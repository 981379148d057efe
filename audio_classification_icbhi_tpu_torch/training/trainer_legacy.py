"""The legacy trainer variant.

Port of `audio_classification_icbhi_tpu/training/trainer_legacy.py`: the
reference's original loop (its `src/training/trainer.py`), without class
weighting and without gradient clipping: uniform weights (plain
CrossEntropyLoss) and unclipped updates. Everything else is the default
Trainer's, the precision and loss-scale modes and data parallelism
included.
"""

from __future__ import annotations

import numpy as np

from audio_classification_icbhi_tpu_torch.training.trainer import Trainer


class LegacyTrainer(Trainer):
    def _max_grad_norm(self) -> float:
        return float("inf")

    def _calculate_class_weights(self) -> np.ndarray:
        return np.ones(self.config["model"]["num_classes"], np.float32)
