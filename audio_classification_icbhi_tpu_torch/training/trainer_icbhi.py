"""Trainer variant scored by the ICBHI 2017 metric.

Port of `audio_classification_icbhi_tpu/training/trainer_icbhi.py:57-116`:
the same training loop, but each epoch's validation also computes the ICBHI
score; best-model selection and early stopping run on the MAX ICBHI score,
the plateau scheduler runs in mode "max", the extra TensorBoard tags are
ICBHI/{score,sensitivity,specificity}, and checkpoints embed icbhi_score and
icbhi_metrics.
"""

from __future__ import annotations

import numpy as np

from audio_classification_icbhi_tpu_torch.training.trainer import Trainer
from audio_classification_icbhi_tpu_torch.utils.icbhi_metrics import calculate_icbhi_score


class TrainerWithICBHI(Trainer):
    plateau_mode = "max"
    collect_predictions = True  # validate() keeps (y_true, y_pred) for us

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.best_icbhi_score = -float("inf")
        self.history.update(icbhi_score=[], sensitivity=[], specificity=[])
        self._last_icbhi: dict = {}

    def _epoch_metrics(self, epoch: int) -> dict[str, float]:
        # predictions come from validate()'s single pass over the val loader
        y_true, y_pred = self.val_predictions
        self._last_icbhi = calculate_icbhi_score(np.asarray(y_true), np.asarray(y_pred))
        return {
            "ICBHI/score": self._last_icbhi["icbhi_score"],
            "ICBHI/sensitivity": self._last_icbhi["avg_sensitivity"],
            "ICBHI/specificity": self._last_icbhi["avg_specificity"],
        }

    def _selection_metric(self, val_loss: float, extra: dict) -> float:
        return extra["ICBHI/score"]

    def _is_improvement(self, metric: float) -> bool:
        return metric > self.best_icbhi_score

    def _record_best(self, metric: float) -> None:
        self.best_icbhi_score = metric

    def _best_description(self) -> str:
        return f"ICBHI score: {self.best_icbhi_score:.4f}"

    def _extend_history(self, extra: dict) -> None:
        self.history["icbhi_score"].append(extra["ICBHI/score"])
        self.history["sensitivity"].append(extra["ICBHI/sensitivity"])
        self.history["specificity"].append(extra["ICBHI/specificity"])

    def _checkpoint_payload(self, epoch: int, val_loss: float, extra: dict) -> dict:
        payload = super()._checkpoint_payload(epoch, val_loss, extra)
        if extra:
            payload["icbhi_score"] = float(extra["ICBHI/score"])
            payload["icbhi_metrics"] = {
                "avg_sensitivity": float(extra["ICBHI/sensitivity"]),
                "avg_specificity": float(extra["ICBHI/specificity"]),
            }
        return payload

    # exact-resume hooks: the selection bar here is the ICBHI score, not
    # val_loss
    def _best_metric(self) -> float:
        return self.best_icbhi_score

    def _restore_best_metric(self, value: float, ckpt: dict) -> None:
        self.best_icbhi_score = value
        self.best_val_loss = float(ckpt.get("val_loss", float("inf")))

    def _legacy_best_metric(self, ckpt: dict) -> float:
        return float(ckpt.get("icbhi_score", -float("inf")))

