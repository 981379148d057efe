"""Validation runner collecting (y_true, y_pred, y_prob).

Port of `audio_classification_icbhi_tpu/training/validation.py:21-78`: a
no-grad pass over a dataset through the eval step (`make_eval_step`: the
front end, the model in eval mode), partial batches padded to the batch
size with a mask (`eval_batches`, the trainer's validation pass too),
softmax on the device, argmax on the host. The logits stay on the device
until the pass ends; their softmax crosses to the host in one copy (and the
logits in a second, when asked for). Either classifier serves, with the
weights it holds: a model loaded by `ClassifierEngine` reads a checkpoint
written by either package.

On a data mesh of several ranks (`parallel/mesh.py`, `validation.py:57-73`
there), the batch size rounds up to a multiple of the ranks, each rank
decodes and runs only its rows of every padded batch, and the logits come
back all-gathered, so every rank returns the same arrays."""

from __future__ import annotations

import numpy as np
import torch

from audio_classification_icbhi_tpu_torch.data.loader import BatchLoader
from audio_classification_icbhi_tpu_torch.ops.mel import MelFrontend
from audio_classification_icbhi_tpu_torch.parallel.data_parallel import (
    eval_batches,
    make_eval_step,
)
from audio_classification_icbhi_tpu_torch.parallel.mesh import Mesh
from audio_classification_icbhi_tpu_torch.utils.config import resolve_device


class Validator:
    """Runs on `device` ("cuda" by default; it raises where no GPU exists,
    and runs on the CPU only when given device="cpu"), or on this rank's
    device of `mesh`."""

    def __init__(self, model: torch.nn.Module, dataset, config: dict,
                 device: str | torch.device = "cuda", batch_size: int | None = None,
                 mesh: Mesh | None = None):
        self.mesh = mesh
        self.device = resolve_device(mesh.device if mesh is not None else device)
        self.model = model.to(self.device)
        self.dataset = dataset
        self.config = config
        self.batch_size = batch_size or config["training"]["batch_size"]
        n_dev = mesh.world_size if mesh is not None else 1
        # a multiple of the ranks; the padding and mask cover the rest
        self.batch_size = -(-self.batch_size // n_dev) * n_dev
        self.frontend = MelFrontend.from_config(config)
        self.eval_step = make_eval_step(model, self.frontend, mesh)
        self.loader = BatchLoader(dataset, self.batch_size, shuffle=False,
                                  shard=(mesh.rank, n_dev) if mesh is not None else (0, 1))
        self.num_classes = config["model"]["num_classes"]

    def validate(self, with_logits: bool = False) -> tuple[np.ndarray, ...]:
        """-> (y_true int64, y_pred int64, y_prob float32) over the dataset,
        and with_logits, the f32 logits y_prob is the softmax of last."""
        ones = torch.ones(self.num_classes, device=self.device)
        y_true, logits = [], []
        for batch_logits, _, _, _, labels in eval_batches(
                self.eval_step, self.loader, self.batch_size, self.device, ones, self.mesh):
            logits.append(batch_logits.float())
            y_true.append(labels)
        if not logits:
            empty = np.zeros((0, self.num_classes), np.float32)
            return (np.zeros(0, np.int64), np.zeros(0, np.int64), empty) + (
                (empty,) if with_logits else ())
        logits = torch.cat(logits)
        probs = torch.softmax(logits, dim=-1).cpu().numpy().astype(np.float32)
        out = (np.concatenate(y_true).astype(np.int64),
               np.argmax(probs, axis=-1).astype(np.int64), probs)
        return out + ((logits.cpu().numpy(),) if with_logits else ())
