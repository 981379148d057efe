"""The reference's readings of a cell, from the benchmark's inputs alone.

Train cells: the recordings split 70 / 15 / 15 in name order, the train
rows shuffled by `np.random.default_rng(seed + epoch)` into batches with
the short last one dropped, A batches an optimizer step; the first steps'
readings (`step.follow_train`) and each validation batch's loss at the
initial weights (`step.eval_losses`).
"""

from __future__ import annotations

import numpy as np
import torch

from port_bench.reference import step


def split(n: int) -> tuple[int, int]:
    """(train, val) recording counts of the whole-recording split."""
    return int(0.7 * n), int(0.15 * n)


def first_steps_rows(n_train: int, seed: int, accum: int, batch: int, steps: int) -> np.ndarray:
    """(steps, accum, batch) train-split indices of epoch 0's first steps."""
    order = np.arange(n_train)
    np.random.default_rng(seed + 0).shuffle(order)
    return order[: steps * accum * batch].reshape(steps, accum, batch)


def pcm_to_float(pcm: np.ndarray) -> np.ndarray:
    return pcm.astype(np.float32) * np.float32(1.0 / 32768.0)


def train(config: dict, state0: dict, pcm: np.ndarray, labels: np.ndarray, seed: int, device,
          steps: int = 3, precision: str = "f32", half_batch: bool = False,
          frozen: bool = False) -> dict:
    """{"losses", "grad1", "change", "val_losses"} of the reference, from the
    corpus' int16 clips pcm (N, L) and labels (N,) in name order."""
    tcfg = config["training"]
    n_train, n_val = split(len(labels))
    accum, batch = max(1, tcfg.get("gradient_accumulation_steps", 1)), tcfg["batch_size"]
    rows = first_steps_rows(n_train, seed, accum, batch, steps)
    weights = torch.as_tensor(step.class_weights(labels[:n_train], config["model"]["num_classes"]),
                              device=device)
    wavs = torch.as_tensor(pcm_to_float(pcm[rows]), device=device)
    out = step.follow_train(config, state0, wavs, torch.as_tensor(labels[rows], device=device),
                            weights, float(tcfg["learning_rate"]), seed, precision, half_batch,
                            frozen)
    del wavs
    val = slice(n_train, n_train + n_val)
    out["val_losses"] = step.eval_losses(
        config, state0, torch.as_tensor(pcm_to_float(pcm[val]), device=device),
        torch.as_tensor(labels[val], device=device), weights, batch, precision)
    return out
