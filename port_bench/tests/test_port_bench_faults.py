"""Whole runs of each cell on the CPU at small sizes, sound and with the
timed path broken underneath: the sound run is `correct`, each fault a
cell can have makes it not so. (The harness's look for a card is skipped:
`run.execute` is called with device="cpu".)"""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from port_bench import run

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
TRAIN = [w["name"] for w in MANIFEST["workloads"] if w["traffic"] == "train-epochs"]
SEED = 2**31 + 1234


def _state_unchanged(monkeypatch):
    """The optimizer step leaves the parameters and its state as they were."""
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)


def _half_batch(monkeypatch):
    """Each train microbatch's loss over its first half, the mean over the rest."""
    from audio_classification_icbhi_tpu_torch.parallel import data_parallel as dp

    real = dp.weighted_cross_entropy

    def half(logits, labels, class_weights, mask=None, dim=None):
        if mask is None:
            n = logits.shape[0] // 2
            return real(logits[:n], labels[:n], class_weights, mask, dim)
        return real(logits, labels, class_weights, mask, dim)

    monkeypatch.setattr(dp, "weighted_cross_entropy", half)


def _val_loss_altered(monkeypatch):
    """The validation pass's loss sums altered where they are produced."""
    from audio_classification_icbhi_tpu_torch.parallel import data_parallel as dp

    real = dp.weighted_cross_entropy

    def altered(logits, labels, class_weights, mask=None, dim=None):
        num, den = real(logits, labels, class_weights, mask, dim)
        return (num * 1.1, den) if mask is not None else (num, den)

    monkeypatch.setattr(dp, "weighted_cross_entropy", altered)


def _gradient_altered(monkeypatch):
    """The first parameter's gradient doubled where the step produces it,
    after clipping."""
    from audio_classification_icbhi_tpu_torch.parallel import data_parallel as dp

    real = dp.clip_by_global_norm

    def altered(grads, max_norm=1.0):
        norm = real(grads, max_norm)
        grads[0].mul_(2.0)
        return norm

    monkeypatch.setattr(dp, "clip_by_global_norm", altered)


def _batch_norm_momentum(monkeypatch, momentum: float):
    """Every BatchNorm of the program built with another running-statistics
    momentum: 0 leaves the running means and variances as they were, 0.9 is
    flax's value taken as torch's."""
    from audio_classification_icbhi_tpu_torch.models import cnn

    real = cnn.BatchNorm.__init__

    def init(self, num_features, group=None):
        real(self, num_features, group)
        self.momentum = momentum

    monkeypatch.setattr(cnn.BatchNorm, "__init__", init)


def _stats_unchanged(monkeypatch):
    _batch_norm_momentum(monkeypatch, 0.0)


def _stats_momentum_swapped(monkeypatch):
    _batch_norm_momentum(monkeypatch, 0.9)


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "gradient_altered": _gradient_altered, "val_loss_altered": _val_loss_altered,
          "stats_unchanged": _stats_unchanged, "stats_momentum_swapped": _stats_momentum_swapped}


def _compares(workload: str, number: str) -> bool:
    return number in json.loads((ROOT / "port_bench" / "checks" / f"{workload}.json").read_text())


def _compares_stats(workload: str) -> bool:
    """Whether the cell's checks compare a BatchNorm statistics number: the
    BatchNorm faults cannot act on a model without BatchNorm."""
    return any(_compares(workload, n) for n in ("stats3_gap", "stats3_median_gap"))


CASES = ([(c, f) for c in TRAIN for f in ("state_unchanged", "half_batch", "gradient_altered")
          + (("stats_unchanged", "stats_momentum_swapped") if _compares_stats(c) else ())]
         + [(c, "val_loss_altered") for c in TRAIN if _compares(c, "val_batch_gap")])


@pytest.mark.parametrize("workload", TRAIN)
def test_sound_run_is_correct(workload, small):
    line = run.execute(workload, SEED, 0.3, False, device="cpu", overrides=small)
    assert line["correct"], line["checks"]


@pytest.mark.parametrize("workload,fault", CASES)
def test_fault_is_not_correct(workload, fault, small, monkeypatch):
    FAULTS[fault](monkeypatch)
    line = run.execute(workload, SEED, 0.3, False, device="cpu", overrides=small)
    assert not line["correct"], line["checks"]
