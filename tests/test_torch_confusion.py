"""The port's confusion-matrix reports (`confusion_matrix.py`) against the
repository's three scripts (`generate_confusion_matrix.py`,
`generate_confusion_matrix_from_runs.py`, `quick_confusion_matrix.py`) on
the CPU: the same (y_true, y_pred) give the same NPY, CSV bytes and
classification report text (the JAX script's is sklearn's), the event-file
summaries are equal, and each command runs through the entry point on a
seeded checkpoint and a small synthetic corpus, with --device cpu.
"""

import csv

import numpy as np
import pytest
import torch

import generate_confusion_matrix as jax_generate
import generate_confusion_matrix_from_runs as jax_from_runs
import quick_confusion_matrix as jax_quick
from audio_classification_icbhi_tpu_torch import confusion_matrix as cm_entry
from audio_classification_icbhi_tpu_torch.data.dataset import ICBHIDataset
from audio_classification_icbhi_tpu_torch.data.synthetic import generate_icbhi_dataset
from audio_classification_icbhi_tpu_torch.inference import ClassifierEngine
from audio_classification_icbhi_tpu_torch.models import build_model
from audio_classification_icbhi_tpu_torch.models.weights import flax_from_state_dict
from audio_classification_icbhi_tpu_torch.training.validation import Validator
from audio_classification_icbhi_tpu_torch.utils.checkpoint import save_checkpoint
from audio_classification_icbhi_tpu_torch.utils.config import load_config
from audio_classification_icbhi_tpu_torch.utils.metrics import confusion_matrix
from audio_classification_icbhi_tpu_torch.utils.tensorboard import SummaryWriter

NAMES = ["normal", "crackles", "wheezes", "both"]


@pytest.mark.parametrize("case", ["mixed", "no_hits", "one_class"])
def test_plot_matrices_matches_the_script(tmp_path, capsys, case):
    rng = np.random.default_rng(len(case))
    y_true = rng.integers(0, 4, 50)
    y_pred = {"mixed": np.where(rng.random(50) < 0.6, y_true, rng.integers(0, 4, 50)),
              "no_hits": (y_true + 1) % 4, "one_class": np.zeros(50, int)}[case]
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = jax_generate.plot_matrices(y_true, y_pred, NAMES, tmp_path / "jax", "val")
    jax_out = capsys.readouterr().out
    got = cm_entry.plot_matrices(y_true, y_pred, NAMES, tmp_path / "port", "val")
    port_out = capsys.readouterr().out
    np.testing.assert_array_equal(got, want)
    assert port_out == jax_out and "weighted avg" in port_out
    files = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == files == [
        "confusion_matrix_val.csv", "confusion_matrix_val.npy", "confusion_matrix_val.png",
        "confusion_matrix_val_normalized.png"]
    for name in ("confusion_matrix_val.csv", "confusion_matrix_val.npy"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


def test_plot_cm_matches_the_script(tmp_path, capsys):
    rng = np.random.default_rng(3)
    y_true, y_pred = rng.integers(0, 4, 40), rng.integers(0, 4, 40)
    want = jax_quick.plot_cm(y_true, y_pred, save_path=tmp_path / "j.png")
    got = cm_entry.plot_cm(y_true, y_pred, save_path=tmp_path / "p.png")
    np.testing.assert_array_equal(got, want)
    assert (tmp_path / "p.png").stat().st_size > 10_000
    out = tmp_path / "quick.png"
    np.testing.assert_array_equal(cm_entry.main(["quick", "--save-path", str(out)])["cm"].sum(), 100)
    assert out.exists()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A flat runs/ directory with two event files (one tag in both), and a
    nested one under it."""
    root = tmp_path_factory.mktemp("runs")
    for i, steps in enumerate(((0, 1, 2), (3, 4))):
        with SummaryWriter(root) as w:
            for s in steps:
                w.add_scalar("Loss/train", 1.0 / (s + 1), s)
                w.add_scalar("Accuracy/val", 0.1 * s, s)
                if i:
                    w.add_scalar("ICBHI/score", 0.2 * s, s)
        for ev in root.glob("events.out.tfevents.*"):  # two writers can share a second
            if not ev.name.endswith((".run0", ".run1")):
                ev.rename(ev.with_name(f"{ev.name}.run{i}"))
    with SummaryWriter(root / "nested") as w:
        w.add_scalar("Loss/val", 0.5, 7)
    return root


def test_summaries_match_the_scripts(runs, capsys):
    merged = cm_entry.summarize_runs(runs)
    assert merged == jax_from_runs.summarize_runs(str(runs))
    assert merged["Loss/train"] == sorted(merged["Loss/train"]) and len(merged["Loss/train"]) == 5
    found = cm_entry.discover_run_scalars(runs)
    port_out = capsys.readouterr().out
    jax_generate.discover_run_scalars(str(runs))
    assert port_out == capsys.readouterr().out
    assert len(found) == 3 and any(p.parent.name == "nested" for p in found)
    result = cm_entry.main(["from-runs", "--log-dir", str(runs)])
    out = capsys.readouterr().out
    assert result["scalars"] == merged
    assert "Accuracy/val: 5 pts, last=0.4000, best=0.4000" in out
    assert "Loss/train: 5 pts, last=0.2000, best=0.2000" in out


@pytest.fixture(scope="module")
def checkpoint_and_corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("cm")
    corpus = generate_icbhi_dataset(d / "corpus", num_recordings=12, seed=5)
    cfg = load_config()
    cfg["data"].update(duration=1.0, dataset_path=str(corpus))
    cfg["training"].update(mixed_precision=False, batch_size=4)
    model = build_model(cfg, dtype=torch.float32, generator=torch.Generator().manual_seed(2))
    sd = {k: v * 30.0 if k in ("fc1.weight", "fc2.weight") else v
          for k, v in model.state_dict().items()}
    ckpt = save_checkpoint(d / "m.ckpt", {"epoch": 0, **flax_from_state_dict(sd),
                                          "val_loss": 0.0, "config": cfg})
    return ckpt, corpus


def test_generate_revalidates_through_the_validator(checkpoint_and_corpus, tmp_path, capsys):
    ckpt, corpus = checkpoint_and_corpus
    engine = ClassifierEngine(ckpt, device="cpu")
    dataset = ICBHIDataset(corpus, "train", engine.config)
    y_true, y_pred, _ = Validator(engine.model, dataset, engine.config, device="cpu").validate()
    want = confusion_matrix(y_true, y_pred, range(4))
    out = tmp_path / "out"
    result = cm_entry.main(["generate", "--model", str(ckpt), "--split", "train",
                            "--output-dir", str(out), "--device", "cpu", "--log-dir",
                            str(tmp_path)])
    np.testing.assert_array_equal(np.load(out / "confusion_matrix_train.npy"), want)
    np.testing.assert_array_equal(result["cm"], want)
    assert want.sum() == len(dataset) == 8
    assert len(list(out.glob("*.png"))) == 2
    rows = list(csv.reader(open(out / "confusion_matrix_train.csv")))
    assert rows[0] == [""] + NAMES and [int(v) for v in rows[1][1:]] == want[0].tolist()
    assert "No event files under" in capsys.readouterr().out

    plain = tmp_path / "plain"
    cm_entry.main(["from-runs", "--log-dir", str(tmp_path), "--model", str(ckpt), "--split",
                   "train", "--data-path", str(corpus), "--output-dir", str(plain),
                   "--device", "cpu", "--no-plots"])
    assert sorted(p.name for p in plain.iterdir()) == ["confusion_matrix_train.csv",
                                                      "confusion_matrix_train.npy"]
    np.testing.assert_array_equal(np.load(plain / "confusion_matrix_train.npy"), want)
    assert "weighted avg: P=" in capsys.readouterr().out


def test_cuda_is_the_default(checkpoint_and_corpus, monkeypatch):
    ckpt, _ = checkpoint_and_corpus
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cm_entry.main(["generate", "--model", str(ckpt)])
