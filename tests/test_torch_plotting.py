"""The port's report pictures and the reports behind them, on the CPU
(matplotlib and seaborn are here; the machine with the card has neither):
every plot function draws a PNG larger than 5 kB, as tests/test_plots.py
holds the JAX package's; the matrices and curves drawn are sklearn's; and
with matplotlib hidden the package still imports and `validate --no-plots`
still runs, while a plot asked for raises naming the module.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from sklearn import metrics as skm

from audio_classification_icbhi_tpu_torch.utils import plotting
from audio_classification_icbhi_tpu_torch.utils.icbhi_metrics import calculate_icbhi_score
from audio_classification_icbhi_tpu_torch.validate import report

REPO = Path(__file__).resolve().parent.parent
HISTORY = {
    "train_loss": [1.4, 1.2, 1.0], "val_loss": [1.35, 1.25, 1.1],
    "train_acc": [30.0, 50.0, 70.0], "val_acc": [35.0, 45.0, 65.0],
    "icbhi_score": [0.3, 0.4, 0.5], "sensitivity": [0.2, 0.4, 0.5],
    "specificity": [0.8, 0.75, 0.8],
}


@pytest.fixture
def preds():
    rng = np.random.default_rng(42)
    y_true = rng.integers(0, 4, 60)
    y_pred = np.where(rng.random(60) < 0.7, y_true, rng.integers(0, 4, 60))
    y_prob = rng.dirichlet(np.ones(4), 60).astype(np.float32)
    return y_true, y_pred, y_prob


def png(path: Path) -> bool:
    return path.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n" and path.stat().st_size > 5_000


PLOTS = {
    "confusion_matrix": lambda p, d: plotting.plot_confusion_matrix(p[0], p[1], save_path=d),
    "confusion_matrix_normalized": lambda p, d: plotting.plot_confusion_matrix(
        p[0], p[1], save_path=d, normalize=True),
    "roc_curves": lambda p, d: plotting.plot_roc_curves(p[0], p[2], save_path=d),
    "training_history": lambda p, d: plotting.plot_training_history(HISTORY, save_path=d),
    "icbhi_metrics": lambda p, d: plotting.plot_icbhi_metrics(
        calculate_icbhi_score(p[0], p[1]), save_path=d),
    "icbhi_confusion_matrix": lambda p, d: plotting.plot_icbhi_confusion_matrix(
        p[0], p[1], save_path=d),
    "icbhi_history": lambda p, d: plotting.plot_icbhi_history(HISTORY, save_path=d),
}


@pytest.mark.parametrize("name", list(PLOTS))
def test_every_plot_draws_a_png(tmp_path, preds, name):
    path = tmp_path / "sub" / f"{name}.png"
    PLOTS[name](preds, path)
    assert png(path)


def test_drawn_data_is_sklearns(tmp_path, preds):
    """What the pictures draw and validation_{split}.json holds: the
    confusion matrix and each class's ROC points are sklearn's."""
    y_true, y_pred, y_prob = preds
    names = ["normal", "crackles", "wheezes", "both"]
    want_cm = skm.confusion_matrix(y_true, y_pred, labels=[0, 1, 2, 3])
    np.testing.assert_array_equal(plotting.plot_confusion_matrix(y_true, y_pred), want_cm)
    np.testing.assert_array_equal(plotting.plot_icbhi_confusion_matrix(y_true, y_pred), want_cm)
    drawn = plotting.plot_roc_curves(y_true, y_prob, save_path=tmp_path / "roc.png")
    written = json.loads(json.dumps(report(y_true, y_pred, y_prob, names)))
    assert written["confusion_matrix"] == want_cm.tolist()
    assert list(written["roc_curves"]) == names == list(drawn)
    for c, name in enumerate(names):
        binary = (y_true == c).astype(int)
        fpr, tpr, thr = skm.roc_curve(binary, y_prob[:, c])
        for points in (written["roc_curves"][name], drawn[name]):
            np.testing.assert_array_equal(points["fpr"], fpr)
            np.testing.assert_array_equal(points["tpr"], tpr)
            np.testing.assert_array_equal(points["thresholds"], thr)
            assert abs(points["auc"] - skm.auc(fpr, tpr)) <= 1e-12


HIDDEN = r"""
import importlib, importlib.abc, importlib.machinery, pkgutil, sys

# finds the hidden modules first, with no origin (a probe by find_spec sees
# nothing to read), and fails to load them
class Hide(importlib.abc.Loader):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("matplotlib", "seaborn", "sklearn"):
            return importlib.machinery.ModuleSpec(name, self)

    def create_module(self, spec):
        raise ModuleNotFoundError(f"No module named {spec.name!r} (hidden)")

    def exec_module(self, module):
        pass

sys.meta_path.insert(0, Hide())
import audio_classification_icbhi_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
assert not any(k.split(".")[0] in ("matplotlib", "seaborn", "sklearn") for k in sys.modules)
from audio_classification_icbhi_tpu_torch import validate
from audio_classification_icbhi_tpu_torch.utils import plotting
result = validate.main(sys.argv[1:])
print("ACCURACY", result["metrics"]["accuracy"])
try:
    plotting.plot_roc_curves(result["y_true"], result["y_prob"], save_path="x.png")
except ImportError as e:
    print("RAISED", e)
"""


def test_without_matplotlib(tmp_path):
    """In a fresh interpreter that cannot import matplotlib, seaborn or
    sklearn: every module of the package imports, `validate --no-plots`
    writes its JSON report, and a plot raises ImportError naming
    utils/plotting."""
    from audio_classification_icbhi_tpu_torch.data.synthetic import generate_icbhi_dataset
    from audio_classification_icbhi_tpu_torch.models import build_model
    from audio_classification_icbhi_tpu_torch.models.weights import flax_from_state_dict
    from audio_classification_icbhi_tpu_torch.utils.checkpoint import save_checkpoint
    from audio_classification_icbhi_tpu_torch.utils.config import load_config
    import torch

    corpus = generate_icbhi_dataset(tmp_path / "corpus", num_recordings=8, seed=0)
    config = load_config(str(REPO / "config.yaml"))
    config["data"]["duration"] = 1.0
    v = flax_from_state_dict(build_model(config, generator=torch.Generator().manual_seed(0))
                             .state_dict())
    ckpt = save_checkpoint(tmp_path / "m.ckpt", {"epoch": 0, **v, "config": config})
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run(
        [sys.executable, "-c", HIDDEN, "--model", str(ckpt), "--data-path", str(corpus),
         "--config", str(REPO / "config.yaml"),
         "--split", "train", "--device", "cpu", "--no-plots", "--output-dir", str(tmp_path / "r")],
        capture_output=True, text=True, env=env, cwd=str(tmp_path), timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "ACCURACY" in out.stdout
    assert "RAISED audio_classification_icbhi_tpu_torch.utils.plotting" in out.stdout
    report_path = tmp_path / "r" / "validation_train.json"
    assert set(json.loads(report_path.read_text())) == {"metrics", "confusion_matrix",
                                                        "roc_curves"}
    assert not list((tmp_path / "r").glob("*.png")) and not (tmp_path / "x.png").exists()
