"""The port's numpy metrics against sklearn and the JAX package's
`calculate_metrics` (which calls sklearn), on seeded random cases: absent
classes, a single class in y_true, tied probabilities, a y_prob with fewer
columns than classes or with a non-finite value. Values agree within 1e-12,
NaN where NaN.
"""

import warnings

import numpy as np
import pytest
import sklearn
from sklearn import metrics as skm

from audio_classification_icbhi_tpu.utils import metrics as jax_metrics
from audio_classification_icbhi_tpu_torch.utils import metrics

CASES = ["random", "absent", "single_class", "ties", "short_prob", "nan_prob", "one_row",
         "pred_outside"]


def make_case(kind: str, seed: int):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(5, 80)) if kind != "one_row" else 1
    y_true = rng.integers(0, 4, n)
    y_pred = np.where(rng.random(n) < 0.6, y_true, rng.integers(0, 4, n))
    y_prob = rng.dirichlet(np.ones(4), n).astype(np.float32)
    if kind == "absent":  # class 2 never true; class 3 never true nor predicted
        y_true = rng.choice([0, 1], n)
        y_pred = rng.choice([0, 1, 2], n)
    elif kind == "single_class":
        y_true = np.full(n, int(rng.integers(0, 4)))
    elif kind == "ties":
        y_prob = (np.round(y_prob * 4) / 4).astype(np.float32)
    elif kind == "short_prob":
        y_prob = y_prob[:, :2]
    elif kind == "nan_prob":
        y_prob[int(rng.integers(0, n)), int(y_true[0])] = np.nan
    elif kind == "pred_outside":  # a 5-class model scored against 4 names
        y_pred = np.where(rng.random(n) < 0.2, 4, y_pred)
    return y_true, y_pred, y_prob


def assert_close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    assert np.array_equal(np.isnan(got), np.isnan(want)), (what, got, want)
    ok = ~np.isnan(want)
    assert np.all(np.abs(got[ok] - want[ok]) <= 1e-12), (what, got, want)


def sklearn_metrics(y_true, y_pred, y_prob):
    """What sklearn's calls, made as the JAX version makes them, give."""
    labels = [0, 1, 2, 3]
    kw = dict(zero_division=0)
    out = {
        "accuracy": skm.accuracy_score(y_true, y_pred),
        "precision_per_class": skm.precision_score(y_true, y_pred, labels=labels, average=None,
                                                   **kw),
        "recall_per_class": skm.recall_score(y_true, y_pred, labels=labels, average=None, **kw),
        "f1_per_class": skm.f1_score(y_true, y_pred, labels=labels, average=None, **kw),
        "precision_weighted": skm.precision_score(y_true, y_pred, average="weighted", **kw),
        "recall_weighted": skm.recall_score(y_true, y_pred, average="weighted", **kw),
        "f1_weighted": skm.f1_score(y_true, y_pred, average="weighted", **kw),
    }
    aucs = []
    try:
        for c in labels:
            binary = (y_true == c).astype(int)
            aucs.append(np.nan if binary.min() == binary.max()
                        else skm.roc_auc_score(binary, y_prob[:, c]))
    except (ValueError, IndexError):
        aucs = [np.nan] * 4
    out["roc_auc_per_class"] = aucs
    return out


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("kind", CASES)
def test_calculate_metrics_matches_sklearn_and_jax(kind, seed):
    assert sklearn.__version__ == "1.9.0"
    y_true, y_pred, y_prob = make_case(kind, seed)
    got = metrics.calculate_metrics(y_true, y_pred, y_prob)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jax_metrics.calculate_metrics(y_true, y_pred, y_prob)
        direct = sklearn_metrics(y_true, y_pred, y_prob)
    assert set(got) == set(want)
    assert got["class_names"] == want["class_names"]
    for key in set(got) - {"class_names"}:
        assert_close(got[key], want[key], key)
        if key in direct:
            assert_close(got[key], direct[key], key)
    if kind in ("short_prob", "nan_prob"):
        assert all(np.isnan(got["roc_auc_per_class"])) and np.isnan(got["roc_auc_macro"])
    no_prob = metrics.calculate_metrics(y_true, y_pred)
    assert "roc_auc_macro" not in no_prob
    assert no_prob == {k: v for k, v in got.items() if not k.startswith("roc_auc")}


@pytest.mark.parametrize("seed", range(4))
def test_confusion_matrix_and_roc_curve_match_sklearn(seed):
    rng = np.random.default_rng(seed)
    n = 60
    y_true = rng.integers(0, 4, n)
    y_pred = np.where(rng.random(n) < 0.5, y_true, rng.integers(0, 5, n))
    for labels in ([0, 1, 2, 3], [3, 1, 0, 2], [0, 1]):
        got = metrics.confusion_matrix(y_true, y_pred, labels)
        np.testing.assert_array_equal(got, skm.confusion_matrix(y_true, y_pred, labels=labels))
    scores = rng.random(n).astype(np.float32)
    scores[::3] = np.round(scores[::3], 1)  # ties
    for c in range(4):
        binary = (y_true == c).astype(int)
        for got, want in zip(metrics.roc_curve(binary, scores), skm.roc_curve(binary, scores)):
            np.testing.assert_array_equal(got, want)
        assert abs(metrics.roc_auc(binary, scores) - skm.roc_auc_score(binary, scores)) <= 1e-12
    # one score for all: two points; a constant target: NaN rates, as sklearn
    flat = np.full(n, 0.5, np.float32)
    binary = (y_true == 0).astype(int)
    for got, want in zip(metrics.roc_curve(binary, flat), skm.roc_curve(binary, flat)):
        np.testing.assert_array_equal(got, want)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for got, want in zip(metrics.roc_curve(np.ones(n, int), scores),
                             skm.roc_curve(np.ones(n, int), scores)):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("with_prob", [True, False])
def test_print_metrics_matches_jax(capsys, with_prob):
    y_true, y_pred, y_prob = make_case("absent", 5)
    prob = y_prob if with_prob else None
    metrics.print_metrics(metrics.calculate_metrics(y_true, y_pred, prob))
    got = capsys.readouterr().out
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jax_metrics.print_metrics(jax_metrics.calculate_metrics(y_true, y_pred, prob))
    assert got == capsys.readouterr().out
    assert ("Macro ROC-AUC" in got) == with_prob
