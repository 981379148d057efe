"""Classification metrics in numpy (no sklearn).

Port of `audio_classification_icbhi_tpu/utils/metrics.py:22-110`, which
calls sklearn; the machine with the card has no sklearn, so the same
semantics are written out here:

- accuracy: the share of y_pred equal to y_true;
- per-class precision, recall and F1 over labels 0..n-1, 0 where a
  denominator is 0 (sklearn's zero_division=0); F1 as 2 tp / (true + pred);
- weighted precision, recall and F1 over the labels present in y_true or
  y_pred, weighted by their count in y_true (sklearn's average="weighted");
- one-vs-rest ROC-AUC by ranks with ties averaged (the Mann-Whitney U, which
  is the area under sklearn's ROC curve), NaN for a class absent from
  y_true or alone in it, and the macro AUC over the finite ones; a y_prob
  that cannot be scored (too few columns or rows, not finite) gives NaN for
  every class, as the JAX version's fallback does.

`confusion_matrix` and `roc_curve` give what sklearn's functions of the
same names give (`roc_curve` with its default drop_intermediate=True), and
`classification_report` sklearn's text report, character for character
(with zero_division=0); the reports and plots draw from them.
"""

from __future__ import annotations

import numpy as np

DEFAULT_CLASSES = ["normal", "crackles", "wheezes", "both"]


def confusion_matrix(y_true, y_pred, labels) -> np.ndarray:
    """(n, n) int64 counts, rows true and columns predicted, in the order of
    `labels`; pairs with a value outside `labels` are not counted."""
    y_true, y_pred = np.asarray(y_true).ravel(), np.asarray(y_pred).ravel()
    labels = np.asarray(labels)
    n = len(labels)
    index = {int(v): i for i, v in enumerate(labels)}
    t = np.array([index.get(int(v), -1) for v in y_true], np.int64)
    p = np.array([index.get(int(v), -1) for v in y_pred], np.int64)
    keep = (t >= 0) & (p >= 0)
    return np.bincount(t[keep] * n + p[keep], minlength=n * n).reshape(n, n).astype(np.int64)


def _divide(num: np.ndarray, den: np.ndarray) -> np.ndarray:
    num, den = np.asarray(num, np.float64), np.asarray(den, np.float64)
    out = np.zeros_like(num)
    np.divide(num, den, out=out, where=den != 0)
    return out


def _prf(y_true: np.ndarray, y_pred: np.ndarray, labels) -> tuple[np.ndarray, ...]:
    """Per-label precision, recall, F1 and support (count in y_true)."""
    labels = np.asarray(labels)
    tp = np.array([np.sum((y_true == c) & (y_pred == c)) for c in labels], np.int64)
    pred = np.array([np.sum(y_pred == c) for c in labels], np.int64)
    true = np.array([np.sum(y_true == c) for c in labels], np.int64)
    return _divide(tp, pred), _divide(tp, true), _divide(2.0 * tp, true + pred), true


def _weighted(scores: np.ndarray, weights: np.ndarray) -> float:
    if scores.shape[0] == 0:
        return float("nan")
    if weights.sum() == 0:
        return float(np.average(scores))
    return float(np.average(scores, weights=weights))


def _ranks(x: np.ndarray) -> np.ndarray:
    """1-based ranks of x, ties given the mean of their ranks."""
    order = np.argsort(x, kind="mergesort")
    xs = x[order]
    starts = np.r_[0, np.flatnonzero(np.diff(xs)) + 1]
    ends = np.r_[starts[1:], len(xs)]
    ranks = np.empty(len(x), np.float64)
    ranks[order] = np.repeat((starts + ends + 1) / 2.0, ends - starts)
    return ranks


def roc_auc(binary, score) -> float:
    """Area under the ROC curve of a 0/1 target: (sum of the positives'
    ranks - n_pos (n_pos + 1) / 2) / (n_pos n_neg), ties averaged. NaN when
    one of the two groups is empty."""
    binary = np.asarray(binary).ravel().astype(bool)
    n_pos = int(binary.sum())
    n_neg = binary.size - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    ranks = _ranks(np.asarray(score, np.float64).ravel())
    return float((ranks[binary].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def roc_curve(binary, score) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(fpr, tpr, thresholds) of a 0/1 target as sklearn's roc_curve gives
    them: one point a distinct score in descending order, the points
    collinear with their neighbours dropped, then (0, 0) at threshold inf
    prepended."""
    binary = np.asarray(binary).ravel()
    score = np.asarray(score).ravel()
    # descending and stable: equal scores keep their input order
    order = np.lexsort((np.arange(len(score)), -score.astype(np.float64)))
    s, y = score[order], binary[order].astype(np.float64)
    idx = np.r_[np.flatnonzero(np.diff(s)), y.size - 1]
    tps = np.cumsum(y)[idx]
    fps = 1.0 + idx.astype(np.float64) - tps
    thresholds = s[idx]
    if fps.shape[0] > 2:
        keep = np.flatnonzero(np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), True])
        fps, tps, thresholds = fps[keep], tps[keep], thresholds[keep]
    tps, fps = np.r_[0.0, tps], np.r_[0.0, fps]
    thresholds = np.r_[np.inf, thresholds.astype(np.float64)]
    fpr = fps / fps[-1] if fps[-1] > 0 else np.full(fps.shape, np.nan)
    tpr = tps / tps[-1] if tps[-1] > 0 else np.full(tps.shape, np.nan)
    return fpr, tpr, thresholds


def _auc_per_class(y_true: np.ndarray, y_prob, labels) -> list[float]:
    """One-vs-rest AUC for every label; NaN for every label when y_prob
    cannot be scored."""
    nan = [float("nan")] * len(labels)
    y_prob = np.asarray(y_prob)
    if y_prob.ndim != 2 or y_prob.shape[0] != y_true.shape[0]:
        return nan
    aucs = []
    for c in labels:
        binary = (y_true == c).astype(int)
        if binary.min() == binary.max():  # class absent (or alone): undefined
            aucs.append(float("nan"))
            continue
        if c >= y_prob.shape[1] or not np.all(np.isfinite(y_prob[:, c])):
            return nan
        aucs.append(roc_auc(binary, y_prob[:, c]))
    return aucs


def calculate_metrics(y_true, y_pred, y_prob=None, class_names: list[str] | None = None) -> dict:
    """Accuracy, per-class and weighted precision / recall / F1, and with
    y_prob the one-vs-rest ROC-AUC per class and its macro mean."""
    y_true, y_pred = np.asarray(y_true).ravel(), np.asarray(y_pred).ravel()
    if class_names is None:
        class_names = DEFAULT_CLASSES
    n = len(class_names)
    labels = list(range(n))
    precision, recall, f1, _ = _prf(y_true, y_pred, labels)
    present = np.union1d(np.unique(y_true), np.unique(y_pred))
    w_precision, w_recall, w_f1, support = _prf(y_true, y_pred, present)
    metrics = {
        "accuracy": float(np.mean(y_true == y_pred)),
        "precision_per_class": precision.tolist(),
        "recall_per_class": recall.tolist(),
        "f1_per_class": f1.tolist(),
        "precision_weighted": _weighted(w_precision, support),
        "recall_weighted": _weighted(w_recall, support),
        "f1_weighted": _weighted(w_f1, support),
        "class_names": list(class_names),
    }
    if y_prob is not None:
        aucs = _auc_per_class(y_true, y_prob, labels)
        metrics["roc_auc_per_class"] = aucs
        finite = [a for a in aucs if np.isfinite(a)]
        metrics["roc_auc_macro"] = float(np.mean(finite)) if finite else float("nan")
    return metrics


def classification_report(y_true, y_pred, labels, target_names, digits: int = 2) -> str:
    """sklearn's `classification_report(y_true, y_pred, labels=labels,
    target_names=target_names, digits=digits, zero_division=0)` text: a
    row a label, then accuracy (or the micro average where some true or
    predicted value is not among `labels`), the macro and the weighted
    average."""
    y_true, y_pred = np.asarray(y_true).ravel(), np.asarray(y_pred).ravel()
    p, r, f1, support = _prf(y_true, y_pred, labels)
    if not np.any(y_true == y_pred):
        support = support.astype(np.float64)  # sklearn's counts are floats then ("1.0")
    headers = ["precision", "recall", "f1-score", "support"]
    width = max(max(len(name) for name in target_names), len("weighted avg"), digits)
    report = ("{:>{width}s} " + " {:>9}" * len(headers)).format("", *headers, width=width)
    report += "\n\n"
    row_fmt = "{:>{width}s} " + " {:>9.{digits}f}" * 3 + " {:>9}\n"
    for row in zip(target_names, p, r, f1, support):
        report += row_fmt.format(*row, width=width, digits=digits)
    report += "\n"
    total = support.sum()
    # the micro average over `labels`: sums of tp, predicted and true
    tp = float(sum(np.sum((y_true == c) & (y_pred == c)) for c in labels))
    n_pred = float(sum(np.sum(y_pred == c) for c in labels))
    micro_p = tp / n_pred if n_pred else 0.0
    micro_r = tp / total if total else 0.0
    micro_f = 2 * tp / (total + n_pred) if total + n_pred else 0.0
    if set(np.unique(np.concatenate([y_true, y_pred])).tolist()) <= set(np.asarray(labels).tolist()):
        report += ("{:>{width}s} " + " {:>9.{digits}}" * 2 + " {:>9.{digits}f}" + " {:>9}\n"
                   ).format("accuracy", "", "", micro_f, total, width=width, digits=digits)
    else:
        report += row_fmt.format("micro avg", micro_p, micro_r, micro_f, total,
                                 width=width, digits=digits)
    report += row_fmt.format("macro avg", p.mean(), r.mean(), f1.mean(), total,
                             width=width, digits=digits)
    w = support if total else np.ones_like(support)
    report += row_fmt.format("weighted avg", *(float(np.average(v, weights=w)) for v in (p, r, f1)),
                             total, width=width, digits=digits)
    return report


def print_metrics(metrics: dict) -> None:
    """The formatted metric report."""
    class_names = metrics.get("class_names", DEFAULT_CLASSES)
    print("\n" + "=" * 60)
    print("CLASSIFICATION METRICS")
    print("=" * 60)
    print(f"Overall Accuracy: {metrics['accuracy']:.4f}")
    print(f"Weighted Precision: {metrics['precision_weighted']:.4f}")
    print(f"Weighted Recall: {metrics['recall_weighted']:.4f}")
    print(f"Weighted F1: {metrics['f1_weighted']:.4f}")
    if "roc_auc_macro" in metrics:
        print(f"Macro ROC-AUC: {metrics['roc_auc_macro']:.4f}")
    print("\nPer-class metrics:")
    header = f"{'class':<12}{'precision':>10}{'recall':>10}{'f1':>10}"
    if "roc_auc_per_class" in metrics:
        header += f"{'auc':>10}"
    print(header)
    for i, name in enumerate(class_names):
        row = (
            f"{name:<12}"
            f"{metrics['precision_per_class'][i]:>10.4f}"
            f"{metrics['recall_per_class'][i]:>10.4f}"
            f"{metrics['f1_per_class'][i]:>10.4f}"
        )
        if "roc_auc_per_class" in metrics:
            row += f"{metrics['roc_auc_per_class'][i]:>10.4f}"
        print(row)
    print("=" * 60)


def roc_points(y_true, y_prob, class_names) -> dict[str, dict]:
    """Per class present in y_true with both groups non-empty: its ROC curve
    points (fpr, tpr, thresholds as lists) and AUC, what the ROC plot draws."""
    y_true, y_prob = np.asarray(y_true).ravel(), np.asarray(y_prob)
    out = {}
    for i, name in enumerate(class_names):
        binary = (y_true == i).astype(int)
        if binary.size == 0 or binary.min() == binary.max():
            continue
        fpr, tpr, thr = roc_curve(binary, y_prob[:, i])
        out[name] = {"fpr": fpr.tolist(), "tpr": tpr.tolist(),
                     "thresholds": [float(t) for t in thr], "auc": roc_auc(binary, y_prob[:, i])}
    return out
