"""ICBHI 2017 Challenge scoring (numpy only).

A copy of `audio_classification_icbhi_tpu/utils/icbhi_metrics.py`:
- per-class one-vs-rest sensitivity/specificity
- per-class harmonic score 2*sens*spec/(sens+spec)
- ICBHI score = harmonic mean of (mean sensitivity, mean specificity)
- detailed TP/FP/FN/TN tables from the multi-class confusion matrix
"""

from __future__ import annotations

import numpy as np

DEFAULT_CLASSES = ["normal", "crackle", "wheeze", "both"]


def calculate_sensitivity_specificity(y_true, y_pred, class_idx: int) -> tuple[float, float]:
    """One-vs-rest sensitivity/specificity for one class
    (reference icbhi_metrics.py:9-37)."""
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    t = y_true == class_idx
    p = y_pred == class_idx
    tp = int(np.sum(t & p))
    tn = int(np.sum(~t & ~p))
    fp = int(np.sum(~t & p))
    fn = int(np.sum(t & ~p))
    sens = tp / (tp + fn) if (tp + fn) > 0 else 0.0
    spec = tn / (tn + fp) if (tn + fp) > 0 else 0.0
    return sens, spec


def calculate_icbhi_score(y_true, y_pred, class_names: list[str] | None = None) -> dict:
    """ICBHI 2017 score dictionary (reference icbhi_metrics.py:40-122)."""
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    if class_names is None:
        class_names = DEFAULT_CLASSES

    sensitivities, specificities = [], []
    per_class = {}
    for idx, name in enumerate(class_names):
        sens, spec = calculate_sensitivity_specificity(y_true, y_pred, idx)
        sensitivities.append(sens)
        specificities.append(spec)
        hs = 2 * sens * spec / (sens + spec) if (sens + spec) > 0 else 0.0
        per_class[name] = {"sensitivity": sens, "specificity": spec, "harmonic_score": hs}

    avg_sens = float(np.mean(sensitivities))
    avg_spec = float(np.mean(specificities))
    icbhi = 2 * avg_sens * avg_spec / (avg_sens + avg_spec) if (avg_sens + avg_spec) > 0 else 0.0

    return {
        "icbhi_score": float(icbhi),
        "avg_sensitivity": avg_sens,
        "avg_specificity": avg_spec,
        "avg_harmonic_score": float(np.mean([m["harmonic_score"] for m in per_class.values()])),
        "accuracy": float(np.mean(y_true == y_pred)) if len(y_true) else 0.0,
        "per_class_metrics": per_class,
        "sensitivities": sensitivities,
        "specificities": specificities,
    }


def calculate_detailed_confusion_metrics(
    y_true, y_pred, class_names: list[str] | None = None
) -> dict:
    """Per-class TP/FP/FN/TN table from the 4x4 confusion matrix
    (reference icbhi_metrics.py:245-287)."""
    if class_names is None:
        class_names = DEFAULT_CLASSES
    n = len(class_names)
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    cm = np.zeros((n, n), dtype=np.int64)
    for t, p in zip(y_true, y_pred):
        cm[int(t), int(p)] += 1
    out = {"confusion_matrix": cm, "per_class": {}}
    total = cm.sum()
    for i, name in enumerate(class_names):
        tp = cm[i, i]
        fp = cm[:, i].sum() - tp
        fn = cm[i, :].sum() - tp
        tn = total - tp - fp - fn
        out["per_class"][name] = {
            "TP": int(tp),
            "FP": int(fp),
            "FN": int(fn),
            "TN": int(tn),
            "precision": float(tp / (tp + fp)) if (tp + fp) > 0 else 0.0,
            "recall": float(tp / (tp + fn)) if (tp + fn) > 0 else 0.0,
        }
    return out


def print_icbhi_metrics(metrics: dict, class_names: list[str] | None = None) -> None:
    """Formatted ICBHI report (reference icbhi_metrics.py:125-165)."""
    if class_names is None:
        class_names = DEFAULT_CLASSES
    print("\n" + "=" * 70)
    print("ICBHI 2017 CHALLENGE SCORE")
    print("=" * 70)
    print(f"ICBHI Score:        {metrics['icbhi_score']:.4f}")
    print(f"Avg Sensitivity:    {metrics['avg_sensitivity']:.4f}")
    print(f"Avg Specificity:    {metrics['avg_specificity']:.4f}")
    print(f"Avg Harmonic Score: {metrics['avg_harmonic_score']:.4f}")
    print(f"Accuracy:           {metrics['accuracy']:.4f}")
    print("-" * 70)
    print(f"{'class':<12}{'sensitivity':>14}{'specificity':>14}{'harmonic':>12}")
    for name in class_names:
        m = metrics["per_class_metrics"][name]
        print(
            f"{name:<12}{m['sensitivity']:>14.4f}{m['specificity']:>14.4f}"
            f"{m['harmonic_score']:>12.4f}"
        )
    print("=" * 70)
