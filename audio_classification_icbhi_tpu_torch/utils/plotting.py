"""Reporting plots (matplotlib and seaborn, host side).

Port of the six plot functions of
`audio_classification_icbhi_tpu/utils/plotting.py:40-174`: the confusion
matrix heatmap, the one-vs-rest ROC curves, the training history, the ICBHI
metric bars, the annotated ICBHI confusion matrix and the 4-panel ICBHI
training history, under the JAX package's file names.

matplotlib and seaborn are imported inside each function, so importing the
package, validating or training never needs them (the machine with the card
has neither). A plot asked for where they are missing raises ImportError.
The matrices and curves come from `utils/metrics` (`confusion_matrix`,
`roc_points`), so a picture shows the numbers the reports write.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from audio_classification_icbhi_tpu_torch.utils.icbhi_metrics import (
    DEFAULT_CLASSES as ICBHI_CLASSES,
)
from audio_classification_icbhi_tpu_torch.utils.metrics import (
    DEFAULT_CLASSES,
    confusion_matrix,
    roc_points,
)


def pyplot():
    """matplotlib.pyplot on the headless Agg backend; ImportError naming
    --no-plots where matplotlib is missing."""
    try:
        import matplotlib

        matplotlib.use("Agg")  # headless
        import matplotlib.pyplot as plt
    except ImportError as e:
        raise ImportError(
            "audio_classification_icbhi_tpu_torch.utils.plotting draws with matplotlib, "
            "which is not installed here; install it, or pass --no-plots") from e
    return plt


def seaborn():
    """seaborn; ImportError naming --no-plots where it is missing."""
    try:
        import seaborn as sns
    except ImportError as e:
        raise ImportError(
            "audio_classification_icbhi_tpu_torch.utils.plotting draws heatmaps with "
            "seaborn, which is not installed here; install it, or pass --no-plots") from e
    return sns


def _save(plt, fig, save_path) -> None:
    if save_path:
        Path(save_path).parent.mkdir(parents=True, exist_ok=True)
        fig.savefig(save_path, dpi=150, bbox_inches="tight")
    plt.close(fig)


def plot_confusion_matrix(y_true, y_pred, class_names=None, save_path=None, normalize=False):
    """Heatmap of the confusion matrix, rows true; returns the counts."""
    plt, sns = pyplot(), seaborn()
    class_names = class_names or DEFAULT_CLASSES
    cm = confusion_matrix(y_true, y_pred, list(range(len(class_names))))
    fmt, data = "d", cm
    if normalize:
        data = cm.astype(float) / np.maximum(cm.sum(axis=1, keepdims=True), 1)
        fmt = ".2f"
    fig, ax = plt.subplots(figsize=(8, 6))
    sns.heatmap(data, annot=True, fmt=fmt, cmap="Blues",
                xticklabels=class_names, yticklabels=class_names, ax=ax)
    ax.set_xlabel("Predicted")
    ax.set_ylabel("True")
    ax.set_title("Confusion Matrix" + (" (normalized)" if normalize else ""))
    _save(plt, fig, save_path)
    return cm


def plot_roc_curves(y_true, y_prob, class_names=None, save_path=None):
    """One-vs-rest ROC curves of the classes present; returns the points
    drawn (`metrics.roc_points`)."""
    plt = pyplot()
    class_names = class_names or DEFAULT_CLASSES
    points = roc_points(y_true, y_prob, class_names)
    fig, ax = plt.subplots(figsize=(8, 6))
    for name, p in points.items():
        ax.plot(p["fpr"], p["tpr"], label=f"{name} (AUC = {p['auc']:.3f})")
    ax.plot([0, 1], [0, 1], "k--", alpha=0.5)
    ax.set_xlabel("False Positive Rate")
    ax.set_ylabel("True Positive Rate")
    ax.set_title("ROC Curves (one-vs-rest)")
    if points:
        ax.legend(loc="lower right")
    _save(plt, fig, save_path)
    return points


def plot_training_history(history: dict, save_path=None):
    """Loss and accuracy curves by epoch."""
    plt = pyplot()
    fig, axes = plt.subplots(1, 2, figsize=(14, 5))
    epochs = range(1, len(history["train_loss"]) + 1)
    axes[0].plot(epochs, history["train_loss"], label="train")
    axes[0].plot(epochs, history["val_loss"], label="val")
    axes[0].set_title("Loss")
    axes[0].set_xlabel("Epoch")
    axes[0].legend()
    axes[1].plot(epochs, history["train_acc"], label="train")
    axes[1].plot(epochs, history["val_acc"], label="val")
    axes[1].set_title("Accuracy (%)")
    axes[1].set_xlabel("Epoch")
    axes[1].legend()
    fig.tight_layout()
    _save(plt, fig, save_path)


def plot_icbhi_metrics(metrics: dict, class_names=None, save_path=None):
    """Per-class sensitivity, specificity and harmonic score bars, and the
    overall scores (`icbhi_metrics.calculate_icbhi_score`'s dict)."""
    plt = pyplot()
    class_names = class_names or ICBHI_CLASSES
    fig, axes = plt.subplots(1, 2, figsize=(14, 5))
    x = np.arange(len(class_names))
    width = 0.27
    per_class = metrics["per_class_metrics"]
    for offset, key, label in ((-width, "sensitivity", "sensitivity"),
                               (0.0, "specificity", "specificity"),
                               (width, "harmonic_score", "harmonic")):
        axes[0].bar(x + offset, [per_class[c][key] for c in class_names], width, label=label)
    axes[0].set_xticks(x)
    axes[0].set_xticklabels(class_names)
    axes[0].set_ylim(0, 1.05)
    axes[0].set_title("Per-class ICBHI metrics")
    axes[0].legend()
    overall = [metrics["avg_sensitivity"], metrics["avg_specificity"], metrics["icbhi_score"],
               metrics["accuracy"]]
    axes[1].bar(["avg sens", "avg spec", "ICBHI", "accuracy"], overall, color="tab:blue")
    axes[1].set_ylim(0, 1.05)
    axes[1].set_title(f"ICBHI Score: {metrics['icbhi_score']:.4f}")
    fig.tight_layout()
    _save(plt, fig, save_path)


def plot_icbhi_confusion_matrix(y_true, y_pred, class_names=None, save_path=None):
    """Confusion matrix annotated with counts and row percentages; returns
    the counts."""
    plt, sns = pyplot(), seaborn()
    class_names = class_names or ICBHI_CLASSES
    cm = confusion_matrix(y_true, y_pred, list(range(len(class_names))))
    row_sums = np.maximum(cm.sum(axis=1, keepdims=True), 1)
    annot = np.empty(cm.shape, dtype=object)
    for i in range(cm.shape[0]):
        for j in range(cm.shape[1]):
            annot[i, j] = f"{cm[i, j]}\n({100 * cm[i, j] / row_sums[i, 0]:.1f}%)"
    fig, ax = plt.subplots(figsize=(9, 7))
    sns.heatmap(cm, annot=annot, fmt="", cmap="Blues",
                xticklabels=class_names, yticklabels=class_names, ax=ax)
    ax.set_xlabel("Predicted")
    ax.set_ylabel("True")
    ax.set_title("ICBHI Confusion Matrix")
    _save(plt, fig, save_path)
    return cm


def plot_icbhi_history(history: dict, save_path=None):
    """4-panel ICBHI training history: loss, accuracy, ICBHI score, and
    sensitivity / specificity by epoch."""
    plt = pyplot()
    fig, axes = plt.subplots(2, 2, figsize=(14, 10))
    epochs = range(1, len(history["train_loss"]) + 1)
    axes[0, 0].plot(epochs, history["train_loss"], label="train")
    axes[0, 0].plot(epochs, history["val_loss"], label="val")
    axes[0, 0].set_title("Loss")
    axes[0, 0].legend()
    axes[0, 1].plot(epochs, history["train_acc"], label="train")
    axes[0, 1].plot(epochs, history["val_acc"], label="val")
    axes[0, 1].set_title("Accuracy (%)")
    axes[0, 1].legend()
    axes[1, 0].plot(epochs, history["icbhi_score"], color="tab:green")
    axes[1, 0].set_title("ICBHI Score")
    axes[1, 0].set_xlabel("Epoch")
    axes[1, 1].plot(epochs, history["sensitivity"], label="sensitivity")
    axes[1, 1].plot(epochs, history["specificity"], label="specificity")
    axes[1, 1].set_title("Sensitivity / Specificity")
    axes[1, 1].set_xlabel("Epoch")
    axes[1, 1].legend()
    fig.tight_layout()
    _save(plt, fig, save_path)
