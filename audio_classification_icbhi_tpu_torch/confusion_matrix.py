"""Confusion-matrix reports: the repository's three confusion-matrix scripts
as one entry point.

    python -m audio_classification_icbhi_tpu_torch.confusion_matrix generate --model m.ckpt
        [--split val] [--data-path d] [--segmented] [--log-dir runs]
        [--output-dir confusion_matrix_results] [--device cuda|cpu] [--no-plots]
    python -m audio_classification_icbhi_tpu_torch.confusion_matrix from-runs [--log-dir runs]
        [--model m.ckpt] [--split val] [--data-path d] [--segmented]
        [--output-dir confusion_matrix_results] [--device cuda|cpu] [--no-plots]
    python -m audio_classification_icbhi_tpu_torch.confusion_matrix quick
        [--save-path confusion_matrix.png]

- generate (`generate_confusion_matrix.py:25-123`): optionally lists the
  scalars of every TensorBoard event file under --log-dir
  (`discover_run_scalars`), re-validates the checkpoint's split through the
  port's `Validator`, and `plot_matrices` writes
  confusion_matrix_{split}.npy and .csv, prints the classification report,
  and draws the count + percentage matrix and the normalized one
  (confusion_matrix_{split}.png, confusion_matrix_{split}_normalized.png);
- from-runs (`generate_confusion_matrix_from_runs.py:18-85`): merges the
  scalars of the event files directly in --log-dir (`summarize_runs`, on
  `utils/tensorboard.read_scalars`) and prints each tag's last and best
  value; with --model it re-validates as generate does and adds the
  metrics and the weighted-average line;
- quick (`quick_confusion_matrix.py:9-30`): `plot_cm` on a seeded random
  example, the template for arrays from any source.

The counts and the report come from `utils/metrics` (numpy), not sklearn,
which the machine with the card lacks; so does matplotlib, and --no-plots
writes the NPY, the CSV and the report without the pictures. --device
defaults to cuda and raises where there is no GPU.
"""

from __future__ import annotations

import argparse
import csv
from pathlib import Path

import numpy as np

from audio_classification_icbhi_tpu_torch.data.dataset import ICBHIDataset
from audio_classification_icbhi_tpu_torch.data.dataset_segmented import ICBHISegmentedDataset
from audio_classification_icbhi_tpu_torch.inference import ClassifierEngine
from audio_classification_icbhi_tpu_torch.training.validation import Validator
from audio_classification_icbhi_tpu_torch.utils.metrics import (
    DEFAULT_CLASSES,
    calculate_metrics,
    classification_report,
    confusion_matrix,
    print_metrics,
)
from audio_classification_icbhi_tpu_torch.utils.plotting import pyplot, seaborn
from audio_classification_icbhi_tpu_torch.utils.tensorboard import read_scalars


def discover_run_scalars(log_dir: str | Path) -> dict[Path, dict]:
    """Every event file under `log_dir`, recursively, with a line a tag:
    its points and last value. Returns {event file: its scalars}."""
    events = sorted(Path(log_dir).rglob("events.out.tfevents.*"))
    if not events:
        print(f"No event files under {log_dir}")
    found = {}
    for ev in events:
        found[ev] = scalars = read_scalars(ev)
        print(f"\n{ev}:")
        for tag, points in sorted(scalars.items()):
            last_step, last_val = points[-1]
            print(f"  {tag}: {len(points)} points, last={last_val:.4f} @ step {last_step}")
    return found


def summarize_runs(log_dir: str | Path) -> dict[str, list]:
    """The scalars of the event files directly in `log_dir`, merged by tag,
    each tag's (step, value) points sorted."""
    merged: dict[str, list] = {}
    for ev in sorted(Path(log_dir).glob("events.out.tfevents.*")):
        for tag, pts in read_scalars(ev).items():
            merged.setdefault(tag, []).extend(pts)
    for tag in merged:
        merged[tag].sort()
    return merged


def plot_matrices(y_true, y_pred, class_names, out_dir: Path, split: str,
                  plots: bool = True) -> np.ndarray:
    """Writes confusion_matrix_{split}.npy and .csv into `out_dir`, prints
    the classification report, and with `plots` draws the count +
    percentage matrix and the normalized one. Returns the counts."""
    out_dir = Path(out_dir)
    cm = confusion_matrix(y_true, y_pred, list(range(len(class_names))))
    row_sums = np.maximum(cm.sum(axis=1, keepdims=True), 1)
    if plots:
        plt, sns = pyplot(), seaborn()
        pct = 100.0 * cm / row_sums
        annot = np.empty(cm.shape, dtype=object)
        for i in range(cm.shape[0]):
            for j in range(cm.shape[1]):
                annot[i, j] = f"{cm[i, j]}\n{pct[i, j]:.1f}%"
        fig, ax = plt.subplots(figsize=(9, 7))
        sns.heatmap(cm, annot=annot, fmt="", cmap="Blues",
                    xticklabels=class_names, yticklabels=class_names, ax=ax)
        ax.set_xlabel("Predicted")
        ax.set_ylabel("True")
        ax.set_title(f"Confusion Matrix ({split})")
        fig.savefig(out_dir / f"confusion_matrix_{split}.png", dpi=150, bbox_inches="tight")
        plt.close(fig)

        fig, ax = plt.subplots(figsize=(9, 7))
        sns.heatmap(cm / row_sums, annot=True, fmt=".2f", cmap="RdYlGn",
                    xticklabels=class_names, yticklabels=class_names, ax=ax,
                    vmin=0.0, vmax=1.0)
        ax.set_xlabel("Predicted")
        ax.set_ylabel("True")
        ax.set_title(f"Normalized Confusion Matrix ({split})")
        fig.savefig(out_dir / f"confusion_matrix_{split}_normalized.png", dpi=150,
                    bbox_inches="tight")
        plt.close(fig)

    print("\n" + classification_report(y_true, y_pred, list(range(len(class_names))),
                                       class_names))
    np.save(out_dir / f"confusion_matrix_{split}.npy", cm)
    with open(out_dir / f"confusion_matrix_{split}.csv", "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow([""] + list(class_names))
        for name, row in zip(class_names, cm):
            writer.writerow([name] + row.tolist())
    return cm


def plot_cm(y_true, y_pred, class_names=None, save_path="confusion_matrix.png") -> np.ndarray:
    """The count heatmap of any (y_true, y_pred), saved to `save_path`;
    returns the counts."""
    plt, sns = pyplot(), seaborn()
    if class_names is None:
        class_names = DEFAULT_CLASSES
    cm = confusion_matrix(y_true, y_pred, list(range(len(class_names))))
    fig, ax = plt.subplots(figsize=(8, 6))
    sns.heatmap(cm, annot=True, fmt="d", cmap="Blues",
                xticklabels=class_names, yticklabels=class_names, ax=ax)
    ax.set_xlabel("Predicted")
    ax.set_ylabel("True")
    ax.set_title("Confusion Matrix")
    fig.savefig(save_path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    print(f"Saved {save_path}")
    return cm


def predict(args) -> tuple[dict, np.ndarray, np.ndarray, np.ndarray]:
    """The checkpoint's split through the Validator on --device: (config,
    y_true, y_pred, y_prob)."""
    engine = ClassifierEngine(args.model, device=args.device)
    config = engine.config
    if args.data_path:
        config["data"]["dataset_path"] = args.data_path
    cls = ICBHISegmentedDataset if args.segmented else ICBHIDataset
    dataset = cls(config["data"]["dataset_path"], args.split, config, augment=False)
    return (config, *Validator(engine.model, dataset, config, device=engine.device).validate())


def _generate(args) -> dict:
    if args.log_dir:
        discover_run_scalars(args.log_dir)
    config, y_true, y_pred, y_prob = predict(args)
    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    cm = plot_matrices(y_true, y_pred, config["classes"], out, args.split,
                       plots=not args.no_plots)
    print(f"Accuracy ({args.split}): {float(np.trace(cm)) / max(cm.sum(), 1):.4f}")
    print(f"✓ Outputs saved to {out}/")
    return dict(cm=cm, y_true=y_true, y_pred=y_pred, y_prob=y_prob)


def _from_runs(args) -> dict:
    scalars = summarize_runs(args.log_dir)
    if scalars:
        print(f"Training scalars found in {args.log_dir}:")
        for tag, pts in sorted(scalars.items()):
            vals = [v for _, v in pts]
            best = max(vals) if "Acc" in tag or "ICBHI" in tag else min(vals)
            print(f"  {tag}: {len(pts)} pts, last={vals[-1]:.4f}, best={best:.4f}")
    else:
        print(f"No event files in {args.log_dir}")
    result = {"scalars": scalars}
    if args.model:
        config, y_true, y_pred, y_prob = predict(args)
        out = Path(args.output_dir)
        out.mkdir(parents=True, exist_ok=True)
        cm = plot_matrices(y_true, y_pred, config["classes"], out, args.split,
                           plots=not args.no_plots)
        metrics = calculate_metrics(y_true, y_pred, y_prob, class_names=config["classes"])
        print_metrics(metrics)
        print(f"weighted avg: P={metrics['precision_weighted']:.4f} "
              f"R={metrics['recall_weighted']:.4f} F1={metrics['f1_weighted']:.4f}")
        print(f"✓ Outputs saved to {out}/")
        result.update(cm=cm, metrics=metrics, y_true=y_true, y_pred=y_pred, y_prob=y_prob)
    return result


def _quick(args) -> dict:
    rng = np.random.default_rng(0)
    y_true = rng.integers(0, 4, 100)
    y_pred = np.where(rng.random(100) < 0.7, y_true, rng.integers(0, 4, 100))
    return {"cm": plot_cm(y_true, y_pred, save_path=args.save_path)}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Confusion-matrix reports")
    sub = parser.add_subparsers(dest="command", required=True)

    def revalidation(p, model_required: bool):
        p.add_argument("--model", type=str, required=model_required, help="Checkpoint path")
        p.add_argument("--split", type=str, default="val",  # from-runs names no choices
                       choices=["train", "val", "test"] if model_required else None)
        p.add_argument("--data-path", type=str, help="Override data.dataset_path")
        p.add_argument("--segmented", action="store_true", help="Use the segmented dataset")
        p.add_argument("--output-dir", type=str, default="confusion_matrix_results")
        p.add_argument("--device", type=str, choices=["cuda", "cpu"], default="cuda",
                       help="Device to validate on (default cuda; cpu only when asked)")
        p.add_argument("--no-plots", action="store_true",
                       help="Write the NPY, the CSV and the report without the PNGs")

    gen = sub.add_parser("generate", help="generate_confusion_matrix.py")
    revalidation(gen, model_required=True)
    gen.add_argument("--log-dir", type=str, help="Also summarize TensorBoard scalars here")
    runs = sub.add_parser("from-runs", help="generate_confusion_matrix_from_runs.py")
    runs.add_argument("--log-dir", type=str, default="runs")
    revalidation(runs, model_required=False)
    quick = sub.add_parser("quick", help="quick_confusion_matrix.py")
    quick.add_argument("--save-path", type=str, default="confusion_matrix.png")
    return parser


def main(argv=None) -> dict:
    """Run one command; returns what it computed (the counts under "cm")."""
    args = build_parser().parse_args(argv)
    return {"generate": _generate, "from-runs": _from_runs, "quick": _quick}[args.command](args)


if __name__ == "__main__":
    main()
