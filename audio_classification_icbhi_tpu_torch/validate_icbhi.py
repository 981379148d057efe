"""Evaluate a checkpoint with ICBHI 2017 scoring on the segmented data.

    python -m audio_classification_icbhi_tpu_torch.validate_icbhi --model best_model.ckpt \
        [--config config_segmented.yaml] [--split test] [--data-path data/ICBHI_segmented] \
        [--output-dir validation_results] [--device cuda|cpu] [--no-plots]

Port of the repository's `validate_icbhi.py:41-81`: the flags and the
checkpoint-config-first contract of `validate`, the per-cycle
`ICBHISegmentedDataset` at config_segmented.yaml, the ICBHI score and the
per-class sensitivity / specificity printed, and icbhi_results_{split}.txt
with the JAX script's lines; unless --no-plots, icbhi_metrics_{split}.png
and confusion_matrix_{split}.png.
"""

from __future__ import annotations

from pathlib import Path

from audio_classification_icbhi_tpu_torch.data.dataset_segmented import ICBHISegmentedDataset
from audio_classification_icbhi_tpu_torch.utils.icbhi_metrics import (
    calculate_detailed_confusion_metrics,
    calculate_icbhi_score,
    print_icbhi_metrics,
)
from audio_classification_icbhi_tpu_torch.validate import parse_args, predict_split

SEG_CLASSES = ["normal", "crackle", "wheeze", "both"]


def results_text(split: str, metrics: dict, detailed: dict) -> str:
    """The text of icbhi_results_{split}.txt."""
    lines = [
        f"ICBHI 2017 results ({split} split)",
        "=" * 50,
        f"ICBHI Score:      {metrics['icbhi_score']:.4f}",
        f"Avg Sensitivity:  {metrics['avg_sensitivity']:.4f}",
        f"Avg Specificity:  {metrics['avg_specificity']:.4f}",
        f"Accuracy:         {metrics['accuracy']:.4f}",
        "",
    ]
    for name in SEG_CLASSES:
        m = metrics["per_class_metrics"][name]
        d = detailed["per_class"][name]
        lines.append(f"{name}: sens={m['sensitivity']:.4f} spec={m['specificity']:.4f} "
                     f"TP={d['TP']} FP={d['FP']} FN={d['FN']} TN={d['TN']}")
    return "\n".join(lines) + "\n"


def main(argv=None) -> dict:
    """Returns the ICBHI metrics, with the split's arrays under y_true,
    y_pred, y_prob and logits."""
    args = parse_args(argv, default_config="config_segmented.yaml",
                      description="Validate with ICBHI 2017 scoring")
    _, y_true, y_pred, y_prob, logits = predict_split(args, ICBHISegmentedDataset)
    metrics = calculate_icbhi_score(y_true, y_pred, class_names=SEG_CLASSES)
    print_icbhi_metrics(metrics, class_names=SEG_CLASSES)
    detailed = calculate_detailed_confusion_metrics(y_true, y_pred, class_names=SEG_CLASSES)

    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / f"icbhi_results_{args.split}.txt").write_text(results_text(args.split, metrics, detailed))
    if not args.no_plots:
        from audio_classification_icbhi_tpu_torch.utils import plotting

        plotting.plot_icbhi_metrics(metrics, class_names=SEG_CLASSES,
                                    save_path=out / f"icbhi_metrics_{args.split}.png")
        plotting.plot_icbhi_confusion_matrix(y_true, y_pred, class_names=SEG_CLASSES,
                                             save_path=out / f"confusion_matrix_{args.split}.png")
    print(f"\n✓ Reports saved to {out}/")
    return dict(metrics, y_true=y_true, y_pred=y_pred, y_prob=y_prob, logits=logits)


if __name__ == "__main__":
    main()
