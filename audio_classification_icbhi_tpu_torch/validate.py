"""Evaluate a checkpoint: metrics, a JSON report, and the confusion matrix
and ROC pictures.

    python -m audio_classification_icbhi_tpu_torch.validate --model best_model.ckpt \
        [--config config.yaml] [--split test] [--data-path data/ICBHI] \
        [--output-dir validation_results] [--device cuda|cpu] [--no-plots]

Port of the repository's `validate.py:36-67`: the checkpoint's embedded
config wins and --config is the fallback; the whole-recording dataset's
split runs through `training/validation.Validator`; the metrics print as
the JAX script prints them. It writes validation_{split}.json (the metrics,
the confusion matrix and the per-class ROC points, from `utils/metrics`)
and, unless --no-plots, confusion_matrix_{split}.png and
roc_curves_{split}.png (`utils/plotting`, which needs matplotlib and
seaborn). --device defaults to cuda and raises where there is no GPU.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from audio_classification_icbhi_tpu_torch.data.dataset import ICBHIDataset
from audio_classification_icbhi_tpu_torch.inference import ClassifierEngine
from audio_classification_icbhi_tpu_torch.training.validation import Validator
from audio_classification_icbhi_tpu_torch.utils.config import load_config, resolve_device, set_seed
from audio_classification_icbhi_tpu_torch.utils.metrics import (
    calculate_metrics,
    confusion_matrix,
    print_metrics,
    roc_points,
)


def parse_args(argv=None, default_config: str = "config.yaml",
               description: str = "Validate audio classification model"):
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--model", type=str, required=True, help="Path to model checkpoint")
    parser.add_argument("--config", type=str, default=default_config, help="Fallback config file")
    parser.add_argument("--split", type=str, default="test", choices=["train", "val", "test"])
    parser.add_argument("--data-path", type=str, help="Override data.dataset_path")
    parser.add_argument("--output-dir", type=str, default="validation_results",
                        help="Directory for reports")
    parser.add_argument("--device", type=str, choices=["cuda", "cpu"], default="cuda",
                        help="Device to validate on (default cuda; cpu only when asked)")
    parser.add_argument("--no-plots", action="store_true",
                        help="Write the reports without the PNGs (no matplotlib needed)")
    return parser.parse_args(argv)


def predict_split(args, dataset_cls):
    """The shared part of the validate entry points: the checkpoint's config
    (the file's as fallback), the split, the Validator's pass. Returns
    (config, y_true, y_pred, y_prob, logits)."""
    device = resolve_device(args.device)
    engine = ClassifierEngine(args.model, config=load_config(args.config), device=device)
    config = engine.config
    if args.data_path:
        config["data"]["dataset_path"] = args.data_path
    set_seed(config.get("seed", 42))
    dataset = dataset_cls(config["data"]["dataset_path"], args.split, config, augment=False)
    validator = Validator(engine.model, dataset, config, device=device)
    return (config, *validator.validate(with_logits=True))


def report(y_true, y_pred, y_prob, class_names) -> dict:
    """What validation_{split}.json holds."""
    return {
        "metrics": calculate_metrics(y_true, y_pred, y_prob, class_names=class_names),
        "confusion_matrix": confusion_matrix(y_true, y_pred,
                                             list(range(len(class_names)))).tolist(),
        "roc_curves": roc_points(y_true, y_prob, class_names),
    }


def main(argv=None) -> dict:
    """Returns the report, with the split's arrays under y_true, y_pred,
    y_prob and logits."""
    args = parse_args(argv)
    config, y_true, y_pred, y_prob, logits = predict_split(args, ICBHIDataset)
    class_names = config["classes"]
    result = report(y_true, y_pred, y_prob, class_names)
    print_metrics(result["metrics"])

    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / f"validation_{args.split}.json").write_text(json.dumps(result, indent=2))
    if not args.no_plots:
        from audio_classification_icbhi_tpu_torch.utils import plotting

        plotting.plot_confusion_matrix(y_true, y_pred, class_names=class_names,
                                       save_path=out / f"confusion_matrix_{args.split}.png")
        plotting.plot_roc_curves(y_true, y_prob, class_names=class_names,
                                 save_path=out / f"roc_curves_{args.split}.png")
    print(f"\n✓ Reports saved to {out}/")
    return dict(result, y_true=y_true, y_pred=y_pred, y_prob=y_prob, logits=logits)


if __name__ == "__main__":
    main()
