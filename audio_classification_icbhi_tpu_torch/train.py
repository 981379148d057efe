"""Train an ICBHI classifier on whole recordings, on the GPU.

    python -m audio_classification_icbhi_tpu_torch.train --config config.yaml \
        --data-path data/ICBHI [--epochs N] [--device cuda|cpu]

Port of the repository's `train.py:19-107`, with its flags --config --model
--epochs --batch-size --learning-rate --device --data-path --resume
--profile, and --no-plots. --device defaults to cuda and raises where there
is no GPU; the CPU runs only when asked. The multi-host flags wait for
ROADMAP.md A10. After training it prints where the best checkpoint went and
draws training_history.png in the working directory (`utils/plotting`,
which needs matplotlib) unless --no-plots.
"""

from __future__ import annotations

import argparse

from audio_classification_icbhi_tpu_torch.data.dataset import ICBHIDataset
from audio_classification_icbhi_tpu_torch.models import build_model
from audio_classification_icbhi_tpu_torch.training.trainer import Trainer
from audio_classification_icbhi_tpu_torch.utils import plotting
from audio_classification_icbhi_tpu_torch.utils.config import load_config, resolve_device, set_seed


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Train audio classification model")
    parser.add_argument("--config", type=str, default=None, help="Path to configuration file")
    parser.add_argument("--model", type=str, choices=["cnn", "resnet"], help="Model architecture")
    parser.add_argument("--epochs", type=int, help="Number of epochs")
    parser.add_argument("--batch-size", type=int, help="Batch size")
    parser.add_argument("--learning-rate", type=float, help="Learning rate")
    parser.add_argument("--device", type=str, choices=["cuda", "cpu"], default="cuda",
                        help="Device to train on (default cuda; cpu only when asked)")
    parser.add_argument("--data-path", type=str, help="Override data.dataset_path")
    parser.add_argument("--resume", type=str, help="Checkpoint to resume from")
    parser.add_argument("--profile", type=str, metavar="DIR",
                        help="Write a torch.profiler trace of the first epoch to DIR")
    parser.add_argument("--no-plots", action="store_true",
                        help="Skip the training-history PNG (no matplotlib needed)")
    return parser.parse_args(argv)


def build_trainer(args, dataset_cls, trainer_cls, default_config: str):
    """Shared setup of the train entry points."""
    device = resolve_device(args.device)  # no GPU and no --device cpu: raise first
    config = load_config(args.config if args.config else default_config)
    # `is not None`: --epochs 0 / --learning-rate 0.0 are explicit values
    if args.model:
        config["model"]["architecture"] = args.model
    if args.epochs is not None:
        config["training"]["epochs"] = args.epochs
    if args.batch_size is not None:
        config["training"]["batch_size"] = args.batch_size
    if args.learning_rate is not None:
        config["training"]["learning_rate"] = args.learning_rate
    if args.data_path:
        config["data"]["dataset_path"] = args.data_path
    set_seed(config.get("seed", 42))

    print("\n" + "=" * 60)
    print("TRAINING CONFIGURATION")
    print("=" * 60)
    print(f"Model: {config['model']['architecture']}")
    print(f"Epochs: {config['training']['epochs']}")
    print(f"Batch size: {config['training']['batch_size']}")
    print(f"Learning rate: {config['training']['learning_rate']}")
    print(f"Device: {device}")
    print("=" * 60)

    augment = bool(config["data"].get("augmentation", False))
    train_ds = dataset_cls(config["data"]["dataset_path"], "train", config, augment=augment)
    val_ds = dataset_cls(config["data"]["dataset_path"], "val", config, augment=False)
    return trainer_cls(build_model(config), train_ds, val_ds, config, device=device)


def report(trainer, history: dict, args, plot, png: str, what: str = "Training history") -> None:
    """Where the best checkpoint went, and the history drawn by `plot` (a
    `utils/plotting` function) to `png` unless --no-plots."""
    print(f"Best checkpoint: {trainer.checkpoint_dir / 'best_model.ckpt'}")
    if not args.no_plots:
        plot(history, save_path=png)
        print(f"{what} saved to {png}")


def main(argv=None):
    args = parse_args(argv)
    trainer = build_trainer(args, ICBHIDataset, Trainer, "config.yaml")
    history = trainer.train(resume_from=args.resume, profile_dir=args.profile)
    report(trainer, history, args, plotting.plot_training_history, "training_history.png")
    return history


if __name__ == "__main__":
    main()
