"""Dataset diagnostics: load check, class balance, a NaN/Inf scan through the
front end, a sample panel, and one batch through the model and the loss.

    python -m audio_classification_icbhi_tpu_torch.diagnose_data [--config config.yaml]
        [--segmented] [--data-path d] [--device cuda|cpu] [--no-plots]

Port of the repository's `diagnose_data.py:24-104`, step for step:
- the train split's class counts, and a warning where the largest is more
  than 5x the smallest non-zero one (`class_balance`);
- the normalized log-mel of the first samples through the port's
  `MelFrontend` (on the card, the row-1 kernel), with its mean, std, min
  and max and a flag where it holds a NaN or an Inf (`mel_statistics`);
- those samples' mel images in data_samples.png in the working directory,
  unless --no-plots (matplotlib, which the machine with the card lacks);
- the first batch of 8 through `build_model` (seeded by the config's seed)
  and `weighted_cross_entropy` with unit weights, and a warning where the
  loss is more than 1 from ln(C), the loss of a uniform guess
  (`first_batch_loss`).

--data-path overrides the config's data.dataset_path. --device defaults to
cuda and raises where there is no GPU.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from audio_classification_icbhi_tpu_torch.data.dataset import ICBHIDataset
from audio_classification_icbhi_tpu_torch.data.dataset_segmented import ICBHISegmentedDataset
from audio_classification_icbhi_tpu_torch.data.loader import BatchLoader
from audio_classification_icbhi_tpu_torch.models import build_model
from audio_classification_icbhi_tpu_torch.ops.mel import MelFrontend
from audio_classification_icbhi_tpu_torch.parallel.data_parallel import (
    features_from_wavs,
    weighted_cross_entropy,
)
from audio_classification_icbhi_tpu_torch.utils.config import load_config, resolve_device, set_seed
from audio_classification_icbhi_tpu_torch.utils.plotting import pyplot


def class_balance(dataset, config: dict) -> tuple[np.ndarray, bool]:
    """(counts per class, whether the largest non-zero count is more than 5x
    the smallest), printed."""
    counts = np.bincount(dataset.labels, minlength=config["model"]["num_classes"])
    print("Class distribution:")
    for i, c in enumerate(counts):
        print(f"  {config['classes'][i]}: {c}")
    nonzero = counts[counts > 0]
    imbalanced = bool(len(nonzero) and nonzero.max() > 5 * max(nonzero.min(), 1))
    if imbalanced:
        print("WARNING: severe class imbalance (>5x) detected")
    return counts, imbalanced


@torch.inference_mode()
def mel_statistics(dataset, frontend: MelFrontend, config: dict, n: int,
                   device: torch.device) -> tuple[list[dict], list[np.ndarray]]:
    """The first `n` samples' normalized log-mel: a dict each (label, mean,
    std, min, max, finite), printed, and the images."""
    print("\nSample statistics:")
    stats, images = [], []
    for i in range(min(n, len(dataset))):
        wav, label = dataset[i]
        mel = frontend(torch.as_tensor(wav[None], device=device))[0].float().cpu().numpy()
        finite = bool(np.isfinite(mel).all())
        stats.append(dict(label=int(label), mean=float(mel.mean()), std=float(mel.std()),
                          min=float(mel.min()), max=float(mel.max()), finite=finite))
        images.append(mel)
        print(f"  [{i}] label={config['classes'][label]:<9} mel "
              f"mean={mel.mean():+.3f} std={mel.std():.3f} "
              f"min={mel.min():+.2f} max={mel.max():+.2f}"
              + ("" if finite else "  <-- NaN/Inf DETECTED"))
    return stats, images


def sample_panel(images: list[np.ndarray], labels: list[int], config: dict,
                 path: str = "data_samples.png") -> None:
    plt = pyplot()
    n = len(images)
    fig, axes = plt.subplots(2, (n + 1) // 2, figsize=(4 * ((n + 1) // 2), 6))
    for ax, mel, label in zip(np.ravel(axes), images, labels):
        ax.imshow(mel, aspect="auto", origin="lower", cmap="magma")
        ax.set_title(config["classes"][label])
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    print(f"\nSample visualization saved to {path}")


@torch.inference_mode()
def first_batch_loss(dataset, model: torch.nn.Module, frontend: MelFrontend, config: dict,
                     device: torch.device) -> tuple[tuple[int, ...], float]:
    """The first unshuffled batch of min(8, len) through `model` in eval mode
    and the unit-weight cross entropy: (logits shape, loss), printed."""
    batches = iter(BatchLoader(dataset, batch_size=min(8, len(dataset)), shuffle=False))
    wavs, labels = next(batches)
    batches.close()  # stops the loader's workers
    print(f"\nBatch shapes: wavs={wavs.shape} labels={labels.shape}")
    model = model.to(device).eval()
    feats = features_from_wavs(frontend, torch.as_tensor(wavs, device=device))
    logits = model(feats)
    ones = torch.ones(config["model"]["num_classes"], device=device)
    num, den = weighted_cross_entropy(logits, torch.as_tensor(labels, device=device).long(),
                                      ones)
    loss = float(num) / float(den)
    print(f"Forward OK: logits={tuple(logits.shape)}, initial loss={loss:.4f}")
    expected = float(np.log(config["model"]["num_classes"]))
    if abs(loss - expected) > 1.0:
        print(f"WARNING: initial loss far from ln(C)={expected:.3f}")
    else:
        print(f"Initial loss near ln(C)={expected:.3f} — sane")
    return tuple(logits.shape), loss


def diagnose_dataset(config_path: str, segmented: bool = False, num_viz: int = 6,
                     data_path: str | None = None, device: str | torch.device = "cuda",
                     plots: bool = True) -> dict:
    """Every diagnostic on the train split; returns their numbers."""
    device = resolve_device(device)
    config = load_config(config_path)
    if data_path:
        config["data"]["dataset_path"] = data_path
    generator = set_seed(config.get("seed", 42))
    cls = ICBHISegmentedDataset if segmented else ICBHIDataset
    dataset = cls(config["data"]["dataset_path"], "train", config, augment=False)
    print(f"\nDataset size: {len(dataset)}")
    counts, imbalanced = class_balance(dataset, config)

    dcfg = config["data"]
    frontend = MelFrontend(sample_rate=dcfg["sample_rate"], n_mels=dcfg["n_mels"],
                           n_fft=dcfg["n_fft"], hop_length=dcfg["hop_length"],
                           duration=dcfg["duration"])
    stats, images = mel_statistics(dataset, frontend, config, num_viz, device)
    if plots:
        sample_panel(images, [s["label"] for s in stats], config)

    model = build_model(config, generator=generator)
    logits_shape, loss = first_batch_loss(dataset, model, frontend, config, device)
    print("\n✓ Diagnostics complete")
    return dict(size=len(dataset), counts=counts, imbalanced=imbalanced, samples=stats,
                logits_shape=logits_shape, loss=loss)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description="Diagnose dataset health")
    parser.add_argument("--config", type=str, default="config.yaml")
    parser.add_argument("--segmented", action="store_true")
    parser.add_argument("--data-path", type=str, help="Override data.dataset_path")
    parser.add_argument("--device", type=str, choices=["cuda", "cpu"], default="cuda",
                        help="Device to run on (default cuda; cpu only when asked)")
    parser.add_argument("--no-plots", action="store_true",
                        help="Skip data_samples.png (no matplotlib needed)")
    args = parser.parse_args(argv)
    return diagnose_dataset(args.config, segmented=args.segmented, data_path=args.data_path,
                            device=args.device, plots=not args.no_plots)


if __name__ == "__main__":
    main()
