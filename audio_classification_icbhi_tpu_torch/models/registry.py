"""Model registry: `config["model"]["architecture"]` -> nn.Module.

Port of `audio_classification_icbhi_tpu/models/registry.py:28-74`, with the
same precision resolution: training.precision, else bf16 when
training.mixed_precision is set, else fp32.
"""

from __future__ import annotations

from typing import Any

import torch

_DTYPES = {"bf16": torch.bfloat16, "fp16": torch.float16, "fp32": torch.float32}


def available_models() -> list[str]:
    return ["cnn"]


def compute_dtype(config: dict[str, Any]) -> torch.dtype:
    tcfg = config.get("training", {})
    precision = tcfg.get("precision")
    if precision is None:
        precision = "bf16" if tcfg.get("mixed_precision", False) else "fp32"
    return _DTYPES[precision]


def build_model(config: dict[str, Any], dtype: torch.dtype | None = None,
                generator: torch.Generator | None = None):
    """Build a model from a config dict (model section: architecture,
    num_classes, dropout), initialised from `generator`."""
    from audio_classification_icbhi_tpu_torch.models.cnn import LightweightCNN

    arch = config["model"]["architecture"].lower()
    if arch == "resnet":
        raise NotImplementedError(
            "CompactResNet18 is not ported yet (ROADMAP.md A9)")
    if arch != "cnn":
        raise ValueError(f"Unknown model architecture: {arch!r} (have {available_models()})")
    return LightweightCNN(
        num_classes=config["model"]["num_classes"],
        dropout=config["model"]["dropout"],
        dtype=compute_dtype(config) if dtype is None else dtype,
        generator=generator,
    )


def check_fused_cnn_opt_in(feats_shape: tuple[int, ...], device: str | torch.device) -> None:
    """Raise where the JAX package's engines would take its fused Pallas
    CNN (`models/fused_infer.py:131-160`): `ICBHI_FUSED_CNN=1` (or the older
    `BENCH_FUSED_CNN=1`), on the accelerator, for a one-channel feature
    shape (B, n_mels, T, 1) with n_mels % 16 == 0, n_mels >= 32 and T >= 4.
    Those conv kernels have no Hopper port yet, and the port does not run
    cuDNN's convs in their place unasked. On the CPU the JAX package runs
    XLA's convs whatever the switch says, and so does the port."""
    import os

    asked = os.environ.get("ICBHI_FUSED_CNN", os.environ.get("BENCH_FUSED_CNN", "0")) == "1"
    _, h, w, c = feats_shape
    if (asked and torch.device(device).type == "cuda"
            and c == 1 and h % 16 == 0 and h >= 32 and w >= 4):
        raise NotImplementedError(
            "ICBHI_FUSED_CNN=1 asks for the fused conv-block kernels, which have no "
            "Hopper port yet (ROADMAP.md B8-B9, then A12); unset it to run the "
            "model's cuDNN convs")
