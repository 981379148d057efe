"""Model registry: `config["model"]["architecture"]` -> nn.Module.

Port of `audio_classification_icbhi_tpu/models/registry.py:28-74`, with the
same precision resolution: training.precision, else bf16 when
training.mixed_precision is set, else fp32.
"""

from __future__ import annotations

from typing import Any

import torch

_DTYPES = {"bf16": torch.bfloat16, "fp16": torch.float16, "fp32": torch.float32}


def _architectures() -> dict:
    from audio_classification_icbhi_tpu_torch.models.cnn import LightweightCNN
    from audio_classification_icbhi_tpu_torch.models.resnet import CompactResNet

    return {"cnn": LightweightCNN, "resnet": CompactResNet}


def available_models() -> list[str]:
    return sorted(_architectures())


def compute_dtype(config: dict[str, Any]) -> torch.dtype:
    tcfg = config.get("training", {})
    precision = tcfg.get("precision")
    if precision is None:
        precision = "bf16" if tcfg.get("mixed_precision", False) else "fp32"
    return _DTYPES[precision]


def build_model(config: dict[str, Any], dtype: torch.dtype | None = None,
                generator: torch.Generator | None = None, axis_name=None):
    """Build a model from a config dict (model section: architecture,
    num_classes, dropout), initialised from `generator`. `axis_name` is the
    data-parallel process group (`parallel/mesh.Mesh.group`) its BatchNorm
    statistics are taken over, or None (`registry.py:28` of the JAX
    package takes the mesh axis name)."""
    arch = config["model"]["architecture"].lower()
    classes = _architectures()
    if arch not in classes:
        raise ValueError(f"Unknown model architecture: {arch!r} (have {available_models()})")
    return classes[arch](
        num_classes=config["model"]["num_classes"],
        dropout=config["model"]["dropout"],
        dtype=compute_dtype(config) if dtype is None else dtype,
        generator=generator,
        axis_name=axis_name,
    )

