"""Model registry: `config["model"]["architecture"]` -> nn.Module.

Port of `audio_classification_icbhi_tpu/models/registry.py:14-71`, with the
same precision resolution: training.precision, else bf16 when
training.mixed_precision is set, else fp32. The builtins are registered
with setdefault, as there, so a class registered under "cnn", "resnet" or
"ast" before this module loads takes their place. "ast" (`models/ast.py`)
is the port's alone.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

_DTYPES = {"bf16": torch.bfloat16, "fp16": torch.float16, "fp32": torch.float32}

_REGISTRY: dict[str, Callable] = {}


def register_model(name: str):
    """Class decorator: build_model builds `name` (any case) with this class, and so do
    the entry points and engines that build through it (the trainers,
    `ClassifierEngine`, `AnalyzerEngine` and the Validator over its model).

    The class takes the port's contract:
    - `__init__(num_classes, dropout, dtype, generator, axis_name)`:
      parameters in float32, computing in `dtype`, initialised from
      `generator`; `axis_name` is the data-parallel process group or None;
    - `reset_parameters(generator)`, which the trainers call with the
      config's seed;
    - `forward(x, generator=None)`: x (B, n_mels, T, 1) -> (B, num_classes)
      float32 logits, its train-mode dropout drawn from `generator`.
    Its weights cross the msgpack and orbax checkpoints by the name table a
    `weight_table()` static method returns (rows of (torch module name,
    flax module path, "conv" | "linear" | "bn"), as `models/weights.py`'s
    builtin tables), or without one, under the state_dict's own names
    split at the dots."""
    def deco(cls):
        _REGISTRY[name.lower()] = cls  # looked up in any case, as the configs name it
        return cls
    return deco


def available_models() -> list[str]:
    return sorted(_REGISTRY)


def model_class(architecture: str):
    """The class registered under `architecture` (any case)."""
    arch = architecture.lower()
    if arch not in _REGISTRY:
        raise ValueError(f"Unknown model architecture: {arch!r} (have {available_models()})")
    return _REGISTRY[arch]


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
    return model_class(config["model"]["architecture"])(
        num_classes=config["model"]["num_classes"],
        dropout=config["model"]["dropout"],
        dtype=compute_dtype(config) if dtype is None else dtype,
        generator=generator,
        axis_name=axis_name,
    )


def _register_builtins():
    from audio_classification_icbhi_tpu_torch.models.ast import AST
    from audio_classification_icbhi_tpu_torch.models.cnn import LightweightCNN
    from audio_classification_icbhi_tpu_torch.models.resnet import CompactResNet

    _REGISTRY.setdefault("cnn", LightweightCNN)
    _REGISTRY.setdefault("resnet", CompactResNet)
    _REGISTRY.setdefault("ast", AST)  # the port's own: the JAX package has no transformer


_register_builtins()
