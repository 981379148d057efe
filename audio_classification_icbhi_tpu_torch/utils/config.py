"""Config loading, seeding and device selection.

Port of `audio_classification_icbhi_tpu/utils/config.py:20-111`: the same
YAML schema (sections data/model/training/device/classes/seed) and defaults.
PyYAML is imported only when a YAML path is given.
"""

from __future__ import annotations

import copy
import random
from typing import Any

import numpy as np
import torch

DEFAULT_CONFIG: dict[str, Any] = {
    "data": {
        "dataset_path": "data/ICBHI",
        "sample_rate": 16000,
        "n_mels": 128,
        "n_fft": 2048,
        "hop_length": 512,
        "duration": 8.0,
        "augmentation": True,
        "train_split": 0.7,
        "val_split": 0.15,
        "test_split": 0.15,
    },
    "model": {"architecture": "cnn", "num_classes": 4, "dropout": 0.3},
    "training": {
        "batch_size": 32,
        "epochs": 100,
        "learning_rate": 0.003,
        "weight_decay": 0.0001,
        "optimizer": "adam",
        "scheduler": "cosine",
        "mixed_precision": True,
        "gradient_accumulation_steps": 2,
        "early_stopping_patience": 15,
        "checkpoint_dir": "checkpoints",
        "log_dir": "runs",
        "save_every": 5,
    },
    "device": {"use_cuda": True, "num_workers": 4, "pin_memory": True},
    "classes": ["normal", "crackles", "wheezes", "both"],
    "seed": 42,
}


def _deep_update(base: dict, overrides: dict) -> dict:
    out = dict(base)
    for k, v in overrides.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_update(out[k], v)
        else:
            out[k] = v
    return out


def load_config(config_path: str | None = None) -> dict[str, Any]:
    """Load a YAML config merged over the defaults. The result is a deep
    copy, so callers may mutate it without touching DEFAULT_CONFIG."""
    if config_path is None:
        return copy.deepcopy(DEFAULT_CONFIG)
    try:
        import yaml
    except ImportError as e:
        raise ImportError(f"reading {config_path} needs PyYAML, which is not installed") from e
    with open(config_path, "r") as f:
        user = yaml.safe_load(f) or {}
    return _deep_update(copy.deepcopy(DEFAULT_CONFIG), user)


def set_seed(seed: int = 42) -> torch.Generator:
    """Seed Python's and numpy's RNGs and return a torch.Generator seeded
    with `seed`, from which all torch randomness should be drawn."""
    random.seed(seed)
    np.random.seed(seed)
    return torch.Generator().manual_seed(seed)


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on. "cuda" (the default everywhere)
    requires a GPU and raises without one: nothing falls back to the CPU
    unless the caller asks for device="cpu"."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was asked for but no CUDA device is available; "
            "pass device='cpu' to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


def describe_devices() -> str:
    if torch.cuda.is_available():
        return f"{torch.cuda.device_count()}x cuda:{torch.cuda.get_device_name(0)}"
    return "1x cpu"
