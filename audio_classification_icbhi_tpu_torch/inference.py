"""Checkpoint-driven inference engine.

Port of `audio_classification_icbhi_tpu/inference.py:30-220`. The model is
rebuilt from the config embedded in the checkpoint, so consumers never need
the original YAML. One wav -> probabilities path serves single clips and
batches: the log-mel front end (the Hopper kernel on the card), then the
checkpoint's classifier (LightweightCNN, CompactResNet18 or a registered
architecture, built by `build_model`) in eval mode and a softmax. With
`ICBHI_FUSED_CNN=1` on the card a LightweightCNN runs through the fused
conv-block kernels (`models/fused_infer.py`), as the JAX engine takes its
fused Pallas CNN; any other model runs its own forward there, as in the
JAX engine.
"""

from __future__ import annotations

import functools
from pathlib import Path
from typing import Any

import numpy as np
import torch

from audio_classification_icbhi_tpu_torch.data import wavio
from audio_classification_icbhi_tpu_torch.models import (
    LightweightCNN,
    build_model,
    count_parameters,
    fused_cnn_enabled,
    make_fused_apply,
)
from audio_classification_icbhi_tpu_torch.models.weights import state_dict_from_flax
from audio_classification_icbhi_tpu_torch.ops.mel import MelFrontend
from audio_classification_icbhi_tpu_torch.parallel.data_parallel import features_from_wavs
from audio_classification_icbhi_tpu_torch.utils.checkpoint import load_checkpoint
from audio_classification_icbhi_tpu_torch.utils.config import resolve_device


class ClassifierEngine:
    """wav -> class probabilities from a self-describing checkpoint.

    Runs on `device` ("cuda" by default; it raises where no GPU exists, and
    runs on the CPU only when given device="cpu")."""

    def __init__(self, checkpoint_path: str | Path, batch_size: int = 32,
                 config: dict | None = None, device: str | torch.device = "cuda"):
        """config: fallback when the checkpoint has no embedded config; the
        embedded config wins when present."""
        ckpt = load_checkpoint(checkpoint_path)
        if "config" not in ckpt and config is None:
            raise ValueError(f"checkpoint {checkpoint_path} has no embedded config")
        self.config: dict[str, Any] = ckpt.get("config") or config
        self.class_names: list[str] = list(self.config["classes"])
        self.batch_size = batch_size
        self.frontend = MelFrontend.from_config(self.config)
        self.device = resolve_device(device)
        self.model = build_model(self.config)
        self.model.load_state_dict(state_dict_from_flax(
            {"params": ckpt["params"], "batch_stats": ckpt.get("batch_stats", {})},
            self.config["model"]["architecture"]))
        self.model.to(self.device).eval()
        self.epoch = int(ckpt.get("epoch", -1))
        self.val_loss = float(ckpt.get("val_loss", float("nan")))
        self.extras = {k: ckpt[k] for k in ("icbhi_score", "icbhi_metrics") if k in ckpt}

    @functools.cached_property
    def _apply_fn(self):
        """feats -> logits for the eval path (`inference.py:67-86` of the JAX
        package): the model's forward, or the fused conv-block kernels when
        `fused_cnn_enabled` says so for this device and feature shape."""
        shape = (1, self.frontend.n_mels, self.frontend.num_frames, 1)
        if isinstance(self.model, LightweightCNN) and fused_cnn_enabled(shape, self.device):
            return make_fused_apply(self.model, self.device)
        return self.model

    @torch.inference_mode()
    def _probs(self, wavs: torch.Tensor) -> torch.Tensor:
        """(B, target_length) f32 on self.device -> (B, C) f32 probabilities."""
        logits = self._apply_fn(features_from_wavs(self.frontend, wavs))
        return torch.softmax(logits.float(), dim=-1)

    def _to_device(self, wav) -> torch.Tensor:
        return torch.as_tensor(wav, dtype=torch.float32).to(self.device, non_blocking=True)

    def warmup_latency(self) -> None:
        """Warm the batch-1 path (kernel build, cuDNN algorithm choice) for
        both input placements a server can present: a host array and a
        device tensor."""
        zero = np.zeros((self.frontend.target_length,), np.float32)
        self.classify_wave(zero)
        self.classify_wave(self._to_device(zero))

    def classify_wave(self, wav) -> dict:
        """Low-latency single clip: `wav` is a (target_length,) float32
        waveform at the config sample rate, as numpy or a tensor. The argmax
        is taken on the device and packed beside the probabilities, so one
        device->host copy returns both."""
        with torch.inference_mode():
            probs = self._probs(self._to_device(wav)[None])[0]
            packed = torch.cat([probs, torch.argmax(probs).to(probs.dtype)[None]]).cpu().numpy()
        return self._result(packed[:-1], int(packed[-1]))

    def _result(self, probs: np.ndarray, pred: int) -> dict:
        return {
            "predicted_class": self.class_names[pred],
            "confidence": float(probs[pred]),
            "probabilities": {
                self.class_names[i]: float(probs[i]) for i in range(len(self.class_names))
            },
        }

    def predict_probs(self, wavs: np.ndarray) -> np.ndarray:
        """(B, target_length) waveforms -> (B, C) probabilities, in chunks
        padded to self.batch_size so every launch has one shape."""
        b = wavs.shape[0]
        out = []
        for i in range(0, b, self.batch_size):
            chunk = np.asarray(wavs[i : i + self.batch_size], np.float32)
            n = chunk.shape[0]
            if n < self.batch_size:
                chunk = np.concatenate(
                    [chunk, np.zeros((self.batch_size - n,) + chunk.shape[1:], chunk.dtype)])
            out.append(self._probs(self._to_device(chunk)).cpu().numpy()[:n])
        return np.concatenate(out)

    def _load_clip(self, audio_path: str | Path) -> np.ndarray:
        wav, _ = wavio.load_audio(audio_path, target_sr=self.frontend.sample_rate)
        return wavio.pad_or_crop(wav, self.frontend.target_length).astype(np.float32)

    def classify_file(self, audio_path: str | Path) -> dict:
        """Single-file result dict, through the batch-1 path."""
        wav = self._load_clip(audio_path)
        return {"audio_path": str(audio_path), **self.classify_wave(wav)}

    def classify_files(self, audio_paths: list) -> list[dict]:
        """Batched multi-file classification; a file that fails to load, for
        whatever reason (the JAX engine catches every `Exception` here too:
        a WAV declaring sample rate 0 fails in the resampler with
        ZeroDivisionError), is reported and skipped."""
        wavs, ok_paths, results = [], [], []
        for p in audio_paths:
            try:
                wavs.append(self._load_clip(p))
                ok_paths.append(p)
            except Exception as e:
                print(f"Error processing {p}: {e}")
        if not wavs:
            return results
        probs = self.predict_probs(np.stack(wavs))
        for path, pr in zip(ok_paths, probs):
            results.append({"audio_path": str(path), **self._result(pr, int(np.argmax(pr)))})
        return results

    def describe(self) -> dict:
        """Model info for `cli info`."""
        return {
            "architecture": self.config["model"]["architecture"],
            "num_classes": self.config["model"]["num_classes"],
            "parameters": count_parameters(self.model),
            "epoch": self.epoch,
            "val_loss": self.val_loss,
            "classes": self.class_names,
            "sample_rate": self.config["data"]["sample_rate"],
            "n_mels": self.config["data"]["n_mels"],
            "duration": self.config["data"]["duration"],
            **self.extras,
        }
