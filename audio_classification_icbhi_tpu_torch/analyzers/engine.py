"""Sliding-window analysis engine.

Port of `audio_classification_icbhi_tpu/analyzers/engine.py`. Windows are
cut on the host from the recording (a tail window zero-padded), bucketed to
a multiple of 32, and window -> log-mel -> classifier (LightweightCNN or
CompactResNet18) -> softmax runs as one device pass over the whole bucket,
followed by one copy to the host.

With `devices`, N devices of this process (the JAX engine's single-process
`mesh`, `:124-140`, `:238-256`), the bucket is a multiple of lcm(32, N),
split into N equal chunks, one a device, each through its own replica of
the model; the chunks' probabilities are concatenated in device order. As
in the JAX engine's mesh path, this path always runs the model's forward, never
the opt-in fused conv blocks.

Front end: `FlexibleMelFrontend`. For windows under 1 s it shortens the FFT
(n_fft = min(1024, sr·dur/2), hop = n_fft/4), which at 16 kHz sends every
window from 0.128 s up to 1 s to `radix8dif_fused`; 1 s windows at
config.yaml's 2048/512 run `radix16dif_fused`. The routing is
`MelFrontend`'s own.

Detection semantics (both reference variants):
- mode="threshold" (the batched analyzers' default): conf_x = min(p_x +
  p_both, 1.0); has_x = conf_x > threshold (default 0.3);
- mode="legacy" (realtime_analyzer.py): has_x = p_x > 0.5 or p_both > 0.5;
  the confidence p_x + p_both is reported unclamped (it can exceed 1.0, a
  reference quirk kept for parity).
"""

from __future__ import annotations

import copy
import csv
import functools
import math
from dataclasses import dataclass
from pathlib import Path
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from audio_classification_icbhi_tpu_torch.data import wavio
from audio_classification_icbhi_tpu_torch.inference import ClassifierEngine
from audio_classification_icbhi_tpu_torch.models import (
    LightweightCNN,
    fused_cnn_enabled,
    make_fused_apply,
)
from audio_classification_icbhi_tpu_torch.ops import mel as mel_ops

CLASS_MAP = {0: "normal", 1: "crackle", 2: "wheeze", 3: "both"}


@dataclass
class SegmentResult:
    """Per-window result (the reference's schema, realtime_analyzer.py:31-42)."""

    start_time: float
    end_time: float
    has_crackle: bool
    has_wheeze: bool
    crackle_confidence: float
    wheeze_confidence: float
    normal_confidence: float
    both_confidence: float
    predicted_class: str


class FlexibleMelFrontend:
    """Window-duration-adaptive log-mel (`analyzers/engine.py:53-108` of the
    JAX package): for windows under 1 s, n_fft = min(1024, sr·dur/2) and
    hop = n_fft/4; the spectrogram is resized along time to a fixed
    max(ceil(L / hop), 32) frames, so one model serves every window size.

    The mel chain is a `MelFrontend` at the resolved shape, with its
    routing. Without a resize its normalize runs in the kernel's epilogue;
    with one, the kernel runs with normalize off (top_db only), then the
    resize, then normalize. The resize is bilinear with half-pixel centres
    and, when it shrinks, antialiased, as `jax.image.resize(method=
    "bilinear")` is: without the antialias a 33 -> 32 shrink (0.512 s
    windows) misses the JAX package by far more than the 2e-3 the tests
    hold it to (ROADMAP.md C).
    """

    def __init__(self, sample_rate: int, n_mels: int, n_fft: int, hop_length: int,
                 duration: float, f_min: float = 0.0, f_max: float | None = None,
                 top_db: float | None = None):
        self.sample_rate = sample_rate
        self.n_mels = n_mels
        self.duration = duration
        self.target_length = int(sample_rate * duration)
        if duration < 1.0:
            n_fft = min(1024, int(sample_rate * duration / 2))
            hop_length = n_fft // 4
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.target_time_steps = max(int(math.ceil(self.target_length / hop_length)), 32)
        # f_min/f_max/top_db come from the checkpoint's config, so the
        # analyzer computes the features the model trained on
        self._inner = mel_ops.MelFrontend(
            sample_rate=sample_rate, n_mels=n_mels, n_fft=self.n_fft,
            hop_length=self.hop_length, duration=duration,
            f_min=f_min, f_max=f_max, top_db=top_db, normalize=True,
        )

    @property
    def needs_resize(self) -> bool:
        return self._inner.num_frames != self.target_time_steps

    def __call__(self, wavs: torch.Tensor) -> torch.Tensor:
        """(B, L) -> (B, n_mels, target_time_steps), normalized."""
        if not self.needs_resize:
            return self._inner(wavs)
        mel = self._inner.log_mel(wavs)
        lead = mel.shape[:-2]
        mel = F.interpolate(mel.reshape((-1, 1) + mel.shape[-2:]),
                            size=(self.n_mels, self.target_time_steps), mode="bilinear",
                            align_corners=False, antialias=True)
        return mel_ops.normalize_spectrogram(mel.reshape(lead + mel.shape[-2:]))


class AnalyzerEngine:
    """Shared core of the analyzer family. Runs on `device` ("cuda" by
    default; device="cpu" only when asked)."""

    def __init__(
        self,
        model_path: str,
        segment_duration: float = 1.0,
        overlap: float = 0.5,
        sample_rate: int | None = None,
        crackle_threshold: float = 0.3,
        wheeze_threshold: float = 0.3,
        mode: str = "threshold",
        max_duration: float | None = 15.0,
        devices: Sequence[str | torch.device] | None = None,
        device: str | torch.device = "cuda",
    ):
        """`devices` splits each bucket of windows over them (the JAX
        engine's `mesh`); with them, `device` is not read."""
        if mode not in ("threshold", "legacy"):
            raise ValueError(f"unknown analyzer mode {mode!r} "
                             "(expected 'threshold' or 'legacy')")
        if not 0.0 <= overlap < 1.0:
            # overlap=1.0 clamps the hop to one sample: a 15 s recording
            # becomes ~224k windows
            raise ValueError(f"overlap must be in [0, 1), got {overlap}")
        self.devices = None if devices is None else [torch.device(d) for d in devices]
        self.classifier = ClassifierEngine(
            model_path, device=self.devices[0] if self.devices is not None else device)
        self.device = self.classifier.device
        dcfg = self.classifier.config["data"]
        # None = the checkpoint's training sample rate; the analyzer entry
        # points pass 16000, as the reference's librosa.load(sr=16000) does
        self.sample_rate = sample_rate or dcfg["sample_rate"]
        self.segment_duration = segment_duration
        self.overlap = overlap
        self.crackle_threshold = crackle_threshold
        self.wheeze_threshold = wheeze_threshold
        self.mode = mode
        self.max_duration = max_duration
        self.class_map = CLASS_MAP
        self.frontend = FlexibleMelFrontend(
            sample_rate=self.sample_rate,
            n_mels=dcfg["n_mels"],
            n_fft=dcfg["n_fft"],
            hop_length=dcfg["hop_length"],
            duration=segment_duration,
            f_min=dcfg.get("f_min", 0.0),
            f_max=dcfg.get("f_max"),
            top_db=dcfg.get("top_db"),
        )

    # ---------------------------------------------------------------- audio

    def load_audio(self, audio_path: str | Path) -> np.ndarray:
        """Decode, resample and crop to max_duration (the reference loads at
        most 15 s)."""
        print(f"\nLoading audio: {audio_path}")
        audio, sr = wavio.load_audio(audio_path, target_sr=self.sample_rate)
        if self.max_duration is not None:
            audio = audio[: int(self.max_duration * self.sample_rate)]
        print(f"✓ Audio loaded: {len(audio) / self.sample_rate:.2f}s, {sr}Hz")
        return audio

    def segment_audio(self, audio: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """-> (windows (W, seg_samples), starts (W,), ends (W,)).

        hop = seg·(1 − overlap); full windows while they fit, then one
        zero-padded tail window if audio remains. A recording shorter than
        one window is a single tail window; an empty one gives no window."""
        seg = int(self.segment_duration * self.sample_rate)
        hop = max(int(seg * (1 - self.overlap)), 1)
        n = len(audio)
        duration = n / self.sample_rate
        starts_idx = list(range(0, n - seg + 1, hop))
        next_start = starts_idx[-1] + hop if starts_idx else 0
        tail = next_start if next_start < n else None
        windows, starts, ends = [], [], []
        for s in starts_idx:
            windows.append(audio[s : s + seg])
            starts.append(s / self.sample_rate)
            ends.append((s + seg) / self.sample_rate)
        if tail is not None:
            w = audio[tail:]
            windows.append(np.pad(w, (0, seg - len(w))))
            starts.append(tail / self.sample_rate)
            ends.append(duration)
        print(
            f"✓ Created {len(windows)} segments ({self.segment_duration}s each, "
            f"{self.overlap * 100:.0f}% overlap)"
        )
        if not windows:
            return (np.zeros((0, seg), np.float32), np.zeros(0), np.zeros(0))
        return np.stack(windows).astype(np.float32), np.array(starts), np.array(ends)

    # ---------------------------------------------------------------- device pass

    @functools.cached_property
    def _apply_fn(self):
        """feats -> logits (`analyzers/engine.py:216-237` of the JAX
        package): for a LightweightCNN on one device, the fused conv-block
        kernels when `fused_cnn_enabled` says so for this device and the
        analyzer's feature height (the kernels take any width >= 4); else,
        and for a CompactResNet18 always, the model's forward."""
        model = self.classifier.model
        if (self.devices is None and isinstance(model, LightweightCNN)
                and fused_cnn_enabled((1, self.frontend.n_mels, 4, 1), self.device)):
            return make_fused_apply(model, self.device)
        return model

    @functools.cached_property
    def _replicas(self) -> list[tuple[torch.device, torch.nn.Module]]:
        """(device, model) for each of `devices`: the classifier's own
        model on the first, copies on the others."""
        model = self.classifier.model
        return [(d, model if i == 0 else copy.deepcopy(model).to(d))
                for i, d in enumerate(self.devices)]

    def _window_bucket(self, w: int) -> int:
        quantum = 32 if self.devices is None else math.lcm(32, len(self.devices))
        return max(quantum, int(math.ceil(w / quantum)) * quantum)

    @torch.inference_mode()
    def predict_window_probs(self, windows: np.ndarray) -> np.ndarray:
        """(W, seg) windows -> (W, 4) probabilities: the windows padded to
        their bucket (a multiple of 32, and of the number of `devices`, so
        recordings of many lengths share a few shapes), one device pass (a
        chunk on each of `devices`, all launched before any result is
        read), one copy to the host."""
        w = windows.shape[0]
        bucket = self._window_bucket(w)
        if w < bucket:
            windows = np.concatenate(
                [windows, np.zeros((bucket - w,) + windows.shape[1:], windows.dtype)])
        x = torch.as_tensor(windows, dtype=torch.float32)
        if self.devices is None:
            logits = self._apply_fn(self.frontend(x.to(self.device))[..., None])
            return torch.softmax(logits.float(), dim=-1).cpu().numpy()[:w]
        chunks = x.chunk(len(self._replicas))
        probs = [torch.softmax(model(self.frontend(c.to(d))[..., None]).float(), dim=-1)
                 for (d, model), c in zip(self._replicas, chunks)]
        return torch.cat([p.cpu() for p in probs]).numpy()[:w]

    # ---------------------------------------------------------------- results

    def _make_result(self, probs: np.ndarray, start: float, end: float) -> SegmentResult:
        normal_conf, crackle_conf, wheeze_conf, both_conf = (float(p) for p in probs[:4])
        if self.mode == "legacy":
            has_crackle = crackle_conf > 0.5 or both_conf > 0.5
            has_wheeze = wheeze_conf > 0.5 or both_conf > 0.5
            total_crackle = crackle_conf + both_conf  # unclamped (quirk kept)
            total_wheeze = wheeze_conf + both_conf
        else:
            total_crackle = min(crackle_conf + both_conf, 1.0)
            total_wheeze = min(wheeze_conf + both_conf, 1.0)
            has_crackle = total_crackle > self.crackle_threshold
            has_wheeze = total_wheeze > self.wheeze_threshold
        return SegmentResult(
            start_time=start,
            end_time=end,
            has_crackle=has_crackle,
            has_wheeze=has_wheeze,
            crackle_confidence=total_crackle,
            wheeze_confidence=total_wheeze,
            normal_confidence=normal_conf,
            both_confidence=both_conf,
            predicted_class=self.class_map[int(np.argmax(probs))],
        )

    def analyze_audio(self, audio_path: str | Path) -> tuple[list[SegmentResult], np.ndarray]:
        """-> (results, audio)."""
        audio = self.load_audio(audio_path)
        windows, starts, ends = self.segment_audio(audio)
        probs = self.predict_window_probs(windows)
        results = [self._make_result(p, s, e) for p, s, e in zip(probs, starts, ends)]
        return results, audio

    # ---------------------------------------------------------------- reporting

    def print_summary(self, results: list[SegmentResult]) -> None:
        total = max(len(results), 1)
        crackle = sum(1 for r in results if r.has_crackle)
        wheeze = sum(1 for r in results if r.has_wheeze)
        both = sum(1 for r in results if r.has_crackle and r.has_wheeze)
        normal = sum(1 for r in results if not r.has_crackle and not r.has_wheeze)
        print("\n" + "=" * 70)
        print("ANALYSIS SUMMARY")
        print("=" * 70)
        print(f"Total segments analyzed: {len(results)}")
        print(f"Normal segments: {normal} ({100 * normal / total:.1f}%)")
        print(f"Crackle detections: {crackle} ({100 * crackle / total:.1f}%)")
        print(f"Wheeze detections: {wheeze} ({100 * wheeze / total:.1f}%)")
        print(f"Both detected: {both} ({100 * both / total:.1f}%)")
        for label, flag in (("Crackle", "has_crackle"), ("Wheeze", "has_wheeze")):
            times = [(r.start_time, r.end_time) for r in results if getattr(r, flag)]
            if times:
                print(f"\n{label} time ranges:")
                for s, e in times[:5]:
                    print(f"  {s:.2f}s - {e:.2f}s")
                if len(times) > 5:
                    print(f"  ... and {len(times) - 5} more")
        print("=" * 70)

    def export_results(self, results: list[SegmentResult], output_path: str | Path) -> None:
        """The reference's results CSV (realtime_analyzer.py:427-464)."""
        with open(output_path, "w", newline="") as f:
            writer = csv.writer(f)
            writer.writerow(["Start (s)", "End (s)", "Crackle", "Wheeze",
                             "Crackle Conf", "Wheeze Conf", "Class"])
            for r in results:
                writer.writerow([f"{r.start_time:.3f}", f"{r.end_time:.3f}",
                                 r.has_crackle, r.has_wheeze,
                                 f"{r.crackle_confidence:.4f}", f"{r.wheeze_confidence:.4f}",
                                 r.predicted_class])
        print(f"✓ Results exported to: {output_path}")

    def export_results_timeline(self, results: list[SegmentResult],
                                output_path: str | Path) -> None:
        """The timeline CSV with its Detection Type column
        (realtime_analyzer_timeline.py:449-484)."""
        with open(output_path, "w", newline="") as f:
            writer = csv.writer(f)
            writer.writerow(["Start (s)", "End (s)", "Detection Type", "Has Crackle",
                             "Has Wheeze", "Crackle Confidence", "Wheeze Confidence",
                             "Predicted Class"])
            for r in results:
                if r.has_crackle and r.has_wheeze:
                    det = "Both"
                elif r.has_crackle:
                    det = "Crackle"
                elif r.has_wheeze:
                    det = "Wheeze"
                else:
                    det = "Normal"
                writer.writerow([f"{r.start_time:.3f}", f"{r.end_time:.3f}", det,
                                 r.has_crackle, r.has_wheeze,
                                 f"{r.crackle_confidence:.4f}", f"{r.wheeze_confidence:.4f}",
                                 r.predicted_class])
        print(f"✓ Results exported to: {output_path}")
