"""Polyphase windowed-sinc resampling kernels (numpy).

Port of `_resample_kernel` (`audio_classification_icbhi_tpu/ops/resample.py:21-35`),
torchaudio's sinc_interp_hann kernel; `data/wavio.resample_np` applies it.
"""

from __future__ import annotations

import functools
import math

import numpy as np


@functools.lru_cache(maxsize=16)
def _resample_kernel(
    orig_freq: int, new_freq: int, lowpass_filter_width: int, rolloff: float
) -> tuple[np.ndarray, int]:
    """Polyphase kernels, shape (new_freq, 1, kernel_width); plus pad width."""
    base_freq = min(orig_freq, new_freq) * rolloff
    width = math.ceil(lowpass_filter_width * orig_freq / base_freq)
    idx = np.arange(-width, width + orig_freq, dtype=np.float64)[None, :] / orig_freq
    t = np.arange(0, -new_freq, -1, dtype=np.float64)[:, None] / new_freq + idx
    t = np.clip(t * base_freq, -lowpass_filter_width, lowpass_filter_width)
    window = np.cos(t * np.pi / lowpass_filter_width / 2.0) ** 2
    t = t * np.pi
    kernel = np.where(t == 0.0, 1.0, np.sin(t) / np.where(t == 0.0, 1.0, t))
    kernel = kernel * window * base_freq / orig_freq
    return kernel[:, None, :].astype(np.float32), width
