"""Polyphase windowed-sinc resampling.

Port of `audio_classification_icbhi_tpu/ops/resample.py:21-71`:
`_resample_kernel`, torchaudio's sinc_interp_hann kernel bank
(`data/wavio.resample_np` applies it on the host), and `resample`, the same
bank applied on the device as one strided `F.conv1d`, as the JAX package
applies it as an XLA conv. That conv runs at `Precision.HIGHEST`, so this
one holds full f32 whatever the caller's TF32 switches say (`_full_f32`).
"""

from __future__ import annotations

import contextlib
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F


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


@contextlib.contextmanager
def _full_f32():
    """TF32 off for cuDNN convolutions and cuBLAS matmuls inside the block
    (torch turns it on for cuDNN by default), the caller's switches back
    after it."""
    cudnn, matmul = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn
        torch.backends.cuda.matmul.allow_tf32 = matmul


def resample(
    waveform: torch.Tensor,
    orig_freq: int,
    new_freq: int,
    *,
    lowpass_filter_width: int = 6,
    rolloff: float = 0.99,
) -> torch.Tensor:
    """Resample a (..., L) waveform from orig_freq to new_freq on its device,
    in its dtype.

    torchaudio's sinc_interp_hann defaults (lowpass_filter_width 6, rolloff
    0.99). The output length is ceil(new·L / orig) after gcd reduction, as
    torchaudio's.
    """
    if orig_freq == new_freq:
        return waveform
    g = math.gcd(int(orig_freq), int(new_freq))
    orig_g, new_g = orig_freq // g, new_freq // g
    kernel_np, width = _resample_kernel(orig_g, new_g, lowpass_filter_width, rolloff)
    kernel = torch.as_tensor(kernel_np, device=waveform.device).to(waveform.dtype)

    lead_shape = waveform.shape[:-1]
    length = waveform.shape[-1]
    x = F.pad(waveform.reshape(-1, 1, length), (width, width + orig_g))
    with _full_f32():
        y = F.conv1d(x, kernel, stride=orig_g)  # (N, new_g, ceil(L / orig_g) + 1)
    y = y.transpose(1, 2).reshape(x.shape[0], -1)
    target_length = math.ceil(new_g * length / orig_g)
    return y[:, :target_length].reshape(lead_shape + (target_length,))
