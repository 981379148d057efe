"""STFT building blocks on torch tensors.

Port of `audio_classification_icbhi_tpu/ops/stft.py:27-200`. Semantics match
torch.stft under torchaudio MelSpectrogram defaults: center=True with
reflect padding, periodic Hann window, onesided bins n_fft//2+1, frame
count 1 + len//hop.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def hann_window(n_fft: int, *, periodic: bool = True, dtype=torch.float32,
                device=None) -> torch.Tensor:
    """Hann window, computed in float64 and cast. `periodic=True` matches
    torch.hann_window's default."""
    n = np.arange(n_fft)
    denom = n_fft if periodic else n_fft - 1
    w = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / denom))
    return torch.as_tensor(w, dtype=dtype, device=device)


def num_frames(length: int, n_fft: int, hop_length: int, *, center: bool = True) -> int:
    """Number of STFT frames for a signal of `length` samples."""
    if center:
        return 1 + length // hop_length
    return 1 + (length - n_fft) // hop_length


def reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflect-pad the last axis by `pad` on both sides.

    Same result as numpy's / jnp.pad's "reflect" mode, including pads longer
    than the signal (the reflection repeats with period 2·(L−1)), which
    torch's own reflect padding refuses.
    """
    length = x.shape[-1]
    if length == 1:
        idx = torch.zeros(length + 2 * pad, dtype=torch.long, device=x.device)
    else:
        period = 2 * (length - 1)
        idx = torch.arange(-pad, length + pad, device=x.device) % period
        idx = torch.where(idx >= length, period - idx, idx)
    return x[..., idx]


def frame_signal(x: torch.Tensor, n_fft: int, hop_length: int, *,
                 center: bool = True) -> torch.Tensor:
    """Slice a (..., length) signal into overlapping frames (..., T, n_fft),
    T = `num_frames`. The result is a strided view of the (padded) signal.

    At odd n_fft the center padding (n_fft // 2 a side) can leave the last
    frame one sample short. The JAX package gathers that frame with its
    index clamped to the padded signal's last sample, so the padded signal
    is extended by its own last sample here, as often as the frame needs."""
    t = num_frames(x.shape[-1], n_fft, hop_length, center=center)
    if center:
        x = reflect_pad(x, n_fft // 2)
        short = (t - 1) * hop_length + n_fft - x.shape[-1]
        if short > 0:
            x = torch.cat([x, x[..., -1:].expand(*x.shape[:-1], short)], dim=-1)
    return x.unfold(-1, n_fft, hop_length)


@functools.lru_cache(maxsize=8)
def _dft_matrices_np(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    n_bins = n_fft // 2 + 1
    ang = 2.0 * np.pi * np.outer(np.arange(n_fft), np.arange(n_bins)) / n_fft
    return np.cos(ang), np.sin(ang)


def dft_matrices(n_fft: int, *, dtype=torch.float32, device=None):
    """Real-DFT cosine/sine matrices (n_fft, n_fft//2+1), computed in float64
    and cast. frames @ C = Re(rfft); the power spectrum is
    (frames@C)² + (frames@S)², so the sign of S does not matter."""
    c, s = _dft_matrices_np(n_fft)
    return (torch.as_tensor(c, dtype=dtype, device=device),
            torch.as_tensor(s, dtype=dtype, device=device))


@functools.lru_cache(maxsize=16)
def _window_and_dft(n_fft: int, dtype: torch.dtype, device: torch.device):
    """The periodic Hann window and the DFT matrices on `device`, made once:
    a copy from the host inside the chain would break a CUDA graph's
    capture of it (a train step that runs the plain chain)."""
    return (hann_window(n_fft, dtype=dtype, device=device),
            *dft_matrices(n_fft, dtype=dtype, device=device))


def stft_power(x: torch.Tensor, n_fft: int, hop_length: int, *,
               center: bool = True) -> torch.Tensor:
    """Power spectrogram |STFT|² with shape (..., T, n_fft//2+1), by a
    windowed matmul DFT in the input's dtype (the plain version the kernels
    are held against; time-major, unlike the JAX package's (..., bins, T))."""
    frames = frame_signal(x, n_fft, hop_length, center=center)
    window, c, s = _window_and_dft(n_fft, x.dtype, x.device)
    frames = frames * window
    re = frames @ c
    im = frames @ s
    return re * re + im * im


def spectrogram(x: torch.Tensor, n_fft: int, hop_length: int, power: float = 2.0,
                **kw) -> torch.Tensor:
    """Magnitude (power=1) or power (power=2) spectrogram, (..., n_fft//2+1,
    T) as torchaudio and the JAX package's `ops/stft.spectrogram` lay it out:
    power 2 is `stft_power` (transposed), any other power
    sqrt(max(|STFT|², 0)) ** power. `kw` goes to `stft_power`."""
    p = stft_power(x, n_fft, hop_length, **kw).transpose(-1, -2)
    if power == 2.0:
        return p
    return torch.sqrt(torch.clamp(p, min=0.0)) ** power
