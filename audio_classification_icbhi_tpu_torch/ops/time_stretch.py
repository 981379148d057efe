"""Phase-vocoder time stretch (torchaudio T.TimeStretch's function).

Port of `audio_classification_icbhi_tpu/ops/time_stretch.py:29-92`:
`stft_complex` gives the complex spectrogram, `phase_vocoder` resamples its
frame axis at `rate` with linear magnitude interpolation and rebuilds the
phases by accumulating the wrapped instantaneous-frequency deviation around
each bin's expected advance (hop · 2π k / n_fft). The frame-index table is
built on the host; on the device the op is a gather, elementwise
trigonometry and a cumulative sum, all plain torch (the JAX package leaves
it to XLA).

One difference: the increments are computed in the spectrogram's dtype, as
the JAX package computes them, but their running sum and the final polar
form are taken in float64. At 2048/512 the top bin advances 804 rad a
frame, so 15 s of frames accumulate ~5·10⁵ rad, where one f32 ulp is
0.03 rad and a cumulative sum's rounding grows with its depth; in float64
the output phase keeps the increments' own error, which `phase_bound`
bounds.
"""

from __future__ import annotations

import numpy as np
import torch

from audio_classification_icbhi_tpu_torch.ops import stft as stft_ops


def stft_complex(x: torch.Tensor, n_fft: int, hop_length: int, *,
                 center: bool = True) -> torch.Tensor:
    """Windowed complex STFT (..., n_fft//2+1, T), torch.stft semantics
    (periodic Hann window, reflect padding when centred)."""
    window = stft_ops.hann_window(n_fft, dtype=x.dtype, device=x.device)
    frames = stft_ops.frame_signal(x, n_fft, hop_length, center=center) * window
    return torch.fft.rfft(frames, n=n_fft, dim=-1).transpose(-1, -2)


def phase_vocoder(spec: torch.Tensor, rate: float, hop_length: int,
                  n_fft: int | None = None) -> torch.Tensor:
    """Stretch a complex spectrogram (..., F, T) by `rate` (> 1 faster and
    shorter). Returns (..., F, ceil(T / rate)) complex; rate 1 returns
    `spec` itself."""
    if rate == 1.0:
        return spec
    f, t = spec.shape[-2], spec.shape[-1]
    if n_fft is None:
        n_fft = 2 * (f - 1)
    real = spec.real.dtype
    # expected phase advance a frame for each bin: hop · 2π k / n_fft
    phase_advance = torch.as_tensor(
        (hop_length * 2.0 * np.pi * np.arange(f) / n_fft)[:, None], dtype=real,
        device=spec.device)
    time_steps = np.arange(0, t, float(rate))
    idx = torch.as_tensor(time_steps.astype(np.int64), device=spec.device)
    alphas = torch.as_tensor((time_steps % 1.0)[None, :], dtype=real, device=spec.device)

    # two zero frames on the end, so idx + 1 is always in range
    padded = torch.cat([spec, spec.new_zeros(spec.shape[:-1] + (2,))], dim=-1)
    s0 = padded[..., idx]
    s1 = padded[..., idx + 1]

    angle0 = torch.angle(s0)
    angle1 = torch.angle(s1)
    mag = alphas * torch.abs(s1) + (1.0 - alphas) * torch.abs(s0)

    # the wrapped deviation from the expected advance, then the advance again
    dphase = angle1 - angle0 - phase_advance
    dphase = dphase - 2.0 * np.pi * torch.round(dphase / (2.0 * np.pi))
    dphase = dphase + phase_advance
    # the first output frame keeps angle0; later frames add the increments
    phase = torch.cat([angle0[..., :1], dphase[..., :-1]], dim=-1)
    phase_acc = torch.cumsum(phase.double(), dim=-1)
    return torch.polar(mag.double(), phase_acc).to(spec.dtype)


def phase_bound(n_bins: int, n_out: int, hop_length: int, n_fft: int,
                dtype=torch.float32) -> np.ndarray:
    """(n_bins, n_out) a-priori bound, in radians, on the error of
    `phase_vocoder`'s output phase against exact arithmetic, for a
    spectrogram in `dtype` (unit roundoff u).

    Output frame j sums j + 1 increments. The first is angle0, within 3
    ulp of π (12u; CUDA's atan2f is held to 3 ulp). Each later one is
    ((a1 − a0 − adv) − 2π·r) + adv with adv the bin's advance
    hop·2πk/n_fft: the two angles carry ≤ 12u each; the subtraction a1 − a0
    ≤ u·2π; subtracting adv ≤ u(adv + 2π) (adv's own rounding cancels when
    it is added back); the product 2π·r, with |r| ≤ (adv + 2π)/2π + 1, and
    2π's rounding ≤ 2u(adv + 3π); the subtraction ≤ u·π; adding adv back
    ≤ u(adv + π). Together ≤ u(4·adv + 24 + 12π) an increment. A wrong
    round of r moves an increment by 2π, which the output cannot show. The
    float64 sum and polar form add ~2^-53 of the phase, and the cast to
    `dtype` one u, both negligible here. So the bound of frame j is
    u·(12 + j·(4·adv_k + 24 + 12π)). Most of it is systematic (2π·r and
    its rounding repeat every frame), so the error grows as j, not √j."""
    u = float(torch.finfo(dtype).eps) / 2
    adv = hop_length * 2.0 * np.pi * np.arange(n_bins) / n_fft
    j = np.arange(n_out)
    return u * (12.0 + j[None, :] * (4.0 * adv[:, None] + 24.0 + 12.0 * np.pi))


class TimeStretch:
    """torchaudio T.TimeStretch's interface: call with a complex
    spectrogram and an optional rate that overrides `fixed_rate`."""

    def __init__(self, hop_length: int = 512, n_freq: int = 1025,
                 fixed_rate: float | None = None):
        self.hop_length = hop_length
        self.n_fft = 2 * (n_freq - 1)
        self.fixed_rate = fixed_rate

    def __call__(self, spec: torch.Tensor, rate: float | None = None) -> torch.Tensor:
        r = rate if rate is not None else self.fixed_rate
        if r is None:
            raise ValueError("no stretch rate given (fixed_rate is None)")
        return phase_vocoder(spec, r, self.hop_length, self.n_fft)
