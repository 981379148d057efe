"""Waveform and SpecAugment augmentation on torch tensors.

Port of `audio_classification_icbhi_tpu/ops/augment.py:19-134`. jax.random
and torch draw different streams, so every augmentation is split in two:

- a **draw** takes a `torch.Generator` (on the device that uses it) and
  returns the random numbers as tensors, batched over examples;
- an **apply** takes those tensors and is deterministic.

The tests feed the JAX package's own draws (from its key splits) to the
applies and get the JAX outputs back. Semantics per example, as in the JAX
package: noise then a circular time shift, each gated at 0.5; SpecAugment's
width ~ U(0, param) and start ~ U(0, size − width) drawn as floats, with both
bounds truncated (mask [floor(start), floor(start + width))), frequency mask
before time mask. `freq_mask` and `time_mask` are the JAX package's
single masks (`augment.py:55-89` there: one mask over the whole tensor),
split the same way into `draw_mask` and `mask_along_axis`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class WaveDraws(NamedTuple):
    """Per-example draws of `augment_waveform`, for a (B, L) batch."""

    noise: torch.Tensor       # (B, L) standard normal
    noise_gate: torch.Tensor  # (B,) U(0, 1): noise applies where < noise_prob
    shift_frac: torch.Tensor  # (B,) U(−shift_max, shift_max)
    shift_gate: torch.Tensor  # (B,) U(0, 1): the shift applies where < shift_prob


class SpecDraws(NamedTuple):
    """Per-example float draws of `augment_spectrogram`, each (B,)."""

    f_width: torch.Tensor
    f_start: torch.Tensor
    t_width: torch.Tensor
    t_start: torch.Tensor


class MaskDraw(NamedTuple):
    """One SpecAugment mask's float draws, each 0-d."""

    width: torch.Tensor
    start: torch.Tensor


class AugmentDraws(NamedTuple):
    """Everything one train microbatch draws for augmentation."""

    wave: WaveDraws
    spec: SpecDraws


def _uniform(generator: torch.Generator, n: int, lo, hi, device) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(n, generator=generator, device=device)


def draw_waveform(generator: torch.Generator, batch: int, length: int, device,
                  shift_max: float = 0.2) -> WaveDraws:
    """The draws of `augment_waveform` for `batch` examples of `length`."""
    noise = torch.randn(batch, length, generator=generator, device=device)
    noise_gate = torch.rand(batch, generator=generator, device=device)
    shift_frac = _uniform(generator, batch, -shift_max, shift_max, device)
    shift_gate = torch.rand(batch, generator=generator, device=device)
    return WaveDraws(noise, noise_gate, shift_frac, shift_gate)


def draw_spectrogram(generator: torch.Generator, batch: int, n_mels: int, num_frames: int,
                     device, freq_mask_param: int = 15,
                     time_mask_param: int = 35) -> SpecDraws:
    """The draws of `augment_spectrogram` for `batch` examples of
    (n_mels, num_frames): width ~ U(0, param), start ~ U(0, size − width)."""
    f_width = _uniform(generator, batch, 0.0, float(freq_mask_param), device)
    f_start = (float(n_mels) - f_width) * torch.rand(batch, generator=generator, device=device)
    t_width = _uniform(generator, batch, 0.0, float(time_mask_param), device)
    t_start = (float(num_frames) - t_width) * torch.rand(batch, generator=generator, device=device)
    return SpecDraws(f_width, f_start, t_width, t_start)


def draw_mask(generator: torch.Generator, size: int, mask_param: int,
              device=None) -> MaskDraw:
    """The draws of one mask over an axis of `size` cells, in the JAX order:
    width ~ U(0, mask_param), then start ~ U(0, size − width)."""
    width = _uniform(generator, 1, 0.0, float(mask_param), device)[0]
    start = (float(size) - width) * torch.rand((), generator=generator, device=device)
    return MaskDraw(width, start)


def draw_augment(generator: torch.Generator, batch: int, length: int, n_mels: int,
                 num_frames: int, device) -> AugmentDraws:
    """One microbatch's draws: waveform first, then SpecAugment."""
    return AugmentDraws(draw_waveform(generator, batch, length, device),
                        draw_spectrogram(generator, batch, n_mels, num_frames, device))


def concat_draws(draws: list[AugmentDraws]) -> AugmentDraws:
    """Microbatch draws -> the draws of their concatenated batch."""
    wave = WaveDraws(*(torch.cat(f) for f in zip(*(d.wave for d in draws))))
    spec = SpecDraws(*(torch.cat(f) for f in zip(*(d.spec for d in draws))))
    return AugmentDraws(wave, spec)


# --- applies ----------------------------------------------------------------

def add_noise(waveform: torch.Tensor, noise: torch.Tensor,
              noise_factor: float = 0.005) -> torch.Tensor:
    """Additive gaussian noise: waveform + noise · noise_factor."""
    return waveform + noise * noise_factor


def time_shift(waveform: torch.Tensor, shift_frac: torch.Tensor) -> torch.Tensor:
    """Circular shift of each (B, L) row by int(frac · L) samples, truncated
    toward zero (torch.roll semantics, one shift per example)."""
    length = waveform.shape[-1]
    shift = (shift_frac * length).to(torch.int64)
    idx = (torch.arange(length, device=waveform.device) - shift[:, None]) % length
    return torch.gather(waveform, -1, idx)


def augment_waveform(waveform: torch.Tensor, draws: WaveDraws, *, noise_prob: float = 0.5,
                     shift_prob: float = 0.5, noise_factor: float = 0.005) -> torch.Tensor:
    """(B, L) -> (B, L): noise, then time shift, each where its gate passes."""
    noisy = add_noise(waveform, draws.noise, noise_factor)
    waveform = torch.where((draws.noise_gate < noise_prob)[:, None], noisy, waveform)
    shifted = time_shift(waveform, draws.shift_frac)
    return torch.where((draws.shift_gate < shift_prob)[:, None], shifted, waveform)


def augment_spectrogram(mel_spec: torch.Tensor, draws: SpecDraws) -> torch.Tensor:
    """(B, n_mels, T) -> SpecAugment's frequency and time masks: mels
    [floor(f_start), floor(f_start + f_width)) and frames [floor(t_start),
    floor(t_start + t_width)) zeroed, per example (torchaudio's truncation).
    The same mask the kernel's epilogue applies from `spec_mask_bounds`."""
    return mask_from_bounds(mel_spec, spec_mask_bounds(draws))


def spec_mask_bounds(draws: SpecDraws) -> torch.Tensor:
    """(B, 4) float32 (f_start, f_width, t_start, t_width), each band
    truncated as torchaudio truncates it: (floor(start), floor(start +
    width) − floor(start)), so that comparing cell indices against [start,
    start + width) masks the cells of [floor(start), floor(start + width))."""
    def one(start, width):
        s = torch.floor(start)
        return s, torch.floor(start + width) - s

    return torch.stack([*one(draws.f_start, draws.f_width),
                        *one(draws.t_start, draws.t_width)], dim=-1).float()


def mask_from_bounds(mel_spec: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
    """Zero the cells of (B, n_mels, T) that (B, 4) bounds mark: mel m with
    f_start ≤ m < f_start + f_width, or frame t with t_start ≤ t < t_start +
    t_width, compared in float32 as the TPU kernel's epilogue does
    (`pallas_mel.py:706-713`). The plain version of the kernel's mask."""
    b = bounds.to(device=mel_spec.device, dtype=torch.float32)
    m = torch.arange(mel_spec.shape[-2], dtype=torch.float32, device=mel_spec.device)
    t = torch.arange(mel_spec.shape[-1], dtype=torch.float32, device=mel_spec.device)
    f_in = (m >= b[:, 0:1]) & (m < b[:, 0:1] + b[:, 1:2])  # (B, n_mels)
    t_in = (t >= b[:, 2:3]) & (t < b[:, 2:3] + b[:, 3:4])  # (B, T)
    masked = f_in[:, :, None] | t_in[:, None, :]
    return torch.where(masked, torch.zeros((), dtype=mel_spec.dtype, device=mel_spec.device),
                       mel_spec)


def mask_along_axis(spec: torch.Tensor, draw: MaskDraw, axis: int) -> torch.Tensor:
    """spec (..., n_mels, T) with the cells [floor(start), floor(start +
    width)) of `axis` (-2, the mels, or -1, the frames) zeroed in every
    leading index: torchaudio's `mask_along_axis` truncation, through
    `mask_from_bounds`."""
    if axis not in (-2, -1):
        raise ValueError(f"axis must be -2 (mels) or -1 (frames), got {axis}")
    start = torch.floor(draw.start)
    band = [start, torch.floor(draw.start + draw.width) - start]
    zero = [torch.zeros_like(start)] * 2
    flat = spec.reshape((-1,) + tuple(spec.shape[-2:]))
    bounds = torch.stack(band + zero if axis == -2 else zero + band).expand(len(flat), 4)
    return mask_from_bounds(flat, bounds).reshape(spec.shape)


def freq_mask(generator: torch.Generator, mel_spec: torch.Tensor,
              mask_param: int = 15) -> torch.Tensor:
    """SpecAugment's frequency mask over the mel axis (-2), one for the whole
    tensor, drawn from `generator` (the reference's T.FrequencyMasking(15))."""
    draw = draw_mask(generator, mel_spec.shape[-2], mask_param, mel_spec.device)
    return mask_along_axis(mel_spec, draw, -2)


def time_mask(generator: torch.Generator, mel_spec: torch.Tensor,
              mask_param: int = 35) -> torch.Tensor:
    """SpecAugment's time mask over the frame axis (-1), one for the whole
    tensor, drawn from `generator` (the reference's T.TimeMasking(35))."""
    draw = draw_mask(generator, mel_spec.shape[-1], mask_param, mel_spec.device)
    return mask_along_axis(mel_spec, draw, -1)
