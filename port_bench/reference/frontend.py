"""The front end in plain float32 PyTorch: waveform augmentation, log-mel,
SpecAugment mask, per-example normalize.

The function is the repository's `config.yaml` front end: reflect pad by
n_fft // 2, frames at hop, periodic Hann, |rfft|², HTK mel filterbank from 0
to sr / 2 without norm, 10·log10(max(·, 1e-10)), then the mask, then
(x − mean) / (std + 1e-8) with the unbiased std over (n_mels, T).

The draws copy the port's draw order (`ops/augment.py`), so that given the
step's generator the reference draws the numbers the program draws:
per microbatch the waveform's noise, noise gate, shift fraction and shift
gate, then SpecAugment's frequency width and start and time width and
start. The applies are written from their definitions: noise · 0.005 where
its gate < 0.5, a circular shift by int(frac · L) where its gate < 0.5,
mels [floor(f0), floor(f0 + fw)) and frames [floor(t0), floor(t0 + tw))
zeroed.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from port_bench.counts import htk_filterbank


class Draws(NamedTuple):
    noise: torch.Tensor
    noise_gate: torch.Tensor
    shift_frac: torch.Tensor
    shift_gate: torch.Tensor
    f_width: torch.Tensor
    f_start: torch.Tensor
    t_width: torch.Tensor
    t_start: torch.Tensor


def step_seed(seed: int, epoch: int, step: int) -> int:
    """The seed of one train step's generator on one device: a function of
    (seed, epoch, step), as the port's trainer seeds it."""
    return int(np.random.SeedSequence([seed, epoch, step]).generate_state(1, np.uint64)[0] >> 1)


def _uniform(g, n, lo, hi, device):
    return lo + (hi - lo) * torch.rand(n, generator=g, device=device)


def draw(g: torch.Generator, batch: int, length: int, n_mels: int, frames: int,
         device) -> Draws:
    """One microbatch's augmentation draws from g, in the port's order."""
    noise = torch.randn(batch, length, generator=g, device=device)
    noise_gate = torch.rand(batch, generator=g, device=device)
    shift_frac = _uniform(g, batch, -0.2, 0.2, device)
    shift_gate = torch.rand(batch, generator=g, device=device)
    f_width = _uniform(g, batch, 0.0, 15.0, device)
    f_start = (float(n_mels) - f_width) * torch.rand(batch, generator=g, device=device)
    t_width = _uniform(g, batch, 0.0, 35.0, device)
    t_start = (float(frames) - t_width) * torch.rand(batch, generator=g, device=device)
    return Draws(noise, noise_gate, shift_frac, shift_gate, f_width, f_start, t_width, t_start)


def concat(draws: list[Draws]) -> Draws:
    return Draws(*(torch.cat(parts) for parts in zip(*draws)))


def augment_wave(x: torch.Tensor, d: Draws) -> torch.Tensor:
    noisy = torch.where((d.noise_gate < 0.5)[:, None], x + d.noise * 0.005, x)
    length = x.shape[-1]
    shift = (d.shift_frac * length).to(torch.int64)  # truncated toward zero
    idx = (torch.arange(length, device=x.device) - shift[:, None]) % length
    return torch.where((d.shift_gate < 0.5)[:, None], torch.gather(noisy, 1, idx), noisy)


def log_mel(x: torch.Tensor, sr: int, n_fft: int, hop: int, n_mels: int) -> torch.Tensor:
    """(B, L) float32 -> (B, n_mels, 1 + L // hop) dB."""
    k = torch.arange(n_fft, dtype=torch.float64, device=x.device)
    window = (0.5 * (1 - torch.cos(2 * torch.pi * k / n_fft))).float()
    padded = torch.nn.functional.pad(x[:, None], (n_fft // 2, n_fft // 2), mode="reflect")[:, 0]
    frames = padded.unfold(-1, n_fft, hop) * window
    power = torch.fft.rfft(frames).abs() ** 2
    fb = torch.as_tensor(htk_filterbank(sr, n_fft, n_mels), dtype=torch.float32, device=x.device)
    return (10.0 * torch.log10(torch.clamp(power @ fb, min=1e-10))).transpose(1, 2)


def mask(mel: torch.Tensor, d: Draws) -> torch.Tensor:
    def band(start, width, n):
        lo = torch.floor(start)
        hi = torch.floor(start + width)
        cells = torch.arange(n, device=mel.device, dtype=torch.float32)
        return (cells >= lo[:, None]) & (cells < hi[:, None])

    f_in = band(d.f_start, d.f_width, mel.shape[1])
    t_in = band(d.t_start, d.t_width, mel.shape[2])
    return torch.where(f_in[:, :, None] | t_in[:, None, :], torch.zeros_like(mel), mel)


def normalize(mel: torch.Tensor) -> torch.Tensor:
    mean = mel.mean(dim=(1, 2), keepdim=True)
    std = mel.std(dim=(1, 2), keepdim=True)  # unbiased
    return (mel - mean) / (std + 1e-8)


def features(x: torch.Tensor, data: dict, draws: Draws | None = None) -> torch.Tensor:
    """(B, L) float32 waveforms -> (B, 1, n_mels, T) normalized log-mel
    images, augmented with `draws` where given."""
    if draws is not None:
        x = augment_wave(x, draws)
    mel = log_mel(x, data["sample_rate"], data["n_fft"], data["hop_length"], data["n_mels"])
    if draws is not None:
        mel = mask(mel, draws)
    return normalize(mel)[:, None]
