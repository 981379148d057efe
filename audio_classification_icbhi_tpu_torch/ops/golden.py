"""The float64 log-mel golden, its float32 twin and the parity battery, in
numpy.

Copies of `benchmarks/sweep_mel.golden_mel`, `bench._golden_mel_f32` and
`bench.parity_battery`, kept here because those modules import jax. The
golden is the budget every front-end kernel is held to: at most 1e-3 dB over
the battery (PERF.md section 2). Both goldens frame as the JAX package does at
every n_fft: at odd n_fft the last frame can run one sample past the padded
signal, and its index clamps to the last sample (`_frames`).
"""

from __future__ import annotations

import numpy as np


def _frames(wav, n_fft, hop, dtype):
    """(T, n_fft) windowed frames in `dtype`, T = 1 + L // hop: reflect pad
    by n_fft // 2, then frame t at t * hop, its index clamped to the padded
    signal's last sample."""
    win = (0.5 * (1 - np.cos(2 * np.pi * np.arange(n_fft) / n_fft))).astype(dtype)
    xp = np.pad(wav.astype(dtype), n_fft // 2, mode="reflect")
    t = 1 + len(wav) // hop
    idx = np.minimum(np.arange(t)[:, None] * hop + np.arange(n_fft), len(xp) - 1)
    return xp[idx] * win


def _filterbank(sr, n_fft, n_mels, dtype):
    """(n_fft // 2 + 1, n_mels) HTK triangles, computed in float64 and stored
    in `dtype`."""
    def h2m(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)

    def m2h(m):
        return 700.0 * (10 ** (m / 2595.0) - 1.0)

    freqs = np.linspace(0, sr / 2, n_fft // 2 + 1)
    pts = m2h(np.linspace(h2m(0.0), h2m(sr / 2), n_mels + 2))
    fb = np.zeros((n_fft // 2 + 1, n_mels), dtype)
    for m in range(n_mels):
        lo, cen, hi = pts[m], pts[m + 1], pts[m + 2]
        fb[:, m] = np.maximum(
            0, np.minimum((freqs - lo) / (cen - lo), (hi - freqs) / (hi - cen))).astype(dtype)
    return fb


def golden_mel(wav, sr=16000, n_fft=2048, hop=512, n_mels=128):
    """(L,) waveform -> (n_mels, T) dB, all in float64: reflect pad, periodic
    Hann, |rfft|², HTK mel filterbank, 10·log10(max(·, 1e-10))."""
    p = (np.abs(np.fft.rfft(_frames(wav, n_fft, hop, np.float64), axis=-1)) ** 2).T
    return 10 * np.log10(np.maximum(_filterbank(sr, n_fft, n_mels, np.float64).T @ p, 1e-10))


def golden_mel_f32(wav, sr=16000, n_fft=2048, hop=512, n_mels=128):
    """`golden_mel` computed end to end in float32 (window, frames, FFT,
    filterbank, log): the numerics floor of any float32 implementation of the
    chain. numpy's rfft of a float32 input runs in complex64."""
    frames = _frames(wav, n_fft, hop, np.float32)
    p = (np.abs(np.fft.rfft(frames, axis=-1)) ** 2).T.astype(np.float32)
    mel = (_filterbank(sr, n_fft, n_mels, np.float32).T @ p).astype(np.float32)
    return 10 * np.log10(np.maximum(mel, np.float32(1e-10)), dtype=np.float32)


def parity_battery(length: int) -> np.ndarray:
    """(8, length) float32 worst-case inputs at 16 kHz: white noise, a loud
    and a faint tone, a chirp, crackles, silence, a square wave, a harmonic
    stack and decaying noise, each over a 0.03 noise floor, which caps the
    in-clip dynamic range near the 30 dB that respiratory audio occupies."""
    rng = np.random.default_rng(7)
    t = np.arange(length) / 16000.0
    sigs = [
        0.1 * rng.standard_normal(length),
        0.5 * np.sin(2 * np.pi * 440 * t) + 1e-3 * np.sin(2 * np.pi * 3017 * t),
        np.sin(2 * np.pi * (50 + 3950 * t / t[-1]) * t) * 0.3,
        np.where(rng.random(length) < 0.001, rng.standard_normal(length), 0.0)
        + 0.01 * rng.standard_normal(length),
        np.zeros(length),
        0.9 * np.sign(np.sin(2 * np.pi * 100 * t)),
        sum(a * np.sin(2 * np.pi * f * t) for a, f in
            ((0.3, 150), (0.2, 600), (0.1, 1200), (0.05, 2400), (1e-3, 6000))),
        0.2 * rng.standard_normal(length) * np.exp(-t / (t[-1] / 4)),
    ]
    floor = 3e-2 * rng.standard_normal((len(sigs), length))
    return (np.stack(sigs) + floor).astype(np.float32)
