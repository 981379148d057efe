"""The port's phase vocoder (`ops/time_stretch`) against the JAX package's
on the CPU, on numpy draws of a seed.

`stft_complex` agrees to 1e-5 of the spectrum's peak. `phase_vocoder`'s
magnitudes agree to 1e-6 of the peak; its phases within the sum of the two
sides' rounding bounds: the port's `phase_bound` (its increments in f32,
their sum in float64) and the JAX op's, which also sums in f32
sequentially, adding (j + 1)·u·Σ|increment| at output frame j, and takes
exp(i·phase) of an f32 phase (u·|phase|). Phases are compared modulo 2π,
where the output's magnitude exceeds 1e-3 of its peak.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_classification_icbhi_tpu.ops.time_stretch import TimeStretch as JaxTimeStretch
from audio_classification_icbhi_tpu.ops.time_stretch import phase_vocoder as jax_vocoder
from audio_classification_icbhi_tpu.ops.time_stretch import stft_complex as jax_stft
from audio_classification_icbhi_tpu_torch.ops.time_stretch import (
    TimeStretch,
    phase_bound,
    phase_vocoder,
    stft_complex,
)

U32 = 2.0 ** -24
N_FFT, HOP = 256, 64


def signal(seed: int, n: int = 8000) -> np.ndarray:
    return (0.3 * np.random.default_rng(seed).standard_normal((2, n))).astype(np.float32)


@pytest.mark.parametrize("n_fft,hop", [(256, 64), (255, 64), (64, 16)])
def test_stft_complex_matches_jax(n_fft, hop):
    x = signal(n_fft)
    want = np.asarray(jax_stft(jnp.asarray(x), n_fft, hop))
    got = stft_complex(torch.from_numpy(x), n_fft, hop).numpy()
    assert got.shape == want.shape == (2, n_fft // 2 + 1, 1 + x.shape[-1] // hop)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def jax_bound(spec64: np.ndarray, rate: float, hop: int, n_fft: int) -> np.ndarray:
    """The JAX op's phase error bound beyond the increments': its f32
    sequential cumulative sum and its f32 exp, from the exact increments."""
    f, t = spec64.shape[-2:]
    steps = np.arange(0, t, rate)
    idx = steps.astype(np.int64)
    padded = np.concatenate([spec64, np.zeros(spec64.shape[:-1] + (2,))], axis=-1)
    a0, a1 = np.angle(padded[..., idx]), np.angle(padded[..., idx + 1])
    adv = (hop * 2 * np.pi * np.arange(f) / n_fft)[:, None]
    d = a1 - a0 - adv
    d = d - 2 * np.pi * np.round(d / (2 * np.pi)) + adv
    inc = np.abs(np.concatenate([a0[..., :1], d[..., :-1]], axis=-1))
    j = np.arange(len(idx))
    return (j + 2) * U32 * np.cumsum(inc, axis=-1)


@pytest.mark.parametrize("rate", [0.5, 1.0, 1.7])
def test_phase_vocoder_matches_jax(rate):
    spec = jax_stft(jnp.asarray(signal(7)), N_FFT, HOP)
    spec_np = np.asarray(spec)
    want = np.asarray(jax_vocoder(spec, rate, HOP))
    got = phase_vocoder(torch.from_numpy(spec_np.copy()), rate, HOP).numpy()
    t = spec_np.shape[-1]
    assert got.shape == want.shape == spec_np.shape[:-1] + (int(np.ceil(t / rate)),)
    assert got.dtype == np.complex64
    if rate == 1.0:
        np.testing.assert_array_equal(got, spec_np)
        return
    peak = np.abs(want).max()
    assert np.abs(np.abs(got) - np.abs(want)).max() <= 1e-6 * peak
    bound = (phase_bound(spec_np.shape[-2], got.shape[-1], HOP, N_FFT) * 2
             + jax_bound(spec_np.astype(np.complex128), rate, HOP, N_FFT))
    dphi = np.abs(np.angle(got.astype(np.complex128) * np.conj(want)))
    seen = np.abs(want) > 1e-3 * peak
    assert (dphi <= bound)[seen].all(), float((dphi / bound)[seen].max())


def test_phase_bound_holds_against_float64():
    """The port in f32 against itself in float64: phases within
    `phase_bound`, magnitudes within 1e-6 of the peak."""
    spec = stft_complex(torch.from_numpy(signal(9, 16000)), 512, 128)
    for rate in (0.8, 1.25):
        got = phase_vocoder(spec, rate, 128)
        ref = phase_vocoder(spec.to(torch.complex128), rate, 128).numpy()
        peak = np.abs(ref).max()
        assert np.abs(np.abs(got.numpy()) - np.abs(ref)).max() <= 1e-6 * peak
        dphi = np.abs(np.angle(got.numpy().astype(np.complex128) * np.conj(ref)))
        seen = np.abs(ref) > 1e-3 * peak
        bound = phase_bound(257, got.shape[-1], 128, 512)
        assert (dphi <= bound)[seen].all()


def test_time_stretch_transform_matches_jax():
    spec = jax_stft(jnp.asarray(signal(11)), N_FFT, HOP)
    spec_t = torch.from_numpy(np.asarray(spec).copy())
    n_freq = N_FFT // 2 + 1
    ours, theirs = TimeStretch(HOP, n_freq, fixed_rate=1.3), JaxTimeStretch(HOP, n_freq, 1.3)
    assert ours.n_fft == theirs.n_fft == N_FFT
    for rate in (None, 0.9):
        got, want = ours(spec_t, rate).numpy(), np.asarray(theirs(spec, rate))
        assert got.shape == want.shape
        assert np.abs(np.abs(got) - np.abs(want)).max() <= 1e-6 * np.abs(want).max()
    assert TimeStretch(HOP, n_freq, 1.0)(spec_t) is spec_t
    with pytest.raises(ValueError, match="fixed_rate is None"):
        TimeStretch(HOP, n_freq)(spec_t)
    with pytest.raises(ValueError, match="fixed_rate is None"):
        JaxTimeStretch(HOP, n_freq)(spec)
