"""The port's log-mel front end against the JAX package's, on the CPU.

The JAX side runs as its own tests run it here: the radix-16 Pallas kernel
in interpret mode, and MelFrontend(backend="xla"). The port side gets CPU
tensors, so its kernel wrapper runs its plain torch version. Inputs are
made with numpy from a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_classification_icbhi_tpu.ops import mel as jax_mel
from audio_classification_icbhi_tpu.ops.pallas_mel import log_mel_pallas
from audio_classification_icbhi_tpu_torch.ops import mel as port_mel
from audio_classification_icbhi_tpu_torch.ops import stft as port_stft
from audio_classification_icbhi_tpu_torch.ops.mel_kernels import (
    log_mel_radix16dif_fused,
    log_mel_fused_reference,
)
from bench import parity_battery
from benchmarks.sweep_mel import golden_mel

SR, N_FFT, HOP, N_MELS = 16000, 2048, 512, 128


def jax_kernel(wav, **kw):
    return np.asarray(log_mel_pallas(jnp.asarray(wav), SR, N_FFT, HOP, N_MELS,
                                     algorithm="radix16dif_fused", interpret=True, **kw))


def port_kernel(wav, **kw):
    out = log_mel_radix16dif_fused(torch.from_numpy(wav), SR, N_FFT, HOP, N_MELS, **kw)
    return out.numpy()


class TestAgainstJaxKernel:
    def test_noise_odd_batch_and_length(self, rng):
        """B = 3, L = 16,320: nothing is a multiple of the TPU kernel's
        packing. 1e-3 dB is the JAX package's own tolerance for this kernel
        (tests/test_pallas_mel.py:343-349); it covers the TPU kernel's bf16
        pass floor."""
        n = (0.1 * rng.standard_normal((3, SR + 320))).astype(np.float32)
        got = port_kernel(n)
        assert got.shape == (3, N_MELS, 1 + (SR + 320) // HOP)
        np.testing.assert_allclose(got, jax_kernel(n), atol=1e-3)

    def test_parity_battery(self):
        """Tonal, chirp, impulsive, silent and square inputs at 1 s: 1.5e-3
        dB, the JAX package's tolerance for its kernel on tonal content."""
        wav = parity_battery(SR)
        np.testing.assert_allclose(port_kernel(wav), jax_kernel(wav), atol=1.5e-3)

    def test_epilogue_top_db_and_normalize(self, rng):
        """top_db 60 against each example's own peak, then the per-example
        normalize; one loud example must not leak into the others."""
        n = (0.1 * rng.standard_normal((8, SR))).astype(np.float32)
        n[3] *= 20.0
        kw = dict(normalize=True, top_db=60.0)
        np.testing.assert_allclose(port_kernel(n, **kw), jax_kernel(n, **kw), atol=2e-3)


@pytest.mark.parametrize("duration", [5.0, 1.0])
def test_plain_version_against_f64_golden(duration):
    """The plain version at f32 within 1e-3 dB of the float64 FFT golden,
    unrestricted, over the parity battery."""
    wavs = parity_battery(int(SR * duration))
    got = log_mel_fused_reference(
        torch.from_numpy(wavs), SR, N_FFT, HOP, N_MELS).double().numpy()
    want = np.stack([golden_mel(w, SR, N_FFT, HOP, N_MELS) for w in wavs])
    assert np.abs(got - want).max() <= 1e-3


@pytest.mark.parametrize("duration", [5.0, 1.0])
def test_port_golden_copies_match_originals(duration):
    """The port keeps numpy copies of golden_mel and parity_battery (their
    homes import jax); they must stay identical to the originals."""
    from audio_classification_icbhi_tpu_torch.ops import golden

    length = int(SR * duration)
    wavs = golden.parity_battery(length)
    np.testing.assert_array_equal(wavs, parity_battery(length))
    np.testing.assert_array_equal(golden.golden_mel(wavs[2]), golden_mel(wavs[2]))


@pytest.mark.parametrize("mel_scale", ["htk", "slaney"])
@pytest.mark.parametrize("norm", [None, "slaney"])
def test_filterbank_matches_jax(mel_scale, norm):
    for sr, n_fft, n_mels, f_min, f_max in ((16000, 2048, 128, 0.0, None),
                                            (22050, 1024, 64, 50.0, 8000.0)):
        got = port_mel.mel_filterbank(sr, n_fft, n_mels, f_min, f_max, mel_scale, norm).numpy()
        want = jax_mel._mel_filterbank_np(sr, n_fft, n_mels, f_min,
                                          sr / 2.0 if f_max is None else f_max,
                                          mel_scale, norm)
        np.testing.assert_allclose(got, want, atol=1e-6)


def test_frontend_matches_jax_xla_frontend(rng):
    """MelFrontend.__call__ (normalized) at 5 s against the JAX frontend's
    explicit XLA path."""
    n = (0.1 * rng.standard_normal((2, 5 * SR))).astype(np.float32)
    want = np.asarray(jax_mel.MelFrontend(duration=5.0, backend="xla")(jnp.asarray(n)))
    fe = port_mel.MelFrontend(duration=5.0)
    got = fe(torch.from_numpy(n)).numpy()
    assert got.shape == (2, N_MELS, fe.num_frames)
    np.testing.assert_allclose(got, want, atol=2e-3)
    # the fused route (kernel algorithm on a CPU tensor) computes the same
    fused = fe._pallas_log_mel(torch.from_numpy(n), normalize=True).numpy()
    np.testing.assert_allclose(fused, got, atol=1e-5)


def test_stft_helpers_match_jax(rng):
    from audio_classification_icbhi_tpu.ops import stft as jax_stft

    for length, pad in ((100, 10), (5, 12), (2, 3)):
        x = rng.standard_normal((2, length)).astype(np.float32)
        np.testing.assert_array_equal(
            port_stft.reflect_pad(torch.from_numpy(x), pad).numpy(),
            np.asarray(jax_stft.reflect_pad(jnp.asarray(x), pad)))
    x = rng.standard_normal((2, 3000)).astype(np.float32)
    np.testing.assert_array_equal(
        port_stft.frame_signal(torch.from_numpy(x), 512, 128).numpy(),
        np.asarray(jax_stft.frame_signal(jnp.asarray(x), 512, 128)))
    np.testing.assert_allclose(port_stft.hann_window(400).numpy(),
                               np.asarray(jax_stft.hann_window(400)), atol=0)


class TestErrors:
    wav = np.zeros((2, SR), np.float32)

    @pytest.mark.parametrize("n_fft, hop, match", [
        (2048, 64, "hop_length % 128"),
        (1024, 128, "n_fft % 2048"),
        (2040, 120, "divisible by 16"),
        (2048, 384, "divisible by hop_length"),
    ])
    def test_ineligible_shapes_raise_like_jax(self, n_fft, hop, match):
        for fn in (
            lambda: log_mel_pallas(jnp.asarray(self.wav), SR, n_fft, hop, N_MELS,
                                   algorithm="radix16dif_fused", interpret=True),
            lambda: log_mel_radix16dif_fused(torch.from_numpy(self.wav), SR, n_fft, hop, N_MELS),
        ):
            with pytest.raises(ValueError, match=match):
                fn()

    @pytest.mark.parametrize("kwargs, match", [
        (dict(dft_passes=7), "dft_passes must be"),
        (dict(dft_passes=5, backend="xla"), "never runs the Pallas kernels"),
        (dict(dft_passes=6, n_fft=512, hop_length=128), "requires the radix-8/16"),
        (dict(dft_passes=6, backend="xla_radix2"), "never runs the Pallas kernels"),
    ])
    def test_frontend_dft_passes_raise_like_jax(self, kwargs, match):
        for cls in (jax_mel.MelFrontend, port_mel.MelFrontend):
            with pytest.raises(ValueError, match=match):
                cls(**kwargs)

    def test_wrapper_dft_passes_checked(self):
        with pytest.raises(ValueError, match="dft_passes must be"):
            log_mel_radix16dif_fused(torch.from_numpy(self.wav), SR, N_FFT, HOP, N_MELS,
                                     dft_passes=2)
        for p in (3, 4, 5, 6):  # every TPU pass budget is accepted
            log_mel_radix16dif_fused(torch.from_numpy(self.wav[:1, :4096]), SR, N_FFT,
                                     HOP, N_MELS, dft_passes=p)

    def test_wrapper_rejects_other_devices_and_ranks(self):
        with pytest.raises(ValueError, match=r"\(B, L\)"):
            log_mel_radix16dif_fused(torch.zeros(SR), SR, N_FFT, HOP, N_MELS)
        with pytest.raises(ValueError, match="unsupported device"):
            log_mel_radix16dif_fused(torch.zeros(1, SR, device="meta"), SR, N_FFT, HOP, N_MELS)

    def test_unported_algorithm_policy(self):
        """Every algorithm name of the JAX policy is known; on the CPU each
        runs the plain chain."""
        fe = port_mel.MelFrontend(n_fft=512, hop_length=128, duration=0.5)
        assert fe._pallas_algorithm() == "radix4dif_fused"
        x = torch.from_numpy((0.1 * np.random.default_rng(0).standard_normal((2, 8000)))
                             .astype(np.float32))
        np.testing.assert_allclose(fe._pallas_log_mel(x, normalize=True).numpy(),
                                   fe(x).numpy(), atol=1e-5)
        with pytest.raises(ValueError, match="unknown algorithm"):
            port_mel.MelFrontend(pallas_algorithm="radix3")._pallas_log_mel(x, normalize=False)
