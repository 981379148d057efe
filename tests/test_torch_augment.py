"""The port's augmentation and the training form of its log-mel kernel
against the JAX package's, on the CPU.

jax.random and torch draw different streams, so the JAX draws are taken
from the JAX package's own key splits (`jax_augment_draws`) and fed to the
port's apply functions. The masked kernel's plain version is held against
the JAX radix-16 kernel in interpret mode. Inputs are made with numpy from
a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_classification_icbhi_tpu.ops import augment as jax_aug
from audio_classification_icbhi_tpu.ops import mel as jax_mel
from audio_classification_icbhi_tpu.ops.pallas_mel import log_mel_pallas
from audio_classification_icbhi_tpu.parallel import data_parallel as jax_dp
from audio_classification_icbhi_tpu_torch.ops import augment as aug
from audio_classification_icbhi_tpu_torch.ops import mel as port_mel
from audio_classification_icbhi_tpu_torch.ops.mel_kernels import (
    log_mel_radix16dif_fused,
    log_mel_fused_reference,
)
from audio_classification_icbhi_tpu_torch.parallel import data_parallel as port_dp

SR, N_FFT, HOP, N_MELS = 16000, 2048, 512, 128


def _wave_draws(keys, length):
    """JAX augment_waveform's draws for per-example keys (augment.py:49-53)."""
    def one(k):
        k_gate_n, k_noise, k_gate_s, k_shift = jax.random.split(k, 4)
        return (jax.random.normal(k_noise, (length,), jnp.float32),
                jax.random.uniform(k_gate_n),
                jax.random.uniform(k_shift, (), minval=-0.2, maxval=0.2),
                jax.random.uniform(k_gate_s))

    return aug.WaveDraws(*(torch.from_numpy(np.array(x)) for x in jax.vmap(one)(keys)))


def _spec_draws(keys, n_mels, num_frames):
    """JAX augment_spectrogram's float draws (augment.py:67-70, :100-102)."""
    def mask(k, size, param):
        k_w, k_s = jax.random.split(k)
        width = jax.random.uniform(k_w, (), minval=0.0, maxval=float(param))
        start = jax.random.uniform(k_s, (), minval=0.0, maxval=float(size) - width)
        return width, start

    def one(k):
        k_f, k_t = jax.random.split(k)
        return (*mask(k_f, n_mels, 15), *mask(k_t, num_frames, 35))

    return aug.SpecDraws(*(torch.from_numpy(np.array(x)) for x in jax.vmap(one)(keys)))


def jax_augment_draws(key, batch, length, n_mels, num_frames) -> aug.AugmentDraws:
    """The draws the JAX package's features_from_wavs(augment=True, key=key)
    makes for one microbatch (data_parallel.py:74-90)."""
    k_wav, k_spec = jax.random.split(key)
    return aug.AugmentDraws(_wave_draws(jax.random.split(k_wav, batch), length),
                            _spec_draws(jax.random.split(k_spec, batch), n_mels, num_frames))


class TestApplies:
    def test_augment_waveform_matches_jax(self, rng):
        b, length = 16, 4000
        wavs = (0.3 * rng.standard_normal((b, length))).astype(np.float32)
        keys = jax.random.split(jax.random.PRNGKey(5), b)
        want = np.asarray(jax.vmap(jax_aug.augment_waveform)(keys, jnp.asarray(wavs)))
        draws = _wave_draws(keys, length)
        # both gates take both branches somewhere in the batch
        for gate in (draws.noise_gate, draws.shift_gate):
            assert (gate < 0.5).any() and (gate >= 0.5).any()
        got = aug.augment_waveform(torch.from_numpy(wavs), draws).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)

    def test_time_shift_truncates_toward_zero(self):
        x = torch.arange(10, dtype=torch.float32)[None].repeat(4, 1)
        frac = torch.tensor([0.25, -0.25, 0.19, -0.19])  # shifts 2, -2, 1, -1
        got = aug.time_shift(x, frac)
        for row, s in zip(got, (2, -2, 1, -1)):
            assert torch.equal(row, torch.roll(x[0], s))

    def test_augment_spectrogram_matches_jax_exactly(self, rng):
        b, n_mels, t = 12, 32, 51
        mel = rng.standard_normal((b, n_mels, t)).astype(np.float32)
        keys = jax.random.split(jax.random.PRNGKey(9), b)
        want = np.asarray(jax.vmap(jax_aug.augment_spectrogram)(keys, jnp.asarray(mel)))
        got = aug.augment_spectrogram(torch.from_numpy(mel), _spec_draws(keys, n_mels, t))
        np.testing.assert_array_equal(got.numpy(), want)
        assert (want == 0.0).any()

    def test_spec_mask_bounds_match_jax_exactly(self):
        b, n_mels, t = 64, 128, 251
        keys = jax.random.split(jax.random.PRNGKey(2), b)
        want = np.asarray(jax.vmap(lambda k: jax_aug.spec_mask_bounds(k, n_mels, t))(keys))
        got = aug.spec_mask_bounds(_spec_draws(keys, n_mels, t))
        assert got.dtype == torch.float32 and got.shape == (b, 4)
        np.testing.assert_array_equal(got.numpy(), want)

    def test_bounds_mask_equals_augment_spectrogram(self, rng):
        """The kernel's mask (from the truncated bounds, compared in f32),
        which augment_spectrogram applies, zeroes exactly the bands
        [floor(start), floor(start + width)) of each example's float draws,
        at config.yaml's 128 mels x 251 frames."""
        b, n_mels, t = 32, 128, 251
        mel_np = rng.standard_normal((b, n_mels, t)).astype(np.float32) + 10.0  # no zeros
        mel = torch.from_numpy(mel_np)
        draws = aug.draw_spectrogram(torch.Generator().manual_seed(4), b, n_mels, t, "cpu")
        want = mel_np.copy()
        d = {k: v.numpy() for k, v in draws._asdict().items()}
        for i in range(b):
            want[i, int(np.floor(d["f_start"][i])):int(np.floor(d["f_start"][i] + d["f_width"][i]))] = 0
            want[i, :, int(np.floor(d["t_start"][i])):int(np.floor(d["t_start"][i] + d["t_width"][i]))] = 0
        np.testing.assert_array_equal(
            aug.mask_from_bounds(mel, aug.spec_mask_bounds(draws)).numpy(), want)
        np.testing.assert_array_equal(aug.augment_spectrogram(mel, draws).numpy(), want)


class TestDraws:
    def test_draws_come_from_the_generator(self):
        def draw(seed):
            return aug.draw_augment(torch.Generator().manual_seed(seed), 8, 1000, 128, 251, "cpu")

        a, b, c = draw(0), draw(0), draw(1)
        for x, y, z in zip(a.wave + a.spec, b.wave + b.spec, c.wave + c.spec):
            assert torch.equal(x, y) and not torch.equal(x, z)
        assert a.wave.noise.shape == (8, 1000) and a.spec.t_start.shape == (8,)

    def test_draw_ranges(self):
        n, n_mels, t = 4096, 128, 251
        d = aug.draw_augment(torch.Generator().manual_seed(3), n, 16, n_mels, t, "cpu")
        assert d.wave.shift_frac.abs().max() <= 0.2
        assert 0 <= d.spec.f_width.min() and d.spec.f_width.max() <= 15
        assert 0 <= d.spec.t_width.min() and d.spec.t_width.max() <= 35
        assert (d.spec.f_start >= 0).all() and (d.spec.f_start + d.spec.f_width <= n_mels).all()
        assert (d.spec.t_start >= 0).all() and (d.spec.t_start + d.spec.t_width <= t).all()
        assert abs(float((d.wave.noise_gate < 0.5).float().mean()) - 0.5) < 0.05

    def test_concat_draws(self):
        g = torch.Generator().manual_seed(0)
        parts = [aug.draw_augment(g, 3, 10, 8, 5, "cpu") for _ in range(2)]
        flat = aug.concat_draws(parts)
        assert flat.wave.noise.shape == (6, 10)
        assert torch.equal(flat.spec.f_start[3:], parts[1].spec.f_start)


# Bounds at the edges: a zero width, a frequency band past n_mels, a time
# band past T (T = 32 frames for 16,320 samples).
EDGE_BOUNDS = np.array([[3.0, 0.0, 10.0, 5.0],
                        [120.0, 15.0, 28.0, 30.0],
                        [5.0, 7.0, 40.0, 3.0]], np.float32)


class TestMaskedKernel:
    def test_plain_version_matches_jax_kernel(self, rng):
        """The training form's plain version against the JAX radix-16
        kernel with the same bounds, in interpret mode: 2e-3, the JAX
        package's tolerance for its masked kernel (test_pallas_mel.py:489-516)."""
        n = (0.1 * rng.standard_normal((3, SR + 320))).astype(np.float32)
        n[1] *= 20.0
        kw = dict(top_db=60.0, normalize=True)
        want = np.asarray(log_mel_pallas(
            jnp.asarray(n), SR, N_FFT, HOP, N_MELS, algorithm="radix16dif_fused",
            interpret=True, spec_mask_bounds=jnp.asarray(EDGE_BOUNDS), **kw))
        bounds = torch.from_numpy(EDGE_BOUNDS)
        got = log_mel_fused_reference(
            torch.from_numpy(n), SR, N_FFT, HOP, N_MELS, spec_mask_bounds=bounds, **kw).numpy()
        assert got.shape == (3, N_MELS, 32)
        np.testing.assert_allclose(got, want, atol=2e-3)
        # the wrapper on a CPU tensor is the plain version
        wrapped = log_mel_radix16dif_fused(torch.from_numpy(n), SR, N_FFT, HOP, N_MELS,
                                           spec_mask_bounds=bounds, **kw).numpy()
        np.testing.assert_array_equal(wrapped, got)
        # the masked cells are where the bounds say, and nowhere else
        unmasked = log_mel_fused_reference(
            torch.from_numpy(n), SR, N_FFT, HOP, N_MELS, top_db=60.0).numpy()
        masked = log_mel_fused_reference(
            torch.from_numpy(n), SR, N_FFT, HOP, N_MELS, top_db=60.0,
            spec_mask_bounds=bounds).numpy()
        zeroed = masked != unmasked
        # example 0: no mel band (width 0), frames 10..14
        assert zeroed[0, :, 10:15].all() and not zeroed[0, :, :10].any()
        assert not zeroed[0, :, 15:].any()
        assert zeroed[1, 120:].all() and zeroed[1, :, 28:].all()
        assert zeroed[2, 5:12].all() and not zeroed[2, :5].any()  # time band past T

    def test_frontend_fused_route_with_bounds(self, rng):
        fe = port_mel.MelFrontend(duration=1.0)
        x = torch.from_numpy((0.1 * rng.standard_normal((3, SR))).astype(np.float32))
        bounds = torch.from_numpy(EDGE_BOUNDS)
        got = fe._pallas_log_mel(x, normalize=True, spec_mask_bounds=bounds)
        want = port_mel.normalize_spectrogram(aug.mask_from_bounds(fe.log_mel(x), bounds))
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)

    def test_bounds_need_a_fused_algorithm(self):
        """As in the JAX package (pallas_mel.py:1734-1738)."""
        wav = np.zeros((2, SR), np.float32)
        bounds = np.zeros((2, 4), np.float32)
        with pytest.raises(ValueError, match="fused algorithm"):
            log_mel_pallas(jnp.asarray(wav), SR, N_FFT, HOP, N_MELS, algorithm="radix2",
                           interpret=True, spec_mask_bounds=jnp.asarray(bounds))
        fe = port_mel.MelFrontend(duration=1.0, pallas_algorithm="radix2")
        with pytest.raises(ValueError, match="fused algorithm"):
            fe._pallas_log_mel(torch.from_numpy(wav), normalize=True,
                               spec_mask_bounds=torch.from_numpy(bounds))

    @pytest.mark.parametrize("bounds, error, match", [
        (torch.zeros(3, 4), ValueError, r"\(B, 4\)"),
        (torch.zeros(2, 4, dtype=torch.float64), TypeError, "float32"),
        (torch.zeros(2, 4, device="meta"), ValueError, "is on meta"),
    ])
    def test_wrapper_checks_bounds(self, bounds, error, match):
        with pytest.raises(error, match=match):
            log_mel_radix16dif_fused(torch.zeros(2, SR), SR, N_FFT, HOP, N_MELS,
                                     spec_mask_bounds=bounds)


def test_augmented_features_match_jax(rng):
    """features_from_wavs(augment=True) with the JAX draws injected, at the
    small front end of tests/test_training.py:674-676 (the JAX side on its
    explicit XLA path, so both compute in f32)."""
    jfe = jax_mel.MelFrontend(sample_rate=4000, n_mels=32, n_fft=256, hop_length=64,
                              duration=0.8, backend="xla")
    pfe = port_mel.MelFrontend(sample_rate=4000, n_mels=32, n_fft=256, hop_length=64,
                               duration=0.8)
    b, length = 6, pfe.target_length
    wavs = (0.3 * rng.standard_normal((b, length))).astype(np.float32)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jax_dp.features_from_wavs(jfe, jnp.asarray(wavs), augment=True, key=key))
    draws = jax_augment_draws(key, b, length, 32, pfe.num_frames)
    got = port_dp.features_from_wavs(pfe, torch.from_numpy(wavs), augment=True, draws=draws)
    assert got.shape == want.shape == (b, 32, 51, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
