"""The port's on-device resampler (`ops/resample.resample`, a polyphase
`F.conv1d`) against the JAX package's `ops.resample` (an XLA conv at
Precision.HIGHEST) on the CPU, on numpy draws of a seed.

Both apply the same f32 kernel bank; only the order of the K-tap sums
differs, so they agree to a few f32 ulps of the output scale: atol 1e-6 on
signals of unit scale (the taps' absolute sum is ~1.5, K <= 475).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_classification_icbhi_tpu.ops.resample import resample as jax_resample
from audio_classification_icbhi_tpu_torch.data.wavio import resample_np
from audio_classification_icbhi_tpu_torch.ops.resample import resample

ATOL = 1e-6


@pytest.mark.parametrize("orig", [44100, 4000, 10000])
def test_matches_jax_at_the_corpus_rates(orig):
    x = np.random.default_rng(orig).uniform(-1, 1, (3, orig // 4)).astype(np.float32)
    want = np.asarray(jax_resample(jnp.asarray(x), orig, 16000))
    got = resample(torch.from_numpy(x), orig, 16000).numpy()
    assert got.shape == want.shape == (3, math.ceil(16000 * (orig // 4) / orig))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    # the host resampler applies the same bank
    np.testing.assert_allclose(got, resample_np(x, orig, 16000), rtol=0, atol=ATOL)


def test_identity_returns_the_input():
    x = torch.randn(2, 100)
    assert resample(x, 16000, 16000) is x


@pytest.mark.parametrize("shape", [(777,), (2, 3, 501)])
@pytest.mark.parametrize("rates", [(16000, 44100), (48000, 16000), (22050, 16000)])
def test_leading_shapes_and_length(shape, rates):
    """Any leading shape; the length is ceil(new·L/orig) after gcd
    reduction, as JAX's."""
    orig, new = rates
    x = np.random.default_rng(len(shape)).uniform(-1, 1, shape).astype(np.float32)
    want = np.asarray(jax_resample(jnp.asarray(x), orig, new))
    got = resample(torch.from_numpy(x), orig, new).numpy()
    g = math.gcd(orig, new)
    assert got.shape == want.shape == shape[:-1] + (math.ceil(new // g * shape[-1] / (orig // g)),)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_tf32_switches_are_restored():
    """The call holds full f32 inside and leaves the caller's switches as
    they were (on the card it is checked against float64 with TF32 on)."""
    before = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        x = torch.randn(4, 1000)
        y = resample(x, 10000, 16000)
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
        want = resample(x.double(), 10000, 16000)
        assert (y.double() - want).abs().max().item() <= ATOL
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before
