"""The port's LightweightCNN and weight bridge against the JAX package's.

Weights come from a flax init (PRNGKey(0)) and are carried across with
state_dict_from_flax; features are made with numpy from a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_classification_icbhi_tpu.models import LightweightCNN as FlaxCNN
from audio_classification_icbhi_tpu.models.torch_import import convert_lightweight_cnn
from audio_classification_icbhi_tpu_torch.models import (
    CompactResNet,
    LightweightCNN,
    build_model,
    count_parameters,
)
from audio_classification_icbhi_tpu_torch.models.weights import (
    flax_from_state_dict,
    state_dict_from_flax,
)
from audio_classification_icbhi_tpu_torch.utils.config import load_config

SHAPE = (4, 128, 157, 1)  # 5 s at 16 kHz, hop 512


@pytest.fixture(scope="module")
def flax_variables():
    v = FlaxCNN(num_classes=4).init(jax.random.PRNGKey(0), jnp.zeros((1,) + SHAPE[1:]),
                                    train=False)
    v = jax.tree_util.tree_map(np.asarray, v)
    # non-trivial BN statistics, so the running-stat path is exercised
    rng = np.random.default_rng(1)
    for blk in v["batch_stats"].values():
        bn = blk["BatchNorm_0"]
        bn["mean"] = (0.1 * rng.standard_normal(bn["mean"].shape)).astype(np.float32)
        bn["var"] = (1.0 + 0.5 * rng.random(bn["var"].shape)).astype(np.float32)
    return v


def assert_trees_equal(a, b):
    assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
    for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_bridge_round_trips(flax_variables):
    sd = state_dict_from_flax(flax_variables)
    assert_trees_equal(flax_from_state_dict(sd), flax_variables)
    assert_trees_equal(convert_lightweight_cnn(sd), flax_variables)
    # and the state_dict loads into the port's module with every name matched
    LightweightCNN().load_state_dict(sd, strict=True)


@pytest.mark.parametrize("dtype, atol", [
    ("fp32", 1e-4),
    # bf16 compute on both sides: the tolerance tests/test_fused_cnn.py uses
    ("bf16", 5e-3),
])
def test_eval_logits_match_flax(flax_variables, rng, dtype, atol):
    jdt, tdt = {"fp32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    x = rng.standard_normal(SHAPE).astype(np.float32)
    want = np.asarray(FlaxCNN(num_classes=4, dtype=jdt).apply(
        flax_variables, jnp.asarray(x), train=False))
    model = LightweightCNN(dtype=tdt)
    model.load_state_dict(state_dict_from_flax(flax_variables))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (4, 4)
    np.testing.assert_allclose(got.numpy(), want, atol=atol)


def test_parameter_count():
    assert count_parameters(LightweightCNN(num_classes=4)) == 1_012_068


def test_registry_precision_and_errors():
    cfg = load_config()
    assert cfg["training"]["mixed_precision"] is True
    assert build_model(cfg).dtype == torch.bfloat16
    cfg["training"]["precision"] = "fp16"
    assert build_model(cfg).dtype == torch.float16
    cfg["training"]["mixed_precision"] = False
    del cfg["training"]["precision"]
    assert build_model(cfg).dtype == torch.float32
    cfg["model"]["architecture"] = "resnet"
    assert isinstance(build_model(cfg), CompactResNet)
    cfg["model"]["architecture"] = "vit"
    with pytest.raises(ValueError, match="Unknown model architecture"):
        build_model(cfg)


def test_seeded_init_statistics():
    """He fan_out normal convs and N(0, 0.01) dense kernels, reproducible
    from a generator."""
    a = LightweightCNN(generator=torch.Generator().manual_seed(0))
    b = LightweightCNN(generator=torch.Generator().manual_seed(0))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    w = a.conv4.conv.weight
    assert abs(w.std().item() - (2.0 / (256 * 9)) ** 0.5) < 2e-3
    assert abs(a.fc1.weight.std().item() - 0.01) < 1e-3
    assert torch.count_nonzero(a.fc1.bias) == 0


def test_odd_widths_pool_by_floor():
    model = LightweightCNN().eval()
    feats = []
    for i in range(1, 6):
        getattr(model, f"conv{i}").register_forward_hook(
            lambda m, inp, out: feats.append(tuple(out.shape[2:])))
    with torch.no_grad():
        model(torch.zeros(1, 128, 157, 1))
    assert feats == [(64, 78), (32, 39), (16, 19), (8, 9), (4, 4)]
