"""The port's train step and its pieces against the JAX package's, on the CPU.

Same inputs (numpy, from a seed), same weights (a flax init carried across
with state_dict_from_flax) and the same augmentation draws (the JAX
package's own, taken from its key splits and injected into the port).
Dropout is inert on both sides: the JAX step runs under an interceptor that
returns every nn.Dropout's input, and the port's rates are set to 0.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from audio_classification_icbhi_tpu.models import LightweightCNN as FlaxCNN
from audio_classification_icbhi_tpu.models.cnn import ConvBlock as FlaxConvBlock
from audio_classification_icbhi_tpu.ops import mel as jax_mel
from audio_classification_icbhi_tpu.parallel import data_parallel as jax_dp
from audio_classification_icbhi_tpu.parallel.mesh import get_mesh
from audio_classification_icbhi_tpu.training.optimizers import build_optimizer as jax_optimizer
from audio_classification_icbhi_tpu_torch.models import LightweightCNN
from audio_classification_icbhi_tpu_torch.models.cnn import ConvBlock, dropout
from audio_classification_icbhi_tpu_torch.models.weights import (
    PARAM_NAMES,
    flax_from_state_dict,
    opt_state_from_optax,
    optax_from_opt_state,
    params_from_flax,
    state_dict_from_flax,
)
from audio_classification_icbhi_tpu_torch.ops import mel as port_mel
from audio_classification_icbhi_tpu_torch.parallel import data_parallel as port_dp
from audio_classification_icbhi_tpu_torch.training.optimizers import build_optimizer
from test_torch_augment import jax_augment_draws

SMALL_FE = dict(sample_rate=4000, n_mels=32, n_fft=256, hop_length=64, duration=0.8)
CW = np.asarray([1.0, 2.0, 0.5, 1.5], np.float32)


def no_dropout(next_fun, args, kwargs, context):
    """flax interceptor: every nn.Dropout returns its input."""
    if isinstance(context.module, nn.Dropout) and context.method_name == "__call__":
        return args[0]
    return next_fun(*args, **kwargs)


def host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def assert_trees_close(got, want, **tol):
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)


@pytest.fixture(scope="module")
def flax_vars():
    dummy = jnp.zeros((2, 32, 51, 1), jnp.float32)
    return host(FlaxCNN(num_classes=4).init(jax.random.PRNGKey(0), dummy, train=False))


# --- 0: the BatchNorm repair -------------------------------------------------

class TestBatchNormRepair:
    def test_running_var_is_biased_as_in_flax(self, rng):
        """One train-mode ConvBlock forward on (2, 32, 6, 1): the port's
        running statistics equal flax's within 1e-6; torch's own BatchNorm
        update misses by n/(n−1) on the variance it adds."""
        x = rng.standard_normal((2, 32, 6, 1)).astype(np.float32)
        block = FlaxConvBlock(32)
        v = host(block.init(jax.random.PRNGKey(1), jnp.asarray(x), train=False))
        with nn.intercept_methods(no_dropout):
            y_flax, mutated = block.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"],
                                          rngs={"dropout": jax.random.PRNGKey(2)})
        want = host(mutated["batch_stats"]["BatchNorm_0"])

        port = ConvBlock(1, 32, drop_rate=0.0)
        with torch.no_grad():
            port.conv.weight.copy_(torch.tensor(v["params"]["Conv_0"]["kernel"].transpose(3, 2, 0, 1)))
        port.train()
        y = port(torch.from_numpy(x).permute(0, 3, 1, 2))
        np.testing.assert_allclose(port.bn.running_mean.numpy(), want["mean"], atol=1e-6, rtol=0)
        np.testing.assert_allclose(port.bn.running_var.numpy(), want["var"], atol=1e-6, rtol=0)
        np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(), np.asarray(y_flax),
                                   atol=1e-5)

        # torch's default running-stats update, on the same conv output
        conv = torch.nn.functional.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                                          port.conv.weight, padding=1)
        bn = torch.nn.BatchNorm2d(32, eps=1e-5, momentum=0.1).train()
        bn(conv)
        n = 2 * 32 * 6
        added_torch = bn.running_var.detach().numpy() - 0.9
        added_flax = want["var"] - 0.9
        np.testing.assert_allclose(added_torch / added_flax, n / (n - 1), rtol=1e-4)
        # ... which puts it outside the 1e-6 bar the port meets, by 10x and more
        assert np.abs(bn.running_var.detach().numpy() - want["var"]).max() > 1e-5

    def test_running_stats_follow_flax_over_steps(self, rng):
        """Three train-mode forwards on inputs of different scale and shape:
        the running statistics, carried from step to step on both sides,
        stay within 1e-6 of flax's (the old part of the variance is no
        longer 1 after the first step)."""
        xs = [(s * rng.standard_normal((2, 16, h, 1)) + s).astype(np.float32)
              for s, h in ((0.5, 6), (2.0, 8), (1.0, 4))]
        block = FlaxConvBlock(16)
        v = host(block.init(jax.random.PRNGKey(3), jnp.asarray(xs[0]), train=False))
        port = ConvBlock(1, 16, drop_rate=0.0)
        with torch.no_grad():
            port.conv.weight.copy_(torch.tensor(v["params"]["Conv_0"]["kernel"].transpose(3, 2, 0, 1)))
        port.train()
        for x in xs:
            with nn.intercept_methods(no_dropout):
                _, mutated = block.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"],
                                         rngs={"dropout": jax.random.PRNGKey(4)})
            v = {**v, "batch_stats": host(mutated["batch_stats"])}
            port(torch.from_numpy(x).permute(0, 3, 1, 2))
        want = v["batch_stats"]["BatchNorm_0"]
        np.testing.assert_allclose(port.bn.running_mean.numpy(), want["mean"], atol=1e-6, rtol=0)
        np.testing.assert_allclose(port.bn.running_var.numpy(), want["var"], atol=1e-6, rtol=0)
        assert int(port.bn.num_batches_tracked) == 3

    def test_dropout_masks_per_channel_like_flax(self):
        """Block dropout keeps one mask per (sample, channel), as flax's
        broadcast_dims=(1, 2); the head's is per unit. Same keep rate and
        survivor scale on both sides."""
        p, shape = 0.2, (64, 32, 8, 8)  # NCHW
        x = torch.ones(shape)
        got = dropout(x, p, torch.Generator().manual_seed(0), per_channel=True)
        want = np.asarray(nn.Dropout(p, broadcast_dims=(1, 2), deterministic=False).apply(
            {}, jnp.ones((64, 8, 8, 32)), rngs={"dropout": jax.random.PRNGKey(0)}))
        for y, spatial in ((got.numpy(), (2, 3)), (want, (1, 2))):
            assert (y.min(axis=spatial) == y.max(axis=spatial)).all()  # constant over H, W
            assert set(np.unique(y)) <= {0.0, np.float32(1 / (1 - p))}
            frac = float((y == 0).mean())
            assert abs(frac - p) < 4 * np.sqrt(p * (1 - p) / (64 * 32))
        head = dropout(torch.ones(64, 128), 0.3, torch.Generator().manual_seed(1))
        assert 0 < float((head == 0).float().mean()) < 1
        assert not (head.min(dim=1).values == head.max(dim=1).values).all()


# --- the pieces --------------------------------------------------------------

def test_weighted_cross_entropy_matches_jax(rng):
    logits = rng.standard_normal((10, 4)).astype(np.float32) * 3
    labels = rng.integers(0, 4, 10).astype(np.int32)
    mask = np.ones(10, np.float32)
    mask[7:] = 0.0
    want = [float(v) for v in jax_dp.weighted_cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(CW), jnp.asarray(mask))]
    got = [float(v) for v in port_dp.weighted_cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(labels), torch.from_numpy(CW),
        torch.from_numpy(mask))]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # and it is torch.nn.CrossEntropyLoss(weight=w) on the unmasked rows
    ref = torch.nn.functional.cross_entropy(torch.from_numpy(logits[:7]),
                                            torch.from_numpy(labels[:7]).long(),
                                            weight=torch.from_numpy(CW))
    np.testing.assert_allclose(got[0] / got[1], float(ref), rtol=1e-6)


@pytest.mark.parametrize("scale", [0.01, 10.0])  # below and above max_norm
def test_clip_by_global_norm_matches_jax(rng, scale):
    grads = [(scale * rng.standard_normal(s)).astype(np.float32) for s in ((3, 4), (5,), (2, 2, 2))]
    want, want_norm = jax_dp.clip_by_global_norm([jnp.asarray(g) for g in grads], 1.0)
    got = [torch.from_numpy(g.copy()) for g in grads]
    norm = port_dp.clip_by_global_norm(got, 1.0)
    np.testing.assert_allclose(float(norm), float(want_norm), rtol=1e-6)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", ["adam", "adamw", "sgd"])
def test_optimizer_matches_optax_and_state_round_trips(flax_vars, rng, name):
    """Five steps with weight decay equal the optax chain within 1e-6, and
    the optimizer state crosses between torch and optax exactly."""
    wd, lr = 1e-4, 3e-3
    tx = jax_optimizer(name, wd)
    params = flax_vars["params"]
    state = tx.init(params)
    model = LightweightCNN()
    model.load_state_dict(state_dict_from_flax(flax_vars))
    opt = build_optimizer(name, model.parameters(), wd)
    assert [n for n, _ in model.named_parameters()] == list(PARAM_NAMES)
    # before any step: optax's init
    assert_trees_close(optax_from_opt_state(opt, name), host(serialization.to_state_dict(state)),
                       rtol=0, atol=0)
    for _ in range(5):
        grads = jax.tree_util.tree_map(
            lambda p: (0.1 * rng.standard_normal(p.shape)).astype(np.float32), params)
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, jax.tree_util.tree_map(lambda u: -lr * u, updates))
        for p, (n, g) in zip(model.parameters(), params_from_flax(grads).items()):
            p.grad = g
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
    got = flax_from_state_dict(model.state_dict())["params"]
    assert_trees_close(got, host(params), rtol=1e-6, atol=1e-6)

    want_state = host(serialization.to_state_dict(state))
    assert_trees_close(optax_from_opt_state(opt, name), want_state, rtol=1e-6, atol=1e-6)
    # optax -> torch -> optax is exact
    fresh = build_optimizer(name, model.parameters(), wd)
    fresh.load_state_dict({"state": opt_state_from_optax(want_state, list(model.named_parameters()),
                                                         name),
                           "param_groups": fresh.state_dict()["param_groups"]})
    assert_trees_close(optax_from_opt_state(fresh, name), want_state, rtol=0, atol=0)


# --- the whole step ----------------------------------------------------------

def _jax_draws(key, a, b, length, num_frames):
    """The JAX step's per-microbatch augmentation draws (one device):
    fold_in(key, 0) -> split per microbatch -> (k_aug, k_drop)."""
    mb_keys = jax.random.split(jax.random.fold_in(key, 0), a)
    return [jax_augment_draws(jax.random.split(k)[0], b, length, 32, num_frames)
            for k in mb_keys]


def _run_steps(flax_vars, rng, mode, groups, optimizer, lr, augment):
    """One optimizer step of each package over `groups` microbatches of 8
    (accum_steps 2, so 1 is a tail group), fp32, from the same weights."""
    a, b = groups, 8
    jfe = jax_mel.MelFrontend(backend="xla", **SMALL_FE)
    pfe = port_mel.MelFrontend(**SMALL_FE)
    length = pfe.target_length
    wavs = (0.3 * rng.standard_normal((a, b, length))).astype(np.float32)
    labels = rng.integers(0, 4, (a, b)).astype(np.int32)
    key = jax.random.PRNGKey(3)
    wd = 1e-4

    tx = jax_optimizer(optimizer, wd)
    steps = jax_dp.make_step_fns(FlaxCNN(num_classes=4), jfe, tx, get_mesh(num_devices=1),
                                 accum_steps=2, augment=augment, accum_mode=mode)
    copy = lambda t: jax.tree_util.tree_map(jnp.array, t)  # noqa: E731 (donated args)
    with nn.intercept_methods(no_dropout):
        p, bs, st, m = steps.train_step(copy(flax_vars["params"]), copy(flax_vars["batch_stats"]),
                                        tx.init(copy(flax_vars["params"])), wavs, labels, CW,
                                        np.float32(lr), key)

    model = LightweightCNN()
    model.load_state_dict(state_dict_from_flax(flax_vars))
    model.set_dropout(0.0)
    opt = build_optimizer(optimizer, model.parameters(), wd)
    port = port_dp.make_step_fns(model, pfe, opt, accum_steps=2, augment=augment, accum_mode=mode)
    got = port.train_step(torch.from_numpy(wavs), torch.from_numpy(labels).long(),
                          torch.from_numpy(CW), lr,
                          draws=_jax_draws(key, a, b, length, pfe.num_frames) if augment else None)

    np.testing.assert_allclose(float(got["loss"]), float(m["loss"]), rtol=1e-5)
    assert float(got["correct"]) == float(m["correct"])
    assert float(got["count"]) == float(m["count"]) == a * b
    v = flax_from_state_dict(model.state_dict())
    assert_trees_close(v["batch_stats"], host(bs), rtol=1e-4, atol=1e-6)
    return got, m, v["params"], host(p), optax_from_opt_state(opt, optimizer), host(
        serialization.to_state_dict(st))


@pytest.mark.parametrize("mode, groups", [("scan", 2), ("parallel", 2), ("parallel", 1),
                                          ("scan", 1)])
def test_train_step_matches_jax(flax_vars, rng, mode, groups):
    """The whole step against the JAX step: loss rtol 1e-5, BN statistics
    rtol 1e-4 / atol 1e-6, updated params rtol 2e-3 / atol 2e-5 (the JAX
    package's own scan-vs-parallel bars, tests/test_training.py:711-725).

    The optimizer here is SGD (momentum 0.9, L2 1e-4) at lr 1, so the
    parameter change is the accumulated, clipped gradient itself and the
    params bar checks it element by element. Adam's first step moves each
    parameter by about lr·sign(g), which turns float noise in gradients
    near zero into whole steps (a few of the 1,012,068 elements per run);
    Adam itself is held to optax separately (test_optimizer_matches_optax)."""
    got, m, params, want, _, _ = _run_steps(flax_vars, rng, mode, groups, "sgd", 1.0,
                                            augment=False)
    np.testing.assert_allclose(float(got["grad_norm"]), float(m["grad_norm"]), rtol=1e-5)
    assert_trees_close(params, want, rtol=2e-3, atol=2e-5)


@pytest.mark.parametrize("mode, groups", [("scan", 2), ("parallel", 1)])
def test_augmented_train_step_matches_jax(flax_vars, rng, mode, groups):
    """Augmentation on, the JAX draws injected, the config's Adam: the
    forward side (loss, correct, BN statistics) at the same bars as above.
    The gradient, read from Adam's first moment (0.1·g after one step), to
    2 % per leaf: SpecAugment's masked bands are exactly constant after
    normalize, so the early blocks' max-pool windows there hold near-equal
    values, and the two frameworks' conv rounding (~4e-5) breaks those ties
    at different positions. Both are valid subgradients; they differ by
    ~0.5 % in blocks 1-3 and agree to ~1e-5 elsewhere."""
    got, m, _, _, mu, want_mu = _run_steps(flax_vars, rng, mode, groups, "adam", 3e-3,
                                           augment=True)
    np.testing.assert_allclose(float(got["grad_norm"]), float(m["grad_norm"]), rtol=1e-3)
    for a_, b_ in zip(jax.tree_util.tree_leaves(mu), jax.tree_util.tree_leaves(want_mu)):
        a_, b_ = np.asarray(a_, np.float64), np.asarray(b_, np.float64)
        if b_.ndim:  # the moments; count is checked exactly
            assert np.linalg.norm(a_ - b_) <= 2e-2 * np.linalg.norm(b_)
        else:
            assert a_ == b_ == 1


def test_eval_step_with_padded_mask_matches_jax(flax_vars, rng):
    jfe = jax_mel.MelFrontend(backend="xla", **SMALL_FE)
    pfe = port_mel.MelFrontend(**SMALL_FE)
    wavs = (0.3 * rng.standard_normal((5, pfe.target_length))).astype(np.float32)
    labels = rng.integers(0, 4, 5).astype(np.int32)
    wavs, labels, mask, real = port_dp.pad_eval_batch(wavs, labels, 8)
    assert real == 5 and mask.tolist() == [1.0] * 5 + [0.0] * 3 and wavs.shape[0] == 8
    tx = jax_optimizer("adam", 0.0)
    steps = jax_dp.make_step_fns(FlaxCNN(num_classes=4), jfe, tx, get_mesh(num_devices=1))
    want = steps.eval_step(flax_vars["params"], flax_vars["batch_stats"], wavs, labels, mask, CW)
    model = LightweightCNN()
    model.load_state_dict(state_dict_from_flax(flax_vars))
    port = port_dp.make_step_fns(model, pfe, build_optimizer("adam", model.parameters()))
    got = port.eval_step(torch.from_numpy(wavs), torch.from_numpy(labels).long(),
                         torch.from_numpy(mask), torch.from_numpy(CW))
    # the real rows; inside its jitted step the JAX package's normalize of
    # a silent pad row is not exactly constant (its logits there are ~1e-3,
    # the port's exactly 0), and the mask drops those rows anyway
    np.testing.assert_allclose(got[0].numpy()[:real], np.asarray(want[0])[:real], atol=1e-4)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5)


def test_bf16_step_is_finite_and_keeps_f32_state(rng):
    pfe = port_mel.MelFrontend(**SMALL_FE)
    model = LightweightCNN(dtype=torch.bfloat16, generator=torch.Generator().manual_seed(0))
    opt = build_optimizer("adam", model.parameters(), 1e-4)
    port = port_dp.make_step_fns(model, pfe, opt, accum_steps=2, augment=True)
    wavs = torch.from_numpy((0.3 * rng.standard_normal((2, 4, pfe.target_length))).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 4, (2, 4))).long()
    m = port.train_step(wavs, labels, torch.from_numpy(CW), 3e-3,
                        generator=torch.Generator().manual_seed(1))
    assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"]))
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(s["exp_avg"].dtype == torch.float32 for s in opt.state.values())


def test_step_draws_from_the_generator(rng):
    """Without injected draws the step draws augmentation and dropout from
    its generator: the same seed repeats the step, another seed does not."""
    pfe = port_mel.MelFrontend(**SMALL_FE)
    wavs = torch.from_numpy((0.3 * rng.standard_normal((2, 4, pfe.target_length))).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 4, (2, 4))).long()

    def loss(seed):
        model = LightweightCNN(generator=torch.Generator().manual_seed(0))
        port = port_dp.make_step_fns(model, pfe, build_optimizer("adam", model.parameters()),
                                     accum_steps=2, augment=True)
        return float(port.train_step(wavs, labels, torch.from_numpy(CW), 1e-3,
                                     generator=torch.Generator().manual_seed(seed))["loss"])

    assert loss(5) == loss(5) != loss(6)
