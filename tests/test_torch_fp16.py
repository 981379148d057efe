"""The fp16 loss-scale mode (`training.precision: fp16`) against the JAX
package's `train_shard_scaled`, on the CPU.

The port's scaled step (`make_step_fns(..., dynamic_loss_scale=True)`) and
the JAX one run from the same flax weights on the same inputs (dropout
inert, accumulation 2): a clean step, a NaN-injected step that both skip,
the scale's growth at 2,000 clean steps and its floor at 1.0, an fp16
model's clean and overflowing steps, and the skip taken together by two
gloo ranks when only one rank's rows are bad. Then the trainers: the
checkpoint's `scale_state` resumes exactly from either package's file, and
the LegacyTrainer trains and resumes in fp16, as
tests/test_trainer_e2e.py:488-510 holds the JAX one.
"""

from pathlib import Path

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_classification_icbhi_tpu.data.dataset import ICBHIDataset as JaxDataset
from audio_classification_icbhi_tpu.models import LightweightCNN as FlaxCNN
from audio_classification_icbhi_tpu.models import build_model as jax_build_model
from audio_classification_icbhi_tpu.ops import mel as jax_mel
from audio_classification_icbhi_tpu.parallel import data_parallel as jax_dp
from audio_classification_icbhi_tpu.parallel.mesh import get_mesh as jax_mesh
from audio_classification_icbhi_tpu.training import trainer as jax_trainer_mod
from audio_classification_icbhi_tpu.training.optimizers import build_optimizer as jax_optimizer
from audio_classification_icbhi_tpu_torch.data.dataset import ICBHIDataset
from audio_classification_icbhi_tpu_torch.data.synthetic import generate_icbhi_dataset
from audio_classification_icbhi_tpu_torch.models import LightweightCNN, build_model
from audio_classification_icbhi_tpu_torch.models.weights import (
    flax_from_state_dict,
    state_dict_from_flax,
)
from audio_classification_icbhi_tpu_torch.ops import mel as port_mel
from audio_classification_icbhi_tpu_torch.parallel import data_parallel as port_dp
from audio_classification_icbhi_tpu_torch.parallel.mesh import local_batch_slice
from audio_classification_icbhi_tpu_torch.step_floor import step_floor, step_margins
from audio_classification_icbhi_tpu_torch.training.optimizers import build_optimizer
from audio_classification_icbhi_tpu_torch.training.trainer import Trainer
from audio_classification_icbhi_tpu_torch.training.trainer_legacy import LegacyTrainer
from audio_classification_icbhi_tpu_torch.utils.config import load_config
from test_torch_data_parallel import join, leaves, run_ranks
from test_torch_train_step import SMALL_FE, no_dropout

REPO = Path(__file__).resolve().parent.parent
CW = np.asarray([0.5, 2.0, 1.0, 1.5], np.float32)
A, B = 2, 8
START = (np.float32(65536.0), np.int32(0))  # torch GradScaler's defaults
DTYPES = {"fp32": (torch.float32, jnp.float32), "fp16": (torch.float16, jnp.float16)}


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(5)
    pfe = port_mel.MelFrontend(**SMALL_FE)
    v = jax.tree_util.tree_map(np.asarray, FlaxCNN(num_classes=4).init(
        jax.random.PRNGKey(0), jnp.zeros((2, 32, pfe.num_frames, 1)), train=False))
    wavs = (0.3 * rng.standard_normal((A, B, pfe.target_length))).astype(np.float32)
    bad = wavs.copy()
    bad[1, 6, 100] = np.nan  # a row of the second half: rank 1's of 2
    return dict(v=v, sd=state_dict_from_flax(v), wavs=wavs, bad=bad,
                labels=rng.integers(0, 4, (A, B)).astype(np.int32))


def port_scaled(sd: dict, optimizer: str, precision: str = "fp32", mesh=None, frontend=None):
    model = LightweightCNN(dtype=DTYPES[precision][0],
                           axis_name=mesh.group if mesh is not None else None)
    model.load_state_dict(sd)
    model.set_dropout(0.0)
    opt = build_optimizer(optimizer, model.named_parameters())
    fns = port_dp.make_step_fns(model, frontend or port_mel.MelFrontend(**SMALL_FE), opt,
                                accum_steps=A, mesh=mesh, dynamic_loss_scale=True)

    def step(wavs, labels, lr, scale_state):
        rows = local_batch_slice(wavs.shape[1], mesh)
        m, ss = fns.train_step(torch.from_numpy(wavs[:, rows]),
                               torch.from_numpy(labels[:, rows]).long(), torch.from_numpy(CW),
                               lr, scale_state=scale_state)
        return {k: float(x) for k, x in m.items()}, ss

    return model, opt, step


class JaxScaled:
    """The JAX package's scaled step on n devices, its state carried."""

    def __init__(self, v, optimizer: str, precision: str = "fp32", n: int = 1):
        self.tx = jax_optimizer(optimizer, 0.0)
        axis = "data" if n > 1 else None
        self.steps = jax_dp.make_step_fns(
            FlaxCNN(num_classes=4, dtype=DTYPES[precision][1], axis_name=axis),
            jax_mel.MelFrontend(backend="xla", **SMALL_FE), self.tx, jax_mesh(num_devices=n),
            accum_steps=A, dynamic_loss_scale=True, accum_mode="scan")
        copy = lambda t: jax.tree_util.tree_map(jnp.array, t)  # noqa: E731 (donated args)
        self.state = (copy(v["params"]), copy(v["batch_stats"]), self.tx.init(copy(v["params"])))

    def step(self, wavs, labels, lr, scale_state):
        with nn.intercept_methods(no_dropout):
            p, bs, opt, m, ss = self.steps.train_step(*self.state, wavs, labels, CW,
                                                      np.float32(lr), jax.random.PRNGKey(3),
                                                      scale_state)
        self.state = (p, bs, opt)
        return {k: float(x) for k, x in m.items()}, (np.float32(ss[0]), np.int32(ss[1]))

    def host(self, i: int):
        return jax.tree_util.tree_map(np.asarray, self.state[i])


def model_snapshot(model, opt) -> list[np.ndarray]:
    return ([t.detach().clone().numpy() for t in model.parameters()]
            + [t.clone().numpy() for st in opt.state.values() for t in st.values()])


def bn_stats(model) -> list[np.ndarray]:
    return [b.clone().numpy() for n, b in model.named_buffers() if "running" in n]


def test_clean_scaled_step_matches_jax(inputs):
    """SGD at lr 1 under the scale 65,536: loss rtol 1e-5, params and grad
    norm by `step_floor` (the port's scaled step under front ends 1e-5 dB
    off), and the same next scale state (65,536, 1)."""
    want_m, want_ss = (jx := JaxScaled(inputs["v"], "sgd")).step(
        inputs["wavs"], inputs["labels"], 1.0, START)

    def run(frontend=None):
        model, _, step = port_scaled(inputs["sd"], "sgd", frontend=frontend)
        m, ss = step(inputs["wavs"], inputs["labels"], 1.0, START)
        return (leaves(flax_from_state_dict(model.state_dict())["params"]), m["grad_norm"]), m, ss

    got, m, ss = run()
    np.testing.assert_allclose(m["loss"], want_m["loss"], rtol=1e-5)
    assert ss == want_ss == (65536.0, 1)
    assert m["step_skipped"] == want_m["step_skipped"] == 0.0
    assert m["loss_scale"] == want_m["loss_scale"] == 65536.0
    floor = step_floor(lambda fe: run(fe)[0], port_mel.MelFrontend(**SMALL_FE), got)
    margins = step_margins(got, (leaves(jx.host(0)), want_m["grad_norm"]), floor)
    print(f"scaled sgd step: {margins}")  # shown with -s
    assert margins.ok, margins


def test_nan_step_is_skipped_like_jax(inputs):
    """Adam, a clean step then one with a NaN in one clip: both packages
    skip it (grad_norm inf, step_skipped 1), the scale halves and the count
    resets; the port's parameters and Adam state stay bit for bit, while
    its BN running statistics take the skipped forward's (NaN here), as
    the JAX step's do."""
    jx = JaxScaled(inputs["v"], "adam")
    model, opt, step = port_scaled(inputs["sd"], "adam")
    want1, wss = jx.step(inputs["wavs"], inputs["labels"], 1e-3, START)
    got1, ss = step(inputs["wavs"], inputs["labels"], 1e-3, START)
    np.testing.assert_allclose(got1["loss"], want1["loss"], rtol=1e-5)
    before, stats = model_snapshot(model, opt), bn_stats(model)
    want2, wss = jx.step(inputs["bad"], inputs["labels"], 1e-3, wss)
    got2, ss = step(inputs["bad"], inputs["labels"], 1e-3, ss)
    assert got2["step_skipped"] == want2["step_skipped"] == 1.0
    assert got2["grad_norm"] == want2["grad_norm"] == float("inf")
    assert ss == wss == (32768.0, 0) and got2["loss_scale"] == want2["loss_scale"] == 32768.0
    for a_, b_ in zip(model_snapshot(model, opt), before):
        np.testing.assert_array_equal(a_, b_)
    after = bn_stats(model)
    assert all(not np.array_equal(a_, b_, equal_nan=True) for a_, b_ in zip(after, stats))
    got_bs = flax_from_state_dict(model.state_dict())["batch_stats"]
    for a_, b_ in zip(leaves(got_bs), leaves(jx.host(1))):
        np.testing.assert_array_equal(np.isnan(a_), np.isnan(b_))


@pytest.mark.parametrize("scale, good, clean, want", [
    (1024.0, 1998, True, (1024.0, 1999)),
    (1024.0, 1999, True, (2048.0, 0)),  # growth after 2,000 clean steps
    (1.0, 5, False, (1.0, 0)),          # the floor: never below 1.0
    (1.5, 5, False, (1.0, 0)),
    (3.0, 5, False, (1.5, 0)),
])
def test_scale_state_update_matches_jax(inputs, scale, good, clean, want):
    """The scale state after one step from (scale, good), clean or with a
    NaN clip, in both packages. torch's GradScaler would halve 1.0 to 0.5."""
    wavs = inputs["wavs"] if clean else inputs["bad"]
    state = (np.float32(scale), np.int32(good))
    *_, step = port_scaled(inputs["sd"], "adam")
    got, ss = step(wavs, inputs["labels"], 1e-3, state)
    want_m, wss = JaxScaled(inputs["v"], "adam").step(wavs, inputs["labels"], 1e-3, state)
    assert ss == wss == want
    assert isinstance(ss[0], np.float32) and isinstance(ss[1], np.int32)
    assert got["loss_scale"] == want_m["loss_scale"] == want[0]
    assert got["step_skipped"] == want_m["step_skipped"] == (0.0 if clean else 1.0)


def test_fp16_model_step_and_overflow_match_jax(inputs):
    """The fp16 model (convs and dense layers in fp16, BatchNorm in f32):
    a clean step at 65,536 (loss within 2e-3, the two packages' fp16
    rounding apart), then a step at 2^24, whose cotangent overflows fp16 in
    the backward: both skip, the parameters stay, and the BN statistics take
    the clean forward's, finite and within fp16 rounding of the JAX ones.
    SGD: Adam's first step, ±lr wherever a gradient is near 0, would turn
    the packages' fp16 rounding into whole steps."""
    jx = JaxScaled(inputs["v"], "sgd", "fp16")
    model, opt, step = port_scaled(inputs["sd"], "sgd", "fp16")
    want1, wss = jx.step(inputs["wavs"], inputs["labels"], 1e-2, START)
    got1, ss = step(inputs["wavs"], inputs["labels"], 1e-2, START)
    assert got1["step_skipped"] == want1["step_skipped"] == 0.0 and ss == wss
    np.testing.assert_allclose(got1["loss"], want1["loss"], rtol=2e-3)
    np.testing.assert_allclose(got1["grad_norm"], want1["grad_norm"], rtol=2e-2)
    before = model_snapshot(model, opt)
    huge = (np.float32(2.0 ** 24), np.int32(4))
    want2, wss = jx.step(inputs["wavs"], inputs["labels"], 1e-2, huge)
    got2, ss = step(inputs["wavs"], inputs["labels"], 1e-2, huge)
    assert got2["step_skipped"] == want2["step_skipped"] == 1.0
    assert ss == wss == (2.0 ** 23, 0)
    for a_, b_ in zip(model_snapshot(model, opt), before):
        np.testing.assert_array_equal(a_, b_)
    got_bs = leaves(flax_from_state_dict(model.state_dict())["batch_stats"])
    assert all(np.isfinite(x).all() for x in got_bs)
    for a_, b_ in zip(got_bs, leaves(jx.host(1))):
        np.testing.assert_allclose(a_, b_, rtol=1e-2, atol=1e-3)


def scaled_rank(rank, n, port, payload, out):
    """Two ranks: a clean scaled step, then one where only rank 1's rows
    hold a NaN."""
    mesh = join(rank, n, port)
    p = torch.load(payload, weights_only=False)
    model, opt, step = port_scaled(p["sd"], "adam", mesh=mesh)
    m1, ss = step(p["wavs"], p["labels"], 1e-3, START)
    before = model_snapshot(model, opt)
    m2, ss = step(p["bad"], p["labels"], 1e-3, ss)
    torch.save(dict(m1=m1, m2=m2, ss=ss, before=before, after=model_snapshot(model, opt)),
               Path(out) / f"rank{rank}.pt")


def test_two_ranks_skip_together(inputs, tmp_path):
    """Only rank 1's rows hold the NaN, yet both ranks skip: the finite
    check reads the all-reduced gradients. Against the JAX 2-device scaled
    step on the same global batches."""
    torch.save(dict(sd=inputs["sd"], wavs=inputs["wavs"], bad=inputs["bad"],
                    labels=inputs["labels"]), tmp_path / "payload.pt")
    run_ranks(2, "test_torch_fp16:scaled_rank", tmp_path / "payload.pt", tmp_path)
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2)]
    jx = JaxScaled(inputs["v"], "adam", n=2)
    want1, wss = jx.step(inputs["wavs"], inputs["labels"], 1e-3, START)
    want2, wss = jx.step(inputs["bad"], inputs["labels"], 1e-3, wss)
    assert want2["step_skipped"] == 1.0
    for r in ranks:
        np.testing.assert_allclose(r["m1"]["loss"], want1["loss"], rtol=1e-5)
        assert r["m1"]["step_skipped"] == 0.0 and r["m2"]["step_skipped"] == 1.0
        assert r["ss"] == wss == (32768.0, 0)
        for a_, b_ in zip(r["after"], r["before"]):
            np.testing.assert_array_equal(a_, b_)
    for a_, b_ in zip(ranks[0]["after"], ranks[1]["after"]):
        np.testing.assert_array_equal(a_, b_)


# --- the trainers ---------------------------------------------------------------

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return generate_icbhi_dataset(tmp_path_factory.mktemp("fp16"), num_recordings=12, seed=0)


def fp16_config(tmp: Path, name: str) -> dict:
    config = load_config(str(REPO / "config.yaml"))
    config["data"].update(duration=1.0, augmentation=False)
    config["training"].update(batch_size=4, gradient_accumulation_steps=2, epochs=1,
                              precision="fp16", save_every=1, async_checkpoint=False,
                              checkpoint_dir=str(tmp / name / "ckpt"),
                              log_dir=str(tmp / name / "runs"))
    return config


def port_trainer(cls, config, corpus):
    return cls(build_model(config), ICBHIDataset(corpus, "train", config),
               ICBHIDataset(corpus, "val", config), config, device="cpu")


def jax_trainer(config, corpus):
    return jax_trainer_mod.Trainer(jax_build_model(config), JaxDataset(corpus, "train", config),
                                   JaxDataset(corpus, "val", config), config,
                                   mesh=jax_mesh(num_devices=1))


def test_fp16_scale_state_resumes_across_trainers(corpus, tmp_path):
    """precision: fp16 no longer raises. A port checkpoint's scale_state
    (a float64 pair) resumes in the JAX trainer and a JAX one in the port,
    with the weights and the optimizer state; the resumed port trains on."""
    config = fp16_config(tmp_path, "port")
    port = port_trainer(Trainer, config, corpus)
    assert port.dynamic_loss_scale and port.model.dtype == torch.float16
    port.scale_state = (np.float32(512.0), np.int32(7))
    port.save_checkpoint(tmp_path / "port.ckpt", 0, 1.0)
    jt = jax_trainer(fp16_config(tmp_path, "jax"), corpus)
    assert jt.dynamic_loss_scale
    jt.restore(tmp_path / "port.ckpt")
    assert (float(jt.scale_state[0]), int(jt.scale_state[1])) == (512.0, 7)
    want = flax_from_state_dict(port.model.state_dict())
    for a_, b_ in zip(leaves(jt.params), leaves(want["params"])):
        np.testing.assert_array_equal(a_, b_)

    jt.scale_state = (np.float32(256.0), np.int32(3))
    jt.save_checkpoint(tmp_path / "jax.ckpt", 0, 1.0)
    jt.wait_for_checkpoints(close=True)
    resumed = port_trainer(Trainer, fp16_config(tmp_path, "resumed"), corpus)
    resumed.restore(tmp_path / "jax.ckpt")
    assert resumed.scale_state == (256.0, 3)
    assert isinstance(resumed.scale_state[0], np.float32)
    got = flax_from_state_dict(resumed.model.state_dict())
    for a_, b_ in zip(leaves(got), leaves({"params": jt.params, "batch_stats": jt.batch_stats})):
        np.testing.assert_array_equal(a_, b_)
    loss, _ = resumed.train_epoch(1)
    assert np.isfinite(loss) and resumed.scale_state[1] > 3


def test_fp16_legacy_trainer_and_scale_state_resume(corpus, tmp_path):
    """The LegacyTrainer (uniform class weights, no clipping) inherits the
    fp16 mode: it trains an epoch, and a settled scale resumes exactly, as
    tests/test_trainer_e2e.py::test_fp16_legacy_trainer_and_scale_state_resume
    holds the JAX one."""
    config = fp16_config(tmp_path, "legacy")
    t = port_trainer(LegacyTrainer, config, corpus)
    assert t.dynamic_loss_scale and t._max_grad_norm() == float("inf")
    np.testing.assert_array_equal(t.class_weights.numpy(), np.ones(4, np.float32))
    loss, acc = t.train_epoch(0)
    assert np.isfinite(loss) and 0.0 <= acc <= 100.0
    assert t.scale_state != START  # a clean step counted, or a skipped one halved it
    t.scale_state = (np.float32(512.0), np.int32(7))
    t.save_checkpoint(tmp_path / "fp16.ckpt", 0, 1.0)
    t2 = port_trainer(LegacyTrainer, config, corpus)
    t2.restore(tmp_path / "fp16.ckpt")
    assert t2.scale_state == (512.0, 7)
