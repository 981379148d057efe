"""The port's data-parallel step over gloo ranks, on the CPU.

Each rank is a process started here on 127.0.0.1 (`run_ranks`, with a
timeout per process), joined by `parallel/mesh.init_distributed` and
running its shard of one global batch through the port's sharded step
(`make_step_fns(..., mesh=...)`, cross-rank BatchNorm through
`build_model(..., axis_name=mesh.group)`). Two spawns serve every test of
this file: 2 ranks and 4 ranks. Against them:

- the JAX package's 2- and 4-device `make_step_fns` on the conftest's
  virtual CPU mesh (same flax weights, dropout inert, SGD at lr 1, both
  accumulation modes), held by the port's `step_floor`;
- the port's own 1-rank step on the concatenated batch (real BN: loss
  within 1e-6, BN statistics 1e-5, params rtol 2e-4 / atol 1e-6), the
  params bit-equal across ranks;
- a step whose ranks average their own weighted means, which must fail
  the JAX invariance bar rtol 2e-4 / atol 1e-6 by far (class weights 0.5,
  2, 1, 1.5);
- the cross-rank BatchNorm's gradient against one BatchNorm over the
  concatenated rows;
- the Validator at 2 ranks against 1 rank.
"""

import os
import subprocess
import sys
from pathlib import Path

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_classification_icbhi_tpu.models import LightweightCNN as FlaxCNN
from audio_classification_icbhi_tpu.ops import mel as jax_mel
from audio_classification_icbhi_tpu.parallel import data_parallel as jax_dp
from audio_classification_icbhi_tpu.parallel.mesh import get_mesh as jax_mesh
from audio_classification_icbhi_tpu.training.optimizers import build_optimizer as jax_optimizer
from audio_classification_icbhi_tpu_torch.data.dataset import ICBHIDataset
from audio_classification_icbhi_tpu_torch.data.synthetic import generate_icbhi_dataset
from audio_classification_icbhi_tpu_torch.models import LightweightCNN, build_model
from audio_classification_icbhi_tpu_torch.models.cnn import BatchNorm
from audio_classification_icbhi_tpu_torch.models.weights import (
    flax_from_state_dict,
    state_dict_from_flax,
)
from audio_classification_icbhi_tpu_torch.ops import mel as port_mel
from audio_classification_icbhi_tpu_torch.parallel import data_parallel as port_dp
from audio_classification_icbhi_tpu_torch.parallel.mesh import (
    free_port,
    get_mesh,
    init_distributed,
    local_batch_slice,
)
from audio_classification_icbhi_tpu_torch.step_floor import step_floor, step_margins
from audio_classification_icbhi_tpu_torch.training.optimizers import build_optimizer
from audio_classification_icbhi_tpu_torch.training.validation import Validator
from audio_classification_icbhi_tpu_torch.utils.config import load_config
from test_torch_train_step import SMALL_FE, no_dropout

REPO = Path(__file__).resolve().parent.parent
CW = np.asarray([0.5, 2.0, 1.0, 1.5], np.float32)
A, B = 2, 8  # microbatches of the global batch; B splits over 2 or 4 ranks
MODES = ("scan", "parallel")


def run_ranks(n: int, worker: str, payload: Path, out: Path, timeout: float = 300) -> None:
    """Start n gloo ranks, each `python -c` calling `worker` ("module:function"
    of this directory) with (rank, n, port, payload, out); wait for each
    within `timeout` and kill what is left if one fails."""
    port = free_port()
    code = (f"import sys; sys.path[:0] = [{str(REPO / 'tests')!r}, {str(REPO)!r}]; "
            "import importlib; m, f = sys.argv[1].split(':'); "
            "getattr(importlib.import_module(m), f)(*sys.argv[2:])")
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, "-c", code, worker, str(r), str(n), str(port),
                               str(payload), str(out)], cwd=str(REPO), env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(n)]
    try:
        for r, proc in enumerate(procs):
            log, _ = proc.communicate(timeout=timeout)
            assert proc.returncode == 0, f"rank {r}:\n{log[-4000:]}"
    finally:
        # a rank that died leaves its peers blocked in a collective
        for proc in procs:
            if proc.poll() is None:
                proc.kill()


def join(rank: str, n: str, port: str):
    """A worker's start: its gloo group and mesh, two threads a rank."""
    torch.set_num_threads(2)
    init_distributed(f"127.0.0.1:{port}", int(n), int(rank), device="cpu")
    return get_mesh(device="cpu")


def per_rank_mean_loss(logits, labels, class_weights, mask=None):
    """The faulty loss: the rank's own weighted mean, returned as (mean, 1)
    so that the sharded step's num / Σ_ranks den averages the ranks' means
    (DDP's gradient mean) instead of taking the global ratio."""
    num, den = port_dp_loss(logits, labels, class_weights, mask)
    return num / den, torch.ones(())


port_dp_loss = port_dp.weighted_cross_entropy


def port_step(sd: dict, wavs, labels, mode: str, mesh=None) -> tuple[dict, dict]:
    """One port step (SGD at lr 1, dropout inert, accumulation A) from the
    state_dict `sd` on this rank's rows of (A, B, L) wavs: (metrics as
    floats, the model's flax variables)."""
    model = LightweightCNN(axis_name=mesh.group if mesh is not None else None)
    model.load_state_dict(sd)
    model.set_dropout(0.0)
    fns = port_dp.make_step_fns(model, port_mel.MelFrontend(**SMALL_FE),
                                build_optimizer("sgd", model.named_parameters()),
                                accum_steps=A, accum_mode=mode, mesh=mesh)
    rows = local_batch_slice(wavs.shape[1], mesh)
    m = fns.train_step(torch.from_numpy(wavs[:, rows]), torch.from_numpy(labels[:, rows]).long(),
                       torch.from_numpy(CW), 1.0)
    return {k: float(v) for k, v in m.items()}, flax_from_state_dict(model.state_dict())


def dp_rank(rank, n, port, payload, out):
    """The ranks of this file: the sharded step in both modes, the per-rank
    mean variant (2 ranks), the cross-rank BatchNorm's gradient, and the
    Validator (2 ranks)."""
    mesh = join(rank, n, port)
    p = torch.load(payload, weights_only=False)
    res = {f"step-{mode}": port_step(p["sd"], p["wavs"], p["labels"], mode, mesh)
           for mode in MODES}
    if mesh.world_size == 2:
        port_dp.weighted_cross_entropy = per_rank_mean_loss
        res["faulty"] = port_step(p["sd"], p["wavs"], p["labels"], "scan", mesh)
        port_dp.weighted_cross_entropy = port_dp_loss

    bn = BatchNorm(p["bn_x"].shape[1], group=mesh.group).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(p["bn_weight"]))
        bn.bias.copy_(torch.from_numpy(p["bn_bias"]))
    rows = local_batch_slice(p["bn_x"].shape[0], mesh)
    x = torch.from_numpy(p["bn_x"][rows]).requires_grad_()
    y = bn(x)
    (y * torch.from_numpy(p["bn_cot"][rows])).sum().backward()
    res["bn"] = dict(y=y.detach().numpy(), x_grad=x.grad.numpy(), w_grad=bn.weight.grad.numpy(),
                     b_grad=bn.bias.grad.numpy(), mean=bn.running_mean.numpy(),
                     var=bn.running_var.numpy())

    if "corpus" in p and mesh.world_size == 2:
        model = build_model(p["config"])
        model.load_state_dict(p["val_sd"])
        res["validator"] = Validator(model, ICBHIDataset(p["corpus"], "val", p["config"]),
                                     p["config"], mesh=mesh).validate()
    torch.save(res, Path(out) / f"rank{rank}.pt")


# --- the parent's side -------------------------------------------------------

def leaves(tree) -> list[np.ndarray]:
    return [np.asarray(x, np.float64) for x in jax.tree_util.tree_leaves(tree)]


def validator_config() -> dict:
    config = load_config(str(REPO / "config.yaml"))
    config["data"].update(duration=1.0, augmentation=False)
    config["training"].update(batch_size=5, mixed_precision=False)
    return config


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both spawns, the JAX N-device steps, and the port's 1-rank step with
    its floor."""
    tmp = tmp_path_factory.mktemp("dp")
    rng = np.random.default_rng(11)
    pfe = port_mel.MelFrontend(**SMALL_FE)
    v = jax.tree_util.tree_map(np.asarray, FlaxCNN(num_classes=4).init(
        jax.random.PRNGKey(0), jnp.zeros((2, 32, pfe.num_frames, 1)), train=False))
    wavs = (0.3 * rng.standard_normal((A, B, pfe.target_length))).astype(np.float32)
    labels = rng.integers(0, 4, (A, B)).astype(np.int32)
    config = validator_config()
    val_model = build_model(config, generator=torch.Generator().manual_seed(3))
    val_sd = {k: t * 30.0 if k in ("fc1.weight", "fc2.weight") else t  # the classes spread
              for k, t in val_model.state_dict().items()}
    payload = dict(
        sd=state_dict_from_flax(v), wavs=wavs, labels=labels,
        bn_x=(1.5 * rng.standard_normal((8, 16, 6, 5)) + 0.7).astype(np.float32),
        bn_cot=rng.standard_normal((8, 16, 6, 5)).astype(np.float32),
        bn_weight=(1.0 + 0.3 * rng.standard_normal(16)).astype(np.float32),
        bn_bias=(0.2 * rng.standard_normal(16)).astype(np.float32),
        corpus=str(generate_icbhi_dataset(tmp / "corpus", num_recordings=48, seed=2)),
        config=config, val_sd=val_sd)
    torch.save(payload, tmp / "payload.pt")
    ranks = {}
    for n in (2, 4):
        (tmp / str(n)).mkdir()
        run_ranks(n, "test_torch_data_parallel:dp_rank", tmp / "payload.pt", tmp / str(n))
        ranks[n] = [torch.load(tmp / str(n) / f"rank{r}.pt", weights_only=False)
                    for r in range(n)]

    jfe = jax_mel.MelFrontend(backend="xla", **SMALL_FE)
    tx = jax_optimizer("sgd", 0.0)
    copy = lambda t: jax.tree_util.tree_map(jnp.array, t)  # noqa: E731 (donated args)
    jax_steps = {}
    for n in (2, 4):
        for mode in MODES:
            steps = jax_dp.make_step_fns(FlaxCNN(num_classes=4, axis_name="data"), jfe, tx,
                                         jax_mesh(num_devices=n), accum_steps=A, accum_mode=mode)
            with nn.intercept_methods(no_dropout):
                params, bs, _, m = steps.train_step(
                    copy(v["params"]), copy(v["batch_stats"]), tx.init(copy(v["params"])),
                    wavs, labels, CW, np.float32(1.0), jax.random.PRNGKey(3))
            jax_steps[n, mode] = ((leaves(params), float(m["grad_norm"])),
                                  {k: float(x) for k, x in m.items()},
                                  jax.tree_util.tree_map(np.asarray, bs))

    def one_rank(frontend):
        model = LightweightCNN()
        model.load_state_dict(payload["sd"])
        model.set_dropout(0.0)
        fns = port_dp.make_step_fns(model, frontend, build_optimizer("sgd", model.named_parameters()),
                                    accum_steps=A)
        m = fns.train_step(torch.from_numpy(wavs), torch.from_numpy(labels).long(),
                           torch.from_numpy(CW), 1.0)
        return {k: float(x) for k, x in m.items()}, flax_from_state_dict(model.state_dict())

    m1, v1 = one_rank(pfe)
    base = (leaves(v1["params"]), m1["grad_norm"])
    floor = step_floor(lambda fe: (lambda r: (leaves(r[1]["params"]), r[0]["grad_norm"]))(
        one_rank(fe)), pfe, base)
    return dict(payload=payload, ranks=ranks, jax=jax_steps, one=(m1, v1), base=base,
                floor=floor)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("mode", MODES)
def test_sharded_step_matches_jax(runs, n, mode):
    """The port's n-rank step against the JAX package's n-device step:
    loss rtol 1e-5, correct and count equal, BN statistics rtol 1e-4 /
    atol 1e-6, params and grad norm by `step_floor` (the port's 1-rank step
    under front ends 1e-5 dB off, seeds 0-7)."""
    metrics, got = runs["ranks"][n][0][f"step-{mode}"]
    want, jm, jbs = runs["jax"][n, mode]
    np.testing.assert_allclose(metrics["loss"], jm["loss"], rtol=1e-5)
    assert metrics["correct"] == jm["correct"] and metrics["count"] == jm["count"] == A * B
    for a_, b_ in zip(leaves(got["batch_stats"]), leaves(jbs)):
        np.testing.assert_allclose(a_, b_, rtol=1e-4, atol=1e-6)
    margins = step_margins((leaves(got["params"]), metrics["grad_norm"]), want, runs["floor"])
    print(f"{n} ranks, {mode}: {margins}")  # shown with -s
    assert margins.ok, margins


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_step_equals_one_rank(runs, n):
    """The n-rank step with cross-rank BN is the 1-rank step on the
    concatenated batch: loss within 1e-6, BN statistics within 1e-5, params
    and grad norm within the JAX invariance test's rtol 2e-4 / atol 1e-6;
    and every rank holds the same parameters, bit for bit."""
    m1, v1 = runs["one"]
    for mode in MODES:
        metrics, got = runs["ranks"][n][0][f"step-{mode}"]
        assert abs(metrics["loss"] - m1["loss"]) <= 1e-6
        assert metrics["correct"] == m1["correct"] and metrics["count"] == m1["count"]
        np.testing.assert_allclose(metrics["grad_norm"], m1["grad_norm"], rtol=2e-4, atol=1e-6)
        for a_, b_ in zip(leaves(got["batch_stats"]), leaves(v1["batch_stats"])):
            np.testing.assert_allclose(a_, b_, rtol=0, atol=1e-5)
        worst = max(float(np.max(np.abs(a_ - b_) / (1e-6 + 2e-4 * np.abs(b_))))
                    for a_, b_ in zip(leaves(got["params"]), leaves(v1["params"])))
        print(f"{n} ranks against 1, {mode}: worst |d| over rtol 2e-4 / atol 1e-6 {worst:.3f}")
        for a_, b_ in zip(leaves(got["params"]), leaves(v1["params"])):
            np.testing.assert_allclose(a_, b_, rtol=2e-4, atol=1e-6)
        for other in runs["ranks"][n][1:]:
            for a_, b_ in zip(leaves(got), leaves(other[f"step-{mode}"][1])):
                np.testing.assert_array_equal(a_, b_)


def test_per_rank_mean_loss_fails_the_bound(runs):
    """Averaging the ranks' own weighted means (DDP's mean of per-rank
    losses) in place of the ratio of global sums misses the 1-rank step by
    far more than test_sharded_step_equals_one_rank allows (the JAX
    invariance bar) and than `step_floor`: the ranks' Σ w[y] differ under
    the class weights."""
    metrics, got = runs["ranks"][2][0]["faulty"]
    _, want = runs["one"]
    worst = max(float(np.max(np.abs(a_ - b_) / (1e-6 + 2e-4 * np.abs(b_))))
                for a_, b_ in zip(leaves(got["params"]), leaves(want["params"])))
    margins = step_margins((leaves(got["params"]), metrics["grad_norm"]), runs["base"],
                           runs["floor"])
    print(f"per-rank mean: worst |d| over rtol 2e-4 / atol 1e-6 {worst:.1f}; {margins}")
    assert worst > 10.0 and margins.params > 10.0


@pytest.mark.parametrize("n", [2, 4])
def test_cross_rank_batchnorm_gradient(runs, n):
    """The cross-rank BatchNorm on each rank's rows against one BatchNorm
    on all of them: outputs and running statistics, and the gradients
    (the ranks' weight and bias gradients summed, their input gradients
    concatenated). A backward that did not all-reduce the statistics'
    cotangent, or did it twice, would miss the cross terms or double them."""
    p = runs["payload"]
    bn = BatchNorm(16).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(p["bn_weight"]))
        bn.bias.copy_(torch.from_numpy(p["bn_bias"]))
    x = torch.from_numpy(p["bn_x"]).requires_grad_()
    y = bn(x)
    (y * torch.from_numpy(p["bn_cot"])).sum().backward()
    got = [r["bn"] for r in runs["ranks"][n]]
    tol = dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.concatenate([g["y"] for g in got]), y.detach().numpy(), **tol)
    np.testing.assert_allclose(np.concatenate([g["x_grad"] for g in got]), x.grad.numpy(), **tol)
    np.testing.assert_allclose(sum(g["w_grad"] for g in got), bn.weight.grad.numpy(), **tol)
    np.testing.assert_allclose(sum(g["b_grad"] for g in got), bn.bias.grad.numpy(), **tol)
    np.testing.assert_allclose(got[0]["mean"], bn.running_mean.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[0]["var"], bn.running_var.numpy(), rtol=0, atol=1e-6)


def test_validator_two_ranks_equals_one(runs):
    """Each of 2 ranks returns the (y_true, y_pred, y_prob) of the 1-rank
    Validator over the whole split (batch 5 rounded up to 6 there, the last
    batch padded)."""
    p = runs["payload"]
    model = build_model(p["config"])
    model.load_state_dict(p["val_sd"])
    want = Validator(model, ICBHIDataset(p["corpus"], "val", p["config"]), p["config"],
                     device="cpu").validate()
    assert len(want[0]) % 6 and float(np.ptp(want[2], axis=0).max()) > 1e-2
    for r in runs["ranks"][2]:
        got = r["validator"]
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_allclose(got[2], want[2], rtol=0, atol=1e-6)
