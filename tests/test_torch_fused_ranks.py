"""The fused epoch over ranks (`train_many`, `eval_many` and the trainer's
fused epoch on a process group), on the CPU.

Two gloo spawns serve every case (`test_torch_data_parallel.run_ranks`): 2
ranks and 4 ranks, each holding the whole int16 cache of 44 clips of
seeded PCM16 noise and taking its `local_batch_slice` columns of each
global batch. On the CPU the fused functions run eagerly; the card
captures each step with its NCCL collectives (`chip_smoke.py` phase 26).
Against them:

- the JAX package's `train_many` on the conftest's 2- and 4-device mesh,
  K = 1 from the port's state before each of 3 steps of (A=2, B=8) (the
  flax init, SGD at lr 1, fp32, augmentation off, dropout inert): loss
  rtol 1e-5, correct and count equal, parameters, BatchNorm statistics and
  grad norm by the port's `step_floor`;
- the port's sharded per-step `train_step` with the same rank seeds,
  augmentation and dropout on, Adam: bit for bit;
- the port's 1-rank `train_many` from the same state, each step: the JAX
  invariance bar of `test_sharded_step_equals_one_rank`; the parameters
  bit-equal across ranks;
- the JAX `eval_many` on an N-device mesh over 3 batches of 8 with a tail
  of 5 real rows (30x head): predictions in global order equal, num rtol
  1e-4, den rtol 1e-6, correct equal;
- the `Trainer` over 2 ranks with `cache_on_device`: fused, its history
  equal to the 2-rank per-step run on the cache (augmentation and dropout
  on), to the 1-rank fused run with both inert (the invariance bar; the
  ICBHI trainer's `val_predictions` equal), the fp16 per-step run on the
  cache equal to the fp16 run on the host loader, and every rank's cache
  the same bytes.
"""

import contextlib
import hashlib
import io
from pathlib import Path

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from audio_classification_icbhi_tpu.models import LightweightCNN as FlaxCNN
from audio_classification_icbhi_tpu.ops import mel as jax_mel
from audio_classification_icbhi_tpu.parallel import data_parallel as jax_dp
from audio_classification_icbhi_tpu.parallel.mesh import get_mesh as jax_mesh
from audio_classification_icbhi_tpu.training.optimizers import build_optimizer as jax_optimizer
from audio_classification_icbhi_tpu_torch.data.dataset_segmented import ICBHISegmentedDataset
from audio_classification_icbhi_tpu_torch.data.device_cache import DeviceCachedLoader
from audio_classification_icbhi_tpu_torch.data.synthetic import generate_segmented_dataset
from audio_classification_icbhi_tpu_torch.models import LightweightCNN, build_model
from audio_classification_icbhi_tpu_torch.models.weights import (
    flax_from_state_dict,
    optax_from_opt_state,
    state_dict_from_flax,
)
from audio_classification_icbhi_tpu_torch.ops import mel as port_mel
from audio_classification_icbhi_tpu_torch.parallel.data_parallel import make_step_fns, step_seed
from audio_classification_icbhi_tpu_torch.parallel.mesh import local_batch_slice
from audio_classification_icbhi_tpu_torch.step_floor import step_floor, step_margins
from audio_classification_icbhi_tpu_torch.training.optimizers import build_optimizer
from audio_classification_icbhi_tpu_torch.training.trainer import Trainer
from audio_classification_icbhi_tpu_torch.training.trainer_icbhi import TrainerWithICBHI
from test_torch_data_parallel import join, leaves, run_ranks
from test_torch_device_cache import (
    CW,
    SMALL_FE,
    NoiseClips,
    port_fns,
    port_state,
    step_result,
    tiny_config,
)
from test_torch_train_step import no_dropout

A, B = 2, 8
STEPS = 3
RANK_SEED = 5  # make_step_fns's seed in the rank-seeded comparison
# the trainer runs over 2 ranks: (trainer class, epochs, config changes)
TRAINER_RUNS = {
    "fused": (Trainer, 2, {}, {"steps_per_dispatch": 0}),
    "per_step": (Trainer, 2, {}, {"steps_per_dispatch": 1}),
    "inert": (TrainerWithICBHI, 2, {"augmentation": False}, {"steps_per_dispatch": 0}),
    "fp16_cache": (Trainer, 1, {}, {"precision": "fp16"}),
    "fp16_host": (Trainer, 1, {"cache_on_device": False}, {"precision": "fp16"}),
}


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.numpy().tobytes()).hexdigest()


def run_config(tmp, name: str) -> tuple[type, dict]:
    cls, epochs, data, training = TRAINER_RUNS[name]
    config = tiny_config(tmp, name, epochs=epochs, **training)
    config["data"].update(data)
    return cls, config


def run_trainer(root, tmp, name: str, mesh=None) -> dict:
    """One of TRAINER_RUNS on the segmented corpus at `root`: its history,
    loaders, whether and how it ran fused, its val_predictions and its
    caches' digests."""
    cls, config = run_config(tmp, name)
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        t = cls(build_model(config, axis_name=mesh.group if mesh is not None else None),
                ICBHISegmentedDataset(root, "train", config, augment=True),
                ICBHISegmentedDataset(root, "val", config, augment=False), config,
                device="cpu", mesh=mesh)
        if name == "inert":  # the conv blocks' channel dropout too
            t.model.set_dropout(0.0)
        calls = []
        many = t.steps.train_many
        if many is not None:
            t.steps = t.steps._replace(train_many=lambda *a: (
                calls.append((tuple(np.shape(a[1])), a[6])), many(*a))[1])
        hist = t.train()
    out = {"history": hist, "calls": calls, "val_predictions": t.val_predictions,
           "loaders": [type(t.train_loader).__name__, type(t.val_loader).__name__],
           "fused": (t._use_multi_dispatch(), t._use_fused_eval()), "printed": text.getvalue()}
    if isinstance(t.train_loader, DeviceCachedLoader):
        out["cache"] = (digest(t.train_loader.cache), digest(t.val_loader.cache))
    return out


def ranked_model(sd: dict, mesh, dropout: bool) -> LightweightCNN:
    model = LightweightCNN(axis_name=mesh.group)
    model.load_state_dict(sd)
    if not dropout:
        model.set_dropout(0.0)
    return model


def fused_rank(rank, n, port, payload, out):
    """One rank: the SGD steps through train_many one step a call, Adam
    with augmentation and dropout through train_many and through the
    sharded train_step, eval_many, and (2 ranks) the trainer runs."""
    mesh = join(rank, n, port)
    p = torch.load(payload, weights_only=False)
    pfe = port_mel.MelFrontend(**SMALL_FE)
    own = local_batch_slice(B, mesh)
    loader = DeviceCachedLoader(NoiseClips(44, seed=6), B, device="cpu", columns=own)
    cache, cw = loader.cache, torch.from_numpy(CW)
    idxs, labels = p["idxs"], p["labels"]
    res = {"cache": digest(cache)}

    model = ranked_model(p["sd"], mesh, dropout=False)
    opt = build_optimizer("sgd", model.named_parameters())
    fns = make_step_fns(model, pfe, opt, accum_steps=A, mesh=mesh)
    states, metrics = [port_state(model, opt)], []
    for s in range(STEPS):
        m = fns.train_many(cache, idxs[s:s + 1], labels[s:s + 1], cw, 1.0, 0, s)
        metrics.append({k: x.numpy() for k, x in m.items()})
        states.append(port_state(model, opt))
    res["sgd"] = (metrics, states)

    def adam():
        model = ranked_model(p["sd"], mesh, dropout=True)
        return model, make_step_fns(model, pfe, build_optimizer("adam", model.named_parameters()),
                                    accum_steps=A, augment=True, mesh=mesh, seed=RANK_SEED)

    model, fns = adam()
    m = fns.train_many(cache, idxs, labels, cw, 1e-3, 2, 0)
    res["adam_fused"] = ({k: x.numpy() for k, x in m.items()},
                         leaves(flax_from_state_dict(model.state_dict())))
    model, fns = adam()
    steps = []
    for s in range(STEPS):
        g = torch.Generator().manual_seed(step_seed(RANK_SEED, 2, s, mesh.rank))
        steps.append(fns.train_step(loader.gather(idxs[s][:, own]),
                                    torch.from_numpy(labels[s][:, own]).long(), cw, 1e-3,
                                    generator=g))
    res["adam_steps"] = ({k: torch.stack([st[k] for st in steps]).numpy() for k in steps[0]},
                         leaves(flax_from_state_dict(model.state_dict())))

    ev = ranked_model(p["ev_sd"], mesh, dropout=True)
    fns = make_step_fns(ev, pfe, build_optimizer("adam", ev.parameters()), mesh=mesh)
    res["eval"] = [x.numpy() for x in fns.eval_many(cache, p["eidx"], p["elab"], p["emask"], cw)]

    if mesh.world_size == 2:
        res["trainer"] = {name: run_trainer(p["root"], p["tmp"] / f"rank{rank}", name, mesh)
                          for name in TRAINER_RUNS}
    torch.save(res, Path(out) / f"rank{rank}.pt")


# --- the parent's side -------------------------------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both spawns; the JAX N-device train_many (K = 1, from the port's
    state before each step) and eval_many; the port's 1-rank train_many
    from the same states with its `step_floor`; the 1-rank ICBHI trainer."""
    tmp = tmp_path_factory.mktemp("fused_ranks")
    root = generate_segmented_dataset(tmp / "seg", per_class=16, duration=0.8, sample_rate=4000)
    pfe = port_mel.MelFrontend(**SMALL_FE)
    v = jax.tree_util.tree_map(np.asarray, FlaxCNN(num_classes=4).init(
        jax.random.PRNGKey(0), jnp.zeros((2, 32, pfe.num_frames, 1)), train=False))
    clips = NoiseClips(44, seed=6)
    rng = np.random.default_rng(4)
    idxs = np.stack([rng.permutation(44)[:A * B].reshape(A, B) for _ in range(STEPS)])
    labels = clips.labels[idxs]
    config = tiny_config(tmp, "ev")
    ev_model = build_model(config, generator=torch.Generator().manual_seed(3))
    ev_sd = {k: t * 30.0 if k in ("fc1.weight", "fc2.weight") else t  # the classes spread
             for k, t in ev_model.state_dict().items()}
    eidx = np.stack([rng.permutation(44)[:B] for _ in range(3)])
    emask = np.ones((3, B), np.float32)
    emask[2, 5:] = 0.0
    eidx[2, 5:] = 0
    payload = dict(sd=state_dict_from_flax(v), idxs=idxs.astype(np.int32), labels=labels,
                   ev_sd=ev_sd, eidx=eidx, elab=clips.labels[eidx], emask=emask, root=root,
                   tmp=tmp)
    torch.save(payload, tmp / "payload.pt")
    ranks = {}
    for n in (2, 4):
        (tmp / str(n)).mkdir()
        run_ranks(n, "test_torch_fused_ranks:fused_rank", tmp / "payload.pt", tmp / str(n))
        ranks[n] = [torch.load(tmp / str(n) / f"rank{r}.pt", weights_only=False)
                    for r in range(n)]

    cache = DeviceCachedLoader(clips, B, device="cpu").cache
    jcache = jnp.asarray(cache.numpy())
    jfe = jax_mel.MelFrontend(backend="xla", **SMALL_FE)
    tx = jax_optimizer("sgd", 0.0)
    out = {"ranks": ranks, "jax": {}, "one": {}, "floor": {}, "jax_eval": {}}
    for n in (2, 4):
        jsteps = jax_dp.make_step_fns(FlaxCNN(num_classes=4, axis_name="data"), jfe, tx,
                                      jax_mesh(num_devices=n), accum_steps=A)
        states = ranks[n][0]["sgd"][1]
        for s in range(STEPS):
            model, opt, _ = port_fns(states[s], pfe)
            jv = flax_from_state_dict(model.state_dict())
            jopt = serialization.from_state_dict(tx.init(jv["params"]),
                                                 optax_from_opt_state(opt, "sgd"))
            with nn.intercept_methods(no_dropout):
                jp, jbs, _, jm = jsteps.train_many(
                    jax.tree_util.tree_map(jnp.asarray, jv["params"]),
                    jax.tree_util.tree_map(jnp.asarray, jv["batch_stats"]), jopt, jcache,
                    idxs[s:s + 1].astype(np.int32), labels[s:s + 1], CW, np.float32(1.0),
                    jax.random.PRNGKey(3), np.int32(s))
            jm = {k: np.asarray(x) for k, x in jm.items()}
            out["jax"][n, s] = (jm, (leaves(jp) + leaves(jbs) + [jm["loss"]],
                                     float(jm["grad_norm"][-1])))

            def rerun(frontend, state=states[s], s=s):
                m_, _, f_ = port_fns(state, frontend)
                got = f_.train_many(cache, idxs[s:s + 1], labels[s:s + 1],
                                    torch.from_numpy(CW), 1.0, 0, s)
                return step_result(got, m_), {k: x.numpy() for k, x in got.items()}, m_

            base, m1, model1 = rerun(pfe)
            out["one"][n, s] = (m1, flax_from_state_dict(model1.state_dict()))
            out["floor"][n, s] = step_floor(lambda fe: rerun(fe)[0], pfe, base)
        ev = flax_from_state_dict(ev_sd)
        out["jax_eval"][n] = [np.asarray(x) for x in jsteps.eval_many(
            ev["params"], ev["batch_stats"], jcache, eidx.astype(np.int32),
            clips.labels[eidx], emask, CW)]
    out["trainer_one"] = run_trainer(root, tmp / "one", "inert")
    return out


def after_step(state) -> dict:
    """The flax variables of a saved (state_dict, optimizer state)."""
    return flax_from_state_dict(state[0])


@pytest.mark.parametrize("step", range(STEPS))
@pytest.mark.parametrize("n", [2, 4])
def test_train_many_matches_jax(runs, n, step):
    """Step `step` of train_many over n ranks against the JAX train_many on
    an n-device mesh (K = 1, the same step0) from the same state: loss
    within rtol 1e-5, correct and count equal, parameters, BatchNorm
    statistics and grad norm by `step_floor` (the port's 1-rank step under
    front ends 1e-5 dB off, seeds 0-7)."""
    metrics, states = runs["ranks"][n][0]["sgd"]
    got_m, (jm, want) = metrics[step], runs["jax"][n, step]
    np.testing.assert_allclose(got_m["loss"], jm["loss"], rtol=1e-5)
    np.testing.assert_array_equal(got_m["correct"], jm["correct"])
    np.testing.assert_array_equal(got_m["count"], jm["count"])
    assert got_m["count"][0] == A * B
    v = after_step(states[step + 1])
    got = (leaves(v["params"]) + leaves(v["batch_stats"]) + [got_m["loss"]],
           float(got_m["grad_norm"][-1]))
    margins = step_margins(got, want, runs["floor"][n, step])
    print(f"{n} ranks, train_many step {step}: {margins}")  # shown with -s
    assert margins.ok, margins


@pytest.mark.parametrize("n", [2, 4])
def test_train_many_equals_sharded_steps(runs, n):
    """Three Adam steps in one train_many call over n ranks, augmentation
    and dropout on, are the sharded per-step `train_step` on each rank's
    columns gathered from the cache, with generators seeded (seed, epoch,
    step, rank): metrics and parameters bit for bit on every rank."""
    for r in runs["ranks"][n]:
        (m_f, p_f), (m_s, p_s) = r["adam_fused"], r["adam_steps"]
        for k in m_f:
            np.testing.assert_array_equal(m_f[k], m_s[k], err_msg=k)
        for a_, b_ in zip(p_f, p_s, strict=True):
            np.testing.assert_array_equal(a_, b_)
        assert m_f["count"].tolist() == [A * B] * STEPS


@pytest.mark.parametrize("n", [2, 4])
def test_train_many_equals_one_rank(runs, n):
    """Each SGD step of train_many over n ranks against the 1-rank
    train_many from the same state (the bar of
    test_sharded_step_equals_one_rank): loss within 1e-6, correct and
    count equal, BatchNorm statistics within 1e-5, params and grad norm
    within rtol 2e-4 / atol 1e-6."""
    metrics, states = runs["ranks"][n][0]["sgd"]
    for s in range(STEPS):
        m1, v1 = runs["one"][n, s]
        got_m, v = metrics[s], after_step(states[s + 1])
        assert abs(float(got_m["loss"][0]) - float(m1["loss"][0])) <= 1e-6
        assert got_m["correct"] == m1["correct"] and got_m["count"] == m1["count"]
        np.testing.assert_allclose(got_m["grad_norm"], m1["grad_norm"], rtol=2e-4, atol=1e-6)
        for a_, b_ in zip(leaves(v["batch_stats"]), leaves(v1["batch_stats"])):
            np.testing.assert_allclose(a_, b_, rtol=0, atol=1e-5)
        for a_, b_ in zip(leaves(v["params"]), leaves(v1["params"])):
            np.testing.assert_allclose(a_, b_, rtol=2e-4, atol=1e-6)


@pytest.mark.parametrize("n", [2, 4])
def test_ranks_hold_equal_parameters(runs, n):
    """After every SGD step, and after the Adam steps, every rank holds
    rank 0's parameters and statistics bit for bit, and the same cache."""
    first = runs["ranks"][n][0]
    for other in runs["ranks"][n][1:]:
        assert other["cache"] == first["cache"]
        for (sd_a, _), (sd_b, _) in zip(first["sgd"][1], other["sgd"][1], strict=True):
            for k in sd_a:
                assert torch.equal(sd_a[k], sd_b[k]), k
        for a_, b_ in zip(first["adam_fused"][1], other["adam_fused"][1], strict=True):
            np.testing.assert_array_equal(a_, b_)


@pytest.mark.parametrize("n", [2, 4])
def test_eval_many_matches_jax(runs, n):
    """eval_many over n ranks (each its B / n columns, G = 128 // (B / n)
    batches a forward, the sums all-reduced, the predictions gathered
    along the batch axis) against the JAX eval_many on an n-device mesh:
    every rank's predictions equal the JAX (S, B) in global order, correct
    equal, den within rtol 1e-6, num within rtol 1e-4 (the 30x head)."""
    jnum, jden, jcorr, jpred = runs["jax_eval"][n]
    assert jpred.shape == (3, B) and len(np.unique(jpred)) > 1
    for r in runs["ranks"][n]:
        num, den, corr, pred = r["eval"]
        assert num.shape == (3,) and pred.shape == (3, B)
        np.testing.assert_array_equal(pred, jpred)
        np.testing.assert_array_equal(corr, jcorr)
        np.testing.assert_allclose(den, jden, rtol=1e-6)
        np.testing.assert_allclose(num, jnum, rtol=1e-4)


def trainer_runs(runs, name: str) -> list[dict]:
    return [r["trainer"][name] for r in runs["ranks"][2]]


def test_trainer_fuses_over_ranks(runs):
    """With cache_on_device over 2 gloo ranks the loaders are the device
    cache and the epoch is fused: one train_many call an epoch on the
    global (2, 2, 8) indices of the 2 full groups (the tail group of one
    batch steps apart), fused validation; the fp16 step has no fused form
    and runs per step on the cache; every rank's caches are the same bytes
    as the 1-rank trainer's."""
    want_cache = runs["trainer_one"]["cache"]
    for name in ("fused", "per_step", "inert", "fp16_cache"):
        for got in trainer_runs(runs, name):
            assert got["loaders"] == ["DeviceCachedLoader", "DeviceCachedLoader"], name
            assert got["cache"] == want_cache, name
            assert "cache_on_device: disabled" not in got["printed"], name
            fused = name in ("fused", "inert")
            assert got["fused"] == (fused, fused), name
            assert got["calls"] == ([((2, A, B), 0)] * 2 if fused else []), name
    for got in trainer_runs(runs, "fp16_host"):
        assert got["loaders"] == ["BatchLoader", "BatchLoader"] and got["fused"] == (False, False)


def test_trainer_fused_equals_per_step_over_ranks(runs):
    """Over 2 ranks, augmentation and dropout on (draws seeded per rank):
    the fused epoch (its tail step included) and fused validation train as
    the per-step path on the cache and its per-batch validation do, each
    on the rank's columns: losses within rtol 1e-4 (the JAX package's bar
    for fused against per step), accuracies equal, on both ranks alike."""
    for fused, per in zip(trainer_runs(runs, "fused"), trainer_runs(runs, "per_step")):
        hf, hp = fused["history"], per["history"]
        for k in ("train_loss", "val_loss"):
            np.testing.assert_allclose(hf[k], hp[k], rtol=1e-4, err_msg=k)
        np.testing.assert_allclose(hf["train_acc"], hp["train_acc"])
        np.testing.assert_allclose(hf["val_acc"], hp["val_acc"])
        assert hf == trainer_runs(runs, "fused")[0]["history"]


def test_trainer_two_ranks_equal_one(runs):
    """With augmentation off and dropout 0, the ICBHI trainer's fused run
    over 2 ranks is the 1-rank fused run: losses within rtol 2e-4 / atol
    1e-6, accuracies and ICBHI scores equal, and every rank's
    val_predictions (the global ones, in loader order) equal the 1-rank
    run's."""
    one = runs["trainer_one"]
    assert one["fused"] == (True, True) and one["calls"] == [((2, A, B), 0)] * 2
    for got in trainer_runs(runs, "inert"):
        for k in ("train_loss", "val_loss"):
            np.testing.assert_allclose(got["history"][k], one["history"][k], rtol=2e-4,
                                       atol=1e-6, err_msg=k)
        for k in ("train_acc", "val_acc", "icbhi_score"):
            np.testing.assert_allclose(got["history"][k], one["history"][k], err_msg=k)
        for a_, b_ in zip(got["val_predictions"], one["val_predictions"], strict=True):
            np.testing.assert_array_equal(a_, b_)
        assert len(one["val_predictions"][1]) == 9


def test_fp16_on_the_cache_over_ranks(runs):
    """The fp16 loss-scaled step over 2 ranks runs per step on the cache,
    each rank gathering its columns, and its per-batch validation reads
    the cache the same way: the history equals the same run on the host
    loader (each rank decoding its rows), bit for bit."""
    for cached, hosted in zip(trainer_runs(runs, "fp16_cache"), trainer_runs(runs, "fp16_host")):
        assert cached["history"] == hosted["history"]
        assert all(np.isfinite(v).all() for v in cached["history"].values())
