"""The port's device-resident waveform cache and fused multi-step epoch
against the JAX package's, on the CPU.

- `DeviceCachedLoader`'s batches against the host `BatchLoader`'s and the
  JAX `DeviceCachedLoader`'s, bit for bit; `_pcm16_quantize` against the
  JAX function; the three `cache_dtype` modes (the JAX package's
  `tests/test_trainer_e2e.py::test_cache_dtype_modes`);
- `train_many` over 3 steps against the JAX `train_many` from the same flax
  weights, cache and indices (augmentation off, dropout inert; SGD at lr 1,
  parameters held by the port's `step_floor`), `eval_many` against the JAX
  `eval_many`;
- the trainer's fused epoch against its per-step epoch (the JAX package's
  `test_multi_step_dispatch_matches_per_step`, rtol 1e-4), every
  steps_per_dispatch but 1 read as the whole epoch a call, fused
  validation with G-group padding against per-batch validation
  (`test_fused_validation_matches_per_batch`), the ICBHI trainer
  and the segmented config through their entry points, and the cache's
  rule over ranks: on over a gloo group of 2 ranks of one machine, off on
  a mesh of 2 hosts.

On the CPU the port's fused functions run eagerly (the CUDA graphs are the
card's: `chip_smoke.py` phase 23).
"""

import contextlib
import copy
import io
from pathlib import Path

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from audio_classification_icbhi_tpu.data import device_cache as jax_cache
from audio_classification_icbhi_tpu.data.dataset_segmented import (
    ICBHISegmentedDataset as JaxSegmented,
)
from audio_classification_icbhi_tpu.models import LightweightCNN as FlaxCNN
from audio_classification_icbhi_tpu.ops import mel as jax_mel
from audio_classification_icbhi_tpu.parallel import data_parallel as jax_dp
from audio_classification_icbhi_tpu.parallel.mesh import get_mesh as jax_mesh
from audio_classification_icbhi_tpu.training.optimizers import build_optimizer as jax_optimizer
from audio_classification_icbhi_tpu_torch import train_icbhi, train_segmented
from audio_classification_icbhi_tpu_torch.data.dataset_segmented import ICBHISegmentedDataset
from audio_classification_icbhi_tpu_torch.data.device_cache import (
    DeviceCachedLoader,
    _pcm16_quantize,
    dequantize,
)
from audio_classification_icbhi_tpu_torch.data.loader import BatchLoader
from audio_classification_icbhi_tpu_torch.data.synthetic import generate_segmented_dataset
from audio_classification_icbhi_tpu_torch.models import LightweightCNN, build_model
from audio_classification_icbhi_tpu_torch.models.weights import (
    flax_from_state_dict,
    optax_from_opt_state,
    state_dict_from_flax,
)
from audio_classification_icbhi_tpu_torch.ops import mel as port_mel
from audio_classification_icbhi_tpu_torch.parallel import data_parallel as port_dp
from audio_classification_icbhi_tpu_torch.parallel.mesh import Mesh
from audio_classification_icbhi_tpu_torch.step_floor import step_floor, step_margins
from audio_classification_icbhi_tpu_torch.training.optimizers import build_optimizer
from audio_classification_icbhi_tpu_torch.training.trainer import Trainer
from audio_classification_icbhi_tpu_torch.utils.config import load_config
from test_torch_data_parallel import join, leaves, run_ranks
from test_torch_train_step import no_dropout

REPO = Path(__file__).resolve().parent.parent
SMALL_FE = dict(sample_rate=4000, n_mels=32, n_fft=256, hop_length=64, duration=0.8)
CW = np.asarray([1.0, 2.0, 0.5, 1.5], np.float32)


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two intra-op threads for this file's many small CPU steps: the same
    time alone, a third less CPU beside the suite's other workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def seg_data(tmp_path_factory):
    """64 PCM16 clips of 0.8 s at 4 kHz: 44 train, 9 val. At batch 8 and
    accumulation 2 the train split has 2 full groups and a tail group of
    one batch, the val split a full batch and a tail batch of one clip."""
    return generate_segmented_dataset(tmp_path_factory.mktemp("seg4k"), per_class=16,
                                      duration=0.8, sample_rate=4000)


def tiny_config(tmp: Path, name: str, epochs: int = 2, **training) -> dict:
    """The JAX package's `test_trainer_e2e.tiny_config`, with the cache on."""
    config = {
        "data": {"dataset_path": "unused", **SMALL_FE, "augmentation": True,
                 "train_split": 0.7, "val_split": 0.15, "cache_on_device": True},
        "model": {"architecture": "cnn", "num_classes": 4, "dropout": 0.1},
        "training": {"batch_size": 8, "epochs": epochs, "learning_rate": 3e-3,
                     "weight_decay": 1e-4, "optimizer": "adam", "scheduler": "cosine",
                     "mixed_precision": False, "gradient_accumulation_steps": 2,
                     "early_stopping_patience": 50, "save_every": 2,
                     "checkpoint_dir": str(tmp / name / "ckpts"),
                     "log_dir": str(tmp / name / "runs"), **training},
        "classes": ["normal", "crackles", "wheezes", "both"],
        "seed": 0,
    }
    return config


def make_trainer(root, config, cls=Trainer):
    train = ICBHISegmentedDataset(root, "train", config, augment=True)
    val = ICBHISegmentedDataset(root, "val", config, augment=False)
    return cls(build_model(config), train, val, config, device="cpu")


# --- the loader ----------------------------------------------------------------

def test_cache_batches_equal_host_and_jax_loaders(seg_data, tmp_path):
    """The seeded shuffle at epoch 3: the cache's batches equal the host
    loader's and the JAX cache's bit for bit, labels and the epoch's index
    table too; PCM16 clips are stored as int16."""
    config = tiny_config(tmp_path, "l")
    train = ICBHISegmentedDataset(seg_data, "train", config)
    jtrain = JaxSegmented(seg_data, "train", config)
    host = BatchLoader(train, 8, shuffle=True, drop_last=True, seed=5)
    dev = DeviceCachedLoader(train, 8, device="cpu", shuffle=True, drop_last=True, seed=5)
    jdev = jax_cache.DeviceCachedLoader(jtrain, 8, shuffle=True, drop_last=True, seed=5)
    assert dev.cache.dtype == torch.int16 and dev.nbytes == dev.cache.numel() * 2
    np.testing.assert_array_equal(dev.cache.numpy(), np.asarray(jdev.cache))
    np.testing.assert_array_equal(dev.labels_all, jdev.labels_all)
    for loader in (host, dev, jdev):
        loader.set_epoch(3)
    np.testing.assert_array_equal(dev.epoch_index_batches(), jdev.epoch_index_batches())
    batches = [list(host), list(dev), list(jdev)]
    assert len(batches[1]) == len(host) == 5 and dev._epoch == 4
    for (w1, l1), (w2, l2), (w3, l3) in zip(*batches):
        assert isinstance(w2, torch.Tensor) and w2.dtype == torch.float32
        np.testing.assert_array_equal(w2.numpy(), w1)
        np.testing.assert_array_equal(w2.numpy(), np.asarray(w3))
        np.testing.assert_array_equal(l1, l2)
        np.testing.assert_array_equal(l2, l3)
    idx = dev.epoch_index_batches()[:2]
    np.testing.assert_array_equal(dev.gather(idx).numpy(),
                                  np.asarray(jdev._gather(jdev.cache, jnp.asarray(idx))))


GRID = np.array([[-32768, -1, 0, 1, 32767]], np.float32) / 32768.0


@pytest.mark.parametrize("case", ["grid", "gain", "range", "nan", "corpus", "float64", "empty",
                                  "1d"])
def test_pcm16_quantize_matches_jax(seg_data, tmp_path, case):
    """The round-trip check equals the JAX function's on PCM16 audio (the
    grid's full-scale ends, decoded clips) and on audio it must refuse
    (an off-grid gain, out of range, NaN, float64, empty): None where the
    JAX one returns None, the same int16 image elsewhere."""
    if case == "corpus":
        loader = BatchLoader(ICBHISegmentedDataset(seg_data, "train", tiny_config(tmp_path, "q")),
                             8)
        x = next(iter(loader))[0]
    else:
        x = {"grid": GRID, "gain": GRID * np.float32(0.3), "range": GRID + np.float32(2.0),
             "nan": np.where(np.arange(5) == 2, np.nan, GRID).astype(np.float32),
             "float64": GRID.astype(np.float64), "empty": np.zeros((0, 4), np.float32),
             "1d": GRID[0]}[case]
    got, want = _pcm16_quantize(x), jax_cache._pcm16_quantize(x)
    assert (got is None) == (want is None) == (case not in ("grid", "corpus", "1d"))
    if want is not None:
        assert got.dtype == np.int16
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(dequantize(torch.from_numpy(got)).numpy(), x)


def test_cache_dtype_modes(seg_data, tmp_path):
    """"auto" stores int16 only where the round-trip is exact and falls back
    to float32 on gain-scaled audio, "float32" forces float32, "int16"
    raises on lossy audio, and another name raises."""
    train = ICBHISegmentedDataset(seg_data, "train", tiny_config(tmp_path, "m"))
    assert DeviceCachedLoader(train, 8, device="cpu").cache.dtype == torch.int16
    forced = DeviceCachedLoader(train, 8, device="cpu", cache_dtype="float32")
    assert forced.cache.dtype == torch.float32 and forced.nbytes == forced.cache.numel() * 4
    q = _pcm16_quantize(GRID)
    np.testing.assert_array_equal(dequantize(torch.from_numpy(q)).numpy(), GRID)
    x = torch.from_numpy(GRID)
    assert dequantize(x) is x  # the identity on float32

    class LossyLoader(DeviceCachedLoader):
        """A decode with an off-grid gain (a resampled or normalized corpus)."""

        def _load_batch(self, idxs):
            w, lbl = super()._load_batch(idxs)
            return w * np.float32(0.3), lbl

    lossy = LossyLoader(train, 8, device="cpu")
    assert lossy.cache.dtype == torch.float32
    np.testing.assert_array_equal(lossy.gather([0, 1]).numpy(),
                                  forced.gather([0, 1]).numpy() * np.float32(0.3))
    with pytest.raises(ValueError, match="round-trip"):
        LossyLoader(train, 8, device="cpu", cache_dtype="int16")
    with pytest.raises(ValueError, match="cache_dtype"):
        DeviceCachedLoader(train, 8, device="cpu", cache_dtype="pcm")
    with pytest.raises(ValueError, match="every row"):
        DeviceCachedLoader(train, 8, device="cpu", shard=(0, 2))


# --- train_many / eval_many against the JAX package ----------------------------

def port_state(model, opt) -> tuple[dict, dict]:
    return copy.deepcopy(model.state_dict()), copy.deepcopy(opt.state_dict())


def port_fns(state, frontend):
    """A LightweightCNN (dropout 0) and its SGD from `state`, and their
    step functions (accumulation 2)."""
    model = LightweightCNN()
    model.load_state_dict(state[0])
    model.set_dropout(0.0)
    opt = build_optimizer("sgd", model.named_parameters())
    opt.load_state_dict(state[1])
    return model, opt, port_dp.make_step_fns(model, frontend, opt, accum_steps=2)


def step_result(metrics, model) -> tuple[list, float]:
    """The step bound's view of a step: the parameters and BatchNorm
    statistics after it and its loss, held element by element, and its
    grad norm."""
    v = flax_from_state_dict(model.state_dict())
    return (leaves(v["params"]) + leaves(v["batch_stats"]) + [np.asarray(metrics["loss"])],
            float(np.asarray(metrics["grad_norm"]).reshape(-1)[-1]))


class NoiseClips:
    """n clips of seeded noise on the PCM16 grid (|x| < 0.3), 0.8 s at 4
    kHz, and their labels: a dataset as the loaders read one."""

    def __init__(self, n: int, seed: int):
        rng = np.random.default_rng(seed)
        self.clips = rng.integers(-9830, 9831, (n, 3200)).astype(np.float32) / 32768.0
        self.labels = rng.integers(0, 4, n).astype(np.int32)
        self.target_length = 3200

    def __len__(self):
        return len(self.labels)

    def __getitem__(self, i):
        return self.clips[i], int(self.labels[i])


@pytest.fixture(scope="module")
def many(tmp_path_factory):
    """The port's train_many over 3 steps of (2, 8) rows of one int16 cache
    (SGD at lr 1, fp32, augmentation off, dropout inert), in one call and
    one step a call; each step also through the JAX train_many (K = 1) from
    the port's state before it, and through the port again under front
    ends 1e-5 dB off for its floor. Both eval_many over a mask-padded tail.
    The cache holds seeded noise, as every step test here does: quiet
    stretches of the synthetic cycles put exact ties into the max-pools,
    which the two frameworks' conv rounding breaks at different positions
    (tests/test_torch_train_step.py::test_augmented_train_step_matches_jax)."""
    config = tiny_config(tmp_path_factory.mktemp("many"), "x")
    loader = DeviceCachedLoader(NoiseClips(44, seed=6), 8, device="cpu")
    assert loader.cache.dtype == torch.int16
    cache = loader.cache
    jcache = jnp.asarray(cache.numpy())
    cw = torch.from_numpy(CW)
    rng = np.random.default_rng(4)
    idxs = np.stack([rng.permutation(len(loader.labels_all))[:16].reshape(2, 8)
                     for _ in range(3)]).astype(np.int32)
    labels = loader.labels_all[idxs]
    jfe = jax_mel.MelFrontend(backend="xla", **SMALL_FE)
    pfe = port_mel.MelFrontend(**SMALL_FE)
    v = jax.tree_util.tree_map(np.asarray, FlaxCNN(num_classes=4).init(
        jax.random.PRNGKey(0), jnp.zeros((2, 32, pfe.num_frames, 1)), train=False))
    init = LightweightCNN()
    init.load_state_dict(state_dict_from_flax(v))
    state0 = port_state(init, build_optimizer("sgd", init.named_parameters()))

    model, _, fns = port_fns(state0, pfe)
    whole = fns.train_many(cache, idxs, labels, cw, 1.0, 0, 0)
    whole = ({k: x.numpy() for k, x in whole.items()}, leaves(
        flax_from_state_dict(model.state_dict())))

    tx = jax_optimizer("sgd", 0.0)
    jsteps = jax_dp.make_step_fns(FlaxCNN(num_classes=4), jfe, tx, jax_mesh(num_devices=1),
                                  accum_steps=2)
    model, opt, fns = port_fns(state0, pfe)
    steps = []
    for s in range(3):
        before = port_state(model, opt)
        jv = flax_from_state_dict(before[0])
        jopt = serialization.from_state_dict(tx.init(jv["params"]),
                                             optax_from_opt_state(opt, "sgd"))
        with nn.intercept_methods(no_dropout):
            jp, jbs, _, jm = jsteps.train_many(
                jax.tree_util.tree_map(jnp.asarray, jv["params"]),
                jax.tree_util.tree_map(jnp.asarray, jv["batch_stats"]), jopt, jcache,
                idxs[s:s + 1], labels[s:s + 1], CW, np.float32(1.0), jax.random.PRNGKey(3),
                np.int32(s))
        jm = {k: np.asarray(x) for k, x in jm.items()}
        got = {k: x.numpy() for k, x in fns.train_many(cache, idxs[s:s + 1], labels[s:s + 1],
                                                         cw, 1.0, 0, s).items()}

        def rerun(frontend, before=before, s=s):
            m_, _, f_ = port_fns(before, frontend)
            return step_result(f_.train_many(cache, idxs[s:s + 1], labels[s:s + 1], cw, 1.0,
                                              0, s), m_)

        base = step_result(got, model)
        want = (leaves(jp) + leaves(jbs) + [jm["loss"]], float(jm["grad_norm"][-1]))
        steps.append(dict(got=got, want=jm, margins=step_margins(
            base, want, step_floor(rerun, pfe, base))))
    stepwise = ({k: np.concatenate([st["got"][k] for st in steps]) for k in whole[0]},
                leaves(flax_from_state_dict(model.state_dict())))

    # eval: seeded weights with a 30x head, so that the classes part; 3
    # batches of 8 with a tail of 5 real rows, one group of G = 16
    ev_model = build_model(config, generator=torch.Generator().manual_seed(3))
    ev_model.load_state_dict({k: t * 30.0 if k in ("fc1.weight", "fc2.weight") else t
                              for k, t in ev_model.state_dict().items()})
    ev = flax_from_state_dict(ev_model.state_dict())
    eidx = np.stack([rng.permutation(len(loader.labels_all))[:8] for _ in range(3)])
    mask = np.ones((3, 8), np.float32)
    mask[2, 5:] = 0.0
    eidx[2, 5:] = 0
    elab = loader.labels_all[eidx]
    jeval = jsteps.eval_many(ev["params"], ev["batch_stats"], jcache, eidx.astype(np.int32),
                             elab, mask, CW)
    fns = port_dp.make_step_fns(ev_model, pfe, build_optimizer("adam", ev_model.parameters()))
    peval = fns.eval_many(cache, eidx, elab, mask, cw)
    return dict(whole=whole, stepwise=stepwise, steps=steps,
                eval=([np.asarray(x) for x in jeval], [x.numpy() for x in peval]))


def test_train_many_in_one_call_equals_a_step_a_call(many):
    """3 steps in one train_many call equal 3 calls of one step (step0 =
    0, 1, 2) bit for bit on the CPU: the chunking moves nothing."""
    (m1, p1), (m2, p2) = many["whole"], many["stepwise"]
    for k in m1:
        np.testing.assert_array_equal(m1[k], m2[k])
    for a_, b_ in zip(p1, p2, strict=True):
        np.testing.assert_array_equal(a_, b_)
    assert m1["loss"].shape == (3,) and (m1["count"] == 16).all()


@pytest.mark.parametrize("step", [0, 1, 2])
def test_train_many_matches_jax(many, step):
    """Each of the 3 steps against the JAX train_many's step (K = 1, the
    same step0) from the same state (the flax init for step 0, the port's
    state after the steps before it): loss within rtol 1e-5, correct and
    count equal, and the parameters, BN statistics and grad norm after it
    held by `step_floor` (the port's step under front ends 1e-5 dB off,
    seeds 0-7; the bound of chip_smoke.py's phase 8). From one init over
    3 lr-1 steps the two trajectories part by up to 10x that bound: each
    step's rounding moves the next step's weights."""
    st = many["steps"][step]
    got, want = st["got"], st["want"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_array_equal(got["correct"], want["correct"])
    np.testing.assert_array_equal(got["count"], want["count"])
    print(f"train_many step {step}: {st['margins']}")  # shown with -s
    assert st["margins"].ok, st["margins"]


def test_eval_many_matches_jax(many):
    """Per-batch (num, den, correct) and the argmax predictions of every
    row, a mask-padded tail and the G-group padding included: den (the
    class weights' sum) within rtol 1e-6, correct and the predictions
    equal, num within rtol 1e-4, since the 30x head that spreads the
    classes scales the logits' rounding by 30."""
    (jnum, jden, jcorr, jpred), (num, den, corr, pred) = many["eval"]
    assert num.shape == (3,) and pred.shape == (3, 8)
    np.testing.assert_allclose(num, jnum, rtol=1e-4)
    np.testing.assert_allclose(den, jden, rtol=1e-6)
    np.testing.assert_array_equal(corr, jcorr)
    np.testing.assert_array_equal(pred, jpred)
    assert len(np.unique(pred)) > 1  # the predictions follow the input


def test_eval_many_empty():
    model = LightweightCNN()
    fns = port_dp.make_step_fns(model, port_mel.MelFrontend(**SMALL_FE),
                                build_optimizer("adam", model.named_parameters()))
    num, den, corr, pred = fns.eval_many(torch.zeros((3, 3200), dtype=torch.int16),
                                         np.zeros((0, 8)), np.zeros((0, 8)), np.zeros((0, 8)),
                                         torch.from_numpy(CW))
    assert num.shape == den.shape == corr.shape == (0,) and pred.shape == (0, 8)


def test_fused_steps_absent_under_loss_scale():
    """As in the JAX package: the fp16 loss-scaled step has neither."""
    model = LightweightCNN()
    fns = port_dp.make_step_fns(model, port_mel.MelFrontend(**SMALL_FE),
                                build_optimizer("adam", model.named_parameters()),
                                dynamic_loss_scale=True)
    assert fns.train_many is None and fns.eval_many is None


# --- the trainer ------------------------------------------------------------------

@pytest.fixture(scope="module")
def per_step(seg_data, tmp_path_factory):
    """2 epochs of the per-step path on the cache (steps_per_dispatch 1) at
    batch 4: 11 batches an epoch, 5 full accumulation groups and a tail
    group of one batch."""
    t = make_trainer(seg_data, tiny_config(tmp_path_factory.mktemp("per"), "p", batch_size=4,
                                           steps_per_dispatch=1))
    assert isinstance(t.train_loader, DeviceCachedLoader) and not t._use_multi_dispatch()
    return t.train()


def test_fused_epoch_matches_per_step(seg_data, tmp_path, per_step):
    """The fused epoch (steps_per_dispatch 0: train_many over the whole
    epoch's 5 full groups, the tail group through train_step) trains as the
    per-step path does: augmentation and dropout on, so the draws of each
    step must be the per-step path's; train and val losses within rtol 1e-4
    over 2 epochs (the JAX package's bar), accuracies equal."""
    t = make_trainer(seg_data, tiny_config(tmp_path, "f", batch_size=4, steps_per_dispatch=0))
    assert t._use_multi_dispatch() and t._use_fused_eval()
    calls = []
    many = t.steps.train_many
    t.steps = t.steps._replace(
        train_many=lambda *a: (calls.append((a[1].shape, a[6])), many(*a))[1])
    hist = t.train()
    assert calls == [((5, 2, 4), 0)] * 2
    for k in ("train_loss", "val_loss"):
        np.testing.assert_allclose(hist[k], per_step[k], rtol=1e-4)
    np.testing.assert_allclose(hist["train_acc"], per_step["train_acc"])
    np.testing.assert_allclose(hist["val_acc"], per_step["val_acc"])


@pytest.mark.parametrize("spd, fused", [(None, True), (0, True), (1, False), (2, True),
                                         (7, True)])
def test_steps_per_dispatch_reads_as_whole_epoch(seg_data, tmp_path, spd, fused):
    """training.steps_per_dispatch: 1 turns the fused epoch off; absent, 0
    or any K runs it, one train_many call an epoch (each step is a graph
    replay of its own on the card, so K sizes nothing)."""
    training = {} if spd is None else {"steps_per_dispatch": spd}
    t = make_trainer(seg_data, tiny_config(tmp_path, "k", epochs=1, batch_size=4, **training))
    assert t._use_multi_dispatch() == t._use_fused_eval() == fused
    if fused:
        calls = []
        many = t.steps.train_many
        t.steps = t.steps._replace(
            train_many=lambda *a: (calls.append((a[1].shape, a[6])), many(*a))[1])
        t.train_epoch(0)
        assert calls == [((5, 2, 4), 0)]


@pytest.mark.parametrize("batch, spd", [(8, 0), (2, 2)])
def test_fused_validation_matches_per_batch(seg_data, tmp_path, batch, spd):
    """Fused validation against per-batch validation, on seeded weights
    with a 30x head (so that the classes part): loss (rel 1e-5), accuracy
    and val_predictions equal, in one eval_many call. Batch 8: a full batch
    and a tail of one clip, padded to one group of G = 16. Batch 2 with
    steps_per_dispatch 2 (read as the whole epoch): 5 batches, the tail one
    clip, padded to one group of G = 64."""
    config = tiny_config(tmp_path, "v", epochs=1, batch_size=batch, steps_per_dispatch=spd)
    t = make_trainer(seg_data, config)
    t.collect_predictions = True
    t.model.load_state_dict({k: v * 30.0 if k in ("fc1.weight", "fc2.weight") else v
                             for k, v in t.model.state_dict().items()})
    seen = []
    orig = t.steps.eval_many
    t.steps = t.steps._replace(eval_many=lambda *a: (seen.append(len(a[1])), orig(*a))[1])
    assert t._use_fused_eval()
    loss_f, acc_f = t.validate(0)
    true_f, pred_f = t.val_predictions
    assert seen == [len(t.val_loader._batch_indices())]
    assert len(true_f) == len(pred_f) == len(t.val_dataset) == 9
    assert len(np.unique(pred_f)) > 1

    t.config["training"]["steps_per_dispatch"] = 1
    assert not t._use_fused_eval()
    loss_p, acc_p = t.validate(0)
    true_p, pred_p = t.val_predictions
    assert loss_f == pytest.approx(loss_p, rel=1e-5)
    assert acc_f == pytest.approx(acc_p)
    np.testing.assert_array_equal(true_f, true_p)
    np.testing.assert_array_equal(pred_f, pred_p)


def write_yaml(path: Path, config: dict) -> str:
    import yaml

    path.write_text(yaml.safe_dump(config))
    return str(path)


@pytest.mark.parametrize("entry", ["train_icbhi", "train_segmented"])
def test_segmented_entries_run_fused(seg_data, tmp_path, monkeypatch, entry):
    """`train_icbhi` (TrainerWithICBHI, selection on the ICBHI score from
    the fused pass's predictions) and `train_segmented` at
    config_segmented.yaml (4 kHz front end, batch 8 x accumulation 4: one
    full group and a tail group of 2 batches), cache on, fused against
    steps_per_dispatch 1 through the entry point, one epoch: the same
    histories within rtol 1e-4, ICBHI scores equal."""
    monkeypatch.chdir(tmp_path)
    module = {"train_icbhi": train_icbhi, "train_segmented": train_segmented}[entry]
    hists = {}
    for spd in (0, 1):
        config = load_config(str(REPO / "config_segmented.yaml"))
        config["data"].update(SMALL_FE, cache_on_device=True)
        config["training"].update(batch_size=8, epochs=1, mixed_precision=False,
                                  steps_per_dispatch=spd,
                                  checkpoint_dir=str(tmp_path / f"s{spd}" / "ckpt"),
                                  log_dir=str(tmp_path / f"s{spd}" / "runs"))
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            hists[spd] = module.main(["--config", write_yaml(tmp_path / f"s{spd}.yaml", config),
                                      "--data-path", str(seg_data), "--device", "cpu",
                                      "--no-plots"])
        assert "Device cache:" in out.getvalue()
        assert (tmp_path / f"s{spd}" / "ckpt" / "best_model.ckpt").exists()
    for k, v in hists[1].items():
        np.testing.assert_allclose(hists[0][k], v, rtol=1e-4, err_msg=k)
    if entry == "train_icbhi":
        assert len(hists[0]["icbhi_score"]) == 1


def cache_rank(rank, n, port, payload, out):
    """One rank of a gloo group building the Trainer with the cache asked
    for: it records the loaders it got and what it printed."""
    mesh = join(rank, n, port)
    p = torch.load(payload, weights_only=False)
    config = p["config"]
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        t = Trainer(build_model(config, axis_name=mesh.group),
                    ICBHISegmentedDataset(p["root"], "train", config),
                    ICBHISegmentedDataset(p["root"], "val", config), config, mesh=mesh)
    torch.save({"loaders": [type(t.train_loader).__name__, type(t.val_loader).__name__],
                "cache": t.cache_on_device, "fused": t._use_multi_dispatch(),
                "hosts": mesh.hosts, "printed": text.getvalue()}, Path(out) / f"rank{rank}.pt")


CACHE_OFF = ("cache_on_device: disabled under multi-host training (the fused dispatch paths "
             "are single-controller); using the per-step host loader.")


@pytest.mark.parametrize("hosts", [1, 2])
def test_cache_rule_over_ranks(seg_data, tmp_path, hosts):
    """The JAX trainer's rule, with a port rank for each device: the cache
    is off only where the group spans several machines (`Mesh.hosts`, the
    counterpart of `jax.process_count()`). Over a gloo group of 2 ranks on
    this machine (hosts 1) both loaders are the device cache and the epoch
    is fused; on a mesh of 2 hosts the trainer turns the cache off with the
    JAX trainer's message and uses the per-step host loaders."""
    config = tiny_config(tmp_path, "g")
    if hosts == 1:
        torch.save({"config": config, "root": str(seg_data)}, tmp_path / "payload.pt")
        run_ranks(2, "test_torch_device_cache:cache_rank", tmp_path / "payload.pt", tmp_path)
        got = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2)]
    else:
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            t = Trainer(build_model(config), ICBHISegmentedDataset(seg_data, "train", config),
                        ICBHISegmentedDataset(seg_data, "val", config), config,
                        mesh=Mesh(torch.device("cpu"), hosts=2))
        got = [{"loaders": [type(t.train_loader).__name__, type(t.val_loader).__name__],
                "cache": t.cache_on_device, "fused": t._use_multi_dispatch(), "hosts": 2,
                "printed": text.getvalue()}]
    for g in got:
        assert g["hosts"] == hosts
        if hosts == 1:
            assert g["loaders"] == ["DeviceCachedLoader", "DeviceCachedLoader"]
            assert g["cache"] and g["fused"]
            assert "Device cache:" in g["printed"] and CACHE_OFF not in g["printed"]
        else:
            assert g["loaders"] == ["BatchLoader", "BatchLoader"]
            assert not g["cache"] and not g["fused"]
            assert CACHE_OFF in g["printed"]
