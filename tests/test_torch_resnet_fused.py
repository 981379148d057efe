"""CompactResNet18 on the port's fused multi-step epoch against the JAX
package, on the CPU.

- `train_many` over 3 steps of a ResNet at `stage_sizes=(1, 1)` against
  the JAX `train_many` with flax `CompactResNet` from the same weights,
  cache and indices (fp32, SGD at lr 1, augmentation off, dropout inert, a
  cache of seeded PCM16 noise): 3 steps in one call equal 3 calls of one
  step bit for bit, and each step holds the JAX one by the port's
  `step_floor`;
- `eval_many` against the JAX `eval_many` over a mask-padded tail;
- the `Trainer` at `architecture: resnet` (full depth) on the device
  cache: the fused epoch's history against the per-step one, fused
  validation against per-batch validation.

On the CPU the port's fused functions run eagerly (the CUDA graphs are the
card's: `chip_smoke.py` phase 27).
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from audio_classification_icbhi_tpu.models.resnet import CompactResNet as FlaxResNet
from audio_classification_icbhi_tpu.ops import mel as jax_mel
from audio_classification_icbhi_tpu.parallel import data_parallel as jax_dp
from audio_classification_icbhi_tpu.parallel.mesh import get_mesh as jax_mesh
from audio_classification_icbhi_tpu.training.optimizers import build_optimizer as jax_optimizer
from audio_classification_icbhi_tpu_torch.data.dataset_segmented import ICBHISegmentedDataset
from audio_classification_icbhi_tpu_torch.data.device_cache import DeviceCachedLoader, dequantize
from audio_classification_icbhi_tpu_torch.data.synthetic import generate_segmented_dataset
from audio_classification_icbhi_tpu_torch.models import CompactResNet, build_model
from audio_classification_icbhi_tpu_torch.models.weights import (
    flax_from_state_dict,
    optax_from_opt_state,
    state_dict_from_flax,
)
from audio_classification_icbhi_tpu_torch.ops import mel as port_mel
from audio_classification_icbhi_tpu_torch.parallel import data_parallel as port_dp
from audio_classification_icbhi_tpu_torch.parallel.data_parallel import features_from_wavs
from audio_classification_icbhi_tpu_torch.step_floor import step_floor, step_margins
from audio_classification_icbhi_tpu_torch.training.optimizers import build_optimizer
from audio_classification_icbhi_tpu_torch.training.trainer import Trainer
from test_torch_data_parallel import leaves
from test_torch_device_cache import port_state, step_result
from test_torch_resnet import flax_resnet_variables
from test_torch_train_step import no_dropout

SMALL_FE = dict(sample_rate=4000, n_mels=32, n_fft=256, hop_length=64, duration=0.5)
STAGES = (1, 1)
CW = np.asarray([1.0, 2.0, 0.5, 1.5], np.float32)


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two intra-op threads, as tests/test_torch_device_cache.py takes."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


class NoiseClips:
    """n clips of seeded noise on the PCM16 grid (|x| < 0.3), 0.5 s at 4
    kHz, and their labels: a dataset as the loaders read one."""

    def __init__(self, n: int, seed: int):
        rng = np.random.default_rng(seed)
        self.clips = rng.integers(-9830, 9831, (n, 2000)).astype(np.float32) / 32768.0
        self.labels = rng.integers(0, 4, n).astype(np.int32)
        self.target_length = 2000

    def __len__(self):
        return len(self.labels)

    def __getitem__(self, i):
        return self.clips[i], int(self.labels[i])


def calibrate_bn(model: torch.nn.Module, frontend, wavs: torch.Tensor) -> None:
    """Every BatchNorm's running statistics set to those of one train-mode
    forward over `wavs`, so that the eval-mode ResNet's classes part on
    these inputs (with the init's statistics every clip falls in one)."""
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    for bn in bns:
        bn.momentum = 1.0
    model.train()
    with torch.no_grad():
        model(features_from_wavs(frontend, wavs))
    for bn in bns:
        bn.momentum = 0.1


def port_fns(state, frontend):
    """A ResNet at STAGES (dropout 0) and its SGD from `state`, and their
    step functions (accumulation 2)."""
    model = CompactResNet(stage_sizes=STAGES)
    model.load_state_dict(state[0])
    model.set_dropout(0.0)
    opt = build_optimizer("sgd", model.named_parameters())
    opt.load_state_dict(state[1])
    return model, opt, port_dp.make_step_fns(model, frontend, opt, accum_steps=2)


@pytest.fixture(scope="module")
def many():
    """The port's ResNet train_many over 3 steps of (2, 8) rows of one
    int16 cache (SGD at lr 1, fp32, augmentation off, dropout inert), in
    one call and one step a call; each step also through the JAX train_many
    (K = 1) from the port's state before it, and through the port again
    under front ends 1e-5 dB off for its floor. Both eval_many over a
    mask-padded tail, on seeded weights with their BatchNorm statistics
    from 32 clips of the cache (`calibrate_bn`)."""
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
    v = flax_resnet_variables(STAGES, (2, 32, pfe.num_frames, 1), head=1.0)
    init = CompactResNet(stage_sizes=STAGES)
    init.load_state_dict(state_dict_from_flax(v))
    state0 = port_state(init, build_optimizer("sgd", init.named_parameters()))

    model, _, fns = port_fns(state0, pfe)
    whole = fns.train_many(cache, idxs, labels, cw, 1.0, 0, 0)
    whole = ({k: x.numpy() for k, x in whole.items()},
             leaves(flax_from_state_dict(model.state_dict())))

    tx = jax_optimizer("sgd", 0.0)
    jsteps = jax_dp.make_step_fns(FlaxResNet(num_classes=4, stage_sizes=STAGES), jfe, tx,
                                  jax_mesh(num_devices=1), accum_steps=2)
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

    # eval: 3 batches of 8 with a tail of 5 real rows, one group of G = 16
    ev_model = CompactResNet(stage_sizes=STAGES)
    ev_model.load_state_dict(state_dict_from_flax(flax_resnet_variables(
        STAGES, (2, 32, pfe.num_frames, 1), seed=4, head=1.0)))
    calibrate_bn(ev_model, pfe, dequantize(cache[:32]))
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


def test_resnet_train_many_in_one_call_equals_a_step_a_call(many):
    """3 ResNet steps in one train_many call equal 3 calls of one step
    (step0 = 0, 1, 2) bit for bit on the CPU: the chunking moves nothing,
    the BatchNorm running statistics included."""
    (m1, p1), (m2, p2) = many["whole"], many["stepwise"]
    for k in m1:
        np.testing.assert_array_equal(m1[k], m2[k])
    for a_, b_ in zip(p1, p2, strict=True):
        np.testing.assert_array_equal(a_, b_)
    assert m1["loss"].shape == (3,) and (m1["count"] == 16).all()


@pytest.mark.parametrize("step", [0, 1, 2])
def test_resnet_train_many_matches_jax(many, step):
    """Each of the 3 ResNet steps against the JAX train_many's step (K = 1,
    the same step0) with flax CompactResNet, from the same state: loss within
    rtol 1e-5, correct and count equal, and the parameters, BN statistics
    and grad norm after it held by `step_floor` (the port's step under
    front ends 1e-5 dB off, seeds 0-7)."""
    st = many["steps"][step]
    got, want = st["got"], st["want"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_array_equal(got["correct"], want["correct"])
    np.testing.assert_array_equal(got["count"], want["count"])
    print(f"resnet train_many step {step}: {st['margins']}")  # shown with -s
    assert st["margins"].ok, st["margins"]


def test_resnet_eval_many_matches_jax(many):
    """Per-batch (num, den, correct) and the argmax predictions of every
    row, a mask-padded tail and the G-group padding included: the sums
    within rtol 1e-5, correct and the predictions equal."""
    (jnum, jden, jcorr, jpred), (num, den, corr, pred) = many["eval"]
    assert num.shape == (3,) and pred.shape == (3, 8)
    np.testing.assert_allclose(num, jnum, rtol=1e-5)
    np.testing.assert_allclose(den, jden, rtol=1e-5)
    np.testing.assert_array_equal(corr, jcorr)
    np.testing.assert_array_equal(pred, jpred)
    assert len(np.unique(pred)) > 1  # the predictions follow the input


# --- the trainer ------------------------------------------------------------------

@pytest.fixture(scope="module")
def seg_data(tmp_path_factory):
    """64 PCM16 clips of 0.5 s at 4 kHz: 44 train, 9 val."""
    return generate_segmented_dataset(tmp_path_factory.mktemp("seg4k"), per_class=16,
                                      duration=0.5, sample_rate=4000)


def resnet_config(tmp, name: str, **training) -> dict:
    """tests/test_torch_device_cache.py's tiny config with the ResNet (full
    depth) and 0.5 s clips: batch 4 x accumulation 2, 11 train batches an
    epoch (5 full groups and a tail group of one batch)."""
    return {
        "data": {"dataset_path": "unused", **SMALL_FE, "augmentation": True,
                 "train_split": 0.7, "val_split": 0.15, "cache_on_device": True},
        "model": {"architecture": "resnet", "num_classes": 4, "dropout": 0.1},
        "training": {"batch_size": 4, "epochs": 2, "learning_rate": 3e-3,
                     "weight_decay": 1e-4, "optimizer": "adam", "scheduler": "cosine",
                     "mixed_precision": False, "gradient_accumulation_steps": 2,
                     "early_stopping_patience": 50, "save_every": 2,
                     "checkpoint_dir": str(tmp / name / "ckpts"),
                     "log_dir": str(tmp / name / "runs"), **training},
        "classes": ["normal", "crackles", "wheezes", "both"],
        "seed": 0,
    }


def make_trainer(root, config):
    train = ICBHISegmentedDataset(root, "train", config, augment=True)
    val = ICBHISegmentedDataset(root, "val", config, augment=False)
    return Trainer(build_model(config), train, val, config, device="cpu")


def test_resnet_fused_epoch_matches_per_step(seg_data, tmp_path):
    """The ResNet's fused epoch (steps_per_dispatch 0: train_many over the
    epoch's 5 full groups, the tail group through train_step) trains as
    its per-step path on the cache does (steps_per_dispatch 1), over 2
    epochs with augmentation and the head's two dropouts on: train and val
    losses within rtol 1e-4, accuracies equal."""
    hists = {}
    for spd in (1, 0):
        t = make_trainer(seg_data, resnet_config(tmp_path, f"s{spd}", steps_per_dispatch=spd))
        assert isinstance(t.model, CompactResNet) and isinstance(t.train_loader,
                                                                 DeviceCachedLoader)
        assert t._use_multi_dispatch() == t._use_fused_eval() == (spd == 0)
        if spd == 0:
            calls = []
            many = t.steps.train_many
            t.steps = t.steps._replace(
                train_many=lambda *a: (calls.append((a[1].shape, a[6])), many(*a))[1])
        hists[spd] = t.train()
    assert calls == [((5, 2, 4), 0)] * 2
    for k in ("train_loss", "val_loss"):
        np.testing.assert_allclose(hists[0][k], hists[1][k], rtol=1e-4)
    np.testing.assert_allclose(hists[0]["train_acc"], hists[1]["train_acc"])
    np.testing.assert_allclose(hists[0]["val_acc"], hists[1]["val_acc"])


def test_resnet_fused_validation_matches_per_batch(seg_data, tmp_path):
    """The ResNet's fused validation against its per-batch validation on
    the seeded init with its BatchNorm statistics from 32 train clips
    (`calibrate_bn`, so that the classes part): loss (rel 1e-5), accuracy
    and val_predictions equal, in one eval_many call (batch 8: a full batch
    and a tail of one clip, padded to one group of G = 16)."""
    config = resnet_config(tmp_path, "v", epochs=1, batch_size=8, steps_per_dispatch=0)
    t = make_trainer(seg_data, config)
    t.collect_predictions = True
    calibrate_bn(t.model, t.frontend, torch.from_numpy(t.train_dataset.load_batch(range(32))[0]))
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
