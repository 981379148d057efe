"""CompactResNet18 trained and served by the port against the JAX package,
on the CPU: the train step, the optimizer state crossing by name, a
JAX-written ResNet checkpoint served, resumed and analyzed by the port, and
a port-written one resumed in the port with the JAX package's tree.

Weights come from a flax init (`test_torch_resnet.flax_resnet_variables`)
carried across with state_dict_from_flax; inputs are made with numpy from a
seed. Dropout is inert where two steps are compared: an interceptor on the
JAX side, rate 0 on the port's.
"""

from pathlib import Path

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from audio_classification_icbhi_tpu.inference import ClassifierEngine as JaxEngine
from audio_classification_icbhi_tpu.models.resnet import CompactResNet as FlaxResNet
from audio_classification_icbhi_tpu.ops import mel as jax_mel
from audio_classification_icbhi_tpu.parallel import data_parallel as jax_dp
from audio_classification_icbhi_tpu.parallel.mesh import get_mesh
from audio_classification_icbhi_tpu.training.optimizers import build_optimizer as jax_optimizer
from audio_classification_icbhi_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from audio_classification_icbhi_tpu_torch.data.dataset import ICBHIDataset
from audio_classification_icbhi_tpu_torch.data.synthetic import (
    generate_icbhi_dataset,
    synth_respiratory_cycle,
)
from audio_classification_icbhi_tpu_torch.inference import ClassifierEngine
from audio_classification_icbhi_tpu_torch.models import CompactResNet, build_model
from audio_classification_icbhi_tpu_torch.models.weights import (
    flax_from_state_dict,
    opt_state_from_optax,
    optax_from_opt_state,
    params_from_flax,
    state_dict_from_flax,
)
from audio_classification_icbhi_tpu_torch.ops import mel as port_mel
from audio_classification_icbhi_tpu_torch.ops.golden import golden_mel
from audio_classification_icbhi_tpu_torch.ops.mel import normalize_spectrogram
from audio_classification_icbhi_tpu_torch.parallel import data_parallel as port_dp
from audio_classification_icbhi_tpu_torch.step_floor import step_floor, step_margins
from audio_classification_icbhi_tpu_torch.training.optimizers import build_optimizer
from audio_classification_icbhi_tpu_torch.training.trainer import Trainer
from audio_classification_icbhi_tpu_torch.utils.checkpoint import load_checkpoint
from audio_classification_icbhi_tpu_torch.utils.config import load_config
from test_torch_analyzers import jax_engine as jax_analyzer
from test_torch_analyzers import port_engine as port_analyzer
from test_torch_resnet import flax_resnet_variables, host
from test_torch_train_step import CW, SMALL_FE, assert_trees_close, no_dropout

REPO = Path(__file__).resolve().parent.parent
SR = 16000


# --- the train step ------------------------------------------------------------

def leaves(tree) -> list[np.ndarray]:
    return [np.asarray(x, np.float64) for x in jax.tree_util.tree_leaves(tree)]


port_dp_loss = port_dp.weighted_cross_entropy


def per_shard_mean_loss(logits, labels, class_weights, mask=None):
    """A faulty loss: each half of the microbatch (a rank's shard under
    DDP) takes its own weighted mean and the step averages the two, where
    the reference takes the ratio of the batch's global sums
    (`parallel/data_parallel.py:37-49` of the JAX package). Returned as
    (loss, 1) so that the step's num / den is that mean."""
    halves = zip(logits.chunk(2), labels.chunk(2))
    ratios = [num / den for num, den in (port_dp_loss(lg, lb, class_weights) for lg, lb in halves)]
    return sum(ratios) / len(ratios), torch.ones(())


@pytest.fixture(scope="module")
def resnet_steps():
    """(mode, groups) -> one optimizer step of each package from the same
    weights and inputs, full depth, fp32, no augmentation, SGD (momentum
    0.9, L2 1e-4) at lr 1 so that the parameter change is the accumulated,
    clipped gradient itself; with the port's own step again under eight
    perturbed front ends (`step_floor.step_floor`) and with the
    faulty loss above. Memoized: the JAX step compiles once a mode."""
    done = {}

    def run(mode, groups):
        if (mode, groups) in done:
            return done[mode, groups]
        rng = np.random.default_rng(42)
        a, b = groups, 8
        jfe = jax_mel.MelFrontend(backend="xla", **SMALL_FE)
        pfe = port_mel.MelFrontend(**SMALL_FE)
        v = flax_resnet_variables((2, 2, 2, 2), (1, 32, pfe.num_frames, 1), head=1.0)
        wavs = (0.3 * rng.standard_normal((a, b, pfe.target_length))).astype(np.float32)
        labels = rng.integers(0, 4, (a, b)).astype(np.int32)
        tx = jax_optimizer("sgd", 1e-4)
        steps = jax_dp.make_step_fns(FlaxResNet(num_classes=4), jfe, tx,
                                     get_mesh(num_devices=1), accum_steps=2, accum_mode=mode)
        copy = lambda t: jax.tree_util.tree_map(jnp.array, t)  # noqa: E731 (donated args)
        with nn.intercept_methods(no_dropout):
            p, bs, _, m = steps.train_step(copy(v["params"]), copy(v["batch_stats"]),
                                           tx.init(copy(v["params"])), wavs, labels, CW,
                                           np.float32(1.0), jax.random.PRNGKey(3))

        def port_step(frontend):
            model = CompactResNet()
            model.load_state_dict(state_dict_from_flax(v))
            model.set_dropout(0.0)
            opt = build_optimizer("sgd", model.named_parameters(), 1e-4)
            fns = port_dp.make_step_fns(model, frontend, opt, accum_steps=2, accum_mode=mode)
            metrics = fns.train_step(torch.from_numpy(wavs), torch.from_numpy(labels).long(),
                                     torch.from_numpy(CW), 1.0)
            return metrics, flax_from_state_dict(model.state_dict())

        def leaf_step(frontend):
            metrics, out = port_step(frontend)
            return leaves(out["params"]), float(metrics["grad_norm"])

        got, out = port_step(pfe)
        base = (leaves(out["params"]), float(got["grad_norm"]))
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(port_dp, "weighted_cross_entropy", per_shard_mean_loss)
            faulty = leaf_step(pfe)
        done[mode, groups] = dict(
            jax=((leaves(host(p)), float(m["grad_norm"])), m, host(bs)),
            port=(base, got, out), faulty=faulty,
            floor=step_floor(leaf_step, pfe, base))
        return done[mode, groups]

    return run


@pytest.mark.parametrize("mode, groups", [("scan", 2), ("parallel", 1)])
def test_train_step_matches_jax(resnet_steps, mode, groups):
    """One optimizer step of each package (see `resnet_steps`): loss rtol
    1e-5 and BN statistics rtol 1e-4 / atol 1e-6, as
    test_torch_train_step.test_train_step_matches_jax.

    The params and the global gradient norm are held by
    `step_floor` (the bound chip_smoke.py's phases 8 and 20 hold
    the card to): 2e-3 |p| plus max(2e-5, twice the floor of the parameter
    tensor), the floor being the element-wise maximum over perturbation
    seeds 0-7 of how far a front end 1e-5 dB off moves the port's own step,
    at its largest in the tensor; and rtol 1e-5 or twice the same floor
    for the norm. The flat 2e-5 of the LightweightCNN test is missed at this depth:
    a ReLU input of layer4.0 lies within the packages' rounding difference
    (~3e-5) of zero and takes either side, and its unit's gradient reaches
    every earlier layer through a BatchNorm channel of near-zero batch
    variance (16 values at 1 x 2), moving their gradients by 1.3-1.9 %.
    Whether one perturbation flips that input depends on its draw (at
    scan-2 seed 5 moves the step by 8.7e-8, seeds 0-4 by 6.5e-4-1.8e-3), so
    the floor takes every seed's."""
    run = resnet_steps(mode, groups)
    want, m, bs = run["jax"]
    base, got, out = run["port"]
    np.testing.assert_allclose(float(got["loss"]), float(m["loss"]), rtol=1e-5)
    assert float(got["correct"]) == float(m["correct"])
    assert_trees_close(out["batch_stats"], bs, rtol=1e-4, atol=1e-6)
    margins = step_margins(base, want, run["floor"])
    print(f"{mode}-{groups}: {margins}")  # shown with -s
    assert margins.ok, margins


@pytest.mark.parametrize("mode, groups", [("scan", 2), ("parallel", 1)])
def test_step_bound_rejects_per_shard_loss_mean(resnet_steps, mode, groups):
    """The multi-seed floor still bites: a port step whose loss averages
    per-shard weighted means (`per_shard_mean_loss`) instead of taking the
    ratio of global sums fails the params check of
    test_train_step_matches_jax by far (24x and 266x its bound at scan-2
    and parallel-1 on the CPU)."""
    run = resnet_steps(mode, groups)
    margins = step_margins(run["faulty"], run["jax"][0], run["floor"])
    print(f"{mode}-{groups} per-shard mean: {margins}")  # shown with -s
    assert margins.params > 10.0, margins


def test_adam_state_crosses_by_name(rng):
    """Three Adam steps with weight decay equal the optax chain within 1e-6
    through the optimizer built over named parameters, and the state
    crosses optax -> torch -> optax exactly, matched by name: flax's tree
    order and the module's named_parameters() order differ."""
    v = flax_resnet_variables((1, 1), (1, 32, 24, 1), head=1.0)
    tx = jax_optimizer("adam", 1e-4)
    params, state = v["params"], tx.init(v["params"])
    model = CompactResNet(stage_sizes=(1, 1))
    model.load_state_dict(state_dict_from_flax(v))
    opt = build_optimizer("adam", model.named_parameters(), 1e-4)
    names = [n for n, _ in model.named_parameters()]
    assert list(params_from_flax(params)) == names
    # flax's leaves come in sorted key order (Dense_0 first), torch's from the stem
    first = jax.tree_util.tree_flatten_with_path(params)[0][0][0]
    assert first[0].key == "Dense_0" and names[0] == "resnet.conv1.weight"
    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda x: (0.1 * rng.standard_normal(x.shape)).astype(np.float32), params)
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, jax.tree_util.tree_map(lambda u: -3e-3 * u, updates))
        named = params_from_flax(grads)
        for n, prm in model.named_parameters():
            prm.grad = named[n]
        for group in opt.param_groups:
            group["lr"] = 3e-3
        opt.step()
    assert_trees_close(flax_from_state_dict(model.state_dict())["params"], host(params),
                       rtol=1e-6, atol=1e-6)
    want = host(serialization.to_state_dict(state))
    assert_trees_close(optax_from_opt_state(opt, "adam"), want, rtol=1e-6, atol=1e-6)

    fresh = build_optimizer("adam", model.named_parameters(), 1e-4)
    fresh.load_state_dict({"state": opt_state_from_optax(want, list(model.named_parameters()),
                                                         "adam"),
                           "param_groups": fresh.state_dict()["param_groups"]})
    assert_trees_close(optax_from_opt_state(fresh, "adam"), want, rtol=0, atol=0)
    # an unnamed optimizer over ResNet's parameters cannot be mapped by name
    with pytest.raises(ValueError, match="named_parameters"):
        optax_from_opt_state(build_optimizer("adam", model.parameters()), "adam")
    # nor a state of another model's parameters
    with pytest.raises(ValueError, match="missing"):
        opt_state_from_optax(want, list(CompactResNet(stage_sizes=(1,)).named_parameters()),
                             "adam")


# --- checkpoints written by the JAX package ------------------------------------

def resnet_config(duration: float = 1.0) -> dict:
    config = load_config(str(REPO / "config.yaml"))
    config["model"]["architecture"] = "resnet"
    config["data"]["duration"] = duration
    config["training"]["mixed_precision"] = False
    return config


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    """A ResNet checkpoint written by the JAX package's save_checkpoint: a
    flax init with non-trivial BN statistics and a x30 head, and the Adam
    state of one optax update, as its trainer writes them."""
    config = resnet_config(duration=5.0)
    v = flax_resnet_variables((2, 2, 2, 2), (1, 128, 157, 1))
    tx = jax_optimizer("adam", config["training"]["weight_decay"])
    grads = jax.tree_util.tree_map(lambda x: np.full(x.shape, 1e-3, np.float32), v["params"])
    _, state = tx.update(grads, tx.init(v["params"]), v["params"])
    path = tmp_path_factory.mktemp("resnet") / "jax.ckpt"
    return jax_save_checkpoint(path, {
        "epoch": 0, "params": v["params"], "batch_stats": v["batch_stats"],
        "opt_state": host(state), "val_loss": 0.5, "config": config,
        "scheduler": {"epoch": 1}, "best_metric": 0.5, "patience_counter": 0})


def golden_probs(jax_classifier, wavs: np.ndarray, n_fft: int, hop: int, frames: int):
    """The JAX package's model (its engine's flax apply) on the float64
    golden log-mel of `wavs`, resized to `frames` as its analyzer resizes
    (jax.image.resize, bilinear) and normalized: the function both engines
    compute, without either front end's float32 error."""
    mel = np.stack([golden_mel(w.astype(np.float64), SR, n_fft, hop, 128) for w in wavs])
    if mel.shape[-1] != frames:
        mel = np.asarray(jax.image.resize(jnp.asarray(mel, jnp.float32),
                                          mel.shape[:-1] + (frames,), method="bilinear"))
    feats = normalize_spectrogram(torch.from_numpy(np.asarray(mel, np.float64))).float().numpy()
    variables = {"params": jax_classifier.params, "batch_stats": jax_classifier.batch_stats}
    logits = jax_classifier.model.apply(variables, jnp.asarray(feats)[..., None], train=False)
    return np.asarray(jax.nn.softmax(logits, axis=-1))


def test_jax_checkpoint_served_by_port(jax_ckpt):
    """The port's ClassifierEngine serves the JAX-written ResNet checkpoint
    on test_torch_engine's clips (5 s; batch 5 at batch_size 4 pads the last
    chunk): its probabilities are within 1e-4 of the JAX package's model on
    the float64 golden log-mel, and of the JAX engine at fp32 (front end on
    its f32 XLA path, ROADMAP.md C) within 1e-4 plus that engine's own
    distance from the golden-fed model. The JAX engine misses 1e-4 by
    itself: its f32 log-mel is up to 11.3 dB off the golden in cells ~126 dB
    below their clip's peak (the port's: 0.32 dB), which this x30 head
    (max |logit| 17) turns into 5.2e-4 in probability (the port: 2.0e-5)."""
    rng = np.random.default_rng(11)
    wavs = np.stack([synth_respiratory_cycle(rng, i % 4, 5.0, SR) for i in range(5)]
                    ).astype(np.float32)
    jax_engine = JaxEngine(jax_ckpt, batch_size=4)
    jax_engine.frontend = jax_mel.MelFrontend.from_config(jax_engine.config, backend="xla")
    want = jax_engine.predict_probs(wavs)
    golden = golden_probs(jax_engine, wavs, 2048, 512, 157)
    engine = ClassifierEngine(jax_ckpt, batch_size=4, device="cpu")
    assert isinstance(engine.model, CompactResNet)
    got = engine.predict_probs(wavs)
    assert float(np.abs(golden - golden.mean(0)).max()) > 1e-2  # the classes spread
    np.testing.assert_allclose(got, golden, atol=1e-4)
    np.testing.assert_allclose(got, want, atol=1e-4 + float(np.abs(want - golden).max()))
    assert engine.describe()["parameters"] == 11_302_596


@pytest.mark.parametrize("segment_duration", [0.25, 0.5])
def test_analyzer_serves_resnet(jax_ckpt, segment_duration, tmp_path):
    """The port's analyzer on the JAX-written ResNet checkpoint: window
    probabilities within 1e-4 of the JAX package's model on the golden
    log-mel at the analyzer's front end (n_fft 1024, hop 256; 16 frames
    resized to 32 at 0.25 s), and of the JAX analyzer within 1e-4 plus that
    analyzer's own distance from the golden-fed model (see above)."""
    rng = np.random.default_rng(17)
    audio = np.concatenate([synth_respiratory_cycle(rng, c, 1.5, SR) for c in range(4)])
    jeng = jax_analyzer(str(jax_ckpt), segment_duration, mixed_precision=False)
    peng = port_analyzer(str(jax_ckpt), segment_duration)
    windows, _, _ = peng.segment_audio(audio.astype(np.float32))
    got, want = peng.predict_window_probs(windows), jeng.predict_window_probs(windows)
    fe = peng.frontend
    golden = golden_probs(jeng.classifier, windows, fe.n_fft, fe.hop_length,
                          fe.target_time_steps)
    assert got.shape == (len(windows), 4) and len(windows) > 20
    np.testing.assert_allclose(got, golden, atol=1e-4)
    np.testing.assert_allclose(got, want, atol=1e-4 + float(np.abs(want - golden).max()))


def test_jax_checkpoint_resumes_in_port(jax_ckpt, tmp_path):
    """Trainer.restore on the JAX-written file: the weights, the BN
    statistics and the Adam state come back, matched by name."""
    corpus = generate_icbhi_dataset(tmp_path / "corpus", num_recordings=4, seed=0)
    config = resnet_config()
    config["training"].update(checkpoint_dir=str(tmp_path / "ckpt"), log_dir=str(tmp_path / "runs"))
    trainer = Trainer(build_model(config), ICBHIDataset(corpus, "train", config),
                      ICBHIDataset(corpus, "val", config), config, device="cpu")
    trainer.restore(jax_ckpt)
    ckpt = load_checkpoint(jax_ckpt)
    assert trainer.start_epoch == 1
    got = flax_from_state_dict(trainer.model.state_dict())
    assert_trees_close(got, {"params": ckpt["params"], "batch_stats": ckpt["batch_stats"]},
                       rtol=0, atol=0)
    assert_trees_close(optax_from_opt_state(trainer.optimizer, "adam"), ckpt["opt_state"],
                       rtol=0, atol=0)


# --- a checkpoint written by the port ------------------------------------------

def test_port_checkpoint_resumes_in_port(tmp_path):
    """Two epochs of the port's trainer at stage_sizes (1, 1); a second
    trainer resumed from the epoch-1 checkpoint repeats epoch 2. The file
    holds the JAX package's tree: params and batch_stats as flax's init
    names them, and the optax Adam chain's state."""
    corpus = generate_icbhi_dataset(tmp_path / "corpus", num_recordings=12, seed=0)

    def trainer(name):
        config = resnet_config()
        config["data"]["augmentation"] = False
        config["training"].update(batch_size=4, epochs=2, save_every=1,
                                  checkpoint_dir=str(tmp_path / name / "ckpt"),
                                  log_dir=str(tmp_path / name / "runs"))
        return Trainer(CompactResNet(stage_sizes=(1, 1)), ICBHIDataset(corpus, "train", config),
                       ICBHIDataset(corpus, "val", config), config, device="cpu")

    whole = trainer("whole").train()
    ckpt_path = tmp_path / "whole" / "ckpt" / "checkpoint_epoch_1.ckpt"
    resumed = trainer("resumed").train(resume_from=str(ckpt_path))
    assert len(resumed["train_loss"]) == 1
    for k in ("train_loss", "val_loss", "train_acc", "val_acc"):
        np.testing.assert_allclose(resumed[k], whole[k][1:], rtol=1e-6, err_msg=k)

    ckpt = load_checkpoint(ckpt_path)
    v = FlaxResNet(num_classes=4, stage_sizes=(1, 1)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 128, 32, 1)), train=False)
    assert jax.tree_util.tree_structure(ckpt["params"]) == \
        jax.tree_util.tree_structure(host(v["params"]))
    assert jax.tree_util.tree_structure(ckpt["batch_stats"]) == \
        jax.tree_util.tree_structure(host(v["batch_stats"]))
    tx = jax_optimizer("adam", 1e-4)
    assert jax.tree_util.tree_structure(ckpt["opt_state"]) == jax.tree_util.tree_structure(
        host(serialization.to_state_dict(tx.init(v["params"]))))
