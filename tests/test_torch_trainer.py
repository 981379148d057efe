"""The port's training loop and data pipeline against the JAX package's,
on the CPU: the loaders and dataset, the synthetic corpus, two trainers
running the same epochs, resuming across packages in either checkpoint
format, the train entry point and the options that once raised.

Both trainers start from the same weights (the JAX init carried across),
fp32, with augmentation off and dropout inert (an interceptor on the JAX
side, rate 0 on the port's), so their histories must agree.
"""

import os
import subprocess
import sys
from pathlib import Path

import flax.linen as nn
import jax
import numpy as np
import pytest
import torch

from audio_classification_icbhi_tpu.data.dataset import ICBHIDataset as JaxDataset
from audio_classification_icbhi_tpu.data.loader import BatchLoader as JaxLoader
from audio_classification_icbhi_tpu.data.synthetic import generate_icbhi_dataset as jax_generate
from audio_classification_icbhi_tpu.models import build_model as jax_build_model
from audio_classification_icbhi_tpu.ops import mel as jax_mel
from audio_classification_icbhi_tpu.parallel.mesh import get_mesh
from audio_classification_icbhi_tpu.training import schedules as jax_schedules
from audio_classification_icbhi_tpu.training import trainer as jax_trainer_mod
from audio_classification_icbhi_tpu.utils.icbhi_metrics import calculate_icbhi_score as jax_icbhi
from audio_classification_icbhi_tpu.utils.tensorboard import read_scalars
from audio_classification_icbhi_tpu_torch import train as port_train
from audio_classification_icbhi_tpu_torch.data.dataset import ICBHIDataset
from audio_classification_icbhi_tpu_torch.data.loader import BatchLoader
from audio_classification_icbhi_tpu_torch.data.synthetic import generate_icbhi_dataset
from audio_classification_icbhi_tpu_torch.models import build_model
from audio_classification_icbhi_tpu_torch.models.weights import state_dict_from_flax
from audio_classification_icbhi_tpu_torch.training import schedules
from audio_classification_icbhi_tpu_torch.training.trainer import Trainer
from audio_classification_icbhi_tpu_torch.training.trainer_icbhi import TrainerWithICBHI
from audio_classification_icbhi_tpu_torch.utils.checkpoint import (
    AsyncCheckpointWriter,
    latest_checkpoint,
    load_checkpoint,
    save_checkpoint,
)
from audio_classification_icbhi_tpu_torch.utils.config import load_config
from audio_classification_icbhi_tpu_torch.utils.icbhi_metrics import calculate_icbhi_score
from test_torch_train_step import no_dropout

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return generate_icbhi_dataset(tmp_path_factory.mktemp("synth"), num_recordings=12, seed=0)


def small_config(tmp: Path, name: str, epochs: int = 2) -> dict:
    config = load_config(str(REPO / "config.yaml"))
    config["data"].update(duration=1.0, augmentation=False)
    config["training"].update(batch_size=4, gradient_accumulation_steps=2, epochs=epochs,
                              mixed_precision=False, save_every=1,
                              checkpoint_dir=str(tmp / name / "ckpt"),
                              log_dir=str(tmp / name / "runs"))
    return config


# --- data ---------------------------------------------------------------------

class _Indexed:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.full(3, i, np.float32), i % 4


@pytest.mark.parametrize("shuffle, drop_last", [(True, True), (False, False)])
def test_batch_loader_same_batches_as_jax(shuffle, drop_last):
    kw = dict(shuffle=shuffle, drop_last=drop_last, seed=42)
    ours, theirs = BatchLoader(_Indexed(23), 4, **kw), JaxLoader(_Indexed(23), 4, **kw)
    assert len(ours) == len(theirs)
    for epoch in range(3):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        got = [(w.copy(), l.copy()) for w, l in ours]
        want = list(theirs)
        assert len(got) == len(want) > 0
        for (gw, gl), (ww, wl) in zip(got, want):
            np.testing.assert_array_equal(gw, ww)
            np.testing.assert_array_equal(gl, wl)


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_dataset_same_files_labels_and_split(corpus, split):
    config = {"data": {"sample_rate": 16000, "duration": 1.0}}
    ours, theirs = ICBHIDataset(corpus, split, config), JaxDataset(corpus, split, config)
    assert ours.data == theirs.data and len(ours) > 0
    np.testing.assert_array_equal(ours.labels, theirs.labels)
    idx = list(range(len(ours)))
    for a, b in zip(ours.load_batch(idx), theirs.load_batch(idx)):
        np.testing.assert_allclose(a, b, atol=1e-6)


@pytest.mark.parametrize("hard", [False, True])
def test_synthetic_corpus_byte_identical(tmp_path, hard):
    generate_icbhi_dataset(tmp_path / "port", num_recordings=3, seed=7, hard=hard)
    jax_generate(tmp_path / "jax", num_recordings=3, seed=7, hard=hard)
    ours = sorted((tmp_path / "port" / "audio_and_txt_files").iterdir())
    theirs = sorted((tmp_path / "jax" / "audio_and_txt_files").iterdir())
    assert [p.name for p in ours] == [p.name for p in theirs] and len(ours) == 6
    for a, b in zip(ours, theirs):
        assert a.read_bytes() == b.read_bytes()


@pytest.mark.parametrize("name", ["cosine", "step", "plateau", "constant", "warmup"])
def test_schedules_match_jax(name):
    def build(mod):
        kind = "cosine" if name == "warmup" else name
        return mod.build_scheduler(kind, 3e-3, 40, plateau_mode="max",
                                   warmup_epochs=3 if name == "warmup" else 0)

    ours, theirs = build(schedules), build(jax_schedules)
    metrics = [0.5, 0.6, 0.6, 0.55] * 10
    for mtr in metrics:
        assert ours.lr == theirs.lr
        ours.step(mtr)
        theirs.step(mtr)
    assert ours.state_dict() == theirs.state_dict()


def test_icbhi_score_matches_jax(rng):
    y_true, y_pred = rng.integers(0, 4, 50), rng.integers(0, 4, 50)
    assert calculate_icbhi_score(y_true, y_pred) == jax_icbhi(y_true, y_pred)


def test_async_writer_files_match_sync_saves(tmp_path):
    payload = {"epoch": 3, "params": {"w": torch.arange(6.0).reshape(2, 3)},
               "opt_state": {"0": {}, "1": {"count": np.asarray(2, np.int32)}},
               "config": {"a": 1}, "scheduler": {"epoch": 4}}
    sync = save_checkpoint(tmp_path / "sync.ckpt", payload)
    writer = AsyncCheckpointWriter()
    writer.save(tmp_path / "checkpoint_epoch_3.ckpt", payload)
    payload["params"]["w"].add_(1.0)  # a later in-place update must not reach the file
    writer.save(tmp_path / "checkpoint_epoch_12.ckpt", payload)
    writer.close()
    assert (tmp_path / "checkpoint_epoch_3.ckpt").read_bytes() == sync.read_bytes()
    assert latest_checkpoint(tmp_path).name == "checkpoint_epoch_12.ckpt"
    assert load_checkpoint(tmp_path / "checkpoint_epoch_12.ckpt")["params"]["w"][0, 0] == 1.0


# --- two trainers, one run ----------------------------------------------------

class _XlaFrontend(jax_mel.MelFrontend):
    """The JAX trainer's front end on its explicit f32 XLA path: on a CPU
    its auto path computes a bf16-split radix-2 DFT (ROADMAP.md C)."""

    @classmethod
    def from_config(cls, config, **overrides):
        return super().from_config(config, backend="xla", **overrides)


def _jax_trainer(config, corpus, monkeypatch):
    monkeypatch.setattr(jax_trainer_mod, "MelFrontend", _XlaFrontend)
    train = JaxDataset(corpus, "train", config)
    val = JaxDataset(corpus, "val", config)
    return jax_trainer_mod.Trainer(jax_build_model(config), train, val, config,
                                   mesh=get_mesh(num_devices=1))


def _port_trainer(config, corpus, variables):
    trainer = Trainer(build_model(config), ICBHIDataset(corpus, "train", config),
                      ICBHIDataset(corpus, "val", config), config, device="cpu")
    trainer.model.load_state_dict(state_dict_from_flax(variables))
    trainer.model.set_dropout(0.0)
    return trainer


def _cross_package_runs(corpus, tmp: Path, fmt: str) -> dict:
    """The JAX trainer and the port's, 2 epochs each from the same weights,
    each writing `fmt` checkpoints, then each resumed from the other's
    epoch-1 checkpoint for epoch 2."""

    def config(name):
        c = small_config(tmp, name)
        c["training"]["checkpoint_format"] = fmt
        return c

    mp = pytest.MonkeyPatch()
    try:
        jt = _jax_trainer(config("jax"), corpus, mp)
        variables = {"params": jax.tree_util.tree_map(np.asarray, jt.params),
                     "batch_stats": jax.tree_util.tree_map(np.asarray, jt.batch_stats)}
        with nn.intercept_methods(no_dropout):
            jax_history = jt.train()
        pt = _port_trainer(config("port"), corpus, variables)
        port_history = pt.train()

        # the port resumes from the JAX trainer's epoch-1 checkpoint
        resumed = _port_trainer(config("port_from_jax"), corpus, variables)
        port_resumed = resumed.train(resume_from=str(tmp / "jax" / "ckpt" / "checkpoint_epoch_1.ckpt"))
        # the JAX trainer resumes from the port's
        jr = _jax_trainer(config("jax_from_port"), corpus, mp)
        with nn.intercept_methods(no_dropout):
            jax_resumed = jr.train(resume_from=str(tmp / "port" / "ckpt" / "checkpoint_epoch_1.ckpt"))
    finally:
        mp.undo()
    return dict(tmp=tmp, jax=jax_history, port=port_history, port_resumed=port_resumed,
                jax_resumed=jax_resumed)


@pytest.fixture(scope="module")
def runs(corpus, tmp_path_factory):
    return _cross_package_runs(corpus, tmp_path_factory.mktemp("runs"), "msgpack")


@pytest.fixture(scope="module")
def orbax_runs(corpus, tmp_path_factory):
    return _cross_package_runs(corpus, tmp_path_factory.mktemp("orbax_runs"), "orbax")


def _assert_history_close(got, want, epochs=slice(None)):
    for k in ("train_loss", "val_loss", "train_acc", "val_acc"):
        np.testing.assert_allclose(got[k], want[k][epochs], rtol=1e-3, atol=1e-6, err_msg=k)


def test_two_trainers_same_history(runs):
    assert len(runs["port"]["train_loss"]) == 2
    _assert_history_close(runs["port"], runs["jax"])
    assert runs["port"]["train_loss"][1] != runs["port"]["train_loss"][0]


def test_tensorboard_tags_match(runs):
    def tags(name):
        (event,) = (runs["tmp"] / name / "runs").glob("events.out.tfevents.*")
        return read_scalars(event)

    ours, theirs = tags("port"), tags("jax")
    assert set(ours) == set(theirs) == {"Loss/train", "Loss/val", "Accuracy/train",
                                         "Accuracy/val", "Learning_Rate"}
    for tag in ours:
        assert [s for s, _ in ours[tag]] == [s for s, _ in theirs[tag]] == [0, 1]
        np.testing.assert_allclose([v for _, v in ours[tag]], [v for _, v in theirs[tag]],
                                   rtol=1e-3)


@pytest.mark.parametrize("fmt", ["msgpack", "orbax"])
def test_port_resumes_from_jax_checkpoint(runs, request, fmt):
    """Epoch 2 of the port resumed from the JAX trainer's epoch-1 checkpoint
    (a msgpack file, or an orbax directory) matches epoch 2 of both
    uninterrupted runs."""
    got = runs if fmt == "msgpack" else request.getfixturevalue("orbax_runs")
    ckpt = got["tmp"] / "jax" / "ckpt" / "checkpoint_epoch_1.ckpt"
    assert ckpt.is_dir() == (fmt == "orbax")
    assert len(got["port_resumed"]["train_loss"]) == 1
    _assert_history_close(got["port_resumed"], runs["jax"], epochs=slice(1, 2))
    _assert_history_close(got["port_resumed"], runs["port"], epochs=slice(1, 2))


@pytest.mark.parametrize("fmt", ["msgpack", "orbax"])
def test_jax_resumes_from_port_checkpoint(runs, request, fmt):
    got = runs if fmt == "msgpack" else request.getfixturevalue("orbax_runs")
    ckpt = got["tmp"] / "port" / "ckpt" / "checkpoint_epoch_1.ckpt"
    assert ckpt.is_dir() == (fmt == "orbax")
    assert len(got["jax_resumed"]["train_loss"]) == 1
    _assert_history_close(got["jax_resumed"], runs["port"], epochs=slice(1, 2))


def test_checkpoint_payload_matches_jax_keys(runs):
    ours = load_checkpoint(runs["tmp"] / "port" / "ckpt" / "best_model.ckpt")
    theirs = load_checkpoint(runs["tmp"] / "jax" / "ckpt" / "best_model.ckpt")
    assert set(ours) == set(theirs)
    assert ours["scheduler"] == theirs["scheduler"] and ours["epoch"] == theirs["epoch"]
    assert jax.tree_util.tree_structure(ours["opt_state"]) == \
        jax.tree_util.tree_structure(theirs["opt_state"])


def test_icbhi_trainer_selects_on_icbhi_score(corpus, tmp_path):
    config = small_config(tmp_path, "icbhi", epochs=1)
    trainer = TrainerWithICBHI(build_model(config), ICBHIDataset(corpus, "train", config),
                               ICBHIDataset(corpus, "val", config), config, device="cpu")
    history = trainer.train()
    assert len(history["icbhi_score"]) == 1 and trainer.best_icbhi_score == history["icbhi_score"][0]
    ckpt = load_checkpoint(Path(config["training"]["checkpoint_dir"]) / "best_model.ckpt")
    assert ckpt["icbhi_score"] == history["icbhi_score"][0]
    assert set(ckpt["icbhi_metrics"]) == {"avg_sensitivity", "avg_specificity"}


# --- entry point and options ---------------------------------------------------

def test_train_entry_point_runs_on_cpu(corpus, tmp_path):
    import yaml

    config = small_config(tmp_path, "entry", epochs=1)
    (tmp_path / "c.yaml").write_text(yaml.safe_dump(config))
    # the history PNG lands in the working directory, as the JAX script's
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run(
        [sys.executable, "-m", "audio_classification_icbhi_tpu_torch.train", "--config",
         str(tmp_path / "c.yaml"), "--data-path", str(corpus), "--device", "cpu", "--epochs", "1"],
        capture_output=True, text=True, timeout=300, cwd=str(tmp_path), env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "Training completed" in out.stdout
    assert (tmp_path / "entry" / "ckpt" / "best_model.ckpt").exists()
    assert "Training history saved to training_history.png" in out.stdout
    assert (tmp_path / "training_history.png").stat().st_size > 5000


def test_train_entry_point_needs_a_gpu_by_default(corpus, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_train.main(["--data-path", str(corpus), "--epochs", "1"])


@pytest.mark.parametrize("steps_per_dispatch", [None])
def test_cache_options_now_run(corpus, tmp_path, steps_per_dispatch):
    """data.cache_on_device (and training.steps_per_dispatch), which raised
    until the device cache and the fused epoch were ported, train through
    `train.main` on the CPU: the fused epoch (steps_per_dispatch absent:
    the whole epoch a call; the per-step path on the cache is
    tests/test_torch_device_cache.py's reference). The best checkpoint of
    one epoch, resumed, gives the uninterrupted run's second epoch."""
    import yaml

    def run(name, epochs, *extra):
        config = small_config(tmp_path, name, epochs=2)
        config["data"]["cache_on_device"] = True
        config["training"]["batch_size"] = 2  # 8 train clips: 2 groups of 2 batches
        if steps_per_dispatch is not None:
            config["training"]["steps_per_dispatch"] = steps_per_dispatch
        (tmp_path / f"{name}.yaml").write_text(yaml.safe_dump(config))
        return port_train.main(["--config", str(tmp_path / f"{name}.yaml"), "--data-path",
                                str(corpus), "--device", "cpu", "--no-plots",
                                "--epochs", str(epochs), *extra])

    whole = run("whole", 2)
    first = run("first", 1)
    best = tmp_path / "first" / "ckpt" / "best_model.ckpt"
    assert best.exists() and len(first["train_loss"]) == 1
    np.testing.assert_allclose(first["train_loss"], whole["train_loss"][:1], rtol=1e-6)
    resumed = run("first", 2, "--resume", str(best))
    assert len(resumed["train_loss"]) == 1
    for k in ("train_loss", "val_loss", "train_acc", "val_acc"):
        np.testing.assert_allclose(resumed[k], whole[k][1:], rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("key, value", [("pretrained", True), ("architecture", "resnet")])
def test_model_options_now_run(corpus, tmp_path, key, value):
    """model.pretrained (a seeded LightweightCNN .pt) and model.architecture:
    resnet, which raised until CompactResNet18 was ported, each train one
    epoch on the CPU and write a best checkpoint."""
    config = small_config(tmp_path, key, epochs=1)
    config["model"][key] = value
    if key == "pretrained":
        sd = build_model(config, generator=torch.Generator().manual_seed(9)).state_dict()
        config["model"]["pretrained_path"] = str(tmp_path / "cnn.pt")
        torch.save({"model_state_dict": sd}, config["model"]["pretrained_path"])
    trainer = Trainer(build_model(config), ICBHIDataset(corpus, "train", config),
                      ICBHIDataset(corpus, "val", config), config, device="cpu")
    if key == "pretrained":
        got = trainer.model.state_dict()
        assert all(torch.equal(got[k], v) for k, v in sd.items())
    history = trainer.train()
    assert len(history["train_loss"]) == 1 and np.isfinite(history["train_loss"][0])
    assert (tmp_path / key / "ckpt" / "best_model.ckpt").exists()