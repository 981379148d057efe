"""The mesh helpers, the train entry's data-parallel flags and the sharded
analyzer, on the CPU.

- `python -m audio_classification_icbhi_tpu_torch.train --multihost
  --coordinator 127.0.0.1:PORT --num-processes 1 --process-id 0` (a gloo
  group of one, as tests/test_distributed.py:33 runs the JAX entry) trains
  as the same run without a group does;
- `--device cpu --num-devices 2` starts two gloo ranks, whose loss history
  matches the 1-rank run's within 2e-4 (CompactResNet18 with its dropout
  at 0 and no augmentation, so that no draw depends on the rank), and only
  rank 0 writes;
- the trainer refuses a mesh its model's BatchNorm does not span, and a
  batch the ranks do not divide, as the JAX trainer does;
- each rank's loader decodes only its own rows of the shared batches;
- `AnalyzerEngine(devices=...)` over 2 and 3 CPU entries against the JAX
  engine on a 2- and 3-device mesh, and against itself on one device.
"""

import argparse
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from audio_classification_icbhi_tpu.parallel.mesh import get_mesh as jax_mesh
from audio_classification_icbhi_tpu_torch import train as port_train
from audio_classification_icbhi_tpu_torch.data.dataset import ICBHIDataset
from audio_classification_icbhi_tpu_torch.data.loader import BatchLoader
from audio_classification_icbhi_tpu_torch.data.synthetic import generate_icbhi_dataset
from audio_classification_icbhi_tpu_torch.models import build_model
from audio_classification_icbhi_tpu_torch.parallel.mesh import (
    Mesh,
    free_port,
    get_mesh,
    init_distributed,
    local_batch_slice,
    shard_batch,
)
from audio_classification_icbhi_tpu_torch.training.trainer import Trainer
from audio_classification_icbhi_tpu_torch.utils.checkpoint import load_checkpoint
from audio_classification_icbhi_tpu_torch.utils.config import load_config
from audio_classification_icbhi_tpu_torch.utils.tensorboard import read_scalars
from test_torch_analyzers import _checkpoint, jax_engine, port_engine, recording  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
TAGS = ("Loss/train", "Loss/val", "Accuracy/train", "Accuracy/val")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return generate_icbhi_dataset(tmp_path_factory.mktemp("mh"), num_recordings=24,
                                  cycles_per_recording=2, sample_rate=4000, seed=1)


def entry_config(tmp: Path, name: str, architecture: str, **training) -> Path:
    """config.yaml at a 4 kHz, 0.8 s front end, batch 8, fp32, SGD, two
    epochs; the ResNet's dropout at 0; `training` over the training keys."""
    import yaml

    config = load_config(str(REPO / "config.yaml"))
    config["data"].update(sample_rate=4000, n_mels=32, n_fft=256, hop_length=64, duration=0.8,
                          augmentation=False)
    config["model"].update(architecture=architecture,
                           dropout=0.0 if architecture == "resnet" else 0.3)
    config["training"].update(batch_size=8, gradient_accumulation_steps=2, epochs=2,
                              mixed_precision=False, optimizer="sgd", learning_rate=0.01,
                              scheduler="cosine", save_every=1,
                              checkpoint_dir=str(tmp / name / "ckpt"),
                              log_dir=str(tmp / name / "runs"), **training)
    path = tmp / f"{name}.yaml"
    path.write_text(yaml.safe_dump(config))
    return path


def entry(config: Path, corpus: Path, *flags: str, cwd: Path) -> str:
    """The train entry as a subprocess on the CPU; its stdout."""
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run(
        [sys.executable, "-m", "audio_classification_icbhi_tpu_torch.train", "--config",
         str(config), "--data-path", str(corpus), "--device", "cpu", "--no-plots", *flags],
        capture_output=True, text=True, timeout=400, cwd=str(cwd), env=env)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    return out.stdout


def history(run_dir: Path) -> dict:
    """The run's TensorBoard scalars; exactly one events file (rank 0's)."""
    (events,) = (run_dir / "runs").glob("events.out.tfevents.*")
    return {tag: [v for _, v in values] for tag, values in read_scalars(events).items()}


def assert_same_history(got: dict, want: dict) -> None:
    for tag in TAGS:
        assert len(got[tag]) == len(want[tag]) == 2, tag
        np.testing.assert_allclose(got[tag], want[tag], rtol=2e-4, atol=1e-6, err_msg=tag)


def test_multihost_flag_one_process(corpus, tmp_path):
    """--multihost with a coordinator and one process: the run joins a
    gloo group of one (cross-rank BatchNorm and the collectives at world
    size 1), trains as the run without a group does, and resumes."""
    config = entry_config(tmp_path, "group", "cnn")
    port = free_port()
    out = entry(config, corpus, "--multihost", "--coordinator", f"127.0.0.1:{port}",
                "--num-processes", "1", "--process-id", "0", cwd=tmp_path)
    assert "Distributed: process 0" in out and "Mesh: 1 device(s)" in out
    assert (tmp_path / "group" / "ckpt" / "best_model.ckpt").exists()
    plain = entry_config(tmp_path, "plain", "cnn")
    port_train.main(["--config", str(plain), "--data-path", str(corpus), "--device", "cpu",
                     "--no-plots"])
    assert_same_history(history(tmp_path / "group"), history(tmp_path / "plain"))
    # and it resumes in a group: every rank reads the file after a barrier,
    # the restored state broadcast from rank 0
    out = entry(config, corpus, "--epochs", "3", "--resume",
                str(tmp_path / "group" / "ckpt" / "checkpoint_epoch_2.ckpt"), "--multihost",
                "--coordinator", f"127.0.0.1:{free_port()}", "--num-processes", "1",
                "--process-id", "0", cwd=tmp_path)
    assert "Resumed from" in out and "Epoch 3/3" in out


def test_two_ranks_match_one_rank(corpus, tmp_path):
    """--num-devices 2 starts two gloo ranks: rank 0 alone writes the
    events and checkpoints, and the history is the 1-rank run's."""
    config = entry_config(tmp_path, "two", "resnet")
    out = entry(config, corpus, "--num-devices", "2", cwd=tmp_path)
    assert "Distributed: process 0" in out and "Distributed: process 1" in out
    assert "Mesh: 2 device(s)" in out
    assert sorted(p.name for p in (tmp_path / "two" / "ckpt").iterdir()) == [
        "best_model.ckpt", "checkpoint_epoch_1.ckpt", "checkpoint_epoch_2.ckpt"]
    one = entry_config(tmp_path, "one", "resnet")
    port_train.main(["--config", str(one), "--data-path", str(corpus), "--device", "cpu",
                     "--no-plots"])
    assert_same_history(history(tmp_path / "two"), history(tmp_path / "one"))


def test_two_ranks_write_and_resume_orbax(corpus, tmp_path):
    """training.checkpoint_format: orbax under two gloo ranks: rank 0 alone
    writes each checkpoint directory, both ranks read it back to resume,
    and the directory holds the state the run trained."""
    config = entry_config(tmp_path, "orbax", "cnn", checkpoint_format="orbax")
    entry(config, corpus, "--epochs", "1", "--num-devices", "2", cwd=tmp_path)
    ckpt = tmp_path / "orbax" / "ckpt"
    assert sorted(p.name for p in ckpt.iterdir()) == ["best_model.ckpt", "checkpoint_epoch_1.ckpt"]
    assert all(p.is_dir() and (p / "_CHECKPOINT_METADATA").exists() for p in ckpt.iterdir())
    saved = load_checkpoint(ckpt / "checkpoint_epoch_1.ckpt")
    assert saved["epoch"] == 0 and saved["config"]["training"]["checkpoint_format"] == "orbax"
    out = entry(config, corpus, "--resume", str(ckpt / "checkpoint_epoch_1.ckpt"),
                "--num-devices", "2", cwd=tmp_path)
    assert "Resumed from" in out and "Epoch 2/2" in out and "Epoch 1/2" not in out
    assert load_checkpoint(ckpt / "checkpoint_epoch_2.ckpt")["epoch"] == 1


@pytest.mark.parametrize("argv, gpus, want", [
    (["--device", "cpu"], 0, 1),
    (["--device", "cpu", "--num-devices", "2"], 0, 2),
    ([], 1, 1),  # one GPU: in this process, no group
    ([], 4, 4),  # every visible GPU, one rank each
    (["--num-devices", "2"], 4, 2),
    (["--multihost", "--num-devices", "4"], 4, 1),  # this process is one rank already
])
def test_ranks_the_entry_starts(monkeypatch, argv, gpus, want):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: gpus)
    assert port_train.ranks_to_start(port_train.parse_args(argv)) == want


def test_mesh_helpers_without_a_group():
    """One process: init_distributed is a no-op returning 0, the mesh has no
    group, a mesh of several devices cannot be made, and the slicing helpers
    give the whole batch; a batch the ranks do not divide raises as the JAX
    helper does."""
    assert init_distributed() == 0 and init_distributed(num_processes=1) == 0
    mesh = get_mesh(device="cpu")
    assert mesh.group is None and mesh.world_size == 1 and mesh.device == torch.device("cpu")
    with pytest.raises(ValueError, match="3 ranks of one device each"):
        get_mesh(3, device="cpu")
    assert local_batch_slice(64) == slice(0, 64)
    x = np.arange(12.0).reshape(6, 2)
    np.testing.assert_array_equal(shard_batch(mesh, x).numpy(), x)
    two = Mesh(torch.device("cpu"), rank=1, world_size=2)
    assert local_batch_slice(6, two) == slice(3, 6)
    np.testing.assert_array_equal(shard_batch(two, x).numpy(), x[3:])
    np.testing.assert_array_equal(shard_batch(two, x[None], axis=1).numpy(), x[None, 3:])
    with pytest.raises(ValueError, match="not divisible by process count 2"):
        local_batch_slice(7, two)


class _CountingDataset:
    """14 one-sample "clips" (the value is the index); it records every
    index it decodes."""

    target_length = 1

    def __init__(self):
        self.labels = np.arange(14, dtype=np.int32) % 4
        self.decoded = []

    def __len__(self):
        return len(self.labels)

    def __getitem__(self, i):
        self.decoded.append(i)
        return np.full(1, i, np.float32), int(self.labels[i])


@pytest.mark.parametrize("ranks", [2, 3])
@pytest.mark.parametrize("shuffle", [False, True])
def test_each_rank_decodes_only_its_rows(ranks, shuffle):
    """Batches of 6 over 14 clips (the last batch 2 rows: some ranks get
    none of it). Each rank decodes only its rows of each batch, every clip
    is decoded once over the ranks, the ranks' rows in rank order are the
    unsharded batch, and every rank gets the whole batch's labels."""
    whole = list(BatchLoader(_CountingDataset(), 6, shuffle=shuffle, seed=3))
    decoded = []
    for rank in range(ranks):
        ds = _CountingDataset()
        got = list(BatchLoader(ds, 6, shuffle=shuffle, seed=3, shard=(rank, ranks)))
        assert len(got) == len(whole)
        for (wavs, labels), (all_wavs, all_labels) in zip(got, whole):
            rows = slice(rank * 6 // ranks, (rank + 1) * 6 // ranks)
            np.testing.assert_array_equal(wavs, all_wavs[rows])
            np.testing.assert_array_equal(labels, all_labels)
        assert sorted(ds.decoded) == sorted(int(w[0]) for wavs, _ in got for w in wavs)
        decoded += ds.decoded
    assert sorted(decoded) == list(range(14))
    with pytest.raises(ValueError, match="does not split into 4 equal parts"):
        BatchLoader(_CountingDataset(), 6, shard=(0, 4))


def test_trainer_refuses_a_mesh_its_model_does_not_span(corpus, tmp_path):
    """The JAX trainer's two errors (`training/trainer.py:76-89` there): a
    model whose BatchNorm lacks the mesh's group, and a batch the ranks do
    not divide. Both raise before any collective runs."""
    config = load_config(str(entry_config(tmp_path, "err", "cnn")))
    train, val = ICBHIDataset(corpus, "train", config), ICBHIDataset(corpus, "val", config)
    group = object()  # stands for a process group of two
    mesh = Mesh(torch.device("cpu"), rank=0, world_size=2, group=group)
    with pytest.raises(ValueError, match="BatchNorm statistics would silently diverge"):
        Trainer(build_model(config), train, val, config, mesh=mesh)
    config["training"]["batch_size"] = 5
    with pytest.raises(ValueError, match="must be divisible by the 2-rank data mesh"):
        Trainer(build_model(config, axis_name=group), train, val, config, mesh=mesh)


@pytest.fixture(scope="module")
def fp32_ckpt(tmp_path_factory):
    return str(_checkpoint(tmp_path_factory.mktemp("mh_ckpt") / "fp32.ckpt", False))


@pytest.mark.parametrize("n", [2, 3])
def test_analyzer_mesh_matches_jax_and_no_mesh(fp32_ckpt, recording, n):  # noqa: F811
    """The windows split over n devices (bucket lcm(32, n): 96 at 3) give
    the JAX engine's probabilities on an n-device mesh within 1e-4 and the
    port's own on one device within 1e-6."""
    engine = port_engine(fp32_ckpt, 0.5, devices=["cpu"] * n)
    assert engine._window_bucket(20) == np.lcm(32, n)
    windows, _, _ = engine.segment_audio(engine.load_audio(recording))
    got = engine.predict_window_probs(windows)
    assert len(engine._replicas) == n
    assert got.shape == (len(windows), 4)
    want = jax_engine(fp32_ckpt, 0.5, False, mesh=jax_mesh(num_devices=n)).predict_window_probs(
        windows)
    np.testing.assert_allclose(got, want, atol=1e-4)
    alone = port_engine(fp32_ckpt, 0.5).predict_window_probs(windows)
    np.testing.assert_allclose(got, alone, rtol=0, atol=1e-6)
    assert float(np.ptp(got, axis=0).max()) > 1e-2


def test_parse_args_has_the_repo_flags():
    args = port_train.parse_args(["--multihost", "--coordinator", "h:1", "--num-processes",
                                  "2", "--process-id", "1", "--num-devices", "2"])
    assert isinstance(args, argparse.Namespace)
    assert (args.multihost, args.coordinator, args.num_processes, args.process_id,
            args.num_devices) == (True, "h:1", 2, 1, 2)
