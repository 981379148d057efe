"""The serving slice end to end: the port's ClassifierEngine against the JAX
package's on one checkpoint, the CLI, and the port's import discipline."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from audio_classification_icbhi_tpu.data.synthetic import synth_respiratory_cycle
from audio_classification_icbhi_tpu.inference import ClassifierEngine as JaxEngine
from audio_classification_icbhi_tpu.models import build_model as jax_build_model
from audio_classification_icbhi_tpu.models.registry import init_variables
from audio_classification_icbhi_tpu.ops.mel import MelFrontend as JaxMelFrontend
from audio_classification_icbhi_tpu.utils.checkpoint import save_checkpoint
from audio_classification_icbhi_tpu_torch.data.wavio import write_wav
from audio_classification_icbhi_tpu_torch.inference import ClassifierEngine
from audio_classification_icbhi_tpu_torch.utils.config import load_config

REPO = Path(__file__).resolve().parent.parent
SR = 16000


def _checkpoint(path: Path, mixed_precision: bool) -> Path:
    """A JAX-written checkpoint with config.yaml's schema at 5 s, from a
    flax init with non-trivial BN statistics."""
    config = load_config(str(REPO / "config.yaml"))
    config["data"]["duration"] = 5.0
    config["training"]["mixed_precision"] = mixed_precision
    model = jax_build_model(config)
    v = jax.tree_util.tree_map(np.asarray, init_variables(
        model, jax.random.PRNGKey(0), (1, 128, 157, 1)))
    rng = np.random.default_rng(3)
    for blk in v["batch_stats"].values():
        bn = blk["BatchNorm_0"]
        bn["mean"] = (0.05 * rng.standard_normal(bn["mean"].shape)).astype(np.float32)
        bn["var"] = (1.0 + rng.random(bn["var"].shape)).astype(np.float32)
    # larger head weights than the N(0, 0.01) init, so the classes separate
    for name in ("Dense_0", "Dense_1"):
        v["params"][name]["kernel"] = v["params"][name]["kernel"] * 30.0
    return save_checkpoint(path, {"epoch": 2, "params": v["params"],
                                  "batch_stats": v["batch_stats"], "val_loss": 0.5,
                                  "config": config})


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    d = tmp_path_factory.mktemp("engine")
    return {mp: _checkpoint(d / f"mp{int(mp)}.ckpt", mp) for mp in (False, True)}


@pytest.fixture(scope="module")
def wavs():
    rng = np.random.default_rng(11)
    return np.stack([synth_respiratory_cycle(rng, i % 4, 5.0, SR) for i in range(5)]
                    ).astype(np.float32)


@pytest.mark.parametrize("mixed_precision, atol", [(False, 1e-4), (True, 5e-3)])
def test_same_answers_from_both_engines(ckpts, wavs, mixed_precision, atol):
    """Batch 5 at batch_size 4 exercises the padded last chunk.

    At fp32 the JAX engine's front end is set to its explicit f32 XLA path,
    so both sides compute in f32: its CPU default, the bf16x4 radix-2
    decomposition, differs from f32 by up to ~5e-4 dB, which the
    heavier-than-init head used here turns into ~1e-3 in probability. With
    mixed precision both engines run as served."""
    ckpt = ckpts[mixed_precision]
    jax_engine = JaxEngine(ckpt, batch_size=4)
    if not mixed_precision:
        jax_engine.frontend = JaxMelFrontend.from_config(jax_engine.config, backend="xla")
    want = jax_engine.predict_probs(wavs)
    eng = ClassifierEngine(ckpt, batch_size=4, device="cpu")
    got = eng.predict_probs(wavs)
    assert got.shape == (5, 4)
    np.testing.assert_allclose(got, want, atol=atol)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
    one = eng.classify_wave(wavs[0])
    assert set(one) == {"predicted_class", "confidence", "probabilities"}
    assert one["predicted_class"] == eng.class_names[int(np.argmax(want[0]))]
    np.testing.assert_allclose(list(one["probabilities"].values()), got[0], atol=atol)


def test_files_resampling_and_describe(ckpts, wavs, tmp_path, capsys):
    """classify_files reports and skips a file that is no WAV, and one that
    declares sample rate 0 (ZeroDivisionError in the resampler), as the JAX
    engine does; before the repair the port stopped at the second."""
    eng = ClassifierEngine(ckpts[True], batch_size=4, device="cpu")
    eng.warmup_latency()
    paths = []
    for i, w in enumerate(wavs[:3]):
        p = tmp_path / f"clip{i}.wav"
        write_wav(p, w[::2], 8000)  # 8 kHz file: resampled to 16 kHz on load
        paths.append(p)
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"not a wav")
    zero_rate = tmp_path / "zero_rate.wav"
    write_wav(zero_rate, wavs[3], 0)
    capsys.readouterr()
    results = eng.classify_files(paths + [bad, zero_rate])
    assert [r["audio_path"] for r in results] == [str(p) for p in paths]
    reported = capsys.readouterr().out
    assert f"Error processing {bad}" in reported and f"Error processing {zero_rate}" in reported
    want = JaxEngine(ckpts[True], batch_size=4).classify_files(paths + [bad, zero_rate])
    assert [r["audio_path"] for r in want] == [r["audio_path"] for r in results]
    single = eng.classify_file(paths[0])
    assert single["predicted_class"] == results[0]["predicted_class"]
    # batch 1 against a padded batch of 4: bf16 sums in another order
    np.testing.assert_allclose(single["confidence"], results[0]["confidence"], atol=5e-3)
    info = eng.describe()
    assert info["parameters"] == 1_012_068 and info["epoch"] == 2
    assert info["duration"] == 5.0 and info["classes"] == eng.class_names


def test_cli_info_and_batch_on_cpu(ckpts, wavs, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    mod = "audio_classification_icbhi_tpu_torch.cli"
    out = subprocess.run([sys.executable, "-m", mod, "info", "--model", str(ckpts[True]),
                          "--device", "cpu"], capture_output=True, text=True, env=env,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert "Parameters: 1,012,068" in out.stdout
    write_wav(tmp_path / "a.wav", wavs[0], SR)
    csv_path = tmp_path / "r.csv"
    out = subprocess.run([sys.executable, "-m", mod, "classify-batch", "--input-dir",
                          str(tmp_path), "--model", str(ckpts[True]), "--output",
                          str(csv_path), "--device", "cpu"], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    header = csv_path.read_text().splitlines()[0]
    assert header == "audio_path,predicted_class,confidence,normal,crackles,wheezes,both"


def test_no_hidden_cpu_run(ckpts, monkeypatch):
    """The default device is cuda; on a machine without a GPU the engine
    raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ClassifierEngine(ckpts[True])


def test_port_imports_without_jax():
    """Every module of the port (the analyzers and `analyze`, the conv-block
    kernels and the fused apply, the native decoder, the resampler and the
    phase vocoder, the pictures, the viewer and the reports among them),
    and chip_smoke.py, imports with jax, the JAX package and the packages
    the card lacks (sklearn, matplotlib, seaborn, pygame, sounddevice)
    blocked."""
    code = f"""
import importlib, pkgutil, sys
sys.path.insert(0, {str(REPO)!r})
for blocked in ("jax", "flax", "optax", "msgpack", "pandas", "yaml", "sklearn",
                "matplotlib", "seaborn", "pygame", "sounddevice",
                "audio_classification_icbhi_tpu"):
    sys.modules[blocked] = None
import audio_classification_icbhi_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for new in ("ops.conv_kernels", "models.fused_infer", "native", "ops.resample",
            "ops.time_stretch", "analyzers.viz", "interactive", "confusion_matrix",
            "diagnose_data"):
    assert pkg.__name__ + "." + new in names, new
for name in names:
    importlib.import_module(name)
for attr in pkg.__all__:
    getattr(pkg, attr)
import chip_smoke
print(len(names))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=str(REPO))
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 39
