"""The port's interactive viewer (`interactive.py`) under SDL's dummy
drivers: the render loop draws and exits on a scripted session, the
playback backend is probed sounddevice -> pygame.mixer -> silent, and the
entry point runs end to end as a subprocess with --device cpu (and raises
without a GPU under its cuda default)."""

import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

os.environ.setdefault("SDL_VIDEODRIVER", "dummy")
os.environ.setdefault("SDL_AUDIODRIVER", "dummy")

from audio_classification_icbhi_tpu_torch import interactive  # noqa: E402
from audio_classification_icbhi_tpu_torch.analyzers import SegmentResult  # noqa: E402
from audio_classification_icbhi_tpu_torch.data.synthetic import synth_respiratory_cycle  # noqa: E402
from audio_classification_icbhi_tpu_torch.data.wavio import write_wav  # noqa: E402
from audio_classification_icbhi_tpu_torch.models import build_model  # noqa: E402
from audio_classification_icbhi_tpu_torch.models.weights import flax_from_state_dict  # noqa: E402
from audio_classification_icbhi_tpu_torch.utils.checkpoint import save_checkpoint  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


def result(start, end, crackle, wheeze):
    return SegmentResult(start, end, crackle, wheeze, 0.8, 0.3, 0.1, 0.1, "crackles")


def test_render_loop_draws_and_exits():
    pygame = pytest.importorskip("pygame")
    sr = 4000
    audio = (0.1 * np.sin(2 * np.pi * 100 * np.arange(2 * sr) / sr)).astype(np.float32)
    results = [result(0.0, 0.9, True, False), result(0.9, 2.0, True, True)]
    viewer = interactive.InteractiveAudioVisualizer("x.wav", results, audio, sr)
    # play, pause, restart, play, exit: posted up front, drained in order
    for key in (pygame.K_SPACE, pygame.K_SPACE, pygame.K_r, pygame.K_SPACE, pygame.K_ESCAPE):
        pygame.event.post(pygame.event.Event(pygame.KEYDOWN, key=key))
    viewer.run()
    assert viewer.frames_drawn >= 1
    assert viewer.playing  # the last SPACE left it playing


def test_playback_probe_order(monkeypatch):
    pygame = pytest.importorskip("pygame")
    audio = np.zeros(4000, np.float32)

    monkeypatch.setitem(sys.modules, "sounddevice", None)  # not installed
    pb = interactive.Playback(audio, 4000, pygame)
    assert pb.backend in ("pygame.mixer", "none")
    pb.play_from(0.0)
    pb.play_from(0.5)
    pb.stop()

    calls = []
    working = types.SimpleNamespace(
        check_output_settings=lambda samplerate, channels: None,
        play=lambda data, samplerate: calls.append(("play", len(data), samplerate)),
        stop=lambda: calls.append(("stop",)))
    monkeypatch.setitem(sys.modules, "sounddevice", working)
    pb = interactive.Playback(audio, 4000, pygame)
    assert pb.backend == "sounddevice"  # first when it works
    pb.play_from(0.5)  # the tail from the cursor
    pb.stop()
    assert calls == [("play", 2000, 4000), ("stop",)]

    def no_device(samplerate, channels):
        raise RuntimeError("no output device")

    monkeypatch.setitem(sys.modules, "sounddevice",
                        types.SimpleNamespace(check_output_settings=no_device))
    assert interactive.Playback(audio, 4000, pygame).backend in ("pygame.mixer", "none")

    broken = types.SimpleNamespace(mixer=types.SimpleNamespace(init=no_device))
    assert interactive.Playback(audio, 4000, broken).backend == "none"  # silent last


def test_entry_point_runs_as_a_subprocess(tmp_path, monkeypatch):
    """`python -m ...interactive --device cpu`: the analysis, the banner, a
    UI that closes after 3 frames (ICBHI_UI_AUTOEXIT), exit 0; with the
    default --device, no GPU here: it raises before the viewer starts."""
    pytest.importorskip("pygame")
    sr = 4000
    cfg = {"data": {"dataset_path": "x", "sample_rate": sr, "n_mels": 32, "n_fft": 256,
                    "hop_length": 64, "duration": 1.0, "augmentation": False},
           "model": {"architecture": "cnn", "num_classes": 4, "dropout": 0.1},
           "training": {"batch_size": 8, "mixed_precision": False},
           "classes": ["normal", "crackles", "wheezes", "both"], "seed": 0}
    model = build_model(cfg, generator=torch.Generator().manual_seed(0))
    ckpt = save_checkpoint(tmp_path / "m.ckpt", {
        "epoch": 0, **flax_from_state_dict(model.state_dict()), "val_loss": 0.0, "config": cfg})
    wav = synth_respiratory_cycle(np.random.default_rng(0), 1, duration=3.0, sample_rate=sr)
    write_wav(tmp_path / "clip.wav", wav, sr)

    env = dict(os.environ, SDL_VIDEODRIVER="dummy", SDL_AUDIODRIVER="dummy",
               ICBHI_UI_AUTOEXIT="3",
               PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    cmd = [sys.executable, "-m", "audio_classification_icbhi_tpu_torch.interactive",
           "--audio", str(tmp_path / "clip.wav"), "--model", str(ckpt)]
    r = subprocess.run(cmd + ["--device", "cpu"], env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-3000:])
    assert "Launching interactive visualizer" in r.stdout
    assert "UI auto-exit after 3 frames" in r.stdout

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        interactive.main(["--audio", str(tmp_path / "clip.wav"), "--model", str(ckpt)])
