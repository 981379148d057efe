"""The analyzer slice end to end: the port's FlexibleMelFrontend and
AnalyzerEngine against the JAX package's on one checkpoint, the `analyze`
entry point's five variants, and the fused-CNN opt-in's routing.

Both packages read the same JAX-written checkpoint (config.yaml's schema:
16 kHz, 128 mels, n_fft 2048, hop 512); inputs are made with numpy from a
seed. At sub-second windows the front end runs n_fft 1024, hop 256: the
radix-8 kernel's shape, whose plain version the port runs on the CPU.
"""

import csv
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from audio_classification_icbhi_tpu.analyzers.engine import AnalyzerEngine as JaxAnalyzer
from audio_classification_icbhi_tpu.analyzers.engine import FlexibleMelFrontend as JaxFlexible
from audio_classification_icbhi_tpu.data.synthetic import synth_respiratory_cycle
from audio_classification_icbhi_tpu.models import build_model as jax_build_model
from audio_classification_icbhi_tpu.models.registry import init_variables
from audio_classification_icbhi_tpu.utils.checkpoint import save_checkpoint
from audio_classification_icbhi_tpu_torch import analyze
from audio_classification_icbhi_tpu_torch.analyzers import AnalyzerEngine, FlexibleMelFrontend
from audio_classification_icbhi_tpu_torch.data.wavio import write_wav
from audio_classification_icbhi_tpu_torch.inference import ClassifierEngine
from audio_classification_icbhi_tpu_torch.ops.mel import normalize_spectrogram
from audio_classification_icbhi_tpu_torch.utils.config import load_config

REPO = Path(__file__).resolve().parent.parent
SR = 16000
DURATIONS = [0.1, 0.25, 0.5, 0.512, 0.75, 1.0, 2.0, 4.0]
ATOL = {False: 1e-4, True: 5e-3}  # probabilities: fp32, bf16


def _checkpoint(path: Path, mixed_precision: bool) -> Path:
    """A JAX-written checkpoint at config.yaml's data section, from a flax
    init with non-trivial BN statistics and a heavier head, so that the
    class probabilities spread."""
    config = load_config(str(REPO / "config.yaml"))
    config["data"]["duration"] = 1.0
    config["training"]["mixed_precision"] = mixed_precision
    model = jax_build_model(config)
    v = jax.tree_util.tree_map(np.asarray, init_variables(
        model, jax.random.PRNGKey(1), (1, 128, 32, 1)))
    rng = np.random.default_rng(5)
    for blk in v["batch_stats"].values():
        bn = blk["BatchNorm_0"]
        bn["mean"] = (0.05 * rng.standard_normal(bn["mean"].shape)).astype(np.float32)
        bn["var"] = (1.0 + rng.random(bn["var"].shape)).astype(np.float32)
    for name in ("Dense_0", "Dense_1"):
        v["params"][name]["kernel"] = v["params"][name]["kernel"] * 30.0
    return save_checkpoint(path, {"epoch": 1, "params": v["params"],
                                  "batch_stats": v["batch_stats"], "val_loss": 0.5,
                                  "config": config})


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    d = tmp_path_factory.mktemp("analyzer")
    return {mp: str(_checkpoint(d / f"mp{int(mp)}.ckpt", mp)) for mp in (False, True)}


@pytest.fixture(scope="module")
def recording(tmp_path_factory):
    """A 6 s recording of respiratory cycles of all four classes, as a wav."""
    rng = np.random.default_rng(17)
    audio = np.concatenate([synth_respiratory_cycle(rng, c, 1.5, SR) for c in range(4)])
    path = tmp_path_factory.mktemp("rec") / "rec.wav"
    write_wav(path, audio.astype(np.float32), SR)
    return str(path)


def jax_engine(ckpt, segment_duration, mixed_precision, **kw):
    """The JAX engine; at fp32 its front end runs its explicit f32 XLA path,
    since its CPU default (the bf16x4 radix-2 path) is up to ~5e-4 dB from
    f32 (ROADMAP.md C)."""
    eng = JaxAnalyzer(ckpt, segment_duration=segment_duration, sample_rate=SR, **kw)
    if not mixed_precision:
        fe = eng.frontend
        eng.frontend = JaxFlexible(SR, fe.n_mels, 2048, 512, segment_duration, backend="xla",
                                   f_min=fe._inner.f_min, f_max=fe._inner.f_max,
                                   top_db=fe._inner.top_db)
    return eng


def port_engine(ckpt, segment_duration, **kw):
    return AnalyzerEngine(ckpt, segment_duration=segment_duration, sample_rate=SR,
                          device="cpu", **kw)


class TestFlexibleMelFrontend:
    @pytest.mark.parametrize("duration", DURATIONS)
    def test_config_matches_jax(self, duration):
        want = JaxFlexible(SR, 128, 2048, 512, duration)
        got = FlexibleMelFrontend(SR, 128, 2048, 512, duration)
        assert (got.n_fft, got.hop_length, got.target_time_steps, got.needs_resize) == (
            want.n_fft, want.hop_length, want.target_time_steps, want.needs_resize)

    @pytest.mark.parametrize("duration", [0.25, 0.5, 0.512, 4.0])
    def test_output_matches_jax(self, rng, duration):
        """0.25 s enlarges 16 -> 32 frames, 0.5 s needs no resize, 0.512 s
        shrinks 33 -> 32 and 4.0 s 126 -> 125 (at 2048/512)."""
        n = (0.1 * rng.standard_normal((3, int(SR * duration)))).astype(np.float32)
        want = np.asarray(JaxFlexible(SR, 128, 2048, 512, duration, backend="xla")(
            jnp.asarray(n)))
        fe = FlexibleMelFrontend(SR, 128, 2048, 512, duration)
        got = fe(torch.from_numpy(n)).numpy()
        assert got.shape == (3, 128, fe.target_time_steps)
        np.testing.assert_allclose(got, want, atol=2e-3)

    def test_shrinking_resize_needs_the_antialias(self, rng):
        """jax.image.resize antialiases when it shrinks; torch's bilinear
        interpolate does not unless asked, and at 0.512 s (33 -> 32 frames)
        it then misses the JAX front end by far more than the tolerance."""
        duration = 0.512
        n = (0.1 * rng.standard_normal((3, int(SR * duration)))).astype(np.float32)
        want = np.asarray(JaxFlexible(SR, 128, 2048, 512, duration, backend="xla")(
            jnp.asarray(n)))
        fe = FlexibleMelFrontend(SR, 128, 2048, 512, duration)
        mel = fe._inner.log_mel(torch.from_numpy(n))[:, None]
        plain = F.interpolate(mel, size=(128, 32), mode="bilinear", align_corners=False)
        assert np.abs(normalize_spectrogram(plain[:, 0]).numpy() - want).max() > 2e-2
        np.testing.assert_allclose(fe(torch.from_numpy(n)).numpy(), want, atol=2e-3)


class TestSegmentation:
    @pytest.mark.parametrize("seconds, overlap", [
        (3.25, 0.5),  # full windows then a zero-padded tail
        (4.0, 0.0),   # no overlap, no tail
        (0.7, 0.5),   # shorter than one window: one padded tail window
        (0.7, 0.0),
        (0.0, 0.5),   # empty
        (15.0, 0.5),
    ])
    @pytest.mark.parametrize("segment_duration", [1.0, 0.5, 0.25])
    def test_windows_match_jax(self, ckpts, rng, seconds, overlap, segment_duration):
        audio = rng.standard_normal(int(SR * seconds)).astype(np.float32)
        want = JaxAnalyzer(ckpts[False], segment_duration=segment_duration, overlap=overlap,
                           sample_rate=SR).segment_audio(audio)
        got = port_engine(ckpts[False], segment_duration, overlap=overlap).segment_audio(audio)
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)

    def test_argument_checks_match_jax(self, ckpts):
        for cls, kw in ((JaxAnalyzer, {}), (AnalyzerEngine, dict(device="cpu"))):
            with pytest.raises(ValueError, match="overlap must be in"):
                cls(ckpts[False], overlap=1.0, **kw)
            with pytest.raises(ValueError, match="unknown analyzer mode"):
                cls(ckpts[False], mode="Legacy", **kw)
        # the JAX engine's mesh is taken now, as a list of devices that replaces `device`
        engine = AnalyzerEngine(ckpts[False], devices=["cpu", "cpu"], device="cuda")
        assert engine.device == torch.device("cpu") and engine._window_bucket(33) == 64

    def test_max_duration_crop_and_resample(self, ckpts, tmp_path):
        p = tmp_path / "long.wav"
        write_wav(p, np.zeros(8000 * 20, np.float32), 8000)
        audio = port_engine(ckpts[False], 0.5).load_audio(p)
        assert len(audio) == SR * 15


@pytest.mark.parametrize("segment_duration", [0.5, 0.25])
@pytest.mark.parametrize("mixed_precision", [False, True])
def test_window_probabilities_match_jax(ckpts, recording, segment_duration, mixed_precision):
    """One recording through both engines: the same windows, probabilities
    within 1e-4 (fp32) or 5e-3 (bf16), and in both detection modes the same
    flags and classes, except where a value lies within that tolerance of
    its threshold; the CSVs have the same rows."""
    ckpt, atol = ckpts[mixed_precision], ATOL[mixed_precision]
    jeng = jax_engine(ckpt, segment_duration, mixed_precision)
    peng = port_engine(ckpt, segment_duration)
    audio = peng.load_audio(recording)
    np.testing.assert_array_equal(audio, jeng.load_audio(recording))
    windows, starts, ends = peng.segment_audio(audio)
    want = jeng.predict_window_probs(windows)
    got = peng.predict_window_probs(windows)
    assert got.shape == (len(windows), 4) and len(windows) > 20
    np.testing.assert_allclose(got, want, atol=atol)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)

    for mode in ("threshold", "legacy"):
        jeng.mode = peng.mode = mode
        limit = 0.5 if mode == "legacy" else 0.3
        for pg, pw, s, e in zip(got, want, starts, ends):
            rg, rw = peng._make_result(pg, s, e), jeng._make_result(pw, s, e)
            assert (rg.start_time, rg.end_time) == (rw.start_time, rw.end_time)
            if np.sort(pw)[-1] - np.sort(pw)[-2] > 2 * atol:
                assert rg.predicted_class == rw.predicted_class
            for flag, values in (("has_crackle", (pw[1], pw[3], pw[1] + pw[3])),
                                 ("has_wheeze", (pw[2], pw[3], pw[2] + pw[3]))):
                if min(abs(v - limit) for v in values) > 2 * atol:
                    assert getattr(rg, flag) == getattr(rw, flag)
            for key in ("crackle_confidence", "wheeze_confidence", "normal_confidence",
                        "both_confidence"):
                assert abs(getattr(rg, key) - getattr(rw, key)) <= 2 * atol


def test_csvs_have_the_same_rows(ckpts, recording, tmp_path):
    """The fp32 engines' results CSV and timeline CSV, row for row: times
    and flags equal, confidences within one unit of their last printed
    digit."""
    jeng = jax_engine(ckpts[False], 0.5, False)
    peng = port_engine(ckpts[False], 0.5)
    jres, _ = jeng.analyze_audio(recording)
    pres, _ = peng.analyze_audio(recording)
    for export in ("export_results", "export_results_timeline"):
        getattr(jeng, export)(jres, tmp_path / "j.csv")
        getattr(peng, export)(pres, tmp_path / "p.csv")
        jrows = list(csv.reader(open(tmp_path / "j.csv")))
        prows = list(csv.reader(open(tmp_path / "p.csv")))
        assert prows[0] == jrows[0] and len(prows) == len(jrows) == len(pres) + 1
        for pr, jr in zip(prows[1:], jrows[1:]):
            for a, b in zip(pr, jr):
                if "." in a and a.replace(".", "").isdigit():
                    assert abs(float(a) - float(b)) <= 1e-4 + 1e-9, (pr, jr)
                else:
                    assert a == b, (pr, jr)


@pytest.mark.parametrize("variant", list(analyze.VARIANTS))
def test_entry_point_variants_write_their_csv(ckpts, recording, tmp_path, variant):
    """Each variant on the CPU: the script's CSV name, columns and rows,
    its detection mode, 16 kHz."""
    out = tmp_path / "out"
    eng, results, path = analyze.main([
        variant, "--audio", recording, "--model", ckpts[True], "--segment-duration", "0.5",
        "--output-dir", str(out), "--device", "cpu", "--no-display"])
    v = analyze.VARIANTS[variant]
    name = {"realtime": "rec_results.csv", "parallel_p": "rec_results.csv",
            "parallel": "rec_results_t0.30.csv", "spec": "rec_detections.csv",
            "timeline": "rec_detections.csv"}[variant]
    assert path == out / name and path.exists()
    assert eng.mode == v.mode and eng.sample_rate == SR and eng.frontend.n_fft == 1024
    rows = list(csv.reader(open(path)))
    assert len(rows) == len(results) + 1 == 24 + 1  # 6 s at 0.5 s, 50 %: 23 + tail
    assert rows[0][2] == ("Detection Type" if v.timeline_csv else "Crackle")


def test_entry_point_runs_as_a_module():
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-m", "audio_classification_icbhi_tpu_torch.analyze",
                          "timeline", "--help"], capture_output=True, text=True, env=env,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert "--crackle-threshold" in out.stdout and "--device" in out.stdout
    top = subprocess.run([sys.executable, "-m", "audio_classification_icbhi_tpu_torch.analyze",
                          "--help"], capture_output=True, text=True, env=env, timeout=120)
    assert "picture" in top.stdout and "--no-plots" in top.stdout


def test_fused_cnn_opt_in_raises_on_cuda(ckpts, monkeypatch):
    """ICBHI_FUSED_CNN=1 is where the JAX engines take the Pallas CNN
    (`models/fused_infer.py:131`); the port's engines take its fused
    conv-block kernels there (the port's `models/fused_infer.py`). Asking
    for cuda without a card raises, whatever the switch says; on the CPU,
    where the JAX package runs XLA's convs, both engines run the model's
    forward; where the switch holds, the analyzer routes its windows
    through the fused apply, within 5e-3 of the model's forward."""
    import audio_classification_icbhi_tpu_torch.analyzers.engine as engine_mod

    monkeypatch.setenv("ICBHI_FUSED_CNN", "1")
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ClassifierEngine(ckpts[True], device="cuda")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            AnalyzerEngine(ckpts[True], segment_duration=0.5, device="cuda")
    eng = AnalyzerEngine(ckpts[True], segment_duration=0.5, device="cpu")
    assert eng._apply_fn is eng.classifier.model
    assert eng.classifier._apply_fn is eng.classifier.model
    windows = (0.1 * np.random.default_rng(3).standard_normal((6, SR // 2))).astype(np.float32)
    want = eng.predict_window_probs(windows)
    monkeypatch.setattr(engine_mod, "fused_cnn_enabled", lambda shape, device: True)
    fused = AnalyzerEngine(ckpts[True], segment_duration=0.5, device="cpu")
    got = fused.predict_window_probs(windows)
    assert fused._apply_fn is not fused.classifier.model
    np.testing.assert_allclose(got, want, atol=5e-3)
