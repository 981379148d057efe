"""The analyzers' pictures (`analyzers/viz.py`) and the `analyze` entry
point's outputs on the CPU: each variant writes its script's PNG and CSV
names, --no-plots the CSV alone, and the spectrogram panel's mel against
the JAX package's `log_mel_spectrogram` with the same arguments (slaney
mels and norm, power_to_db against the maximum, top_db 80).

The checkpoint is the port's seeded LightweightCNN at config.yaml's front
end and 1 s clips, fp32, its head x30 so that windows differ.
"""

import csv

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_classification_icbhi_tpu.ops import mel as jax_mel
from audio_classification_icbhi_tpu_torch import analyze
from audio_classification_icbhi_tpu_torch.analyzers import SegmentResult, viz
from audio_classification_icbhi_tpu_torch.data.synthetic import synth_respiratory_cycle
from audio_classification_icbhi_tpu_torch.data.wavio import write_wav
from audio_classification_icbhi_tpu_torch.models import build_model
from audio_classification_icbhi_tpu_torch.models.weights import flax_from_state_dict
from audio_classification_icbhi_tpu_torch.utils.checkpoint import save_checkpoint
from audio_classification_icbhi_tpu_torch.utils.config import load_config

SR = 16000
PNG = {"realtime": "rec_analysis.png", "parallel_p": "rec_analysis.png",
       "parallel": "rec_analysis_t0.30.png", "spec": "rec_spectrogram.png",
       "timeline": "rec_timeline.png"}
CSV = {"realtime": "rec_results.csv", "parallel_p": "rec_results.csv",
       "parallel": "rec_results_t0.30.csv", "spec": "rec_detections.csv",
       "timeline": "rec_detections.csv"}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("viz")
    cfg = load_config()
    cfg["data"]["duration"] = 1.0
    cfg["training"]["mixed_precision"] = False
    model = build_model(cfg, dtype=torch.float32, generator=torch.Generator().manual_seed(0))
    sd = {k: v * 30.0 if k.startswith("fc") and k.endswith("weight") else v
          for k, v in model.state_dict().items()}
    ckpt = save_checkpoint(d / "m.ckpt", {"epoch": 0, **flax_from_state_dict(sd),
                                          "val_loss": 0.0, "config": cfg})
    rng = np.random.default_rng(21)
    audio = np.concatenate([synth_respiratory_cycle(rng, c, 1.0, SR) for c in range(4)])
    write_wav(d / "rec.wav", audio.astype(np.float32), SR)
    return str(ckpt), str(d / "rec.wav")


@pytest.mark.parametrize("variant", list(analyze.VARIANTS))
def test_variant_writes_its_png_and_csv(inputs, tmp_path, variant):
    ckpt, rec = inputs
    out = tmp_path / "out"
    eng, results, path = analyze.main([variant, "--audio", rec, "--model", ckpt,
                                       "--output-dir", str(out), "--device", "cpu"])
    assert path == out / CSV[variant]
    assert sorted(p.name for p in out.iterdir()) == sorted({CSV[variant], PNG[variant]})
    png = (out / PNG[variant]).read_bytes()
    assert png[:8] == b"\x89PNG\r\n\x1a\n" and len(png) > 10_000
    rows = list(csv.reader(open(path)))
    assert len(rows) == len(results) + 1 == 8 + 1  # 4 s at 1 s, 50 % overlap: 7 + tail


@pytest.mark.parametrize("variant", ["parallel", "spec"])
def test_no_plots_writes_the_csv_alone(inputs, tmp_path, variant):
    ckpt, rec = inputs
    out = tmp_path / "out"
    analyze.main([variant, "--audio", rec, "--model", ckpt, "--output-dir", str(out),
                  "--device", "cpu", "--no-plots", "--crackle-threshold", "0.25"])
    name = CSV[variant].replace("0.30", "0.25")
    assert [p.name for p in out.iterdir()] == [name]


@pytest.mark.parametrize("n_fft,hop,n_mels", [(2048, 512, 128), (512, 128, 64)])
def test_spectrogram_mel_matches_jax(n_fft, hop, n_mels):
    """The panel's dB, f32 on the CPU, against the JAX function's: 1e-3 dB
    at the analyzers' 2048/512 (the 80 dB floor clamps the cells far below
    the peak); below n_fft 1536, where no f32 chain holds 1e-3 dB
    unrestricted (ROADMAP.md C), in the 25 dB active region."""
    audio = np.concatenate([synth_respiratory_cycle(np.random.default_rng(s), s % 4, 0.75, SR)
                            for s in range(4)]).astype(np.float32)
    got = viz.spectrogram_db(audio, SR, n_fft, hop, n_mels)
    want = np.asarray(jax_mel.log_mel_spectrogram(
        jnp.asarray(audio), SR, n_fft, hop, n_mels, mel_scale="slaney", norm="slaney",
        to_db="power_max"))
    assert got.shape == want.shape == (n_mels, 1 + len(audio) // hop)
    assert got.max() == 0.0 and got.min() >= -80.0
    active = want >= -25.0 if n_fft < 1536 else np.ones_like(want, bool)
    np.testing.assert_allclose(got[active], want[active], rtol=0, atol=1e-3)


def test_panels_draw_from_results(tmp_path):
    """The three panels from hand-made results of every detection type
    (the legend and the summary box count them), and COLORS' keys."""
    kinds = [(False, False), (True, False), (False, True), (True, True)]
    results = [SegmentResult(i * 0.5, i * 0.5 + 1.0, c, w, 0.6 * c + 0.1, 0.7 * w + 0.1,
                             0.2, 0.1, "normal") for i, (c, w) in enumerate(kinds)]
    assert [viz.detection_label(r) for r in results] == ["normal", "crackle", "wheeze", "both"]
    assert set(viz.COLORS) == {"normal", "crackle", "wheeze", "both"}
    audio = np.zeros(int(2.5 * SR), np.float32)
    viz.three_panel(results, audio, SR, 0.3, 0.3, save_path=tmp_path / "a.png")
    viz.timeline(results, audio, SR, save_path=tmp_path / "b.png")
    viz.spectrogram(results, audio + 1e-3, SR, save_path=tmp_path / "c.png", n_fft=512,
                    hop_length=128, n_mels=32)
    assert all((tmp_path / f"{n}.png").stat().st_size > 10_000 for n in "abc")
