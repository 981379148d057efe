"""The port's data diagnostics (`diagnose_data.py`) against the
repository's `diagnose_data.py` (the JAX package) on a small synthetic
corpus, on the CPU: the class counts and imbalance warning, each sample's
normalized log-mel statistics, and the first batch's initial loss with the
JAX script's own initial weights (flax init at PRNGKey(0)) carried over.

The numbers are compared, not the printed lines: the JAX side's are
recomputed at full precision with the script's own modules. Its
MelFrontend "auto" runs bf16x4 on the CPU (ROADMAP.md C), which moves the
lowest cell of a normalized log-mel by up to 1.8e-3 from the float64
golden where the port's f32 moves it 2e-4; so, as the whole-engine
comparisons do, the statistics are recomputed at backend="xla" (f32) and
held to 1e-3, and the loss to 1e-4.
"""

import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diagnose_data as jax_diagnose
from audio_classification_icbhi_tpu.data.dataset import ICBHIDataset as JaxDataset
from audio_classification_icbhi_tpu.models import build_model as jax_build_model
from audio_classification_icbhi_tpu.ops.mel import MelFrontend as JaxMelFrontend
from audio_classification_icbhi_tpu.parallel.data_parallel import (
    features_from_wavs as jax_features,
)
from audio_classification_icbhi_tpu.parallel.data_parallel import (
    weighted_cross_entropy as jax_wce,
)
from audio_classification_icbhi_tpu_torch import diagnose_data
from audio_classification_icbhi_tpu_torch.data.dataset import ICBHIDataset
from audio_classification_icbhi_tpu_torch.data.synthetic import (
    generate_icbhi_dataset,
    generate_segmented_dataset,
)
from audio_classification_icbhi_tpu_torch.models import build_model
from audio_classification_icbhi_tpu_torch.models.weights import state_dict_from_flax
from audio_classification_icbhi_tpu_torch.ops.mel import MelFrontend
from audio_classification_icbhi_tpu_torch.utils.config import load_config


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("diag")
    corpus = generate_icbhi_dataset(d / "corpus", num_recordings=12, seed=9)
    cfg = load_config()
    cfg["data"].update(dataset_path=str(corpus), duration=1.0)
    cfg["training"]["mixed_precision"] = False
    path = d / "config.yaml"
    path.write_text(json.dumps(cfg))  # JSON is YAML
    return path, cfg, corpus


def test_matches_the_jax_script(setup, tmp_path, monkeypatch, capsys):
    config_path, cfg, corpus = setup
    monkeypatch.chdir(tmp_path)
    jax_diagnose.diagnose_dataset(str(config_path))
    jax_out = capsys.readouterr().out
    assert (tmp_path / "data_samples.png").exists()
    (tmp_path / "data_samples.png").unlink()

    got = diagnose_data.main(["--config", str(config_path), "--device", "cpu"])
    port_out = capsys.readouterr().out
    assert (tmp_path / "data_samples.png").stat().st_size > 10_000

    jax_counts = [int(c) for c in re.findall(r"^  \w+: (\d+)$", jax_out, re.M)]
    assert got["counts"].tolist() == jax_counts and got["size"] == sum(jax_counts) == 8
    assert got["imbalanced"] == ("severe class imbalance" in jax_out)
    assert got["imbalanced"] == ("severe class imbalance" in port_out)

    # the JAX script's mel statistics at full precision, with its modules
    ds = JaxDataset(corpus, "train", cfg)
    d = cfg["data"]
    fe = JaxMelFrontend(sample_rate=d["sample_rate"], n_mels=d["n_mels"], n_fft=d["n_fft"],
                        hop_length=d["hop_length"], duration=d["duration"], backend="xla")
    assert len(got["samples"]) == 6
    for i, s in enumerate(got["samples"]):
        wav, label = ds[i]
        mel = np.asarray(fe(jnp.asarray(wav[None])))[0]
        assert s["label"] == label and s["finite"]
        for key, want in (("mean", mel.mean()), ("std", mel.std()), ("min", mel.min()),
                          ("max", mel.max())):
            assert abs(s[key] - float(want)) <= 1e-3, (i, key, s[key], want)
    jax_loss = float(re.search(r"initial loss=([\d.]+)", jax_out).group(1))
    assert got["logits_shape"] == (8, 4)
    assert abs(got["loss"] - np.log(4)) < 1.0 and abs(jax_loss - np.log(4)) < 1.0
    assert "Initial loss near ln(C)" in port_out


def test_initial_loss_with_the_jax_weights(setup):
    """The first batch's loss through the port with the JAX script's own
    initial weights equals the JAX script's loss."""
    config_path, cfg, corpus = setup
    jds, ds = JaxDataset(corpus, "train", cfg), ICBHIDataset(corpus, "train", cfg)
    d = cfg["data"]
    jfe = JaxMelFrontend(sample_rate=d["sample_rate"], n_mels=d["n_mels"], n_fft=d["n_fft"],
                         hop_length=d["hop_length"], duration=d["duration"], backend="xla")
    wavs, labels = jds.load_batch(np.arange(8))
    feats = jax_features(jfe, jnp.asarray(wavs))
    jmodel = jax_build_model(cfg)
    variables = jmodel.init(jax.random.PRNGKey(0), feats, train=False)
    logits = jmodel.apply(variables, feats, train=False)
    num, den = jax_wce(logits, jnp.asarray(labels), jnp.ones(4, jnp.float32),
                       jnp.ones(len(labels), jnp.float32))
    want = float(num) / float(den)

    model = build_model(cfg)
    model.load_state_dict(state_dict_from_flax(jax.tree_util.tree_map(np.asarray, variables)))
    fe = MelFrontend(sample_rate=d["sample_rate"], n_mels=d["n_mels"], n_fft=d["n_fft"],
                     hop_length=d["hop_length"], duration=d["duration"])
    shape, loss = diagnose_data.first_batch_loss(ds, model, fe, cfg, torch.device("cpu"))
    assert shape == (8, 4)
    assert abs(loss - want) <= 1e-4, (loss, want)


def test_segmented_no_plots_and_cuda_default(setup, tmp_path, monkeypatch):
    """--segmented over the per-class layout with --no-plots writes no
    picture; the default --device asks for cuda, which raises here."""
    config_path, cfg, _ = setup
    seg = generate_segmented_dataset(tmp_path / "seg", per_class=3, duration=1.0, seed=2)
    monkeypatch.chdir(tmp_path)
    got = diagnose_data.main(["--config", str(config_path), "--segmented", "--data-path",
                              str(seg), "--device", "cpu", "--no-plots"])
    assert not (tmp_path / "data_samples.png").exists()
    assert got["size"] == sum(got["counts"]) == int(0.7 * 12)
    assert all(s["finite"] for s in got["samples"]) and np.isfinite(got["loss"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        diagnose_data.main(["--config", str(config_path)])
