"""The port's segmented ICBHI data path against the JAX package's, on the
CPU: the synthetic writers, the segmenter (and its entry point) on the
corpus fixture, and the segmented dataset's splits and items.

Both packages write from the same seed into their own directories; the
files must be byte-equal. The datasets index one directory, so their
(path, label) lists must be equal, split for split.
"""

import json
from pathlib import Path

import numpy as np
import pytest

from audio_classification_icbhi_tpu.data import synthetic as jax_synth
from audio_classification_icbhi_tpu.data.dataset_segmented import (
    ICBHISegmentedDataset as JaxSegmented,
)
from audio_classification_icbhi_tpu.data.segmenter import ICBHISegmenter as JaxSegmenter
from audio_classification_icbhi_tpu_torch import preprocess_icbhi
from audio_classification_icbhi_tpu_torch.data import synthetic
from audio_classification_icbhi_tpu_torch.data.dataset_segmented import ICBHISegmentedDataset
from audio_classification_icbhi_tpu_torch.data.segmenter import ICBHISegmenter
from audio_classification_icbhi_tpu_torch.utils.config import load_config

REPO = Path(__file__).resolve().parent.parent


def tree_bytes(root: Path) -> dict[str, bytes]:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


def assert_same_tree(got: Path, want: Path) -> None:
    g, w = tree_bytes(got), tree_bytes(want)
    assert sorted(g) == sorted(w)
    assert g, "no files written"
    for name in w:
        assert g[name] == w[name], name


@pytest.mark.parametrize("kwargs", [
    dict(per_class=3, duration=0.5, seed=0),
    dict(per_class=2, duration=0.5, seed=1, hard=True, coverage="dense"),
    dict(duration=0.4, seed=2, hard=True, class_counts=synthetic.icbhi_class_counts(12)),
], ids=["easy", "hard-dense", "icbhi-skew"])
def test_segmented_writer_bytes_equal(tmp_path, kwargs):
    assert synthetic.icbhi_class_counts(12) == jax_synth.icbhi_class_counts(12)
    synthetic.generate_segmented_dataset(tmp_path / "port", sample_rate=8000, **kwargs)
    jax_synth.generate_segmented_dataset(tmp_path / "jax", sample_rate=8000, **kwargs)
    assert_same_tree(tmp_path / "port", tmp_path / "jax")


@pytest.mark.parametrize("total", [1, 12, 100, 6898])
def test_icbhi_class_counts(total):
    assert synthetic.icbhi_class_counts(total) == jax_synth.icbhi_class_counts(total)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The corpus fixture written by each package (mixed native rates, CRLF
    and header lines, a zero-length cycle every fourth recording)."""
    root = tmp_path_factory.mktemp("corpus")
    synthetic.generate_icbhi_corpus_fixture(root / "port", num_recordings=10,
                                            cycles_per_recording=4, seed=3)
    jax_synth.generate_icbhi_corpus_fixture(root / "jax", num_recordings=10,
                                            cycles_per_recording=4, seed=3)
    return root


def test_corpus_fixture_bytes_equal(corpus):
    assert_same_tree(corpus / "port", corpus / "jax")
    rates = {p.name.rsplit("_", 1)[-1] for p in (corpus / "port").rglob("*.wav")}
    assert rates == {"AKGC417L.wav", "Litt3200.wav", "Meditron.wav", "LittC2SE.wav"}


@pytest.fixture(scope="module")
def segmented(corpus, tmp_path_factory):
    """Each package's segmenter on the same recordings, at 16 kHz."""
    out = tmp_path_factory.mktemp("segmented")
    audio = corpus / "port" / "audio_and_txt_files"
    port_stats = ICBHISegmenter(audio, out / "port").process_all()
    jax_stats = JaxSegmenter(audio, out / "jax").process_all()
    return out, port_stats, jax_stats


def test_segmenter_matches_jax(segmented):
    """Same file names, wav bytes and segmentation_stats.json."""
    out, port_stats, jax_stats = segmented
    assert port_stats == jax_stats
    assert port_stats["skipped_segments"] >= 3  # the zero-length cycles
    assert port_stats["total_segments"] + port_stats["skipped_segments"] >= 40
    assert_same_tree(out / "port", out / "jax")
    stats = json.loads((out / "port" / "segmentation_stats.json").read_text())
    assert stats == port_stats


def test_preprocess_entry_point(corpus, segmented, tmp_path, capsys):
    """`python -m ...preprocess_icbhi` with the top-level script's flags
    writes what the segmenter writes."""
    out, port_stats, _ = segmented
    stats = preprocess_icbhi.main([
        "--input-dir", str(corpus / "port" / "audio_and_txt_files"),
        "--output-dir", str(tmp_path / "seg"), "--sample-rate", "16000",
        "--min-duration", "0.5"])
    assert stats == port_stats
    assert_same_tree(tmp_path / "seg", out / "port")
    assert "Segmentation summary" in capsys.readouterr().out


def split_configs():
    no_data = {"model": {"num_classes": 4}}
    return {
        "config_segmented": load_config(str(REPO / "config_segmented.yaml")),  # renormalized
        "config": load_config(str(REPO / "config.yaml")),
        "no_data_section": no_data,
    }


@pytest.mark.parametrize("name", list(split_configs()))
@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_dataset_splits_match_jax(segmented, name, split, capsys):
    out, _, _ = segmented
    config = split_configs()[name]
    port = ICBHISegmentedDataset(out / "port", split, config)
    port_text = capsys.readouterr().out
    jax = JaxSegmented(out / "port", split, config)
    assert port.data == jax.data
    assert np.array_equal(port.labels, jax.labels) and port.labels.dtype == jax.labels.dtype
    assert port.target_length == jax.target_length
    assert port_text == capsys.readouterr().out  # the warning and class distribution


def test_renormalized_split_sizes(segmented):
    """config_segmented.yaml's 0.75 / 0.45 takes val to 0.125: the three
    splits partition the corpus and the test split is not empty."""
    out, stats, _ = segmented
    config = split_configs()["config_segmented"]
    sizes = [len(ICBHISegmentedDataset(out / "port", s, config)) for s in ("train", "val", "test")]
    total = stats["total_segments"]
    assert sizes[0] == int(0.75 * total) and sizes[1] == int(0.125 * total)
    assert sum(sizes) == total and sizes[2] > 0


@pytest.mark.parametrize("duration", [3.0, 1.0])
def test_items_and_batches_match_jax(segmented, duration):
    """__getitem__ and load_batch give the JAX dataset's arrays: padded
    (3 s, longer than most cycles) and cropped (1 s)."""
    out, _, _ = segmented
    config = {"data": {"sample_rate": 16000, "duration": duration}}
    port = ICBHISegmentedDataset(out / "port", "train", config)
    jax = JaxSegmented(out / "port", "train", config)
    for i in range(len(port)):
        (w, y), (jw, jy) = port[i], jax[i]
        assert y == jy and w.dtype == np.float32 and w.shape == (int(16000 * duration),)
        np.testing.assert_array_equal(w, jw)
    idxs = np.array([3, 0, len(port) - 1, 1])
    (w, y), (jw, jy) = port.load_batch(idxs), jax.load_batch(idxs)
    np.testing.assert_array_equal(w, jw)
    np.testing.assert_array_equal(y, jy)
    assert w.dtype == np.float32 and y.dtype == np.int32


@pytest.mark.parametrize("entry, png", [("train_icbhi", "icbhi_training_history.png"),
                                        ("train_segmented", "training_history_segmented.png")])
def test_segmented_train_entry_points(segmented, tmp_path, monkeypatch, capsys, entry, png):
    """`train_icbhi` (TrainerWithICBHI) and `train_segmented` (Trainer) train
    the per-cycle dataset on the CPU and draw their history PNG in the
    working directory; without --config both read config_segmented.yaml."""
    import importlib

    import yaml

    module = importlib.import_module(f"audio_classification_icbhi_tpu_torch.{entry}")
    out, stats, _ = segmented
    config = load_config(str(REPO / "config_segmented.yaml"))
    config["data"]["duration"] = 1.0
    config["training"].update(batch_size=4, gradient_accumulation_steps=2)
    (tmp_path / "c.yaml").write_text(yaml.safe_dump(config))
    monkeypatch.chdir(tmp_path)
    history = module.main(["--config", "c.yaml", "--data-path", str(out / "port"),
                           "--device", "cpu", "--epochs", "1"])
    text = capsys.readouterr().out
    assert len(history["train_loss"]) == 1 and np.isfinite(history["train_loss"]).all()
    assert ("icbhi_score" in history) == (entry == "train_icbhi")
    assert f"Training samples: {int(0.75 * stats['total_segments'])}" in text
    assert (tmp_path / "checkpoints" / "best_model.ckpt").exists()
    assert (tmp_path / png).stat().st_size > 5000

    seen = []

    def no_run(path):
        seen.append(path)
        raise KeyboardInterrupt

    # build_trainer (train.py) reads the config
    monkeypatch.setattr("audio_classification_icbhi_tpu_torch.train.load_config", no_run)
    with pytest.raises(KeyboardInterrupt):
        module.main(["--data-path", str(out / "port"), "--device", "cpu", "--no-plots"])
    assert seen == ["config_segmented.yaml"]
