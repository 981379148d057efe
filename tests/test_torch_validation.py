"""The port's Validator and its two entry points against the JAX package's,
on the CPU, from the same weights and the same recordings: LightweightCNN
and CompactResNet18 (at stage_sizes (1, 1) and at full depth), fp32, with
a partial last batch on both sides.

The JAX side's front end is its f32 XLA path (`backend="xla"`, set from the
test as `tests/test_torch_engine.py` sets it): its CPU default, the bf16x4
radix-2 chain, is up to ~5e-4 dB from f32. y_true is equal, y_prob within
1e-4, and y_pred equal wherever the JAX side's top-2 margin exceeds 1e-4.
"""

import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import validate as jax_validate_script
import validate_icbhi as jax_validate_icbhi_script
from audio_classification_icbhi_tpu.data.dataset import ICBHIDataset as JaxDataset
from audio_classification_icbhi_tpu.models import build_model as jax_build_model
from audio_classification_icbhi_tpu.models.registry import init_variables
from audio_classification_icbhi_tpu.models.resnet import CompactResNet as FlaxResNet
from audio_classification_icbhi_tpu.ops import mel as jax_mel
from audio_classification_icbhi_tpu.training import validation as jax_validation
from audio_classification_icbhi_tpu.utils.checkpoint import save_checkpoint
from audio_classification_icbhi_tpu_torch import validate, validate_icbhi
from audio_classification_icbhi_tpu_torch.data.dataset import ICBHIDataset
from audio_classification_icbhi_tpu_torch.data.loader import BatchLoader
from audio_classification_icbhi_tpu_torch.data.synthetic import (
    generate_icbhi_dataset,
    generate_segmented_dataset,
)
from audio_classification_icbhi_tpu_torch.models import CompactResNet, build_model
from audio_classification_icbhi_tpu_torch.models.weights import state_dict_from_flax
from audio_classification_icbhi_tpu_torch.ops.mel import MelFrontend
from audio_classification_icbhi_tpu_torch.parallel.data_parallel import (
    eval_batches,
    make_eval_step,
)
from audio_classification_icbhi_tpu_torch.parallel.mesh import get_mesh
from audio_classification_icbhi_tpu_torch.training.validation import Validator
from audio_classification_icbhi_tpu_torch.utils.config import load_config
from audio_classification_icbhi_tpu_torch.utils.metrics import calculate_metrics
from test_torch_resnet import flax_resnet_variables

REPO = Path(__file__).resolve().parent.parent
FRAMES = 32  # 1 s at 16 kHz, hop 512


class XlaMelFrontend(jax_mel.MelFrontend):
    """The JAX front end on its f32 XLA path whatever the config asks."""

    @classmethod
    def from_config(cls, config, **kwargs):
        return jax_mel.MelFrontend.from_config(config, backend="xla")


@pytest.fixture
def jax_f32_frontend(monkeypatch):
    monkeypatch.setattr(jax_validation, "MelFrontend", XlaMelFrontend)


def small_config(architecture: str = "cnn") -> dict:
    """config_segmented.yaml's schema at 1 s, fp32, batch 5: the JAX side
    rounds it to 8 (its 8 CPU devices), so both pad a partial last batch."""
    config = load_config(str(REPO / "config_segmented.yaml"))
    config["data"]["duration"] = 1.0
    config["model"]["architecture"] = architecture
    config["training"].update(batch_size=5, mixed_precision=False)
    return config


def cnn_variables(config) -> dict:
    """A flax init of LightweightCNN with non-trivial BN statistics and a
    x30 head, so that the classes separate."""
    v = jax.tree_util.tree_map(np.asarray, init_variables(
        jax_build_model(config), jax.random.PRNGKey(0), (1, 128, FRAMES, 1)))
    rng = np.random.default_rng(3)
    for blk in v["batch_stats"].values():
        bn = blk["BatchNorm_0"]
        bn["mean"] = (0.05 * rng.standard_normal(bn["mean"].shape)).astype(np.float32)
        bn["var"] = (1.0 + rng.random(bn["var"].shape)).astype(np.float32)
    for name in ("Dense_0", "Dense_1"):
        v["params"][name]["kernel"] = v["params"][name]["kernel"] * 30.0
    return v


MODELS = {
    "cnn": lambda config: (jax_build_model(config), build_model(config), cnn_variables(config)),
    "resnet-1-1": lambda config: (
        FlaxResNet(num_classes=4, stage_sizes=(1, 1)), CompactResNet(stage_sizes=(1, 1)),
        flax_resnet_variables((1, 1), (1, 128, FRAMES, 1))),
    "resnet": lambda config: (
        FlaxResNet(num_classes=4), CompactResNet(),
        flax_resnet_variables((2, 2, 2, 2), (1, 128, FRAMES, 1))),
}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """18 recordings: a train split of 12, so 5 + 5 + 2 in the port and
    8 + 4 in the JAX package."""
    return generate_icbhi_dataset(tmp_path_factory.mktemp("corpus"), num_recordings=18, seed=4)


def assert_same_predictions(got, want, atol: float = 1e-4) -> None:
    (y_true, y_pred, y_prob), (j_true, j_pred, j_prob) = got, want
    assert y_true.dtype == np.int64 and y_pred.dtype == np.int64 and y_prob.dtype == np.float32
    np.testing.assert_array_equal(y_true, j_true)
    np.testing.assert_allclose(y_prob, j_prob, atol=atol)
    top2 = np.sort(j_prob, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > atol
    np.testing.assert_array_equal(y_pred[clear], j_pred[clear])
    assert clear.mean() > 0.9


@pytest.mark.parametrize("arch", list(MODELS))
def test_validator_matches_jax(corpus, arch, jax_f32_frontend):
    config = small_config("resnet" if arch.startswith("resnet") else "cnn")
    flax_model, port_model, v = MODELS[arch](config)
    port_model.load_state_dict(state_dict_from_flax(v))
    dataset = ICBHIDataset(corpus, "train", config)
    assert len(dataset) % 5 and len(dataset) % 8  # a partial last batch on both sides
    got = Validator(port_model, dataset, config, device="cpu").validate()
    want = jax_validation.Validator(flax_model, JaxDataset(corpus, "train", config), config
                                    ).validate(v["params"], v["batch_stats"])
    assert got[2].shape == (len(dataset), 4)
    assert float(np.abs(want[2] - want[2].mean(0)).max()) > 1e-2  # the classes spread
    print(f"{arch}: max|y_prob port - jax| = {np.abs(got[2] - want[2]).max():.3e}")  # with -s
    assert_same_predictions(got, want)


def test_validator_raises_on_mesh_and_missing_gpu(corpus, monkeypatch):
    """A mesh of several devices for one process cannot be made (a rank
    validates on one device; data-parallel validation is
    tests/test_torch_data_parallel.py's), and the default device raises where
    no GPU exists."""
    config = small_config()
    model, dataset = build_model(config), ICBHIDataset(corpus, "val", config)
    with pytest.raises(ValueError, match="one device"):
        Validator(model, dataset, config, device="cpu", mesh=get_mesh(2, device="cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Validator(model, dataset, config)


def test_eval_batches_pads_and_keeps_the_real_rows(corpus):
    """The padded, masked pass the Validator and the trainer share: 12
    clips at batch 5 are 5 + 5 + 2, and the padded last batch gives the
    logits and masked sums of its two real clips run alone."""
    config = small_config()
    model = build_model(config, generator=torch.Generator().manual_seed(0))
    dataset = ICBHIDataset(corpus, "train", config)
    step = make_eval_step(model, MelFrontend.from_config(config))
    weights = torch.tensor([1.0, 2.0, 0.5, 1.5])
    batches = list(eval_batches(step, BatchLoader(dataset, 5, shuffle=False), 5,
                                torch.device("cpu"), weights))
    assert [len(b[4]) for b in batches] == [5, 5, 2]
    assert all(b[0].shape == (len(b[4]), 4) for b in batches)
    np.testing.assert_array_equal(np.concatenate([b[4] for b in batches]), dataset.labels)
    wavs, labels = dataset.load_batch([10, 11])
    logits, num, den, correct = step(torch.from_numpy(wavs), torch.from_numpy(labels).long(),
                                     torch.ones(2), weights)
    got = batches[-1]
    torch.testing.assert_close(got[0], logits, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(torch.stack(got[1:4]), torch.stack([num, den, correct]),
                               rtol=1e-5, atol=1e-6)


def test_validator_returns_the_logits_of_its_pass(corpus):
    """validate(with_logits=True): the same three arrays and the f32 logits
    whose softmax y_prob is."""
    config = small_config()
    model = build_model(config, generator=torch.Generator().manual_seed(0))
    validator = Validator(model, ICBHIDataset(corpus, "train", config), config, device="cpu")
    plain = validator.validate()
    *three, logits = validator.validate(with_logits=True)
    for a, b in zip(three, plain, strict=True):
        np.testing.assert_array_equal(a, b)
    assert logits.dtype == np.float32 and logits.shape == plain[2].shape
    np.testing.assert_allclose(torch.softmax(torch.from_numpy(logits), -1).numpy(), plain[2],
                               rtol=1e-6, atol=1e-7)


# --- the entry points on a JAX-written checkpoint -------------------------------

@pytest.fixture(scope="module")
def entry_data(corpus, tmp_path_factory):
    """A LightweightCNN checkpoint written by the JAX package's
    save_checkpoint with small_config() embedded, and a segmented corpus."""
    root = tmp_path_factory.mktemp("entries")
    config = small_config()
    config["data"]["dataset_path"] = str(corpus)
    v = cnn_variables(config)
    ckpt = save_checkpoint(root / "jax.ckpt", {
        "epoch": 1, "params": v["params"], "batch_stats": v["batch_stats"], "val_loss": 0.5,
        "config": config})
    segmented = generate_segmented_dataset(root / "segmented", per_class=10, duration=1.0, seed=5,
                                           hard=True)
    return ckpt, segmented


def run_jax_script(module, argv, monkeypatch, capsys):
    """The top-level script's main() with `argv`, its Validator's arrays
    recorded. Returns (stdout, (y_true, y_pred, y_prob))."""
    seen = []
    validate_fn = jax_validation.Validator.validate

    def recording(self, params, batch_stats):
        seen.append(validate_fn(self, params, batch_stats))
        return seen[-1]

    monkeypatch.setattr(jax_validation.Validator, "validate", recording)
    monkeypatch.setattr(sys, "argv", [module.__file__] + argv)
    capsys.readouterr()
    module.main()
    return capsys.readouterr().out, seen[-1]


def metric_lines(text: str, start: str) -> list[str]:
    """The metrics block a script prints, from its first line to the rule
    that closes it."""
    lines = text.splitlines()
    i = lines.index(start)
    j = next(k for k in range(i + 2, len(lines)) if set(lines[k]) == {"="})
    return lines[i - 1: j + 1]


def test_validate_entry_matches_jax_script(entry_data, corpus, tmp_path, monkeypatch, capsys,
                                           jax_f32_frontend):
    """`validate` and the top-level validate.py on the same checkpoint and
    split: the same arrays, the same printed metrics, and validation_test.json holds the numpy metrics of the
    port's arrays, its confusion matrix and ROC points; the PNGs of both."""
    ckpt, _ = entry_data
    args = ["--model", str(ckpt), "--config", str(REPO / "config.yaml"), "--split", "train",
            "--data-path", str(corpus)]
    out, want = run_jax_script(jax_validate_script, args + ["--output-dir", str(tmp_path / "jax")],
                               monkeypatch, capsys)
    result = validate.main(args + ["--output-dir", str(tmp_path / "port"), "--device", "cpu"])
    got_out = capsys.readouterr().out
    got = (result["y_true"], result["y_pred"], result["y_prob"])
    assert_same_predictions(got, want)
    np.testing.assert_array_equal(got[1], want[1])
    assert metric_lines(got_out, "CLASSIFICATION METRICS") == \
        metric_lines(out, "CLASSIFICATION METRICS")
    report = json.loads((tmp_path / "port" / "validation_train.json").read_text())
    class_names = small_config()["classes"]
    assert report == json.loads(json.dumps(validate.report(*got, class_names)))
    assert report["metrics"] == json.loads(json.dumps(calculate_metrics(*got, class_names)))
    for name in ("confusion_matrix_train.png", "roc_curves_train.png"):
        assert (tmp_path / "port" / name).stat().st_size > 5000
        assert (tmp_path / "jax" / name).exists()


def test_validate_icbhi_entry_matches_jax_script(entry_data, tmp_path, monkeypatch, capsys,
                                                 jax_f32_frontend):
    """`validate_icbhi` and the top-level validate_icbhi.py on the same
    checkpoint and segmented test split (config_segmented.yaml's renormalized
    fractions, from the checkpoint): the same arrays, the same printed ICBHI
    block and the same icbhi_results_test.txt, and both PNGs."""
    ckpt, segmented = entry_data
    args = ["--model", str(ckpt), "--data-path", str(segmented)]
    out, want = run_jax_script(jax_validate_icbhi_script,
                               args + ["--output-dir", str(tmp_path / "jax")], monkeypatch, capsys)
    result = validate_icbhi.main(args + ["--output-dir", str(tmp_path / "port"), "--device", "cpu"])
    got_out = capsys.readouterr().out
    got = (result["y_true"], result["y_pred"], result["y_prob"])
    assert_same_predictions(got, want)
    np.testing.assert_array_equal(got[1], want[1])
    assert metric_lines(got_out, "ICBHI 2017 CHALLENGE SCORE") == \
        metric_lines(out, "ICBHI 2017 CHALLENGE SCORE")
    text = (tmp_path / "port" / "icbhi_results_test.txt").read_text()
    assert text == (tmp_path / "jax" / "icbhi_results_test.txt").read_text()
    assert text.startswith("ICBHI 2017 results (test split)\n")
    for name in ("icbhi_metrics_test.png", "confusion_matrix_test.png"):
        assert (tmp_path / "port" / name).stat().st_size > 5000
