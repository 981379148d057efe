"""The JAX package's public surface in the port, on the CPU.

- every name the JAX package's `__init__.py` files export (the package
  root, `ops`, `data`, `training`, `parallel`, `models`), read from their
  source with `ast`, resolves in the port's counterpart; importing the
  port's `ops` loads no kernel module;
- `ops.spectrogram` against the JAX one at power 1 and 2;
- `ops.freq_mask` / `time_mask` fed the JAX package's own draws against
  the JAX masks, bit for bit; the drawn form's bounds;
- `models.register_model`: a registered architecture trains through the
  `Trainer`, saves, resumes, serves through `ClassifierEngine` and
  `AnalyzerEngine`; the weight bridge's name tables of registered models,
  and a tree it cannot map.
"""

import ast
import importlib
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from audio_classification_icbhi_tpu.ops import augment as jax_aug
from audio_classification_icbhi_tpu.ops import stft as jax_stft
from audio_classification_icbhi_tpu_torch.analyzers.engine import AnalyzerEngine
from audio_classification_icbhi_tpu_torch.data.dataset_segmented import ICBHISegmentedDataset
from audio_classification_icbhi_tpu_torch.data.synthetic import generate_segmented_dataset
from audio_classification_icbhi_tpu_torch.data.wavio import write_wav
from audio_classification_icbhi_tpu_torch.inference import ClassifierEngine
from audio_classification_icbhi_tpu_torch.models import registry
from audio_classification_icbhi_tpu_torch.models.cnn import dropout, init_weights
from audio_classification_icbhi_tpu_torch.models.weights import (
    flax_from_state_dict,
    state_dict_from_flax,
)
from audio_classification_icbhi_tpu_torch.ops import augment as aug
from audio_classification_icbhi_tpu_torch.ops import stft as port_stft
from audio_classification_icbhi_tpu_torch.training.trainer import Trainer
from audio_classification_icbhi_tpu_torch.utils.checkpoint import load_checkpoint

REPO = Path(__file__).resolve().parent.parent
JAX_PKG, PORT_PKG = "audio_classification_icbhi_tpu", "audio_classification_icbhi_tpu_torch"
SUBPACKAGES = ("", "ops", "data", "training", "parallel", "models")

# JAX exports the port does not provide, each with its reason. Every name
# of the JAX package's `__init__.py` files resolves in the port, so it is
# empty; a JAX-only helper that is no export (`init_variables`,
# `recover_ema_chain`, ...) is listed in ROADMAP.md with its reason.
NOT_PORTED: dict[str, str] = {}


def jax_exports(sub: str) -> list[str]:
    """The names the JAX package's `sub/__init__.py` imports, by its source."""
    path = REPO / JAX_PKG / sub / "__init__.py"
    tree = ast.parse(path.read_text())
    return sorted(alias.asname or alias.name for node in tree.body
                  if isinstance(node, ast.ImportFrom) for alias in node.names)


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_jax_exports_resolve_in_the_port(sub):
    """Each name resolves in the port's counterpart of the subpackage and is
    the port's own object (defined under the port's package), not a module;
    the port's __all__ lists it."""
    names = jax_exports(sub)
    assert names, sub
    stale = [k for k in NOT_PORTED if k.rpartition(".")[0] == sub
             and k.rpartition(".")[2] not in names]
    assert not stale, f"NOT_PORTED lists names the JAX package does not export: {stale}"
    port = importlib.import_module(".".join(filter(None, (PORT_PKG, sub))))
    for name in names:
        if f"{sub}.{name}" in NOT_PORTED:
            continue
        obj = getattr(port, name)
        assert not isinstance(obj, types.ModuleType), f"{sub}.{name} is a module"
        owner = getattr(obj, "__module__", None)
        assert owner is None or owner.startswith(PORT_PKG), f"{sub}.{name} from {owner}"
        assert name in getattr(port, "__all__", dir(port)), f"{sub}.{name} not in __all__"


def test_subpackages_import_lazily():
    """In a fresh process: importing the port's `ops` loads no kernel module
    (`mel_kernels`, `conv_kernels`), and none of the subpackages imports
    another's modules or makes a cycle; an export loads its module on first
    access (`ops.fused_conv_block1` loads `conv_kernels` alone)."""
    code = f"""
import sys
sys.path.insert(0, {str(REPO)!r})
kernels = ("{PORT_PKG}.ops.mel_kernels", "{PORT_PKG}.ops.conv_kernels")
import {PORT_PKG}.ops as ops
assert not [m for m in kernels if m in sys.modules], sorted(sys.modules)
for sub in ("data", "training", "parallel", "utils"):
    __import__("{PORT_PKG}." + sub)
assert not [m for m in kernels if m in sys.modules]
ops.fused_conv_block1
assert kernels[1] in sys.modules and kernels[0] not in sys.modules
assert callable(ops.resample) and ops.resample.__module__ == "{PORT_PKG}.ops.resample"
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=str(REPO))
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


# --- spectrogram ------------------------------------------------------------------

def numpy_spectrogram(x: np.ndarray, n_fft: int, hop: int, power: float) -> np.ndarray:
    """float64: reflect padding by n_fft // 2, periodic Hann, |rfft| ** power,
    (..., bins, frames)."""
    padded = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(n_fft // 2, n_fft // 2)], mode="reflect")
    frames = 1 + x.shape[-1] // hop
    idx = np.arange(frames)[:, None] * hop + np.arange(n_fft)
    window = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft)
    spec = np.abs(np.fft.rfft(padded[..., idx] * window, axis=-1)) ** power
    return np.swapaxes(spec, -1, -2)


@pytest.mark.parametrize("power", [1.0, 2.0])
def test_spectrogram_matches_jax(rng, power):
    """`ops.spectrogram` against the JAX `ops/stft.spectrogram` on seeded
    noise: the same (B, bins, T) layout, and every value within rtol 1e-5
    of the largest (the JAX one's f32 FFT is itself up to 5e-5 off float64
    in the quietest bins); in float64 the port equals the numpy chain to
    1e-10."""
    x = (0.3 * rng.standard_normal((3, 2000))).astype(np.float32)
    want = np.asarray(jax_stft.spectrogram(jnp.asarray(x), 256, 64, power=power))
    got = port_stft.spectrogram(torch.from_numpy(x), 256, 64, power=power).numpy()
    assert got.shape == want.shape == (3, 129, 32)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    exact = port_stft.spectrogram(torch.from_numpy(x).double(), 256, 64, power=power).numpy()
    np.testing.assert_allclose(exact, numpy_spectrogram(x.astype(np.float64), 256, 64, power),
                               rtol=1e-10, atol=1e-12)


# --- freq_mask / time_mask --------------------------------------------------------

def jax_mask_draw(key, size: int, mask_param: int) -> aug.MaskDraw:
    """The draws the JAX package's `_mask_along_axis` makes from `key`
    (`ops/augment.py:55-77` there), as the port's MaskDraw."""
    k_w, k_s = jax.random.split(key)
    width = jax.random.uniform(k_w, (), minval=0.0, maxval=float(mask_param))
    start = jax.random.uniform(k_s, (), minval=0.0, maxval=float(size) - width)
    return aug.MaskDraw(torch.from_numpy(np.array(width)), torch.from_numpy(np.array(start)))


MASKS = {"freq": (jax_aug.freq_mask, -2, 15), "time": (jax_aug.time_mask, -1, 35)}


@pytest.mark.parametrize("which", sorted(MASKS))
@pytest.mark.parametrize("shape", [(3, 32, 40), (32, 40)])
def test_masks_match_jax_exactly(rng, which, shape):
    """`mask_along_axis` fed the JAX package's own draws equals the JAX
    `freq_mask` / `time_mask` bit for bit, over keys 0-7 (both bounds
    truncated: the keys include draws whose start + width crosses an
    integer that start + floor(width) does not reach, and draws that do
    not)."""
    jax_fn, axis, param = MASKS[which]
    spec = rng.standard_normal(shape).astype(np.float32)
    crossed = []
    for seed in range(8):
        key = jax.random.PRNGKey(seed)
        draw = jax_mask_draw(key, shape[axis], param)
        want = np.asarray(jax_fn(key, jnp.asarray(spec)))
        got = aug.mask_along_axis(torch.from_numpy(spec), draw, axis).numpy()
        np.testing.assert_array_equal(got, want)
        start, end = float(draw.start), float(draw.start + draw.width)
        crossed.append(np.floor(end) > np.floor(start) + np.floor(float(draw.width)))
    assert any(crossed) and not all(crossed)


def test_mask_truncates_both_bounds():
    """start 2.7, width 1.5: the cells [floor(2.7), floor(4.2)) = [2, 4),
    two cells where truncating the width would mask one."""
    draw = aug.MaskDraw(torch.tensor(1.5), torch.tensor(2.7))
    out = aug.mask_along_axis(torch.ones(2, 10, 6), draw, -2)
    assert out[:, 2:4].eq(0).all() and out[:, :2].eq(1).all() and out[:, 4:].eq(1).all()
    out = aug.mask_along_axis(torch.ones(10, 6), draw, -1)
    assert out[:, 2:4].eq(0).all() and out.sum() == 40


@pytest.mark.parametrize("which", sorted(MASKS))
def test_drawn_masks_in_range(which):
    """The drawn form: 200 draws from a generator give width in [0, param)
    and start in [0, size - width]; each mask zeroes one contiguous band of
    at most `param` cells inside the axis, the same in every leading index;
    the drawn mask equals `mask_along_axis` of `draw_mask` from the same
    seed."""
    fn = {"freq": aug.freq_mask, "time": aug.time_mask}[which]
    _, axis, param = MASKS[which]
    g = torch.Generator().manual_seed(11)
    shape = (2, 32, 40)
    size = shape[axis]
    for _ in range(200):
        d = aug.draw_mask(g, size, param)
        assert 0.0 <= float(d.width) < param and 0.0 <= float(d.start) <= size - float(d.width)
    for seed in range(20):
        out = fn(torch.Generator().manual_seed(seed), torch.ones(shape))
        zeroed = (out == 0).all(dim=-1 if axis == -2 else -2)  # (2, size)
        assert torch.equal(zeroed[0], zeroed[1])
        cells = torch.nonzero(zeroed[0]).flatten().tolist()
        assert len(cells) <= param and cells == list(range(cells[0], cells[0] + len(cells))) \
            if cells else True
        again = aug.mask_along_axis(torch.ones(shape), aug.draw_mask(
            torch.Generator().manual_seed(seed), size, param), axis)
        assert torch.equal(out, again)


# --- register_model ---------------------------------------------------------------

class TinyNet(nn.Module):
    """A user's architecture in the port's contract: conv3x3 -> BatchNorm ->
    ReLU -> global mean -> dropout from the generator -> dense."""

    def __init__(self, num_classes: int = 4, dropout: float = 0.3,
                 dtype: torch.dtype = torch.float32, generator=None, axis_name=None):
        super().__init__()
        self.dtype, self.p = dtype, dropout
        self.conv = nn.Conv2d(1, 8, 3, padding=1, bias=False)
        self.bn = nn.BatchNorm2d(8)
        self.fc = nn.Linear(8, num_classes)
        self.reset_parameters(generator)

    def reset_parameters(self, generator=None) -> None:
        init_weights(self, generator)

    def forward(self, x, generator=None):
        x = F.conv2d(x.permute(0, 3, 1, 2).to(self.dtype), self.conv.weight.to(self.dtype),
                     padding=1)
        x = F.relu(self.bn(x.float())).mean(dim=(2, 3))
        if self.training:
            x = dropout(x, self.p, generator)
        return F.linear(x, self.fc.weight, self.fc.bias)


class TabledNet(TinyNet):
    """TinyNet with its own flax name table."""

    @staticmethod
    def weight_table():
        return [("conv", ("Conv_0",), "conv"), ("bn", ("BatchNorm_0",), "bn"),
                ("fc", ("Dense_0",), "linear")]


@pytest.fixture
def registered():
    """Registers TinyNet as "tinynet" and TabledNet as "tablednet", and
    removes both afterwards: later test files run in the same worker."""
    registry.register_model("tinynet")(TinyNet)
    registry.register_model("tablednet")(TabledNet)
    yield
    for name in ("tinynet", "tablednet"):
        registry._REGISTRY.pop(name)


SMALL_FE = dict(sample_rate=4000, n_mels=32, n_fft=256, hop_length=64, duration=0.5)


def tiny_config(tmp: Path, architecture: str) -> dict:
    return {
        "data": {"dataset_path": "unused", **SMALL_FE, "augmentation": True,
                 "train_split": 0.7, "val_split": 0.15},
        "model": {"architecture": architecture, "num_classes": 4, "dropout": 0.2},
        "training": {"batch_size": 8, "epochs": 1, "learning_rate": 3e-3,
                     "weight_decay": 1e-4, "optimizer": "adam", "scheduler": "cosine",
                     "mixed_precision": False, "gradient_accumulation_steps": 2,
                     "early_stopping_patience": 50, "save_every": 1,
                     "checkpoint_dir": str(tmp / "ckpts"), "log_dir": str(tmp / "runs")},
        "classes": ["normal", "crackles", "wheezes", "both"],
        "seed": 0,
    }


def test_registered_model_trains_saves_serves_and_analyzes(registered, tmp_path):
    """A registered architecture reaches every entry point through
    build_model: `available_models()` lists it; one Trainer epoch trains it
    on the segmented corpus (its loss finite, its weights moved) and writes
    a checkpoint whose params tree holds its torch names split at the dots;
    a new Trainer resumes from it with the weights and Adam's state equal;
    `ClassifierEngine(device="cpu")` serves it with the trained weights
    (probabilities equal to the trained model's own softmax) and
    `AnalyzerEngine` analyzes a recording with it."""
    assert {"cnn", "resnet", "tinynet"} <= set(registry.available_models())
    root = generate_segmented_dataset(tmp_path / "seg", per_class=8, duration=0.5,
                                      sample_rate=4000)
    config = tiny_config(tmp_path, "tinynet")

    def trainer():
        return Trainer(registry.build_model(config),
                       ICBHISegmentedDataset(root, "train", config, augment=True),
                       ICBHISegmentedDataset(root, "val", config), config, device="cpu")

    t = trainer()
    assert isinstance(t.model, TinyNet)
    before = {k: v.clone() for k, v in t.model.state_dict().items()}
    hist = t.train()
    assert np.isfinite(hist["train_loss"]).all() and np.isfinite(hist["val_loss"]).all()
    assert not torch.equal(before["conv.weight"], t.model.conv.weight.detach())
    ckpt = Path(config["training"]["checkpoint_dir"]) / "checkpoint_epoch_1.ckpt"
    saved = load_checkpoint(ckpt)
    assert saved["config"]["model"]["architecture"] == "tinynet"
    assert set(saved["params"]) == {"conv", "bn", "fc"} and "running_var" in saved["params"]["bn"]

    resumed = trainer()
    resumed.restore(ckpt)
    for k, v in t.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], v), k
    for p, q in zip(t.optimizer.param_groups[0]["params"],
                    resumed.optimizer.param_groups[0]["params"], strict=True):
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(t.optimizer.state[p][key], resumed.optimizer.state[q][key])

    engine = ClassifierEngine(ckpt, device="cpu")
    assert isinstance(engine.model, TinyNet)
    clips = np.stack([ICBHISegmentedDataset(root, "test", config)[i][0] for i in range(4)])
    probs = engine.predict_probs(clips)
    t.model.eval()
    with torch.no_grad():
        feats = engine.frontend(torch.from_numpy(clips))[..., None]
        want = torch.softmax(t.model(feats), dim=-1).numpy()
    np.testing.assert_allclose(probs, want, rtol=1e-5, atol=1e-6)

    wav = tmp_path / "rec.wav"
    write_wav(wav, np.concatenate(list(clips)), 4000)
    analyzer = AnalyzerEngine(str(ckpt), segment_duration=0.5, sample_rate=4000, device="cpu")
    results, _ = analyzer.analyze_audio(wav)
    assert isinstance(analyzer.classifier.model, TinyNet) and len(results) == 8


def test_registered_table_crosses_under_flax_names(registered):
    """A registered class's `weight_table()` maps its weights to flax
    names and layouts (a conv kernel (H, W, I, O), BatchNorm statistics in
    batch_stats) and back; without a table its state_dict crosses under its
    own names, dtypes kept."""
    model = TabledNet(generator=torch.Generator().manual_seed(1))
    sd = model.state_dict()
    v = flax_from_state_dict(sd, "tablednet")
    assert set(v["params"]) == {"Conv_0", "BatchNorm_0", "Dense_0"}
    assert v["params"]["Conv_0"]["kernel"].shape == (3, 3, 1, 8)
    assert set(v["batch_stats"]["BatchNorm_0"]) == {"mean", "var"}
    back = state_dict_from_flax(v, "TabledNet")
    for k, t in sd.items():
        assert torch.equal(back[k], t if "num_batches" not in k else torch.tensor(0)), k
    plain = flax_from_state_dict(TinyNet().state_dict(), "tinynet")
    assert plain["params"]["bn"]["num_batches_tracked"].dtype == np.int64
    back = state_dict_from_flax(plain, "tinynet")
    assert back["bn.num_batches_tracked"].dtype == torch.int64


def test_bridge_raises_on_a_tree_it_cannot_map():
    """A tree that matches neither builtin, of an architecture with no
    registered table, raises naming the architecture, both ways; a
    checkpoint's unregistered architecture fails in build_model."""
    with pytest.raises(ValueError, match="'mynet'"):
        flax_from_state_dict({"body.weight": torch.zeros(2)}, "mynet")
    with pytest.raises(ValueError, match="'cnn'"):
        state_dict_from_flax({"params": {"body": {"kernel": np.zeros(2)}}}, "cnn")
    with pytest.raises(ValueError, match="None"):
        flax_from_state_dict({"body.weight": torch.zeros(2)})
    with pytest.raises(ValueError, match="Unknown model architecture: 'mynet'"):
        registry.build_model({"model": {"architecture": "MyNet", "num_classes": 4,
                                        "dropout": 0.1}})
