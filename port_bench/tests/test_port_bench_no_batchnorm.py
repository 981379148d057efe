"""A model with no BatchNorm in the harness: a transformer cell added as
files alone, the seeded weights' rules, and the compared numbers.

The toy cell follows the Audio Spectrogram Transformer's equations (Gong et
al., Interspeech 2021, `src/models/ast_models.py`) at small widths: a
16 x 16 patch convolution at stride 10 over the (n_mels, T) image, the
class and distillation tokens, a positional table of F x T_TABLE patches
whose centre columns are cropped to the input's T, pre-LN blocks (exact
GELU, a bias on qkv, LayerNorm eps 1e-6), the final LayerNorm, the mean of
the two tokens, then LayerNorm and Linear. No dropout (AST's rates are 0).
The program's side (`ToyAST`) takes the port's registry contract and
`F.scaled_dot_product_attention`; its plain twin (`Twin`, float32 through
`reference/layers.Ops`) writes the softmax out and can keep its rows.
"""

from __future__ import annotations

import hashlib
import json
import math
import shutil
import sys
import types
import warnings
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F
from torch import nn

from port_bench import compare, corpus, counts, run
from port_bench.reference import readings, step
from port_bench.reference.frontend import features
from port_bench.reference.layers import Ops
from test_port_bench_faults import FAULTS

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "port_bench"
SEED = 2**31 + 4321

NAME = "toy_ast"
WIDTH, HEADS, MLP, DEPTH = 32, 2, 128, 2
PATCH, STRIDE = 16, 10
F_PATCHES, T_TABLE = 12, 9  # (128 mels - 16) // 10 + 1 rows; the table's columns


def patches(n: int) -> int:
    return (n - PATCH) // STRIDE + 1


def _build(model: nn.Module, num_classes: int) -> None:
    """The parameters both sides share, under timm's names."""
    model.cls_token = nn.Parameter(torch.zeros(1, 1, WIDTH))
    model.dist_token = nn.Parameter(torch.zeros(1, 1, WIDTH))
    model.pos_embed = nn.Parameter(torch.zeros(1, 2 + F_PATCHES * T_TABLE, WIDTH))
    model.patch_embed = nn.Conv2d(1, WIDTH, PATCH, stride=STRIDE)
    model.blocks = nn.ModuleList()
    for _ in range(DEPTH):
        block = nn.Module()
        block.norm1 = nn.LayerNorm(WIDTH, eps=1e-6)
        block.attn = nn.Module()
        block.attn.qkv = nn.Linear(WIDTH, 3 * WIDTH)
        block.attn.proj = nn.Linear(WIDTH, WIDTH)
        block.norm2 = nn.LayerNorm(WIDTH, eps=1e-6)
        block.mlp = nn.Module()
        block.mlp.fc1 = nn.Linear(WIDTH, MLP)
        block.mlp.fc2 = nn.Linear(MLP, WIDTH)
        model.blocks.append(block)
    model.norm = nn.LayerNorm(WIDTH, eps=1e-6)
    model.mlp_head = nn.Sequential(nn.LayerNorm(WIDTH), nn.Linear(WIDTH, num_classes))


def _tokens(model: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """(B, WIDTH, F, T) patch embeddings -> (B, 2 + F·T, WIDTH) tokens with
    the positional table's centre T columns added."""
    b, _, f, t = x.shape
    start = T_TABLE // 2 - t // 2
    grid = model.pos_embed[:, 2:].reshape(1, F_PATCHES, T_TABLE, WIDTH)[:, :f, start:start + t]
    pos = torch.cat([model.pos_embed[:, :2], grid.reshape(1, f * t, WIDTH)], 1)
    cls = torch.cat([model.cls_token, model.dist_token], 1).expand(b, -1, -1)
    return torch.cat([cls.to(x.dtype), x.flatten(2).transpose(1, 2)], 1) + pos.to(x.dtype)


class ToyAST(nn.Module):
    """The program's side, under the port's registry contract: input
    (B, n_mels, T, 1), float32 logits."""

    scale_power = 0.5  # the softmax scale is head_dim ** -scale_power

    def __init__(self, num_classes=4, dropout=0.0, dtype=torch.float32, generator=None,
                 axis_name=None):
        super().__init__()
        self.dtype = dtype
        _build(self, num_classes)
        self.reset_parameters(generator)

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.endswith("bias"):
                    p.zero_()
                elif p.ndim == 1:
                    p.fill_(1.0)
                else:
                    p.normal_(0.0, 0.02, generator=generator)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        dt, hd = self.dtype, WIDTH // HEADS

        def linear(h, layer):
            return F.linear(h, layer.weight.to(dt), layer.bias.to(dt))

        def norm(h, layer):
            return F.layer_norm(h, (WIDTH,), layer.weight.to(dt), layer.bias.to(dt), layer.eps)

        x = F.conv2d(x.permute(0, 3, 1, 2).to(dt), self.patch_embed.weight.to(dt),
                     self.patch_embed.bias.to(dt), stride=STRIDE)
        x = _tokens(self, x)
        b, n, _ = x.shape
        for block in self.blocks:
            qkv = linear(norm(x, block.norm1), block.attn.qkv)
            q, k, v = qkv.reshape(b, n, 3, HEADS, hd).permute(2, 0, 3, 1, 4)
            o = F.scaled_dot_product_attention(q, k, v, scale=hd ** -self.scale_power)
            x = x + linear(o.transpose(1, 2).reshape(b, n, WIDTH), block.attn.proj)
            h = F.gelu(linear(norm(x, block.norm2), block.mlp.fc1))
            x = x + linear(h, block.mlp.fc2)
        x = norm(x, self.norm)
        x = norm((x[:, 0] + x[:, 1]) / 2, self.mlp_head[0])
        return linear(x, self.mlp_head[1]).float()


class Twin(nn.Module):
    """The plain twin, as a `reference/<architecture>.py` provides it:
    `Model(num_classes, dropout, precision)` with `forward(x, train, g)`,
    x (B, 1, n_mels, T). Where `probs` is a list, each attention's
    softmax rows (B, heads, N, N) are appended to it."""

    def __init__(self, num_classes: int, dropout: float, precision: str = "f32"):
        super().__init__()
        _build(self, num_classes)
        self.ops = Ops(precision)
        self.probs = None

    def forward(self, x: torch.Tensor, train: bool, g: torch.Generator | None = None):
        ops, hd = self.ops, WIDTH // HEADS
        x = _tokens(self, ops.conv(x, self.patch_embed.weight, STRIDE)
                    + self.patch_embed.bias[:, None, None])
        b, n, _ = x.shape
        for block in self.blocks:
            qkv = ops.linear(block.norm1(x), block.attn.qkv).reshape(b, n, 3, HEADS, hd)
            q, k, v = (ops.q(t) for t in qkv.permute(2, 0, 3, 1, 4))
            p = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(hd), dim=-1)
            if self.probs is not None:
                self.probs.append(p.detach())
            o = ops.q(p @ v).transpose(1, 2).reshape(b, n, WIDTH)
            x = x + ops.linear(o, block.attn.proj)
            x = x + ops.linear(F.gelu(ops.linear(block.norm2(x), block.mlp.fc1)), block.mlp.fc2)
        x = self.norm(x)
        return ops.linear(self.mlp_head[0]((x[:, 0] + x[:, 1]) / 2), self.mlp_head[1])


def transformer_gflop(h: int, w: int, classes: int, width: int, depth: int, mlp: int) -> float:
    """Forward GFLOP of one (h, w) input, 2 per multiply-add: the patch
    convolution, then per block qkv, QKᵀ, AV, the projection and the MLP
    over N = 2 + patches tokens, then the head."""
    p = patches(h) * patches(w)
    n = p + 2
    block = 2 * n * width * 3 * width + 2 * 2 * n * n * width + 2 * n * width * width \
        + 2 * 2 * n * width * mlp
    return (2 * p * width * PATCH * PATCH + depth * block + 2 * width * classes) / 1e9


def twin_module() -> types.ModuleType:
    module = types.ModuleType(f"port_bench.reference.{NAME}")
    module.Model = Twin
    module.forward_gflop = lambda h, w, classes=4: transformer_gflop(h, w, classes, WIDTH,
                                                                     DEPTH, MLP)
    module.first_layer_gflop = lambda h, w: 2 * patches(h) * patches(w) * WIDTH * PATCH ** 2 / 1e9
    return module


def _attention_scale(monkeypatch):
    """The toy program's softmax scale 1 / d in place of 1 / √d."""
    monkeypatch.setattr(ToyAST, "scale_power", 1.0)


@pytest.fixture
def toy(monkeypatch):
    """The toy architecture in the port's registry and its twin among the
    reference's modules, both removed after the test."""
    from audio_classification_icbhi_tpu_torch.models import registry

    monkeypatch.setitem(registry._REGISTRY, NAME, ToyAST)
    monkeypatch.setitem(sys.modules, f"port_bench.reference.{NAME}", twin_module())
    cfg = json.loads((BENCH / "configs" / "lwcnn-icbhi8s.json").read_text())
    cfg["config"]["model"].update(architecture=NAME, dropout=0.0)
    return cfg


def mean_row_entropy(cfg: dict, state: dict, wavs: torch.Tensor) -> tuple[float, int]:
    """The mean entropy of the twin's attention rows under `state`, and
    the rows' length N."""
    twin = Twin(cfg["model"]["num_classes"], 0.0)
    twin.load_state_dict(state)
    twin.probs = []
    with torch.no_grad():
        twin(features(wavs, cfg["data"]), train=False)
    p = torch.cat([q.flatten(0, -2) for q in twin.probs])
    return float(-(p * p.clamp_min(1e-30).log()).sum(-1).mean()), p.shape[-1]


def test_transformer_cell_is_files_alone(tmp_path, small, toy, monkeypatch):
    """A BatchNorm-free transformer cell added as new files (config,
    checks) and manifest entries runs `correct`; each fault it can have
    (and the softmax scale 1/d) makes it not so; the seeded weights give
    attention rows well below uniform; no file that was there changed."""
    shutil.copytree(BENCH, tmp_path / "port_bench", ignore=shutil.ignore_patterns("tests"))
    before = {p: p.read_bytes() for p in (tmp_path / "port_bench").rglob("*") if p.is_file()}
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    (tmp_path / "port_bench" / "configs" / "toy-ast.json").write_text(json.dumps(toy))
    # the LightweightCNN cell's limits with no statistics number, and the ResNet's val_batch_gap
    limits = {k: v for k, v in json.loads((BENCH / "checks" / "lwcnn-train-epochs.json")
                                          .read_text()).items() if not k.startswith("stats3")}
    limits["val_batch_gap"] = json.loads(
        (BENCH / "checks" / "resnet18-train-epochs.json").read_text())["val_batch_gap"]
    (tmp_path / "port_bench" / "checks" / "toy-ast-train-epochs.json").write_text(
        json.dumps(limits))
    manifest["configs"].append({"name": "toy-ast", "source": "x",
                                "file": "port_bench/configs/toy-ast.json", "reduced": [],
                                "why": "x"})
    manifest["workloads"].append({"name": "toy-ast-train-epochs", "config": "toy-ast",
                                  "traffic": "train-epochs", "chips": 1, "why": "x"})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "workloads" in m:
            m["workloads"].append("toy-ast-train-epochs")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))

    def execute(trace=False):
        return run.execute("toy-ast-train-epochs", SEED, 0.3, trace, device="cpu",
                           root=tmp_path, overrides=small)

    line = execute(trace=True)
    assert line["correct"], line["checks"]
    assert set(line["checks"]) == set(limits)
    assert line["metrics"]["mfu.train"]["value"] > 0

    cfg = run.deep_merge(toy["config"], small["config"])
    labels = corpus.seeded_labels(small["traffic"]["recordings"], SEED)
    pcm = corpus.make_clips(labels, 16000, 16000, SEED, torch.device("cpu"))
    wavs = torch.as_tensor(readings.pcm_to_float(pcm[:8]))
    entropy, n = mean_row_entropy(cfg, step.seeded_state(cfg, SEED, wavs), wavs)
    assert n == 2 + F_PATCHES * patches(1 + 16000 // cfg["data"]["hop_length"])
    assert entropy <= 0.9 * math.log(n), (entropy, math.log(n))

    faults = {f: FAULTS[f] for f in ("state_unchanged", "half_batch", "gradient_altered",
                                     "val_loss_altered")} | {"attention_scale": _attention_scale}
    for name, fault in faults.items():
        with monkeypatch.context() as m:
            fault(m)
            line = execute()
        assert not line["correct"], (name, line["checks"])
    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_transformer_gflop_at_ast_widths():
    """AST at ViT-Base widths over 128 mels x 801 frames: 12 x 79 patches,
    ≈ 195.0 GFLOP a forward, 33.3 of them QKᵀ and AV; ≈ 584.7 a train clip."""
    fwd = transformer_gflop(128, 801, 4, 768, 12, 3072)
    first = 2 * 12 * 79 * 768 * 256 / 1e9
    assert patches(128) * patches(801) == 948
    assert fwd == pytest.approx(195.0, abs=0.05)
    assert 12 * 2 * 2 * 950 ** 2 * 768 / 1e9 == pytest.approx(33.3, abs=0.05)
    assert counts.train_gflop(fwd, first) == pytest.approx(584.7, abs=0.05)


def test_numbers_of_a_model_without_batchnorm():
    """No running statistics: the stats3 numbers and their detail are
    absent, every other number finite, and nothing warns."""
    g = torch.Generator().manual_seed(0)
    grads = {n: torch.randn(4, 3, generator=g) for n in ("a", "b", "out")}

    def side(scale):
        return {"losses": [1.0 * scale, 0.9, 0.8], "val_losses": [1.1, 1.2 * scale],
                "grad1": {k: float(v.norm()) * scale for k, v in grads.items()},
                "grad1_tensors": {k: v * scale for k, v in grads.items()},
                "change": {k: 0.01 * scale for k in grads}, "stats": {}}

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        numbers = compare.train_numbers(side(1.01), side(1.0))
        detail = compare.train_detail(side(1.01), side(1.0))
    assert not any(k.startswith("stats3") for k in numbers) and "stats3_worst" not in detail
    assert all(math.isfinite(v) for v in numbers.values())
    assert numbers["grad1_gap"] == pytest.approx(0.01)


def seeded_state_digests(config_name: str, overrides: dict) -> dict[str, str]:
    """sha256 (first 16 hex digits) of each tensor's dtype, shape and bytes
    of `seeded_state` for a configuration at the overrides' sizes, seed
    SEED, calibrated on the first clips the corpus makes from it; one
    thread, so that the calibration's reductions take one order."""
    cfg = run.deep_merge(json.loads((BENCH / "configs" / f"{config_name}.json").read_text())
                         ["config"], overrides["config"])
    n, clips = overrides["traffic"]["recordings"], overrides["traffic"]["calibration_clips"]
    length = int(cfg["data"]["sample_rate"] * cfg["data"]["duration"])
    pcm = corpus.make_clips(corpus.seeded_labels(n, SEED), length, cfg["data"]["sample_rate"],
                            SEED, torch.device("cpu"))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        state = step.seeded_state(cfg, SEED, torch.as_tensor(readings.pcm_to_float(pcm[:clips])))
    finally:
        torch.set_num_threads(threads)
    return {k: hashlib.sha256(f"{v.dtype}{tuple(v.shape)}".encode()
                              + v.contiguous().numpy().tobytes()).hexdigest()[:16]
            for k, v in state.items()}


@pytest.mark.parametrize("config_name", ["lwcnn-icbhi8s", "resnet18-icbhi8s"])
def test_seeded_state_of_the_batchnorm_models_is_unchanged(config_name, small):
    """The rules for LayerNorm and for bare parameters change no tensor of
    the two BatchNorm models: the digests in `seeded_state_digests.json`
    were computed by `seeded_state_digests` on commit 9b6a5f5, before those
    rules, with torch 2.13.0 on the CPU."""
    pinned = json.loads((Path(__file__).parent / "seeded_state_digests.json").read_text())
    assert seeded_state_digests(config_name, small) == pinned[config_name]
