"""AST (`models/ast.py`) and the attention op (`ops/attention.py`) on the CPU:
the published widths and names against the harness's plain reference
(`port_bench/reference/ast.py`, plain torch, no JAX), the positional crop,
the forward and every gradient at narrow widths against the reference in
float32, the op against an explicit float64 softmax, and the Trainer's fused
and per-step epochs with checkpoints through msgpack and orbax."""

from __future__ import annotations

import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from audio_classification_icbhi_tpu_torch import tracing  # noqa: E402
from audio_classification_icbhi_tpu_torch.data.dataset_segmented import (  # noqa: E402
    ICBHISegmentedDataset,
)
from audio_classification_icbhi_tpu_torch.data.synthetic import (  # noqa: E402
    generate_segmented_dataset,
)
from audio_classification_icbhi_tpu_torch.models import ast as port_ast  # noqa: E402
from audio_classification_icbhi_tpu_torch.models import registry  # noqa: E402
from audio_classification_icbhi_tpu_torch.models.ast import AST  # noqa: E402
from audio_classification_icbhi_tpu_torch.ops.attention import attention  # noqa: E402
from audio_classification_icbhi_tpu_torch.training.trainer import Trainer  # noqa: E402
from audio_classification_icbhi_tpu_torch.utils.checkpoint import load_checkpoint  # noqa: E402
from port_bench.reference import ast as ref_ast  # noqa: E402

NARROW = dict(embed_dim=64, depth=2, heads=4, mlp_dim=256)
REF_NARROW = dict(width=64, depth=2, heads=4, mlp=256)
FRAMES_1S = 101  # 1 + 16,000 // 160: a 1 s clip at hop 160


def test_published_widths_and_names():
    """86,191,876 parameters at 4 classes (the whole 1,214-row table
    counted), and the state_dict names, in order, the reference's."""
    model = AST(num_classes=4)
    assert sum(p.numel() for p in model.parameters()) == 86_191_876
    assert model.v.pos_embed.shape == (1, 2 + 12 * 101, 768)
    assert list(model.state_dict()) == list(ref_ast.Model(4, 0.0).state_dict())
    cfg = {"model": {"architecture": "ast", "num_classes": 4, "dropout": 0.0},
           "training": {"mixed_precision": True}}
    built = registry.build_model(cfg, generator=torch.Generator().manual_seed(0))
    assert isinstance(built, AST) and built.dtype == torch.bfloat16
    assert len(built.v.blocks) == 12 and built.v.blocks[0].heads == 12


@pytest.mark.parametrize("frames, t_dim, start", [(801, 79, 11), (FRAMES_1S, 9, 46)])
def test_crop_arithmetic(frames, t_dim, start):
    """t_dim and the table's first column at 801 and 101 frames; the
    patches flattened frequency-major, each token given the table row of
    its (frequency, start + time) patch."""
    enc = port_ast.Encoder(width=2, depth=0, heads=1, mlp_dim=4)
    grid = enc.patch_embed.proj(torch.zeros(1, 1, 128, frames)).shape[2:]
    assert tuple(grid) == (ref_ast.patches(128), ref_ast.patches(frames)) == (12, t_dim)
    assert port_ast.crop_start(t_dim) == ref_ast.crop_start(t_dim) == start
    with torch.no_grad():
        f, c = torch.meshgrid(torch.arange(12.0), torch.arange(101.0), indexing="ij")
        enc.pos_embed[0, 2:, 0] = (1000 * f + c).reshape(-1)  # channel 0: its (f, column)
        enc.pos_embed[0, :2] = 0.0
        enc.pos_embed[0, 2:, 1] = 0.0
        enc.cls_token.zero_()
        enc.dist_token.zero_()
    pf, pt = torch.meshgrid(torch.arange(12.0), torch.arange(float(t_dim)), indexing="ij")
    x = torch.zeros(1, 2, 12, t_dim)
    x[0, 1] = 1000 * pf + pt  # channel 1: the patch's own (f, t)
    tok = enc.tokens(x).detach()
    assert tok.shape == (1, 2 + 12 * t_dim, 2)
    assert torch.equal(tok[0, 2:, 1], (1000 * pf + pt).reshape(-1))
    assert torch.equal(tok[0, 2:, 0], (1000 * pf + pt + start).reshape(-1))


def narrow_pair(generator: torch.Generator):
    """The port and the reference at narrow widths with one set of weights:
    Linear weights He-normal, N(0, 2 / fan_in), so that GELU sees inputs
    near 1, where erf and tanh part; the patch convolution, the biases, the
    tokens and the table N(0, 0.02²), so that the first LayerNorm sees a
    residual stream of variance near 1e-3, where eps 1e-6 and 1e-5 part;
    LayerNorm scales 1 + N(0, 0.1²) and shifts N(0, 0.1²)."""
    model = AST(**NARROW)
    ref = ref_ast.Model(4, 0.0, **REF_NARROW)
    kinds = {n: type(m) for n, m in model.named_modules()}
    state = {}
    for name, p in model.state_dict().items():
        z = torch.randn(p.shape, generator=generator)
        owner, leaf = name.rsplit(".", 1)
        if kinds.get(owner) is torch.nn.LayerNorm:
            state[name] = (1.0 if leaf == "weight" else 0.0) + 0.1 * z
        elif kinds.get(owner) is torch.nn.Linear and leaf == "weight":
            state[name] = z * math.sqrt(2.0 / p.shape[1])
        else:
            state[name] = 0.02 * z
    model.load_state_dict(state)
    ref.load_state_dict(state)
    return model, ref


def gaps(model, ref, x: torch.Tensor) -> tuple[float, float]:
    """(the logits' relative gap, the worst leaf's relative gradient gap)
    of the port against the reference on x (B, 128, T, 1), the loss the
    logits' sum weighted by a fixed draw."""
    w = torch.randn(x.shape[0], 4, generator=torch.Generator().manual_seed(7))
    got = model(x)
    want = ref(x.permute(0, 3, 1, 2), train=True)
    (got * w).sum().backward()
    (want * w).sum().backward()
    logits = float((got - want).detach().norm() / want.detach().norm())
    refs = dict(ref.named_parameters())
    grad = max(float((p.grad - refs[n].grad).norm() / refs[n].grad.norm())
               for n, p in model.named_parameters())
    return logits, grad


class _TanhGelu:
    """torch.nn.functional with GELU's tanh approximation in place of erf."""

    def __getattr__(self, name):
        return getattr(F, name)

    @staticmethod
    def gelu(x):
        return F.gelu(x, approximate="tanh")


def _tanh_gelu(model, monkeypatch):
    monkeypatch.setattr(port_ast, "F", _TanhGelu())


def _norm_eps(model, monkeypatch):
    for m in model.modules():
        if isinstance(m, torch.nn.LayerNorm) and m.eps == 1e-6:
            monkeypatch.setattr(m, "eps", 1e-5)


MUTATIONS = {"sound": None, "tanh_gelu": _tanh_gelu, "layer_norm_eps": _norm_eps}


@pytest.mark.parametrize("mutation", list(MUTATIONS))
def test_narrow_forward_and_gradients_match_reference(mutation, monkeypatch):
    """Narrow widths (64, 4 heads, MLP 256, 2 blocks) on 1 s clips (12 x 9
    patches, 110 tokens), float32, seeded weights. Logits within 1e-5
    relative: both sides run the same float32 operations in the same order
    but for attention's (the reference's matmuls against the op's plain
    version), a few ulps. Every leaf's gradient within 1e-4 relative: the
    backward sums over 110 tokens and 3 clips in other orders (the port's
    final LayerNorm takes the two token rows alone), ulps amplified by the
    LayerNorms' backward. The tanh GELU or LayerNorm eps 1e-5 in the port
    must fail them."""
    model, ref = narrow_pair(torch.Generator().manual_seed(3))
    if MUTATIONS[mutation] is not None:
        MUTATIONS[mutation](model, monkeypatch)
    x = torch.randn(3, 128, FRAMES_1S, 1, generator=torch.Generator().manual_seed(5))
    logits, grad = gaps(model, ref, x)
    if mutation == "sound":
        assert logits <= 1e-5 and grad <= 1e-4, (logits, grad)
    else:
        assert logits > 1e-5 or grad > 1e-4, (mutation, logits, grad)


def test_attention_cpu_matches_float64():
    """The CPU path against softmax(q kᵀ / √d) v in float64, forward and
    the three input gradients, within 2e-6 relative (float32 products over
    d = 32 and N = 40, a few ulps); bfloat16 in, bfloat16 out; no launch
    counted (the CPU runs the plain version)."""
    g = torch.Generator().manual_seed(11)
    q, k, v = (torch.randn(2, 3, 40, 32, generator=g, requires_grad=True) for _ in range(3))
    w = torch.randn(2, 3, 40, 32, generator=g)
    counts = (attention.launches, attention.launches_backward)
    out = attention(q, k, v)
    (out * w).sum().backward()
    q64, k64, v64 = (t.detach().double().requires_grad_() for t in (q, k, v))
    want = torch.softmax(q64 @ k64.transpose(-1, -2) / math.sqrt(32), dim=-1) @ v64
    (want * w.double()).sum().backward()
    for got, ref in [(out, want), (q.grad, q64.grad), (k.grad, k64.grad), (v.grad, v64.grad)]:
        assert float((got.detach().double() - ref.detach()).norm() / ref.detach().norm()) <= 2e-6
    assert attention(q.bfloat16(), k.bfloat16(), v.bfloat16()).dtype == torch.bfloat16
    assert (attention.launches, attention.launches_backward) == counts
    assert {"attention.launches", "attention.launches_backward"} <= set(tracing.counters())


class NarrowAST(AST):
    """AST at NARROW widths under the registry's contract."""

    def __init__(self, num_classes=4, dropout=0.0, dtype=torch.float32, generator=None,
                 axis_name=None):
        super().__init__(num_classes, dropout, dtype, generator, axis_name, **NARROW)


@pytest.fixture
def narrow_ast():
    """NarrowAST registered as "ast_narrow", removed afterwards: later test
    files run in the same worker."""
    registry.register_model("ast_narrow")(NarrowAST)
    yield "ast_narrow"
    registry._REGISTRY.pop("ast_narrow")


def ast_config(tmp: Path, architecture: str, **data) -> dict:
    return {
        "data": {"dataset_path": "unused", "sample_rate": 16000, "n_mels": 128, "n_fft": 400,
                 "hop_length": 160, "duration": 1.0, "augmentation": True,
                 "train_split": 0.7, "val_split": 0.15, **data},
        "model": {"architecture": architecture, "num_classes": 4, "dropout": 0.0},
        "training": {"batch_size": 4, "epochs": 1, "learning_rate": 5e-5,
                     "weight_decay": 1e-4, "optimizer": "adam", "scheduler": "cosine",
                     "mixed_precision": False, "gradient_accumulation_steps": 2,
                     "early_stopping_patience": 50, "save_every": 1, "async_checkpoint": False,
                     "checkpoint_dir": str(tmp / "ckpts"), "log_dir": str(tmp / "runs")},
        "classes": ["normal", "crackles", "wheezes", "both"],
        "seed": 0,
    }


@pytest.mark.parametrize("cache", [True, False])
def test_trainer_epoch_and_checkpoints(narrow_ast, tmp_path, cache):
    """One epoch of `architecture: ast` at narrow widths through the Trainer,
    fused on the device cache or per step from the host loader: the losses
    finite, every parameter moved; the checkpoint, msgpack and orbax, holds
    the state_dict's names split at the dots, the 3-D table and tokens among
    them, and a new Trainer restored from either has the weights and Adam's
    state bit for bit."""
    root = generate_segmented_dataset(tmp_path / "seg", per_class=6, duration=1.0,
                                      sample_rate=16000)
    config = ast_config(tmp_path, narrow_ast, cache_on_device=cache)

    def trainer():
        return Trainer(registry.build_model(config),
                       ICBHISegmentedDataset(root, "train", config, augment=True),
                       ICBHISegmentedDataset(root, "val", config), config, device="cpu")

    t = trainer()
    assert isinstance(t.model, NarrowAST) and t._use_multi_dispatch() == cache
    before = {k: v.clone() for k, v in t.model.state_dict().items()}
    loss = t.train_epoch(0)[0]
    val = t.validate(0)[0]
    assert np.isfinite(loss) and np.isfinite(val)
    for k, v in t.model.state_dict().items():
        assert not torch.equal(before[k], v), k
    for fmt in ("msgpack", "orbax"):
        config["training"]["checkpoint_format"] = fmt
        path = tmp_path / f"ast.{fmt}"
        t.save_checkpoint(path, 0, val)
        saved = load_checkpoint(path)
        assert set(saved["params"]) == {"v", "mlp_head"} and saved["batch_stats"] == {}
        for leaf in ("pos_embed", "cls_token", "dist_token"):
            assert tuple(saved["params"]["v"][leaf].shape) == tuple(before[f"v.{leaf}"].shape)
        resumed = trainer()
        resumed.restore(path)
        for k, v in t.model.state_dict().items():
            assert torch.equal(resumed.model.state_dict()[k], v), (fmt, k)
        for p, q in zip(t.optimizer.param_groups[0]["params"],
                        resumed.optimizer.param_groups[0]["params"], strict=True):
            for key in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(t.optimizer.state[p][key], resumed.optimizer.state[q][key])
