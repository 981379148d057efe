"""The Audio Spectrogram Transformer (AST), in plain PyTorch.

Gong, Chung and Glass, Interspeech 2021 (arXiv:2104.01778), code at
github.com/YuanGongND/ast, `src/models/ast_models.py`, with timm's
`deit_base_distilled` blocks at their published widths:

- a 16 x 16 patch convolution at stride 10 x 10, no padding, over the
  (n_mels, T) image: F = (n_mels − 16) // 10 + 1 rows of T' = (T − 16) // 10
  + 1 patches, flattened frequency-major;
- the class and distillation tokens prepended, N = 2 + F · T' tokens;
- AudioSet's positional table, 2 + 12 x 101 rows, its patch rows viewed as
  (12, 101) and cropped to the time columns [50 − T' // 2, that + T'), as
  `ast_models.py` crops for inputs shorter than 1,024 frames; the table is
  held whole and cropped in `forward` (AST crops it once at init);
- 12 pre-LN blocks: x + proj(attn(LN1(x))), then x + fc2(GELU(fc1(LN2(x)))),
  width 768, 12 heads of 64, softmax scale 1 / √64, a bias on qkv, MLP 3,072
  with the exact (erf) GELU, LayerNorm eps 1e-6; no dropout, no drop-path;
- the encoder's final LayerNorm, the mean of the two token rows, then
  LayerNorm(768) (eps 1e-5) and Linear(768, classes).

Parameter names are `ast_models.py`'s (the encoder under `v.`, the head
`mlp_head.0` / `mlp_head.1`), less timm's ImageNet heads `v.head` and
`v.head_dist`, which AST's forward never reads. 86,191,876 parameters at
4 classes, the whole 1,214-row table counted.

Rounding goes through `layers.Ops` where the program rounds to bfloat16:
the patch convolution's and every Linear's operands and output, and in
attention q, k, v (qkv's output), the softmax rows P as the fused kernel's
P·V product takes them, and the output. LayerNorm, the softmax and the
residual stream stay float32. Attention is written out,
softmax(q kᵀ / √d) v, with its (B, H, N, N) rows in memory.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from port_bench.reference.layers import Ops

PATCH, STRIDE = 16, 10
F_TABLE, T_TABLE = 12, 101  # AudioSet's table: 12 x 101 patches (128 mels x 1,024 frames)
WIDTH, DEPTH, HEADS, MLP = 768, 12, 12, 3072


def patches(n: int) -> int:
    """Patches along an axis of n pixels."""
    return (n - PATCH) // STRIDE + 1


def crop_start(t: int) -> int:
    """The table's first time column for t patches along time."""
    return T_TABLE // 2 - t // 2


class _Block(nn.Module):
    def __init__(self, width: int, mlp: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(width, eps=1e-6)
        self.attn = nn.Module()
        self.attn.qkv = nn.Linear(width, 3 * width)
        self.attn.proj = nn.Linear(width, width)
        self.norm2 = nn.LayerNorm(width, eps=1e-6)
        self.mlp = nn.Module()
        self.mlp.fc1 = nn.Linear(width, mlp)
        self.mlp.fc2 = nn.Linear(mlp, width)


class _Encoder(nn.Module):
    """AST's `v`: timm's distilled ViT with AST's patch convolution and table."""

    def __init__(self, width: int, depth: int, mlp: int):
        super().__init__()
        self.cls_token = nn.Parameter(torch.zeros(1, 1, width))
        self.pos_embed = nn.Parameter(torch.zeros(1, 2 + F_TABLE * T_TABLE, width))
        self.dist_token = nn.Parameter(torch.zeros(1, 1, width))
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(1, width, PATCH, stride=STRIDE)
        self.blocks = nn.ModuleList(_Block(width, mlp) for _ in range(depth))
        self.norm = nn.LayerNorm(width, eps=1e-6)


def tokens(v: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """(B, W, F, T') patch embeddings -> (B, 2 + F·T', W) tokens, the two
    tokens first, with the table's rows added (its centre T' columns)."""
    b, width, f, t = x.shape
    if f != F_TABLE or t > T_TABLE:
        raise ValueError(f"AST's table holds {F_TABLE} x {T_TABLE} patches; the input gives "
                         f"{f} x {t} (128 mels and at most 1,024 frames)")
    start = crop_start(t)
    grid = v.pos_embed[:, 2:].reshape(1, F_TABLE, T_TABLE, width)[:, :, start:start + t]
    pos = torch.cat([v.pos_embed[:, :2], grid.reshape(1, f * t, width)], 1)
    cls = torch.cat([v.cls_token, v.dist_token], 1).expand(b, -1, -1)
    return torch.cat([cls, x.flatten(2).transpose(1, 2)], 1) + pos


class Model(nn.Module):
    """AST as the harness's contract has it: `forward(x, train, g)`, x
    (B, 1, n_mels, T) -> (B, classes) logits; no dropout (`dropout` and g
    are accepted and unused). The widths are keywords, for narrow tests."""

    def __init__(self, num_classes: int, dropout: float = 0.0, precision: str = "f32", *,
                 width: int = WIDTH, depth: int = DEPTH, heads: int = HEADS, mlp: int = MLP):
        super().__init__()
        self.v = _Encoder(width, depth, mlp)
        self.mlp_head = nn.Sequential(nn.LayerNorm(width), nn.Linear(width, num_classes))
        self.heads = heads
        self.ops = Ops(precision)

    def attention(self, qkv: torch.Tensor) -> torch.Tensor:
        """(B, N, 3W) rounded q, k, v -> (B, N, W)."""
        ops = self.ops
        b, n, w3 = qkv.shape
        d = w3 // 3 // self.heads
        q, k, v = qkv.reshape(b, n, 3, self.heads, d).permute(2, 0, 3, 1, 4)
        p = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(d), dim=-1)
        return ops.q(ops.q(p) @ v).transpose(1, 2).reshape(b, n, w3 // 3)

    def forward(self, x: torch.Tensor, train: bool = False, g: torch.Generator | None = None):
        ops, v = self.ops, self.v
        conv = v.patch_embed.proj
        x = tokens(v, ops.q(F.conv2d(ops.q(x), ops.q(conv.weight), conv.bias, stride=STRIDE)))
        for block in v.blocks:
            x = x + ops.linear(self.attention(ops.linear(block.norm1(x), block.attn.qkv)),
                               block.attn.proj)
            x = x + ops.linear(F.gelu(ops.linear(block.norm2(x), block.mlp.fc1)),
                               block.mlp.fc2)
        x = v.norm(x)
        return ops.linear(self.mlp_head[0]((x[:, 0] + x[:, 1]) / 2), self.mlp_head[1])


def _sizes(h: int, w: int) -> tuple[int, int]:
    """(patches, tokens) of one (h, w) input."""
    p = patches(h) * patches(w)
    return p, p + 2


def forward_gflop(h: int, w: int, classes: int = 4) -> float:
    """Forward GFLOP of one (h, w) input, 2 per multiply-add: the patch
    convolution, then per block qkv, QKᵀ, AV, the projection and the MLP
    over N tokens, then the head."""
    p, n = _sizes(h, w)
    block = (2 * n * WIDTH * 3 * WIDTH + 2 * 2 * n * n * WIDTH + 2 * n * WIDTH * WIDTH
             + 2 * 2 * n * WIDTH * MLP)
    return (2 * p * WIDTH * PATCH * PATCH + DEPTH * block + 2 * WIDTH * classes) / 1e9


def first_layer_gflop(h: int, w: int) -> float:
    """GFLOP of the patch convolution's forward."""
    return 2 * _sizes(h, w)[0] * WIDTH * PATCH * PATCH / 1e9


def attention_gflop(h: int, w: int) -> float:
    """GFLOP of one clip's DEPTH attention calls, forward and backward:
    4·H·N²·d forward (QKᵀ and PV) and 8·H·N²·d backward (dV, dP, dQ, dK),
    a recompute of the scores in the backward not counted (it is the
    implementation's choice, not work)."""
    n = _sizes(h, w)[1]
    return DEPTH * (4 + 8) * HEADS * n * n * (WIDTH // HEADS) / 1e9


def attention_bytes(h: int, w: int, batch: int) -> float:
    """Bytes the DEPTH attention calls of `batch` clips move at the least,
    forward and backward, bf16 tensors and f32 log-sum-exp: the forward
    reads q, k, v and writes o and the log-sum-exp; the backward reads q,
    k, v, o, dO and the log-sum-exp and writes dQ, dK, dV."""
    rows = batch * HEADS * _sizes(h, w)[1]
    d = WIDTH // HEADS
    return DEPTH * ((4 + 8) * rows * d * 2 + 2 * rows * 4)
