"""The Audio Spectrogram Transformer (AST) as a torch nn.Module.

It replaces no model of the JAX package, which has no transformer. AST is
Gong, Chung and Glass, Interspeech 2021 (arXiv:2104.01778;
github.com/YuanGongND/ast, `src/models/ast_models.py`) with timm's
`deit_base_distilled` blocks, as ICBHI work fine-tunes it (Bae et al.,
Interspeech 2023, arXiv:2305.14032: 8 s clips, 128 mels, 25 ms / 10 ms).
At the published widths (the keyword defaults; the registry builds those),
86,191,876 parameters at 4 classes:

- a `Conv2d(1, W, 16x16, stride 10x10)` patch embedding, no padding, over
  the (n_mels, T) image: F = (n_mels − 16) // 10 + 1 rows of T' = (T − 16)
  // 10 + 1 patches, flattened frequency-major; 128 x 801 gives 12 x 79;
- the class and distillation tokens prepended: N = 2 + F·T' tokens (950);
- AudioSet's positional table, 2 + 12 x 101 rows, held whole: `forward`
  views its patch rows as (12, 101) and takes the time columns
  [50 − T' // 2, that + T') (11–89 at 801 frames, 46–54 at 101), the two
  token rows kept, as `ast_models.py` crops for inputs under 1,024 frames.
  AST crops once at init; holding the table makes every parameter's shape
  independent of the input, so AudioSet's table would load as it is;
- `depth` pre-LN blocks, x + proj(attn(LN1(x))), then x + fc2(GELU(fc1(
  LN2(x)))): `heads` heads of W / heads, scale 1 / √(W / heads), a bias on
  qkv, the exact (erf) GELU, LayerNorm eps 1e-6, no dropout and no
  drop-path (timm's defaults, which AST keeps);
- the final LayerNorm (eps 1e-6) of the two token rows, their mean, then
  LayerNorm(W) (eps 1e-5) and Linear(W, classes).

Parameter names are `ast_models.py`'s: the encoder under `v.` (`v.cls_token`,
`v.pos_embed`, `v.dist_token`, `v.patch_embed.proj`, `v.blocks.{i}.{norm1,
attn.qkv, attn.proj, norm2, mlp.fc1, mlp.fc2}`, `v.norm`) and the head
`mlp_head.0` / `mlp_head.1`; timm's ImageNet heads `v.head` and
`v.head_dist`, which AST's forward never reads, are not held. No weight
table: checkpoints carry these names split at the dots
(`models/weights.py`).

Precision, as AST runs under `torch.autocast(bfloat16)`: parameters are
float32; the patch convolution and every Linear take their operands in
`dtype` and give `dtype`; attention (`ops/attention.py`) takes q, k, v in
`dtype` and gives `dtype`; LayerNorm computes in float32 on the float32
residual stream, to which each block adds its `dtype` outputs; GELU runs in
`dtype`; the logits come out float32. The plain reference
(`port_bench/reference/ast.py`) rounds at the same places.

`dropout` is accepted for the registry's contract and unused: AST has none
(a config states `model.dropout: 0.0`).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from audio_classification_icbhi_tpu_torch.ops.attention import attention

PATCH, STRIDE = 16, 10
F_TABLE, T_TABLE = 12, 101  # AudioSet's table: 12 x 101 patches (128 mels x 1,024 frames)


def crop_start(t: int) -> int:
    """The table's first time column for t patches along time."""
    return T_TABLE // 2 - t // 2


class Block(nn.Module):
    """One pre-LN transformer block (timm's names)."""

    def __init__(self, width: int, heads: int, mlp_dim: int):
        super().__init__()
        self.heads = heads
        self.norm1 = nn.LayerNorm(width, eps=1e-6)
        self.attn = nn.Module()
        self.attn.qkv = nn.Linear(width, 3 * width)
        self.attn.proj = nn.Linear(width, width)
        self.norm2 = nn.LayerNorm(width, eps=1e-6)
        self.mlp = nn.Module()
        self.mlp.fc1 = nn.Linear(width, mlp_dim)
        self.mlp.fc2 = nn.Linear(mlp_dim, width)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """x (B, N, W) float32 -> the same."""
        b, n, width = x.shape
        qkv = _linear(_norm(x, self.norm1), self.attn.qkv, dtype)
        q, k, v = qkv.view(b, n, 3, self.heads, width // self.heads).permute(2, 0, 3, 1, 4)
        o = attention(q, k, v).transpose(1, 2).reshape(b, n, width)
        x = x + _linear(o, self.attn.proj, dtype).float()
        h = F.gelu(_linear(_norm(x, self.norm2), self.mlp.fc1, dtype))
        return x + _linear(h, self.mlp.fc2, dtype).float()


def _linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


def _norm(x: torch.Tensor, layer: nn.LayerNorm) -> torch.Tensor:
    return F.layer_norm(x.float(), layer.normalized_shape, layer.weight, layer.bias, layer.eps)


class Encoder(nn.Module):
    """AST's `v`: timm's distilled ViT with AST's patch convolution and table."""

    def __init__(self, width: int, depth: int, heads: int, mlp_dim: int):
        super().__init__()
        self.cls_token = nn.Parameter(torch.zeros(1, 1, width))
        self.pos_embed = nn.Parameter(torch.zeros(1, 2 + F_TABLE * T_TABLE, width))
        self.dist_token = nn.Parameter(torch.zeros(1, 1, width))
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(1, width, PATCH, stride=STRIDE)
        self.blocks = nn.ModuleList(Block(width, heads, mlp_dim) for _ in range(depth))
        self.norm = nn.LayerNorm(width, eps=1e-6)

    def tokens(self, x: torch.Tensor) -> torch.Tensor:
        """(B, W, F, T') patch embeddings -> (B, 2 + F·T', W) float32 tokens,
        the two tokens first, with the table's centre T' columns added."""
        b, width, f, t = x.shape
        if f != F_TABLE or t > T_TABLE:
            raise ValueError(f"AST's table holds {F_TABLE} x {T_TABLE} patches; the input "
                             f"gives {f} x {t} (128 mels and at most 1,024 frames)")
        start = crop_start(t)
        grid = self.pos_embed[:, 2:].view(1, F_TABLE, T_TABLE, width)[:, :, start:start + t]
        pos = torch.cat([self.pos_embed[:, :2], grid.reshape(1, f * t, width)], 1)
        cls = torch.cat([self.cls_token, self.dist_token], 1).expand(b, -1, -1)
        return torch.cat([cls, x.flatten(2).transpose(1, 2).float()], 1) + pos


class AST(nn.Module):
    """Input (B, n_mels, T, 1); output (B, num_classes) float32 logits."""

    def __init__(self, num_classes: int = 4, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32, generator: torch.Generator | None = None,
                 axis_name=None, *, embed_dim: int = 768, depth: int = 12, heads: int = 12,
                 mlp_dim: int = 3072):
        super().__init__()
        self.dtype = dtype
        self.axis_name = axis_name  # no BatchNorm: nothing is taken over the ranks
        self.v = Encoder(embed_dim, depth, heads, mlp_dim)
        self.mlp_head = nn.Sequential(nn.LayerNorm(embed_dim), nn.Linear(embed_dim, num_classes))
        self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """timm's ViT init: tokens, the table and Linear weights truncated
        normal (std 0.02, at ±2), Linear biases 0, LayerNorms 1 and 0; the
        patch convolution torch's Conv2d default, as AST builds it anew."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Linear):
                    nn.init.trunc_normal_(m.weight, std=0.02, generator=generator)
                    nn.init.zeros_(m.bias)
                elif isinstance(m, nn.LayerNorm):
                    nn.init.ones_(m.weight)
                    nn.init.zeros_(m.bias)
                elif isinstance(m, nn.Conv2d):
                    nn.init.kaiming_uniform_(m.weight, a=math.sqrt(5), generator=generator)
                    bound = 1.0 / math.sqrt(m.weight[0].numel())
                    nn.init.uniform_(m.bias, -bound, bound, generator=generator)
            for p in (self.v.cls_token, self.v.dist_token, self.v.pos_embed):
                nn.init.trunc_normal_(p, std=0.02, generator=generator)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        dt, v = self.dtype, self.v
        conv = v.patch_embed.proj
        x = F.conv2d(x.permute(0, 3, 1, 2).to(dt), conv.weight.to(dt), conv.bias.to(dt),
                     stride=STRIDE)
        x = v.tokens(x)
        for block in v.blocks:
            x = block(x, dt)
        return self.head(x)

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """The residual stream (B, N, W) -> float32 logits: the final
        LayerNorm of the two token rows (LayerNorm is per token: the other
        rows are not needed), their mean, LayerNorm and Linear."""
        x = _norm(x[:, :2], self.v.norm)
        x = _norm((x[:, 0] + x[:, 1]) / 2, self.mlp_head[0])
        return _linear(x, self.mlp_head[1], self.dtype).float()
