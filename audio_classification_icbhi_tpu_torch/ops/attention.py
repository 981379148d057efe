"""Attention, softmax(q kᵀ / √d) v over (B, H, N, d): the one place the port
computes it.

It replaces no TPU kernel: the JAX package has no transformer. Added for
AST (`models/ast.py`), whose 12 calls a forward are a quarter to a third of
its train step; at its shapes (N = 950, d = 64) the work is bound by
operations, 4·B·H·N²·d forward and 8·B·H·N²·d backward.

A CUDA tensor goes to `F.scaled_dot_product_attention` with one backend
pinned, `BACKEND`, chosen by one measurement on an H100 at the train
step's shapes, forward and backward in bf16 inside a CUDA graph
(`chip_smoke.py` phase 29, both times in PERF.md). Nothing selects another:
where the pinned backend refuses a shape or a dtype (float32 among them),
the call raises, and nothing falls back to the math backend. A CPU tensor
runs the plain version, `plain`, in the tensor's dtype.

On the card the call is a `torch.autograd.Function`: its forward runs the
pinned kernel on detached copies of q, k, v with a graph of their own, and
its backward takes that graph's gradient, so the backward is the pinned
backend's backward kernel. While a train step is captured into a CUDA
graph, each pass records device marks around its kernels
(`tracing.interval("attention")`); the recorder sums them as
`step.attention`. `attention` counts its CUDA calls in `launches`
(forward) and `launches_backward`.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

from audio_classification_icbhi_tpu_torch import tracing

# cuDNN's fused attention: 1.020 ms a call forward and backward at 32 x 12 x 950 x 64 in
# bf16 as a CUDA graph, flash 1.689 (H100, PERF.md)
BACKEND = SDPBackend.CUDNN_ATTENTION


def plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q kᵀ / √d) v in the tensors' dtype."""
    scores = q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1])
    return torch.softmax(scores, dim=-1) @ v


def _fused(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The pinned backend's forward, between device marks while a step is
    captured."""
    with tracing.interval("attention"), sdpa_kernel([BACKEND]):
        out = F.scaled_dot_product_attention(q, k, v)
    attention.launches += 1
    return out


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        with torch.enable_grad():
            ctx.leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            ctx.out = _fused(*ctx.leaves)
        return ctx.out.detach()

    @staticmethod
    def backward(ctx, grad):
        with tracing.interval("attention"):
            grads = torch.autograd.grad(ctx.out, ctx.leaves, grad)
        attention.launches_backward += 1
        del ctx.out, ctx.leaves
        return grads


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q kᵀ / √d) v of (B, H, N, d) tensors, the last dimension
    contiguous (module doc)."""
    if q.device.type != "cuda":
        return plain(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _Attention.apply(q, k, v)
    return _fused(q, k, v)


attention.launches = 0
attention.launches_backward = 0
