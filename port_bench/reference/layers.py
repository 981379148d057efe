"""Layers the reference classifiers share, in plain PyTorch.

`precision` is "f32" (the reference), "fp8" (the control) or "bf16" (a
witness). At every place where the program rounds to bfloat16 (each
convolution's and dense layer's operands and output, each BatchNorm's
output, the residual sums) the two others round too: "fp8" to float8 e4m3
under a per-tensor scale going forward and the gradient to e5m2 going back
(the common fp8 training recipe), "bf16" to bfloat16 both ways, as the
program's bf16 autograd does.

BatchNorm follows the classifiers' definition (flax's, momentum 0.9): train
mode normalizes with the batch mean and biased variance and moves the
running statistics by 0.1 toward them; eval mode uses the running ones.
Dropout keeps a unit where a draw from the step's generator is below 1 − p
and scales the kept by 1 / (1 − p); the classifiers' blocks keep one draw
per (example, channel).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

E4M3_MAX, E5M2_MAX = 448.0, 57344.0


def _fp8(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    scale = top / x.abs().amax().clamp(min=1e-30)
    return (x * scale).to(dtype).float() / scale


def _round(x: torch.Tensor, how: str) -> torch.Tensor:
    if how == "bf16":
        return x.to(torch.bfloat16).float()
    if how == "e4m3":
        return _fp8(x, torch.float8_e4m3fn, E4M3_MAX)
    return _fp8(x, torch.float8_e5m2, E5M2_MAX)


class _Rounded(torch.autograd.Function):
    """x rounded one way forward, its gradient another way back."""

    @staticmethod
    def forward(ctx, x, forward: str, backward: str):
        ctx.backward_format = backward
        return _round(x, forward)

    @staticmethod
    def backward(ctx, grad):
        return _round(grad, ctx.backward_format), None, None


FORMATS = {"bf16": ("bf16", "bf16"), "fp8": ("e4m3", "e5m2")}


class Ops:
    """Convolutions, dense layers and the other rounding places at a
    precision."""

    def __init__(self, precision: str):
        if precision not in ("f32", "bf16", "fp8"):
            raise ValueError(f"precision must be f32, bf16 or fp8, got {precision!r}")
        self.formats = FORMATS.get(precision)

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """x as the precision stores it."""
        return x if self.formats is None else _Rounded.apply(x, *self.formats)

    def conv(self, x, w, stride=1, padding=0):
        return self.q(F.conv2d(self.q(x), self.q(w), stride=stride, padding=padding))

    def linear(self, x, layer: nn.Linear):
        return self.q(F.linear(self.q(x), self.q(layer.weight), layer.bias))


def batch_norm(x: torch.Tensor, bn: nn.BatchNorm2d, train: bool) -> torch.Tensor:
    if not train:
        return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                            training=False, eps=1e-5)
    var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
    with torch.no_grad():
        if getattr(bn, "calibrate", False):  # running statistics := this batch's
            bn.running_mean.copy_(mean)
            bn.running_var.copy_(var)
        else:
            bn.running_mean.mul_(0.9).add_(0.1 * mean)
            bn.running_var.mul_(0.9).add_(0.1 * var)
            bn.num_batches_tracked.add_(1)
    inv = torch.rsqrt(var + 1e-5)
    return (x - mean[:, None, None]) * (inv * bn.weight)[:, None, None] + bn.bias[:, None, None]


def dropout(x: torch.Tensor, p: float, g: torch.Generator | None, per_channel: bool = False):
    if g is None or p == 0.0:
        return x
    shape = x.shape[:2] + (1, 1) if per_channel else x.shape
    keep = torch.rand(shape, generator=g, device=x.device) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


def bn(channels: int) -> nn.BatchNorm2d:
    """A container of one BatchNorm's weight, bias and running statistics,
    under torch's names (the computation is `batch_norm`)."""
    return nn.BatchNorm2d(channels)
