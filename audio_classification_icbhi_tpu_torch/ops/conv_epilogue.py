"""The ConvBlock epilogue on Hopper, and its plain version.

After each convolution, `models/cnn.ConvBlock` computes
dropout(maxpool2(relu(bn(y)))) on the conv output y (B, C, H, W): BatchNorm
(flax's: batch statistics with the biased variance in train mode, the
running ones in eval mode), ReLU, a 2x2 max-pool that floors odd sizes, and
one dropout mask per (sample, channel). `conv_epilogue` runs it as one
hand-written kernel pair (`csrc/conv_epilogue.cu`), forward and backward,
in y's dtype (bf16, fp16 or f32), with the precision of torch's chain:

- statistics and the normalization in f32;
- the normalized value rounded to y's dtype where `.to(dtype)` after the
  f32 BatchNorm rounds; ReLU, the max and the dropout's scale in that dtype
  (the scale as torch's CUDA divide by a scalar computes it: `keep_scale`);
- the max-pool's winner by torch's rule: the first maximum in scan order,
  NaN propagating;
- backward: dy rounded where the dtype's dropout backward rounds; the
  BatchNorm backward in f32, dx rounded to the dtype once.

The forward keeps a one-byte code a pooled output for the backward (the
winner's position dh·2 + dw, or `NO_GRADIENT` where ReLU zeroed the winner
or the channel was dropped), where the chain kept an f32 copy of y, the
ReLU output and int64 indices. The dropout mask is drawn by the caller
(`models/cnn.keep_mask`, the same generator call as the chain's), and the
kernels consume it.

A CPU tensor runs the plain version: the same stages in plain torch
(`batch_stats_reference`, `apply_reference`, `grad_reference`), in f32, or
in f64 for an f64 input, with their backward written out as the kernels
compute it. A CUDA tensor launches the kernels or raises. `conv_epilogue`
counts its CUDA calls in `launches` (forward) and `launches_backward`.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from audio_classification_icbhi_tpu_torch.ops import _build

NO_GRADIENT = 4     # code of a pooled output that passes no gradient
_THREADS = 256      # csrc/conv_epilogue.cu kThreads
_VEC = 8            # channels a thread
_MAX_C = 1024
_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def keep_scale(p: float) -> float:
    """1 / (1 − p) as torch's CUDA `x / (1 − p)` applies it to a tensor:
    the f32 reciprocal of f32(1 − p), multiplied in f32."""
    return float(np.float32(1.0) / np.float32(1.0 - p))


def pooled_shape(y_shape) -> tuple[int, int, int, int]:
    """(B, C, H // 2, W // 2); raises as torch's max-pool does for a map that
    pools to nothing."""
    b, c, h, w = y_shape
    if h < 2 or w < 2:
        raise RuntimeError(f"Given input size: ({c}x{h}x{w}). Calculated output size: "
                           f"({c}x{h // 2}x{w // 2}). Output size is too small")
    return b, c, h // 2, w // 2


# ------------------------------------------------------------ plain version

def _compute_dtype(y: torch.Tensor) -> torch.dtype:
    return torch.float64 if y.dtype == torch.float64 else torch.float32


def batch_stats_reference(y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel mean and biased variance of y in f32 (f64 for f64)."""
    var, mean = torch.var_mean(y.to(_compute_dtype(y)), dim=(0, 2, 3), correction=0)
    return mean, var


def _windows(t: torch.Tensor, ho: int, wo: int) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, Ho, Wo, 4), the 2x2 windows in scan order."""
    b, c = t.shape[:2]
    t = t[:, :, :2 * ho, :2 * wo].reshape(b, c, ho, 2, wo, 2)
    return t.permute(0, 1, 2, 4, 3, 5).reshape(b, c, ho, wo, 4)


def apply_reference(y: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                    weight: torch.Tensor, bias: torch.Tensor, eps: float,
                    keep: torch.Tensor | None = None,
                    scale: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """The Apply kernel in plain torch: (out (B, C, H//2, W//2) in y's
    dtype, code (B, H//2, W//2, C) uint8). keep: (B, C, 1, 1) bool or None."""
    b, c, ho, wo = pooled_shape(y.shape)
    cd = _compute_dtype(y)
    alpha = weight.to(cd) / torch.sqrt(var.to(cd) + eps)
    beta = bias.to(cd) - mean.to(cd) * alpha
    v = y.to(cd) * alpha[:, None, None] + beta[:, None, None]
    r = torch.relu(v.to(y.dtype).to(cd))
    win = _windows(r, ho, wo)
    at = win.argmax(-1)  # the first maximum; NaN counts as the maximum
    best = win.gather(-1, at[..., None])[..., 0]
    live = (best > 0) | torch.isnan(best)
    if keep is not None:
        kept = keep.reshape(b, c, 1, 1)
        live &= kept
        best = torch.where(kept, (best * scale).to(y.dtype).to(cd), torch.zeros((), dtype=cd,
                                                                                 device=y.device))
    code = torch.where(live, at, NO_GRADIENT).to(torch.uint8)
    return best.to(y.dtype), code.permute(0, 2, 3, 1).contiguous()


def grad_reference(g: torch.Tensor, y: torch.Tensor, code: torch.Tensor, mean: torch.Tensor,
                   var: torch.Tensor, weight: torch.Tensor, eps: float, scale: float,
                   batch_stats: bool) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The Reduce and dx kernels in plain torch: (dx in y's dtype,
    grad_weight, grad_bias) from the pooled gradient g, the forward's code
    and statistics."""
    b, c, ho, wo = pooled_shape(y.shape)
    h, w = y.shape[2:]
    cd = _compute_dtype(y)
    dyw = (g.to(cd) * scale).to(y.dtype).to(cd)
    at = code.permute(0, 3, 1, 2).long()
    win = torch.zeros((b, c, ho, wo, 4), dtype=cd, device=y.device)
    win.scatter_(-1, at.clamp(max=3)[..., None], torch.where(at < 4, dyw, 0.0)[..., None])
    dy = torch.zeros((b, c, h, w), dtype=cd, device=y.device)
    dy[:, :, :2 * ho, :2 * wo] = win.reshape(b, c, ho, wo, 2, 2).permute(
        0, 1, 2, 4, 3, 5).reshape(b, c, 2 * ho, 2 * wo)
    invstd = 1.0 / torch.sqrt(var.to(cd) + eps)
    xhat = (y.to(cd) - mean.to(cd)[:, None, None]) * invstd[:, None, None]
    sum_dy = dy.sum((0, 2, 3))
    sum_dy_xhat = (dy * xhat).sum((0, 2, 3))
    alpha = (weight.to(cd) * invstd)[:, None, None]
    if batch_stats:
        n = b * h * w
        dx = alpha * (dy - (sum_dy / n)[:, None, None] - xhat * (sum_dy_xhat / n)[:, None, None])
    else:
        dx = alpha * dy
    return dx.to(y.dtype), sum_dy_xhat.to(weight.dtype), sum_dy.to(weight.dtype)


# ------------------------------------------------------------------- kernels

@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _dev_index(x: torch.Tensor) -> int:
    return x.device.index if x.device.index is not None else torch.cuda.current_device()


def _partial_blocks(x: torch.Tensor, items: int) -> int:
    """CTAs of Stats / Reduce over `items` thread items: at most four an SM,
    which bounds the partials Finalize merges."""
    return max(1, min(4 * _sms(_dev_index(x)), math.ceil(items / _THREADS)))


def _channels_last(t: torch.Tensor) -> torch.Tensor:
    """t channels-last, starting on a 16-byte boundary (the kernels' vector
    loads)."""
    t = t.contiguous(memory_format=torch.channels_last)
    if t.data_ptr() % 16:
        t = t.clone(memory_format=torch.channels_last)
    return t


def _check_cuda(y: torch.Tensor, bn, keep: torch.Tensor | None) -> None:
    if y.dtype not in _DTYPES:
        raise TypeError(f"conv_epilogue takes bf16, fp16 or f32 on the card, got {y.dtype}")
    b, c = y.shape[:2]
    if c < _VEC or c % _VEC or c > _MAX_C or _THREADS % (c // _VEC):
        raise ValueError(f"conv_epilogue takes C a multiple of 8 whose eighth divides "
                         f"{_THREADS}, got C={c}")
    for name in ("weight", "bias", "running_mean", "running_var"):
        t = getattr(bn, name)
        if t.device != y.device or t.dtype != torch.float32 or t.shape != (c,) \
                or not t.is_contiguous():
            raise ValueError(f"bn.{name} must be a contiguous ({c},) float32 tensor on "
                             f"{y.device}")
    if keep is not None and (keep.dtype != torch.bool or keep.device != y.device
                             or keep.numel() != b * c):
        raise ValueError(f"keep must be a ({b}, {c}, 1, 1) bool tensor on {y.device}")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def epilogue_forward(y: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, bn,
             keep: torch.Tensor | None, scale: float, with_code: bool):
    """(out, code or None, mean, var): the forward on either route (Stats,
    Finalize and Apply on the card); in train mode it moves bn's running
    statistics. scale: `keep_scale(p)`, or 1 without a mask."""
    eps = bn.eps
    if y.device.type == "cpu":
        if bn.training:
            mean, var = batch_stats_reference(y)
            with torch.no_grad():
                m = bn.momentum
                bn.running_mean.mul_(1.0 - m).add_(mean.to(bn.running_mean.dtype), alpha=m)
                bn.running_var.mul_(1.0 - m).add_(var.to(bn.running_var.dtype), alpha=m)
                bn.num_batches_tracked.add_(1)
        else:
            mean, var = bn.running_mean.clone(), bn.running_var.clone()
        out, code = apply_reference(y, mean, var, weight, bias, eps, keep, scale)
        return out, code if with_code else None, mean, var
    if y.device.type != "cuda":
        raise ValueError(f"unsupported device {y.device}")
    _check_cuda(y, bn, keep)
    b, c, ho, wo = pooled_shape(y.shape)
    h, w = y.shape[2:]
    y = _channels_last(y)
    out = torch.empty((b, c, ho, wo), dtype=y.dtype, device=y.device,
                      memory_format=torch.channels_last)
    code = torch.empty((b, ho, wo, c), dtype=torch.uint8, device=y.device) if with_code else None
    keep_bytes = None if keep is None else keep.reshape(b, c).contiguous()
    if bn.training:
        stats = torch.empty((2, c), dtype=torch.float32, device=y.device)
        mean, var = stats[0], stats[1]
        blocks = _partial_blocks(y, b * h * w * (c // _VEC))
        part = torch.empty(3 * blocks * c, dtype=torch.float32, device=y.device)
        running = (bn.running_mean.data_ptr(), bn.running_var.data_ptr(),
                   bn.num_batches_tracked.data_ptr())
    else:
        # saved for a backward in eval mode: a later train step moves the buffers
        mean, var = (bn.running_mean.clone(), bn.running_var.clone()) if with_code else (
            bn.running_mean, bn.running_var)
        blocks, part, running = 0, None, (None, None, None)
    lib = _build.load("conv_epilogue")
    _build.launch(lib, lib.conv_epilogue_forward, _dev_index(y), _DTYPES[y.dtype], y.data_ptr(),
                  b, h, w, c, weight.data_ptr(), bias.data_ptr(), eps, bn.momentum,
                  mean.data_ptr(), var.data_ptr(), *running, _ptr(part), blocks,
                  _ptr(keep_bytes), scale, out.data_ptr(), _ptr(code), _stream(y))
    conv_epilogue.launches += 1
    return out, code, mean, var


def epilogue_backward(g: torch.Tensor, y: torch.Tensor, code: torch.Tensor, mean: torch.Tensor,
              var: torch.Tensor, weight: torch.Tensor, eps: float, scale: float,
              batch_stats: bool) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, grad_weight, grad_bias) on either route (Reduce, Finalize and
    dx on the card), from the pooled gradient g and the forward's code and
    statistics."""
    if y.device.type == "cpu":
        return grad_reference(g, y, code, mean, var, weight, eps, scale, batch_stats)
    b, c, ho, wo = pooled_shape(y.shape)
    h, w = y.shape[2:]
    g = _channels_last(g.to(y.dtype))
    dx = torch.empty_like(y, memory_format=torch.channels_last)
    sums = torch.empty((2, c), dtype=torch.float32, device=y.device)
    blocks = _partial_blocks(y, b * ho * wo * (c // _VEC))
    part = torch.empty(2 * blocks * c, dtype=torch.float32, device=y.device)
    lib = _build.load("conv_epilogue")
    _build.launch(lib, lib.conv_epilogue_backward, _dev_index(y), _DTYPES[y.dtype], y.data_ptr(),
                  g.data_ptr(), code.data_ptr(), b, h, w, c, mean.data_ptr(), var.data_ptr(),
                  weight.data_ptr(), eps, int(batch_stats), scale, part.data_ptr(), blocks,
                  sums.data_ptr(), dx.data_ptr(), _stream(y))
    conv_epilogue.launches_backward += 1
    return dx, sums[1], sums[0]


class ConvEpilogue(torch.autograd.Function):
    """`conv_epilogue` with its backward: autograd saves y, the code and the
    statistics."""

    @staticmethod
    def forward(ctx, y, weight, bias, bn, keep, scale):
        if y.is_cuda:
            y = _channels_last(y)
        out, code, mean, var = epilogue_forward(y, weight, bias, bn, keep, scale, with_code=True)
        ctx.save_for_backward(y, code, mean, var, weight)
        ctx.eps, ctx.scale, ctx.batch_stats = bn.eps, scale, bn.training
        return out

    @staticmethod
    def backward(ctx, g):
        y, code, mean, var, weight = ctx.saved_tensors
        dx, grad_weight, grad_bias = epilogue_backward(g, y, code, mean, var, weight, ctx.eps,
                                               ctx.scale, ctx.batch_stats)
        return dx, grad_weight, grad_bias, None, None, None


def conv_epilogue(y: torch.Tensor, bn, keep: torch.Tensor | None = None,
                  p: float = 0.0) -> torch.Tensor:
    """dropout(maxpool2(relu(bn(y)))): y (B, C, H, W) -> (B, C, H//2, W//2)
    in y's dtype (channels-last on the card).

    bn: a BatchNorm module (weight, bias, running_mean, running_var,
    num_batches_tracked, eps, momentum, training); train mode normalizes
    with the batch's statistics and moves the running ones flax's way, eval
    mode uses the running ones. keep: the (B, C, 1, 1) bool dropout mask of
    rate p, or None for no dropout. The gradient reaches y, bn.weight and
    bn.bias. On the card y's dtype is bf16, fp16 or f32 and C a multiple of
    8 whose eighth divides 256; anything else raises."""
    pooled_shape(y.shape)
    scale = keep_scale(p) if keep is not None else 1.0
    if torch.is_grad_enabled() and (y.requires_grad or bn.weight.requires_grad
                                    or bn.bias.requires_grad):
        return ConvEpilogue.apply(y, bn.weight, bn.bias, bn, keep, scale)
    return epilogue_forward(y, bn.weight, bn.bias, bn, keep, scale, with_code=False)[0]


conv_epilogue.launches = 0
conv_epilogue.launches_backward = 0

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_build.declare("conv_epilogue", {
    "conv_epilogue_forward": [_I, _I, _P, _I, _I, _I, _I, _P, _P, _F, _F, _P, _P, _P, _P, _P,
                              _P, _I, _P, _F, _P, _P, _P],
    "conv_epilogue_backward": [_I, _I, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _F, _I, _F, _P,
                               _I, _P, _P, _P],
})
