"""Inference forward of LightweightCNN through the fused conv-block kernels.

Port of `audio_classification_icbhi_tpu/models/fused_infer.py`.
`make_fused_apply` builds a drop-in replacement for the model's eval
forward that runs blocks 1-3 through the fused kernels of
`ops/conv_kernels.py` (conv + BN + ReLU + pool in one pass a block, the
pre-pool activation never written to device memory) and blocks 4-5 and the
head through plain torch ops that round where the JAX package's lax ops do:
a bf16 conv, BatchNorm in bf16 with its scale and shift computed in f32 and
cast to bf16 (the port's `ConvBlock` normalizes in f32, so it is not reused
here), ReLU, max-pool, global average pool, the bf16 head, f32 logits. The
fused apply is bf16 whatever the checkpoint's precision, as in the JAX
package.

The opt-in is `ICBHI_FUSED_CNN=1` (or the older `BENCH_FUSED_CNN=1`),
read by `fused_cnn_enabled`, which both engines ask. It holds on a CUDA
device only: on the CPU the engines run the model's forward, as the JAX
package runs XLA's convs off the TPU. Where it holds, the kernels are
checked once on the card by `fused_kernels_available`, which raises on a
fault instead of falling back.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from audio_classification_icbhi_tpu_torch.ops import conv_kernels as ck

_BN_EPS = 1e-5  # flax/torch default, models/cnn.py of the JAX package


def _conv_bn_relu_pool(x: torch.Tensor, weight: torch.Tensor, s: torch.Tensor,
                       t: torch.Tensor) -> torch.Tensor:
    """One eval ConvBlock in bf16 (blocks the fused chain leaves), NHWC in
    and out: `fused_infer.py:42-56` of the JAX package. A map that pools
    to nothing comes out empty, as lax's VALID reduce_window gives it (the
    global average pool then makes NaN logits, as in the JAX package)."""
    b, h, w, _ = x.shape
    if h < 2 or w < 2:
        return x.new_zeros((b, h // 2, w // 2, weight.shape[0]), dtype=torch.bfloat16)
    y = F.conv2d(x.to(torch.bfloat16).permute(0, 3, 1, 2), weight, padding=1)
    y = torch.relu(y * s[:, None, None] + t[:, None, None])
    return F.max_pool2d(y, 2).permute(0, 2, 3, 1)


def make_fused_apply(model_or_state_dict, device: str | torch.device):
    """Return fn(feats (B, H, W, 1) f32 on `device`) -> logits (B, C) f32.

    `model_or_state_dict` is a LightweightCNN or its state_dict. The folded
    constants are made once, on the host, and moved to `device`; build one
    apply per checkpoint. The chain decisions are the JAX package's
    (`fused_infer.py:78-103`): block 1 always; block 2 when h1 is even,
    h1 >= 4 and w1 >= 4; block 3 likewise on (h2, w2); the rest plain.
    Fused blocks hand each other unpadded NHWC bf16 tensors.
    """
    sd = (model_or_state_dict.state_dict() if isinstance(model_or_state_dict, torch.nn.Module)
          else model_or_state_dict)
    sd = {k: v.detach().cpu() for k, v in sd.items()}
    device = torch.device(device)
    folded = [ck.fold_conv_block(*ck.block_args_from_state_dict(sd, i), eps=_BN_EPS,
                                 bias_bf16=(i == 0), device=device) for i in range(3)]
    plain = []
    for i in range(1, 5):
        p = f"conv{i + 1}"
        s = sd[f"{p}.bn.weight"] * torch.rsqrt(sd[f"{p}.bn.running_var"] + _BN_EPS)
        t = sd[f"{p}.bn.bias"] - sd[f"{p}.bn.running_mean"] * s
        plain.append(tuple(v.to(device=device, dtype=torch.bfloat16)
                           for v in (sd[f"{p}.conv.weight"], s, t)))
    head = [sd[k].to(device=device, dtype=torch.bfloat16)
            for k in ("fc1.weight", "fc1.bias", "fc2.weight", "fc2.bias")]

    def apply_fn(feats: torch.Tensor) -> torch.Tensor:
        h1, w1 = feats.shape[1] // 2, feats.shape[2] // 2
        x = ck.conv_block1_folded(feats, folded[0])
        start = 1
        if h1 % 2 == 0 and h1 >= 4 and w1 >= 4:
            x = ck.conv_packed_folded(x, folded[1])
            start = 2
            h2, w2 = h1 // 2, w1 // 2
            if h2 % 2 == 0 and h2 >= 4 and w2 >= 4:
                x = ck.conv_packed_folded(x, folded[2])
                start = 3
        for i in range(start, 5):
            x = _conv_bn_relu_pool(x, *plain[i - 1])
        x = x.float().mean(dim=(1, 2)).to(torch.bfloat16)  # GAP, summed in f32
        w0, b0, w1_, b1 = head
        x = torch.relu(x @ w0.T + b0)
        return (x @ w1_.T + b1).float()

    return apply_fn


def fused_apply_supported(feats_shape) -> bool:
    """True when the block-1 kernel covers this feature shape."""
    if len(feats_shape) != 4:
        return False
    _, h, w, c = feats_shape
    return c == 1 and h % 16 == 0 and h >= 32 and w >= 4


def fused_cnn_enabled(feats_shape=None, device: str | torch.device = "cuda") -> bool:
    """Should inference on `device` run the fused conv-block kernels?

    True only when `ICBHI_FUSED_CNN=1` (or the older `BENCH_FUSED_CNN=1`)
    is set, `device` is a CUDA device, the feature shape (when given) fits
    the block-1 kernel, and `fused_kernels_available()` passes (it raises
    where it does not). Both engines ask this one function. Off by default:
    which path is faster on this card is measured in PERF.md.
    """
    env = os.environ.get("ICBHI_FUSED_CNN", os.environ.get("BENCH_FUSED_CNN", "0"))
    if env != "1":
        return False
    if torch.device(device).type != "cuda":
        return False
    if feats_shape is not None and not fused_apply_supported(feats_shape):
        return False
    return fused_kernels_available(device)


_PROBED: set[torch.device] = set()  # devices whose probe passed


def fused_kernels_available(device: str | torch.device = "cuda") -> bool:
    """Build and check the fused kernels on `device` (the card by default).

    Runs each wrapper once on small inputs on `device` (on the CPU, the
    plain versions) and compares with a numpy ground truth; caches a pass.
    Unlike the JAX package's probe, which warns and falls back to the
    model's forward, this raises on a build failure, a launch failure or a
    mismatch: no kernel is hidden behind a fallback.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("the fused conv-block kernels need a CUDA device")
        dev = torch.device("cuda", torch.cuda.current_device() if dev.index is None else dev.index)
    if dev in _PROBED:
        return True
    rng = np.random.default_rng(0)
    cases = (("block1", ck.fused_conv_block1, (1, 32, 8, 1), 32, 2e-2, {}),
             ("block1_batched", ck.fused_conv_block1_batched, (3, 32, 8, 1), 32, 2e-2,
              {"group": 2}),
             ("block2", ck.fused_conv_block2, (1, 4, 8, 32), 64, 2e-2, {}),
             ("block3", ck.fused_conv_block3, (1, 4, 8, 64), 128, 5e-2, {}))
    for name, fn, shape, co, tol, kw in cases:
        x = rng.standard_normal(shape).astype(np.float32)
        k = rng.standard_normal((3, 3, shape[-1], co)).astype(np.float32) * 0.1
        ones, zeros = np.ones(co, np.float32), np.zeros(co, np.float32)
        got = fn(torch.from_numpy(x).to(dev), k, ones, zeros, zeros, ones, **kw)
        got = got.double().cpu().numpy()
        ref = _conv_pool_np(x, k)
        if got.shape != ref.shape or not np.abs(got - ref).max() <= tol:
            raise RuntimeError(f"fused conv {name} probe numerics mismatch: shape "
                               f"{got.shape} vs {ref.shape}, max error "
                               f"{np.abs(got - ref).max() if got.shape == ref.shape else 'n/a'}")
    _PROBED.add(dev)
    return True


def _conv_pool_np(x, k, eps: float = 1e-5) -> np.ndarray:
    """Numpy ground truth for the probe: conv3x3 + identity BN + ReLU + pool."""
    xx = np.asarray(x, np.float64)
    kk = np.asarray(k, np.float64)
    b, h, w, ci = xx.shape
    co = kk.shape[-1]
    xp = np.zeros((b, h + 2, w + 2, ci))
    xp[:, 1:-1, 1:-1] = xx
    conv = np.zeros((b, h, w, co))
    for dh in range(3):
        for dw in range(3):
            conv += np.einsum("bhwc,co->bhwo", xp[:, dh:dh + h, dw:dw + w], kk[dh, dw])
    y = np.maximum(conv / np.sqrt(1.0 + eps), 0.0)
    return y[:, :h // 2 * 2, :w // 2 * 2].reshape(b, h // 2, 2, w // 2, 2, co).max(axis=(2, 4))
