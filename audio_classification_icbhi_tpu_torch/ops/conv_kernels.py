"""The fused eval ConvBlocks on Hopper, and their plain versions.

Two hand-written CUDA kernels replace the three TPU kernels of
`audio_classification_icbhi_tpu/ops/pallas_conv.py`. Each computes one eval
ConvBlock of LightweightCNN in one pass: conv3x3 (pad 1, no bias) with the
BatchNorm folded into the taps, ReLU, maxpool 2x2 (floor), bf16 output,
without writing the full-resolution pre-pool activation to device memory.

- `fused_conv_block1` (`csrc/fused_conv_block1.cu`) replaces `_kernel_block1`
  (`:92`), launched by `fused_conv_block1` (`:292`, `pl.pallas_call` at
  `:313`): (B, H, W, 1) f32 -> (B, H/2, W/2, 32) bf16;
- `fused_conv_block1_batched` launches the same CUDA kernel, whose grid
  covers the batch; it replaces `_kernel_block1_batched` (`:334`), launched
  by `fused_conv_block1_batched` (`:381`, `pl.pallas_call` at `:418`), whose
  `group` of examples stacked in lanes was a device for the TPU's matrix
  unit. `group` is checked and otherwise changes nothing;
- `fused_conv_block2` (32 -> 64) and `fused_conv_block3` (64 -> 128)
  (`csrc/fused_conv_packed.cu`, one templated kernel) replace
  `_kernel_packed` (`:157`), launched by `_fused_conv_packed` (`:207`,
  `pl.pallas_call` at `:232`) for `fused_conv_block2` / `_block3` (`:263`,
  `:279`): (B, H, W, ci) bf16 or f32 -> (B, H/2, W/2, co) bf16.

What surrounds the kernels is here, where the CPU tests reach it: the tile
schedules (`block1_schedule`, `packed_schedule`), the taps in the layout a
`wgmma` B descriptor reads (`wgmma_tap_image`) and the TMA row-pitch check
(`tma_row_pitch`).

The wrappers take the JAX package's arguments: the HWIO `conv_kernel`
(3, 3, ci, co) and the BatchNorm's scale, bias, running mean and variance,
as numpy arrays or tensors; `block_args_from_state_dict` reads them from the
port's state_dict. The BatchNorm folds on the host in float64 (`fold_conv_block`,
as `pallas_conv.py:308-309` and `:222-223` do), and both the kernels and the
plain versions take the folded constants, so they round where the TPU
kernels round:

- block 1: taps bf16(w·s), bias bf16(t) (it rides the TPU kernel's bf16
  ones-row); input rounded to bf16; the sum in f32; ReLU and the 2x2 max in
  f32; bf16 out;
- blocks 2-3: taps bf16(k·s), bias f32 (`bias_row`); input rounded to bf16;
  the sum in f32, + bias, ReLU, the 2x2 max; bf16 out.

A bf16 x bf16 product is exact in f32, so a sum of such products in f32 is
what the TPU's matrix unit computes, up to the order of the sum.

A CPU tensor runs the plain version; a CUDA tensor launches the kernel or
raises. Each wrapper counts its launches in `launches`. The `*_folded`
functions take constants folded once (`models/fused_infer.py` does that)
and count on the same wrappers.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from audio_classification_icbhi_tpu_torch.ops import _build

_TILE = 16   # block 1 takes H % 16 == 0 (the TPU kernel's row tile)
_COUT1 = 32  # block 1 output channels


@dataclass(frozen=True)
class FoldedConvBlock:
    """One ConvBlock's folded constants on one device.

    weight: (co, ci, 3, 3) f32, each value a bf16, bf16(f32(k·s));
    bias: (co,) f32, bf16(f32(t)) for block 1, f32(t) for blocks 2-3;
    taps: the kernel's layout of `weight`: block 1 (9, 32) f32 [dh·3 + dw][c];
    blocks 2-3 (9, co, ci) bf16, `wgmma_tap_image` of the (co, 9·ci) taps
    [c_out][(dh·3 + dw)·ci + c_in]."""

    weight: torch.Tensor
    bias: torch.Tensor
    taps: torch.Tensor

    @property
    def ci(self) -> int:
        return self.weight.shape[1]

    @property
    def co(self) -> int:
        return self.weight.shape[0]


def _f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().double().numpy()
    return np.asarray(x, np.float64)


def fold_conv_block(conv_kernel, bn_scale, bn_bias, bn_mean, bn_var, *, eps: float = 1e-5,
                    bias_bf16: bool, device: str | torch.device = "cpu") -> FoldedConvBlock:
    """Fold eval BatchNorm into the conv in float64: s = scale / sqrt(var +
    eps), t = bias − mean·s; taps bf16(f32(k·s)), bias f32(t), rounded on to
    bf16 when `bias_bf16` (block 1). The f64 -> f32 -> bf16 rounding is the
    TPU kernels' own (`pallas_conv.py:71-82`, `:139-154`)."""
    k = _f64(conv_kernel)
    s = _f64(bn_scale) / np.sqrt(_f64(bn_var) + eps)
    t = _f64(bn_bias) - _f64(bn_mean) * s
    w = torch.from_numpy((k * s).astype(np.float32)).to(torch.bfloat16)  # (3, 3, ci, co)
    bias = torch.from_numpy(t.astype(np.float32))
    if bias_bf16:
        bias = bias.to(torch.bfloat16).float()
    weight = w.permute(3, 2, 0, 1).float().contiguous()                  # (co, ci, 3, 3)
    co, ci = weight.shape[:2]
    if ci == 1:
        taps = weight[:, 0].reshape(co, 9).T.contiguous()                 # (9, co) f32
    else:
        taps = wgmma_tap_image(w.permute(3, 0, 1, 2).reshape(co, 9 * ci))  # (9, co, ci) bf16
    return FoldedConvBlock(weight.to(device), bias.to(device), taps.to(device))


# --------------------------------------------------------- layouts and schedules

def swizzle_offsets(n_bytes: int, span: int) -> np.ndarray:
    """Physical byte offset of each logical byte offset 0..n_bytes-1 under
    the hardware's swizzle of `span` (64 or 128) bytes: the 16-byte chunk
    index (address bits 4..) XOR the row index (address bits 7..), modulo
    span / 16. The region starts on a swizzle atom (8 rows)."""
    logical = np.arange(n_bytes, dtype=np.int64)
    mask = span // 16 - 1
    return logical ^ (((logical >> 7) & mask) << 4)


def wgmma_tap_image(taps: torch.Tensor) -> torch.Tensor:
    """(co, 9·ci) bf16 taps -> (9, co, ci) bf16 in shared-memory order for
    `csrc/fused_conv_packed.cu`: tap t's block is the K-major B operand of
    its `wgmma`s (row n: channel n's ci values), each row one swizzle row
    of 2·ci bytes (64 or 128: ci is 32 or 64), swizzled as `swizzle_offsets`
    says. The kernel copies the image into shared memory byte for byte."""
    co, k = taps.shape
    ci = k // 9
    logical = taps.reshape(co, 9, ci).permute(1, 0, 2).contiguous()        # (9, co, ci)
    elems = swizzle_offsets(logical.numel() * 2, 2 * ci)[::2] // 2
    image = torch.empty(logical.numel(), dtype=torch.bfloat16)
    image[torch.from_numpy(elems)] = logical.flatten()
    return image.reshape(9, co, ci)


def tma_row_pitch(w_pitch: int, ci: int) -> int:
    """The bytes between two rows of a (B, H, w_pitch, ci) bf16 input, the
    tensor map's row stride; TMA takes only multiples of 16. At the channel
    counts the kernel has instances for (32 and 64) every pitch passes; the
    check names the cause for an instance of another channel count, where
    the C launch would refuse with a bare error code."""
    pitch = 2 * w_pitch * ci
    if pitch % 16:
        raise ValueError(f"row pitch {pitch} bytes ({w_pitch} x {ci} bf16) is not a "
                         f"multiple of 16: TMA cannot read this input")
    return pitch


@dataclass(frozen=True)
class PackedSchedule:
    """How `csrc/fused_conv_packed.cu` cuts a block-2/3 output into tiles.

    A tile is `rows` pooled rows x 4·`slots` pooled columns of one example,
    loaded as one TMA box of (2·rows + 2) x (8·slots + 2) pixels from
    (2·h2_0 − 1, 2·w2_0 − 1); a slot is 4 pooled windows of one pooled row
    (one warp's 16 rows of a `wgmma` m64 tile). Tiles are numbered
    (b, row tile, column tile), column fastest; the column tiles cover
    out_w. A tile holds at least 8 slots (the kernel's ring needs it)."""

    h2n: int
    w2n: int
    out_w: int
    rows: int
    slots: int
    row_tiles: int
    col_tiles: int

    @property
    def box(self) -> tuple[int, int]:
        return 2 * self.rows + 2, 8 * self.slots + 2

    def tiles(self, batch: int) -> int:
        return batch * self.row_tiles * self.col_tiles


# the widest tile row in slots a block's shared memory takes at rows = 2
# (block 2: two CTAs an SM beside 36 KB of taps; block 3: one beside 144 KB)
PACKED_MAX_SLOTS = {32: 10, 64: 5}


@functools.lru_cache(maxsize=64)
def packed_schedule(h: int, w_valid: int, out_w: int, ci: int) -> PackedSchedule:
    """The tiles of one block-2/3 call: as few column tiles as the slot
    limit allows, slots spread evenly over them, and the fewest rows (at
    least 2) that give a tile 8 slots."""
    h2n, w2n = h // 2, w_valid // 2
    need = -(-out_w // 4)
    col_tiles = -(-need // PACKED_MAX_SLOTS[ci])
    slots = -(-need // col_tiles)
    rows = max(2, -(-8 // slots))
    return PackedSchedule(h2n, w2n, out_w, rows, slots, -(-h2n // rows), col_tiles)


BLOCK1_MAX_UNITS = 16  # 8-column units a block-1 tile row: 128 pooled columns


@functools.lru_cache(maxsize=64)
def block1_schedule(out_w: int) -> tuple[int, int]:
    """(units, col_tiles) of `csrc/fused_conv_block1.cu`: a tile is 8 pooled
    rows x 8·units pooled columns; the column tiles cover out_w."""
    need = -(-out_w // 8)
    col_tiles = -(-need // BLOCK1_MAX_UNITS)
    return -(-need // col_tiles), col_tiles


def block_args_from_state_dict(state_dict: dict, block: int) -> tuple:
    """(conv_kernel HWIO, bn_scale, bn_bias, bn_mean, bn_var) of ConvBlock
    `block` (0-based) from the port's LightweightCNN state_dict, as the JAX
    package's wrappers take them from the flax tree."""
    p = f"conv{block + 1}"
    return (state_dict[f"{p}.conv.weight"].detach().cpu().permute(2, 3, 1, 0),
            *(state_dict[f"{p}.bn.{leaf}"].detach().cpu()
              for leaf in ("weight", "bias", "running_mean", "running_var")))


# ----------------------------------------------------------------- plain versions

def _conv_bias_relu_pool(x: torch.Tensor, folded: FoldedConvBlock,
                         pad_out_w: int | None) -> torch.Tensor:
    """x (B, H, W, ci) -> (B, H/2, W/2, co) bf16: bf16-rounded x, f32 conv
    with the folded taps, + bias, ReLU, 2x2 max (floor), bf16. cuDNN's TF32
    is held off so that an f32 conv on the card sums in f32."""
    xb = x.to(torch.bfloat16).float().permute(0, 3, 1, 2)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        y = F.conv2d(xb, folded.weight.to(x.device), padding=1)
    y = torch.relu(y + folded.bias.to(x.device)[:, None, None])
    y = F.max_pool2d(y, 2).to(torch.bfloat16).permute(0, 2, 3, 1)
    return _pad_columns(y.contiguous(), pad_out_w)


def _pad_columns(y: torch.Tensor, pad_out_w: int | None) -> torch.Tensor:
    """Zero columns up to `pad_out_w` (the JAX wrappers' `pad_out_w`)."""
    if pad_out_w is not None and pad_out_w > y.shape[2]:
        y = F.pad(y, (0, 0, 0, pad_out_w - y.shape[2]))
    return y


def conv_block1_reference(feats: torch.Tensor, folded: FoldedConvBlock,
                          pad_out_w: int | None = None) -> torch.Tensor:
    """Plain version of block 1 (and of its batched form)."""
    return _conv_bias_relu_pool(feats, folded, pad_out_w)


def conv_packed_reference(x: torch.Tensor, folded: FoldedConvBlock, true_w: int | None = None,
                          pad_out_w: int | None = None) -> torch.Tensor:
    """Plain version of blocks 2-3: the first `true_w` columns of x."""
    wt = x.shape[2] if true_w is None else true_w
    return _conv_bias_relu_pool(x[:, :, :wt], folded, pad_out_w)


# ------------------------------------------------------------------------ checks

_BLOCK1_ONLY = {"fused_conv_block1": "fused_conv_block1 handles the 1->32 3x3 block only",
                "fused_conv_block1_batched": "fused_conv_block1_batched handles the 1->32 block only"}


def _check_block1(feats, conv_kernel, name: str) -> None:
    """`pallas_conv.py:303-307` and `:393-397`, with their messages."""
    b, h, w, cin = feats.shape
    if cin != 1 or tuple(conv_kernel.shape) != (3, 3, 1, _COUT1):
        raise ValueError(_BLOCK1_ONLY[name])
    if h % _TILE or h < 2 * _TILE or w < 4:
        raise ValueError(f"unsupported feature shape {(h, w)}")


def _check_packed(x, conv_kernel_shape, ci: int, co: int, true_w: int | None) -> int:
    """`pallas_conv.py:211-221`; returns the valid width."""
    b, h, w, cin = x.shape
    wt = true_w if true_w is not None else w
    if cin != ci or tuple(conv_kernel_shape) != (3, 3, ci, co):
        raise ValueError(
            f"expected a (3, 3, {ci}, {co}) block, got input {tuple(x.shape)} "
            f"kernel {tuple(conv_kernel_shape)}")
    if h % 2 or h < 4 or wt < 4 or wt > w:
        raise ValueError(f"unsupported input shape {(h, w)} (true_w={wt})")
    return wt


def _device_tensor(x: torch.Tensor) -> None:
    if not x.is_cuda:
        raise ValueError(f"unsupported device {x.device}")


def _dev_index(x: torch.Tensor) -> int:
    return x.device.index if x.device.index is not None else torch.cuda.current_device()


# -------------------------------------------------------------------- block 1

def _check_folded(folded: FoldedConvBlock, x: torch.Tensor, ci: int, co: int) -> None:
    if (folded.ci, folded.co) != (ci, co):
        raise ValueError(f"folded constants are a {folded.ci}->{folded.co} block, "
                         f"expected {ci}->{co}")
    if folded.taps.device != x.device:
        raise ValueError(f"folded constants on {folded.taps.device}, input on {x.device}")


def _block1_folded(wrapper, feats: torch.Tensor, folded: FoldedConvBlock,
                   pad_out_w: int | None) -> torch.Tensor:
    """What both block-1 wrappers share: the checks, the CPU route to the
    plain version, the launch and the count (on `wrapper`)."""
    _check_block1(feats, folded.weight.permute(2, 3, 1, 0), wrapper.__name__)
    if feats.device.type == "cpu":
        return conv_block1_reference(feats, folded, pad_out_w)
    _device_tensor(feats)
    _check_folded(folded, feats, 1, _COUT1)
    if feats.dtype != torch.float32:
        raise TypeError(f"feats must be float32, got {feats.dtype}")
    x = feats.contiguous()
    b, h, w, _ = x.shape
    out_w = max(w // 2, pad_out_w or 0)
    out = torch.empty((b, h // 2, out_w, _COUT1), dtype=torch.bfloat16, device=x.device)
    units, col_tiles = block1_schedule(out_w)
    lib = _build.load("fused_conv_block1")
    _build.launch(lib, lib.fused_conv_block1_launch, _dev_index(x), x.data_ptr(), b, h, w,
            folded.taps.data_ptr(), folded.bias.data_ptr(), out.data_ptr(), out_w,
            units, col_tiles, torch.cuda.current_stream(x.device).cuda_stream)
    wrapper.launches += 1
    return out


def conv_block1_folded(feats: torch.Tensor, folded: FoldedConvBlock, *,
                       pad_out_w: int | None = None) -> torch.Tensor:
    """`fused_conv_block1` on constants folded once (`fold_conv_block`
    with bias_bf16=True)."""
    return _block1_folded(fused_conv_block1, feats, folded, pad_out_w)


def fused_conv_block1(feats, conv_kernel, bn_scale, bn_bias, bn_mean, bn_var, *,
                      eps: float = 1e-5, pad_out_w: int | None = None) -> torch.Tensor:
    """Fused eval block 1: (B, H, W, 1) f32 -> (B, H//2, W//2, 32) bf16
    (`csrc/fused_conv_block1.cu`). Takes H % 16 == 0, H >= 32, W >= 4.
    `pad_out_w`: zero output columns up to that width."""
    _check_block1(feats, conv_kernel, "fused_conv_block1")
    folded = fold_conv_block(conv_kernel, bn_scale, bn_bias, bn_mean, bn_var, eps=eps,
                             bias_bf16=True, device=feats.device)
    return conv_block1_folded(feats, folded, pad_out_w=pad_out_w)


def conv_block1_batched_folded(feats: torch.Tensor, folded: FoldedConvBlock, *,
                               group: int = 8, pad_out_w: int | None = None) -> torch.Tensor:
    """`fused_conv_block1_batched` on constants folded once."""
    if group < 1:
        raise ValueError(f"group must be >= 1, got {group}")
    return _block1_folded(fused_conv_block1_batched, feats, folded, pad_out_w)


def fused_conv_block1_batched(feats, conv_kernel, bn_scale, bn_bias, bn_mean, bn_var, *,
                              eps: float = 1e-5, group: int = 8,
                              pad_out_w: int | None = None) -> torch.Tensor:
    """`fused_conv_block1` under the TPU's batched entry point: the same
    function and the same CUDA kernel, whose grid covers the batch whatever
    `group` is (the TPU stacked `group` examples in lanes to widen its
    matrix products). Counted apart, in its own `launches`."""
    _check_block1(feats, conv_kernel, "fused_conv_block1_batched")
    folded = fold_conv_block(conv_kernel, bn_scale, bn_bias, bn_mean, bn_var, eps=eps,
                             bias_bf16=True, device=feats.device)
    return conv_block1_batched_folded(feats, folded, group=group, pad_out_w=pad_out_w)


# ----------------------------------------------------------------- blocks 2, 3

def conv_packed_folded(x: torch.Tensor, folded: FoldedConvBlock, *, true_w: int | None = None,
                       pad_out_w: int | None = None) -> torch.Tensor:
    """`fused_conv_block2` / `_block3` on constants folded once
    (`fold_conv_block` with bias_bf16=False); the block follows from
    the folded channel counts."""
    ci, co = folded.ci, folded.co
    if (ci, co) not in ((32, 64), (64, 128)):
        raise ValueError(f"no fused kernel for a {ci}->{co} block")
    wt = _check_packed(x, (3, 3, ci, co), ci, co, true_w)
    if x.device.type == "cpu":
        return conv_packed_reference(x, folded, wt, pad_out_w)
    _device_tensor(x)
    _check_folded(folded, x, ci, co)
    xb = x.to(torch.bfloat16).contiguous()
    b, h, w, _ = x.shape
    tma_row_pitch(w, ci)
    out_w = max(wt // 2, pad_out_w or 0)
    out = torch.empty((b, h // 2, out_w, co), dtype=torch.bfloat16, device=x.device)
    sched = packed_schedule(h, wt, out_w, ci)
    lib = _build.load("fused_conv_packed")
    _build.launch(lib, lib.fused_conv_packed_launch, _dev_index(x), ci, co, xb.data_ptr(), b, h, w,
            wt, folded.taps.data_ptr(), folded.bias.data_ptr(), out.data_ptr(), out_w,
            sched.rows, sched.slots, sched.col_tiles,
            torch.cuda.current_stream(x.device).cuda_stream)
    (fused_conv_block2 if ci == 32 else fused_conv_block3).launches += 1
    return out


def _fused_conv_packed(x, conv_kernel, bn_scale, bn_bias, bn_mean, bn_var, ci: int, co: int,
                       eps: float, true_w: int | None, pad_out_w: int | None) -> torch.Tensor:
    _check_packed(x, np.shape(conv_kernel), ci, co, true_w)
    folded = fold_conv_block(conv_kernel, bn_scale, bn_bias, bn_mean, bn_var, eps=eps,
                             bias_bf16=False, device=x.device)
    return conv_packed_folded(x, folded, true_w=true_w, pad_out_w=pad_out_w)


def fused_conv_block2(x, conv_kernel, bn_scale, bn_bias, bn_mean, bn_var, *,
                      eps: float = 1e-5, true_w: int | None = None,
                      pad_out_w: int | None = None) -> torch.Tensor:
    """Fused eval block 2: (B, H, W, 32) -> (B, H//2, W//2, 64) bf16
    (`csrc/fused_conv_packed.cu`). Takes H even >= 4, W >= 4, bf16 or f32
    input. `true_w`: read only the first `true_w` columns; `pad_out_w`: zero
    output columns up to that width."""
    return _fused_conv_packed(x, conv_kernel, bn_scale, bn_bias, bn_mean, bn_var, 32, 64,
                              eps, true_w, pad_out_w)


def fused_conv_block3(x, conv_kernel, bn_scale, bn_bias, bn_mean, bn_var, *,
                      eps: float = 1e-5, true_w: int | None = None,
                      pad_out_w: int | None = None) -> torch.Tensor:
    """Fused eval block 3: (B, H, W, 64) -> (B, H//2, W//2, 128) bf16, the
    same kernel at 64 -> 128."""
    return _fused_conv_packed(x, conv_kernel, bn_scale, bn_bias, bn_mean, bn_var, 64, 128,
                              eps, true_w, pad_out_w)


for _fn in (fused_conv_block1, fused_conv_block1_batched, fused_conv_block2, fused_conv_block3):
    _fn.launches = 0

# ctypes signatures of the C entry points in csrc/*.cu
_P, _I = ctypes.c_void_p, ctypes.c_int
_build.declare("fused_conv_block1", {
    "fused_conv_block1_launch": [_I, _P, _I, _I, _I, _P, _P, _P, _I, _I, _I, _P],
    "fused_conv_block1_occupancy": [_I, _I, _P],
})
_build.declare("fused_conv_packed", {
    "fused_conv_packed_launch": [_I, _I, _I, _P, _I, _I, _I, _I, _P, _P, _P, _I, _I, _I, _I, _P],
    "fused_conv_packed_occupancy": [_I, _I, _I, _I, _I, _P],
})


def kernel_occupancy(x: torch.Tensor) -> dict[str, int]:
    """CTAs an SM, registers a thread and shared bytes a CTA of the kernel
    that a block's input `x` (on the card) launches: block 1 at one channel."""
    _, h, w, ci = x.shape
    out = (ctypes.c_int * 3)()
    if ci == 1:
        lib = _build.load("fused_conv_block1")
        _build.launch(lib, lib.fused_conv_block1_occupancy, _dev_index(x),
                      block1_schedule(w // 2)[0], out)
    else:
        sched = packed_schedule(h, w, w // 2, ci)
        lib = _build.load("fused_conv_packed")
        _build.launch(lib, lib.fused_conv_packed_occupancy, _dev_index(x), ci, 2 * ci,
                      sched.rows, sched.slots, out)
    return {"ctas_per_sm": out[0], "registers": out[1], "shared_bytes": out[2]}
