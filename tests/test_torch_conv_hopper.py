"""The Hopper designs of the fused conv-block kernels, modelled on the CPU.

`csrc/fused_conv_packed.cu` (blocks 2-3: a persistent implicit GEMM on
`wgmma`, input tiles by TMA, taps resident in shared memory) and
`csrc/fused_conv_block1.cu` (block 1 on `mma.sync`) cannot run here. What
they compute is modelled in numpy, lane by lane, from the host-side pieces
they take (`ops/conv_kernels.py`: the swizzled tap image, the tile
schedules):

- the tap image read back as a `wgmma` B descriptor reads it (K-major,
  8-row core-matrix groups, the 64- or 128-byte swizzle on address bits)
  gives the (co, 9·ci) taps exactly;
- the kernels' walks of their tile schedules (persistent CTAs, slots
  numbered through a CTA's tiles, m64 tiles taken in turn by two consumer
  warpgroups) cover every pooled output once, write zeros at columns
  w2n..out_w and nothing past out_w, and read only TMA boxes whose
  out-of-image pixels (rows outside [0, H), columns at or past w_valid) are
  zero-filled;
- the arithmetic: emulated TMA boxes in their swizzled shared-memory order,
  each lane's `ldmatrix` addresses, the MMAs as f32 matmuls in the kernels'
  M and N order, the accumulator-to-pool-window mapping with its one
  shuffle, bias, ReLU and the 16-byte stores, held to the plain versions
  within one bf16 ulp (rtol 2^-7, atol 1e-4 of the largest value): the
  products are exact and only the order of the f32 sum differs.
"""

import numpy as np
import pytest
import torch

from audio_classification_icbhi_tpu_torch.ops import conv_kernels as ck

BF16_RTOL = 2.0 ** -7


def bf16(x: np.ndarray) -> np.ndarray:
    """Round to bf16 (to nearest even), as float32."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(torch.bfloat16).float().numpy()


def bf16_bits(x: np.ndarray) -> np.ndarray:
    t = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(torch.bfloat16)
    return t.view(torch.int16).numpy().view(np.uint16)


def from_bits(bits: np.ndarray) -> np.ndarray:
    return torch.from_numpy(bits.astype(np.uint16).view(np.int16)).view(torch.bfloat16).float().numpy()


def folded_block(blk: int, seed: int = 0) -> ck.FoldedConvBlock:
    """Seeded folded constants of block `blk` (1-based), BN away from 1/0."""
    ci, co = {1: (1, 32), 2: (32, 64), 3: (64, 128)}[blk]
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((3, 3, ci, co)).astype(np.float32) * (0.3 if ci == 1 else 0.06)
    scale = (1.0 + 0.2 * rng.standard_normal(co)).astype(np.float32)
    shift = (0.1 * rng.standard_normal(co)).astype(np.float32)
    mean = (0.1 * rng.standard_normal(co)).astype(np.float32)
    var = (0.5 + rng.random(co)).astype(np.float32)
    return ck.fold_conv_block(k, scale, shift, mean, var, bias_bf16=blk == 1)


def assert_one_bf16_ulp(got: np.ndarray, want: torch.Tensor) -> None:
    want = want.float().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=BF16_RTOL, atol=1e-4 * np.abs(want).max())


# ------------------------------------------------------------ the tap image

def read_b_operand(image: np.ndarray, ci: int, co: int) -> np.ndarray:
    """The (co, 9·ci) taps as the kernel's `wgmma`s read them from the image's
    bytes: for tap t and k-step kc the descriptor starts at t·co·2ci + 32·kc,
    row n of B lies at (n // 8)·SBO + (n % 8)·span (SBO = 8 rows, span = 2ci
    bytes, the swizzle row), k at 2k bytes further; the hardware swizzle then
    XORs the address's 16-byte chunk bits (4..) with its bits 7.., modulo
    span / 16."""
    span, sbo = 2 * ci, 16 * ci
    raw = image.reshape(-1)
    out = np.zeros((co, 9 * ci), np.uint16)
    n = np.arange(co)[:, None]
    kk = np.arange(16)[None, :]
    for t in range(9):
        for kc in range(ci // 16):
            logical = t * co * span + 32 * kc + (n // 8) * sbo + (n % 8) * span + 2 * kk
            physical = logical ^ (((logical >> 7) & (span // 16 - 1)) << 4)
            out[:, t * ci + 16 * kc + kk[0]] = raw[physical // 2]
    return out


@pytest.mark.parametrize("blk", [2, 3])
@pytest.mark.parametrize("seed", [0, 1])
def test_tap_image_reads_back_as_the_taps(blk, seed):
    f = folded_block(blk, seed)
    ci, co = f.ci, f.co
    assert f.taps.shape == (9, co, ci) and f.taps.dtype == torch.bfloat16
    image = f.taps.view(torch.int16).numpy().view(np.uint16)
    got = read_b_operand(image, ci, co)
    # the taps in (c_out, (dh·3 + dw)·ci + c_in) order, from the folded weight
    want = bf16_bits(f.weight.permute(0, 2, 3, 1).reshape(co, 9 * ci).numpy())
    np.testing.assert_array_equal(got, want)
    # a swizzle, not the identity: rows past the first of each group move
    assert not np.array_equal(image.reshape(9, co, ci), want.reshape(co, 9, ci).transpose(1, 0, 2))


@pytest.mark.parametrize("ci", [32, 64])
def test_swizzle_is_a_permutation_within_each_row_group(ci):
    span = 2 * ci
    n = 8 * span * 3
    phys = ck.swizzle_offsets(n, span)
    assert sorted(phys.tolist()) == list(range(n))
    # bytes stay in their 8-row group and 16-byte chunks move whole
    np.testing.assert_array_equal(phys // (8 * span), np.arange(n) // (8 * span))
    np.testing.assert_array_equal(phys % 16, np.arange(n) % 16)


@pytest.mark.parametrize("w_pitch, ci, ok", [(78, 32, True), (39, 64, True), (16, 64, True),
                                             (8, 32, True), (3, 4, False), (5, 1, False)])
def test_tma_row_pitch(w_pitch, ci, ok):
    if ok:
        assert ck.tma_row_pitch(w_pitch, ci) == 2 * w_pitch * ci
    else:
        with pytest.raises(ValueError, match="multiple of 16"):
            ck.tma_row_pitch(w_pitch, ci)


# --------------------------------------------- the packed kernel's tile walk

CONSUMERS, STAGES = 2, 2  # fused_conv_packed.cu kConsumers, kStages


def packed_walk(sched: ck.PackedSchedule, batch: int, grid: int):
    """Every slot the kernel computes, in its own index math: per CTA its
    tiles tile = cta + k·grid and the slots numbered through them; the m64
    tile q (slots 4q..4q+3) goes to consumer q % 2, slot 4q + w to its warp
    w, whose place (tile k, pooled row lr, slot sc) steps 8 slots at a time
    without a division, as the kernel's does. Yields (cta, consumer, warp,
    k, b, h2, w2_0, box origin (row, col))."""
    n_tiles = sched.tiles(batch)
    rows, slots = sched.rows, sched.slots
    tile_slots = rows * slots
    for cta in range(min(grid, n_tiles)):
        n_local = (n_tiles - 1 - cta) // grid + 1
        n_sub = -(-(n_local * tile_slots) // 4)
        for cons in range(CONSUMERS):
            for wq in range(4):
                k, lr, sc = 0, 0, 4 * cons + wq
                while sc >= slots:
                    sc, lr = sc - slots, lr + 1
                for q in range(cons, n_sub, CONSUMERS):
                    if q != cons:
                        sc += 8
                        while sc >= slots:
                            sc, lr = sc - slots, lr + 1
                        if lr >= rows:
                            lr, k = lr - rows, k + 1
                    if k >= n_local:
                        continue  # past the CTA's last slot: computed, never stored
                    assert 4 * q + wq == k * tile_slots + lr * slots + sc
                    b, rc = divmod(cta + k * grid, sched.row_tiles * sched.col_tiles)
                    h2_0, w2_0 = rc // sched.col_tiles * rows, rc % sched.col_tiles * 4 * slots
                    yield (cta, cons, wq, k, b, h2_0 + lr, w2_0 + 4 * sc,
                           (2 * h2_0 - 1, 2 * w2_0 - 1))


PACKED_SHAPES = [
    # (batch, H, W, ci, true_w, pad_out_w): serving, the analyzer's, odd ones
    (128, 64, 78, 32, None, None), (128, 32, 39, 64, None, None),
    (64, 64, 16, 32, None, None), (64, 32, 8, 64, None, None),
    (1, 64, 77, 32, None, None), (1, 8, 9, 32, None, None), (1, 8, 12, 32, 10, 8),
    (3, 18, 19, 64, None, None), (2, 64, 313, 32, None, None),
]


@pytest.mark.parametrize("shape", PACKED_SHAPES)
def test_packed_walk_covers_each_window_once(shape):
    batch, h, w, ci, true_w, pad_out_w = shape
    wt = w if true_w is None else true_w
    out_w = max(wt // 2, pad_out_w or 0)
    sched = ck.packed_schedule(h, wt, out_w, ci)
    assert sched.rows * sched.slots >= 8  # every warp meets every tile: the ring's waits
    assert (sched.col_tiles - 1) * 4 * sched.slots < out_w <= sched.col_tiles * 4 * sched.slots
    box_h, box_w = sched.box
    assert box_h <= 256 and box_w <= 256 and sched.slots <= ck.PACKED_MAX_SLOTS[ci]
    for grid in (1, 7, 132, 264):
        hits = np.zeros((batch, sched.h2n, out_w), np.int32)
        per_consumer = {}
        seen = {}
        for cta, cons, wq, k, b, h2, w2_0, (r0, c0) in packed_walk(sched, batch, grid):
            per_consumer.setdefault(cta, np.zeros(CONSUMERS, np.int64))[cons] += 1
            seen.setdefault((cta, wq + 4 * cons), set()).add(k)
            if h2 >= sched.h2n:
                continue  # rows past h2n are computed and not stored
            # the slot's 16 pre-pool pixels and their 3x3 halo lie in the box
            rows = 2 * h2 + np.arange(-1, 3)
            cols = 2 * w2_0 + np.arange(-1, 9)
            assert rows.min() >= r0 and rows.max() < r0 + box_h
            assert cols.min() >= c0 and cols.max() < c0 + box_w
            for w2 in range(w2_0, min(w2_0 + 4, out_w)):
                hits[b, h2, w2] += 1
        np.testing.assert_array_equal(hits, 1)
        # in each CTA the two consumer warpgroups' slots differ by one m64 tile at most
        assert all(abs(int(c[0]) - int(c[1])) <= 4 for c in per_consumer.values())
        # each warp meets every one of its CTA's tiles
        n_tiles = sched.tiles(batch)
        for (cta, _), ks in seen.items():
            assert ks == set(range((n_tiles - 1 - cta) // min(grid, n_tiles) + 1))


@pytest.mark.parametrize("shape, pad_out_w", [((128, 128, 157), None), ((1, 48, 70), 40),
                                              ((13, 32, 9), None), ((2, 128, 626), None)])
def test_block1_walk_covers_each_window_once(shape, pad_out_w):
    batch, h, w = shape
    out_w = max(w // 2, pad_out_w or 0)
    units, col_tiles = ck.block1_schedule(out_w)
    assert (col_tiles - 1) * 8 * units < out_w <= col_tiles * 8 * units
    assert units <= ck.BLOCK1_MAX_UNITS
    row_tiles = h // 2 // 8
    n_tiles = batch * row_tiles * col_tiles
    for grid in (1, 5, 528):
        hits = np.zeros((batch, h // 2, out_w), np.int32)
        for cta in range(min(grid, n_tiles)):
            for k in range((n_tiles - 1 - cta) // grid + 1):
                b, rc = divmod(cta + k * grid, row_tiles * col_tiles)
                h2_0, w2_0 = rc // col_tiles * 8, rc % col_tiles * 8 * units
                for item in range(8 * units):
                    lr, u = divmod(item, units)
                    for win in range(8):
                        w2 = w2_0 + 8 * u + win
                        if w2 < out_w:
                            hits[b, h2_0 + lr, w2] += 1
        np.testing.assert_array_equal(hits, 1)


# ------------------------------------------- the packed kernel's arithmetic

def tma_box(x_bits: np.ndarray, b: int, r0: int, c0: int, box_h: int, box_w: int,
            w_valid: int) -> np.ndarray:
    """TMA's box of the (B, H, W, ci) bf16 bits at (r0, c0) of example b, in
    shared-memory order: zero outside rows [0, H) and columns [0, w_valid),
    each pixel's 2·ci bytes swizzled as `swizzle_offsets` says. Returns the
    stage as uint16 words."""
    _, h, _, ci = x_bits.shape
    dense = np.zeros((box_h, box_w, ci), np.uint16)
    rr = np.arange(r0, r0 + box_h)
    cc = np.arange(c0, c0 + box_w)
    ri = (rr >= 0) & (rr < h)
    cj = (cc >= 0) & (cc < w_valid)
    dense[np.ix_(ri, cj)] = x_bits[b][np.ix_(rr[ri], cc[cj])]
    flat = dense.reshape(-1)
    stage = np.zeros_like(flat)
    stage[ck.swizzle_offsets(flat.size * 2, 2 * ci)[::2] // 2] = flat
    return stage


def emulate_packed(x: torch.Tensor, f: ck.FoldedConvBlock, true_w=None, pad_out_w=None,
                   grid: int = 3) -> np.ndarray:
    """fused_conv_packed.cu on the CPU, lane by lane."""
    batch, h, w, ci = x.shape
    co = f.co
    wt = w if true_w is None else true_w
    out_w = max(wt // 2, pad_out_w or 0)
    sched = ck.packed_schedule(h, wt, out_w, ci)
    box_h, box_w = sched.box
    x_bits = bf16_bits(x.numpy())
    image = f.taps.view(torch.int16).numpy().view(np.uint16).reshape(-1)
    b_mat = from_bits(read_b_operand(image, ci, co)).T  # (9·ci, co): K x N
    bias = f.bias.numpy()
    out_bits = np.full((batch, sched.h2n, out_w, co), 0xFFFF, np.uint16)  # poison
    lane = np.arange(32)
    mi, r = lane >> 3, lane & 7
    bottom, khalf, col_in_slot = mi & 1, mi >> 1, 2 * (r & 3) + (r >> 2)
    g, t = lane >> 2, lane & 3
    right = g >= 4
    win_pitch = 2 * co + 32
    boxes = {}
    for cta, _, _, k, b, h2, w2_0, (r0, c0) in packed_walk(sched, batch, grid):
        key = (cta, k)
        if key not in boxes:
            boxes[key] = tma_box(x_bits, b, r0, c0, box_h, box_w, wt)
        stage = boxes[key]
        lr = (h2 - (r0 + 1) // 2)
        sc = (w2_0 - (c0 + 1) // 2) // 4
        p0 = (2 * lr + bottom) * box_w + 8 * sc + col_in_slot
        acc = np.zeros((16, co), np.float32)
        for tap in range(9):
            dh, dw = divmod(tap, 3)
            p = p0 + dh * box_w + dw
            sw = (p & 7) if ci == 64 else ((p >> 1) & 3)
            for kc in range(ci // 16):
                addr = p * 2 * ci + 16 * ((2 * kc + khalf) ^ sw)    # bytes, per lane
                rows8 = stage[(addr // 2)[:, None] + np.arange(8)]   # (32, 8) bf16 words
                a = np.zeros((16, 16), np.uint16)  # lane l: row l % 8 of matrix l / 8
                for ln in range(32):
                    a[r[ln] + 8 * bottom[ln], 8 * khalf[ln]:8 * khalf[ln] + 8] = rows8[ln]
                kk = tap * ci + 16 * kc
                acc += from_bits(a) @ b_mat[kk:kk + 16]
        if h2 >= sched.h2n:
            continue
        # thread (g, t) holds element 4j + e: row g + 8 (e >> 1), column 8j + 2t + (e & 1)
        cols = 8 * np.arange(co // 8)[None, :] + 2 * t[:, None]
        thr = np.stack([acc[(g + 8 * (e >> 1))[:, None], cols + (e & 1)] for e in range(4)],
                       axis=-1)  # (32 lanes, co / 8, 4)
        staging = np.zeros(4 * win_pitch // 2, np.uint16)
        for jj in range(co // 16):
            res = np.zeros((32, 2), np.float32)
            for e in range(2):
                even = np.maximum(thr[:, 2 * jj, e], thr[:, 2 * jj, 2 + e])
                odd = np.maximum(thr[:, 2 * jj + 1, e], thr[:, 2 * jj + 1, 2 + e])
                send = np.where(right, even, odd)
                got = send[lane ^ 16]
                keep = np.where(right, odd, even)
                n = 8 * (2 * jj + right) + 2 * t + e
                res[:, e] = np.maximum(np.maximum(keep, got) + bias[n], 0.0)
            byte = (g & 3) * win_pitch + 2 * (8 * (2 * jj + right) + 2 * t)
            staging[byte // 2] = bf16_bits(res[:, 0])
            staging[byte // 2 + 1] = bf16_bits(res[:, 1])
        per_win = co // 8
        for c in range(4 * co // 8):
            win, part = divmod(c, per_win)
            w2 = w2_0 + win
            if w2 < out_w:
                words = (staging[(win * win_pitch + 16 * part) // 2:][:8] if w2 < sched.w2n
                         else np.zeros(8, np.uint16))
                out_bits[b, h2, w2, 8 * part:8 * part + 8] = words
    assert not (out_bits == 0xFFFF).any(), "an output element was never written"
    return from_bits(out_bits)


@pytest.mark.parametrize("blk, shape, kw, grid", [
    (2, (2, 8, 18, 32), {}, 3), (2, (1, 8, 12, 32), {"true_w": 10, "pad_out_w": 8}, 2),
    (2, (1, 6, 23, 32), {}, 1), (3, (2, 8, 9, 64), {}, 2), (3, (1, 12, 21, 64), {}, 3),
])
def test_packed_emulation_matches_the_plain_version(blk, shape, kw, grid):
    f = folded_block(blk, seed=blk)
    rng = np.random.default_rng(len(shape) + shape[2])
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    if "true_w" in kw:
        x[:, :, kw["true_w"]:] = 5.0  # past true_w: never read
    got = emulate_packed(x, f, grid=grid, **kw)
    want = ck.conv_packed_reference(x, f, kw.get("true_w"), kw.get("pad_out_w"))
    assert_one_bf16_ulp(got, want)


# -------------------------------------------- the block-1 kernel's arithmetic

def emulate_block1(feats: torch.Tensor, f: ck.FoldedConvBlock, pad_out_w=None,
                   grid: int = 2) -> np.ndarray:
    """fused_conv_block1.cu on the CPU, lane by lane: the cp.async tile with
    its zero halo, the A fragments (taps 2t, 2t + 1 and 8), the MMA in its
    M order, the pool with its shuffle and the staged 16-byte stores."""
    batch, h, w, _ = feats.shape
    x = feats[..., 0].numpy()
    out_w = max(w // 2, pad_out_w or 0)
    h2n, w2n = h // 2, w // 2
    units, col_tiles = ck.block1_schedule(out_w)
    tile_w, row_tiles = 16 * units + 2, h2n // 8
    n_tiles = batch * row_tiles * col_tiles
    taps, bias = f.taps.numpy(), f.bias.numpy()
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    right = g >= 4
    k0, k1 = 2 * t, 2 * t + 1
    off0 = (k0 // 3) * tile_w + k0 % 3
    off1 = (k1 // 3) * tile_w + k1 % 3
    off8 = 2 * tile_w + 2
    # B: (16, 32) from the fragments b0 = taps 2t, 2t + 1 and b1 = tap 8 (t = 0) of channel 8j + g
    b_mat = np.zeros((16, 32), np.float32)
    for ln in range(32):
        for j in range(4):
            n = 8 * j + g[ln]
            b_mat[2 * t[ln], n], b_mat[2 * t[ln] + 1, n] = taps[2 * t[ln], n], taps[2 * t[ln] + 1, n]
            if t[ln] == 0:
                b_mat[8, n] = taps[8, n]
    out_bits = np.full((batch, h2n, out_w, 32), 0xFFFF, np.uint16)
    for cta in range(min(grid, n_tiles)):
        for k in range((n_tiles - 1 - cta) // grid + 1):
            b, rc = divmod(cta + k * grid, row_tiles * col_tiles)
            h2_0, w2_0 = rc // col_tiles * 8, rc % col_tiles * 8 * units
            r0, c0 = 2 * h2_0 - 1, 2 * w2_0 - 1
            tile = np.zeros((18, tile_w), np.float32)
            for rr in range(18):
                for cc in range(tile_w):
                    gr, gc = r0 + rr, c0 + cc
                    if 0 <= gr < h and 0 <= gc < w:
                        tile[rr, cc] = x[b, gr, gc]
            flat = tile.reshape(-1)
            for item in range(8 * units):
                lr, u = divmod(item, units)
                staging = np.zeros(8 * 96 // 2, np.uint16)
                for gg in range(2):
                    base = 2 * lr * tile_w + 2 * (8 * u + 4 * gg + (g & 3)) + (g >> 2)
                    a = np.zeros((16, 16), np.float32)  # (M row, k), from the fragments
                    a[g, k0] = bf16(flat[base + off0])
                    a[g, k1] = bf16(flat[base + off1])
                    a[g + 8, k0] = bf16(flat[base + tile_w + off0])
                    a[g + 8, k1] = bf16(flat[base + tile_w + off1])
                    z = t == 0
                    a[g[z], 8] = bf16(flat[base[z] + off8])
                    a[g[z] + 8, 8] = bf16(flat[base[z] + tile_w + off8])
                    acc = a @ b_mat  # (16, 32)
                    for jj in range(2):
                        res = np.zeros((32, 2), np.float32)
                        for e in range(2):
                            def elem(j, ee):
                                return acc[g + 8 * (ee >> 1), 8 * j + 2 * t + (ee & 1)]
                            even = np.maximum(elem(2 * jj, e), elem(2 * jj, 2 + e))
                            odd = np.maximum(elem(2 * jj + 1, e), elem(2 * jj + 1, 2 + e))
                            got = np.where(right, even, odd)[lane ^ 16]
                            n = 8 * (2 * jj + right) + 2 * t + e
                            res[:, e] = np.maximum(np.maximum(np.where(right, odd, even), got)
                                                   + bias[n], 0.0)
                        byte = (4 * gg + (g & 3)) * 96 + 2 * (8 * (2 * jj + right) + 2 * t)
                        staging[byte // 2] = bf16_bits(res[:, 0])
                        staging[byte // 2 + 1] = bf16_bits(res[:, 1])
                win, part = lane >> 2, lane & 3
                for ln in range(32):
                    w2 = w2_0 + 8 * u + win[ln]
                    if w2 < out_w:
                        words = (staging[(win[ln] * 96 + 16 * part[ln]) // 2:][:8] if w2 < w2n
                                 else np.zeros(8, np.uint16))
                        out_bits[b, h2_0 + lr, w2, 8 * part[ln]:8 * part[ln] + 8] = words
    assert not (out_bits == 0xFFFF).any(), "an output element was never written"
    return from_bits(out_bits)


@pytest.mark.parametrize("shape, pad_out_w, grid", [((1, 32, 9, 1), None, 1),
                                                    ((2, 32, 21, 1), None, 3),
                                                    ((1, 48, 70, 1), 40, 2),
                                                    ((1, 16, 135, 1), None, 2)])
def test_block1_emulation_matches_the_plain_version(shape, pad_out_w, grid):
    f = folded_block(1, seed=4)
    rng = np.random.default_rng(shape[2])
    feats = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    got = emulate_block1(feats, f, pad_out_w=pad_out_w, grid=grid)
    want = ck.conv_block1_reference(feats, f, pad_out_w)
    assert_one_bf16_ulp(got, want)
