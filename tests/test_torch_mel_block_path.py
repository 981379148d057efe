"""The block path of the mixed-radix log-mel kernel
(`csrc/log_mel_mixed_radix.cu`, every n_fft % 4 == 0 up to 16,384 without a
warp instance) on the CPU, by a numpy model of its passes.

The kernel runs only on the card (`chip_smoke.py` phase 16 holds it to the
plain version and the golden there). What it computes from indices is
written out here for every butterfly of a pass at once and held against
`np.fft.fft` and the port's plain version in float64:

- the plan (`mel_kernels.block_plan`, which phase 16 reads back from the
  card): P, m, Bluestein's length and columns, threads, lanes a mel band and
  shared bytes, for every block-path n_fft;
- the XOR swizzle of the shared slots (`swz`): a permutation within each
  group of 16, and the banks it spreads the passes' strides over;
- the hand-written 2/4/8-point DFTs both ways, and the radix-3/5/7 ones;
- the radix passes (butterfly to items, elements and slots, twiddles, the
  inverse undoing the forward) and the digit-reversed positions they leave;
- the whole spectrum of a frame pair: the row passes with the twiddle
  W_N^{r k0} on their last write, then the staged odd passes or Bluestein
  (chirp, forward, times DFT_M of the conjugate chirp, inverse, chirp),
  against `np.fft.fft` through `bin_slot`;
- the unpacking and the mel pass of whole calls against the plain version.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from audio_classification_icbhi_tpu_torch.ops import mel_kernels as mk
from audio_classification_icbhi_tpu_torch.ops import stft as port_stft
from audio_classification_icbhi_tpu_torch.ops.mel import log_mel_spectrogram

SR, N_MELS = 16000, 128
CPU = torch.device("cpu")
SOURCE = (Path(mk.__file__).resolve().parent.parent / "csrc" / "log_mel_mixed_radix.cu").read_text()
WARP = {int(n) for n in re.findall(r"X\((\d+), \d+, \d+\)", SOURCE)}
# the block-path n_fft phase 16 times, the two smallest, and the largest
# Bluestein workspace (16,380 = 4 * 4095, M = 8192)
SHAPES = (1200, 1100, 4036, 12288, 16384, 16380, 4, 36)


def block_n_fft():
    return [n for n in range(4, mk.MIXED_RADIX_MAX_N_FFT + 1, 4)
            if n not in mk.RADIX8_N_FFT and n not in WARP]


# --- the plan ------------------------------------------------------------------

def test_plan_of_every_block_n_fft():
    """Every block-path n_fft: P the largest power of two dividing it, m the
    odd rest; Bluestein exactly where m has a prime factor above 7, at the
    smallest power of two M >= 2m - 1, over all P columns a round where the
    workspace fits; 64 to 1024 threads in whole warps; a whole number of
    mel groups a warp; the shared bytes within a Hopper block's opt-in."""
    assert len(block_n_fft()) == 4096 - 5 - len(WARP)
    for n in block_n_fft():
        plan = mk.block_plan(n)
        p, m, big_m, cols = plan["p"], plan["m"], plan["bluestein"], plan["columns"]
        assert p & (p - 1) == 0 and p * m == n and m % 2 == 1
        needs = any(f > 7 for f in mk._odd_factors(m))
        assert bool(big_m) == needs
        if needs:
            assert big_m & (big_m - 1) == 0 and 2 * m - 1 <= big_m < 4 * m - 2
            assert p % cols == 0
            assert cols == p or mk.block_plan(n, 10**9)["smem_bytes"] > mk.HOPPER_SMEM_OPTIN
        else:
            assert cols == 1
        assert plan["threads"] % 32 == 0 and 64 <= plan["threads"] <= 1024
        assert 32 % plan["mel_lanes"] == 0
        assert plan["smem_bytes"] == 8 * (-(-n // 16) * 16 + -(-cols * big_m // 16) * 16)
        assert plan["smem_bytes"] <= mk.HOPPER_SMEM_OPTIN


@pytest.mark.parametrize("n_fft, want", [
    (1200, (16, 75, 0, 1, 96, 4, 9600)),
    (1100, (4, 275, 1024, 4, 256, 4, 41600)),
    (4036, (4, 1009, 2048, 4, 512, 8, 97920)),
    (12288, (4096, 3, 0, 1, 768, 32, 98304)),
    (16384, (16384, 1, 0, 1, 1024, 32, 131072)),
    (16380, (4, 4095, 8192, 1, 1024, 32, 196608)),
    (4, (4, 1, 0, 1, 64, 1, 128)),
    (36, (4, 9, 0, 1, 64, 1, 384)),
])
def test_plan_at_the_named_shapes(n_fft, want):
    """The plans phase 16 prints at its block-path shapes (and the two
    smallest): (P, m, M, columns, threads, lanes a band, shared bytes)."""
    plan = mk.block_plan(n_fft)
    assert tuple(plan[k] for k in ("p", "m", "bluestein", "columns", "threads", "mel_lanes",
                                   "smem_bytes")) == want


def test_the_limit_stays_16384():
    """The one n_fft limit of every route is the largest power of two whose
    block fits: 16,384 (131,072 bytes); 32,768 would need 262,144."""
    assert mk.MIXED_RADIX_MAX_N_FFT == 16384
    assert mk.mixed_radix_smem_bytes(32768) > mk.HOPPER_SMEM_OPTIN


# --- the swizzle ------------------------------------------------------------------

def test_swizzle_permutes_each_group_of_16():
    a = np.arange(1 << 16)
    s = mk.swizzle(a)
    assert (s >> 4 == a >> 4).all()
    for g in range(0, 1 << 16, 16):
        assert sorted(s[g:g + 16]) == list(range(g, g + 16))


def banks_hit(slots) -> int:
    """The most 8-byte slots of one access that share a bank pair: a
    half-warp's 16 float2 loads are one 128-byte wavefront when distinct."""
    return int(np.bincount(np.asarray(slots) % 16, minlength=16).max())


@pytest.mark.parametrize("stride", [1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096])
def test_swizzle_spreads_power_of_two_strides(stride):
    """Sixteen lanes at a power-of-two stride of slots (the radix passes'
    sub-sequences at every span, and consecutive bins' digit-reversed
    slots, P / 8 apart) fall on 16 distinct banks from any aligned start, at
    most 2 deep for strides of 2 and 4, which the plain layout would put
    16 deep."""
    for base in range(0, 16384, 16 * stride):
        hit = banks_hit(mk.swizzle(base + stride * np.arange(16)))
        assert hit <= (2 if stride in (2, 4) else 1)
    if stride >= 16:
        assert banks_hit(stride * np.arange(16)) == 16


# --- the small DFTs -----------------------------------------------------------------

H = np.sqrt(0.5)


def mul_i(a, inverse):
    return a * (1j if inverse else -1j)


def small_dft(x, inverse=False):
    """The kernel's `small_dft<R>` over axis 0: radix 2 and 4 written out,
    radix 8 as two radix-4 halves and W_8^k, radix 3/5/7 by the symmetric
    pairs of `butterfly<R>`."""
    r = x.shape[0]
    if r == 2:
        return np.stack([x[0] + x[1], x[0] - x[1]])
    if r == 4:
        s02, d02 = x[0] + x[2], x[0] - x[2]
        s13, d13 = x[1] + x[3], mul_i(x[1] - x[3], inverse)
        return np.stack([s02 + s13, d02 + d13, s02 - s13, d02 - d13])
    if r == 8:
        e, o = small_dft(x[0::2], inverse), small_dft(x[1::2], inverse)
        sign = 1 if inverse else -1
        o = o * np.array([1, H + sign * 1j * H, sign * 1j, -H + sign * 1j * H])[:, None]
        return np.concatenate([e + o, e - o])
    assert not inverse
    h = (r - 1) // 2
    a = {j: x[j] + x[r - j] for j in range(1, h + 1)}
    b = {j: x[j] - x[r - j] for j in range(1, h + 1)}
    out = np.empty_like(x)
    out[0] = x[0] + sum(a.values())
    for q in range(1, h + 1):
        c = x[0] + sum(np.cos(2 * np.pi * ((j * q) % r) / r) * a[j] for j in a)
        s = sum(np.sin(2 * np.pi * ((j * q) % r) / r) * b[j] for j in b)
        out[q], out[r - q] = c - 1j * s, c + 1j * s
    return out


@pytest.mark.parametrize("r, inverse", [(2, False), (4, False), (8, False), (2, True),
                                        (4, True), (8, True), (3, False), (5, False), (7, False)])
def test_small_dfts(rng, r, inverse):
    x = rng.standard_normal((r, 5)) + 1j * rng.standard_normal((r, 5))
    want = np.fft.ifft(x, axis=0) * r if inverse else np.fft.fft(x, axis=0)
    np.testing.assert_allclose(small_dft(x, inverse), want, rtol=0, atol=1e-12)


# --- the passes --------------------------------------------------------------------

def radix_pass(buf, batch, r, span, inverse=False, pre=None, post=None, seen=None):
    """One `radix_pass<R>` over every transform of `batch` = (len, count,
    bstride, estride) at `span`, all butterflies at once: items to (j, s, blk)
    as the kernel splits them, elements e = blk span + s + t span / R, slots
    swz(j bstride + e estride); forward DFT then twiddle W_span^{s q}, or
    inverse twiddle then DFT; `pre` multiplies element e as it is read,
    `post` = (post_bin, N) multiplies element e of transform j by W_N^{j
    post_bin[e]} as it is written. `seen` collects each pass's slots."""
    length, count, bstride, estride = batch
    sub, per = span // r, length // r
    u = np.arange(count * per)
    if bstride == 1 and count >= 16:
        jj, j = np.divmod(u, count)
    else:
        j, jj = np.divmod(u, per)
    blk, s = np.divmod(jj, sub)
    e = blk[:, None] * span + s[:, None] + sub * np.arange(r)[None, :]
    slots = mk.swizzle(j[:, None] * bstride + e * estride)
    if seen is not None:
        seen.append(slots)
    v = buf[slots].T
    if pre is not None:
        v = v * pre[e].T
    w = np.exp(-2j * np.pi * np.outer(np.arange(r), s) / span)
    v = small_dft(v * np.conj(w), True) if inverse else small_dft(v) * w
    if post is not None:
        post_bin, n = post
        v = v * np.exp(-2j * np.pi * (j[None, :] * post_bin[e].T) / n)
    buf[slots.T] = v


def pow2_passes(buf, batch, inverse=False, pre=None, post=None, seen=None):
    """`pow2_passes`: radix 8 from the whole length down, 2 or 4 last;
    inverse from the smallest span up, `pre` on its first pass, `post` on
    the forward's last."""
    bits = batch[0].bit_length() - 1
    spans = []
    s = bits
    while s > 0:
        r = min(3, s)
        spans.append((1 << s, 1 << r))
        s -= r
    for i, (span, r) in enumerate(reversed(spans) if inverse else spans):
        radix_pass(buf, batch, r, span, inverse, pre if inverse and i == 0 else None,
                   post if not inverse and i == len(spans) - 1 else None, seen)


def odd_passes(buf, batch, seen=None):
    span = batch[0]
    while span > 1:
        r = next(f for f in (3, 5, 7) if span % f == 0)
        radix_pass(buf, batch, r, span, seen=seen)
        span //= r


@pytest.mark.parametrize("length", [2, 4, 8, 16, 32, 256, 2048, 8192])
def test_pow2_passes_leave_digit_reversed_bins(rng, length):
    """The forward passes over three transforms leave bin k at
    `digit_positions`; the inverse passes return the input times the
    length; no two butterflies of a pass share a slot."""
    count = 3
    z = rng.standard_normal((count, length)) + 1j * rng.standard_normal((count, length))
    buf = np.zeros(-(-count * length // 16) * 16, complex)
    buf[mk.swizzle(np.arange(count * length))] = z.ravel()
    seen = []
    pow2_passes(buf, (length, count, length, 1), seen=seen)
    for slots in seen:
        assert len(np.unique(slots)) == slots.size
    got = buf[mk.swizzle(np.arange(count * length))].reshape(count, length)
    pos = mk.digit_positions(length, mk._pow2_radices(length))
    np.testing.assert_allclose(got[:, pos], np.fft.fft(z, axis=1), rtol=0, atol=1e-9 * length)
    pow2_passes(buf, (length, count, length, 1), inverse=True)
    back = buf[mk.swizzle(np.arange(count * length))].reshape(count, length)
    np.testing.assert_allclose(back, z * length, rtol=0, atol=1e-9 * length)


@pytest.mark.parametrize("m", [3, 9, 15, 75, 105, 2205])
def test_odd_passes_leave_digit_reversed_bins(rng, m):
    """The staged radix-3/5/7 passes down 4 columns (column c at c m + r)
    leave output q at `digit_positions` over the ascending factors."""
    count = 4
    z = rng.standard_normal((count, m)) + 1j * rng.standard_normal((count, m))
    buf = np.zeros(-(-count * m // 16) * 16, complex)
    buf[mk.swizzle(np.arange(count * m))] = z.ravel()
    odd_passes(buf, (m, count, m, 1))
    got = buf[mk.swizzle(np.arange(count * m))].reshape(count, m)
    pos = mk.digit_positions(m, mk._odd_factors(m))
    np.testing.assert_allclose(got[:, pos], np.fft.fft(z, axis=1), rtol=0, atol=1e-9 * m)


def exact_chirps(m, big_m):
    """Bluestein's chirp and DFT_M of its conjugate at the forward
    positions, in float64 (the kernel's tables are these in float32)."""
    n = np.arange(m)
    w = np.exp(-1j * np.pi * ((n * n) % (2 * m)) / m)
    b = np.zeros(big_m, complex)
    b[n] = np.conj(w)
    b[(-n) % big_m] = np.conj(w)
    pos = mk.digit_positions(big_m, mk._pow2_radices(big_m))
    return w, (np.fft.fft(b) / big_m)[np.argsort(pos)]


def block_spectrum(z, n_fft):
    """One frame pair z (N complex, natural order) through the block path as
    the kernel runs it, in float64; returns the slice of shared memory and
    `bin_slot` (Z[k] at bin_slot[k])."""
    plan = mk.block_plan(n_fft)
    p, m, big_m, cols = plan["p"], plan["m"], plan["bluestein"], plan["columns"]
    col_bin, bin_slot = (t.numpy() for t in mk._block_tables(n_fft, CPU)[:2])
    y = np.zeros(-(-n_fft // 16) * 16, complex)
    y[mk.swizzle(np.arange(n_fft))] = z
    pow2_passes(y, (p, m, 1, m), post=(col_bin, n_fft) if m > 1 else None)
    if m > 1 and not big_m:
        odd_passes(y, (m, p, m, 1))
    elif m > 1:
        chirp, chirp_hat = exact_chirps(m, big_m)
        for c0 in range(0, p, cols):
            ws = np.zeros(-(-cols * big_m // 16) * 16, complex)
            u = np.arange(cols * big_m)
            j, e = np.divmod(u, big_m)
            inside = e < m
            ws[mk.swizzle(u[inside])] = y[mk.swizzle((c0 + j[inside]) * m + e[inside])] * chirp[
                e[inside]]
            pow2_passes(ws, (big_m, cols, big_m, 1))
            pow2_passes(ws, (big_m, cols, big_m, 1), inverse=True, pre=chirp_hat)
            u = np.arange(cols * m)
            j, q = np.divmod(u, m)
            y[mk.swizzle((c0 + j) * m + q)] = ws[mk.swizzle(j * big_m + q)] * chirp[q]
    return y, bin_slot


@pytest.mark.parametrize("n_fft", SHAPES)
def test_block_spectrum_matches_fft(rng, n_fft):
    """Lane by lane with exact twiddles: Z[k] of the pair at `bin_slot[k]`
    equals `np.fft.fft` (1e-9 of the input's sum of magnitudes: float64
    rounding only)."""
    z = rng.standard_normal(n_fft) + 1j * rng.standard_normal(n_fft)
    y, bin_slot = block_spectrum(z, n_fft)
    np.testing.assert_allclose(y[bin_slot], np.fft.fft(z), rtol=0,
                               atol=1e-9 * np.abs(z).sum())


@pytest.mark.parametrize("n_fft", SHAPES)
def test_block_tables_match_their_definitions(n_fft):
    """col_bin inverts the row passes' positions; bin_slot[k] is the
    swizzled row_pos[k // P] + m col_pos[k % P], a permutation of the pair's
    slots; the chirp is exp(-i pi n^2 / m) and chirp_hat DFT_M of b_n =
    conj w_|n| over M at the forward positions (float32 of the float64
    values: 2e-7)."""
    plan = mk.block_plan(n_fft)
    p, m, big_m = plan["p"], plan["m"], plan["bluestein"]
    col_bin, bin_slot, chirp, chirp_hat = mk._block_tables(n_fft, CPU)
    col_pos = mk.digit_positions(p, mk._pow2_radices(p))
    np.testing.assert_array_equal(col_pos[col_bin.numpy()], np.arange(p))
    assert sorted(bin_slot.tolist()) == sorted(mk.swizzle(np.arange(n_fft)).tolist())
    assert (chirp is None) == (chirp_hat is None) == (big_m == 0)
    if big_m:
        n = np.arange(m)
        w = np.exp(-1j * np.pi * n.astype(float) ** 2 / m)
        np.testing.assert_allclose(chirp.double().numpy() @ np.array([1, 1j]), w, atol=2e-7)
        hat = exact_chirps(m, big_m)[1]
        np.testing.assert_allclose(chirp_hat.double().numpy() @ np.array([1, 1j]), hat, atol=2e-7)


# --- whole calls ---------------------------------------------------------------------

def block_log_mel(x, n_fft, hop):
    """The block path end to end in float64, pair by pair: the staged
    windowed pair (reflected at the edges), `block_spectrum`, the unpacking
    of both frames' power at `bin_slot`, the mel pass (mel_lanes lanes a
    band, interleaved weights, a shuffle tree), dB."""
    plan = mk.block_plan(n_fft)
    starts, offsets, weights = (t.numpy() for t in mk.mel_bands(
        SR, n_fft, N_MELS, 0.0, SR / 2.0, "htk", None, CPU))
    window = port_stft.hann_window(n_fft, dtype=torch.float64).numpy()
    batch, length = x.shape
    t_count = port_stft.num_frames(length, n_fft, hop)
    frames = port_stft.frame_signal(torch.from_numpy(x), n_fft, hop).numpy() * window
    out = np.zeros((batch, N_MELS, t_count))
    g = plan["mel_lanes"]
    for b in range(batch):
        for t0 in range(0, t_count, 2):
            pair = frames[b, t0 + 1] if t0 + 1 < t_count else np.zeros(n_fft)
            y, bin_slot = block_spectrum(frames[b, t0] + 1j * pair, n_fft)
            k = np.arange(n_fft // 2 + 1)
            za, zb = y[bin_slot[k]], y[bin_slot[(-k) % n_fft]]
            power = (0.25 * np.abs(za + np.conj(zb)) ** 2, 0.25 * np.abs(za - np.conj(zb)) ** 2)
            for mel in range(N_MELS):
                lo, hi = offsets[mel], offsets[mel + 1]
                lanes = [[0.0, 0.0] for _ in range(g)]
                for jw in range(lo, hi):
                    kb = starts[mel] + jw - lo
                    lanes[(jw - lo) % g][0] += weights[jw] * power[0][kb]
                    lanes[(jw - lo) % g][1] += weights[jw] * power[1][kb]
                width = g
                while width > 1:
                    width //= 2
                    lanes = [[lanes[i][f] + lanes[i + width][f] for f in (0, 1)]
                             for i in range(width)]
                for f, t in ((0, t0), (1, t0 + 1)):
                    if t < t_count:
                        out[b, mel, t] = 10 * np.log10(max(lanes[0][f], 1e-10))
    return out


@pytest.mark.parametrize("n_fft, hop, batch, length", [
    (36, 9, 2, 101), (1200, 300, 1, 1700), (1100, 275, 1, 1500), (4036, 1009, 1, 3000),
    (16380, 4095, 1, 4500)])
def test_block_model_end_to_end(rng, n_fft, hop, batch, length):
    """The block path's model against the port's plain version in float64:
    within 1e-9 dB, edge pairs and an odd T included."""
    x = rng.standard_normal((batch, length))
    want = log_mel_spectrogram(torch.from_numpy(x), SR, n_fft, hop, N_MELS).numpy()
    np.testing.assert_allclose(block_log_mel(x, n_fft, hop), want, rtol=0, atol=1e-9)
