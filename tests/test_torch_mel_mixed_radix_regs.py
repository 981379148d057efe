"""The index math of the mixed-radix log-mel kernel
(`csrc/log_mel_mixed_radix.cu`) on the CPU, by a numpy model of its lanes.

The kernel runs only on the card (`chip_smoke.py` phase 16 holds it to the
plain version there). What it computes from indices is written out here for
the lanes of a warp at once and held against numpy and the port's plain
version in float64:

- the plan: n_fft -> (P, the odd factor's prime factors, path) for every
  n_fft % 4 == 0 up to 16,384 that the source takes, by its launch
  function's switch as the source lists it, and each path's shared memory;
- the warp path's four steps lane by lane (the staged frame pair, each
  lane's block of rows, the P-point FFT over L lanes, the twiddle W_N^{r k0},
  the odd factor's DFT as radix-3/5/7 butterflies) against `np.fft.fft`, the
  unpacking of the two frames' power and where the mel pass finds it;
- (the block path is `tests/test_torch_mel_block_path.py`'s);
- the in-kernel reflection of a frame pair, the pairs (never across
  examples, odd T) and the warp loop's groups;
- a whole warp, pair by pair, against the plain version.

The warps an SM, registers and shared bytes of each path are the card's
own: `chip_smoke.py` phase 16 reads them from `log_mel_mixed_radix_occupancy`.
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
MODEL_N_FFT = (400, 448, 480, 768, 800, 1280, 1536, 3072, 6144)
SOURCE = (Path(mk.__file__).resolve().parent.parent / "csrc" / "log_mel_mixed_radix.cu").read_text()


def warp_instances() -> dict[int, tuple[int, int]]:
    """The source's MIXED_RADIX_WARP_INSTANCES, X(n_fft, P, m): n_fft -> (P, m)."""
    body = re.search(r"#define MIXED_RADIX_WARP_INSTANCES\(X\)((?:.*\\\n)*.*)", SOURCE).group(1)
    return {int(n): (int(p), int(m))
            for n, p, m in re.findall(r"X\((\d+), (\d+), (\d+)\)", body)}


WARP = warp_instances()
# complex values a lane keeps in registers on the warp path (its kRegValues)
REG_VALUES = int(re.search(r"constexpr int kRegValues = (\d+);", SOURCE).group(1))


def bitrev(v, bits: int):
    v = np.asarray(v)
    out = np.zeros_like(v)
    for b in range(bits):
        out |= ((v >> b) & 1) << (bits - 1 - b)
    return out


def geometry(n_fft: int) -> tuple[int, int, int, int, int]:
    """(P, m, L lanes a pair, Q row elements a lane, G pairs a warp)."""
    p = n_fft & -n_fft
    lanes = min(p, 32)
    return p, n_fft // p, lanes, p // lanes, 32 // lanes


# --- the plan ---------------------------------------------------------------

def all_n_fft():
    return [n for n in range(4, mk.MIXED_RADIX_MAX_N_FFT + 1, 4) if n not in mk.RADIX8_N_FFT]


def prime_factors(m: int) -> list[int]:
    out, f = [], 3
    while m > 1:
        while m % f == 0:
            out.append(f)
            m //= f
        f += 2
    return out


def plan(n_fft: int) -> tuple[int, list[int], str]:
    """How the source runs n_fft, by its launch function's switch: (P, the
    odd factor's prime factors in the order its DFT takes them, path).
    "registers" or "shared": a warp instance, its rows in registers where
    m * Q <= kRegValues complex values, else in the lane's block of shared
    memory; "block": one block a frame pair
    (tests/test_torch_mel_block_path.py)."""
    p = n_fft & -n_fft
    factors = prime_factors(n_fft // p)
    if n_fft not in WARP:
        return p, factors, "block"
    values = (n_fft // p) * geometry(n_fft)[3]
    return p, factors, "registers" if values <= REG_VALUES else "shared"


def test_plan_covers_every_n_fft():
    """Every n_fft % 4 == 0 up to 16,384 outside the radix-8 source's has a
    plan: P the largest power of two dividing it, the factors' product the
    odd rest; the warp instances the model of every lane below takes, in
    registers up to 1536 and in shared memory at 3072 and 6144; the block
    path everywhere else, 4036 = 4 * 1009 and the two largest included."""
    paths = {}
    for n in all_n_fft():
        p, factors, path = plan(n)
        assert p & (p - 1) == 0 and n % p == 0 and (n // p) % 2 == 1
        assert int(np.prod(factors, dtype=np.int64)) == n // p
        assert factors == sorted(factors) and all(f % 2 for f in factors)
        paths.setdefault(path, []).append(n)
    assert paths["registers"] == [400, 448, 480, 768, 800, 1280, 1536]
    assert paths["shared"] == [3072, 6144]
    assert sorted(WARP) == list(MODEL_N_FFT)
    assert 4036 in paths["block"] and 12288 in paths["block"] and 16384 in paths["block"]
    assert plan(4036) == (4, [1009], "block")


@pytest.mark.parametrize("n_fft", sorted(WARP))
def test_warp_instance_is_its_n_fft(n_fft):
    """Each warp instance X(n_fft, P, m): P the largest power of two dividing
    n_fft, m the odd rest, a product of 3, 5 and 7 (the hand-written
    butterflies), and P >= 16 (a group of at least 16 lanes a pair)."""
    p, m = WARP[n_fft]
    assert p == n_fft & -n_fft and p * m == n_fft and m % 2 == 1
    assert set(prime_factors(m)) <= {3, 5, 7} and p >= 16


def test_shared_memory_of_each_path():
    """A warp-path pair takes 8 N bytes (its staged pair, then Z, then the
    power in place) and G pairs a warp; a warp fits a Hopper block at every
    warp n_fft. The block path's block (`mel_kernels.block_plan`: the pair,
    and Bluestein's workspace where it has one) fits up to the one limit,
    16,384."""
    for n in WARP:
        assert 8 * n * geometry(n)[4] <= mk.HOPPER_SMEM_OPTIN
    for n in all_n_fft():
        assert mk.mixed_radix_smem_bytes(n) <= mk.HOPPER_SMEM_OPTIN
    assert mk.mixed_radix_smem_bytes(2 * mk.MIXED_RADIX_MAX_N_FFT) > mk.HOPPER_SMEM_OPTIN


# --- the warp path's constants -----------------------------------------------

def pairs(t):
    return t.double().numpy() @ np.array([1, 1j])


def exact_tables(n_fft: int):
    """The warp path's tables by their definitions: stage twiddles W_{2h}^j
    at [h - 1 + j], W_N^{r k0} (r = 1 .. m - 1) and W_m^j."""
    p, m = geometry(n_fft)[:2]
    stages = np.zeros(p - 1, complex)
    h = 1
    while h < p:
        stages[h - 1:2 * h - 1] = np.exp(-2j * np.pi * np.arange(h) / (2 * h))
        h *= 2
    rk = np.exp(-2j * np.pi * np.outer(np.arange(1, m), np.arange(p)) / n_fft)
    return stages, rk, np.exp(-2j * np.pi * np.arange(m) / m)


@pytest.mark.parametrize("n_fft", MODEL_N_FFT + (4036, 1200, 16384))
def test_tables_match_their_definitions(n_fft):
    """The wrapper passes both paths' tables at every n_fft, as the launch
    function picks the path: the window, then the warp path's (the block
    path's are `_block_tables`, tests/test_torch_mel_block_path.py)."""
    window, *tables = mk._twiddles_mixed_radix(n_fft, CPU)
    np.testing.assert_array_equal(window.numpy(), port_stft.hann_window(n_fft).numpy())
    want = exact_tables(n_fft)
    assert len(tables) == len(want)
    for got, exact in zip(tables, want):
        assert got.dtype == torch.float32 and got.is_contiguous()
        np.testing.assert_allclose(pairs(got).reshape(exact.shape), exact, rtol=0, atol=1e-7)


# --- the warp path, lane by lane ----------------------------------------------

def fft_row_lanes(v: np.ndarray, tw: np.ndarray, lanes: int) -> np.ndarray:
    """The kernel's `fft_row`: v (L lanes, Q) complex, element n = lg + L i;
    stages of half-length L h inside a lane, then half L/2 .. 1 across lanes
    (partner lg ^ half); bin bitrev(n) ends at n."""
    v = v.copy()
    lg = np.arange(lanes)
    q = v.shape[1]
    h = q // 2
    while h >= 1:
        for i in range(q):
            if i & h:
                continue
            a, b = v[:, i].copy(), v[:, i + h].copy()
            v[:, i] = a + b
            v[:, i + h] = (a - b) * tw[lanes * h - 1 + lg + lanes * (i & (h - 1))]
        h //= 2
    half = lanes // 2
    while half >= 1:
        partner = v[lg ^ half]
        upper = ((lg & half) != 0)[:, None]
        w = tw[half - 1 + (lg & (half - 1))][:, None] if half > 1 else 1.0
        s = np.where(upper, -1.0, 1.0)
        v = (s * v + partner) * np.where(upper, w, 1.0)
        half //= 2
    return v


RADIX_COS = {r: np.cos(2 * np.pi * np.arange(r) / r) for r in (3, 5, 7)}
RADIX_SIN = {r: np.sin(2 * np.pi * np.arange(r) / r) for r in (3, 5, 7)}


def butterfly(x: np.ndarray) -> np.ndarray:
    """The kernel's `butterfly<R>` over axis 0 (R = 3, 5, 7): the symmetric
    pairs a_j, b_j and X[q], X[R - q] from one cos and one sin sum."""
    r = x.shape[0]
    h = (r - 1) // 2
    a = {j: x[j] + x[r - j] for j in range(1, h + 1)}
    b = {j: x[j] - x[r - j] for j in range(1, h + 1)}
    out = np.empty_like(x)
    out[0] = x[0] + sum(a.values())
    for q in range(1, h + 1):
        c = x[0] + sum(RADIX_COS[r][(j * q) % r] * a[j] for j in a)
        s = sum(RADIX_SIN[r][(j * q) % r] * b[j] for j in b)
        out[q] = c - 1j * s
        out[r - q] = c + 1j * s
    return out


def smallest_factor(m: int) -> int:
    return 3 if m % 3 == 0 else 5 if m % 5 == 0 else 7


def dft(x: np.ndarray, tw: np.ndarray, stride: int = 1) -> np.ndarray:
    """The kernel's `dft<M, kStride>` over axis 0: decimation in time over
    the smallest factor R, W_M^t = tw[t * stride] of the top-level table."""
    m = x.shape[0]
    if m in (3, 5, 7):
        return butterfly(x)
    if m == 1:
        return x.copy()
    r = smallest_factor(m)
    s = m // r
    y = [dft(x[j::r], tw, stride * r) for j in range(r)]
    out = np.empty_like(x)
    for k in range(s):
        c = np.stack([y[j][k] * (1.0 if (j * k) % m == 0 else tw[((j * k) % m) * stride])
                      for j in range(r)])
        c = butterfly(c)
        for q in range(r):
            out[k + s * q] = c[q]
    return out


@pytest.mark.parametrize("m", [3, 5, 7, 9, 15, 21, 25, 27, 35, 45, 49, 75, 105, 125])
def test_odd_factor_dft_matches_fft(rng, m):
    """The radix-3/5/7 butterflies and the factored m-point DFT (each factor
    a pass, twiddles W_M^{jk} from the one table) are the DFT."""
    x = rng.standard_normal((m, 4)) + 1j * rng.standard_normal((m, 4))
    tw = np.exp(-2j * np.pi * np.arange(m) / m)
    np.testing.assert_allclose(dft(x, tw), np.fft.fft(x, axis=0), rtol=0,
                               atol=1e-12 * np.abs(x).sum())


def warp_pair(za_frames: np.ndarray, n_fft: int, tables=None):
    """One group's frame pair through the warp path, as the kernel computes
    it: z (the staged windowed pair, a + ib) -> each lane's rows -> row FFTs
    -> W_N^{r k0} -> the odd factor's DFT -> Z in the lanes' blocks -> the
    unpacked powers in place. Returns (Y by row and lane, the slice after
    the DFT, the slice after unpacking, which slots each lane wrote)."""
    p, m, lanes, q, _ = geometry(n_fft)
    stages, rk, wm = tables if tables is not None else exact_tables(n_fft)
    z = za_frames.astype(complex)
    n = np.arange(lanes)[:, None] + lanes * np.arange(q)[None, :]  # (L, Q)
    rows = np.stack([z[m * n + r] for r in range(m)])  # (m, L, Q)
    y = np.stack([fft_row_lanes(rows[r], stages, lanes) for r in range(m)])
    k0 = bitrev(n, p.bit_length() - 1)
    c = y.copy()
    for r in range(1, m):
        c[r] = c[r] * rk[r - 1][k0]
    c = dft(c, wm)
    sl = np.empty(p * m, complex)
    for qq in range(m):
        sl[m * n + qq] = c[qq]
    out = sl.copy()
    written = np.zeros(p * m, int)
    reads = {}
    for lane in range(lanes):
        for i in range(q):
            nn = lane + lanes * i
            kk = int(bitrev(nn, p.bit_length() - 1))
            kp = (p - kk) & (p - 1)
            np_ = int(bitrev(kp, p.bit_length() - 1))
            for qq in range((m - 1) // 2 + 1):  # k0 + P q > N/2 past (m - 1) / 2
                if qq == (m - 1) // 2 and 2 * kk > p:
                    continue
                assert kk + p * qq <= n_fft // 2
                qp = m - 1 - qq if kk else (m - qq) % m
                a, b = sl[m * nn + qq], sl[m * np_ + qp]
                reads[(lane, m * np_ + qp)] = True
                out[m * nn + qq] = (0.25 * abs(a + np.conj(b)) ** 2
                                    + 1j * 0.25 * abs(a - np.conj(b)) ** 2)
                written[m * nn + qq] += 1
    return y, sl, out, written, reads


def power_position(k, n_fft: int):
    """Where the mel pass finds bin k's powers: z[m bitrev(k mod P) + k / P]."""
    p, m = geometry(n_fft)[:2]
    return m * bitrev(np.asarray(k) & (p - 1), p.bit_length() - 1) + np.asarray(k) // p


@pytest.mark.parametrize("n_fft", MODEL_N_FFT)
def test_warp_steps_match_fft(rng, n_fft):
    """Lane by lane, with the kernel's own f32 tables: each row FFT leaves
    Y_r[bitrev(n)] at element n; the slice after the odd factor's DFT holds
    Z[bitrev(n) + P q] at m n + q (Z = fft of the staged pair); the
    unpacking writes each bin k <= N/2 once with both frames' power, and
    the mel pass's positions find them."""
    p, m, lanes, q, _ = geometry(n_fft)
    a, b = rng.standard_normal(n_fft), rng.standard_normal(n_fft)
    z = a + 1j * b
    _, stages, rk, wm = mk._twiddles_mixed_radix(n_fft, CPU)
    y, sl, out, written, _ = warp_pair(z, n_fft, tuple(pairs(t) for t in (stages, rk, wm)))
    n = np.arange(lanes)[:, None] + lanes * np.arange(q)[None, :]
    bits = p.bit_length() - 1
    tol = 1e-5 * np.abs(z).sum()
    for r in range(m):
        want = np.fft.fft(z[r::m])
        np.testing.assert_allclose(y[r], want[bitrev(n, bits)], rtol=0, atol=tol)
    zf = np.fft.fft(z)
    k = (bitrev(n, bits)[None, :, :] + p * np.arange(m)[:, None, None])  # (m, L, Q)
    pos = m * n[None, :, :] + np.arange(m)[:, None, None]
    np.testing.assert_allclose(sl[pos], zf[k], rtol=0, atol=tol)
    bins = np.arange(n_fft // 2 + 1)
    where = power_position(bins, n_fft)
    assert len(set(where.tolist())) == bins.size
    np.testing.assert_array_equal(written[where], 1)
    assert written.sum() == bins.size
    pa, pb = np.abs(np.fft.rfft(a)) ** 2, np.abs(np.fft.rfft(b)) ** 2
    np.testing.assert_allclose(out[where].real, pa, rtol=0, atol=1e-6 * pa.max())
    np.testing.assert_allclose(out[where].imag, pb, rtol=0, atol=1e-6 * pb.max())


@pytest.mark.parametrize("n_fft", MODEL_N_FFT)
def test_lanes_share_no_slot_while_unpacking(n_fft):
    """Between the two __syncwarp of the unpacking, a slot one lane writes
    is read by no other lane: the owner of k <= N/2 reads its own Z[k] and
    Z[N - k], whose owner (N - k > N/2) skips, except k = 0 and N/2, which
    pair with themselves."""
    p, m, lanes, q, _ = geometry(n_fft)
    _, _, _, written, reads = warp_pair(np.zeros(n_fft), n_fft)
    owner = np.empty(n_fft, int)
    for lane in range(lanes):
        for i in range(q):
            owner[m * (lane + lanes * i):m * (lane + lanes * i + 1)] = lane
    for lane, slot in reads:
        assert not (written[slot] and owner[slot] != lane)


@pytest.mark.parametrize("n_fft", MODEL_N_FFT)
def test_row_reads_are_free_of_bank_conflicts(n_fft):
    """A lane reads its rows at z[m n + r]: for fixed (r, i) the lanes of a
    half-warp touch float2 words m apart, m odd, so the 16 lanes' 64-bit
    loads fall on 32 distinct banks; each lane's block of m slots is its
    own."""
    p, m, lanes, q, g = geometry(n_fft)
    for r in range(m):
        for i in range(q):
            lane = np.arange(32)
            slot = (lane // lanes) * n_fft + m * (lane % lanes + lanes * i) + r
            for half in (slice(0, 16), slice(16, 32)):
                words = np.concatenate([2 * slot[half], 2 * slot[half] + 1])
                assert len(set((words % 32).tolist())) == 32


# --- frames, pairs and the reflection ------------------------------------------

def reflect_index(o: int, length: int) -> int:
    """`reflect_index` of log_mel_reflect.cuh, branch by branch, with C's `%`:
    an index inside the signal as it is, one bounce off either end without
    a division, the periodic rule past that."""
    if 0 <= o < length:
        return o
    if length == 1:
        return 0
    period = 2 * (length - 1)
    if -length < o < 0:
        return -o
    if length <= o <= period:
        return period - o
    r = int(np.fmod(o, period))
    if r < 0:
        r += period
    return period - r if r >= length else r


def reflect_all(o, length: int) -> np.ndarray:
    return np.array([reflect_index(int(v), length) for v in np.ravel(o)], dtype=np.int64)


@pytest.mark.parametrize("length", [1, 2, 3, 7, 100, 401])
def test_reflection_branches_match_reflect_pad(length):
    """Each branch of the reflection (inside, one bounce off the start or
    the end, the periodic rule for pads longer than the signal) picks the
    sample `reflect_pad` puts there, for pads from 1 to 3 periods."""
    x = torch.arange(length, dtype=torch.float64)
    for pad in sorted({1, 3, length - 1, length, length + 1, 3 * length + 2} - {0}):
        want = port_stft.reflect_pad(x, pad).numpy()
        got = x.numpy()[reflect_all(np.arange(-pad, length + pad), length)]
        np.testing.assert_array_equal(got, want)


def staged_pair(x: np.ndarray, t0: int, n_fft: int, hop: int):
    """The kernel's `stage_pair` of frames t0 and t0 + 1 (unwindowed): the
    pair reflects when either frame reaches into the padding."""
    length = x.size
    t_count = port_stft.num_frames(length, n_fft, hop)
    start = t0 * hop - n_fft // 2
    edge = start < 0 or start + hop + n_fft > length
    o = start + np.arange(n_fft)
    a = x[reflect_all(o, length) if edge else o]
    b = (x[reflect_all(o + hop, length) if edge else o + hop] if t0 + 1 < t_count
         else np.zeros(n_fft))
    return a, b, edge


@pytest.mark.parametrize("length, n_fft, hop", [
    (1, 800, 200),        # L = 1: index 0 throughout
    (150, 400, 160),      # L < N/2: the pad is longer than the signal
    (399, 800, 200),      # L < N/2, odd
    (3001, 768, 300),     # a hop that does not divide n_fft
    (80000, 768, 256),    # row 5's serving clip
    (80000, 1536, 384),   # row 3's
    (16321, 6144, 512),   # a pad longer than a third of the signal
])
def test_pair_staging_matches_frame_signal(length, n_fft, hop):
    """Each pair's staged samples are the two frames `frame_signal` cuts from
    the padded signal; the last pair of an odd T stages zeros for its absent
    frame."""
    x = np.arange(length, dtype=np.float64) + 1.0
    frames = port_stft.frame_signal(torch.from_numpy(x), n_fft, hop).numpy()
    t_count = frames.shape[0]
    for t0 in range(0, t_count, 2):
        a, b, edge = staged_pair(x, t0, n_fft, hop)
        np.testing.assert_array_equal(a, frames[t0])
        if t0 + 1 < t_count:
            np.testing.assert_array_equal(b, frames[t0 + 1])
        else:
            assert not b.any()
        if not edge:
            assert t0 * hop >= n_fft // 2 and t0 * hop + hop + n_fft // 2 <= length


@pytest.mark.parametrize("batch, t_count, n_fft", [(3, 313, 768), (2, 401, 800), (5, 1, 400),
                                                   (4, 2, 400), (3, 7, 1536)])
def test_pairs_cover_each_frame_once(batch, t_count, n_fft):
    """The warp loop over pairs, as the kernel walks it (a grid of 3 blocks
    of 2 warps, G pairs a warp): every (example, frame) is written exactly
    once, a pair never crosses examples, an odd T leaves each example's last
    frame alone, and a group past the last pair writes nothing."""
    g = geometry(n_fft)[4]
    per_example = (t_count + 1) // 2
    total = batch * per_example
    blocks, warps = 3, 2
    seen = np.zeros((batch, t_count), int)
    for block in range(blocks):
        for warp in range(warps):
            first = (block * warps + warp) * g
            while first < total:
                for group in range(g):
                    pr = first + group
                    if pr >= total:
                        continue
                    b, t0 = divmod(pr, per_example)
                    t0 *= 2
                    seen[b, t0] += 1
                    if t0 + 1 < t_count:
                        seen[b, t0 + 1] += 1
                first += blocks * warps * g
    np.testing.assert_array_equal(seen, 1)


# --- a whole warp ----------------------------------------------------------------

def mel_pass(power: np.ndarray, n_fft: int, lanes: int) -> np.ndarray:
    """The warp path's mel pass over one slice: lane lg sums bands lg, lg +
    L, ... for both frames, in four interleaved accumulators added as (a0 +
    a1) + (a2 + a3)."""
    starts, offsets, weights = (t.numpy() for t in mk.mel_bands(
        SR, n_fft, N_MELS, 0.0, SR / 2.0, "htk", None, CPU))
    out = np.zeros(N_MELS, complex)
    for lane in range(lanes):
        for mel in range(lane, N_MELS, lanes):
            lo, hi = offsets[mel], offsets[mel + 1]
            k0 = starts[mel] - lo
            acc = [0j] * 4
            for j in range(lo, hi):
                acc[(j - lo) % 4] += weights[j] * power[power_position(k0 + j, n_fft)]
            out[mel] = (acc[0] + acc[1]) + (acc[2] + acc[3])
    return out


@pytest.mark.parametrize("n_fft, hop, batch, length", [
    (400, 160, 2, 1700), (800, 200, 1, 1), (768, 300, 2, 2000), (480, 160, 1, 200)])
def test_warp_model_end_to_end(rng, n_fft, hop, batch, length):
    """The model of the warp path, pair by pair (staging with the
    reflection, window, the four steps, unpacking, mel pass, dB) with exact
    tables, against the port's plain version in float64: within 1e-9 dB.
    Edge frames, a pad longer than the signal, L = 1 and odd T included."""
    x = rng.standard_normal((batch, length))
    window = port_stft.hann_window(n_fft, dtype=torch.float64).numpy()
    lanes = geometry(n_fft)[2]
    t_count = port_stft.num_frames(length, n_fft, hop)
    got = np.zeros((batch, N_MELS, t_count))
    for b in range(batch):
        for t0 in range(0, t_count, 2):
            a, bb, _ = staged_pair(x[b], t0, n_fft, hop)
            _, _, power, _, _ = warp_pair(a * window + 1j * bb * window, n_fft)
            mel = mel_pass(power, n_fft, lanes)
            got[b, :, t0] = 10.0 * np.log10(np.maximum(mel.real, 1e-10))
            if t0 + 1 < t_count:
                got[b, :, t0 + 1] = 10.0 * np.log10(np.maximum(mel.imag, 1e-10))
    want = log_mel_spectrogram(torch.from_numpy(x), SR, n_fft, hop, N_MELS).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
