"""The index math of the radix-8 log-mel kernel (`csrc/log_mel_radix8dif.cu`)
on the CPU, by a numpy model of its lanes.

The kernel runs only on the card (`chip_smoke.py` phases 3, 11 and 16 hold it
to the plain version there). What it computes from indices is written out
here for the 32 lanes of a warp at once, and held against numpy and the
port's plain version in float64:

- the reflection of a frame's sample indices into the unpadded waveform
  (`reflect_index`), against `stft_ops.reflect_pad`;
- each lane's rows u_r[n] for n = lane + 32i, the class twiddle, the
  register FFT (stages inside a lane, then five across lanes by xor), the
  bit-reversed bins, the class-0 and class-4 skip rules and the skewed power
  buffer, against `np.fft.rfft` power;
- the mel pass (four interleaved accumulators, added as (a0 + a1) + (a2 +
  a3)) against the banded filterbank matmul;
- a whole warp, frame by frame, against the plain version.

The warps an SM, registers and shared bytes of each instance are the card's
own: `chip_smoke.py` phase 16 reads them from `log_mel_radix8dif_occupancy`.
"""

import numpy as np
import pytest
import torch

from audio_classification_icbhi_tpu_torch.ops import mel_kernels as mk
from audio_classification_icbhi_tpu_torch.ops import stft as port_stft
from audio_classification_icbhi_tpu_torch.ops.mel import _mel_filterbank_np, log_mel_spectrogram

SR, N_MELS = 16000, 128
CPU = torch.device("cpu")
LANES = np.arange(32)
KH = np.sqrt(0.5)


def reflect_index(o: np.ndarray, length: int) -> np.ndarray:
    """The kernel's `reflect_index`, elementwise, with C's signed `%`."""
    if length == 1:
        return np.zeros_like(o)
    period = 2 * (length - 1)
    r = np.fmod(o, period)
    r = np.where(r < 0, r + period, r)
    return np.where(r >= length, period - r, r)


def frame_indices(t: int, n_fft: int, hop: int, length: int) -> tuple[np.ndarray, bool]:
    """The waveform indices frame t reads, and whether it is an edge frame
    (the kernel's `edge`: only those reflect)."""
    base = t * hop - n_fft // 2
    edge = base < 0 or base + n_fft > length
    o = base + np.arange(n_fft)
    return (reflect_index(o, length) if edge else o), edge


@pytest.mark.parametrize("length, n_fft, hop", [
    (1, 1024, 256),       # L = 1: index 0 throughout
    (5, 512, 128),        # a pad (256) far longer than the signal
    (257, 512, 128),      # odd L, pad just shorter than L
    (3001, 1024, 300),    # odd L, hop not dividing n_fft
    (80000, 2048, 512),   # the serving clip
    (8000, 8192, 2048),   # a pad (4096) longer than half the signal
])
def test_reflection_matches_reflect_pad(length, n_fft, hop):
    """Every frame's indices, edge frames reflected and interior frames read
    directly, pick the samples `frame_signal` frames from the padded
    signal; the edge frames are those within n_fft / 2 of either end."""
    x = torch.arange(length, dtype=torch.float64)
    frames = port_stft.frame_signal(x, n_fft, hop).numpy()
    t_count = port_stft.num_frames(length, n_fft, hop)
    assert frames.shape == (t_count, n_fft)
    edges = 0
    for t in range(t_count):
        idx, edge = frame_indices(t, n_fft, hop, length)
        edges += edge
        assert idx.min() >= 0 and idx.max() < length
        np.testing.assert_array_equal(x.numpy()[idx], frames[t])
    interior = [t for t in range(t_count)
                if t * hop >= n_fft // 2 and t * hop + n_fft // 2 <= length]
    assert edges == t_count - len(interior)


def test_reflection_of_reflect_pad_itself():
    """`reflect_index` over the whole padded range is `reflect_pad`'s gather,
    at L = 1, 2 and an odd L with pads shorter and longer than L."""
    for length in (1, 2, 7, 100):
        for pad in (1, 3, 6, 7, 250):
            x = torch.arange(length, dtype=torch.float64)
            want = port_stft.reflect_pad(x, pad).numpy()
            got = x.numpy()[reflect_index(np.arange(-pad, length + pad), length)]
            np.testing.assert_array_equal(got, want)


def lane_rows(frame: np.ndarray, e: int) -> dict[int, np.ndarray]:
    """The windowed frame's class sequences as the lanes form them: class r
    -> u_r at (lane, i) for n = lane + 32i, with the kernel's expressions."""
    p = e // 32
    n = LANES[:, None] + 32 * np.arange(p)[None, :]
    bj = [frame[j * e + n] for j in range(8)]
    ev = (bj[0] + bj[4]) + (bj[2] + bj[6])
    od = (bj[1] + bj[5]) + (bj[3] + bj[7])
    d04, d26 = bj[0] - bj[4], bj[2] - bj[6]
    s17, s35 = bj[1] + bj[7], bj[3] + bj[5]
    hs = KH * ((bj[5] + bj[7]) - (bj[1] + bj[3]))
    return {0: ev + od + 0j, 4: ev - od + 0j,
            1: (d04 + KH * (s17 - s35)) + 1j * (hs - d26),
            2: ((bj[0] + bj[4]) - (bj[2] + bj[6])) + 1j * ((bj[3] + bj[7]) - (bj[1] + bj[5])),
            3: (d04 + KH * (s35 - s17)) + 1j * (hs + d26)}


def fft_dif_lanes(z: np.ndarray, tw: np.ndarray) -> np.ndarray:
    """The kernel's `fft_dif`: z (32 lanes, P) complex, element p = lane +
    32i; stages of half-length 32h inside a lane, then half 16 .. 1 across
    lanes, the partner lane ^ half; bin bitrev(p) ends at p."""
    z = z.copy()
    p = z.shape[1]
    h = p // 2
    while h >= 1:
        for i in range(p):
            if i & h:
                continue
            a, b = z[:, i].copy(), z[:, i + h].copy()
            z[:, i] = a + b
            z[:, i + h] = (a - b) * tw[32 * h - 1 + LANES + 32 * (i & (h - 1))]
        h //= 2
    for half in (16, 8, 4, 2, 1):
        partner = z[LANES ^ half]
        upper = ((LANES & half) != 0)[:, None]
        w = tw[half - 1 + (LANES & (half - 1))][:, None]
        z = np.where(upper, (partner - z) * w, z + partner)
    return z


def bitrev(v: np.ndarray, bits: int) -> np.ndarray:
    out = np.zeros_like(v)
    for b in range(bits):
        out |= ((v >> b) & 1) << (bits - 1 - b)
    return out


def pw_index(k):
    return k + (k >> 5)


def power_words(n_fft: int) -> int:
    """The kernel's `pw_words`: bins 0 .. n_fft / 2 and their skew."""
    return pw_index(n_fft // 2) + 1


def exact_twiddles(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """The kernel's two tables by their definitions, in complex128: W_N^{rn}
    (r = 1..4, n < E) and W_{2h}^j at [h - 1 + j]."""
    e = n_fft // 8
    rn = np.exp(-2j * np.pi * np.outer(np.arange(1, 5), np.arange(e)) / n_fft)
    stages = np.zeros(e - 1, complex)
    h = 1
    while h < e:
        stages[h - 1:2 * h - 1] = np.exp(-2j * np.pi * np.arange(h) / (2 * h))
        h *= 2
    return rn, stages


def kernel_power(frame: np.ndarray, n_fft: int, exact: bool = False):
    """The warp's power buffer after the five classes, and how often each
    word was written: from the kernel's own tables (complex128 of its f32
    pairs), or with `exact` from the tables' definitions in float64."""
    e = n_fft // 8
    if exact:
        trn, tfft = exact_twiddles(n_fft)
    else:
        _, trn, tfft = mk._twiddles_radix8dif(n_fft, CPU)
        trn = trn.double().numpy() @ np.array([1, 1j])
        tfft = tfft.double().numpy() @ np.array([1, 1j])
        for table, exact_table in zip((trn, tfft), exact_twiddles(n_fft)):
            np.testing.assert_allclose(table, exact_table, rtol=0, atol=1e-7)
    words = power_words(n_fft)
    pw, writes = np.zeros(words), np.zeros(words, dtype=int)
    n = LANES[:, None] + 32 * np.arange(e // 32)[None, :]
    m = bitrev(n, e.bit_length() - 1)
    for r, u in lane_rows(frame, e).items():
        if r:
            u = u * trn[r - 1][n]
        z = fft_dif_lanes(u, tfft)
        keep = np.ones_like(m, dtype=bool)
        if r == 0:
            keep = m <= e // 2
        elif r == 4:
            keep = m < e // 2
        k = 8 * m + r
        k = np.where(k > n_fft // 2, n_fft - k, k)[keep]
        np.add.at(writes, pw_index(k), 1)
        pw[pw_index(k)] = np.abs(z[keep]) ** 2
    return pw, writes


@pytest.mark.parametrize("n_fft", mk.RADIX8_N_FFT)
def test_classes_to_bins_match_rfft(rng, n_fft):
    """Each lane's classes, twiddles, FFT, bins and skip rules put every bin
    k = 0 .. n_fft / 2 in the power buffer exactly once, with rfft's power;
    the skew leaves the other words untouched and stays inside the
    buffer."""
    frame = rng.standard_normal(n_fft)
    pw, writes = kernel_power(frame, n_fft)
    k = np.arange(n_fft // 2 + 1)
    np.testing.assert_array_equal(writes[pw_index(k)], 1)
    assert writes.sum() == k.size and pw_index(k).max() == power_words(n_fft) - 1
    want = np.abs(np.fft.rfft(frame)) ** 2
    np.testing.assert_allclose(pw[pw_index(k)], want, rtol=0, atol=1e-6 * want.max())


@pytest.mark.parametrize("n_fft", mk.RADIX8_N_FFT)
def test_skip_rules_drop_only_mirrored_bins(n_fft):
    """Class 0 keeps m <= E/2 and class 4 keeps m < E/2: the dropped bins
    are the mirrored halves, whose k > n_fft / 2 fold onto kept bins."""
    e = n_fft // 8
    m = np.arange(e)
    for r, keep in ((0, m <= e // 2), (4, m < e // 2)):
        kept = 8 * m[keep] + r
        dropped = 8 * m[~keep] + r
        assert kept.max() <= n_fft // 2
        assert set(n_fft - dropped) <= set(kept)
    for r in (1, 2, 3):  # complex classes keep all, folding k > N/2 to N - k
        k = 8 * m + r
        folded = np.where(k > n_fft // 2, n_fft - k, k)
        assert len(set(folded)) == e and folded.max() < n_fft // 2


def mel_pass(pw: np.ndarray, starts, offsets, weights, n_mels: int, dtype) -> np.ndarray:
    """The kernel's mel pass over a power buffer: lane l sums bands l, l +
    32, ... in four interleaved accumulators, added as (a0 + a1) + (a2 +
    a3)."""
    out = np.zeros(n_mels, dtype)
    pw, weights = pw.astype(dtype), weights.astype(dtype)
    for lane in range(32):
        for m in range(lane, n_mels, 32):
            lo, hi = offsets[m], offsets[m + 1]
            k0 = starts[m] - lo
            a = [dtype(0)] * 4
            j = lo
            while j + 4 <= hi:
                for q in range(4):
                    a[q] = a[q] + weights[j + q] * pw[pw_index(k0 + j + q)]
                j += 4
            for q in range(3):
                if j + q < hi:
                    a[q] = a[q] + weights[j + q] * pw[pw_index(k0 + j + q)]
            out[m] = (a[0] + a[1]) + (a[2] + a[3])
    return out


@pytest.mark.parametrize("n_fft", mk.RADIX8_N_FFT)
def test_mel_pass_matches_banded_matmul(rng, n_fft):
    """The band walk with its remainder (0-3 weights) covers each band's
    nonzero weights exactly: float64 agrees with the dense filterbank matmul
    to 1e-12, float32 to 1e-6 (a different order of the same sums)."""
    starts, offsets, weights = (t.numpy() for t in mk.mel_bands(
        SR, n_fft, N_MELS, 0.0, SR / 2.0, "htk", None, CPU))
    power = rng.random(n_fft // 2 + 1) * 10.0 ** rng.uniform(-6, 2, n_fft // 2 + 1)
    pw = np.zeros(power_words(n_fft))
    pw[pw_index(np.arange(power.size))] = power
    want = _mel_filterbank_np(SR, n_fft, N_MELS, 0.0, SR / 2.0, "htk", None).T @ power
    got = mel_pass(pw, starts, offsets, weights, N_MELS, np.float64)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    got32 = mel_pass(pw, starts, offsets, weights, N_MELS, np.float32)
    np.testing.assert_allclose(got32, want, rtol=1e-6, atol=1e-30)
    assert (offsets[1:] - offsets[:-1]).max() % 4 in (0, 1, 2, 3)


@pytest.mark.parametrize("n_fft, hop, batch, length", [
    (512, 128, 2, 700), (1024, 256, 1, 1), (1024, 300, 2, 2999), (2048, 512, 2, 3000)])
def test_warp_model_end_to_end(rng, n_fft, hop, batch, length):
    """The model of a warp, frame by frame (reflection, window, classes,
    FFT, power buffer, mel pass, dB) with exact twiddles, against the
    port's plain version in float64: within 1e-9 dB. Edge frames, pads
    longer than the signal and L = 1 included."""
    x = rng.standard_normal((batch, length))
    window = port_stft.hann_window(n_fft, dtype=torch.float64).numpy()
    starts, offsets, weights = (t.numpy() for t in mk.mel_bands(
        SR, n_fft, N_MELS, 0.0, SR / 2.0, "htk", None, CPU))
    t_count = port_stft.num_frames(length, n_fft, hop)
    got = np.zeros((batch, N_MELS, t_count))
    for b in range(batch):
        for t in range(t_count):
            idx, _ = frame_indices(t, n_fft, hop, length)
            pw, _ = kernel_power(x[b, idx] * window, n_fft, exact=True)
            mel = mel_pass(pw, starts, offsets, weights, N_MELS, np.float64)
            got[b, :, t] = 10.0 * np.log10(np.maximum(mel, 1e-10))
    want = log_mel_spectrogram(torch.from_numpy(x), SR, n_fft, hop, N_MELS).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)

