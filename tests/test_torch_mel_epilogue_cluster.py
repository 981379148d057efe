"""The cluster epilogue (`csrc/log_mel_epilogue.cuh`) on the CPU, by a numpy
model of its CTAs, held against the JAX package's `_fused_epilogue`
(`audio_classification_icbhi_tpu/ops/pallas_mel.py:683`, a plain jnp
function, called per example) and the port's `epilogue_reference`.

The kernel runs only on the card (`chip_smoke.py` phase 19 holds it to
`epilogue_reference` in float64 there, checks two calls for equal bits and
reads its plan back). The model writes out what it computes from indices:

- the plan (`mel_kernels.epilogue_plan`): C CTAs an example, CTA r taking
  the band of mels [r band, r band + band) of every frame, the last bands
  short or empty; threads a CTA; resident (the band in shared memory at an
  odd row pitch) or re-read;
- each thread's walk over its cells (`GridWalk`, no divide) and the 16-byte
  loads (kVec = 4) where the bands allow them;
- the partials in a fixed order: a thread's cells in turn, a shuffle tree in
  each warp, the warps in order; the peak over the cluster, then each band's
  sum and squared deviations about its own mean, combined over the ranks in
  order (Chan, Golub and LeVeque), all in float64;
- the transposed write through the padded rows, free of bank conflicts.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_classification_icbhi_tpu.ops.pallas_mel import _fused_epilogue
from audio_classification_icbhi_tpu_torch.ops import mel_kernels as mk

EPS = 1e-8


def grid_walk(cols: int, threads: int, tid: int, count: int):
    """`GridWalk`: the (row, col) cells tid, tid + threads, ... of a grid of
    `cols` columns, stepped by carries."""
    r, c = (tid // cols, tid % cols) if cols else (0, tid)
    dr, dc = (threads // cols, threads % cols) if cols else (0, threads)
    out = []
    for _ in range(count):
        out.append((r, c))
        r, c = r + dr, c + dc
        if c >= cols:
            c -= cols
            r += 1
    return out


def warp_tree(v: np.ndarray) -> float:
    """`__shfl_down_sync` over 16, 8, 4, 2, 1: lane 0's sum."""
    v = v.copy()
    for o in (16, 8, 4, 2, 1):
        v[:32 - o] = v[:32 - o] + v[o:32]
    return v[0]


def cta_sum(per_thread: np.ndarray) -> float:
    """`cta_sum`: each warp's tree, then the warps in order."""
    total = 0.0
    for w in range(0, per_thread.size, 32):
        total += warp_tree(per_thread[w:w + 32])
    return total


def model(db: np.ndarray, top_db, normalize: bool, bounds, cluster: int, resident: bool,
          threads: int) -> np.ndarray:
    """(B, T, n_mels) float32 -> (B, n_mels, T) float32, CTA by CTA."""
    batch, t_count, n_mels = db.shape
    band = -(-n_mels // cluster)
    pitch = band | 1
    out = np.empty((batch, n_mels, t_count), np.float32)
    for b in range(batch):
        x = db[b]
        bands = []
        for r in range(cluster):
            lo = min(r * band, n_mels)
            bands.append((lo, min(lo + band, n_mels) - lo))
        peaks = [np.float32(x[:, lo:lo + cols].max()) if cols else np.float32(-np.inf)
                 for lo, cols in bands]
        floor = np.float32(max(peaks) - np.float32(top_db)) if top_db is not None else -np.inf
        f = bounds[b] if bounds is not None else None

        def value(t, m):
            v = np.float32(x[t, m])
            if f is not None and ((np.float32(m) >= f[0] and np.float32(m) < f[0] + f[1]) or (
                    np.float32(t) >= f[2] and np.float32(t) < f[2] + f[3])):
                return np.float32(0.0)
            return np.float32(max(v, floor))

        tiles = []
        stats = []
        for lo, cols in bands:
            tile = np.zeros((t_count, pitch), np.float32) if resident else None
            cells = t_count * cols
            per_thread = np.zeros(threads)
            for tid in range(threads):
                for t, c in grid_walk(cols, threads, tid, max(0, -(-(cells - tid) // threads))):
                    v = value(t, lo + c)
                    per_thread[tid] += np.float64(v)
                    if resident:
                        tile[t, c] = v
            s = cta_sum(per_thread)
            band_mean = s / cells if cells else 0.0
            per_thread[:] = 0.0
            for tid in range(threads):
                for t, c in grid_walk(cols, threads, tid, max(0, -(-(cells - tid) // threads))):
                    v = tile[t, c] if resident else value(t, lo + c)
                    per_thread[tid] += (np.float64(v) - band_mean) ** 2
            stats.append((cells, s, cta_sum(per_thread)))
            tiles.append(tile)
        n, mu, ss = 0.0, 0.0, 0.0
        for cells, s, m2 in stats:  # ranks in order
            if cells == 0:
                continue
            delta, nn = s / cells - mu, n + cells
            mu += delta * cells / nn
            ss += m2 + delta * delta * n * cells / nn
            n = nn
        mean = np.float32(mu)
        denom = np.float32(np.sqrt(np.float32(ss / (n - 1 if n > 1 else 1)))) + np.float32(EPS)
        for (lo, cols), tile in zip(bands, tiles):
            for c in range(cols):
                for t in range(t_count):
                    v = tile[t, c] if resident else value(t, lo + c)
                    out[b, lo + c, t] = (v - mean) / denom if normalize else v
    return out


def jax_epilogue(db: np.ndarray, top_db, normalize: bool, bounds) -> np.ndarray:
    """The JAX package's epilogue, example by example on its (T, n_mels)
    block, transposed to (n_mels, T)."""
    t_count, n_mels = db.shape[1:]
    return np.stack([np.asarray(_fused_epilogue(
        jnp.asarray(db[b]), t_count, n_mels, normalize, top_db, EPS,
        None if bounds is None else jnp.asarray(bounds[b]))).T for b in range(db.shape[0])])


def edge_bounds(batch: int, t_count: int, n_mels: int) -> np.ndarray:
    """(B, 4) f32 bounds at the edges: a band from mel 0, one past the last
    mel, a time band from before the first frame, one past the last, zero
    widths."""
    rows = [(0.0, 2.0, t_count - 1.0, 5.0), (n_mels - 1.0, 4.0, -3.0, 4.0),
            (1.5, 0.0, 0.0, 0.0), (2.0, 1.0, t_count + 2.0, 3.0)]
    return np.array([rows[b % len(rows)] for b in range(batch)], np.float32)


def scratch(rng, batch, t_count, n_mels) -> np.ndarray:
    return (rng.standard_normal((batch, t_count, n_mels)) * 15.0 - 40.0).astype(np.float32)


CASES = [
    # (B, T, n_mels, C, top_db, normalize, masked, resident, threads)
    (2, 9, 10, 4, 80.0, True, True, True, 128),     # n_mels 10 over 4 CTAs: bands 3, 3, 3, 1
    (2, 7, 3, 8, 60.0, True, True, True, 128),      # n_mels < C: five empty bands
    (1, 1, 16, 4, None, True, False, True, 128),    # T = 1
    (4, 13, 12, 2, 20.0, True, True, False, 256),   # re-read, masks at every edge
    (2, 11, 8, 4, None, True, True, True, 256),     # top_db off
    (2, 11, 8, 4, 40.0, False, True, True, 128),    # normalize off
    (2, 11, 8, 2, None, False, False, False, 128),  # neither: the transpose alone
    (1, 1, 1, 1, 80.0, True, False, True, 128),     # n = 1: the ddof guard
    (3, 40, 32, 8, None, True, False, True, 512),   # bands of 4 mels, 16-byte loads
]


@pytest.mark.parametrize("case", CASES)
def test_model_matches_jax_and_reference(rng, case):
    """The model against the JAX epilogue (float32 sums over T x n_mels
    cells: within 2e-5 of the normalized values, |v| < 5, and 1e-5 dB
    without normalize) and against `epilogue_reference` in float64 (the
    model's one float32 rounding of each normalized cell: 2e-6; without
    normalize, top_db's floor in float32 against float64: 1e-5 dB)."""
    batch, t_count, n_mels, cluster, top_db, normalize, masked, resident, threads = case
    db = scratch(rng, batch, t_count, n_mels)
    bounds = edge_bounds(batch, t_count, n_mels) if masked else None
    got = model(db, top_db, normalize, bounds, cluster, resident, threads)
    want = jax_epilogue(db, top_db, normalize, bounds)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5 if normalize else 1e-5)
    ref = mk.epilogue_reference(torch.from_numpy(db).double(), top_db, normalize, EPS,
                                None if bounds is None else torch.from_numpy(bounds)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6 if normalize else 1e-5)


@pytest.mark.parametrize("clusters", [(1, 2), (1, 4), (2, 8), (1, 16)])
def test_the_band_split_moves_no_statistic(rng, clusters):
    """Two cluster sizes over the same scratch agree to float32 rounding:
    the peak is exact; the combined mean and squared deviations differ from
    the one-CTA sums by float64 rounding only (no cell counted twice or
    missed), so the outputs round to within one float32 ulp of |v| < 8."""
    db = scratch(rng, 2, 21, 16)
    bounds = edge_bounds(2, 21, 16)
    a, b = (model(db, 70.0, True, bounds, c, True, 128) for c in clusters)
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def test_epilogue_reference_is_the_plain_chain(rng):
    """`epilogue_reference` on a dB scratch is the plain chain's epilogue:
    the transpose of `log_mel_fused_reference`'s dB, then top_db, the mask
    and normalize as it applies them."""
    x = torch.from_numpy(rng.standard_normal((3, 4000))).double()
    bounds = torch.from_numpy(edge_bounds(3, 16, 128))
    dbt = mk.log_mel_fused_reference(x, 16000, 1024, 256, 128)  # (B, n_mels, T)
    want = mk.log_mel_fused_reference(x, 16000, 1024, 256, 128, top_db=60.0, normalize=True,
                                      spec_mask_bounds=bounds)
    got = mk.epilogue_reference(dbt.transpose(1, 2), 60.0, True, 1e-8, bounds)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("cols, threads", [(1, 128), (3, 128), (16, 256), (32, 512), (129, 128),
                                           (157, 256), (626, 512)])
def test_grid_walk_is_the_divide(cols, threads):
    """The carried walk visits cell i = tid + k threads at (i // cols, i % cols)."""
    for tid in (0, 1, threads - 1):
        walk = grid_walk(cols, threads, tid, 40)
        assert walk == [divmod(tid + k * threads, cols) for k in range(40)]


@pytest.mark.parametrize("band", [1, 2, 3, 8, 16, 32, 64, 128])
def test_the_transposed_read_is_free_of_bank_conflicts(band):
    """A warp's 32 lanes reading one mel of 32 consecutive frames,
    tile[t pitch + c] at the odd pitch band | 1, hit 32 distinct banks; the
    loads' stores (consecutive cells of a frame's band) too."""
    pitch = band | 1
    for c in range(band):
        for t0 in (0, 7, 100):
            banks = [((t0 + lane) * pitch + c) % 32 for lane in range(32)]
            assert len(set(banks)) == 32


SHAPES = {  # chip_smoke.EPILOGUE_SHAPES as (B, T): the plan each takes
    "serving 2048/512": (128, 157, (2, 64, True, 256)),
    "row 1 masked 2048/512": (64, 251, (4, 32, True, 256)),
    "row 2 masked 1024/256": (64, 501, (4, 32, True, 512)),
    "row 3 512/128": (128, 626, (4, 32, True, 512)),
    "row 3 masked 512/128": (64, 1001, (8, 16, True, 512)),
    "analyzer 1024/256": (64, 32, (4, 32, True, 128)),
}


@pytest.mark.parametrize("what", sorted(SHAPES))
def test_plan_at_the_main_shapes(what):
    """The plan phase 19 reads back from the card at its shapes (132 SMs,
    128 mels): (CTAs an example, mels a CTA, resident, threads)."""
    batch, t_count, want = SHAPES[what]
    plan = mk.epilogue_plan(batch, t_count, 128, 132)
    assert (plan["cluster"], plan["band"], plan["resident"], plan["threads"]) == want
    assert plan["smem_bytes"] == t_count * plan["pitch"] * 4


def test_plan_rule():
    """Clusters are powers of two up to 8, 16 only where a band would not fit;
    a band of every frame resident up to 192 KiB, re-read past it (clips over
    ~43 s at hop 128 and 128 mels); the bands cover the mels once."""
    for batch in (1, 3, 64, 128, 2400):
        for t_count in (1, 2, 32, 157, 1001, 5461, 5462, 20000):
            for n_mels in (1, 5, 64, 128):
                plan = mk.epilogue_plan(batch, t_count, n_mels, 132)
                c = plan["cluster"]
                assert c & (c - 1) == 0 and c <= 16 and c <= max(1, n_mels)
                assert plan["band"] == -(-n_mels // c) and plan["pitch"] % 2 == 1
                nbytes = t_count * plan["pitch"] * 4
                assert plan["resident"] == (nbytes <= mk.EPILOGUE_TILE_BYTES)
                if c == 16:
                    assert t_count * ((-(-n_mels // 8)) | 1) * 4 > mk.EPILOGUE_TILE_BYTES
                cols = [min(min(r * plan["band"], n_mels) + plan["band"], n_mels)
                        - min(r * plan["band"], n_mels) for r in range(c)]
                assert sum(cols) == n_mels and min(cols) >= 0
    assert mk.epilogue_plan(64, 5461, 128, 132)["resident"]
    assert not mk.epilogue_plan(64, 5462, 128, 132)["resident"]
