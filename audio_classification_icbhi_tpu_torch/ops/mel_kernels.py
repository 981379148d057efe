"""The log-mel front-end kernels on Hopper, and their one plain version.

Three hand-written CUDA sources replace the seven log-mel TPU kernels of
`audio_classification_icbhi_tpu/ops/pallas_mel.py`, each of which ends in,
or is followed by, the per-example epilogue `_fused_epilogue` (`:683`) or
its top_db / normalize. One wrapper a TPU kernel, with the TPU kernel's
shape contract:

- `log_mel_radix16dif_fused` replaces `_kernel_radix16dif_fused` (`:1270`,
  via `_log_mel_radix16dif_fused` `:1374`); n_fft % 2048 == 0;
- `log_mel_radix8dif_fused` replaces `_kernel_radix8dif_fused` (`:1193`, via
  `:1456`); n_fft % 1024 == 0;
- `log_mel_radix4dif_fused` replaces `_kernel_radix4dif_fused` (`:1037`, via
  `:1111`); n_fft % 512 == 0, hop % 128 == 0;
- `log_mel_radix4_fused` replaces `_kernel_radix4_fused` (`:861`, via `:947`);
  hop % 512 == 0;
- `log_mel_radix2_fused` replaces `_kernel_radix2_fused` (`:723`, via `:783`);
  hop % 256 == 0;
- `log_mel_radix2` replaces `_kernel_radix2` (`:633`, via `_log_mel_radix2`
  `:1542`); any hop, dB only in the TPU package with top_db and normalize
  after it, so no SpecAugment bounds;
- `log_mel_bf16x3` and `log_mel_f32` replace `_kernel_bf16x3` (`:518`) and
  `_kernel_f32` (`:497`), one `pallas_call` in `log_mel_pallas` (`:1681`);
  any n_fft, any hop, dB only with top_db and normalize after it (`:1866`),
  as for radix2.

All eight compute one function, so the source a CUDA tensor runs depends on
n_fft alone (`cuda_route`): `csrc/log_mel_dft_gemm.cu`, a folded real-input
DFT on `wgmma` (TF32, three hi/lo products) fed by a TMA ring, at n_fft % 4
!= 0 (where the JAX policy picks bf16x3), with its constants built once per
(n_fft, device) (`_dft_fold_constants`, 1.08 GB at n_fft 16,383);
`csrc/log_mel_radix8dif.cu` at n_fft 512, 1024, 2048, 4096 and 8192, where it is
the fastest (`chip_smoke.py` phases 16 and 18 time the sources side by side);
`csrc/log_mel_mixed_radix.cu` at every other n_fft, one warp a frame pair
at the n_fft its launch function lists and one block a pair elsewhere, by
staged radix passes in shared memory and Bluestein where the odd factor has
a prime above 7 (`block_plan`; `mixed_radix_occupancy` reports the path on
the card). All take any hop, up to
one limit, `MIXED_RADIX_MAX_N_FFT`; beyond it the CUDA route raises
NotImplementedError naming the algorithm's ROADMAP.md row.

All compute the same function, (B, L) f32 waveform -> (B, n_mels, T) f32
log-mel:

  reflect pad by n_fft/2 -> frame at hop -> periodic Hann -> |rfft|² ->
  mel projection -> 10·log10(max(·, 1e-10)) -> [top_db against the
  example's own peak] -> [SpecAugment mask] -> [normalize: mean, ddof=1 std,
  (x − mean)/(std + eps) over the valid T × n_mels cells].

The fused wrappers have two forms, as the TPU kernels have (`with_masks`):
the inference form, and the training form, which takes per-example
SpecAugment bounds (B, 4) and zeroes those cells between the dB stage and
normalize. Each wrapper counts its forms' launches apart: `launches` and
`launches_masked` (which stays 0 for radix2, bf16x3 and f32: bounds raise);
`log_mel_epilogue.launches` counts the epilogue's launches of every wrapper.
On a CPU tensor every wrapper runs `log_mel_fused_reference`;
`epilogue_reference` is the plain version of the epilogue alone.

Each CUDA source's header note says what bounds its kernel on the card and
what its design does about it; the epilogue kernel (a thread-block cluster
an example, `epilogue_plan`) is `csrc/log_mel_epilogue.cuh`, which all
include. A wrapper allocates the dB
scratch and the output and launches the spectrum kernel and the epilogue on
the current stream: two launches on the radix-8 and mixed-radix sources,
which reflect each edge frame's samples inside the kernel; the DFT GEMM
alone reads a reflect-padded copy that the wrapper gathers first (as the TPU
wrappers do).
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from audio_classification_icbhi_tpu_torch.ops import _build
from audio_classification_icbhi_tpu_torch.ops.augment import mask_from_bounds
from audio_classification_icbhi_tpu_torch.ops import stft as stft_ops
from audio_classification_icbhi_tpu_torch.ops.mel import (
    _FUSED_ALGORITHMS,
    _ROADMAP_ROW,
    _mel_filterbank_np,
    check_dft_passes,
    log_mel_spectrogram,
    normalize_spectrogram,
)

# The TPU kernels' shape contracts (`pallas_mel.py:1380-1388`, `:1462-1471`,
# `:1117-1126`, `:953-960`, `:789-794` with `:1799-1800`, `:1808-1809`):
# algorithm -> (n_fft divisor, d, parts). d: n_fft % hop == 0 and
# (hop // d) % 128 == 0 ("hop_length % 128·d == 0"); None for radix2, which
# takes any hop. parts: (n_fft // parts) % 128 == 0 ("n_fft % 128·parts"), or
# None. bf16x3 and f32 take any n_fft and any hop.
_CONTRACTS = {
    "radix16dif_fused": (16, 1, 16),
    "radix8dif_fused": (8, 1, 8),
    "radix4dif_fused": (8, 1, 4),
    "radix4_fused": (8, 4, None),
    "radix2_fused": (4, 2, None),
    "radix2": (4, None, None),
    "bf16x3": (1, None, None),
    "f32": (1, None, None),
}
# the most shared memory a Hopper block can opt into, in bytes
HOPPER_SMEM_OPTIN = 232_448


def _pow2_radices(length: int) -> list[int]:
    """The radices of a power-of-two length's passes in
    `csrc/log_mel_mixed_radix.cu` (`pow2_passes`), from the whole length
    down: 8 while the span holds 8, then the rest, 2 or 4."""
    eights, rest = divmod(length.bit_length() - 1, 3)
    return [8] * eights + ([1 << rest] if rest else [])


def _odd_factors(m: int) -> list[int]:
    """m's prime factors, the smallest first: the radices of the block
    path's odd passes where all are 3, 5 or 7 (`odd_passes`)."""
    out, f = [], 3
    while m > 1:
        while m % f == 0:
            out.append(f)
            m //= f
        f += 2
    return out


def digit_positions(length: int, radices: list[int]) -> np.ndarray:
    """Where the block path's forward passes of these radices (decimation in
    frequency, in place, the first at the whole length) leave output k: its
    digits in the radices, least significant first, as the position's digits
    most significant first."""
    k = np.arange(length)
    pos = np.zeros(length, dtype=np.int64)
    span = length
    for r in radices:
        span //= r
        pos += (k % r) * span
        k = k // r
    return pos


def _round16(n: int) -> int:
    """Complex values a buffer of n takes: n rounded up to the kernel's
    16-value swizzle groups (`round16`)."""
    return -(-n // 16) * 16


def block_plan(n_fft: int, smem_optin: int = HOPPER_SMEM_OPTIN) -> dict:
    """The plan of `csrc/log_mel_mixed_radix.cu`'s block path for n_fft =
    P * m (its `block_plan`, which `chip_smoke.py` phase 16 reads back on the
    card): P, m, Bluestein's length M (the power of two >= 2m - 1, where m has
    a prime factor above 7; else 0, the staged radix-3/5/7 passes), the
    Bluestein columns a round (all P where the workspace fits), threads a
    block (16 complex values a thread of the pair or a round's workspace,
    whichever is larger), lanes a mel band and dynamic
    shared bytes: the frame pair, then the Bluestein workspace of columns x
    M, each rounded up to 16 complex values."""
    p = n_fft & -n_fft
    m = n_fft // p
    bluestein = 0
    if any(f > 7 for f in _odd_factors(m)):
        bluestein = 1 << (2 * m - 2).bit_length()

    def smem(cols: int) -> int:
        return 8 * (_round16(n_fft) + (_round16(cols * bluestein) if bluestein else 0))

    columns = 1
    if bluestein:
        columns = p
        while columns > 1 and smem(columns) > smem_optin:
            columns //= 2
    lanes = 1
    while lanes < 32 and 512 * lanes <= n_fft:
        lanes *= 2
    work = max(n_fft, columns * bluestein)
    return {"p": p, "m": m, "bluestein": bluestein, "columns": columns,
            "threads": min(1024, max(64, -(-(work // 16) // 32) * 32)),
            "mel_lanes": lanes, "smem_bytes": smem(columns)}


def swizzle(a):
    """The block path's shared-memory slot of complex value a (`swz`): a
    XOR the higher groups of four index bits, within a's group of 16."""
    a = np.asarray(a)
    return a ^ (((a >> 4) ^ (a >> 8) ^ (a >> 12)) & 15)


def mixed_radix_smem_bytes(n_fft: int) -> int:
    """Shared memory a block of `csrc/log_mel_mixed_radix.cu`'s block path
    takes (`block_plan`). Every n_fft the warp path takes needs less a pair
    (8 N bytes)."""
    return block_plan(n_fft)["smem_bytes"]


# the kernels' n_fft limit: the largest power of two whose mixed-radix block
# fits (16,384); the one limit of every log-mel route, the DFT GEMM's too
MIXED_RADIX_MAX_N_FFT = max(1 << k for k in range(32)
                            if mixed_radix_smem_bytes(1 << k) <= HOPPER_SMEM_OPTIN)


def _check_eligible(algorithm: str, n_fft: int, hop_length: int) -> None:
    """The TPU kernels' shape contracts, with their messages, in their order."""
    divisor, d, parts = _CONTRACTS[algorithm]
    if n_fft % divisor:
        raise ValueError(f"{algorithm} requires n_fft divisible by {divisor}")
    if d is None:
        return
    if n_fft % hop_length:
        raise ValueError(f"{algorithm} requires n_fft divisible by hop_length")
    if (hop_length // d) % 128:
        raise ValueError(f"{algorithm} requires hop_length % {128 * d} == 0")
    if parts is not None and (n_fft // parts) % 128:
        raise ValueError(f"{algorithm} requires n_fft % {128 * parts} == 0")


# the n_fft `csrc/log_mel_radix8dif.cu` takes (one template instance each),
# all of which `cuda_route` sends to it: the faster source at each
# (`chip_smoke.py` phase 16 times both)
RADIX8_N_FFT = (512, 1024, 2048, 4096, 8192)


def cuda_route(algorithm: str, n_fft: int) -> str:
    """The CUDA source (stem under csrc/) that a CUDA tensor of this
    algorithm and n_fft runs; NotImplementedError, naming the algorithm's
    ROADMAP.md row, past the kernels' limit."""
    if n_fft > MIXED_RADIX_MAX_N_FFT:
        raise NotImplementedError(
            f"the Hopper {algorithm} kernels take n_fft up to {MIXED_RADIX_MAX_N_FFT} "
            f"(ROADMAP.md {_ROADMAP_ROW[algorithm]}); got n_fft={n_fft}")
    if n_fft % 4:
        return "log_mel_dft_gemm"
    if n_fft in RADIX8_N_FFT:
        return "log_mel_radix8dif"
    return "log_mel_mixed_radix"


def log_mel_fused_reference(
    waveform: torch.Tensor, sample_rate: int, n_fft: int, hop_length: int,
    n_mels: int, *, f_min: float = 0.0, f_max: float | None = None,
    top_db: float | None = None, mel_scale: str = "htk", norm: str | None = None,
    normalize: bool = False, eps: float = 1e-8,
    spec_mask_bounds: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain torch version of every kernel, in the waveform's dtype: framing
    by unfold, window, matmul DFT, power, mel matmul, dB, then the epilogue:
    top_db, the mask of `spec_mask_bounds` (B, 4) if given, normalize."""
    db = log_mel_spectrogram(
        waveform, sample_rate, n_fft, hop_length, n_mels, f_min=f_min,
        f_max=f_max, mel_scale=mel_scale, norm=norm, top_db=top_db)
    if spec_mask_bounds is not None:
        db = mask_from_bounds(db, spec_mask_bounds)
    return normalize_spectrogram(db, eps) if normalize else db


def _check_bounds(bounds: torch.Tensor, waveform: torch.Tensor) -> None:
    if not isinstance(bounds, torch.Tensor) or bounds.dtype != torch.float32:
        raise TypeError("spec_mask_bounds must be a float32 tensor")
    if tuple(bounds.shape) != (waveform.shape[0], 4):
        raise ValueError(f"spec_mask_bounds must be (B, 4) = ({waveform.shape[0]}, 4), "
                         f"got {tuple(bounds.shape)}")
    if bounds.device != waveform.device:
        raise ValueError(f"spec_mask_bounds is on {bounds.device}, the waveform on "
                         f"{waveform.device}")


def _dev(x, dtype, device):
    return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype, device=device)


def _complex_pairs(z: np.ndarray) -> np.ndarray:
    """complex (..., n) -> (..., n, 2) float pairs, the kernels' float2."""
    return np.stack([z.real, z.imag], -1)


@functools.lru_cache(maxsize=16)
def mel_bands(sample_rate: int, n_fft: int, n_mels: int, f_min: float, f_max: float,
              mel_scale: str, norm: str | None, device: torch.device):
    """The banded mel filterbank on `device`, as the kernels take it.

    Each triangular filter is nonzero on a short band of bins, so the
    filterbank travels as per-mel [start, start + len) bin ranges beside
    the packed float32 weights of each band (about two weights per bin):
    (starts (n_mels,) int32, offsets (n_mels + 1,) int32, weights (nnz,)).
    An empty filter (128 HTK mels at n_fft 512 leave one) is an empty band:
    its sum is 0, its dB the floor, as in the plain chain."""
    fb = _mel_filterbank_np(sample_rate, n_fft, n_mels, f_min, f_max, mel_scale, norm)
    starts, offsets, weights = [], [0], []
    for m in range(n_mels):
        nz = np.flatnonzero(fb[:, m])
        lo, hi = (int(nz[0]), int(nz[-1]) + 1) if nz.size else (0, 0)
        starts.append(lo)
        weights.append(fb[lo:hi, m])
        offsets.append(offsets[-1] + hi - lo)
    return (_dev(starts, torch.int32, device), _dev(offsets, torch.int32, device),
            _dev(np.concatenate(weights), torch.float32, device))


@functools.lru_cache(maxsize=16)
def mel_bin_table(sample_rate: int, n_fft: int, n_mels: int, f_min: float, f_max: float,
                  mel_scale: str, norm: str | None, device: torch.device) -> torch.Tensor:
    """The mel filterbank by bin, as `csrc/log_mel_dft_gemm.cu` takes it:
    (bins padded to its tile, 4) int32, each bin's (even mel, its weight's
    float32 bits, odd mel, its weight's bits), -1 and 0 where the bin lies in
    no band of that parity. A triangular filter overlaps only its
    neighbours, so a bin lies in at most one band of each parity; a
    filterbank where it does not raises."""
    fb = _mel_filterbank_np(sample_rate, n_fft, n_mels, f_min, f_max, mel_scale, norm)
    table = np.zeros((dft_fold_geometry(n_fft)[2], 4), dtype=np.int32)
    table[:, 0::2] = -1
    for k, m in zip(*np.nonzero(fb)):
        slot = 2 * (m % 2)
        if table[k, slot] >= 0:
            raise ValueError(f"bin {k} lies in two mel bands of one parity ({table[k, slot]} "
                             f"and {m}): the DFT GEMM kernel takes triangular filterbanks")
        table[k, slot] = m
        table[k, slot + 1] = np.float32(fb[k, m]).view(np.int32)
    return _dev(table, torch.int32, device)


@functools.lru_cache(maxsize=8)
def _twiddles_radix8dif(n_fft: int, device: torch.device) -> tuple[torch.Tensor, ...]:
    """Window; the class twiddles W_N^{rn} as (4, E) for r = 1..4, n < E;
    and the E-point FFT's stage twiddles W_{2h}^j for h = 1, 2, .., E/2,
    j < h, packed at [h - 1 + j] (E - 1 in all). Built in float64."""
    e = n_fft // 8
    n = np.arange(e)
    rn = np.exp(-2j * np.pi * np.outer(np.arange(1, 5), n) / n_fft)
    stages = np.concatenate([np.exp(-2j * np.pi * np.arange(h) / (2 * h))
                             for h in (1 << np.arange(e.bit_length() - 1))])
    return (stft_ops.hann_window(n_fft, dtype=torch.float32, device=device),
            _dev(_complex_pairs(rn), torch.float32, device),
            _dev(_complex_pairs(stages), torch.float32, device))


@functools.lru_cache(maxsize=8)
def _twiddles_mixed_radix(n_fft: int, device: torch.device) -> tuple[torch.Tensor, ...]:
    """`csrc/log_mel_mixed_radix.cu`'s window and the warp path's constants
    of n_fft = P * m (P its largest power-of-two factor), built in float64:
    the P-point FFT's stage twiddles W_{2h}^j at [h - 1 + j] (P - 1),
    W_N^{r k0} as (m - 1, P) for r = 1 .. m - 1, and W_m^j (m). The block
    path computes its twiddles (`_block_tables` has its tables)."""
    p = n_fft & -n_fft
    m = n_fft // p
    stages = np.concatenate([np.exp(-2j * np.pi * np.arange(h) / (2 * h))
                             for h in (1 << np.arange(p.bit_length() - 1))])
    tables = (stages, np.exp(-2j * np.pi * np.outer(np.arange(1, m), np.arange(p)) / n_fft),
              np.exp(-2j * np.pi * np.arange(m) / m))
    return (stft_ops.hann_window(n_fft, dtype=torch.float32, device=device),
            *(_dev(_complex_pairs(t), torch.float32, device) for t in tables))


@functools.lru_cache(maxsize=8)
def _block_tables(n_fft: int, device: torch.device) -> tuple[torch.Tensor | None, ...]:
    """The block path's index tables and Bluestein constants for n_fft = P *
    m (`block_plan`), the constants built in float64: col_bin, the row bin
    at each position of a row after the row passes (P int32); bin_slot, the
    swizzled slot where Z[k] ends (N int32): row_pos[k // P] + m
    col_pos[k % P], col_pos where the row passes leave row bin k0 and row_pos
    where the odd passes leave output q (q itself under Bluestein); then,
    where m has a prime factor above 7, the chirp w_n = exp(-i pi (n^2 mod
    2m) / m) (m) and DFT_M of the conjugate chirp (b_n = conj w_|n| at n mod
    M for |n| < m) over M, at the forward passes' positions (M); None
    elsewhere."""
    plan = block_plan(n_fft)
    p, m, big_m = plan["p"], plan["m"], plan["bluestein"]
    col_pos = digit_positions(p, _pow2_radices(p))
    row_pos = np.arange(m) if big_m else digit_positions(m, _odd_factors(m))
    k = np.arange(n_fft)
    tables = [_dev(np.argsort(col_pos), torch.int32, device),
              _dev(swizzle(row_pos[k // p] + m * col_pos[k % p]), torch.int32, device)]
    if not big_m:
        return (*tables, None, None)
    n = np.arange(m, dtype=np.int64)
    chirp = np.exp(-1j * np.pi * ((n * n) % (2 * m)) / m)
    b = np.zeros(big_m, complex)
    b[:m] = np.conj(chirp)
    b[big_m - m + 1:] = np.conj(chirp[1:][::-1])
    hat = np.empty(big_m, complex)
    hat[digit_positions(big_m, _pow2_radices(big_m))] = np.fft.fft(b) / big_m
    return (*tables, *(_dev(_complex_pairs(t), torch.float32, device) for t in (chirp, hat)))


# `csrc/log_mel_dft_gemm.cu`'s tiles: folded samples a TMA box row (128
# bytes), bins a wgmma (its N) and frame rows a block
DFT_K_CHUNK, DFT_BIN_TILE, DFT_TILE_ROWS = 32, 72, 128


def dft_fold_geometry(n_fft: int) -> tuple[int, int, int]:
    """(K, K padded, bins padded) of the folded DFT: K = n_fft // 2 folded
    samples (n = 1 .. K) padded to the 32-float TMA box row, and n_fft // 2 + 1
    bins padded to the 72-bin tile."""
    k = n_fft // 2
    return (k, -(-k // DFT_K_CHUNK) * DFT_K_CHUNK,
            -(-(n_fft // 2 + 1) // DFT_BIN_TILE) * DFT_BIN_TILE)


def dft_fold_matrices(n_fft: int, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The folded real DFT's windowed cos and sin matrices, (n_fft // 2 + 1
    bins, K) float64, K = n_fft // 2: C[k, n - 1] = c_n w_n cos(2π ((n k)
    mod N) / N) and S[k, n - 1] = w_n sin(2π ((n k) mod N) / N) for n = 1 ..
    K, w the periodic Hann window, c_n = 1/2 for the even-N middle sample
    n = N / 2 (its fold x_n + x_{N-n} counts it twice) and 1 otherwise. With
    s_n = x_n + x_{N-n} and d_n = x_n - x_{N-n}, Re X = s C^T and Im X =
    -d S^T (`csrc/log_mel_dft_gemm.cu`'s header derives it)."""
    k_half = n_fft // 2
    n = torch.arange(1, k_half + 1, dtype=torch.int64, device=device)
    bins = torch.arange(n_fft // 2 + 1, dtype=torch.int64, device=device)
    angle = (2.0 * math.pi / n_fft) * ((bins[:, None] * n[None, :]) % n_fft).double()
    w = 0.5 - 0.5 * torch.cos((2.0 * math.pi / n_fft) * n.double())
    c = torch.where(2 * n == n_fft, 0.5, 1.0).double() * w
    return c * torch.cos(angle), w * torch.sin(angle)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to TF32 (10 mantissa bits, the 13 low bits zero), to
    nearest with ties away from zero: the kernels' `to_tf32`."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


@functools.lru_cache(maxsize=4)
def _dft_fold_constants(n_fft: int, device: torch.device) -> torch.Tensor:
    """`csrc/log_mel_dft_gemm.cu`'s constant operand, (4, bins padded, K
    padded) float32: C_hi, C_lo, S_hi, S_lo, K-major, zero in the padding.
    Built on `device` in float64 (`dft_fold_matrices`) and split into TF32
    hi = tf32(m) and lo = tf32(m - hi): 4.1 MB at n_fft 1001, 1.08 GB at
    16,383."""
    k_half, k_pad, bins_pad = dft_fold_geometry(n_fft)
    out = torch.zeros((4, bins_pad, k_pad), dtype=torch.float32, device=device)
    for i, m in enumerate(dft_fold_matrices(n_fft, device)):
        hi = tf32_round(m.float())
        out[2 * i, :m.shape[0], :k_half] = hi
        out[2 * i + 1, :m.shape[0], :k_half] = tf32_round((m - hi.double()).float())
    return out


def _log_mel_fused(wrapper, algorithm: str, waveform: torch.Tensor, sample_rate: int,
                   n_fft: int, hop_length: int, n_mels: int, *, f_min: float,
                   f_max: float | None, top_db: float | None, mel_scale: str,
                   norm: str | None, normalize: bool, eps: float, dft_passes: int | None,
                   spec_mask_bounds: torch.Tensor | None) -> torch.Tensor:
    """What every wrapper shares: the JAX dispatcher's checks in its order
    (`pallas_mel.py:1734-1755`, then the shape contract), the CPU route to
    the plain version, the launch of `cuda_route`'s source and the launch
    counts (on `wrapper`)."""
    if spec_mask_bounds is not None and algorithm not in _FUSED_ALGORITHMS:
        raise ValueError("spec_mask_bounds requires a fused algorithm")
    check_dft_passes(dft_passes)
    if dft_passes is not None and dft_passes >= 5 and algorithm not in (
            "radix8dif_fused", "radix16dif_fused"):
        raise ValueError(
            f"dft_passes={dft_passes} (3-way split) requires radix8dif_fused"
            f" or radix16dif_fused, got {algorithm}")
    _check_eligible(algorithm, n_fft, hop_length)
    if waveform.dim() != 2:
        raise ValueError(f"waveform must be (B, L), got shape {tuple(waveform.shape)}")
    if spec_mask_bounds is not None:
        _check_bounds(spec_mask_bounds, waveform)
    if waveform.device.type == "cpu":
        return log_mel_fused_reference(
            waveform, sample_rate, n_fft, hop_length, n_mels, f_min=f_min, f_max=f_max,
            top_db=top_db, mel_scale=mel_scale, norm=norm, normalize=normalize, eps=eps,
            spec_mask_bounds=spec_mask_bounds)
    if not waveform.is_cuda:
        raise ValueError(f"unsupported device {waveform.device}")
    if waveform.dtype != torch.float32:
        raise TypeError(f"waveform must be float32, got {waveform.dtype}")
    if not waveform.is_contiguous():
        raise ValueError("waveform must be contiguous")
    out = run_source(cuda_route(algorithm, n_fft), waveform, sample_rate, n_fft, hop_length,
                     n_mels, f_min=f_min, f_max=f_max, top_db=top_db, mel_scale=mel_scale,
                     norm=norm, normalize=normalize, eps=eps, spec_mask_bounds=spec_mask_bounds,
                     epilogue=log_mel_epilogue)
    if spec_mask_bounds is None:
        wrapper.launches += 1
    else:
        wrapper.launches_masked += 1
    return out


def run_source(source: str, waveform: torch.Tensor, sample_rate: int, n_fft: int,
               hop_length: int, n_mels: int, *, f_min: float, f_max: float | None,
               top_db: float | None, mel_scale: str, norm: str | None, normalize: bool,
               eps: float, spec_mask_bounds: torch.Tensor | None,
               epilogue=None) -> torch.Tensor:
    """Launch CUDA source `source`'s spectrum kernel and the epilogue on a
    checked, contiguous (B, L) float32 CUDA waveform. The wrappers run
    `cuda_route`'s source through it with `epilogue=log_mel_epilogue`, which
    counts the epilogue's launch; by default (`epilogue_only`) it counts
    nothing, as `chip_smoke.py` times each source at the same shape."""
    b, length = waveform.shape
    t = stft_ops.num_frames(length, n_fft, hop_length)
    db = torch.empty((b, t, n_mels), dtype=torch.float32, device=waveform.device)
    out = torch.empty((b, n_mels, t), dtype=torch.float32, device=waveform.device)
    spectrum_only(source, waveform, sample_rate, n_fft, hop_length, n_mels, db, f_min=f_min,
                  f_max=f_max, mel_scale=mel_scale, norm=norm)
    (epilogue or epilogue_only)(source, db, out, top_db=top_db, normalize=normalize, eps=eps,
                                spec_mask_bounds=spec_mask_bounds)
    return out


def epilogue_reference(db: torch.Tensor, top_db: float | None = None, normalize: bool = False,
                       eps: float = 1e-8, bounds: torch.Tensor | None = None) -> torch.Tensor:
    """Plain torch version of the epilogue alone (`csrc/log_mel_epilogue.cuh`,
    `_fused_epilogue` of the JAX package), in db's dtype: the (B, T, n_mels)
    dB scratch -> top_db against each example's peak (before the mask) ->
    the SpecAugment mask of (B, 4) `bounds` -> normalize -> (B, n_mels, T)."""
    x = db.transpose(1, 2)
    if top_db is not None:
        x = torch.maximum(x, torch.amax(x, dim=(1, 2), keepdim=True) - top_db)
    if bounds is not None:
        x = mask_from_bounds(x, bounds)
    return normalize_spectrogram(x, eps) if normalize else x.contiguous()


# the most shared memory an epilogue CTA's band may take (`kEpilogueTileBytes`)
EPILOGUE_TILE_BYTES = 196_608


def epilogue_plan(batch: int, n_frames: int, n_mels: int, sms: int = 132) -> dict:
    """The launch shape `csrc/log_mel_epilogue.cuh` picks for a call (its
    `epilogue_plan`; `chip_smoke.py` reads the card's back and compares):
    CTAs an example (the cluster, a power of two: the smallest that puts a
    CTA on each SM over the batch, doubled up to 8 while a CTA's band takes
    more than half of the 192 KiB tile budget, then up to 16 while it takes
    more than all of it, never past n_mels), mels a CTA (its band of every
    frame), the shared row pitch (the band | 1), whether the band is
    resident in shared memory, its bytes, and threads a CTA (128, 256 or
    512 by the band's cells: about 16 to 48 a thread)."""
    def band(c):
        return -(-n_mels // c)

    def nbytes(c):
        return n_frames * (band(c) | 1) * 4

    c = 1
    while c < 8 and batch * c < sms and 2 * c <= n_mels:
        c *= 2
    while c < 8 and nbytes(c) > EPILOGUE_TILE_BYTES // 2 and 2 * c <= n_mels:
        c *= 2
    while c < 16 and nbytes(c) > EPILOGUE_TILE_BYTES and 2 * c <= n_mels:
        c *= 2
    resident = nbytes(c) <= EPILOGUE_TILE_BYTES
    cells = n_frames * band(c)
    return {"cluster": c, "band": band(c), "pitch": band(c) | 1, "resident": resident,
            "smem_bytes": nbytes(c) if resident else 0,
            "threads": 128 if cells < 2048 else 256 if cells < 12288 else 512}


def epilogue_device_plan(batch: int, n_frames: int, n_mels: int, device_index: int) -> dict:
    """The epilogue's plan of a call as the card's library computes it
    (`log_mel_epilogue_plan`): cluster, band, resident, shared bytes, threads."""
    lib = _build.load("log_mel_mixed_radix")
    out = (ctypes.c_int * 5)()
    _build.launch(lib, lib.log_mel_epilogue_plan, device_index, batch, n_frames, n_mels, out)
    cluster, band, resident, smem, threads = out
    return {"cluster": cluster, "band": band, "resident": bool(resident), "smem_bytes": smem,
            "threads": threads}


def epilogue_only(source: str, db: torch.Tensor, out: torch.Tensor, *, top_db: float | None,
                  normalize: bool, eps: float,
                  spec_mask_bounds: torch.Tensor | None = None) -> None:
    """The second half of `run_source`: the epilogue kernel of CUDA source
    `source`'s library on a (B, T, n_mels) float32 dB scratch into the (B,
    n_mels, T) `out`, both preallocated on the card, counted nowhere
    (`chip_smoke.py` times it alone)."""
    b, t, n_mels = db.shape
    if tuple(out.shape) != (b, n_mels, t) or not (db.is_contiguous() and out.is_contiguous()):
        raise ValueError(f"epilogue buffers {tuple(db.shape)} -> {tuple(out.shape)}")
    lib = _build.load(source)
    device = db.device
    stream = torch.cuda.current_stream(device).cuda_stream
    dev_index = device.index if device.index is not None else torch.cuda.current_device()
    bounds = None if spec_mask_bounds is None else spec_mask_bounds.contiguous()
    _build.launch(lib, lib.log_mel_epilogue_launch, dev_index, db.data_ptr(), b, t, n_mels,
                  int(top_db is not None), 0.0 if top_db is None else float(top_db),
                  int(normalize), float(eps), None if bounds is None else bounds.data_ptr(),
                  out.data_ptr(), stream)


def log_mel_epilogue(source: str, db: torch.Tensor, out: torch.Tensor, *, top_db: float | None,
                     normalize: bool, eps: float,
                     spec_mask_bounds: torch.Tensor | None = None) -> None:
    """The epilogue as every log-mel wrapper launches it after its spectrum
    kernel: `epilogue_only`, counted in `log_mel_epilogue.launches`."""
    epilogue_only(source, db, out, top_db=top_db, normalize=normalize, eps=eps,
                  spec_mask_bounds=spec_mask_bounds)
    log_mel_epilogue.launches += 1


log_mel_epilogue.launches = 0


def spectrum_only(source: str, waveform: torch.Tensor, sample_rate: int, n_fft: int,
                  hop_length: int, n_mels: int, db: torch.Tensor, *, f_min: float = 0.0,
                  f_max: float | None = None, mel_scale: str = "htk", norm: str | None = None):
    """The first half of `run_source`: source `source`'s spectrum pass of a
    (B, L) float32 CUDA waveform into the (B, T, n_mels) dB scratch `db`,
    counted nowhere (`chip_smoke.py` times it alone on preallocated
    buffers). The radix-8 and mixed-radix sources reflect inside the
    kernel; the DFT GEMM reads the wrapper's reflect-padded copy."""
    device = waveform.device
    filterbank = (sample_rate, n_fft, n_mels, float(f_min),
                  sample_rate / 2.0 if f_max is None else float(f_max), mel_scale, norm, device)
    lib = _build.load(source)
    stream = torch.cuda.current_stream(device).cuda_stream
    dev_index = device.index if device.index is not None else torch.cuda.current_device()
    _SPECTRA[source](lib, dev_index, waveform, n_fft, hop_length, db.shape[1], filterbank, db,
                     stream)


@functools.lru_cache(maxsize=16)
def mixed_radix_occupancy(n_fft: int, device_index: int) -> dict:
    """The launch shape of n_fft on `csrc/log_mel_mixed_radix.cu` on a CUDA
    device, from its `log_mel_mixed_radix_occupancy`: path ("block",
    "registers", "shared"), warps a block, blocks an SM, warps an SM,
    registers a thread, shared bytes a block; on the block path also
    Bluestein's length M (0: staged radix-3/5/7 passes) and its columns a
    round (`block_plan`)."""
    lib = _build.load("log_mel_mixed_radix")
    out = (ctypes.c_int * 7)()
    _build.launch(lib, lib.log_mel_mixed_radix_occupancy, device_index, n_fft, out)
    path, warps, blocks, regs, smem, bluestein, columns = out
    return {"path": ("block", "registers", "shared")[path], "warps_per_block": warps,
            "blocks_per_sm": blocks, "warps_per_sm": warps * blocks, "registers": regs,
            "smem_bytes": smem, "bluestein": bluestein, "columns": columns}


@functools.lru_cache(maxsize=16)
def radix8_occupancy(n_fft: int, device_index: int) -> dict[str, int]:
    """The launch shape of `csrc/log_mel_radix8dif.cu`'s n_fft instance on a
    CUDA device, from its `log_mel_radix8dif_occupancy`: warps a block,
    blocks an SM, warps an SM, registers a thread, shared bytes a block."""
    lib = _build.load("log_mel_radix8dif")
    out = (ctypes.c_int * 4)()
    _build.launch(lib, lib.log_mel_radix8dif_occupancy, device_index, n_fft, out)
    warps, blocks, regs, smem = out
    return {"warps_per_block": warps, "blocks_per_sm": blocks, "warps_per_sm": warps * blocks,
            "registers": regs, "smem_bytes": smem}


def log_mel_radix16dif_fused(
    waveform: torch.Tensor, sample_rate: int, n_fft: int, hop_length: int,
    n_mels: int, *, f_min: float = 0.0, f_max: float | None = None,
    top_db: float | None = None, mel_scale: str = "htk", norm: str | None = None,
    normalize: bool = False, eps: float = 1e-8, dft_passes: int | None = None,
    spec_mask_bounds: torch.Tensor | None = None,
) -> torch.Tensor:
    """(B, L) f32 waveform -> (B, n_mels, T) f32 log-mel, for n_fft % 2048
    == 0 (`csrc/log_mel_radix8dif.cu` at 2048/4096/8192, as config.yaml's
    2048/512; other n_fft on `csrc/log_mel_mixed_radix.cu`).

    A CUDA tensor launches the hand-written kernel, or raises; a CPU tensor
    runs the plain version. `spec_mask_bounds`, a (B, 4) float32 tensor on
    the waveform's device, selects the training form. `dft_passes` is
    checked as in the JAX package and otherwise ignored: the kernel runs its
    FFT and mel projection in float32, at least as accurate as every bf16
    pass budget of the TPU kernel.
    """
    return _log_mel_fused(
        log_mel_radix16dif_fused, "radix16dif_fused", waveform, sample_rate, n_fft,
        hop_length, n_mels, f_min=f_min, f_max=f_max, top_db=top_db, mel_scale=mel_scale,
        norm=norm, normalize=normalize, eps=eps, dft_passes=dft_passes,
        spec_mask_bounds=spec_mask_bounds)


def log_mel_radix8dif_fused(
    waveform: torch.Tensor, sample_rate: int, n_fft: int, hop_length: int,
    n_mels: int, *, f_min: float = 0.0, f_max: float | None = None,
    top_db: float | None = None, mel_scale: str = "htk", norm: str | None = None,
    normalize: bool = False, eps: float = 1e-8, dft_passes: int | None = None,
    spec_mask_bounds: torch.Tensor | None = None,
) -> torch.Tensor:
    """(B, L) f32 waveform -> (B, n_mels, T) f32 log-mel, for n_fft % 1024
    == 0 (`csrc/log_mel_radix8dif.cu` at the powers of two from 1024 to
    8192; other n_fft on `csrc/log_mel_mixed_radix.cu`): the same function
    and the same two forms as `log_mel_radix16dif_fused`. The analyzer's
    sub-second windows (n_fft 1024, hop 256) run it.
    """
    return _log_mel_fused(
        log_mel_radix8dif_fused, "radix8dif_fused", waveform, sample_rate, n_fft,
        hop_length, n_mels, f_min=f_min, f_max=f_max, top_db=top_db, mel_scale=mel_scale,
        norm=norm, normalize=normalize, eps=eps, dft_passes=dft_passes,
        spec_mask_bounds=spec_mask_bounds)


def log_mel_radix4dif_fused(
    waveform: torch.Tensor, sample_rate: int, n_fft: int, hop_length: int,
    n_mels: int, *, f_min: float = 0.0, f_max: float | None = None,
    top_db: float | None = None, mel_scale: str = "htk", norm: str | None = None,
    normalize: bool = False, eps: float = 1e-8, dft_passes: int | None = None,
    spec_mask_bounds: torch.Tensor | None = None,
) -> torch.Tensor:
    """(B, L) f32 waveform -> (B, n_mels, T) f32 log-mel, for n_fft % 512
    == 0 and hop % 128 == 0 (`csrc/log_mel_radix8dif.cu` at the powers of
    two from 512 to 8192, `csrc/log_mel_mixed_radix.cu` at 1536 and the other
    n_fft): the same
    function and two forms as `log_mel_radix16dif_fused`. A 512/128
    checkpoint and the analyzer's 0.064 s windows run it. `dft_passes` 5 and
    6 raise, as in the JAX package (its 3-way split exists only for the
    radix-8/16 kernels); 3 and 4 are checked and ignored.
    """
    return _log_mel_fused(
        log_mel_radix4dif_fused, "radix4dif_fused", waveform, sample_rate, n_fft,
        hop_length, n_mels, f_min=f_min, f_max=f_max, top_db=top_db, mel_scale=mel_scale,
        norm=norm, normalize=normalize, eps=eps, dft_passes=dft_passes,
        spec_mask_bounds=spec_mask_bounds)


def log_mel_radix4_fused(
    waveform: torch.Tensor, sample_rate: int, n_fft: int, hop_length: int,
    n_mels: int, *, f_min: float = 0.0, f_max: float | None = None,
    top_db: float | None = None, mel_scale: str = "htk", norm: str | None = None,
    normalize: bool = False, eps: float = 1e-8, dft_passes: int | None = None,
    spec_mask_bounds: torch.Tensor | None = None,
) -> torch.Tensor:
    """(B, L) f32 waveform -> (B, n_mels, T) f32 log-mel, for n_fft % 8 ==
    0 and hop % 512 == 0 (the source `cuda_route` picks by n_fft), both
    forms. Only an explicit `pallas_algorithm="radix4_fused"` reaches it,
    at 2048/512 on `csrc/log_mel_radix8dif.cu`. The TPU
    kernel's `group` of examples a grid cell has no counterpart here.
    """
    return _log_mel_fused(
        log_mel_radix4_fused, "radix4_fused", waveform, sample_rate, n_fft,
        hop_length, n_mels, f_min=f_min, f_max=f_max, top_db=top_db, mel_scale=mel_scale,
        norm=norm, normalize=normalize, eps=eps, dft_passes=dft_passes,
        spec_mask_bounds=spec_mask_bounds)


def log_mel_radix2_fused(
    waveform: torch.Tensor, sample_rate: int, n_fft: int, hop_length: int,
    n_mels: int, *, f_min: float = 0.0, f_max: float | None = None,
    top_db: float | None = None, mel_scale: str = "htk", norm: str | None = None,
    normalize: bool = False, eps: float = 1e-8, dft_passes: int | None = None,
    spec_mask_bounds: torch.Tensor | None = None,
) -> torch.Tensor:
    """(B, L) f32 waveform -> (B, n_mels, T) f32 log-mel, for n_fft % 4 ==
    0 and hop % 256 == 0 (the source `cuda_route` picks by n_fft), both
    forms. A 768/256 or 1280/256 checkpoint runs it, on
    `csrc/log_mel_mixed_radix.cu`.
    """
    return _log_mel_fused(
        log_mel_radix2_fused, "radix2_fused", waveform, sample_rate, n_fft,
        hop_length, n_mels, f_min=f_min, f_max=f_max, top_db=top_db, mel_scale=mel_scale,
        norm=norm, normalize=normalize, eps=eps, dft_passes=dft_passes,
        spec_mask_bounds=spec_mask_bounds)


def log_mel_radix2(
    waveform: torch.Tensor, sample_rate: int, n_fft: int, hop_length: int,
    n_mels: int, *, f_min: float = 0.0, f_max: float | None = None,
    top_db: float | None = None, mel_scale: str = "htk", norm: str | None = None,
    normalize: bool = False, eps: float = 1e-8, dft_passes: int | None = None,
    spec_mask_bounds: torch.Tensor | None = None,
) -> torch.Tensor:
    """(B, L) f32 waveform -> (B, n_mels, T) f32 log-mel, for n_fft % 4 ==
    0 and any hop (the source `cuda_route` picks by n_fft; at 800/200 and
    400/160 `csrc/log_mel_mixed_radix.cu`): dB, then top_db and
    normalize, as the JAX package runs them after its kernel
    (`pallas_mel.py:1807-1814`). Only backend "pallas" reaches it.
    `spec_mask_bounds` raises: the TPU kernel has no training form.
    """
    return _log_mel_fused(
        log_mel_radix2, "radix2", waveform, sample_rate, n_fft,
        hop_length, n_mels, f_min=f_min, f_max=f_max, top_db=top_db, mel_scale=mel_scale,
        norm=norm, normalize=normalize, eps=eps, dft_passes=dft_passes,
        spec_mask_bounds=spec_mask_bounds)


def log_mel_bf16x3(
    waveform: torch.Tensor, sample_rate: int, n_fft: int, hop_length: int,
    n_mels: int, *, f_min: float = 0.0, f_max: float | None = None,
    top_db: float | None = None, mel_scale: str = "htk", norm: str | None = None,
    normalize: bool = False, eps: float = 1e-8, dft_passes: int | None = None,
    spec_mask_bounds: torch.Tensor | None = None,
) -> torch.Tensor:
    """(B, L) f32 waveform -> (B, n_mels, T) f32 log-mel at any n_fft and
    hop: dB, then top_db and normalize, as the JAX package runs them after
    `_kernel_bf16x3` (`pallas_mel.py:1866`). Backend "pallas" reaches it at
    every n_fft % 4 != 0 (1001/250, 1022/511, 2050/512), which runs
    `csrc/log_mel_dft_gemm.cu`: the folded real DFT (K = n_fft // 2) as three
    TF32 `wgmma` products on hi/lo-split operands, the constants fed by TMA;
    named, at other n_fft, the source `cuda_route` picks. `spec_mask_bounds`
    raises, and `dft_passes` 5 and 6 raise, as in the JAX package; 3 and 4 are
    checked and ignored: the TPU's bf16 hi/lo split becomes a TF32 one that
    meets the f32 budget.
    """
    return _log_mel_fused(
        log_mel_bf16x3, "bf16x3", waveform, sample_rate, n_fft,
        hop_length, n_mels, f_min=f_min, f_max=f_max, top_db=top_db, mel_scale=mel_scale,
        norm=norm, normalize=normalize, eps=eps, dft_passes=dft_passes,
        spec_mask_bounds=spec_mask_bounds)


def log_mel_f32(
    waveform: torch.Tensor, sample_rate: int, n_fft: int, hop_length: int,
    n_mels: int, *, f_min: float = 0.0, f_max: float | None = None,
    top_db: float | None = None, mel_scale: str = "htk", norm: str | None = None,
    normalize: bool = False, eps: float = 1e-8, dft_passes: int | None = None,
    spec_mask_bounds: torch.Tensor | None = None,
) -> torch.Tensor:
    """The same function as `log_mel_bf16x3`, for `_kernel_f32` (`:497`),
    which runs its DFT at f32 precision on the TPU. Only naming it
    (`pallas_algorithm="f32"`) reaches it; it runs the same sources.
    """
    return _log_mel_fused(
        log_mel_f32, "f32", waveform, sample_rate, n_fft,
        hop_length, n_mels, f_min=f_min, f_max=f_max, top_db=top_db, mel_scale=mel_scale,
        norm=norm, normalize=normalize, eps=eps, dft_passes=dft_passes,
        spec_mask_bounds=spec_mask_bounds)


def _spectrum_radix8dif(lib, dev_index, x, n_fft, hop, t, filterbank, db, stream) -> None:
    window, twiddle_rn, twiddle_fft = _twiddles_radix8dif(n_fft, x.device)
    mel_start, mel_offset, mel_weight = mel_bands(*filterbank)
    _build.launch(lib, lib.log_mel_radix8dif_launch, dev_index, x.data_ptr(), x.shape[0],
            x.shape[1], n_fft, hop, t, window.data_ptr(), twiddle_rn.data_ptr(),
            twiddle_fft.data_ptr(), mel_start.data_ptr(), mel_offset.data_ptr(),
            mel_weight.data_ptr(), mel_start.numel(), db.data_ptr(), stream)


def _spectrum_mixed_radix(lib, dev_index, x, n_fft, hop, t, filterbank, db, stream) -> None:
    # window, then both paths' twiddles, then the block path's tables
    tables = _twiddles_mixed_radix(n_fft, x.device) + _block_tables(n_fft, x.device)
    mel_start, mel_offset, mel_weight = mel_bands(*filterbank)
    _build.launch(lib, lib.log_mel_mixed_radix_launch, dev_index, x.data_ptr(), x.shape[0],
            x.shape[1], n_fft, hop, t,
            *(None if table is None else table.data_ptr() for table in tables),
            mel_start.data_ptr(), mel_offset.data_ptr(), mel_weight.data_ptr(),
            mel_start.numel(), db.data_ptr(), stream)


def dft_fold_splits(n_rows: int, bin_tiles: int, sms: int) -> int:
    """The blocks that share a 128-frame row tile of `csrc/log_mel_dft_gemm.cu`,
    each taking a contiguous half of its bin tiles: 2 where that leaves fewer
    SMs idle in the last wave (one block an SM), else 1. At 1001/250, 128
    clips of 5 s: 321 row tiles fill 2.43 waves of 132 SMs, as 642 halves 4.86."""
    tiles = -(-n_rows // DFT_TILE_ROWS)

    def waves(splits: int) -> float:
        return -(-tiles * splits // sms) / splits

    return 2 if bin_tiles >= 2 and waves(2) < waves(1) else 1


def _spectrum_dft_fold(lib, dev_index, x, n_fft, hop, t, filterbank, db, stream) -> None:
    x = stft_ops.reflect_pad(x, n_fft // 2)
    consts = _dft_fold_constants(n_fft, x.device)
    table = mel_bin_table(*filterbank)
    splits = dft_fold_splits(db.shape[0] * t, consts.shape[1] // DFT_BIN_TILE,
                             torch.cuda.get_device_properties(x.device).multi_processor_count)
    partial = torch.empty_like(db) if splits == 2 else None
    _build.launch(lib, lib.log_mel_dft_gemm_launch, dev_index, x.data_ptr(), x.shape[0],
            x.shape[1], n_fft, hop, t, consts.data_ptr(), consts.shape[2], consts.shape[1],
            table.data_ptr(), filterbank[2], db.data_ptr(), splits,
            None if partial is None else partial.data_ptr(), stream)


# CUDA source -> its spectrum launch
_SPECTRA = {
    "log_mel_radix8dif": _spectrum_radix8dif,
    "log_mel_mixed_radix": _spectrum_mixed_radix,
    "log_mel_dft_gemm": _spectrum_dft_fold,
}
# the wrapper of each algorithm, and the launch counts of each: the inference
# form, and the training form (SpecAugment bounds; only the fused algorithms)
WRAPPERS = {
    "radix16dif_fused": log_mel_radix16dif_fused,
    "radix8dif_fused": log_mel_radix8dif_fused,
    "radix4dif_fused": log_mel_radix4dif_fused,
    "radix4_fused": log_mel_radix4_fused,
    "radix2_fused": log_mel_radix2_fused,
    "radix2": log_mel_radix2,
    "bf16x3": log_mel_bf16x3,
    "f32": log_mel_f32,
}
for _fn in WRAPPERS.values():
    _fn.launches = 0
    _fn.launches_masked = 0

# ctypes signatures of the C entry points in csrc/*.cu
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_EPILOGUE = [_I, _P, _I, _I, _I, _I, _F, _I, _F, _P, _P, _P]
_build.declare("log_mel_radix8dif", {
    "log_mel_radix8dif_launch": [_I, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P,
                                 _I, _P, _P],
    "log_mel_radix8dif_occupancy": [_I, _I, _P],
    "log_mel_epilogue_launch": _EPILOGUE,
})
_build.declare("log_mel_mixed_radix", {
    "log_mel_mixed_radix_launch": [_I, _P, _I, _I, _I, _I, _I, *[_P] * 11, _I, _P, _P],
    "log_mel_mixed_radix_occupancy": [_I, _I, _P],
    "log_mel_epilogue_launch": _EPILOGUE,
    "log_mel_epilogue_plan": [_I, _I, _I, _I, _P],
})
_build.declare("log_mel_dft_gemm", {
    "log_mel_dft_gemm_launch": [_I, _P, _I, _I, _I, _I, _I, _P, _I, _I, _P, _I, _P, _I, _P,
                                _P],
    "log_mel_epilogue_launch": _EPILOGUE,
})
