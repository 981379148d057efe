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
at the n_fft its launch function lists and one block a pair elsewhere
(`mixed_radix_occupancy` reports which). All take any hop, up to
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
`launches_masked` (which stays 0 for radix2, bf16x3 and f32: bounds raise).
On a CPU tensor every wrapper runs `log_mel_fused_reference`.

Each CUDA source's header note says what bounds its kernel on the card and
what its design does about it; the epilogue kernel is
`csrc/log_mel_epilogue.cuh`, which all include. A wrapper allocates the dB
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


def mixed_radix_smem_bytes(n_fft: int) -> int:
    """Shared memory a block of `csrc/log_mel_mixed_radix.cu`'s block path
    takes (its `block_smem_bytes`): the N complex values, then two power
    spectra. Every n_fft the warp path takes needs less a pair (8 N bytes)."""
    return 8 * n_fft + 8 * (n_fft // 2 + 1)


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
    """`csrc/log_mel_mixed_radix.cu`'s constants of n_fft = P * m (P its
    largest power-of-two factor), built in float64, for either path, as the
    launch function picks the path: window; W_N^j for every j < N (the block
    path); the P-point FFT's stage twiddles W_{2h}^j at [h - 1 + j] (P - 1),
    W_N^{r k0} as (m - 1, P) for r = 1 .. m - 1, and W_m^j (m) (the warp
    path)."""
    p = n_fft & -n_fft
    m = n_fft // p
    stages = np.concatenate([np.exp(-2j * np.pi * np.arange(h) / (2 * h))
                             for h in (1 << np.arange(p.bit_length() - 1))])
    tables = (np.exp(-2j * np.pi * np.arange(n_fft) / n_fft), stages,
              np.exp(-2j * np.pi * np.outer(np.arange(1, m), np.arange(p)) / n_fft),
              np.exp(-2j * np.pi * np.arange(m) / m))
    return (stft_ops.hann_window(n_fft, dtype=torch.float32, device=device),
            *(_dev(_complex_pairs(t), torch.float32, device) for t in tables))


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
                     norm=norm, normalize=normalize, eps=eps, spec_mask_bounds=spec_mask_bounds)
    if spec_mask_bounds is None:
        wrapper.launches += 1
    else:
        wrapper.launches_masked += 1
    return out


def run_source(source: str, waveform: torch.Tensor, sample_rate: int, n_fft: int,
               hop_length: int, n_mels: int, *, f_min: float, f_max: float | None,
               top_db: float | None, mel_scale: str, norm: str | None, normalize: bool,
               eps: float, spec_mask_bounds: torch.Tensor | None) -> torch.Tensor:
    """Launch CUDA source `source`'s spectrum kernel and the epilogue on a
    checked, contiguous (B, L) float32 CUDA waveform; counts nothing. The
    wrappers run `cuda_route`'s source through it; `chip_smoke.py` times
    each source at the same shape."""
    b, length = waveform.shape
    t = stft_ops.num_frames(length, n_fft, hop_length)
    db = torch.empty((b, t, n_mels), dtype=torch.float32, device=waveform.device)
    out = torch.empty((b, n_mels, t), dtype=torch.float32, device=waveform.device)
    lib, dev_index, stream = spectrum_only(source, waveform, sample_rate, n_fft, hop_length,
                                           n_mels, db, f_min=f_min, f_max=f_max,
                                           mel_scale=mel_scale, norm=norm)
    bounds = None if spec_mask_bounds is None else spec_mask_bounds.contiguous()
    _build.launch(lib, lib.log_mel_epilogue_launch, dev_index, db.data_ptr(), b, t, n_mels,
            int(top_db is not None), 0.0 if top_db is None else float(top_db),
            int(normalize), float(eps), None if bounds is None else bounds.data_ptr(),
            out.data_ptr(), stream)
    return out


def spectrum_only(source: str, waveform: torch.Tensor, sample_rate: int, n_fft: int,
                  hop_length: int, n_mels: int, db: torch.Tensor, *, f_min: float = 0.0,
                  f_max: float | None = None, mel_scale: str = "htk", norm: str | None = None):
    """The first half of `run_source`: source `source`'s spectrum pass of a
    (B, L) float32 CUDA waveform into the (B, T, n_mels) dB scratch `db`,
    counted nowhere (`chip_smoke.py` times it alone on preallocated
    buffers). The radix-8 and mixed-radix sources reflect inside the
    kernel; the DFT GEMM reads the wrapper's reflect-padded copy. Returns (library,
    device index, stream) for the epilogue."""
    device = waveform.device
    filterbank = (sample_rate, n_fft, n_mels, float(f_min),
                  sample_rate / 2.0 if f_max is None else float(f_max), mel_scale, norm, device)
    lib = _build.load(source)
    stream = torch.cuda.current_stream(device).cuda_stream
    dev_index = device.index if device.index is not None else torch.cuda.current_device()
    _SPECTRA[source](lib, dev_index, waveform, n_fft, hop_length, db.shape[1], filterbank, db,
                     stream)
    return lib, dev_index, stream


@functools.lru_cache(maxsize=16)
def mixed_radix_occupancy(n_fft: int, device_index: int) -> dict:
    """The launch shape of n_fft on `csrc/log_mel_mixed_radix.cu` on a CUDA
    device, from its `log_mel_mixed_radix_occupancy`: path ("block",
    "registers", "shared"), warps a block, blocks an SM, warps an SM,
    registers a thread, shared bytes a block."""
    lib = _build.load("log_mel_mixed_radix")
    out = (ctypes.c_int * 5)()
    _build.launch(lib, lib.log_mel_mixed_radix_occupancy, device_index, n_fft, out)
    path, warps, blocks, regs, smem = out
    return {"path": ("block", "registers", "shared")[path], "warps_per_block": warps,
            "blocks_per_sm": blocks, "warps_per_sm": warps * blocks, "registers": regs,
            "smem_bytes": smem}


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
    tables = _twiddles_mixed_radix(n_fft, x.device)  # window, then both paths' twiddles
    mel_start, mel_offset, mel_weight = mel_bands(*filterbank)
    _build.launch(lib, lib.log_mel_mixed_radix_launch, dev_index, x.data_ptr(), x.shape[0],
            x.shape[1], n_fft, hop, t, *(table.data_ptr() for table in tables),
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
    "log_mel_mixed_radix_launch": [_I, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                                   _I, _P, _P],
    "log_mel_mixed_radix_occupancy": [_I, _I, _P],
    "log_mel_epilogue_launch": _EPILOGUE,
})
_build.declare("log_mel_dft_gemm", {
    "log_mel_dft_gemm_launch": [_I, _P, _I, _I, _I, _I, _I, _P, _I, _I, _P, _I, _P, _I, _P,
                                _P],
    "log_mel_epilogue_launch": _EPILOGUE,
})
