"""The log-mel front-end kernels on Hopper, and their one plain version.

Two hand-written CUDA kernels replace two TPU kernels of
`audio_classification_icbhi_tpu/ops/pallas_mel.py`, with the per-example
epilogue `_fused_epilogue` (`:683`) they both end in:

- `log_mel_radix16dif_fused` (`csrc/log_mel_radix16dif.cu`) replaces
  `_kernel_radix16dif_fused` (`:1270`), launched by
  `_log_mel_radix16dif_fused` (`:1374`, `pl.pallas_call` at `:1437`); it
  takes n_fft % 2048 == 0;
- `log_mel_radix8dif_fused` (`csrc/log_mel_radix8dif.cu`) replaces
  `_kernel_radix8dif_fused` (`:1193`), launched by
  `_log_mel_radix8dif_fused` (`:1456`, `pl.pallas_call` at `:1523`); it
  takes n_fft % 1024 == 0.

Both compute the same function, (B, L) f32 waveform -> (B, n_mels, T) f32
log-mel:

  reflect pad by n_fft/2 -> frame at hop -> periodic Hann -> |rfft|² ->
  mel projection -> 10·log10(max(·, 1e-10)) -> [top_db against the
  example's own peak] -> [SpecAugment mask] -> [normalize: mean, ddof=1 std,
  (x − mean)/(std + eps) over the valid T × n_mels cells].

Each has two forms, as the TPU kernels have (`with_masks`): the inference
form, and the training form, which takes per-example SpecAugment bounds
(B, 4) and zeroes those cells between the dB stage and normalize. Each
wrapper counts its forms' launches apart: `launches` and `launches_masked`.
On a CPU tensor both run `log_mel_fused_reference`.

Each CUDA source's header note says what bounds its kernel on the card and
what its design does about it; the epilogue kernel is
`csrc/log_mel_epilogue.cuh`, which both include. A wrapper reflect-pads (as
the TPU wrappers do), allocates the dB scratch and the output, and launches
the spectrum kernel and the epilogue on the current stream.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from audio_classification_icbhi_tpu_torch.ops import _build
from audio_classification_icbhi_tpu_torch.ops.augment import mask_from_bounds
from audio_classification_icbhi_tpu_torch.ops import stft as stft_ops
from audio_classification_icbhi_tpu_torch.ops.mel import (
    _mel_filterbank_np,
    check_dft_passes,
    log_mel_spectrogram,
    normalize_spectrogram,
)

def _check_eligible(algorithm: str, n_fft: int, hop_length: int) -> None:
    """The TPU kernels' shape contracts, with their messages
    (`pallas_mel.py:1380-1388` for radix16dif_fused, `:1462-1471` for
    radix8dif_fused)."""
    parts = 16 if algorithm == "radix16dif_fused" else 8
    if n_fft % parts:
        raise ValueError(f"{algorithm} requires n_fft divisible by {parts}")
    if n_fft % hop_length:
        raise ValueError(f"{algorithm} requires n_fft divisible by hop_length")
    if hop_length % 128:
        raise ValueError(f"{algorithm} requires hop_length % 128 == 0")
    if (n_fft // parts) % 128:
        raise ValueError(f"{algorithm} requires n_fft % {128 * parts} == 0")


def log_mel_fused_reference(
    waveform: torch.Tensor, sample_rate: int, n_fft: int, hop_length: int,
    n_mels: int, *, f_min: float = 0.0, f_max: float | None = None,
    top_db: float | None = None, mel_scale: str = "htk", norm: str | None = None,
    normalize: bool = False, eps: float = 1e-8,
    spec_mask_bounds: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain torch version of both kernels, in the waveform's dtype: framing
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
    """The banded mel filterbank on `device`, as both kernels take it.

    Each triangular filter is nonzero on a short band of bins, so the
    filterbank travels as per-mel [start, start + len) bin ranges beside
    the packed float32 weights of each band (about two weights per bin):
    (starts (n_mels,) int32, offsets (n_mels + 1,) int32, weights (nnz,))."""
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


@functools.lru_cache(maxsize=8)
def _twiddles_radix16dif(n_fft: int, device: torch.device) -> tuple[torch.Tensor, ...]:
    """Window and the radix-2 FFT's twiddles exp(-2πik/N), k < N/2."""
    k = np.arange(n_fft // 2)
    return (stft_ops.hann_window(n_fft, dtype=torch.float32, device=device),
            _dev(_complex_pairs(np.exp(-2j * np.pi * k / n_fft)), torch.float32, device))


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


def _log_mel_fused(wrapper, algorithm: str, waveform: torch.Tensor, sample_rate: int,
                   n_fft: int, hop_length: int, n_mels: int, *, f_min: float,
                   f_max: float | None, top_db: float | None, mel_scale: str,
                   norm: str | None, normalize: bool, eps: float, dft_passes: int | None,
                   spec_mask_bounds: torch.Tensor | None) -> torch.Tensor:
    """What both wrappers share: the checks, the CPU route to the plain
    version, the reflect pad, the dB scratch, the epilogue launch and the
    launch counts (on `wrapper`). `_KERNELS[algorithm]` names the source,
    the n_fft check and the spectrum launch of the algorithm's own kernel."""
    source, check_n_fft, spectrum = _KERNELS[algorithm]
    _check_eligible(algorithm, n_fft, hop_length)
    check_dft_passes(dft_passes)
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
    check_n_fft(n_fft)
    b, length = waveform.shape
    t = stft_ops.num_frames(length, n_fft, hop_length)
    device = waveform.device
    bands = mel_bands(sample_rate, n_fft, n_mels, float(f_min),
                      sample_rate / 2.0 if f_max is None else float(f_max), mel_scale, norm,
                      device)
    x = stft_ops.reflect_pad(waveform, n_fft // 2)  # (B, L + n_fft), contiguous
    db = torch.empty((b, t, n_mels), dtype=torch.float32, device=device)
    out = torch.empty((b, n_mels, t), dtype=torch.float32, device=device)
    lib = _build.load(source)
    stream = torch.cuda.current_stream(device).cuda_stream
    dev_index = device.index if device.index is not None else torch.cuda.current_device()
    spectrum(lib, dev_index, x, n_fft, hop_length, t, bands, db, stream)
    bounds = None if spec_mask_bounds is None else spec_mask_bounds.contiguous()
    _build.launch(lib, lib.log_mel_epilogue_launch, dev_index, db.data_ptr(), b, t, n_mels,
            int(top_db is not None), 0.0 if top_db is None else float(top_db),
            int(normalize), float(eps), None if bounds is None else bounds.data_ptr(),
            out.data_ptr(), stream)
    if bounds is None:
        wrapper.launches += 1
    else:
        wrapper.launches_masked += 1
    return out


def log_mel_radix16dif_fused(
    waveform: torch.Tensor, sample_rate: int, n_fft: int, hop_length: int,
    n_mels: int, *, f_min: float = 0.0, f_max: float | None = None,
    top_db: float | None = None, mel_scale: str = "htk", norm: str | None = None,
    normalize: bool = False, eps: float = 1e-8, dft_passes: int | None = None,
    spec_mask_bounds: torch.Tensor | None = None,
) -> torch.Tensor:
    """(B, L) f32 waveform -> (B, n_mels, T) f32 log-mel, for n_fft % 2048
    == 0 (`csrc/log_mel_radix16dif.cu`).

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


def _check_n_fft_radix16dif(n_fft: int) -> None:
    if n_fft & (n_fft - 1):
        raise NotImplementedError(
            "the Hopper radix16dif_fused kernel takes a power-of-two n_fft "
            "(ROADMAP.md B1); got n_fft=%d" % n_fft)


def _spectrum_radix16dif(lib, dev_index, x, n_fft, hop, t, bands, db, stream) -> None:
    window, twiddle = _twiddles_radix16dif(n_fft, x.device)
    mel_start, mel_offset, mel_weight = bands
    _build.launch(lib, lib.log_mel_spectrum_launch, dev_index, x.data_ptr(), x.shape[0],
            x.shape[1], n_fft, hop, t, window.data_ptr(), twiddle.data_ptr(),
            mel_start.data_ptr(), mel_offset.data_ptr(), mel_weight.data_ptr(),
            mel_start.numel(), mel_weight.numel(), db.data_ptr(), stream)


def log_mel_radix8dif_fused(
    waveform: torch.Tensor, sample_rate: int, n_fft: int, hop_length: int,
    n_mels: int, *, f_min: float = 0.0, f_max: float | None = None,
    top_db: float | None = None, mel_scale: str = "htk", norm: str | None = None,
    normalize: bool = False, eps: float = 1e-8, dft_passes: int | None = None,
    spec_mask_bounds: torch.Tensor | None = None,
) -> torch.Tensor:
    """(B, L) f32 waveform -> (B, n_mels, T) f32 log-mel, for n_fft % 1024
    == 0 (`csrc/log_mel_radix8dif.cu`): the same function and the same two
    forms as `log_mel_radix16dif_fused`, by radix-8 decimation in frequency,
    one warp per frame. The analyzer's sub-second windows (n_fft 1024, hop
    256) run it.
    """
    return _log_mel_fused(
        log_mel_radix8dif_fused, "radix8dif_fused", waveform, sample_rate, n_fft,
        hop_length, n_mels, f_min=f_min, f_max=f_max, top_db=top_db, mel_scale=mel_scale,
        norm=norm, normalize=normalize, eps=eps, dft_passes=dft_passes,
        spec_mask_bounds=spec_mask_bounds)


def _check_n_fft_radix8dif(n_fft: int) -> None:
    if n_fft & (n_fft - 1) or n_fft > 8192:
        raise NotImplementedError(
            "the Hopper radix8dif_fused kernel takes n_fft/8 a power of two, "
            "n_fft up to 8192 (ROADMAP.md B2); got n_fft=%d" % n_fft)


def _spectrum_radix8dif(lib, dev_index, x, n_fft, hop, t, bands, db, stream) -> None:
    window, twiddle_rn, twiddle_fft = _twiddles_radix8dif(n_fft, x.device)
    mel_start, mel_offset, mel_weight = bands
    _build.launch(lib, lib.log_mel_radix8dif_launch, dev_index, x.data_ptr(), x.shape[0],
            x.shape[1], n_fft, hop, t, window.data_ptr(), twiddle_rn.data_ptr(),
            twiddle_fft.data_ptr(), mel_start.data_ptr(), mel_offset.data_ptr(),
            mel_weight.data_ptr(), mel_start.numel(), mel_weight.numel(), db.data_ptr(),
            stream)


# algorithm -> (CUDA source, n_fft check, spectrum launch)
_KERNELS = {
    "radix16dif_fused": ("log_mel_radix16dif", _check_n_fft_radix16dif, _spectrum_radix16dif),
    "radix8dif_fused": ("log_mel_radix8dif", _check_n_fft_radix8dif, _spectrum_radix8dif),
}
# launch counts of each wrapper: the inference form, and the training form
# (SpecAugment bounds)
for _fn in (log_mel_radix16dif_fused, log_mel_radix8dif_fused):
    _fn.launches = 0
    _fn.launches_masked = 0

# ctypes signatures of the C entry points in csrc/*.cu
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_EPILOGUE = [_I, _P, _I, _I, _I, _I, _F, _I, _F, _P, _P, _P]
_build.declare("log_mel_radix16dif", {
    "log_mel_spectrum_launch": [_I, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P,
                                _I, _I, _P, _P],
    "log_mel_epilogue_launch": _EPILOGUE,
})
_build.declare("log_mel_radix8dif", {
    "log_mel_radix8dif_launch": [_I, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P,
                                 _I, _I, _P, _P],
    "log_mel_epilogue_launch": _EPILOGUE,
})
