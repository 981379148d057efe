"""The radix-16 log-mel front-end kernel on Hopper, and its plain version.

Replaces the TPU kernel `_kernel_radix16dif_fused`
(`audio_classification_icbhi_tpu/ops/pallas_mel.py:1270`), launched by
`_log_mel_radix16dif_fused` (`:1374`, `pl.pallas_call` at `:1437`), with its
per-example epilogue `_fused_epilogue` (`:683`). It computes the same
function, (B, L) f32 waveform -> (B, n_mels, T) f32 log-mel:

  reflect pad by n_fft/2 -> frame at hop -> periodic Hann -> |rfft|² ->
  mel projection -> 10·log10(max(·, 1e-10)) -> [top_db against the
  example's own peak] -> [SpecAugment mask] -> [normalize: mean, ddof=1 std,
  (x − mean)/(std + eps) over the valid T × n_mels cells].

It has two forms, as the TPU kernel has (`with_masks`): the inference form,
and the training form, which takes per-example SpecAugment bounds (B, 4)
and zeroes those cells between the dB stage and normalize. The wrapper
counts each form's launches apart: `launches` and `launches_masked`.

The CUDA source is `csrc/log_mel_radix16dif.cu`; its header note says what
bounds the kernel on the card and what its design does about it. The wrapper
reflect-pads (as the TPU wrapper does), allocates the dB scratch and the
output, and launches the two kernels on the current stream.
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

SOURCE = "log_mel_radix16dif"


def _check_eligible(n_fft: int, hop_length: int) -> None:
    """The TPU kernel's shape contract (`pallas_mel.py:1380-1388`)."""
    if n_fft % 16:
        raise ValueError("radix16dif_fused requires n_fft divisible by 16")
    if n_fft % hop_length:
        raise ValueError("radix16dif_fused requires n_fft divisible by hop_length")
    if hop_length % 128:
        raise ValueError("radix16dif_fused requires hop_length % 128 == 0")
    if (n_fft // 16) % 128:
        raise ValueError("radix16dif_fused requires n_fft % 2048 == 0")


def log_mel_radix16dif_fused_reference(
    waveform: torch.Tensor, sample_rate: int, n_fft: int, hop_length: int,
    n_mels: int, *, f_min: float = 0.0, f_max: float | None = None,
    top_db: float | None = None, mel_scale: str = "htk", norm: str | None = None,
    normalize: bool = False, eps: float = 1e-8,
    spec_mask_bounds: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain torch version of the kernel, in the waveform's dtype: framing by
    unfold, window, matmul DFT, power, mel matmul, dB, then the epilogue:
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


@functools.lru_cache(maxsize=8)
def _constants(sample_rate: int, n_fft: int, n_mels: int, f_min: float,
               f_max: float, mel_scale: str, norm: str | None, device: torch.device):
    """Window, twiddles and the banded mel filterbank on `device`.

    Each triangular filter is nonzero on a short band of bins, so the
    filterbank travels as per-mel [start, start + len) bin ranges beside
    the packed float32 weights of each band (about two weights per bin)."""
    window = stft_ops.hann_window(n_fft, dtype=torch.float32, device=device)
    k = np.arange(n_fft // 2)
    twiddle = np.stack([np.cos(2 * np.pi * k / n_fft), -np.sin(2 * np.pi * k / n_fft)], 1)
    fb = _mel_filterbank_np(sample_rate, n_fft, n_mels, f_min, f_max, mel_scale, norm)
    starts, offsets, weights = [], [0], []
    for m in range(n_mels):
        nz = np.flatnonzero(fb[:, m])
        lo, hi = (int(nz[0]), int(nz[-1]) + 1) if nz.size else (0, 0)
        starts.append(lo)
        weights.append(fb[lo:hi, m])
        offsets.append(offsets[-1] + hi - lo)

    def dev(x, dtype):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype, device=device)

    return (window, dev(twiddle, torch.float32), dev(starts, torch.int32),
            dev(offsets, torch.int32), dev(np.concatenate(weights), torch.float32))


def _launch(fn, *args) -> None:
    err = fn(*args)
    if err:
        msg = _build.load(SOURCE).cuda_error_string(err).decode()
        raise RuntimeError(f"{fn.__name__} failed: CUDA error {err} ({msg})")


def log_mel_radix16dif_fused(
    waveform: torch.Tensor, sample_rate: int, n_fft: int, hop_length: int,
    n_mels: int, *, f_min: float = 0.0, f_max: float | None = None,
    top_db: float | None = None, mel_scale: str = "htk", norm: str | None = None,
    normalize: bool = False, eps: float = 1e-8, dft_passes: int | None = None,
    spec_mask_bounds: torch.Tensor | None = None,
) -> torch.Tensor:
    """(B, L) f32 waveform -> (B, n_mels, T) f32 log-mel.

    A CUDA tensor launches the hand-written kernel, or raises; a CPU tensor
    runs the plain version. `spec_mask_bounds`, a (B, 4) float32 tensor on
    the waveform's device, selects the training form. `dft_passes` is
    checked as in the JAX package and otherwise ignored: the kernel runs its
    FFT and mel projection in float32, at least as accurate as every bf16
    pass budget of the TPU kernel.
    """
    _check_eligible(n_fft, hop_length)
    check_dft_passes(dft_passes)
    if waveform.dim() != 2:
        raise ValueError(f"waveform must be (B, L), got shape {tuple(waveform.shape)}")
    if spec_mask_bounds is not None:
        _check_bounds(spec_mask_bounds, waveform)
    kwargs = dict(f_min=f_min, f_max=f_max, top_db=top_db, mel_scale=mel_scale,
                  norm=norm, normalize=normalize, eps=eps, spec_mask_bounds=spec_mask_bounds)
    if waveform.device.type == "cpu":
        return log_mel_radix16dif_fused_reference(
            waveform, sample_rate, n_fft, hop_length, n_mels, **kwargs)
    if not waveform.is_cuda:
        raise ValueError(f"unsupported device {waveform.device}")
    if waveform.dtype != torch.float32:
        raise TypeError(f"waveform must be float32, got {waveform.dtype}")
    if not waveform.is_contiguous():
        raise ValueError("waveform must be contiguous")
    if n_fft & (n_fft - 1):
        raise NotImplementedError(
            "the Hopper radix16dif_fused kernel takes a power-of-two n_fft "
            "(ROADMAP.md B1); got n_fft=%d" % n_fft)
    b, length = waveform.shape
    t = stft_ops.num_frames(length, n_fft, hop_length)
    device = waveform.device
    window, twiddle, mel_start, mel_offset, mel_weight = _constants(
        sample_rate, n_fft, n_mels, float(f_min),
        sample_rate / 2.0 if f_max is None else float(f_max), mel_scale, norm, device)
    x = stft_ops.reflect_pad(waveform, n_fft // 2)  # (B, L + n_fft), contiguous
    db = torch.empty((b, t, n_mels), dtype=torch.float32, device=device)
    out = torch.empty((b, n_mels, t), dtype=torch.float32, device=device)
    lib = _build.load(SOURCE)
    stream = torch.cuda.current_stream(device).cuda_stream
    dev_index = device.index if device.index is not None else torch.cuda.current_device()
    _launch(lib.log_mel_spectrum_launch, dev_index, x.data_ptr(), b, x.shape[1],
            n_fft, hop_length, t, window.data_ptr(), twiddle.data_ptr(),
            mel_start.data_ptr(), mel_offset.data_ptr(), mel_weight.data_ptr(),
            n_mels, mel_weight.numel(), db.data_ptr(), stream)
    bounds = None if spec_mask_bounds is None else spec_mask_bounds.contiguous()
    _launch(lib.log_mel_epilogue_launch, dev_index, db.data_ptr(), b, t, n_mels,
            int(top_db is not None), 0.0 if top_db is None else float(top_db),
            int(normalize), float(eps), None if bounds is None else bounds.data_ptr(),
            out.data_ptr(), stream)
    if bounds is None:
        log_mel_radix16dif_fused.launches += 1
    else:
        log_mel_radix16dif_fused.launches_masked += 1
    return out


log_mel_radix16dif_fused.launches = 0         # inference form
log_mel_radix16dif_fused.launches_masked = 0  # training form (SpecAugment bounds)

# ctypes signatures of the C entry points in csrc/log_mel_radix16dif.cu
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_build.declare(SOURCE, {
    "log_mel_spectrum_launch": [_I, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P,
                                _I, _I, _P, _P],
    "log_mel_epilogue_launch": [_I, _P, _I, _I, _I, _I, _F, _I, _F, _P, _P, _P],
})
