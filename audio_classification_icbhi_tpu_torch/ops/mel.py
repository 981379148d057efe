"""Mel filterbanks and the log-mel front end on torch tensors.

Port of `audio_classification_icbhi_tpu/ops/mel.py:40-170` and `:346-628`.
The chain is torchaudio's MelSpectrogram(power=2) -> AmplitudeToDB:
framing -> Hann window -> DFT -> power -> mel projection -> 10·log10 ->
optional per-example normalize. Both mel conventions are kept: "htk"
(torchaudio) and "slaney" (librosa), with norm None or "slaney".

Layouts follow the JAX package: a log-mel is (..., n_mels, T).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from audio_classification_icbhi_tpu_torch.ops import stft as stft_ops

# --- Mel scales ------------------------------------------------------------

_F_SP = 200.0 / 3.0  # Slaney: 66.67 Hz per mel below 1 kHz
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0

# The kernel algorithm names of the JAX package's policy
# (`ops/mel.py:497-531`), each with a Hopper kernel in this port.
PORTED_ALGORITHMS = ("radix16dif_fused", "radix8dif_fused", "radix4dif_fused",
                     "radix4_fused", "radix2_fused", "radix2", "bf16x3", "f32")
# each algorithm's row in ROADMAP.md queue B
_ROADMAP_ROW = {"radix16dif_fused": "B1", "radix8dif_fused": "B2", "radix4dif_fused": "B3",
                "radix4_fused": "B4", "radix2_fused": "B5", "radix2": "B6",
                "bf16x3": "B7", "f32": "B7"}
# the algorithms with a per-example epilogue: the only ones that take
# SpecAugment bounds, and the only ones backend "auto" sends to a kernel
# (`_auto_pallas`, `ops/mel.py:483-487`)
_FUSED_ALGORITHMS = ("radix16dif_fused", "radix8dif_fused", "radix4dif_fused",
                     "radix4_fused", "radix2_fused")


def hz_to_mel(freq, mel_scale: str = "htk"):
    """Hz -> mel. HTK: 2595*log10(1+f/700). Slaney: linear<1kHz, log above."""
    freq = np.asarray(freq, dtype=np.float64)
    if mel_scale == "htk":
        return 2595.0 * np.log10(1.0 + freq / 700.0)
    if mel_scale != "slaney":
        raise ValueError(f"unknown mel_scale: {mel_scale!r}")
    mel = freq / _F_SP
    log_region = freq >= _MIN_LOG_HZ
    return np.where(
        log_region,
        _MIN_LOG_MEL + np.log(np.maximum(freq, _MIN_LOG_HZ) / _MIN_LOG_HZ) / _LOGSTEP,
        mel,
    )


def mel_to_hz(mel, mel_scale: str = "htk"):
    """Mel -> Hz (inverse of hz_to_mel)."""
    mel = np.asarray(mel, dtype=np.float64)
    if mel_scale == "htk":
        return 700.0 * (10.0 ** (mel / 2595.0) - 1.0)
    if mel_scale != "slaney":
        raise ValueError(f"unknown mel_scale: {mel_scale!r}")
    freq = _F_SP * mel
    log_region = mel >= _MIN_LOG_MEL
    return np.where(log_region, _MIN_LOG_HZ * np.exp(_LOGSTEP * (mel - _MIN_LOG_MEL)), freq)


@functools.lru_cache(maxsize=16)
def _mel_filterbank_np(
    sample_rate: int,
    n_fft: int,
    n_mels: int,
    f_min: float,
    f_max: float,
    mel_scale: str,
    norm: str | None,
) -> np.ndarray:
    n_freqs = n_fft // 2 + 1
    all_freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    m_pts = np.linspace(hz_to_mel(f_min, mel_scale), hz_to_mel(f_max, mel_scale), n_mels + 2)
    f_pts = mel_to_hz(m_pts, mel_scale)
    # Triangular filters between consecutive mel-spaced frequency points.
    f_diff = f_pts[1:] - f_pts[:-1]                       # (n_mels+1,)
    slopes = f_pts[None, :] - all_freqs[:, None]          # (n_freqs, n_mels+2)
    down = -slopes[:, :-2] / f_diff[None, :-1]            # rising edge
    up = slopes[:, 2:] / f_diff[None, 1:]                 # falling edge
    fb = np.maximum(0.0, np.minimum(down, up))            # (n_freqs, n_mels)
    if norm == "slaney":
        enorm = 2.0 / (f_pts[2 : n_mels + 2] - f_pts[:n_mels])
        fb = fb * enorm[None, :]
    elif norm is not None:
        raise ValueError(f"unknown norm: {norm!r}")
    return fb.astype(np.float32)


def mel_filterbank(
    sample_rate: int,
    n_fft: int,
    n_mels: int,
    f_min: float = 0.0,
    f_max: float | None = None,
    mel_scale: str = "htk",
    norm: str | None = None,
    *,
    dtype=torch.float32,
    device=None,
) -> torch.Tensor:
    """Triangular mel filterbank, shape (n_fft//2+1, n_mels).

    Defaults reproduce torchaudio MelSpectrogram (htk scale, no norm);
    (mel_scale="slaney", norm="slaney") reproduces librosa defaults. The
    filterbank is built in float64 and rounded to float32, as in the JAX
    package, before any cast to `dtype`.
    """
    if f_max is None:
        f_max = sample_rate / 2.0
    fb = _mel_filterbank_np(sample_rate, n_fft, n_mels, float(f_min), float(f_max),
                            mel_scale, norm)
    return torch.as_tensor(fb, dtype=dtype, device=device)


@functools.lru_cache(maxsize=16)
def _device_filterbank(sample_rate, n_fft, n_mels, f_min, f_max, mel_scale, norm, dtype,
                       device) -> torch.Tensor:
    """`mel_filterbank` on `device`, made once: a copy from the host inside
    the chain would break a CUDA graph's capture of it."""
    return mel_filterbank(sample_rate, n_fft, n_mels, f_min, f_max, mel_scale, norm,
                          dtype=dtype, device=device)


# --- dB conversion ----------------------------------------------------------

def amplitude_to_db(
    x: torch.Tensor,
    *,
    stype: str = "power",
    ref: float = 1.0,
    amin: float = 1e-10,
    top_db: float | None = None,
) -> torch.Tensor:
    """torchaudio T.AmplitudeToDB semantics.

    power: 10*log10(max(x, amin)) - 10*log10(max(amin, ref)).
    top_db, if given, clips per example to (max - top_db) over the last two
    axes.
    """
    multiplier = 10.0 if stype == "power" else 20.0
    db = multiplier * torch.log10(torch.clamp(x, min=amin))
    db = db - multiplier * float(np.log10(max(amin, ref)))
    if top_db is not None:
        peak = torch.amax(db, dim=(-2, -1), keepdim=True)
        db = torch.maximum(db, peak - top_db)
    return db


def power_to_db(
    x: torch.Tensor,
    *,
    ref: str | float = 1.0,
    amin: float = 1e-10,
    top_db: float | None = 80.0,
) -> torch.Tensor:
    """librosa.power_to_db semantics; ref="max" uses the array's max."""
    log_spec = 10.0 * torch.log10(torch.clamp(x, min=amin))
    if isinstance(ref, str):
        if ref != "max":
            raise ValueError("ref must be a float or 'max'")
        ref_val = torch.amax(x)
    else:
        ref_val = torch.as_tensor(ref, dtype=x.dtype, device=x.device)
    log_spec = log_spec - 10.0 * torch.log10(torch.clamp(ref_val, min=amin))
    if top_db is not None:
        log_spec = torch.maximum(log_spec, torch.amax(log_spec) - top_db)
    return log_spec


# --- Log-mel front end --------------------------------------------------------

def log_mel_spectrogram(
    waveform: torch.Tensor,
    sample_rate: int,
    n_fft: int,
    hop_length: int,
    n_mels: int,
    *,
    f_min: float = 0.0,
    f_max: float | None = None,
    mel_scale: str = "htk",
    norm: str | None = None,
    power: float = 2.0,
    center: bool = True,
    to_db: str = "amplitude",  # "amplitude" (torchaudio) | "power_max" (librosa) | "none"
    top_db: float | None = None,
) -> torch.Tensor:
    """waveform (..., L) -> log-mel (..., n_mels, T), computed in the
    waveform's dtype with a matmul DFT: the plain version every front-end
    kernel is held against."""
    spec = stft_ops.stft_power(waveform, n_fft, hop_length, center=center)  # (..., T, bins)
    if power != 2.0:
        spec = torch.sqrt(torch.clamp(spec, min=0.0)) ** power
    fb = _device_filterbank(sample_rate, n_fft, n_mels, f_min, f_max, mel_scale, norm,
                            waveform.dtype, waveform.device)
    mel = (spec @ fb).transpose(-1, -2)  # (..., n_mels, T)
    if to_db == "amplitude":
        return amplitude_to_db(mel, stype="power" if power == 2.0 else "magnitude",
                               top_db=top_db)
    if to_db == "power_max":
        return power_to_db(mel, ref="max", top_db=80.0 if top_db is None else top_db)
    if to_db == "none":
        return mel
    raise ValueError(f"unknown to_db mode: {to_db!r}")


def normalize_spectrogram(mel_spec: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Per-example zero-mean unit-variance normalization over the last two
    axes. The variance is unbiased (ddof=1, torch.std's default) and eps is
    added to the std, not the variance."""
    n = mel_spec.shape[-2] * mel_spec.shape[-1]
    mean = torch.mean(mel_spec, dim=(-2, -1), keepdim=True)
    var = torch.sum((mel_spec - mean) ** 2, dim=(-2, -1), keepdim=True) / max(n - 1, 1)
    return (mel_spec - mean) / (torch.sqrt(var) + eps)


def check_dft_passes(dft_passes: int | None) -> None:
    """The JAX kernels' bf16 pass budgets (`pallas_mel.py:1741-1747`)."""
    if dft_passes is not None and dft_passes not in (3, 4, 5, 6):
        raise ValueError(
            f"dft_passes must be 3 or 4 (2-way bf16 split), 5 "
            f"(3-way operand x 2-way matrix), or 6 "
            f"(3-way hi/mid/lo split), got {dft_passes}")


class MelFrontend:
    """Configured wav -> normalized log-mel transform.

    Call with a (..., L) float32 waveform; returns (..., n_mels, T).

    Routing (`uses_kernel`), as the JAX package routes to its Pallas
    kernels: on a CUDA tensor, backend "pallas" runs the kernel of the
    algorithm the policy picks (`_pallas_algorithm`), and backend "auto"
    does so only for the fused algorithms (`_auto_pallas`,
    `ops/mel.py:483-487`); "radix2" and "bf16x3" then run the plain torch
    chain, as the JAX package runs XLA there. Every algorithm has a Hopper
    port (`PORTED_ALGORITHMS`); the source each shape runs is
    `mel_kernels.cuda_route`'s, by n_fft: the DFT GEMM kernel at n_fft % 4
    != 0 (backend "pallas" picks "bf16x3" there), the radix-8 kernel at
    512, 1024, 2048, 4096 and 8192, the mixed-radix kernel at every other n_fft
    up to 16,384. Past that limit a kernel route raises
    NotImplementedError naming the algorithm's ROADMAP.md row. Backends
    "xla" and "xla_radix2", the JAX package's explicit non-Pallas paths, run
    the plain chain. On a CPU tensor every backend runs the plain chain.

    `dft_passes` is validated as in the JAX package, where it picks the bf16
    split of the TPU kernels' DFT GEMMs. The Hopper kernels compute their
    FFT (or, at n_fft % 4 != 0, a three-product TF32 DFT) and mel projection
    to float32 accuracy, at least as accurate as every pass budget, so they
    take the value and ignore it.
    """

    def __init__(
        self,
        sample_rate: int = 16000,
        n_mels: int = 128,
        n_fft: int = 2048,
        hop_length: int = 512,
        duration: float = 5.0,
        *,
        f_min: float = 0.0,
        f_max: float | None = None,
        top_db: float | None = None,
        mel_scale: str = "htk",
        norm: str | None = None,
        use_matmul_dft: bool = True,
        normalize: bool = True,
        backend: str = "auto",  # "auto" | "pallas" | "xla" | "xla_radix2"
        pallas_algorithm: str | None = None,
        dft_passes: int | None = None,
    ):
        if backend not in ("auto", "pallas", "xla", "xla_radix2"):
            raise ValueError(f"unknown backend {backend!r}")
        self.sample_rate = sample_rate
        self.n_mels = n_mels
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.duration = duration
        self.target_length = int(sample_rate * duration)
        self.f_min = float(f_min)
        self.f_max = None if f_max is None else float(f_max)
        self.top_db = None if top_db is None else float(top_db)
        self.mel_scale = mel_scale
        self.norm = norm
        # accepted for the JAX package's signature: the plain chain always
        # uses the matmul DFT
        self.use_matmul_dft = use_matmul_dft
        self.normalize = normalize
        self.backend = backend
        self.pallas_algorithm = pallas_algorithm
        self.dft_passes = dft_passes
        if dft_passes is not None:
            check_dft_passes(dft_passes)
            if backend in ("xla", "xla_radix2"):
                raise ValueError(
                    f"dft_passes selects a Pallas kernel decomposition; "
                    f"backend={backend!r} never runs the Pallas kernels")
            if dft_passes >= 5:
                alg = self._pallas_algorithm()
                if alg not in ("radix8dif_fused", "radix16dif_fused"):
                    raise ValueError(
                        f"dft_passes={dft_passes} (3-way split) requires the "
                        f"radix-8/16 DIF kernels; this shape selects {alg!r} "
                        f"(need n_fft % 1024 == 0 and hop_length % 128 == 0)")

    @classmethod
    def from_config(cls, config: dict, **overrides) -> "MelFrontend":
        """Build from a config dict's data section (full config or the
        section itself)."""
        dcfg = config.get("data", config)
        kwargs = dict(
            sample_rate=dcfg["sample_rate"],
            n_mels=dcfg["n_mels"],
            n_fft=dcfg["n_fft"],
            hop_length=dcfg["hop_length"],
            duration=dcfg["duration"],
            f_min=dcfg.get("f_min", 0.0),
            f_max=dcfg.get("f_max"),
            top_db=dcfg.get("top_db"),
        )
        kwargs.update(overrides)
        return cls(**kwargs)

    def _pallas_algorithm(self) -> str:
        """The JAX package's kernel choice for this shape (same policy and
        names as `ops/mel.py:497-531`)."""
        if self.pallas_algorithm is not None:
            return self.pallas_algorithm
        if self.n_fft % 4 == 0:
            if self.n_fft % self.hop_length == 0:
                if self.n_fft % 2048 == 0 and self.hop_length % 128 == 0:
                    return "radix16dif_fused"
                if self.n_fft % 1024 == 0 and self.hop_length % 128 == 0:
                    return "radix8dif_fused"
                if self.n_fft % 512 == 0 and self.hop_length % 128 == 0:
                    return "radix4dif_fused"
                if self.n_fft % 8 == 0 and self.hop_length % 512 == 0:
                    return "radix4_fused"
                if self.hop_length % 256 == 0:
                    return "radix2_fused"
            return "radix2"
        return "bf16x3"

    def uses_kernel(self, waveform: torch.Tensor) -> bool:
        """Whether this waveform goes to a front-end kernel: a CUDA tensor
        under backend "pallas", or under "auto" when the algorithm is a
        fused one (the JAX package's `_auto_pallas`). The one place the
        port decides it; `features_from_wavs` asks here too."""
        if not waveform.is_cuda:
            return False
        if self.backend == "pallas":
            return True
        return self.backend == "auto" and self._pallas_algorithm() in _FUSED_ALGORITHMS

    @property
    def num_frames(self) -> int:
        return stft_ops.num_frames(self.target_length, self.n_fft, self.hop_length)

    def log_mel(self, waveform: torch.Tensor) -> torch.Tensor:
        """Un-normalized log-mel (..., n_mels, T) — the point in the chain
        where SpecAugment applies."""
        if self.uses_kernel(waveform):
            return self._pallas_log_mel(waveform, normalize=False)
        return log_mel_spectrogram(
            waveform, self.sample_rate, self.n_fft, self.hop_length, self.n_mels,
            f_min=self.f_min, f_max=self.f_max, top_db=self.top_db,
            mel_scale=self.mel_scale, norm=self.norm,
        )

    def _pallas_log_mel(self, waveform: torch.Tensor, normalize: bool,
                        spec_mask_bounds: torch.Tensor | None = None) -> torch.Tensor:
        """The algorithm `_pallas_algorithm` names, with the per-example
        epilogue (top_db, the SpecAugment mask of `spec_mask_bounds` (B, 4),
        normalize) fused. On a CUDA tensor its kernel runs; on a CPU tensor
        the plain chain computes the same function. Bounds need a fused
        algorithm, as in the JAX package (`pallas_mel.py:1734-1738`)."""
        from audio_classification_icbhi_tpu_torch.ops import mel_kernels

        alg = self._pallas_algorithm()
        if alg not in PORTED_ALGORITHMS:
            raise ValueError(f"unknown algorithm {alg!r}")
        if spec_mask_bounds is not None and alg not in _FUSED_ALGORITHMS:
            raise ValueError("spec_mask_bounds requires a fused algorithm")
        lead = waveform.shape[:-1]
        out = mel_kernels.WRAPPERS[alg](
            waveform.reshape(-1, waveform.shape[-1]), self.sample_rate, self.n_fft,
            self.hop_length, self.n_mels, f_min=self.f_min, f_max=self.f_max,
            top_db=self.top_db, mel_scale=self.mel_scale, norm=self.norm,
            normalize=normalize, dft_passes=self.dft_passes,
            spec_mask_bounds=spec_mask_bounds,
        )
        return out.reshape(lead + out.shape[-2:])

    def __call__(self, waveform: torch.Tensor) -> torch.Tensor:
        if self.uses_kernel(waveform):
            return self._pallas_log_mel(waveform, normalize=self.normalize)
        mel = self.log_mel(waveform)
        if self.normalize:
            mel = normalize_spectrogram(mel)
        return mel

    def pad_or_crop(self, waveform: torch.Tensor) -> torch.Tensor:
        """Zero-pad at the end or center-crop the last axis to target_length."""
        length = waveform.shape[-1]
        if length < self.target_length:
            return torch.nn.functional.pad(waveform, (0, self.target_length - length))
        if length > self.target_length:
            start = (length - self.target_length) // 2
            return waveform[..., start : start + self.target_length]
        return waveform
