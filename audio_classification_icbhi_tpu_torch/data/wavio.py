"""WAV decode/encode and host-side resampling (numpy).

Port of `audio_classification_icbhi_tpu/data/wavio.py:29-190`: RIFF/WAVE
PCM 8/16/24/32 and IEEE float 32/64, including WAVE_FORMAT_EXTENSIBLE, and
the polyphase resampler. `load_audio` decodes through the native C++
decoder (`native.decode_mono`) where it builds and takes the file, else
through this module's numpy codec (`decode_mono_numpy`), which gives the
same samples bit for bit.

One difference from the JAX package's numpy fallback: an IEEE float64
file with two channels is mixed to mono in float64 and rounded once, as
the C++ decoder mixes it, where the JAX fallback rounds each channel to
float32 first (`read_wav`) and can land one ulp away.
"""

from __future__ import annotations

import math
import struct
from pathlib import Path

import numpy as np

from audio_classification_icbhi_tpu_torch import native
from audio_classification_icbhi_tpu_torch.ops.resample import _resample_kernel

_PCM_DTYPES = {8: np.uint8, 16: np.int16, 32: np.int32}


def read_wav(path: str | Path) -> tuple[np.ndarray, int]:
    """Decode a WAV file -> (float32 samples in [-1, 1] of shape (channels, n), sr)."""
    x, sr = _read_samples(path)
    return np.ascontiguousarray(x, dtype=np.float32), sr


def _read_samples(path: str | Path) -> tuple[np.ndarray, int]:
    """`read_wav` before the cast: (channels, n) samples in float32, or in
    float64 for an IEEE float64 file."""
    raw = Path(path).read_bytes()
    if len(raw) < 12 or raw[:4] != b"RIFF" or raw[8:12] != b"WAVE":
        raise ValueError(f"not a RIFF/WAVE file: {path}")
    pos = 12
    fmt = None
    data = None
    while pos + 8 <= len(raw):
        cid = raw[pos : pos + 4]
        (size,) = struct.unpack_from("<I", raw, pos + 4)
        body = raw[pos + 8 : pos + 8 + size]
        if len(body) < size:
            raise ValueError(
                f"truncated {cid!r} chunk (declares {size} bytes, "
                f"{len(body)} available): {path}"
            )
        if cid == b"fmt ":
            if len(body) < 16:
                raise ValueError(f"truncated fmt chunk ({len(body)} bytes): {path}")
            fmt = struct.unpack_from("<HHIIHH", body, 0)
            fmt_body = body  # the EXTENSIBLE sub-format sits at ITS offset 24
        elif cid == b"data":
            data = body
        pos += 8 + size + (size & 1)  # chunks are word-aligned
    if fmt is None or data is None:
        raise ValueError(f"missing fmt/data chunk: {path}")
    audio_format, channels, sr, _, _, bits = fmt
    if channels < 1:
        raise ValueError(f"malformed fmt chunk (channels={channels}): {path}")
    if audio_format == 0xFFFE:
        if len(fmt_body) < 26:
            raise ValueError(f"truncated EXTENSIBLE fmt chunk: {path}")
        (audio_format,) = struct.unpack_from("<H", fmt_body, 24)

    if audio_format == 1:  # PCM
        if bits == 24:
            b = np.frombuffer(data, dtype=np.uint8)
            n = len(b) // 3
            b = b[: n * 3].reshape(n, 3)
            vals = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
            x = vals.astype(np.float32) / float(1 << 23)
        elif bits in _PCM_DTYPES:
            v = np.frombuffer(data, dtype=_PCM_DTYPES[bits])
            if bits == 8:
                x = (v.astype(np.float32) - 128.0) / 128.0
            else:
                x = v.astype(np.float32) / float(1 << (bits - 1))
        else:
            raise ValueError(f"unsupported PCM bit depth {bits}: {path}")
    elif audio_format == 3:  # IEEE float
        x = np.frombuffer(data, dtype=np.float32 if bits == 32 else np.float64)
    else:
        raise ValueError(f"unsupported WAV format code {audio_format}: {path}")

    n = (len(x) // channels) * channels
    return x[:n].reshape(-1, channels).T, int(sr)


def decode_mono_numpy(path: str | Path) -> tuple[np.ndarray, int]:
    """The numpy codec's mono decode -> ((n,) float32, sr): the channels'
    mean, in float64 for a float64 file, as the C++ decoder takes it."""
    x, sr = _read_samples(path)
    mono = x.mean(axis=0) if x.shape[0] > 1 else x[0]
    return mono.astype(np.float32), sr


def pad_or_crop(x: np.ndarray, target_length: int) -> np.ndarray:
    """End-pad with zeros or center-crop to target_length."""
    n = x.shape[-1]
    if n < target_length:
        return np.pad(x, (0, target_length - n))
    if n > target_length:
        start = (n - target_length) // 2
        return x[start : start + target_length]
    return x


def write_wav(path: str | Path, samples: np.ndarray, sample_rate: int, *, dtype: str = "int16"):
    """Encode (n,) or (channels, n) float samples to a WAV file (PCM16 or float32)."""
    x = np.asarray(samples, dtype=np.float32)
    if x.ndim == 1:
        x = x[None]
    interleaved = x.T.reshape(-1)
    if dtype == "int16":
        payload = (np.clip(interleaved, -1.0, 1.0) * 32767.0).astype("<i2").tobytes()
        audio_format, bits = 1, 16
    elif dtype == "float32":
        payload = interleaved.astype("<f4").tobytes()
        audio_format, bits = 3, 32
    else:
        raise ValueError(f"unsupported dtype {dtype!r}")
    channels = x.shape[0]
    byte_rate = sample_rate * channels * bits // 8
    block_align = channels * bits // 8
    hdr = b"RIFF" + struct.pack("<I", 36 + len(payload)) + b"WAVE"
    hdr += b"fmt " + struct.pack(
        "<IHHIIHH", 16, audio_format, channels, sample_rate, byte_rate, block_align, bits
    )
    hdr += b"data" + struct.pack("<I", len(payload))
    Path(path).write_bytes(hdr + payload)


def resample_np(x: np.ndarray, orig_freq: int, new_freq: int) -> np.ndarray:
    """Polyphase resample of x (..., L) float32, torchaudio sinc_interp_hann
    defaults (lowpass_filter_width 6, rolloff 0.99); output length
    ceil(new·L/orig) after gcd reduction."""
    if orig_freq == new_freq:
        return x
    g = math.gcd(int(orig_freq), int(new_freq))
    og, ng = orig_freq // g, new_freq // g
    kernel, width = _resample_kernel(og, ng, 6, 0.99)  # (ng, 1, K)
    kernel = kernel[:, 0, :]  # (ng, K)
    k = kernel.shape[1]
    lead = x.shape[:-1]
    length = x.shape[-1]
    xf = x.reshape(-1, length).astype(np.float32)
    xp = np.pad(xf, [(0, 0), (width, width + og)])
    n_out_blocks = (xp.shape[1] - k) // og + 1
    sv = np.lib.stride_tricks.as_strided(
        xp,
        shape=(xp.shape[0], n_out_blocks, k),
        strides=(xp.strides[0], xp.strides[1] * og, xp.strides[1]),
        writeable=False,
    )
    y = np.einsum("bnk,pk->bnp", sv, kernel, optimize=True)  # (batch, blocks, ng)
    y = y.reshape(xp.shape[0], -1)
    target = math.ceil(ng * length / og)
    return y[:, :target].reshape(lead + (target,)).astype(np.float32)


def load_audio(path: str | Path, target_sr: int | None = None) -> tuple[np.ndarray, int]:
    """Decode -> mono mix -> optional resample. Returns ((n,) float32, sr).
    The native decoder decodes where it can, the numpy codec elsewhere;
    `native.ROWS` counts which."""
    decoded = native.decode_mono(path)
    if decoded is not None:
        mono, sr = decoded
        native.ROWS.add(native=1)
    else:
        mono, sr = decode_mono_numpy(path)
        native.ROWS.add(numpy=1)
    if target_sr is not None and sr != target_sr:
        mono = resample_np(mono, sr, target_sr)
        sr = target_sr
    return mono.astype(np.float32), sr
