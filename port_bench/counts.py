"""The yardstick's arithmetic: the card's published peaks, the log-mel
function's least time, and the operations of the models' steps.

Nothing here reads the program: the filterbank's non-zeros are computed
from the HTK formula itself, and the model FLOPs from the layer shapes
(`reference/<architecture>.py`).
"""

from __future__ import annotations

import math

import numpy as np

# NVIDIA H100 SXM, dense rates, at its full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12


def htk_filterbank(sr: int, n_fft: int, n_mels: int) -> np.ndarray:
    """(n_fft // 2 + 1, n_mels) float64 HTK triangles from 0 to sr / 2,
    unnormalised: the front end's mel projection."""
    def h2m(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)

    def m2h(m):
        return 700.0 * (10 ** (m / 2595.0) - 1.0)

    freqs = np.linspace(0, sr / 2, n_fft // 2 + 1)
    pts = m2h(np.linspace(h2m(0.0), h2m(sr / 2), n_mels + 2))
    fb = np.zeros((n_fft // 2 + 1, n_mels))
    for m in range(n_mels):
        lo, cen, hi = pts[m], pts[m + 1], pts[m + 2]
        fb[:, m] = np.maximum(0, np.minimum((freqs - lo) / (cen - lo), (hi - freqs) / (hi - cen)))
    return fb


def mel_nnz(sr: int, n_fft: int, n_mels: int) -> int:
    """The filterbank's non-zero weights: the multiply-adds a mel
    projection needs per frame."""
    return int(np.count_nonzero(htk_filterbank(sr, n_fft, n_mels)))


def log_mel_bound_s(batch: int, length: int, sr: int, n_fft: int, hop: int,
                    n_mels: int) -> dict[str, float]:
    """Least seconds for the log-mel function on (batch, length) f32
    waveforms: "bytes", the waveform read once and the (batch, n_mels, T)
    f32 image written once, over HBM bandwidth; "operations", f32, over the
    CUDA-core peak: 5·N·log2(N) per N-point complex FFT, one complex FFT per
    two real frames, 3 per power bin, 2 per mel weight, 5 per output cell.
    Copied from `chip_smoke.log_mel_bound_ms` (chip_smoke.py:436-456), with
    the non-zeros from `mel_nnz` in place of the port's `mel_bands`."""
    t = 1 + length // hop
    out_bytes = 4 * batch * n_mels * t
    bytes_moved = 4 * batch * length + out_bytes
    frames = batch * t
    flops = (frames / 2 * 5 * n_fft * math.log2(n_fft)
             + frames * (3 * (n_fft // 2 + 1) + 2 * mel_nnz(sr, n_fft, n_mels))
             + 5 * frames * n_mels)
    return {"bytes": bytes_moved / HBM_BYTES_PER_S, "operations": flops / F32_FLOPS}


def conv_out(n: int, k: int, s: int, p: int) -> int:
    """A convolution's output size (copied from chip_smoke.py:2922)."""
    return (n + 2 * p - k) // s + 1


def train_gflop(forward_gflop: float, first_layer_gflop: float) -> float:
    """GFLOP of one clip's forward and backward: the forward, then twice
    its products for the input and the weight gradients, less the first
    layer's input gradient, which no one needs (the input is data)."""
    return 3 * forward_gflop - first_layer_gflop


def model_gflop(config: dict) -> tuple[float, float]:
    """(forward, forward and backward) GFLOP of one clip of the config's
    model at its front end's shape."""
    import importlib

    data = config["data"]
    arch = importlib.import_module(f"port_bench.reference.{config['model']['architecture']}")
    h = data["n_mels"]
    w = 1 + int(data["sample_rate"] * data["duration"]) // data["hop_length"]
    fwd = arch.forward_gflop(h, w, config["model"]["num_classes"])
    return fwd, train_gflop(fwd, arch.first_layer_gflop(h, w))


def peak_flops(config: dict) -> float:
    """The card's dense peak at the precision the config computes in."""
    tcfg = config["training"]
    precision = tcfg.get("precision") or ("bf16" if tcfg.get("mixed_precision") else "fp32")
    return BF16_FLOPS if precision in ("bf16", "fp16") else F32_FLOPS


def log_mel_share(config: dict, rows: int, ms: float) -> float:
    """Percent of the log-mel function's least time at (rows, clip
    length) that a call taking `ms` reaches."""
    data = config["data"]
    bound = log_mel_bound_s(rows, int(data["sample_rate"] * data["duration"]),
                            data["sample_rate"], data["n_fft"], data["hop_length"],
                            data["n_mels"])
    return 100.0 * max(bound.values()) * 1e3 / ms
