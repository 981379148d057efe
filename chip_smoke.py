#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA device and the CUDA
toolkit. Phases:

1. the card: name and power limit (nvidia-smi), torch and CUDA versions;
2. the build: every kernel under audio_classification_icbhi_tpu_torch/csrc;
3. each kernel against its plain torch version (float64) on the card;
4. the log-mel kernel against the float64 golden on the parity battery;
5. the serving path through ClassifierEngine(device="cuda"): predict_probs,
   classify_wave and classify_files, held against the same engine on the
   CPU, with every kernel's launch count read around the run;
6. timings: kernel, plain version and a PyTorch yardstick by CUDA events;
   wav -> logits clips/s at batch 128 and single-clip latency by the host
   clock; device time by kernel over a short profiler trace.

Every failed check raises, and the script exits non-zero without printing a
result. The line before the last lists the kernels as JSON; the last line is
{"ok": true, "device": {...}}. No CUDA device: exit 1.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from audio_classification_icbhi_tpu_torch.data.wavio import write_wav
from audio_classification_icbhi_tpu_torch.inference import ClassifierEngine
from audio_classification_icbhi_tpu_torch.models import build_model
from audio_classification_icbhi_tpu_torch.models.weights import flax_from_state_dict
from audio_classification_icbhi_tpu_torch.ops import _build, mel_kernels
from audio_classification_icbhi_tpu_torch.ops.golden import golden_mel, parity_battery
from audio_classification_icbhi_tpu_torch.ops.mel import mel_filterbank
from audio_classification_icbhi_tpu_torch.parallel.data_parallel import features_from_wavs
from audio_classification_icbhi_tpu_torch.utils.checkpoint import save_checkpoint
from audio_classification_icbhi_tpu_torch.utils.config import load_config, set_seed

SR, N_FFT, HOP, N_MELS = 16000, 2048, 512, 128
BATCH, CLIP = 128, 5 * SR
# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, f32 CUDA-core FLOP/s
HBM_BYTES_PER_S, F32_FLOPS = 3.35e12, 67e12


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds per call over `iters` back-to-back calls, by CUDA
    events, after `warmup` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def log_mel_bound_ms(batch: int, length: int, nnz: int) -> dict[str, float]:
    """Least times for the log-mel function at this shape, in ms: "bytes"
    (padded waveform read once, output written once) over HBM bandwidth,
    "operations" (f32) over the CUDA-core peak, and "bytes_with_scratch",
    the two-pass design's own floor, which also writes and reads back its
    (B, T, n_mels) dB scratch. Operations: 5·N·log2(N) per N-point complex
    FFT, one complex FFT per two real frames; 3 per power bin; 2 per mel
    weight; 5 per output cell."""
    t = 1 + length // HOP
    out_bytes = 4 * batch * N_MELS * t
    bytes_moved = 4 * batch * (length + N_FFT) + out_bytes
    frames = batch * t
    flops = (frames / 2 * 5 * N_FFT * math.log2(N_FFT)
             + frames * (3 * (N_FFT // 2 + 1) + 2 * nnz) + 5 * frames * N_MELS)
    return {"bytes": bytes_moved / HBM_BYTES_PER_S * 1e3,
            "operations": flops / F32_FLOPS * 1e3,
            "bytes_with_scratch": (bytes_moved + 2 * out_bytes) / HBM_BYTES_PER_S * 1e3}


def synth_clips(rng: np.random.Generator, n: int) -> np.ndarray:
    """(n, CLIP) float32 clips: breath-like noise with a tone and clicks."""
    t = np.arange(CLIP) / SR
    noise = 0.05 * rng.standard_normal((n, CLIP))
    tone = (0.2 * rng.random((n, 1))) * np.sin(2 * np.pi * rng.uniform(100, 1500, (n, 1)) * t)
    clicks = np.where(rng.random((n, CLIP)) < 2e-4, rng.standard_normal((n, CLIP)), 0.0)
    return (noise + tone + clicks).astype(np.float32)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    # Phase 1: the card
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"phase 1: {kind}; torch {torch.__version__}; CUDA {torch.version.cuda}; "
          f"{torch.cuda.device_count()} device(s)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("phase 1: TF32 off for matmuls and cuDNN (references compute in full f32/f64)")

    # Phase 2: the build
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"phase 2: built {sorted(built)} in {time.perf_counter() - t0:.1f} s")
    for name, (path, log) in built.items():
        print(f"phase 2: {name} -> {path}\n{log.strip()}")

    # Phase 3: kernel vs its plain version (f64) on the card
    errs = []
    for b, length in ((BATCH, CLIP), (3, 16320)):
        x = (0.1 * rng.standard_normal((b, length))).astype(np.float32)
        x[1] *= 20.0  # one loud example: the epilogue is per example
        xt = torch.from_numpy(x).to(dev)
        for kw, tol in (({}, 1e-3), (dict(top_db=60.0, normalize=True), 2e-3)):
            got = mel_kernels.log_mel_radix16dif_fused(xt, SR, N_FFT, HOP, N_MELS, **kw)
            want = mel_kernels.log_mel_radix16dif_fused_reference(
                xt.double(), SR, N_FFT, HOP, N_MELS, **kw)
            torch.cuda.synchronize()
            check(got.shape == (b, N_MELS, 1 + length // HOP), f"shape {tuple(got.shape)}")
            check(bool(torch.isfinite(got).all()), "finite kernel output")
            err = (got.double() - want).abs().max().item()
            errs.append(err)
            print(f"phase 3: log_mel_radix16dif_fused B={b} L={length} {kw or 'dB'}: "
                  f"max|kernel - plain f64| = {err:.3e} (tol {tol:g})")
            check(err <= tol, f"kernel vs plain at B={b} L={length} {kw}")

    # Phase 4: kernel vs the float64 golden on the parity battery
    for duration in (5.0, 1.0):
        wavs = parity_battery(int(SR * duration))
        want = np.stack([golden_mel(w, SR, N_FFT, HOP, N_MELS) for w in wavs])
        got = mel_kernels.log_mel_radix16dif_fused(
            torch.from_numpy(wavs).to(dev), SR, N_FFT, HOP, N_MELS).double().cpu().numpy()
        err = float(np.abs(got - want).max())
        print(f"phase 4: golden {duration:g} s: max|kernel - f64 golden| = {err:.3e} dB (tol 1e-3)")
        check(err <= 1e-3, f"kernel vs golden at {duration} s")

    # Phase 5: the serving path through the user's entry point
    with tempfile.TemporaryDirectory() as tmp:
        def write_checkpoint(name: str, mixed_precision: bool, head_scale: float) -> Path:
            cfg = load_config()
            cfg["data"]["duration"] = 5.0
            cfg["training"]["mixed_precision"] = mixed_precision
            sd = build_model(cfg, generator=set_seed(cfg["seed"])).state_dict()
            for k in ("fc1.weight", "fc2.weight"):
                sd[k] = sd[k] * head_scale
            return save_checkpoint(Path(tmp) / name, {
                "epoch": 0, **flax_from_state_dict(sd), "val_loss": 0.0, "config": cfg})

        ckpt = write_checkpoint("serve.ckpt", mixed_precision=True, head_scale=1.0)
        clips = synth_clips(rng, BATCH)
        paths = []
        for i in range(3):
            paths.append(Path(tmp) / f"clip{i}.wav")
            write_wav(paths[-1], clips[i, ::2], SR // 2)  # 8 kHz files, resampled on load

        mel_kernels.log_mel_radix16dif_fused.launches = 0
        engine = ClassifierEngine(ckpt, batch_size=BATCH, device="cuda")
        probs = engine.predict_probs(clips)
        one = engine.classify_wave(clips[0])
        files = engine.classify_files(paths)
        torch.cuda.synchronize()
        launches = {"log_mel_radix16dif_fused": mel_kernels.log_mel_radix16dif_fused.launches}
        print(f"phase 5: main path launches {launches}")
        check(all(n > 0 for n in launches.values()), "every kernel launched on the main path")

        check(probs.shape == (BATCH, 4) and bool(np.isfinite(probs).all()), "probs shape/finite")
        check(bool(np.allclose(probs.sum(-1), 1.0, atol=1e-4)), "probs sum to 1")
        check(len(files) == 3 and set(one) == {"predicted_class", "confidence", "probabilities"},
              "classify_wave / classify_files schema")
        p1 = np.array(list(one["probabilities"].values()))
        err_one = float(np.abs(p1 - probs[0]).max())
        check(err_one <= 5e-3, f"classify_wave vs predict_probs ({err_one:.2e})")
        cpu_probs = ClassifierEngine(ckpt, batch_size=BATCH, device="cpu").predict_probs(clips)
        err_cpu = float(np.abs(probs - cpu_probs).max())
        print(f"phase 5: predict_probs on {BATCH} clips, seeded init, bf16 CNN: max|cuda - cpu| = "
              f"{err_cpu:.3e} (tol 5e-3); classify_wave vs batch row {err_one:.3e}")
        check(err_cpu <= 5e-3, "engine probabilities on cuda vs cpu (bf16)")
        for r in files:
            print(f"phase 5: classify_files {Path(r['audio_path']).name}: "
                  f"{r['predicted_class']} {r['confidence']:.4f}")

        # The same path in f32 with a 30x heavier head, so that the class
        # probabilities spread: bf16 rounding then no longer hides behind
        # near-uniform rows, and the CUDA path must match the CPU to 1e-4.
        ckpt32 = write_checkpoint("f32.ckpt", mixed_precision=False, head_scale=30.0)
        p32 = ClassifierEngine(ckpt32, batch_size=BATCH, device="cuda").predict_probs(clips)
        c32 = ClassifierEngine(ckpt32, batch_size=BATCH, device="cpu").predict_probs(clips)
        err32 = float(np.abs(p32 - c32).max())
        print(f"phase 5: f32 engine, 30x head: max|cuda - cpu| = {err32:.3e} (tol 1e-4); "
              f"class histogram {np.bincount(p32.argmax(-1), minlength=4).tolist()}")
        check(err32 <= 1e-4, "engine probabilities on cuda vs cpu (f32)")

    # Phase 6: timings at the serving shape (128 clips of 5 s)
    x = torch.from_numpy(synth_clips(rng, BATCH)).to(dev)
    kw = dict(normalize=True)
    nnz = mel_kernels._constants(SR, N_FFT, N_MELS, 0.0, SR / 2.0, "htk", None, x.device)[4].numel()
    floors = log_mel_bound_ms(BATCH, CLIP, nnz)
    bound_by = max(("bytes", "operations"), key=floors.get)
    bound_ms = floors[bound_by]
    kernel_ms = cuda_ms(lambda: mel_kernels.log_mel_radix16dif_fused(
        x, SR, N_FFT, HOP, N_MELS, **kw), iters=50)
    plain_ms = cuda_ms(lambda: mel_kernels.log_mel_radix16dif_fused_reference(
        x, SR, N_FFT, HOP, N_MELS, **kw), iters=10)
    window = torch.hann_window(N_FFT, device=dev)
    fb = mel_filterbank(SR, N_FFT, N_MELS, device=dev)

    def library():  # yardstick only: torch.stft + mel matmul + dB + normalize
        spec = torch.stft(x, N_FFT, HOP, window=window, center=True, pad_mode="reflect",
                          return_complex=True).abs() ** 2
        db = 10.0 * torch.log10(torch.clamp(fb.T @ spec, min=1e-10))
        mean = db.mean(dim=(1, 2), keepdim=True)
        return (db - mean) / (db.std(dim=(1, 2), keepdim=True) + 1e-8)

    library_ms = cuda_ms(library, iters=20)
    print(f"phase 6: [{card}] log_mel_radix16dif_fused B={BATCH} x 5 s: kernel {kernel_ms:.4f} ms, "
          f"plain f32 {plain_ms:.4f} ms, torch.stft yardstick {library_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by}; bytes {floors['bytes']:.4f}, operations "
          f"{floors['operations']:.4f}, bytes with the dB scratch "
          f"{floors['bytes_with_scratch']:.4f})")

    with torch.inference_mode():
        def wav_to_logits():
            return engine.model(features_from_wavs(engine.frontend, x))

        for _ in range(3):
            wav_to_logits()
        torch.cuda.synchronize()
        reps = 20
        t0 = time.perf_counter()
        for _ in range(reps):
            logits = wav_to_logits()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    check(bool(torch.isfinite(logits).all()), "finite logits")
    print(f"phase 6: [{card}] wav->logits batch {BATCH}, bf16 CNN: "
          f"{BATCH * reps / dt:.1f} clips/s ({dt / reps * 1e3:.3f} ms per batch)")

    # classify_wave ends in a device->host copy, so the host clock sees the
    # whole request: host clip in, result dict out.
    host_clip = x[0].cpu().numpy()
    engine.warmup_latency()
    lat_ms = []
    for _ in range(50):
        t0 = time.perf_counter()
        engine.classify_wave(host_clip)
        lat_ms.append((time.perf_counter() - t0) * 1e3)
    print(f"phase 6: [{card}] classify_wave, batch 1, host clip in: median "
          f"{np.median(lat_ms):.3f} ms, p90 {np.percentile(lat_ms, 90):.3f} ms over 50 calls")

    # Where a wav->logits step spends device time: kernels by name over a
    # short traced window, and the device's busy share of that window.
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    steps = 5
    with torch.inference_mode(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            wav_to_logits()
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    device_kernels = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                            key=lambda e: -e.self_device_time_total)
    busy_us = sum(e.self_device_time_total for e in device_kernels)
    print(f"phase 6: [{card}] traced {steps} steps: device busy {busy_us / steps:.1f} us/step "
          f"of {window_us / steps:.1f} us/step wall ({100 * busy_us / window_us:.1f}%)")
    for e in device_kernels[:12]:
        print(f"phase 6:   {e.self_device_time_total / steps:9.1f} us/step "
              f"{e.count // steps:3d}x  {e.key[:90]}")

    print(json.dumps({"kernels": [{
        "name": "log_mel_radix16dif_fused",
        "route": "cuda",
        "source": "audio_classification_icbhi_tpu_torch/csrc/log_mel_radix16dif.cu",
        "replaces": "audio_classification_icbhi_tpu/ops/pallas_mel.py:1270",
        "launches": launches["log_mel_radix16dif_fused"],
        "max_abs_err": max(errs),
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
