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
   clock; device time by kernel over a short profiler trace;
7. the training form of the log-mel kernel (SpecAugment bounds) against its
   plain version in float64, edge bounds included;
8. one train step on the card against the same step on the CPU, at
   config.yaml's shapes with batch 8 x accumulation 2: same weights, same
   injected augmentation draws, fp32, dropout inert; and a bf16 step;
9. the training path through its entry point: a synthetic corpus, 2 epochs
   of `audio_classification_icbhi_tpu_torch.train` at config.yaml with the
   launch counts read around it, a resumed third epoch as a subprocess, and
   the best checkpoint served by ClassifierEngine(device="cuda");
10. training timings: the masked kernel at 64 x 8 s beside its bound and
   yardstick, the train step at config.yaml, a profiler split of one step,
   and an epoch's wall time and device share beside the loader alone and
   validation, on a corpus of ICBHI's split sizes;
11. the radix-8 log-mel kernel (n_fft 1024, hop 256: the analyzer's
   sub-second windows), both forms, against its plain version (float64) at
   the analyzer's shapes and against the float64 golden; the routing repair
   (radix2 and bf16x3 shapes run the plain chain on the card, no kernel);
12. the analyzers through their entry point (`analyze`, all five variants)
   on a 15 s recording with phase 9's trained checkpoint at 0.25, 0.5 and
   1 s windows, the launch counts read around each run, the card's window
   probabilities against the CPU's; and one training epoch at a sub-second
   front end (n_fft 1024), which runs the radix-8 kernel's masked form;
13. analyzer timings: the radix-8 kernel at 64 and 2,400 windows of 0.5 s
   and its masked form at 64 x 8 s, beside bound, plain version and
   yardstick; the warm time of one 15 s recording; windows/s over a
   10-minute recording (2,400 windows) and a profiler split of that pass;
14. the fused conv-block kernels (blocks 1, 1 batched, 2 and 3) against
   their plain versions on the card, in bf16 (one bf16 ulp), at the serving
   shapes and odd ones; `fused_kernels_available()`; the fused apply on the
   card against itself on the CPU and against the model's cuDNN forward;
   each kernel timed beside its bound, plain version and the port's cuDNN
   ConvBlock as yardstick;
15. the opt-in `ICBHI_FUSED_CNN=1` through the entry points: the serving
   engine (predict_probs, classify_wave, classify_files) and `analyze.main`
   at 0.5 s windows, the launch counts read around each run, the
   probabilities held against the same engines without the switch; wav ->
   logits clips/s and classify_wave latency with and without the switch,
   and a profiler split of the fused step.

Every failed check raises, and the script exits non-zero without printing a
result. The line before the last lists the kernels as JSON; the last line is
{"ok": true, "device": {...}}. No CUDA device: exit 1.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from audio_classification_icbhi_tpu_torch import analyze
from audio_classification_icbhi_tpu_torch import train as train_entry
from audio_classification_icbhi_tpu_torch.analyzers import AnalyzerEngine
from audio_classification_icbhi_tpu_torch.data.dataset import ICBHIDataset
from audio_classification_icbhi_tpu_torch.data.synthetic import (
    generate_icbhi_dataset,
    synth_respiratory_cycle,
)
from audio_classification_icbhi_tpu_torch.data.wavio import write_wav
from audio_classification_icbhi_tpu_torch.inference import ClassifierEngine
from audio_classification_icbhi_tpu_torch.models import (
    LightweightCNN,
    build_model,
    fused_kernels_available,
    make_fused_apply,
)
from audio_classification_icbhi_tpu_torch.models import fused_infer
from audio_classification_icbhi_tpu_torch.models.weights import flax_from_state_dict
from audio_classification_icbhi_tpu_torch.ops import _build, mel_kernels
from audio_classification_icbhi_tpu_torch.ops import conv_kernels as ck
from audio_classification_icbhi_tpu_torch.ops import augment as aug
from audio_classification_icbhi_tpu_torch.ops.golden import golden_mel, parity_battery
from audio_classification_icbhi_tpu_torch.ops.mel import MelFrontend, mel_filterbank
from audio_classification_icbhi_tpu_torch.parallel.data_parallel import (
    features_from_wavs,
    make_step_fns,
)
from audio_classification_icbhi_tpu_torch.training.optimizers import build_optimizer
from audio_classification_icbhi_tpu_torch.training.trainer import Trainer
from audio_classification_icbhi_tpu_torch.utils.checkpoint import save_checkpoint
from audio_classification_icbhi_tpu_torch.utils.config import load_config, set_seed

REPO = Path(__file__).resolve().parent
SR, N_FFT, HOP, N_MELS = 16000, 2048, 512, 128
BATCH, CLIP = 128, 5 * SR
TRAIN_CLIP = 8 * SR  # config.yaml: 8 s clips, batch 32 x accumulation 2
N_RECORDINGS = 920   # ICBHI's whole-recording split, 644/138/138: 10 optimizer steps an epoch
N_FFT8, HOP8 = 1024, 256  # the analyzer's front end for windows under 1 s (radix-8 kernel)
WINDOW = SR // 2          # the analyzer's 0.5 s window
# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, f32 CUDA-core
# FLOP/s, dense bf16 tensor-core FLOP/s
HBM_BYTES_PER_S, F32_FLOPS, BF16_FLOPS = 3.35e12, 67e12, 989e12


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


def log_mel_bound_ms(batch: int, length: int, nnz: int, n_fft: int = N_FFT, hop: int = HOP,
                     n_mels: int = N_MELS) -> dict[str, float]:
    """Least times for the log-mel function at this shape, in ms: "bytes"
    (padded waveform read once, output written once) over HBM bandwidth,
    "operations" (f32) over the CUDA-core peak, and "bytes_with_scratch",
    the two-pass design's own floor, which also writes and reads back its
    (B, T, n_mels) dB scratch. Operations: 5·N·log2(N) per N-point complex
    FFT, one complex FFT per two real frames; 3 per power bin; 2 per mel
    weight; 5 per output cell. The training form also reads (B, 4) bounds,
    16 bytes an example, which this counts in neither form (< 0.01 %).
    Both kernels compute this one function, so it bounds both."""
    t = 1 + length // hop
    out_bytes = 4 * batch * n_mels * t
    bytes_moved = 4 * batch * (length + n_fft) + out_bytes
    frames = batch * t
    flops = (frames / 2 * 5 * n_fft * math.log2(n_fft)
             + frames * (3 * (n_fft // 2 + 1) + 2 * nnz) + 5 * frames * n_mels)
    return {"bytes": bytes_moved / HBM_BYTES_PER_S * 1e3,
            "operations": flops / F32_FLOPS * 1e3,
            "bytes_with_scratch": (bytes_moved + 2 * out_bytes) / HBM_BYTES_PER_S * 1e3}


def bound(batch: int, length: int, device, n_fft: int = N_FFT,
          hop: int = HOP) -> tuple[float, str, dict[str, float]]:
    nnz = mel_kernels.mel_bands(SR, n_fft, N_MELS, 0.0, SR / 2.0, "htk", None, device)[2].numel()
    floors = log_mel_bound_ms(batch, length, nnz, n_fft, hop)
    bound_by = max(("bytes", "operations"), key=floors.get)
    return floors[bound_by], bound_by, floors


def yardstick(x: torch.Tensor, n_fft: int, hop: int, bounds: torch.Tensor | None = None):
    """The library call timed beside a kernel (the port never calls it):
    torch.stft + mel matmul + dB + [mask] + normalize, on the same inputs."""
    window = torch.hann_window(n_fft, device=x.device)
    fb = mel_filterbank(SR, n_fft, N_MELS, device=x.device)

    def library():
        spec = torch.stft(x, n_fft, hop, window=window, center=True, pad_mode="reflect",
                          return_complex=True).abs() ** 2
        db = 10.0 * torch.log10(torch.clamp(fb.T @ spec, min=1e-10))
        if bounds is not None:
            db = aug.mask_from_bounds(db, bounds)
        mean = db.mean(dim=(1, 2), keepdim=True)
        return (db - mean) / (db.std(dim=(1, 2), keepdim=True) + 1e-8)

    return library


def edge_bounds(batch: int, n_frames: int, generator: torch.Generator) -> torch.Tensor:
    """(B, 4) SpecAugment bounds drawn as the train step draws them, with
    the first three rows at the edges: a zero width, a mel band past
    n_mels, a time band past the last frame."""
    b = aug.spec_mask_bounds(aug.draw_spectrogram(generator, batch, N_MELS, n_frames, "cpu"))
    b[0] = torch.tensor([3.0, 0.0, 10.0, 5.0])
    b[1] = torch.tensor([120.0, 15.0, n_frames - 4.0, 30.0])
    b[2] = torch.tensor([5.0, 7.0, n_frames + 8.0, 3.0])
    return b


def seeded_checkpoint(path: Path, mixed_precision: bool, head_scale: float,
                      duration: float = 5.0) -> Path:
    """A checkpoint at config's defaults (16 kHz, 128 mels, 2048/512) with
    weights from the config's seed; head_scale > 1 spreads the classes."""
    cfg = load_config()
    cfg["data"]["duration"] = duration
    cfg["training"]["mixed_precision"] = mixed_precision
    sd = build_model(cfg, generator=set_seed(cfg["seed"])).state_dict()
    for k in ("fc1.weight", "fc2.weight"):
        sd[k] = sd[k] * head_scale
    return save_checkpoint(path, {
        "epoch": 0, **flax_from_state_dict(sd), "val_loss": 0.0, "config": cfg})


def draws_to(d: aug.AugmentDraws, device) -> aug.AugmentDraws:
    return aug.AugmentDraws(aug.WaveDraws(*(t.to(device) for t in d.wave)),
                            aug.SpecDraws(*(t.to(device) for t in d.spec)))


def trace_device(fn, steps: int) -> tuple[list, float, float]:
    """Run fn `steps` times under torch.profiler: (device kernels sorted by
    time, device-busy µs as the sum of kernel times, wall µs)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device kernels only: a record_function range (torch.optim's
    # "Optimizer.step#Adam.step") also shows on the device as an annotation
    kernels = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                      and not getattr(e, "is_user_annotation", False)
                      and not e.key.startswith("Optimizer.")),
                     key=lambda e: -e.self_device_time_total)
    return kernels, sum(e.self_device_time_total for e in kernels), wall_us


def synth_clips(rng: np.random.Generator, n: int, length: int = CLIP) -> np.ndarray:
    """(n, length) float32 clips: breath-like noise with a tone and clicks."""
    t = np.arange(length) / SR
    noise = 0.05 * rng.standard_normal((n, length))
    tone = (0.2 * rng.random((n, 1))) * np.sin(2 * np.pi * rng.uniform(100, 1500, (n, 1)) * t)
    clicks = np.where(rng.random((n, length)) < 2e-4, rng.standard_normal((n, length)), 0.0)
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
            want = mel_kernels.log_mel_fused_reference(
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
        ckpt = seeded_checkpoint(Path(tmp) / "serve.ckpt", mixed_precision=True, head_scale=1.0)
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
        ckpt32 = seeded_checkpoint(Path(tmp) / "f32.ckpt", mixed_precision=False,
                                   head_scale=30.0)
        p32 = ClassifierEngine(ckpt32, batch_size=BATCH, device="cuda").predict_probs(clips)
        c32 = ClassifierEngine(ckpt32, batch_size=BATCH, device="cpu").predict_probs(clips)
        err32 = float(np.abs(p32 - c32).max())
        print(f"phase 5: f32 engine, 30x head: max|cuda - cpu| = {err32:.3e} (tol 1e-4); "
              f"class histogram {np.bincount(p32.argmax(-1), minlength=4).tolist()}")
        check(err32 <= 1e-4, "engine probabilities on cuda vs cpu (f32)")

    # Phase 6: timings at the serving shape (128 clips of 5 s)
    x = torch.from_numpy(synth_clips(rng, BATCH)).to(dev)
    kw = dict(normalize=True)
    bound_ms, bound_by, floors = bound(BATCH, CLIP, x.device)
    kernel_ms = cuda_ms(lambda: mel_kernels.log_mel_radix16dif_fused(
        x, SR, N_FFT, HOP, N_MELS, **kw), iters=50)
    plain_ms = cuda_ms(lambda: mel_kernels.log_mel_fused_reference(
        x, SR, N_FFT, HOP, N_MELS, **kw), iters=10)
    library_ms = cuda_ms(yardstick(x, N_FFT, HOP), iters=20)
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
    steps = 5
    with torch.inference_mode():
        device_kernels, busy_us, window_us = trace_device(wav_to_logits, steps)
    print(f"phase 6: [{card}] traced {steps} steps: device busy {busy_us / steps:.1f} us/step "
          f"of {window_us / steps:.1f} us/step wall ({100 * busy_us / window_us:.1f}%)")
    for e in device_kernels[:12]:
        print(f"phase 6:   {e.self_device_time_total / steps:9.1f} us/step "
              f"{e.count // steps:3d}x  {e.key[:90]}")
    serving = {"launches": launches["log_mel_radix16dif_fused"], "max_abs_err": max(errs),
               "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "library_ms": library_ms}

    masked_err = phase7_masked_kernel(dev, rng)
    phase8_train_step(dev, rng)
    with tempfile.TemporaryDirectory() as tmp:
        corpus, masked_launches = phase9_trainer(Path(tmp), card)
        training = phase10_timings(dev, rng, card, corpus, Path(tmp))
        r8_err, r8_masked_err = phase11_radix8_kernel(dev, rng)
        recording, r8_launches = phase12_analyzer(Path(tmp), corpus, card)
        r8, r8_masked = phase13_analyzer_timings(dev, rng, card, Path(tmp), recording)
        conv_rows = phase14_conv_kernels(dev, rng, card)
        conv_launches = phase15_fused_cnn(dev, rng, card, Path(tmp), recording)
    for name, numbers in conv_rows.items():
        numbers["launches"] = sum(conv_launches[k] for k in CONV_ROWS[name][2])
    training.update(launches=masked_launches, max_abs_err=masked_err)
    r8.update(launches=r8_launches["inference"], max_abs_err=r8_err)
    r8_masked.update(launches=r8_launches["masked"], max_abs_err=r8_masked_err)

    csrc = "audio_classification_icbhi_tpu_torch/csrc/"
    pallas_mel = "audio_classification_icbhi_tpu/ops/pallas_mel.py"
    rows = (("log_mel_radix16dif_fused", "log_mel_radix16dif.cu", ":1270", serving),
            ("log_mel_radix16dif_fused_masked", "log_mel_radix16dif.cu", ":1270", training),
            ("log_mel_radix8dif_fused", "log_mel_radix8dif.cu", ":1193", r8),
            ("log_mel_radix8dif_fused_masked", "log_mel_radix8dif.cu", ":1193", r8_masked))
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": csrc + source, "replaces": pallas_mel + line,
         **{k: numbers[k] for k in serving}}
        for name, source, line, numbers in rows]
        + [{"name": name, "route": "cuda", "source": csrc + source,
            "replaces": "audio_classification_icbhi_tpu/ops/pallas_conv.py" + line,
            **{k: conv_rows[name][k] for k in serving}}
           for name, (source, line, _) in CONV_ROWS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


def phase7_masked_kernel(dev, rng) -> float:
    """The training form against its plain version in float64, at the train
    step's front-end batch (64 x 8 s) and at an odd shape."""
    errs = []
    gen = torch.Generator().manual_seed(7)
    before = mel_kernels.log_mel_radix16dif_fused.launches_masked
    calls = 0
    for b, length in ((64, TRAIN_CLIP), (3, 16320)):
        t = 1 + length // HOP
        x = (0.1 * rng.standard_normal((b, length))).astype(np.float32)
        x[1] *= 20.0
        xt = torch.from_numpy(x).to(dev)
        bounds = edge_bounds(b, t, gen).to(dev)
        for kw, tol in (({}, 1e-3), (dict(top_db=60.0, normalize=True), 2e-3)):
            got = mel_kernels.log_mel_radix16dif_fused(xt, SR, N_FFT, HOP, N_MELS,
                                                       spec_mask_bounds=bounds, **kw)
            calls += 1
            want = mel_kernels.log_mel_fused_reference(
                xt.double(), SR, N_FFT, HOP, N_MELS, spec_mask_bounds=bounds, **kw)
            torch.cuda.synchronize()
            check(got.shape == (b, N_MELS, t), f"masked shape {tuple(got.shape)}")
            check(bool(torch.isfinite(got).all()), "finite masked kernel output")
            err = (got.double() - want).abs().max().item()
            errs.append(err)
            zeros = int((want == 0).sum()) if not kw else -1
            print(f"phase 7: masked log_mel_radix16dif_fused B={b} L={length} {kw or 'dB'}: "
                  f"max|kernel - plain f64| = {err:.3e} (tol {tol:g})"
                  + (f"; {zeros} cells masked" if zeros >= 0 else ""))
            check(err <= tol, f"masked kernel vs plain at B={b} L={length} {kw}")
    rose = mel_kernels.log_mel_radix16dif_fused.launches_masked - before
    print(f"phase 7: launches_masked rose by {rose} over {calls} calls")
    check(rose == calls, "launches_masked counts every masked launch")
    return max(errs)


def phase8_train_step(dev, rng) -> None:
    """One optimizer step on the card against the same step on the CPU, at
    config.yaml's front end and model with batch 8 x accumulation 2."""
    cfg = load_config(str(REPO / "config.yaml"))
    fe = MelFrontend.from_config(cfg)
    a, b = 2, 8
    wavs = torch.from_numpy(synth_clips(rng, a * b, TRAIN_CLIP).reshape(a, b, TRAIN_CLIP))
    labels = torch.from_numpy(rng.integers(0, 4, (a, b))).long()
    cw = torch.tensor([1.0, 2.0, 0.5, 1.5])
    g = torch.Generator().manual_seed(8)
    draws = [aug.draw_augment(g, b, TRAIN_CLIP, N_MELS, fe.num_frames, "cpu") for _ in range(a)]
    init = LightweightCNN(generator=torch.Generator().manual_seed(0)).state_dict()

    def step(device, optimizer, lr, augment, dtype=torch.float32, head=1.0):
        model = LightweightCNN(dtype=dtype)
        # head > 1 spreads the logits, so that the loss depends on the
        # features and not only on log(4) (the init's head is N(0, 0.01))
        model.load_state_dict({k: v * head if k in ("fc1.weight", "fc2.weight") else v
                               for k, v in init.items()})
        model.to(device).set_dropout(0.0)
        opt = build_optimizer(optimizer, model.parameters(), 1e-4)
        fns = make_step_fns(model, fe, opt, accum_steps=2, augment=augment)
        m = fns.train_step(wavs.to(device), labels.to(device), cw.to(device), lr,
                           draws=[draws_to(d, device) for d in draws] if augment else None)
        return {k: float(v) for k, v in m.items()}, model, opt

    # (a) augmentation on, the config's Adam: the masked kernel on the card
    before = mel_kernels.log_mel_radix16dif_fused.launches_masked
    m_gpu, model_gpu, opt_gpu = step(dev, "adam", 3e-3, augment=True, head=30.0)
    torch.cuda.synchronize()
    check(mel_kernels.log_mel_radix16dif_fused.launches_masked == before + 1,
          "the augmented step ran the masked kernel once (one flattened front end)")
    m_cpu, model_cpu, opt_cpu = step("cpu", "adam", 3e-3, augment=True, head=30.0)
    err_loss = abs(m_gpu["loss"] - m_cpu["loss"]) / abs(m_cpu["loss"])
    sd_g, sd_c = model_gpu.state_dict(), model_cpu.state_dict()
    bn_err = max(((sd_g[k].cpu() - sd_c[k]).abs() / (sd_c[k].abs() + 1e-2)).max().item()
                 for k in sd_c if "running" in k)
    mu_err = max((torch.linalg.vector_norm(opt_gpu.state[pg]["exp_avg"].cpu() - opt_cpu.state[pc]["exp_avg"])
                  / torch.linalg.vector_norm(opt_cpu.state[pc]["exp_avg"])).item()
                 for pg, pc in zip(model_gpu.parameters(), model_cpu.parameters()))
    print(f"phase 8: augmented adam step, 2 x 8 x 8 s, fp32, 30x head: loss cuda {m_gpu['loss']:.6f} cpu "
          f"{m_cpu['loss']:.6f} (rel {err_loss:.2e}, tol 1e-4); BN buffers max rel {bn_err:.2e} "
          f"(tol 1e-4); gradient (Adam first moment) worst leaf rel {mu_err:.2e} (tol 2e-2)")
    check(err_loss <= 1e-4, "train step loss, cuda vs cpu")
    check(m_gpu["correct"] == m_cpu["correct"], "train step correct count, cuda vs cpu")
    for k in sd_c:
        if "running" in k:
            check(torch.allclose(sd_g[k].cpu(), sd_c[k], rtol=1e-4, atol=1e-6), f"BN buffer {k}")
    check(mu_err <= 2e-2, "accumulated gradient, cuda vs cpu")

    # (b) SGD at lr 1, no augmentation: the parameter change is the
    # accumulated, clipped gradient itself, held element by element
    m_gpu, model_gpu, _ = step(dev, "sgd", 1.0, augment=False)
    m_cpu, model_cpu, _ = step("cpu", "sgd", 1.0, augment=False)
    sd_g, sd_c = model_gpu.state_dict(), model_cpu.state_dict()
    worst = max(((sd_g[k].cpu() - sd_c[k]).abs() - 2e-3 * sd_c[k].abs()).max().item()
                for k, _ in model_cpu.named_parameters())
    print(f"phase 8: sgd step, lr 1: loss cuda {m_gpu['loss']:.6f} cpu {m_cpu['loss']:.6f}; "
          f"params max(|d| - 2e-3|p|) = {worst:.2e} (tol 2e-5)")
    check(abs(m_gpu["loss"] - m_cpu["loss"]) <= 1e-4 * abs(m_cpu["loss"]), "sgd step loss")
    for k, _ in model_cpu.named_parameters():
        check(torch.allclose(sd_g[k].cpu(), sd_c[k], rtol=2e-3, atol=2e-5), f"param {k}")

    # (c) bf16 compute on the card
    m_bf, _, _ = step(dev, "adam", 3e-3, augment=True, dtype=torch.bfloat16)
    print(f"phase 8: bf16 augmented step on the card: loss {m_bf['loss']:.6f}, "
          f"grad_norm {m_bf['grad_norm']:.4f}")
    check(math.isfinite(m_bf["loss"]) and math.isfinite(m_bf["grad_norm"]), "finite bf16 step")


def phase9_trainer(tmp: Path, card: str) -> tuple[Path, int]:
    """The training path as a user runs it, on a synthetic corpus."""
    t0 = time.perf_counter()
    corpus = generate_icbhi_dataset(tmp / "corpus", num_recordings=N_RECORDINGS, seed=0)
    print(f"phase 9: synthetic corpus of {N_RECORDINGS} recordings in "
          f"{time.perf_counter() - t0:.1f} s")
    config = str(REPO / "config.yaml")
    work = tmp / "run"
    work.mkdir()
    cwd = os.getcwd()
    os.chdir(work)  # config.yaml's checkpoint_dir and log_dir are relative
    try:
        for name in ("launches", "launches_masked"):
            setattr(mel_kernels.log_mel_radix16dif_fused, name, 0)
        t0 = time.perf_counter()
        history = train_entry.main(["--config", config, "--data-path", str(corpus),
                                    "--epochs", "2"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"log_mel_radix16dif_fused (masked)":
                    mel_kernels.log_mel_radix16dif_fused.launches_masked,
                    "log_mel_radix16dif_fused": mel_kernels.log_mel_radix16dif_fused.launches}
    finally:
        os.chdir(cwd)
    print(f"phase 9: [{card}] train.main, 2 epochs at config.yaml (8 s, batch 32 x 2, bf16): "
          f"{wall:.1f} s; history {json.dumps(history)}")
    print(f"phase 9: training path launches {launches}")
    check(all(n > 0 for n in launches.values()), "every kernel launched on the training path")
    check(len(history["train_loss"]) == 2
          and all(math.isfinite(v) for vals in history.values() for v in vals), "finite history")
    best = work / "checkpoints" / "best_model.ckpt"
    check(best.exists(), "best_model.ckpt written")

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + ([os.environ["PYTHONPATH"]] if os.environ.get("PYTHONPATH") else [])))
    out = subprocess.run(
        [sys.executable, "-m", "audio_classification_icbhi_tpu_torch.train", "--config", config,
         "--data-path", str(corpus), "--epochs", "3", "--resume", str(best)],
        cwd=work, env=env, capture_output=True, text=True, timeout=600)
    print("phase 9: resumed run (subprocess), last lines:\n  "
          + "\n  ".join(out.stdout.strip().splitlines()[-6:]))
    check(out.returncode == 0, f"resumed training exited {out.returncode}: {out.stderr[-2000:]}")
    check("Epoch 3/3" in out.stdout and "Resumed from" in out.stdout, "resumed to a third epoch")

    engine = ClassifierEngine(best, device="cuda")
    clip, _ = ICBHIDataset(corpus, "test", engine.config)[0]
    result = engine.classify_wave(clip)
    print(f"phase 9: best checkpoint served on the card: {result['predicted_class']} "
          f"{result['confidence']:.4f}")
    probs = np.array(list(result["probabilities"].values()))
    check(bool(np.isfinite(probs).all()) and abs(probs.sum() - 1.0) < 1e-4, "served probabilities")
    return corpus, launches["log_mel_radix16dif_fused (masked)"]


def phase10_timings(dev, rng, card: str, corpus: Path, tmp: Path) -> dict:
    """The training form at 64 x 8 s, the train step at config.yaml, one
    step's profiler split, and one epoch's wall time and device share."""
    b = 64
    x = torch.from_numpy(synth_clips(rng, b, TRAIN_CLIP)).to(dev)
    t = 1 + TRAIN_CLIP // HOP
    bounds = edge_bounds(b, t, torch.Generator().manual_seed(10)).to(dev)
    kw = dict(normalize=True, spec_mask_bounds=bounds)
    bound_ms, bound_by, floors = bound(b, TRAIN_CLIP, dev)
    kernel_ms = cuda_ms(lambda: mel_kernels.log_mel_radix16dif_fused(
        x, SR, N_FFT, HOP, N_MELS, **kw), iters=50)
    plain_ms = cuda_ms(lambda: mel_kernels.log_mel_fused_reference(
        x, SR, N_FFT, HOP, N_MELS, **kw), iters=10)
    library_ms = cuda_ms(yardstick(x, N_FFT, HOP, bounds), iters=20)
    print(f"phase 10: [{card}] masked log_mel_radix16dif_fused B={b} x 8 s: kernel "
          f"{kernel_ms:.4f} ms, plain f32 {plain_ms:.4f} ms, torch.stft yardstick "
          f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; bytes {floors['bytes']:.4f}, "
          f"operations {floors['operations']:.4f}, bytes with the dB scratch "
          f"{floors['bytes_with_scratch']:.4f})")

    # the train step at config.yaml: batch 32 x accumulation 2, bf16, Adam,
    # augmentation on, draws and dropout from a generator on the card
    cfg = load_config(str(REPO / "config.yaml"))
    fe = MelFrontend.from_config(cfg)
    wavs = torch.from_numpy(synth_clips(rng, 64, TRAIN_CLIP).reshape(2, 32, TRAIN_CLIP)).to(dev)
    labels = torch.from_numpy(rng.integers(0, 4, (2, 32))).long().to(dev)
    cw = torch.ones(4, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    model = build_model(cfg, generator=torch.Generator().manual_seed(0)).to(dev)
    opt = build_optimizer("adam", model.parameters(), 1e-4)
    fns = make_step_fns(model, fe, opt, accum_steps=2, augment=True)

    def one_step():
        return fns.train_step(wavs, labels, cw, 3e-3, generator=gen)

    step_ms = cuda_ms(one_step, iters=20, warmup=5)
    enqueue_ms = []  # host time to enqueue one step, the device queue empty
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_step()
        enqueue_ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    print(f"phase 10: [{card}] train step at config.yaml (32 x 2 x 8 s, bf16, adam, "
          f"augmentation on): {step_ms:.3f} ms ({64 / step_ms * 1e3:.1f} clips/s); "
          f"host enqueue time median {np.median(enqueue_ms):.3f} ms")
    steps = 3
    kernels, busy_us, wall_us = trace_device(one_step, steps)
    print(f"phase 10: [{card}] traced {steps} steps: device busy "
          f"{busy_us / steps:.1f} us/step of {wall_us / steps:.1f} us/step wall "
          f"({100 * busy_us / wall_us:.1f}%), "
          f"{sum(e.count for e in kernels) / steps:.0f} kernel launches a step")
    for e in kernels[:12]:
        print(f"phase 10:   {e.self_device_time_total / steps:9.1f} us/step "
              f"{e.count // steps:3d}x  {e.key[:90]}")

    # one epoch of the trainer on the corpus (ICBHI's split sizes), as
    # train.main runs it, and its parts apart: the loader alone (decode of
    # every train batch, no step), the train epoch, validation
    cfg["data"]["dataset_path"] = str(corpus)
    cfg["training"].update(checkpoint_dir=str(tmp / "t10" / "ckpt"), log_dir=str(tmp / "t10" / "runs"))
    trainer = Trainer(build_model(cfg), ICBHIDataset(corpus, "train", cfg, augment=True),
                      ICBHIDataset(corpus, "val", cfg), cfg, device="cuda")
    trainer.train_epoch(0)  # warm-up: cuDNN algorithm choice, allocator
    trainer.validate(0)
    torch.cuda.synchronize()
    kernels, busy_us, wall_us = trace_device(lambda: trainer.train_epoch(1), 1)
    t0 = time.perf_counter()
    trainer.train_epoch(2)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    trainer.train_loader.set_epoch(3)
    t0 = time.perf_counter()
    n_batches = sum(1 for _ in trainer.train_loader)
    loader_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    trainer.validate(2)
    val_s = time.perf_counter() - t0
    n_steps = -(-len(trainer.train_loader) // trainer.accum_steps)
    print(f"phase 10: [{card}] train epoch, {len(trainer.train_dataset)} clips, {n_steps} "
          f"optimizer steps: {epoch_s * 1e3:.1f} ms wall untraced; traced {wall_us / 1e3:.1f} ms "
          f"with the device busy {busy_us / 1e3:.1f} ms ({100 * busy_us / wall_us:.1f}%); "
          f"the loader alone, {n_batches} batches decoded: {loader_s * 1e3:.1f} ms; "
          f"validation, {len(trainer.val_dataset)} clips: {val_s * 1e3:.1f} ms")
    return {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}

def phase11_radix8_kernel(dev, rng) -> tuple[float, float]:
    """The radix-8 kernel against its plain version in float64 at the
    analyzer's shapes (64 x 0.5 s and 128 x 0.25 s windows) and an odd one,
    both forms; against the float64 golden; and the routing repair: auto
    front ends at radix2 and bf16x3 shapes run the plain chain on the card.
    Returns the largest error of each form against the plain version."""
    kernel = mel_kernels.log_mel_radix8dif_fused
    errs = {False: [], True: []}
    gen = torch.Generator().manual_seed(11)
    before = (kernel.launches, kernel.launches_masked)
    calls = [0, 0]
    for b, length in ((64, WINDOW), (128, WINDOW // 2), (3, WINDOW + 320)):
        t = 1 + length // HOP8
        x = (0.1 * rng.standard_normal((b, length))).astype(np.float32)
        x[1] *= 20.0
        xt = torch.from_numpy(x).to(dev)
        bounds = edge_bounds(b, t, gen).to(dev)
        for kw, tol in (({}, 1e-3), (dict(top_db=60.0, normalize=True), 2e-3),
                        (dict(top_db=60.0, normalize=True, spec_mask_bounds=bounds), 2e-3)):
            masked = "spec_mask_bounds" in kw
            got = kernel(xt, SR, N_FFT8, HOP8, N_MELS, **kw)
            calls[masked] += 1
            want = mel_kernels.log_mel_fused_reference(xt.double(), SR, N_FFT8, HOP8, N_MELS, **kw)
            torch.cuda.synchronize()
            check(got.shape == (b, N_MELS, t), f"radix-8 shape {tuple(got.shape)}")
            check(bool(torch.isfinite(got).all()), "finite radix-8 output")
            err = (got.double() - want).abs().max().item()
            errs[masked].append(err)
            what = ("masked, " if masked else "") + (
                "top_db 60 + normalize" if kw else "dB")
            print(f"phase 11: log_mel_radix8dif_fused B={b} L={length} {what}: "
                  f"max|kernel - plain f64| = {err:.3e} (tol {tol:g})")
            check(err <= tol, f"radix-8 kernel vs plain at B={b} L={length} {what}")
    for duration in (0.5, 0.25):
        wavs = parity_battery(int(SR * duration))
        want = np.stack([golden_mel(w, SR, N_FFT8, HOP8, N_MELS) for w in wavs])
        got = kernel(torch.from_numpy(wavs).to(dev), SR, N_FFT8, HOP8,
                     N_MELS).double().cpu().numpy()
        calls[0] += 1
        err = float(np.abs(got - want).max())
        print(f"phase 11: radix-8 golden {duration:g} s: max|kernel - f64 golden| = "
              f"{err:.3e} dB (tol 1e-3)")
        check(err <= 1e-3, f"radix-8 kernel vs golden at {duration} s")
    rose = (kernel.launches - before[0], kernel.launches_masked - before[1])
    print(f"phase 11: launches rose by {rose} over {tuple(calls)} calls (inference, masked)")
    check(rose == tuple(calls), "the radix-8 wrapper counts every launch of each form")

    # the routing repair: the JAX package runs XLA for radix2 and bf16x3
    # shapes, so the port runs the plain chain there and launches nothing
    for n_fft, hop, duration in ((800, 200, 0.1), (1000, 250, 0.25)):
        fe = MelFrontend(n_fft=n_fft, hop_length=hop, duration=duration)
        x = torch.from_numpy(synth_clips(rng, 4, int(SR * duration)))
        counts = [kernel.launches, mel_kernels.log_mel_radix16dif_fused.launches]
        got = fe(x.to(dev))
        torch.cuda.synchronize()
        check([kernel.launches, mel_kernels.log_mel_radix16dif_fused.launches] == counts,
              f"no kernel at {n_fft}/{hop}")
        err = (got.cpu() - fe(x)).abs().max().item()
        print(f"phase 11: auto front end {n_fft}/{hop} ({fe._pallas_algorithm()}) on the card: "
              f"plain chain, max|cuda - cpu| = {err:.3e} (tol 1e-3)")
        check(err <= 1e-3, f"auto front end at {n_fft}/{hop}, cuda vs cpu")
    return max(errs[False]), max(errs[True])


def kernel_name(key: str) -> str:
    """A profiler kernel key, shortened: no return type, no namespaces,
    at most 60 characters ("log_mel_epilogue_kernel(float const*, ...")."""
    name = key.removeprefix("void ").replace("(anonymous namespace)::", "")
    return name.replace("at::native::", "")[:60]


def quiet(fn, *args, **kwargs):
    """Call fn with its standard output (the analyzers' progress lines)
    dropped."""
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kwargs)


def phase12_analyzer(tmp: Path, corpus: Path, card: str) -> tuple[Path, dict[str, int]]:
    """The analyzers as a user runs them, on a 15 s recording (the engine's
    max_duration), with phase 9's trained checkpoint; then one training
    epoch at a sub-second front end. Returns the recording and the radix-8
    kernel's launches on these paths: the sub-second analyzer runs
    (inference form) and the training epoch (masked form)."""
    gen = np.random.default_rng(12)
    recording = tmp / "recording.wav"
    cycles = [synth_respiratory_cycle(gen, c, 2.5, SR) for c in (0, 1, 2, 3, 1, 2)]
    write_wav(recording, np.concatenate(cycles).astype(np.float32), SR)  # 15 s
    trained = tmp / "run" / "checkpoints" / "best_model.ckpt"
    k8, k16 = mel_kernels.log_mel_radix8dif_fused, mel_kernels.log_mel_radix16dif_fused
    expected = {0.25: 120, 0.5: 60, 1.0: 30}  # windows at 50 % overlap, tail included
    runs = [(0.5, v) for v in analyze.VARIANTS] + [(0.25, "realtime"), (1.0, "parallel")]
    launches = {"inference": 0}
    for duration, variant in runs:
        for fn in (k8, k16):
            fn.launches = fn.launches_masked = 0
        t0 = time.perf_counter()
        eng, results, csv_path = quiet(analyze.main, [
            variant, "--audio", str(recording), "--model", str(trained),
            "--segment-duration", str(duration), "--output-dir", str(tmp / "analysis")])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n8, n16 = k8.launches, k16.launches
        rows = csv_path.read_text().strip().splitlines()
        print(f"phase 12: [{card}] analyze {variant} at {duration:g} s windows: "
              f"{len(results)} windows -> {csv_path.name} ({len(rows) - 1} rows), "
              f"{sum(r.has_crackle for r in results)} crackle / "
              f"{sum(r.has_wheeze for r in results)} wheeze windows, {wall:.2f} s with "
              f"engine start; launches radix8 {n8}, radix16 {n16}")
        check(len(results) == expected[duration] == len(rows) - 1, "windows and CSV rows")
        check(eng.device.type == "cuda" and eng.mode == analyze.VARIANTS[variant].mode,
              "the analyzer ran on the card in its variant's mode")
        if duration < 1.0:
            check(n8 == 1 and n16 == 0, "sub-second windows ran the radix-8 kernel")
            launches["inference"] += n8
        else:
            check(n16 == 1 and n8 == 0, "1 s windows ran the radix-16 kernel")

    # the card's window probabilities against the port on the CPU
    fp32 = seeded_checkpoint(tmp / "analyzer_f32.ckpt", mixed_precision=False,
                             head_scale=30.0, duration=1.0)
    for ckpt, tol, what in ((trained, 5e-3, "trained checkpoint, bf16 CNN"),
                            (fp32, 1e-4, "seeded, f32 CNN, 30x head")):
        for duration in (0.25, 0.5, 1.0):
            engines = [quiet(AnalyzerEngine, str(ckpt), segment_duration=duration,
                             sample_rate=SR, device=d) for d in ("cuda", "cpu")]
            windows = quiet(lambda: engines[0].segment_audio(engines[0].load_audio(recording)))[0]
            gpu, cpu = (e.predict_window_probs(windows) for e in engines)
            err = float(np.abs(gpu - cpu).max())
            print(f"phase 12: {what}, {duration:g} s windows: max|cuda - cpu| probability "
                  f"= {err:.3e} (tol {tol:g}); classes {np.bincount(gpu.argmax(-1), minlength=4).tolist()}")
            check(bool(np.isfinite(gpu).all()) and err <= tol,
                  f"analyzer probabilities, cuda vs cpu, {what}, {duration} s")

    # the training path at a sub-second front end: config.yaml with n_fft
    # 1024 and hop 256, one epoch on phase 9's corpus (JSON is YAML)
    cfg = load_config(str(REPO / "config.yaml"))
    cfg["data"].update(n_fft=N_FFT8, hop_length=HOP8)
    cfg["training"].update(checkpoint_dir=str(tmp / "r8" / "ckpt"), log_dir=str(tmp / "r8" / "runs"))
    cfg_path = tmp / "config_n_fft_1024.yaml"
    cfg_path.write_text(json.dumps(cfg))
    for fn in (k8, k16):
        fn.launches = fn.launches_masked = 0
    t0 = time.perf_counter()
    history = quiet(train_entry.main, ["--config", str(cfg_path), "--data-path", str(corpus),
                                       "--epochs", "1"])
    torch.cuda.synchronize()
    launches["masked"] = k8.launches_masked
    print(f"phase 12: [{card}] train.main, 1 epoch at n_fft 1024 / hop 256: "
          f"{time.perf_counter() - t0:.1f} s; history {json.dumps(history)}; launches radix8 "
          f"masked {k8.launches_masked}, radix8 {k8.launches}, radix16 "
          f"{k16.launches + k16.launches_masked}")
    check(k8.launches_masked > 0 and k16.launches + k16.launches_masked == 0,
          "the sub-second training path ran the radix-8 kernel's masked form")
    check(all(math.isfinite(v) for vals in history.values() for v in vals), "finite history")
    return recording, launches


def phase13_analyzer_timings(dev, rng, card: str, tmp: Path, recording: Path) -> tuple[dict, dict]:
    """The radix-8 kernel beside its bound, plain version and yardstick at
    the analyzer's 64 x 0.5 s (a 15 s recording's bucket) and 2,400 x 0.5 s
    (a 10-minute recording), and its masked form at 64 x 8 s; then the
    analyzer end to end. Returns the kernel-line numbers of both forms."""
    kernel = mel_kernels.log_mel_radix8dif_fused
    rows = {}
    for b, length, masked in ((64, WINDOW, False), (2400, WINDOW, False), (64, TRAIN_CLIP, True)):
        x = torch.from_numpy(synth_clips(rng, b, length)).to(dev)
        bounds = (edge_bounds(b, 1 + length // HOP8, torch.Generator().manual_seed(13)).to(dev)
                  if masked else None)
        kw = dict(normalize=True, spec_mask_bounds=bounds)
        bound_ms, bound_by, floors = bound(b, length, dev, N_FFT8, HOP8)
        kernel_ms = cuda_ms(lambda: kernel(x, SR, N_FFT8, HOP8, N_MELS, **kw), iters=50)
        plain_ms = cuda_ms(lambda: mel_kernels.log_mel_fused_reference(
            x, SR, N_FFT8, HOP8, N_MELS, **kw), iters=10)
        library_ms = cuda_ms(yardstick(x, N_FFT8, HOP8, bounds), iters=20)
        print(f"phase 13: [{card}] {'masked ' if masked else ''}log_mel_radix8dif_fused B={b} "
              f"x {length / SR:g} s: kernel {kernel_ms:.4f} ms, plain f32 {plain_ms:.4f} ms, "
              f"torch.stft yardstick {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; "
              f"bytes {floors['bytes']:.4f}, operations {floors['operations']:.4f}, bytes with "
              f"the dB scratch {floors['bytes_with_scratch']:.4f})")
        rows[(b, masked)] = {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                             "bound_by": bound_by, "library_ms": library_ms}
        # the device's share of one call: the wrapper's kernels by name
        calls = 10
        kernels, busy_us, wall_us = trace_device(
            lambda: kernel(x, SR, N_FFT8, HOP8, N_MELS, **kw), calls)
        print(f"phase 13:   traced {calls} calls: device busy {busy_us / calls:.1f} us/call of "
              f"{wall_us / calls:.1f} us/call wall; "
              + "; ".join(f"{kernel_name(e.key)} {e.self_device_time_total / calls:.1f} us"
                          for e in kernels))
        del x

    trained = tmp / "run" / "checkpoints" / "best_model.ckpt"
    eng = quiet(AnalyzerEngine, str(trained), segment_duration=0.5, sample_rate=SR)
    for _ in range(3):
        quiet(eng.analyze_audio, recording)
    wall_ms = []
    for _ in range(20):
        t0 = time.perf_counter()
        quiet(eng.analyze_audio, recording)
        wall_ms.append((time.perf_counter() - t0) * 1e3)
    audio = quiet(eng.load_audio, recording)
    windows = quiet(eng.segment_audio, audio)[0]
    pass_ms = []
    for _ in range(20):
        t0 = time.perf_counter()
        eng.predict_window_probs(windows)
        pass_ms.append((time.perf_counter() - t0) * 1e3)
    print(f"phase 13: [{card}] analyzer, 15 s recording at 0.5 s windows (60 -> bucket 64), "
          f"warm: analyze_audio (wav decode, windows, device pass, results) median "
          f"{np.median(wall_ms):.3f} ms, p90 {np.percentile(wall_ms, 90):.3f} ms; the device "
          f"pass alone (host windows in, probabilities out) median {np.median(pass_ms):.3f} ms")

    long_path = tmp / "ten_minutes.wav"
    write_wav(long_path, synth_clips(rng, 1, 600 * SR)[0], SR)
    long = quiet(AnalyzerEngine, str(trained), segment_duration=0.5, sample_rate=SR,
                 max_duration=None)
    audio = quiet(long.load_audio, long_path)
    windows = quiet(long.segment_audio, audio)[0]
    check(windows.shape == (2400, WINDOW), f"10 minutes -> 2,400 windows, got {windows.shape}")
    for _ in range(2):
        long.predict_window_probs(windows)
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        probs = long.predict_window_probs(windows)
        times.append(time.perf_counter() - t0)
    check(probs.shape == (2400, 4) and bool(np.isfinite(probs).all()), "10-minute probabilities")
    t0 = time.perf_counter()
    results, _ = quiet(long.analyze_audio, long_path)
    whole = time.perf_counter() - t0
    print(f"phase 13: [{card}] analyzer, 10-minute recording, max_duration=None, 2,400 windows "
          f"of 0.5 s: device pass median {np.median(times) * 1e3:.3f} ms = "
          f"{2400 / np.median(times):.1f} windows/s; analyze_audio end to end (wav decode "
          f"included) {whole * 1e3:.1f} ms for {len(results)} windows")
    kernels, busy_us, wall_us = trace_device(lambda: long.predict_window_probs(windows), 2)
    print(f"phase 13: [{card}] traced 2 passes of 2,400 windows: device busy "
          f"{busy_us / 2:.1f} us/pass of {wall_us / 2:.1f} us/pass wall "
          f"({100 * busy_us / wall_us:.1f}%), {sum(e.count for e in kernels) / 2:.0f} kernel "
          f"launches a pass")
    for e in kernels[:14]:
        print(f"phase 13:   {e.self_device_time_total / 2:9.1f} us/pass "
              f"{e.count // 2:3d}x  {e.key[:90]}")
    return rows[(64, False)], rows[(64, True)]



# phase 14-15: the fused conv-block kernels. Kernel-line rows: (CUDA source,
# TPU kernel line in pallas_conv.py, wrappers whose launches the row counts)
CONV_ROWS = {
    "fused_conv_block1": ("fused_conv_block1.cu", ":92", ("fused_conv_block1",)),
    "fused_conv_block1_batched": ("fused_conv_block1.cu", ":334", ("fused_conv_block1_batched",)),
    "fused_conv_packed": ("fused_conv_packed.cu", ":157", ("fused_conv_block2", "fused_conv_block3")),
}
CONV_WRAPPERS = ("fused_conv_block1", "fused_conv_block1_batched", "fused_conv_block2",
                 "fused_conv_block3")
WRAPPER_BLOCK = {"fused_conv_block1": 0, "fused_conv_block1_batched": 0, "fused_conv_block2": 1,
                 "fused_conv_block3": 2}


def seeded_cnn(seed: int, head_scale: float = 30.0) -> LightweightCNN:
    """A bf16 LightweightCNN from `seed`, with BN statistics, scales and
    biases away from their init, so that folding them is exercised, and the
    head's weights times `head_scale`, so that the logits follow the CNN's
    features (at init they are ~1e-2 whatever the features)."""
    cfg = load_config()
    cfg["training"]["mixed_precision"] = True
    model = build_model(cfg, generator=torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        model.fc1.weight.mul_(head_scale)
        model.fc2.weight.mul_(head_scale)
        for i in range(1, 6):
            bn = getattr(model, f"conv{i}").bn
            n = bn.num_features
            bn.running_mean.copy_(0.1 * torch.randn(n, generator=g))
            bn.running_var.copy_(0.5 + torch.rand(n, generator=g))
            bn.weight.copy_(1.0 + 0.2 * torch.randn(n, generator=g))
            bn.bias.copy_(0.1 * torch.randn(n, generator=g))
    return model.eval()


def one_bf16_ulp(got: torch.Tensor, want: torch.Tensor) -> tuple[float, bool]:
    """(max |got - want|, whether every element is within one bf16 ulp:
    |d| <= 2^-7 |want| + 1e-4 max |want|)."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    limit = 2.0 ** -7 * want.abs() + 1e-4 * want.abs().max()
    return err.max().item(), bool((err <= limit).all())


def conv_bound_ms(x: torch.Tensor, folded: ck.FoldedConvBlock) -> tuple[float, str, dict]:
    """Least time for one fused block on x: its input, taps, bias and pooled
    bf16 output moved once over HBM bandwidth, against its 2·9·ci·co
    operations a pre-pool pixel that a pool window covers (floor pooling
    drops an odd last row or column, so the function never needs it) over
    the bf16 tensor-core peak (the products are bf16 x bf16 into f32, the
    tensor cores' own type)."""
    b, h, w, ci = x.shape
    co = folded.co
    out_bytes = 2 * b * (h // 2) * (w // 2) * co
    moved = (x.numel() * x.element_size() + folded.taps.numel() * folded.taps.element_size()
             + 4 * co + out_bytes)
    pixels = b * (h // 2 * 2) * (w // 2 * 2)
    floors = {"bytes": moved / HBM_BYTES_PER_S * 1e3,
              "operations": 2 * 9 * ci * co * pixels / BF16_FLOPS * 1e3}
    bound_by = max(floors, key=floors.get)
    return floors[bound_by], bound_by, floors


def phase14_conv_kernels(dev, rng, card: str) -> dict[str, dict]:
    """Each fused conv-block wrapper against its plain version on the card,
    in bf16, at the serving shapes (block 1 on the log-mel of 128 clips of
    5 s, blocks 2 and 3 on the outputs of the blocks before) and odd ones;
    the probe; the fused apply against itself on the CPU and against the
    model's cuDNN forward; then each kernel timed at the serving shape.
    Returns the kernel-line numbers of each CONV_ROWS row but its launches."""
    model = seeded_cnn(14).to(dev)
    sd = model.state_dict()
    args = [ck.block_args_from_state_dict(sd, i) for i in range(3)]
    folded = [ck.fold_conv_block(*args[i], bias_bf16=i == 0, device=dev) for i in range(3)]
    fe = MelFrontend.from_config(load_config())
    with torch.inference_mode():
        feats = features_from_wavs(fe, torch.from_numpy(synth_clips(rng, BATCH)).to(dev))
        x2 = ck.conv_block1_reference(feats, folded[0])
        x3 = ck.conv_packed_reference(x2, folded[1])
    check(tuple(feats.shape) == (BATCH, N_MELS, 157, 1), f"serving features {tuple(feats.shape)}")

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)

    # the analyzer's bucket of 64 windows of 0.5 s (n_fft 1024, hop 256: 32
    # frames), chained through the plain blocks as the fused apply chains it
    xa = rand(64, N_MELS, 32, 1)
    with torch.inference_mode():
        xa2 = ck.conv_block1_reference(xa, folded[0])
        xa3 = ck.conv_packed_reference(xa2, folded[1])
    junk = torch.zeros((1, 8, 12, 32), device=dev)
    junk[:, :, :10] = rand(1, 8, 10, 32)
    junk[:, :, 10:] = 5.0  # past true_w: never read
    cases = [("fused_conv_block1", feats, {}), ("fused_conv_block1", rand(3, 128, 157, 1), {}),
             ("fused_conv_block1", rand(2, 128, 64, 1), {}), ("fused_conv_block1", rand(1, 32, 9, 1), {}),
             ("fused_conv_block1", rand(1, 48, 70, 1), {"pad_out_w": 40}),
             ("fused_conv_block1", xa, {}), ("fused_conv_block2", xa2, {}),
             ("fused_conv_block3", xa3, {}),
             ("fused_conv_block1_batched", feats, {"group": 8}),
             ("fused_conv_block1_batched", rand(13, 32, 9, 1), {"group": 8}),
             ("fused_conv_block1_batched", rand(13, 128, 157, 1), {"group": 8}),
             ("fused_conv_block2", x2, {}), ("fused_conv_block2", rand(2, 64, 78, 32), {}),
             ("fused_conv_block2", rand(1, 64, 77, 32), {}), ("fused_conv_block2", rand(1, 8, 9, 32), {}),
             ("fused_conv_block2", junk, {"true_w": 10, "pad_out_w": 8}),
             ("fused_conv_block3", x3, {}), ("fused_conv_block3", rand(2, 32, 39, 64), {}),
             ("fused_conv_block3", rand(1, 16, 20, 64), {}), ("fused_conv_block3", rand(3, 18, 19, 64), {})]
    errs = {name: [] for name in CONV_ROWS}
    for name, x, kw in cases:
        blk = WRAPPER_BLOCK[name]
        fn = getattr(ck, name)
        before = fn.launches
        got = fn(x, *args[blk], **kw)
        plain_kw = {k: v for k, v in kw.items() if k != "group"}
        want = (ck.conv_block1_reference(x, folded[0], **plain_kw) if blk == 0
                else ck.conv_packed_reference(x, folded[blk], **plain_kw))
        torch.cuda.synchronize()
        check(fn.launches == before + 1, f"{name} counted its launch")
        check(got.shape == want.shape and got.dtype == torch.bfloat16,
              f"{name} shape {tuple(got.shape)} vs {tuple(want.shape)}")
        check(bool(torch.isfinite(got.float()).all()), f"finite {name} output")
        err, ok = one_bf16_ulp(got, want)
        row = next(r for r, (_, _, names) in CONV_ROWS.items() if name in names)
        errs[row].append(err)
        print(f"phase 14: {name} {tuple(x.shape)} {x.dtype} {kw or ''}: max|kernel - plain| = "
              f"{err:.3e} (max |plain| {want.float().abs().max().item():.3f}; tol one bf16 ulp)")
        check(ok, f"{name} within one bf16 ulp of its plain version at {tuple(x.shape)} {kw}")
    check(fused_kernels_available() is True, "fused_kernels_available()")
    print("phase 14: fused_kernels_available() passed")

    # logits held relative to their largest: the fused apply ends in a bf16
    # head, so it is within a few bf16 ulps (2^-8 each) of either reference,
    # while a wrong block moves the logits by their own size
    apply_gpu, apply_cpu = make_fused_apply(model, dev), make_fused_apply(model, "cpu")
    rel_tol = 3e-2
    with torch.inference_mode():
        for what, f in (("serving 128 x 128 x 157", feats), ("analyzer 64 x 128 x 32", xa)):
            lg = apply_gpu(f)
            lm = model(f).float()
            lc = apply_cpu(f[:16].cpu())
            torch.cuda.synchronize()
            top = lm.abs().max().item()
            err_cpu = (lg[:16].cpu() - lc).abs().max().item()
            err_model = (lg - lm).abs().max().item()
            print(f"phase 14: fused apply, {what}: max|cuda - cpu| logits (16 rows) {err_cpu:.3e}; "
                  f"max|fused - cuDNN forward| {err_model:.3e}; max |logit| {top:.3e} "
                  f"(tol {rel_tol} x max |logit|; spread head, max |logit| >= 1)")
            check(bool(torch.isfinite(lg).all()) and top >= 1.0
                  and max(err_cpu, err_model) <= rel_tol * top, f"fused apply at {what}")

    # timings at the serving shapes, through the folded entry points the
    # fused apply calls; the yardstick is the port's cuDNN ConvBlock
    timed = {"fused_conv_block1": (lambda: ck.conv_block1_folded(feats, folded[0]), feats, 0),
             "fused_conv_block1_batched": (
                 lambda: ck.conv_block1_batched_folded(feats, folded[0], group=8), feats, 0),
             "fused_conv_block2": (lambda: ck.conv_packed_folded(x2, folded[1]), x2, 1),
             "fused_conv_block3": (lambda: ck.conv_packed_folded(x3, folded[2]), x3, 2)}
    per = {}
    with torch.inference_mode():
        for name, (kernel, x, blk) in timed.items():
            plain = ((lambda: ck.conv_block1_reference(x, folded[0])) if blk == 0
                     else (lambda: ck.conv_packed_reference(x, folded[blk])))
            block = getattr(model, f"conv{blk + 1}")
            nchw = x.permute(0, 3, 1, 2)
            kernel_ms = cuda_ms(kernel, iters=50)
            plain_ms = cuda_ms(plain, iters=20)
            library_ms = cuda_ms(lambda: block(nchw), iters=50)
            bound_ms, bound_by, floors = conv_bound_ms(x, folded[blk])
            per[name] = {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by, "library_ms": library_ms}
            print(f"phase 14: [{card}] {name} {tuple(x.shape)} {x.dtype}: kernel {kernel_ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms, cuDNN ConvBlock yardstick {library_ms:.4f} ms, bound "
                  f"{bound_ms:.4f} ms ({bound_by}; bytes {floors['bytes']:.4f}, operations "
                  f"{floors['operations']:.4f})")
    packed = {k: per["fused_conv_block2"][k] + per["fused_conv_block3"][k]
              for k in ("ms", "plain_ms", "bound_ms", "library_ms")}
    rows = {"fused_conv_block1": per["fused_conv_block1"],
            "fused_conv_block1_batched": per["fused_conv_block1_batched"],
            "fused_conv_packed": {**packed, "bound_by": "operations"}}
    check(per["fused_conv_block2"]["bound_by"] == per["fused_conv_block3"]["bound_by"] == "operations",
          "blocks 2 and 3 bound by operations")
    for row, numbers in rows.items():
        numbers["max_abs_err"] = max(errs[row])
    return rows


def conv_counts() -> dict[str, int]:
    return {name: getattr(ck, name).launches for name in CONV_WRAPPERS}


def zero_counts() -> None:
    for name in CONV_WRAPPERS:
        getattr(ck, name).launches = 0
    for fn in (mel_kernels.log_mel_radix16dif_fused, mel_kernels.log_mel_radix8dif_fused):
        fn.launches = fn.launches_masked = 0


def phase15_fused_cnn(dev, rng, card: str, tmp: Path, recording: Path) -> dict[str, int]:
    """`ICBHI_FUSED_CNN=1` through the entry points: the serving engine
    (predict_probs, classify_wave, classify_files on a seeded 5 s checkpoint)
    and `analyze.main` at 0.5 s windows with phase 9's trained checkpoint,
    each with the launch counts zeroed before and read after; the same
    engines without the switch as reference; then the fused step's speed
    beside the cuDNN one. Returns each wrapper's launches over both runs.

    The probe of `fused_kernels_available` is cleared first, so the counts
    hold what a fresh process pays: one launch of each wrapper (row 9's only
    one) when the first engine takes the fused path."""
    # head x15: the probabilities follow the CNN (spread >= 4x the tolerance,
    # so a CNN with a constant output fails) while bf16 stays within 5e-3
    ckpt = seeded_checkpoint(tmp / "fused_serve.ckpt", mixed_precision=True, head_scale=15.0)
    trained = tmp / "run" / "checkpoints" / "best_model.ckpt"
    clips = synth_clips(rng, BATCH)
    paths = []
    for i in range(3):
        paths.append(tmp / f"fused_clip{i}.wav")
        write_wav(paths[-1], clips[i, ::2], SR // 2)
    windows = None
    os.environ["ICBHI_FUSED_CNN"] = "1"
    try:
        fused_infer._PROBED.clear()  # phase 14 ran the probe; a user's process has not
        zero_counts()
        engine = ClassifierEngine(ckpt, batch_size=BATCH, device="cuda")
        probs = engine.predict_probs(clips)
        one = engine.classify_wave(clips[0])
        files = engine.classify_files(paths)
        torch.cuda.synchronize()
        serve = conv_counts()
        serve["log_mel_radix16dif_fused"] = mel_kernels.log_mel_radix16dif_fused.launches
        print(f"phase 15: serving path with ICBHI_FUSED_CNN=1: launches {serve}")
        check(engine._apply_fn is not engine.model, "the serving engine took the fused apply")
        check(all(serve[k] > 0 for k in ("fused_conv_block1", "fused_conv_block2",
                                         "fused_conv_block3", "log_mel_radix16dif_fused")),
              "rows 8 and 10 and the log-mel kernel launched on the fused serving path")

        zero_counts()
        eng, results, csv_path = quiet(analyze.main, [
            "parallel", "--audio", str(recording), "--model", str(trained),
            "--segment-duration", "0.5", "--output-dir", str(tmp / "fused_analysis")])
        torch.cuda.synchronize()
        ana = conv_counts()
        ana["log_mel_radix8dif_fused"] = mel_kernels.log_mel_radix8dif_fused.launches
        rows = csv_path.read_text().strip().splitlines()
        print(f"phase 15: [{card}] analyze parallel at 0.5 s windows with ICBHI_FUSED_CNN=1: "
              f"{len(results)} windows -> {csv_path.name} ({len(rows) - 1} rows); launches {ana}")
        check(eng._apply_fn is not eng.classifier.model, "the analyzer took the fused apply")
        check(len(results) == 60 == len(rows) - 1, "analyzer windows and CSV rows")
        check(all(ana[k] > 0 for k in ("fused_conv_block1", "fused_conv_block2",
                                       "fused_conv_block3", "log_mel_radix8dif_fused")),
              "rows 8 and 10 and the radix-8 kernel launched on the fused analyzer path")
        windows = quiet(lambda: eng.segment_audio(eng.load_audio(recording)))[0]
        fused_windows = eng.predict_window_probs(windows)
    finally:
        os.environ.pop("ICBHI_FUSED_CNN", None)
    check(serve["fused_conv_block1_batched"] == 1 and ana["fused_conv_block1_batched"] == 0,
          "the batched wrapper launched by the first engine's probe only")

    plain = ClassifierEngine(ckpt, batch_size=BATCH, device="cuda")
    check(plain._apply_fn is plain.model, "without the switch the engine runs the model")
    ref = plain.predict_probs(clips)
    ref_files = plain.classify_files(paths)
    err = float(np.abs(probs - ref).max())
    err_one = float(np.abs(np.array(list(one["probabilities"].values()))
                           - np.array(list(plain.classify_wave(clips[0])["probabilities"].values()))).max())
    err_files = max(abs(a["confidence"] - b["confidence"]) for a, b in zip(files, ref_files))
    spread = float(np.abs(ref - ref.mean(axis=0)).max())
    print(f"phase 15: serving probabilities, fused vs cuDNN engine: predict_probs {err:.3e}, "
          f"classify_wave {err_one:.3e}, classify_files confidences {err_files:.3e} (tol 5e-3); "
          f"spread max|p - mean p| {spread:.3e} (>= 2e-2); classes "
          f"{np.bincount(ref.argmax(-1), minlength=ref.shape[1]).tolist()}")
    check(spread >= 2e-2, "the serving checkpoint's probabilities follow the CNN")
    check(max(err, err_one, err_files) <= 5e-3, "fused serving probabilities vs cuDNN")
    plain_ana = quiet(AnalyzerEngine, str(trained), segment_duration=0.5, sample_rate=SR)
    ref_windows = plain_ana.predict_window_probs(windows)
    err_w = float(np.abs(fused_windows - ref_windows).max())
    print(f"phase 15: analyzer window probabilities (trained checkpoint), fused vs cuDNN: "
          f"{err_w:.3e} (tol 5e-3); classes {np.bincount(fused_windows.argmax(-1), minlength=4).tolist()}")
    check(bool(np.isfinite(fused_windows).all()) and err_w <= 5e-3, "fused analyzer probabilities")

    # speed, with and without the switch, in turns: cuDNN, fused, fused, cuDNN
    x = torch.from_numpy(synth_clips(rng, BATCH)).to(dev)
    applies = {"cuDNN": plain._apply_fn, "fused": engine._apply_fn}

    def step(apply):
        return apply(features_from_wavs(engine.frontend, x))

    with torch.inference_mode():
        for name in ("cuDNN", "fused", "fused", "cuDNN"):
            for _ in range(3):
                step(applies[name])
            torch.cuda.synchronize()
            reps = 20
            t0 = time.perf_counter()
            for _ in range(reps):
                logits = step(applies[name])
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            check(bool(torch.isfinite(logits).all()), "finite logits")
            print(f"phase 15: [{card}] wav->logits batch {BATCH}, {name} CNN: "
                  f"{BATCH * reps / dt:.1f} clips/s ({dt / reps * 1e3:.3f} ms per batch)")
    host_clip = clips[0]
    for e in (engine, plain):
        e.warmup_latency()
    lat = {"fused": [], "cuDNN": []}
    for _ in range(50):
        for name, e in (("fused", engine), ("cuDNN", plain)):
            t0 = time.perf_counter()
            e.classify_wave(host_clip)
            lat[name].append((time.perf_counter() - t0) * 1e3)
    for name, ms in lat.items():
        print(f"phase 15: [{card}] classify_wave, batch 1, host clip in, {name} CNN: median "
              f"{np.median(ms):.3f} ms, p90 {np.percentile(ms, 90):.3f} ms over 50 calls")
    steps = 5
    with torch.inference_mode():
        for name in ("fused", "cuDNN"):
            kernels, busy_us, wall_us = trace_device(lambda: step(applies[name]), steps)
            print(f"phase 15: [{card}] traced {steps} {name} steps: device busy "
                  f"{busy_us / steps:.1f} us/step of {wall_us / steps:.1f} us/step wall "
                  f"({100 * busy_us / wall_us:.1f}%), "
                  f"{sum(e.count for e in kernels) / steps:.0f} kernel launches a step")
            for e in kernels[:14]:
                print(f"phase 15:   {e.self_device_time_total / steps:9.1f} us/step "
                      f"{e.count // steps:3d}x  {kernel_name(e.key)}")
    return {k: serve[k] + ana[k] for k in CONV_WRAPPERS}


if __name__ == "__main__":
    sys.exit(main())
