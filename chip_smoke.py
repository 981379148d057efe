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
   validation, on a corpus of ICBHI's split sizes.

Every failed check raises, and the script exits non-zero without printing a
result. The line before the last lists the kernels as JSON; the last line is
{"ok": true, "device": {...}}. No CUDA device: exit 1.
"""

from __future__ import annotations

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

from audio_classification_icbhi_tpu_torch import train as train_entry
from audio_classification_icbhi_tpu_torch.data.dataset import ICBHIDataset
from audio_classification_icbhi_tpu_torch.data.synthetic import generate_icbhi_dataset
from audio_classification_icbhi_tpu_torch.data.wavio import write_wav
from audio_classification_icbhi_tpu_torch.inference import ClassifierEngine
from audio_classification_icbhi_tpu_torch.models import LightweightCNN, build_model
from audio_classification_icbhi_tpu_torch.models.weights import flax_from_state_dict
from audio_classification_icbhi_tpu_torch.ops import _build, mel_kernels
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
    weight; 5 per output cell. The training form also reads (B, 4) bounds,
    16 bytes an example, which this counts in neither form (< 0.01 %)."""
    t = 1 + length // HOP
    out_bytes = 4 * batch * N_MELS * t
    bytes_moved = 4 * batch * (length + N_FFT) + out_bytes
    frames = batch * t
    flops = (frames / 2 * 5 * N_FFT * math.log2(N_FFT)
             + frames * (3 * (N_FFT // 2 + 1) + 2 * nnz) + 5 * frames * N_MELS)
    return {"bytes": bytes_moved / HBM_BYTES_PER_S * 1e3,
            "operations": flops / F32_FLOPS * 1e3,
            "bytes_with_scratch": (bytes_moved + 2 * out_bytes) / HBM_BYTES_PER_S * 1e3}


def bound(batch: int, length: int, device) -> tuple[float, str, dict[str, float]]:
    nnz = mel_kernels._constants(SR, N_FFT, N_MELS, 0.0, SR / 2.0, "htk", None, device)[4].numel()
    floors = log_mel_bound_ms(batch, length, nnz)
    bound_by = max(("bytes", "operations"), key=floors.get)
    return floors[bound_by], bound_by, floors


def edge_bounds(batch: int, n_frames: int, generator: torch.Generator) -> torch.Tensor:
    """(B, 4) SpecAugment bounds drawn as the train step draws them, with
    the first three rows at the edges: a zero width, a mel band past
    n_mels, a time band past the last frame."""
    b = aug.spec_mask_bounds(aug.draw_spectrogram(generator, batch, N_MELS, n_frames, "cpu"))
    b[0] = torch.tensor([3.0, 0.0, 10.0, 5.0])
    b[1] = torch.tensor([120.0, 15.0, n_frames - 4.0, 30.0])
    b[2] = torch.tensor([5.0, 7.0, n_frames + 8.0, 3.0])
    return b


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
    bound_ms, bound_by, floors = bound(BATCH, CLIP, x.device)
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
    training.update(launches=masked_launches, max_abs_err=masked_err)

    source = "audio_classification_icbhi_tpu_torch/csrc/log_mel_radix16dif.cu"
    replaces = "audio_classification_icbhi_tpu/ops/pallas_mel.py:1270"
    print(json.dumps({"kernels": [
        {"name": "log_mel_radix16dif_fused", "route": "cuda", "source": source,
         "replaces": replaces, **serving},
        {"name": "log_mel_radix16dif_fused_masked", "route": "cuda",
         "source": source, "replaces": replaces, **{k: training[k] for k in serving}},
    ]}))
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
            want = mel_kernels.log_mel_radix16dif_fused_reference(
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
    plain_ms = cuda_ms(lambda: mel_kernels.log_mel_radix16dif_fused_reference(
        x, SR, N_FFT, HOP, N_MELS, **kw), iters=10)
    window = torch.hann_window(N_FFT, device=dev)
    fb = mel_filterbank(SR, N_FFT, N_MELS, device=dev)

    def library():  # yardstick only: torch.stft + mel matmul + dB + mask + normalize
        spec = torch.stft(x, N_FFT, HOP, window=window, center=True, pad_mode="reflect",
                          return_complex=True).abs() ** 2
        db = aug.mask_from_bounds(10.0 * torch.log10(torch.clamp(fb.T @ spec, min=1e-10)), bounds)
        mean = db.mean(dim=(1, 2), keepdim=True)
        return (db - mean) / (db.std(dim=(1, 2), keepdim=True) + 1e-8)

    library_ms = cuda_ms(library, iters=20)
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

if __name__ == "__main__":
    sys.exit(main())
