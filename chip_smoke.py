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
   injected augmentation draws, fp32, dropout inert; an lr-1 SGD step held
   by `step_floor` (the CPU step rerun with its log-mel 1e-5 dB
   off under seeds 0-7 sets each tensor's floor, as in the CPU tests); and
   a bf16 step;
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
   their plain versions on the card, in bf16 (one bf16 ulp, and the count
   of outputs that differ), at the serving shapes, odd ones and block 3's
   tile edges (w = 38-41); `fused_kernels_available()`; each source's CTAs
   an SM and its SASS (HGMMA and UTMALDG in `fused_conv_packed`, HMMA in
   `fused_conv_block1`); the fused apply on the card against itself on the
   CPU and against the model's cuDNN forward; each kernel's eager time (CUDA
   events, the kernels line's `ms`) beside its device time as a CUDA graph
   of 20 calls (`graph_ms`), bound, plain version, the port's cuDNN
   ConvBlock as yardstick and cuDNN's bf16 conv alone;
15. the opt-in `ICBHI_FUSED_CNN=1` through the entry points: the serving
   engine (predict_probs, classify_wave, classify_files) and `analyze.main`
   at 0.5 s windows, the launch counts read around each run, the
   probabilities held against the same engines without the switch; wav ->
   logits clips/s and classify_wave latency with and without the switch,
   a profiler split of the fused step, and each step's device time as a
   replayed CUDA graph beside the host clock's;
16. TPU-kernel rows 3-6 (on the mixed-radix log-mel kernel, or the radix-8
   one at n_fft 512 and 2048), and rows 1-2 at n_fft the radix-8 kernel does not
   take (6144/512, 3072/768, 12288/1536, 16384/1024): each row against its
   plain version in float64 on seeded noise at its shapes, the fused rows in
   both forms with edge bounds, row 3's training form also at 64 x 8 s;
   against the float64 golden over the parity battery at 5 and 1 s
   (unrestricted at n_fft >= 1536, in the 25 dB active region below, the
   plain f32 chain's error printed beside); rows 4 and 6 through
   `MelFrontend(backend="pallas")`, their launch counts read around the
   run; each row timed at 128 x 5 s at its main shape beside its bound,
   plain version and yardstick; then both log-mel sources side by side at
   rows 1-2's shapes; then the radix-8 source alone: each instance's warps
   an SM, registers and shared memory (`log_mel_radix8dif_occupancy`), its
   spectrum kernel alone beside the whole call at rows 1-2's shapes and at
   512/128 (both forms, where it is timed against the mixed-radix source
   too), two calls bit-equal, and one call captured as a CUDA graph whose
   only nodes are the spectrum kernel and the epilogue (no reflect-pad
   gather); then the mixed-radix source alone: each path's launch shape
   (`log_mel_mixed_radix_occupancy`: the warp instances, with the rows in
   registers or in shared memory, and the block path with the plan of
   `mel_kernels.block_plan`), its spectrum kernel alone beside the whole call
   at 768/256, 800/200, 1536/384, 400/160, 1280/256 and on the block path at
   128 x 5 s at 1200/300, 1100/275, 4036/1009 (8 clips too), 12288/1536,
   16380/4095 and 16384/1024, two calls bit-equal at each, each block-path
   shape also beside its bound, plain version and yardstick and through the
   golden gate, and one row-5 call captured as a CUDA graph (the warp
   spectrum kernel and the epilogue, nothing else); row 3 is also timed at
   1536/384;
17. the entry points at n_fft 512 / hop 128 (row 3): the serving engine,
   one training epoch of `train.main` (row 3's masked form) on phase 9's
   corpus and the train step's time and device share at that front end,
   `analyze.main` at 1 s and 0.064 s windows, and the serving
   engine at 768/256 (row 5), 1536/384 (row 3 on the mixed-radix
   source) and 16384/1024 (row 1 on its block path), each with the launch
   counts read around it and the card held against the CPU; wav -> logits
   clips/s and classify_wave latency at 512/128 and 768/256;
18. TPU-kernel row 7 (`bf16x3` / `f32`) on the DFT GEMM log-mel kernel (a
   folded real-input DFT on `wgmma`, fed by TMA; its SASS must hold HGMMA and
   UTMALDG, counted by `cuobjdump -sass`) at
   n_fft % 4 != 0 (1001/250, 505/126, 1022/511, 2050/512): both names against
   their plain version in float64 on seeded noise at 5 and 1 s, dB only and
   with top_db 80 + normalize, and against the float64 golden over the
   parity battery (`parity.parity`; unrestricted at n_fft >= 1536, in the
   25 dB active region below); the main path with the counts zeroed before
   and read after: wav -> logits at 1001/250, 128 clips of 5 s, through
   `features_from_wavs(MelFrontend(backend="pallas"), ...)` and the bf16
   LightweightCNN, held against the CPU and timed, `MelFrontend(backend=
   "pallas")` at 1022/511 and `pallas_algorithm="f32"` at 1001/250 and
   2048/512; the odd-n_fft framing repair on the card (`ClassifierEngine`
   under backend "auto" at 1001/250: 321 frames, the plain chain, held
   against the CPU); each name timed at 128 x 5 s beside its bound, plain
   version and yardstick, with its achieved TF32 rate (MMA work over time,
   and its share of 495 TFLOP/s); the new source beside the radix-8 one at
   2048/512 (`run_source`); and `python -m audio_classification_icbhi_tpu_torch.parity`
   at 2048/512, every row within its gate;
19. the shared epilogue alone (`csrc/log_mel_epilogue.cuh`, a thread-block
   cluster an example) on the dB scratch of the serving batch, the train
   step's front end at rows 1-3's n_fft, row 3 at 512/128 and the
   analyzer's bucket: its plan read from the card against
   `mel_kernels.epilogue_plan`, against `epilogue_reference` in float64 with
   and without top_db, two calls bit-equal, eager and as a CUDA graph beside
   its bytes bound, plain version and a PyTorch yardstick; and its launches
   over every main-path run above (one with each log-mel call), which the
   kernels line reports;
20. CompactResNet18 through the entry points (it has no kernel of its own;
   its paths run rows 1 and 2): the serving engine on a seeded checkpoint
   (BN statistics from 32 clips, head x15), bf16 logits within 2e-2 x max
   |logit| and fp32 probabilities within 1e-4 of the CPU; wav -> logits at
   128 x 5 s (device time as a CUDA graph, launches a batch) and
   classify_wave beside LightweightCNN's; one epoch of `train.main --model
   resnet` at config.yaml, a resumed epoch as a subprocess and the best
   checkpoint served; the train step by CUDA events, its launches and its
   device time as a CUDA graph, an epoch's wall time; an fp32 lr-1 SGD step
   against the CPU by phase 8's bound; `analyze.main` at 0.5 s windows and
   its warm time; `model.pretrained` from a torchvision-shaped resnet18
   `.pt` (the stem the channel sum, the head at its seeded init); and
   `ICBHI_FUSED_CNN=1`, under which rows 8-10 launch 0 times. Its row-1 and
   row-2 launches add to the kernels line;
21. the segmented ICBHI path through its entry points: the corpus fixture
   (64 recordings x 6 cycles at native 4 / 10 / 44.1 kHz), `preprocess_icbhi`
   (timed), one epoch of `train_icbhi` at config_segmented.yaml (3 s, 32 x
   4, bf16; 3 optimizer steps) as a subprocess for LightweightCNN and the
   ResNet, printing its launch counts, `validate_icbhi --no-plots` on each
   best checkpoint and `validate --no-plots` on phase 9's checkpoint and
   corpus (8 s at config.yaml), and for the ResNet (its softmax saturated
   after 3 steps) on a copy with its BN statistics from 32 train cycles,
   each held to the CPU port's Validator on the same checkpoint (bf16
   y_prob within 5e-3, the ResNet's logits from the entry's own pass within
   2e-2 x max |logit|, y_pred where the margin allows) and an fp32 copy of
   the LightweightCNN checkpoint within 1e-4, every y_prob held but the
   saturated one's spread across the clips >= 2e-2 (4x the bf16
   tolerance), so that a model whose output ignores its input fails; each
   report against the numpy metrics of the card's arrays; validation ms a split and clips/s, and the
   train step at config_segmented.yaml by CUDA events and as a CUDA graph.
   Its row-1 launches (94 frames at 3 s, 251 at 8 s) add to the kernels
   line.
22. data-parallel training and the fp16 loss scale: phase 8's lr-1 SGD
   step on a world-size-1 NCCL mesh (cross-rank BatchNorm, the
   all-reduces) against the same step without a group on the card and on
   the CPU, by phase 8's bound; two NCCL ranks against one where two GPUs
   are visible (else it prints that this part did not run); the fp16
   loss-scaled step on the card against the CPU, and a forced overflow,
   skipped with the scale halved; one epoch of `train --multihost
   --num-processes 1` at config.yaml with `precision: fp16` as a
   subprocess printing its launch counts, resumed as a subprocess from its
   checkpoint's scale state, its best checkpoint served; the analyzer on a
   1-device mesh against no mesh at 0.5 and 1 s windows; and the train step
   at config.yaml on the NCCL mesh and in fp16 beside the plain bf16 step
   (CUDA events, host launch calls, profiler busy time). Its row-1 and
   row-2 launches add to the kernels line.
23. the device-resident waveform cache and the fused multi-step epoch
   (`train_many` / `eval_many`, each step and eval group a replayed CUDA
   graph): phase 8's lr-1 SGD step through `train_many` (the capture's
   eager warm-up) against phase 8's eager steps on the card and the CPU by
   its bound, then a replay at lr 1 and a re-capture's replay at lr 0.5,
   each against an eager step from the same state;
   `Trainer` at config.yaml with `data.cache_on_device` at
   steps_per_dispatch 1 and 0 for 3 epochs on phase 9's corpus cut to
   294 / 63 clips (4 full optimizer steps and a tail group, a tail val
   batch), the fused losses within rtol 1e-4 of the per-step ones, epoch
   ms; the captured graphs' nodes (the masked row-1 kernel in the train
   graph, the inference form in the eval graph, through libcuda) and the
   launches one replay counts; the cache's MB, decode and upload ms; host
   calls a step, per step and fused, and the eager step's device records
   (kernels, copies, fills); the graphed step's and eval group's device
   ms. Its row-1 launches add to the kernels line;
24. the host side and the last entry points: (a) the native wav decoder
   (`native`, built with g++ into build/native/): a fresh build's time,
   `ICBHIDataset.load_batch` over the train split of phase 9's 16 kHz
   corpus and of phase 21's 4 / 10 / 44.1 kHz fixture equal bit for bit to
   the numpy codec, with the row counters (native rows; the other rates on
   the per-row path), host ms of each decoder, and the 10-minute
   recording's `load_audio`; phases 10, 13 and 23 print which decoder did
   their rows; (b) `ops/resample.resample` of 8 x 15 s at 44.1 / 4 / 10 kHz
   to 16 kHz with TF32 switched on around the call, against the same
   polyphase sum in float64 (an a-priori f32 bound) and equal to the call
   with TF32 off, by CUDA events beside `wavio.resample_np`; (c)
   `phase_vocoder` at 2048/512 on 15 s at rates 0.8 and 1.25 against itself
   in float64: magnitudes within 1e-6 of the peak, phases within
   `phase_bound`; (d) `diagnose_data --no-plots` on phase 9's corpus and
   phase 21's segmented corpus: finite mels, a finite loss within 1 of
   ln 4, row 1 launched; (e) `confusion_matrix generate --no-plots` on
   phase 9's checkpoint: its NPY equals the counts of a Validator pass on
   the card. The analyzer runs of phases 12, 15, 17 and 20 pass
   --no-plots (the card's machine has no matplotlib). Row-1 launches of
   (d) and (e) add to the kernels line;
25. orbax checkpoint directories (`utils/orbax_format.py`, the zstd decoder
   `native/zstd.cc`): (a) a fresh g++ build of the decoder, timed; (b) the
   committed JAX-written fixture (`tests/data/orbax_jax_fixture/`, its
   frames Huffman- and FSE-coded) decoded on the card's host and held to
   the values recorded beside it; (c) one epoch of `train.main` at
   config.yaml on phase 9's corpus with `training.checkpoint_format:
   orbax` (async writes), resumed from its `best_model.ckpt` directory to
   epoch 2 as a subprocess; (d) that directory served by
   `ClassifierEngine(device="cuda")` beside an engine on a msgpack re-save
   of it: every state tensor and the logits of the same seeded clips bit
   for bit; (e) save and load by the host clock, orbax beside msgpack, with
   MB on disk, for the trained LightweightCNN + Adam payload and a
   CompactResNet18 + Adam one. Row-1 launches of (c) and (d) add to the
   kernels line;
26. the fused epoch on an NCCL process group (the NCCL version printed;
   capture needs 2.9.6): phase 8's lr-1 SGD step through `train_many` on
   a world-size-1 group (cross-rank BatchNorm, the all-reduces), the
   capture's eager warm-up against phase 8's step without a group on the
   card and the CPU by its bound, the collectives counted in the warm-up
   and the capture (24 each), then a replay against an eager NCCL step
   from the same state; `Trainer` at config.yaml (bf16, capturable Adam,
   augmentation and dropout on, `cache_on_device`) on that group for 3
   epochs on phase 23's 294 / 63 clips at steps_per_dispatch 1 and 0, the
   fused history within rtol 1e-4 of the per-step one, and within rounding
   of phase 23's fused run without a group (max(rtol 1e-4, twice how far
   that run moves from initial weights 1e-6 off, seeds 0-7)); the train
   graph's nodes by kind (its NCCL kernels) beside phase 23's, the eval
   graph's (no collective), the captures' ms, host calls a step, the
   graphed step's and eval group's device ms; one epoch of `train
   --multihost --num-processes 1` at config.yaml with the cache on as a
   subprocess printing its launch counts (the cache line, no "disabled"
   line), its best checkpoint served; two NCCL ranks fused against one
   where two GPUs are visible (else it prints that this part did not
   run). Its row-1 launches add to the kernels line.
27. CompactResNet18 and the segmented config on the fused epoch: phase
   20's fp32 lr-1 SGD step of the full ResNet through `train_many`, the
   capture's eager warm-up step against phase 20's eager steps on the card
   and the CPU by its bound, then a replay against an eager step from the
   same state; `Trainer` at config.yaml with `architecture: resnet` (bf16,
   capturable Adam, augmentation and the head's dropouts on, the cache on)
   for 3 epochs on phase 23's 294 / 63 clips at steps_per_dispatch 1 and 0,
   the fused history held to the per-step one (rtol 1e-4, else max(rtol
   1e-4, twice how far the per-step run moves from initial weights 1e-6
   off, seeds 0-7)), the eval graph against an eager forward of its 128
   rows (rtol 1e-5) and beside the per-step run's 32-row forwards, the
   graphs' nodes by kind, replays and memory pools, the captures' ms, host
   calls a step, the graphed step's and eval group's device ms and the
   steady epochs' ms; `train_segmented` and `train_icbhi` at
   config_segmented.yaml with the cache on at steps_per_dispatch 1 and 0 for
   3 epochs on phase 21's segmented corpus (their graphs' replays counted),
   the histories held alike. Its row-1 launches add to the kernels line.

Every failed check raises, and the script exits non-zero without printing a
result. The line before the last lists the kernels as JSON; the last line is
{"ok": true, "device": {...}}. No CUDA device: exit 1.

    python3 chip_smoke.py --parent DIR

times the mixed-radix block path and the epilogue alone of an earlier
checkout unpacked in DIR beside this one's instead (`compare_parent`,
`mel_times`), and runs no phase.

    python3 chip_smoke.py --phase27

builds the kernels and runs phase 27 alone, on phase 9's and phase 21's
corpora and phase 20's ResNet SGD step (`phase27_alone`; about two minutes
on one H100).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import importlib
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from audio_classification_icbhi_tpu_torch import analyze
from audio_classification_icbhi_tpu_torch import confusion_matrix as cm_entry
from audio_classification_icbhi_tpu_torch import diagnose_data
from audio_classification_icbhi_tpu_torch import native
from audio_classification_icbhi_tpu_torch import parity
from audio_classification_icbhi_tpu_torch import preprocess_icbhi
from audio_classification_icbhi_tpu_torch import tracing
from audio_classification_icbhi_tpu_torch import train as train_entry
from audio_classification_icbhi_tpu_torch import validate as validate_entry
from audio_classification_icbhi_tpu_torch import validate_icbhi
from audio_classification_icbhi_tpu_torch.analyzers import AnalyzerEngine
from audio_classification_icbhi_tpu_torch.data.dataset import ICBHIDataset
from audio_classification_icbhi_tpu_torch.data.dataset_segmented import ICBHISegmentedDataset
from audio_classification_icbhi_tpu_torch.data.device_cache import DeviceCachedLoader
from audio_classification_icbhi_tpu_torch.data.synthetic import (
    generate_icbhi_corpus_fixture,
    generate_icbhi_dataset,
    synth_respiratory_cycle,
)
from audio_classification_icbhi_tpu_torch.data import wavio
from audio_classification_icbhi_tpu_torch.data.wavio import (
    decode_mono_numpy,
    pad_or_crop,
    read_wav,
    resample_np,
    write_wav,
)
from audio_classification_icbhi_tpu_torch.inference import ClassifierEngine
from audio_classification_icbhi_tpu_torch.models import (
    CompactResNet,
    LightweightCNN,
    build_model,
    fused_kernels_available,
    make_fused_apply,
)
from audio_classification_icbhi_tpu_torch.models import fused_infer
from audio_classification_icbhi_tpu_torch.models.cnn import BatchNorm
from audio_classification_icbhi_tpu_torch.models.weights import (
    flax_from_state_dict,
    optax_from_opt_state,
    state_dict_from_flax,
)
from audio_classification_icbhi_tpu_torch.ops import _build, mel_kernels
from audio_classification_icbhi_tpu_torch.ops import conv_kernels as ck
from audio_classification_icbhi_tpu_torch.ops import augment as aug
from audio_classification_icbhi_tpu_torch.ops.golden import golden_mel, parity_battery
from audio_classification_icbhi_tpu_torch.ops.mel import MelFrontend, mel_filterbank
from audio_classification_icbhi_tpu_torch.ops.resample import _resample_kernel, resample
from audio_classification_icbhi_tpu_torch.ops.time_stretch import (
    phase_bound,
    phase_vocoder,
    stft_complex,
)
from audio_classification_icbhi_tpu_torch.parallel.data_parallel import (
    features_from_wavs,
    make_step_fns,
    weighted_cross_entropy,
)
from audio_classification_icbhi_tpu_torch.parallel.mesh import (
    all_reduce_sum,
    close_distributed,
    free_port,
    get_mesh,
    init_distributed,
)
from audio_classification_icbhi_tpu_torch.step_floor import (
    FLOOR_SEEDS,
    param_arrays,
    step_floor,
    step_margins,
)
from audio_classification_icbhi_tpu_torch.training.optimizers import build_optimizer
from audio_classification_icbhi_tpu_torch.training.trainer import Trainer
from audio_classification_icbhi_tpu_torch.training.validation import Validator
from audio_classification_icbhi_tpu_torch.utils import orbax_format
from audio_classification_icbhi_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from audio_classification_icbhi_tpu_torch.utils.config import load_config, set_seed
from audio_classification_icbhi_tpu_torch.utils.metrics import (
    confusion_matrix as metrics_confusion_matrix,
)
from audio_classification_icbhi_tpu_torch.utils.icbhi_metrics import (
    calculate_detailed_confusion_metrics,
    calculate_icbhi_score,
)

# the module: `ops.resample` is its function, as in the JAX package
resample_mod = importlib.import_module("audio_classification_icbhi_tpu_torch.ops.resample")

REPO = Path(__file__).resolve().parent
SR, N_FFT, HOP, N_MELS = 16000, 2048, 512, 128
BATCH, CLIP = 128, 5 * SR
TRAIN_CLIP = 8 * SR  # config.yaml: 8 s clips, batch 32 x accumulation 2
SEG_CLIP = 3 * SR    # config_segmented.yaml: 3 s cycles, batch 32 x accumulation 4
ORBAX_FIXTURE = REPO / "tests" / "data" / "orbax_jax_fixture"
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


def graph_ms(fn, calls: int = 20, iters: int = 10) -> float:
    """Device milliseconds a call of fn with the host out of the way:
    `calls` warm calls captured into one CUDA graph, replayed `iters` times
    back to back, timed by CUDA events."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(calls):
            fn()
    return cuda_ms(graph.replay, iters, warmup=2) / calls


def log_mel_bound_ms(batch: int, length: int, nnz: int, n_fft: int = N_FFT, hop: int = HOP,
                     n_mels: int = N_MELS) -> dict[str, float]:
    """Least times for the log-mel function at this shape, in ms: "bytes"
    (the (B, L) waveform read once, output written once; the reflect pad
    is an index map, not data) over HBM bandwidth, "operations" (f32) over
    the CUDA-core peak, and "bytes_with_scratch", the two-pass design's own
    floor, which also writes and reads back its (B, T, n_mels) dB scratch.
    Operations: 5·N·log2(N) per N-point complex FFT, one complex FFT per
    two real frames; 3 per power bin; 2 per mel weight; 5 per output cell.
    The training form also reads (B, 4) bounds, 16 bytes an example, which
    this counts in neither form (< 0.01 %). Both kernels compute this one
    function, so it bounds both."""
    t = 1 + length // hop
    out_bytes = 4 * batch * n_mels * t
    bytes_moved = 4 * batch * length + out_bytes
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


# the dense kernels of both classifiers' heads (LightweightCNN's, CompactResNet's)
HEAD_WEIGHTS = ("fc1.weight", "fc2.weight", "resnet.fc.1.weight", "resnet.fc.4.weight")


def scaled_head(sd: dict, head_scale: float) -> dict:
    """A state_dict with its head's dense kernels times head_scale: > 1
    spreads the logits, so that they follow the network (at init they are
    ~1e-2 whatever the features)."""
    return {k: v * head_scale if k in HEAD_WEIGHTS else v for k, v in sd.items()}


def seeded_checkpoint(path: Path, mixed_precision: bool, head_scale: float,
                      duration: float = 5.0, architecture: str = "cnn",
                      calibrate: np.ndarray | None = None, **data) -> Path:
    """A checkpoint at config's defaults (16 kHz, 128 mels, 2048/512; `data`
    overrides the data section, e.g. n_fft and hop_length) of `architecture`
    with weights from the config's seed; head_scale > 1 spreads the classes.
    `calibrate` (clips of `duration`) sets every BN's running statistics to
    the batch statistics of one train-mode forward over them: with BN at
    mean 0 / var 1 a seeded ResNet's logits barely follow its input."""
    cfg = load_config()
    cfg["data"].update(duration=duration, **data)
    cfg["model"]["architecture"] = architecture
    cfg["training"]["mixed_precision"] = mixed_precision
    model = build_model(cfg, dtype=torch.float32, generator=set_seed(cfg["seed"]))
    if calibrate is not None:
        calibrate_bn(model, cfg, calibrate)
    sd = scaled_head(model.state_dict(), head_scale)
    return save_checkpoint(path, {
        "epoch": 0, **flax_from_state_dict(sd), "val_loss": 0.0, "config": cfg})


def calibrate_bn(model: torch.nn.Module, cfg: dict, clips: np.ndarray) -> None:
    """Set every BN's running statistics of `model` (on the CPU) to the
    batch statistics of one train-mode forward over `clips`."""
    for bn in (m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)):
        bn.momentum = 1.0  # the running statistics become the batch's
    with torch.no_grad():
        model.train()(features_from_wavs(MelFrontend.from_config(cfg), torch.from_numpy(clips)))


def checkpoint_copy(src: Path, path: Path, calibrate: np.ndarray | None = None,
                    mixed_precision: bool | None = None) -> Path:
    """The checkpoint at `src` with, given `calibrate` clips, its BN
    statistics from one train-mode forward over them (`calibrate_bn`), and
    `mixed_precision` in place of its config's. A ResNet trained for a few
    steps has its eval-mode BN far from the batch statistics and its softmax
    saturated; calibrated, its probabilities follow its input."""
    ckpt = load_checkpoint(src)
    cfg = ckpt["config"]
    if mixed_precision is not None:
        cfg["training"]["mixed_precision"] = mixed_precision
    if calibrate is not None:
        model = build_model(cfg, dtype=torch.float32)
        model.load_state_dict(state_dict_from_flax(ckpt))
        calibrate_bn(model, cfg, calibrate)
        ckpt.update(flax_from_state_dict(model.state_dict()))
    return save_checkpoint(path, ckpt)


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

    # Phase 3: kernel vs its plain version (f64) on the card, at the serving
    # shape, at validation's (batch 32 of 3 s and 8 s clips), at phase 23's
    # eval group (128 rows of 8 s), at phase 22's fp16 step (8 clips of 2 s)
    # and an odd one
    errs = []
    for b, length in ((BATCH, CLIP), (32, SEG_CLIP), (32, TRAIN_CLIP), (128, TRAIN_CLIP),
                      (8, 2 * SR), (3, 16320)):
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

        zero_counts()
        engine = ClassifierEngine(ckpt, batch_size=BATCH, device="cuda")
        probs = engine.predict_probs(clips)
        one = engine.classify_wave(clips[0])
        files = engine.classify_files(paths)
        torch.cuda.synchronize()
        read_epilogue("phase 5 serving")
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
    sgd_step = phase8_train_step(dev, rng)
    with tempfile.TemporaryDirectory() as tmp:
        corpus, masked_launches = phase9_trainer(Path(tmp), card)
        training = phase10_timings(dev, rng, card, corpus, Path(tmp))
        r8_err, r8_masked_err = phase11_radix8_kernel(dev, rng)
        recording, r8_launches = phase12_analyzer(Path(tmp), corpus, card)
        r8, r8_masked = phase13_analyzer_timings(dev, rng, card, Path(tmp), recording)
        conv_rows = phase14_conv_kernels(dev, rng, card)
        conv_launches = phase15_fused_cnn(dev, rng, card, Path(tmp), recording)
        mixed = phase16_mixed_radix(dev, card)
        mixed_launches = phase17_entry_points(dev, rng, card, Path(tmp), corpus, recording)
        dft_gemm = phase18_dft_gemm(dev, card, Path(tmp))
        resnet = phase20_resnet(dev, rng, card, Path(tmp), corpus, recording)
        segmented = phase21_segmented(dev, rng, card, Path(tmp), corpus)
        parallel = phase22_data_parallel(dev, rng, card, Path(tmp), corpus, recording, sgd_step)
        fused = phase23_fused_epoch(dev, rng, card, Path(tmp), corpus, sgd_step)
        host = phase24_host_and_reports(dev, rng, card, Path(tmp), corpus)
        orbax = phase25_orbax(dev, rng, card, Path(tmp), corpus)
        ranks = phase26_fused_ranks(dev, card, Path(tmp), corpus, sgd_step, fused)
        resnet_fused = phase27_resnet_fused(dev, card, Path(tmp), corpus, resnet["sgd"])
    epilogue = phase19_epilogue(dev, card)
    print(f"phase 19: the epilogue's main-path launches {EPILOGUE_MAIN_PATH['launches']}")
    check(EPILOGUE_MAIN_PATH["launches"] > 0, "the epilogue launched on the main paths")
    epilogue["launches"] = EPILOGUE_MAIN_PATH["launches"]
    for alg, n in mixed_launches.items():
        mixed[alg]["launches"] = n
    for name, numbers in conv_rows.items():
        numbers["launches"] = sum(conv_launches[k] for k in CONV_ROWS[name][2])
    serving["launches"] += (resnet["inference"] + segmented["inference"] + parallel["inference"]
                            + fused["inference"] + host["inference"] + orbax["inference"]
                            + ranks["inference"] + resnet_fused["inference"])
    training.update(launches=masked_launches + resnet["masked"] + segmented["masked"]
                    + parallel["masked"] + fused["masked"] + orbax["masked"] + ranks["masked"]
                    + resnet_fused["masked"],
                    max_abs_err=masked_err)
    r8.update(launches=r8_launches["inference"] + resnet["analyzer"] + parallel["analyzer"],
              max_abs_err=r8_err)
    r8_masked.update(launches=r8_launches["masked"], max_abs_err=r8_masked_err)

    csrc = "audio_classification_icbhi_tpu_torch/csrc/"
    pallas_mel = "audio_classification_icbhi_tpu/ops/pallas_mel.py"
    # each row's source is the one its main shape runs (`cuda_route` by n_fft)
    rows = (("log_mel_radix16dif_fused", ":1270", N_FFT, serving),
            ("log_mel_radix16dif_fused_masked", ":1270", N_FFT, training),
            ("log_mel_radix8dif_fused", ":1193", N_FFT8, r8),
            ("log_mel_radix8dif_fused_masked", ":1193", N_FFT8, r8_masked),
            *((f"log_mel_{alg}", line, n_fft, mixed[alg])
              for alg, (line, (n_fft, _), _) in MIXED_ROWS.items()),
            ("log_mel_radix4dif_fused_masked", MIXED_ROWS["radix4dif_fused"][0], 512,
             mixed["radix4dif_fused_masked"]),
            ("log_mel_radix4dif_fused_1536", MIXED_ROWS["radix4dif_fused"][0], 1536,
             mixed["radix4dif_fused_1536"]),
            ("log_mel_radix16dif_fused_16384", ":1270", 16384, mixed["radix16dif_fused_16384"]),
            *((f"log_mel_{alg}", line, B7_MAIN[0], dft_gemm[alg])
              for alg, line in (("bf16x3", ":518"), ("f32", ":497"))))
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"{csrc}{mel_kernels.cuda_route(wrapper_of(name), n_fft)}.cu",
         "replaces": pallas_mel + line, **{k: numbers[k] for k in serving}}
        for name, line, n_fft, numbers in rows]
        + [{"name": name, "route": "cuda", "source": csrc + source,
            "replaces": "audio_classification_icbhi_tpu/ops/pallas_conv.py" + line,
            **{k: conv_rows[name][k] for k in (*serving, "graph_ms")}}
           for name, (source, line, _) in CONV_ROWS.items()]
        + [{"name": "log_mel_epilogue", "route": "cuda", "source": csrc + "log_mel_epilogue.cuh",
            "replaces": pallas_mel + ":683", **{k: epilogue[k] for k in (*serving, "graph_ms")}}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


def wrapper_of(row_name: str) -> str:
    """The algorithm of a kernel-table row name: log_mel_<alg>[_masked][_<n_fft>]."""
    return re.sub(r"(_masked)?(_\d+)?$", "", row_name.removeprefix("log_mel_"))


def phase7_masked_kernel(dev, rng) -> float:
    """The training form against its plain version in float64, at the train
    steps' front-end batches (64 x 8 s at config.yaml, 128 x 3 s at
    config_segmented.yaml) and at an odd shape."""
    errs = []
    gen = torch.Generator().manual_seed(7)
    before = mel_kernels.log_mel_radix16dif_fused.launches_masked
    calls = 0
    for b, length in ((64, TRAIN_CLIP), (128, SEG_CLIP), (3, 16320)):
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


def sgd_step_margins(gpu, cpu, cpu_step, frontend):
    """`step_floor`'s margins of the card's step against the CPU's,
    each given as (metrics, model); `cpu_step(frontend)` reruns the CPU step
    and returns (metrics, model). Returns (margins, floor)."""
    def result(run):
        return param_arrays(run[1]), run[0]["grad_norm"]

    base = result(cpu)
    floor = step_floor(lambda fe: result(cpu_step(fe)), frontend, base)
    return step_margins(result(gpu), base, floor), floor


def one_train_step(model, init: dict, device, frontend, optimizer: str, lr: float, wavs, labels,
                   cw, draws=None):
    """One optimizer step (accumulation 2, weight decay 1e-4, dropout off)
    of `model` loaded with `init`, on `device`; `draws` (augmentation on)
    are the microbatches' injected augmentation draws. Returns (metrics as
    floats, model, optimizer)."""
    model.load_state_dict(init)
    model.to(device).set_dropout(0.0)
    opt = build_optimizer(optimizer, model.named_parameters(), 1e-4)
    fns = make_step_fns(model, frontend, opt, accum_steps=2, augment=draws is not None)
    m = fns.train_step(wavs.to(device), labels.to(device), cw.to(device), lr,
                       draws=None if draws is None else [draws_to(d, device) for d in draws])
    return {k: float(v) for k, v in m.items()}, model, opt


def phase8_train_step(dev, rng) -> dict:
    """One optimizer step on the card against the same step on the CPU, at
    config.yaml's front end and model with batch 8 x accumulation 2.
    Returns its inputs, the lr-1 SGD step's runs on the card and the CPU
    and their `step_floor`, which phase 22 holds its steps to."""
    cfg = load_config(str(REPO / "config.yaml"))
    fe = MelFrontend.from_config(cfg)
    a, b = 2, 8
    wavs = torch.from_numpy(synth_clips(rng, a * b, TRAIN_CLIP).reshape(a, b, TRAIN_CLIP))
    labels = torch.from_numpy(rng.integers(0, 4, (a, b))).long()
    cw = torch.tensor([1.0, 2.0, 0.5, 1.5])
    g = torch.Generator().manual_seed(8)
    draws = [aug.draw_augment(g, b, TRAIN_CLIP, N_MELS, fe.num_frames, "cpu") for _ in range(a)]
    init = LightweightCNN(generator=torch.Generator().manual_seed(0)).state_dict()

    def step(device, optimizer, lr, augment, dtype=torch.float32, head=1.0, frontend=fe):
        return one_train_step(LightweightCNN(dtype=dtype), scaled_head(init, head), device,
                              frontend, optimizer, lr, wavs, labels, cw,
                              draws if augment else None)

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
    # accumulated, clipped gradient itself, held element by element. Max-pool
    # and ReLU make it jump where a feature moves by a rounding error, so the
    # bound is `step_floor`'s: twice what a front end 1e-5 dB off moves the
    # CPU's own step (the maximum over eight seeds, at its largest in each
    # parameter tensor)
    m_gpu, model_gpu, _ = step(dev, "sgd", 1.0, augment=False)
    m_cpu, model_cpu, _ = step("cpu", "sgd", 1.0, augment=False)
    margins, floor = sgd_step_margins(
        (m_gpu, model_gpu), (m_cpu, model_cpu),
        lambda frontend: step("cpu", "sgd", 1.0, augment=False, frontend=frontend)[:2], fe)
    print(f"phase 8: sgd step, lr 1: loss cuda {m_gpu['loss']:.6f} cpu {m_cpu['loss']:.6f}; "
          f"params worst |d| over its bound {margins.params:.3f}, grad norm {margins.grad_norm:.3f} "
          f"(bound 2e-3 |p| + max(2e-5, 2 floor); the CPU step with its log-mel 1e-5 dB off, "
          f"seeds 0-7, moves params by up to {max(f.max() for f in floor.params):.2e}, the norm by "
          f"{floor.grad_norm:.2e})")
    check(abs(m_gpu["loss"] - m_cpu["loss"]) <= 1e-4 * abs(m_cpu["loss"]), "sgd step loss")
    check(margins.ok, f"sgd step params and grad norm, cuda vs cpu ({margins})")
    sgd = dict(fe=fe, wavs=wavs, labels=labels, cw=cw, init=init, floor=floor,
               card=(param_arrays(model_gpu), m_gpu["grad_norm"]), card_loss=m_gpu["loss"],
               cpu=(param_arrays(model_cpu), m_cpu["grad_norm"]))

    # (c) bf16 compute on the card
    m_bf, _, _ = step(dev, "adam", 3e-3, augment=True, dtype=torch.bfloat16)
    print(f"phase 8: bf16 augmented step on the card: loss {m_bf['loss']:.6f}, "
          f"grad_norm {m_bf['grad_norm']:.4f}")
    check(math.isfinite(m_bf["loss"]) and math.isfinite(m_bf["grad_norm"]), "finite bf16 step")
    return sgd


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
        zero_counts()
        t0 = time.perf_counter()
        history = train_entry.main(["--config", config, "--data-path", str(corpus),
                                    "--epochs", "2", "--no-plots"])
        torch.cuda.synchronize()
        read_epilogue("phase 9 training")
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
         "--data-path", str(corpus), "--epochs", "3", "--resume", str(best), "--no-plots"],
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
          f"{sum(e.count for e in kernels) / steps:.0f} device records a step (kernels, "
          f"copies and fills: phase 23 splits them)")
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
    native.ROWS.reset()
    t0 = time.perf_counter()
    n_batches = sum(1 for _ in trainer.train_loader)
    loader_s = time.perf_counter() - t0
    loader_rows = decoders()
    t0 = time.perf_counter()
    trainer.validate(2)
    val_s = time.perf_counter() - t0
    n_steps = -(-len(trainer.train_loader) // trainer.accum_steps)
    print(f"phase 10: [{card}] train epoch, {len(trainer.train_dataset)} clips, {n_steps} "
          f"optimizer steps: {epoch_s * 1e3:.1f} ms wall untraced; traced {wall_us / 1e3:.1f} ms "
          f"with the device busy {busy_us / 1e3:.1f} ms ({100 * busy_us / wall_us:.1f}%); "
          f"the loader alone, {n_batches} batches decoded: {loader_s * 1e3:.1f} ms "
          f"({loader_rows}); "
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


def decoders() -> str:
    """Which wav decoder did the rows since `native.ROWS.reset()`."""
    rows = native.ROWS.as_dict()
    return (f"wav rows decoded: native {rows['native']}, numpy codec {rows['numpy']}; "
            f"{rows['per_row']} of a batch on the per-row path")


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
        zero_counts()
        t0 = time.perf_counter()
        eng, results, csv_path = quiet(analyze.main, [
            variant, "--audio", str(recording), "--model", str(trained),
            "--segment-duration", str(duration), "--output-dir", str(tmp / "analysis"),
            "--no-plots"])
        torch.cuda.synchronize()
        read_epilogue(f"phase 12 analyze {variant}")
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
            check(n8 == 1 and n16 == 0, "sub-second windows ran radix8dif_fused")
            launches["inference"] += n8
        else:
            check(n16 == 1 and n8 == 0, "1 s windows ran radix16dif_fused")

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
    zero_counts()
    t0 = time.perf_counter()
    history = quiet(train_entry.main, ["--config", str(cfg_path), "--data-path", str(corpus),
                                       "--epochs", "1", "--no-plots"])
    torch.cuda.synchronize()
    read_epilogue("phase 12 training")
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
    native.ROWS.reset()
    t0 = time.perf_counter()
    results, _ = quiet(long.analyze_audio, long_path)
    whole = time.perf_counter() - t0
    print(f"phase 13: [{card}] analyzer, 10-minute recording, max_duration=None, 2,400 windows "
          f"of 0.5 s: device pass median {np.median(times) * 1e3:.3f} ms = "
          f"{2400 / np.median(times):.1f} windows/s; analyze_audio end to end (wav decode "
          f"included) {whole * 1e3:.1f} ms for {len(results)} windows ({decoders()})")
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
             ("fused_conv_block3", rand(1, 16, 20, 64), {}), ("fused_conv_block3", rand(3, 18, 19, 64), {}),
             # block 3's tile edges at the serving depth: a tile row is 20 columns
             *(("fused_conv_block3", rand(2, 32, w, 64), {}) for w in (38, 39, 40, 41))]
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
        differ = int((got != want).sum())
        print(f"phase 14: {name} {tuple(x.shape)} {x.dtype} {kw or ''}: max|kernel - plain| = "
              f"{err:.3e} (max |plain| {want.float().abs().max().item():.3f}; tol one bf16 ulp); "
              f"{differ} of {want.numel()} outputs differ from the plain version")
        check(ok, f"{name} within one bf16 ulp of its plain version at {tuple(x.shape)} {kw}")
    check(fused_kernels_available() is True, "fused_kernels_available()")
    print("phase 14: fused_kernels_available() passed")
    for what, x in (("block 1", feats), ("block 2", x2), ("block 3", x3),
                    ("block 3, analyzer", xa3)):
        print(f"phase 14: {what} {tuple(x.shape)}: {ck.kernel_occupancy(x)}")
    built = _build.build_all()
    for source, opcodes in (("fused_conv_packed", ("HGMMA", "UTMALDG")),
                            ("fused_conv_block1", ("HMMA",))):
        counts = sass_counts(built[source][0], opcodes)
        print(f"phase 14: {source} SASS: {counts}")
        check(all(n > 0 for n in counts.values()), f"{source} runs on {opcodes}")

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
    # fused apply calls: the kernel's eager time by CUDA events (`ms`, as
    # every row) and as 20 calls in a CUDA graph (`graph_ms`); the yardstick
    # is the port's cuDNN ConvBlock
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
            kernel_ms = cuda_ms(kernel, iters=50)  # eager, as every other row
            device_ms = graph_ms(kernel)  # the host's launch cost out of the way
            plain_ms = cuda_ms(plain, iters=20)
            library_ms = cuda_ms(lambda: block(nchw), iters=50)
            # the matrix work alone: cuDNN's bf16 conv, channels_last (x is NHWC)
            xc = nchw.to(torch.bfloat16)
            wc = folded[blk].weight.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
            conv_ms = cuda_ms(lambda: F.conv2d(xc, wc, padding=1), iters=50)
            bound_ms, bound_by, floors = conv_bound_ms(x, folded[blk])
            per[name] = {"ms": kernel_ms, "graph_ms": device_ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}
            print(f"phase 14: [{card}] {name} {tuple(x.shape)} {x.dtype}: kernel {kernel_ms:.4f} ms "
                  f"(eager; {device_ms:.4f} as a CUDA graph), plain {plain_ms:.4f} ms, cuDNN ConvBlock yardstick {library_ms:.4f} ms, cuDNN "
                  f"bf16 conv alone (channels_last) {conv_ms:.4f} ms, bound {bound_ms:.4f} ms "
                  f"({bound_by}; bytes {floors['bytes']:.4f}, operations {floors['operations']:.4f})")
    packed = {k: per["fused_conv_block2"][k] + per["fused_conv_block3"][k]
              for k in ("ms", "graph_ms", "plain_ms", "bound_ms", "library_ms")}
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
    for fn, attr in tracing.launch_counters():
        setattr(fn, attr, 0)
    tracing.reset()


def graph_count(what: str, kind: str) -> int:
    """The recorder's count of graph `what` ("captures", "replays") of
    `kind` since the last `zero_counts`."""
    return tracing.counters().get(f"graph.{what}.{kind}", 0)


def capture_ms() -> str:
    """Each kind's warm-up and capture host ms since the last
    `zero_counts`, from the recorder's spans."""
    out = []
    for kind in ("train", "eval"):
        cap, warm = tracing.stat(f"graph.capture.{kind}"), tracing.stat(f"graph.warmup.{kind}")
        if cap is not None:
            out.append(f"{kind} {warm.total_ms if warm else 0.0:.1f} + {cap.total_ms:.1f} ms")
    return ", ".join(out) or "none"


# the epilogue's launches over every main-path run (`read_epilogue`)
EPILOGUE_MAIN_PATH = {"launches": 0}


def read_epilogue(what: str) -> None:
    """After a main-path run whose counts `zero_counts` set to 0: the
    epilogue launched once with each log-mel wrapper launch; its count adds
    to the kernels line's `log_mel_epilogue` launches."""
    n = mel_kernels.log_mel_epilogue.launches
    calls = sum(fn.launches + fn.launches_masked for fn in mel_kernels.WRAPPERS.values())
    check(n == calls, f"{what}: the epilogue launched with each log-mel call ({n} of {calls})")
    EPILOGUE_MAIN_PATH["launches"] += n


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
            "--segment-duration", "0.5", "--output-dir", str(tmp / "fused_analysis"),
            "--no-plots"])
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

    host_ms = {"cuDNN": [], "fused": []}
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
            host_ms[name].append(dt / reps * 1e3)
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
    # the device's time a batch with the host out of the way (the profiler
    # drops kernel records on this card): one step captured as a CUDA graph
    # and replayed, by CUDA events, beside the host clock's time a batch
    with torch.inference_mode():
        for name in ("fused", "cuDNN"):
            device_ms = graph_ms(lambda: step(applies[name]), calls=1, iters=20)
            nodes, _ = graph_nodes(lambda: step(applies[name]))
            wall = float(np.mean(host_ms[name]))
            print(f"phase 15: [{card}] {name} wav->logits batch {BATCH}: device {device_ms:.4f} "
                  f"ms a batch (a CUDA graph of one step, "
                  f"{sum(kind == 'kernel' for kind, _ in nodes)} kernel nodes) against "
                  f"{wall:.4f} ms a batch by the host clock: device busy "
                  f"{100 * device_ms / wall:.1f}%")
    return {k: serve[k] + ana[k] for k in CONV_WRAPPERS}


# phases 16-17: the mixed-radix log-mel kernel (`csrc/log_mel_mixed_radix.cu`).
# Each kernel-table row it serves: (TPU kernel line in pallas_mel.py, the main
# shape it is timed at, the shapes held against its plain version)
MIXED_ROWS = {
    "radix4dif_fused": (":1037", (512, 128), ((512, 128), (1536, 384), (2048, 512), (2048, 256))),
    "radix4_fused": (":861", (2048, 512), ((2048, 512),)),
    "radix2_fused": (":723", (768, 256), ((768, 256), (1280, 256), (2048, 512))),
    "radix2": (":633", (800, 200), ((800, 200), (400, 160), (2048, 512))),
}
# rows 1-2 at n_fft that log_mel_radix8dif.cu does not take, which run the
# mixed-radix kernel, up to its limit (16,384: 131,072 bytes of shared memory
# a block on its block path)
MIXED_RADIX_ROWS_1_2 = (("radix16dif_fused", (6144, 512)), ("radix8dif_fused", (3072, 768)),
                        ("radix8dif_fused", (12288, 1536)), ("radix16dif_fused", (16384, 1024)))
# the shapes where both log-mel sources can run, timed side by side: rows
# 1-2's main shapes, both forms, and row 1 at the other n_fft the radix-8
# source takes; (algorithm, batch, length, n_fft, hop, masked)
SOURCE_SHAPES = (
    ("radix16dif_fused", BATCH, CLIP, 2048, 512, False),
    ("radix16dif_fused", 64, TRAIN_CLIP, 2048, 512, True),
    ("radix8dif_fused", 64, WINDOW, N_FFT8, HOP8, False),
    ("radix8dif_fused", 2400, WINDOW, N_FFT8, HOP8, False),
    ("radix8dif_fused", 64, TRAIN_CLIP, N_FFT8, HOP8, True),
    ("radix16dif_fused", BATCH, CLIP, 4096, 1024, False),
    ("radix16dif_fused", BATCH, CLIP, 8192, 2048, False),
)


def phase16_mixed_radix(dev, card: str) -> dict[str, dict]:
    """Rows 3-6, and rows 1-2 at the mixed-radix kernel's n_fft, through
    their wrappers (each line names the source `cuda_route` picked): against
    the plain version in float64 on seeded noise (B 3, odd length), both
    forms of the fused rows with edge bounds, row 3's training form also at
    the train step's 64 x 8 s; against the float64 golden over the parity
    battery at 5 and 1 s, unrestricted at n_fft >= 1536 and in the 25 dB
    active region below it (where no f32 chain holds 1e-3 dB on tonal clips'
    cells 80-89 dB below their peak; the plain f32 chain's error on the card
    is printed beside); rows 4 and 6 through `MelFrontend(backend="pallas")`
    with their counts read around the run; then each row timed at 128 x 5 s
    at its main shape, row 3's training form at 64 x 8 s, and the two
    sources side by side (`compare_sources`), row 3 also at 1536/384; then
    each source alone (`radix8_design`, `mixed_radix_design`). Returns the
    kernel-line numbers of rows 3-6, row 3's training form and row 3 at
    1536/384 but their launches, which rows 3 and 5 take from phase 17 and
    rows 4 and 6 from the MelFrontend run here."""
    rng = np.random.default_rng(16)  # its own stream: the inputs do not depend on earlier phases
    gen = torch.Generator().manual_seed(16)
    wrappers = mel_kernels.WRAPPERS
    before = {alg: (fn.launches, fn.launches_masked) for alg, fn in wrappers.items()}
    calls = {alg: [0, 0] for alg in wrappers}
    errs = {(alg, masked): [] for alg in wrappers for masked in (False, True)}
    errs_at = {}  # (alg, n_fft, hop) -> errors of both forms
    cases = [(alg, shape) for alg, (_, _, shapes) in MIXED_ROWS.items() for shape in shapes]
    cases += list(MIXED_RADIX_ROWS_1_2)

    def against_plain(alg, n_fft, hop, b, length, forms):
        source = mel_kernels.cuda_route(alg, n_fft)
        t = 1 + length // hop
        x = (0.1 * rng.standard_normal((b, length))).astype(np.float32)
        x[1] *= 20.0
        xt = torch.from_numpy(x).to(dev)
        bounds = edge_bounds(b, t, gen).to(dev)
        for kw, masked, tol, beside in forms:
            if masked:
                kw = dict(kw, spec_mask_bounds=bounds)
            got = wrappers[alg](xt, SR, n_fft, hop, N_MELS, **kw)
            calls[alg][masked] += 1
            want = mel_kernels.log_mel_fused_reference(xt.double(), SR, n_fft, hop, N_MELS, **kw)
            torch.cuda.synchronize()
            check(got.shape == (b, N_MELS, t), f"{alg} shape {tuple(got.shape)}")
            check(bool(torch.isfinite(got).all()), f"finite {alg} output")
            diff = (got.double() - want).abs()
            err = diff.max().item()
            what = ("masked, " if masked else "") + ("top_db 60 + normalize" if
                                                     "normalize" in kw else "dB")
            line = (f"phase 16: log_mel_{alg} {n_fft}/{hop} ({source}) B={b} L={length} "
                    f"{what}: max|kernel - plain f64| = {err:.3e}")
            if beside:  # the plain f32 chain's error, and the 25 dB active region's
                plain = mel_kernels.log_mel_fused_reference(xt, SR, n_fft, hop, N_MELS, **kw)
                plain_err = (plain.double() - want).abs().max().item()
                active = diff[want >= want.amax(dim=(1, 2), keepdim=True) - 25.0].max().item()
                line += (f" (plain f32 on the card {plain_err:.3e}; {active:.3e} within 25 dB "
                         f"of the example's peak)")
            errs[alg, masked].append(err)
            errs_at.setdefault((alg, n_fft, hop), []).append(err)
            print(f"{line} (tol {tol:g})")
            check(err <= tol, f"{alg} vs plain at {n_fft}/{hop} B={b} {what}")

    epilogue = dict(top_db=60.0, normalize=True)
    for alg, (n_fft, hop) in cases:
        forms = [({}, False, 1e-3, False), (epilogue, False, 2e-3, False)]
        if alg != "radix2":
            forms.append((epilogue, True, 2e-3, False))
        against_plain(alg, n_fft, hop, 3, 16321, forms)
    # row 3's training form at the shape the training path gives it: 64 x 8 s
    # (1001 frames), bounds drawn as the train step draws them, edges included.
    # dB only, 64k frames of noise put single-bin low mels far below their
    # frame's level, where f32 rounding counts most: the plain f32 chain's
    # error is printed beside.
    against_plain("radix4dif_fused", 512, 128, 64, TRAIN_CLIP,
                  [({}, True, 1e-3, True), (epilogue, True, 2e-3, False)])

    golden = {}
    for alg, (n_fft, hop) in cases:
        for duration in (5.0, 1.0):
            key = (n_fft, hop, duration)
            if key not in golden:
                wavs = parity_battery(int(SR * duration))
                want = np.stack([golden_mel(w, SR, n_fft, hop, N_MELS) for w in wavs])
                plain = mel_kernels.log_mel_fused_reference(
                    torch.from_numpy(wavs).to(dev), SR, n_fft, hop, N_MELS).double().cpu().numpy()
                active = want >= want.max(axis=(1, 2), keepdims=True) - 25.0
                golden[key] = (wavs, want, active, np.abs(plain - want))
            wavs, want, active, plain_err = golden[key]
            got = wrappers[alg](torch.from_numpy(wavs).to(dev), SR, n_fft, hop,
                                N_MELS).double().cpu().numpy()
            calls[alg][0] += 1
            err = np.abs(got - want)
            unrestricted = n_fft >= 1536
            print(f"phase 16: log_mel_{alg} {n_fft}/{hop} ({mel_kernels.cuda_route(alg, n_fft)}) "
                  f"golden {duration:g} s: max|kernel - "
                  f"f64 golden| = {err.max():.3e} dB all cells, {err[active].max():.3e} active "
                  f"(tol 1e-3 {'unrestricted' if unrestricted else 'active'}); plain f32 on the "
                  f"card {plain_err.max():.3e} / {plain_err[active].max():.3e}")
            check((err.max() if unrestricted else err[active].max()) <= 1e-3,
                  f"{alg} vs golden at {n_fft}/{hop}, {duration} s")
    rose = {alg: [fn.launches - before[alg][0], fn.launches_masked - before[alg][1]]
            for alg, fn in wrappers.items()}
    print(f"phase 16: launches rose by {rose} over {calls} calls (inference, masked)")
    check(rose == calls, "every wrapper counts every launch of each form")

    # rows 4 and 6 as a user reaches them: MelFrontend(backend="pallas")
    # (row 4 only by naming it), the counts zeroed before and read after;
    # row 4's training form through the augmented features
    launches = {}
    clips = synth_clips(rng, 8)
    x = torch.from_numpy(clips).to(dev)
    for alg, n_fft, hop in (("radix4_fused", 2048, 512), ("radix2", 800, 200)):
        fe = MelFrontend(n_fft=n_fft, hop_length=hop, duration=5.0, backend="pallas",
                         pallas_algorithm="radix4_fused" if alg == "radix4_fused" else None)
        check(fe._pallas_algorithm() == alg, f"MelFrontend picks {alg} at {n_fft}/{hop}")
        draws = aug.draw_augment(gen, 8, CLIP, N_MELS, fe.num_frames, "cpu")
        zero_counts()
        outs = {"inference": fe(x), "log_mel": fe.log_mel(x)}
        if alg != "radix2":
            outs["masked"] = features_from_wavs(fe, x, augment=True, draws=draws_to(draws, dev))[..., 0]
        torch.cuda.synchronize()
        read_epilogue(f"phase 16 MelFrontend {alg}")
        launches[alg] = wrappers[alg].launches + wrappers[alg].launches_masked
        check(wrappers[alg].launches == 2 and wrappers[alg].launches_masked == len(outs) - 2,
              f"MelFrontend(backend='pallas') launched {alg} in each form")
        # the same front end on the CPU in float64: the plain chain itself
        x64 = torch.from_numpy(clips).double()
        want = {"inference": fe(x64), "log_mel": fe.log_mel(x64)}
        if alg != "radix2":
            want["masked"] = features_from_wavs(fe, x64, augment=True, draws=draws)[..., 0]
        for form, got in outs.items():
            err = (got.double().cpu() - want[form]).abs().max().item()
            tol = 1e-3 if form == "log_mel" else 2e-3
            print(f"phase 16: MelFrontend(backend='pallas') {alg} {n_fft}/{hop}, 8 x 5 s, {form}: "
                  f"max|cuda - cpu f64| = {err:.3e} (tol {tol:g})")
            check(err <= tol, f"MelFrontend {alg} {form}, cuda vs cpu")
    print(f"phase 16: MelFrontend(backend='pallas') launches {launches}")

    rows = {}
    x = torch.from_numpy(synth_clips(rng, BATCH)).to(dev)
    timed = [(alg, alg, n_fft, hop) for alg, (_, (n_fft, hop), _) in MIXED_ROWS.items()]
    timed.append(("radix4dif_fused_1536", "radix4dif_fused", 1536, 384))
    for key, alg, n_fft, hop in timed:
        kw = dict(normalize=True)
        bound_ms, bound_by, floors = bound(BATCH, CLIP, dev, n_fft, hop)
        kernel_ms = cuda_ms(lambda: wrappers[alg](x, SR, n_fft, hop, N_MELS, **kw), iters=50)
        plain_ms = cuda_ms(lambda: mel_kernels.log_mel_fused_reference(
            x, SR, n_fft, hop, N_MELS, **kw), iters=10)
        library_ms = cuda_ms(yardstick(x, n_fft, hop), iters=20)
        print(f"phase 16: [{card}] log_mel_{alg} {n_fft}/{hop} B={BATCH} x 5 s: kernel "
              f"{kernel_ms:.4f} ms, plain f32 {plain_ms:.4f} ms, torch.stft yardstick "
              f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; bytes "
              f"{floors['bytes']:.4f}, operations {floors['operations']:.4f}, bytes with the dB "
              f"scratch {floors['bytes_with_scratch']:.4f})")
        # row 3's forms are two lines of the kernel table (and 1536/384 a
        # third, on the mixed-radix source); rows 4-6 one each
        err = (errs_at[alg, n_fft, hop] if key != alg else
               errs[alg, False] + ([] if alg == "radix4dif_fused" else errs[alg, True]))
        rows[key] = {"max_abs_err": max(err), "ms": kernel_ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}
        if key in launches:  # rows 4 and 6; rows 3 and 5 count in phase 17
            rows[key]["launches"] = launches[key]
    # row 3's training form at the train step's front-end batch (64 x 8 s)
    xm = torch.from_numpy(synth_clips(rng, 64, TRAIN_CLIP)).to(dev)
    bounds = edge_bounds(64, 1 + TRAIN_CLIP // 128, torch.Generator().manual_seed(17)).to(dev)
    kw = dict(normalize=True, spec_mask_bounds=bounds)
    bound_ms, bound_by, _ = bound(64, TRAIN_CLIP, dev, 512, 128)
    kernel_ms = cuda_ms(lambda: wrappers["radix4dif_fused"](xm, SR, 512, 128, N_MELS, **kw),
                        iters=20)
    plain_ms = cuda_ms(lambda: mel_kernels.log_mel_fused_reference(
        xm, SR, 512, 128, N_MELS, **kw), iters=5)
    library_ms = cuda_ms(yardstick(xm, 512, 128, bounds), iters=10)
    print(f"phase 16: [{card}] masked log_mel_radix4dif_fused 512/128 B=64 x 8 s: kernel "
          f"{kernel_ms:.4f} ms, plain f32 {plain_ms:.4f} ms, torch.stft yardstick "
          f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    rows["radix4dif_fused_masked"] = {
        "max_abs_err": max(errs["radix4dif_fused", True]), "ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms}
    compare_sources(dev, card, rng)
    radix8_design(dev, card, rng)
    rows["radix16dif_fused_16384"] = mixed_radix_design(dev, card, rng)
    return rows


def compare_sources(dev, card: str, rng: np.random.Generator, shapes=SOURCE_SHAPES,
                    sources=("log_mel_radix8dif", "log_mel_mixed_radix"), phase: int = 16) -> None:
    """Two log-mel sources at each of `shapes`, through
    `mel_kernels.run_source` (launches counted nowhere): each against the
    plain version in float64 (normalize on; tol 2e-3), then timed by CUDA
    events, alternating, twice each. `cuda_route` sends each shape to one
    of the two, marked "(routed)"; the lines say where each source wins."""
    kw = dict(f_min=0.0, f_max=None, top_db=None, mel_scale="htk", norm=None,
              normalize=True, eps=1e-8)
    for alg, b, length, n_fft, hop, masked in shapes:
        routed = mel_kernels.cuda_route(alg, n_fft)
        check(routed in sources, f"{alg} at {n_fft} routes to one of {sources}")
        x = torch.from_numpy(synth_clips(rng, b, length)).to(dev)
        bounds = (edge_bounds(b, 1 + length // hop, torch.Generator().manual_seed(16)).to(dev)
                  if masked else None)
        want = mel_kernels.log_mel_fused_reference(x.double(), SR, n_fft, hop, N_MELS,
                                                   normalize=True, spec_mask_bounds=bounds)
        runs = {s: (lambda s=s: mel_kernels.run_source(
            s, x, SR, n_fft, hop, N_MELS, spec_mask_bounds=bounds, **kw)) for s in sources}
        errs = {s: (run().double() - want).abs().max().item() for s, run in runs.items()}
        del want
        iters = 20 if b * length > 5e6 else 50
        times = {s: [] for s in sources}
        for _ in range(2):
            for s, run in runs.items():
                times[s].append(cuda_ms(run, iters))
        print(f"phase {phase}: [{card}] sources at {alg} {n_fft}/{hop} B={b} x {length / SR:g} s"
              f"{', masked' if masked else ''}, normalize: " + "; ".join(
                  f"{s}{' (routed)' if s == routed else ''} {times[s][0]:.4f} / "
                  f"{times[s][1]:.4f} ms (max|- plain f64| {errs[s]:.3e})" for s in sources))
        check(max(errs.values()) <= 2e-3, f"both sources vs plain at {alg} {n_fft}/{hop}")


# the radix-8 source's previous design (u rows and constants in shared
# memory): warps an SM at each n_fft, the floor the new one must keep
RADIX8_PREVIOUS_WARPS = {1024: 24, 2048: 8, 4096: 7, 8192: 3}
# row 3's shapes at 512/128, where the radix-8 source's smallest instance is
# timed against the mixed-radix one: the serving batch and the train step's
# masked front end
RADIX8_512_SHAPES = (("radix4dif_fused", BATCH, CLIP, 512, 128, False),
                     ("radix4dif_fused", 64, TRAIN_CLIP, 512, 128, True))


def radix8_design(dev, card: str, rng: np.random.Generator) -> None:
    """`csrc/log_mel_radix8dif.cu` alone: each instance's launch shape from
    its `log_mel_radix8dif_occupancy` (warps an SM no fewer than the
    previous design's); at every SOURCE_SHAPES shape and at 512/128 (both
    forms) the spectrum kernel alone (CUDA events on preallocated buffers,
    as the profiler may drop kernel records: PERF.md §7) beside the whole
    call (`run_source`), and two calls bit-equal; one wrapper call captured
    as a CUDA graph: two kernel nodes, each named, the spectrum kernel and
    the epilogue."""
    for n_fft in mel_kernels.RADIX8_N_FFT:
        occ = mel_kernels.radix8_occupancy(n_fft, dev.index or 0)
        print(f"phase 16: [{card}] log_mel_radix8dif n_fft {n_fft}: {occ['warps_per_sm']} warps "
              f"an SM ({occ['blocks_per_sm']} blocks of {occ['warps_per_block']}), "
              f"{occ['registers']} registers a thread, {occ['smem_bytes']} shared bytes a block "
              f"(previous design {RADIX8_PREVIOUS_WARPS.get(n_fft, '-')} warps an SM)")
        check(occ["warps_per_sm"] >= RADIX8_PREVIOUS_WARPS.get(n_fft, 1),
              f"radix-8 warps an SM at {n_fft} no fewer than before")
    kw = dict(f_min=0.0, f_max=None, top_db=None, mel_scale="htk", norm=None,
              normalize=True, eps=1e-8)
    for alg, b, length, n_fft, hop, masked in SOURCE_SHAPES + RADIX8_512_SHAPES:
        x = torch.from_numpy(synth_clips(rng, b, length)).to(dev)
        bounds = (edge_bounds(b, 1 + length // hop, torch.Generator().manual_seed(16)).to(dev)
                  if masked else None)
        db = torch.empty((b, 1 + length // hop, N_MELS), dtype=torch.float32, device=dev)

        def spectrum():
            mel_kernels.spectrum_only("log_mel_radix8dif", x, SR, n_fft, hop, N_MELS, db)

        def call():
            return mel_kernels.run_source("log_mel_radix8dif", x, SR, n_fft, hop, N_MELS,
                                          spec_mask_bounds=bounds, **kw)

        equal = torch.equal(call(), call())
        iters = 20 if b * length > 5e6 else 50
        times = [cuda_ms(f, iters) for f in (spectrum, call, spectrum, call)]
        print(f"phase 16: [{card}] log_mel_radix8dif at {alg} {n_fft}/{hop} B={b} x "
              f"{length / SR:g} s{', masked' if masked else ''}: spectrum kernel alone "
              f"{times[0]:.4f} / {times[2]:.4f} ms, the whole call {times[1]:.4f} / "
              f"{times[3]:.4f} ms; two calls bit-equal: {equal}")
        check(equal, f"two radix-8 calls give equal bits at {n_fft}/{hop}")
        del x, db
    compare_sources(dev, card, rng, RADIX8_512_SHAPES)

    # the launches of one wrapper call, as the nodes of a CUDA graph that
    # captures it (the profiler here drops kernel records: PERF.md §7)
    x = torch.from_numpy(synth_clips(rng, BATCH)).to(dev)
    wrapper = mel_kernels.log_mel_radix16dif_fused
    eager = wrapper(x, SR, N_FFT, HOP, N_MELS, normalize=True)
    nodes, graph_out = graph_nodes(lambda: wrapper(x, SR, N_FFT, HOP, N_MELS, normalize=True))
    print(f"phase 16: [{card}] one log_mel_radix16dif_fused call at {N_FFT}/{HOP}, B={BATCH}, "
          f"captured as a CUDA graph: {len(nodes)} nodes {nodes}; replay equals the eager call: "
          f"{torch.equal(graph_out, eager)}")
    stems = ("log_mel_radix8dif_kernel", "log_mel_epilogue_kernel")
    found = [[stem for stem in stems if name and stem in name] for _, name in nodes]
    check([kind for kind, _ in nodes] == ["kernel", "kernel"]
          and sorted(sum(found, [])) == sorted(stems) and all(len(f) == 1 for f in found),
          "the radix-8 route launches the spectrum kernel and the epilogue, nothing else")
    check(torch.equal(graph_out, eager), "the captured call replays the eager one")


# the mixed-radix source alone: rows 5, 6 and 3 at their shapes, the 25 ms /
# 10 ms speech front end (400/160, two pairs a warp), 1280/256, the other
# warp instances at 448/160 (the radix-7 butterfly; a hop that does not
# divide n_fft) and 480/160 (m = 15); then BLOCK_SHAPES; (batch, n_fft, hop)
MIXED_WARP_SHAPES = ((BATCH, 768, 256), (BATCH, 800, 200), (BATCH, 1536, 384),
                     (BATCH, 400, 160), (BATCH, 1280, 256), (BATCH, 448, 160), (BATCH, 480, 160))
# the block path (no warp instance), 128 clips of 5 s: 1200/300 (m = 75: the
# staged radix-3/5/5 passes), 1100/275 (m = 275 = 5^2 11) and 4036/1009 (m =
# 1009; also at 8 clips, as earlier PRs timed it), Bluestein; 12288/1536 (P =
# 4096, m = 3) and 16384/1024 (P = 16,384), rows 1-2 there; 16380/4095 (m =
# 4095 = 3^2 5 7 13: Bluestein at M = 8192, the most shared memory of any
# n_fft)
BLOCK_SHAPES = ((BATCH, 1200, 300), (BATCH, 1100, 275), (8, 4036, 1009), (BATCH, 4036, 1009),
                (BATCH, 12288, 1536), (BATCH, 16380, 4095), (BATCH, 16384, 1024))
MIXED_DESIGN_SHAPES = MIXED_WARP_SHAPES + BLOCK_SHAPES
# n_fft whose launch shape phase 16 prints: every warp instance of the
# source (the first nine), then its block path
MIXED_OCCUPANCY_N_FFT = (400, 448, 480, 768, 800, 1280, 1536, 3072, 6144, 1200, 1100, 4036,
                         12288, 16380, 16384)


def golden_errors(run, n_fft: int, hop: int, duration: float) -> tuple[float, float]:
    """max |run(battery) - f64 golden| over the parity battery of `duration`
    seconds, all cells and the 25 dB active region; run takes the (8, L)
    float32 battery on the card and returns dB (8, n_mels, T)."""
    wavs = parity_battery(int(SR * duration))
    want = np.stack([golden_mel(w, SR, n_fft, hop, N_MELS) for w in wavs])
    got = run(torch.from_numpy(wavs).cuda()).double().cpu().numpy()
    err = np.abs(got - want)
    active = want >= want.max(axis=(1, 2), keepdims=True) - 25.0
    return float(err.max()), float(err[active].max())


def mixed_radix_design(dev, card: str, rng: np.random.Generator) -> dict:
    """`csrc/log_mel_mixed_radix.cu` alone: the launch shape of each
    MIXED_OCCUPANCY_N_FFT from `log_mel_mixed_radix_occupancy` (path, warps
    an SM, registers, shared bytes; each warp instance on a warp path, each
    other n_fft on the block path with `mel_kernels.block_plan`'s shared
    bytes, Bluestein length and columns); at each MIXED_DESIGN_SHAPES shape
    the whole call against the plain version in float64 (normalize on, tol
    2e-3), the spectrum kernel alone on preallocated buffers beside the
    whole call (CUDA events, in turns), and two calls bit-equal; at each
    BLOCK_SHAPES shape also the plain version's time, the torch.stft
    yardstick and the bound, and the golden gate over the parity battery at
    5 and 1 s (1e-3 dB, unrestricted at n_fft >= 1536, in the 25 dB active
    region below); one row-5 call at 768/256 captured as a CUDA graph: two
    kernel nodes, the warp spectrum kernel and the epilogue, so no
    reflect-pad gather. Returns the block path's kernel-line numbers at
    16384/1024 (row 1 there) but its launches, which phase 17 counts."""
    paths = {}
    for n_fft in MIXED_OCCUPANCY_N_FFT:
        occ = mel_kernels.mixed_radix_occupancy(n_fft, dev.index or 0)
        paths[n_fft] = occ["path"]
        print(f"phase 16: [{card}] log_mel_mixed_radix n_fft {n_fft} (P {n_fft & -n_fft}, m "
              f"{n_fft // (n_fft & -n_fft)}): {occ['path']} path, {occ['warps_per_sm']} warps "
              f"an SM ({occ['blocks_per_sm']} blocks of {occ['warps_per_block']}), "
              f"{occ['registers']} registers a thread, {occ['smem_bytes']} shared bytes a block"
              + (f"; {'Bluestein M ' + str(occ['bluestein']) + ', ' + str(occ['columns']) + ' columns a round' if occ['bluestein'] else 'staged radix-3/5/7 passes'}"
                 if occ["path"] == "block" else ""))
        check(occ["warps_per_sm"] > 0, f"the mixed-radix source launches at n_fft {n_fft}")
        if occ["path"] == "block":
            plan = mel_kernels.block_plan(n_fft)
            check((occ["smem_bytes"], occ["bluestein"], occ["columns"], 32 * occ["warps_per_block"])
                  == (plan["smem_bytes"], plan["bluestein"], plan["columns"], plan["threads"]),
                  f"the block path's plan at {n_fft} is `mel_kernels.block_plan`'s")
    check(all(paths[n] != "block" for n in MIXED_OCCUPANCY_N_FFT[:9])
          and all(paths[n] == "block" for n in MIXED_OCCUPANCY_N_FFT[9:]),
          "every warp instance (rows 3, 5 and 6 among them) runs a warp path, the rest the block path")
    kw = dict(f_min=0.0, f_max=None, top_db=None, mel_scale="htk", norm=None,
              normalize=True, eps=1e-8, spec_mask_bounds=None)
    row = {}
    for b, n_fft, hop in MIXED_DESIGN_SHAPES:
        x = torch.from_numpy(synth_clips(rng, b)).to(dev)
        db = torch.empty((b, 1 + CLIP // hop, N_MELS), dtype=torch.float32, device=dev)

        def spectrum():
            mel_kernels.spectrum_only("log_mel_mixed_radix", x, SR, n_fft, hop, N_MELS, db)

        def call():
            return mel_kernels.run_source("log_mel_mixed_radix", x, SR, n_fft, hop, N_MELS, **kw)

        want = mel_kernels.log_mel_fused_reference(x.double(), SR, n_fft, hop, N_MELS,
                                                   normalize=True)
        first = call()
        err = (first.double() - want).abs().max().item()
        del want
        equal = torch.equal(first, call())
        times = [cuda_ms(f, 50) for f in (spectrum, call, spectrum, call)]
        path = paths.get(n_fft) or mel_kernels.mixed_radix_occupancy(n_fft, dev.index or 0)["path"]
        print(f"phase 16: [{card}] log_mel_mixed_radix at {n_fft}/{hop} ({path} path) "
              f"B={b} x 5 s: spectrum kernel "
              f"alone {times[0]:.4f} / {times[2]:.4f} ms, the whole call {times[1]:.4f} / "
              f"{times[3]:.4f} ms; max|- plain f64| {err:.3e} (tol 2e-3); two calls bit-equal: "
              f"{equal}")
        check(err <= 2e-3, f"the mixed-radix source vs plain at {n_fft}/{hop}")
        check(equal, f"two mixed-radix calls give equal bits at {n_fft}/{hop}")
        if (b, n_fft, hop) in BLOCK_SHAPES:
            bound_ms, bound_by, floors = bound(b, CLIP, dev, n_fft, hop)
            plain_ms = cuda_ms(lambda: mel_kernels.log_mel_fused_reference(
                x, SR, n_fft, hop, N_MELS, normalize=True), iters=5)
            library_ms = cuda_ms(yardstick(x, n_fft, hop), iters=10)
            gates = []
            for duration in (5.0, 1.0):
                all_cells, active = golden_errors(lambda w: mel_kernels.run_source(
                    "log_mel_mixed_radix", w, SR, n_fft, hop, N_MELS, **dict(kw, normalize=False)),
                    n_fft, hop, duration)
                gates.append((all_cells, active))
                unrestricted = n_fft >= 1536
                check((all_cells if unrestricted else active) <= 1e-3,
                      f"the block path vs golden at {n_fft}/{hop}, {duration} s")
            print(f"phase 16: [{card}] block path {n_fft}/{hop} B={b} x 5 s: the whole call "
                  f"{min(times[1], times[3]):.4f} ms, plain f32 {plain_ms:.4f} ms, torch.stft "
                  f"yardstick {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; bytes "
                  f"{floors['bytes']:.4f}, operations {floors['operations']:.4f}); golden 5 s / 1 s: "
                  + " / ".join(f"{a:.3e} all cells, {c:.3e} active" for a, c in gates)
                  + f" (tol 1e-3 {'unrestricted' if n_fft >= 1536 else 'active'})")
            if n_fft == 16384:
                row = {"max_abs_err": err, "ms": times[3], "plain_ms": plain_ms,
                       "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}
        del x, db, first

    x = torch.from_numpy(synth_clips(rng, BATCH)).to(dev)
    wrapper = mel_kernels.log_mel_radix2_fused
    eager = wrapper(x, SR, 768, 256, N_MELS, normalize=True)
    nodes, graph_out = graph_nodes(lambda: wrapper(x, SR, 768, 256, N_MELS, normalize=True))
    print(f"phase 16: [{card}] one log_mel_radix2_fused call at 768/256, B={BATCH}, captured as "
          f"a CUDA graph: {len(nodes)} nodes {nodes}; replay equals the eager call: "
          f"{torch.equal(graph_out, eager)}")
    stems = ("log_mel_mixed_radix_warp_kernel", "log_mel_epilogue_kernel")
    found = [[stem for stem in stems if name and stem in name] for _, name in nodes]
    check([kind for kind, _ in nodes] == ["kernel", "kernel"]
          and sorted(sum(found, [])) == sorted(stems) and all(len(f) == 1 for f in found),
          "row 5 launches the warp spectrum kernel and the epilogue, nothing else")
    check(torch.equal(graph_out, eager), "the captured call replays the eager one")
    return row


# `--parent`: run in a subprocess whose cwd is a checkout: loads this file,
# which then imports that checkout's package
PARENT_TIMER = """
import importlib.util, json, sys
sys.path.insert(0, sys.argv[1])
spec = importlib.util.spec_from_file_location("smoke_timer", sys.argv[2])
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
print(json.dumps(smoke.mel_times()))
"""
# the epilogue's shapes: (what, batch, clip length, n_fft, hop, masked): the
# serving batch at 2048/512, the train step's front end (64 x 8 s) at rows
# 1-3's n_fft in their training form, row 3 at 512/128 serving, and the
# analyzer's bucket (64 windows of 0.5 s, 1024/256)
EPILOGUE_SHAPES = (("serving 2048/512", BATCH, CLIP, 2048, 512, False),
                   ("row 1 masked 2048/512", 64, TRAIN_CLIP, 2048, 512, True),
                   ("row 2 masked 1024/256", 64, TRAIN_CLIP, 1024, 256, True),
                   ("row 3 512/128", BATCH, CLIP, 512, 128, False),
                   ("row 3 masked 512/128", 64, TRAIN_CLIP, 512, 128, True),
                   ("analyzer 1024/256", 64, WINDOW, 1024, 256, False))


def adaptive_ms(fn, budget_ms: float = 150.0, most: int = 50) -> float:
    """cuda_ms with as many calls as fit about budget_ms (3 to `most`)."""
    one = cuda_ms(fn, 1, warmup=1)
    return cuda_ms(fn, int(min(most, max(3, budget_ms / max(one, 1e-3)))))


def epilogue_raw(db: torch.Tensor, out: torch.Tensor, top_db, normalize: bool,
                 bounds) -> None:
    """The epilogue kernel of the radix-8 source's library through its C
    entry point alone (which every checkout since the port's first has),
    counted nowhere: how `--parent` reaches an earlier checkout's epilogue."""
    lib = _build.load("log_mel_radix8dif")
    b, t, n_mels = db.shape
    _build.launch(lib, lib.log_mel_epilogue_launch, db.device.index or 0, db.data_ptr(), b, t,
                  n_mels, int(top_db is not None), 0.0 if top_db is None else float(top_db),
                  int(normalize), 1e-8, None if bounds is None else bounds.data_ptr(),
                  out.data_ptr(), torch.cuda.current_stream(db.device).cuda_stream)


def epilogue_yardstick(db: torch.Tensor, top_db, bounds):
    """The library chain timed beside the epilogue (the port never calls
    it): amax, clamp, mask, mean / std and the transpose, on the same
    (B, T, n_mels) scratch; in db's dtype."""
    def library():
        x = db.transpose(1, 2)
        if top_db is not None:
            x = torch.clamp(x, min=x.amax(dim=(1, 2), keepdim=True) - top_db)
        if bounds is not None:
            x = aug.mask_from_bounds(x, bounds)
        mean = x.mean(dim=(1, 2), keepdim=True)
        return ((x - mean) / (x.std(dim=(1, 2), keepdim=True) + 1e-8)).contiguous()

    return library


def epilogue_scratch(rng: np.random.Generator, b: int, length: int, n_fft: int, hop: int,
                     masked: bool):
    """A (B, T, n_mels) dB scratch as the spectrum kernel writes it for
    synthetic clips (the source `cuda_route` picks, counted nowhere), and
    edge bounds where masked."""
    x = torch.from_numpy(synth_clips(rng, b, length)).cuda()
    t = 1 + length // hop
    db = torch.empty((b, t, N_MELS), dtype=torch.float32, device=x.device)
    mel_kernels.spectrum_only(mel_kernels.cuda_route("radix8dif_fused", n_fft), x, SR, n_fft, hop,
                              N_MELS, db)
    bounds = (edge_bounds(b, t, torch.Generator().manual_seed(19)).cuda() if masked else None)
    return db, bounds


def mel_times() -> dict:
    """This PR's two log-mel kernels in whichever checkout's package is
    imported, through what that checkout and this one share (`run_source`,
    `spectrum_only`, the libraries' epilogue entry point): the block path at
    BLOCK_SHAPES (its spectrum kernel alone and the whole call, normalize on,
    by CUDA events; the whole call against the plain version in float64; the
    golden errors over the 5 s parity battery, all cells and active region)
    and the epilogue alone at EPILOGUE_SHAPES (eager and as a CUDA graph;
    against the yardstick in float64; two calls bit-equal)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(11)
    kw = dict(f_min=0.0, f_max=None, top_db=None, mel_scale="htk", norm=None, eps=1e-8,
              spec_mask_bounds=None)
    out = {"block": {}, "epilogue": {}}
    for b, n_fft, hop in BLOCK_SHAPES:
        x = torch.from_numpy(synth_clips(rng, b)).to(dev)
        db = torch.empty((b, 1 + CLIP // hop, N_MELS), dtype=torch.float32, device=dev)

        def spectrum():
            mel_kernels.spectrum_only("log_mel_mixed_radix", x, SR, n_fft, hop, N_MELS, db)

        def call():
            return mel_kernels.run_source("log_mel_mixed_radix", x, SR, n_fft, hop, N_MELS,
                                          normalize=True, **kw)

        want = mel_kernels.log_mel_fused_reference(x.double(), SR, n_fft, hop, N_MELS,
                                                   normalize=True)
        err = (call().double() - want).abs().max().item()
        del want
        golden = golden_errors(lambda w: mel_kernels.run_source(
            "log_mel_mixed_radix", w, SR, n_fft, hop, N_MELS, normalize=False, **kw),
            n_fft, hop, 5.0)
        out["block"][f"{n_fft}/{hop} B={b}"] = {
            "spectrum_ms": adaptive_ms(spectrum), "call_ms": adaptive_ms(call),
            "max_abs_err": err, "golden_all": golden[0], "golden_active": golden[1]}
        del x, db
    for what, b, length, n_fft, hop, masked in EPILOGUE_SHAPES:
        db, bounds = epilogue_scratch(rng, b, length, n_fft, hop, masked)
        y = torch.empty((b, N_MELS, db.shape[1]), dtype=torch.float32, device=dev)

        def epilogue():
            epilogue_raw(db, y, None, True, bounds)

        epilogue()
        first = y.clone()
        epilogue()
        want = epilogue_yardstick(db.double(), None, bounds)()
        out["epilogue"][what] = {
            "ms": cuda_ms(epilogue, 100, warmup=5), "graph_ms": graph_ms(epilogue),
            "max_abs_err": (first.double() - want).abs().max().item(),
            "equal": torch.equal(first, y)}
    return out


def compare_parent(parent: Path) -> int:
    """`python3 chip_smoke.py --parent DIR`, DIR an unpacked earlier
    checkout (`git archive <commit> | tar -x -C DIR`): `mel_times` in that
    checkout's package and in this one, each in its own process, in turns
    (parent, this, this, parent); prints the block path's and the
    epilogue's times, errors and golden errors side by side, the card's
    name and power limit first. Exits non-zero on any failed check."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    runs = {"parent": [], "this": []}
    for which in ("parent", "this", "this", "parent"):
        root = parent.resolve() if which == "parent" else REPO
        proc = subprocess.run([sys.executable, "-c", PARENT_TIMER, str(root),
                               str(Path(__file__).resolve())],
                              cwd=root, capture_output=True, text=True, timeout=900)
        check(proc.returncode == 0, f"{which} ({root}):\n{proc.stdout[-4000:]}\n"
                                    f"{proc.stderr[-4000:]}")
        runs[which].append(json.loads(proc.stdout.strip().splitlines()[-1]))

    def series(kind, shape, key, fmt=".4f"):
        return {w: " / ".join(format(r[kind][shape][key], fmt) for r in rs)
                for w, rs in runs.items()}

    for shape in runs["this"][0]["block"]:
        sp, ca = series("block", shape, "spectrum_ms"), series("block", shape, "call_ms")
        er = series("block", shape, "max_abs_err", ".3e")
        ga, gc = series("block", shape, "golden_all", ".3e"), series("block", shape, "golden_active", ".3e")
        print(f"--parent: [{card}] block path {shape} x 5 s: spectrum kernel alone this "
              f"{sp['this']}, parent {sp['parent']} ms; the whole call this {ca['this']}, parent "
              f"{ca['parent']} ms; max|- plain f64| this {er['this']}, parent {er['parent']}; "
              f"golden 5 s all cells this {ga['this']}, parent {ga['parent']}; active this "
              f"{gc['this']}, parent {gc['parent']}")
    for shape in runs["this"][0]["epilogue"]:
        ms, gm = series("epilogue", shape, "ms"), series("epilogue", shape, "graph_ms")
        er = series("epilogue", shape, "max_abs_err", ".3e")
        eq = {w: [r["epilogue"][shape]["equal"] for r in rs] for w, rs in runs.items()}
        print(f"--parent: [{card}] epilogue alone at {shape}: eager this {ms['this']}, parent "
              f"{ms['parent']} ms; CUDA graph this {gm['this']}, parent {gm['parent']} ms; "
              f"max|- yardstick f64| this {er['this']}, parent {er['parent']}; two calls "
              f"bit-equal this {eq['this']}, parent {eq['parent']}")
        check(all(eq["this"]) and all(eq["parent"]), f"epilogue bit-equal at {shape}")
    return 0


# CUgraphNodeType names (cuda.h)
GRAPH_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph", 5: "empty"}


def graph_nodes(fn) -> tuple[list[tuple[str, str | None]], torch.Tensor]:
    """Capture fn() (warm) into a CUDA graph and list its nodes
    (`list_graph_nodes`); then replay it and return its output."""
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    torch.cuda.synchronize()
    return list_graph_nodes(graph), out


def list_graph_nodes(graph: torch.cuda.CUDAGraph) -> list[tuple[str, str | None]]:
    """The nodes of a CUDA graph captured with keep_graph=True, through
    libcuda's graph calls: (type, the kernel's symbol for a kernel node),
    in the graph's order. Fails where libcuda cannot name a kernel node."""
    cuda = ctypes.CDLL("libcuda.so.1")
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    check(cuda.cuGraphGetNodes(raw, None, ctypes.byref(count)) == 0, "cuGraphGetNodes")
    handles = (ctypes.c_void_p * count.value)()
    check(cuda.cuGraphGetNodes(raw, handles, ctypes.byref(count)) == 0, "cuGraphGetNodes")
    nodes = []
    for handle in handles:
        kind = ctypes.c_int(-1)
        check(cuda.cuGraphNodeGetType(ctypes.c_void_p(handle), ctypes.byref(kind)) == 0,
              "cuGraphNodeGetType")
        name = None
        if kind.value == 0:
            check(hasattr(cuda, "cuFuncGetName"), "libcuda has cuFuncGetName (CUDA 12.3 on)")
            params = (ctypes.c_void_p * 16)()  # CUDA_KERNEL_NODE_PARAMS: first the CUfunction
            text = ctypes.c_char_p()
            check(cuda.cuGraphKernelNodeGetParams(ctypes.c_void_p(handle), params) == 0
                  and bool(params[0])
                  and cuda.cuFuncGetName(ctypes.byref(text), ctypes.c_void_p(params[0])) == 0,
                  "libcuda names the kernel node")
            name = text.value.decode()
        nodes.append((GRAPH_NODE_TYPES.get(kind.value, str(kind.value)), name))
    return nodes


def serving_speed(engine: ClassifierEngine, x: torch.Tensor, host_clip: np.ndarray,
                  card: str) -> None:
    """Phase 17's serving numbers of one engine: wav -> logits clips/s at
    batch 128 (host clock around 10 synchronized batches) with a traced
    split, and classify_wave's latency over 50 calls."""
    fe = engine.frontend
    shape = f"{fe.n_fft}/{fe.hop_length}"
    with torch.inference_mode():
        def wav_to_logits():
            return engine.model(features_from_wavs(fe, x))

        for _ in range(3):
            wav_to_logits()
        torch.cuda.synchronize()
        reps = 10
        t0 = time.perf_counter()
        for _ in range(reps):
            logits = wav_to_logits()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        check(bool(torch.isfinite(logits).all()), "finite logits")
        print(f"phase 17: [{card}] wav->logits at {shape} ({fe.num_frames} frames), batch "
              f"{x.shape[0]}, bf16 CNN: {x.shape[0] * reps / dt:.1f} clips/s "
              f"({dt / reps * 1e3:.3f} ms per batch)")
        steps = 3
        kernels, busy_us, wall_us = trace_device(wav_to_logits, steps)
    print(f"phase 17: [{card}] traced {steps} steps at {shape}: device busy "
          f"{busy_us / steps:.1f} us/step of {wall_us / steps:.1f} us/step wall "
          f"({100 * busy_us / wall_us:.1f}%)")
    for e in kernels[:10]:
        print(f"phase 17:   {e.self_device_time_total / steps:9.1f} us/step "
              f"{e.count // steps:3d}x  {kernel_name(e.key)}")
    engine.warmup_latency()
    lat_ms = []
    for _ in range(50):
        t0 = time.perf_counter()
        engine.classify_wave(host_clip)
        lat_ms.append((time.perf_counter() - t0) * 1e3)
    print(f"phase 17: [{card}] classify_wave at {shape}, batch 1, host clip in: median "
          f"{np.median(lat_ms):.3f} ms, p90 {np.percentile(lat_ms, 90):.3f} ms over 50 calls")


def phase17_entry_points(dev, rng, card: str, tmp: Path, corpus: Path,
                         recording: Path) -> dict[str, int]:
    """The entry points at n_fft 512 / hop 128, 768/256 and 1536/384, each
    run with the launch counts zeroed before and read after: the serving
    engine on seeded checkpoints (predict_probs on 128 clips of 5 s,
    classify_wave, classify_files) at all three, held against the same
    engine on the CPU (16 clips); one training epoch of `train.main` on
    phase 9's corpus at 512/128, and the train step at that front end timed;
    then `analyze.main` (parallel) with that epoch's checkpoint at 1 s
    windows (512/128, 126 -> 125 frames) and 0.064 s windows (512/128, 9 ->
    32 frames), the card's window probabilities against the CPU's; then wav
    -> logits clips/s and classify_wave latency at 512/128 and 768/256.
    Returns the launches of row 3 (each form apart, and at 1536/384 apart)
    and row 5 over these runs."""
    wrappers = mel_kernels.WRAPPERS
    k3, k5 = wrappers["radix4dif_fused"], wrappers["radix2_fused"]

    def others_idle(alg):
        return all(fn.launches + fn.launches_masked == 0
                   for a, fn in wrappers.items() if a != alg)

    launches = {"radix4dif_fused": 0, "radix2_fused": 0, "radix4dif_fused_1536": 0,
                "radix16dif_fused_16384": 0}
    clips = synth_clips(rng, BATCH)
    paths = []
    for i in range(3):
        paths.append(tmp / f"clip512_{i}.wav")
        write_wav(paths[-1], clips[i, ::2], SR // 2)
    engines = {}
    for alg, n_fft, hop in (("radix4dif_fused", 512, 128), ("radix2_fused", 768, 256),
                            ("radix4dif_fused", 1536, 384), ("radix16dif_fused", 16384, 1024)):
        shape = dict(n_fft=n_fft, hop_length=hop)
        ckpt = seeded_checkpoint(tmp / f"serve_{n_fft}.ckpt", mixed_precision=True,
                                 head_scale=15.0, **shape)
        zero_counts()
        engine = ClassifierEngine(ckpt, batch_size=BATCH, device="cuda")
        probs = engine.predict_probs(clips)
        one = engine.classify_wave(clips[0])
        files = engine.classify_files(paths)
        torch.cuda.synchronize()
        read_epilogue(f"phase 17 serving at {n_fft}/{hop}")
        n = wrappers[alg].launches
        print(f"phase 17: serving at {n_fft}/{hop} ({engine.frontend._pallas_algorithm()}, "
              f"{engine.frontend.num_frames} frames): launches {alg} {n}")
        check(engine.frontend._pallas_algorithm() == alg and n > 0 and others_idle(alg),
              f"the {n_fft}/{hop} serving path ran {alg} and no other log-mel kernel")
        launches[alg if n_fft in (512, 768) else f"{alg}_{n_fft}"] += n
        check(probs.shape == (BATCH, 4) and bool(np.isfinite(probs).all()), "probs shape/finite")
        p1 = np.array(list(one["probabilities"].values()))
        err_one = float(np.abs(p1 - probs[0]).max())
        cpu = ClassifierEngine(ckpt, batch_size=16, device="cpu").predict_probs(clips[:16])
        err = float(np.abs(probs[:16] - cpu).max())
        # f32 with the head x30, so that the probabilities follow the CNN
        # (spread >= 2e-2, 200x the tolerance) and bf16 rounding cannot hide
        ckpt32 = seeded_checkpoint(tmp / f"f32_{n_fft}.ckpt", mixed_precision=False,
                                   head_scale=30.0, **shape)
        p32 = ClassifierEngine(ckpt32, batch_size=16, device="cuda").predict_probs(clips[:16])
        c32 = ClassifierEngine(ckpt32, batch_size=16, device="cpu").predict_probs(clips[:16])
        err32 = float(np.abs(p32 - c32).max())
        spread = float(np.abs(c32 - c32.mean(axis=0)).max())
        print(f"phase 17: {n_fft}/{hop} predict_probs, bf16 CNN, head x15: max|cuda - cpu| "
              f"(16 clips) {err:.3e} (tol 5e-3); classify_wave vs batch row {err_one:.3e}; f32 "
              f"CNN, head x30: {err32:.3e} (tol 1e-4), spread {spread:.3e} (>= 2e-2), classes "
              f"{np.bincount(c32.argmax(-1), minlength=4).tolist()}; classify_files "
              f"{[(r['predicted_class'], round(r['confidence'], 4)) for r in files]}")
        check(err <= 5e-3 and err_one <= 5e-3, f"{n_fft}/{hop} serving, bf16")
        check(err32 <= 1e-4 and spread >= 2e-2, f"{n_fft}/{hop} serving, f32")
        check(len(files) == 3, "classify_files")
        engines[n_fft] = engine

    # one training epoch at 512/128 on phase 9's corpus (JSON is YAML)
    cfg = load_config(str(REPO / "config.yaml"))
    cfg["data"].update(n_fft=512, hop_length=128)
    cfg["training"].update(checkpoint_dir=str(tmp / "r4" / "ckpt"), log_dir=str(tmp / "r4" / "runs"))
    cfg_path = tmp / "config_n_fft_512.yaml"
    cfg_path.write_text(json.dumps(cfg))
    zero_counts()
    t0 = time.perf_counter()
    history = quiet(train_entry.main, ["--config", str(cfg_path), "--data-path", str(corpus),
                                       "--epochs", "1", "--no-plots"])
    torch.cuda.synchronize()
    read_epilogue("phase 17 training")
    wall = time.perf_counter() - t0
    print(f"phase 17: [{card}] train.main, 1 epoch at n_fft 512 / hop 128 (8 s clips, 1001 "
          f"frames, batch 32 x 2, bf16): {wall:.1f} s with start-up; history "
          f"{json.dumps(history)}; launches radix4dif masked {k3.launches_masked}, "
          f"inference {k3.launches}")
    check(k3.launches_masked > 0 and others_idle("radix4dif_fused"),
          "the 512/128 training path ran row 3's masked form and no other log-mel kernel")
    check(all(math.isfinite(v) for vals in history.values() for v in vals), "finite history")
    launches["radix4dif_fused"] += k3.launches
    launches["radix4dif_fused_masked"] = k3.launches_masked
    trained = tmp / "r4" / "ckpt" / "best_model.ckpt"
    check(trained.exists(), "the 512/128 epoch wrote best_model.ckpt")

    # the train step at this front end: config.yaml's 32 x 2 x 8 s, bf16,
    # Adam, augmentation on
    fe = MelFrontend.from_config(cfg)
    wavs = torch.from_numpy(synth_clips(rng, 64, TRAIN_CLIP).reshape(2, 32, TRAIN_CLIP)).to(dev)
    labels = torch.from_numpy(rng.integers(0, 4, (2, 32))).long().to(dev)
    model = build_model(cfg, generator=torch.Generator().manual_seed(0)).to(dev)
    fns = make_step_fns(model, fe, build_optimizer("adam", model.parameters(), 1e-4),
                        accum_steps=2, augment=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    cw = torch.ones(4, device=dev)

    def one_step():
        return fns.train_step(wavs, labels, cw, 3e-3, generator=gen)

    step_ms = cuda_ms(one_step, iters=10, warmup=3)
    steps = 2
    kernels, busy_us, wall_us = trace_device(one_step, steps)
    print(f"phase 17: [{card}] train step at 512/128 (32 x 2 x 8 s, bf16, adam, augmentation "
          f"on): {step_ms:.3f} ms ({64 / step_ms * 1e3:.1f} clips/s); traced {steps} steps: "
          f"device busy {busy_us / steps:.1f} us/step of {wall_us / steps:.1f} us/step wall "
          f"({100 * busy_us / wall_us:.1f}%)")
    for e in kernels[:8]:
        print(f"phase 17:   {e.self_device_time_total / steps:9.1f} us/step "
              f"{e.count // steps:3d}x  {kernel_name(e.key)}")

    frames = {1.0: (126, 125), 0.064: (9, 32)}
    for duration, (t_in, t_out) in frames.items():
        zero_counts()
        eng, results, csv_path = quiet(analyze.main, [
            "parallel", "--audio", str(recording), "--model", str(trained),
            "--segment-duration", str(duration), "--output-dir", str(tmp / "analysis512"),
            "--no-plots"])
        torch.cuda.synchronize()
        read_epilogue(f"phase 17 analyze at {duration:g} s")
        fe = eng.frontend
        n = k3.launches
        rows = csv_path.read_text().strip().splitlines()
        print(f"phase 17: [{card}] analyze parallel at {duration:g} s windows, 512/128 "
              f"checkpoint: {len(results)} windows -> {csv_path.name} ({len(rows) - 1} rows); "
              f"front end {fe.n_fft}/{fe.hop_length}, {fe._inner.num_frames} -> "
              f"{fe.target_time_steps} frames; launches radix4dif {n}")
        check((fe.n_fft, fe.hop_length, fe._inner.num_frames, fe.target_time_steps)
              == (512, 128, t_in, t_out), "the analyzer's front end at 512/128")
        check(n > 0 and others_idle("radix4dif_fused") and len(rows) - 1 == len(results) > 0,
              f"the analyzer at {duration} s ran row 3")
        launches["radix4dif_fused"] += n
        pair = [quiet(AnalyzerEngine, str(trained), segment_duration=duration, sample_rate=SR,
                      device=d) for d in ("cuda", "cpu")]
        windows = quiet(lambda: pair[0].segment_audio(pair[0].load_audio(recording)))[0]
        gpu, cpu = (e.predict_window_probs(windows) for e in pair)
        err = float(np.abs(gpu - cpu).max())
        print(f"phase 17: analyzer {duration:g} s windows ({len(windows)}), trained 512/128 "
              f"checkpoint, bf16 CNN: max|cuda - cpu| probability = {err:.3e} (tol 5e-3)")
        check(bool(np.isfinite(gpu).all()) and err <= 5e-3, f"analyzer at {duration} s, cuda vs cpu")

    # speed at 512/128 and 768/256: wav -> logits at batch 128, and batch-1 latency
    x = torch.from_numpy(synth_clips(rng, BATCH)).to(dev)
    for n_fft in (512, 768):
        serving_speed(engines[n_fft], x, clips[0], card)
    print(f"phase 17: entry-point launches {launches}")
    return launches


# phase 18: TPU-kernel row 7 on the DFT GEMM log-mel kernel
# (`csrc/log_mel_dft_gemm.cu`). Its shapes are the n_fft % 4 != 0 ones, where
# the JAX policy picks bf16x3 (1001 = 7 * 11 * 13, 505 = 5 * 101, 1022 =
# 2 * 511, 2050 = 2 * 1025); the main one, where both names are timed and
# the full-width path runs, is 1001/250 (321 frames at 5 s).
B7_SHAPES = ((1001, 250), (505, 126), (1022, 511), (2050, 512))
B7_MAIN = (1001, 250)
B7_ALGORITHMS = ("bf16x3", "f32")
TF32_FLOPS = 495e12  # H100 SXM dense TF32 tensor-core peak (NVIDIA data sheet)


def sass_counts(library: Path, opcodes=("HGMMA", "UTMALDG")) -> dict[str, int]:
    """How many of each opcode the built library's SASS holds, by the
    toolkit's `cuobjdump -sass` (beside nvcc); raises if it is missing."""
    cuobjdump = Path(_build.nvcc()).with_name("cuobjdump")
    check(cuobjdump.exists(), f"cuobjdump beside nvcc ({cuobjdump})")
    sass = subprocess.run([str(cuobjdump), "-sass", str(library)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    return {op: len(re.findall(rf"\b{op}\b", sass)) for op in opcodes}


def dft_fold_tflop(batch: int, length: int, n_fft: int, hop: int) -> tuple[float, float]:
    """TF32 MMA work of one `log_mel_dft_gemm` call in TFLOP, (as run on the
    padded tiles, as the fold needs): cos and sin products, three each, of
    frames x bins x K, 2 operations a multiply-add."""
    k_half, k_pad, bins_pad = mel_kernels.dft_fold_geometry(n_fft)
    rows, tile = batch * (1 + length // hop), mel_kernels.DFT_TILE_ROWS
    run = 12 * (-(-rows // tile) * tile) * bins_pad * k_pad
    need = 12 * rows * (n_fft // 2 + 1) * k_half
    return run / 1e12, need / 1e12


def print_tf32_rate(card: str, alg: str, n_fft: int, hop: int, kernel_ms: float) -> None:
    """The DFT kernel's achieved TF32 rate at 128 x 5 s: its MMA work over its
    time, and that as a share of the dense TF32 peak."""
    run, need = dft_fold_tflop(BATCH, CLIP, n_fft, hop)
    rate = run / kernel_ms * 1e3
    print(f"phase 18: [{card}] log_mel_{alg} {n_fft}/{hop}: TF32 MMA work {run:.4f} TFLOP as "
          f"run on the tiles ({need:.4f} as the fold needs): {rate:.1f} TFLOP/s, "
          f"{100 * rate * 1e12 / TF32_FLOPS:.1f}% of {TF32_FLOPS / 1e12:g}; folded floor "
          f"{run * 1e15 / TF32_FLOPS:.4f} ms")


def phase18_dft_gemm(dev, card: str, tmp: Path) -> dict[str, dict]:
    """Row 7 through its two wrappers, after a look at the DFT kernel's SASS
    (HGMMA and UTMALDG both present, or the phase fails): against the plain
    version in float64 on seeded noise (B 3, one example 26 dB louder) at 5
    and 1 s, dB only
    (tol 1e-3) and with top_db 80 + normalize (2e-3); against the float64
    golden over the parity battery at 5 and 1 s through `parity.parity`,
    unrestricted at n_fft >= 1536 and in the 25 dB active region below. Then
    the main path with the counts zeroed before and read after: wav ->
    logits at 1001/250 through `features_from_wavs(MelFrontend(backend=
    "pallas"), ...)` and a seeded bf16 LightweightCNN (128 clips of 5 s; the
    first 16 held against the same pipeline on the CPU), `MelFrontend(
    backend="pallas")` at 1022/511 and `pallas_algorithm="f32"` at 1001/250
    and 2048/512 (8 clips, against the CPU in float64). Then the framing
    repair on the card (`ClassifierEngine` under "auto" at 1001/250: 321
    frames, no kernel), the timings with the achieved TF32 rate, the new
    source beside the radix-8 one at 2048/512, and the parity entry point at
    2048/512. Returns each name's kernel-line numbers."""
    rng = np.random.default_rng(18)  # its own stream: the inputs do not depend on earlier phases
    wrappers = mel_kernels.WRAPPERS
    sass = sass_counts(_build.build_all()["log_mel_dft_gemm"][0])
    print(f"phase 18: SASS of log_mel_dft_gemm: {sass} (wgmma, TMA tensor loads)")
    check(all(n > 0 for n in sass.values()), "the DFT kernel's SASS holds HGMMA and UTMALDG")
    errs = {alg: [] for alg in B7_ALGORITHMS}
    epilogue = dict(top_db=80.0, normalize=True)
    for n_fft, hop in B7_SHAPES:
        check(mel_kernels.cuda_route("bf16x3", n_fft) == "log_mel_dft_gemm",
              f"n_fft {n_fft} routes to the DFT GEMM kernel")
        for duration in (5.0, 1.0):
            length = int(SR * duration)
            x = (0.1 * rng.standard_normal((3, length))).astype(np.float32)
            x[1] *= 20.0
            xt = torch.from_numpy(x).to(dev)
            for kw, tol in (({}, 1e-3), (epilogue, 2e-3)):
                want = mel_kernels.log_mel_fused_reference(xt.double(), SR, n_fft, hop, N_MELS,
                                                           **kw)
                for alg in B7_ALGORITHMS:
                    got = wrappers[alg](xt, SR, n_fft, hop, N_MELS, **kw)
                    torch.cuda.synchronize()
                    check(got.shape == (3, N_MELS, 1 + length // hop), f"{alg} shape")
                    check(bool(torch.isfinite(got).all()), f"finite {alg} output")
                    err = (got.double() - want).abs().max().item()
                    errs[alg].append(err)
                    print(f"phase 18: log_mel_{alg} {n_fft}/{hop} B=3 x {duration:g} s "
                          f"{'top_db 80 + normalize' if kw else 'dB'}: max|kernel - plain f64| = "
                          f"{err:.3e} (tol {tol:g})")
                    check(err <= tol, f"{alg} vs plain at {n_fft}/{hop}, {duration} s, {kw}")
    for n_fft, hop in B7_SHAPES:
        unrestricted = n_fft >= 1536
        for r in parity.parity(dev, n_fft, hop, (5.0, 1.0), B7_ALGORITHMS):
            print(f"phase 18: golden {n_fft}/{hop} {r['duration_s']:g} s {r['algorithm']}: "
                  f"max|- f64 golden| = {r['max_abs_db_err']:.3e} dB all cells, "
                  f"{r['max_abs_db_err_25db']:.3e} active (tol 1e-3 "
                  f"{'unrestricted' if unrestricted else 'active'})")
            check(r["within_budget_unrestricted" if unrestricted else "within_budget"],
                  f"{r['algorithm']} vs golden at {n_fft}/{hop}, {r['duration_s']} s")

    # the main path: wav -> logits at 1001/250 as bench.py:build_pipeline(
    # backend="pallas") builds it, and the other front ends that reach row 7
    n_fft, hop = B7_MAIN
    ckpt = seeded_checkpoint(tmp / "serve_1001.ckpt", mixed_precision=True, head_scale=15.0,
                             n_fft=n_fft, hop_length=hop)
    engine = ClassifierEngine(ckpt, batch_size=BATCH, device="cuda")
    fe = MelFrontend.from_config(engine.config, backend="pallas")
    check(fe._pallas_algorithm() == "bf16x3" and fe.num_frames == 321,
          "backend 'pallas' picks bf16x3 at 1001/250, 321 frames")
    clips = synth_clips(rng, BATCH)
    x = torch.from_numpy(clips).to(dev)

    def wav_to_logits():
        return engine.model(features_from_wavs(fe, x))

    others = ((1022, 511, None), (1001, 250, "f32"), (2048, 512, "f32"))
    zero_counts()
    with torch.inference_mode():
        logits = wav_to_logits()
        outs = [MelFrontend(n_fft=nf, hop_length=hp, duration=5.0, backend="pallas",
                            pallas_algorithm=alg)(x[:8]) for nf, hp, alg in others]
    torch.cuda.synchronize()
    read_epilogue("phase 18 wav -> logits at 1001/250")
    launches = {alg: wrappers[alg].launches for alg in B7_ALGORITHMS}
    print(f"phase 18: main path launches {launches}")
    check(all(n > 0 for n in launches.values()) and all(
        fn.launches + fn.launches_masked == 0 for a, fn in wrappers.items()
        if a not in B7_ALGORITHMS) and all(wrappers[a].launches_masked == 0
                                           for a in B7_ALGORITHMS),
          "the row-7 paths launched both row-7 wrappers and no other log-mel kernel")
    check(logits.shape == (BATCH, 4) and bool(torch.isfinite(logits).all()), "finite logits")
    cpu_engine = ClassifierEngine(ckpt, batch_size=16, device="cpu")
    with torch.inference_mode():
        cpu_logits = cpu_engine.model(features_from_wavs(fe, torch.from_numpy(clips[:16])))
    probs = torch.softmax(logits[:16].float().cpu(), -1)
    cpu_probs = torch.softmax(cpu_logits.float(), -1)
    err = (probs - cpu_probs).abs().max().item()
    spread = (cpu_probs - cpu_probs.mean(0)).abs().max().item()
    print(f"phase 18: wav->logits at {n_fft}/{hop}, backend 'pallas', bf16 CNN, head x15: "
          f"max|cuda - cpu| probability (16 clips) {err:.3e} (tol 5e-3), spread {spread:.3e} "
          f"(>= 2e-2)")
    check(err <= 5e-3 and spread >= 2e-2, "the 1001/250 pallas path, cuda vs cpu")
    x64 = torch.from_numpy(clips[:8]).double()
    for (nf, hp, alg), got in zip(others, outs):
        want = MelFrontend(n_fft=nf, hop_length=hp, duration=5.0, backend="pallas",
                           pallas_algorithm=alg)(x64)
        err = (got.double().cpu() - want).abs().max().item()
        print(f"phase 18: MelFrontend(backend='pallas', pallas_algorithm={alg!r}) {nf}/{hp}, "
              f"8 x 5 s: max|cuda - cpu f64| = {err:.3e} (tol 2e-3)")
        check(err <= 2e-3, f"MelFrontend {nf}/{hp} {alg}, cuda vs cpu")

    # the framing repair on the card: under "auto" bf16x3 runs the plain chain
    # on CUDA (as the JAX package runs XLA), with 1 + L // hop frames
    before = {a: (fn.launches, fn.launches_masked) for a, fn in wrappers.items()}
    auto = ClassifierEngine(ckpt, batch_size=16, device="cuda")
    with torch.inference_mode():
        feats = features_from_wavs(auto.frontend, x[:16])
    got = auto.predict_probs(clips[:16])
    want = cpu_engine.predict_probs(clips[:16])
    torch.cuda.synchronize()
    err = float(np.abs(got - want).max())
    print(f"phase 18: ClassifierEngine at {n_fft}/{hop}, backend 'auto' (plain chain on the "
          f"card): features {tuple(feats.shape)}, max|cuda - cpu| probability {err:.3e} "
          f"(tol 5e-3)")
    check(auto.frontend.num_frames == 321 and tuple(feats.shape) == (16, N_MELS, 321, 1),
          "321 frames at 1001/250 on the card")
    check(err <= 5e-3 and before == {a: (fn.launches, fn.launches_masked)
                                     for a, fn in wrappers.items()},
          "the auto engine at 1001/250 ran the plain chain and matches the cpu")

    # speed: the full-width path, then each name beside its bound, plain
    # version and yardstick at 128 x 5 s, and the kernel alone at the other
    # shapes
    with torch.inference_mode():
        for _ in range(2):
            wav_to_logits()
        torch.cuda.synchronize()
        reps = 5
        t0 = time.perf_counter()
        for _ in range(reps):
            wav_to_logits()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        print(f"phase 18: [{card}] wav->logits at {n_fft}/{hop} (321 frames), backend "
              f"'pallas', batch {BATCH}, bf16 CNN: {BATCH * reps / dt:.1f} clips/s "
              f"({dt / reps * 1e3:.3f} ms per batch)")
        steps = 2
        kernels, busy_us, wall_us = trace_device(wav_to_logits, steps)
    print(f"phase 18: [{card}] traced {steps} steps: device busy {busy_us / steps:.1f} us/step "
          f"of {wall_us / steps:.1f} us/step wall ({100 * busy_us / wall_us:.1f}%)")
    for e in kernels[:8]:
        print(f"phase 18:   {e.self_device_time_total / steps:9.1f} us/step "
              f"{e.count // steps:3d}x  {kernel_name(e.key)}")
    rows = {}
    kw = dict(normalize=True)
    bound_ms, bound_by, floors = bound(BATCH, CLIP, dev, n_fft, hop)
    plain_ms = cuda_ms(lambda: mel_kernels.log_mel_fused_reference(
        x, SR, n_fft, hop, N_MELS, **kw), iters=5)
    library_ms = cuda_ms(yardstick(x, n_fft, hop), iters=10)
    for alg in B7_ALGORITHMS:
        kernel_ms = cuda_ms(lambda: wrappers[alg](x, SR, n_fft, hop, N_MELS, **kw), iters=10)
        print(f"phase 18: [{card}] log_mel_{alg} {n_fft}/{hop} B={BATCH} x 5 s: kernel "
              f"{kernel_ms:.4f} ms, plain f32 {plain_ms:.4f} ms, torch.stft yardstick "
              f"{library_ms:.4f} ms (one frame fewer: torch.stft pads an odd n_fft by "
              f"(n_fft - 1) / 2), bound {bound_ms:.4f} ms ({bound_by}; bytes "
              f"{floors['bytes']:.4f}, operations {floors['operations']:.4f}, bytes with the "
              f"dB scratch {floors['bytes_with_scratch']:.4f})")
        print_tf32_rate(card, alg, n_fft, hop, kernel_ms)
        rows[alg] = {"launches": launches[alg], "max_abs_err": max(errs[alg]), "ms": kernel_ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": library_ms}
    for nf, hp in B7_SHAPES[1:]:
        kernel_ms = cuda_ms(lambda: wrappers["bf16x3"](x, SR, nf, hp, N_MELS, **kw), iters=5)
        print(f"phase 18: [{card}] log_mel_bf16x3 {nf}/{hp} B={BATCH} x 5 s: kernel "
              f"{kernel_ms:.4f} ms, bound {bound(BATCH, CLIP, dev, nf, hp)[0]:.4f} ms")
        print_tf32_rate(card, "bf16x3", nf, hp, kernel_ms)
    compare_sources(dev, card, rng, shapes=(("bf16x3", BATCH, CLIP, 2048, 512, False),),
                    sources=("log_mel_radix8dif", "log_mel_dft_gemm"), phase=18)

    # the parity entry point at the JAX package's shape: every row within
    # its gate (unrestricted: n_fft 2048 >= 1536)
    out = tmp / "parity_2048.jsonl"
    check(parity.main(["--out", str(out)]) == 0, "parity entry point")
    results = [json.loads(line) for line in out.read_text().splitlines()]
    check(len(results) == 30 and all(r["platform"] == "gpu" and r["within_budget_unrestricted"]
                                     for r in results),
          "every parity row at 2048/512 within 1e-3 dB unrestricted")
    return rows


# phase 19: the epilogue alone (`csrc/log_mel_epilogue.cuh`)
def phase19_epilogue(dev, card: str) -> dict:
    """The epilogue kernel alone at EPILOGUE_SHAPES, on the dB scratch the
    spectrum kernel writes for synthetic clips, through
    `mel_kernels.epilogue_only` (counted nowhere): its plan as the card's
    library computes it (CTAs an example, mels a CTA, resident or re-read)
    against `mel_kernels.epilogue_plan`; against `epilogue_reference` in
    float64 in the main path's form (normalize, the shape's bounds) and with
    top_db 80 beside it (tol 1e-4: the kernel's one f32 rounding of each
    normalized cell, |cell| < 20, against statistics summed in f64); two
    calls bit-equal; then timed eager (CUDA events, back to back) and as a
    CUDA graph of 20 calls (the device's time, the host out of the way)
    beside its bytes bound (the scratch read once, the output written once,
    the bounds), the plain version and the yardstick. Returns the kernel-line
    numbers at the serving shape, the error over all shapes."""
    rng = np.random.default_rng(19)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    row, errs = {}, []
    for what, b, length, n_fft, hop, masked in EPILOGUE_SHAPES:
        db, bounds = epilogue_scratch(rng, b, length, n_fft, hop, masked)
        t = db.shape[1]
        plan = mel_kernels.epilogue_device_plan(b, t, N_MELS, dev.index or 0)
        mirror = mel_kernels.epilogue_plan(b, t, N_MELS, sms)
        check(plan == {k: mirror[k] for k in plan}, f"the epilogue's plan at {what} is "
                                                     f"`epilogue_plan`'s ({plan}, {mirror})")
        source = mel_kernels.cuda_route("radix8dif_fused", n_fft)
        out = torch.empty((b, N_MELS, t), dtype=torch.float32, device=dev)
        line = []
        for top_db in (None, 80.0):
            def call(top_db=top_db):
                mel_kernels.epilogue_only(source, db, out, top_db=top_db, normalize=True,
                                          eps=1e-8, spec_mask_bounds=bounds)

            call()
            first = out.clone()
            call()
            equal = torch.equal(first, out)
            want = mel_kernels.epilogue_reference(db.double(), top_db, True, 1e-8, bounds)
            err = (first.double() - want).abs().max().item()
            errs.append(err)
            line.append(f"{'top_db 80 + ' if top_db else ''}normalize: max|- plain f64| "
                        f"{err:.3e}, two calls bit-equal {equal}")
            check(err <= 1e-4 and equal, f"the epilogue at {what}, top_db {top_db}")

        def epilogue():
            mel_kernels.epilogue_only(source, db, out, top_db=None, normalize=True, eps=1e-8,
                                      spec_mask_bounds=bounds)

        eager_ms = cuda_ms(epilogue, 200, warmup=5)
        device_ms = graph_ms(epilogue)
        plain_ms = cuda_ms(lambda: mel_kernels.epilogue_reference(db, None, True, 1e-8, bounds),
                           50)
        library_ms = cuda_ms(epilogue_yardstick(db, None, bounds), 50)
        bound_ms = (8 * db.numel() + (16 * b if masked else 0)) / HBM_BYTES_PER_S * 1e3
        print(f"phase 19: [{card}] epilogue alone at {what}, B={b} x {length / SR:g} s ({t} "
              f"frames{', masked' if masked else ''}): {plan['cluster']} CTAs an example, "
              f"{plan['band']} mels a CTA, {'resident' if plan['resident'] else 're-read'} "
              f"({plan['smem_bytes']} shared bytes); " + "; ".join(line)
              + f"; eager {eager_ms:.4f} ms, CUDA graph {device_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms (bytes), plain f32 {plain_ms:.4f} ms, yardstick "
              f"{library_ms:.4f} ms")
        if what.startswith("serving"):
            row = {"ms": eager_ms, "graph_ms": device_ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": library_ms}
        del db, out
    row["max_abs_err"] = max(errs)
    return row


# phase 20: CompactResNet18, the second classifier. It has no kernel of its
# own (the JAX package leaves its convs, BN, pooling and head to XLA, the port
# to cuDNN/ATen); its paths run rows 1 and 2 and the epilogue.

def conv_out(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


def resnet_gflop(h: int, w: int, stage_sizes=(2, 2, 2, 2), classes: int = 4) -> float:
    """Forward GFLOP of one (h, w) CompactResNet input: 2 per multiply-add
    of every conv and dense layer, by the layer shapes."""
    h, w = conv_out(h, 7, 2, 3), conv_out(w, 7, 2, 3)
    flops = 2 * h * w * 64 * 49
    h, w, cin = conv_out(h, 3, 2, 1), conv_out(w, 3, 2, 1), 64
    for stage, blocks in enumerate(stage_sizes):
        c = 64 * 2 ** stage
        for block in range(blocks):
            s = 2 if stage > 0 and block == 0 else 1
            h, w = conv_out(h, 3, s, 1), conv_out(w, 3, s, 1)
            flops += 2 * h * w * c * 9 * (cin + c)
            if s != 1 or cin != c:  # the 1x1 projection
                flops += 2 * h * w * c * cin
            cin = c
    return (flops + 2 * cin * 256 + 2 * 256 * classes) / 1e9


def cnn_conv_gflop(h: int, w: int) -> float:
    """Forward GFLOP of LightweightCNN's five 3x3 convs on one (h, w) input."""
    chans, flops = (1, 32, 64, 128, 256, 256), 0
    for i in range(5):
        flops += 2 * h * w * chans[i] * chans[i + 1] * 9
        h, w = h // 2, w // 2
    return flops / 1e9


def launch_calls(fn, steps: int) -> float:
    """Kernel launches a call, counted on the host: the launch calls
    (cudaLaunchKernel, cuLaunchKernel, their Ex forms and
    cudaLaunchCooperativeKernel) the profiler records around `steps` calls
    (host records, which the device-record losses of PERF.md §7 do not
    touch)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if "Launch" in e.key and "Kernel" in e.key) / steps


def train_step_times(cfg: dict, dev, rng, a: int, b: int, clip: int) -> tuple[float, float, float]:
    """The train step at `cfg`'s model, precision and front end on a x b
    clips of `clip` samples (Adam, augmentation on, the draws and dropout
    from a generator on the card). Returns its ms by CUDA events back to
    back, its kernel launches (host launch calls), and its device ms as a
    replayed CUDA graph: the same step with its draws injected, the dropout
    from the default generator and Adam's capturable form (graph capture
    refuses the host-side step count of the eager one)."""
    fe = MelFrontend.from_config(cfg)
    wavs = torch.from_numpy(synth_clips(rng, a * b, clip).reshape(a, b, clip)).to(dev)
    labels = torch.from_numpy(rng.integers(0, 4, (a, b))).long().to(dev)
    cw = torch.ones(4, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    model = build_model(cfg, generator=torch.Generator().manual_seed(0)).to(dev)
    fns = make_step_fns(model, fe, build_optimizer("adam", model.named_parameters(), 1e-4),
                        accum_steps=a, augment=True)

    def one_step():
        return fns.train_step(wavs, labels, cw, 3e-3, generator=gen)

    step_ms = cuda_ms(one_step, iters=10, warmup=3)
    per_step = launch_calls(one_step, 2)
    g_model = build_model(cfg, generator=torch.Generator().manual_seed(0)).to(dev)
    g_opt = torch.optim.Adam(g_model.parameters(), lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4, capturable=True)
    g_fns = make_step_fns(g_model, fe, g_opt, accum_steps=a, augment=True)
    draws = [aug.draw_augment(gen, b, clip, N_MELS, fe.num_frames, dev) for _ in range(a)]
    device_ms = graph_ms(lambda: g_fns.train_step(wavs, labels, cw, 3e-3, draws=draws),
                         calls=1, iters=10)
    return step_ms, per_step, device_ms


def torchvision_shaped_resnet18(seed: int) -> dict:
    """A plain torchvision resnet18 state_dict from a seed: a 3-channel stem
    and a 1000-class fc (an ImageNet checkpoint's shapes)."""
    g = torch.Generator().manual_seed(seed)
    sd = {k.removeprefix("resnet."): v for k, v in CompactResNet(generator=g).state_dict().items()
          if not k.startswith("resnet.fc.")}
    sd["conv1.weight"] = torch.randn((64, 3, 7, 7), generator=g) * 0.05
    sd["fc.weight"] = torch.randn((1000, 512), generator=g) * 0.01
    sd["fc.bias"] = torch.zeros(1000)
    return sd


def resnet_sgd_step(dev, rng, fe: MelFrontend) -> dict:
    """One fp32 ResNet step without augmentation, SGD at lr 1, on the card and
    the CPU from the same weights (head x15), held by phase 8's loss and
    param bounds (a front end 1e-5 dB off sets the CPU's own floor). Returns
    its inputs, the card's and the CPU's results and the floor, as
    `phase8_train_step` returns LightweightCNN's."""
    a, b = 2, 8
    wavs = torch.from_numpy(synth_clips(rng, a * b, TRAIN_CLIP).reshape(a, b, TRAIN_CLIP))
    labels = torch.from_numpy(rng.integers(0, 4, (a, b))).long()
    cw = torch.tensor([1.0, 2.0, 0.5, 1.5])
    init = scaled_head(CompactResNet(generator=torch.Generator().manual_seed(0)).state_dict(), 15.0)
    (m_gpu, model_gpu, _), (m_cpu, model_cpu, _) = (
        one_train_step(CompactResNet(), init, device, fe, "sgd", 1.0, wavs, labels, cw)
        for device in (dev, "cpu"))
    margins, floor = sgd_step_margins(
        (m_gpu, model_gpu), (m_cpu, model_cpu),
        lambda frontend: one_train_step(CompactResNet(), init, "cpu", frontend, "sgd", 1.0, wavs,
                                        labels, cw)[:2], fe)
    sd_g, sd_c = model_gpu.state_dict(), model_cpu.state_dict()
    err_loss = abs(m_gpu["loss"] - m_cpu["loss"]) / abs(m_cpu["loss"])
    print(f"phase 20: ResNet fp32 sgd step, lr 1, no augmentation, x15 head: loss cuda "
          f"{m_gpu['loss']:.6f} cpu {m_cpu['loss']:.6f} (rel {err_loss:.2e}, tol 1e-4); params "
          f"worst |d| over its bound {margins.params:.3f}, grad norm {margins.grad_norm:.3f} "
          f"(phase 8's bound; the CPU step with its log-mel 1e-5 dB off, seeds 0-7, moves "
          f"params by up to {max(f.max() for f in floor.params):.2e}, the norm by {floor.grad_norm:.2e})")
    check(err_loss <= 1e-4, "ResNet step loss, cuda vs cpu")
    check(m_gpu["correct"] == m_cpu["correct"], "ResNet step correct count, cuda vs cpu")
    check(margins.ok, f"ResNet step params and grad norm, cuda vs cpu ({margins})")
    for k in sd_c:
        if "running" in k:
            check(torch.allclose(sd_g[k].cpu(), sd_c[k], rtol=1e-4, atol=1e-6), f"BN buffer {k}")
    return dict(fe=fe, wavs=wavs, labels=labels, cw=cw, init=init, floor=floor,
                card=(param_arrays(model_gpu), m_gpu["grad_norm"]), card_loss=m_gpu["loss"],
                cpu=(param_arrays(model_cpu), m_cpu["grad_norm"]))


def phase20_resnet(dev, rng, card: str, tmp: Path, corpus: Path, recording: Path) -> dict:
    """CompactResNet18 through the entry points, with the launch counts
    zeroed before and read after each main-path run: the serving engine on a
    seeded bf16 checkpoint (x15 head) against the CPU, and an fp32 one; wav
    -> logits at 128 x 5 s and classify_wave beside LightweightCNN's; one
    epoch of `train.main --model resnet` at config.yaml on phase 9's corpus,
    a resumed epoch in a subprocess and the best checkpoint served; the
    train step's time, launches and device time, and an epoch's wall time;
    an fp32 lr-1 SGD step on the card against the CPU; `analyze.main` at
    0.5 s windows; `model.pretrained` from a torchvision-shaped .pt; and
    `ICBHI_FUSED_CNN=1` on a ResNet (rows 8-10 launch 0 times). Returns rows
    1 and 2's launches over these runs: row 1's inference form
    ("inference"), its training form ("masked"), row 2's ("analyzer"); and
    for phase 27 the SGD step's inputs, results and floor ("sgd")."""
    k16, k8 = mel_kernels.log_mel_radix16dif_fused, mel_kernels.log_mel_radix8dif_fused
    launches = {"inference": 0, "masked": 0, "analyzer": 0}

    # serving: a seeded checkpoint, its BN statistics from 32 clips and its
    # head x15, so that the probabilities follow the network; the card
    # against the CPU, bf16 and fp32 on the same weights
    clips = synth_clips(rng, BATCH)
    ckpt, ckpt32 = (seeded_checkpoint(tmp / f"resnet_{name}.ckpt", mixed_precision=mp,
                                      head_scale=15.0, architecture="resnet",
                                      calibrate=synth_clips(np.random.default_rng(20), 32))
                    for name, mp in (("bf16", True), ("f32", False)))
    zero_counts()
    engine = ClassifierEngine(ckpt, batch_size=BATCH, device="cuda")
    probs = engine.predict_probs(clips)
    one = engine.classify_wave(clips[0])
    torch.cuda.synchronize()
    read_epilogue("phase 20 ResNet serving")
    launches["inference"] += k16.launches
    print(f"phase 20: ResNet serving path launches: log_mel_radix16dif_fused {k16.launches}")
    check(isinstance(engine.model, CompactResNet) and k16.launches > 0,
          "a CompactResNet served through row 1")
    n = 32
    x_n = torch.from_numpy(clips[:n])

    @torch.inference_mode()
    def logits_of(e):
        return e.model(features_from_wavs(e.frontend, x_n.to(e.device))).float().cpu().numpy()

    cpu, cpu32, gpu32 = (ClassifierEngine(c, batch_size=n, device=d)
                         for c, d in ((ckpt, "cpu"), (ckpt32, "cpu"), (ckpt32, "cuda")))
    err = float(np.abs(probs[:n] - cpu.predict_probs(clips[:n])).max())
    err32 = float(np.abs(gpu32.predict_probs(clips[:n]) - cpu32.predict_probs(clips[:n])).max())
    on_card, on_host, exact = logits_of(engine), logits_of(cpu), logits_of(cpu32)
    scale = float(np.abs(exact).max())
    gap, own = float(np.abs(on_card - on_host).max()), float(np.abs(on_host - exact).max())
    err_one = float(np.abs(np.log(np.array(list(one["probabilities"].values()), np.float64))
                           - np.log(probs[0].astype(np.float64))).max())
    spread = float(np.abs(probs - probs.mean(axis=0)).max())
    print(f"phase 20: ResNet predict_probs, seeded bf16, x15 head, {n} clips: max|cuda - cpu| "
          f"{err:.3e} (the aim 5e-3); logits max|cuda - cpu| {gap:.3e} = "
          f"{gap / scale:.2e} x max|logit| {scale:.3f} (tol 2e-2 x), the CPU's own bf16 against "
          f"its fp32 {own:.3e}; classify_wave vs batch row, max|log p| {err_one:.3e} (tol 4e-2 "
          f"x max|logit|); spread max|p - mean p| {spread:.3e} (>= 2e-2); classes "
          f"{np.bincount(probs.argmax(-1), minlength=4).tolist()}; fp32 engine, same weights: "
          f"max|cuda - cpu| {err32:.3e} (tol 1e-4)")
    check(spread >= 2e-2 and scale >= 1.0, "the ResNet's probabilities follow the network")
    check(gap <= 2e-2 * scale, "ResNet serving logits, cuda vs cpu (bf16)")
    check(err_one <= 4e-2 * scale, "ResNet classify_wave vs its batch row (bf16)")
    check(err32 <= 1e-4, "ResNet serving probabilities, cuda vs cpu (fp32)")

    # wav -> logits at 128 x 5 s, bf16, beside LightweightCNN from the same
    # call, in turns: host clock, then each step as a CUDA graph
    cnn = ClassifierEngine(seeded_checkpoint(tmp / "cnn_x15.ckpt", mixed_precision=True,
                                             head_scale=15.0), batch_size=BATCH, device="cuda")
    engines = {"LightweightCNN": cnn, "ResNet18": engine}
    gflop = {"LightweightCNN": cnn_conv_gflop(N_MELS, 157), "ResNet18": resnet_gflop(N_MELS, 157)}
    x = torch.from_numpy(synth_clips(rng, BATCH)).to(dev)

    def step(e):
        return e.model(features_from_wavs(e.frontend, x))

    host_ms = {name: [] for name in engines}
    with torch.inference_mode():
        for name in ("LightweightCNN", "ResNet18", "ResNet18", "LightweightCNN"):
            for _ in range(3):
                step(engines[name])
            torch.cuda.synchronize()
            reps = 20
            t0 = time.perf_counter()
            for _ in range(reps):
                logits = step(engines[name])
            torch.cuda.synchronize()
            host_ms[name].append((time.perf_counter() - t0) / reps * 1e3)
            check(bool(torch.isfinite(logits).all()), "finite logits")
        for name, e in engines.items():
            device_ms = graph_ms(lambda: step(e), calls=1, iters=20)
            per_batch = launch_calls(lambda: step(e), 2)
            wall = float(np.mean(host_ms[name]))
            work = gflop[name] * BATCH
            print(f"phase 20: [{card}] {name} wav->logits batch {BATCH} x 5 s, bf16: "
                  f"{', '.join(f'{BATCH / ms * 1e3:.1f}' for ms in host_ms[name])} clips/s by the "
                  f"host clock ({wall:.3f} ms a batch); device {device_ms:.4f} ms a batch (a CUDA "
                  f"graph of one step; busy {100 * device_ms / wall:.1f}%); {per_batch:.0f} "
                  f"kernel launches a batch (host launch calls); "
                  f"{'conv ' if name == 'LightweightCNN' else ''}work {work:.1f} GFLOP a batch "
                  f"({gflop[name]:.3f} a clip): {work / device_ms:.1f} TFLOP/s over the whole "
                  f"step, {100 * work / device_ms / (BF16_FLOPS / 1e12):.1f}% of 989")
    for e in engines.values():
        e.warmup_latency()
    lat = {name: [] for name in engines}
    for _ in range(50):
        for name, e in engines.items():
            t0 = time.perf_counter()
            e.classify_wave(clips[1])
            lat[name].append((time.perf_counter() - t0) * 1e3)
    for name, ms in lat.items():
        print(f"phase 20: [{card}] {name} classify_wave, batch 1, host clip in: median "
              f"{np.median(ms):.3f} ms, p90 {np.percentile(ms, 90):.3f} ms over 50 calls")

    # training through the entry point: one epoch at config.yaml
    config = str(REPO / "config.yaml")
    work_dir = tmp / "resnet_run"
    work_dir.mkdir()
    cwd = os.getcwd()
    os.chdir(work_dir)  # config.yaml's checkpoint_dir and log_dir are relative
    try:
        zero_counts()
        t0 = time.perf_counter()
        history = quiet(train_entry.main, ["--config", config, "--model", "resnet",
                                           "--data-path", str(corpus), "--epochs", "1",
                                           "--no-plots"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        read_epilogue("phase 20 ResNet training")
    finally:
        os.chdir(cwd)
    launches["masked"] += k16.launches_masked
    launches["inference"] += k16.launches
    print(f"phase 20: [{card}] train.main --model resnet, 1 epoch at config.yaml (8 s, batch "
          f"32 x 2, bf16, adam, cosine, augmentation): {wall:.1f} s with start-up; history "
          f"{json.dumps(history)}; launches masked {k16.launches_masked}, inference {k16.launches}")
    check(k16.launches_masked > 0 and k16.launches > 0, "the ResNet training path ran row 1")
    check(all(math.isfinite(v) for vals in history.values() for v in vals), "finite history")
    best = work_dir / "checkpoints" / "best_model.ckpt"
    check(best.exists(), "the ResNet's best_model.ckpt written")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + ([os.environ["PYTHONPATH"]] if os.environ.get("PYTHONPATH") else [])))
    out = subprocess.run(
        [sys.executable, "-m", "audio_classification_icbhi_tpu_torch.train", "--config", config,
         "--model", "resnet", "--data-path", str(corpus), "--epochs", "2", "--resume", str(best),
         "--no-plots"],
        cwd=work_dir, env=env, capture_output=True, text=True, timeout=600)
    print("phase 20: resumed ResNet run (subprocess), last lines:\n  "
          + "\n  ".join(out.stdout.strip().splitlines()[-4:]))
    check(out.returncode == 0, f"resumed ResNet training exited {out.returncode}: "
                               f"{out.stderr[-2000:]}")
    check("Epoch 2/2" in out.stdout and "Resumed from" in out.stdout, "resumed to a second epoch")
    served = ClassifierEngine(best, device="cuda")
    clip, _ = ICBHIDataset(corpus, "test", served.config)[0]
    result = served.classify_wave(clip)
    p = np.array(list(result["probabilities"].values()))
    print(f"phase 20: the ResNet's best checkpoint served on the card: "
          f"{result['predicted_class']} {result['confidence']:.4f}")
    check(isinstance(served.model, CompactResNet) and bool(np.isfinite(p).all())
          and abs(p.sum() - 1.0) < 1e-4, "the trained ResNet served")

    # the train step at config.yaml (32 x 2 x 8 s, bf16, Adam, augmentation),
    # and one epoch's wall time as phase 10 takes LightweightCNN's
    cfg = load_config(config)
    cfg["model"]["architecture"] = "resnet"
    fe = MelFrontend.from_config(cfg)
    step_ms, per_step, device_ms = train_step_times(cfg, dev, rng, 2, 32, TRAIN_CLIP)
    train_gflop = 3 * resnet_gflop(N_MELS, 1 + TRAIN_CLIP // HOP) * 64
    print(f"phase 20: [{card}] ResNet train step at config.yaml (32 x 2 x 8 s, bf16, adam, "
          f"augmentation on): {step_ms:.3f} ms by CUDA events back to back "
          f"({64 / step_ms * 1e3:.1f} clips/s); {per_step:.0f} kernel launches a step (host "
          f"launch calls); device {device_ms:.3f} ms a step as a replayed CUDA graph (busy "
          f"{100 * device_ms / step_ms:.1f}% of the eager step); about {train_gflop:.0f} GFLOP "
          f"a step (3 x forward): {train_gflop / device_ms:.1f} TFLOP/s of device time")
    cfg["data"]["dataset_path"] = str(corpus)
    cfg["training"].update(checkpoint_dir=str(tmp / "t20" / "ckpt"),
                           log_dir=str(tmp / "t20" / "runs"))
    trainer = quiet(Trainer, build_model(cfg), ICBHIDataset(corpus, "train", cfg, augment=True),
                    ICBHIDataset(corpus, "val", cfg), cfg, device="cuda")
    trainer.train_epoch(0)  # warm-up: cuDNN algorithm choice, allocator
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.train_epoch(1)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    trainer.validate(1)
    val_s = time.perf_counter() - t0
    print(f"phase 20: [{card}] ResNet train epoch, {len(trainer.train_dataset)} clips, "
          f"{-(-len(trainer.train_loader) // trainer.accum_steps)} optimizer steps: "
          f"{epoch_s * 1e3:.1f} ms wall; validation, {len(trainer.val_dataset)} clips: "
          f"{val_s * 1e3:.1f} ms")
    del trainer
    torch.cuda.empty_cache()

    sgd = resnet_sgd_step(dev, rng, fe)

    # the analyzer with the trained ResNet at 0.5 s windows (row 2)
    zero_counts()
    eng, results, csv_path = quiet(analyze.main, [
        "parallel", "--audio", str(recording), "--model", str(best),
        "--segment-duration", "0.5", "--output-dir", str(tmp / "resnet_analysis"),
        "--no-plots"])
    torch.cuda.synchronize()
    read_epilogue("phase 20 ResNet analyzer")
    launches["analyzer"] += k8.launches
    check(k8.launches == 1 and k16.launches == 0 and len(results) == 60
          and isinstance(eng.classifier.model, CompactResNet),
          "the ResNet analyzer ran row 2 once over 60 windows")
    for _ in range(3):
        quiet(eng.analyze_audio, recording)
    wall_ms = []
    for _ in range(20):
        t0 = time.perf_counter()
        quiet(eng.analyze_audio, recording)
        wall_ms.append((time.perf_counter() - t0) * 1e3)
    windows = quiet(lambda: eng.segment_audio(eng.load_audio(recording)))[0]
    on_cpu = quiet(AnalyzerEngine, str(best), segment_duration=0.5, sample_rate=SR, device="cpu")
    gpu_w, cpu_w = eng.predict_window_probs(windows), on_cpu.predict_window_probs(windows)
    err_w = float(np.abs(gpu_w - cpu_w).max())
    with torch.inference_mode():
        gpu_l, cpu_l = (e._apply_fn(e.frontend(torch.from_numpy(windows).to(e.device))[..., None])
                        .float().cpu().numpy() for e in (eng, on_cpu))
    gap_w, scale_w = float(np.abs(gpu_l - cpu_l).max()), float(np.abs(cpu_l).max())
    print(f"phase 20: [{card}] ResNet analyzer, 15 s recording at 0.5 s windows (60 -> bucket "
          f"64), warm analyze_audio median {np.median(wall_ms):.3f} ms, p90 "
          f"{np.percentile(wall_ms, 90):.3f} ms; max|cuda - cpu| probability {err_w:.3e} (the "
          f"aim 5e-3), logits {gap_w:.3e} = {gap_w / scale_w:.2e} x max|logit| {scale_w:.3f} "
          f"(tol 2e-2 x); classes {np.bincount(gpu_w.argmax(-1), minlength=4).tolist()}")
    check(bool(np.isfinite(gpu_w).all()) and gap_w <= 2e-2 * scale_w,
          "ResNet analyzer, cuda vs cpu (bf16)")

    # model.pretrained from a torchvision-shaped resnet18 .pt
    tv = torchvision_shaped_resnet18(seed=20)
    torch.save(tv, tmp / "resnet18_imagenet_shaped.pt")
    cfg["model"].update(pretrained=True, pretrained_path=str(tmp / "resnet18_imagenet_shaped.pt"))
    trainer = quiet(Trainer, build_model(cfg), ICBHIDataset(corpus, "train", cfg),
                    ICBHIDataset(corpus, "val", cfg), cfg, device="cuda")
    got = {k: v.cpu() for k, v in trainer.model.state_dict().items()}
    seeded = CompactResNet(generator=torch.Generator().manual_seed(cfg["seed"])).state_dict()
    stem = torch.equal(got["resnet.conv1.weight"], tv["conv1.weight"].sum(1, keepdim=True))
    trunk = all(torch.equal(got[f"resnet.{k}"], v) for k, v in tv.items()
                if k != "conv1.weight" and not k.startswith("fc."))
    head = all(torch.equal(got[k], seeded[k]) for k in seeded if k.startswith("resnet.fc."))
    print(f"phase 20: model.pretrained from a torchvision-shaped resnet18 .pt on the card: stem "
          f"= channel sum {stem}, trunk loaded {trunk}, head kept its seeded init {head}")
    check(stem and trunk and head and trainer.model.resnet.conv1.weight.is_cuda,
          "model.pretrained imported the torchvision resnet18")
    del trainer

    # ICBHI_FUSED_CNN=1 on a ResNet: its own forward, rows 8-10 never launch
    os.environ["ICBHI_FUSED_CNN"] = "1"
    try:
        zero_counts()
        fused = ClassifierEngine(ckpt, batch_size=BATCH, device="cuda")
        fused.predict_probs(clips)
        fused.classify_wave(clips[0])
        fused_ana = quiet(AnalyzerEngine, str(best), segment_duration=0.5, sample_rate=SR)
        fused_ana.predict_window_probs(windows)
        torch.cuda.synchronize()
        conv = conv_counts()
        read_epilogue("phase 20 ResNet with ICBHI_FUSED_CNN=1")
        launches["inference"] += k16.launches
        launches["analyzer"] += k8.launches
    finally:
        os.environ.pop("ICBHI_FUSED_CNN", None)
    print(f"phase 20: ResNet serving and analyzer with ICBHI_FUSED_CNN=1: rows 8-10 launches "
          f"{conv}; row 1 {k16.launches}, row 2 {k8.launches}")
    check(all(v == 0 for v in conv.values()) and fused._apply_fn is fused.model
          and fused_ana._apply_fn is fused_ana.classifier.model,
          "a ResNet runs its own forward under ICBHI_FUSED_CNN=1")
    print(f"phase 20: rows 1 and 2 over the ResNet runs: {launches}")
    return launches | {"sgd": sgd}


SEG_RECORDINGS, SEG_CYCLES = 64, 6  # 384 cycles: 288 / 48 / 48, 3 optimizer steps an epoch

# A subprocess that trains through `train_icbhi.main` and prints, as its
# last line, the launches its kernel wrappers counted.
ENTRY_COUNTED = """
import importlib, json, sys, torch
from audio_classification_icbhi_tpu_torch.ops import mel_kernels
history = importlib.import_module(sys.argv[1]).main(sys.argv[2:])
print(json.dumps({"history": history, "epilogue": mel_kernels.log_mel_epilogue.launches,
                  "launches": {name: [fn.launches, fn.launches_masked]
                               for name, fn in mel_kernels.WRAPPERS.items()}}))
"""


def held_to_cpu(what: str, card: tuple, cpu: tuple, tol: float, by_logits: bool = False,
                spread_at_least: float | None = None) -> str:
    """The card's Validator output (y_true, y_pred, y_prob, logits) against
    the CPU port's on the same checkpoint and split: y_true equal; y_prob
    within `tol`, or by_logits, the logits within tol x max |logit|; y_pred
    equal wherever the CPU's top-2 margin of those exceeds the tolerance.
    The CPU's y_prob spread across the clips, max|p - mean p|, is reported
    and, given spread_at_least, held to it: a model whose output ignores its
    input would pass the rest whatever the front end. Returns a line to
    print."""
    check(np.array_equal(card[0], cpu[0]), f"{what}: y_true, card vs cpu")
    if by_logits:
        got, want, kind = card[3], cpu[3], "logits"
        tol = tol * float(np.abs(want).max())
    else:
        got, want, kind = card[2], cpu[2], "y_prob"
    err = float(np.abs(got - want).max())
    top2 = np.sort(want, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > tol
    spread = float(np.abs(cpu[2] - cpu[2].mean(axis=0)).max())
    check(err <= tol, f"{what}: {kind} card vs cpu {err:.3e} (tol {tol:.3e})")
    check(np.array_equal(card[1][clear], cpu[1][clear]), f"{what}: y_pred where the margin allows")
    if spread_at_least is not None:
        check(spread >= spread_at_least, f"{what}: y_prob spread {spread:.3e} across the clips "
                                         f"(>= {spread_at_least:g})")
    return (f"{what}: max|{kind} card - cpu| = {err:.3e} (tol {tol:.3e}); y_pred equal on "
            f"{int(clear.sum())} of {len(clear)} clips clear of the tolerance; y_prob spread "
            f"{spread:.3e}" + ("" if spread_at_least is None else f" (>= {spread_at_least:g})")
            + f"; classes {np.bincount(cpu[1], minlength=cpu[2].shape[1]).tolist()}")


def validate_on_card(entry, ckpt: Path, config: str, data: Path, out: Path, dev) -> tuple:
    """`entry.main` (validate or validate_icbhi) on the card with --no-plots,
    the launch counts zeroed before and read after. Returns (its result,
    row 1's inference launches)."""
    zero_counts()
    res = quiet(entry.main, ["--model", str(ckpt), "--config", config, "--data-path", str(data),
                             "--output-dir", str(out), "--no-plots", "--device", dev.type])
    torch.cuda.synchronize()
    read_epilogue(f"phase 21 {entry.__name__.rsplit('.', 1)[-1]} {out.name}")
    k16 = mel_kernels.log_mel_radix16dif_fused
    check(k16.launches > 0 and k16.launches_masked == 0, f"{out.name}: row 1 ran")
    check(not list(out.glob("*.png")), "--no-plots drew nothing")
    return res, k16.launches


def phase21_segmented(dev, rng, card: str, tmp: Path, corpus: Path) -> dict[str, int]:
    """The segmented ICBHI path through its entry points, with the launch
    counts zeroed before and read after each main-path run: the corpus
    fixture at native 4 / 10 / 44.1 kHz, `preprocess_icbhi`, one epoch of
    `train_icbhi` at config_segmented.yaml as a subprocess for LightweightCNN
    and then the ResNet, `validate_icbhi` on each best checkpoint and
    `validate` on phase 9's whole-recording checkpoint (8 s at config.yaml),
    and the ResNet's `checkpoint_copy` with calibrated BN, each held to the
    CPU port's Validator on the same checkpoint, and each
    report to the port's numpy metrics of the card's arrays; the timings of
    validation, of the train step at config_segmented.yaml and of the
    segmentation. Returns row 1's launches: its inference form
    ("inference", 94 frames at 3 s and 251 at 8 s) and its training form
    ("masked")."""
    launches = {"inference": 0, "masked": 0}
    seg_config = str(REPO / "config_segmented.yaml")
    t0 = time.perf_counter()
    raw = generate_icbhi_corpus_fixture(tmp / "icbhi_raw", num_recordings=SEG_RECORDINGS,
                                        cycles_per_recording=SEG_CYCLES, seed=21)
    fixture_s = time.perf_counter() - t0
    segmented = tmp / "icbhi_segmented"
    t0 = time.perf_counter()
    stats = quiet(preprocess_icbhi.main, ["--input-dir", str(raw / "audio_and_txt_files"),
                                          "--output-dir", str(segmented)])
    seg_ms = (time.perf_counter() - t0) * 1e3
    audio_s = sum(x.shape[-1] / sr for x, sr in map(read_wav, (raw / "audio_and_txt_files").glob("*.wav")))
    print(f"phase 21: [{card}] corpus fixture, {SEG_RECORDINGS} recordings x {SEG_CYCLES} cycles "
          f"at 4 / 10 / 44.1 kHz ({audio_s:.1f} s of audio): written in {fixture_s:.1f} s; "
          f"preprocess_icbhi (host): {seg_ms:.1f} ms, {stats['total_segments']} segments, "
          f"{stats['skipped_segments']} skipped ({audio_s / seg_ms * 1e3:.1f} s of audio a second)")
    check(stats["processed_files"] == SEG_RECORDINGS
          and stats["total_segments"] == SEG_RECORDINGS * SEG_CYCLES
          and all(stats[c] > 0 for c in ("normal", "crackle", "wheeze", "both")),
          "every cycle segmented into its class, the zero-length rows skipped")

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + ([os.environ["PYTHONPATH"]] if os.environ.get("PYTHONPATH") else [])))
    reports = tmp / "reports21"
    arrays = {}
    for arch in ("cnn", "resnet"):
        work = tmp / f"t21_{arch}"
        work.mkdir()
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-c", ENTRY_COUNTED, "audio_classification_icbhi_tpu_torch.train_icbhi",
             "--config", seg_config, "--data-path",
             str(segmented), "--epochs", "1", "--no-plots", "--model", arch, "--device", dev.type],
            cwd=work, env=env, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        check(out.returncode == 0, f"train_icbhi --model {arch} exited {out.returncode}: "
                                   f"{out.stderr[-2000:]}")
        counted = json.loads(out.stdout.strip().splitlines()[-1])
        row1 = counted["launches"]["radix16dif_fused"]
        others = sum(sum(v) for k, v in counted["launches"].items() if k != "radix16dif_fused")
        calls = sum(sum(v) for v in counted["launches"].values())
        n_train = int(re.search(r"Training samples: (\d+)", out.stdout).group(1))
        steps = -(-(n_train // 32) // 4)
        print(f"phase 21: [{card}] train_icbhi --model {arch}, 1 epoch at config_segmented.yaml "
              f"(3 s, batch 32 x 4, bf16), subprocess: {wall:.1f} s wall; {n_train} clips, "
              f"{steps} optimizer steps; history {json.dumps(counted['history'])}; row 1 "
              f"launches {row1[0]} (validation), {row1[1]} masked (training)")
        check(steps >= 2, "at least two optimizer steps an epoch")
        check(row1[0] > 0 and row1[1] > 0 and others == 0,
              f"train_icbhi --model {arch} ran row 1, both forms, and no other log-mel kernel")
        check(counted["epilogue"] == calls, "the epilogue launched with each log-mel call")
        check(all(math.isfinite(v) for vals in counted["history"].values() for v in vals),
              "finite history")
        launches["inference"] += row1[0]
        launches["masked"] += row1[1]
        EPILOGUE_MAIN_PATH["launches"] += counted["epilogue"]
        best = work / "checkpoints" / "best_model.ckpt"
        check(best.exists(), f"the {arch} best checkpoint written")

        # validate_icbhi on the card on the best checkpoint, and for the
        # ResNet, whose softmax is saturated after 3 steps, on a copy with its
        # BN statistics from 32 train cycles: each report against the numpy
        # metrics of the card's arrays, the arrays against the CPU port's
        # Validator, and every y_prob held spread >= 4x the bf16 tolerance
        cfg = load_checkpoint(best)["config"]
        test = quiet(ICBHISegmentedDataset, segmented, "test", cfg)
        runs = [("as trained", best, arch == "cnn")]
        if arch == "resnet":
            clips = quiet(ICBHISegmentedDataset, segmented, "train", cfg).load_batch(range(32))[0]
            runs.append(("BN calibrated", checkpoint_copy(best, work / "best_bn.ckpt", clips),
                         True))
        for name, ckpt_path, spread in runs:
            out_dir = reports / f"{arch}_{name.split()[0]}"
            res, ran = validate_on_card(validate_icbhi, ckpt_path, seg_config, segmented,
                                        out_dir, dev)
            launches["inference"] += ran
            got = (res["y_true"], res["y_pred"], res["y_prob"], res["logits"])
            scores = calculate_icbhi_score(got[0], got[1], class_names=validate_icbhi.SEG_CLASSES)
            detailed = calculate_detailed_confusion_metrics(
                got[0], got[1], class_names=validate_icbhi.SEG_CLASSES)
            check((out_dir / "icbhi_results_test.txt").read_text()
                  == validate_icbhi.results_text("test", scores, detailed),
                  "icbhi_results_test.txt is the numpy metrics of the card's arrays")
            engine = ClassifierEngine(ckpt_path, device="cpu")
            cpu = Validator(engine.model, test, engine.config, device="cpu").validate(
                with_logits=True)
            print(f"phase 21: validate_icbhi {arch} {name} (test split, {len(got[0])} cycles, "
                  f"row 1 {ran} launches): ICBHI score {scores['icbhi_score']:.4f}; "
                  + held_to_cpu(f"{arch} bf16 {name}", got, cpu, 2e-2 if arch == "resnet" else 5e-3,
                                by_logits=arch == "resnet", spread_at_least=2e-2 if spread else None))
        arrays[arch] = (best, test)

    # fp32: the LightweightCNN checkpoint with mixed precision off
    best, test = arrays["cnn"]
    f32 = checkpoint_copy(best, tmp / "t21_cnn_f32.ckpt", mixed_precision=False)
    cfg32 = load_checkpoint(f32)["config"]
    on = {d: Validator(ClassifierEngine(f32, device=d).model, test, cfg32, device=d
                       ).validate(with_logits=True) for d in (dev, "cpu")}
    print("phase 21: cnn fp32 Validator: "
          + held_to_cpu("cnn fp32", on[dev], on["cpu"], 1e-4, spread_at_least=2e-2))

    # validate on phase 9's whole-recording checkpoint and corpus (8 s)
    best9 = tmp / "run" / "checkpoints" / "best_model.ckpt"
    out_dir = reports / "whole"
    res, ran = validate_on_card(validate_entry, best9, str(REPO / "config.yaml"), corpus,
                                out_dir, dev)
    launches["inference"] += ran
    got = (res["y_true"], res["y_pred"], res["y_prob"], res["logits"])
    engine = ClassifierEngine(best9, device="cpu")
    text = (out_dir / "validation_test.json").read_text()
    check(text == json.dumps(validate_entry.report(*got[:3], engine.config["classes"]), indent=2),
          "validation_test.json is the numpy metrics of the card's arrays")
    whole_test = quiet(ICBHIDataset, corpus, "test", engine.config)
    cpu = Validator(engine.model, whole_test, engine.config, device="cpu").validate(
        with_logits=True)
    print(f"phase 21: validate, phase 9's checkpoint (test split, {len(got[0])} recordings x 8 s, "
          f"row 1 {ran} launches): accuracy {json.loads(text)['metrics']['accuracy']:.4f}; "
          + held_to_cpu("cnn bf16 whole", got, cpu, 5e-3, spread_at_least=2e-2))

    # timings: a warm validation pass of each split by the host clock (it
    # ends in the device->host copy), and the train step at config_segmented
    for what, ckpt_path, ds in (("cnn segmented", *arrays["cnn"]),
                                ("resnet segmented", *arrays["resnet"]),
                                ("cnn whole 8 s", best9, whole_test)):
        engine = ClassifierEngine(ckpt_path, device=dev)
        validator = Validator(engine.model, ds, engine.config, device=dev)
        validator.validate()
        wall = []
        for _ in range(3):
            t0 = time.perf_counter()
            validator.validate()
            wall.append((time.perf_counter() - t0) * 1e3)
        ms = float(np.median(wall))
        print(f"phase 21: [{card}] Validator {what}, {len(ds)} clips at batch "
              f"{validator.batch_size}: {ms:.1f} ms a split (median of 3; "
              f"{min(wall):.1f}-{max(wall):.1f}), {len(ds) / ms * 1e3:.1f} clips/s")
    cfg = load_config(seg_config)
    for arch in ("cnn", "resnet"):
        cfg["model"]["architecture"] = arch
        step_ms, per_step, device_ms = train_step_times(cfg, dev, rng, 4, 32, SEG_CLIP)
        print(f"phase 21: [{card}] {arch} train step at config_segmented.yaml (32 x 4 x 3 s, bf16, "
              f"adam, augmentation on): {step_ms:.3f} ms by CUDA events back to back "
              f"({128 / step_ms * 1e3:.1f} clips/s); {per_step:.0f} kernel launches a step; "
              f"device {device_ms:.3f} ms a step as a replayed CUDA graph (busy "
              f"{100 * device_ms / step_ms:.1f}% of the eager step)")
    print(f"phase 21: row 1 launches over the phase's main paths {launches}")
    return launches


LOSS_SCALE_START = (np.float32(65536.0), np.int32(0))  # torch GradScaler's defaults


def mesh_step_times(cfg: dict, dev, rng, mesh=None) -> tuple[float, float, float]:
    """The train step at `cfg` on 2 x 32 clips of 8 s (Adam, augmentation
    on, the draws and dropout from a generator on the card), through
    `mesh`'s group when given (its BatchNorm and its step), with the fp16
    loss scale when cfg asks for fp16. Returns its ms by CUDA events back to
    back, its host launch calls a step, and its device-busy ms a step by
    the profiler: the fp16 step reads its skip flag on the host, which a
    CUDA graph cannot hold, and the NCCL step's collectives are not
    captured; the profiler undercounts (PERF.md §7), so the plain step's
    figure by the same means stands beside."""
    fe = MelFrontend.from_config(cfg)
    a, b = 2, 32
    wavs = torch.from_numpy(synth_clips(rng, a * b, TRAIN_CLIP).reshape(a, b, TRAIN_CLIP)).to(dev)
    labels = torch.from_numpy(rng.integers(0, 4, (a, b))).long().to(dev)
    cw = torch.ones(4, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    model = build_model(cfg, generator=torch.Generator().manual_seed(0),
                        axis_name=mesh.group if mesh is not None else None).to(dev)
    scaled = cfg["training"].get("precision") == "fp16"
    fns = make_step_fns(model, fe, build_optimizer("adam", model.named_parameters(), 1e-4),
                        accum_steps=a, augment=True, mesh=mesh, dynamic_loss_scale=scaled)
    scale = [LOSS_SCALE_START]

    def one_step():
        if not scaled:
            return fns.train_step(wavs, labels, cw, 3e-3, generator=gen)
        m, scale[0] = fns.train_step(wavs, labels, cw, 3e-3, generator=gen, scale_state=scale[0])
        return m

    step_ms = cuda_ms(one_step, iters=10, warmup=3)
    per_step = launch_calls(one_step, 2)
    _, busy_us, _ = trace_device(one_step, 3)
    return step_ms, per_step, busy_us / 3e3


def sync_batchnorm_on_card(dev, rng, card: str, mesh) -> None:
    """The cross-rank BatchNorm (`models/cnn.SyncBatchNorm`, on torch's fused
    per-channel ops on the card) at world size 1 against BatchNorm without a
    group (cuDNN's) on the same input: block 1's in the train step at
    config.yaml, 32 clips x 32 channels x 128 mels x 251 frames, channels
    last as the convolution leaves it. Output, input and parameter
    gradients, running statistics; then each one's forward and backward by
    CUDA events."""
    def on_card(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a.astype(np.float32)).to(dev).contiguous(
            memory_format=torch.channels_last)

    x = on_card(1.5 * rng.standard_normal((32, 32, N_MELS, 251)) + 0.3)
    cot = on_card(rng.standard_normal(tuple(x.shape)))
    runs = {}
    for name, group in (("sync", mesh.group), ("plain", None)):
        bn = BatchNorm(32, group=group).to(dev).train()
        xg = x.clone().requires_grad_()
        y = bn(xg)
        (y * cot).sum().backward()
        runs[name] = (y.detach(), xg.grad, bn.weight.grad, bn.bias.grad,
                      bn.running_mean.clone(), bn.running_var.clone())

        def fwd_bwd(bn=bn):
            xg = x.clone().requires_grad_()
            (bn(xg) * cot).sum().backward()

        runs[name] += (cuda_ms(fwd_bwd, iters=20),)
    names = ("output", "input grad", "weight grad", "bias grad", "running mean", "running var")
    errs = [float(((a - b).abs().max() / b.abs().max().clamp(min=1.0)).item())
            for a, b in zip(runs["sync"][:6], runs["plain"][:6])]
    print(f"phase 22: cross-rank BatchNorm at world size 1 (fused per-channel ops, NCCL) against "
          f"BatchNorm without a group, 32 x 32 x {N_MELS} x 251 f32 channels last: max |d| / "
          f"max(1, max|ref|) "
          + ", ".join(f"{n} {e:.2e}" for n, e in zip(names, errs)) + " (tol 1e-5)")
    print(f"phase 22: [{card}] forward + backward by CUDA events: cross-rank "
          f"{runs['sync'][6]:.3f} ms, without a group {runs['plain'][6]:.3f} ms")
    check(max(errs) <= 1e-5, "the cross-rank BatchNorm at world size 1 is BatchNorm")


def phase22_data_parallel(dev, rng, card: str, tmp: Path, corpus: Path, recording: Path,
                          sgd: dict) -> dict[str, int]:
    """Data-parallel training and the fp16 loss scale on the card, the launch
    counts zeroed before and read after each main-path run:
    (a) phase 8's lr-1 SGD step (config.yaml, 2 x 8 x 8 s, fp32) on a
    world-size-1 NCCL mesh (cross-rank BatchNorm, the all-reduces) against
    the same step without a group on the card and on the CPU, by phase 8's
    `step_floor`; (b) two NCCL ranks against one, where two GPUs are
    visible; (c) the fp16 scaled step on the card against the CPU, and a
    forced overflow (scale 2^24), which must be skipped with the scale
    halved and the parameters untouched; (d) one epoch of `train` at
    config.yaml with `precision: fp16` under `--multihost --num-processes
    1` as a subprocess printing its counts, resumed as a subprocess with
    its checkpoint's scale state, and its best checkpoint served; (e) the
    analyzer on a 1-device mesh against no mesh at 0.5 and 1 s windows;
    (f) the NCCL and fp16 steps' times beside the plain bf16 step's.
    Returns row 1's launches ("inference", "masked") and row 2's
    ("analyzer")."""
    import yaml

    launches = {"inference": 0, "masked": 0, "analyzer": 0}
    k8, k16 = mel_kernels.log_mel_radix8dif_fused, mel_kernels.log_mel_radix16dif_fused
    wavs, labels, cw = (sgd[k].to(dev) for k in ("wavs", "labels", "cw"))
    cfg = load_config(str(REPO / "config.yaml"))
    cfg16 = load_config(str(REPO / "config.yaml"))
    cfg16["training"]["precision"] = "fp16"

    # (a) the NCCL step at world size 1, and (f) the timings
    init_distributed(f"127.0.0.1:{free_port()}", 1, 0, device=dev)
    try:
        mesh = get_mesh(device=dev)
        check(mesh.group is not None and mesh.world_size == 1 and mesh.device.type == "cuda",
              "a world-size-1 NCCL mesh on the card")
        model = LightweightCNN(axis_name=mesh.group)
        model.load_state_dict(sgd["init"])
        model.to(dev).set_dropout(0.0)
        fns = make_step_fns(model, sgd["fe"], build_optimizer("sgd", model.named_parameters(),
                                                              1e-4), accum_steps=2, mesh=mesh)
        zero_counts()
        m = {k: float(v) for k, v in fns.train_step(wavs, labels, cw, 1.0).items()}
        torch.cuda.synchronize()
        read_epilogue("phase 22 NCCL step")
        check(k16.launches == 1 and k16.launches_masked == 0, "the NCCL step ran row 1 once")
        launches["inference"] += k16.launches
        got = (param_arrays(model), m["grad_norm"])
        vs_card = step_margins(got, sgd["card"], sgd["floor"])
        vs_cpu = step_margins(got, sgd["cpu"], sgd["floor"])
        loss_err = abs(m["loss"] - sgd["card_loss"]) / abs(sgd["card_loss"])
        print(f"phase 22: lr-1 SGD step on a world-size-1 NCCL mesh (cross-rank BN, all-reduces), "
              f"2 x 8 x 8 s fp32: loss {m['loss']:.6f} (rel {loss_err:.2e} from the step without "
              f"a group, tol 1e-5); params worst |d| over phase 8's bound {vs_card.params:.3f} "
              f"against the card's step without a group, {vs_cpu.params:.3f} against the CPU's; "
              f"grad norm {vs_card.grad_norm:.3f} / {vs_cpu.grad_norm:.3f}")
        check(loss_err <= 1e-5, "NCCL step loss")
        check(vs_card.ok and vs_cpu.ok, f"NCCL step params ({vs_card}; {vs_cpu})")

        sync_batchnorm_on_card(dev, rng, card, mesh)

        ones = torch.ones(64, device=dev)  # one collective's own cost, on the host and the card
        for _ in range(10):
            all_reduce_sum(ones, mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(100):
            all_reduce_sum(ones, mesh)
        host_us = (time.perf_counter() - t0) * 1e4
        torch.cuda.synchronize()
        call_us = (time.perf_counter() - t0) * 1e4
        print(f"phase 22: [{card}] a 64-float NCCL all-reduce at world size 1: {host_us:.1f} us "
              f"of host time a call, {call_us:.1f} us a call to the card's sync (100 calls)")
        plain = mesh_step_times(cfg, dev, rng)
        dp = mesh_step_times(cfg, dev, rng, mesh)
        half = mesh_step_times(cfg16, dev, rng)
        graph = train_step_times(cfg, dev, rng, 2, 32, TRAIN_CLIP)[2]
    finally:
        close_distributed()
    for what, (ms, per, busy) in (("bf16, no group", plain), ("bf16, world-size-1 NCCL mesh", dp),
                                  ("fp16, loss-scaled", half)):
        print(f"phase 22: [{card}] train step at config.yaml (32 x 2 x 8 s, adam, augmentation "
              f"on), {what}: {ms:.3f} ms by CUDA events back to back; {per:.0f} kernel launches "
              f"a step; device busy {busy:.3f} ms a step by the profiler "
              f"({100 * busy / plain[2] - 100:+.1f}% against the plain step's)")
    print(f"phase 22: [{card}] the plain bf16 step as a replayed CUDA graph: {graph:.3f} ms")

    # (b) two NCCL ranks against one
    n_gpu = torch.cuda.device_count()
    if n_gpu >= 2:
        cfg2 = load_config(str(REPO / "config.yaml"))
        cfg2["data"]["augmentation"] = False
        cfg2["model"].update(architecture="resnet", dropout=0.0)  # no draw depends on the rank
        cfg2["training"].update(mixed_precision=False, optimizer="sgd", learning_rate=0.01)
        runs = {}
        for n in (2, 1):
            cfg2["training"].update(checkpoint_dir=str(tmp / f"r{n}" / "ckpt"),
                                    log_dir=str(tmp / f"r{n}" / "runs"))
            path = tmp / f"ranks{n}.yaml"
            path.write_text(yaml.safe_dump(cfg2))
            runs[n] = quiet(train_entry.main, ["--config", str(path), "--data-path", str(corpus),
                                               "--epochs", "1", "--no-plots", "--num-devices",
                                               str(n)])
        err = max(abs(a - b) / abs(b) for k in ("train_loss", "val_loss")
                  for a, b in zip(runs[2][k], runs[1][k]))
        print(f"phase 22: [{card}] two NCCL ranks against one, ResNet fp32 without dropout, one "
              f"epoch: losses {runs[2]['train_loss']} / {runs[1]['train_loss']}, max rel {err:.2e} "
              f"(tol 2e-3)")
        check(err <= 2e-3, "two NCCL ranks against one")
    else:
        print(f"phase 22: two NCCL ranks against one: not run, {n_gpu} CUDA device visible "
              f"(NCCL takes one GPU a rank); the 2- and 4-rank steps are held on the CPU over "
              f"gloo (tests/test_torch_data_parallel.py)")

    # (c) the fp16 scaled step, card against CPU, and a forced overflow, on
    # 2 x 4 clips of 2 s of phase 8's (fp16 convolutions are slow on the CPU)
    def fp16_step(device, scale_state):
        model = LightweightCNN(dtype=torch.float16)
        model.load_state_dict(sgd["init"])
        model.to(device).set_dropout(0.0)
        fns = make_step_fns(model, sgd["fe"], build_optimizer("sgd", model.named_parameters(),
                                                              1e-4),
                            accum_steps=2, dynamic_loss_scale=True)
        m, ss = fns.train_step(sgd["wavs"][:, :4, :2 * SR].to(device),
                               sgd["labels"][:, :4].to(device), sgd["cw"].to(device), 1e-2,
                               scale_state=scale_state)
        return {k: float(v) for k, v in m.items()}, ss, model

    zero_counts()
    m_gpu, ss_gpu, model_gpu = fp16_step(dev, LOSS_SCALE_START)
    huge = (np.float32(2.0 ** 24), np.int32(4))
    m_over, ss_over, model_over = fp16_step(dev, huge)
    torch.cuda.synchronize()
    read_epilogue("phase 22 fp16 steps")
    check(k16.launches == 2 and k16.launches_masked == 0, "the fp16 steps ran row 1")
    launches["inference"] += k16.launches
    m_cpu, ss_cpu, model_cpu = fp16_step("cpu", LOSS_SCALE_START)
    loss_err = abs(m_gpu["loss"] - m_cpu["loss"]) / abs(m_cpu["loss"])
    norm_err = abs(m_gpu["grad_norm"] - m_cpu["grad_norm"]) / m_cpu["grad_norm"]
    sd_g, sd_c = model_gpu.state_dict(), model_cpu.state_dict()
    bn_err = max(((sd_g[k].cpu() - sd_c[k]).abs() / (sd_c[k].abs() + 1e-2)).max().item()
                 for k in sd_c if "running" in k)
    print(f"phase 22: fp16 loss-scaled SGD step, 2 x 4 x 2 s: loss cuda {m_gpu['loss']:.6f} cpu "
          f"{m_cpu['loss']:.6f} (rel {loss_err:.2e}, tol 5e-3); grad norm rel {norm_err:.2e} "
          f"(tol 5e-2); BN buffers max rel {bn_err:.2e} (tol 2e-2); scale state cuda "
          f"{ss_gpu} cpu {ss_cpu}")
    check(loss_err <= 5e-3 and norm_err <= 5e-2 and bn_err <= 2e-2, "fp16 step, cuda vs cpu")
    check(m_gpu["step_skipped"] == m_cpu["step_skipped"] == 0.0
          and ss_gpu == ss_cpu == (65536.0, 1), "a clean fp16 step counts towards growth")
    untouched = all(torch.equal(p.detach().cpu(), sgd["init"][n])
                    for n, p in model_over.named_parameters())
    print(f"phase 22: forced overflow (scale 2^24): skipped {m_over['step_skipped']:g}, grad norm "
          f"{m_over['grad_norm']}, scale state {ss_over}, parameters untouched {untouched}")
    check(m_over["step_skipped"] == 1.0 and math.isinf(m_over["grad_norm"])
          and ss_over == (2.0 ** 23, 0) and untouched, "the overflowing step was skipped")

    # (d) train at fp16 under --multihost, resumed, served
    work = tmp / "fp16"
    work.mkdir()
    (work / "fp16.yaml").write_text(yaml.safe_dump(cfg16))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + ([os.environ["PYTHONPATH"]] if os.environ.get("PYTHONPATH") else [])))

    def multihost() -> list[str]:
        return ["--multihost", "--coordinator", f"127.0.0.1:{free_port()}", "--num-processes",
                "1", "--process-id", "0"]

    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-c", ENTRY_COUNTED, "audio_classification_icbhi_tpu_torch.train",
         "--config", "fp16.yaml", "--data-path", str(corpus), "--epochs", "1", "--no-plots",
         *multihost()], cwd=work, env=env, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    check(out.returncode == 0, f"fp16 --multihost train exited {out.returncode}: "
                               f"{out.stderr[-2000:]}")
    check("Distributed: process 0" in out.stdout, "the run joined its process group")
    counted = json.loads(out.stdout.strip().splitlines()[-1])
    row1 = counted["launches"]["radix16dif_fused"]
    others = sum(sum(v) for k, v in counted["launches"].items() if k != "radix16dif_fused")
    check(row1[0] > 0 and row1[1] > 0 and others == 0, "the fp16 epoch ran row 1, both forms")
    check(counted["epilogue"] == sum(row1), "the epilogue launched with each log-mel call")
    launches["inference"] += row1[0]
    launches["masked"] += row1[1]
    EPILOGUE_MAIN_PATH["launches"] += counted["epilogue"]
    best = work / "checkpoints" / "best_model.ckpt"
    scale_state = load_checkpoint(best)["scale_state"]
    history = counted["history"]
    print(f"phase 22: [{card}] train --multihost --num-processes 1 at config.yaml with precision: "
          f"fp16, 1 epoch (subprocess, start-up included): {wall:.1f} s; history "
          f"{json.dumps(history)}; row 1 launches {row1[0]} (validation), {row1[1]} masked "
          f"(training); checkpoint scale_state {scale_state.tolist()} ({scale_state.dtype})")
    check(scale_state.dtype == np.float64 and scale_state.shape == (2,), "scale_state is a pair")
    check(all(math.isfinite(v) for vals in history.values() for v in vals), "finite fp16 history")
    out = subprocess.run(
        [sys.executable, "-m", "audio_classification_icbhi_tpu_torch.train", "--config",
         "fp16.yaml", "--data-path", str(corpus), "--epochs", "2", "--resume", str(best),
         "--no-plots", *multihost()], cwd=work, env=env, capture_output=True, text=True,
        timeout=600)
    check(out.returncode == 0, f"resumed fp16 training exited {out.returncode}: "
                               f"{out.stderr[-2000:]}")
    found = re.search(r"Resumed from .* at epoch 1 \(loss scale ([0-9.e+]+), (\d+) clean steps\)",
                      out.stdout)
    check(found is not None and "Epoch 2/2" in out.stdout, "resumed to a second fp16 epoch")
    resumed = (float(found.group(1)), int(found.group(2)))
    print(f"phase 22: resumed run (subprocess) started from loss scale {resumed[0]:g} with "
          f"{resumed[1]} clean steps; the checkpoint holds {scale_state.tolist()}")
    check(resumed == (float(scale_state[0]), int(scale_state[1])), "scale_state resumed exactly")
    engine = ClassifierEngine(best, device="cuda")
    clip, _ = ICBHIDataset(corpus, "test", engine.config)[0]
    result = engine.classify_wave(clip)
    probs = np.array(list(result["probabilities"].values()))
    print(f"phase 22: the fp16 best checkpoint served on the card ({engine.model.dtype}): "
          f"{result['predicted_class']} {result['confidence']:.4f}")
    check(engine.model.dtype == torch.float16 and bool(np.isfinite(probs).all())
          and abs(probs.sum() - 1.0) < 1e-3, "fp16 checkpoint served")

    # (e) the analyzer on a 1-device mesh against no mesh
    trained = str(tmp / "run" / "checkpoints" / "best_model.ckpt")
    for duration in (0.5, 1.0):
        plain = quiet(AnalyzerEngine, trained, segment_duration=duration, sample_rate=SR,
                      device="cuda")
        windows, _, _ = quiet(plain.segment_audio, quiet(plain.load_audio, recording))
        want = plain.predict_window_probs(windows)
        zero_counts()
        meshed = quiet(AnalyzerEngine, trained, segment_duration=duration, sample_rate=SR,
                       devices=["cuda"])
        got = meshed.predict_window_probs(windows)
        torch.cuda.synchronize()
        read_epilogue(f"phase 22 analyzer on a mesh at {duration:g} s")
        err = float(np.abs(got - want).max())
        print(f"phase 22: analyzer on a 1-device mesh at {duration:g} s windows, {len(windows)} "
              f"windows (bucket {meshed._window_bucket(len(windows))}): max|mesh - no mesh| = "
              f"{err:.3e} (tol 1e-6); launches radix8 {k8.launches}, radix16 {k16.launches}")
        check(err <= 1e-6, "the analyzer on a mesh")
        if duration < 1.0:
            check(k8.launches == 1 and k16.launches == 0, "0.5 s windows ran row 2")
            launches["analyzer"] += k8.launches
        else:
            check(k16.launches == 1 and k8.launches == 0, "1 s windows ran row 1")
            launches["inference"] += k16.launches
    print(f"phase 22: row 1 and row 2 launches over the phase's main paths {launches}")
    return launches


# phase 23: the fused epoch. ICBHI's whole-recording split cut to 294 train
# clips (9 batches of 32: 4 accumulation groups of 2 and a tail group of one
# batch) and 63 val clips (a full batch and a tail batch of 31)
P23_TRAIN, P23_VAL, P23_EPOCHS = 294, 63, 3
RADIX8_STEMS = ("log_mel_radix8dif_kernel", "log_mel_epilogue_kernel")


def p23_config(corpus: Path) -> dict:
    """config.yaml with the device cache on, over `corpus`."""
    cfg = load_config(str(REPO / "config.yaml"))
    cfg["data"].update(dataset_path=str(corpus), cache_on_device=True)
    return cfg


def p23_datasets(corpus: Path, cfg: dict) -> tuple:
    """Phase 23's train and val splits: phase 9's corpus cut to P23_TRAIN /
    P23_VAL clips."""
    train = quiet(ICBHIDataset, corpus, "train", cfg, augment=True)
    val = quiet(ICBHIDataset, corpus, "val", cfg)
    train.data, val.data = train.data[:P23_TRAIN], val.data[:P23_VAL]
    return train, val


def train_epochs(trainer: Trainer) -> tuple[dict, list]:
    """P23_EPOCHS epochs of train_epoch and validate, the scheduler stepped
    on the val loss: the history and each epoch's (train, validate) ms."""
    hist = {"train_loss": [], "val_loss": [], "train_acc": [], "val_acc": []}
    times = []
    for epoch in range(P23_EPOCHS):
        t0 = time.perf_counter()
        tl, ta = trainer.train_epoch(epoch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        vl, va = trainer.validate(epoch)
        torch.cuda.synchronize()
        times.append(((t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3))
        trainer.scheduler.step(vl)
        for k, v in zip(hist, (tl, vl, ta, va)):
            hist[k].append(v)
    return hist, times


class HeldClips:
    """A dataset over clips already in memory, as the loaders read one."""

    def __init__(self, clips: np.ndarray, labels: np.ndarray):
        self.clips, self.labels = clips, labels.astype(np.int32)
        self.target_length = clips.shape[-1]

    def __len__(self):
        return len(self.labels)

    def __getitem__(self, i):
        return self.clips[i], int(self.labels[i])


def host_calls(fn, steps: int) -> dict[str, float]:
    """CUDA calls on the host a step (cuda* and cu*), by name, that put
    work on the card (kernel and graph launches, copies, fills), from the
    profiler's host records around `steps` steps' worth of fn()."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.count / steps for e in prof.key_averages()
            if e.device_type == DeviceType.CPU and e.key.startswith("cu")
            and any(w in e.key for w in ("Launch", "Memcpy", "Memset"))}


def device_records(fn, steps: int) -> dict[str, float]:
    """The profiler's device records a step, by kind: kernels, copies and
    fills (what phase 10 summed as "kernel launches a step")."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kinds = {"kernels": 0, "copies": 0, "fills": 0}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False) \
                or e.key.startswith("Optimizer."):
            continue
        kind = "copies" if e.key.startswith("Memcpy") else "fills" if e.key.startswith(
            "Memset") else "kernels"
        kinds[kind] += e.count / steps
    return kinds


def radix8_nodes(graph: torch.cuda.CUDAGraph) -> tuple[int, dict[str, int]]:
    """A captured graph's kernel nodes, and how many are the radix-8
    spectrum kernel and the epilogue."""
    nodes = list_graph_nodes(graph)
    return (sum(kind == "kernel" for kind, _ in nodes),
            {stem: sum(1 for _, name in nodes if name and stem in name) for stem in RADIX8_STEMS})


def phase23_fused_epoch(dev, rng, card: str, tmp: Path, corpus: Path,
                        sgd: dict) -> dict[str, int]:
    """The device-resident cache and the fused multi-step epoch on the card,
    the launch counts zeroed before and read after each main-path run (a
    replayed graph adds its row-1 launches at each replay):
    (a) phase 8's lr-1 SGD step (config.yaml, 2 x 8 x 8 s, fp32) through
    `train_many` on a cache of its clips, the capture's eager warm-up,
    against phase 8's steps on the card and the CPU by its `step_floor`;
    then a second step at lr 1, a replay of that capture, and a third at lr
    0.5, a re-capture (SGD's graph holds its rate) and its replay, each
    against an eager step on the card from the same state by that bound;
    (b) `Trainer` at config.yaml (bf16, Adam, augmentation and dropout on)
    with `data.cache_on_device` at steps_per_dispatch 1 (per step, on the
    cache) and 0 (the whole epoch a call), three epochs each on phase 9's
    corpus cut to 294 / 63 clips: the fused histories within rtol 1e-4 of
    the per-step one; each epoch's wall time; the train graph's nodes
    (the masked row-1 kernel and the epilogue once) and the eval graph's
    (the inference form, 128 rows); (c) the cache's MB, its one-time decode
    and its upload; host calls a step, per step and fused; the device
    records of an eager step (kernels, copies, fills); the graphed step's
    and eval group's device ms (replays back to back); the step by CUDA
    events per step and fused. Returns row 1's launches ("inference",
    "masked"), and for phase 26 the fused run's history ("history") and
    its train graph's nodes by kind ("train_nodes")."""
    import copy

    k16 = mel_kernels.log_mel_radix16dif_fused
    launches = {"inference": 0, "masked": 0}

    # (a) phase 8's lr-1 SGD step through train_many: the first call's step
    # is the capture's eager warm-up, the second a replay, the third (a new
    # rate, which SGD's graph bakes in) a re-capture's replay
    a, b = 2, 8
    clips = sgd["wavs"].reshape(a * b, -1).numpy()
    labels = sgd["labels"].reshape(-1).numpy()
    loader = DeviceCachedLoader(HeldClips(clips, labels), b, device=dev)
    check(loader.cache.dtype == torch.float32, "float clips off the PCM16 grid stay float32")
    cw = sgd["cw"].to(dev)

    def sgd_model(state=None):
        model = LightweightCNN()
        model.load_state_dict(sgd["init"] if state is None else state[0])
        model.to(dev).set_dropout(0.0)
        opt = build_optimizer("sgd", model.named_parameters(), 1e-4)
        if state is not None:
            opt.load_state_dict(copy.deepcopy(state[1]))
        return model, opt

    model, opt = sgd_model()
    fns = make_step_fns(model, sgd["fe"], opt, accum_steps=a)
    zero_counts()
    steps = []  # (lr, state before, metrics, params after, captures, graph, replays so far)
    for lr in (1.0, 1.0, 0.5):
        before = ({k: v.detach().clone() for k, v in model.state_dict().items()},
                  copy.deepcopy(opt.state_dict()))
        m = fns.train_many(loader.cache, np.arange(a * b).reshape(1, a, b),
                           labels.reshape(1, a, b), cw, lr, 0, 0)
        graph = fns.train_many.graphs["train"]
        steps.append((lr, before, {k: float(v[0]) for k, v in m.items()}, param_arrays(model),
                      graph_count("captures", "train"), graph,
                      graph_count("replays", "train")))
    torch.cuda.synchronize()
    read_epilogue("phase 23 SGD steps")
    counts = (k16.launches, k16.launches_masked)
    per_replay = {f"{fn.__name__}.{attr}": n for (fn, attr), n in steps[0][5].kernel_launches.items()}
    print(f"phase 23: three lr-1/1/0.5 SGD steps through train_many: row-1 launches {counts[0]} "
          f"(the warm-up step's and two replays'), a replay's counted launches {per_replay}; "
          f"train captures after each call {[st[4] for st in steps]}, train replays "
          f"{[st[6] for st in steps]}")
    check(counts == (3, 0) and per_replay == {"log_mel_radix16dif_fused.launches": 1,
                                              "log_mel_epilogue.launches": 1},
          "the captured SGD step holds row 1 once, counted per replay")
    check([st[4] for st in steps] == [1, 1, 2]
          and steps[1][5] is steps[0][5] and steps[2][5] is not steps[0][5]
          and [st[6] for st in steps] == [0, 1, 2],
          "SGD: warm-up step, a replay, a re-capture at the new rate and its replay")
    launches["inference"] += counts[0]
    lr, _, m, got, *_ = steps[0]
    vs_card = step_margins((got, m["grad_norm"]), sgd["card"], sgd["floor"])
    vs_cpu = step_margins((got, m["grad_norm"]), sgd["cpu"], sgd["floor"])
    loss_err = abs(m["loss"] - sgd["card_loss"]) / abs(sgd["card_loss"])
    print(f"phase 23: the warm-up step: loss {m['loss']:.6f} (rel {loss_err:.2e} from phase 8's "
          f"eager step, tol 1e-5); params worst |d| over phase 8's bound {vs_card.params:.3f} "
          f"against the card's eager step, {vs_cpu.params:.3f} against the CPU's; grad norm "
          f"{vs_card.grad_norm:.3f} / {vs_cpu.grad_norm:.3f}")
    check(loss_err <= 1e-5, "warm-up step loss")
    check(vs_card.ok and vs_cpu.ok, f"warm-up step params ({vs_card}; {vs_cpu})")
    for what, (lr, before, m, got, *_) in (("replay", steps[1]), ("re-capture's replay",
                                                                  steps[2])):
        ref_model, ref_opt = sgd_model(before)
        ref = make_step_fns(ref_model, sgd["fe"], ref_opt, accum_steps=a).train_step(
            sgd["wavs"].to(dev), sgd["labels"].to(dev), cw, lr)
        ref_loss = float(ref["loss"])
        margins = step_margins((got, m["grad_norm"]),
                               (param_arrays(ref_model), float(ref["grad_norm"])), sgd["floor"])
        loss_err = abs(m["loss"] - ref_loss) / abs(ref_loss)
        print(f"phase 23: the {what} at lr {lr:g}: loss {m['loss']:.6f} (rel {loss_err:.2e} from "
              f"an eager step from the same state, tol 1e-5); params worst |d| over phase 8's "
              f"bound {margins.params:.3f}, grad norm {margins.grad_norm:.3f}")
        check(loss_err <= 1e-5, f"SGD {what} loss")
        check(margins.ok, f"SGD {what} params ({margins})")

    # (b) the Trainer on the cache: per step, and fused
    cfg = p23_config(corpus)

    def datasets():
        return p23_datasets(corpus, cfg)

    runs = {}
    for spd in (1, 0):
        run_cfg = copy.deepcopy(cfg)
        run_cfg["training"].update(steps_per_dispatch=spd,
                                   checkpoint_dir=str(tmp / f"p23_{spd}" / "ckpt"),
                                   log_dir=str(tmp / f"p23_{spd}" / "runs"))
        zero_counts()
        t0 = time.perf_counter()
        trainer = quiet(Trainer, build_model(run_cfg), *datasets(), run_cfg, device="cuda")
        build_s = time.perf_counter() - t0
        check(isinstance(trainer.train_loader, DeviceCachedLoader)
              and trainer._use_multi_dispatch() == (spd != 1)
              and trainer._use_fused_eval() == (spd != 1), f"steps_per_dispatch {spd}'s path")
        hist, times = train_epochs(trainer)
        read_epilogue(f"phase 23 trainer at steps_per_dispatch {spd}")
        counts = (k16.launches, k16.launches_masked)
        check(counts[0] > 0 and counts[1] > 0 and all(
            fn.launches + fn.launches_masked == 0 for name, fn in mel_kernels.WRAPPERS.items()
            if name != "radix16dif_fused"), f"steps_per_dispatch {spd} ran row 1, both forms")
        launches["inference"] += counts[0]
        launches["masked"] += counts[1]
        caps = {kind: graph_count("captures", kind) for kind in ("train", "eval")}
        if spd != 1:  # Adam reads its rate from the device: one capture of each for all epochs
            check(caps == {"train": 1, "eval": 1},
                  f"steps_per_dispatch {spd}: the step and the eval group captured once ({caps})")
        runs[spd] = dict(trainer=trainer, hist=hist, times=times, counts=counts, build_s=build_s)
        print(f"phase 23: [{card}] Trainer at config.yaml, cache on, steps_per_dispatch {spd} "
              f"({'per step' if spd == 1 else 'fused'}), {P23_EPOCHS} epochs of "
              f"{len(trainer.train_dataset)} / {len(trainer.val_dataset)} clips: train + "
              f"validate ms by epoch " + ", ".join(f"{t:.1f} + {v:.1f}" for t, v in times)
              + f"; built in {build_s:.2f} s (the caches decoded); warm-up + capture "
              + capture_ms()
              + f"; history {json.dumps(hist)}; row-1 launches {counts[0]} (validation), "
              f"{counts[1]} masked (training)")
    for spd in (0,):
        err = max(abs(x - y) / abs(y) for k in ("train_loss", "val_loss")
                  for x, y in zip(runs[spd]["hist"][k], runs[1]["hist"][k]))
        print(f"phase 23: steps_per_dispatch {spd} against per step: losses max rel {err:.2e} "
              f"(tol 1e-4)")
        check(err <= 1e-4, f"fused losses at steps_per_dispatch {spd}")

    fused = runs[0]["trainer"]
    train_graph = fused.steps.train_many.graphs["train"]
    eval_graph = fused.steps.eval_many.graphs["eval"]
    for what, graph, form in (("train", train_graph, "launches_masked"),
                              ("eval", eval_graph, "launches")):
        kernels, found = radix8_nodes(graph.graph)
        counted = {f"{fn.__name__}.{attr}": n for (fn, attr), n in graph.kernel_launches.items()}
        print(f"phase 23: the {what} graph ({tuple(graph.static[0].shape)} rows in): "
              f"{kernels} kernel nodes, {found}; counted a replay {counted}; replays over the "
              f"{P23_EPOCHS} epochs {graph_count('replays', what)}")
        check(all(n == 1 for n in found.values()), f"the {what} graph holds row 1 once")
        check(counted == {f"log_mel_radix16dif_fused.{form}": 1, "log_mel_epilogue.launches": 1},
              f"the {what} graph's row-1 form counted once a replay")

    # (c) the numbers
    tl_ = fused.train_loader
    mb = (tl_.nbytes + fused.val_loader.nbytes) / 1e6
    host = tl_.cache.cpu().numpy()
    up = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.from_numpy(host).to(dev)
        torch.cuda.synchronize()
        up.append((time.perf_counter() - t0) * 1e3)
    native.ROWS.reset()
    t0 = time.perf_counter()
    quiet(DeviceCachedLoader, datasets()[0], 32, device=dev)
    decode_ms = (time.perf_counter() - t0) * 1e3
    print(f"phase 23: [{card}] device cache: {mb:.1f} MB ({tl_.cache.dtype}; train "
          f"{tuple(tl_.cache.shape)}); train split's upload {np.median(up):.2f} ms "
          f"({tl_.nbytes / 1e6:.1f} MB, pageable); its construction (decode, round-trip check, "
          f"upload) {decode_ms:.1f} ms ({decoders()})")

    idxs = tl_.epoch_index_batches()[:8].reshape(4, 2, 32)
    lbls = tl_.labels_all[idxs]
    cw = fused.class_weights
    lr = float(fused.scheduler.lr)

    def fused_steps():
        return fused.steps.train_many(tl_.cache, idxs, lbls, cw, lr, 9, 0)

    fused_steps()
    calls = host_calls(fused_steps, 4)
    fused_ms = cuda_ms(fused_steps, iters=3, warmup=1) / 4
    per = runs[1]["trainer"]
    wavs = tl_.gather(idxs[0])
    labels_t = torch.from_numpy(lbls[0]).long().to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def eager_step():
        return per.steps.train_step(wavs, labels_t, cw, lr, generator=gen)

    def twice(fn):
        return lambda: (fn(), fn())

    eager_ms = cuda_ms(eager_step, iters=10, warmup=3)
    eager_calls = host_calls(twice(eager_step), 2)
    # phases 10 and 22's step (Adam not capturable, no cache): 567 launches
    # a step by the one, 504 by the other
    plain_model = build_model(cfg, generator=torch.Generator().manual_seed(0)).to(dev)
    plain = make_step_fns(plain_model, fused.frontend,
                          build_optimizer("adam", plain_model.named_parameters(), 1e-4),
                          accum_steps=2, augment=True)

    def plain_step():
        return plain.train_step(wavs, labels_t, cw, lr, generator=gen)

    plain_step()
    counted = {"plain adam": (host_calls(twice(plain_step), 2),
                              device_records(twice(plain_step), 2)),
               "capturable adam": (eager_calls, device_records(twice(eager_step), 2))}
    for what, (by_host, records) in counted.items():
        print(f"phase 23: [{card}] one eager train step at config.yaml, {what}: host calls "
              f"{json.dumps({k: round(v, 1) for k, v in by_host.items()})}; device records "
              f"(the profiler) {json.dumps(records)}, {sum(records.values()):.0f} in all")
    graph_step_ms = cuda_ms(train_graph.graph.replay, iters=10, warmup=2)
    graph_eval_ms = cuda_ms(eval_graph.graph.replay, iters=10, warmup=2)
    print(f"phase 23: [{card}] host calls a step: per step {sum(eager_calls.values()):.0f} "
          f"{json.dumps({k: round(v, 1) for k, v in eager_calls.items()})}; fused "
          f"{sum(calls.values()):.1f} {json.dumps({k: round(v, 2) for k, v in calls.items()})}")
    print(f"phase 23: [{card}] train step at config.yaml (32 x 2 x 8 s, bf16, capturable adam, "
          f"augmentation on) by CUDA events back to back: per step {eager_ms:.3f} ms, fused "
          f"{fused_ms:.3f} ms a step; the graphed step alone (replays back to back) "
          f"{graph_step_ms:.3f} ms; an eval group of {tuple(eval_graph.static[0].shape)[1:]} "
          f"batches x rows as a graph {graph_eval_ms:.3f} ms")
    print(f"phase 23: row 1 and the epilogue over the phase's main paths {launches}")
    return launches | {"history": runs[0]["hist"],
                       "train_nodes": node_kinds(list_graph_nodes(train_graph.graph))}


def resample_tolerance(x: torch.Tensor, orig: int, new: int) -> float:
    """An a-priori bound on |resample(x) in f32 - the same polyphase sum in
    exact arithmetic|: each output sums K products of x with one phase's
    taps, so its f32 rounding is at most γ_K·max|x|·max_p Σ_k |h_pk|, with
    γ_K = K·u / (1 − K·u), u = 2^-24 (Higham's bound, any summation order).
    A TF32 product (operands rounded to 2^-11) can stay inside it on noise,
    so full f32 is checked apart: the call with TF32 on equals the call with
    it off, bit for bit."""
    g = math.gcd(orig, new)
    kernel, _ = _resample_kernel(orig // g, new // g, 6, 0.99)
    k, u = kernel.shape[-1], 2.0 ** -24
    return k * u / (1 - k * u) * float(x.abs().max()) * float(np.abs(kernel).sum(-1).max())


def numpy_codec_row(path: str, sample_rate: int, length: int) -> np.ndarray:
    """One dataset row by the numpy codec alone: decode, resample where the
    file's rate differs, pad or crop."""
    mono, sr = decode_mono_numpy(path)
    if sr != sample_rate:
        mono = resample_np(mono, sr, sample_rate)
    return pad_or_crop(mono, length).astype(np.float32)


def phase24_host_and_reports(dev, rng, card: str, tmp: Path, corpus: Path) -> dict[str, int]:
    """(a) the native wav decoder: its build, `ICBHIDataset.load_batch` on
    phase 9's 16 kHz corpus against the numpy codec bit for bit with the
    row counters, the corpus fixture's 4 / 10 / 44.1 kHz recordings on the
    per-row path, host ms of each decoder and of the 10-minute recording's
    `load_audio`; (b) `ops/resample.resample` on the card at 44.1 / 4 / 10
    kHz -> 16 kHz, TF32 switched on around the call, against the same
    polyphase sum in float64; (c) `phase_vocoder` at 2048/512 on 15 s,
    rates 0.8 and 1.25, against itself in float64 within `phase_bound`;
    (d) `diagnose_data --no-plots` on phase 9's and phase 21's corpora;
    (e) `confusion_matrix generate --no-plots` on phase 9's checkpoint
    against a Validator pass on the card. Returns row 1's inference
    launches on (d) and (e)."""
    start = time.perf_counter()
    launches = {"inference": 0}
    cfg = load_config(str(REPO / "config.yaml"))

    # (a) the native decoder
    check(native.available(), "the native decoder built and loaded")
    t0 = time.perf_counter()
    subprocess.run([native.compiler(), *native.CXX_FLAGS, "-o", str(tmp / "fastwav24.so"),
                    str(native.SRC)], check=True, capture_output=True, timeout=300)
    print(f"phase 24: [{card}] native decoder available, {native.build().name}; a fresh "
          f"{native.compiler()} build of {native.SRC.name}: {time.perf_counter() - t0:.2f} s")
    for what, root, other_rates in (
            ("phase 9's corpus, 16 kHz", corpus, False),
            ("phase 21's corpus fixture, 4 / 10 / 44.1 kHz", tmp / "icbhi_raw", True)):
        ds = quiet(ICBHIDataset, root, "train", cfg)
        idxs = np.arange(len(ds))
        native.ROWS.reset()
        t0 = time.perf_counter()
        wavs, _ = ds.load_batch(idxs)
        native_ms = (time.perf_counter() - t0) * 1e3
        rows = native.ROWS.as_dict()
        t0 = time.perf_counter()
        plain = np.stack([numpy_codec_row(p, ds.sample_rate, ds.target_length)
                          for p, _ in ds.data])
        numpy_ms = (time.perf_counter() - t0) * 1e3
        srs = native.decode_batch([p for p, _ in ds.data], 1)[1]
        rates = sorted(set(srs.tolist()))
        print(f"phase 24: [{card}] load_batch of the train split of {what} ({len(ds)} rows "
              f"of {ds.duration:g} s, file rates {rates}): native {native_ms:.1f} ms "
              f"(4 threads), numpy codec {numpy_ms:.1f} ms; rows {json.dumps(rows)}; "
              f"equal bit for bit: {np.array_equal(wavs, plain)}")
        check(np.array_equal(wavs, plain), f"load_batch on {what}: native == numpy codec")
        per_row = int(np.sum(srs != ds.sample_rate))
        check(per_row == (len(ds) if other_rates else 0), f"{what}: the files' rates")
        check(rows == {"native": len(ds), "numpy": 0, "per_row": per_row},
              f"{what}: every row decoded natively, the other rates on the per-row path")
    long_path = tmp / "ten_minutes.wav"
    times = {}
    for name, load in (("native", lambda: wavio.load_audio(long_path, SR)[0]),
                       ("numpy codec", lambda: decode_mono_numpy(long_path)[0])):
        native.ROWS.reset()
        out, ms = [], []
        for _ in range(5):
            t0 = time.perf_counter()
            out.append(load())
            ms.append((time.perf_counter() - t0) * 1e3)
        times[name] = (float(np.median(ms)), out[0], native.ROWS.as_dict())
    check(np.array_equal(times["native"][1], times["numpy codec"][1]),
          "the 10-minute recording: native == numpy codec")
    check(times["native"][2]["native"] == 5, "load_audio decoded the recording natively")
    print(f"phase 24: [{card}] the 10-minute recording (16 kHz PCM16): load_audio, native, "
          f"median {times['native'][0]:.2f} ms; the numpy codec {times['numpy codec'][0]:.2f} ms")

    # (b) resample on the card, full f32 with TF32 switched on around it
    for orig in (44100, 4000, 10000):
        host = synth_clips(rng, 8, 15 * orig)
        x = torch.from_numpy(host).to(dev)
        switches = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        try:
            got = resample(x, orig, SR)
            kernel_ms = cuda_ms(lambda: resample(x, orig, SR), iters=20)
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = switches
        tf32_off = resample(x, orig, SR)
        want = resample(x.double(), orig, SR)
        # what the same conv gives where TF32 may run: the call without its guard
        switches = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        guard, resample_mod._full_f32 = resample_mod._full_f32, contextlib.nullcontext
        try:
            unguarded = resample(x, orig, SR)
        finally:
            resample_mod._full_f32 = guard
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = switches
        unguarded_err = (unguarded.double() - want).abs().max().item()
        err = (got.double() - want).abs().max().item()
        tol = resample_tolerance(x, orig, SR)
        t0 = time.perf_counter()
        on_host = resample_np(host, orig, SR)
        host_ms = (time.perf_counter() - t0) * 1e3
        host_err = float(np.abs(on_host - want.cpu().numpy()).max())
        print(f"phase 24: [{card}] resample 8 x 15 s {orig} -> {SR} Hz, TF32 on around the "
              f"call: max|card - f64| = {err:.3e} (tol {tol:.3e}, margin {tol / max(err, 1e-30):.1f}x); "
              f"equal to the call with TF32 off: {torch.equal(got, tf32_off)} (without the "
              f"guard, TF32 on: {unguarded_err:.3e}); CUDA events "
              f"{kernel_ms:.4f} ms; wavio.resample_np on the host {host_ms:.1f} ms "
              f"(max|host - f64| {host_err:.3e})")
        check(got.shape == (8, 15 * SR) and err <= tol, f"resample at {orig} Hz vs float64")
        check(torch.equal(got, tf32_off), f"resample at {orig} Hz holds f32 with TF32 on")

    # (c) the phase vocoder against itself in float64
    spec = stft_complex(torch.from_numpy(synth_clips(rng, 1, 15 * SR)[0]).to(dev), N_FFT, HOP)
    for rate in (0.8, 1.25):
        out = phase_vocoder(spec, rate, HOP)
        ref = phase_vocoder(spec.to(torch.complex128), rate, HOP)
        peak = ref.abs().max()
        mag = ((out.abs().double() - ref.abs()).abs().max() / peak).item()
        bound = torch.from_numpy(phase_bound(spec.shape[-2], out.shape[-1], HOP, N_FFT)).to(dev)
        seen = ref.abs() > 1e-3 * peak
        dphi = torch.angle(out.to(torch.complex128) * ref.conj()).abs()
        ratio = (dphi / bound)[seen].max().item()
        ms = cuda_ms(lambda: phase_vocoder(spec, rate, HOP), iters=10)
        top = HOP * 2 * np.pi * (N_FFT // 2) / N_FFT * out.shape[-1]
        print(f"phase 24: [{card}] phase_vocoder {tuple(spec.shape)} -> {tuple(out.shape)} at "
              f"rate {rate}: max magnitude error {mag:.3e} of the peak (tol 1e-6); the top "
              f"bin's phase reaches {top:.3e} rad; max |phase error| {dphi[seen].max().item():.3e} "
              f"rad, at most {ratio:.3f} of phase_bound (max {bound.max().item():.3e} rad, margin "
              f"{1 / ratio:.1f}x); {ms:.4f} ms by CUDA events")
        check(mag <= 1e-6 and ratio <= 1.0, f"phase_vocoder at rate {rate} vs float64")

    # (d) diagnose_data on both corpora, (e) the confusion-matrix report
    k16 = mel_kernels.log_mel_radix16dif_fused
    for what, argv in (
            ("phase 9's corpus at config.yaml", ["--config", str(REPO / "config.yaml"),
                                                  "--data-path", str(corpus)]),
            ("phase 21's segmented corpus at config_segmented.yaml",
             ["--config", str(REPO / "config_segmented.yaml"), "--segmented",
              "--data-path", str(tmp / "icbhi_segmented")])):
        zero_counts()
        t0 = time.perf_counter()
        got = quiet(diagnose_data.main, argv + ["--no-plots"])
        torch.cuda.synchronize()
        read_epilogue(f"phase 24 diagnose_data on {what}")
        launches["inference"] += k16.launches
        print(f"phase 24: [{card}] diagnose_data --no-plots on {what}: {got['size']} clips, "
              f"classes {got['counts'].tolist()} (imbalance flag {got['imbalanced']}), "
              f"{len(got['samples'])} mels finite {all(s['finite'] for s in got['samples'])}, "
              f"initial loss {got['loss']:.4f} (ln 4 = {math.log(4):.4f}), "
              f"{(time.perf_counter() - t0) * 1e3:.1f} ms; row-1 launches {k16.launches}")
        check(k16.launches > 0, f"diagnose_data on {what} ran row 1")
        check(all(s["finite"] for s in got["samples"]) and math.isfinite(got["loss"])
              and abs(got["loss"] - math.log(4)) <= 1.0, f"diagnose_data on {what}")

    best = tmp / "run" / "checkpoints" / "best_model.ckpt"
    out_dir = tmp / "cm24"
    zero_counts()
    quiet(cm_entry.main, ["generate", "--model", str(best), "--split", "val", "--data-path",
                          str(corpus), "--output-dir", str(out_dir), "--no-plots"])
    torch.cuda.synchronize()
    read_epilogue("phase 24 confusion_matrix")
    entry_launches = k16.launches
    launches["inference"] += entry_launches
    check(entry_launches > 0, "confusion_matrix ran row 1")
    engine = ClassifierEngine(best, device="cuda")
    val = quiet(ICBHIDataset, corpus, "val", engine.config)
    y_true, y_pred, _ = quiet(Validator(engine.model, val, engine.config, device=dev).validate)
    want = metrics_confusion_matrix(y_true, y_pred, range(4))
    got = np.load(out_dir / "confusion_matrix_val.npy")
    files = sorted(p.name for p in out_dir.iterdir())
    print(f"phase 24: [{card}] confusion_matrix generate --no-plots on phase 9's checkpoint, "
          f"val split ({len(val)} clips): {got.tolist()}, equal to a Validator pass on the "
          f"card: {np.array_equal(got, want)}; files {files}; row-1 launches {entry_launches}")
    check(np.array_equal(got, want) and files == ["confusion_matrix_val.csv",
                                                  "confusion_matrix_val.npy"],
          "confusion_matrix's NPY equals the Validator's counts")
    print(f"phase 24: {time.perf_counter() - start:.1f} s")
    return launches


def orbax_record(tree: dict, prefix: str = "") -> dict:
    """Each leaf of a loaded checkpoint by its joined key path: an array's
    dtype, shape, sha256 and sum, any other value as it is. The record
    beside the committed fixture (`tests/data/orbax_jax_fixture.json`)."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(orbax_record(v, name + "/"))
        elif isinstance(v, torch.Tensor):  # bfloat16, which numpy lacks
            out[name] = {"dtype": "bfloat16", "shape": list(v.shape),
                         "sha256": hashlib.sha256(v.view(torch.int16).numpy().tobytes()).hexdigest(),
                         "sum": v.float().sum().item()}
        elif isinstance(v, np.ndarray):
            out[name] = {"dtype": str(v.dtype), "shape": list(v.shape),
                         "sha256": hashlib.sha256(v.tobytes()).hexdigest(),
                         "sum": float(np.asarray(v, np.float64).sum())}
        else:
            out[name] = v
    return out


def same_leaves(a, b) -> bool:
    """Two loaded checkpoints hold the same keys, dtypes and bytes."""
    if isinstance(a, dict):
        return isinstance(b, dict) and set(a) == set(b) and all(same_leaves(a[k], b[k]) for k in a)
    if isinstance(a, (np.ndarray, torch.Tensor)):
        return isinstance(b, type(a)) and orbax_record({"x": a}) == orbax_record({"x": b})
    return a == b


def disk_mb(path: Path) -> float:
    files = [path] if path.is_file() else [f for f in path.rglob("*") if f.is_file()]
    return sum(f.stat().st_size for f in files) / 1e6


def adam_payload(architecture: str) -> dict:
    """The trainer's payload of a seeded `architecture` at config.yaml after
    one Adam step: flax-form weights and optax-form moments."""
    cfg = load_config(str(REPO / "config.yaml"))
    cfg["model"]["architecture"] = architecture
    model = build_model(cfg, dtype=torch.float32, generator=set_seed(cfg["seed"]))
    opt = build_optimizer("adam", model.named_parameters())
    gen = torch.Generator().manual_seed(1)
    for p in model.parameters():
        p.grad = 1e-3 * torch.randn(p.shape, generator=gen)
    opt.param_groups[0]["lr"] = 1e-3
    opt.step()
    return {"epoch": 0, **flax_from_state_dict(model.state_dict()),
            "opt_state": optax_from_opt_state(opt, "adam"), "val_loss": 1.0, "config": cfg,
            "class_weights": np.ones(4, np.float32), "best_metric": 1.0, "patience_counter": 0}


def phase25_orbax(dev, rng, card: str, tmp: Path, corpus: Path) -> dict[str, int]:
    """Orbax checkpoint directories on the card's machine (the module
    docstring's phase 25). Returns row 1's launches by form."""
    import yaml

    start = time.perf_counter()
    k16 = mel_kernels.log_mel_radix16dif_fused

    # (a) the decoder's library, and a fresh build of it timed
    t0 = time.perf_counter()
    subprocess.run([native.compiler(), *native.CXX_FLAGS, "-o", str(tmp / "zstd25.so"),
                    str(native.ZSTD_SRC)], check=True, capture_output=True, timeout=300)
    build_s = time.perf_counter() - t0
    native.zstd_decompress(orbax_format.zstd_raw_frame(b"orbax"), 5)
    print(f"phase 25: [{card}] zstd decoder {native.build(native.ZSTD_SRC).name}; a fresh "
          f"{native.compiler()} build of {native.ZSTD_SRC.name}: {build_s:.2f} s")

    # (b) the JAX-written fixture
    t0 = time.perf_counter()
    got = load_checkpoint(ORBAX_FIXTURE)
    fixture_ms = (time.perf_counter() - t0) * 1e3
    want = json.loads(ORBAX_FIXTURE.with_suffix(".json").read_text())
    ok = orbax_record(got) == want
    print(f"phase 25: [{card}] the JAX-written fixture ({disk_mb(ORBAX_FIXTURE) * 1e3:.1f} kB, "
          f"{len(want)} leaves) decoded in {fixture_ms:.1f} ms; equal to its record: {ok}")
    check(ok, "the orbax fixture decodes to its recorded values")

    # (c) one epoch writing orbax directories, resumed from one
    cfg = load_config(str(REPO / "config.yaml"))
    cfg["training"].update(checkpoint_format="orbax", async_checkpoint=True)
    work = tmp / "run25"
    work.mkdir()
    (work / "orbax.yaml").write_text(yaml.safe_dump(cfg))
    cwd = os.getcwd()
    os.chdir(work)
    try:
        zero_counts()
        t0 = time.perf_counter()
        history = quiet(train_entry.main, ["--config", "orbax.yaml", "--data-path", str(corpus),
                                           "--epochs", "1", "--no-plots"])
        torch.cuda.synchronize()
        read_epilogue("phase 25 training")
        wall = time.perf_counter() - t0
        launches = {"masked": k16.launches_masked, "inference": k16.launches}
    finally:
        os.chdir(cwd)
    best = work / "checkpoints" / "best_model.ckpt"
    print(f"phase 25: [{card}] train.main, 1 epoch at config.yaml with checkpoint_format orbax: "
          f"{wall:.1f} s; history {json.dumps(history)}; row-1 launches {launches}; "
          f"{best.name} {sorted(p.name for p in best.iterdir())}")
    check(best.is_dir() and (best / "_CHECKPOINT_METADATA").exists()
          and (best / "state" / "manifest.ocdbt").exists(), "best_model.ckpt is an orbax directory")
    check(launches["masked"] > 0 and launches["inference"] > 0, "the orbax run trained on row 1")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + ([os.environ["PYTHONPATH"]] if os.environ.get("PYTHONPATH") else [])))
    out = subprocess.run(
        [sys.executable, "-m", "audio_classification_icbhi_tpu_torch.train", "--config",
         "orbax.yaml", "--data-path", str(corpus), "--epochs", "2", "--resume", str(best),
         "--no-plots"], cwd=work, env=env, capture_output=True, text=True, timeout=600)
    print("phase 25: resumed from the orbax directory (subprocess), last lines:\n  "
          + "\n  ".join(out.stdout.strip().splitlines()[-4:]))
    check(out.returncode == 0, f"resumed training exited {out.returncode}: {out.stderr[-2000:]}")
    check("Epoch 2/2" in out.stdout and "Resumed from" in out.stdout, "resumed to epoch 2")

    # (d) the directory served, beside a msgpack re-save of it
    ckpt = load_checkpoint(best)
    msgpack = save_checkpoint(tmp / "best25.ckpt", ckpt)
    zero_counts()
    engines = [ClassifierEngine(path, device="cuda") for path in (best, msgpack)]
    length = int(engines[0].config["data"]["duration"] * SR)
    x = torch.from_numpy(synth_clips(rng, 16, length)).to(dev)
    with torch.inference_mode():
        logits = [e.model(features_from_wavs(e.frontend, x)) for e in engines]
    torch.cuda.synchronize()
    read_epilogue("phase 25 serving")
    launches["inference"] += k16.launches
    sds = [e.model.state_dict() for e in engines]
    same_state = set(sds[0]) == set(sds[1]) and all(torch.equal(sds[0][k], sds[1][k])
                                                    for k in sds[0])
    same_logits = torch.equal(logits[0], logits[1])
    print(f"phase 25: [{card}] ClassifierEngine(device='cuda') on the orbax directory and on a "
          f"msgpack re-save: {len(sds[0])} state tensors bit-equal {same_state}; logits of 16 "
          f"seeded {length / SR:g} s clips bit-equal {same_logits} (max |logit| "
          f"{logits[0].abs().max().item():.3f}); row-1 launches {k16.launches}")
    check(same_state and same_logits, "orbax and msgpack engines agree bit for bit")
    check(k16.launches > 0 and bool(torch.isfinite(logits[0]).all()), "served on row 1")

    # (e) save and load, orbax beside msgpack, by the host clock
    for what, payload in (("LightweightCNN + Adam (phase 25's trained checkpoint)", ckpt),
                          ("CompactResNet18 + Adam (seeded, one step)", adam_payload("resnet"))):
        times, loaded = {}, {}
        for fmt in ("msgpack", "orbax"):
            path = tmp / f"timing25.{fmt}.ckpt"
            save, load = [], []
            for _ in range(3):
                t0 = time.perf_counter()
                save_checkpoint(path, payload, format=fmt)
                save.append((time.perf_counter() - t0) * 1e3)
                t0 = time.perf_counter()
                loaded[fmt] = load_checkpoint(path)
                load.append((time.perf_counter() - t0) * 1e3)
            times[fmt] = (float(np.median(save)), float(np.median(load)), disk_mb(path))
        print(f"phase 25: [{card}] {what}: " + "; ".join(
            f"{fmt} save {t[0]:.1f} ms, load {t[1]:.1f} ms, {t[2]:.2f} MB on disk"
            for fmt, t in times.items()) + " (median of 3, warm page cache)")
        check(same_leaves(loaded["orbax"], loaded["msgpack"]), f"{what}: both formats load equal")
    print(f"phase 25: {time.perf_counter() - start:.1f} s")
    return launches



# phase 26: the fused epoch on an NCCL group
COLLECTIVES_A_STEP = 24  # 2 microbatches x (Σw + 5 BatchNorms x 2) + gradients + metrics


def node_kinds(nodes: list[tuple[str, str | None]]) -> dict[str, int]:
    """A graph's nodes by type, its NCCL kernels apart ("nccl")."""
    kinds: dict[str, int] = {}
    for kind, name in nodes:
        key = "nccl" if kind == "kernel" and name and "nccl" in name.lower() else kind
        kinds[key] = kinds.get(key, 0) + 1
    return kinds


@contextlib.contextmanager
def counted_collectives():
    """Count the calls into torch.distributed's all_reduce and all_gather
    (the sharded step's, `parallel/mesh.py` and `models/cnn.py`, look them
    up at each call) while the block runs."""
    import torch.distributed as dist

    counts = {"all_reduce": 0, "all_gather": 0}
    saved = {name: getattr(dist, name) for name in counts}

    def counting(name):
        def call(*args, **kwargs):
            counts[name] += 1
            return saved[name](*args, **kwargs)
        return call

    for name in counts:
        setattr(dist, name, counting(name))
    try:
        yield counts
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


def phase26_fused_ranks(dev, card: str, tmp: Path, corpus: Path, sgd: dict,
                        p23: dict) -> dict[str, int]:
    """The fused epoch over a process group on the card, the launch counts
    zeroed before and read after each main-path run: (b) phase 8's lr-1
    SGD step (config.yaml, 2 x 8 x 8 s, fp32, dropout 0) through
    `train_many` on a world-size-1 NCCL group: the capture's eager warm-up
    step against phase 8's step without a group on the card and the CPU by
    its `step_floor`, the collectives counted in the warm-up and the
    capture, then a replay against an eager NCCL step from the same state;
    (a) `Trainer` at config.yaml (bf16, capturable Adam, augmentation and
    dropout on, the cache on) on that group for three epochs on phase 23's
    294 / 63 clips, at steps_per_dispatch 1 (per step on the cache) and 0
    (fused): the fused history within rtol 1e-4 of the per-step one, and
    within max(rtol 1e-4, twice how far phase 23's fused run moves from
    initial weights 1e-6 off) of phase 23's fused run without a group (the
    cross-rank BatchNorm rounds otherwise, and three epochs of Adam on bf16
    carry that into the losses); the graphs' nodes (the NCCL kernels in the
    train graph, none in the eval graph), captures, host calls a step, the
    graphed step's device ms; (c) `train --multihost
    --num-processes 1` at config.yaml with `data.cache_on_device: true`, one
    epoch as a subprocess printing its counts: the cache line, no
    "disabled" line, its best checkpoint served; (d) two NCCL ranks fused
    against one, where two GPUs are visible. Returns row 1's launches
    ("inference", "masked")."""
    import copy

    import yaml

    k16 = mel_kernels.log_mel_radix16dif_fused
    launches = {"inference": 0, "masked": 0}
    start = time.perf_counter()
    nccl = tuple(torch.cuda.nccl.version())
    print(f"phase 26: NCCL {'.'.join(map(str, nccl))} (collectives under graph capture need "
          f">= 2.9.6); torch {torch.__version__}")
    check(nccl[:3] >= (2, 9, 6), "NCCL can be captured")

    init_distributed(f"127.0.0.1:{free_port()}", 1, 0, device=dev)
    try:
        mesh = get_mesh(device=dev)
        check(mesh.group is not None and mesh.world_size == 1 and mesh.hosts == 1
              and mesh.device.type == "cuda", "a world-size-1 NCCL mesh on one machine")

        # (b) phase 8's SGD step through train_many on the group: the warm-up
        # step, then a replay of the captured step with its collectives
        a, b = 2, 8
        clips = sgd["wavs"].reshape(a * b, -1).numpy()
        labels = sgd["labels"].reshape(-1).numpy()
        loader = DeviceCachedLoader(HeldClips(clips, labels), b, device=dev)
        cw = sgd["cw"].to(dev)

        def sgd_model(state=None):
            model = LightweightCNN(axis_name=mesh.group)
            model.load_state_dict(sgd["init"] if state is None else state[0])
            model.to(dev).set_dropout(0.0)
            opt = build_optimizer("sgd", model.named_parameters(), 1e-4)
            if state is not None:
                opt.load_state_dict(copy.deepcopy(state[1]))
            return model, opt

        model, opt = sgd_model()
        fns = make_step_fns(model, sgd["fe"], opt, accum_steps=a, mesh=mesh)
        zero_counts()
        steps = []  # (state before, metrics, params after)
        for i in range(2):
            before = ({k: v.detach().clone() for k, v in model.state_dict().items()},
                      copy.deepcopy(opt.state_dict()))
            with counted_collectives() as called:
                m = fns.train_many(loader.cache, np.arange(a * b).reshape(1, a, b),
                                   labels.reshape(1, a, b), cw, 1.0, 0, 0)
            torch.cuda.synchronize()
            steps.append((before, {k: float(v[0]) for k, v in m.items()}, param_arrays(model),
                          dict(called)))
        read_epilogue("phase 26 SGD steps")
        graph = fns.train_many.graphs["train"]
        kinds = node_kinds(list_graph_nodes(graph.graph))
        print(f"phase 26: two lr-1 SGD steps through train_many on the NCCL group: collectives "
              f"called {steps[0][3]} in the first (the warm-up step, then the capture), "
              f"{steps[1][3]} in the second (a replay); train captures "
              f"{graph_count('captures', 'train')}, replays {graph_count('replays', 'train')}; "
              f"row-1 "
              f"launches {k16.launches}; the graph's nodes by kind {json.dumps(kinds)}")
        check(sum(steps[0][3].values()) == 2 * COLLECTIVES_A_STEP
              and sum(steps[1][3].values()) == 0,
              "the warm-up and the capture each called the step's collectives; a replay none")
        check((k16.launches, k16.launches_masked) == (2, 0)
              and graph_count("replays", "train") == 1
              and graph_count("captures", "train") == 1 and graph_count("captures", "eval") == 0,
              "the SGD steps on the group: the warm-up step and a replay")
        launches["inference"] += k16.launches
        _, m, got, _ = steps[0]
        vs_card = step_margins((got, m["grad_norm"]), sgd["card"], sgd["floor"])
        vs_cpu = step_margins((got, m["grad_norm"]), sgd["cpu"], sgd["floor"])
        loss_err = abs(m["loss"] - sgd["card_loss"]) / abs(sgd["card_loss"])
        print(f"phase 26: the warm-up step on the group: loss {m['loss']:.6f} (rel {loss_err:.2e} "
              f"from phase 8's step without a group, tol 1e-5); params worst |d| over phase 8's "
              f"bound {vs_card.params:.3f} against the card's, {vs_cpu.params:.3f} against the "
              f"CPU's; grad norm {vs_card.grad_norm:.3f} / {vs_cpu.grad_norm:.3f}")
        check(loss_err <= 1e-5, "warm-up step loss on the group")
        check(vs_card.ok and vs_cpu.ok, f"warm-up step params on the group ({vs_card}; {vs_cpu})")
        before, m, got, _ = steps[1]
        ref_model, ref_opt = sgd_model(before)
        ref = make_step_fns(ref_model, sgd["fe"], ref_opt, accum_steps=a, mesh=mesh).train_step(
            sgd["wavs"].to(dev), sgd["labels"].to(dev), cw, 1.0)
        ref_loss = float(ref["loss"])
        margins = step_margins((got, m["grad_norm"]),
                               (param_arrays(ref_model), float(ref["grad_norm"])), sgd["floor"])
        loss_err = abs(m["loss"] - ref_loss) / abs(ref_loss)
        print(f"phase 26: the replay: loss {m['loss']:.6f} (rel {loss_err:.2e} from an eager NCCL "
              f"step from the same state, tol 1e-5); params worst |d| over phase 8's bound "
              f"{margins.params:.3f}, grad norm {margins.grad_norm:.3f}")
        check(loss_err <= 1e-5, "replay loss on the group")
        check(margins.ok, f"replay params on the group ({margins})")

        # (a) the Trainer on the group, per step and fused on the cache
        runs = {}
        for spd in (1, 0):
            cfg = p23_config(corpus)
            cfg["training"].update(steps_per_dispatch=spd,
                                   checkpoint_dir=str(tmp / f"p26_{spd}" / "ckpt"),
                                   log_dir=str(tmp / f"p26_{spd}" / "runs"))
            zero_counts()
            t0 = time.perf_counter()
            trainer = quiet(Trainer, build_model(cfg, axis_name=mesh.group),
                            *p23_datasets(corpus, cfg), cfg, mesh=mesh)
            build_s = time.perf_counter() - t0
            check(isinstance(trainer.train_loader, DeviceCachedLoader)
                  and trainer._use_multi_dispatch() == trainer._use_fused_eval() == (spd != 1),
                  f"the trainer on the group, steps_per_dispatch {spd}: the cache and its path")
            hist, times = train_epochs(trainer)
            read_epilogue(f"phase 26 trainer on the group at steps_per_dispatch {spd}")
            counts = (k16.launches, k16.launches_masked)
            check(counts[0] > 0 and counts[1] > 0 and all(
                fn.launches + fn.launches_masked == 0 for name, fn in mel_kernels.WRAPPERS.items()
                if name != "radix16dif_fused"), f"steps_per_dispatch {spd} ran row 1, both forms")
            launches["inference"] += counts[0]
            launches["masked"] += counts[1]
            caps = {kind: graph_count("captures", kind) for kind in ("train", "eval")}
            check(caps == ({"train": 1, "eval": 1} if spd != 1 else {"train": 0, "eval": 0}),
                  f"steps_per_dispatch {spd}: the step and the eval group captured once ({caps})")
            runs[spd] = dict(trainer=trainer, hist=hist)
            print(f"phase 26: [{card}] Trainer at config.yaml on the world-size-1 NCCL group, "
                  f"cache on, steps_per_dispatch {spd} ({'per step' if spd == 1 else 'fused'}), "
                  f"{P23_EPOCHS} epochs of {len(trainer.train_dataset)} / "
                  f"{len(trainer.val_dataset)} clips: train + validate ms by epoch "
                  + ", ".join(f"{t:.1f} + {v:.1f}" for t, v in times)
                  + f"; built in {build_s:.2f} s; warm-up + capture " + capture_ms()
                  + f"; history {json.dumps(hist)}; row-1 launches {counts[0]} (validation), "
                  f"{counts[1]} masked (training)")
        err = max(abs(x - y) / abs(y) for k in ("train_loss", "val_loss")
                  for x, y in zip(runs[0]["hist"][k], runs[1]["hist"][k]))
        print(f"phase 26: on the group, fused against per step: losses max rel {err:.2e} "
              f"(tol 1e-4)")
        check(err <= 1e-4, "the fused epoch on the group trains as the sharded per-step path")
        hist = runs[0]["hist"]
        trainer = runs[0]["trainer"]
        train_graph = trainer.steps.train_many.graphs["train"]
        eval_graph = trainer.steps.eval_many.graphs["eval"]
        train_kinds = node_kinds(list_graph_nodes(train_graph.graph))
        eval_kinds = node_kinds(list_graph_nodes(eval_graph.graph))
        print(f"phase 26: the train graph's nodes by kind {json.dumps(train_kinds)} (without a "
              f"group, phase 23: {json.dumps(p23['train_nodes'])}); NCCL kernels in one replay "
              f"{train_kinds.get('nccl', 0)} ({COLLECTIVES_A_STEP} collectives a step at "
              f"config.yaml); the eval graph's {json.dumps(eval_kinds)}")
        check("nccl" not in eval_kinds, "the eval graph holds no collective")
        kernels, found = radix8_nodes(train_graph.graph)
        check(found == {stem: 1 for stem in RADIX8_STEMS}, "the train graph holds row 1 once")

        tl_ = trainer.train_loader
        idxs = tl_.epoch_index_batches()[:8].reshape(4, 2, 32)
        lbls = tl_.labels_all[idxs]
        lr = float(trainer.scheduler.lr)

        def fused_steps():
            return trainer.steps.train_many(tl_.cache, idxs, lbls, trainer.class_weights, lr,
                                            9, 0)

        fused_steps()
        calls = host_calls(fused_steps, 4)
        fused_ms = cuda_ms(fused_steps, iters=3, warmup=1) / 4
        graph_step_ms = cuda_ms(train_graph.graph.replay, iters=10, warmup=2)
        graph_eval_ms = cuda_ms(eval_graph.graph.replay, iters=10, warmup=2)
        print(f"phase 26: [{card}] the fused step on the NCCL group at config.yaml (32 x 2 x 8 s, "
              f"bf16, capturable adam, augmentation on): host calls a step "
              f"{sum(calls.values()):.1f} {json.dumps({k: round(v, 2) for k, v in calls.items()})}; "
              f"{fused_ms:.3f} ms a step by CUDA events back to back; the graphed step alone "
              f"(replays back to back) {graph_step_ms:.3f} ms; the eval group as a graph "
              f"{graph_eval_ms:.3f} ms; {kernels} kernel nodes in the train graph")
    finally:
        close_distributed()

    # (a) against phase 23's fused run without a group. The cross-rank
    # BatchNorm rounds otherwise than BatchNorm, and three epochs of Adam
    # on bf16 activations carry rounding into the losses (a gradient near
    # zero whose sign flips moves its weight by the whole rate), so the
    # bar is how far rounding alone moves phase 23's run: the same run with
    # its initial weights scaled by 1 + 1e-6 u (u uniform in [-1, 1], the
    # step floor's seeds 0-7), twice the largest move at each epoch, and never
    # under rtol 1e-4
    cfg = p23_config(corpus)
    moved = []
    for seed in FLOOR_SEEDS:
        cfg["training"].update(steps_per_dispatch=0,
                               checkpoint_dir=str(tmp / f"p26_floor{seed}" / "ckpt"),
                               log_dir=str(tmp / f"p26_floor{seed}" / "runs"))
        trainer = quiet(Trainer, build_model(cfg), *p23_datasets(corpus, cfg), cfg,
                        device="cuda")
        g = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for prm in trainer.model.parameters():
                prm.mul_((1.0 + 1e-6 * (2.0 * torch.rand(prm.shape, generator=g) - 1.0))
                         .to(prm.device))
        moved.append(train_epochs(trainer)[0])
    worst, rel_group, rel_moved = 0.0, 0.0, 0.0
    for k in ("train_loss", "val_loss"):
        for e, want in enumerate(p23["history"][k]):
            floor = max(abs(m[k][e] - want) for m in moved)
            worst = max(worst, abs(hist[k][e] - want) / max(1e-4 * abs(want), 2.0 * floor))
            rel_group = max(rel_group, abs(hist[k][e] - want) / abs(want))
            rel_moved = max(rel_moved, floor / abs(want))
    print(f"phase 26: against phase 23's fused run without a group "
          f"{json.dumps(p23['history'])}: the losses on the group max rel {rel_group:.2e}; "
          f"phase 23's run from weights 1e-6 off (seeds 0-7) moved by max rel {rel_moved:.2e}; "
          f"worst |d| over max(rtol 1e-4, twice that move) {worst:.3f}; histories of the "
          f"moved runs {json.dumps(moved)}")
    check(worst <= 1.0, "the fused run on the group within rounding of the run without one")

    # (c) train --multihost --num-processes 1 with the cache, served
    work = tmp / "p26_entry"
    work.mkdir()
    entry_cfg = load_config(str(REPO / "config.yaml"))
    entry_cfg["data"]["cache_on_device"] = True
    (work / "cache.yaml").write_text(yaml.safe_dump(entry_cfg))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + ([os.environ["PYTHONPATH"]] if os.environ.get("PYTHONPATH") else [])))
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-c", ENTRY_COUNTED, "audio_classification_icbhi_tpu_torch.train",
         "--config", "cache.yaml", "--data-path", str(corpus), "--epochs", "1", "--no-plots",
         "--multihost", "--coordinator", f"127.0.0.1:{free_port()}", "--num-processes", "1",
         "--process-id", "0"], cwd=work, env=env, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    check(out.returncode == 0, f"--multihost train with the cache exited {out.returncode}: "
                               f"{out.stderr[-2000:]}")
    cache_line = next((line for line in out.stdout.splitlines()
                       if line.startswith("Device cache:")), None)
    check("Distributed: process 0" in out.stdout and cache_line is not None
          and "disabled" not in out.stdout,
          "the --multihost run kept the device cache on its process group")
    counted = json.loads(out.stdout.strip().splitlines()[-1])
    row1 = counted["launches"]["radix16dif_fused"]
    others = sum(sum(v) for k, v in counted["launches"].items() if k != "radix16dif_fused")
    check(row1[0] > 0 and row1[1] > 0 and others == 0, "the cached epoch ran row 1, both forms")
    check(counted["epilogue"] == sum(row1), "the epilogue launched with each log-mel call")
    launches["inference"] += row1[0]
    launches["masked"] += row1[1]
    EPILOGUE_MAIN_PATH["launches"] += counted["epilogue"]
    best = work / "checkpoints" / "best_model.ckpt"
    engine = ClassifierEngine(best, device="cuda")
    clip, _ = ICBHIDataset(corpus, "test", engine.config)[0]
    result = engine.classify_wave(clip)
    probs = np.array(list(result["probabilities"].values()))
    print(f"phase 26: [{card}] train --multihost --num-processes 1 at config.yaml with "
          f"cache_on_device, 1 epoch (subprocess, start-up included): {wall:.1f} s; "
          f"\"{cache_line}\"; history {json.dumps(counted['history'])}; row 1 launches "
          f"{row1[0]} (validation), {row1[1]} masked (training, replays counted); its best "
          f"checkpoint served: {result['predicted_class']} {result['confidence']:.4f}")
    check(all(math.isfinite(v) for vals in counted["history"].values() for v in vals),
          "finite history")
    check(bool(np.isfinite(probs).all()) and abs(probs.sum() - 1.0) < 1e-3,
          "the cached run's checkpoint served")

    # (d) two NCCL ranks fused against one
    n_gpu = torch.cuda.device_count()
    if n_gpu >= 2:
        cfg2 = load_config(str(REPO / "config.yaml"))
        cfg2["data"].update(augmentation=False, cache_on_device=True)
        cfg2["model"].update(architecture="resnet", dropout=0.0)  # no draw depends on the rank
        cfg2["training"].update(mixed_precision=False, optimizer="sgd", learning_rate=0.01,
                                steps_per_dispatch=0)
        runs = {}
        for n in (2, 1):
            cfg2["training"].update(checkpoint_dir=str(tmp / f"p26r{n}" / "ckpt"),
                                    log_dir=str(tmp / f"p26r{n}" / "runs"))
            path = tmp / f"p26_ranks{n}.yaml"
            path.write_text(yaml.safe_dump(cfg2))
            runs[n] = quiet(train_entry.main, ["--config", str(path), "--data-path", str(corpus),
                                               "--epochs", "1", "--no-plots", "--num-devices",
                                               str(n)])
        err = max(abs(x - y) / abs(y) for k in ("train_loss", "val_loss")
                  for x, y in zip(runs[2][k], runs[1][k]))
        print(f"phase 26: [{card}] two NCCL ranks fused against one, ResNet fp32 without "
              f"dropout, cache on, one epoch: losses {runs[2]['train_loss']} / "
              f"{runs[1]['train_loss']}, max rel {err:.2e} (tol 2e-3)")
        check(err <= 2e-3, "two NCCL ranks fused against one")
    else:
        print(f"phase 26: two NCCL ranks fused against one: not run, {n_gpu} CUDA device "
              f"visible (NCCL takes one GPU a rank); 2 and 4 ranks of the fused epoch are held "
              f"on the CPU over gloo (tests/test_torch_fused_ranks.py)")
    print(f"phase 26: row 1 over the phase's main paths {launches}; "
          f"{time.perf_counter() - start:.1f} s")
    return launches


# phase 27: CompactResNet18 and the segmented config on the fused epoch

def pool_mb(graph: torch.cuda.CUDAGraph) -> float:
    """MB the caching allocator holds in a graph's private memory pool: its
    segments in `torch.cuda.memory_snapshot()`."""
    pool = tuple(graph.pool())
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == pool) / 1e6


def perturbed(model: torch.nn.Module, seed: int) -> None:
    """Every parameter scaled by 1 + 1e-6 u, u uniform in [-1, 1] from `seed`."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for prm in model.parameters():
            prm.mul_((1.0 + 1e-6 * (2.0 * torch.rand(prm.shape, generator=g) - 1.0))
                     .to(prm.device))


def hold_histories(what: str, got: dict, want: dict, moved_runs) -> str:
    """`got` (the fused run's history) against `want` (the per-step run's):
    the losses within rtol 1e-4, or, where one misses it, within max(rtol
    1e-4, twice how far the per-step run moves from initial weights 1e-6 off
    at that epoch), phase 26's rule: `moved_runs()` gives those runs'
    histories, seeds 0-7 (both rules pass the same histories: the second
    never bars what the first admits). Checks, and returns a line to print."""
    keys = ("train_loss", "val_loss")
    rel = max(abs(x - y) / abs(y) for k in keys for x, y in zip(got[k], want[k]))
    if rel <= 1e-4:
        return f"losses max rel {rel:.2e} (tol 1e-4)"
    moved = moved_runs()
    worst, rel_moved = 0.0, 0.0
    for k in keys:
        for e, w in enumerate(want[k]):
            floor = max(abs(m[k][e] - w) for m in moved)
            worst = max(worst, abs(got[k][e] - w) / max(1e-4 * abs(w), 2.0 * floor))
            rel_moved = max(rel_moved, floor / abs(w))
    check(worst <= 1.0, f"{what}: fused within rounding of per step ({worst:.3f})")
    return (f"losses max rel {rel:.2e}, over rtol 1e-4; the per-step run from weights 1e-6 "
            f"off (seeds 0-7) moves by max rel {rel_moved:.2e}; worst |d| over max(rtol "
            f"1e-4, twice that move) {worst:.3f}; moved histories {json.dumps(moved)}")


def phase27_resnet_fused(dev, card: str, tmp: Path, corpus: Path, sgd: dict) -> dict[str, int]:
    """CompactResNet18 and the segmented config on the fused epoch, the
    launch counts zeroed before and read after each main-path run: (a)
    phase 20's fp32 lr-1 SGD step of the full ResNet (config.yaml, 2 x 8 x 8
    s, dropout 0) through `train_many` on a cache of its clips: the
    capture's eager warm-up step against phase 20's step on the card and the
    CPU by its `step_floor`, then a replay against an eager step from the
    same state; (b) `Trainer` at config.yaml with `architecture: resnet`
    (bf16, capturable Adam, augmentation and the head's dropouts on, the
    cache on) for three epochs on phase 23's 294 / 63 clips, at
    steps_per_dispatch 1 (per step on the cache) and 0 (fused, each step
    and eval group a replayed graph); (c) `train_segmented` at
    config_segmented.yaml (LightweightCNN, 3 s, batch 32 x 4) and
    `train_icbhi` there with the cache on, steps_per_dispatch 1 and 0, three
    epochs on phase 21's segmented corpus. The fused histories are held to the per-step ones
    (`hold_histories`); the ResNet graphs' nodes, captures, pool MB, host
    calls a step and device ms are printed. Returns row 1's launches
    ("inference", "masked")."""
    import copy

    import yaml

    from audio_classification_icbhi_tpu_torch import train_icbhi, train_segmented
    from audio_classification_icbhi_tpu_torch.training.trainer_icbhi import TrainerWithICBHI

    k16 = mel_kernels.log_mel_radix16dif_fused
    launches = {"inference": 0, "masked": 0}
    start = time.perf_counter()

    def row1_only(what: str) -> tuple[int, int]:
        counts = (k16.launches, k16.launches_masked)
        check(counts[0] > 0 and counts[1] > 0 and all(
            fn.launches + fn.launches_masked == 0 for name, fn in mel_kernels.WRAPPERS.items()
            if name != "radix16dif_fused"), f"{what} ran row 1, both forms")
        launches["inference"] += counts[0]
        launches["masked"] += counts[1]
        return counts

    # (a) phase 20's SGD step through train_many: the warm-up step, a replay
    a, b = 2, 8
    clips = sgd["wavs"].reshape(a * b, -1).numpy()
    labels = sgd["labels"].reshape(-1).numpy()
    loader = DeviceCachedLoader(HeldClips(clips, labels), b, device=dev)
    check(loader.cache.dtype == torch.float32, "float clips off the PCM16 grid stay float32")
    cw = sgd["cw"].to(dev)

    def sgd_model(state=None):
        model = CompactResNet()
        model.load_state_dict(sgd["init"] if state is None else state[0])
        model.to(dev).set_dropout(0.0)
        opt = build_optimizer("sgd", model.named_parameters(), 1e-4)
        if state is not None:
            opt.load_state_dict(copy.deepcopy(state[1]))
        return model, opt

    model, opt = sgd_model()
    fns = make_step_fns(model, sgd["fe"], opt, accum_steps=a)
    zero_counts()
    steps = []  # (state before, metrics, params after)
    for _ in range(2):
        before = ({k: v.detach().clone() for k, v in model.state_dict().items()},
                  copy.deepcopy(opt.state_dict()))
        m = fns.train_many(loader.cache, np.arange(a * b).reshape(1, a, b),
                           labels.reshape(1, a, b), cw, 1.0, 0, 0)
        steps.append((before, {k: float(v[0]) for k, v in m.items()}, param_arrays(model)))
    torch.cuda.synchronize()
    read_epilogue("phase 27 ResNet SGD steps")
    graph = fns.train_many.graphs["train"]
    per_replay = {f"{fn.__name__}.{attr}": n for (fn, attr), n in graph.kernel_launches.items()}
    print(f"phase 27: two lr-1 SGD steps of the full ResNet through train_many: row-1 launches "
          f"{k16.launches} (the warm-up step's and a replay's), a replay's counted launches "
          f"{per_replay}; train captures {graph_count('captures', 'train')}, replays "
          f"{graph_count('replays', 'train')}")
    check((k16.launches, k16.launches_masked) == (2, 0) and graph_count("replays", "train") == 1
          and graph_count("captures", "train") == 1 and graph_count("captures", "eval") == 0
          and per_replay == {"log_mel_radix16dif_fused.launches": 1,
                             "log_mel_epilogue.launches": 1},
          "the ResNet SGD steps: the warm-up step and a replay, row 1 once a replay")
    launches["inference"] += k16.launches
    _, m, got = steps[0]
    vs_card = step_margins((got, m["grad_norm"]), sgd["card"], sgd["floor"])
    vs_cpu = step_margins((got, m["grad_norm"]), sgd["cpu"], sgd["floor"])
    loss_err = abs(m["loss"] - sgd["card_loss"]) / abs(sgd["card_loss"])
    print(f"phase 27: the ResNet warm-up step: loss {m['loss']:.6f} (rel {loss_err:.2e} from "
          f"phase 20's eager step, tol 1e-5); params worst |d| over phase 20's bound "
          f"{vs_card.params:.3f} against the card's eager step, {vs_cpu.params:.3f} against the "
          f"CPU's; grad norm {vs_card.grad_norm:.3f} / {vs_cpu.grad_norm:.3f}")
    check(loss_err <= 1e-5, "ResNet warm-up step loss")
    check(vs_card.ok and vs_cpu.ok, f"ResNet warm-up step params ({vs_card}; {vs_cpu})")
    before, m, got = steps[1]
    ref_model, ref_opt = sgd_model(before)
    ref = make_step_fns(ref_model, sgd["fe"], ref_opt, accum_steps=a).train_step(
        sgd["wavs"].to(dev), sgd["labels"].to(dev), cw, 1.0)
    ref_loss, ref_params = float(ref["loss"]), param_arrays(ref_model)
    margins = step_margins((got, m["grad_norm"]), (ref_params, float(ref["grad_norm"])),
                           sgd["floor"])
    loss_err = abs(m["loss"] - ref_loss) / abs(ref_loss)
    same = max(float(np.abs(x - y).max()) for x, y in zip(got, ref_params))
    print(f"phase 27: the ResNet replay: loss {m['loss']:.6f} (rel {loss_err:.2e} from an eager "
          f"step from the same state, tol 1e-5); params max |d| {same:.3e}, worst |d| over "
          f"phase 20's bound {margins.params:.3f}, grad norm {margins.grad_norm:.3f}")
    check(loss_err <= 1e-5, "ResNet replay loss")
    check(margins.ok, f"ResNet replay params ({margins})")
    del model, opt, fns, ref_model, ref_opt, loader
    torch.cuda.empty_cache()

    # (b) the ResNet Trainer on the cache: per step, and fused
    cfg = p23_config(corpus)
    cfg["model"]["architecture"] = "resnet"

    def resnet_trainer(spd: int, name: str) -> Trainer:
        run_cfg = copy.deepcopy(cfg)
        run_cfg["training"].update(steps_per_dispatch=spd,
                                   checkpoint_dir=str(tmp / f"p27_{name}" / "ckpt"),
                                   log_dir=str(tmp / f"p27_{name}" / "runs"))
        return quiet(Trainer, build_model(run_cfg), *p23_datasets(corpus, run_cfg), run_cfg,
                     device="cuda")

    runs = {}
    for spd in (1, 0):
        zero_counts()
        trainer = resnet_trainer(spd, str(spd))
        check(isinstance(trainer.model, CompactResNet)
              and isinstance(trainer.train_loader, DeviceCachedLoader)
              and trainer._use_multi_dispatch() == trainer._use_fused_eval() == (spd != 1),
              f"the ResNet trainer at steps_per_dispatch {spd}: the cache and its path")
        hist, times = train_epochs(trainer)
        read_epilogue(f"phase 27 ResNet trainer at steps_per_dispatch {spd}")
        counts = row1_only(f"the ResNet trainer at steps_per_dispatch {spd}")
        caps = {kind: graph_count("captures", kind) for kind in ("train", "eval")}
        check(caps == ({"train": 1, "eval": 1} if spd != 1 else {"train": 0, "eval": 0}),
              f"steps_per_dispatch {spd}: the step and the eval group captured once ({caps})")
        runs[spd] = dict(trainer=trainer, hist=hist, times=times)
        print(f"phase 27: [{card}] ResNet Trainer at config.yaml, cache on, steps_per_dispatch "
              f"{spd} ({'per step' if spd == 1 else 'fused'}), {P23_EPOCHS} epochs of "
              f"{len(trainer.train_dataset)} / {len(trainer.val_dataset)} clips: train + "
              f"validate ms by epoch " + ", ".join(f"{t:.1f} + {v:.1f}" for t, v in times)
              + "; warm-up + capture " + capture_ms()
              + f"; history {json.dumps(hist)}; row-1 launches {counts[0]} (validation), "
              f"{counts[1]} masked (training)")

    def moved_resnet_runs():
        moved = []
        for seed in FLOOR_SEEDS:
            trainer = resnet_trainer(1, f"floor{seed}")
            perturbed(trainer.model, seed)
            moved.append(train_epochs(trainer)[0])
        return moved

    print("phase 27: the ResNet's fused history against per step: "
          + hold_histories("the ResNet trainer", runs[0]["hist"], runs[1]["hist"],
                           moved_resnet_runs))

    fused, per = runs[0]["trainer"], runs[1]["trainer"]
    train_graph = fused.steps.train_many.graphs["train"]
    eval_graph = fused.steps.eval_many.graphs["eval"]
    replayed = {kind: graph_count("replays", kind) for kind in ("train", "eval")}

    # the eval graph against eager forwards of the same rows on the fused
    # run's last weights: one of the graph's G x 32 rows, and one a batch of
    # 32 (the per-step run's validation)
    vl, cwf = fused.val_loader, fused.class_weights
    batches = vl._batch_indices()
    n_val, g_rows = len(batches), 128 // fused.batch_size
    idx = np.zeros((-(-n_val // g_rows) * g_rows, fused.batch_size), np.int64)
    mask = np.zeros(idx.shape, np.float32)
    for i, bidx in enumerate(batches):
        idx[i, :len(bidx)], mask[i, :len(bidx)] = bidx, 1.0
    idx[n_val:] = idx[0]  # eval_many's padding: the first batch's rows, masked out
    lab = vl.labels_all[idx]
    graph_out = [x.cpu().numpy() for x in fused.steps.eval_many(
        vl.cache, idx[:n_val], lab[:n_val], mask[:n_val], cwf)]

    @torch.no_grad()
    def eager_eval(rows: slice) -> list[np.ndarray]:
        fused.model.eval()
        wavs = vl.gather(idx[rows])
        logits = fused.model(features_from_wavs(fused.frontend, wavs.reshape(-1, wavs.shape[-1])))
        logits = logits.reshape(wavs.shape[:2] + (-1,))
        labels_t = torch.from_numpy(lab[rows]).to(dev)
        mask_t = torch.from_numpy(mask[rows]).to(dev)
        num, den = weighted_cross_entropy(logits, labels_t, cwf, mask_t, dim=-1)
        return [num.cpu().numpy(), den.cpu().numpy(), logits.argmax(-1).cpu().numpy()]

    one_group = [x[:n_val] for x in eager_eval(slice(0, len(idx)))]
    per_batch = [np.concatenate(parts) for parts in zip(*(eager_eval(slice(i, i + 1))
                                                          for i in range(n_val)))]
    real = mask[:n_val].astype(bool)
    for what, ref, tol in (("an eager forward of the same 128 rows", one_group, 1e-5),
                           ("eager forwards of 32 rows, as per step", per_batch, None)):
        rel = float(np.max(np.abs(graph_out[0] - ref[0]) / np.abs(ref[0])))
        agree = int((graph_out[3][real] == ref[2][real]).sum())
        print(f"phase 27: the ResNet eval graph on the fused run's last weights against {what}: "
              f"loss sums max rel {rel:.2e}"
              + (f" (tol {tol:g})" if tol else "") + f"; predictions equal on {agree} of "
              f"{int(real.sum())} clips")
        if tol is not None:
            check(rel <= tol and agree == int(real.sum()),
                  f"the ResNet eval graph against {what}")

    for what, g, form in (("train", train_graph, "launches_masked"),
                          ("eval", eval_graph, "launches")):
        kinds = node_kinds(list_graph_nodes(g.graph))
        _, found = radix8_nodes(g.graph)
        counted = {f"{fn.__name__}.{attr}": n for (fn, attr), n in g.kernel_launches.items()}
        print(f"phase 27: [{card}] the ResNet's {what} graph ({tuple(g.static[0].shape)} rows "
              f"in): nodes by kind {json.dumps(kinds)}, {found}; counted a replay {counted}; "
              f"replays over the {P23_EPOCHS} epochs {replayed[what]}; its memory pool "
              f"{pool_mb(g.graph):.1f} MB")
        check(found == {stem: 1 for stem in RADIX8_STEMS}, f"the ResNet {what} graph holds row 1 "
                                                          f"once")
        check(counted == {f"log_mel_radix16dif_fused.{form}": 1, "log_mel_epilogue.launches": 1},
              f"the ResNet {what} graph's row-1 form counted once a replay")
    tl_ = fused.train_loader
    idxs = tl_.epoch_index_batches()[:8].reshape(4, 2, 32)
    lbls = tl_.labels_all[idxs]
    lr = float(fused.scheduler.lr)

    def fused_steps():
        return fused.steps.train_many(tl_.cache, idxs, lbls, fused.class_weights, lr, 9, 0)

    fused_steps()
    calls = host_calls(fused_steps, 4)
    fused_ms = cuda_ms(fused_steps, iters=3, warmup=1) / 4
    wavs = tl_.gather(idxs[0])
    labels_t = torch.from_numpy(lbls[0]).long().to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def eager_step():
        return per.steps.train_step(wavs, labels_t, per.class_weights, lr, generator=gen)

    eager_ms = cuda_ms(eager_step, iters=10, warmup=3)
    eager_calls = host_calls(lambda: (eager_step(), eager_step()), 2)
    records = device_records(lambda: (eager_step(), eager_step()), 2)
    graph_step_ms = cuda_ms(train_graph.graph.replay, iters=10, warmup=2)
    graph_eval_ms = cuda_ms(eval_graph.graph.replay, iters=10, warmup=2)
    epoch = {spd: [t + v for t, v in runs[spd]["times"][1:]] for spd in runs}
    print(f"phase 27: [{card}] ResNet host calls a step: per step {sum(eager_calls.values()):.0f} "
          f"{json.dumps({k: round(v, 1) for k, v in eager_calls.items()})}; fused "
          f"{sum(calls.values()):.1f} {json.dumps({k: round(v, 2) for k, v in calls.items()})}; "
          f"an eager step's device records (the profiler) {json.dumps(records)}")
    print(f"phase 27: [{card}] ResNet train step at config.yaml (32 x 2 x 8 s, bf16, capturable "
          f"adam, augmentation on) by CUDA events back to back: per step {eager_ms:.3f} ms, "
          f"fused {fused_ms:.3f} ms a step; the graphed step alone (replays back to back) "
          f"{graph_step_ms:.3f} ms; an eval group of "
          f"{tuple(eval_graph.static[0].shape)[1:]} batches x rows as a graph "
          f"{graph_eval_ms:.3f} ms; steady epochs (train + validate) fused "
          f"{', '.join(f'{t:.1f}' for t in epoch[0])} ms, per step "
          f"{', '.join(f'{t:.1f}' for t in epoch[1])} ms")
    del runs, fused, per, train_graph, eval_graph
    torch.cuda.empty_cache()

    # (c) train_segmented and train_icbhi at config_segmented.yaml on the
    # cache, per step and fused, through the entry points; the recorder
    # counts the graphs they capture and replay
    segmented = tmp / "icbhi_segmented"
    seg_config = str(REPO / "config_segmented.yaml")

    def seg_argv(spd: int, name: str) -> list[str]:
        scfg = load_config(seg_config)
        scfg["data"]["cache_on_device"] = True
        scfg["training"].update(steps_per_dispatch=spd,
                                checkpoint_dir=str(tmp / f"p27_{name}" / "ckpt"),
                                log_dir=str(tmp / f"p27_{name}" / "runs"))
        path = tmp / f"p27_{name}.yaml"
        path.write_text(yaml.safe_dump(scfg))
        return ["--config", str(path), "--data-path", str(segmented),
                "--epochs", str(P23_EPOCHS), "--no-plots"]

    for entry, trainer_cls in ((train_segmented, Trainer), (train_icbhi, TrainerWithICBHI)):
        name = entry.__name__.rsplit(".", 1)[-1]
        seg = {}
        for spd in (1, 0):
            zero_counts()
            t0 = time.perf_counter()
            hist = quiet(entry.main, seg_argv(spd, f"{name}{spd}"))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            read_epilogue(f"phase 27 {name} at steps_per_dispatch {spd}")
            counts = row1_only(f"{name} at steps_per_dispatch {spd}")
            # fused: the step and the eval group captured once for all
            # epochs, and each replayed; per step: no graph
            caps = {kind: graph_count("captures", kind) for kind in ("train", "eval")}
            replays = [graph_count("replays", kind) for kind in ("train", "eval")]
            check(caps == ({"train": 1, "eval": 1} if spd != 1 else {"train": 0, "eval": 0})
                  and all((n > 0) == (spd != 1) for n in replays),
                  f"{name} at steps_per_dispatch {spd}: captures {caps}, replays "
                  f"(train, eval) {replays}")
            check(all(math.isfinite(v) for vals in hist.values() for v in vals),
                  "finite history")
            seg[spd] = hist
            print(f"phase 27: [{card}] {name} at config_segmented.yaml, cache on, "
                  f"steps_per_dispatch {spd} ({'per step' if spd == 1 else 'fused'}), "
                  f"{P23_EPOCHS} epochs: {wall:.1f} s with start-up; the graphs' replays "
                  f"(train, eval) {replays}; history {json.dumps(hist)}; row-1 launches "
                  f"{counts[0]} (validation), {counts[1]} masked (training)")

        def moved_segmented_runs(name=name, trainer_cls=trainer_cls):
            moved = []
            for seed in FLOOR_SEEDS:
                args = train_entry.parse_args(seg_argv(1, f"{name}floor{seed}"))
                trainer = quiet(train_entry.build_trainer, args, ICBHISegmentedDataset,
                                trainer_cls, seg_config)
                perturbed(trainer.model, seed)
                moved.append(quiet(trainer.train))
            return moved

        print(f"phase 27: {name}'s fused history against per step: "
              + hold_histories(name, seg[0], seg[1], moved_segmented_runs))
    print(f"phase 27: row 1 over the phase's main paths {launches}; "
          f"{time.perf_counter() - start:.1f} s")
    return launches


def phase27_alone() -> int:
    """`python3 chip_smoke.py --phase27`: the build, phase 9's and phase 21's
    corpora, phase 20's ResNet SGD step and phase 27, without the other
    phases. Exits non-zero on any failed check."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(f"{card}; torch {torch.__version__}; CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        corpus = generate_icbhi_dataset(tmp / "corpus", num_recordings=N_RECORDINGS, seed=0)
        raw = generate_icbhi_corpus_fixture(tmp / "icbhi_raw", num_recordings=SEG_RECORDINGS,
                                            cycles_per_recording=SEG_CYCLES, seed=21)
        quiet(preprocess_icbhi.main, ["--input-dir", str(raw / "audio_and_txt_files"),
                                      "--output-dir", str(tmp / "icbhi_segmented")])
        cfg = load_config(str(REPO / "config.yaml"))
        cfg["model"]["architecture"] = "resnet"
        sgd = resnet_sgd_step(dev, np.random.default_rng(0), MelFrontend.from_config(cfg))
        phase27_resnet_fused(dev, card, tmp, corpus, sgd)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--parent":
        sys.exit(compare_parent(Path(sys.argv[2])))
    if sys.argv[1:] == ["--phase27"]:
        sys.exit(phase27_alone())
    check(len(sys.argv) == 1, "usage: python3 chip_smoke.py [--parent DIR | --phase27]")
    sys.exit(main())
