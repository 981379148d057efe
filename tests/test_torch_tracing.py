"""The port's recorder (`tracing.py`): spans, counters and device marks.

On the CPU:
- spans nest, take their parent and keep their self time; a name keeps at
  most RING durations;
- under torch's CPU profiler each span is a record_function of its name
  and length; with the profiler off no record_function is opened;
- `counters()` is the kernel wrappers' launch counts, `native.ROWS` and
  the program counters;
- a CPU `Trainer` with the device cache records its set-up spans once and
  each fused-epoch and fused-validation span once an epoch, and the
  fused-epoch spans cover its `train_epoch`; `train(profile_dir=)` writes
  `spans.json` beside `trace.json`;
- each per-layer reader of the benchmark that reads the recorder returns a
  number from a planted state and nothing from an empty one.

On the card (marker `card`; this file imports no JAX, so it runs there
with `--noconftest`): the device marks of a replayed LightweightCNN step at
config.yaml add up to the replay's CUDA-event time.

    python -m pytest tests/test_torch_tracing.py -q -m card --noconftest -p no:cacheprovider
"""

from __future__ import annotations

import json
import statistics
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from audio_classification_icbhi_tpu_torch import native, tracing
from audio_classification_icbhi_tpu_torch.data.dataset_segmented import ICBHISegmentedDataset
from audio_classification_icbhi_tpu_torch.data.synthetic import generate_segmented_dataset
from audio_classification_icbhi_tpu_torch.data.wavio import load_audio, write_wav
from audio_classification_icbhi_tpu_torch.models import build_model
from audio_classification_icbhi_tpu_torch.ops import conv_kernels, mel_kernels
from audio_classification_icbhi_tpu_torch.training.trainer import Trainer

REPO = Path(__file__).resolve().parent.parent
EPOCHS = 2
# the spans under `fused_epoch` and `fused_val`: the Trainer's and its step
# functions'
FUSED_EPOCH = ("fused_epoch.prepare", "train_many.upload", "train_many.replays",
               "fused_epoch.tail", "fused_epoch.readback")
FUSED_VAL = ("fused_val.prepare", "eval_many.upload", "eval_many.replays", "eval_many.collect",
             "fused_val.readback")


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two intra-op threads for the CPU Trainer's small steps."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def clean_recorder():
    tracing.reset()
    yield
    tracing.reset()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def wait_ms(ms: float) -> None:
    end = time.perf_counter() + ms / 1e3
    while time.perf_counter() < end:
        pass


# --- spans ----------------------------------------------------------------------

def test_spans_nest_with_parents_and_self_time():
    with tracing.span("t.outer"):
        wait_ms(2)
        with tracing.span("t.inner"):
            wait_ms(3)
        with tracing.span("t.second"):
            wait_ms(1)
            with tracing.span("t.deep"):
                wait_ms(1)
    outer, inner, second, deep = map(tracing.stat, ("t.outer", "t.inner", "t.second", "t.deep"))
    assert (outer.count, inner.count, second.count, deep.count) == (1, 1, 1, 1)
    assert (outer.parent, inner.parent, second.parent, deep.parent) == (
        None, "t.outer", "t.outer", "t.second")
    assert inner.self_ms == inner.total_ms >= 3
    assert second.self_ms == pytest.approx(second.total_ms - deep.total_ms)
    assert outer.total_ms >= 7
    assert outer.self_ms == pytest.approx(outer.total_ms - inner.total_ms - second.total_ms)
    assert 2 <= outer.self_ms < outer.total_ms


def test_span_closes_when_its_block_raises():
    with pytest.raises(RuntimeError):
        with tracing.span("t.outer"):
            with tracing.span("t.failing"):
                raise RuntimeError
    with tracing.span("t.next"):
        pass
    assert tracing.stat("t.failing").count == 1
    assert tracing.stat("t.failing").parent == "t.outer"
    assert tracing.stat("t.outer").count == 1
    assert tracing.stat("t.next").parent is None


def test_ring_is_bounded():
    n = tracing.RING + 100
    for _ in range(n):
        with tracing.span("t.many"):
            pass
    s = tracing.stat("t.many")
    assert s.count == n and len(s.ring) == tracing.RING
    assert len(tracing.snapshot()["spans"]["t.many"]["last_ms"]) == tracing.RING


def test_span_is_a_record_function_under_the_profiler():
    """Each span is a record_function of its name whose length agrees with
    the recorder's within 50 us (the median of 7, against the host's
    noise; the first record_function of a process is left out, whose
    set-up lengthens it)."""
    from torch.profiler import ProfilerActivity, profile

    names = ("t.profiled", "t.profiled_inner")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("t.first"):
            pass
        for _ in range(7):
            with tracing.span(names[0]):
                wait_ms(2)
                with tracing.span(names[1]):
                    wait_ms(1)
    for name in names:
        events = sorted((e for e in prof.events() if e.name == name),
                        key=lambda e: e.time_range.start)
        assert len(events) == 7, name
        gaps = [abs(e.time_range.elapsed_us() - 1e3 * ms)
                for e, ms in zip(events, tracing.stat(name).ring)]
        assert statistics.median(gaps) <= 50, (name, gaps)


def test_no_record_function_without_the_profiler(monkeypatch):
    def refused(name):
        raise AssertionError(f"record_function({name!r}) with the profiler off")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refused)
    with tracing.span("t.quiet"):
        with tracing.span("t.quiet_inner"):
            pass
    assert tracing.stat("t.quiet").count == 1
    assert tracing.stat("t.quiet_inner").parent == "t.quiet"


# --- counters ---------------------------------------------------------------------

def test_counters_are_every_count_the_program_keeps(tmp_path, monkeypatch):
    wav = tmp_path / "a.wav"
    write_wav(wav, np.zeros(800, np.float32), 4000)
    native.ROWS.reset()
    for _ in range(3):
        load_audio(wav)
    k16 = mel_kernels.log_mel_radix16dif_fused
    monkeypatch.setattr(k16, "launches", k16.launches + 2)
    monkeypatch.setattr(conv_kernels.fused_conv_block2, "launches", 5)
    tracing.count("graph.replays.train", 7)
    tracing.count("graph.replays.train")
    got = tracing.counters()
    assert {k: got[f"rows.{k}"] for k in native.ROWS.FIELDS} == native.ROWS.as_dict()
    assert sum(native.ROWS.as_dict().values()) == 3
    for fn, attr in tracing.launch_counters():
        assert got[f"{fn.__name__}.{attr}"] == getattr(fn, attr)
    assert got["fused_conv_block2.launches"] == 5
    assert got["graph.replays.train"] == 8
    tracing.reset()
    assert "graph.replays.train" not in tracing.counters()


def test_marks_do_nothing_off_the_card():
    assert tracing.step_marks(torch.device("cpu")) is None
    tracing.marks_pending(None)
    tracing.read_marks()
    assert tracing.snapshot()["device"] == {}


# --- the Trainer ------------------------------------------------------------------

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """64 PCM16 clips of 0.8 s at 4 kHz: at batch 8 and accumulation 2 the
    train split has 2 full groups and a tail group of one batch."""
    return generate_segmented_dataset(tmp_path_factory.mktemp("trace4k"), per_class=16,
                                      duration=0.8, sample_rate=4000)


def tiny_config(tmp: Path) -> dict:
    return {
        "data": {"dataset_path": "unused", "sample_rate": 4000, "n_mels": 32, "n_fft": 256,
                 "hop_length": 64, "duration": 0.8, "augmentation": True,
                 "train_split": 0.7, "val_split": 0.15, "cache_on_device": True},
        "model": {"architecture": "cnn", "num_classes": 4, "dropout": 0.1},
        "training": {"batch_size": 8, "epochs": EPOCHS, "learning_rate": 3e-3,
                     "weight_decay": 1e-4, "optimizer": "adam", "scheduler": "cosine",
                     "mixed_precision": False, "gradient_accumulation_steps": 2,
                     "early_stopping_patience": 50, "save_every": 100,
                     "checkpoint_dir": str(tmp / "ckpts"), "log_dir": str(tmp / "runs")},
        "classes": ["normal", "crackles", "wheezes", "both"],
        "seed": 0,
    }


def test_trainer_records_each_layer(corpus, tmp_path):
    config = tiny_config(tmp_path)
    train = ICBHISegmentedDataset(corpus, "train", config, augment=True)
    val = ICBHISegmentedDataset(corpus, "val", config, augment=False)
    t = Trainer(build_model(config), train, val, config, device="cpu")
    assert t._use_multi_dispatch() and t._use_fused_eval()
    snap = tracing.snapshot()["spans"]
    children = ("trainer.frontend", "trainer.cache", "trainer.model", "trainer.optimizer",
                "trainer.step_fns", "trainer.writer")
    assert snap["trainer.init"]["count"] == 1
    assert all(snap[c]["count"] == 1 and snap[c]["parent"] == "trainer.init"
               for c in children)
    for c in ("cache.decode", "cache.pcm16", "cache.upload"):  # one each split
        assert snap[c]["count"] == 2 and snap[c]["parent"] == "trainer.cache", c
    covered = []
    for epoch in range(EPOCHS):
        t0 = time.perf_counter()
        t.train_epoch(epoch)
        host_ms = 1e3 * (time.perf_counter() - t0)
        covered.append(sum(tracing.stat(n).ring[-1] for n in FUSED_EPOCH) / host_ms)
        t.validate(epoch)
    snap = tracing.snapshot()["spans"]
    for parent, names in (("fused_epoch", FUSED_EPOCH), ("fused_val", FUSED_VAL)):
        assert snap[parent]["count"] == EPOCHS and snap[parent]["parent"] is None
        for name in names:
            assert snap[name]["count"] == EPOCHS and snap[name]["parent"] == parent, name
    assert min(covered) >= 0.95, covered
    # the CPU runs the steps eagerly: no graph, no mark
    assert not any(k.startswith("graph.") for k in tracing.counters())
    assert tracing.snapshot()["device"] == {}


def test_profile_dir_writes_spans_beside_the_trace(corpus, tmp_path):
    config = tiny_config(tmp_path)
    config["training"]["epochs"] = 1
    train = ICBHISegmentedDataset(corpus, "train", config, augment=True)
    val = ICBHISegmentedDataset(corpus, "val", config, augment=False)
    Trainer(build_model(config), train, val, config, device="cpu").train(
        profile_dir=str(tmp_path / "prof"))
    spans = json.loads((tmp_path / "prof" / "spans.json").read_text())
    assert set(spans) == {"spans", "device", "counters"}
    assert spans["spans"]["trainer.init"]["count"] == 1
    assert all(spans["spans"][n]["count"] == 1 for n in FUSED_EPOCH)
    assert spans["counters"]["rows.native"] + spans["counters"]["rows.numpy"] > 0
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert set(FUSED_EPOCH) <= names  # the profiled epoch carries the program's spans


# --- the benchmark's readers ------------------------------------------------------

class Phases:
    """Stands in for a graph's StepMarks whose replay has run."""

    def __init__(self, phases: dict[str, float]):
        self._phases = phases

    def phases(self) -> dict[str, float]:
        return self._phases


def plant() -> dict[str, float]:
    """A recorder state with every span and mark the readers read, and
    what each reader should give from it."""
    for _ in range(3):
        with tracing.span("trainer.cache"):
            wait_ms(0.2)
    for kind in ("train", "eval"):
        with tracing.span(f"graph.warmup.{kind}"):
            wait_ms(0.3)
        with tracing.span(f"graph.capture.{kind}"):
            wait_ms(0.1)
    for _ in range(3):  # epoch 0 calls train_many outside the Trainer
        with tracing.span("train_many.upload"):
            wait_ms(1)
    for i in range(5):
        for prefix, many in (("fused_epoch", "train_many"), ("fused_val", "eval_many")):
            with tracing.span(f"{prefix}.prepare"):
                wait_ms(0.05 * (i + 1))
            with tracing.span(f"{many}.upload"):
                wait_ms(0.05)
    for i in range(5):
        tracing.marks_pending(Phases({"front_end": 0.5 + i, "forward": 2.0 + i,
                                      "backward": 4.0 + i, "update": 0.25 + i}))
        tracing.read_marks()

    def median(prepare, upload):  # of each set-up's two spans, summed
        last = zip(list(tracing.stat(prepare).ring)[-5:], list(tracing.stat(upload).ring)[-5:])
        return statistics.median(a + b for a, b in last)

    return {"cache_build_ms": tracing.stat("trainer.cache").ring[-1],
            "graph_capture_ms": tracing.stat("graph.capture.train").total_ms
            + tracing.stat("graph.capture.eval").total_ms,
            "epoch_prepare_ms": median("fused_epoch.prepare", "train_many.upload"),
            "val_prepare_ms": median("fused_val.prepare", "eval_many.upload"),
            "step_front_end_ms": 2.5, "step_forward_ms": 4.0, "step_backward_ms": 6.0,
            "step_update_ms": 2.25}


READERS = ("cache_build_ms", "graph_capture_ms", "epoch_prepare_ms", "val_prepare_ms",
           "step_front_end_ms", "step_forward_ms", "step_backward_ms", "step_update_ms")


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_the_recorder(name):
    from port_bench.run import reader

    read = reader(name)
    assert read(None, None) is None  # an empty recorder: nothing
    want = plant()
    assert want[name] > 0
    assert read(None, None) == pytest.approx(want[name])


def test_readers_are_declared_for_both_cells():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    declared = {m["name"]: m for m in bench["per_layer"]}
    for name in READERS:
        assert declared[name]["workloads"] == ["lwcnn-train-epochs", "resnet18-train-epochs"]
        assert (REPO / "port_bench" / "metrics" / f"{name}.py").exists()


# --- on the card ------------------------------------------------------------------

@pytest.mark.card
def test_marks_add_up_to_the_replay(card):
    """A LightweightCNN step at config.yaml (8 s clips, batch 32 x 2, bf16,
    capturable Adam, augmentation on) through `train_many`: its graph's
    four phases add up to the CUDA-event time of a bare replay within 3 %,
    and the epoch's read leaves them with the recorder."""
    from audio_classification_icbhi_tpu_torch.ops.mel import MelFrontend
    from audio_classification_icbhi_tpu_torch.parallel.data_parallel import make_step_fns
    from audio_classification_icbhi_tpu_torch.training.optimizers import build_optimizer
    from audio_classification_icbhi_tpu_torch.utils.config import load_config

    cfg = load_config(str(REPO / "config.yaml"))
    a, b = cfg["training"]["gradient_accumulation_steps"], cfg["training"]["batch_size"]
    length = int(cfg["data"]["sample_rate"] * cfg["data"]["duration"])
    model = build_model(cfg)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.to(card)
    opt = build_optimizer("adam", model.named_parameters(), 1e-4, capturable=True)
    fns = make_step_fns(model, MelFrontend.from_config(cfg), opt, accum_steps=a, augment=True)
    g = torch.Generator().manual_seed(0)
    n = 3 * a * b
    cache = torch.randint(-8000, 8000, (n, length), generator=g, dtype=torch.int16).to(card)
    idxs = torch.randperm(n, generator=g).reshape(3, a, b).numpy()
    labels = torch.randint(0, 4, (3, a, b), generator=g).numpy()
    cw = torch.ones(4, device=card)
    m = fns.train_many(cache, idxs, labels, cw, 1e-3, 0, 0)  # warm-up step, two replays
    float(m["loss"].sum())  # the read-back
    tracing.read_marks()
    step = fns.train_many.graphs["train"]
    recorded = {p: tracing.stat(f"step.{p}").ring[-1]
                for p in ("front_end", "forward", "backward", "update")}
    assert all(v > 0 for v in recorded.values()), recorded
    assert tracing.counters()["graph.replays.train"] == 2
    sums = []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        step.graph.replay()
        end.record()
        end.synchronize()
        phases = step.marks.phases()
        assert set(phases) == set(recorded)
        sums.append((sum(phases.values()), start.elapsed_time(end)))
    print("phases of the last replay (ms)", phases, "sum against the replay", sums)
    for total, replay in sums:
        assert 0.97 * replay <= total <= replay * 1.0001
