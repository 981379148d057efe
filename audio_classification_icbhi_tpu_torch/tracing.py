"""The port's spans, device marks and counters: one recorder a process.

Spans. `span(name)` is a context manager around one stretch of host work.
It reads `time.perf_counter_ns` at its start and end, takes the innermost
span open in its thread as its parent, and adds to its name's aggregate
(`Stat`): the count, the total, the self time (the duration less what its
child spans cover) and the duration itself, in a ring of the last RING.
So memory stays bounded over any run: one aggregate and at most RING
durations a name. While torch's profiler records, a span also opens
`torch.autograd.profiler.record_function(name)`: the span then sits in
the device trace's timeline, on the profiler's clock, and an idle stretch
of the device falls under the span that holds it. With the profiler off
a span never touches record_function. Spans are always
recorded: they sit at layer boundaries, a few an epoch and none a replay,
and none is opened inside a function captured into a CUDA graph.

Span names are dotted by layer: `trainer.*` and `cache.*` (the Trainer's
set-up and its device cache), `kernels.build`, `graph.warmup.<kind>` and
`graph.capture.<kind>` (the step graphs), `fused_epoch` and `fused_val`
with their children `fused_epoch.*` and `fused_val.*` (the Trainer's
fused epoch and validation, `training/trainer.py`), and `train_many.*` and
`eval_many.*` (the step functions those call, `parallel/data_parallel.py`).

Device marks. `step_marks(device)` gives a `StepMarks` while a train step
is being captured into a CUDA graph (None otherwise, and on the CPU):
CUDA timing events at the step's phase boundaries, made `external`, so
that each becomes an event-record node of the graph and is recorded again
by every replay. `train_many` hands its graph's marks to the recorder
after its replays (`marks_pending`); once the caller has read the epoch
back from the device, which synchronises, `read_marks()` adds the phase
times of the last replay (`step.front_end`, `step.forward`,
`step.backward`, `step.update`; device ms) to the recorder, with no
synchronisation of its own. An eager step records no marks. Outside that
chain, an op may mark its own kernels: while `marking(marks)` holds the
marks of the step being captured, `interval(name)` records a pair of
events around a block (on any thread: the autograd engine runs backward
passes on its own), and `read_marks()` adds their device ms, summed over
the step's pairs, as `step.<name>` (`ops/attention.py`: `step.attention`).

Counters. `count(name, n)` adds to a program counter: graph captures and
replays by kind (`graph.captures.train`, `graph.replays.eval`) and the
kernel libraries nvcc built against those loaded as built before
(`kernels.built`, `kernels.cached`). `counters()` is one snapshot of every
count the program keeps: those, the kernel wrappers' and the attention
op's launch counts (`launch_counters()`, as `<wrapper>.<attribute>`) and
the rows each WAV decoder path decoded (`native.ROWS`, as `rows.<path>`).

`snapshot()` gives all of it as plain data and `write(path)` as JSON (the
`spans.json` that `train.py --profile DIR` writes beside its trace);
`reset()` clears the spans, the marks and the program counters (the
wrappers' launch counts and `native.ROWS` have their own).
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from collections import defaultdict, deque
from pathlib import Path

import torch

RING = 1024  # durations kept a name


class Stat:
    """The aggregate of one span or device phase name, in milliseconds:
    count, total, self time (a device phase's is its total), the parent
    span of its last occurrence, and its last RING durations."""

    __slots__ = ("count", "total_ms", "self_ms", "parent", "ring")

    def __init__(self):
        self.count = 0
        self.total_ms = 0.0
        self.self_ms = 0.0
        self.parent: str | None = None
        self.ring: deque[float] = deque(maxlen=RING)

    def add(self, ms: float, self_ms: float, parent: str | None = None) -> None:
        self.count += 1
        self.total_ms += ms
        self.self_ms += self_ms
        self.parent = parent
        self.ring.append(ms)

    def as_dict(self) -> dict:
        return {"count": self.count, "total_ms": self.total_ms, "self_ms": self.self_ms,
                "parent": self.parent, "last_ms": list(self.ring)}


_lock = threading.Lock()
_local = threading.local()
_spans: dict[str, Stat] = defaultdict(Stat)
_device: dict[str, Stat] = defaultdict(Stat)
_counts: dict[str, int] = defaultdict(int)
_pending: list = []  # the StepMarks of the last replays, until read_marks
_marking: list = [None]  # the StepMarks of the step being captured, for `interval`


def _stack() -> list[span]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class span:
    """`with span(name):` the block as span `name`, under the innermost
    span open in this thread (module doc)."""

    __slots__ = ("name", "parent", "child_ms", "rf", "start")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        # the clock is read before the record_function opens and before it
        # closes, so that the costs of the two mostly cancel in a length
        self.start = time.perf_counter_ns()
        stack = _stack()
        self.parent = stack[-1] if stack else None
        self.child_ms = 0.0
        self.rf = None
        if torch._C._autograd._profiler_enabled():
            self.rf = torch.autograd.profiler.record_function(self.name)
            self.rf.__enter__()
        stack.append(self)
        return self

    def __exit__(self, *exc):
        ms = (time.perf_counter_ns() - self.start) / 1e6
        _stack().pop()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        parent = self.parent
        if parent is not None:
            parent.child_ms += ms
        with _lock:
            _spans[self.name].add(ms, ms - self.child_ms, parent.name if parent else None)
        return False


class StepMarks:
    """CUDA timing events at the phase boundaries of one captured train
    step. `mark(phase)` records the end of `phase`, the first call the
    step's start; `phases()` gives each phase's device ms in the last
    replay, a phase marked several times (one a microbatch) summed, and
    each interval's (`interval`) summed over its pairs."""

    def __init__(self):
        self.events: list[tuple[str, torch.cuda.Event]] = []
        self.intervals: dict[str, list[tuple[torch.cuda.Event, torch.cuda.Event]]] = \
            defaultdict(list)

    @staticmethod
    def _event() -> torch.cuda.Event:
        event = torch.cuda.Event(enable_timing=True, external=True)
        event.record()
        return event

    def mark(self, phase: str) -> None:
        self.events.append((phase, self._event()))

    def phases(self) -> dict[str, float]:
        out: dict[str, float] = defaultdict(float)
        for (_, a), (phase, b) in zip(self.events, self.events[1:]):
            out[phase] += a.elapsed_time(b)
        for name, pairs in self.intervals.items():
            out[name] = sum(a.elapsed_time(b) for a, b in pairs)
        return dict(out)


def step_marks(device: torch.device) -> StepMarks | None:
    """A StepMarks for a step on `device` while the current stream is
    capturing a CUDA graph; None otherwise (an eager step, the CPU)."""
    if device.type != "cuda" or not torch.cuda.is_current_stream_capturing():
        return None
    return StepMarks()


@contextlib.contextmanager
def marking(marks: StepMarks | None):
    """`interval` records into `marks` inside the block (None: nowhere)."""
    saved, _marking[0] = _marking[0], marks
    try:
        yield
    finally:
        _marking[0] = saved


@contextlib.contextmanager
def interval(name: str):
    """A pair of device marks around the block, kept under `name` in the
    StepMarks that `marking` holds; nothing where it holds none."""
    marks = _marking[0]
    if marks is None:
        yield
        return
    start = marks._event()
    yield
    marks.intervals[name].append((start, marks._event()))


def marks_pending(marks: StepMarks | None) -> None:
    """Keep the marks of a graph that has just been replayed, for the next
    `read_marks`."""
    _pending[:] = [] if marks is None else [marks]


def read_marks() -> None:
    """Record the phases of the last replay whose marks are pending as
    `step.<phase>` device ms. Call once the device has run the replay
    (after a read-back): it does not synchronise."""
    if not _pending:
        return
    phases = _pending.pop().phases()
    with _lock:
        for phase, ms in phases.items():
            _device[f"step.{phase}"].add(ms, ms)


def count(name: str, n: int = 1) -> None:
    """Add n to program counter `name`."""
    with _lock:
        _counts[name] += n


def launch_counters() -> list[tuple[object, str]]:
    """(function, attribute) of every launch count the kernel wrappers and
    the attention op keep."""
    from audio_classification_icbhi_tpu_torch.ops import (
        attention,
        conv_epilogue,
        conv_kernels,
        mel_kernels,
    )

    out = [(fn, attr) for fn in mel_kernels.WRAPPERS.values()
           for attr in ("launches", "launches_masked")]
    out.append((mel_kernels.log_mel_epilogue, "launches"))
    out += [(fn, "launches") for fn in (conv_kernels.fused_conv_block1,
                                        conv_kernels.fused_conv_block1_batched,
                                        conv_kernels.fused_conv_block2,
                                        conv_kernels.fused_conv_block3)]
    out += [(fn, attr) for fn in (conv_epilogue.conv_epilogue, attention.attention)
            for attr in ("launches", "launches_backward")]
    return out


def counters() -> dict[str, int]:
    """Every count the program keeps, by name (module doc)."""
    from audio_classification_icbhi_tpu_torch import native

    out = {f"{fn.__name__}.{attr}": getattr(fn, attr) for fn, attr in launch_counters()}
    out.update((f"rows.{path}", n) for path, n in native.ROWS.as_dict().items())
    with _lock:
        out.update(_counts)
    return out


def stat(name: str) -> Stat | None:
    """The aggregate of span or device phase `name`; None where none was
    recorded."""
    with _lock:
        return _spans.get(name) or _device.get(name)


def snapshot() -> dict:
    """The spans, the device phases and the counters as plain data."""
    with _lock:
        spans = {name: s.as_dict() for name, s in _spans.items()}
        device = {name: s.as_dict() for name, s in _device.items()}
    return {"spans": spans, "device": device, "counters": counters()}


def write(path) -> Path:
    """`snapshot()` as JSON at path."""
    path = Path(path)
    path.write_text(json.dumps(snapshot(), indent=1))
    return path


def reset() -> None:
    """Clear the spans, the device phases, the pending marks and the
    program counters."""
    with _lock:
        _spans.clear()
        _device.clear()
        _counts.clear()
        _pending.clear()
        _marking[0] = None
