"""Clocks: CUDA-event timing of many launches, and the spans a run records.

`cuda_ms` and `graph_ms` are copied from `chip_smoke.py:408-431`.
"""

from __future__ import annotations

import time
from collections import defaultdict

import torch


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


class Spans:
    """Named intervals a run records around its calls into the program:
    host-clock seconds (`host`) and, on a CUDA device, device milliseconds
    between two CUDA events (`device_ms`, read once the run has
    synchronised)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.host: dict[str, list[float]] = defaultdict(list)
        self._events: dict[str, list] = defaultdict(list)

    def timed(self, name: str, fn, *args, device_time: bool = False, sync: bool = False):
        """fn(*args), its host seconds under `name` and, with device_time
        on a CUDA device, the device milliseconds between events recorded
        before and after it. sync waits for the device before the clock
        stops."""
        events = None
        if device_time and self.cuda:
            events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            events[0].record()
        t0 = time.perf_counter()
        out = fn(*args)
        if events is not None:
            events[1].record()
            self._events[name].append(events)
        if sync and self.cuda:
            torch.cuda.synchronize()
        self.host[name].append(time.perf_counter() - t0)
        return out

    def device_ms(self, name: str) -> list[float]:
        """The device milliseconds of every `name` span (synchronises)."""
        if self._events[name]:
            self._events[name][-1][1].synchronize()
        return [a.elapsed_time(b) for a, b in self._events[name]]
