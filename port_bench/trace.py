"""The device trace of a traced segment, from torch.profiler.

`profiled(fn)` runs fn under the profiler inside a span of its own and
reduces the timeline: the device's busy seconds (the union of kernel, copy
and fill intervals inside the span), the span's length, the device
operations by total time, the idle stretches by what the host was doing
(the innermost host event over each stretch's middle, under the benchmark's
own span that holds it).

`replay_records(graphs)` checks the profiler on CUDA-graph replays: it
counts the device records of raw replays of captured graphs against the
kernel, copy and fill nodes the graphs hold, by libcuda's graph calls.
"""

from __future__ import annotations

import ctypes
from collections import Counter, defaultdict

import torch

WINDOW = "port_bench.window"
REPLAYS = 5  # raw replays of each graph under the profiler
# CUgraphNodeType (cuda.h) of the nodes that leave a device record
RECORDED_NODES = {0: "kernel", 1: "memcpy", 2: "memset"}


def _device_events(events):
    out = []
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if getattr(e, "is_user_annotation", False) or e.name.startswith("Optimizer."):
            continue
        out.append(e)
    return out


def _merge(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def reduce(events, spans: tuple[str, ...] = ()) -> dict:
    """The timeline of a profiled segment (`events`: the profiler's
    FunctionEvents) reduced to seconds. `spans` are the benchmark's own
    record_function names, which label the idle stretches they hold."""
    cuda = torch.autograd.DeviceType.CUDA
    window = [e for e in events if e.name == WINDOW and e.device_type != cuda]
    if not window:
        return {}
    w0, w1 = window[0].time_range.start, window[0].time_range.end
    device = _device_events(events)
    busy_iv = _merge((max(e.time_range.start, w0), min(e.time_range.end, w1)) for e in device
                     if e.time_range.end > w0 and e.time_range.start < w1)
    busy_us = sum(b - a for a, b in busy_iv)
    by_name: dict[str, float] = defaultdict(float)
    for e in device:
        by_name[e.name[:160]] += e.time_range.end - e.time_range.start
    gaps, edge = [], w0
    for a, b in busy_iv:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    if w1 > edge:
        gaps.append((edge, w1))
    host = [e for e in events if e.device_type != cuda and e.name != WINDOW]
    idle: dict[str, float] = defaultdict(float)
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:50]:
        mid = (a + b) / 2
        cover = [e for e in host if e.time_range.start <= mid <= e.time_range.end]
        inner = min(cover, key=lambda e: e.time_range.end - e.time_range.start, default=None)
        span = min((e for e in cover if e.name in spans),
                   key=lambda e: e.time_range.end - e.time_range.start, default=None)
        label = " > ".join(n for n in ((span.name if span else "python"),
                                        (inner.name if inner and inner is not span else ""))
                           if n)
        idle[label[:160]] += (b - a)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "busy_s": busy_us / 1e6,
        "window_s": (w1 - w0) / 1e6,
        "kernel_sum_s": sum(v for k, v in by_name.items()
                            if not k.startswith(("Memcpy", "Memset"))) / 1e6,
        "device_ops": [[k, v / 1e6] for k, v in top],
        "idle_gaps": [[k, v / 1e6] for k, v in sorted(idle.items(), key=lambda kv: -kv[1])[:10]],
    }


def profiled(fn, spans: tuple[str, ...] = ()) -> tuple[object, dict]:
    """fn() under torch.profiler: (its result, `reduce` of the timeline)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            out = fn()
            torch.cuda.synchronize()
    return out, reduce(prof.events(), spans)


def graph_node_types(graph: torch.cuda.CUDAGraph) -> Counter:
    """CUgraphNodeType -> count of a graph captured with keep_graph=True
    (after `list_graph_nodes`, chip_smoke.py:2386-2413, without the kernel
    names)."""
    cuda = ctypes.CDLL("libcuda.so.1")
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    if cuda.cuGraphGetNodes(raw, None, ctypes.byref(count)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    handles = (ctypes.c_void_p * count.value)()
    if cuda.cuGraphGetNodes(raw, handles, ctypes.byref(count)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    kinds = Counter()
    for handle in handles:
        kind = ctypes.c_int(-1)
        if cuda.cuGraphNodeGetType(ctypes.c_void_p(handle), ctypes.byref(kind)) != 0:
            raise RuntimeError("cuGraphNodeGetType failed")
        kinds[kind.value] += 1
    return kinds


def replay_records(steps, replays: int = REPLAYS) -> tuple[int, int, list[dict]]:
    """(device records the profiler keeps, kernel + copy + fill nodes, each
    graph's node counts by type) over `replays` bare replays of each
    captured step's graph (`.graph`), with nothing else launched in the
    profiled span. A graph holding a child graph or a conditional node
    counts as incomplete (nodes += 1)."""
    graphs = [s.graph for s in steps]
    nodes, types = 0, []
    for g in graphs:
        kinds = graph_node_types(g)
        types.append(dict(sorted(kinds.items())))
        nodes += replays * sum(kinds[k] for k in RECORDED_NODES)
        nodes += int(kinds[4] > 0 or kinds[13] > 0)  # child graph, conditional

    def bare():
        for g in graphs:
            for _ in range(replays):
                g.replay()

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        bare()
        torch.cuda.synchronize()
    return len(_device_events(prof.events())), nodes, types
