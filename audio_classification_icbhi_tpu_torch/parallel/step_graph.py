"""One step function captured as a CUDA graph and replayed.

The fused multi-step epoch (`data_parallel.make_step_fns`'s `train_many` and
`eval_many`) runs on a CUDA device as replays: one optimizer step, or one
eval group, is captured once over static input buffers, and each call copies
its inputs into those buffers and replays the graph, a handful of host calls
where the eager step makes hundreds of launches. On the CPU the same step
functions run eagerly (there are no CPU graphs).

Capture follows torch's recipe (`torch.cuda.graph`, the default "global"
error mode, or "thread_local" where the caller asks: in a process group,
whose watchdog thread queries CUDA events while a capture runs): a warm-up
call on a side stream first, where everything lazy happens outside the
capture (the kernels' nvcc build and device tables, cuBLAS's workspace,
the optimizer's state, the NCCL communicator), then the capture on the
same stream. The warm-up is the caller's first real step, run eagerly: its
outputs are that step's, and the replays go on from the second. A capture
that fails raises; nothing goes back to eager launches.

A generator the step draws from is registered with the graph, so a replay
draws what an eager call would from the generator's seed and offset at
that moment: the caller reseeds it before each replay.

The kernel wrappers count their launches on the host, and a replay makes no
host call into them, so a `GraphedStep` keeps the counts true: the capture's
own increments are taken back (it launched nothing) and kept as the
launches one replay makes, which each replay adds.
"""

from __future__ import annotations

import time
from typing import Callable, Sequence

import torch


def launch_counters() -> list[tuple[object, str]]:
    """(function, attribute) of every launch count the kernel wrappers keep."""
    from audio_classification_icbhi_tpu_torch.ops import conv_kernels, mel_kernels

    out = [(fn, attr) for fn in mel_kernels.WRAPPERS.values()
           for attr in ("launches", "launches_masked")]
    out.append((mel_kernels.log_mel_epilogue, "launches"))
    out += [(fn, "launches") for fn in (conv_kernels.fused_conv_block1,
                                        conv_kernels.fused_conv_block1_batched,
                                        conv_kernels.fused_conv_block2,
                                        conv_kernels.fused_conv_block3)]
    return out


def _read_counts() -> list[int]:
    return [getattr(fn, attr) for fn, attr in launch_counters()]


class GraphedStep:
    """fn(*static inputs) captured once as a CUDA graph.

    `inputs` give the static buffers' shapes, dtypes and first values;
    `replay(*inputs)` copies new values into them, replays the graph and
    returns fn's output tensor, the graph's own, which the next replay
    rewrites. The capture runs on the side stream `stream`. With `warm`, fn
    first runs eagerly there on the first inputs, as the caller's first
    step, and `first` holds its output (else None: a re-capture of a step
    that has run before). `generator` is registered with the graph. `pool`
    is a memory-pool handle shared with earlier captures of the same step
    on the same stream (`torch.cuda.graph_pool_handle()`), so that a
    re-capture reuses their memory. `capture_error_mode` is
    `torch.cuda.graph`'s. `kernel_launches` maps each counted
    kernel wrapper (function, attribute) to the launches one replay makes;
    `capture_s` is the host time of the warm-up and the capture."""

    def __init__(self, fn: Callable[..., torch.Tensor], inputs: Sequence[torch.Tensor], *,
                 stream: torch.cuda.Stream, warm: bool = False,
                 generator: torch.Generator | None = None, pool=None,
                 capture_error_mode: str = "global"):
        t0 = time.perf_counter()
        device = inputs[0].device
        current = torch.cuda.current_stream(device)
        self.static = [x.detach().clone() for x in inputs]
        self.generator = generator
        self.first = None
        stream.wait_stream(current)
        if warm:
            with torch.cuda.stream(stream):
                self.first = fn(*self.static)
            current.wait_stream(stream)
            self.first.record_stream(current)  # read there, made here
        before = _read_counts()
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        if generator is not None:
            self.graph.register_generator_state(generator)
        with torch.cuda.graph(self.graph, pool=pool, stream=stream,
                              capture_error_mode=capture_error_mode):
            self.outputs = fn(*self.static)
        after = _read_counts()
        self.kernel_launches = {}
        for (fn_, attr), b, a in zip(launch_counters(), before, after):
            setattr(fn_, attr, b)  # the capture launched nothing
            if a != b:
                self.kernel_launches[fn_, attr] = a - b
        self.replays = 0
        self.capture_s = time.perf_counter() - t0

    def replay(self, *inputs: torch.Tensor):
        for buf, x in zip(self.static, inputs):
            buf.copy_(x, non_blocking=True)
        self.graph.replay()
        self.replays += 1
        for (fn, attr), n in self.kernel_launches.items():
            setattr(fn, attr, getattr(fn, attr) + n)
        return self.outputs
