"""Percent of its least time that the train step's attention reaches: the
least time of the step's A · B clips' attention work, forward and backward
(`reference/<architecture>.attention_gflop` over the card's bf16 peak, or
`attention_bytes` over its memory bandwidth, whichever is larger), over
`step_attention_ms`. The work is the architecture's, whatever computes it;
nothing where the architecture has no attention or the program records no
attention marks."""

import importlib

from port_bench.counts import BF16_FLOPS, HBM_BYTES_PER_S
from port_bench.run import reader


def read(run, outcome):
    ms = reader("step_attention_ms")(run, outcome)
    cfg = outcome.info["config"]
    arch = importlib.import_module(f"port_bench.reference.{cfg['model']['architecture']}")
    if ms is None or not hasattr(arch, "attention_gflop"):
        return None
    data, tcfg = cfg["data"], cfg["training"]
    h = data["n_mels"]
    w = 1 + int(data["sample_rate"] * data["duration"]) // data["hop_length"]
    clips = tcfg["batch_size"] * max(1, tcfg.get("gradient_accumulation_steps", 1))
    least_s = max(clips * arch.attention_gflop(h, w) * 1e9 / BF16_FLOPS,
                  arch.attention_bytes(h, w, clips) / HBM_BYTES_PER_S)
    return 100.0 * least_s * 1e3 / ms
