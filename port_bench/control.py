#!/usr/bin/env python3
"""The control and the planted faults of a cell, read at the cell's own size.

    python3 port_bench/control.py --workload <cell> --seeds 11 12 13

From the checkout's root, on a CUDA device (the benchmark's runs never run
this). For each seed it makes the cell's inputs as a run does (the clips,
labels and weights, without the program) and puts the reference in the
program's place in these ways, each compared with the reference in float32
by the numbers that decide `correct` (`compare.py`):
- "control": the reference computed in fp8, the precision below the
  configuration's bf16 (`reference/layers.py`: e4m3 going forward, e5m2
  gradients going back, at every place the program rounds to bf16);
- "half_batch": each microbatch's loss taken over its first half only,
  the mean over the rest;
- "state_unchanged": every step returns the state it got;
- "bf16_witness": the reference rounded to bfloat16 at the
  same places: a witness of how far bf16 alone moves each number, not a
  control.
Prints one JSON line a seed and variant; their least readings are the
upper readings the limits in `checks/<workload>.json` sit below.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from port_bench import compare, corpus  # noqa: E402
from port_bench.reference import readings, step  # noqa: E402
from port_bench.run import cell  # noqa: E402


VARIANTS = {"control": {"precision": "fp8"}, "half_batch": {"half_batch": True},
            "state_unchanged": {"frozen": True}, "bf16_witness": {"precision": "bf16"}}


def readings_of(workload: str, seed: int, device, root: Path = ROOT,
                overrides: dict | None = None) -> list[dict]:
    import torch

    from port_bench.run import deep_merge

    spec = cell(json.loads((root / "BENCHMARK.json").read_text()), workload, root)
    over = overrides or {}
    cfg = deep_merge(spec.config, over.get("config", {}))
    tr = deep_merge(spec.traffic, over.get("traffic", {}))
    cfg["seed"] = seed
    data = cfg["data"]
    length = int(data["sample_rate"] * data["duration"])
    labels = corpus.seeded_labels(tr["recordings"], seed)
    pcm = corpus.make_clips(labels, length, data["sample_rate"], seed, device)
    calib = torch.as_tensor(readings.pcm_to_float(pcm[: tr["calibration_clips"]]),
                            device=device)
    state0 = {k: v.cpu() for k, v in step.seeded_state(cfg, seed, calib).items()}
    ref = readings.train(cfg, state0, pcm, labels, seed, device)
    out = []
    for variant, kw in VARIANTS.items():
        other = readings.train(cfg, state0, pcm, labels, seed, device, **kw)
        out.append({"workload": workload, "seed": seed, "variant": variant,
                    **compare.train_numbers(other, ref),
                    "detail": compare.train_detail(other, ref)})
    return out


def main(argv=None) -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    for seed in args.seeds:
        for line in readings_of(args.workload, seed, torch.device("cuda")):
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
