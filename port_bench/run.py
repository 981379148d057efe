#!/usr/bin/env python3
"""Run one cell of the port's benchmark and print its result line.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the checkout's root. The cell is an entry of `workloads` in
`BENCHMARK.json`; its configuration, traffic mix, loop, limits and metric
readers are found by name under this folder (`port_bench/__init__.py`).
`--trace 0` reports the cell's end-to-end metrics, `--trace 1` its
per-layer ones. The last line of standard output is one JSON object:
correct, attempted, failed, metrics, device, with --trace 1 a breakdown,
and last `checks`, each number that decided `correct` beside its limit,
which also close standard error.

Exits non-zero, printing no result, where no CUDA device is visible or
fewer than the cell asks for, and where JAX, flax or the JAX package were
loaded in this process once the window has closed.
"""

from __future__ import annotations

import time

_T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import copy  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "audio_classification_icbhi_tpu")


def process_age_s() -> float:
    """Seconds since this process started, from /proc where it is there
    (clock ticks), else since this module was imported."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return float(Path("/proc/uptime").read_text().split()[0]) - start
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T_IMPORT


@dataclass
class Run:
    """What a loop gets: the cell, its files' contents, the run's
    arguments, and `started`, the perf_counter reading of the process's
    start."""
    workload: str
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    started: float


@dataclass
class Outcome:
    """What a loop returns. `e2e` holds the end-to-end metrics;
    `numbers` the compared numbers by name; `spans`, `trace`, `probes` and
    `info` what the per-layer readers read."""
    e2e: dict
    attempted: int
    failed: int
    memory_peak: int
    numbers: dict
    spans: object = None
    trace: dict = field(default_factory=dict)
    probes: dict = field(default_factory=dict)
    info: dict = field(default_factory=dict)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def deep_merge(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        nested = isinstance(v, dict) and isinstance(out.get(k), dict)
        out[k] = deep_merge(out[k], v) if nested else v
    return out


def by_name(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"BENCHMARK.json has no {what} named {name!r}")


@dataclass
class Cell:
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def cell(manifest: dict, workload: str, root: Path = ROOT) -> Cell:
    """A cell and everything it names, found by name."""
    bench = root / "port_bench"
    w = by_name(manifest["workloads"], workload, "workload")
    c = by_name(manifest["configs"], w["config"], "config")
    config = json.loads((root / c["file"]).read_text())["config"]
    traffic = json.loads((bench / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((bench / "checks" / f"{workload}.json").read_text())

    def mine(m):
        return "workloads" not in m or workload in m["workloads"]

    return Cell(w, config, traffic, limits,
                [m for m in manifest["end_to_end"] if mine(m)],
                [m for m in manifest["per_layer"] if mine(m)])


def reader(name: str, root: Path = ROOT):
    """The `read(run, outcome)` function of metric `name`."""
    return load_module(root / "port_bench" / "metrics" / f"{name}.py",
                       f"port_bench_metric_{name.replace('.', '_')}").read


def forbidden_modules() -> list[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def execute(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
            root: Path = ROOT, overrides: dict | None = None, started: float | None = None
            ) -> dict:
    """Run the cell and return its result line as a dict. overrides
    ({"config": ..., "traffic": ...}) are merged into the cell's
    configuration and traffic mix: the tests' small sizes."""
    import torch

    manifest = json.loads((root / "BENCHMARK.json").read_text())
    spec = cell(manifest, workload, root)
    dev = torch.device(device)
    overrides = overrides or {}
    run = Run(workload, spec.workload, deep_merge(spec.config, overrides.get("config", {})),
              deep_merge(spec.traffic, overrides.get("traffic", {})),
              int(seed), float(seconds), bool(trace), dev,
              time.perf_counter() - process_age_s() if started is None else started)
    loop = load_module(root / "port_bench" / "loops" / f"{spec.traffic['kind']}.py",
                       f"port_bench_loop_{spec.traffic['kind']}")
    out: Outcome = loop.run(run)
    metrics = {}
    for m in (spec.per_layer if trace else spec.end_to_end):
        value = reader(m["name"], root)(run, out) if trace else out.e2e.get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    checks = {k: {"value": float(v), "limit": float(spec.limits[k])}
              for k, v in out.numbers.items() if k in spec.limits}
    line = {
        "correct": bool(checks) and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                                        for c in checks.values()),
        "attempted": int(out.attempted),
        "failed": int(out.failed),
        "metrics": metrics,
        "device": {
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "count": int(spec.workload["chips"]),
            "memory_peak_bytes": int(out.memory_peak),
        },
    }
    if trace:
        line["device"]["busy_s"] = out.trace.get("busy_s", 0.0)
        line["device"]["window_s"] = out.trace.get("window_s", 0.0)
        if out.trace.get("device_ops"):
            line["breakdown"] = {"device_ops": out.trace["device_ops"],
                                 "idle_gaps": out.trace["idle_gaps"]}
    line["checks"] = checks
    return line


def power_line() -> str:
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return res.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi: not available"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    started = time.perf_counter() - process_age_s()

    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = by_name(manifest["workloads"], args.workload, "workload")["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"port_bench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 3
    try:
        import audio_classification_icbhi_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"port_bench: the port is not importable here: {e}", file=sys.stderr)
        return 3
    line = execute(args.workload, args.seed, args.seconds, bool(args.trace), started=started)
    found = forbidden_modules()
    if found:
        print(f"port_bench: loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 4
    print(f"port_bench: {power_line()}", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
