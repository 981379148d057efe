"""The control of every cell, on the card at the cell's own size: the
reference put in the program's place computed in fp8, and for train cells
the planted faults (half of each microbatch left out of the loss, a step
that returns its state unchanged), must each fail at least one of the
cell's limits, on three seeds; the bf16 witness must fail none.

    python -m pytest port_bench/tests/test_port_bench_card.py -q -m card
"""

from __future__ import annotations

import json
from pathlib import Path

import pytest

from port_bench import control

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MANIFEST["workloads"]]  # the benchmark's cells
SEEDS = (2**31 + 11, 2**31 + 12, 2**31 + 13)


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_a_limit(workload, card):
    limits = json.loads((ROOT / "port_bench" / "checks" / f"{workload}.json").read_text())
    for seed in SEEDS:
        for reading in control.readings_of(workload, seed, card):
            failed = [k for k, limit in limits.items() if reading[k] > limit]
            assert bool(failed) == (reading["variant"] != "bf16_witness"), reading
