"""Tests of the benchmark's harness. Those that need a CUDA card carry the
`card` marker and take the `card` fixture, which skips them where none is
visible (decided when the test runs, never at import).

    python -m pytest port_bench/tests -q          # on the CPU
    python -m pytest port_bench/tests -q -m card  # on the card
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def small() -> dict:
    """Overrides of a cell's sizes that a CPU run holds: 1 s clips, batch 4,
    fp32, a corpus of 60 recordings."""
    return {"config": {"data": {"duration": 1.0},
                       "training": {"batch_size": 4, "mixed_precision": False}},
            "traffic": {"recordings": 60, "calibration_clips": 8}}

