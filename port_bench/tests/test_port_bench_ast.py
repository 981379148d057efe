"""The AST cell, `ast-train-epochs`, on the CPU at the `small` sizes (1 s
clips: 12 x 9 patches, 110 tokens, at AST's published widths): faults
planted in the port's AST (`models/ast.py`) each make the run not
`correct`. (The sound run and the harness's own faults are
`test_port_bench_faults.py`'s cases of this cell.)"""

from __future__ import annotations

import math

import pytest
import torch

from port_bench import run

SEED = 2**31 + 1234
CELL = "ast-train-epochs"


def _attention_scale(monkeypatch):
    """The softmax scale 1 / d in place of 1 / √d."""
    from audio_classification_icbhi_tpu_torch.models import ast

    def scaled(q, k, v):
        p = torch.softmax(q @ k.transpose(-1, -2) / q.shape[-1], dim=-1)
        return p @ v

    monkeypatch.setattr(ast, "attention", scaled)


def _crop_shifted(monkeypatch):
    """The positional table's time columns taken one to the right."""
    from audio_classification_icbhi_tpu_torch.models import ast

    monkeypatch.setattr(ast, "crop_start", lambda t: ast.T_TABLE // 2 - t // 2 + 1)


def _distillation_token_left_out(monkeypatch):
    """The head reads the class token's row alone, not the mean of the
    class and distillation tokens'."""
    from audio_classification_icbhi_tpu_torch.models import ast

    def head(self, x):
        x = ast._norm(x[:, :1], self.v.norm)[:, 0]
        return ast._linear(ast._norm(x, self.mlp_head[0]), self.mlp_head[1], self.dtype).float()

    monkeypatch.setattr(ast.AST, "head", head)


FAULTS = {"attention_scale": _attention_scale, "crop_shifted": _crop_shifted,
          "distillation_token_left_out": _distillation_token_left_out}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_ast_fault_is_not_correct(fault, small, monkeypatch):
    FAULTS[fault](monkeypatch)
    line = run.execute(CELL, SEED, 0.3, False, device="cpu", overrides=small)
    assert not line["correct"], line["checks"]
    assert all(math.isfinite(c["value"]) for c in line["checks"].values())
