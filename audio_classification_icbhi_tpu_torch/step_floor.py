"""The bound two runs of one train step are held to.

At lr 1 with SGD the parameter change of a step is its accumulated, clipped
gradient, and ReLU and max-pool make that gradient jump where one of their
inputs lies within rounding of a tie: two correct implementations (the port
and the JAX package, or the card and the CPU) may then differ by far more
than their rounding. The bound measures how far rounding alone moves the
port's own step on the same inputs: the step is run again with the plain
front end's log-mel perturbed by seeded uniform noise of +-1e-5 dB (as far
from the function as the card's kernels are), once for each seed in
FLOOR_SEEDS, and the floor is the element-wise maximum of how far those
runs moved each parameter, and the global gradient norm. One seed alone is
not enough: whether its draw flips a near-tie input decides whether it
moves the step at all.

A parameter tensor is held element by element to |got - want| <=
2e-3 |want| + max(2e-5, 2 f), where f is the largest floor in that tensor:
which near-tie inputs flip differs between two runs (the card's convs
round otherwise than the CPU's), so an element the perturbations left
still may move where its neighbours in the tensor moved. The gradient norm
is held to |got - want| <= max(1e-5 want, 2 f_norm).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from audio_classification_icbhi_tpu_torch.ops.mel import MelFrontend

FLOOR_SEEDS = tuple(range(8))
FLOOR_EPS_DB = 1e-5
PARAM_RTOL, PARAM_ATOL, GRAD_NORM_RTOL = 2e-3, 2e-5, 1e-5

# One run of a step: (its parameters after the step, one float64 array per
# tensor, in a fixed order; its global gradient norm).
StepResult = tuple[Sequence[np.ndarray], float]


class PerturbedPlainFrontend(MelFrontend):
    """A front end with seeded uniform noise of +-`eps` dB on its plain
    log-mel. It perturbs only the plain chain, so give it CPU tensors."""

    @classmethod
    def of(cls, frontend: MelFrontend, eps: float, seed: int) -> "PerturbedPlainFrontend":
        out = cls.__new__(cls)
        out.__dict__.update(vars(frontend))
        out.eps, out.generator = eps, torch.Generator().manual_seed(seed)
        return out

    def log_mel(self, waveform: torch.Tensor) -> torch.Tensor:
        db = super().log_mel(waveform)
        noise = torch.rand(db.shape, generator=self.generator, dtype=db.dtype)
        return db + self.eps * (2.0 * noise - 1.0)


class StepFloor(NamedTuple):
    params: list[np.ndarray]  # per tensor, element by element
    grad_norm: float


class StepMargins(NamedTuple):
    """Each check's worst |got - want| over its bound: a step passes when
    both are at most 1."""
    params: float
    grad_norm: float

    @property
    def ok(self) -> bool:
        return self.params <= 1.0 and self.grad_norm <= 1.0


def step_floor(step: Callable[[MelFrontend], StepResult], frontend: MelFrontend,
               base: StepResult, seeds=FLOOR_SEEDS, eps: float = FLOOR_EPS_DB) -> StepFloor:
    """`step(frontend)` runs the step from fixed weights and inputs on the
    CPU; `base` is what it returns for `frontend` itself. The floor is the
    element-wise maximum over `seeds` of |perturbed - base|."""
    params = [np.zeros(np.shape(b), np.float64) for b in base[0]]
    grad_norm = 0.0
    for seed in seeds:
        p, g = step(PerturbedPlainFrontend.of(frontend, eps, seed))
        params = [np.maximum(f, np.abs(np.asarray(x, np.float64) - b))
                  for f, x, b in zip(params, p, base[0])]
        grad_norm = max(grad_norm, abs(float(g) - float(base[1])))
    return StepFloor(params, grad_norm)


def step_margins(got: StepResult, want: StepResult, floor: StepFloor) -> StepMargins:
    """`got` and `want` are two runs of one step; `floor` is `step_floor`'s
    for the same step."""
    params = 0.0
    for g, w, f in zip(got[0], want[0], floor.params, strict=True):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        excess = np.maximum(np.abs(g - w) - PARAM_RTOL * np.abs(w), 0.0)
        bound = max(PARAM_ATOL, 2.0 * float(f.max(initial=0.0)))
        params = max(params, float(excess.max(initial=0.0)) / bound)
    want_gn = float(want[1])
    grad_norm = abs(float(got[1]) - want_gn) / max(GRAD_NORM_RTOL * want_gn, 2.0 * floor.grad_norm)
    return StepMargins(params, grad_norm)


def param_arrays(model: torch.nn.Module) -> list[np.ndarray]:
    """The model's parameters in named_parameters() order, each as a
    float64 array on the host."""
    return [p.detach().cpu().double().numpy() for _, p in model.named_parameters()]
