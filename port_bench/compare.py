"""The numbers that decide `correct`, each taken between the program's
reading and the plain reference's.

Train cells (the first three optimizer steps of the run, which set-up
drives through the window's own call):
- loss1_gap: the relative gap of the first step's loss;
- loss_gap: the largest relative gap of the three steps' losses;
- grad1_gap: by the worst leaf, the gap between the norms of the first
  gradient as Adam takes it, over the larger of that leaf's reference norm
  and the median leaf's;
- update3_gap: the same for each leaf's change after three steps, leaving
  out leaves whose first reference gradient is under a thousandth of the
  median leaf's (they move under Adam by round-off alone);
- grad1_median_gap, update3_median_gap: the median leaf's relative gap of
  the same two norms, steady from seed to seed where the worst leaf swings;
- grad1_direction_gap: the median leaf's ‖p − r‖ / ‖r‖ of the first
  gradient itself; grad1_output_gap: the same of the output layer's
  weight;
- stats3_gap, stats3_median_gap: the same two for the change of each
  BatchNorm running mean and variance after three steps, where the model
  has running statistics (absent, not NaN, where it has none);
- val_batch_gap: the root mean square over the validation batches of each
  batch's relative loss gap, at the initial weights.
"""

from __future__ import annotations

import math

import numpy as np


def rel_gap(program: float, reference: float) -> float:
    if not math.isfinite(program):
        return math.inf
    return abs(program - reference) / max(abs(reference), 1e-30)


def leaf_gap(program: dict[str, float], reference: dict[str, float],
             leaves: list[str] | None = None) -> float:
    """max over leaves of |‖p‖ − ‖r‖| / max(‖r‖, median ‖r‖)."""
    leaves = list(reference) if leaves is None else leaves
    median = float(np.median([reference[k] for k in reference]))
    worst = 0.0
    for k in leaves:
        p = program[k]
        if not math.isfinite(p):
            return math.inf
        worst = max(worst, abs(p - reference[k]) / max(reference[k], median, 1e-30))
    return worst


def median_leaf_gap(program: dict[str, float], reference: dict[str, float],
                    leaves: list[str] | None = None) -> float:
    """The median over leaves of |‖p‖ − ‖r‖| / ‖r‖: a number that moves
    with the precision of every leaf, not with the noise of one."""
    leaves = list(reference) if leaves is None else leaves
    gaps = [abs(program[k] - reference[k]) / max(reference[k], 1e-30) for k in leaves]
    return math.inf if not all(map(math.isfinite, gaps)) else float(np.median(gaps))


def direction_gap(program: dict, reference: dict) -> float:
    """The median over leaves of ‖p − r‖ / ‖r‖ of the first gradient's
    tensors: where the norms agree it still sees a gradient of other rows
    or another loss."""
    gaps = []
    for k, r in reference.items():
        p = program[k].double()
        r = r.double()
        gaps.append(float((p - r).norm() / r.norm().clamp_min(1e-30)))
    return math.inf if not all(map(math.isfinite, gaps)) else float(np.median(gaps))


def output_gap(program: dict, reference: dict) -> float:
    """‖p − r‖ / ‖r‖ of the output layer's weight (the last 2-D leaf): a
    gradient that no max-pool routes, so it moves with the precision of
    the forward alone."""
    k = [k for k, r in reference.items() if r.ndim == 2][-1]
    p, r = program[k].double(), reference[k].double()
    gap = float((p - r).norm() / r.norm().clamp_min(1e-30))
    return gap if math.isfinite(gap) else math.inf


def moving_leaves(grad1_reference: dict[str, float]) -> list[str]:
    """Leaves whose first reference gradient is at least a thousandth of
    the median leaf's."""
    median = float(np.median(list(grad1_reference.values())))
    return [k for k, v in grad1_reference.items() if v >= 1e-3 * median]


def train_numbers(program: dict, reference: dict) -> dict[str, float]:
    """program and reference: {"losses": [3], "grad1": {leaf: norm},
    "grad1_tensors": {leaf: tensor}, "change": {leaf: norm}, "stats":
    {running statistic: norm of its change}, "val_losses": [one a
    validation batch]}. The stats3 numbers only where the reference has
    running statistics."""
    numbers = {
        "loss1_gap": rel_gap(program["losses"][0], reference["losses"][0]),
        "loss_gap": max(rel_gap(p, r) for p, r in zip(program["losses"], reference["losses"])),
        "grad1_gap": leaf_gap(program["grad1"], reference["grad1"]),
        "update3_gap": leaf_gap(program["change"], reference["change"],
                                moving_leaves(reference["grad1"])),
        "grad1_median_gap": median_leaf_gap(program["grad1"], reference["grad1"]),
        "grad1_direction_gap": direction_gap(program["grad1_tensors"],
                                             reference["grad1_tensors"]),
        "grad1_output_gap": output_gap(program["grad1_tensors"], reference["grad1_tensors"]),
        "update3_median_gap": median_leaf_gap(program["change"], reference["change"],
                                              moving_leaves(reference["grad1"])),
    }
    if reference["stats"]:
        numbers["stats3_gap"] = leaf_gap(program["stats"], reference["stats"])
        numbers["stats3_median_gap"] = median_leaf_gap(program["stats"], reference["stats"])
    numbers["val_batch_gap"] = float(np.sqrt(np.mean([
        rel_gap(p, r) ** 2 for p, r in zip(program["val_losses"], reference["val_losses"])])))
    return numbers


def train_detail(program: dict, reference: dict, top: int = 3) -> dict:
    """What stands behind `train_numbers`: each step's loss gap and the
    worst leaves of the leaf gaps."""
    def worst(key, leaves):
        ref = reference[key]
        median = float(np.median(list(ref.values())))
        gaps = {k: abs(program[key][k] - ref[k]) / max(ref[k], median, 1e-30) for k in leaves}
        return sorted(([k, g, program[key][k], ref[k]] for k, g in gaps.items()),
                      key=lambda x: -x[1])[:top]

    detail = {"step_loss_gaps": [rel_gap(p, r) for p, r in
                                 zip(program["losses"], reference["losses"])],
              "grad1_worst": worst("grad1", list(reference["grad1"])),
              "update3_worst": worst("change", moving_leaves(reference["grad1"]))}
    if reference["stats"]:
        detail["stats3_worst"] = worst("stats", list(reference["stats"]))
    return detail
