"""Host-side per-epoch LR schedules.

A copy of `audio_classification_icbhi_tpu/training/schedules.py` (pure
Python): cosine, step, plateau, constant and linear warmup, with their
state_dicts, `restore_scheduler` and `build_scheduler`. They match torch's
schedulers stepped once per epoch; the train step sets the scheduler's lr
on the optimizer's param groups.
"""

from __future__ import annotations

import math


class CosineAnnealingLR:
    """torch CosineAnnealingLR(T_max=epochs): lr_e = min + (lr0-min)/2 *
    (1 + cos(pi * e / T_max))."""

    def __init__(self, base_lr: float, t_max: int, eta_min: float = 0.0):
        self.base_lr = base_lr
        self.t_max = max(t_max, 1)
        self.eta_min = eta_min
        self._epoch = 0

    @property
    def lr(self) -> float:
        return self.eta_min + (self.base_lr - self.eta_min) * 0.5 * (
            1 + math.cos(math.pi * self._epoch / self.t_max)
        )

    def step(self, metric: float | None = None) -> None:
        self._epoch += 1

    def state_dict(self) -> dict:
        return {"epoch": self._epoch}

    def load_state_dict(self, state: dict) -> None:
        self._epoch = int(state["epoch"])


class StepLR:
    """torch StepLR(step_size=30, gamma=0.1) (reference trainer_fixed.py:87-90)."""

    def __init__(self, base_lr: float, step_size: int = 30, gamma: float = 0.1):
        self.base_lr = base_lr
        self.step_size = step_size
        self.gamma = gamma
        self._epoch = 0

    @property
    def lr(self) -> float:
        return self.base_lr * self.gamma ** (self._epoch // self.step_size)

    def step(self, metric: float | None = None) -> None:
        self._epoch += 1

    def state_dict(self) -> dict:
        return {"epoch": self._epoch}

    def load_state_dict(self, state: dict) -> None:
        self._epoch = int(state["epoch"])


class ReduceLROnPlateau:
    """torch ReduceLROnPlateau(mode, factor=0.5, patience=10)
    (reference trainer_fixed.py:83-86; mode='max' in trainer_icbhi.py:86-87),
    including torch's default threshold=1e-4 in 'rel' mode: a sub-0.01%%
    relative improvement still counts as a bad epoch, so near-flat metrics
    trigger the LR cut after `patience` epochs like the reference."""

    def __init__(
        self,
        base_lr: float,
        mode: str = "min",
        factor: float = 0.5,
        patience: int = 10,
        min_lr: float = 0.0,
        threshold: float = 1e-4,
    ):
        self._lr = base_lr
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.threshold = threshold
        self.best: float | None = None
        self.bad_epochs = 0

    @property
    def lr(self) -> float:
        return self._lr

    def _is_better(self, metric: float) -> bool:
        if self.best is None:
            return True
        if self.mode == "min":
            return metric < self.best * (1.0 - self.threshold)
        return metric > self.best * (1.0 + self.threshold)

    def step(self, metric: float | None = None) -> None:
        if metric is None:
            return
        if self._is_better(metric):
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self._lr = max(self._lr * self.factor, self.min_lr)
                self.bad_epochs = 0

    def state_dict(self) -> dict:
        # msgpack has no None: encode "no best yet" as NaN
        return {
            "lr": float(self._lr),
            "best": float("nan") if self.best is None else float(self.best),
            "bad_epochs": int(self.bad_epochs),
        }

    def load_state_dict(self, state: dict) -> None:
        self._lr = float(state["lr"])
        best = float(state["best"])
        self.best = None if math.isnan(best) else best
        self.bad_epochs = int(state["bad_epochs"])


class ConstantLR:
    def __init__(self, base_lr: float):
        self._lr = base_lr

    @property
    def lr(self) -> float:
        return self._lr

    def step(self, metric: float | None = None) -> None:
        pass

    def state_dict(self) -> dict:
        return {}

    def load_state_dict(self, state: dict) -> None:
        pass


class LinearWarmup:
    """Linear LR warmup over the first warmup_epochs epochs, wrapping any
    base scheduler (framework extension — the reference has no warmup;
    config training.warmup_epochs, default 0 = off). At 0-based epoch e:
    lr = base.lr * min(1, (e+1)/warmup_epochs). Useful against the
    cold-start collapse weighted CE can hit on hard, skewed data."""

    def __init__(self, base, warmup_epochs: int):
        self.base = base
        self.warmup_epochs = max(int(warmup_epochs), 1)
        self._epoch = 0

    @property
    def lr(self) -> float:
        scale = min(1.0, (self._epoch + 1) / self.warmup_epochs)
        return self.base.lr * scale

    def step(self, metric: float | None = None) -> None:
        self._epoch += 1
        self.base.step(metric)

    def state_dict(self) -> dict:
        return {"warmup_epoch": self._epoch, "base": self.base.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        if "warmup_epoch" not in state:
            # checkpoint saved before warmup was enabled: the state is the
            # bare base scheduler's; past-warmup epochs resume correctly by
            # setting _epoch from the base's epoch counter (plateau carries
            # no epoch — warmup restarts, which only scales the first
            # warmup_epochs epochs)
            self.base.load_state_dict(state)
            self._epoch = int(state.get("epoch", 0))
            return
        self._epoch = int(state["warmup_epoch"])
        self.base.load_state_dict(state["base"])


def restore_scheduler(scheduler, state: dict) -> None:
    """Shape-tolerant scheduler restore: a checkpoint saved with warmup
    enabled (state = {warmup_epoch, base}) restoring into a non-warmup
    scheduler unwraps the base state; the converse (bare base state into a
    LinearWarmup) is handled by LinearWarmup.load_state_dict. Keeps resume
    working when training.warmup_epochs is toggled between save and resume."""
    if "warmup_epoch" in state and not isinstance(scheduler, LinearWarmup):
        state = state["base"]
    scheduler.load_state_dict(state)


def build_scheduler(name: str | None, base_lr: float, epochs: int, *,
                    plateau_mode: str = "min", warmup_epochs: int = 0):
    """Scheduler factory keyed by config['training']['scheduler']
    (reference trainer_fixed.py:78-92); warmup_epochs > 0 wraps the result
    in LinearWarmup."""
    name = (name or "").lower()
    if name == "cosine":
        sched = CosineAnnealingLR(base_lr, t_max=epochs)
    elif name == "plateau":
        sched = ReduceLROnPlateau(base_lr, mode=plateau_mode)
    elif name == "step":
        sched = StepLR(base_lr)
    else:
        sched = ConstantLR(base_lr)
    if warmup_epochs:
        return LinearWarmup(sched, warmup_epochs)
    return sched
