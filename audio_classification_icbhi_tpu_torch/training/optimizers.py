"""Optimizers with the JAX package's weight-decay placement.

Port of `audio_classification_icbhi_tpu/training/optimizers.py:19-37` onto
torch.optim, whose update rules are the ones the optax chains there were
built to match:

- adam: L2 added to the gradient before the moments (torch Adam's
  weight_decay);
- adamw: decoupled decay (torch AdamW, with the decay given explicitly:
  torch's default is 1e-2, optax's chain has none unless asked);
- anything else: SGD with momentum 0.9, no nesterov, L2 before the momentum.

The learning rate is set on every param group by the train step from the
per-epoch scheduler (`parallel/data_parallel.make_step_fns`). Given
`model.named_parameters()`, the optimizer keeps the names (torch's
`param_names`), which the checkpoint bridge matches by
(`models/weights.optax_from_opt_state`).

`capturable=True` keeps Adam's and AdamW's step count on the parameters'
device and lets them take the learning rate as a device tensor, as a step
captured in a CUDA graph needs (the fused multi-step epoch); the update is
the same. SGD has no step count and captures as it is, its rate baked in.
"""

from __future__ import annotations

from typing import Iterable

import torch


def build_optimizer(name: str,
                    params: Iterable[torch.nn.Parameter] | Iterable[tuple[str, torch.nn.Parameter]],
                    weight_decay: float = 0.0, capturable: bool = False) -> torch.optim.Optimizer:
    name = (name or "adam").lower()
    params = list(params)
    if name == "adam":
        return torch.optim.Adam(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=weight_decay, capturable=capturable)
    if name == "adamw":
        return torch.optim.AdamW(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=weight_decay, capturable=capturable)
    return torch.optim.SGD(params, lr=0.0, momentum=0.9, nesterov=False,
                           weight_decay=weight_decay)
