"""The plain reference that decides `correct`: the front end, both
classifiers and the train step in plain PyTorch,
float32 with TF32 off (or, for the control, in fp8: `layers.py`).

It imports nothing of the port, nor JAX: it works out again, from the
benchmark's own inputs and the seed, what the program works out (the
split, the shuffle, the class weights, the augmentation and dropout draws).

A configuration's `model.architecture` names its module here,
`reference/<architecture>.py`, which provides:
- `Model(num_classes, dropout, precision)`, an `nn.Module` whose parameter
  and buffer names are the program's state_dict names, with
  `forward(x, train, g)`: x (B, 1, n_mels, T) normalized log-mel images ->
  (B, classes) logits, its train-mode dropout drawn from the generator g
  in the program's order (g None: none), rounding through `layers.Ops` at
  the places the program rounds;
- `forward_gflop(h, w, classes)`, the forward GFLOP of one (h, w) input,
  and `first_layer_gflop(h, w)`, the first layer's (whose input gradient a
  train step does not take);
- the output layer as its last 2-D parameter (`compare.output_gap`, and the
  weights' N(0, 1 / fan_in));
- parameters owned by `nn.Conv2d`, `nn.Linear`, `nn.BatchNorm2d` (`layers.bn`)
  or `nn.LayerNorm` where they are such layers, since the seeded weights'
  rules go by the owning module (`step.seeded_state`): dense weights
  He-normal, their biases N(0, 0.05²), norm scales 1 + N(0, 0.1²) and
  shifts N(0, 0.1²), any other parameter (a positional table, a token)
  N(0, 0.02²). BatchNorm running statistics are calibrated, and compared
  (`stats3_*`), only where the model has BatchNorms.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_f32():
    """TF32 off for cuBLAS and cuDNN inside the block, restored after it."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
