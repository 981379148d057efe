"""The plain reference that decides `correct`: the front end, both
classifiers and the train step in plain PyTorch,
float32 with TF32 off (or, for the control, in fp8: `layers.py`).

It imports nothing of the port, nor JAX: it works out again, from the
benchmark's own inputs and the seed, what the program works out (the
split, the shuffle, the class weights, the augmentation and dropout draws).
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
