"""LightweightCNN, the reference's `src/models/cnn.py:33-103`, in plain PyTorch.

Five blocks of conv3x3 (no bias) -> BatchNorm -> ReLU -> max-pool 2 ->
channel dropout 0.2, channels 1-32-64-128-256-256, a global average pool,
Dense 256-128, ReLU, dropout p, Dense 128-classes. Parameter names are the
reference's torch names, which the port keeps. Dropout draws, in train
mode, one (B, C) mask after each block and one (B, 128) mask in the head,
in that order.
"""

from __future__ import annotations

import torch
from torch import nn

from port_bench.counts import conv_out
from port_bench.reference.layers import Ops, batch_norm, bn, dropout

CHANNELS = (1, 32, 64, 128, 256, 256)
BLOCK_DROPOUT = 0.2


class _Block(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3, padding=1, bias=False)
        self.bn = bn(cout)


class Model(nn.Module):
    def __init__(self, num_classes: int, dropout: float, precision: str = "f32"):
        super().__init__()
        for i in range(5):
            self.add_module(f"conv{i + 1}", _Block(CHANNELS[i], CHANNELS[i + 1]))
        self.fc1 = nn.Linear(256, 128)
        self.fc2 = nn.Linear(128, num_classes)
        self.p = dropout
        self.ops = Ops(precision)

    def forward(self, x: torch.Tensor, train: bool, g: torch.Generator | None = None):
        """x (B, 1, n_mels, T) -> (B, classes) logits; g draws the dropout
        masks in train mode (None: none)."""
        for i in range(5):
            block = getattr(self, f"conv{i + 1}")
            x = self.ops.conv(x, block.conv.weight, padding=1)
            x = torch.max_pool2d(torch.relu(self.ops.q(batch_norm(x, block.bn, train))), 2)
            x = dropout(x, BLOCK_DROPOUT, g if train else None, per_channel=True)
        x = torch.relu(self.ops.linear(x.mean(dim=(2, 3)), self.fc1))
        x = dropout(x, self.p, g if train else None)
        return self.ops.linear(x, self.fc2)


def forward_gflop(h: int, w: int, classes: int = 4) -> float:
    """Forward GFLOP of one (h, w) input: 2 per multiply-add of the five
    convolutions (copied from `chip_smoke.cnn_conv_gflop`, chip_smoke.py:2941)
    and of the two dense layers."""
    flops = 0
    for i in range(5):
        flops += 2 * h * w * CHANNELS[i] * CHANNELS[i + 1] * 9
        h, w = h // 2, w // 2
    return (flops + 2 * 256 * 128 + 2 * 128 * classes) / 1e9


def first_layer_gflop(h: int, w: int) -> float:
    """GFLOP of the first convolution's forward."""
    return 2 * conv_out(h, 3, 1, 1) * conv_out(w, 3, 1, 1) * CHANNELS[1] * 9 / 1e9
