"""CompactResNet18, the reference's `src/models/resnet.py:8-57`, in plain PyTorch.

A torchvision resnet18 under `resnet.` with a one-channel 7x7/2 stem and a
3x3/2 max-pool, four stages of two basic blocks (64, 128, 256, 512
channels; a 1x1 projection where the shape changes), a global average pool
and the head Dropout(p) -> Dense(512-256) -> ReLU -> Dropout(p / 2) ->
Dense(256-classes). Parameter names are torchvision's, which the port keeps.
Dropout draws, in train mode, a (B, 512) mask and then a (B, 256) one.
"""

from __future__ import annotations

import torch
from torch import nn

from port_bench.counts import conv_out
from port_bench.reference.layers import Ops, batch_norm, bn, dropout

STAGES = (2, 2, 2, 2)


class _BasicBlock(nn.Module):
    def __init__(self, cin: int, c: int, stride: int):
        super().__init__()
        self.stride = stride
        self.conv1 = nn.Conv2d(cin, c, 3, stride=stride, padding=1, bias=False)
        self.bn1 = bn(c)
        self.conv2 = nn.Conv2d(c, c, 3, padding=1, bias=False)
        self.bn2 = bn(c)
        self.downsample = None
        if stride != 1 or cin != c:
            self.downsample = nn.Sequential(nn.Conv2d(cin, c, 1, stride=stride, bias=False), bn(c))

    def forward(self, x, ops: Ops, train: bool):
        y = ops.q(batch_norm(ops.conv(x, self.conv1.weight, self.stride, 1), self.bn1, train))
        y = ops.q(batch_norm(ops.conv(torch.relu(y), self.conv2.weight, 1, 1), self.bn2, train))
        if self.downsample is not None:
            x = ops.q(batch_norm(ops.conv(x, self.downsample[0].weight, self.stride, 0),
                                 self.downsample[1], train))
        return torch.relu(ops.q(y + x))


class _Trunk(nn.Module):
    def __init__(self, num_classes: int, p: float):
        super().__init__()
        self.conv1 = nn.Conv2d(1, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = bn(64)
        cin = 64
        for stage, blocks in enumerate(STAGES):
            c = 64 * 2 ** stage
            layer = []
            for block in range(blocks):
                layer.append(_BasicBlock(cin, c, 2 if stage > 0 and block == 0 else 1))
                cin = c
            self.add_module(f"layer{stage + 1}", nn.Sequential(*layer))
        self.fc = nn.Sequential(nn.Dropout(p), nn.Linear(512, 256), nn.ReLU(),
                                nn.Dropout(p / 2), nn.Linear(256, num_classes))


class Model(nn.Module):
    def __init__(self, num_classes: int, dropout: float, precision: str = "f32"):
        super().__init__()
        self.resnet = _Trunk(num_classes, dropout)
        self.p = dropout
        self.ops = Ops(precision)

    def forward(self, x: torch.Tensor, train: bool, g: torch.Generator | None = None):
        """x (B, 1, n_mels, T) -> (B, classes) logits; g draws the dropout
        masks in train mode (None: none)."""
        r, ops = self.resnet, self.ops
        x = torch.relu(ops.q(batch_norm(ops.conv(x, r.conv1.weight, 2, 3), r.bn1, train)))
        x = torch.nn.functional.max_pool2d(x, 3, stride=2, padding=1)
        for stage in range(len(STAGES)):
            for block in getattr(r, f"layer{stage + 1}"):
                x = block(x, ops, train)
        x = dropout(x.mean(dim=(2, 3)), self.p, g if train else None)
        x = torch.relu(ops.linear(x, r.fc[1]))
        x = dropout(x, self.p / 2, g if train else None)
        return ops.linear(x, r.fc[4])


def forward_gflop(h: int, w: int, classes: int = 4) -> float:
    """Forward GFLOP of one (h, w) input: 2 per multiply-add of every conv
    and dense layer, by the layer shapes (copied from
    `chip_smoke.resnet_gflop`, chip_smoke.py:2925)."""
    h, w = conv_out(h, 7, 2, 3), conv_out(w, 7, 2, 3)
    flops = 2 * h * w * 64 * 49
    h, w, cin = conv_out(h, 3, 2, 1), conv_out(w, 3, 2, 1), 64
    for stage, blocks in enumerate(STAGES):
        c = 64 * 2 ** stage
        for block in range(blocks):
            s = 2 if stage > 0 and block == 0 else 1
            h, w = conv_out(h, 3, s, 1), conv_out(w, 3, s, 1)
            flops += 2 * h * w * c * 9 * (cin + c)
            if s != 1 or cin != c:  # the 1x1 projection
                flops += 2 * h * w * c * cin
            cin = c
    return (flops + 2 * cin * 256 + 2 * 256 * classes) / 1e9


def first_layer_gflop(h: int, w: int) -> float:
    """GFLOP of the stem convolution's forward."""
    return 2 * conv_out(h, 7, 2, 3) * conv_out(w, 7, 2, 3) * 64 * 49 / 1e9
