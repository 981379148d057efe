"""CompactResNet18 classifier as torch nn.Modules.

Port of `audio_classification_icbhi_tpu/models/resnet.py:25-105`: ResNet18
(BasicBlock x stage_sizes, channels 64/128/256/512), a single-channel 7x7/2
stem with a 3x3/2 max-pool, global average pool and the 2-layer head
Dropout(p) -> Dense(512->256) -> ReLU -> Dropout(p/2) -> Dense(256->classes).
11,302,596 parameters at 4 classes.

Parameter names are the reference's torch names: its CompactResNet holds a
torchvision resnet18 under `resnet.` (`resnet.conv1`, `resnet.bn1`,
`resnet.layer{1-4}.{0,1}.{conv1,bn1,conv2,bn2}`,
`resnet.layer{2-4}.0.downsample.{0,1}`) with the head
`resnet.fc = Sequential(Dropout, Linear, ReLU, Dropout, Linear)`, whose
Linears are `resnet.fc.1` and `resnet.fc.4`. A reference `.pt` loads as it
is (`models/torch_import.py`).

Precision follows flax with `dtype=`, as LightweightCNN's does: parameters
stay float32, convs and dense layers compute in `dtype`, BatchNorm
normalizes in float32 and returns `dtype` before the residual add, so
`relu(y + residual)` runs in `dtype`; the global mean sums in float32 and
casts back; the logits come out float32. Train mode uses the shared flax
BatchNorm (`models/cnn.BatchNorm`; cross-rank when `axis_name` is a process
group, as flax's `axis_name`) and draws its per-unit head dropout from the
`generator` passed to `forward`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from audio_classification_icbhi_tpu_torch.models.cnn import BatchNorm, dropout, init_weights


class BasicBlock(nn.Module):
    """ResNet-v1 basic block: two 3x3 convs and an identity or 1x1
    projection skip (torchvision's names)."""

    def __init__(self, in_channels: int, features: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32, axis_name=None):
        super().__init__()
        self.dtype = dtype
        self.stride = stride
        self.conv1 = nn.Conv2d(in_channels, features, 3, stride=stride, padding=1, bias=False)
        self.bn1 = BatchNorm(features, group=axis_name)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1, bias=False)
        self.bn2 = BatchNorm(features, group=axis_name)
        self.downsample = None
        if stride != 1 or in_channels != features:
            # flax's default SAME padding is no padding for a 1x1 kernel
            self.downsample = nn.Sequential(
                nn.Conv2d(in_channels, features, 1, stride=stride, bias=False),
                BatchNorm(features, group=axis_name))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        y = F.conv2d(x, self.conv1.weight.to(dt), stride=self.stride, padding=1)
        y = F.relu(self.bn1(y))
        y = self.bn2(F.conv2d(y, self.conv2.weight.to(dt), padding=1))
        residual = x
        if self.downsample is not None:
            conv, bn = self.downsample
            residual = bn(F.conv2d(x, conv.weight.to(dt), stride=self.stride))
        return F.relu(y + residual)


class ResNet18(nn.Module):
    """The torchvision-shaped trunk and head the reference wraps as
    `CompactResNet.resnet`. Input NCHW in `dtype`; output f32 logits."""

    def __init__(self, num_classes: int, dropout: float, stage_sizes: tuple,
                 dtype: torch.dtype, axis_name=None):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(1, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm(64, group=axis_name)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)  # pads with -inf, as flax
        in_channels = 64
        for stage, num_blocks in enumerate(stage_sizes):
            features = 64 * 2 ** stage
            blocks = []
            for block in range(num_blocks):
                stride = 2 if stage > 0 and block == 0 else 1
                blocks.append(BasicBlock(in_channels, features, stride, dtype, axis_name))
                in_channels = features
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
        self.num_stages = len(stage_sizes)
        self.fc = nn.Sequential(nn.Dropout(dropout), nn.Linear(in_channels, 256), nn.ReLU(),
                                nn.Dropout(dropout / 2), nn.Linear(256, num_classes))

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        dt = self.dtype
        x = F.conv2d(x.to(dt), self.conv1.weight.to(dt), stride=2, padding=3)
        x = self.maxpool(F.relu(self.bn1(x)))
        for stage in range(self.num_stages):
            x = getattr(self, f"layer{stage + 1}")(x)
        x = x.float().mean(dim=(2, 3)).to(dt)  # global average pool, summed in f32
        drop0, dense0, _, drop1, dense1 = self.fc  # per unit, masks from `generator`
        if self.training:
            x = dropout(x, drop0.p, generator)
        x = F.relu(F.linear(x, dense0.weight.to(dt), dense0.bias.to(dt)))
        if self.training:
            x = dropout(x, drop1.p, generator)
        x = F.linear(x, dense1.weight.to(dt), dense1.bias.to(dt))
        return x.float()


class CompactResNet(nn.Module):
    """ResNet18 with a 1-channel stem and a 2-layer dropout head. Input
    (B, n_mels, T, 1); output (B, num_classes) f32 logits."""

    def __init__(self, num_classes: int = 4, dropout: float = 0.3,
                 dtype: torch.dtype = torch.float32, stage_sizes: tuple = (2, 2, 2, 2),
                 generator: torch.Generator | None = None, axis_name=None):
        super().__init__()
        self.dtype = dtype
        self.axis_name = axis_name
        self.resnet = ResNet18(num_classes, dropout, tuple(stage_sizes), dtype, axis_name)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        init_weights(self, generator)

    def set_dropout(self, p: float) -> None:
        """Set the head's dropout: `p` before the first dense layer, `p/2`
        before the second (p = 0 makes train mode deterministic)."""
        self.resnet.fc[0].p, self.resnet.fc[3].p = p, p / 2

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        """In train mode the dropout masks come from `generator`."""
        return self.resnet(x.permute(0, 3, 1, 2), generator)
