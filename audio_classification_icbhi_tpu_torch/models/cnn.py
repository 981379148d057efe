"""LightweightCNN classifier as torch nn.Modules.

Port of `audio_classification_icbhi_tpu/models/cnn.py:29-93`: five blocks of
Conv3x3 (no bias) -> BatchNorm -> ReLU -> MaxPool2 -> channel dropout with
channels 1->32->64->128->256->256, global average pool, Dense 256->128, ReLU,
dropout, Dense 128->num_classes. 1,012,068 parameters at 4 classes.

Parameter names are the reference's torch names
(`models/torch_import.py:48-64` reads them): conv{i}.conv.weight,
conv{i}.bn.{weight,bias,running_mean,running_var}, fc1, fc2.

Inputs keep the JAX package's layout, (B, n_mels, T, 1); `forward` permutes
to NCHW. With a reduced `dtype` (bf16 or fp16) the parameters stay float32
and are cast at each op, as flax does with `dtype=`: convs and dense layers
compute in `dtype`, BatchNorm normalizes in float32 and casts back, and the
logits come out float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def _conv_init(weight: torch.Tensor, generator: torch.Generator | None) -> None:
    """He normal, fan_out, untruncated (torch kaiming_normal_ mode=fan_out)."""
    fan_out = weight.shape[0] * weight.shape[2] * weight.shape[3]
    with torch.no_grad():
        weight.normal_(0.0, (2.0 / fan_out) ** 0.5, generator=generator)


class ConvBlock(nn.Module):
    """Conv3x3 (no bias) -> BatchNorm -> ReLU -> MaxPool2 -> Dropout2d."""

    def __init__(self, in_channels: int, out_channels: int, drop_rate: float = 0.2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.Conv2d(in_channels, out_channels, 3, padding=1, bias=False)
        # flax momentum=0.9 (weight of the old value) is torch momentum=0.1
        self.bn = nn.BatchNorm2d(out_channels, eps=1e-5, momentum=0.1)
        self.pool = nn.MaxPool2d(2)  # floors odd sizes, as flax max_pool does
        self.dropout = nn.Dropout2d(drop_rate)  # one mask per (sample, channel)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.conv2d(x.to(self.dtype), self.conv.weight.to(self.dtype), padding=1)
        x = self.bn(x.float()).to(self.dtype)
        return self.dropout(self.pool(F.relu(x)))


class LightweightCNN(nn.Module):
    """5-block CNN. Input (B, n_mels, T, 1); output (B, num_classes) f32 logits."""

    def __init__(self, num_classes: int = 4, dropout: float = 0.3,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        chans = (1, 32, 64, 128, 256, 256)
        for i in range(5):
            self.add_module(f"conv{i + 1}", ConvBlock(chans[i], chans[i + 1], dtype=dtype))
        self.fc1 = nn.Linear(256, 128)
        self.fc2 = nn.Linear(128, num_classes)
        self.dropout = nn.Dropout(dropout)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """He fan_out normal for convs, N(0, 0.01) for dense kernels, zero
        dense biases, BN scale 1 / bias 0 / mean 0 / var 1."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                _conv_init(m.weight, generator)
            elif isinstance(m, nn.Linear):
                with torch.no_grad():
                    m.weight.normal_(0.0, 0.01, generator=generator)
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)  # (B, H, W, C) -> (B, C, H, W)
        for i in range(5):
            x = getattr(self, f"conv{i + 1}")(x)
        x = x.mean(dim=(2, 3))  # global average pool -> (B, 256)
        dt = self.dtype
        x = F.relu(F.linear(x.to(dt), self.fc1.weight.to(dt), self.fc1.bias.to(dt)))
        x = self.dropout(x)
        x = F.linear(x, self.fc2.weight.to(dt), self.fc2.bias.to(dt))
        return x.float()


def count_parameters(model: nn.Module) -> int:
    """Trainable parameter count."""
    return sum(p.numel() for p in model.parameters() if p.requires_grad)
