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

Train mode follows flax (`cnn.py:52-62` of the JAX package), not torch's
defaults:

- BatchNorm normalizes with the batch mean and the biased batch variance,
  and updates its running statistics as `new = 0.9·old + 0.1·batch` with the
  biased variance too (torch's own BatchNorm would store the unbiased one,
  n/(n−1) too large);
- dropout masks are drawn from the `generator` passed to `forward`: one
  mask per (sample, channel) after each block (flax `broadcast_dims=(1, 2)`),
  one per unit before the last dense layer, survivors scaled by 1/(1−p).

`axis_name` is the data-parallel process group (`parallel/mesh.Mesh.group`)
or None, as flax's `axis_name="data"` or None: with a group, train-mode
BatchNorm normalizes with the statistics of the global batch over every
rank (`cnn.py:52-57` of the JAX package).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from audio_classification_icbhi_tpu_torch.ops.conv_epilogue import conv_epilogue


def _conv_init(weight: torch.Tensor, generator: torch.Generator | None) -> None:
    """He normal, fan_out, untruncated (torch kaiming_normal_ mode=fan_out)."""
    fan_out = weight.shape[0] * weight.shape[2] * weight.shape[3]
    with torch.no_grad():
        weight.normal_(0.0, (2.0 / fan_out) ** 0.5, generator=generator)


def init_weights(model: nn.Module, generator: torch.Generator | None = None) -> None:
    """Both classifiers' init: He fan_out normal for convs, N(0, 0.01) for
    dense kernels, zero dense biases, BN scale 1 / bias 0 / mean 0 / var 1."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            _conv_init(m.weight, generator)
        elif isinstance(m, nn.Linear):
            with torch.no_grad():
                m.weight.normal_(0.0, 0.01, generator=generator)
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()


def keep_mask(shape, p: float, generator: torch.Generator | None,
              device: torch.device) -> torch.Tensor:
    """The keep mask of dropout at rate p, drawn from `generator`."""
    return torch.rand(shape, generator=generator, device=device) < 1.0 - p


def dropout(x: torch.Tensor, p: float, generator: torch.Generator | None,
            per_channel: bool = False) -> torch.Tensor:
    """Inverted dropout with its mask drawn from `generator` (on x's
    device): flax `nn.Dropout` semantics. per_channel keeps one mask per
    (sample, channel) of an NCHW tensor."""
    if p == 0.0:
        return x
    keep = keep_mask(x.shape[:2] + (1, 1) if per_channel else x.shape, p, generator, x.device)
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype, device=x.device))


class _PlainBatchNormOps:
    """The five per-channel ops that torch's nn.SyncBatchNorm is built on
    (`torch.batch_norm_stats` and the rest, fused kernels that exist for
    CUDA tensors only), with the same signatures and results, for CPU
    tensors. The per-rank variance is recovered from invstd, as the CUDA
    gather does."""

    @staticmethod
    def batch_norm_stats(x, eps):
        var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
        return mean, torch.rsqrt(var + eps)

    @staticmethod
    def batch_norm_gather_stats_with_counts(x, means, invstds, running_mean, running_var,
                                            momentum, eps, counts):
        """(Without running statistics to update, as SyncBatchNorm calls it.)"""
        counts = counts[:, None]
        total = counts.sum()
        mean = (counts * means).sum(0) / total
        var = (counts * (invstds.pow(-2) - eps + (means - mean) ** 2)).sum(0) / total
        return mean, torch.rsqrt(var + eps)

    @staticmethod
    def batch_norm_elemt(x, weight, bias, mean, invstd, eps):
        a = invstd * weight
        return torch.addcmul((bias - mean * a)[:, None, None], x, a[:, None, None])

    @staticmethod
    def batch_norm_backward_reduce(dy, x, mean, invstd, weight, input_g, weight_g, bias_g):
        sum_dy = dy.sum((0, 2, 3))
        sum_dy_xmu = (dy * (x - mean[:, None, None])).sum((0, 2, 3))
        return sum_dy, sum_dy_xmu, sum_dy_xmu * invstd, sum_dy

    @staticmethod
    def batch_norm_backward_elemt(dy, x, mean, invstd, weight, sum_dy, sum_dy_xmu, counts):
        total = counts.sum()
        a = invstd * weight
        b = -a * invstd * invstd * sum_dy_xmu / total
        return torch.addcmul(torch.addcmul((-a * sum_dy / total - mean * b)[:, None, None],
                                           x, b[:, None, None]), dy, a[:, None, None])


class SyncBatchNorm(torch.autograd.Function):
    """Train-mode BatchNorm of an NCHW f32 tensor over the global batch of
    every rank in `bn.group`, with its backward written out; it updates
    `bn`'s running statistics flax's way.

    It is torch's nn.SyncBatchNorm algorithm on the same fused per-channel
    ops (`_PlainBatchNormOps` on the CPU). Forward: each rank's per-channel
    (mean, invstd, n) is all-gathered once and merged into the global mean
    and biased variance; the output is (x − mean)·invstd·w + bias.

    Backward: each rank's loss is its share of the global one and the
    trainer sums the ranks' parameter gradients, so every rank's share
    depends on the global statistics. The rank's Σdy and Σdy·(x − mean)
    are all-reduced (the cotangent of the statistics, summed over the
    ranks), and dx = w·invstd·(dy − ΣΣdy / Σn − (x − mean)·invstd²·
    ΣΣdy(x − mean) / Σn); the weight and bias gradients are the rank's own
    share. The ranks' summed gradients are those of one BatchNorm over the
    concatenated batch (tests/test_torch_data_parallel.py holds them to
    it)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, bn: "BatchNorm"):
        import torch.distributed as dist

        ops = torch if x.is_cuda else _PlainBatchNormOps
        c = x.shape[1]
        mean, invstd = ops.batch_norm_stats(x, bn.eps)
        local = torch.cat([mean, invstd, mean.new_full((1,), x.numel() // c)])
        parts = [torch.empty_like(local) for _ in range(dist.get_world_size(bn.group))]
        dist.all_gather(parts, local, group=bn.group)
        gathered = torch.stack(parts)
        counts = gathered[:, 2 * c]
        mean, invstd = ops.batch_norm_gather_stats_with_counts(
            x, gathered[:, :c], gathered[:, c:2 * c], None, None, bn.momentum, bn.eps, counts)
        # flax's running update, from the biased variance (the op's own
        # would take the unbiased one)
        var = invstd.pow(-2) - bn.eps
        torch._foreach_lerp_([bn.running_mean, bn.running_var], [mean, var], bn.momentum)
        bn.num_batches_tracked.add_(1)
        ctx.save_for_backward(x, weight, mean, invstd, counts.int())
        ctx.group = bn.group
        return ops.batch_norm_elemt(x, weight, bias, mean, invstd, bn.eps)

    @staticmethod
    def backward(ctx, dy: torch.Tensor):
        import torch.distributed as dist

        x, weight, mean, invstd, counts = ctx.saved_tensors
        ops = torch if x.is_cuda else _PlainBatchNormOps
        # in x's layout: the convolutions give channels-last tensors, and the
        # fused ops take their channels-last kernels only when both are
        layout = torch.channels_last if x.is_contiguous(memory_format=torch.channels_last) \
            else torch.contiguous_format
        dy = dy.contiguous(memory_format=layout)
        sum_dy, sum_dy_xmu, grad_weight, grad_bias = ops.batch_norm_backward_reduce(
            dy, x, mean, invstd, weight, True, True, True)
        sums = torch.cat([sum_dy, sum_dy_xmu])
        dist.all_reduce(sums, group=ctx.group)
        sum_dy, sum_dy_xmu = sums.chunk(2)
        grad_x = ops.batch_norm_backward_elemt(dy, x, mean, invstd, weight, sum_dy, sum_dy_xmu,
                                               counts)
        return grad_x, grad_weight, grad_bias, None


class BatchNorm(nn.BatchNorm2d):
    """flax `nn.BatchNorm(momentum=0.9, epsilon=1e-5)` on NCHW, shared by
    both classifiers: it normalizes in float32 and returns x's dtype. Train
    mode normalizes with the batch mean and biased variance and updates the
    running statistics as `new = 0.9·old + 0.1·batch` from the biased
    variance (torch's `momentum` 0.1 is flax's 0.9).

    F.batch_norm updates the buffers in the same pass that computes the
    batch statistics, but with the unbiased variance: it gives u =
    m·old + (1−m)·var·n/(n−1) for m = 0.9. With c = (n−1)/n, c·u + m·(1−c)·old
    is flax's m·old + (1−m)·var, without a second pass over x. The running
    variance F.batch_norm updates is a copy, since autograd may keep the
    tensors it was given and `old` is rescaled in place.

    With a process group (`group`), train mode is flax's cross-replica
    form instead (`SyncBatchNorm`): it normalizes with the global batch's
    mean and biased variance, and the running statistics take those. torch's
    nn.SyncBatchNorm is not used: it stores the unbiased variance."""

    def __init__(self, num_features: int, group=None):
        super().__init__(num_features, eps=1e-5, momentum=0.1)
        self.group = group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.training and self.group is not None:
            return SyncBatchNorm.apply(xf, self.weight, self.bias, self).to(x.dtype)
        if not self.training:
            out = F.batch_norm(xf, self.running_mean, self.running_var, self.weight, self.bias,
                               training=False, eps=self.eps)
            return out.to(x.dtype)
        unbiased = self.running_var.clone()
        out = F.batch_norm(xf, self.running_mean, unbiased, self.weight, self.bias,
                           training=True, momentum=self.momentum, eps=self.eps)
        with torch.no_grad():
            n = xf.numel() // xf.shape[1]
            c = (n - 1) / n
            m = 1.0 - self.momentum
            self.running_var.mul_(m * (1.0 - c)).add_(unbiased, alpha=c)
            self.num_batches_tracked.add_(1)
        return out.to(x.dtype)


class ConvBlock(nn.Module):
    """Conv3x3 (no bias) -> BatchNorm -> ReLU -> MaxPool2 -> channel dropout.

    On the card, everything after the convolution is one hand-written kernel
    pair (`ops/conv_epilogue.py`), in train mode without a process group and
    in eval mode; the dropout mask is drawn by the same generator call as the
    chain's. The cross-rank BatchNorm (train mode with a group) and every CPU
    tensor run the chain of torch ops."""

    def __init__(self, in_channels: int, out_channels: int, drop_rate: float = 0.2,
                 dtype: torch.dtype = torch.float32, axis_name=None):
        super().__init__()
        self.dtype = dtype
        self.drop_rate = drop_rate
        self.conv = nn.Conv2d(in_channels, out_channels, 3, padding=1, bias=False)
        self.bn = BatchNorm(out_channels, group=axis_name)
        self.pool = nn.MaxPool2d(2)  # floors odd sizes, as flax max_pool does

    def epilogue_engages(self, x) -> bool:
        """Whether the conv output x takes the kernel pair (class doc)."""
        return x.is_cuda and not (self.training and self.bn.group is not None)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        x = F.conv2d(x.to(self.dtype), self.conv.weight.to(self.dtype), padding=1)
        if self.epilogue_engages(x):
            p = self.drop_rate if self.training else 0.0
            keep = keep_mask(x.shape[:2] + (1, 1), p, generator, x.device) if p else None
            return conv_epilogue(x, self.bn, keep, p)
        x = self.pool(F.relu(self.bn(x)))
        if self.training:
            x = dropout(x, self.drop_rate, generator, per_channel=True)
        return x


class LightweightCNN(nn.Module):
    """5-block CNN. Input (B, n_mels, T, 1); output (B, num_classes) f32 logits."""

    def __init__(self, num_classes: int = 4, dropout: float = 0.3,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None, axis_name=None):
        super().__init__()
        self.dtype = dtype
        self.axis_name = axis_name
        chans = (1, 32, 64, 128, 256, 256)
        for i in range(5):
            self.add_module(f"conv{i + 1}", ConvBlock(chans[i], chans[i + 1], dtype=dtype,
                                                      axis_name=axis_name))
        self.fc1 = nn.Linear(256, 128)
        self.fc2 = nn.Linear(128, num_classes)
        self.drop_rate = dropout
        self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        init_weights(self, generator)

    def set_dropout(self, p: float) -> None:
        """Set every dropout rate: the blocks' and the head's (p = 0 makes
        train mode deterministic)."""
        self.drop_rate = p
        for i in range(5):
            getattr(self, f"conv{i + 1}").drop_rate = p

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        """In train mode the dropout masks come from `generator`."""
        x = x.permute(0, 3, 1, 2)  # (B, H, W, C) -> (B, C, H, W)
        for i in range(5):
            x = getattr(self, f"conv{i + 1}")(x, generator)
        x = x.mean(dim=(2, 3))  # global average pool -> (B, 256)
        dt = self.dtype
        x = F.relu(F.linear(x.to(dt), self.fc1.weight.to(dt), self.fc1.bias.to(dt)))
        if self.training:
            x = dropout(x, self.drop_rate, generator)
        x = F.linear(x, self.fc2.weight.to(dt), self.fc2.bias.to(dt))
        return x.float()


def count_parameters(model: nn.Module) -> int:
    """Trainable parameter count."""
    return sum(p.numel() for p in model.parameters() if p.requires_grad)
