"""The ConvBlock epilogue's plain version (`ops/conv_epilogue.py`) on the CPU.

The kernels of `csrc/conv_epilogue.cu` run only on the card, where
`chip_smoke.py` holds them to this plain version. Here the plain version is
held to the formula in f64, to the port's chain of torch ops (the CPU's and
the cross-rank path's code, `models/cnn.ConvBlock`), to its own backward by
gradcheck, and ConvBlock's routing is checked.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from audio_classification_icbhi_tpu_torch import tracing
from audio_classification_icbhi_tpu_torch.models import cnn
from audio_classification_icbhi_tpu_torch.models.cnn import BatchNorm, ConvBlock, keep_mask
from audio_classification_icbhi_tpu_torch.ops import conv_epilogue as ce

# (B, C, H, W): each block's channels at config.yaml's first frames, odd H
# or W (the floor drops the last row or column), config_segmented.yaml's
# 94 frames
SHAPES = [(2, 32, 16, 25), (2, 64, 8, 13), (3, 128, 5, 6), (2, 256, 4, 7), (2, 256, 3, 3),
          (2, 32, 128, 94)]


def make_bn(c: int, seed: int, dtype=torch.float32) -> BatchNorm:
    g = torch.Generator().manual_seed(seed)
    bn = BatchNorm(c).to(dtype)
    with torch.no_grad():
        bn.weight.copy_(1.0 + 0.3 * torch.randn(c, generator=g))
        bn.bias.copy_(0.2 * torch.randn(c, generator=g))
        bn.running_mean.copy_(0.1 * torch.randn(c, generator=g))
        bn.running_var.copy_(0.5 + torch.rand(c, generator=g))
    return bn


def conv_like(shape, seed: int, dtype=torch.float32) -> torch.Tensor:
    """A conv output: per-channel offsets and scales, so the statistics matter."""
    g = torch.Generator().manual_seed(seed)
    b, c, h, w = shape
    y = torch.randn(shape, generator=g, dtype=torch.float64)
    y = y * (0.5 + torch.rand(c, 1, 1, generator=g, dtype=torch.float64)) \
        + torch.randn(c, 1, 1, generator=g, dtype=torch.float64)
    return y.to(dtype)


def chain(y, bn, keep, p):
    """ConvBlock's chain of torch ops after the convolution."""
    x = F.max_pool2d(F.relu(bn(y)), 2)
    if keep is None:
        return x
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype))


def formula(y, mean, var, weight, bias, keep, p, dtype):
    """The epilogue in f64 from the statistics, rounded to dtype where the
    chain rounds."""
    y, mean, var = y.double(), mean.double(), var.double()
    v = (y - mean[:, None, None]) / torch.sqrt(var[:, None, None] + 1e-5) \
        * weight.double()[:, None, None] + bias.double()[:, None, None]
    x = F.max_pool2d(torch.relu(v.to(dtype).double()), 2)
    if keep is not None:
        x = torch.where(keep, (x * ce.keep_scale(p)).to(dtype).double(), 0.0)
    return x


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("p", [0.0, 0.2])
def test_plain_holds_the_formula_and_the_chain(shape, p):
    y = conv_like(shape, 1)
    keep = keep_mask(shape[:2] + (1, 1), p, torch.Generator().manual_seed(2), "cpu") if p \
        else None
    bn, bn_chain = make_bn(shape[1], 3), make_bn(shape[1], 3)
    got = ce.conv_epilogue(y, bn, keep, p)
    assert got.shape == (shape[0], shape[1], shape[2] // 2, shape[3] // 2)
    var, mean = torch.var_mean(y.double(), dim=(0, 2, 3), correction=0)
    want = formula(y, mean, var, bn.weight.detach(), bn.bias.detach(), keep, p, torch.float32)
    torch.testing.assert_close(got.double(), want, rtol=2e-6, atol=2e-6)
    torch.testing.assert_close(got, chain(y, bn_chain, keep, p), rtol=2e-6, atol=2e-6)
    # flax's running update, from the biased variance
    old = make_bn(shape[1], 3)
    torch.testing.assert_close(bn.running_mean.double(),
                               0.9 * old.running_mean.double() + 0.1 * mean, rtol=0, atol=1e-6)
    torch.testing.assert_close(bn.running_var.double(),
                               0.9 * old.running_var.double() + 0.1 * var, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(bn.running_var, bn_chain.running_var, rtol=2e-6, atol=1e-7)
    assert int(bn.num_batches_tracked) == int(bn_chain.num_batches_tracked) == 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_plain_rounds_where_the_chain_rounds(dtype):
    """In bf16 and fp16 the plain version and the chain round the same f32
    values at the same points: they agree to one ulp of the dtype (the sums
    run in another order), the backward as well."""
    shape, p = (4, 64, 16, 21), 0.2
    y = conv_like(shape, 4, dtype)
    keep = keep_mask(shape[:2] + (1, 1), p, torch.Generator().manual_seed(5), "cpu")
    bn, bn_chain = make_bn(64, 6), make_bn(64, 6)
    ya, yb = y.clone().requires_grad_(), y.clone().requires_grad_()
    got, want = ce.conv_epilogue(ya, bn, keep, p), chain(yb, bn_chain, keep, p)
    ulp = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}[dtype]
    err = (got.float() - want.float()).abs()
    assert bool((err <= 2 * ulp * want.float().abs() + 1e-30).all())
    assert (err > 0).float().mean().item() < 0.01
    g = torch.randn(got.shape, generator=torch.Generator().manual_seed(7)).to(dtype)
    got.backward(g)
    want.backward(g)
    for a, b in ((bn.weight.grad, bn_chain.weight.grad), (bn.bias.grad, bn_chain.bias.grad)):
        torch.testing.assert_close(a, b, rtol=2e-3, atol=2e-3 * b.abs().max().item())
    dx_err = (ya.grad.float() - yb.grad.float()).abs()
    assert (dx_err <= 2 * ulp * yb.grad.float().abs() + 1e-3 * yb.grad.float().abs().max()
            ).float().mean().item() > 0.999


def test_ties_route_to_the_first_maximum():
    """SpecAugment zeroes whole bands, which the conv turns into constant
    ones: each tied window passes its gradient to its first element in scan
    order, as torch's max-pool does."""
    shape = (2, 32, 12, 16)
    y = conv_like(shape, 8)
    y[:, :, 2:8, :] = y[:, :, 2:3, :1]   # a constant band across time
    y[:, :, :, 5:11] = 3.0               # and one across frequency
    bn = make_bn(32, 9)
    mean, var = ce.batch_stats_reference(y)
    _, code = ce.apply_reference(y, mean, var, bn.weight.detach(), bn.bias.detach(), 1e-5)
    band = code[:, 1:4, 3:5, :]          # pooled windows inside both bands
    assert bool(((band == 0) | (band == ce.NO_GRADIENT)).all())
    assert bool((band == 0).any())
    ya, yb = y.clone().requires_grad_(), y.clone().requires_grad_()
    bn_chain = make_bn(32, 9)
    ce.conv_epilogue(ya, bn).sum().backward()
    chain(yb, bn_chain, None, 0.0).sum().backward()
    torch.testing.assert_close(ya.grad, yb.grad, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(bn.weight.grad, bn_chain.weight.grad, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("p", [0.0, 0.2])
def test_conv_block_draws_masks_as_the_chain(monkeypatch, p):
    """ConvBlock's kernel route (taken here on the CPU) draws the same
    dropout mask from the same generator call as the chain: the generator's
    state after a forward is the chain's, and so are the output and the
    running statistics."""
    x = torch.randn((3, 16, 10, 14), generator=torch.Generator().manual_seed(10))
    blocks = []
    for seed in (0, 0):
        torch.manual_seed(seed)
        blocks.append(ConvBlock(16, 32, drop_rate=p).train())
    kernel_route, chain_route = blocks
    monkeypatch.setattr(kernel_route, "epilogue_engages", lambda x: True)
    ga, gb = torch.Generator().manual_seed(11), torch.Generator().manual_seed(11)
    got, want = kernel_route(x, ga), chain_route(x, gb)
    assert torch.equal(ga.get_state(), gb.get_state())
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(kernel_route.bn.running_var, chain_route.bn.running_var,
                               rtol=2e-6, atol=1e-7)
    got.sum().backward()
    want.sum().backward()
    torch.testing.assert_close(kernel_route.conv.weight.grad, chain_route.conv.weight.grad,
                               rtol=1e-4, atol=1e-4)


def test_eval_uses_the_running_statistics():
    shape = (2, 32, 9, 11)
    y = conv_like(shape, 12)
    bn, bn_chain = make_bn(32, 13).eval(), make_bn(32, 13).eval()
    got = ce.conv_epilogue(y, bn)
    want = formula(y, bn.running_mean, bn.running_var, bn.weight.detach(), bn.bias.detach(),
                   None, 0.0, torch.float32)
    torch.testing.assert_close(got.double(), want, rtol=2e-6, atol=2e-6)
    torch.testing.assert_close(got, chain(y, bn_chain, None, 0.0), rtol=2e-6, atol=2e-6)
    assert torch.equal(bn.running_mean, bn_chain.running_mean)
    assert int(bn.num_batches_tracked) == 0
    with torch.no_grad():
        torch.testing.assert_close(ce.conv_epilogue(y, bn), got, rtol=0, atol=0)


@pytest.mark.parametrize("training, p", [(True, 0.0), (True, 0.2), (False, 0.0)])
def test_plain_backward_gradcheck(training, p):
    """The plain version's backward, written out as the Reduce and dx kernels
    compute it, against finite differences in float64."""
    shape = (2, 8, 5, 7)
    y = conv_like(shape, 14, torch.float64).requires_grad_()
    g = torch.Generator().manual_seed(15)
    weight = (1.0 + 0.3 * torch.randn(8, generator=g, dtype=torch.float64)).requires_grad_()
    bias = (0.2 * torch.randn(8, generator=g, dtype=torch.float64)).requires_grad_()
    bn = SimpleNamespace(weight=weight, bias=bias, eps=1e-5, momentum=0.1, training=training,
                         running_mean=torch.zeros(8, dtype=torch.float64),
                         running_var=torch.ones(8, dtype=torch.float64),
                         num_batches_tracked=torch.zeros((), dtype=torch.long))
    keep = keep_mask((2, 8, 1, 1), p, g, "cpu") if p else None
    scale = ce.keep_scale(p) if p else 1.0
    assert torch.autograd.gradcheck(
        lambda y, w, b: ce.ConvEpilogue.apply(y, w, b, bn, keep, scale), (y, weight, bias))


def test_conv_block_routes_by_what_it_sees(monkeypatch):
    """The kernel pair engages for CUDA tensors in eval mode, and in train
    mode without a process group; the CPU and the cross-rank BatchNorm keep
    the chain."""
    block = ConvBlock(1, 32)
    card = SimpleNamespace(is_cuda=True)
    assert block.train().epilogue_engages(card)
    assert block.eval().epilogue_engages(card)
    block.bn.group = object()
    assert not block.train().epilogue_engages(card)
    assert block.eval().epilogue_engages(card)
    block.bn.group = None

    def refused(*args, **kwargs):
        raise AssertionError("the kernel route on the CPU")

    monkeypatch.setattr(cnn, "conv_epilogue", refused)
    x = torch.randn(2, 1, 8, 8)
    assert not block.train().epilogue_engages(x)
    block.train()(x, torch.Generator().manual_seed(0))
    block.eval()(x)


def test_a_map_that_pools_to_nothing_raises():
    with pytest.raises(RuntimeError, match="Output size is too small"):
        ce.conv_epilogue(torch.randn(2, 8, 1, 6), make_bn(8, 0))
    with pytest.raises(RuntimeError, match="Output size is too small"):
        cnn.LightweightCNN().eval()(torch.randn(1, 16, 40, 1))


def test_the_recorder_reports_the_counts(monkeypatch):
    monkeypatch.setattr(ce.conv_epilogue, "launches", 10)
    monkeypatch.setattr(ce.conv_epilogue, "launches_backward", 7)
    got = tracing.counters()
    assert (got["conv_epilogue.launches"], got["conv_epilogue.launches_backward"]) == (10, 7)
    assert np.isfinite(ce.keep_scale(0.2)) and ce.keep_scale(0.2) == np.float32(1) / np.float32(
        0.8)
