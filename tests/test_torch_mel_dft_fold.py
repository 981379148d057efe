"""The folded real-input DFT of TPU-kernel row 7's Hopper kernel
(`csrc/log_mel_dft_gemm.cu`) on the CPU: the fold identity, the constant
operand the kernel streams by TMA, the per-bin mel table of its mel pass, and
a torch model of its arithmetic against the float64 plain version.

The kernel itself runs only on the card (`chip_smoke.py` phase 18 holds it to
the plain version there). The model is the kernel's arithmetic written out in
torch: the fold in f32, the TF32 hi/lo split, three products an 8-deep step,
each `wgmma` rounding its f32 sum toward zero as the tensor cores do, a chain
of `reset` steps started from zero and added to the running f32 sum. It lives
here only; the port's plain version stays `log_mel_fused_reference`.

    PYTHONPATH=. python tests/test_torch_mel_dft_fold.py

prints the model's error at each row-7 shape for reset intervals of 1, 2 and
4 steps (the kernel's header note cites them).
"""

import numpy as np
import pytest
import torch

from audio_classification_icbhi_tpu_torch.ops import mel_kernels as mk
from audio_classification_icbhi_tpu_torch.ops import stft as port_stft
from audio_classification_icbhi_tpu_torch.ops.mel import _mel_filterbank_np, mel_filterbank

SR, N_MELS = 16000, 128
CPU = torch.device("cpu")
ROW7_SHAPES = [(1001, 250), (505, 126), (1022, 511), (2050, 512)]


def fold_power(frames: torch.Tensor, n_fft: int) -> torch.Tensor:
    """|rfft|² of the windowed frames by the fold, in the frames' dtype:
    s = x_n + x_{N-n}, d = x_n - x_{N-n} for n = 1 .. N // 2, against the
    windowed cos / sin matrices."""
    n = torch.arange(1, n_fft // 2 + 1)
    s = frames[..., n] + frames[..., n_fft - n]
    d = frames[..., n] - frames[..., n_fft - n]
    c, sn = mk.dft_fold_matrices(n_fft)
    return (s @ c.T.to(frames.dtype)) ** 2 + (d @ sn.T.to(frames.dtype)) ** 2


@pytest.mark.parametrize("n_fft, hop, length", [(7, 3, 21), (1001, 250, 4000),
                                                (1022, 511, 3066), (2050, 512, 4096)])
def test_fold_identity(rng, n_fft, hop, length):
    """In float64 the fold reproduces torch.fft.rfft's power of the windowed
    frames to 1e-12 of the largest, at odd and even n_fft: the even-N middle
    sample (counted once, through c_{N/2} = 1/2) and, at odd n_fft with hop
    dividing the length, the clamped last frame."""
    x = torch.from_numpy(rng.standard_normal((2, length)))
    frames = port_stft.frame_signal(x, n_fft, hop)
    padded = port_stft.reflect_pad(x, n_fft // 2)
    if n_fft % 2:  # the last frame runs a sample past the padded signal and clamps
        assert (frames.shape[-2] - 1) * hop + n_fft == padded.shape[-1] + 1
        assert torch.equal(frames[:, -1, -1], padded[:, -1])
    want = torch.fft.rfft(frames * port_stft.hann_window(n_fft, dtype=torch.float64),
                          dim=-1).abs() ** 2
    got = fold_power(frames, n_fft)
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= 1e-12 * want.max().item()


def test_even_middle_sample_counted_once():
    """At even n_fft the middle sample x_{N/2} folds onto itself: its column
    carries half the windowed cosine, and the sine column is zero there."""
    n_fft = 1022
    c, s = mk.dft_fold_matrices(n_fft)
    k = torch.arange(n_fft // 2 + 1, dtype=torch.float64)
    w_mid = port_stft.hann_window(n_fft, dtype=torch.float64)[n_fft // 2]
    torch.testing.assert_close(c[:, -1], 0.5 * w_mid * torch.cos(np.pi * k), rtol=0, atol=1e-15)
    assert s[:, -1].abs().max().item() < 1e-15


@pytest.mark.parametrize("n_fft", [7, 1001, 1022, 2050])
def test_constants_layout(n_fft):
    """`_dft_fold_constants`: (4, bins padded to 72, K padded to 32) float32,
    K-major (C_hi, C_lo, S_hi, S_lo); hi and lo are TF32 (13 low bits zero);
    hi + lo matches the float64 windowed cos / sin to 2⁻²¹ relative; zeros
    in the padding."""
    k_half, k_pad, bins_pad = mk.dft_fold_geometry(n_fft)
    n_bins = n_fft // 2 + 1
    assert k_half == n_fft // 2 and k_pad % 32 == 0 and 0 <= k_pad - k_half < 32
    assert bins_pad % 72 == 0 and 0 <= bins_pad - n_bins < 72
    consts = mk._dft_fold_constants(n_fft, CPU)
    assert consts.dtype == torch.float32 and tuple(consts.shape) == (4, bins_pad, k_pad)
    assert consts.is_contiguous()
    assert int((consts.view(torch.int32) & 0x1FFF).abs().max()) == 0
    for i, ref in enumerate(mk.dft_fold_matrices(n_fft)):
        assert tuple(ref.shape) == (n_bins, k_half)
        hi, lo = consts[2 * i].double(), consts[2 * i + 1].double()
        err = (hi[:n_bins, :k_half] + lo[:n_bins, :k_half] - ref).abs()
        assert bool((err <= 2.0 ** -21 * ref.abs()).all())
        assert lo[:n_bins, :k_half].abs().max().item() <= 2.0 ** -10 * ref.abs().max().item()
        for part in (hi, lo):
            assert not part[n_bins:].any() and not part[:, k_half:].any()


def test_constants_cached_per_n_fft_and_device():
    assert mk._dft_fold_constants(1001, CPU) is mk._dft_fold_constants(1001, CPU)
    assert mk._dft_fold_constants.cache_info().maxsize <= 4


@pytest.mark.parametrize("n_fft", [37, 505, 1001, 2050])
def test_mel_bin_table_is_the_filterbank(n_fft):
    """`mel_bin_table`: each bin's even and odd band and weight, -1 and 0
    where it lies in none, padded to the bin tile; it holds every nonzero
    weight of the filterbank, so the kernel's mel pass sums the same terms."""
    table = mk.mel_bin_table(SR, n_fft, N_MELS, 0.0, SR / 2.0, "htk", None, CPU).numpy()
    fb = _mel_filterbank_np(SR, n_fft, N_MELS, 0.0, SR / 2.0, "htk", None)
    assert table.shape == (mk.dft_fold_geometry(n_fft)[2], 4)
    rebuilt = np.zeros((table.shape[0], N_MELS), dtype=np.float32)
    for slot in (0, 2):
        mel, bits = table[:, slot], table[:, slot + 1]
        has = mel >= 0
        assert np.all(mel[has] % 2 == slot // 2) and np.all(bits[~has] == 0)
        rebuilt[np.flatnonzero(has), mel[has]] = bits[has].view(np.float32)
    np.testing.assert_array_equal(rebuilt[:fb.shape[0]], fb.astype(np.float32))
    assert np.all(table[fb.shape[0]:, 0::2] == -1)


def test_mel_bin_table_refuses_overlapping_bands(monkeypatch):
    """A bin in two bands of one parity cannot be summed by the kernel's
    (row, parity) threads: the table raises rather than drop a term."""
    fb = _mel_filterbank_np(SR, 505, 8, 0.0, SR / 2.0, "htk", None)
    wide = fb.copy()
    wide[:, 2] += wide[:, 0]  # band 2 now overlaps band 0
    monkeypatch.setattr(mk, "_mel_filterbank_np", lambda *args: wide)
    mk.mel_bin_table.cache_clear()
    try:
        with pytest.raises(ValueError, match="two mel bands of one parity"):
            mk.mel_bin_table(SR, 505, 8, 0.0, SR / 2.0, "htk", None, CPU)
    finally:
        mk.mel_bin_table.cache_clear()


@pytest.mark.parametrize("rows, bin_tiles, splits", [
    (128 * 321, 7, 2),   # 1001/250, 128 x 5 s: 321 row tiles, 2.43 waves -> 642 halves, 4.86
    (128 * 635, 4, 1),   # 505/126: 635 row tiles, 4.81 waves; halves would fill 9.62 of 10
    (128 * 157, 15, 2),  # 2050/512
    (3 * 65, 7, 2),      # two row tiles on 132 SMs: halves put four blocks to work
    (3 * 65, 1, 1),      # one bin tile: nothing to split
])
def test_dft_fold_splits(rows, bin_tiles, splits):
    """The kernel splits a row tile's bin tiles over two blocks only where
    that leaves fewer SMs idle in the last wave (132 SMs, one block each)."""
    assert mk.dft_fold_splits(rows, bin_tiles, 132) == splits


def _round_toward_zero(x64: torch.Tensor) -> torch.Tensor:
    f = x64.float()
    return torch.where(f.double().abs() > x64.abs(), torch.nextafter(f, torch.zeros_like(f)), f)


def kernel_model(x: torch.Tensor, n_fft: int, hop: int, reset: int = 1) -> torch.Tensor:
    """The kernel's arithmetic on a (B, L) float32 waveform -> (B, n_mels, T)
    dB: the f32 fold of the clamped frames, the TF32 split, per 8-deep step
    the three products lo·hi, hi·lo, hi·hi against the constants, each
    `wgmma` adding its exact 8-term sum and rounding toward zero, a chain of
    `reset` steps from zero added to the running f32 sum (rounding to
    nearest), then power, mel and dB in f32."""
    k_half, k_pad, bins_pad = mk.dft_fold_geometry(n_fft)
    consts = mk._dft_fold_constants(n_fft, CPU)
    frames = port_stft.frame_signal(x, n_fft, hop)
    n = torch.clamp(torch.arange(1, k_pad + 1), max=k_half)  # padded columns repeat K
    steps = k_pad // 8
    sums = []
    for a, b_hi, b_lo in ((frames[..., n] + frames[..., n_fft - n], consts[0], consts[1]),
                          (frames[..., n] - frames[..., n_fft - n], consts[2], consts[3])):
        a_hi = mk.tf32_round(a)
        a_lo = mk.tf32_round(a - a_hi)

        def product(p, q):  # (B, T, steps, bins), each step's 8-term sum, exact in f64
            return torch.einsum("btsj,ksj->btsk", p.double().reshape(*p.shape[:-1], steps, 8),
                                q.double().reshape(bins_pad, steps, 8))

        terms = (product(a_lo, b_hi), product(a_hi, b_lo), product(a_hi, b_hi))
        run = torch.zeros(terms[0].shape[:2] + terms[0].shape[3:])
        for s0 in range(0, steps, reset):
            acc = torch.zeros_like(run)
            for s in range(s0, min(s0 + reset, steps)):
                for t in terms:
                    acc = _round_toward_zero(acc.double() + t[:, :, s])
            run = run + acc
        sums.append(run)
    power = (sums[0] ** 2 + sums[1] ** 2)[..., :n_fft // 2 + 1]
    mel = power @ mel_filterbank(SR, n_fft, N_MELS).float()
    return (10.0 * torch.log10(torch.clamp(mel, min=1e-10))).transpose(1, 2)


def seeded_noise(n_fft: int) -> torch.Tensor:
    """chip_smoke.py phase 18's input at 1 s: three clips of noise, one 26 dB
    louder."""
    x = (0.1 * np.random.default_rng(18).standard_normal((3, SR))).astype(np.float32)
    x[1] *= 20.0
    return torch.from_numpy(x)


@pytest.mark.parametrize("n_fft, hop", [(1001, 250), (505, 126)])
def test_kernel_model_against_plain_f64(n_fft, hop):
    """The model of the kernel's arithmetic (reset interval 1, as built) is
    within 5e-4 dB of the float64 plain version on seeded noise: half the
    1e-3 gate that phase 18 holds the card to."""
    x = seeded_noise(n_fft)
    want = mk.log_mel_fused_reference(x.double(), SR, n_fft, hop, N_MELS)
    got = kernel_model(x, n_fft, hop)
    assert got.shape == want.shape
    assert (got.double() - want).abs().max().item() <= 5e-4


def test_kernel_model_even_n_fft_against_f64_fold():
    """At an even n_fft (its middle sample through c_{N/2} = 1/2) the model
    agrees within 5e-4 dB with the float64 fold of the same frames."""
    n_fft, hop = 1022, 511
    x = seeded_noise(n_fft)
    frames = port_stft.frame_signal(x.double(), n_fft, hop)
    mel = fold_power(frames, n_fft) @ mel_filterbank(SR, n_fft, N_MELS, dtype=torch.float64)
    want = (10.0 * torch.log10(torch.clamp(mel, min=1e-10))).transpose(1, 2)
    got = kernel_model(x, n_fft, hop)
    assert (got.double() - want).abs().max().item() <= 5e-4


if __name__ == "__main__":
    for n_fft, hop in ROW7_SHAPES:
        x = seeded_noise(n_fft)
        want = mk.log_mel_fused_reference(x.double(), SR, n_fft, hop, N_MELS)
        errs = {r: (kernel_model(x, n_fft, hop, r).double() - want).abs().max().item()
                for r in (1, 2, 4)}
        print(f"{n_fft}/{hop}: max|model - plain f64| dB by reset interval "
              + ", ".join(f"{r}: {e:.3e}" for r, e in errs.items()))
