"""TPU-kernel row 7 (`_kernel_bf16x3` / `_kernel_f32`) in the port, the
odd-n_fft framing repair (ROADMAP.md C1), the `classify_files` repair (C2 is
in tests/test_torch_engine.py) and the parity entry point, on the CPU.

The JAX side runs as its own tests run it here: `log_mel_pallas` in
interpret mode, and its XLA front end. The port side gets CPU tensors, so
the row-7 wrappers run their plain version (`log_mel_fused_reference`).
Inputs are made with numpy from a seed; the 2048/512 inputs and tolerances
are tests/test_pallas_mel.py's.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from audio_classification_icbhi_tpu.ops import mel as jax_mel
from audio_classification_icbhi_tpu.ops import stft as jax_stft
from audio_classification_icbhi_tpu.ops.pallas_mel import log_mel_pallas
from audio_classification_icbhi_tpu_torch import parity
from audio_classification_icbhi_tpu_torch.ops import _build, mel_kernels
from audio_classification_icbhi_tpu_torch.ops import mel as port_mel
from audio_classification_icbhi_tpu_torch.ops import stft as port_stft
from audio_classification_icbhi_tpu_torch.ops.golden import golden_mel, parity_battery
from audio_classification_icbhi_tpu_torch.ops.mel import log_mel_spectrogram

SR, N_MELS = 16000, 128
ROW7 = ["bf16x3", "f32"]
JAX_ATOL = {"f32": 1e-3, "bf16x3": 2e-3}  # tests/test_pallas_mel.py:38-52


def jax_kernel(algorithm, wav, n_fft=2048, hop=512, **kw):
    return np.asarray(log_mel_pallas(jnp.asarray(wav), SR, n_fft, hop, N_MELS,
                                     algorithm=algorithm, interpret=True, **kw))


def port_kernel(algorithm, wav, n_fft=2048, hop=512, **kw):
    return mel_kernels.WRAPPERS[algorithm](torch.from_numpy(wav), SR, n_fft, hop, N_MELS,
                                           **kw).numpy()


@pytest.fixture
def wav(rng):
    """tests/test_pallas_mel.py's input: two tones over noise, 2 s, and the
    same reversed."""
    t = np.arange(SR * 2) / SR
    x = (0.4 * np.sin(2 * np.pi * 220 * t) + 0.2 * np.sin(2 * np.pi * 1333 * t)
         + 0.05 * rng.standard_normal(SR * 2))
    return np.stack([x, x[::-1]]).astype(np.float32)


# --- C1: odd n_fft frames as the JAX package does ----------------------------

def test_ramp_last_frame_clamps():
    """n_fft 5 / hop 4 on a 16-sample ramp: 1 + 16 // 4 = 5 frames, the last
    one running a sample past the padded signal, whose index clamps."""
    x = np.arange(16, dtype=np.float32)
    got = port_stft.frame_signal(torch.from_numpy(x), 5, 4).numpy()
    want = np.asarray(jax_stft.frame_signal(jnp.asarray(x), 5, 4))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[-1], [14, 15, 14, 13, 13])


@pytest.mark.parametrize("n_fft, hop, length", [(7, 3, 21), (1001, 250, 4000),
                                                (505, 126, 1008), (1022, 511, 3066)])
def test_frames_equal_jax(rng, n_fft, hop, length):
    """Odd n_fft with hop dividing the length (one sample short before the
    repair), and an even n_fft % 4 != 0; shapes where the JAX gather path
    frames (its reshape path refuses odd n_fft with hop | n_fft and hop | L,
    ROADMAP.md C)."""
    x = rng.standard_normal((2, length)).astype(np.float32)
    got = port_stft.frame_signal(torch.from_numpy(x), n_fft, hop).numpy()
    want = np.asarray(jax_stft.frame_signal(jnp.asarray(x), n_fft, hop))
    assert got.shape == want.shape == (2, 1 + length // hop, n_fft)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_fft, hop, length", [(1001, 250, SR), (505, 126, 1008)])
def test_auto_frontend_matches_jax_xla(rng, n_fft, hop, length):
    """`MelFrontend(backend="auto")` (bf16x3 shapes: the plain chain, as the
    JAX package runs XLA there) against the JAX XLA front end: equal frame
    counts, normalized output within 2e-3. Before the repair the port gave
    one frame fewer (64 against 65, 8 against 9)."""
    n = (0.1 * rng.standard_normal((2, length))).astype(np.float32)
    kw = dict(n_fft=n_fft, hop_length=hop, duration=length / SR)
    fe = port_mel.MelFrontend(**kw)
    assert fe._pallas_algorithm() == "bf16x3" and fe.target_length == length
    got = fe(torch.from_numpy(n)).numpy()
    want = np.asarray(jax_mel.MelFrontend(backend="xla", **kw)(jnp.asarray(n)))
    assert got.shape == want.shape == (2, N_MELS, 1 + length // hop) == (2, N_MELS, fe.num_frames)
    np.testing.assert_allclose(got, want, atol=2e-3)


@pytest.mark.parametrize("n_fft, hop", [(1001, 250), (505, 126)])
def test_golden_frames_odd_n_fft(n_fft, hop):
    """The golden gives `num_frames` at odd n_fft and agrees with the plain
    chain in float64, which frames by the same clamp."""
    wavs = parity_battery(4 * hop)
    want = log_mel_spectrogram(torch.from_numpy(wavs).double(), SR, n_fft, hop, N_MELS).numpy()
    for w, plain in zip(wavs, want):
        got = golden_mel(w, SR, n_fft, hop, N_MELS)
        assert got.shape == (N_MELS, 5)
        np.testing.assert_allclose(got, plain, atol=1e-6)


# --- row 7 against the JAX kernel ---------------------------------------------

@pytest.mark.parametrize("algorithm", ROW7)
class TestAgainstJaxKernel:
    """2048/512, at the JAX package's own tolerances (f32 1e-3, bf16x3 2e-3)."""

    def test_tones_over_noise(self, wav, algorithm):
        np.testing.assert_allclose(port_kernel(algorithm, wav), jax_kernel(algorithm, wav),
                                   atol=JAX_ATOL[algorithm])

    def test_top_db_and_normalize(self, rng, algorithm):
        """Per example, after the kernel, as the JAX package runs them
        (`pallas_mel.py:1866`): one loud clip must not leak into the others."""
        n = (0.1 * rng.standard_normal((3, SR))).astype(np.float32)
        n[1] *= 20.0
        kw = dict(normalize=True, top_db=80.0)
        np.testing.assert_allclose(port_kernel(algorithm, n, **kw),
                                   jax_kernel(algorithm, n, **kw), atol=JAX_ATOL[algorithm])


@pytest.mark.parametrize("algorithm", ROW7)
@pytest.mark.parametrize("n_fft, hop", [(1001, 250), (1022, 511), (505, 126)])
def test_odd_shapes_active_region(algorithm, n_fft, hop):
    """Over the parity battery at 1 s, n_fft % 4 != 0: within 1e-3 of the
    JAX kernel in the 25 dB active region (cells within 25 dB of their
    clip's peak), dB only and with top_db 80 + normalize. Outside it the
    TPU kernel's bf16 products miss by up to 1.8e-2 dB at 505/126, and no
    f32 chain holds 1e-3 on the battery's deepest cells below n_fft 1536
    (ROADMAP.md C)."""
    wavs = parity_battery(SR)
    want = jax_kernel(algorithm, wavs, n_fft, hop)
    got = port_kernel(algorithm, wavs, n_fft, hop)
    assert got.shape == want.shape == (8, N_MELS, 1 + SR // hop)
    active = want >= want.max(axis=(1, 2), keepdims=True) - 25.0
    assert active.mean() > 0.2
    assert np.abs(got - want)[active].max() <= 1e-3
    kw = dict(top_db=80.0, normalize=True)
    got = port_kernel(algorithm, wavs, n_fft, hop, **kw)
    assert np.abs(got - jax_kernel(algorithm, wavs, n_fft, hop, **kw))[active].max() <= 1e-3


# --- messages, routing, counters -------------------------------------------------

def _message(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


@pytest.mark.parametrize("algorithm", ROW7)
@pytest.mark.parametrize("kw", [dict(spec_mask_bounds=np.zeros((2, 4), np.float32)),
                                dict(dft_passes=5), dict(dft_passes=6), dict(dft_passes=7)],
                         ids=["bounds", "passes5", "passes6", "passes7"])
def test_jax_messages(algorithm, kw):
    """The JAX dispatcher's refusals, with its messages (`pallas_mel.py:
    1734-1755`): bounds need a fused algorithm, passes 5/6 need the radix-8/16
    DIF kernels, 7 is no pass budget."""
    x = np.zeros((2, 4096), np.float32)
    jkw = {k: jnp.asarray(v) if k == "spec_mask_bounds" else v for k, v in kw.items()}
    pkw = {k: torch.from_numpy(v) if k == "spec_mask_bounds" else v for k, v in kw.items()}
    want = _message(lambda: log_mel_pallas(jnp.asarray(x), SR, 1001, 250, N_MELS,
                                           algorithm=algorithm, interpret=True, **jkw))
    assert _message(lambda: port_kernel(algorithm, x, 1001, 250, **pkw)) == want


@pytest.mark.parametrize("algorithm, n_fft, route", [
    ("bf16x3", 1001, "log_mel_dft_gemm"),
    ("bf16x3", 1022, "log_mel_dft_gemm"),
    ("f32", 2050, "log_mel_dft_gemm"),
    ("f32", 505, "log_mel_dft_gemm"),
    ("bf16x3", 16383, "log_mel_dft_gemm"),
    ("f32", 2048, "log_mel_radix8dif"),
    ("bf16x3", 1024, "log_mel_radix8dif"),
    ("f32", 512, "log_mel_radix8dif"),
    ("bf16x3", 1536, "log_mel_mixed_radix"),
])
def test_cuda_route(algorithm, n_fft, route):
    """By n_fft alone: n_fft % 4 != 0 goes to the DFT GEMM kernel, every
    other n_fft keeps its source (radix-8 at 512-8192, mixed-radix else)."""
    assert mel_kernels.cuda_route(algorithm, n_fft) == route
    assert (_build.CSRC / f"{route}.cu").exists()


@pytest.mark.parametrize("algorithm", ROW7)
def test_past_the_limit_names_b7(algorithm):
    """One n_fft limit for every log-mel route: past 16,384 the CUDA route
    raises naming B7 and the limit; the CPU route runs the plain version."""
    limit = mel_kernels.MIXED_RADIX_MAX_N_FFT
    with pytest.raises(NotImplementedError, match=rf"up to {limit} \(ROADMAP.md B7\)"):
        mel_kernels.cuda_route(algorithm, limit + 1)
    out = mel_kernels.WRAPPERS[algorithm](torch.zeros(1, limit + 1), SR, limit + 1,
                                          (limit + 1) // 4, N_MELS)
    assert out.shape == (1, N_MELS, 5)


def test_counters_do_not_move_on_the_cpu(rng):
    before = {a: (f.launches, f.launches_masked) for a, f in mel_kernels.WRAPPERS.items()}
    n = (0.1 * rng.standard_normal((2, SR // 4))).astype(np.float32)
    for a in ROW7:
        port_kernel(a, n, 1001, 250)
        port_kernel(a, n, 2048, 512, top_db=80.0, normalize=True)
    for backend in ("pallas", "auto"):
        port_mel.MelFrontend(n_fft=1001, hop_length=250, duration=0.25,
                             backend=backend)(torch.from_numpy(n))
    assert {a: (f.launches, f.launches_masked)
            for a, f in mel_kernels.WRAPPERS.items()} == before


def test_pallas_frontend_runs_row_7(rng):
    """`MelFrontend(backend="pallas")` at 1001/250 takes the bf16x3
    wrapper (on a CPU tensor its plain version): the JAX XLA front end's
    output, with `dft_passes` 3 and 4 checked and ignored."""
    n = (0.1 * rng.standard_normal((2, SR))).astype(np.float32)
    kw = dict(n_fft=1001, hop_length=250, duration=1.0)
    want = np.asarray(jax_mel.MelFrontend(backend="xla", **kw)(jnp.asarray(n)))
    for passes in (None, 3, 4):
        fe = port_mel.MelFrontend(backend="pallas", dft_passes=passes, **kw)
        assert fe._pallas_algorithm() == "bf16x3"
        np.testing.assert_allclose(fe(torch.from_numpy(n)).numpy(), want, atol=2e-3)


# --- the parity entry point ------------------------------------------------------

def test_parity_rows_on_the_cpu(tmp_path, capsys):
    """`python -m audio_classification_icbhi_tpu_torch.parity --device cpu`:
    the JAX package's rows and keys at its shape and durations, written to
    --out; the numpy_f32 row is `bench._golden_mel_f32`'s error."""
    out = tmp_path / "parity.jsonl"
    assert parity.main(["--out", str(out), "--device", "cpu"]) == 0
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    names = (["numpy_f32"] + [f"pallas_{a}" for a in port_mel.PORTED_ALGORITHMS]
             + [f"pallas_{a}_passes{p}" for a in ("radix16dif_fused", "radix8dif_fused")
                for p in (4, 6)] + ["xla_radix2", "xla_matmul_dft"])
    assert [(r["algorithm"], r["duration_s"]) for r in rows] == [
        (name, d) for d in (5.0, 1.0) for name in names]
    keys = {"algorithm", "duration_s", "platform", "max_abs_db_err", "max_abs_db_err_25db",
            "within_budget", "within_budget_unrestricted"}
    assert all(set(r) == keys and r["platform"] == "cpu" for r in rows)
    assert all(r["within_budget"] and r["within_budget_unrestricted"] for r in rows)
    assert capsys.readouterr().out.count('"algorithm"') == len(rows)
    for d in (5.0, 1.0):
        wavs = parity_battery(int(SR * d))
        want = np.stack([golden_mel(w) for w in wavs])
        err = np.abs(np.stack([bench._golden_mel_f32(w, SR, 2048, 512, N_MELS)
                               for w in wavs]) - want).max()
        row = next(r for r in rows if r["algorithm"] == "numpy_f32" and r["duration_s"] == d)
        assert row["max_abs_db_err"] == round(float(err), 8)


def test_parity_at_row_7_shapes():
    """The function chip_smoke.py calls at row 7's own shapes: only the
    named wrappers, no pass-budget rows."""
    rows = parity.parity("cpu", n_fft=1001, hop=250, durations=(0.25,),
                         algorithms=("bf16x3", "f32"))
    assert [r["algorithm"] for r in rows] == ["numpy_f32", "pallas_bf16x3", "pallas_f32",
                                              "xla_radix2", "xla_matmul_dft"]
    assert all(r["within_budget"] for r in rows)
