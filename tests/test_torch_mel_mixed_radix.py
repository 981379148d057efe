"""The port's mixed-radix log-mel wrappers (TPU-kernel rows 3-6) and the slice
at n_fft 512 / hop 128 against the JAX package, on the CPU.

The JAX side runs as its own tests run it here: the Pallas kernels in
interpret mode, and its XLA front end, engines and train step. The port side
gets CPU tensors, so each wrapper runs its plain torch version. Inputs are
made with numpy from a seed; the 2048/512 inputs and tolerances are
tests/test_pallas_mel.py's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_classification_icbhi_tpu.data.synthetic import synth_respiratory_cycle
from audio_classification_icbhi_tpu.inference import ClassifierEngine as JaxEngine
from audio_classification_icbhi_tpu.models import build_model as jax_build_model
from audio_classification_icbhi_tpu.models.registry import init_variables
from audio_classification_icbhi_tpu.ops import mel as jax_mel
from audio_classification_icbhi_tpu.ops.pallas_mel import log_mel_pallas
from audio_classification_icbhi_tpu.utils.checkpoint import save_checkpoint
from audio_classification_icbhi_tpu_torch.inference import ClassifierEngine
from audio_classification_icbhi_tpu_torch.ops import _build
from audio_classification_icbhi_tpu_torch.ops import mel as port_mel
from audio_classification_icbhi_tpu_torch.ops import mel_kernels
from audio_classification_icbhi_tpu_torch.ops.golden import golden_mel, parity_battery
from audio_classification_icbhi_tpu_torch.ops.mel_kernels import log_mel_fused_reference
from audio_classification_icbhi_tpu_torch.utils.config import load_config
import test_torch_train_step as train_step_tests
from test_torch_analyzers import REPO, ATOL, ckpts, jax_engine, port_engine, recording  # noqa: F401
from test_torch_train_step import flax_vars  # noqa: F401

SR, N_MELS = 16000, 128
ROWS = ["radix4dif_fused", "radix4_fused", "radix2_fused", "radix2"]
FUSED = ROWS[:3]


def jax_kernel(algorithm, wav, n_fft=2048, hop=512, **kw):
    if "spec_mask_bounds" in kw:
        kw["spec_mask_bounds"] = jnp.asarray(kw["spec_mask_bounds"])
    return np.asarray(log_mel_pallas(jnp.asarray(wav), SR, n_fft, hop, N_MELS,
                                     algorithm=algorithm, interpret=True, **kw))


def port_kernel(algorithm, wav, n_fft=2048, hop=512, **kw):
    if "spec_mask_bounds" in kw:
        kw["spec_mask_bounds"] = torch.from_numpy(kw["spec_mask_bounds"])
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


def edge_bounds(batch, n_frames):
    """(B, 4) SpecAugment bounds (f_start, f_width, t_start, t_width): a zero
    width, a mel band past n_mels, a time band past the last frame, then
    ordinary bands."""
    b = np.array([[3.0, 0.0, 10.0, 5.0],
                  [120.0, 15.0, n_frames - 4.0, 30.0],
                  [5.0, 7.0, n_frames + 8.0, 3.0]] + [[40.0, 12.0, 4.0, 6.0]] * (batch - 3),
                 np.float32)
    return b[:batch]


@pytest.mark.parametrize("algorithm", ROWS)
class TestAgainstJaxKernel:
    """Rows 3-6 at 2048/512, at the JAX package's own tolerances for each
    (tests/test_pallas_mel.py:54-253)."""

    def test_tones_over_noise(self, wav, algorithm):
        np.testing.assert_allclose(port_kernel(algorithm, wav), jax_kernel(algorithm, wav),
                                   atol=1e-3)

    def test_noise_odd_batch_and_length(self, rng, algorithm):
        n = (0.1 * rng.standard_normal((3, SR + 321))).astype(np.float32)
        got = port_kernel(algorithm, n)
        assert got.shape == (3, N_MELS, 1 + (SR + 321) // 512)
        np.testing.assert_allclose(got, jax_kernel(algorithm, n), atol=1e-3)

    def test_top_db_and_normalize(self, rng, algorithm):
        """Per example: one loud clip must not leak into the others. Row 6
        runs top_db and normalize after its kernel, as the JAX package does."""
        n = (0.1 * rng.standard_normal((5, SR))).astype(np.float32)
        n[3] *= 20.0
        kw = dict(normalize=True, top_db=60.0)
        np.testing.assert_allclose(port_kernel(algorithm, n, **kw),
                                   jax_kernel(algorithm, n, **kw), atol=2e-3)


@pytest.mark.parametrize("algorithm", FUSED)
def test_mask_bounds(rng, algorithm):
    """The training form of rows 3-5: edge-case bounds, after top_db and
    before normalize."""
    n = (0.1 * rng.standard_normal((5, SR))).astype(np.float32)
    n[1] *= 20.0
    t = 1 + SR // 512
    kw = dict(normalize=True, top_db=60.0, spec_mask_bounds=edge_bounds(5, t))
    got = port_kernel(algorithm, n, **dict(kw))
    np.testing.assert_allclose(got, jax_kernel(algorithm, n, **dict(kw)), atol=2e-3)
    assert not np.allclose(got, port_kernel(algorithm, n, normalize=True, top_db=60.0))


@pytest.mark.parametrize("algorithm, atol", [
    ("radix4dif_fused", 2e-3),  # the JAX test's bar: near-empty edge mels
    ("radix4_fused", 1.1e-3),   # 1 cell in 16k at 1.04e-3 under interpret mode
    ("radix2_fused", 1e-3),
])
def test_f_min_f_max(wav, algorithm, atol):
    """The restricted band's near-empty edge mels carry the JAX kernel's
    largest error against its FFT reference (the bars are its own). The
    port's wrapper takes the waveform in float64 here, so that its plain
    version computes the function itself: in f32 its own rounding at that
    cell adds to the JAX kernel's (1.116e-3 at row 4)."""
    kw = dict(f_min=50.0, f_max=4000.0)
    got = mel_kernels.WRAPPERS[algorithm](torch.from_numpy(wav).double(), SR, 2048, 512,
                                          N_MELS, **kw).numpy()
    np.testing.assert_allclose(got, jax_kernel(algorithm, wav, **kw), atol=atol)


@pytest.mark.parametrize("algorithm, n_fft, hop", [
    ("radix4dif_fused", 512, 128),  # a 512/128 checkpoint; the analyzer at 0.064 s
    ("radix2_fused", 768, 256),
    ("radix2", 800, 200),
])
def test_small_n_fft_active_region(algorithm, n_fft, hop):
    """Over the parity battery at 1 s: within 1e-3 dB of the JAX kernel in
    the 25 dB active region (cells within 25 dB of their clip's f64 peak).
    Outside it the JAX kernel itself misses the f64 golden by up to 5.3e-2
    dB at 512/128, and no f32 chain holds 1e-3 on cells 80-89 dB below a
    tonal clip's peak (test_plain_f64_against_golden pins the function)."""
    wavs = parity_battery(SR)
    golden = np.stack([golden_mel(w, SR, n_fft, hop, N_MELS) for w in wavs])
    active = golden >= golden.max(axis=(1, 2), keepdims=True) - 25.0
    got = port_kernel(algorithm, wavs, n_fft, hop)
    want = jax_kernel(algorithm, wavs, n_fft, hop)
    assert got.shape == want.shape == golden.shape
    assert np.abs(got - want)[active].max() <= 1e-3
    assert np.abs(got - golden)[active].max() <= 1e-3


@pytest.mark.parametrize("n_fft, hop", [(512, 128), (768, 256), (1280, 256), (800, 200),
                                        (400, 160), (1536, 384), (2048, 256),
                                        (6144, 512), (3072, 768)])
def test_plain_f64_against_golden(n_fft, hop):
    """The plain version in float64 within 1e-3 dB of the float64 FFT
    golden, unrestricted, over the parity battery at 1 s, at every shape
    this slice adds (n_fft 512 and 400 leave one and four of 128 HTK mels
    empty: both give the 1e-10 floor, -100 dB)."""
    wavs = parity_battery(SR)
    got = log_mel_fused_reference(torch.from_numpy(wavs).double(), SR, n_fft, hop,
                                  N_MELS).numpy()
    want = np.stack([golden_mel(w, SR, n_fft, hop, N_MELS) for w in wavs])
    assert np.abs(got - want).max() <= 1e-3


@pytest.mark.parametrize("duration", [1.0, 5.0])
def test_plain_f32_misses_the_golden_at_512(duration):
    """Not a fault, a property of f32 at an 80-89 dB range: at 512/128 the
    plain chain in f32 misses the f64 golden by more than 1e-3 dB on tonal
    clips' cells far below their peak (3.6e-3 at 1 s, 7.7e-3 at 5 s here;
    the digits follow the BLAS), and holds it in the 25 dB active region."""
    wavs = parity_battery(int(SR * duration))
    got = log_mel_fused_reference(torch.from_numpy(wavs), SR, 512, 128, N_MELS).double().numpy()
    want = np.stack([golden_mel(w, SR, 512, 128, N_MELS) for w in wavs])
    err = np.abs(got - want)
    active = want >= want.max(axis=(1, 2), keepdims=True) - 25.0
    assert 1e-3 < err.max() < 2e-2
    assert err[active].max() <= 1e-4


class TestErrors:
    wav = np.zeros((2, SR), np.float32)

    @pytest.mark.parametrize("algorithm, n_fft, hop, match", [
        ("radix4dif_fused", 1028, 257, "divisible by 8"),
        ("radix4dif_fused", 2048, 384, "divisible by hop_length"),
        ("radix4dif_fused", 2048, 64, "hop_length % 128"),
        ("radix4dif_fused", 768, 128, "n_fft % 512"),
        ("radix4_fused", 1028, 514, "divisible by 8"),
        ("radix4_fused", 2048, 1536, "divisible by hop_length"),
        ("radix4_fused", 2048, 256, "hop_length % 512"),
        ("radix2_fused", 1022, 511, "divisible by 4"),
        ("radix2_fused", 2048, 768, "divisible by hop_length"),
        ("radix2_fused", 2048, 128, "hop_length % 256"),
        ("radix2", 1022, 511, "divisible by 4"),
    ])
    def test_ineligible_shapes_raise_like_jax(self, algorithm, n_fft, hop, match):
        for fn in (lambda: jax_kernel(algorithm, self.wav, n_fft, hop),
                   lambda: port_kernel(algorithm, self.wav, n_fft, hop)):
            with pytest.raises(ValueError, match=match):
                fn()

    @pytest.mark.parametrize("algorithm", ROWS)
    def test_dft_passes_5_and_6_raise(self, algorithm):
        """The 3-way split exists only for the radix-8/16 DIF kernels; rows
        3-6 take 3 and 4 (checked and ignored by the f32 kernel)."""
        for passes in (5, 6):
            for fn in (jax_kernel, port_kernel):
                with pytest.raises(ValueError, match=f"dft_passes={passes}"):
                    fn(algorithm, self.wav, dft_passes=passes)
        for passes in (3, 4):
            port_kernel(algorithm, self.wav[:1, :4096], dft_passes=passes)

    def test_radix2_refuses_mask_bounds_like_jax(self):
        bounds = np.zeros((2, 4), np.float32)
        for fn in (jax_kernel, port_kernel):
            with pytest.raises(ValueError, match="requires a fused algorithm"):
                fn("radix2", self.wav, spec_mask_bounds=bounds)

    def test_hop_not_dividing_n_fft(self, rng):
        """Row 6 takes any hop (800/200, 400/160 and 2048/384 alike). At
        n_fft 400 the JAX kernel's bf16 passes miss by up to 1.6e-3 dB on
        noise cells far below the clip's peak, so there the comparison
        holds in the 25 dB active region, as at the other small shapes."""
        n = (0.1 * rng.standard_normal((2, SR // 2 + 3))).astype(np.float32)
        for n_fft, hop, depth in ((400, 160, 25.0), (2048, 384, np.inf)):
            got = port_kernel("radix2", n, n_fft, hop)
            want = jax_kernel("radix2", n, n_fft, hop)
            assert got.shape == want.shape == (2, N_MELS, 1 + n.shape[1] // hop)
            active = want >= want.max(axis=(1, 2), keepdims=True) - depth
            assert active.mean() > 0.9
            assert np.abs(got - want)[active].max() <= 1e-3

    def test_counters_do_not_move_on_the_cpu(self, rng):
        before = {a: (f.launches, f.launches_masked) for a, f in mel_kernels.WRAPPERS.items()}
        n = (0.1 * rng.standard_normal((3, SR // 4))).astype(np.float32)
        for a in ROWS:
            port_kernel(a, n)
        for a in FUSED:
            port_kernel(a, n, spec_mask_bounds=edge_bounds(3, 1 + n.shape[1] // 512))
        assert {a: (f.launches, f.launches_masked)
                for a, f in mel_kernels.WRAPPERS.items()} == before


@pytest.mark.parametrize("algorithm, n_fft, route", [
    ("radix16dif_fused", 2048, "log_mel_radix8dif"),
    ("radix16dif_fused", 8192, "log_mel_radix8dif"),
    ("radix16dif_fused", 6144, "log_mel_mixed_radix"),
    ("radix16dif_fused", 16384, "log_mel_mixed_radix"),
    ("radix8dif_fused", 1024, "log_mel_radix8dif"),
    ("radix8dif_fused", 3072, "log_mel_mixed_radix"),
    ("radix4dif_fused", 512, "log_mel_radix8dif"),
    ("radix4dif_fused", 1536, "log_mel_mixed_radix"),
    ("radix4_fused", 2048, "log_mel_radix8dif"),
    ("radix2_fused", 768, "log_mel_mixed_radix"),
    ("radix2", 800, "log_mel_mixed_radix"),
    ("radix2", 400, "log_mel_mixed_radix"),
])
def test_cuda_route(algorithm, n_fft, route):
    """The source each shape runs on the card, by n_fft alone: the radix-8
    kernel at 512, 1024, 2048, 4096 and 8192, the mixed-radix kernel for the
    rest."""
    assert mel_kernels.cuda_route(algorithm, n_fft) == route
    assert (_build.CSRC / f"{route}.cu").exists()


@pytest.mark.parametrize("algorithm, row", [("radix16dif_fused", "B1"), ("radix8dif_fused", "B2"),
                                            ("radix4dif_fused", "B3"), ("radix4_fused", "B4"),
                                            ("radix2_fused", "B5"), ("radix2", "B6")])
def test_past_the_limit_names_the_row(algorithm, row):
    """Past 16,384 the CUDA route raises naming the row; the CPU route runs
    the plain version."""
    with pytest.raises(NotImplementedError, match=row):
        mel_kernels.cuda_route(algorithm, 2 * mel_kernels.MIXED_RADIX_MAX_N_FFT)


def test_only_b7_stays_unported():
    """Every algorithm of the JAX policy has a wrapper, B7's bf16x3 and f32
    too (the name is kept from when B7 was the one left): `MelFrontend`
    raises NotImplementedError on a CUDA tensor only past the n_fft limit."""
    assert set(port_mel.PORTED_ALGORITHMS) == set(mel_kernels.WRAPPERS) == set(
        port_mel._ROADMAP_ROW)
    assert {a: port_mel._ROADMAP_ROW[a] for a in ("bf16x3", "f32")} == {"bf16x3": "B7",
                                                                        "f32": "B7"}
    assert mel_kernels.MIXED_RADIX_MAX_N_FFT == 16384
    assert mel_kernels.mixed_radix_smem_bytes(16384) == 131_072
    for n_fft, hop, alg in ((512, 128, "radix4dif_fused"), (768, 256, "radix2_fused"),
                            (800, 200, "radix2"), (1022, 511, "bf16x3")):
        fe = port_mel.MelFrontend(n_fft=n_fft, hop_length=hop, duration=0.5, backend="pallas")
        assert fe._pallas_algorithm() == alg


# --- the slice at n_fft 512 / hop 128 ------------------------------------------

def _checkpoint_512(path, mixed_precision):
    """A JAX-written checkpoint at config.yaml's schema with n_fft 512 / hop
    128 and 2 s clips (251 frames), non-trivial BN statistics and a heavier
    head."""
    config = load_config(str(REPO / "config.yaml"))
    config["data"].update(n_fft=512, hop_length=128, duration=2.0)
    config["training"]["mixed_precision"] = mixed_precision
    v = jax.tree_util.tree_map(np.asarray, init_variables(
        jax_build_model(config), jax.random.PRNGKey(2), (1, 128, 251, 1)))
    rng = np.random.default_rng(9)
    for blk in v["batch_stats"].values():
        bn = blk["BatchNorm_0"]
        bn["mean"] = (0.05 * rng.standard_normal(bn["mean"].shape)).astype(np.float32)
        bn["var"] = (1.0 + rng.random(bn["var"].shape)).astype(np.float32)
    for name in ("Dense_0", "Dense_1"):
        v["params"][name]["kernel"] = v["params"][name]["kernel"] * 30.0
    return save_checkpoint(path, {"epoch": 1, "params": v["params"],
                                  "batch_stats": v["batch_stats"], "val_loss": 0.5,
                                  "config": config})


@pytest.mark.parametrize("mixed_precision, atol", [(False, 1e-4), (True, 5e-3)])
def test_engine_at_512_matches_jax(tmp_path, mixed_precision, atol):
    """The port's ClassifierEngine on the CPU against the JAX engine on one
    512/128 checkpoint (the JAX front end at its f32 XLA path at fp32, as
    tests/test_torch_engine.py explains)."""
    ckpt = _checkpoint_512(tmp_path / "c.ckpt", mixed_precision)
    rng = np.random.default_rng(13)
    wavs = np.stack([synth_respiratory_cycle(rng, i % 4, 2.0, SR) for i in range(5)]
                    ).astype(np.float32)
    jeng = JaxEngine(ckpt, batch_size=4)
    if not mixed_precision:
        jeng.frontend = jax_mel.MelFrontend.from_config(jeng.config, backend="xla")
    eng = ClassifierEngine(ckpt, batch_size=4, device="cpu")
    assert eng.frontend._pallas_algorithm() == "radix4dif_fused"
    assert eng.frontend.num_frames == 251
    want = jeng.predict_probs(wavs)
    got = eng.predict_probs(wavs)
    np.testing.assert_allclose(got, want, atol=atol)
    assert np.abs(want - want.mean(axis=0)).max() > 4 * 5e-3  # the classes spread
    one = eng.classify_wave(wavs[0])
    np.testing.assert_allclose(list(one["probabilities"].values()), got[0], atol=atol)


def test_augmented_train_step_at_512_matches_jax(flax_vars, rng, monkeypatch):  # noqa: F811
    """One augmented Adam step at 16 kHz, n_fft 512 / hop 128 (0.5 s, 63
    frames, 32 mels) against the JAX step with its own draws injected:
    loss within 1e-5, BN statistics 1e-4, the gradient 2 % per leaf
    (tests/test_torch_train_step.py's bars and helpers)."""
    monkeypatch.setattr(train_step_tests, "SMALL_FE", dict(
        sample_rate=SR, n_mels=32, n_fft=512, hop_length=128, duration=0.5))
    got, m, _, _, mu, want_mu = train_step_tests._run_steps(
        flax_vars, rng, "parallel", 2, "adam", 3e-3, augment=True)
    np.testing.assert_allclose(float(got["grad_norm"]), float(m["grad_norm"]), rtol=1e-3)
    for a_, b_ in zip(jax.tree_util.tree_leaves(mu), jax.tree_util.tree_leaves(want_mu)):
        a_, b_ = np.asarray(a_, np.float64), np.asarray(b_, np.float64)
        if b_.ndim:
            assert np.linalg.norm(a_ - b_) <= 2e-2 * np.linalg.norm(b_)


@pytest.mark.parametrize("mixed_precision", [False, True])
def test_analyzer_at_64_ms_windows_matches_jax(ckpts, recording, mixed_precision):  # noqa: F811
    """0.064 s windows: the front end runs n_fft 512 / hop 128 (row 3's
    shape) and resizes 9 -> 32 frames; the window probabilities match the
    JAX analyzer's within 1e-4 (fp32) or 5e-3 (bf16)."""
    ckpt, atol = ckpts[mixed_precision], ATOL[mixed_precision]
    jeng = jax_engine(ckpt, 0.064, mixed_precision)
    peng = port_engine(ckpt, 0.064)
    fe = peng.frontend
    assert (fe.n_fft, fe.hop_length, fe._inner.num_frames, fe.target_time_steps) == (512, 128, 9, 32)
    assert fe._inner._pallas_algorithm() == "radix4dif_fused"
    windows = peng.segment_audio(peng.load_audio(recording))[0]
    got = peng.predict_window_probs(windows)
    want = jeng.predict_window_probs(windows)
    assert got.shape == (len(windows), 4) and len(windows) > 100
    np.testing.assert_allclose(got, want, atol=atol)
