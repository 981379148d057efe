"""The fused-CNN slice: the port's conv-block wrappers and fused apply
against the JAX package's Pallas kernels and fused apply.

Weights are a flax init with non-trivial running statistics (as
tests/test_fused_cnn.py makes them), carried across with
state_dict_from_flax; inputs are made with numpy from a seed. On the CPU each
wrapper runs its plain version; the JAX kernels run in interpret mode.

Tolerances: a plain version and the JAX kernel take the same bf16 taps and
inputs, whose products are exact in f32, and round to bf16 at the same
place; they differ only in the order of the f32 sum, so by at most one bf16
ulp (rtol 2^-7, atol 1e-4 of the largest value). The fused apply runs four
more bf16 blocks and the head, held to 5e-3 in logits as
tests/test_fused_cnn.py holds the JAX fused apply to flax.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_classification_icbhi_tpu.inference import ClassifierEngine as JaxEngine
from audio_classification_icbhi_tpu.analyzers.engine import AnalyzerEngine as JaxAnalyzer
from audio_classification_icbhi_tpu.models import LightweightCNN as FlaxCNN
from audio_classification_icbhi_tpu.models import fused_infer as jax_fused
from audio_classification_icbhi_tpu.ops import pallas_conv
from audio_classification_icbhi_tpu.utils.checkpoint import save_checkpoint
from audio_classification_icbhi_tpu_torch.analyzers import AnalyzerEngine
from audio_classification_icbhi_tpu_torch.inference import ClassifierEngine
from audio_classification_icbhi_tpu_torch.models import LightweightCNN, fused_infer
from audio_classification_icbhi_tpu_torch.models.weights import state_dict_from_flax
from audio_classification_icbhi_tpu_torch.ops import conv_kernels as ck
from audio_classification_icbhi_tpu_torch.utils.config import load_config

SR = 16000
BF16_RTOL = 2.0 ** -7


@pytest.fixture(scope="module")
def variables():
    """LightweightCNN (bf16) variables with non-trivial running statistics."""
    rng = np.random.default_rng(7)
    v = FlaxCNN(num_classes=4, dtype=jnp.bfloat16).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 128, 157, 1)), train=False)
    v = jax.tree_util.tree_map(np.asarray, v)
    for st in v["batch_stats"].values():
        n = st["BatchNorm_0"]["mean"].shape[0]
        st["BatchNorm_0"]["mean"] = rng.standard_normal(n).astype(np.float32) * 0.1
        st["BatchNorm_0"]["var"] = rng.random(n).astype(np.float32) * 0.5 + 0.5
    # BN scale and bias away from 1 and 0, so that folding is exercised
    for blk in (f"ConvBlock_{i}" for i in range(5)):
        bn = v["params"][blk]["BatchNorm_0"]
        bn["scale"] = (1.0 + 0.2 * rng.standard_normal(bn["scale"].shape)).astype(np.float32)
        bn["bias"] = (0.1 * rng.standard_normal(bn["bias"].shape)).astype(np.float32)
    return v


def block_args(variables, i):
    p = variables["params"][f"ConvBlock_{i}"]
    s = variables["batch_stats"][f"ConvBlock_{i}"]["BatchNorm_0"]
    return (p["Conv_0"]["kernel"], p["BatchNorm_0"]["scale"], p["BatchNorm_0"]["bias"],
            s["mean"], s["var"])


def assert_one_bf16_ulp(got: torch.Tensor, want) -> None:
    assert got.dtype == torch.bfloat16
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=BF16_RTOL, atol=1e-4 * np.abs(want).max())


class TestPlainVersionsMatchPallas:
    @pytest.mark.parametrize("shape", [(3, 128, 157, 1), (2, 128, 64, 1), (1, 32, 9, 1)])
    def test_block1(self, variables, shape):
        x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
        args = block_args(variables, 0)
        want = pallas_conv.fused_conv_block1(jnp.asarray(x), *args, interpret=True)
        before = ck.fused_conv_block1.launches
        assert_one_bf16_ulp(ck.fused_conv_block1(torch.from_numpy(x), *args), want)
        assert ck.fused_conv_block1.launches == before  # the CPU launches nothing

    @pytest.mark.parametrize("shape", [(13, 32, 9, 1), (13, 64, 33, 1)])
    def test_block1_batched(self, variables, shape):
        """B = 13 with group 8: the JAX wrapper pads the batch to 16."""
        x = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
        args = block_args(variables, 0)
        want = pallas_conv.fused_conv_block1_batched(jnp.asarray(x), *args, group=8,
                                                     interpret=True)
        got = ck.fused_conv_block1_batched(torch.from_numpy(x), *args, group=8)
        assert_one_bf16_ulp(got, want)
        # the same function as the unbatched wrapper
        torch.testing.assert_close(got, ck.fused_conv_block1(torch.from_numpy(x), *args),
                                   rtol=0, atol=0)

    @pytest.mark.parametrize("blk, shape", [
        (1, (2, 64, 78, 32)), (1, (1, 64, 77, 32)), (1, (1, 8, 9, 32)),
        (2, (2, 32, 39, 64)), (2, (1, 16, 20, 64)),
    ])
    def test_packed(self, variables, blk, shape):
        x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
        args = block_args(variables, blk)
        jfn, tfn = ((pallas_conv.fused_conv_block2, ck.fused_conv_block2) if blk == 1
                    else (pallas_conv.fused_conv_block3, ck.fused_conv_block3))
        want = jfn(jnp.asarray(x), *args, interpret=True)
        assert_one_bf16_ulp(tfn(torch.from_numpy(x), *args), want)
        # bf16 input, as the chain hands it on, gives the same numbers
        xb = torch.from_numpy(x).to(torch.bfloat16)
        torch.testing.assert_close(tfn(xb, *args), tfn(torch.from_numpy(x), *args),
                                   rtol=0, atol=0)

    def test_true_w_and_pad_out_w(self, variables):
        """`test_prepadded_input_matches_unpadded`: a pre-padded buffer with
        true_w gives the unpadded result; pad_out_w appends zero columns;
        both as the JAX wrapper does."""
        args = block_args(variables, 1)
        rng = np.random.default_rng(4)
        x = rng.standard_normal((1, 8, 10, 32)).astype(np.float32)
        xpad = np.zeros((1, 8, 12, 32), np.float32)
        xpad[:, :, :10] = x
        xpad_junk = xpad.copy()
        xpad_junk[:, :, 10:] = 5.0  # columns past true_w are not read
        plain = ck.fused_conv_block2(torch.from_numpy(x), *args)
        for buf in (xpad, xpad_junk):
            torch.testing.assert_close(ck.fused_conv_block2(torch.from_numpy(buf), *args,
                                                            true_w=10), plain, rtol=0, atol=0)
        out_pad = ck.fused_conv_block2(torch.from_numpy(x), *args, pad_out_w=8)
        assert out_pad.shape == (1, 4, 8, 64)
        torch.testing.assert_close(out_pad[:, :, :5], plain, rtol=0, atol=0)
        assert bool((out_pad[:, :, 5:] == 0).all())
        want = pallas_conv.fused_conv_block2(jnp.asarray(xpad), *args, true_w=10, pad_out_w=8,
                                             interpret=True)
        assert_one_bf16_ulp(ck.fused_conv_block2(torch.from_numpy(xpad), *args, true_w=10,
                                                 pad_out_w=8), want)
        f1 = rng.standard_normal((1, 32, 9, 1)).astype(np.float32)
        b1 = ck.fused_conv_block1(torch.from_numpy(f1), *block_args(variables, 0), pad_out_w=7)
        assert b1.shape == (1, 16, 7, 32) and bool((b1[:, :, 4:] == 0).all())
        assert_one_bf16_ulp(b1, pallas_conv.fused_conv_block1(
            jnp.asarray(f1), *block_args(variables, 0), pad_out_w=7, interpret=True))


@pytest.mark.parametrize("case", [
    "block1_height", "block1_short", "block1_narrow", "block1_channels",
    "batched_height", "batched_group", "block2_channels", "block2_odd_height",
    "block2_true_w_wide", "block3_narrow",
])
def test_value_errors_match_jax(variables, case):
    """The shapes the JAX wrappers refuse (`pallas_conv.py:304-307`,
    `:394-399`, `:216-221`), refused by the port's with a ValueError too."""
    a0, a1, a2 = (block_args(variables, i) for i in range(3))
    calls = {
        "block1_height": ("fused_conv_block1", (1, 120, 157, 1), a0, {}),
        "block1_short": ("fused_conv_block1", (1, 16, 157, 1), a0, {}),
        "block1_narrow": ("fused_conv_block1", (1, 32, 3, 1), a0, {}),
        "block1_channels": ("fused_conv_block1", (1, 32, 8, 2), a0, {}),
        "batched_height": ("fused_conv_block1_batched", (2, 40, 8, 1), a0, {}),
        "batched_group": ("fused_conv_block1_batched", (2, 32, 8, 1), a0, {"group": 0}),
        "block2_channels": ("fused_conv_block2", (1, 64, 78, 64), a1, {}),
        "block2_odd_height": ("fused_conv_block2", (1, 7, 8, 32), a1, {}),
        "block2_true_w_wide": ("fused_conv_block2", (1, 8, 8, 32), a1, {"true_w": 9}),
        "block3_narrow": ("fused_conv_block3", (1, 8, 3, 64), a2, {}),
    }
    name, shape, args, kw = calls[case]
    x = np.zeros(shape, np.float32)
    with pytest.raises(ValueError):
        getattr(pallas_conv, name)(jnp.asarray(x), *args, interpret=True, **kw)
    with pytest.raises(ValueError):
        getattr(ck, name)(torch.from_numpy(x), *args, **kw)


@pytest.mark.parametrize("shape", [(1, 120, 157, 1), (1, 128, 157, 2), (1, 128, 157, 1),
                                   (1, 16, 8, 1), (1, 32, 3, 1), (128, 157, 1), (2, 48, 33, 1)])
def test_fused_apply_supported_matches_jax(shape):
    assert fused_infer.fused_apply_supported(shape) == jax_fused.fused_apply_supported(shape)


def test_weights_from_state_dict(variables):
    """The state_dict helper gives back the flax tree's HWIO kernel and BN
    leaves, and folding either gives the same constants."""
    sd = state_dict_from_flax(variables)
    for i in range(5):
        got = ck.block_args_from_state_dict(sd, i)
        for g, w in zip(got, block_args(variables, i)):
            np.testing.assert_array_equal(g.numpy(), w)
    a = ck.fold_conv_block(*ck.block_args_from_state_dict(sd, 2), bias_bf16=False)
    b = ck.fold_conv_block(*block_args(variables, 2), bias_bf16=False)
    for x, y in ((a.weight, b.weight), (a.bias, b.bias), (a.taps, b.taps)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert a.taps.shape == (9, 128, 64) and a.taps.dtype == torch.bfloat16
    f1 = ck.fold_conv_block(*block_args(variables, 0), bias_bf16=True)
    assert f1.taps.shape == (9, 32) and f1.taps.dtype == torch.float32
    # block 1's bias rides a bf16 row on the TPU; blocks 2-3 keep it in f32
    torch.testing.assert_close(f1.bias, f1.bias.to(torch.bfloat16).float(), rtol=0, atol=0)
    assert not torch.equal(a.bias, a.bias.to(torch.bfloat16).float())


# tests/test_fused_cnn.py's shapes: the serving shape, two others that fuse
# blocks 1-3 at other heights and widths, and (1, 64, 5, 1), which fuses
# block 1 only (w1 = 2) and runs blocks 2-5 plain.
APPLY_SHAPES = [(4, 128, 157, 1), (2, 128, 96, 1), (1, 48, 33, 1), (1, 64, 5, 1)]


@pytest.mark.parametrize("shape", APPLY_SHAPES)
def test_fused_apply_matches_jax_and_flax(variables, shape):
    feats = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    want_fused = np.asarray(jax_fused.make_fused_apply(variables, interpret=True)(
        jnp.asarray(feats)))
    want_flax = np.asarray(FlaxCNN(num_classes=4, dtype=jnp.bfloat16).apply(
        variables, jnp.asarray(feats), train=False))
    sd = state_dict_from_flax(variables)
    counts = [fn.launches for fn in (ck.fused_conv_block1, ck.fused_conv_block2,
                                     ck.fused_conv_block3)]
    with torch.inference_mode():
        got = fused_infer.make_fused_apply(sd, "cpu")(torch.from_numpy(feats))
    assert got.dtype == torch.float32 and got.shape == (shape[0], 4)
    np.testing.assert_allclose(got.numpy(), want_fused, atol=5e-3)
    np.testing.assert_allclose(got.numpy(), want_flax, atol=5e-3)
    assert [fn.launches for fn in (ck.fused_conv_block1, ck.fused_conv_block2,
                                   ck.fused_conv_block3)] == counts
    # a module gives the same apply as its state_dict
    model = LightweightCNN(dtype=torch.float32)
    model.load_state_dict(sd)
    with torch.inference_mode():
        again = fused_infer.make_fused_apply(model, "cpu")(torch.from_numpy(feats))
    torch.testing.assert_close(again, got, rtol=0, atol=0, equal_nan=True)
    # under 32 frames the map pools to nothing before block 5: flax, the JAX
    # fused apply and the port all give NaN logits there
    assert np.isnan(want_flax).all() == np.isnan(want_fused).all() == bool(
        torch.isnan(got).all()) == (shape[2] < 32)


@pytest.mark.parametrize("shape, fused_blocks", [((4, 128, 157, 1), 3), ((1, 48, 10, 1), 2),
                                                 ((1, 64, 5, 1), 1), ((1, 32, 14, 1), 2)])
def test_chain_decisions_follow_jax(variables, monkeypatch, shape, fused_blocks):
    """Which blocks run fused, counted through the folded entry points, is
    the JAX apply's decision (counted through its wrappers)."""
    seen = {"jax": [], "port": []}
    for mod, key, names in ((jax_fused, "jax", ("fused_conv_block1", "fused_conv_block2",
                                                 "fused_conv_block3")),
                            (ck, "port", ("conv_block1_folded", "conv_packed_folded"))):
        for name in names:
            orig = getattr(mod, name)

            def spy(*a, _orig=orig, _key=key, **kw):
                seen[_key].append(1)
                return _orig(*a, **kw)
            monkeypatch.setattr(mod, name, spy)
    feats = np.random.default_rng(6).standard_normal(shape).astype(np.float32)
    jax_fused.make_fused_apply(variables, interpret=True)(jnp.asarray(feats))
    with torch.inference_mode():
        fused_infer.make_fused_apply(state_dict_from_flax(variables), "cpu")(
            torch.from_numpy(feats))
    assert len(seen["jax"]) == len(seen["port"]) == fused_blocks


class TestSwitch:
    """`fused_cnn_enabled` is the one switch both engines ask."""

    @pytest.fixture(autouse=True)
    def _clean_env(self, monkeypatch):
        monkeypatch.delenv("ICBHI_FUSED_CNN", raising=False)
        monkeypatch.delenv("BENCH_FUSED_CNN", raising=False)

    @pytest.fixture
    def probe_passes(self, monkeypatch):
        calls = []
        monkeypatch.setattr(fused_infer, "fused_kernels_available",
                            lambda device="cuda": calls.append(device) or True)
        return calls

    def test_off_by_default(self, probe_passes):
        assert fused_infer.fused_cnn_enabled((1, 128, 157, 1)) is False
        assert fused_infer.fused_cnn_enabled((1, 128, 157, 1), "cuda") is False
        assert probe_passes == []

    def test_cpu_is_off(self, monkeypatch, probe_passes):
        monkeypatch.setenv("ICBHI_FUSED_CNN", "1")
        assert fused_infer.fused_cnn_enabled((1, 128, 157, 1), "cpu") is False
        assert fused_infer.fused_cnn_enabled((1, 128, 157, 1), torch.device("cpu")) is False
        assert probe_passes == []

    @pytest.mark.parametrize("name", ["ICBHI_FUSED_CNN", "BENCH_FUSED_CNN"])
    def test_either_name_turns_it_on(self, monkeypatch, probe_passes, name):
        monkeypatch.setenv(name, "1")
        assert fused_infer.fused_cnn_enabled((1, 128, 157, 1), "cuda") is True
        assert fused_infer.fused_cnn_enabled(None, "cuda:0") is True
        assert probe_passes == ["cuda", "cuda:0"]

    def test_parse(self, monkeypatch, probe_passes):
        for icbhi, bench, on in (("1", "0", True), ("0", "1", False), (None, "1", True),
                                 ("true", None, False), ("", "1", False), ("1", None, True)):
            for name, value in (("ICBHI_FUSED_CNN", icbhi), ("BENCH_FUSED_CNN", bench)):
                if value is None:
                    monkeypatch.delenv(name, raising=False)
                else:
                    monkeypatch.setenv(name, value)
            assert fused_infer.fused_cnn_enabled(None, "cuda") is on, (icbhi, bench)
            # the JAX package parses the same way (its backend check is
            # what keeps it False here)
            env = __import__("os").environ
            assert (env.get("ICBHI_FUSED_CNN", env.get("BENCH_FUSED_CNN", "0")) == "1") is on

    def test_unsupported_shape_is_off(self, monkeypatch, probe_passes):
        monkeypatch.setenv("ICBHI_FUSED_CNN", "1")
        assert fused_infer.fused_cnn_enabled((1, 120, 157, 1), "cuda") is False
        assert fused_infer.fused_cnn_enabled((1, 128, 3, 1), "cuda") is False
        assert probe_passes == []

    def test_probe_raises_without_a_card(self, monkeypatch):
        monkeypatch.setenv("ICBHI_FUSED_CNN", "1")
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA device"):
            fused_infer.fused_cnn_enabled((1, 128, 157, 1), "cuda")


class TestProbe:
    def test_passes_on_the_plain_versions(self):
        assert fused_infer.fused_kernels_available("cpu") is True

    @pytest.mark.parametrize("name", ["fused_conv_block1", "fused_conv_block1_batched",
                                      "fused_conv_block2", "fused_conv_block3"])
    def test_a_wrong_kernel_raises(self, monkeypatch, name):
        """A wrapper that returns wrong numbers makes the probe raise; it
        does not warn and fall back as the JAX probe does."""
        monkeypatch.setattr(fused_infer, "_PROBED", set())
        orig = getattr(ck, name)
        monkeypatch.setattr(ck, name, lambda *a, **kw: orig(*a, **kw) + 0.25)
        with pytest.raises(RuntimeError, match="probe numerics mismatch"):
            fused_infer.fused_kernels_available("cpu")


def _checkpoint(path, duration: float):
    config = load_config()
    config["data"]["duration"] = duration
    config["training"]["mixed_precision"] = True
    v = FlaxCNN(num_classes=4, dtype=jnp.bfloat16).init(
        jax.random.PRNGKey(3), jnp.zeros((1, 128, 32, 1)), train=False)
    v = jax.tree_util.tree_map(np.asarray, v)
    rng = np.random.default_rng(8)
    for st in v["batch_stats"].values():
        bn = st["BatchNorm_0"]
        bn["mean"] = (0.05 * rng.standard_normal(bn["mean"].shape)).astype(np.float32)
        bn["var"] = (1.0 + rng.random(bn["var"].shape)).astype(np.float32)
    for name in ("Dense_0", "Dense_1"):
        v["params"][name]["kernel"] = v["params"][name]["kernel"] * 30.0
    return str(save_checkpoint(path, {"epoch": 1, "params": v["params"],
                                      "batch_stats": v["batch_stats"], "val_loss": 0.5,
                                      "config": config}))


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return _checkpoint(tmp_path_factory.mktemp("fused") / "m.ckpt", 1.0)


def test_engines_on_the_cpu_run_the_model(ckpt, monkeypatch):
    """With the switch set, both engines on the CPU run the model's forward
    (as the JAX engines run flax off the TPU), and agree with the JAX
    engines, which the switch leaves on flax here too."""
    monkeypatch.setenv("ICBHI_FUSED_CNN", "1")
    wavs = (0.1 * np.random.default_rng(9).standard_normal((3, SR))).astype(np.float32)
    eng = ClassifierEngine(ckpt, batch_size=4, device="cpu")
    got = eng.predict_probs(wavs)
    assert eng._apply_fn is eng.model
    np.testing.assert_allclose(got, JaxEngine(ckpt, batch_size=4).predict_probs(wavs), atol=5e-3)

    windows = (0.1 * np.random.default_rng(10).standard_normal((5, SR // 2))).astype(np.float32)
    ana = AnalyzerEngine(ckpt, segment_duration=0.5, device="cpu")
    got = ana.predict_window_probs(windows)
    assert ana._apply_fn is ana.classifier.model
    want = JaxAnalyzer(ckpt, segment_duration=0.5).predict_window_probs(windows)
    np.testing.assert_allclose(got, want, atol=5e-3)


def test_engines_route_through_the_fused_apply(ckpt, monkeypatch):
    """Where the switch holds (forced here, as on the card) both engines
    run the fused apply, and their probabilities stay within 5e-3 of the
    model's forward; the engines ask with their own feature shapes."""
    import audio_classification_icbhi_tpu_torch.analyzers.engine as ana_mod
    import audio_classification_icbhi_tpu_torch.inference as inf_mod

    wavs = (0.1 * np.random.default_rng(11).standard_normal((3, SR))).astype(np.float32)
    windows = wavs[:, : SR // 2].copy()
    plain = ClassifierEngine(ckpt, batch_size=4, device="cpu")
    plain_ana = AnalyzerEngine(ckpt, segment_duration=0.5, device="cpu")
    want, want_w = plain.predict_probs(wavs), plain_ana.predict_window_probs(windows)
    asked = []
    for mod in (inf_mod, ana_mod):
        monkeypatch.setattr(mod, "fused_cnn_enabled",
                            lambda shape, device: asked.append((shape, str(device))) or True)
    eng = ClassifierEngine(ckpt, batch_size=4, device="cpu")
    ana = AnalyzerEngine(ckpt, segment_duration=0.5, device="cpu")
    got, got_w = eng.predict_probs(wavs), ana.predict_window_probs(windows)
    one = eng.classify_wave(wavs[0])
    assert eng._apply_fn is not eng.model and ana._apply_fn is not ana.classifier.model
    assert asked == [((1, 128, 32, 1), "cpu"), ((1, 128, 4, 1), "cpu")]
    np.testing.assert_allclose(got, want, atol=5e-3)
    np.testing.assert_allclose(got_w, want_w, atol=5e-3)
    np.testing.assert_allclose(list(one["probabilities"].values()), got[0], atol=1e-6)
