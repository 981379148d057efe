"""Checkpoint files cross between the JAX package and the port, bit-exact."""

import numpy as np
import pytest

from audio_classification_icbhi_tpu.utils import checkpoint as jax_ckpt
from audio_classification_icbhi_tpu_torch.utils import checkpoint as port_ckpt


def payload(rng):
    return {
        "epoch": 7,
        "val_loss": 0.8125,
        "params": {
            "ConvBlock_0": {"Conv_0": {"kernel": rng.standard_normal((3, 3, 1, 32)).astype(np.float32)}},
            "Dense_0": {"bias": rng.standard_normal(128).astype(np.float32)},
            "counts": np.arange(-3, 300, dtype=np.int64),
            "flags": np.array([True, False]),
            "half": rng.standard_normal((2, 5)).astype(np.float16),
            "empty": np.zeros((0, 4), np.float32),
        },
        "batch_stats": {"ConvBlock_0": {"BatchNorm_0": {"mean": np.float32(0.5) * np.ones(32, np.float32)}}},
        "config": {"data": {"sample_rate": 16000, "duration": 5.0, "f_max": None},
                   "classes": ["normal", "crackles", "wheezes", "both"],
                   "model": {"architecture": "cnn", "num_classes": 4, "dropout": 0.3},
                   "note": "ü" * 40 + "x" * 300},
        "big_int": 2 ** 40,
        "neg": -70000,
        "scalar": np.float64(1.25),
        "long_list": list(range(20)),
    }


def assert_same(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (a.keys(), b.keys())
        for k in a:
            assert_same(a[k], b[k])
    elif isinstance(a, (np.ndarray, np.generic)):
        assert np.asarray(b).dtype == np.asarray(a).dtype
        assert np.asarray(b).shape == np.asarray(a).shape
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    else:
        assert a == b and type(a) is type(b), (a, b)


def test_jax_written_file_loads_in_port(tmp_path, rng):
    p = payload(rng)
    path = jax_ckpt.save_checkpoint(tmp_path / "jax.ckpt", p)
    got = port_ckpt.load_checkpoint(path)
    want = jax_ckpt.load_checkpoint(path)
    assert got["config"] == p["config"]
    assert_same(want, got)


def test_port_written_file_loads_in_jax(tmp_path, rng):
    p = payload(rng)
    path = port_ckpt.save_checkpoint(tmp_path / "port.ckpt", p)
    got = jax_ckpt.load_checkpoint(path)
    assert got["config"] == p["config"]
    assert_same(port_ckpt.load_checkpoint(path), got)
    np.testing.assert_array_equal(got["params"]["counts"], p["params"]["counts"])
    # lists travel as flax's position-keyed dicts
    assert got["long_list"] == {str(i): i for i in range(20)}


def test_torch_tensors_are_written_as_arrays(tmp_path):
    import torch

    t = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    path = port_ckpt.save_checkpoint(tmp_path / "t.ckpt", {"w": t, "b": t.to(torch.bfloat16)})
    back = port_ckpt.load_checkpoint(path)
    np.testing.assert_array_equal(back["w"], t.numpy())
    assert back["b"].dtype == torch.bfloat16 and torch.equal(back["b"], t.to(torch.bfloat16))


def test_truncated_file_raises(tmp_path, rng):
    path = port_ckpt.save_checkpoint(tmp_path / "t.ckpt", payload(rng))
    path.write_bytes(path.read_bytes()[:-10])
    with pytest.raises(ValueError, match="truncated"):
        port_ckpt.load_checkpoint(path)
