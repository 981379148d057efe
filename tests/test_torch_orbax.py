"""Orbax checkpoint directories between the JAX package (orbax itself) and
the port's own reader and writer (`utils/orbax_format.py`).

`python tests/test_torch_orbax.py` rewrites the committed fixture
(`tests/data/orbax_jax_fixture/`, written by the JAX package's
`save_checkpoint(format="orbax")`) and the values recorded beside it.
"""

import json
import os
import shutil
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import tensorstore as ts
import torch
import zstandard

from audio_classification_icbhi_tpu.inference import ClassifierEngine as JaxEngine
from audio_classification_icbhi_tpu.ops.mel import MelFrontend as JaxMelFrontend
from audio_classification_icbhi_tpu.utils import checkpoint as jax_ckpt
from audio_classification_icbhi_tpu_torch import validate
from audio_classification_icbhi_tpu_torch.inference import ClassifierEngine
from audio_classification_icbhi_tpu_torch.utils import checkpoint as port_ckpt
from audio_classification_icbhi_tpu_torch.utils import orbax_format
from chip_smoke import orbax_record as record

DATA = Path(__file__).resolve().parent / "data"
FIXTURE = DATA / "orbax_jax_fixture"
FIXTURE_VALUES = DATA / "orbax_jax_fixture.json"
FIXTURE_SEED = 18


def payload(seed: int, structured: bool = False) -> dict:
    """`tests/test_training.py`'s orbax payload (the optax-like tuple state
    included) with bf16, a float64 scale_state, bool, an int32 scalar, an
    empty subtree and the ICBHI extras; `structured` adds a 32 KB smooth
    f32 array, whose zstd frame holds Huffman literals and FSE sequences.
    bf16 leaves are JAX arrays here (`port_payload` makes them tensors)."""
    rng = np.random.default_rng(seed)
    params = {"dense": {"kernel": np.ones((4, 2), np.float32)},
              "conv": {"kernel": rng.standard_normal((3, 3, 1, 8)).astype(np.float32)},
              "half": jnp.asarray(rng.standard_normal((2, 5)), jnp.bfloat16)}
    if structured:
        t = np.arange(64 * 128, dtype=np.float32).reshape(64, 128)
        params["dense"]["smooth"] = np.round(np.sin(t / 40.0) * 64.0) / 64.0
    return {
        "epoch": 3,
        "params": params,
        "batch_stats": {"bn": {"mean": np.zeros(4, np.float32)}},
        "opt_state": ({"count": np.int32(7)}, {"mu": np.ones(2, np.float32)}, ()),
        "val_loss": 0.5,
        "config": {"model": {"architecture": "cnn"}, "classes": ["a", "b"]},
        "class_weights": np.array([1.0, 2.0], np.float32),
        "scheduler": {"last_lr": 0.001, "bad_epochs": 2},
        "best_metric": 0.9,
        "patience_counter": 1,
        "scale_state": np.array([65536.0, 3.0], np.float64),
        "flags": np.array([True, False, True]),
        "icbhi_score": 0.625,
        "icbhi_metrics": {"avg_sensitivity": 0.5, "avg_specificity": 0.75},
    }


def port_payload(p):
    """The same payload as the port's trainer holds it: bf16 as torch."""
    if isinstance(p, dict):
        return {k: port_payload(v) for k, v in p.items()}
    if isinstance(p, tuple):
        return tuple(port_payload(v) for v in p)
    if hasattr(p, "dtype") and str(p.dtype) == "bfloat16":
        return torch.from_numpy(np.asarray(p).view(np.int16).copy()).view(torch.bfloat16)
    return p


def bits(x) -> tuple:
    """(dtype name, shape, raw bytes) of an array leaf of either package."""
    if isinstance(x, torch.Tensor):
        assert x.dtype == torch.bfloat16 and x.device.type == "cpu"
        return "bfloat16", tuple(x.shape), x.view(torch.int16).numpy().tobytes()
    x = np.asarray(x)
    return str(x.dtype), x.shape, x.tobytes()


def assert_same(got, want, where="") -> None:
    """Keys, dtypes and values equal; bf16 a torch tensor on the port's
    side, an ml_dtypes array on the JAX side."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (where, got, want)
        for k in want:
            assert_same(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, (np.ndarray, np.generic)) or isinstance(got, torch.Tensor):
        assert bits(got) == bits(want), where
    else:
        assert got == want and type(got) is type(want), (where, got, want)


def kv_store(path: Path):
    return ts.KvStore.open({"driver": "ocdbt", "base": f"file://{path.resolve()}/"}).result()


# --- the two packages on each other's directories -------------------------------

def test_jax_written_directory_loads_in_port(tmp_path):
    path = jax_ckpt.save_checkpoint(tmp_path / "jax.ckpt", payload(0), format="orbax")
    assert (path / "state" / "ocdbt.process_0").is_dir()
    got = port_ckpt.load_checkpoint(path)
    assert_same(got, jax_ckpt.load_checkpoint(path))
    assert got["opt_state"]["2"] == {} and got["opt_state"]["0"]["count"].shape == ()


def test_port_written_directory_loads_in_jax(tmp_path):
    p = payload(1)
    path = port_ckpt.save_checkpoint(tmp_path / "port.ckpt", port_payload(p), format="orbax")
    want = jax_ckpt.load_checkpoint(path)
    assert_same(port_ckpt.load_checkpoint(path), want)
    # and it holds what the JAX package itself writes for the payload
    assert_same(want, jax_ckpt.load_checkpoint(
        jax_ckpt.save_checkpoint(tmp_path / "jax.ckpt", p, format="orbax")))


def test_files_equal_jax_package(tmp_path):
    """_METADATA, meta/metadata and every .zarray byte for byte, the same
    keys and chunk contents, _CHECKPOINT_METADATA but for its timestamps."""
    p = payload(2)
    mine = port_ckpt.save_checkpoint(tmp_path / "port.ckpt", port_payload(p), format="orbax")
    theirs = jax_ckpt.save_checkpoint(tmp_path / "jax.ckpt", p, format="orbax")
    for name in ("state/_METADATA", "meta/metadata"):
        assert (mine / name).read_bytes() == (theirs / name).read_bytes(), name
    a, b = (json.loads((d / "_CHECKPOINT_METADATA").read_text()) for d in (mine, theirs))
    assert list(a) == list(b)
    for k in ("init_timestamp_nsecs", "commit_timestamp_nsecs"):
        assert a.pop(k) > 0 and b.pop(k) > 0
    assert a == b
    ka, kb = kv_store(mine / "state"), kv_store(theirs / "state")
    keys = kb.list().result()
    entries = json.loads((theirs / "state" / "_METADATA").read_text())["tree_metadata"]
    arrays = sum(e["value_metadata"]["value_type"] == "np.ndarray" for e in entries.values())
    assert ka.list().result() == keys and len(keys) == 2 * arrays
    dctx = zstandard.ZstdDecompressor()
    for key in keys:
        va, vb = ka.read(key).result().value, kb.read(key).result().value
        if key.endswith(b"/.zarray"):
            assert va == vb, key
        else:
            assert dctx.decompress(va) == dctx.decompressobj().decompress(vb), key
    assert sorted(os.listdir(mine / "state")) == ["_METADATA", "d", "manifest.ocdbt"]


def test_tensorstore_chunked_array(tmp_path):
    """A zarr v2 array written by tensorstore with chunks (3, 5) over
    (7, 11): padded edge chunks, and a never-written chunk read as the
    fill value."""
    want = np.arange(77, dtype=np.float32).reshape(7, 11) * 0.5
    want[6:, 10:] = 1.5  # chunk (2, 2): left at the fill value
    arr = ts.open({"driver": "zarr",
                   "kvstore": {"driver": "ocdbt", "base": f"file://{tmp_path}/", "path": "w/"},
                   "metadata": {"shape": [7, 11], "chunks": [3, 5], "dtype": "<f4",
                                "fill_value": 1.5, "compressor": {"id": "zstd", "level": 5}},
                   "create": True}).result()
    arr[:6, :].write(want[:6]).result()
    arr[6:, :10].write(want[6:, :10]).result()
    kv = orbax_format.read_ocdbt(tmp_path)
    assert "w/2.2" not in kv and "w/2.1" in kv and "w/0.0" in kv
    got = orbax_format.read_zarr(kv, "w")
    assert got.dtype == np.float32 and np.array_equal(got, want)


def test_interior_btree_nodes(tmp_path):
    """A database whose B-tree has interior nodes (node size 300 bytes),
    inline and out-of-line values: every key and value as tensorstore
    reads them."""
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp_path}/",
                          "config": {"max_decoded_node_bytes": 300,
                                     "max_inline_value_bytes": 16}}).result()
    want = {f"key{i:03d}/v".encode(): bytes([i]) * (i % 40) for i in range(90)}
    with ts.Transaction() as txn:
        for k, v in want.items():
            kv.with_transaction(txn)[k] = v
    got = orbax_format.read_ocdbt(tmp_path)
    assert {k.encode(): v for k, v in got.items()} == want


@pytest.mark.parametrize("target", ["manifest", "node"])
def test_flipped_byte_raises_naming_the_file(tmp_path, target):
    path = port_ckpt.save_checkpoint(tmp_path / "c.ckpt", port_payload(payload(3)),
                                     format="orbax")
    f = path / "state" / "manifest.ocdbt" if target == "manifest" else next(
        (path / "state" / "d").iterdir())
    data = bytearray(f.read_bytes())
    data[-40] ^= 0x10  # in the manifest's body, or in the node after the data
    f.write_bytes(bytes(data))
    with pytest.raises(ValueError, match=f"{f.name}.*crc32c mismatch"):
        port_ckpt.load_checkpoint(path)


def test_overwrite_and_failed_write(tmp_path, monkeypatch):
    """A save over an existing checkpoint replaces it (orbax's force=True);
    an exception while writing leaves nothing under the final name but
    what was there, and no temporary directory."""
    path = tmp_path / "best_model.ckpt"
    port_ckpt.save_checkpoint(path, {"epoch": 1, "w": np.zeros(3, np.float32)}, format="orbax")
    port_ckpt.save_checkpoint(path, {"epoch": 2, "w": np.ones(5, np.float32)}, format="orbax")
    got = port_ckpt.load_checkpoint(path)
    assert got["epoch"] == 2 and np.array_equal(got["w"], np.ones(5, np.float32))
    assert os.listdir(tmp_path) == ["best_model.ckpt"]

    write = orbax_format.write_ocdbt

    def crash(*args):
        write(*args)
        raise KeyboardInterrupt("killed mid-write")

    monkeypatch.setattr(orbax_format, "write_ocdbt", crash)
    for target in (path, tmp_path / "fresh.ckpt"):
        with pytest.raises(KeyboardInterrupt):
            port_ckpt.save_checkpoint(target, {"epoch": 3, "w": np.ones(2, np.float32)},
                                      format="orbax")
    assert os.listdir(tmp_path) == ["best_model.ckpt"]
    assert port_ckpt.load_checkpoint(path)["epoch"] == 2


@pytest.mark.parametrize("field", ["use_zarr3", "use_ocdbt", "dtype", "compressor"])
def test_unwritten_layouts_raise(tmp_path, field):
    path = port_ckpt.save_checkpoint(tmp_path / "c.ckpt", {"w": np.ones(3, np.float32)},
                                     format="orbax")
    if field in ("use_zarr3", "use_ocdbt"):
        md = json.loads((path / "state" / "_METADATA").read_text())
        md[field] = not md[field]
        (path / "state" / "_METADATA").write_text(json.dumps(md))
        match = f"{field}: {str(md[field]).lower()}"
    else:
        kv = orbax_format.read_ocdbt(path / "state")
        meta = json.loads(kv["w/.zarray"])
        meta[field] = "<c8" if field == "dtype" else {"id": "blosc"}
        kv["w/.zarray"] = json.dumps(meta).encode()
        shutil.rmtree(path / "state" / "d")
        (path / "state" / "manifest.ocdbt").unlink()
        orbax_format.write_ocdbt(path / "state", [(k.encode(), [v]) for k, v in kv.items()])
        match = f"{field} .*(c8|blosc)"
    with pytest.raises(NotImplementedError, match=match):
        port_ckpt.load_checkpoint(path)


def test_unknown_format_and_unwritable_leaves(tmp_path):
    with pytest.raises(ValueError, match="unknown checkpoint format"):
        port_ckpt.save_checkpoint(tmp_path / "x.ckpt", {"epoch": 0}, format="pickle")
    with pytest.raises(ValueError, match="zero size"):
        port_ckpt.save_checkpoint(tmp_path / "x.ckpt", {"w": np.zeros((0, 3))}, format="orbax")
    with pytest.raises(TypeError, match="str"):
        port_ckpt.save_checkpoint(tmp_path / "x.ckpt", {"w": "text"}, format="orbax")
    with pytest.raises(ValueError, match="needs state"):
        port_ckpt.save_checkpoint(tmp_path / "x.ckpt", {"epoch": 1}, format="orbax")
    assert not list(tmp_path.iterdir())


def test_async_writer_writes_orbax(tmp_path):
    p = port_payload(payload(4))
    p["params"]["conv"]["kernel"] = torch.from_numpy(p["params"]["conv"]["kernel"].copy())
    before = p["params"]["conv"]["kernel"].numpy().copy()
    writer = port_ckpt.AsyncCheckpointWriter()
    writer.save(tmp_path / "a.ckpt", p, format="orbax")
    p["params"]["conv"]["kernel"].add_(1.0)  # after the snapshot: not in the directory
    writer.close()
    got = port_ckpt.load_checkpoint(tmp_path / "a.ckpt")
    np.testing.assert_array_equal(got["params"]["conv"]["kernel"], before)
    assert_same(got, jax_ckpt.load_checkpoint(tmp_path / "a.ckpt"))


# --- the committed fixture --------------------------------------------------------

def test_fixture_reads_equal_in_both_packages(tmp_path):
    """The fixture, rebuilt from its seed, reads back equal in both packages
    and matches the values recorded beside it (which the card's check
    reads); its smooth array's frame is compressed, not raw."""
    assert sum(f.stat().st_size for f in FIXTURE.rglob("*") if f.is_file()) <= 64 * 1024
    want = jax_ckpt.load_checkpoint(FIXTURE)
    got = port_ckpt.load_checkpoint(FIXTURE)
    assert_same(got, want)
    rebuilt = jax_ckpt.load_checkpoint(jax_ckpt.save_checkpoint(
        tmp_path / "fixture", payload(FIXTURE_SEED, structured=True), format="orbax"))
    assert_same(got, rebuilt)
    assert record(got) == json.loads(FIXTURE_VALUES.read_text())  # as chip_smoke checks it
    frame = orbax_format.read_ocdbt(FIXTURE / "state")["params.dense.smooth/0.0"]
    assert len(frame) < 32 * 1024 // 2 and frame[4] & 0x20 == 0  # no content size, compressed


# --- consumers of a JAX-written orbax directory ------------------------------------

def test_engine_serves_jax_orbax_directory(tmp_path):
    """ClassifierEngine on a directory the JAX package wrote, held to the
    JAX engine at the fp32 tolerance of tests/test_torch_engine.py."""
    from test_torch_engine import _checkpoint, SR
    from audio_classification_icbhi_tpu.data.synthetic import synth_respiratory_cycle

    ckpt = jax_ckpt.load_checkpoint(_checkpoint(tmp_path / "m.ckpt", False))
    path = jax_ckpt.save_checkpoint(tmp_path / "m_orbax.ckpt", ckpt, format="orbax")
    rng = np.random.default_rng(11)
    wavs = np.stack([synth_respiratory_cycle(rng, i % 4, 5.0, SR) for i in range(3)]
                    ).astype(np.float32)
    jax_engine = JaxEngine(path, batch_size=4)
    jax_engine.frontend = JaxMelFrontend.from_config(jax_engine.config, backend="xla")
    want = jax_engine.predict_probs(wavs)
    eng = ClassifierEngine(path, batch_size=4, device="cpu")
    np.testing.assert_allclose(eng.predict_probs(wavs), want, atol=1e-4)
    msgpack = ClassifierEngine(tmp_path / "m.ckpt", batch_size=4, device="cpu")
    np.testing.assert_array_equal(eng.predict_probs(wavs), msgpack.predict_probs(wavs))


def test_validate_reads_jax_orbax_directory(tmp_path):
    """`validate` on a JAX-written orbax directory gives the arrays it
    gives on the msgpack file of the same checkpoint."""
    from test_torch_validation import REPO, cnn_variables, small_config
    from audio_classification_icbhi_tpu_torch.data.synthetic import generate_icbhi_dataset

    corpus = generate_icbhi_dataset(tmp_path / "corpus", num_recordings=8, seed=4)
    config = small_config()
    v = cnn_variables(config)
    ckpt = {"epoch": 1, "params": v["params"], "batch_stats": v["batch_stats"],
            "val_loss": 0.5, "config": config}
    results = []
    for fmt in ("orbax", "msgpack"):
        path = jax_ckpt.save_checkpoint(tmp_path / f"{fmt}.ckpt", ckpt, format=fmt)
        results.append(validate.main([
            "--model", str(path), "--config", str(REPO / "config.yaml"), "--split", "train",
            "--data-path", str(corpus), "--output-dir", str(tmp_path / fmt), "--device", "cpu",
            "--no-plots"]))
    assert len(results[0]["y_true"]) > 0
    for k in ("y_true", "y_pred", "y_prob"):
        np.testing.assert_array_equal(results[0][k], results[1][k])


def test_port_reads_and_writes_without_orbax_or_jax(tmp_path):
    """The port reads the fixture and round-trips a directory with jax,
    flax, optax, orbax, tensorstore, zstandard and the JAX package blocked."""
    import subprocess

    code = f"""
import sys
sys.path.insert(0, {str(DATA.parents[1])!r})
for blocked in ("jax", "flax", "optax", "orbax", "tensorstore", "zstandard", "msgpack",
                "audio_classification_icbhi_tpu"):
    sys.modules[blocked] = None
import numpy as np
from audio_classification_icbhi_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
got = load_checkpoint({str(FIXTURE)!r})
path = save_checkpoint({str(tmp_path / "c.ckpt")!r}, got, format="orbax")
back = load_checkpoint(path)
assert np.array_equal(back["params"]["dense"]["smooth"], got["params"]["dense"]["smooth"])
print(sorted(back))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "icbhi_metrics" in out.stdout


def write_fixture() -> None:
    """Rewrite the fixture and its record from FIXTURE_SEED."""
    shutil.rmtree(FIXTURE, ignore_errors=True)
    jax_ckpt.save_checkpoint(FIXTURE, payload(FIXTURE_SEED, structured=True), format="orbax")
    FIXTURE_VALUES.write_text(json.dumps(record(port_ckpt.load_checkpoint(FIXTURE)), indent=1)
                              + "\n")
    size = sum(f.stat().st_size for f in FIXTURE.rglob("*") if f.is_file())
    print(f"wrote {FIXTURE} ({size} bytes) and {FIXTURE_VALUES.name}")


if __name__ == "__main__":
    sys.exit(write_fixture())
