"""Orbax checkpoint directories, read and written without orbax.

The JAX package's `save_checkpoint(..., format="orbax")`
(`audio_classification_icbhi_tpu/utils/checkpoint.py:49-67`) writes an
orbax `CompositeCheckpointHandler` directory:

- `_CHECKPOINT_METADATA`: orbax's JSON, naming the two item handlers;
- `meta/metadata`: JSON of the payload's `_META_KEYS` (epoch, val_loss,
  config, ...);
- `state/_METADATA`: JSON whose `tree_metadata` holds each leaf's key tuple
  and value type ("np.ndarray", "scalar", "Dict" / "None" for an empty
  subtree), beside `use_ocdbt: true` and `use_zarr3: false`;
- `state/`: a TensorStore OCDBT database (a B-tree key-value store) whose
  keys are zarr v2 arrays named by the joined key tuple:
  `params.conv.kernel/.zarray` (JSON) and `params.conv.kernel/0.0.0.0`
  (a chunk: a zstd frame of the C-order bytes).

OCDBT (TensorStore's "optionally-cooperative distributed B-tree"): the
manifest `state/manifest.ocdbt` and every B-tree node share one envelope, a
big-endian magic (0x0cdb3a2a manifest, 0x0cdb20de node), the file's length
(u64 LE), a varint format version (0) and a varint compression (0 none, 1
zstd), then the body, then a crc32c (LE) of everything before it. The
manifest's body holds the database's config, a table of data files and the
versions (columns of varints), the last of which names the B-tree's root:
(data file, offset, length) and its height. A node holds its height, its
own table of data files (paths prefix-compressed, each with a base path
that the files its children name are relative to), and its entries in
columns: keys prefix-compressed and, within an interior node's subtree,
stripped of the prefix every key there shares; a leaf's values inline or
as (data file, offset, length); an interior node's children likewise.

`load` reads such a directory with `native.zstd_decompress` (the
hand-written decoder in `native/zstd.cc`; there is no Python path) and
verifies every crc32c. `save` writes what `_save_orbax` writes for the same
payload, with two differences a reader cannot tell: each zstd frame holds
raw blocks (so writing needs no encoder and no library), and the database
is single-level, one manifest with its nodes and data under `state/`, where
orbax adds a per-process sub-database (`state/ocdbt.process_0/`). A layout
the JAX package does not write raises NotImplementedError naming the field.
"""

from __future__ import annotations

import itertools
import json
import os
import shutil
import struct
import time
import uuid
from pathlib import Path
from typing import Any, Iterator

import numpy as np
import torch

from audio_classification_icbhi_tpu_torch import native

# payload keys that are JSON metadata, not array trees (the JAX package's
# checkpoint.py:45)
META_KEYS = ("epoch", "val_loss", "config", "icbhi_score", "icbhi_metrics",
             "scheduler", "best_metric", "patience_counter")

ITEM_HANDLERS = {
    "meta": "orbax.checkpoint._src.handlers.json_checkpoint_handler.JsonCheckpointHandler",
    "state": "orbax.checkpoint._src.handlers.standard_checkpoint_handler."
             "StandardCheckpointHandler",
}

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
# the config orbax's OCDBT databases carry
MAX_INLINE_VALUE_BYTES = 1024
MAX_DECODED_NODE_BYTES = 100_000_000
VERSION_TREE_ARITY_LOG2 = 4
_MISSING = (1 << 64) - 1  # a version's root offset and length when its tree is empty
_MANIFEST_LIMIT = 1 << 26  # decoded bytes a manifest may take

ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"
ZSTD_BLOCK = 128 * 1024


# --- zstd raw-block frames and CRC32C, for writing (no library needed) -------

def _raw_frame_parts(data: memoryview) -> Iterator[bytes | memoryview]:
    """A zstd frame of `data` in raw blocks of at most 128 KiB:
    Single_Segment, with the content size in 1, 2, 4 or 8 bytes."""
    n = len(data)
    if n < 256:
        head = bytes([0x20, n])
    elif n < 65536 + 256:
        head = bytes([0x60]) + struct.pack("<H", n - 256)
    elif n < 1 << 32:
        head = bytes([0xA0]) + struct.pack("<I", n)
    else:
        head = bytes([0xE0]) + struct.pack("<Q", n)
    yield ZSTD_MAGIC + head
    pos = 0
    while True:
        size = min(ZSTD_BLOCK, n - pos)
        last = pos + size == n
        yield struct.pack("<I", (size << 3) | int(last))[:3]
        yield data[pos:pos + size]
        pos += size
        if last:
            return


def zstd_raw_frame(data) -> bytes:
    return b"".join(_raw_frame_parts(memoryview(data).cast("B")))


def _crc32c_table() -> list[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c_py(data: bytes) -> int:
    """CRC32C in Python, for the small manifests and nodes the writer
    frames (the reader verifies with the library's)."""
    c = 0xFFFFFFFF
    for b in data:
        c = _CRC_TABLE[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


# --- byte cursor ---------------------------------------------------------------

class _Cursor:
    def __init__(self, data: bytes, what: str):
        self.data = data
        self.pos = 0
        self.what = what

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError(f"{self.what}: truncated")
        v = self.data[self.pos:self.pos + n]
        self.pos += n
        return v

    def byte(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        v, shift = 0, 0
        while True:
            b = self.byte()
            v |= (b & 0x7F) << shift
            if not b & 0x80:
                return v
            shift += 7
            if shift > 63:
                raise ValueError(f"{self.what}: varint too long")

    def varints(self, n: int) -> list[int]:
        return [self.varint() for _ in range(n)]


def _varint(v: int) -> bytes:
    out = bytearray()
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def _varints(vs) -> bytes:
    return b"".join(_varint(v) for v in vs)


# --- OCDBT reader --------------------------------------------------------------

def _unwrap(data: bytes, magic: int, what: str, limit: int) -> bytes:
    """The body of a manifest or node envelope, its crc32c verified."""
    if len(data) < 18:
        raise ValueError(f"{what}: truncated OCDBT file ({len(data)} bytes)")
    got = struct.unpack_from(">I", data)[0]
    if got != magic:
        raise ValueError(f"{what}: magic 0x{got:08x}, 0x{magic:08x} expected")
    if struct.unpack_from("<Q", data, 4)[0] != len(data):
        raise ValueError(f"{what}: length field {struct.unpack_from('<Q', data, 4)[0]}, "
                         f"{len(data)} bytes present")
    if native.crc32c(data[:-4]) != struct.unpack_from("<I", data, len(data) - 4)[0]:
        raise ValueError(f"{what}: crc32c mismatch")
    c = _Cursor(data[:-4], what)
    c.take(12)
    version, compression = c.varint(), c.varint()
    if version != 0:
        raise NotImplementedError(f"{what}: OCDBT format version {version}")
    body = data[c.pos:-4]
    if compression == 0:
        return body
    if compression != 1:
        raise NotImplementedError(f"{what}: OCDBT compression {compression}")
    try:  # `limit` bounds the output; the crc32c has vouched for the frame
        return native.zstd_decompress(body, limit, exact=False).tobytes()
    except ValueError as e:
        raise ValueError(f"{what}: {e}") from None


def _data_file_table(c: _Cursor, base: str) -> list[tuple[str, str]]:
    """(base path, full path) of each data file a node names; `base` is the
    base path of the file the node itself was read from."""
    n = c.varint()
    if n == 0:
        return []
    prefix = [0] + c.varints(n - 1)
    suffix = c.varints(n)
    base_len = c.varints(n)
    files, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev) or base_len[i] > prefix[i] + suffix[i]:
            raise ValueError(f"{c.what}: corrupt data file table")
        path = prev[:prefix[i]] + c.take(suffix[i])
        prev = path
        files.append((base + path[:base_len[i]].decode(), base + path.decode()))
    return files


def _keys(c: _Cursor, n: int, subtree: bool) -> tuple[list[bytes], list[int]]:
    prefix = [0] + c.varints(n - 1) if n else []
    suffix = c.varints(n)
    common = c.varints(n) if subtree else []
    keys, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise ValueError(f"{c.what}: corrupt key prefix")
        prev = prev[:prefix[i]] + c.take(suffix[i])
        keys.append(prev)
    return keys, common


def _read_range(root: Path, rel: str, offset: int, length: int) -> bytes:
    path = root / rel
    with open(path, "rb") as f:
        f.seek(offset)
        data = f.read(length)
    if len(data) != length:
        raise ValueError(f"{path}: {length} bytes at {offset} asked, {len(data)} present")
    return data


def read_ocdbt(root: str | Path) -> dict[str, bytes]:
    """Every key of the OCDBT database at `root` and its value, at the
    latest version."""
    root = Path(root)
    manifest = root / "manifest.ocdbt"
    c = _Cursor(_unwrap(manifest.read_bytes(), MANIFEST_MAGIC, str(manifest), _MANIFEST_LIMIT),
                str(manifest))
    c.take(16)  # uuid
    kind = c.varint()
    c.varint()  # max_inline_value_bytes
    max_node = c.varint()
    c.byte()  # version tree arity
    if c.varint() == 1:
        c.take(4)  # zstd level
    if kind != 0:
        raise NotImplementedError(f"{manifest}: OCDBT manifest_kind {kind} (numbered manifests)")
    files = _data_file_table(c, "")
    n = c.varint()
    if n == 0:
        return {}
    c.varints(n)  # generation numbers
    heights = list(c.take(n))
    file_ids, offsets, lengths, num_keys = (c.varints(n) for _ in range(4))
    out: dict[str, bytes] = {}
    if num_keys[-1] == 0 or offsets[-1] == _MISSING:
        return out
    if file_ids[-1] >= len(files):
        raise ValueError(f"{manifest}: root names data file {file_ids[-1]} of {len(files)}")
    _walk(root, files[file_ids[-1]], offsets[-1], lengths[-1], heights[-1], b"", max_node, out)
    return out


def _walk(root: Path, file: tuple[str, str], offset: int, length: int, height: int,
          prefix: bytes, max_node: int, out: dict[str, bytes]) -> None:
    base, rel = file
    what = f"{root / rel} @ {offset}"
    c = _Cursor(_unwrap(_read_range(root, rel, offset, length), NODE_MAGIC, what, max_node), what)
    if c.byte() != height:
        raise ValueError(f"{what}: node height differs from its reference's")
    files = _data_file_table(c, base)
    n = c.varint()

    def ref(file_id: int) -> tuple[str, str]:
        if file_id >= len(files):
            raise ValueError(f"{what}: data file {file_id} of {len(files)}")
        return files[file_id]

    if height == 0:
        keys, _ = _keys(c, n, subtree=False)
        lens = c.varints(n)
        kinds = c.varints(n)
        if any(k > 1 for k in kinds):
            raise ValueError(f"{what}: value kind {max(kinds)}")
        m = sum(kinds)
        ids, offs = c.varints(m), c.varints(m)
        j = 0
        for key, size, kind in zip(keys, lens, kinds):
            if kind:
                value = _read_range(root, ref(ids[j])[1], offs[j], size)
                j += 1
            else:
                value = c.take(size)
            out[(prefix + key).decode()] = value
        return
    keys, common = _keys(c, n, subtree=True)
    ids, offs, lens = c.varints(n), c.varints(n), c.varints(n)
    for key, shared, file_id, off, size in zip(keys, common, ids, offs, lens):
        _walk(root, ref(file_id), off, size, height - 1, prefix + key[:shared], max_node, out)


# --- zarr v2 arrays ------------------------------------------------------------

_DTYPE_KINDS = "biuf"


def _zarr_dtype(name: str, where: str):
    if name == "bfloat16":
        return np.dtype("<u2")
    try:
        dt = np.dtype(name)
    except TypeError:
        raise NotImplementedError(f"{where}: zarr dtype {name!r}") from None
    if dt.kind not in _DTYPE_KINDS:
        raise NotImplementedError(f"{where}: zarr dtype {name!r}")
    return dt


def _fill(value, where: str):
    if value is None:
        return 0
    if isinstance(value, str):
        special = {"NaN": np.nan, "Infinity": np.inf, "-Infinity": -np.inf}
        if value not in special:
            raise NotImplementedError(f"{where}: fill_value {value!r}")
        return special[value]
    return value


def read_zarr(kv: dict[str, bytes], name: str):
    """The zarr v2 array `name` of an OCDBT key space: numpy, or a CPU
    torch.bfloat16 tensor for bfloat16 (which numpy lacks), as the msgpack
    reader returns it."""
    where = f"{name}/.zarray"
    if where not in kv:
        raise ValueError(f"the checkpoint has no {where}")
    meta = json.loads(kv[where])
    if meta.get("zarr_format") != 2:
        raise NotImplementedError(f"{where}: zarr_format {meta.get('zarr_format')}")
    if meta.get("order", "C") != "C":
        raise NotImplementedError(f"{where}: order {meta['order']!r}")
    if meta.get("filters"):
        raise NotImplementedError(f"{where}: filters {meta['filters']!r}")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise NotImplementedError(f"{where}: compressor {comp.get('id')!r}")
    dt = _zarr_dtype(meta["dtype"], where)
    shape, chunks = list(meta["shape"]), list(meta["chunks"])
    sep = meta.get("dimension_separator", ".")
    chunk_bytes = int(np.prod(chunks, dtype=np.int64)) * dt.itemsize
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    out = None
    for idx in itertools.product(*(range(g) for g in grid)):
        key = f"{name}/{sep.join(map(str, idx)) if idx else '0'}"
        raw = kv.get(key)
        if raw is None:
            continue  # never written: the fill value
        try:
            data = native.zstd_decompress(raw, chunk_bytes) if comp is not None else \
                np.frombuffer(raw, np.uint8).copy()
        except ValueError as e:
            raise ValueError(f"{key}: {e}") from None
        if data.size != chunk_bytes:
            raise ValueError(f"{key}: {data.size} bytes, {chunk_bytes} expected")
        chunk = data.view(dt).reshape(chunks)
        if chunks == shape:  # one chunk, as orbax writes every array: no copy
            out = chunk
            break
        if out is None:
            out = np.full(shape, _fill(meta.get("fill_value"), where), dt)
        region = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape))
        out[region] = chunk[tuple(slice(0, r.stop - r.start) for r in region)]
    if out is None:
        out = np.full(shape, _fill(meta.get("fill_value"), where), dt)
    if not dt.isnative:
        out = out.astype(dt.newbyteorder("="))
    if meta["dtype"] == "bfloat16":
        return torch.from_numpy(out.view(np.int16)).view(torch.bfloat16)
    return out


# --- the checkpoint directory ----------------------------------------------------

def _set_path(tree: dict, keys: list[str], value) -> None:
    for k in keys[:-1]:
        tree = tree.setdefault(k, {})
    tree[keys[-1]] = value


def load(path: str | Path) -> dict[str, Any]:
    """A checkpoint directory as `_load_orbax` returns it: the state tree
    with the metadata merged over it."""
    path = Path(path)
    md_path = path / "state" / "_METADATA"
    md = json.loads(md_path.read_text())
    if md.get("use_zarr3", False):
        raise NotImplementedError(f"{md_path}: use_zarr3: true")
    if not md.get("use_ocdbt", False):
        raise NotImplementedError(f"{md_path}: use_ocdbt: false")
    kv = read_ocdbt(path / "state")
    state: dict[str, Any] = {}
    for entry in md["tree_metadata"].values():
        keys = []
        for k in entry["key_metadata"]:
            if k.get("key_type", 2) != 2:
                raise NotImplementedError(f"{md_path}: key_type {k['key_type']} (only dict keys)")
            keys.append(str(k["key"]))
        vtype = entry["value_metadata"]["value_type"]
        if vtype in ("np.ndarray", "jax.Array"):
            value = read_zarr(kv, ".".join(keys))
        elif vtype == "scalar":
            value = read_zarr(kv, ".".join(keys)).item()
        elif vtype == "Dict":
            value = {}
        elif vtype == "None":
            value = None
        else:
            raise NotImplementedError(f"{md_path}: value_type {vtype!r}")
        _set_path(state, keys, value)
    meta_path = path / "meta" / "metadata"
    out = dict(state)
    if meta_path.exists():
        out.update(json.loads(meta_path.read_text()) or {})
    return out


def _to_array(x) -> tuple[np.ndarray, str]:
    """(C-order host array, zarr dtype name) of a leaf."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy(), "bfloat16"
        x = x.numpy()
    x = np.asarray(x)
    if not x.flags.c_contiguous:
        x = x.copy(order="C")  # (np.ascontiguousarray would make a 0-d array 1-d)
    if x.dtype.name == "bfloat16":
        return x.view(np.int16), "bfloat16"
    if x.dtype.kind not in _DTYPE_KINDS:
        raise TypeError(f"cannot write an array of dtype {x.dtype} to an orbax checkpoint")
    return x, x.dtype.str


def _flatten(tree, prefix: tuple = ()) -> Iterator[tuple[tuple, Any]]:
    """The leaves of a payload's state in jax.tree_util order (dict keys
    sorted), lists and tuples keyed by position as flax's to_state_dict
    keys them; an empty dict is a leaf, as orbax records it."""
    if isinstance(tree, (list, tuple)):
        tree = {str(i): v for i, v in enumerate(tree)}
    if isinstance(tree, dict) and tree:
        for k in sorted(tree, key=str):
            yield from _flatten(tree[k], prefix + (str(k),))
    else:
        yield prefix, tree


def _leaf(value) -> tuple[str, np.ndarray | None, str | None]:
    """(orbax value_type, array, zarr dtype) of a state leaf."""
    if isinstance(value, dict):
        return "Dict", None, None
    if value is None:
        return "None", None, None
    if isinstance(value, (bool, int, float)) and not isinstance(value, np.generic):
        if isinstance(value, bool):
            raise TypeError("cannot write a Python bool leaf to an orbax checkpoint")
        arr = np.asarray(value, np.int64 if isinstance(value, int) else np.float64)
        return "scalar", arr, arr.dtype.str
    if isinstance(value, (np.ndarray, np.generic, torch.Tensor)):
        arr, dtype = _to_array(value)
        if arr.size == 0:
            raise ValueError("cannot write an array with zero size to an orbax checkpoint")
        return "np.ndarray", arr, dtype
    raise TypeError(f"cannot write a {type(value).__name__} leaf to an orbax checkpoint")


def _zarray(shape: tuple, dtype: str) -> bytes:
    meta = {"chunks": list(shape), "compressor": {"id": "zstd", "level": 1},
            "dimension_separator": ".", "dtype": dtype, "fill_value": None, "filters": None,
            "order": "C", "shape": list(shape), "zarr_format": 2}
    return json.dumps(meta, sort_keys=True, separators=(",", ":")).encode()


def _envelope(magic: int, body: bytes) -> bytes:
    frame = zstd_raw_frame(body)
    head = struct.pack(">I", magic) + struct.pack("<Q", 18 + len(frame)) + b"\x00\x01"
    data = head + frame
    return data + struct.pack("<I", crc32c_py(data))


def _file_table(path: str | None) -> bytes:
    """A table of no data file, or of `path` with base path ""."""
    if path is None:
        return _varint(0)
    return _varint(1) + _varint(len(path)) + _varint(0) + path.encode()


def write_ocdbt(root: Path, values: list[tuple[bytes, list]]) -> None:
    """A single-level OCDBT database at `root`: one data file `d/<hex>`
    with the values above MAX_INLINE_VALUE_BYTES, then one leaf node
    holding every key and the smaller values, then the manifest. `values`
    is (key, parts) with the value the concatenation of its byte parts."""
    values = sorted(values, key=lambda kv: kv[0])
    rel = f"d/{uuid.uuid4().hex}"
    (root / "d").mkdir(parents=True)
    lens, kinds, offsets, inline = [], [], [], []
    with open(root / rel, "wb") as f:
        pos = 0
        for _, parts in values:
            size = sum(len(p) for p in parts)
            lens.append(size)
            if size > MAX_INLINE_VALUE_BYTES:
                kinds.append(1)
                offsets.append(pos)
                for p in parts:
                    f.write(p)
                pos += size
            else:
                kinds.append(0)
                inline.append(b"".join(bytes(p) for p in parts))
        indirect = pos
        keys = [k for k, _ in values]
        prefix = [len(os.path.commonprefix([a, b])) for a, b in zip(keys, keys[1:])]
        body = (b"\x00" + _file_table(rel if indirect else None) + _varint(len(keys))
                + _varints(prefix) + _varints(len(k) - p for k, p in zip(keys, [0] + prefix))
                + b"".join(k[p:] for k, p in zip(keys, [0] + prefix))
                + _varints(lens) + _varints(kinds)
                + _varints(0 for _ in offsets) + _varints(offsets) + b"".join(inline))
        if len(body) > MAX_DECODED_NODE_BYTES:
            raise ValueError(f"the checkpoint's keys and small values take {len(body)} bytes, "
                             f"more than one OCDBT node holds ({MAX_DECODED_NODE_BYTES})")
        node = _envelope(NODE_MAGIC, body)
        f.write(node)
    config = (uuid.uuid4().bytes + _varint(0) + _varint(MAX_INLINE_VALUE_BYTES)
              + _varint(MAX_DECODED_NODE_BYTES) + bytes([VERSION_TREE_ARITY_LOG2])
              + _varint(1) + struct.pack("<i", 0))
    # one version: generation 1, a leaf root in data file 0, its statistics
    versions = (_varint(1) + _varint(1) + b"\x00"
                + _varints([0, pos, len(node), len(keys), len(node), indirect])
                + struct.pack("<Q", time.time_ns()) + _varint(0))
    (root / "manifest.ocdbt").write_bytes(
        _envelope(MANIFEST_MAGIC, config + _file_table(rel) + versions))


def _json_default(o):
    if isinstance(o, np.generic):
        return o.item()
    raise TypeError(f"{type(o).__name__} is not JSON serializable")


def save(path: str | Path, checkpoint: dict[str, Any]) -> Path:
    """Write `checkpoint` as the JAX package's `_save_orbax` does: into a
    temporary sibling directory, renamed into place at the end, replacing
    an earlier checkpoint at `path` (orbax's force=True). A failed write
    leaves nothing under `path`'s name but what was there before."""
    path = Path(path)
    started = time.time_ns()
    meta = {k: checkpoint[k] for k in checkpoint if k in META_KEYS}
    state = {k: v for k, v in checkpoint.items() if k not in meta}
    if not state:  # as orbax refuses it ("Found empty item")
        raise ValueError("an orbax checkpoint needs state beside its metadata keys")
    tree_metadata, values = {}, []
    for keys, value in _flatten(state):
        vtype, arr, dtype = _leaf(value)
        tree_metadata[str(keys)] = {
            "key_metadata": [{"key": k, "key_type": 2} for k in keys],
            "value_metadata": {"value_type": vtype, "skip_deserialize": arr is None}}
        if arr is None:
            continue
        name = ".".join(keys)
        chunk = "0" if arr.ndim == 0 else ".".join("0" * arr.ndim)
        values.append((f"{name}/.zarray".encode(), [_zarray(arr.shape, dtype)]))
        values.append((f"{name}/{chunk}".encode(),
                       list(_raw_frame_parts(memoryview(arr.reshape(-1)).cast("B")))))
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.tmp-{os.getpid()}-{uuid.uuid4().hex[:8]}")
    old = None
    try:
        (tmp / "state").mkdir(parents=True)
        (tmp / "meta").mkdir()
        write_ocdbt(tmp / "state", values)
        (tmp / "state" / "_METADATA").write_text(json.dumps({
            "tree_metadata": tree_metadata, "use_ocdbt": True, "use_zarr3": False,
            "store_array_data_equal_to_fill_value": True, "custom_metadata": None}))
        (tmp / "meta" / "metadata").write_text(json.dumps(meta, default=_json_default))
        (tmp / "_CHECKPOINT_METADATA").write_text(json.dumps({
            "item_handlers": ITEM_HANDLERS, "metrics": {}, "performance_metrics": {},
            "init_timestamp_nsecs": started, "commit_timestamp_nsecs": time.time_ns(),
            "custom_metadata": {}}))
        if path.exists() or path.is_symlink():
            old = path.with_name(f"{tmp.name}.old")
            os.replace(path, old)
        os.replace(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        if old is not None and not path.exists():
            os.replace(old, path)  # the earlier checkpoint back under its name
        raise
    if old is not None:
        if old.is_dir() and not old.is_symlink():
            shutil.rmtree(old)
        else:
            old.unlink()
    return path
