"""Self-describing checkpoints in the JAX package's msgpack format.

Port of `audio_classification_icbhi_tpu/utils/checkpoint.py:89-127`. A
checkpoint is one msgpack file holding a dict {epoch, params, batch_stats,
opt_state, val_loss, config, ...}, as flax's `msgpack_serialize` writes it:

- the config dict is a "json:"-prefixed JSON string leaf;
- arrays are msgpack ext type 1 holding msgpack (shape, dtype name, raw
  C-order bytes); numpy scalars are ext type 3 in the same encoding;
  complex numbers ext type 2 holding (real, imag);
- arrays above 1 GiB arrive split, as {"__msgpack_chunked_array__": True,
  "shape": {...}, "chunks": {...}};
- lists and tuples are dicts keyed "0", "1", ... (flax's to_state_dict).

The codec below covers exactly that much msgpack, so the port needs no
msgpack package. Files written here load in the JAX package and back.
`format="orbax"` writes the JAX package's orbax checkpoint directory
instead, and `load_checkpoint` reads a directory as one
(`utils/orbax_format.py`), so every consumer takes either format.

The trainer's payload (`training/trainer.py`, as the JAX trainer's
`trainer.py:816-839`) is {epoch, params, batch_stats, opt_state (optax's
state-dict form), val_loss, config, class_weights, scheduler, best_metric,
patience_counter}, so a checkpoint written by either trainer resumes in the
other. `AsyncCheckpointWriter` writes them from a worker thread.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Any

import numpy as np
import torch

from audio_classification_icbhi_tpu_torch.utils import orbax_format

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


# --- msgpack encoder ----------------------------------------------------------

def _pack_len(out: bytearray, n: int, fix: int | None, fix_max: int, codes: tuple) -> None:
    if fix is not None and n <= fix_max:
        out.append(fix | n)
    elif n < 1 << 8 and codes[0] is not None:
        out += bytes([codes[0], n])
    elif n < 1 << 16:
        out += bytes([codes[1]]) + struct.pack(">H", n)
    elif n < 1 << 32:
        out += bytes([codes[2]]) + struct.pack(">I", n)
    else:
        raise ValueError(f"msgpack object too large ({n})")


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v < 128:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif v >= 0:
        for code, fmt, lim in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                               (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if v < lim:
                out += bytes([code]) + struct.pack(fmt, v)
                return
        raise OverflowError(v)
    else:
        for code, fmt, lim in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                               (0xD2, ">i", 1 << 31), (0xD3, ">q", 1 << 63)):
            if v >= -lim:
                out += bytes([code]) + struct.pack(fmt, v)
                return
        raise OverflowError(v)


def _pack_ext(out: bytearray, code: int, data: bytes) -> None:
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixext:
        out.append(fixext[len(data)])
    else:
        _pack_len(out, len(data), None, -1, (0xC7, 0xC8, 0xC9))
    out.append(code)
    out += data


def _array_bytes(x) -> bytes:
    """flax's ndarray encoding: msgpack (shape, dtype name, C-order bytes)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        if x.dtype == torch.bfloat16:
            return _packb([list(x.shape), "bfloat16", x.view(torch.int16).numpy().tobytes()])
        x = x.numpy()
    if x.dtype.hasobject:
        raise ValueError("object arrays cannot be serialized")
    return _packb([list(x.shape), x.dtype.name, x.tobytes("C")])


def _pack(out: bytearray, obj: Any) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int) and not isinstance(obj, np.generic):
        _pack_int(out, obj)
    elif isinstance(obj, float) and not isinstance(obj, np.generic):
        out += b"\xcb" + struct.pack(">d", obj)
    elif isinstance(obj, complex):
        _pack_ext(out, _EXT_COMPLEX, _packb([obj.real, obj.imag]))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(out, len(data), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out += data
    elif isinstance(obj, (bytes, bytearray)):
        _pack_len(out, len(obj), None, -1, (0xC4, 0xC5, 0xC6))
        out += obj
    elif isinstance(obj, dict):
        _pack_len(out, len(obj), 0x80, 15, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    elif isinstance(obj, list):
        _pack_len(out, len(obj), 0x90, 15, (None, 0xDC, 0xDD))
        for v in obj:
            _pack(out, v)
    elif isinstance(obj, (np.ndarray, torch.Tensor)):
        _pack_ext(out, _EXT_NDARRAY, _array_bytes(obj))
    elif isinstance(obj, np.generic):
        _pack_ext(out, _EXT_NPSCALAR, _array_bytes(np.asarray(obj)))
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__}")


def _packb(obj: Any) -> bytes:
    out = bytearray()
    _pack(out, obj)
    return bytes(out)


# --- msgpack decoder ----------------------------------------------------------

class _Reader:
    def __init__(self, data: bytes):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        v = self.buf[self.pos : self.pos + n]
        self.pos += n
        return v

    def num(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self) -> Any:
        b = self.num(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 256
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.obj() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if b in sized:
            return bytes(self.take(self.num(sized[b])))
        if b in (0xC7, 0xC8, 0xC9):
            n = self.num({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
            return self.ext(self.num(">b"), n)
        if b in (0xD4, 0xD5, 0xD6, 0xD7, 0xD8):
            return self.ext(self.num(">b"), 1 << (b - 0xD4))
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                   0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.num(numbers[b])
        if b in (0xD9, 0xDA, 0xDB):
            n = self.num({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b])
            return str(self.take(n), "utf-8")
        if b in (0xDC, 0xDD):
            n = self.num(">H" if b == 0xDC else ">I")
            return [self.obj() for _ in range(n)]
        if b in (0xDE, 0xDF):
            return self.map(self.num(">H" if b == 0xDE else ">I"))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out

    def ext(self, code: int, n: int) -> Any:
        data = bytes(self.take(n))
        if code == _EXT_NDARRAY:
            return _array_from_bytes(data)
        if code == _EXT_NPSCALAR:
            return _array_from_bytes(data)[()]
        if code == _EXT_COMPLEX:
            re, im = _unpackb(data)
            return complex(re, im)
        raise ValueError(f"unsupported msgpack ext type {code}")


def _unpackb(data: bytes) -> Any:
    r = _Reader(data)
    obj = r.obj()
    if r.pos != len(r.buf):
        raise ValueError("trailing bytes after msgpack object")
    return obj


def _array_from_bytes(data: bytes):
    """Inverse of _array_bytes. bfloat16, which numpy lacks, comes back as
    a torch.bfloat16 tensor; every other dtype as a numpy array."""
    shape, name, raw = _unpackb(data)
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        return torch.from_numpy(np.frombuffer(raw, np.int16).copy()).view(
            torch.bfloat16).reshape(shape)
    return np.frombuffer(raw, dtype=np.dtype(name)).reshape(shape).copy()


def _unchunk(tree):
    if isinstance(tree, dict):
        if tree.get("__msgpack_chunked_array__"):
            shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def _to_state_dict(tree):
    """flax's to_state_dict for plain containers: lists and tuples become
    dicts keyed by position."""
    if isinstance(tree, dict):
        return {str(k): _to_state_dict(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): _to_state_dict(v) for i, v in enumerate(tree)}
    return tree


# --- checkpoints ----------------------------------------------------------------

def save_checkpoint(path: str | Path, checkpoint: dict[str, Any],
                    format: str = "msgpack") -> Path:
    """Write a checkpoint dict, atomically: one msgpack file (default;
    tensor and array leaves stored as arrays, a config dict as a "json:"
    string leaf) or an orbax directory (format="orbax",
    training.checkpoint_format)."""
    path = Path(path)
    if format == "orbax":
        return orbax_format.save(path, checkpoint)
    if format != "msgpack":
        raise ValueError(f"unknown checkpoint format {format!r}")
    path.parent.mkdir(parents=True, exist_ok=True)
    ckpt = dict(checkpoint)
    if isinstance(ckpt.get("config"), dict):
        ckpt["config"] = "json:" + json.dumps(ckpt["config"])
    payload = _packb(_to_state_dict(ckpt))
    tmp = path.with_suffix(path.suffix + ".tmp")
    tmp.write_bytes(payload)
    tmp.replace(path)
    return path


def load_checkpoint(path: str | Path) -> dict[str, Any]:
    """Read a checkpoint written by either package: an orbax directory or
    a msgpack file."""
    path = Path(path)
    if path.is_dir():
        return orbax_format.load(path)
    data = _unchunk(_unpackb(path.read_bytes()))
    cfg = data.get("config")
    if isinstance(cfg, str) and cfg.startswith("json:"):
        data["config"] = json.loads(cfg[5:])
    return data


def _host_snapshot(tree):
    """A copy of a checkpoint tree whose tensor leaves are host arrays
    (numpy; bfloat16 stays a CPU tensor, which the codec writes as the JAX
    package does), so later in-place updates of the live tensors cannot
    reach a queued write."""
    if isinstance(tree, dict):
        return {k: _host_snapshot(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_snapshot(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        return t.clone() if t.dtype == torch.bfloat16 else t.numpy().copy()
    if isinstance(tree, np.ndarray):
        return tree.copy()
    return tree


class AsyncCheckpointWriter:
    """Checkpoint writes off the training thread.

    save() takes a host snapshot of the payload on the calling thread (one
    device->host copy per tensor leaf; the state is a few MB) and queues
    the encoding and the write (msgpack, the slow part in pure Python, or
    orbax) for one worker thread. What lands on disk is what synchronous
    save_checkpoint calls write (msgpack files byte for byte; orbax
    directories but for their timestamps and random names). wait() blocks until every queued write is on
    disk and re-raises the first worker error; close() also retires the
    thread. Port of `audio_classification_icbhi_tpu/utils/checkpoint.py:169-264`.
    """

    def __init__(self):
        import queue
        import threading

        self._q: "queue.Queue" = queue.Queue(maxsize=2)
        self._errors: list[BaseException] = []
        self._closed = False
        self._worker = threading.Thread(target=self._run, name="ckpt-writer", daemon=True)
        self._worker.start()

    def _run(self):
        while True:
            item = self._q.get()
            try:
                if item is not None:
                    path, snapshot, fmt = item
                    save_checkpoint(path, snapshot, format=fmt)
            except BaseException as e:  # surfaced on the next save()/wait()
                self._errors.append(e)
            finally:
                self._q.task_done()
            if item is None:
                return

    def _raise_pending(self):
        if self._errors:
            raise RuntimeError("async checkpoint write failed") from self._errors.pop(0)

    def save(self, path: str | Path, checkpoint: dict[str, Any], format: str = "msgpack"):
        """Snapshot now, write later; blocks only while 2 writes are queued."""
        if self._closed:
            raise RuntimeError("AsyncCheckpointWriter is closed")
        self._raise_pending()
        self._q.put((Path(path), _host_snapshot(checkpoint), format))

    def wait(self):
        self._q.join()
        self._raise_pending()

    def close(self):
        if self._closed:
            return
        self._closed = True
        self._q.join()
        self._q.put(None)
        self._worker.join()
        self._raise_pending()


def latest_checkpoint(checkpoint_dir: str | Path) -> Path | None:
    """The most recent periodic checkpoint (checkpoint_epoch_{N}.ckpt)."""
    d = Path(checkpoint_dir)
    if not d.exists():
        return None
    candidates = sorted(d.glob("checkpoint_epoch_*.ckpt"),
                        key=lambda p: int(p.stem.rsplit("_", 1)[-1]))
    return candidates[-1] if candidates else None
