"""The native WAV decoder (`fastwav.cc`), loaded through ctypes.

Port of `audio_classification_icbhi_tpu/native/__init__.py:24-119`, with
the same API (`available`, `decode_mono`, `decode_batch`) over the port's
own copy of the C++ source. On first use the source builds with g++ into
`build/native/` at the repository root, as `ops/_build.py` builds the CUDA
sources: the library is named by a digest of the source, the flags, the
compiler's version and the platform, so an edited source rebuilds and a
library built on another machine is never loaded. Nothing is built inside
the package. A failed build warns once, with the compiler's output; every
caller then decodes with the numpy codec (`data/wavio.decode_mono_numpy`).

`ROWS` counts the rows each path decoded, as the kernel wrappers count
their launches: `wavio.load_audio` adds one to `native` or `numpy`;
`data/dataset._native_load_batch` adds the batch's rows the library
assembled to `native`, and the rows it sent to the per-row path (another
sample rate, or a file the library refused) to `per_row`; those rows then
count again under `native` or `numpy` as `load_audio` decodes them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
import warnings
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "fastwav.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-pthread", "-Wall")

_lock = threading.Lock()
_lib = None
_tried = False


class RowCounts:
    """Rows decoded by each path since the last `reset` (see the module
    docstring). The loader decodes in threads, so updates take a lock."""

    FIELDS = ("native", "numpy", "per_row")

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            for name in self.FIELDS:
                setattr(self, name, 0)

    def add(self, **counts: int) -> None:
        with self._lock:
            for name, n in counts.items():
                setattr(self, name, getattr(self, name) + n)

    def as_dict(self) -> dict[str, int]:
        with self._lock:
            return {name: getattr(self, name) for name in self.FIELDS}


ROWS = RowCounts()


def compiler() -> str:
    return os.environ.get("CXX", "g++")


def build() -> Path:
    """The decoder's library, compiled first if it is not in BUILD_DIR.
    Raises OSError where the compiler cannot run, RuntimeError with the
    compiler's output where the source does not compile."""
    cxx = compiler()
    version = subprocess.run([cxx, "--version"], capture_output=True, text=True,
                             timeout=60, check=True).stdout
    digest = hashlib.sha256(SRC.read_bytes())
    for part in (" ".join(CXX_FLAGS), version, platform.platform()):
        digest.update(part.encode())
    lib = BUILD_DIR / f"fastwav-{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SRC)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} could not build {SRC.name}:\n{proc.stderr.strip()}")
    os.replace(tmp, lib)
    return lib


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(str(build()))
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            warnings.warn(f"the native WAV decoder is unavailable ({e}); "
                          "decoding with the numpy codec", RuntimeWarning, stacklevel=3)
            return None
        lib.fastwav_decode_mono.restype = ctypes.c_int
        lib.fastwav_decode_mono.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.fastwav_info.restype = ctypes.c_int
        lib.fastwav_info.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_long),
        ]
        lib.fastwav_decode_batch.restype = ctypes.c_int
        lib.fastwav_decode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int,
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_long),
            ctypes.c_int,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the library builds and loads (built on the first call)."""
    return _load() is not None


def decode_mono(path: str | Path) -> tuple[np.ndarray, int] | None:
    """Decode to mono float32; None where the library is unavailable or the
    file is not one it takes (the caller falls back to the numpy codec)."""
    lib = _load()
    if lib is None:
        return None
    path_b = str(path).encode()
    n = ctypes.c_long(0)
    sr = ctypes.c_int(0)
    ch = ctypes.c_int(0)
    # the header alone first, to size the buffer
    if lib.fastwav_info(path_b, ctypes.byref(sr), ctypes.byref(ch), ctypes.byref(n)) != 0:
        return None
    out = np.empty(n.value, dtype=np.float32)
    rc = lib.fastwav_decode_mono(
        path_b, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_long(n.value), ctypes.byref(n), ctypes.byref(sr),
    )
    if rc != 0:
        return None
    return out[: n.value], int(sr.value)


def decode_batch(
    paths: list, target_len: int, n_threads: int = 4
) -> tuple[np.ndarray, np.ndarray, np.ndarray] | None:
    """Decode `paths` in `n_threads` C++ threads, each file end-padded with
    zeros or centre-cropped (`wavio.pad_or_crop`) into its row of a
    (N, target_len) float32 batch. Returns (batch, sample rates, true
    lengths), or None where the library is unavailable. A file the library
    refuses leaves its row zero, its rate the negative error code and its
    length 0."""
    lib = _load()
    if lib is None:
        return None
    n = len(paths)
    out = np.zeros((n, target_len), dtype=np.float32)
    srs = np.zeros(n, dtype=np.int32)
    lens = np.zeros(n, dtype=np.int64)
    arr = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    lib.fastwav_decode_batch(
        arr, n, ctypes.c_long(target_len),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        srs.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        n_threads,
    )
    return out, srs, lens
