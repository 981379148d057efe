"""The port's host C++ libraries, each built on first use and loaded
through ctypes.

- `fastwav.cc`, the native WAV decoder: a port of
  `audio_classification_icbhi_tpu/native/__init__.py:24-119`, with the same
  API (`available`, `decode_mono`, `decode_batch`) over the port's own copy
  of the C++ source. A failed build warns once, with the compiler's output;
  every caller then decodes with the numpy codec
  (`data/wavio.decode_mono_numpy`).
- `zstd.cc`, a Zstandard frame decoder and CRC32C (`zstd_decompress`,
  `crc32c`), which read orbax checkpoint directories
  (`utils/orbax_format.py`). It has no fallback: where it does not build,
  each call raises with the compiler's output.

`build(src)` compiles a source with g++ into `build/native/` at the
repository root, as `ops/_build.py` builds the CUDA sources: the library is
named by the source's stem and a digest of the source, the flags, the
compiler's version and the platform, so an edited source rebuilds and a
library built on another machine is never loaded. Nothing is built inside
the package.

`ROWS` counts the rows each path decoded, as the kernel wrappers count
their launches: `wavio.load_audio` adds one to `native` or `numpy`;
`data/dataset._native_load_batch` adds the batch's rows the library
assembled to `native`, and the rows it sent to the per-row path (another
sample rate, or a file the library refused) to `per_row`; those rows then
count again under `native` or `numpy` as `load_audio` decodes them.
`tracing.counters()` reports them as `rows.native`, `rows.numpy` and
`rows.per_row`.
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
ZSTD_SRC = SRC.with_name("zstd.cc")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-pthread", "-Wall")

_lock = threading.Lock()
# source path -> its bound library, or the exception its build or load raised
_loaded: dict[Path, object] = {}


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


def build(src: Path | None = None) -> Path:
    """The library of `src` (default: the WAV decoder), compiled first if
    it is not in BUILD_DIR. Raises OSError where the compiler cannot run,
    RuntimeError with the compiler's output where the source does not
    compile."""
    src = SRC if src is None else src
    cxx = compiler()
    version = subprocess.run([cxx, "--version"], capture_output=True, text=True,
                             timeout=60, check=True).stdout
    digest = hashlib.sha256(src.read_bytes())
    for part in (" ".join(CXX_FLAGS), version, platform.platform()):
        digest.update(part.encode())
    lib = BUILD_DIR / f"{src.stem}-{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} could not build {src.name}:\n{proc.stderr.strip()}")
    os.replace(tmp, lib)
    return lib


def _bind_fastwav(lib) -> None:
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


def _bind_zstd(lib) -> None:
    lib.zstd_decompress.restype = ctypes.c_long
    lib.zstd_decompress.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                    ctypes.c_void_p, ctypes.c_size_t]
    lib.zstd_crc32c.restype = ctypes.c_uint32
    lib.zstd_crc32c.argtypes = [ctypes.c_uint32, ctypes.c_void_p, ctypes.c_size_t]


def _library(src: Path, bind) -> tuple[object, bool]:
    """(the bound library of `src` or the exception its build raised,
    whether this call made the attempt), built and loaded at most once."""
    with _lock:
        if src in _loaded:
            return _loaded[src], False
        try:
            lib = ctypes.CDLL(str(build(src)))
            bind(lib)
        except (OSError, RuntimeError, subprocess.SubprocessError, AttributeError) as e:
            lib = e
        _loaded[src] = lib
        return lib, True


def _load():
    """The WAV decoder's library, or None (warned once) where it fails."""
    lib, first = _library(SRC, _bind_fastwav)
    if isinstance(lib, Exception):
        if first:
            warnings.warn(f"the native WAV decoder is unavailable ({lib}); "
                          "decoding with the numpy codec", RuntimeWarning, stacklevel=3)
        return None
    return lib


def _zstd():
    lib, _ = _library(ZSTD_SRC, _bind_zstd)
    if isinstance(lib, Exception):
        raise RuntimeError(f"the zstd decoder ({ZSTD_SRC.name}) is unavailable: {lib}") from lib
    return lib


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


# zstd_decompress's error codes (zstd.cc)
ZSTD_ERRORS = {-1: "corrupt frame", -2: "truncated frame", -3: "frame needs a dictionary",
               -4: "frame larger than expected", -5: "content checksum mismatch"}


def zstd_decompress(data, size: int, exact: bool = True) -> np.ndarray:
    """Decode the zstd frames in `data` (bytes-like) into `size` bytes, a
    uint8 array (with exact=False, into at most `size` bytes). Raises
    ValueError where the frames are corrupt, truncated, name a dictionary
    or do not decode to that size, and RuntimeError where the library does
    not build."""
    lib = _zstd()
    src = np.frombuffer(data, np.uint8)
    out = np.empty(size, np.uint8)
    rc = lib.zstd_decompress(src.ctypes.data, src.size, out.ctypes.data, size)
    if rc < 0:
        raise ValueError(f"zstd: {ZSTD_ERRORS.get(rc, f'error {rc}')}")
    if exact and rc != size:
        raise ValueError(f"zstd: the frames decode to {rc} bytes, {size} expected")
    return out[:rc]


def crc32c(data, crc: int = 0) -> int:
    """CRC32C (Castagnoli) of `data`, continued from `crc`."""
    src = np.frombuffer(data, np.uint8)
    return int(_zstd().zstd_crc32c(crc, src.ctypes.data, src.size))
