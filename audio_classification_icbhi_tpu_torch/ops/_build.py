"""Builds the port's CUDA sources (`csrc/*.cu`) on first use.

Each source compiles with nvcc for `sm_90a` into its own shared library with
a plain C interface under `build/kernels/` at the repository root, and loads
through ctypes. No PyTorch header is compiled, which keeps a build to seconds.
All sources build together, one nvcc process each. A library is named by a
digest of its source, the shared headers (`csrc/*.cuh`) and the flags, so an
edited source or header rebuilds and an unchanged one loads as it is.

The recorder (`tracing.py`) holds the span `kernels.build` (each
`build_all`) and counts each library loaded as `kernels.built` (nvcc built
it in this process) or `kernels.cached` (found built).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from audio_classification_icbhi_tpu_torch import tracing

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# C entry points of each library: {source stem: {function: ctypes argtypes}}.
# Every entry point returns a cudaError_t as int; every library also exports
# `const char* cuda_error_string(int)`.
_SIGNATURES: dict[str, dict[str, list]] = {}
_LIBS: dict[str, ctypes.CDLL] = {}
_BUILT: set[str] = set()  # stems nvcc built in this process


def declare(name: str, signatures: dict[str, list]) -> None:
    """Record the ctypes argtypes of the C functions in `csrc/<name>.cu`."""
    _SIGNATURES[name] = signatures


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME") and Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc",
                 Path("/usr/local/cuda/bin/nvcc"), shutil.which("nvcc")):
        if cand and Path(cand).exists():
            return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed (set CUDA_HOME)")


def _target(src: Path) -> Path:
    """The library of `src`, named by a digest of the source, every header
    under csrc/ (the sources include them) and the flags."""
    digest = hashlib.sha256()
    for part in (src, *sorted(CSRC.glob("*.cuh"))):
        digest.update(part.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{digest.hexdigest()[:16]}.so"


def build_all() -> dict[str, tuple[Path, str]]:
    """Compile every source whose library is missing, all at once.

    Returns {source stem: (library path, compiler log)}; the log holds
    ptxas's register and shared-memory report, or "cached". Raises with the
    log of any source that fails to compile."""
    with tracing.span("kernels.build"):
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        out: dict[str, tuple[Path, str]] = {}
        running = []
        for src in sorted(CSRC.glob("*.cu")):
            lib = _target(src)
            if lib.exists():
                out[src.stem] = (lib, "cached")
                continue
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)
            running.append((src, lib, tmp, proc))
        failed = []
        for src, lib, tmp, proc in running:
            log, _ = proc.communicate()
            if proc.returncode:
                failed.append(f"{src.name}:\n{log}")
                continue
            os.replace(tmp, lib)
            out[src.stem] = (lib, log)
            _BUILT.add(src.stem)
        if failed:
            raise RuntimeError("nvcc failed\n" + "\n".join(failed))
        return out


def load(name: str) -> ctypes.CDLL:
    """The library built from `csrc/<name>.cu`, built on first use."""
    if name not in _LIBS:
        lib = ctypes.CDLL(str(build_all()[name][0]))
        tracing.count("kernels.built" if name in _BUILT else "kernels.cached")
        for fn, argtypes in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return _LIBS[name]


def launch(lib: ctypes.CDLL, fn, *args) -> None:
    """Call the C entry point `fn` of `lib`; raise with CUDA's message if it
    returns an error (a refused launch never runs, and no later synchronize
    reports it)."""
    err = fn(*args)
    if err:
        msg = lib.cuda_error_string(err).decode()
        raise RuntimeError(f"{fn.__name__} failed: CUDA error {err} ({msg})")
