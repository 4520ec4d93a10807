"""Build and load the CUDA kernels of ``csrc/prop_round.cu``.

The source is compiled with ``nvcc`` into a shared library with a plain C
interface, at first use, into ``build/<hash>/`` beside the package (a
directory that git ignores), keyed by a hash of the source and the flags, and
loaded with ``ctypes``.  Nothing is built or loaded when the package is
imported; a CPU-only installation never reaches this module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "prop_round.cu"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

P, I64, I32, F64 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_double
# C entry points: argument types in order, every one returns a cudaError_t.
SIGNATURES = {
    "fused_scatter_round": [P] * 9 + [I64, I32, F64, F64, P],
    "activities_gather": [P] * 8 + [I64, I32, F64, P],
    "candidates_scatter": [P] * 13 + [I64, I32, F64, F64, P],
    "apply_updates": [P] * 5 + [I64, F64, F64, F64, P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_info: dict = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path() -> Path:
    key = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / key[:16] / "libprop_round.so"


def build() -> Path:
    """Compile the kernels unless a library for this source already exists.

    The compiler writes into a temporary file that is renamed into place, so
    concurrent processes never load a half-written library.  ``build_info``
    records the seconds taken and the compiler's register report."""
    out = library_path()
    if out.exists():
        build_info.setdefault("seconds", 0.0)
        build_info.setdefault("cached", True)
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
            capture_output=True, text=True, check=False,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    build_info.update(
        seconds=time.perf_counter() - t0, cached=False, log=proc.stdout + proc.stderr
    )
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            handle.error_string.argtypes = [ctypes.c_int]
            handle.error_string.restype = ctypes.c_char_p
            _lib = handle
        return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        msg = lib().error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: {msg} ({err})")
