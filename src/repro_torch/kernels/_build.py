"""Build and load the CUDA kernels of ``csrc/``.

Each source (``prop_round.cu``, ``slab_round.cu``, ``tier_round.cu``,
``batch_tier_round.cu``, ``slab_tier_round.cu``, ``telemetry.cu``,
``half_round.cu``, ``half_batch_round.cu``) is
compiled with ``nvcc`` into a shared library with a plain C interface, at first use, into
``build/<hash>/`` beside the package (a directory that git ignores), keyed
by a hash of the sources, the shared header and the flags, and loaded with
``ctypes``.  The compilers run in parallel, one process per source.  A
file lock beside the build directory serialises builds across processes
(the ranks of a world started together), a thread lock within one.
Nothing is built or loaded when the package is imported; a CPU-only
installation never reaches this module.
"""
from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from types import SimpleNamespace

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
SOURCES = (CSRC / "prop_round.cu", CSRC / "slab_round.cu", CSRC / "tier_round.cu",
           CSRC / "batch_tier_round.cu", CSRC / "slab_tier_round.cu", CSRC / "telemetry.cu",
           CSRC / "half_round.cu", CSRC / "half_batch_round.cu")
HEADERS = (CSRC / "round_common.cuh", CSRC / "single_round.cuh", CSRC / "batch_round.cuh",
           CSRC / "slab_round.cuh", CSRC / "record_round.cuh")
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

P, I64, I32, F64 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_double
F32 = ctypes.c_float  # the float32 and 16-bit entries' scalars, passed as floats
# C entry points of each source: argument types in order, every one returns
# a cudaError_t.
SIGNATURES = {
    "prop_round.cu": {
        "fused_scatter_round": [P] * 11 + [I64, I32, I32, F64, F64, P],
        "activities_gather": [P] * 9 + [I64, I32, F64, P],
        "candidates_scatter": [P] * 14 + [I64, I32, F64, F64, P],
        "node_activities_gather": [P] * 10 + [I64, I32, I32, I64, I64, F64, P],
        "node_candidates_scatter": [P] * 15 + [I64, I32, I32, I64, I64, F64, F64, P],
        "node_combine_chunk_partials": [P] * 12 + [I64, I64, I64, I64, P],
        "apply_updates": [P] * 5 + [I64, I32, I32, F64, F64, F64, P],
        "combine_chunk_partials": [P] * 12 + [I64, I64, P],
        "straddle_combine": [P] * 16 + [I64, I64, I64, I64, P],
        "node_fused_scatter_round": [P] * 11 + [I64, I32, I32, I64, I64, F64, F64, P],
        "batched_fused_scatter_round": [P] * 12 + [I64, I32, I32, I64, I64, F64, F64, P],
        "apply_updates_batch": [P] * 7 + [I64, I64, F64, F64, F64, P],
        "node_objective": [P] * 8 + [I64, I64, F64, F64, P],
        "activities": [P] * 8 + [I64, I32, F64, P],
        "candidates": [P] * 13 + [I64, I32, F64, F64, P],
        "fused_round": [P] * 9 + [I64, I32, F64, F64, P],
    },
    "slab_round.cu": {
        "slab_partials": [P] * 13 + [I32, I64, I32, I32, I64, I64, F64, P],
        "node_slab_partials": [P] * 11 + [I64, I32, I32, I32, I64, I64, I64, F64, P],
        "slab_scatter": [P] * 19 + [I64, I32, I32, I32, I64, I64, F64, F64, P],
        "node_slab_scatter": [P] * 17 + [I64, I32, I32, I32, I64, I64, I64, F64, F64, P],
        "slab_merge": [P] * 8 + [I64, I64, I64, I32, I32, F64, F64, F64, P],
    },
    "tier_round.cu": {
        "fused_scatter_round_f32": [P] * 11 + [I64, I32, I32, F32, F32, P],
        "fused_scatter_round_f32c": [P] * 11 + [I64, I32, I32, F32, F32, P],
        "activities_gather_f32": [P] * 9 + [I64, I32, F32, P],
        "activities_gather_f32c": [P] * 9 + [I64, I32, F32, P],
        "candidates_scatter_f32": [P] * 14 + [I64, I32, F32, F32, P],
        "candidates_scatter_f32c": [P] * 14 + [I64, I32, F32, F32, P],
        "combine_chunk_partials_f32": [P] * 12 + [I64, I64, P],
        "apply_updates_f32": [P] * 5 + [I64, I32, I32, F32, F32, F32, P],
        "apply_updates_stop": [P] * 6 + [I64, F64, F64, F64, F64, I32, P],
        "apply_updates_stop_f32": [P] * 6 + [I64, F32, F32, F32, F32, I32, P],
        "activities_f32": [P] * 8 + [I64, I32, F32, P],
        "candidates_f32": [P] * 13 + [I64, I32, F32, F32, P],
        "candidates_f32c": [P] * 13 + [I64, I32, F32, F32, P],
        "fused_round_f32": [P] * 9 + [I64, I32, F32, F32, P],
        "fused_round_f32c": [P] * 9 + [I64, I32, F32, F32, P],
    },
    "batch_tier_round.cu": {
        "batched_fused_scatter_round_f32": [P] * 12 + [I64, I32, I32, I64, I64, F32, F32, P],
        "node_fused_scatter_round_f32": [P] * 11 + [I64, I32, I32, I64, I64, F32, F32, P],
        "node_fused_scatter_round_f32c": [P] * 11 + [I64, I32, I32, I64, I64, F32, F32, P],
        "node_activities_gather_f32": [P] * 10 + [I64, I32, I32, I64, I64, F32, P],
        "node_activities_gather_f32c": [P] * 10 + [I64, I32, I32, I64, I64, F32, P],
        "node_combine_chunk_partials_f32": [P] * 12 + [I64, I64, I64, I64, P],
        "node_candidates_scatter_f32": [P] * 15 + [I64, I32, I32, I64, I64, F32, F32, P],
        "node_candidates_scatter_f32c": [P] * 15 + [I64, I32, I32, I64, I64, F32, F32, P],
        "apply_updates_batch_f32": [P] * 7 + [I64, I64, F32, F32, F32, P],
        "apply_updates_batch_stop": [P] * 10 + [I64, I64, F64, F64, F64, P],
        "apply_updates_batch_stop_f32": [P] * 10 + [I64, I64, F32, F32, F32, P],
    },
    "slab_tier_round.cu": {
        "slab_partials_f32": [P] * 13 + [I32, I64, I32, I32, I64, I64, F32, P],
        "node_slab_partials_f32": [P] * 11 + [I64, I32, I32, I32, I64, I64, I64, F32, P],
        "slab_scatter_f32": [P] * 19 + [I64, I32, I32, I32, I64, I64, F32, F32, P],
        "node_slab_scatter_f32": [P] * 17 + [I64, I32, I32, I32, I64, I64, I64, F32, F32, P],
        "slab_merge_f32": [P] * 8 + [I64, I64, I64, I32, I32, F32, F32, F32, P],
        "straddle_combine_f32": [P] * 16 + [I64, I64, I64, I64, P],
        "slab_merge_stop": [P] * 7 + [I64, F64, F64, F64, F64, I32, P],
        "slab_merge_stop_f32": [P] * 7 + [I64, F32, F32, F32, F32, I32, P],
        "slab_merge_rows_stop": [P] * 10 + [I64, I64, I64, F64, F64, F64, P],
        "slab_merge_rows_stop_f32": [P] * 10 + [I64, I64, I64, F32, F32, F32, P],
    },
    "telemetry.cu": {
        "record_round": [P] * 8 + [I64, I32, I32, I32, F64, P],
        "record_round_f32": [P] * 8 + [I64, I32, I32, I32, F32, P],
        "record_round_batch": [P] * 11 + [I64, I64, I32, I32, F64, P],
        "record_round_batch_f32": [P] * 11 + [I64, I64, I32, I32, F32, P],
    },
}



# The kernels with 16-bit forms: those of the single-instance engines
# (``half_round.cu``) and those of the batched, node and service rounds
# (``half_batch_round.cu``).  Every kernel but #16 (``node_objective``: the
# solver runs at the default type) has them.
SINGLE_HALF_KERNELS = ("fused_scatter_round", "activities_gather", "candidates_scatter",
                       "combine_chunk_partials", "apply_updates", "apply_updates_stop",
                       "activities", "candidates", "fused_round", "slab_partials",
                       "slab_scatter", "slab_merge", "slab_merge_stop", "straddle_combine",
                       "record_round")
BATCH_HALF_KERNELS = ("batched_fused_scatter_round", "node_fused_scatter_round",
                      "node_activities_gather", "node_combine_chunk_partials",
                      "node_candidates_scatter", "apply_updates_batch",
                      "apply_updates_batch_stop", "node_slab_partials", "node_slab_scatter",
                      "slab_merge_rows_stop", "record_round_batch")
HALF_KERNELS = SINGLE_HALF_KERNELS + BATCH_HALF_KERNELS


def _half_signatures(names) -> dict:
    """The 16-bit entries of the kernels ``names``: each takes its float32
    form's arguments (its scalars as floats holding 16-bit values),
    ``_bf16`` and ``_f16``, and ``_bf16c`` where float32 has a compact
    ``_f32c`` form."""
    f32 = {name: sig for table in SIGNATURES.values() for name, sig in table.items()}
    out = {}
    for name in names:
        for suffix in ("bf16", "f16"):
            out[f"{name}_{suffix}"] = f32[f"{name}_f32"]
        if f"{name}_f32c" in f32:
            out[f"{name}_bf16c"] = f32[f"{name}_f32c"]
    return out


SIGNATURES["half_round.cu"] = _half_signatures(SINGLE_HALF_KERNELS)
SIGNATURES["half_batch_round.cu"] = _half_signatures(BATCH_HALF_KERNELS)

_lock = threading.Lock()
_lib: SimpleNamespace | None = None
build_info: dict = {}
build_count = 0  # runs of the compilers in this process (the first use, at most)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def build_path() -> Path:
    """The build directory of this set of sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (*SOURCES, *HEADERS):
        h.update(f.name.encode() + f.read_bytes())
    return BUILD_DIR / h.hexdigest()[:16]


def library_paths() -> list[Path]:
    return [build_path() / f"lib{src.stem}.so" for src in SOURCES]


@contextlib.contextmanager
def _file_lock(path: Path):
    """An exclusive ``flock`` on ``path`` (created if missing), held for
    the ``with`` block: one process of this host at a time."""
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build() -> list[Path]:
    """Compile every source whose library does not exist yet, all at once,
    under the build directory's file lock: a process that finds another
    compiling waits for it and then finds the libraries built.

    Each compiler writes into a temporary file that is renamed into place,
    so concurrent processes never load a half-written library.
    ``build_info`` records the seconds taken and the compilers' register
    reports."""
    with _file_lock(build_path().with_suffix(".lock")):
        return _build_unlocked()


def _build_unlocked() -> list[Path]:
    global build_count
    outs = library_paths()
    todo = [(src, out) for src, out in zip(SOURCES, outs) if not out.exists()]
    if not todo:
        build_info.setdefault("seconds", 0.0)
        build_info.setdefault("cached", True)
        return outs
    outs[0].parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    jobs, tmps = [], []
    try:
        for src, out in todo:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
            os.close(fd)
            tmps.append(tmp)
            jobs.append(subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            ))
        logs = []
        for (src, out), proc, tmp in zip(todo, jobs, tmps):
            stdout, stderr = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {src.name} ({proc.returncode}):\n{stdout}\n{stderr}"
                )
            logs.append(stdout + stderr)
        for (_, out), tmp in zip(todo, tmps):
            os.replace(tmp, out)
    finally:
        for proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for tmp in tmps:
            if os.path.exists(tmp):
                os.unlink(tmp)
    build_info.update(seconds=time.perf_counter() - t0, cached=False, log="".join(logs))
    build_count += 1
    return outs


def lib() -> SimpleNamespace:
    """The loaded kernel libraries' entry points, by name (built on first
    call)."""
    global _lib
    with _lock:
        if _lib is None:
            entries = {}
            for src, path in zip(SOURCES, build()):
                handle = ctypes.CDLL(str(path))
                for name, argtypes in SIGNATURES[src.name].items():
                    fn = getattr(handle, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                    entries[name] = fn
                if "error_string" not in entries:
                    handle.error_string.argtypes = [ctypes.c_int]
                    handle.error_string.restype = ctypes.c_char_p
                    entries["error_string"] = handle.error_string
            _lib = SimpleNamespace(**entries)
        return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        msg = lib().error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: {msg} ({err})")
