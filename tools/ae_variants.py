#!/usr/bin/env python3
"""Time variants of kernels A' and E on the ``mixed`` stream, to see what
holds each back on the card (no profiler that counts stalls runs there).

    python3 tools/ae_variants.py [--reps 20]

Run from the root of a checkout on a machine with a CUDA card and nvcc.  It
builds ``tools/ae_variants.cu`` (the kernels before the redesign and the
redesigned ones with one trait at a time switched off) into
``src/repro_torch/build/ae_variants/``, prepares the ``mixed`` instance of
``chip_smoke.py`` (m = 150,000, n = 60,000, K = 128), holds every variant
against the plain version of its kernel (bitwise, as values), and prints
each variant's median time over ``--reps`` launches (CUDA events around
the launch, queued behind a sleep on the card, the variants taken in turn
within each repetition) with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SOURCE = ROOT / "tools" / "ae_variants.cu"

A_VARIANTS = {
    0: "before the redesign (one chain per stride, every slot)",
    1: "new helpers, 1 stride per batch, every slot",
    2: "4 strides in flight, every slot",
    3: "1 stride per batch, stopped at the length",
    4: "4 strides in flight, stopped (the port's A')",
    5: "as 4, bounds as one 16-byte pair (interleaved copy)",
    6: "as 5, at most 32 registers a thread",
    7: "as 5, at most 40 registers a thread",
}
E_VARIANTS = {
    0: "before the redesign (one chain per stride, every slot, CAS)",
    1: "4 strides, stopped, CAS",
    2: "4 strides, stopped, integer atomics + L2 pre-check (the port's E)",
    3: "4 strides, stopped, integer atomics, no pre-check",
    4: "1 stride, every slot, integer atomics + pre-check",
    5: "as 2, bounds as one 16-byte pair",
    6: "as 3, bounds as one 16-byte pair",
    7: "as 5, pre-check through L1",
    8: "as 5, at most 32 registers a thread",
    9: "as 5, at most 64 registers a thread",
    10: "as 5, at most 80 registers a thread",
    11: "as 5, at most 48 registers a thread",
    12: "as 5, at most 40 registers a thread",
}


def build() -> ctypes.CDLL:
    from repro_torch.kernels import _build

    out = _build.BUILD_DIR / "ae_variants" / "libae_variants.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    t = time.perf_counter()
    done = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(SOURCE)],
                          check=True, capture_output=True, text=True)
    print(f"build: {time.perf_counter() - t:.1f} s", flush=True)
    for line in (done.stdout + done.stderr).splitlines():
        if "Used" in line or "spill" in line and " 0 bytes spill" not in line:
            print("  ptxas:", line.strip(), flush=True)
    lib = ctypes.CDLL(str(out))
    P, I64, I32, F64 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_double
    lib.a_variant.argtypes = [I32] + [P] * 10 + [I64, I32, F64, P]
    lib.e_variant.argtypes = [I32] + [P] * 15 + [I64, I32, F64, F64, P]
    lib.a_variant.restype = lib.e_variant.restype = I32
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("ae_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch as rt
    import repro_torch.data as td
    from repro_torch.kernels import ref as tref

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"gpu: {smi}", flush=True)
    lib = build()
    p = td.make_mixed(m=150_000, n=60_000, seed=0, density=0.0005)
    prep = rt.prepare_block_ell(p, device="cuda")
    d, n_pad, cfg = prep.d, prep.n_pad, rt.core.DEFAULT_CONFIG
    t, r, k = d.val.shape
    n_chunks = t * r
    clen = prep.chunk_len
    nnz = int((d.val != 0).sum())
    strides = int(((clen + 31) // 32).clamp_min(1).sum()) * 32  # slots the stopped walk reads
    print(f"mixed: tiles {(t, r, k)}, {nnz} nonzeros in {t * r * k} slots; the stopped walk "
          f"reads {strides} slots", flush=True)
    lb, ub = prep.lb0, prep.ub0
    lub = torch.stack((lb, ub), dim=-1).contiguous()  # (n_pad, 2) interleaved bounds
    want_a = tref.activities_gather_tiles_ref(d.val, d.col, lb, ub, n_pad)
    aggs = tref.combine_chunk_partials_ref(*want_a, d.chunk_row, prep.row_start)
    want_e = tref.candidates_scatter_tiles_ref(d.val, d.col, prep.ii_g, *aggs, prep.lhs_g,
                                               prep.rhs_g, lb, ub, n_pad, cfg.int_eps)
    ptr = lambda x: x.data_ptr()
    stream = lambda: torch.cuda.current_stream().cuda_stream

    def run_a(v):
        out = [torch.empty((t, r), dtype=dt, device="cuda")
               for dt in (torch.float64, torch.int32, torch.float64, torch.int32)]
        err = lib.a_variant(v, ptr(d.val), ptr(d.col), ptr(clen), ptr(lb), ptr(ub), ptr(lub),
                            *map(ptr, out), n_chunks, k, cfg.inf, stream())
        assert err == 0, err
        return out

    def run_e(v):
        bl = torch.full((n_pad,), -cfg.inf, dtype=torch.float64, device="cuda")
        bu = torch.full((n_pad,), cfg.inf, dtype=torch.float64, device="cuda")
        return bl, bu, lambda: lib.e_variant(
            v, ptr(d.val), ptr(d.col), ptr(prep.ii_g), ptr(clen), *map(ptr, aggs),
            ptr(prep.lhs_g), ptr(prep.rhs_g), ptr(lb), ptr(ub), ptr(lub), ptr(bl), ptr(bu),
            n_chunks, k,
            cfg.int_eps, cfg.inf, stream())

    for v in A_VARIANTS:
        got = run_a(v)
        torch.cuda.synchronize()
        for g, w in zip(got, want_a):
            if not torch.equal(g, w):
                raise SystemExit(f"ae_variants: A' variant {v} disagrees with the plain version")
    for v in E_VARIANTS:
        bl, bu, launch = run_e(v)
        assert launch() == 0
        torch.cuda.synchronize()
        if not (torch.equal(bl, want_e[0]) and torch.equal(bu, want_e[1])):
            raise SystemExit(f"ae_variants: E variant {v} disagrees with the plain version")

    times = {("A'", v): [] for v in A_VARIANTS}
    times.update({("E", v): [] for v in E_VARIANTS})
    for _ in range(args.reps):
        for (kern, v), acc in times.items():
            if kern == "E":
                _, _, launch = run_e(v)
            torch.cuda.synchronize()
            torch.cuda._sleep(1_000_000)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            if kern == "A'":
                run_a(v)
            else:
                assert launch() == 0
            end.record()
            torch.cuda.synchronize()
            acc.append(start.elapsed_time(end))
    stack = []
    for _ in range(args.reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(1_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.stack((lb, ub), dim=-1)
        end.record()
        torch.cuda.synchronize()
        stack.append(start.elapsed_time(end))
    print(f"interleaving the bounds (torch.stack, {2 * n_pad} float64): "
          f"{statistics.median(stack):.4f} ms", flush=True)
    rows = []
    for (kern, v), acc in times.items():
        ms = statistics.median(acc)
        what = (A_VARIANTS if kern == "A'" else E_VARIANTS)[v]
        rows.append(dict(kernel=kern, variant=v, what=what, ms=ms))
        print(f"{kern} variant {v}: {ms:.4f} ms  {what}", flush=True)
    print(json.dumps({"gpu": smi, "variants": rows}), flush=True)
    print(f"gpu: {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
