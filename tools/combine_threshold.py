#!/usr/bin/env python3
"""Time the long-row combine at the shapes the main paths give it, with its
segments split into short ones (a thread each) and long ones (a warp each)
at several thresholds, to choose ``ref.LONG_SEGMENT``.

    python3 tools/combine_threshold.py [--reps 20]

Run from the root of a checkout on a machine with a CUDA card and nvcc.
Three shapes: ``mixed`` of ``chip_smoke.py`` at tile width 128 (rows of up
to 375 chunks); two of its service's ``mixed`` requests packed at tile
width 8 (rows of up to 3,000 chunks); and ``mixed`` under four node planes
at tile width 128 (``nodes mixed``).  The partials are kernel A''s at the
instances' initial bounds.  Then single segments of 375 to 12,000 chunks
of random partials alone, whose times per chunk show the cost of the warp's
in-order chain of adds.  Each threshold's split is held bitwise against
the plain version, then timed: the median over ``--reps`` launches (CUDA
events around the launch, queued behind a sleep on the card), the
thresholds taken in turn within each repetition.  "all short" is one thread
per segment, the kernel before the redesign.  Prints the card's name and
power limit.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
THRESHOLDS = (4, 8, 16, 32, 64, 128, 1 << 30)


def shapes(torch, rt, td, tk, ops, dev):
    """{name: (partials, chunk_row, row_start, active or None)}."""
    import numpy as np

    out = {}
    p = td.make_mixed(m=150_000, n=60_000, seed=0, density=0.0005)
    prep = rt.prepare_block_ell(p, device=dev)
    d = prep.d
    parts = tk.activities_gather_tiles(d.val, d.col, prep.lb0, prep.ub0, prep.n_pad,
                                       chunk_len=prep.chunk_len)
    out["mixed K=128"] = (parts, d.chunk_row, prep.row_start, None)
    bsz = 4
    lbp, ubp = prep.lb0.repeat(bsz, 1), prep.ub0.repeat(bsz, 1)
    act = torch.ones(bsz, dtype=torch.bool, device=dev)
    parts = tk.node_activities_gather_tiles(d.val, d.col, lbp, ubp, act, prep.n_pad,
                                            chunk_len=prep.chunk_len)
    out["nodes mixed K=128, 4 nodes"] = (parts, d.chunk_row, prep.row_start, act)
    rows = np.random.default_rng(0).integers(30_000, 90_000, size=28)[24:26]
    mixed = [td.make_mixed(m=int(m), n=30_000, seed=100 + i, density=0.0005)
             for i, m in enumerate(rows)]
    (batch,) = ops.packed_problems(mixed, tile_width=8)
    bp = ops.prepare_problem_batch(batch, device=dev)
    bd = bp.d
    width = bp.size * bp.n_pad
    parts = tk.activities_gather_tiles(bd.val, bd.col_g, bd.lb0.reshape(width),
                                       bd.ub0.reshape(width), width, chunk_len=bd.chunk_len)
    out["service mixed K=8, 2 requests"] = (parts, bd.chunk_row, bp.row_start, None)
    for n in (375, 3000, 6000, 12000):
        gen = torch.Generator(device=dev).manual_seed(n)
        f = lambda: torch.randn((n, 1), dtype=torch.float64, device=dev, generator=gen)
        c = lambda: torch.randint(0, 3, (n, 1), dtype=torch.int32, device=dev, generator=gen)
        crow = torch.zeros((n, 1), dtype=torch.int32, device=dev)
        row_start = torch.tensor([0, n], dtype=torch.int64, device=dev)
        out[f"one segment of {n} chunks"] = ((f(), c(), f(), c()), crow, row_start, None)
    return out


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("combine_threshold: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch as rt
    import repro_torch.data as td
    from repro_torch.kernels import ops, prop_round as tk, ref as tref

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(f"gpu: {smi}", flush=True)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    cases = shapes(torch, rt, td, tk, ops, dev)
    print(f"set-up {time.perf_counter() - t0:.1f} s", flush=True)
    summary = {}
    for name, (parts, crow, row_start, act) in cases.items():
        length = row_start[1:] - row_start[:-1]
        node = act is not None
        fn = tk.node_combine_chunk_partials_tiles if node else tk.combine_chunk_partials_tiles
        extra = (act,) if node else ()
        want = (tref.node_combine_chunk_partials_ref if node
                else tref.combine_chunk_partials_ref)(*parts, crow, row_start, *extra)
        split = {}
        for thr in THRESHOLDS:
            cls = tref.segment_classes(row_start, thr)
            for g, w in zip(fn(*parts, crow, row_start, *extra, classes=cls), want):
                if not torch.equal(g, w):
                    raise SystemExit(f"{name}: threshold {thr} disagrees with the plain version")
            split[thr] = cls
        times = {thr: [] for thr in THRESHOLDS}
        for _ in range(args.reps):
            for thr in THRESHOLDS:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda._sleep(1_000_000)
                start.record()
                fn(*parts, crow, row_start, *extra, classes=split[thr])
                end.record()
                times[thr].append((start, end))
        torch.cuda.synchronize()
        row = {}
        for thr in THRESHOLDS:
            ms = statistics.median(s.elapsed_time(e) for s, e in times[thr])
            label = "all short" if thr == 1 << 30 else str(thr)
            row[label] = ms
            print(f"{name}: threshold {label}: long segments {split[thr][1].numel()}, "
                  f"ms {ms:.4f}", flush=True)
        print(f"{name}: segments {length.numel()}, longest {int(length.max())} chunks, "
              f"chunks {int(row_start[-1])}", flush=True)
        summary[name] = row
    print(json.dumps({"gpu": smi, "combine_ms": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
