#!/usr/bin/env python3
"""Time the main-path runs that kernels #10 and #12 sit on, through the
port's public entry points only, so that two checkouts can be compared in
one call on one card (parent, change, change, parent).

    python3 tools/path_times.py [--src DIR] [--reps 5]

Run from the root of a checkout on a machine with a CUDA card and nvcc.
``--src`` names the ``src`` directory whose ``repro_torch`` is timed
(default: this checkout's); the instances and helpers come from this
checkout's ``chip_smoke.py``.  The runs: ``propagate_block_ell`` on
``bandw`` and ``pbw`` (the partitioned engine: #11, the straddle combine,
#12 with #15), ``propagate_nodes`` on the 64 branched ``pbf`` nodes of
``chip_smoke.py`` phase 6 (#10 with #9), ``solve`` on ``pbf`` with its full
128-slot search (#10, #9, #16) and ``propagate_batch`` on ``[bandw, pbw]``
(the batch-partitioned round).  For each it prints the result (rounds,
search counts), the median wall time of ``--reps`` calls (CUDA events
around the call, host syncs included), the device busy time of one more
call (``torch.profiler`` device items), the idle share and the largest
device items, and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("path_times: no CUDA device", file=sys.stderr)
        return 2
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    import repro_torch as rt
    import repro_torch.data as td

    if not Path(rt.__file__).resolve().is_relative_to(src):
        raise SystemExit(f"path_times: imported {rt.__file__}, not from {src}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"gpu: {smi}; port from {src}", flush=True)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    wide = {name: getattr(td, gen)(**kw) for name, gen, kw in cs.WIDE_SPECS}
    pbf = td.make_pseudo_boolean(**cs.PBF)
    root = rt.propagate_block_ell(pbf, tile_width=cs.SOLVER_TILE_WIDTH, device=dev)
    lb_r, ub_r = root.lb.cpu().numpy(), root.ub.cpu().numpy()
    cols = cs.most_fractional_order(np, lb_r, ub_r, pbf.is_int)[:6]
    lb_n, ub_n = cs.branched(np, rt, lb_r, ub_r, cols)
    c = cs.objective(np, pbf.n)
    print(f"set-up: {time.perf_counter() - t0:.1f} s", flush=True)

    def rounds(r):
        return int(r.rounds.max()) if r.rounds.ndim else int(r.rounds)

    paths = {
        "propagate_block_ell bandw": (
            lambda: rt.propagate_block_ell(wide["bandw"], device=dev), rounds),
        "propagate_block_ell pbw": (
            lambda: rt.propagate_block_ell(wide["pbw"], device=dev), rounds),
        "nodes pbf (64 nodes)": (
            lambda: rt.propagate_nodes(pbf, lb_n, ub_n, tile_width=cs.SOLVER_TILE_WIDTH,
                                       device=dev), rounds),
        "solve pbf (128 slots)": (
            lambda: rt.solve(pbf, c, device=dev, **cs.FULL_SEARCH),
            lambda r: (r.status, r.nodes_expanded, r.nodes_created, r.levels, r.host_syncs)),
        "propagate_batch [bandw, pbw]": (
            lambda: rt.propagate_batch([wide["bandw"], wide["pbw"]], device=dev),
            lambda rs: [rounds(r) for r in rs]),
    }
    for name, (fn, summary) in paths.items():
        result = summary(fn())
        torch.cuda.synchronize()
        wall = cs.time_ms(torch, fn, reps=1, trials=args.reps)
        prof = cs.busy_profile(torch, fn)
        if prof is None:
            busy_txt = "busy not measured (the profiler recorded no device item)"
        else:
            busy, top = prof
            busy_txt = f"busy {busy:.3f} ms, idle share {1 - busy / wall:.3f}; top: {top}"
        print(f"path {name}: result {result}; wall {wall:.3f} ms (median of {args.reps}); "
              f"{busy_txt}", flush=True)
    print(f"gpu: {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
