#!/usr/bin/env python3
"""Time the main-path runs that kernels D, #8, #9, #10, #12 and #14 sit on,
through the port's public entry points only, so that two checkouts can be
compared in one call on one card (parent, change, change, parent).

    python3 tools/path_times.py [--src DIR] [--reps 5] [--paths NAME,...] [--count NAME,...]

Run from the root of a checkout on a machine with a CUDA card and nvcc.
``--src`` names the ``src`` directory whose ``repro_torch`` is timed
(default: this checkout's); the instances and helpers come from this
checkout's ``chip_smoke.py``.  The runs (``--paths`` picks some by name
or by the first words of their name, default all): ``propagate_block_ell`` with its
defaults on ``pb`` and ``banded`` (D with F), ``mixed`` (A', the combine,
E with F) and ``bandw`` and ``pbw`` (the partitioned engine: #11, the
straddle combine, #12 with #15), ``fused``: the explicit fused engine
(``scatter="fused"``: D with F) on ``bandw`` and ``pbw``, ``segment``: the
segment engine (``scatter="segment"``: C, or A, the combine and B, with F)
on ``pb``, ``banded`` and ``mixed``,
``propagate_nodes`` on the 64 branched ``pbf`` nodes of
``chip_smoke.py`` phase 6 (#10 with #9) and at tile width 4 (the multi-chunk
node round: node A', the node combine, node E with #9), and on the 16
branched ``pbw`` nodes of phase 8 (#13, the straddle combine, #14 with
#15), ``solve`` on ``pbf`` with its full 128-slot search (#10, #9, #16),
the same search at tile width 4 (phase 7's multi-chunk search) and on
``pbw`` with phase 8's 128-slot search (#14), ``propagate_batch`` on
``[bandw, pbw]``
(the batch-partitioned round) and on phase 9's fused bucket ``[pb, pbf,
banded, banded1]`` (#8 with #9), and phase 10's service stream of 24
requests through 4 slots (#8 with #9, A', the combine and E), served
once before the timing (construction, admission staging and the
engines' warm-up are set-up).  For each it prints the result (rounds,
search counts), the median wall time of ``--reps`` calls (CUDA events
around the call, host syncs included), the device busy time of one more
call (``torch.profiler`` device items), the idle share and the largest
device items, with ``--count`` the number and time of the device items
whose names hold each given substring (e.g. ``node_slab_partials``), the
caching allocator's device segments allocated and freed and its retries
over one call, and the card's name and power limit.
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
    ap.add_argument("--paths", default="")
    ap.add_argument("--count", default="")
    args = ap.parse_args()
    picked = {x for x in args.paths.split(",") if x}
    counted = tuple(x for x in args.count.split(",") if x)
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
    # A run is picked by its name or its first words ("nodes", "nodes pbf").
    want = lambda *names: not picked or any(x.split()[0] in names for x in picked)
    chosen = lambda name: not picked or any(name == x or name.startswith(x + " ")
                                            for x in picked)
    wide = {name: getattr(td, gen)(**kw) for name, gen, kw in cs.WIDE_SPECS}
    main = ({name: getattr(td, gen)(**kw) for name, gen, kw in cs.SPECS}
            if want("propagate_block_ell", "segment") else {})
    pbf = td.make_pseudo_boolean(**cs.PBF)
    tw = cs.SOLVER_TILE_WIDTH

    def branched(p, count):
        """``count`` branched nodes of ``p`` below its root at tile width 8."""
        root = rt.propagate_block_ell(p, tile_width=tw, device=dev)
        lb_r, ub_r = root.lb.cpu().numpy(), root.ub.cpu().numpy()
        cols = cs.most_fractional_order(np, lb_r, ub_r, p.is_int)[:count]
        return cs.branched(np, rt, lb_r, ub_r, cols)

    def rounds(r):
        return int(r.rounds.max()) if r.rounds.ndim else int(r.rounds)

    search = lambda r: (r.status, r.nodes_expanded, r.nodes_created, r.levels, r.host_syncs)
    paths = {}
    if want("propagate_block_ell"):
        for name, p in (*main.items(), *wide.items()):
            paths[f"propagate_block_ell {name}"] = (
                lambda p=p: rt.propagate_block_ell(p, device=dev), rounds)
    if want("segment"):
        for name, p in main.items():
            paths[f"segment {name}"] = (
                lambda p=p: rt.propagate_block_ell(p, scatter="segment", device=dev), rounds)
    if want("fused"):
        for name, p in wide.items():
            paths[f"fused {name} (scatter='fused')"] = (
                lambda p=p: rt.propagate_block_ell(p, scatter="fused", device=dev), rounds)
    if want("nodes"):
        nodes_pbf, nodes_pbw = branched(pbf, 6), branched(wide["pbw"], cs.WIDE_BRANCHED)
        paths["nodes pbf (64 nodes)"] = (
            lambda: rt.propagate_nodes(pbf, *nodes_pbf, tile_width=tw, device=dev), rounds)
        paths[f"nodes pbf K = {cs.MULTI_CHUNK_TILE_WIDTH} (64 nodes)"] = (
            lambda: rt.propagate_nodes(pbf, *nodes_pbf, tile_width=cs.MULTI_CHUNK_TILE_WIDTH,
                                       device=dev), rounds)
        paths["nodes pbw (16 nodes)"] = (
            lambda: rt.propagate_nodes(wide["pbw"], *nodes_pbw, tile_width=tw, device=dev),
            rounds)
    if want("solve"):
        c, cw = cs.objective(np, pbf.n), cs.objective(np, wide["pbw"].n)
        paths["solve pbf (128 slots)"] = (
            lambda: rt.solve(pbf, c, device=dev, **cs.FULL_SEARCH), search)
        paths[f"solve pbf multi-chunk (K = {cs.MULTI_CHUNK_TILE_WIDTH})"] = (
            lambda: rt.solve(pbf, c, device=dev, tile_width=cs.MULTI_CHUNK_TILE_WIDTH,
                             **cs.FULL_SEARCH), search)
        paths["solve pbw (128 slots)"] = (
            lambda: rt.solve(wide["pbw"], cw, device=dev, **cs.WIDE_SEARCH), search)
    if want("propagate_batch"):
        paths["propagate_batch [bandw, pbw]"] = (
            lambda: rt.propagate_batch([wide["bandw"], wide["pbw"]], device=dev),
            lambda rs: [rounds(r) for r in rs])
        fused = [td.make_pseudo_boolean(**cs.SPECS[0][2]), pbf, td.make_banded(**cs.SPECS[1][2]),
                 td.make_banded(**cs.BANDED1)]
        paths["propagate_batch fused [pb, pbf, banded, banded1]"] = (
            lambda: rt.propagate_batch(fused, device=dev), lambda rs: [rounds(r) for r in rs])
    if want("service"):
        stream, _ = cs.service_streams(np, td)
        specs = rt.BucketSpec.for_problems(stream, slots=cs.SERVICE_SLOTS,
                                           size_classes=cs.SERVICE_SIZE_CLASSES)
        svc = rt.PropagationService(specs, rounds_per_step=cs.SERVICE_ROUNDS_PER_STEP,
                                    device=dev)
        payloads = [next(s for s in specs if s.fits_problem(p)).pack(p) for p in stream]
        paths["service stream (24 requests)"] = (
            lambda: [t.result() for t in cs.serve_once(torch, svc, payloads)[0]],
            lambda rs: [int(r.rounds) for r in rs])
    paths = {name: run for name, run in paths.items() if chosen(name)}
    print(f"set-up: {time.perf_counter() - t0:.1f} s", flush=True)
    for name, (fn, summary) in paths.items():
        result = summary(fn())
        torch.cuda.synchronize()
        # The caching allocator's device segments (cudaMalloc calls) and
        # retries (cudaFree of cached blocks, then again) over one more call.
        before = torch.cuda.memory_stats()
        fn()
        torch.cuda.synchronize()
        after = torch.cuda.memory_stats()
        segs = {k: after.get(k, 0) - before.get(k, 0)
                for k in ("segment.all.allocated", "segment.all.freed", "num_alloc_retries")}
        wall = cs.time_ms(torch, fn, reps=1, trials=args.reps)
        prof = cs.busy_profile(torch, fn, counted)
        if prof is None:
            busy_txt = "busy not measured (the profiler recorded no device item)"
        else:
            busy, top = prof
            busy_txt = f"busy {busy:.3f} ms, idle share {1 - busy / wall:.3f}; top: {top}"
        print(f"path {name}: result {result}; wall {wall:.3f} ms (median of {args.reps}); "
              f"{busy_txt}; allocator over one call: {segs}", flush=True)
    print(f"gpu: {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
