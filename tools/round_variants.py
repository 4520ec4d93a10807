#!/usr/bin/env python3
"""Time variants of kernels D (the single instance's fused round), #8 (the
packed batch's round) and #10 (the node round), of the scatters of #12 and
#14 (the slab rounds) and of the batched merges #9 and #15, to see which
design step of their redesign pays (no profiler that counts stalls runs on
the card).

    python3 tools/round_variants.py [--reps 20] [--only 1,9]

Run from the root of a checkout on a machine with a CUDA card and nvcc.  It
builds ``tools/round_variants.cu`` (the kernels before the redesign, and the
redesigned ones one step at a time: bounds gathered once and held, integer
atomics, chunks stopped at their length, short-row chunks packed several to
a warp, node- or instance-major order over the active planes only or the
window from the tile maps, a register cap)
into ``src/repro_torch/build/round_variants/``, makes the instances of
``chip_smoke.py`` -- ``pb``, ``banded``, ``bandw`` and ``pbw`` (one
instance each at K = 128, the explicit fused engine's tiles at n_pad
150,016) for D, ``pbf`` at tile width 8 with its 128-node pool for #10
and #9 (0, 8 and 128 nodes active), ``bandw`` and ``pbw`` (one plane each,
their default slab partitions) for #12 and #15, the fused batch bucket
(``pb``, ``pbf``, ``banded`` and a second ``banded``) with 0, 2 and 4
instances active for #8, ``pbw`` at tile width 8 with a 128-node pool (0,
8, 32 and 128 nodes active) for #14 -- holds every
variant against the plain version of its kernel (bitwise, as values), and
prints each variant's median time over ``--reps`` launches (CUDA events
around the launch, queued behind a sleep on the card, the variants taken in
turn within each repetition; the accumulator planes at the sentinels before
each scatter, the merges' inputs restored and the L2 evicted before each
merge), the time of the two ``torch.full`` sentinel planes that the
wrappers no longer fill per launch, and the card's name and power limit.
``--only`` picks the kernels (of 1 (D), 8, 9, 10, 12, 14; the merge #15
rides with 12).
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
SOURCE = ROOT / "tools" / "round_variants.cu"

NODE_VARIANTS = {
    0: "before the redesign (warp ballot order, two gathers per slot, CAS, every slot)",
    1: "ballot order, bounds gathered once and held, CAS, every slot",
    2: "as 1, integer atomics",
    3: "as 2, stopped at the chunk length",
    4: "node-major over the resident blocks",
    5: "node-major over one block per chunk block (no resident cap)",
    6: "as 4, at most 64 registers a thread",
    7: "as 4, at most 40 registers a thread",
    8: "as 4, at most 32 registers a thread",
    9: "as 4, columns and marks loaded with the values",
    10: "as 9, no pre-check before the atomics (the port's #10 before it shared the walk)",
    11: "as 9, at most 40 registers a thread",
    12: "as 4, no pre-check before the atomics",
    13: "as 10 on the active-only walk that #8 and #14 share (the port's #10)",
}
SLAB_VARIANTS = {
    0: "before the redesign (search over the runs, two gathers per slot, CAS, every slot)",
    1: "search, bounds held, CAS, every slot",
    2: "as 1, integer atomics",
    3: "as 2, stopped at the copy stream's chunk length",
    4: "window from the tile maps, no search (four strides held at K = 128)",
    5: "as 4, at most 64 registers a thread",
    6: "as 4, one stride held (later strides gathered again)",
    7: "as 6, columns and marks loaded with the values",
    8: "as 7, no pre-check before the atomics (the port's #12 scatter)",
    9: "as 7, at most 64 registers a thread",
    10: "as 7, at most 40 registers a thread",
    11: "as 7, at most 32 registers a thread",
    12: "as 6, no pre-check before the atomics",
}
BATCHED_VARIANTS = {
    0: "before the redesign (every chunk's warp launched, two gathers per slot, CAS, every slot)",
    1: "the same grid, bounds gathered once and held, values/columns/marks together, CAS",
    2: "as 1, integer atomics",
    3: "as 2, stopped at the chunk length",
    4: "instance-major over the active instances' chunk blocks",
    5: "as 4, at most 64 registers a thread (the port's #8)",
}
NODE_SLAB_VARIANTS = {
    0: "before the redesign (warp ballot order, search over the runs, two gathers, CAS)",
    1: "ballot order and search, chunk_round (bounds held, integer atomics, stopped)",
    2: "as 1, the window from tile_slab (no search)",
    3: "node-major over the active nodes' chunk blocks",
    4: "as 3, at most 64 registers a thread, 4 blocks an SM (the port's #14 scatter)",
    5: "as 3, at most 40 registers a thread, 6 blocks an SM",
    6: "node-major over groups of 8 active nodes (a warp's chunks for each in turn)",
    7: "as 6, each chunk's data and first strides loaded once for the group",
    8: "as 7, at most 64 registers a thread",
    9: "one group of every active node (ballot order over the resident blocks), at most 64 "
       "registers",
}
MERGE_VARIANTS = {
    0: "#9 reading the planes only (before the hand-back)",
    1: "#9 handing them back at the sentinels, (column block, row) grid (before the walk)",
    2: "#15 reading the planes only (before the redesign)",
    3: "#15 handing them back (the port's)",
    4: "#9 on the active-only walk, a flag store per thread that tightens",
    5: "as 4, one flag store per warp",
    6: "as 5, an item of 2 column blocks, a thread's columns loaded before any merge",
    7: "as 5, an item of 4 column blocks, a thread's columns loaded before any merge (the "
       "port's #9)",
    8: "as 5, an item of 8 column blocks, a thread's columns loaded before any merge",
    9: "a (column block, group of 32 rows) grid, a warp merging its column of each active row",
}
FUSED_VARIANTS = {
    0: "before the redesign (group_width(K) lanes a chunk, two gathers per slot, CAS, every "
       "slot, planes filled per launch)",
    1: "the same grid, bounds gathered once and held, values/columns/marks together, CAS",
    2: "as 1, stopped at the chunk length",
    3: "as 2, integer atomics",
    4: "as 3, packed groups (group_width(longest chunk) lanes a chunk; the port's D)",
    5: "as 4, at most 64 registers a thread",
    6: "as 4, at most 40 registers a thread",
    7: "as 3 (a warp a chunk), at most 64 registers a thread",
}


def build() -> ctypes.CDLL:
    from repro_torch.kernels import _build

    out = _build.BUILD_DIR / "round_variants" / "libround_variants.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    t = time.perf_counter()
    done = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(SOURCE)],
                          check=True, capture_output=True, text=True)
    print(f"build: {time.perf_counter() - t:.1f} s", flush=True)
    entry, spill = "", ""
    for line in (done.stdout + done.stderr).splitlines():
        if "Compiling entry" in line:
            entry = line.split("'")[1] if "'" in line else line
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line:
            print(f"  ptxas: {entry[:110]}: {line.split('info    :')[-1].strip()}; {spill}",
                  flush=True)
    lib = ctypes.CDLL(str(out))
    P, I64, I32, F64 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_double
    lib.node_variant.argtypes = [I32] + [P] * 11 + [I64, I32, I64, I64, F64, F64, P]
    lib.slab_variant.argtypes = [I32] + [P] * 21 + [I32, I64, I32, I32, I64, I64, F64, F64, P]
    lib.merge_variant.argtypes = [I32] + [P] * 6 + [I64, I64, I64, F64, F64, F64, P]
    lib.fused_variant.argtypes = [I32] + [P] * 10 + [I64, I32, I32, F64, F64, P]
    lib.batched_variant.argtypes = [I32] + [P] * 13 + [I64, I32, I32, I32, I64, I64, F64, F64,
                                                       P]
    lib.node_slab_variant.argtypes = [I32] + [P] * 19 + [I32, I64, I32, I32, I32, I64, I64, I64,
                                                         F64, F64, P]
    for fn in (lib.node_variant, lib.slab_variant, lib.merge_variant, lib.batched_variant,
               lib.node_slab_variant, lib.fused_variant):
        fn.restype = I32
    return lib


def event_ms(torch, launch, reset=None) -> float:
    """One launch's device time: queued behind a sleep, CUDA events around
    it; ``reset`` (untimed) first."""
    if reset is not None:
        reset()
    torch.cuda.synchronize()
    torch.cuda._sleep(1_000_000)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    err = launch()
    end.record()
    torch.cuda.synchronize()
    if err:
        raise SystemExit(f"round_variants: launch failed with CUDA error {err}")
    return start.elapsed_time(end)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--only", default="1,8,9,10,12,14")
    args = ap.parse_args()
    only = {int(x) for x in args.only.split(",")}
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("round_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import repro_torch as rt
    import repro_torch.data as td
    from repro_torch.kernels import accumulator_planes, ops, ref as tref

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"gpu: {smi}", flush=True)
    lib = build()
    cfg = rt.core.DEFAULT_CONFIG
    inf, eps = cfg.inf, cfg.eps_for(torch.float64)
    ptr = lambda x: None if x is None else x.data_ptr()
    stream = lambda: torch.cuda.current_stream().cuda_stream
    sentinels = lambda acc: (acc[0].fill_(-inf), acc[1].fill_(inf))

    def fill(like):
        """The pair of sentinel planes a wrapper filled per launch before."""
        accumulator_planes(like)
        return 0

    times: dict = {}
    cases: list = []  # (label, kind, variant, launch, reset)

    fills = {}
    if 1 in only:
        # D on one instance's (n_pad,) vectors at K = 128: pb and pbw (chunks
        # of at most 8 slots: packed groups), banded and bandw (24 slots).
        for name, gen, kw in (*cs.SPECS[:2], *cs.WIDE_SPECS):
            dprep = rt.prepare_block_ell(getattr(td, gen)(**kw), device="cuda")
            d = dprep.d
            t, r, k = d.val.shape
            want = tref.fused_scatter_round_tiles_ref(
                d.val, d.col, dprep.ii_g, dprep.lhs_g, dprep.rhs_g, dprep.lb0, dprep.ub0,
                dprep.n_pad, cfg.int_eps)
            dacc = accumulator_planes(dprep.lb0)
            print(f"D {name}: tiles {(t, r, k)}, {int((d.val != 0).sum())} nonzeros, "
                  f"longest chunk {dprep.max_chunk_len}, n_pad {dprep.n_pad}", flush=True)
            for v in FUSED_VARIANTS:
                def launch(v=v, d=d, dprep=dprep, dacc=dacc, chunks=t * r, k=k):
                    return lib.fused_variant(
                        v, ptr(d.val), ptr(d.col), ptr(dprep.ii_g), ptr(dprep.chunk_len),
                        ptr(dprep.lhs_g), ptr(dprep.rhs_g), ptr(dprep.lb0), ptr(dprep.ub0),
                        ptr(dacc[0]), ptr(dacc[1]), chunks, k, dprep.max_chunk_len,
                        cfg.int_eps, inf, stream())

                event_ms(torch, launch, lambda dacc=dacc: sentinels(dacc))
                if not (torch.equal(dacc[0], want[0]) and torch.equal(dacc[1], want[1])):
                    raise SystemExit(f"round_variants: D {name} variant {v} disagrees with the "
                                     "plain version")
                cases.append((f"D {name}", "fused", v, launch, lambda dacc=dacc: sentinels(dacc)))
            fills[f"D {name}"] = statistics.median(
                event_ms(torch, lambda lb=dprep.lb0: fill(lb)) for _ in range(args.reps))

    if 9 in only or 10 in only:
        # #10 and #9 on the pbf pool at tile width 8.
        pbf = td.make_pseudo_boolean(**cs.PBF)
        prep = rt.prepare_block_ell(pbf, tile_width=cs.SOLVER_TILE_WIDTH, device="cuda")
        d, n_pad = prep.d, prep.n_pad
        t, r, k = d.val.shape
        lbp, ubp = ops._node_planes(prep, *cs.node_pool(np, rt, pbf, cs.POOL, seed=3))
        acc = accumulator_planes(lbp)
        print(f"pbf: tiles {(t, r, k)}, {int((d.val != 0).sum())} nonzeros, "
              f"pool {tuple(lbp.shape)}", flush=True)
        for n_act in (0, 8, cs.POOL):
            act = torch.zeros(cs.POOL, dtype=torch.bool, device="cuda")
            if n_act:
                act[:: cs.POOL // n_act] = True
            want = tref.node_fused_scatter_round_ref(d.val, d.col, prep.ii_g, prep.lhs_g,
                                                     prep.rhs_g, lbp, ubp, n_pad, cfg.int_eps,
                                                     active=act)
            label = f"#10 pbf pool, {n_act} of {cs.POOL} active"
            for v in NODE_VARIANTS if 10 in only else ():
                def launch(v=v, act=act):
                    return lib.node_variant(
                        v, ptr(d.val), ptr(d.col), ptr(prep.ii_g), ptr(prep.chunk_len),
                        ptr(prep.lhs_g), ptr(prep.rhs_g), ptr(lbp), ptr(ubp), ptr(act), ptr(acc[0]),
                        ptr(acc[1]), t * r, k, cs.POOL, n_pad, cfg.int_eps, inf, stream())

                event_ms(torch, launch, lambda: sentinels(acc))
                if not (torch.equal(acc[0], want[0]) and torch.equal(acc[1], want[1])):
                    raise SystemExit(f"round_variants: {label} variant {v} disagrees with "
                                     "the plain version")
                cases.append((label, "node", v, launch, lambda: sentinels(acc)))
            best = [x.clone() for x in want]
            want_m = rt.core.apply_updates_batch(lbp, ubp, *best, eps, active=act)
            planes = [lbp.clone(), ubp.clone(), best[0].clone(), best[1].clone()]
            flags = torch.zeros(cs.POOL, dtype=torch.int32, device="cuda")
            flush = torch.empty(64 << 17, dtype=torch.float64, device="cuda")

            def restore(planes=planes, best=best, flags=flags, flush=flush):
                for x, y in zip(planes, (lbp, ubp, *best)):
                    x.copy_(y)
                flags.zero_()
                flush.zero_()

            for v in (0, 1, 4, 5, 6, 7, 8, 9) if 9 in only else (0, 1):
                def launch(v=v, act=act, planes=planes, flags=flags):
                    return lib.merge_variant(v, *map(ptr, planes), ptr(act), ptr(flags),
                                             cs.POOL, n_pad, n_pad, eps, inf, 0.0, stream())

                label = f"#9 pbf pool, {n_act} of {cs.POOL} active"
                event_ms(torch, launch, restore)
                handed = v == 0 or bool((planes[2][act] == -inf).all()
                                        and (planes[3][act] == inf).all())
                if not (torch.equal(planes[0], want_m[0]) and torch.equal(planes[1], want_m[1])
                        and torch.equal(flags != 0, want_m[2]) and handed
                        and torch.equal(planes[2][~act], best[0][~act])):
                    raise SystemExit(f"round_variants: {label} variant {v} disagrees with the "
                                     "plain version")
                cases.append((label, "merge", v, launch, restore))
        fills["pbf pool"] = statistics.median(event_ms(torch, lambda: fill(lbp))
                                              for _ in range(args.reps))

    if 9 in only:
        # #9 on the fused batch bucket's (4, 60,032) planes, 1 and 4 active
        # (pb alone runs rounds 10 to 33 of that batch).
        pops = [td.make_pseudo_boolean(**cs.SPECS[0][2]), td.make_pseudo_boolean(**cs.PBF),
                td.make_banded(**cs.SPECS[1][2]), td.make_banded(**cs.BANDED1)]
        (batch,) = ops.packed_problems(pops)
        bd = ops.prepare_problem_batch(batch, device="cuda").d
        bsz, width = bd.lb0.shape
        for n_act in (1, bsz):
            act = torch.arange(bsz, device="cuda") < n_act
            best = tref.batched_fused_scatter_round_ref(
                bd.val, bd.col_g, bd.ii_g, bd.lhs_g, bd.rhs_g, bd.lb0, bd.ub0, width,
                cfg.int_eps, active=act)
            want_m = rt.core.apply_updates_batch(bd.lb0, bd.ub0, *best, eps, active=act)
            planes = [bd.lb0.clone(), bd.ub0.clone(), best[0].clone(), best[1].clone()]
            flags = torch.zeros(bsz, dtype=torch.int32, device="cuda")
            flush = torch.empty(64 << 17, dtype=torch.float64, device="cuda")

            def restore(planes=planes, best=best, flags=flags, flush=flush):
                for x, y in zip(planes, (bd.lb0, bd.ub0, *best)):
                    x.copy_(y)
                flags.zero_()
                flush.zero_()

            label = f"#9 fused bucket, {n_act} of {bsz} active"
            for v in (1, 5, 6, 7, 9):
                def launch(v=v, act=act, planes=planes, flags=flags):
                    return lib.merge_variant(v, *map(ptr, planes), ptr(act), ptr(flags), bsz,
                                             width, width, eps, inf, 0.0, stream())

                event_ms(torch, launch, restore)
                if not (torch.equal(planes[0], want_m[0]) and torch.equal(flags != 0, want_m[2])):
                    raise SystemExit(f"round_variants: {label} variant {v} disagrees with the "
                                     "plain version")
                cases.append((label, "merge", v, launch, restore))

    # #12's scatter and #15 on bandw and pbw, one plane each.
    if 12 in only:
        for name, gen, kw in cs.WIDE_SPECS:
            p = getattr(td, gen)(**kw)
            wprep = rt.prepare_block_ell(p, device="cuda")
            part = wprep.slab_partition()
            width = wprep.n_pad
            lb, ub = wprep.lb0[None].clone(), wprep.ub0[None].clone()
            one = torch.ones(1, dtype=torch.bool, device="cuda")
            partials = tref.batched_slab_partials_ref(
                part.a_val, part.a_col_s, part.a_run_start, part.a_run_len, part.a_run_inst,
                part.a_run_slab, one, lb, ub, part.slab, part.a_max_run_len)
            strs = tref.straddle_tables(part, *partials)
            want = tref.batched_slab_scatter_ref(
                part.val, part.col_s, part.ii_g, part.row_done, *strs, part.lhs_g, part.rhs_g,
                part.run_start, part.run_inst, part.run_slab, one, lb, ub, part.slab, cfg.int_eps)
            wacc = accumulator_planes(lb)
            tw, rw, kw_ = part.val.shape
            print(f"{name}: copy tiles {(tw, rw, kw_)}, "
                  f"{int((part.val != 0).sum())} kept nonzeros, "
                  f"slab {part.slab} x {part.n_slabs}, chunks stopped short of K: "
                  f"{int((part.chunk_len < kw_).sum())} of {tw * rw}", flush=True)
            for v in SLAB_VARIANTS:
                def launch(v=v, part=part, strs=strs, lb=lb, ub=ub, wacc=wacc, one=one, width=width,
                           shape=(tw, rw, kw_)):
                    tw, rw, kw_ = shape
                    return lib.slab_variant(
                        v, ptr(part.val), ptr(part.col_s), ptr(part.ii_g), ptr(part.chunk_len),
                        ptr(part.row_done), *map(ptr, strs), ptr(part.lhs_g), ptr(part.rhs_g),
                        ptr(part.run_start), ptr(part.run_inst), ptr(part.run_slab),
                        ptr(part.tile_inst), ptr(part.tile_slab), ptr(one), ptr(lb), ptr(ub),
                        ptr(wacc[0]), ptr(wacc[1]), part.run_start.numel(), tw * rw, rw, kw_, width,
                        part.slab, cfg.int_eps, inf, stream())

                event_ms(torch, launch, lambda wacc=wacc: sentinels(wacc))
                if not (torch.equal(wacc[0], want[0]) and torch.equal(wacc[1], want[1])):
                    raise SystemExit(f"round_variants: #12 {name} variant {v} disagrees with the "
                                     "plain version")
                cases.append((f"#12 scatter {name}", "slab", v, launch,
                              lambda wacc=wacc: sentinels(wacc)))
            planes = [lb.clone(), ub.clone(), want[0].clone(), want[1].clone()]
            flags = torch.zeros(part.n_slabs, dtype=torch.int32, device="cuda")
            flush = torch.empty(64 << 17, dtype=torch.float64, device="cuda")

            def restore(planes=planes, lb=lb, ub=ub, want=want, flags=flags, flush=flush):
                for x, y in zip(planes, (lb, ub, *want)):
                    x.copy_(y)
                flags.zero_()
                flush.zero_()

            for v in (2, 3):
                def launch(v=v, planes=planes, one=one, flags=flags, width=width, part=part):
                    return lib.merge_variant(v, *map(ptr, planes), ptr(one), ptr(flags), 1, width,
                                             part.slab, eps, inf, 0.0, stream())

                cases.append((f"#15 {name}", "merge", v, launch, restore))
            fills[name] = statistics.median(event_ms(torch, lambda lb=lb: fill(lb))
                                            for _ in range(args.reps))


    # #8 on the fused batch bucket, 0, 2 and 4 instances active.
    if 8 in only:
        pops = [td.make_pseudo_boolean(**cs.SPECS[0][2]), td.make_pseudo_boolean(**cs.PBF),
                td.make_banded(**cs.SPECS[1][2]), td.make_banded(**cs.BANDED1)]
        (batch,) = ops.packed_problems(pops)
        bprep = ops.prepare_problem_batch(batch, device="cuda")
        assert bprep.fits_one_chunk
        bd = bprep.d
        tb, rb, kb = bd.val.shape
        bacc = accumulator_planes(bd.lb0)
        print(f"fused bucket: tiles {(tb, rb, kb)}, {int((bd.val != 0).sum())} nonzeros, "
              f"longest chunk {bprep.max_chunk_len}, planes {tuple(bd.lb0.shape)}", flush=True)
        for n_act in (0, 2, batch.size):
            act_h = np.zeros(batch.size, bool)
            act_h[:: max(1, batch.size // max(n_act, 1))][:n_act] = True
            act = torch.as_tensor(act_h, device="cuda")
            want = tref.batched_fused_scatter_round_ref(
                bd.val, bd.col_g, bd.ii_g, bd.lhs_g, bd.rhs_g, bd.lb0, bd.ub0, bprep.n_pad,
                cfg.int_eps, active=act)
            label = f"#8 fused bucket, {n_act} of {batch.size} active"
            for v in BATCHED_VARIANTS:
                def launch(v=v, act=act):
                    return lib.batched_variant(
                        v, ptr(bd.val), ptr(bd.col), ptr(bd.ii_g), ptr(bd.chunk_len),
                        ptr(bd.lhs_g), ptr(bd.rhs_g), ptr(bd.lb0), ptr(bd.ub0),
                        ptr(bd.tile_inst), ptr(bd.chunks), ptr(act), ptr(bacc[0]),
                        ptr(bacc[1]), tb * rb, rb, kb, bprep.max_chunk_len, batch.size,
                        bprep.n_pad, cfg.int_eps, inf, stream())

                event_ms(torch, launch, lambda: sentinels(bacc))
                if not (torch.equal(bacc[0], want[0]) and torch.equal(bacc[1], want[1])):
                    raise SystemExit(f"round_variants: {label} variant {v} disagrees with the "
                                     "plain version")
                cases.append((label, "batched", v, launch, lambda: sentinels(bacc)))
        fills["fused bucket"] = statistics.median(event_ms(torch, lambda: fill(bd.lb0))
                                                  for _ in range(args.reps))

    # #14's scatter on pbw at tile width 8 with a 128-node pool.
    if 14 in only:
        pbw = getattr(td, cs.WIDE_SPECS[1][1])(**cs.WIDE_SPECS[1][2])
        prep8 = rt.prepare_block_ell(pbw, tile_width=cs.SOLVER_TILE_WIDTH, device="cuda")
        part = prep8.slab_partition()
        lbw, ubw = ops._node_planes(prep8, *cs.node_pool(np, rt, pbw, cs.POOL, seed=3))
        nacc = accumulator_planes(lbw)
        tn, rn, kn = part.val.shape
        print(f"pbw K = {kn}: copy tiles {(tn, rn, kn)}, {int((part.val != 0).sum())} kept "
              f"nonzeros, pool {tuple(lbw.shape)}", flush=True)
        for n_act in (0, 8, 32, cs.POOL):
            act = torch.zeros(cs.POOL, dtype=torch.bool, device="cuda")
            if n_act:
                act[:: cs.POOL // n_act] = True
            partials = tref.node_slab_partials_ref(
                part.a_val, part.a_col_s, part.a_run_start, part.a_run_len, part.a_run_slab, act,
                lbw, ubw, part.slab, part.a_max_run_len)
            strs = tref.straddle_tables(part, *partials)
            want = tref.node_slab_scatter_ref(
                part.val, part.col_s, part.ii_g, part.row_done, *strs, part.lhs_g, part.rhs_g,
                part.run_start, part.run_slab, act, lbw, ubw, part.slab, cfg.int_eps)
            label = f"#14 scatter pbw pool, {n_act} of {cs.POOL} active"
            for v in NODE_SLAB_VARIANTS:
                def launch(v=v, act=act, strs=strs):
                    return lib.node_slab_variant(
                        v, ptr(part.val), ptr(part.col_s), ptr(part.ii_g), ptr(part.chunk_len),
                        ptr(part.row_done), *map(ptr, strs), ptr(part.lhs_g), ptr(part.rhs_g),
                        ptr(part.run_start), ptr(part.run_slab), ptr(part.tile_slab), ptr(act),
                        ptr(lbw), ptr(ubw), ptr(nacc[0]), ptr(nacc[1]), part.run_start.numel(),
                        tn * rn, rn, kn, part.max_chunk_len, cs.POOL, lbw.shape[1], part.slab,
                        cfg.int_eps, inf, stream())

                event_ms(torch, launch, lambda: sentinels(nacc))
                if not (torch.equal(nacc[0], want[0]) and torch.equal(nacc[1], want[1])):
                    raise SystemExit(f"round_variants: {label} variant {v} disagrees with the "
                                     "plain version")
                cases.append((label, "node_slab", v, launch, lambda: sentinels(nacc)))
        fills["pbw pool"] = statistics.median(event_ms(torch, lambda: fill(lbw))
                                              for _ in range(args.reps))

    for _ in range(args.reps):
        for label, kind, v, launch, reset in cases:
            try:
                ms = event_ms(torch, launch, reset)
            except Exception:
                print(f"round_variants: {label} variant {v} failed", flush=True)
                raise
            times.setdefault((label, kind, v), []).append(ms)
    names = {"node": NODE_VARIANTS, "slab": SLAB_VARIANTS, "merge": MERGE_VARIANTS,
             "batched": BATCHED_VARIANTS, "node_slab": NODE_SLAB_VARIANTS,
             "fused": FUSED_VARIANTS}
    rows = []
    for (label, kind, v), ms in times.items():
        row = dict(case=label, variant=v, what=names[kind][v], ms=statistics.median(ms))
        rows.append(row)
        print(f"{label} variant {v}: {row['ms']:.4f} ms  {row['what']}", flush=True)
    print("sentinel planes the wrappers no longer fill per launch (a pair of the case's "
          "planes): " + "; ".join(f"{n} {ms:.4f} ms" for n, ms in fills.items()), flush=True)
    print(json.dumps({"gpu": smi, "variants": rows, "fill_ms": fills}), flush=True)
    print(f"gpu: {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
