#!/usr/bin/env python3
"""Time variants of kernels D (the single instance's fused round), #8 (the
packed batch's round), #10 (the node round) and #13 (the node slab
partials), of the scatters of #12 and #14 (the slab rounds) and of the
batched merges #9 and #15, to see which design step of their redesign pays
(no profiler that counts stalls runs on the card).

    python3 tools/round_variants.py [--reps 20] [--only 13,15]

Run from the root of a checkout on a machine with a CUDA card and nvcc.  It
builds ``tools/round_variants.cu`` (the kernels before the redesign, and the
redesigned ones one step at a time: bounds gathered once and held, integer
atomics, chunks stopped at their length, short-row chunks packed several to
a warp, node- or instance-major order over the active planes only or the
window from the tile maps, a register cap, a chunk loaded once for several
nodes)
into ``src/repro_torch/build/round_variants/``, makes the instances of
``chip_smoke.py`` -- ``pb``, ``banded``, ``bandw`` and ``pbw`` (one
instance each at K = 128, the explicit fused engine's tiles at n_pad
150,016) for D, ``pbf`` at tile width 8 with its 128-node pool for #10
and #9 (0, 8 and 128 nodes active), ``bandw`` and ``pbw`` (one plane each,
their default slab partitions) for #12 and #15, the fused batch bucket
(``pb``, ``pbf``, ``banded`` and a second ``banded``) with 0, 2 and 4
instances active for #8, ``pbw`` at tile width 8 with a 128-node pool (0,
1, 2, 4, 8, 32 and 128 nodes active) for #13, #14 and #15, and for #13
also the active masks of its launches in ``chip_smoke.py``'s ``pbw``
search, logged from a run of that search and printed -- holds every
variant against the plain version of its kernel (bitwise, as values), and
prints each variant's median time over ``--reps`` launches (CUDA events
around the launch, queued behind a sleep on the card, the variants taken in
turn within each repetition; the accumulator planes at the sentinels before
each scatter, the merges' inputs restored and the L2 evicted before each
merge; #13 cold, its outputs filled first, which evicts the L2, and warm,
the same launch or sequence run untimed just before), the time of the two
``torch.full`` sentinel planes that the wrappers no longer fill per
launch, and the card's name and power limit.
``--only`` picks the kernels (of 1 (D), 8, 9, 10, 12, 13, 14, 15).
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
    3: "#15 handing them back, (column block, row) grid (the port's before the walk)",
    4: "#9 on the active-only walk, a flag store per thread that tightens",
    5: "as 4, one flag store per warp",
    6: "as 5, an item of 2 column blocks, a thread's columns loaded before any merge",
    7: "as 5, an item of 4 column blocks, a thread's columns loaded before any merge (the "
       "port's #9)",
    8: "as 5, an item of 8 column blocks, a thread's columns loaded before any merge",
    9: "a (column block, group of 32 rows) grid, a warp merging its column of each active row",
    10: "#15 on the active-only walk, one column a thread, a window flag store per warp",
    11: "#15 on the merge body it shares with #9, on the walk: four columns a thread, loaded "
        "before any merge, a flag store per warp and column stride (the port's past 16 rows)",
    12: "as 11 on a (column block, row) grid, four columns a thread",
    13: "#9 on the shared body, (column block, row) grid, four columns a thread (the port's #9 "
        "for at most 16 rows)",
    14: "#9 on the shared body, on the walk (the port's #9 past 16 rows)",
    15: "#15 on the shared body's grid, one column a thread (the port's #15 for at most 16 rows)",
    16: "#9 on the shared body's grid, one column a thread",
}
PARTIALS_VARIANTS = {
    0: "before the redesign (warp ballot order, search over the runs, every slot, K's group)",
    1: "node-major on the active-only walk, window from a_tile_slab, chunk_sums stopped at the "
       "copy length, the longest copy's group (the port's #13)",
    2: "chunk once: a warp's chunks loaded once for a group of 4 active nodes, their "
       "gathers issued before any sum",
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
                          capture_output=True, text=True)
    if done.returncode:
        raise SystemExit(f"round_variants: nvcc failed:\n{done.stderr[-4000:]}")
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
    lib.partials_variant.argtypes = [I32] + [P] * 13 + [I32, I64, I32, I32, I32, I64, I64, I64,
                                                        F64, P]
    for fn in (lib.node_variant, lib.slab_variant, lib.merge_variant, lib.batched_variant,
               lib.node_slab_variant, lib.fused_variant, lib.partials_variant):
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
    ap.add_argument("--only", default="1,8,9,10,12,13,14,15")
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

    def row_flags(v, flags):
        """The flags a merge variant writes: the int32 ``flags``, or for the
        port's body under #9 (13, 14, 16) a bool per row, which ``flags``'
        first bytes hold (zeroed with it)."""
        return flags.view(torch.bool)[: flags.numel()] if v in (13, 14, 16) else flags

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

            for v in (0, 1, 4, 5, 6, 7, 8, 9, 13, 14, 16) if 9 in only else (0, 1):
                def launch(v=v, act=act, planes=planes, flags=flags):
                    return lib.merge_variant(v, *map(ptr, planes), ptr(act),
                                             ptr(row_flags(v, flags)), cs.POOL, n_pad, n_pad, eps,
                                             inf, 0.0, stream())

                label = f"#9 pbf pool, {n_act} of {cs.POOL} active"
                event_ms(torch, launch, restore)
                handed = v == 0 or bool((planes[2][act] == -inf).all()
                                        and (planes[3][act] == inf).all())
                if not (torch.equal(planes[0], want_m[0]) and torch.equal(planes[1], want_m[1])
                        and torch.equal(row_flags(v, flags) != 0, want_m[2]) and handed
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

            def restore(planes=planes, best=best, flags=flags, flush=flush, bd=bd):
                for x, y in zip(planes, (bd.lb0, bd.ub0, *best)):
                    x.copy_(y)
                flags.zero_()
                flush.zero_()

            label = f"#9 fused bucket, {n_act} of {bsz} active"
            for v in (1, 5, 6, 7, 9, 13, 14, 16):
                # Bound now: later cases rebind bsz and width.
                def launch(v=v, act=act, planes=planes, flags=flags, bsz=bsz, width=width):
                    return lib.merge_variant(v, *map(ptr, planes), ptr(act),
                                             ptr(row_flags(v, flags)), bsz, width, width, eps,
                                             inf, 0.0, stream())

                event_ms(torch, launch, restore)
                if not (torch.equal(planes[0], want_m[0])
                        and torch.equal(row_flags(v, flags) != 0, want_m[2])):
                    raise SystemExit(f"round_variants: {label} variant {v} disagrees with the "
                                     "plain version")
                cases.append((label, "merge", v, launch, restore))

    def merge_cases(label, variants, planes, pristine, act, flags, bsz, width, slab, want_m):
        """#15's variants on ``planes`` (bounds, candidates), each held
        against ``want_m`` (bounds and window flags) and, but for the
        variant that only reads, handing the active rows back."""
        flush = torch.empty(64 << 17, dtype=torch.float64, device="cuda")

        def restore():
            for x, y in zip(planes, pristine):
                x.copy_(y)
            flags.zero_()
            flush.zero_()

        for v in variants:
            def launch(v=v):
                return lib.merge_variant(v, *map(ptr, planes), ptr(act), ptr(flags), bsz, width,
                                         slab, eps, inf, 0.0, stream())

            event_ms(torch, launch, restore)
            handed = v == 2 or bool((planes[2][act] == -inf).all()
                                    and (planes[3][act] == inf).all())
            if not (torch.equal(planes[0], want_m[0]) and torch.equal(planes[1], want_m[1])
                    and torch.equal(flags.reshape(want_m[2].shape) != 0, want_m[2] != 0)
                    and handed):
                raise SystemExit(f"round_variants: {label} variant {v} disagrees with the "
                                 "plain version")
            cases.append((label, "merge", v, launch, restore))

    # #12's scatter and #15 on bandw and pbw, one plane each.
    if 12 in only or 15 in only:
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
            for v in SLAB_VARIANTS if 12 in only else ():
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
            if 15 in only:
                want_m = tref.apply_updates_slab_ref(lb, ub, *want, one, part.slab, eps)
                merge_cases(f"#15 {name}, one plane", (2, 3, 10, 11, 12, 15),
                            [lb.clone(), ub.clone(), want[0].clone(), want[1].clone()],
                            (lb, ub, *want), one,
                            torch.zeros(part.n_slabs, dtype=torch.int32, device="cuda"), 1,
                            width, part.slab, want_m)
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

    def search_cases(pbw, part, lbw, ubw, partials_launch):
        """#13's variants over the masks of its launches in ``chip_smoke.py``'s
        pbw search (phase 8), in the search's order on the pool's planes:
        the whole sequence timed once the same sequence has run untimed
        (warm: the L2 as the search leaves it) and once the outputs have
        been filled (cold: the L2 evicted)."""
        from repro_torch.kernels import prop_round

        masks, kernel = [], prop_round.node_slab_partials_tiles

        def logged(*a, **kw):
            masks.append(a[5].clone())  # the (B,) active mask
            return kernel(*a, **kw)

        # The engine calls the wrapper through the module, whose launch
        # counter the wrapper bumps by its module-level name.
        logged.launches = 0
        prop_round.node_slab_partials_tiles = logged
        try:
            res = rt.solve(pbw, cs.objective(np, pbw.n), device="cuda", **cs.WIDE_SEARCH)
        finally:
            prop_round.node_slab_partials_tiles = kernel
        print(f"#13 in the pbw search {(res.status, res.nodes_expanded, res.levels)}: active "
              f"nodes at each launch {[int(m.sum()) for m in masks]}", flush=True)
        ta, ra, _ = part.a_val.shape
        outs = [torch.empty((cs.POOL, ta, ra), dtype=d, device="cuda")
                for d in (torch.float64, torch.int32, torch.float64, torch.int32)]
        spoil = lambda: [o.fill_(-7) for o in outs]
        wants = [tref.node_slab_partials_ref(
            part.a_val, part.a_col_s, part.a_run_start, part.a_run_len, part.a_run_slab, m,
            lbw, ubw, part.slab, part.a_max_run_len) for m in masks]
        label = f"#13 pbw search's {len(masks)} launches"
        for v in PARTIALS_VARIANTS:
            for m, want in zip(masks, wants):
                spoil()
                if partials_launch(v, m, outs) or not all(
                        torch.equal(o[m], w[m]) for o, w in zip(outs, want)):
                    raise SystemExit(f"round_variants: {label} variant {v} disagrees with the "
                                     "plain version")

            def sequence(v=v):
                return next((e for e in (partials_launch(v, m, outs) for m in masks) if e), 0)

            cases.append((f"{label}, warm", "partials", v, sequence, sequence))
            cases.append((f"{label}, cold", "partials", v, sequence, spoil))

    # #13, #14's scatter and #15 on pbw at tile width 8 with a 128-node pool.
    if only & {13, 14, 15}:
        pbw = getattr(td, cs.WIDE_SPECS[1][1])(**cs.WIDE_SPECS[1][2])
        prep8 = rt.prepare_block_ell(pbw, tile_width=cs.SOLVER_TILE_WIDTH, device="cuda")
        part = prep8.slab_partition()
        lbw, ubw = ops._node_planes(prep8, *cs.node_pool(np, rt, pbw, cs.POOL, seed=3))
        nacc = accumulator_planes(lbw)
        tn, rn, kn = part.val.shape
        print(f"pbw K = {kn}: copy tiles {(tn, rn, kn)}, {int((part.val != 0).sum())} kept "
              f"nonzeros, pool {tuple(lbw.shape)}", flush=True)

        def partials_launch(v, act, outs):
            ta, ra, ka = part.a_val.shape
            return lib.partials_variant(
                v, ptr(part.a_val), ptr(part.a_col_s), ptr(part.a_chunk_len),
                ptr(part.a_run_start), ptr(part.a_run_slab), ptr(part.a_tile_slab), ptr(act),
                ptr(lbw), ptr(ubw), *map(ptr, outs), part.a_run_start.numel(), ta * ra, ra, ka,
                part.a_max_chunk_len, cs.POOL, lbw.shape[1], part.slab, inf, stream())

        if 13 in only:
            search_cases(pbw, part, lbw, ubw, partials_launch)
        for n_act in (0, 1, 2, 4, 8, 32, cs.POOL):
            act = torch.zeros(cs.POOL, dtype=torch.bool, device="cuda")
            if n_act:
                act[:: cs.POOL // n_act] = True
            partials = tref.node_slab_partials_ref(
                part.a_val, part.a_col_s, part.a_run_start, part.a_run_len, part.a_run_slab, act,
                lbw, ubw, part.slab, part.a_max_run_len)
            ta, ra, ka = part.a_val.shape
            outs = [torch.empty((cs.POOL, ta, ra), dtype=d, device="cuda")
                    for d in (torch.float64, torch.int32, torch.float64, torch.int32)]

            def spoil(outs=outs):
                """Garbage in every output, so a variant must write the active rows."""
                for o in outs:
                    o.fill_(-7)

            label = f"#13 pbw pool, {n_act} of {cs.POOL} active"
            for v in PARTIALS_VARIANTS if 13 in only else ():
                def launch(v=v, act=act, outs=outs):
                    return partials_launch(v, act, outs)

                event_ms(torch, launch, spoil)
                if not all(torch.equal(o[act], w[act]) for o, w in zip(outs, partials)):
                    raise SystemExit(f"round_variants: {label} variant {v} disagrees with the "
                                     "plain version")
                cases.append((label, "partials", v, launch, spoil))
                # Warm: the same launch just before, untimed, leaves the L2
                # as a run of launches at this count does.
                cases.append((f"{label}, warm", "partials", v, launch, launch))
            if not only & {14, 15}:
                continue
            strs = tref.straddle_tables(part, *partials)
            want = tref.node_slab_scatter_ref(
                part.val, part.col_s, part.ii_g, part.row_done, *strs, part.lhs_g, part.rhs_g,
                part.run_start, part.run_slab, act, lbw, ubw, part.slab, cfg.int_eps)
            if 15 in only:
                want_m = tref.apply_updates_slab_ref(lbw, ubw, *want, act, part.slab, eps)
                merge_cases(f"#15 pbw pool, {n_act} of {cs.POOL} active", (3, 10, 11, 12, 15),
                            [lbw.clone(), ubw.clone(), want[0].clone(), want[1].clone()],
                            (lbw, ubw, *want), act,
                            torch.zeros((cs.POOL, part.n_slabs), dtype=torch.int32,
                                        device="cuda"), cs.POOL, lbw.shape[1], part.slab, want_m)
            label = f"#14 scatter pbw pool, {n_act} of {cs.POOL} active"
            for v in NODE_SLAB_VARIANTS if 14 in only else ():
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
             "fused": FUSED_VARIANTS, "partials": PARTIALS_VARIANTS}
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
