#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Run from the root of a checkout.  It imports ``src/repro_torch`` (torch and
numpy only, nothing of JAX) and, on one CUDA card:

  1. prints the card's name and power limit, builds the CUDA kernels of
     ``src/repro_torch/csrc/prop_round.cu`` and ``slab_round.cu`` from
     source (one ``nvcc`` per file, in parallel) and prints the build time
     and the compilers' register report;
  2. generates three instances at n = 60,000 columns, 150,000 rows (the
     paper's Set-5 size): ``pb`` (pseudo-boolean, exact arithmetic, rows in
     one chunk), ``banded`` (rows in one chunk) and ``mixed`` (MIPLIB-like,
     rows spanning chunks);
  3. holds each kernel against its plain PyTorch version on the card, at the
     shapes the main path gives it, and times both with CUDA events: the
     kernel's own launch, the wrapper call as a whole, and the plain
     version;
  4. resets the launch counters, runs ``propagate_block_ell`` with its
     defaults on the three instances (the main path), reads the counters,
     and holds each result against the plain-version path
     (``use_kernels=False``) and the plain-PyTorch ``propagate``, all on the
     card: rounds, converged and infeasible exactly; bounds bitwise against
     the plain-version path (the long-row combine of ``mixed`` sums in one
     fixed order) and between two runs of the kernel path, under
     ``bounds_equal`` against ``propagate``, which sums in another order; on
     ``pb`` also bitwise against ``propagate`` over the rounds whose sums are
     exact; then one warm-started branch-and-bound node on ``pb``;
  5. prints per-round times, host syncs per fixed point and the card's idle
     share per fixed point;
  6. (phase 5) builds ``pbf``, a pseudo-boolean instance at the same size
     that is feasible at the root, and holds the node-batch kernels against
     their plain versions at the solver's shapes: the node round (#10) and
     the batched merge (#9) on its (18,750, 8, 8) tiles over a (128, 60,032)
     pool of warm-started node bounds with 0, 8 and 128 active rows, and the
     node objective (#16) on the same pool, all bitwise, timed;
  7. (phase 6) runs ``propagate_nodes`` on 64 ``pbf`` nodes, 16 ``banded``
     nodes and 4 ``mixed`` nodes (the multi-chunk branch) and holds every
     node bitwise against its own single-instance ``propagate_block_ell``
     and against the plain-version path;
  8. (phase 7) runs ``solve`` on the small instances whose reference results
     are hard-coded below and on ``pbf`` at full width (128 pool slots),
     holds the search against the reference's counts and the kernel path
     against the plain path (result and final pool), and prints levels,
     nodes, host syncs, flag reads, ms per level, nodes per second and the
     idle share; then the same search at tile width 4, where rows span two
     chunks and each round runs A', combine, E and F per pool slot, held
     against the tile-width-8 search (result and final pool) and timed;
  9. (phase 8) past 2^16 columns, where ``scatter="auto"`` takes the
     column-slab partitioned engine: builds ``bandw`` and ``pbw``
     (n = m = 150,000; n_pad 150,016, three slabs of 50,048 columns) and
     their slab partitions (build seconds printed); holds kernels #11 and
     #12 (with #15's window merge) against their plain versions on both
     partitions at K = 128, kernel D + F at n_pad 150,016, and #13, #14 and
     #15 on pbw's K = 8 partition over a (128, 150,016) pool with 0, 8 and
     128 active rows, all bitwise, timed; runs ``propagate_block_ell`` with
     its defaults on both (30 and 6 rounds, as the reference) against the
     plain path and a second run (bitwise) and the explicit fused engine
     (``bounds_equal``, differing entries counted), with ms per round for
     both engines, host syncs and the idle share; ``propagate_nodes`` on 16
     branched pbw nodes, each bitwise against its single-instance run and
     the plain path; ``solve`` on pbw (128 slots, 8 levels) against the
     reference's counts, the plain path and the same search through the
     fused node round (#10 + #9), same result and final pool;
 10. (phase 9) runs ``propagate_batch`` with its defaults on three buckets:
     ``pb``, ``pbf``, ``banded`` and a second banded instance at n_pad
     60,032 (kernel #8 then #9), ``mixed`` and a second mixed instance
     (A', the combine and E over the flat stream, then #9), ``bandw`` and
     ``pbw`` past 2^16 (the partitioned round with two planes); holds #8
     against its plain version at the fused bucket's shapes with 0, 2 and
     4 instances active (timed) and every instance bitwise against its own
     ``propagate_block_ell`` and the plain path, plus one ``bounds=`` warm
     start; prints batch and summed single-instance fixed-point times, flag
     reads and the idle share;
 11. (phase 10) serves 24 requests (12 pseudo-boolean at n = 60,000 and 12
     banded at n = 40,000, 30,000 to 90,000 rows) through
     ``PropagationService.from_problems(slots=4, size_classes=2,
     rounds_per_step=8)`` and 4 mixed requests through a 2-slot service;
     holds every ticket bitwise against a one-shot ``propagate_batch`` on
     the kernels and on the plain versions; prints instances/s at
     saturation (pre-packed, all submitted, then drained) against
     sequential ``propagate_block_ell``, latency percentiles, pumps, flag
     reads per pump, the idle share and per-bucket stats;
 12. prints a ``kernels`` JSON line, and last
     ``{"ok": true, "device": {...}}``.

Each path runs with the launch counters at zero just before it and read just
after; every kernel must have been launched by the main-path runs.

Any failed check raises, so the exit code is not 0 and no result is printed.
Without a CUDA device it exits with code 2 before doing anything.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and dense float64 rate
# outside the tensor cores, the rate of this f64 vector arithmetic.
HBM_BYTES_PER_S = 3.35e12
F64_FLOPS = 34e12

# The three smoke instances: (name, generator, kwargs).
SPECS = [
    ("pb", "make_pseudo_boolean", dict(n=60_000, m=150_000, seed=0)),
    ("banded", "make_banded", dict(n=60_000, m=150_000, row_nnz=24, band=7_500, seed=0)),
    ("mixed", "make_mixed", dict(m=150_000, n=60_000, seed=0, density=0.0005)),
]
# Rounds the JAX reference's pure-jnp propagate takes on these instances
# (on a CPU); pb must also end infeasible.
REFERENCE_ROUNDS = {"pb": 33, "banded": 6, "mixed": 16}
# Rounds of pb over which every sum stays exact (verified at run time).
PB_EXACT_ROUNDS = 24

# pbf: the pseudo-boolean family at the same size with fewer unit clauses,
# feasible at the root (pb is not), so a search on it goes deeper than one
# level.  The solver's default tile width is 8.
PBF = dict(n=60_000, m=150_000, seed=0, unit_frac=0.002)
PBF_ROUNDS = 9  # the reference's propagate on pbf: 9 rounds, feasible
SOLVER_TILE_WIDTH = 8
MULTI_CHUNK_TILE_WIDTH = 4  # pbf's rows of 5-8 nonzeros span two chunks
POOL = 128

# The reference's repro.core.solve on the small instances (on a CPU, tile
# width 8, node_cap 256, the objective c_j = (j+1)(-1 if j % 3 == 0 else 1)):
# status, objective, expanded, created, leaves, pruned bound, pruned
# infeasible, levels.
SOLVE_REFERENCE = [
    ("make_pseudo_boolean", dict(n=12, m=16, seed=0), "most_fractional",
     ("optimal", -2.0, 29, 59, 16, 14, 0, 7)),
    ("make_pseudo_boolean", dict(n=12, m=16, seed=0), "pseudo_cost",
     ("optimal", -2.0, 27, 55, 15, 13, 0, 7)),
    ("make_random_mip", dict(n=9, m=12, seed=1), "most_fractional",
     ("optimal", 10.0, 4, 9, 4, 1, 0, 4)),
    ("make_random_mip", dict(n=9, m=12, seed=1), "pseudo_cost",
     ("optimal", 10.0, 4, 9, 4, 1, 0, 4)),
    ("make_random_mip", dict(n=9, m=12, seed=0), "most_fractional",
     ("infeasible", 1e20, 0, 1, 0, 0, 1, 1)),
    ("make_random_mip", dict(n=9, m=12, seed=0), "pseudo_cost",
     ("infeasible", 1e20, 0, 1, 0, 0, 1, 1)),
    ("make_pseudo_boolean", dict(n=40, m=56, seed=7), "most_fractional",
     ("pool_exhausted", 1e20, 255, 511, 0, 0, 0, 9)),
    ("make_pseudo_boolean", dict(n=40, m=56, seed=7), "pseudo_cost",
     ("pool_exhausted", 1e20, 255, 511, 0, 0, 0, 9)),
]
# The full-width search on pbf and the reference's result for it:
# status, expanded, created, levels, host syncs.
FULL_SEARCH = dict(node_cap=POOL, expand_width=4, max_levels=16, sync_every=8)
FULL_REFERENCE = ("level_limit", 59, 119, 16, 2)

# Phase 8, past 2^16 columns, where scatter="auto" takes the partitioned
# engine: bandw is banded at 2.5 times the columns (rows rarely cross a slab
# edge: the engine's intended case), pbw is pbf at 2.5 times the columns
# (rows draw columns from the whole range, so nearly every row straddles
# slabs: its worst case; pure-integer, so solve runs on it).
WIDE_SPECS = [
    ("bandw", "make_banded", dict(n=150_000, m=150_000, row_nnz=24, band=7_500, seed=0)),
    ("pbw", "make_pseudo_boolean", dict(n=150_000, m=150_000, seed=0, unit_frac=0.002)),
]
# The reference's propagate_block_ell (its partitioned engine, on a CPU):
# rounds; both converge feasible.
WIDE_ROUNDS = {"bandw": 30, "pbw": 6}
WIDE_BRANCHED = 4  # 2**4 = 16 pbw nodes
# The reference's repro.core.solve on pbw with this call (on a CPU, tile
# width 8): status, expanded, created, levels, host syncs.
WIDE_SEARCH = dict(node_cap=POOL, expand_width=4, max_levels=8, sync_every=4)
WIDE_REFERENCE = ("level_limit", 27, 55, 8, 2)

# Phase 9: the batched engine's three buckets (instances of earlier phases
# plus a second banded and a second mixed instance of the same size).
BANDED1 = dict(n=60_000, m=150_000, row_nnz=24, band=7_500, seed=1)
MIXED1 = dict(m=150_000, n=60_000, seed=1, density=0.0005)
# Phase 10: the service's request streams (the paper's Set-3/Set-4 scale):
# rows drawn from [30,000, 90,000) by default_rng(0), 12 + 12 requests in two
# col_pad classes split into size classes, and 4 mixed requests whose long
# rows span chunks.  The reference bench's service settings.
SERVICE_REQUESTS = 12
SERVICE_ROWS = (30_000, 90_000)
SERVICE_SLOTS = 4
SERVICE_SIZE_CLASSES = 2
SERVICE_ROUNDS_PER_STEP = 8
SERVICE_MIXED = 4
SERVICE_TIMED_RUNS = 2

SOURCE = "src/repro_torch/csrc/prop_round.cu"
SLAB_SOURCE = "src/repro_torch/csrc/slab_round.cu"
REPLACES = {
    "fused_scatter_round_tiles": "src/repro/kernels/prop_round.py:580",
    "activities_gather_tiles": "src/repro/kernels/prop_round.py:269",
    "candidates_scatter_tiles": "src/repro/kernels/prop_round.py:651",
    "apply_updates_tiles": "src/repro/kernels/prop_round.py:721",
    # Not a Pallas kernel: the XLA segment_sum of the long-row combine.
    "combine_chunk_partials_tiles": "src/repro/kernels/ops.py:821",
    "node_fused_scatter_round_tiles": "src/repro/kernels/prop_round.py:964",
    "apply_updates_batch_tiles": "src/repro/kernels/prop_round.py:1666",
    "node_objective_tiles": "src/repro/kernels/prop_round.py:1730",
    "batched_slab_partials_tiles": "src/repro/kernels/prop_round.py:1129",
    "batched_slab_round_tiles": "src/repro/kernels/prop_round.py:1258",
    "node_slab_partials_tiles": "src/repro/kernels/prop_round.py:1383",
    "node_slab_round_tiles": "src/repro/kernels/prop_round.py:1498",
    "apply_updates_slab_tiles": "src/repro/kernels/prop_round.py:1595",
    "batched_fused_scatter_round_tiles": "src/repro/kernels/prop_round.py:816",
}
# The C entry point that launches each wrapper's kernel (the slab rounds
# launch two: their scatter, then #15's window merge).
SYMBOL = {
    "fused_scatter_round_tiles": "fused_scatter_round",
    "activities_gather_tiles": "activities_gather",
    "candidates_scatter_tiles": "candidates_scatter",
    "apply_updates_tiles": "apply_updates",
    "combine_chunk_partials_tiles": "combine_chunk_partials",
    "node_fused_scatter_round_tiles": "node_fused_scatter_round",
    "apply_updates_batch_tiles": "apply_updates_batch",
    "node_objective_tiles": "node_objective",
    "batched_slab_partials_tiles": "slab_partials",
    "batched_slab_round_tiles": "slab_scatter",
    "node_slab_partials_tiles": "node_slab_partials",
    "node_slab_round_tiles": "node_slab_scatter",
    "apply_updates_slab_tiles": "slab_merge",
    "batched_fused_scatter_round_tiles": "batched_fused_scatter_round",
}
# Nominal float64 operations per real nonzero (products, sums, residual
# subtractions, divisions, rounding) -- the compute side of each bound.
OPS_PER_NNZ = {
    "fused_scatter_round_tiles": 16,
    "activities_gather_tiles": 4,
    "candidates_scatter_tiles": 12,
    "apply_updates_tiles": 0,
    "combine_chunk_partials_tiles": 0,  # four adds per chunk: bytes bound it
}


def log(*args):
    print(*args, flush=True)


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def time_ms(torch, fn, reps: int = 10, trials: int = 5) -> float:
    """Median over ``trials`` of the mean CUDA-event time of ``reps`` calls."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / reps)
    return statistics.median(out)


def device_items(torch, fn) -> list[tuple[str, float]]:
    """``(name, microseconds)`` of every device item (kernel, memset, copy)
    that ``torch.profiler`` records over one call of ``fn``.  Only the
    device's own events count: a CPU op's device time repeats theirs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == DeviceType.CUDA]


class EventTimedLib:
    """Stands in for the kernel library while a kernel is timed: brackets
    each C entry call with CUDA events on the current stream, so an event
    pair holds the kernel's own device time, not the wrapper's fills."""

    def __init__(self, torch, lib):
        self.torch, self.lib, self.pairs = torch, lib, []

    def __getattr__(self, name):
        entry = getattr(self.lib, name)
        if name not in SYMBOL.values():
            return entry

        def timed(*args):
            start = self.torch.cuda.Event(enable_timing=True)
            end = self.torch.cuda.Event(enable_timing=True)
            start.record()
            err = entry(*args)
            end.record()
            self.pairs.append((start, end))
            return err

        return timed


def kernel_ms(torch, build, fn, reps: int = 20, reset=None, launches: int = 1) -> float:
    """Median device time of the kernel launches in each of ``reps`` calls
    of the wrapper call ``fn`` (``launches`` per call, summed: the slab
    rounds launch their scatter and the window merge).  Each call is queued
    behind a sleep on the card, so no host time falls between the events
    around a launch; ``reset`` (untimed) runs before each call."""
    real = build.lib
    timed = EventTimedLib(torch, real())
    build.lib = lambda: timed
    try:
        for _ in range(reps):
            if reset is not None:
                reset()
            torch.cuda._sleep(1_000_000)
            fn()
        torch.cuda.synchronize()
    finally:
        build.lib = real
    if len(timed.pairs) != reps * launches:
        fail(f"timed {len(timed.pairs)} launches, expected {reps * launches}")
    ms = [start.elapsed_time(end) for start, end in timed.pairs]
    return statistics.median(sum(ms[i : i + launches]) for i in range(0, len(ms), launches))


def fresh_inputs(torch, pairs):
    """A ``reset`` for :func:`kernel_ms` of an in-place merge: copy each
    pristine tensor over its scratch copy, so every timed launch does the
    stores of this run's inputs, then evict the L2 (64 MiB of zeros) so the
    launch reads from device memory, as its bound assumes."""
    flush = torch.empty(64 << 17, dtype=torch.float64, device=pairs[0][0].device)

    def reset():
        for scratch, pristine in pairs:
            scratch.copy_(pristine)
        flush.zero_()

    return reset


def merge_bytes(torch, bnd, lb, ub, best_l, best_u, eps, active=None) -> dict:
    """Bytes an in-place merge must move on these inputs: the bounds and
    candidates of every active column read, and 8 B for each entry that
    tightens (most store nothing)."""
    take_l, take_u = bnd.improved_lb(best_l, lb, eps), bnd.improved_ub(best_u, ub, eps)
    if active is not None:
        take_l, take_u = take_l & active[:, None], take_u & active[:, None]
        cols = int(active.sum()) * lb.shape[-1]
    else:
        cols = lb.shape[-1]
    return dict(bounds=16 * cols, best=16 * cols,
                stores=8 * int(take_l.sum() + take_u.sum()))


def max_abs_err(torch, got, want) -> float:
    """Largest |kernel - plain| over a tuple of outputs, after requiring that
    they are equal as values: the plain versions sum in the kernels' order
    (``ref.warp_order_sum``), so the two round alike on any data."""
    err = 0.0
    for g, w in zip(got, want):
        if g.dtype != w.dtype or g.shape != w.shape:
            fail(f"output mismatch: {g.dtype}{tuple(g.shape)} vs {w.dtype}{tuple(w.shape)}")
        if not torch.equal(g, w):
            d = (g.double() - w.double()).abs().max().item()
            fail(f"kernel disagrees with its plain version: max abs diff {d}")
        err = max(err, (g.double() - w.double()).abs().max().item())
    return err


def bound(nbytes: int, ops: float) -> tuple[float, str]:
    """The least time for ``nbytes`` of device memory traffic and ``ops``
    float64 operations, and which of the two sets it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F64_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def needed_bytes(kname: str, prep, nnz: int) -> dict:
    """Bytes the kernel's function must move, each input read once and each
    output written once: ``val`` for every padded slot (its zeros mark the
    padding), ``col`` and the integrality marks for each real nonzero only,
    the per-chunk row data, and the (n_pad,) vectors."""
    t, r, k = prep.d.val.shape
    slots, chunks, vec = t * r * k, t * r, 8 * prep.n_pad
    if kname == "fused_scatter_round_tiles":
        return dict(val=8 * slots, col=4 * nnz, is_int=4 * nnz, rows=16 * chunks,
                    bounds=2 * vec, out=2 * vec)
    if kname == "activities_gather_tiles":
        return dict(val=8 * slots, col=4 * nnz, bounds=2 * vec, out=24 * chunks)
    if kname == "candidates_scatter_tiles":
        return dict(val=8 * slots, col=4 * nnz, is_int=4 * nnz, rows=40 * chunks,
                    bounds=2 * vec, out=2 * vec)
    if kname == "combine_chunk_partials_tiles":
        return dict(partials=24 * chunks, row_start=8 * (prep.m + 2), out=24 * chunks)
    raise KeyError(kname)


def check_kernels(torch, tk, tref, ops, build, name, p, prep, lb, ub, timed):
    """Each kernel of the instance's branch against its plain version on the
    card, on the tiles of ``prep`` and the padded bounds ``lb``/``ub``;
    ``timed`` also times both.  Returns {kernel: row of measurements}."""
    d = prep.d
    n_pad, cfg = prep.n_pad, ops.DEFAULT_CONFIG
    nnz = int((d.val != 0).sum().item())  # real nonzeros in the tiles
    rows = {}

    def row(kname, got, want, fn_k, fn_p, moved=None, reset=None):
        r = dict(instance=name, max_abs_err=max_abs_err(torch, got, want))
        if timed:
            moved = moved or needed_bytes(kname, prep, nnz)
            b_ms, b_by = bound(sum(moved.values()), OPS_PER_NNZ[kname] * nnz)
            r.update(ms=kernel_ms(torch, build, fn_k, reset=reset),
                     wrapper_ms=time_ms(torch, fn_k),
                     plain_ms=time_ms(torch, fn_p), bound_ms=b_ms, bound_by=b_by, bytes=moved)
        rows[kname] = r

    if prep.fits_one_chunk:
        args = (d.val, d.col, prep.ii_g, prep.lhs_g, prep.rhs_g, lb, ub, n_pad, cfg.int_eps)
        got = tk.fused_scatter_round_tiles(*args)
        want = tref.fused_scatter_round_tiles_ref(*args)
        row("fused_scatter_round_tiles", got, want,
            lambda: tk.fused_scatter_round_tiles(*args),
            lambda: tref.fused_scatter_round_tiles_ref(*args))
        best_l, best_u = want
    else:
        a_args = (d.val, d.col, lb, ub, n_pad)
        got = tk.activities_gather_tiles(*a_args)
        want = tref.activities_gather_tiles_ref(*a_args)
        row("activities_gather_tiles", got, want,
            lambda: tk.activities_gather_tiles(*a_args),
            lambda: tref.activities_gather_tiles_ref(*a_args))
        c_args = (*want, d.chunk_row, prep.row_start)
        got = tk.combine_chunk_partials_tiles(*c_args)
        aggs = tref.combine_chunk_partials_ref(*c_args)
        row("combine_chunk_partials_tiles", got, aggs,
            lambda: tk.combine_chunk_partials_tiles(*c_args),
            lambda: tref.combine_chunk_partials_ref(*c_args))
        e_args = (d.val, d.col, prep.ii_g, *aggs, prep.lhs_g, prep.rhs_g, lb, ub, n_pad,
                  cfg.int_eps)
        got = tk.candidates_scatter_tiles(*e_args)
        want = tref.candidates_scatter_tiles_ref(*e_args)
        row("candidates_scatter_tiles", got, want,
            lambda: tk.candidates_scatter_tiles(*e_args),
            lambda: tref.candidates_scatter_tiles_ref(*e_args))
        best_l, best_u = want

    eps = cfg.eps_for(lb.dtype)
    want = ops.bnd.apply_updates(lb, ub, best_l, best_u, eps)
    got = tk.apply_updates_tiles(lb.clone(), ub.clone(), best_l, best_u, eps)
    # Kernel time on scratch copies restored before each launch; the
    # wrapper's time on repeated calls, where nothing tightens after the
    # first.
    lbw, ubw = lb.clone(), ub.clone()
    row("apply_updates_tiles", got, want,
        lambda: tk.apply_updates_tiles(lbw, ubw, best_l, best_u, eps),
        lambda: ops.bnd.apply_updates(lb, ub, best_l, best_u, eps),
        moved=dict(merge_bytes(torch, ops.bnd, lb, ub, best_l, best_u, eps), flag=1),
        reset=fresh_inputs(torch, [(lbw, lb), (ubw, ub)]))
    return rows


def check_same(rt, name, got, want, bitwise, what):
    for f in ("rounds", "converged", "infeasible"):
        if getattr(got, f).item() != getattr(want, f).item():
            fail(f"{name}: {f} {getattr(got, f).item()} != {what} {getattr(want, f).item()}")
    if bitwise:
        import torch

        if not (torch.equal(got.lb, want.lb) and torch.equal(got.ub, want.ub)):
            fail(f"{name}: bounds differ bitwise from {what}")
    elif not rt.bounds_equal(got.lb, got.ub, want.lb, want.ub):
        fail(f"{name}: bounds not bounds_equal to {what}")


def require_launched(per_run: dict, need: dict) -> None:
    """Fail unless each run launched each kernel it must."""
    for run, kernels in need.items():
        for k in kernels:
            if per_run[run][k] <= 0:
                fail(f"main path {run} never launched {k}: {per_run[run]}")


def smoke(torch, dev):
    import numpy as np

    import repro_torch as rt
    import repro_torch.data as td
    from repro_torch.kernels import _build, ops, prop_round as tk, ref as tref

    t0 = time.perf_counter()
    _build.lib()
    info = _build.build_info
    log(f"build: {time.perf_counter() - t0:.1f} s (nvcc {info.get('seconds', 0.0):.1f} s, "
        f"cached={info.get('cached')}) -> {_build.build_path()}")
    for line in info.get("log", "").splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            log("  ptxas:", line.strip())

    problems, preps = {}, {}
    for name, gen, kw in SPECS:
        t = time.perf_counter()
        p = getattr(td, gen)(**kw)
        t_gen = time.perf_counter() - t
        t = time.perf_counter()
        prep = rt.prepare_block_ell(p, device=dev)
        torch.cuda.synchronize()
        t_prep = time.perf_counter() - t
        problems[name], preps[name] = p, prep
        log(f"instance {name}: m={p.m} n={p.n} nnz={p.nnz} "
            f"max_row={int(np.diff(p.csr.row_ptr).max())} tiles={tuple(prep.d.val.shape)} "
            f"n_pad={prep.n_pad} fits_one_chunk={prep.fits_one_chunk} "
            f"generate={t_gen:.1f}s prepare={t_prep:.2f}s")

    # Phase 1: kernel vs plain version on the card, at the main path's shapes
    # and initial bounds, timed.
    measured = {}
    for name in problems:
        prep = preps[name]
        rows = check_kernels(torch, tk, tref, ops, _build, name, problems[name], prep,
                             prep.lb0, prep.ub0, timed=True)
        for kname, r in rows.items():
            log(f"kernel {kname} on {name}: max_abs_err={r['max_abs_err']} ms={r['ms']:.4f} "
                f"wrapper_ms={r['wrapper_ms']:.4f} plain_ms={r['plain_ms']:.4f} "
                f"bound_ms={r['bound_ms']:.4f} "
                f"({r['bound_by']}, {sum(r['bytes'].values())} B: {r['bytes']})")
            measured.setdefault(kname, {})[name] = r

    # Phase 2: the main path, with every launch counter at zero before it.
    tk.reset_launch_counts()
    results, syncs, per_instance = {}, {}, {}
    for name, p in problems.items():
        before = tk.launch_counts()
        n_sync = [0]
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = rt.propagate_block_ell(
            p, device=dev, on_sync=lambda: n_sync.__setitem__(0, n_sync[0] + 1)
        )
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        after = tk.launch_counts()
        per_instance[name] = {k: after[k] - before[k] for k in after}
        results[name], syncs[name] = r, n_sync[0]
        log(f"main path {name}: rounds={r.rounds.item()} (reference {REFERENCE_ROUNDS[name]}) "
            f"converged={r.converged.item()} infeasible={r.infeasible.item()} "
            f"host_syncs={n_sync[0]} wall_s={wall:.4f} launches={per_instance[name]}")
    need = {
        "pb": ("fused_scatter_round_tiles", "apply_updates_tiles"),
        "banded": ("fused_scatter_round_tiles", "apply_updates_tiles"),
        "mixed": ("activities_gather_tiles", "combine_chunk_partials_tiles",
                  "candidates_scatter_tiles", "apply_updates_tiles"),
    }
    require_launched(per_instance, need)
    if results["pb"].rounds.item() != REFERENCE_ROUNDS["pb"] or not results["pb"].infeasible.item():
        fail("pb must take 33 rounds and end infeasible")

    # Phase 3: each kernel again at the main path's final bounds (general
    # floats on banded and mixed, magnitudes up to 1e20 on pb), then the same
    # instances through the plain versions and the plain-PyTorch propagate.
    for name, p in problems.items():
        prep = preps[name]
        lb_f, ub_f = prep.pad_bounds(results[name].lb, results[name].ub)
        for kname, r in check_kernels(torch, tk, tref, ops, _build, name, p, prep, lb_f, ub_f,
                                      timed=True).items():
            log(f"kernel {kname} on {name} at the final bounds: max_abs_err={r['max_abs_err']} "
                f"ms={r['ms']:.4f} wrapper_ms={r['wrapper_ms']:.4f} plain_ms={r['plain_ms']:.4f}")
        plain = rt.propagate_block_ell(p, use_kernels=False, device=dev)
        # Same tiles and summation order, long rows included: bitwise.
        check_same(rt, name, results[name], plain, True, "the plain-version path")
        again = rt.propagate_block_ell(p, device=dev)
        check_same(rt, name, results[name], again, True, "a second run of the kernel path")
        pure = rt.propagate(p, device=dev)
        check_same(rt, name, results[name], pure, False, "plain-PyTorch propagate")
        exact = torch.equal(results[name].lb, plain.lb) and torch.equal(results[name].ub, plain.ub)
        diff = [(getattr(results[name], f) != getattr(pure, f)).sum().item() for f in ("lb", "ub")]
        log(f"compare {name}: matches plain path (bitwise: {exact}) and propagate (bounds_equal; "
            f"entries not bitwise equal: lb {diff[0]}, ub {diff[1]})")

    # pb is exact arithmetic only while its bounds stay small: nearly every
    # variable's domain crosses within a few rounds and the crossed bounds
    # then grow geometrically, past 2**53 before round 33.  Bounds only
    # tighten, so no bound of the first PB_EXACT_ROUNDS rounds exceeds the
    # largest finite magnitude at their end or start; a round's sums and
    # candidates stay below (max_row + 1) times that, and are exact while it
    # is under 2**53.  There the independent propagate must agree bitwise.
    p = problems["pb"]
    cap = rt.core.PropagatorConfig(max_rounds=PB_EXACT_ROUNDS)
    capped = rt.propagate_block_ell(p, cap, device=dev)
    seen = torch.cat([capped.lb, capped.ub, preps["pb"].lb0, preps["pb"].ub0]).abs()
    big = seen[seen < cap.inf].max().item()
    max_row = int(np.diff(p.csr.row_ptr).max())
    if (max_row + 1) * big >= 2.0**53:
        fail(f"pb capped at {PB_EXACT_ROUNDS} rounds reached |bound| {big}: sums not exact")
    check_same(rt, "pb capped", capped, rt.propagate(p, cap, device=dev), True,
               "plain-PyTorch propagate")
    log(f"compare pb over {PB_EXACT_ROUNDS} rounds (max |bound| {big:.4g}, exact sums): "
        f"bitwise equal to propagate")

    # One warm-started branch-and-bound node on pb, through the cached tiles.
    p = problems["pb"]
    rng = np.random.default_rng(1)
    ub0 = np.array(p.ub)
    ub0[rng.choice(p.n, size=p.n // 20, replace=False)] = 0.0
    hits = ops.cache_info()["prepare_block_ell"]["hits"]
    node = rt.propagate_block_ell(p, lb0=p.lb, ub0=ub0, device=dev)
    if ops.cache_info()["prepare_block_ell"]["hits"] != hits + 1:
        fail("the warm-started node did not reuse the prepared tiles")
    node_plain = rt.propagate_block_ell(p, lb0=p.lb, ub0=ub0, use_kernels=False, device=dev)
    check_same(rt, "pb node", node, node_plain, True, "the plain-version path")
    log(f"node pb: rounds={node.rounds.item()} infeasible={node.infeasible.item()} "
        "(matches plain path)")

    # Phase 4: per-round times of the whole fixed point, kernels vs plain
    # (CUDA events bracket each fixed point, host syncs included), and one
    # profiled fixed point for the card's busy time and idle share.
    for name, p in problems.items():
        rounds = results[name].rounds.item()
        k_ms = time_ms(torch, lambda: rt.propagate_block_ell(p, device=dev), reps=1, trials=3)
        p_ms = time_ms(
            torch, lambda: rt.propagate_block_ell(p, use_kernels=False, device=dev),
            reps=1, trials=3,
        )
        log(f"round time {name}: kernels {k_ms / rounds:.4f} ms/round, plain {p_ms / rounds:.4f} "
            f"ms/round, fixed point {k_ms:.3f} ms vs {p_ms:.3f} ms, {rounds} rounds, "
            f"{syncs[name]} host syncs")
        prof = busy_profile(torch, lambda: rt.propagate_block_ell(p, device=dev))
        if prof is None:
            log(f"profile {name}: the profiler recorded no device time; idle share not measured")
            continue
        busy, top = prof
        log(f"profile {name}: device busy {busy:.3f} ms of {k_ms:.3f} ms fixed point, "
            f"idle share {1 - busy / k_ms:.3f}; top: {top}")

    # Phases 5-7: the node engine and the solver, at the solver's tile width.
    t = time.perf_counter()
    pbf = td.make_pseudo_boolean(**PBF)
    prep8 = rt.prepare_block_ell(pbf, tile_width=SOLVER_TILE_WIDTH, device=dev)
    torch.cuda.synchronize()
    log(f"instance pbf: m={pbf.m} n={pbf.n} nnz={pbf.nnz} "
        f"max_row={int(np.diff(pbf.csr.row_ptr).max())} tiles={tuple(prep8.d.val.shape)} "
        f"n_pad={prep8.n_pad} fits_one_chunk={prep8.fits_one_chunk} "
        f"set-up={time.perf_counter() - t:.1f}s")
    for k, rows in node_kernel_phase(torch, np, rt, tk, tref, ops, _build, pbf, prep8, dev).items():
        measured.setdefault(k, {}).update(rows)
    runs = {f"propagate_block_ell {k}": v for k, v in per_instance.items()}
    runs.update(node_batch_phase(torch, np, rt, tk, pbf, problems, dev))
    runs.update(solve_phase(torch, np, rt, td, tk, pbf, dev))
    wide_runs, wide = wide_phase(torch, np, rt, td, tk, tref, ops, _build, dev, measured)
    runs.update(wide_runs)
    runs.update(batch_phase(torch, np, rt, td, tk, tref, ops, _build, dev, measured,
                            {**problems, "pbf": pbf, **wide}))
    runs.update(service_phase(torch, np, rt, td, tk, dev))
    slab_path = ("batched_slab_partials_tiles", "combine_chunk_partials_tiles",
                 "batched_slab_round_tiles", "apply_updates_slab_tiles")
    node_slab_path = ("node_slab_partials_tiles", "combine_chunk_partials_tiles",
                      "node_slab_round_tiles", "apply_updates_slab_tiles")
    require_launched(runs, {
        "propagate_block_ell bandw": slab_path,
        "propagate_block_ell pbw": slab_path,
        "nodes pbw": node_slab_path,
        "solve pbw": node_slab_path + ("node_objective_tiles",),
    })
    fused_batch = ("batched_fused_scatter_round_tiles", "apply_updates_batch_tiles")
    multi_batch = ("activities_gather_tiles", "combine_chunk_partials_tiles",
                   "candidates_scatter_tiles", "apply_updates_batch_tiles")
    require_launched(runs, {
        "batch fused": fused_batch,
        "batch multi-chunk": multi_batch,
        "batch partitioned": slab_path,
        "service stream": fused_batch,
        "service mixed": multi_batch,
    })
    require_launched(runs, {
        "nodes pbf": ("node_fused_scatter_round_tiles", "apply_updates_batch_tiles"),
        "nodes banded": ("node_fused_scatter_round_tiles", "apply_updates_batch_tiles"),
        "nodes mixed": ("activities_gather_tiles", "combine_chunk_partials_tiles",
                        "candidates_scatter_tiles", "apply_updates_tiles"),
        "solve pbf": ("node_fused_scatter_round_tiles", "apply_updates_batch_tiles",
                      "node_objective_tiles"),
        "solve pbf multi-chunk": ("activities_gather_tiles", "combine_chunk_partials_tiles",
                                  "candidates_scatter_tiles", "apply_updates_tiles",
                                  "node_objective_tiles"),
    })
    launches = {fn.__name__: sum(r[fn.__name__] for r in runs.values()) for fn in tk.KERNELS}
    if any(v <= 0 for v in launches.values()):
        fail(f"a kernel of the main path was never launched: {launches}")
    log(f"launches per main-path run: {json.dumps(runs)}")

    primary = {
        "fused_scatter_round_tiles": "pb", "apply_updates_tiles": "pb",
        "activities_gather_tiles": "mixed", "candidates_scatter_tiles": "mixed",
        "combine_chunk_partials_tiles": "mixed",
        "node_fused_scatter_round_tiles": f"pbf pool, 8 of {POOL} active",
        "apply_updates_batch_tiles": f"pbf pool, 8 of {POOL} active",
        "node_objective_tiles": f"pbf pool, {POOL} rows",
        "batched_slab_partials_tiles": "pbw",
        "batched_slab_round_tiles": "pbw",
        "node_slab_partials_tiles": f"pbw pool, 8 of {POOL} active",
        "node_slab_round_tiles": f"pbw pool, 8 of {POOL} active",
        "apply_updates_slab_tiles": f"pbw pool, 8 of {POOL} active",
        "batched_fused_scatter_round_tiles": "fused bucket, 4 of 4 active",
    }
    kernels = []
    for fn in tk.KERNELS:
        k = fn.__name__
        r = measured[k][primary[k]]
        kernels.append(dict(
            name=k, route="cuda", source=SLAB_SOURCE if "slab" in k else SOURCE,
            replaces=REPLACES[k],
            launches=launches[k],
            max_abs_err=max(v["max_abs_err"] for v in measured[k].values()),
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=None, instance=primary[k],
            wrapper_ms=r["wrapper_ms"], bytes=r["bytes"],
        ))
    log(json.dumps({"kernels": kernels}))


def busy_profile(torch, fn):
    """``(device busy ms, the four largest items)`` of one profiled call of
    ``fn``, or None when the profiler recorded no device item."""
    items = device_items(torch, fn)
    if not items:
        return None
    by_name = {}
    for item, us in items:
        key = item.replace("(anonymous namespace)::", "").split("(")[0][:48]
        total, count = by_name.get(key, (0.0, 0))
        by_name[key] = (total + us, count + 1)
    busy = sum(total for total, _ in by_name.values()) / 1e3
    top = ", ".join(
        f"{key} {total / 1e3:.3f} ms x{count}"
        for key, (total, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:4]
    )
    return busy, top


def objective(np, n: int):
    """The solver tests' objective: c_j = (j + 1), negated where j % 3 == 0."""
    return np.arange(1, n + 1, dtype=np.float64) * np.where(np.arange(n) % 3 == 0, -1.0, 1.0)


def node_pool(np, rt, p, cap: int, seed: int):
    """``cap`` warm-started node bound rows (host arrays): the root bounds
    with one to six random branchings each."""
    rng = np.random.default_rng(seed)
    ints = np.flatnonzero(p.is_int)
    lbs, ubs = [], []
    for i in range(cap):
        lb, ub = np.array(p.lb, np.float64), np.array(p.ub, np.float64)
        for var in rng.choice(ints, size=1 + i % 6, replace=False):
            down, up = rt.core.branch_children(lb, ub, int(var), lb[var])
            lb, ub = down if rng.random() < 0.5 else up
        lbs.append(lb)
        ubs.append(ub)
    return np.stack(lbs), np.stack(ubs)


def node_kernel_phase(torch, np, rt, tk, tref, ops, build, pbf, prep, dev):
    """Phase 5: kernels #10, #9 and #16 against their plain versions on the
    pbf tiles and a (POOL, n_pad) pool of warm-started node bounds, with 0, 8
    and POOL active rows; every active row of #10 also against kernel D on
    that node's bounds.  Returns {kernel: {shape: row of measurements}}."""
    cfg = ops.DEFAULT_CONFIG
    d, n_pad, n = prep.d, prep.n_pad, prep.n
    lb_h, ub_h = node_pool(np, rt, pbf, POOL, seed=3)
    lbp, ubp = ops._node_planes(prep, lb_h, ub_h)
    t, r, k = d.val.shape
    nnz = int((d.val != 0).sum().item())
    tiles = 8 * t * r * k + 8 * nnz + 16 * t * r  # val per slot, col+is_int per nnz, sides
    eps = cfg.eps_for(lbp.dtype)
    out = {"node_fused_scatter_round_tiles": {}, "apply_updates_batch_tiles": {},
           "node_objective_tiles": {}}

    def measure(kname, shape, got, want, fn_k, fn_p, moved, n_ops, plain_reps, reset=None):
        b_ms, b_by = bound(sum(moved.values()), n_ops)
        row = dict(max_abs_err=max_abs_err(torch, got, want),
                   ms=kernel_ms(torch, build, fn_k, reset=reset),
                   wrapper_ms=time_ms(torch, fn_k),
                   plain_ms=time_ms(torch, fn_p, reps=plain_reps, trials=3),
                   bound_ms=b_ms, bound_by=b_by, bytes=moved)
        out[kname][shape] = row
        log(f"kernel {kname} on {shape}: max_abs_err={row['max_abs_err']} ms={row['ms']:.4f} "
            f"wrapper_ms={row['wrapper_ms']:.4f} plain_ms={row['plain_ms']:.4f} "
            f"bound_ms={b_ms:.4f} ({b_by}, {sum(moved.values())} B: {moved})")

    for n_act in (0, 8, POOL):
        act = torch.zeros(POOL, dtype=torch.bool, device=dev)
        if n_act:
            act[:: POOL // n_act] = True
        shape = f"pbf pool, {n_act} of {POOL} active"
        args = (d.val, d.col, prep.ii_g, prep.lhs_g, prep.rhs_g, lbp, ubp, act, n_pad,
                cfg.int_eps)
        got = tk.node_fused_scatter_round_tiles(*args)
        want = tref.node_fused_scatter_round_ref(*args[:7], n_pad, cfg.int_eps, active=act)
        for i in act.nonzero().flatten().tolist():
            one = tk.fused_scatter_round_tiles(d.val, d.col, prep.ii_g, prep.lhs_g, prep.rhs_g,
                                               lbp[i], ubp[i], n_pad, cfg.int_eps)
            max_abs_err(torch, (got[0][i], got[1][i]), one)
        # The tile stream is 18 MB: it stays in the 50 MB L2 across the
        # nodes, so it counts once per launch; each active node reads its
        # two bound rows and writes its two accumulator rows.
        moved = dict(tiles=tiles if n_act else 0, bounds=16 * n_act * n_pad,
                     out=16 * n_act * n_pad)
        measure("node_fused_scatter_round_tiles", shape, got, want,
                lambda: tk.node_fused_scatter_round_tiles(*args),
                lambda: tref.node_fused_scatter_round_ref(*args[:7], n_pad, cfg.int_eps,
                                                          active=act),
                moved, 16 * nnz * n_act, 1)

        best_l, best_u = want
        want_m = ops.bnd.apply_updates_batch(lbp, ubp, best_l, best_u, eps, active=act)
        got_m = tk.apply_updates_batch_tiles(lbp.clone(), ubp.clone(), best_l, best_u, act, eps)
        # In place on scratch planes, restored before each timed launch; the
        # mask is read and the per-row flags written.
        lbw, ubw = lbp.clone(), ubp.clone()
        measure("apply_updates_batch_tiles", shape, got_m, want_m,
                lambda: tk.apply_updates_batch_tiles(lbw, ubw, best_l, best_u, act, eps),
                lambda: ops.bnd.apply_updates_batch(lbp, ubp, best_l, best_u, eps, active=act),
                dict(merge_bytes(torch, ops.bnd, lbp, ubp, best_l, best_u, eps, act),
                     flags=2 * POOL),
                6 * n_act * n_pad, 10, reset=fresh_inputs(torch, [(lbw, lbp), (ubw, ubp)]))

    valid = torch.arange(n_pad, device=dev) < n
    ii = torch.zeros(n_pad, dtype=torch.bool, device=dev)
    ii[:n] = d.is_int
    c_pad = torch.zeros(n_pad, dtype=torch.float64, device=dev)
    c_pad[:n] = torch.as_tensor(objective(np, n), device=dev)
    o_args = (lbp, ubp, c_pad, ii, valid, cfg.feas_eps)
    measure("node_objective_tiles", f"pbf pool, {POOL} rows", tk.node_objective_tiles(*o_args),
            tref.node_objective_ref(*o_args), lambda: tk.node_objective_tiles(*o_args),
            lambda: tref.node_objective_ref(*o_args),
            dict(planes=16 * POOL * n_pad, shared=10 * n_pad, out=10 * POOL),
            3 * POOL * n_pad, 10)
    return out


def most_fractional_order(np, lb, ub, is_int):
    """Columns by the most-fractional rule's preference (ties to the lowest
    column), unfixed integer columns first."""
    cand = np.asarray(is_int, bool) & (ub - lb > 0.5)
    mid = 0.5 * (lb + ub)
    frac = mid - np.floor(mid)
    score = np.where(cand, 0.5 - np.abs(frac - 0.5), -1.0)
    return np.argsort(-score, kind="stable")[: int(cand.sum())]


def branched(np, rt, lb, ub, cols):
    """All 2**len(cols) nodes that branch each of ``cols`` at its domain
    midpoint, down or up."""
    lbs, ubs = [], []
    for bits in range(2 ** len(cols)):
        l, u = lb.copy(), ub.copy()
        for j, v in enumerate(cols):
            down, up = rt.core.branch_children(l, u, int(v), 0.5 * (l[v] + u[v]))
            l, u = up if bits >> j & 1 else down
        lbs.append(l)
        ubs.append(u)
    return np.stack(lbs), np.stack(ubs)


def node_batch_phase(torch, np, rt, tk, pbf, problems, dev):
    """Phase 6: propagate_nodes on branched nodes of pbf (64), banded (16) and
    mixed (4, the multi-chunk branch); each node bitwise against its own
    single-instance propagate_block_ell and against the plain-version path.
    Returns the launch counts of each kernel-path run."""
    root = rt.propagate_block_ell(pbf, tile_width=SOLVER_TILE_WIDTH, device=dev)
    if root.rounds.item() != PBF_ROUNDS or root.infeasible.item():
        fail(f"pbf root: {root.rounds.item()} rounds, infeasible={root.infeasible.item()}; "
             f"the reference takes {PBF_ROUNDS} rounds and stays feasible")
    lb_r, ub_r = root.lb.cpu().numpy(), root.ub.cpu().numpy()
    sets = {"pbf": (pbf, SOLVER_TILE_WIDTH,
                    branched(np, rt, lb_r, ub_r, most_fractional_order(np, lb_r, ub_r,
                                                                       pbf.is_int)[:6]))}
    for name, count in (("banded", 4), ("mixed", 2)):
        p = problems[name]
        res = rt.propagate_block_ell(p, device=dev)
        lb, ub = res.lb.cpu().numpy(), res.ub.cpu().numpy()
        cols = np.flatnonzero((ub - lb > 1.0) & (np.abs(lb) < 1e6) & (np.abs(ub) < 1e6))[:count]
        sets[name] = (p, 128, branched(np, rt, lb, ub, cols))

    runs = {}
    for name, (p, tw, (lb, ub)) in sets.items():
        reads = [0]
        tk.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = rt.propagate_nodes(p, lb, ub, tile_width=tw, device=dev,
                                 on_sync=lambda: reads.__setitem__(0, reads[0] + 1))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        runs[f"nodes {name}"] = tk.launch_counts()
        plain = rt.propagate_nodes(p, lb, ub, tile_width=tw, device=dev, use_kernels=False)
        for f in ("lb", "ub", "rounds", "converged", "infeasible"):
            if not torch.equal(getattr(got, f), getattr(plain, f)):
                fail(f"nodes {name}: {f} differs from the plain-version path")
        if not torch.allclose(got.progress, plain.progress, rtol=0, atol=0, equal_nan=True):
            fail(f"nodes {name}: progress differs from the plain-version path")
        for i in range(lb.shape[0]):
            one = rt.propagate_block_ell(p, tile_width=tw, lb0=lb[i], ub0=ub[i], device=dev)
            if not (torch.equal(got.lb[i], one.lb) and torch.equal(got.ub[i], one.ub)):
                fail(f"nodes {name}: node {i} differs from its single-instance run")
            for f in ("rounds", "converged", "infeasible"):
                if getattr(got, f)[i].item() != getattr(one, f).item():
                    fail(f"nodes {name}: node {i} {f} differs from its single-instance run")
        rounds = int(got.rounds.max())
        k_ms = time_ms(torch, lambda: rt.propagate_nodes(p, lb, ub, tile_width=tw, device=dev),
                       reps=1, trials=3)
        p_ms = time_ms(torch, lambda: rt.propagate_nodes(p, lb, ub, tile_width=tw, device=dev,
                                                          use_kernels=False), reps=1, trials=1)
        log(f"nodes {name}: {lb.shape[0]} nodes, rounds {int(got.rounds.min())}-{rounds}, "
            f"infeasible {int(got.infeasible.sum())}, flag reads {reads[0]}, first wall "
            f"{wall * 1e3:.3f} ms; kernels {k_ms:.3f} ms ({k_ms / rounds:.4f} ms/round), plain "
            f"{p_ms:.3f} ms ({p_ms / rounds:.4f} ms/round); every node bitwise equal to its "
            f"single-instance run and to the plain path; launches {runs[f'nodes {name}']}")
    return runs


SOLVE_FIELDS = ("status", "objective", "feasible", "nodes_expanded", "nodes_created", "leaves",
                "pruned_bound", "pruned_infeasible", "levels", "host_syncs",
                "incumbent_trajectory")


def solve_phase(torch, np, rt, td, tk, pbf, dev):
    """Phase 7: solve on the small instances against the reference's results,
    and on pbf at full width against the reference's counts and the plain
    path.  Returns the launch counts of the full-width kernel-path search."""
    for gen, kw, rule, want in SOLVE_REFERENCE:
        p = getattr(td, gen)(**kw)
        res = rt.solve(p, objective(np, p.n), rule=rt.BranchRule(rule), device=dev)
        got = (res.status, res.objective, res.nodes_expanded, res.nodes_created, res.leaves,
               res.pruned_bound, res.pruned_infeasible, res.levels)
        if got != want:
            fail(f"solve {gen}{kw} {rule}: {got} != reference {want}")
    log(f"solve: the {len(SOLVE_REFERENCE)} small searches reproduce the reference's results")

    c = objective(np, pbf.n)
    reads, syncs = [0], []
    tk.reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = rt.solve(pbf, c, device=dev, on_sync=syncs.append,
                   on_flag_read=lambda: reads.__setitem__(0, reads[0] + 1), **FULL_SEARCH)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    runs = {"solve pbf": tk.launch_counts()}
    got = (res.status, res.nodes_expanded, res.nodes_created, res.levels, res.host_syncs)
    if got != FULL_REFERENCE:
        fail(f"solve pbf: {got} != reference {FULL_REFERENCE}")
    t = time.perf_counter()
    plain = rt.solve(pbf, c, device=dev, use_kernels=False, **FULL_SEARCH)
    torch.cuda.synchronize()
    p_wall = time.perf_counter() - t
    for f in SOLVE_FIELDS:
        if getattr(res, f) != getattr(plain, f):
            fail(f"solve pbf: {f} {getattr(res, f)} != plain path {getattr(plain, f)}")
    for f, x, y in zip(res.carry._fields, res.carry, plain.carry):
        if not torch.equal(x, y):
            fail(f"solve pbf: final pool {f} differs from the plain path")
    k_ms = time_ms(torch, lambda: rt.solve(pbf, c, device=dev, **FULL_SEARCH), reps=1, trials=3)
    log(f"solve pbf: {res.status}, levels {res.levels}, expanded {res.nodes_expanded}, created "
        f"{res.nodes_created}, host syncs {res.host_syncs}, flag reads {reads[0]}; kernels "
        f"{k_ms:.3f} ms ({k_ms / res.levels:.3f} ms/level, "
        f"{res.nodes_created / (k_ms / 1e3):.1f} nodes/s; first call {wall * 1e3:.3f} ms), plain "
        f"{p_wall * 1e3:.3f} ms; same result and final pool as the plain path; "
        f"launches {runs['solve pbf']}")
    prof = busy_profile(torch, lambda: rt.solve(pbf, c, device=dev, **FULL_SEARCH))
    if prof is None:
        log("profile solve pbf: the profiler recorded no device time; idle share not measured")
    else:
        busy, top = prof
        log(f"profile solve pbf: device busy {busy:.3f} ms of {k_ms:.3f} ms search, idle share "
            f"{1 - busy / k_ms:.3f}; top: {top}")

    # The same search at tile width 4, where pbf's rows of 5 to 8 nonzeros
    # span two chunks: every round runs A', combine, E and F on each of the
    # POOL slots in turn.  The data are integral, so the search and the final
    # pool equal the one-chunk search's.
    reads4 = [0]
    tk.reset_launch_counts()
    multi = rt.solve(pbf, c, device=dev, tile_width=MULTI_CHUNK_TILE_WIDTH,
                     on_flag_read=lambda: reads4.__setitem__(0, reads4[0] + 1), **FULL_SEARCH)
    torch.cuda.synchronize()
    runs["solve pbf multi-chunk"] = tk.launch_counts()
    for f in SOLVE_FIELDS:
        if getattr(multi, f) != getattr(res, f):
            fail(f"solve pbf at tile width {MULTI_CHUNK_TILE_WIDTH}: {f} {getattr(multi, f)} != "
                 f"tile width {SOLVER_TILE_WIDTH}'s {getattr(res, f)}")
    for f, x, y in zip(res.carry._fields, multi.carry, res.carry):
        if not torch.equal(x, y):
            fail(f"solve pbf at tile width {MULTI_CHUNK_TILE_WIDTH}: final pool {f} differs")
    m_ms = time_ms(torch, lambda: rt.solve(pbf, c, device=dev, tile_width=MULTI_CHUNK_TILE_WIDTH,
                                           **FULL_SEARCH), reps=1, trials=1)
    rounds = reads4[0] - multi.levels  # one flag read per round and one per level
    log(f"solve pbf multi-chunk (tile width {MULTI_CHUNK_TILE_WIDTH}, {POOL} slots): "
        f"{multi.status}, levels {multi.levels}, rounds {rounds}, flag reads {reads4[0]}; "
        f"{m_ms:.3f} ms ({m_ms / multi.levels:.3f} ms/level, {m_ms / rounds:.3f} ms/round, "
        f"{m_ms / rounds / POOL:.4f} ms per slot and round, "
        f"{multi.nodes_created / (m_ms / 1e3):.1f} nodes/s); same result and final pool as "
        f"tile width {SOLVER_TILE_WIDTH}; launches {runs['solve pbf multi-chunk']}")
    return runs

# ---------------------------------------------------------------------------
# Phase 8: past 2^16 columns (the column-slab partitioned engine)
# ---------------------------------------------------------------------------


def log_row(kname, shape, r):
    log(f"kernel {kname} on {shape}: max_abs_err={r['max_abs_err']} ms={r['ms']:.4f} "
        f"wrapper_ms={r['wrapper_ms']:.4f} plain_ms={r['plain_ms']:.4f} "
        f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}, {sum(r['bytes'].values())} B: "
        f"{r['bytes']})")


def measured_row(torch, build, got, want, fn_k, fn_p, moved, n_ops, plain_reps=3, reset=None,
                 launches=1):
    """Kernel against plain version (equal as values), then timed: the
    kernel's launches (CUDA events around the C entries), the wrapper call,
    the plain version; and the bound of ``moved`` bytes and ``n_ops``
    float64 operations."""
    b_ms, b_by = bound(sum(moved.values()), n_ops)
    return dict(max_abs_err=max_abs_err(torch, got, want),
                ms=kernel_ms(torch, build, fn_k, reset=reset, launches=launches),
                wrapper_ms=time_ms(torch, fn_k, reps=3, trials=3),
                plain_ms=time_ms(torch, fn_p, reps=1, trials=plain_reps),
                bound_ms=b_ms, bound_by=b_by, bytes=moved)


def stores(torch, new, old) -> int:
    """Entries a merge changed: 8 B each of the bytes it must store."""
    return int(sum((n != o).sum().item() for n, o in zip(new, old)))


def check_slab_kernels(torch, tk, tref, ops, build, name, prep, part):
    """Kernels #11 and #12 (with #15's merge) against their plain versions
    on the instance's partition at its initial bounds, the single-instance
    shapes of the main path; timed.  Returns {kernel: row}."""
    cfg = ops.DEFAULT_CONFIG
    eps, width = cfg.eps_for(prep.lb0.dtype), prep.n_pad
    act = torch.ones(1, dtype=torch.bool, device=prep.lb0.device)
    lbp, ubp = prep.lb0[None].clone(), prep.ub0[None].clone()
    rows = {}
    ta, r, k = part.a_val.shape
    a_nnz = int((part.a_val != 0).sum().item())
    a_args = (part.a_val, part.a_col_s, part.a_run_start, part.a_run_len, part.a_run_inst,
              part.a_run_slab, act, lbp, ubp, part.slab, part.a_max_run_len)
    partials = tref.batched_slab_partials_ref(*a_args)
    rows["batched_slab_partials_tiles"] = measured_row(
        torch, build, tk.batched_slab_partials_tiles(*a_args), partials,
        lambda: tk.batched_slab_partials_tiles(*a_args),
        lambda: tref.batched_slab_partials_ref(*a_args),
        dict(val=8 * ta * r * k, col=4 * a_nnz, bounds=16 * width, out=24 * ta * r),
        4 * a_nnz)
    segs = prep.straddle_segments(part, 1)
    strs = tref.straddle_tables(part, *partials, segments=segs)
    max_abs_err(torch, tref.straddle_tables(part, *partials, segments=segs,
                                            combine=tk.combine_chunk_partials_tiles), strs)
    t, r, k = part.val.shape
    nnz = int((part.val != 0).sum().item())
    r_args = (part.val, part.col_s, part.ii_g, part.row_done, *strs, part.lhs_g, part.rhs_g,
              part.run_start, part.run_len, part.run_inst, part.run_slab, act)
    tail = (part.slab, part.max_run_len, eps, cfg.int_eps)
    want = tref.batched_slab_round_ref(*r_args, lbp, ubp, *tail)
    got = tk.batched_slab_round_tiles(*r_args, lbp.clone(), ubp.clone(), *tail)
    lbw, ubw = lbp.clone(), ubp.clone()
    rows["batched_slab_round_tiles"] = measured_row(
        torch, build, got, want,
        lambda: tk.batched_slab_round_tiles(*r_args, lbw, ubw, *tail),
        lambda: tref.batched_slab_round_ref(*r_args, lbp, ubp, *tail),
        dict(val=8 * t * r * k, col_ii=8 * nnz, rows=44 * t * r, bounds=16 * width,
             stores=8 * stores(torch, want[:2], (lbp, ubp)), accumulators=32 * width,
             flags=4 * part.n_slabs),
        16 * nnz, reset=fresh_inputs(torch, [(lbw, lbp), (ubw, ubp)]), launches=2)
    for kname, row in rows.items():
        row["instance"] = name
        log_row(kname, name, row)
    return rows


def check_node_slab_kernels(torch, np, rt, tk, tref, ops, build, pbw, prep, part):
    """Kernels #13, #14 (with #15's merge) and #15 alone against their plain
    versions on pbw's K = 8 partition over a (POOL, n_pad) pool of
    warm-started node bounds, with 0, 8 and POOL rows active; timed.
    Returns {kernel: {shape: row}}."""
    cfg = ops.DEFAULT_CONFIG
    width = prep.n_pad
    lb_h, ub_h = node_pool(np, rt, pbw, POOL, seed=3)
    lbp, ubp = ops._node_planes(prep, lb_h, ub_h)
    eps = cfg.eps_for(lbp.dtype)
    ta, r, k = part.a_val.shape
    a_nnz = int((part.a_val != 0).sum().item())
    t, _, _ = part.val.shape
    nnz = int((part.val != 0).sum().item())
    out = {"node_slab_partials_tiles": {}, "node_slab_round_tiles": {},
           "apply_updates_slab_tiles": {}}
    fill = time_ms(torch, lambda: (torch.full_like(lbp, -cfg.inf), torch.full_like(ubp, cfg.inf)))
    log(f"accumulator fill: two ({POOL}, {width}) sentinel planes, {fill:.4f} ms")
    for n_act in (0, 8, POOL):
        act = torch.zeros(POOL, dtype=torch.bool, device=lbp.device)
        if n_act:
            act[:: POOL // n_act] = True
        shape = f"pbw pool, {n_act} of {POOL} active"
        reps = 1 if n_act == POOL else 3
        a_args = (part.a_val, part.a_col_s, part.a_run_start, part.a_run_len, part.a_run_slab,
                  act, lbp, ubp, part.slab, part.a_max_run_len)
        partials = tref.node_slab_partials_ref(*a_args)
        # The sub-stream is read once per launch (26 MB at K = 8: in L2);
        # each active node gathers its bound row and writes its partials.
        # The zero rows of inactive nodes are the wrapper's fill.
        out["node_slab_partials_tiles"][shape] = measured_row(
            torch, build, tk.node_slab_partials_tiles(*a_args), partials,
            lambda: tk.node_slab_partials_tiles(*a_args),
            lambda: tref.node_slab_partials_ref(*a_args),
            dict(stream=(8 * ta * r * k + 4 * a_nnz) if n_act else 0,
                 bounds=16 * n_act * width, out=24 * n_act * ta * r),
            4 * a_nnz * n_act, plain_reps=reps)
        strs = tref.straddle_tables(part, *partials, segments=prep.straddle_segments(part, POOL))
        r_args = (part.val, part.col_s, part.ii_g, part.row_done, *strs, part.lhs_g,
                  part.rhs_g, part.run_start, part.run_len, part.run_slab, act)
        tail = (part.slab, part.max_run_len, eps, cfg.int_eps)
        want = tref.node_slab_round_ref(*r_args, lbp, ubp, *tail)
        got = tk.node_slab_round_tiles(*r_args, lbp.clone(), ubp.clone(), *tail)
        for i in act.nonzero().flatten().tolist()[:8]:
            one = tref.batched_slab_round_ref(
                part.val, part.col_s, part.ii_g, part.row_done, *(x[i] for x in strs),
                part.lhs_g, part.rhs_g, part.run_start, part.run_len, part.run_inst,
                part.run_slab, act[i : i + 1], lbp[i : i + 1], ubp[i : i + 1], *tail)
            max_abs_err(torch, (got[0][i], got[1][i]), (one[0][0], one[1][0]))
        lbw, ubw = lbp.clone(), ubp.clone()
        out["node_slab_round_tiles"][shape] = measured_row(
            torch, build, got, want,
            lambda: tk.node_slab_round_tiles(*r_args, lbw, ubw, *tail),
            lambda: tref.node_slab_round_ref(*r_args, lbp, ubp, *tail),
            dict(stream=(8 * t * r * k + 8 * nnz + 20 * t * r) if n_act else 0,
                 aggregates=24 * n_act * t * r, bounds=16 * n_act * width,
                 stores=8 * stores(torch, want[:2], (lbp, ubp)),
                 accumulators=32 * n_act * width, flags=4 * POOL * part.n_slabs + POOL),
            16 * nnz * n_act, plain_reps=reps,
            reset=fresh_inputs(torch, [(lbw, lbp), (ubw, ubp)]), launches=2)
        bl, bu = tref.node_partitioned_round_ref(part, lbp, ubp, cfg.int_eps, cfg.inf,
                                                 active=act)
        bl, bu = bl[:, :width].contiguous(), bu[:, :width].contiguous()
        m_args = (act, part.slab, eps)
        want_m = tref.apply_updates_slab_ref(lbp, ubp, bl, bu, *m_args)
        want_m = (*want_m[:2], want_m[2].any(dim=1))
        got_m = tk.apply_updates_slab_tiles(lbp.clone(), ubp.clone(), bl, bu, *m_args)
        lbw, ubw = lbp.clone(), ubp.clone()
        out["apply_updates_slab_tiles"][shape] = measured_row(
            torch, build, got_m, want_m,
            lambda: tk.apply_updates_slab_tiles(lbw, ubw, bl, bu, *m_args),
            lambda: tref.apply_updates_slab_ref(lbp, ubp, bl, bu, *m_args),
            dict(merge_bytes(torch, ops.bnd, lbp, ubp, bl, bu, eps, act),
                 flags=4 * POOL * part.n_slabs + POOL),
            6 * n_act * width, reset=fresh_inputs(torch, [(lbw, lbp), (ubw, ubp)]))
        for kname in out:
            log_row(kname, shape, out[kname][shape])
    return out


def wide_phase(torch, np, rt, td, tk, tref, ops, build, dev, measured):
    """Phase 8: bandw and pbw past 2^16 columns.  Kernels #11-#15 against
    their plain versions at the engine's shapes (and D + F at n_pad
    150,016); propagate_block_ell with its defaults (the partitioned engine)
    against the plain path, a second run and the explicit fused engine;
    propagate_nodes on 16 pbw nodes; solve on pbw against the reference's
    counts, the plain path and the fused node path.  Adds to ``measured``;
    returns the launch counts of each main-path run."""
    problems, preps, parts = {}, {}, {}
    for name, gen, kw in WIDE_SPECS:
        t = time.perf_counter()
        p = getattr(td, gen)(**kw)
        t_gen = time.perf_counter() - t
        t = time.perf_counter()
        prep = rt.prepare_block_ell(p, device=dev)
        torch.cuda.synchronize()
        t_prep = time.perf_counter() - t
        t = time.perf_counter()
        part = prep.slab_partition()
        torch.cuda.synchronize()
        t_part = time.perf_counter() - t
        problems[name], preps[name], parts[name] = p, prep, part
        log(f"instance {name}: m={p.m} n={p.n} nnz={p.nnz} "
            f"max_row={int(np.diff(p.csr.row_ptr).max())} tiles={tuple(prep.d.val.shape)} "
            f"n_pad={prep.n_pad} slab={part.slab} x {part.n_slabs} copies={part.num_copies} "
            f"straddle_tiles={part.a_val.shape[0]} straddle_rows={part.n_straddle} "
            f"duplication={part.duplication:.4f} generate={t_gen:.1f}s prepare={t_prep:.2f}s "
            f"partition_build={t_part:.2f}s")
        if ops._resolve_scatter("auto", prep) != "partitioned":
            fail(f"{name}: scatter='auto' does not take the partitioned engine")

    for name, p in problems.items():
        prep = preps[name]
        for kname, r in check_kernels(torch, tk, tref, ops, build, name, p, prep, prep.lb0,
                                      prep.ub0, timed=True).items():
            log(f"kernel {kname} on {name} (n_pad {prep.n_pad}): max_abs_err="
                f"{r['max_abs_err']} ms={r['ms']:.4f} wrapper_ms={r['wrapper_ms']:.4f} "
                f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f}")
            measured.setdefault(kname, {})[name] = r
        for kname, r in check_slab_kernels(torch, tk, tref, ops, build, name, prep,
                                           parts[name]).items():
            measured.setdefault(kname, {})[name] = r

    runs = {}
    results = {}
    for name, p in problems.items():
        n_sync = [0]
        tk.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = rt.propagate_block_ell(p, device=dev,
                                   on_sync=lambda: n_sync.__setitem__(0, n_sync[0] + 1))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        runs[f"propagate_block_ell {name}"] = tk.launch_counts()
        results[name] = r
        rounds = r.rounds.item()
        if (rounds, r.converged.item(), r.infeasible.item()) != (WIDE_ROUNDS[name], True, False):
            fail(f"{name}: rounds={rounds} converged={r.converged.item()} "
                 f"infeasible={r.infeasible.item()}; the reference takes {WIDE_ROUNDS[name]} "
                 "rounds and converges feasible")
        check_same(rt, name, r, rt.propagate_block_ell(p, use_kernels=False, device=dev), True,
                   "the plain-version path")
        check_same(rt, name, r, rt.propagate_block_ell(p, device=dev), True,
                   "a second run of the kernel path")
        fused = rt.propagate_block_ell(p, scatter="fused", device=dev)
        check_same(rt, name, r, fused, False, "the explicit fused engine")
        diff = [(getattr(r, f) != getattr(fused, f)).sum().item() for f in ("lb", "ub")]
        k_ms = time_ms(torch, lambda: rt.propagate_block_ell(p, device=dev), reps=1, trials=3)
        f_ms = time_ms(torch, lambda: rt.propagate_block_ell(p, scatter="fused", device=dev),
                       reps=1, trials=3)
        p_ms = time_ms(torch, lambda: rt.propagate_block_ell(p, use_kernels=False, device=dev),
                       reps=1, trials=1)
        fixed = int((r.lb == r.ub).sum().item())
        log(f"main path {name}: partitioned, rounds={rounds} (reference {WIDE_ROUNDS[name]}) "
            f"converged feasible, {fixed} variables fixed, host_syncs={n_sync[0]}, first wall "
            f"{wall * 1e3:.3f} ms; bitwise equal to the plain path and a second run; explicit "
            f"fused: same rounds, bounds_equal, entries not bitwise equal: lb {diff[0]}, "
            f"ub {diff[1]}; launches {runs[f'propagate_block_ell {name}']}")
        log(f"round time {name}: partitioned {k_ms / rounds:.4f} ms/round ({k_ms:.3f} ms), "
            f"fused {f_ms / rounds:.4f} ms/round ({f_ms:.3f} ms), plain {p_ms / rounds:.4f} "
            f"ms/round, {rounds} rounds, {n_sync[0]} host syncs")
        prof = busy_profile(torch, lambda: rt.propagate_block_ell(p, device=dev))
        if prof is None:
            log(f"profile {name}: the profiler recorded no device time; idle share not measured")
        else:
            busy, top = prof
            log(f"profile {name}: device busy {busy:.3f} ms of {k_ms:.3f} ms fixed point, "
                f"idle share {1 - busy / k_ms:.3f}; top: {top}")

    # The node engine and the solver at the solver's tile width.
    pbw = problems["pbw"]
    t = time.perf_counter()
    prep8 = rt.prepare_block_ell(pbw, tile_width=SOLVER_TILE_WIDTH, device=dev)
    part8 = prep8.slab_partition()
    torch.cuda.synchronize()
    log(f"pbw at tile width {SOLVER_TILE_WIDTH}: tiles={tuple(prep8.d.val.shape)} "
        f"copies={part8.num_copies} straddle_tiles={part8.a_val.shape[0]} "
        f"straddle_rows={part8.n_straddle} duplication={part8.duplication:.4f} "
        f"prepare + partition_build={time.perf_counter() - t:.2f}s")
    for k, rows in check_node_slab_kernels(torch, np, rt, tk, tref, ops, build, pbw, prep8,
                                           part8).items():
        measured.setdefault(k, {}).update(rows)

    root = rt.propagate_block_ell(pbw, tile_width=SOLVER_TILE_WIDTH, device=dev)
    check_same(rt, "pbw at tile width 8", root, results["pbw"], True, "tile width 128")
    lb_r, ub_r = root.lb.cpu().numpy(), root.ub.cpu().numpy()
    lb, ub = branched(np, rt, lb_r, ub_r,
                      most_fractional_order(np, lb_r, ub_r, pbw.is_int)[:WIDE_BRANCHED])
    reads = [0]
    tk.reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    got = rt.propagate_nodes(pbw, lb, ub, tile_width=SOLVER_TILE_WIDTH, device=dev,
                             on_sync=lambda: reads.__setitem__(0, reads[0] + 1))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    runs["nodes pbw"] = tk.launch_counts()
    plain = rt.propagate_nodes(pbw, lb, ub, tile_width=SOLVER_TILE_WIDTH, device=dev,
                               use_kernels=False)
    for f in ("lb", "ub", "rounds", "converged", "infeasible"):
        if not torch.equal(getattr(got, f), getattr(plain, f)):
            fail(f"nodes pbw: {f} differs from the plain-version path")
    for i in range(lb.shape[0]):
        one = rt.propagate_block_ell(pbw, tile_width=SOLVER_TILE_WIDTH, lb0=lb[i], ub0=ub[i],
                                     device=dev)
        if not (torch.equal(got.lb[i], one.lb) and torch.equal(got.ub[i], one.ub)):
            fail(f"nodes pbw: node {i} differs from its single-instance run")
        for f in ("rounds", "converged", "infeasible"):
            if getattr(got, f)[i].item() != getattr(one, f).item():
                fail(f"nodes pbw: node {i} {f} differs from its single-instance run")
    rounds = int(got.rounds.max())
    k_ms = time_ms(torch, lambda: rt.propagate_nodes(pbw, lb, ub, tile_width=SOLVER_TILE_WIDTH,
                                                     device=dev), reps=1, trials=3)
    log(f"nodes pbw: {lb.shape[0]} nodes, rounds {int(got.rounds.min())}-{rounds}, infeasible "
        f"{int(got.infeasible.sum())}, flag reads {reads[0]}, first wall {wall * 1e3:.3f} ms; "
        f"kernels {k_ms:.3f} ms ({k_ms / rounds:.4f} ms/round); every node bitwise equal to "
        f"its single-instance run and to the plain path; launches {runs['nodes pbw']}")

    c = objective(np, pbw.n)
    reads, syncs = [0], []
    tk.reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = rt.solve(pbw, c, device=dev, on_sync=syncs.append,
                   on_flag_read=lambda: reads.__setitem__(0, reads[0] + 1), **WIDE_SEARCH)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    runs["solve pbw"] = tk.launch_counts()
    got = (res.status, res.nodes_expanded, res.nodes_created, res.levels, res.host_syncs)
    if got != WIDE_REFERENCE:
        fail(f"solve pbw: {got} != reference {WIDE_REFERENCE}")
    plain = rt.solve(pbw, c, device=dev, use_kernels=False, **WIDE_SEARCH)
    # The same search through the fused node round (#10 + #9): the limit is
    # raised past pbw's n_pad for this call alone.
    limit = ops.SCATTER_MAX_NPAD
    ops.SCATTER_MAX_NPAD = 1 << 18
    try:
        tk.reset_launch_counts()
        fused = rt.solve(pbw, c, device=dev, **WIDE_SEARCH)
        fused_counts = tk.launch_counts()
        f_ms = time_ms(torch, lambda: rt.solve(pbw, c, device=dev, **WIDE_SEARCH), reps=1,
                       trials=3)
    finally:
        ops.SCATTER_MAX_NPAD = limit
    if fused_counts["node_fused_scatter_round_tiles"] <= 0 or fused_counts[
            "node_slab_round_tiles"] != 0:
        fail(f"solve pbw through the fused node round launched {fused_counts}")
    for other, what in ((plain, "the plain path"), (fused, "the fused node path")):
        for f in SOLVE_FIELDS:
            if getattr(res, f) != getattr(other, f):
                fail(f"solve pbw: {f} {getattr(res, f)} != {what} {getattr(other, f)}")
        for f, x, y in zip(res.carry._fields, res.carry, other.carry):
            if not torch.equal(x, y):
                fail(f"solve pbw: final pool {f} differs from {what}")
    k_ms = time_ms(torch, lambda: rt.solve(pbw, c, device=dev, **WIDE_SEARCH), reps=1, trials=3)
    log(f"solve pbw: {res.status}, levels {res.levels}, expanded {res.nodes_expanded}, created "
        f"{res.nodes_created}, host syncs {res.host_syncs}, flag reads {reads[0]} (reference "
        f"{WIDE_REFERENCE}); partitioned {k_ms:.3f} ms ({k_ms / res.levels:.3f} ms/level, "
        f"{res.nodes_created / (k_ms / 1e3):.1f} nodes/s; first call {wall * 1e3:.3f} ms), "
        f"fused node path {f_ms:.3f} ms ({f_ms / res.levels:.3f} ms/level); same result and "
        f"final pool on the kernel path, the plain path and the fused node path; launches "
        f"{runs['solve pbw']}")
    prof = busy_profile(torch, lambda: rt.solve(pbw, c, device=dev, **WIDE_SEARCH))
    if prof is None:
        log("profile solve pbw: the profiler recorded no device time; idle share not measured")
    else:
        busy, top = prof
        log(f"profile solve pbw: device busy {busy:.3f} ms of {k_ms:.3f} ms search, idle share "
            f"{1 - busy / k_ms:.3f}; top: {top}")
    return runs, problems


# ---------------------------------------------------------------------------
# Phase 9: the batched engine (propagate_batch)
# ---------------------------------------------------------------------------


def batched_fused_bytes(np, batch, active) -> dict:
    """Bytes kernel #8 must move on a packed bucket with ``active`` (host
    bool per instance): for the tiles of active instances ``val`` per padded
    slot, ``col`` and ``is_int`` per nonzero, the two sides per chunk; per
    active instance its two bound rows read and its two accumulator rows
    written; the tile map and the mask."""
    ell = batch.ell
    t, r, k = ell.val.shape
    on = np.asarray(active)[ell.tile_inst]
    nnz = int((ell.val[on] != 0).sum())
    tiles = int(on.sum())
    n_act = int(np.asarray(active).sum())
    return dict(val=8 * tiles * r * k, col_ii=8 * nnz, sides=16 * tiles * r,
                planes=32 * n_act * batch.n_pad, maps=4 * t + batch.size), nnz


def check_batched_fused(torch, np, rt, tk, tref, build, batch, prep, singles, dev):
    """Kernel #8 against its plain version at the fused bucket's shapes and
    initial planes, with 0, 2 and 4 instances active, bitwise; each active
    row also against kernel D on that instance's own tiles.  Timed: the
    kernel's launch, the wrapper call, the plain version.  Returns {shape:
    row}."""
    d, cfg = prep.d, rt.core.DEFAULT_CONFIG
    rows = {}
    for n_act in (0, 2, batch.size):
        act_h = np.zeros(batch.size, bool)
        act_h[:: max(1, batch.size // max(n_act, 1))][:n_act] = True
        act = torch.as_tensor(act_h, device=dev)
        args = (d.val, d.col, d.ii_g, d.lhs_g, d.rhs_g, d.lb0, d.ub0, d.tile_inst, act,
                prep.n_pad, cfg.int_eps)
        got = tk.batched_fused_scatter_round_tiles(*args)
        want = tref.batched_fused_scatter_round_ref(
            d.val, d.col_g, d.ii_g, d.lhs_g, d.rhs_g, d.lb0, d.ub0, prep.n_pad, cfg.int_eps,
            active=act)
        for i in np.flatnonzero(act_h):
            sp = singles[i]
            one = tk.fused_scatter_round_tiles(sp.d.val, sp.d.col, sp.ii_g, sp.lhs_g, sp.rhs_g,
                                               sp.lb0, sp.ub0, sp.n_pad, cfg.int_eps)
            max_abs_err(torch, (got[0][i], got[1][i]), one)
        moved, nnz = batched_fused_bytes(np, batch, act_h)
        shape = f"fused bucket, {n_act} of {batch.size} active"
        rows[shape] = r = measured_row(
            torch, build, got, want, lambda: tk.batched_fused_scatter_round_tiles(*args),
            lambda: tref.batched_fused_scatter_round_ref(
                d.val, d.col_g, d.ii_g, d.lhs_g, d.rhs_g, d.lb0, d.ub0, prep.n_pad,
                cfg.int_eps, active=act),
            moved, 16 * nnz, plain_reps=1)
        log_row("batched_fused_scatter_round_tiles", shape, r)
    fill = time_ms(torch, lambda: (torch.full_like(d.lb0, -cfg.inf),
                                   torch.full_like(d.ub0, cfg.inf)))
    log(f"accumulator fill: two {tuple(d.lb0.shape)} sentinel planes, {fill:.4f} ms")
    return rows


def batch_phase(torch, np, rt, td, tk, tref, ops, build, dev, measured, problems):
    """Phase 9: propagate_batch with its defaults on three buckets -- one
    fused (#8 + #9), one multi-chunk (A', combine, E over the flat stream,
    then #9), one past 2^16 columns (the partitioned round with two planes).
    Every instance bitwise against its own propagate_block_ell and against
    the plain path; a bounds= warm start; #8 against its plain version,
    timed.  Adds to ``measured``; returns the launch counts of each run."""
    t = time.perf_counter()
    banded1 = td.make_banded(**BANDED1)
    mixed1 = td.make_mixed(**MIXED1)
    log(f"instances banded1, mixed1: generate={time.perf_counter() - t:.1f}s")
    pops = {
        "fused": [problems["pb"], problems["pbf"], problems["banded"], banded1],
        "multi-chunk": [problems["mixed"], mixed1],
        "partitioned": [problems["bandw"], problems["pbw"]],
    }
    preps = {}
    for name, pop in pops.items():
        t = time.perf_counter()
        (batch,) = ops.packed_problems(pop)
        t_pack = time.perf_counter() - t
        t = time.perf_counter()
        prep = ops.prepare_problem_batch(batch, device=dev)
        torch.cuda.synchronize()
        t_prep = time.perf_counter() - t
        t = time.perf_counter()
        extra = ""
        if prep.n_pad > ops.SCATTER_MAX_NPAD:
            part = prep.slab_partition()
            extra = (f" slab={part.slab} x {part.n_slabs} copies={part.num_copies} "
                     f"straddle_tiles={part.a_val.shape[0]} straddle_rows={part.n_straddle} "
                     f"partition_build={time.perf_counter() - t:.2f}s")
        got = ("partitioned" if prep.n_pad > ops.SCATTER_MAX_NPAD
               else "fused" if prep.fits_one_chunk else "multi-chunk")
        if got != name:
            fail(f"batch {name}: the bucket takes the {got} round")
        preps[name] = (batch, prep)
        log(f"batch {name}: {batch.size} instances, nnz={[q.nnz for q in pop]}, "
            f"tiles={tuple(prep.d.val.shape)} "
            f"n_pad={prep.n_pad} m_total={prep.m_total} fits_one_chunk={prep.fits_one_chunk} "
            f"pack={t_pack:.2f}s prepare={t_prep:.2f}s{extra}")

    batch, prep = preps["fused"]
    singles = [rt.prepare_block_ell(p, device=dev) for p in pops["fused"]]
    measured["batched_fused_scatter_round_tiles"] = check_batched_fused(
        torch, np, rt, tk, tref, build, batch, prep, singles, dev)

    runs = {}
    for name, pop in pops.items():
        reads = [0]
        tk.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = rt.propagate_batch(pop, device=dev,
                                 on_sync=lambda: reads.__setitem__(0, reads[0] + 1))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        runs[f"batch {name}"] = tk.launch_counts()
        plain = rt.propagate_batch(pop, device=dev, use_kernels=False)
        singles = [rt.propagate_block_ell(p, device=dev) for p in pop]
        for i, (g, w, one) in enumerate(zip(got, plain, singles)):
            for f in ("lb", "ub", "rounds", "converged", "infeasible"):
                if not torch.equal(getattr(g, f), getattr(w, f)):
                    fail(f"batch {name}: instance {i} {f} differs from the plain path")
                if not torch.equal(getattr(g, f), getattr(one, f)):
                    fail(f"batch {name}: instance {i} {f} differs from its propagate_block_ell")
            if not torch.equal(g.progress, w.progress):
                fail(f"batch {name}: instance {i} progress differs from the plain path")
        b_ms = time_ms(torch, lambda: rt.propagate_batch(pop, device=dev), reps=1, trials=3)
        s_ms = [time_ms(torch, lambda p=p: rt.propagate_block_ell(p, device=dev), reps=1,
                        trials=3) for p in pop]
        rounds = [int(r.rounds) for r in got]
        log(f"batch {name}: rounds {rounds}, converged {[bool(r.converged) for r in got]}, "
            f"infeasible {[bool(r.infeasible) for r in got]}, flag reads {reads[0]}, first wall "
            f"{wall * 1e3:.3f} ms; batch fixed point {b_ms:.3f} ms ({b_ms / max(rounds):.4f} "
            f"ms/round), sum of single-instance fixed points {sum(s_ms):.3f} ms "
            f"({', '.join(f'{x:.3f}' for x in s_ms)}); every instance bitwise equal to its "
            f"propagate_block_ell and to the plain path; launches {runs[f'batch {name}']}")
        prof = busy_profile(torch, lambda: rt.propagate_batch(pop, device=dev))
        if prof is None:
            log(f"profile batch {name}: the profiler recorded no device time; idle share not "
                "measured")
        else:
            busy, top = prof
            log(f"profile batch {name}: device busy {busy:.3f} ms of {b_ms:.3f} ms fixed point, "
                f"idle share {1 - busy / b_ms:.3f}; top: {top}")

    # A warm start of one instance through the same packed tiles.
    pop = pops["fused"]
    p = pop[0]
    rng = np.random.default_rng(1)
    ub0 = np.array(p.ub)
    ub0[rng.choice(p.n, size=p.n // 20, replace=False)] = 0.0
    hits = ops.cache_info()["prepare_problem_batch"]["hits"]
    warm = rt.propagate_batch(pop, bounds=[(p.lb, ub0), None, None, None], device=dev)
    if ops.cache_info()["prepare_problem_batch"]["hits"] != hits + 1:
        fail("the warm start did not reuse the prepared bucket")
    one = rt.propagate_block_ell(p, lb0=p.lb, ub0=ub0, device=dev)
    cold = rt.propagate_batch(pop, device=dev)
    for f in ("lb", "ub", "rounds", "converged", "infeasible"):
        if not torch.equal(getattr(warm[0], f), getattr(one, f)):
            fail(f"batch warm start: {f} differs from the warm-started propagate_block_ell")
        for i in range(1, len(pop)):
            if not torch.equal(getattr(warm[i], f), getattr(cold[i], f)):
                fail(f"batch warm start: instance {i} {f} moved")
    log(f"batch warm start: pb with {p.n // 20} upper bounds at 0, rounds "
        f"{int(warm[0].rounds)}, infeasible {bool(warm[0].infeasible)}; equal to its "
        "warm-started propagate_block_ell, the other instances unchanged")
    return runs


# ---------------------------------------------------------------------------
# Phase 10: the continuous-batching service
# ---------------------------------------------------------------------------


def percentiles(np, xs) -> str:
    q = np.percentile(np.asarray(xs) * 1e3, [50, 95, 99])
    return f"p50 {q[0]:.3f} / p95 {q[1]:.3f} / p99 {q[2]:.3f} ms"


def serve_once(torch, svc, payloads):
    """Submit every pre-packed payload, then pump until all retired.
    Returns (tickets, wall seconds, pumps)."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    tickets = [svc.submit(payload=pay) for pay in payloads]
    pumps = 0
    while not all(tk_.done() for tk_ in tickets):
        svc.pump()
        pumps += 1
    torch.cuda.synchronize()
    return tickets, time.perf_counter() - t, pumps


def service_run(torch, np, rt, tk, name, stream, dev, **kw):
    """One service over ``stream``: build, a checked serve (every ticket
    bitwise against one-shot propagate_batch on the kernels and on the
    plain versions), timed saturation runs against sequential
    propagate_block_ell, profile and stats.  Returns the checked serve's
    launch counts."""
    reads = [0]
    t = time.perf_counter()
    specs = rt.BucketSpec.for_problems(stream, **{k: v for k, v in kw.items()
                                                  if k in ("slots", "size_classes")})
    svc = rt.PropagationService(specs, rounds_per_step=SERVICE_ROUNDS_PER_STEP, device=dev,
                                on_sync=lambda: reads.__setitem__(0, reads[0] + 1))
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t
    for s in specs:
        log(f"service {name} bucket: n_pad={s.n_pad} slots={s.slots} slot_tiles={s.slot_tiles} "
            f"slot_rows={s.slot_rows} tile_width={s.tile_width} "
            f"fits_one_chunk={s.fits_one_chunk}")
    spec_of = [next(s for s in specs if s.fits_problem(p)) for p in stream]
    t = time.perf_counter()
    payloads = [s.pack(p) for s, p in zip(spec_of, stream)]
    t_pack = time.perf_counter() - t
    cc0 = svc.compile_counts()

    tk.reset_launch_counts()
    reads[0] = 0
    tickets, wall, pumps = serve_once(torch, svc, payloads)
    counts = tk.launch_counts()
    first_reads = reads[0]
    for i, (p, s, tkt) in enumerate(zip(stream, spec_of, tickets)):
        r = tkt.result()
        for use_kernels in (True, False):
            one = rt.propagate_batch([p], tile_rows=8, tile_width=s.tile_width,
                                     use_kernels=use_kernels, device=dev)[0]
            for f in ("lb", "ub", "rounds", "converged", "infeasible", "progress"):
                if not torch.equal(getattr(r, f), getattr(one, f).cpu()):
                    fail(f"service {name}: ticket {i} {f} differs from the one-shot batch "
                         f"({'kernels' if use_kernels else 'plain versions'})")
    if svc.compile_counts() != cc0:
        fail(f"service {name}: builds after construction: {cc0} -> {svc.compile_counts()}")

    rates, lat, queue, resident, pump_counts = [], [], [], [], []
    for _ in range(SERVICE_TIMED_RUNS):
        reads[0] = 0
        tickets, wall_t, pumps_t = serve_once(torch, svc, payloads)
        rates.append(len(stream) / wall_t)
        pump_counts.append((pumps_t, reads[0]))
        lat += [x.latency() for x in tickets]
        queue += [x.queue_latency() for x in tickets]
        resident += [x.service_latency() for x in tickets]
    for s, p in zip(spec_of, stream):  # prepare once, outside the timer
        rt.propagate_block_ell(p, tile_width=s.tile_width, device=dev)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for s, p in zip(spec_of, stream):
        rt.propagate_block_ell(p, tile_width=s.tile_width, device=dev)
    torch.cuda.synchronize()
    seq = len(stream) / (time.perf_counter() - t)
    rounds = [int(x.result().rounds) for x in tickets]
    log(f"service {name}: {len(stream)} requests, rounds {min(rounds)}-{max(rounds)}, "
        f"build {t_build:.2f}s, pack {t_pack:.2f}s; checked serve {wall * 1e3:.1f} ms, "
        f"{pumps} pumps, {first_reads} flag reads ({first_reads / pumps:.2f} per pump); every "
        f"ticket bitwise equal to the one-shot batch on the kernels and on the plain versions; "
        f"no build after construction {cc0}; launches {counts}")
    log(f"service {name}: saturation {', '.join(f'{x:.2f}' for x in rates)} instances/s "
        f"(pumps, flag reads per run: {pump_counts}); sequential propagate_block_ell "
        f"{seq:.2f} instances/s; latency submit->retire {percentiles(np, lat)}, queue "
        f"{percentiles(np, queue)}, resident {percentiles(np, resident)}")
    prof = busy_profile(torch, lambda: serve_once(torch, svc, payloads))
    if prof is None:
        log(f"profile service {name}: the profiler recorded no device time; idle share not "
            "measured")
    else:
        busy, top = prof
        wall_p = len(stream) / statistics.median(rates) * 1e3
        log(f"profile service {name}: device busy {busy:.3f} ms of {wall_p:.3f} ms saturation "
            f"run, idle share {1 - busy / wall_p:.3f}; top: {top}")
    st = svc.stats()
    for b in st["buckets"]:
        log(f"service {name} stats: n_pad={b['n_pad']} tile_width={b['tile_width']} "
            f"slot_tiles={b['slot_tiles']} retired={b['retired']} "
            f"mean_occupancy={b['mean_occupancy']:.3f}")
    log(f"service {name} stats: submitted={st['submitted']} retired={st['retired']} "
        f"pending={st['pending']} occupied={st['occupied']} engine_cache={st['engine_cache']}")
    if st["retired"] != st["submitted"] or st["occupied"] or st["pending"]:
        fail(f"service {name}: not drained: {st}")
    return counts, specs


def service_phase(torch, np, rt, td, tk, dev):
    """Phase 10: the continuous-batching service on two request streams.
    Returns the launch counts of each checked serve."""
    rng = np.random.default_rng(0)
    rows = rng.integers(*SERVICE_ROWS, size=2 * SERVICE_REQUESTS + SERVICE_MIXED)
    t = time.perf_counter()
    pbs = [td.make_pseudo_boolean(n=60_000, m=int(m), seed=100 + i, unit_frac=0.002)
           for i, m in enumerate(rows[:SERVICE_REQUESTS])]
    bands = [td.make_banded(n=40_000, m=int(m), row_nnz=24, band=5_000, seed=100 + i)
             for i, m in enumerate(rows[SERVICE_REQUESTS:2 * SERVICE_REQUESTS])]
    stream = [p for pair in zip(pbs, bands) for p in pair]
    mixed = [td.make_mixed(m=int(m), n=30_000, seed=100 + i, density=0.0005)
             for i, m in enumerate(rows[2 * SERVICE_REQUESTS:])]
    log(f"service streams: {len(stream)} + {len(mixed)} requests, rows "
        f"{[int(x) for x in rows]}, nnz {sum(p.nnz for p in stream)} + "
        f"{sum(p.nnz for p in mixed)}, generate={time.perf_counter() - t:.1f}s")
    runs = {}
    counts, specs = service_run(torch, np, rt, tk, "stream", stream, dev, slots=SERVICE_SLOTS,
                                size_classes=SERVICE_SIZE_CLASSES)
    runs["service stream"] = counts
    if not any(s.fits_one_chunk for s in specs):
        fail("service stream: no bucket runs the fused round")
    if not all(s.fits_one_chunk for s in specs):
        require_launched({"service stream": counts}, {"service stream": (
            "activities_gather_tiles", "combine_chunk_partials_tiles",
            "candidates_scatter_tiles")})
    counts, _ = service_run(torch, np, rt, tk, "mixed", mixed, dev, slots=2)
    runs["service mixed"] = counts
    return runs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    log(f"gpu: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    smoke(torch, torch.device("cuda"))
    log(f"total: {time.perf_counter() - t0:.1f} s")
    log(f"gpu: {smi}")
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
