#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Run from the root of a checkout.  It imports ``src/repro_torch`` (torch and
numpy only, nothing of JAX) and, on one CUDA card:

  1. prints the card's name and power limit, builds the CUDA kernels of
     ``src/repro_torch/csrc/prop_round.cu`` from source and prints the
     build time and the compiler's register report;
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
  9. prints a ``kernels`` JSON line, and last
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

SOURCE = "src/repro_torch/csrc/prop_round.cu"
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
}
# The C entry point that launches each wrapper's kernel.
SYMBOL = {
    "fused_scatter_round_tiles": "fused_scatter_round",
    "activities_gather_tiles": "activities_gather",
    "candidates_scatter_tiles": "candidates_scatter",
    "apply_updates_tiles": "apply_updates",
    "combine_chunk_partials_tiles": "combine_chunk_partials",
    "node_fused_scatter_round_tiles": "node_fused_scatter_round",
    "apply_updates_batch_tiles": "apply_updates_batch",
    "node_objective_tiles": "node_objective",
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


def kernel_ms(torch, build, fn, reps: int = 20, reset=None) -> float:
    """Median device time of the one kernel launch in each of ``reps`` calls
    of the wrapper call ``fn``.  Each call is queued behind a sleep on the
    card, so no host time falls between the events around the launch;
    ``reset`` (untimed) runs before each call."""
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
    if len(timed.pairs) != reps:
        fail(f"timed {len(timed.pairs)} launches, expected {reps}")
    return statistics.median(start.elapsed_time(end) for start, end in timed.pairs)


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
        f"cached={info.get('cached')}) -> {_build.library_path()}")
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
    }
    kernels = []
    for fn in tk.KERNELS:
        k = fn.__name__
        r = measured[k][primary[k]]
        kernels.append(dict(
            name=k, route="cuda", source=SOURCE, replaces=REPLACES[k],
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
