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
     the plain-version path where rows fit one chunk, under ``bounds_equal``
     otherwise and against ``propagate``, which sums in another order; on
     ``pb`` also bitwise against ``propagate`` over the rounds whose sums are
     exact; then one warm-started branch-and-bound node on ``pb``;
  5. prints per-round times, host syncs per fixed point, a ``kernels`` JSON
     line, and last ``{"ok": true, "device": {...}}``.

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

SOURCE = "src/repro_torch/csrc/prop_round.cu"
REPLACES = {
    "fused_scatter_round_tiles": "src/repro/kernels/prop_round.py:580",
    "activities_gather_tiles": "src/repro/kernels/prop_round.py:269",
    "candidates_scatter_tiles": "src/repro/kernels/prop_round.py:651",
    "apply_updates_tiles": "src/repro/kernels/prop_round.py:721",
}
# The C entry point that launches each wrapper's kernel.
SYMBOL = {
    "fused_scatter_round_tiles": "fused_scatter_round",
    "activities_gather_tiles": "activities_gather",
    "candidates_scatter_tiles": "candidates_scatter",
    "apply_updates_tiles": "apply_updates",
}
# Nominal float64 operations per real nonzero (products, sums, residual
# subtractions, divisions, rounding) -- the compute side of each bound.
OPS_PER_NNZ = {
    "fused_scatter_round_tiles": 16,
    "activities_gather_tiles": 4,
    "candidates_scatter_tiles": 12,
    "apply_updates_tiles": 0,
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


def kernel_ms(torch, build, fn, reps: int = 20) -> float:
    """Median device time of the one kernel launch in each of ``reps`` calls
    of the wrapper call ``fn``.  Each call is queued behind a sleep on the
    card, so no host time falls between the events around the launch."""
    real = build.lib
    timed = EventTimedLib(torch, real())
    build.lib = lambda: timed
    try:
        for _ in range(reps):
            torch.cuda._sleep(1_000_000)
            fn()
        torch.cuda.synchronize()
    finally:
        build.lib = real
    if len(timed.pairs) != reps:
        fail(f"timed {len(timed.pairs)} launches, expected {reps}")
    return statistics.median(start.elapsed_time(end) for start, end in timed.pairs)


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


def bound(name: str, nbytes: int, nnz: int) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = OPS_PER_NNZ[name] * nnz / F64_FLOPS * 1e3
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
    return dict(bounds=2 * vec, best=2 * vec, out=2 * vec + 1)


def check_kernels(torch, tk, tref, ops, build, name, p, prep, lb, ub, timed):
    """Each kernel of the instance's branch against its plain version on the
    card, on the tiles of ``prep`` and the padded bounds ``lb``/``ub``;
    ``timed`` also times both.  Returns {kernel: row of measurements}."""
    d = prep.d
    n_pad, cfg = prep.n_pad, ops.DEFAULT_CONFIG
    nnz = int((d.val != 0).sum().item())  # real nonzeros in the tiles
    rows = {}

    def row(kname, got, want, fn_k, fn_p):
        r = dict(instance=name, max_abs_err=max_abs_err(torch, got, want))
        if timed:
            moved = needed_bytes(kname, prep, nnz)
            b_ms, b_by = bound(kname, sum(moved.values()), nnz)
            r.update(ms=kernel_ms(torch, build, fn_k), wrapper_ms=time_ms(torch, fn_k),
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
        aggs = ops._combine_chunk_partials(prep, *want)
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
    # Timed on scratch copies: after the first call nothing tightens, but
    # every call still reads all four vectors.
    lbw, ubw = lb.clone(), ub.clone()
    row("apply_updates_tiles", got, want,
        lambda: tk.apply_updates_tiles(lbw, ubw, best_l, best_u, eps),
        lambda: ops.bnd.apply_updates(lb, ub, best_l, best_u, eps))
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
    launches = tk.launch_counts()

    need = {
        "pb": ("fused_scatter_round_tiles", "apply_updates_tiles"),
        "banded": ("fused_scatter_round_tiles", "apply_updates_tiles"),
        "mixed": ("activities_gather_tiles", "candidates_scatter_tiles", "apply_updates_tiles"),
    }
    for name, kernels in need.items():
        for k in kernels:
            if per_instance[name][k] <= 0:
                fail(f"main path on {name} never launched {k}")
    if any(v <= 0 for v in launches.values()):
        fail(f"a kernel of the main path was never launched: {launches}")
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
        # Same tiles and summation order: bitwise, except where rows span
        # three or more chunks, whose partials index_add_ sums in no fixed
        # order.
        check_same(rt, name, results[name], plain, prep.fits_one_chunk, "the plain-version path")
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
        items = device_items(torch, lambda: rt.propagate_block_ell(p, device=dev))
        if not items:
            log(f"profile {name}: the profiler recorded no device time; idle share not measured")
            continue
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
        log(f"profile {name}: device busy {busy:.3f} ms of {k_ms:.3f} ms fixed point, "
            f"idle share {1 - busy / k_ms:.3f}; top: {top}")

    primary = {
        "fused_scatter_round_tiles": "pb", "apply_updates_tiles": "pb",
        "activities_gather_tiles": "mixed", "candidates_scatter_tiles": "mixed",
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
