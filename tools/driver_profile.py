#!/usr/bin/env python3
"""Profile the single-instance fixed points under both loop drivers in a
fresh process: for each run, wall, device busy time and idle share from ONE
traced call (CUDA events around the call inside its ``torch.profiler``
trace), the median untraced wall beside it, and the host's enqueue time
per round, timed directly.

    python3 tools/driver_profile.py [--runs pb,segment pb,...] [--reps 9] [--tries 5]

Run from the root of a checkout on a machine with a CUDA card and nvcc.
The runs are ``chip_smoke.py`` phase 12's: ``propagate_block_ell`` with its
defaults on ``pb``, ``banded``, ``mixed``, ``bandw`` and ``pbw``, and with
``scatter="segment"`` on the first three.  Each run is warmed on both
drivers first.  A trace counts as complete when it holds every carry merge
(F's or #15's) that the driver launches, and is retried up to ``--tries``
times otherwise; traces taken late in a long process (``chip_smoke.py``'s
last phase) have missed device items, hence a fresh process.  The
profiler adds host time to every launch, so the traced wall exceeds the
untraced one (``--reps`` calls, both drivers interleaved) and the traced
idle share is an upper bound.  Prints the card's name and power limit.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def enqueued(rounds: int, group: int, max_rounds: int) -> int:
    """Rounds that device_loop enqueues (and merges it launches) for a fixed
    point of ``rounds``: whole read groups of ``group``, at most
    ``max_rounds``."""
    return min(-(-rounds // group) * group, max_rounds)


def traced_call(torch, fn, merges: int, tries: int):
    """``(wall ms, device busy ms, the four largest items, carry merges in
    the trace, tries)`` of ONE call of ``fn`` under ``torch.profiler``
    (device activity only): the wall by CUDA events around the call inside
    the trace, the busy time the sum of the trace's device items.  Retried
    until the trace holds all ``merges`` carry merges; the last trace is
    returned either way, its merge count beside it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, tries + 1):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
        items = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        found = sum("CarryFlags" in name for name, _ in items)
        if found != merges and attempt < tries:
            continue
        by_name = {}
        for item, us in items:
            key = item.replace("(anonymous namespace)::", "").split("(")[0][:48]
            total, n = by_name.get(key, (0.0, 0))
            by_name[key] = (total + us, n + 1)
        top = ", ".join(f"{key} {total / 1e3:.3f} ms x{n}" for key, (total, n) in
                        sorted(by_name.items(), key=lambda kv: -kv[1][0])[:4])
        return start.elapsed_time(end), sum(us for _, us in items) / 1e3, top, found, attempt


def enqueue_us(torch, ops, prep, scatter: str, rounds: int, trials: int = 5) -> float:
    """The host's time to enqueue one round of the device loop, timed
    directly: ``perf_counter`` around ``rounds`` calls of the engine's round
    closure on an armed carry, with no synchronisation inside (the card
    waits for the host, never the reverse, at these depths); median over
    ``trials`` per-round means, in microseconds."""
    fn = ops.round_fn_for(prep, scatter=scatter)
    out = []
    for _ in range(trials + 1):
        lb, ub = prep.lb0.clone(), prep.ub0.clone()
        fn.carry.arm(lb.device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(rounds):
            lb, ub, _ = fn(lb, ub)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        fn.carry.release()
        out.append((t1 - t0) / rounds * 1e6)
    return statistics.median(out[1:])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", default="")
    ap.add_argument("--reps", type=int, default=9)
    ap.add_argument("--tries", type=int, default=5)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("driver_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    import repro_torch as rt
    import repro_torch.data as td
    from repro_torch.core import propagator as rt_prop
    from repro_torch.kernels import ops

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"gpu: {smi}", flush=True)
    dev = torch.device("cuda")
    problems = {name: getattr(td, gen)(**kw) for name, gen, kw in cs.SPECS + cs.WIDE_SPECS}
    cases = [(name, name, {}) for name in ("pb", "banded", "mixed", "bandw", "pbw")]
    cases += [(f"segment {name}", name, dict(scatter="segment"))
              for name in ("pb", "banded", "mixed")]
    picked = {x for x in args.runs.split(",") if x}
    max_rounds = rt_prop.DEFAULT_CONFIG.max_rounds
    for label, name, kw in cases:
        if picked and label not in picked:
            continue
        p = problems[name]
        prep = rt.prepare_block_ell(p, device=dev)
        run = lambda driver: rt.propagate_block_ell(p, driver=driver, device=dev, **kw)
        rounds = int(run("host_loop").rounds)
        run("device_loop")
        group = rt_prop.loop_group(ops.round_fn_for(prep, scatter=kw.get("scatter", "auto")))
        walls = {"host_loop": [], "device_loop": []}
        for _ in range(args.reps):
            for driver in walls:
                walls[driver].append(cs.wall_ms(torch, lambda: run(driver)))
        for driver in walls:
            merges = rounds if driver == "host_loop" else enqueued(rounds, group, max_rounds)
            wall, busy, top, found, tries = traced_call(torch, lambda: run(driver), merges,
                                                        args.tries)
            state = "complete" if found == merges else f"INCOMPLETE, {found} of {merges} merges"
            print(f"{label} {driver}: rounds {rounds}, one traced call ({state}; try {tries}): "
                  f"wall {wall:.3f} ms, device busy {busy:.3f} ms, idle share "
                  f"{1 - busy / wall:.3f}; untraced wall {statistics.median(walls[driver]):.3f} "
                  f"ms (median of {args.reps}); top: {top}", flush=True)
        us = enqueue_us(torch, ops, prep, kw.get("scatter", "auto"), rounds)
        print(f"{label}: host enqueue {us:.1f} us a round over {rounds} rounds (read group "
              f"{group})", flush=True)
    print(f"gpu: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
