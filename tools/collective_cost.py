#!/usr/bin/env python3
"""Time the collectives of the sharded rounds (``repro_torch.core.sharded``)
on one card, in a world of one NCCL rank started by ``run_world`` once per
setting of PyTorch's flight recorder (on, and off as ``run_world`` runs
its ranks).

    python3 tools/collective_cost.py [--calls 200]

Run from the root of a checkout on a machine with a CUDA card.  In each
world it times ``dist.all_reduce`` on the operands of the nnz round at
``mixed``'s size (``chip_smoke.py``: MAX over the 60,000 real columns of a
60,032-column plane, SUM over the stacked (4, 150,000) row aggregates),
blocking as the rounds call it, with ``async_op=True``, and through the
process group's backend object (no Python wrapper): the host's time per
call (enqueue only, ``--calls`` calls back to back) and the card's (CUDA
events around the same calls).  Then, on ``pb``, the fixed point of the row
partition's round closure against the unsharded round closure on the same
prepared tiles (D and F; the sharded one adds its two all-reduces a round),
wall per enqueued round.  Prints medians of 5 and the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# (label, environment) of each world: PyTorch's flight recorder on (a
# buffer of 2,000 collectives' traces) and off, run_world's default.
SETTINGS = (
    ("flight recorder on", {"TORCH_FR_BUFFER_SIZE": "2000"}),
    ("flight recorder off", {"TORCH_FR_BUFFER_SIZE": "0"}),
)
TRIALS = 5


def rank_main(rank, world_size, calls, pb):
    import torch
    import torch.distributed as dist

    import repro_torch as rt
    from repro_torch.core import sharded
    from repro_torch.core.propagator import device_fixed_point
    from repro_torch.kernels import ops

    del rank, world_size
    dev = torch.device("cuda")
    plane = torch.full((60_032,), -1e20, dtype=torch.float64, device=dev)
    rows = torch.zeros((4, 150_000), dtype=torch.float64, device=dev)
    backend = dist.group.WORLD._get_backend(dev)
    opts = dist.AllreduceOptions()
    opts.reduceOp = dist.ReduceOp.MAX
    view = plane[:60_000]

    def timed(fn, n=calls):
        """Medians over TRIALS of (host us, device us) per call of ``fn``."""
        for _ in range(10):
            fn()
        host, device = [], []
        for _ in range(TRIALS):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            t = time.perf_counter()
            for _ in range(n):
                fn()
            host.append((time.perf_counter() - t) / n * 1e6)
            end.record()
            end.synchronize()
            device.append(start.elapsed_time(end) / n * 1e3)
        return statistics.median(host), statistics.median(device)

    def pending(op):
        works = []

        def call():
            works.append(op())
            if len(works) >= 16:
                for w in works:
                    w.wait()
                works.clear()

        return call

    out = {
        "max (60,000 of 60,032) blocking": timed(
            lambda: dist.all_reduce(view, op=dist.ReduceOp.MAX)),
        "max async_op": timed(pending(
            lambda: dist.all_reduce(view, op=dist.ReduceOp.MAX, async_op=True))),
        "max via the backend": timed(pending(lambda: backend.allreduce([view], opts))),
        "sum (4, 150,000) blocking": timed(lambda: dist.all_reduce(rows)),
        "copy_ of the plane (a kernel, for scale)": timed(lambda: plane.copy_(plane)),
    }
    local = sharded._row_shard(pb, 0, 1)
    prep = rt.prepare_block_ell(local, device=dev)
    cfg = rt.core.DEFAULT_CONFIG
    closures = {
        "unsharded round (D, F)": lambda: ops.round_fn_for(prep),
        "row-partition round (D, MAX, MIN, F)": lambda: sharded._sharded_round_fn(
            prep, cfg, None, pb.n, nnz=False),
    }
    for label, make in closures.items():
        round_fn = make()
        enqueued = [0]

        def fixed_point():
            lb, ub = prep.lb0.clone(), prep.ub0.clone()
            counted = [0]

            def counting(lb, ub):
                counted[0] += 1
                return round_fn(lb, ub)

            counting.carry, counting.gated = round_fn.carry, round_fn.gated
            device_fixed_point(counting, lb, ub, cfg.max_rounds)
            enqueued[0] = counted[0]

        host, device = timed(fixed_point, n=1)
        out[label] = (host / enqueued[0], device / enqueued[0])
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--calls", type=int, default=200)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("collective_cost: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT / "tools"))
    import collective_cost
    import repro_torch.data as td
    from repro_torch.core import run_world

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(f"gpu: {smi}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    pb = td.make_pseudo_boolean(n=60_000, m=150_000, seed=0)
    for label, env in SETTINGS:
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            (out,) = run_world(collective_cost.rank_main, 1, backend="nccl", device="cuda",
                               args=(args.calls, pb), timeout=600)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        for what, (host, device) in out.items():
            print(f"{label}: {what}: host {host:.1f} us, card {device:.1f} us a call "
                  f"(or a round), medians of {TRIALS}", flush=True)
    print(f"gpu: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
