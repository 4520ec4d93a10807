"""Presolve-service example on the PyTorch port: a CONTINUOUS-BATCHING
propagation service (``repro_torch.core.PropagationService``) serving a
Poisson request stream -- the "serving" shape of the paper's technique (a
presolver processes streams of subproblems arriving at unpredictable times).

Instances stream through per-bucket device-resident super-tiles: each
request is admitted into a free slot on the device, converged instances
retire while co-resident instances keep iterating, and freed slots are
backfilled from the queue.  Contrast with the fixed-batch shape
(``propagate_batch``), which must collect the whole batch before
dispatching and holds every result until the slowest instance converges.

  PYTHONPATH=src python examples/torch_presolve_service.py               # the card
  PYTHONPATH=src python examples/torch_presolve_service.py --device cpu  # plain PyTorch

Prints the lines of ``examples/presolve_service.py`` from the same seeded
instances and arrival times.  On the card the buckets run the port's CUDA
kernels (the reference example runs its jnp engine); on the CPU the kernel
wrappers take their plain versions.
"""
import argparse
import time

import numpy as np

from repro_torch.core import PropagationService, analyze_constraints
from repro_torch.core.propagator import DeviceProblem
from repro_torch.data import make_bin_packing, make_knapsack, make_mixed, make_set_cover

REQUESTS = [
    ("knapsack_1", make_knapsack(n=60, m=12, seed=1)),
    ("knapsack_2", make_knapsack(n=70, m=14, seed=11)),
    ("set_cover_1", make_set_cover(n=80, m=25, seed=2)),
    ("set_cover_2", make_set_cover(n=90, m=30, seed=12)),
    ("bin_packing", make_bin_packing(items=20, bins=6, seed=3)),
    ("mixed_1", make_mixed(m=300, n=220, seed=4)),
    ("mixed_2", make_mixed(m=500, n=400, seed=5)),
    ("mixed_3", make_mixed(m=300, n=220, seed=6)),
    ("mixed_4", make_mixed(m=500, n=400, seed=7)),
    ("mixed_5", make_mixed(m=320, n=240, seed=8)),
]

MEAN_ARRIVAL_S = 0.003  # Poisson request stream: ~330 requests/sec offered


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    dev = parser.parse_args().device

    names = [nm for nm, _ in REQUESTS]
    problems = [p for _, p in REQUESTS]

    # Size the slot pool from the sample population: one bucket per padded
    # column class, split into tile-count quantiles so small instances get
    # tight slots.  Construction builds every bucket's engine up front.
    t0 = time.perf_counter()
    svc = PropagationService.from_problems(problems, slots=2, size_classes=2, device=dev)
    print(
        f"service up in {time.perf_counter() - t0:.1f}s: "
        + ", ".join(
            f"bucket[n_pad={b['n_pad']} tiles={b['slot_tiles']}x{b['slots']}slots]"
            for b in svc.stats()["buckets"]
        )
    )

    # Background device loop: pumps admissions/steps/retirements continuously;
    # the client thread only submits and waits on tickets.
    with svc:
        rng = np.random.default_rng(0)
        tickets = []
        t0 = time.perf_counter()
        for name, p in REQUESTS:
            time.sleep(rng.exponential(MEAN_ARRIVAL_S))
            tickets.append(svc.submit(p))
        results = [tk.result(timeout=60.0) for tk in tickets]
        wall = time.perf_counter() - t0

    lat = np.asarray([tk.latency() for tk in tickets]) * 1e3
    print(
        f"served {len(tickets)} requests in {wall * 1e3:.1f} ms wall "
        f"({len(tickets) / wall:.0f} instances/sec with Poisson arrivals)\n"
        f"latency p50={np.percentile(lat, 50):.1f}ms "
        f"p95={np.percentile(lat, 95):.1f}ms max={lat.max():.1f}ms"
    )
    st = svc.stats()
    print(
        f"retired={st['retired']} pending={st['pending']} "
        f"mean occupancy={np.mean([b['mean_occupancy'] for b in st['buckets']]):.2f} "
        f"engine cache: {st['engine_cache']}\n"
    )

    print(f"{'instance':12s} {'m':>6s} {'n':>6s} {'nnz':>8s} {'rounds':>6s} "
          f"{'tightened':>9s} {'redundant':>9s} {'infeas':>6s}")
    for name, p, r in zip(names, problems, results):
        lb, ub = r.lb.cpu().numpy(), r.ub.cpu().numpy()
        tightened = int(np.sum(lb > p.lb + 1e-9) + np.sum(ub < p.ub - 1e-9))
        dp = DeviceProblem(p, device=dev)
        verdict = analyze_constraints(
            dp.row_id, dp.val, dp.col, dp.lhs, dp.rhs, r.lb, r.ub, p.m
        )
        print(
            f"{name:12s} {p.m:6d} {p.n:6d} {p.nnz:8d} {int(r.rounds):6d} "
            f"{tightened:9d} {int(verdict.redundant.sum()):9d} "
            f"{str(bool(r.infeasible)):>6s}"
        )


if __name__ == "__main__":
    main()
