"""Device-resident branch-and-bound vs a level-by-level Python driver, on the
PyTorch port.

``repro_torch.core.solve`` keeps the WHOLE search on the device: node pool,
branching-variable selection, incumbent and pruning all live in a search
carry on the device, and the host is consulted only every ``sync_every``
levels.  This example solves one pseudo-boolean instance twice:

  1. with ``solve()`` -- one device-resident search, ``ceil(levels/sync_every)``
     host syncs, per-level telemetry read back at the end;
  2. with a Python loop that propagates each frontier level in one
     ``propagate_nodes`` dispatch but does ALL search bookkeeping
     (branching, incumbent, pruning) in host numpy, syncing every level.

Branching is deterministic in both drivers (``pick_most_fractional``, ties
to the lowest column index), so both searches find the same optimum and the
comparison isolates the cost of hosting the search loop.

  PYTHONPATH=src python examples/torch_bnb_dive.py               # the card: CUDA kernels
  PYTHONPATH=src python examples/torch_bnb_dive.py --device cpu  # plain PyTorch versions

Prints the lines of ``examples/bnb_dive.py``; where that example takes the
Pallas kernels on a TPU and its jnp engine elsewhere, this one runs the
port's CUDA kernels on the card and their plain versions on the CPU (the
kernel wrappers take their plain versions on CPU tensors).
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core import (
    INF,
    branch_children,
    pick_most_fractional,
    propagate_nodes,
    solve,
)
from repro_torch.data import make_pseudo_boolean

NODE_CAP = 512
MAX_LEVELS = 64
SYNC_EVERY = 8
# Pseudo-boolean rows carry <= 8 nonzeros; tiling at the row width keeps the
# block-ELL padding (and with it every per-round sweep) proportional to nnz.
TILE = dict(tile_rows=8, tile_width=8)


def sync(dev):
    if dev == "cuda":
        torch.cuda.synchronize()


def python_bnb(p, c, dev):
    """The hosted search: device propagation per level, numpy bookkeeping.

    Same branching rule, branch point and pruning test as ``solve()``, so
    it visits an equivalent tree -- but the frontier, incumbent and slot
    logic live on the host, one sync (plus numpy passes) per level."""
    frontier = [(np.asarray(p.lb, np.float64), np.asarray(p.ub, np.float64))]
    inc, inc_x = INF, None
    created, levels, syncs = 1, 0, 0
    while frontier and levels < MAX_LEVELS:
        levels += 1
        lbs = np.stack([n[0] for n in frontier])
        ubs = np.stack([n[1] for n in frontier])
        out = propagate_nodes(p, lbs, ubs, device=dev, **TILE)
        lbs, ubs = out.lb.cpu().numpy(), out.ub.cpu().numpy()
        infeas = out.infeasible.cpu().numpy()
        syncs += 1  # readback before ANY host-side search decision
        nxt = []
        for i in range(lbs.shape[0]):
            if infeas[i]:
                continue
            lb, ub = lbs[i], ubs[i]
            obj = float(np.sum(np.where(c > 0, c * lb, c * ub)))
            if obj >= inc:
                continue
            var = pick_most_fractional(lb, ub, p.is_int)
            if var is None:
                inc, inc_x = obj, lb.copy()
                continue
            bv = np.clip(np.floor(0.5 * (lb[var] + ub[var])), lb[var],
                         ub[var] - 1.0)
            down, up = branch_children(lb, ub, var, float(bv))
            nxt += [down, up]
            created += 2
        frontier = nxt[:NODE_CAP]
    return inc, inc_x, created, levels, syncs


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    dev = parser.parse_args().device

    # Default clause mix: unit clauses give propagation traction, so leaves
    # seed the incumbent early and bound pruning keeps the pool small.
    root = make_pseudo_boolean(n=48, m=96, seed=0)
    sign = np.where(np.arange(root.n) % 3 == 0, -1.0, 1.0)
    c = np.arange(1, root.n + 1, dtype=np.float64) * sign
    print(f"root: m={root.m} n={root.n} nnz={root.nnz} (pseudo-boolean, all binary)")

    # --- 1. device-resident search -------------------------------------------

    kw = dict(
        node_cap=NODE_CAP, max_levels=MAX_LEVELS, sync_every=SYNC_EVERY,
        telemetry=MAX_LEVELS, device=dev, **TILE,
    )
    if dev == "cuda":  # warm-up: build the kernels; the CPU has none to build
        solve(root, c, **kw)
        sync(dev)
    t0 = time.perf_counter()
    res = solve(root, c, **kw)
    sync(dev)
    dt_dev = time.perf_counter() - t0

    tel = res.telemetry.summary()
    print("\ndevice-resident solve():")
    print(f"  status={res.status} objective={res.objective}")
    print(
        f"  {res.nodes_expanded} expanded / {res.nodes_created} created "
        f"({res.leaves} leaves, {res.pruned_bound} bound-pruned, "
        f"{res.pruned_infeasible} infeasible)"
    )
    print(
        f"  {res.levels} levels, {res.host_syncs} host syncs "
        f"(sync_every={SYNC_EVERY}), incumbent trajectory "
        f"{res.incumbent_trajectory}"
    )
    print(
        f"  telemetry: first incumbent at level {tel['stop_round']}, "
        f"first fathom at level {tel['infeasible_round']}"
    )
    print(
        f"  {res.nodes_created} nodes in {dt_dev * 1e3:.1f} ms -> "
        f"{res.nodes_created / dt_dev:.0f} nodes/sec"
    )

    # --- 2. level-by-level Python driver -------------------------------------

    if dev == "cuda":  # warm-up, as for solve()
        python_bnb(root, c, dev)
        sync(dev)
    t0 = time.perf_counter()
    inc, inc_x, created, levels, syncs = python_bnb(root, c, dev)
    sync(dev)
    dt_py = time.perf_counter() - t0

    print("\nlevel-by-level Python driver (same rule, same branch points):")
    print(f"  objective={inc} ({created} nodes, {levels} levels, {syncs} syncs)")
    print(
        f"  {created} nodes in {dt_py * 1e3:.1f} ms -> "
        f"{created / dt_py:.0f} nodes/sec"
    )

    assert inc == res.objective, (inc, res.objective)
    ratio = (res.nodes_created / dt_dev) / (created / dt_py)
    print(
        f"\nsame optimum, {res.host_syncs} vs {syncs} host syncs -> "
        f"device-resident search is {ratio:.1f}x on nodes/sec here"
    )
    print(
        "(wide trees saturate both drivers on CPU propagation arithmetic; on "
        "deep narrow dives, where per-level host overhead dominates, the "
        "`solver` row of BENCH_prop.json measures the payoff of hosting the "
        "loop on device)"
    )


if __name__ == "__main__":
    main()
