"""Distributed propagation on torch.distributed: the equal-nnz partition of
``propagate_sharded`` on a world of 4 ranks of this host, against the
single-device ``propagate``.

  PYTHONPATH=src python examples/torch_distributed_propagation.py               # the card
  PYTHONPATH=src python examples/torch_distributed_propagation.py --device cpu  # gloo, CPU

On the card the ranks take ``nccl`` where there is a card for each, and
``gloo`` (every collective staged through the host) where they share fewer.
"""
import argparse

import numpy as np
import torch

from repro_torch.core import bounds_equal, propagate, propagate_sharded, run_world
from repro_torch.data import make_mixed

WORLD = 4


def instance():
    return make_mixed(m=2000, n=1500, seed=42)


def rank_main(rank, world_size, device):
    del rank, world_size
    return propagate_sharded(instance(), device=device)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args()
    if args.device == "cuda" and torch.cuda.device_count() >= WORLD:
        backend = "nccl"
    else:
        backend = "gloo"
    print(f"world: {WORLD} ranks ({backend}, {args.device})")

    p = instance()
    print(f"instance: m={p.m} n={p.n} nnz={p.nnz}")

    r1 = propagate(p, driver="device_loop", device=args.device)
    r2 = run_world(rank_main, WORLD, backend=backend, device=args.device,
                   args=(args.device,))[0]

    print(f"single-device : rounds={int(r1.rounds)} converged={bool(r1.converged)}")
    print(f"sharded ({WORLD})   : rounds={int(r2.rounds)} converged={bool(r2.converged)}")
    print("limit points equal:", bounds_equal(r1.lb, r1.ub, r2.lb, r2.ub))
    tight = int(np.sum(r2.lb > p.lb + 1e-9) + np.sum(r2.ub < p.ub - 1e-9))
    print(f"bounds tightened: {tight}")


if __name__ == "__main__":
    main()
