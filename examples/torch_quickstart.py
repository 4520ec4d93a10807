"""Quickstart: propagate a small MIP with the paper's parallel algorithm,
on the PyTorch port.

  PYTHONPATH=src python examples/torch_quickstart.py               # the card
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu  # plain PyTorch

Prints the lines of ``examples/quickstart.py``.  The port runs eagerly, so
it caches prepared instances but has no compiled fixed-point runner: its
``cache_info()`` line for ``block_ell_runner`` says so instead of counting.
"""
import argparse

import numpy as np

from repro_torch.core import INF, Problem, csr_from_dense, propagate, propagate_sequential
from repro_torch.kernels import cache_info, propagate_block_ell

# A tiny MIP:  min c^T x  s.t.
#   2x + 3y        <= 6
#    x +  y +  z   >= 1
#        4y -  z   == 2      (as ranged row 2 <= . <= 2)
# x,y integer in [0,10], z continuous in [0,8].
A = np.array(
    [
        [2.0, 3.0, 0.0],
        [1.0, 1.0, 1.0],
        [0.0, 4.0, -1.0],
    ]
)
problem = Problem(
    csr=csr_from_dense(A),
    lhs=np.array([-INF, 1.0, 2.0]),
    rhs=np.array([6.0, INF, 2.0]),
    lb=np.zeros(3),
    ub=np.array([10.0, 10.0, 8.0]),
    is_int=np.array([True, True, False]),
)


def host(x):
    return x.cpu().numpy()


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    dev = parser.parse_args().device

    print("initial domains:")
    for j, (l, u) in enumerate(zip(problem.lb, problem.ub)):
        print(f"  x{j} in [{l:g}, {u:g}]")

    # GPU-parallel algorithm (Alg. 2): the fixed point's loop state stays on
    # the device, read once per group of rounds.
    result = propagate(problem, driver="device_loop", device=dev)
    print(f"\nparallel propagation: {int(result.rounds)} rounds, "
          f"converged={bool(result.converged)}, infeasible={bool(result.infeasible)}")
    for j, (l, u) in enumerate(zip(host(result.lb), host(result.ub))):
        print(f"  x{j} in [{l:g}, {u:g}]")

    # Sequential reference (Alg. 1, with constraint marking).
    seq = propagate_sequential(problem)
    print(f"\nsequential reference: {seq.rounds} rounds -- bounds match: "
          f"{np.allclose(seq.lb, host(result.lb)) and np.allclose(seq.ub, host(result.ub))}")

    # --- Warm start: the tree-search pattern ---------------------------------
    # A branch-and-bound node differs from its parent by ONE branching bound.
    # Bounds are RUNTIME arguments of every driver, so a node propagates on
    # the SAME prepared tiles -- nothing is repacked.  Here: the kernel-backed
    # engine, first the root, then a child with y fixed to 0.
    root = propagate_block_ell(problem, device=dev)   # prepares once
    child_lb = host(root.lb).copy()
    child_ub = host(root.ub).copy()
    child_ub[1] = 1.0                                  # branch down: y <= 1
    child = propagate_block_ell(problem, lb0=child_lb, ub0=child_ub, device=dev)
    print(f"\nwarm-started child (y <= 1): infeasible={bool(child.infeasible)}, "
          f"rounds={int(child.rounds)}")
    for j, (l, u) in enumerate(zip(host(child.lb), host(child.ub))):
        print(f"  x{j} in [{l:g}, {u:g}]")

    # The second call hit the prepared-instance LRU.
    info = cache_info()
    print("\ncache_info():")
    for name in ("prepare_block_ell", "block_ell_runner"):
        c = info.get(name)
        if c is None:
            print(f"  {name}: none (PyTorch runs eagerly: no compiled runner to cache)")
            continue
        print(f"  {name}: hits={c['hits']} misses={c['misses']} size={c['size']}")


if __name__ == "__main__":
    main()
