"""The cases of ``test_torch_sharded.py`` as one rank runs them: every
sharded entry point of the port on every instance, at float64 and float32,
on the CPU (or, for the GPU tests, on the card).  A world of ranks started by
``repro_torch.core.run_world`` imports this module (not the test file,
which imports JAX) and returns its results to the test process.

The instances are built here and in the test from the same generator names
and seeds, by both packages' byte-identical generators."""
import numpy as np

# name -> (generator, kwargs, exact): exact families keep every sum an
# integer, so any summation order gives the same bits.
CASES = {
    "cascade": ("make_cascade_chain", dict(length=24), True),
    "pb": ("make_pseudo_boolean", dict(n=40, m=30, seed=0), True),
    "set_cover": ("make_set_cover", dict(n=40, m=16, seed=1), True),
    "knapsack": ("make_knapsack", dict(n=40, m=12, seed=2), True),
    "mixed": ("make_mixed", dict(m=60, n=45, seed=1), False),
    "banded": ("make_banded", dict(n=120, m=40, row_nnz=10, band=30, seed=0), False),
}
# Batches: more instances than the largest world, and fewer (idle ranks).
BATCHES = {
    "six": ("knapsack", "set_cover", "pb", "mixed", "cascade", "banded"),
    "two": ("knapsack", "pb"),
}
DTYPES = ("float64", "float32")
# Rows of up to 40 nonzeros span up to five chunks: ranks run D or A'/E.
TILE_WIDTH = 8
# The warm-start twin of the reference's test_sharded_warm_start_identity.
WARM = ("make_mixed", dict(m=60, n=50, seed=5))


def build(data, name: str):
    gen, kw, _ = CASES[name]
    return getattr(data, gen)(**kw)


def cases(rank: int, world_size: int, device: str = "cpu") -> dict:
    """Every sharded result of this rank, keyed ``(entry, case, dtype)``."""
    del rank, world_size
    import repro_torch.core as rc
    import repro_torch.data as td

    problems = {name: build(td, name) for name in CASES}
    kw = dict(tile_width=TILE_WIDTH, device=device)
    out = {}
    for dt in DTYPES:
        for name, p in problems.items():
            out[("nnz", name, dt)] = rc.propagate_sharded(p, dtype=np.dtype(dt), **kw)
            out[("rows", name, dt)] = rc.propagate_sharded_rows(p, dtype=np.dtype(dt), **kw)
        for batch, members in BATCHES.items():
            out[("batch", batch, dt)] = rc.propagate_batch_sharded(
                [problems[name] for name in members], dtype=np.dtype(dt), **kw)
    gen, wkw = WARM
    p = getattr(td, gen)(**wkw)
    out[("warm", "base", "float64")] = rc.propagate_sharded(p, device=device)
    out[("warm", "warm", "float64")] = rc.propagate_sharded(p, lb0=p.lb, ub0=p.ub,
                                                            device=device)
    return out


def hang(rank: int, world_size: int) -> None:
    """Rank 0 waits in a collective that rank 1 never joins."""
    import time

    import torch
    import torch.distributed as dist

    if rank == 0:
        dist.all_reduce(torch.zeros(1))
    else:
        time.sleep(3600)


def fail(rank: int, world_size: int) -> int:
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    return rank


def launches(rank: int, world_size: int, device: str = "cuda") -> dict:
    """The kernel launches of one run of each sharded path on this rank:
    the nnz partition and the row partition of ``mixed`` and ``pb``, the
    batch partition of ``BATCHES["six"]``."""
    del rank, world_size
    import repro_torch.core as rc
    import repro_torch.data as td
    from repro_torch.kernels import launch_counts, reset_launch_counts

    runs = {
        "nnz mixed": lambda: rc.propagate_sharded(build(td, "mixed"), device=device,
                                                   tile_width=TILE_WIDTH),
        "rows pb": lambda: rc.propagate_sharded_rows(build(td, "pb"), device=device,
                                                     tile_width=TILE_WIDTH),
        "rows knapsack": lambda: rc.propagate_sharded_rows(build(td, "knapsack"),
                                                           device=device, tile_width=TILE_WIDTH),
        "batch six": lambda: rc.propagate_batch_sharded(
            [build(td, name) for name in BATCHES["six"]], device=device, tile_width=TILE_WIDTH),
    }
    out = {}
    for label, run in runs.items():
        reset_launch_counts()
        run()
        out[label] = {k: v for k, v in launch_counts().items() if v}
    return out
