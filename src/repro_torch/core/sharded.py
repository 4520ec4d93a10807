"""Distributed domain propagation over ``torch.distributed`` (the reference's
``src/repro/core/sharded.py``, which runs under ``shard_map``).

Every rank of a process group calls an entry point with the same
``Problem``, builds the same partition from it on its host, takes its own
shard and returns the same (replicated) result.  The bound vectors, O(n),
live whole on every rank; the nonzeros are split.

One round of the equal-nnz partition (:func:`propagate_sharded`), on the
kernels of the fused engine's multi-chunk round (``kernels.ops``):

  1. kernel A' over the rank's nonzeros, whose local problem keeps all
     ``m`` rows (row ids stay global, most rows empty), then the long-row
     combine: each row's partial aggregates on this rank;
  2. one all-reduce SUM of the four ``(m,)`` row aggregates, stacked (the
     counts in the value type, exact);
  3. kernel E: the candidates from the completed aggregates, and each
     column's max/min over this rank's nonzeros into the kept planes;
  4. all-reduce MAX of ``best_l`` and MIN of ``best_u`` over the ``n`` real
     columns, in place: the paper's atomic column max/min across ranks;
  5. kernel F, which merges, hands the planes back and keeps the loop carry.

Kernel D cannot serve here: a row's sums must be complete across ranks
before any candidate is formed.  The row partition
(:func:`propagate_sharded_rows`) puts whole rows on a rank (greedy,
nnz-balanced), so its rows complete locally: D (or A', the combine and E
where its rows span chunks), the MAX/MIN all-reduce, then F.  The batch
partition (:func:`propagate_batch_sharded`) balances whole instances
across the ranks; each runs the port's batched engine on its share, with
no collective, and all-gathers hand every rank the whole list.

The single-instance fixed points run on ``core.propagator.
device_fixed_point`` at one round a check group, so ``rounds`` is the
reference's count.  Every rank holds the same bounds and so reads the same
loop carry at the same round; the collectives run in every enqueued round,
including those enqueued after convergence (whose kernels return at once
and whose collectives reduce sentinel planes), so every rank makes the same
collectives.

No outward widening: the reference's sharded rounds merge float32 and
bfloat16 bounds exactly (``bounds.apply_updates`` with no ``outward``, and
its ``batched_reference_round`` at ``outward=0.0``), and so do these,
unlike ``propagate`` and ``propagate_block_ell`` at those types.

At bfloat16 and float16 the ranks run the kernels' 16-bit forms; the
column planes they all-reduce (MAX / MIN) are the kept float32 planes,
which hold 16-bit values exactly, and the nnz partition's SUM of the
stacked ``(4, m)`` row aggregates runs at the aggregates' 16-bit type, its
counts held exactly (up to 256 at bfloat16, 2,048 at float16; a larger
count rounds to another count of at least 2, which the candidates read
alike).  On one rank that sum is the identity; over several it is the
backend's own order (ring or tree), each add rounded to the type, so the
bounds may differ from one rank's in the last bit where a row's partial
sums are inexact.

:func:`run_world` starts a world of processes on this host, the
counterpart of ``jax.make_mesh`` plus the single controller's dispatch.
Imports torch, torch.distributed and numpy only.
"""
from __future__ import annotations

import dataclasses
import math
import multiprocessing
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from .carry import LoopCarry
from .lru import LRU
from .propagator import _result, check_dtype, device_fixed_point, resolve_device, round_scalars
from .sparse import CSR, Problem, col_pad, pack_problems
from .types import DEFAULT_CONFIG, INF, PropagationResult, PropagatorConfig


# ---------------------------------------------------------------------------
# Partitions (host numpy; the reference's, array for array)
# ---------------------------------------------------------------------------


def partition_nnz(p: Problem, num_shards: int):
    """Equal-nnz padding + partition. Returns flat (padded) nnz arrays:
    ``(row_id, col, val)``, shard ``s`` owning ``[s * per, (s + 1) * per)``;
    the padding (``val == 0``, row and column 0) contributes nothing."""
    csr = p.csr
    nnz = csr.nnz
    per = -(-nnz // num_shards)
    pad = per * num_shards - nnz

    def padf(x, fill):
        return np.concatenate([x, np.full(pad, fill, dtype=x.dtype)])

    return padf(csr.row_ids(), 0), padf(csr.col, 0), padf(csr.val, 0)


def _greedy(order, weights, num_shards: int) -> list:
    """Items in ``order`` to the least-loaded shard each, a shard's load the
    sum of ``max(1, weight)`` of its items (CSR-adaptive's balancing)."""
    loads = np.zeros(num_shards, dtype=np.int64)
    assign = [[] for _ in range(num_shards)]
    for i in order:
        s = int(np.argmin(loads))
        assign[s].append(int(i))
        loads[s] += max(1, int(weights[i]))
    return assign


def _row_assignment(p: Problem, num_shards: int) -> list:
    """The rows of each shard, longest rows placed first."""
    lengths = np.diff(p.csr.row_ptr).astype(np.int64)
    return _greedy(np.argsort(-lengths), lengths, num_shards)


def _rows_problem(p: Problem, rows: list) -> Problem:
    """The problem of ``p``'s rows ``rows`` in that order (local row ids,
    all ``n`` columns); no rows give one empty row with infinite sides."""
    csr = p.csr
    rows = np.asarray(rows, dtype=np.int64)
    if rows.size == 0:
        empty = CSR(np.zeros(2, np.int32), csr.col[:0], csr.val[:0], csr.n_cols)
        return p._replace(csr=empty, lhs=np.full(1, -INF), rhs=np.full(1, INF))
    lens = np.diff(csr.row_ptr).astype(np.int64)[rows]
    row_ptr = np.zeros(rows.size + 1, dtype=np.int64)
    np.cumsum(lens, out=row_ptr[1:])
    src = np.repeat(csr.row_ptr[rows].astype(np.int64) - row_ptr[:-1], lens)
    src += np.arange(row_ptr[-1], dtype=np.int64)
    local = CSR(row_ptr.astype(np.int32), csr.col[src], csr.val[src], csr.n_cols)
    return p._replace(csr=local, lhs=p.lhs[rows], rhs=p.rhs[rows])


def partition_rows(p: Problem, num_shards: int):
    """Greedy nnz-balanced ROW partition: every row lives entirely on one
    shard, so activities complete locally and only the ``(n,)`` bound
    combine crosses shards.

    Returns per-shard dense arrays, all padded to common sizes:
      val, col, lrow (shards, NNZ) ; lhs, rhs (shards, R)
    where ``lrow`` is the shard-local row index (R == padding row), and R.
    """
    dt = p.csr.val.dtype
    assign = _row_assignment(p, num_shards)
    shards = [_rows_problem(p, rows).csr for rows in assign]
    max_rows = max(len(a) for a in assign)
    max_nnz = max(max(c.nnz for c in shards), 1)
    val = np.zeros((num_shards, max_nnz), dtype=dt)
    col = np.zeros((num_shards, max_nnz), dtype=np.int32)
    lrow = np.full((num_shards, max_nnz), max_rows, dtype=np.int32)
    lhs = np.full((num_shards, max_rows), -INF, dtype=dt)
    rhs = np.full((num_shards, max_rows), INF, dtype=dt)
    for s, (rows, c) in enumerate(zip(assign, shards)):
        val[s, : c.nnz] = c.val
        col[s, : c.nnz] = c.col
        lrow[s, : c.nnz] = c.row_ids()
        lhs[s, : len(rows)] = p.lhs[rows]
        rhs[s, : len(rows)] = p.rhs[rows]
    return val, col, lrow, lhs, rhs, max_rows


def _nnz_shard(p: Problem, rank: int, world: int) -> Problem:
    """Rank ``rank``'s share of :func:`partition_nnz` as a problem of all
    ``m`` rows (global row ids; a row split between ranks keeps its part
    here), the padding left out."""
    csr = p.csr
    per = -(-csr.nnz // world)
    lo, hi = min(rank * per, csr.nnz), min((rank + 1) * per, csr.nnz)
    row_ptr = (np.clip(csr.row_ptr, lo, hi) - lo).astype(np.int32)
    return p._replace(csr=CSR(row_ptr, csr.col[lo:hi], csr.val[lo:hi], csr.n_cols))


def _row_shard(p: Problem, rank: int, world: int) -> Problem:
    """Rank ``rank``'s rows of :func:`partition_rows` as a problem of its own."""
    return _rows_problem(p, _row_assignment(p, world)[rank])


# Built shards, LRU-cached per (problem structure, partition, world, rank):
# a caller that re-propagates the same instance (with other bounds, too)
# partitions and prepares it once.  Batch shards as the reference's (4).
_shard_cache = LRU(8)
_batch_shard_cache = LRU(4)


def _cached(cache: LRU, key: tuple, anchors: tuple, build: Callable):
    """``cache``'s entry for ``key``, built and put on a miss."""
    value = cache.get(key, anchors)
    if value is None:
        value = build()
        cache.put(key, anchors, value)
    return value


def _group_rank(group) -> tuple[int, int]:
    """``(rank, world size)`` in ``group`` (None: the default world), which
    must be initialised: there is no silent one-rank path."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "no process group: call torch.distributed.init_process_group on every rank "
            "first (run_world starts a world on this host)"
        )
    return dist.get_rank(group), dist.get_world_size(group)


# ---------------------------------------------------------------------------
# Single-instance partitions: a round of the fused engine with collectives
# ---------------------------------------------------------------------------


def _sharded_round_fn(prep, cfg: PropagatorConfig, group, n: int, *, nnz: bool):
    """A ``(lb, ub) -> (lb, ub, changed)`` round closure over one rank's
    prepared shard: the fused engine's round (``kernels.ops._prepared_round``)
    on :data:`kernels.ops.KERNEL_OPS` with the collectives spliced into its
    functions.  The merge first all-reduces the kept planes (MAX of
    ``best_l``, MIN of ``best_u``, the ``n`` real columns, in place), then
    runs F.  Under ``nnz`` (rows split between ranks) the round always takes
    the multi-chunk branch, and the combine's per-chunk aggregates are
    completed across ranks: each row's from its first chunk into a stacked
    ``(4, m)`` plane, one all-reduce SUM, then spread back to the chunks.
    Otherwise (whole rows) D runs where the rank's rows fit one chunk.  The
    closure carries its loop carry, as ``kernels.ops.round_fn_for``'s does,
    and merges with no outward widening."""
    from ..kernels import ops as kops  # lazy: kernels imports core at module scope

    ops = kops.KERNEL_OPS
    d = prep.d
    dt = d.val.dtype

    def merge(lb, ub, best_l, best_u, *args, **kwargs):
        dist.all_reduce(best_l[:n], op=dist.ReduceOp.MAX, group=group)
        dist.all_reduce(best_u[:n], op=dist.ReduceOp.MIN, group=group)
        return ops.merge(lb, ub, best_l, best_u, *args, **kwargs)

    collective = dict(merge=merge)
    if nnz:
        m = prep.m
        first = prep.row_start[:m]  # every row keeps at least one chunk
        spread = d.chunk_row.reshape(-1).long().clamp(max=max(m - 1, 0))

        def combine(*args, **kwargs):
            aggs = ops.combine(*args, **kwargs)
            rows = torch.stack([a.reshape(-1).to(dt) for a in aggs]).index_select(1, first)
            dist.all_reduce(rows, op=dist.ReduceOp.SUM, group=group)
            chunks = rows.index_select(1, spread)
            return tuple(chunks[i].to(a.dtype).view(a.shape) for i, a in enumerate(aggs))

        collective["combine"] = combine
    rops = ops._replace(**collective)
    fused = prep.fits_one_chunk and not nnz
    eps, int_eps, inf, _ = round_scalars(cfg, dt)
    kept = kops.KeptPlanes(inf)
    carry = LoopCarry()

    def round_fn(lb, ub):
        return kops._prepared_round(
            prep, lb, ub, ops=rops, eps=eps, int_eps=int_eps, inf=inf, fused=fused,
            outward=0.0, kept=kept, carry=carry.step(lb.device), gate=True,
        )

    run = kept.guard(round_fn)
    # On the card every kernel of a round enqueued after convergence
    # returns at once; on the CPU the plain versions run in full.
    run.carry, run.gated = carry, d.val.is_cuda
    return run


def _propagate_shard(p: Problem, nnz: bool, group, cfg, dtype, lb0, ub0, device, tile_rows,
                     tile_width) -> PropagationResult:
    from ..kernels.ops import _initial_padded_bounds, prepare_block_ell

    dev = resolve_device(device)
    dt = check_dtype(p.csr.val.dtype if dtype is None else dtype)
    rank, world = _group_rank(group)
    anchors = (p.csr, p.lhs, p.rhs, p.is_int)
    key = tuple(id(a) for a in anchors) + (nnz, world, rank)
    shard = _nnz_shard if nnz else _row_shard
    local = _cached(_shard_cache, key, anchors, lambda: shard(p, rank, world))
    prep = prepare_block_ell(local, tile_rows, tile_width, dt, dev)
    round_fn = _sharded_round_fn(prep, cfg, group, p.n, nnz=nnz)
    lb, ub = _initial_padded_bounds(prep, p.lb if lb0 is None else lb0,
                                    p.ub if ub0 is None else ub0)
    lb, ub, rounds, changed, prog = device_fixed_point(round_fn, lb, ub, cfg.max_rounds)
    return _result(lb[: p.n], ub[: p.n], rounds, changed, prog, cfg.feas_eps)


def propagate_sharded(
    p: Problem,
    group=None,
    cfg: PropagatorConfig = DEFAULT_CONFIG,
    dtype=None,
    lb0=None,
    ub0=None,
    *,
    device="cuda",
    tile_rows: int = 8,
    tile_width: int = 128,
) -> PropagationResult:
    """Distributed fixed-point propagation over the ranks of ``group`` (None:
    the default world, which must be initialised), the nonzeros split
    equally (:func:`partition_nnz`).  Every rank calls it with the same
    problem and returns the same result.

    Each round runs kernel A', the combine, an all-reduce SUM of the four
    ``(m,)`` row aggregates, kernel E, an all-reduce MAX/MIN of the column
    planes and kernel F (the module's docstring).  ``lb0``/``ub0`` warm-start
    the fixed point from caller-supplied ``(n,)`` bounds (default: the
    problem's own); the partition and its prepared tiles are cached per
    problem structure, so one partitioned matrix serves any node.  ``dtype``
    is float64, float32, bfloat16 or float16 (default: the matrix's); the
    merges run with no outward widening, as the reference's sharded rounds
    do (unlike ``propagate``).  ``device`` defaults to the rank's current
    CUDA device (``device="cpu"`` runs the kernels' plain versions: a ``gloo`` group).
    ``progress`` is the last round's measure; ``tier_rounds`` is 0."""
    return _propagate_shard(p, True, group, cfg, dtype, lb0, ub0, device, tile_rows,
                            tile_width)


def propagate_sharded_rows(
    p: Problem,
    group=None,
    cfg: PropagatorConfig = DEFAULT_CONFIG,
    dtype=None,
    lb0=None,
    ub0=None,
    *,
    device="cuda",
    tile_rows: int = 8,
    tile_width: int = 128,
) -> PropagationResult:
    """Row-partitioned distributed propagation (:func:`partition_rows`): each
    rank runs its own rows' round (kernel D where they fit one chunk, else
    A', the combine and E), then the all-reduce MAX/MIN of the column planes
    and kernel F; no activity collective.  Each row is whole on one rank and
    summed in the unsharded engine's order, so the result equals
    ``propagate_block_ell``'s bitwise (at float32, its run without outward
    widening).  Arguments as :func:`propagate_sharded`'s."""
    return _propagate_shard(p, False, group, cfg, dtype, lb0, ub0, device, tile_rows,
                            tile_width)


# ---------------------------------------------------------------------------
# Batch partition: instances split across ranks, no collective in the loop
# ---------------------------------------------------------------------------


class _BatchShard(NamedTuple):
    """One rank's cached part of :func:`propagate_batch_sharded`."""

    assign: list   # the instances (input positions) of each rank
    prep: object   # this rank's prepared bucket (None: no members)
    rows: tuple    # each bucket row's position in this rank's members
    b_max: int
    n_pad: int


def _build_batch_shard(problems, rank, world, tile_rows, tile_width, dt, dev) -> _BatchShard:
    from ..kernels.ops import prepare_problem_batch

    n_pad = max(col_pad(p.n) for p in problems)
    # The reference's greedy instance balance (a stable sort by nnz).
    order = sorted(range(len(problems)), key=lambda i: -problems[i].nnz)
    assign = _greedy(order, [p.nnz for p in problems], world)
    members = assign[rank]
    prep, rows = None, ()
    if members:
        (bucket,) = pack_problems([problems[i] for i in members], tile_rows=tile_rows,
                                  tile_width=tile_width, n_pad=n_pad)
        prep, rows = prepare_problem_batch(bucket, dt, dev), bucket.indices
    return _BatchShard(assign, prep, rows, max(len(a) for a in assign), n_pad)


def propagate_batch_sharded(
    problems,
    group=None,
    cfg: PropagatorConfig = DEFAULT_CONFIG,
    tile_rows: int = 8,
    tile_width: int = 128,
    dtype=None,
    *,
    device="cuda",
) -> "list[PropagationResult]":
    """Shard the batch axis of many instances across the ranks of ``group``.

    Instances are balanced greedily across the ranks by nonzero count (the
    reference's rule); each rank packs its share at the common ``n_pad`` of
    the whole list and runs the port's batched engine on it
    (``prepare_problem_batch`` and ``propagate_batch_prepared``: kernel #8 +
    #9, the flat multi-chunk round, or the partitioned kernels past
    ``SCATTER_MAX_NPAD``, as that engine chooses) with no collective; a rank
    with no members runs nothing.  All-gathers of the ``(2, b_max, n_pad)``
    bound planes, the progress and ``(rounds, converged, infeasible)`` then
    hand every rank the whole list.  The partition and the prepared bucket are
    LRU-cached (4) per problem list (by identity), group, config, layout,
    dtype and device; every run starts from private copies of the cached
    initial bounds.  Every type (16-bit ones included) merges with no
    outward widening, as the reference's ``batched_reference_round``.
    Returns one result per instance, input order, on every rank."""
    from ..kernels.ops import propagate_batch_prepared

    problems = list(problems)
    if not problems:
        return []
    dev = resolve_device(device)
    dt = check_dtype(dtype)
    rank, world = _group_rank(group)
    key = (tuple(id(p) for p in problems), id(group), cfg, tile_rows, tile_width, str(dt),
           str(dev), rank, world)
    built = _cached(_batch_shard_cache, key, (*problems, group),
                    lambda: _build_batch_shard(problems, rank, world, tile_rows, tile_width, dt,
                                               dev))
    planes = torch.zeros((2, built.b_max, built.n_pad), dtype=dt, device=dev)
    progress = torch.full((built.b_max,), math.nan, dtype=dt, device=dev)
    stats = torch.zeros((built.b_max, 3), dtype=torch.int32, device=dev)
    if built.prep is not None:
        exact = dataclasses.replace(cfg, outward_eps_f32=0.0)
        for j, r in zip(built.rows, propagate_batch_prepared(built.prep, exact)):
            n = r.lb.shape[0]
            planes[0, j, :n] = r.lb
            planes[1, j, :n] = r.ub
            progress[j] = r.progress
            stats[j] = torch.stack([r.rounds.to(torch.int32), r.converged.to(torch.int32),
                                    r.infeasible.to(torch.int32)])
    gathered = []
    for t in (planes, progress, stats):
        parts = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(parts, t, group=group)
        gathered.append(parts)
    out = [None] * len(problems)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    for s, members in enumerate(built.assign):
        pl, pg, st = (g[s] for g in gathered)
        for j, i in enumerate(members):
            n = problems[i].n
            out[i] = PropagationResult(pl[0, j, :n], pl[1, j, :n], st[j, 0], st[j, 1].bool(),
                                       st[j, 2].bool(), pg[j], zero)
    return out


# ---------------------------------------------------------------------------
# What one rank of propagate_sharded holds and sends (no execution)
# ---------------------------------------------------------------------------


class ShardedArg(NamedTuple):
    """One argument of the reference's sharded fixed point."""

    name: str
    shape: tuple     # the whole argument
    per_rank: tuple  # the part one rank holds
    dtype: torch.dtype


class Collective(NamedTuple):
    """One all-reduce of a round of :func:`propagate_sharded`."""

    op: str        # "sum", "max" or "min"
    elements: int  # per round
    bytes: int


class ShardedLowering(NamedTuple):
    """What :func:`lower_sharded` returns."""

    world_size: int
    args: tuple                  # ShardedArg, the reference's 8 arguments in order
    arg_bytes_per_rank: int
    collectives_per_round: tuple  # Collective: sum, max, min


def lower_sharded(p: Problem, world_size: int, cfg: PropagatorConfig = DEFAULT_CONFIG,
                  dtype=torch.float32) -> ShardedLowering:
    """The counterpart of the reference's AOT lowering of
    :func:`propagate_sharded` for a dry run: a plain record, built without
    running anything and without a process group, of what one rank of a
    ``world_size`` world holds and sends.

    ``args`` lists the reference's 8 arguments in its order (``row_id``,
    ``col``, ``val`` split by :func:`partition_nnz`; ``lhs``, ``rhs``,
    ``is_int``, ``lb0``, ``ub0`` replicated) with their whole and per-rank
    shapes and dtypes; ``arg_bytes_per_rank`` sums the per-rank ones.
    ``collectives_per_round`` gives the all-reduces of one round: SUM over
    the four ``(m,)`` row aggregates (sent stacked in ``dtype``, the counts
    included), MAX and MIN over ``(n,)``.  XLA's temporary bytes
    (``memory_analysis``) have no counterpart here.  ``cfg`` is accepted
    for the reference's signature."""
    del cfg
    dt = check_dtype(dtype)
    m, n = p.m, p.n
    per = -(-p.csr.nnz // world_size)
    nnz_args = ((per * world_size,), (per,))
    specs = (("row_id", *nnz_args, torch.int32), ("col", *nnz_args, torch.int32),
             ("val", *nnz_args, dt), ("lhs", (m,), (m,), dt), ("rhs", (m,), (m,), dt),
             ("is_int", (n,), (n,), torch.bool), ("lb0", (n,), (n,), dt),
             ("ub0", (n,), (n,), dt))
    args = tuple(ShardedArg(*s) for s in specs)
    size = lambda t: torch.empty((), dtype=t).element_size()
    arg_bytes = sum(math.prod(a.per_rank) * size(a.dtype) for a in args)
    item = size(dt)
    colls = tuple(Collective(op, k, k * item) for op, k in (("sum", 4 * m), ("max", n),
                                                            ("min", n)))
    return ShardedLowering(world_size, args, arg_bytes, colls)


# ---------------------------------------------------------------------------
# A world of processes on this host
# ---------------------------------------------------------------------------


class _BFloat16Bits(NamedTuple):
    """A bfloat16 tensor's bits (numpy has no bfloat16), as a rank sends
    it; :func:`_from_host` makes the tensor again."""

    bits: np.ndarray  # int16


def _walk(obj, leaf):
    """``obj`` (tuples, named tuples, lists, dicts) with ``leaf`` applied to
    every other value."""
    if isinstance(obj, _BFloat16Bits) or not isinstance(obj, (tuple, list, dict)):
        return leaf(obj)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_walk(x, leaf) for x in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(_walk(x, leaf) for x in obj)
    return {k: _walk(v, leaf) for k, v in obj.items()}


def _to_host(obj):
    """Tensors in ``obj`` as numpy arrays (bfloat16 ones as their bits), so
    a rank's result crosses the process boundary by value."""
    def leaf(x):
        if not isinstance(x, torch.Tensor):
            return x
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return _BFloat16Bits(x.view(torch.int16).numpy())
        return x.numpy()

    return _walk(obj, leaf)


def _from_host(obj):
    """A rank's result as :func:`_to_host` sent it, its bfloat16 arrays as
    CPU tensors again."""
    return _walk(obj, lambda x: torch.from_numpy(x.bits).view(torch.bfloat16)
                 if isinstance(x, _BFloat16Bits) else x)


# PyTorch's flight recorder keeps a trace of every collective for a hang's
# post-mortem; a rank of run_world runs without it unless the caller's
# environment sets it.  It cost 14-16 us of host time per all-reduce (27.7
# against 13.8 us, 37.1 against 21.1; tools/collective_cost.py, NVIDIA H100
# 80GB HBM3, 700 W), paid three times a round by the nnz partition.
FLIGHT_RECORDER_ENV = "TORCH_FR_BUFFER_SIZE"


def _rank_main(fn, rank, world_size, backend, device, store_path, timeout, threads, args_path,
               results):
    try:
        with open(args_path, "rb") as f:
            args = pickle.load(f)
        os.environ.setdefault(FLIGHT_RECORDER_ENV, "0")
        torch.set_num_threads(threads)
        if torch.device(device).type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        store = dist.FileStore(store_path, world_size)
        dist.init_process_group(backend, store=store, rank=rank, world_size=world_size,
                                timeout=timedelta(seconds=timeout))
        try:
            out = _to_host(fn(rank, world_size, *args))
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except Exception:  # the rank's boundary: report the traceback to run_world
        results.put((rank, False, traceback.format_exc()))


def run_world(fn: Callable, world_size: int, *, backend: str = "gloo", device="cpu",
              init_file: str | None = None, timeout: float = 300.0, args: tuple = (),
              threads: int | None = None) -> list:
    """Run ``fn(rank, world_size, *args)`` on ``world_size`` new processes of
    this host, each a rank of a default process group of ``backend``, and
    return their results by rank (tensors in them come back as numpy
    arrays, bfloat16 ones as CPU tensors; ``fn`` and ``args`` must pickle,
    ``fn`` by its module name).

    The ranks meet through a ``FileStore`` at ``init_file`` (default: a
    fresh file in a temporary directory, removed afterwards), so concurrent
    worlds on one host need no free TCP port, and read ``args`` from a file
    there, pickled once.  With ``device="cuda"`` each
    rank first takes card ``rank % device_count`` as its current device
    (``nccl`` needs a card per rank; several ranks on one card take
    ``gloo``, which stages each collective through the host).  Each rank
    runs ``threads`` intra-op threads (default: this host's cores shared
    out among the ranks, at most the caller's own intra-op threads; more
    threads than cores spin against each other in every parallel region
    and run many times slower), and without
    PyTorch's flight recorder unless the caller's environment sets
    :data:`FLIGHT_RECORDER_ENV` (its per-collective trace costs host time
    every round; the deadline below catches a hang).  The call
    waits at most ``timeout`` seconds: past it, or as soon as a rank raises
    or dies, every rank is killed and it raises (``TimeoutError`` or
    ``RuntimeError`` with the rank's traceback), so a rank that diverges and
    waits forever in a collective fails within the deadline."""
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="run_world_")
    if init_file is None:
        init_file = os.path.join(tmp, "store")
    if threads is None:
        threads = max(1, min(torch.get_num_threads(),
                             len(os.sched_getaffinity(0)) // world_size))
    # ``args`` reach the ranks through a file, pickled once: a process's
    # own arguments are piped to it, one rank after another, while it
    # starts.
    args_path = os.path.join(tmp, "args.pickle")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world_size, backend, str(device), init_file, timeout,
                               threads, args_path, results))
             for r in range(world_size)]
    deadline = time.monotonic() + timeout
    out: dict = {}
    try:
        with open(args_path, "wb") as f:
            pickle.dump(tuple(args), f, protocol=pickle.HIGHEST_PROTOCOL)
        for proc in procs:
            proc.start()
        while len(out) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"run_world: {world_size - len(out)} of {world_size} ranks "
                                   f"did not finish within {timeout} s")
            try:
                rank, ok, value = results.get(timeout=min(left, 0.5))
            except queue.Empty:
                # A rank that returns or raises reports before it exits 0.
                dead = [r for r, proc in enumerate(procs) if proc.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"run_world: rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode} and no result")
                continue
            if not ok:
                raise RuntimeError(f"run_world: rank {rank} raised:\n{value}")
            out[rank] = _from_host(value)
        for proc in procs:
            proc.join(max(deadline - time.monotonic(), 1.0))
    finally:
        for proc in procs:
            if proc.pid is None:
                continue  # never started
            if proc.is_alive():
                proc.kill()
            proc.join()
        results.cancel_join_thread()  # a killed rank leaves its data unread
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(world_size)]
