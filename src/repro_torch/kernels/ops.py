"""The block-ELL propagation engines over the round kernels: one instance
(``propagate_block_ell``), a packed batch of instances
(``propagate_batch_block_ell``) and a batch of nodes sharing one matrix
(``propagate_nodes_prepared``).

The kernel-backed sibling of ``core.propagator``; both share the bound-update
semantics so they converge to the same fixed points.

  * ``prepare_block_ell`` -- one-time, cached per matrix structure: block-ELL
    conversion, upload, and the round-constant gathers (``is_int[col]``,
    ``lhs1[chunk_row]``, ``rhs1[chunk_row]``).
  * The ``"fused"`` round: rows that fit one chunk run kernel D (gather,
    activities, candidates, column max/min) then kernel F (merge, in place);
    rows that span chunks run kernel A' (chunk partials), the combine kernel
    (each row's partials summed left to right: a thread per short row, a
    warp per long row, by the segment classes hoisted at prepare time),
    kernel E (candidates + column max/min), then F.  D and E scatter into
    accumulator planes that the round closure keeps for its whole fixed
    point, and F sets them back to the sentinels.
  * The ``"partitioned"`` round (``slab.SlabPartition``, built once per slab
    width on the host): the straddle rows' copy partials (#11), their
    completed aggregates by the straddle combine kernel in one fixed order
    (a compact table per plane, spread to the chunks), then the slab round
    (#12: scatter into accumulator planes that the round closure keeps for
    its whole fixed point, then #15's window merge, in place, which sets
    them back to the sentinels).
  * The ``"segment"`` round (the reference's seed dataflow, kept as its
    cross-validation engine): the bounds gathered at every slot, kernel C
    (rows in one chunk) or kernel A, the combine and kernel B, the
    candidates written out, then the column max/min over the nonzero slots
    (``scatter_reduce_``) and kernel F.  ``block_ell_round`` /
    ``legacy_round_fn_for`` run the same round in the unpadded ``(n,)``
    domain with its constant gathers redone every round.
  * ``scatter="auto"`` picks the engine as the reference does: ``fused``
    while ``n_pad <= SCATTER_MAX_NPAD``, ``partitioned`` beyond (or
    ``segment``, under ``REPRO_AUTO_LARGE_SCATTER=segment``).  The limit
    picks the engine and no longer bounds what the port can run: an
    explicit ``scatter="fused"`` runs at any ``n_pad``.
  * The batched round over a packed bucket (``prepare_problem_batch``, one
    flat tile stream, ``(B, n_pad)`` planes, a per-instance active mask):
    kernel #8 (into the closure's kept planes, over the active instances'
    chunk ranges only) then #9 where every row fits one chunk; past
    ``SCATTER_MAX_NPAD`` the partitioned round over the bucket's slab
    partition; otherwise A', the combine and E over the flat stream with
    global columns, then #9.
  * The node round: kernel #10 (into the closure's kept accumulator
    planes) then the batched merge #9 (which hands them back clean) where
    rows fit one chunk, else A', the combine and E over the node batch
    then #9 -- four launches per round whatever the batch size; past ``SCATTER_MAX_NPAD``
    the partitioned node kernels (#13, the straddle combine over the active
    nodes' planes, #14 into the kept planes with #15) over the ``(B,
    n_pad)`` planes, whatever
    the tile width (the plain path there follows
    ``REPRO_AUTO_LARGE_SCATTER``, as the reference's does).
  * The fixed point runs on private copies of the cached initial bounds, so
    the in-place merges never touch the cache.
  * The precision tiers (ROADMAP Queue 1 item 5): ``prepare_block_ell`` at
    float32 (the fp32 tier) narrows the index streams where ``n_pad <=
    2**15`` (``col`` int16, ``ii_g`` int8), and every engine runs its
    kernels' float32 forms: the fused and multi-chunk rounds D, A', the
    combine, E and F; the segment round A, B and C (B and C on the int8
    marks; the bound gather on columns widened once per prep) and F; the
    partitioned round #11, the straddle combine, #12 and #15 (the
    partition widens the columns to int32).  ``propagate_block_ell`` takes
    the two-tier ``policy`` and the progress-based early stop on every
    engine (F, or #15 past the limit, folds the round's measure into the
    loop carry).  ``prepare_problem_batch`` at float32 keeps int32 ids; the
    batched and node rounds run the float32 forms of #8, #10, the
    node-batched A', combine and E and #9, or past ``SCATTER_MAX_NPAD`` of
    #11/#13, the straddle combine and #12/#14 with #15; under a per-row
    early stop #9 or #15 measures each active row's round
    (``propagate_batch_block_ell`` and ``core.nodes.propagate_nodes`` take
    ``policy`` too).

Telemetry (ROADMAP Queue 1 item 6): every engine takes ``telemetry=`` (a
ring capacity); the round closures carry the record kernel's prepared
launch (``record``, or ``record_batch`` for the batched and node rounds),
which the loop drivers of ``core.propagator`` run after each round.
``donate=`` is accepted for the reference's signatures and changes nothing.

Per-round device-memory traffic of the fused round: ``val``, ``col`` and
``is_int`` at the nonzeros (16 B each; every chunk stops at its hoisted
length), plus O(m + n_pad) for the lengths, the row data and the bound and
accumulator vectors.
"""
from __future__ import annotations

import dataclasses
import os
import threading
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..core import bounds as bnd
from ..core import carry as _carry
from ..core.carry import LoopCarry
from ..core.carry import EarlyStop, early_stop
from ..core.lru import LRU
from ..core.propagator import (
    _result,
    batched_fixed_point,
    check_dtype,
    device_fixed_point,
    fixed_point,
    resolve_device,
    run_tiers,
    two_tier_bounds_dtypes,
    KERNEL_DRIVERS,
)
from ..core.sparse import Problem, ProblemBatch, col_pad, csr_to_block_ell, pack_problems
from ..core.types import DEFAULT_CONFIG, INF, PropagationResult, PropagatorConfig, TierPolicy
from ..obs import telemetry as obs
from . import prop_round as kern
from . import ref as kref
from .slab import (  # noqa: F401  (re-exported)
    SCATTER_MAX_NPAD,
    SLAB_NPAD,
    SlabPartition,
    build_slab_partition,
    default_slab_width,
)

# SCATTER_MAX_NPAD and SLAB_NPAD are read from this module at call time, so
# a caller (or a test) may move the point where ``scatter="auto"`` switches
# engines.  SCATTER_MAX_NPAD is the JAX package's VMEM budget, kept so that
# both packages pick the same engine; it limits nothing on the H100.

# Compact index streams (the reference's, src/repro/kernels/ops.py:97): a
# float32 tier whose padded column space fits int16 narrows its
# per-nonzero index streams, ``col`` to int16 and the hoisted ``is_int``
# gather to int8; the kernels widen them in registers.
_COMPACT_COL_MAX_NPAD = 1 << 15


class DeviceBlockEll(NamedTuple):
    """One instance's block-ELL tiles and vectors as tensors on one device."""

    val: torch.Tensor        # (T, R, K) float64 or float32; 0 == padding
    col: torch.Tensor        # (T, R, K) int32 (int16 on compact float32 tiers); 0 at padding
    chunk_row: torch.Tensor  # (T, R) int32 in [0, m]; m == padding
    lhs1: torch.Tensor       # (m+1,) sides padded with one dummy slot at index m
    rhs1: torch.Tensor       # (m+1,)
    is_int: torch.Tensor     # (n,) bool
    lb0: torch.Tensor        # (n,)
    ub0: torch.Tensor        # (n,)


def device_block_ell(
    p: Problem, tile_rows: int = 8, tile_width: int = 128, dtype=None, device="cuda"
) -> DeviceBlockEll:
    """Convert + upload one instance.  Prefer :func:`prepare_block_ell`,
    which caches this and hoists the round-constant gathers."""
    dev = resolve_device(device)
    dt = check_dtype(dtype)
    b = csr_to_block_ell(p.csr, tile_rows=tile_rows, tile_width=tile_width)
    t = lambda x, d=dt: torch.as_tensor(np.asarray(x), dtype=d, device=dev)
    pad1 = lambda x: np.concatenate([np.asarray(x, np.float64), [0.0]])
    return DeviceBlockEll(
        val=t(b.val),
        col=t(b.col, torch.int32),
        chunk_row=t(b.chunk_row, torch.int32),
        lhs1=t(pad1(p.lhs)),
        rhs1=t(pad1(p.rhs)),
        is_int=t(p.is_int, torch.bool),
        lb0=t(p.lb),
        ub0=t(p.ub),
    )


def rows_fit_one_chunk(p: Problem, tile_width: int) -> bool:
    """True iff every row's nonzeros fit one ``tile_width``-wide chunk -- the
    condition for the single-kernel fused round."""
    return int(np.diff(p.csr.row_ptr).max(initial=0)) <= tile_width


@dataclasses.dataclass(frozen=True)
class PreparedBlockEll:
    """Device tiles + everything about a round that does not change across
    rounds: the hoisted gathers, the column-padded initial bounds, and static
    layout facts.  Rounds read only matrix structure from it; ``lb0``/``ub0``
    are per-problem defaults that every driver accepts as runtime overrides,
    so one prepared engine serves any bounds."""

    d: DeviceBlockEll
    ii_g: torch.Tensor   # (T, R, K) int32 (int8 on compact float32 tiers): is_int[col], hoisted
    lhs_g: torch.Tensor  # (T, R): lhs1[chunk_row], hoisted
    rhs_g: torch.Tensor  # (T, R): rhs1[chunk_row], hoisted
    lb0: torch.Tensor    # (n_pad,) default initial bounds (column-padded)
    ub0: torch.Tensor    # (n_pad,)
    row_start: torch.Tensor  # (m+2,) int64: first chunk of each row, padding row m too
    seg_classes: tuple       # the combine's (short, long) int32 segment ids, hoisted
    chunk_len: torch.Tensor  # (T, R) int32: one past each chunk's last nonzero (D, A', E, #10)
    max_chunk_len: int       # its largest entry: D's lanes per chunk, the strides D and #10 hold
    m: int
    n: int
    n_pad: int
    fits_one_chunk: bool
    # Slab partitions, built lazily and keyed by slab width; shared by
    # bounds-swapped views of this prep.
    _slabs: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)
    # The segment round's reduction index, built at its first use; shared
    # by bounds-swapped views.
    _segment: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    def segment_index(self):
        """The nonzero slots of the tiles as the segment round's column
        reduction visits them (:func:`segment_index`), built once."""
        idx = self._segment.get("index")
        if idx is None:
            idx = self._segment["index"] = segment_index(self.d.val, self.d.col)
        return idx

    def gather_columns(self) -> torch.Tensor:
        """The columns the segment round's bound gather reads
        (:func:`gather_bounds`): ``d.col`` itself where it is int32, else
        (a compact float32 prep's int16 columns) widened to int32 once and
        kept, never per round."""
        col = self.d.col
        if col.dtype == torch.int32:
            return col
        wide = self._segment.get("columns")
        if wide is None:
            wide = self._segment["columns"] = col.to(torch.int32)
        return wide

    def slab_partition(self, slab: int | None = None) -> SlabPartition:
        """This instance's tile stream re-bucketed into ``slab``-wide column
        windows (default: :func:`default_slab_width` under the module's
        :data:`SLAB_NPAD`, read at call time), for the partitioned engine.
        Built once per slab width on the host from the tiles and cached on
        the prep; its tensors live on the prep's device."""
        s = default_slab_width(self.n_pad, SLAB_NPAD) if slab is None else int(slab)
        part = self._slabs.get(s)
        if part is None:
            d = self.d
            is_int_rows = np.zeros((1, self.n_pad), dtype=bool)
            is_int_rows[0, : self.n] = d.is_int.cpu().numpy()
            host = lambda x: x.cpu().numpy()
            part = build_slab_partition(
                host(d.val), host(d.col), host(d.chunk_row),
                np.zeros(d.val.shape[0], dtype=np.int32), host(d.lhs1), host(d.rhs1),
                is_int_rows, self.n_pad, s, np.array([self.m], dtype=np.int32),
                device=d.val.device,
            )
            self._slabs[s] = part
        return part

    def pad_bound(self, arr) -> torch.Tensor:
        """One caller bound vector -> the column-padded ``(n_pad,)`` domain
        (padded columns sit at 0, the trivially converged fill)."""
        a = torch.as_tensor(arr, dtype=self.lb0.dtype, device=self.lb0.device)
        if tuple(a.shape) != (self.n,):
            raise ValueError(f"bounds have shape {tuple(a.shape)}, expected {(self.n,)}")
        out = torch.zeros(self.n_pad, dtype=a.dtype, device=a.device)
        out[: self.n] = a
        return out

    def pad_bounds(self, lb, ub):
        return self.pad_bound(lb), self.pad_bound(ub)


# Structure anchors: a prepared engine depends on the matrix, the sides and
# the integrality marks -- NOT on the bounds -- so a branch-and-bound node
# built as ``root._replace(lb=..., ub=...)`` hits the cache.
def _structure_anchors(p: Problem) -> tuple:
    return (p.csr, p.lhs, p.rhs, p.is_int)


_prep_cache = LRU(maxsize=32)


def prepare_block_ell(
    p: Problem, tile_rows: int = 8, tile_width: int = 128, dtype=None, device="cuda"
) -> PreparedBlockEll:
    """One-time setup for kernel-backed propagation, LRU-cached per matrix
    STRUCTURE (``csr``/``lhs``/``rhs``/``is_int`` identity, plus layout,
    dtype and device -- maxsize 32, see :func:`cache_info`).

    A hit from a problem whose bounds differ from the cached defaults
    returns a bounds-swapped view sharing every device tile.  ``dtype`` is
    float64 (the default) or float32; a float32 prep whose ``n_pad`` fits
    int16 (:data:`_COMPACT_COL_MAX_NPAD`) holds ``d.col`` as int16 and
    ``ii_g`` as int8."""
    dev = resolve_device(device)
    dt = check_dtype(dtype)
    anchors = _structure_anchors(p)
    key = tuple(id(a) for a in anchors) + (tile_rows, tile_width, str(dt), str(dev))
    hit = _prep_cache.get(key, anchors)
    if hit is not None:
        creator, prep = hit
        if creator.lb is p.lb and creator.ub is p.ub:
            return prep
        lb0, ub0 = prep.pad_bounds(p.lb, p.ub)
        d = prep.d._replace(
            lb0=torch.as_tensor(np.asarray(p.lb), dtype=dt, device=dev),
            ub0=torch.as_tensor(np.asarray(p.ub), dtype=dt, device=dev),
        )
        return dataclasses.replace(prep, d=d, lb0=lb0, ub0=ub0)

    d = device_block_ell(p, tile_rows, tile_width, dt, dev)
    n_pad = col_pad(p.n)
    compact = dt == torch.float32 and n_pad <= _COMPACT_COL_MAX_NPAD
    col = d.col.long()
    crow = d.chunk_row.long()
    row_start = kref.row_starts(d.chunk_row, p.m + 1)
    chunk_len = kref.chunk_lengths(d.val)
    ii_g = d.is_int[col].to(torch.int8 if compact else torch.int32)
    if compact:
        d = d._replace(col=d.col.to(torch.int16))
    prep = PreparedBlockEll(
        d=d,
        ii_g=ii_g,
        lhs_g=d.lhs1[crow],
        rhs_g=d.rhs1[crow],
        lb0=torch.zeros(n_pad, dtype=dt, device=dev),
        ub0=torch.zeros(n_pad, dtype=dt, device=dev),
        row_start=row_start,
        seg_classes=kref.segment_classes(row_start),
        chunk_len=chunk_len,
        max_chunk_len=int(chunk_len.max()) if chunk_len.numel() else 0,
        m=p.m,
        n=p.n,
        n_pad=n_pad,
        fits_one_chunk=rows_fit_one_chunk(p, tile_width),
    )
    prep.lb0[: p.n] = d.lb0
    prep.ub0[: p.n] = d.ub0
    _prep_cache.put(key, anchors, (p, prep))
    return prep


def clear_prepare_cache() -> None:
    """Drop all cached prepared instances (frees their device buffers)."""
    _prep_cache.clear()


def segment_index(val, col):
    """``(pos, cols)``: the flat int64 positions of the nonzero slots of
    (T, R, K) tiles and their int64 columns -- the slots the segment round's
    column reduction visits.  A padding slot holds column 0 and both
    sentinel candidates, the identities of max and min over accumulators
    that start at the sentinels, so leaving it out is exact; reducing it
    would pile every padding slot of the stream onto column 0."""
    pos = torch.nonzero(val.reshape(-1) != 0).flatten()
    return pos, col.reshape(-1)[pos].long()


def segment_reduce(lcand, ucand, index, width: int, inf: float):
    """The segment round's column reduction: the column max of ``lcand`` and
    min of ``ucand`` over the slots of ``index`` (:func:`segment_index`),
    from the sentinels -- ``ref.scatter_round_ref`` restricted to the
    nonzero slots.  The reference's XLA ``segment_max``/``segment_min``
    (src/repro/kernels/ops.py:1033), not a Pallas kernel: here
    ``scatter_reduce_``."""
    pos, cols = index
    best_l = torch.full((width,), -inf, dtype=lcand.dtype, device=lcand.device)
    best_u = torch.full((width,), inf, dtype=ucand.dtype, device=ucand.device)
    best_l.scatter_reduce_(0, cols, lcand.reshape(-1).index_select(0, pos), "amax")
    best_u.scatter_reduce_(0, cols, ucand.reshape(-1).index_select(0, pos), "amin")
    return best_l, best_u


def gather_bounds(lb, ub, col):
    """``lb[col]``, ``ub[col]`` as (T, R, K) tiles: the segment round's
    per-round bound gather (``index_select`` takes int32 or int64 columns
    as they are; int16 ones, which it refuses, are widened here: the
    legacy round's, which redoes its structure work every round; the
    prepared round passes :meth:`PreparedBlockEll.gather_columns`)."""
    flat = col.reshape(-1)
    if flat.dtype == torch.int16:
        flat = flat.to(torch.int32)
    return (lb.index_select(0, flat).view(col.shape), ub.index_select(0, flat).view(col.shape))


class KeptPlanes:
    """The accumulator planes of kernels D and E (``(n_pad,)``) and #8, #10,
    #12 and #14 (``(B, W)``), kept by the round closure that owns them (or
    the service's bucket engine) for its whole fixed point: allocated and
    filled with the sentinels at the first round
    (:func:`prop_round.accumulator_planes`), scattered into by the kernel,
    and set back to the sentinels by the merge that reads them (F, every
    column; #9 or #15, the active rows: the rows the kernel scattered
    into), so each round finds them clean.  A new shape or device
    allocates anew.  One pair per thread, since a cached closure may run in
    several threads; a round that raises drops the pair (it may have
    scattered without merging).  The merges #9 and #15 also take their
    flags from here: a :class:`prop_round.FlagPair` per shape, written in
    turn (:meth:`flags`); and the partitioned round its straddle partials
    and aggregates (:meth:`scratch`)."""

    def __init__(self, inf: float):
        self.inf = inf
        self._local = threading.local()

    @property
    def planes(self):
        """This thread's pair, or None before the first round."""
        return getattr(self._local, "planes", None)

    def get(self, like: torch.Tensor):
        """The pair for bound planes shaped like ``like`` (and of its dtype)."""
        planes = self.planes
        if (planes is None or planes[0].shape != like.shape or planes[0].device != like.device
                or planes[0].dtype != like.dtype):
            planes = self._local.planes = kern.accumulator_planes(like, self.inf)
        return planes

    def scratch(self, key, specs, like: torch.Tensor) -> tuple:
        """This thread's tensors of ``specs`` (``(shape, dtype)`` each) for
        ``key`` on ``like``'s device: a kernel's outputs that a round reads
        within the round, allocated (zeroed) once instead of every round."""
        bufs = getattr(self._local, "scratch", None)
        if bufs is None:
            bufs = self._local.scratch = {}
        full = (key, tuple(specs), like.device)
        out = bufs.get(full)
        if out is None:
            out = bufs[full] = tuple(torch.zeros(shape, dtype=dt, device=like.device)
                                     for shape, dt in specs)
        return out

    def stop_buffers(self, like: torch.Tensor) -> dict:
        """#9's early-stop buffers for ``(B, W)`` planes shaped like
        ``like`` (:func:`prop_round.apply_updates_batch_tiles`): the block
        partials and the zeroed ticket, kept like the scratch."""
        bsz, width = like.shape
        blocks = -(-width // kref.MERGE_BLOCK)
        partials, ticket = self.scratch("row_progress", (((bsz, blocks), like.dtype),
                                                         ((1,), torch.int32)), like)
        return dict(partials=partials, ticket=ticket)

    def flags(self, shape, dtype: torch.dtype, like: torch.Tensor) -> "kern.FlagPair":
        """This thread's flag pair of ``shape`` and ``dtype`` on ``like``'s
        device, allocated zeroed at its first use."""
        pairs = getattr(self._local, "flag_pairs", None)
        if pairs is None:
            pairs = self._local.flag_pairs = {}
        key = (tuple(shape), dtype, like.device)
        pair = pairs.get(key)
        if pair is None:
            pair = pairs[key] = kern.FlagPair(shape, dtype, like.device)
        return pair

    def guard(self, round_fn: Callable) -> Callable:
        """``round_fn``, dropping the planes and flag pairs if it raises; the
        planes are its ``kept`` attribute."""

        def run(*args, **kwargs):
            try:
                return round_fn(*args, **kwargs)
            except BaseException:
                self._local.planes = None
                self._local.flag_pairs = None
                self._local.scratch = None
                raise

        run.kept = self
        return run


class RoundOps(NamedTuple):
    """The functions of a round: the kernel wrappers, or their plain
    PyTorch versions."""

    fused: Callable       # D: tiles + bounds (+ acc, hoisted lengths) -> (best_l, best_u)
    activities: Callable  # A': tiles + bounds -> chunk partials
    combine: Callable     # chunk partials -> completed row aggregates
    candidates: Callable  # E: tiles + row aggregates + bounds (+ acc) -> (best_l, best_u)
    merge: Callable       # F: (lb, ub, best_l, best_u, eps, inf, outward, carry=, k=, unroll=,
                          # stop=, partials=) -> (lb, ub, GO); hands best_l / best_u back
    node_fused: Callable  # #10: tiles + (B, n_pad) planes + active + kept -> (best_l, best_u)
    merge_batch: Callable  # #9: (lb, ub, best_l, best_u, active, eps, inf, outward, flags=,
                           # progress=, partials=, ticket=)
    partitioned: Callable  # (part, lb, ub, active, ..., kept, carry=, stop=, stop_partials=,
                           # progress=) -> (lb, ub, (B,) changed)
    batched_fused: Callable  # #8: flat stream + tile_inst + (B, n_pad) planes + active + acc
    activities_tiles: Callable   # A: tiles + gathered bounds -> chunk partials
    candidates_tiles: Callable   # B: ... + row aggregates -> (T, R, K) candidates
    fused_round_tiles: Callable  # C: tiles + gathered bounds -> (T, R, K) candidates
    node_activities: Callable  # A' over (B, n_pad) planes + active -> (B, T, R) partials
    node_combine: Callable     # the combine over (B, T, R) partials + active
    node_candidates: Callable  # E over (B, T, R) aggregates + planes + active


def _kernel_node_fused(val, col, is_int_g, lhs_g, rhs_g, lb, ub, active, n_pad, int_eps, inf,
                       *, kept: KeptPlanes, chunk_len=None, max_chunk_len=None):
    return kern.node_fused_scatter_round_tiles(
        val, col, is_int_g, lhs_g, rhs_g, lb, ub, active, n_pad, int_eps, inf,
        acc=kept.get(lb), chunk_len=chunk_len, max_chunk_len=max_chunk_len,
    )


def _plain_fused(val, col, is_int_g, lhs_g, rhs_g, lb, ub, n_pad, int_eps, inf=INF, *,
                 acc=None, chunk_len=None, max_chunk_len=None):
    """D's plain version, folded into the kept planes ``acc`` as the kernel
    scatters into them (the hoisted lengths change nothing)."""
    del chunk_len, max_chunk_len
    best = kref.fused_scatter_round_tiles_ref(val, col, is_int_g, lhs_g, rhs_g, lb, ub, n_pad,
                                              int_eps, inf)
    return best if acc is None else kern._fold(acc, best)


def _plain_candidates(*args, chunk_len=None, acc=None):
    """E's plain version, folded into the kept planes ``acc`` as the kernel
    scatters into them."""
    best = kref.candidates_scatter_tiles_ref(*args, chunk_len=chunk_len)
    return best if acc is None else kern._fold(acc, best)


def _plain_merge(lb, ub, best_l, best_u, eps, inf=INF, outward=0.0, *, carry=None, k=0,
                unroll=1, stop=None, partials=None):
    """F's plain version (:func:`ref.merge_carry_ref`), handing every
    accumulator entry back at the sentinels as the kernel does (the kept
    planes of D and E need it) and folding its flag (and, with the early
    stop ``stop``, the round's progress measure in the kernel's order) into
    the loop carry (a fresh one without ``carry``).  ``partials``, the
    kernel's per-block sums, is not used."""
    del partials
    if carry is None:
        carry, k, unroll = _carry.armed_state(lb.device), 0, 1
    return kref.merge_carry_ref(lb, ub, best_l, best_u, eps, inf, outward, carry, k, unroll,
                                stop)


def _plain_node_fused(val, col, is_int_g, lhs_g, rhs_g, lb, ub, active, n_pad, int_eps, inf,
                      *, kept, chunk_len=None, max_chunk_len=None):
    del kept, chunk_len, max_chunk_len  # the plain round allocates its own planes
    return kref.node_fused_scatter_round_ref(
        val, col, is_int_g, lhs_g, rhs_g, lb, ub, n_pad, int_eps, inf, active=active
    )


def _plain_batched_fused(val, col, is_int_g, lhs_g, rhs_g, lb, ub, tile_inst, active, n_pad,
                         int_eps, inf, *, acc, chunk_len=None, max_chunk_len=None, chunks=None):
    """#8's plain version, folded into the kept planes ``acc`` as the
    kernel scatters into them (the hoisted fields change nothing)."""
    del chunk_len, max_chunk_len, chunks
    return kern._fold(acc, kref.batched_fused_scatter_round_ref(
        val, kref.global_columns(col, tile_inst, n_pad), is_int_g, lhs_g, rhs_g, lb, ub, n_pad,
        int_eps, inf, active=active,
    ))


def _plain_merge_batch(lb, ub, best_l, best_u, active, eps, inf, outward=0.0, *, flags=None,
                       progress=None, partials=None, ticket=None):
    """#9's plain version, handing the active rows of the planes back at the
    sentinels as the kernel does (the kept planes of #8 need it); its flags
    are fresh (``flags``, the kernel's kept pair, is not used).  With
    ``progress`` each active row's early-stop measure is written into it in
    the kernel's order (:func:`ref.merge_rows_progress`); ``partials`` and
    ``ticket`` are not used."""
    del flags, partials, ticket
    out = bnd.apply_updates_batch(lb, ub, best_l, best_u, eps, inf, outward, active=active)
    if progress is not None:
        _, prog = kref.merge_rows_progress(lb, ub, out[0], out[1])
        progress.copy_(torch.where(active, prog, progress))
    kern._hand_back(best_l, best_u, active, inf)
    return out


def _partitioned_kernel_round(
    part: SlabPartition, lb, ub, active, *, node: bool, eps: float, int_eps: float,
    inf: float, kept: KeptPlanes, outward: float = 0.0, carry=None,
    stop: EarlyStop | None = None, stop_partials=None, progress=None,
):
    """One partitioned round on the kernels over ``(B, W)`` planes (``W`` the
    instance's ``n_pad``: no real nonzero reaches past it), IN PLACE:
    straddle-row partials (#11, or #13 per node), their completed
    aggregates (the straddle combine kernel, each slot's partials left to
    right in sub-stream order, on the active nodes' planes), then the slab
    round (#12, or #14 per node: scatter, then #15's window merge).
    ``node=False`` routes copies to their own instance's plane by the run
    maps (a single instance passes ``B == 1``); ``node=True`` runs ONE
    instance's copies against every node's plane.  #12 and #14 scatter
    into the closure's kept planes ``kept``, and #15 writes its window flags
    into a pair kept there.  Returns ``(lb, ub, changed)`` with ``(B,)``
    bool flags: the window flags OR-ed per plane.  With ``carry`` (``(state,
    k, unroll)`` of a single instance's loop carry, ``active`` its ``GO``)
    #11, the straddle combine and #12 return at once where ``GO`` is false,
    #15 folds its flags into the carry and ``changed`` is None; the carry's
    early stop ``stop`` then has #15 fold the round's progress measure too
    (each block's sum into ``stop_partials``, kept by the closure).  Without a
    carry, ``progress`` (a ``(B,)`` tensor) takes each active plane's
    measure of the round from #15 (its buffers kept in ``kept``)."""
    bsz = lb.shape[0]
    go = active if carry is not None else None
    if part.has_straddle:
        if node:
            partials = kern.node_slab_partials_tiles(
                part.a_val, part.a_col_s, part.a_run_start, part.a_run_len, part.a_run_slab,
                active, lb, ub, part.slab, part.a_max_run_len, inf, tile_slab=part.a_tile_slab,
                chunk_len=part.a_chunk_len, max_chunk_len=part.a_max_chunk_len,
            )
            strs = kern.straddle_combine_tiles(*partials, part.a_order, part.a_seg,
                                               part.agg_slot, active)
        else:
            # Kept across rounds: the single-instance and batch rounds
            # allocate nothing per round.
            partials = kern.batched_slab_partials_tiles(
                part.a_val, part.a_col_s, part.a_run_start, part.a_run_len, part.a_run_inst,
                part.a_run_slab, active, lb, ub, part.slab, part.a_max_run_len, inf,
                out=kept.scratch("slab_partials",
                                 kern.partial_specs(part.a_val.shape[:2], lb.dtype), lb),
                go=go,
            )
            specs = kern.straddle_specs(tuple(partials[0].shape), tuple(part.agg_slot.shape),
                                        part.a_seg.shape[0] - 1, lb.dtype)
            strs = kern.straddle_combine_tiles(*partials, part.a_order, part.a_seg,
                                               part.agg_slot, go,
                                               out=kept.scratch("straddle", specs, lb))
    else:
        shape = ((bsz,) if node else ()) + tuple(part.chunk_row.shape)
        z, zi = kept.scratch("no_straddle", ((shape, lb.dtype), (shape, torch.int32)), lb)
        strs = (z, zi, z, zi)
    common = (part.val, part.col_s, part.ii_g, part.row_done, *strs, part.lhs_g, part.rhs_g,
              part.run_start, part.run_len)
    hoisted = dict(acc=kept.get(lb), chunk_len=part.chunk_len, max_chunk_len=part.max_chunk_len)
    if carry is None:
        n_slabs = -(-lb.shape[1] // part.slab)
        hoisted["flags"] = kept.flags((bsz, n_slabs), torch.int32, lb)
        if progress is not None:
            hoisted.update(progress=progress, **kept.stop_buffers(lb))
    if node:
        lb, ub, ch = kern.node_slab_round_tiles(
            *common, part.run_slab, active, lb, ub, part.slab, part.max_run_len, eps, int_eps,
            inf, outward, tile_slab=part.tile_slab, **hoisted,
        )
    else:
        state, k, unroll = carry if carry is not None else (None, 0, 1)
        lb, ub, ch = kern.batched_slab_round_tiles(
            *common, part.run_inst, part.run_slab, active, lb, ub, part.slab,
            part.max_run_len, eps, int_eps, inf, outward,
            tiles=(part.tile_inst, part.tile_slab), carry=state, k=k, unroll=unroll, go=go,
            **(dict(stop=stop, partials=stop_partials) if carry is not None else {}),
            **hoisted,
        )
        if carry is not None:
            return lb, ub, None
    # Runs lie in window order: (plane, slab).
    return lb, ub, (ch.reshape(bsz, -1) != 0).any(dim=1)


def _partitioned_plain_round(
    part: SlabPartition, lb, ub, active, *, node: bool, eps: float, int_eps: float,
    inf: float, kept: KeptPlanes, outward: float = 0.0, carry=None,
    stop: EarlyStop | None = None, stop_partials=None, progress=None,
):
    """The plain partitioned round, as the reference's ``use_pallas=False``:
    ``ref.partitioned_round_ref`` (per active node under ``node=True``) and
    the shared merge; returns new ``(B, W)`` planes and ``(B,)`` flags, or
    with ``carry`` (as in :func:`_partitioned_kernel_round`) folds the
    flags, and with its ``stop`` the round's progress measure in #15's
    order (:func:`ref.merge_progress`), into it and returns None for them.
    ``progress`` takes each active plane's measure in #15's order
    (:func:`ref.merge_rows_progress`).  ``kept`` and ``stop_partials`` are
    not used: the plain round allocates its own planes."""
    del kept, stop_partials
    if node:
        best_l, best_u = kref.node_partitioned_round_ref(part, lb, ub, int_eps, inf,
                                                         active=active)
    else:
        best_l, best_u = kref.partitioned_round_ref(part, lb, ub, int_eps, inf)
    width = lb.shape[1]
    new_lb, new_ub, ch = bnd.apply_updates_batch(lb, ub, best_l[:, :width], best_u[:, :width],
                                                 eps, inf, outward, active=active)
    if carry is None:
        if progress is not None:
            kern._plain_row_progress(lb, ub, new_lb, new_ub, active, progress)
        return new_lb, new_ub, ch
    prog = kref.merge_progress(lb, ub, new_lb, new_ub) if stop is not None else None
    _carry.fold(carry[0], ch.any(), carry[1], carry[2], stop, prog)
    return new_lb, new_ub, None


KERNEL_OPS = RoundOps(
    kern.fused_scatter_round_tiles,
    kern.activities_gather_tiles,
    kern.combine_chunk_partials_tiles,
    kern.candidates_scatter_tiles,
    kern.apply_updates_tiles,
    _kernel_node_fused,
    kern.apply_updates_batch_tiles,
    _partitioned_kernel_round,
    kern.batched_fused_scatter_round_tiles,
    kern.activities_tiles,
    kern.candidates_tiles,
    kern.fused_round_tiles,
    kern.node_activities_gather_tiles,
    kern.node_combine_chunk_partials_tiles,
    kern.node_candidates_scatter_tiles,
)
PLAIN_OPS = RoundOps(
    _plain_fused,
    kref.activities_gather_tiles_ref,
    kref.combine_chunk_partials_ref,
    _plain_candidates,
    _plain_merge,
    _plain_node_fused,
    _plain_merge_batch,
    _partitioned_plain_round,
    _plain_batched_fused,
    kref.activities_tiles_ref,
    kref.candidates_tiles_ref,
    kref.fused_round_tiles_ref,
    kref.node_activities_gather_ref,
    kref.node_combine_chunk_partials_ref,
    kref.node_candidates_scatter_ref,
)


def _segment_round(
    ops: RoundOps, d: DeviceBlockEll, lb, ub, ii_g, lhs_g, rhs_g, row_start, index,
    width: int, *, fused: bool, eps: float, int_eps: float, inf: float, outward: float = 0.0,
    classes=None, carry=None, gate: bool = False, stop: EarlyStop | None = None, col=None,
):
    """One round of the segment (seed) dataflow over ``(width,)`` bounds:
    bounds gathered per slot, kernel C (``fused``) or kernel A, the fused
    engine's fixed-order combine (so both engines sum each row alike) and
    kernel B, the candidates written out, the column max/min over the slots
    of ``index`` (:func:`segment_reduce`), then the merge.  The per-slot
    marks and sides ``ii_g``, ``lhs_g``, ``rhs_g`` and the combine's
    ``row_start`` (and its segment ``classes``) come hoisted or per round
    from the caller.  F folds its flag into the loop carry ``carry``
    (``(state, k, unroll)``; a fresh one when None).  With ``gate`` (the
    kernels and a carry) C, A, the combine and B return at once where the
    carry's GO is false; the bound gather and the column reduction, in
    PyTorch, still run.  ``stop`` (the carry's early stop) goes to F.
    ``col`` is the gather's columns (default ``d.col``; the prepared round
    passes them widened once, :meth:`PreparedBlockEll.gather_columns`).
    Returns ``(lb, ub, changed)``, ``changed`` the carry's ``GO``; with
    kernels the bounds are updated in place."""
    state, k, unroll = carry if carry is not None else (None, 0, 1)
    gate = dict(go=_carry.go_mask(state)) if gate and state is not None else {}
    lb_g, ub_g = gather_bounds(lb, ub, d.col if col is None else col)
    if fused:
        lcand, ucand = ops.fused_round_tiles(d.val, lb_g, ub_g, ii_g, lhs_g, rhs_g, int_eps, inf,
                                             **gate)
    else:
        partials = ops.activities_tiles(d.val, lb_g, ub_g, inf, **gate)
        aggs = ops.combine(*partials, d.chunk_row, row_start, classes=classes, **gate)
        lcand, ucand = ops.candidates_tiles(d.val, lb_g, ub_g, ii_g, *aggs, lhs_g, rhs_g,
                                            int_eps, inf, **gate)
    best_l, best_u = segment_reduce(lcand, ucand, index, width, inf)
    return ops.merge(lb, ub, best_l, best_u, eps, inf, outward, carry=state, k=k, unroll=unroll,
                     **_merge_stop(stop, unroll))


def _merge_stop(stop: EarlyStop | None, unroll: int, partials=None) -> dict:
    """F's early-stop arguments for a round with the carry's ``stop``:
    none without one.  F measures one round, so a check group of several
    rounds cannot take it."""
    if stop is None:
        return {}
    if unroll != 1:
        raise ValueError(f"unroll={unroll}: kernel F's early stop takes one round a check group")
    return dict(stop=stop, partials=partials)


def _prepared_round(
    prep: PreparedBlockEll,
    lb,
    ub,
    *,
    ops: RoundOps,
    eps: float,
    int_eps: float,
    inf: float,
    fused: bool,
    outward: float = 0.0,
    kept: KeptPlanes,
    carry: tuple,
    part: SlabPartition | None = None,
    gate: bool = False,
    stop: EarlyStop | None = None,
):
    """One round over hoisted constants; (lb, ub) live in the column-padded
    ``(n_pad,)`` domain.  Returns ``(lb, ub, changed)``, ``changed`` the
    loop carry's ``GO`` (:mod:`core.carry`); with :data:`KERNEL_OPS` the
    bounds are updated in place.  D or E scatters into the closure's kept
    planes ``kept`` (each chunk stopped at its hoisted length, D's lanes set
    by the hoisted longest chunk) and F hands them back and folds its flag
    into the carry ``carry`` (``(state, k, unroll)``).  With ``gate`` (the
    kernels only) the kernels before F return at once where the carry's GO
    is false.  With a slab partition ``part`` the partitioned
    round runs (it ignores ``fused``: split rows are straddle rows there),
    the carry's GO as the instance's active mask, #12 scattering into
    ``kept`` and #15 folding its flags into the carry.  With the carry's
    early stop ``stop`` F (or #15) also folds the round's progress measure,
    each block's sum into a buffer kept in ``kept``."""
    d = prep.d
    state, k, unroll = carry
    go = _carry.go_mask(state)
    # The early stop's block sums of the round's merge (F, or #15), kept.
    stop_partials = None
    if stop is not None:
        blocks = -(-prep.n_pad // kref.MERGE_BLOCK)
        (stop_partials,) = kept.scratch("progress", (((blocks,), lb.dtype),), lb)
    if part is not None:
        new_lb, new_ub, _ = ops.partitioned(
            part, lb[None], ub[None], go, node=False, eps=eps, int_eps=int_eps, inf=inf,
            outward=outward, kept=kept, carry=carry, stop=stop, stop_partials=stop_partials,
        )
        return new_lb[0], new_ub[0], _carry.go_flag(state)
    acc = kept.get(lb)
    gate = dict(go=go) if gate else {}
    if fused:
        best_l, best_u = ops.fused(
            d.val, d.col, prep.ii_g, prep.lhs_g, prep.rhs_g, lb, ub, prep.n_pad, int_eps, inf,
            acc=acc, chunk_len=prep.chunk_len, max_chunk_len=prep.max_chunk_len, **gate,
        )
    else:
        # Long rows: chunk partials -> each row's partials summed left to
        # right (one fixed order on every device, so a node's round equals
        # its single-instance round bitwise) -> candidates + column reduction.
        partials = ops.activities(d.val, d.col, lb, ub, prep.n_pad, inf,
                                  chunk_len=prep.chunk_len, **gate)
        rmf, rmc, rxf, rxc = ops.combine(*partials, d.chunk_row, prep.row_start,
                                         classes=prep.seg_classes, **gate)
        best_l, best_u = ops.candidates(
            d.val, d.col, prep.ii_g, rmf, rmc, rxf, rxc,
            prep.lhs_g, prep.rhs_g, lb, ub, prep.n_pad, int_eps, inf, chunk_len=prep.chunk_len,
            acc=acc, **gate,
        )
    return ops.merge(lb, ub, best_l, best_u, eps, inf, outward, carry=state, k=k, unroll=unroll,
                     **_merge_stop(stop, unroll, stop_partials))


# A mirror of the reference's escape hatch, kept for parity only (callers
# choose an engine with ``scatter=``): REPRO_AUTO_LARGE_SCATTER=segment
# routes ``propagate_block_ell``'s ``scatter="auto"`` past SCATTER_MAX_NPAD
# to the segment engine instead of the partitioned one, and so does the
# plain node round (``use_kernels=False``); the node round on the kernels
# ignores it, as the reference's Pallas path does.  Read at call time.
AUTO_LARGE_SCATTER_ENV = "REPRO_AUTO_LARGE_SCATTER"


def _auto_large_scatter() -> str:
    mode = os.environ.get(AUTO_LARGE_SCATTER_ENV, "partitioned")
    if mode not in ("partitioned", "segment"):
        raise ValueError(
            f"{AUTO_LARGE_SCATTER_ENV}={mode!r}: expected 'partitioned' or 'segment'"
        )
    return mode


def _resolve_scatter(scatter: str, prep: PreparedBlockEll) -> str:
    """The engine decision, as the reference's: ``auto`` keeps the fused
    round while ``n_pad <= SCATTER_MAX_NPAD`` (read at call time) and takes
    the column-slab ``partitioned`` round beyond it (or the one that
    :data:`AUTO_LARGE_SCATTER_ENV` names); ``fused``, ``segment`` and
    ``partitioned`` run at any ``n_pad``, at float64 or float32."""
    if scatter == "auto":
        scatter = "fused" if prep.n_pad <= SCATTER_MAX_NPAD else _auto_large_scatter()
    if scatter not in ("fused", "segment", "partitioned"):
        raise ValueError(f"unknown scatter mode: {scatter!r}")
    return scatter


def round_fn_for(
    prep: PreparedBlockEll,
    cfg: PropagatorConfig = DEFAULT_CONFIG,
    use_kernels: bool = True,
    scatter: str = "fused",
    fused: bool | None = None,
    slab: int | None = None,
):
    """A ``(lb, ub) -> (lb, ub, changed)`` round closure over a prepared
    instance (bounds in the ``(n_pad,)`` domain).  ``slab`` overrides the
    partitioned engine's column-slab width (default
    :func:`default_slab_width`; ignored by the other engines).

    The closure owns a loop carry (its ``carry``, :class:`core.carry.
    LoopCarry`) that the round's last kernel updates on the device.  A
    driver arms it for a fixed point (:func:`core.propagator.fixed_point`,
    :func:`core.propagator.device_fixed_point`); then ``changed`` is a view
    of the carry's GO, which the next round overwrites: read it before the
    next call.  A call outside a driver is a fixed point of its own: a
    fresh carry, and ``changed`` (a view of that carry alone) says whether
    the round tightened a bound.  On the kernels every kernel of the round
    returns at once where the carry's GO is false (a round enqueued after
    convergence); the closure's ``gated`` says whether that is all the
    round does then (the fused and partitioned engines), which the device
    loop reads to size its read groups (:func:`core.propagator.loop_group`).
    The segment engine's bound gather and column reduction and the plain
    versions run in full.  On the kernels the closure's ``record`` is the
    telemetry's record kernel (``prop_round.RecordLaunch``, checked once a
    fixed point), which the drivers launch after each round when asked for
    telemetry; the plain closures leave it to its plain version."""
    scatter = _resolve_scatter(scatter, prep)
    do_fuse = prep.fits_one_chunk if fused is None else bool(fused)
    dt = prep.d.val.dtype
    eps, outward = cfg.eps_for(dt), cfg.outward_for(dt)
    ops = KERNEL_OPS if use_kernels else PLAIN_OPS
    carry = LoopCarry()
    if scatter == "segment":
        def round_fn(lb, ub):
            return _segment_round(
                ops, prep.d, lb, ub, prep.ii_g, prep.lhs_g, prep.rhs_g, prep.row_start,
                prep.segment_index(), prep.n_pad, fused=do_fuse, eps=eps,
                int_eps=cfg.int_eps, inf=cfg.inf, outward=outward, classes=prep.seg_classes,
                carry=carry.step(lb.device), gate=use_kernels, stop=carry.stop,
                col=prep.gather_columns(),
            )

        round_fn.carry, round_fn.gated = carry, False
        if use_kernels:
            round_fn.record = kern.RecordLaunch
        return round_fn
    part = prep.slab_partition(slab) if scatter == "partitioned" else None
    kept = KeptPlanes(cfg.inf)

    def round_fn(lb, ub):
        return _prepared_round(
            prep, lb, ub, ops=ops, eps=eps, int_eps=cfg.int_eps, inf=cfg.inf,
            fused=do_fuse, outward=outward, part=part, kept=kept, carry=carry.step(lb.device),
            gate=use_kernels, stop=carry.stop,
        )

    run = kept.guard(round_fn)
    run.carry, run.gated = carry, use_kernels
    if use_kernels:
        run.record = kern.RecordLaunch
    return run


def block_ell_round(
    d: DeviceBlockEll,
    lb,
    ub,
    m: int,
    n: int,
    eps: float,
    int_eps: float,
    inf: float = INF,
    use_kernels: bool = True,
    fused: bool = False,
    outward: float = 0.0,
):
    """One propagation round over block-ELL tiles in the seed dataflow, the
    reference's legacy baseline (src/repro/kernels/ops.py:757): bounds in
    the unpadded ``(n,)`` domain, the structure work (``is_int[col]``,
    ``lhs1[chunk_row]``, ``rhs1[chunk_row]``, the combine's row starts and
    the reduction's :func:`segment_index`) redone every round, kernel C
    (``fused``) or kernel A, the fixed-order combine and kernel B, the
    candidates written out, a column reduction over ``n`` columns, then
    the merge.  Float64 or float32 (a compact prep's int16 columns widened
    with the rest of the structure work; its int8 marks are gathered anew
    as int32).  Returns ``(lb, ub, changed)``; with kernels the bounds are
    updated in place."""
    col = d.col.long()
    crow = d.chunk_row.long()
    row_start = None if fused else kref.row_starts(d.chunk_row, m + 1)
    return _segment_round(
        KERNEL_OPS if use_kernels else PLAIN_OPS, d, lb, ub, d.is_int[col].to(torch.int32),
        d.lhs1[crow], d.rhs1[crow], row_start, segment_index(d.val, d.col), n, fused=fused,
        eps=eps, int_eps=int_eps, inf=inf, outward=outward,
    )


def legacy_round_fn_for(
    prep: PreparedBlockEll, cfg: PropagatorConfig = DEFAULT_CONFIG, use_kernels: bool = True
):
    """The seed round (:func:`block_ell_round`) as a ``(lb, ub) -> (lb, ub,
    changed)`` closure over a prepared instance, bounds in the unpadded
    ``(n,)`` domain (src/repro/kernels/ops.py:1038).  Kept as the measured
    baseline; it reads only the prep's tiles, at the prep's dtype (float32
    widens the merges outward, as the reference's does)."""
    dt = prep.d.val.dtype
    eps, outward = cfg.eps_for(dt), cfg.outward_for(dt)

    def round_fn(lb, ub):
        return block_ell_round(
            prep.d, lb, ub, prep.m, prep.n, eps, cfg.int_eps, cfg.inf, use_kernels,
            prep.fits_one_chunk, outward,
        )

    return round_fn


def _initial_padded_bounds(prep: PreparedBlockEll, lb0, ub0):
    """Per-call bound overrides -> private ``(n_pad,)`` tensors that the
    in-place merge may overwrite."""
    lb = prep.lb0.clone() if lb0 is None else prep.pad_bound(lb0)
    ub = prep.ub0.clone() if ub0 is None else prep.pad_bound(ub0)
    return lb, ub


def propagate_block_ell(
    p: Problem,
    cfg: PropagatorConfig = DEFAULT_CONFIG,
    tile_rows: int = 8,
    tile_width: int = 128,
    dtype=None,
    use_kernels: bool = True,
    fused: str = "auto",
    driver: str = "device_loop",
    scatter: str = "auto",
    lb0=None,
    ub0=None,
    slab: int | None = None,
    stop_progress: float | None = None,
    patience: int = 1,
    policy=None,
    telemetry: int | None = None,
    donate: bool | None = None,
    device="cuda",
    on_sync: Callable[[], None] | None = None,
) -> PropagationResult:
    """Kernel-backed propagation of one instance.

    ``fused='auto'`` runs kernel D whenever every row fits one chunk and the
    A'/E pair otherwise (``'yes'``/``'no'`` force one; under
    ``scatter='segment'`` kernel C or the A/B pair).  ``scatter='auto'``
    takes that fused engine while ``n_pad <= SCATTER_MAX_NPAD`` and the
    column-slab ``'partitioned'`` engine beyond it (``slab`` overrides its
    window width; ``REPRO_AUTO_LARGE_SCATTER=segment`` takes the segment
    engine there instead); each may be asked for at any size.  ``use_kernels=False``
    runs the kernels' plain PyTorch versions instead (the counterpart of the
    reference's ``use_pallas=False``); on a CPU device the wrappers run the
    plain versions either way.  ``lb0``/``ub0`` warm-start the fixed point
    from ``(n,)`` caller bounds on the cached prepared tiles.

    ``device`` defaults to CUDA and raises where there is none; pass
    ``device="cpu"`` to run on the CPU.  ``driver`` takes the reference's
    two: ``"host_loop"`` reads the round's flag on the host once per round;
    ``"device_loop"`` (:func:`core.propagator.device_fixed_point`, one
    round per check) enqueues rounds whose last kernel keeps the loop state
    in the round closure's carry on the device, and reads it once per
    :func:`core.propagator.loop_group` rounds.  Both give the same
    rounds, flags and bounds, bit for bit; ``on_sync`` is called once per
    host read.  ``"unrolled"`` raises ``ValueError``, as the reference's
    does.

    ``dtype`` is float64 (the default) or float32, on every engine.
    ``stop_progress``/``patience`` arm the progress-based early stop: F
    (#15 on the partitioned engine) folds each round's measure into the
    loop carry and clears its GO once it stayed below ``stop_progress``
    for ``patience`` rounds.  ``policy`` (a
    :class:`~repro_torch.core.types.TierPolicy`) runs the reference's
    two-tier scheme (:func:`core.propagator.run_tiers`): a float32 tier
    early-stopped at ``policy.switch_progress``, promotion, and the endgame
    in ``dtype``; each tier runs on its own dtype-keyed prep and round
    closure.

    ``telemetry`` (a ring capacity) attaches an ``obs.TelemetrySnapshot``
    to the result, on every engine and driver: on ``device_loop`` the
    record kernel (``csrc/telemetry.cu``) runs after each round's last
    kernel (F, or #15) and writes the round's measure (kept in the loop
    carry by F's or #15's stop form, armed without a threshold where no
    stop is), the infeasibility probe and the early stop into a plane on
    the device; on ``host_loop`` it writes the probe into the carry and
    the host builds the history from the carry's one read a round.  No
    read is added and every other field is bitwise telemetry-off's; under
    a two-tier ``policy`` the snapshot nests the fp32 tier's (``fp32``,
    ``tier_switch_round``).  ``donate`` is accepted for the reference's
    signature and changes nothing: the fixed point already runs in place
    on private copies of the bounds, never on the prep's cached ones."""
    if driver not in KERNEL_DRIVERS:
        raise ValueError(f"unknown driver: {driver!r}")

    def single(cfg_, dtype_, lb0_, ub0_, stop_progress_, patience_):
        return _propagate_prepared(
            prepare_block_ell(p, tile_rows, tile_width, dtype_, device), cfg_, use_kernels,
            fused, driver, scatter, lb0_, ub0_, slab, early_stop(stop_progress_, patience_),
            on_sync, telemetry,
        )

    return run_tiers(single, cfg, dtype, lb0, ub0, policy, stop_progress, patience, on_sync)


def _propagate_prepared(prep: PreparedBlockEll, cfg: PropagatorConfig, use_kernels: bool,
                        fused: str, driver: str, scatter: str, lb0, ub0, slab: int | None,
                        stop: EarlyStop | None, on_sync,
                        telemetry: int | None = None) -> PropagationResult:
    """One single-dtype fixed point of :func:`propagate_block_ell`."""
    do_fuse = prep.fits_one_chunk if fused == "auto" else bool(fused == "yes" or fused is True)
    round_fn = round_fn_for(prep, cfg, use_kernels, scatter, do_fuse, slab)
    lb, ub = _initial_padded_bounds(prep, lb0, ub0)
    tel = dict(telemetry=telemetry, feas_eps=cfg.feas_eps)
    if driver == "host_loop":
        out = fixed_point(round_fn, lb, ub, cfg.max_rounds, on_sync, stop=stop, **tel)
    else:
        out = device_fixed_point(round_fn, lb, ub, cfg.max_rounds, on_sync=on_sync, stop=stop,
                                 **tel)
    lb, ub, rounds, changed, prog = out[:5]
    return _result(lb[: prep.n], ub[: prep.n], rounds, changed, prog, cfg.feas_eps, *out[5:])


# ---------------------------------------------------------------------------
# Batched engine: a whole packed bucket of instances per fixed point
# ---------------------------------------------------------------------------


class DeviceProblemBatch(NamedTuple):
    """A packed bucket as tensors on one device: the flat tile stream, the
    hoisted round constants, initial bounds and the real-column mask.
    ``col`` keeps instance-local columns (kernel #8 routes each tile by
    ``tile_inst``); ``col_g`` holds the global ids ``col + tile_inst *
    n_pad`` into the flattened planes for the multi-chunk round."""

    val: torch.Tensor        # (T, R, K) float64 or float32
    col: torch.Tensor        # (T, R, K) int32 instance-local
    col_g: torch.Tensor      # (T, R, K) int32 global (bound-plane) columns
    chunk_row: torch.Tensor  # (T, R) int32 global row ids, ascending
    tile_inst: torch.Tensor  # (T,) int32 instance of each tile
    ii_g: torch.Tensor       # (T, R, K) int32: is_int at each slot's column, hoisted
    lhs_g: torch.Tensor      # (T, R): lhs1[chunk_row], hoisted
    rhs_g: torch.Tensor      # (T, R)
    chunk_len: torch.Tensor  # (T, R) int32: one past each chunk's last nonzero (A', E, #8)
    chunks: torch.Tensor     # (B + 1,) int64: instance i's chunks [chunks[i], chunks[i+1]) (#8)
    lb0: torch.Tensor        # (B, n_pad)
    ub0: torch.Tensor        # (B, n_pad)
    col_valid: torch.Tensor  # (B, n_pad) bool: j < n_i (real columns)


@dataclasses.dataclass(frozen=True)
class PreparedBatch:
    """One packed bucket, on its device: what a batched round reads and
    never changes.  ``row_start`` is the long-row combine's index over the
    flat stream's global rows (instance row offsets, one dummy row each)."""

    batch: ProblemBatch
    d: DeviceProblemBatch
    size: int
    m_total: int
    n_pad: int
    fits_one_chunk: bool
    row_start: torch.Tensor  # (m_total + 1,) int64
    seg_classes: tuple       # the combine's (short, long) int32 segment ids, hoisted
    max_chunk_len: int       # max(d.chunk_len): the strides #8 holds per lane
    # Slab partitions of the packed stream keyed by slab width.
    _slabs: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    def slab_partition(self, slab: int | None = None) -> SlabPartition:
        """The bucket's flat stream re-bucketed into per-instance
        ``slab``-wide column windows (default :func:`default_slab_width`
        under :data:`SLAB_NPAD`, read at call time), built once per width
        from the host-side packed arrays at the bucket's value type (as the
        reference's, src/repro/kernels/ops.py:1423); instance ``i``'s padding
        chunks sit on its dummy row, the last of its row range."""
        s = default_slab_width(self.n_pad, SLAB_NPAD) if slab is None else int(slab)
        part = self._slabs.get(s)
        if part is None:
            ell = self.batch.ell
            dt = np.dtype(str(self.d.val.dtype).removeprefix("torch."))
            part = self._slabs[s] = build_slab_partition(
                np.asarray(ell.val, dtype=dt), ell.col, ell.chunk_row, ell.tile_inst,
                self.batch.lhs1, self.batch.rhs1, self.batch.is_int, self.n_pad, s,
                (ell.row_offset[1:] - 1).astype(np.int32), device=self.d.val.device,
            )
        return part


_batch_prep_cache = LRU(maxsize=16)


def prepare_problem_batch(batch: ProblemBatch, dtype=None, device="cuda") -> PreparedBatch:
    """Upload + hoisted round constants of one packed bucket, LRU-cached per
    ``ProblemBatch`` identity, dtype and device (maxsize 16, see
    :func:`cache_info`): a serving loop re-propagates the same packed batch
    with fresh bounds, which every driver takes per call.  ``dtype`` is
    float64 (the default) or float32 (the fp32 tier; the ids stay int32,
    as the reference's packed batch keeps them)."""
    dev = resolve_device(device)
    dt = check_dtype(dtype)
    key = (id(batch), str(dt), str(dev))
    hit = _batch_prep_cache.get(key, (batch,))
    if hit is not None:
        return hit
    ell = batch.ell
    n_pad = batch.n_pad
    col_g = ell.col + ell.tile_inst[:, None, None] * np.int32(n_pad)
    t = lambda x, d=dt: torch.as_tensor(np.asarray(x), dtype=d, device=dev)
    chunk_row = t(ell.chunk_row, torch.int32)
    tile_inst = t(ell.tile_inst, torch.int32)
    val = t(ell.val)
    d = DeviceProblemBatch(
        val=val,
        col=t(ell.col, torch.int32),
        col_g=t(col_g, torch.int32),
        chunk_row=chunk_row,
        tile_inst=tile_inst,
        ii_g=t(batch.is_int.reshape(-1)[col_g], torch.int32),
        lhs_g=t(batch.lhs1[ell.chunk_row]),
        rhs_g=t(batch.rhs1[ell.chunk_row]),
        chunk_len=kref.chunk_lengths(val),
        chunks=kref.instance_chunks(tile_inst, ell.tile_rows, batch.size),
        lb0=t(batch.lb),
        ub0=t(batch.ub),
        col_valid=t(np.arange(n_pad)[None, :] < ell.n[:, None], torch.bool),
    )
    row_start = kref.row_starts(chunk_row, batch.m_total)
    prep = PreparedBatch(
        batch=batch,
        d=d,
        size=batch.size,
        m_total=batch.m_total,
        n_pad=n_pad,
        fits_one_chunk=all(rows_fit_one_chunk(p, ell.tile_width) for p in batch.problems),
        row_start=row_start,
        seg_classes=kref.segment_classes(row_start),
        max_chunk_len=int(d.chunk_len.max()) if d.chunk_len.numel() else 0,
    )
    _batch_prep_cache.put(key, (batch,), prep)
    return prep


def batched_reference_round(
    val, col, col_g, tile_inst, ii_g, chunk_row, row_start, lhs_g, rhs_g, lb, ub, active,
    *, n_pad: int, fits_one_chunk: bool, eps: float, int_eps: float, inf: float,
    kept: KeptPlanes, outward: float = 0.0, ops: RoundOps = KERNEL_OPS, chunk_len=None,
    max_chunk_len: int | None = None, chunks=None, classes=None, progress=None,
):
    """One batched round over a flat stream, IN PLACE with
    :data:`KERNEL_OPS`: ``(B, n_pad)`` planes + ``(B,)`` active mask ->
    ``(lb, ub, (B,) changed)``.  The counterpart of the reference's XLA
    dataflow ``batched_reference_round`` (src/repro/kernels/ops.py:1492),
    here on the ported kernels.  Rows that fit one chunk: kernel #8 (which
    computes exactly the reference's fused dataflow) into the kept planes
    ``kept``, over each instance's chunk range ``chunks`` (``(B + 1,)``
    int64, :func:`ref.instance_chunks`), each chunk stopped at its length
    (``chunk_len``; ``max_chunk_len`` the longest).  Otherwise A', the
    combine and E on the flat stream with global columns ``col_g`` over the
    ``(B * n_pad,)`` view of the planes; the candidates of inactive
    instances are then forced to the sentinel.  Then the batched merge #9,
    which leaves inactive rows as they are and writes its flags into a
    pair kept in ``kept`` (valid until the next round).  The combine's segments
    ``(chunk_row, row_start)`` are the global rows (``row_start`` from the
    ascending ``chunk_row``), or any finer split into runs of adjacent
    chunks that keeps each real row whole (the service's), split into short
    and long by ``classes`` (:func:`ref.segment_classes`).  ``chunk_len``
    (the stream's :func:`ref.chunk_lengths`) is where A' and E stop each
    chunk.  All are hoisted by the caller; the kernels compute them when
    they are omitted.  With ``progress`` (a ``(B,)`` tensor of the planes'
    dtype) #9 also writes each active row's early-stop measure of the
    round into it (its partials and ticket kept in ``kept``)."""
    if fits_one_chunk:
        best_l, best_u = ops.batched_fused(
            val, col, ii_g, lhs_g, rhs_g, lb, ub, tile_inst, active, n_pad, int_eps, inf,
            acc=kept.get(lb), chunk_len=chunk_len, max_chunk_len=max_chunk_len, chunks=chunks,
        )
    else:
        bsz = lb.shape[0]
        width = bsz * n_pad
        lbf, ubf = lb.view(width), ub.view(width)
        partials = ops.activities(val, col_g, lbf, ubf, width, inf, chunk_len=chunk_len)
        aggs = ops.combine(*partials, chunk_row, row_start, classes=classes)
        best_l, best_u = ops.candidates(val, col_g, ii_g, *aggs, lhs_g, rhs_g, lbf, ubf, width,
                                        int_eps, inf, chunk_len=chunk_len)
        on = active[:, None]
        best_l = torch.where(on, best_l.view(bsz, n_pad), -inf)
        best_u = torch.where(on, best_u.view(bsz, n_pad), inf)
    return ops.merge_batch(lb, ub, best_l, best_u, active, eps, inf, outward,
                           flags=kept.flags(active.shape, torch.bool, lb),
                           **_row_stop(kept, lb, progress))


def _row_stop(kept: KeptPlanes, lb, progress) -> dict:
    """#9's early-stop arguments for a round whose loop measures every
    round (``progress``, the loop's ``(B,)`` measure): none without it."""
    if progress is None:
        return {}
    return dict(progress=progress, **kept.stop_buffers(lb))


def _batched_prepared_round(
    prep: PreparedBatch, lb, ub, active, *, ops: RoundOps, eps: float, int_eps: float,
    inf: float, kept: KeptPlanes, slab: int | None = None, outward: float = 0.0,
    progress=None,
):
    """One round over a prepared bucket, with the reference's rule: past
    ``SCATTER_MAX_NPAD`` (read at call time) the partitioned round over the
    bucket's slab partition (#11, the straddle combine, #12 with #15:
    copies routed to their instance's plane by the hoisted tile maps,
    inactive instances skipped on the device, #12 scattering into
    ``kept``, #15 measuring each active row's round into ``progress`` where
    given); otherwise :func:`batched_reference_round` (#8 scattering into
    ``kept``; ``progress`` as there)."""
    if prep.n_pad > SCATTER_MAX_NPAD:
        part = prep.slab_partition(slab)
        return ops.partitioned(
            part, lb, ub, active, node=False, eps=eps, int_eps=int_eps, inf=inf,
            outward=outward, kept=kept, progress=progress,
        )
    d = prep.d
    return batched_reference_round(
        d.val, d.col, d.col_g, d.tile_inst, d.ii_g, d.chunk_row, prep.row_start, d.lhs_g,
        d.rhs_g, lb, ub, active, n_pad=prep.n_pad, fits_one_chunk=prep.fits_one_chunk,
        eps=eps, int_eps=int_eps, inf=inf, kept=kept, outward=outward, ops=ops,
        chunk_len=d.chunk_len, max_chunk_len=prep.max_chunk_len, chunks=d.chunks,
        classes=prep.seg_classes, progress=progress,
    )


def batched_round_fn_for(
    prep: PreparedBatch, cfg: PropagatorConfig = DEFAULT_CONFIG, use_kernels: bool = True,
    slab: int | None = None,
):
    """A ``(lb, ub, active) -> (lb, ub, changed)`` round closure over a
    prepared bucket (``(B, n_pad)`` planes, updated in place with kernels).
    ``slab`` overrides the partitioned engine's window width.  The closure
    is ``measured``: with ``progress=`` (a ``(B,)`` tensor) #9 writes each
    active row's early-stop measure of the round into it
    (``core.propagator.batched_step_rounds`` passes it under a stop, or
    for telemetry); on the kernels its ``record_batch`` is the batched
    record kernel."""
    dt = prep.d.val.dtype
    eps, outward = cfg.eps_for(dt), cfg.outward_for(dt)
    ops = KERNEL_OPS if use_kernels else PLAIN_OPS
    kept = KeptPlanes(cfg.inf)

    def round_fn(lb, ub, active, progress=None):
        return _batched_prepared_round(
            prep, lb, ub, active, ops=ops, eps=eps, int_eps=cfg.int_eps, inf=cfg.inf,
            slab=slab, outward=outward, kept=kept, progress=progress,
        )

    return _measured(kept.guard(round_fn), use_kernels)


def _measured(round_fn: Callable, use_kernels: bool) -> Callable:
    """Mark a batched round closure as taking ``progress=`` (its merge
    measures the round for the early stop and the telemetry) and, on the
    kernels, give it the batched record kernel as its ``record_batch``."""
    round_fn.measured = True
    if use_kernels:
        round_fn.record_batch = kern.RecordBatchLaunch
    return round_fn


def _unpack_batch_results(prep: PreparedBatch, lb, ub, rounds, converged, infeasible, progress,
                          plane=None):
    """One :class:`PropagationResult` per instance (bucket order), each a
    view of the bucket's tensors, unpadded to the instance's ``n``; with a
    telemetry ``plane`` each carries the snapshot of its row (one plane
    shared by the bucket, read only when a snapshot is)."""
    no_tier = torch.zeros_like(rounds)
    return [
        PropagationResult(lb[i, : p.n], ub[i, : p.n], rounds[i], converged[i], infeasible[i],
                          progress[i], no_tier[i],
                          obs.TelemetrySnapshot(plane=plane, index=i) if plane is not None
                          else None)
        for i, p in enumerate(prep.batch.problems)
    ]


# Fixed-point runners, cached per prepared bucket and config (maxsize 64, see
# :func:`cache_info`).  PyTorch runs eagerly, so a runner is only the round
# closure and its loop; bounds are per-call arguments.
_batch_runner_cache = LRU(maxsize=64)


def _batch_runner(prep: PreparedBatch, cfg, use_kernels: bool, slab,
                  stop_progress: float | None = None, patience: int = 1,
                  telemetry: int | None = None):
    tel = int(telemetry or 0)
    key = (id(prep), cfg, use_kernels, slab, stop_progress, patience, tel)
    run = _batch_runner_cache.get(key, (prep,))
    if run is not None:
        return run
    round_fn = batched_round_fn_for(prep, cfg, use_kernels, slab)
    col_valid = prep.d.col_valid

    def run(lb0, ub0, on_sync: Callable[[], None] | None = None):
        plane = (obs.device_plane(tel, batch=lb0.shape[0], dtype=lb0.dtype, device=lb0.device)
                 if tel else None)
        out = batched_fixed_point(
            round_fn, lb0, ub0, cfg.max_rounds, stop_progress=stop_progress,
            patience=patience, with_progress=True, plane=plane, feas_eps=cfg.feas_eps,
            on_sync=on_sync,
        )
        lb, ub, rounds, converged, progress = out[:5]
        infeasible = ((lb > ub + cfg.feas_eps) & col_valid).any(dim=-1)
        return (lb, ub, rounds, converged, infeasible, progress) + out[5:]

    _batch_runner_cache.put(key, (prep,), run)
    return run


def batched_device_runner(
    prep: PreparedBatch, cfg: PropagatorConfig = DEFAULT_CONFIG, use_kernels: bool = True,
    slab: int | None = None, stop_progress: float | None = None, patience: int = 1,
    donate: bool | None = None, telemetry: int | None = None,
):
    """The bucket's whole fixed point as one function, cached: ``run(lb0,
    ub0, on_sync=None) -> (lb, ub, rounds, converged, infeasible,
    progress)``, all per instance, over private ``(B, n_pad)`` planes that
    it updates in place.  The loop reads ``active.any()`` on the host once
    per round (reported to ``on_sync``).  ``stop_progress``/``patience``
    arm the per-instance early stop (#9 measures every round).
    ``telemetry`` (a ring capacity) appends the bucket's
    ``obs.TelemetryPlane``, recorded every round by the batched record
    kernel (its plain version off the kernels).  ``donate`` is accepted for
    the reference's signature and changes nothing (the planes are
    private)."""
    del donate
    return _batch_runner(prep, cfg, use_kernels, slab, stop_progress, patience, telemetry)


def _batch_initial_bounds(prep: PreparedBatch, lb0, ub0):
    """Per-call ``(B, n_pad)`` bound planes (default: the packed instances'
    own bounds) -> private tensors that the in-place rounds may overwrite."""
    d = prep.d
    out = []
    for override, default in ((lb0, d.lb0), (ub0, d.ub0)):
        if override is None:
            out.append(default.clone())
            continue
        arr = torch.as_tensor(override, dtype=default.dtype, device=default.device)
        if arr.shape != default.shape:
            raise ValueError(
                f"bound plane has shape {tuple(arr.shape)}, expected {tuple(default.shape)}"
            )
        out.append(arr.clone())
    return tuple(out)


def propagate_batch_prepared(
    prep: PreparedBatch,
    cfg: PropagatorConfig = DEFAULT_CONFIG,
    use_kernels: bool = True,
    driver: str = "device_loop",
    lb0=None,
    ub0=None,
    slab: int | None = None,
    stop_progress: float | None = None,
    patience: int = 1,
    telemetry: int | None = None,
    on_sync: Callable[[], None] | None = None,
    donate: bool | None = None,
):
    """Run one prepared bucket to its per-instance fixed points.  Returns one
    :class:`PropagationResult` per instance, bucket order.

    Both drivers run the batched fixed point with the per-instance mask on
    the device (:func:`batched_device_runner`), which reads one flag on the
    host per round (``on_sync``) and measures every round's progress: in
    this port ``"host_loop"`` is a name for the same loop.
    ``lb0``/``ub0`` warm-start the bucket from ``(B, n_pad)`` planes through
    the same prepared tiles.  ``stop_progress``/``patience`` arm the
    per-instance early stop: an instance whose round's progress measure
    stays below ``stop_progress`` for ``patience`` rounds stops (not
    converged).  ``telemetry`` (a ring capacity) attaches per-instance
    ``obs.TelemetrySnapshot``s, the rows of one plane recorded on the
    device every round (``TelemetrySnapshot(plane, index=i)``), on both
    drivers.  ``donate`` changes nothing (the planes are private copies)."""
    if driver not in KERNEL_DRIVERS:
        raise ValueError(f"unknown driver: {driver!r}")
    del donate
    run = _batch_runner(prep, cfg, use_kernels, slab, stop_progress, patience, telemetry)
    lb, ub = _batch_initial_bounds(prep, lb0, ub0)
    return _unpack_batch_results(prep, *run(lb, ub, on_sync))


# Packed-batch cache (maxsize 8): serving re-propagates the same request
# list, and repacking would defeat the prepare and runner caches (both key
# on object identity).
_pack_cache = LRU(maxsize=8)


def packed_problems(problems, tile_rows: int = 8, tile_width: int = 128):
    """LRU-cached :func:`~repro_torch.core.sparse.pack_problems`: the same
    problem list (by identity) packs once."""
    problems = list(problems)
    anchors = tuple(problems)
    key = (tuple(id(p) for p in problems), tile_rows, tile_width)
    hit = _pack_cache.get(key, anchors)
    if hit is not None:
        return hit
    batches = pack_problems(problems, tile_rows=tile_rows, tile_width=tile_width)
    _pack_cache.put(key, anchors, batches)
    return batches


def clear_batch_caches() -> None:
    """Drop packed batches, prepared buckets and batch runners."""
    _pack_cache.clear()
    _batch_prep_cache.clear()
    _batch_runner_cache.clear()


def _bound_planes_for_batch(prep: PreparedBatch, bounds):
    """Per-problem ``(lb, ub)`` overrides (input order; ``None`` keeps the
    problem's own bounds; arrays or tensors, cast to the prep's dtype) ->
    the bucket's ``(B, n_pad)`` planes on its device, or ``(None, None)``
    when no instance of the bucket is overridden."""
    batch = prep.batch
    lb_plane, ub_plane = prep.d.lb0.clone(), prep.d.ub0.clone()
    as_plane = lambda x: torch.as_tensor(x, dtype=lb_plane.dtype, device=lb_plane.device)
    touched = False
    for row, (idx, p) in enumerate(zip(batch.indices, batch.problems)):
        pair = bounds[idx]
        if pair is None:
            continue
        lb_i, ub_i = as_plane(pair[0]), as_plane(pair[1])
        if tuple(lb_i.shape) != (p.n,) or tuple(ub_i.shape) != (p.n,):
            raise ValueError(
                f"bounds for instance {idx} have shapes {tuple(lb_i.shape)}/"
                f"{tuple(ub_i.shape)}, expected {(p.n,)}"
            )
        lb_plane[row, : p.n] = lb_i
        ub_plane[row, : p.n] = ub_i
        touched = True
    if not touched:
        return None, None
    return lb_plane, ub_plane


def propagate_batch_block_ell(
    problems,
    cfg: PropagatorConfig = DEFAULT_CONFIG,
    tile_rows: int = 8,
    tile_width: int = 128,
    dtype=None,
    use_kernels: bool = True,
    driver: str = "device_loop",
    bounds=None,
    slab: int | None = None,
    stop_progress: float | None = None,
    patience: int = 1,
    policy: TierPolicy | None = None,
    telemetry: int | None = None,
    donate: bool | None = None,
    device="cuda",
    on_sync: Callable[[], None] | None = None,
) -> "list[PropagationResult]":
    """Batched kernel-backed propagation: pack (bucketed by ``col_pad(n)``)
    -> one fixed point per bucket -> one result per instance, input order.
    Packing, upload and the runners are LRU-cached on the identity of the
    problem list and packed batch, so a serving loop pays them once.
    ``bounds`` (one ``(lb, ub)`` pair of ``(n_i,)`` arrays or tensors, or
    ``None``, per problem) warm-starts instances through the same packed
    tiles.  The public front end is ``core.propagate_batch``.

    ``dtype`` is float64 (the default) or float32.  ``stop_progress``/
    ``patience`` arm the per-instance early stop.  ``policy`` (a
    :class:`TierPolicy`) runs the whole batch through the two tiers, as
    the reference's (src/repro/kernels/ops.py:1917-1963): a float32 pass
    of at most ``max(1, int(max_rounds * fp32_round_frac))`` rounds,
    stopped per instance below ``switch_progress``; each instance promoted
    by an exact cast with the infinite sentinels restored, except that an
    instance with an fp32 infeasible verdict restarts from its original
    bounds; the endgame of at most ``max(1, max_rounds - cap)`` rounds in
    ``dtype`` with the policy's ``stop_progress``.  ``rounds`` adds the
    tier's rounds where it was trusted, and ``tier_rounds`` is the tier's.
    The tier's verdicts are read on the host at once (reported to
    ``on_sync``).  ``device`` defaults to CUDA and raises where there is
    none.  ``telemetry`` (a ring capacity) attaches per-instance
    ``obs.TelemetrySnapshot``s (rows of one plane per bucket; under a
    policy the endgame's, with the tier's under ``fp32`` and
    ``tier_switch_round`` the tier's rounds, ``-1`` where its verdict was
    distrusted), as the reference's (src/repro/kernels/ops.py:1948-1961).
    ``donate`` changes nothing (the planes are private copies)."""
    if driver not in KERNEL_DRIVERS:
        raise ValueError(f"unknown driver: {driver!r}")
    problems = list(problems)
    pair = two_tier_bounds_dtypes(policy, dtype) if policy is not None else None
    if pair is not None:
        dt32, final = pair
        kw = dict(tile_rows=tile_rows, tile_width=tile_width, use_kernels=use_kernels,
                  driver=driver, slab=slab, patience=policy.patience, telemetry=telemetry,
                  device=device, on_sync=on_sync)
        cap32 = max(1, int(cfg.max_rounds * policy.fp32_round_frac))
        r32 = propagate_batch_block_ell(problems, dataclasses.replace(cfg, max_rounds=cap32),
                                        dtype=dt32, bounds=bounds,
                                        stop_progress=policy.switch_progress, **kw)
        # The tier's verdicts and round counts, in one read.
        read = torch.stack([torch.stack([t.infeasible.to(torch.int32), t.rounds.to(torch.int32)])
                            for t in r32]).tolist() if r32 else []
        bad = [bool(v) for v, _ in read]
        if on_sync is not None:
            on_sync()
        orig = list(bounds) if bounds is not None else [None] * len(problems)
        warm = [o if b else bnd.canonical_infinite(t.lb.to(final), t.ub.to(final))
                for t, b, o in zip(r32, bad, orig)]
        rem = dataclasses.replace(cfg, max_rounds=max(1, cfg.max_rounds - cap32))
        res = propagate_batch_block_ell(problems, rem, dtype=final, bounds=warm,
                                        stop_progress=policy.stop_progress, **kw)

        def tiered(r, t, b, n32):
            if r.telemetry is None:
                return None
            return dataclasses.replace(r.telemetry, tier_switch_round=-1 if b else n32,
                                       fp32=t.telemetry)

        return [r._replace(rounds=r.rounds + (0 if b else t.rounds), tier_rounds=t.rounds,
                           telemetry=tiered(r, t, b, n32))
                for r, t, b, (_, n32) in zip(res, r32, bad, read)]
    if policy is not None:
        stop_progress, patience = policy.stop_progress, policy.patience
    if bounds is not None:
        bounds = list(bounds)
        if len(bounds) != len(problems):
            raise ValueError(f"bounds has {len(bounds)} entries for {len(problems)} problems")
    out = [None] * len(problems)
    for batch in packed_problems(problems, tile_rows=tile_rows, tile_width=tile_width):
        prep = prepare_problem_batch(batch, dtype, device)
        lb0 = ub0 = None
        if bounds is not None:
            lb0, ub0 = _bound_planes_for_batch(prep, bounds)
        results = propagate_batch_prepared(prep, cfg, use_kernels, driver, lb0, ub0, slab,
                                           stop_progress, patience, telemetry, on_sync=on_sync)
        for idx, res in zip(batch.indices, results):
            out[idx] = res
    return out


# ---------------------------------------------------------------------------
# Node-batch engine: one shared matrix, many bound planes (tree search)
# ---------------------------------------------------------------------------


def _node_segment_round(prep: PreparedBlockEll, lb, ub, active, *, eps: float,
                        int_eps: float, inf: float, outward: float = 0.0):
    """The plain segment round over a node batch, every node at once: the
    reference's plain node round past ``SCATTER_MAX_NPAD`` under
    ``REPRO_AUTO_LARGE_SCATTER=segment`` (its vmapped segment round).  Per
    node exactly :func:`_segment_round` on the plain versions: bounds
    gathered at every slot, kernel C's or A's, the combine's and B's plain
    versions over a leading node axis, the column max/min over the nonzero
    slots into each node's row, then the batched merge, which leaves
    inactive nodes as they are."""
    d = prep.d
    bsz, width = lb.shape
    c = d.col.long()
    lb_g, ub_g = lb[:, c], ub[:, c]
    if prep.fits_one_chunk:
        lcand, ucand = kref.fused_round_tiles_ref(d.val, lb_g, ub_g, prep.ii_g, prep.lhs_g,
                                                  prep.rhs_g, int_eps, inf)
    else:
        partials = kref.activities_tiles_ref(d.val, lb_g, ub_g, inf)
        aggs = kref.combine_chunk_partials_ref(*partials, d.chunk_row, prep.row_start)
        lcand, ucand = kref.candidates_tiles_ref(d.val, lb_g, ub_g, prep.ii_g, *aggs,
                                                 prep.lhs_g, prep.rhs_g, int_eps, inf)
    pos, cols = prep.segment_index()
    plane = torch.arange(bsz, device=cols.device)[:, None] * width
    flat = (cols[None, :] + plane).reshape(-1)
    best_l = torch.full((bsz * width,), -inf, dtype=lb.dtype, device=lb.device)
    best_u = torch.full((bsz * width,), inf, dtype=ub.dtype, device=ub.device)
    best_l.scatter_reduce_(0, flat, lcand.reshape(bsz, -1)[:, pos].reshape(-1), "amax")
    best_u.scatter_reduce_(0, flat, ucand.reshape(bsz, -1)[:, pos].reshape(-1), "amin")
    return bnd.apply_updates_batch(lb, ub, best_l.view(bsz, width), best_u.view(bsz, width),
                                   eps, inf, outward, active=active)


def _node_round(
    prep: PreparedBlockEll, lb, ub, active, *, ops: RoundOps, eps: float,
    int_eps: float, inf: float, kept: KeptPlanes, outward: float = 0.0,
    part: SlabPartition | None = None, progress=None,
):
    """One round over a node batch: ``(B, n_pad)`` per-node bounds + ``(B,)``
    active mask -> updated bounds + per-node changed flags, the matrix tiles
    shared by every node; inactive nodes pass through, and no node is
    picked on the host.

    With a slab partition ``part`` (instances past ``SCATTER_MAX_NPAD``)
    the partitioned node round runs: #13, the straddle combine, #14 and
    #15's merge, which skip inactive nodes on the device (the plain path: the
    partitioned oracle per active node).  Else rows that fit one chunk run
    kernel #10, and rows that span chunks A', the combine and E over the
    node batch (where the reference vmaps its single-instance round); then
    the batched merge #9.  Each launch covers every node, so a round makes
    the same launches whatever the batch size.  #10 and #14 scatter into the
    closure's kept planes ``kept``, which #9 / #15 set back to the
    sentinels.  With ``progress`` (a ``(B,)`` tensor) #9 (or #15) also
    writes each active node's early-stop measure of the round into it."""
    if part is not None:
        return ops.partitioned(
            part, lb, ub, active, node=True, eps=eps, int_eps=int_eps, inf=inf,
            kept=kept, outward=outward, progress=progress,
        )
    d = prep.d
    if prep.fits_one_chunk:
        best_l, best_u = ops.node_fused(
            d.val, d.col, prep.ii_g, prep.lhs_g, prep.rhs_g, lb, ub, active,
            prep.n_pad, int_eps, inf, kept=kept, chunk_len=prep.chunk_len,
            max_chunk_len=prep.max_chunk_len,
        )
    else:
        partials = ops.node_activities(d.val, d.col, lb, ub, active, prep.n_pad, inf,
                                       chunk_len=prep.chunk_len)
        aggs = ops.node_combine(*partials, d.chunk_row, prep.row_start, active,
                                classes=prep.seg_classes)
        best_l, best_u = ops.node_candidates(
            d.val, d.col, prep.ii_g, *aggs, prep.lhs_g, prep.rhs_g, lb, ub, active,
            prep.n_pad, int_eps, inf, chunk_len=prep.chunk_len,
        )
    return ops.merge_batch(lb, ub, best_l, best_u, active, eps, inf, outward,
                           flags=kept.flags(active.shape, torch.bool, lb),
                           **_row_stop(kept, lb, progress))


def node_round_fn_for(
    prep: PreparedBlockEll, cfg: PropagatorConfig = DEFAULT_CONFIG, use_kernels: bool = True,
    slab: int | None = None,
):
    """A ``(lb, ub, active) -> (lb, ub, changed)`` node-batch round closure
    over a prepared instance (bounds ``(B, n_pad)``; with kernels updated
    in place).  Past ``SCATTER_MAX_NPAD`` (read at call time) it runs the
    partitioned node kernels, ``slab`` overriding the window width; the
    plain path there takes the engine of ``scatter="auto"`` as the
    reference's plain node round does (the segment round under
    ``REPRO_AUTO_LARGE_SCATTER=segment``, read here).  Float64 or float32
    everywhere.  The closure is ``measured`` as
    :func:`batched_round_fn_for`'s (``progress=``), except the plain
    segment round's (the loop then measures from copies of the planes)."""
    dt = prep.d.val.dtype
    eps, outward = cfg.eps_for(dt), cfg.outward_for(dt)
    ops = KERNEL_OPS if use_kernels else PLAIN_OPS
    large = prep.n_pad > SCATTER_MAX_NPAD
    if large and not use_kernels and _auto_large_scatter() == "segment":
        def round_fn(lb, ub, active):
            return _node_segment_round(prep, lb, ub, active, eps=eps, int_eps=cfg.int_eps,
                                       inf=cfg.inf, outward=outward)

        return round_fn
    part = prep.slab_partition(slab) if large else None
    kept = KeptPlanes(cfg.inf)

    def round_fn(lb, ub, active, progress=None):
        return _node_round(
            prep, lb, ub, active, ops=ops, eps=eps, int_eps=cfg.int_eps, inf=cfg.inf,
            outward=outward, part=part, kept=kept, progress=progress,
        )

    return _measured(kept.guard(round_fn), use_kernels)


def node_batch_runner(
    prep: PreparedBlockEll,
    batch_size: int,
    cfg: PropagatorConfig = DEFAULT_CONFIG,
    use_kernels: bool = True,
    on_sync: Callable[[], None] | None = None,
    slab: int | None = None,
    stop_progress: float | None = None,
    patience: int = 1,
    donate: bool | None = None,
    telemetry: int | None = None,
):
    """The node batch's whole fixed point as one function: ``run(lb0, ub0)
    -> (lb, ub, rounds, converged, infeasible, progress)`` over ``(B,
    n_pad)`` planes, the node axis leading everywhere.  PyTorch runs
    eagerly, so nothing is compiled or cached here; the prepared tiles and
    slab partitions are (see :func:`cache_info`).  ``on_sync`` is called
    once per host read of the loop's exit flag (one per round); ``slab``
    as in :func:`node_round_fn_for`; ``stop_progress``/``patience`` arm the
    per-node early stop.  ``telemetry`` (a ring capacity) appends the
    per-node ``obs.TelemetryPlane``, recorded every round on the device.
    ``donate`` is accepted for the reference's signature and changes
    nothing (``run`` updates the planes it is given in place)."""
    del donate
    tel = int(telemetry or 0)
    round_fn = node_round_fn_for(prep, cfg, use_kernels, slab)
    col_valid = torch.arange(prep.n_pad, device=prep.lb0.device) < prep.n

    def run(lb0, ub0):
        if lb0.shape[0] != batch_size:
            raise ValueError(f"runner for {batch_size} nodes got {lb0.shape[0]}")
        plane = (obs.device_plane(tel, batch=batch_size, dtype=lb0.dtype, device=lb0.device)
                 if tel else None)
        out = batched_fixed_point(
            round_fn, lb0, ub0, cfg.max_rounds, stop_progress=stop_progress,
            patience=patience, with_progress=True, plane=plane, feas_eps=cfg.feas_eps,
            on_sync=on_sync,
        )
        lb, ub, rounds, converged, progress = out[:5]
        infeasible = ((lb > ub + cfg.feas_eps) & col_valid[None, :]).any(dim=-1)
        return (lb, ub, rounds, converged, infeasible, progress) + out[5:]

    return run


def _node_planes(prep: PreparedBlockEll, lb_nodes, ub_nodes):
    """``(B, n)`` caller planes -> private column-padded ``(B, n_pad)``
    tensors on the prepared device."""
    dev, dt = prep.lb0.device, prep.lb0.dtype
    lb_t = torch.as_tensor(lb_nodes, dtype=dt, device=dev)
    ub_t = torch.as_tensor(ub_nodes, dtype=dt, device=dev)
    if lb_t.ndim != 2 or lb_t.shape != ub_t.shape:
        raise ValueError(
            f"node bound planes must share a (B, n) shape, got "
            f"{tuple(lb_t.shape)} / {tuple(ub_t.shape)}"
        )
    bsz, n = lb_t.shape
    if n != prep.n:
        raise ValueError(f"node bounds have n={n}, instance has n={prep.n}")
    planes = []
    for t in (lb_t, ub_t):
        out = torch.zeros((bsz, prep.n_pad), dtype=dt, device=dev)
        out[:, :n] = t
        planes.append(out)
    return planes


def propagate_nodes_prepared(
    prep: PreparedBlockEll,
    lb_nodes,
    ub_nodes,
    cfg: PropagatorConfig = DEFAULT_CONFIG,
    use_kernels: bool = True,
    with_progress: bool = False,
    on_sync: Callable[[], None] | None = None,
    slab: int | None = None,
    stop_progress: float | None = None,
    patience: int = 1,
    donate: bool | None = None,
    telemetry: int | None = None,
):
    """Run B warm-started nodes of one prepared instance to their fixed
    points together.

    ``lb_nodes``/``ub_nodes`` are ``(B, n)`` per-node bound planes (numpy or
    tensors; the matrix tiles stay resident once).  Returns ``(lb, ub,
    rounds, converged, infeasible)`` with the node axis leading
    (``with_progress=True`` appends the ``(B,)`` last-round progress
    measure); ``infeasible`` marks nodes whose domain emptied.  Each node's
    result is exactly what its own single-instance warm-started
    ``propagate_block_ell`` run gives, round counts included.  Past
    ``SCATTER_MAX_NPAD`` the nodes run the partitioned node kernels
    (``slab`` overrides the window width).  ``stop_progress``/``patience``
    arm the per-node early stop.  The planes take the prep's dtype.
    ``telemetry`` (a ring capacity) appends the per-node batched
    ``obs.TelemetryPlane`` to either return (wrap rows in
    ``obs.TelemetrySnapshot(plane, index=i)`` to read one node's).
    ``donate`` changes nothing: the caller's planes are copied into private
    padded ones."""
    lb0, ub0 = _node_planes(prep, lb_nodes, ub_nodes)
    run = node_batch_runner(prep, lb0.shape[0], cfg, use_kernels, on_sync, slab, stop_progress,
                            patience, donate, telemetry)
    res = run(lb0, ub0)
    lb, ub, rounds, converged, infeasible, progress = res[:6]
    out = (lb[:, : prep.n], ub[:, : prep.n], rounds, converged, infeasible)
    return out + ((progress,) if with_progress else ()) + res[6:]


def cache_info() -> dict:
    """Hit/miss/size/maxsize counters of the engines' LRU caches (prepared
    instances, packed batches, prepared buckets, batch runners)."""
    return {
        "prepare_block_ell": _prep_cache.info(),
        "packed_problems": _pack_cache.info(),
        "prepare_problem_batch": _batch_prep_cache.info(),
        "batch_runner": _batch_runner_cache.info(),
    }
