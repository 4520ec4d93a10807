"""The block-ELL propagation engines over the round kernels: one instance
(``propagate_block_ell``) and a batch of nodes sharing one matrix
(``propagate_nodes_prepared``).

The kernel-backed sibling of ``core.propagator``; both share the bound-update
semantics so they converge to the same fixed points.

  * ``prepare_block_ell`` -- one-time, cached per matrix structure: block-ELL
    conversion, upload, and the round-constant gathers (``is_int[col]``,
    ``lhs1[chunk_row]``, ``rhs1[chunk_row]``).
  * The ``"fused"`` round: rows that fit one chunk run kernel D (gather,
    activities, candidates, column max/min) then kernel F (merge, in place);
    rows that span chunks run kernel A' (chunk partials), the combine kernel
    (each row's partials summed left to right), kernel E (candidates +
    column max/min), then F.
  * The ``"partitioned"`` round (``slab.SlabPartition``, built once per slab
    width on the host): the straddle rows' copy partials (#11), their
    completed aggregates by the combine kernel in one fixed order, then
    the slab round (#12: scatter into accumulator planes, then #15's window
    merge, in place).
  * ``scatter="auto"`` picks the engine as the reference does: ``fused``
    while ``n_pad <= SCATTER_MAX_NPAD``, ``partitioned`` beyond.  The limit
    picks the engine and no longer bounds what the port can run: an
    explicit ``scatter="fused"`` runs at any ``n_pad``.
  * The node round: kernel #10 then the batched merge #9 where rows fit one
    chunk, else the single-instance round per node, masked; past
    ``SCATTER_MAX_NPAD`` the partitioned node kernels (#13, the combine,
    #14 with #15) over the ``(B, n_pad)`` planes, whatever the tile width.
  * The fixed point runs on private copies of the cached initial bounds, so
    the in-place merges never touch the cache.

Per-round device-memory traffic of the fused round: ``val`` (8 B per padded
slot, its zeros mark the padding), ``col`` and ``is_int`` (8 B per nonzero),
plus O(m + n_pad) for the bound and accumulator vectors and the row data.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..core import bounds as bnd
from ..core.propagator import (
    _result,
    batched_fixed_point,
    check_dtype,
    fixed_point,
    not_ported,
    resolve_device,
    DRIVERS,
)
from ..core.sparse import Problem, col_pad, csr_to_block_ell
from ..core.types import DEFAULT_CONFIG, PropagationResult, PropagatorConfig
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


class DeviceBlockEll(NamedTuple):
    """One instance's block-ELL tiles and vectors as tensors on one device."""

    val: torch.Tensor        # (T, R, K) float64; 0 == padding
    col: torch.Tensor        # (T, R, K) int32; 0 at padding
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


class LRU:
    """Bounded LRU keyed by tuples that embed ``id()`` of host objects.

    Every entry pins its ``anchors`` (the objects whose ids appear in the
    key) so an id cannot be recycled while the entry is live, and a hit is
    honoured only if every anchor is still the identical object.  Counts
    hits and misses for :func:`cache_info`.  Thread-safe."""

    def __init__(self, maxsize: int):
        self.maxsize = maxsize
        self._d: "OrderedDict[tuple, tuple[tuple, object]]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self._lock = threading.RLock()

    def get(self, key, anchors: tuple):
        with self._lock:
            hit = self._d.get(key)
            if hit is not None and all(a is b for a, b in zip(hit[0], anchors)):
                self._d.move_to_end(key)
                self.hits += 1
                return hit[1]
            self.misses += 1
            return None

    def put(self, key, anchors: tuple, value) -> None:
        with self._lock:
            self._d[key] = (anchors, value)
            while len(self._d) > self.maxsize:
                self._d.popitem(last=False)

    def clear(self) -> None:
        with self._lock:
            self._d.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)

    def info(self) -> dict:
        with self._lock:
            return {
                "hits": self.hits,
                "misses": self.misses,
                "size": len(self._d),
                "maxsize": self.maxsize,
            }


@dataclasses.dataclass(frozen=True)
class PreparedBlockEll:
    """Device tiles + everything about a round that does not change across
    rounds: the hoisted gathers, the column-padded initial bounds, and static
    layout facts.  Rounds read only matrix structure from it; ``lb0``/``ub0``
    are per-problem defaults that every driver accepts as runtime overrides,
    so one prepared engine serves any bounds."""

    d: DeviceBlockEll
    ii_g: torch.Tensor   # (T, R, K) int32: is_int[col], hoisted
    lhs_g: torch.Tensor  # (T, R): lhs1[chunk_row], hoisted
    rhs_g: torch.Tensor  # (T, R): rhs1[chunk_row], hoisted
    lb0: torch.Tensor    # (n_pad,) default initial bounds (column-padded)
    ub0: torch.Tensor    # (n_pad,)
    row_start: torch.Tensor  # (m+2,) int64: first chunk of each row, padding row m too
    m: int
    n: int
    n_pad: int
    fits_one_chunk: bool
    # Slab partitions, built lazily and keyed by slab width, and the
    # straddle combine's segments keyed by (slab width, planes); shared by
    # bounds-swapped views of this prep.
    _slabs: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

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

    def straddle_segments(self, part: SlabPartition, planes: int):
        """The straddle combine's segments over ``planes`` bound planes of
        ``part`` (``ref.straddle_segments``), cached."""
        key = (part.slab, int(planes))
        segs = self._slabs.get(key)
        if segs is None:
            segs = self._slabs[key] = kref.straddle_segments(part, planes)
        return segs

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
    returns a bounds-swapped view sharing every device tile."""
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
    col = d.col.long()
    crow = d.chunk_row.long()
    prep = PreparedBlockEll(
        d=d,
        ii_g=d.is_int[col].to(torch.int32),
        lhs_g=d.lhs1[crow],
        rhs_g=d.rhs1[crow],
        lb0=torch.zeros(n_pad, dtype=dt, device=dev),
        ub0=torch.zeros(n_pad, dtype=dt, device=dev),
        row_start=torch.searchsorted(
            d.chunk_row.reshape(-1),
            torch.arange(p.m + 2, dtype=d.chunk_row.dtype, device=dev),
        ),
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


class RoundOps(NamedTuple):
    """The functions of a round: the kernel wrappers, or their plain
    PyTorch versions."""

    fused: Callable       # D: tiles + bounds -> (best_l, best_u)
    activities: Callable  # A': tiles + bounds -> chunk partials
    combine: Callable     # chunk partials -> completed row aggregates
    candidates: Callable  # E: tiles + row aggregates + bounds -> (best_l, best_u)
    merge: Callable       # F: (lb, ub, best_l, best_u, eps, inf, outward) -> (lb, ub, changed)
    node_fused: Callable  # #10: tiles + (B, n_pad) planes + active -> (best_l, best_u)
    merge_batch: Callable  # #9: (lb, ub, best_l, best_u, active, eps, inf, outward)
    partitioned: Callable  # (part, lb, ub, active, ...) -> (lb, ub, (B,) changed)


def _plain_node_fused(val, col, is_int_g, lhs_g, rhs_g, lb, ub, active, n_pad, int_eps, inf):
    return kref.node_fused_scatter_round_ref(
        val, col, is_int_g, lhs_g, rhs_g, lb, ub, n_pad, int_eps, inf, active=active
    )


def _plain_merge_batch(lb, ub, best_l, best_u, active, eps, inf, outward=0.0):
    return bnd.apply_updates_batch(lb, ub, best_l, best_u, eps, inf, outward, active=active)


def _partitioned_kernel_round(
    part: SlabPartition, lb, ub, active, *, node: bool, eps: float, int_eps: float,
    inf: float, outward: float = 0.0, segments=None,
):
    """One partitioned round on the kernels over ``(B, W)`` planes (``W`` the
    instance's ``n_pad``: no real nonzero reaches past it), IN PLACE:
    straddle-row partials (#11, or #13 per node), their completed
    aggregates (the combine kernel, each slot's partials left to right in
    sub-stream order), then the slab round (#12, or #14 per node: scatter,
    then #15's window merge).  ``node=False`` routes copies to their own
    instance's plane by the run maps (a single instance passes ``B == 1``);
    ``node=True`` runs ONE instance's copies against every node's plane.
    ``segments`` are the combine's cached segments
    (:meth:`PreparedBlockEll.straddle_segments`).  Returns ``(lb, ub,
    changed)`` with ``(B,)`` bool flags: the window flags OR-ed per plane."""
    bsz = lb.shape[0]
    if part.has_straddle:
        if node:
            partials = kern.node_slab_partials_tiles(
                part.a_val, part.a_col_s, part.a_run_start, part.a_run_len, part.a_run_slab,
                active, lb, ub, part.slab, part.a_max_run_len, inf,
            )
        else:
            partials = kern.batched_slab_partials_tiles(
                part.a_val, part.a_col_s, part.a_run_start, part.a_run_len, part.a_run_inst,
                part.a_run_slab, active, lb, ub, part.slab, part.a_max_run_len, inf,
            )
        strs = kref.straddle_tables(part, *partials, segments=segments,
                                    combine=kern.combine_chunk_partials_tiles)
    else:
        shape = ((bsz,) if node else ()) + tuple(part.chunk_row.shape)
        z = torch.zeros(shape, dtype=lb.dtype, device=lb.device)
        zi = torch.zeros(shape, dtype=torch.int32, device=lb.device)
        strs = (z, zi, z, zi)
    common = (part.val, part.col_s, part.ii_g, part.row_done, *strs, part.lhs_g, part.rhs_g,
              part.run_start, part.run_len)
    if node:
        lb, ub, ch = kern.node_slab_round_tiles(
            *common, part.run_slab, active, lb, ub, part.slab, part.max_run_len, eps, int_eps,
            inf, outward,
        )
    else:
        lb, ub, ch = kern.batched_slab_round_tiles(
            *common, part.run_inst, part.run_slab, active, lb, ub, part.slab,
            part.max_run_len, eps, int_eps, inf, outward,
        )
    # Runs lie in window order: (plane, slab).
    return lb, ub, (ch.reshape(bsz, -1) != 0).any(dim=1)


def _partitioned_plain_round(
    part: SlabPartition, lb, ub, active, *, node: bool, eps: float, int_eps: float,
    inf: float, outward: float = 0.0, segments=None,
):
    """The plain partitioned round, as the reference's ``use_pallas=False``:
    ``ref.partitioned_round_ref`` (per active node under ``node=True``) and
    the shared merge; returns new ``(B, W)`` planes and ``(B,)`` flags."""
    del segments
    if node:
        best_l, best_u = kref.node_partitioned_round_ref(part, lb, ub, int_eps, inf,
                                                         active=active)
    else:
        best_l, best_u = kref.partitioned_round_ref(part, lb, ub, int_eps, inf)
    width = lb.shape[1]
    return bnd.apply_updates_batch(lb, ub, best_l[:, :width], best_u[:, :width], eps, inf,
                                   outward, active=active)


KERNEL_OPS = RoundOps(
    kern.fused_scatter_round_tiles,
    kern.activities_gather_tiles,
    kern.combine_chunk_partials_tiles,
    kern.candidates_scatter_tiles,
    kern.apply_updates_tiles,
    kern.node_fused_scatter_round_tiles,
    kern.apply_updates_batch_tiles,
    _partitioned_kernel_round,
)
PLAIN_OPS = RoundOps(
    kref.fused_scatter_round_tiles_ref,
    kref.activities_gather_tiles_ref,
    kref.combine_chunk_partials_ref,
    kref.candidates_scatter_tiles_ref,
    bnd.apply_updates,
    _plain_node_fused,
    _plain_merge_batch,
    _partitioned_plain_round,
)


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
    part: SlabPartition | None = None,
):
    """One round over hoisted constants; (lb, ub) live in the column-padded
    ``(n_pad,)`` domain.  Returns ``(lb, ub, changed)``; with
    :data:`KERNEL_OPS` the bounds are updated in place.  With a slab
    partition ``part`` the partitioned round runs (it ignores ``fused``:
    split rows are straddle rows there)."""
    d = prep.d
    if part is not None:
        one = torch.ones((1,), dtype=torch.bool, device=lb.device)
        new_lb, new_ub, ch = ops.partitioned(
            part, lb[None], ub[None], one, node=False, eps=eps, int_eps=int_eps, inf=inf,
            outward=outward, segments=prep.straddle_segments(part, 1),
        )
        return new_lb[0], new_ub[0], ch[0]
    if fused:
        best_l, best_u = ops.fused(
            d.val, d.col, prep.ii_g, prep.lhs_g, prep.rhs_g, lb, ub, prep.n_pad, int_eps, inf,
        )
    else:
        # Long rows: chunk partials -> each row's partials summed left to
        # right (one fixed order on every device, so a node's round equals
        # its single-instance round bitwise) -> candidates + column reduction.
        partials = ops.activities(d.val, d.col, lb, ub, prep.n_pad, inf)
        rmf, rmc, rxf, rxc = ops.combine(*partials, d.chunk_row, prep.row_start)
        best_l, best_u = ops.candidates(
            d.val, d.col, prep.ii_g, rmf, rmc, rxf, rxc,
            prep.lhs_g, prep.rhs_g, lb, ub, prep.n_pad, int_eps, inf,
        )
    return ops.merge(lb, ub, best_l, best_u, eps, inf, outward)


def _resolve_scatter(scatter: str, prep: PreparedBlockEll) -> str:
    """The engine decision, as the reference's: ``auto`` keeps the fused
    round while ``n_pad <= SCATTER_MAX_NPAD`` (read at call time) and takes
    the column-slab ``partitioned`` round beyond it; ``fused`` and
    ``partitioned`` run at any ``n_pad``.  ``segment`` is a later slice of
    the port."""
    if scatter == "auto":
        return "fused" if prep.n_pad <= SCATTER_MAX_NPAD else "partitioned"
    if scatter == "segment":
        not_ported("scatter='segment'", "item 4 (segment dataflow)")
    if scatter not in ("fused", "partitioned"):
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
    :func:`default_slab_width`; ignored by the fused engine)."""
    scatter = _resolve_scatter(scatter, prep)
    do_fuse = prep.fits_one_chunk if fused is None else bool(fused)
    dt = prep.d.val.dtype
    eps, outward = cfg.eps_for(dt), cfg.outward_for(dt)
    ops = KERNEL_OPS if use_kernels else PLAIN_OPS
    part = prep.slab_partition(slab) if scatter == "partitioned" else None

    def round_fn(lb, ub):
        return _prepared_round(
            prep, lb, ub, ops=ops, eps=eps, int_eps=cfg.int_eps, inf=cfg.inf,
            fused=do_fuse, outward=outward, part=part,
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
    policy=None,
    telemetry=None,
    device="cuda",
    on_sync: Callable[[], None] | None = None,
) -> PropagationResult:
    """Kernel-backed propagation of one instance.

    ``fused='auto'`` runs kernel D whenever every row fits one chunk and the
    A'/E pair otherwise (``'yes'``/``'no'`` force one).  ``scatter='auto'``
    takes that fused engine while ``n_pad <= SCATTER_MAX_NPAD`` and the
    column-slab ``'partitioned'`` engine beyond it (``slab`` overrides its
    window width); either may be asked for at any size.  ``use_kernels=False``
    runs the kernels' plain PyTorch versions instead (the counterpart of the
    reference's ``use_pallas=False``); on a CPU device the wrappers run the
    plain versions either way.  ``lb0``/``ub0`` warm-start the fixed point
    from ``(n,)`` caller bounds on the cached prepared tiles.

    ``device`` defaults to CUDA and raises where there is none; pass
    ``device="cpu"`` to run on the CPU.  ``driver`` takes the reference's
    names, but in this slice ``"host_loop"`` is an alias of
    ``"device_loop"``: both read the round's ``changed`` flag on the host
    once per round, and ``on_sync`` is called for each such read.  Float64 only: ``dtype``, ``policy``, ``stop_progress``
    and ``telemetry`` outside this slice raise ``NotImplementedError``."""
    if driver not in DRIVERS:
        raise ValueError(f"unknown driver: {driver!r}")
    if policy is not None or stop_progress is not None:
        not_ported("policy= / stop_progress=", "item 5 (precision tiers)")
    if telemetry is not None:
        not_ported("telemetry=", "item 6 (observability)")
    prep = prepare_block_ell(p, tile_rows, tile_width, dtype, device)
    do_fuse = prep.fits_one_chunk if fused == "auto" else bool(fused == "yes" or fused is True)
    round_fn = round_fn_for(prep, cfg, use_kernels, scatter, do_fuse, slab)
    lb, ub = _initial_padded_bounds(prep, lb0, ub0)
    lb, ub, rounds, changed, prog = fixed_point(round_fn, lb, ub, cfg.max_rounds, on_sync)
    return _result(lb[: prep.n], ub[: prep.n], rounds, changed, prog, cfg.feas_eps)


# ---------------------------------------------------------------------------
# Node-batch engine: one shared matrix, many bound planes (tree search)
# ---------------------------------------------------------------------------


def _node_round(
    prep: PreparedBlockEll, lb, ub, active, *, ops: RoundOps, eps: float,
    int_eps: float, inf: float, outward: float = 0.0, part: SlabPartition | None = None,
):
    """One round over a node batch: ``(B, n_pad)`` per-node bounds + ``(B,)``
    active mask -> updated bounds + per-node changed flags, the matrix tiles
    shared by every node.

    With a slab partition ``part`` (instances past ``SCATTER_MAX_NPAD``)
    the partitioned node round runs: #13, the combine, #14 and #15's merge,
    which skip inactive nodes on the device (the plain path: the
    partitioned oracle per active node).  Else rows that fit one chunk run
    kernel #10 then the batched merge #9, likewise.  Otherwise each node
    runs the single-instance round (A', combine, E, F) on copies of its
    rows, and the results of inactive nodes are masked out afterwards, as
    the reference's vmapped round does -- no node is picked on the host."""
    if part is not None:
        return ops.partitioned(
            part, lb, ub, active, node=True, eps=eps, int_eps=int_eps, inf=inf,
            outward=outward, segments=prep.straddle_segments(part, lb.shape[0]),
        )
    if prep.fits_one_chunk:
        d = prep.d
        best_l, best_u = ops.node_fused(
            d.val, d.col, prep.ii_g, prep.lhs_g, prep.rhs_g, lb, ub, active,
            prep.n_pad, int_eps, inf,
        )
        return ops.merge_batch(lb, ub, best_l, best_u, active, eps, inf, outward)
    rows = [
        _prepared_round(
            prep, lb[b].clone(), ub[b].clone(), ops=ops, eps=eps, int_eps=int_eps,
            inf=inf, fused=False, outward=outward,
        )
        for b in range(lb.shape[0])
    ]
    new_lb = torch.stack([r[0] for r in rows])
    new_ub = torch.stack([r[1] for r in rows])
    changed = torch.stack([r[2] for r in rows])
    keep = active[:, None]
    return torch.where(keep, new_lb, lb), torch.where(keep, new_ub, ub), changed & active


def node_round_fn_for(
    prep: PreparedBlockEll, cfg: PropagatorConfig = DEFAULT_CONFIG, use_kernels: bool = True,
    slab: int | None = None,
):
    """A ``(lb, ub, active) -> (lb, ub, changed)`` node-batch round closure
    over a prepared instance (bounds ``(B, n_pad)``).  Past
    ``SCATTER_MAX_NPAD`` (read at call time) it runs the partitioned node
    kernels, ``slab`` overriding the window width.  With kernels the planes
    are updated in place where rows fit one chunk or the instance is
    partitioned."""
    dt = prep.d.val.dtype
    eps, outward = cfg.eps_for(dt), cfg.outward_for(dt)
    ops = KERNEL_OPS if use_kernels else PLAIN_OPS
    part = prep.slab_partition(slab) if prep.n_pad > SCATTER_MAX_NPAD else None

    def round_fn(lb, ub, active):
        return _node_round(
            prep, lb, ub, active, ops=ops, eps=eps, int_eps=cfg.int_eps, inf=cfg.inf,
            outward=outward, part=part,
        )

    return round_fn


def node_batch_runner(
    prep: PreparedBlockEll,
    batch_size: int,
    cfg: PropagatorConfig = DEFAULT_CONFIG,
    use_kernels: bool = True,
    on_sync: Callable[[], None] | None = None,
    slab: int | None = None,
):
    """The node batch's whole fixed point as one function: ``run(lb0, ub0)
    -> (lb, ub, rounds, converged, infeasible, progress)`` over ``(B,
    n_pad)`` planes, the node axis leading everywhere.  PyTorch runs
    eagerly, so nothing is compiled or cached here; the prepared tiles and
    slab partitions are (see :func:`cache_info`).  ``on_sync`` is called
    once per host read of the loop's exit flag (one per round); ``slab``
    as in :func:`node_round_fn_for`."""
    round_fn = node_round_fn_for(prep, cfg, use_kernels, slab)
    col_valid = torch.arange(prep.n_pad, device=prep.lb0.device) < prep.n

    def run(lb0, ub0):
        if lb0.shape[0] != batch_size:
            raise ValueError(f"runner for {batch_size} nodes got {lb0.shape[0]}")
        lb, ub, rounds, converged, progress = batched_fixed_point(
            round_fn, lb0, ub0, cfg.max_rounds, with_progress=True, on_sync=on_sync
        )
        infeasible = ((lb > ub + cfg.feas_eps) & col_valid[None, :]).any(dim=-1)
        return lb, ub, rounds, converged, infeasible, progress

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
    (``slab`` overrides the window width)."""
    lb0, ub0 = _node_planes(prep, lb_nodes, ub_nodes)
    run = node_batch_runner(prep, lb0.shape[0], cfg, use_kernels, on_sync, slab)
    lb, ub, rounds, converged, infeasible, progress = run(lb0, ub0)
    out = (lb[:, : prep.n], ub[:, : prep.n], rounds, converged, infeasible)
    return out + (progress,) if with_progress else out


def cache_info() -> dict:
    """Hit/miss/size/maxsize counters of the engine's LRU cache."""
    return {"prepare_block_ell": _prep_cache.info()}
