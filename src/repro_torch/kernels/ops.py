"""The single-instance block-ELL propagation engine over the round kernels.

The kernel-backed sibling of ``core.propagator``; both share the bound-update
semantics so they converge to the same fixed points.

  * ``prepare_block_ell`` -- one-time, cached per matrix structure: block-ELL
    conversion, upload, and the round-constant gathers (``is_int[col]``,
    ``lhs1[chunk_row]``, ``rhs1[chunk_row]``).
  * The ``"fused"`` round: rows that fit one chunk run kernel D (gather,
    activities, candidates, column max/min) then kernel F (merge, in place);
    rows that span chunks run kernel A' (chunk partials), a segment sum of the
    (T, R) partials over rows, kernel E (candidates + column max/min), then F.
  * The fixed point runs on private copies of the cached initial bounds, so
    F's in-place merge never touches the cache.

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
    check_dtype,
    fixed_point,
    not_ported,
    resolve_device,
    DRIVERS,
)
from ..core.sparse import Problem, col_pad, csr_to_block_ell
from ..core.types import DEFAULT_CONFIG, PropagationResult, PropagatorConfig
from ..core.activities import segment_sum
from . import prop_round as kern
from . import ref as kref

# Largest padded column count the fused engine takes.  It is the JAX
# package's VMEM budget, kept until the H100's own limit is measured; beyond
# it the reference switches to the column-slab partitioned engine.
SCATTER_MAX_NPAD = 1 << 16


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
    m: int
    n: int
    n_pad: int
    fits_one_chunk: bool

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


def _combine_chunk_partials(prep: PreparedBlockEll, mf, mc, xf, xc):
    """Chunk partials -> completed per-chunk row aggregates (long rows): a
    segment sum over the m + 1 rows (padding chunks carry row m), gathered
    back per chunk.  On the GPU ``index_add_`` sums in no fixed order, so for
    rows of three or more chunks the float sums may differ in the last bits
    from run to run (exact on integer-valued data)."""
    crow = prep.d.chunk_row.reshape(-1).long()
    g = lambda x: segment_sum(x.reshape(-1), crow, prep.m + 1)[crow].reshape(x.shape)
    return g(mf), g(mc), g(xf), g(xc)


class RoundOps(NamedTuple):
    """The four functions of a round: the kernel wrappers, or their plain
    PyTorch versions."""

    fused: Callable       # D: tiles + bounds -> (best_l, best_u)
    activities: Callable  # A': tiles + bounds -> chunk partials
    candidates: Callable  # E: tiles + row aggregates + bounds -> (best_l, best_u)
    merge: Callable       # F: (lb, ub, best_l, best_u, eps, inf, outward) -> (lb, ub, changed)


KERNEL_OPS = RoundOps(
    kern.fused_scatter_round_tiles,
    kern.activities_gather_tiles,
    kern.candidates_scatter_tiles,
    kern.apply_updates_tiles,
)
PLAIN_OPS = RoundOps(
    kref.fused_scatter_round_tiles_ref,
    kref.activities_gather_tiles_ref,
    kref.candidates_scatter_tiles_ref,
    bnd.apply_updates,
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
):
    """One fused-scatter round over hoisted constants; (lb, ub) live in the
    column-padded ``(n_pad,)`` domain.  Returns ``(lb, ub, changed)``; with
    :data:`KERNEL_OPS` the bounds are updated in place."""
    d = prep.d
    if fused:
        best_l, best_u = ops.fused(
            d.val, d.col, prep.ii_g, prep.lhs_g, prep.rhs_g, lb, ub, prep.n_pad, int_eps, inf,
        )
    else:
        # Long rows: chunk partials -> segment combine of the (T, R)
        # aggregates -> candidates + column reduction.
        partials = ops.activities(d.val, d.col, lb, ub, prep.n_pad, inf)
        rmf, rmc, rxf, rxc = _combine_chunk_partials(prep, *partials)
        best_l, best_u = ops.candidates(
            d.val, d.col, prep.ii_g, rmf, rmc, rxf, rxc,
            prep.lhs_g, prep.rhs_g, lb, ub, prep.n_pad, int_eps, inf,
        )
    return ops.merge(lb, ub, best_l, best_u, eps, inf, outward)


def _resolve_scatter(scatter: str, prep: PreparedBlockEll) -> str:
    """``auto`` and ``fused`` resolve to the fused round while the padded
    column count is within :data:`SCATTER_MAX_NPAD`; the other engines of
    the reference are later slices of the port."""
    if scatter in ("segment", "partitioned"):
        entry = {"segment": "item 4 (segment dataflow)",
                 "partitioned": "item 9 (partitioned engine)"}[scatter]
        not_ported(f"scatter={scatter!r}", entry)
    if scatter not in ("auto", "fused"):
        raise ValueError(f"unknown scatter mode: {scatter!r}")
    if prep.n_pad > SCATTER_MAX_NPAD:
        not_ported(
            f"n_pad={prep.n_pad} > {SCATTER_MAX_NPAD} (the partitioned engine)",
            "item 9 (partitioned engine)",
        )
    return "fused"


def round_fn_for(
    prep: PreparedBlockEll,
    cfg: PropagatorConfig = DEFAULT_CONFIG,
    use_kernels: bool = True,
    scatter: str = "fused",
    fused: bool | None = None,
):
    """A ``(lb, ub) -> (lb, ub, changed)`` round closure over a prepared
    instance (bounds in the ``(n_pad,)`` domain)."""
    _resolve_scatter(scatter, prep)
    do_fuse = prep.fits_one_chunk if fused is None else bool(fused)
    dt = prep.d.val.dtype
    eps, outward = cfg.eps_for(dt), cfg.outward_for(dt)
    ops = KERNEL_OPS if use_kernels else PLAIN_OPS

    def round_fn(lb, ub):
        return _prepared_round(
            prep, lb, ub, ops=ops, eps=eps, int_eps=cfg.int_eps, inf=cfg.inf,
            fused=do_fuse, outward=outward,
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
    stop_progress: float | None = None,
    policy=None,
    telemetry=None,
    device="cuda",
    on_sync: Callable[[], None] | None = None,
) -> PropagationResult:
    """Kernel-backed propagation of one instance.

    ``fused='auto'`` runs kernel D whenever every row fits one chunk and the
    A'/E pair otherwise (``'yes'``/``'no'`` force one).  ``use_kernels=False``
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
    round_fn = round_fn_for(prep, cfg, use_kernels, scatter, do_fuse)
    lb, ub = _initial_padded_bounds(prep, lb0, ub0)
    lb, ub, rounds, changed, prog = fixed_point(round_fn, lb, ub, cfg.max_rounds, on_sync)
    return _result(lb[: prep.n], ub[: prep.n], rounds, changed, prog, cfg.feas_eps)


def cache_info() -> dict:
    """Hit/miss/size/maxsize counters of the engine's LRU cache."""
    return {"prepare_block_ell": _prep_cache.info()}
