"""The kernels of the fused propagation round, of its node-batch and packed-
batch forms, of the column-slab partitioned round and of the solver's node
objective, behind PyTorch wrappers.

Each wrapper of a TPU kernel keeps the signature of its Pallas twin in the
JAX package (``src/repro/kernels/prop_round.py``) minus ``interpret`` and
``block``; the long-row combine replaces an XLA segment sum.  On
a CPU tensor it runs the kernel's plain-PyTorch version (``ref.py``); on a
CUDA tensor it launches the hand-written Hopper kernel of
``csrc/prop_round.cu`` or ``csrc/slab_round.cu`` on the current stream, or
raises -- it never falls back.  Each wrapper counts its kernel launches in
a plain integer attribute, ``<wrapper>.launches`` (see
:func:`launch_counts`).

Layout of the tile arguments: ``val`` (T, R, K) float64 with 0 at padding,
``col`` (T, R, K) int32 with every id in ``[0, n_pad)``, ``is_int_g``
(T, R, K) int32 integrality of each slot's column, per-chunk sides and row
aggregates (T, R), bound vectors (n_pad,) float64; node batches carry
(B, n_pad) float64 planes and a (B,) bool ``active`` mask, packed batches
also a (T,) int32 ``tile_inst`` map.  The slab
kernels take a partition's copy tiles (slab-local ``col_s``), its (n_runs,)
int32 run maps and (B, W) planes (W the partition's ``n_pad_part`` or the
instance's ``n_pad``).  All contiguous, all on one device.
"""
from __future__ import annotations

import torch

from ..core import bounds as bnd
from ..core.types import INF
from . import _build
from . import ref


def _on_cuda(*tensors: torch.Tensor) -> bool:
    """True for CUDA operands, False for CPU ones; anything else raises."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"operands lie on several devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type in ("cpu", "cuda"):
        return dev.type == "cuda"
    raise ValueError(f"unsupported device {dev}")


def _expect(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_tiles(val, col, lb, ub, n_pad, is_int_g=None):
    t, r, k = val.shape
    _expect("val", val, torch.float64, (t, r, k))
    _expect("col", col, torch.int32, (t, r, k))
    if is_int_g is not None:
        _expect("is_int_g", is_int_g, torch.int32, (t, r, k))
    _expect("lb", lb, torch.float64, (n_pad,))
    _expect("ub", ub, torch.float64, (n_pad,))
    return t * r, k


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _p(t: torch.Tensor) -> int:
    return t.data_ptr()


# ---------------------------------------------------------------------------
# Kernel D: the whole round for rows that fit one chunk
# ---------------------------------------------------------------------------


def fused_scatter_round_tiles(
    val, col, is_int_g, lhs_g, rhs_g, lb, ub, n_pad: int, int_eps: float,
    inf: float = INF,
):
    """Fully fused round: (T, R, K) tiles + (n_pad,) bounds -> (n_pad,)
    ``best_l`` / ``best_u``, the column max/min of the lower/upper bound
    candidates (sentinel where a column has none).  Requires every row to
    fit its chunk.

    Replaces ``fused_scatter_round_tiles`` / ``_fused_scatter_kernel``
    (src/repro/kernels/prop_round.py:580 / :556).  Bound on the H100: the
    bytes of the tile stream, read once per round: ``val`` for every padded
    slot (8 B; its zeros mark the padding), ``col`` and ``is_int_g`` for
    each nonzero only (8 B); the bound vectors (2 x 8 B x n_pad) stay in
    L2.  Design:
    a group of lanes per chunk (K rounded up to a power of two, at most a
    warp: four chunks per warp at K = 8), lanes on consecutive slots
    (coalesced), row sums by shuffles in the group, the one-hot gather of the TPU kernel as an indexed load and
    its one-hot scatter as a float64 atomic max/min that padding and
    sentinel candidates skip.  The accumulators are filled with the sentinel
    before the launch, since blocks run in no order."""
    if not _on_cuda(val, col, is_int_g, lhs_g, rhs_g, lb, ub):
        return ref.fused_scatter_round_tiles_ref(
            val, col, is_int_g, lhs_g, rhs_g, lb, ub, n_pad, int_eps, inf
        )
    n_chunks, k = _check_tiles(val, col, lb, ub, n_pad, is_int_g)
    _expect("lhs_g", lhs_g, torch.float64, val.shape[:2])
    _expect("rhs_g", rhs_g, torch.float64, val.shape[:2])
    best_l = torch.full((n_pad,), -inf, dtype=torch.float64, device=val.device)
    best_u = torch.full((n_pad,), inf, dtype=torch.float64, device=val.device)
    err = _build.lib().fused_scatter_round(
        _p(val), _p(col), _p(is_int_g), _p(lhs_g), _p(rhs_g), _p(lb), _p(ub),
        _p(best_l), _p(best_u), n_chunks, k, int_eps, inf, _stream(),
    )
    fused_scatter_round_tiles.launches += 1
    _build.check(err, "fused_scatter_round")
    return best_l, best_u


fused_scatter_round_tiles.launches = 0


# ---------------------------------------------------------------------------
# Kernel A': activity partials of rows that span chunks
# ---------------------------------------------------------------------------


def activities_gather_tiles(val, col, lb, ub, n_pad: int, inf: float = INF):
    """Per-chunk activity partials with the bound gather inside the kernel:
    (T, R, K) tiles + (n_pad,) bounds -> ``(mf, mc, xf, xc)``, each (T, R):
    finite min/max sums (float64) and infinity counts (int32).

    Replaces ``activities_gather_tiles`` / ``_activities_gather_kernel``
    (src/repro/kernels/prop_round.py:269 / :252).  Bound on the H100: the
    bytes of the tile stream (8 B of ``val`` per padded slot, 4 B of ``col``
    per nonzero).  Design: kernel D's
    lane group per chunk, indexed bound loads, shuffle sums; the group's
    first lane writes the chunk's four partials."""
    if not _on_cuda(val, col, lb, ub):
        return ref.activities_gather_tiles_ref(val, col, lb, ub, n_pad, inf)
    n_chunks, k = _check_tiles(val, col, lb, ub, n_pad)
    shape, dev = val.shape[:2], val.device
    mf = torch.empty(shape, dtype=torch.float64, device=dev)
    xf = torch.empty(shape, dtype=torch.float64, device=dev)
    mc = torch.empty(shape, dtype=torch.int32, device=dev)
    xc = torch.empty(shape, dtype=torch.int32, device=dev)
    err = _build.lib().activities_gather(
        _p(val), _p(col), _p(lb), _p(ub), _p(mf), _p(mc), _p(xf), _p(xc),
        n_chunks, k, inf, _stream(),
    )
    activities_gather_tiles.launches += 1
    _build.check(err, "activities_gather")
    return mf, mc, xf, xc


activities_gather_tiles.launches = 0


# ---------------------------------------------------------------------------
# Kernel E: candidates from completed row aggregates, then the column scatter
# ---------------------------------------------------------------------------


def candidates_scatter_tiles(
    val, col, is_int_g,
    row_min_fin, row_min_cnt, row_max_fin, row_max_cnt,
    lhs_g, rhs_g, lb, ub, n_pad: int, int_eps: float, inf: float = INF,
):
    """Candidates + column reduction: (T, R, K) tiles + (T, R) completed row
    aggregates + (n_pad,) bounds -> (n_pad,) ``best_l`` / ``best_u``.

    Replaces ``candidates_scatter_tiles`` / ``_candidates_scatter_kernel``
    (src/repro/kernels/prop_round.py:651 / :628).  Bound on the H100: the
    bytes of the tile stream (as kernel D's) plus 40 B of row data per
    chunk.  Design: kernel D's candidate and scatter pass, with the row
    aggregates read from memory instead of summed in the warp."""
    operands = (val, col, is_int_g, row_min_fin, row_min_cnt, row_max_fin,
                row_max_cnt, lhs_g, rhs_g, lb, ub)
    if not _on_cuda(*operands):
        return ref.candidates_scatter_tiles_ref(*operands, n_pad, int_eps, inf)
    n_chunks, k = _check_tiles(val, col, lb, ub, n_pad, is_int_g)
    rows = val.shape[:2]
    _expect("row_min_fin", row_min_fin, torch.float64, rows)
    _expect("row_min_cnt", row_min_cnt, torch.int32, rows)
    _expect("row_max_fin", row_max_fin, torch.float64, rows)
    _expect("row_max_cnt", row_max_cnt, torch.int32, rows)
    _expect("lhs_g", lhs_g, torch.float64, rows)
    _expect("rhs_g", rhs_g, torch.float64, rows)
    best_l = torch.full((n_pad,), -inf, dtype=torch.float64, device=val.device)
    best_u = torch.full((n_pad,), inf, dtype=torch.float64, device=val.device)
    err = _build.lib().candidates_scatter(
        _p(val), _p(col), _p(is_int_g), _p(row_min_fin), _p(row_min_cnt),
        _p(row_max_fin), _p(row_max_cnt), _p(lhs_g), _p(rhs_g), _p(lb), _p(ub),
        _p(best_l), _p(best_u), n_chunks, k, int_eps, inf, _stream(),
    )
    candidates_scatter_tiles.launches += 1
    _build.check(err, "candidates_scatter")
    return best_l, best_u


candidates_scatter_tiles.launches = 0


# ---------------------------------------------------------------------------
# Kernel F: merge -- fold best bounds into (lb, ub) in place
# ---------------------------------------------------------------------------


def apply_updates_tiles(lb, ub, best_l, best_u, eps: float, inf: float = INF, outward: float = 0.0):
    """Bound merge with ``bounds.apply_updates`` semantics, IN PLACE:
    ``lb``/``ub`` (n_pad,) are overwritten and returned with a 0-d bool
    ``changed`` tensor on their device.

    Replaces ``apply_updates_tiles`` / ``_apply_updates_kernel``
    (src/repro/kernels/prop_round.py:721 / :710), whose bound buffers are
    donated.  Bound on the H100: 48 B per column (four vectors read, two
    written) -- under a microsecond at n_pad = 60,032, so its time is launch
    latency.  Design: one thread per column; every thread that takes a
    tightening stores ``true`` to the flag, which the wrapper zeroes
    first."""
    if not _on_cuda(lb, ub, best_l, best_u):
        new_lb, new_ub, changed = bnd.apply_updates(lb, ub, best_l, best_u, eps, inf, outward)
        lb.copy_(new_lb)
        ub.copy_(new_ub)
        return lb, ub, changed
    (n,) = lb.shape
    for name, t in (("lb", lb), ("ub", ub), ("best_l", best_l), ("best_u", best_u)):
        _expect(name, t, torch.float64, (n,))
    changed = torch.zeros((), dtype=torch.bool, device=lb.device)
    err = _build.lib().apply_updates(
        _p(lb), _p(ub), _p(best_l), _p(best_u), _p(changed), n, eps, inf, outward,
        _stream(),
    )
    apply_updates_tiles.launches += 1
    _build.check(err, "apply_updates")
    return lb, ub, changed


apply_updates_tiles.launches = 0


# ---------------------------------------------------------------------------
# The long-row combine: chunk partials -> completed row aggregates
# ---------------------------------------------------------------------------


def combine_chunk_partials_tiles(mf, mc, xf, xc, chunk_row, row_start):
    """Kernel A' partials ``(T, R)`` -> each chunk's completed row aggregates
    ``(T, R)``: every row's partials summed left to right over its adjacent
    chunks (``row_start`` ``(m + 2,)`` int64: each row's first chunk, the
    padding row ``m`` included).

    Replaces the XLA ``segment_sum`` of the reference's
    ``_combine_chunk_partials`` (src/repro/kernels/ops.py:821), not a Pallas
    kernel: an atomic segment sum has no fixed order on the card.  Bound on
    the H100: 48 B per chunk (four partials read, four aggregates written).
    Design: one thread per row walks its chunks in stream order, twice (sum,
    then write back)."""
    operands = (mf, mc, xf, xc, chunk_row, row_start)
    if not _on_cuda(*operands):
        return ref.combine_chunk_partials_ref(mf, mc, xf, xc, chunk_row, row_start)
    shape = tuple(mf.shape)
    for name, t, dt in (("mf", mf, torch.float64), ("mc", mc, torch.int32),
                        ("xf", xf, torch.float64), ("xc", xc, torch.int32),
                        ("chunk_row", chunk_row, torch.int32)):
        _expect(name, t, dt, shape)
    _expect("row_start", row_start, torch.int64, (row_start.shape[0],))
    omf, oxf = torch.empty_like(mf), torch.empty_like(xf)
    omc, oxc = torch.empty_like(mc), torch.empty_like(xc)
    err = _build.lib().combine_chunk_partials(
        _p(mf), _p(mc), _p(xf), _p(xc), _p(row_start), _p(omf), _p(omc), _p(oxf),
        _p(oxc), row_start.shape[0] - 1, _stream(),
    )
    combine_chunk_partials_tiles.launches += 1
    _build.check(err, "combine_chunk_partials")
    return omf, omc, oxf, oxc


combine_chunk_partials_tiles.launches = 0


# ---------------------------------------------------------------------------
# Kernel #10: kernel D over a node batch (one matrix, B bound planes)
# ---------------------------------------------------------------------------


def _check_planes(bsz: int, n_pad: int, **planes) -> None:
    for name, t in planes.items():
        _expect(name, t, torch.float64, (bsz, n_pad))


def node_fused_scatter_round_tiles(
    val, col, is_int_g, lhs_g, rhs_g, lb, ub, active, n_pad: int, int_eps: float,
    inf: float = INF,
):
    """Fully fused round over a node batch: ONE instance's ``(T, R, K)``
    tiles + ``(B, n_pad)`` per-node bound planes + ``(B,)`` bool ``active``
    mask -> ``(B, n_pad)`` ``best_l`` / ``best_u``.  Per node exactly
    :func:`fused_scatter_round_tiles`; inactive nodes get sentinel rows.
    Requires every row to fit its chunk.

    Replaces ``node_fused_scatter_round_tiles`` /
    ``_node_fused_scatter_kernel`` (src/repro/kernels/prop_round.py:964 /
    :923).  Bound on the H100: the tile stream once per launch (it fits the
    50 MB L2 at the solver's sizes), plus each active node's two bound rows
    read and two accumulator rows written.  Design: kernel D's lane group
    per chunk; each warp reads the mask on the device, 32 nodes per ballot,
    and visits the active nodes only, reusing its tile data from L1; the
    accumulator planes are filled with the sentinel before the launch."""
    operands = (val, col, is_int_g, lhs_g, rhs_g, lb, ub, active)
    if not _on_cuda(*operands):
        return ref.node_fused_scatter_round_ref(
            val, col, is_int_g, lhs_g, rhs_g, lb, ub, n_pad, int_eps, inf, active=active
        )
    t, r, k = val.shape
    _expect("val", val, torch.float64, (t, r, k))
    _expect("col", col, torch.int32, (t, r, k))
    _expect("is_int_g", is_int_g, torch.int32, (t, r, k))
    _expect("lhs_g", lhs_g, torch.float64, (t, r))
    _expect("rhs_g", rhs_g, torch.float64, (t, r))
    bsz = lb.shape[0]
    _check_planes(bsz, n_pad, lb=lb, ub=ub)
    _expect("active", active, torch.bool, (bsz,))
    best_l = torch.full((bsz, n_pad), -inf, dtype=torch.float64, device=val.device)
    best_u = torch.full((bsz, n_pad), inf, dtype=torch.float64, device=val.device)
    err = _build.lib().node_fused_scatter_round(
        _p(val), _p(col), _p(is_int_g), _p(lhs_g), _p(rhs_g), _p(lb), _p(ub), _p(active),
        _p(best_l), _p(best_u), t * r, k, bsz, n_pad, int_eps, inf, _stream(),
    )
    node_fused_scatter_round_tiles.launches += 1
    _build.check(err, "node_fused_scatter_round")
    return best_l, best_u


node_fused_scatter_round_tiles.launches = 0


# ---------------------------------------------------------------------------
# Kernel #8: kernel D over a packed batch (many matrices, one flat stream)
# ---------------------------------------------------------------------------


def batched_fused_scatter_round_tiles(
    val, col, is_int_g, lhs_g, rhs_g, lb, ub, tile_inst, active, n_pad: int,
    int_eps: float, inf: float = INF,
):
    """Fully fused round over a packed batch: ``(T, R, K)`` flat tile stream
    (instance-local columns) + ``(B, n_pad)`` bound planes + ``(T,)`` int32
    ``tile_inst`` + ``(B,)`` bool ``active`` -> ``(B, n_pad)`` ``best_l`` /
    ``best_u``.  Per instance exactly :func:`fused_scatter_round_tiles`
    (every row of every instance must fit its chunk); inactive instances
    get sentinel rows.  ``active`` is also the service's slot-occupancy
    mask (:func:`batched_occupancy_round_tiles`).

    Replaces ``batched_fused_scatter_round_tiles`` /
    ``_batched_fused_scatter_kernel`` (src/repro/kernels/prop_round.py:816
    / :766), whose grid walks the stream in order and flushes its resident
    accumulator block at each instance boundary.  Bound on the H100: for the
    tiles of active instances, ``val`` per padded slot (8 B), ``col`` and
    ``is_int_g`` per nonzero (8 B) and the sides per chunk (16 B); per
    active instance its two bound rows read and two accumulator rows
    written.  Design: kernel D's lane group per chunk; a group reads its
    tile's instance and that instance's flag on the device and, if
    inactive, loads nothing; the bound gather and the float64 CAS max/min
    are offset by ``inst * n_pad``.  Blocks run in no order, so the wrapper
    fills both accumulator planes with the sentinel before the launch (all
    ``B`` rows) and no instance's tiles need to be contiguous."""
    operands = (val, col, is_int_g, lhs_g, rhs_g, lb, ub, tile_inst, active)
    if not _on_cuda(*operands):
        return ref.batched_fused_scatter_round_ref(
            val, ref.global_columns(col, tile_inst, n_pad), is_int_g, lhs_g, rhs_g, lb, ub,
            n_pad, int_eps, inf, active=active,
        )
    t, r, k = val.shape
    _expect("val", val, torch.float64, (t, r, k))
    _expect("col", col, torch.int32, (t, r, k))
    _expect("is_int_g", is_int_g, torch.int32, (t, r, k))
    _expect("lhs_g", lhs_g, torch.float64, (t, r))
    _expect("rhs_g", rhs_g, torch.float64, (t, r))
    _expect("tile_inst", tile_inst, torch.int32, (t,))
    bsz = lb.shape[0]
    _check_planes(bsz, n_pad, lb=lb, ub=ub)
    _expect("active", active, torch.bool, (bsz,))
    best_l = torch.full((bsz, n_pad), -inf, dtype=torch.float64, device=val.device)
    best_u = torch.full((bsz, n_pad), inf, dtype=torch.float64, device=val.device)
    err = _build.lib().batched_fused_scatter_round(
        _p(val), _p(col), _p(is_int_g), _p(lhs_g), _p(rhs_g), _p(lb), _p(ub), _p(tile_inst),
        _p(active), _p(best_l), _p(best_u), t * r, r, k, n_pad, int_eps, inf, _stream(),
    )
    batched_fused_scatter_round_tiles.launches += 1
    _build.check(err, "batched_fused_scatter_round")
    return best_l, best_u


batched_fused_scatter_round_tiles.launches = 0


def batched_occupancy_round_tiles(
    val, col, is_int_g, lhs_g, rhs_g, lb, ub, tile_inst, occupied, n_pad: int,
    eps: float, int_eps: float, inf: float = INF, outward: float = 0.0,
):
    """One occupancy-masked round over a slot-resident stream, IN PLACE:
    kernel #8, then the batched merge #9 -> ``(lb, ub, changed)`` with
    ``(S,)`` per-slot flags.  A free or retired slot is an inactive
    instance: its tiles compute nothing and its rows pass through.  The
    counterpart of the reference's ``batched_occupancy_round_tiles``
    (src/repro/kernels/prop_round.py:878), which launches no kernel of its
    own."""
    best_l, best_u = batched_fused_scatter_round_tiles(
        val, col, is_int_g, lhs_g, rhs_g, lb, ub, tile_inst, occupied, n_pad, int_eps, inf
    )
    return apply_updates_batch_tiles(lb, ub, best_l, best_u, occupied, eps, inf, outward)


# ---------------------------------------------------------------------------
# Kernel #9: the batched merge, in place, with an active mask
# ---------------------------------------------------------------------------

MAX_GRID_Y = 65535


def apply_updates_batch_tiles(
    lb, ub, best_l, best_u, active, eps: float, inf: float = INF, outward: float = 0.0
):
    """Batched merge with ``bounds.apply_updates_batch`` semantics, IN
    PLACE: ``(B, n_pad)`` ``lb``/``ub`` are overwritten and returned with a
    ``(B,)`` bool ``changed``.  Inactive rows are neither read nor written
    and report unchanged.

    Replaces ``apply_updates_batch_tiles`` / ``_apply_updates_batch_kernel``
    (src/repro/kernels/prop_round.py:1666 / :1652), whose bound buffers are
    donated.  Bound on the H100: 32 B of reads per active (node, column)
    (its bounds and candidates), 8 B per entry that tightens, and the mask
    and flags.  Design: a
    (column block, node) grid whose blocks of inactive nodes return at once;
    every thread that takes a tightening stores ``true`` to its node's flag,
    which the wrapper zeroes first."""
    if not _on_cuda(lb, ub, best_l, best_u, active):
        new_lb, new_ub, changed = bnd.apply_updates_batch(
            lb, ub, best_l, best_u, eps, inf, outward, active=active
        )
        lb.copy_(new_lb)
        ub.copy_(new_ub)
        return lb, ub, changed
    bsz, n_pad = lb.shape
    if bsz > MAX_GRID_Y:
        raise ValueError(f"batch of {bsz} rows exceeds the grid's {MAX_GRID_Y}")
    _check_planes(bsz, n_pad, lb=lb, ub=ub, best_l=best_l, best_u=best_u)
    _expect("active", active, torch.bool, (bsz,))
    changed = torch.zeros((bsz,), dtype=torch.bool, device=lb.device)
    err = _build.lib().apply_updates_batch(
        _p(lb), _p(ub), _p(best_l), _p(best_u), _p(active), _p(changed), bsz, n_pad,
        eps, inf, outward, _stream(),
    )
    apply_updates_batch_tiles.launches += 1
    _build.check(err, "apply_updates_batch")
    return lb, ub, changed


apply_updates_batch_tiles.launches = 0


# ---------------------------------------------------------------------------
# Kernel #16: the solver's node objective and leaf / prune predicates
# ---------------------------------------------------------------------------


def node_objective_tiles(lb, ub, c, is_int, valid, feas_eps: float, inf: float = INF):
    """Per-node objective bound + leaf/prune predicates: ``(B, n_pad)``
    planes + ``(n_pad,)`` objective ``c`` (float64) and ``is_int`` /
    ``valid`` (bool) -> ``(obj, fixed, crossed)``, each ``(B,)``; semantics
    of ``ref.node_objective_ref``, whose sum takes the kernel's order.

    Replaces ``node_objective_tiles`` / ``_node_objective_kernel``
    (src/repro/kernels/prop_round.py:1730 / :1711).  Bound on the H100:
    16 B per (node, column) plus the three shared vectors (10 B per
    column).  Design: one 1024-thread block per node, strided column loop,
    warp-shuffle and shared-memory sum, ``__syncthreads_or`` for the
    flags."""
    if not _on_cuda(lb, ub, c, is_int, valid):
        return ref.node_objective_ref(lb, ub, c, is_int, valid, feas_eps, inf)
    bsz, n_pad = lb.shape
    _check_planes(bsz, n_pad, lb=lb, ub=ub)
    _expect("c", c, torch.float64, (n_pad,))
    _expect("is_int", is_int, torch.bool, (n_pad,))
    _expect("valid", valid, torch.bool, (n_pad,))
    obj = torch.empty((bsz,), dtype=torch.float64, device=lb.device)
    fixed = torch.empty((bsz,), dtype=torch.bool, device=lb.device)
    crossed = torch.empty((bsz,), dtype=torch.bool, device=lb.device)
    err = _build.lib().node_objective(
        _p(lb), _p(ub), _p(c), _p(is_int), _p(valid), _p(obj), _p(fixed), _p(crossed),
        bsz, n_pad, feas_eps, inf, _stream(),
    )
    node_objective_tiles.launches += 1
    _build.check(err, "node_objective")
    return obj, fixed, crossed


node_objective_tiles.launches = 0


# ---------------------------------------------------------------------------
# The column-slab partitioned round: kernels #11-#15 (csrc/slab_round.cu)
# ---------------------------------------------------------------------------


def _check_runs(n_tiles: int, **runs) -> int:
    """Run maps are (n_runs,) int32 and cover the copy tiles; returns
    n_runs."""
    n_runs = None
    for name, t in runs.items():
        n_runs = t.shape[0] if n_runs is None else n_runs
        _expect(name, t, torch.int32, (n_runs,))
    if n_runs == 0 and n_tiles:
        raise ValueError("copy tiles without runs")
    return n_runs


def _check_copies(val, col_s, lb, ub, active):
    t, r, k = val.shape
    _expect("val", val, torch.float64, (t, r, k))
    _expect("col_s", col_s, torch.int32, (t, r, k))
    bsz, width = lb.shape
    _check_planes(bsz, width, lb=lb, ub=ub)
    _expect("active", active, torch.bool, (bsz,))
    if bsz > MAX_GRID_Y:
        raise ValueError(f"{bsz} planes exceed the grid's {MAX_GRID_Y}")
    return t, r, k, bsz, width


def _n_slabs(width: int, slab: int) -> int:
    return -(-width // slab)


def batched_slab_partials_tiles(
    val, col_s, run_start, run_len, run_inst, run_slab, active, lb, ub, slab: int,
    max_run_len: int, inf: float = INF,
):
    """Per-copy activity partials of a slab-partitioned sub-stream:
    ``(Ta, R, K)`` copies with slab-local columns + the run maps (one run
    per populated ``(instance, slab)`` window, ``(n_runs,)`` int32) + ``(B,
    W)`` bound planes + ``(B,)`` bool ``active`` -> 4 x ``(Ta, R)`` partials
    (float64 sums, int32 counts); the copies of inactive instances get
    zeros.  ``W`` is ``n_pad_part`` or the instance's ``n_pad``; a copy's
    window starts at ``inst * W + slab_id * slab``.  ``max_run_len`` sizes
    the TPU's grid and is not used here.

    Replaces ``batched_slab_partials_tiles`` /
    ``_batched_slab_partials_kernel`` (src/repro/kernels/prop_round.py:1129
    / :1090).  Bound on the H100: the sub-stream's bytes (8 B of ``val`` per
    slot, 4 B of ``col_s`` per nonzero) plus 24 B of partials per chunk.
    Design: kernel A''s lane group per chunk; a copy finds its run by a
    binary search over ``run_start`` and gathers from its window by an
    indexed load; no grid step is padded."""
    operands = (val, col_s, run_start, run_len, run_inst, run_slab, active, lb, ub)
    if not _on_cuda(*operands):
        return ref.batched_slab_partials_ref(*operands, slab, max_run_len, inf)
    t, r, k, _, width = _check_copies(val, col_s, lb, ub, active)
    n_runs = _check_runs(t, run_start=run_start, run_len=run_len, run_inst=run_inst,
                         run_slab=run_slab)
    dev = val.device
    mf = torch.empty((t, r), dtype=torch.float64, device=dev)
    xf = torch.empty((t, r), dtype=torch.float64, device=dev)
    mc = torch.empty((t, r), dtype=torch.int32, device=dev)
    xc = torch.empty((t, r), dtype=torch.int32, device=dev)
    if t == 0:
        return mf, mc, xf, xc
    err = _build.lib().slab_partials(
        _p(val), _p(col_s), _p(run_start), _p(run_inst), _p(run_slab), _p(active), _p(lb),
        _p(ub), _p(mf), _p(mc), _p(xf), _p(xc), n_runs, t * r, r, k, width, slab, inf,
        _stream(),
    )
    batched_slab_partials_tiles.launches += 1
    _build.check(err, "slab_partials")
    return mf, mc, xf, xc


batched_slab_partials_tiles.launches = 0


def _slab_merge(lb, ub, best_l, best_u, active, slab: int, eps: float, inf: float,
                outward: float):
    """Launch kernel #15 on ``(B, W)`` planes, in place; returns the ``(B,
    n_slabs)`` int32 window flags.  Counted as a launch of
    :func:`apply_updates_slab_tiles`, whichever wrapper calls it."""
    bsz, width = lb.shape
    flags = torch.zeros((bsz, _n_slabs(width, slab)), dtype=torch.int32, device=lb.device)
    err = _build.lib().slab_merge(
        _p(lb), _p(ub), _p(best_l), _p(best_u), _p(active), _p(flags), bsz, width, slab, eps,
        inf, outward, _stream(),
    )
    apply_updates_slab_tiles.launches += 1
    _build.check(err, "slab_merge")
    return flags


def _check_round(val, col_s, is_int_g, row_done, lhs_g, rhs_g, strs, str_lead, lb, ub, active):
    t, r, k, bsz, width = _check_copies(val, col_s, lb, ub, active)
    _expect("is_int_g", is_int_g, torch.int32, (t, r, k))
    _expect("row_done", row_done, torch.int32, (t, r))
    _expect("lhs_g", lhs_g, torch.float64, (t, r))
    _expect("rhs_g", rhs_g, torch.float64, (t, r))
    for name, x, dt in zip(("str_min_fin", "str_min_cnt", "str_max_fin", "str_max_cnt"), strs,
                           (torch.float64, torch.int32, torch.float64, torch.int32)):
        _expect(name, x, dt, (*str_lead, t, r))
    return t, r, k, bsz, width


def batched_slab_round_tiles(
    val, col_s, is_int_g, row_done, str_min_fin, str_min_cnt, str_max_fin, str_max_cnt,
    lhs_g, rhs_g, run_start, run_len, run_inst, run_slab, active, lb, ub, slab: int,
    max_run_len: int, eps: float, int_eps: float, inf: float = INF, outward: float = 0.0,
):
    """The slab round over a partitioned stream, IN PLACE: ``(T'', R, K)``
    copies + ``(T'', R)`` ``row_done`` and straddle aggregates ``str_*``
    (read where ``row_done == 0``) + sides + the run maps (one run per
    ``(instance, slab)`` window, in window order) + ``(B, W)`` planes +
    ``(B,)`` ``active`` -> the planes, updated, and ``(n_runs,)`` int32
    per-run changed flags (``n_runs == B * n_slabs``).  Inactive instances
    pass through.

    Replaces ``batched_slab_round_tiles`` / ``_batched_slab_round_kernel``
    (src/repro/kernels/prop_round.py:1258 / :1195), whose merge at each
    run's last grid step relies on the TPU running a run's tiles in order.
    Bound on the H100: the copy stream (8 B of ``val`` per slot, 8 B of
    ``col_s`` and ``is_int_g`` per kept nonzero, 40 B of row data per
    chunk), the window bounds read and written, and the accumulator planes
    written and read once.  Design: two launches -- kernel D's lane groups
    scatter every copy's candidates into ``(B, W)`` accumulator planes
    (float64 CAS max/min, filled with the sentinel first), then kernel
    #15's window merge runs once every copy has scattered, in place (counted
    as #15's launch)."""
    strs = (str_min_fin, str_min_cnt, str_max_fin, str_max_cnt)
    operands = (val, col_s, is_int_g, row_done, *strs, lhs_g, rhs_g, run_start, run_len,
                run_inst, run_slab, active, lb, ub)
    if not _on_cuda(*operands):
        new_lb, new_ub, ch = ref.batched_slab_round_ref(
            *operands, slab, max_run_len, eps, int_eps, inf, outward
        )
        lb.copy_(new_lb)
        ub.copy_(new_ub)
        return lb, ub, ch
    t, r, k, bsz, width = _check_round(val, col_s, is_int_g, row_done, lhs_g, rhs_g, strs, (),
                                       lb, ub, active)
    n_runs = _check_runs(t, run_start=run_start, run_len=run_len, run_inst=run_inst,
                         run_slab=run_slab)
    if n_runs != bsz * _n_slabs(width, slab):
        raise ValueError(f"{n_runs} runs, expected one per window ({bsz} x "
                         f"{_n_slabs(width, slab)})")
    best_l = torch.full((bsz, width), -inf, dtype=torch.float64, device=val.device)
    best_u = torch.full((bsz, width), inf, dtype=torch.float64, device=val.device)
    err = _build.lib().slab_scatter(
        _p(val), _p(col_s), _p(is_int_g), _p(row_done), *map(_p, strs), _p(lhs_g), _p(rhs_g),
        _p(run_start), _p(run_inst), _p(run_slab), _p(active), _p(lb), _p(ub), _p(best_l),
        _p(best_u), n_runs, t * r, r, k, width, slab, int_eps, inf, _stream(),
    )
    batched_slab_round_tiles.launches += 1
    _build.check(err, "slab_scatter")
    flags = _slab_merge(lb, ub, best_l, best_u, active, slab, eps, inf, outward)
    return lb, ub, flags.reshape(-1)


batched_slab_round_tiles.launches = 0


def node_slab_partials_tiles(
    val, col_s, run_start, run_len, run_slab, active, lb, ub, slab: int, max_run_len: int,
    inf: float = INF,
):
    """Per-copy, per-node activity partials of ONE instance's straddle
    sub-stream: ``(Ta, R, K)`` copies + run maps + ``(B, W)`` per-node
    planes + ``(B,)`` ``active`` -> 4 x ``(B, Ta, R)``; inactive nodes get
    zeros.  Per node exactly :func:`batched_slab_partials_tiles`.

    Replaces ``node_slab_partials_tiles`` / ``_node_slab_partials_kernel``
    (src/repro/kernels/prop_round.py:1383 / :1351).  Bound on the H100: the
    sub-stream once per launch (it fits the 50 MB L2 at the solver's
    sizes) plus each active node's window gathers and 24 B of partials per
    (node, chunk), and the zeros of the inactive nodes' rows.  Design: #11's
    lane groups; each warp ballots the mask 32 nodes at a time and visits
    the active nodes only (kernel #10's scheme); the wrapper zero-fills the
    outputs."""
    operands = (val, col_s, run_start, run_len, run_slab, active, lb, ub)
    if not _on_cuda(*operands):
        return ref.node_slab_partials_ref(*operands, slab, max_run_len, inf)
    t, r, k, bsz, width = _check_copies(val, col_s, lb, ub, active)
    n_runs = _check_runs(t, run_start=run_start, run_len=run_len, run_slab=run_slab)
    dev = val.device
    mf = torch.zeros((bsz, t, r), dtype=torch.float64, device=dev)
    xf = torch.zeros((bsz, t, r), dtype=torch.float64, device=dev)
    mc = torch.zeros((bsz, t, r), dtype=torch.int32, device=dev)
    xc = torch.zeros((bsz, t, r), dtype=torch.int32, device=dev)
    if t == 0:
        return mf, mc, xf, xc
    err = _build.lib().node_slab_partials(
        _p(val), _p(col_s), _p(run_start), _p(run_slab), _p(active), _p(lb), _p(ub), _p(mf),
        _p(mc), _p(xf), _p(xc), n_runs, t * r, r, k, bsz, width, slab, inf, _stream(),
    )
    node_slab_partials_tiles.launches += 1
    _build.check(err, "node_slab_partials")
    return mf, mc, xf, xc


node_slab_partials_tiles.launches = 0


def node_slab_round_tiles(
    val, col_s, is_int_g, row_done, str_min_fin, str_min_cnt, str_max_fin, str_max_cnt,
    lhs_g, rhs_g, run_start, run_len, run_slab, active, lb, ub, slab: int, max_run_len: int,
    eps: float, int_eps: float, inf: float = INF, outward: float = 0.0,
):
    """The slab round over a node batch, IN PLACE: ONE instance's ``(T'',
    R, K)`` copies + ``(B, T'', R)`` per-node straddle aggregates + shared
    ``row_done`` / sides / run maps + ``(B, W)`` per-node planes + ``(B,)``
    ``active`` -> the planes, updated, and ``(B, n_runs)`` int32 changed
    flags.  Per node exactly :func:`batched_slab_round_tiles` at ``B ==
    1``; inactive nodes pass through.

    Replaces ``node_slab_round_tiles`` / ``_node_slab_round_kernel``
    (src/repro/kernels/prop_round.py:1498 / :1443).  Bound on the H100: the
    copy stream once per launch, plus per active node the window bounds
    read and written, 24 B of straddle aggregates per chunk and the
    accumulator rows written and read once.  Design: #12's two launches;
    the scatter ballots the mask 32 nodes per warp and visits the active
    nodes only; #15's merge skips the inactive rows (counted as #15's
    launch)."""
    strs = (str_min_fin, str_min_cnt, str_max_fin, str_max_cnt)
    operands = (val, col_s, is_int_g, row_done, *strs, lhs_g, rhs_g, run_start, run_len,
                run_slab, active, lb, ub)
    if not _on_cuda(*operands):
        new_lb, new_ub, ch = ref.node_slab_round_ref(
            *operands, slab, max_run_len, eps, int_eps, inf, outward
        )
        lb.copy_(new_lb)
        ub.copy_(new_ub)
        return lb, ub, ch
    bsz = lb.shape[0]
    t, r, k, bsz, width = _check_round(val, col_s, is_int_g, row_done, lhs_g, rhs_g, strs,
                                       (bsz,), lb, ub, active)
    n_runs = _check_runs(t, run_start=run_start, run_len=run_len, run_slab=run_slab)
    if n_runs != _n_slabs(width, slab):
        raise ValueError(f"{n_runs} runs, expected one per slab ({_n_slabs(width, slab)})")
    best_l = torch.full((bsz, width), -inf, dtype=torch.float64, device=val.device)
    best_u = torch.full((bsz, width), inf, dtype=torch.float64, device=val.device)
    err = _build.lib().node_slab_scatter(
        _p(val), _p(col_s), _p(is_int_g), _p(row_done), *map(_p, strs), _p(lhs_g), _p(rhs_g),
        _p(run_start), _p(run_slab), _p(active), _p(lb), _p(ub), _p(best_l), _p(best_u),
        n_runs, t * r, r, k, bsz, width, slab, int_eps, inf, _stream(),
    )
    node_slab_round_tiles.launches += 1
    _build.check(err, "node_slab_scatter")
    flags = _slab_merge(lb, ub, best_l, best_u, active, slab, eps, inf, outward)
    return lb, ub, flags


node_slab_round_tiles.launches = 0


def apply_updates_slab_tiles(
    lb, ub, best_l, best_u, active, slab: int, eps: float, inf: float = INF,
    outward: float = 0.0,
):
    """Merge over ``(instance, slab)`` windows, IN PLACE: ``(B, W)``
    bounds and best candidates + ``(B,)`` ``active`` -> the planes, updated,
    and ``(B,)`` bool per-instance changed flags (the per-window flags
    OR-ed).  ``bounds.apply_updates`` semantics; inactive rows pass
    through.

    Replaces ``apply_updates_slab_tiles`` / ``_apply_updates_slab_kernel``
    (src/repro/kernels/prop_round.py:1595 / :1581).  The same kernel is the
    second launch of #12 and #14.  Bound on the H100: 32 B of reads per
    active (row, column), 8 B per entry that tightens, and the flags.
    Design: a (column block, row) grid whose blocks of inactive rows return
    at once; a thread whose column tightens sets its window's flag."""
    if not _on_cuda(lb, ub, best_l, best_u, active):
        new_lb, new_ub, flags = ref.apply_updates_slab_ref(
            lb, ub, best_l, best_u, active, slab, eps, inf, outward
        )
        lb.copy_(new_lb)
        ub.copy_(new_ub)
        return lb, ub, flags.any(dim=1)
    bsz, width = lb.shape
    if bsz > MAX_GRID_Y:
        raise ValueError(f"{bsz} planes exceed the grid's {MAX_GRID_Y}")
    _check_planes(bsz, width, lb=lb, ub=ub, best_l=best_l, best_u=best_u)
    _expect("active", active, torch.bool, (bsz,))
    flags = _slab_merge(lb, ub, best_l, best_u, active, slab, eps, inf, outward)
    return lb, ub, flags.any(dim=1)


apply_updates_slab_tiles.launches = 0


KERNELS = (
    fused_scatter_round_tiles,
    activities_gather_tiles,
    candidates_scatter_tiles,
    apply_updates_tiles,
    combine_chunk_partials_tiles,
    node_fused_scatter_round_tiles,
    apply_updates_batch_tiles,
    node_objective_tiles,
    batched_fused_scatter_round_tiles,
    batched_slab_partials_tiles,
    batched_slab_round_tiles,
    node_slab_partials_tiles,
    node_slab_round_tiles,
    apply_updates_slab_tiles,
)


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last :func:`reset_launch_counts`."""
    return {fn.__name__: fn.launches for fn in KERNELS}


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
