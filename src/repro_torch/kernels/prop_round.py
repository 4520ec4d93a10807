"""The four kernels of the fused propagation round, behind PyTorch wrappers.

Each wrapper keeps the signature of its Pallas twin in the JAX package
(``src/repro/kernels/prop_round.py``) minus ``interpret`` and ``block``.  On
a CPU tensor it runs the kernel's plain-PyTorch version (``ref.py``); on a
CUDA tensor it launches the hand-written Hopper kernel of
``csrc/prop_round.cu`` on the current stream, or raises -- it never falls
back.  Each wrapper counts its kernel launches in a plain integer attribute,
``<wrapper>.launches`` (see :func:`launch_counts`).

Layout of the tile arguments: ``val`` (T, R, K) float64 with 0 at padding,
``col`` (T, R, K) int32 with every id in ``[0, n_pad)``, ``is_int_g``
(T, R, K) int32 integrality of each slot's column, per-chunk sides and row
aggregates (T, R), bound vectors (n_pad,) float64.  All contiguous, all on
one device.
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
    one warp per chunk, lanes on consecutive slots (coalesced), row sums by
    warp shuffle, the one-hot gather of the TPU kernel as an indexed load and
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
    per nonzero).  Design: one
    warp per chunk, indexed bound loads, warp-shuffle sums; lane 0 writes
    the chunk's four partials."""
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


KERNELS = (
    fused_scatter_round_tiles,
    activities_gather_tiles,
    candidates_scatter_tiles,
    apply_updates_tiles,
)


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last :func:`reset_launch_counts`."""
    return {fn.__name__: fn.launches for fn in KERNELS}


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
