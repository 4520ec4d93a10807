"""Plain-PyTorch versions of the tile kernels: the shared tile math and the
oracle of every kernel in ``prop_round``.

These define the exact semantics (sentinel-infinity handling, padding masks,
division-first candidates) the CUDA kernels must reproduce.  On a CPU tensor
the kernel wrappers run these functions; on the card ``chip_smoke.py`` and
the GPU tests hold each kernel against them on the same inputs.
"""
from __future__ import annotations

import torch

from ..core.types import INF, int_round_slack


def tile_contributions(val, lb_g, ub_g, inf: float = INF):
    """Per-nonzero activity contributions of one (or many) (.., R, K) tiles.

    Returns (pos, pad, min_is_inf, max_is_inf, c_min, c_max)."""
    pos = val > 0
    pad = val == 0
    b_min = torch.where(pos, lb_g, ub_g)
    b_max = torch.where(pos, ub_g, lb_g)
    min_is_inf = (b_min.abs() >= inf) & ~pad
    max_is_inf = (b_max.abs() >= inf) & ~pad
    c_min = torch.where(min_is_inf | pad, 0.0, val * b_min)
    c_max = torch.where(max_is_inf | pad, 0.0, val * b_max)
    return pos, pad, min_is_inf, max_is_inf, c_min, c_max


WARP = 32


def warp_order_sum(x):
    """Sum over the last axis in the order of the CUDA kernels' row sums.

    A warp owns a chunk: lane ``l`` adds slots ``l, l + 32, l + 64, ...`` in
    turn, then a butterfly of shuffles halves the lanes (``l + 16``, then
    ``l + 8``, ... ``l + 1``).  Fixing this order makes kernel and plain
    version round alike on any data, not only where the sums are exact."""
    pad = (-x.shape[-1]) % WARP
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    x = x.reshape(*x.shape[:-1], -1, WARP)
    acc = x[..., 0, :]
    for j in range(1, x.shape[-2]):
        acc = acc + x[..., j, :]
    width = WARP
    while width > 1:
        width //= 2
        acc = acc[..., :width] + acc[..., width : 2 * width]
    return acc[..., 0]


def tile_row_aggregates(val, lb_g, ub_g, inf: float = INF):
    """Per-chunk activity partials of (.., R, K) tiles -> 4 x (.., R): finite
    min/max sums (in :func:`warp_order_sum` order) and int32 infinity
    counts."""
    _, _, min_is_inf, max_is_inf, c_min, c_max = tile_contributions(
        val, lb_g, ub_g, inf
    )
    rmf = warp_order_sum(c_min)
    rxf = warp_order_sum(c_max)
    rmc = min_is_inf.sum(dim=-1, dtype=torch.int32)
    rxc = max_is_inf.sum(dim=-1, dtype=torch.int32)
    return rmf, rmc, rxf, rxc


def tile_candidates(
    val, lb_g, ub_g, is_int_g,
    row_min_fin, row_min_cnt, row_max_fin, row_max_cnt,
    lhs, rhs, int_eps: float, inf: float = INF,
):
    """Residual activities (§3.4 single-infinity rule) + bound candidates
    (Eqs. 4/5) + integrality rounding.  Row aggregates / sides are (.., R)
    and broadcast over the K axis.

    Candidates use the division-first form ``(side - row_sum) / a + bound``:
    the chain (sub, div, add) has no multiply feeding an add, so no compiler
    can contract it into an FMA and every implementation rounds alike."""
    pos, pad, min_is_inf, max_is_inf, _, _ = tile_contributions(
        val, lb_g, ub_g, inf
    )
    rmf = row_min_fin[..., None]
    rmc = row_min_cnt[..., None]
    rxf = row_max_fin[..., None]
    rxc = row_max_cnt[..., None]
    lhs_b = lhs[..., None]
    rhs_b = rhs[..., None]

    # Residual usable at this entry (§3.4): all contributions finite and the
    # row sum complete (cnt == 0), or exactly this entry's bound infinite so
    # the sum over the others IS the residual (cnt == 1).
    ok_min = torch.where(min_is_inf, rmc == 1, rmc == 0)
    ok_max = torch.where(max_is_inf, rxc == 1, rxc == 0)
    # This entry's own bound, folded back in candidate space (0 when the
    # entry's contribution was never part of the finite sum).
    b_min = torch.where(pos, lb_g, ub_g)
    b_max = torch.where(pos, ub_g, lb_g)
    inc_min = torch.where(min_is_inf | pad, 0.0, b_min)
    inc_max = torch.where(max_is_inf | pad, 0.0, b_max)

    safe_a = torch.where(pad, 1.0, val)
    q_min = (rhs_b - rmf) / safe_a + inc_min
    q_max = (lhs_b - rxf) / safe_a + inc_max
    lcand = torch.where(pos, q_max, q_min)
    ucand = torch.where(pos, q_min, q_max)

    valid_l = torch.where(pos, (lhs_b > -inf) & ok_max, (rhs_b < inf) & ok_min) & ~pad
    valid_u = torch.where(pos, (rhs_b < inf) & ok_min, (lhs_b > -inf) & ok_max) & ~pad
    lcand = torch.where(valid_l, lcand.clamp(-inf, inf), -inf)
    ucand = torch.where(valid_u, ucand.clamp(-inf, inf), inf)

    do_l = is_int_g & (lcand.abs() < inf)
    do_u = is_int_g & (ucand.abs() < inf)
    slack = int_round_slack(lcand.dtype)
    sl = su = int_eps
    if slack:
        sl = int_eps + slack * lcand.abs().clamp_min(1.0)
        su = int_eps + slack * ucand.abs().clamp_min(1.0)
    lcand = torch.where(do_l, torch.ceil(lcand - sl), lcand)
    ucand = torch.where(do_u, torch.floor(ucand + su), ucand)
    return lcand, ucand


def activities_tiles_ref(val, lb_g, ub_g, inf: float = INF):
    """Kernel A oracle: per-chunk activity partials from pre-gathered bounds,
    (T, R, K) -> 4 x (T, R)."""
    return tile_row_aggregates(val, lb_g, ub_g, inf)


def candidates_tiles_ref(
    val, lb_g, ub_g, is_int_g,
    row_min_fin, row_min_cnt, row_max_fin, row_max_cnt,
    lhs_g, rhs_g, int_eps: float, inf: float = INF,
):
    """Kernel B oracle: (T, R, K) candidates from completed (T, R) row
    aggregates; invalid entries at the -inf/+inf sentinels."""
    return tile_candidates(
        val, lb_g, ub_g, is_int_g != 0,
        row_min_fin, row_min_cnt, row_max_fin, row_max_cnt,
        lhs_g, rhs_g, int_eps, inf,
    )


def fused_round_tiles_ref(
    val, lb_g, ub_g, is_int_g, lhs_g, rhs_g, int_eps: float, inf: float = INF
):
    """Kernel C oracle: activities + candidates in one pass; valid iff every
    row fits one chunk."""
    mf, mc, xf, xc = activities_tiles_ref(val, lb_g, ub_g, inf)
    return candidates_tiles_ref(
        val, lb_g, ub_g, is_int_g, mf, mc, xf, xc, lhs_g, rhs_g, int_eps, inf
    )


def scatter_round_ref(lcand, ucand, col, n_pad: int, inf: float = INF):
    """Column reduction oracle: accumulators start at the -inf/+inf
    *sentinels*, so columns with no candidate come out at the sentinel (the
    segment identities clamped to it)."""
    flat_col = col.reshape(-1).long()
    best_l = torch.full((n_pad,), -inf, dtype=lcand.dtype, device=lcand.device)
    best_u = torch.full((n_pad,), inf, dtype=ucand.dtype, device=ucand.device)
    best_l.scatter_reduce_(0, flat_col, lcand.reshape(-1), "amax")
    best_u.scatter_reduce_(0, flat_col, ucand.reshape(-1), "amin")
    return best_l, best_u


def fused_scatter_round_tiles_ref(
    val, col, is_int_g, lhs_g, rhs_g, lb, ub, n_pad: int, int_eps: float, inf: float = INF,
):
    """Kernel D oracle: bound gather + fused round + column reduction.
    (T, R, K) tiles + (n_pad,) bounds -> (n_pad,) x2."""
    c = col.long()
    lcand, ucand = fused_round_tiles_ref(
        val, lb[c], ub[c], is_int_g, lhs_g, rhs_g, int_eps, inf
    )
    return scatter_round_ref(lcand, ucand, col, n_pad, inf)


def activities_gather_tiles_ref(val, col, lb, ub, n_pad: int, inf: float = INF):
    """Kernel A' oracle: bound gather + activity partials."""
    del n_pad  # shape bookkeeping only; the gather is by column id
    c = col.long()
    return activities_tiles_ref(val, lb[c], ub[c], inf)


def candidates_scatter_tiles_ref(
    val, col, is_int_g,
    row_min_fin, row_min_cnt, row_max_fin, row_max_cnt,
    lhs_g, rhs_g, lb, ub, n_pad: int, int_eps: float, inf: float = INF,
):
    """Kernel E oracle: bound gather + candidates from row aggregates +
    column reduction."""
    c = col.long()
    lcand, ucand = candidates_tiles_ref(
        val, lb[c], ub[c], is_int_g,
        row_min_fin, row_min_cnt, row_max_fin, row_max_cnt,
        lhs_g, rhs_g, int_eps, inf,
    )
    return scatter_round_ref(lcand, ucand, col, n_pad, inf)
