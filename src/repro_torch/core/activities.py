"""Activity computation (paper Def. 1 + §3.4 infinity counting), PyTorch.

Given the per-nonzero coefficient ``a`` and the bounds of its column, emit
the finite minimum/maximum activity contributions and 0/1 infinity counters,
which are then segment-summed per row.  The pure-torch propagator
(``core.propagator``) and the sequential semantics share these formulas.
"""
from __future__ import annotations

import torch

from .types import INF, Activities


def nnz_contributions(a, lb_col, ub_col, inf: float = INF):
    """Per-nonzero activity contributions.

    Args:
      a: (nnz,) coefficients (0 == padding; contributes nothing).
      lb_col, ub_col: (nnz,) bounds of each nonzero's column, pre-gathered.

    Returns:
      (min_fin, min_inf, max_fin, max_inf): finite contributions (0 where the
      chosen bound is infinite or at padding) and int32 0/1 infinity counters.
    """
    pos = a > 0
    pad = a == 0
    # Minimum activity picks lb where a>0 else ub (Eq. 3a); maximum the
    # other one (Eq. 3b).
    b_min = torch.where(pos, lb_col, ub_col)
    b_max = torch.where(pos, ub_col, lb_col)
    min_is_inf = (b_min.abs() >= inf) & ~pad
    max_is_inf = (b_max.abs() >= inf) & ~pad
    min_fin = torch.where(min_is_inf | pad, 0.0, a * b_min)
    max_fin = torch.where(max_is_inf | pad, 0.0, a * b_max)
    return (
        min_fin,
        min_is_inf.to(torch.int32),
        max_fin,
        max_is_inf.to(torch.int32),
    )


def segment_sum(x, segment_ids, num_segments: int):
    """Sum of ``x`` per segment id (``index_add_``), zeros for empty segments.
    On the CPU it adds in index order, so a 16-bit sum rounds after every
    add in that order, as the reference's ``segment_sum`` does; on the card
    its atomics add in no fixed order (the plain ``propagate`` is no kernel
    path)."""
    out = torch.zeros(num_segments, dtype=x.dtype, device=x.device)
    return out.index_add_(0, segment_ids, x)


def compute_activities(
    row_id, a, col, lb, ub, m: int, inf: float = INF
) -> Activities:
    """Row activities by segment reduction over nonzeros.

    Args:
      row_id: (nnz,) int64 row of each nonzero.
      a: (nnz,) coefficients.
      col: (nnz,) int64 column ids.
      lb, ub: (n,) bounds.
      m: row count.
    """
    min_fin, min_inf, max_fin, max_inf = nnz_contributions(a, lb[col], ub[col], inf)
    return Activities(
        min_finite=segment_sum(min_fin, row_id, m),
        min_inf_count=segment_sum(min_inf, row_id, m),
        max_finite=segment_sum(max_fin, row_id, m),
        max_inf_count=segment_sum(max_inf, row_id, m),
    )


def activity_values(acts: Activities, inf: float = INF):
    """Materialized (sentinel) activity values: -inf / +inf where counted."""
    amin = torch.where(acts.min_inf_count > 0, -inf, acts.min_finite)
    amax = torch.where(acts.max_inf_count > 0, inf, acts.max_finite)
    return amin, amax


def residual_activities(
    a, contrib_fin, contrib_is_inf, row_fin, row_inf_count, side: str, inf: float = INF
):
    """Residual activities per nonzero (paper Eqs. 5a/5b + §3.4 special case).

    ``side='min'``: residual of the minimum activity; infinite residuals are
    ``-inf``.  ``side='max'``: symmetric with ``+inf``.  If this nonzero's
    own contribution is the only infinite one, the residual is the (fully
    finite) row sum; if any *other* contribution is infinite the residual is
    infinite.
    """
    sent = -inf if side == "min" else inf
    res_if_own_inf = torch.where(row_inf_count == 1, row_fin, sent)
    res_if_own_fin = torch.where(row_inf_count == 0, row_fin - contrib_fin, sent)
    res = torch.where(contrib_is_inf == 1, res_if_own_inf, res_if_own_fin)
    return torch.where(a == 0, sent, res)  # padding: force invalid
