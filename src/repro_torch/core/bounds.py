"""Bound-candidate computation and update (paper Eqs. 4a/4b via 5a/5b).

Candidate formulas, written with residual activities:

  a_ij > 0:  lcand = (lhs_i - maxres_ij) / a_ij    ucand = (rhs_i - minres_ij) / a_ij
  a_ij < 0:  lcand = (rhs_i - minres_ij) / a_ij    ucand = (lhs_i - maxres_ij) / a_ij

A candidate is *valid* only if the side it uses is finite and the residual
activity it uses is finite.  Invalid candidates are emitted as -INF (lower) /
+INF (upper) so that the column-wise max/min reduction ignores them.
"""
from __future__ import annotations

import torch

from .types import INF, int_round_slack


def bound_candidates(a, lhs_row, rhs_row, min_res, max_res, inf: float = INF):
    """Per-nonzero lower/upper bound candidates (invalid at -inf/+inf).

    Args:
      a: (nnz,) coefficients (0 == padding).
      lhs_row, rhs_row: (nnz,) constraint sides of each nonzero's row.
      min_res, max_res: (nnz,) residual activities (sentinel-infinite).
    """
    pos = a > 0
    pad = a == 0
    safe_a = torch.where(pad, 1.0, a)

    num_l = torch.where(pos, lhs_row - max_res, rhs_row - min_res)
    num_u = torch.where(pos, rhs_row - min_res, lhs_row - max_res)
    lcand = num_l / safe_a
    ucand = num_u / safe_a

    valid_l = torch.where(
        pos,
        (lhs_row > -inf) & (max_res < inf),
        (rhs_row < inf) & (min_res > -inf),
    ) & ~pad
    valid_u = torch.where(
        pos,
        (rhs_row < inf) & (min_res > -inf),
        (lhs_row > -inf) & (max_res < inf),
    ) & ~pad

    lcand = torch.where(valid_l, lcand.clamp(-inf, inf), -inf)
    ucand = torch.where(valid_u, ucand.clamp(-inf, inf), inf)
    return lcand, ucand


def round_candidates(lcand, ucand, is_int_col, int_eps: float, inf: float = INF):
    """Integrality strengthening: ceil lower / floor upper (paper Step 3).

    Low-precision candidates get the dtype's scale-aware rounding slack
    (:func:`core.types.int_round_slack`); fp64 rounds exactly."""
    do_round_l = is_int_col & (lcand.abs() < inf)
    do_round_u = is_int_col & (ucand.abs() < inf)
    slack = int_round_slack(lcand.dtype)
    sl = su = int_eps
    if slack:
        sl = int_eps + slack * lcand.abs().clamp_min(1.0)
        su = int_eps + slack * ucand.abs().clamp_min(1.0)
    lcand = torch.where(do_round_l, torch.ceil(lcand - sl), lcand)
    ucand = torch.where(do_round_u, torch.floor(ucand + su), ucand)
    return lcand, ucand


def improved_lb(new_lb, old_lb, eps: float):
    """Scale-aware strict improvement test (tolerance-based termination)."""
    return new_lb > old_lb + eps * old_lb.abs().clamp_min(1.0)


def improved_ub(new_ub, old_ub, eps: float):
    return new_ub < old_ub - eps * old_ub.abs().clamp_min(1.0)


def widen_outward(lcand, ucand, outward: float):
    """Round accepted tightenings *outward* (fp32-tier safety widening): the
    lower candidate moves DOWN and the upper UP by
    ``outward * max(1, |candidate|)``.  ``outward == 0.0`` is the exact fp64
    merge (identity)."""
    lcand = lcand - outward * lcand.abs().clamp_min(1.0)
    ucand = ucand + outward * ucand.abs().clamp_min(1.0)
    return lcand, ucand


def canonical_infinite(lb, ub, inf: float = INF):
    """Restore exact ``+-inf`` sentinels after a cross-dtype cast (fp32
    rounds ``1e20`` to ``1.00000002e20``)."""
    lb = torch.where(lb <= -inf, -inf, lb)
    ub = torch.where(ub >= inf, inf, ub)
    return lb, ub


def apply_updates(
    lb, ub, best_lcand, best_ucand, eps: float, inf: float = INF,
    outward: float = 0.0,
):
    """Merge column-reduced candidates into the bounds.

    Returns ``(new_lb, new_ub, changed)`` with ``changed`` a 0-d bool tensor.
    Non-improving candidates leave the bound untouched, so no epsilon drift
    accumulates across rounds.  ``outward > 0`` widens every accepted
    tightening by :func:`widen_outward`; the improvement test runs on the
    unwidened candidate."""
    take_l = improved_lb(best_lcand, lb, eps)
    take_u = improved_ub(best_ucand, ub, eps)
    if outward:
        best_lcand, best_ucand = widen_outward(best_lcand, best_ucand, outward)
    new_lb = torch.where(take_l, best_lcand.clamp(-inf, inf), lb)
    new_ub = torch.where(take_u, best_ucand.clamp(-inf, inf), ub)
    changed = take_l.any() | take_u.any()
    return new_lb, new_ub, changed


def apply_updates_batch(
    lb, ub, best_lcand, best_ucand, eps: float, inf: float = INF,
    outward: float = 0.0, active=None,
):
    """Batched merge: ``(B, n_pad)`` bounds/candidates -> per-row change.

    Identical elementwise semantics to :func:`apply_updates`; the
    ``changed`` reduction stays per row (``(B,)`` bool), which lets a
    batched fixed point converge each row independently.  ``active`` (a
    ``(B,)`` bool mask) freezes the rows where it is False: they pass
    through bit for bit and report unchanged.  This is the plain version
    of the batched merge kernel (``kernels.apply_updates_batch_tiles``)."""
    take_l = improved_lb(best_lcand, lb, eps)
    take_u = improved_ub(best_ucand, ub, eps)
    if active is not None:
        take_l = take_l & active[:, None]
        take_u = take_u & active[:, None]
    if outward:
        best_lcand, best_ucand = widen_outward(best_lcand, best_ucand, outward)
    new_lb = torch.where(take_l, best_lcand.clamp(-inf, inf), lb)
    new_ub = torch.where(take_u, best_ucand.clamp(-inf, inf), ub)
    changed = take_l.any(dim=-1) | take_u.any(dim=-1)
    return new_lb, new_ub, changed


def progress_measure(lb_old, ub_old, lb_new, ub_new):
    """Per-round *measure of progress* (Sofranac et al., arXiv:2106.07573,
    adapted to sentinel-infinite bounds): the scale-normalized total bound
    movement of one round,

        sum_j  (lb' - lb) / (1 + max(|lb|, |lb'|))
             + (ub - ub') / (1 + max(|ub|, |ub'|))

    reduced over the trailing (variable) axis."""
    dl = lb_new - lb_old
    du = ub_old - ub_new
    sl = 1.0 + torch.maximum(lb_old.abs(), lb_new.abs())
    su = 1.0 + torch.maximum(ub_old.abs(), ub_new.abs())
    return (dl / sl + du / su).sum(dim=-1)
