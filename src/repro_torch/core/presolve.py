"""Constraint-level presolve observations (paper §1.1 Steps 1 and 2).

These are *diagnostics* layered on top of the activity computation: Step 3
(the propagator) is correct without them (paper §1.1 remark), but a MIP
presolve service wants the redundancy / infeasibility verdicts as outputs.
PyTorch, on the port's ``core.activities``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .activities import activity_values, compute_activities
from .propagator import resolve_device
from .types import INF


class PresolveVerdict(NamedTuple):
    """Per-constraint presolve verdicts from one activity computation
    (paper §1.1 Steps 1-2): rows provably redundant, rows provably
    unsatisfiable, and their any-reduction."""

    redundant: torch.Tensor    # (m,) bool: Step 1 -- constraint can be removed
    infeasible: torch.Tensor   # (m,) bool: Step 2 -- constraint cannot be satisfied
    any_infeasible: torch.Tensor  # () bool


def analyze_constraints(
    row_id, val, col, lhs, rhs, lb, ub, m: int, feas_eps: float = 1e-8, inf: float = INF,
    device="cuda",
) -> PresolveVerdict:
    """Classify every constraint as redundant / infeasible / neither from
    its activity bounds (``(nnz,)`` COO-style inputs plus ``(m,)`` sides and
    ``(n,)`` bounds, tensors or arrays).  It runs on the device of ``lb``
    where that is a tensor, else on ``device``: CUDA by default, which
    raises where there is none; pass ``device="cpu"`` to run on the CPU."""
    dev = lb.device if isinstance(lb, torch.Tensor) else resolve_device(device)
    t = lambda x: torch.as_tensor(x, device=dev)
    lb, ub, val, lhs, rhs = t(lb), t(ub), t(val), t(lhs), t(rhs)
    acts = compute_activities(t(row_id).long(), val, t(col).long(), lb, ub, m, inf)
    amin, amax = activity_values(acts, inf)
    # Step 1: lhs <= amin and amax <= rhs  -> redundant.
    redundant = (lhs <= amin) & (amax <= rhs)
    # Step 2: amin > rhs or lhs > amax     -> infeasible.
    infeasible = (amin > rhs + feas_eps) | (lhs > amax + feas_eps)
    return PresolveVerdict(redundant, infeasible, infeasible.any())
