"""Sequential domain propagation (paper Algorithm 1) -- the cpu_seq baseline,
and the exhaustive integer oracle of the solver's tests.  Host numpy; the
port's own copy of the JAX package's ``core/seq_ref.py``, so that
``repro_torch`` stands alone.

Faithful numpy implementation of the state-of-the-art sequential algorithm,
including:

  * the constraint *marking* mechanism (lines 1, 6, 7, 20) driven by a CSC
    view built once up-front (init excluded from timing, paper §4.3);
  * early-termination checks (redundant / cannot-propagate constraints are
    skipped);
  * immediate bound updates: a tightening found while processing constraint c
    is visible to every constraint processed after c in the same round --
    the sequential advantage quantified in §2.2.

A variant without marking (``propagate_sequential(..., use_marking=False)``)
serves as the independent second baseline for the Fig.-3-style validation
benchmark.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .sparse import Problem, csr_to_csc
from .types import DEFAULT_CONFIG, INF, PropagatorConfig


@dataclasses.dataclass
class SeqResult:
    """Outcome of the sequential reference propagation (host numpy):
    tightened ``(n,)`` bounds, rounds to the fixed point, convergence /
    infeasibility verdicts, and the total number of bound changes applied
    (the marking mechanism's work measure)."""

    lb: np.ndarray
    ub: np.ndarray
    rounds: int
    converged: bool
    infeasible: bool
    n_bound_changes: int


def _row_activities(a, lb_v, ub_v, inf):
    """Finite parts + infinity counts of min/max activity for one row."""
    pos = a > 0
    b_min = np.where(pos, lb_v, ub_v)
    b_max = np.where(pos, ub_v, lb_v)
    min_inf = np.abs(b_min) >= inf
    max_inf = np.abs(b_max) >= inf
    min_fin = float(np.sum(np.where(min_inf, 0.0, a * b_min)))
    max_fin = float(np.sum(np.where(max_inf, 0.0, a * b_max)))
    return min_fin, int(min_inf.sum()), max_fin, int(max_inf.sum()), min_inf, max_inf


def propagate_sequential(
    p: Problem,
    cfg: PropagatorConfig = DEFAULT_CONFIG,
    use_marking: bool = True,
    dtype=np.float64,
) -> SeqResult:
    """The paper's sequential Algorithm 1 on the host: constraint-at-a-time
    propagation with the CSC-based marking mechanism (``use_marking=False``
    sweeps every row each round instead).  The limit-point reference every
    parallel engine is validated against (paper §4.3 tolerance)."""
    csr = p.csr._replace(val=p.csr.val.astype(dtype))
    m, n = csr.m, csr.n
    inf = cfg.inf
    eps = cfg.tighten_eps if dtype == np.float64 else cfg.tighten_eps_f32
    int_eps = cfg.int_eps

    lb = p.lb.astype(dtype).copy()
    ub = p.ub.astype(dtype).copy()
    lhs = p.lhs.astype(dtype)
    rhs = p.rhs.astype(dtype)
    is_int = p.is_int

    # Init phase (excluded from timed region by callers): CSC for marking.
    csc = csr_to_csc(p.csr)

    marked = np.ones(m, dtype=bool)
    rounds = 0
    infeasible = False
    n_changes = 0
    bound_change_found = True

    while bound_change_found and rounds < cfg.max_rounds and not infeasible:
        bound_change_found = False
        rounds += 1
        for c in range(m):
            if use_marking and not marked[c]:
                continue
            marked[c] = False
            s, e = int(csr.row_ptr[c]), int(csr.row_ptr[c + 1])
            if s == e:
                continue
            a = csr.val[s:e]
            cols = csr.col[s:e]
            lb_v = lb[cols]
            ub_v = ub[cols]
            min_fin, min_cnt, max_fin, max_cnt, min_inf, max_inf = _row_activities(
                a, lb_v, ub_v, inf
            )
            amin = -inf if min_cnt > 0 else min_fin
            amax = inf if max_cnt > 0 else max_fin

            # Early termination (paper Alg. 1 line 9): redundant constraints
            # cannot tighten anything.
            if lhs[c] <= amin + 1e-12 * max(1.0, abs(amin)) and amax <= rhs[c] + 1e-12 * max(1.0, abs(amax)):
                continue
            # No finite residual on either side -> nothing to propagate.
            if min_cnt >= 2 and max_cnt >= 2:
                continue

            pos = a > 0
            contrib_min = np.where(min_inf, 0.0, a * np.where(pos, lb_v, ub_v))
            contrib_max = np.where(max_inf, 0.0, a * np.where(pos, ub_v, lb_v))

            for k in range(e - s):
                j = int(cols[k])
                ak = float(a[k])
                # Residual activities (Eqs. 5a/5b, §3.4 single-infinity rule).
                if min_inf[k]:
                    min_res = min_fin if min_cnt == 1 else -inf
                else:
                    min_res = min_fin - contrib_min[k] if min_cnt == 0 else -inf
                if max_inf[k]:
                    max_res = max_fin if max_cnt == 1 else inf
                else:
                    max_res = max_fin - contrib_max[k] if max_cnt == 0 else inf

                if ak > 0:
                    lcand_ok = lhs[c] > -inf and max_res < inf
                    ucand_ok = rhs[c] < inf and min_res > -inf
                    lcand = (lhs[c] - max_res) / ak if lcand_ok else -inf
                    ucand = (rhs[c] - min_res) / ak if ucand_ok else inf
                else:
                    lcand_ok = rhs[c] < inf and min_res > -inf
                    ucand_ok = lhs[c] > -inf and max_res < inf
                    lcand = (rhs[c] - min_res) / ak if lcand_ok else -inf
                    ucand = (lhs[c] - max_res) / ak if ucand_ok else inf

                if is_int[j]:
                    if abs(lcand) < inf:
                        lcand = np.ceil(lcand - int_eps)
                    if abs(ucand) < inf:
                        ucand = np.floor(ucand + int_eps)

                changed_j = False
                if lcand > lb[j] + eps * max(1.0, abs(lb[j])):
                    lb[j] = min(max(lcand, -inf), inf)
                    changed_j = True
                if ucand < ub[j] - eps * max(1.0, abs(ub[j])):
                    ub[j] = min(max(ucand, -inf), inf)
                    changed_j = True
                if changed_j:
                    n_changes += 1
                    bound_change_found = True
                    if lb[j] > ub[j] + cfg.feas_eps:
                        infeasible = True
                    # Mark every constraint containing variable j (line 20).
                    cs, ce = int(csc.col_ptr[j]), int(csc.col_ptr[j + 1])
                    marked[csc.row[cs:ce]] = True
                    # Bound of j changed -> our own activities are stale.
                    lb_v = lb[cols]
                    ub_v = ub[cols]
                    (
                        min_fin,
                        min_cnt,
                        max_fin,
                        max_cnt,
                        min_inf,
                        max_inf,
                    ) = _row_activities(a, lb_v, ub_v, inf)
                    contrib_min = np.where(
                        min_inf, 0.0, a * np.where(pos, lb_v, ub_v)
                    )
                    contrib_max = np.where(
                        max_inf, 0.0, a * np.where(pos, ub_v, lb_v)
                    )
                if infeasible:
                    break
            if infeasible:
                break

    converged = not bound_change_found and not infeasible
    return SeqResult(
        lb=lb,
        ub=ub,
        rounds=rounds,
        converged=converged,
        infeasible=infeasible,
        n_bound_changes=n_changes,
    )


@dataclasses.dataclass
class BruteForceResult:
    """Outcome of :func:`brute_force_solve`: the exact optimal objective
    and one optimal assignment (``None`` when infeasible), the feasibility
    verdict, and the number of assignments enumerated."""

    objective: float
    x: "np.ndarray | None"
    feasible: bool
    n_enumerated: int


def brute_force_solve(
    p: Problem,
    c,
    feas_eps: float = 1e-8,
    limit: int = 2_000_000,
    chunk: int = 65536,
) -> BruteForceResult:
    """Exhaustive minimization of ``c @ x`` over the integer box -- the
    exact oracle the device solver's differential tests compare against.

    Enumerates EVERY integer assignment in ``prod_j (ub_j - lb_j + 1)``
    (mixed-radix, variable 0 most significant; ``limit`` guards against
    accidental blowups -- binary instances are fine up to n = 20), checks
    each against the dense constraint rows with the same ``feas_eps``
    tolerance the propagator uses (infinite sides are no constraints), and
    returns the minimum objective over the feasible set with a
    first-in-enumeration-order tie-break.  All host numpy in f64: over
    integral data the objective sums are exact, so the comparison to
    ``solver.solve()`` is bitwise.  Enumeration runs in ``chunk``-sized
    blocks to bound memory."""
    lb = np.asarray(p.lb, np.float64)
    ub = np.asarray(p.ub, np.float64)
    c = np.asarray(c, np.float64)
    if not bool(np.all(np.asarray(p.is_int, bool))):
        raise ValueError("brute_force_solve requires a pure-integer problem")
    if np.any(np.abs(lb) >= INF) or np.any(np.abs(ub) >= INF):
        raise ValueError("brute_force_solve requires finite variable bounds")
    widths = (ub - lb + 1.0).astype(np.int64)
    if np.any(widths < 1):
        return BruteForceResult(INF, None, False, 0)
    total = int(np.prod(widths))
    if total > limit:
        raise ValueError(f"{total} assignments exceed the {limit} cap")

    n = p.n
    dense = np.zeros((p.m, n))
    csr = p.csr
    dense[csr.row_ids(), csr.col] = csr.val
    lhs = np.asarray(p.lhs, np.float64)
    rhs = np.asarray(p.rhs, np.float64)
    has_lhs = lhs > -INF
    has_rhs = rhs < INF

    # Mixed-radix place values, variable 0 most significant.
    place = np.ones(n, np.int64)
    for j in range(n - 2, -1, -1):
        place[j] = place[j + 1] * widths[j + 1]

    best_obj = INF
    best_x = None
    for start in range(0, total, chunk):
        idx = np.arange(start, min(start + chunk, total), dtype=np.int64)
        digits = (idx[:, None] // place[None, :]) % widths[None, :]
        X = lb[None, :] + digits.astype(np.float64)
        act = X @ dense.T
        ok = np.ones(idx.shape[0], dtype=bool)
        if has_lhs.any():
            ok &= np.all(act[:, has_lhs] >= lhs[has_lhs][None, :] - feas_eps, axis=1)
        if has_rhs.any():
            ok &= np.all(act[:, has_rhs] <= rhs[has_rhs][None, :] + feas_eps, axis=1)
        if not ok.any():
            continue
        obj = X[ok] @ c
        k = int(np.argmin(obj))
        if obj[k] < best_obj:
            best_obj = float(obj[k])
            best_x = X[ok][k].copy()
    return BruteForceResult(
        objective=best_obj if best_x is not None else INF,
        x=best_x,
        feasible=best_x is not None,
        n_enumerated=total,
    )
