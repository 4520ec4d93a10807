"""Synthetic MIP instance generator (MIPLIB-2017-like structural mixes).

The paper's MIPLIB 2017 test bed is replaced by a seeded generator
reproducing the structural features the paper calls out:

  * highly sparse matrices with power-law row lengths (§1, §3);
  * a few very dense *connecting constraints* (§3: the CSR-vector case);
  * integrality mixes (§1.1 Step 3 rounding);
  * finite and infinite bounds / one-sided constraints (§3.4);
  * cascade chains -- the §2.2 price-of-parallelism worst case;
  * classic families (knapsack, set cover, bin packing, assignment) whose
    propagation behavior is well understood.

Sizes are scaled so the Set-1..Set-8 sweep (paper §4.1) completes on one CPU;
the set boundaries keep the paper's *relative* 2x spacing.

This is a numpy copy of the JAX package's generators: the same call with the
same seed gives byte-identical arrays in both packages.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Callable, Dict, List, Tuple

import numpy as np

from ..core.sparse import Problem, csr_from_coo
from ..core.types import INF


@dataclasses.dataclass(frozen=True)
class InstanceSpec:
    family: str
    m: int
    n: int
    seed: int


# ---------------------------------------------------------------------------
# Families
# ---------------------------------------------------------------------------


def make_knapsack(n: int = 50, m: int = 10, seed: int = 0) -> Problem:
    """m knapsack rows over n binary items: a^T x <= cap, a > 0."""
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    rhs = np.empty(m)
    for i in range(m):
        k = int(rng.integers(max(2, n // 4), max(3, n // 2)))
        js = rng.choice(n, size=k, replace=False)
        a = rng.integers(1, 20, size=k).astype(np.float64)
        rows += [i] * k
        cols += list(js)
        vals += list(a)
        rhs[i] = float(a.sum()) * rng.uniform(0.2, 0.5)
    csr = csr_from_coo(
        np.array(rows), np.array(cols), np.array(vals, dtype=np.float64), m, n
    )
    return Problem(
        csr=csr,
        lhs=np.full(m, -INF),
        rhs=rhs,
        lb=np.zeros(n),
        ub=np.ones(n),
        is_int=np.ones(n, dtype=bool),
    )


def make_set_cover(n: int = 60, m: int = 20, seed: int = 0) -> Problem:
    """sum_j x_j >= 1 over random supports; binary x."""
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for i in range(m):
        k = int(rng.integers(2, max(3, n // 5)))
        js = rng.choice(n, size=k, replace=False)
        rows += [i] * k
        cols += list(js)
        vals += [1.0] * k
    csr = csr_from_coo(
        np.array(rows), np.array(cols), np.array(vals, dtype=np.float64), m, n
    )
    return Problem(
        csr=csr,
        lhs=np.ones(m),
        rhs=np.full(m, INF),
        lb=np.zeros(n),
        ub=np.ones(n),
        is_int=np.ones(n, dtype=bool),
    )


def make_bin_packing(items: int = 30, bins: int = 10, seed: int = 0) -> Problem:
    """x[i,b] binary assignment; capacity rows + assignment equalities."""
    rng = np.random.default_rng(seed)
    n = items * bins
    sizes = rng.integers(2, 12, size=items).astype(np.float64)
    cap = float(sizes.sum() / bins * 1.4)
    rows, cols, vals = [], [], []
    lhs, rhs = [], []
    r = 0
    for b in range(bins):  # capacity rows
        for i in range(items):
            rows.append(r)
            cols.append(i * bins + b)
            vals.append(sizes[i])
        lhs.append(-INF)
        rhs.append(cap)
        r += 1
    for i in range(items):  # assignment equalities: sum_b x[i,b] == 1
        for b in range(bins):
            rows.append(r)
            cols.append(i * bins + b)
            vals.append(1.0)
        lhs.append(1.0)
        rhs.append(1.0)
        r += 1
    csr = csr_from_coo(
        np.array(rows), np.array(cols), np.array(vals, dtype=np.float64), r, n
    )
    return Problem(
        csr=csr,
        lhs=np.array(lhs),
        rhs=np.array(rhs),
        lb=np.zeros(n),
        ub=np.ones(n),
        is_int=np.ones(n, dtype=bool),
    )


def make_assignment(size: int = 12, seed: int = 0) -> Problem:
    """Assignment polytope rows; LP-relaxed bounds on continuous x."""
    n = size * size
    rows, cols, vals = [], [], []
    lhs, rhs = [], []
    r = 0
    for i in range(size):
        for j in range(size):
            rows.append(r)
            cols.append(i * size + j)
            vals.append(1.0)
        lhs.append(1.0)
        rhs.append(1.0)
        r += 1
    for j in range(size):
        for i in range(size):
            rows.append(r)
            cols.append(i * size + j)
            vals.append(1.0)
        lhs.append(1.0)
        rhs.append(1.0)
        r += 1
    csr = csr_from_coo(
        np.array(rows), np.array(cols), np.array(vals, dtype=np.float64), r, n
    )
    return Problem(
        csr=csr,
        lhs=np.array(lhs),
        rhs=np.array(rhs),
        lb=np.zeros(n),
        ub=np.ones(n),
        is_int=np.zeros(n, dtype=bool),
    )


def make_cascade_chain(length: int = 64, seed: int = 0) -> Problem:
    """§2.2 worst case: x_{k+1} <= x_k chain seeded by x_0 <= 0.5.

    Sequential propagation resolves the chain in one round (forward order);
    the parallel algorithm needs ~``length`` rounds.
    """
    del seed
    n = length + 1
    m = length + 1
    rows, cols, vals = [], [], []
    lhs, rhs = [], []
    # Row 0: x_0 <= 0.5
    rows += [0]
    cols += [0]
    vals += [1.0]
    lhs.append(-INF)
    rhs.append(0.5)
    # Row k: x_k - x_{k-1} <= 0  =>  x_k <= x_{k-1}
    for k in range(1, length + 1):
        rows += [k, k]
        cols += [k, k - 1]
        vals += [1.0, -1.0]
        lhs.append(-INF)
        rhs.append(0.0)
    csr = csr_from_coo(
        np.array(rows), np.array(cols), np.array(vals, dtype=np.float64), m, n
    )
    return Problem(
        csr=csr,
        lhs=np.array(lhs),
        rhs=np.array(rhs),
        lb=np.zeros(n),
        ub=np.ones(n),
        is_int=np.zeros(n, dtype=bool),
    )


def make_pseudo_boolean(
    n: int = 80,
    m: int = 60,
    seed: int = 0,
    clause_frac: float = 0.65,
    unit_frac: float = 0.1,
) -> Problem:
    """Pseudo-boolean optimization instance (paper §1's explicit target
    workload): 0/1 variables, ±1 coefficients only.

    Rows mix three shapes:
      * clause-like rows (fraction ``clause_frac``) encoding
        ``x_{j1} v ... v ¬x_{jk}``: positive literals contribute ``+x_j``,
        negated ones ``-x_j``, and the side is ``sum >= 1 - #negated``
        (the standard linearization of a clause);
      * unit clauses (fraction ``unit_frac``) fixing a single literal --
        the seeds that make root propagation cascade through the clauses
        (a PB instance mid-search always carries branching units);
      * cardinality rows ``sum_j x_j <= k/2`` over a random support.
    """
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    lhs = np.empty(m)
    rhs = np.empty(m)
    for i in range(m):
        shape = rng.random()
        if shape < unit_frac:
            j = int(rng.integers(0, n))
            sign = 1.0 if rng.random() < 0.5 else -1.0
            rows.append(i)
            cols.append(j)
            vals.append(sign)
            lhs[i] = 1.0 if sign > 0 else 0.0  # x_j >= 1  /  -x_j >= 0
            rhs[i] = INF
            continue
        k = int(rng.integers(2, max(3, min(9, n))))
        js = rng.choice(n, size=k, replace=False)
        if shape < unit_frac + clause_frac:
            sign = rng.choice([-1.0, 1.0], size=k)
            if not (sign > 0).any():
                sign[rng.integers(0, k)] = 1.0  # keep at least one positive literal
            a = sign
            lhs[i] = 1.0 - float((sign < 0).sum())
            rhs[i] = INF
        else:
            a = np.ones(k)
            lhs[i] = -INF
            rhs[i] = float(max(1, k // 2))
        rows += [i] * k
        cols += list(js)
        vals += list(a)
    csr = csr_from_coo(
        np.array(rows), np.array(cols), np.array(vals, dtype=np.float64), m, n
    )
    return Problem(
        csr=csr,
        lhs=lhs,
        rhs=rhs,
        lb=np.zeros(n),
        ub=np.ones(n),
        is_int=np.ones(n, dtype=bool),
    )


def make_random_mip(
    n: int = 10,
    m: int = 14,
    seed: int = 0,
    ub_max: int = 3,
    tight: float = 0.35,
) -> Problem:
    """Small bounded pure-integer instances for exact solver cross-checks.

    Every variable is integer on ``[0, u_j]`` with ``u_j <= ub_max`` and
    all data is INTEGRAL -- coefficients in ``±[1, 4]``, sides rounded to
    integers -- so every activity and objective sum is an exact f64
    integer and the brute-force oracle comparison
    (``core.seq_ref.brute_force_solve`` vs ``core.solver.solve``) can be
    bitwise.  Rows mix ``<=``, ``>=`` and ranged shapes with integral
    sides drawn strictly inside each row's activity range (``tight``
    controls how deep they cut), so rows actually propagate; some seeds'
    ranged rows conflict and the instance is infeasible -- kept on
    purpose, the differential suite asserts the verdict matches the
    oracle either way.  Enumeration size is ``prod(u_j + 1)``: keep
    ``n * log2(ub_max + 1)`` near 20 for oracle-speed instances."""
    rng = np.random.default_rng(seed)
    lb = np.zeros(n)
    ub = rng.integers(1, ub_max + 1, size=n).astype(np.float64)
    rows, cols, vals = [], [], []
    lhs = np.empty(m)
    rhs = np.empty(m)
    for i in range(m):
        k = int(rng.integers(2, max(3, n // 2 + 1)))
        js = rng.choice(n, size=k, replace=False)
        a = rng.integers(1, 5, size=k).astype(np.float64)
        a *= rng.choice([-1.0, 1.0], size=k)
        amin = float(np.where(a > 0, a * lb[js], a * ub[js]).sum())
        amax = float(np.where(a > 0, a * ub[js], a * lb[js]).sum())
        kind = rng.random()
        q = rng.uniform(tight, 0.9)
        if kind < 0.45:
            lhs[i], rhs[i] = -INF, float(np.floor(amin + q * (amax - amin)))
        elif kind < 0.9:
            lhs[i], rhs[i] = float(np.ceil(amax - q * (amax - amin))), INF
        else:
            lo = float(np.ceil(amin + 0.25 * (amax - amin)))
            hi = float(np.floor(amax - 0.25 * (amax - amin)))
            lhs[i], rhs[i] = min(lo, hi), max(lo, hi)
        rows += [i] * k
        cols += list(js)
        vals += list(a)
    csr = csr_from_coo(
        np.array(rows), np.array(cols), np.array(vals, dtype=np.float64), m, n
    )
    return Problem(
        csr=csr,
        lhs=lhs,
        rhs=rhs,
        lb=lb,
        ub=ub,
        is_int=np.ones(n, dtype=bool),
    )


def make_banded(
    n: int = 100_000,
    m: int = 2_000,
    row_nnz: int = 24,
    band: int = 2_048,
    seed: int = 0,
    int_frac: float = 0.4,
) -> Problem:
    """Wide instance with column-banded rows (the favorably-large regime).

    Each row draws ``row_nnz`` integer-valued coefficients from a random
    ``band``-wide column window, modeling the column locality real models
    exhibit after ordering (paper App. B) -- the regime where the paper's
    speedups grow with size and where the column-slab partitioned engine
    keeps tile duplication near 1 (a row's band rarely straddles a slab
    boundary).  Data is integer-valued so engine cross-checks can assert
    exact agreement."""
    rng = np.random.default_rng(seed)
    row_nnz = min(row_nnz, band, n)
    rows = np.repeat(np.arange(m, dtype=np.int32), row_nnz)
    starts = rng.integers(0, max(1, n - band + 1), size=m)
    cols = np.empty(m * row_nnz, dtype=np.int64)
    for i in range(m):
        cols[i * row_nnz : (i + 1) * row_nnz] = starts[i] + rng.choice(
            min(band, n - starts[i]), size=row_nnz, replace=False
        )
    vals = rng.choice([-3.0, -2.0, -1.0, 1.0, 2.0, 3.0], size=m * row_nnz)
    csr = csr_from_coo(rows, cols.astype(np.int32), vals, m, n)
    lb = -rng.integers(0, 3, size=n).astype(np.float64)
    ub = rng.integers(1, 8, size=n).astype(np.float64)
    lb[rng.random(n) < 0.1] = -INF
    ub[rng.random(n) < 0.1] = INF
    is_int = rng.random(n) < int_frac
    absrow = np.zeros(m)
    np.add.at(absrow, rows, np.abs(vals) * 2.0)
    kind = rng.random(m)
    # lhs <= 0 <= rhs by construction (absrow >= 0), so no side swap needed.
    lhs = np.where(kind < 0.4, -INF, -absrow * 0.3)
    rhs = np.where(kind > 0.8, INF, absrow * 0.3)
    return Problem(csr=csr, lhs=lhs, rhs=rhs, lb=lb, ub=ub, is_int=is_int)


def make_mixed(
    m: int = 200,
    n: int = 150,
    seed: int = 0,
    density: float = 0.03,
    dense_rows: int = 2,
    int_frac: float = 0.6,
    inf_bound_frac: float = 0.15,
) -> Problem:
    """MIPLIB-like heterogeneous instance (power-law rows + dense connecting rows)."""
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    # Power-law-ish row lengths.
    base = max(2, int(density * n))
    raw = rng.pareto(2.0, size=m) + 1.0
    lengths = np.clip((raw * base).astype(int), 2, max(3, n // 2))
    # A few dense connecting rows (paper §3).
    dense_idx = rng.choice(m, size=min(dense_rows, m), replace=False)
    lengths[dense_idx] = max(3, int(n * 0.8))
    for i in range(m):
        k = int(lengths[i])
        js = rng.choice(n, size=k, replace=False)
        a = rng.choice([-1.0, 1.0], size=k) * rng.integers(1, 10, size=k)
        rows += [i] * k
        cols += list(js)
        vals += list(a.astype(np.float64))
    csr = csr_from_coo(
        np.array(rows), np.array(cols), np.array(vals, dtype=np.float64), m, n
    )
    # Bounds: mostly [0, U]; some infinite; integrality mix.
    ub = rng.integers(1, 10, size=n).astype(np.float64)
    lb = np.zeros(n)
    inf_mask = rng.random(n) < inf_bound_frac
    ub[inf_mask] = INF
    lb[rng.random(n) < inf_bound_frac * 0.5] = -INF
    is_int = rng.random(n) < int_frac
    # Sides: mix of <=, >=, ranged rows; scaled to row content for tightness.
    rid = csr.row_ids()
    absrow = np.zeros(m)
    np.add.at(absrow, rid, np.abs(csr.val) * 3.0)
    kind = rng.random(m)
    lhs = np.where(kind < 0.35, -INF, -absrow * rng.uniform(0.1, 0.4, m))
    rhs = np.where(kind > 0.85, INF, absrow * rng.uniform(0.1, 0.4, m))
    bad = lhs > rhs
    lhs[bad], rhs[bad] = rhs[bad], lhs[bad]
    return Problem(
        csr=csr, lhs=lhs, rhs=rhs, lb=lb, ub=ub, is_int=is_int
    )


FAMILIES: Dict[str, Callable[..., Problem]] = {
    "knapsack": make_knapsack,
    "set_cover": make_set_cover,
    "bin_packing": make_bin_packing,
    "assignment": make_assignment,
    "cascade": make_cascade_chain,
    "mixed": make_mixed,
    "pseudo_boolean": make_pseudo_boolean,
    "banded": make_banded,
    "random_mip": make_random_mip,
}


def make_instance(spec: InstanceSpec) -> Problem:
    if spec.family == "knapsack":
        return make_knapsack(n=spec.n, m=spec.m, seed=spec.seed)
    if spec.family == "set_cover":
        return make_set_cover(n=spec.n, m=spec.m, seed=spec.seed)
    if spec.family == "bin_packing":
        items = max(4, spec.n // 10)
        return make_bin_packing(items=items, bins=10, seed=spec.seed)
    if spec.family == "assignment":
        return make_assignment(size=max(3, int(np.sqrt(spec.n))), seed=spec.seed)
    if spec.family == "cascade":
        return make_cascade_chain(length=spec.m - 1, seed=spec.seed)
    if spec.family == "mixed":
        return make_mixed(m=spec.m, n=spec.n, seed=spec.seed)
    if spec.family == "pseudo_boolean":
        return make_pseudo_boolean(n=spec.n, m=spec.m, seed=spec.seed)
    if spec.family == "random_mip":
        # Solver-oracle family: n is clamped so the brute-force enumeration
        # (prod of domain widths) stays tractable whatever the spec asks.
        return make_random_mip(n=min(spec.n, 12), m=spec.m, seed=spec.seed)
    if spec.family == "banded":
        return make_banded(
            n=spec.n, m=spec.m, band=max(128, spec.n // 8), seed=spec.seed
        )
    raise ValueError(spec.family)


# Paper §4.1 size partition [s, t): scaled 100x down so the sweep runs on one
# CPU container while keeping the 2x set spacing.  "size" = max(m, n).
SIZE_SETS: List[Tuple[str, int, int]] = [
    ("Set-1", 10, 100),
    ("Set-2", 100, 200),
    ("Set-3", 200, 400),
    ("Set-4", 400, 800),
    ("Set-5", 800, 1600),
    ("Set-6", 1600, 3200),
    ("Set-7", 3200, 6400),
    ("Set-8", 6400, 12800),
]


def instances_for_set(
    set_name: str,
    per_family: int = 2,
    # pseudo_boolean appended LAST on purpose: the per-family rng draws are
    # sequential, so earlier families keep their exact pre-existing sizes.
    families: Tuple[str, ...] = ("mixed", "knapsack", "set_cover", "pseudo_boolean"),
) -> List[Tuple[InstanceSpec, Problem]]:
    lo, hi = next((a, b) for nm, a, b in SIZE_SETS if nm == set_name)
    out = []
    # NOT hash(): str hashes are salted per process (PYTHONHASHSEED), which
    # silently made every benchmark run on a different instance draw.
    rng = np.random.default_rng(zlib.crc32(set_name.encode("utf-8")))
    for fam in families:
        for k in range(per_family):
            size = int(rng.integers(lo, hi))
            m = size
            n = max(10, int(size * rng.uniform(0.6, 1.2)))
            spec = InstanceSpec(family=fam, m=m, n=n, seed=1000 + k + lo)
            out.append((spec, make_instance(spec)))
    return out
