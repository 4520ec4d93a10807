"""The port's host layer (``repro_torch.core.sparse``: ``permute_problem``,
``block_ell_stats``, the CSR / CSC conversions) against the reference's,
and CPU twins of the reference's property tests (``tests/test_properties.py``
and ``tests/test_sparse_roundtrip.py``), held on the port's plain round
(``propagate``) and its fused engine (``propagate_block_ell``):

  * parallel == sequential limit point;
  * monotonicity: propagation only tightens domains;
  * idempotence: the fixed point is stable under one more round;
  * row-scaling invariance (by 2^k, exact in floating point);
  * ordering invariance: row / column permutations permute the limit point;
  * the CSR / CSC / COO round trips.

Hypothesis runs few examples here (``SETTINGS``), each on both engines.
"""
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import repro.core as rc
import repro.data as rd
import repro_torch as rt
from repro_torch.core import (
    INF,
    Problem,
    block_ell_stats,
    csr_from_coo,
    csr_from_dense,
    csr_to_block_ell,
    csr_to_csc,
    permute_problem,
    propagate_sequential,
)
from repro_torch.data import make_mixed, make_pseudo_boolean

SETTINGS = dict(max_examples=6, deadline=None)
ENGINES = ("propagate", "fused")


def _run(engine, p):
    if engine == "propagate":
        return rt.propagate(p, driver="device_loop", device="cpu")
    return rt.propagate_block_ell(p, scatter="fused", tile_width=8, device="cpu")


def _np(x):
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


@st.composite
def problems(draw):
    """The reference's strategy (tests/test_properties.py:31), built with the
    port's host layer."""
    m = draw(st.integers(2, 18))
    n = draw(st.integers(2, 14))
    density = draw(st.floats(0.2, 0.7))
    seed = draw(st.integers(0, 2**31 - 1))
    rng = np.random.default_rng(seed)
    nnz_mask = rng.random((m, n)) < density
    for i in range(m):
        if not nnz_mask[i].any():
            nnz_mask[i, rng.integers(0, n)] = True
    rows, cols = np.nonzero(nnz_mask)
    vals = rng.choice([-3.0, -2.0, -1.0, 1.0, 2.0, 3.0], size=rows.size)
    csr = csr_from_coo(rows.astype(np.int32), cols.astype(np.int32), vals, m, n)
    ub = rng.integers(1, 8, size=n).astype(np.float64)
    lb = -rng.integers(0, 3, size=n).astype(np.float64)
    lb[rng.random(n) < 0.15] = -INF
    ub[rng.random(n) < 0.15] = INF
    is_int = rng.random(n) < 0.5
    row_abs = np.zeros(m)
    np.add.at(row_abs, rows, np.abs(vals) * 2.0)
    lhs = np.where(rng.random(m) < 0.4, -INF, -row_abs * rng.uniform(0.1, 0.5, m))
    rhs = np.where(rng.random(m) < 0.2, INF, row_abs * rng.uniform(0.1, 0.5, m))
    swap = lhs > rhs
    lhs[swap], rhs[swap] = rhs[swap], lhs[swap]
    return Problem(csr=csr, lhs=lhs, rhs=rhs, lb=lb, ub=ub, is_int=is_int)


# ---------------------------------------------------------------------------
# permute_problem and block_ell_stats against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_permute_problem_matches_reference(seed):
    pr = rd.make_mixed(m=40, n=30, seed=seed)
    rng = np.random.default_rng(seed)
    rp, cp = rng.permutation(pr.m), rng.permutation(pr.n)
    got = permute_problem(rt.problem_from_reference(pr), rp, cp)
    want = rc.permute_problem(pr, rp, cp)
    for f in ("row_ptr", "col", "val"):
        np.testing.assert_array_equal(getattr(got.csr, f), np.asarray(getattr(want.csr, f)))
    assert int(got.csr.n_cols) == int(want.csr.n_cols)
    for f in ("lhs", "rhs", "lb", "ub", "is_int"):
        np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(want, f)))


@pytest.mark.parametrize("tile", [(8, 128), (4, 8), (2, 3)])
def test_block_ell_stats_match_reference(tile):
    pr = rd.make_mixed(m=60, n=45, seed=21)
    tr, tw = tile
    got = block_ell_stats(csr_to_block_ell(rt.problem_from_reference(pr).csr, tr, tw))
    want = rc.block_ell_stats(rc.csr_to_block_ell(pr.csr, tr, tw))
    assert got == want


# ---------------------------------------------------------------------------
# Property twins (tests/test_properties.py)
# ---------------------------------------------------------------------------


@given(problems())
@settings(**SETTINGS)
def test_parallel_equals_sequential_limit_point(p):
    a = propagate_sequential(p)
    for engine in ENGINES:
        b = _run(engine, p)
        if a.infeasible or bool(b.infeasible):
            continue  # verdicts may be reached at different rounds
        if not (a.converged and bool(b.converged)):
            continue  # round cap: excluded from the comparison (paper §4.1)
        assert rt.bounds_equal(a.lb, a.ub, b.lb, b.ub), engine


@given(problems())
@settings(**SETTINGS)
def test_monotonicity(p):
    for engine in ENGINES:
        r = _run(engine, p)
        assert np.all(_np(r.lb) >= p.lb - 1e-12), engine
        assert np.all(_np(r.ub) <= p.ub + 1e-12), engine


@given(problems())
@settings(**SETTINGS)
def test_fixed_point_idempotent(p):
    for engine in ENGINES:
        r = _run(engine, p)
        if bool(r.infeasible) or not bool(r.converged):
            continue
        r2 = _run(engine, p._replace(lb=_np(r.lb), ub=_np(r.ub)))
        assert int(r2.rounds) <= 1, engine  # the confirming round finds nothing
        assert rt.bounds_equal(r.lb, r.ub, r2.lb, r2.ub), engine


@given(problems(), st.integers(-2, 4))
@settings(**SETTINGS)
def test_row_scaling_invariance(p, k):
    scale = float(2.0**k)
    csr2 = p.csr._replace(val=p.csr.val * scale)
    lhs2 = np.where(np.abs(p.lhs) >= INF, p.lhs, p.lhs * scale)
    rhs2 = np.where(np.abs(p.rhs) >= INF, p.rhs, p.rhs * scale)
    p2 = p._replace(csr=csr2, lhs=lhs2, rhs=rhs2)
    for engine in ENGINES:
        a, b = _run(engine, p), _run(engine, p2)
        if bool(a.infeasible) or bool(b.infeasible):
            continue
        assert rt.bounds_equal(a.lb, a.ub, b.lb, b.ub), engine


@given(st.integers(0, 10_000))
@settings(max_examples=4, deadline=None)
def test_permutation_invariance(seed):
    p = make_mixed(m=40, n=30, seed=seed % 100)
    rng = np.random.default_rng(seed)
    rp, cp = rng.permutation(p.m), rng.permutation(p.n)
    p2 = permute_problem(p, rp, cp)
    for engine in ENGINES:
        a, b = _run(engine, p), _run(engine, p2)
        if bool(a.infeasible) or bool(b.infeasible):
            continue
        if not (bool(a.converged) and bool(b.converged)):
            continue
        assert rt.bounds_equal(_np(a.lb)[cp], _np(a.ub)[cp], b.lb, b.ub), engine


# ---------------------------------------------------------------------------
# Round-trip twins (tests/test_sparse_roundtrip.py)
# ---------------------------------------------------------------------------


def _random_problem(seed):
    """The reference's ``_random_problem`` (tests/test_sparse_roundtrip.py:27)."""
    rng = np.random.default_rng(seed)
    m = int(rng.integers(3, 25))
    n = int(rng.integers(3, 20))
    density = float(rng.uniform(0.15, 0.6))
    mask = rng.random((m, n)) < density
    for i in range(m):
        if not mask[i].any():
            mask[i, rng.integers(0, n)] = True
    a = np.where(mask, rng.choice([-3.0, -2.0, -1.0, 1.0, 2.0], size=(m, n)), 0.0)
    csr = csr_from_dense(a)
    ub = rng.integers(1, 6, size=n).astype(np.float64)
    lb = -rng.integers(0, 3, size=n).astype(np.float64)
    lb[rng.random(n) < 0.15] = -INF
    ub[rng.random(n) < 0.15] = INF
    row_abs = np.abs(a).sum(axis=1)
    lhs = np.where(rng.random(m) < 0.4, -INF, -row_abs * rng.uniform(0.1, 0.5, m))
    rhs = np.where(rng.random(m) < 0.2, INF, row_abs * rng.uniform(0.1, 0.5, m))
    swap = lhs > rhs
    lhs[swap], rhs[swap] = rhs[swap], lhs[swap]
    return Problem(csr=csr, lhs=lhs, rhs=rhs, lb=lb, ub=ub, is_int=rng.random(n) < 0.5)


def _csc_to_dense(csc) -> np.ndarray:
    m, n = int(csc.n_rows), int(csc.col_ptr.shape[0]) - 1
    a = np.zeros((m, n), dtype=csc.val.dtype)
    for j in range(n):
        s, e = int(csc.col_ptr[j]), int(csc.col_ptr[j + 1])
        a[csc.row[s:e], j] = csc.val[s:e]
    return a


@pytest.mark.parametrize("seed", range(4))
def test_csr_to_csc_same_dense_matrix(seed):
    p = _random_problem(seed)
    np.testing.assert_array_equal(_csc_to_dense(csr_to_csc(p.csr)), p.csr.to_dense())


def test_csr_to_csc_handles_empty_rows_and_cols():
    a = np.array([[1.0, 0.0, 0.0, -2.0],
                  [0.0, 0.0, 0.0, 0.0],
                  [0.0, 3.0, 0.0, 0.5]])
    csc = csr_to_csc(csr_from_dense(a))
    np.testing.assert_array_equal(_csc_to_dense(csc), a)
    assert int(csc.col_ptr[2]) == int(csc.col_ptr[3])  # the empty column's window


def test_csr_to_csc_column_major_invariants():
    p = make_mixed(m=60, n=45, seed=9)
    csc = csr_to_csc(p.csr)
    assert csc.val.shape == p.csr.val.shape
    cols_of = np.repeat(np.arange(p.n), np.diff(csc.col_ptr))
    assert (np.diff(cols_of) >= 0).all()
    for j in range(p.n):
        s, e = int(csc.col_ptr[j]), int(csc.col_ptr[j + 1])
        assert (np.diff(csc.row[s:e]) > 0).all()


def test_coo_csr_csc_round_trip():
    rng = np.random.default_rng(42)
    m, n, nnz = 15, 12, 40
    cells = rng.choice(m * n, size=nnz, replace=False)
    rows, cols = (cells // n).astype(np.int32), (cells % n).astype(np.int32)
    vals = rng.uniform(-4, 4, size=nnz)
    csr = csr_from_coo(rows, cols, vals, m, n)
    dense = np.zeros((m, n))
    dense[rows, cols] = vals
    np.testing.assert_array_equal(csr.to_dense(), dense)
    np.testing.assert_array_equal(_csc_to_dense(csr_to_csc(csr)), dense)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("seed", range(3))
def test_permuted_problem_propagates_to_permuted_bounds(seed, engine):
    p = _random_problem(100 + seed)
    rng = np.random.default_rng(seed)
    row_perm, col_perm = rng.permutation(p.m), rng.permutation(p.n)
    q = permute_problem(p, row_perm, col_perm)
    np.testing.assert_array_equal(q.csr.to_dense(),
                                  p.csr.to_dense()[np.ix_(row_perm, col_perm)])
    rp, rq = _run(engine, p), _run(engine, q)
    assert bool(rq.infeasible) == bool(rp.infeasible)
    if not bool(rp.infeasible):
        assert rt.bounds_equal(rq.lb, rq.ub, _np(rp.lb)[col_perm], _np(rp.ub)[col_perm])


def test_permutation_identity_is_noop():
    p = make_pseudo_boolean(n=40, m=30, seed=5)
    q = permute_problem(p, np.arange(p.m), np.arange(p.n))
    np.testing.assert_array_equal(q.csr.to_dense(), p.csr.to_dense())
    np.testing.assert_array_equal(q.lb, p.lb)
    np.testing.assert_array_equal(q.lhs, p.lhs)
