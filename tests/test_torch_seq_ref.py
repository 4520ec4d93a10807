"""The port's host oracles against the reference's: the sequential
Algorithm 1 (``propagate_sequential``), the exhaustive integer oracle
(``brute_force_solve``) and the presolve verdicts (``analyze_constraints``),
on seeded instances; then the port's ``solve()`` against its own
``brute_force_solve`` (the reference's differential suite, on the port).

Contract: the numpy copies are bitwise equal to the reference's; the solver
finds the brute-force optimum bitwise (integral data, exact sums).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as rc
import repro.data as rd
import repro_torch as rt

INSTANCES = [
    ("make_set_cover", dict(n=60, m=30, seed=3)),
    ("make_knapsack", dict(n=40, m=6, seed=5)),
    ("make_cascade_chain", dict(length=16)),
    ("make_pseudo_boolean", dict(n=120, m=160, seed=7)),
    ("make_random_mip", dict(n=30, m=40, seed=2)),
    ("make_mixed", dict(m=60, n=45, seed=21)),
    ("make_banded", dict(n=300, m=120, row_nnz=8, band=40, seed=1)),
]


def _ids():
    return [f"{g}-{kw.get('seed', 0)}" for g, kw in INSTANCES]


def _assert_seq_equal(got, want):
    np.testing.assert_array_equal(got.lb, want.lb)
    np.testing.assert_array_equal(got.ub, want.ub)
    assert got.lb.dtype == want.lb.dtype
    assert (got.rounds, got.converged, got.infeasible, got.n_bound_changes) == (
        want.rounds, want.converged, want.infeasible, want.n_bound_changes)


@pytest.mark.parametrize("use_marking", [True, False])
@pytest.mark.parametrize("gen,kw", INSTANCES, ids=_ids())
def test_propagate_sequential_matches_reference(gen, kw, use_marking):
    pr = getattr(rd, gen)(**kw)
    pt = rt.problem_from_reference(pr)
    want = rc.propagate_sequential(pr, use_marking=use_marking)
    got = rt.core.propagate_sequential(pt, use_marking=use_marking)
    assert isinstance(got, rt.core.SeqResult)
    _assert_seq_equal(got, want)


def test_propagate_sequential_float32_and_config_match_reference():
    pr = rd.make_mixed(m=60, n=45, seed=21)
    pt = rt.problem_from_reference(pr)
    _assert_seq_equal(rt.core.propagate_sequential(pt, dtype=np.float32),
                      rc.propagate_sequential(pr, dtype=np.float32))
    want = rc.propagate_sequential(pr, rc.PropagatorConfig(max_rounds=2))
    got = rt.core.propagate_sequential(pt, rt.core.PropagatorConfig(max_rounds=2))
    _assert_seq_equal(got, want)
    assert got.rounds == 2


def test_propagate_sequential_agrees_with_the_engines():
    """The paper's §4.3 check on the port: the sequential limit point is
    ``bounds_equal`` to the kernel engine's and the plain propagate's."""
    pt = rt.problem_from_reference(rd.make_mixed(m=90, n=70, seed=4))
    seq = rt.core.propagate_sequential(pt)
    assert seq.converged and not seq.infeasible
    for res in (rt.propagate_block_ell(pt, device="cpu"),
                rt.propagate_block_ell(pt, scatter="segment", device="cpu"),
                rt.propagate(pt, device="cpu")):
        assert rt.bounds_equal(seq.lb, seq.ub, res.lb, res.ub)


def _objective(n):
    """The solver tests' integral objective with mixed signs."""
    return np.arange(1, n + 1, dtype=np.float64) * np.where(np.arange(n) % 3 == 0, -1.0, 1.0)


BRUTE = [("make_pseudo_boolean", dict(n=12, m=16, seed=s)) for s in range(4)] + [
    ("make_random_mip", dict(n=9, m=12, seed=s)) for s in range(3)
]


@pytest.mark.parametrize("gen,kw", BRUTE, ids=[f"{g}-{kw['seed']}" for g, kw in BRUTE])
def test_brute_force_matches_reference(gen, kw):
    pr = getattr(rd, gen)(**kw)
    pt = rt.problem_from_reference(pr)
    c = _objective(pt.n)
    want = rc.brute_force_solve(pr, c)
    got = rt.core.brute_force_solve(pt, c)
    assert isinstance(got, rt.core.BruteForceResult)
    assert (got.objective, got.feasible, got.n_enumerated) == (
        want.objective, want.feasible, want.n_enumerated)
    if want.x is None:
        assert got.x is None
    else:
        np.testing.assert_array_equal(got.x, want.x)


def test_brute_force_refuses_what_the_reference_refuses():
    pt = rt.problem_from_reference(rd.make_mixed(m=6, n=5, seed=0))
    with pytest.raises(ValueError, match="pure-integer"):
        rt.core.brute_force_solve(pt, np.ones(pt.n))
    pb = rt.problem_from_reference(rd.make_pseudo_boolean(n=12, m=16, seed=0))
    with pytest.raises(ValueError, match="cap"):
        rt.core.brute_force_solve(pb, np.ones(pb.n), limit=100)
    wide = pb._replace(ub=np.full(pb.n, rc.INF))
    with pytest.raises(ValueError, match="finite"):
        rt.core.brute_force_solve(wide, np.ones(pb.n))


@pytest.mark.parametrize("gen,kw", BRUTE, ids=[f"{g}-{kw['seed']}" for g, kw in BRUTE])
def test_solve_finds_the_brute_force_optimum(gen, kw):
    """The reference's differential suite (test_solver.py) on the port:
    ``solve()`` on the CPU against the port's own exhaustive oracle."""
    p = getattr(rt.data, gen)(**kw)
    c = _objective(p.n)
    bf = rt.core.brute_force_solve(p, c)
    rule = rt.BranchRule.PSEUDO_COST if kw["seed"] % 2 else rt.BranchRule.MOST_FRACTIONAL
    res = rt.solve(p, c, rule=rule, node_cap=128, max_levels=48, sync_every=8, device="cpu")
    assert res.feasible == bf.feasible
    if bf.feasible:
        assert res.status == "optimal"
        assert res.objective == bf.objective  # bitwise: integral data
        assert float(c @ res.x) == bf.objective
    else:
        assert res.status == "infeasible" and res.x is None


def _verdicts_match(pr, pt):
    csr_r, csr_t = pr.csr, pt.csr
    want = rc.analyze_constraints(
        jnp.asarray(csr_r.row_ids()), jnp.asarray(csr_r.val), jnp.asarray(csr_r.col),
        jnp.asarray(pr.lhs), jnp.asarray(pr.rhs), jnp.asarray(pr.lb), jnp.asarray(pr.ub),
        pr.csr.m,
    )
    got = rt.core.analyze_constraints(
        torch.as_tensor(csr_t.row_ids()), torch.as_tensor(csr_t.val),
        torch.as_tensor(csr_t.col), torch.as_tensor(pt.lhs), torch.as_tensor(pt.rhs),
        torch.as_tensor(pt.lb), torch.as_tensor(pt.ub), pt.m, device="cpu",
    )
    assert isinstance(got, rt.core.PresolveVerdict)
    assert got._fields == want._fields
    for g, w in zip(got, want):
        assert isinstance(g, torch.Tensor) and g.dtype == torch.bool
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    return got


@pytest.mark.parametrize("gen,kw", INSTANCES, ids=_ids())
def test_analyze_constraints_matches_reference(gen, kw):
    pr = getattr(rd, gen)(**kw)
    _verdicts_match(pr, rt.problem_from_reference(pr))


def test_analyze_constraints_on_tightened_bounds_matches_reference():
    """At the fixed point rows turn redundant, and crossing a bound makes a
    row infeasible: both verdicts as the reference gives them."""
    pr = rd.make_knapsack(n=40, m=6, seed=5)
    pt = rt.problem_from_reference(pr)
    seq = rt.core.propagate_sequential(pt)
    tight_r = pr._replace(lb=seq.lb, ub=seq.ub)
    _verdicts_match(tight_r, rt.problem_from_reference(tight_r))
    crossed = pr._replace(lb=np.asarray(pr.ub) + 1.0)
    got = _verdicts_match(crossed, rt.problem_from_reference(crossed))
    assert bool(got.any_infeasible)


def test_analyze_constraints_takes_arrays_and_keeps_the_device():
    """Host arrays go to ``device``; tensors keep their own device, whatever
    ``device`` says."""
    pt = rt.problem_from_reference(rd.make_set_cover(n=60, m=30, seed=3))
    csr = pt.csr
    a = rt.core.analyze_constraints(csr.row_ids(), csr.val, csr.col, pt.lhs, pt.rhs, pt.lb,
                                    pt.ub, pt.m, device="cpu")
    b = rt.core.analyze_constraints(csr.row_ids(), csr.val, csr.col, pt.lhs, pt.rhs,
                                    torch.as_tensor(pt.lb), torch.as_tensor(pt.ub), pt.m)
    for x, y in zip(a, b):
        assert x.device.type == "cpu" and y.device.type == "cpu" and torch.equal(x, y)
