"""The port's plain-PyTorch round and loop drivers (``repro_torch.propagate``)
against the reference's pure-jnp ``repro.core.propagate``.

Contract: exact-arithmetic families match bitwise (as values); general-float
families (``make_mixed``, ``make_banded``) pass ``bounds_equal`` and
``allclose(rtol=1e-12, atol=1e-12)`` because row sums are taken in another
order; ``rounds``, ``converged`` and ``infeasible`` match exactly everywhere.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as rc
import repro.data as rd
import repro_torch as rt
from repro.core import activities as ract
from repro.core import bounds as rbnd
from repro_torch.core import activities as tact
from repro_torch.core import bounds as tbnd

EXACT_CASES = [
    ("make_cascade_chain", dict(length=24)),
    ("make_pseudo_boolean", dict(n=300, m=400, seed=7)),   # infeasible in 10 rounds
    ("make_pseudo_boolean", dict(n=300, m=400, seed=4)),   # feasible
    ("make_set_cover", dict(n=80, m=40, seed=2)),
    ("make_knapsack", dict(n=60, m=12, seed=1)),
]
FLOAT_CASES = [
    ("make_mixed", dict(m=80, n=60, seed=1)),
    ("make_banded", dict(n=500, m=300, row_nnz=10, band=60, seed=6)),  # 29 rounds
]


def case_id(case):
    gen, kw = case
    return f"{gen}-{kw.get('seed', 0)}"


def assert_results_match(got, want, exact):
    assert int(got.rounds) == int(want.rounds)
    assert bool(got.converged) == bool(want.converged)
    assert bool(got.infeasible) == bool(want.infeasible)
    g_lb, g_ub = got.lb.cpu().numpy(), got.ub.cpu().numpy()
    w_lb, w_ub = np.asarray(want.lb), np.asarray(want.ub)
    if exact:
        np.testing.assert_array_equal(g_lb, w_lb)
        np.testing.assert_array_equal(g_ub, w_ub)
    else:
        assert rt.bounds_equal(g_lb, g_ub, w_lb, w_ub)
        np.testing.assert_allclose(g_lb, w_lb, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(g_ub, w_ub, rtol=1e-12, atol=1e-12)
    # Both host loops report NaN progress (no early stop is armed); every
    # other driver reports the last round's measure.
    np.testing.assert_allclose(
        float(got.progress), float(want.progress), rtol=1e-12, equal_nan=True
    )


@pytest.mark.parametrize("driver", ["host_loop", "device_loop"])
@pytest.mark.parametrize(
    "case,exact",
    [(c, True) for c in EXACT_CASES] + [(c, False) for c in FLOAT_CASES],
    ids=[case_id(c) for c in EXACT_CASES + FLOAT_CASES],
)
def test_propagate_matches_reference(case, exact, driver):
    gen, kw = case
    pr = getattr(rd, gen)(**kw)
    want = rc.propagate(pr, driver=driver)
    syncs = []
    got = rt.propagate(
        rt.problem_from_reference(pr), driver=driver, device="cpu",
        on_sync=lambda: syncs.append(1),
    )
    assert_results_match(got, want, exact)
    rounds = int(got.rounds)
    # The host loop reads a flag per round; the device loop reads its carry
    # once per UNGATED_LOOP_GROUP rounds (the plain round is not gated).
    group = rt.core.propagator.UNGATED_LOOP_GROUP
    assert len(syncs) == (rounds if driver == "host_loop" else -(-rounds // group))


def test_propagate_round_cap():
    pr = rd.make_cascade_chain(length=24)
    cfg_r = rc.PropagatorConfig(max_rounds=5)
    cfg_t = rt.core.PropagatorConfig(max_rounds=5)
    want = rc.propagate(pr, cfg_r)
    got = rt.propagate(rt.problem_from_reference(pr), cfg_t, device="cpu")
    assert int(got.rounds) == 5 and not bool(got.converged)
    assert_results_match(got, want, exact=True)


@pytest.mark.parametrize("gen,kw,fix", [
    ("make_set_cover", dict(n=80, m=40, seed=2), "ub"),   # x_j = 0 forces covers
    ("make_knapsack", dict(n=60, m=12, seed=1), "lb"),    # x_j = 1 fills capacity
])
def test_propagate_warm_start(gen, kw, fix):
    pr = getattr(rd, gen)(**kw)
    rng = np.random.default_rng(0)
    lb0, ub0 = np.array(pr.lb), np.array(pr.ub)
    picks = rng.choice(pr.n, size=pr.n // 3, replace=False)
    (ub0 if fix == "ub" else lb0)[picks] = 0.0 if fix == "ub" else 1.0
    want = rc.propagate(pr, lb0=lb0, ub0=ub0)
    got = rt.propagate(rt.problem_from_reference(pr), lb0=lb0, ub0=ub0, device="cpu")
    assert int(want.rounds) > 1
    assert_results_match(got, want, exact=True)


def _t(x):
    return torch.from_numpy(np.array(x))


def test_round_building_blocks_match_reference(rng):
    """Activities, residuals, candidates, rounding, merge helpers and the
    progress measure, elementwise against the reference."""
    p = rd.make_mixed(m=30, n=20, seed=5)
    rid, col, val = p.csr.row_ids(), p.csr.col, p.csr.val
    lb, ub = np.array(p.lb), np.array(p.ub)
    want = ract.compute_activities(jnp.asarray(rid), jnp.asarray(val), jnp.asarray(col),
                                   jnp.asarray(lb), jnp.asarray(ub), p.m)
    got = tact.compute_activities(_t(rid).long(), _t(val), _t(col).long(), _t(lb), _t(ub), p.m)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(tact.activity_values(got), ract.activity_values(want)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    n = 64
    a = rng.choice([-2.0, 0.0, 1.0, 3.0], size=n)
    lhs, rhs = rng.uniform(-9, 0, n), rng.uniform(0, 9, n)
    rhs[rng.random(n) < 0.2] = rc.INF
    mres, xres = rng.uniform(-5, 5, n), rng.uniform(-5, 5, n)
    mres[rng.random(n) < 0.2] = -rc.INF
    ii = rng.random(n) < 0.5
    wc = rbnd.round_candidates(*rbnd.bound_candidates(*map(jnp.asarray, (a, lhs, rhs, mres, xres))),
                               jnp.asarray(ii), 1e-6)
    gc = tbnd.round_candidates(*tbnd.bound_candidates(*map(_t, (a, lhs, rhs, mres, xres))),
                               _t(ii), 1e-6)
    for g, w in zip(gc, wc):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    fin, inf_c = rng.uniform(-3, 3, n), (rng.random(n) < 0.3).astype(np.int32)
    rfin, rcnt = rng.uniform(-9, 9, n), rng.integers(0, 3, n).astype(np.int32)
    for side in ("min", "max"):
        w = ract.residual_activities(*map(jnp.asarray, (a, fin, inf_c, rfin, rcnt)), side)
        g = tact.residual_activities(*map(_t, (a, fin, inf_c, rfin, rcnt)), side)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    lo, hi = rng.uniform(-5, 0, n), rng.uniform(0, 5, n)
    lo2, hi2 = lo + rng.uniform(0, 1, n), hi - rng.uniform(0, 1, n)
    lo[0], hi[1] = -1.00000002e20, 1.00000002e20
    np.testing.assert_allclose(
        float(tbnd.progress_measure(*map(_t, (lo, hi, lo2, hi2)))),
        float(rbnd.progress_measure(*map(jnp.asarray, (lo, hi, lo2, hi2)))),
        rtol=1e-12,
    )
    for fn in ("canonical_infinite",):
        for g, w in zip(getattr(tbnd, fn)(_t(lo), _t(hi)),
                        getattr(rbnd, fn)(jnp.asarray(lo), jnp.asarray(hi))):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(tbnd.widen_outward(_t(lo2), _t(hi2), 2.0**-17),
                    rbnd.widen_outward(jnp.asarray(lo2), jnp.asarray(hi2), 2.0**-17)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_bounds_equal_matches_reference(rng):
    a = rng.uniform(-5, 5, 50)
    b = a * (1 + 1e-7)
    c = a + 1e-3
    inf = np.full(3, rc.INF)
    for x, y in ((a, b), (a, c), (inf, inf * 2), (-inf, -inf * 3)):
        assert rt.bounds_equal(x, x, y, y) == rc.bounds_equal(x, x, y, y)


def test_config_and_types_match_reference():
    ref = dataclasses.asdict(rc.DEFAULT_CONFIG)
    port = dataclasses.asdict(rt.core.DEFAULT_CONFIG)
    assert ref == port
    assert rt.core.INF == rc.INF
    assert rt.core.int_round_slack(torch.float32) == rc.int_round_slack(jnp.float32)
    assert rt.core.int_round_slack(torch.float64) == rc.int_round_slack(jnp.float64)
    assert list(rt.core.PropagationResult._fields) == [
        f for f in rc.PropagationResult._fields if f != "telemetry"
    ]


@pytest.mark.parametrize("kw", [
    dict(dtype=torch.float32), dict(dtype=np.float32), dict(policy=rt.core.TierPolicy()),
    dict(telemetry=8),
])
def test_requests_outside_the_slice_raise(kw):
    """Telemetry (item 6) raises.  float32 and the two-tier policy (item 5,
    ported since) run and give the reference's result: rounds, flags,
    ``tier_rounds`` and bounds."""
    pr = rd.make_set_cover(n=20, m=8, seed=0)
    p = rt.problem_from_reference(pr)
    if "telemetry" in kw:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            rt.propagate(p, device="cpu", **kw)
        return
    got = rt.propagate(p, device="cpu", **kw)
    want = rc.propagate(pr, **({"policy": rc.TierPolicy()} if "policy" in kw
                               else {"dtype": np.float32}))
    for f in ("rounds", "converged", "infeasible", "tier_rounds"):
        assert int(getattr(got, f)) == int(getattr(want, f))
    assert got.lb.dtype == (torch.float64 if "policy" in kw else torch.float32)
    np.testing.assert_array_equal(got.lb.double().numpy(), np.asarray(want.lb, np.float64))
    np.testing.assert_array_equal(got.ub.double().numpy(), np.asarray(want.ub, np.float64))
