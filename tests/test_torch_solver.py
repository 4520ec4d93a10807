"""The port's device-resident branch-and-bound (``repro_torch.solve``, on the
CPU) against the reference's ``repro.core.solve``.

Contract (the solver's integral-data exactness contract): on pure-integer
instances with integral data every sum is exact, so status, objective,
solution, every node count, levels, host syncs and the incumbent trajectory
must be identical, for both branching rules.
"""
import dataclasses
import math

import numpy as np
import pytest

import repro.core as rc
import repro.data as rd
import repro_torch as rt
from repro_torch.core import solver as tsolver

FIELDS = ("status", "objective", "feasible", "nodes_expanded", "nodes_created", "leaves",
          "pruned_bound", "pruned_infeasible", "levels", "host_syncs",
          "incumbent_trajectory")
RULES = ["most_fractional", "pseudo_cost"]


def _objective(n):
    """The reference tests' objective: integral, mixed signs."""
    sign = np.where(np.arange(n) % 3 == 0, -1.0, 1.0)
    return np.arange(1, n + 1, dtype=np.float64) * sign


def _solve_both(pr, rule="most_fractional", **kw):
    c = _objective(pr.lb.shape[0])
    r_calls, t_calls = [], []
    want = rc.solve(pr, c, rule=rc.BranchRule(rule), use_pallas=False,
                    on_sync=r_calls.append, **kw)
    got = rt.solve(rt.problem_from_reference(pr), c, rule=rt.BranchRule(rule),
                   device="cpu", on_sync=t_calls.append, **kw)
    return got, want, t_calls, r_calls


def _assert_same(got, want):
    for f in FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    if want.x is None:
        assert got.x is None
    else:
        np.testing.assert_array_equal(got.x, want.x)


# The small instances whose reference results the chip smoke also holds.
INSTANCES = [
    ("make_pseudo_boolean", dict(n=12, m=16, seed=0)),   # optimal -2
    ("make_random_mip", dict(n=9, m=12, seed=1)),        # optimal 10
    ("make_random_mip", dict(n=9, m=12, seed=0)),        # infeasible at the root
    ("make_pseudo_boolean", dict(n=40, m=56, seed=7)),   # pool exhausted
]


@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("gen,kw", INSTANCES, ids=lambda v: str(v.get("seed", v))
                         if isinstance(v, dict) else v)
def test_solve_matches_reference(gen, kw, rule):
    got, want, t_calls, r_calls = _solve_both(getattr(rd, gen)(**kw), rule)
    _assert_same(got, want)
    assert t_calls == r_calls


@pytest.mark.parametrize("seed", [1, 2, 5, 6])
def test_solve_matches_reference_on_pseudo_boolean_seeds(seed):
    rule = RULES[seed % 2]
    got, want, _, _ = _solve_both(rd.make_pseudo_boolean(n=12, m=16, seed=seed), rule,
                                  node_cap=64, max_levels=32, sync_every=8)
    _assert_same(got, want)


@pytest.mark.parametrize("seed", [2, 3])
def test_solve_matches_reference_on_random_mip_seeds(seed):
    got, want, _, _ = _solve_both(rd.make_random_mip(n=9, m=12, seed=seed),
                                  node_cap=128, max_levels=48, sync_every=8)
    _assert_same(got, want)


@pytest.mark.parametrize("sync_every", [2, 3])
def test_sync_contract_matches_reference(sync_every):
    """Every outer sync reports the same progress dict as the reference's, at
    most ceil(levels / sync_every) of them; the per-round flag reads are
    counted apart, at least one per level and one per round."""
    pr = rd.make_pseudo_boolean(n=12, m=16, seed=0)
    c = _objective(pr.lb.shape[0])
    flags = []
    got = rt.solve(rt.problem_from_reference(pr), c, node_cap=64, max_levels=32,
                   sync_every=sync_every, device="cpu", on_flag_read=lambda: flags.append(1))
    want = rc.solve(pr, c, node_cap=64, max_levels=32, sync_every=sync_every,
                    use_pallas=False)
    _assert_same(got, want)
    assert got.host_syncs <= max(1, math.ceil(got.levels / sync_every))
    assert len(flags) >= 2 * got.levels


@pytest.mark.parametrize("width", [1, 2])
def test_expand_width_matches_reference(width):
    got, want, _, _ = _solve_both(rd.make_pseudo_boolean(n=12, m=16, seed=0),
                                  "pseudo_cost", node_cap=16, max_levels=64,
                                  expand_width=width)
    _assert_same(got, want)


def test_kernel_and_plain_paths_give_the_same_search():
    p = rt.problem_from_reference(rd.make_pseudo_boolean(n=40, m=56, seed=3))
    c = _objective(p.n)
    a = rt.solve(p, c, node_cap=64, max_levels=12, device="cpu")
    b = rt.solve(p, c, node_cap=64, max_levels=12, device="cpu", use_kernels=False)
    for f in FIELDS:
        assert getattr(a, f) == getattr(b, f), f
    for x, y in zip(a.carry, b.carry):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_result_fields_match_reference():
    port = [f.name for f in dataclasses.fields(tsolver.SolveResult)]
    ref = [f.name for f in dataclasses.fields(rc.SolveResult)]
    assert port == ref + ["carry"]
    assert [r.value for r in tsolver.BranchRule] == [r.value for r in rc.BranchRule]
    assert list(tsolver.SearchCarry._fields) == [
        f for f in rc.SearchCarry._fields if f != "plane"
    ]
    assert (tsolver.FREE, tsolver.OPEN, tsolver.READY) == (rc.solver.FREE, rc.solver.OPEN,
                                                           rc.solver.READY)


def test_solve_rejects_bad_input():
    p = rt.problem_from_reference(rd.make_pseudo_boolean(n=12, m=16, seed=0))
    c = _objective(p.n)
    # telemetry= (item 6) is ported: it runs and records one sample a level.
    res = rt.solve(p, c, telemetry=8, device="cpu")
    assert res.telemetry.rounds_recorded == res.levels
    with pytest.raises(ValueError, match="objective"):
        rt.solve(p, c[:-1], device="cpu")
    with pytest.raises(ValueError, match="node_cap"):
        rt.solve(p, c, node_cap=1, device="cpu")
    mixed = p._replace(is_int=np.zeros(p.n, bool))
    with pytest.raises(ValueError, match="pure-integer"):
        rt.solve(mixed, c, device="cpu")


@pytest.mark.parametrize("tile_width", [2, 4])
def test_multi_chunk_search_matches_reference(tile_width):
    """Rows longer than the tile width take the multi-chunk node round (A',
    combine, E and F per pool slot); the search is the reference's, and on
    integral data the same as where every row fits one chunk, pool included."""
    pr = rd.make_pseudo_boolean(n=12, m=16, seed=0)
    got, want, _, _ = _solve_both(pr, tile_width=tile_width)
    _assert_same(got, want)
    one, _, _, _ = _solve_both(pr, tile_width=8)
    for x, y in zip(got.carry, one.carry):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("seed", [1, 2])
def test_tile_width_4_search_matches_reference_counts(seed, rule):
    """solve(tile_width=4): every row of the pseudo-boolean family spans two
    chunks, so each round runs A', the combine and E over the whole pool
    (free and finished slots masked on the device); status, objective, node
    counts, levels, syncs and trajectory are the reference's."""
    pr = rd.make_pseudo_boolean(n=20, m=28, seed=seed)
    got, want, t_calls, r_calls = _solve_both(pr, rule, tile_width=4, node_cap=64)
    _assert_same(got, want)
    assert len(t_calls) == len(r_calls)
