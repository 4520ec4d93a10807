"""The port's partitioned engine (``scatter="partitioned"`` and the ``auto``
rule past ``SCATTER_MAX_NPAD``) against the reference's, on the CPU: single
instances on the cases of the reference's own partitioned tests, the engine
choice on both sides of the limit, an explicit ``fused`` past 2^16 columns,
and -- with ``SCATTER_MAX_NPAD`` and ``SLAB_NPAD`` shrunk to 128 in both
packages -- node batches and ``solve`` through the partitioned node round.

Contract: ``rounds``, ``converged`` and ``infeasible`` exact everywhere;
bounds bitwise (as values) on integer-valued data; on general floats
``bounds_equal`` and ``rtol=1e-12, atol=1e-12`` (the reference's own
cross-engine tolerance: the two packages sum in different orders).  Each
node of a batch is bitwise equal to its own single-instance run of the
port; ``solve`` is identical to the reference's (status, objective, ``x``,
node counts, levels, host syncs, incumbent trajectory).
"""
import numpy as np
import pytest
import torch

import repro.core as rc
import repro.data as rd
from repro.kernels import ops as rops
import repro_torch as rt
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels import ops as tops


def _assert_same(got, want, exact):
    for f in ("rounds", "converged", "infeasible"):
        assert int(getattr(got, f)) == int(np.asarray(getattr(want, f))), f
    assert rt.bounds_equal(got.lb, got.ub, np.asarray(want.lb), np.asarray(want.ub))
    for g, w in ((got.lb, want.lb), (got.ub, want.ub)):
        if exact:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12, atol=1e-12)


def _run_both(pr, ref_kw=None, **kw):
    want = rops.propagate_block_ell(pr, **{"use_pallas": False, **(ref_kw or {})}, **kw)
    got = rt.propagate_block_ell(rt.problem_from_reference(pr), device="cpu", **kw)
    return got, want


# The single-instance cases of the reference's partitioned engine tests:
# (generator, kwargs, tile, integer data).
SINGLE = {
    **{f"mixed_{s}": ("make_mixed", dict(m=35, n=300, seed=s), (4, 32), False)
       for s in range(4)},
    # Rows far longer than the tile width: slab copies and chunk splits
    # complete through the same straddle table.
    "knapsack_spans_chunks": ("make_knapsack", dict(n=280, m=8, seed=5), (2, 8), True),
    "set_cover": ("make_set_cover", dict(n=270, m=25, seed=6), (4, 32), True),
}


@pytest.mark.parametrize("use_kernels", [True, False], ids=["kernels", "plain"])
@pytest.mark.parametrize("name", list(SINGLE))
def test_partitioned_engine_matches_reference(name, use_kernels):
    gen, kw, tile, exact = SINGLE[name]
    pr = getattr(rd, gen)(**kw)
    got, want = _run_both(pr, tile_rows=tile[0], tile_width=tile[1], scatter="partitioned",
                          slab=128)
    _assert_same(got, want, exact)
    if not use_kernels:
        plain = rt.propagate_block_ell(rt.problem_from_reference(pr), tile_rows=tile[0],
                                       tile_width=tile[1], scatter="partitioned", slab=128,
                                       use_kernels=False, device="cpu")
        # The plain-version path sums in the kernels' order: bitwise.
        np.testing.assert_array_equal(plain.lb.numpy(), got.lb.numpy())
        np.testing.assert_array_equal(plain.ub.numpy(), got.ub.numpy())
        assert int(plain.rounds) == int(got.rounds)


def test_partitioned_engine_matches_reference_pallas_path():
    """Against the reference's Pallas kernels (interpret mode) as well."""
    pr = rd.make_knapsack(n=280, m=8, seed=5)
    got, want = _run_both(pr, ref_kw=dict(use_pallas=True), tile_rows=2, tile_width=8,
                          scatter="partitioned", slab=128, driver="host_loop")
    _assert_same(got, want, True)


def test_auto_selects_engine_on_both_sides_of_the_limit():
    small = rt.prepare_block_ell(rt.problem_from_reference(rd.make_mixed(m=10, n=50, seed=0)),
                                 4, 16, device="cpu")
    assert small.n_pad <= tops.SCATTER_MAX_NPAD
    assert tops._resolve_scatter("auto", small) == "fused"
    big = rd.make_banded(n=tops.SCATTER_MAX_NPAD + 200, m=48, row_nnz=6, band=512, seed=0)
    prep = rt.prepare_block_ell(rt.problem_from_reference(big), 8, 8, device="cpu")
    assert prep.n_pad > tops.SCATTER_MAX_NPAD
    assert tops._resolve_scatter("auto", prep) == "partitioned"
    assert rops._resolve_scatter("auto", rops.prepare_block_ell(big, 8, 8)) == "partitioned"
    for mode in ("fused", "segment", "partitioned"):
        assert tops._resolve_scatter(mode, prep) == mode
    with pytest.raises(ValueError):
        tops._resolve_scatter("bogus", prep)


def test_instance_past_the_limit_rides_partitioned_auto():
    """A real n_pad > 2^16 instance under ``scatter="auto"`` takes the
    partitioned kernels and agrees with the reference's auto run (integer
    coefficients and bounds, but fractional sides: general floats after
    the first round)."""
    pr = rd.make_banded(n=tops.SCATTER_MAX_NPAD + 4000, m=56, row_nnz=6, band=512, seed=2)
    reset_launch_counts()
    got, want = _run_both(pr, tile_rows=8, tile_width=8)
    # The CPU runs the kernels' plain versions: nothing is launched.
    assert set(launch_counts().values()) == {0}
    assert rt.prepare_block_ell(rt.problem_from_reference(pr), 8, 8,
                                device="cpu").slab_partition().n_slabs == 2
    _assert_same(got, want, False)


def test_explicit_fused_runs_past_the_limit():
    """``scatter="fused"`` is not refused past ``SCATTER_MAX_NPAD``: kernel
    D + F at n_pad = 65,792, as the reference's explicit fused.  The sides
    of this family are fractional, so the two packages' sums (each in its
    own order) may differ in the last bit: general-float tolerance."""
    pr = rd.make_banded(n=tops.SCATTER_MAX_NPAD + 200, m=48, row_nnz=6, band=512, seed=0)
    got, want = _run_both(pr, scatter="fused")
    assert rt.prepare_block_ell(rt.problem_from_reference(pr),
                                device="cpu").n_pad > tops.SCATTER_MAX_NPAD
    _assert_same(got, want, False)
    auto = rt.propagate_block_ell(rt.problem_from_reference(pr), device="cpu")
    _assert_same(auto, want, False)


# ---------------------------------------------------------------------------
# Node batches and solve across the limit (shrunken limits keep them small)
# ---------------------------------------------------------------------------


@pytest.fixture
def tiny_budget(monkeypatch):
    """Shrink the engine limit and the slab cap to 128 in both packages, so
    small instances cross the limit and ride the partitioned engines."""
    rops.clear_prepare_cache()
    tops.clear_prepare_cache()
    monkeypatch.setattr(rops, "SCATTER_MAX_NPAD", 128)
    monkeypatch.setattr(rops, "SLAB_NPAD", 128)
    monkeypatch.setattr(tops, "SCATTER_MAX_NPAD", 128)
    monkeypatch.setattr(tops, "SLAB_NPAD", 128)
    yield
    rops.clear_prepare_cache()
    tops.clear_prepare_cache()


def _nodes_of(root):
    """The reference test's three nodes: the root, one branched up and one
    branched down."""
    lb0, ub0 = np.asarray(root.lb), np.asarray(root.ub)
    nodes_lb = np.stack([lb0, lb0.copy(), lb0.copy()])
    nodes_ub = np.stack([ub0, ub0.copy(), ub0.copy()])
    free = np.flatnonzero(root.is_int & (lb0 < ub0))
    nodes_lb[1][free[0]] = max(lb0[free[0]], 1.0)
    nodes_ub[2][free[1]] = min(ub0[free[1]], 0.0)
    return nodes_lb, nodes_ub


@pytest.mark.parametrize("use_kernels", [True, False], ids=["kernels", "plain"])
def test_nodes_past_the_limit_match_reference_and_single_runs(tiny_budget, use_kernels):
    root = rd.make_mixed(m=25, n=260, seed=4)
    p = rt.problem_from_reference(root)
    prep = rt.prepare_block_ell(p, device="cpu")
    assert prep.n_pad > tops.SCATTER_MAX_NPAD
    lb, ub = _nodes_of(root)
    got = rt.propagate_nodes(p, lb, ub, use_kernels=use_kernels, device="cpu")
    want = rc.propagate_nodes(root, lb, ub)  # the reference's partitioned node kernels
    assert len(prep._slabs) >= 1  # the node round took the slab partition
    for i in range(3):
        w = want.result(i)
        assert rt.bounds_equal(got.lb[i], got.ub[i], np.asarray(w.lb), np.asarray(w.ub))
        assert int(got.rounds[i]) == int(w.rounds)
        assert bool(got.infeasible[i]) == bool(w.infeasible)
        assert bool(got.converged[i]) == bool(w.converged)
        one = rt.propagate_block_ell(p, lb0=lb[i], ub0=ub[i], device="cpu")
        np.testing.assert_array_equal(got.lb[i].numpy(), one.lb.numpy())
        np.testing.assert_array_equal(got.ub[i].numpy(), one.ub.numpy())
        for f in ("rounds", "converged", "infeasible"):
            assert getattr(got, f)[i].item() == getattr(one, f).item(), f


def test_nodes_past_the_limit_integer_data_bitwise(tiny_budget):
    """Integer-valued data: the node batch equals the reference's bitwise."""
    root = rd.make_knapsack(n=200, m=10, seed=3)
    p = rt.problem_from_reference(root)
    lb, ub = _nodes_of(root)
    got = rt.propagate_nodes(p, lb, ub, tile_width=8, device="cpu")
    want = rc.propagate_nodes(root, lb, ub, tile_width=8, use_pallas=False)
    np.testing.assert_array_equal(got.lb.numpy(), np.asarray(want.lb))
    np.testing.assert_array_equal(got.ub.numpy(), np.asarray(want.ub))
    for f in ("rounds", "converged", "infeasible"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))


def _objective(n):
    sign = np.where(np.arange(n) % 3 == 0, -1.0, 1.0)
    return np.arange(1, n + 1, dtype=np.float64) * sign


SOLVE_FIELDS = ("status", "objective", "feasible", "nodes_expanded", "nodes_created", "leaves",
                "pruned_bound", "pruned_infeasible", "levels", "host_syncs",
                "incumbent_trajectory")
# (seed, rule, search options): n = 200 columns, n_pad 256, two slabs of 128.
SEARCHES = {
    "exhausts_pool": (1, "most_fractional", dict(node_cap=32)),
    "exhausts_pool_pseudo_cost": (1, "pseudo_cost", dict(node_cap=32)),
    "dive": (1, "most_fractional", dict(node_cap=32, expand_width=2, max_levels=8,
                                       sync_every=3)),
    "infeasible_root": (0, "most_fractional", dict(node_cap=16)),
}


@pytest.mark.parametrize("use_kernels", [True, False], ids=["kernels", "plain"])
@pytest.mark.parametrize("name", list(SEARCHES))
def test_solve_past_the_limit_matches_reference(tiny_budget, name, use_kernels):
    seed, rule, kw = SEARCHES[name]
    pr = rd.make_pseudo_boolean(n=200, m=260, seed=seed)
    p = rt.problem_from_reference(pr)
    prep = rt.prepare_block_ell(p, tile_width=8, device="cpu")
    assert prep.n_pad == 256 and prep.slab_partition().n_slabs == 2
    c = _objective(pr.n)
    want = rc.solve(pr, c, rule=rc.BranchRule(rule), use_pallas=False, **kw)
    got = rt.solve(p, c, rule=rt.BranchRule(rule), use_kernels=use_kernels, device="cpu", **kw)
    for f in SOLVE_FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    if want.x is None:
        assert got.x is None
    else:
        np.testing.assert_array_equal(got.x, want.x)
    if name == "exhausts_pool":
        assert got.levels > 3
        # The same search through the fused node round (limit restored).
        tops.SCATTER_MAX_NPAD = 1 << 16
        fused = rt.solve(p, c, rule=rt.BranchRule(rule), device="cpu", **kw)
        for f in SOLVE_FIELDS:
            assert getattr(fused, f) == getattr(got, f), f
        for f, x, y in zip(got.carry._fields, got.carry, fused.carry):
            assert torch.equal(x, y), f


@pytest.mark.parametrize("gen_name,kw,tile_width,exact", [
    ("make_mixed", dict(m=25, n=260, seed=4), 128, False),
    ("make_knapsack", dict(n=200, m=10, seed=3), 8, True),
])
def test_plain_nodes_past_the_limit_follow_the_segment_override(tiny_budget, monkeypatch,
                                                                gen_name, kw, tile_width,
                                                                exact):
    """Under ``REPRO_AUTO_LARGE_SCATTER=segment`` the plain node round past
    the limit runs the segment round per node, as the reference's plain node
    round does (no slab partition is built); the kernel path ignores the
    override, as the reference's Pallas path does."""
    monkeypatch.setenv(tops.AUTO_LARGE_SCATTER_ENV, "segment")
    root = getattr(rd, gen_name)(**kw)
    p = rt.problem_from_reference(root)
    lb, ub = _nodes_of(root)
    prep = rt.prepare_block_ell(p, tile_width=tile_width, device="cpu")
    assert prep.n_pad > tops.SCATTER_MAX_NPAD
    got = rt.propagate_nodes(p, lb, ub, tile_width=tile_width, use_kernels=False, device="cpu")
    want = rc.propagate_nodes(root, lb, ub, tile_width=tile_width, use_pallas=False)
    assert not prep._slabs and "index" in prep._segment  # the segment round ran
    for i in range(3):
        w = want.result(i)
        for f in ("rounds", "converged", "infeasible"):
            assert int(getattr(got, f)[i]) == int(np.asarray(getattr(w, f))), f
        assert rt.bounds_equal(got.lb[i], got.ub[i], np.asarray(w.lb), np.asarray(w.ub))
        for g, x in ((got.lb[i], w.lb), (got.ub[i], w.ub)):
            if exact:
                np.testing.assert_array_equal(g.numpy(), np.asarray(x))
            else:
                np.testing.assert_allclose(g.numpy(), np.asarray(x), rtol=1e-12, atol=1e-12)
        # The port's own single-instance segment run, bitwise.
        one = rt.propagate_block_ell(p, tile_width=tile_width, lb0=lb[i], ub0=ub[i],
                                     scatter="segment", use_kernels=False, device="cpu")
        np.testing.assert_array_equal(got.lb[i].numpy(), one.lb.numpy())
        np.testing.assert_array_equal(got.ub[i].numpy(), one.ub.numpy())
        assert int(got.rounds[i]) == int(one.rounds)
    kern = rt.propagate_nodes(p, lb, ub, tile_width=tile_width, device="cpu")
    assert prep._slabs  # the kernel path took the partitioned round
    for i in range(3):
        assert int(kern.rounds[i]) == int(got.rounds[i])


@pytest.mark.parametrize("name", ["exhausts_pool", "dive"])
def test_plain_solve_past_the_limit_follows_the_segment_override(tiny_budget, monkeypatch,
                                                                 name):
    """solve(use_kernels=False) past the limit under the override equals the
    reference's plain search under it."""
    monkeypatch.setenv(tops.AUTO_LARGE_SCATTER_ENV, "segment")
    seed, rule, kw = SEARCHES[name]
    pr = rd.make_pseudo_boolean(n=200, m=260, seed=seed)
    p = rt.problem_from_reference(pr)
    c = _objective(pr.n)
    want = rc.solve(pr, c, rule=rc.BranchRule(rule), use_pallas=False, **kw)
    got = rt.solve(p, c, rule=rt.BranchRule(rule), use_kernels=False, device="cpu", **kw)
    prep = rt.prepare_block_ell(p, tile_width=8, device="cpu")
    assert not prep._slabs and "index" in prep._segment
    for f in SOLVE_FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    np.testing.assert_array_equal(got.x, want.x)
