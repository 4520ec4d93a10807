"""The port's segment (seed) dataflow against the reference's.

  * Kernels A, B and C: their plain versions (the wrappers on CPU tensors)
    against the reference's Pallas kernels in interpret mode, on seeded
    tiles in the shapes of ``test_torch_kernels.py``: bitwise (as values) on
    integer-valued data, ``rtol=1e-12`` on general floats, infinity counts
    exact.
  * ``propagate_block_ell(scatter="segment", device="cpu")`` on both
    branches (kernel C where rows fit one chunk, A + combine + B otherwise)
    against the reference's ``scatter="segment"`` with Pallas in interpret
    mode and with ``use_pallas=False``: rounds, converged and infeasible
    exact; bounds bitwise on the exact families and ``bounds_equal`` /
    ``allclose(1e-12)`` on ``make_mixed``.  The port's segment engine also
    equals its fused engine bitwise (same summation order, same combine).
  * ``block_ell_round`` / ``legacy_round_fn_for`` on one round, the
    ``REPRO_AUTO_LARGE_SCATTER`` override, a segment warm start, and the
    reference's three-engine check (sequential, fused, segment) on the port.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.data as rd
import repro.kernels as rk
from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro.kernels import (
    activities_tiles as r_activities,
    candidates_tiles as r_candidates,
    fused_round_tiles as r_fused_round,
)
import repro_torch as rt
from repro_torch import kernels as tk
from repro_torch.kernels import ops as tops

from test_fused_scatter import _random_problem
from test_torch_kernels import EXACT, SHAPES, _assert_match, _j, _t, _tiles
from test_torch_propagator import assert_results_match


def _gathered(x):
    return x["lb"][x["col"]], x["ub"][x["col"]]


@pytest.mark.parametrize("exact", EXACT, ids=["int", "float"])
@pytest.mark.parametrize("t,r,k,n", SHAPES)
def test_activities_tiles_matches_pallas(t, r, k, n, exact, rng):
    x = _tiles(rng, t, r, k, n, exact)
    lb_g, ub_g = _gathered(x)
    want = r_activities(_j(x["val"]), _j(lb_g), _j(ub_g), interpret=True)
    tk.reset_launch_counts()
    got = tk.activities_tiles(_t(x["val"]), _t(lb_g), _t(ub_g))
    assert [g.dtype for g in got] == [torch.float64, torch.int32] * 2
    for g, w in zip(got, want):
        _assert_match(g, w, exact)
    assert tk.launch_counts()["activities_tiles"] == 0  # CPU: the plain version


@pytest.mark.parametrize("exact", EXACT, ids=["int", "float"])
@pytest.mark.parametrize("t,r,k,n", SHAPES)
def test_candidates_tiles_matches_pallas(t, r, k, n, exact, rng):
    x = _tiles(rng, t, r, k, n, exact)
    lb_g, ub_g = _gathered(x)
    # Completed row aggregates as the engine feeds them: the reference
    # oracle's partials, so both packages see identical (T, R) inputs.
    aggs = [np.asarray(a) for a in rref.activities_tiles_ref(_j(x["val"]), _j(lb_g), _j(ub_g))]
    want = r_candidates(
        _j(x["val"]), _j(lb_g), _j(ub_g), _j(x["ii"]), *map(_j, aggs), _j(x["lhs"]),
        _j(x["rhs"]), int_eps=1e-6, interpret=True,
    )
    got = tk.candidates_tiles(
        _t(x["val"]), _t(lb_g), _t(ub_g), _t(x["ii"]), *map(_t, aggs), _t(x["lhs"]),
        _t(x["rhs"]), int_eps=1e-6,
    )
    for g, w in zip(got, want):
        _assert_match(g, w, exact)


@pytest.mark.parametrize("exact", EXACT, ids=["int", "float"])
@pytest.mark.parametrize("t,r,k,n", SHAPES)
def test_fused_round_tiles_matches_pallas(t, r, k, n, exact, rng):
    x = _tiles(rng, t, r, k, n, exact)
    lb_g, ub_g = _gathered(x)
    want = r_fused_round(
        _j(x["val"]), _j(lb_g), _j(ub_g), _j(x["ii"]), _j(x["lhs"]), _j(x["rhs"]),
        int_eps=1e-6, interpret=True,
    )
    got = tk.fused_round_tiles(
        _t(x["val"]), _t(lb_g), _t(ub_g), _t(x["ii"]), _t(x["lhs"]), _t(x["rhs"]), int_eps=1e-6,
    )
    for g, w in zip(got, want):
        _assert_match(g, w, exact)
    # Bool marks widen to int32 (the reference's _int_operand).
    as_bool = tk.fused_round_tiles(
        _t(x["val"]), _t(lb_g), _t(ub_g), _t(x["ii"] != 0), _t(x["lhs"]), _t(x["rhs"]),
        int_eps=1e-6,
    )
    for g, w in zip(as_bool, got):
        assert torch.equal(g, w)


# (generator, kwargs, tile_rows, tile_width, exact): each family once with
# every row in one chunk (kernel C) and once with rows spanning chunks
# (A, the combine, B).
CASES = [
    ("make_set_cover", dict(n=60, m=30, seed=3), 4, 128, True),
    ("make_set_cover", dict(n=60, m=30, seed=3), 4, 8, True),
    ("make_knapsack", dict(n=40, m=6, seed=5), 4, 128, True),
    ("make_knapsack", dict(n=40, m=6, seed=5), 2, 8, True),
    ("make_cascade_chain", dict(length=16), 2, 128, True),
    ("make_cascade_chain", dict(length=16), 2, 1, True),
    ("make_mixed", dict(m=60, n=45, seed=21), 4, 128, False),
    ("make_mixed", dict(m=60, n=45, seed=21), 4, 8, False),
]


def _ids():
    return [f"{g}-{kw.get('seed', 0)}-R{r}K{k}" for g, kw, r, k, _ in CASES]


@pytest.mark.parametrize("gen,kw,tile_rows,tile_width,exact", CASES, ids=_ids())
def test_segment_engine_matches_reference(gen, kw, tile_rows, tile_width, exact):
    pr = getattr(rd, gen)(**kw)
    pt = rt.problem_from_reference(pr)
    lay = dict(tile_rows=tile_rows, tile_width=tile_width)
    pallas = rk.propagate_block_ell(pr, scatter="segment", use_pallas=True, interpret=True,
                                    **lay)
    plain = rk.propagate_block_ell(pr, scatter="segment", use_pallas=False, **lay)
    fused = rt.propagate_block_ell(pt, scatter="fused", device="cpu", **lay)
    for driver in ("device_loop", "host_loop"):
        for use_kernels in (True, False):
            got = rt.propagate_block_ell(pt, scatter="segment", driver=driver,
                                         use_kernels=use_kernels, device="cpu", **lay)
            for want in (pallas, plain):
                assert_results_match(got, want, exact)
            # The fused engine sums each row in the same order, through the
            # same combine: bitwise on every family.
            assert_results_match(got, fused, exact=True)


@pytest.mark.parametrize("tile_width", [128, 8])
@pytest.mark.parametrize("use_kernels", [True, False])
def test_legacy_round_matches_reference(tile_width, use_kernels):
    """One seed round (``legacy_round_fn_for``) in the unpadded ``(n,)``
    domain against the reference's, and against one prepared segment
    round on the same bounds."""
    pr = rd.make_mixed(m=60, n=45, seed=21)
    pt = rt.problem_from_reference(pr)
    rprep = rk.prepare_block_ell(pr, 4, tile_width)
    want = rk.legacy_round_fn_for(rprep, use_pallas=use_kernels, interpret=True)(
        jnp.asarray(pr.lb), jnp.asarray(pr.ub)
    )
    prep = tk.prepare_block_ell(pt, 4, tile_width, device="cpu")
    got = tk.legacy_round_fn_for(prep, use_kernels=use_kernels)(
        torch.tensor(pt.lb), torch.tensor(pt.ub)
    )
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12, atol=1e-12)
    assert bool(got[2]) == bool(want[2])
    seg = tk.round_fn_for(prep, use_kernels=use_kernels, scatter="segment")(
        prep.lb0.clone(), prep.ub0.clone()
    )
    assert torch.equal(got[0], seg[0][: pt.n]) and torch.equal(got[1], seg[1][: pt.n])
    assert bool(got[2]) == bool(seg[2])


@pytest.mark.parametrize("fused", [True, False])
def test_block_ell_round_matches_reference(fused):
    """``block_ell_round`` called directly, both branches (C, or A + combine
    + B: ``fused=True`` on rows that fit one chunk), against the
    reference's on the same device tiles' host copies."""
    pr = rd.make_knapsack(n=40, m=6, seed=5)
    pt = rt.problem_from_reference(pr)
    tw = 128 if fused else 8
    rprep = rk.prepare_block_ell(pr, 2, tw)
    prep = tk.prepare_block_ell(pt, 2, tw, device="cpu")
    assert prep.fits_one_chunk == fused
    cfg = rt.core.DEFAULT_CONFIG
    eps = cfg.eps_for(torch.float64)
    want = rk.block_ell_round(rprep.d, jnp.asarray(pr.lb), jnp.asarray(pr.ub), pr.m, pr.n, eps,
                              cfg.int_eps, fused=fused, interpret=True)
    got = tk.block_ell_round(prep.d, torch.tensor(pt.lb), torch.tensor(pt.ub), pt.m, pt.n, eps,
                             cfg.int_eps, fused=fused)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert bool(got[2]) == bool(want[2])


def test_segment_index_skips_padding_only():
    pt = rt.problem_from_reference(rd.make_set_cover(n=60, m=30, seed=3))
    prep = tk.prepare_block_ell(pt, 4, 8, device="cpu")
    pos, cols = prep.segment_index()
    assert pos.dtype == cols.dtype == torch.int64
    assert int(pos.numel()) == pt.nnz
    assert prep.segment_index()[0] is pos  # built once
    flat = prep.d.val.reshape(-1)
    assert bool((flat[pos] != 0).all()) and int((flat != 0).sum()) == pt.nnz
    np.testing.assert_array_equal(np.sort(cols.numpy()), np.sort(pt.csr.col))


def test_auto_large_scatter_env_override(monkeypatch):
    """REPRO_AUTO_LARGE_SCATTER reroutes only the large-instance leg of
    ``scatter='auto'`` (the reference's test_partitioned.py check)."""
    monkeypatch.setattr(tops, "SCATTER_MAX_NPAD", 128)
    monkeypatch.setattr(tops, "SLAB_NPAD", 128)
    tops.clear_prepare_cache()
    big_r = rd.make_banded(n=600, m=48, row_nnz=6, band=64, seed=0)
    big = rt.problem_from_reference(big_r)
    prep = tk.prepare_block_ell(big, 8, 8, device="cpu")
    assert prep.n_pad > tops.SCATTER_MAX_NPAD
    assert tops._resolve_scatter("auto", prep) == "partitioned"
    part = rt.propagate_block_ell(big, tile_width=8, device="cpu")
    monkeypatch.setenv(tk.AUTO_LARGE_SCATTER_ENV, "segment")
    assert tops._resolve_scatter("auto", prep) == "segment"
    small = tk.prepare_block_ell(rt.problem_from_reference(rd.make_mixed(m=10, n=50, seed=0)),
                                 4, 16, device="cpu")
    assert tops._resolve_scatter("auto", small) == "fused"  # unaffected
    got = rt.propagate_block_ell(big, tile_width=8, device="cpu")
    seg = rt.propagate_block_ell(big, tile_width=8, scatter="segment", device="cpu")
    assert_results_match(got, seg, exact=True)
    for f in ("rounds", "converged", "infeasible"):
        assert getattr(got, f).item() == getattr(part, f).item()
    assert rt.bounds_equal(got.lb, got.ub, part.lb, part.ub)
    # The reference takes the same route; its sides are not integral, so
    # its own summation order may move a last bit.
    monkeypatch.setattr(rops, "SCATTER_MAX_NPAD", 128)
    want = rk.propagate_block_ell(big_r, tile_width=8, use_pallas=False)
    assert_results_match(got, want, exact=False)
    monkeypatch.setenv(tk.AUTO_LARGE_SCATTER_ENV, "bogus")
    with pytest.raises(ValueError, match="REPRO_AUTO_LARGE_SCATTER"):
        tops._resolve_scatter("auto", prep)
    with pytest.raises(ValueError, match="unknown scatter"):
        tops._resolve_scatter("bogus", prep)
    tops.clear_prepare_cache()


@pytest.mark.parametrize("use_kernels", [True, False])
def test_segment_warm_start(use_kernels):
    """As the reference's test_nodes.py warm-start identity: the problem's
    own bounds passed as ``lb0``/``ub0`` give the default run; a tightened
    warm start matches the reference's, through the cached tiles."""
    pr = rd.make_mixed(m=90, n=70, seed=4)
    pt = rt.problem_from_reference(pr)
    kw = dict(scatter="segment", use_kernels=use_kernels, device="cpu")
    base = rt.propagate_block_ell(pt, **kw)
    warm = rt.propagate_block_ell(pt, lb0=pt.lb, ub0=pt.ub, **kw)
    assert_results_match(warm, base, exact=True)
    ub0 = np.array(pt.ub)
    ub0[::5] = np.minimum(ub0[::5], 0.0)
    hits = tk.cache_info()["prepare_block_ell"]["hits"]
    node = rt.propagate_block_ell(pt, lb0=pt.lb, ub0=ub0, **kw)
    assert tk.cache_info()["prepare_block_ell"]["hits"] == hits + 1
    want = rk.propagate_block_ell(pr, scatter="segment", use_pallas=False, lb0=pr.lb, ub0=ub0)
    assert_results_match(node, want, exact=False)


def _three_engines(pr, tile_rows=4, tile_width=16):
    """The reference's cross-engine check (test_fused_scatter.py) on the
    port: ``propagate_sequential``, the fused and the segment engine."""
    pt = rt.problem_from_reference(pr)
    a = rt.core.propagate_sequential(pt)
    lay = dict(tile_rows=tile_rows, tile_width=tile_width, driver="host_loop", device="cpu")
    fused = rt.propagate_block_ell(pt, scatter="fused", **lay)
    seg = rt.propagate_block_ell(pt, scatter="segment", **lay)
    assert_results_match(seg, fused, exact=True)
    if bool(a.infeasible) or bool(fused.infeasible):
        return  # infeasibility verdicts may be reached at different rounds
    assert rt.bounds_equal(fused.lb, fused.ub, seg.lb, seg.ub)
    if not (a.converged and bool(fused.converged)):
        return
    assert rt.bounds_equal(a.lb, a.ub, fused.lb, fused.ub)


@pytest.mark.parametrize("seed", range(8))
def test_three_engines_agree_on_random_instances(seed):
    _three_engines(_random_problem(seed))


@pytest.mark.parametrize("seed", [100, 101, 102])
def test_three_engines_agree_with_empty_columns(seed):
    _three_engines(_random_problem(seed, m=15, n=18, empty_col_frac=0.3))
