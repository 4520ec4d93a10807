"""The port's block-ELL engine, ``repro_torch.propagate_block_ell(device="cpu")``,
against the reference's ``repro.kernels.propagate_block_ell`` (Pallas kernels
in interpret mode), on both branches of the fused round:

  * rows that fit one chunk -> kernel D then F;
  * rows that span chunks (a ``tile_width`` below the longest row) -> A', the
    segment combine, E, then F.

Contract: exact-arithmetic families match bitwise (as values); ``make_mixed``
passes ``bounds_equal`` and ``allclose(rtol=1e-12, atol=1e-12)``; ``rounds``,
``converged`` and ``infeasible`` match exactly everywhere.
"""
import numpy as np
import pytest
import torch

import repro.core as rc
import repro.data as rd
import repro.kernels as rk
import repro_torch as rt
from repro_torch import kernels as tk

from test_torch_propagator import assert_results_match

# (generator, kwargs, tile_rows, tile_width, exact): the tile width picks the
# branch -- each family runs once with every row in one chunk and once with
# rows spanning chunks.
CASES = [
    ("make_set_cover", dict(n=60, m=30, seed=3), 4, 32, True),
    ("make_set_cover", dict(n=60, m=30, seed=3), 4, 4, True),
    ("make_knapsack", dict(n=40, m=6, seed=5), 4, 128, True),
    ("make_knapsack", dict(n=40, m=6, seed=5), 2, 8, True),
    ("make_cascade_chain", dict(length=16), 2, 4, True),
    ("make_cascade_chain", dict(length=16), 2, 1, True),
    ("make_pseudo_boolean", dict(n=300, m=400, seed=7), 8, 128, True),
    ("make_pseudo_boolean", dict(n=300, m=400, seed=7), 8, 4, True),
    ("make_mixed", dict(m=60, n=45, seed=21), 4, 128, False),
    ("make_mixed", dict(m=60, n=45, seed=21), 4, 16, False),
]


def _ids():
    return [f"{g}-{kw.get('seed', 0)}-R{r}K{k}" for g, kw, r, k, _ in CASES]


@pytest.mark.parametrize("gen,kw,tile_rows,tile_width,exact", CASES, ids=_ids())
def test_engine_matches_reference(gen, kw, tile_rows, tile_width, exact):
    pr = getattr(rd, gen)(**kw)
    pt = rt.problem_from_reference(pr)
    fits = tk.rows_fit_one_chunk(pt, tile_width)
    assert fits == rk.rows_fit_one_chunk(pr, tile_width)
    for driver in ("device_loop", "host_loop"):
        want = rk.propagate_block_ell(
            pr, tile_rows=tile_rows, tile_width=tile_width, driver=driver
        )
        got = rt.propagate_block_ell(
            pt, tile_rows=tile_rows, tile_width=tile_width, driver=driver, device="cpu"
        )
        assert_results_match(got, want, exact)
        assert got.lb.shape == (pt.n,)


def test_engine_branch_choice_and_plain_path_agree():
    """``fused='no'`` forces the long-row branch on rows that fit, and the
    kernel path equals the plain path (on the CPU both run the plain
    versions, so they are bitwise equal)."""
    pr = rd.make_pseudo_boolean(n=300, m=400, seed=7)
    pt = rt.problem_from_reference(pr)
    want = rk.propagate_block_ell(pr, fused="no", use_pallas=False)
    got = rt.propagate_block_ell(pt, fused="no", device="cpu")
    assert_results_match(got, want, exact=True)
    plain = rt.propagate_block_ell(pt, use_kernels=False, device="cpu")
    assert_results_match(plain, want, exact=True)


def test_engine_round_cap():
    pr = rd.make_cascade_chain(length=24)
    want = rk.propagate_block_ell(pr, rc.PropagatorConfig(max_rounds=6), tile_width=4)
    got = rt.propagate_block_ell(
        rt.problem_from_reference(pr), rt.core.PropagatorConfig(max_rounds=6),
        tile_width=4, device="cpu",
    )
    assert int(got.rounds) == 6 and not bool(got.converged)
    assert_results_match(got, want, exact=True)


def test_warm_start_and_prepare_cache_hit():
    """A branch-and-bound node: warm-start bounds through the cached prepared
    tiles, and a bounds-only variant of the problem hitting the cache."""
    pr = rd.make_set_cover(n=80, m=40, seed=2)
    pt = rt.problem_from_reference(pr)
    ub0 = np.array(pr.ub)
    ub0[np.random.default_rng(0).choice(pr.n, size=pr.n // 3, replace=False)] = 0.0
    tk.clear_prepare_cache()
    root = rt.propagate_block_ell(pt, device="cpu")
    prep = tk.prepare_block_ell(pt, device="cpu")
    lb_before, ub_before = prep.lb0.clone(), prep.ub0.clone()
    info0 = tk.cache_info()["prepare_block_ell"]

    want = rk.propagate_block_ell(pr, lb0=pr.lb, ub0=ub0)
    got = rt.propagate_block_ell(pt, lb0=pt.lb, ub0=ub0, device="cpu")
    assert int(want.rounds) > 1
    assert_results_match(got, want, exact=True)
    info1 = tk.cache_info()["prepare_block_ell"]
    assert info1["hits"] == info0["hits"] + 1 and info1["misses"] == info0["misses"]

    # The in-place merge ran on private copies: the cached bounds survive.
    assert torch.equal(prep.lb0, lb_before) and torch.equal(prep.ub0, ub_before)
    again = rt.propagate_block_ell(pt, device="cpu")
    assert torch.equal(again.lb, root.lb) and torch.equal(again.ub, root.ub)

    node = pt._replace(ub=ub0)
    view = tk.prepare_block_ell(node, device="cpu")
    assert view.d.val is prep.d.val and not torch.equal(view.ub0, prep.ub0)
    via_view = rt.propagate_block_ell(node, device="cpu")
    assert_results_match(via_view, want, exact=True)
    assert tk.prepare_block_ell(pt, device="cpu") is prep


def test_host_syncs_counted_once_per_round():
    """One read per round on the host loop; on the device loop (the
    default) one read of the carry per DEVICE_LOOP_GROUP rounds."""
    pt = rt.problem_from_reference(rd.make_cascade_chain(length=12))
    syncs = []
    r = rt.propagate_block_ell(pt, tile_width=4, driver="host_loop", device="cpu",
                               on_sync=lambda: syncs.append(1))
    assert len(syncs) == int(r.rounds) == 14
    syncs.clear()
    r = rt.propagate_block_ell(pt, tile_width=4, device="cpu", on_sync=lambda: syncs.append(1))
    group = rt.core.propagator.DEVICE_LOOP_GROUP
    assert int(r.rounds) == 14 and len(syncs) == -(-14 // group)


@pytest.mark.parametrize("kw,match", [
    (dict(dtype=np.float32), "item 5"),
    (dict(dtype=torch.float32), "item 5"),
    (dict(policy=rt.core.TierPolicy()), "item 5"),
    (dict(stop_progress=1e-3), "item 5"),
    (dict(telemetry=8), "item 6"),
])
def test_requests_outside_the_slice_raise(kw, match):
    """Telemetry (item 6) raises.  Item 5's options, ported since (the
    precision tiers), run and give the reference's rounds, flags and
    bounds: float32 and the two-tier policy against the reference's
    ``propagate`` (whose fp32 tier widens outward as the port's does), the
    early stop against its ``propagate_block_ell``."""
    pr = rd.make_set_cover(n=20, m=8, seed=0)
    pt = rt.problem_from_reference(pr)
    if match == "item 6":
        with pytest.raises(NotImplementedError, match=match):
            rt.propagate_block_ell(pt, device="cpu", **kw)
        return
    got = rt.propagate_block_ell(pt, device="cpu", **kw)
    if "stop_progress" in kw:
        want = rk.propagate_block_ell(pr, **kw)
    elif "policy" in kw:
        want = rc.propagate(pr, policy=rc.TierPolicy())
        assert int(got.tier_rounds) == int(want.tier_rounds) >= 1
    else:
        want = rc.propagate(pr, dtype=np.float32)
        assert got.lb.dtype == torch.float32
    for f in ("rounds", "converged", "infeasible"):
        assert int(getattr(got, f)) == int(getattr(want, f))
    np.testing.assert_array_equal(got.lb.double().numpy(), np.asarray(want.lb, np.float64))
    np.testing.assert_array_equal(got.ub.double().numpy(), np.asarray(want.ub, np.float64))


def test_wide_instance_needs_the_partitioned_engine():
    n = tk.SCATTER_MAX_NPAD + 1
    csr = rt.core.csr_from_coo(
        np.array([0, 0]), np.array([0, n - 1]), np.array([1.0, 1.0]), 1, n
    )
    p = rt.Problem(csr, np.array([1.0]), np.array([rc.INF]), np.zeros(n), np.ones(n),
                   np.ones(n, dtype=bool))
    prep = tk.prepare_block_ell(p, device="cpu")
    assert prep.n_pad > tk.SCATTER_MAX_NPAD
    assert tk.ops._resolve_scatter("auto", prep) == "partitioned"
    # The row's two nonzeros lie in different slabs: a straddle row.
    part = prep.slab_partition()
    assert part.n_slabs == 2 and part.n_straddle == 1
    auto = rt.propagate_block_ell(p, device="cpu")
    fused = rt.propagate_block_ell(p, scatter="fused", device="cpu")
    for got in (auto, fused):
        assert (int(got.rounds), bool(got.converged), bool(got.infeasible)) == (1, True, False)
        np.testing.assert_array_equal(got.lb.numpy(), p.lb)
        np.testing.assert_array_equal(got.ub.numpy(), p.ub)


def test_lru_pins_anchors_and_evicts_oldest():
    cache = tk.LRU(maxsize=2)
    a, b, c = object(), object(), object()
    cache.put((id(a),), (a,), "A")
    cache.put((id(b),), (b,), "B")
    assert cache.get((id(a),), (a,)) == "A"          # a is now the newest
    cache.put((id(c),), (c,), "C")                    # evicts b
    assert cache.get((id(b),), (b,)) is None
    assert cache.get((id(c),), (c,)) == "C"
    assert cache.get((id(a),), (object(),)) is None   # same key, other anchor
    assert len(cache) == 2
    assert cache.info() == {"hits": 2, "misses": 2, "size": 2, "maxsize": 2}


def test_device_block_ell_layout_matches_reference():
    pr = rd.make_mixed(m=40, n=30, seed=4)
    want = rk.device_block_ell(pr, tile_rows=4, tile_width=16)
    got = tk.device_block_ell(rt.problem_from_reference(pr), 4, 16, device="cpu")
    for f in want._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
    prep_r = rk.prepare_block_ell(pr, 4, 16)
    prep_t = tk.prepare_block_ell(rt.problem_from_reference(pr), 4, 16, device="cpu")
    for f in ("ii_g", "lhs_g", "rhs_g", "lb0", "ub0"):
        np.testing.assert_array_equal(getattr(prep_t, f).numpy(), np.asarray(getattr(prep_r, f)))
    assert (prep_t.m, prep_t.n, prep_t.n_pad, prep_t.fits_one_chunk) == (
        prep_r.m, prep_r.n, prep_r.n_pad, prep_r.fits_one_chunk
    )


@pytest.mark.parametrize("tile_rows,tile_width", [(4, 16), (8, 4), (2, 1)])
def test_row_start_marks_each_rows_first_chunk(tile_rows, tile_width):
    """``row_start`` (read off the chunk stream) holds each row's first chunk
    by the layout rule: ceil(len / K) chunks per row, one for an empty row,
    then the padding row m up to the end of the last tile."""
    pr = rd.make_mixed(m=40, n=30, seed=4)
    prep = tk.prepare_block_ell(rt.problem_from_reference(pr), tile_rows, tile_width,
                                device="cpu")
    lengths = np.diff(pr.csr.row_ptr)
    per_row = np.maximum(1, -(-lengths // tile_width))
    total = prep.d.val.shape[0] * tile_rows
    want = np.concatenate([[0], np.cumsum(per_row), [total]])
    np.testing.assert_array_equal(prep.row_start.numpy(), want)
