"""The port's batched engine (``repro_torch.propagate_batch``, on the CPU)
against the reference's ``repro.core.propagate_batch``, on the cases of the
reference's own batch tests: packing, kernel #8's plain version, the three
branches of the batched round, both drivers, the convergence mask and
warm starts.

Contract: packed arrays byte-identical; bounds bitwise (as values) on the
integer-valued families (``make_set_cover``, ``make_knapsack``,
``make_cascade_chain``), ``bounds_equal`` and ``rtol=1e-12, atol=1e-12`` on
``make_mixed`` (the two packages sum in different orders); ``rounds``,
``converged`` and ``infeasible`` exactly everywhere; ``progress`` to
``rtol=1e-12`` (a sum over columns), NaN included.  Against the port's own
single-instance engine every instance is bitwise on any data: both sum each
chunk in the warp's order and each long row's chunks left to right.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as rc
import repro.data as rd
from repro.kernels import batched_fused_scatter_round_tiles as r_batched_round
from repro.kernels import ops as rops
from repro.kernels import ref as rref
import repro_torch as rt
from repro_torch.core import INF, batch_stats, pack_problems
from repro_torch.kernels import (
    accumulator_planes,
    batched_fused_scatter_round_tiles,
    batched_occupancy_round_tiles,
    cache_info,
    launch_counts,
    ref as tref,
    reset_launch_counts,
)
from repro_torch.kernels import ops as tops


def _port(problems):
    return [rt.problem_from_reference(p) for p in problems]


def _set2_bucket(count=8, m=120, n=100):
    """Set-2-sized instances (size in [100, 200)) that share one bucket."""
    return [rd.make_mixed(m=m, n=n, seed=s) for s in range(count)]


def _free_problem(m=20, n=60, seed=0):
    """Converges in one (no-change) round: every side is infinite."""
    p = rd.make_knapsack(n=n, m=m, seed=seed)
    return p._replace(lhs=np.full(p.m, -INF), rhs=np.full(p.m, INF))


def _assert_matches(got, want, exact):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for f in ("rounds", "converged", "infeasible"):
            assert int(getattr(g, f)) == int(np.asarray(getattr(w, f))), f
        assert g.lb.shape == np.asarray(w.lb).shape
        assert rt.bounds_equal(g.lb, g.ub, np.asarray(w.lb), np.asarray(w.ub))
        for a, b in ((g.lb, w.lb), (g.ub, w.ub)):
            if exact:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            else:
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(g.progress.numpy(), np.asarray(w.progress), rtol=1e-12,
                                   equal_nan=True)


def _assert_same(a, b):
    """Two results of the port: bitwise, progress included."""
    for f in ("lb", "ub", "rounds", "converged", "infeasible", "progress"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.shape == y.shape, f
        np.testing.assert_array_equal(x.numpy(), y.numpy(), err_msg=f)


# ---------------------------------------------------------------------------
# Packing
# ---------------------------------------------------------------------------

POPULATIONS = {
    "set2_and_knapsack": (lambda: _set2_bucket(3) + [rd.make_knapsack(n=60, m=20, seed=7)],
                          {}),
    "two_widths": (lambda: [rd.make_mixed(m=120, n=100, seed=0),
                            rd.make_mixed(m=120, n=200, seed=1),
                            rd.make_set_cover(n=90, m=30, seed=2)], {}),
    "tile_8x2": (lambda: [rd.make_knapsack(n=40, m=10, seed=s) for s in range(3)],
                 dict(tile_rows=2, tile_width=8)),
    "forced_width": (lambda: [rd.make_mixed(m=120, n=100, seed=0),
                              rd.make_mixed(m=120, n=200, seed=1)], dict(n_pad=256)),
}


@pytest.mark.parametrize("name", list(POPULATIONS))
def test_pack_problems_is_byte_identical(name):
    make, kw = POPULATIONS[name]
    probs = make()
    want = rc.pack_problems(probs, **kw)
    got = pack_problems(_port(probs), **kw)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.indices == w.indices and g.size == w.size
        assert (g.n_pad, g.m_total) == (w.n_pad, w.m_total)
        for f in ("lhs1", "rhs1", "lb", "ub", "is_int"):
            a, b = getattr(g, f), getattr(w, f)
            assert a.dtype == b.dtype and a.shape == b.shape, f
            assert a.tobytes() == b.tobytes(), f
        for f in w.ell._fields:
            a, b = getattr(g.ell, f), np.asarray(getattr(w.ell, f))
            assert a.dtype == b.dtype and a.shape == b.shape, f
            assert a.tobytes() == b.tobytes(), f
    assert batch_stats(got) == rc.batch_stats(want)


def test_pack_problems_flat_structure():
    """The reference test's invariants, on the port's packing: one bucket,
    instance tile streams contiguous, rows inside each instance's window,
    dummy rows zero; the global rows ascend, so each row's chunks lie next
    to each other (the long-row combine's precondition)."""
    probs = _port(_set2_bucket(3) + [rd.make_knapsack(n=60, m=20, seed=7)])
    (b,) = pack_problems(probs)
    ell = b.ell
    assert sorted(b.indices) == [0, 1, 2, 3]
    assert (np.diff(ell.tile_inst) >= 0).all()
    assert (np.diff(ell.chunk_row.reshape(-1)) >= 0).all()
    for i, p in enumerate(b.problems):
        rows = ell.chunk_row[ell.tile_inst == i]
        assert rows.min() >= ell.row_offset[i]
        assert rows.max() <= ell.row_offset[i] + p.m
        off = ell.row_offset[i]
        np.testing.assert_array_equal(b.lhs1[off : off + p.m], p.lhs)
        assert b.lhs1[off + p.m] == 0.0


@pytest.mark.parametrize("tile", [(8, 128), (2, 8)])
def test_row_start_marks_each_global_rows_first_chunk(tile):
    probs = _port([rd.make_knapsack(n=40, m=10, seed=s) for s in range(3)])
    (b,) = pack_problems(probs, tile_rows=tile[0], tile_width=tile[1])
    prep = tops.prepare_problem_batch(b, device="cpu")
    flat = b.ell.chunk_row.reshape(-1)
    start = prep.row_start.numpy()
    assert start.shape == (b.m_total + 1,) and start[-1] == flat.size
    for row in range(b.m_total):
        chunks = np.flatnonzero(flat == row)
        assert start[row + 1] - start[row] == chunks.size
        if chunks.size:
            assert start[row] == chunks[0] and (np.diff(chunks) == 1).all()
    dummies = b.ell.row_offset[1:] - 1
    assert (start[dummies + 1] - start[dummies] >= 0).all()


# ---------------------------------------------------------------------------
# Kernel #8's plain version and the batched round functions
# ---------------------------------------------------------------------------


def _flat_batch(rng, sizes, r, k, n, integer):
    """Random flat tile stream: ``sizes[i]`` tiles for instance i (numpy)."""
    t, bsz, n_pad = sum(sizes), len(sizes), rc.col_pad(n)
    val = rng.choice([-2.0, -1.0, 0.0, 1.0, 3.0], size=(t, r, k))
    col = rng.integers(0, n, size=(t, r, k)).astype(np.int32)
    col[val == 0] = 0
    tile_inst = np.repeat(np.arange(bsz, dtype=np.int32), sizes)
    if integer:
        lb = rng.integers(-5, 1, size=(bsz, n_pad)).astype(np.float64)
        ub = rng.integers(0, 6, size=(bsz, n_pad)).astype(np.float64)
        lhs = rng.integers(-10, 1, size=(t, r)).astype(np.float64)
        rhs = rng.integers(0, 11, size=(t, r)).astype(np.float64)
    else:
        lb, ub = rng.uniform(-5, 0, size=(bsz, n_pad)), rng.uniform(0, 5, size=(bsz, n_pad))
        lhs, rhs = rng.uniform(-10, 0, size=(t, r)), rng.uniform(0, 10, size=(t, r))
    lb[rng.random((bsz, n_pad)) < 0.15] = -INF
    ub[rng.random((bsz, n_pad)) < 0.15] = INF
    ii = (rng.random((t, r, k)) < 0.5).astype(np.int32)
    return val, col, ii, lhs, rhs, lb, ub, tile_inst, n_pad


MASKS = {"on": None, "mixed": [True, False, True], "off": [False, False, False]}


@pytest.mark.parametrize("integer", [True, False], ids=["int", "float"])
@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("sizes,n", [((2, 3, 1), 20), ((1, 4, 2), 150)])
def test_batched_fused_round_matches_reference_kernel(rng, sizes, n, mask, integer):
    """#8's plain version (through the wrapper, on CPU tensors) against the
    reference's Pallas kernel in interpret mode; inactive instances give
    identity rows; active ones equal the reference's oracle and the port's
    kernel D on that instance alone, bitwise."""
    val, col, ii, lhs, rhs, lb, ub, tile_inst, n_pad = _flat_batch(rng, sizes, 4, 8, n, integer)
    active = np.ones(3, bool) if MASKS[mask] is None else np.array(MASKS[mask])
    j, t = jnp.asarray, torch.from_numpy
    reset_launch_counts()
    got = batched_fused_scatter_round_tiles(t(val), t(col), t(ii), t(lhs), t(rhs), t(lb),
                                            t(ub), t(tile_inst), t(active), n_pad, 1e-6,
                                            acc=accumulator_planes(t(lb)))
    assert set(launch_counts().values()) == {0}  # CPU tensors: the plain version
    want = r_batched_round(j(val), j(col), j(ii != 0), j(lhs), j(rhs), j(lb), j(ub),
                           j(tile_inst), j(active), n_pad, int_eps=1e-6, interpret=True)
    oracle = rref.batched_fused_scatter_round_ref(
        j(val), j(col + tile_inst[:, None, None] * n_pad), j(ii != 0), j(lhs), j(rhs), j(lb),
        j(ub), n_pad, int_eps=1e-6)
    for g, w, o in zip(got, want, oracle):
        g, w, o = g.numpy(), np.asarray(w), np.asarray(o)
        for i in range(3):
            if not active[i]:
                assert (np.abs(g[i]) == INF).all() and (np.sign(g[i]) == np.sign(w[i])).all()
                continue
            if integer:
                np.testing.assert_array_equal(g[i], w[i])
                np.testing.assert_array_equal(g[i], o[i])
            else:
                np.testing.assert_allclose(g[i], w[i], rtol=1e-12, atol=0)
                np.testing.assert_allclose(g[i], o[i], rtol=1e-12, atol=0)
    for i in np.flatnonzero(active):
        sel = tile_inst == i
        one = tref.fused_scatter_round_tiles_ref(
            t(val[sel]), t(col[sel]), t(ii[sel]), t(lhs[sel]), t(rhs[sel]), t(lb[i]),
            t(ub[i]), n_pad, 1e-6)
        np.testing.assert_array_equal(got[0][i].numpy(), one[0].numpy())
        np.testing.assert_array_equal(got[1][i].numpy(), one[1].numpy())


def test_occupancy_round_is_fused_round_then_masked_merge(rng):
    val, col, ii, lhs, rhs, lb, ub, tile_inst, n_pad = _flat_batch(rng, (2, 2, 3), 4, 8, 30,
                                                                    True)
    t = torch.from_numpy
    occ = t(np.array([True, False, True]))
    best_l, best_u = batched_fused_scatter_round_tiles(
        t(val), t(col), t(ii), t(lhs), t(rhs), t(lb), t(ub), t(tile_inst), occ, n_pad, 1e-6,
        acc=accumulator_planes(t(lb)))
    want = rt.core.apply_updates_batch(t(lb), t(ub), best_l, best_u, 1e-9, active=occ)
    lbw, ubw = t(lb.copy()), t(ub.copy())
    acc = accumulator_planes(lbw)
    got = batched_occupancy_round_tiles(t(val), t(col), t(ii), t(lhs), t(rhs), lbw, ubw,
                                        t(tile_inst), occ, n_pad, 1e-9, 1e-6, acc=acc)
    assert got[0] is lbw and got[1] is ubw  # in place
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    np.testing.assert_array_equal(got[0][1].numpy(), lb[1])
    # #9 hands the kept planes back at the sentinels.
    assert (acc[0] == -INF).all() and (acc[1] == INF).all()


@pytest.mark.parametrize("integer", [True, False], ids=["int", "float"])
def test_multichunk_batched_round_matches_reference(rng, integer):
    """The multi-chunk round's plain version (A', the left-to-right combine
    over global rows, E) against the reference's segment-sum oracle."""
    probs = [rd.make_knapsack(n=40, m=10, seed=s) for s in range(3)]
    (b,) = rc.pack_problems(probs, tile_rows=2, tile_width=8)
    ell, n_pad = b.ell, b.n_pad
    col_g = ell.col + ell.tile_inst[:, None, None] * n_pad
    ii = b.is_int.reshape(-1)[col_g]
    lhs, rhs = b.lhs1[ell.chunk_row], b.rhs1[ell.chunk_row]
    if integer:
        lb, ub = b.lb, b.ub
    else:
        lb = b.lb + rng.uniform(-0.5, 0, size=b.lb.shape)
        ub = b.ub + rng.uniform(0, 0.5, size=b.ub.shape)
    j, t = jnp.asarray, torch.from_numpy
    want = rref.batched_candidates_scatter_round_ref(
        j(ell.val), j(col_g), j(ii), j(ell.chunk_row), j(lhs), j(rhs), j(lb), j(ub),
        b.m_total, n_pad, int_eps=1e-6)
    got = tref.batched_candidates_scatter_round_ref(
        t(ell.val), t(col_g), t(ii.astype(np.int32)), t(ell.chunk_row), t(lhs), t(rhs), t(lb),
        t(ub), b.m_total, n_pad, 1e-6)
    for g, w in zip(got, want):
        if integer:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# propagate_batch against the reference and the port's single-instance engine
# ---------------------------------------------------------------------------

# (population, tile, integer data).  The tile widths pick the branch: rows in
# one chunk (#8 + #9) or rows spanning chunks (A', combine, E, #9).
CASES = {
    "set2_fused": (lambda: _set2_bucket(8), (8, 128), False),
    "mixed_multichunk": (lambda: [rd.make_mixed(m=60, n=50, seed=s) for s in range(4)], (8, 8),
                         False),
    "knapsack_multichunk": (lambda: [rd.make_knapsack(n=40, m=10, seed=s) for s in range(3)],
                            (2, 8), True),
    "exact_fused": (lambda: [rd.make_knapsack(n=60, m=20, seed=s) for s in range(2)]
                    + [rd.make_set_cover(n=60, m=22, seed=9), rd.make_cascade_chain(16)],
                    (8, 128), True),
    "set_cover_multichunk": (lambda: [rd.make_set_cover(n=60, m=20, seed=s) for s in range(4)],
                             (8, 8), True),
}


@pytest.mark.parametrize("use_kernels", [True, False], ids=["kernels", "plain"])
@pytest.mark.parametrize("name", list(CASES))
def test_propagate_batch_matches_reference(name, use_kernels):
    make, (tr, tw), exact = CASES[name]
    probs = make()
    want = rc.propagate_batch(probs, tile_rows=tr, tile_width=tw, use_pallas=False)
    ports = _port(probs)
    got = rt.propagate_batch(ports, tile_rows=tr, tile_width=tw, use_kernels=use_kernels,
                             device="cpu")
    _assert_matches(got, want, exact)
    for p, r in zip(ports, got):
        one = rt.propagate_block_ell(p, tile_rows=tr, tile_width=tw, device="cpu")
        for f in ("lb", "ub", "rounds", "converged", "infeasible"):
            np.testing.assert_array_equal(getattr(r, f).numpy(), getattr(one, f).numpy())


def test_propagate_batch_matches_reference_pallas_path():
    """Against the reference's Pallas kernels (#8 and #9 in interpret
    mode), as the reference's own cross-engine test."""
    probs = [rd.make_knapsack(n=60, m=20, seed=s) for s in range(2)] + [
        rd.make_set_cover(n=60, m=22, seed=9), rd.make_cascade_chain(16)]
    want = rc.propagate_batch(probs, use_pallas=True, interpret=True)
    _assert_matches(rt.propagate_batch(_port(probs), device="cpu"), want, True)


KEPT_BUCKETS = {
    # Fits-one-chunk buckets (#8 into kept planes, then #9) whose instances
    # converge at different rounds.
    "knapsack": (lambda: [rd.make_knapsack(n=30, m=30, seed=s) for s in range(3)]
                 + [rd.make_cascade_chain(7)], True),
    "set_cover": (lambda: [rd.make_set_cover(n=60, m=20 + s, seed=s) for s in range(3)]
                  + [rd.make_cascade_chain(7)], True),
    "cascade_chain": (lambda: [rd.make_cascade_chain(16), rd.make_cascade_chain(7),
                               _free_problem()], True),
    "mixed": (lambda: [rd.make_mixed(m=40, n=50, seed=s) for s in range(3)]
              + [_free_problem()], False),
}


@pytest.mark.parametrize("name", list(KEPT_BUCKETS))
def test_fused_bucket_with_kept_planes_matches_reference(name):
    """``propagate_batch`` on a bucket whose rows fit one chunk, on the
    port's kernel path (#8 scattering into the closure's kept planes, over
    the hoisted instance chunk ranges, #9 handing them back), against the
    reference's ``propagate_batch``, while the mask changes between rounds."""
    make, exact = KEPT_BUCKETS[name]
    probs = make()
    want = rc.propagate_batch(probs, tile_rows=8, tile_width=64, use_pallas=False)
    ports = _port(probs)
    (batch,) = pack_problems(ports, tile_rows=8, tile_width=64)
    assert tops.prepare_problem_batch(batch, device="cpu").fits_one_chunk
    reset_launch_counts()
    got = rt.propagate_batch(ports, tile_rows=8, tile_width=64, device="cpu")
    assert set(launch_counts().values()) == {0}  # CPU tensors: the plain versions
    assert len({int(r.rounds) for r in got}) > 1
    if exact:
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.lb.numpy(), np.asarray(w.lb))
            np.testing.assert_array_equal(g.ub.numpy(), np.asarray(w.ub))
    _assert_matches(got, want, exact)


def test_fused_service_with_kept_planes_matches_reference_service():
    """Retire and backfill through two slots of a fits-one-chunk bucket (#8
    into the engine's kept planes): every ticket against the reference's
    service, bitwise on integer data, with the same rounds and verdicts."""
    probs = [rd.make_knapsack(n=60, m=12 + 2 * s, seed=s) for s in range(5)]
    svc = rt.PropagationService.from_problems(_port(probs), slots=2, tile_width=128,
                                              device="cpu")
    assert svc._buckets[0].spec.fits_one_chunk
    got = svc.serve(_port(probs))
    want = rc.PropagationService.from_problems(probs, slots=2, tile_width=128).serve(probs)
    assert svc.stats()["retired"] == len(probs)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.lb.numpy(), np.asarray(w.lb))
        np.testing.assert_array_equal(g.ub.numpy(), np.asarray(w.ub))
        for f in ("rounds", "converged", "infeasible"):
            assert int(getattr(g, f)) == int(np.asarray(getattr(w, f))), f


@pytest.fixture
def tiny_limit(monkeypatch):
    """Shrink the engine limit and the slab cap to 128 in both packages, so
    small buckets cross the limit and ride the partitioned round."""
    for mod in (rops, tops):
        mod.clear_batch_caches()
        monkeypatch.setattr(mod, "SCATTER_MAX_NPAD", 128)
        monkeypatch.setattr(mod, "SLAB_NPAD", 128)
    yield
    for mod in (rops, tops):
        mod.clear_batch_caches()


PARTITIONED = [
    # Rows longer than the tile width: straddle rows and chunk splits.
    ((2, 8), lambda: [rd.make_knapsack(n=280, m=8, seed=5),
                      rd.make_set_cover(n=270, m=25, seed=6)], True),
    ((4, 32), lambda: [rd.make_set_cover(n=270, m=25, seed=s) for s in (6, 7, 8)], True),
    ((4, 32), lambda: [rd.make_mixed(m=35, n=300, seed=s) for s in range(3)], False),
]


@pytest.mark.parametrize("use_kernels", [True, False], ids=["kernels", "plain"])
@pytest.mark.parametrize("case", range(len(PARTITIONED)))
def test_partitioned_branch_matches_reference(tiny_limit, case, use_kernels):
    """A bucket past ``SCATTER_MAX_NPAD`` takes the partitioned round (B > 1
    planes, copies routed by the run maps) and agrees with the reference's
    batch and with each instance's own partitioned single-instance run."""
    (tr, tw), make, exact = PARTITIONED[case]
    probs = make()
    ports = _port(probs)
    (b,) = tops.packed_problems(ports, tile_rows=tr, tile_width=tw)
    prep = tops.prepare_problem_batch(b, device="cpu")
    part = prep.slab_partition()
    assert prep.n_pad > tops.SCATTER_MAX_NPAD and part.batch == len(probs) > 1
    assert part.n_slabs > 1 and part.has_straddle
    want = rc.propagate_batch(probs, tile_rows=tr, tile_width=tw, use_pallas=False)
    got = rt.propagate_batch(ports, tile_rows=tr, tile_width=tw, use_kernels=use_kernels,
                             device="cpu")
    _assert_matches(got, want, exact)
    for p, r in zip(ports, got):
        one = rt.propagate_block_ell(p, tile_rows=tr, tile_width=tw, device="cpu")
        for f in ("lb", "ub", "rounds", "converged", "infeasible"):
            np.testing.assert_array_equal(getattr(r, f).numpy(), getattr(one, f).numpy())


def test_partitioned_branch_matches_reference_pallas_path(tiny_limit):
    """Against the reference's own partitioned batch (#11, #12 in interpret
    mode)."""
    probs = [rd.make_knapsack(n=280, m=8, seed=5), rd.make_set_cover(n=270, m=25, seed=6)]
    want = rc.propagate_batch(probs, tile_rows=2, tile_width=8, use_pallas=True,
                              interpret=True, driver="host_loop")
    got = rt.propagate_batch(_port(probs), tile_rows=2, tile_width=8, device="cpu")
    _assert_matches(got, want, True)


# ---------------------------------------------------------------------------
# Drivers, convergence mask, warm starts, caches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tile_width", [128, 8])
def test_host_loop_matches_device_loop(tile_width):
    """``host_loop`` names the same device-masked loop in the port: the same
    results and the same one flag read per round."""
    probs = _port(_set2_bucket(3))
    reads = {"host_loop": 0, "device_loop": 0}

    def count(driver):
        return lambda: reads.__setitem__(driver, reads[driver] + 1)

    rh = rt.propagate_batch(probs, tile_width=tile_width, driver="host_loop", device="cpu",
                            on_sync=count("host_loop"))
    rd_ = rt.propagate_batch(probs, tile_width=tile_width, driver="device_loop", device="cpu",
                             on_sync=count("device_loop"))
    for a, b in zip(rh, rd_):
        _assert_same(a, b)
    rounds = max(int(r.rounds) for r in rd_)
    assert reads == {"host_loop": rounds, "device_loop": rounds}


def test_convergence_mask_mixed_rounds_no_leakage():
    """One-round instance + many-round cascade in ONE bucket: each converges
    to its own fixed point with its own round count, bitwise what each gets
    alone (the reference's engine and the port's)."""
    probs = [_free_problem(m=20, n=60), rd.make_cascade_chain(16)]
    assert len(rc.pack_problems(probs)) == 1
    res = rt.propagate_batch(_port(probs), device="cpu")
    assert int(res[0].rounds) == 1 and int(res[1].rounds) > 10
    assert bool(res[0].converged) and bool(res[1].converged)
    _assert_matches(res, rc.propagate_batch(probs, use_pallas=False), True)
    for p, r in zip(_port(probs), res):
        one = rt.propagate_block_ell(p, device="cpu")
        np.testing.assert_array_equal(r.lb.numpy(), one.lb.numpy())
        assert int(r.rounds) == int(one.rounds)


def test_per_instance_infeasibility_is_isolated():
    ok = rd.make_set_cover(n=30, m=10, seed=1)
    bad = rc.Problem(
        csr=rc.csr_from_coo(np.array([0]), np.array([0]), np.array([1.0]), 1, 30),
        lhs=np.full(1, 5.0),  # x0 >= 5 with ub = 1: empty domain
        rhs=np.full(1, INF),
        lb=np.zeros(30),
        ub=np.ones(30),
        is_int=np.zeros(30, dtype=bool),
    )
    res = rt.propagate_batch(_port([ok, bad]), device="cpu")
    assert not bool(res[0].infeasible) and bool(res[1].infeasible)
    _assert_matches(res, rc.propagate_batch([ok, bad], use_pallas=False), True)


def test_bounds_warm_start_matches_reference():
    """``bounds=`` warm-starts chosen instances through the same packed
    tiles (a cache hit), as the reference's."""
    probs = [rd.make_knapsack(n=60, m=20, seed=s) for s in range(3)]
    ports = _port(probs)
    rt.propagate_batch(ports, device="cpu")
    p = probs[1]
    ub = p.ub.copy()
    ub[np.flatnonzero(p.is_int)[:5]] = 0.0
    bounds = [None, (p.lb, ub), None]
    hits = cache_info()["prepare_problem_batch"]["hits"]
    got = rt.propagate_batch(ports, bounds=bounds, device="cpu")
    assert cache_info()["prepare_problem_batch"]["hits"] == hits + 1
    _assert_matches(got, rc.propagate_batch(probs, bounds=bounds, use_pallas=False), True)
    one = rt.propagate_block_ell(ports[1], lb0=p.lb, ub0=ub, device="cpu")
    np.testing.assert_array_equal(got[1].ub.numpy(), one.ub.numpy())
    with pytest.raises(ValueError):
        rt.propagate_batch(ports, bounds=[None], device="cpu")
    with pytest.raises(ValueError):
        rt.propagate_batch(ports, bounds=[None, (p.lb[:3], ub[:3]), None], device="cpu")


def test_results_unpadded_and_repeat_stable():
    """Per-instance ``(n_i,)`` results; the caches hand back the same packed
    batch, prep and runner, and repeated runs are bitwise stable (the
    in-place rounds run on private planes)."""
    tops.clear_batch_caches()
    probs = _port([rd.make_mixed(m=30, n=25, seed=1), rd.make_mixed(m=40, n=31, seed=2)])
    r1 = rt.propagate_batch(probs, device="cpu")
    assert r1[0].lb.shape == (25,) and r1[1].lb.shape == (31,)
    r2 = rt.propagate_batch(probs, device="cpu")
    for a, b in zip(r1, r2):
        _assert_same(a, b)
    info = cache_info()
    for name in ("packed_problems", "prepare_problem_batch", "batch_runner"):
        assert info[name]["hits"] >= 1 and info[name]["size"] >= 1, name


@pytest.mark.parametrize("kw,item", [
    (dict(policy="TierPolicy"), "item 5"),
    (dict(stop_progress=0.1), "item 5"),
    (dict(patience=2), "item 5"),
    (dict(telemetry=8), "item 6"),
    (dict(dtype=np.float32), "item 5"),
])
def test_options_outside_the_slice_raise(kw, item):
    """The options of items 5 and 6, ported since, run and are held to the
    reference's result (flags, tier rounds and bounds, bitwise on the
    knapsack; with telemetry the rounds the snapshot recorded)."""
    pr = rd.make_knapsack(n=20, m=8, seed=0)
    port_kw, ref_kw = dict(kw), dict(kw)
    if "policy" in kw:
        port_kw["policy"], ref_kw["policy"] = rt.core.TierPolicy(), rc.TierPolicy()
    (got,) = rt.propagate_batch(_port([pr]), device="cpu", **port_kw)
    (want,) = rc.propagate_batch([pr], use_pallas=False, **ref_kw)
    for f in ("rounds", "converged", "infeasible", "tier_rounds"):
        assert int(getattr(got, f)) == int(getattr(want, f)), f
    if "telemetry" in kw:
        assert got.telemetry.rounds_recorded == want.telemetry.rounds_recorded == int(got.rounds)
    np.testing.assert_array_equal(got.lb.double().numpy(), np.asarray(want.lb, np.float64))
    np.testing.assert_array_equal(got.ub.double().numpy(), np.asarray(want.ub, np.float64))
