"""Kernel D and F under the kept-plane contract, on the CPU (where the
wrappers run their plain versions through the same ownership logic as on
the card): D (and E) fold into the accumulator planes the round closure
keeps for its whole fixed point, F hands every entry back at the
sentinels, the closure's planes are clean after every round, and the
fixed points still match the reference's ``propagate_block_ell`` (Pallas
kernels in interpret mode).  Also the order argument of D's packed lane
groups: a chunk of at most G slots summed by a G-lane butterfly equals
``ref.warp_order_sum`` over its K = 128 slots.

Contract: bounds bitwise (as values) on integer-valued data, ``rtol=1e-12``
on general floats against the reference (another summation order),
bitwise between the kernel and plain paths of the port; rounds, converged,
infeasible and flags exact.
"""
import numpy as np
import pytest
import torch

import repro.data as rd
import repro.kernels as rk
import repro_torch as rt
from repro_torch.core import INF
from repro_torch.kernels import (
    accumulator_planes,
    apply_updates_tiles,
    candidates_scatter_tiles,
    fused_scatter_round_tiles,
    ops as tops,
    ref as tref,
)

from test_torch_propagator import assert_results_match

EPS, INT_EPS = 1e-9, 1e-6


def _t(x):
    return torch.from_numpy(np.array(x))


def _is_clean(acc) -> bool:
    return bool((acc[0] == -INF).all() and (acc[1] == INF).all())


def _prep(gen, kw, tile_width):
    p = rt.problem_from_reference(getattr(rd, gen)(**kw))
    return rt.prepare_block_ell(p, tile_width=tile_width, device="cpu")


# ---------------------------------------------------------------------------
# The plain D and E fold into the planes; F hands them back
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("form", ["wrapper", "plain_ops"])
def test_plain_fused_folds_into_the_planes(form):
    """D's plain version scatters into the planes it is given: clean planes
    end as the oracle's result (the pair itself is returned), a dirty entry
    (a plane not handed back) shows in the result, and without planes a
    fresh pair comes back."""
    prep = _prep("make_knapsack", dict(n=40, m=10, seed=2), 64)
    assert prep.fits_one_chunk
    d = prep.d
    args = (d.val, d.col, prep.ii_g, prep.lhs_g, prep.rhs_g, prep.lb0, prep.ub0, prep.n_pad,
            INT_EPS)
    fused = fused_scatter_round_tiles if form == "wrapper" else tops.PLAIN_OPS.fused
    hoisted = dict(chunk_len=prep.chunk_len, max_chunk_len=prep.max_chunk_len)
    want = tref.fused_scatter_round_tiles_ref(*args)
    acc = accumulator_planes(prep.lb0)
    got = fused(*args, acc=acc, **hoisted)
    assert got[0] is acc[0] and got[1] is acc[1]
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    fresh = fused(*args)
    assert torch.equal(fresh[0], want[0]) and torch.equal(fresh[1], want[1])
    dirty = accumulator_planes(prep.lb0)
    dirty[0][:] = INF / 2
    fused(*args, acc=dirty, **hoisted)
    assert not torch.equal(dirty[0], want[0])


@pytest.mark.parametrize("form", ["wrapper", "plain_ops"])
def test_plain_candidates_fold_into_the_planes(form):
    """E's plain version does the same on rows that span chunks."""
    prep = _prep("make_mixed", dict(m=60, n=45, seed=21), 16)
    assert not prep.fits_one_chunk
    d = prep.d
    partials = tref.activities_gather_tiles_ref(d.val, d.col, prep.lb0, prep.ub0, prep.n_pad)
    aggs = tref.combine_chunk_partials_ref(*partials, d.chunk_row, prep.row_start)
    args = (d.val, d.col, prep.ii_g, *aggs, prep.lhs_g, prep.rhs_g, prep.lb0, prep.ub0,
            prep.n_pad, INT_EPS)
    cands = candidates_scatter_tiles if form == "wrapper" else tops.PLAIN_OPS.candidates
    want = tref.candidates_scatter_tiles_ref(*args)
    acc = accumulator_planes(prep.lb0)
    got = cands(*args, chunk_len=prep.chunk_len, acc=acc)
    assert got[0] is acc[0] and got[1] is acc[1]
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    dirty = accumulator_planes(prep.lb0)
    dirty[1][:] = -INF / 2
    cands(*args, acc=dirty)
    assert not torch.equal(dirty[1], want[1])


@pytest.mark.parametrize("exact", [True, False], ids=["int", "float"])
@pytest.mark.parametrize("form", ["wrapper", "plain_ops"])
def test_merge_hands_every_entry_back(form, exact):
    """F (its CPU branch and ``PLAIN_OPS.merge``) sets every accumulator
    entry back to the sentinels once read; its merge is the reference's."""
    from repro.core import bounds as rbnd

    rng = np.random.default_rng(4)
    n_pad = 384
    if exact:
        lb = rng.integers(-5, 1, n_pad).astype(np.float64)
        ub = rng.integers(0, 6, n_pad).astype(np.float64)
        bl = rng.integers(-6, 3, n_pad).astype(np.float64)
        bu = rng.integers(-2, 7, n_pad).astype(np.float64)
    else:
        lb, ub = rng.uniform(-5, 0, n_pad), rng.uniform(0, 5, n_pad)
        bl, bu = rng.uniform(-6, 2, n_pad), rng.uniform(-2, 6, n_pad)
    bl[rng.random(n_pad) < 0.3] = -INF
    bu[rng.random(n_pad) < 0.3] = INF
    want = rbnd.apply_updates(lb, ub, bl, bu, EPS)
    best = (_t(bl), _t(bu))
    if form == "wrapper":
        got = apply_updates_tiles(_t(lb), _t(ub), *best, EPS)
    else:
        got = tops.PLAIN_OPS.merge(_t(lb), _t(ub), *best, EPS, INF)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert _is_clean(best)


# ---------------------------------------------------------------------------
# The round closure's planes, round after round
# ---------------------------------------------------------------------------

# (generator, kwargs): pb-, banded- and mixed-like instances of a few hundred
# rows; each runs at K = 16 and K = 128 (mixed's long rows span chunks at
# both, the others' fit one chunk).
ROUND_CASES = {
    "pb": ("make_pseudo_boolean", dict(n=300, m=400, seed=7)),
    "banded": ("make_banded", dict(n=600, m=300, row_nnz=12, band=80, seed=1)),
    "mixed": ("make_mixed", dict(m=300, n=200, seed=3, density=0.02)),
}


@pytest.mark.parametrize("tile_width", [16, 128])
@pytest.mark.parametrize("name", list(ROUND_CASES))
def test_prepared_round_keeps_its_planes_clean(name, tile_width):
    """D or E scatters into the closure's kept planes and F hands them back:
    after every round the planes hold the sentinels, and the kernel path
    equals the plain path (which keeps its own planes) bitwise."""
    gen, kw = ROUND_CASES[name]
    prep = _prep(gen, kw, tile_width)
    assert prep.fits_one_chunk == (name != "mixed")
    round_fn = tops.round_fn_for(prep)
    plain_fn = tops.round_fn_for(prep, use_kernels=False)
    lb, ub = prep.lb0.clone(), prep.ub0.clone()
    plb, pub = lb.clone(), ub.clone()
    changed = True
    rounds = 0
    while changed and rounds < 30:
        lb, ub, ch = round_fn(lb, ub)
        plb, pub, pch = plain_fn(plb, pub)
        assert torch.equal(lb, plb) and torch.equal(ub, pub) and bool(ch) == bool(pch)
        assert _is_clean(round_fn.kept.planes) and _is_clean(plain_fn.kept.planes)
        assert round_fn.kept.planes[0].shape == (prep.n_pad,)
        changed, rounds = bool(ch), rounds + 1
    assert rounds > 1


# (generator, kwargs, tile_width, exact)
FIXED_POINTS = [
    ("make_set_cover", dict(n=60, m=30, seed=3), 32, True),
    ("make_set_cover", dict(n=60, m=30, seed=3), 4, True),
    ("make_knapsack", dict(n=40, m=6, seed=5), 128, True),
    ("make_knapsack", dict(n=40, m=6, seed=5), 8, True),
    ("make_cascade_chain", dict(length=16), 4, True),
    ("make_mixed", dict(m=60, n=45, seed=21), 128, False),
    ("make_mixed", dict(m=60, n=45, seed=21), 16, False),
    ("make_banded", dict(n=600, m=300, row_nnz=12, band=80, seed=1), 16, False),
]


@pytest.mark.parametrize("gen,kw,tile_width,exact", FIXED_POINTS,
                         ids=[f"{g}-K{k}" for g, _, k, _ in FIXED_POINTS])
def test_fixed_points_with_kept_planes_match_reference(monkeypatch, gen, kw, tile_width,
                                                       exact):
    """``propagate_block_ell`` (its round closure keeping D's or E's planes,
    F handing them back) against the reference's, whose Pallas kernels run
    in interpret mode; the closure's planes are clean at the end."""
    closures = []
    real = tops.round_fn_for

    def spy(*args, **kwargs):
        closures.append(real(*args, **kwargs))
        return closures[-1]

    monkeypatch.setattr(tops, "round_fn_for", spy)
    pr = getattr(rd, gen)(**kw)
    want = rk.propagate_block_ell(pr, tile_width=tile_width)
    got = rt.propagate_block_ell(rt.problem_from_reference(pr), tile_width=tile_width,
                                 device="cpu")
    assert_results_match(got, want, exact)
    (round_fn,) = closures
    assert round_fn.kept.planes is not None and _is_clean(round_fn.kept.planes)


# ---------------------------------------------------------------------------
# D's packed lane groups sum in ref.warp_order_sum's order
# ---------------------------------------------------------------------------


def _packed_sum(row, g):
    """D's row sum of a chunk with a group of ``g`` lanes: lane l adds slot
    l to 0.0 (every slot lies below g), then xor shuffles with offsets
    g/2, ..., 2, 1 over the group."""
    lanes = [0.0] * g
    for j, v in enumerate(row):
        if v != 0.0:
            assert j < g
            lanes[j] = lanes[j] + v
    off = g // 2
    while off:
        lanes = [lanes[i] + lanes[i ^ off] for i in range(g)]
        off //= 2
    return lanes[0]


@pytest.mark.parametrize("g", [1, 2, 4, 8, 16, 32])
def test_packed_butterfly_is_warp_order_sum(g):
    """A chunk no longer than G (lengths 0, 1, G - 1 and G) of K = 128 slots
    summed by the G-lane butterfly equals ``ref.warp_order_sum``, on general
    floats spread over many magnitudes (where another order rounds
    otherwise)."""
    rng = np.random.default_rng(g)
    k = 128
    lengths = sorted({0, 1, g - 1, g})
    x = np.zeros((len(lengths) * 8, k))
    for i, n in enumerate(np.repeat(lengths, 8)):
        x[i, :n] = rng.standard_normal(n) * 10.0 ** rng.integers(-8, 9, size=n)
    got = tref.warp_order_sum(torch.from_numpy(x)).numpy()
    want = np.array([_packed_sum(row, g) for row in x])
    np.testing.assert_array_equal(got, want)
