"""The port's long-row combine and straddle combine on the CPU: the plain
straddle combine (``ref.straddle_combine_ref``, the CPU path of
``straddle_combine_tiles``) against ``ref.straddle_tables`` and against the
reference's straddle aggregates (``repro.kernels.ops._straddle_aggregates``,
its Pallas partials in interpret mode); the hoisted short/long split of the
combine's segments (``ref.segment_classes``); and ``propagate_nodes``,
``propagate_batch`` and ``solve`` past a shrunk ``SCATTER_MAX_NPAD`` on the
kernel-ops path against the reference.

Tolerances: bitwise (bit patterns) between the port's own plain versions,
which sum in one order; against the reference, bitwise (as values) on
integer-valued data and ``rtol=1e-12, atol=0`` on general floats (the
reference's XLA ``segment_sum`` sums in its own order); rounds, converged,
infeasible and the searches' results exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as rc
import repro.data as rd
from repro.kernels import ops as rops
import repro_torch as rt
import repro_torch.data as td
from repro_torch.kernels import ops as tops
from repro_torch.kernels import prop_round as tk
from repro_torch.kernels import ref as tref

# name: (generator, kwargs, tile, slab, integer data) -- the partitions of
# tests/test_torch_slab_kernels.py.
INSTANCES = {
    "knapsack": ("make_knapsack", dict(n=280, m=8, seed=5), (2, 8), 128, True),
    "mixed_256": ("make_mixed", dict(m=30, n=280, seed=7), (2, 8), 256, False),
}


def _t(x):
    return torch.from_numpy(np.array(x))


def _bits(x):
    return x.view(torch.int64) if x.dtype == torch.float64 else x


def _partitions(name):
    """(reference prep, reference partition, port partition, integer data)."""
    gen, kw, tile, slab, integer = INSTANCES[name]
    pr = getattr(rd, gen)(**kw)
    want = rops.prepare_block_ell(pr, *tile)
    got = rt.prepare_block_ell(rt.problem_from_reference(pr), *tile, device="cpu")
    return want, want.slab_partition(slab), got.slab_partition(slab), integer


def _partials(rng, part, nb, kind):
    """Per-copy partials ``(nb, Ta, R)`` of one kind: general floats over 16
    decades, mostly explicit zeros, or -0.0 mixed in."""
    shape = (nb, *part.a_slot.shape)
    f = lambda: rng.uniform(-1e3, 1e3, size=shape) * 10.0 ** rng.integers(-8, 9, shape)
    mf, xf = f(), f()
    if kind == "zeros":
        mf[rng.random(shape) < 0.8] = 0.0
        xf[rng.random(shape) < 0.8] = 0.0
    elif kind == "negzero":
        mf[rng.random(shape) < 0.5] = -0.0
        xf[:] = -0.0
    c = lambda: rng.integers(0, 3, size=shape).astype(np.int32)
    return tuple(map(_t, (mf, c(), xf, c())))


MASKS = {"all": None, "on": [True, True, True], "mixed": [True, False, True],
         "off": [False, False, False]}


@pytest.mark.parametrize("kind", ["float", "zeros", "negzero"])
@pytest.mark.parametrize("nb,mask", [(1, "all"), (1, "on"), (3, "all"), (3, "mixed"),
                                     (3, "off")])
@pytest.mark.parametrize("name", list(INSTANCES))
def test_straddle_combine_matches_straddle_tables(name, nb, mask, kind):
    """On every active plane and every chunk with ``row_done == 0`` the
    straddle combine equals ``straddle_tables`` bit for bit; chunks with
    ``row_done == 1`` hold the dummy slot's +0.0 and 0, inactive planes
    zeros; the CPU wrapper is the plain version."""
    rng = np.random.default_rng(17)
    _, _, part, _ = _partitions(name)
    parts = _partials(rng, part, nb, kind)
    act = None if MASKS[mask] is None else torch.tensor(MASKS[mask][:nb])
    if nb == 1:
        parts = tuple(x[0] for x in parts)
    index = (part.a_order, part.a_seg, part.agg_slot)
    got = tref.straddle_combine_ref(*parts, *index, act)
    wrapped = tk.straddle_combine_tiles(*parts, *index, act)
    tables = tref.straddle_tables(part, *parts)
    done = part.row_done == 0
    assert part.has_straddle and bool(done.any()) and bool((~done).any())
    assert torch.equal(done, part.agg_slot != 0)
    lead = (nb,) if nb > 1 else ()
    planes = range(nb) if act is None else [i for i in range(nb) if bool(act[i])]
    for g, w, t, x in zip(got, wrapped, tables, parts):
        assert g.shape == (*lead, *part.agg_slot.shape) and g.dtype == x.dtype
        assert torch.equal(_bits(g), _bits(w))
        g, t = g.reshape(nb, *done.shape), t.reshape(nb, *done.shape)
        for b in range(nb):
            if b in planes:
                assert torch.equal(_bits(g[b][done]), _bits(t[b][done]))
                assert torch.equal(_bits(g[b][~done]), _bits(torch.zeros_like(g[b][~done])))
            else:
                assert (g[b] == 0).all()


@pytest.mark.parametrize("node", [False, True], ids=["single", "nodes"])
@pytest.mark.parametrize("name", list(INSTANCES))
def test_straddle_combine_matches_reference_aggregates(name, node):
    """The port's copy partials (#11 or #13, plain versions) and straddle
    combine against the reference's ``_straddle_aggregates`` (its Pallas
    partials, interpret mode, and XLA segment sum) on the same partition
    and bounds: each chunk with ``row_done == 0`` reads its slot's entry."""
    rng = np.random.default_rng(3)
    prep_r, part_r, part, integer = _partitions(name)
    width = prep_r.n_pad
    nb = 3 if node else 1
    if integer:
        lb = rng.integers(-5, 1, size=(nb, width)).astype(np.float64)
        ub = rng.integers(0, 6, size=(nb, width)).astype(np.float64)
    else:
        lb, ub = rng.uniform(-5, 0, size=(nb, width)), rng.uniform(0, 5, size=(nb, width))
    lb[rng.random((nb, width)) < 0.1] = -rc.INF
    ub[rng.random((nb, width)) < 0.1] = rc.INF
    act = np.array([True, False, True][:nb])
    want = rops._straddle_aggregates(part_r, jnp.asarray(lb), jnp.asarray(ub),
                                     jnp.asarray(act), node=node, inf=rc.INF, interpret=True)
    if node:
        partials = tk.node_slab_partials_tiles(
            part.a_val, part.a_col_s, part.a_run_start, part.a_run_len, part.a_run_slab,
            _t(act), _t(lb), _t(ub), part.slab, part.a_max_run_len)
    else:
        partials = tk.batched_slab_partials_tiles(
            part.a_val, part.a_col_s, part.a_run_start, part.a_run_len, part.a_run_inst,
            part.a_run_slab, _t(act), _t(lb), _t(ub), part.slab, part.a_max_run_len)
    got = tk.straddle_combine_tiles(*partials, part.a_order, part.a_seg, part.agg_slot,
                                    _t(act) if node else None)
    slot = part.agg_slot.numpy()
    done = part.row_done.numpy() == 0
    for g, w in zip(got, want):
        g = g.numpy().reshape(nb, *slot.shape)
        w = np.asarray(w).reshape(nb, -1)
        for b in np.flatnonzero(act):
            expect = w[b][slot[done]]
            if integer or g.dtype.kind == "i":
                np.testing.assert_array_equal(g[b][done], expect)
            else:
                np.testing.assert_allclose(g[b][done], expect, rtol=1e-12, atol=0)


@pytest.mark.parametrize("threshold", [1, 8, tref.LONG_SEGMENT])
@pytest.mark.parametrize("fixed", [False, True], ids=["exact", "fixed_length"])
def test_segment_classes_place_every_segment_once(threshold, fixed):
    """Segments of 0, 1 and threshold -1 / threshold / +1 chunks: each lies
    in exactly one class, long exactly where it holds more than
    ``threshold`` chunks; the fixed-length form pads with -1."""
    lengths = np.array([0, 1, threshold - 1, threshold, threshold + 1, 0, threshold + 1, 1,
                        3 * threshold + 5])
    row_start = _t(np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64))
    n_chunks = int(lengths.sum())
    short, long = tref.segment_classes(row_start, threshold,
                                       n_chunks=n_chunks if fixed else None)
    assert short.dtype == long.dtype == torch.int32
    if fixed:
        assert short.numel() == lengths.size
        assert long.numel() == n_chunks // (threshold + 1)
    ids = lambda x: x[x >= 0].tolist()
    assert sorted(ids(short) + ids(long)) == list(range(lengths.size))
    assert ids(long) == np.flatnonzero(lengths > threshold).tolist()
    assert ids(short) == np.flatnonzero(lengths <= threshold).tolist()
    if fixed:
        assert (short[len(ids(short)):] == -1).all() and (long[len(ids(long)):] == -1).all()


@pytest.mark.parametrize("batch", [False, True], ids=["instance", "bucket"])
def test_prepared_segment_classes_split_the_rows(batch):
    """The split hoisted at prepare time covers every row segment once and
    agrees with the one the combine computes when given none."""
    problems = [td.make_mixed(m=60, n=120, seed=s) for s in range(2)]
    if batch:
        (packed,) = tops.packed_problems(problems, tile_width=2)
        prep = tops.prepare_problem_batch(packed, device="cpu")
    else:
        prep = rt.prepare_block_ell(problems[0], tile_width=2, device="cpu")
    chunks = prep.d.chunk_row.numel()
    length = prep.row_start[1:] - prep.row_start[:-1]
    short, long = prep.seg_classes
    assert long.numel() > 0  # rows of more than 32 chunks at tile width 2
    assert bool((length[long.long()] > tref.LONG_SEGMENT).all())
    assert bool((length[short.long()] <= tref.LONG_SEGMENT).all())
    assert short.numel() + long.numel() == length.numel()
    fixed = tref.segment_classes(prep.row_start, n_chunks=chunks)
    for hoisted, padded in zip(prep.seg_classes, fixed):
        assert torch.equal(hoisted, padded[padded >= 0])


@pytest.fixture
def tiny_budget(monkeypatch):
    """Shrink the engine limit and the slab cap to 128 in both packages, so
    small instances cross the limit and ride the partitioned engines."""
    rops.clear_prepare_cache()
    tops.clear_prepare_cache()
    for mod in (rops, tops):
        monkeypatch.setattr(mod, "SCATTER_MAX_NPAD", 128)
        monkeypatch.setattr(mod, "SLAB_NPAD", 128)
    yield
    rops.clear_prepare_cache()
    tops.clear_prepare_cache()


@pytest.fixture
def straddle_calls(monkeypatch):
    """Counts the kernel-ops path's calls of the straddle combine's plain
    version, and fails on any call of ``straddle_tables`` outside it: the
    kernel path runs no PyTorch gather of the straddle tables."""
    calls = {"straddle_combine_ref": 0}
    real = tref.straddle_combine_ref

    def counted(*args, **kw):
        calls["straddle_combine_ref"] += 1
        return real(*args, **kw)

    def forbidden(*args, **kw):
        raise AssertionError("the kernel path called straddle_tables")

    monkeypatch.setattr(tref, "straddle_combine_ref", counted)
    monkeypatch.setattr(tref, "straddle_tables", forbidden)
    return calls


def _nodes_of(root):
    lb0, ub0 = np.asarray(root.lb), np.asarray(root.ub)
    nodes_lb = np.stack([lb0, lb0.copy(), lb0.copy()])
    nodes_ub = np.stack([ub0, ub0.copy(), ub0.copy()])
    free = np.flatnonzero(root.is_int & (lb0 < ub0))
    nodes_lb[1][free[0]] = max(lb0[free[0]], 1.0)
    nodes_ub[2][free[1]] = min(ub0[free[1]], 0.0)
    return nodes_lb, nodes_ub


@pytest.mark.parametrize("gen_name,kw,tile_width,exact", [
    ("make_mixed", dict(m=25, n=260, seed=4), 128, False),
    ("make_knapsack", dict(n=200, m=10, seed=3), 8, True),
])
def test_nodes_past_the_limit_on_kernel_ops_match_reference(tiny_budget, straddle_calls,
                                                            gen_name, kw, tile_width, exact):
    root = getattr(rd, gen_name)(**kw)
    p = rt.problem_from_reference(root)
    lb, ub = _nodes_of(root)
    got = rt.propagate_nodes(p, lb, ub, tile_width=tile_width, device="cpu")
    want = rc.propagate_nodes(root, lb, ub, tile_width=tile_width, use_pallas=False)
    assert straddle_calls["straddle_combine_ref"] == int(got.rounds.max()) > 0
    for f in ("rounds", "converged", "infeasible"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
    assert rt.bounds_equal(got.lb, got.ub, np.asarray(want.lb), np.asarray(want.ub))
    for g, w in ((got.lb, want.lb), (got.ub, want.ub)):
        if exact:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12, atol=1e-12)


def test_batch_past_the_limit_on_kernel_ops_matches_reference(tiny_budget, straddle_calls):
    probs = [rd.make_knapsack(n=280, m=8, seed=5), rd.make_set_cover(n=270, m=25, seed=6)]
    got = rt.propagate_batch([rt.problem_from_reference(q) for q in probs], tile_rows=2,
                             tile_width=8, device="cpu")
    want = rc.propagate_batch(probs, tile_rows=2, tile_width=8, use_pallas=False)
    assert straddle_calls["straddle_combine_ref"] == max(int(r.rounds) for r in got) > 0
    for g, w in zip(got, want):
        for f in ("lb", "ub", "rounds", "converged", "infeasible"):
            np.testing.assert_array_equal(np.asarray(getattr(g, f)), np.asarray(getattr(w, f)))


SOLVE_FIELDS = ("status", "objective", "feasible", "nodes_expanded", "nodes_created", "leaves",
                "pruned_bound", "pruned_infeasible", "levels", "host_syncs",
                "incumbent_trajectory")


@pytest.mark.parametrize("seed,kw", [(1, dict(node_cap=32)),
                                     (1, dict(node_cap=32, expand_width=2, max_levels=8,
                                              sync_every=3))])
def test_solve_past_the_limit_on_kernel_ops_matches_reference(tiny_budget, straddle_calls,
                                                              seed, kw):
    pr = rd.make_pseudo_boolean(n=200, m=260, seed=seed)
    c = np.arange(1, pr.n + 1, dtype=np.float64) * np.where(np.arange(pr.n) % 3 == 0, -1.0, 1.0)
    want = rc.solve(pr, c, use_pallas=False, **kw)
    got = rt.solve(rt.problem_from_reference(pr), c, device="cpu", **kw)
    assert straddle_calls["straddle_combine_ref"] > 0
    for f in SOLVE_FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    if want.x is None:
        assert got.x is None
    else:
        np.testing.assert_array_equal(got.x, want.x)
