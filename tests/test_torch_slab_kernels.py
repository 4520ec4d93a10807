"""The plain versions of the port's slab kernels (#11 and #13 partials, #12
and #14 rounds, #15 window merge) against the reference's Pallas kernels in
interpret mode on the CPU, on the same partitions (byte-identical, see
``test_torch_slab.py``); the port's ``partitioned_round_ref`` and
``node_partitioned_round_ref`` against the reference's; and the straddle
combine against a numpy left-to-right sum.

Tolerances: bitwise (as values) on integer-valued data; on general floats
``rtol=1e-12, atol=0`` for float outputs, because the plain versions sum in
the CUDA kernels' order and the reference in its own.  Counts, flags and the
rows of inactive planes are exact everywhere.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.data as rd
from repro.core import INF
from repro.kernels import ops as rops
from repro.kernels import prop_round as rkern
from repro.kernels import ref as rref
import repro_torch as rt
from repro_torch.kernels import (
    accumulator_planes,
    apply_updates_slab_tiles,
    batched_slab_partials_tiles,
    batched_slab_round_tiles,
    launch_counts,
    node_slab_partials_tiles,
    node_slab_round_tiles,
    reset_launch_counts,
)
from repro_torch.kernels import ref as tref
from repro_torch.kernels import slab as tslab

EPS, INT_EPS = 1e-9, 1e-6

# name: (generator, kwargs, tile, slab, integer data)
INSTANCES = {
    # Every row of the knapsack straddles every slab boundary and spans
    # chunks; integer data.
    "knapsack": ("make_knapsack", dict(n=280, m=8, seed=5), (2, 8), 128, True),
    "mixed": ("make_mixed", dict(m=30, n=280, seed=0), (4, 16), 128, False),
    "mixed_256": ("make_mixed", dict(m=30, n=280, seed=7), (2, 8), 256, False),
}
MASKS = ["on", "off", "mixed"]


def _j(x):
    return jnp.asarray(np.asarray(x))


def _t(x):
    return torch.from_numpy(np.array(x))


def _mask(bsz, kind):
    if kind == "on":
        return np.ones(bsz, bool)
    if kind == "off":
        return np.zeros(bsz, bool)
    act = np.zeros(bsz, bool)
    act[::2] = True
    return act


def _planes(rng, bsz, width, integer, inf_frac=0.1):
    if integer:
        lb = rng.integers(-5, 1, size=(bsz, width)).astype(np.float64)
        ub = rng.integers(0, 6, size=(bsz, width)).astype(np.float64)
    else:
        lb = rng.uniform(-5, 0, size=(bsz, width))
        ub = rng.uniform(0, 5, size=(bsz, width))
    lb[rng.random((bsz, width)) < inf_frac] = -INF
    ub[rng.random((bsz, width)) < inf_frac] = INF
    return lb, ub


def _match(got, want, exact):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (got.dtype, want.dtype)
    if exact or got.dtype.kind in "ib":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


def _partitions(name):
    """(reference partition, port partition, integer data) of one instance."""
    gen, kw, tile, slab, integer = INSTANCES[name]
    pr = getattr(rd, gen)(**kw)
    want = rops.prepare_block_ell(pr, *tile).slab_partition(slab)
    got = rt.prepare_block_ell(rt.problem_from_reference(pr), *tile, device="cpu")
    return want, got.slab_partition(slab), integer


def _batched_partitions():
    """Three packed instances: (reference partition, port partition)."""
    problems = [rd.make_mixed(m=25, n=260, seed=s) for s in range(3)]
    (batch,) = rops.packed_problems(problems, 4, 32)
    prep = rops.prepare_problem_batch(batch)
    ell = batch.ell
    got = tslab.build_slab_partition(
        np.asarray(ell.val), ell.col, ell.chunk_row, ell.tile_inst, batch.lhs1, batch.rhs1,
        batch.is_int, prep.n_pad, 128, (ell.row_offset[1:] - 1).astype(np.int32),
    )
    return prep.slab_partition(128), got


def _case(name):
    if name == "batched":
        want, got = _batched_partitions()
        return want, got, False
    return _partitions(name)


def _aggs(rng, part, lead, integer):
    """Straddle aggregates per main-stream chunk: what the engine passes the
    round kernels where ``row_done == 0`` (any values elsewhere)."""
    shape = (*lead, *part.chunk_row.shape)
    if integer:
        f = lambda: rng.integers(-20, 21, size=shape).astype(np.float64)
    else:
        f = lambda: rng.uniform(-20, 20, size=shape)
    c = lambda: rng.integers(0, 3, size=shape).astype(np.int32)
    return f(), c(), f(), c()


# ---------------------------------------------------------------------------
# #11 / #12: the batched (and single-instance) slab kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", MASKS)
@pytest.mark.parametrize("name", list(INSTANCES) + ["batched"])
def test_slab_partials_match_pallas(name, kind):
    rng = np.random.default_rng(1)
    want_p, part, integer = _case(name)
    bsz = part.batch
    lb, ub = _planes(rng, bsz, part.n_pad_part, integer)
    act = _mask(bsz, kind)
    want = rkern.batched_slab_partials_tiles(
        want_p.a_val, want_p.a_col_s, want_p.a_run_start, want_p.a_run_len, want_p.a_run_inst,
        want_p.a_run_slab, _j(act), _j(lb), _j(ub), want_p.slab, want_p.a_max_run_len, INF,
        interpret=True,
    )
    reset_launch_counts()
    got = batched_slab_partials_tiles(
        part.a_val, part.a_col_s, part.a_run_start, part.a_run_len, part.a_run_inst,
        part.a_run_slab, _t(act), _t(lb), _t(ub), part.slab, part.a_max_run_len,
    )
    assert set(launch_counts().values()) == {0}  # CPU tensors launch nothing
    for g, w in zip(got, want):
        _match(g, w, integer)
    off = ~act[part.a_tile_inst.numpy()]
    assert all((g.numpy()[off] == 0).all() for g in got)


@pytest.mark.parametrize("kind", MASKS)
@pytest.mark.parametrize("name", list(INSTANCES) + ["batched"])
def test_slab_round_matches_pallas(name, kind):
    rng = np.random.default_rng(2)
    want_p, part, integer = _case(name)
    bsz = part.batch
    lb, ub = _planes(rng, bsz, part.n_pad_part, integer)
    act = _mask(bsz, kind)
    aggs = _aggs(rng, part, (), integer)
    want = rkern.batched_slab_round_tiles(
        want_p.val, want_p.col_s, want_p.ii_g, want_p.row_done, *map(_j, aggs), want_p.lhs_g,
        want_p.rhs_g, want_p.run_start, want_p.run_len, want_p.run_inst, want_p.run_slab,
        _j(act), _j(lb), _j(ub), want_p.slab, want_p.max_run_len, EPS, INT_EPS, INF,
        interpret=True,
    )
    tlb, tub = _t(lb), _t(ub)
    acc = accumulator_planes(tlb)
    got = batched_slab_round_tiles(
        part.val, part.col_s, part.ii_g, part.row_done, *map(_t, aggs), part.lhs_g,
        part.rhs_g, part.run_start, part.run_len, part.run_inst, part.run_slab, _t(act), tlb,
        tub, part.slab, part.max_run_len, EPS, INT_EPS, acc=acc,
        tiles=(part.tile_inst, part.tile_slab), chunk_len=part.chunk_len,
    )
    assert got[0] is tlb and got[1] is tub  # in place
    # The merge hands the accumulator planes back at the sentinels.
    assert (acc[0] == -INF).all() and (acc[1] == INF).all()
    for g, w in zip(got, want):
        _match(g, w, integer)
    np.testing.assert_array_equal(tlb.numpy()[~act], lb[~act])
    assert got[2].shape == (bsz * part.n_slabs,)


@pytest.mark.parametrize("name", ["knapsack", "mixed"])
def test_slab_round_on_planes_of_width_n_pad(name):
    """The port's kernels also take ``(B, n_pad)`` planes, no padding to
    the slab grid: the same result as the reference's on zero-padded planes,
    sliced back."""
    rng = np.random.default_rng(3)
    gen, kw, tile, _, integer = INSTANCES[name]
    slab = 256  # two slabs over n_pad = 384: the planes end inside the last
    pr = getattr(rd, gen)(**kw)
    want_p = rops.prepare_block_ell(pr, *tile).slab_partition(slab)
    prep = rt.prepare_block_ell(rt.problem_from_reference(pr), *tile, device="cpu")
    part = prep.slab_partition(slab)
    assert prep.n_pad < part.n_pad_part
    lb, ub = _planes(rng, 1, prep.n_pad, integer)
    pad = lambda x: np.pad(x, ((0, 0), (0, part.n_pad_part - prep.n_pad)))
    act = np.ones(1, bool)
    aggs = _aggs(rng, part, (), integer)
    want = rkern.batched_slab_round_tiles(
        want_p.val, want_p.col_s, want_p.ii_g, want_p.row_done, *map(_j, aggs), want_p.lhs_g,
        want_p.rhs_g, want_p.run_start, want_p.run_len, want_p.run_inst, want_p.run_slab,
        _j(act), _j(pad(lb)), _j(pad(ub)), slab, want_p.max_run_len, EPS, INT_EPS, INF,
        interpret=True,
    )
    tlb = _t(lb)
    got = batched_slab_round_tiles(
        part.val, part.col_s, part.ii_g, part.row_done, *map(_t, aggs), part.lhs_g,
        part.rhs_g, part.run_start, part.run_len, part.run_inst, part.run_slab, _t(act),
        tlb, _t(ub), slab, part.max_run_len, EPS, INT_EPS, acc=accumulator_planes(tlb),
        tiles=(part.tile_inst, part.tile_slab),
    )
    _match(got[0], np.asarray(want[0])[:, : prep.n_pad], integer)
    _match(got[1], np.asarray(want[1])[:, : prep.n_pad], integer)
    _match(got[2], want[2], True)
    partials = batched_slab_partials_tiles(
        part.a_val, part.a_col_s, part.a_run_start, part.a_run_len, part.a_run_inst,
        part.a_run_slab, _t(act), _t(lb), _t(ub), slab, part.a_max_run_len,
    )
    want_a = rkern.batched_slab_partials_tiles(
        want_p.a_val, want_p.a_col_s, want_p.a_run_start, want_p.a_run_len,
        want_p.a_run_inst, want_p.a_run_slab, _j(act), _j(pad(lb)), _j(pad(ub)), slab,
        want_p.a_max_run_len, INF, interpret=True,
    )
    for g, w in zip(partials, want_a):
        _match(g, w, integer)


# ---------------------------------------------------------------------------
# #13 / #14: the node slab kernels (one instance, B planes)
# ---------------------------------------------------------------------------

NODE_BATCHES = [(1, "on"), (1, "off"), (3, "on"), (3, "off"), (3, "mixed")]


@pytest.mark.parametrize("bsz,kind", NODE_BATCHES)
@pytest.mark.parametrize("name", list(INSTANCES))
def test_node_slab_partials_match_pallas(name, bsz, kind):
    rng = np.random.default_rng(4)
    want_p, part, integer = _partitions(name)
    lb, ub = _planes(rng, bsz, part.n_pad_part, integer)
    act = _mask(bsz, kind)
    want = rkern.node_slab_partials_tiles(
        want_p.a_val, want_p.a_col_s, want_p.a_run_start, want_p.a_run_len, want_p.a_run_slab,
        _j(act), _j(lb), _j(ub), want_p.slab, want_p.a_max_run_len, INF, interpret=True,
    )
    got = node_slab_partials_tiles(
        part.a_val, part.a_col_s, part.a_run_start, part.a_run_len, part.a_run_slab, _t(act),
        _t(lb), _t(ub), part.slab, part.a_max_run_len,
    )
    for g, w in zip(got, want):
        _match(g, w, integer)
        assert (g.numpy()[~act] == 0).all()


@pytest.mark.parametrize("bsz,kind", NODE_BATCHES)
@pytest.mark.parametrize("name", list(INSTANCES))
def test_node_slab_round_matches_pallas(name, bsz, kind):
    rng = np.random.default_rng(5)
    want_p, part, integer = _partitions(name)
    lb, ub = _planes(rng, bsz, part.n_pad_part, integer)
    act = _mask(bsz, kind)
    aggs = _aggs(rng, part, (bsz,), integer)
    want = rkern.node_slab_round_tiles(
        want_p.val, want_p.col_s, want_p.ii_g, want_p.row_done, *map(_j, aggs), want_p.lhs_g,
        want_p.rhs_g, want_p.run_start, want_p.run_len, want_p.run_slab, _j(act), _j(lb),
        _j(ub), want_p.slab, want_p.max_run_len, EPS, INT_EPS, INF, interpret=True,
    )
    tlb, tub = _t(lb), _t(ub)
    acc = accumulator_planes(tlb)
    got = node_slab_round_tiles(
        part.val, part.col_s, part.ii_g, part.row_done, *map(_t, aggs), part.lhs_g,
        part.rhs_g, part.run_start, part.run_len, part.run_slab, _t(act), tlb, tub, part.slab,
        part.max_run_len, EPS, INT_EPS, acc=acc, tile_slab=part.tile_slab,
        chunk_len=part.chunk_len,
    )
    assert got[0] is tlb and got[1] is tub
    assert (acc[0] == -INF).all() and (acc[1] == INF).all()  # handed back by #15
    for g, w in zip(got, want):
        _match(g, w, integer)
    np.testing.assert_array_equal(tlb.numpy()[~act], lb[~act])
    assert not got[2].numpy()[~act].any()


# ---------------------------------------------------------------------------
# #15: the window merge
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("exact", [True, False], ids=["int", "float"])
@pytest.mark.parametrize("bsz,kind", [(1, "on"), (2, "mixed"), (3, "off"), (3, "on")])
def test_window_merge_matches_pallas(bsz, kind, exact):
    rng = np.random.default_rng(6)
    width = 512
    lb, ub = _planes(rng, bsz, width, exact, inf_frac=0.0)
    bl, bu = _planes(rng, bsz, width, exact, inf_frac=0.2)
    bl, bu = bl - 1.0, bu + 1.0
    act = _mask(bsz, kind)
    want = rkern.apply_updates_slab_tiles(
        _j(lb), _j(ub), _j(bl), _j(bu), _j(act), slab=128, eps=EPS, interpret=True,
    )
    tlb, tub = _t(lb), _t(ub)
    got = apply_updates_slab_tiles(tlb, tub, _t(bl), _t(bu), _t(act), 128, EPS)
    assert got[0] is tlb and got[1] is tub
    for g, w in zip(got, want):
        _match(g, w, True)
    # The per-window flags: one per (row, slab), OR-ed to the row's flag.
    _, _, flags = tref.apply_updates_slab_ref(_t(lb), _t(ub), _t(bl), _t(bu), _t(act), 128, EPS)
    assert flags.shape == (bsz, 4) and flags.dtype == torch.int32
    np.testing.assert_array_equal(flags.numpy().any(axis=1), np.asarray(want[2]))


def test_window_merge_outward_and_ragged_width():
    """``outward`` widens accepted tightenings as ``bounds.apply_updates``
    does, and a width that is no multiple of the slab flags its last,
    partial window."""
    rng = np.random.default_rng(7)
    lb, ub = _planes(rng, 2, 300, False, inf_frac=0.0)
    bl, bu = lb + rng.uniform(-1, 1, lb.shape), ub + rng.uniform(-1, 1, ub.shape)
    act = np.ones(2, bool)
    new_lb, new_ub, flags = tref.apply_updates_slab_ref(
        _t(lb), _t(ub), _t(bl), _t(bu), _t(act), 128, EPS, INF, 1e-7
    )
    for i in range(2):
        w_lb, w_ub, _ = rops.bnd.apply_updates(_j(lb[i]), _j(ub[i]), _j(bl[i]), _j(bu[i]), EPS,
                                               INF, 1e-7)
        _match(new_lb[i], w_lb, True)
        _match(new_ub[i], w_ub, True)
    took = (new_lb.numpy() != lb) | (new_ub.numpy() != ub)
    assert flags.shape == (2, 3)
    np.testing.assert_array_equal(flags.numpy()[:, 2], took[:, 256:].any(axis=1))


# ---------------------------------------------------------------------------
# The partitioned oracles and the straddle combine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(INSTANCES) + ["batched"])
def test_partitioned_round_ref_matches_reference(name):
    rng = np.random.default_rng(8)
    want_p, part, integer = _case(name)
    n_pad = part.n_pad_part - 100  # planes narrower than the slab grid
    lb, ub = _planes(rng, part.batch, n_pad, integer)
    want = rref.partitioned_round_ref(want_p, _j(lb), _j(ub), INT_EPS)
    got = tref.partitioned_round_ref(part, _t(lb), _t(ub), INT_EPS)
    for g, w in zip(got, want):
        _match(g, w, integer)


@pytest.mark.parametrize("name", list(INSTANCES))
def test_node_partitioned_round_ref_matches_reference(name):
    rng = np.random.default_rng(9)
    want_p, part, integer = _partitions(name)
    lb, ub = _planes(rng, 3, part.n_pad_part, integer)
    want = rref.node_partitioned_round_ref(want_p, _j(lb), _j(ub), INT_EPS)
    got = tref.node_partitioned_round_ref(part, _t(lb), _t(ub), INT_EPS)
    for g, w in zip(got, want):
        _match(g, w, integer)
    act = _mask(3, "mixed")
    got_m = tref.node_partitioned_round_ref(part, _t(lb), _t(ub), INT_EPS, active=_t(act))
    for g, w in zip(got_m, got):
        np.testing.assert_array_equal(g.numpy()[act], w.numpy()[act])
        assert (np.abs(g.numpy()[~act]) == INF).all()


@pytest.mark.parametrize("nb", [1, 3])
@pytest.mark.parametrize("name", ["knapsack", "mixed_256"])
def test_straddle_combine_is_a_left_to_right_sum(name, nb):
    """Each straddle row's aggregate is its copies' partials summed from 0
    in ascending sub-stream position, bitwise, on general floats."""
    rng = np.random.default_rng(10)
    _, part, _ = _partitions(name)
    ta, r = part.a_slot.shape
    mf = rng.uniform(-1e3, 1e3, size=(nb, ta, r)) * 10.0 ** rng.integers(-8, 9, (nb, ta, r))
    xf = rng.uniform(-1e3, 1e3, size=(nb, ta, r))
    mc = rng.integers(0, 3, size=(nb, ta, r)).astype(np.int32)
    xc = rng.integers(0, 3, size=(nb, ta, r)).astype(np.int32)
    got = tref.straddle_tables(part, *map(_t, (mf, mc, xf, xc)))
    slot = part.a_slot.numpy().reshape(-1)
    agg = part.agg_slot.numpy()
    done = part.row_done.numpy() != 0
    for x, g in zip((mf, mc, xf, xc), got):
        assert g.shape == (nb, *agg.shape) and g.dtype == _t(x).dtype
        for b in range(nb):
            flat = x[b].reshape(-1)
            table = np.zeros(part.n_straddle + 1, dtype=x.dtype)
            for i in range(slot.size):  # ascending position, left to right
                table[slot[i]] = table[slot[i]] + flat[i]
            np.testing.assert_array_equal(g.numpy()[b][~done], table[agg[~done]])
    # Rows without a leading plane axis give the same tables.
    one = tref.straddle_tables(part, *(_t(x[0]) for x in (mf, mc, xf, xc)))
    for g, o in zip(got, one):
        np.testing.assert_array_equal(g.numpy()[0], o.numpy())
