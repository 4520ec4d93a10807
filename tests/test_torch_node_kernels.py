"""The plain versions of the port's node-batch and solver kernels (#10 node
round, #9 batched merge, #16 node objective) against the reference's Pallas
kernels in interpret mode on the CPU, and the solver's selection oracles and
slot planner against the reference's.

Tolerances: bitwise (as values) on integer-valued data; on general floats
``rtol=1e-12, atol=0`` for float outputs, because the plain versions sum in
the CUDA kernels' order and the reference in its own.  Flags, masks, counts,
selected columns and the rows of inactive nodes are exact everywhere.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import INF
from repro.core import solver as rsolver
from repro.kernels import (
    apply_updates_batch_tiles as r_merge_batch,
    node_fused_scatter_round_tiles as r_node_round,
    node_objective_tiles as r_node_objective,
)
from repro.kernels import ref as rref
from repro_torch.core import solver as tsolver
from repro_torch.kernels import (
    accumulator_planes,
    apply_updates_batch_tiles,
    launch_counts,
    node_activities_gather_tiles,
    node_candidates_scatter_tiles,
    node_combine_chunk_partials_tiles,
    node_fused_scatter_round_tiles,
    node_objective_tiles,
    ref as tref,
    reset_launch_counts,
)

SHAPES = [(1, 2, 4, 3), (3, 4, 8, 20), (2, 8, 16, 150)]
# (B, mask): all on, all off, mixed.
BATCHES = [(1, "on"), (3, "off"), (3, "mixed"), (5, "mixed"), (5, "on")]


def _j(x):
    return jnp.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _mask(rng, bsz, kind):
    if kind == "on":
        return np.ones(bsz, bool)
    if kind == "off":
        return np.zeros(bsz, bool)
    act = rng.random(bsz) < 0.5
    act[0], act[-1] = True, False
    return act


def _planes(rng, bsz, n_pad, integer, inf_frac=0.15):
    if integer:
        lb = rng.integers(-5, 1, size=(bsz, n_pad)).astype(np.float64)
        ub = rng.integers(0, 6, size=(bsz, n_pad)).astype(np.float64)
    else:
        lb = rng.uniform(-5, 0, size=(bsz, n_pad))
        ub = rng.uniform(0, 5, size=(bsz, n_pad))
    lb[rng.random((bsz, n_pad)) < inf_frac] = -INF
    ub[rng.random((bsz, n_pad)) < inf_frac] = INF
    return lb, ub


def _tiles(rng, t, r, k, n, integer):
    val = rng.choice([-2.0, -1.0, 0.0, 1.0, 3.0], size=(t, r, k))
    col = rng.integers(0, n, size=(t, r, k)).astype(np.int32)
    col[val == 0] = 0
    if integer:
        lhs = rng.integers(-10, 1, size=(t, r)).astype(np.float64)
        rhs = rng.integers(0, 11, size=(t, r)).astype(np.float64)
    else:
        lhs, rhs = rng.uniform(-10, 0, size=(t, r)), rng.uniform(0, 10, size=(t, r))
    lhs[rng.random((t, r)) < 0.15] = -INF
    rhs[rng.random((t, r)) < 0.15] = INF
    ii = (rng.random((t, r, k)) < 0.5).astype(np.int32)
    ii[val == 0] = 0
    return val, col, ii, lhs, rhs


def _assert_match(got, want, exact):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if exact or got.dtype.kind in "ib":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


@pytest.mark.parametrize("exact", [True, False], ids=["int", "float"])
@pytest.mark.parametrize("bsz,kind", BATCHES)
@pytest.mark.parametrize("t,r,k,n", SHAPES)
def test_node_round_matches_pallas(t, r, k, n, bsz, kind, exact, rng):
    from repro.kernels import col_pad

    n_pad = col_pad(n)
    val, col, ii, lhs, rhs = _tiles(rng, t, r, k, n, exact)
    lb, ub = _planes(rng, bsz, n_pad, exact)
    act = _mask(rng, bsz, kind)
    want = r_node_round(
        _j(val), _j(col), _j(ii), _j(lhs), _j(rhs), _j(lb), _j(ub), _j(act), n_pad,
        int_eps=1e-6, interpret=True,
    )
    reset_launch_counts()
    tlb = _t(lb)
    acc = accumulator_planes(tlb)
    got = node_fused_scatter_round_tiles(
        _t(val), _t(col), _t(ii), _t(lhs), _t(rhs), tlb, _t(ub), _t(act), n_pad,
        int_eps=1e-6, acc=acc,
    )
    assert got[0] is acc[0] and got[1] is acc[1]  # scattered into the planes given
    assert set(launch_counts().values()) == {0}  # CPU tensors launch nothing
    for g, w in zip(got, want):
        _assert_match(g, w, exact)
        # Inactive nodes' rows are the sentinel identities, exactly.
        assert np.all(np.abs(g.numpy()[~act]) == INF)


@pytest.mark.parametrize("exact", [True, False], ids=["int", "float"])
@pytest.mark.parametrize("bsz,kind", BATCHES)
def test_batched_merge_matches_pallas(bsz, kind, exact, rng):
    n_pad = 256
    lb, ub = _planes(rng, bsz, n_pad, exact, inf_frac=0.0)
    bl, bu = _planes(rng, bsz, n_pad, exact, inf_frac=0.2)
    bl, bu = bl - 1.0, bu + 1.0
    act = _mask(rng, bsz, kind)
    want = r_merge_batch(_j(lb), _j(ub), _j(bl), _j(bu), _j(act), eps=1e-9, interpret=True)
    tlb, tub = _t(lb), _t(ub)
    got = apply_updates_batch_tiles(tlb, tub, _t(bl), _t(bu), _t(act), eps=1e-9)
    assert got[0] is tlb and got[1] is tub  # the merge is in place
    for g, w in zip(got, want):
        _assert_match(g, w, True)
    # Inactive rows pass through bit for bit and report unchanged.
    np.testing.assert_array_equal(got[0].numpy()[~act], lb[~act])
    assert not got[2].numpy()[~act].any()


def test_batched_merge_outward_matches_reference(rng):
    from repro.core import bounds as rbnd
    from repro_torch.core import bounds as tbnd

    lb, ub = _planes(rng, 4, 128, False, inf_frac=0.0)
    bl, bu = _planes(rng, 4, 128, False, inf_frac=0.2)
    want = rbnd.apply_updates_batch(_j(lb), _j(ub), _j(bl), _j(bu), 1e-5, outward=2.0**-17)
    got = tbnd.apply_updates_batch(_t(lb), _t(ub), _t(bl), _t(bu), 1e-5, outward=2.0**-17)
    for g, w in zip(got, want):
        _assert_match(g, w, True)


def _objective_inputs(rng, bsz, n, exact):
    n_pad = -(-n // 128) * 128
    lb, ub = _planes(rng, bsz, n_pad, exact, inf_frac=0.02)
    if exact:
        c = rng.integers(-4, 5, n_pad).astype(np.float64)
    else:
        c = rng.standard_normal(n_pad) * 10.0 ** rng.integers(-3, 4, n_pad)
        c[rng.random(n_pad) < 0.1] = 0.0
    valid = np.arange(n_pad) < n
    c[~valid] = 0.0
    is_int = rng.random(n_pad) < 0.7
    # Some rows fixed (leaf candidates), one crossed.
    lb[0] = np.where(lb[0] <= -INF, 0.0, lb[0])
    ub[0] = lb[0]
    if bsz > 1:
        lb[1, 3] = ub[1, 3] + 1.0
    return lb, ub, c, is_int, valid


@pytest.mark.parametrize("exact", [True, False], ids=["int", "float"])
@pytest.mark.parametrize("bsz,n", [(1, 5), (3, 300), (5, 3000)])
def test_node_objective_matches_pallas(bsz, n, exact, rng):
    lb, ub, c, is_int, valid = _objective_inputs(rng, bsz, n, exact)
    want = r_node_objective(
        _j(lb), _j(ub), _j(c), _j(is_int), _j(valid), 1e-8, interpret=True
    )
    got = node_objective_tiles(_t(lb), _t(ub), _t(c), _t(is_int), _t(valid), 1e-8)
    for g, w in zip(got, want):
        _assert_match(g, w, exact)
    want_ref = rref.node_objective_ref(_j(lb), _j(ub), _j(c), _j(is_int), _j(valid), 1e-8)
    for g, w in zip(got, want_ref):
        _assert_match(g, w, exact)


def _warp(xs):
    off = 16
    while off:
        xs = [xs[i] + xs[i ^ off] for i in range(32)]
        off //= 2
    return xs[0]


def test_block_order_sum_is_the_kernel_order(rng):
    """The objective's plain sum, written thread by thread as the CUDA block
    reduces: thread t adds columns t, t + 1024, ... from 0.0, then a shuffle
    butterfly per warp and one over the 32 warp sums."""
    x = rng.standard_normal((2, 2500)) * 10.0 ** rng.integers(-8, 9, size=(2, 2500))
    got = tref.block_order_sum(torch.from_numpy(x)).numpy()
    for row, g in zip(x, got):
        thread = [0.0] * 1024
        for j, v in enumerate(row):
            thread[j % 1024] = thread[j % 1024] + v
        warps = [_warp(thread[32 * w: 32 * w + 32]) for w in range(32)]
        assert g == _warp(warps)


def _pool(rng, bsz, n_pad, n):
    lb = rng.integers(0, 3, size=(bsz, n_pad)).astype(np.float64)
    ub = lb + rng.integers(0, 3, size=(bsz, n_pad))
    lb[:, ::7] += 0.5  # fractional midpoints
    valid = np.arange(n_pad) < n
    is_int = rng.random(n_pad) < 0.8
    return lb, ub, is_int, valid


def test_selection_oracles_match_reference(rng):
    lb, ub, is_int, valid = _pool(rng, 6, 256, 200)
    ub[2] = lb[2]  # a node with nothing to branch on
    for g, w in zip(tref.most_fractional_ref(_t(lb), _t(ub), _t(is_int), _t(valid)),
                    rref.most_fractional_ref(_j(lb), _j(ub), _j(is_int), _j(valid))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    pc_sum = rng.integers(0, 4, size=(2, 256)).astype(np.float64)
    pc_cnt = rng.integers(0, 3, size=(2, 256)).astype(np.float64)
    pc_sum[:, 10:20] = 1.0  # ties: the lowest column wins
    pc_cnt[:, 10:20] = 1.0
    got = tref.pseudo_cost_select_ref(_t(lb), _t(ub), _t(is_int), _t(valid), _t(pc_sum),
                                      _t(pc_cnt))
    want = rref.pseudo_cost_select_ref(_j(lb), _j(ub), _j(is_int), _j(valid), _j(pc_sum),
                                       _j(pc_cnt))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("case", ["improve", "tie", "none", "worse"])
def test_incumbent_update_matches_reference(case, rng):
    bsz, n_pad = 6, 128
    lb = rng.integers(0, 3, size=(bsz, n_pad)).astype(np.float64)
    obj = np.array([5.0, 3.0, 3.0, 7.0, 3.0, 9.0])
    leaf = np.array([True, False, True, True, True, False])
    inc = {"improve": 4.0, "tie": 3.0, "none": 1e20, "worse": 1.0}[case]
    if case == "none":
        leaf[:] = False
    inc_x = rng.integers(0, 3, n_pad).astype(np.float64)
    got = tref.incumbent_update_ref(_t(leaf), _t(obj), torch.tensor(inc, dtype=torch.float64),
                                    _t(inc_x), _t(lb))
    want = rref.incumbent_update_ref(_j(leaf), _j(obj), jnp.asarray(inc), _j(inc_x), _j(lb))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("width", [None, 1, 3])
@pytest.mark.parametrize("seed", range(6))
def test_plan_expansion_matches_reference(seed, width):
    rng = np.random.default_rng(seed)
    cap = int(rng.integers(2, 40))
    status = rng.integers(0, 3, cap).astype(np.int32)
    depth = rng.integers(0, 4, cap).astype(np.int32)
    nbound = rng.integers(-3, 3, cap).astype(np.float64)  # ties on every key
    got = tsolver._plan_expansion(_t(status), _t(depth), _t(nbound), width)
    want = rsolver._plan_expansion(_j(status), _j(depth), _j(nbound), width)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


# ---------------------------------------------------------------------------
# The multi-chunk node round: A', the combine and E over a node batch
# ---------------------------------------------------------------------------


def _chunk_rows(rng, t, r):
    """Rows of one to three adjacent chunks over a (T, R) stream, ascending;
    ``(chunk_row, m)``."""
    n = t * r
    starts = np.zeros(n, np.int32)
    if n > 1:
        starts[rng.choice(np.arange(1, n), size=max(1, n // 3) - 1 if n > 3 else 0,
                          replace=False)] = 1
    crow = np.cumsum(starts).astype(np.int32)
    return crow.reshape(t, r), int(crow.max()) + 1


def _active_match(got, want, act, exact):
    """The active nodes' rows equal as values (the reference's oracles
    count in int64 under x64, the port's kernels in int32)."""
    g, w = got.numpy()[act], np.asarray(want)[act]
    if g.dtype.kind == "i":
        w = w.astype(g.dtype)
    _assert_match(g, w, exact)


def _vmapped(fn, *per_node, shared=()):
    """The reference oracle ``fn`` vmapped over its leading per-node
    arguments, the ``shared`` ones broadcast."""
    import jax

    return jax.vmap(lambda *a: fn(*shared, *a))(*map(_j, per_node))


@pytest.mark.parametrize("exact", [True, False], ids=["int", "float"])
@pytest.mark.parametrize("bsz,kind", BATCHES)
@pytest.mark.parametrize("t,r,k,n", SHAPES + [(2, 8, 128, 300)])
def test_node_multichunk_round_plain_versions_match_reference(t, r, k, n, bsz, kind, exact,
                                                              rng):
    """The plain node A', combine and E (what the wrappers run on CPU
    tensors) against the reference's single-instance oracles vmapped over
    the nodes, with every, some and no node active: the active nodes'
    outputs equal (bitwise on integer data), the others' partials zero and
    accumulators at the sentinels."""
    import jax

    from repro.kernels import col_pad

    n_pad = col_pad(n)
    val, col, ii, lhs, rhs = _tiles(rng, t, r, k, n, exact)
    lb, ub = _planes(rng, bsz, n_pad, exact)
    act = _mask(rng, bsz, kind)
    crow, m = _chunk_rows(rng, t, r)
    row_start = tref.row_starts(_t(crow), m)
    reset_launch_counts()

    got_p = node_activities_gather_tiles(_t(val), _t(col), _t(lb), _t(ub), _t(act), n_pad)
    want_p = _vmapped(lambda lb_, ub_: rref.activities_gather_tiles_ref(
        _j(val), _j(col), lb_, ub_, n_pad), lb, ub)
    for g, w in zip(got_p, want_p):
        _active_match(g, w, act, exact)
        assert not g.numpy()[~act].any()

    def segment_combine(x):  # the reference's _combine_chunk_partials, per node
        flat = jax.ops.segment_sum(x.reshape(-1), _j(crow).reshape(-1), num_segments=m)
        return flat[_j(crow)]

    got_a = node_combine_chunk_partials_tiles(*got_p, _t(crow), row_start, _t(act))
    want_a = [jax.vmap(segment_combine)(_j(x.numpy())) for x in got_p]
    for g, w in zip(got_a, want_a):
        _active_match(g, w, act, exact)
        assert not g.numpy()[~act].any()

    aggs = [x.numpy() for x in got_a]
    got = node_candidates_scatter_tiles(
        _t(val), _t(col), _t(ii), *map(_t, aggs), _t(lhs), _t(rhs), _t(lb), _t(ub), _t(act),
        n_pad, 1e-6,
    )
    want = _vmapped(lambda mf, mc, xf, xc, lb_, ub_: rref.candidates_scatter_tiles_ref(
        _j(val), _j(col), _j(ii), mf, mc, xf, xc, _j(lhs), _j(rhs), lb_, ub_, n_pad, 1e-6),
        *aggs, lb, ub)
    for g, w in zip(got, want):
        _active_match(g, w, act, exact)
        assert np.all(np.abs(g.numpy()[~act]) == INF)
    assert set(launch_counts().values()) == {0}  # CPU tensors launch nothing


@pytest.mark.parametrize("bsz,kind", BATCHES)
def test_node_multichunk_plain_versions_equal_single_instance_versions(bsz, kind, rng):
    """Each active node of the plain node A', combine and E equals the
    single-instance plain versions on its own row bitwise, on general
    floats too (one summation order)."""
    t, r, k, n = 3, 8, 16, 150
    n_pad = 256
    val, col, ii, lhs, rhs = _tiles(rng, t, r, k, n, False)
    lb, ub = _planes(rng, bsz, n_pad, False)
    act = _mask(rng, bsz, kind)
    crow, m = _chunk_rows(rng, t, r)
    args = lambda *a: tuple(map(_t, a))
    row_start = tref.row_starts(_t(crow), m)
    parts = node_activities_gather_tiles(*args(val, col, lb, ub, act), n_pad)
    aggs = node_combine_chunk_partials_tiles(*parts, _t(crow), row_start, _t(act))
    best = node_candidates_scatter_tiles(*args(val, col, ii), *aggs, *args(lhs, rhs, lb, ub, act),
                                         n_pad, 1e-6)
    for i in np.flatnonzero(act):
        one = tref.activities_gather_tiles_ref(*args(val, col, lb[i], ub[i]), n_pad)
        for g, w in zip(parts, one):
            assert torch.equal(g[i], w)
        done = tref.combine_chunk_partials_ref(*one, _t(crow), row_start)
        for g, w in zip(aggs, done):
            assert torch.equal(g[i], w)
        single = tref.candidates_scatter_tiles_ref(*args(val, col, ii), *done,
                                                   *args(lhs, rhs, lb[i], ub[i]), n_pad, 1e-6)
        for g, w in zip(best, single):
            assert torch.equal(g[i], w)


@pytest.mark.parametrize("k", [1, 4, 8, 16, 128])
def test_chunk_lengths_stop_after_the_last_nonzero(k, rng):
    """Where A' and E stop: one past each chunk's last nonzero, 0 for a
    chunk of padding, whatever lies before it (explicit zeros included)."""
    val = rng.choice([0.0, 0.0, 1.0, -2.0], size=(5, 4, k))
    val[0] = 0.0
    got = tref.chunk_lengths(_t(val)).numpy()
    nz = val != 0
    want = np.where(nz.any(-1), k - np.argmax(nz[..., ::-1], axis=-1), 0)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32
