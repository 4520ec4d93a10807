"""The accumulator planes that kernels #8, #10, #12 and #14 scatter into,
kept by the round closures (and the service's bucket engines) for a whole
fixed point, on the CPU (where the wrappers run their plain versions
through the same ownership logic as on the card): the merges #9 and #15
hand the active rows back at the sentinels, the scatters fold into what the
planes hold, the closures' planes are clean after every round while the
active mask changes, and the engines that use them still match the
reference's ``propagate_nodes``, ``solve`` and partitioned
``propagate_block_ell`` / ``propagate_batch``.  Also what the engines hoist
for those kernels: the copy stream's chunk lengths and tile maps (#12, #14),
a packed bucket's instance chunk ranges and longest chunk (#8), and the
service's chunk lengths, kept current at each admission.

Contract: bounds bitwise (as values) on integer-valued data, ``rtol=1e-12``
on general floats against the reference (another summation order), bitwise
between the kernel and plain paths of the port; rounds, converged,
infeasible, flags and the search's counts exact.
"""
import numpy as np
import pytest
import torch

import repro.core as rc
import repro.data as rd
from repro.kernels import ops as rops
import repro_torch as rt
from repro_torch.core import INF
from repro_torch.kernels import (
    accumulator_planes,
    apply_updates_batch_tiles,
    apply_updates_slab_tiles,
    batched_fused_scatter_round_tiles,
    batched_slab_round_tiles,
    node_fused_scatter_round_tiles,
    node_slab_round_tiles,
    ops as tops,
    ref as tref,
)

EPS, INT_EPS = 1e-9, 1e-6


def _t(x):
    return torch.from_numpy(np.array(x))


def _mask(bsz, kind):
    if kind == "on":
        return torch.ones(bsz, dtype=torch.bool)
    if kind == "off":
        return torch.zeros(bsz, dtype=torch.bool)
    return torch.arange(bsz) % 2 == 0


def _planes(rng, bsz, width, integer, inf_frac=0.1):
    if integer:
        lb = rng.integers(-5, 1, size=(bsz, width)).astype(np.float64)
        ub = rng.integers(0, 6, size=(bsz, width)).astype(np.float64)
    else:
        lb, ub = rng.uniform(-5, 0, size=(bsz, width)), rng.uniform(0, 5, size=(bsz, width))
    lb[rng.random((bsz, width)) < inf_frac] = -INF
    ub[rng.random((bsz, width)) < inf_frac] = INF
    return _t(lb), _t(ub)


def _is_clean(acc) -> bool:
    return bool((acc[0] == -INF).all() and (acc[1] == INF).all())


@pytest.fixture
def tiny_limit(monkeypatch):
    """Shrink the engine limit and the slab cap to 128 in both packages, so
    small instances cross the limit and ride the partitioned rounds."""
    rops.clear_prepare_cache()
    tops.clear_prepare_cache()
    rops.clear_batch_caches()
    tops.clear_batch_caches()
    for mod in (rops, tops):
        monkeypatch.setattr(mod, "SCATTER_MAX_NPAD", 128)
        monkeypatch.setattr(mod, "SLAB_NPAD", 128)
    yield
    rops.clear_prepare_cache()
    tops.clear_prepare_cache()
    rops.clear_batch_caches()
    tops.clear_batch_caches()


# ---------------------------------------------------------------------------
# The copy stream's hoisted chunk lengths and tile maps
# ---------------------------------------------------------------------------

# name: (generator, kwargs, tile, slab)
PARTITIONS = {
    "knapsack": ("make_knapsack", dict(n=280, m=8, seed=5), (2, 8), 128),
    "mixed": ("make_mixed", dict(m=35, n=300, seed=0), (4, 32), 128),
    "set_cover": ("make_set_cover", dict(n=270, m=25, seed=6), (4, 32), 128),
    "banded": ("make_banded", dict(n=3000, m=400, row_nnz=12, band=600, seed=1), (8, 128), 256),
}


def _partition(name):
    if name.startswith("batch"):
        gen = "make_mixed" if name == "batch_mixed" else "make_knapsack"
        kw = dict(m=25, n=260) if gen == "make_mixed" else dict(n=200, m=10)
        problems = [rt.problem_from_reference(getattr(rd, gen)(**kw, seed=s)) for s in range(3)]
        (batch,) = tops.packed_problems(problems, 4, 32)
        return tops.prepare_problem_batch(batch, device="cpu").slab_partition(128)
    gen, kw, tile, slab = PARTITIONS[name]
    p = rt.problem_from_reference(getattr(rd, gen)(**kw))
    return rt.prepare_block_ell(p, *tile, device="cpu").slab_partition(slab)


@pytest.mark.parametrize("name", list(PARTITIONS) + ["batch_mixed", "batch_knapsack"])
def test_copy_stream_chunk_length_is_hoisted(name):
    part = _partition(name)
    t, r, k = part.val.shape
    assert part.chunk_len.dtype == torch.int32 and tuple(part.chunk_len.shape) == (t, r)
    assert torch.equal(part.chunk_len, tref.chunk_lengths(part.val))
    # A copy keeps one slab's nonzeros of its chunk: most stop short of K.
    assert int((part.chunk_len < k).sum()) > 0


@pytest.mark.parametrize("name", list(PARTITIONS) + ["batch_mixed", "batch_knapsack"])
def test_copy_tile_maps_match_the_runs(name):
    """#12 reads each copy tile's window from ``tile_inst``/``tile_slab``;
    the plain version finds it through the runs: the same windows."""
    part = _partition(name)
    run = tref.copy_tile_runs(part.run_start, part.val.shape[0])
    assert torch.equal(part.tile_inst.long(), part.run_inst.long()[run])
    assert torch.equal(part.tile_slab.long(), part.run_slab.long()[run])


# ---------------------------------------------------------------------------
# The plain merges and scatters under the kept-plane contract
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["on", "off", "mixed"])
@pytest.mark.parametrize("merge", ["batch", "slab"])
def test_plain_merges_hand_the_planes_back(merge, kind):
    """#9 and #15 set every accumulator entry of the active rows back to the
    sentinels once read, and leave the other rows as they were; their
    merge is unchanged."""
    rng = np.random.default_rng(0)
    bsz, width = 4, 384
    lb, ub = _planes(rng, bsz, width, False, inf_frac=0.0)
    bl, bu = _planes(rng, bsz, width, False, inf_frac=0.2)
    bl, bu = bl - 1.0, bu + 1.0
    act = _mask(bsz, kind)
    if merge == "batch":
        want = rt.core.apply_updates_batch(lb, ub, bl, bu, EPS, active=act)
    else:
        want = tref.apply_updates_slab_ref(lb, ub, bl, bu, act, 128, EPS)
        want = (*want[:2], want[2].any(dim=1))
    old_l, old_u = bl.clone(), bu.clone()
    glb, gub = lb.clone(), ub.clone()
    if merge == "batch":
        got = apply_updates_batch_tiles(glb, gub, bl, bu, act, EPS)
    else:
        got = apply_updates_slab_tiles(glb, gub, bl, bu, act, 128, EPS)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (bl[act] == -INF).all() and (bu[act] == INF).all()
    assert torch.equal(bl[~act], old_l[~act]) and torch.equal(bu[~act], old_u[~act])


@pytest.mark.parametrize("kind", ["on", "off", "mixed"])
def test_plain_node_round_folds_into_the_planes(kind):
    """#10's plain version scatters into the planes it is given: clean
    active rows end as the oracle's rows, other rows are not touched, and a
    dirty active row (a plane not handed back) shows in the result."""
    rng = np.random.default_rng(1)
    p = rt.problem_from_reference(rd.make_knapsack(n=40, m=10, seed=2))
    prep = rt.prepare_block_ell(p, tile_width=64, device="cpu")
    assert prep.fits_one_chunk
    d, n_pad = prep.d, prep.n_pad
    bsz = 5
    lb = prep.lb0.expand(bsz, -1).clone()
    ub = prep.ub0.expand(bsz, -1).clone()
    act = _mask(bsz, kind)
    args = (d.val, d.col, prep.ii_g, prep.lhs_g, prep.rhs_g, lb, ub)
    want = tref.node_fused_scatter_round_ref(*args, n_pad, INT_EPS, active=act)
    acc = accumulator_planes(lb)
    junk = _t(rng.uniform(-3, 3, size=(bsz, n_pad)))
    acc[0][~act] = junk[~act]
    got = node_fused_scatter_round_tiles(*args, act, n_pad, INT_EPS, acc=acc,
                                         chunk_len=prep.chunk_len)
    assert got[0] is acc[0] and got[1] is acc[1]
    assert torch.equal(got[0][act], want[0][act]) and torch.equal(got[1][act], want[1][act])
    assert torch.equal(got[0][~act], junk[~act]) and (got[1][~act] == INF).all()
    if act.any():
        dirty = accumulator_planes(lb)
        dirty[0][act] = INF / 2
        node_fused_scatter_round_tiles(*args, act, n_pad, INT_EPS, acc=dirty)
        assert not torch.equal(dirty[0][act], want[0][act])


@pytest.mark.parametrize("kind", ["on", "off", "mixed"])
@pytest.mark.parametrize("name", ["batch_mixed", "batch_knapsack"])
def test_plain_slab_round_hands_its_planes_back(name, kind):
    """#12's plain version folds into the planes, merges and hands the
    active rows back: the planes are clean after the round, and a second
    round on them equals a round on fresh planes."""
    rng = np.random.default_rng(2)
    part = _partition(name)
    bsz = part.batch
    lb, ub = _planes(rng, bsz, part.n_pad_part, name == "batch_knapsack")
    act = _mask(bsz, kind)
    z = torch.zeros(part.chunk_row.shape, dtype=torch.float64)
    zi = torch.zeros(part.chunk_row.shape, dtype=torch.int32)
    r_args = (part.val, part.col_s, part.ii_g, part.row_done, z, zi, z, zi, part.lhs_g,
              part.rhs_g, part.run_start, part.run_len, part.run_inst, part.run_slab, act)
    tail = (part.slab, part.max_run_len, EPS, INT_EPS)
    acc = accumulator_planes(lb)
    for _ in range(2):
        want = tref.batched_slab_round_ref(*r_args, lb, ub, *tail)
        glb, gub = lb.clone(), ub.clone()
        got = batched_slab_round_tiles(*r_args, glb, gub, *tail, acc=acc,
                                       tiles=(part.tile_inst, part.tile_slab),
                                       chunk_len=part.chunk_len)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        assert _is_clean(acc)
        lb, ub = glb, gub


@pytest.mark.parametrize("kind", ["on", "off", "mixed"])
def test_plain_batched_fused_round_folds_into_the_planes(kind):
    """#8's plain version scatters into the planes it is given: clean active
    rows end as the oracle's rows, inactive rows are not touched, and a
    dirty active row (a plane not handed back) shows in the result."""
    rng = np.random.default_rng(3)
    problems = [rt.problem_from_reference(rd.make_knapsack(n=40, m=10, seed=s))
                for s in range(3)]
    (batch,) = tops.packed_problems(problems, 4, 64)
    prep = tops.prepare_problem_batch(batch, device="cpu")
    assert prep.fits_one_chunk
    d, n_pad = prep.d, prep.n_pad
    act = _mask(3, kind)
    args = (d.val, d.col, d.ii_g, d.lhs_g, d.rhs_g, d.lb0, d.ub0, d.tile_inst, act, n_pad,
            INT_EPS)
    want = tref.batched_fused_scatter_round_ref(
        d.val, d.col_g, d.ii_g, d.lhs_g, d.rhs_g, d.lb0, d.ub0, n_pad, INT_EPS, active=act)
    acc = accumulator_planes(d.lb0)
    junk = _t(rng.uniform(-3, 3, size=(3, n_pad)))
    acc[0][~act] = junk[~act]
    got = batched_fused_scatter_round_tiles(*args, acc=acc, chunk_len=d.chunk_len,
                                            max_chunk_len=prep.max_chunk_len, chunks=d.chunks)
    assert got[0] is acc[0] and got[1] is acc[1]
    assert torch.equal(got[0][act], want[0][act]) and torch.equal(got[1][act], want[1][act])
    assert torch.equal(got[0][~act], junk[~act]) and (got[1][~act] == INF).all()
    if act.any():
        dirty = accumulator_planes(d.lb0)
        dirty[0][act] = INF / 2
        batched_fused_scatter_round_tiles(*args, acc=dirty)
        assert not torch.equal(dirty[0][act], want[0][act])


@pytest.mark.parametrize("kind", ["on", "off", "mixed"])
def test_plain_node_slab_round_hands_its_planes_back(kind):
    """#14's plain version folds into the planes, merges and hands the
    active rows back: the planes are clean after the round, and rounds on
    them equal the oracle's rounds."""
    rng = np.random.default_rng(4)
    part = _partition("knapsack")
    bsz = 5
    lb, ub = _planes(rng, bsz, part.n_pad_part, True)
    act = _mask(bsz, kind)
    shape = (bsz, *part.chunk_row.shape)
    strs = (_t(rng.integers(-3, 3, size=shape).astype(np.float64)),
            _t(rng.integers(0, 2, size=shape).astype(np.int32)),
            _t(rng.integers(-3, 3, size=shape).astype(np.float64)),
            _t(rng.integers(0, 2, size=shape).astype(np.int32)))
    r_args = (part.val, part.col_s, part.ii_g, part.row_done, *strs, part.lhs_g, part.rhs_g,
              part.run_start, part.run_len, part.run_slab, act)
    tail = (part.slab, part.max_run_len, EPS, INT_EPS)
    acc = accumulator_planes(lb)
    for _ in range(2):
        want = tref.node_slab_round_ref(*r_args, lb, ub, *tail)
        glb, gub = lb.clone(), ub.clone()
        got = node_slab_round_tiles(*r_args, glb, gub, *tail, acc=acc, tile_slab=part.tile_slab,
                                    chunk_len=part.chunk_len, max_chunk_len=part.max_chunk_len)
        assert got[0] is glb and got[1] is gub
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        assert _is_clean(acc)
        lb, ub = glb, gub


# ---------------------------------------------------------------------------
# What the engines hoist for #8: chunk ranges, lengths, the longest chunk
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("gen,kw,tile", [
    ("make_knapsack", dict(n=40, m=10), (4, 64)),
    ("make_set_cover", dict(n=60, m=20), (2, 8)),
    ("make_mixed", dict(m=25, n=60), (8, 16)),
])
def test_batch_hoists_instance_chunk_ranges(gen, kw, tile):
    """A packed bucket's instance chunk ranges and longest chunk, hoisted at
    prepare time, against recomputation from the packed host arrays."""
    problems = [rt.problem_from_reference(getattr(rd, gen)(**kw, seed=s)) for s in range(4)]
    (batch,) = tops.packed_problems(problems, *tile)
    prep = tops.prepare_problem_batch(batch, device="cpu")
    ell = batch.ell
    first = [int(np.flatnonzero(ell.tile_inst == i)[0]) for i in range(batch.size)]
    want = np.array(first + [ell.num_tiles], dtype=np.int64) * ell.tile_rows
    assert prep.d.chunks.dtype == torch.int64
    np.testing.assert_array_equal(prep.d.chunks.numpy(), want)
    for i in range(batch.size):  # each range holds exactly its instance's chunks
        lo, hi = want[i] // ell.tile_rows, want[i + 1] // ell.tile_rows
        assert (ell.tile_inst[lo:hi] == i).all()
    lens = np.where(ell.val != 0, np.arange(1, ell.tile_width + 1), 0).max(axis=-1)
    np.testing.assert_array_equal(prep.d.chunk_len.numpy(), lens)
    assert prep.max_chunk_len == int(lens.max())


@pytest.mark.parametrize("tile_width", [128, 8])
def test_service_hoists_chunk_lengths_at_each_admission(monkeypatch, tile_width):
    """The service's chunk lengths (fits-one-chunk buckets too) equal a
    recomputation from the resident tiles after every admission, and its
    longest chunk is the running maximum of the admitted payloads'."""
    problems = [rt.problem_from_reference(rd.make_knapsack(n=40 + 10 * s, m=8 + s, seed=s))
                for s in range(5)]
    svc = rt.PropagationService.from_problems(problems, slots=2, tile_width=tile_width,
                                              device="cpu")
    (bk,) = svc._buckets
    assert bk.spec.fits_one_chunk == (tile_width == 128)
    engine, admitted, checks = bk.engine, [], []
    admit = engine.admit

    def checked(state, aux, payloads, slot_ids):
        admit(state, aux, payloads, slot_ids)
        admitted.extend(payloads)
        assert torch.equal(aux[4], tref.chunk_lengths(state[0]))
        longest = max(int(tref.chunk_lengths(torch.from_numpy(p.val)).max()) for p in admitted)
        assert aux[6][0] == longest
        checks.append(longest)

    monkeypatch.setattr(engine, "admit", checked)
    out = svc.serve(problems)
    assert len(admitted) == len(problems) and len(checks) >= 3  # backfills happened
    assert checks == sorted(checks)
    if bk.spec.fits_one_chunk:  # #8 scattered into the engine's planes
        assert _is_clean(engine.kept.planes)
    for p, r in zip(problems, out):
        one = rt.propagate_batch([p], tile_width=tile_width, device="cpu")[0]
        assert torch.equal(r.lb, one.lb) and torch.equal(r.ub, one.ub)


# ---------------------------------------------------------------------------
# The round closures: planes clean after every round while ``active`` moves
# ---------------------------------------------------------------------------


def _masks(bsz, rounds, seed):
    """A different active mask each round, all off and all on among them."""
    rng = np.random.default_rng(seed)
    out = [torch.ones(bsz, dtype=torch.bool), torch.zeros(bsz, dtype=torch.bool)]
    out += [_t(rng.random(bsz) < 0.5) for _ in range(rounds - 2)]
    return out


def _drive(round_fn, plain_fn, lb, ub, masks):
    """Run both closures round by round on the same masks: the kernel
    closure's bounds and flags equal the plain closure's, and its kept
    planes are clean after every round."""
    plb, pub = lb.clone(), ub.clone()
    for act in masks:
        lb, ub, ch = round_fn(lb, ub, act)
        plb, pub, pch = plain_fn(plb, pub, act)
        assert torch.equal(lb, plb) and torch.equal(ub, pub) and torch.equal(ch, pch)
        assert _is_clean(round_fn.kept.planes)
    return lb, ub


@pytest.mark.parametrize("gen,kw,tile_width", [
    ("make_pseudo_boolean", dict(n=300, m=400, seed=7), 8),
    ("make_knapsack", dict(n=40, m=10, seed=2), 64),
])
def test_node_round_keeps_its_planes_clean(gen, kw, tile_width):
    p = rt.problem_from_reference(getattr(rd, gen)(**kw))
    prep = rt.prepare_block_ell(p, tile_width=tile_width, device="cpu")
    assert prep.fits_one_chunk
    lb, ub = tops._node_planes(prep, *_branched(p, 7))
    round_fn = tops.node_round_fn_for(prep)
    _drive(round_fn, tops.node_round_fn_for(prep, use_kernels=False), lb, ub, _masks(7, 6, 0))
    # A batch of another size allocates a new pair.
    lb3, ub3 = lb[:3].clone(), ub[:3].clone()
    round_fn(lb3, ub3, torch.ones(3, dtype=torch.bool))
    assert round_fn.kept.planes[0].shape == (3, prep.n_pad)
    assert _is_clean(round_fn.kept.planes)


def test_partitioned_rounds_keep_their_planes_clean(tiny_limit):
    # One instance through round_fn_for (B == 1) ...
    p = rt.problem_from_reference(rd.make_knapsack(n=200, m=10, seed=3))
    prep = rt.prepare_block_ell(p, tile_width=8, device="cpu")
    assert prep.n_pad > tops.SCATTER_MAX_NPAD
    round_fn = tops.round_fn_for(prep, scatter="partitioned")
    plain_fn = tops.round_fn_for(prep, scatter="partitioned", use_kernels=False)
    lb, ub = prep.lb0.clone(), prep.ub0.clone()
    plb, pub = lb.clone(), ub.clone()
    for _ in range(4):
        lb, ub, ch = round_fn(lb, ub)
        plb, pub, pch = plain_fn(plb, pub)
        assert torch.equal(lb, plb) and torch.equal(ub, pub) and bool(ch) == bool(pch)
        assert _is_clean(round_fn.kept.planes)
    # ... and a packed bucket through batched_round_fn_for.
    problems = [rt.problem_from_reference(rd.make_mixed(m=25, n=260, seed=s))
                for s in range(3)]
    (batch,) = tops.packed_problems(problems, 4, 32)
    bprep = tops.prepare_problem_batch(batch, device="cpu")
    assert bprep.n_pad > tops.SCATTER_MAX_NPAD
    round_fn = tops.batched_round_fn_for(bprep)
    _drive(round_fn, tops.batched_round_fn_for(bprep, use_kernels=False),
           bprep.d.lb0.clone(), bprep.d.ub0.clone(), _masks(3, 6, 1))
    # ... and a node batch through node_round_fn_for (#13, the straddle
    # combine, #14 with #15).
    lb, ub = tops._node_planes(prep, *_branched(p, 5))
    round_fn = tops.node_round_fn_for(prep)
    _drive(round_fn, tops.node_round_fn_for(prep, use_kernels=False), lb, ub, _masks(5, 6, 2))


def test_fused_batch_round_keeps_its_planes_clean():
    """#8 + #9 through batched_round_fn_for, the mask moving every round."""
    problems = [rt.problem_from_reference(rd.make_knapsack(n=40, m=10, seed=s))
                for s in range(4)]
    (batch,) = tops.packed_problems(problems, 4, 64)
    prep = tops.prepare_problem_batch(batch, device="cpu")
    assert prep.fits_one_chunk
    round_fn = tops.batched_round_fn_for(prep)
    _drive(round_fn, tops.batched_round_fn_for(prep, use_kernels=False), prep.d.lb0.clone(),
           prep.d.ub0.clone(), _masks(4, 6, 3))


def test_a_round_that_raises_drops_its_planes(monkeypatch):
    """A round cut between #10 and #9 may leave its planes dirty: the
    closure drops them, and the next round starts from a fresh pair."""
    p = rt.problem_from_reference(rd.make_pseudo_boolean(n=300, m=400, seed=7))
    prep = rt.prepare_block_ell(p, tile_width=8, device="cpu")
    lb, ub = tops._node_planes(prep, *_branched(p, 4))

    def boom(*args, **kw):
        raise RuntimeError("merge lost")

    monkeypatch.setattr(tops, "KERNEL_OPS", tops.KERNEL_OPS._replace(merge_batch=boom))
    round_fn = tops.node_round_fn_for(prep)
    act = torch.ones(4, dtype=torch.bool)
    with pytest.raises(RuntimeError, match="merge lost"):
        round_fn(lb.clone(), ub.clone(), act)
    assert round_fn.kept.planes is None
    monkeypatch.undo()
    round_fn = tops.node_round_fn_for(prep)
    got = round_fn(lb.clone(), ub.clone(), act)
    want = tops.node_round_fn_for(prep, use_kernels=False)(lb.clone(), ub.clone(), act)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# The engines over multi-round fixed points, against the reference
# ---------------------------------------------------------------------------


def _branched(p, count, seed=0):
    rng = np.random.default_rng(seed)
    lbs, ubs = [], []
    for _ in range(count):
        lb, ub = np.array(p.lb), np.array(p.ub)
        for var in rng.choice(p.n, size=3, replace=False):
            if p.is_int[var] and lb[var] < ub[var]:
                down, up = rt.core.branch_children(lb, ub, int(var), lb[var])
                lb, ub = down if rng.random() < 0.5 else up
        lbs.append(lb)
        ubs.append(ub)
    return np.stack(lbs), np.stack(ubs)


@pytest.mark.parametrize("gen,kw,tile_width", [
    ("make_pseudo_boolean", dict(n=300, m=400, seed=7), 8),
    ("make_knapsack", dict(n=60, m=12, seed=4), 64),
    ("make_set_cover", dict(n=80, m=30, seed=3), 32),
])
def test_node_batches_with_kept_planes_match_reference(gen, kw, tile_width):
    pr = getattr(rd, gen)(**kw)
    p = rt.problem_from_reference(pr)
    lb, ub = _branched(p, 8, seed=1)
    want = rc.propagate_nodes(pr, lb, ub, tile_width=tile_width, use_pallas=False)
    got = rt.propagate_nodes(p, lb, ub, tile_width=tile_width, device="cpu")
    np.testing.assert_array_equal(got.lb.numpy(), np.asarray(want.lb))
    np.testing.assert_array_equal(got.ub.numpy(), np.asarray(want.ub))
    for f in ("rounds", "converged", "infeasible"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_search_with_kept_planes_matches_reference(seed):
    pr = rd.make_pseudo_boolean(n=40, m=50, seed=seed)
    p = rt.problem_from_reference(pr)
    c = np.arange(1, pr.n + 1) * np.where(np.arange(pr.n) % 3 == 0, -1.0, 1.0)
    kw = dict(node_cap=16, expand_width=2, max_levels=12, sync_every=3)
    want = rc.solve(pr, c, use_pallas=False, tile_width=8, **kw)
    got = rt.solve(p, c, device="cpu", tile_width=8, **kw)
    for f in ("status", "objective", "nodes_expanded", "nodes_created", "leaves", "levels",
              "host_syncs", "incumbent_trajectory"):
        assert getattr(got, f) == getattr(want, f), f


@pytest.mark.parametrize("gen,kw,tile,exact", [
    ("make_pseudo_boolean", dict(n=200, m=260), (8, 8), True),
    ("make_mixed", dict(m=25, n=260), (4, 32), False),
])
def test_partitioned_fixed_points_with_kept_planes_match_reference(tiny_limit, gen, kw, tile,
                                                                   exact):
    refs = [getattr(rd, gen)(**kw, seed=s) for s in range(3)]
    problems = [rt.problem_from_reference(pr) for pr in refs]
    got = rt.core.propagate_batch(problems, tile_rows=tile[0], tile_width=tile[1],
                                  device="cpu")
    rounds = set()
    for pr, p, g in zip(refs, problems, got):
        layout = dict(tile_rows=tile[0], tile_width=tile[1])
        want = rops.propagate_block_ell(pr, use_pallas=False, **layout)
        one = rt.propagate_block_ell(p, device="cpu", **layout)
        for res in (g, one):
            assert int(res.rounds) == int(want.rounds)
            assert bool(res.infeasible) == bool(want.infeasible)
            assert bool(res.converged) == bool(want.converged)
            for a, w in ((res.lb, want.lb), (res.ub, want.ub)):
                if exact:
                    np.testing.assert_array_equal(a.numpy(), np.asarray(w))
                else:
                    np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-12, atol=1e-12)
        assert torch.equal(g.lb, one.lb) and torch.equal(g.ub, one.ub)
        rounds.add(int(g.rounds))
    assert len(rounds) > 1  # the batch's active mask changed between rounds


@pytest.mark.parametrize("gen,kw,exact", [
    ("make_knapsack", dict(n=200, m=10, seed=3), True),
    ("make_mixed", dict(m=25, n=260, seed=4), False),
])
def test_partitioned_node_batches_with_kept_planes_match_reference(tiny_limit, gen, kw, exact):
    """The partitioned node fixed point (#13, the straddle combine, #14 into
    the closure's kept planes, #15) against the reference's node batch."""
    pr = getattr(rd, gen)(**kw)
    p = rt.problem_from_reference(pr)
    lb, ub = _branched(p, 4, seed=2)
    want = rc.propagate_nodes(pr, lb, ub, tile_width=8, use_pallas=False)
    got = rt.propagate_nodes(p, lb, ub, tile_width=8, device="cpu")
    assert rt.prepare_block_ell(p, tile_width=8, device="cpu").n_pad > tops.SCATTER_MAX_NPAD
    for f in ("rounds", "converged", "infeasible"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
    if exact:
        np.testing.assert_array_equal(got.lb.numpy(), np.asarray(want.lb))
        np.testing.assert_array_equal(got.ub.numpy(), np.asarray(want.ub))
    else:
        for i in range(4):
            assert rt.bounds_equal(got.lb[i], got.ub[i], np.asarray(want.lb[i]),
                                   np.asarray(want.ub[i]))


def test_partitioned_search_with_kept_planes_matches_reference(tiny_limit):
    """A search whose node rounds run #14 into kept planes, against the
    reference's ``solve``: every count exact."""
    pr = rd.make_pseudo_boolean(n=200, m=260, seed=1)
    p = rt.problem_from_reference(pr)
    c = np.arange(1, pr.n + 1) * np.where(np.arange(pr.n) % 3 == 0, -1.0, 1.0)
    kw = dict(node_cap=16, expand_width=2, max_levels=6, sync_every=3, tile_width=8)
    want = rc.solve(pr, c, use_pallas=False, **kw)
    got = rt.solve(p, c, device="cpu", **kw)
    assert got.levels > 2
    for f in ("status", "objective", "nodes_expanded", "nodes_created", "leaves", "levels",
              "host_syncs", "incumbent_trajectory"):
        assert getattr(got, f) == getattr(want, f), f
