"""GPU tests of the port's CUDA kernels: each kernel against its plain
PyTorch version on the same CUDA tensors, and the engine on the card against
the engine on the CPU.  Marked ``gpu``; they skip where there is no card.

This file imports neither JAX nor the JAX package, so on a machine without
JAX it runs on its own:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Kernel and plain version must agree bitwise (as values) on integer-valued
and general-float inputs alike: the plain version sums each chunk in the
kernels' order (``ref.warp_order_sum``) and the kernels are built without FMA
contraction.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch as rt
import repro_torch.data as td
from repro_torch.core import INF, col_pad
from repro_torch import kernels as tk
from repro_torch.kernels import ref as tref

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def gen():
    return np.random.default_rng(0)


def _enqueued(rounds: int, gated: bool = True) -> int:
    """Rounds that the device loop (``propagate_block_ell``'s default)
    enqueues for a fixed point of ``rounds``: whole read groups of
    ``DEVICE_LOOP_GROUP`` (``UNGATED_LOOP_GROUP`` for the segment engine),
    at most ``max_rounds``.  Those after convergence still launch (and
    return at once)."""
    prop = rt.core.propagator
    group = prop.DEVICE_LOOP_GROUP if gated else prop.UNGATED_LOOP_GROUP
    return min(-(-rounds // group) * group, rt.core.DEFAULT_CONFIG.max_rounds)


def _tiles(gen, t, r, k, n, integer, dev):
    val = gen.choice([-2.0, -1.0, 0.0, 1.0, 3.0], size=(t, r, k))
    col = gen.integers(0, n, size=(t, r, k)).astype(np.int32)
    col[val == 0] = 0
    n_pad = col_pad(n)
    if integer:
        lb = gen.integers(-5, 1, size=n_pad).astype(np.float64)
        ub = gen.integers(0, 6, size=n_pad).astype(np.float64)
        lhs = gen.integers(-10, 1, size=(t, r)).astype(np.float64)
        rhs = gen.integers(0, 11, size=(t, r)).astype(np.float64)
    else:
        lb, ub = gen.uniform(-5, 0, size=n_pad), gen.uniform(0, 5, size=n_pad)
        lhs, rhs = gen.uniform(-10, 0, size=(t, r)), gen.uniform(0, 10, size=(t, r))
    lb[gen.random(n_pad) < 0.15] = -INF
    ub[gen.random(n_pad) < 0.15] = INF
    ii = (gen.random((t, r, k)) < 0.5).astype(np.int32)
    ii[val == 0] = 0
    c = lambda x: torch.from_numpy(np.array(x)).to(dev)
    return dict(val=c(val), col=c(col), ii=c(ii), lb=c(lb), ub=c(ub), lhs=c(lhs),
                rhs=c(rhs), n_pad=n_pad)


def _match(got, want):
    torch.cuda.synchronize()
    g, w = got.cpu().numpy(), want.cpu().numpy()
    assert g.dtype == w.dtype and g.shape == w.shape
    np.testing.assert_array_equal(g, w)


SHAPES = [(1, 2, 4, 3), (3, 4, 8, 20), (5, 8, 128, 300), (64, 8, 128, 5000)]


def _clean(acc) -> bool:
    """Accumulator planes (or rows of them) at the sentinels."""
    torch.cuda.synchronize()
    return bool((acc[0] == -INF).all() and (acc[1] == INF).all())


@pytest.mark.parametrize("exact", [True, False], ids=["int", "float"])
@pytest.mark.parametrize("t,r,k,n", SHAPES)
def test_kernels_match_plain_versions(cuda, gen, t, r, k, n, exact):
    x = _tiles(gen, t, r, k, n, exact, cuda)
    tk.reset_launch_counts()
    d_args = (x["val"], x["col"], x["ii"], x["lhs"], x["rhs"], x["lb"], x["ub"], x["n_pad"], 1e-6)
    for g, w in zip(tk.fused_scatter_round_tiles(*d_args),
                    tref.fused_scatter_round_tiles_ref(*d_args)):
        _match(g, w)

    a_args = (x["val"], x["col"], x["lb"], x["ub"], x["n_pad"])
    aggs = tk.activities_gather_tiles(*a_args)
    for g, w in zip(aggs, tref.activities_gather_tiles_ref(*a_args)):
        _match(g, w)

    e_args = (x["val"], x["col"], x["ii"], *aggs, x["lhs"], x["rhs"], x["lb"], x["ub"],
              x["n_pad"], 1e-6)
    for g, w in zip(tk.candidates_scatter_tiles(*e_args),
                    tref.candidates_scatter_tiles_ref(*e_args)):
        _match(g, w)

    best_l, best_u = tref.fused_scatter_round_tiles_ref(*d_args)
    want = rt.core.apply_updates(x["lb"], x["ub"], best_l, best_u, 1e-9)
    lb, ub = x["lb"].clone(), x["ub"].clone()
    got = tk.apply_updates_tiles(lb, ub, best_l, best_u, 1e-9)
    assert got[0] is lb and got[1] is ub
    for g, w in zip(got, want):
        _match(g, w)
    called = {"fused_scatter_round_tiles", "activities_gather_tiles",
              "candidates_scatter_tiles", "apply_updates_tiles"}
    assert tk.launch_counts() == {fn.__name__: int(fn.__name__ in called) for fn in tk.KERNELS}


def test_wrappers_check_operands(cuda, gen):
    x = _tiles(gen, 2, 2, 4, 10, True, cuda)
    with pytest.raises(TypeError, match="col"):
        tk.activities_gather_tiles(x["val"], x["col"].long(), x["lb"], x["ub"], x["n_pad"])
    with pytest.raises(ValueError, match="lb"):
        tk.activities_gather_tiles(x["val"], x["col"], x["lb"][:-1], x["ub"], x["n_pad"])
    with pytest.raises(ValueError, match="device"):
        tk.activities_gather_tiles(x["val"], x["col"], x["lb"].cpu(), x["ub"], x["n_pad"])


@pytest.mark.parametrize("gen_name,kw,tile_width,exact", [
    ("make_pseudo_boolean", dict(n=3000, m=4000, seed=7), 128, True),
    ("make_pseudo_boolean", dict(n=3000, m=4000, seed=7), 4, True),
    ("make_cascade_chain", dict(length=40), 4, True),
    ("make_mixed", dict(m=600, n=450, seed=21), 128, False),
    ("make_mixed", dict(m=600, n=450, seed=21), 16, False),
])
def test_engine_on_card_matches_cpu(cuda, gen_name, kw, tile_width, exact):
    p = getattr(td, gen_name)(**kw)
    tk.reset_launch_counts()
    got = rt.propagate_block_ell(p, tile_width=tile_width)
    want = rt.propagate_block_ell(p, tile_width=tile_width, device="cpu")
    counts = tk.launch_counts()
    rounds = _enqueued(int(got.rounds))
    assert counts["apply_updates_tiles"] == rounds
    if tk.rows_fit_one_chunk(p, tile_width):
        assert counts["fused_scatter_round_tiles"] == rounds
    else:
        assert counts["activities_gather_tiles"] == counts["candidates_scatter_tiles"] == rounds
    assert got.lb.device.type == "cuda"
    for f in ("rounds", "converged", "infeasible"):
        assert getattr(got, f).item() == getattr(want, f).item()
    if exact:
        np.testing.assert_array_equal(got.lb.cpu().numpy(), want.lb.numpy())
        np.testing.assert_array_equal(got.ub.cpu().numpy(), want.ub.numpy())
    else:
        assert rt.bounds_equal(got.lb, got.ub, want.lb, want.ub)


def _planes(gen, bsz, n_pad, integer, dev):
    if integer:
        lb = gen.integers(-5, 1, size=(bsz, n_pad)).astype(np.float64)
        ub = gen.integers(0, 6, size=(bsz, n_pad)).astype(np.float64)
    else:
        lb, ub = gen.uniform(-5, 0, size=(bsz, n_pad)), gen.uniform(0, 5, size=(bsz, n_pad))
    lb[gen.random((bsz, n_pad)) < 0.1] = -INF
    ub[gen.random((bsz, n_pad)) < 0.1] = INF
    c = lambda x: torch.from_numpy(np.array(x)).to(dev)
    return c(lb), c(ub)


@pytest.mark.parametrize("exact", [True, False], ids=["int", "float"])
@pytest.mark.parametrize("t,r,k,n", SHAPES)
@pytest.mark.parametrize("bsz", [1, 5])
def test_node_kernels_match_plain_versions(cuda, gen, t, r, k, n, bsz, exact):
    x = _tiles(gen, t, r, k, n, exact, cuda)
    lb, ub = _planes(gen, bsz, x["n_pad"], exact, cuda)
    for act in (torch.ones(bsz, dtype=torch.bool), torch.arange(bsz) % 2 == 0,
                torch.zeros(bsz, dtype=torch.bool)):
        act = act.to(cuda)
        tk.reset_launch_counts()
        args = (x["val"], x["col"], x["ii"], x["lhs"], x["rhs"], lb, ub, act, x["n_pad"], 1e-6)
        acc = tk.accumulator_planes(lb)
        got = tk.node_fused_scatter_round_tiles(*args, acc=acc)
        want = tref.node_fused_scatter_round_ref(*args[:7], x["n_pad"], 1e-6, active=act)
        for g, w in zip(got, want):
            _match(g, w)
        best_l, best_u = want
        want_m = rt.core.apply_updates_batch(lb, ub, best_l, best_u, 1e-9, active=act)
        glb, gub = lb.clone(), ub.clone()
        # The merge reads the kernel's planes and hands them back clean.
        got_m = tk.apply_updates_batch_tiles(glb, gub, *acc, act, 1e-9)
        assert got_m[0] is glb
        for g, w in zip(got_m, want_m):
            _match(g, w)
        assert _clean(acc)
        counts = tk.launch_counts()
        assert counts["node_fused_scatter_round_tiles"] == counts["apply_updates_batch_tiles"] == 1


@pytest.mark.parametrize("exact", [True, False], ids=["int", "float"])
@pytest.mark.parametrize("bsz,n", [(1, 5), (4, 3000), (3, 60000)])
def test_node_objective_matches_plain_version(cuda, gen, bsz, n, exact):
    n_pad = col_pad(n)
    lb, ub = _planes(gen, bsz, n_pad, exact, cuda)
    if exact:
        c = gen.integers(-4, 5, n_pad).astype(np.float64)
    else:
        c = gen.standard_normal(n_pad) * 10.0 ** gen.integers(-3, 4, n_pad)
    valid = np.arange(n_pad) < n
    c[~valid] = 0.0
    ub[0] = lb[0]  # a fixed node
    to = lambda a: torch.from_numpy(np.array(a)).to(cuda)
    args = (lb, ub, to(c), to(gen.random(n_pad) < 0.7), to(valid), 1e-8)
    for g, w in zip(tk.node_objective_tiles(*args), tref.node_objective_ref(*args)):
        _match(g, w)


@pytest.mark.parametrize("lengths", [[3, 1, 5, 2], [40, 1, 300, 7]])
def test_combine_matches_plain_version(cuda, gen, lengths):
    counts = np.array(lengths)
    m = len(counts)
    n_chunks = int(counts.sum()) + 3
    crow = np.concatenate([np.repeat(np.arange(m), counts), [m] * 3]).astype(np.int32)
    row_start = np.concatenate([[0], np.cumsum(counts), [n_chunks]]).astype(np.int64)
    to = lambda a: torch.from_numpy(np.array(a)).to(cuda).reshape(-1, 1)
    parts = (gen.standard_normal(n_chunks) * 10.0 ** gen.integers(-8, 9, n_chunks),
             gen.integers(0, 3, n_chunks).astype(np.int32),
             gen.standard_normal(n_chunks) * 10.0 ** gen.integers(-8, 9, n_chunks),
             gen.integers(0, 3, n_chunks).astype(np.int32))
    args = (*map(to, parts), to(crow), to(row_start).reshape(-1))
    for g, w in zip(tk.combine_chunk_partials_tiles(*args), tref.combine_chunk_partials_ref(*args)):
        _match(g, w)


def _bits(x):
    """Bit patterns of a float64 or float32 tensor (ints as they are): -0.0
    differs from +0.0."""
    x = x.cpu()
    ints = {torch.float64: torch.int64, torch.float32: torch.int32, torch.bfloat16: torch.int16,
            torch.float16: torch.int16}
    return x.view(ints[x.dtype]) if x.dtype in ints else x


def _match_bits(got, want):
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(_bits(got), _bits(want))


# Segment lengths of the long-row combine around its thread/warp threshold
# and up to the longest rows of the smoke instances (3,000 chunks at tile
# width 8) and beyond.
COMBINE_LENGTHS = [0, 1, 31, 32, 33, 1000, 3000, 6000, 2, 0]


def _combine_partials(gen, n_chunks, kind, lead=()):
    """Chunk partials of one kind: general floats over 16 decades, mostly
    explicit zeros, or a mix with -0.0."""
    shape = (*lead, n_chunks)
    f = lambda: gen.standard_normal(shape) * 10.0 ** gen.integers(-8, 9, shape)
    mf, xf = f(), f()
    if kind == "zeros":
        mf[gen.random(shape) < 0.8] = 0.0
        xf[gen.random(shape) < 0.8] = 0.0
    elif kind == "negzero":
        mf[gen.random(shape) < 0.5] = -0.0
        xf[:] = -0.0
    return (mf, gen.integers(0, 3, shape).astype(np.int32), xf,
            gen.integers(0, 3, shape).astype(np.int32))


@pytest.mark.parametrize("kind", ["float", "zeros", "negzero"])
@pytest.mark.parametrize("threshold", [tref.LONG_SEGMENT, 0, 1 << 30])
def test_combine_long_segments_match_plain_version(cuda, gen, kind, threshold):
    """The flat and node combine at segment lengths 0 to 6,000 chunks: the
    thread (short) and warp (long) paths bitwise equal (bit patterns) to
    the unchanged plain version, whatever the threshold that split them,
    hoisted or computed by the wrapper."""
    counts = np.array(COMBINE_LENGTHS)
    m = len(counts)
    n_chunks = int(counts.sum()) + 3
    crow = np.concatenate([np.repeat(np.arange(m), counts), [m] * 3]).astype(np.int32)
    to = lambda a: torch.from_numpy(np.array(a)).to(cuda)
    crow_t = to(crow).reshape(-1, 1)
    row_start = tref.row_starts(crow_t, m + 1)
    classes = tref.segment_classes(row_start, threshold)
    parts = [to(x).reshape(-1, 1) for x in _combine_partials(gen, n_chunks, kind)]
    want = tref.combine_chunk_partials_ref(*parts, crow_t, row_start)
    tk.reset_launch_counts()
    for got in (tk.combine_chunk_partials_tiles(*parts, crow_t, row_start, classes=classes),
                tk.combine_chunk_partials_tiles(*parts, crow_t, row_start)):
        for g, w in zip(got, want):
            _match_bits(g, w)
    assert tk.launch_counts()["combine_chunk_partials_tiles"] == 2
    bsz = 5
    act = torch.arange(bsz, device=cuda) % 2 == 0
    nodes = [to(x).reshape(bsz, -1, 1)
             for x in _combine_partials(gen, n_chunks, kind, lead=(bsz,))]
    want = tref.node_combine_chunk_partials_ref(*nodes, crow_t, row_start, act)
    got = tk.node_combine_chunk_partials_tiles(*nodes, crow_t, row_start, act, classes=classes)
    for g, w in zip(got, want):
        _match_bits(g[act], w[act])
    for i in act.nonzero().flatten().tolist():
        one = tk.combine_chunk_partials_tiles(*(x[i] for x in nodes), crow_t, row_start)
        for g, w in zip(got, one):
            _match_bits(g[i], w)


def _packed_tiles(gen, t, r, k, n, integer, dev, longest=None):
    """Tiles laid out as the block-ELL conversion lays them out, each
    chunk's nonzeros at its front: lengths 0 (all padding), 1, up to 31
    (shorter than a stride), half of K and K (``longest`` in place of K,
    reached by the first chunk, where given); bounds and sides as
    :func:`_tiles`.  ``clen`` holds the lengths."""
    x = _tiles(gen, t, r, k, n, integer, dev)
    top = k if longest is None else longest
    lengths = gen.choice(sorted({0, 1, min(top, 7), min(top, 31), max(1, top // 2), top}),
                         size=(t, r))
    if longest is not None:
        lengths[0, 0] = longest
    keep = np.arange(k) < lengths[..., None]
    val = np.where(keep, gen.choice([-2.0, -1.0, 1.0, 3.0], size=(t, r, k)), 0.0)
    col = np.where(keep, gen.integers(0, n, size=(t, r, k)), 0).astype(np.int32)
    ii = np.where(keep, gen.random((t, r, k)) < 0.5, 0).astype(np.int32)
    c = lambda a: torch.from_numpy(np.array(a)).to(dev)
    x.update(val=c(val), col=c(col), ii=c(ii), clen=c(lengths.astype(np.int32)))
    return x


LENGTH_SHAPES = [(3, 4, 8, 20), (2, 8, 16, 150), (5, 8, 128, 300), (64, 8, 128, 5000),
                 (4, 8, 200, 400)]


@pytest.mark.parametrize("exact", [True, False], ids=["int", "float"])
@pytest.mark.parametrize("t,r,k,n", LENGTH_SHAPES)
def test_stopped_kernels_match_plain_versions(cuda, gen, t, r, k, n, exact):
    """A' and E stop each chunk at its length: on front-packed tiles (all
    padding, shorter than one stride, K <= 16, K past 128) with the lengths
    given and computed, and on tiles with zeros anywhere (the lengths
    computed), bitwise equal to their plain versions."""
    x = _packed_tiles(gen, t, r, k, n, exact, cuda)
    assert torch.equal(tref.chunk_lengths(x["val"]), x["clen"])
    for y, clen in ((x, x["clen"]), (x, None), (_tiles(gen, t, r, k, n, exact, cuda), None)):
        tk.reset_launch_counts()
        a_args = (y["val"], y["col"], y["lb"], y["ub"], y["n_pad"])
        aggs = tk.activities_gather_tiles(*a_args, chunk_len=clen)
        for g, w in zip(aggs, tref.activities_gather_tiles_ref(*a_args)):
            _match(g, w)
        e_args = (y["val"], y["col"], y["ii"], *aggs, y["lhs"], y["rhs"], y["lb"], y["ub"],
                  y["n_pad"], 1e-6)
        for g, w in zip(tk.candidates_scatter_tiles(*e_args, chunk_len=clen),
                        tref.candidates_scatter_tiles_ref(*e_args)):
            _match(g, w)
        counts = tk.launch_counts()
        assert counts["activities_gather_tiles"] == counts["candidates_scatter_tiles"] == 1


@pytest.mark.parametrize("exact", [True, False], ids=["int", "float"])
@pytest.mark.parametrize("t,r,k,n", LENGTH_SHAPES)
@pytest.mark.parametrize("bsz", [1, 5, 40])
def test_node_multichunk_kernels_match_plain_versions(cuda, gen, t, r, k, n, bsz, exact):
    """The node-batched A', combine and E against their plain versions with
    every, some and no node active: bitwise on the active nodes' planes (the
    kernels leave the partials of inactive nodes unwritten), bitwise on
    every accumulator row (inactive: the sentinels); each active node also
    against the single-instance kernels on its own row."""
    x = _packed_tiles(gen, t, r, k, n, exact, cuda)
    lb, ub = _planes(gen, bsz, x["n_pad"], exact, cuda)
    m = t * r // 3 + 1  # rows of 1-3 adjacent chunks, then the padding row
    cuts = np.sort(gen.choice(np.arange(1, t * r), size=m - 1, replace=False))
    crow = np.zeros(t * r, np.int32)
    crow[cuts] = 1
    crow = np.cumsum(crow).astype(np.int32)
    crow_t = torch.from_numpy(crow.reshape(t, r)).to(cuda)
    row_start = tref.row_starts(crow_t, int(crow.max()) + 1)
    for act in (torch.ones(bsz, dtype=torch.bool), torch.arange(bsz) % 3 == 1,
                torch.zeros(bsz, dtype=torch.bool)):
        act = act.to(cuda)
        on = act.nonzero().flatten().tolist()
        tk.reset_launch_counts()
        a_args = (x["val"], x["col"], lb, ub, act, x["n_pad"])
        parts = tk.node_activities_gather_tiles(*a_args, chunk_len=x["clen"])
        want_p = tref.node_activities_gather_ref(*a_args)
        for g, w in zip(parts, want_p):
            _match(g[act], w[act])
        c_args = (*want_p, crow_t, row_start, act)
        aggs = tk.node_combine_chunk_partials_tiles(*c_args)
        want_a = tref.node_combine_chunk_partials_ref(*c_args)
        for g, w in zip(aggs, want_a):
            _match(g[act], w[act])
        e_args = (x["val"], x["col"], x["ii"], *want_a, x["lhs"], x["rhs"], lb, ub, act,
                  x["n_pad"], 1e-6)
        got = tk.node_candidates_scatter_tiles(*e_args, chunk_len=x["clen"])
        for g, w in zip(got, tref.node_candidates_scatter_ref(*e_args)):
            _match(g, w)
        for i in on[:4]:
            one = tk.activities_gather_tiles(x["val"], x["col"], lb[i], ub[i], x["n_pad"],
                                             chunk_len=x["clen"])
            for g, w in zip(parts, one):
                _match(g[i], w)
            single = tk.combine_chunk_partials_tiles(*one, crow_t, row_start)
            for g, w in zip(aggs, single):
                _match(g[i], w)
            best = tk.candidates_scatter_tiles(x["val"], x["col"], x["ii"], *single, x["lhs"],
                                               x["rhs"], lb[i], ub[i], x["n_pad"], 1e-6,
                                               chunk_len=x["clen"])
            for g, w in zip(got, best):
                _match(g[i], w)
        counts = tk.launch_counts()
        assert (counts["node_activities_gather_tiles"] == counts["node_combine_chunk_partials_tiles"]
                == counts["node_candidates_scatter_tiles"] == 1)


# The forms of node A' and node E (csrc/prop_round.cu, batch_tier_round.cu,
# half_batch_round.cu) and (K, longest chunk) pairs: one thread a chunk at
# group widths 1, 2, 4 and 8 (below or at K), 16 lanes, a warp holding one
# stride and two.
NODE_FORMS = ["f64", "f32", "f32c", "bf16", "bf16c", "f16"]
NODE_LENGTHS = [(4, 1), (4, 2), (4, 3), (4, 4), (8, 5), (8, 8), (64, 1), (64, 9), (64, 17),
                (64, 33)]
POOL_ACTIVE = (0, 1, 8, 33, 128)


def _form_tiles(x, form):
    """Tiles of :func:`_packed_tiles` in one of :data:`NODE_FORMS`."""
    if form == "f64":
        return x
    if form.startswith("f32"):
        return _tier_tiles(x, form == "f32c")
    dtype = torch.bfloat16 if form.startswith("bf16") else torch.float16
    return _half_tiles(x, dtype, form == "bf16c")


def _row_index(gen, t, r, dev):
    """``(chunk_row, row_start)``: rows of one to three adjacent chunks over
    a (T, R) stream, then the padding row."""
    m = t * r // 3 + 1
    crow = np.zeros(t * r, np.int32)
    crow[np.sort(gen.choice(np.arange(1, t * r), size=m - 1, replace=False))] = 1
    crow_t = torch.from_numpy(np.cumsum(crow).astype(np.int32).reshape(t, r)).to(dev)
    return crow_t, tref.row_starts(crow_t, int(crow_t.max()) + 1)


@pytest.mark.parametrize("k,longest", NODE_LENGTHS)
@pytest.mark.parametrize("form", NODE_FORMS)
def test_node_multichunk_kernels_every_form_over_a_pool(cuda, gen, form, k, longest):
    """Node A', the node combine and node E in every form over a 128-node
    pool with 0, 1, 8, 33 and 128 nodes active (scattered, with holes), the
    lanes keyed on the longest chunk (hoisted or K): bitwise as values
    equal to their plain versions on the active rows, fresh or into kept
    buffers (A' and the combine leave the inactive rows of ``out`` as they
    were; E folds into ``acc``, which then holds the plain planes), each
    launching its form."""
    bsz, t, r, n = 128, 24, 8, 700
    x = _form_tiles(_packed_tiles(gen, t, r, k, n, True, cuda, longest=longest), form)
    dt = x["val"].dtype
    lb, ub = (p.to(dt) for p in _planes(gen, bsz, x["n_pad"], True, cuda))
    _, int_eps, inf, _ = rt.core.propagator.round_scalars(rt.core.DEFAULT_CONFIG, dt)
    crow_t, row_start = _row_index(gen, t, r, cuda)
    value_form = {"f32c": "f32", "bf16c": "bf16"}.get(form, form)
    tk.reset_launch_counts()
    for n_act in POOL_ACTIVE:
        act = torch.zeros(bsz, dtype=torch.bool)
        act[gen.choice(bsz, size=n_act, replace=False)] = True
        act = act.to(cuda)
        a_args = (x["val"], x["col"], lb, ub, act, x["n_pad"], inf)
        want_p = tref.node_activities_gather_ref(*a_args)
        out = tuple(torch.full_like(w, 7) for w in want_p)
        for hoisted in (dict(max_chunk_len=longest), {}):
            for g, w in zip(tk.node_activities_gather_tiles(*a_args, chunk_len=x["clen"],
                                                            **hoisted), want_p):
                _match_values(g[act], w[act])
        kept = tk.node_activities_gather_tiles(*a_args, chunk_len=x["clen"],
                                               max_chunk_len=longest, out=out)
        for g, o, w in zip(kept, out, want_p):
            assert g is o
            _match_values(g[act], w[act])
            assert bool((g[~act] == 7).all())
        c_args = (*want_p, crow_t, row_start, act)
        want_a = tref.node_combine_chunk_partials_ref(*c_args)
        out = tuple(torch.full_like(w, 7) for w in want_a)
        for got in (tk.node_combine_chunk_partials_tiles(*c_args),
                    tk.node_combine_chunk_partials_tiles(*c_args, out=out)):
            for g, w in zip(got, want_a):
                _match_values(g[act], w[act])
        assert all(bool((o[~act] == 7).all()) for o in out)
        e_args = (x["val"], x["col"], x["ii"], *want_a, x["lhs"], x["rhs"], lb, ub, act,
                  x["n_pad"], int_eps, inf)
        want_e = tref.node_candidates_scatter_ref(*e_args)
        acc = tk.accumulator_planes(lb, inf)
        for hoisted in (dict(max_chunk_len=longest), {}, dict(max_chunk_len=longest, acc=acc)):
            got = tk.node_candidates_scatter_tiles(*e_args, chunk_len=x["clen"], **hoisted)
            for g, w in zip(got, want_e):
                _match_values(g, w)
        assert got[0] is acc[0] and got[1] is acc[1]
    n = len(POOL_ACTIVE)
    assert tk.form_counts() == {f"node_activities_gather_tiles[{form}]": 3 * n,
                                f"node_combine_chunk_partials_tiles[{value_form}]": 2 * n,
                                f"node_candidates_scatter_tiles[{form}]": 3 * n}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16, torch.float16])
def test_multichunk_node_rounds_in_a_row_match_plain_rounds(cuda, dtype):
    """Two multi-chunk node rounds in a row through one closure, on other
    masks each time: each equals the plain round bitwise as values (node E
    scatters into the closure's kept planes, which #9 hands back: clean
    after each round), and the second round allocates nothing on the card
    (A' and the combine write into buffers kept by the closure)."""
    p = td.make_pseudo_boolean(n=3000, m=4000, seed=7, unit_frac=0.002)
    prep = rt.prepare_block_ell(p, tile_width=4, dtype=dtype, device=cuda)
    assert not prep.fits_one_chunk
    kernel = tk.node_round_fn_for(prep)
    plain = tk.node_round_fn_for(prep, use_kernels=False)
    lb_h, ub_h = _nodes(p, 40, seed=5)
    lb, ub = tk.ops._node_planes(prep, lb_h, ub_h)
    lbk, ubk, lbp, ubp = lb.clone(), ub.clone(), lb.clone(), ub.clone()
    inf = rt.core.propagator.round_scalars(rt.core.DEFAULT_CONFIG, prep.d.val.dtype)[2]
    for i, act in enumerate((torch.arange(40) % 3 != 1, torch.arange(40) % 4 == 0)):
        act = act.to(cuda)
        torch.cuda.synchronize()
        before = torch.cuda.memory_stats()["allocation.all.allocated"]
        lbk, ubk, ch_k = kernel(lbk, ubk, act)
        torch.cuda.synchronize()
        if i:
            assert torch.cuda.memory_stats()["allocation.all.allocated"] == before
        lbp, ubp, ch_p = plain(lbp, ubp, act)
        for g, w in ((lbk, lbp), (ubk, ubp), (ch_k, ch_p)):
            _match_values(g, w)
        planes = kernel.kept.planes
        assert bool((planes[0] == -inf).all() and (planes[1] == inf).all())


@pytest.mark.parametrize("tile_width", [2, 4])
def test_multichunk_node_round_launches_do_not_grow_with_the_batch(cuda, tile_width):
    """One multi-chunk node round makes the same launches for B = 4 and B =
    128 -- A', the combine and E over the batch, then the batched merge --
    and each node's row equals its own single-instance round."""
    p = td.make_pseudo_boolean(n=3000, m=4000, seed=7)
    prep = rt.prepare_block_ell(p, tile_width=tile_width, device=cuda)
    assert not prep.fits_one_chunk
    round_fn = tk.node_round_fn_for(prep)
    per_batch = []
    for bsz in (4, 128):
        lb_h, ub_h = _nodes(p, bsz, seed=bsz)
        lb, ub = tk.ops._node_planes(prep, lb_h, ub_h)
        act = torch.ones(bsz, dtype=torch.bool, device=cuda)
        act[1::3] = False
        want = [tk.round_fn_for(prep)(lb[i].clone(), ub[i].clone()) for i in range(bsz)]
        tk.reset_launch_counts()
        new_lb, new_ub, changed = round_fn(lb.clone(), ub.clone(), act)
        per_batch.append(tk.launch_counts())
        for i in range(bsz):
            if act[i]:
                _match(new_lb[i], want[i][0])
                _match(new_ub[i], want[i][1])
                assert bool(changed[i]) == bool(want[i][2])
            else:
                _match(new_lb[i], lb[i])
                assert not bool(changed[i])
    assert per_batch[0] == per_batch[1]
    used = {k for k, v in per_batch[0].items() if v}
    assert used == {"node_activities_gather_tiles", "node_combine_chunk_partials_tiles",
                    "node_candidates_scatter_tiles", "apply_updates_batch_tiles"}
    assert all(v in (0, 1) for v in per_batch[0].values())


def test_multichunk_solve_on_card_matches_plain_path_and_one_chunk_search(cuda):
    """solve at tile width 4 (rows span two chunks) through the node-batched
    kernels: the plain path's search and pool, and the tile-width-8
    search's (integral data)."""
    p = td.make_pseudo_boolean(n=40, m=56, seed=3)
    c = np.arange(1, p.n + 1, dtype=np.float64) * np.where(np.arange(p.n) % 3 == 0, -1.0, 1.0)
    tk.reset_launch_counts()
    a = rt.solve(p, c, node_cap=64, max_levels=12, tile_width=4)
    counts = tk.launch_counts()
    assert counts["node_candidates_scatter_tiles"] > 0 and counts["candidates_scatter_tiles"] == 0
    b = rt.solve(p, c, node_cap=64, max_levels=12, tile_width=4, use_kernels=False)
    one = rt.solve(p, c, node_cap=64, max_levels=12, tile_width=8)
    for other in (b, one):
        for f in ("status", "objective", "nodes_expanded", "nodes_created", "leaves",
                  "pruned_bound", "pruned_infeasible", "levels", "host_syncs",
                  "incumbent_trajectory"):
            assert getattr(a, f) == getattr(other, f), f
        for x, y in zip(a.carry, other.carry):
            _match(x, y)


def _nodes(p, count, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        lb, ub = p.lb.copy(), p.ub.copy()
        for var in rng.choice(p.n, size=3, replace=False):
            if p.is_int[var] and lb[var] < ub[var]:
                down, up = rt.core.branch_children(lb, ub, int(var), lb[var])
                lb, ub = down if rng.random() < 0.5 else up
        out.append((lb, ub))
    return np.stack([a for a, _ in out]), np.stack([b for _, b in out])


@pytest.mark.parametrize("gen_name,kw,tile_width", [
    ("make_pseudo_boolean", dict(n=3000, m=4000, seed=7), 8),
    ("make_knapsack", dict(n=40, m=10, seed=2), 8),
    ("make_mixed", dict(m=600, n=450, seed=21), 16),
    ("make_pseudo_boolean", dict(n=3000, m=4000, seed=7), 4),
    ("make_mixed", dict(m=600, n=450, seed=21), 128),
])
def test_nodes_on_card_match_plain_path_and_single_runs(cuda, gen_name, kw, tile_width):
    p = getattr(td, gen_name)(**kw)
    lb, ub = _nodes(p, 6)
    tk.reset_launch_counts()
    got = rt.propagate_nodes(p, lb, ub, tile_width=tile_width)
    counts = tk.launch_counts()
    plain = rt.propagate_nodes(p, lb, ub, tile_width=tile_width, use_kernels=False)
    rounds = int(got.rounds.max())
    if tk.rows_fit_one_chunk(p, tile_width):
        assert counts["node_fused_scatter_round_tiles"] == rounds
    else:
        # The multi-chunk node round: A', the combine and E over the batch.
        assert (counts["node_activities_gather_tiles"] == counts["node_combine_chunk_partials_tiles"]
                == counts["node_candidates_scatter_tiles"] == rounds)
        assert counts["activities_gather_tiles"] == counts["combine_chunk_partials_tiles"] == 0
    for f in ("lb", "ub", "rounds", "converged", "infeasible"):
        _match(getattr(got, f), getattr(plain, f))
    for i in range(lb.shape[0]):
        single = rt.propagate_block_ell(p, tile_width=tile_width, lb0=lb[i], ub0=ub[i])
        _match(got.lb[i], single.lb)
        _match(got.ub[i], single.ub)
        assert got.rounds[i].item() == single.rounds.item()


def test_solve_on_card_matches_plain_path(cuda):
    p = td.make_pseudo_boolean(n=40, m=56, seed=3)
    c = np.arange(1, p.n + 1, dtype=np.float64) * np.where(np.arange(p.n) % 3 == 0, -1.0, 1.0)
    tk.reset_launch_counts()
    a = rt.solve(p, c, node_cap=64, max_levels=12)
    assert tk.launch_counts()["node_objective_tiles"] == a.levels
    b = rt.solve(p, c, node_cap=64, max_levels=12, use_kernels=False)
    for f in ("status", "objective", "nodes_expanded", "nodes_created", "leaves",
              "pruned_bound", "pruned_infeasible", "levels", "host_syncs",
              "incumbent_trajectory"):
        assert getattr(a, f) == getattr(b, f), f
    for x, y in zip(a.carry, b.carry):
        _match(x, y)


# ---------------------------------------------------------------------------
# The column-slab partitioned engine: kernels #11-#15
# ---------------------------------------------------------------------------


def _packed_partition(problems, tile_width, slab, dev):
    """One slab partition over the tile streams of several instances (run
    maps route each copy to its own instance's plane row)."""
    from repro_torch.kernels import build_slab_partition

    preps = [rt.prepare_block_ell(p, tile_width=tile_width, device="cpu") for p in problems]
    n_pad = max(q.n_pad for q in preps)
    vals, cols, crows, insts, lhs, rhs, dummies = [], [], [], [], [], [], []
    is_int = np.zeros((len(preps), n_pad), bool)
    off = 0
    for i, q in enumerate(preps):
        vals.append(q.d.val.numpy())
        cols.append(q.d.col.numpy())
        crows.append(q.d.chunk_row.numpy() + off)
        insts.append(np.full(q.d.val.shape[0], i, np.int32))
        lhs.append(q.d.lhs1.numpy())
        rhs.append(q.d.rhs1.numpy())
        is_int[i, : q.n] = q.d.is_int.numpy()
        dummies.append(off + q.m)
        off += q.m + 1
    return build_slab_partition(
        np.concatenate(vals), np.concatenate(cols), np.concatenate(crows),
        np.concatenate(insts), np.concatenate(lhs), np.concatenate(rhs), is_int, n_pad, slab,
        np.array(dummies, np.int32), device=dev,
    ), n_pad


SLAB_CASES = [
    # (generator, kwargs, tile width, slab, integer data)
    ("make_knapsack", dict(n=280, m=8, seed=5), 8, 128, True),
    ("make_mixed", dict(m=30, n=280, seed=0), 16, 128, False),
    ("make_banded", dict(n=3000, m=400, row_nnz=12, band=600, seed=1), 128, 256, False),
]


@pytest.mark.parametrize("instances", [1, 3])
@pytest.mark.parametrize("gen_name,kw,tile_width,slab,exact", SLAB_CASES)
def test_slab_kernels_match_plain_versions(cuda, gen, gen_name, kw, tile_width, slab, exact,
                                           instances):
    problems = [getattr(td, gen_name)(**{**kw, "seed": kw["seed"] + i}) for i in range(instances)]
    part, n_pad = _packed_partition(problems, tile_width, slab, cuda)
    assert part.has_straddle
    for width in (part.n_pad_part, n_pad):
        lb, ub = _planes(gen, instances, width, exact, cuda)
        for act in (torch.ones(instances, dtype=torch.bool), torch.arange(instances) % 2 == 0,
                    torch.zeros(instances, dtype=torch.bool)):
            act = act.to(cuda)
            tk.reset_launch_counts()
            a_args = (part.a_val, part.a_col_s, part.a_run_start, part.a_run_len,
                      part.a_run_inst, part.a_run_slab, act, lb, ub, slab, part.a_max_run_len)
            partials = tk.batched_slab_partials_tiles(*a_args)
            for g, w in zip(partials, tref.batched_slab_partials_ref(*a_args)):
                _match(g, w)
            index = (part.a_order, part.a_seg, part.agg_slot)
            strs = tk.straddle_combine_tiles(*partials, *index)
            for g, w in zip(strs, tref.straddle_combine_ref(*partials, *index)):
                _match(g, w)
            done = part.row_done == 0
            for g, w in zip(strs, tref.straddle_tables(part, *partials)):
                _match(g[done], w[done])
            r_args = (part.val, part.col_s, part.ii_g, part.row_done, *strs, part.lhs_g,
                      part.rhs_g, part.run_start, part.run_len, part.run_inst, part.run_slab,
                      act)
            want = tref.batched_slab_round_ref(*r_args, lb, ub, slab, part.max_run_len, 1e-9,
                                               1e-6)
            glb, gub = lb.clone(), ub.clone()
            acc = tk.accumulator_planes(lb)
            got = tk.batched_slab_round_tiles(*r_args, glb, gub, slab, part.max_run_len, 1e-9,
                                              1e-6, acc=acc, tiles=(part.tile_inst,
                                                                    part.tile_slab),
                                              chunk_len=part.chunk_len)
            assert got[0] is glb and got[1] is gub
            for g, w in zip(got, want):
                _match(g, w)
            assert _clean(acc)
            assert tk.launch_counts() == {
                fn.__name__: int(fn.__name__ in ("batched_slab_partials_tiles",
                                                 "straddle_combine_tiles",
                                                 "batched_slab_round_tiles",
                                                 "apply_updates_slab_tiles"))
                for fn in tk.KERNELS
            }


@pytest.mark.parametrize("bsz", [1, 5, 40])
@pytest.mark.parametrize("gen_name,kw,tile_width,slab,exact", SLAB_CASES)
def test_node_slab_kernels_match_plain_versions(cuda, gen, gen_name, kw, tile_width, slab,
                                                exact, bsz):
    p = getattr(td, gen_name)(**kw)
    prep = rt.prepare_block_ell(p, tile_width=tile_width)
    part = prep.slab_partition(slab)
    lb, ub = _planes(gen, bsz, prep.n_pad, exact, cuda)
    for act in (torch.ones(bsz, dtype=torch.bool), torch.arange(bsz) % 3 == 1,
                torch.zeros(bsz, dtype=torch.bool)):
        act = act.to(cuda)
        tk.reset_launch_counts()
        a_args = (part.a_val, part.a_col_s, part.a_run_start, part.a_run_len, part.a_run_slab,
                  act, lb, ub, slab, part.a_max_run_len)
        partials = tk.node_slab_partials_tiles(*a_args)
        # Inactive nodes' partials are not written: active planes only.
        for g, w in zip(partials, tref.node_slab_partials_ref(*a_args)):
            _match(g[act], w[act])
        index = (part.a_order, part.a_seg, part.agg_slot)
        strs = tk.straddle_combine_tiles(*partials, *index, act)
        done = part.row_done == 0
        for g, w, t in zip(strs, tref.straddle_combine_ref(*partials, *index, act),
                           tref.straddle_tables(part, *partials)):
            _match(g[act], w[act])
            _match(g[act][:, done], t[act][:, done])
        r_args = (part.val, part.col_s, part.ii_g, part.row_done, *strs, part.lhs_g,
                  part.rhs_g, part.run_start, part.run_len, part.run_slab, act)
        want = tref.node_slab_round_ref(*r_args, lb, ub, slab, part.max_run_len, 1e-9, 1e-6)
        glb, gub = lb.clone(), ub.clone()
        acc = tk.accumulator_planes(lb)
        got = tk.node_slab_round_tiles(*r_args, glb, gub, slab, part.max_run_len, 1e-9, 1e-6,
                                       acc=acc, tile_slab=part.tile_slab,
                                       chunk_len=part.chunk_len)
        for g, w in zip(got, want):
            _match(g, w)
        assert _clean(acc)
        # Each active node equals the single-instance kernels on its plane.
        for i in act.nonzero().flatten().tolist()[:3]:
            one = tk.batched_slab_partials_tiles(
                part.a_val, part.a_col_s, part.a_run_start, part.a_run_len, part.a_run_inst,
                part.a_run_slab, act[i : i + 1], lb[i : i + 1].contiguous(),
                ub[i : i + 1].contiguous(), slab, part.a_max_run_len)
            for g, w in zip(partials, one):
                _match(g[i], w)
        counts = tk.launch_counts()
        assert (counts["node_slab_partials_tiles"] == counts["straddle_combine_tiles"]
                == counts["node_slab_round_tiles"] == 1)
        assert counts["combine_chunk_partials_tiles"] == 0


@pytest.mark.parametrize("kind", ["float", "zeros", "negzero"])
@pytest.mark.parametrize("n_act", [0, 8, 128])
def test_straddle_combine_matches_plain_version(cuda, gen, kind, n_act):
    """The straddle combine over 128 planes with 0, 8 and 128 active:
    bitwise (bit patterns) equal to its plain version on the active planes,
    and to ``straddle_tables`` where ``row_done == 0``; the single-plane
    form (no mask) too."""
    p = td.make_knapsack(n=280, m=8, seed=5)
    part = rt.prepare_block_ell(p, tile_width=8).slab_partition(128)
    assert part.has_straddle
    ta, r = part.a_slot.shape
    bsz = 128
    act = torch.zeros(bsz, dtype=torch.bool, device=cuda)
    if n_act:
        act[:: bsz // n_act] = True
    to = lambda a: torch.from_numpy(np.array(a)).to(cuda).reshape(bsz, ta, r)
    parts = [to(x) for x in _combine_partials(gen, ta * r, kind, lead=(bsz,))]
    index = (part.a_order, part.a_seg, part.agg_slot)
    done = part.row_done == 0
    tk.reset_launch_counts()
    got = tk.straddle_combine_tiles(*parts, *index, act)
    want = tref.straddle_combine_ref(*parts, *index, act)
    tables = tref.straddle_tables(part, *parts)
    for g, w, t in zip(got, want, tables):
        _match_bits(g[act], w[act])
        _match_bits(g[act][:, done], t[act][:, done])
    one = tk.straddle_combine_tiles(*(x[0] for x in parts), *index)
    for g, t in zip(one, tables):
        _match_bits(g[done], t[0][done])
    assert tk.launch_counts()["straddle_combine_tiles"] == 2


@pytest.mark.parametrize("exact", [True, False], ids=["int", "float"])
@pytest.mark.parametrize("bsz,width", [(1, 512), (4, 300), (3, 150_016)])
def test_window_merge_matches_plain_version(cuda, gen, bsz, width, exact):
    lb, ub = _planes(gen, bsz, width, exact, cuda)
    bl, bu = _planes(gen, bsz, width, exact, cuda)
    bl, bu = bl - 1.0, bu + 1.0
    act = (torch.arange(bsz) % 2 == 0).to(cuda)
    want = tref.apply_updates_slab_ref(lb, ub, bl, bu, act, 128, 1e-9)
    glb, gub = lb.clone(), ub.clone()
    old_l, old_u = bl.clone(), bu.clone()
    tk.reset_launch_counts()
    got = tk.apply_updates_slab_tiles(glb, gub, bl, bu, act, 128, 1e-9)
    assert got[0] is glb and tk.launch_counts()["apply_updates_slab_tiles"] == 1
    _match(got[0], want[0])
    _match(got[1], want[1])
    _match(got[2], want[2].any(dim=1))
    # The merge hands the active rows back at the sentinels.
    assert _clean((bl[act], bu[act]))
    _match(bl[~act], old_l[~act])
    _match(bu[~act], old_u[~act])


@pytest.mark.parametrize("gen_name,kw,tile_width,exact", [
    ("make_knapsack", dict(n=280, m=8, seed=5), 8, True),
    ("make_mixed", dict(m=35, n=300, seed=1), 32, False),
    ("make_pseudo_boolean", dict(n=3000, m=4000, seed=7), 8, True),
])
def test_partitioned_engine_on_card_matches_plain_path(cuda, gen_name, kw, tile_width, exact):
    p = getattr(td, gen_name)(**kw)
    tk.reset_launch_counts()
    got = rt.propagate_block_ell(p, tile_width=tile_width, scatter="partitioned", slab=128)
    counts = tk.launch_counts()
    rounds = _enqueued(int(got.rounds))
    assert counts["batched_slab_round_tiles"] == counts["apply_updates_slab_tiles"] == rounds
    assert counts["batched_slab_partials_tiles"] == rounds
    assert counts["fused_scatter_round_tiles"] == 0
    plain = rt.propagate_block_ell(p, tile_width=tile_width, scatter="partitioned", slab=128,
                                   use_kernels=False)
    for f in ("lb", "ub", "rounds", "converged", "infeasible"):
        _match(getattr(got, f), getattr(plain, f))
    cpu = rt.propagate_block_ell(p, tile_width=tile_width, scatter="partitioned", slab=128,
                                 device="cpu")
    _match(got.lb, cpu.lb.to(cuda))
    _match(got.ub, cpu.ub.to(cuda))


def test_instance_past_the_limit_on_card(cuda):
    """``auto`` past 2^16 columns takes the partitioned kernels; explicit
    ``fused`` runs D + F there; both agree with the plain path."""
    p = td.make_banded(n=tk.SCATTER_MAX_NPAD + 4000, m=3000, row_nnz=8, band=2000, seed=2)
    tk.reset_launch_counts()
    got = rt.propagate_block_ell(p)
    counts = tk.launch_counts()
    assert counts["batched_slab_round_tiles"] == _enqueued(int(got.rounds)) > 0
    assert counts["fused_scatter_round_tiles"] == 0
    plain = rt.propagate_block_ell(p, use_kernels=False)
    for f in ("lb", "ub", "rounds", "converged", "infeasible"):
        _match(getattr(got, f), getattr(plain, f))
    fused = rt.propagate_block_ell(p, scatter="fused")
    assert tk.launch_counts()["fused_scatter_round_tiles"] == _enqueued(int(fused.rounds))
    for f in ("rounds", "converged", "infeasible"):
        assert getattr(fused, f).item() == getattr(got, f).item()
    assert rt.bounds_equal(fused.lb, fused.ub, got.lb, got.ub)


@pytest.fixture
def small_limit(monkeypatch):
    from repro_torch.kernels import ops

    ops.clear_prepare_cache()
    monkeypatch.setattr(ops, "SCATTER_MAX_NPAD", 128)
    monkeypatch.setattr(ops, "SLAB_NPAD", 128)
    yield
    ops.clear_prepare_cache()


@pytest.mark.parametrize("gen_name,kw,tile_width", [
    ("make_pseudo_boolean", dict(n=3000, m=4000, seed=7), 8),
    ("make_mixed", dict(m=600, n=450, seed=21), 16),
])
def test_nodes_past_the_limit_on_card(cuda, small_limit, gen_name, kw, tile_width):
    p = getattr(td, gen_name)(**kw)
    lb, ub = _nodes(p, 6)
    tk.reset_launch_counts()
    got = rt.propagate_nodes(p, lb, ub, tile_width=tile_width)
    counts = tk.launch_counts()
    assert counts["node_slab_round_tiles"] == int(got.rounds.max())
    assert counts["node_slab_partials_tiles"] == int(got.rounds.max())
    assert counts["node_fused_scatter_round_tiles"] == 0
    plain = rt.propagate_nodes(p, lb, ub, tile_width=tile_width, use_kernels=False)
    for f in ("lb", "ub", "rounds", "converged", "infeasible"):
        _match(getattr(got, f), getattr(plain, f))
    for i in range(lb.shape[0]):
        single = rt.propagate_block_ell(p, tile_width=tile_width, lb0=lb[i], ub0=ub[i])
        _match(got.lb[i], single.lb)
        _match(got.ub[i], single.ub)
        assert got.rounds[i].item() == single.rounds.item()


def test_solve_past_the_limit_on_card(cuda, small_limit):
    p = td.make_pseudo_boolean(n=200, m=260, seed=1)
    c = np.arange(1, p.n + 1, dtype=np.float64) * np.where(np.arange(p.n) % 3 == 0, -1.0, 1.0)
    tk.reset_launch_counts()
    a = rt.solve(p, c, node_cap=32)
    counts = tk.launch_counts()
    assert counts["node_slab_round_tiles"] > 0 and counts["node_fused_scatter_round_tiles"] == 0
    b = rt.solve(p, c, node_cap=32, use_kernels=False)
    for f in ("status", "objective", "nodes_expanded", "nodes_created", "leaves",
              "pruned_bound", "pruned_infeasible", "levels", "host_syncs",
              "incumbent_trajectory"):
        assert getattr(a, f) == getattr(b, f), f
    for x, y in zip(a.carry, b.carry):
        _match(x, y)


# ---------------------------------------------------------------------------
# Kernel #8, the batched engine and the service
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("exact", [True, False], ids=["int", "float"])
@pytest.mark.parametrize("mask", ["on", "mixed", "off"])
@pytest.mark.parametrize("sizes,r,k,n", [((2, 3, 1), 4, 8, 20), ((1, 4, 2), 8, 128, 300),
                                         ((40, 7, 90), 8, 4, 5000)])
def test_batched_fused_kernel_matches_plain_version(cuda, gen, sizes, r, k, n, mask, exact):
    bsz = len(sizes)
    xs = [_tiles(gen, s, r, k, n, exact, cuda) for s in sizes]
    cat = lambda f: torch.cat([x[f] for x in xs])
    val, col, ii, lhs, rhs = cat("val"), cat("col"), cat("ii"), cat("lhs"), cat("rhs")
    lb = torch.stack([x["lb"] for x in xs])
    ub = torch.stack([x["ub"] for x in xs])
    n_pad = xs[0]["n_pad"]
    tile_inst = torch.repeat_interleave(torch.arange(bsz, dtype=torch.int32, device=cuda),
                                        torch.tensor(sizes, device=cuda))
    active = torch.tensor({"on": [True] * 3, "mixed": [True, False, True],
                           "off": [False] * 3}[mask], device=cuda)
    tk.reset_launch_counts()
    got = tk.batched_fused_scatter_round_tiles(val, col, ii, lhs, rhs, lb, ub, tile_inst,
                                               active, n_pad, 1e-6,
                                               acc=tk.accumulator_planes(lb))
    assert tk.launch_counts()["batched_fused_scatter_round_tiles"] == 1
    want = tref.batched_fused_scatter_round_ref(
        val, tref.global_columns(col, tile_inst, n_pad), ii, lhs, rhs, lb, ub, n_pad, 1e-6,
        active=active)
    for g, w in zip(got, want):
        _match(g, w)
    for i, x in enumerate(xs):
        if not active[i]:
            assert (got[0][i] == -INF).all() and (got[1][i] == INF).all()
            continue
        one = tk.fused_scatter_round_tiles(x["val"], x["col"], x["ii"], x["lhs"], x["rhs"],
                                           x["lb"], x["ub"], n_pad, 1e-6)
        _match(got[0][i], one[0])
        _match(got[1][i], one[1])
    lbw, ubw = lb.clone(), ub.clone()
    acc = tk.accumulator_planes(lb)
    occ = tk.batched_occupancy_round_tiles(val, col, ii, lhs, rhs, lbw, ubw, tile_inst, active,
                                           n_pad, 1e-9, 1e-6, acc=acc)
    merged = rt.core.apply_updates_batch(lb, ub, *want, 1e-9, active=active)
    assert occ[0] is lbw and tk.launch_counts()["apply_updates_batch_tiles"] == 1
    for g, w in zip(occ, merged):
        _match(g, w)
    assert _clean(acc)


BATCHES = [
    # (population, tile width): rows in one chunk (#8 + #9) and spanning chunks.
    (lambda: [td.make_pseudo_boolean(n=3000, m=4000, seed=s) for s in (7, 8, 9)], 128),
    (lambda: [td.make_mixed(m=600, n=450, seed=s) for s in (21, 22, 23)], 16),
    (lambda: [td.make_knapsack(n=200, m=30, seed=s) for s in range(4)], 8),
]


@pytest.mark.parametrize("case", range(len(BATCHES)))
def test_batch_on_card_matches_plain_path_and_single_runs(cuda, case):
    make, tile_width = BATCHES[case]
    probs = make()
    tk.reset_launch_counts()
    got = rt.propagate_batch(probs, tile_width=tile_width)
    counts = tk.launch_counts()
    fused = all(int(np.diff(p.csr.row_ptr).max()) <= tile_width for p in probs)
    branch = "batched_fused_scatter_round_tiles" if fused else "combine_chunk_partials_tiles"
    rounds = max(int(r.rounds) for r in got)
    assert counts[branch] == counts["apply_updates_batch_tiles"] == rounds
    plain = rt.propagate_batch(probs, tile_width=tile_width, use_kernels=False)
    host = rt.propagate_batch(probs, tile_width=tile_width, driver="host_loop")
    for p, g, w, h in zip(probs, got, plain, host):
        single = rt.propagate_block_ell(p, tile_width=tile_width)
        for f in ("lb", "ub", "rounds", "converged", "infeasible"):
            _match(getattr(g, f), getattr(w, f))
            _match(getattr(g, f), getattr(h, f))
            _match(getattr(g, f), getattr(single, f))
        _match(g.progress, w.progress)


def test_batch_past_the_limit_on_card(cuda, small_limit):
    probs = [td.make_knapsack(n=280, m=8, seed=5), td.make_set_cover(n=270, m=25, seed=6)]
    tk.reset_launch_counts()
    got = rt.propagate_batch(probs, tile_rows=2, tile_width=8)
    counts = tk.launch_counts()
    assert counts["batched_slab_round_tiles"] == max(int(r.rounds) for r in got) > 0
    assert counts["batched_fused_scatter_round_tiles"] == 0
    plain = rt.propagate_batch(probs, tile_rows=2, tile_width=8, use_kernels=False)
    for p, g, w in zip(probs, got, plain):
        single = rt.propagate_block_ell(p, tile_rows=2, tile_width=8)
        for f in ("lb", "ub", "rounds", "converged", "infeasible"):
            _match(getattr(g, f), getattr(w, f))
            _match(getattr(g, f), getattr(single, f))


@pytest.mark.parametrize("tile_width", [128, 4])
def test_service_on_card_matches_one_shot(cuda, tile_width):
    """Fused (#8 + #9 at tile width 128) and multi-chunk (A', combine, E, #9
    at 4, where rows of 5 to 8 nonzeros span two chunks) buckets through
    two slots, inline and from the background thread: every ticket bitwise
    against the one-shot batch; nothing is built after construction."""
    probs = [td.make_pseudo_boolean(n=3000, m=m, seed=s)
             for s, m in enumerate((4000, 2500, 3500, 3000, 1800))]
    svc = rt.PropagationService.from_problems(probs, slots=2, tile_width=tile_width)
    cc = svc.compile_counts()
    tk.reset_launch_counts()
    results = svc.serve(probs)
    counts = tk.launch_counts()
    if tile_width == 128:
        assert counts["batched_fused_scatter_round_tiles"] > 0
    else:
        assert counts["activities_gather_tiles"] == counts["candidates_scatter_tiles"] > 0
    with svc:
        tickets = [svc.submit(p) for p in probs]
        threaded = [t.result(timeout=60) for t in tickets]
    assert svc.compile_counts() == cc
    for p, r, t in zip(probs, results, threaded):
        one = rt.propagate_batch([p], tile_width=tile_width)[0]
        for f in ("lb", "ub", "rounds", "converged", "infeasible", "progress"):
            _match(getattr(r, f).to(cuda), getattr(one, f))
            _match(getattr(t, f).to(cuda), getattr(one, f))


# ---------------------------------------------------------------------------
# The segment (seed) round: kernels A, B, C and the segment engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("exact", [True, False], ids=["int", "float"])
@pytest.mark.parametrize("t,r,k,n", SHAPES)
def test_segment_kernels_match_plain_versions(cuda, gen, t, r, k, n, exact):
    x = _tiles(gen, t, r, k, n, exact, cuda)
    c = x["col"].long()
    lb_g, ub_g = x["lb"][c], x["ub"][c]
    tk.reset_launch_counts()
    partials = tk.activities_tiles(x["val"], lb_g, ub_g)
    for g, w in zip(partials, tref.activities_tiles_ref(x["val"], lb_g, ub_g)):
        _match(g, w)
    b_args = (x["val"], lb_g, ub_g, x["ii"], *partials, x["lhs"], x["rhs"], 1e-6)
    for g, w in zip(tk.candidates_tiles(*b_args), tref.candidates_tiles_ref(*b_args)):
        _match(g, w)
    c_args = (x["val"], lb_g, ub_g, x["ii"], x["lhs"], x["rhs"], 1e-6)
    got = tk.fused_round_tiles(*c_args)
    for g, w in zip(got, tref.fused_round_tiles_ref(*c_args)):
        _match(g, w)
    # Bool marks widen to int32, as the reference's _int_operand does.
    for g, w in zip(tk.fused_round_tiles(x["val"], lb_g, ub_g, x["ii"] != 0, *c_args[4:]), got):
        _match(g, w)
    # C's candidates reduce to kernel D's column max/min.
    best = tref.scatter_round_ref(*got, x["col"], x["n_pad"])
    d_args = (x["val"], x["col"], x["ii"], x["lhs"], x["rhs"], x["lb"], x["ub"], x["n_pad"], 1e-6)
    for g, w in zip(best, tk.fused_scatter_round_tiles(*d_args)):
        _match(g, w)
    counts = tk.launch_counts()
    assert (counts["activities_tiles"], counts["candidates_tiles"],
            counts["fused_round_tiles"]) == (1, 1, 2)


def test_segment_wrappers_check_operands(cuda, gen):
    x = _tiles(gen, 2, 2, 4, 10, True, cuda)
    c = x["col"].long()
    lb_g, ub_g = x["lb"][c], x["ub"][c]
    with pytest.raises(ValueError, match="lb_g"):
        tk.activities_tiles(x["val"], x["lb"], ub_g)
    with pytest.raises(TypeError, match="is_int_g"):
        tk.fused_round_tiles(x["val"], lb_g, ub_g, x["ii"].long(), x["lhs"], x["rhs"], 1e-6)
    with pytest.raises(ValueError, match="device"):
        tk.fused_round_tiles(x["val"], lb_g.cpu(), ub_g, x["ii"], x["lhs"], x["rhs"], 1e-6)


@pytest.mark.parametrize("gen_name,kw,tile_width", [
    ("make_pseudo_boolean", dict(n=3000, m=4000, seed=7), 128),
    ("make_pseudo_boolean", dict(n=3000, m=4000, seed=7), 4),
    ("make_cascade_chain", dict(length=40), 4),
    ("make_mixed", dict(m=600, n=450, seed=21), 128),
    ("make_mixed", dict(m=600, n=450, seed=21), 16),
])
def test_segment_engine_on_card_matches_fused_engine(cuda, gen_name, kw, tile_width):
    """The segment engine sums each row in the fused engine's order through
    the same combine: the two give the same rounds and bounds, bitwise."""
    p = getattr(td, gen_name)(**kw)
    tk.reset_launch_counts()
    got = rt.propagate_block_ell(p, tile_width=tile_width, scatter="segment")
    counts = tk.launch_counts()
    rounds = _enqueued(int(got.rounds), gated=False)
    assert counts["apply_updates_tiles"] == rounds
    if tk.rows_fit_one_chunk(p, tile_width):
        assert counts["fused_round_tiles"] == rounds
    else:
        assert counts["activities_tiles"] == counts["candidates_tiles"] == rounds
        assert counts["combine_chunk_partials_tiles"] == rounds
    assert counts["fused_scatter_round_tiles"] == counts["activities_gather_tiles"] == 0
    fused = rt.propagate_block_ell(p, tile_width=tile_width, scatter="fused")
    plain = rt.propagate_block_ell(p, tile_width=tile_width, scatter="segment",
                                   use_kernels=False)
    for other in (fused, plain):
        for f in ("lb", "ub", "rounds", "converged", "infeasible"):
            _match(getattr(got, f), getattr(other, f))


def test_segment_auto_past_the_limit_on_card(cuda, small_limit, monkeypatch):
    """Under the override ``auto`` takes the segment engine past the limit:
    bitwise the explicit fused engine, and the partitioned engine's rounds
    and bounds (``bounds_equal``: its straddle rows sum in another order)."""
    p = td.make_banded(n=600, m=500, row_nnz=6, band=60, seed=0)
    part = rt.propagate_block_ell(p)
    fused = rt.propagate_block_ell(p, scatter="fused")
    monkeypatch.setenv(tk.AUTO_LARGE_SCATTER_ENV, "segment")
    tk.reset_launch_counts()
    got = rt.propagate_block_ell(p)
    counts = tk.launch_counts()
    assert counts["fused_round_tiles"] == _enqueued(int(got.rounds), gated=False) > 0
    assert counts["batched_slab_round_tiles"] == 0
    for f in ("lb", "ub", "rounds", "converged", "infeasible"):
        _match(getattr(got, f), getattr(fused, f))
    for f in ("rounds", "converged", "infeasible"):
        _match(getattr(got, f), getattr(part, f))
    assert rt.bounds_equal(got.lb, got.ub, part.lb, part.ub)


@pytest.mark.parametrize("tile_width", [128, 8])
def test_legacy_round_on_card_matches_segment_round(cuda, tile_width):
    p = td.make_mixed(m=600, n=450, seed=21)
    prep = tk.prepare_block_ell(p, tile_width=tile_width)
    lb, ub = prep.lb0.clone(), prep.ub0.clone()
    want = tk.round_fn_for(prep, scatter="segment")(lb, ub)
    got = tk.legacy_round_fn_for(prep)(prep.d.lb0.clone(), prep.d.ub0.clone())
    _match(got[0], want[0][: prep.n])
    _match(got[1], want[1][: prep.n])
    assert bool(got[2]) == bool(want[2])


# ---------------------------------------------------------------------------
# The redesigned #10 and #12: held bounds, integer atomics, chunks stopped at
# their length, node-major #10, accumulator planes kept across rounds
# ---------------------------------------------------------------------------


def _active(bsz, n_act, dev):
    act = torch.zeros(bsz, dtype=torch.bool, device=dev)
    if n_act == "all":
        act[:] = True
    elif n_act:
        act[torch.linspace(0, bsz - 1, n_act).long()] = True
    return act


@pytest.mark.parametrize("bsz", [1, 33, 128, 256])
@pytest.mark.parametrize("k", [4, 8, 16, 32, 128])
def test_node_major_round_matches_plain_version(cuda, gen, k, bsz):
    """#10 at every group width and at batch sizes that are and are not
    multiples of 32 (256: the solver's default pool), with 0, 1, 8 and all
    nodes active, one pair of planes kept across the masks and handed back
    by #9 each time: bitwise equal to its plain version, each active node
    to kernel D on its row."""
    x = _tiles(gen, 24, 8, k, 700, False, cuda)
    n_pad = x["n_pad"]
    x["val"][0, 0, k // 2 :] = 0.0  # a chunk that stops short of K
    x["col"][0, 0, k // 2 :] = 0
    lb, ub = _planes(gen, bsz, n_pad, False, cuda)
    clen = tref.chunk_lengths(x["val"])
    acc = tk.accumulator_planes(lb)
    # Strides held per lane: as the longest chunk needs (hoisted), as K
    # needs (omitted), or one (a short hint: later strides gathered again).
    hints = [int(clen.max()), None, 1]
    for j, n_act in enumerate((0, 1, 8, "all")):
        act = _active(bsz, n_act, cuda)
        args = (x["val"], x["col"], x["ii"], x["lhs"], x["rhs"], lb, ub, act, n_pad, 1e-6)
        tk.reset_launch_counts()
        got = tk.node_fused_scatter_round_tiles(*args, acc=acc, chunk_len=clen,
                                                max_chunk_len=hints[j % 3])
        assert tk.launch_counts()["node_fused_scatter_round_tiles"] == 1
        want = tref.node_fused_scatter_round_ref(*args[:7], n_pad, 1e-6, active=act)
        for g, w in zip(got, want):
            _match(g, w)
        for i in act.nonzero().flatten().tolist()[:3]:
            one = tk.fused_scatter_round_tiles(x["val"], x["col"], x["ii"], x["lhs"], x["rhs"],
                                               lb[i], ub[i], n_pad, 1e-6)
            _match(got[0][i], one[0])
            _match(got[1][i], one[1])
        want_m = rt.core.apply_updates_batch(lb, ub, *want, 1e-9, active=act)
        glb, gub = lb.clone(), ub.clone()
        for g, w in zip(tk.apply_updates_batch_tiles(glb, gub, *acc, act, 1e-9), want_m):
            _match(g, w)
        assert _clean(acc)


WIDE_CASES = [
    # pbw-like: pseudo-boolean rows at K = 8; bandw-like: banded rows at K = 128.
    ("make_pseudo_boolean", dict(n=3000, m=4000, seed=7), 8, 1024),
    ("make_banded", dict(n=3000, m=2000, row_nnz=12, band=600, seed=1), 128, 1024),
]


@pytest.mark.parametrize("instances", [1, 2])
@pytest.mark.parametrize("gen_name,kw,tile_width,slab", WIDE_CASES)
def test_slab_scatter_matches_plain_version(cuda, gen, gen_name, kw, tile_width, slab,
                                            instances):
    """#12 on small partitions shaped like the card's ``pbw`` and ``bandw``,
    one and two planes, each instance in turn inactive, the planes kept
    across the masks: bitwise equal to ``ref.batched_slab_round_ref``, the
    window flags too; the chunk lengths given (as the engine does) or
    computed from the copies."""
    problems = [getattr(td, gen_name)(**{**kw, "seed": kw["seed"] + i})
                for i in range(instances)]
    part, n_pad = _packed_partition(problems, tile_width, slab, cuda)
    lb, ub = _planes(gen, instances, n_pad, gen_name == "make_pseudo_boolean", cuda)
    strs = tref.straddle_combine_ref(
        *tref.batched_slab_partials_ref(
            part.a_val, part.a_col_s, part.a_run_start, part.a_run_len, part.a_run_inst,
            part.a_run_slab, torch.ones(instances, dtype=torch.bool, device=cuda), lb, ub,
            slab, part.a_max_run_len),
        part.a_order, part.a_seg, part.agg_slot)
    acc = tk.accumulator_planes(lb)
    masks = [torch.ones(instances, dtype=torch.bool)]
    masks += [torch.arange(instances) != i for i in range(instances)]
    for j, act in enumerate(masks):
        act = act.to(cuda)
        r_args = (part.val, part.col_s, part.ii_g, part.row_done, *strs, part.lhs_g,
                  part.rhs_g, part.run_start, part.run_len, part.run_inst, part.run_slab, act)
        want = tref.batched_slab_round_ref(*r_args, lb, ub, slab, part.max_run_len, 1e-9, 1e-6)
        glb, gub = lb.clone(), ub.clone()
        hoisted = dict(chunk_len=part.chunk_len, max_chunk_len=part.max_chunk_len)
        got = tk.batched_slab_round_tiles(*r_args, glb, gub, slab, part.max_run_len, 1e-9, 1e-6,
                                          acc=acc, tiles=(part.tile_inst, part.tile_slab),
                                          **(hoisted if j % 2 == 0 else {}))
        for g, w in zip(got, want):
            _match(g, w)
        assert _clean(acc)


@pytest.mark.parametrize("max_chunk_len", [None, 1, 40, 128])
def test_slab_scatter_holds_the_strides_it_is_told(cuda, gen, max_chunk_len):
    """#12 on a copy stream whose chunks run to 128 slots (a K = 128
    knapsack: rows far longer than a slab), whatever number of strides a
    lane holds (the hint ``max_chunk_len``: one, two or four strides, or K):
    bitwise equal to its plain version."""
    p = td.make_knapsack(n=900, m=12, seed=4)
    part, n_pad = _packed_partition([p], 128, 256, cuda)
    assert part.max_chunk_len > 64
    lb, ub = _planes(gen, 1, n_pad, True, cuda)
    act = torch.ones(1, dtype=torch.bool, device=cuda)
    strs = tref.straddle_tables(part, *tref.batched_slab_partials_ref(
        part.a_val, part.a_col_s, part.a_run_start, part.a_run_len, part.a_run_inst,
        part.a_run_slab, act, lb, ub, 256, part.a_max_run_len))
    r_args = (part.val, part.col_s, part.ii_g, part.row_done, *strs, part.lhs_g, part.rhs_g,
              part.run_start, part.run_len, part.run_inst, part.run_slab, act)
    want = tref.batched_slab_round_ref(*r_args, lb, ub, 256, part.max_run_len, 1e-9, 1e-6)
    acc = tk.accumulator_planes(lb)
    got = tk.batched_slab_round_tiles(*r_args, lb.clone(), ub.clone(), 256, part.max_run_len,
                                      1e-9, 1e-6, acc=acc, tiles=(part.tile_inst, part.tile_slab),
                                      chunk_len=part.chunk_len, max_chunk_len=max_chunk_len)
    for g, w in zip(got, want):
        _match(g, w)
    assert _clean(acc)


@pytest.mark.parametrize("merge", ["batch", "slab"])
def test_merges_hand_kept_planes_back_on_card(cuda, gen, merge):
    """#9 and #15 set the accumulator entries of the active rows back to the
    sentinels once read and leave the other rows untouched."""
    bsz, width = 37, 1000
    lb, ub = _planes(gen, bsz, width, False, cuda)
    bl, bu = _planes(gen, bsz, width, False, cuda)
    bl, bu = bl - 1.0, bu + 1.0
    act = _active(bsz, 8, cuda)
    old_l, old_u = bl.clone(), bu.clone()
    if merge == "batch":
        want = rt.core.apply_updates_batch(lb, ub, old_l, old_u, 1e-9, active=act)
        got = tk.apply_updates_batch_tiles(lb.clone(), ub.clone(), bl, bu, act, 1e-9)
    else:
        want = tref.apply_updates_slab_ref(lb, ub, old_l, old_u, act, 128, 1e-9)
        want = (*want[:2], want[2].any(dim=1))
        got = tk.apply_updates_slab_tiles(lb.clone(), ub.clone(), bl, bu, act, 128, 1e-9)
    for g, w in zip(got, want):
        _match(g, w)
    assert _clean((bl[act], bu[act]))
    _match(bl[~act], old_l[~act])
    _match(bu[~act], old_u[~act])


def test_search_and_partitioned_batch_keep_planes_on_card(cuda, small_limit):
    """Fixed points whose active mask changes from round to round through
    the kept planes: a ``solve`` through #10 + #9 and a partitioned
    ``propagate_batch`` through #12 + #15, each equal to the plain path;
    the closures' planes are clean after the runs."""
    from repro_torch.kernels import ops

    ops.SCATTER_MAX_NPAD = 1 << 16  # the search's fused node round
    p = td.make_pseudo_boolean(n=300, m=420, seed=3, unit_frac=0.002)  # 10 levels, 71 nodes
    c = np.arange(1, p.n + 1, dtype=np.float64) * np.where(np.arange(p.n) % 3 == 0, -1.0, 1.0)
    tk.reset_launch_counts()
    a = rt.solve(p, c, node_cap=64, expand_width=4, max_levels=10, tile_width=8)
    assert tk.launch_counts()["node_fused_scatter_round_tiles"] > a.levels
    b = rt.solve(p, c, node_cap=64, expand_width=4, max_levels=10, tile_width=8,
                 use_kernels=False)
    for f in ("status", "objective", "nodes_expanded", "nodes_created", "leaves", "levels",
              "host_syncs", "incumbent_trajectory"):
        assert getattr(a, f) == getattr(b, f), f
    for x, y in zip(a.carry, b.carry):
        _match(x, y)

    ops.SCATTER_MAX_NPAD = 128  # the batch's partitioned round
    ops.clear_batch_caches()
    problems = [td.make_pseudo_boolean(n=200, m=260, seed=s) for s in range(3)]
    tk.reset_launch_counts()
    got = rt.core.propagate_batch(problems, tile_width=8)
    assert tk.launch_counts()["batched_slab_round_tiles"] == max(int(r.rounds) for r in got)
    assert len({int(r.rounds) for r in got}) > 1
    plain = rt.core.propagate_batch(problems, tile_width=8, use_kernels=False)
    for g, w, p_ in zip(got, plain, problems):
        for f in ("lb", "ub", "rounds", "converged", "infeasible"):
            _match(getattr(g, f), getattr(w, f))
        one = rt.propagate_block_ell(p_, tile_width=8)
        _match(g.lb, one.lb)
        _match(g.ub, one.ub)
    ops.clear_batch_caches()


# ---------------------------------------------------------------------------
# #8 and #14: the active-only walks, into kept planes
# ---------------------------------------------------------------------------

# Active masks over B planes: none, one, some, all, and one that is not
# contiguous (every third plane, and the last).
WALK_MASKS = ("none", "one", "some", "all", "gaps")


def _walk_mask(bsz, kind, dev):
    act = torch.zeros(bsz, dtype=torch.bool, device=dev)
    if kind == "one":
        act[bsz // 2] = True
    elif kind == "some":
        act[: max(1, bsz // 3)] = True
    elif kind == "all":
        act[:] = True
    elif kind == "gaps":
        act[::3] = True
        act[-1] = True
    return act


@pytest.mark.parametrize("k", [1, 2, 4, 8, 16, 32, 128])
@pytest.mark.parametrize("bsz", [1, 5, 40])
def test_batched_fused_walk_matches_plain_version(cuda, gen, k, bsz):
    """#8 at every group width (K = 1 to 128), over instances of different
    sizes (one without tiles), with none, one, some, all and a
    non-contiguous set of instances active, the strides held as the hoisted
    longest chunk says, as K says and one (U = 1, 2, 4 at K = 128), one
    pair of planes kept across the masks and handed back by #9 each time:
    bitwise equal to its plain version, each active row to kernel D on its
    instance's own tiles."""
    sizes = [int(x) for x in gen.integers(1, 6, size=bsz)]
    if bsz > 1:
        sizes[1] = 0
    r = 4
    xs = [_tiles(gen, s, r, k, 300, bool(i % 2), cuda) for i, s in enumerate(sizes)]
    n_pad = xs[0]["n_pad"]
    for x in xs:
        if x["val"].shape[0]:
            x["val"][0, 0, (k + 1) // 2 :] = 0.0  # a chunk that stops short of K
            x["col"][0, 0, (k + 1) // 2 :] = 0
    cat = lambda f: torch.cat([x[f] for x in xs])
    val, col, ii, lhs, rhs = cat("val"), cat("col"), cat("ii"), cat("lhs"), cat("rhs")
    lb = torch.stack([x["lb"] for x in xs])
    ub = torch.stack([x["ub"] for x in xs])
    tile_inst = torch.repeat_interleave(torch.arange(bsz, dtype=torch.int32, device=cuda),
                                        torch.tensor(sizes, device=cuda))
    clen = tref.chunk_lengths(val)
    chunks = tref.instance_chunks(tile_inst, r, bsz)
    _match(chunks, torch.tensor(np.concatenate([[0], np.cumsum(sizes)]) * r, device=cuda))
    acc = tk.accumulator_planes(lb)
    hints = [int(clen.max()), None, 1, 33, 65]
    for j, kind in enumerate(WALK_MASKS):
        act = _walk_mask(bsz, kind, cuda)
        args = (val, col, ii, lhs, rhs, lb, ub, tile_inst, act, n_pad, 1e-6)
        tk.reset_launch_counts()
        got = tk.batched_fused_scatter_round_tiles(*args, acc=acc, chunk_len=clen,
                                                   max_chunk_len=hints[j], chunks=chunks)
        assert tk.launch_counts()["batched_fused_scatter_round_tiles"] == 1
        want = tref.batched_fused_scatter_round_ref(
            val, tref.global_columns(col, tile_inst, n_pad), ii, lhs, rhs, lb, ub, n_pad, 1e-6,
            active=act)
        for g, w in zip(got, want):
            _match(g, w)
        for i in act.nonzero().flatten().tolist()[:3]:
            x = xs[i]
            if sizes[i] == 0:  # no tiles: its rows stay at the sentinels (held above)
                continue
            one = tk.fused_scatter_round_tiles(x["val"], x["col"], x["ii"], x["lhs"], x["rhs"],
                                               x["lb"], x["ub"], n_pad, 1e-6)
            _match(got[0][i], one[0])
            _match(got[1][i], one[1])
        want_m = rt.core.apply_updates_batch(lb, ub, *want, 1e-9, active=act)
        glb, gub = lb.clone(), ub.clone()
        for g, w in zip(tk.apply_updates_batch_tiles(glb, gub, *acc, act, 1e-9), want_m):
            _match(g, w)
        assert _clean(acc)


def test_batched_fused_computes_what_it_is_not_given(cuda, gen):
    """#8 without the hoisted chunk ranges and lengths computes them from
    ``tile_inst`` and ``val``, and refuses a stream whose instances' tiles
    are not contiguous."""
    sizes = [3, 2, 4]
    xs = [_tiles(gen, s, 4, 8, 200, True, cuda) for s in sizes]
    val, col, ii, lhs, rhs = (torch.cat([x[f] for x in xs])
                              for f in ("val", "col", "ii", "lhs", "rhs"))
    lb = torch.stack([x["lb"] for x in xs])
    ub = torch.stack([x["ub"] for x in xs])
    n_pad = xs[0]["n_pad"]
    tile_inst = torch.tensor([0, 0, 0, 1, 1, 2, 2, 2, 2], dtype=torch.int32, device=cuda)
    act = torch.ones(3, dtype=torch.bool, device=cuda)
    args = (val, col, ii, lhs, rhs, lb, ub, tile_inst, act, n_pad, 1e-6)
    got = tk.batched_fused_scatter_round_tiles(*args, acc=tk.accumulator_planes(lb))
    want = tref.batched_fused_scatter_round_ref(
        val, tref.global_columns(col, tile_inst, n_pad), ii, lhs, rhs, lb, ub, n_pad, 1e-6)
    for g, w in zip(got, want):
        _match(g, w)
    shuffled = tile_inst.flip(0).contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        tk.batched_fused_scatter_round_tiles(val, col, ii, lhs, rhs, lb, ub, shuffled, act,
                                             n_pad, 1e-6, acc=tk.accumulator_planes(lb))


@pytest.mark.parametrize("tile_width", [1, 2, 4, 8, 16, 32, 128])
def test_node_slab_walk_matches_plain_version(cuda, gen, tile_width):
    """#14 at every group width (the copy stream of a knapsack at K = 1 to
    128, its rows straddling every slab), over 40 node planes with none,
    one, some, all and a non-contiguous set of nodes active, the strides
    held as the hoisted longest copy says, as K says and one, two or four,
    one pair of planes kept across the masks and handed back by #15: bitwise
    equal to its plain version, the window flags too, each active node to
    #12 on its own plane."""
    p = td.make_knapsack(n=600, m=10, seed=4)
    prep = rt.prepare_block_ell(p, tile_rows=2, tile_width=tile_width)
    part = prep.slab_partition(128)
    assert part.has_straddle
    bsz, width = 40, prep.n_pad
    lb, ub = _planes(gen, bsz, width, tile_width % 2 == 0, cuda)
    acc = tk.accumulator_planes(lb)
    hints = [part.max_chunk_len, None, 1, 33, 65]
    for j, kind in enumerate(WALK_MASKS):
        act = _walk_mask(bsz, kind, cuda)
        partials = tref.node_slab_partials_ref(
            part.a_val, part.a_col_s, part.a_run_start, part.a_run_len, part.a_run_slab, act,
            lb, ub, part.slab, part.a_max_run_len)
        strs = tref.straddle_combine_ref(*partials, part.a_order, part.a_seg, part.agg_slot,
                                         act)
        r_args = (part.val, part.col_s, part.ii_g, part.row_done, *strs, part.lhs_g,
                  part.rhs_g, part.run_start, part.run_len, part.run_slab, act)
        tail = (part.slab, part.max_run_len, 1e-9, 1e-6)
        want = tref.node_slab_round_ref(*r_args, lb, ub, *tail)
        glb, gub = lb.clone(), ub.clone()
        tk.reset_launch_counts()
        got = tk.node_slab_round_tiles(*r_args, glb, gub, *tail, acc=acc,
                                       tile_slab=part.tile_slab, chunk_len=part.chunk_len,
                                       max_chunk_len=hints[j])
        counts = tk.launch_counts()
        assert counts["node_slab_round_tiles"] == counts["apply_updates_slab_tiles"] == 1
        for g, w in zip(got, want):
            _match(g, w)
        assert _clean(acc)
        for i in act.nonzero().flatten().tolist()[:2]:
            one = tref.batched_slab_round_ref(
                part.val, part.col_s, part.ii_g, part.row_done, *(x[i] for x in strs),
                part.lhs_g, part.rhs_g, part.run_start, part.run_len, part.run_inst,
                part.run_slab, act[i : i + 1], lb[i : i + 1], ub[i : i + 1], *tail)
            _match(got[0][i], one[0][0])
            _match(got[1][i], one[1][0])


def test_fixed_points_leave_kept_planes_clean_on_card(cuda, small_limit):
    """Whole fixed points whose active mask changes from round to round:
    ``propagate_batch`` on a fused bucket (#8 + #9), the service's fused
    bucket (#8 + #9 from the engine's planes) and a ``solve`` past the
    limit (#14 + #15), each equal to its plain path and with the launch
    counts of its rounds; the closures' and the engine's planes are all at
    the sentinels afterwards."""
    from repro_torch.kernels import ops

    ops.SCATTER_MAX_NPAD = 1 << 16
    ops.clear_batch_caches()
    probs = [td.make_pseudo_boolean(n=3000, m=m, seed=s)
             for s, m in enumerate((4000, 2500, 3500))]
    (batch,) = ops.packed_problems(probs, 8, 128)
    prep = ops.prepare_problem_batch(batch)
    assert prep.fits_one_chunk
    _match(prep.d.chunks, tref.instance_chunks(prep.d.tile_inst, 8, 3))
    assert prep.max_chunk_len == int(prep.d.chunk_len.max())
    round_fn = ops.batched_round_fn_for(prep)
    plain_fn = ops.batched_round_fn_for(prep, use_kernels=False)
    lb, ub = prep.d.lb0.clone(), prep.d.ub0.clone()
    plb, pub = lb.clone(), ub.clone()
    act = torch.ones(3, dtype=torch.bool, device=cuda)
    tk.reset_launch_counts()
    rounds = 0
    while bool(act.any()):
        lb, ub, ch = round_fn(lb, ub, act)
        plb, pub, pch = plain_fn(plb, pub, act)
        _match(lb, plb)
        _match(ch, pch)
        assert _clean(round_fn.kept.planes)
        act = act & ch
        rounds += 1
    counts = tk.launch_counts()
    assert counts["batched_fused_scatter_round_tiles"] == counts[
        "apply_updates_batch_tiles"] == rounds > 1

    svc = rt.PropagationService.from_problems(probs, slots=2, tile_width=128)
    results = svc.serve(probs)
    for p, r in zip(probs, results):
        one = rt.propagate_batch([p], tile_width=128)[0]
        _match(r.lb.to(cuda), one.lb)
        _match(r.ub.to(cuda), one.ub)
    engines = {id(bk.engine): bk.engine for bk in svc._buckets}
    assert engines and all(_clean(e.kept.planes) for e in engines.values())

    ops.SCATTER_MAX_NPAD = 128
    ops.clear_prepare_cache()
    p = td.make_pseudo_boolean(n=300, m=420, seed=3, unit_frac=0.002)
    c = np.arange(1, p.n + 1, dtype=np.float64) * np.where(np.arange(p.n) % 3 == 0, -1.0, 1.0)
    tk.reset_launch_counts()
    a = rt.solve(p, c, node_cap=64, expand_width=4, max_levels=6, tile_width=8)
    counts = tk.launch_counts()
    assert counts["node_slab_round_tiles"] > 0 and counts["node_fused_scatter_round_tiles"] == 0
    assert counts["apply_updates_slab_tiles"] == counts["node_slab_round_tiles"]
    b = rt.solve(p, c, node_cap=64, expand_width=4, max_levels=6, tile_width=8,
                 use_kernels=False)
    for f in ("status", "objective", "nodes_expanded", "nodes_created", "leaves", "levels",
              "host_syncs", "incumbent_trajectory"):
        assert getattr(a, f) == getattr(b, f), f
    ops.clear_prepare_cache()
    ops.clear_batch_caches()


# ---------------------------------------------------------------------------
# D on chunk_round with packed lane groups, into kept planes; #9 on the walk
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("longest", [1, 8, 9, 16, 17, 32, 33])
def test_fused_packed_groups_match_plain_version(cuda, gen, longest):
    """Kernel D at K = 128 where the longest chunk holds 1 to 33 slots: lane
    groups of 1, 8 and 16 lanes packed several to a warp, a warp with one
    stride, a warp with two; the lengths hoisted and computed by the
    wrapper, the group keyed on K instead (no packing), fresh and kept
    planes, integer and general-float data: bitwise equal to its plain
    version; F then hands the kept planes back at the sentinels."""
    k = 128
    for exact in (True, False):
        x = _tiles(gen, 40, 8, k, 3000, exact, cuda)
        # Every chunk stops by `longest` (some are empty); one is that long.
        stop = torch.from_numpy(gen.integers(0, longest + 1, size=(40, 8))).to(cuda)
        pad = torch.arange(k, device=cuda)[None, None, :] >= stop[..., None]
        x["val"][pad] = 0.0
        x["col"][pad] = 0
        x["ii"][pad] = 0
        x["val"][0, 0, longest - 1] = 3.0
        clen = tref.chunk_lengths(x["val"])
        assert int(clen.max()) == longest
        args = (x["val"], x["col"], x["ii"], x["lhs"], x["rhs"], x["lb"], x["ub"], x["n_pad"],
                1e-6)
        want = tref.fused_scatter_round_tiles_ref(*args)
        tk.reset_launch_counts()
        for g, w in zip(tk.fused_scatter_round_tiles(*args), want):
            _match(g, w)
        for hint in (longest, k):
            for g, w in zip(tk.fused_scatter_round_tiles(*args, chunk_len=clen,
                                                         max_chunk_len=hint), want):
                _match(g, w)
        acc = tk.accumulator_planes(x["lb"])
        got = tk.fused_scatter_round_tiles(*args, acc=acc, chunk_len=clen,
                                           max_chunk_len=longest)
        assert got[0] is acc[0] and got[1] is acc[1]
        for g, w in zip(got, want):
            _match(g, w)
        assert tk.launch_counts()["fused_scatter_round_tiles"] == 4
        want_f = rt.core.apply_updates(x["lb"], x["ub"], *want, 1e-9)
        for g, w in zip(tk.apply_updates_tiles(x["lb"].clone(), x["ub"].clone(), *acc, 1e-9),
                        want_f):
            _match(g, w)
        assert _clean(acc)
        # The planes handed back serve the next launch as fresh ones.
        for g, w in zip(tk.fused_scatter_round_tiles(*args, acc=acc, chunk_len=clen,
                                                     max_chunk_len=longest), want):
            _match(g, w)


def test_fused_and_candidates_into_kept_planes_reject_bad_planes(cuda, gen):
    x = _tiles(gen, 2, 2, 8, 10, True, cuda)
    args = (x["val"], x["col"], x["ii"], x["lhs"], x["rhs"], x["lb"], x["ub"], x["n_pad"], 1e-6)
    acc = tk.accumulator_planes(x["lb"][:-1])
    with pytest.raises(ValueError, match="acc"):
        tk.fused_scatter_round_tiles(*args, acc=acc)
    aggs = tk.activities_gather_tiles(x["val"], x["col"], x["lb"], x["ub"], x["n_pad"])
    e_args = (x["val"], x["col"], x["ii"], *aggs, x["lhs"], x["rhs"], x["lb"], x["ub"],
              x["n_pad"], 1e-6)
    with pytest.raises(TypeError, match="acc"):
        tk.candidates_scatter_tiles(*e_args, acc=(acc[0].float(), acc[1]))


def _holey_mask(bsz, n_act, dev):
    """``n_act`` of ``bsz`` rows active, spread evenly over the 32-row
    ballot words with holes between them, the first and last row of each
    word left out while the count allows (all rows at ``n_act == bsz``)."""
    act = np.zeros(bsz, dtype=bool)
    inner = np.array([i for i in range(bsz) if i % 32 not in (0, 31)])
    if n_act > len(inner):
        act[:n_act] = True
    elif n_act:
        act[inner[np.linspace(0, len(inner) - 1, n_act).round().astype(int)]] = True
    assert int(act.sum()) == n_act
    return torch.from_numpy(act).to(dev)


@pytest.mark.parametrize("n_act", [0, 1, 8, 33, 128])
def test_batched_merge_walk_matches_plain_version(cuda, gen, n_act):
    """#9 on its active-only walk over a (128, 1,000) pool (the last column
    block partial) with 0, 1, 8, 33 and 128 rows active, masks with holes in
    every ballot word: bitwise equal to its plain version, flags exact, the
    active rows of the planes handed back at the sentinels and every other
    row neither read nor written."""
    bsz, width = 128, 1000
    act = _holey_mask(bsz, n_act, cuda)
    for exact in (True, False):
        lb, ub = _planes(gen, bsz, width, exact, cuda)
        bl, bu = _planes(gen, bsz, width, exact, cuda)
        bl, bu = bl - 1.0, bu + 1.0
        bl[:, ::7] = -INF
        bu[:, ::5] = INF
        want = rt.core.apply_updates_batch(lb, ub, bl, bu, 1e-9, active=act)
        planes = (bl.clone(), bu.clone())
        tk.reset_launch_counts()
        got = tk.apply_updates_batch_tiles(lb.clone(), ub.clone(), *planes, act, 1e-9)
        assert tk.launch_counts()["apply_updates_batch_tiles"] == 1
        for g, w in zip(got, want):
            _match(g, w)
        assert _clean((planes[0][act], planes[1][act]))
        _match(planes[0][~act], bl[~act])
        _match(planes[1][~act], bu[~act])
        if n_act:
            assert bool(got[2].any())


POOL_ACTIVE = (0, 1, 8, 31, 32, 33, 45)


def _straddle_stream(gen, k, longest, tiles, r, slab, n_slabs, dev):
    """A straddle sub-stream of ``(tiles, r, k)`` copies whose lengths run
    over every value from 0 to ``longest`` (each copy's last slot a nonzero,
    zeros inside, general floats), slab-local columns, ``n_slabs``
    contiguous runs in window order, and the tile slabs, copy lengths and
    longest copy hoisted as the partition hoists them."""
    n = tiles * r
    lengths = np.arange(n) % (longest + 1)
    gen.shuffle(lengths)
    val = np.zeros((n, k))
    col = np.zeros((n, k), np.int32)
    for i, n_i in enumerate(lengths):
        if n_i:
            v = gen.choice([-2.0, -1.0, 0.0, 0.5, 3.0], size=n_i) * 10.0 ** gen.integers(-3, 4, n_i)
            v[-1] = gen.choice([-1.5, 2.5])
            val[i, :n_i] = v
            col[i, :n_i] = gen.integers(0, slab, size=n_i)
    col[val == 0] = 0
    cuts = np.sort(gen.choice(np.arange(1, tiles), size=n_slabs - 1, replace=False))
    run_start = np.concatenate([[0], cuts]).astype(np.int32)
    run_len = np.diff(np.append(run_start, tiles)).astype(np.int32)
    run_slab = np.arange(n_slabs, dtype=np.int32)
    c = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    v = c(val.reshape(tiles, r, k))
    return dict(val=v, col=c(col.reshape(tiles, r, k)), run_start=c(run_start),
                run_len=c(run_len), run_slab=c(run_slab),
                hoisted=dict(tile_slab=c(np.repeat(run_slab, run_len)),
                             chunk_len=tref.chunk_lengths(v), max_chunk_len=int(lengths.max())))


@pytest.mark.parametrize("k,longest", [(8, 8), (128, 8), (128, 16), (128, 33), (128, 128)])
def test_node_slab_partials_over_a_pool_match_plain_version(cuda, gen, k, longest):
    """#13 over a pool of 45 node planes (no multiple of 32) with 0, 1, 8,
    31, 32, 33 and all 45 active, holes in every ballot word (the walk's
    items skip them), on copies of every length from 0 to the longest --
    the lane group keyed on it (8, 16 or 32 lanes, one, two or four strides
    held) -- with the hoisted tile slabs and lengths given and derived:
    bitwise equal to its plain version on the active planes, on integer and
    general-float bounds."""
    bsz, slab, n_slabs = 45, 128, 3
    s = _straddle_stream(gen, k, longest, 40, 4, slab, n_slabs, cuda)
    for exact in (True, False):
        lb, ub = _planes(gen, bsz, slab * n_slabs, exact, cuda)
        for n_act in POOL_ACTIVE:
            act = _holey_mask(bsz, n_act, cuda)
            args = (s["val"], s["col"], s["run_start"], s["run_len"], s["run_slab"], act, lb, ub,
                    slab, int(s["run_len"].max()))
            want = tref.node_slab_partials_ref(*args)
            for kw in (s["hoisted"], {}):
                tk.reset_launch_counts()
                got = tk.node_slab_partials_tiles(*args, **kw)
                assert tk.launch_counts()["node_slab_partials_tiles"] == 1
                for g, w in zip(got, want):
                    _match(g[act], w[act])


@pytest.mark.parametrize("bsz,width,slab", [(1, 2500, 128), (1, 150_016, 50_048),
                                            (45, 2500, 256), (45, 1000, 128)])
def test_window_merge_walk_matches_plain_version(cuda, gen, bsz, width, slab):
    """#15 on the merge walk it shares with #9: one plane, and a 45-row pool
    with 0, 1, 8, 31, 32, 33 and all rows active (holes in every ballot
    word), at widths that are no multiple of 1,024 columns (a partial column
    block): the bounds and every window flag bitwise equal to its plain
    version, through the launch and through the wrapper (flags OR-ed per
    row); the active rows of the planes handed back at the sentinels, the
    others neither read nor written."""
    from repro_torch.kernels import prop_round as tpr

    for exact in (True, False):
        lb, ub = _planes(gen, bsz, width, exact, cuda)
        bl, bu = _planes(gen, bsz, width, exact, cuda)
        bl, bu = bl - 1.0, bu + 1.0
        bl[:, ::7] = -INF
        bu[:, ::5] = INF
        for n_act in (0, 1) if bsz == 1 else POOL_ACTIVE:
            act = _holey_mask(bsz, n_act, cuda)
            want = tref.apply_updates_slab_ref(lb, ub, bl, bu, act, slab, 1e-9)
            glb, gub, gbl, gbu = lb.clone(), ub.clone(), bl.clone(), bu.clone()
            tk.reset_launch_counts()
            flags = tpr._slab_merge(glb, gub, gbl, gbu, act, slab, 1e-9, INF, 0.0)
            assert tk.launch_counts()["apply_updates_slab_tiles"] == 1
            for g, w in zip((glb, gub, flags), want):
                _match(g, w)
            assert _clean((gbl[act], gbu[act]))
            _match(gbl[~act], bl[~act])
            _match(gbu[~act], bu[~act])
            got = tk.apply_updates_slab_tiles(lb.clone(), ub.clone(), bl.clone(), bu.clone(), act,
                                              slab, 1e-9)
            _match(got[2], want[2].any(dim=1))
            if n_act:
                assert bool(want[2].any())


@pytest.mark.parametrize("bsz", [1, 2, 16, 17])
def test_merges_on_the_grid_and_the_walk_match_plain_version(cuda, gen, bsz):
    """#9 and #15 at row counts around their launch's choice -- a (column
    block, row) grid for at most 16 rows (``kMergeGridRows``), the
    active-only walk beyond -- with none, one, half and all rows active
    (holes where the count allows), at a width that is no multiple of
    1,024 columns: bounds and flags bitwise equal to their plain versions,
    the active rows of the planes handed back at the sentinels and every
    other row neither read nor written."""
    from repro_torch.kernels import prop_round as tpr

    width, slab = 2500, 128
    for exact in (True, False):
        lb, ub = _planes(gen, bsz, width, exact, cuda)
        bl, bu = _planes(gen, bsz, width, exact, cuda)
        bl, bu = bl - 1.0, bu + 1.0
        bl[:, ::7] = -INF
        bu[:, ::5] = INF
        for n_act in sorted({0, 1, bsz // 2, bsz}):
            act = _holey_mask(bsz, n_act, cuda)
            for merge in ("#9", "#15"):
                glb, gub, gbl, gbu = lb.clone(), ub.clone(), bl.clone(), bu.clone()
                if merge == "#9":
                    want = rt.core.apply_updates_batch(lb, ub, bl, bu, 1e-9, active=act)
                    got = tk.apply_updates_batch_tiles(glb, gub, gbl, gbu, act, 1e-9)
                else:
                    want = tref.apply_updates_slab_ref(lb, ub, bl, bu, act, slab, 1e-9)
                    got = (glb, gub, tpr._slab_merge(glb, gub, gbl, gbu, act, slab, 1e-9, INF,
                                                     0.0))
                for g, w in zip(got, want):
                    _match(g, w)
                assert _clean((gbl[act], gbu[act]))
                _match(gbl[~act], bl[~act])
                _match(gbu[~act], bu[~act])


def test_window_merge_rejects_slabs_of_partial_warps(cuda, gen):
    """#15 flags a window once per warp, so its slab must be a multiple of
    32: the wrapper raises on any other before it launches."""
    lb, ub = _planes(gen, 2, 300, True, cuda)
    act = torch.ones(2, dtype=torch.bool, device=cuda)
    tk.reset_launch_counts()
    for slab in (100, 48):
        with pytest.raises(ValueError, match="multiples of 32"):
            tk.apply_updates_slab_tiles(lb, ub, lb - 1.0, ub + 1.0, act, slab, 1e-9)
    assert tk.launch_counts()["apply_updates_slab_tiles"] == 0


# ---------------------------------------------------------------------------
# The loop carry (kernel F, #15 for one instance) and the kept flag pairs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("unroll", [1, 3])
def test_merge_keeps_the_carry_on_card(cuda, gen, unroll):
    """F against its plain version over the rounds of one fixed point:
    bounds, handed-back planes, the returned GO and the carry bitwise,
    through convergence and rounds enqueued after it."""
    from repro_torch.core import carry as tcarry

    n = 60_032
    lb = torch.zeros(n, dtype=torch.float64, device=cuda)
    ub = torch.full((n,), 10.0, dtype=torch.float64, device=cuda)
    st_k, st_p = tcarry.armed_state(cuda), tcarry.armed_state(cuda)
    plan = [True] * (2 * unroll) + [False] * unroll + [True] * 2
    for i, tighten in enumerate(plan):
        bl = torch.full((n,), -INF, dtype=torch.float64, device=cuda)
        bu = torch.full((n,), INF, dtype=torch.float64, device=cuda)
        if tighten:
            pick = torch.from_numpy(gen.random(n) < 0.3).to(cuda)
            bl[pick] = lb[pick] + 1.0
        want = tref.merge_carry_ref(lb, ub, bl.clone(), bu.clone(), 1e-9, INF, 0.0, st_p,
                                    i % unroll, unroll)
        acc = (bl.clone(), bu.clone())
        got = tk.apply_updates_tiles(lb.clone(), ub.clone(), *acc, 1e-9, INF, 0.0, carry=st_k,
                                     k=i % unroll, unroll=unroll)
        for g, w in zip((*got, st_k), (*want, st_p)):
            _match(g, w)
        assert _clean(acc)
        lb, ub = want[0], want[1]
    assert st_k.tolist()[tcarry.ROUNDS] == 3 * unroll


@pytest.mark.parametrize("engine,gen_name,kw,tile_width,scatter", [
    ("fused", "make_pseudo_boolean", dict(n=3000, m=4000, seed=7), 128, "auto"),
    ("multi-chunk", "make_mixed", dict(m=600, n=450, seed=21), 16, "auto"),
    ("partitioned", "make_pseudo_boolean", dict(n=3000, m=4000, seed=7), 8, "partitioned"),
    ("segment", "make_mixed", dict(m=600, n=450, seed=21), 16, "segment"),
])
def test_device_loop_on_card_equals_host_loop(cuda, monkeypatch, engine, gen_name, kw,
                                              tile_width, scatter):
    monkeypatch.setattr(rt.core.propagator, "DEVICE_LOOP_GROUP", 3)
    monkeypatch.setattr(rt.core.propagator, "UNGATED_LOOP_GROUP", 3)
    p = getattr(td, gen_name)(**kw)
    args = dict(tile_width=tile_width, scatter=scatter, slab=128)
    syncs = {"host_loop": [], "device_loop": []}
    out = {d: rt.propagate_block_ell(p, driver=d, on_sync=lambda d=d: syncs[d].append(1),
                                     **args) for d in syncs}
    for f in ("lb", "ub", "rounds", "converged", "infeasible", "progress"):
        _match(getattr(out["device_loop"], f), getattr(out["host_loop"], f))
    rounds = int(out["host_loop"].rounds)
    assert len(syncs["host_loop"]) == rounds and len(syncs["device_loop"]) == -(-rounds // 3)


@pytest.mark.parametrize("engine,gen_name,kw,tile_width,scatter", [
    ("fused", "make_pseudo_boolean", dict(n=3000, m=4000, seed=7), 128, "fused"),
    ("multi-chunk", "make_mixed", dict(m=600, n=450, seed=21), 16, "fused"),
    ("partitioned", "make_pseudo_boolean", dict(n=3000, m=4000, seed=7), 8, "partitioned"),
    ("segment-C", "make_pseudo_boolean", dict(n=3000, m=4000, seed=7), 128, "segment"),
    ("segment-AB", "make_mixed", dict(m=600, n=450, seed=21), 16, "segment"),
])
def test_gated_rounds_on_card_equal_plain_rounds(cuda, engine, gen_name, kw, tile_width,
                                                 scatter):
    """The round closure on the kernels against the one on the plain
    versions, carries armed for groups of 3, through convergence and 12
    rounds enqueued after it, where every kernel returns at once on the
    carry's clear GO: bounds and carry bitwise after every round."""
    from repro_torch.core import carry as tcarry
    from repro_torch.kernels import ops as tops

    p = getattr(td, gen_name)(**kw)
    prep = rt.prepare_block_ell(p, tile_width=tile_width)
    fk = tops.round_fn_for(prep, scatter=scatter, slab=128)
    fp = tops.round_fn_for(prep, use_kernels=False, scatter=scatter, slab=128)
    assert fk.gated == (scatter != "segment") and not fp.gated
    lbk, ubk = prep.lb0.clone(), prep.ub0.clone()
    lbp, ubp = prep.lb0.clone(), prep.ub0.clone()
    fk.carry.arm(cuda, 3)
    fp.carry.arm(cuda, 3)
    try:
        go = []
        for _ in range(int(rt.propagate_block_ell(p, tile_width=tile_width, scatter=scatter,
                                                  slab=128).rounds) + 12):
            lbk, ubk, _ = fk(lbk, ubk)
            lbp, ubp, _ = fp(lbp, ubp)
            for g, w in ((lbk, lbp), (ubk, ubp), (fk.carry.state, fp.carry.state)):
                _match(g, w)
            go.append(fk.carry.state.tolist()[tcarry.GO])
    finally:
        fk.carry.release()
        fp.carry.release()
    # GO clears, for good, at the end of the first check group of 3 in which
    # no round changed a bound: at most four rounds after the host loop's
    # last round (the one that changed nothing).
    assert go == sorted(go, reverse=True) and go.count(0) >= 8


def test_kept_flag_pairs_on_card(cuda, gen):
    """#9 and #15 through kept flag pairs: the flags of fresh ones, the
    other buffer zeroed by each launch."""
    bsz, width = 20, 1000
    active = torch.from_numpy(gen.random(bsz) < 0.5).to(cuda)
    pairs = {"batch": tk.FlagPair((bsz,), torch.bool, cuda),
             "slab": tk.FlagPair((bsz, 8), torch.int32, cuda)}
    for _ in range(3):
        lb = torch.from_numpy(gen.uniform(-5, 0, (bsz, width))).to(cuda)
        ub = torch.from_numpy(gen.uniform(0, 5, (bsz, width))).to(cuda)
        bl = torch.from_numpy(gen.uniform(-6, 2, (bsz, width))).to(cuda)
        bu = torch.full((bsz, width), INF, dtype=torch.float64, device=cuda)
        for name, pair in pairs.items():
            fn = (tk.apply_updates_batch_tiles if name == "batch" else
                  lambda *a, **k: tk.apply_updates_slab_tiles(*a[:5], 128, *a[5:], **k))
            want = fn(lb.clone(), ub.clone(), bl.clone(), bu.clone(), active, 1e-9)
            got = fn(lb.clone(), ub.clone(), bl.clone(), bu.clone(), active, 1e-9, flags=pair)
            for g, w in zip(got, want):
                _match(g, w)
            assert not bool(pair.bufs[pair.turn].any())  # the next launch's, zeroed


# ---------------------------------------------------------------------------
# The precision tiers: the float32 forms of D, A', the combine, E and F
# (int32 and compact int16 / int8 index streams) and F with the early stop
# ---------------------------------------------------------------------------


def _tier_tiles(x, compact):
    """Tiles of :func:`_tiles` / :func:`_packed_tiles` at float32, with the
    compact index streams (int16 columns, int8 marks) or int32 ones."""
    f = lambda t: t.to(torch.float32)
    y = dict(x, val=f(x["val"]), lb=f(x["lb"]), ub=f(x["ub"]), lhs=f(x["lhs"]),
             rhs=f(x["rhs"]))
    if compact:
        y.update(col=x["col"].to(torch.int16), ii=x["ii"].to(torch.int8))
    return y


@pytest.mark.parametrize("compact", [True, False], ids=["f32c", "f32"])
@pytest.mark.parametrize("exact", [True, False], ids=["int", "float"])
@pytest.mark.parametrize("t,r,k,n", LENGTH_SHAPES)
def test_float32_kernels_match_plain_versions(cuda, gen, t, r, k, n, exact, compact):
    """D, A', E and F (with the tier's outward widening) at float32 on both
    index forms, bitwise equal to their plain versions, each launching its
    float form; front-packed tiles with their lengths, and tiles with zeros
    anywhere."""
    cfg = rt.core.DEFAULT_CONFIG
    eps, outward = cfg.eps_for(torch.float32), cfg.outward_for(torch.float32)
    form = "f32c" if compact else "f32"
    packed = _tier_tiles(_packed_tiles(gen, t, r, k, n, exact, cuda), compact)
    for x, clen in ((packed, packed["clen"]), (_tier_tiles(_tiles(gen, t, r, k, n, exact, cuda),
                                                           compact), None)):
        tk.reset_launch_counts()
        d_args = (x["val"], x["col"], x["ii"], x["lhs"], x["rhs"], x["lb"], x["ub"], x["n_pad"],
                  1e-6)
        best = tref.fused_scatter_round_tiles_ref(*d_args)
        for g, w in zip(tk.fused_scatter_round_tiles(*d_args, chunk_len=clen), best):
            _match(g, w)
        a_args = (x["val"], x["col"], x["lb"], x["ub"], x["n_pad"])
        aggs = tk.activities_gather_tiles(*a_args, chunk_len=clen)
        for g, w in zip(aggs, tref.activities_gather_tiles_ref(*a_args)):
            _match(g, w)
        e_args = (x["val"], x["col"], x["ii"], *aggs, x["lhs"], x["rhs"], x["lb"], x["ub"],
                  x["n_pad"], 1e-6)
        for g, w in zip(tk.candidates_scatter_tiles(*e_args, chunk_len=clen),
                        tref.candidates_scatter_tiles_ref(*e_args)):
            _match(g, w)
        want = rt.core.apply_updates(x["lb"], x["ub"], *best, eps, INF, outward)
        got = tk.apply_updates_tiles(x["lb"].clone(), x["ub"].clone(), best[0].clone(),
                                     best[1].clone(), eps, INF, outward)
        for g, w in zip(got, want):
            _match(g, w)
        assert tk.form_counts() == {
            f"fused_scatter_round_tiles[{form}]": 1, f"activities_gather_tiles[{form}]": 1,
            f"candidates_scatter_tiles[{form}]": 1, "apply_updates_tiles[f32]": 1}


@pytest.mark.parametrize("lengths", [[3, 1, 5, 2], [40, 1, 300, 7], COMBINE_LENGTHS])
def test_float32_combine_matches_plain_version(cuda, gen, lengths):
    counts = np.array(lengths)
    m = len(counts)
    n_chunks = int(counts.sum()) + 3
    crow = np.concatenate([np.repeat(np.arange(m), counts), [m] * 3]).astype(np.int32)
    row_start = np.concatenate([[0], np.cumsum(counts), [n_chunks]]).astype(np.int64)
    to = lambda a: torch.from_numpy(np.array(a)).to(cuda).reshape(-1, 1)
    mf, mc, xf, xc = _combine_partials(gen, n_chunks, "float")
    parts = (mf.astype(np.float32), mc, xf.astype(np.float32), xc)
    args = (*map(to, parts), to(crow), to(row_start).reshape(-1))
    tk.reset_launch_counts()
    got = tk.combine_chunk_partials_tiles(*args)
    for g, w in zip(got, tref.combine_chunk_partials_ref(*args)):
        _match(g, w)
    assert tk.form_counts() == {"combine_chunk_partials_tiles[f32]": 1}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", [5, 1_000, 60_032])
def test_f_early_stop_matches_plain_version(cuda, gen, n, dtype):
    """F with the early stop armed over a fixed point's rounds against its
    plain version: bounds, handed-back planes and the carry (the measure's
    bits, the low-progress streak, the last group's flag) bitwise; two
    rounds of large progress, two of low (three columns tightened by 1e-3,
    a measure under 0.05), which stop the loop at patience 2 though they
    changed bounds, and two rounds enqueued after the stop."""
    from repro_torch.core import carry as tcarry

    cfg = rt.core.DEFAULT_CONFIG
    eps, outward = cfg.eps_for(dtype), cfg.outward_for(dtype)
    stop = tcarry.EarlyStop(0.05, 2)
    lb = torch.zeros(n, dtype=dtype, device=cuda)
    ub = torch.full((n,), 10.0, dtype=dtype, device=cuda)
    st_k, st_p = tcarry.armed_state(cuda), tcarry.armed_state(cuda)
    partials = torch.empty(-(-n // tref.MERGE_BLOCK), dtype=dtype, device=cuda)
    tk.reset_launch_counts()
    for i, big in enumerate((True, True, False, False, True, True)):
        if big:  # a third of the columns, other ones each round
            pick = torch.arange(n, device=cuda) % 3 == i % 3
            step_l, step_u = 0.5, 0.25
        else:
            pick = torch.zeros(n, dtype=torch.bool, device=cuda)
            pick[torch.from_numpy(gen.choice(n, min(3, n), replace=False)).to(cuda)] = True
            step_l, step_u = 1e-3, 1e-3
        bl = torch.where(pick, lb + step_l, torch.full_like(lb, -INF))
        bu = torch.where(pick, ub - step_u, torch.full_like(ub, INF))
        acc = (bl.clone(), bu.clone())
        got = tk.apply_updates_tiles(lb.clone(), ub.clone(), *acc, eps, INF, outward, carry=st_k,
                                     stop=stop, partials=partials)
        want = tref.merge_carry_ref(lb, ub, bl.clone(), bu.clone(), eps, INF, outward, st_p, 0, 1,
                                    stop)
        for g, w in zip((*got[:2], st_k), (*want[:2], st_p)):
            _match_bits(g, w)
        assert _clean(acc)
        lb, ub = want[0], want[1]
    fields = st_k.tolist()
    assert fields[tcarry.GO] == 0 and fields[tcarry.LAST] == 1
    assert fields[tcarry.FLAT] == 2 and fields[tcarry.ROUNDS] == 4
    form = "f64+stop" if dtype == torch.float64 else "f32+stop"
    assert tk.form_counts() == {f"apply_updates_tiles[{form}]": 6}


@pytest.mark.parametrize("gen_name,kw,tile_width,exact", [
    ("make_pseudo_boolean", dict(n=3000, m=4000, seed=7), 128, True),
    ("make_cascade_chain", dict(length=40), 4, True),
    ("make_mixed", dict(m=600, n=450, seed=21), 16, False),
    ("make_mixed", dict(m=6000, n=40_000, seed=3, density=0.002), 128, False),
])
def test_tiers_on_card_match_cpu(cuda, gen_name, kw, tile_width, exact):
    """float32-only, two-tier and early-stopped fixed points on the card
    against the same runs on the CPU (the plain versions, in the kernels'
    order): rounds, flags, tier rounds and bounds (bitwise on exact data),
    both drivers; the compact streams below n_pad 2**15 and int32 above."""
    p = getattr(td, gen_name)(**kw)
    runs = [dict(dtype=torch.float32), dict(policy=rt.core.TierPolicy()),
            dict(policy=rt.core.TierPolicy(two_tier=False, stop_progress=0.05, patience=1)),
            dict(dtype=torch.float32, stop_progress=0.01, patience=2)]
    for run in runs:
        for driver in ("host_loop", "device_loop"):
            got = rt.propagate_block_ell(p, tile_width=tile_width, driver=driver, **run)
            want = rt.propagate_block_ell(p, tile_width=tile_width, driver=driver,
                                          device="cpu", **run)
            for f in ("rounds", "converged", "infeasible", "tier_rounds"):
                assert getattr(got, f).item() == getattr(want, f).item(), (run, driver, f)
            assert got.lb.dtype == want.lb.dtype
            if exact:
                _match(got.lb, want.lb)
                _match(got.ub, want.ub)
            else:
                assert rt.bounds_equal(got.lb, got.ub, want.lb, want.ub)


# ---------------------------------------------------------------------------
# The precision tiers on the batched engines: the float32 forms of #8, #9,
# #10 and the node-batched A', combine and E, and #9 with the early stop
# ---------------------------------------------------------------------------


def _tier_planes(lb, ub):
    return lb.to(torch.float32), ub.to(torch.float32)


@pytest.mark.parametrize("compact", [True, False], ids=["f32c", "f32"])
@pytest.mark.parametrize("exact", [True, False], ids=["int", "float"])
@pytest.mark.parametrize("t,r,k,n", LENGTH_SHAPES)
def test_float32_node_kernels_match_plain_versions(cuda, gen, t, r, k, n, exact, compact):
    """#10, the node-batched A', combine and E and #9 (with the tier's
    widening) at float32 on both index forms, over five nodes with every,
    some and no node active: bitwise equal to their plain versions (the
    partials of inactive nodes unwritten), each launching its float form."""
    cfg = rt.core.DEFAULT_CONFIG
    eps, outward = cfg.eps_for(torch.float32), cfg.outward_for(torch.float32)
    form = "f32c" if compact else "f32"
    x = _tier_tiles(_packed_tiles(gen, t, r, k, n, exact, cuda), compact)
    lb, ub = _tier_planes(*_planes(gen, 5, x["n_pad"], exact, cuda))
    m = t * r // 3 + 1
    cuts = np.sort(gen.choice(np.arange(1, t * r), size=m - 1, replace=False))
    crow = np.zeros(t * r, np.int32)
    crow[cuts] = 1
    crow_t = torch.from_numpy(np.cumsum(crow).astype(np.int32).reshape(t, r)).to(cuda)
    row_start = tref.row_starts(crow_t, int(crow_t.max()) + 1)
    for act in (torch.ones(5, dtype=torch.bool), torch.arange(5) % 2 == 0,
                torch.zeros(5, dtype=torch.bool)):
        act = act.to(cuda)
        tk.reset_launch_counts()
        args = (x["val"], x["col"], x["ii"], x["lhs"], x["rhs"], lb, ub, act, x["n_pad"], 1e-6)
        acc = tk.accumulator_planes(lb)
        got = tk.node_fused_scatter_round_tiles(*args, acc=acc, chunk_len=x["clen"])
        want = tref.node_fused_scatter_round_ref(*args[:7], x["n_pad"], 1e-6, active=act)
        for g, w in zip(got, want):
            _match(g, w)
        want_m = rt.core.apply_updates_batch(lb, ub, *want, eps, INF, outward, active=act)
        got_m = tk.apply_updates_batch_tiles(lb.clone(), ub.clone(), *acc, act, eps, INF,
                                             outward)
        for g, w in zip(got_m, want_m):
            _match(g, w)
        assert _clean(acc)
        a_args = (x["val"], x["col"], lb, ub, act, x["n_pad"])
        parts = tk.node_activities_gather_tiles(*a_args, chunk_len=x["clen"])
        want_p = tref.node_activities_gather_ref(*a_args)
        for g, w in zip(parts, want_p):
            _match(g[act], w[act])
        c_args = (*want_p, crow_t, row_start, act)
        aggs = tk.node_combine_chunk_partials_tiles(*c_args)
        want_a = tref.node_combine_chunk_partials_ref(*c_args)
        for g, w in zip(aggs, want_a):
            _match(g[act], w[act])
        e_args = (x["val"], x["col"], x["ii"], *want_a, x["lhs"], x["rhs"], lb, ub, act,
                  x["n_pad"], 1e-6)
        for g, w in zip(tk.node_candidates_scatter_tiles(*e_args, chunk_len=x["clen"]),
                        tref.node_candidates_scatter_ref(*e_args)):
            _match(g, w)
        assert tk.form_counts() == {
            f"node_fused_scatter_round_tiles[{form}]": 1, "apply_updates_batch_tiles[f32]": 1,
            f"node_activities_gather_tiles[{form}]": 1,
            "node_combine_chunk_partials_tiles[f32]": 1,
            f"node_candidates_scatter_tiles[{form}]": 1}


@pytest.mark.parametrize("exact", [True, False], ids=["int", "float"])
@pytest.mark.parametrize("mask", ["on", "mixed", "off"])
@pytest.mark.parametrize("sizes,r,k,n", [((2, 3, 1), 4, 8, 20), ((1, 4, 2), 8, 128, 300),
                                         ((40, 7, 90), 8, 4, 5000)])
def test_float32_batched_fused_kernel_matches_plain_version(cuda, gen, sizes, r, k, n, mask,
                                                            exact):
    """#8 at float32 (int32 ids) into kept planes, then #9 at float32,
    bitwise equal to their plain versions; each active row also equal to
    D's float32 form on that instance."""
    cfg = rt.core.DEFAULT_CONFIG
    eps, outward = cfg.eps_for(torch.float32), cfg.outward_for(torch.float32)
    bsz = len(sizes)
    xs = [_tier_tiles(_tiles(gen, s, r, k, n, exact, cuda), False) for s in sizes]
    cat = lambda f: torch.cat([x[f] for x in xs])
    val, col, ii, lhs, rhs = cat("val"), cat("col"), cat("ii"), cat("lhs"), cat("rhs")
    lb = torch.stack([x["lb"] for x in xs])
    ub = torch.stack([x["ub"] for x in xs])
    n_pad = xs[0]["n_pad"]
    tile_inst = torch.repeat_interleave(torch.arange(bsz, dtype=torch.int32, device=cuda),
                                        torch.tensor(sizes, device=cuda))
    active = torch.tensor({"on": [True] * 3, "mixed": [True, False, True],
                           "off": [False] * 3}[mask], device=cuda)
    tk.reset_launch_counts()
    acc = tk.accumulator_planes(lb)
    got = tk.batched_fused_scatter_round_tiles(val, col, ii, lhs, rhs, lb, ub, tile_inst,
                                               active, n_pad, 1e-6, acc=acc)
    want = tref.batched_fused_scatter_round_ref(
        val, tref.global_columns(col, tile_inst, n_pad), ii, lhs, rhs, lb, ub, n_pad, 1e-6,
        active=active)
    for g, w in zip(got, want):
        _match(g, w)
    for i, x in enumerate(xs):
        if active[i]:
            one = tk.fused_scatter_round_tiles(x["val"], x["col"], x["ii"], x["lhs"], x["rhs"],
                                               x["lb"], x["ub"], n_pad, 1e-6)
            _match(got[0][i], one[0])
            _match(got[1][i], one[1])
    merged = rt.core.apply_updates_batch(lb, ub, *want, eps, INF, outward, active=active)
    for g, w in zip(tk.apply_updates_batch_tiles(lb.clone(), ub.clone(), *acc, active, eps, INF,
                                                 outward), merged):
        _match(g, w)
    assert _clean(acc)
    counts = tk.form_counts()
    assert counts["batched_fused_scatter_round_tiles[f32]"] == 1
    assert counts["apply_updates_batch_tiles[f32]"] == 1


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("bsz,n_act,width", [(5, 3, 1000), (16, 16, 3000), (128, 0, 1000),
                                             (128, 33, 5000), (128, 128, 60_032)])
def test_batched_merge_stop_matches_plain_version(cuda, gen, dtype, bsz, n_act, width):
    """#9 with the early stop's measure, on the grid (at most 16 rows) and
    on the walk, through three rounds with one ticket and one partials
    buffer: bounds, flags, each active row's block partials and measure
    bitwise its plain version's; inactive rows' entries untouched; the
    ticket back at 0 after every launch."""
    cfg = rt.core.DEFAULT_CONFIG
    eps, outward = cfg.eps_for(dtype), cfg.outward_for(dtype)
    act = _holey_mask(bsz, n_act, cuda)
    lb, ub = _planes(gen, bsz, width, False, cuda)
    lb, ub = lb.to(dtype), ub.to(dtype)
    blocks = -(-width // tref.MERGE_BLOCK)
    part_k = torch.full((bsz, blocks), 7.0, dtype=dtype, device=cuda)
    part_p = part_k.clone()
    prog_k = torch.full((bsz,), 9.0, dtype=dtype, device=cuda)
    prog_p = prog_k.clone()
    ticket = torch.zeros(1, dtype=torch.int32, device=cuda)
    tk.reset_launch_counts()
    for step in (0.5, 1e-3, 0.25):
        pick = torch.from_numpy(gen.random((bsz, width)) < 0.3).to(cuda)
        bl = torch.where(pick, lb + step, torch.full_like(lb, -INF))
        bu = torch.where(~pick, ub - step, torch.full_like(ub, INF))
        got = tk.apply_updates_batch_tiles(lb.clone(), ub.clone(), bl.clone(), bu.clone(), act,
                                           eps, INF, outward, progress=prog_k, partials=part_k,
                                           ticket=ticket)
        prog_w, part_w = prog_p.cpu(), part_p.cpu()
        want = tk.apply_updates_batch_tiles(lb.cpu(), ub.cpu(), bl.cpu(), bu.cpu(), act.cpu(),
                                            eps, INF, outward, progress=prog_w, partials=part_w)
        _match_bits(got[0], want[0].to(cuda))
        _match_bits(got[1], want[1].to(cuda))
        _match(got[2], want[2].to(cuda))
        _match_bits(prog_k, prog_w.to(cuda))
        _match_bits(part_k[act], part_w.to(cuda)[act])
        prog_p, part_p = prog_w.to(cuda), part_w.to(cuda)
        assert int(ticket.item()) == 0
        lb, ub = got[0], got[1]
    assert bool((part_k[~act] == 7.0).all()) and bool((prog_k[~act] == 9.0).all())
    form = "f64+stop" if dtype == torch.float64 else "f32+stop"
    assert tk.form_counts() == {f"apply_updates_batch_tiles[{form}]": 3}


BATCH_TIER_RUNS = [dict(dtype=torch.float32), dict(policy=rt.core.TierPolicy()),
                   dict(stop_progress=0.05, patience=1),
                   dict(dtype=torch.float32, stop_progress=0.01, patience=2)]


@pytest.mark.parametrize("case", range(len(BATCHES)))
def test_batch_tiers_on_card_match_cpu(cuda, case):
    """propagate_batch at float32, under TierPolicy() and with the early stop
    on the card against the same runs on the CPU (the plain versions in the
    kernels' order): every instance's flags, tier rounds, progress and
    bounds bitwise."""
    make, tile_width = BATCHES[case]
    pop = make()
    for run in BATCH_TIER_RUNS:
        got = rt.propagate_batch(pop, tile_width=tile_width, **run)
        want = rt.propagate_batch(pop, tile_width=tile_width, device="cpu", **run)
        for g, w in zip(got, want):
            for f in ("rounds", "converged", "infeasible", "tier_rounds", "lb", "ub"):
                _match(getattr(g, f), getattr(w, f))
            _match_bits(g.progress, w.progress)


@pytest.mark.parametrize("tile_width", [8, 4])
def test_node_and_service_tiers_on_card_match_cpu(cuda, tile_width):
    """propagate_nodes and the service at float32, under TierPolicy() (nodes)
    and with the early stop / early retire on the card against the CPU:
    flags, tier rounds and bounds bitwise; the service's early-stop count
    equal."""
    p = td.make_pseudo_boolean(n=3000, m=4000, seed=7, unit_frac=0.002)
    lb, ub = _nodes(p, 6)
    for run in BATCH_TIER_RUNS:
        got = rt.propagate_nodes(p, lb, ub, tile_width=tile_width, **run)
        want = rt.propagate_nodes(p, lb, ub, tile_width=tile_width, device="cpu", **run)
        for f in ("rounds", "converged", "infeasible", "lb", "ub"):
            _match(getattr(got, f), getattr(want, f))
        if "policy" in run:
            _match(got.tier_rounds, want.tier_rounds)
    pop = [td.make_pseudo_boolean(n=3000, m=4000, seed=s, unit_frac=0.002) for s in (7, 8, 9)]
    for run in (dict(dtype=torch.float32), dict(stop_progress=0.05, patience=1)):
        svc = rt.PropagationService.from_problems(pop, slots=2, tile_width=tile_width, **run)
        ref = rt.PropagationService.from_problems(pop, slots=2, tile_width=tile_width,
                                                  device="cpu", **run)
        for g, w in zip(svc.serve(pop), ref.serve(pop)):
            for f in ("rounds", "converged", "lb", "ub"):
                _match(getattr(g, f), getattr(w, f))
        assert svc.stats()["early_stopped"] == ref.stats()["early_stopped"]


# ---------------------------------------------------------------------------
# The precision tiers on the segment and partitioned engines: the float32
# forms of A, B, C, #11-#15 and the straddle combine, and #15 with the
# early stop (one instance's carry; a batch's rows)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("compact", [True, False], ids=["f32c", "f32"])
@pytest.mark.parametrize("exact", [True, False], ids=["int", "float"])
@pytest.mark.parametrize("t,r,k,n", SHAPES)
def test_float32_segment_kernels_match_plain_versions(cuda, gen, t, r, k, n, exact, compact):
    """A, B and C at float32 over bounds gathered at each slot, B and C on
    int32 or the compact int8 marks, bitwise equal to their plain versions,
    each launching its float form."""
    x = _tier_tiles(_tiles(gen, t, r, k, n, exact, cuda), compact)
    c = x["col"].long()
    lb_g, ub_g = x["lb"][c], x["ub"][c]
    form = "f32c" if compact else "f32"
    tk.reset_launch_counts()
    partials = tk.activities_tiles(x["val"], lb_g, ub_g)
    for g, w in zip(partials, tref.activities_tiles_ref(x["val"], lb_g, ub_g)):
        _match(g, w)
    b_args = (x["val"], lb_g, ub_g, x["ii"], *partials, x["lhs"], x["rhs"], 1e-6)
    for g, w in zip(tk.candidates_tiles(*b_args), tref.candidates_tiles_ref(*b_args)):
        _match(g, w)
    c_args = (x["val"], lb_g, ub_g, x["ii"], x["lhs"], x["rhs"], 1e-6)
    for g, w in zip(tk.fused_round_tiles(*c_args), tref.fused_round_tiles_ref(*c_args)):
        _match(g, w)
    assert tk.form_counts() == {"activities_tiles[f32]": 1, f"candidates_tiles[{form}]": 1,
                                f"fused_round_tiles[{form}]": 1}


SLAB_TIER_CASES = [
    ("make_mixed", dict(m=600, n=450, seed=21), (8, 16), 128, False),
    ("make_knapsack", dict(n=900, m=12, seed=5), (2, 8), 256, True),
    ("make_pseudo_boolean", dict(n=3000, m=4000, seed=7), (8, 8), 1024, True),
]


@pytest.mark.parametrize("case", range(len(SLAB_TIER_CASES)))
def test_float32_slab_kernels_match_plain_versions(cuda, case):
    """#11, the straddle combine, #12 with #15, #15 alone, #13 and #14 at
    float32 on a float32 prep's partition (int32 ids), on a single plane
    and over seven node planes with every, some and no node active:
    bitwise equal to their plain versions (inactive planes' partials
    unwritten), each launching its float form."""
    gen_name, kw, tile, slab, exact = SLAB_TIER_CASES[case]
    p = getattr(td, gen_name)(**kw)
    prep = rt.prepare_block_ell(p, *tile, dtype=torch.float32)
    part = prep.slab_partition(slab)
    cfg = rt.core.DEFAULT_CONFIG
    eps, outward = cfg.eps_for(torch.float32), cfg.outward_for(torch.float32)
    width = prep.n_pad
    tail = (slab, part.max_run_len, eps, 1e-6, INF, outward)
    one = torch.ones(1, dtype=torch.bool, device=cuda)
    lbp, ubp = prep.lb0[None].clone(), prep.ub0[None].clone()
    tk.reset_launch_counts()
    a_args = (part.a_val, part.a_col_s, part.a_run_start, part.a_run_len, part.a_run_inst,
              part.a_run_slab, one, lbp, ubp, slab, part.a_max_run_len)
    partials = tk.batched_slab_partials_tiles(*a_args)
    for g, w in zip(partials, tref.batched_slab_partials_ref(*a_args)):
        _match(g, w)
    index = (part.a_order, part.a_seg, part.agg_slot)
    strs = tk.straddle_combine_tiles(*partials, *index)
    for g, w in zip(strs, tref.straddle_combine_ref(*partials, *index)):
        _match(g, w)
    r_args = (part.val, part.col_s, part.ii_g, part.row_done, *strs, part.lhs_g, part.rhs_g,
              part.run_start, part.run_len, part.run_inst, part.run_slab, one)
    acc = tk.accumulator_planes(lbp)
    got = tk.batched_slab_round_tiles(*r_args, lbp.clone(), ubp.clone(), *tail, acc=acc,
                                      tiles=(part.tile_inst, part.tile_slab),
                                      chunk_len=part.chunk_len, max_chunk_len=part.max_chunk_len)
    want = tref.batched_slab_round_ref(*r_args, lbp, ubp, *tail)
    for g, w in zip(got, want):
        _match(g, w)
    assert _clean(acc)
    best = tref.batched_slab_scatter_ref(
        part.val, part.col_s, part.ii_g, part.row_done, *strs, part.lhs_g, part.rhs_g,
        part.run_start, part.run_inst, part.run_slab, one, lbp, ubp, slab, 1e-6)
    got_m = tk.apply_updates_slab_tiles(lbp.clone(), ubp.clone(), best[0].clone(),
                                        best[1].clone(), one, slab, eps, INF, outward)
    want_m = tref.apply_updates_slab_ref(lbp, ubp, *best, one, slab, eps, INF, outward)
    for g, w in zip(got_m[:2], want_m[:2]):
        _match(g, w)
    assert tk.form_counts() == {
        "batched_slab_partials_tiles[f32]": 1, "straddle_combine_tiles[f32]": 1,
        "batched_slab_round_tiles[f32]": 1, "apply_updates_slab_tiles[f32]": 2}
    lb_n, ub_n = _nodes(p, 7)
    nlb, nub = (torch.nn.functional.pad(torch.as_tensor(x, dtype=torch.float32, device=cuda),
                                        (0, width - p.n)) for x in (lb_n, ub_n))
    for act in (torch.ones(7, dtype=torch.bool), torch.arange(7) % 3 == 0,
                torch.zeros(7, dtype=torch.bool)):
        act = act.to(cuda)
        n_args = (part.a_val, part.a_col_s, part.a_run_start, part.a_run_len, part.a_run_slab,
                  act, nlb, nub, slab, part.a_max_run_len)
        parts_n = tk.node_slab_partials_tiles(*n_args, tile_slab=part.a_tile_slab,
                                              chunk_len=part.a_chunk_len,
                                              max_chunk_len=part.a_max_chunk_len)
        for g, w in zip(parts_n, tref.node_slab_partials_ref(*n_args)):
            _match(g[act], w[act])
        strs_n = tk.straddle_combine_tiles(*parts_n, *index, act)
        for g, w in zip(strs_n, tref.straddle_combine_ref(*parts_n, *index, act)):
            _match(g[act], w[act])
        nr_args = (part.val, part.col_s, part.ii_g, part.row_done, *strs_n, part.lhs_g,
                   part.rhs_g, part.run_start, part.run_len, part.run_slab, act)
        nacc = tk.accumulator_planes(nlb)
        got_n = tk.node_slab_round_tiles(*nr_args, nlb.clone(), nub.clone(), *tail, acc=nacc,
                                         tile_slab=part.tile_slab, chunk_len=part.chunk_len,
                                         max_chunk_len=part.max_chunk_len)
        want_n = tref.node_slab_round_ref(*nr_args, nlb, nub, *tail)
        for g, w in zip(got_n, want_n):
            _match(g, w)
        assert _clean(nacc)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("bsz,n_act,width", [(1, 1, 2500), (1, 1, 150_016), (5, 3, 3000),
                                             (45, 33, 5000)])
def test_window_merge_stop_matches_plain_version(cuda, gen, dtype, bsz, n_act, width):
    """#15 with the early stop against its plain version, bitwise: for one
    plane, folded into a loop carry over six rounds (two of large progress,
    two of low that stop the loop at patience 2, two enqueued after the
    stop): bounds, window flags' fold and the whole carry; for a batch (on
    the grid for at most 16 rows, on the walk beyond), each active row's
    block partials and measure through three rounds with one ticket, window
    flags and bounds; inactive rows' entries untouched."""
    from repro_torch.core import carry as tcarry

    cfg = rt.core.DEFAULT_CONFIG
    eps, outward = cfg.eps_for(dtype), cfg.outward_for(dtype)
    slab = 256
    act = _holey_mask(bsz, n_act, cuda)
    lb, ub = _planes(gen, bsz, width, False, cuda)
    lb, ub = lb.to(dtype), ub.to(dtype)
    blocks = -(-width // tref.MERGE_BLOCK)
    tk.reset_launch_counts()
    if bsz == 1:
        stop = tcarry.EarlyStop(0.05, 2)
        st_k, st_p = tcarry.armed_state(cuda), tcarry.armed_state(cuda)
        partials = torch.empty(blocks, dtype=dtype, device=cuda)
        for i, big in enumerate((True, True, False, False, True, True)):
            pick = torch.from_numpy(gen.random((1, width)) < (0.3 if big else 3 / width)).to(cuda)
            step = 0.5 if big else 1e-3
            bl = torch.where(pick, lb + step, torch.full_like(lb, -INF))
            bu = torch.where(pick, ub - step, torch.full_like(ub, INF))
            acc = (bl.clone(), bu.clone())
            got = tk.prop_round._slab_merge(lb.clone(), ub.clone(), *acc, tcarry.go_mask(st_k),
                                            slab, eps, INF, outward, carry=st_k, stop=stop,
                                            partials=partials)
            new = tref.apply_updates_slab_ref(lb, ub, bl, bu, tcarry.go_mask(st_p), slab, eps,
                                              INF, outward)
            prog = tref.merge_progress(lb, ub, new[0], new[1])
            tcarry.fold(st_p, new[2].any(), 0, 1, stop, prog)
            _match_bits(st_k, st_p)
            assert bool(got) == bool(tcarry.go_flag(st_p))
            lb, ub = new[0], new[1]
        fields = st_k.tolist()
        assert fields[tcarry.GO] == 0 and fields[tcarry.FLAT] == 2 and fields[tcarry.ROUNDS] == 4
        form = "f64+stop" if dtype == torch.float64 else "f32+stop"
        assert tk.form_counts() == {f"apply_updates_slab_tiles[{form}]": 6}
        return
    part_k = torch.full((bsz, blocks), 7.0, dtype=dtype, device=cuda)
    prog_k = torch.full((bsz,), 9.0, dtype=dtype, device=cuda)
    prog_p = prog_k.clone()
    ticket = torch.zeros(1, dtype=torch.int32, device=cuda)
    for step in (0.5, 1e-3, 0.25):
        pick = torch.from_numpy(gen.random((bsz, width)) < 0.3).to(cuda)
        bl = torch.where(pick, lb + step, torch.full_like(lb, -INF))
        bu = torch.where(~pick, ub - step, torch.full_like(ub, INF))
        lbk, ubk = lb.clone(), ub.clone()
        flags = tk.prop_round._slab_merge(lbk, ubk, bl.clone(), bu.clone(), act, slab, eps, INF,
                                          outward, progress=prog_k, partials=part_k,
                                          ticket=ticket)
        new = tref.apply_updates_slab_ref(lb, ub, bl, bu, act, slab, eps, INF, outward)
        blocks_p, rows_p = tref.merge_rows_progress(lb, ub, new[0], new[1])
        prog_p = torch.where(act, rows_p, prog_p)
        _match_bits(lbk, new[0])
        _match_bits(ubk, new[1])
        _match(flags, new[2])
        _match_bits(prog_k, prog_p)
        _match_bits(part_k[act], blocks_p[act])
        assert int(ticket.item()) == 0
        lb, ub = new[0], new[1]
    assert bool((part_k[~act] == 7.0).all()) and bool((prog_k[~act] == 9.0).all())
    form = "f64+stop_rows" if dtype == torch.float64 else "f32+stop_rows"
    assert tk.form_counts() == {f"apply_updates_slab_tiles[{form}]": 3}


ENGINE_TIER_RUNS = [dict(dtype=torch.float32), dict(policy=rt.core.TierPolicy()),
                    dict(stop_progress=0.05, patience=1),
                    dict(dtype=torch.float32, stop_progress=0.01, patience=2),
                    dict(dtype=torch.float32, stop_progress=1e6, patience=1)]


@pytest.mark.parametrize("gen_name,kw,tile,scatter,exact", [
    ("make_pseudo_boolean", dict(n=3000, m=4000, seed=7), (8, 128), "segment", True),
    ("make_mixed", dict(m=600, n=450, seed=21), (8, 16), "segment", False),
    ("make_mixed", dict(m=6000, n=40_000, seed=3, density=0.002), (8, 128), "segment", False),
    ("make_pseudo_boolean", dict(n=3000, m=4000, seed=7), (8, 8), "partitioned", True),
    ("make_mixed", dict(m=600, n=450, seed=21), (8, 16), "partitioned", False),
    ("make_knapsack", dict(n=900, m=12, seed=5), (2, 8), "partitioned", True),
])
def test_engine_tiers_on_card_match_cpu(cuda, gen_name, kw, tile, scatter, exact):
    """float32-only, two-tier, early-stopped and eagerly stopped fixed
    points on the segment and partitioned engines (128-column slabs) on the
    card against the same runs on the CPU: rounds, flags, tier rounds,
    progress and bounds (bitwise on exact data), both drivers."""
    p = getattr(td, gen_name)(**kw)
    for run in ENGINE_TIER_RUNS:
        for driver in ("host_loop", "device_loop"):
            args = dict(tile_rows=tile[0], tile_width=tile[1], scatter=scatter, slab=128,
                        driver=driver, **run)
            got = rt.propagate_block_ell(p, **args)
            want = rt.propagate_block_ell(p, device="cpu", **args)
            for f in ("rounds", "converged", "infeasible", "tier_rounds"):
                assert getattr(got, f).item() == getattr(want, f).item(), (run, driver, f)
            assert got.lb.dtype == want.lb.dtype
            if exact:
                _match(got.lb, want.lb)
                _match(got.ub, want.ub)
                if "stop_progress" in run:
                    _match_bits(got.progress, want.progress)
            else:
                assert rt.bounds_equal(got.lb, got.ub, want.lb, want.ub)


def test_batch_and_node_tiers_past_the_limit_on_card(cuda, small_limit):
    """Past the (shrunk) limit: propagate_batch and propagate_nodes at
    float32, under TierPolicy() and with the early stop (the partitioned
    batched rounds; #15 measuring each active row) on the card against the
    CPU: flags, tier rounds, progress and bounds bitwise, every float form
    of the path launched."""
    pop = [td.make_pseudo_boolean(n=3000, m=4000, seed=s, unit_frac=0.002) for s in (7, 8)]
    for run in BATCH_TIER_RUNS:
        tk.reset_launch_counts()
        got = rt.propagate_batch(pop, tile_width=8, **run)
        counts = tk.form_counts()
        want = rt.propagate_batch(pop, tile_width=8, device="cpu", **run)
        for g, w in zip(got, want):
            for f in ("rounds", "converged", "infeasible", "tier_rounds", "lb", "ub"):
                _match(getattr(g, f), getattr(w, f))
            _match_bits(g.progress, w.progress)
        if run.get("dtype") == torch.float32:
            assert counts.get("batched_slab_round_tiles[f32]", 0) > 0
        if "stop_progress" in run:
            assert any(k.startswith("apply_updates_slab_tiles") and k.endswith("+stop_rows]")
                       for k in counts)
    p = pop[0]
    lb, ub = _nodes(p, 6)
    for run in BATCH_TIER_RUNS:
        tk.reset_launch_counts()
        got = rt.propagate_nodes(p, lb, ub, tile_width=8, **run)
        counts = tk.form_counts()
        want = rt.propagate_nodes(p, lb, ub, tile_width=8, device="cpu", **run)
        for f in ("rounds", "converged", "infeasible", "lb", "ub"):
            _match(getattr(got, f), getattr(want, f))
        if "stop_progress" in run:
            _match_bits(got.progress, want.progress)
        if run.get("dtype") == torch.float32:
            assert counts.get("node_slab_round_tiles[f32]", 0) > 0
            assert counts.get("node_slab_partials_tiles[f32]", 0) > 0


# ---------------------------------------------------------------------------
# Telemetry: the record kernels, and telemetry on against off on the card
# ---------------------------------------------------------------------------


def _planes_match(got, want):
    for g, w in zip(got, want):
        _match_bits(g, w)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", [37, 5000, 70_000])
def test_record_round_matches_plain_version(cuda, gen, dtype, n):
    """``record_round`` against its plain version on the same carry: the
    carry's measure at ``ticks % cap`` (across a wrap), the ``ROUNDS``
    gate (a repeated launch records nothing), both latches, and the host
    loop's probe into the carry's ``CROSS`` field; plane and carry bitwise."""
    from repro_torch.core import carry as tcarry
    from repro_torch.obs import device_plane

    lb = torch.as_tensor(gen.integers(-3, 1, n), dtype=dtype, device=cuda)
    ub = torch.as_tensor(gen.integers(1, 4, n), dtype=dtype, device=cuda)
    carry = tcarry.armed_state(cuda)
    got = device_plane(3, dtype=dtype, device=cuda)
    want = device_plane(3, dtype=dtype, device=cuda)
    scratch = torch.zeros(2, dtype=torch.int32, device=cuda)
    tk.reset_launch_counts()
    for r in range(1, 8):
        carry[tcarry.ROUNDS] = r
        carry[tcarry.FLAT] = r - 4
        tcarry.progress_view(carry, dtype).fill_(float(gen.random()))
        if r == 5:
            ub[n // 2] = lb[n // 2] - 1.0
        for _ in range(2):
            tk.record_round_tiles(lb, ub, carry, got, 1e-6, patience=2, scratch=scratch)
            tref.record_round_ref(lb, ub, carry, want, 1e-6, 1, 2)
            _planes_match(got, want)
    assert int(got.infeas_round) == 5 and int(got.stop_round) == 6
    assert scratch.tolist() == [0, 0]
    for cross in (True, False):
        ub[n // 2] = lb[n // 2] - 1.0 if cross else lb[n // 2] + 1.0
        state = carry.clone()
        tk.record_round_tiles(lb, ub, carry, None, 1e-6, scratch=scratch)
        tref.record_round_ref(lb, ub, state, None, 1e-6)
        _match_bits(carry, state)
        assert int(carry[tcarry.CROSS]) == int(cross)
    form = "f64" if dtype == torch.float64 else "f32"
    assert tk.form_counts() == {f"record_round_tiles[{form}]": 16}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("bsz,n", [(1, 37), (4, 5000), (130, 300)])
def test_record_round_batch_matches_plain_version(cuda, gen, dtype, bsz, n):
    """``record_round_batch`` against its plain version over rounds with
    random masks, streaks and crossings (inactive rows untouched), across a
    wrap; plane bitwise and the scratch left zeroed."""
    from repro_torch.obs import device_plane

    lb = torch.zeros(bsz, n, dtype=dtype, device=cuda)
    ub = torch.ones(bsz, n, dtype=dtype, device=cuda)
    got = device_plane(3, batch=bsz, dtype=dtype, device=cuda)
    want = device_plane(3, batch=bsz, dtype=dtype, device=cuda)
    scratch = torch.zeros(bsz + 1, dtype=torch.int32, device=cuda)
    rounds = torch.zeros(bsz, dtype=torch.int32, device=cuda)
    for _ in range(6):
        rows = torch.as_tensor(gen.random(bsz) < 0.3, device=cuda)
        ub[rows, gen.integers(0, n)] = -1.0
        ran = torch.as_tensor(gen.random(bsz) < 0.7, device=cuda)
        rounds = rounds + ran.to(torch.int32)
        flat = torch.as_tensor(gen.integers(0, 3, bsz), dtype=torch.int32, device=cuda)
        prog = torch.as_tensor(gen.random(bsz), dtype=dtype, device=cuda)
        tk.record_round_batch_tiles(lb, ub, prog, ran, rounds, flat, got, 1e-6, patience=2,
                                    scratch=scratch)
        tref.record_round_batch_ref(lb, ub, prog, ran, rounds, flat, want, 1e-6, 2)
        _planes_match(got, want)
    assert not bool(scratch.any())


def _same_result(got, want):
    for f in ("lb", "ub", "rounds", "converged", "infeasible", "progress", "tier_rounds"):
        _match_bits(torch.as_tensor(getattr(got, f)), torch.as_tensor(getattr(want, f)))


def _snapshots_equal(got, want):
    for f in ("capacity", "rounds_recorded", "stop_round", "infeasible_round",
              "tier_switch_round"):
        assert getattr(got, f) == getattr(want, f), f
    np.testing.assert_array_equal(got.progress_history(), want.progress_history())


@pytest.mark.parametrize("scatter", ["fused", "segment", "partitioned"])
@pytest.mark.parametrize("run", [{}, dict(stop_progress=0.05, patience=1),
                                 dict(policy="tier"), dict(dtype=torch.float32)])
def test_telemetry_on_card_equals_off_and_cpu(cuda, scatter, run):
    """Telemetry on against off on the card, every engine, both drivers:
    every result field and the host reads bitwise; the snapshot equals the
    same run's on the CPU (the plain record in the kernels' order), and the
    record kernel launched at least once per recorded round."""
    p = td.make_pseudo_boolean(n=3000, m=4000, seed=7)
    run = {**run, "policy": rt.core.TierPolicy()} if "policy" in run else run
    kw = dict(tile_width=16, scatter=scatter, **run)
    if scatter == "partitioned":
        kw["slab"] = 1024
    for driver in ("host_loop", "device_loop"):
        reads = [[], []]
        off = rt.propagate_block_ell(p, driver=driver, on_sync=lambda: reads[0].append(1), **kw)
        tk.reset_launch_counts()
        on = rt.propagate_block_ell(p, driver=driver, telemetry=16,
                                    on_sync=lambda: reads[1].append(1), **kw)
        launches = tk.launch_counts()["record_round_tiles"]
        _same_result(on, off)
        assert len(reads[0]) == len(reads[1])
        assert launches >= on.telemetry.rounds_recorded > 0
        cpu = rt.propagate_block_ell(p, driver=driver, telemetry=16, device="cpu", **kw)
        _snapshots_equal(on.telemetry, cpu.telemetry)


def test_batched_telemetry_on_card_equals_off_and_cpu(cuda):
    """Batches, nodes, the solver and the service with telemetry on the
    card: results bitwise telemetry-off's, snapshots the CPU run's, the
    batched record kernel launched."""
    pop = [td.make_pseudo_boolean(n=3000, m=4000, seed=s, unit_frac=0.002) for s in (7, 8)]
    pop.append(td.make_cascade_chain(length=40))
    for run in ({}, dict(stop_progress=0.05), dict(policy=rt.core.TierPolicy())):
        off = rt.propagate_batch(pop, tile_width=8, **run)
        tk.reset_launch_counts()
        on = rt.propagate_batch(pop, tile_width=8, telemetry=16, **run)
        assert tk.launch_counts()["record_round_batch_tiles"] > 0
        cpu = rt.propagate_batch(pop, tile_width=8, telemetry=16, device="cpu", **run)
        for a, b, c in zip(off, on, cpu):
            _same_result(b, a)
            _snapshots_equal(b.telemetry, c.telemetry)
    p = pop[0]
    lb, ub = _nodes(p, 6)
    off = rt.propagate_nodes(p, lb, ub, tile_width=8)
    on = rt.propagate_nodes(p, lb, ub, tile_width=8, telemetry=16)
    cpu = rt.propagate_nodes(p, lb, ub, tile_width=8, telemetry=16, device="cpu")
    for f in ("lb", "ub", "rounds", "converged", "infeasible", "progress"):
        _match_bits(getattr(on, f), getattr(off, f))
    for i in range(6):
        _snapshots_equal(on.node_telemetry(i), cpu.node_telemetry(i))
    q = td.make_pseudo_boolean(n=12, m=16, seed=0)
    c = np.arange(1, q.n + 1) * np.where(np.arange(q.n) % 3 == 0, -1.0, 1.0)
    a, b = rt.solve(q, c), rt.solve(q, c, telemetry=16)
    assert (a.status, a.nodes_created, a.levels) == (b.status, b.nodes_created, b.levels)
    _snapshots_equal(b.telemetry, rt.solve(q, c, telemetry=16, device="cpu").telemetry)
    svc_off = rt.PropagationService.from_problems(pop, slots=2, tile_width=8)
    svc_on = rt.PropagationService.from_problems(pop, slots=2, tile_width=8, telemetry=16)
    for a, b in zip(svc_off.serve(pop), svc_on.serve(pop)):
        _same_result(b, a)
        assert b.telemetry.rounds_recorded == int(b.rounds)


# ---------------------------------------------------------------------------
# The sharded engines: a world of one rank on the card, over NCCL
# ---------------------------------------------------------------------------

NO_WIDENING = dataclasses.replace(rt.core.DEFAULT_CONFIG, outward_eps_f32=0.0)


@pytest.fixture(scope="module")
def nccl_world():
    """``torch_sharded_world.cases`` on a world of one NCCL rank on the
    card, and that rank's launches per sharded path."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch_sharded_world as world

    run = lambda fn: rt.core.run_world(fn, 1, backend="nccl", device="cuda", args=("cuda",),
                                       timeout=600)[0]
    return world, run(world.cases), run(world.launches)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", ["cascade", "pb", "set_cover", "knapsack", "mixed", "banded"])
def test_sharded_rows_on_card_equal_unsharded(nccl_world, name, dtype):
    """The row partition on the kernels equals the unsharded engine on the
    card, bitwise (at float32 both without outward widening)."""
    world, got, _ = nccl_world
    p = world.build(td, name)
    want = rt.propagate_block_ell(p, NO_WIDENING, tile_width=world.TILE_WIDTH,
                                  dtype=np.dtype(dtype))
    r = got[("rows", name, dtype)]
    for f in ("lb", "ub", "rounds", "converged", "infeasible"):
        np.testing.assert_array_equal(np.asarray(getattr(r, f)),
                                      getattr(want, f).cpu().numpy(), err_msg=f)


@pytest.mark.parametrize("name", ["cascade", "pb", "set_cover", "knapsack", "mixed", "banded"])
def test_sharded_nnz_on_card_holds_unsharded(nccl_world, name):
    """The nnz partition on the kernels: the unsharded engine's rounds and
    verdict, its bounds under ``bounds_equal`` (bitwise on exact data)."""
    world, got, _ = nccl_world
    p = world.build(td, name)
    want = rt.propagate_block_ell(p, tile_width=world.TILE_WIDTH)
    r = got[("nnz", name, "float64")]
    assert int(r.rounds) == int(want.rounds)
    assert bool(r.infeasible) == bool(want.infeasible)
    assert rt.bounds_equal(r.lb, r.ub, want.lb, want.ub)
    if world.CASES[name][2]:
        np.testing.assert_array_equal(r.lb, want.lb.cpu().numpy())
        np.testing.assert_array_equal(r.ub, want.ub.cpu().numpy())


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("batch", ["six", "two"])
def test_sharded_batch_on_card_equals_unsharded(nccl_world, batch, dtype):
    world, got, _ = nccl_world
    problems = [world.build(td, name) for name in world.BATCHES[batch]]
    want = rt.propagate_batch(problems, NO_WIDENING, tile_width=world.TILE_WIDTH,
                              dtype=np.dtype(dtype))
    for g, w in zip(got[("batch", batch, dtype)], want):
        for f in ("lb", "ub", "rounds", "converged", "infeasible", "progress"):
            np.testing.assert_array_equal(np.asarray(getattr(g, f)),
                                          getattr(w, f).cpu().numpy(), err_msg=f)


def test_sharded_paths_launch_their_kernels(nccl_world):
    _, _, launched = nccl_world
    need = {
        "nnz mixed": ("activities_gather_tiles", "combine_chunk_partials_tiles",
                      "candidates_scatter_tiles", "apply_updates_tiles"),
        "rows pb": ("fused_scatter_round_tiles", "apply_updates_tiles"),
        "rows knapsack": ("activities_gather_tiles", "combine_chunk_partials_tiles",
                          "candidates_scatter_tiles", "apply_updates_tiles"),
        "batch six": ("activities_gather_tiles", "combine_chunk_partials_tiles",
                      "candidates_scatter_tiles", "apply_updates_batch_tiles"),
    }
    for label, kernels in need.items():
        for k in kernels:
            assert launched[label].get(k, 0) > 0, (label, k, launched[label])
    assert "fused_scatter_round_tiles" not in launched["nnz mixed"]


LM_ARCHS = ["granite-3-2b", "granite-3-8b", "qwen2-0.5b", "chatglm3-6b", "musicgen-medium",
            "internvl2-1b", "mamba2-780m", "recurrentgemma-9b", "deepseek-v2-236b",
            "qwen3-moe-30b-a3b"]


def _lm_logits(tf, ss, model, cfg, toks, fe, s_prompt, steps, dev):
    """forward_train, prefill and ``steps`` decode logits of ``model`` on ``dev``."""
    fe = None if fe is None else fe.to(dev)
    with torch.no_grad():
        out = [tf.forward_train(model, cfg, toks.to(dev), fe)[0]]
    lg, caches = tf.prefill(model, cfg, toks[:, :s_prompt].to(dev), fe)
    out.append(lg)
    s0 = s_prompt + (0 if fe is None else fe.shape[1])
    cache = ss.prefill_to_decode_cache(cfg, caches, s0, s0 + steps)
    for i in range(steps):
        lg, cache = tf.decode_step(model, cfg, toks[:, s_prompt + i : s_prompt + i + 1].to(dev),
                                   cache, s0 + i)
        out.append(lg)
    return [o.cpu() for o in out]


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_serving_on_card_equals_cpu(cuda, arch):
    """The LM serving path (no kernel of its own) on the card against the CPU,
    same float32 weights, no TF32: forward, prefill and 4 decode logits
    within 1e-3 (``rtol = atol``), all finite."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.train import serve_step as ss

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = get_config(arch, smoke=True)
    card = tf.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    host = tf.params_from_reference(cfg, card.numpy_tree(), device="cpu")
    gen = torch.Generator().manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (2, 20), generator=gen)
    fe = None
    if cfg.frontend != "none":
        fe = torch.randn((2, cfg.n_frontend_tokens, cfg.d_model), generator=gen) * 0.1
    got = _lm_logits(tf, ss, card, cfg, toks, fe, 16, 4, cuda)
    want = _lm_logits(tf, ss, host, cfg, toks, fe, 16, 4, "cpu")
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.double().numpy(), w.double().numpy(), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_train_step_on_card_equals_cpu(cuda, arch):
    """The training path (no kernel of its own) on the card against the
    CPU, same float32 weights and batch, no TF32: the loss and every leaf's
    gradient within 1e-3 (``atol`` scaled by the leaf's largest magnitude,
    floored at ``1e-6 x`` the model's largest gradient: the key bias's exact
    gradient is zero, and its rounding noise differs between the devices),
    then one ``make_train_step`` step: its loss, gradient norm and learning
    rate.  (The params after it are not compared: Adam's first update is
    about ``lr * sign(g)``, and the key bias's exact gradient is zero.)"""
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import DataConfig, make_batch
    from repro_torch.models import transformer as tf
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts
    from repro_torch.train.tree import paths, tree_map

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = get_config(arch, smoke=True)
    card = tf.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    host = tf.params_from_reference(cfg, card.numpy_tree(), device="cpu")
    batch = make_batch(DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=2), 0)
    if cfg.frontend != "none":
        batch["frontend_embeds"] = (torch.randn((2, cfg.n_frontend_tokens, cfg.d_model),
                                                generator=torch.Generator().manual_seed(1))
                                    * 0.02).numpy()
    opt_cfg = opt.OptimizerConfig(lr_peak=1e-3, warmup_steps=1, total_steps=10)
    step = ts.make_train_step(cfg, opt_cfg)
    out = []
    for model in (card, host):
        p = tree_map(lambda t: t.detach(), model.tree())
        (loss, _), g = ts.value_and_grad(ts.make_loss_fn(cfg))(p, batch)
        _, _, metrics = step(p, opt.init_opt_state(p, opt_cfg), batch)
        out.append((float(loss), {k: v.cpu() for k, v in paths(g)},
                    {k: float(v) for k, v in metrics.items()}))
    (l_c, g_c, m_c), (l_h, g_h, m_h) = out
    np.testing.assert_allclose(l_c, l_h, rtol=1e-3, atol=1e-3)
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(m_c[k], m_h[k], rtol=1e-3, atol=1e-3, err_msg=k)
    top = max(float(v.abs().max()) for v in g_h.values())
    for k, want in g_h.items():
        assert torch.isfinite(g_c[k]).all(), k
        scale = float(want.abs().max())
        np.testing.assert_allclose(g_c[k].double().numpy(), want.double().numpy(), rtol=1e-3,
                                   atol=1e-3 * scale + 1e-6 * top, err_msg=k)


# ---------------------------------------------------------------------------
# Phase 20's pieces: the sharded LM step on a world of one NCCL rank, and the
# propagation rounds counted on a fake world with their kernels on the card
# ---------------------------------------------------------------------------


def test_launch_sharded_step_and_serving_on_one_nccl_rank(cuda):
    """``make_train_step`` / ``make_prefill_fn`` / ``make_serve_step`` with a
    ``(1, 1)`` mesh on a world of one NCCL rank (granite-3-2b SMOKE, float32)
    against the unsharded port on the card, same weights: loss within 1e-5
    (relative), params within 1e-5, logits within 1e-5 of their scale.  The
    decode cache (32 slots) is placed by ``cache_spec``: its sequence over
    the one "model" rank, so the split softmax's all-reduces run on NCCL."""
    import torch_launch_world as world

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.train import optimizer as opt
    from repro_torch.train import serve_step as ss
    from repro_torch.train import train_step as ts
    from repro_torch.train.tree import paths

    arch = "granite-3-2b"
    cfg = get_config(arch, smoke=True)
    tree = tf.init_params(cfg, 0, device="cpu").numpy_tree()
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 32)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    (got,) = rt.core.run_world(world.lm_cases, 1, backend="nccl", device="cuda", timeout=600,
                               args=(arch, tree, batch, (1, 1), [("base", (), 1)],
                                     (toks[:2, :16], 4, 32), "cuda"))
    model = tf.params_from_reference(cfg, tree, device=cuda)
    oc = opt.OptimizerConfig(**world.OPT)
    p1, _, m1 = ts.make_train_step(cfg, oc)(model, opt.init_opt_state(model.tree(), oc), batch)
    metrics, params = got["base"][0], dict(paths(got["base"][1]))
    assert abs(metrics["loss"] - float(m1["loss"])) <= 1e-5 * abs(float(m1["loss"]))
    for k, want in paths(p1):
        assert np.abs(params[k] - want.cpu().numpy()).max() <= 1e-5, k
    logits, caches = ss.make_prefill_fn(cfg)(model, torch.as_tensor(toks[:2, :16], device=cuda))
    cache = ss.prefill_to_decode_cache(cfg, caches, 16, 32)
    want = [logits.cpu().numpy()]
    for i in range(4):
        tok = torch.as_tensor(got["serve"][i][:, -1], device=cuda).argmax(-1)[:, None]
        logits, cache = ss.make_serve_step(cfg)(model, tok.to(torch.int32), cache, 16 + i)
        want.append(logits.cpu().numpy())
    for a, b in zip(got["serve"], want):
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()


def test_launch_propagation_rounds_launch_their_kernels(cuda):
    """One counted round of each partition on rank 0 of a fake world of 4,
    its kernels on the card: 50,000 B and 10,000 B of all-reduce (equal to
    ``lower_sharded``'s) and the rounds' kernels launched once each (A',
    the long-row combine, E and F; D and F)."""
    import torch_launch_world as world

    nnz, rows = world.in_child(world.propagation_rounds, dict(m=2_500, n=1_250, nnz=40_000),
                               "cuda")
    assert nnz["per_round_collective_bytes"]["all-reduce"] == 50_000
    assert rows["per_round_collective_bytes"]["all-reduce"] == 10_000
    assert nnz["matches_lower_sharded"] and rows["matches_lower_sharded"]
    assert nnz["launches"] == {"activities_gather_tiles": 1, "combine_chunk_partials_tiles": 1,
                               "candidates_scatter_tiles": 1, "apply_updates_tiles": 1}
    assert rows["launches"] == {"fused_scatter_round_tiles": 1, "apply_updates_tiles": 1}


# ---------------------------------------------------------------------------
# bfloat16 and float16 on the single-instance engines (csrc/half_round.cu)
# ---------------------------------------------------------------------------

HALF_DTYPES = [torch.bfloat16, torch.float16]


def _match_values(got, want):
    """Equal as values (-0.0 equals +0.0; NaN where both hold it), 16-bit
    tensors included; the scatters' float32 planes against 16-bit
    candidates widened."""
    torch.cuda.synchronize()
    assert got.shape == want.shape
    g, w = got.cpu(), want.cpu().to(got.dtype)
    same = g == w
    if g.is_floating_point():
        same |= torch.isnan(g) & torch.isnan(w)
    assert bool(same.all()), int((~same).sum())


def _half_tiles(x, dtype, compact):
    """Tiles of :func:`_tiles` at a 16-bit type (bfloat16 with the compact
    index streams where ``compact``)."""
    f = lambda t: t.to(dtype)
    y = dict(x, val=f(x["val"]), lb=f(x["lb"]), ub=f(x["ub"]), lhs=f(x["lhs"]),
             rhs=f(x["rhs"]))
    if compact:
        y.update(col=x["col"].to(torch.int16), ii=x["ii"].to(torch.int8))
    return y


@pytest.mark.parametrize("compact", [True, False], ids=["compact", "int32"])
@pytest.mark.parametrize("dtype", HALF_DTYPES, ids=["bf16", "f16"])
@pytest.mark.parametrize("exact", [True, False], ids=["int", "float"])
@pytest.mark.parametrize("t,r,k,n", LENGTH_SHAPES)
def test_half_kernels_match_plain_versions(cuda, gen, t, r, k, n, exact, dtype, compact):
    """D, A', the combine, E, F and F's stop form, and A, B, C, at bfloat16
    (int32 or the compact ids) and float16 (int32), against their plain
    versions: candidates in float32 planes holding the 16-bit values, the
    rest bitwise as values; each launching its 16-bit form."""
    from repro_torch.core import carry as tcarry

    if compact and dtype == torch.float16:
        pytest.skip("float16 preps never hold the compact ids")
    x = _half_tiles(_tiles(gen, t, r, k, n, exact, cuda), dtype, compact)
    eps, int_eps, inf, outward = rt.core.propagator.round_scalars(rt.core.DEFAULT_CONFIG, dtype)
    label = ("bf16" if dtype == torch.bfloat16 else "f16") + ("c" if compact else "")
    value = label.rstrip("c")
    tk.reset_launch_counts()
    d_args = (x["val"], x["col"], x["ii"], x["lhs"], x["rhs"], x["lb"], x["ub"], x["n_pad"],
              int_eps, inf)
    best = tref.fused_scatter_round_tiles_ref(*d_args)
    got = tk.fused_scatter_round_tiles(*d_args)
    for g, w in zip(got, best):
        _match_values(g, w)
    a_args = (x["val"], x["col"], x["lb"], x["ub"], x["n_pad"], inf)
    aggs = tk.activities_gather_tiles(*a_args)
    for g, w in zip(aggs, tref.activities_gather_tiles_ref(*a_args)):
        _match_values(g, w)
    crow = torch.arange(t * r, dtype=torch.int32, device=cuda).reshape(t, r) // 3
    row_start = tref.row_starts(crow, int(crow.max()) + 2)
    done = tk.combine_chunk_partials_tiles(*aggs, crow, row_start)
    for g, w in zip(done, tref.combine_chunk_partials_ref(*aggs, crow, row_start)):
        _match_values(g, w)
    e_args = (x["val"], x["col"], x["ii"], *done, x["lhs"], x["rhs"], x["lb"], x["ub"],
              x["n_pad"], int_eps, inf)
    for g, w in zip(tk.candidates_scatter_tiles(*e_args),
                    tref.candidates_scatter_tiles_ref(*e_args)):
        _match_values(g, w)
    planes = tk.accumulator_planes(x["lb"], inf)
    for p_, b in zip(planes, best):
        p_.copy_(b)
    want = rt.core.apply_updates(x["lb"], x["ub"], *best, eps, inf, outward)
    lb, ub = x["lb"].clone(), x["ub"].clone()
    got = tk.apply_updates_tiles(lb, ub, *(p_.clone() for p_ in planes), eps, inf, outward)
    for g, w in zip(got[:2], want[:2]):
        _match_values(g, w)
    stop = tcarry.EarlyStop(0.5, 1)
    st_k, st_p = tcarry.armed_state(cuda), tcarry.armed_state(cuda)
    got = tk.apply_updates_tiles(x["lb"].clone(), x["ub"].clone(), *(p_.clone() for p_ in planes),
                                 eps, inf, outward, carry=st_k, stop=stop)
    want = tref.merge_carry_ref(x["lb"], x["ub"], *(p_.clone() for p_ in planes), eps, inf,
                                outward, st_p, 0, 1, stop)
    for g, w in zip(got[:2], want[:2]):
        _match_values(g, w)
    _match_bits(st_k, st_p)
    c = x["col"].long()
    lb_g, ub_g = x["lb"][c], x["ub"][c]
    partials = tk.activities_tiles(x["val"], lb_g, ub_g, inf)
    for g, w in zip(partials, tref.activities_tiles_ref(x["val"], lb_g, ub_g, inf)):
        _match_values(g, w)
    b_args = (x["val"], lb_g, ub_g, x["ii"], *partials, x["lhs"], x["rhs"], int_eps, inf)
    for g, w in zip(tk.candidates_tiles(*b_args), tref.candidates_tiles_ref(*b_args)):
        _match_values(g, w)
    c_args = (x["val"], lb_g, ub_g, x["ii"], x["lhs"], x["rhs"], int_eps, inf)
    for g, w in zip(tk.fused_round_tiles(*c_args), tref.fused_round_tiles_ref(*c_args)):
        _match_values(g, w)
    assert tk.form_counts() == {
        f"fused_scatter_round_tiles[{label}]": 1, f"activities_gather_tiles[{label}]": 1,
        f"combine_chunk_partials_tiles[{value}]": 1, f"candidates_scatter_tiles[{label}]": 1,
        f"apply_updates_tiles[{value}]": 1, f"apply_updates_tiles[{value}+stop]": 1,
        f"activities_tiles[{value}]": 1, f"candidates_tiles[{label}]": 1,
        f"fused_round_tiles[{label}]": 1}


@pytest.mark.parametrize("dtype", HALF_DTYPES, ids=["bf16", "f16"])
@pytest.mark.parametrize("case", range(len(SLAB_TIER_CASES)))
def test_half_slab_kernels_match_plain_versions(cuda, case, dtype):
    """#11, the straddle combine, #12 with #15, #15 alone and #15's stop
    form (one instance's carry) at 16 bits on a 16-bit prep's partition,
    against their plain versions, bitwise as values (the carry bitwise),
    each launching its 16-bit form."""
    from repro_torch.core import carry as tcarry

    gen_name, kw, tile, slab, _ = SLAB_TIER_CASES[case]
    p = getattr(td, gen_name)(**kw)
    prep = rt.prepare_block_ell(p, *tile, dtype=dtype)
    part = prep.slab_partition(slab)
    eps, int_eps, inf, outward = rt.core.propagator.round_scalars(rt.core.DEFAULT_CONFIG, dtype)
    tail = (slab, part.max_run_len, eps, int_eps, inf, outward)
    one = torch.ones(1, dtype=torch.bool, device=cuda)
    lbp, ubp = prep.lb0[None].clone(), prep.ub0[None].clone()
    label = "bf16" if dtype == torch.bfloat16 else "f16"
    tk.reset_launch_counts()
    a_args = (part.a_val, part.a_col_s, part.a_run_start, part.a_run_len, part.a_run_inst,
              part.a_run_slab, one, lbp, ubp, slab, part.a_max_run_len, inf)
    partials = tk.batched_slab_partials_tiles(*a_args)
    for g, w in zip(partials, tref.batched_slab_partials_ref(*a_args)):
        _match_values(g, w)
    index = (part.a_order, part.a_seg, part.agg_slot)
    strs = tk.straddle_combine_tiles(*partials, *index)
    for g, w in zip(strs, tref.straddle_combine_ref(*partials, *index)):
        _match_values(g, w)
    r_args = (part.val, part.col_s, part.ii_g, part.row_done, *strs, part.lhs_g, part.rhs_g,
              part.run_start, part.run_len, part.run_inst, part.run_slab, one)
    acc = tk.accumulator_planes(lbp, inf)
    got = tk.batched_slab_round_tiles(*r_args, lbp.clone(), ubp.clone(), *tail, acc=acc,
                                      tiles=(part.tile_inst, part.tile_slab),
                                      chunk_len=part.chunk_len, max_chunk_len=part.max_chunk_len)
    want = tref.batched_slab_round_ref(*r_args, lbp, ubp, *tail)
    for g, w in zip(got, want):
        _match_values(g, w)
    torch.cuda.synchronize()
    assert bool((acc[0] == -inf).all() and (acc[1] == inf).all())
    best = tref.batched_slab_scatter_ref(
        part.val, part.col_s, part.ii_g, part.row_done, *strs, part.lhs_g, part.rhs_g,
        part.run_start, part.run_inst, part.run_slab, one, lbp, ubp, slab, int_eps, inf)
    planes = tuple(b.float() for b in best)
    got_m = tk.apply_updates_slab_tiles(lbp.clone(), ubp.clone(), *(b.clone() for b in planes),
                                        one, slab, eps, inf, outward)
    want_m = tref.apply_updates_slab_ref(lbp, ubp, *best, one, slab, eps, inf, outward)
    for g, w in zip(got_m[:2], want_m[:2]):
        _match_values(g, w)
    stop = tcarry.EarlyStop(0.5, 1)
    st_k, st_p = tcarry.armed_state(cuda), tcarry.armed_state(cuda)
    lk, uk = lbp.clone(), ubp.clone()
    tk.apply_updates_slab_tiles(lk, uk, *(b.clone() for b in planes), tcarry.go_mask(st_k), slab,
                                eps, inf, outward, carry=st_k, stop=stop)
    new = tref.apply_updates_slab_ref(lbp, ubp, *best, tcarry.go_mask(st_p), slab, eps, inf,
                                      outward)
    tcarry.fold(st_p, new[2].any(), 0, 1, stop, tref.merge_progress(lbp, ubp, new[0], new[1]))
    for g, w in zip((lk, uk), new[:2]):
        _match_values(g, w)
    _match_bits(st_k, st_p)
    assert tk.form_counts() == {
        f"batched_slab_partials_tiles[{label}]": 1, f"straddle_combine_tiles[{label}]": 1,
        f"batched_slab_round_tiles[{label}]": 1, f"apply_updates_slab_tiles[{label}]": 2,
        f"apply_updates_slab_tiles[{label}+stop]": 1}


@pytest.mark.parametrize("dtype", HALF_DTYPES, ids=["bf16", "f16"])
@pytest.mark.parametrize("n", [37, 70_000])
def test_half_record_round_matches_plain_version(cuda, gen, dtype, n):
    """``record_round`` at 16 bits (the carry's measure in its field's low
    half) against its plain version: plane and carry bitwise."""
    from repro_torch.core import carry as tcarry
    from repro_torch.obs import device_plane

    lb = torch.as_tensor(gen.integers(-3, 1, n), dtype=dtype, device=cuda)
    ub = torch.as_tensor(gen.integers(1, 4, n), dtype=dtype, device=cuda)
    carry = tcarry.armed_state(cuda)
    got = device_plane(3, dtype=dtype, device=cuda)
    want = device_plane(3, dtype=dtype, device=cuda)
    scratch = torch.zeros(2, dtype=torch.int32, device=cuda)
    tk.reset_launch_counts()
    for r in range(1, 6):
        carry[tcarry.ROUNDS] = r
        carry[tcarry.FLAT] = r - 3
        tcarry.progress_view(carry, dtype).fill_(float(gen.random()))
        if r == 4:
            ub[n // 2] = lb[n // 2] - 1.0
        tk.record_round_tiles(lb, ub, carry, got, 1e-6, patience=2, scratch=scratch)
        tref.record_round_ref(lb, ub, carry, want, 1e-6, 1, 2)
        _planes_match(got, want)
    assert int(got.infeas_round) == 4 and int(got.stop_round) == 5
    label = "bf16" if dtype == torch.bfloat16 else "f16"
    assert tk.form_counts() == {f"record_round_tiles[{label}]": 5}


HALF_ENGINES = [("fused", (8, 128)), ("fused", (8, 8)), ("segment", (8, 16)),
                ("partitioned", (8, 16))]


@pytest.mark.parametrize("dtype", HALF_DTYPES, ids=["bf16", "f16"])
@pytest.mark.parametrize("gen_name,kw", [
    ("make_pseudo_boolean", dict(n=3000, m=4000, seed=7)),
    ("make_mixed", dict(m=600, n=450, seed=21)),
    ("make_banded", dict(n=3000, m=4000, row_nnz=12, band=300, seed=0)),
])
def test_half_engines_on_card_match_cpu(cuda, gen_name, kw, dtype):
    """``propagate_block_ell`` at 16 bits on every engine (128-column slabs
    for the partitioned one), both drivers, plain, early-stopped and with
    telemetry, on the card against the same run on the CPU (the plain
    versions): rounds, flags and bounds bitwise as values -- the kernels
    round as their plain versions do on any data."""
    p = getattr(td, gen_name)(**kw)
    for scatter, tile in HALF_ENGINES:
        for run in ({}, dict(stop_progress=0.05, patience=1), dict(telemetry=16)):
            for driver in ("host_loop", "device_loop"):
                args = dict(tile_rows=tile[0], tile_width=tile[1], scatter=scatter, slab=128,
                            driver=driver, dtype=dtype, **run)
                got = rt.propagate_block_ell(p, **args)
                want = rt.propagate_block_ell(p, device="cpu", **args)
                for f in ("rounds", "converged", "infeasible"):
                    assert getattr(got, f).item() == getattr(want, f).item(), (scatter, run, f)
                assert got.lb.dtype == dtype
                _match_values(got.lb, want.lb)
                _match_values(got.ub, want.ub)



# ---------------------------------------------------------------------------
# bfloat16 and float16 on the batched, node, service and sharded entry
# points (csrc/half_batch_round.cu)
# ---------------------------------------------------------------------------


def _half_same(got, want, fields=("rounds", "converged", "infeasible", "lb", "ub")):
    for f in fields:
        _match_values(torch.as_tensor(getattr(got, f)), torch.as_tensor(getattr(want, f)))


@pytest.mark.parametrize("dtype", HALF_DTYPES, ids=["bf16", "f16"])
@pytest.mark.parametrize("case", range(len(BATCHES)))
def test_half_batch_on_card_matches_cpu(cuda, case, dtype):
    """``propagate_batch`` at 16 bits (#8 + #9, or the flat A', combine and
    E + #9), plain, early-stopped (#9's stop form) and with telemetry (the
    batched record kernel), on the card against the same runs on the CPU:
    flags and bounds bitwise as values; each launching its 16-bit forms."""
    make, tile_width = BATCHES[case]
    pop = make()
    label = "bf16" if dtype == torch.bfloat16 else "f16"
    tk.reset_launch_counts()
    for run in ({}, dict(stop_progress=0.05, patience=1), dict(telemetry=16)):
        got = rt.propagate_batch(pop, tile_width=tile_width, dtype=dtype, **run)
        want = rt.propagate_batch(pop, tile_width=tile_width, dtype=dtype, device="cpu", **run)
        for g, w in zip(got, want):
            assert g.lb.dtype == dtype
            _half_same(g, w)
    forms = tk.form_counts()
    assert forms.get(f"apply_updates_batch_tiles[{label}]", 0) > 0
    assert forms.get(f"apply_updates_batch_tiles[{label}+stop]", 0) > 0
    assert forms.get(f"record_round_batch_tiles[{label}]", 0) > 0
    fused = all(int(np.diff(p.csr.row_ptr).max()) <= tile_width for p in pop)
    if fused:
        assert forms.get(f"batched_fused_scatter_round_tiles[{label}]", 0) > 0


@pytest.mark.parametrize("dtype", HALF_DTYPES, ids=["bf16", "f16"])
def test_half_batch_past_the_limit_on_card(cuda, small_limit, dtype):
    """The partitioned batch at 16 bits (#11, the straddle combine, #12, #15
    and its row-stop form) on the card against the CPU, bitwise."""
    probs = [td.make_knapsack(n=280, m=8, seed=5), td.make_set_cover(n=270, m=25, seed=6)]
    label = "bf16" if dtype == torch.bfloat16 else "f16"
    tk.reset_launch_counts()
    for run in ({}, dict(stop_progress=0.05, patience=1)):
        got = rt.propagate_batch(probs, tile_rows=2, tile_width=8, dtype=dtype, **run)
        want = rt.propagate_batch(probs, tile_rows=2, tile_width=8, dtype=dtype, device="cpu",
                                  **run)
        for g, w in zip(got, want):
            _half_same(g, w)
    forms = tk.form_counts()
    assert forms.get(f"batched_slab_round_tiles[{label}]", 0) > 0
    assert forms.get(f"apply_updates_slab_tiles[{label}+stop_rows]", 0) > 0


@pytest.mark.parametrize("dtype", HALF_DTYPES, ids=["bf16", "f16"])
@pytest.mark.parametrize("tile_width", [8, 4])
def test_half_batch_nodes_and_service_on_card_match_cpu(cuda, tile_width, dtype):
    """``propagate_nodes`` (#10, or the node-batched A', combine and E; #9)
    at 16 bits, bfloat16 on the compact ids, with the early stop and a
    float16 ``TierPolicy``, and the service through 2 slots, on the card
    against the CPU: flags and bounds bitwise as values."""
    p = td.make_pseudo_boolean(n=3000, m=4000, seed=7, unit_frac=0.002)
    lb, ub = _nodes(p, 6)
    label = "bf16c" if dtype == torch.bfloat16 else "f16"
    runs = [{}, dict(stop_progress=0.05, patience=1)]
    if dtype == torch.float16:
        runs.append(dict(policy=rt.core.TierPolicy()))
    tk.reset_launch_counts()
    for run in runs:
        got = rt.propagate_nodes(p, lb, ub, tile_width=tile_width, dtype=dtype, **run)
        want = rt.propagate_nodes(p, lb, ub, tile_width=tile_width, dtype=dtype, device="cpu",
                                  **run)
        _half_same(got, want)
    forms = tk.form_counts()
    name = ("node_fused_scatter_round_tiles" if tile_width == 8
            else "node_candidates_scatter_tiles")
    assert forms.get(f"{name}[{label}]", 0) > 0
    pop = [td.make_pseudo_boolean(n=3000, m=4000, seed=s, unit_frac=0.002) for s in (7, 8, 9)]
    svc = rt.PropagationService.from_problems(pop, slots=2, tile_width=tile_width, dtype=dtype)
    ref = rt.PropagationService.from_problems(pop, slots=2, tile_width=tile_width, dtype=dtype,
                                              device="cpu")
    for g, w in zip(svc.serve(pop), ref.serve(pop)):
        _half_same(g, w, ("rounds", "converged", "lb", "ub"))


@pytest.mark.parametrize("dtype", HALF_DTYPES, ids=["bf16", "f16"])
def test_half_batch_node_slab_kernels_match_plain_versions(cuda, dtype):
    """#13, the straddle combine over the active planes, #14 with #15 (on
    the grid at 3 rows, on the walk at 20) and #15's row-stop form at 16
    bits on a partition, against their plain versions on the card, bitwise
    as values; each launching its 16-bit form."""
    gen_name, kw, tile, slab, _ = SLAB_TIER_CASES[0]
    p = getattr(td, gen_name)(**kw)
    prep = rt.prepare_block_ell(p, *tile, dtype=dtype)
    part = prep.slab_partition(slab)
    eps, int_eps, inf, outward = rt.core.propagator.round_scalars(rt.core.DEFAULT_CONFIG, dtype)
    label = "bf16" if dtype == torch.bfloat16 else "f16"
    lbs, ubs = _nodes(p, 20)
    from repro_torch.kernels import ops

    lbp, ubp = ops._node_planes(prep, lbs, ubs)
    tk.reset_launch_counts()
    for bsz in (3, 20):
        act = torch.arange(bsz, device=cuda) % 3 != 1
        lb, ub = lbp[:bsz].contiguous(), ubp[:bsz].contiguous()
        a_args = (part.a_val, part.a_col_s, part.a_run_start, part.a_run_len, part.a_run_slab,
                  act, lb, ub, slab, part.a_max_run_len, inf)
        got_p = tk.node_slab_partials_tiles(*a_args)
        want_p = tref.node_slab_partials_ref(*a_args)
        for g, w in zip(got_p, want_p):
            _match_values(g[act], w[act])
        index = (part.a_order, part.a_seg, part.agg_slot)
        strs = tk.straddle_combine_tiles(*want_p, *index, act)
        for g, w in zip(strs, tref.straddle_combine_ref(*want_p, *index, act)):
            _match_values(g[act], w[act])
        r_args = (part.val, part.col_s, part.ii_g, part.row_done, *strs, part.lhs_g,
                  part.rhs_g, part.run_start, part.run_len, part.run_slab, act)
        tail = (slab, part.max_run_len, eps, int_eps, inf, outward)
        prog = torch.full((bsz,), 7.0, dtype=dtype, device=cuda)
        got = tk.node_slab_round_tiles(*r_args, lb.clone(), ub.clone(), *tail,
                                       acc=tk.accumulator_planes(lb, inf),
                                       tile_slab=part.tile_slab, chunk_len=part.chunk_len,
                                       progress=prog)
        want = tref.node_slab_round_ref(*r_args, lb, ub, *tail)
        for g, w in zip(got, want):
            _match_values(g, w)
        _, rows = tref.merge_rows_progress(lb, ub, want[0], want[1])
        _match_values(prog, torch.where(act, rows, 7.0))
    forms = tk.form_counts()
    for name in ("node_slab_partials_tiles", "node_slab_round_tiles", "straddle_combine_tiles"):
        assert forms.get(f"{name}[{label}]", 0) == 2, forms
    assert forms.get(f"apply_updates_slab_tiles[{label}+stop_rows]", 0) == 2


@pytest.mark.parametrize("dtype", HALF_DTYPES, ids=["bf16", "f16"])
def test_half_batch_sharded_on_one_nccl_rank(cuda, dtype):
    """The three sharded engines at 16 bits on a world of one NCCL rank
    against the CPU: the row and batch partitions bitwise the unsharded
    plain runs without widening, the nnz partition's flags equal."""
    probs = [td.make_pseudo_boolean(n=3000, m=4000, seed=7), td.make_mixed(m=600, n=450, seed=21)]
    ranks = rt.core.run_world(_half_sharded_rank, 1, backend="nccl", device="cuda",
                              args=(probs, str(dtype).removeprefix("torch.")), timeout=300)
    got = ranks[0]
    exact = dataclasses.replace(rt.core.DEFAULT_CONFIG, outward_eps_f32=0.0)
    for i, p in enumerate(probs):
        want = rt.propagate_block_ell(p, exact, dtype=dtype, use_kernels=False, device="cpu")
        _half_same(got["rows"][i], want)
        nnz = got["nnz"][i]
        assert (int(nnz.rounds), bool(nnz.infeasible)) == (int(want.rounds),
                                                           bool(want.infeasible))
    want = rt.propagate_batch(probs, exact, dtype=dtype, use_kernels=False, device="cpu")
    for g, w in zip(got["batch"], want):
        _half_same(g, w)


def _half_sharded_rank(rank, world_size, probs, dtype):
    del rank, world_size
    dt = getattr(torch, dtype)
    return dict(rows=[rt.core.propagate_sharded_rows(p, dtype=dt) for p in probs],
                nnz=[rt.core.propagate_sharded(p, dtype=dt) for p in probs],
                batch=rt.core.propagate_batch_sharded(probs, dtype=dt))
