"""What kernels #13 (node slab partials) and #15 (the window merge) rely on
since they run on the active-only walk, checked on the CPU:

- the partition's hoisted straddle chunk lengths ``a_chunk_len`` /
  ``a_max_chunk_len``, where #13 stops each copy, against the chunk lengths
  of the reference's own straddle sub-stream (byte-identical ``a_val``,
  ``test_torch_slab.py``), on that file's partition cases at slab widths 128
  and 256 and on a batched stream; and the tile slabs #13's wrapper derives
  from the run maps when it is given none, against the partition's;
- #13's sums at the lane group it is launched with (keyed on the longest
  straddle copy, so copies of at most 16 slots share a warp): a numpy
  emulation of the kernel's lane order against ``ref.node_slab_partials_ref``;
- #15's window flags as the merge walk stores them (one per warp and column
  stride, columns ``j0 + v * kThreads + lane``): a numpy emulation over
  ragged widths against ``ref.apply_updates_slab_ref`` and the reference's
  Pallas merge, and its failure for a slab that is not a multiple of 32.

Tolerances: exact everywhere -- lengths and flags are integers, and the
emulated sums take the kernel's order, which is the plain version's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.data as rd
from repro.kernels import ops as rops
from repro.kernels import prop_round as rkern
import repro_torch as rt
import repro_torch.data as td
from repro_torch.core import INF
from repro_torch.core import bounds as tbnd
from repro_torch.kernels import ref as tref
from repro_torch.kernels import slab as tslab

WARP, THREADS, MERGE_COLS = 32, 256, 4  # round_common.cuh: kWarp, kThreads, kMergeCols
EPS = 1e-9

CASES = {
    # name: (generator, kwargs, (tile_rows, tile_width)) -- test_torch_slab.py's
    "mixed": ("make_mixed", dict(m=40, n=300, seed=11), (4, 32)),
    "knapsack": ("make_knapsack", dict(n=280, m=8, seed=5), (2, 8)),
}


def _both(name, slab_w):
    gen, kw, tile = CASES[name]
    pr = getattr(rd, gen)(**kw)
    want = rops.prepare_block_ell(pr, *tile).slab_partition(slab_w)
    got = rt.prepare_block_ell(rt.problem_from_reference(pr), *tile, device="cpu")
    return want, got.slab_partition(slab_w)


def _lengths(val):
    """One past the last nonzero slot of each chunk, in numpy."""
    val = np.asarray(val)
    k = val.shape[-1]
    return np.where(val != 0, np.arange(1, k + 1), 0).max(axis=-1, initial=0).astype(np.int32)


def _batched():
    problems = [rd.make_mixed(m=25, n=260, seed=s) for s in range(3)]
    (batch,) = rops.packed_problems(problems, 4, 32)
    prep = rops.prepare_problem_batch(batch)
    ell = batch.ell
    got = tslab.build_slab_partition(
        np.asarray(ell.val), ell.col, ell.chunk_row, ell.tile_inst, batch.lhs1, batch.rhs1,
        batch.is_int, prep.n_pad, 128, (ell.row_offset[1:] - 1).astype(np.int32),
    )
    return prep.slab_partition(128), got


def _assert_hoisted(want, part):
    lengths = _lengths(want.a_val)
    assert part.a_chunk_len.dtype == torch.int32
    np.testing.assert_array_equal(part.a_chunk_len.numpy(), lengths)
    np.testing.assert_array_equal(part.a_chunk_len.numpy(),
                                  tref.chunk_lengths(part.a_val).numpy())
    assert part.a_max_chunk_len == int(lengths.max(initial=0))
    assert part.a_max_chunk_len == int(part.a_chunk_len.max())
    # The main stream's pair, as before, and the tile slabs #13's wrapper
    # derives from the run maps when it is given none.
    np.testing.assert_array_equal(part.chunk_len.numpy(), _lengths(want.val))
    assert part.max_chunk_len == int(_lengths(want.val).max())
    derived = torch.repeat_interleave(part.a_run_slab, part.a_run_len).to(torch.int32)
    assert torch.equal(derived, part.a_tile_slab)


@pytest.mark.parametrize("slab_w", [128, 256])
@pytest.mark.parametrize("name", list(CASES))
def test_straddle_chunk_lengths_are_hoisted(name, slab_w):
    want, part = _both(name, slab_w)
    assert part.has_straddle
    _assert_hoisted(want, part)


def test_straddle_chunk_lengths_of_a_batched_stream():
    want, part = _batched()
    assert part.batch == 3 and part.has_straddle
    _assert_hoisted(want, part)


def test_straddle_chunk_lengths_without_straddle_rows():
    """A partition whose rows all fit their slab has an empty sub-stream:
    no lengths and a longest copy of 0."""
    p = td.make_banded(n=256, m=30, row_nnz=3, band=20, seed=0)
    part = rt.prepare_block_ell(p, 2, 8, device="cpu").slab_partition(256)
    assert not part.has_straddle
    assert part.a_chunk_len.shape == (0, 2) and part.a_max_chunk_len == 0


# ---------------------------------------------------------------------------
# #13: the sums at the launched lane group
# ---------------------------------------------------------------------------


def _group_width(k):
    g = 1
    while g < k and g < WARP:
        g *= 2
    return g


def _lane_sum(x, g):
    """A chunk's sum as #13's group of ``g`` lanes takes it: lane ``l < g``
    adds slots l, l + 32, ... from +0.0, then xor shuffles with offsets g/2,
    ..., 1 over the group (slots that lane order leaves out must be 0)."""
    lanes = [0.0] * g
    for j, v in enumerate(x):
        if v != 0.0:
            assert j % WARP < g
            lanes[j % WARP] = lanes[j % WARP] + v
    off = g // 2
    while off:
        lanes = [lanes[i] + lanes[i ^ off] for i in range(g)]
        off //= 2
    return lanes[0]


def _emulated_partials(part, lb, ub, active):
    """#13's output on the active planes, emulated in numpy."""
    val, col = part.a_val.numpy(), part.a_col_s.numpy()
    ta, r, k = val.shape
    g = _group_width(min(part.a_max_chunk_len, k))
    tile_slab = part.a_tile_slab.numpy()
    out = [np.zeros((lb.shape[0], ta, r), d) for d in (np.float64, np.int32) * 2]
    for b in np.flatnonzero(active):
        for t in range(ta):
            off = int(tile_slab[t]) * part.slab
            for i in range(r):
                v = val[t, i]
                lo, hi = lb[b, off + col[t, i]], ub[b, off + col[t, i]]
                bmin, bmax = np.where(v > 0, lo, hi), np.where(v > 0, hi, lo)
                nz = v != 0
                min_inf, max_inf = nz & (np.abs(bmin) >= INF), nz & (np.abs(bmax) >= INF)
                out[0][b, t, i] = _lane_sum(np.where(nz & ~min_inf, v * bmin, 0.0), g)
                out[1][b, t, i] = min_inf.sum()
                out[2][b, t, i] = _lane_sum(np.where(nz & ~max_inf, v * bmax, 0.0), g)
                out[3][b, t, i] = max_inf.sum()
    return out


PARTIAL_CASES = [
    # (generator, kwargs, (tile_rows, tile_width), slab, longest straddle copy)
    ("make_knapsack", dict(n=280, m=8, seed=5), (2, 8), 128, 8),
    ("make_mixed", dict(m=40, n=300, seed=11), (4, 32), 128, 32),
    # K = 128 with copies of at most 12 and 6 slots: 16 and 8 lanes a copy.
    ("make_banded", dict(n=3000, m=400, row_nnz=12, band=600, seed=1), (8, 128), 256, 12),
    ("make_banded", dict(n=3000, m=400, row_nnz=6, band=600, seed=1), (8, 128), 128, 6),
]


@pytest.mark.parametrize("gen,kw,tile,slab_w,longest", PARTIAL_CASES)
def test_packed_partials_take_the_plain_order(gen, kw, tile, slab_w, longest):
    """General-float bounds over three node planes, two active: #13's lane
    order at the group of the longest straddle copy gives
    ``ref.node_slab_partials_ref`` bit for bit."""
    p = getattr(td, gen)(**kw)
    part = rt.prepare_block_ell(p, *tile, device="cpu").slab_partition(slab_w)
    assert part.a_max_chunk_len == longest
    rng = np.random.default_rng(longest)
    width = part.n_pad_part
    lb = rng.uniform(-5, 0, size=(3, width)) * 10.0 ** rng.integers(-6, 7, size=(3, width))
    ub = rng.uniform(0, 5, size=(3, width)) * 10.0 ** rng.integers(-6, 7, size=(3, width))
    lb[rng.random(lb.shape) < 0.1] = -INF
    ub[rng.random(ub.shape) < 0.1] = INF
    active = np.array([True, False, True])
    want = tref.node_slab_partials_ref(
        part.a_val, part.a_col_s, part.a_run_start, part.a_run_len, part.a_run_slab,
        torch.from_numpy(active), torch.from_numpy(lb), torch.from_numpy(ub), part.slab,
        part.a_max_run_len,
    )
    for g, w in zip(_emulated_partials(part, lb, ub, active), want):
        np.testing.assert_array_equal(g[active], w.numpy()[active])


# ---------------------------------------------------------------------------
# #15: the window flags of the merge walk
# ---------------------------------------------------------------------------


def _walk_window_flags(take, active, slab):
    """#15's ``(B, n_slabs)`` flags as the merge walk stores them: per
    active row, per item of ``THREADS * MERGE_COLS`` columns, per warp and
    column stride ``v``, the 32 columns ``w0 + lane`` (``w0 = j0 + v *
    THREADS + 32 * warp``); if any of them tightened, the warp's lane 0
    flags window ``w0 // slab``."""
    bsz, width = take.shape
    flags = np.zeros((bsz, -(-width // slab)), np.int32)
    for b in np.flatnonzero(active):
        for j0 in range(0, width, THREADS * MERGE_COLS):
            for warp in range(THREADS // WARP):
                for v in range(MERGE_COLS):
                    w0 = j0 + v * THREADS + warp * WARP
                    if take[b, w0 : min(w0 + WARP, width)].any():
                        flags[b, w0 // slab] = 1
    return flags


def _merge_inputs(rng, bsz, width):
    lb = rng.uniform(-5, 0, size=(bsz, width))
    ub = rng.uniform(0, 5, size=(bsz, width))
    bl, bu = lb.copy(), ub.copy()
    # Sparse tightenings, so that most windows stay unflagged.
    for x, d in ((bl, 1.0), (bu, -1.0)):
        hit = rng.random(x.shape) < 0.004
        x[hit] += d
    return lb, ub, bl, bu


@pytest.mark.parametrize("slab_w", [128, 256])
@pytest.mark.parametrize("width", [1000, 2500, 4096 + 256])
def test_walk_window_flags_match_plain_version(slab_w, width):
    """Widths with a partial column block, two of them also with a partial
    window: the walk's per-warp flags are the plain version's and, OR-ed per
    row, the reference's Pallas merge's where it takes the width (whole
    windows)."""
    rng = np.random.default_rng(width + slab_w)
    bsz = 4
    lb, ub, bl, bu = _merge_inputs(rng, bsz, width)
    active = np.array([True, False, True, True])
    t = lambda x: torch.from_numpy(x)
    take = (tbnd.improved_lb(t(bl), t(lb), EPS) | tbnd.improved_ub(t(bu), t(ub), EPS)).numpy()
    got = _walk_window_flags(take, active, slab_w)
    _, _, want = tref.apply_updates_slab_ref(t(lb), t(ub), t(bl), t(bu), t(active), slab_w, EPS)
    assert want.numpy().any() and not want.numpy().all()
    np.testing.assert_array_equal(got, want.numpy())
    if width % slab_w:
        return
    ref = rkern.apply_updates_slab_tiles(
        jnp.asarray(lb), jnp.asarray(ub), jnp.asarray(bl), jnp.asarray(bu), jnp.asarray(active),
        slab=slab_w, eps=EPS, interpret=True,
    )
    np.testing.assert_array_equal(got.any(axis=1), np.asarray(ref[2]))


@pytest.mark.parametrize("slab_w,whole", [(96, True), (160, True), (48, False), (100, False)])
def test_walk_window_flags_need_slabs_of_whole_warps(slab_w, whole):
    """A slab that is a multiple of 32 keeps every warp's columns in one
    window.  Otherwise a warp straddles two windows, and a tightening past
    the boundary alone flags the wrong one: one tightened column at the
    start of each window but the first shows it."""
    width = 1024
    lb = np.zeros((1, width))
    ub = np.ones((1, width))
    bl, bu = lb.copy(), ub.copy()
    bl[0, slab_w:width:slab_w] = 0.5
    t = lambda x: torch.from_numpy(x)
    take = (tbnd.improved_lb(t(bl), t(lb), EPS) | tbnd.improved_ub(t(bu), t(ub), EPS)).numpy()
    active = np.array([True])
    got = _walk_window_flags(take, active, slab_w)
    _, _, want = tref.apply_updates_slab_ref(t(lb), t(ub), t(bl), t(bu), t(active), slab_w, EPS)
    assert want.numpy()[0, 0] == 0 and want.numpy()[0, 1:].all()
    assert np.array_equal(got, want.numpy()) == whole
