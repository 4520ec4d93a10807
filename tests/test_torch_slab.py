"""The port's column-slab partition (``repro_torch.kernels.slab``) against the
reference's ``build_slab_partition``: byte for byte on every field the port
keeps, on the instances of the reference's own partition tests, a batched
stream, and an instance past 2^16 columns; the balanced slab width; the
cache per slab width; and the port's straddle-combine index.

Contract: every array identical in dtype, shape and bytes; every layout
integer equal.  The reference's ``col_slots`` (its jnp oracle's reduction
schedule) has no counterpart in the port.
"""
import numpy as np
import pytest
import torch

import repro.data as rd
from repro.kernels import ops as rops
import repro_torch as rt
from repro_torch.kernels import ops as tops
from repro_torch.kernels import slab as tslab

ARRAYS = ("val", "col_s", "chunk_row", "tile_inst", "tile_slab", "ii_g", "lhs_g", "rhs_g",
          "row_done", "agg_slot", "run_start", "run_len", "run_inst", "run_slab", "a_val",
          "a_col_s", "a_slot", "a_tile_inst", "a_tile_slab", "a_run_start", "a_run_len",
          "a_run_inst", "a_run_slab")
INTS = ("slab", "n_slabs", "n_pad_part", "batch", "n_straddle", "max_run_len", "a_max_run_len",
        "source_tiles", "source_chunks", "num_chunk_copies")


def assert_same_partition(got, want):
    for f in ARRAYS:
        w = np.asarray(getattr(want, f))
        g = getattr(got, f).cpu().numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, (f, g.dtype, w.dtype, g.shape, w.shape)
        assert g.tobytes() == w.tobytes(), f
    for f in INTS:
        assert getattr(got, f) == getattr(want, f), f
    assert got.has_straddle == want.has_straddle
    assert got.num_copies == want.num_copies
    assert got.duplication == want.duplication


def _both(gen, kw, tile):
    pr = getattr(rd, gen)(**kw)
    want = rops.prepare_block_ell(pr, *tile)
    got = rt.prepare_block_ell(rt.problem_from_reference(pr), *tile, device="cpu")
    assert got.n_pad == want.n_pad
    return pr, got, want


CASES = {
    # name: (generator, kwargs, (tile_rows, tile_width))
    "mixed": ("make_mixed", dict(m=40, n=300, seed=11), (4, 32)),
    # Dense rows at tile width 8: rows straddle every slab boundary and
    # span chunks.
    "knapsack": ("make_knapsack", dict(n=280, m=8, seed=5), (2, 8)),
}


@pytest.mark.parametrize("slab_w", [128, 256])
@pytest.mark.parametrize("name", list(CASES))
def test_partition_is_byte_identical(name, slab_w):
    _, got, want = _both(*CASES[name])
    part = got.slab_partition(slab_w)
    assert_same_partition(part, want.slab_partition(slab_w))
    assert part.has_straddle
    # Every nonzero lands in exactly one copy, inside its window.
    val = part.val.numpy()
    col = part.col_s.numpy()
    assert int((val != 0).sum()) == int((got.d.val.numpy() != 0).sum())
    assert col.min() >= 0 and col[val != 0].max() < slab_w


def test_partition_past_two_to_the_sixteen_columns():
    n = tslab.SCATTER_MAX_NPAD + 200
    _, got, want = _both("make_banded", dict(n=n, m=48, row_nnz=6, band=512, seed=0), (8, 8))
    assert got.n_pad > tslab.SCATTER_MAX_NPAD
    part = got.slab_partition()
    assert part.n_slabs == 2 and part.slab == tslab.default_slab_width(got.n_pad)
    assert_same_partition(part, want.slab_partition())


def test_batched_partition_is_byte_identical():
    """A stream of three instances (run_inst routes copies to their own
    plane rows), built from the reference's packed batch arrays."""
    problems = [rd.make_mixed(m=25, n=260, seed=s) for s in range(3)]
    (batch,) = rops.packed_problems(problems, 4, 32)
    prep = rops.prepare_problem_batch(batch)
    want = prep.slab_partition(128)
    ell = batch.ell
    got = tslab.build_slab_partition(
        np.asarray(ell.val), ell.col, ell.chunk_row, ell.tile_inst, batch.lhs1, batch.rhs1,
        batch.is_int, prep.n_pad, 128, (ell.row_offset[1:] - 1).astype(np.int32),
    )
    assert got.batch == 3
    assert_same_partition(got, want)


def test_default_slab_width_matches_reference():
    for n_pad in [128, 4096, 1 << 15, (1 << 16) - 128, 1 << 16, (1 << 16) + 128,
                  (1 << 16) + 4096, 150_016, 3 * (1 << 16), 3 * (1 << 16) + 128, 1_000_064]:
        assert tslab.default_slab_width(n_pad) == rops.default_slab_width(n_pad), n_pad
        for cap in (128, 1024, 50_048):
            assert tslab.default_slab_width(n_pad, cap) == rops.default_slab_width(n_pad, cap)


def test_slab_cap_is_read_at_call_time(monkeypatch):
    _, got, _ = _both("make_mixed", dict(m=20, n=200, seed=3), (4, 32))
    assert got.slab_partition().n_slabs == 1
    monkeypatch.setattr(tops, "SLAB_NPAD", 128)
    assert got.slab_partition().slab == 128


def test_partition_is_cached_per_slab_width():
    pr, got, _ = _both("make_mixed", dict(m=20, n=200, seed=3), (4, 32))
    a = got.slab_partition(128)
    assert got.slab_partition(128) is a
    b = got.slab_partition(256)
    assert b is not a and b.n_slabs != a.n_slabs
    # A bounds-swapped view of the prep shares the partitions.
    p = rt.problem_from_reference(pr)
    base = rt.prepare_block_ell(p, 4, 32, device="cpu")
    view = rt.prepare_block_ell(p._replace(lb=p.lb - 1.0, ub=p.ub + 1.0), 4, 32, device="cpu")
    assert view is not base and view.d.val is base.d.val
    assert view.slab_partition(128) is base.slab_partition(128)


@pytest.mark.parametrize("name", list(CASES))
def test_straddle_combine_index(name):
    """``a_order`` takes each slot's partials in ascending sub-stream
    position, ``a_seg`` starts each slot and ``agg_pos`` points every
    split-row copy of the main stream at its slot's first partial."""
    _, got, _ = _both(*CASES[name])
    part = got.slab_partition(128)
    slot = part.a_slot.numpy().reshape(-1)
    order, seg, pos = part.a_order.numpy(), part.a_seg.numpy(), part.agg_pos.numpy()
    assert seg.shape == (part.n_straddle + 2,) and seg[-1] == slot.size
    for s in range(part.n_straddle + 1):
        run = order[seg[s]:seg[s + 1]]
        assert (slot[run] == s).all() and (np.diff(run) > 0).all()
    agg = part.agg_slot.numpy()
    done = part.row_done.numpy() != 0
    assert (agg[~done] > 0).all()
    np.testing.assert_array_equal(pos[~done], seg[agg[~done]])
    assert (pos[done] == 0).all()
    assert part.a_order.dtype == torch.int64 and part.agg_pos.shape == part.agg_slot.shape
