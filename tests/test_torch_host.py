"""Host layer of the PyTorch port against the JAX reference: the port's numpy
copies of the generators and sparse layouts must give byte-identical arrays
for the same call and seed."""
import numpy as np
import pytest

import repro.core as rc
import repro.data as rd
import repro_torch.core as tc
import repro_torch.data as td

# One small call per family (the same keyword arguments go to both packages).
FAMILY_CALLS = [
    ("make_knapsack", dict(n=40, m=8, seed=3)),
    ("make_set_cover", dict(n=50, m=20, seed=4)),
    ("make_bin_packing", dict(items=12, bins=4, seed=5)),
    ("make_assignment", dict(size=6, seed=0)),
    ("make_cascade_chain", dict(length=20)),
    ("make_pseudo_boolean", dict(n=70, m=50, seed=6)),
    ("make_random_mip", dict(n=10, m=12, seed=7)),
    ("make_banded", dict(n=400, m=60, row_nnz=12, band=64, seed=8)),
    ("make_mixed", dict(m=60, n=45, seed=9)),
]

PROBLEM_FIELDS = ("lhs", "rhs", "lb", "ub", "is_int")
CSR_FIELDS = ("row_ptr", "col", "val", "n_cols")


def _same_bytes(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _assert_same_problem(pr, pt):
    for f in CSR_FIELDS:
        _same_bytes(getattr(pr.csr, f), getattr(pt.csr, f))
    for f in PROBLEM_FIELDS:
        _same_bytes(getattr(pr, f), getattr(pt, f))


def test_family_tables_match():
    assert sorted(td.FAMILIES) == sorted(rd.instances.FAMILIES)
    assert td.SIZE_SETS == rd.SIZE_SETS


@pytest.mark.parametrize("gen,kwargs", FAMILY_CALLS, ids=[g for g, _ in FAMILY_CALLS])
def test_generator_byte_equal(gen, kwargs):
    _assert_same_problem(getattr(rd, gen)(**kwargs), getattr(td, gen)(**kwargs))


@pytest.mark.parametrize("gen,kwargs", FAMILY_CALLS, ids=[g for g, _ in FAMILY_CALLS])
@pytest.mark.parametrize("tile_rows,tile_width", [(8, 128), (4, 16), (2, 4)])
def test_block_ell_byte_equal(gen, kwargs, tile_rows, tile_width):
    pr = getattr(rd, gen)(**kwargs)
    want = rc.csr_to_block_ell(pr.csr, tile_rows=tile_rows, tile_width=tile_width)
    got = tc.csr_to_block_ell(
        tc.problem_from_reference(pr).csr, tile_rows=tile_rows, tile_width=tile_width
    )
    for f in ("val", "col", "chunk_row", "m", "n"):
        _same_bytes(getattr(want, f), getattr(got, f))
    assert got.padding_fraction() == want.padding_fraction()


def test_block_ell_empty_rows_byte_equal():
    """Rows without nonzeros keep one all-padding chunk in both packages."""
    rows = np.array([0, 0, 3, 3, 3, 5])
    cols = np.array([1, 4, 0, 2, 4, 3])
    vals = np.array([1.0, -2.0, 3.0, 1.0, 1.0, 2.0])
    want = rc.csr_to_block_ell(rc.csr_from_coo(rows, cols, vals, 7, 5), 2, 2)
    got = tc.csr_to_block_ell(tc.csr_from_coo(rows, cols, vals, 7, 5), 2, 2)
    for f in ("val", "col", "chunk_row"):
        _same_bytes(getattr(want, f), getattr(got, f))


@pytest.mark.parametrize("set_name", ["Set-1", "Set-3"])
def test_instances_for_set_byte_equal(set_name):
    want = rd.instances_for_set(set_name, per_family=1)
    got = td.instances_for_set(set_name, per_family=1)
    assert [s.__dict__ for s, _ in want] == [s.__dict__ for s, _ in got]
    for (_, pr), (_, pt) in zip(want, got):
        _assert_same_problem(pr, pt)


def test_make_instance_byte_equal():
    for fam in sorted(td.FAMILIES):
        spec = dict(family=fam, m=30, n=40, seed=2)
        _assert_same_problem(
            rd.make_instance(rd.InstanceSpec(**spec)),
            td.make_instance(td.InstanceSpec(**spec)),
        )


def test_problem_from_reference_carries_state():
    pr = rd.make_mixed(m=30, n=20, seed=1)
    pt = tc.problem_from_reference(pr)
    _assert_same_problem(pr, pt)
    assert (pt.m, pt.n, pt.nnz) == (pr.m, pr.n, pr.nnz)


def test_csc_dense_and_chunk_stream_byte_equal(rng):
    a = rng.choice([0.0, 0.0, 1.0, -2.0], size=(9, 7))
    want, got = rc.csr_from_dense(a), tc.csr_from_dense(a)
    for f in CSR_FIELDS:
        _same_bytes(getattr(want, f), getattr(got, f))
    np.testing.assert_array_equal(got.to_dense(), a)
    wc, gc = rc.csr_to_csc(want), tc.csr_to_csc(got)
    for f in ("col_ptr", "row", "val", "n_rows"):
        _same_bytes(getattr(wc, f), getattr(gc, f))
    b = tc.csr_to_block_ell(got, 2, 4)
    for w, g in zip(rc.chunk_stream(b.val, b.col, b.chunk_row),
                    tc.chunk_stream(b.val, b.col, b.chunk_row)):
        _same_bytes(w, g)
    assert [tc.col_pad(n) for n in (1, 128, 129, 60_000)] == [
        rc.col_pad(n) for n in (1, 128, 129, 60_000)
    ]
