"""The port's MPS reader/writer against the reference's: the same text gives
byte-identical ``Problem`` arrays, the writers print the same text, and a
round trip through either package's reader reproduces the instance.  The
port's propagation of a read instance gives the reference's tightenings."""
import io

import numpy as np
import pytest

from repro.data.mps import read_mps as r_read, write_mps as r_write
import repro_torch as rt
from repro_torch.data import read_mps, write_mps

from test_mps import FIXTURE, _random_roundtrip_problem

RANGED = """\
NAME T
ROWS
 N OBJ
 L R1
 G R2
 E R3
 E R4
COLUMNS
    X  R1  1.0  R2  2.0
    X  OBJ  3.0
    Y  R3  1.0  R4  -1.0
RHS
    RHS  R1  5.0  R2  1.0
    RHS  R3  2.0  R4  4.0
    RHS  OBJ  9.0
RANGES
    RNG  R1  3.0  R2  -2.5
    RNG  R3  1.5  R4  -0.5
BOUNDS
 BV BND  X
 MI BND  Y
 UI BND  Y  7
 LI BND  Q  -2
 FX BND  X  1.0
ENDATA
"""


def _assert_same_problem(got, want):
    """Every array of the Problem equal, dtype and bytes alike."""
    pairs = [(got.csr.row_ptr, want.csr.row_ptr), (got.csr.col, want.csr.col),
             (got.csr.val, want.csr.val), (np.asarray(got.csr.n_cols), np.asarray(want.csr.n_cols)),
             (got.lhs, want.lhs), (got.rhs, want.rhs), (got.lb, want.lb), (got.ub, want.ub),
             (got.is_int, want.is_int)]
    for g, w in pairs:
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize("text", [FIXTURE, RANGED], ids=["fixture", "ranges-and-bounds"])
def test_reader_matches_reference(text):
    _assert_same_problem(read_mps(io.StringIO(text)), r_read(io.StringIO(text)))


def test_fixture_propagates_as_the_reference():
    p = read_mps(io.StringIO(FIXTURE))
    r = rt.propagate_block_ell(p, device="cpu")
    np.testing.assert_array_equal(r.ub.numpy(), [1.0, 2.0, 6.0])
    np.testing.assert_array_equal(r.lb.numpy(), [0.0, 1.0, 2.0])


@pytest.mark.parametrize("seed", range(6))
def test_round_trip_matches_reference(seed):
    pr = _random_roundtrip_problem(seed)
    pt = rt.problem_from_reference(pr)
    mine, theirs = io.StringIO(), io.StringIO()
    write_mps(pt, mine)
    r_write(pr, theirs)
    assert mine.getvalue() == theirs.getvalue()
    back = read_mps(io.StringIO(mine.getvalue()))
    _assert_same_problem(back, r_read(io.StringIO(mine.getvalue())))
    assert (back.m, back.n, back.nnz) == (pt.m, pt.n, pt.nnz)
    np.testing.assert_array_equal(back.csr.to_dense(), pt.csr.to_dense())
    np.testing.assert_array_equal(back.lb, pt.lb)
    np.testing.assert_array_equal(back.ub, pt.ub)
    np.testing.assert_array_equal(back.is_int, pt.is_int)
    np.testing.assert_array_equal(back.rhs, pt.rhs)
    np.testing.assert_allclose(back.lhs, pt.lhs, rtol=1e-15, atol=1e-12)


def test_round_trip_of_a_generated_instance_keeps_its_limit_point():
    p = rt.data.make_mixed(m=40, n=30, seed=3)
    buf = io.StringIO()
    write_mps(p, buf, name="MIXED")
    assert buf.getvalue().startswith("NAME          MIXED\n")
    p2 = read_mps(io.StringIO(buf.getvalue()))
    want = r_read(io.StringIO(buf.getvalue()))
    _assert_same_problem(p2, want)
    a = rt.propagate_block_ell(p, device="cpu")
    b = rt.propagate_block_ell(p2, device="cpu")
    assert rt.bounds_equal(a.lb, a.ub, b.lb, b.ub)
