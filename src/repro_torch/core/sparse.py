"""Sparse constraint-matrix containers (host side, numpy).

Three layouts, mirroring the paper's storage pipeline (§3):

  * :class:`CSR` -- the canonical input format.
  * :class:`CSC` -- column-major view (the sequential algorithm's marking
    mechanism, Alg. 1 line 20), built once up front.
  * :class:`BlockEll` -- length-bucketed block-ELL, the tile layout the
    propagation kernels stream.  Rows are split into chunks of at most
    ``K`` nonzeros; chunks are stacked into dense ``(num_tiles, R, K)``
    tiles.  Short rows occupy one chunk; long rows span several chunks
    whose partial sums are combined by a per-row segment reduction.
    Padding entries carry ``val == 0`` and ``col == 0``.

The arrays are byte-identical to the JAX package's for the same input, so
the two packages can be held against each other on the same tiles.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

# Column-padding quantum: padded domains are multiples of this.
LANE = 128


def col_pad(n: int, lane: int = LANE) -> int:
    """Columns padded up to a lane-width multiple (scatter accumulator size)."""
    return max(lane, -(-n // lane) * lane)


class Problem(NamedTuple):
    """A full propagation instance: ``lhs <= A x <= rhs``, ``lb <= x <= ub``."""

    csr: "CSR"
    lhs: np.ndarray       # (m,) constraint left-hand sides  (-INF if absent)
    rhs: np.ndarray       # (m,) constraint right-hand sides (+INF if absent)
    lb: np.ndarray        # (n,)
    ub: np.ndarray        # (n,)
    is_int: np.ndarray    # (n,) bool: integrality marks

    @property
    def m(self) -> int:
        return self.csr.m

    @property
    def n(self) -> int:
        return self.csr.n

    @property
    def nnz(self) -> int:
        return self.csr.nnz


class CSR(NamedTuple):
    """Compressed sparse rows: ``row_ptr`` is the ``(m+1,)`` offset array;
    ``col``/``val`` hold the ``nnz`` column ids and coefficients row-major
    with columns sorted within each row."""

    row_ptr: np.ndarray   # (m+1,) int32
    col: np.ndarray       # (nnz,) int32
    val: np.ndarray       # (nnz,) float
    n_cols: np.ndarray    # () int32

    @property
    def m(self) -> int:
        return int(self.row_ptr.shape[0]) - 1

    @property
    def n(self) -> int:
        return int(self.n_cols)

    @property
    def nnz(self) -> int:
        return int(self.col.shape[0])

    def row_ids(self) -> np.ndarray:
        """Expand row_ptr to a per-nonzero row index."""
        counts = np.diff(self.row_ptr).astype(np.int64)
        return np.repeat(np.arange(self.m, dtype=np.int32), counts)

    def to_dense(self) -> np.ndarray:
        a = np.zeros((self.m, self.n), dtype=self.val.dtype)
        a[self.row_ids(), self.col] = self.val
        return a


class CSC(NamedTuple):
    """Compressed sparse columns, built once by :func:`csr_to_csc`."""

    col_ptr: np.ndarray   # (n+1,) int32
    row: np.ndarray       # (nnz,) int32
    val: np.ndarray       # (nnz,) float
    n_rows: np.ndarray    # () int32


class BlockEll(NamedTuple):
    """Length-bucketed block-ELL (see module docstring)."""

    val: np.ndarray        # (T, R, K) float; 0 == padding
    col: np.ndarray        # (T, R, K) int32; 0 at padding slots
    chunk_row: np.ndarray  # (T, R) int32; row id of each chunk (m at padding chunks)
    m: np.ndarray          # () int32 original row count
    n: np.ndarray          # () int32 original column count

    @property
    def num_tiles(self) -> int:
        return int(self.val.shape[0])

    @property
    def tile_rows(self) -> int:
        return int(self.val.shape[1])

    @property
    def tile_width(self) -> int:
        return int(self.val.shape[2])

    def padding_fraction(self) -> float:
        return 1.0 - float((self.val != 0).sum()) / float(self.val.size)


def csr_from_dense(a: np.ndarray, dtype=np.float64) -> CSR:
    """Dense ``(m, n)`` matrix -> :class:`CSR` (zeros become structural
    zeros; columns come out sorted within each row)."""
    a = np.asarray(a, dtype=dtype)
    m, n = a.shape
    mask = a != 0
    counts = mask.sum(axis=1).astype(np.int32)
    row_ptr = np.zeros(m + 1, dtype=np.int32)
    np.cumsum(counts, out=row_ptr[1:])
    col = np.nonzero(mask)[1].astype(np.int32)
    val = a[mask].astype(dtype)
    return CSR(row_ptr=row_ptr, col=col, val=val, n_cols=np.int32(n))


def csr_from_coo(
    rows: np.ndarray, cols: np.ndarray, vals: np.ndarray, m: int, n: int
) -> CSR:
    """Coordinate triplets (any order, no duplicate handling) -> sorted
    :class:`CSR` with ``m`` rows and ``n`` columns."""
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    counts = np.bincount(rows, minlength=m).astype(np.int32)
    row_ptr = np.zeros(m + 1, dtype=np.int32)
    np.cumsum(counts, out=row_ptr[1:])
    return CSR(
        row_ptr=row_ptr,
        col=cols.astype(np.int32),
        val=np.asarray(vals),
        n_cols=np.int32(n),
    )


def csr_to_csc(csr: CSR) -> CSC:
    """:class:`CSR` -> :class:`CSC` with rows sorted within each column."""
    rid = csr.row_ids()
    order = np.lexsort((rid, csr.col))
    col_sorted = csr.col[order]
    counts = np.bincount(col_sorted, minlength=csr.n).astype(np.int32)
    col_ptr = np.zeros(csr.n + 1, dtype=np.int32)
    np.cumsum(counts, out=col_ptr[1:])
    return CSC(
        col_ptr=col_ptr,
        row=rid[order].astype(np.int32),
        val=csr.val[order],
        n_rows=np.int32(csr.m),
    )


def csr_to_block_ell(csr: CSR, tile_rows: int = 8, tile_width: int = 128) -> BlockEll:
    """Convert CSR to length-bucketed block-ELL.

    Every row is split into ``ceil(len/K)`` chunks of width ``K=tile_width``
    (an empty row keeps one all-padding chunk); chunks are packed
    ``R=tile_rows`` per tile in row order.  Vectorised: each nonzero's chunk
    is its row's first chunk plus its in-row offset divided by ``K``.
    """
    m = csr.m
    lengths = np.diff(csr.row_ptr).astype(np.int64)
    chunks_per_row = np.maximum(1, -(-lengths // tile_width))  # ceil, min 1
    total_chunks = int(chunks_per_row.sum())
    num_tiles = max(1, -(-total_chunks // tile_rows))
    padded_chunks = num_tiles * tile_rows

    val = np.zeros((padded_chunks, tile_width), dtype=csr.val.dtype)
    col = np.zeros((padded_chunks, tile_width), dtype=np.int32)
    chunk_row = np.full((padded_chunks,), m, dtype=np.int32)  # m == padding row
    chunk_row[:total_chunks] = np.repeat(np.arange(m, dtype=np.int32), chunks_per_row)

    first_chunk = np.cumsum(chunks_per_row) - chunks_per_row
    rid = np.repeat(np.arange(m, dtype=np.int64), lengths)
    offset = np.arange(csr.nnz, dtype=np.int64) - csr.row_ptr[rid].astype(np.int64)
    chunk = first_chunk[rid] + offset // tile_width
    slot = offset % tile_width
    val[chunk, slot] = csr.val
    col[chunk, slot] = csr.col

    return BlockEll(
        val=val.reshape(num_tiles, tile_rows, tile_width),
        col=col.reshape(num_tiles, tile_rows, tile_width),
        chunk_row=chunk_row.reshape(num_tiles, tile_rows),
        m=np.int32(m),
        n=np.int32(csr.n),
    )


def chunk_stream(val, col, chunk_row, tile_inst=None):
    """Flatten a ``(T, R, K)`` block-ELL tile stream into its chunk stream.

    Returns ``(cval, ccol, crow, cinst, src)``: ``(T*R, K)`` / ``(T*R,)``
    views of the stream (``cinst`` zeros when ``tile_inst`` is ``None``) and
    ``src``, which flags the chunks carrying at least one nonzero."""
    val = np.asarray(val)
    t, r, k = val.shape
    cval = val.reshape(t * r, k)
    ccol = np.asarray(col).reshape(t * r, k)
    crow = np.asarray(chunk_row).reshape(t * r)
    if tile_inst is None:
        cinst = np.zeros(t * r, dtype=np.int64)
    else:
        cinst = np.repeat(np.asarray(tile_inst, dtype=np.int64), r)
    src = (cval != 0).any(axis=1)
    return cval, ccol, crow, cinst, src


def problem_from_reference(obj) -> Problem:
    """A :class:`Problem` from any object with the same fields.

    Reads ``csr.row_ptr/col/val/n_cols``, ``lhs``, ``rhs``, ``lb``, ``ub``
    and ``is_int`` by attribute as numpy arrays, so an instance built by
    another package (for example the JAX reference) can be propagated here
    without importing that package."""
    c = obj.csr
    csr = CSR(
        row_ptr=np.asarray(c.row_ptr, dtype=np.int32),
        col=np.asarray(c.col, dtype=np.int32),
        val=np.asarray(c.val),
        n_cols=np.int32(int(np.asarray(c.n_cols))),
    )
    return Problem(
        csr=csr,
        lhs=np.asarray(obj.lhs),
        rhs=np.asarray(obj.rhs),
        lb=np.asarray(obj.lb),
        ub=np.asarray(obj.ub),
        is_int=np.asarray(obj.is_int, dtype=bool),
    )
