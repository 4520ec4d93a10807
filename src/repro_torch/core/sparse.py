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

Two packings serve many instances at once: :func:`pack_problems` (a bucket
of instances as ONE flat tile stream, the batched engine's input) and
:func:`pack_into_slot` (one instance to a fixed slot shape, the
continuous-batching service's admission payload).

The arrays are byte-identical to the JAX package's for the same input, so
the two packages can be held against each other on the same tiles.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

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


# ---------------------------------------------------------------------------
# Batched multi-instance packing (the serving shape)
# ---------------------------------------------------------------------------


class BatchedBlockEll(NamedTuple):
    """A bucket of instances packed as ONE flat tile stream (super-tile).

    Instances' tile streams are concatenated along the tile axis -- no
    per-instance tile padding at all, so ragged batches cost at most
    ``R - 1`` empty chunks per instance (the per-instance tail tile), never
    a stack-to-the-maximum blowup.  Per-instance offsets knit the shared
    domains together:

      * ``tile_inst[t]`` -- which instance tile ``t`` belongs to (tiles of
        one instance are contiguous);
      * ``chunk_row`` -- GLOBAL row ids: instance ``i``'s rows live at
        ``row_offset[i] + local_row``, its padding chunks at its own dummy
        row ``row_offset[i] + m_i``, so one flat segment reduction covers
        the whole batch;
      * columns stay instance-local (each instance owns one ``n_pad``-wide
        window of the ``(B, n_pad)`` bound plane; the global column id is
        ``col + tile_inst * n_pad``).

    ``val == 0`` marks padding slots, exactly as in :class:`BlockEll`.
    """

    val: np.ndarray         # (T, R, K) float; 0 == padding
    col: np.ndarray         # (T, R, K) int32 instance-local columns
    chunk_row: np.ndarray   # (T, R) int32 global row ids
    tile_inst: np.ndarray   # (T,) int32 instance of each tile
    row_offset: np.ndarray  # (B + 1,) int32; instance i owns rows
                            # [row_offset[i], row_offset[i] + m_i], the last
                            # being its dummy padding row
    m: np.ndarray           # (B,) int32 original row counts
    n: np.ndarray           # (B,) int32 original column counts

    @property
    def size(self) -> int:
        return int(self.m.shape[0])

    @property
    def num_tiles(self) -> int:
        return int(self.val.shape[0])

    @property
    def tile_rows(self) -> int:
        return int(self.val.shape[1])

    @property
    def tile_width(self) -> int:
        return int(self.val.shape[2])


class ProblemBatch(NamedTuple):
    """A bucket of propagation instances packed for one device dispatch.

    Built by :func:`pack_problems`.  Constraint sides are stacked into one
    flat ``(m_total,)`` row domain (each instance contributes its ``m_i``
    rows plus one zero dummy row addressed by its padding chunks); bounds
    live on the ``(B, n_pad)`` plane, zero-padded -- padded columns are
    never referenced by any nonzero, so they stay at their (trivially
    converged) initial values.
    """

    problems: tuple          # the original Problem objects, batch order
    indices: tuple           # position of each instance in the packed input
    ell: BatchedBlockEll     # flat tile stream
    lhs1: np.ndarray         # (m_total,) stacked sides incl. dummy rows
    rhs1: np.ndarray         # (m_total,)
    lb: np.ndarray           # (B, n_pad) initial bounds, zero-padded
    ub: np.ndarray           # (B, n_pad)
    is_int: np.ndarray       # (B, n_pad) bool, False-padded

    @property
    def size(self) -> int:
        return len(self.problems)

    @property
    def m_total(self) -> int:
        return int(self.lhs1.shape[0])

    @property
    def n_pad(self) -> int:
        return int(self.lb.shape[1])


def pack_problems(
    problems: Sequence[Problem],
    tile_rows: int = 8,
    tile_width: int = 128,
    lane: int = LANE,
    n_pad: "int | None" = None,
) -> "list[ProblemBatch]":
    """Bucket + pack instances into flat batched block-ELL super-tiles.

    Instances are bucketed by ``col_pad(n)`` only -- the lane-padded column
    width must be uniform within a bucket because every instance owns one
    ``n_pad``-wide window of the bound plane.  Within a bucket the tile
    streams concatenate exactly (no tile quantization), so one bucket is
    one dispatch shape regardless of how ragged the instance sizes are.
    Pass ``n_pad`` to force a single shared column width (one bucket for
    instances of different widths).
    """
    buckets: "dict[int, list[tuple[int, Problem, BlockEll]]]" = {}
    for idx, p in enumerate(problems):
        b = csr_to_block_ell(p.csr, tile_rows=tile_rows, tile_width=tile_width)
        width = col_pad(p.n, lane) if n_pad is None else int(n_pad)
        if width < p.n:
            raise ValueError(f"forced n_pad={width} < n={p.n}")
        buckets.setdefault(width, []).append((idx, p, b))

    out = []
    for width, members in sorted(buckets.items()):
        bsz = len(members)
        # Mixed-precision buckets promote to the widest member dtype so no
        # instance's coefficients are silently truncated by the stacking.
        dtype = np.result_type(*[b.val.dtype for _, _, b in members])
        tiles = [b for _, _, b in members]
        t_total = sum(b.num_tiles for b in tiles)
        m_total = sum(p.m + 1 for _, p, _ in members)
        val = np.zeros((t_total, tile_rows, tile_width), dtype=dtype)
        col = np.zeros((t_total, tile_rows, tile_width), dtype=np.int32)
        chunk_row = np.zeros((t_total, tile_rows), dtype=np.int32)
        tile_inst = np.zeros((t_total,), dtype=np.int32)
        row_offset = np.zeros((bsz + 1,), dtype=np.int32)
        lhs1 = np.zeros((m_total,), dtype=np.float64)
        rhs1 = np.zeros((m_total,), dtype=np.float64)
        lb = np.zeros((bsz, width), dtype=np.float64)
        ub = np.zeros((bsz, width), dtype=np.float64)
        is_int = np.zeros((bsz, width), dtype=bool)
        t0, r0 = 0, 0
        for i, (_, p, b) in enumerate(members):
            t = b.num_tiles
            val[t0 : t0 + t] = b.val
            col[t0 : t0 + t] = b.col
            # Local chunk rows -> global; padding chunks (local id m_i) land
            # on this instance's dummy row r0 + m_i.
            chunk_row[t0 : t0 + t] = b.chunk_row + r0
            tile_inst[t0 : t0 + t] = i
            row_offset[i] = r0
            lhs1[r0 : r0 + p.m] = p.lhs
            rhs1[r0 : r0 + p.m] = p.rhs
            lb[i, : p.n] = p.lb
            ub[i, : p.n] = p.ub
            is_int[i, : p.n] = p.is_int
            t0 += t
            r0 += p.m + 1
        row_offset[bsz] = r0
        out.append(
            ProblemBatch(
                problems=tuple(p for _, p, _ in members),
                indices=tuple(idx for idx, _, _ in members),
                ell=BatchedBlockEll(
                    val=val,
                    col=col,
                    chunk_row=chunk_row,
                    tile_inst=tile_inst,
                    row_offset=row_offset,
                    m=np.array([p.m for _, p, _ in members], dtype=np.int32),
                    n=np.array([p.n for _, p, _ in members], dtype=np.int32),
                ),
                lhs1=lhs1,
                rhs1=rhs1,
                lb=lb,
                ub=ub,
                is_int=is_int,
            )
        )
    return out


def batch_stats(batches: Sequence[ProblemBatch]) -> dict:
    """Packing diagnostics: bucket shapes, fill, padding overhead.

    ``per_bucket`` is the occupancy/padding histogram of each bucket's
    super-tile (one entry per bucket, same order as ``batches``): instance
    count, tile count, value slots used vs padded, and the fill fraction
    ``nnz / padded_slots`` (so "at least half full" is ``fill >= 0.5``).
    The service's stats endpoint surfaces the same histogram shape for its
    resident slot buckets (``core.service.PropagationService.stats``)."""
    total = sum(b.size for b in batches)
    slots = sum(b.ell.val.size for b in batches)
    nnz = sum(int((b.ell.val != 0).sum()) for b in batches)
    per_bucket = []
    for b in batches:
        b_slots = int(b.ell.val.size)
        b_nnz = int((b.ell.val != 0).sum())
        fill = b_nnz / b_slots if b_slots else 0.0
        per_bucket.append(
            {
                "n_pad": b.n_pad,
                "instances": b.size,
                "tiles": b.ell.num_tiles,
                "tile_rows": b.ell.tile_rows,
                "tile_width": b.ell.tile_width,
                "nnz": b_nnz,
                "padded_slots": b_slots,
                "fill": fill,
                "padding_fraction": 1.0 - fill,
            }
        )
    return {
        "instances": total,
        "buckets": len(batches),
        "bucket_shapes": [tuple(b.ell.val.shape) for b in batches],
        "bucket_sizes": [b.size for b in batches],
        "padded_slots": slots,
        "nnz": nnz,
        "padding_fraction": 1.0 - (nnz / slots if slots else 0.0),
        "per_bucket": per_bucket,
    }


# ---------------------------------------------------------------------------
# Slot-granular packing (the continuous-batching serving shape)
# ---------------------------------------------------------------------------


class SlotPayload(NamedTuple):
    """One instance packed to a FIXED slot shape, ready for device scatter.

    The continuous-batching service (``core.service``) keeps per-bucket
    super-tiles resident on device and admits instances one slot at a time:
    instead of repacking the whole batch (``pack_problems``), an arriving
    instance is converted host-side into this fixed-shape payload and
    copied into a free slot's tile/bound windows in place.  All
    row/column ids stay SLOT-LOCAL -- the admission scatter adds the slot's
    global offsets (``slot * n_pad`` columns, ``slot * (slot_rows + 1)``
    rows) on device, so one payload can be admitted into any slot of any
    bucket with matching shape.

    Conventions match :class:`BatchedBlockEll`: ``val == 0`` marks padding,
    padding chunks address the instance's own dummy row (local id ``m``),
    sides/bounds of unused rows/columns are zero-filled (trivially
    converged).  ``lhs_c``/``rhs_c`` are the per-chunk side gathers
    (``lhs1[chunk_row]``) hoisted at pack time, like ``prepare_*`` does for
    whole batches; ``ii`` is the per-nonzero integrality gather.
    """

    val: np.ndarray        # (slot_tiles, R, K) float; 0 == padding
    col: np.ndarray        # (slot_tiles, R, K) int32 slot-local columns
    chunk_row: np.ndarray  # (slot_tiles, R) int32 slot-local rows; m == dummy
    ii: np.ndarray         # (slot_tiles, R, K) int32: is_int[col], 0 at padding
    lhs_c: np.ndarray      # (slot_tiles, R) per-chunk lhs (0 at dummy rows)
    rhs_c: np.ndarray      # (slot_tiles, R) per-chunk rhs
    lb: np.ndarray         # (n_pad,) zero-padded initial bounds
    ub: np.ndarray         # (n_pad,)
    m: int                 # original row count (dummy row == m)
    n: int                 # original column count
    nnz: int               # nonzeros packed
    tiles_used: int        # leading tiles actually carrying the instance
    max_row_nnz: int       # longest row (chunk-splitting diagnostic)

    @property
    def slot_tiles(self) -> int:
        return int(self.val.shape[0])

    @property
    def n_pad(self) -> int:
        return int(self.lb.shape[0])

    def fill(self) -> float:
        """Fraction of the slot's value slots carrying real nonzeros."""
        return self.nnz / float(self.val.size) if self.val.size else 0.0


def pack_into_slot(
    p: Problem,
    slot_tiles: int,
    slot_rows: int,
    n_pad: int,
    tile_rows: int = 8,
    tile_width: int = 128,
    dtype=None,
) -> SlotPayload:
    """Pack ONE instance to a fixed slot shape (see :class:`SlotPayload`).

    The instance's block-ELL stream is laid into the leading tiles of a
    ``(slot_tiles, tile_rows, tile_width)`` window; trailing tiles stay
    all-padding (their chunks address the dummy row, so they contribute
    nothing to any round).  Raises if the instance exceeds the slot
    capacity (``tiles``, ``rows`` or ``n_pad``) -- routing instances to a
    bucket whose slots fit them is the caller's job
    (``core.service.BucketSpec.admits``)."""
    b = csr_to_block_ell(p.csr, tile_rows=tile_rows, tile_width=tile_width)
    dt = np.dtype(dtype) if dtype is not None else b.val.dtype
    if b.num_tiles > slot_tiles:
        raise ValueError(
            f"instance needs {b.num_tiles} tiles > slot capacity {slot_tiles}"
        )
    if p.m > slot_rows:
        raise ValueError(f"instance has {p.m} rows > slot capacity {slot_rows}")
    if p.n > n_pad:
        raise ValueError(f"instance has {p.n} columns > slot width {n_pad}")

    val = np.zeros((slot_tiles, tile_rows, tile_width), dtype=dt)
    col = np.zeros((slot_tiles, tile_rows, tile_width), dtype=np.int32)
    # All-padding chunks (both the packed stream's and the unused slot
    # tail's) address the instance's own dummy row m, exactly like
    # ``pack_problems`` -- so they never touch another slot's rows.
    chunk_row = np.full((slot_tiles, tile_rows), p.m, dtype=np.int32)
    t = b.num_tiles
    val[:t] = b.val
    col[:t] = b.col
    chunk_row[:t] = b.chunk_row  # local rows; padding chunks already at m

    ii = np.zeros((slot_tiles, tile_rows, tile_width), dtype=np.int32)
    ii[:t] = p.is_int[b.col].astype(np.int32)
    ii[val == 0] = 0

    # Per-chunk side gathers with the dummy row's sides pinned to 0.0 (the
    # ``pack_problems`` convention: dummy rows are trivially redundant).
    lhs1 = np.concatenate([np.asarray(p.lhs, np.float64), [0.0]])
    rhs1 = np.concatenate([np.asarray(p.rhs, np.float64), [0.0]])
    lhs_c = lhs1[chunk_row].astype(dt)
    rhs_c = rhs1[chunk_row].astype(dt)

    lb = np.zeros((n_pad,), dtype=dt)
    ub = np.zeros((n_pad,), dtype=dt)
    lb[: p.n] = p.lb
    ub[: p.n] = p.ub

    lengths = np.diff(p.csr.row_ptr)
    return SlotPayload(
        val=val,
        col=col,
        chunk_row=chunk_row,
        ii=ii,
        lhs_c=lhs_c,
        rhs_c=rhs_c,
        lb=lb,
        ub=ub,
        m=p.m,
        n=p.n,
        nnz=p.nnz,
        tiles_used=t,
        max_row_nnz=int(lengths.max()) if lengths.size else 0,
    )


def evict_slot(
    slot_tiles: int,
    slot_rows: int,
    n_pad: int,
    tile_rows: int = 8,
    tile_width: int = 128,
    dtype=np.float64,
) -> SlotPayload:
    """The all-padding payload that CLEARS a slot.

    Scattering it through the same admission op zeroes the slot's tiles and
    bounds and parks every chunk on the slot's dummy row (local id
    ``slot_rows``), leaving the slot exactly as an empty bucket initializes
    it.  Retirement itself doesn't need this -- a retired slot's stale
    tiles are gated off by the occupancy mask and simply overwritten by the
    next admission -- but explicit eviction keeps device state minimal when
    a bucket idles, and gives tests a known-empty fixture."""
    dt = np.dtype(dtype)
    shape = (slot_tiles, tile_rows, tile_width)
    return SlotPayload(
        val=np.zeros(shape, dtype=dt),
        col=np.zeros(shape, dtype=np.int32),
        chunk_row=np.full((slot_tiles, tile_rows), slot_rows, dtype=np.int32),
        ii=np.zeros(shape, dtype=np.int32),
        lhs_c=np.zeros((slot_tiles, tile_rows), dtype=dt),
        rhs_c=np.zeros((slot_tiles, tile_rows), dtype=dt),
        lb=np.zeros((n_pad,), dtype=dt),
        ub=np.zeros((n_pad,), dtype=dt),
        m=slot_rows,
        n=0,
        nnz=0,
        tiles_used=0,
        max_row_nnz=0,
    )


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
