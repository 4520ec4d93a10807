"""Column-slab partitioning: the block-ELL tile stream re-bucketed per
column window, for the partitioned engine (instances past
:data:`SCATTER_MAX_NPAD` columns under ``scatter="auto"``).

Host-side numpy, built once per prepared instance and slab width.  The
arrays are byte-identical to the JAX package's ``build_slab_partition`` for
the same tiles, tile shape and slab width.  Two things of the reference's
builder are left out: the rectangle-gather schedule ``col_slots`` and
``_rect_gather_schedule``, which serve only the reference's jnp oracle (the
port's plain column reduction is a ``scatter_reduce`` ``amax``/``amin``,
which does not depend on order).  One thing is added: the index of the
straddle combine (``a_order``, ``a_seg``, ``agg_pos``), which sums each
straddle row's copy partials left to right in sub-stream order, the same
order on every device; and the chunk lengths of the main stream
(``chunk_len``), where kernels #12 and #14 stop each copy, and of the
straddle sub-stream (``a_chunk_len``), where #13 stops each copy.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.sparse import LANE, chunk_stream
from .ref import chunk_lengths

# Largest padded column count that ``scatter="auto"`` sends to the fused
# engine; beyond it the partitioned engine runs.  The JAX package's VMEM
# budget (two (n_pad,) f64 accumulators in 1 MiB), kept so that both
# packages pick the same engine.  Nothing on the H100 limits the fused
# engine's width: an explicit ``scatter="fused"`` runs at any n_pad.
SCATTER_MAX_NPAD = 1 << 16

# Cap on the partitioned engine's slab width (the reference's: one slab
# holds what the fused engine holds at its cap).
SLAB_NPAD = SCATTER_MAX_NPAD


def default_slab_width(n_pad: int, cap: int | None = None) -> int:
    """Balanced column-slab width for a padded domain: the fewest slabs
    whose width stays within ``cap`` (default :data:`SLAB_NPAD`, read at
    call time), each width a LANE multiple, so ``n_pad_part - n_pad < LANE *
    n_slabs``."""
    cap = SLAB_NPAD if cap is None else int(cap)
    n_slabs = max(1, -(-n_pad // cap))
    return -(-n_pad // (n_slabs * LANE)) * LANE


class SlabPartition(NamedTuple):
    """A block-ELL stream re-bucketed by column slabs at CHUNK granularity
    (the layout of the reference's ``SlabPartition``, as tensors on one
    device).

    The padded column space is split into ``n_slabs`` windows of ``slab``
    columns.  Each nonzero-carrying chunk becomes one COPY per slab its
    nonzeros touch, keeping only the in-slab nonzeros (``val == 0``
    elsewhere) with slab-LOCAL columns.  The main stream packs the copies
    into ``(T'', R, K)`` tiles grouped by ``(instance, slab)`` window, each
    group padded to whole tiles with dummy-row chunks; run ``r`` covers
    copy tiles ``run_start[r] : run_start[r] + run_len[r]`` of window
    ``(run_inst[r], run_slab[r])``, every window has exactly one run (an
    empty window gets one all-padding tile), and runs lie in window order.

    A row whose nonzeros are split across copies is a STRADDLE row: its
    aggregate cannot complete inside one copy.  The sub-stream ``a_*``
    repacks those rows' copies; the engine computes per-copy partials over
    it and sums them per table slot ``a_slot`` (slot 0 is a dummy) into
    completed aggregates, which the round reads where ``row_done == 0``.

    The straddle combine's index (the port's addition): ``a_order`` is the
    stable argsort of the flattened ``a_slot``, so each slot's partials lie
    next to each other in ascending sub-stream position; ``a_seg`` holds
    each slot's first position in that order (``n_straddle + 2`` entries);
    ``agg_pos`` is, per main-stream chunk, the position of its slot's first
    partial (0 where ``row_done == 1``).  ``chunk_len`` and ``a_chunk_len``
    (also the port's) are :func:`ref.chunk_lengths` of the main stream and
    of the sub-stream, ``max_chunk_len`` and ``a_max_chunk_len`` their
    largest entries: a copy keeps only its slab's nonzeros, so its chunks
    are padded more than the source's."""

    # Main stream: every chunk copy, (instance, slab)-grouped and padded.
    val: torch.Tensor        # (T'', R, K) slab-masked copies; 0 == padding
    col_s: torch.Tensor      # (T'', R, K) int32 slab-LOCAL columns
    chunk_row: torch.Tensor  # (T'', R) int32 rows
    tile_inst: torch.Tensor  # (T'',) int32 instance of each copy tile
    tile_slab: torch.Tensor  # (T'',) int32 slab of each copy tile
    ii_g: torch.Tensor       # (T'', R, K) int32 is_int at each kept nonzero
    lhs_g: torch.Tensor      # (T'', R) sides gathered per chunk row
    rhs_g: torch.Tensor      # (T'', R)
    row_done: torch.Tensor   # (T'', R) int32: 1 iff copy holds its whole row
    agg_slot: torch.Tensor   # (T'', R) int32 straddle-table slot (0 = dummy)
    chunk_len: torch.Tensor  # (T'', R) int32 one past each copy's last kept nonzero (#12)
    run_start: torch.Tensor  # (B*n_slabs,) int32 first copy tile of each run
    run_len: torch.Tensor    # (B*n_slabs,) int32 copy tiles per run (>= 1)
    run_inst: torch.Tensor   # (B*n_slabs,) int32 window instance per run
    run_slab: torch.Tensor   # (B*n_slabs,) int32 window slab per run
    # Straddle sub-stream (empty when nothing straddles).
    a_val: torch.Tensor        # (Ta, R, K)
    a_col_s: torch.Tensor      # (Ta, R, K) int32 slab-local
    a_slot: torch.Tensor       # (Ta, R) int32 straddle-table slot (0 = dummy)
    a_tile_inst: torch.Tensor  # (Ta,) int32
    a_tile_slab: torch.Tensor  # (Ta,) int32
    a_run_start: torch.Tensor  # (n_aruns,) int32
    a_run_len: torch.Tensor    # (n_aruns,) int32
    a_run_inst: torch.Tensor   # (n_aruns,) int32
    a_run_slab: torch.Tensor   # (n_aruns,) int32
    a_chunk_len: torch.Tensor  # (Ta, R) int32 one past each copy's last nonzero (#13)
    # The straddle combine's index.
    a_order: torch.Tensor    # (Ta*R,) int64 stable argsort of a_slot
    a_seg: torch.Tensor      # (n_straddle + 2,) int64 each slot's first position
    agg_pos: torch.Tensor    # (T'', R) int64 first position of each chunk's slot
    # Static layout facts.
    slab: int               # S: columns per slab (multiple of LANE)
    n_slabs: int            # windows per instance
    n_pad_part: int         # n_slabs * slab >= n_pad
    batch: int              # B: instances sharing the stream
    n_straddle: int         # straddle rows (table has n_straddle + 1 slots)
    max_run_len: int        # max(run_len)
    max_chunk_len: int      # max(chunk_len): the strides #12 and #14 hold per lane
    a_max_run_len: int      # max(a_run_len), 0 when no straddle copies
    a_max_chunk_len: int    # max(a_chunk_len), 0 when no straddle copies: #13's lanes per copy
    source_tiles: int       # T of the unpartitioned stream
    source_chunks: int      # nonzero-carrying chunks of the source stream
    num_chunk_copies: int   # chunk copies before window padding

    @property
    def num_copies(self) -> int:
        """Main-stream copy tiles (T'')."""
        return int(self.val.shape[0])

    @property
    def has_straddle(self) -> bool:
        """True iff any row's nonzeros are split across copies."""
        return int(self.a_val.shape[0]) > 0

    @property
    def duplication(self) -> float:
        """Chunk-copy blowup vs the source chunks (1.0 == no straddling)."""
        return self.num_chunk_copies / max(1, self.source_chunks)


def _pack_copy_windows(
    sel, cp_inst, cp_slab, cp_val, cp_col, cp_ii, cp_row, cp_done, cp_slot,
    bsz, n_slabs, r, k, dummy_rows, cover,
):
    """Pack the selected chunk copies into per-``(instance, slab)`` window
    groups of whole ``(R, K)`` tiles, plus the run maps describing each
    group.  ``cover=True`` materializes one all-padding tile for windows
    with no copies (the main stream); ``cover=False`` keeps only populated
    windows (the straddle sub-stream).  Window-padding rows are dummy-row
    chunks: ``val == 0`` everywhere, ``done = 1``, ``slot = 0``."""
    idx = np.flatnonzero(sel)
    inst_g = cp_inst[idx]
    slab_g = cp_slab[idx]
    order = np.lexsort((idx, slab_g, inst_g))  # stable: stream order in-window
    idx, inst_g, slab_g = idx[order], inst_g[order], slab_g[order]
    win = inst_g * n_slabs + slab_g

    if cover:
        win_ids = np.arange(bsz * n_slabs, dtype=np.int64)
        counts = np.bincount(win, minlength=bsz * n_slabs)
        rows_per_win = np.maximum(-(-counts // r), 1) * r
    else:
        win_ids, counts = np.unique(win, return_counts=True)
        rows_per_win = -(-counts // r) * r
    n_runs = int(win_ids.size)
    offs = np.zeros(n_runs + 1, dtype=np.int64)
    np.cumsum(rows_per_win, out=offs[1:])
    total_rows = int(offs[-1])
    n_tiles = total_rows // r

    if idx.size:
        uw, uc = np.unique(win, return_counts=True)
        starts = np.concatenate([[0], np.cumsum(uc)[:-1]])
        rank = np.arange(win.size) - np.repeat(starts, uc)
        pos = win if cover else np.searchsorted(win_ids, win)
        dst = offs[pos] + rank
    else:
        dst = np.zeros(0, dtype=np.int64)

    row_win = np.repeat(win_ids, rows_per_win)
    w_inst = (row_win // n_slabs).astype(np.int64)
    p_val = np.zeros((total_rows, k), cp_val.dtype)
    p_col = np.zeros((total_rows, k), np.int32)
    p_ii = np.zeros((total_rows, k), bool)
    p_row = dummy_rows[w_inst].astype(np.int32)
    p_done = np.ones(total_rows, dtype=np.int32)
    p_slot = np.zeros(total_rows, dtype=np.int64)
    p_val[dst] = cp_val[idx]
    p_col[dst] = cp_col[idx]
    p_ii[dst] = cp_ii[idx]
    p_row[dst] = cp_row[idx]
    p_done[dst] = cp_done[idx]
    p_slot[dst] = cp_slot[idx]

    run_len = (rows_per_win // r).astype(np.int32)
    run_start = (offs[:-1] // r).astype(np.int32)
    run_inst = (win_ids // n_slabs).astype(np.int32)
    run_slab = (win_ids % n_slabs).astype(np.int32)
    tiles = {
        "val": p_val.reshape(n_tiles, r, k),
        "col": p_col.reshape(n_tiles, r, k),
        "ii": p_ii.reshape(n_tiles, r, k),
        "row": p_row.reshape(n_tiles, r),
        "done": p_done.reshape(n_tiles, r),
        "slot": p_slot.reshape(n_tiles, r).astype(np.int32),
        "tile_inst": np.repeat(run_inst, run_len),
        "tile_slab": np.repeat(run_slab, run_len),
    }
    return tiles, run_start, run_len, run_inst, run_slab


def _longest_chunk(val: np.ndarray) -> int:
    """The largest :func:`ref.chunk_lengths` entry of ``(T, R, K)`` tiles
    (0 for none)."""
    k = val.shape[-1]
    return int(np.where(val != 0, np.arange(1, k + 1), 0).max(initial=0))


def straddle_combine_index(a_slot: np.ndarray, agg_slot: np.ndarray, n_straddle: int):
    """The straddle combine's index (see :class:`SlabPartition`):
    ``(a_order, a_seg, agg_pos)`` from the sub-stream's and the main
    stream's slot maps."""
    flat = np.asarray(a_slot, np.int64).reshape(-1)
    order = np.argsort(flat, kind="stable")
    seg = np.searchsorted(flat[order], np.arange(n_straddle + 2), side="left")
    pos = np.where(np.asarray(agg_slot) != 0, seg[np.asarray(agg_slot, np.int64)], 0)
    return order.astype(np.int64), seg.astype(np.int64), pos.astype(np.int64)


def build_slab_partition(
    val: np.ndarray,
    col: np.ndarray,
    chunk_row: np.ndarray,
    tile_inst: np.ndarray,
    lhs1: np.ndarray,
    rhs1: np.ndarray,
    is_int_rows: np.ndarray,
    n_pad: int,
    slab: int,
    dummy_rows: np.ndarray,
    device="cpu",
) -> SlabPartition:
    """Host-side slab bucketing of a (possibly batched) block-ELL stream at
    chunk granularity (see :class:`SlabPartition` for the layout), as
    tensors on ``device``.

    ``val``/``col`` are ``(T, R, K)`` tiles with instance-local columns;
    ``chunk_row`` carries the row ids; ``lhs1``/``rhs1`` are the side
    vectors those ids index; ``is_int_rows`` is the ``(B, n_pad)``
    integrality plane and ``dummy_rows`` each instance's padding row.

    Each nonzero-carrying chunk becomes one copy per slab its columns
    touch, so every matrix nonzero lands in exactly one copy.  Rows whose
    nonzeros split across copies are diverted to the straddle sub-stream;
    everything else completes inside its copy."""
    val = np.asarray(val)
    col = np.asarray(col, dtype=np.int32)
    chunk_row = np.asarray(chunk_row)
    tile_inst = np.asarray(tile_inst, dtype=np.int64)
    is_int_rows = np.asarray(is_int_rows)
    dummy_rows = np.asarray(dummy_rows, dtype=np.int64)
    t, r, k = val.shape
    dt = val.dtype
    if slab % LANE:
        raise ValueError(f"slab={slab} must be a multiple of LANE={LANE}")
    n_slabs = -(-n_pad // slab)
    n_pad_part = n_slabs * slab
    bsz = int(dummy_rows.shape[0])

    cval, ccol, crow, cinst, src = chunk_stream(val, col, chunk_row, tile_inst)
    nc = t * r
    nz = cval != 0

    # Copy list: one (chunk, slab) pair per touched slab, chunk-major.
    slab_of = np.where(nz, ccol // slab, 0)
    touched = np.zeros((nc, n_slabs), dtype=bool)
    c_idx = np.broadcast_to(np.arange(nc)[:, None], (nc, k))
    touched[c_idx[nz], slab_of[nz]] = True
    ch_ids, s_ids = np.nonzero(touched)
    cp_inst = cinst[ch_ids]

    keep = nz[ch_ids] & (slab_of[ch_ids] == s_ids[:, None])
    cp_nnz = keep.sum(axis=1)

    # Straddle detection: a copy is complete iff it holds ALL of its row's
    # nonzeros; rows with any incomplete copy get a table slot (>= 1).
    n_rows_all = int(np.asarray(lhs1).shape[0])
    row_nnz = np.zeros(n_rows_all, dtype=np.int64)
    np.add.at(row_nnz, crow, nz.sum(axis=1))
    cp_row = crow[ch_ids].astype(np.int64)
    complete = cp_nnz == row_nnz[cp_row]
    srows = np.unique(cp_row[~complete])
    n_straddle = int(srows.size)
    slot_of_row = np.zeros(n_rows_all, dtype=np.int64)
    slot_of_row[srows] = 1 + np.arange(n_straddle)

    cp_val = np.where(keep, cval[ch_ids], 0).astype(dt)
    cp_col = np.where(keep, ccol[ch_ids] - s_ids[:, None] * slab, 0).astype(np.int32)
    cp_ii = np.where(keep, is_int_rows[cp_inst[:, None], ccol[ch_ids]], False)
    cp_slot = slot_of_row[cp_row]

    main, run_start, run_len, run_inst, run_slab = _pack_copy_windows(
        np.ones(ch_ids.size, dtype=bool), cp_inst, s_ids,
        cp_val, cp_col, cp_ii, cp_row, complete, cp_slot,
        bsz, n_slabs, r, k, dummy_rows, cover=True,
    )
    sub, a_run_start, a_run_len, a_run_inst, a_run_slab = _pack_copy_windows(
        ~complete, cp_inst, s_ids,
        cp_val, cp_col, cp_ii, cp_row, complete, cp_slot,
        bsz, n_slabs, r, k, dummy_rows, cover=False,
    )
    a_order, a_seg, agg_pos = straddle_combine_index(sub["slot"], main["slot"], n_straddle)

    lhs1 = np.asarray(lhs1, dtype=dt)
    rhs1 = np.asarray(rhs1, dtype=dt)
    dev = torch.device(device)
    t_ = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    i32 = lambda x: t_(np.asarray(x).astype(np.int32))
    return SlabPartition(
        val=t_(main["val"]),
        col_s=t_(main["col"]),
        chunk_row=t_(main["row"]),
        tile_inst=i32(main["tile_inst"]),
        tile_slab=i32(main["tile_slab"]),
        ii_g=i32(main["ii"]),
        lhs_g=t_(lhs1[main["row"]]),
        rhs_g=t_(rhs1[main["row"]]),
        row_done=t_(main["done"]),
        agg_slot=t_(main["slot"]),
        chunk_len=chunk_lengths(t_(main["val"])),
        run_start=t_(run_start),
        run_len=t_(run_len),
        run_inst=t_(run_inst),
        run_slab=t_(run_slab),
        a_val=t_(sub["val"]),
        a_col_s=t_(sub["col"]),
        a_slot=t_(sub["slot"]),
        a_tile_inst=i32(sub["tile_inst"]),
        a_tile_slab=i32(sub["tile_slab"]),
        a_run_start=t_(a_run_start),
        a_run_len=t_(a_run_len),
        a_run_inst=t_(a_run_inst),
        a_run_slab=t_(a_run_slab),
        a_chunk_len=chunk_lengths(t_(sub["val"])),
        a_order=t_(a_order),
        a_seg=t_(a_seg),
        agg_pos=t_(agg_pos),
        slab=int(slab),
        n_slabs=int(n_slabs),
        n_pad_part=int(n_pad_part),
        batch=bsz,
        n_straddle=n_straddle,
        max_run_len=int(run_len.max(initial=1)),
        max_chunk_len=_longest_chunk(main["val"]),
        a_max_run_len=int(a_run_len.max(initial=0)),
        a_max_chunk_len=_longest_chunk(sub["val"]),
        source_tiles=t,
        source_chunks=int(src.sum()),
        num_chunk_copies=int(ch_ids.size),
    )
