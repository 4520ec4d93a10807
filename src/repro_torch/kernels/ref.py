"""Plain-PyTorch versions of the tile kernels: the shared tile math and the
oracle of every kernel in ``prop_round``.

These define the exact semantics (sentinel-infinity handling, padding masks,
division-first candidates) the CUDA kernels must reproduce.  On a CPU tensor
the kernel wrappers run these functions; on the card ``chip_smoke.py`` and
the GPU tests hold each kernel against them on the same inputs.
"""
from __future__ import annotations

import torch

from ..core import bounds as bnd
from ..core import carry as _carry
from ..core.types import INF, int_round_slack, is_half, plane_dtype, rounded
from ..obs import telemetry as _tel


def tile_contributions(val, lb_g, ub_g, inf: float = INF):
    """Per-nonzero activity contributions of one (or many) (.., R, K) tiles.

    Returns (pos, pad, min_is_inf, max_is_inf, c_min, c_max)."""
    pos = val > 0
    pad = val == 0
    b_min = torch.where(pos, lb_g, ub_g)
    b_max = torch.where(pos, ub_g, lb_g)
    min_is_inf = (b_min.abs() >= inf) & ~pad
    max_is_inf = (b_max.abs() >= inf) & ~pad
    c_min = torch.where(min_is_inf | pad, 0.0, val * b_min)
    c_max = torch.where(max_is_inf | pad, 0.0, val * b_max)
    return pos, pad, min_is_inf, max_is_inf, c_min, c_max


WARP = 32


def warp_order_sum(x):
    """Sum over the last axis in the order of the CUDA kernels' row sums.

    As if a warp owned a chunk: lane ``l`` adds slots ``l, l + 32, l + 64,
    ...`` in turn, then a butterfly of shuffles halves the lanes (``l + 16``,
    then ``l + 8``, ... ``l + 1``).  The kernels give a chunk of K <= 16
    slots fewer lanes (K rounded up to a power of two); the lanes they drop
    would only add +0.0, so the sum is the same.  Fixing this order makes
    kernel and plain version round alike on any data, not only where the
    sums are exact.  A 16-bit ``x`` is summed in float32 and rounded once,
    as XLA reduces it (and as the kernels' 16-bit forms do)."""
    if is_half(x.dtype):
        return warp_order_sum(x.float()).to(x.dtype)
    pad = (-x.shape[-1]) % WARP
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    x = x.reshape(*x.shape[:-1], -1, WARP)
    acc = x[..., 0, :]
    for j in range(1, x.shape[-2]):
        acc = acc + x[..., j, :]
    width = WARP
    while width > 1:
        width //= 2
        acc = acc[..., :width] + acc[..., width : 2 * width]
    return acc[..., 0]


def tile_row_aggregates(val, lb_g, ub_g, inf: float = INF):
    """Per-chunk activity partials of (.., R, K) tiles -> 4 x (.., R): finite
    min/max sums (in :func:`warp_order_sum` order) and int32 infinity
    counts."""
    _, _, min_is_inf, max_is_inf, c_min, c_max = tile_contributions(
        val, lb_g, ub_g, inf
    )
    rmf = warp_order_sum(c_min)
    rxf = warp_order_sum(c_max)
    rmc = min_is_inf.sum(dim=-1, dtype=torch.int32)
    rxc = max_is_inf.sum(dim=-1, dtype=torch.int32)
    return rmf, rmc, rxf, rxc


def tile_candidates(
    val, lb_g, ub_g, is_int_g,
    row_min_fin, row_min_cnt, row_max_fin, row_max_cnt,
    lhs, rhs, int_eps: float, inf: float = INF,
):
    """Residual activities (§3.4 single-infinity rule) + bound candidates
    (Eqs. 4/5) + integrality rounding.  Row aggregates / sides are (.., R)
    and broadcast over the K axis.

    Candidates use the division-first form ``(side - row_sum) / a + bound``:
    the chain (sub, div, add) has no multiply feeding an add, so no compiler
    can contract it into an FMA and every implementation rounds alike."""
    pos, pad, min_is_inf, max_is_inf, _, _ = tile_contributions(
        val, lb_g, ub_g, inf
    )
    rmf = row_min_fin[..., None]
    rmc = row_min_cnt[..., None]
    rxf = row_max_fin[..., None]
    rxc = row_max_cnt[..., None]
    lhs_b = lhs[..., None]
    rhs_b = rhs[..., None]

    # Residual usable at this entry (§3.4): all contributions finite and the
    # row sum complete (cnt == 0), or exactly this entry's bound infinite so
    # the sum over the others IS the residual (cnt == 1).
    ok_min = torch.where(min_is_inf, rmc == 1, rmc == 0)
    ok_max = torch.where(max_is_inf, rxc == 1, rxc == 0)
    # This entry's own bound, folded back in candidate space (0 when the
    # entry's contribution was never part of the finite sum).
    b_min = torch.where(pos, lb_g, ub_g)
    b_max = torch.where(pos, ub_g, lb_g)
    inc_min = torch.where(min_is_inf | pad, 0.0, b_min)
    inc_max = torch.where(max_is_inf | pad, 0.0, b_max)

    safe_a = torch.where(pad, 1.0, val)
    q_min = (rhs_b - rmf) / safe_a + inc_min
    q_max = (lhs_b - rxf) / safe_a + inc_max
    lcand = torch.where(pos, q_max, q_min)
    ucand = torch.where(pos, q_min, q_max)

    valid_l = torch.where(pos, (lhs_b > -inf) & ok_max, (rhs_b < inf) & ok_min) & ~pad
    valid_u = torch.where(pos, (rhs_b < inf) & ok_min, (lhs_b > -inf) & ok_max) & ~pad
    lcand = torch.where(valid_l, lcand.clamp(-inf, inf), -inf)
    ucand = torch.where(valid_u, ucand.clamp(-inf, inf), inf)

    do_l = is_int_g & (lcand.abs() < inf)
    do_u = is_int_g & (ucand.abs() < inf)
    slack = int_round_slack(lcand.dtype)
    sl = su = int_eps
    if slack:
        sl = int_eps + slack * lcand.abs().clamp_min(1.0)
        su = int_eps + slack * ucand.abs().clamp_min(1.0)
    lcand = torch.where(do_l, torch.ceil(lcand - sl), lcand)
    ucand = torch.where(do_u, torch.floor(ucand + su), ucand)
    return lcand, ucand


def activities_tiles_ref(val, lb_g, ub_g, inf: float = INF):
    """Kernel A oracle: per-chunk activity partials from pre-gathered bounds,
    (T, R, K) -> 4 x (T, R)."""
    return tile_row_aggregates(val, lb_g, ub_g, inf)


def candidates_tiles_ref(
    val, lb_g, ub_g, is_int_g,
    row_min_fin, row_min_cnt, row_max_fin, row_max_cnt,
    lhs_g, rhs_g, int_eps: float, inf: float = INF,
):
    """Kernel B oracle: (T, R, K) candidates from completed (T, R) row
    aggregates; invalid entries at the -inf/+inf sentinels."""
    return tile_candidates(
        val, lb_g, ub_g, is_int_g != 0,
        row_min_fin, row_min_cnt, row_max_fin, row_max_cnt,
        lhs_g, rhs_g, int_eps, inf,
    )


def fused_round_tiles_ref(
    val, lb_g, ub_g, is_int_g, lhs_g, rhs_g, int_eps: float, inf: float = INF
):
    """Kernel C oracle: activities + candidates in one pass; valid iff every
    row fits one chunk."""
    mf, mc, xf, xc = activities_tiles_ref(val, lb_g, ub_g, inf)
    return candidates_tiles_ref(
        val, lb_g, ub_g, is_int_g, mf, mc, xf, xc, lhs_g, rhs_g, int_eps, inf
    )


def scatter_round_ref(lcand, ucand, col, n_pad: int, inf: float = INF):
    """Column reduction oracle: accumulators start at the -inf/+inf
    *sentinels*, so columns with no candidate come out at the sentinel (the
    segment identities clamped to it)."""
    flat_col = col.reshape(-1).long()
    best_l = torch.full((n_pad,), -inf, dtype=lcand.dtype, device=lcand.device)
    best_u = torch.full((n_pad,), inf, dtype=ucand.dtype, device=ucand.device)
    best_l.scatter_reduce_(0, flat_col, lcand.reshape(-1), "amax")
    best_u.scatter_reduce_(0, flat_col, ucand.reshape(-1), "amin")
    return best_l, best_u


def fused_scatter_round_tiles_ref(
    val, col, is_int_g, lhs_g, rhs_g, lb, ub, n_pad: int, int_eps: float, inf: float = INF,
):
    """Kernel D oracle: bound gather + fused round + column reduction.
    (T, R, K) tiles + (n_pad,) bounds -> (n_pad,) x2."""
    c = col.long()
    lcand, ucand = fused_round_tiles_ref(
        val, lb[c], ub[c], is_int_g, lhs_g, rhs_g, int_eps, inf
    )
    return scatter_round_ref(lcand, ucand, col, n_pad, inf)


# Kernel F's grid: blocks of MERGE_THREADS threads, MERGE_COLUMNS columns a
# thread (round_common.cuh's merge body: thread t of block b takes columns
# b * MERGE_BLOCK + v * MERGE_THREADS + t, v < MERGE_COLUMNS).
MERGE_THREADS = 256
MERGE_COLUMNS = 4
MERGE_BLOCK = MERGE_THREADS * MERGE_COLUMNS


def merge_block_sums(x):
    """Block sums of the last axis of ``x`` (``(..., n)``) in the order of
    the merges' early-stop measure (``csrc/round_common.cuh``
    ``StopCarryFlags`` and ``RowStopFlags``): each thread adds its columns
    in order, each warp reduces its 32 sums by the butterfly of
    :func:`warp_order_sum`, each block adds its 8 warp sums left to right.
    Returns ``(..., ceil(n / MERGE_BLOCK))``.  Padding columns add +0.0,
    which changes no sum of these non-negative terms."""
    pad = (-x.shape[-1]) % MERGE_BLOCK
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    x = x.reshape(*x.shape[:-1], -1, MERGE_COLUMNS, MERGE_THREADS)
    acc = x[..., 0, :]
    for v in range(1, MERGE_COLUMNS):
        acc = acc + x[..., v, :]
    warps = warp_order_sum(acc.reshape(*acc.shape[:-1], MERGE_THREADS // WARP, WARP))
    block = warps[..., 0]
    for w in range(1, warps.shape[-1]):
        block = block + warps[..., w]
    return block


def merge_order_sum(x):
    """Sum of the last axis of ``x`` in the order of the merges' early stop:
    the block sums of :func:`merge_block_sums`, reduced as
    :func:`warp_order_sum` reduces a row (kernel F's last block, and #9's
    per row).  16-bit terms are summed in float32 and the sum rounded once,
    as the reference's ``progress_measure`` reduces them."""
    if is_half(x.dtype):
        return merge_order_sum(x.float()).to(x.dtype)
    return warp_order_sum(merge_block_sums(x))


def _progress_terms(lb, ub, new_lb, new_ub):
    """``bounds.progress_measure``'s terms, one per column."""
    dl = new_lb - lb
    du = ub - new_ub
    sl = 1.0 + torch.maximum(lb.abs(), new_lb.abs())
    su = 1.0 + torch.maximum(ub.abs(), new_ub.abs())
    return dl / sl + du / su


def merge_progress(lb, ub, new_lb, new_ub):
    """The progress measure of one merge (``bounds.progress_measure``'s
    terms) summed in kernel F's order (:func:`merge_order_sum`); over the
    last axis, so ``(B, n)`` planes give one measure per row (#9's)."""
    return merge_order_sum(_progress_terms(lb, ub, new_lb, new_ub))


def merge_rows_progress(lb, ub, new_lb, new_ub):
    """#9's early-stop measure of one merge of ``(B, n)`` planes: each row's
    block sums ``(B, ceil(n / MERGE_BLOCK))`` (the kernel's partials) and
    their sum in block order ``(B,)`` (the row's measure).  16-bit terms
    are summed in float32 (float32 partials) and each row's sum rounded
    once, as :func:`merge_order_sum`."""
    terms = _progress_terms(lb, ub, new_lb, new_ub)
    blocks = merge_block_sums(terms.to(plane_dtype(terms.dtype)))
    return blocks, warp_order_sum(blocks).to(terms.dtype)


def merge_carry_ref(lb, ub, best_l, best_u, eps: float, inf: float, outward: float, carry,
                    k: int, unroll: int, stop=None):
    """Kernel F's plain version: ``bounds.apply_updates`` where the loop
    carry's ``GO`` is set (else the bounds as they were), the round's flag
    folded into ``carry`` (:func:`~repro_torch.core.carry.fold`, in place),
    and every accumulator entry set back to the sentinel (in place).  With
    an early stop ``stop`` (one round a check group) the fold also takes
    the round's progress measure in the kernel's order
    (:func:`merge_progress`).  Planes of float32 beside 16-bit bounds
    (:func:`~repro_torch.core.types.plane_dtype`) narrow back exactly
    before the merge.  Returns new ``(lb, ub)`` and the carry's ``GO`` (a
    0-d bool view)."""
    new_lb, new_ub, changed = bnd.apply_updates(lb, ub, best_l.to(lb.dtype),
                                                best_u.to(ub.dtype), eps, inf, outward)
    best_l.fill_(-inf)
    best_u.fill_(inf)
    go = _carry.go_flag(carry)
    prog = merge_progress(lb, ub, new_lb, new_ub) if stop is not None else None
    new_lb, new_ub = torch.where(go, new_lb, lb), torch.where(go, new_ub, ub)
    _carry.fold(carry, changed, k, unroll, stop, prog)
    return new_lb, new_ub, go


def chunk_lengths(val):
    """``(T, R)`` int32: one past the last nonzero slot of each chunk of
    ``(T, R, K)`` tiles (0 for a chunk of padding) -- where kernels A' and
    E stop.  Every slot past it is padding, so it is exact whatever the
    chunk's layout (explicit zeros inside a row included)."""
    k = val.shape[-1]
    pos = torch.arange(1, k + 1, dtype=torch.int32, device=val.device)
    return torch.where(val != 0, pos, 0).amax(dim=-1).to(torch.int32)


def activities_gather_tiles_ref(val, col, lb, ub, n_pad: int, inf: float = INF,
                                chunk_len=None):
    """Kernel A' oracle: bound gather + activity partials.  ``chunk_len``
    (the kernel's stopping point) changes nothing: the sums skip padding."""
    del n_pad, chunk_len  # shape bookkeeping only; the gather is by column id
    c = col.long()
    return activities_tiles_ref(val, lb[c], ub[c], inf)


def candidates_scatter_tiles_ref(
    val, col, is_int_g,
    row_min_fin, row_min_cnt, row_max_fin, row_max_cnt,
    lhs_g, rhs_g, lb, ub, n_pad: int, int_eps: float, inf: float = INF, chunk_len=None,
):
    """Kernel E oracle: bound gather + candidates from row aggregates +
    column reduction (``chunk_len`` as in :func:`activities_gather_tiles_ref`)."""
    del chunk_len
    c = col.long()
    lcand, ucand = candidates_tiles_ref(
        val, lb[c], ub[c], is_int_g,
        row_min_fin, row_min_cnt, row_max_fin, row_max_cnt,
        lhs_g, rhs_g, int_eps, inf,
    )
    return scatter_round_ref(lcand, ucand, col, n_pad, inf)


# ---------------------------------------------------------------------------
# Long-row combine: chunk partials -> completed row aggregates, fixed order
# ---------------------------------------------------------------------------


def row_starts(chunk_row, n_rows: int):
    """``(n_rows + 1,)`` int64: the first chunk of each of the rows ``0 ..
    n_rows - 1`` in a stream whose ``chunk_row`` ascends (every row's chunks
    lie next to each other), then the stream's length -- the ``row_start``
    of the long-row combine."""
    flat = chunk_row.reshape(-1)
    return torch.searchsorted(flat, torch.arange(n_rows + 1, dtype=flat.dtype,
                                                 device=flat.device))



# Segments of more chunks than this are long: the combine kernel gives each
# one a warp, and each short segment a thread.
LONG_SEGMENT = 32


def segment_classes(row_start, threshold: int = LONG_SEGMENT, n_chunks: int | None = None):
    """The long-row combine's segments (``row_start`` ``(n_seg + 1,)``
    int64) in two classes, ``(short, long)`` int32 segment ids in ascending
    order: long where a segment holds more than ``threshold`` chunks.  Every
    segment lies in exactly one class.  Built once per layout (prepare
    time, or the service's admission), not per round; the combine's sums
    do not depend on it.

    With ``n_chunks`` (the stream's chunks) the lists have fixed lengths
    and are computed on the device with no host read: ``short`` holds
    ``n_seg`` entries, ``long`` ``n_chunks // (threshold + 1)`` (as many
    long segments as fit), each padded with -1 (an empty entry)."""
    n_seg = row_start.shape[0] - 1
    is_long = (row_start[1:] - row_start[:-1]) > threshold
    if n_chunks is None:
        return tuple(x.nonzero().flatten().to(torch.int32) for x in (~is_long, is_long))
    ids = torch.arange(n_seg, dtype=torch.int32, device=row_start.device)
    out = []
    for mask, cap in ((~is_long, n_seg), (is_long, n_chunks // (threshold + 1))):
        pos = torch.where(mask, torch.cumsum(mask, 0) - 1, cap)
        buf = torch.full((cap + 1,), -1, dtype=torch.int32, device=row_start.device)
        out.append(buf.scatter_(0, pos, ids)[:cap])
    return tuple(out)


def _segment_sums(values, start, count):
    """``values`` ``(..., L)`` summed LEFT TO RIGHT from 0 over the segments
    ``[start, start + count)`` -> ``(..., n_seg)``."""
    acc = torch.zeros((*values.shape[:-1], start.shape[0]), dtype=values.dtype,
                      device=values.device)
    for j in range(int(count.max()) if count.numel() else 0):
        has = count > j
        idx = torch.where(has, start + j, 0)
        acc = acc + torch.where(has, values[..., idx], 0)
    return acc


def combine_chunk_partials_ref(mf, mc, xf, xc, chunk_row, row_start, classes=None):
    """Oracle of the long-row combine: each row's ``(T, R)`` chunk partials
    summed LEFT TO RIGHT over the row's chunks, which lie next to each other
    in the stream (``row_start`` ``(m + 2,)`` int64 holds each row's first
    chunk, padding row ``m`` included), starting from 0, then gathered back
    per chunk.  One fixed order on every device, so the combine kernel
    matches it bitwise; rows that ran out of chunks add 0, which leaves a
    sum started from +0.0 unchanged.  Partials may carry leading node axes
    before ``chunk_row``'s shape: each node is combined on its own, over the
    same segments.  ``classes`` (:func:`segment_classes`, the kernel's
    thread/warp split) changes nothing."""
    del classes
    lead = mf.shape[: mf.ndim - chunk_row.ndim]
    nb = 1
    for d in lead:
        nb *= d
    start = row_start[:-1]
    count = row_start[1:] - start
    acc_f = _segment_sums(torch.stack([mf.reshape(nb, -1), xf.reshape(nb, -1)]), start, count)
    acc_i = _segment_sums(torch.stack([mc.reshape(nb, -1), xc.reshape(nb, -1)]), start, count)
    crow = chunk_row.reshape(-1).long()
    shape = mf.shape
    return (acc_f[0][:, crow].reshape(shape), acc_i[0][:, crow].reshape(shape),
            acc_f[1][:, crow].reshape(shape), acc_i[1][:, crow].reshape(shape))


# ---------------------------------------------------------------------------
# Node batches: one matrix, many bound planes
# ---------------------------------------------------------------------------


def node_fused_scatter_round_ref(
    val, col, is_int_g, lhs_g, rhs_g, lb, ub, n_pad: int,
    int_eps: float, inf: float = INF, active=None,
):
    """Kernel #10 oracle: ONE instance's ``(T, R, K)`` tiles over ``(B,
    n_pad)`` bound planes -> ``(B, n_pad)`` best_l / best_u.  Per node this
    is exactly :func:`fused_scatter_round_tiles_ref`.  ``active`` (``(B,)``
    bool) leaves the rows of inactive nodes at the sentinel identities; only
    active rows are computed, one at a time (reading the mask on the host)."""
    bsz = lb.shape[0]
    best_l = torch.full((bsz, n_pad), -inf, dtype=lb.dtype, device=lb.device)
    best_u = torch.full((bsz, n_pad), inf, dtype=ub.dtype, device=ub.device)
    rows = range(bsz) if active is None else active.nonzero().flatten().tolist()
    for b in rows:
        best_l[b], best_u[b] = fused_scatter_round_tiles_ref(
            val, col, is_int_g, lhs_g, rhs_g, lb[b], ub[b], n_pad, int_eps, inf
        )
    return best_l, best_u


def _active_rows(active):
    return active.nonzero().flatten()


def node_activities_gather_ref(val, col, lb, ub, active, n_pad: int, inf: float = INF,
                               chunk_len=None):
    """Oracle of kernel A' over a node batch: ONE instance's ``(T, R, K)``
    tiles over ``(B, n_pad)`` bound planes -> 4 x ``(B, T, R)`` partials,
    the active nodes' at once (each exactly
    :func:`activities_gather_tiles_ref` on its row), zeros for the others
    (whose rows the kernel does not write)."""
    del n_pad, chunk_len
    bsz = lb.shape[0]
    t, r, _ = val.shape
    outs = [torch.zeros((bsz, t, r), dtype=dt, device=lb.device)
            for dt in (lb.dtype, torch.int32, lb.dtype, torch.int32)]
    rows = _active_rows(active)
    if rows.numel():
        c = col.long()
        for o, x in zip(outs, activities_tiles_ref(val, lb[rows][:, c], ub[rows][:, c], inf)):
            o[rows] = x
    return tuple(outs)


def node_combine_chunk_partials_ref(mf, mc, xf, xc, chunk_row, row_start, active,
                                    classes=None):
    """Oracle of the long-row combine over a node batch: ``(B, T, R)``
    partials, every node's segments those of ``row_start`` -> ``(B, T, R)``
    completed aggregates for the active nodes (each exactly
    :func:`combine_chunk_partials_ref` on its planes), zeros for the
    others.  ``classes`` changes nothing."""
    del classes
    outs = [torch.zeros_like(x) for x in (mf, mc, xf, xc)]
    rows = _active_rows(active)
    if rows.numel():
        done = combine_chunk_partials_ref(mf[rows], mc[rows], xf[rows], xc[rows], chunk_row,
                                          row_start)
        for o, x in zip(outs, done):
            o[rows] = x
    return tuple(outs)


def node_candidates_scatter_ref(
    val, col, is_int_g, row_min_fin, row_min_cnt, row_max_fin, row_max_cnt, lhs_g, rhs_g,
    lb, ub, active, n_pad: int, int_eps: float, inf: float = INF, chunk_len=None,
):
    """Oracle of kernel E over a node batch: ONE instance's tiles, ``(B, T,
    R)`` completed row aggregates and ``(B, n_pad)`` planes -> ``(B,
    n_pad)`` best_l / best_u, each active node's exactly
    :func:`candidates_scatter_tiles_ref` on its rows, the sentinels for the
    others."""
    del chunk_len
    bsz = lb.shape[0]
    dt = plane_dtype(lb.dtype)  # float32 planes beside 16-bit bounds, as the kernel's
    best_l = torch.full((bsz, n_pad), -inf, dtype=dt, device=lb.device)
    best_u = torch.full((bsz, n_pad), inf, dtype=dt, device=ub.device)
    rows = _active_rows(active)
    nb = rows.numel()
    if nb:
        c = col.long()
        lcand, ucand = candidates_tiles_ref(
            val, lb[rows][:, c], ub[rows][:, c], is_int_g, row_min_fin[rows],
            row_min_cnt[rows], row_max_fin[rows], row_max_cnt[rows], lhs_g, rhs_g, int_eps, inf,
        )
        plane = torch.arange(nb, device=c.device)[:, None, None, None] * n_pad
        bl, bu = scatter_round_ref(lcand, ucand, c[None] + plane, nb * n_pad, inf)
        best_l[rows], best_u[rows] = bl.view(nb, n_pad).to(dt), bu.view(nb, n_pad).to(dt)
    return best_l, best_u


# ---------------------------------------------------------------------------
# Packed batches: one flat tile stream, one column window per instance
# ---------------------------------------------------------------------------
#
# ``col_g`` holds global column ids ``col + tile_inst * n_pad`` into the
# flattened ``(B, n_pad)`` planes, so instance windows never alias and each
# instance's arithmetic is exactly its single-instance round.


def global_columns(col, tile_inst, n_pad: int):
    """``(T, R, K)`` int64 global column ids ``col + tile_inst * n_pad`` of a
    flat stream with instance-local columns."""
    return col.long() + tile_inst.long()[:, None, None] * n_pad


def instance_chunks(tile_inst, tile_rows: int, batch: int):
    """``(B + 1,)`` int64 chunk ranges of a flat stream whose tiles of one
    instance are contiguous and in instance order (``tile_inst`` non-
    decreasing, as packing and the service's slots lay them out): instance
    ``i`` owns chunks ``[start[i], start[i + 1])``, an instance without
    tiles an empty range.  Kernel #8 walks the active instances' ranges."""
    bounds = torch.arange(batch + 1, dtype=torch.int32, device=tile_inst.device)
    return torch.searchsorted(tile_inst.contiguous(), bounds).to(torch.int64) * tile_rows


def batched_scatter_round_ref(lcand, ucand, col_g, batch: int, n_pad: int, inf: float = INF):
    """Column reduction over a whole packed batch -> ``(B, n_pad)`` best_l /
    best_u, sentinel where a column has no candidate."""
    best_l, best_u = scatter_round_ref(lcand, ucand, col_g, batch * n_pad, inf)
    return best_l.reshape(batch, n_pad), best_u.reshape(batch, n_pad)


def batched_fused_scatter_round_ref(
    val, col_g, is_int_g, lhs_g, rhs_g, lb, ub, n_pad: int,
    int_eps: float, inf: float = INF, active=None,
):
    """Kernel #8 oracle: a packed batch's ``(T, R, K)`` flat tile stream
    (global columns) + ``(B, n_pad)`` bound planes -> ``(B, n_pad)`` x2.
    Per instance exactly :func:`fused_scatter_round_tiles_ref` (each chunk
    summed in :func:`warp_order_sum` order).  ``active`` (``(B,)`` bool)
    leaves the rows of inactive instances at the sentinel identities: their
    candidates are dropped before the column reduction (a slot's instance
    is ``col_g // n_pad``, padding included)."""
    c = col_g.long()
    lbf, ubf = lb.reshape(-1), ub.reshape(-1)
    lcand, ucand = fused_round_tiles_ref(
        val, lbf[c], ubf[c], is_int_g, lhs_g, rhs_g, int_eps, inf
    )
    if active is not None:
        on = active[c // n_pad]
        lcand = torch.where(on, lcand, -inf)
        ucand = torch.where(on, ucand, inf)
    return batched_scatter_round_ref(lcand, ucand, c, lb.shape[0], n_pad, inf)


def batched_candidates_scatter_round_ref(
    val, col_g, is_int_g, chunk_row, lhs_g, rhs_g, lb, ub,
    m_total: int, n_pad: int, int_eps: float, inf: float = INF,
):
    """The batched round for rows spanning several chunks, over the flat
    stream and the ``(B * n_pad,)`` view of the planes: chunk partials (A'),
    each GLOBAL row's partials summed left to right (``chunk_row`` ascends:
    instance row offsets, each instance's padding chunks on its own dummy
    row, so segments never alias across instances; ``m_total`` rows), then
    candidates + the column reduction (E).  Per instance exactly the
    single-instance A' / combine / E round."""
    batch = lb.shape[0]
    width = batch * n_pad
    lbf, ubf = lb.reshape(-1), ub.reshape(-1)
    partials = activities_gather_tiles_ref(val, col_g, lbf, ubf, width, inf)
    aggs = combine_chunk_partials_ref(*partials, chunk_row, row_starts(chunk_row, m_total))
    best_l, best_u = candidates_scatter_tiles_ref(
        val, col_g, is_int_g, *aggs, lhs_g, rhs_g, lbf, ubf, width, int_eps, inf
    )
    return best_l.reshape(batch, n_pad), best_u.reshape(batch, n_pad)


# ---------------------------------------------------------------------------
# Column-slab partitions: the partitioned engine's kernels (#11-#15)
# ---------------------------------------------------------------------------
#
# Bound planes are (B, W) with W >= every window's end that a real nonzero
# reaches: the partition's n_pad_part, or the instance's n_pad (the columns
# in between carry no nonzero, so the reference's zero padding there is
# never read and its merge never changes anything).  A copy tile's window
# starts at ``inst * W + slab_id * slab``.


def copy_tile_runs(run_start, n_tiles: int):
    """The run of each of ``n_tiles`` copy tiles: runs cover contiguous,
    ascending tile ranges, so it is the last run starting at or before the
    tile (the kernels' binary search)."""
    tiles = torch.arange(n_tiles, dtype=run_start.dtype, device=run_start.device)
    return torch.searchsorted(run_start, tiles, right=True) - 1


def _copy_windows(run_start, run_inst, run_slab, n_tiles: int, width: int, slab: int):
    """Per copy tile: its instance (int64, zeros without ``run_inst``) and
    the flat offset of its window in the ``(B, width)`` planes."""
    run = copy_tile_runs(run_start, n_tiles)
    inst = torch.zeros_like(run) if run_inst is None else run_inst.long()[run]
    return inst, inst * width + run_slab.long()[run] * slab


def _window_partials(val, col_s, off, lb, ub, inf):
    c = col_s.long() + off[:, None, None]
    lbf, ubf = lb.reshape(-1), ub.reshape(-1)
    return activities_tiles_ref(val, lbf[c], ubf[c], inf)


def _window_candidates(
    val, col_s, is_int_g, row_done, smf, smc, sxf, sxc, lhs_g, rhs_g, off, lb, ub,
    int_eps, inf,
):
    """Candidates of the copy tiles against their windows: local row
    aggregates, the straddle aggregates where ``row_done == 0``.  Returns
    ``(lcand, ucand, flat column ids)``."""
    c = col_s.long() + off[:, None, None]
    lbf, ubf = lb.reshape(-1), ub.reshape(-1)
    lb_g, ub_g = lbf[c], ubf[c]
    lmf, lmc, lxf, lxc = activities_tiles_ref(val, lb_g, ub_g, inf)
    done = row_done != 0
    sel = lambda local, s: torch.where(done, local, s)
    lcand, ucand = candidates_tiles_ref(
        val, lb_g, ub_g, is_int_g, sel(lmf, smf), sel(lmc, smc), sel(lxf, sxf),
        sel(lxc, sxc), lhs_g, rhs_g, int_eps, inf,
    )
    return lcand, ucand, c


def apply_updates_slab_ref(lb, ub, best_l, best_u, active, slab: int, eps: float,
                           inf: float = INF, outward: float = 0.0):
    """Kernel #15 oracle: the ``bounds.apply_updates`` merge over every
    ``(instance, slab)`` window of ``(B, W)`` planes; inactive rows pass
    through.  Returns ``(new_lb, new_ub, flags)``, ``flags`` ``(B,
    n_slabs)`` int32: 1 where the window changed."""
    bsz, width = lb.shape
    n_slabs = -(-width // slab)
    best_l, best_u = best_l.to(lb.dtype), best_u.to(ub.dtype)  # float32 planes narrow exactly
    take = (bnd.improved_lb(best_l, lb, eps) | bnd.improved_ub(best_u, ub, eps))
    take = take & active[:, None]
    new_lb, new_ub, _ = bnd.apply_updates_batch(lb, ub, best_l, best_u, eps, inf, outward,
                                                active=active)
    take = torch.nn.functional.pad(take, (0, n_slabs * slab - width))
    return new_lb, new_ub, take.reshape(bsz, n_slabs, slab).any(-1).to(torch.int32)


def batched_slab_partials_ref(val, col_s, run_start, run_len, run_inst, run_slab, active,
                              lb, ub, slab: int, max_run_len: int, inf: float = INF):
    """Kernel #11 oracle: per-copy activity partials of a sub-stream, each
    tile gathering from its run's ``(instance, slab)`` window of the ``(B,
    W)`` planes -> 4 x ``(Ta, R)``; the copies of inactive instances get
    zeros."""
    del run_len, max_run_len  # runs are contiguous: run_start alone maps tiles
    inst, off = _copy_windows(run_start, run_inst, run_slab, val.shape[0], lb.shape[1], slab)
    act = active[inst][:, None]
    return tuple(torch.where(act, x, torch.zeros_like(x))
                 for x in _window_partials(val, col_s, off, lb, ub, inf))


def batched_slab_scatter_ref(
    val, col_s, is_int_g, row_done, str_min_fin, str_min_cnt, str_max_fin, str_max_cnt,
    lhs_g, rhs_g, run_start, run_inst, run_slab, active, lb, ub, slab: int,
    int_eps: float, inf: float = INF,
):
    """The scatter of kernel #12: candidates of every copy tile against its
    window (straddle aggregates ``str_*`` ``(T'', R)`` where ``row_done ==
    0``), reduced per column -> ``(B, W)`` best_l / best_u, the sentinels
    where a column has no candidate and in the rows of inactive
    instances."""
    bsz, width = lb.shape
    inst, off = _copy_windows(run_start, run_inst, run_slab, val.shape[0], width, slab)
    lcand, ucand, c = _window_candidates(
        val, col_s, is_int_g, row_done, str_min_fin, str_min_cnt, str_max_fin, str_max_cnt,
        lhs_g, rhs_g, off, lb, ub, int_eps, inf,
    )
    act = active[inst][:, None, None]
    lcand = torch.where(act, lcand, -inf)
    ucand = torch.where(act, ucand, inf)
    best_l, best_u = scatter_round_ref(lcand, ucand, c, bsz * width, inf)
    return best_l.reshape(bsz, width), best_u.reshape(bsz, width)


def batched_slab_round_ref(
    val, col_s, is_int_g, row_done, str_min_fin, str_min_cnt, str_max_fin, str_max_cnt,
    lhs_g, rhs_g, run_start, run_len, run_inst, run_slab, active, lb, ub, slab: int,
    max_run_len: int, eps: float, int_eps: float, inf: float = INF, outward: float = 0.0,
):
    """Kernel #12 oracle: candidates of every copy tile against its window
    (straddle aggregates ``str_*`` ``(T'', R)`` where ``row_done == 0``),
    the column max/min per window (:func:`batched_slab_scatter_ref`), then
    #15's merge.  Returns ``(new_lb, new_ub, changed)``, ``changed``
    ``(n_runs,)`` int32 per run, which is per window in window order."""
    del run_len, max_run_len
    best_l, best_u = batched_slab_scatter_ref(
        val, col_s, is_int_g, row_done, str_min_fin, str_min_cnt, str_max_fin, str_max_cnt,
        lhs_g, rhs_g, run_start, run_inst, run_slab, active, lb, ub, slab, int_eps, inf,
    )
    new_lb, new_ub, flags = apply_updates_slab_ref(lb, ub, best_l, best_u, active, slab, eps,
                                                   inf, outward)
    return new_lb, new_ub, flags.reshape(-1)


def node_slab_partials_ref(val, col_s, run_start, run_len, run_slab, active, lb, ub,
                           slab: int, max_run_len: int, inf: float = INF):
    """Kernel #13 oracle: #11 per node of ONE instance's sub-stream over
    ``(B, W)`` per-node planes -> 4 x ``(B, Ta, R)``; inactive nodes get
    zeros.  Only active nodes are computed, one at a time (reading the mask
    on the host)."""
    del run_len, max_run_len
    t, r, _ = val.shape
    bsz = lb.shape[0]
    _, off = _copy_windows(run_start, None, run_slab, t, lb.shape[1], slab)
    dev = lb.device
    outs = [torch.zeros((bsz, t, r), dtype=d, device=dev)
            for d in (lb.dtype, torch.int32, lb.dtype, torch.int32)]
    for b in active.nonzero().flatten().tolist():
        for o, x in zip(outs, _window_partials(val, col_s, off, lb[b], ub[b], inf)):
            o[b] = x
    return tuple(outs)


def node_slab_scatter_ref(
    val, col_s, is_int_g, row_done, str_min_fin, str_min_cnt, str_max_fin, str_max_cnt,
    lhs_g, rhs_g, run_start, run_slab, active, lb, ub, slab: int, int_eps: float,
    inf: float = INF,
):
    """The scatter of #14: #12's scatter per node of ONE instance's copies,
    with ``(B, T'', R)`` per-node straddle aggregates and ``(B, W)``
    per-node planes -> ``(B, W)`` ``best_l`` / ``best_u``, the sentinels in
    the rows of inactive nodes.  Only active nodes are computed, one at a
    time."""
    bsz, width = lb.shape
    _, off = _copy_windows(run_start, None, run_slab, val.shape[0], width, slab)
    best_l = torch.full_like(lb, -inf)
    best_u = torch.full_like(ub, inf)
    for b in active.nonzero().flatten().tolist():
        lcand, ucand, c = _window_candidates(
            val, col_s, is_int_g, row_done, str_min_fin[b], str_min_cnt[b], str_max_fin[b],
            str_max_cnt[b], lhs_g, rhs_g, off, lb[b], ub[b], int_eps, inf,
        )
        best_l[b], best_u[b] = scatter_round_ref(lcand, ucand, c, width, inf)
    return best_l, best_u


def node_slab_round_ref(
    val, col_s, is_int_g, row_done, str_min_fin, str_min_cnt, str_max_fin, str_max_cnt,
    lhs_g, rhs_g, run_start, run_len, run_slab, active, lb, ub, slab: int, max_run_len: int,
    eps: float, int_eps: float, inf: float = INF, outward: float = 0.0,
):
    """Kernel #14 oracle: :func:`node_slab_scatter_ref`, then the window
    merge.  Returns ``(new_lb, new_ub, changed)``, ``changed`` ``(B,
    n_runs)`` int32; inactive nodes pass through unchanged."""
    del run_len, max_run_len
    best_l, best_u = node_slab_scatter_ref(
        val, col_s, is_int_g, row_done, str_min_fin, str_min_cnt, str_max_fin, str_max_cnt,
        lhs_g, rhs_g, run_start, run_slab, active, lb, ub, slab, int_eps, inf,
    )
    return apply_updates_slab_ref(lb, ub, best_l, best_u, active, slab, eps, inf, outward)


def straddle_segments(part, nb: int):
    """The segments of the straddle combine over ``nb`` planes of partials
    taken in ``part.a_order``: ``(chunk_row, row_start)`` in the long-row
    combine's layout, one segment per (plane, table slot) -- ``(nb * Ta *
    R,)`` int32 segment ids and ``(nb * (n_straddle + 1) + 1,)`` int64
    first positions."""
    length = int(part.a_order.shape[0])
    nseg = part.n_straddle + 1
    dev = part.a_seg.device
    start = part.a_seg[:-1][None, :] + length * torch.arange(nb, device=dev)[:, None]
    row_start = torch.cat([start.reshape(-1), start.new_full((1,), nb * length)])
    crow = torch.repeat_interleave(
        torch.arange(nb * nseg, dtype=torch.int32, device=dev),
        row_start[1:] - row_start[:-1], output_size=nb * length,
    )
    return crow, row_start


def straddle_tables(part, mf, mc, xf, xc):
    """The straddle combine over every plane: per-copy partials ``(...,
    Ta, R)`` -> each straddle row's completed aggregates, gathered per
    main-stream chunk ``(..., T'', R)``.  Each slot's partials are taken in
    ascending sub-stream position (``part.a_order``) and summed left to
    right from 0 by the long-row combine's plain version, so the sums take
    one order on every device.  The plain path's function; the kernel path
    runs :func:`straddle_combine_ref`'s kernel, equal to it on every chunk
    that reads it (``row_done == 0``)."""
    lead = mf.shape[:-2]
    flat = [x.reshape(-1, x.shape[-2] * x.shape[-1])[:, part.a_order] for x in (mf, mc, xf, xc)]
    nb, length = flat[0].shape
    crow, row_start = straddle_segments(part, nb)
    done = combine_chunk_partials_ref(*(x.reshape(-1) for x in flat), crow, row_start)
    pos = part.agg_pos.reshape(-1)
    shape = (*lead, *part.agg_pos.shape)
    return tuple(x.reshape(nb, length)[:, pos].reshape(shape) for x in done)


def straddle_combine_ref(mf, mc, xf, xc, a_order, a_seg, agg_slot, active=None):
    """Oracle of the straddle combine kernel: per-copy partials ``(Ta, R)``
    or ``(nb, Ta, R)`` + the partition's straddle index (``a_order``
    ``(Ta*R,)`` int64, ``a_seg`` ``(n_straddle + 2,)`` int64, ``agg_slot``
    ``(T'', R)`` int32) + ``active`` ``(nb,)`` bool (None: every plane) ->
    4 x ``(T'', R)`` or ``(nb, T'', R)`` straddle aggregates.  Per active
    plane: the compact ``(n_straddle + 1,)`` table of each slot's partials
    summed left to right from 0 in ``a_order`` order (slot 0, the dummy,
    holds +0.0 and 0), then each chunk's slot entry.  Equal to
    :func:`straddle_tables` wherever ``agg_slot != 0``, which is every chunk
    with ``row_done == 0``; inactive planes are zeros."""
    lead = mf.shape[:-2]
    nb = 1
    for d in lead:
        nb *= d
    rows = (torch.arange(nb, device=mf.device) if active is None
            else active.nonzero().flatten())
    start = a_seg[:-1].clone()
    count = a_seg[1:] - start
    start[0], count[0] = 0, 0  # the dummy slot sums nothing
    slot = agg_slot.reshape(-1).long()
    outs = []
    for x in (mf, mc, xf, xc):
        out = torch.zeros((nb, slot.shape[0]), dtype=x.dtype, device=x.device)
        if rows.numel():
            table = _segment_sums(x.reshape(nb, -1)[rows][:, a_order], start, count)
            out[rows] = table[:, slot]
        outs.append(out.reshape(*lead, *agg_slot.shape))
    return tuple(outs)


def partitioned_round_ref(part, lb_p, ub_p, int_eps: float, inf: float = INF):
    """Slab oracle: one round over a slab partition, ``(B, n_pad)`` planes
    (``B == part.batch``; ``n_pad <= n_pad_part``) -> ``(B, n_pad_part)``
    best_l / best_u with sentinel identities.  Per copy: local activity
    partials; straddle rows (``row_done == 0``) take their completed
    aggregates from :func:`straddle_tables`; candidates; the column
    max/min over global padded ids."""
    bsz, n_pad = lb_p.shape
    width = part.n_pad_part
    pad = lambda x: torch.nn.functional.pad(x, (0, width - n_pad))
    lb, ub = pad(lb_p), pad(ub_p)
    _, off = _copy_windows(part.run_start, part.run_inst, part.run_slab, part.num_copies,
                           width, part.slab)
    if part.has_straddle:
        _, a_off = _copy_windows(part.a_run_start, part.a_run_inst, part.a_run_slab,
                                 int(part.a_val.shape[0]), width, part.slab)
        tabs = straddle_tables(part, *_window_partials(part.a_val, part.a_col_s, a_off,
                                                           lb, ub, inf))
    else:
        z = torch.zeros(part.chunk_row.shape, dtype=lb.dtype, device=lb.device)
        zi = torch.zeros(part.chunk_row.shape, dtype=torch.int32, device=lb.device)
        tabs = (z, zi, z, zi)
    lcand, ucand, c = _window_candidates(
        part.val, part.col_s, part.ii_g, part.row_done, *tabs, part.lhs_g, part.rhs_g, off,
        lb, ub, int_eps, inf,
    )
    best_l, best_u = scatter_round_ref(lcand, ucand, c, bsz * width, inf)
    return best_l.reshape(bsz, width), best_u.reshape(bsz, width)


def node_partitioned_round_ref(part, lb_p, ub_p, int_eps: float, inf: float = INF,
                               active=None):
    """Node-batch slab oracle: ONE instance's partition over ``(B, n_pad)``
    per-node planes; per node exactly :func:`partitioned_round_ref`.
    Returns ``(B, n_pad_part)`` best_l / best_u; nodes outside ``active``
    (default: all) keep the sentinel identities."""
    bsz = lb_p.shape[0]
    best_l = torch.full((bsz, part.n_pad_part), -inf, dtype=lb_p.dtype, device=lb_p.device)
    best_u = torch.full_like(best_l, inf)
    rows = range(bsz) if active is None else active.nonzero().flatten().tolist()
    for b in rows:
        bl, bu = partitioned_round_ref(part, lb_p[b][None], ub_p[b][None], int_eps, inf)
        best_l[b], best_u[b] = bl[0], bu[0]
    return best_l, best_u


# ---------------------------------------------------------------------------
# Solver oracles: node objective bound, branch selection, incumbent update
# ---------------------------------------------------------------------------

# Threads of the node-objective kernel's block (one block per node).
OBJ_BLOCK = 1024


def block_order_sum(x):
    """Sum over the last axis in the order of the node-objective kernel:
    thread ``t`` adds columns ``t, t + 1024, ...`` to 0.0 in turn, each warp
    reduces its 32 sums by the shuffle butterfly of :func:`warp_order_sum`,
    and the first warp reduces the 32 warp sums the same way."""
    lead = x.shape[:-1]
    pad = (-x.shape[-1]) % OBJ_BLOCK
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    x = x.reshape(*lead, -1, OBJ_BLOCK)
    acc = torch.zeros((*lead, OBJ_BLOCK), dtype=x.dtype, device=x.device)
    for j in range(x.shape[-2]):
        acc = acc + x[..., j, :]
    return warp_order_sum(warp_order_sum(acc.reshape(*lead, OBJ_BLOCK // WARP, WARP)))


def node_objective_ref(lb, ub, c, is_int, valid, feas_eps: float, inf: float = INF):
    """Kernel #16 oracle: per-node objective lower bound + leaf/prune
    predicates.

    ``lb``/``ub`` ``(B, n_pad)``; ``c`` ``(n_pad,)`` minimization objective;
    ``is_int``/``valid`` ``(n_pad,)`` bool.  Returns ``(obj, fixed,
    crossed)``, each ``(B,)``: the domain-relaxation bound ``sum_j c_j lb_j``
    (``c_j > 0``) or ``c_j ub_j`` (``c_j < 0``), summed in the kernel's
    order (:func:`block_order_sum`) and the ``-inf`` sentinel if any
    contributing bound is infinite; ``fixed``: every valid integer column
    has ``ub - lb <= 0.5``; ``crossed``: some valid column has ``lb > ub +
    feas_eps``."""
    v = valid[None, :]
    cb = c[None, :]
    contrib = torch.where(cb > 0, cb * lb, cb * ub)
    contrib = torch.where(v & (cb != 0), contrib, 0.0)
    unbounded = v & (((cb > 0) & (lb <= -inf)) | ((cb < 0) & (ub >= inf)))
    total = block_order_sum(contrib)
    obj = torch.where(unbounded.any(dim=-1), torch.full_like(total, -inf), total)
    fixed = (~(v & is_int[None, :]) | (ub - lb <= 0.5)).all(dim=-1)
    crossed = ((lb > ub + feas_eps) & v).any(dim=-1)
    return obj, fixed, crossed


def most_fractional_ref(lb, ub, is_int, valid):
    """Most-fractional branching over ``(B, n_pad)`` planes: among valid
    unfixed integer columns (``ub - lb > 0.5``) the one whose domain
    midpoint is farthest from an integer, ties to the lowest column.
    Returns ``(var, has)``; ``var`` is 0 where ``has`` is False."""
    cand = valid[None, :] & is_int[None, :] & (ub - lb > 0.5)
    mid = 0.5 * (lb + ub)
    frac = mid - torch.floor(mid)
    score = torch.where(cand, 0.5 - (frac - 0.5).abs(), -1.0)
    return score.argmax(dim=-1), cand.any(dim=-1)


def pseudo_cost_select_ref(lb, ub, is_int, valid, pc_sum, pc_cnt, prior: float = 1e-4):
    """Pseudo-cost branching over ``(B, n_pad)`` planes: the product of the
    two directions' average bound gains (``(2, n_pad)`` sums and counts,
    direction 0 = down) plus ``prior``; candidates and ties as
    :func:`most_fractional_ref`.  Returns ``(var, has)``."""
    cand = valid[None, :] & is_int[None, :] & (ub - lb > 0.5)
    avg_d = pc_sum[0] / pc_cnt[0].clamp_min(1.0)
    avg_u = pc_sum[1] / pc_cnt[1].clamp_min(1.0)
    score = (avg_d + prior) * (avg_u + prior)
    score = torch.where(cand, score[None, :], -1.0)
    return score.argmax(dim=-1), cand.any(dim=-1)


def incumbent_update_ref(leaf, obj, inc, inc_x, lb, inf: float = INF):
    """Incumbent update: the best ``leaf`` node's objective (``min`` and
    first-index ``argmin``) replaces the 0-d incumbent ``inc`` and its
    ``lb`` row the ``(n_pad,)`` solution ``inc_x`` on strict improvement.
    Returns ``(inc, inc_x, improved)``."""
    leaf_obj = torch.where(leaf, obj, torch.full_like(obj, inf))
    best = leaf_obj.min()
    improved = best < inc
    inc_new = torch.where(improved, best, inc)
    x_new = torch.where(improved, lb[leaf_obj.argmin()], inc_x)
    return inc_new, x_new, improved


# ---------------------------------------------------------------------------
# Telemetry: the record kernels' plain versions
# ---------------------------------------------------------------------------


def crossed_columns(lb, ub, feas_eps: float):
    """Where ``lb > ub + feas_eps``, computed in the bounds' dtype (the
    scalar rounded to it, as the reference's weakly typed one is)."""
    return lb > ub + rounded(feas_eps, lb.dtype)


def crossed(lb, ub, feas_eps: float):
    """The infeasibility probe over the last axis: some ``lb > ub +
    feas_eps`` (computed in the bounds' dtype), padding columns included."""
    return crossed_columns(lb, ub, feas_eps).any(dim=-1)


def record_round_ref(lb, ub, carry, plane, feas_eps: float, unroll: int = 1,
                     patience: int = 0):
    """``record_round``'s plain version, IN PLACE, built on
    ``obs.telemetry.record_round``: after a check group of ``unroll``
    rounds of one instance's fixed point, where the loop carry's ``ROUNDS``
    has passed ``unroll * ticks`` (a group begun while GO was set), the
    carry's ``PROG`` (the group's measure, in ``lb``'s dtype) goes to
    ``ring[ticks % cap]``, ``ticks`` counts it, ``infeas_round`` latches
    ``ROUNDS`` where the post-round planes cross (:func:`crossed`) and,
    with an early stop armed (``patience > 0``), ``stop_round`` latches it
    where ``FLAT >= patience``; a group enqueued after GO cleared records
    nothing.  Returns ``plane``.  With ``plane=None`` (the host loop) the
    probe alone goes to the carry's ``CROSS`` field; returns None."""
    hit = crossed(lb, ub, feas_eps)
    if plane is None:
        carry[_carry.CROSS : _carry.CROSS + 1] = hit.to(torch.int32).reshape(1)
        return None
    rounds = carry[_carry.ROUNDS]
    prog = _carry.progress_view(carry, lb.dtype)[0]
    stopped = carry[_carry.FLAT] >= patience if patience > 0 else None
    new = _tel.record_round(plane, prog, rounds, hit, stopped)
    go = rounds > plane.ticks * unroll
    for dst, src in zip(plane, new):
        dst.copy_(torch.where(go, src, dst))
    return plane


def record_round_batch_ref(lb, ub, progress, ran, rounds, flat, plane, feas_eps: float,
                           patience: int = 0):
    """``record_round_batch``'s plain version, IN PLACE: one round of a
    batched fixed point over ``(B, n_pad)`` planes, recorded as
    ``obs.telemetry.record_round(..., active=ran)`` does: for each row that
    ran (``ran``), ``progress`` (its measure) to its ring, ``ticks``
    counted, ``infeas_round`` latched at ``rounds`` where its planes cross,
    and with an early stop armed (``patience > 0``) ``stop_round`` where
    ``flat >= patience``.  Returns ``plane``."""
    stopped = flat >= patience if patience > 0 else None
    new = _tel.record_round(plane, progress, rounds, crossed(lb, ub, feas_eps), stopped,
                            active=ran)
    for dst, src in zip(plane, new):
        dst.copy_(src)
    return plane
