"""Attention: GQA/MQA/MHA with memory-efficient blockwise softmax.

  * train/prefill use *blockwise* attention -- an online-softmax loop over
    (q-chunk, k-chunk) tiles so the S x S score matrix never materializes.
    The full schedule computes every tile (masked ones included); the
    ``causal_skip`` pair schedule computes only tiles with a live (q, k)
    position.
  * GQA never materializes repeated KV heads: q is grouped to
    (B, H_kv, G, S, D) and contracted against (B, H_kv, S, D), so query head
    ``h`` reads KV head ``h // G``.
  * decode attends a (possibly rolling) cache with position masking.

The scores, the softmax state ``(m, l, acc)`` and the value products are a
float32 island at every activation dtype, as in the JAX package: a product
over bfloat16 or float32 operands runs in float32, one over float64 operands
in float64 rounded to float32 (what XLA does for
``preferred_element_type=float32``).  Masks are ``NEG = -1e30``, applied
with ``where`` in prefill and added in decode.
"""
from __future__ import annotations

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Replicate, Shard

NEG = -1e30


def _dot32(eq: str, a, b):
    """``einsum(eq, a, b)`` with a float32 result (``preferred_element_type``)."""
    if a.dtype == torch.float64 or b.dtype == torch.float64:
        return torch.einsum(eq, a.to(torch.float64), b.to(torch.float64)).to(torch.float32)
    return torch.einsum(eq, a.to(torch.float32), b.to(torch.float32))


def _group_q(q, n_kv: int):
    b, hq, s, d = q.shape
    g = hq // n_kv
    return q.reshape(b, n_kv, g, s, d)


def _per_rank(fn, q, k, v, **kw):
    """``fn`` on each rank's own batch rows and heads of DTensor ``q``, ``k``,
    ``v`` (B, H, S, D): attention is independent across both, so each rank
    runs the plain attention on its local blocks, as GSPMD partitions it,
    and no collective runs inside (nor does DTensor dispatch the tile
    loop).  The inputs are first placed split over dims 0 and 1 only, as
    ``q`` is (K and V must hold ``q``'s KV heads on each rank: the model
    gives each query head its own KV head where the KV heads are fewer
    than the ranks that split the query heads); the output takes that
    placement."""
    mesh = q.device_mesh
    place = [p if isinstance(p, Shard) and p.dim in (0, 1) else Replicate()
             for p in q.placements]
    q, k, v = (t.redistribute(mesh, place) for t in (q, k, v))
    out = fn(q.to_local(), k.to_local(), v.to_local(), **kw)
    shape = (q.shape[0], q.shape[1], q.shape[2], v.shape[3])
    return DTensor.from_local(out, mesh, place, run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta").stride())


def _pick(s: int, c: int) -> int:
    c = min(c, s)
    while s % c:  # largest divisor <= requested chunk
        c -= 1
    return c


def blockwise_attention(
    q,
    k,
    v,
    *,
    causal: bool = True,
    window: int | None = None,
    chunk_q: int = 512,
    chunk_k: int = 512,
    q_offset: int = 0,
    unroll: bool = False,
    causal_skip: bool = False,
):
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D); Hq % Hkv == 0.
    ``q_offset``: absolute position of q[..., 0, :] (chunked prefill).
    Returns (B, Hq, Sq, Dv).  ``causal_skip=True`` takes the triangular
    pair schedule (fully masked tiles never computed).  ``unroll`` is the
    JAX package's HLO probe switch; the loops here are Python loops either
    way, so it changes nothing.  DTensor inputs run per rank
    (:func:`_per_rank`)."""
    del unroll
    if isinstance(q, DTensor):
        return _per_rank(blockwise_attention, q, k, v, causal=causal, window=window,
                         chunk_q=chunk_q, chunk_k=chunk_k, q_offset=q_offset,
                         causal_skip=causal_skip)
    if causal_skip and q.shape[2] > 1:
        return _blockwise_attention_pairs(
            q, k, v, causal=causal, window=window, chunk_q=chunk_q,
            chunk_k=chunk_k, q_offset=q_offset,
        )
    return _blockwise_attention_full(
        q, k, v, causal=causal, window=window, chunk_q=chunk_q,
        chunk_k=chunk_k, q_offset=q_offset,
    )


def _tiles(q, k, v, chunk_q: int, chunk_k: int):
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    dv = v.shape[-1]  # value dim may differ from qk dim (MLA)
    g = hq // hkv
    cq = _pick(sq, chunk_q)
    ck = _pick(sk, chunk_k)
    nq, nk = sq // cq, sk // ck
    qg = _group_q(q, hkv).reshape(b, hkv, g, nq, cq, d)
    ks = k.reshape(b, hkv, nk, ck, d)
    vs = v.reshape(b, hkv, nk, ck, dv)
    return qg, ks, vs, (b, hkv, g, cq, ck, nq, nk, dv, d ** -0.5)


def _tile_step(state, q_c, k_c, v_c, qpos, kpos, scale, causal, window):
    """One online-softmax update of ``state = (m, l, acc)`` by one tile."""
    m, l, acc = state
    s = _dot32("bhgqd,bhkd->bhgqk", q_c, k_c) * scale
    mask = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool, device=s.device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window is not None:
        mask &= (qpos[:, None] - kpos[None, :]) < window
    s = torch.where(mask, s, NEG)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    pv = _dot32("bhgqk,bhkd->bhgqd", p.to(v_c.dtype), v_c)
    return m_new, l_new, acc * corr[..., None] + pv


def _init_state(b, hkv, g, cq, dv, device):
    f32 = torch.float32
    return (torch.full((b, hkv, g, cq), NEG, dtype=f32, device=device),
            torch.zeros((b, hkv, g, cq), dtype=f32, device=device),
            torch.zeros((b, hkv, g, cq, dv), dtype=f32, device=device))


def _finish(states, q, b, hq, sq, dv):
    outs = [acc / torch.clamp_min(l, 1e-30)[..., None] for _, l, acc in states]
    out = torch.stack(outs, dim=3).to(q.dtype)  # (b, hkv, g, nq, cq, dv)
    return out.reshape(b, hq, sq, dv)


def _blockwise_attention_full(q, k, v, *, causal=True, window=None, chunk_q=512,
                              chunk_k=512, q_offset=0):
    """Every (q-chunk, k-chunk) tile, in order of k within each q chunk."""
    b, hq, sq, _ = q.shape
    qg, ks, vs, (b, hkv, g, cq, ck, nq, nk, dv, scale) = _tiles(q, k, v, chunk_q, chunk_k)
    ar_q = torch.arange(cq, device=q.device)
    ar_k = torch.arange(ck, device=q.device)
    states = []
    for iq in range(nq):
        qpos = q_offset + iq * cq + ar_q
        st = _init_state(b, hkv, g, cq, dv, q.device)
        for j in range(nk):
            st = _tile_step(st, qg[:, :, :, iq], ks[:, :, j], vs[:, :, j], qpos,
                            j * ck + ar_k, scale, causal, window)
        states.append(st)
    return _finish(states, q, b, hq, sq, dv)


def _blockwise_attention_pairs(q, k, v, *, causal=True, window=None, chunk_q=512,
                               chunk_k=512, q_offset=0):
    """Triangular (i, j) tile schedule: only tiles with at least one live
    (q, k) position are computed, in the JAX package's order (i-major)."""
    b, hq, sq, _ = q.shape
    qg, ks, vs, (b, hkv, g, cq, ck, nq, nk, dv, scale) = _tiles(q, k, v, chunk_q, chunk_k)
    pairs = []
    for i in range(nq):
        q_lo = q_offset + i * cq
        q_hi = q_offset + (i + 1) * cq - 1
        for j in range(nk):
            k_lo = j * ck
            k_hi = (j + 1) * ck - 1
            if causal and k_lo > q_hi:
                continue  # fully in the future
            if window is not None and (q_lo - k_hi) >= window:
                continue  # fully out of the band
            pairs.append((i, j))
    ar_q = torch.arange(cq, device=q.device)
    ar_k = torch.arange(ck, device=q.device)
    states = [_init_state(b, hkv, g, cq, dv, q.device) for _ in range(nq)]
    for i, j in pairs:
        states[i] = _tile_step(states[i], qg[:, :, :, i], ks[:, :, j], vs[:, :, j],
                               q_offset + i * cq + ar_q, j * ck + ar_k, scale, causal, window)
    return _finish(states, q, b, hq, sq, dv)


def _decode_bias(slots, pos: int, window: int | None):
    """0 where a cache slot holds a position ``<= pos``, else ``NEG``."""
    if window is None:
        valid = slots <= pos  # (smax,)
    else:
        # slot s holds absolute position p = pos - ((pos - s) mod window)
        p_abs = pos - torch.remainder(pos - slots, window)
        valid = (p_abs >= 0) & (p_abs <= pos)
    return torch.where(valid, 0.0, NEG).to(torch.float32)


def decode_attention(q, k_cache, v_cache, pos: int, *, window: int | None = None):
    """Single-token attention over a (max_len) cache.

    q: (B, Hq, 1, D); caches: (B, Hkv, S_max, D); pos: index of the
    *current* token (cache already updated at ``pos``).  For rolling caches
    (window), ``k_cache`` holds the last ``window`` positions at slots
    ``p % window`` (Python's ``mod``: ``torch.remainder``).  DTensor caches
    are read where they lie (:func:`_decode_sharded`).
    """
    if isinstance(k_cache, DTensor):
        return _decode_sharded(q, k_cache, v_cache, pos, window)
    b, hq, _, d = q.shape
    _, hkv, smax, _ = k_cache.shape
    dv = v_cache.shape[-1]
    scale = d ** -0.5
    qg = _group_q(q, hkv)  # (B, Hkv, G, 1, D)
    s = _dot32("bhgqd,bhkd->bhgqk", qg, k_cache) * scale
    bias = _decode_bias(torch.arange(smax, device=q.device), pos, window)
    p = torch.softmax(s + bias, dim=-1)  # broadcast over trailing smax dim
    out = _dot32("bhgqk,bhkd->bhgqd", p.to(v_cache.dtype), v_cache)
    return out.reshape(b, hq, 1, dv).to(q.dtype)


def split_dim(t, dim: int):
    """The mesh dim whose ``Shard`` splits tensor dim ``dim`` of DTensor
    ``t``, and this rank's first index along ``dim`` (DTensor splits as
    ``torch.chunk`` does); ``(None, 0)`` where no mesh dim splits it."""
    hits = [i for i, p in enumerate(t.placements) if isinstance(p, Shard) and p.dim == dim]
    if not hits:
        return None, 0
    if len(hits) > 1:
        raise ValueError(f"dim {dim} split over several mesh dims: {t.placements}")
    mesh = t.device_mesh
    chunk = -(-t.shape[dim] // mesh.size(hits[0]))
    return hits[0], mesh.get_local_rank(hits[0]) * chunk


def _all_reduce(t, op: str, group):
    return funcol.wait_tensor(funcol.all_reduce(t, op, group))


def softmax_across(s, weighted, group):
    """``softmax(s) @ V`` where the last dim of ``s`` (float32 scores) and
    the rows of V are split across the ranks of ``group``, a ``(mesh, mesh
    dim)``: each rank takes its own entries' max, sum of exponentials and
    ``weighted(e)`` (``e @ V`` over its own rows, float32), and two
    all-reduces complete them (the max; the two sums together) -- the
    partition GSPMD gives a softmax over a sharded dim.  Nothing of V moves."""
    m = _all_reduce(s.amax(dim=-1, keepdim=True), "max", group)
    e = torch.exp(s - m)
    o = weighted(e)
    acc = _all_reduce(torch.cat([o, e.sum(dim=-1, keepdim=True).to(o.dtype)], dim=-1), "sum",
                      group)
    return acc[..., :-1] / acc[..., -1:]


def _decode_sharded(q, k_cache, v_cache, pos: int, window: int | None):
    """:func:`decode_attention` on DTensor caches as ``cache_spec`` places
    them: batch rows over the data axes, and the KV heads or the sequence
    over "model".  ``q`` is placed to match (its batch rows as the cache's,
    its heads split where the cache's are).  Split heads: each rank runs
    the plain attention on its own rows and heads.  A split sequence: each
    rank scores its own slots, and :func:`softmax_across` completes the
    softmax over the ranks that hold the others, so the cache stays where
    it lies.  The output is placed as ``q`` was placed here."""
    mesh = k_cache.device_mesh
    if tuple(v_cache.placements) != tuple(k_cache.placements):
        raise ValueError(f"K and V caches placed apart: {k_cache.placements}, "
                         f"{v_cache.placements}")
    place = []
    for i, p in enumerate(k_cache.placements):
        if p.is_partial() or (isinstance(p, Shard) and p.dim == 3):
            raise ValueError(f"a decode cache placed {k_cache.placements}")
        if isinstance(p, Shard) and p.dim == 1 and (
                k_cache.shape[1] % mesh.size(i) or q.shape[1] % mesh.size(i)):
            raise ValueError(f"{k_cache.shape[1]} KV heads, {q.shape[1]} query heads: not "
                             f"split evenly over {mesh.size(i)} ranks")
        place.append(p if isinstance(p, Shard) and p.dim in (0, 1) else Replicate())
    ql = q.redistribute(mesh, place).to_local()
    k, v = k_cache.to_local(), v_cache.to_local()
    seq, lo = split_dim(k_cache, 2)
    if seq is None:
        out = decode_attention(ql, k, v, pos, window=window)
    else:
        b, hq, _, d = ql.shape
        qg = _group_q(ql, k.shape[1])
        s = _dot32("bhgqd,bhkd->bhgqk", qg, k) * d ** -0.5
        s = s + _decode_bias(lo + torch.arange(k.shape[2], device=k.device), pos, window)
        out = softmax_across(s, lambda e: _dot32("bhgqk,bhkd->bhgqd", e.to(v.dtype), v),
                             (mesh, seq))
        out = out.reshape(b, hq, 1, v.shape[-1]).to(ql.dtype)
    shape = (q.shape[0], q.shape[1], 1, v_cache.shape[3])
    return DTensor.from_local(out, mesh, place, run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta").stride())


def write_slots(cache, new, start: int, dim: int):
    """DTensor ``cache`` (a copy) with ``new`` written at ``start`` along
    ``dim``: each rank writes the part of ``new`` that falls in its own
    slots (``new`` is first placed as the cache is, whole along ``dim``).
    DTensor's own slice assignment of a split dim writes into a gathered
    copy, not the cache."""
    mesh = cache.device_mesh
    keep = [Replicate() if isinstance(p, Shard) and p.dim == dim else p for p in cache.placements]
    new = new.redistribute(mesh, keep).to_local()
    out = cache.to_local().clone()
    _, lo = split_dim(cache, dim)
    a, b = max(start, lo), min(start + new.shape[dim], lo + out.shape[dim])
    if a < b:
        out.narrow(dim, a - lo, b - a).copy_(new.narrow(dim, a - start, b - a))
    return DTensor.from_local(out, mesh, cache.placements, run_check=False, shape=cache.shape,
                              stride=cache.stride())


def _slot(pos: int, size: int, n_new: int, window: int | None) -> int:
    """Write position of ``cache_update``: ``pos`` (mod ``window`` for a
    rolling cache), clamped so the update stays in bounds, as
    ``lax.dynamic_update_slice`` clamps."""
    slot = int(pos) if window is None else int(pos) % window
    return min(max(slot, 0), size - n_new)


def cache_update(k_cache, v_cache, k_new, v_new, pos: int, window: int | None = None):
    """Insert one step's K/V at position ``pos`` (mod window for rolling).
    Returns new caches; the given ones are left as they were."""
    slot = _slot(pos, k_cache.shape[2], k_new.shape[2], window)
    if isinstance(k_cache, DTensor):
        return write_slots(k_cache, k_new, slot, 2), write_slots(v_cache, v_new, slot, 2)
    k_cache, v_cache = k_cache.clone(), v_cache.clone()
    k_cache[:, :, slot:slot + k_new.shape[2]] = k_new
    v_cache[:, :, slot:slot + v_new.shape[2]] = v_new
    return k_cache, v_cache
