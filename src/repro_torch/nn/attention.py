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
    way, so it changes nothing."""
    del unroll
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


def decode_attention(q, k_cache, v_cache, pos: int, *, window: int | None = None):
    """Single-token attention over a (max_len) cache.

    q: (B, Hq, 1, D); caches: (B, Hkv, S_max, D); pos: index of the
    *current* token (cache already updated at ``pos``).  For rolling caches
    (window), ``k_cache`` holds the last ``window`` positions at slots
    ``p % window`` (Python's ``mod``: ``torch.remainder``).
    """
    b, hq, _, d = q.shape
    _, hkv, smax, _ = k_cache.shape
    dv = v_cache.shape[-1]
    scale = d ** -0.5
    qg = _group_q(q, hkv)  # (B, Hkv, G, 1, D)
    s = _dot32("bhgqd,bhkd->bhgqk", qg, k_cache) * scale
    slots = torch.arange(smax, device=q.device)
    if window is None:
        valid = slots <= pos  # (smax,)
    else:
        # slot s holds absolute position p = pos - ((pos - s) mod window)
        p_abs = pos - torch.remainder(pos - slots, window)
        valid = (p_abs >= 0) & (p_abs <= pos)
    bias = torch.where(valid, 0.0, NEG).to(torch.float32)
    p = torch.softmax(s + bias, dim=-1)  # broadcast over trailing smax dim
    out = _dot32("bhgqk,bhkd->bhgqd", p.to(v_cache.dtype), v_cache)
    return out.reshape(b, hq, 1, dv).to(q.dtype)


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
    k_cache, v_cache = k_cache.clone(), v_cache.clone()
    k_cache[:, :, slot:slot + k_new.shape[2]] = k_new
    v_cache[:, :, slot:slot + v_new.shape[2]] = v_new
    return k_cache, v_cache
