"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434).

Train/prefill expand the KV latent to per-head keys/values and run the
blockwise attention (q/k head dim ``nope + rope``, value dim ``v``); decode
uses the *absorbed* formulation so the cache is only the latent ``c_kv``
(kv_lora_rank) plus the shared rotary key (qk_rope_dim) per position:

  score = q_nope^T k_nope + q_rope^T k_rope
        = (q_nope W_uk^T)^T c   + q_rope^T k_rope            (absorb W_uk)
  out_h = (sum_t p_t c_t) W_uv[h]                            (absorb W_uv)
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from .attention import NEG, blockwise_attention, softmax_across, split_dim, write_slots
from .layers import full_leaf, init_from_spec, normal_leaf, rmsnorm
from .rope import apply_rope


class MLAConfig(NamedTuple):
    d_model: int
    n_heads: int
    q_lora_rank: int       # 0 => full-rank q projection
    kv_lora_rank: int
    qk_nope_dim: int
    qk_rope_dim: int
    v_dim: int


def mla_spec(cfg: MLAConfig):
    """The parameter tree with ``(shape, init rule)`` leaves, the JAX
    package's ``mla_init`` scales: bare projection tensors (``wq`` or
    ``wq_a``/``wq_b``, ``wkv_a``, ``wkv_b``, ``wo``) and ``{"scale"}``
    norms (``q_norm``, ``kv_norm``)."""
    d, h = cfg.d_model, cfg.n_heads
    qk = cfg.qk_nope_dim + cfg.qk_rope_dim
    p = {}
    if cfg.q_lora_rank > 0:
        p["wq_a"] = normal_leaf((d, cfg.q_lora_rank), d**-0.5)
        p["q_norm"] = {"scale": full_leaf((cfg.q_lora_rank,), 1.0)}
        p["wq_b"] = normal_leaf((cfg.q_lora_rank, h * qk), cfg.q_lora_rank**-0.5)
    else:
        p["wq"] = normal_leaf((d, h * qk), d**-0.5)
    p["wkv_a"] = normal_leaf((d, cfg.kv_lora_rank + cfg.qk_rope_dim), d**-0.5)
    p["kv_norm"] = {"scale": full_leaf((cfg.kv_lora_rank,), 1.0)}
    p["wkv_b"] = normal_leaf((cfg.kv_lora_rank, h * (cfg.qk_nope_dim + cfg.v_dim)),
                             cfg.kv_lora_rank**-0.5)
    p["wo"] = normal_leaf((h * cfg.v_dim, d), (h * cfg.v_dim) ** -0.5)
    return p


def mla_init(gen: torch.Generator, cfg: MLAConfig, device=None):
    """fp32 weights of :func:`mla_spec` drawn from ``gen``."""
    return init_from_spec(gen, mla_spec(cfg), device)


def _queries(params, x, cfg: MLAConfig, cos, sin):
    b, s, _ = x.shape
    h = cfg.n_heads
    qk = cfg.qk_nope_dim + cfg.qk_rope_dim
    if cfg.q_lora_rank > 0:
        qa = x @ params["wq_a"].to(x.dtype)
        qa = rmsnorm(params["q_norm"], qa)
        q = qa @ params["wq_b"].to(x.dtype)
    else:
        q = x @ params["wq"].to(x.dtype)
    q = q.reshape(b, s, h, qk).transpose(1, 2)  # (B, H, S, qk)
    q_nope = q[..., : cfg.qk_nope_dim]
    q_rope = apply_rope(q[..., cfg.qk_nope_dim :], cos, sin)
    return q_nope, q_rope


def _latent(params, x, cfg: MLAConfig, cos, sin):
    """Compressed KV: (c_latent (B,S,r), k_rope (B,1,S,rope)) -- rope applied."""
    kv = x @ params["wkv_a"].to(x.dtype)
    c = rmsnorm(params["kv_norm"], kv[..., : cfg.kv_lora_rank])
    k_rope = kv[..., cfg.kv_lora_rank :][:, None]  # (B, 1, S, rope), shared head
    return c, apply_rope(k_rope, cos, sin)


def mla_attention(params, x, cfg: MLAConfig, cos, sin, chunk: int = 512,
                  unroll: bool = False, causal_skip: bool = False):
    """Full-sequence MLA (train / prefill). Returns (y, cache=(c, k_rope)),
    ``c`` (B, S, r) and ``k_rope`` (B, S, rope)."""
    b, s, _ = x.shape
    h = cfg.n_heads
    q_nope, q_rope = _queries(params, x, cfg, cos, sin)
    c, k_rope = _latent(params, x, cfg, cos, sin)

    kvb = (c @ params["wkv_b"].to(x.dtype)).reshape(b, s, h, cfg.qk_nope_dim + cfg.v_dim)
    k_nope = kvb[..., : cfg.qk_nope_dim].transpose(1, 2)   # (B,H,S,nope)
    v = kvb[..., cfg.qk_nope_dim :].transpose(1, 2)        # (B,H,S,v)

    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(b, h, s, cfg.qk_rope_dim)], dim=-1)
    y = blockwise_attention(q, k, v, causal=True, chunk_q=chunk, chunk_k=chunk,
                            unroll=unroll, causal_skip=causal_skip)
    y = y.transpose(1, 2).reshape(b, s, h * cfg.v_dim)
    return y @ params["wo"].to(x.dtype), (c, k_rope[:, 0])


def _write(cache, new, pos: int):
    """``cache`` with ``new`` (B, 1, ...) written at position ``pos`` along
    dim 1 (a copy).  Raises where the JAX package's
    ``dynamic_update_slice_in_dim`` would clamp the start."""
    if not 0 <= pos < cache.shape[1]:
        raise IndexError(f"decode position {pos} outside the cache's {cache.shape[1]} slots")
    if isinstance(cache, DTensor):
        return write_slots(cache, new, pos, 1)
    out = cache.clone()
    out[:, pos : pos + 1] = new
    return out


def mla_decode(params, x, cfg: MLAConfig, cos, sin, cache, pos: int):
    """Absorbed single-token decode.

    cache: (c_cache (B, S_max, r), kr_cache (B, S_max, rope)) with entries
    valid for positions <= pos-1; this step writes position ``pos``.
    Returns (y, new cache); the given cache is left as it was.
    """
    b, one, _ = x.shape
    assert one == 1
    h = cfg.n_heads
    r = cfg.kv_lora_rank
    pos = int(pos)

    q_nope, q_rope = _queries(params, x, cfg, cos, sin)  # (B,H,1,*)
    c_new, kr_new = _latent(params, x, cfg, cos, sin)    # (B,1,r), (B,1,1,rope)

    c_cache, kr_cache = cache
    c_cache = _write(c_cache, c_new, pos)
    kr_cache = _write(kr_cache, kr_new[:, 0], pos)

    wkv_b = params["wkv_b"].to(x.dtype).reshape(r, h, cfg.qk_nope_dim + cfg.v_dim)
    w_uk = wkv_b[..., : cfg.qk_nope_dim]   # (r, H, nope)
    w_uv = wkv_b[..., cfg.qk_nope_dim :]   # (r, H, v)

    # Absorb W_uk into the query: q_abs (B, H, r).
    q_abs = torch.einsum("bhon,rhn->bhor", q_nope, w_uk)[:, :, 0]
    scale = (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5
    if isinstance(c_cache, DTensor):
        ctx = _context_sharded(q_abs, q_rope, c_cache, kr_cache, pos, scale, x.dtype)
        y = torch.einsum("bhr,rhv->bhv", ctx, w_uv).reshape(b, 1, h * cfg.v_dim)
        return y @ params["wo"].to(x.dtype), (c_cache, kr_cache)
    s_nope = torch.einsum("bhr,bsr->bhs", q_abs, c_cache)
    s_rope = torch.einsum("bhoe,bse->bhs", q_rope, kr_cache)
    s = (s_nope + s_rope).to(torch.float32) * scale
    valid = torch.arange(c_cache.shape[1], device=x.device) <= pos
    s = s + torch.where(valid, 0.0, NEG).to(torch.float32)
    p = torch.softmax(s, dim=-1).to(x.dtype)

    ctx = torch.einsum("bhs,bsr->bhr", p, c_cache)           # latent context
    y = torch.einsum("bhr,rhv->bhv", ctx, w_uv).reshape(b, 1, h * cfg.v_dim)
    return y @ params["wo"].to(x.dtype), (c_cache, kr_cache)


def _context_sharded(q_abs, q_rope, c_cache, kr_cache, pos: int, scale: float, dtype):
    """The absorbed decode's latent context ``softmax(s) @ c`` (B, H, r) on
    DTensor caches, split over their sequence as ``cache_spec`` places them
    (batch rows over the data axes): each rank scores its own slots with
    every head's query (gathered: (B, H, r), not the cache), and
    ``softmax_across`` completes the softmax over the ranks that hold the
    other slots.  The context is placed over the batch rows only."""
    mesh = c_cache.device_mesh
    rows = [p if isinstance(p, Shard) and p.dim == 0 else Replicate() for p in c_cache.placements]
    qa, qr = (t.redistribute(mesh, rows).to_local() for t in (q_abs, q_rope))
    c = c_cache.to_local()
    kr = kr_cache.redistribute(mesh, c_cache.placements).to_local()
    seq, lo = split_dim(c_cache, 1)
    s = torch.einsum("bhr,bsr->bhs", qa, c) + torch.einsum("bhoe,bse->bhs", qr, kr)
    s = s.to(torch.float32) * scale
    s = s + torch.where(lo + torch.arange(c.shape[1], device=c.device) <= pos, 0.0,
                        NEG).to(torch.float32)
    weighted = lambda e: torch.einsum("bhs,bsr->bhr", e.to(dtype), c).to(torch.float32)
    if seq is None:
        ctx = weighted(torch.softmax(s, dim=-1))
    else:
        ctx = softmax_across(s, weighted, (mesh, seq))
    shape = (q_abs.shape[0], q_abs.shape[1], c_cache.shape[2])
    return DTensor.from_local(ctx.to(dtype), mesh, rows, run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta").stride())
