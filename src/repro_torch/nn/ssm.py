"""Mamba-2 (SSD -- state-space duality, arXiv:2405.21060).

Chunked SSD for train/prefill (quadratic within chunks, linear recurrence
across chunks) and a constant-memory recurrent step for decode.  Follows the
minimal-SSD reference formulation:

  h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t        (per head, state (P, N))
  y_t = C_t . h_t + D x_t

The whole scan and the decode state are float32 at every activation dtype,
as in the JAX package; a sequence is padded to a chunk multiple with
``dt = 0`` steps; B/C groups are repeated onto heads with
``repeat_interleave`` (``jnp.repeat``); the gate norm takes ``rmsnorm``'s
default eps.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .layers import rmsnorm
from .rglru import softplus


class Mamba2Config(NamedTuple):
    d_model: int
    d_inner: int       # = expand * d_model
    n_heads: int       # d_inner = n_heads * head_p
    head_p: int
    n_groups: int      # B/C groups (G)
    d_state: int       # N
    d_conv: int = 4
    chunk: int = 128


def _split_in(proj, cfg: Mamba2Config):
    di, gn = cfg.d_inner, cfg.n_groups * cfg.d_state
    z = proj[..., :di]
    xbc = proj[..., di : di + di + 2 * gn]
    dt = proj[..., di + di + 2 * gn :]
    return z, xbc, dt


def _causal_conv(xbc, conv_w, conv_b, conv_state=None):
    """Depthwise causal conv, kernel K. xbc: (B, S, C).

    If ``conv_state`` (B, K-1, C) is given (decode), it is prepended and the
    new state returned."""
    k = conv_w.shape[0]
    if conv_state is None:
        pad = torch.zeros(xbc.shape[:1] + (k - 1,) + xbc.shape[2:], dtype=xbc.dtype,
                          device=xbc.device)
    else:
        pad = conv_state.to(xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1)  # (B, S+K-1, C)
    out = sum(
        xp[:, i : i + xbc.shape[1], :] * conv_w[i].to(xbc.dtype)
        for i in range(k)
    )
    out = out + conv_b.to(xbc.dtype)
    new_state = xp[:, -(k - 1) :, :]
    return F.silu(out), new_state


def _segsum(x):
    """Cumulative segment-sum matrix: out[..., i, j] = sum_{j<k<=i} x[..., k]
    (``cs[i] - cs[j]``, ``-inf`` above the diagonal)."""
    t = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=x.device), 0)
    return torch.where(mask, out, -torch.inf)


def ssd_scan(xh, dt, a, bmat, cmat, cfg: Mamba2Config, h0=None, unroll: bool = False):
    """Chunked SSD.

    xh: (B, S, H, P); dt: (B, S, H) (post-softplus); a: (H,) negative;
    bmat/cmat: (B, S, G, N).  Returns (y (B,S,H,P), h_final (B,H,P,N)).
    ``unroll`` (the JAX package's HLO probe switch) changes nothing here.
    """
    del unroll
    b, s, h, p = xh.shape
    g, n = bmat.shape[2], bmat.shape[3]
    q = min(cfg.chunk, s)
    s_orig = s
    if s % q:  # pad with dt=0 steps: decay exp(0)=1, zero contribution
        pad = q - s % q
        padf = lambda x: F.pad(x, (0, 0) * (x.ndim - 2) + (0, pad))
        xh, dt, bmat, cmat = padf(xh), padf(dt), padf(bmat), padf(cmat)
        s = s + pad
    nc = s // q
    rep = h // g

    f32 = torch.float32
    xc = xh.reshape(b, nc, q, h, p).to(f32)
    dtc = dt.reshape(b, nc, q, h).to(f32)
    bc = bmat.reshape(b, nc, q, g, n).to(f32)
    cc = cmat.reshape(b, nc, q, g, n).to(f32)

    da = dtc * a  # (b, nc, q, h)
    da_cs = torch.cumsum(da, dim=2)

    # Intra-chunk (diagonal blocks): y_i += C_i . (sum_{j<=i} decay * dt_j B_j x_j)
    l = torch.exp(_segsum(da.permute(0, 1, 3, 2)))              # (b,nc,h,q,q)
    cb = torch.einsum("bcqgn,bckgn->bcgqk", cc, bc)              # (b,nc,g,q,q)
    cb = torch.repeat_interleave(cb, rep, dim=2)                 # (b,nc,h,q,q)
    m = cb * l * dtc.permute(0, 1, 3, 2)[:, :, :, None, :]       # weight on x_k
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", m, xc)

    # Chunk-final states: S_c = sum_j decay_to_end * dt_j B_j x_j
    decay_end = torch.exp(da_cs[:, :, -1:, :] - da_cs)           # (b,nc,q,h)
    b_h = torch.repeat_interleave(bc, rep, dim=3)                # per-head B (G small)
    sb = torch.einsum("bcqh,bcqhn,bcqhp->bchpn", decay_end * dtc, b_h, xc)

    # Inter-chunk recurrence over chunk index.
    chunk_decay = torch.exp(torch.sum(da, dim=2))                # (b,nc,h)
    hprev = torch.zeros((b, h, p, n), dtype=f32, device=xh.device) if h0 is None else h0
    h_in = []
    for c in range(nc):
        h_in.append(hprev)  # state *entering* the chunk
        hprev = hprev * chunk_decay[:, c, :, None, None] + sb[:, c]
    h_in = torch.stack(h_in, dim=1)                              # (b,nc,h,p,n)

    # Off-diagonal contribution: y_i += (C_i . h_in) * exp(da_cs_i)
    c_h = torch.repeat_interleave(cc, rep, dim=3)                # (b,nc,q,h,n)
    y_off = torch.einsum("bcqhn,bchpn->bcqhp", c_h, h_in) * torch.exp(da_cs)[..., None]

    y = (y_diag + y_off).reshape(b, s, h, p)[:, :s_orig]
    return y.to(xh.dtype), hprev


def mamba2_forward(params, x, cfg: Mamba2Config, h0=None, conv_state=None,
                   unroll: bool = False):
    """Full-sequence forward. Returns (y, (conv_state, ssm_state))."""
    proj = x @ params["in_proj"].to(x.dtype)
    z, xbc, dt = _split_in(proj, cfg)
    xbc, conv_state_new = _causal_conv(xbc, params["conv_w"], params["conv_b"], conv_state)
    di, gn = cfg.d_inner, cfg.n_groups * cfg.d_state
    xs = xbc[..., :di]
    bmat = xbc[..., di : di + gn].reshape(*x.shape[:2], cfg.n_groups, cfg.d_state)
    cmat = xbc[..., di + gn :].reshape(*x.shape[:2], cfg.n_groups, cfg.d_state)
    dt = softplus(dt.to(torch.float32) + params["dt_bias"])
    a = -torch.exp(params["a_log"])
    xh = xs.reshape(*x.shape[:2], cfg.n_heads, cfg.head_p)
    y, hfin = ssd_scan(xh, dt, a, bmat, cmat, cfg, h0, unroll=unroll)
    y = y + xh.to(y.dtype) * params["d_skip"].to(y.dtype)[:, None]
    y = y.reshape(*x.shape[:2], di)
    y = rmsnorm(params["gate_norm"], y * F.silu(z))
    return y @ params["out_proj"].to(x.dtype), (conv_state_new, hfin)


def mamba2_decode(params, x, cfg: Mamba2Config, state):
    """Single-token recurrent step. state = (conv_state (B,K-1,C), h (B,H,P,N))."""
    f32 = torch.float32
    conv_state, h = state
    proj = x @ params["in_proj"].to(x.dtype)
    z, xbc, dt = _split_in(proj, cfg)
    xbc, conv_state = _causal_conv(xbc, params["conv_w"], params["conv_b"], conv_state)
    di, gn = cfg.d_inner, cfg.n_groups * cfg.d_state
    xs = xbc[..., :di]
    bmat = xbc[..., di : di + gn].reshape(x.shape[0], 1, cfg.n_groups, cfg.d_state)
    cmat = xbc[..., di + gn :].reshape(x.shape[0], 1, cfg.n_groups, cfg.d_state)
    dt = softplus(dt.to(f32) + params["dt_bias"])[:, 0]            # (B,H)
    a = -torch.exp(params["a_log"])
    xh = xs.reshape(x.shape[0], cfg.n_heads, cfg.head_p).to(f32)

    rep = cfg.n_heads // cfg.n_groups
    bh = torch.repeat_interleave(bmat[:, 0], rep, dim=1).to(f32)   # (B,H,N)
    ch = torch.repeat_interleave(cmat[:, 0], rep, dim=1).to(f32)

    decay = torch.exp(dt * a)                                      # (B,H)
    h = h * decay[..., None, None] + torch.einsum("bh,bhn,bhp->bhpn", dt, bh, xh)
    y = torch.einsum("bhpn,bhn->bhp", h, ch)
    y = y + xh * params["d_skip"][:, None]
    y = y.reshape(x.shape[0], 1, di).to(x.dtype)
    y = rmsnorm(params["gate_norm"], y * F.silu(z))
    return y @ params["out_proj"].to(x.dtype), (conv_state, h)
