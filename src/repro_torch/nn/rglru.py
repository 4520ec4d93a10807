"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427).

  i_t = sigmoid(W_x x_t + b_x)                 (input gate)
  r_t = sigmoid(W_a x_t + b_a)                 (recurrence gate)
  log a_t = -c * softplus(Lambda) * r_t        (c = 8)
  h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t x_t)

Prefill/train runs a log-step (Hillis-Steele) scan over (a, b) pairs, whose
sums differ from the JAX package's ``associative_scan`` only in order;
decode is the single recurrence step.  The gates and the state ``h`` are
float32 at every activation dtype.  The surrounding block is the Griffin
recurrent block: linear -> temporal conv (k=4) -> RG-LRU, gated by a
(tanh-form) GeLU branch, then an output projection.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class RGLRUConfig(NamedTuple):
    d_model: int
    d_rnn: int
    d_conv: int = 4
    c: float = 8.0


def softplus(x):
    """``log(1 + exp(x))`` as the JAX package computes it (``logaddexp(x, 0)``),
    with no linear cut-off."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _gates(params, u, cfg: RGLRUConfig):
    """Per-step recurrence coefficients (a_t, b_t) in fp32. u: (..., d_rnn)."""
    f32 = torch.float32
    uf = u.to(f32)
    i_t = torch.sigmoid(uf @ params["w_x"].to(f32) + params["b_x"])
    r_t = torch.sigmoid(uf @ params["w_a"].to(f32) + params["b_a"])
    log_a = -cfg.c * softplus(params["lam"]) * r_t
    a_t = torch.exp(log_a)
    b_t = torch.sqrt(torch.clamp_min(1.0 - a_t * a_t, 1e-12)) * (i_t * uf)
    return a_t, b_t


def _conv(params, u, conv_state=None):
    k = params["conv_w"].shape[0]
    if conv_state is None:
        pad = torch.zeros(u.shape[:1] + (k - 1,) + u.shape[2:], dtype=u.dtype, device=u.device)
    else:
        pad = conv_state.to(u.dtype)
    up = torch.cat([pad, u], dim=1)
    out = sum(
        up[:, i : i + u.shape[1], :] * params["conv_w"][i].to(u.dtype)
        for i in range(k)
    )
    return out + params["conv_b"].to(u.dtype), up[:, -(k - 1) :, :]


def linear_scan(a, b):
    """Inclusive scan of ``h_t = a_t h_{t-1} + b_t`` (``h_{-1} = 0``) along
    axis 1, in ``ceil(log2 S)`` steps."""
    s = a.shape[1]
    d = 1
    while d < s:
        b = torch.cat([b[:, :d], b[:, :-d] * a[:, d:] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
        d *= 2
    return b


def rglru_block_forward(params, x, cfg: RGLRUConfig, state=None):
    """Full-sequence forward. state=(h0 (B, d_rnn) fp32, conv_state)."""
    h0, conv_state = state if state is not None else (None, None)
    u = x @ params["w_in"].to(x.dtype)
    u, conv_state_new = _conv(params, u, conv_state)
    a_t, b_t = _gates(params, u, cfg)  # (B, S, dr) fp32

    if h0 is not None:
        # Fold the incoming state into the first step: b_0 += a_0 * h0.
        b_t = torch.cat([b_t[:, :1] + a_t[:, :1] * h0[:, None], b_t[:, 1:]], dim=1)

    h = linear_scan(a_t, b_t)
    h_last = h[:, -1, :]

    gate = F.gelu(x @ params["w_gate_branch"].to(x.dtype), approximate="tanh")
    y = (h.to(x.dtype) * gate) @ params["w_out"].to(x.dtype)
    return y, (h_last, conv_state_new)


def rglru_block_decode(params, x, cfg: RGLRUConfig, state):
    """Single-token step. state = (h (B, dr) fp32, conv_state (B, K-1, dr))."""
    h, conv_state = state
    u = x @ params["w_in"].to(x.dtype)
    u, conv_state = _conv(params, u, conv_state)
    a_t, b_t = _gates(params, u, cfg)           # (B, 1, dr)
    h = a_t[:, 0] * h + b_t[:, 0]
    gate = F.gelu(x @ params["w_gate_branch"].to(x.dtype), approximate="tanh")
    y = (h[:, None, :].to(x.dtype) * gate) @ params["w_out"].to(x.dtype)
    return y, (h, conv_state)
