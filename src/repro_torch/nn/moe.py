"""Mixture-of-Experts: top-k softmax router + capacity-based dispatch with
SwiGLU experts and optional shared experts (DeepSeekMoE / Qwen3-MoE style).

Dispatch is scatter-based (no dense one-hot matmuls), as in the JAX
package: each (token, k) routing takes a slot of its expert's capacity in a
running count over the flat routing, tokens are scattered into an
``(E * cap + 1, D)`` buffer whose last row is the overflow bin, the experts
run as grouped einsums over the expert dim, and the outputs are gathered
back and combined with the gate weights.  The scatter is an out-of-place
``index_add``, so autograd reaches the tokens through it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .layers import init_from_spec, normal_leaf

# Dropless up to this many tokens: ``cap = t`` (decode and small prefills).
DROPLESS_TOKENS = 4096


class MoEConfig(NamedTuple):
    n_experts: int
    top_k: int
    d_model: int
    d_ff_expert: int
    n_shared: int = 0
    d_ff_shared: int = 0          # total shared-expert hidden width
    capacity_factor: float = 1.25
    router_scale: bool = False    # normalize top-k weights to sum 1


def moe_spec(cfg: MoEConfig):
    """The parameter tree with ``(shape, init rule)`` leaves, the JAX
    package's ``moe_init`` scales.  The leaves are bare tensors:
    ``router``, ``w_gate``, ``w_up``, ``w_down`` and, with shared experts,
    ``shared.{w_gate, w_up, w_down}``."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff_expert
    p = {
        "router": normal_leaf((d, e), d**-0.5),
        "w_gate": normal_leaf((e, d, f), d**-0.5),
        "w_up": normal_leaf((e, d, f), d**-0.5),
        "w_down": normal_leaf((e, f, d), f**-0.5),
    }
    if cfg.n_shared > 0:
        fs = cfg.d_ff_shared or cfg.d_ff_expert * cfg.n_shared
        p["shared"] = {
            "w_gate": normal_leaf((d, fs), d**-0.5),
            "w_up": normal_leaf((d, fs), d**-0.5),
            "w_down": normal_leaf((fs, d), fs**-0.5),
        }
    return p


def moe_init(gen: torch.Generator, cfg: MoEConfig, device=None):
    """fp32 weights of :func:`moe_spec` drawn from ``gen``."""
    return init_from_spec(gen, moe_spec(cfg), device)


def capacity(cfg: MoEConfig, t: int) -> int:
    """Slots per expert for ``t`` tokens: ``t`` (dropless) up to
    :data:`DROPLESS_TOKENS`, else ``t * k * capacity_factor / E`` truncated."""
    if t <= DROPLESS_TOKENS:
        return t
    return max(1, int(t * cfg.top_k * cfg.capacity_factor / cfg.n_experts))


def route(params, xt, cfg: MoEConfig):
    """Router in float32 (the router leaf is cast: under bfloat16 weights
    the JAX package's product promotes to float32).  Returns (probs (T, E),
    gate weights (T, K), experts (T, K)), the top k in descending order."""
    logits = xt.to(torch.float32) @ params["router"].to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    weights, experts = torch.topk(probs, cfg.top_k, dim=-1, sorted=True)
    if cfg.router_scale:
        weights = weights / torch.clamp_min(weights.sum(dim=-1, keepdim=True), 1e-9)
    return probs, weights, experts


def slots(experts, e: int, cap: int):
    """Each (token, k) routing's slot in the flat ``(E * cap + 1)`` buffer,
    token-major: its running index within its expert; routings past
    ``cap`` go to the overflow bin ``E * cap``.  Returns (slot, keep)."""
    flat_e = experts.reshape(-1)
    onehot = F.one_hot(flat_e, e)
    pos_in_e = torch.cumsum(onehot, dim=0) - 1
    my_pos = pos_in_e.gather(1, flat_e[:, None])[:, 0]
    keep = my_pos < cap
    slot = torch.where(keep, flat_e * cap + my_pos, torch.full_like(flat_e, e * cap))
    return slot, keep


def moe_apply(params, x, cfg: MoEConfig):
    """x: (B, S, D) -> (B, S, D). Returns (y, aux) with the load-balance
    loss (float32)."""
    b, s, d = x.shape
    t = b * s
    k, e = cfg.top_k, cfg.n_experts
    xt = x.reshape(t, d)
    probs, weights, experts = route(params, xt, cfg)
    cap = capacity(cfg, t)
    slot, keep = slots(experts, e, cap)

    # Scatter tokens to (E*cap+1, D) expert buffers (last row: overflow).
    src = xt.repeat_interleave(k, dim=0)                          # (T*K, D)
    buf = x.new_zeros((e * cap + 1, d)).index_add(0, slot, src)
    xe = buf[: e * cap].reshape(e, cap, d)

    # Expert SwiGLU (grouped einsum over the expert dim).
    g = torch.einsum("ecd,edf->ecf", xe, params["w_gate"].to(x.dtype))
    u = torch.einsum("ecd,edf->ecf", xe, params["w_up"].to(x.dtype))
    ye = torch.einsum("ecf,efd->ecd", F.silu(g) * u, params["w_down"].to(x.dtype))

    # Gather back + weighted combine.
    yflat = ye.reshape(e * cap, d)
    y_tok = torch.where(keep[:, None], yflat[torch.clamp(slot, 0, e * cap - 1)],
                        yflat.new_zeros(()))                      # (T*K, D)
    y = (y_tok.reshape(t, k, d) * weights[..., None].to(x.dtype)).sum(dim=1).reshape(b, s, d)

    if "shared" in params:
        sh = params["shared"]
        gg = x @ sh["w_gate"].to(x.dtype)
        uu = x @ sh["w_up"].to(x.dtype)
        y = y + (F.silu(gg) * uu) @ sh["w_down"].to(x.dtype)

    # Switch-style load-balance aux loss, over every token (dropped included).
    me = probs.mean(dim=0)                                        # (E,)
    hit = F.one_hot(experts, e).sum(dim=1) > 0                    # (T, E)
    ce = hit.to(torch.float32).mean(dim=0)
    aux = e * torch.sum(me * ce)
    return y, aux
