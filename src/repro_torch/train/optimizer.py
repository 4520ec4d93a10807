"""AdamW + cosine schedule + global-norm clipping, from scratch.

Optimizer state is a tree of ``(m, v)`` mirroring the (fp32 master) params
tree, stored in ``state_dtype``.  An optional int8 gradient-compression hook
(error feedback) quantizes gradients and keeps the residual.

Functional, as the JAX package's: every function returns new trees and
leaves its arguments as they were; the update runs under ``torch.no_grad``.
The schedule and the bias corrections are float32 arithmetic on the int32
step (0-dim tensors on the step's device), and every Python constant is
rounded to float32 before it meets a float32 tensor, as JAX's weak types
round it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import numpy as np
import torch

from .tree import leaves, tree_map

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr_peak: float = 3e-4
    lr_min: float = 3e-5
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    grad_compress: bool = False  # int8 + error feedback
    # "bfloat16" halves m/v + grad-accum residency.
    state_dtype: str = "float32"


class OptState(NamedTuple):
    m: Any
    v: Any
    step: torch.Tensor  # int32, 0-dim
    ef: Any  # error-feedback residuals (0-dim zeros unless grad_compress)


def state_dtype(cfg: OptimizerConfig) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[cfg.state_dtype]


def _f(x: float) -> float:
    """``x`` rounded to float32 (a JAX weak-typed scalar meeting float32)."""
    return float(np.float32(x))


def cosine_lr(cfg: OptimizerConfig, step):
    step = torch.as_tensor(step).to(F32)
    warm = step * _f(cfg.lr_peak) / _f(max(1.0, cfg.warmup_steps))
    t = (step - _f(cfg.warmup_steps)) / _f(max(1.0, cfg.total_steps - cfg.warmup_steps))
    t = torch.clamp(t, 0.0, 1.0)
    cos = _f(cfg.lr_min) + _f(0.5 * (cfg.lr_peak - cfg.lr_min)) * (1 + torch.cos(_f(math.pi) * t))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params, cfg: OptimizerConfig) -> OptState:
    sdt = state_dtype(cfg)
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=sdt, device=p.device), params)
    if cfg.grad_compress:
        ef = tree_map(lambda p: torch.zeros(p.shape, dtype=F32, device=p.device), params)
    else:
        ef = tree_map(lambda p: torch.zeros((), dtype=F32, device=p.device), params)
    dev = leaves(params)[0].device
    return OptState(m=zeros, v=tree_map(torch.clone, zeros),
                    step=torch.zeros((), dtype=torch.int32, device=dev), ef=ef)


def global_norm(tree):
    return torch.sqrt(sum(torch.sum(torch.square(g.to(F32))) for g in leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp_max(_f(max_norm) / torch.clamp_min(norm, _f(1e-9)), 1.0)
    # Keep each leaf's dtype (a float32 scale would promote bf16 trees).
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


def _quantize_int8(g):
    absmax = torch.clamp_min(torch.max(torch.abs(g)), _f(1e-12))
    q = torch.round(g / absmax * 127.0).to(torch.int8)  # half to even, as jnp.round
    return q.to(F32) * (absmax / 127.0)


def compress_grads(grads, ef):
    """int8 quantization with error feedback: g' = Q(g + ef); ef' = g+ef-g'."""
    gf = tree_map(lambda g, e: g.to(F32) + e, grads, ef)
    gq = tree_map(_quantize_int8, gf)
    return gq, tree_map(torch.sub, gf, gq)


@torch.no_grad()
def adamw_update(params, grads, state: OptState, cfg: OptimizerConfig):
    """One AdamW step. Returns (new_params, new_state, metrics).

    Grads keep their incoming dtype; each leaf is widened to float32 inside
    its own update.  New params keep each master's dtype; ``m`` and ``v``
    are stored in ``state_dtype``."""
    if cfg.grad_compress:
        grads, ef = compress_grads(grads, state.ef)
    else:
        ef = state.ef
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)

    step = state.step + 1
    lr = cosine_lr(cfg, step)
    b1c = 1 - torch.pow(torch.tensor(_f(cfg.b1), device=step.device), step.to(F32))
    b2c = 1 - torch.pow(torch.tensor(_f(cfg.b2), device=step.device), step.to(F32))
    sdt = state_dtype(cfg)
    b1, b2, c1, c2 = _f(cfg.b1), _f(cfg.b2), _f(1 - cfg.b1), _f(1 - cfg.b2)
    eps, wd = _f(cfg.eps), _f(cfg.weight_decay)

    def upd(p, g, m, v):
        g = g.to(F32)
        m2 = b1 * m.to(F32) + c1 * g
        v2 = b2 * v.to(F32) + c2 * g * g
        mh = m2 / b1c
        vh = v2 / b2c
        delta = mh / (torch.sqrt(vh) + eps) + wd * p.to(F32)
        new_p = (p.to(F32) - lr * delta).to(p.dtype)
        return new_p, m2.to(sdt), v2.to(sdt)

    out = tree_map(upd, params, grads, state.m, state.v)
    new_params, new_m, new_v = (_pick(out, params, i) for i in range(3))
    return (new_params, OptState(m=new_m, v=new_v, step=step, ef=ef),
            {"grad_norm": gnorm, "lr": lr})


def _pick(out, like, i: int):
    """The ``i``-th of each leaf's result tuple of a :func:`tree_map` over ``like``."""
    return tree_map(lambda _, t: t[i], like, out)
