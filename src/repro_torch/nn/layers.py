"""Basic layers: norms, dense projections, embeddings (pure-function style).

Parameters are plain nested dicts of tensors (fp32 masters); every layer is
``apply(params, x, ...) -> y`` and casts its weights to the activation dtype
at use.  Norm statistics are a float32 island at every activation dtype, as
in the JAX package (float64 activations included).
"""
from __future__ import annotations

import math

import torch


def normal_init(gen: torch.Generator, shape, scale: float = 0.02, device=None):
    """fp32 ``N(0, scale^2)`` drawn from ``gen`` (on ``gen``'s device), then
    moved to ``device``."""
    x = torch.randn(tuple(shape), generator=gen, device=gen.device, dtype=torch.float32)
    return (x * scale).to(device or gen.device)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm(params, x, eps: float = 1e-6):
    h = x.to(torch.float32)
    var = torch.mean(h * h, dim=-1, keepdim=True)
    h = h * torch.rsqrt(var + eps)
    return (h * params["scale"].to(torch.float32)).to(x.dtype)


def layernorm(params, x, eps: float = 1e-5):
    h = x.to(torch.float32)
    mu = torch.mean(h, dim=-1, keepdim=True)
    var = torch.var(h, dim=-1, keepdim=True, unbiased=False)
    h = (h - mu) * torch.rsqrt(var + eps)
    h = h * params["scale"].to(torch.float32) + params["bias"].to(torch.float32)
    return h.to(x.dtype)


# ---------------------------------------------------------------------------
# Dense
# ---------------------------------------------------------------------------


def dense(params, x):
    y = x @ params["w"].to(x.dtype)
    if "b" in params:
        y = y + params["b"].to(x.dtype)
    return y


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------


def embed(params, tokens):
    return params["table"][tokens]


def unembed(params, x):
    """Tied read-out: logits = x @ table^T."""
    return x @ params["table"].to(x.dtype).T


def sinusoidal_positions(positions, d: int, dtype=torch.float32):
    """Classic sin/cos absolute embedding (MusicGen-style backbone stub),
    computed in float32 and cast to ``dtype``."""
    half = d // 2
    ar = torch.arange(half, dtype=torch.float32, device=positions.device)
    freqs = torch.exp(-math.log(10000.0) * ar / half)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)
