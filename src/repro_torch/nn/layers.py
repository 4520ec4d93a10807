"""Basic layers: norms, dense projections, embeddings (pure-function style).

Parameters are plain nested dicts of tensors (fp32 masters); every layer is
``apply(params, x, ...) -> y`` and casts its weights to the activation dtype
at use.  Norm statistics are a float32 island at every activation dtype, as
in the JAX package (float64 activations included).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate


def normal_init(gen: torch.Generator, shape, scale: float = 0.02, device=None):
    """fp32 ``N(0, scale^2)`` drawn from ``gen`` (on ``gen``'s device), then
    moved to ``device``."""
    x = torch.randn(tuple(shape), generator=gen, device=gen.device, dtype=torch.float32)
    return (x * scale).to(device or gen.device)


def normal_leaf(shape, scale: float):
    """A parameter-spec leaf: ``(shape, ("normal", scale))``."""
    return (tuple(shape), ("normal", scale))


def full_leaf(shape, value: float):
    """A parameter-spec leaf: ``(shape, ("full", value))``."""
    return (tuple(shape), ("full", value))


def init_leaf(gen: torch.Generator, leaf, device=None):
    """The fp32 tensor of one :func:`normal_leaf` / :func:`full_leaf`."""
    shape, (rule, arg) = leaf
    if rule == "normal":
        return normal_init(gen, shape, arg, device)
    if rule == "full":
        return torch.full(shape, arg, dtype=torch.float32, device=device or gen.device)
    raise ValueError(f"unknown init rule {rule!r}")


def init_from_spec(gen: torch.Generator, spec, device=None):
    """fp32 tensors for a dict tree of :func:`normal_leaf` / :func:`full_leaf`
    leaves, the normal ones drawn from ``gen`` in the tree's order."""
    if isinstance(spec, dict):
        return {k: init_from_spec(gen, v, device) for k, v in spec.items()}
    return init_leaf(gen, spec, device)


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
    """The table's rows of ``tokens``; a DTensor table (vocab-sharded)
    looks them up by ``F.embedding``, which DTensor computes on each
    rank's vocab slice, and the slices' rows are summed at once (the same
    rows)."""
    table = params["table"]
    if isinstance(table, DTensor):
        rows = F.embedding(tokens, table)
        done = [Replicate() if p.is_partial() else p for p in rows.placements]
        return rows.redistribute(rows.device_mesh, done)
    return table[tokens]


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
