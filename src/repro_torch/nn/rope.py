"""Rotary position embeddings, including partial-rotary (ChatGLM3's 2d-RoPE
applies rotation to half the head dimension; the other half is untouched).

The tables are float32 at every activation dtype, and pairs are interleaved
``(x[2i], x[2i+1])`` -- not the half-split ``rotate_half`` convention.
"""
from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float = 10000.0, device=None):
    """Inverse frequencies for the rotated part (head_dim must be even)."""
    return 1.0 / (
        theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim)
    )


def rope_cos_sin(positions, head_dim: int, theta: float = 10000.0):
    """cos/sin tables at given positions. positions: (...,) int -> (..., hd/2)."""
    inv = rope_freqs(head_dim, theta, device=positions.device)
    ang = positions.to(torch.float32)[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin, rotary_dim: int | None = None):
    """Rotate the first ``rotary_dim`` dims of the head dimension.

    x: (..., S, head_dim); cos/sin: (S, rotary_dim/2) broadcastable.
    Pairs are (x[2i], x[2i+1]) -- interleaved convention.
    """
    hd = x.shape[-1]
    rd = rotary_dim if rotary_dim is not None else hd
    xr = x[..., :rd]
    x_pass = x[..., rd:]
    x1 = xr[..., 0::2]
    x2 = xr[..., 1::2]
    cos = cos.to(x.dtype)
    sin = sin.to(x.dtype)
    y1 = x1 * cos - x2 * sin
    y2 = x1 * sin + x2 * cos
    yr = torch.stack([y1, y2], dim=-1).reshape(xr.shape)
    if rd == hd:
        return yr
    return torch.cat([yr, x_pass], dim=-1)
