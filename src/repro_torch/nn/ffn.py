"""Feed-forward blocks: SwiGLU (LLaMA-style) and plain GELU MLP.

The GELU is the tanh approximation, the JAX package's default
(``jax.nn.gelu(approximate=True)``), not PyTorch's erf form.
"""
from __future__ import annotations

import torch.nn.functional as F


def swiglu(params, x):
    g = x @ params["w_gate"].to(x.dtype)
    u = x @ params["w_up"].to(x.dtype)
    return (F.silu(g) * u) @ params["w_down"].to(x.dtype)


def gelu_mlp(params, x):
    h = F.gelu(x @ params["w_in"].to(x.dtype), approximate="tanh")
    return h @ params["w_out"].to(x.dtype)
