"""Serving: prefill + decode step factories, cache-layout conversion and the
greedy generation loop.

``serve_step`` is ONE new token against a KV cache of size ``s_max``.  The
functions run on the device of the model's weights (see
``models.transformer.init_params``: CUDA unless the caller asks for the
CPU).  ``mesh=`` (a ``DeviceMesh``) builds ``Sharder(mesh,
seq_shard=cfg.seq_shard)`` as the JAX package's does; the caller places
params, tokens and cache with ``launch.sharding.shard_tree``.
"""
from __future__ import annotations

import torch

from ..models.config import ModelConfig
from ..launch.sharding import Sharder
from ..models.transformer import _params, decode_step, prefill


def make_prefill_fn(cfg: ModelConfig, mesh=None):
    shd = Sharder(mesh, seq_shard=cfg.seq_shard)

    def prefill_fn(params, tokens, frontend_embeds=None):
        return prefill(params, cfg, tokens, frontend_embeds=frontend_embeds, shd=shd)

    return prefill_fn


def make_serve_step(cfg: ModelConfig, mesh=None):
    shd = Sharder(mesh, seq_shard=cfg.seq_shard)

    def serve_step(params, tokens, cache, pos):
        """tokens: (B, 1) new token ids; pos: int write position."""
        return decode_step(params, cfg, tokens, cache, pos, shd=shd)

    return serve_step


# ---------------------------------------------------------------------------
# Prefill-cache -> decode-cache layout conversion
# ---------------------------------------------------------------------------


def _pad_seq(x, s_max: int, axis: int):
    pad = s_max - x.shape[axis]
    if pad <= 0:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def _roll_window(k, window: int, s: int):
    """(..., S, D) prefill keys -> rolling (..., W, D) decode buffer where
    slot p % W holds position p, for p in [max(0, S-W), S)."""
    start = max(0, s - window)
    slots = torch.remainder(torch.arange(start, s, device=k.device), window)
    buf = k.new_zeros(k.shape[:-2] + (window, k.shape[-1]))
    buf[..., slots, :] = k[..., start:s, :]
    return buf


def prefill_to_decode_cache(cfg: ModelConfig, caches, s_prefill: int, s_max: int):
    """Convert prefill-emitted caches to the decode layout used by
    init_cache/_cache_specs (pad full-attn KV to s_max; roll local windows;
    SSM and RG-LRU states pass through)."""
    out = []
    for idx, (kind, count) in enumerate(cfg.segments()):
        c = caches[idx]
        if kind == "mamba2":
            out.append(c)
            continue
        if kind.startswith("pattern"):
            sub_out = {}
            for name, sub in c.items():
                if "k" in sub:  # local attention: roll into window buffer
                    sub_out[name] = {
                        "k": _roll_window(sub["k"], cfg.local_window, s_prefill),
                        "v": _roll_window(sub["v"], cfg.local_window, s_prefill),
                    }
                else:
                    sub_out[name] = sub
            out.append(sub_out)
            continue
        if cfg.attn_type == "mla":
            out.append(
                {
                    "c": _pad_seq(c["c"], s_max, axis=2),
                    "kr": _pad_seq(c["kr"], s_max, axis=2),
                }
            )
            continue
        if cfg.local_window is not None:
            out.append(
                {
                    "k": _roll_window(c["k"], cfg.local_window, s_prefill),
                    "v": _roll_window(c["v"], cfg.local_window, s_prefill),
                }
            )
        else:
            out.append(
                {
                    "k": _pad_seq(c["k"], s_max, axis=3),
                    "v": _pad_seq(c["v"], s_max, axis=3),
                }
            )
    return out


def generate(params, cfg: ModelConfig, tokens, steps: int, s_max: int,
             frontend_embeds=None, mesh=None, greedy: bool = True, key=None):
    """Generation loop: prefill then ``steps - 1`` decode steps, greedy.

    Runs under ``torch.inference_mode`` on the device of ``params`` (a
    ``Transformer`` or its tree) and returns ``(B, steps)`` int32 token ids.
    ``greedy`` and ``key`` are accepted for the JAX package's signature and
    unused: its loop, like this one, always takes the ``argmax`` over the
    padded vocabulary (ties to the lowest id)."""
    del greedy, key
    prefill_fn = make_prefill_fn(cfg, mesh)
    serve_fn = make_serve_step(cfg, mesh)
    with torch.inference_mode():
        tree = _params(params)
        dev = tree["embed"]["table"].device
        tokens = torch.as_tensor(tokens, device=dev)
        logits, caches = prefill_fn(tree, tokens, frontend_embeds)
        s0 = tokens.shape[1] + (
            frontend_embeds.shape[1] if frontend_embeds is not None else 0
        )
        cache = prefill_to_decode_cache(cfg, caches, s0, s_max)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        out = [tok]
        for i in range(steps - 1):
            logits, cache = serve_fn(tree, tok, cache, s0 + i)
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
            out.append(tok)
        return torch.cat(out, dim=1)
