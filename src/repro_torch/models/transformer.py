"""Composable decoder stack covering all ten assigned architectures:
training (``forward_train`` with autograd), prefill and decode.

Layers are grouped into homogeneous *segments* (``ModelConfig.segments()``)
whose parameters are stacked ``(count, ...)`` as in the JAX package; the
layer loop indexes ``w[i]`` where the JAX package scans.  Caches keep the
same ``(count, B, ...)`` layout, so both packages' weights and caches match
leaf for leaf.

Block kinds:
  dense     -- GQA attention + SwiGLU            (granite/qwen2/chatglm3/
                                                  musicgen/internvl2 LM)
  moe       -- attention (GQA or MLA) + MoE      (qwen3-moe, deepseek-v2)
  mamba2    -- Mamba-2 SSD block                 (mamba2-780m)
  pattern   -- RecurrentGemma period: each sub-layer is (RG-LRU | local
               attention) + SwiGLU, pattern e.g. ("rec","rec","attn")

Sharding: ``shd=`` takes a ``launch.sharding.Sharder``.  With a mesh,
the parameters (and the inputs, placed by ``launch.sharding.shard_tree``)
are DTensors; the Sharder constrains the residual stream between blocks,
K/V and the logits where the JAX package's does, and the model runs in its
``region()``, where the tensors the model makes for itself (positions,
masks, rope tables, scan states) are taken as replicated.  Without a mesh
(or ``shd=None``) nothing changes.

Every block has three modes: train (full seq, no cache), prefill (full seq,
emit cache), decode (one token, consume+emit cache).  Parameters are fp32
masters cast to the activation dtype at use.  ``forward_train`` runs under
the caller's grad mode, so autograd reaches every leaf through the ``w[i]``
indexing; with ``cfg.remat`` each layer is recomputed in the backward
(``torch.utils.checkpoint``, the JAX package's ``nothing_saveable``
policy).  ``prefill`` and ``decode_step`` run under ``torch.no_grad``.
"""
from __future__ import annotations

import contextlib
import functools
import math
from typing import Any, Dict

import numpy as np
import torch
from torch import nn
from torch.autograd.profiler import record_function
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from ..core.propagator import resolve_device
from ..nn import attention as attn_lib
from ..nn import mla as mla_lib
from ..nn import moe as moe_lib
from ..nn import rglru as rglru_lib
from ..nn import ssm as ssm_lib
from ..nn.ffn import swiglu
from ..nn.layers import (dense, embed, full_leaf, init_leaf, normal_leaf, rmsnorm,
                         sinusoidal_positions, unembed)
from ..nn.rope import apply_rope, rope_cos_sin
from .config import ModelConfig, _cache_specs

Params = Dict[str, Any]

def act_dtype(cfg: ModelConfig) -> torch.dtype:
    if cfg.dtype == "bfloat16":
        return torch.bfloat16
    if cfg.dtype == "float64":
        return torch.float64  # layout-equivalence tests / precision studies
    return torch.float32


def padded_vocab(cfg: ModelConfig) -> int:
    """Vocab padded to a multiple of 256 (MaxText-style padding).  The pad
    rows are ordinary random rows of the table and the pad logits take
    part in the greedy ``argmax``, as in the JAX package."""
    v = cfg.vocab_size
    return v if v % 256 == 0 else v + (256 - v % 256)


def _mla_cfg(cfg: ModelConfig) -> mla_lib.MLAConfig:
    return mla_lib.MLAConfig(
        d_model=cfg.d_model,
        n_heads=cfg.n_heads,
        q_lora_rank=cfg.q_lora_rank,
        kv_lora_rank=cfg.kv_lora_rank,
        qk_nope_dim=cfg.qk_nope_dim,
        qk_rope_dim=cfg.qk_rope_dim,
        v_dim=cfg.v_head_dim,
    )


def _moe_cfg(cfg: ModelConfig) -> moe_lib.MoEConfig:
    return moe_lib.MoEConfig(
        n_experts=cfg.n_experts,
        top_k=cfg.top_k,
        d_model=cfg.d_model,
        d_ff_expert=cfg.d_ff_expert,
        n_shared=cfg.n_shared,
        d_ff_shared=cfg.d_ff_shared,
        capacity_factor=cfg.capacity_factor,
    )


def _mamba_cfg(cfg: ModelConfig) -> ssm_lib.Mamba2Config:
    return ssm_lib.Mamba2Config(
        d_model=cfg.d_model,
        d_inner=cfg.d_inner,
        n_heads=cfg.ssm_heads,
        head_p=cfg.ssm_head_p,
        n_groups=cfg.ssm_groups,
        d_state=cfg.ssm_state,
        chunk=cfg.ssm_chunk,
    )


def _rglru_cfg(cfg: ModelConfig) -> rglru_lib.RGLRUConfig:
    return rglru_lib.RGLRUConfig(d_model=cfg.d_model, d_rnn=cfg.d_rnn)


def _n_sub(cfg: ModelConfig, kind: str) -> int:
    return len(cfg.layer_pattern) if kind == "pattern" else int(kind.replace("pattern_tail", ""))


# ---------------------------------------------------------------------------
# Parameter layout: leaf -> (shape, init rule), the JAX package's init_params
# ---------------------------------------------------------------------------


def _normal(*shape, scale):
    return normal_leaf(shape, scale)


def _const(value, *shape):
    return full_leaf(shape, value)


def _dense_spec(d_in: int, d_out: int, bias: bool):
    p = {"w": _normal(d_in, d_out, scale=d_in**-0.5)}
    if bias:
        p["b"] = _const(0.0, d_out)
    return p


def _norm_spec(d: int):
    return {"scale": _const(1.0, d)}


def _gqa_spec(cfg: ModelConfig):
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "wq": _dense_spec(d, h * hd, cfg.qkv_bias),
        "wk": _dense_spec(d, hkv * hd, cfg.qkv_bias),
        "wv": _dense_spec(d, hkv * hd, cfg.qkv_bias),
        "wo": _dense_spec(h * hd, d, False),
    }


def _swiglu_spec(d: int, d_ff: int):
    return {
        "w_gate": _normal(d, d_ff, scale=d**-0.5),
        "w_up": _normal(d, d_ff, scale=d**-0.5),
        "w_down": _normal(d_ff, d, scale=d_ff**-0.5),
    }


def _mamba_spec(cfg: ModelConfig):
    mc = _mamba_cfg(cfg)
    d, di, gn = mc.d_model, mc.d_inner, mc.n_groups * mc.d_state
    conv_ch = di + 2 * gn
    return {
        "in_proj": _normal(d, 2 * di + 2 * gn + mc.n_heads, scale=d**-0.5),
        "conv_w": _normal(mc.d_conv, conv_ch, scale=0.5),
        "conv_b": _const(0.0, conv_ch),
        "a_log": ((mc.n_heads,), ("a_log",)),  # log(linspace(1, 16, H))
        "dt_bias": _const(0.0, mc.n_heads),
        "d_skip": _const(1.0, mc.n_heads),
        "gate_norm": _norm_spec(di),
        "out_proj": _normal(di, d, scale=di**-0.5),
    }


def _rglru_spec(cfg: ModelConfig):
    rc = _rglru_cfg(cfg)
    d, dr = rc.d_model, rc.d_rnn
    return {
        "w_in": _normal(d, dr, scale=d**-0.5),
        "w_gate_branch": _normal(d, dr, scale=d**-0.5),
        "conv_w": _normal(rc.d_conv, dr, scale=0.5),
        "conv_b": _const(0.0, dr),
        "w_x": _normal(dr, dr, scale=dr**-0.5),
        "b_x": _const(0.0, dr),
        "w_a": _normal(dr, dr, scale=dr**-0.5),
        "b_a": _const(0.0, dr),
        "lam": _const(0.65, dr),
        "w_out": _normal(dr, d, scale=dr**-0.5),
    }


def _block_spec(kind: str, cfg: ModelConfig):
    if kind in ("dense", "moe"):
        attn = mla_lib.mla_spec(_mla_cfg(cfg)) if cfg.attn_type == "mla" else _gqa_spec(cfg)
        p = {"ln1": _norm_spec(cfg.d_model), "ln2": _norm_spec(cfg.d_model), "attn": attn}
        if kind == "dense":
            p["mlp"] = _swiglu_spec(cfg.d_model, cfg.d_ff)
        else:
            p["moe"] = moe_lib.moe_spec(_moe_cfg(cfg))
        return p
    if kind == "mamba2":
        return {"ln1": _norm_spec(cfg.d_model), "mix": _mamba_spec(cfg)}
    if kind.startswith("pattern"):
        p = {}
        for i in range(_n_sub(cfg, kind)):
            rec = cfg.layer_pattern[i] == "rec"
            p[f"sub{i}"] = {
                "ln1": _norm_spec(cfg.d_model),
                "ln2": _norm_spec(cfg.d_model),
                "mlp": _swiglu_spec(cfg.d_model, cfg.d_ff),
                "mix": _rglru_spec(cfg) if rec else _gqa_spec(cfg),
            }
        return p
    raise ValueError(kind)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def param_spec(cfg: ModelConfig):
    """The parameter tree of ``cfg`` with ``(shape, init rule)`` leaves, in
    the JAX package's ``init_params`` layout (segments stacked)."""
    vpad = padded_vocab(cfg)
    spec = {
        "embed": {"table": _normal(vpad, cfg.d_model, scale=1.0)},
        "final_norm": _norm_spec(cfg.d_model),
    }
    if not cfg.tie_embeddings:
        spec["lm_head"] = {"w": _normal(cfg.d_model, vpad, scale=cfg.d_model**-0.5)}
    spec["segments"] = [
        _map(lambda leaf, c=count: ((c,) + leaf[0], leaf[1]), _block_spec(kind, cfg))
        for kind, count in cfg.segments()
    ]
    return spec


# ---------------------------------------------------------------------------
# The module
# ---------------------------------------------------------------------------


class _Node(nn.Module):
    """A dict of the parameter tree: sub-dicts are modules, leaves parameters."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, sub in tree.items():
            if isinstance(sub, torch.Tensor):
                self.register_parameter(name, nn.Parameter(sub))
            else:
                self.add_module(name, _module(sub))


def _module(tree):
    if isinstance(tree, list):
        return nn.ModuleList([_module(t) for t in tree])
    return _Node(tree)


def _as_tree(mod: nn.Module):
    if isinstance(mod, nn.ModuleList):
        return [_as_tree(m) for m in mod]
    out = dict(mod.named_parameters(recurse=False))
    out.update((name, _as_tree(child)) for name, child in mod.named_children())
    return out


class Transformer(nn.Module):
    """The parameters of one model under the JAX package's leaf names
    (``embed.table``, ``segments.<i>.attn.wq.w``, ...), each segment's
    leaves stacked ``(count, ...)``.  ``tree()`` is the nested-dict view the
    functions of this module take; calling the module is
    :func:`forward_train`."""

    def __init__(self, cfg: ModelConfig, tree: Params):
        super().__init__()
        self.cfg = cfg
        for name, sub in tree.items():
            self.add_module(name, _module(sub))

    def tree(self) -> Params:
        return _as_tree(self)

    def numpy_tree(self) -> Params:
        """The weights as numpy arrays in the same tree: the form
        :func:`params_from_reference` takes (a copy on another device is
        ``params_from_reference(cfg, model.numpy_tree(), device)``)."""
        return _map(lambda t: t.detach().cpu().numpy(), self.tree())

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    def forward(self, tokens, frontend_embeds=None):
        return forward_train(self, self.cfg, tokens, frontend_embeds)


def _params(params) -> Params:
    return params.tree() if isinstance(params, Transformer) else params


def _generator(generator, dev: torch.device) -> torch.Generator:
    if isinstance(generator, torch.Generator):
        return generator
    return torch.Generator(device=dev).manual_seed(int(generator))


def init_params(cfg: ModelConfig, generator, device="cuda") -> Transformer:
    """Random fp32 master weights on ``device`` (CUDA by default; raises
    where there is none), drawn from ``generator`` (a ``torch.Generator`` or
    an int seed) with the JAX package's init rules.  JAX's PRNG is not
    reproduced: to hold the port against the JAX package, carry its weights
    over with :func:`params_from_reference`."""
    dev = resolve_device(device)
    gen = _generator(generator, dev)

    def make(leaf):
        shape, (rule, *_) = leaf
        if rule == "a_log":
            h = shape[-1]
            row = torch.log(torch.linspace(1.0, 16.0, h, dtype=torch.float32, device=dev))
            return row.expand(shape).clone()
        return init_leaf(gen, leaf, dev)

    return Transformer(cfg, _map(make, param_spec(cfg)))


def params_from_reference(cfg: ModelConfig, tree, device="cuda") -> Transformer:
    """The port's model holding the JAX package's ``init_params`` weights.

    ``tree`` is that pytree with numpy leaves
    (``jax.tree.map(np.asarray, params)``): nested dicts, a list of
    segments.  Raises ``ValueError`` if a reference leaf is left unused, a
    port parameter is left unset or a shape differs."""
    dev = resolve_device(device)

    def fill(spec, ref, path):
        if isinstance(spec, list):
            if not isinstance(ref, (list, tuple)) or len(ref) != len(spec):
                raise ValueError(f"{path}: {len(spec)} segments expected")
            return [fill(s, r, f"{path}.{i}") for i, (s, r) in enumerate(zip(spec, ref))]
        if isinstance(spec, dict):
            if not isinstance(ref, dict):
                raise ValueError(f"{path}: a dict of leaves expected")
            unused = sorted(set(ref) - set(spec))
            unset = sorted(set(spec) - set(ref))
            if unused:
                raise ValueError(f"reference leaves left unused: "
                                 f"{[f'{path}.{k}'.lstrip('.') for k in unused]}")
            if unset:
                raise ValueError(f"port parameters left unset: "
                                 f"{[f'{path}.{k}'.lstrip('.') for k in unset]}")
            return {k: fill(spec[k], ref[k], f"{path}.{k}") for k in spec}
        arr = np.asarray(ref)
        if arr.shape != spec[0]:
            raise ValueError(f"{path.lstrip('.')}: shape {arr.shape}, expected {spec[0]}")
        return torch.tensor(arr, dtype=torch.float32, device=dev)

    return Transformer(cfg, fill(param_spec(cfg), tree, ""))


# ---------------------------------------------------------------------------
# GQA attention sub-block
# ---------------------------------------------------------------------------


def _rot(cfg: ModelConfig) -> int:
    """Rotated head dims, rounded down to an even number."""
    rd = int(cfg.head_dim * cfg.partial_rotary)
    return rd - rd % 2


def _kv_for(shd, q, k, v):
    """K and V as the blockwise attention takes them.  Sharded over more
    "model" ranks than there are KV heads, each query head gets its own
    copy of its KV head, placed as the query heads are (each rank slices
    its own): grouping the query heads under too few KV heads cannot be
    split evenly, and DTensor would replicate every head on every rank.
    The values are the same."""
    if shd is None or shd.mesh is None or k.shape[1] % shd.model_size == 0:
        return k, v
    rep = q.shape[1] // k.shape[1]
    place = lambda t: t.repeat_interleave(rep, dim=1).redistribute(shd.mesh, q.placements)
    return place(k), place(v)


def gqa_apply(p, x, cfg: ModelConfig, mode, cos, sin, cache=None, pos=None,
              window=None, q_offset=0, shd=None):
    b, s, d = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    split = (lambda t, n: t) if shd is None else shd.heads
    q = split(dense(p["wq"], x), h).reshape(b, s, h, hd).transpose(1, 2)
    k = split(dense(p["wk"], x), hkv).reshape(b, s, hkv, hd).transpose(1, 2)
    v = split(dense(p["wv"], x), hkv).reshape(b, s, hkv, hd).transpose(1, 2)
    rd = _rot(cfg)
    if cfg.pos_type == "rope" and rd > 0:
        q = apply_rope(q, cos, sin, rotary_dim=rd)
        k = apply_rope(k, cos, sin, rotary_dim=rd)
    if shd is not None and mode != "decode":
        k = shd.kv(k)
        v = shd.kv(v)

    if mode == "decode":
        kc, vc = attn_lib.cache_update(cache["k"], cache["v"], k, v, pos, window)
        y = attn_lib.decode_attention(q, kc, vc, pos, window=window)
        new_cache = {"k": kc, "v": vc}
    else:
        y = attn_lib.blockwise_attention(
            q, *_kv_for(shd, q, k, v), causal=True, window=window,
            chunk_q=min(cfg.attn_chunk, s), chunk_k=min(cfg.attn_chunk, s),
            q_offset=q_offset, causal_skip=cfg.causal_skip,
        )
        new_cache = {"k": k, "v": v} if mode == "prefill" else None
    y = y.transpose(1, 2).reshape(b, s, h * hd)
    return dense(p["wo"], y), new_cache


# ---------------------------------------------------------------------------
# Block apply (one layer of a segment)
# ---------------------------------------------------------------------------


def _residual(shd, x):
    """The residual stream after a sub-block's add, constrained as between
    blocks: a TP projection leaves it a pending sum (``Partial``), which
    DTensor would otherwise carry into the next norm and projection, where
    it gathers the weights instead of reducing the activations."""
    return x if shd is None else shd.hidden(x)


def block_apply(kind: str, p, x, cfg: ModelConfig, mode, cos, sin,
                cache=None, pos=None, q_offset=0, shd=None):
    """Returns (x, new_cache, aux_loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind in ("dense", "moe"):
        h = rmsnorm(p["ln1"], x, cfg.norm_eps)
        if cfg.attn_type == "mla":
            if mode == "decode":
                y, (c, kr) = mla_lib.mla_decode(p["attn"], h, _mla_cfg(cfg), cos, sin,
                                                (cache["c"], cache["kr"]), pos)
                new_cache = {"c": c, "kr": kr}
            else:
                y, (c, kr) = mla_lib.mla_attention(p["attn"], h, _mla_cfg(cfg), cos, sin,
                                                   chunk=cfg.attn_chunk,
                                                   causal_skip=cfg.causal_skip)
                new_cache = {"c": c, "kr": kr} if mode == "prefill" else None
        else:
            y, new_cache = gqa_apply(
                p["attn"], h, cfg, mode, cos, sin, cache, pos,
                window=cfg.local_window, q_offset=q_offset, shd=shd,
            )
        x = _residual(shd, x + y)
        h2 = rmsnorm(p["ln2"], x, cfg.norm_eps)
        if kind == "dense":
            return x + swiglu(p["mlp"], h2), new_cache, aux
        ym, aux = moe_lib.moe_apply(p["moe"], h2, _moe_cfg(cfg))
        return x + ym, new_cache, aux

    if kind == "mamba2":
        h = rmsnorm(p["ln1"], x, cfg.norm_eps)
        if mode == "decode":
            y, (conv, hs) = ssm_lib.mamba2_decode(
                p["mix"], h, _mamba_cfg(cfg), (cache["conv"], cache["h"])
            )
            new_cache = {"conv": conv, "h": hs}
        else:
            y, (conv, hs) = ssm_lib.mamba2_forward(p["mix"], h, _mamba_cfg(cfg))
            new_cache = (
                {"conv": conv.to(x.dtype), "h": hs} if mode == "prefill" else None
            )
        return x + y, new_cache, aux

    if kind.startswith("pattern"):
        new_cache = {}
        for i in range(_n_sub(cfg, kind)):
            sk = cfg.layer_pattern[i]
            sub = p[f"sub{i}"]
            sub_cache = cache[f"sub{i}"] if cache is not None else None
            h = rmsnorm(sub["ln1"], x, cfg.norm_eps)
            if sk == "rec":
                if mode == "decode":
                    y, (hs, conv) = rglru_lib.rglru_block_decode(
                        sub["mix"], h, _rglru_cfg(cfg),
                        (sub_cache["h"], sub_cache["conv"]),
                    )
                    new_cache[f"sub{i}"] = {"h": hs, "conv": conv}
                else:
                    y, (hs, conv) = rglru_lib.rglru_block_forward(
                        sub["mix"], h, _rglru_cfg(cfg)
                    )
                    if mode == "prefill":
                        new_cache[f"sub{i}"] = {"h": hs, "conv": conv.to(x.dtype)}
            else:
                y, c_out = gqa_apply(
                    sub["mix"], h, cfg, mode, cos, sin, sub_cache, pos,
                    window=cfg.local_window, q_offset=q_offset, shd=shd,
                )
                if c_out is not None:
                    new_cache[f"sub{i}"] = c_out
            x = _residual(shd, x + y)
            h2 = rmsnorm(sub["ln2"], x, cfg.norm_eps)
            x = _residual(shd, x + swiglu(sub["mlp"], h2))
        return x, (new_cache if mode != "train" else None), aux

    raise ValueError(kind)


# ---------------------------------------------------------------------------
# Whole model: forward / prefill / decode
# ---------------------------------------------------------------------------


def _entry(fn):
    """A serving entry point over ``params`` (a :class:`Transformer` or its
    tree): runs without autograd, in ``shd``'s region."""

    @functools.wraps(fn)
    def run(params, cfg, *args, shd=None, **kw):
        with torch.no_grad(), _region(shd):
            return fn(_params(params), cfg, *args, shd=shd, **kw)

    return run


def _region(shd):
    if shd is None:
        return contextlib.nullcontext()
    if not callable(getattr(shd, "region", None)):
        raise TypeError(f"shd= takes a launch.sharding.Sharder, not {type(shd).__name__}")
    return shd.region()


def _device(params: Params) -> torch.device:
    return params["embed"]["table"].device


def _input(t, dev: torch.device):
    """An input on the weights' device; a DTensor (placed by the caller) as
    it is."""
    return t if isinstance(t, DTensor) else torch.as_tensor(t, device=dev)


def _rope_tables(cfg: ModelConfig, positions):
    if cfg.attn_type == "mla":
        return rope_cos_sin(positions, cfg.qk_rope_dim, cfg.rope_theta)
    rd = _rot(cfg)
    if cfg.pos_type != "rope" or rd == 0:
        return rope_cos_sin(positions, 2, cfg.rope_theta)  # dummy dim-2 tables
    return rope_cos_sin(positions, rd, cfg.rope_theta)


def _embed_inputs(params, cfg: ModelConfig, tokens, frontend_embeds=None):
    dev = _device(params)
    tokens = _input(tokens, dev).long()
    x = embed(params["embed"], tokens).to(act_dtype(cfg))
    if frontend_embeds is not None:
        # Modality stub: precomputed patch/frame embeddings prepended.
        fe = _input(frontend_embeds, dev)
        x = torch.cat([fe.to(x.dtype), x], dim=1)
    if cfg.pos_type == "sinusoidal":
        pos = torch.arange(x.shape[1], device=dev)
        x = x + sinusoidal_positions(pos, cfg.d_model, x.dtype)
    return x


def _index(tree, i: int):
    return _map(lambda a: a[i], tree)


def _stack(trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def _layer(kind, seg_params, li, x, cfg, mode, cos, sin, cache, pos, shd):
    if shd is None:
        return block_apply(kind, _index(seg_params, li), x, cfg, mode, cos, sin, cache, pos)
    with shd.region():  # also where a remat recompute runs it, in the backward
        return block_apply(kind, shd.gather(_index(seg_params, li)), shd.hidden(x), cfg, mode,
                           cos, sin, cache, pos, shd=shd)


def _run_segments(params, cfg: ModelConfig, x, mode, cos, sin, cache=None, pos=None,
                  shd=None):
    """Each segment's layers in order (``w[i]`` of the stacked leaves), the
    residual stream constrained by ``shd.hidden`` at each layer's entry.
    Returns (x, new_caches, aux_total).  A training forward with autograd
    on and ``cfg.remat`` keeps only each layer's input and recomputes the
    layer in the backward."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    new_caches = []
    remat = mode == "train" and cfg.remat and torch.is_grad_enabled()
    for idx, (kind, count) in enumerate(cfg.segments()):
        seg_params = params["segments"][idx]
        seg_cache = cache[idx] if cache is not None else None
        ncs = []
        for li in range(count):
            lc = _index(seg_cache, li) if seg_cache is not None else None
            args = (kind, seg_params, li, x, cfg, mode, cos, sin, lc, pos, shd)
            with record_function(f"segments/{idx}/{kind}"):  # the cost counter's label
                if remat:
                    x, nc, a = checkpoint(_layer, *args, use_reentrant=False)
                else:
                    x, nc, a = _layer(*args)
            aux_total = aux_total + a
            ncs.append(nc)
        new_caches.append(_stack(ncs) if mode != "train" else None)
    return x, new_caches, aux_total


def _logits(params, cfg: ModelConfig, x, shd=None):
    if cfg.tie_embeddings:
        return unembed(params["embed"], x)
    head = params["lm_head"] if shd is None else shd.gather(params["lm_head"])
    return dense(head, x)


def forward_train(params, cfg: ModelConfig, tokens, frontend_embeds=None, shd=None):
    """Full training forward -> (logits (B, S, V), aux (float32 MoE
    load-balance loss summed over layers)).  Runs under the caller's grad
    mode: wrap it in ``torch.no_grad`` to serve, differentiate it to train."""
    params = _params(params)
    with _region(shd):
        x = _embed_inputs(params, cfg, tokens, frontend_embeds)
        if shd is not None:
            x = shd.hidden(x)
        cos, sin = _rope_tables(cfg, torch.arange(x.shape[1], device=x.device))
        x, _, aux = _run_segments(params, cfg, x, "train", cos, sin, shd=shd)
        x = rmsnorm(params["final_norm"], _residual(shd, x), cfg.norm_eps)
        logits = _logits(params, cfg, x, shd)
        if shd is not None:
            logits = shd.logits(logits)
        return logits, aux


@_entry
def prefill(params, cfg: ModelConfig, tokens, frontend_embeds=None, shd=None):
    """Prefill -> (logits_last (B, 1, V), caches)."""
    x = _embed_inputs(params, cfg, tokens, frontend_embeds)
    if shd is not None:
        x = shd.hidden(x)
    cos, sin = _rope_tables(cfg, torch.arange(x.shape[1], device=x.device))
    x, caches, _ = _run_segments(params, cfg, x, "prefill", cos, sin, shd=shd)
    x = rmsnorm(params["final_norm"], _residual(shd, x)[:, -1:, :], cfg.norm_eps)
    return _logits(params, cfg, x, shd), caches


@_entry
def decode_step(params, cfg: ModelConfig, tokens, cache, pos, shd=None):
    """One decode step. tokens: (B, 1); pos: int index being written.
    Returns (logits (B, 1, V), new caches); ``cache`` is left as it was."""
    dev = _device(params)
    pos = int(pos)
    tokens = _input(tokens, dev).long()
    x = embed(params["embed"], tokens).to(act_dtype(cfg))
    if cfg.pos_type == "sinusoidal":
        x = x + sinusoidal_positions(
            torch.full((1,), pos, dtype=torch.int32, device=dev), cfg.d_model, x.dtype
        )
    cos, sin = _rope_tables(cfg, torch.arange(1, device=dev) + pos)
    x, new_caches, _ = _run_segments(params, cfg, x, "decode", cos, sin, cache=cache, pos=pos,
                                     shd=shd)
    x = rmsnorm(params["final_norm"], _residual(shd, x), cfg.norm_eps)
    return _logits(params, cfg, x, shd), new_caches


def init_cache(cfg: ModelConfig, batch: int, s_max: int, dtype=None, device="cuda"):
    """Zero-initialized decode cache (mirrors config._cache_specs).  ``dtype``
    is accepted for the JAX package's signature and, as there, unused."""
    del dtype
    dev = resolve_device(device)
    return _map(lambda s: torch.zeros(s.shape, dtype=s.dtype, device=dev),
                _cache_specs(cfg, batch, s_max))


def param_count(cfg: ModelConfig) -> int:
    return sum(math.prod(shape) for shape, _ in _leaves(param_spec(cfg)))


def active_param_count(cfg: ModelConfig) -> int:
    """Active params per token (MoE: top_k + shared experts only)."""
    total = param_count(cfg)
    if cfg.n_experts == 0:
        return total
    e, k = cfg.n_experts, cfg.top_k
    moe_layers = cfg.num_layers - cfg.first_k_dense
    per_expert = 3 * cfg.d_model * cfg.d_ff_expert
    return total - moe_layers * e * per_expert + moe_layers * k * per_expert
