"""Training step: CE loss (+MoE aux), grad accumulation, AdamW.

``make_train_step(cfg, opt_cfg)`` returns a function
``(params, opt_state, batch) -> (params, opt_state, metrics)`` that runs on
the device of the params (CUDA unless the model was made on the CPU).
``params`` is a :class:`~repro_torch.models.Transformer` or its tree of
fp32 masters; the new params come back as a tree in the same layout
(``Transformer(cfg, tree)`` wraps one as a module).  With ``mesh=`` (a
``DeviceMesh``) the step builds ``Sharder(mesh, seq_shard=cfg.seq_shard)``
as the JAX package's does; the caller places params, optimizer state and
batch on the mesh with ``launch.sharding.shard_tree`` (the counterpart of
``jit(in_shardings=...)``), and the new params and state come back as
DTensors on the same placements.

As in the JAX package, the gradient is taken with respect to copies of the
masters in the compute dtype (bfloat16 grads under ``dtype="bfloat16"``);
the fp32 masters appear only in the update.
"""
from __future__ import annotations

import contextlib

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from ..launch.sharding import Sharder, _Constrain
from ..models.config import ModelConfig
from ..models.transformer import _input, _params, forward_train
from .optimizer import OptimizerConfig, adamw_update, state_dtype
from .tree import leaves, tree_map, unflatten

F32 = torch.float32


def cross_entropy(logits, labels):
    """Mean CE over all positions; float32 ``log_softmax`` over the (padded)
    vocabulary.  Logits that are a DTensor (vocab TP-sharded) take
    :func:`_sharded_cross_entropy`."""
    if isinstance(logits, DTensor):
        return _sharded_cross_entropy(logits, labels)
    logp = torch.log_softmax(logits.to(F32), dim=-1)
    ll = logp.gather(-1, labels[..., None].long())[..., 0]
    return -torch.mean(ll)


def _sharded_cross_entropy(logits, labels):
    """CE over vocab-sharded logits by the partial reductions XLA inserts
    for the JAX package: each rank reduces its own vocab slice (max, sum
    of exponentials, the label's logit, picked by comparing the labels
    with this rank's vocab ids) and the ``(B, S)`` sums are completed
    across ranks, their gradients placed as they are (else DTensor splits
    them over "model" and gathers the logits' gradient).  DTensor's
    ``log_softmax`` and ``gather`` would gather the whole vocab on every
    rank (and ``gather``'s backward allocates the global logits on each)."""
    x = logits.to(F32)
    mesh, last = x.device_mesh, x.ndim - 1
    tokens = [Replicate() if getattr(p, "dim", None) == last else p for p in x.placements]
    vocab = [Shard(0) if getattr(p, "dim", None) == last else Replicate() for p in x.placements]
    ids = distribute_tensor(torch.arange(x.shape[-1], device=x.to_local().device), mesh, vocab,
                            src_data_rank=None)
    z = x - x.amax(dim=-1, keepdim=True).detach()  # the max shifts nothing
    total = lambda t: _Constrain.apply(t.sum(dim=-1), mesh, tokens)
    lse = torch.log(total(torch.exp(z)))
    picked = total(z * (labels[..., None].long() == ids))
    return -torch.mean(picked - lse)


def _on(batch: dict, dev: torch.device) -> dict:
    return {k: _input(v, dev) for k, v in batch.items() if v is not None}


def make_loss_fn(cfg: ModelConfig, shd=None):
    """``loss_fn(params, batch) -> (total, {"ce", "moe_aux"})``, differentiable."""

    def loss_fn(params, batch):
        params = _params(params)
        batch = _on(batch, params["embed"]["table"].device)
        logits, aux = forward_train(params, cfg, batch["tokens"],
                                    frontend_embeds=batch.get("frontend_embeds"), shd=shd)
        with contextlib.nullcontext() if shd is None else shd.region():
            labels = batch["labels"]
            # Modality stubs prepend frontend tokens; loss is on text positions.
            if logits.shape[1] != labels.shape[1]:
                logits = logits[:, -labels.shape[1]:, :]
            loss = cross_entropy(logits, labels)
            total = loss + cfg.moe_aux_coef * aux
        return total, {"ce": loss, "moe_aux": aux}

    return loss_fn


def _placed_like(g, p):
    """A DTensor gradient on its parameter's placement (as JAX shards a
    gradient like its parameter): a pending sum over the data axes is
    reduced now -- all-reduced for a replicated parameter, reduce-scattered
    for a sharded one -- not by whichever optimizer op meets it first."""
    if isinstance(g, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def value_and_grad(loss_fn):
    """``grad_fn(params, batch) -> ((total, parts), grads)``: the loss and its
    gradient with respect to every leaf of ``params`` (a tree), detached;
    a leaf the loss does not reach gets zeros."""

    def grad_fn(params, batch):
        flat = leaves(params)
        with torch.enable_grad():
            inputs = [p.detach().requires_grad_() for p in flat]
            total, parts = loss_fn(unflatten(params, inputs), batch)
            grads = torch.autograd.grad(total, inputs, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else _placed_like(g, p)
                 for p, g in zip(inputs, grads)]
        parts = {k: v.detach() for k, v in parts.items()}
        return (total.detach(), parts), unflatten(params, grads)

    return grad_fn


def make_train_step(cfg: ModelConfig, opt_cfg: OptimizerConfig, mesh=None,
                    microbatches: int = 1):
    shd = Sharder(mesh, seq_shard=cfg.seq_shard)
    grad_fn = value_and_grad(make_loss_fn(cfg, shd))
    compute_dt = torch.bfloat16 if cfg.dtype == "bfloat16" else F32

    def cast_params(params):
        # True mixed precision: differentiate w.r.t. the compute-dtype copy so
        # grads are bf16 under bfloat16; fp32 masters live in the update only.
        return tree_map(lambda p: p.detach().to(compute_dt) if p.dtype == F32 else p.detach(),
                        params)

    def train_step(params, opt_state, batch):
        with shd.region():
            return step(_params(params), opt_state, batch)

    def step(params, opt_state, batch):
        cparams = cast_params(params)
        if microbatches == 1:
            (loss, parts), grads = grad_fn(cparams, batch)
        else:
            # Gradient accumulation over microbatch slices; the accumulator
            # is state_dtype, each add in float32.
            acc_dt = state_dtype(opt_cfg)
            dev = params["embed"]["table"].device
            # The global batch whole on every rank (once; token ids are
            # small), so that slice i of it is the JAX package's microbatch
            # i: a slice of a dim split over the data ranks has no DTensor
            # rule.  Each slice is placed back over the data axes.
            batch = {k: shd.whole(v) for k, v in _on(batch, dev).items()}
            grads = tree_map(lambda p: torch.zeros_like(p, dtype=acc_dt), params)
            loss = torch.zeros((), dtype=F32, device=dev)
            for i in range(microbatches):
                mb = {k: shd.batch(v.reshape(microbatches, -1, *v.shape[1:])[i])
                      for k, v in batch.items()}
                (l, _), g = grad_fn(cparams, mb)
                grads = tree_map(lambda a, gg: (a.to(F32) + gg.to(F32)).to(acc_dt), grads, g)
                loss = loss + l
            grads = tree_map(lambda g: g / microbatches, grads)
            loss = loss / microbatches
            parts = {"ce": loss, "moe_aux": torch.zeros((), dtype=F32, device=dev)}

        params, opt_state, opt_metrics = adamw_update(params, grads, opt_state, opt_cfg)
        metrics = {"loss": loss, **parts, **opt_metrics}
        return params, opt_state, metrics

    return train_step
