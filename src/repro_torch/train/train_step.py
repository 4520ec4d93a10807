"""Training step: CE loss (+MoE aux), grad accumulation, AdamW.

``make_train_step(cfg, opt_cfg)`` returns a function
``(params, opt_state, batch) -> (params, opt_state, metrics)`` that runs on
the device of the params (CUDA unless the model was made on the CPU).
``params`` is a :class:`~repro_torch.models.Transformer` or its tree of
fp32 masters; the new params come back as a tree in the same layout
(``Transformer(cfg, tree)`` wraps one as a module).  ``mesh=`` is accepted
only as ``None`` (sharding is ROADMAP Queue 1 item 15, part three).

As in the JAX package, the gradient is taken with respect to copies of the
masters in the compute dtype (bfloat16 grads under ``dtype="bfloat16"``);
the fp32 masters appear only in the update.
"""
from __future__ import annotations

import torch

from ..models.config import ModelConfig
from ..models.transformer import _params, check_unsharded, forward_train
from .optimizer import OptimizerConfig, adamw_update, state_dtype
from .tree import leaves, tree_map, unflatten

F32 = torch.float32


def cross_entropy(logits, labels):
    """Mean CE over all positions; float32 ``log_softmax`` over the (padded)
    vocabulary."""
    logp = torch.log_softmax(logits.to(F32), dim=-1)
    ll = logp.gather(-1, labels[..., None].long())[..., 0]
    return -torch.mean(ll)


def _on(batch: dict, dev: torch.device) -> dict:
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items() if v is not None}


def make_loss_fn(cfg: ModelConfig, shd=None):
    """``loss_fn(params, batch) -> (total, {"ce", "moe_aux"})``, differentiable."""
    check_unsharded(shd)

    def loss_fn(params, batch):
        params = _params(params)
        batch = _on(batch, params["embed"]["table"].device)
        logits, aux = forward_train(params, cfg, batch["tokens"],
                                    frontend_embeds=batch.get("frontend_embeds"))
        labels = batch["labels"]
        # Modality stubs prepend frontend tokens; loss is on text positions.
        logits = logits[:, -labels.shape[1]:, :]
        loss = cross_entropy(logits, labels)
        total = loss + cfg.moe_aux_coef * aux
        return total, {"ce": loss, "moe_aux": aux}

    return loss_fn


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
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(inputs, grads)]
        parts = {k: v.detach() for k, v in parts.items()}
        return (total.detach(), parts), unflatten(params, grads)

    return grad_fn


def make_train_step(cfg: ModelConfig, opt_cfg: OptimizerConfig, mesh=None,
                    microbatches: int = 1):
    check_unsharded(mesh=mesh)
    grad_fn = value_and_grad(make_loss_fn(cfg))
    compute_dt = torch.bfloat16 if cfg.dtype == "bfloat16" else F32

    def cast_params(params):
        # True mixed precision: differentiate w.r.t. the compute-dtype copy so
        # grads are bf16 under bfloat16; fp32 masters live in the update only.
        return tree_map(lambda p: p.detach().to(compute_dt) if p.dtype == F32 else p.detach(),
                        params)

    def train_step(params, opt_state, batch):
        params = _params(params)
        cparams = cast_params(params)
        if microbatches == 1:
            (loss, parts), grads = grad_fn(cparams, batch)
        else:
            # Gradient accumulation over microbatch slices; the accumulator
            # is state_dtype, each add in float32.
            acc_dt = state_dtype(opt_cfg)
            dev = params["embed"]["table"].device
            batch = _on(batch, dev)
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=acc_dt, device=dev), params)
            loss = torch.zeros((), dtype=F32, device=dev)
            for i in range(microbatches):
                mb = {k: v.reshape(microbatches, -1, *v.shape[1:])[i] for k, v in batch.items()}
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
