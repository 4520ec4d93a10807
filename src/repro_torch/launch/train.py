"""End-to-end training driver with checkpoint/restart (fault tolerance).

Example (CPU, reduced config):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b --smoke \
      --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt --device cpu

The driver auto-resumes from the newest checkpoint: kill it at any step and
rerun the same command -- it continues where it left off (the data pipeline
is stateless-deterministic, so the token stream realigns exactly).  It runs
on the card unless ``--device cpu`` is given.  The modality stubs' frontend
embeddings of each step come from a ``torch.Generator`` seeded from
``(seed, step)`` (the JAX package folds the step into a ``jax.random``
key), so they too are the same after a resume.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config
from ..core.propagator import resolve_device
from ..data.tokens import DataConfig, make_batch
from ..models.transformer import init_params
from ..train.checkpoint import AsyncCheckpointer, restore_checkpoint
from ..train.optimizer import OptimizerConfig, init_opt_state
from ..train.train_step import make_train_step
from ..train.tree import tree_map


def frontend_embeds(seed: int, step: int, shape, device) -> torch.Tensor:
    """The step's frontend embeddings: ``N(0, 0.02^2)`` from a generator
    seeded from ``(seed, step)``."""
    s = int(np.random.SeedSequence([seed, step]).generate_state(1)[0])
    gen = torch.Generator(device=device).manual_seed(s)
    return torch.randn(shape, generator=gen, device=device) * 0.02


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    opt_cfg = OptimizerConfig(
        lr_peak=args.lr, warmup_steps=max(10, args.steps // 10),
        total_steps=args.steps,
    )
    data_cfg = DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch, seed=args.seed,
    )

    params = tree_map(lambda p: p.detach(), init_params(cfg, args.seed, device=dev).tree())
    opt_state = init_opt_state(params, opt_cfg)
    start_step = 0

    ckpt = None
    if args.ckpt_dir:
        ckpt = AsyncCheckpointer(args.ckpt_dir)
        (params, opt_state), start_step = restore_checkpoint(
            args.ckpt_dir, (params, opt_state)
        )
        if start_step:
            print(f"[resume] restored step {start_step} from {args.ckpt_dir}")

    step_fn = make_train_step(cfg, opt_cfg, mesh=None, microbatches=args.microbatches)

    losses = []
    t0 = time.time()
    for step in range(start_step, args.steps):
        batch = {k: torch.as_tensor(v, device=dev) for k, v in make_batch(data_cfg, step).items()}
        if cfg.frontend != "none":
            batch["frontend_embeds"] = frontend_embeds(
                args.seed, step, (args.batch, cfg.n_frontend_tokens, cfg.d_model), dev)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        if (step + 1) % args.log_every == 0:
            rate = (step + 1 - start_step) * args.batch * args.seq / (
                time.time() - t0
            )
            print(
                f"step {step+1:5d} loss {losses[-1]:.4f} "
                f"ce {float(metrics['ce']):.4f} "
                f"gnorm {float(metrics['grad_norm']):.3f} "
                f"lr {float(metrics['lr']):.2e} tok/s {rate:,.0f}",
                flush=True,
            )
        if ckpt and (step + 1) % args.ckpt_every == 0:
            ckpt.save(step + 1, (params, opt_state))
    if ckpt:
        ckpt.save(args.steps, (params, opt_state))
        ckpt.wait()
    first, last = losses[0], np.mean(losses[-5:])
    print(f"[done] loss {first:.4f} -> {last:.4f} "
          f"({'improved' if last < first else 'NO IMPROVEMENT'})")
    return losses


if __name__ == "__main__":
    main()
