"""End-to-end driver on the PyTorch port: train a ~100M-param qwen2-family
model for a few hundred steps on the synthetic token pipeline.

  PYTHONPATH=src python examples/torch_train_lm.py               # the card
  PYTHONPATH=src python examples/torch_train_lm.py --device cpu  # the CPU

The twin of ``examples/train_lm.py``: the same ``CFG``, steps, batch,
optimizer settings and print format.  Its losses differ from that
example's, because the weights come from a seeded ``torch.Generator`` where
the JAX example draws from ``jax.random``; its own check is the last line's
``improved``.  ``tests/test_torch_train_*.py`` carry the JAX package's
weights across and hold the port's training step to its numbers.
"""
import argparse

import numpy as np
import torch

from repro_torch.data.tokens import DataConfig, make_batch
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import init_params, param_count
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
from repro_torch.train.train_step import make_train_step
from repro_torch.train.tree import tree_map

# ~100M-param config of the qwen2 family (structure from the assigned arch).
CFG = ModelConfig(
    name="qwen2-100m",
    family="dense",
    num_layers=8,
    d_model=512,
    n_heads=8,
    n_kv_heads=2,
    head_dim=64,
    d_ff=2048,
    vocab_size=32000,
    qkv_bias=True,
    rope_theta=1e6,
    tie_embeddings=True,
    dtype="float32",
    attn_chunk=128,
)

STEPS = 200
BATCH, SEQ = 8, 256


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    dev = torch.device(parser.parse_args().device)
    print(f"model: {CFG.name}, params = {param_count(CFG)/1e6:.1f}M")
    opt_cfg = OptimizerConfig(lr_peak=1e-3, warmup_steps=20, total_steps=STEPS)
    data_cfg = DataConfig(vocab_size=CFG.vocab_size, seq_len=SEQ, global_batch=BATCH)

    params = tree_map(lambda p: p.detach(), init_params(CFG, 0, device=dev).tree())
    opt_state = init_opt_state(params, opt_cfg)
    step_fn = make_train_step(CFG, opt_cfg)

    losses = []
    for step in range(STEPS):
        batch = {k: torch.as_tensor(v, device=dev) for k, v in make_batch(data_cfg, step).items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        if (step + 1) % 20 == 0:
            print(f"step {step+1:4d} loss {np.mean(losses[-20:]):.4f} "
                  f"lr {float(metrics['lr']):.2e}")
    print(f"loss: {losses[0]:.3f} -> {np.mean(losses[-10:]):.3f} "
          f"({'improved' if np.mean(losses[-10:]) < losses[0] else 'FAILED'})")


if __name__ == "__main__":
    main()
