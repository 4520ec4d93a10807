"""Serving example on the PyTorch port: prefill + batched greedy decoding
with a KV cache (rolling-window for the hybrid arch), across three cache
families (full attention, RG-LRU + local attention, Mamba-2 states).

  PYTHONPATH=src python examples/torch_serve_lm.py               # the card
  PYTHONPATH=src python examples/torch_serve_lm.py --device cpu  # the CPU

The twin of ``examples/serve_lm.py``: the same archs (SMOKE configs),
shapes and print format.  Its samples differ from that example's, because
the weights and the prompt come from a seeded ``torch.Generator`` where the
JAX example draws from ``jax.random``; ``tests/test_torch_lm_*.py`` carry
the JAX package's weights across and hold the port to its tokens.
"""
import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.models import init_params
from repro_torch.train.serve_step import generate


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    dev = parser.parse_args().device
    for arch in ("qwen2-0.5b", "recurrentgemma-9b", "mamba2-780m"):
        cfg = get_config(arch, smoke=True)
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        b, s_prompt, steps, s_max = 4, 16, 24, 64
        prompt = torch.randint(0, cfg.vocab_size, (b, s_prompt), device=dev,
                               generator=torch.Generator(device=dev).manual_seed(1))
        fe = None
        if cfg.frontend != "none":
            fe = torch.zeros((b, cfg.n_frontend_tokens, cfg.d_model), device=dev)
        if dev == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = generate(params, cfg, prompt, steps=steps, s_max=s_max, frontend_embeds=fe)
        dt = time.perf_counter() - t0
        print(f"{arch:20s} ({cfg.family:6s}): generated {tuple(out.shape)} tokens in "
              f"{dt:.2f}s -- sample: {out[0, :10].tolist()}")


if __name__ == "__main__":
    main()
