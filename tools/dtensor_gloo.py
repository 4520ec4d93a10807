#!/usr/bin/env python3
"""Does gloo carry DTensor's collectives with this machine's PyTorch, on CPU
tensors and on CUDA tensors?  Each case runs in a world of four gloo ranks
of its own (``repro_torch.core.run_world``; with CUDA tensors the four
ranks share card 0), so that a rank that dies fails that case alone:

1. ``collective``: one DTensor redistribution of each kind the sharded LM
   step issues, on a ``(4,)`` mesh and a (64, 32) float32 tensor:
   all-gather (``Shard(0)`` -> ``Replicate``), all-reduce (``Partial`` ->
   ``Replicate``), reduce-scatter (``Partial`` -> ``Shard(0)``) and
   all-to-all (``Shard(0)`` -> ``Shard(1)``), each held to the plain value.
   Nothing of the port runs in these worlds.
2. ``lm``: ``tests/torch_launch_world.lm_cases``, granite-3-2b SMOKE's
   train step on a ``(2, 2)`` mesh (float32, seeded weights and tokens),
   held to the port's unsharded step on the CPU: loss within 1e-5
   (relative), every new parameter within 1e-5 (absolute).

    python3 tools/dtensor_gloo.py [--device cpu|cuda|both]

Run from the root of a checkout.  Prints a line per case (``ok``, or the
error or the exit code a rank died with), PyTorch's version, and the
card's name and power limit where there is one.  Exits 0 whatever the
cases gave: it reports, it does not gate.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tests"))

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all")
TOL = 1e-5


def collective(rank, world_size, kind, device):
    """One redistribution of ``kind`` on a ``(4,)`` mesh; the largest
    |difference| from the plain value."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor

    mesh = init_device_mesh(torch.device(device).type, (world_size,))
    x = torch.arange(64 * 32, dtype=torch.float32, device=device).reshape(64, 32)
    if kind == "all-gather":
        got = distribute_tensor(x, mesh, [Shard(0)]).redistribute(mesh, [Replicate()])
        want = x
    elif kind == "all-to-all":
        got = distribute_tensor(x, mesh, [Shard(0)]).redistribute(mesh, [Shard(1)])
        want = x
    else:  # a pending sum: each rank holds x, the whole is world_size * x
        part = DTensor.from_local(x, mesh, [Partial()], run_check=False)
        got = part.redistribute(mesh, [Shard(0) if kind == "reduce-scatter" else Replicate()])
        want = world_size * x
    del rank
    return float((got.full_tensor() - want).abs().max())


def lm_world(device):
    """``lm_cases`` on four gloo ranks: (its loss, params) and the unsharded
    port's on the CPU."""
    import numpy as np

    import torch_launch_world as world
    from repro_torch.configs import get_config
    from repro_torch.core import run_world
    from repro_torch.models import transformer as tf
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts
    from repro_torch.train.tree import paths

    arch = "granite-3-2b"
    cfg = get_config(arch, smoke=True)
    tree = tf.init_params(cfg, 0, device="cpu").numpy_tree()
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 32)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    ranks = run_world(world.lm_cases, 4, backend="gloo", device=device, timeout=300,
                      args=(arch, tree, batch, (2, 2), [("base", (), 1)], None, device))
    model = tf.params_from_reference(cfg, tree, device="cpu")
    oc = opt.OptimizerConfig(**world.OPT)
    p1, _, m1 = ts.make_train_step(cfg, oc)(model, opt.init_opt_state(model.tree(), oc), batch)
    metrics, params = ranks[0]["base"][0], dict(paths(ranks[0]["base"][1]))
    loss_gap = abs(metrics["loss"] - float(m1["loss"])) / abs(float(m1["loss"]))
    param_gap = max(float(np.abs(params[k] - v.numpy()).max()) for k, v in paths(p1))
    return loss_gap, param_gap


def report(label, fn, check):
    t = time.perf_counter()
    try:
        got = fn()
        verdict = "ok" if check(got) else "WRONG"
        print(f"{label}: {verdict} {got} ({time.perf_counter() - t:.1f} s)", flush=True)
    except Exception as e:  # noqa: BLE001 -- each case is reported, not raised
        text = " ".join(str(e).split())[-600:]
        print(f"{label}: FAILED {type(e).__name__}: {text} ({time.perf_counter() - t:.1f} s)",
              flush=True)


def main(argv=None) -> int:
    import torch

    from repro_torch.core import run_world

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cpu", "cuda", "both"), default="both")
    args = ap.parse_args(argv)
    devices = ("cpu", "cuda") if args.device == "both" else (args.device,)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    if torch.cuda.is_available():
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip()
        print(f"gpu: {smi}", flush=True)
    for device in devices:
        for kind in KINDS:
            report(f"collective {kind} on {device} tensors, 4 gloo ranks",
                   lambda: max(run_world(collective, 4, backend="gloo", device=device,
                                         timeout=90, args=(kind, device))),
                   lambda gap: gap == 0.0)
        report(f"lm granite-3-2b SMOKE train step, (2, 2) mesh on {device} tensors, 4 gloo "
               f"ranks: (loss gap relative, param gap) against the unsharded port",
               lambda: lm_world(device), lambda gaps: gaps[0] <= TOL and gaps[1] <= TOL)
    return 0


if __name__ == "__main__":
    sys.exit(main())
