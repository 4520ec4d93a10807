"""Shared runs of ``tests/test_torch_launch_step.py`` and
``test_torch_launch_variants.py``: the reference's unsharded jitted train
step (the reference's ``test_sharded_train_step_matches_unsharded``'s
config, optimizer and batch shape, tokens from numpy), the port's unsharded
step on the same weights, and the port's sharded step on a ``(2, 2)`` mesh
over a world of four gloo ranks (``torch_launch_world.lm_cases``).

Tolerances: against the reference, the reference test's (loss 1e-3,
params 2e-2, absolute); against the port's unsharded float32 step, 1e-5
(loss relative, params absolute: one Adam step moves each entry by about
``lr_peak`` = 1e-3, so a flipped update would show as 2e-3)."""
import dataclasses
import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config
from repro.models.transformer import init_params
from repro.train.optimizer import OptimizerConfig, init_opt_state
from repro.train.train_step import make_train_step
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import run_world
from repro_torch.models import params_from_reference
from repro_torch.train import optimizer as t_opt
from repro_torch.train import train_step as t_ts
from repro_torch.train.tree import paths

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_launch_world as world  # noqa: E402

ARCH = "granite-3-2b"
B, S = 4, 32
REF_TOL = dict(loss=1e-3, params=2e-2)
PORT_TOL = 1e-5
SERVE = (2, 16, 4)  # b, prompt, decode steps (s_max = prompt + steps unless given)


@functools.cache
def weights(arch: str = ARCH):
    """The reference's SMOKE weights (numpy tree) and one batch."""
    params = init_params(get_config(arch, smoke=True), jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    toks = rng.integers(0, get_config(arch, smoke=True).vocab_size, (B, S)).astype(np.int32)
    return jax.tree.map(np.asarray, params), {"tokens": toks, "labels": np.roll(toks, -1, 1)}


@functools.cache
def reference_step(microbatches: int = 1, **overrides):
    """The reference's unsharded jitted step: (loss, {path: new param})."""
    tree, batch = weights()
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), **overrides)
    opt_cfg = OptimizerConfig(**world.OPT)
    params = jax.tree.map(jnp.asarray, tree)
    step = jax.jit(make_train_step(cfg, opt_cfg, microbatches=microbatches))
    p1, _, m1 = step(params, init_opt_state(params, opt_cfg),
                     {k: jnp.asarray(v) for k, v in batch.items()})
    flat = jax.tree_util.tree_flatten_with_path(p1)[0]
    from repro.launch.sharding import _path_str

    return float(m1["loss"]), {_path_str(p): np.asarray(v) for p, v in flat}


@functools.cache
def port_step(microbatches: int = 1, **overrides):
    """The port's unsharded step on the same weights: (loss, {path: param})."""
    tree, batch = weights()
    cfg = dataclasses.replace(t_get_config(ARCH, smoke=True), **overrides)
    oc = t_opt.OptimizerConfig(**world.OPT)
    model = params_from_reference(cfg, tree, device="cpu")
    p1, _, m1 = t_ts.make_train_step(cfg, oc, microbatches=microbatches)(
        model, t_opt.init_opt_state(model.tree(), oc), batch)
    return float(m1["loss"]), {k: v.numpy() for k, v in paths(p1)}


@functools.cache
def sharded(variants: tuple, serve: bool = False, arch: str = ARCH, s_max: int | None = None):
    """The sharded world's results (``torch_launch_world.lm_cases``); with
    ``serve``, decode caches of ``s_max`` slots (prompt + steps if None)."""
    tree, batch = weights(arch)
    extra = None
    if serve:
        b, prompt, steps = SERVE
        extra = (batch["tokens"][:b, :prompt], steps, s_max or prompt + steps)
    return run_world(world.lm_cases, 4, timeout=600,
                     args=(arch, tree, batch, (2, 2), list(variants), extra))


def max_gap(got: dict, want: dict) -> float:
    assert sorted(got) == sorted(want)
    return max(float(np.max(np.abs(np.asarray(got[k], np.float32) - want[k]))) for k in want)


def check(name: str, ranks: list, ref: tuple, port: tuple) -> None:
    """Every rank's loss equal; rank 0's params and the loss against the
    reference's (REF_TOL) and the port's unsharded step (PORT_TOL)."""
    losses = [r[name][0]["loss"] for r in ranks]
    assert len(set(losses)) == 1, losses
    params = dict(paths(ranks[0][name][1]))
    assert abs(losses[0] - ref[0]) < REF_TOL["loss"], (losses[0], ref[0])
    assert max_gap(params, ref[1]) < REF_TOL["params"]
    assert abs(losses[0] - port[0]) <= PORT_TOL * abs(port[0]), (losses[0], port[0])
    gap = max_gap(params, port[1])
    assert gap <= PORT_TOL, gap
    print(name, "loss", losses[0], "reference", ref[0], "port", port[0], "param gap", gap)
