"""Shared runs of the LM training path for ``tests/test_torch_train_*.py``
(split so that ``--dist loadfile`` spreads the reference's compiles over
workers): the reference (``src/repro``) is run once per (arch, variant) and
every assert reads from that run; the port runs the same calls on the
reference's weights (``params_from_reference``) on the CPU.

One batch of ``tests/test_archs_smoke.py``'s shape (b = 2, s = 32) is made
once as numpy and fed to both packages.  The reference's loss and gradient
are ``jax.value_and_grad(make_loss_fn(cfg), has_aux=True)`` and its steps
``make_train_step``, jitted together (one compile); every variant runs
:data:`STEPS` steps.

Tolerances (set from the dtypes and from Adam's arithmetic):
  * loss, its parts and the metrics: ``rtol = atol = 1e-4`` (the serving
    tests' ``TOL``);
  * each gradient leaf, and ``m`` and ``v``: ``rtol = 1e-4``,
    ``atol = 1e-4 x`` the leaf's largest magnitude (a gradient's floored at
    ``1e-6 x`` the model's largest gradient: the key bias's exact gradient
    is zero, so its whole leaf is rounding noise); ``m``/``v`` stored in
    bfloat16: one bfloat16 step (``2**-8``) in place of ``1e-4``;
  * params: ``rtol = 1e-5``, ``atol = 1e-2 x lr_peak``.  Adam's first
    update is ``lr * g / (|g| + eps)``, about ``lr * sign(g)``, so an entry
    whose gradient the two packages give apart by more than
    ``1e-2 x (|g| + eps)`` at some step (a gradient at the rounding level:
    the key bias's exact gradient is zero by the softmax's shift
    invariance) takes another update.  Those entries, compared first, are
    held only to Adam's bound, ``2 x lr_peak`` a step, and counted;
  * with ``grad_compress``, the int8 levels of ``(g + ef)`` are compared
    first: where they differ at the first step, the reference's
    ``(g + ef) / absmax * 127`` must lie within ``1e-4 x 127`` of a rounding
    tie (the gradients' tolerance in int8 steps); such an entry is held to one quantum
    ``absmax / 127``'s effect on ``m``, ``v`` and ``ef`` and to Adam's
    bound on the params, and counted.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config
from repro.models import transformer as r_tf
from repro.train import optimizer as r_opt
from repro.train import train_step as r_ts
from repro_torch.configs import get_config as t_get_config
from repro_torch.models import transformer as t_tf
from repro_torch.train import optimizer as t_opt
from repro_torch.train import train_step as t_ts
from repro_torch.train.tree import paths, tree_map

B, S, STEPS = 2, 32, 2
OPT = dict(lr_peak=1e-3, warmup_steps=1, total_steps=10)  # test_one_train_step's
# variant -> (OptimizerConfig fields, microbatches)
VARIANTS = {
    "base": ({}, 1),
    "microbatches": ({}, 2),
    "bf16_state": ({"state_dtype": "bfloat16"}, 1),
    "grad_compress": ({"grad_compress": True}, 1),
}
TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_RTOL = 1e-4
BF16_STEP = 2.0**-8
TIE_MARGIN = GRAD_RTOL * 127.0
UPDATE_RTOL = 1e-2


def configs(arch: str, **kw):
    return (dataclasses.replace(get_config(arch, smoke=True), **kw),
            dataclasses.replace(t_get_config(arch, smoke=True), **kw))


def batch(cfg) -> dict:
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    out = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    if cfg.frontend != "none":
        out["frontend_embeds"] = (
            rng.standard_normal((B, cfg.n_frontend_tokens, cfg.d_model)) * 0.1
        ).astype(np.float32)
    return out


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64) if a.dtype == jnp.bfloat16
                        else np.asarray(a), tree)


def _flat(tree) -> dict:
    """``{path: numpy}`` of a reference tree (paths as the port names them)."""
    return {k: np.asarray(v) for k, v in paths(_np(tree))}


def _tflat(tree) -> dict:
    return {k: v.detach().to(torch.float64).numpy() for k, v in paths(tree)}


def _grad_and_step(cfg, opt_cfg, microbatches: int):
    """One jitted function (one compile) of the gradient a step sees -- the
    batch's, or each microbatch's -- and the step itself."""
    grad_fn = jax.value_and_grad(r_ts.make_loss_fn(cfg), has_aux=True)
    step = r_ts.make_train_step(cfg, opt_cfg, microbatches=microbatches)

    def run(params, opt_state, b):
        mbs = [jax.tree.map(lambda x: x.reshape(microbatches, -1, *x.shape[1:])[i], b)
               for i in range(microbatches)]
        return [grad_fn(params, mb) for mb in mbs], step(params, opt_state, b)

    return jax.jit(run)


def reference_run(arch: str, variant: str = "base") -> dict:
    """The reference's loss, parts and gradient on the batch (``base``), and
    :data:`STEPS` ``make_train_step`` steps with the gradient each sees.
    Cached by ``(arch, variant)`` however the call spells them."""
    return _reference_run(arch, variant)


@functools.lru_cache(maxsize=None)
def _reference_run(arch: str, variant: str) -> dict:
    fields, microbatches = VARIANTS[variant]
    cfg, _ = configs(arch)
    params = jax.jit(functools.partial(r_tf.init_params, cfg))(jax.random.PRNGKey(0))
    b = batch(cfg)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    out = {"params": jax.tree.map(np.asarray, params), "batch": b}
    opt_cfg = r_opt.OptimizerConfig(**OPT, **fields)
    run = _grad_and_step(cfg, opt_cfg, microbatches)
    p, o = params, r_opt.init_opt_state(params, opt_cfg)
    out["steps"] = []
    for i in range(STEPS):
        grads, (p, o, metrics) = run(p, o, jb)
        gs = [_flat(g) for _, g in grads]
        g = {k: sum(x[k] for x in gs) / microbatches for k in gs[0]}
        if i == 0 and variant == "base":
            (loss, parts), _ = grads[0]
            out["loss"], out["parts"], out["grads"] = (
                float(loss), {k: float(v) for k, v in parts.items()}, g)
        out["steps"].append({
            "grads_in": g, "params": _flat(p), "m": _flat(o.m), "v": _flat(o.v),
            "ef": _flat(o.ef), "step": int(o.step),
            "metrics": {k: float(v) for k, v in metrics.items()},
        })
    return out


def port_run(arch: str, variant: str = "base") -> dict:
    """The same calls through the port, on the reference's weights."""
    return _port_run(arch, variant)


@functools.lru_cache(maxsize=None)
def _port_run(arch: str, variant: str) -> dict:
    fields, microbatches = VARIANTS[variant]
    ref = reference_run(arch, variant)
    _, cfg = configs(arch)
    b = ref["batch"]
    params = tree_map(lambda t: t.detach(),
                      t_tf.params_from_reference(cfg, ref["params"], device="cpu").tree())
    out = {}
    if variant == "base":
        (loss, parts), g = t_ts.value_and_grad(t_ts.make_loss_fn(cfg))(params, b)
        out["loss"], out["parts"], out["grads"] = float(loss), parts, _tflat(g)
    opt_cfg = t_opt.OptimizerConfig(**OPT, **fields)
    step = t_ts.make_train_step(cfg, opt_cfg, microbatches=microbatches)
    grad_fn = t_ts.value_and_grad(t_ts.make_loss_fn(cfg))
    p, o = params, t_opt.init_opt_state(params, opt_cfg)
    out["steps"] = []
    for _ in range(STEPS):
        mbs = [{k: v.reshape(microbatches, -1, *v.shape[1:])[i] for k, v in b.items()}
               for i in range(microbatches)]
        gs = [_tflat(grad_fn(p, mb)[1]) for mb in mbs]
        grads_in = {k: sum(g[k] for g in gs) / microbatches for k in gs[0]}
        p, o, metrics = step(p, o, b)
        out["steps"].append({
            "grads_in": grads_in, "params": _tflat(p), "m": _tflat(o.m), "v": _tflat(o.v),
            "ef": _tflat(o.ef), "step": o.step, "metrics": metrics,
            "dtypes": {k: {n: str(v.dtype) for n, v in paths(t)}
                       for k, t in (("params", p), ("m", o.m), ("v", o.v))},
        })
    return out


def port_grads(arch: str, remat: bool) -> dict:
    """The port's gradient on the batch with ``cfg.remat`` set, as tensors."""
    ref = reference_run(arch)
    _, cfg = configs(arch, remat=remat)
    params = tree_map(lambda t: t.detach(),
                      t_tf.params_from_reference(cfg, ref["params"], device="cpu").tree())
    _, g = t_ts.value_and_grad(t_ts.make_loss_fn(cfg))(params, ref["batch"])
    return dict(paths(g))


# ---------------------------------------------------------------------------
# The checks, one per test
# ---------------------------------------------------------------------------


def _close(got, want, rtol, atol, what):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol, err_msg=what)


def check_loss(arch: str):
    ref, got = reference_run(arch), port_run(arch)
    _close(got["loss"], ref["loss"], what="loss", **TOL)
    for k in ("ce", "moe_aux"):
        assert got["parts"][k].dtype == torch.float32, k
        _close(float(got["parts"][k]), ref["parts"][k], what=k, **TOL)


def check_grads(arch: str):
    ref, got = reference_run(arch), port_run(arch)
    assert sorted(got["grads"]) == sorted(ref["grads"])
    top = max(float(np.abs(v).max()) for v in ref["grads"].values())
    for k, want in ref["grads"].items():
        assert got["grads"][k].shape == want.shape, k
        scale = float(np.abs(want).max())
        _close(got["grads"][k], want, GRAD_RTOL, GRAD_RTOL * scale + 1e-6 * top, f"grad {k}")


def check_remat_bitwise(arch: str):
    on, off = port_grads(arch, True), port_grads(arch, False)
    assert sorted(on) == sorted(off)
    for k in on:
        assert torch.equal(on[k], off[k]), k


def _update_apart(ref_steps, got_steps) -> dict:
    """Per leaf, the entries whose gradient the packages give apart by more
    than ``UPDATE_RTOL x (|g| + eps)`` at some step."""
    eps = r_opt.OptimizerConfig().eps
    out = {}
    for r, g in zip(ref_steps, got_steps):
        for k, want in r["grads_in"].items():
            apart = np.abs(g["grads_in"][k] - want) > UPDATE_RTOL * (np.abs(want) + eps)
            out[k] = out.get(k, False) | apart
    return out


def _levels(gf):
    absmax = max(float(np.abs(gf).max()), 1e-12)
    scaled = gf / absmax * 127.0
    return np.round(scaled), scaled, absmax / 127.0


def _level_flips(ref_steps, got_steps) -> tuple:
    """Per leaf, the entries whose int8 level of ``g + ef`` differs between
    the packages at some step, and the largest quantum over steps.  At the
    first step, where both start from the same params and state, each must
    be a near-tie in the reference; a later step's inputs already differ
    where an earlier level or update did."""
    flips, quantum = {}, {}
    r_ef = g_ef = None
    for r, g in zip(ref_steps, got_steps):
        for k, rg in r["grads_in"].items():
            r_lv, r_scaled, q = _levels(rg + (0.0 if r_ef is None else r_ef[k]))
            g_lv, _, _ = _levels(g["grads_in"][k] + (0.0 if g_ef is None else g_ef[k]))
            flip = r_lv != g_lv
            if r_ef is None:  # same params and state: only a near-tie may flip
                frac = np.abs(r_scaled[flip]) % 1.0
                assert (np.abs(frac - 0.5) < TIE_MARGIN).all(), (k, "int8 level off a tie")
            flips[k] = flips.get(k, False) | flip
            quantum[k] = max(quantum.get(k, 0.0), q)
        r_ef, g_ef = r["ef"], g["ef"]
    return flips, quantum


def check_steps(arch: str, variant: str = "base") -> dict:
    """Metrics, step, params, ``m``, ``v`` and ``ef`` after each step.
    Returns the counts of entries held only to the loose bounds."""
    fields, _ = VARIANTS[variant]
    ref, got = reference_run(arch, variant), port_run(arch, variant)
    noise = _update_apart(ref["steps"], got["steps"])
    ties, quantum = ({}, {})
    if fields.get("grad_compress"):
        ties, quantum = _level_flips(ref["steps"], got["steps"])
    rel = BF16_STEP if fields.get("state_dtype") == "bfloat16" else GRAD_RTOL
    sdt = fields.get("state_dtype", "float32")
    counts = {"update_apart": 0, "int8_level_flips": 0}
    for i, (r, g) in enumerate(zip(ref["steps"], got["steps"])):
        assert int(g["step"]) == r["step"] == i + 1 and g["step"].dtype == torch.int32
        assert sorted(g["metrics"]) == sorted(r["metrics"])
        for k, v in r["metrics"].items():
            assert g["metrics"][k].dtype == torch.float32, k
            _close(float(g["metrics"][k]), v, what=f"step {i + 1} {k}", **TOL)
        assert set(g["dtypes"]["params"].values()) == {"torch.float32"}
        assert set(g["dtypes"]["m"].values()) == {f"torch.{sdt}"}
        for k, want in r["params"].items():
            tie = ties.get(k, False)
            loose = noise[k] | tie
            lr_bound = 2 * OPT["lr_peak"] * (i + 1)
            d = np.abs(g["params"][k] - want)
            assert (d[loose] <= lr_bound).all(), (i, k, "loose", d[loose].max())
            _close(g["params"][k][~loose], want[~loose], 1e-5, 1e-2 * OPT["lr_peak"],
                   f"step {i + 1} params {k}")
            q = quantum.get(k, 0.0)
            for name, extra in (("m", q), ("v", q * 127.0 * q * 2), ("ef", 2 * q)):
                w, t = r[name][k], g[name][k]
                atol = rel * float(np.abs(w).max())
                if name == "ef":  # residuals live at the gradient's scale
                    atol = GRAD_RTOL * float(np.abs(r["grads_in"][k]).max())
                _close(t[~tie] if np.ndim(tie) else t, w[~tie] if np.ndim(tie) else w,
                       rel, atol, f"step {i + 1} {name} {k}")
                if np.ndim(tie):
                    assert (np.abs(t - w)[tie] <= extra + atol).all(), (i, name, k)
            if i == len(ref["steps"]) - 1:
                counts["update_apart"] += int(np.sum(noise[k]))
                counts["int8_level_flips"] += int(np.sum(tie))
    return counts
