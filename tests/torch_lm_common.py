"""Shared runs of the LM serving path for ``tests/test_torch_lm_serve*.py``,
``tests/test_torch_lm_recurrent.py`` and ``tests/test_torch_lm_bfloat16.py``
(split so that ``--dist loadfile`` spreads the reference's runs over
workers): the reference (``src/repro``) is run
once per (arch, dtype) and every assert reads from that run; the port runs
the same calls on the reference's weights (``params_from_reference``) on the
CPU.

The reference's calls are jitted here (``init_params``, ``forward_train``,
``prefill``, ``decode_step``) to keep the files cheap; ``generate`` is its
own, as it is.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config
from repro.models import transformer as r_tf
from repro.train import serve_step as r_serve
from repro_torch.configs import get_config as t_get_config
from repro_torch.models import transformer as t_tf
from repro_torch.train import serve_step as t_serve

B, S_PROMPT, STEPS, S_MAX, GEN_STEPS = 2, 16, 4, 32, 8


def configs(arch: str, dtype: str = "float32"):
    r = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype)
    t = dataclasses.replace(t_get_config(arch, smoke=True), dtype=dtype)
    return r, t


def inputs(cfg):
    rng = np.random.default_rng(11)
    toks = rng.integers(0, cfg.vocab_size, (B, S_PROMPT + STEPS)).astype(np.int32)
    fe = None
    if cfg.frontend != "none":
        fe = (rng.standard_normal((B, cfg.n_frontend_tokens, cfg.d_model)) * 0.1).astype(
            np.float32)
    return toks, fe


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def reference_run(arch: str, dtype: str = "float32", generate: bool = True) -> dict:
    """The reference's forward, prefill, decode-cache conversion, STEPS
    decode steps (the prompt's next tokens fed in) and ``generate``.
    Cached by ``(arch, dtype, generate)`` however the call spells them."""
    return _reference_run(arch, dtype, generate)


@functools.lru_cache(maxsize=None)
def _reference_run(arch: str, dtype: str, generate: bool) -> dict:
    cfg, _ = configs(arch, dtype)
    params = jax.jit(functools.partial(r_tf.init_params, cfg))(jax.random.PRNGKey(0))
    toks, fe = inputs(cfg)
    jfe = None if fe is None else jnp.asarray(fe)
    out = {"params": _np(params), "toks": toks, "fe": fe}
    fwd = jax.jit(lambda p, t, f: r_tf.forward_train(p, cfg, t, frontend_embeds=f)[0])
    out["forward"] = np.asarray(fwd(params, jnp.asarray(toks), jfe))
    pf = jax.jit(lambda p, t, f: r_tf.prefill(p, cfg, t, frontend_embeds=f))
    logits, caches = pf(params, jnp.asarray(toks[:, :S_PROMPT]), jfe)
    out["prefill"], out["prefill_caches"] = np.asarray(logits), _np(caches)
    s0 = S_PROMPT + (0 if fe is None else fe.shape[1])
    cache = r_serve.prefill_to_decode_cache(cfg, caches, s0, S_MAX)
    out["s0"], out["decode_cache"] = s0, _np(cache)
    step = jax.jit(lambda p, t, c, pos: r_tf.decode_step(p, cfg, t, c, pos))
    out["steps"] = []
    for i in range(STEPS):
        tok = jnp.asarray(toks[:, S_PROMPT + i : S_PROMPT + i + 1])
        logits, cache = step(params, tok, cache, jnp.int32(s0 + i))
        out["steps"].append((np.asarray(logits), _np(cache)))
    if generate:
        gen = r_serve.generate(params, cfg, jnp.asarray(toks[:, :S_PROMPT]), steps=GEN_STEPS,
                               s_max=S_MAX, frontend_embeds=jfe)
        out["generate"] = np.asarray(gen)
    return out


def port_run(arch: str, dtype: str = "float32", generate: bool = True) -> dict:
    """The same calls through the port, on the reference's weights."""
    return _port_run(arch, dtype, generate)


@functools.lru_cache(maxsize=None)
def _port_run(arch: str, dtype: str, generate: bool) -> dict:
    ref = reference_run(arch, dtype, generate)
    _, cfg = configs(arch, dtype)
    model = t_tf.params_from_reference(cfg, ref["params"], device="cpu")
    toks, fe = ref["toks"], ref["fe"]
    tfe = None if fe is None else torch.tensor(fe)
    out = {"model": model}
    with torch.no_grad():  # serving: no graph
        out["forward"] = t_tf.forward_train(model, cfg, toks, frontend_embeds=tfe)[0]
    logits, caches = t_tf.prefill(model, cfg, toks[:, :S_PROMPT], frontend_embeds=tfe)
    out["prefill"], out["prefill_caches"] = logits, caches
    cache = t_serve.prefill_to_decode_cache(cfg, caches, ref["s0"], S_MAX)
    out["decode_cache"] = cache
    out["steps"] = []
    for i in range(STEPS):
        logits, cache = t_tf.decode_step(model, cfg, toks[:, S_PROMPT + i : S_PROMPT + i + 1],
                                         cache, ref["s0"] + i)
        out["steps"].append((logits, cache))
    if generate:
        out["generate"] = t_serve.generate(model, cfg, toks[:, :S_PROMPT], steps=GEN_STEPS,
                                           s_max=S_MAX, frontend_embeds=tfe)
    return out


def dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    return np.asarray(x).dtype.name


def assert_close(got, want, tol, what=""):
    got = got.detach().to(torch.float64).numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want).astype(np.float64), err_msg=what, **tol)


def assert_tree_close(got, want, tol, what="cache"):
    """Same structure, leaf shapes and dtypes; values within ``tol``."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), (what, got, want)
        for k in want:
            assert_tree_close(got[k], want[k], tol, f"{what}.{k}")
        return
    if isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            assert_tree_close(g, w, tol, f"{what}.{i}")
        return
    assert tuple(got.shape) == tuple(np.shape(want)), (what, tuple(got.shape), np.shape(want))
    assert dtype_name(got) == dtype_name(want), (what, dtype_name(got), dtype_name(want))
    assert_close(got, want, tol, what)


def assert_same_specs(got, want, what="specs"):
    """Same structure, shapes and dtypes (values not compared)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), (what, got, want)
        for k in want:
            assert_same_specs(got[k], want[k], f"{what}.{k}")
        return
    if isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same_specs(g, w, f"{what}.{i}")
        return
    assert tuple(got.shape) == tuple(want.shape), (what, tuple(got.shape), want.shape)
    assert dtype_name(got) == np.dtype(want.dtype).name, (what, got.dtype, want.dtype)


def self_consistency(arch: str, tol=dict(rtol=5e-2, atol=5e-2)):
    """The twin of the reference's ``test_prefill_decode_matches_full_forward``
    on the port alone: at float64, prefill on 24 tokens + 4 decode steps
    against ``forward_train`` over all 28."""
    _, cfg = configs(arch, "float64")
    model = t_tf.init_params(cfg, 0, device="cpu")
    b, s_pre, s_max = 2, 24, 48
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (b, s_pre + 4))
    with torch.no_grad():
        full, _ = t_tf.forward_train(model, cfg, toks)
    lg, caches = t_tf.prefill(model, cfg, toks[:, :s_pre])
    assert lg.dtype == torch.float64
    assert_close(lg[:, 0], full[:, s_pre - 1], tol)
    cache = t_serve.prefill_to_decode_cache(cfg, caches, s_pre, s_max)
    for i in range(4):
        lg, cache = t_tf.decode_step(model, cfg, toks[:, s_pre + i : s_pre + i + 1], cache,
                                     s_pre + i)
        got, want = lg[:, 0].float().numpy(), full[:, s_pre + i].float().numpy()
        assert_close(got, want, tol)
        assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.99


def bfloat16_errors(arch: str) -> dict:
    """Largest absolute differences, port against reference, both at
    bfloat16 on the reference's weights, relative to the logits' scale."""
    ref = reference_run(arch, "bfloat16", False)
    got = port_run(arch, "bfloat16", False)
    scale = float(np.abs(np.asarray(ref["forward"], np.float32)).max())

    def err(a, b):
        return float(np.abs(a.float().numpy() - np.asarray(b, np.float32)).max()) / scale

    return {
        "forward": err(got["forward"], ref["forward"]),
        "prefill": err(got["prefill"], ref["prefill"]),
        "steps": max(err(g[0], r[0]) for g, r in zip(got["steps"], ref["steps"])),
        "dtype": dtype_name(got["forward"]),
    }


# The float32 checks against the reference, one per test of each file.
TOL = dict(rtol=1e-4, atol=1e-4)


def check_forward(arch: str):
    ref, got = reference_run(arch), port_run(arch)
    assert dtype_name(got["forward"]) == "float32"
    assert_close(got["forward"], ref["forward"], TOL)


def check_prefill(arch: str):
    ref, got = reference_run(arch), port_run(arch)
    assert_close(got["prefill"], ref["prefill"], TOL)
    assert_tree_close(got["prefill_caches"], ref["prefill_caches"], TOL)


def check_decode_cache(arch: str):
    ref, got = reference_run(arch), port_run(arch)
    assert_tree_close(got["decode_cache"], ref["decode_cache"], TOL)


def check_decode_steps(arch: str):
    ref, got = reference_run(arch), port_run(arch)
    for i, ((g_lg, g_c), (r_lg, r_c)) in enumerate(zip(got["steps"], ref["steps"])):
        assert_close(g_lg, r_lg, TOL, f"step {i} logits")
        assert_tree_close(g_c, r_c, TOL, f"step {i} cache")


def check_generate(arch: str):
    ref, got = reference_run(arch), port_run(arch)
    assert got["generate"].dtype == torch.int32
    assert np.array_equal(got["generate"].numpy(), ref["generate"])
