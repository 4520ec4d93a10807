"""The port's mixture-of-experts and multi-head latent attention
(``repro_torch.nn.moe``, ``repro_torch.nn.mla``) against the reference's
(``src/repro/nn/``), on the CPU at small sizes.

Inputs are seeded numpy arrays; weights come from the reference's own
initialisers and are carried across as numpy.  Outputs, the aux loss and
the caches are held within ``rtol = atol = 1e-4`` (the serving tests'
``TOL``); the gradients of a fixed random projection of the outputs (plus
the aux loss) with respect to ``x`` and every leaf within ``rtol = 1e-4``,
``atol = 1e-4 x`` the leaf's largest magnitude.  The expert routing is
compared first, exactly: a near-tie that flips a routing would be reported
there, with its probability gap.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import mla as r_mla
from repro.nn import moe as r_moe
from repro.nn import rope as r_rope
from repro_torch.nn import mla as t_mla
from repro_torch.nn import moe as t_moe
from repro_torch.nn import rope as t_rope

TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_RTOL = 1e-4


def _close(got, want, tol=TOL, what=""):
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float64), err_msg=what, **tol)


def _tree_torch(tree, grad=False):
    if isinstance(tree, dict):
        return {k: _tree_torch(v, grad) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree)).requires_grad_(grad)


def _grads_close(got, want, what):
    """Leaf by leaf: ``got`` a tree of tensors with ``.grad``, ``want`` numpy."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            _grads_close(got[k], want[k], f"{what}.{k}")
        return
    want = np.asarray(want, np.float64)
    scale = float(np.abs(want).max())
    _close(got.grad, want, dict(rtol=GRAD_RTOL, atol=GRAD_RTOL * scale), what)


# ---------------------------------------------------------------------------
# Mixture of experts
# ---------------------------------------------------------------------------


def _moe_case(b, s, *, n_shared=0, router_scale=False, capacity_factor=1.25, seed=0):
    cfg = r_moe.MoEConfig(n_experts=8, top_k=2, d_model=32, d_ff_expert=16, n_shared=n_shared,
                          d_ff_shared=24 if n_shared else 0, capacity_factor=capacity_factor,
                          router_scale=router_scale)
    params = jax.tree.map(np.asarray, r_moe.moe_init(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    proj = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    return cfg, params, x, proj


@functools.partial(jax.jit, static_argnums=3)
def _r_moe_run(params, x, proj, cfg):
    def loss(p, xx):
        y, aux = r_moe.moe_apply(p, xx, cfg)
        return jnp.sum(y * proj) + aux, (y, aux)

    (_, (y, aux)), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(params, x)
    logits = x.reshape(-1, cfg.d_model) @ params["router"]
    _, experts = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), cfg.top_k)
    return y, aux, gp, gx, experts


def _check_moe(cfg, params, x, proj):
    y_r, aux_r, gp_r, gx_r, experts_r = _r_moe_run(params, jnp.asarray(x), jnp.asarray(proj), cfg)
    tcfg = t_moe.MoEConfig(*cfg)
    tp = _tree_torch(params, grad=True)
    tx = torch.tensor(x, requires_grad=True)
    t = x.shape[0] * x.shape[1]
    probs, _, experts = t_moe.route(tp, tx.reshape(t, -1), tcfg)
    experts_r = np.asarray(experts_r)
    if not np.array_equal(experts.numpy(), experts_r):
        bad = np.nonzero((experts.numpy() != experts_r).any(-1))[0]
        gaps = np.sort(probs.detach().numpy()[bad], axis=-1)[:, -cfg.top_k:]
        pytest.fail(f"routing differs on tokens {bad[:8]} (top-k probabilities {gaps[:4]})")
    y, aux = t_moe.moe_apply(tp, tx, tcfg)
    assert y.dtype == torch.float32 and aux.dtype == torch.float32
    _close(y, y_r, what="y")
    _close(aux, aux_r, what="aux")
    (torch.sum(y * torch.tensor(proj)) + aux).backward()
    _close(tx.grad, gx_r, dict(rtol=GRAD_RTOL, atol=GRAD_RTOL * float(np.abs(gx_r).max())), "x")
    _grads_close(tp, jax.tree.map(np.asarray, gp_r), "params")
    return tp, tx, tcfg


def test_moe_init_layout_and_scales():
    cfg = t_moe.MoEConfig(n_experts=4, top_k=2, d_model=64, d_ff_expert=16, n_shared=2)
    p = t_moe.moe_init(torch.Generator().manual_seed(0), cfg)
    r = jax.eval_shape(lambda k: r_moe.moe_init(k, r_moe.MoEConfig(*cfg)), jax.random.PRNGKey(0))
    assert jax.tree.map(lambda a: tuple(a.shape), r) == jax.tree.map(lambda a: tuple(a.shape), p)
    assert abs(float(p["w_down"].std()) - 16**-0.5) < 0.02
    assert abs(float(p["shared"]["w_down"].std()) - 32**-0.5) < 0.02


@pytest.mark.parametrize("n_shared", [0, 2])
def test_moe_dropless_matches_reference(n_shared):
    cfg, params, x, proj = _moe_case(2, 24, n_shared=n_shared, seed=n_shared)
    assert t_moe.capacity(t_moe.MoEConfig(*cfg), 48) == 48  # dropless: cap = t
    _check_moe(cfg, params, x, proj)


def test_moe_router_scale_matches_reference():
    cfg, params, x, proj = _moe_case(2, 16, router_scale=True, seed=3)
    _check_moe(cfg, params, x, proj)


@pytest.mark.parametrize("capacity_factor", [1.0, 1.25])
def test_moe_capacity_path_matches_reference(capacity_factor):
    """Past 4,096 tokens: ``cap = int(t * k * capacity_factor / E)``; the
    routings past their expert's capacity go to the overflow bin and add
    nothing.  At ``capacity_factor = 1.0`` (cap = the mean load) some are
    dropped."""
    cfg, params, x, proj = _moe_case(2, 2100, capacity_factor=capacity_factor, seed=5)
    tp, tx, tcfg = _check_moe(cfg, params, x, proj)
    t = 4200
    cap = t_moe.capacity(tcfg, t)
    assert cap == int(t * 2 * capacity_factor / 8)
    _, _, experts = t_moe.route(tp, tx.detach().reshape(t, -1), tcfg)
    n = int((~t_moe.slots(experts, 8, cap)[1]).sum())
    print(f"capacity_factor {capacity_factor}: cap {cap}, {n} of {t * 2} routings dropped")
    if capacity_factor == 1.0:
        assert n > 0


def test_moe_bfloat16_router_in_float32():
    """Under bfloat16 weights and activations the router leaf is bfloat16;
    the reference's product promotes to float32, the port casts: same
    routing, outputs within bfloat16's rounding."""
    cfg, params, x, _ = _moe_case(2, 16, n_shared=2, seed=7)
    bf = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    xb = jnp.asarray(x, jnp.bfloat16)
    y_r, aux_r = jax.jit(r_moe.moe_apply, static_argnums=2)(bf, xb, cfg)
    tp = jax.tree.map(lambda a: torch.tensor(np.asarray(a, np.float32)).to(torch.bfloat16), bf)
    tx = torch.tensor(np.asarray(xb, np.float32)).to(torch.bfloat16)
    y, aux = t_moe.moe_apply(tp, tx, t_moe.MoEConfig(*cfg))
    assert y.dtype == torch.bfloat16 and aux.dtype == torch.float32
    scale = float(np.abs(np.asarray(y_r, np.float32)).max())
    _close(y.float(), np.asarray(y_r, np.float32), dict(rtol=2e-2, atol=2e-2 * scale), "y")
    _close(aux, aux_r, what="aux")


# ---------------------------------------------------------------------------
# Multi-head latent attention
# ---------------------------------------------------------------------------


def _mla_case(q_lora_rank, b=2, s=12, seed=0):
    cfg = r_mla.MLAConfig(d_model=32, n_heads=4, q_lora_rank=q_lora_rank, kv_lora_rank=16,
                          qk_nope_dim=8, qk_rope_dim=4, v_dim=6)
    params = jax.tree.map(np.asarray, r_mla.mla_init(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    return cfg, params, x, rng


def _tables(n, dim, offset=0):
    r = r_rope.rope_cos_sin(jnp.arange(n) + offset, dim, 10000.0)
    t = t_rope.rope_cos_sin(torch.arange(n) + offset, dim, 10000.0)
    return r, t


@functools.partial(jax.jit, static_argnums=(3, 4))
def _r_mla_prefill(params, x, projs, cfg, chunk):
    cos, sin = r_rope.rope_cos_sin(jnp.arange(x.shape[1]), cfg.qk_rope_dim, 10000.0)

    def loss(p, xx):
        y, (c, kr) = r_mla.mla_attention(p, xx, cfg, cos, sin, chunk=chunk)
        return jnp.sum(y * projs[0]) + jnp.sum(c * projs[1]) + jnp.sum(kr * projs[2]), (y, c, kr)

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(params, x)
    return out, grads


@pytest.mark.parametrize("q_lora_rank", [0, 12])
def test_mla_attention_matches_reference(q_lora_rank):
    """Prefill: q/k head dim ``nope + rope`` (12), value dim 6, the shared
    rotary key broadcast over the heads; tiles of 4 (``chunk``)."""
    cfg, params, x, rng = _mla_case(q_lora_rank)
    b, s, _ = x.shape
    projs = [rng.standard_normal(shape).astype(np.float32)
             for shape in ((b, s, cfg.d_model), (b, s, cfg.kv_lora_rank), (b, s, cfg.qk_rope_dim))]
    (y_r, c_r, kr_r), (gp_r, gx_r) = _r_mla_prefill(params, jnp.asarray(x), projs, cfg, 4)
    assert ("wq_a" in params) == (q_lora_rank > 0)
    tp = _tree_torch(params, grad=True)
    tx = torch.tensor(x, requires_grad=True)
    _, (cos, sin) = _tables(s, cfg.qk_rope_dim)
    y, (c, kr) = t_mla.mla_attention(tp, tx, t_mla.MLAConfig(*cfg), cos, sin, chunk=4)
    for got, want, what in ((y, y_r, "y"), (c, c_r, "c"), (kr, kr_r, "kr")):
        assert tuple(got.shape) == tuple(want.shape), what
        _close(got, want, what=what)
    loss = sum(torch.sum(o * torch.tensor(p)) for o, p in zip((y, c, kr), projs))
    loss.backward()
    _close(tx.grad, gx_r, dict(rtol=GRAD_RTOL, atol=GRAD_RTOL * float(np.abs(gx_r).max())), "x")
    _grads_close(tp, jax.tree.map(np.asarray, gp_r), "params")


@functools.partial(jax.jit, static_argnums=(4, 5))
def _r_mla_decode(params, x, cache, proj, cfg, pos):
    cos, sin = r_rope.rope_cos_sin(jnp.arange(1) + pos, cfg.qk_rope_dim, 10000.0)

    def loss(p, xx):
        y, new = r_mla.mla_decode(p, xx, cfg, cos, sin, cache, pos)
        return jnp.sum(y * proj), (y, new)

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(params, x)
    return out, grads


@pytest.mark.parametrize("q_lora_rank", [0, 12])
def test_mla_decode_matches_reference(q_lora_rank):
    """The absorbed decode on a latent cache of 16 slots (the first 12
    filled by a prefill): the latent ``c`` and rotary key written at the
    position, the scores masked past it."""
    cfg, params, x, rng = _mla_case(q_lora_rank)
    b, s, _ = x.shape
    s_max, pos = 16, s
    r_cos, r_sin = r_rope.rope_cos_sin(jnp.arange(s), cfg.qk_rope_dim, 10000.0)
    _, (c, kr) = r_mla.mla_attention(params, jnp.asarray(x), cfg, r_cos, r_sin, chunk=4)
    pad = lambda a: np.pad(np.asarray(a), ((0, 0), (0, s_max - s), (0, 0)))  # noqa: E731
    cache = (pad(c), pad(kr))
    xt = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    proj = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    (y_r, (c_r, kr_r)), (gp_r, gx_r) = _r_mla_decode(params, jnp.asarray(xt), cache, proj, cfg,
                                                     pos)
    tp = _tree_torch(params, grad=True)
    tx = torch.tensor(xt, requires_grad=True)
    _, (cos, sin) = _tables(1, cfg.qk_rope_dim, offset=pos)
    tcache = (torch.tensor(cache[0]), torch.tensor(cache[1]))
    y, (c_new, kr_new) = t_mla.mla_decode(tp, tx, t_mla.MLAConfig(*cfg), cos, sin, tcache, pos)
    assert torch.equal(tcache[0], torch.tensor(cache[0]))  # the given cache is kept
    _close(y, y_r, what="y")
    _close(c_new, c_r, what="c")
    _close(kr_new, kr_r, what="kr")
    torch.sum(y * torch.tensor(proj)).backward()
    _close(tx.grad, gx_r, dict(rtol=GRAD_RTOL, atol=GRAD_RTOL * float(np.abs(gx_r).max())), "x")
    _grads_close(tp, jax.tree.map(np.asarray, gp_r), "params")


def test_mla_decode_refuses_a_position_past_the_cache():
    """The reference's ``dynamic_update_slice_in_dim`` clamps such a start
    (and so overwrites the last slot); the port raises instead."""
    cfg, params, x, _ = _mla_case(0, s=1)
    tcfg = t_mla.MLAConfig(*cfg)
    cache = (torch.zeros((2, 4, cfg.kv_lora_rank)), torch.zeros((2, 4, cfg.qk_rope_dim)))
    _, (cos, sin) = _tables(1, cfg.qk_rope_dim, offset=4)
    with pytest.raises(IndexError, match="outside the cache"):
        t_mla.mla_decode(_tree_torch(params), torch.tensor(x), tcfg, cos, sin, cache, 4)
