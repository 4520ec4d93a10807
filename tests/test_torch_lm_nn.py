"""The port's LM substrate (``repro_torch.nn``) against the reference's
(``src/repro/nn/``), function by function, on the CPU at small sizes.

Inputs are seeded numpy arrays; weights come from the reference's own
initialisers and are carried across as numpy.  Tolerances (``rtol = atol``):
  * 1e-5 at float32;
  * at float64, 1e-12 where no float32 island is crossed (RoPE with given
    tables, the feed-forward blocks) and 1e-6 where one is (the attention
    softmax state, the RG-LRU gates and state, the whole SSD scan), as the
    reference runs those islands in float32 at every activation dtype.
The RG-LRU scan and the SSD einsums sum in another order than the
reference's; the tolerances cover that.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import attention as r_attn
from repro.nn import ffn as r_ffn
from repro.nn import rglru as r_rglru
from repro.nn import rope as r_rope
from repro.nn import ssm as r_ssm
from repro_torch.nn import attention as t_attn
from repro_torch.nn import ffn as t_ffn
from repro_torch.nn import layers as t_layers
from repro_torch.nn import rglru as t_rglru
from repro_torch.nn import rope as t_rope
from repro_torch.nn import ssm as t_ssm

F32 = dict(rtol=1e-5, atol=1e-5)
F64_EXACT = dict(rtol=1e-12, atol=1e-12)
F64_ISLAND = dict(rtol=1e-6, atol=1e-6)
# The reference's blocks, jitted (configs and switches static) to keep the
# file cheap: one compile per shape instead of one per eager op.
R_SSD = jax.jit(r_ssm.ssd_scan, static_argnums=5)
R_MAMBA_FWD = jax.jit(r_ssm.mamba2_forward, static_argnums=2)
R_MAMBA_DEC = jax.jit(r_ssm.mamba2_decode, static_argnums=2)
R_RGLRU_FWD = jax.jit(r_rglru.rglru_block_forward, static_argnums=2)
R_RGLRU_DEC = jax.jit(r_rglru.rglru_block_decode, static_argnums=2)
R_BLOCKWISE = jax.jit(r_attn.blockwise_attention,
                      static_argnames=("causal", "window", "chunk_q", "chunk_k", "q_offset",
                                       "causal_skip"))
R_DECODE = jax.jit(r_attn.decode_attention, static_argnames="window")
R_CACHE_UPDATE = jax.jit(r_attn.cache_update, static_argnums=5)
DTYPES = {"float32": (np.float32, jnp.float32, torch.float32),
          "float64": (np.float64, jnp.float64, torch.float64)}


def _rand(rng, shape, dtype=np.float32, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(dtype)


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


def _tree_torch(tree):
    return {k: _tree_torch(v) if isinstance(v, dict) else torch.tensor(np.asarray(v))
            for k, v in tree.items()}


def _close(got, want, tol):
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float64), **tol)


# ---------------------------------------------------------------------------
# RoPE, feed-forward, norms, sinusoidal positions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rotary", [None, 8])
def test_apply_rope(dtype, rotary):
    npd, jd, _ = DTYPES[dtype]
    rng = np.random.default_rng(0)
    x = _rand(rng, (2, 3, 7, 16), npd)
    pos = np.arange(5, 12)
    rd = rotary or 16
    cos_r, sin_r = r_rope.rope_cos_sin(jnp.asarray(pos), rd, 1e4)
    cos_t, sin_t = t_rope.rope_cos_sin(torch.tensor(pos), rd, 1e4)
    _close(cos_t, cos_r, F32)
    _close(sin_t, sin_r, F32)
    cos, sin = np.asarray(cos_r), np.asarray(sin_r)  # the same float32 tables
    want = r_rope.apply_rope(jnp.asarray(x), jnp.asarray(cos), jnp.asarray(sin), rotary)
    got = t_rope.apply_rope(torch.tensor(x), torch.tensor(cos), torch.tensor(sin), rotary)
    assert got.dtype == torch.tensor(x).dtype
    _close(got, want, F32 if dtype == "float32" else F64_EXACT)
    if rotary:  # the unrotated half passes through untouched
        assert torch.equal(got[..., rotary:], torch.tensor(x)[..., rotary:])


@pytest.mark.parametrize("dtype", DTYPES)
def test_feed_forward_blocks(dtype):
    npd, jd, _ = DTYPES[dtype]
    rng = np.random.default_rng(1)
    x = _rand(rng, (2, 5, 16), npd)
    tol = F32 if dtype == "float32" else F64_EXACT
    sw = _tree_np(r_ffn.swiglu_init(jax.random.PRNGKey(0), 16, 24))
    _close(t_ffn.swiglu(_tree_torch(sw), torch.tensor(x)),
           r_ffn.swiglu(sw, jnp.asarray(x)), tol)
    gm = _tree_np(r_ffn.gelu_mlp_init(jax.random.PRNGKey(1), 16, 24))
    # 3 * x: the tanh and erf forms of GELU differ by up to ~1e-3 there.
    _close(t_ffn.gelu_mlp(_tree_torch(gm), torch.tensor(3 * x)),
           r_ffn.gelu_mlp(gm, jnp.asarray(3 * x)), tol)


@pytest.mark.parametrize("dtype", DTYPES)
def test_norms_and_positions(dtype):
    from repro.nn import layers as r_layers

    npd, _, _ = DTYPES[dtype]
    rng = np.random.default_rng(2)
    x = _rand(rng, (2, 5, 16), npd, 3.0)
    p = {"scale": _rand(rng, (16,)), "bias": _rand(rng, (16,))}
    tp = {k: torch.tensor(v) for k, v in p.items()}
    # float32 statistics at every dtype: a float32 island.
    tol = F32 if dtype == "float32" else F64_ISLAND
    _close(t_layers.rmsnorm(tp, torch.tensor(x), 1e-5), r_layers.rmsnorm(p, jnp.asarray(x), 1e-5),
           tol)
    _close(t_layers.layernorm(tp, torch.tensor(x)), r_layers.layernorm(p, jnp.asarray(x)), tol)
    pos = np.arange(0, 40, 3)
    _close(t_layers.sinusoidal_positions(torch.tensor(pos), 16),
           r_layers.sinusoidal_positions(jnp.asarray(pos), 16), F32)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

HEADS = {"mha": (4, 4), "gqa": (4, 2), "mqa": (4, 1)}


@pytest.mark.parametrize("causal_skip", [False, True], ids=["full", "pairs"])
@pytest.mark.parametrize("heads", HEADS)
@pytest.mark.parametrize("window", [None, 5], ids=["causal", "window5"])
def test_blockwise_attention(causal_skip, heads, window):
    hq, hkv = HEADS[heads]
    rng = np.random.default_rng(3)
    # 12 tokens at chunk 8: _pick takes the largest divisor, 6.
    q = _rand(rng, (2, hq, 12, 8))
    k = _rand(rng, (2, hkv, 12, 8))
    v = _rand(rng, (2, hkv, 12, 8))
    kw = dict(causal=True, window=window, chunk_q=8, chunk_k=8, causal_skip=causal_skip)
    want = R_BLOCKWISE(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    got = t_attn.blockwise_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v), **kw)
    _close(got, want, F32)


@pytest.mark.parametrize("causal_skip", [False, True], ids=["full", "pairs"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_blockwise_attention_q_offset(causal_skip, dtype):
    """A later query chunk (``q_offset > 0``) against the whole key range,
    windowed; at float64 through the float32 softmax island."""
    npd = DTYPES[dtype][0]
    rng = np.random.default_rng(4)
    q = _rand(rng, (1, 4, 6, 8), npd)
    k = _rand(rng, (1, 2, 16, 8), npd)
    v = _rand(rng, (1, 2, 16, 8), npd)
    kw = dict(causal=True, window=7, chunk_q=4, chunk_k=4, q_offset=10,
              causal_skip=causal_skip)
    want = R_BLOCKWISE(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    got = t_attn.blockwise_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v), **kw)
    assert got.dtype == torch.tensor(q).dtype
    _close(got, want, F32 if dtype == "float32" else F64_ISLAND)


@pytest.mark.parametrize("window", [None, 6], ids=["full", "rolling"])
@pytest.mark.parametrize("heads", ["gqa", "mqa"])
def test_decode_attention_and_cache_update(window, heads):
    """Step a cache through positions before and after a rolling window
    wraps; each step's update and attention against the reference's."""
    hq, hkv = HEADS[heads]
    rng = np.random.default_rng(5)
    size = 16 if window is None else window
    kc = _rand(rng, (2, hkv, size, 8))
    vc = _rand(rng, (2, hkv, size, 8))
    rk, rv, tk, tv = jnp.asarray(kc), jnp.asarray(vc), torch.tensor(kc), torch.tensor(vc)
    for pos in [0, 3, 5, 6, 9, 13]:
        q = _rand(rng, (2, hq, 1, 8))
        kn = _rand(rng, (2, hkv, 1, 8))
        vn = _rand(rng, (2, hkv, 1, 8))
        rk, rv = R_CACHE_UPDATE(rk, rv, jnp.asarray(kn), jnp.asarray(vn), jnp.int32(pos),
                                window)
        before = tk.clone()
        tk2, tv2 = t_attn.cache_update(tk, tv, torch.tensor(kn), torch.tensor(vn), pos, window)
        assert torch.equal(tk, before)  # the given cache is left as it was
        tk, tv = tk2, tv2
        assert np.array_equal(tk.numpy(), np.asarray(rk))
        assert np.array_equal(tv.numpy(), np.asarray(rv))
        want = R_DECODE(jnp.asarray(q), rk, rv, jnp.int32(pos), window=window)
        got = t_attn.decode_attention(torch.tensor(q), tk, tv, pos, window=window)
        _close(got, want, F32)


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------


def _rglru_setup(dtype):
    npd = DTYPES[dtype][0]
    cfg_r = r_rglru.RGLRUConfig(d_model=16, d_rnn=12)
    cfg_t = t_rglru.RGLRUConfig(d_model=16, d_rnn=12)
    p = _tree_np(r_rglru.rglru_block_init(jax.random.PRNGKey(2), cfg_r))
    rng = np.random.default_rng(6)
    x = _rand(rng, (2, 11, 16), npd)
    h0 = _rand(rng, (2, 12), np.float32, 0.5)
    conv0 = _rand(rng, (2, 3, 12), npd, 0.5)
    return cfg_r, cfg_t, p, _tree_torch(p), x, h0, conv0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("carried", [False, True], ids=["fresh", "carried"])
def test_rglru_forward(dtype, carried):
    cfg_r, cfg_t, p, tp, x, h0, conv0 = _rglru_setup(dtype)
    tol = F32 if dtype == "float32" else F64_ISLAND
    rs = (jnp.asarray(h0), jnp.asarray(conv0)) if carried else None
    ts = (torch.tensor(h0), torch.tensor(conv0)) if carried else None
    y_r, (h_r, c_r) = R_RGLRU_FWD(p, jnp.asarray(x), cfg_r, rs)
    y_t, (h_t, c_t) = t_rglru.rglru_block_forward(tp, torch.tensor(x), cfg_t, ts)
    _close(y_t, y_r, tol)
    assert h_t.dtype == torch.float32
    _close(h_t, h_r, tol)
    _close(c_t, c_r, tol)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rglru_decode_stepped(dtype):
    """rglru_block_decode stepped over the sequence: against the
    reference's steps, and against the port's own full-sequence forward
    from the same carried state."""
    cfg_r, cfg_t, p, tp, x, h0, conv0 = _rglru_setup(dtype)
    tol = F32 if dtype == "float32" else F64_ISLAND
    rs = (jnp.asarray(h0), jnp.asarray(conv0))
    ts = (torch.tensor(h0), torch.tensor(conv0))
    ys = []
    for t in range(x.shape[1]):
        y_r, rs = R_RGLRU_DEC(p, jnp.asarray(x[:, t : t + 1]), cfg_r, rs)
        y_t, ts = t_rglru.rglru_block_decode(tp, torch.tensor(x[:, t : t + 1]), cfg_t, ts)
        _close(y_t, y_r, tol)
        _close(ts[0], rs[0], tol)
        ys.append(y_t)
    y_full, (h_full, _) = t_rglru.rglru_block_forward(
        tp, torch.tensor(x), cfg_t, (torch.tensor(h0), torch.tensor(conv0)))
    _close(torch.cat(ys, dim=1), y_full.numpy(), F32)
    _close(ts[0], h_full.numpy(), F32)


# ---------------------------------------------------------------------------
# Mamba-2 / SSD
# ---------------------------------------------------------------------------


def _mamba_cfgs(chunk=4):
    kw = dict(d_model=16, d_inner=32, n_heads=4, head_p=8, n_groups=2, d_state=6, chunk=chunk)
    return r_ssm.Mamba2Config(**kw), t_ssm.Mamba2Config(**kw)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_h0", [False, True], ids=["zero_state", "h0"])
def test_ssd_scan(dtype, with_h0):
    """11 steps at chunk 4: padded with dt = 0 steps to 12."""
    npd = DTYPES[dtype][0]
    cfg_r, cfg_t = _mamba_cfgs()
    rng = np.random.default_rng(7)
    xh = _rand(rng, (2, 11, 4, 8), npd)
    dt = np.abs(_rand(rng, (2, 11, 4), np.float32, 0.5))
    a = -np.linspace(0.5, 2.0, 4).astype(np.float32)
    bm = _rand(rng, (2, 11, 2, 6), npd)
    cm = _rand(rng, (2, 11, 2, 6), npd)
    h0 = _rand(rng, (2, 4, 8, 6), np.float32) if with_h0 else None
    y_r, h_r = R_SSD(*map(jnp.asarray, (xh, dt, a, bm, cm)), cfg_r,
                              None if h0 is None else jnp.asarray(h0))
    y_t, h_t = t_ssm.ssd_scan(*map(torch.tensor, (xh, dt, a, bm, cm)), cfg_t,
                              None if h0 is None else torch.tensor(h0))
    tol = F32 if dtype == "float32" else F64_ISLAND
    assert y_t.dtype == torch.tensor(xh).dtype and h_t.dtype == torch.float32
    _close(y_t, y_r, tol)
    _close(h_t, h_r, tol)


def test_segsum():
    x = _rand(np.random.default_rng(8), (3, 5))
    want = np.asarray(r_ssm._segsum(jnp.asarray(x)))
    got = t_ssm._segsum(torch.tensor(x)).numpy()
    assert np.array_equal(np.isinf(got), np.isinf(want))
    _close(np.where(np.isinf(got), 0, got), np.where(np.isinf(want), 0, want), F32)


@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba2_forward_and_decode(dtype):
    """The full-sequence forward, then decode steps from its states, each
    against the reference's; the port's steps against its own forward over
    the longer sequence."""
    npd = DTYPES[dtype][0]
    cfg_r, cfg_t = _mamba_cfgs()
    p = _tree_np(r_ssm.mamba2_init(jax.random.PRNGKey(3), cfg_r))
    tp = _tree_torch(p)
    rng = np.random.default_rng(9)
    x = _rand(rng, (2, 13, 16), npd)
    tol = F32 if dtype == "float32" else F64_ISLAND
    y_r, (c_r, h_r) = R_MAMBA_FWD(p, jnp.asarray(x[:, :9]), cfg_r)
    y_t, (c_t, h_t) = t_ssm.mamba2_forward(tp, torch.tensor(x[:, :9]), cfg_t)
    _close(y_t, y_r, tol)
    _close(c_t, c_r, tol)
    _close(h_t, h_r, tol)
    rs, ts, ys = (c_r, h_r), (c_t, h_t), []
    for t in range(9, 13):
        y_r, rs = R_MAMBA_DEC(p, jnp.asarray(x[:, t : t + 1]), cfg_r, rs)
        y_t, ts = t_ssm.mamba2_decode(tp, torch.tensor(x[:, t : t + 1]), cfg_t, ts)
        _close(y_t, y_r, tol)
        _close(ts[1], rs[1], tol)
        ys.append(y_t)
    y_full, _ = t_ssm.mamba2_forward(tp, torch.tensor(x), cfg_t)
    _close(torch.cat(ys, dim=1), y_full[:, 9:].numpy(), F32)
