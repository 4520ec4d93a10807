"""GPU tests of the port's CUDA kernels: each kernel against its plain
PyTorch version on the same CUDA tensors, and the engine on the card against
the engine on the CPU.  Marked ``gpu``; they skip where there is no card.

This file imports neither JAX nor the JAX package, so on a machine without
JAX it runs on its own:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Kernel and plain version must agree bitwise (as values) on integer-valued
and general-float inputs alike: the plain version sums each chunk in the
kernels' order (``ref.warp_order_sum``) and the kernels are built without FMA
contraction.
"""
import numpy as np
import pytest
import torch

import repro_torch as rt
import repro_torch.data as td
from repro_torch.core import INF, col_pad
from repro_torch import kernels as tk
from repro_torch.kernels import ref as tref

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def gen():
    return np.random.default_rng(0)


def _tiles(gen, t, r, k, n, integer, dev):
    val = gen.choice([-2.0, -1.0, 0.0, 1.0, 3.0], size=(t, r, k))
    col = gen.integers(0, n, size=(t, r, k)).astype(np.int32)
    col[val == 0] = 0
    n_pad = col_pad(n)
    if integer:
        lb = gen.integers(-5, 1, size=n_pad).astype(np.float64)
        ub = gen.integers(0, 6, size=n_pad).astype(np.float64)
        lhs = gen.integers(-10, 1, size=(t, r)).astype(np.float64)
        rhs = gen.integers(0, 11, size=(t, r)).astype(np.float64)
    else:
        lb, ub = gen.uniform(-5, 0, size=n_pad), gen.uniform(0, 5, size=n_pad)
        lhs, rhs = gen.uniform(-10, 0, size=(t, r)), gen.uniform(0, 10, size=(t, r))
    lb[gen.random(n_pad) < 0.15] = -INF
    ub[gen.random(n_pad) < 0.15] = INF
    ii = (gen.random((t, r, k)) < 0.5).astype(np.int32)
    ii[val == 0] = 0
    c = lambda x: torch.from_numpy(np.array(x)).to(dev)
    return dict(val=c(val), col=c(col), ii=c(ii), lb=c(lb), ub=c(ub), lhs=c(lhs),
                rhs=c(rhs), n_pad=n_pad)


def _match(got, want):
    torch.cuda.synchronize()
    g, w = got.cpu().numpy(), want.cpu().numpy()
    assert g.dtype == w.dtype and g.shape == w.shape
    np.testing.assert_array_equal(g, w)


SHAPES = [(1, 2, 4, 3), (3, 4, 8, 20), (5, 8, 128, 300), (64, 8, 128, 5000)]


@pytest.mark.parametrize("exact", [True, False], ids=["int", "float"])
@pytest.mark.parametrize("t,r,k,n", SHAPES)
def test_kernels_match_plain_versions(cuda, gen, t, r, k, n, exact):
    x = _tiles(gen, t, r, k, n, exact, cuda)
    tk.reset_launch_counts()
    d_args = (x["val"], x["col"], x["ii"], x["lhs"], x["rhs"], x["lb"], x["ub"], x["n_pad"], 1e-6)
    for g, w in zip(tk.fused_scatter_round_tiles(*d_args),
                    tref.fused_scatter_round_tiles_ref(*d_args)):
        _match(g, w)

    a_args = (x["val"], x["col"], x["lb"], x["ub"], x["n_pad"])
    aggs = tk.activities_gather_tiles(*a_args)
    for g, w in zip(aggs, tref.activities_gather_tiles_ref(*a_args)):
        _match(g, w)

    e_args = (x["val"], x["col"], x["ii"], *aggs, x["lhs"], x["rhs"], x["lb"], x["ub"],
              x["n_pad"], 1e-6)
    for g, w in zip(tk.candidates_scatter_tiles(*e_args),
                    tref.candidates_scatter_tiles_ref(*e_args)):
        _match(g, w)

    best_l, best_u = tref.fused_scatter_round_tiles_ref(*d_args)
    want = rt.core.apply_updates(x["lb"], x["ub"], best_l, best_u, 1e-9)
    lb, ub = x["lb"].clone(), x["ub"].clone()
    got = tk.apply_updates_tiles(lb, ub, best_l, best_u, 1e-9)
    assert got[0] is lb and got[1] is ub
    for g, w in zip(got, want):
        _match(g, w)
    assert tk.launch_counts() == {fn.__name__: 1 for fn in tk.KERNELS}


def test_wrappers_check_operands(cuda, gen):
    x = _tiles(gen, 2, 2, 4, 10, True, cuda)
    with pytest.raises(TypeError, match="col"):
        tk.activities_gather_tiles(x["val"], x["col"].long(), x["lb"], x["ub"], x["n_pad"])
    with pytest.raises(ValueError, match="lb"):
        tk.activities_gather_tiles(x["val"], x["col"], x["lb"][:-1], x["ub"], x["n_pad"])
    with pytest.raises(ValueError, match="device"):
        tk.activities_gather_tiles(x["val"], x["col"], x["lb"].cpu(), x["ub"], x["n_pad"])


@pytest.mark.parametrize("gen_name,kw,tile_width,exact", [
    ("make_pseudo_boolean", dict(n=3000, m=4000, seed=7), 128, True),
    ("make_pseudo_boolean", dict(n=3000, m=4000, seed=7), 4, True),
    ("make_cascade_chain", dict(length=40), 4, True),
    ("make_mixed", dict(m=600, n=450, seed=21), 128, False),
    ("make_mixed", dict(m=600, n=450, seed=21), 16, False),
])
def test_engine_on_card_matches_cpu(cuda, gen_name, kw, tile_width, exact):
    p = getattr(td, gen_name)(**kw)
    tk.reset_launch_counts()
    got = rt.propagate_block_ell(p, tile_width=tile_width)
    want = rt.propagate_block_ell(p, tile_width=tile_width, device="cpu")
    counts = tk.launch_counts()
    assert counts["apply_updates_tiles"] == int(got.rounds)
    if tk.rows_fit_one_chunk(p, tile_width):
        assert counts["fused_scatter_round_tiles"] == int(got.rounds)
    else:
        rounds = int(got.rounds)
        assert counts["activities_gather_tiles"] == counts["candidates_scatter_tiles"] == rounds
    assert got.lb.device.type == "cuda"
    for f in ("rounds", "converged", "infeasible"):
        assert getattr(got, f).item() == getattr(want, f).item()
    if exact:
        np.testing.assert_array_equal(got.lb.cpu().numpy(), want.lb.numpy())
        np.testing.assert_array_equal(got.ub.cpu().numpy(), want.ub.numpy())
    else:
        assert rt.bounds_equal(got.lb, got.ub, want.lb, want.ub)
