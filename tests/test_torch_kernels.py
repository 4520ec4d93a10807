"""The plain versions of the port's four round kernels (D, E, A', F) against
the reference's Pallas kernels, which run in interpret mode on the CPU.

Tolerances: on integer-valued tiles every output must be bitwise equal (as
values); on general floats the float outputs agree to ``rtol=1e-12, atol=0``
because the row sums are taken in another order.  Infinity counts are exact
everywhere.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import INF
from repro.core import bounds as rbnd
from repro.kernels import (
    activities_gather_tiles as r_activities_gather,
    apply_updates_tiles as r_apply_updates,
    candidates_scatter_tiles as r_candidates_scatter,
    col_pad,
    fused_scatter_round_tiles as r_fused_scatter,
)
from repro.kernels import ref as rref
from repro_torch.core import bounds as tbnd
from repro_torch.kernels import (
    activities_gather_tiles,
    apply_updates_tiles,
    candidates_scatter_tiles,
    fused_scatter_round_tiles,
    launch_counts,
    ref as tref,
    reset_launch_counts,
)

SHAPES = [(1, 2, 4, 3), (3, 4, 8, 20), (2, 8, 16, 150), (2, 8, 128, 300)]
EXACT = [True, False]


def _tiles(rng, t, r, k, n, integer, inf_frac=0.15):
    """Random kernel inputs with block-ELL conventions (val == 0 and col == 0
    mark padding); ``integer`` makes every bound and side integer-valued."""
    val = rng.choice([-2.0, -1.0, 0.0, 1.0, 3.0], size=(t, r, k))
    col = rng.integers(0, n, size=(t, r, k)).astype(np.int32)
    col[val == 0] = 0
    n_pad = col_pad(n)
    if integer:
        lb = rng.integers(-5, 1, size=n_pad).astype(np.float64)
        ub = rng.integers(0, 6, size=n_pad).astype(np.float64)
        lhs = rng.integers(-10, 1, size=(t, r)).astype(np.float64)
        rhs = rng.integers(0, 11, size=(t, r)).astype(np.float64)
    else:
        lb = rng.uniform(-5, 0, size=n_pad)
        ub = rng.uniform(0, 5, size=n_pad)
        lhs = rng.uniform(-10, 0, size=(t, r))
        rhs = rng.uniform(0, 10, size=(t, r))
    lb[rng.random(n_pad) < inf_frac] = -INF
    ub[rng.random(n_pad) < inf_frac] = INF
    lhs[rng.random((t, r)) < inf_frac] = -INF
    rhs[rng.random((t, r)) < inf_frac] = INF
    ii = (rng.random((t, r, k)) < 0.5).astype(np.int32)
    ii[val == 0] = 0
    return dict(val=val, col=col, ii=ii, lb=lb, ub=ub, lhs=lhs, rhs=rhs, n_pad=n_pad)


def _j(x):
    return jnp.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _assert_match(got, want, exact):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if exact or got.dtype.kind == "i":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


@pytest.mark.parametrize("exact", EXACT, ids=["int", "float"])
@pytest.mark.parametrize("t,r,k,n", SHAPES)
def test_fused_scatter_round_matches_pallas(t, r, k, n, exact, rng):
    x = _tiles(rng, t, r, k, n, exact)
    want = r_fused_scatter(
        _j(x["val"]), _j(x["col"]), _j(x["ii"]), _j(x["lhs"]), _j(x["rhs"]),
        _j(x["lb"]), _j(x["ub"]), x["n_pad"], int_eps=1e-6, interpret=True,
    )
    got = fused_scatter_round_tiles(
        _t(x["val"]), _t(x["col"]), _t(x["ii"]), _t(x["lhs"]), _t(x["rhs"]),
        _t(x["lb"]), _t(x["ub"]), x["n_pad"], int_eps=1e-6,
    )
    for g, w in zip(got, want):
        _assert_match(g, w, exact)


@pytest.mark.parametrize("exact", EXACT, ids=["int", "float"])
@pytest.mark.parametrize("t,r,k,n", SHAPES)
def test_activities_gather_matches_pallas(t, r, k, n, exact, rng):
    x = _tiles(rng, t, r, k, n, exact)
    want = r_activities_gather(
        _j(x["val"]), _j(x["col"]), _j(x["lb"]), _j(x["ub"]), x["n_pad"], interpret=True
    )
    got = activities_gather_tiles(
        _t(x["val"]), _t(x["col"]), _t(x["lb"]), _t(x["ub"]), x["n_pad"]
    )
    for g, w in zip(got, want):
        _assert_match(g, w, exact)


@pytest.mark.parametrize("exact", EXACT, ids=["int", "float"])
@pytest.mark.parametrize("t,r,k,n", SHAPES)
def test_candidates_scatter_matches_pallas(t, r, k, n, exact, rng):
    x = _tiles(rng, t, r, k, n, exact)
    # Completed row aggregates as the engine feeds them: the oracle's own
    # partials, so both packages see identical (T, R) inputs.
    lb_g, ub_g = x["lb"][x["col"]], x["ub"][x["col"]]
    aggs = [np.asarray(a) for a in rref.activities_tiles_ref(_j(x["val"]), _j(lb_g), _j(ub_g))]
    want = r_candidates_scatter(
        _j(x["val"]), _j(x["col"]), _j(x["ii"]), *map(_j, aggs), _j(x["lhs"]),
        _j(x["rhs"]), _j(x["lb"]), _j(x["ub"]), x["n_pad"], int_eps=1e-6,
        interpret=True,
    )
    got = candidates_scatter_tiles(
        _t(x["val"]), _t(x["col"]), _t(x["ii"]), *map(_t, aggs), _t(x["lhs"]),
        _t(x["rhs"]), _t(x["lb"]), _t(x["ub"]), x["n_pad"], int_eps=1e-6,
    )
    for g, w in zip(got, want):
        _assert_match(g, w, exact)


@pytest.mark.parametrize("exact", EXACT, ids=["int", "float"])
def test_apply_updates_matches_pallas(exact, rng):
    n_pad = 256
    if exact:
        lb = rng.integers(-5, 1, n_pad).astype(np.float64)
        ub = rng.integers(0, 6, n_pad).astype(np.float64)
        best_l = rng.integers(-6, 3, n_pad).astype(np.float64)
        best_u = rng.integers(-2, 7, n_pad).astype(np.float64)
    else:
        lb, ub = rng.uniform(-5, 0, n_pad), rng.uniform(0, 5, n_pad)
        best_l, best_u = rng.uniform(-6, 2, n_pad), rng.uniform(-2, 6, n_pad)
    best_l[rng.random(n_pad) < 0.2] = -INF
    best_u[rng.random(n_pad) < 0.2] = INF
    want = r_apply_updates(_j(lb), _j(ub), _j(best_l), _j(best_u), eps=1e-9, interpret=True)
    tlb, tub = _t(lb.copy()), _t(ub.copy())
    got = apply_updates_tiles(tlb, tub, _t(best_l), _t(best_u), eps=1e-9)
    assert got[0] is tlb and got[1] is tub  # the merge is in place
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert bool(got[2]) == bool(want[2])


def test_apply_updates_no_change_and_outward(rng):
    """An all-sentinel candidate set changes nothing; a nonzero ``outward``
    widens exactly as the reference's shared merge does."""
    n_pad = 128
    lb, ub = rng.uniform(-5, 0, n_pad), rng.uniform(0, 5, n_pad)
    got = apply_updates_tiles(
        _t(lb.copy()), _t(ub.copy()), _t(np.full(n_pad, -INF)), _t(np.full(n_pad, INF)), 1e-9
    )
    assert not bool(got[2])
    np.testing.assert_array_equal(got[0].numpy(), lb)
    best_l, best_u = rng.uniform(-6, 2, n_pad), rng.uniform(-2, 6, n_pad)
    want = rbnd.apply_updates(_j(lb), _j(ub), _j(best_l), _j(best_u), 1e-5, outward=2.0**-17)
    got = tbnd.apply_updates(_t(lb), _t(ub), _t(best_l), _t(best_u), 1e-5, outward=2.0**-17)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("exact", EXACT, ids=["int", "float"])
def test_tile_oracles_match_reference(exact, rng):
    """The port's materializing oracles (kernels A, B, C and the column
    reduction) against the reference's jnp oracles."""
    x = _tiles(rng, 3, 4, 16, 90, exact)
    lb_g, ub_g = x["lb"][x["col"]], x["ub"][x["col"]]
    ii = x["ii"] != 0
    want = rref.fused_round_tiles_ref(
        _j(x["val"]), _j(lb_g), _j(ub_g), _j(ii), _j(x["lhs"]), _j(x["rhs"]), 1e-6
    )
    got = tref.fused_round_tiles_ref(
        _t(x["val"]), _t(lb_g), _t(ub_g), _t(ii), _t(x["lhs"]), _t(x["rhs"]), 1e-6
    )
    for g, w in zip(got, want):
        _assert_match(g, w, exact)
    want_s = rref.scatter_round_ref(want[0], want[1], _j(x["col"]), x["n_pad"])
    got_s = tref.scatter_round_ref(got[0], got[1], _t(x["col"]), x["n_pad"])
    for g, w in zip(got_s, want_s):
        _assert_match(g, w, exact)


def test_cpu_tensors_never_count_launches(rng):
    """On CPU tensors the wrappers run the plain versions and launch nothing."""
    x = _tiles(rng, 2, 2, 4, 10, True)
    reset_launch_counts()
    fused_scatter_round_tiles(
        _t(x["val"]), _t(x["col"]), _t(x["ii"]), _t(x["lhs"]), _t(x["rhs"]),
        _t(x["lb"]), _t(x["ub"]), x["n_pad"], int_eps=1e-6,
    )
    assert set(launch_counts().values()) == {0}


def test_wrappers_reject_mixed_devices(rng):
    x = _tiles(rng, 1, 2, 4, 3, True)
    with pytest.raises(ValueError, match="device"):
        activities_gather_tiles(
            _t(x["val"]), _t(x["col"]), _t(x["lb"]), _t(x["ub"]).to("meta"), x["n_pad"]
        )


def _warp_sum_emulated(row):
    """The CUDA kernels' row sum, written lane by lane: lane l adds slots
    l, l + 32, ... from 0.0, then xor shuffles with offsets 16, 8, 4, 2, 1."""
    lanes = [0.0] * 32
    for j, v in enumerate(row):
        lanes[j % 32] = lanes[j % 32] + v
    off = 16
    while off:
        lanes = [lanes[i] + lanes[i ^ off] for i in range(32)]
        off //= 2
    return lanes[0]


@pytest.mark.parametrize("k", [1, 4, 32, 128, 200])
def test_warp_order_sum_is_the_kernel_order(k, rng):
    x = rng.standard_normal((6, k)) * 10.0 ** rng.integers(-8, 9, size=(6, k))
    got = tref.warp_order_sum(torch.from_numpy(x)).numpy()
    want = np.array([_warp_sum_emulated(row) for row in x])
    np.testing.assert_array_equal(got, want)
