"""The port's precision tiers (``repro_torch``: float32, ``TierPolicy``, the
compact index streams and the progress-based early stop) against the
reference's (``tests/test_precision.py`` and its ``src/repro/core/types.py``,
``core/bounds.py``, ``core/propagator.py`` and ``kernels/ops.py``), on the
CPU at small sizes.

Contracts, as the reference's:
  * never tighter: float32 fixed points stay outside the float64 sequential
    oracle's, exactly for integer variables and within ``F32_BAND``
    relative for continuous ones;
  * two tiers land on the float64 fixed point (integer bounds bitwise,
    continuous within the band), and an fp32 infeasible verdict is never
    trusted;
  * the early stop only cuts the trajectory.
Against the reference directly: the float32 plain kernel versions against
``repro.kernels.ref`` (bitwise on the exact-data families
``make_set_cover``, ``make_knapsack``, ``make_cascade_chain``,
``bounds_equal`` elsewhere); the float32 and two-tier fixed points with the
reference's ``rounds``, ``converged``, ``infeasible`` and ``tier_rounds``
(bounds bitwise on the exact families); the drivers bitwise within the
port.

The reference's block-ELL fixed point is run through its own
``round_fn_for`` (``use_pallas=False``), which widens the fp32 tier's merges
outward as its ``propagate`` and the port do; its ``propagate_block_ell``
builds the round without ``outward`` (src/repro/kernels/ops.py:1262), so
its fp32 tier merges exactly (ROADMAP Queue 3, reference note).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as rc
import repro.core.bounds as rbnd
import repro.core.types as rtypes
import repro.data as rd
import repro.kernels as rk
import repro.kernels.ref as rref
from repro.kernels import ops as rops
import repro_torch as rt
import repro_torch.core.propagator as tprop
from repro_torch import kernels as tk
from repro_torch.core import carry as tcarry
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

F32_BAND = 1e-6  # the reference's (tests/test_precision.py)
EXACT = ("knapsack", "knapsack1", "set_cover", "cascade")
# The instances run through the reference itself (each run compiles JAX
# programs): the exact families, a general-float one and the pseudo-boolean.
AGAINST_REFERENCE = ("set_cover", "cascade", "mixed", "pb")


@functools.lru_cache(maxsize=None)
def _population():
    """The reference's ``_population()`` (tests/test_precision.py:63) and a
    cascade chain: (name, reference problem, port problem)."""
    pop = [
        ("knapsack", rd.make_knapsack(n=50, m=10, seed=0)),
        ("knapsack1", rd.make_knapsack(n=50, m=10, seed=1)),
        ("set_cover", rd.make_set_cover(n=60, m=20, seed=0)),
        ("mixed", rd.make_mixed(m=80, n=60, seed=0)),
        ("mixed1", rd.make_mixed(m=80, n=60, seed=3)),
        ("banded", rd.make_banded(n=384, m=64, row_nnz=8, band=48, seed=0)),
        ("pb", rd.make_pseudo_boolean(n=60, m=40, seed=0)),
        ("cascade", rd.make_cascade_chain(length=16)),
    ]
    return tuple((name, pr, rt.problem_from_reference(pr)) for name, pr in pop)


def _case(name):
    return next(c for c in _population() if c[0] == name)


def _np(x):
    return x.detach().cpu().double().numpy() if isinstance(x, torch.Tensor) else (
        np.asarray(x, np.float64))


def _assert_never_tighter(name, lb_t, ub_t, lb_o, ub_o, is_int, band):
    """The reference's ``_assert_never_tighter`` (tests/test_precision.py:91)."""
    inf = rc.INF
    lb_t, ub_t = _np(lb_t), _np(ub_t)
    assert not np.any((lb_o <= -inf / 2) & (lb_t > -inf / 2)), name
    assert not np.any((ub_o >= inf / 2) & (ub_t < inf / 2)), name
    fin_l, fin_u = lb_o > -inf / 2, ub_o < inf / 2
    tol = np.where(is_int, 0.0, band * (1.0 + np.abs(lb_o)))
    assert np.all(lb_t[fin_l] <= (lb_o + tol)[fin_l]), name
    tol = np.where(is_int, 0.0, band * (1.0 + np.abs(ub_o)))
    assert np.all(ub_t[fin_u] >= (ub_o - tol)[fin_u]), name


def _assert_same_fixed_point(name, got, r64, is_int):
    """The reference's ``_assert_same_fixed_point`` (tests/test_precision.py:197)."""
    lb_t, ub_t, lb_r, ub_r = _np(got.lb), _np(got.ub), _np(r64.lb), _np(r64.ub)
    assert np.array_equal(lb_t[is_int], lb_r[is_int]), name
    assert np.array_equal(ub_t[is_int], ub_r[is_int]), name
    assert np.all(np.abs(lb_t - lb_r) <= F32_BAND * (1.0 + np.abs(lb_r))), name
    assert np.all(np.abs(ub_t - ub_r) <= F32_BAND * (1.0 + np.abs(ub_r))), name
    assert rt.bounds_equal(lb_t, ub_t, lb_r, ub_r), name


def _assert_flags(got, want):
    for f in ("rounds", "converged", "infeasible", "tier_rounds"):
        assert int(getattr(got, f)) == int(getattr(want, f)), f


# The reference's runs, each once per session: its propagate (pure jnp) at
# float32, under the two-tier policy and under the early stop.
_REF_MODES = {
    "f32": dict(dtype=np.float32),
    "tier": dict(policy=rc.TierPolicy()),
    "stop": dict(dtype=np.float32,
                 policy=rc.TierPolicy(two_tier=False, stop_progress=0.05, patience=1)),
}


@functools.lru_cache(maxsize=None)
def _ref_propagate(name, mode):
    return rc.propagate(_case(name)[1], **_REF_MODES[mode])


# ---------------------------------------------------------------------------
# Types, primitives and helpers (item 1's gaps beside this slice)
# ---------------------------------------------------------------------------


def test_tier_policy_matches_reference():
    assert dataclasses.asdict(rt.core.TierPolicy()) == dataclasses.asdict(rc.TierPolicy())
    assert rt.core.DEFAULT_TIER_POLICY == rt.core.TierPolicy()
    assert [f.name for f in dataclasses.fields(rt.core.TierPolicy)] == [
        f.name for f in dataclasses.fields(rc.TierPolicy)]
    assert rt.core.int_round_slack(torch.float32) == rc.int_round_slack(jnp.float32)
    assert rt.core.int_round_slack(torch.bfloat16) == rc.int_round_slack(jnp.bfloat16)
    assert rt.core.int_round_slack(torch.float64) == 0.0
    r = rt.propagate_block_ell(_case("set_cover")[2], device="cpu")
    assert r.tier_rounds.dtype == torch.int32 and r.tier_rounds.shape == ()
    assert int(r.tier_rounds) == 0


@pytest.mark.parametrize("fn", ["is_pos_inf", "is_neg_inf", "is_inf", "clamp_to_sentinel",
                                "np_is_inf"])
def test_infinity_helpers_match_reference(fn):
    rng = np.random.default_rng(11)
    x = rng.choice([-2e20, -1e20, -3.5, 0.0, 2.25, 1e20, 5e20, 1e19], size=64)
    got = getattr(rt.core, fn)(x if fn == "np_is_inf" else torch.from_numpy(x))
    want = getattr(rtypes, fn)(x if fn == "np_is_inf" else jnp.asarray(x))
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    if fn != "np_is_inf":  # Python scalars too
        for v in (-3e20, 2.5, 1e20):
            assert float(getattr(rt.core, fn)(v)) == float(getattr(rtypes, fn)(v))


def test_col_pad_is_reexported():
    assert tk.col_pad is rt.core.col_pad
    assert [tk.col_pad(n) for n in (1, 60, 128, 129, 60_000)] == [
        rk.col_pad(n) for n in (1, 60, 128, 129, 60_000)]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_widen_outward_progress_and_canonical_match_reference(dtype):
    rng = np.random.default_rng(5)
    lb = rng.choice([-1e20, -3.0, 0.0, 0.5, 7.25], size=40).astype(dtype)
    ub = lb + rng.choice([0.0, 1.0, 2.5, 1e20], size=40).astype(dtype)
    lb2 = np.maximum(lb, rng.uniform(-4, 4, size=40).astype(dtype))
    ub2 = np.minimum(ub, rng.uniform(0, 9, size=40).astype(dtype))
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))
    j = lambda x: jnp.asarray(x)
    for out in (0.0, 2.0**-17):
        got = rt.core.widen_outward(t(lb), t(ub), out)
        want = rc.widen_outward(j(lb), j(ub), out)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    got = rt.core.progress_measure(t(lb), t(ub), t(lb2), t(ub2))
    want = rc.progress_measure(j(lb), j(ub), j(lb2), j(ub2))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert float(rt.core.progress_measure(t(lb), t(ub), t(lb), t(ub))) == 0.0
    got = rt.core.canonical_infinite(t(lb).double() * 1.5, t(ub).double() * 1.5)
    want = rc.canonical_infinite(j(lb).astype(jnp.float64) * 1.5, j(ub).astype(jnp.float64) * 1.5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_compact_index_streams_per_dtype():
    """The reference's test (tests/test_precision.py:164): float32 preps
    narrow the index streams where n_pad fits int16, float64 keeps int32."""
    _, pr, pt = _case("set_cover")
    ref32 = rk.prepare_block_ell(pr, dtype=np.float32)
    prep32 = rt.prepare_block_ell(pt, dtype=np.float32, device="cpu")
    assert prep32.d.col.dtype == torch.int16 and ref32.d.col.dtype == np.int16
    assert prep32.ii_g.dtype == torch.int8 and ref32.ii_g.dtype == np.int8
    np.testing.assert_array_equal(prep32.d.col.numpy(), np.asarray(ref32.d.col))
    np.testing.assert_array_equal(prep32.ii_g.numpy(), np.asarray(ref32.ii_g))
    prep64 = rt.prepare_block_ell(pt, device="cpu")
    assert prep64.d.col.dtype == torch.int32 and prep64.ii_g.dtype == torch.int32


def test_compact_streams_stop_at_the_int16_limit(monkeypatch):
    """Past ``_COMPACT_COL_MAX_NPAD`` a float32 prep keeps int32 streams."""
    _, _, pt = _case("set_cover")
    monkeypatch.setattr(tops, "_COMPACT_COL_MAX_NPAD", 64)  # n_pad is 128
    rt.kernels.clear_prepare_cache()
    prep = rt.prepare_block_ell(pt, dtype=torch.float32, device="cpu")
    assert prep.d.col.dtype == torch.int32 and prep.ii_g.dtype == torch.int32
    rt.kernels.clear_prepare_cache()


# ---------------------------------------------------------------------------
# The five plain kernel versions at float32 against the reference's oracles
# ---------------------------------------------------------------------------


# The reference's kernel oracles and merge, jitted (one compile per shape
# instead of one per operation).
_REF_D = jax.jit(rref.fused_scatter_round_tiles_ref, static_argnums=(7, 8))
_REF_A = jax.jit(rref.activities_gather_tiles_ref, static_argnums=(4,))
_REF_E = jax.jit(rref.candidates_scatter_tiles_ref, static_argnums=(11, 12))
_REF_MERGE = jax.jit(rbnd.apply_updates, static_argnums=(4, 5, 6))
# The reference's long-row combine (src/repro/kernels/ops.py:821).
_REF_COMBINE = jax.jit(
    lambda x, crow, m: jax.ops.segment_sum(x.reshape(-1), crow.reshape(-1), num_segments=m)[crow],
    static_argnums=(2,))


def _prep_pair(name, tile_width):
    _, pr, pt = _case(name)
    return (rk.prepare_block_ell(pr, tile_width=tile_width, dtype=np.float32),
            rt.prepare_block_ell(pt, tile_width=tile_width, dtype=torch.float32, device="cpu"))


def _assert_close(got, want, exact):
    for g, w in zip(got, want):
        g, w = _np(g), _np(w)
        if exact:
            np.testing.assert_array_equal(g, w)
        else:
            assert rt.bounds_equal(g, g, w, w)


@pytest.mark.parametrize("name", ["set_cover", "knapsack", "mixed"])
def test_float32_kernel_plain_versions_match_reference(name):
    """D (or A', the combine and E), then F with the tier's widening, at
    float32 on the compact streams, at the root bounds and one round on."""
    exact = name in EXACT
    cfg = rt.core.DEFAULT_CONFIG
    eps, outward = cfg.eps_for(torch.float32), cfg.outward_for(torch.float32)
    for tile_width in (128, 4):
        rp, tp = _prep_pair(name, tile_width)
        lb_r, ub_r = rp.lb0, rp.ub0
        lb_t, ub_t = tp.lb0.clone(), tp.ub0.clone()
        for _ in range(2):
            if tp.fits_one_chunk:
                want = _REF_D(rp.d.val, rp.d.col, rp.ii_g, rp.lhs_g, rp.rhs_g, lb_r, ub_r,
                              rp.n_pad, cfg.int_eps)
                got = tk.fused_scatter_round_tiles(
                    tp.d.val, tp.d.col, tp.ii_g, tp.lhs_g, tp.rhs_g, lb_t, ub_t, tp.n_pad,
                    cfg.int_eps)
            else:
                wp = _REF_A(rp.d.val, rp.d.col, lb_r, ub_r, rp.n_pad)
                gp = tk.activities_gather_tiles(tp.d.val, tp.d.col, lb_t, ub_t, tp.n_pad)
                _assert_close(gp, wp, exact)
                wa = tuple(_REF_COMBINE(x, rp.d.chunk_row, rp.m + 1) for x in wp)
                ga = tk.combine_chunk_partials_tiles(*gp, tp.d.chunk_row, tp.row_start)
                _assert_close(ga, wa, exact)
                want = _REF_E(rp.d.val, rp.d.col, rp.ii_g, *wa, rp.lhs_g, rp.rhs_g, lb_r, ub_r,
                              rp.n_pad, cfg.int_eps)
                got = tk.candidates_scatter_tiles(
                    tp.d.val, tp.d.col, tp.ii_g, *ga, tp.lhs_g, tp.rhs_g, lb_t, ub_t, tp.n_pad,
                    cfg.int_eps)
            _assert_close(got, want, exact)
            wl, wu, wch = _REF_MERGE(lb_r, ub_r, *want, eps, cfg.inf, outward)
            gl, gu, gch = tk.apply_updates_tiles(lb_t, ub_t, got[0].clone(), got[1].clone(), eps,
                                                 cfg.inf, outward)
            _assert_close((gl, gu), (wl, wu), exact)
            assert bool(gch) == bool(wch)
            lb_r, ub_r, lb_t, ub_t = wl, wu, gl, gu


def test_merge_order_sum_is_the_kernels_order():
    """F's progress sum (``ref.merge_order_sum``): each thread's four
    columns, the warp butterfly, the block's warps left to right, the
    blocks as ``warp_order_sum`` reduces a row; equal to a float64 sum
    within float32 rounding, and bitwise a sum written out in that order."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.uniform(0, 1, 2_500).astype(np.float32))
    got = tref.merge_order_sum(x)
    pad = torch.nn.functional.pad(x, (0, 3 * 1024 - 2_500)).reshape(3, 4, 256)
    threads = ((pad[:, 0] + pad[:, 1]) + pad[:, 2]) + pad[:, 3]
    warps = tref.warp_order_sum(threads.reshape(3, 8, 32))
    blocks = warps[:, 0]
    for w in range(1, 8):
        blocks = blocks + warps[:, w]
    want = tref.warp_order_sum(blocks)
    assert got.dtype == torch.float32 and torch.equal(got, want)
    assert float(got) == pytest.approx(float(x.double().sum()), rel=1e-6)


# ---------------------------------------------------------------------------
# Fixed points
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _ref_block_ell_f32(name, tile_width, scatter="fused"):
    """The reference's block-ELL float32 fixed point on its round closure
    (plain jnp versions, the tier's outward widening) on the engine
    ``scatter``: bounds, rounds, last flag."""
    _, pr, _ = _case(name)
    prep = rk.prepare_block_ell(pr, tile_width=tile_width, dtype=np.float32)
    fn = jax.jit(rk.round_fn_for(prep, use_pallas=False, scatter=scatter))
    lb, ub, rounds, changed = prep.lb0, prep.ub0, 0, True
    while changed and rounds < rc.DEFAULT_CONFIG.max_rounds:
        lb, ub, ch = fn(lb, ub)
        rounds, changed = rounds + 1, bool(ch)
    return np.asarray(lb)[: pr.n], np.asarray(ub)[: pr.n], rounds, changed


@pytest.mark.parametrize("fused", ["auto", "yes", "no"])
def test_float32_block_ell_matches_reference(fused):
    for name in AGAINST_REFERENCE:
        pt = _case(name)[2]
        tile_width = 8
        rp = rk.prepare_block_ell(_case(name)[1], tile_width=tile_width, dtype=np.float32)
        if fused == "yes" and not rp.fits_one_chunk:
            continue
        wl, wu, rounds, changed = _ref_block_ell_f32(name, tile_width)
        for driver in ("host_loop", "device_loop"):
            got = rt.propagate_block_ell(pt, tile_width=tile_width, dtype=np.float32,
                                         fused=fused, driver=driver, device="cpu")
            assert got.lb.dtype == torch.float32
            assert int(got.rounds) == rounds and bool(got.converged) == (not changed), name
            _assert_close((got.lb, got.ub), (wl, wu), name in EXACT)


def test_float32_propagate_matches_reference():
    for name in AGAINST_REFERENCE:
        pt = _case(name)[2]
        want = _ref_propagate(name, "f32")
        for driver in ("host_loop", "device_loop", "unrolled"):
            got = rt.propagate(pt, dtype=np.float32, driver=driver, device="cpu")
            if driver != "unrolled":
                _assert_flags(got, want)
                _assert_close((got.lb, got.ub), (want.lb, want.ub), name in EXACT)


# The block-ELL engines of the tier tests: the partitioned one on 128-column
# slabs (banded's n_pad of 384 splits into three).
ENGINES = {"fused": dict(scatter="fused"), "segment": dict(scatter="segment"),
           "partitioned": dict(scatter="partitioned", slab=128)}


@pytest.mark.parametrize("engine", ["propagate", "fused-yes", "fused-no", "segment",
                                    "partitioned"])
def test_fp32_tier_never_tighter_than_f64_oracle(engine):
    """The reference's test (tests/test_precision.py:112) on the port, its
    ``segment`` engine case included."""
    for name, pr, pt in _population():
        if engine == "propagate":
            r = rt.propagate(pt, dtype=np.float32, device="cpu")
        elif engine.startswith("fused"):
            r = rt.propagate_block_ell(pt, dtype=np.float32, fused=engine[6:], device="cpu")
        else:
            r = rt.propagate_block_ell(pt, dtype=np.float32, device="cpu", **ENGINES[engine])
        seq = rc.propagate_sequential(pr)
        if bool(r.infeasible):
            assert seq.infeasible, f"{name}/{engine}: false fp32 infeasibility"
            continue
        if seq.infeasible:
            continue
        _assert_never_tighter(f"{name}/{engine}", r.lb, r.ub, np.asarray(seq.lb),
                              np.asarray(seq.ub), np.asarray(pr.is_int, bool), F32_BAND)


@pytest.mark.parametrize("engine", ["propagate", "fused", "segment", "partitioned"])
def test_two_tier_lands_on_f64_fixed_point(engine):
    """The reference's test (tests/test_precision.py:218), plus the
    reference's own two-tier run's flags (its ``propagate``, whose tier
    widens outward as the port's does)."""
    tp = rt.core.TierPolicy()
    for name, pr, pt in _population():
        if engine == "propagate":
            r64 = rt.propagate(pt, device="cpu")
            tiered = rt.propagate(pt, policy=tp, device="cpu")
        else:
            r64 = rt.propagate_block_ell(pt, device="cpu", **ENGINES[engine])
            tiered = rt.propagate_block_ell(pt, policy=tp, device="cpu", **ENGINES[engine])
        if name in AGAINST_REFERENCE:
            _assert_flags(tiered, _ref_propagate(name, "tier"))
        assert tiered.lb.dtype == torch.float64
        assert bool(tiered.infeasible) == bool(r64.infeasible), name
        if bool(r64.infeasible):
            continue
        _assert_same_fixed_point(f"{name}/{engine}", tiered, r64, np.asarray(pr.is_int, bool))
        assert int(tiered.tier_rounds) >= 1


@pytest.mark.parametrize("engine", ["propagate", "fused"])
def test_two_tier_guard_ignores_fp32_infeasible(monkeypatch, engine):
    """The reference's test (tests/test_precision.py:264): an fp32 verdict
    forced to infeasible reruns the endgame from the original bounds."""
    _, _, pt = _case("set_cover")
    if engine == "propagate":
        base, mod, attr = rt.propagate(pt, device="cpu"), tprop, "_propagate_single"
        is_f32 = lambda args: args[3] is not None and tprop.torch_dtype(args[3]) == torch.float32
    else:
        base, mod, attr = rt.propagate_block_ell(pt, device="cpu"), tops, "_propagate_prepared"
        is_f32 = lambda args: args[0].d.val.dtype == torch.float32
    assert not bool(base.infeasible)
    real = getattr(mod, attr)

    def lying_fp32(*args, **kw):
        r = real(*args, **kw)
        return r._replace(infeasible=torch.tensor(True)) if is_f32(args) else r

    monkeypatch.setattr(mod, attr, lying_fp32)
    run = rt.propagate if engine == "propagate" else rt.propagate_block_ell
    tiered = run(pt, policy=rt.core.TierPolicy(), device="cpu")
    assert not bool(tiered.infeasible)
    assert int(tiered.tier_rounds) >= 1
    assert torch.equal(tiered.lb, base.lb) and torch.equal(tiered.ub, base.ub)
    assert int(tiered.rounds) == int(base.rounds)


@pytest.mark.parametrize("engine", ["propagate", "fused"])
def test_early_stop_is_a_trajectory_prefix(engine):
    """The reference's test (tests/test_precision.py:293) on the port, with
    the reference's rounds and flags on the plain round."""
    tp = rt.core.TierPolicy(two_tier=False, stop_progress=0.05, patience=1)
    run = rt.propagate if engine == "propagate" else rt.propagate_block_ell
    saved = 0
    for name, pr, pt in _population():
        full = run(pt, dtype=np.float32, device="cpu")
        if bool(full.infeasible):
            continue
        stop = run(pt, dtype=np.float32, policy=tp, device="cpu")
        if engine == "propagate" and name in AGAINST_REFERENCE:
            want = _ref_propagate(name, "stop")
            _assert_flags(stop, want)
            np.testing.assert_allclose(float(stop.progress), float(want.progress), rtol=1e-5)
        assert int(stop.rounds) <= int(full.rounds), name
        saved += int(full.rounds) - int(stop.rounds)
        lb_s, ub_s = np.maximum(_np(stop.lb), -rc.INF), np.minimum(_np(stop.ub), rc.INF)
        lb_f, ub_f = np.maximum(_np(full.lb), -rc.INF), np.minimum(_np(full.ub), rc.INF)
        assert np.all(lb_s >= np.asarray(pr.lb)) and np.all(ub_s <= np.asarray(pr.ub)), name
        assert np.all(lb_s <= lb_f) and np.all(ub_s >= ub_f), name
        if int(stop.rounds) < int(full.rounds):
            assert not bool(stop.converged), name
            assert float(stop.progress) < 0.05, name
    assert saved > 0


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_drivers_agree_bitwise_with_the_early_stop(dtype):
    """host_loop, device_loop (read groups of 8 and 1) and, on the plain
    round, unrolled: the same rounds, flags, bounds and progress, early
    stop armed (patience 2), on the fused and multi-chunk branches."""
    _, _, pt = _case("mixed1")
    stop = dict(stop_progress=0.05, patience=2)
    for tile_width in (128, 8):
        runs = [rt.propagate_block_ell(pt, tile_width=tile_width, dtype=dtype, driver=d,
                                       device="cpu", **stop)
                for d in ("host_loop", "device_loop")]
        for a in runs[1:]:
            _assert_flags(a, runs[0])
            assert torch.equal(a.lb, runs[0].lb) and torch.equal(a.ub, runs[0].ub)
            assert torch.equal(a.progress, runs[0].progress)
    dp = rt.core.DeviceProblem(pt, dtype=dtype, device="cpu")
    host = rt.core.propagate_host_loop(dp, **stop)
    dev = rt.core.propagate_device_loop(dp, **stop)
    _assert_flags(dev, host)
    assert torch.equal(dev.lb, host.lb) and torch.equal(dev.progress, host.progress)
    unrolled = rt.core.propagate_unrolled(dp, unroll=1, **stop)
    assert torch.equal(unrolled.lb, host.lb) and int(unrolled.rounds) == int(host.rounds)


def test_kernel_early_stop_fold_matches_the_reference_cond():
    """F's plain version with the early stop: FLAT counts rounds below the
    threshold, GO clears at ``patience``, LAST keeps the round's flag and
    PROG its measure (in F's summation order)."""
    rng = np.random.default_rng(2)
    n = 3_000
    lb = torch.zeros(n)
    ub = torch.full((n,), 10.0)
    st = tcarry.armed_state("cpu")
    stop = tcarry.EarlyStop(0.5, 2)
    flats = []
    for tighten in (200, 1, 1):
        bl = torch.full((n,), -rc.INF)
        bu = torch.full((n,), rc.INF)
        pick = torch.from_numpy(rng.choice(n, tighten, replace=False))
        bl[pick] = lb[pick] + 1.0
        new_lb = rt.core.apply_updates(lb, ub, bl, bu, 1e-5, rc.INF, 2.0**-17)[0]
        want = tref.merge_progress(lb, ub, new_lb, ub)
        lb, ub, go = tk.apply_updates_tiles(lb, ub, bl, bu, 1e-5, rc.INF, 2.0**-17, carry=st,
                                           stop=stop)
        fields = st.tolist()
        flats.append(fields[tcarry.FLAT])
        assert fields[tcarry.LAST] == 1
        assert tcarry.progress_of(fields, torch.float32) == float(want)
    assert flats == [0, 1, 2] and not bool(go)
    assert st.tolist()[tcarry.ROUNDS] == 3


# ---------------------------------------------------------------------------
# What stays outside the slice raises, naming the item
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["bfloat16", "float16", "segment", "partitioned",
                                  "past_the_limit", "stop_partitioned"])
def test_block_ell_outside_the_slice_raises(monkeypatch, case):
    """bfloat16 and float16, which the batched entry points refused before
    item 5's remainder (part two) was ported, run there and return the
    reference's rounds and verdicts (the full contract is
    ``test_torch_half_batch.py``'s).  The cases that the engine slice ports
    run and are held to the reference:
    float32 on the segment and partitioned engines and through ``auto``
    past ``SCATTER_MAX_NPAD`` against its round closure on the same engine
    (rounds, converged, bounds bitwise on set cover), and the early stop on
    the partitioned engine against its ``propagate_block_ell`` there (which
    at float64 merges as the port does; progress within 1e-12)."""
    _, pr, pt = _case("set_cover")
    if case in ("bfloat16", "float16"):
        dtype = torch.bfloat16 if case == "bfloat16" else np.float16
        (got,) = rt.propagate_batch([pt], device="cpu", dtype=dtype)
        (want,) = rc.propagate_batch([pr], dtype=getattr(jnp, case), use_pallas=False)
        assert got.lb.dtype == tprop.torch_dtype(dtype)
        assert (int(got.rounds), bool(got.converged), bool(got.infeasible)) == (
            int(want.rounds), bool(want.converged), bool(want.infeasible))
        return
    if case == "stop_partitioned":
        kw = dict(stop_progress=0.05, scatter="partitioned")
        got = rt.propagate_block_ell(pt, device="cpu", **kw)
        want = rk.propagate_block_ell(pr, use_pallas=False, **kw)
        for f in ("rounds", "converged", "infeasible"):
            assert int(getattr(got, f)) == int(getattr(want, f)), f
        np.testing.assert_array_equal(got.lb.numpy(), np.asarray(want.lb))
        np.testing.assert_array_equal(got.ub.numpy(), np.asarray(want.ub))
        np.testing.assert_allclose(float(got.progress), float(want.progress), rtol=1e-12,
                                   atol=1e-12)
        return
    scatter = {"segment": "segment", "partitioned": "partitioned",
               "past_the_limit": "auto"}[case]
    if case == "past_the_limit":
        monkeypatch.setattr(tops, "SCATTER_MAX_NPAD", 64)
        monkeypatch.setattr(rops, "SCATTER_MAX_NPAD", 64)
        prep = rk.prepare_block_ell(pr, dtype=np.float32)
        fn = jax.jit(rk.round_fn_for(prep, use_pallas=False, scatter="auto"))
        lb, ub, rounds, changed = prep.lb0, prep.ub0, 0, True
        while changed and rounds < rc.DEFAULT_CONFIG.max_rounds:
            lb, ub, ch = fn(lb, ub)
            rounds, changed = rounds + 1, bool(ch)
        wl, wu = np.asarray(lb)[: pr.n], np.asarray(ub)[: pr.n]
    else:
        wl, wu, rounds, changed = _ref_block_ell_f32("set_cover", 128, scatter)
    got = rt.propagate_block_ell(pt, device="cpu", dtype=np.float32, scatter=scatter)
    assert got.lb.dtype == torch.float32
    assert int(got.rounds) == rounds and bool(got.converged) == (not changed)
    _assert_close((got.lb, got.ub), (wl, wu), True)


@pytest.mark.parametrize("case", ["batch_policy", "batch_float32", "nodes_policy",
                                  "nodes_float32", "service_stop", "service_float32",
                                  "batch_past_the_limit", "nodes_past_the_limit"])
def test_batched_engines_outside_the_slice_raise(monkeypatch, case):
    """The batched engines' tier options: each case that the batched slice
    ports runs and is held to the reference's result (flags, tier rounds,
    bounds bitwise on set cover, the service's early-stop count); float32
    past ``SCATTER_MAX_NPAD`` (the partitioned batch and node rounds, which
    the engine slice ports) too, against the reference's plain batched and
    node rounds with the limit moved in both packages."""
    _, pr, pt = _case("set_cover")
    lb, ub = np.asarray(pt.lb)[None], np.asarray(pt.ub)[None]
    rlb, rub = np.asarray(pr.lb)[None], np.asarray(pr.ub)[None]
    if case.endswith("past_the_limit"):
        monkeypatch.setattr(tops, "SCATTER_MAX_NPAD", 64)
        monkeypatch.setattr(rops, "SCATTER_MAX_NPAD", 64)
        if case.startswith("batch"):
            got = rt.propagate_batch([pt], dtype=np.float32, device="cpu")[0]
            want = rc.propagate_batch([pr], dtype=np.float32, use_pallas=False)[0]
            _assert_flags(got, want)
        else:
            got = rt.propagate_nodes(pt, lb, ub, dtype=np.float32, device="cpu")
            want = rc.propagate_nodes(pr, rlb, rub, dtype=np.float32, use_pallas=False)
            for f in ("rounds", "converged", "infeasible"):
                np.testing.assert_array_equal(_np(getattr(got, f)), _np(getattr(want, f)))
        assert got.lb.dtype == torch.float32
        np.testing.assert_array_equal(_np(got.lb), np.asarray(want.lb, np.float64))
        np.testing.assert_array_equal(_np(got.ub), np.asarray(want.ub, np.float64))
        return
    kind, opt = case.split("_")
    port_kw = {"policy": dict(policy=rt.core.TierPolicy()), "float32": dict(dtype=np.float32),
               "stop": dict(stop_progress=0.05)}[opt]
    ref_kw = {"policy": dict(policy=rc.TierPolicy()), "float32": dict(dtype=np.float32),
              "stop": dict(stop_progress=0.05)}[opt]
    if kind == "batch":
        got = rt.propagate_batch([pt], device="cpu", **port_kw)[0]
        want = rc.propagate_batch([pr], use_pallas=False, **ref_kw)[0]
        _assert_flags(got, want)
    elif kind == "nodes":
        got = rt.propagate_nodes(pt, lb, ub, device="cpu", **port_kw)
        want = rc.propagate_nodes(pr, rlb, rub, use_pallas=False, **ref_kw)
        for f in ("rounds", "converged", "infeasible", "tier_rounds"):
            np.testing.assert_array_equal(_np(getattr(got, f)), _np(getattr(want, f)))
    else:
        svc = rt.PropagationService.from_problems([pt], slots=1, device="cpu", **port_kw)
        ref = rc.PropagationService.from_problems([pr], slots=1, use_pallas=False, **ref_kw)
        got, want = svc.serve([pt])[0], ref.serve([pr])[0]
        for f in ("rounds", "converged", "infeasible"):
            assert int(getattr(got, f)) == int(getattr(want, f)), f
        assert svc.stats()["early_stopped"] == ref.stats()["early_stopped"]
    np.testing.assert_array_equal(_np(got.lb), np.asarray(want.lb, np.float64))
    np.testing.assert_array_equal(_np(got.ub), np.asarray(want.ub, np.float64))
