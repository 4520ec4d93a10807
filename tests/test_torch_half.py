"""The port's single-instance engines at bfloat16 and float16 (``repro_torch``,
ROADMAP Queue 1 item 5, remainder, part one) against the reference
(``src/repro``) on the CPU.

The contract, from the reference's own behaviour at these types:

* **bfloat16**: bounds bitwise by value (-0.0 equals +0.0); ``rounds``,
  ``converged`` and ``infeasible`` exact.  The engines are held to the
  reference's ``round_fn_for(prep, use_pallas=False)`` driven to its fixed
  point (its ``propagate_block_ell`` builds its round without ``outward``,
  src/repro/kernels/ops.py:1262-1274, so on pb it keeps 0.0 where its round
  closure, its ``propagate`` and the port widen an upper bound of 0 to
  2**-17); the port's ``propagate`` to the reference's ``propagate``.
* **float16**: bitwise on set cover, knapsack, the cascade chain and pb;
  ``rounds`` and verdicts exact everywhere; on mixed and banded the bounds
  within :data:`F16_ULPS` float16 ulps, both infinite counted equal.  XLA
  keeps a float32 value between a float16 multiply and the add it feeds, so
  the reference is not one function at float16: its plain round closure and
  its Pallas kernels (interpret mode) differ at their fixed points on mixed
  (m=600, n=300) in 14 bounds by at most 1 ulp (0 on banded), measured on
  every engine of this file; the port rounds after every operation, as the
  Pallas kernels do, and stays within that spread.  float16 is no tier of
  the reference (``_is_low_precision`` leaves it out): eps 1e-9 and
  feas_eps 1e-8 round to 0.0, ``INF`` to ``inf``, and on banded a fixed
  point changes no bound and stops after one round.

The 16-bit plain versions of the kernels (D, A', the combine, E, F and its
stop form, A, B, C, #11, the straddle combine, #12, #15 and its stop form,
and the record kernel) are held to the reference's oracles
(``repro.kernels.ref``, jitted) at the same type on the same inputs.
Instances come from each package's seeded generators; 16-bit reference
arrays cross to torch through their bits.  The reference's runs are cached
per session.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as rc
import repro.core.bounds as rbnd
import repro.kernels as rk
import repro.kernels.ref as rref
from repro.kernels import ops as rops
from repro.obs import telemetry as robs
import repro_torch as rt
from repro_torch import kernels as tk
from repro_torch.core import carry as tcarry
from repro_torch.core.types import rounded
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from torch_half_common import (CFG, DTYPES, INSTANCES, RCFG, _REF_PROGRESS, _assert_same,
                               _bitwise, _drive, _instance, _j, _t, _ulps)
from torch_half_common import one_thread  # noqa: F401  (the module's autouse fixture)

# float16 overflows INF to inf, on purpose: the reference's casts warn.
pytestmark = pytest.mark.filterwarnings("ignore:overflow encountered in cast:RuntimeWarning")

SLAB = 128
# (scatter, (tile_rows, tile_width)) of each engine.
ENGINES = {
    "fused": ("fused", (8, 128)),
    "multi": ("fused", (8, 8)),
    "segment": ("segment", (8, 128)),
    "partitioned": ("partitioned", (4, 32)),
}


@functools.lru_cache(maxsize=None)
def _ref_prep(name, dtype, engine):
    """The reference's prep of one instance on an engine's tiles."""
    return rk.prepare_block_ell(_instance(name)[0], *ENGINES[engine][1], dtype=DTYPES[dtype][1])


@functools.lru_cache(maxsize=None)
def _ref_round(name, dtype, engine):
    """The reference's plain round closure of one instance on one engine,
    jitted once per session, with its prep."""
    prep = _ref_prep(name, dtype, engine)
    scatter = ENGINES[engine][0]
    return prep, jax.jit(rk.round_fn_for(prep, use_pallas=False, scatter=scatter, slab=SLAB))


@functools.lru_cache(maxsize=None)
def _ref_fixed(name, dtype, engine):
    prep, fn = _ref_round(name, dtype, engine)
    n = _instance(name)[0].n
    lb, ub, rounds, changed, _ = _drive(fn, prep.lb0, prep.ub0)
    return _t(lb)[:n], _t(ub)[:n], rounds, changed


def _check_run(got, want, bitwise):
    wl, wu, rounds, changed = want
    assert int(got.rounds) == rounds and bool(got.converged) == (not changed)
    assert bool(got.infeasible) == bool((wl > wu + rounded(CFG.feas_eps, wl.dtype)).any())
    _assert_same((got.lb, got.ub), (wl, wu), bitwise)


@pytest.fixture
def tiny_budget(monkeypatch):
    """Both packages' engine limit and slab cap shrunk to 128."""
    for mod in (rops, tops):
        mod.clear_prepare_cache()
        monkeypatch.setattr(mod, "SCATTER_MAX_NPAD", 128)
        monkeypatch.setattr(mod, "SLAB_NPAD", 128)
    yield
    for mod in (rops, tops):
        mod.clear_prepare_cache()


# ---------------------------------------------------------------------------
# Fixed points
# ---------------------------------------------------------------------------


# (driver, use_kernels): both drivers, and the wrappers and plain versions.
RUNS = (("host_loop", True), ("device_loop", True), ("device_loop", False))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", list(INSTANCES))
def test_engines_match_round_closure(tiny_budget, name, dtype):
    """Every engine (fused, multi-chunk at ``tile_width=8``, segment,
    partitioned under ``tiny_budget``) on both drivers, on the kernels'
    wrappers (on the CPU their plain versions) and on the plain round
    (``use_kernels=False``), against the reference's fused round closure:
    on these instances its four engines reach one fixed point at both types
    (checked while the port was written; on make_mixed(m=600, n=300,
    density=0.01) at bfloat16 its partitioned engine's differs from its
    fused one, and the port's engines equal its engines one by one)."""
    _, pt = _instance(name)
    tdt = DTYPES[dtype][0]
    want = _ref_fixed(name, dtype, "fused")
    for engine, (scatter, (rows, width)) in ENGINES.items():
        for driver, use_kernels in RUNS:
            got = rt.propagate_block_ell(pt, tile_rows=rows, tile_width=width, dtype=tdt,
                                         scatter=scatter, driver=driver,
                                         use_kernels=use_kernels, device="cpu")
            assert got.lb.dtype == tdt
            _check_run(got, want, _bitwise(name, dtype))
    if name == "pb" and dtype == "bf16":
        # The widening merge: upper bounds of 0 go to 2**-17 (the reference's
        # round closure and propagate; its propagate_block_ell keeps 0.0).
        assert bool((got.ub == 2.0**-17).any())


@functools.lru_cache(maxsize=None)
def _ref_propagate(name, dtype):
    return rc.propagate(_instance(name)[0], dtype=DTYPES[dtype][1])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", ["pb", "banded", "mixed"])
def test_propagate_matches_reference(name, dtype):
    """The plain ``propagate`` (row sums by ``index_add_``, which rounds
    after every add in nonzero order on the CPU, as ``segment_sum`` does)
    on both drivers against the reference's ``propagate``."""
    _, pt = _instance(name)
    tdt = DTYPES[dtype][0]
    w = _ref_propagate(name, dtype)
    for driver in ("host_loop", "device_loop"):
        g = rt.propagate(pt, dtype=tdt, driver=driver, device="cpu")
        assert int(g.rounds) == int(w.rounds) and bool(g.converged) == bool(w.converged)
        assert bool(g.infeasible) == bool(w.infeasible)
        _assert_same((g.lb, g.ub), (w.lb, w.ub), _bitwise(name, dtype))


def test_float16_scalars_and_banded():
    """float16 is no tier: its scalars round to 0.0 (eps, feas_eps) and
    ``inf`` (the sentinel), and on banded the fixed point changes no bound,
    stops after one round and makes no NaN, as the reference's does."""
    f16 = torch.float16
    eps, int_eps, inf, outward = rt.core.propagator.round_scalars(CFG, f16)
    assert (eps, inf, outward) == (0.0, float("inf"), 0.0)
    assert int_eps == float(np.float16(1e-6)) and rounded(CFG.feas_eps, f16) == 0.0
    _, pt = _instance("banded")
    want = _ref_propagate("banded", "f16")
    for got in (rt.propagate(pt, dtype=f16, device="cpu"),
                rt.propagate_block_ell(pt, dtype=f16, device="cpu")):
        assert int(got.rounds) == 1 == int(want.rounds)
        assert not torch.isnan(got.lb).any() and not torch.isnan(got.ub).any()
        start = rt.core.types.as_values(pt.lb, f16), rt.core.types.as_values(pt.ub, f16)
        _assert_same((got.lb, got.ub), start)
        assert int(torch.isinf(got.lb).sum() + torch.isinf(got.ub).sum()) == int(
            np.isinf(np.asarray(want.lb, np.float64)).sum()
            + np.isinf(np.asarray(want.ub, np.float64)).sum())


def test_legacy_round_matches_reference():
    """The seed round (``legacy_round_fn_for``, bounds in the unpadded
    ``(n,)`` domain, its structure work redone every round; the reference's
    segment dataflow) at both types, on the kernels' wrappers and plain
    versions, against the reference's round closure on mixed (whose engines
    reach one fixed point, the segment engine's included)."""
    _, pt = _instance("mixed")
    for dtype, (tdt, _) in DTYPES.items():
        want = _ref_fixed("mixed", dtype, "fused")
        tprep = rt.prepare_block_ell(pt, 8, 8, dtype=tdt, device="cpu")
        for use_kernels in (True, False):
            fn = tops.legacy_round_fn_for(tprep, use_kernels=use_kernels)
            lb, ub = tprep.d.lb0.clone(), tprep.d.ub0.clone()
            rounds, changed = 0, True
            while changed and rounds < CFG.max_rounds:
                lb, ub, ch = fn(lb, ub)
                rounds, changed = rounds + 1, bool(ch)
            assert rounds == want[2] and changed == want[3]
            _assert_same((lb, ub), want[:2], dtype == "bf16")


def _drive_tiered(name, policy):
    """The float16 endgame of the two-tier scheme, as ``run_tiers`` runs it,
    on the reference's round closure: from the port's float32 tier (its own
    fixed point, early-stopped at ``switch_progress``; at float32 the
    packages agree to ``bounds_equal`` only, and a float16 endgame, whose
    eps is 0, takes any difference as progress), promoted exactly."""
    pr, pt = _instance(name)
    cap32 = max(1, int(CFG.max_rounds * policy.fp32_round_frac))
    r32 = rt.propagate_block_ell(pt, rt.core.types.dataclasses.replace(CFG, max_rounds=cap32),
                                 dtype=torch.float32, stop_progress=policy.switch_progress,
                                 patience=policy.patience, device="cpu")
    prep, fn = _ref_round(name, "f16", "fused")
    pad = lambda x: jnp.concatenate([x, jnp.zeros((prep.n_pad - pr.n,), x.dtype)])
    lb, ub = (pad(jnp.asarray(x.numpy()).astype(jnp.float16)) for x in (r32.lb, r32.ub))
    lb, ub = rbnd.canonical_infinite(lb, ub)
    tier = int(r32.rounds)
    lb, ub, rounds, changed, _ = _drive(fn, lb, ub, max(1, CFG.max_rounds - tier))
    return _t(lb)[: pr.n], _t(ub)[: pr.n], rounds + tier, changed, tier


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_run_tiers_with_sixteen_bit_final(dtype):
    """``TierPolicy`` with a 16-bit final type: at bfloat16 one tier (no
    float32 tier runs; on mixed), at float16 a float32 tier, an exact
    promotion and a float16 endgame (on the cascade chain: 26 tier rounds,
    then the endgame).  The plain ``propagate`` against the reference's;
    the block-ELL engine's endgame against the reference's round closure
    from the port's float32 tier.  Where float16 sums are inexact the
    reference is not one function from a warm start either: from the port's
    float32 tier on mixed its plain round closure takes 5 endgame rounds,
    its Pallas kernels (interpret mode) and the port 3; and its plain
    ``propagate`` tiered on banded takes an endgame round more than the
    port's (11 to 10)."""
    name = "mixed" if dtype == "bf16" else "cascade"
    pr, pt = _instance(name)
    tdt, jdt = DTYPES[dtype]
    policy = rt.core.TierPolicy()
    want = rc.propagate(pr, dtype=jdt, policy=rc.TierPolicy())
    got = rt.propagate(pt, dtype=tdt, policy=policy, device="cpu")
    for f in ("rounds", "tier_rounds", "converged", "infeasible"):
        assert int(getattr(got, f)) == int(getattr(want, f)), f
    _assert_same((got.lb, got.ub), (want.lb, want.ub), dtype == "bf16")
    got = rt.propagate_block_ell(pt, dtype=tdt, policy=policy, device="cpu")
    if dtype == "bf16":
        assert int(got.tier_rounds) == 0
        _check_run(got, _ref_fixed(name, dtype, "fused"), True)
    else:
        wl, wu, rounds, changed, r32 = _drive_tiered(name, policy)
        assert int(got.tier_rounds) == r32 > 0
        _check_run(got, (wl, wu, rounds, changed), True)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_early_stop_and_telemetry(dtype):
    """The early stop (F folds each round's measure into the loop carry)
    against the reference's round closure with the stop folded as its
    while loop folds it, on both drivers, where it cuts the fixed point
    (mixed at bfloat16; pb at float16, whose bounds are finite: an
    infinite float16 bound makes the measure NaN, in the reference too,
    and NaN never stops); telemetry on returns every field as it is off,
    its progress history the reference's per-round measure (summed in
    another order: within one ulp of the type)."""
    name, stop = ("mixed", 1.0) if dtype == "bf16" else ("pb", 2.0)
    pr, pt = _instance(name)
    tdt = DTYPES[dtype][0]
    prep, fn = _ref_round(name, dtype, "fused")
    wl, wu, rounds, changed, hist = _drive(fn, prep.lb0, prep.ub0, stop=stop)
    _, _, full, _, _ = _drive(fn, prep.lb0, prep.ub0)
    assert rounds < full  # the stop cuts the fixed point
    want = (_t(wl)[: pr.n], _t(wu)[: pr.n], rounds, changed)
    hist = torch.stack([_t(h) for h in hist])
    for driver in ("host_loop", "device_loop"):
        kw = dict(dtype=tdt, driver=driver, device="cpu", stop_progress=stop)
        got = rt.propagate_block_ell(pt, **kw)
        _check_run(got, want, True)
        assert int(_ulps(got.progress.reshape(1), hist[-1:]).max()) <= 1
        tel = rt.propagate_block_ell(pt, telemetry=16, **kw)
        for f in ("lb", "ub", "rounds", "converged", "infeasible", "progress"):
            assert torch.equal(getattr(tel, f), getattr(got, f)), f
        snap = tel.telemetry
        assert snap.rounds_recorded == rounds and snap.stop_round == rounds
        got_hist = torch.tensor(snap.progress_history()).to(tdt)
        assert int(_ulps(got_hist, hist).max()) <= 1


def test_compact_ids_at_bfloat16_only(monkeypatch):
    """A bfloat16 prep whose ``n_pad`` fits int16 holds int16 columns and
    int8 marks, as the reference's (``_is_low_precision``); float16 never
    does, and neither type past the limit."""
    _, pt = _instance("mixed")
    tops.clear_prepare_cache()
    bf = rt.prepare_block_ell(pt, dtype=torch.bfloat16, device="cpu")
    assert bf.d.col.dtype == torch.int16 and bf.ii_g.dtype == torch.int8
    hf = rt.prepare_block_ell(pt, dtype=torch.float16, device="cpu")
    assert hf.d.col.dtype == torch.int32 and hf.ii_g.dtype == torch.int32
    monkeypatch.setattr(tops, "_COMPACT_COL_MAX_NPAD", 64)
    tops.clear_prepare_cache()
    wide = rt.prepare_block_ell(pt, dtype=torch.bfloat16, device="cpu")
    assert wide.d.col.dtype == torch.int32 and wide.ii_g.dtype == torch.int32
    tops.clear_prepare_cache()


def test_other_entry_points_raise_part_two():
    """The batched, node, service and sharded entry points, which refused
    both 16-bit types before their part of the port, run at both and
    return the reference's round count on set cover (one round on every
    entry point of the reference, sharded ones included; the port's sharded
    engines on a world of one gloo rank in this process)."""
    import torch.distributed as dist

    pr, pt = _instance("set_cover")
    lbs, ubs = np.stack([pt.lb, pt.lb]), np.stack([pt.ub, pt.ub])
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        for tdt, jdt in DTYPES.values():
            want = int(rc.propagate_batch([pr], dtype=jdt, use_pallas=False)[0].rounds)
            calls = [
                lambda: rt.propagate_batch([pt, pt], dtype=tdt, device="cpu")[1],
                lambda: rt.propagate_nodes(pt, lbs, ubs, dtype=tdt, device="cpu"),
                lambda: rt.PropagationService.from_problems([pt], slots=1, dtype=tdt,
                                                            device="cpu").serve([pt])[0],
                lambda: rt.core.propagate_sharded(pt, dtype=tdt, device="cpu"),
                lambda: rt.core.propagate_sharded_rows(pt, dtype=tdt, device="cpu"),
                lambda: rt.core.propagate_batch_sharded([pt], dtype=tdt, device="cpu")[0],
            ]
            for call in calls:
                got = call()
                assert got.lb.dtype == tdt
                assert bool((torch.as_tensor(got.rounds) == want).all())
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The kernels' 16-bit plain versions against the reference's oracles
# ---------------------------------------------------------------------------

_REF_D = jax.jit(rref.fused_scatter_round_tiles_ref, static_argnums=(7, 8))
_REF_AG = jax.jit(rref.activities_gather_tiles_ref, static_argnums=(4,))
_REF_E = jax.jit(rref.candidates_scatter_tiles_ref, static_argnums=(11, 12))
_REF_A = jax.jit(rref.activities_tiles_ref)
_REF_B = jax.jit(rref.candidates_tiles_ref, static_argnums=(10,))
_REF_C = jax.jit(rref.fused_round_tiles_ref, static_argnums=(6,))
_REF_MERGE = jax.jit(rbnd.apply_updates, static_argnums=(4, 5, 6))
_REF_RECORD = jax.jit(lambda plane, prog, lb, ub: robs.record_round(
    plane, prog, 1, jnp.any(lb > ub + RCFG.feas_eps)))
_REF_SEGMENT_SUM = jax.jit(lambda x, seg, n: jax.ops.segment_sum(x, seg, num_segments=n),
                           static_argnums=(2,))
_REF_COMBINE = jax.jit(
    lambda x, crow, m: jax.ops.segment_sum(x.reshape(-1), crow.reshape(-1), num_segments=m)[crow],
    static_argnums=(2,))


@functools.lru_cache(maxsize=None)
def _one_round_on(name, dtype, engine):
    """The port's and the reference's preps of an instance on an engine's
    tiles, and bounds one round past the root (the reference's fused round
    closure), so candidates meet finite and infinite bounds."""
    rows, width = ENGINES[engine][1]
    tp = rt.prepare_block_ell(_instance(name)[1], rows, width, dtype=DTYPES[dtype][0],
                              device="cpu")
    prep, fn = _ref_round(name, dtype, "fused")
    lb, ub, _ = fn(prep.lb0, prep.ub0)
    return _ref_prep(name, dtype, engine), tp, lb, ub


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_fused_round_kernels_match_oracles(dtype):
    """D (rows in one chunk), then A', the combine and E (``tile_width=8``),
    into the kept float32 planes, then F's merge, its stop form and the
    record kernel, on mixed (and bfloat16's compact ids), against the
    reference's oracles and ``apply_updates`` at the same type."""
    tdt, _ = DTYPES[dtype]
    eps, int_eps, inf, outward = rt.core.propagator.round_scalars(CFG, tdt)
    bitwise = dtype == "bf16"
    for engine in ("fused", "multi"):
        rp, tp, lb, ub = _one_round_on("mixed", dtype, engine)
        assert tp.d.col.dtype == (torch.int16 if dtype == "bf16" else torch.int32)
        tlb, tub = _t(lb), _t(ub)
        acc = tk.accumulator_planes(tlb, CFG.inf)
        assert acc[0].dtype == torch.float32 and float(acc[0][0]) == -inf
        if tp.fits_one_chunk:
            best = tk.fused_scatter_round_tiles(tp.d.val, tp.d.col, tp.ii_g, tp.lhs_g, tp.rhs_g,
                                                tlb, tub, tp.n_pad, CFG.int_eps, CFG.inf,
                                                acc=acc)
            want = _REF_D(rp.d.val, rp.d.col, rp.ii_g, rp.lhs_g, rp.rhs_g, lb, ub, rp.n_pad,
                          CFG.int_eps)
        else:
            parts = tk.activities_gather_tiles(tp.d.val, tp.d.col, tlb, tub, tp.n_pad, CFG.inf)
            wparts = _REF_AG(rp.d.val, rp.d.col, lb, ub, rp.n_pad)
            _assert_same(parts, wparts, bitwise)
            aggs = tk.combine_chunk_partials_tiles(*parts, tp.d.chunk_row, tp.row_start)
            waggs = tuple(_REF_COMBINE(x, rp.d.chunk_row, rp.m + 1) for x in wparts)
            _assert_same(aggs, waggs, bitwise)
            best = tk.candidates_scatter_tiles(tp.d.val, tp.d.col, tp.ii_g, *aggs, tp.lhs_g,
                                               tp.rhs_g, tlb, tub, tp.n_pad, CFG.int_eps,
                                               CFG.inf, acc=acc)
            want = _REF_E(rp.d.val, rp.d.col, rp.ii_g, *map(_j, aggs), rp.lhs_g, rp.rhs_g, lb,
                          ub, rp.n_pad, CFG.int_eps)
        assert best[0] is acc[0] and best[0].dtype == torch.float32
        _assert_same([b.to(tdt) for b in best], want, bitwise)
        planes = [b.clone() for b in best]
        jdt = DTYPES[dtype][1]
        wl, wu, wch = _REF_MERGE(lb, ub, *want, RCFG.eps_for(jdt), RCFG.inf,
                                 RCFG.outward_for(jdt))
        gl, gu, gch = tk.apply_updates_tiles(tlb.clone(), tub.clone(), *acc, CFG.eps_for(tdt),
                                             CFG.inf, CFG.outward_for(tdt))
        _assert_same((gl, gu), (wl, wu), bitwise)
        assert bool(gch) == bool(wch)
        assert bool((acc[0] == -inf).all()) and bool((acc[1] == inf).all())  # handed back
        # F's stop form: the measure summed in float32 and rounded once.
        carry = tcarry.armed_state("cpu")
        sl, su, _ = tk.apply_updates_tiles(tlb.clone(), tub.clone(), *planes, eps, inf, outward,
                                           carry=carry, stop=tcarry.EarlyStop(0.05, 1))
        _assert_same((sl, su), (gl, gu))
        prog = tcarry.progress_view(carry, tdt)
        want_prog = _t(_REF_PROGRESS(lb, ub, wl, wu)).reshape(1)
        assert bool(torch.isnan(want_prog).all()) == bool(torch.isnan(prog).all())
        assert bool(torch.isnan(prog).all()) or int(_ulps(prog, want_prog).max()) <= 1
        assert carry[tcarry.ROUNDS] == 1
        # The record kernel: the carry's measure to the ring, the probe.
        plane = rt.obs.device_plane(4, dtype=tdt, device="cpu")
        tk.record_round_tiles(sl, su, carry, plane, CFG.feas_eps)
        wplane = _REF_RECORD(robs.device_plane(4, dtype=DTYPES[dtype][1]), _j(prog)[0], wl, wu)
        _assert_same((plane.ring[:1],), (wplane.ring[:1],), nan=True)  # NaN: inf bounds
        assert int(plane.ticks) == int(wplane.ticks) == 1
        assert int(plane.infeas_round) == int(wplane.infeas_round)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_segment_kernels_match_oracles(dtype):
    """The segment round's A, the combine and B (``tile_width=8``), and C
    (rows in one chunk), over bounds gathered at each slot, on mixed (the
    compact int8 marks at bfloat16), against the reference's oracles."""
    bitwise = dtype == "bf16"
    for engine in ("fused", "multi"):
        rp, tp, lb, ub = _one_round_on("mixed", dtype, engine)
        glb, gub = tops.gather_bounds(_t(lb), _t(ub), tp.gather_columns())
        rlb, rub = lb[rp.d.col], ub[rp.d.col]
        if tp.fits_one_chunk:
            got = tk.fused_round_tiles(tp.d.val, glb, gub, tp.ii_g, tp.lhs_g, tp.rhs_g,
                                       CFG.int_eps)
            want = _REF_C(rp.d.val, rlb, rub, rp.ii_g, rp.lhs_g, rp.rhs_g, CFG.int_eps)
        else:
            parts = tk.activities_tiles(tp.d.val, glb, gub)
            wparts = _REF_A(rp.d.val, rlb, rub)
            _assert_same(parts, wparts, bitwise)
            aggs = tk.combine_chunk_partials_tiles(*parts, tp.d.chunk_row, tp.row_start)
            got = tk.candidates_tiles(tp.d.val, glb, gub, tp.ii_g, *aggs, tp.lhs_g, tp.rhs_g,
                                      CFG.int_eps)
            want = _REF_B(rp.d.val, rlb, rub, rp.ii_g, *map(_j, aggs), rp.lhs_g, rp.rhs_g,
                          CFG.int_eps)
        assert got[0].dtype == DTYPES[dtype][0]
        _assert_same(got, want, bitwise)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_slab_kernels_match_oracles(dtype):
    """One partitioned round on mixed (rows straddling its three 128-column
    slabs), over ``(1, n_pad)`` planes as the engine runs it: #11's copy
    partials against the reference's ``activities_tiles_ref`` on the same
    window gathers, the straddle combine against its segment sum, #12 with
    #15's merge against the reference's partitioned round closure
    (``partitioned_round_ref``, then ``apply_updates``), and #15's stop
    form against the same merge and ``progress_measure``."""
    tdt, jdt = DTYPES[dtype]
    bitwise = dtype == "bf16"
    rp, tp, lb, ub = _one_round_on("mixed", dtype, "partitioned")
    want_p = rp.slab_partition(SLAB)
    part = tp.slab_partition(SLAB)
    assert part.has_straddle and part.val.dtype == tdt
    wl, wu, _ = _ref_round("mixed", dtype, "partitioned")[1](lb, ub)
    width = tp.n_pad
    lb, ub = lb[None], ub[None]
    act = torch.ones(1, dtype=torch.bool)
    got_p = tk.batched_slab_partials_tiles(part.a_val, part.a_col_s, part.a_run_start,
                                           part.a_run_len, part.a_run_inst, part.a_run_slab, act,
                                           _t(lb), _t(ub), SLAB, part.a_max_run_len)
    _, off = tref._copy_windows(part.a_run_start, part.a_run_inst, part.a_run_slab,
                                part.a_val.shape[0], width, SLAB)
    cols = jnp.asarray((part.a_col_s.long() + off[:, None, None]).numpy())
    want_pa = _REF_A(_j(part.a_val), lb.reshape(-1)[cols], ub.reshape(-1)[cols])
    _assert_same(got_p, want_pa, bitwise)
    strs = tk.straddle_combine_tiles(*got_p, part.a_order, part.a_seg, part.agg_slot)
    slot = want_p.a_slot.reshape(-1)
    done = torch.from_numpy(part.row_done.numpy() == 0)
    for g, w in zip(strs, got_p):
        table = _REF_SEGMENT_SUM(_j(w).reshape(-1), slot, want_p.n_straddle + 1)
        _assert_same((g[done],), (_t(table)[torch.from_numpy(np.array(want_p.agg_slot))][done],))
    eps, outward = RCFG.eps_for(jdt), RCFG.outward_for(jdt)
    r_args = (part.val, part.col_s, part.ii_g, part.row_done, *strs, part.lhs_g, part.rhs_g,
              part.run_start, part.run_len, part.run_inst, part.run_slab, act)
    tlb, tub = _t(lb), _t(ub)
    acc = tk.accumulator_planes(tlb, CFG.inf)
    got = tk.batched_slab_round_tiles(*r_args, tlb, tub, SLAB, part.max_run_len, eps,
                                      CFG.int_eps, CFG.inf, outward, acc=acc,
                                      tiles=(part.tile_inst, part.tile_slab),
                                      chunk_len=part.chunk_len)
    _assert_same((got[0][0], got[1][0]), (wl, wu), bitwise)
    inf = rounded(CFG.inf, tdt)
    assert bool((acc[0] == -inf).all()) and bool((acc[1] == inf).all())
    # #15's stop form over the plain scatter's candidates, in float32 planes.
    best = tref.batched_slab_scatter_ref(
        part.val, part.col_s, part.ii_g, part.row_done, *strs, part.lhs_g, part.rhs_g,
        part.run_start, part.run_inst, part.run_slab, act, _t(lb), _t(ub), SLAB,
        rounded(CFG.int_eps, tdt), inf)
    carry = tcarry.armed_state("cpu")
    sl, su, _ = tk.apply_updates_slab_tiles(
        _t(lb), _t(ub), *(b[:, :width].float().contiguous() for b in best),
        tcarry.go_mask(carry), SLAB, eps, CFG.inf, outward, carry=carry,
        stop=tcarry.EarlyStop(0.05, 1))
    _assert_same((sl[0], su[0]), (wl, wu), bitwise)
    prog = tcarry.progress_view(carry, tdt)
    want_prog = _t(_REF_PROGRESS(lb[0], ub[0], wl, wu)).reshape(1)
    assert bool(torch.isnan(want_prog).all()) == bool(torch.isnan(prog).all())
    assert bool(torch.isnan(prog).all()) or int(_ulps(prog, want_prog).max()) <= 1
