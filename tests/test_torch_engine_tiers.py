"""The port's precision tiers on the segment and partitioned engines
(``repro_torch``: float32, ``TierPolicy`` and the progress-based early stop
on ``scatter="segment"`` and ``"partitioned"``, ``auto`` past
``SCATTER_MAX_NPAD``, the legacy round, and the batched and node rounds
past the limit) against the reference's (``src/repro/kernels/ops.py``,
``core/propagator.py``, ``core/nodes.py``), on the CPU at small sizes.

The plain versions of the new float32 forms -- A, B and C (int32 and the
compact int8 marks), #11-#15 and the straddle combine -- are held to the
reference's oracles and its Pallas kernels in interpret mode on the same
float32 preps and partitions; #15's two early-stop forms to the reference's
merge and progress measure.  Fixed points: ``rounds``, ``converged``,
``infeasible`` and ``tier_rounds`` equal; bounds bitwise on the exact
families (set cover, knapsack, the cascade chain), ``bounds_equal``
elsewhere; the progress measure within ``_progress_rtol`` (the port sums it
in the merge kernel's order, the reference in XLA's).

The reference's ``propagate_block_ell`` builds its round without
``outward`` (src/repro/kernels/ops.py:1265-1276), so single-instance float32
runs are held against its ``round_fn_for(..., use_pallas=False)`` driven in
a loop here (the early stop folded on the host as its while loop folds it),
and two-tier runs against ``rc.propagate``; batches and nodes against
``rc.propagate_batch`` / ``rc.propagate_nodes`` with ``use_pallas=False``.
Past the limit both packages run with ``SCATTER_MAX_NPAD`` and ``SLAB_NPAD``
shrunk to 128 (``tiny_budget``).
"""
import functools

import jax
import numpy as np
import pytest
import torch

import repro.core as rc
import repro.core.bounds as rbnd
import repro.data as rd
import repro.kernels as rk
import repro.kernels.ref as rref
from repro.kernels import ops as rops
from repro.kernels import prop_round as rkern
import repro_torch as rt
from repro_torch import kernels as tk
from repro_torch.core import carry as tcarry
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

from test_torch_batch_tiers import MODES, _assert_progress, _mode_dtype, _port_kw

F32 = np.float32
CFG = rt.core.DEFAULT_CONFIG
STOP = 0.05

# name: (generator, kwargs, exact: every sum of the fixed point exact, so
# the two packages agree bitwise).  The first group is small (one slab at
# the default width); the wide ones (n_pad 384) split into three 128-column
# slabs, rows straddling them.
INSTANCES = {
    "set_cover": ("make_set_cover", dict(n=60, m=20, seed=0), True),
    "cascade": ("make_cascade_chain", dict(length=16), True),
    "mixed": ("make_mixed", dict(m=80, n=60, seed=0), False),
    "pb": ("make_pseudo_boolean", dict(n=60, m=40, seed=0), False),
    "knapsack_wide": ("make_knapsack", dict(n=280, m=8, seed=5), True),
    "set_cover_wide": ("make_set_cover", dict(n=270, m=25, seed=6), True),
    "mixed_wide": ("make_mixed", dict(m=35, n=300, seed=0), False),
    # Instances on which the early stop at 0.05 cuts the fixed point: four
    # of six rounds, and seven of eight.
    "mixed1": ("make_mixed", dict(m=80, n=60, seed=3), False),
    "mixed_wide2": ("make_mixed", dict(m=80, n=300, seed=2), False),
}
SLAB = 128


@functools.lru_cache(maxsize=None)
def _instance(name):
    gen, kw, _ = INSTANCES[name]
    pr = getattr(rd, gen)(**kw)
    return pr, rt.problem_from_reference(pr)


def _exact(name):
    return INSTANCES[name][2]


def _np(x):
    return x.detach().cpu().double().numpy() if isinstance(x, torch.Tensor) else (
        np.asarray(x, np.float64))


def _t(x):
    return torch.from_numpy(np.array(x))


def _j(x):
    return jax.numpy.asarray(np.asarray(x))


def _assert_close(got, want, exact, rtol=None):
    """Bitwise on exact data; else ``bounds_equal`` (bound pairs) or
    ``rtol`` (sums)."""
    for g, w in zip(got, want):
        g, w = _np(g), _np(w)
        if exact:
            np.testing.assert_array_equal(g, w)
        elif rtol is not None:
            np.testing.assert_allclose(g, w, rtol=rtol, atol=rtol)
        else:
            assert rt.bounds_equal(g, g, w, w)


def _assert_flags(got, want, fields=("rounds", "converged", "infeasible", "tier_rounds")):
    for f in fields:
        np.testing.assert_array_equal(_np(getattr(got, f)), _np(getattr(want, f)), err_msg=f)


# Float32 sums of the partials in two summation orders (the plain versions'
# and XLA's): a few units of the float32 epsilon, relative.
F32_SUM_RTOL = 16 * float(np.finfo(np.float32).eps)


@pytest.fixture
def tiny_budget(monkeypatch):
    """Shrink the engine limit and the slab cap to 128 in both packages, so
    small instances cross the limit (caches cleared around the test)."""
    for mod in (rops, tops):
        mod.clear_prepare_cache()
        mod.clear_batch_caches()
        monkeypatch.setattr(mod, "SCATTER_MAX_NPAD", 128)
        monkeypatch.setattr(mod, "SLAB_NPAD", 128)
    yield
    for mod in (rops, tops):
        mod.clear_prepare_cache()
        mod.clear_batch_caches()


# ---------------------------------------------------------------------------
# The plain versions of the float32 forms against the reference's oracles
# ---------------------------------------------------------------------------

_REF_A = jax.jit(rref.activities_tiles_ref)
_REF_B = jax.jit(rref.candidates_tiles_ref, static_argnums=(10,))
_REF_C = jax.jit(rref.fused_round_tiles_ref, static_argnums=(6,))
_REF_MERGE = jax.jit(rbnd.apply_updates, static_argnums=(4, 5, 6))
_REF_COMBINE = jax.jit(
    lambda x, crow, m: jax.ops.segment_sum(x.reshape(-1), crow.reshape(-1), num_segments=m)[crow],
    static_argnums=(2,))


@pytest.mark.parametrize("marks", ["int8", "int32"])
@pytest.mark.parametrize("name,tile_width", [("set_cover", 128), ("mixed", 8), ("pb", 128),
                                             ("knapsack_wide", 8)])
def test_float32_segment_kernels_match_reference(name, tile_width, marks):
    """C (rows in one chunk) or A, the combine and B over bounds gathered
    at each slot, at float32 on the compact prep (int8 marks, or the same
    marks widened to int32), then F's merge with the tier's widening, at
    the root bounds and one round on."""
    pr, pt = _instance(name)
    exact = _exact(name)
    rp = rk.prepare_block_ell(pr, tile_width=tile_width, dtype=F32)
    tp = rt.prepare_block_ell(pt, tile_width=tile_width, dtype=torch.float32, device="cpu")
    assert tp.d.col.dtype == torch.int16 and tp.ii_g.dtype == torch.int8
    ii = tp.ii_g if marks == "int8" else tp.ii_g.to(torch.int32)
    eps, outward = CFG.eps_for(torch.float32), CFG.outward_for(torch.float32)
    lb_r, ub_r, lb_t, ub_t = rp.lb0, rp.ub0, tp.lb0.clone(), tp.ub0.clone()
    for _ in range(2):
        glb, gub = tops.gather_bounds(lb_t, ub_t, tp.gather_columns())
        rlb, rub = lb_r[rp.d.col], ub_r[rp.d.col]
        if tp.fits_one_chunk:
            got = tk.fused_round_tiles(tp.d.val, glb, gub, ii, tp.lhs_g, tp.rhs_g, CFG.int_eps)
            want = _REF_C(rp.d.val, rlb, rub, rp.ii_g, rp.lhs_g, rp.rhs_g, CFG.int_eps)
        else:
            gp = tk.activities_tiles(tp.d.val, glb, gub)
            wp = _REF_A(rp.d.val, rlb, rub)
            _assert_close(gp, wp, exact, F32_SUM_RTOL)
            ga = tk.combine_chunk_partials_tiles(*gp, tp.d.chunk_row, tp.row_start)
            wa = tuple(_REF_COMBINE(x, rp.d.chunk_row, rp.m + 1) for x in wp)
            got = tk.candidates_tiles(tp.d.val, glb, gub, ii, *ga, tp.lhs_g, tp.rhs_g,
                                      CFG.int_eps)
            want = _REF_B(rp.d.val, rlb, rub, rp.ii_g, *wa, rp.lhs_g, rp.rhs_g, CFG.int_eps)
        assert got[0].dtype == torch.float32
        _assert_close(got, want, exact)
        best_t = tops.segment_reduce(*got, tp.segment_index(), tp.n_pad, CFG.inf)
        best_r = (jax.ops.segment_max(want[0].reshape(-1), rp.d.col.reshape(-1),
                                      num_segments=rp.n_pad),
                  jax.ops.segment_min(want[1].reshape(-1), rp.d.col.reshape(-1),
                                      num_segments=rp.n_pad))
        wl, wu, wch = _REF_MERGE(lb_r, ub_r, *best_r, eps, CFG.inf, outward)
        gl, gu, gch = tk.apply_updates_tiles(lb_t, ub_t, *best_t, eps, CFG.inf, outward)
        _assert_close((gl, gu), (wl, wu), exact)
        assert bool(gch) == bool(wch)
        lb_r, ub_r, lb_t, ub_t = wl, wu, gl, gu


def _partitions(name, tile):
    """(reference partition, port partition) of an instance at float32."""
    pr, pt = _instance(name)
    want = rops.prepare_block_ell(pr, *tile, dtype=F32).slab_partition(SLAB)
    got = rt.prepare_block_ell(pt, *tile, dtype=torch.float32, device="cpu").slab_partition(SLAB)
    return want, got


def _planes(rng, bsz, width, integer):
    if integer:
        lb = rng.integers(-5, 1, size=(bsz, width))
        ub = rng.integers(0, 6, size=(bsz, width))
    else:
        lb, ub = rng.uniform(-5, 0, size=(bsz, width)), rng.uniform(0, 5, size=(bsz, width))
    lb = lb.astype(F32)
    ub = ub.astype(F32)
    lb[rng.random((bsz, width)) < 0.1] = -CFG.inf
    ub[rng.random((bsz, width)) < 0.1] = CFG.inf
    return lb, ub


SLAB_CASES = {"knapsack": ("knapsack_wide", (2, 8)), "mixed": ("mixed_wide", (4, 32))}


@pytest.mark.parametrize("case", list(SLAB_CASES))
def test_float32_slab_kernels_match_pallas(case):
    """#11, the straddle combine, #12 (with #15's merge) and #15 alone at
    float32 on one instance's partition, against the reference's Pallas
    kernels (interpret mode) and its straddle segment sum; then #13 and #14
    over three node planes, one inactive."""
    name, tile = SLAB_CASES[case]
    exact = _exact(name)
    rng = np.random.default_rng(3)
    want_p, part = _partitions(name, tile)
    assert part.val.dtype == torch.float32 and part.col_s.dtype == torch.int32
    width = part.n_pad_part
    eps, outward = CFG.eps_for(torch.float32), CFG.outward_for(torch.float32)
    lb, ub = _planes(rng, 1, width, exact)
    act = np.ones(1, bool)
    a_args = (part.a_val, part.a_col_s, part.a_run_start, part.a_run_len, part.a_run_inst,
              part.a_run_slab, _t(act), _t(lb), _t(ub), SLAB, part.a_max_run_len)
    got_p = tk.batched_slab_partials_tiles(*a_args)
    want_pa = rkern.batched_slab_partials_tiles(
        want_p.a_val, want_p.a_col_s, want_p.a_run_start, want_p.a_run_len, want_p.a_run_inst,
        want_p.a_run_slab, _j(act), _j(lb), _j(ub), SLAB, want_p.a_max_run_len, CFG.inf,
        interpret=True)
    assert got_p[0].dtype == torch.float32
    _assert_close(got_p, want_pa, exact, F32_SUM_RTOL)
    # The straddle combine: each slot's partials summed from +0.0 in
    # sub-stream order, against the reference's segment sum over a_slot.
    strs = tk.straddle_combine_tiles(*got_p, part.a_order, part.a_seg, part.agg_slot)
    slot = want_p.a_slot.reshape(-1)
    nseg = want_p.n_straddle + 1
    done = part.row_done.numpy() == 0
    for g, w in zip(strs, want_pa):
        table = jax.ops.segment_sum(w.reshape(-1), slot, num_segments=nseg)
        _assert_close((g.numpy()[done],), (np.asarray(table)[want_p.agg_slot][done],), exact,
                      F32_SUM_RTOL)
    assert strs[0].dtype == torch.float32
    # #12 with #15's merge (the tier's widening), on the port's aggregates.
    r_args = (part.val, part.col_s, part.ii_g, part.row_done, *strs, part.lhs_g, part.rhs_g,
              part.run_start, part.run_len, part.run_inst, part.run_slab, _t(act))
    tlb, tub = _t(lb), _t(ub)
    acc = tk.accumulator_planes(tlb)
    got = tk.batched_slab_round_tiles(*r_args, tlb, tub, SLAB, part.max_run_len, eps,
                                      CFG.int_eps, CFG.inf, outward, acc=acc,
                                      tiles=(part.tile_inst, part.tile_slab),
                                      chunk_len=part.chunk_len)
    want = rkern.batched_slab_round_tiles(
        want_p.val, want_p.col_s, want_p.ii_g, want_p.row_done, *map(_j, strs), want_p.lhs_g,
        want_p.rhs_g, want_p.run_start, want_p.run_len, want_p.run_inst, want_p.run_slab,
        _j(act), _j(lb), _j(ub), SLAB, want_p.max_run_len, eps, CFG.int_eps, CFG.inf,
        interpret=True, outward=outward)
    assert (acc[0] == -CFG.inf).all() and (acc[1] == CFG.inf).all()
    _assert_close(got[:2], want[:2], exact)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    # #15 alone on the plain scatter's candidates.
    best = tref.batched_slab_scatter_ref(
        part.val, part.col_s, part.ii_g, part.row_done, *strs, part.lhs_g, part.rhs_g,
        part.run_start, part.run_inst, part.run_slab, _t(act), _t(lb), _t(ub), SLAB,
        CFG.int_eps, CFG.inf)
    got_m = tk.apply_updates_slab_tiles(_t(lb), _t(ub), best[0].clone(), best[1].clone(),
                                        _t(act), SLAB, eps, CFG.inf, outward)
    want_m = rkern.apply_updates_slab_tiles(_j(lb), _j(ub), _j(best[0]), _j(best[1]), _j(act),
                                            SLAB, eps, CFG.inf, interpret=True, outward=outward)
    _assert_close(got_m[:2], want_m[:2], True)
    # #13 and #14 over three node planes, the middle one inactive.
    nodes = np.array([True, False, True])
    nlb, nub = _planes(rng, 3, width, exact)
    n_args = (part.a_val, part.a_col_s, part.a_run_start, part.a_run_len, part.a_run_slab,
              _t(nodes), _t(nlb), _t(nub), SLAB, part.a_max_run_len)
    got_np = tk.node_slab_partials_tiles(*n_args)
    want_np = rkern.node_slab_partials_tiles(
        want_p.a_val, want_p.a_col_s, want_p.a_run_start, want_p.a_run_len, want_p.a_run_slab,
        _j(nodes), _j(nlb), _j(nub), SLAB, want_p.a_max_run_len, CFG.inf, interpret=True)
    _assert_close([g[nodes] for g in got_np], [np.asarray(w)[nodes] for w in want_np], exact,
                  F32_SUM_RTOL)
    nstrs = tk.straddle_combine_tiles(*got_np, part.a_order, part.a_seg, part.agg_slot,
                                      _t(nodes))
    tnl, tnu = _t(nlb), _t(nub)
    got_n = tk.node_slab_round_tiles(
        part.val, part.col_s, part.ii_g, part.row_done, *nstrs, part.lhs_g, part.rhs_g,
        part.run_start, part.run_len, part.run_slab, _t(nodes), tnl, tnu, SLAB,
        part.max_run_len, eps, CFG.int_eps, CFG.inf, outward, acc=tk.accumulator_planes(tnl),
        tile_slab=part.tile_slab, chunk_len=part.chunk_len)
    want_n = rkern.node_slab_round_tiles(
        want_p.val, want_p.col_s, want_p.ii_g, want_p.row_done, *map(_j, nstrs), want_p.lhs_g,
        want_p.rhs_g, want_p.run_start, want_p.run_len, want_p.run_slab, _j(nodes), _j(nlb),
        _j(nub), SLAB, want_p.max_run_len, eps, CFG.int_eps, CFG.inf, interpret=True,
        outward=outward)
    _assert_close(got_n[:2], want_n[:2], exact)
    np.testing.assert_array_equal(got_n[2].numpy(), np.asarray(want_n[2]))


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
def test_window_merge_stop_forms_match_reference(dtype):
    """#15's early-stop forms, through the partitioned round on the
    kernels' plain versions: one instance's round folded into its loop
    carry with the round's measure (F's order, ``ref.merge_progress``),
    round after round until the stop clears GO; and each active node's
    measure of a node batch's round (#9's order, ``ref.merge_rows_progress``;
    the inactive node's entry kept).  Bounds against the reference's plain
    partitioned round and merge, each measure against its
    ``progress_measure``."""
    name, tile = SLAB_CASES["mixed"]
    pr, pt = _instance(name)
    td = torch.float32 if dtype == np.float32 else torch.float64
    prep = rt.prepare_block_ell(pt, *tile, dtype=td, device="cpu")
    part = prep.slab_partition(SLAB)
    rprep = rops.prepare_block_ell(pr, *tile, dtype=dtype)
    rpart = rprep.slab_partition(SLAB)
    eps, outward = CFG.eps_for(td), CFG.outward_for(td)
    rnd = dict(eps=eps, int_eps=CFG.int_eps, inf=CFG.inf, outward=outward)

    def ref_round(rlb, rub):
        bl, bu = rref.partitioned_round_ref(rpart, rlb[None], rub[None], CFG.int_eps, CFG.inf)
        nl, nu, ch = rbnd.apply_updates(rlb, rub, bl[0, : rprep.n_pad], bu[0, : rprep.n_pad],
                                        eps, CFG.inf, outward)
        return nl, nu, bool(ch), float(rbnd.progress_measure(rlb, rub, nl, nu))

    carry = tcarry.armed_state("cpu")
    stop = tcarry.EarlyStop(STOP, 1)
    kept = tops.KeptPlanes(CFG.inf)
    lb, ub = prep.lb0[None].clone(), prep.ub0[None].clone()
    rlb, rub = rprep.lb0, rprep.ub0
    rounds = 0
    while carry[tcarry.GO]:
        lb, ub, _ = tops.KERNEL_OPS.partitioned(part, lb, ub, tcarry.go_mask(carry), node=False,
                                                kept=kept, carry=(carry, 0, 1), stop=stop, **rnd)
        rlb, rub, ch, prog = ref_round(rlb, rub)
        rounds += 1
        fields = carry.tolist()
        _assert_close((lb[0], ub[0]), (rlb, rub), False)
        _assert_progress(np.array([tcarry.progress_of(fields, td)]), np.array([prog]), dtype)
        assert fields[tcarry.LAST] == int(ch) and fields[tcarry.ROUNDS] == rounds
    assert fields[tcarry.FLAT] == 1 or not fields[tcarry.LAST]
    # A node batch of three planes, the middle one inactive, two rounds.
    act = torch.tensor([True, False, True])
    nlb, nub = prep.lb0.repeat(3, 1), prep.ub0.repeat(3, 1)
    progress = torch.full((3,), float("nan"), dtype=td)
    want = [(rprep.lb0, rprep.ub0)] * 3
    for _ in range(2):
        nlb, nub, ch = tops.KERNEL_OPS.partitioned(part, nlb, nub, act, node=True, kept=kept,
                                                   progress=progress, **rnd)
        for i in (0, 2):
            wl, wu, wch, wprog = ref_round(*want[i])
            want[i] = (wl, wu)
            _assert_close((nlb[i], nub[i]), (wl, wu), False)
            assert bool(ch[i]) == wch
            _assert_progress(progress[i : i + 1], np.array([wprog]), dtype)
        assert torch.isnan(progress[1]) and not bool(ch[1])


# ---------------------------------------------------------------------------
# Single-instance fixed points on the segment and partitioned engines
# ---------------------------------------------------------------------------

# The option sets of the single-instance runs: float32, the early stop at
# float32 and at float64, and a stop that fires after the first round.
SINGLE_MODES = {
    "f32": dict(dtype=F32),
    "stop32": dict(dtype=F32, stop_progress=STOP),
    "stop": dict(stop_progress=STOP),
    "eager32": dict(dtype=F32, stop_progress=1e6),
}


def _ref_fixed_point(pr, fn, prep, stop):
    """Drive the reference's round closure to its fixed point, the early
    stop folded as its while loop folds it (src/repro/kernels/ops.py:
    1290-1310): ``(lb, ub, rounds, changed, progress)``."""
    lb, ub = prep.lb0, prep.ub0
    rounds, changed, flat, prog = 0, True, 0, float("nan")
    while changed and rounds < CFG.max_rounds and (stop is None or flat < 1):
        nlb, nub, ch = fn(lb, ub)
        prog = float(rbnd.progress_measure(lb, ub, nlb, nub))
        if stop is not None:
            flat = flat + 1 if prog < stop else 0
        lb, ub, changed, rounds = nlb, nub, bool(ch), rounds + 1
    return np.asarray(lb)[: pr.n], np.asarray(ub)[: pr.n], rounds, changed, prog


@functools.lru_cache(maxsize=None)
def _ref_engine(name, scatter, tile, mode, limit=None):
    """The reference's fixed point of one instance on one engine (its
    plain round closure, the tier's outward widening), once per session
    and limit."""
    pr, _ = _instance(name)
    kw = SINGLE_MODES[mode]
    prep = rk.prepare_block_ell(pr, *tile, dtype=kw.get("dtype"))
    fn = jax.jit(rk.round_fn_for(prep, use_pallas=False, scatter=scatter, slab=SLAB))
    return _ref_fixed_point(pr, fn, prep, kw.get("stop_progress"))


def _check_engine_run(name, got, want, mode):
    wl, wu, rounds, changed, prog = want
    assert got.lb.dtype == (torch.float32 if mode != "stop" else torch.float64)
    assert int(got.rounds) == rounds and bool(got.converged) == (not changed), name
    _assert_close((got.lb, got.ub), (wl, wu), _exact(name))
    if mode != "f32":
        _assert_progress(got.progress, np.array(prog), F32 if mode != "stop" else np.float64)


ENGINE_CASES = {
    "segment-set_cover": ("set_cover", "segment", (8, 128)),
    "segment-mixed_multichunk": ("mixed1", "segment", (8, 8)),
    "partitioned-knapsack": ("knapsack_wide", "partitioned", (2, 8)),
    "partitioned-mixed": ("mixed_wide2", "partitioned", (4, 32)),
}


@pytest.mark.parametrize("mode", list(SINGLE_MODES))
@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engines_match_reference(case, mode):
    """``propagate_block_ell(scatter="segment" | "partitioned")`` at
    float32, with the early stop at float32 and float64, on both drivers
    and on the kernel and plain paths, against the reference's round
    closure driven to its fixed point."""
    name, scatter, tile = ENGINE_CASES[case]
    _, pt = _instance(name)
    want = _ref_engine(name, scatter, tile, mode)
    kw = SINGLE_MODES[mode]
    runs = [rt.propagate_block_ell(pt, tile_rows=tile[0], tile_width=tile[1], scatter=scatter,
                                   slab=SLAB, driver=driver, use_kernels=uk, device="cpu", **kw)
            for driver in ("host_loop", "device_loop") for uk in (True, False)]
    for got in runs:
        _check_engine_run(name, got, want, mode)
        assert torch.equal(got.lb, runs[0].lb) and torch.equal(got.ub, runs[0].ub)
    if mode == "stop" and name.startswith("mixed"):
        assert not bool(runs[0].converged)  # the stop cut the fixed point
    if scatter == "segment" and kw.get("dtype") is F32:
        prep = tops.prepare_block_ell(pt, *tile, dtype=torch.float32, device="cpu")
        assert prep.gather_columns() is prep.gather_columns()  # widened once per prep
        assert prep.gather_columns().dtype == torch.int32 and prep.d.col.dtype == torch.int16


@pytest.mark.parametrize("mode", ["f32", "stop32"])
@pytest.mark.parametrize("large", ["partitioned", "segment"])
def test_auto_past_the_limit_matches_reference(tiny_budget, monkeypatch, large, mode):
    """``scatter="auto"`` past the (shrunk) limit takes the partitioned
    engine, or the segment one under ``REPRO_AUTO_LARGE_SCATTER=segment``
    (read by both packages), at float32 and with the early stop."""
    monkeypatch.setenv(tops.AUTO_LARGE_SCATTER_ENV, large)
    name, tile = "set_cover_wide", (4, 32)
    pr, pt = _instance(name)
    prep = tops.prepare_block_ell(pt, *tile, dtype=torch.float32, device="cpu")
    assert prep.n_pad > tops.SCATTER_MAX_NPAD
    assert tops._resolve_scatter("auto", prep) == large
    kw = SINGLE_MODES[mode]
    rprep = rk.prepare_block_ell(pr, *tile, dtype=F32)
    fn = jax.jit(rk.round_fn_for(rprep, use_pallas=False, scatter="auto"))
    want = _ref_fixed_point(pr, fn, rprep, kw.get("stop_progress"))
    for driver in ("host_loop", "device_loop"):
        got = rt.propagate_block_ell(pt, tile_rows=tile[0], tile_width=tile[1], driver=driver,
                                     device="cpu", **kw)
        _check_engine_run(name, got, want, mode)


@pytest.mark.parametrize("name,tile_width", [("set_cover", 128), ("mixed", 8)])
def test_float32_legacy_round_matches_reference(name, tile_width):
    """The seed round in the unpadded domain at float32 (kernel C, or A,
    the combine and B, over the compact prep's columns widened per round),
    round by round against the reference's ``legacy_round_fn_for``."""
    pr, pt = _instance(name)
    rprep = rk.prepare_block_ell(pr, tile_width=tile_width, dtype=F32)
    tprep = rt.prepare_block_ell(pt, tile_width=tile_width, dtype=torch.float32, device="cpu")
    assert tprep.d.col.dtype == torch.int16
    ref = jax.jit(rk.legacy_round_fn_for(rprep, use_pallas=False))
    for uk in (True, False):
        fn = tops.legacy_round_fn_for(tprep, use_kernels=uk)
        lb_r, ub_r, lb_t, ub_t = rprep.d.lb0, rprep.d.ub0, tprep.d.lb0.clone(), tprep.d.ub0.clone()
        for _ in range(CFG.max_rounds):
            lb_r, ub_r, wch = ref(lb_r, ub_r)
            lb_t, ub_t, gch = fn(lb_t, ub_t)
            assert lb_t.dtype == torch.float32 and bool(gch) == bool(wch)
            _assert_close((lb_t, ub_t), (lb_r, ub_r), _exact(name))
            if not bool(wch):
                break


# ---------------------------------------------------------------------------
# Batches and node batches past the limit (the partitioned batched rounds)
# ---------------------------------------------------------------------------

WIDE_BATCH = ("knapsack_wide", "set_cover_wide", "mixed_wide2")


def _wide_nodes(pr):
    """The root and two children of its first integer variable at 0."""
    var = int(np.where(np.asarray(pr.is_int, bool))[0][0])
    (dl, du), (ul, uu) = rc.branch_children(pr.lb, pr.ub, var, 0.0)
    return (np.stack([np.asarray(pr.lb, np.float64), dl, ul]),
            np.stack([np.asarray(pr.ub, np.float64), du, uu]))


@pytest.mark.parametrize("mode", list(MODES))
def test_batch_past_the_limit_matches_reference(tiny_budget, mode):
    """``propagate_batch`` past the (shrunk) limit: the partitioned round
    over the bucket's slab partition (#11, the straddle combine, #12 with
    #15, which measures each active row under a stop), in every mode of the
    batched tiers, on the kernel and plain paths, against the reference's
    plain batched fixed point."""
    pops = [_instance(n) for n in WIDE_BATCH]
    want = rc.propagate_batch([pr for pr, _ in pops], use_pallas=False, **MODES[mode])
    (batch,) = tops.packed_problems([pt for _, pt in pops])
    assert batch.n_pad > tops.SCATTER_MAX_NPAD
    dt = torch.float32 if _mode_dtype(mode) == F32 else torch.float64
    part = tops.prepare_problem_batch(batch, dt, device="cpu").slab_partition()
    assert part.val.dtype == dt and part.lhs_g.dtype == dt  # the bucket's value type
    for uk in (True, False):
        got = rt.propagate_batch([pt for _, pt in pops], use_kernels=uk, device="cpu",
                                 **_port_kw(mode))
        for name, g, w in zip(WIDE_BATCH, got, want):
            _assert_flags(g, w)
            _assert_close((g.lb, g.ub), (w.lb, w.ub), _exact(name))
            if mode.startswith("stop") or mode == "eager":
                _assert_progress(g.progress, w.progress, _mode_dtype(mode), name)


@pytest.mark.parametrize("mode", list(MODES))
def test_nodes_past_the_limit_match_reference(tiny_budget, mode):
    """``propagate_nodes`` past the (shrunk) limit: the partitioned node
    round (#13, the straddle combine over the active planes, #14 with #15),
    in every mode of the batched tiers, against the reference's plain
    node fixed point (its partitioned round per node)."""
    name = "mixed_wide2"
    pr, pt = _instance(name)
    lb, ub = _wide_nodes(pr)
    want = rc.propagate_nodes(pr, lb, ub, use_pallas=False, **MODES[mode])
    for uk in (True, False):
        got = rt.propagate_nodes(pt, lb, ub, use_kernels=uk, device="cpu", **_port_kw(mode))
        for f in ("rounds", "converged", "infeasible", "tier_rounds"):
            np.testing.assert_array_equal(_np(getattr(got, f)), _np(getattr(want, f)),
                                          err_msg=f)
        _assert_close((got.lb, got.ub), (want.lb, want.ub), _exact(name))
        if mode.startswith("stop") or mode == "eager":
            _assert_progress(got.progress, want.progress, _mode_dtype(mode), name)


@pytest.mark.parametrize("mode", ["f32", "stop32"])
def test_plain_node_segment_round_matches_reference(tiny_budget, monkeypatch, mode):
    """The plain node round past the limit under
    ``REPRO_AUTO_LARGE_SCATTER=segment`` (the reference's vmapped segment
    round) at float32, against the reference's plain node fixed point under
    the same setting."""
    monkeypatch.setenv(tops.AUTO_LARGE_SCATTER_ENV, "segment")
    name = "mixed_wide"
    pr, pt = _instance(name)
    lb, ub = _wide_nodes(pr)
    want = rc.propagate_nodes(pr, lb, ub, tile_width=32, use_pallas=False, **MODES[mode])
    got = rt.propagate_nodes(pt, lb, ub, tile_width=32, use_kernels=False, device="cpu",
                             **_port_kw(mode))
    assert got.lb.dtype == torch.float32
    for f in ("rounds", "converged", "infeasible"):
        np.testing.assert_array_equal(_np(getattr(got, f)), _np(getattr(want, f)), err_msg=f)
    _assert_close((got.lb, got.ub), (want.lb, want.ub), False)
