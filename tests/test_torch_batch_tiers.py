"""The port's precision tiers on the batched engines (``repro_torch``:
``propagate_batch``, ``propagate_nodes``, ``PropagationService`` and the
batched loop ``batched_step_rounds`` at float32, under ``TierPolicy`` and
with the per-row early stop) against the reference's
(``tests/test_precision.py`` and its ``src/repro/kernels/ops.py``,
``core/nodes.py``, ``core/propagator.py`` and ``core/service.py``), on the
CPU at small sizes.

Contracts, as the reference's: ``rounds``, ``converged``, ``infeasible`` and
``tier_rounds`` equal; bounds bitwise on the exact families (set cover,
knapsack, the cascade chain), ``bounds_equal`` elsewhere; float32 fixed
points never tighter than the float64 sequential oracle's; two tiers land
on the float64 fixed point; the early stop only cuts the trajectory.  The
reference runs its plain rounds (``use_pallas=False``), which widen the
fp32 merges outward as the port's do.  Within the port: the plain versions
of the new float forms against the reference's oracles, #9's early-stop
measure against its own fold, and the batched stop resumable bit for bit
across budgets.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as rc
import repro.core.bounds as rbnd
import repro.data as rd
import repro.kernels as rk
import repro.kernels.ref as rref
from repro.kernels import ops as rops
import repro_torch as rt
from repro_torch import kernels as tk
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

F32_BAND = 1e-6  # the reference's (tests/test_precision.py)
EXACT = ("knapsack", "knapsack1", "set_cover", "cascade")
F32_EPS = float(np.finfo(np.float32).eps)
STOP = 0.05


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


@functools.lru_cache(maxsize=None)
def _multichunk():
    """Two general-float instances whose rows span chunks at tile width 16."""
    pop = [("mixed", rd.make_mixed(m=60, n=45, seed=21)),
           ("mixed2", rd.make_mixed(m=50, n=40, seed=3))]
    return tuple((name, pr, rt.problem_from_reference(pr)) for name, pr in pop)


def _np(x):
    return x.detach().cpu().double().numpy() if isinstance(x, torch.Tensor) else (
        np.asarray(x, np.float64))


def _assert_flags(got, want, name=""):
    for f in ("rounds", "converged", "infeasible", "tier_rounds"):
        np.testing.assert_array_equal(_np(getattr(got, f)), _np(getattr(want, f)),
                                      err_msg=f"{name}: {f}")


def _assert_bounds(name, got_lb, got_ub, want_lb, want_ub, exact):
    if exact:
        np.testing.assert_array_equal(_np(got_lb), _np(want_lb), err_msg=name)
        np.testing.assert_array_equal(_np(got_ub), _np(want_ub), err_msg=name)
    else:
        assert rt.bounds_equal(got_lb, got_ub, _np(want_lb), _np(want_ub)), name


def _progress_rtol(dtype) -> float:
    """The port sums the measure in the merge kernel's order, the reference
    in XLA's: at float64 the sums agree to 1e-12 relative; at float32 to a
    few units of the float32 epsilon per sum (``F32_EPS`` times the
    columns' square root covers the instances here)."""
    return 1e-12 if dtype == np.float64 else 16 * F32_EPS


def _assert_progress(got, want, dtype, name=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=_progress_rtol(dtype),
                               atol=_progress_rtol(dtype), equal_nan=True, err_msg=name)


# The option sets of the batched runs: float32, the two tiers, the early
# stop at float64 and at float32, and a stop that fires after every row's
# first round.
MODES = {
    "f32": dict(dtype=np.float32),
    "tier": dict(policy=rc.TierPolicy()),
    "stop": dict(stop_progress=STOP, patience=1),
    "stop32": dict(dtype=np.float32, stop_progress=STOP, patience=2),
    "eager": dict(stop_progress=1e6, patience=1),
}


def _port_kw(mode):
    kw = dict(MODES[mode])
    if "policy" in kw:
        kw["policy"] = rt.core.TierPolicy()
    return kw


def _mode_dtype(mode):
    return np.float32 if MODES[mode].get("dtype") is np.float32 else np.float64


# ---------------------------------------------------------------------------
# propagate_batch
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _ref_batch(mode, which="population", tile_width=128):
    pop = _population() if which == "population" else _multichunk()
    return rc.propagate_batch([pr for _, pr, _ in pop], tile_width=tile_width,
                              use_pallas=False, **MODES[mode])


@pytest.mark.parametrize("use_kernels", [True, False], ids=["kernels", "plain"])
@pytest.mark.parametrize("mode", list(MODES))
def test_batch_matches_reference(mode, use_kernels):
    """One bucket per ``col_pad`` class, rows that fit one chunk (#8, #9)."""
    pop = _population()
    got = rt.propagate_batch([pt for _, _, pt in pop], use_kernels=use_kernels, device="cpu",
                             **_port_kw(mode))
    want = _ref_batch(mode)
    dt = _mode_dtype(mode)
    for (name, _, _), g, w in zip(pop, got, want):
        _assert_flags(g, w, name)
        _assert_bounds(name, g.lb, g.ub, w.lb, w.ub, name in EXACT)
        assert g.lb.dtype == (torch.float32 if dt == np.float32 else torch.float64)
        if mode.startswith("stop") or mode == "eager":
            _assert_progress(g.progress, w.progress, dt, name)
    if mode == "eager":
        assert sum(not bool(g.converged) for g in got) >= 4


@pytest.mark.parametrize("mode", ["f32", "tier", "stop32"])
def test_multichunk_batch_matches_reference(mode):
    """Rows spanning chunks (tile width 16): A', the combine and E over the
    flat stream at float32, then #9."""
    pop = _multichunk()
    prep = tops.prepare_problem_batch(tops.packed_problems([pt for _, _, pt in pop],
                                                           tile_width=16)[0], np.float32,
                                      device="cpu")
    assert not prep.fits_one_chunk and prep.d.col.dtype == torch.int32
    got = rt.propagate_batch([pt for _, _, pt in pop], tile_width=16, device="cpu",
                             **_port_kw(mode))
    want = _ref_batch(mode, "multichunk", 16)
    for (name, _, _), g, w in zip(pop, got, want):
        _assert_flags(g, w, name)
        _assert_bounds(name, g.lb, g.ub, w.lb, w.ub, False)


@pytest.mark.parametrize("mode", ["f32", "tier"])
def test_batch_warm_start_matches_reference(mode):
    """``bounds=`` warm starts through the same packed tiles: one instance
    tightened, one left at its own bounds."""
    pop = _population()[:4]
    _, pr, pt = pop[0]
    ub = np.array(pr.ub, np.float64)
    ub[::3] = np.minimum(ub[::3], 0.0)
    bounds = [(np.asarray(pr.lb), ub), None, None, (np.asarray(pop[3][1].lb),
                                                    np.asarray(pop[3][1].ub))]
    got = rt.propagate_batch([q for _, _, q in pop], bounds=bounds, device="cpu",
                             **_port_kw(mode))
    want = rc.propagate_batch([q for _, q, _ in pop], bounds=bounds, use_pallas=False,
                              **MODES[mode])
    for (name, _, _), g, w in zip(pop, got, want):
        _assert_flags(g, w, name)
        _assert_bounds(name, g.lb, g.ub, w.lb, w.ub, name in EXACT)


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


def test_fp32_batch_never_tighter_than_f64_oracle():
    """The twin of the reference's ``test_fp32_tier_never_tighter_than_f64_
    oracle[batch]``: against the port's sequential float64 oracle."""
    pop = _population()
    batch = rt.propagate_batch([pt for _, _, pt in pop], dtype=np.float32, device="cpu")
    for (name, _, pt), r in zip(pop, batch):
        seq = rt.core.propagate_sequential(pt)
        if bool(r.infeasible):
            assert seq.infeasible, f"{name}: false fp32 infeasibility"
            continue
        if seq.infeasible:
            continue
        _assert_never_tighter(name, r.lb, r.ub, np.asarray(seq.lb), np.asarray(seq.ub),
                              np.asarray(pt.is_int, bool), F32_BAND)


def _assert_same_fixed_point(name, lb_t, ub_t, lb_r, ub_r, is_int):
    """The reference's ``_assert_same_fixed_point`` (tests/test_precision.py:197)."""
    lb_t, ub_t, lb_r, ub_r = _np(lb_t), _np(ub_t), _np(lb_r), _np(ub_r)
    assert np.array_equal(lb_t[is_int], lb_r[is_int]), name
    assert np.array_equal(ub_t[is_int], ub_r[is_int]), name
    assert np.all(np.abs(lb_t - lb_r) <= F32_BAND * (1.0 + np.abs(lb_r))), name
    assert np.all(np.abs(ub_t - ub_r) <= F32_BAND * (1.0 + np.abs(ub_r))), name


def test_two_tier_batch_lands_on_f64_fixed_point():
    """The twin of the reference's test of the same name."""
    pop = _population()
    base = rt.propagate_batch([pt for _, _, pt in pop], device="cpu")
    tier = rt.propagate_batch([pt for _, _, pt in pop], policy=rt.core.TierPolicy(),
                              device="cpu")
    for (name, _, pt), r64, r in zip(pop, base, tier):
        assert bool(r.infeasible) == bool(r64.infeasible), name
        assert r.tier_rounds.dtype == torch.int32 and int(r.tier_rounds) >= 1, name
        if bool(r64.infeasible):
            continue
        _assert_same_fixed_point(name, r.lb, r.ub, r64.lb, r64.ub,
                                 np.asarray(pt.is_int, bool))


# ---------------------------------------------------------------------------
# propagate_nodes
# ---------------------------------------------------------------------------


def _three_nodes(p):
    """The reference test's nodes (tests/test_precision.py:280): the root
    and the two children of the first integer variable at 0."""
    var = int(np.where(np.asarray(p.is_int, bool))[0][0])
    (dl, du), (ul, uu) = rc.branch_children(p.lb, p.ub, var, 0.0)
    return (np.stack([np.asarray(p.lb, np.float64), dl, ul]),
            np.stack([np.asarray(p.ub, np.float64), du, uu]))


# Node cases: (instance, tile width).  set_cover (the reference test's
# nodes) and pb fit one chunk (#10); mixed's rows span chunks at width 8
# (A', the combine and E over the node batch) and hold general floats.  All
# have n_pad <= 2^15, so their float32 preps hold the compact int16 / int8
# streams.
NODE_CASES = {"set_cover": ("set_cover", 128), "mixed_multichunk": ("mixed", 8),
              "pb": ("pb", 128)}
NODE_MODES = ("f32", "tier", "stop32", "eager")


def _node_case(case):
    name, tw = NODE_CASES[case]
    _, pr, pt = next(c for c in _population() if c[0] == name)
    return name, tw, pr, pt


@functools.lru_cache(maxsize=None)
def _ref_nodes(case, mode):
    _, tw, pr, _ = _node_case(case)
    lb, ub = _three_nodes(pr)
    return rc.propagate_nodes(pr, lb, ub, tile_width=tw, use_pallas=False, **MODES[mode])


@pytest.mark.parametrize("mode", NODE_MODES)
@pytest.mark.parametrize("case", list(NODE_CASES))
def test_nodes_match_reference(case, mode):
    name, tw, pr, pt = _node_case(case)
    lb, ub = _three_nodes(pr)
    got = rt.propagate_nodes(pt, lb, ub, tile_width=tw, device="cpu", **_port_kw(mode))
    want = _ref_nodes(case, mode)
    prep = tops.prepare_block_ell(pt, tile_width=tw, dtype=np.float32, device="cpu")
    assert prep.d.col.dtype == torch.int16 and prep.ii_g.dtype == torch.int8
    assert prep.fits_one_chunk == (case != "mixed_multichunk")
    for f in ("rounds", "converged", "infeasible"):
        np.testing.assert_array_equal(_np(getattr(got, f)), _np(getattr(want, f)), err_msg=f)
    np.testing.assert_array_equal(_np(got.tier_rounds), _np(want.tier_rounds))
    _assert_bounds(case, got.lb, got.ub, want.lb, want.ub, name in EXACT)
    if mode in ("stop32", "eager"):
        _assert_progress(got.progress, want.progress, _mode_dtype(mode), case)


def test_nodes_with_int32_ids_match_reference(monkeypatch):
    """A float32 node batch with int32 ids (the compact limit moved below
    the instance's n_pad) gives the compact form's results."""
    name, tw, pr, pt = _node_case("set_cover")
    lb, ub = _three_nodes(pr)
    compact = rt.propagate_nodes(pt, lb, ub, dtype=np.float32, device="cpu")
    monkeypatch.setattr(tops, "_COMPACT_COL_MAX_NPAD", 64)
    rt.kernels.clear_prepare_cache()
    try:
        prep = tops.prepare_block_ell(pt, dtype=np.float32, device="cpu")
        assert prep.d.col.dtype == torch.int32
        wide = rt.propagate_nodes(pt, lb, ub, dtype=np.float32, device="cpu")
    finally:
        rt.kernels.clear_prepare_cache()
    for f in ("lb", "ub", "rounds", "converged", "infeasible"):
        assert torch.equal(getattr(wide, f), getattr(compact, f)), f
    want = _ref_nodes("set_cover", "f32")
    np.testing.assert_array_equal(_np(wide.lb), _np(want.lb))


def test_two_tier_nodes_lands_on_f64_fixed_point():
    """The twin of the reference's test of the same name; ``tier_rounds``
    is a ``(B,)`` int32, 0 without a policy."""
    _, _, pr, pt = _node_case("set_cover")
    lb, ub = _three_nodes(pr)
    base = rt.propagate_nodes(pt, lb, ub, device="cpu")
    tier = rt.propagate_nodes(pt, lb, ub, policy=rt.core.TierPolicy(), device="cpu")
    assert base.tier_rounds == 0
    assert tier.tier_rounds.dtype == torch.int32 and tier.tier_rounds.shape == (3,)
    is_int = np.asarray(pt.is_int, bool)
    for i in range(3):
        assert bool(tier.infeasible[i]) == bool(base.infeasible[i])
        if bool(base.infeasible[i]):
            continue
        _assert_same_fixed_point(f"node{i}", tier.lb[i], tier.ub[i], base.lb[i], base.ub[i],
                                 is_int)


def test_infeasible_fp32_node_restarts_with_no_tier_rounds(monkeypatch):
    """A node whose fp32 tier says infeasible restarts from its original
    bounds with ``tier_rounds`` 0, as the reference's rule
    (src/repro/core/nodes.py:203-241); the others are promoted."""
    _, _, pr, pt = _node_case("set_cover")
    lb, ub = _three_nodes(pr)
    real = tops.propagate_nodes_prepared

    def forged(prep, lb_n, ub_n, cfg, **kw):
        out = list(real(prep, lb_n, ub_n, cfg, **kw))
        if prep.d.val.dtype == torch.float32:
            out[4] = out[4].clone()
            out[4][1] = True
        return tuple(out)

    monkeypatch.setattr(tops, "propagate_nodes_prepared", forged)
    tier = rt.propagate_nodes(pt, lb, ub, policy=rt.core.TierPolicy(), device="cpu")
    base = rt.propagate_nodes(pt, lb, ub, device="cpu")
    assert int(tier.tier_rounds[1]) == 0 and int(tier.tier_rounds[0]) >= 1
    assert int(tier.rounds[1]) == int(base.rounds[1])
    np.testing.assert_array_equal(tier.lb[1].numpy(), base.lb[1].numpy())


# ---------------------------------------------------------------------------
# The per-row early stop of the batched loop
# ---------------------------------------------------------------------------


def _node_state(pr, dtype):
    """The node test's carried state (tests/test_torch_nodes.py): five
    branched knapsack nodes with rounds already run, one inactive."""
    rng = np.random.default_rng(0)
    nodes = []
    for _ in range(5):
        lb, ub = pr.lb.copy(), pr.ub.copy()
        for var in rng.choice(pr.n, size=3, replace=False):
            if not pr.is_int[var] or lb[var] >= ub[var]:
                continue
            down, up = rc.branch_children(lb, ub, int(var), lb[var])
            lb, ub = down if rng.random() < 0.5 else up
        nodes.append((lb, ub))
    n_pad = rk.col_pad(pr.n)
    lb = np.zeros((5, n_pad), dtype)
    ub = np.zeros((5, n_pad), dtype)
    lb[:, : pr.n] = np.stack([a for a, _ in nodes])
    ub[:, : pr.n] = np.stack([b for _, b in nodes])
    active = np.array([True, True, False, True, True])
    rounds = np.array([0, 2, 5, 1, 3], np.int32)
    return lb, ub, active, rounds


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
def test_batched_step_rounds_with_stop_matches_reference(dtype):
    """``batched_step_rounds`` with ``stop_progress``/``patience`` over the
    reference's and the port's plain node rounds, from a carried state:
    per-row bounds, ``active``, ``last_changed``, ``rounds``, ``flat`` equal
    and ``progress`` to the order's tolerance; then a bounded step."""
    pr = rd.make_knapsack(n=40, m=12, seed=1)
    lb, ub, active, rounds = _node_state(pr, dtype)
    cfg = rc.PropagatorConfig(max_rounds=12)
    r_fn = rk.node_round_fn_for(rk.prepare_block_ell(pr, dtype=dtype), cfg, use_pallas=False)
    t_cfg = rt.core.PropagatorConfig(max_rounds=12)
    t_prep = tk.prepare_block_ell(rt.problem_from_reference(pr), dtype=dtype, device="cpu")
    t_fn = tk.node_round_fn_for(t_prep, t_cfg, use_kernels=False)
    j = lambda x: jnp.asarray(x)
    t = lambda x: torch.from_numpy(np.array(x))
    for budget, patience in ((None, 2), (2, 1)):
        kw = dict(stop_progress=STOP, patience=patience, with_progress=True)
        want = rc.batched_step_rounds(r_fn, j(lb), j(ub), j(active), j(active), j(rounds),
                                      cfg.max_rounds, budget=budget, **kw)
        got = rt.core.batched_step_rounds(t_fn, t(lb), t(ub), t(active), t(active), t(rounds),
                                          t_cfg.max_rounds, budget=budget, **kw)
        assert len(got) == len(want) == 7
        for i in (0, 1):
            np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))
        for i in (2, 3, 4, 6):
            np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))
        _assert_progress(got[5], want[5], dtype)
        assert int(np.asarray(want[6]).max()) >= 1  # the stop did fire


def _measured_batch_fn(dtype):
    pop = _population()
    (batch,) = [b for b in tops.packed_problems([pt for _, _, pt in pop[:3]], tile_width=8)]
    prep = tops.prepare_problem_batch(batch, dtype, device="cpu")
    return prep, tops.batched_round_fn_for(prep)


@pytest.mark.parametrize("budget", [1, 2, 3])
def test_batched_stop_is_resumable_across_budgets(budget):
    """With the stop armed, a fixed point chunked by ``budget`` ends where
    one call does, bit for bit: bounds, mask, flags, rounds, progress and
    the low-progress streak."""
    prep, fn = _measured_batch_fn(torch.float32)
    assert fn.measured
    bsz = prep.size
    state0 = (prep.d.lb0.clone(), prep.d.ub0.clone(), torch.ones(bsz, dtype=torch.bool),
              torch.ones(bsz, dtype=torch.bool), torch.zeros(bsz, dtype=torch.int32))
    kw = dict(stop_progress=0.5, patience=2, with_progress=True)
    one = rt.core.batched_step_rounds(fn, *[x.clone() for x in state0], 40, **kw)
    state = [x.clone() for x in state0]
    prog = flat = None
    for _ in range(50):
        out = rt.core.batched_step_rounds(fn, *state, 40, budget=budget, progress=prog,
                                          flat=flat, **kw)
        state, prog, flat = list(out[:5]), out[5], out[6]
        if not bool(state[2].any()):
            break
    for g, w in zip((*state, prog, flat), one):
        assert torch.equal(g, w) or (torch.isnan(g).all() and torch.isnan(w).all())
    assert int(one[6].max()) >= 1


def test_unmeasured_round_closure_takes_the_stop_from_copies():
    """A round closure that does not measure (no ``measured``) gets each
    row's measure from copies of the planes, with the same streak and mask
    as the measured closure on an exact family."""
    prep, fn = _measured_batch_fn(torch.float64)
    plain = lambda lb, ub, act: fn(lb, ub, act)  # noqa: E731  (no ``measured``)
    bsz = prep.size
    args = lambda: (prep.d.lb0.clone(), prep.d.ub0.clone(), torch.ones(bsz, dtype=torch.bool),
                    torch.ones(bsz, dtype=torch.bool), torch.zeros(bsz, dtype=torch.int32))
    kw = dict(stop_progress=0.5, patience=1, with_progress=True)
    a = rt.core.batched_step_rounds(fn, *args(), 40, **kw)
    b = rt.core.batched_step_rounds(plain, *args(), 40, **kw)
    for i in (0, 1, 2, 3, 4, 6):
        assert torch.equal(a[i], b[i])
    torch.testing.assert_close(a[5], b[5], rtol=1e-12, atol=1e-12, equal_nan=True)


# ---------------------------------------------------------------------------
# The service: float32 and the early retire
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _retire_population():
    """The reference test's population (tests/test_precision.py:368)."""
    pop = [rd.make_set_cover(n=60, m=20, seed=s) for s in range(3)] + [
        rd.make_mixed(m=80, n=60, seed=s) for s in range(3)]
    return tuple(pop), tuple(rt.problem_from_reference(p) for p in pop)


@functools.lru_cache(maxsize=None)
def _ref_service(**kw):
    pop, _ = _retire_population()
    svc = rc.PropagationService.from_problems(pop, slots=2, tile_width=8, use_pallas=False, **kw)
    return svc.serve(pop), svc.stats()["early_stopped"]


def test_service_early_retire_frees_slots():
    """The twin of the reference's test of the same name: the same
    population and settings; ``early_stopped`` equal to the reference
    service's and to the per-result evidence; every early result a prefix
    of the exact service's trajectory; each ticket the reference's."""
    pop, tpop = _retire_population()
    exact = rt.PropagationService.from_problems(tpop, slots=2, tile_width=8, device="cpu")
    ref = exact.serve(tpop)
    assert exact.stats()["early_stopped"] == 0
    eager = rt.PropagationService.from_problems(tpop, slots=2, tile_width=8, device="cpu",
                                                stop_progress=1e6, patience=1)
    got = eager.serve(tpop)
    want, want_early = _ref_service(stop_progress=1e6, patience=1)
    n_early = sum(1 for r in got if not bool(r.converged)
                  and int(r.rounds) < rt.core.DEFAULT_CONFIG.max_rounds)
    assert eager.stats()["early_stopped"] == n_early == want_early
    assert n_early >= 1
    for i, (r, rr, w) in enumerate(zip(got, ref, want)):
        _assert_flags(r, w._replace(tier_rounds=0), f"ticket {i}")
        _assert_bounds(f"ticket {i}", r.lb, r.ub, w.lb, w.ub, i < 3)
        if bool(rr.infeasible):
            continue
        assert np.all(_np(r.lb) <= _np(rr.lb)) and np.all(_np(r.ub) >= _np(rr.ub))
        assert np.isfinite(float(r.progress)) or bool(r.converged)


@pytest.mark.parametrize("use_kernels", [True, False], ids=["kernels", "plain"])
def test_float32_service_matches_reference(use_kernels):
    """The whole service at float32 against the reference's float32 service:
    every ticket's flags, bounds (bitwise on the set covers) and dtype, and
    each ticket bitwise the port's one-shot float32 batch."""
    pop, tpop = _retire_population()
    svc = rt.PropagationService.from_problems(tpop, slots=2, tile_width=8, dtype=np.float32,
                                              use_kernels=use_kernels, device="cpu")
    got = svc.serve(tpop)
    want, _ = _ref_service(dtype=np.float32)
    for i, (r, w, p) in enumerate(zip(got, want, tpop)):
        assert r.lb.dtype == torch.float32
        _assert_flags(r, w._replace(tier_rounds=0), f"ticket {i}")
        _assert_bounds(f"ticket {i}", r.lb, r.ub, w.lb, w.ub, i < 3)
        one = rt.propagate_batch([p], tile_width=8, dtype=np.float32, device="cpu")[0]
        for f in ("lb", "ub", "rounds", "converged", "progress"):
            assert torch.equal(getattr(r, f), getattr(one, f)), (i, f)


# ---------------------------------------------------------------------------
# The plain versions of the new float forms
# ---------------------------------------------------------------------------


_REF_BATCHED = jax.jit(rref.batched_fused_scatter_round_ref, static_argnums=(7, 8))
_REF_NODE = jax.jit(rref.node_fused_scatter_round_ref, static_argnums=(7, 8))
_REF_MERGE_BATCH = jax.jit(rbnd.apply_updates_batch, static_argnums=(4, 5, 6))


def _node_planes(pr, count, dtype, seed=0):
    rng = np.random.default_rng(seed)
    n_pad = rk.col_pad(pr.n)
    lb = np.zeros((count, n_pad))
    ub = np.zeros((count, n_pad))
    for i in range(count):
        l, u = np.array(pr.lb, np.float64), np.array(pr.ub, np.float64)
        for var in rng.choice(np.flatnonzero(pr.is_int), size=1 + i % 3, replace=False):
            (dl, du), (ul, uu) = rc.branch_children(l, u, int(var), l[var])
            l, u = (dl, du) if rng.random() < 0.5 else (ul, uu)
        lb[i, : pr.n], ub[i, : pr.n] = l, u
    return lb.astype(dtype), ub.astype(dtype)


@pytest.mark.parametrize("name", ["set_cover", "knapsack", "mixed"])
def test_float32_node_plain_versions_match_reference(name):
    """#10 (or the node-batched A', combine and E, at tile width 8) on the
    compact streams, then #9 with the tier's widening, at float32, against
    the reference's node oracle (or its single-instance oracles per node),
    with a node inactive."""
    exact = name in EXACT
    _, pr, pt = next(c for c in _population() if c[0] == name)
    cfg = rt.core.DEFAULT_CONFIG
    eps, outward = cfg.eps_for(torch.float32), cfg.outward_for(torch.float32)
    for tw in (128, 8):
        rp = rk.prepare_block_ell(pr, tile_width=tw, dtype=np.float32)
        tp = tk.prepare_block_ell(pt, tile_width=tw, dtype=torch.float32, device="cpu")
        lb, ub = _node_planes(pr, 4, np.float32)
        act = np.array([True, False, True, True])
        t_act = torch.from_numpy(act)
        lb_t, ub_t = torch.from_numpy(lb), torch.from_numpy(ub)
        if tp.fits_one_chunk:
            acc = tk.accumulator_planes(lb_t)
            got = tk.node_fused_scatter_round_tiles(
                tp.d.val, tp.d.col, tp.ii_g, tp.lhs_g, tp.rhs_g, lb_t, ub_t, t_act, tp.n_pad,
                cfg.int_eps, acc=acc)
            want = _REF_NODE(rp.d.val, rp.d.col, rp.ii_g, rp.lhs_g, rp.rhs_g, jnp.asarray(lb),
                             jnp.asarray(ub), rp.n_pad, cfg.int_eps)
            want = tuple(np.where(act[:, None], np.asarray(w), s)
                         for w, s in zip(want, (-cfg.inf, cfg.inf)))
        else:
            parts = tk.node_activities_gather_tiles(tp.d.val, tp.d.col, lb_t, ub_t, t_act,
                                                    tp.n_pad)
            aggs = tk.node_combine_chunk_partials_tiles(*parts, tp.d.chunk_row, tp.row_start,
                                                        t_act)
            got = tk.node_candidates_scatter_tiles(
                tp.d.val, tp.d.col, tp.ii_g, *aggs, tp.lhs_g, tp.rhs_g, lb_t, ub_t, t_act,
                tp.n_pad, cfg.int_eps)
            want = [np.full(lb.shape, -cfg.inf, np.float32), np.full(ub.shape, cfg.inf,
                                                                       np.float32)]
            for i in np.flatnonzero(act):
                w = rref.candidates_scatter_tiles_ref(
                    rp.d.val, rp.d.col, rp.ii_g,
                    *[jax.ops.segment_sum(x.reshape(-1), rp.d.chunk_row.reshape(-1),
                                          num_segments=rp.m + 1)[rp.d.chunk_row]
                      for x in rref.activities_gather_tiles_ref(rp.d.val, rp.d.col, lb[i], ub[i],
                                                                rp.n_pad)],
                    rp.lhs_g, rp.rhs_g, lb[i], ub[i], rp.n_pad, cfg.int_eps)
                want[0][i], want[1][i] = np.asarray(w[0]), np.asarray(w[1])
        _assert_bounds(f"{name} K={tw}", got[0], got[1], want[0], want[1], exact)
        assert got[0].dtype == torch.float32
        wl, wu, wch = _REF_MERGE_BATCH(jnp.asarray(lb), jnp.asarray(ub),
                                       jnp.asarray(_np(got[0]).astype(np.float32)),
                                       jnp.asarray(_np(got[1]).astype(np.float32)), eps,
                                       cfg.inf, outward)
        gl, gu, gch = tk.apply_updates_batch_tiles(lb_t.clone(), ub_t.clone(), got[0].clone(),
                                                   got[1].clone(), t_act, eps, cfg.inf, outward)
        for i in range(4):
            if act[i]:
                np.testing.assert_array_equal(gl[i].numpy(), np.asarray(wl[i]))
                np.testing.assert_array_equal(gu[i].numpy(), np.asarray(wu[i]))
                assert bool(gch[i]) == bool(wch[i])
            else:
                assert torch.equal(gl[i], lb_t[i]) and not bool(gch[i])


@pytest.mark.parametrize("name", ["set_cover", "cascade", "pb"])
def test_float32_batched_fused_plain_version_matches_reference(name):
    """#8 at float32 (int32 ids) on a two-instance bucket with one instance
    inactive, against the reference's batched oracle."""
    _, pr, pt = next(c for c in _population() if c[0] == name)
    other = rd.make_knapsack(n=50, m=10, seed=4)  # the same col_pad class (128)
    (rbatch,) = rc.pack_problems([pr, other])
    rprep = rk.prepare_problem_batch(rbatch, np.float32)
    (tbatch,) = tops.packed_problems([pt, rt.problem_from_reference(other)])
    tprep = tops.prepare_problem_batch(tbatch, torch.float32, device="cpu")
    d, cfg = tprep.d, rt.core.DEFAULT_CONFIG
    assert d.col.dtype == torch.int32 and d.val.dtype == torch.float32
    act = torch.tensor([True, False])
    got = tk.batched_fused_scatter_round_tiles(
        d.val, d.col, d.ii_g, d.lhs_g, d.rhs_g, d.lb0, d.ub0, d.tile_inst, act, tprep.n_pad,
        cfg.int_eps, acc=tk.accumulator_planes(d.lb0))
    rd_ = rprep.d
    want = _REF_BATCHED(rd_.val, rd_.col_g, rd_.ii_g, rd_.lhs_g, rd_.rhs_g, rd_.lb0, rd_.ub0,
                        rprep.n_pad, cfg.int_eps)
    _assert_bounds(name, got[0][0], got[1][0], np.asarray(want[0])[0], np.asarray(want[1])[0],
                   name in EXACT)
    assert bool((got[0][1] == -cfg.inf).all()) and bool((got[1][1] == cfg.inf).all())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_merge_batch_stop_plain_version_is_its_fold(dtype):
    """#9 with the early stop's measure, plain version: each active row's
    block sums and measure are the kernel order's fold of the row's terms
    (``ref.merge_progress`` on the row alone), the bounds and flags #9's
    without the stop, inactive rows' entries untouched; the measure is
    ``bounds.progress_measure`` up to the sum's order."""
    rng = np.random.default_rng(3)
    bsz, n = 5, 2_500
    lb = torch.from_numpy(rng.uniform(-5, 0, (bsz, n))).to(dtype)
    ub = lb + torch.from_numpy(rng.uniform(0, 5, (bsz, n))).to(dtype)
    lb[:, ::7] = -rc.INF
    bl = torch.where(torch.from_numpy(rng.random((bsz, n)) < 0.3), lb + 0.5, -rc.INF).to(dtype)
    bu = torch.where(torch.from_numpy(rng.random((bsz, n)) < 0.3), ub - 0.25, rc.INF).to(dtype)
    act = torch.tensor([True, False, True, True, False])
    eps = rt.core.DEFAULT_CONFIG.eps_for(dtype)
    outward = rt.core.DEFAULT_CONFIG.outward_for(dtype)
    blocks = -(-n // tref.MERGE_BLOCK)
    progress = torch.full((bsz,), 7.0, dtype=dtype)
    partials = torch.full((bsz, blocks), 9.0, dtype=dtype)
    got = tk.apply_updates_batch_tiles(lb.clone(), ub.clone(), bl.clone(), bu.clone(), act, eps,
                                       rc.INF, outward, progress=progress, partials=partials)
    want = tk.apply_updates_batch_tiles(lb.clone(), ub.clone(), bl.clone(), bu.clone(), act, eps,
                                        rc.INF, outward)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for b in range(bsz):
        if act[b]:
            assert float(progress[b]) == float(tref.merge_progress(lb[b], ub[b], got[0][b],
                                                                   got[1][b]))
            terms = tref._progress_terms(lb[b], ub[b], got[0][b], got[1][b])
            assert torch.equal(partials[b], tref.merge_block_sums(terms))
            torch.testing.assert_close(
                progress[b], rt.core.progress_measure(lb[b], ub[b], got[0][b], got[1][b]),
                rtol=1e-12 if dtype == torch.float64 else 1e-5, atol=0.0)
        else:
            assert float(progress[b]) == 7.0 and bool((partials[b] == 9.0).all())


def test_merge_order_sum_rows_is_the_vector_order():
    """``ref.merge_order_sum`` over ``(B, n)`` rows is the 1-D sum row by
    row (F's order is #9's per row)."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.random((3, 3_000)))
    rows = tref.merge_order_sum(x)
    for b in range(3):
        assert float(rows[b]) == float(tref.merge_order_sum(x[b]))


def test_kept_stop_buffers_are_allocated_once():
    """The batched round closure keeps #9's stop buffers (one allocation,
    one partial per row and 1,024-column block) across rounds."""
    prep, fn = _measured_batch_fn(torch.float32)
    lb, ub = prep.d.lb0.clone(), prep.d.ub0.clone()
    act = torch.ones(prep.size, dtype=torch.bool)
    prog = torch.zeros(prep.size, dtype=torch.float32)
    fn(lb, ub, act, progress=prog)
    first = fn.kept.stop_buffers(lb)["partials"]
    fn(lb, ub, act, progress=prog)
    assert fn.kept.stop_buffers(lb)["partials"] is first
    assert fn.kept.stop_buffers(lb)["partials"].shape == (prep.size, 1)


# ---------------------------------------------------------------------------
# Past SCATTER_MAX_NPAD: the partitioned batch and node rounds
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["batch_float32", "batch_stop", "batch_tier", "nodes_float32",
                                  "nodes_stop", "nodes_tier"])
def test_batched_tiers_past_the_limit_raise(monkeypatch, case):
    """Past ``SCATTER_MAX_NPAD`` (the partitioned batch and node rounds)
    float32, the early stop and the two tiers run (the engine slice ports
    them) and match the reference's plain batched and node rounds with the
    limit moved in both packages: flags, tier rounds, bounds bitwise on set
    cover, the stop's progress within ``_progress_rtol``; float64 without a
    stop still runs there."""
    _, pr, pt = next(c for c in _population() if c[0] == "set_cover")
    monkeypatch.setattr(tops, "SCATTER_MAX_NPAD", 64)
    monkeypatch.setattr(rops, "SCATTER_MAX_NPAD", 64)
    lb, ub = _three_nodes(pr)
    opt = case.split("_")[1]
    mode = {"float32": "f32", "stop": "stop", "tier": "tier"}[opt]
    if case.startswith("batch"):
        run = lambda **k: rt.propagate_batch([pt], device="cpu", **k)[0]  # noqa: E731
        want = rc.propagate_batch([pr], use_pallas=False, **MODES[mode])[0]
    else:
        run = lambda **k: rt.propagate_nodes(pt, lb, ub, device="cpu", **k)  # noqa: E731
        want = rc.propagate_nodes(pr, lb, ub, use_pallas=False, **MODES[mode])
    got = run(**_port_kw(mode))
    _assert_flags(got, want, case)
    _assert_bounds(case, got.lb, got.ub, want.lb, want.ub, True)
    if mode == "stop":
        _assert_progress(got.progress, want.progress, np.float64, case)
    run()  # float64 on the partitioned round
