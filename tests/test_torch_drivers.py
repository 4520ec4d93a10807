"""The port's named loop drivers against the reference's, and the loop carry
that kernel F keeps on the device.

  * ``propagate(driver=...)`` for ``host_loop``, ``device_loop`` and
    ``unrolled``, and ``propagate_host_loop`` / ``propagate_device_loop`` /
    ``propagate_unrolled`` / ``fresh_instance_runner``, against
    ``repro.core``'s, under the equality contract of
    ``tests/test_torch_propagator.py``: rounds, converged, infeasible and
    progress exactly (progress to 1e-12, NaN where the reference's is),
    exact families bitwise, float families ``bounds_equal`` and
    ``allclose(1e-12)``;
  * round caps that end inside a check group and across the host's read
    groups (``DEVICE_LOOP_GROUP`` and ``UNGATED_LOOP_GROUP`` monkeypatched),
    and which of the two each engine's closure reads;
  * ``propagate_block_ell``'s ``device_loop`` bitwise equal to its
    ``host_loop`` on every engine, on the kernels' CPU branches and on the
    plain versions;
  * the carry's fields after F's plain version, including rounds enqueued
    after convergence, which change nothing;
  * the host reads each driver makes (``on_sync``).
"""
import math

import numpy as np
import pytest
import torch

import repro.core as rc
import repro.data as rd
import repro.kernels.ops as rops
import repro_torch as rt
from repro_torch.core import carry as tcarry
from repro_torch.core import propagator as tprop
from repro_torch.kernels import ops as tops
from repro_torch.kernels import prop_round as tk

from test_torch_propagator import EXACT_CASES, FLOAT_CASES, assert_results_match, case_id

CASES = [(c, True) for c in EXACT_CASES] + [(c, False) for c in FLOAT_CASES]
CASE_IDS = [case_id(c) for c in EXACT_CASES + FLOAT_CASES]
UNROLL = {"host_loop": 1, "device_loop": 1, "unrolled": 4}


def expected_reads(driver: str, rounds: int, group: int) -> int:
    """Host reads of a fixed point of ``rounds`` rounds: one per round on
    the host loop; one per ``group`` check groups on the device loops (the
    last read is the one that sees the loop stopped or its groups spent)."""
    if driver == "host_loop":
        return rounds
    return math.ceil(rounds // UNROLL[driver] / group)


def _set_groups(monkeypatch, group: int) -> None:
    """Both read groups of the device loop set to ``group``."""
    monkeypatch.setattr(tprop, "DEVICE_LOOP_GROUP", group)
    monkeypatch.setattr(tprop, "UNGATED_LOOP_GROUP", group)


def _counter():
    n = [0]
    return n, lambda: n.__setitem__(0, n[0] + 1)


@pytest.mark.parametrize("driver", list(UNROLL))
@pytest.mark.parametrize("case,exact", CASES, ids=CASE_IDS)
def test_propagate_drivers_match_reference(case, exact, driver):
    gen, kw = case
    pr = getattr(rd, gen)(**kw)
    want = rc.propagate(pr, driver=driver)
    n, count = _counter()
    got = rt.propagate(rt.problem_from_reference(pr), driver=driver, device="cpu",
                       on_sync=count)
    assert_results_match(got, want, exact)
    assert n[0] == expected_reads(driver, int(got.rounds), tprop.UNGATED_LOOP_GROUP)


NAMED = {
    "propagate_host_loop": {},
    "propagate_device_loop": {},
    "propagate_unrolled": {},
    "propagate_device_loop-unroll3": dict(unroll=3),
}


@pytest.mark.parametrize("name", list(NAMED))
@pytest.mark.parametrize("case,exact", [CASES[1], CASES[-1]], ids=[CASE_IDS[1], CASE_IDS[-1]])
def test_named_drivers_match_reference(case, exact, name):
    gen, kw = case
    pr = getattr(rd, gen)(**kw)
    fn = name.split("-")[0]
    want = getattr(rc, fn)(rc.DeviceProblem(pr), **NAMED[name])
    dp = rt.core.DeviceProblem(rt.problem_from_reference(pr), device="cpu")
    got = getattr(rt.core, fn)(dp, **NAMED[name])
    assert_results_match(got, want, exact)
    unroll = NAMED[name].get("unroll", 4 if fn == "propagate_unrolled" else 1)
    assert int(got.rounds) % unroll == 0


@pytest.mark.parametrize("group", [1, 3, 8])
@pytest.mark.parametrize("max_rounds", [5, 7])
def test_round_caps_across_check_groups(monkeypatch, max_rounds, group):
    """A cap that ends inside a check group of 4 (the reference counts the
    whole group, past the cap) and inside the host's read group; and with
    one round per check.  The cascade chain changes a bound every round,
    so the cap cuts every run, and progress is the last group's measure."""
    _set_groups(monkeypatch, group)
    pr = rd.make_cascade_chain(length=24)
    dp = rt.core.DeviceProblem(rt.problem_from_reference(pr), device="cpu")
    cfg_r = rc.PropagatorConfig(max_rounds=max_rounds)
    cfg_t = rt.core.PropagatorConfig(max_rounds=max_rounds)
    for unroll in (1, 4):
        want = rc.propagate_device_loop(rc.DeviceProblem(pr), cfg_r, unroll=unroll)
        n, count = _counter()
        got = rt.core.propagate_device_loop(dp, cfg_t, unroll=unroll, on_sync=count)
        assert_results_match(got, want, exact=True)
        assert int(got.rounds) == -(-max_rounds // unroll) * unroll and not bool(got.converged)
        assert n[0] == math.ceil(-(-max_rounds // unroll) / group)


@pytest.mark.parametrize("group", [1, 3, 8])
def test_convergence_inside_a_read_group(monkeypatch, group):
    """Groups enqueued after convergence, before the host's read, change
    neither the bounds nor the counts: bitwise the host loop's result."""
    _set_groups(monkeypatch, group)
    p = rt.problem_from_reference(rd.make_pseudo_boolean(n=300, m=400, seed=4))
    host = rt.propagate(p, driver="host_loop", device="cpu")
    n, count = _counter()
    dev = rt.propagate(p, driver="device_loop", device="cpu", on_sync=count)
    assert int(dev.rounds) == int(host.rounds) and bool(dev.converged)
    assert torch.equal(dev.lb, host.lb) and torch.equal(dev.ub, host.ub)
    assert n[0] == math.ceil(int(host.rounds) / group)


def _assert_same_result(a, b):
    for f in ("rounds", "converged", "infeasible"):
        assert getattr(a, f).item() == getattr(b, f).item()
    assert torch.equal(a.lb, b.lb) and torch.equal(a.ub, b.ub)
    np.testing.assert_equal(float(a.progress), float(b.progress))


@pytest.mark.parametrize("driver", list(UNROLL))
def test_core_driver_warm_start_identity(driver):
    """As ``tests/test_nodes.py``: warm-starting from the problem's own
    bounds is the cold run, bit for bit."""
    p = rt.problem_from_reference(rd.make_mixed(m=90, n=70, seed=3))
    base = rt.propagate(p, driver=driver, device="cpu")
    warm = rt.propagate(p, driver=driver, lb0=p.lb, ub0=p.ub, device="cpu")
    _assert_same_result(base, warm)


@pytest.mark.parametrize("kwargs", [
    dict(use_kernels=False),
    dict(use_kernels=True),
    dict(use_kernels=False, driver="host_loop"),
    dict(use_kernels=False, scatter="segment"),
])
def test_block_ell_warm_start_identity(kwargs):
    p = rt.problem_from_reference(rd.make_mixed(m=90, n=70, seed=4))
    base = rt.propagate_block_ell(p, device="cpu", **kwargs)
    warm = rt.propagate_block_ell(p, lb0=p.lb, ub0=p.ub, device="cpu", **kwargs)
    _assert_same_result(base, warm)


@pytest.mark.parametrize("gen,kw,fix", [
    ("make_set_cover", dict(n=80, m=40, seed=2), "ub"),
    ("make_knapsack", dict(n=60, m=12, seed=1), "lb"),
])
def test_fresh_instance_runner_matches_reference(gen, kw, fix):
    """The re-upload baseline from warm-start bounds, twice (each call
    uploads the matrix again), against the reference's runner."""
    pr = getattr(rd, gen)(**kw)
    rng = np.random.default_rng(0)
    lb0, ub0 = np.array(pr.lb), np.array(pr.ub)
    picks = rng.choice(pr.n, size=pr.n // 3, replace=False)
    (ub0 if fix == "ub" else lb0)[picks] = 0.0 if fix == "ub" else 1.0
    w_lb, w_ub, w_rounds = rc.fresh_instance_runner(pr)(lb0, ub0)
    run = rt.core.fresh_instance_runner(rt.problem_from_reference(pr), device="cpu")
    for _ in range(2):
        lb, ub, rounds = run(lb0, ub0)
        assert int(rounds) == int(w_rounds) > 1 and rounds.dtype == torch.int32
        np.testing.assert_array_equal(lb.numpy(), np.asarray(w_lb))
        np.testing.assert_array_equal(ub.numpy(), np.asarray(w_ub))


@pytest.fixture
def tiny_limit(monkeypatch):
    """Shrink the engine limit and the slab cap to 128, so small instances
    ride the partitioned round."""
    tops.clear_prepare_cache()
    monkeypatch.setattr(tops, "SCATTER_MAX_NPAD", 128)
    monkeypatch.setattr(tops, "SLAB_NPAD", 128)
    yield
    tops.clear_prepare_cache()


# (engine, generator, kwargs, tile_width, scatter)
ENGINES = {
    "fused": ("make_pseudo_boolean", dict(n=300, m=400, seed=7), 128, "fused"),
    "multi-chunk": ("make_mixed", dict(m=60, n=45, seed=21), 16, "fused"),
    "segment": ("make_mixed", dict(m=60, n=45, seed=21), 16, "segment"),
    "partitioned": ("make_pseudo_boolean", dict(n=300, m=400, seed=4), 8, "partitioned"),
}


@pytest.mark.parametrize("use_kernels", [True, False], ids=["kernels", "plain"])
@pytest.mark.parametrize("engine", list(ENGINES))
def test_block_ell_device_loop_equals_host_loop(monkeypatch, tiny_limit, engine, use_kernels):
    gen, kw, tile_width, scatter = ENGINES[engine]
    _set_groups(monkeypatch, 3)
    p = rt.problem_from_reference(getattr(rd, gen)(**kw))
    kw = dict(tile_width=tile_width, scatter=scatter, use_kernels=use_kernels, device="cpu")
    n_host, count_host = _counter()
    host = rt.propagate_block_ell(p, driver="host_loop", on_sync=count_host, **kw)
    n_dev, count_dev = _counter()
    dev = rt.propagate_block_ell(p, driver="device_loop", on_sync=count_dev, **kw)
    _assert_same_result(dev, host)
    rounds = int(host.rounds)
    assert rounds > 2 and n_host[0] == rounds and n_dev[0] == math.ceil(rounds / 3)
    # A cap inside the last read group: the progress of the capped round.
    cap = rt.core.PropagatorConfig(max_rounds=rounds - 1)
    _assert_same_result(rt.propagate_block_ell(p, cap, driver="device_loop", **kw),
                        rt.propagate_block_ell(p, cap, driver="host_loop", **kw))


@pytest.mark.parametrize("use_kernels", [True, False], ids=["kernels", "plain"])
@pytest.mark.parametrize("engine", list(ENGINES))
def test_read_group_follows_the_engine(monkeypatch, tiny_limit, engine, use_kernels):
    """The device loop reads the carry once per DEVICE_LOOP_GROUP rounds
    where every kernel of a round enqueued after convergence returns at
    once (the fused and partitioned engines on the kernels), and once per
    UNGATED_LOOP_GROUP rounds where such a round still runs in full (the
    segment engine's gather and column reduction, the plain versions)."""
    gen, kw, tile_width, scatter = ENGINES[engine]
    monkeypatch.setattr(tprop, "DEVICE_LOOP_GROUP", 5)
    monkeypatch.setattr(tprop, "UNGATED_LOOP_GROUP", 2)
    p = rt.problem_from_reference(getattr(rd, gen)(**kw))
    prep = rt.prepare_block_ell(p, tile_width=tile_width, device="cpu")
    gated = use_kernels and engine != "segment"
    round_fn = tops.round_fn_for(prep, use_kernels=use_kernels, scatter=scatter)
    assert round_fn.gated == gated and tprop.loop_group(round_fn) == (5 if gated else 2)
    n, count = _counter()
    got = rt.propagate_block_ell(p, tile_width=tile_width, scatter=scatter,
                                 use_kernels=use_kernels, device="cpu", on_sync=count)
    assert n[0] == math.ceil(int(got.rounds) / (5 if gated else 2))


def test_plain_round_reads_the_ungated_group(monkeypatch):
    """propagate's plain round has no kernel to skip a wasted round: its
    device loops read once per UNGATED_LOOP_GROUP check groups."""
    monkeypatch.setattr(tprop, "DEVICE_LOOP_GROUP", 5)
    monkeypatch.setattr(tprop, "UNGATED_LOOP_GROUP", 3)
    p = rt.problem_from_reference(rd.make_pseudo_boolean(n=300, m=400, seed=4))
    dp = rt.core.DeviceProblem(p, device="cpu")
    assert tprop.loop_group(tprop._round_fn(dp, rt.core.DEFAULT_CONFIG)) == 3
    for driver, unroll in (("device_loop", 1), ("unrolled", 4)):
        n, count = _counter()
        got = rt.propagate(p, driver=driver, device="cpu", on_sync=count)
        assert n[0] == math.ceil(int(got.rounds) // unroll / 3)


def test_unarmed_round_flags_stay_their_own():
    """Outside a driver each round runs on a fresh carry, so a round's
    ``changed`` keeps its value after later rounds."""
    p = rt.problem_from_reference(rd.make_cascade_chain(length=12))
    prep = rt.prepare_block_ell(p, tile_width=4, device="cpu")
    for scatter in ("fused", "segment"):
        round_fn = tops.round_fn_for(prep, scatter=scatter)
        lb, ub = prep.lb0.clone(), prep.ub0.clone()
        flags = [round_fn(lb, ub)[2] for _ in range(16)]
        assert [bool(f) for f in flags] == [True] * 13 + [False] * 3
    fresh = [tcarry.armed_state("cpu") for _ in range(2)]
    assert fresh[0].data_ptr() != fresh[1].data_ptr()
    assert fresh[0].tolist() == [0, 0, 0, 1] + [0] * (tcarry.FIELDS - 4)


def test_block_ell_rejects_unrolled():
    """The reference's kernel path takes two drivers; so does the port's."""
    p = rt.problem_from_reference(rd.make_set_cover(n=20, m=8, seed=0))
    with pytest.raises(ValueError, match="unrolled"):
        rt.propagate_block_ell(p, driver="unrolled", device="cpu")
    with pytest.raises(ValueError, match="unknown driver"):
        rops.propagate_block_ell(rd.make_set_cover(n=20, m=8, seed=0), driver="unrolled")


def _while_loop_model(flags, unroll):
    """The reference's carry after each round of check groups of ``unroll``
    rounds whose rounds report ``flags``; rounds after the loop stopped
    count nothing.  Returns ``(rounds, go)`` per round."""
    rounds, go, any_, out = 0, 1, 0, []
    for i, f in enumerate(flags):
        if go:
            any_ |= f
            if i % unroll == unroll - 1:
                rounds, go, any_ = rounds + unroll, any_, 0
        out.append((rounds, go))
    return out


@pytest.mark.parametrize("unroll", [1, 2, 4])
def test_carry_fold_follows_the_while_loop(unroll):
    flags = [1, 1, 0, 1, 0, 0, 0, 0, 1, 1, 0, 1]
    state = tcarry.armed_state("cpu")
    for i, (f, (rounds, go)) in enumerate(zip(flags, _while_loop_model(flags, unroll))):
        tcarry.fold(state, torch.tensor(bool(f)), i % unroll, unroll)
        fields = state.tolist()
        assert fields[tcarry.ROUNDS] == rounds and fields[tcarry.GO] == go
        assert fields[tcarry.FLAG] == fields[tcarry.TICKET] == 0
        assert bool(tcarry.go_flag(state)) == bool(go)
        assert tcarry.go_mask(state).tolist() == [bool(go)]


@pytest.mark.parametrize("unroll", [1, 3])
@pytest.mark.parametrize("form", ["wrapper", "plain_ops"])
def test_merge_keeps_the_carry(form, unroll):
    """F (its CPU branch and ``PLAIN_OPS.merge``) over a sequence of rounds
    of one fixed point: the bounds as ``apply_updates`` gives them while
    the carry's GO is set, the carry's fields as the reference's loop, the
    planes handed back; after convergence a round whose candidates would
    tighten changes nothing and counts nothing."""
    rng = np.random.default_rng(3)
    n = 300
    lb, ub = torch.zeros(n, dtype=torch.float64), torch.full((n,), 10.0, dtype=torch.float64)
    state = tcarry.armed_state("cpu")
    merge = tk.apply_updates_tiles if form == "wrapper" else tops.PLAIN_OPS.merge
    # Rounds that tighten, then (unroll) rounds that do not: the loop stops.
    plan = [True] * (2 * unroll) + [False] * unroll + [True] * 2
    model = _while_loop_model([int(t) for t in plan], unroll)
    for i, (tighten, (rounds, go)) in enumerate(zip(plan, model)):
        bl = torch.full((n,), -rc.INF, dtype=torch.float64)
        bu = torch.full((n,), rc.INF, dtype=torch.float64)
        if tighten:
            pick = torch.from_numpy(rng.random(n) < 0.3)
            bl[pick] = lb[pick] + 1.0
        go_before = bool(tcarry.go_flag(state))
        want = rt.core.apply_updates(lb, ub, bl, bu, 1e-9)
        new_lb, new_ub, ch = merge(lb.clone(), ub.clone(), bl, bu, 1e-9, rc.INF, 0.0,
                                   carry=state, k=i % unroll, unroll=unroll)
        if go_before:
            assert torch.equal(new_lb, want[0]) and torch.equal(new_ub, want[1])
        else:
            assert torch.equal(new_lb, lb) and torch.equal(new_ub, ub)
        fields = state.tolist()
        assert (fields[tcarry.ROUNDS], fields[tcarry.GO]) == (rounds, go)
        assert fields[tcarry.FLAG] == fields[tcarry.TICKET] == 0
        assert bool(ch) == bool(go)
        assert bool((bl == -rc.INF).all()) and bool((bu == rc.INF).all())
        lb, ub = new_lb, new_ub
    assert model[-1] == (3 * unroll, 0)


def test_merge_without_a_carry_reports_its_round():
    """F called on its own arms a carry of its own: the flag says whether
    this merge tightened a bound, and it is not overwritten by the next."""
    lb, ub = torch.zeros(8, dtype=torch.float64), torch.ones(8, dtype=torch.float64)
    bl = torch.full((8,), -rc.INF, dtype=torch.float64)
    bu = torch.full((8,), rc.INF, dtype=torch.float64)
    bl[3] = 0.5
    first = tk.apply_updates_tiles(lb, ub, bl, bu, 1e-9)
    second = tk.apply_updates_tiles(lb, ub, bl, bu, 1e-9)  # handed back: nothing to do
    assert bool(first[2]) and not bool(second[2]) and bool(first[2])


def test_round_closure_inside_and_outside_a_driver():
    """A round closure called outside a driver runs each round as its own
    fixed point; a driver arms its carry for the whole fixed point and
    releases it."""
    p = rt.problem_from_reference(rd.make_cascade_chain(length=12))
    prep = rt.prepare_block_ell(p, tile_width=4, device="cpu")
    round_fn = tops.round_fn_for(prep)
    lb, ub = prep.lb0.clone(), prep.ub0.clone()
    flags = [bool(round_fn(lb, ub)[2]) for _ in range(16)]
    assert flags == [True] * 13 + [False] * 3 and not round_fn.carry.armed
    lb, ub = prep.lb0.clone(), prep.ub0.clone()
    out = tprop.device_fixed_point(round_fn, lb, ub, 100)
    assert out[2] == 14 and not out[3] and not round_fn.carry.armed
    assert round_fn.carry.state.tolist()[: tcarry.TICKET + 1] == [0, 0, 14, 0, 0]


@pytest.mark.parametrize("merge", ["batch", "slab"])
def test_kept_flag_pairs_alternate(merge):
    """#9's and #15's flags through a kept pair: each launch returns one
    buffer and zeroes the other, so no launch needs a fill."""
    rng = np.random.default_rng(5)
    bsz, width = 3, 256
    pair = tk.FlagPair((bsz,) if merge == "batch" else (bsz, 2),
                       torch.bool if merge == "batch" else torch.int32, "cpu")
    active = torch.tensor([True, False, True])
    outs = []
    for _ in range(3):
        lb = torch.from_numpy(rng.uniform(-5, 0, (bsz, width)))
        ub = torch.from_numpy(rng.uniform(0, 5, (bsz, width)))
        bl = torch.from_numpy(rng.uniform(-6, 2, (bsz, width)))
        bu = torch.full((bsz, width), rc.INF, dtype=torch.float64)
        want = rt.core.apply_updates_batch(lb, ub, bl, bu, 1e-9, active=active)[2]
        if merge == "batch":
            got = tk.apply_updates_batch_tiles(lb, ub, bl, bu, active, 1e-9, flags=pair)[2]
        else:
            got = tk.apply_updates_slab_tiles(lb, ub, bl, bu, active, 128, 1e-9, flags=pair)[2]
            assert bool((pair.bufs[0] != 0).any()) != bool((pair.bufs[1] != 0).any())
        assert torch.equal(got, want)
        outs.append(got)
    if merge == "batch":
        assert outs[0] is outs[2] and outs[1] is not outs[0]
        assert not bool(outs[1].any())  # zeroed by the third launch


@pytest.mark.parametrize("kw,item", [
    (dict(stop_progress=1e-3), "item 5"), (dict(patience=2), "item 5"),
    (dict(telemetry=8), "item 6"),
])
@pytest.mark.parametrize("fn", ["propagate_host_loop", "propagate_device_loop",
                                "propagate_unrolled"])
def test_named_drivers_refuse_unported_options(fn, kw, item):
    """The options of items 5 and 6, ported since, run and give the
    reference's named driver's result: rounds, flags, bounds and progress
    (the early stop's ``stop_progress`` and ``patience``), and the rounds
    the telemetry snapshot recorded."""
    pr = rd.make_set_cover(n=20, m=8, seed=0)
    dp = rt.core.DeviceProblem(rt.problem_from_reference(pr), device="cpu")
    want = getattr(rc, fn)(rc.DeviceProblem(pr), **kw)
    got = getattr(rt.core, fn)(dp, **kw)
    assert_results_match(got, want, exact=True)
    if item == "item 6":
        assert got.telemetry.rounds_recorded == want.telemetry.rounds_recorded
