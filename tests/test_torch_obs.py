"""The port's observability (``repro_torch.obs``: the device telemetry plane,
fenced timing and run metadata) against the reference's
(``tests/test_obs.py`` and its ``src/repro/obs/``), on the CPU at small
sizes, and the ``donate=`` keyword of the entry points.

Contracts:
  * telemetry on changes nothing: every result field (bounds, rounds,
    flags, progress, tier rounds) and every host-read count is bitwise the
    telemetry-off run's, on every engine and driver, for batches, nodes,
    the solver and the service;
  * the snapshots are the reference's: capacity, rounds recorded, the
    stop, infeasibility and tier-switch rounds, the history's length and
    its NaNs equal; the history within 1e-12 relative at float64 and 16
    float32 epsilons at float32 (the two packages sum the measure in
    different orders); the solver's ring (frontier widths) equal outright;
  * ``donate=`` is accepted and changes nothing.

The reference's float32 ``propagate_block_ell`` merges without widening
(ROADMAP Queue 3, reference notes), so the port's float32 snapshots are held
against the reference's ``propagate`` (whose plain round widens, as the
port's engines do).
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as rc
import repro.data as rd
import repro.kernels as rk
import repro.obs as ro
import repro_torch as rt
from repro_torch import obs as tobs
from repro_torch.core import carry as tcarry
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

CAP = 16
F32_EPS = float(np.finfo(np.float32).eps)
FIELDS = ("lb", "ub", "rounds", "converged", "infeasible", "progress", "tier_rounds")
SRC = Path(__file__).resolve().parent.parent / "src"


def contraction_chain(n: int = 32, rho: float = 0.9):
    """The reference's ring-truncation workload (tests/test_obs.py:44-58):
    a cyclic contraction whose geometric tail takes many more rounds than
    the ring holds."""
    dense = np.zeros((n, n))
    for j in range(n):
        dense[j, j] = 1.0
        dense[j, (j + 1) % n] = -rho
    return rc.Problem(
        csr=rc.csr_from_dense(dense), lhs=np.full(n, -rc.INF), rhs=np.zeros(n),
        lb=np.zeros(n), ub=np.ones(n), is_int=np.zeros(n, dtype=bool),
    )


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(a, b, fields=FIELDS):
    """Bitwise equal fields (NaNs in the same places)."""
    for f in fields:
        x, y = _np(getattr(a, f)), _np(getattr(b, f))
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert x.tobytes() == y.tobytes(), f


def _counted(fn, **kw):
    """``fn(**kw, on_sync=...)`` and its host-read count."""
    reads = []
    out = fn(**kw, on_sync=lambda: reads.append(1))
    return out, len(reads)


def _assert_snapshot(got, want, dtype=np.float64, name=""):
    """The port's snapshot against the reference's (module docstring)."""
    for f in ("capacity", "rounds_recorded", "stop_round", "infeasible_round",
              "tier_switch_round"):
        assert getattr(got, f) == getattr(want, f), (name, f)
    g, w = got.progress_history(), np.asarray(want.progress_history())
    assert g.shape == w.shape, name
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=name)
    tol = 1e-12 if dtype == np.float64 else 16 * F32_EPS
    np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64), rtol=tol, atol=tol,
                               equal_nan=True, err_msg=name)
    assert (got.fp32 is None) == (want.fp32 is None), name
    if got.fp32 is not None:
        _assert_snapshot(got.fp32, want.fp32, np.float32, name + " fp32")


def _port(pr):
    return rt.problem_from_reference(pr)


# ---------------------------------------------------------------------------
# propagate_block_ell: every engine and driver, bitwise and against the
# reference's snapshots
# ---------------------------------------------------------------------------

# (name, reference problem, tile width, engine options); the segment
# engine is the port's own (the reference's plain engines agree with it).
BLOCK_CASES = {
    "mixed": (lambda: rd.make_mixed(m=80, n=60, seed=0), 8, {}),
    "cascade": (lambda: rd.make_cascade_chain(length=16), 16, {}),
    "partitioned": (lambda: rd.make_knapsack(300, 40, seed=1), 16,
                    dict(scatter="partitioned", slab=128)),
    "mixed_partitioned": (lambda: rd.make_mixed(m=80, n=60, seed=0), 8,
                          dict(scatter="partitioned", slab=128)),
    "cascade_segment": (lambda: rd.make_cascade_chain(length=16), 16, dict(scatter="segment")),
    "infeasible": (lambda: rd.make_pseudo_boolean(n=60, m=90, seed=5, unit_frac=0.2), 16, {}),
}


@pytest.mark.parametrize("driver", ["host_loop", "device_loop"])
@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_block_ell_bitwise_and_snapshot(case, driver):
    """The twin of ``test_fused_bitwise_and_snapshot`` and
    ``test_partitioned_bitwise``, on every engine and both drivers, with
    an instance that goes infeasible.  The device loop's snapshot is held
    against the reference's; the host loop's, built on the host from the
    carry, equals it outright (both take the merge's measure)."""
    make, tw, kw = BLOCK_CASES[case]
    pr = make()
    p = _port(pr)
    fn = lambda driver=driver, **k: rt.propagate_block_ell(
        p, tile_width=tw, driver=driver, device="cpu", **kw, **k)
    off, reads_off = _counted(fn)
    on, reads_on = _counted(fn, telemetry=CAP)
    _same(off, on)
    assert reads_off == reads_on
    assert off.telemetry is None
    t = on.telemetry
    assert t.capacity == CAP and t.rounds_recorded == int(on.rounds)
    if driver == "host_loop":
        want = fn(driver="device_loop", telemetry=CAP).telemetry
        _assert_snapshot(t, want, name=case)
        np.testing.assert_array_equal(t.progress_history(), want.progress_history())
    else:
        ref_kw = {k: v for k, v in kw.items() if k != "scatter" or v != "segment"}
        want = rk.propagate_block_ell(pr, tile_width=tw, use_pallas=False, telemetry=CAP,
                                      **ref_kw)
        assert int(want.rounds) == int(on.rounds)
        _assert_snapshot(t, want.telemetry, name=case)
    if case == "infeasible":
        assert bool(on.infeasible) and t.infeasible_round >= 2


@pytest.mark.parametrize("driver", ["host_loop", "device_loop"])
def test_early_stop_round_matches_reference(driver):
    """The early stop's ``stop_round``: F's stop form latched by the record
    (device loop) or read with the carry (host loop)."""
    pr = rd.make_mixed(m=80, n=60, seed=0)
    p = _port(pr)
    kw = dict(tile_width=8, driver=driver, stop_progress=0.5, patience=1)
    off = rt.propagate_block_ell(p, device="cpu", **kw)
    on = rt.propagate_block_ell(p, device="cpu", telemetry=CAP, **kw)
    _same(off, on)
    want = rk.propagate_block_ell(pr, use_pallas=False, telemetry=CAP, **kw)
    assert on.telemetry.stop_round == int(on.rounds) >= 1
    _assert_snapshot(on.telemetry, want.telemetry)


@pytest.mark.parametrize("engine", ["fused", "partitioned"])
def test_float32_snapshot_against_reference_propagate(engine):
    """Float32 snapshots against the reference's ``propagate`` (the plain
    round, which widens as the port's engines do)."""
    pr = rd.make_cascade_chain(length=16)
    p = _port(pr)
    kw = dict(dtype=np.float32, tile_width=16)
    if engine == "partitioned":
        kw.update(scatter="partitioned", slab=128)
    off = rt.propagate_block_ell(p, device="cpu", **kw)
    on = rt.propagate_block_ell(p, device="cpu", telemetry=CAP, **kw)
    _same(off, on)
    assert on.telemetry.plane.ring.dtype == torch.float32
    want = rc.propagate(pr, dtype=np.float32, telemetry=CAP)
    assert int(want.rounds) == int(on.rounds)
    _assert_snapshot(on.telemetry, want.telemetry, np.float32)


def test_float32_history_against_reference_round_loop():
    """The float32 history against the reference's ``round_fn_for``
    (``use_pallas=False``) driven in a loop, each round's measure taken by
    its ``progress_measure``."""
    pr = rd.make_mixed(m=80, n=60, seed=0)
    got = rt.propagate_block_ell(_port(pr), dtype=np.float32, tile_width=8, telemetry=CAP,
                                 device="cpu")
    prep = rk.prepare_block_ell(pr, 8, 8, np.float32)
    round_fn = rk.round_fn_for(prep, use_pallas=False)

    @jax.jit
    def step(lb, ub):
        nlb, nub, ch = round_fn(lb, ub)
        return nlb, nub, ch, rc.bounds.progress_measure(lb, ub, nlb, nub)

    lb, ub = prep.lb0, prep.ub0
    hist = []
    for _ in range(100):
        nlb, nub, ch, prog = step(lb, ub)
        hist.append(float(prog))
        lb, ub = nlb, nub
        if not bool(ch):
            break
    g = got.telemetry.progress_history()
    assert len(g) == len(hist) == int(got.rounds)
    np.testing.assert_allclose(g, np.asarray(hist, np.float32), rtol=16 * F32_EPS,
                               atol=16 * F32_EPS)


def test_two_tier_snapshot_chain():
    """The twin of ``test_two_tier_snapshot_chain``: the endgame's snapshot
    with the tier's nested, on ``propagate`` and the kernel engine."""
    pr = rd.make_knapsack(80, 20, seed=2)
    p = _port(pr)
    want = rc.propagate(pr, policy=rc.TierPolicy(), telemetry=CAP)
    for fn in (rt.propagate, rt.propagate_block_ell):
        off = fn(p, policy=rt.core.TierPolicy(), device="cpu")
        on = fn(p, policy=rt.core.TierPolicy(), telemetry=CAP, device="cpu")
        _same(off, on)
        t = on.telemetry
        assert int(on.tier_rounds) == int(want.tier_rounds)
        if int(on.tier_rounds) > 0:
            assert t.tier_switch_round == int(on.tier_rounds)
            assert t.fp32.rounds_recorded == int(on.tier_rounds)
        _assert_snapshot(t, want.telemetry, name=fn.__name__)


@pytest.mark.parametrize("driver", ["host_loop", "device_loop", "unrolled"])
def test_propagate_drivers_bitwise_and_snapshot(driver):
    """``propagate`` (the plain round, its record in torch ops) on each
    driver, against the reference's: ``unrolled`` records one sample per
    check group of four rounds."""
    pr = rd.make_cascade_chain(length=16)
    off, reads_off = _counted(rt.propagate, p=_port(pr), driver=driver, device="cpu")
    on, reads_on = _counted(rt.propagate, p=_port(pr), driver=driver, device="cpu",
                            telemetry=CAP)
    _same(off, on)
    assert reads_off == reads_on
    want = rc.propagate(pr, driver=driver, telemetry=CAP)
    _assert_snapshot(on.telemetry, want.telemetry, name=driver)


@pytest.mark.parametrize("fn", ["propagate_host_loop", "propagate_device_loop",
                                "propagate_unrolled"])
def test_named_drivers_take_telemetry(fn):
    """The named drivers on a ``DeviceProblem``: bitwise telemetry off, and
    the snapshot ``propagate`` gives on the same driver (held to the
    reference's above)."""
    p = _port(rd.make_mixed(m=80, n=60, seed=0))
    dp = rt.core.DeviceProblem(p, device="cpu")
    off = getattr(rt.core, fn)(dp)
    on = getattr(rt.core, fn)(dp, telemetry=CAP)
    _same(off, on)
    driver = fn.removeprefix("propagate_")
    want = rt.propagate(p, driver=driver, telemetry=CAP, device="cpu").telemetry
    _assert_snapshot(on.telemetry, want, name=fn)
    np.testing.assert_array_equal(on.telemetry.progress_history(), want.progress_history())


# ---------------------------------------------------------------------------
# Ring truncation, host and device agreement
# ---------------------------------------------------------------------------


def test_ring_truncation_keeps_tail():
    """The twin of ``test_ring_truncation_keeps_tail``: the contraction
    chain at ``telemetry=8`` keeps the last 8 rounds, host_loop and
    device_loop give the same ring, on ``propagate`` and on the kernel
    engine, and both match the reference's."""
    pr = contraction_chain()
    p = _port(pr)
    want = rc.propagate(pr, telemetry=8).telemetry
    rings = {}
    for name, fn in (("propagate", rt.propagate), ("block_ell", rt.propagate_block_ell)):
        for driver in ("host_loop", "device_loop"):
            r = fn(p, driver=driver, telemetry=8, device="cpu")
            t = r.telemetry
            assert t.rounds_recorded == int(r.rounds) > 8
            hist = t.progress_history()
            assert hist.shape == (8,)
            assert np.all(np.diff(hist) <= 1e-12)
            rings[name, driver] = hist
            _assert_snapshot(t, want, name=f"{name} {driver}")
        np.testing.assert_array_equal(rings[name, "host_loop"], rings[name, "device_loop"])


def test_host_snapshot_matches_device_wrap():
    history = [2.0 ** -i for i in range(11)]
    snap = tobs.host_snapshot(history, capacity=4)
    want = ro.host_snapshot(history, capacity=4)
    assert snap.rounds_recorded == want.rounds_recorded == 11
    np.testing.assert_array_equal(snap.progress_history(), want.progress_history())
    np.testing.assert_allclose(snap.progress_history(), history[-4:])


# ---------------------------------------------------------------------------
# The plane's semantics and the record kernels' plain versions
# ---------------------------------------------------------------------------


def test_infeasible_round_latches_first():
    plane = tobs.device_plane(4, device="cpu")
    plane = tobs.record_round(plane, 0.5, 1, False)
    plane = tobs.record_round(plane, 0.4, 2, True)
    plane = tobs.record_round(plane, 0.3, 3, True)
    assert int(plane.infeas_round) == 2
    assert int(plane.ticks) == 3


def test_batched_record_respects_active_mask():
    plane = tobs.device_plane(4, batch=2, device="cpu")
    plane = tobs.record_round(plane, torch.tensor([0.5, 0.7]), torch.tensor([1, 1]),
                              torch.tensor([False, False]), active=torch.tensor([True, False]))
    assert plane.ticks.tolist() == [1, 0]
    assert torch.isnan(plane.ring[1]).all()
    plane = tobs.reset_rows(plane, torch.tensor([0]))
    assert plane.ticks.tolist() == [0, 0]
    assert torch.isnan(plane.ring).all()


def _ref_plane(plane):
    return ro.TelemetryPlane(*(jnp.asarray(_np(t)) for t in plane))


def _assert_planes(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_record_round_matches_reference_across_wrap_and_latches(dtype):
    """``obs.telemetry.record_round`` against the reference's, scalar and
    batched, across a wrap, with masks and both latches."""
    gen = np.random.default_rng(0)
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    plane = tobs.device_plane(3, dtype=dtype, device="cpu")
    want = ro.device_plane(3, dtype=np_dt)
    bplane = tobs.device_plane(3, batch=4, dtype=dtype, device="cpu")
    bwant = ro.device_plane(3, batch=4, dtype=np_dt)
    for r in range(1, 6):
        prog, hit, stop = float(gen.random()), r >= 3, r >= 4
        plane = tobs.record_round(plane, prog, r, hit, stop)
        want = ro.record_round(want, prog, r, jnp.asarray(hit), jnp.asarray(stop))
        _assert_planes(plane, want)
        progs = gen.random(4).astype(np_dt)
        act, hits, stops = gen.random(4) < 0.7, gen.random(4) < 0.3, gen.random(4) < 0.3
        rounds = np.full(4, r, np.int32)
        bplane = tobs.record_round(bplane, torch.as_tensor(progs), torch.as_tensor(rounds),
                                   torch.as_tensor(hits), torch.as_tensor(stops),
                                   active=torch.as_tensor(act))
        bwant = ro.record_round(bwant, jnp.asarray(progs), jnp.asarray(rounds),
                                jnp.asarray(hits), jnp.asarray(stops), active=jnp.asarray(act))
        _assert_planes(bplane, bwant)
    assert int(plane.ticks) == 5 and int(plane.infeas_round) == 3 and int(plane.stop_round) == 4
    rows = torch.tensor([1, 3])
    _assert_planes(tobs.reset_rows(bplane, rows), ro.reset_rows(bwant, jnp.asarray([1, 3])))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_record_kernel_plain_versions(dtype):
    """The record kernels' plain versions (what the wrappers run on a CPU
    tensor) against ``obs.telemetry.record_round``: the carry's measure at
    its ticks, gated on ``ROUNDS``, both latches, a wrap; the host loop's
    probe into the carry; and the batched form with a mask."""
    tk = rt.kernels
    n = 37
    lb = torch.zeros(n, dtype=dtype)
    ub = torch.ones(n, dtype=dtype)
    carry = tcarry.armed_state("cpu")
    plane = tobs.device_plane(3, dtype=dtype, device="cpu")
    want = tobs.device_plane(3, dtype=dtype, device="cpu")
    prog_slot = tcarry.progress_view(carry, dtype)
    for r in range(1, 8):
        carry[tcarry.ROUNDS] = r
        carry[tcarry.FLAT] = r - 4  # reaches patience 2 at round 6
        prog_slot.fill_(0.25 * r)
        if r == 5:
            ub[7] = -1.0  # the bounds cross from round 5 on
        tk.record_round_tiles(lb, ub, carry, plane, 1e-6, patience=2)
        want = tobs.record_round(want, 0.25 * r, r, r >= 5, r - 4 >= 2)
        _assert_planes(plane, want)
        # A group enqueued after GO cleared (ROUNDS unchanged) records nothing.
        tk.record_round_tiles(lb, ub, carry, plane, 1e-6, patience=2)
        _assert_planes(plane, want)
    assert int(plane.infeas_round) == 5 and int(plane.stop_round) == 6
    # No stop armed: the stop latch stays -1.
    quiet = tobs.device_plane(3, dtype=dtype, device="cpu")
    tk.record_round_tiles(lb, ub, carry, quiet, 1e-6)
    assert int(quiet.stop_round) == -1 and int(quiet.infeas_round) == 7
    # The host loop's probe goes into the carry's CROSS field.
    tk.record_round_tiles(lb, ub, carry, None, 1e-6)
    assert int(carry[tcarry.CROSS]) == 1
    ub[7] = 1.0
    tk.record_round_tiles(lb, ub, carry, None, 1e-6)
    assert int(carry[tcarry.CROSS]) == 0
    # Batched: four rows, a mask, both latches.
    gen = np.random.default_rng(1)
    bsz = 4
    blb, bub = torch.zeros(bsz, n, dtype=dtype), torch.ones(bsz, n, dtype=dtype)
    bub[2, 5] = -1.0
    bplane = tobs.device_plane(3, batch=bsz, dtype=dtype, device="cpu")
    bwant = tobs.device_plane(3, batch=bsz, dtype=dtype, device="cpu")
    rounds = torch.zeros(bsz, dtype=torch.int32)
    for r in range(1, 6):
        ran = torch.as_tensor(gen.random(bsz) < 0.75)
        rounds = rounds + ran.to(torch.int32)
        flat = torch.as_tensor(gen.integers(0, 3, bsz), dtype=torch.int32)
        prog = torch.as_tensor(gen.random(bsz), dtype=dtype)
        tk.record_round_batch_tiles(blb, bub, prog, ran, rounds, flat, bplane, 1e-6, patience=2)
        bwant = tobs.record_round(bwant, prog, rounds, tref.crossed(blb, bub, 1e-6), flat >= 2,
                                  active=ran)
        _assert_planes(bplane, bwant)


# ---------------------------------------------------------------------------
# Batches and nodes
# ---------------------------------------------------------------------------


def _batch():
    return [rd.make_set_cover(40, 20, seed=s) for s in range(3)] + [
        rd.make_knapsack(40, 10, seed=s) for s in range(3)] + [rd.make_cascade_chain(length=16)]


@pytest.mark.parametrize("driver", ["device_loop", "host_loop"])
@pytest.mark.parametrize("mode", ["plain", "stop", "tier", "f32"])
def test_batched_bitwise_per_instance_snapshots(driver, mode):
    """The twin of ``test_batched_bitwise_per_instance_snapshots`` and
    ``test_batched_host_loop_bitwise``: per-instance snapshots, rows of one
    plane per bucket, with the early stop, two tiers and float32."""
    probs = _batch()
    kw = {"plain": {}, "stop": dict(stop_progress=0.5), "f32": dict(dtype=np.float32),
          "tier": dict(policy="tier")}[mode]
    port_kw, ref_kw = dict(kw), dict(kw)
    if mode == "tier":
        port_kw["policy"], ref_kw["policy"] = rt.core.TierPolicy(), rc.TierPolicy()
    ported = [_port(p) for p in probs]
    fn = lambda driver=driver, **k: rt.propagate_batch(ported, device="cpu", driver=driver,
                                                       **port_kw, **k)
    off, reads_off = _counted(fn)
    on, reads_on = _counted(fn, telemetry=CAP)
    assert reads_off == reads_on
    if driver == "host_loop":  # the port's batches run one loop for both drivers
        want = fn(driver="device_loop", telemetry=CAP)
    else:
        want = rc.propagate_batch(probs, use_pallas=False, telemetry=CAP, **ref_kw)
    dt = np.float32 if mode == "f32" else np.float64
    for i, (a, b, w) in enumerate(zip(off, on, want)):
        _same(a, b)
        assert a.telemetry is None
        assert b.telemetry.rounds_recorded == len(b.telemetry.progress_history()) or (
            b.telemetry.rounds_recorded > CAP)
        _assert_snapshot(b.telemetry, w.telemetry, dt, name=f"{mode} {i}")


@pytest.mark.parametrize("mode", ["plain", "stop", "tier"])
def test_nodes_bitwise(mode):
    """The twin of ``test_nodes_bitwise``, a node whose domain crosses
    included, against the reference's node snapshots (on an exact-data
    family: the two tiers' endgames start from bitwise equal promotions)."""
    pr = rd.make_cascade_chain(length=16)
    lb = np.repeat(np.asarray(pr.lb, np.float64)[None, :], 4, axis=0)
    ub = np.repeat(np.asarray(pr.ub, np.float64)[None, :], 4, axis=0)
    ub[1, 3] = lb[1, 3] - 5.0
    kw = {"plain": {}, "stop": dict(stop_progress=0.5), "tier": {}}[mode]
    port_kw, ref_kw = dict(kw), dict(kw)
    if mode == "tier":
        port_kw["policy"], ref_kw["policy"] = rt.core.TierPolicy(), rc.TierPolicy()
    p = _port(pr)
    fn = lambda **k: rt.propagate_nodes(p, lb, ub, tile_width=16, device="cpu", **port_kw, **k)
    off, reads_off = _counted(fn)
    on, reads_on = _counted(fn, telemetry=CAP)
    assert reads_off == reads_on
    for f in ("lb", "ub", "rounds", "converged", "infeasible", "progress", "tier_rounds"):
        assert _np(getattr(off, f)).tobytes() == _np(getattr(on, f)).tobytes(), f
    assert off.node_telemetry(0) is None
    want = rc.propagate_nodes(pr, lb, ub, tile_width=16, use_pallas=False, telemetry=CAP,
                              **ref_kw)
    for i in range(4):
        snap = on.node_telemetry(i)
        assert snap.rounds_recorded == int(on.rounds[i]) - (
            int(on.tier_rounds[i]) if mode == "tier" else 0)
        assert on.result(i).telemetry.rounds_recorded == snap.rounds_recorded
        _assert_snapshot(snap, want.node_telemetry(i), name=f"node {i}")
    assert on.node_telemetry(1).infeasible_round == 1


# ---------------------------------------------------------------------------
# The solver and the service
# ---------------------------------------------------------------------------


def _objective(n):
    return np.arange(1, n + 1) * np.where(np.arange(n) % 3 == 0, -1.0, 1.0)


def test_solve_telemetry_matches_reference():
    """One sample per level: the frontier widths equal outright, the first
    incumbent and fathom levels equal, the search unchanged."""
    pr = rd.make_pseudo_boolean(n=12, m=16, seed=0)
    p = _port(pr)
    c = _objective(p.n)
    off = rt.solve(p, c, device="cpu")
    on = rt.solve(p, c, telemetry=CAP, device="cpu")
    for f in ("status", "objective", "nodes_expanded", "nodes_created", "leaves",
              "pruned_bound", "pruned_infeasible", "levels", "host_syncs",
              "incumbent_trajectory"):
        assert getattr(off, f) == getattr(on, f), f
    assert off.telemetry is None
    want = rc.solve(pr, c, telemetry=CAP, use_pallas=False)
    t, w = on.telemetry, want.telemetry
    for f in ("capacity", "rounds_recorded", "stop_round", "infeasible_round"):
        assert getattr(t, f) == getattr(w, f), f
    np.testing.assert_array_equal(t.progress_history(), np.asarray(w.progress_history()))
    assert t.rounds_recorded == on.levels


def test_service_bitwise_compiles_and_snapshots():
    """The twin of ``test_service_bitwise_compiles_and_snapshots``: every
    retired ticket bitwise, its snapshot a host copy that survives slot
    recycling and matches the reference's, the reads and the engine builds
    unchanged."""
    probs = _batch()
    specs = rt.core.BucketSpec.for_problems([_port(p) for p in probs], slots=2)
    reads = [[], []]
    svc_off = rt.PropagationService(specs, device="cpu", on_sync=lambda: reads[0].append(1))
    svc_on = rt.PropagationService(specs, device="cpu", telemetry=CAP,
                                   on_sync=lambda: reads[1].append(1))
    res_off = svc_off.serve([_port(p) for p in probs])
    res_on = svc_on.serve([_port(p) for p in probs])
    assert len(reads[0]) == len(reads[1])
    ref_specs = rc.BucketSpec.for_problems(probs, slots=2)
    want = rc.PropagationService(ref_specs, use_pallas=False, telemetry=CAP).serve(probs)
    for i, (a, b, w) in enumerate(zip(res_off, res_on, want)):
        _same(a, b)
        assert a.telemetry is None
        assert b.telemetry.rounds_recorded == int(b.rounds)
        assert isinstance(b.telemetry.plane.ring, torch.Tensor)
        assert b.telemetry.plane.ring.device.type == "cpu"
        _assert_snapshot(b.telemetry, w.telemetry, name=f"ticket {i}")
    counts = svc_on.compile_counts()
    assert counts == svc_off.compile_counts()
    svc_on.serve([_port(p) for p in probs])
    assert svc_on.compile_counts() == counts
    # As the reference's: the capacity is the registry's service counter.
    assert svc_on.stats()["metrics"]["sources"]["service"]["telemetry_capacity"] == CAP
    assert svc_off.stats()["metrics"]["sources"]["service"]["telemetry_capacity"] == 0


def test_service_tracer_spans_with_telemetry():
    """The twin of ``test_service_tracer_spans`` (telemetry on)."""
    probs = [_port(rd.make_set_cover(40, 20, seed=s)) for s in range(3)]
    tr = tobs.Tracer()
    svc = rt.PropagationService.from_problems(probs, slots=2, device="cpu", telemetry=CAP,
                                              tracer=tr)
    out = svc.serve(probs)
    assert all(r.telemetry.rounds_recorded == int(r.rounds) for r in out)
    names = {s.name for s in tr.spans()}
    assert {"pump", "admit", "step", "readback", "ticket"} <= names


# ---------------------------------------------------------------------------
# donate=
# ---------------------------------------------------------------------------


def test_repeated_propagation_with_donation_is_stable():
    """The twin of ``tests/test_fused_scatter.py::
    test_repeated_propagation_with_donation_is_stable``: donated runs never
    touch the cached initial bounds, so two give identical results."""
    p = _port(rd.make_set_cover(n=30, m=10, seed=8))
    kw = dict(tile_rows=4, tile_width=32, scatter="fused", donate=True, driver="host_loop",
              device="cpu")
    prep = tops.prepare_block_ell(p, 4, 32, device="cpu")
    lb0, ub0 = prep.lb0.clone(), prep.ub0.clone()
    r1 = rt.propagate_block_ell(p, **kw)
    r2 = rt.propagate_block_ell(p, **kw)
    _same(r1, r2)
    assert torch.equal(prep.lb0, lb0) and torch.equal(prep.ub0, ub0)
    _same(r1, rt.propagate_block_ell(p, **{**kw, "donate": None}))


@pytest.mark.parametrize("entry", ["propagate_batch", "propagate_nodes", "batched_device_runner",
                                   "propagate_batch_prepared", "node_batch_runner",
                                   "propagate_nodes_prepared", "propagate_batch_block_ell"])
def test_donate_changes_nothing(entry):
    probs = [_port(rd.make_mixed(m=80, n=60, seed=s)) for s in range(2)]
    p = probs[0]
    lb = np.repeat(np.asarray(p.lb)[None], 2, axis=0)
    ub = np.repeat(np.asarray(p.ub)[None], 2, axis=0)

    def run(donate):
        if entry == "propagate_batch":
            return rt.propagate_batch(probs, tile_width=8, donate=donate, device="cpu")
        if entry == "propagate_batch_block_ell":
            return tops.propagate_batch_block_ell(probs, tile_width=8, donate=donate,
                                                  device="cpu")
        if entry == "propagate_nodes":
            return [rt.propagate_nodes(p, lb, ub, tile_width=8, donate=donate,
                                       device="cpu").result(i) for i in range(2)]
        if entry in ("batched_device_runner", "propagate_batch_prepared"):
            (batch,) = tops.packed_problems(probs, tile_width=8)
            prep = tops.prepare_problem_batch(batch, device="cpu")
            if entry == "propagate_batch_prepared":
                return tops.propagate_batch_prepared(prep, donate=donate)
            out = tops.batched_device_runner(prep, donate=donate)(prep.d.lb0.clone(),
                                                                  prep.d.ub0.clone())
            return [rt.core.PropagationResult(*(x[i] for x in out), torch.tensor(0))
                    for i in range(2)]
        prep = tops.prepare_block_ell(p, tile_width=8, device="cpu")
        if entry == "propagate_nodes_prepared":
            out = tops.propagate_nodes_prepared(prep, lb, ub, donate=donate, with_progress=True)
        else:
            planes = tops._node_planes(prep, lb, ub)
            out = tops.node_batch_runner(prep, 2, donate=donate)(*planes)
        return [rt.core.PropagationResult(*(x[i] for x in out[:5]), out[5][i] if len(out) > 5
                                          else torch.tensor(0.0), torch.tensor(0))
                for i in range(2)]

    for a, b in zip(run(None), run(True)):
        _same(a, b, FIELDS[:5])


# ---------------------------------------------------------------------------
# Timing, run metadata, exports, isolation
# ---------------------------------------------------------------------------


def test_run_metadata_shape():
    meta = tobs.run_metadata()
    assert set(meta) == {"git_commit", "timestamp", "torch_version", "cuda_version", "backend",
                         "device", "power_limit"}
    assert meta["git_commit"] != "" and meta["torch_version"] == torch.__version__
    assert meta["backend"] == ("cuda" if torch.cuda.is_available() else "cpu")
    assert all(isinstance(v, str) and v for v in meta.values())


def test_timing_utilities():
    xs = torch.arange(1024.0)
    t = tobs.time_fenced(lambda: xs * 2.0, repeats=2)
    assert 0.0 < t < 10.0
    trials = tobs.paired_trials([lambda: xs + 1.0, lambda: xs + 2.0], trials=3, repeats=2)
    assert len(trials) == 3 and all(len(row) == 2 for row in trials)
    assert tobs.median_ratio(trials) > 0.0
    assert tobs.median_of(trials, 0) > 0.0
    tr = tobs.Tracer()
    phases = tobs.time_phases({"a": lambda: xs * 3.0, "b": lambda: xs * 4.0}, repeats=1,
                              tracer=tr)
    assert set(phases) == {"a", "b"} and all(v > 0.0 for v in phases.values())
    assert {s.name for s in tr.spans()} == {"phase:a", "phase:b"}
    nested = {"a": (xs, [xs]), "b": rt.core.PropagationResult(*([xs] * 7))}
    assert tobs.fence(nested) is nested


def test_obs_exports_match_reference():
    assert sorted(tobs.__all__) == sorted(ro.__all__)
    assert tobs.DEFAULT_CAPACITY == ro.DEFAULT_CAPACITY
    assert list(rt.core.PropagationResult._fields) == list(rc.PropagationResult._fields)
    assert {"record_round_tiles", "record_round_batch_tiles"} <= set(rt.kernels.__all__)


def test_obs_imports_no_jax():
    code = (
        "import sys\n"
        "import repro_torch.obs, repro_torch.obs.telemetry, repro_torch.obs.timing\n"
        "repro_torch.obs.run_metadata()\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
