"""The port's continuous-batching service (``repro_torch.PropagationService``,
on the CPU) and its slot packing against the reference's, on the cases of
the reference's own service tests.

The guarantees held here:
  * ``pack_into_slot``/``evict_slot`` are byte-identical to the reference's,
    and ``BucketSpec.for_problems`` derives the same specs;
  * admit -> converge -> retire -> backfill leaves every instance bitwise
    equal to the port's one-shot ``propagate_batch`` of the same instance
    with the same tile parameters, ``progress`` included, on any data (the
    port's rounds sum in one fixed order); against the reference's one-shot
    bitwise on the integer-valued families and to ``rtol=1e-12,
    atol=1e-12`` on ``make_mixed``, with ``rounds``, ``converged`` and
    ``infeasible`` exact everywhere;
  * ``batched_step_rounds`` chunked by any budget reproduces the one-call
    fixed point bitwise, ``progress`` included;
  * engine builds and kernel-library builds stay constant across
    backfills; retire and backfill happen while a slow instance is
    resident; ``stats()`` has the reference's keys.
"""
import dataclasses
import json
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as rc
import repro.data as rd
import repro_torch as rt
from repro_torch.core import INF, BucketSpec, PropagationService, evict_slot, pack_into_slot
from repro_torch.kernels import ops as tops
from repro_torch.obs import SNAPSHOT_KEYS, SPAN_KEYS, MetricsRegistry, Tracer

SET_COVERS = [rd.make_set_cover(n=60, m=20, seed=s) for s in range(6)]
T_SET_COVERS = [rt.problem_from_reference(p) for p in SET_COVERS]


def _port(problems):
    return [rt.problem_from_reference(p) for p in problems]


def _one_shot(p, tile_width, use_kernels=True):
    """The fixed-batch path the service must reproduce, on the port."""
    return rt.propagate_batch([p], tile_rows=8, tile_width=tile_width,
                              use_kernels=use_kernels, device="cpu")[0]


def _ref_one_shot(p, tile_width):
    return rc.propagate_batch([p], tile_rows=8, tile_width=tile_width, use_pallas=False)[0]


def _assert_bitwise(r, one):
    for f in ("lb", "ub", "rounds", "converged", "infeasible", "progress"):
        np.testing.assert_array_equal(getattr(r, f).numpy(), getattr(one, f).numpy(),
                                      err_msg=f)


def _assert_reference(r, want, exact):
    for f in ("rounds", "converged", "infeasible"):
        assert int(getattr(r, f)) == int(np.asarray(getattr(want, f))), f
    for a, b in ((r.lb, want.lb), (r.ub, want.ub)):
        if exact:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(r.progress.numpy(), np.asarray(want.progress), rtol=1e-12,
                               equal_nan=True)


@pytest.fixture(scope="module")
def sc_service():
    """Two-slot multi-chunk bucket (tile width 8 < longest set-cover row):
    six instances through two slots force retire -> backfill."""
    return PropagationService.from_problems(T_SET_COVERS, slots=2, tile_width=8, device="cpu")


# ---------------------------------------------------------------------------
# Slot packing and bucket specs
# ---------------------------------------------------------------------------


def _assert_payload_equal(got, want):
    for f in want._fields:
        a, b = getattr(got, f), getattr(want, f)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, f
            assert a.tobytes() == b.tobytes(), f
        else:
            assert a == b, f
    assert got.fill() == want.fill()


@pytest.mark.parametrize("gen,kw,shape", [
    ("make_set_cover", dict(n=60, m=20, seed=0), dict(slot_tiles=12, slot_rows=30, n_pad=128,
                                                       tile_width=8)),
    ("make_knapsack", dict(n=60, m=20, seed=3), dict(slot_tiles=4, slot_rows=20, n_pad=128)),
    ("make_mixed", dict(m=60, n=50, seed=1), dict(slot_tiles=40, slot_rows=70, n_pad=256,
                                                   tile_rows=4, tile_width=16)),
])
def test_pack_into_slot_is_byte_identical(gen, kw, shape):
    p = getattr(rd, gen)(**kw)
    got = pack_into_slot(rt.problem_from_reference(p), **shape)
    _assert_payload_equal(got, rc.pack_into_slot(p, **shape))
    tail = slice(got.tiles_used, None)
    assert (got.val[tail] == 0).all() and (got.chunk_row[tail] == p.m).all()
    assert (got.ii[got.val == 0] == 0).all()
    assert (got.lb[p.n:] == 0).all() and (got.ub[p.n:] == 0).all()


def test_pack_into_slot_refuses_what_does_not_fit():
    p = T_SET_COVERS[0]
    with pytest.raises(ValueError):
        pack_into_slot(p, slot_tiles=1, slot_rows=30, n_pad=128, tile_width=8)
    with pytest.raises(ValueError):
        pack_into_slot(p, slot_tiles=12, slot_rows=5, n_pad=128, tile_width=8)
    with pytest.raises(ValueError):
        pack_into_slot(p, slot_tiles=12, slot_rows=30, n_pad=32, tile_width=8)


def test_evict_slot_is_byte_identical():
    got = evict_slot(slot_tiles=3, slot_rows=10, n_pad=128, tile_width=8)
    _assert_payload_equal(got, rc.evict_slot(slot_tiles=3, slot_rows=10, n_pad=128,
                                             tile_width=8))
    assert (got.val == 0).all() and got.nnz == 0 and (got.chunk_row == 10).all()


POPULATIONS = {
    "set_covers": (lambda: SET_COVERS, dict(slots=2, tile_width=8)),
    "free_width": (lambda: SET_COVERS[:3] + [rd.make_knapsack(n=60, m=20, seed=1)],
                   dict(slots=4)),
    "size_classes": (lambda: [rd.make_set_cover(n=60, m=20, seed=s) for s in range(3)]
                     + [rd.make_cascade_chain(length=100 + s) for s in range(3)],
                     dict(slots=2, tile_width=8, size_classes=2)),
    "two_widths": (lambda: [rd.make_mixed(m=60, n=50, seed=0), rd.make_mixed(m=40, n=200,
                                                                             seed=1)],
                   dict(slots=3, size_classes=3)),
}


@pytest.mark.parametrize("name", list(POPULATIONS))
def test_bucket_specs_equal_reference(name):
    make, kw = POPULATIONS[name]
    probs = make()
    want = rc.BucketSpec.for_problems(probs, **kw)
    got = BucketSpec.for_problems(_port(probs), **kw)
    assert [dataclasses.asdict(s) for s in got] == [dataclasses.asdict(s) for s in want]
    for p in _port(probs):
        assert any(s.fits_problem(p) for s in got)


def test_bucket_spec_routing():
    spec = BucketSpec(n_pad=128, slots=2, slot_tiles=8, slot_rows=25, tile_width=8,
                      fits_one_chunk=False)
    assert spec.fits_problem(T_SET_COVERS[0])
    assert not spec.fits_problem(rt.problem_from_reference(rd.make_mixed(m=120, n=100, seed=0)))
    assert not spec.fits_problem(rt.problem_from_reference(rd.make_mixed(m=20, n=200, seed=0)))
    pay = spec.pack(T_SET_COVERS[0])
    assert spec.admits(pay)
    other = pack_into_slot(T_SET_COVERS[0], slot_tiles=9, slot_rows=25, n_pad=128,
                           tile_width=8)
    assert not spec.admits(other)
    svc = PropagationService([spec], device="cpu")
    with pytest.raises(ValueError):
        svc.submit(rt.problem_from_reference(rd.make_mixed(m=120, n=100, seed=0)))
    with pytest.raises(ValueError):
        svc.submit(payload=other)


# ---------------------------------------------------------------------------
# The service step primitive
# ---------------------------------------------------------------------------


def _toy_round(lb, ub, active):
    new_ub = torch.maximum(lb, ub - 0.7)
    new_ub = torch.where(active[:, None], new_ub, ub)
    return lb, new_ub, (new_ub != ub).any(dim=-1)


def _chunked(round_fn, lb0, ub0, max_rounds, budget):
    bsz = lb0.shape[0]
    active = torch.ones(bsz, dtype=torch.bool)
    state = (lb0.clone(), ub0.clone(), active, active, torch.zeros(bsz, dtype=torch.int32))
    progress = flat = None
    calls = 0
    while bool(state[2].any()):
        out = rt.core.batched_step_rounds(round_fn, *state, max_rounds, budget=budget,
                                          progress=progress, flat=flat, with_progress=True)
        state, progress, flat = out[:5], out[5], out[6]
        calls += 1
    return state, progress, calls


@pytest.mark.parametrize("budget", [1, 2, 3])
@pytest.mark.parametrize("max_rounds", [100, 4])
def test_batched_step_rounds_chunked_matches_fixed_point(budget, max_rounds):
    """Chunking the fixed point by any budget cannot change the carried
    trajectory, ``progress`` of the retired rows included; a ``max_rounds``
    of 4 cuts a row mid-chunk (its progress is that of its last round)."""
    lb0 = torch.zeros((3, 4), dtype=torch.float64)
    ub0 = torch.tensor([[5.3] * 4, [1.1] * 4, [0.0] * 4], dtype=torch.float64)
    lb_f, ub_f, rounds_f, conv_f, prog_f = rt.core.batched_fixed_point(
        _toy_round, lb0.clone(), ub0.clone(), max_rounds, with_progress=True)
    state, progress, calls = _chunked(_toy_round, lb0, ub0, max_rounds, budget)
    assert calls >= -(-int(rounds_f.max()) // budget)
    for g, w in ((state[0], lb_f), (state[1], ub_f), (state[4], rounds_f), (~state[3], conv_f),
                 (progress, prog_f)):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    def ref_round(lb, ub, active):  # the reference test's round, in jnp
        new_ub = jnp.where(active[:, None], jnp.maximum(lb, ub - 0.7), ub)
        return lb, new_ub, jnp.any(new_ub != ub, axis=-1)

    want = rc.batched_fixed_point(ref_round, jnp.asarray(lb0.numpy()), jnp.asarray(ub0.numpy()),
                                  max_rounds, with_progress=True)
    np.testing.assert_array_equal(state[4].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(progress.numpy(), np.asarray(want[4]), rtol=1e-12)


@pytest.mark.parametrize("budget", [1, 2, 3])
def test_batched_step_rounds_chunked_on_the_batched_round(budget):
    """The same on the port's batched round over a real bucket (in-place
    kernel wrappers, general floats), with ``max_rounds`` cutting one
    instance."""
    probs = _port([rd.make_mixed(m=60, n=50, seed=s) for s in range(3)])
    (b,) = tops.packed_problems(probs, tile_width=8)
    prep = tops.prepare_problem_batch(b, device="cpu")
    round_fn = tops.batched_round_fn_for(prep)
    one = rt.core.batched_fixed_point(round_fn, prep.d.lb0.clone(), prep.d.ub0.clone(), 3,
                                      with_progress=True)
    assert int(one[2].max()) == 3 and not bool(one[3].all())  # a row was cut
    state, progress, _ = _chunked(round_fn, prep.d.lb0, prep.d.ub0, 3, budget)
    for g, w in ((state[0], one[0]), (state[1], one[1]), (state[4], one[2]),
                 (~state[3], one[3]), (progress, one[4])):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


# ---------------------------------------------------------------------------
# Lifecycle: admit -> converge -> retire -> backfill
# ---------------------------------------------------------------------------


def test_lifecycle_backfill_bitwise_multichunk(sc_service):
    """Six instances through two slots (A', combine, E, #9 with the
    combine's rows recomputed at each admission): every result, backfilled
    ones included, bitwise against the port's one-shot and the reference's."""
    before = sc_service.stats()["retired"]
    results = sc_service.serve(T_SET_COVERS)
    for p, tp, r in zip(SET_COVERS, T_SET_COVERS, results):
        _assert_bitwise(r, _one_shot(tp, 8))
        _assert_reference(r, _ref_one_shot(p, 8), exact=True)
    assert sc_service.stats()["retired"] == before + len(SET_COVERS)


@pytest.mark.parametrize("use_kernels", [True, False], ids=["kernels", "plain"])
def test_lifecycle_backfill_bitwise_fused(use_kernels):
    """The same contract through the fused bucket (#8 then #9)."""
    probs = [rd.make_knapsack(n=60, m=20, seed=s) for s in range(5)]
    ports = _port(probs)
    svc = PropagationService.from_problems(ports, slots=2, tile_width=128, device="cpu",
                                           use_kernels=use_kernels)
    assert svc._buckets[0].spec.fits_one_chunk
    for p, tp, r in zip(probs, ports, svc.serve(ports)):
        _assert_bitwise(r, _one_shot(tp, 128, use_kernels))
        _assert_reference(r, _ref_one_shot(p, 128), exact=True)


def test_lifecycle_general_floats():
    """General-float family: bitwise against the port's one-shot (one
    summation order), to ``rtol=1e-12`` against the reference's, with exact
    round trajectories and verdicts."""
    probs = [rd.make_mixed(m=60, n=50, seed=s) for s in range(4)]
    ports = _port(probs)
    svc = PropagationService.from_problems(ports, slots=2, tile_width=8, device="cpu")
    assert not svc._buckets[0].spec.fits_one_chunk
    for p, tp, r in zip(probs, ports, svc.serve(ports)):
        _assert_bitwise(r, _one_shot(tp, 8))
        _assert_reference(r, _ref_one_shot(p, 8), exact=False)


def _zero_run_problem(seed: int, n: int = 60, m: int = 6, long_row: int = 48):
    """Row 0 is long (``long_row`` nonzeros over tile width 8: six chunks)
    and holds 16 explicit zero coefficients in the middle, whole chunks 1
    and 2; the other rows are short.  Positive integer coefficients over
    negative lower bounds, ``x = lb`` feasible: the activities (and the
    candidates) depend on every chunk of the long row."""
    rng = np.random.default_rng(seed)
    rows, cols = [0] * long_row, list(range(long_row))
    a = rng.integers(1, 10, size=long_row).astype(np.float64)
    a[8:24] = 0.0
    vals = list(a)
    for i in range(1, m):
        rows += [i] * 5
        cols += list(rng.choice(n, size=5, replace=False))
        vals += list(rng.integers(1, 10, size=5).astype(np.float64))
    rows, cols, vals = np.array(rows), np.array(cols), np.array(vals, dtype=np.float64)
    csr = rc.csr_from_coo(rows, cols, vals, m, n)
    lb = rng.integers(-3, 0, size=n).astype(np.float64)
    ub = lb + rng.integers(4, 9, size=n)
    act = np.zeros(m)
    np.add.at(act, rows, vals * lb[cols])
    return rc.Problem(csr=csr, lhs=np.full(m, -INF), rhs=act + rng.integers(2, 6, size=m),
                      lb=lb, ub=ub, is_int=rng.random(n) < 0.5)


def test_lifecycle_explicit_zero_chunks_in_a_long_row():
    """A long row whose middle chunks hold only explicit zeros stays one
    combine segment in the resident state: three such instances through a
    two-slot multi-chunk bucket, bitwise against the port's one-shot (which
    segments by row) and equal to the reference's."""
    probs = [_zero_run_problem(s) for s in range(3)]
    ports = _port(probs)
    assert all((p.csr.val[8:24] == 0).all() for p in ports)
    svc = PropagationService.from_problems(ports, slots=2, tile_width=8, device="cpu")
    assert not svc._buckets[0].spec.fits_one_chunk
    for p, tp, r in zip(probs, ports, svc.serve(ports)):
        one = _one_shot(tp, 8)
        assert int(one.rounds) > 1
        _assert_bitwise(r, one)
        _assert_reference(r, _ref_one_shot(p, 8), exact=False)


def test_size_classes_serve_bitwise():
    """Quantile sub-buckets route small instances to tight slots, and
    serving through them stays bitwise."""
    pop = _port(POPULATIONS["size_classes"][0]())
    split = BucketSpec.for_problems(pop, slots=2, tile_width=8, size_classes=2)
    flat = BucketSpec.for_problems(pop, slots=2, tile_width=8)
    assert len(split) > len(flat)
    tight = next(s for s in split if s.fits_problem(pop[0]))
    wide = next(s for s in flat if s.fits_problem(pop[0]))
    assert tight.slot_tiles < wide.slot_tiles
    svc = PropagationService(split, device="cpu")
    for p, r in zip(pop, svc.serve(pop)):
        _assert_bitwise(r, _one_shot(p, 8))


def test_backfill_builds_nothing(sc_service):
    """Steady state builds nothing: the engine and kernel-library build
    counts are frozen after construction across a full serve with slot
    recycling, and a same-shape reconstruction is an engine-cache hit."""
    cc0 = sc_service.compile_counts()
    for counts in cc0.values():
        assert counts["engine_builds"] == 1
    sc_service.serve(T_SET_COVERS)
    assert sc_service.compile_counts() == cc0
    hits0 = sc_service.stats()["engine_cache"]["hits"]
    again = PropagationService.from_problems(T_SET_COVERS, slots=2, tile_width=8, device="cpu")
    assert sc_service.stats()["engine_cache"]["hits"] > hits0
    assert again.compile_counts() == cc0


def test_retire_backfill_while_slow_instance_resident():
    """One slow cascade + four 1-round instances through two slots: the
    fast slots turn over while the cascade is still resident and
    iterating."""
    slow = rd.make_cascade_chain(24)
    free = [p._replace(lhs=np.full(p.m, -INF), rhs=np.full(p.m, INF)) for p in SET_COVERS[:4]]
    probs = _port([slow] + free)
    svc = PropagationService.from_problems(probs, slots=2, tile_width=8, rounds_per_step=4,
                                           device="cpu")
    slow_t = svc.submit(probs[0])
    fast_ts = [svc.submit(p) for p in probs[1:]]
    while not slow_t.done():
        svc.pump()
    svc.drain()
    assert int(slow_t.result().rounds) > 20
    assert all(t.done_t < slow_t.done_t for t in fast_ts)
    assert fast_ts[-1].admit_t > fast_ts[0].done_t
    assert fast_ts[-1].admit_t < slow_t.done_t
    for p, t in zip(probs, [slow_t] + fast_ts):
        _assert_bitwise(t.result(), _one_shot(p, 8))


# ---------------------------------------------------------------------------
# Stats endpoint, tickets, observability
# ---------------------------------------------------------------------------


def test_stats_keys_equal_reference(sc_service):
    """Mid-flight stats have the reference's keys at every level and the
    ``batch_stats``-shaped histogram over the resident instances."""
    ref = rc.PropagationService.from_problems(SET_COVERS[:2], slots=2, tile_width=8,
                                              use_pallas=False)
    ref.submit(SET_COVERS[0])
    ref.pump()
    want = ref.stats()
    tickets = [sc_service.submit(p) for p in T_SET_COVERS[:3]]
    sc_service.pump()
    got = sc_service.stats()
    assert set(got) == set(want)
    assert set(got["buckets"][0]) == set(want["buckets"][0])
    assert set(got["buckets"][0]["histogram"]) == set(want["buckets"][0]["histogram"])
    assert set(got["metrics"]) == set(want["metrics"]) == SNAPSHOT_KEYS
    assert set(got["metrics"]["sources"]) == set(want["metrics"]["sources"])
    assert set(got["metrics"]["sources"]["service"]) == set(want["metrics"]["sources"]["service"])
    assert got["metrics"]["errors"] == {}
    bk = got["buckets"][0]
    if bk["occupied"]:
        assert bk["histogram"]["instances"] == bk["occupied"]
        assert 0.0 < bk["histogram"]["fill"] <= 1.0
    assert 0.0 < bk["mean_occupancy"] <= 1.0
    assert {"packed_problems", "prepare_problem_batch", "batch_runner"} <= set(
        got["kernel_caches"])
    sc_service.drain()
    got = sc_service.stats()
    assert got["occupied"] == 0 and got["pending"] == 0
    assert all(t.done() for t in tickets)


def test_ticket_timeout_and_latency(sc_service):
    t = sc_service.submit(T_SET_COVERS[0])
    with pytest.raises(TimeoutError):
        t.result(timeout=0.01)
    assert t.latency() is None and t.service_latency() is None
    sc_service.drain()
    assert t.done() and t.latency() >= 0.0
    assert t.admit_t >= t.submit_t and t.done_t >= t.admit_t
    assert t.queue_latency() + t.service_latency() == pytest.approx(t.latency())


def test_tracer_spans_and_flag_reads():
    """A traced service records pump/admit/step/readback spans and one
    ticket span per request, in the pinned schema; ``on_sync`` counts the
    flag reads (per step, the round counts and one per round; per pump, the
    active mask)."""
    tracer, reads = Tracer(), [0]
    svc = PropagationService.from_problems(
        T_SET_COVERS[:3], slots=2, tile_width=8, device="cpu", tracer=tracer,
        on_sync=lambda: reads.__setitem__(0, reads[0] + 1))
    assert svc.tracer is tracer
    svc.serve(T_SET_COVERS[:3])
    spans = tracer.spans()
    names = {s.name for s in spans}
    assert {"pump", "admit", "step", "readback", "ticket"} <= names
    assert sum(s.name == "ticket" for s in spans) == 3
    for line in tracer.export().splitlines():
        assert set(json.loads(line)) == SPAN_KEYS
    steps = sum(s.name == "step" for s in spans)
    assert reads[0] >= 3 * steps


def test_metrics_registry_isolates_failing_sources():
    reg = MetricsRegistry()
    reg.register("ok", lambda: 1)
    reg.register("bad", lambda: 1 / 0)
    with pytest.raises(ValueError):
        reg.register("ok", lambda: 2)
    snap = reg.snapshot()
    assert set(snap) == SNAPSHOT_KEYS
    assert snap["sources"] == {"ok": 1} and "ZeroDivisionError" in snap["errors"]["bad"]


@pytest.mark.parametrize("kw,item", [
    (dict(telemetry=8), "item 6"),
    (dict(stop_progress=0.1), "item 5"),
    (dict(patience=3), "item 5"),
    (dict(dtype=np.float32), "item 5"),
])
def test_options_outside_the_slice_raise(kw, item):
    """``telemetry=`` (item 6) still raises; the early retire and the
    float32 service (item 5) now run and are held to the reference's
    service (flags, bounds, the early-stop count)."""
    if "telemetry" in kw:
        with pytest.raises(NotImplementedError, match=item):
            PropagationService.from_problems(T_SET_COVERS[:1], slots=1, device="cpu", **kw)
        return
    svc = PropagationService.from_problems(T_SET_COVERS[:2], slots=1, device="cpu", **kw)
    ref = rc.PropagationService.from_problems(SET_COVERS[:2], slots=1, use_pallas=False, **kw)
    for got, want in zip(svc.serve(T_SET_COVERS[:2]), ref.serve(SET_COVERS[:2])):
        for f in ("rounds", "converged", "infeasible"):
            assert int(getattr(got, f)) == int(getattr(want, f)), f
        np.testing.assert_array_equal(got.lb.double().numpy(), np.asarray(want.lb, np.float64))
        np.testing.assert_array_equal(got.ub.double().numpy(), np.asarray(want.ub, np.float64))
    assert svc.stats()["early_stopped"] == ref.stats()["early_stopped"]


# ---------------------------------------------------------------------------
# Concurrency: background loop + concurrent submitters
# ---------------------------------------------------------------------------


def test_background_loop_with_concurrent_submitters():
    """The background pump thread and more client threads than cores
    submitting concurrently, with a short switch interval to interleave
    them: every ticket resolves once, bitwise against the one-shot, and the
    counters agree."""
    probs = _port([rd.make_set_cover(n=60, m=20, seed=100 + s) for s in range(12)])
    svc = PropagationService.from_problems(probs, slots=2, tile_width=8, device="cpu")
    tickets, lock = {}, threading.Lock()

    def client(chunk):
        for i, p in chunk:
            t = svc.submit(p)
            with lock:
                tickets[i] = t

    chunks = [[(i, probs[i])] for i in range(len(probs))]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with svc:
            pump = svc._thread
            workers = [threading.Thread(target=client, args=(c,)) for c in chunks]
            for w in workers:
                w.start()
            for w in workers:
                w.join(timeout=60)
            assert not any(w.is_alive() for w in workers)
            results = {i: t.result(timeout=120) for i, t in tickets.items()}
    finally:
        sys.setswitchinterval(interval)
    assert not pump.is_alive()
    assert len(results) == len(probs)
    st = svc.stats()
    assert st["submitted"] == st["retired"] == len(probs) and st["occupied"] == 0
    for i, p in enumerate(probs):
        _assert_bitwise(results[i], _one_shot(p, 8))
