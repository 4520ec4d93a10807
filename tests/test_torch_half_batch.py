"""The port's batched, node, service and sharded entry points at bfloat16 and
float16 (``repro_torch``) against the reference (``src/repro``) on the CPU.

The contract, from the reference's own behaviour at these types:

* **bfloat16**: bounds bitwise by value (-0.0 equals +0.0); ``rounds``,
  ``converged`` and ``infeasible`` exact.  ``propagate_batch`` (fused,
  multi-chunk and partitioned buckets, kernels' wrappers and plain
  versions) is held to the reference's ``propagate_batch(use_pallas=False)``
  and each instance to its own single-instance fixed point;
  ``propagate_nodes`` to the reference's ``propagate_nodes(use_pallas=False)``;
  the service to the reference's service.  The sharded engines are held to
  the reference's sharded engines on a 1-device mesh, which merge without
  the outward widening: on pb they keep 0.0 where the widened engines give
  2**-17.
* **float16**: bitwise on set cover and pb; ``rounds`` and verdicts exact
  everywhere; on mixed and banded the bounds within :data:`F16_ULPS`
  float16 ulp (the reference's own spread: its plain batch and its Pallas
  batch differ in 13 upper bounds of mixed, by 1 ulp).

The 16-bit plain versions of #8, #9 and its stop form, #10, #13, #14, #15's
batched walk and row-stop form and the batched record kernel are held to
the reference's oracles (``repro.kernels.ref``, jitted, and its bounds and
telemetry functions) at the same type; the node-batched A', combine and E,
which have no oracle (the reference vmaps its round), to the port's
single-instance plain versions, one node at a time.  The reference's runs
are cached per session; torch runs in one thread.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.core as rc
import repro.core.bounds as rbnd
import repro.kernels as rk
import repro.kernels.ref as rref
from repro.kernels import ops as rops
from repro.obs import telemetry as robs
import repro_torch as rt
from repro_torch import kernels as tk
from repro_torch.core.types import as_values, rounded
from repro_torch.kernels import ops as tops
from repro_torch.kernels import prop_round as tkern
from repro_torch.kernels import ref as tref
from torch_half_common import CFG, DTYPES, RCFG, _assert_same, _bitwise, _instance, _j, _t, _ulps
from torch_half_common import one_thread  # noqa: F401  (the module's autouse fixture)

pytestmark = pytest.mark.filterwarnings("ignore:overflow encountered in cast:RuntimeWarning")

BATCH = ("set_cover", "pb", "banded", "mixed")
# (tile_rows, tile_width) of each bucket: rows in one chunk (#8 + #9), rows
# over several chunks (A', the combine and E + #9), and past the shrunk
# limit (the partitioned round: #11, the straddle combine, #12 with #15).
BUCKETS = {"fused": (8, 128), "multi": (8, 8), "partitioned": (4, 32)}
SLAB = 128
# The early stop's threshold where it cuts the fixed point (part one's):
# at float16 an infinite bound makes the measure NaN, which never stops.
STOP = {"bf16": 1.0, "f16": 2.0}


@pytest.fixture
def tiny_budget(monkeypatch):
    """Both packages' engine limit and slab cap shrunk to 128."""
    for mod in (rops, tops):
        mod.clear_prepare_cache()
        mod.clear_batch_caches()
        monkeypatch.setattr(mod, "SCATTER_MAX_NPAD", 128)
        monkeypatch.setattr(mod, "SLAB_NPAD", 128)
    yield
    for mod in (rops, tops):
        mod.clear_prepare_cache()
        mod.clear_batch_caches()


def _check(got, want, bitwise, progress=False):
    """One result against the reference's: verdicts exact, bounds by the
    contract, and the progress measure (where asked) within one ulp, NaN
    where the reference's is."""
    for f in ("rounds", "converged", "infeasible"):
        assert bool((torch.as_tensor(np.asarray(getattr(want, f))) ==
                     torch.as_tensor(getattr(got, f))).all()), f
    _assert_same((got.lb, got.ub), (want.lb, want.ub), bitwise)
    if progress:
        g, w = torch.as_tensor(got.progress).reshape(-1), _t(want.progress).reshape(-1)
        assert bool((torch.isnan(g) == torch.isnan(w)).all())
        keep = ~torch.isnan(g)
        assert int(_ulps(g[keep], w[keep]).max()) <= 1 if bool(keep.any()) else True


# ---------------------------------------------------------------------------
# Batches
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _ref_batch(bucket, dtype, stop=None, telemetry=None):
    rows, width = BUCKETS[bucket]
    return rc.propagate_batch([_instance(n)[0] for n in BATCH], tile_rows=rows, tile_width=width,
                              dtype=DTYPES[dtype][1], use_pallas=False, stop_progress=stop,
                              telemetry=telemetry)


@pytest.mark.parametrize("bucket", list(BUCKETS))
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_batch_matches_reference(request, dtype, bucket):
    """``propagate_batch`` on ``[set_cover, pb, banded, mixed]``, on the
    kernels' wrappers and plain versions, against the reference's plain
    batch, and each instance against its own single-instance fixed point
    (the port's ``propagate_block_ell`` on the same tiles), bitwise."""
    if bucket == "partitioned":
        request.getfixturevalue("tiny_budget")
    rows, width = BUCKETS[bucket]
    tdt = DTYPES[dtype][0]
    pts = [_instance(n)[1] for n in BATCH]
    want = _ref_batch(bucket, dtype)
    batches = tops.packed_problems(pts, tile_rows=rows, tile_width=width)
    for b in batches:
        prep = tops.prepare_problem_batch(b, tdt, device="cpu")
        assert prep.d.val.dtype == tdt and prep.d.col.dtype == torch.int32  # never narrowed
        if bucket == "partitioned" and prep.n_pad > 128:
            assert prep.slab_partition().val.dtype == tdt
    for use_kernels in (True, False):
        got = rt.propagate_batch(pts, tile_rows=rows, tile_width=width, dtype=tdt,
                                 use_kernels=use_kernels, device="cpu")
        for name, g, w in zip(BATCH, got, want):
            assert g.lb.dtype == tdt
            _check(g, w, _bitwise(name, dtype))
    for name, pt, g in zip(BATCH, pts, got):
        one = rt.propagate_block_ell(pt, tile_rows=rows, tile_width=width, dtype=tdt,
                                     use_kernels=False, device="cpu")
        assert int(one.rounds) == int(g.rounds) and bool(one.converged) == bool(g.converged)
        _assert_same((g.lb, g.ub), (one.lb, one.ub))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_batch_early_stop_and_telemetry(dtype):
    """The per-instance early stop (#9 measures every active row, the loop
    folds the streak) against the reference's batched stop, with the
    telemetry on and off: on returns every field as off, each instance's
    ring the reference's (its progress within one ulp: another order of a
    float32 sum), ``stop_round`` and ``infeasible_round`` exact."""
    tdt = DTYPES[dtype][0]
    stop = STOP[dtype]
    pts = [_instance(n)[1] for n in BATCH]
    want = _ref_batch("fused", dtype, stop, 16)
    assert any(int(w.rounds) < int(f.rounds)
               for w, f in zip(want, _ref_batch("fused", dtype)))  # the stop cuts
    for use_kernels in (True, False):
        kw = dict(dtype=tdt, stop_progress=stop, use_kernels=use_kernels, device="cpu")
        off = rt.propagate_batch(pts, **kw)
        on = rt.propagate_batch(pts, telemetry=16, **kw)
        for name, a, b, w in zip(BATCH, off, on, want):
            _check(a, w, _bitwise(name, dtype), progress=True)
            for f in ("lb", "ub", "rounds", "converged", "infeasible", "progress"):
                torch.testing.assert_close(getattr(a, f), getattr(b, f), rtol=0, atol=0,
                                           equal_nan=True, msg=f)
            snap, wsnap = b.telemetry, w.telemetry
            for f in ("rounds_recorded", "stop_round", "infeasible_round"):
                assert getattr(snap, f) == int(getattr(wsnap, f)), f
            g = torch.tensor(snap.progress_history()).to(tdt)
            h = _t(wsnap.progress_history())
            assert bool((torch.isnan(g) == torch.isnan(h)).all())
            keep = ~torch.isnan(g)
            assert not bool(keep.any()) or int(_ulps(g[keep], h[keep]).max()) <= 1


# ---------------------------------------------------------------------------
# Nodes
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _nodes(name, count=4):
    """``count`` float64 node planes of an instance, each a few branchings
    of integer variables from the root (seeded)."""
    pr = _instance(name)[0]
    rng = np.random.default_rng(0)
    ints = np.flatnonzero(pr.is_int)
    lb, ub = np.zeros((count, pr.n)), np.zeros((count, pr.n))
    for i in range(count):
        lo, hi = np.array(pr.lb, np.float64), np.array(pr.ub, np.float64)
        for var in rng.choice(ints, size=1 + i % 3, replace=False):
            (dl, du), (ul, uu) = rc.branch_children(lo, hi, int(var), lo[var])
            lo, hi = (dl, du) if rng.random() < 0.5 else (ul, uu)
        lb[i], ub[i] = lo, hi
    return lb, ub


@functools.lru_cache(maxsize=None)
def _ref_nodes(name, dtype, width):
    lb, ub = _nodes(name)
    return rc.propagate_nodes(_instance(name)[0], lb, ub, tile_width=width,
                              dtype=DTYPES[dtype][1], use_pallas=False)


def _check_nodes(got, want, bitwise):
    for f in ("rounds", "converged", "infeasible", "tier_rounds"):
        np.testing.assert_array_equal(np.asarray(getattr(got, f)), np.asarray(getattr(want, f)),
                                      err_msg=f)
    _assert_same((got.lb, got.ub), (want.lb, want.ub), bitwise)


@pytest.mark.parametrize("width", [128, 4])
@pytest.mark.parametrize("name", ["mixed", "pb"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_nodes_match_reference(dtype, name, width):
    """Four branched nodes of mixed and pb, at tile width 128 (#10 + #9) and
    4 (the node-batched A', combine and E + #9; bfloat16 on the compact
    ids), on the kernels' wrappers and plain versions, against the
    reference's plain node fixed point."""
    tdt = DTYPES[dtype][0]
    prep = rt.prepare_block_ell(_instance(name)[1], 8, width, dtype=tdt, device="cpu")
    assert prep.d.col.dtype == (torch.int16 if dtype == "bf16" else torch.int32)
    lb, ub = _nodes(name)
    want = _ref_nodes(name, dtype, width)
    for use_kernels in (True, False):
        got = rt.propagate_nodes(_instance(name)[1], lb, ub, tile_width=width, dtype=tdt,
                                 use_kernels=use_kernels, device="cpu")
        assert got.lb.dtype == tdt
        _check_nodes(got, want, _bitwise(name, dtype))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_nodes_with_policy(dtype):
    """``TierPolicy`` with a 16-bit final type on two nodes of the cascade
    chain (its root bounds; an exact family, so the packages' float32 tiers
    agree bitwise): at bfloat16 one tier (no float32 rounds), at float16 a
    float32 tier, the exact promotion and the float16 endgame, against the
    reference's."""
    tdt, jdt = DTYPES[dtype]
    pr, pt = _instance("cascade")
    lb, ub = np.stack([pr.lb] * 2), np.stack([pr.ub] * 2)
    want = rc.propagate_nodes(pr, lb, ub, dtype=jdt, use_pallas=False, policy=rc.TierPolicy())
    got = rt.propagate_nodes(pt, lb, ub, dtype=tdt, policy=rt.core.TierPolicy(), device="cpu")
    _check_nodes(got, want, True)
    tiers = np.asarray(got.tier_rounds)
    assert (tiers == 0).all() if dtype == "bf16" else (tiers > 0).all()


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_nodes_past_the_limit(tiny_budget, monkeypatch, dtype):
    """mixed's nodes past the shrunk limit: the partitioned node kernels
    (#13, the straddle combine over the active planes, #14 with #15), and
    the plain node segment round under ``REPRO_AUTO_LARGE_SCATTER=segment``,
    against the reference's plain node fixed points under the same
    settings."""
    tdt, jdt = DTYPES[dtype]
    pr, pt = _instance("mixed")
    lb, ub = _nodes("mixed")
    want = rc.propagate_nodes(pr, lb, ub, tile_width=32, dtype=jdt, use_pallas=False)
    got = rt.propagate_nodes(pt, lb, ub, tile_width=32, dtype=tdt, device="cpu")
    _check_nodes(got, want, _bitwise("mixed", dtype))
    monkeypatch.setenv(tops.AUTO_LARGE_SCATTER_ENV, "segment")
    want = rc.propagate_nodes(pr, lb, ub, tile_width=32, dtype=jdt, use_pallas=False)
    got = rt.propagate_nodes(pt, lb, ub, tile_width=32, dtype=tdt, use_kernels=False,
                             device="cpu")
    _check_nodes(got, want, _bitwise("mixed", dtype))


# ---------------------------------------------------------------------------
# The service
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _ref_service(dtype):
    probs = [_instance(n)[0] for n in ("mixed", "pb")]
    svc = rc.PropagationService.from_problems(probs, slots=2, dtype=DTYPES[dtype][1])
    return svc.serve(probs)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_service_matches_reference(dtype):
    """``[mixed, pb]`` served through 2 slots, on the kernels' wrappers and
    plain versions, against the reference's service; each admitted slot's
    values are ``prepare_problem_batch``'s bit for bit."""
    tdt = DTYPES[dtype][0]
    pts = [_instance(n)[1] for n in ("mixed", "pb")]
    want = _ref_service(dtype)
    for use_kernels in (True, False):
        svc = rt.PropagationService.from_problems(pts, slots=2, dtype=tdt,
                                                  use_kernels=use_kernels, device="cpu")
        for name, g, w in zip(("mixed", "pb"), svc.serve(pts), want):
            assert g.lb.dtype == tdt
            _check(g, w, _bitwise(name, dtype))
    svc = rt.PropagationService.from_problems(pts, slots=2, dtype=tdt, device="cpu")
    for pt in pts:
        ticket = svc.submit(pt)
        svc.pump()
        bucket = next(b for b in svc._buckets if b.spec.admits(ticket.payload))
        spec = bucket.spec
        (batch,) = tops.packed_problems([pt], tile_rows=spec.tile_rows,
                                        tile_width=spec.tile_width)
        prep = tops.prepare_problem_batch(batch, tdt, device="cpu")
        used = prep.d.val.shape[0]
        tiles = bucket.state[0][ticket.slot * spec.slot_tiles:][:used]
        assert tiles.dtype == tdt and torch.equal(tiles.view(torch.int16),
                                                  prep.d.val.view(torch.int16))
        svc.drain()


def test_service_values_round_once():
    """A payload value converts from float64 once, as
    ``prepare_problem_batch`` and the reference convert it: a float16 upper
    bound of 1 + 2**-11 + 2**-40 is 1 + 2**-10 (through float32 it would
    tie to 1.0); at bfloat16 the reference converts through float32 (XLA
    and ``ml_dtypes`` alike), and so does the port: 1 + 2**-8 + 2**-30 is
    1.0 there."""
    pr, pt = _instance("pb")
    for dtype, x, after in (("f16", 1 + 2**-11 + 2**-40, 1 + 2**-10),
                            ("bf16", 1 + 2**-8 + 2**-30, 1.0)):
        tdt, jdt = DTYPES[dtype]
        ub = np.array(pt.ub, np.float64)
        ub[0] = x
        warm = pt._replace(ub=ub)
        assert float(jnp.asarray(ub, jdt)[0]) == after
        svc = rt.PropagationService.from_problems([warm], slots=2, dtype=tdt, device="cpu")
        ticket = svc.submit(warm)
        assert float(torch.from_numpy(ticket.payload.ub[:1]).view(tdt)[0]) == after
        assert float(as_values(ub, tdt)[0]) == after


# ---------------------------------------------------------------------------
# The sharded engines
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def world_of_one():
    """A default process group of one gloo rank in this process."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    yield
    dist.destroy_process_group()


@functools.lru_cache(maxsize=None)
def _ref_sharded(entry, dtype):
    mesh = jax.make_mesh((1,), ("b",))
    jdt = DTYPES[dtype][1]
    if entry == "batch":
        return rc.propagate_batch_sharded([_instance(n)[0] for n in ("mixed", "pb")], mesh,
                                          dtype=jdt)
    fn = rc.propagate_sharded if entry == "nnz" else rc.propagate_sharded_rows
    return [fn(_instance(n)[0], mesh, dtype=jdt) for n in ("mixed", "pb")]


@functools.lru_cache(maxsize=None)
def _ref_block_ell(name, dtype):
    return rk.propagate_block_ell(_instance(name)[0], dtype=DTYPES[dtype][1], use_pallas=False)


@pytest.mark.parametrize("entry", ["nnz", "rows", "batch"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_sharded_matches_reference(world_of_one, dtype, entry):
    """The three sharded engines on mixed and pb against the reference's on
    a 1-device mesh (both merge without widening: no 2**-17 bound on pb,
    where ``propagate_block_ell`` widens upper bounds of 0 to it at
    bfloat16).  Rounds and verdicts exact.  The bounds are the contract's,
    except on mixed at bfloat16 under the nnz and row partitions: there
    the reference's sharded rounds sum each row's contributions in
    nonzero order (``segment_sum``), rounding after every add, where the
    port's sum in its block-ELL engine's order (as at float32, whose test
    holds ``bounds_equal`` there).  The port's bounds equal the
    reference's unwidened block-ELL fixed point (``propagate_block_ell``,
    the same order) bitwise, and differ from its sharded ones only where
    the reference's two engines differ from each other (measured: 5 bounds
    of mixed, by at most 64 bfloat16 ulps)."""
    tdt = DTYPES[dtype][0]
    pts = [_instance(n)[1] for n in ("mixed", "pb")]
    if entry == "batch":
        got = rt.core.propagate_batch_sharded(pts, dtype=tdt, device="cpu")
    else:
        fn = rt.core.propagate_sharded if entry == "nnz" else rt.core.propagate_sharded_rows
        got = [fn(pt, dtype=tdt, device="cpu") for pt in pts]
    for name, g, w in zip(("mixed", "pb"), got, _ref_sharded(entry, dtype)):
        assert g.lb.dtype == tdt
        if name == "mixed" and dtype == "bf16" and entry != "batch":
            own = _ref_block_ell(name, dtype)
            _check(g, own, True)
            for f in ("rounds", "converged", "infeasible"):
                assert int(getattr(g, f)) == int(getattr(w, f)), f
            for gv, wv, ov in ((g.lb, w.lb, own.lb), (g.ub, w.ub, own.ub)):
                assert not bool((gv != _t(wv))[_t(wv) == _t(ov)].any())
            continue
        _check(g, w, _bitwise(name, dtype))
    assert not bool((got[1].ub == 2.0**-17).any())
    if dtype == "bf16":
        widened = rt.propagate_block_ell(pts[1], dtype=tdt, device="cpu")
        assert bool((widened.ub == 2.0**-17).any())


# ---------------------------------------------------------------------------
# The kernels' 16-bit plain versions against the reference's oracles
# ---------------------------------------------------------------------------

_REF_NODE = jax.jit(rref.node_fused_scatter_round_ref, static_argnums=(7, 8))
_REF_BATCHED = jax.jit(rref.batched_fused_scatter_round_ref, static_argnums=(7, 8))
_REF_MERGE_BATCH = jax.jit(rbnd.apply_updates_batch, static_argnums=(4, 5, 6))
_REF_PROGRESS_ROWS = jax.jit(rbnd.progress_measure)
_REF_RECORD_BATCH = jax.jit(lambda plane, prog, rounds, crossed, stopped, active:
                            robs.record_round(plane, prog, rounds, crossed, stopped, active))


def _planes(name, dtype, n_pad):
    """Four node planes of an instance at ``dtype``, padded to ``n_pad``, as
    the port's and the reference's arrays."""
    lb, ub = _nodes(name)
    pad = lambda x: np.pad(x, ((0, 0), (0, n_pad - x.shape[1])))
    tdt = DTYPES[dtype][0]
    tl, tu = as_values(pad(lb), tdt), as_values(pad(ub), tdt)
    return tl, tu, _j(tl), _j(tu)


def _merge_against_reference(dtype, lb, ub, best, act, progress=True):
    """#9 (with its stop form's per-row measure) on the port's candidates
    against the reference's ``apply_updates_batch`` and
    ``progress_measure`` on the same inputs; returns the merged planes."""
    tdt, jdt = DTYPES[dtype]
    eps, inf, outward = CFG.eps_for(tdt), CFG.inf, CFG.outward_for(tdt)
    wl, wu, wch = _REF_MERGE_BATCH(_j(lb), _j(ub), *(_j(b.to(tdt)) for b in best),
                                   RCFG.eps_for(jdt), RCFG.inf, RCFG.outward_for(jdt))
    prog = torch.full((lb.shape[0],), 7.0, dtype=tdt)
    gl, gu, gch = tk.apply_updates_batch_tiles(lb.clone(), ub.clone(), *(b.clone() for b in best),
                                               act, eps, inf, outward,
                                               progress=prog if progress else None)
    rows = act.nonzero().flatten()
    _assert_same((gl[rows], gu[rows]), (_t(wl)[rows], _t(wu)[rows]))
    assert torch.equal(gch[rows], _t(wch)[rows]) and not bool(gch[~act].any())
    assert torch.equal(gl[~act], lb[~act])
    if progress:
        want = _t(_REF_PROGRESS_ROWS(_j(lb), _j(ub), wl, wu))
        assert bool((prog[~act] == 7.0).all())
        g, w = prog[rows], want[rows]
        assert bool((torch.isnan(g) == torch.isnan(w)).all())
        keep = ~torch.isnan(g)
        assert not bool(keep.any()) or int(_ulps(g[keep], w[keep]).max()) <= 1
    return gl, gu


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_node_kernels_match_oracles(dtype):
    """#10 (tile width 128) on mixed's nodes, one inactive, into the kept
    float32 planes, against the reference's node oracle; then #9 and its
    stop form against ``apply_updates_batch`` and ``progress_measure``.  At
    tile width 4, the node-batched A', combine and E against the port's
    single-instance plain versions node by node (bfloat16 on the compact
    ids)."""
    tdt, _ = DTYPES[dtype]
    bitwise = dtype == "bf16"
    act = torch.tensor([True, False, True, True])
    int_eps, inf = CFG.int_eps, CFG.inf
    pr = _instance("mixed")[0]
    rp = rk.prepare_block_ell(pr, tile_width=128, dtype=DTYPES[dtype][1])
    tp = rt.prepare_block_ell(_instance("mixed")[1], 8, 128, dtype=tdt, device="cpu")
    lb, ub, jl, ju = _planes("mixed", dtype, tp.n_pad)
    acc = tk.accumulator_planes(lb, inf)
    best = tk.node_fused_scatter_round_tiles(tp.d.val, tp.d.col, tp.ii_g, tp.lhs_g, tp.rhs_g,
                                             lb, ub, act, tp.n_pad, int_eps, inf, acc=acc)
    assert best[0] is acc[0] and best[0].dtype == torch.float32
    want = _REF_NODE(rp.d.val, rp.d.col, rp.ii_g, rp.lhs_g, rp.rhs_g, jl, ju, rp.n_pad,
                     int_eps)
    rows = act.nonzero().flatten()
    _assert_same([b[rows].to(tdt) for b in best], [_t(w)[rows] for w in want], bitwise)
    assert bool((best[0][1] == -rounded(inf, tdt)).all())
    _merge_against_reference(dtype, lb, ub, best, act)
    # Rows over several chunks: A', the combine and E per node.
    tp = rt.prepare_block_ell(_instance("mixed")[1], 8, 4, dtype=tdt, device="cpu")
    parts = tk.node_activities_gather_tiles(tp.d.val, tp.d.col, lb, ub, act, tp.n_pad, inf)
    aggs = tk.node_combine_chunk_partials_tiles(*parts, tp.d.chunk_row, tp.row_start, act)
    got = tk.node_candidates_scatter_tiles(tp.d.val, tp.d.col, tp.ii_g, *aggs, tp.lhs_g,
                                           tp.rhs_g, lb, ub, act, tp.n_pad, int_eps, inf)
    assert got[0].dtype == torch.float32 and parts[0].dtype == tdt
    for b in rows.tolist():
        one = tk.activities_gather_tiles(tp.d.val, tp.d.col, lb[b], ub[b], tp.n_pad, inf)
        _assert_same([x[b] for x in parts], one)
        one_aggs = tk.combine_chunk_partials_tiles(*one, tp.d.chunk_row, tp.row_start)
        _assert_same([x[b] for x in aggs], one_aggs)
        one_best = tk.candidates_scatter_tiles(tp.d.val, tp.d.col, tp.ii_g, *one_aggs,
                                               tp.lhs_g, tp.rhs_g, lb[b], ub[b], tp.n_pad,
                                               int_eps, inf)
        _assert_same([x[b].to(tdt) for x in got], [x.to(tdt) for x in one_best])
    assert bool((got[0][1] == -rounded(inf, tdt)).all())


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_batched_fused_kernel_matches_oracle(dtype):
    """#8 (int32 ids) on the widest bucket of ``[set_cover, pb, banded,
    mixed]`` at tile width 128 (banded and mixed) with one instance
    inactive, against the reference's batched oracle; then #9 over the
    bucket's planes."""
    tdt, jdt = DTYPES[dtype]
    bitwise = dtype == "bf16"
    pts = [_instance(n)[1] for n in BATCH]
    prs = [_instance(n)[0] for n in BATCH]
    tbatch = tops.packed_problems(pts)
    rbatch = rc.pack_problems(prs)
    assert [b.size for b in tbatch] == [b.size for b in rbatch]
    for tb, rb in list(zip(tbatch, rbatch))[-1:]:
        tprep = tops.prepare_problem_batch(tb, tdt, device="cpu")
        rprep = rk.prepare_problem_batch(rb, jdt)
        d, rd_ = tprep.d, rprep.d
        assert d.col.dtype == torch.int32
        act = torch.ones(tprep.size, dtype=torch.bool)
        act[0] = tprep.size == 1
        got = tk.batched_fused_scatter_round_tiles(
            d.val, d.col, d.ii_g, d.lhs_g, d.rhs_g, d.lb0, d.ub0, d.tile_inst, act, tprep.n_pad,
            CFG.int_eps, CFG.inf, acc=tk.accumulator_planes(d.lb0, CFG.inf))
        want = _REF_BATCHED(rd_.val, rd_.col_g, rd_.ii_g, rd_.lhs_g, rd_.rhs_g, rd_.lb0,
                            rd_.ub0, rprep.n_pad, CFG.int_eps)
        rows = act.nonzero().flatten()
        _assert_same([g[rows].to(tdt) for g in got], [_t(w)[rows] for w in want], bitwise)
        _merge_against_reference(dtype, d.lb0, d.ub0, got, act)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_node_slab_kernels_match_oracle(dtype):
    """#13, the straddle combine over the active planes and #14 with #15's
    row-stop form over mixed's nodes (one inactive), against the
    reference's node partition oracle and its merge; #15's batched walk (20
    planes, past the grid's 16 rows) on the same candidates."""
    tdt, jdt = DTYPES[dtype]
    bitwise = dtype == "bf16"
    pr, pt = _instance("mixed")
    rp = rk.prepare_block_ell(pr, 4, 32, dtype=jdt)
    tp = rt.prepare_block_ell(pt, 4, 32, dtype=tdt, device="cpu")
    want_p, part = rp.slab_partition(SLAB), tp.slab_partition(SLAB)
    assert part.has_straddle and part.val.dtype == tdt
    act = torch.tensor([True, False, True, True])
    lb, ub, jl, ju = _planes("mixed", dtype, tp.n_pad)
    eps, int_eps, inf, outward = (CFG.eps_for(tdt), CFG.int_eps, CFG.inf,
                                  CFG.outward_for(tdt))
    parts = tk.node_slab_partials_tiles(part.a_val, part.a_col_s, part.a_run_start,
                                        part.a_run_len, part.a_run_slab, act, lb, ub, SLAB,
                                        part.a_max_run_len, inf)
    assert parts[0].dtype == tdt
    strs = tk.straddle_combine_tiles(*parts, part.a_order, part.a_seg, part.agg_slot, act)
    acc = tk.accumulator_planes(lb, inf)
    prog = torch.full((4,), 7.0, dtype=tdt)
    gl, gu, flags = tk.node_slab_round_tiles(
        part.val, part.col_s, part.ii_g, part.row_done, *strs, part.lhs_g, part.rhs_g,
        part.run_start, part.run_len, part.run_slab, act, lb.clone(), ub.clone(), SLAB,
        part.max_run_len, eps, int_eps, inf, outward, acc=acc, tile_slab=part.tile_slab,
        chunk_len=part.chunk_len, progress=prog)
    oracle = jax.jit(functools.partial(rref.node_partitioned_round_ref, want_p),
                     static_argnums=(2,))
    wbl, wbu = oracle(jl, ju, int_eps)
    width = tp.n_pad
    wl, wu, _ = _REF_MERGE_BATCH(jl, ju, wbl[:, :width], wbu[:, :width], RCFG.eps_for(jdt),
                                 RCFG.inf, RCFG.outward_for(jdt))
    rows = act.nonzero().flatten()
    _assert_same((gl[rows], gu[rows]), (_t(wl)[rows], _t(wu)[rows]), bitwise)
    assert torch.equal(gl[1], lb[1]) and not bool(flags[1].any())
    assert bool((acc[0] == -rounded(inf, tdt)).all())  # handed back
    wprog = _t(_REF_PROGRESS_ROWS(jl, ju, wl, wu))
    g, w = prog[rows], wprog[rows]
    assert bool((torch.isnan(g) == torch.isnan(w)).all()) and bool((prog[1] == 7.0).all())
    # #15 on the walk: 20 planes (the node planes repeated), the plain
    # scatter's candidates of the active ones; inactive rows pass through.
    best = tref.node_slab_scatter_ref(
        part.val, part.col_s, part.ii_g, part.row_done, *strs, part.lhs_g, part.rhs_g,
        part.run_start, part.run_slab, act, lb, ub, SLAB, rounded(int_eps, tdt),
        rounded(inf, tdt))
    big = torch.arange(20) % 4
    blb, bub = lb[big], ub[big]
    bact = act[big]
    ml, mu, mflags = tk.apply_updates_slab_tiles(blb.clone(), bub.clone(),
                                                 *(b[big].float() for b in best), bact, SLAB,
                                                 eps, inf, outward)
    on = bact.nonzero().flatten()
    _assert_same((ml[on], mu[on]), (gl[big][on], gu[big][on]))
    assert torch.equal(ml[~bact], blb[~bact]) and not bool(mflags[~bact].any())


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_batched_record_kernel_matches_reference(dtype):
    """The batched record kernel's plain version (its prepared launch off
    the card) over mixed's four node planes, two rounds with a row that did
    not run and one crossed row, against the reference's
    ``obs.telemetry.record_round`` with ``active``."""
    tdt, jdt = DTYPES[dtype]
    lb, ub, _, _ = _planes("mixed", dtype, 256)
    ub[2, 3] = lb[2, 3] - 1  # crossed
    plane = rt.obs.device_plane(4, batch=4, dtype=tdt, device="cpu")
    wplane = robs.device_plane(4, batch=4, dtype=jdt)
    launch = tkern.RecordBatchLaunch(plane, CFG.feas_eps, patience=2)
    for r, ran in enumerate(([True, True, False, True], [True, False, True, True]), 1):
        ran = torch.tensor(ran)
        prog = torch.tensor([0.5, 0.25, 2.0**-9, 3.0], dtype=tdt) * r
        rounds = torch.full((4,), r, dtype=torch.int32)
        flat = torch.tensor([0, 2, 1, 3], dtype=torch.int32)
        launch(lb, ub, prog, ran, rounds, flat)
        crossed = jnp.any(_j(lb) > _j(ub) + RCFG.feas_eps, axis=-1)
        wplane = _REF_RECORD_BATCH(wplane, _j(prog), jnp.asarray(rounds.numpy()), crossed,
                                   jnp.asarray((flat >= 2).numpy()), jnp.asarray(ran.numpy()))
    _assert_same((plane.ring,), (wplane.ring,), nan=True)
    for f in ("ticks", "stop_round", "infeas_round"):
        assert torch.equal(getattr(plane, f).long(), _t(getattr(wplane, f)).long()), f
