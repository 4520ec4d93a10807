"""The port's sharded engines (``repro_torch.core.sharded``) on worlds of 1,
3 and 4 ``gloo`` ranks on the CPU, against the reference's
``repro.core.sharded`` on a 1-device mesh, in-process.

Each world size starts once for the file (``run_world``, all three at
once) and runs every case of ``torch_sharded_world.cases``; the tests read
its results.  Contract: partitions array for array; results bitwise (as
values) on the exact families (``make_cascade_chain``,
``make_pseudo_boolean``, ``make_set_cover``, ``make_knapsack``) at float64
and float32, ``bounds_equal`` on ``make_mixed`` and ``make_banded`` at
float64 (the packages sum in different orders); ``rounds``, ``converged``
and ``infeasible`` exactly everywhere.  Against the port itself, whatever
the data: every rank returns rank 0's result bitwise, the row partition and
the batch partition equal the unsharded engines bitwise (at float32 run
without outward widening, as the sharded paths merge).
"""
import dataclasses
import functools
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as rc
import repro.data as rd
import repro_torch as rt
import repro_torch.core as tc
import repro_torch.data as td
import torch_sharded_world as world_cases
from torch_sharded_world import BATCHES, CASES, DTYPES, TILE_WIDTH, WARM

ROOT = Path(__file__).resolve().parent.parent
WORLDS = (1, 3, 4)
EXACT = [name for name, (_, _, exact) in CASES.items() if exact]
# The cases held against the reference: the exact families at both dtypes,
# the others at float64.
_REF_CASES = ([(n, dt) for n in EXACT for dt in DTYPES]
              + [(n, "float64") for n in CASES if n not in EXACT])
# The reference's dtype arguments (``dtype or ...`` takes a type, not an
# np.dtype, whose truth value is False).
REF_DTYPE = {"float64": jnp.float64, "float32": jnp.float32}
NO_WIDENING = dataclasses.replace(tc.DEFAULT_CONFIG, outward_eps_f32=0.0)


@pytest.fixture(scope="module")
def worlds():
    """``{world size: [rank 0's results, rank 1's, ...]}``, the worlds run
    side by side while this process runs the reference's cases."""
    with ThreadPoolExecutor(len(WORLDS)) as pool:
        runs = {w: pool.submit(tc.run_world, world_cases.cases, w, timeout=300, threads=1)
                for w in WORLDS}
        for entry in ("nnz", "rows"):
            for name, dtype in _REF_CASES:
                _reference(entry, name, dtype)
        for batch in BATCHES:
            for dtype in DTYPES:
                _reference("batch", batch, dtype)
        return {w: run.result() for w, run in runs.items()}


@pytest.fixture(scope="module")
def mesh1():
    return jax.make_mesh((1,), ("b",))


@functools.lru_cache(maxsize=None)
def _ref_problem(name):
    return world_cases.build(rd, name)


@functools.lru_cache(maxsize=None)
def _port_problem(name):
    return world_cases.build(td, name)


@functools.lru_cache(maxsize=None)
def _reference(entry, name, dtype):
    mesh = jax.make_mesh((1,), ("b",))
    dt = REF_DTYPE[dtype]
    if entry == "batch":
        return rc.propagate_batch_sharded([_ref_problem(n) for n in BATCHES[name]], mesh,
                                          tile_width=TILE_WIDTH, dtype=dt)
    fn = rc.propagate_sharded if entry == "nnz" else rc.propagate_sharded_rows
    return fn(_ref_problem(name), mesh, dtype=dt)


def _fields(r):
    return [np.asarray(x) for x in r[:5]]


def _assert_against_reference(got, want, exact):
    g_lb, g_ub, g_rounds, g_conv, g_inf = _fields(got)
    w_lb, w_ub, w_rounds, w_conv, w_inf = _fields(want)
    assert (int(g_rounds), bool(g_conv), bool(g_inf)) == (int(w_rounds), bool(w_conv),
                                                          bool(w_inf))
    assert g_lb.shape == w_lb.shape and g_lb.dtype == w_lb.dtype
    assert rt.bounds_equal(g_lb, g_ub, w_lb, w_ub)
    if exact:
        np.testing.assert_array_equal(g_lb, w_lb)
        np.testing.assert_array_equal(g_ub, w_ub)


def _assert_same(a, b):
    """Two results of the port, bitwise (as values), progress included."""
    for f in ("lb", "ub", "rounds", "converged", "infeasible", "progress"):
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)


# ---------------------------------------------------------------------------
# Partitions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shards", [1, 3, 4, 8])
@pytest.mark.parametrize("name", list(CASES))
def test_partitions_match_reference(name, shards):
    ref, port = _ref_problem(name), _port_problem(name)
    for got, want in zip(tc.partition_nnz(port, shards), rc.partition_nnz(ref, shards)):
        assert got.dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(got, np.asarray(want))
    got, want = tc.partition_rows(port, shards), rc.partition_rows(ref, shards)
    for g, w in zip(got[:5], want[:5]):
        assert g.dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g, np.asarray(w))
    assert got[5] == want[5]


# ---------------------------------------------------------------------------
# Against the reference on a 1-device mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,dtype", _REF_CASES)
@pytest.mark.parametrize("entry", ["nnz", "rows"])
@pytest.mark.parametrize("size", WORLDS)
def test_sharded_matches_reference(worlds, size, entry, name, dtype):
    got = worlds[size][0][(entry, name, dtype)]
    _assert_against_reference(got, _reference(entry, name, dtype), CASES[name][2])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("batch", list(BATCHES))
@pytest.mark.parametrize("size", WORLDS)
def test_batch_sharded_matches_reference(worlds, size, batch, dtype):
    got = worlds[size][0][("batch", batch, dtype)]
    want = _reference("batch", batch, dtype)
    assert len(got) == len(want) == len(BATCHES[batch])
    for name, g, w in zip(BATCHES[batch], got, want):
        exact = CASES[name][2]
        if exact or dtype == "float64":
            _assert_against_reference(g, w, exact)


# ---------------------------------------------------------------------------
# Against the port itself
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size", WORLDS)
def test_every_rank_returns_rank_zeros_result(worlds, size):
    ranks = worlds[size]
    assert len(ranks) == size
    for other in ranks[1:]:
        assert other.keys() == ranks[0].keys()
        for key, want in ranks[0].items():
            got = other[key]
            for g, w in zip(got if key[0] == "batch" else [got],
                            want if key[0] == "batch" else [want]):
                _assert_same(g, w)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("size", WORLDS)
def test_row_partition_equals_unsharded_port(worlds, size, name, dtype):
    want = rt.propagate_block_ell(_port_problem(name), NO_WIDENING, tile_width=TILE_WIDTH,
                                  dtype=np.dtype(dtype), use_kernels=False, device="cpu")
    got = worlds[size][0][("rows", name, dtype)]
    for f in ("lb", "ub", "rounds", "converged", "infeasible"):
        np.testing.assert_array_equal(np.asarray(getattr(got, f)), getattr(want, f).numpy(),
                                      err_msg=f)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("batch", list(BATCHES))
@pytest.mark.parametrize("size", WORLDS)
def test_batch_partition_equals_unsharded_port(worlds, size, batch, dtype):
    problems = [_port_problem(n) for n in BATCHES[batch]]
    want = rt.propagate_batch(problems, NO_WIDENING, tile_width=TILE_WIDTH,
                              dtype=np.dtype(dtype), use_kernels=False, device="cpu")
    for g, w in zip(worlds[size][0][("batch", batch, dtype)], want):
        _assert_same(g, w)


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("size", WORLDS)
def test_nnz_partition_holds_the_unsharded_fixed_point(worlds, size, name):
    want = rt.propagate_block_ell(_port_problem(name), tile_width=TILE_WIDTH, device="cpu")
    got = worlds[size][0][("nnz", name, "float64")]
    assert int(got.rounds) == int(want.rounds)
    assert bool(got.infeasible) == bool(want.infeasible)
    assert rt.bounds_equal(got.lb, got.ub, want.lb, want.ub)


@pytest.mark.parametrize("size", WORLDS)
def test_sharded_warm_start_identity(worlds, size):
    """The twin of the reference's ``test_sharded_warm_start_identity``:
    explicit root bounds warm-start to the cold run, bitwise; and both
    equal the reference's run."""
    out = worlds[size][0]
    base, warm = out[("warm", "base", "float64")], out[("warm", "warm", "float64")]
    _assert_same(base, warm)
    gen, kw = WARM
    want = rc.propagate_sharded(getattr(rd, gen)(**kw), jax.make_mesh((1,), ("b",)))
    _assert_against_reference(base, want, exact=False)


# ---------------------------------------------------------------------------
# lower_sharded
# ---------------------------------------------------------------------------


def _ref_all_reduces(text: str) -> list:
    """``(elements, element type)`` of each all-reduce of a lowering's text."""
    out = []
    for at in [m.end() for m in re.finditer(r"stablehlo\.all_reduce", text)]:
        sig = re.search(r"\)\s*->\s*tensor<(\d+)x(\w+)>", text[at:])
        out.append((int(sig.group(1)), sig.group(2)))
    return out


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", ["mixed", "knapsack"])
def test_lower_sharded_matches_reference_arguments(mesh1, name, dtype):
    got = tc.lower_sharded(_port_problem(name), 1, dtype=getattr(torch, dtype))
    lowered = rc.lower_sharded(_ref_problem(name), mesh1, dtype=REF_DTYPE[dtype])
    want = lowered.args_info[0]
    assert len(got.args) == len(want) == 8
    for arg, info in zip(got.args, want):
        assert arg.shape == arg.per_rank == tuple(info.shape)
        assert str(arg.dtype).removeprefix("torch.") == str(info.dtype)
    item = np.dtype(dtype).itemsize
    p = _port_problem(name)
    assert [(c.op, c.elements) for c in got.collectives_per_round] == [
        ("sum", 4 * p.m), ("max", p.n), ("min", p.n)]
    assert all(c.bytes == c.elements * item for c in got.collectives_per_round)
    # The reference's six all-reduces: four over (m,), two over (n,).
    reduces = _ref_all_reduces(lowered.as_text())
    assert sorted(k for k, _ in reduces) == sorted([p.m] * 4 + [p.n] * 2)


@pytest.mark.parametrize("size", [3, 4])
def test_lower_sharded_per_rank_lengths_follow_partition_nnz(size):
    p = _port_problem("mixed")
    got = tc.lower_sharded(p, size, dtype=torch.float64)
    row_id, _, _ = tc.partition_nnz(p, size)
    per = row_id.shape[0] // size
    for arg in got.args[:3]:
        assert arg.shape == (row_id.shape[0],) and arg.per_rank == (per,)
    for arg in got.args[3:]:
        assert arg.per_rank == arg.shape
    size_of = {torch.int32: 4, torch.float64: 8, torch.bool: 1}
    assert got.arg_bytes_per_rank == sum(int(np.prod(a.per_rank)) * size_of[a.dtype]
                                         for a in got.args)
    assert got.world_size == size


# ---------------------------------------------------------------------------
# Process groups and worlds
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("entry", ["propagate_sharded", "propagate_sharded_rows",
                                   "propagate_batch_sharded"])
def test_missing_process_group_raises(entry):
    assert not torch.distributed.is_initialized()
    p = _port_problem("knapsack")
    arg = [p] if entry == "propagate_batch_sharded" else p
    with pytest.raises(RuntimeError, match="init_process_group"):
        getattr(tc, entry)(arg, device="cpu")


@pytest.mark.parametrize("entry", ["propagate_sharded", "propagate_sharded_rows",
                                   "propagate_batch_sharded"])
def test_sharded_entry_points_default_to_cuda(entry):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable here")
    p = _port_problem("knapsack")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        getattr(tc, entry)([p] if entry == "propagate_batch_sharded" else p)


def test_run_world_reports_a_failing_rank():
    with pytest.raises(RuntimeError, match="(?s)rank 1 raised.*fails on purpose"):
        tc.run_world(world_cases.fail, 2, timeout=120)


def test_run_world_kills_a_hanging_world_at_its_deadline():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        tc.run_world(world_cases.hang, 2, timeout=6)
    assert time.monotonic() - t0 < 30


def test_distributed_example_on_the_cpu():
    # One intra-op thread in the example and its ranks (run_world's default
    # follows the caller's): the other test workers hold the cores.
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "torch_distributed_propagation.py"),
         "--device", "cpu"], env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert "limit points equal: True" in out.stdout
    assert "world: 4 ranks (gloo, cpu)" in out.stdout
