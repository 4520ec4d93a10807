"""The port's roofline tooling against the reference's (the twin of
``tests/test_hlo_tools.py``): ``CostCounter``'s dot FLOPs and HBM traffic
against the reference's HLO parsers on its compiled modules, per-rank (not
global) counting of a DTensor matmul, ``RooflineTerms`` on the H100
constants, ``report.py``'s tables, and the collective-count twin: one
counted round of each propagation partition on a fake world of 4 against
``lower_sharded`` and against the reference's ``collective_bytes`` of its
rounds lowered on a 4-device mesh.  Worlds run in child processes."""
import functools
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.roofline import report as r_report
from repro.roofline.hlo_flops import dot_flops_by_op as r_dot_flops
from repro.roofline.hlo_flops import hbm_traffic_estimate as r_traffic
from repro_torch.roofline import analysis, counting, report

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_launch_world as world  # noqa: E402

SRC = Path(__file__).resolve().parent.parent / "src"
# The reference's run_propagation_variants instance at the issue's size.
INSTANCE = dict(m=2_500, n=1_250, nnz=40_000)
NNZ_ROUND_BYTES = 4 * INSTANCE["m"] * 4 + 2 * INSTANCE["n"] * 4   # 50,000
ROW_ROUND_BYTES = 2 * INSTANCE["n"] * 4                            # 10,000


def test_dot_flops_equal_reference_on_compiled_module():
    m, k, n, p = 8, 16, 32, 4
    sds = jax.ShapeDtypeStruct
    compiled = jax.jit(lambda a, b, c: (a @ b) @ c).lower(
        sds((m, k), jnp.float32), sds((k, n), jnp.float32), sds((n, p), jnp.float32)).compile()
    want, _ = r_dot_flops(compiled.as_text())
    a, b, c = torch.randn(m, k), torch.randn(k, n), torch.randn(n, p)
    with counting.CostCounter() as counter:
        (a @ b) @ c
    total, by_op = counting.dot_flops_by_op(counter)
    assert total == want == 10_240
    assert by_op == {"step": 10_240}
    counting.print_flops_report(counter)


def test_hbm_traffic_equals_reference():
    sds = jax.ShapeDtypeStruct
    compiled = jax.jit(lambda a, b: a @ b).lower(sds((64, 128), jnp.float32),
                                                 sds((128, 32), jnp.float32)).compile()
    want = r_traffic(compiled.as_text())
    with counting.CostCounter() as counter:
        torch.randn(64, 128) @ torch.randn(128, 32)
    assert counting.hbm_traffic_estimate(counter) == want == 57_344
    # Elementwise chains are assumed fused: they add no traffic.
    x = torch.randn(64, 128)
    with counting.CostCounter() as counter:
        torch.exp(x * 2.0 + 1.0)
    assert counter.record.hbm_bytes == 0.0


def test_memory_peak_counts_fresh_allocations_only():
    """The peak counts the storages ops allocate while they live: a view of
    an argument and an in-place result allocate nothing, a freed output
    leaves the peak where it was."""
    w = torch.empty(8, 1024, 1024, device="meta")  # a 32 MiB argument
    with counting.CostCounter(track_memory=True) as counter:
        a = w[0]
        b = a * 2.0  # 4 MiB
        a.add_(1.0)
        del b
        c = a + 1.0  # 4 MiB again, after b was freed
    assert counter.record.peak_bytes == 4 * 2**20
    del c


def test_dtensor_matmul_counted_per_rank():
    """On a fake world of 256, a (16, 16)-mesh DTensor matmul counts one
    rank's local product: the global FLOPs over 256 (FlopCounterMode counts
    the global product)."""
    mine, flop_counter = world.in_child(world.per_rank_matmul)
    assert flop_counter == 2 * 64 * 1024 * 4096 == 536_870_912
    assert mine == flop_counter / 256


def test_roofline_terms_on_h100_peaks():
    t = analysis.RooflineTerms(flops=989e12, bytes_hbm=3.35e12 * 2,
                               bytes_coll=450e9).finalize()
    assert abs(t.t_compute - 1.0) < 1e-12
    assert abs(t.t_memory - 2.0) < 1e-12
    assert abs(t.t_collective - 1.0) < 1e-12
    assert t.bottleneck == "memory" and t.t_bound == t.t_memory
    assert set(t.as_dict()) >= {"flops_per_device", "t_bound_s", "bottleneck"}
    assert analysis.extrapolate(10.0, 13.0, 1, 2, 10) == 7 + 3 * 10
    assert analysis.model_flops(10, 7, "train") == 420.0
    assert analysis.model_flops(10, 7, "decode") == 140.0
    assert analysis.ICI_BW == analysis.NVLINK_BW


RECORDS = [
    {"arch": "a", "shape": "train_4k", "mesh": "single", "supported": True,
     "compile_s": 1.5, "microbatches": 8, "arg_bytes": 3 * 2**30, "temp_bytes": 2**30,
     "fits_hbm": True, "t_compute_s": 0.5, "t_memory_s": 0.25, "t_collective_s": 0.125,
     "bottleneck": "compute", "useful_compute_ratio": 0.75, "roofline_fraction": 1.0},
    {"arch": "b", "shape": "long_500k", "mesh": "single", "supported": False,
     "skip_reason": "full-attention arch"},
    {"arch": "c", "shape": "decode_32k", "mesh": "multi", "error": "ValueError: x"},
]


def test_report_tables_are_the_reference_s():
    """``report.py`` prints the reference's tables, the memory column named
    after one H100's 80 GB."""
    h100 = lambda text: text.replace("16GiB/chip", "80GB/card").replace("16GiB", "80GB")
    assert report.dryrun_table(RECORDS) == h100(r_report.dryrun_table(RECORDS))
    assert report.roofline_table(RECORDS) == r_report.roofline_table(RECORDS)
    assert report.summarize(RECORDS) == h100(r_report.summarize(RECORDS))
    assert "fits 80GB" in report.dryrun_table(RECORDS)


def test_counter_counts_collectives_by_the_reference_convention():
    """``dist.all_reduce`` and DTensor's redistributions on a fake world of
    4: all-gather and reduce-scatter by their operand, all-reduce by its
    result."""
    got = world.in_child(world.collective_case)
    assert got == {"all-gather": 64.0, "all-reduce": 20.0 + 256.0, "reduce-scatter": 256.0,
                   "all-to-all": 0.0, "collective-permute": 0.0, "total": 596.0}


_REFERENCE_ROUNDS = """
import functools, json
import jax, jax.numpy as jnp, numpy as np
from jax import shard_map
from jax.sharding import PartitionSpec as P
from repro.core.sharded import (_row_sharded_round, _sharded_round, partition_nnz,
                                partition_rows)
from repro.core.sparse import Problem, csr_from_coo
from repro.core.types import DEFAULT_CONFIG as cfg
from repro.roofline.analysis import collective_bytes
m, n, nnz = {m}, {n}, {nnz}
rng = np.random.default_rng(0)
rows_idx = np.sort(rng.integers(0, m, nnz)).astype(np.int32)
cols = rng.integers(0, n, nnz).astype(np.int32)
vals = rng.standard_normal(nnz).astype(np.float32)
p = Problem(csr=csr_from_coo(rows_idx, cols, vals, m, n), lhs=np.full(m, -1e20, np.float32),
            rhs=rng.uniform(1, 10, m).astype(np.float32), lb=np.zeros(n, np.float32),
            ub=np.full(n, 10.0, np.float32), is_int=np.zeros(n, dtype=bool))
mesh = jax.make_mesh((2, 2), ("data", "model"))
axes = tuple(mesh.axis_names)
eps = cfg.eps_for(jnp.float32)
rep = P()
row_id, col, val = partition_nnz(p, 4)
fa = functools.partial(_sharded_round, m=m, n=n, eps=eps, int_eps=cfg.int_eps, inf=cfg.inf,
                       axes=axes)
fnA = shard_map(fa, mesh=mesh, in_specs=(P(axes),) * 3 + (rep,) * 5,
                out_specs=(rep, rep, rep), check_vma=False)
args = [jnp.asarray(x) for x in (row_id, col, val, p.lhs, p.rhs, p.is_int, p.lb, p.ub)]
a = collective_bytes(jax.jit(fnA).lower(*args).compile().as_text())
val2, col2, lrow2, lhs2, rhs2, rows = partition_rows(p, 4)
fb = functools.partial(_row_sharded_round, rows=rows, n=n, eps=eps, int_eps=cfg.int_eps,
                       inf=cfg.inf, axes=axes)
def bodyB(lrow, col, val, lhs, rhs, is_int, lb, ub):
    return fb(lrow[0], col[0], val[0], lhs[0], rhs[0], is_int, lb, ub)
fnB = shard_map(bodyB, mesh=mesh, in_specs=(P(axes, None),) * 5 + (rep,) * 3,
                out_specs=(rep, rep, rep), check_vma=False)
args = [jnp.asarray(x) for x in (lrow2, col2, val2, lhs2, rhs2, p.is_int, p.lb, p.ub)]
b = collective_bytes(jax.jit(fnB).lower(*args).compile().as_text())
print("ROUNDS", json.dumps([a, b]))
"""


@functools.cache
def _reference_rounds() -> list:
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(
        _REFERENCE_ROUNDS.format(**INSTANCE))], capture_output=True, text=True, env=env,
        timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    line = [x for x in out.stdout.splitlines() if x.startswith("ROUNDS ")][-1]
    return json.loads(line[len("ROUNDS "):])


@functools.cache
def _port_rounds() -> list:
    return world.in_child(world.propagation_rounds, INSTANCE)


@pytest.mark.parametrize("partition", ["nnz", "rows"])
def test_collective_counts_equal_reference_and_lower_sharded(partition):
    """One counted round of each partition on rank 0 of a fake world of 4
    (m = 2,500, n = 1,250, nnz = 40,000, float32, seed 0): 50,000 B (nnz)
    and 10,000 B (rows) of all-reduce, equal to ``lower_sharded``'s and to
    the reference's HLO parse of its rounds on a (2, 2) mesh."""
    recs = _port_rounds()
    rec = recs[0] if partition == "nnz" else recs[1]
    ref = _reference_rounds()[0 if partition == "nnz" else 1]
    want = NNZ_ROUND_BYTES if partition == "nnz" else ROW_ROUND_BYTES
    got = rec["per_round_collective_bytes"]
    assert got == {k: float(v) for k, v in ref.items()}
    assert got["all-reduce"] == got["total"] == want == rec["lower_sharded_bytes"]
    assert rec["matches_lower_sharded"] and rec["world"] == 4
