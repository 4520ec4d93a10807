"""``probe_cell``'s extrapolation equals the full-depth trace's count for
the ``mamba2`` and ``pattern`` (RecurrentGemma: periods and a tail)
segments (``tests/test_torch_launch_dryrun.py`` has the others); the
propagation dry run's record on both production meshes equals
``lower_sharded``'s; the dry-run CLI writes its records and ``report.py``
reads them; heads that do not divide over the "model" ranks trace through
the model's explicit redistribution, and raise without it."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.core.sharded import lower_sharded
from repro_torch.launch import dryrun
from repro_torch.roofline import report
from test_torch_launch_dryrun import check_probe, world

SRC = Path(__file__).resolve().parent.parent / "src"


@pytest.mark.parametrize("arch,layers", [("mamba2-780m", 4), ("recurrentgemma-9b", 10)])
def test_probe_extrapolation_equals_full_trace(arch, layers):
    check_probe(arch, layers)


def test_propagation_dryrun_records(monkeypatch):
    """The 16 M-nnz instance's per-round all-reduce on 256 and 512 ranks:
    4 m + 2 n float32 values, the reference's per-round collectives."""
    p = dryrun.propagation_instance(m=1_000, n=500, nnz=16_000)
    monkeypatch.setattr(dryrun, "propagation_instance", lambda: p)
    recs = dryrun.run_propagation_dryrun([], None, ["single", "multi"])
    assert [r["mesh"] for r in recs] == ["single", "multi"]
    for r, world in zip(recs, (256, 512)):
        low = lower_sharded(p, world)
        assert r["collective_by_op_per_round"]["all-reduce"] == (4 * 1_000 + 2 * 500) * 4
        assert r["collective_by_op_per_round"]["total"] == sum(
            c.bytes for c in low.collectives_per_round)
        assert r["arg_bytes"] == low.arg_bytes_per_rank and r["fits_hbm"]


def test_cli_skips_and_reports(tmp_path):
    """``python -m repro_torch.launch.dryrun`` records a cell the shape does
    not support (long_500k on a full-attention arch) without tracing it,
    and ``report.py`` prints its tables from the file."""
    out = tmp_path / "dryrun.json"
    env = {"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"}
    run = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                          "granite-3-2b", "--shape", "long_500k", "--out", str(out)],
                         capture_output=True, text=True, env=env, timeout=120)
    assert run.returncode == 0, run.stderr[-2000:]
    (rec,) = json.loads(out.read_text())
    assert rec["supported"] is False and "infeasible" in rec["skip_reason"]
    assert "skip" in report.dryrun_table([rec])
    shown = subprocess.run([sys.executable, "-m", "repro_torch.roofline.report", str(out)],
                           capture_output=True, text=True, env=env, timeout=120)
    assert shown.returncode == 0 and "documented skips: 1" in shown.stdout


def test_uneven_heads_are_redistributed_explicitly():
    """Heads that do not divide over the "model" ranks trace through the
    model's own redistribution; without it the trace raises (no op is
    retried on another placement behind the model's back)."""
    flops = world.in_child(world.uneven_heads_case)
    assert isinstance(flops, dict), flops
    assert flops["train_4k"] > flops["decode_32k"] > 0
    err = world.in_child(world.uneven_heads_case, False)
    assert isinstance(err, str), err
    print(err[:300])
