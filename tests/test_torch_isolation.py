"""The PyTorch port stands alone: importing it loads neither JAX nor the JAX
package, and its entry points refuse to fall back to the CPU."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch as rt
import repro_torch.data as td

SRC = Path(__file__).resolve().parent.parent / "src"


def test_import_loads_no_jax_and_no_reference():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.core, repro_torch.data, repro_torch.kernels\n"
        "import repro_torch.kernels._build, repro_torch.core.nodes, repro_torch.core.solver\n"
        "import repro_torch.kernels.slab, repro_torch.kernels.prop_round\n"
        "import repro_torch.core.service, repro_torch.obs, repro_torch.obs.metrics\n"
        "import repro_torch.obs.trace, repro_torch.core.seq_ref, repro_torch.core.presolve\n"
        "import repro_torch.data.mps, repro_torch.core.sharded\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_sources_name_no_jax():
    pkg = SRC / "repro_torch"
    for path in pkg.rglob("*.py"):
        text = path.read_text()
        assert "import jax" not in text and "from jax" not in text, path
        assert "from repro." not in text and "import repro." not in text, path
        assert "from repro import" not in text, path


def _call(name, p, **kw):
    if name == "propagate_nodes":
        return rt.propagate_nodes(p, p.lb[None], p.ub[None], **kw)
    if name == "solve":
        return rt.solve(p, np.ones(p.n), **kw)
    if name == "propagate_batch":
        return rt.propagate_batch([p, p], **kw)
    if name == "PropagationService":
        return rt.PropagationService.from_problems([p], slots=2, **kw).serve([p])
    if name == "analyze_constraints":
        return rt.core.analyze_constraints(p.csr.row_ids(), p.csr.val, p.csr.col, p.lhs, p.rhs,
                                           p.lb, p.ub, p.m, **kw)
    return getattr(rt, name)(p, **kw)


@pytest.mark.parametrize("call", ["propagate", "propagate_block_ell", "prepare_block_ell",
                                  "propagate_nodes", "solve", "propagate_batch",
                                  "PropagationService", "analyze_constraints"])
def test_entry_points_default_to_cuda(call):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable here")
    p = td.make_set_cover(n=20, m=8, seed=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _call(call, p)
    _call(call, p, device="cpu")  # the explicit request runs


def test_wrappers_refuse_devices_other_than_cpu_and_cuda():
    """Only a CPU tensor takes the plain version: a tensor on any other
    device is refused, never copied to the CPU."""
    from repro_torch.kernels import apply_updates_tiles

    z = torch.zeros(4, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        apply_updates_tiles(z, z, z, z, 1e-9)
