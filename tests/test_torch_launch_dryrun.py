"""The dry-run twin of the reference's ``test_dryrun_cell_small_mesh``:
``lower_cell`` on a ``(2, 2)`` mesh of a fake world of 4 (a child process)
traces granite-3-2b SMOKE's train step (bfloat16, 2 microbatches), prefill
and decode on fake-free meta tensors, with arguments, temporaries and
FLOPs counted; and ``probe_cell``'s linear extrapolation equals the
full-depth trace's count (same probe settings) for the dense and the
``moe`` segments (``first_k_dense``; ``tests/test_torch_launch_probes.py``
has ``mamba2`` and ``pattern``).  Counts are sums of integers: equal to
1e-9 relative."""
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_launch_world as world  # noqa: E402

REL = 1e-9


def check_probe(arch: str, layers: int) -> None:
    (flops, hbm, coll), (f_flops, f_hbm, f_coll) = world.in_child(world.probe_case, arch,
                                                                  layers)
    assert f_flops > 0 and f_hbm > 0 and f_coll["total"] > 0
    assert flops == pytest.approx(f_flops, rel=REL)
    assert hbm == pytest.approx(f_hbm, rel=REL)
    for k, v in f_coll.items():
        assert coll[k] == pytest.approx(v, rel=REL, abs=1e-6), k


def test_dryrun_cell_small_mesh():
    out = world.in_child(world.lower_case)
    train = out["train_4k"]
    assert train["arg_bytes"] > 0 and train["flops"] > 0
    assert train["temp_bytes"] > 0 and train["peak_bytes"] == train["arg_bytes"] + \
        train["temp_bytes"]
    assert train["collectives"]["total"] > 0 and train["hbm_bytes"] > 0
    assert set(train["collectives"]) == {"all-gather", "all-reduce", "reduce-scatter",
                                         "all-to-all", "collective-permute", "total"}
    for name in ("prefill_32k", "decode_32k"):
        assert out[name]["arg_bytes"] > 0 and out[name]["flops"] > 0
    # The train step does about three times a prefill's work per token
    # (forward, backward, the remat recompute): more FLOPs than prefill.
    assert train["flops"] > out["prefill_32k"]["flops"] > out["decode_32k"]["flops"]


@pytest.mark.parametrize("arch,layers", [("granite-3-2b", 4), ("deepseek-v2-236b", 4)])
def test_probe_extrapolation_equals_full_trace(arch, layers):
    check_probe(arch, layers)
