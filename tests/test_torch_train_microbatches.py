"""The port's training path against the reference's with ``microbatches=2``
on ``qwen3-moe-30b-a3b`` (SMOKE config, float32, on the CPU): the gradient
accumulated in ``state_dtype`` over the two halves of the batch, the loss
their mean, and ``moe_aux`` reported as ``0.0`` -- the reference's quirk,
kept.  A file of its own, so that ``--dist loadfile`` runs its compile
beside ``tests/test_torch_train_qwen3_moe.py``'s.

Contracts and tolerances: ``tests/torch_train_common.py``.
"""
import torch_train_common as tc

ARCH = "qwen3-moe-30b-a3b"


def test_microbatches_steps():
    got = tc.port_run(ARCH, "microbatches")
    assert [float(s["metrics"]["moe_aux"]) for s in got["steps"]] == [0.0] * tc.STEPS
    print(ARCH, tc.check_steps(ARCH, "microbatches"))
