"""The port's training path against the reference's for ``qwen3-moe-30b-a3b``
(GQA, 8 experts top 2 in every layer; the MoE load-balance loss in the
total), SMOKE config at float32 on the CPU, weights carried over from the
reference's ``init_params``.  ``microbatches=2`` on this arch:
``tests/test_torch_train_microbatches.py``.

One file per arch, so that ``--dist loadfile`` spreads the reference's
compiles over workers.  Contracts and tolerances:
``tests/torch_train_common.py``.
"""
import torch_train_common as tc

ARCH = "qwen3-moe-30b-a3b"


def test_loss_and_parts():
    tc.check_loss(ARCH)


def test_grads_leaf_by_leaf():
    tc.check_grads(ARCH)


def test_two_train_steps():
    print(ARCH, tc.check_steps(ARCH))


def test_remat_grads_bitwise():
    tc.check_remat_bitwise(ARCH)
