"""The port's LM serving path against the reference's for the two recurrent
architectures: ``mamba2-780m`` (Mamba-2 SSD segments) and
``recurrentgemma-9b`` (RG-LRU + local attention pattern with a tail), on
their SMOKE configs on the CPU, weights carried over from the reference's
``init_params``.

Contracts: as ``tests/test_torch_lm_serve.py`` -- float32 logits and every
cache leaf (the SSM and RG-LRU states, conv states, rolling KV windows)
within ``rtol = atol = 1e-4``, ``generate``'s tokens equal, and the float64
prefill + decode property of the port against itself at the reference
test's tolerance (bfloat16: ``tests/test_torch_lm_bfloat16.py``).
"""
import pytest
import torch

import torch_lm_common as lm

RECURRENT = ["mamba2-780m", "recurrentgemma-9b"]


@pytest.mark.parametrize("arch", RECURRENT)
def test_forward_train_logits(arch):
    lm.check_forward(arch)


@pytest.mark.parametrize("arch", RECURRENT)
def test_prefill_logits_and_caches(arch):
    lm.check_prefill(arch)


@pytest.mark.parametrize("arch", RECURRENT)
def test_prefill_to_decode_cache(arch):
    lm.check_decode_cache(arch)


@pytest.mark.parametrize("arch", RECURRENT)
def test_decode_steps(arch):
    lm.check_decode_steps(arch)


@pytest.mark.parametrize("arch", RECURRENT)
def test_generate_tokens(arch):
    lm.check_generate(arch)


@pytest.mark.parametrize("arch", RECURRENT)
def test_prefill_decode_matches_full_forward(arch):
    lm.self_consistency(arch)


def test_recurrent_states_stay_float32():
    got = lm.port_run("recurrentgemma-9b")
    seg = got["decode_cache"][0]
    assert seg["sub0"]["h"].dtype == torch.float32
    assert seg["sub2"]["k"].shape[-2] == 16  # the rolling window, local_window = 16
    assert lm.port_run("mamba2-780m")["decode_cache"][0]["h"].dtype == torch.float32
