"""The port's LM serving path against the reference's for the other three
dense-family architectures: ``chatglm3-6b`` (partial rotary: half the head
dimension rotated), ``musicgen-medium`` (sinusoidal positions, audio frame
embeddings prepended) and ``internvl2-1b`` (QKV bias, vision patch
embeddings prepended), on their SMOKE configs on the CPU, weights carried
over from the reference's ``init_params``.

Contracts: as ``tests/test_torch_lm_serve.py`` -- float32 logits and every
cache leaf within ``rtol = atol = 1e-4``, ``generate``'s tokens equal.
"""
import pytest

import torch_lm_common as lm

BACKBONES = ["chatglm3-6b", "musicgen-medium", "internvl2-1b"]


@pytest.mark.parametrize("arch", BACKBONES)
def test_forward_train_logits(arch):
    lm.check_forward(arch)


@pytest.mark.parametrize("arch", BACKBONES)
def test_prefill_logits_and_caches(arch):
    lm.check_prefill(arch)


@pytest.mark.parametrize("arch", BACKBONES)
def test_prefill_to_decode_cache(arch):
    lm.check_decode_cache(arch)


@pytest.mark.parametrize("arch", BACKBONES)
def test_decode_steps(arch):
    lm.check_decode_steps(arch)


@pytest.mark.parametrize("arch", BACKBONES)
def test_generate_tokens(arch):
    lm.check_generate(arch)
