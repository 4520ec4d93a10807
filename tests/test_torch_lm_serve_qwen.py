"""The port's LM serving path against the reference's for ``qwen2-0.5b``
(GQA with QKV bias, tied embeddings, RoPE theta 1e6), on its SMOKE config on
the CPU, weights carried over from the reference's ``init_params``.

Contracts: as ``tests/test_torch_lm_serve.py`` -- float32 logits and every
cache leaf within ``rtol = atol = 1e-4``, ``generate``'s tokens equal.
"""
import torch_lm_common as lm

ARCH = "qwen2-0.5b"


def test_forward_train_logits():
    lm.check_forward(ARCH)


def test_prefill_logits_and_caches():
    lm.check_prefill(ARCH)


def test_prefill_to_decode_cache():
    lm.check_decode_cache(ARCH)


def test_decode_steps():
    lm.check_decode_steps(ARCH)


def test_generate_tokens():
    lm.check_generate(ARCH)
