"""The port's LM serving path against the reference's for ``deepseek-v2-236b``
(multi-head latent attention, its absorbed decode on the latent cache ``c``
+ rotary key ``kr``, a dense first layer, shared experts), on its SMOKE
config on the CPU, weights carried over from the reference's
``init_params``.

Contracts: as ``tests/test_torch_lm_serve.py`` -- float32 logits and every
cache leaf within ``rtol = atol = 1e-4``, ``generate``'s tokens equal; and,
on the port alone at float64, prefill + 4 decode steps against its full
forward (the reference test's property).
"""
import torch_lm_common as lm

ARCH = "deepseek-v2-236b"


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


def test_prefill_decode_matches_full_forward():
    lm.self_consistency(ARCH)
