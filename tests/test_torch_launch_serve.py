"""Sharded serving on a ``(2, 2)`` mesh over four gloo ranks:
``make_prefill_fn(cfg, mesh)`` on a data-sharded prompt, the caches
converted by ``prefill_to_decode_cache`` and four greedy
``make_serve_step(cfg, mesh)`` decodes, each step's logits held to the
port's unsharded prefill and decodes on the same weights (1e-5 of the
logits' scale; those are held to the reference's by
``test_torch_lm_serve*.py``).  The cases place the decode cache as
``cache_spec`` does, 32 slots split over their sequence (each rank's
partial softmax over its own slots): granite-3-2b SMOKE's two KV heads,
and deepseek-v2-236b SMOKE's MLA latent.
"""
import numpy as np
import torch

import launch_step_common as c
from repro_torch.configs import get_config
from repro_torch.models import params_from_reference
from repro_torch.train import serve_step as ss


def _unsharded(steps_logits, arch, s_max):
    tree, batch = c.weights(arch)
    b, prompt, steps = c.SERVE
    cfg = get_config(arch, smoke=True)
    model = params_from_reference(cfg, tree, device="cpu")
    toks = torch.as_tensor(batch["tokens"][:b, :prompt])
    logits, caches = ss.make_prefill_fn(cfg)(model, toks)
    cache = ss.prefill_to_decode_cache(cfg, caches, prompt, s_max or prompt + steps)
    out = [logits.numpy()]
    for i in range(steps):
        tok = torch.as_tensor(steps_logits[i][:, -1]).argmax(-1)[:, None].to(torch.int32)
        logits, cache = ss.make_serve_step(cfg)(model, tok, cache, prompt + i)
        out.append(logits.numpy())
    return out


def check_serving(arch: str, s_max: int) -> None:
    ranks = c.sharded((), serve=True, arch=arch, s_max=s_max)
    got = ranks[0]["serve"]
    for r in ranks[1:]:  # the gathered logits are the same on every rank
        for a, b in zip(r["serve"], got):
            np.testing.assert_array_equal(a, b)
    want = _unsharded(got, arch, s_max)
    assert len(got) == len(want) == c.SERVE[2] + 1
    for a, b in zip(got, want):
        scale = float(np.abs(b).max())
        assert float(np.abs(a - b).max()) <= c.PORT_TOL * scale


def test_sharded_prefill_and_decodes_match_unsharded():
    check_serving(c.ARCH, 32)


def test_sharded_mla_prefill_and_decodes_match_unsharded():
    check_serving("deepseek-v2-236b", 32)
