"""The port's LM serving path at bfloat16 against the reference's at
bfloat16, one architecture per cache family (``qwen2-0.5b``: full KV;
``mamba2-780m``: SSM state; ``recurrentgemma-9b``: RG-LRU state and a
rolling window), SMOKE configs with their dtype set to bfloat16 (the FULL
configs' own), weights carried over from the reference's ``init_params``.

Tolerance: bfloat16 keeps 8 significant bits (a step of 2^-8 = 0.0039
relative), and the two packages round at other points (XLA fuses
elementwise chains; the port rounds after each torch op), while the
states and the float32 islands stay float32 in both.  So the forward,
prefill and 4 decode steps' logits differ by a few steps: measured up to
0.0050 (qwen2), 0.0121 (mamba2) and 0.0090 (recurrentgemma) of the largest
|logit|.  Held to 0.03 of it; a cache-layout fault moves logits by O(1) of
it.
"""
import pytest

import torch_lm_common as lm


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-780m", "recurrentgemma-9b"])
def test_bfloat16_against_reference(arch):
    err = lm.bfloat16_errors(arch)
    assert err["dtype"] == "bfloat16"
    assert max(err["forward"], err["prefill"], err["steps"]) <= 0.03, err
