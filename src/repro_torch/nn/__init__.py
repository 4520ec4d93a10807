"""Neural-net substrate shared by the assigned architectures (plain PyTorch;
the JAX package's counterparts have no Pallas kernel).

``mla`` and ``moe`` (multi-head latent attention, mixture of experts) are
not ported yet: ROADMAP Queue 1 item 15, part two.
"""
from . import attention, ffn, layers, rglru, rope, ssm
