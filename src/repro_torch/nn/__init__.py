"""Neural-net substrate shared by the assigned architectures (plain PyTorch;
the JAX package's counterparts have no Pallas kernel)."""
from . import attention, ffn, layers, mla, moe, rglru, rope, ssm
