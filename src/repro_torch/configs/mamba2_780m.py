"""mamba2-780m [ssm]: 48L d_model=1536 (attention-free) vocab=50280,
ssm_state=128 -- SSD state-space duality [arXiv:2405.21060; unverified]."""
from ..models.config import ModelConfig

FULL = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    num_layers=48,
    d_model=1536,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    attn_type="none",
    ssm_state=128,
    ssm_expand=2,
    ssm_head_p=64,
    ssm_groups=1,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="mamba2-780m-smoke",
    family="ssm",
    num_layers=2,
    d_model=64,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=256,
    attn_type="none",
    ssm_state=16,
    ssm_expand=2,
    ssm_head_p=16,
    ssm_groups=1,
    ssm_chunk=8,
    tie_embeddings=True,
    dtype="float32",
)
