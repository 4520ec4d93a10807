"""granite-3-8b [dense]: 40L d_model=4096 32H (GQA kv=8) d_ff=12800 vocab=49155
-- GQA [hf:ibm-granite/granite-3.0-2b-base family; hf]."""
from ..models.config import ModelConfig

FULL = ModelConfig(
    name="granite-3-8b",
    family="dense",
    num_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=12800,
    vocab_size=49155,
    rope_theta=10000.0,
)

SMOKE = ModelConfig(
    name="granite-3-8b-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=160,
    vocab_size=256,
    attn_chunk=32,
    dtype="float32",
)
