"""chatglm3-6b [dense]: 28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024
-- 2d/partial RoPE (half the head dim rotated), GQA [arXiv:2406.12793; hf]."""
from ..models.config import ModelConfig

FULL = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    num_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab_size=65024,
    partial_rotary=0.5,
    rope_theta=10000.0,
)

SMOKE = ModelConfig(
    name="chatglm3-6b-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    partial_rotary=0.5,
    attn_chunk=32,
    dtype="float32",
)
