"""qwen2-0.5b [dense]: 24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151936
-- GQA, QKV bias [arXiv:2407.10671; hf]."""
from ..models.config import ModelConfig

FULL = ModelConfig(
    name="qwen2-0.5b",
    family="dense",
    num_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1e6,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="qwen2-0.5b-smoke",
    family="dense",
    num_layers=2,
    d_model=56,          # 14-head-like ratio: 4 heads x 14
    n_heads=4,
    n_kv_heads=2,
    head_dim=14,
    d_ff=128,
    vocab_size=256,
    qkv_bias=True,
    rope_theta=1e6,
    tie_embeddings=True,
    attn_chunk=32,
    dtype="float32",
)
