"""internvl2-1b [vlm]: 24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655
-- InternViT frontend (stub patch embeddings) + Qwen2-0.5B-family LM
[arXiv:2404.16821; hf]."""
from ..models.config import ModelConfig

FULL = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    num_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151655,
    qkv_bias=True,
    rope_theta=1e6,
    tie_embeddings=True,
    frontend="vision",
    n_frontend_tokens=1024,
)

SMOKE = ModelConfig(
    name="internvl2-1b-smoke",
    family="vlm",
    num_layers=2,
    d_model=56,
    n_heads=4,
    n_kv_heads=2,
    head_dim=14,
    d_ff=128,
    vocab_size=256,
    qkv_bias=True,
    tie_embeddings=True,
    frontend="vision",
    n_frontend_tokens=8,
    attn_chunk=32,
    dtype="float32",
)
