"""qwen3-moe-30b-a3b [moe]: 48L d_model=2048 32H (GQA kv=4) d_ff(expert)=768
vocab=151936, MoE 128e top-8, head_dim=128, no shared experts
[hf:Qwen/Qwen3-30B-A3B; hf]."""
from ..models.config import ModelConfig

FULL = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=6144,             # unused (all layers MoE); kept for reference
    vocab_size=151936,
    rope_theta=1e6,
    n_experts=128,
    top_k=8,
    d_ff_expert=768,
    n_shared=0,
)

SMOKE = ModelConfig(
    name="qwen3-moe-30b-a3b-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=32,
    d_ff=128,
    vocab_size=256,
    rope_theta=1e6,
    n_experts=8,
    top_k=2,
    d_ff_expert=32,
    n_shared=0,
    attn_chunk=32,
    dtype="float32",
)
