"""deepseek-v2-236b [moe]: 60L d_model=5120 128H d_ff(expert)=1536
vocab=102400, MoE 160e top-6, MLA kv_lora=512, 2 shared experts, first layer
dense (d_ff=12288), q_lora=1536, qk nope/rope=128/64, v=128
[arXiv:2405.04434; hf]."""
from ..models.config import ModelConfig

FULL = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    head_dim=128,
    d_ff=12288,            # dense (first) layer width
    vocab_size=102400,
    attn_type="mla",
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    n_experts=160,
    top_k=6,
    d_ff_expert=1536,
    n_shared=2,
    d_ff_shared=3072,      # 2 shared experts x 1536
    first_k_dense=1,
)

SMOKE = ModelConfig(
    name="deepseek-v2-236b-smoke",
    family="moe",
    num_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    attn_type="mla",
    q_lora_rank=32,
    kv_lora_rank=16,
    qk_nope_dim=16,
    qk_rope_dim=8,
    v_head_dim=16,
    n_experts=8,
    top_k=2,
    d_ff_expert=32,
    n_shared=2,
    d_ff_shared=64,
    first_k_dense=1,
    attn_chunk=32,
    dtype="float32",
)
