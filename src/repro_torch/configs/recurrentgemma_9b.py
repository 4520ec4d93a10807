"""recurrentgemma-9b [hybrid]: 38L d_model=4096 16H (MQA kv=1) d_ff=12288
vocab=256000 -- RG-LRU + local attention, pattern (rec, rec, attn)
[arXiv:2402.19427; unverified].  38 layers = 12 full periods + 2-rec tail."""
from ..models.config import ModelConfig

FULL = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    local_window=2048,
    layer_pattern=("rec", "rec", "attn"),
    d_rnn=4096,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="recurrentgemma-9b-smoke",
    family="hybrid",
    num_layers=4,            # one period + 1-layer tail
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    local_window=16,
    layer_pattern=("rec", "rec", "attn"),
    d_rnn=64,
    tie_embeddings=True,
    attn_chunk=16,
    dtype="float32",
)
