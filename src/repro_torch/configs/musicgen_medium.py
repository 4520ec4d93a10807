"""musicgen-medium [audio]: 48L d_model=1536 24H (MHA kv=24) d_ff=6144
vocab=2048 -- decoder-only over EnCodec tokens [arXiv:2306.05284; hf].

Backbone only (per task spec): the EnCodec/conditioning frontend is a stub
-- ``input_specs()`` provides precomputed conditioning frame embeddings.
Positional encoding is sinusoidal (as in MusicGen); the FFN is modeled with
the shared SwiGLU block (DESIGN.md records this substitution)."""
from ..models.config import ModelConfig

FULL = ModelConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    pos_type="sinusoidal",
    frontend="audio",
    n_frontend_tokens=512,
)

SMOKE = ModelConfig(
    name="musicgen-medium-smoke",
    family="audio",
    num_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    pos_type="sinusoidal",
    frontend="audio",
    n_frontend_tokens=8,
    attn_chunk=32,
    dtype="float32",
)
