"""ModelConfig: one dataclass covering all 10 assigned architectures, plus
the input-shape registry (train_4k / prefill_32k / decode_32k / long_500k)
and ``input_specs()``.

The JAX package's stand-ins are shape-and-dtype structs; here they are
tensors on the ``meta`` device, which carry a shape and a dtype and allocate
nothing.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # attention
    attn_type: str = "gqa"       # gqa | mla | none
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    partial_rotary: float = 1.0  # fraction of head_dim rotated (chatglm3: 0.5)
    pos_type: str = "rope"       # rope | sinusoidal (musicgen backbone stub)
    local_window: Optional[int] = None
    # MoE
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    n_shared: int = 0
    d_ff_shared: int = 0
    first_k_dense: int = 0       # deepseek-v2: first layer(s) dense
    moe_aux_coef: float = 0.001
    capacity_factor: float = 1.25
    # MLA
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_p: int = 64
    ssm_groups: int = 1
    ssm_chunk: int = 128
    # hybrid (recurrentgemma 1:2 pattern)
    layer_pattern: Tuple[str, ...] = ()  # e.g. ("rec","rec","attn")
    d_rnn: int = 0
    # modality frontend stubs
    frontend: str = "none"       # none | vision | audio
    n_frontend_tokens: int = 0   # patch/frame embeddings injected at prefill
    # numerics / compute
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    attn_chunk: int = 512        # blockwise attention tile
    remat: bool = True
    dtype: str = "bfloat16"
    # Lowering controls of the JAX package's dry-run probes, kept field for
    # field; the port runs eagerly and reads neither (its layer and chunk
    # loops are Python loops either way).
    scan_layers: bool = True
    unroll_inner: bool = False
    # §Perf hillclimb levers (baseline keeps both off):
    causal_skip: bool = False    # triangular attention tile schedule
    seq_shard: bool = False      # Megatron-style sequence-parallel residual

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run long_500k? (SSM / hybrid-local-attn only.)"""
        if self.attn_type == "none":
            return True
        if self.layer_pattern and self.local_window is not None:
            return True
        return False

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_p

    def segments(self):
        """Homogeneous layer segments [(kind, count)] for scan-over-layers."""
        if self.layer_pattern:
            period = len(self.layer_pattern)
            full, rem = divmod(self.num_layers, period)
            segs = []
            if full:
                segs.append(("pattern", full))
            if rem:
                segs.append((f"pattern_tail{rem}", 1))
            return segs
        if self.attn_type == "none":
            return [("mamba2", self.num_layers)]
        if self.n_experts > 0:
            segs = []
            if self.first_k_dense:
                segs.append(("dense", self.first_k_dense))
            segs.append(("moe", self.num_layers - self.first_k_dense))
            return segs
        return [("dense", self.num_layers)]


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": InputShape("train_4k", "train", 4096, 256),
    "prefill_32k": InputShape("prefill_32k", "prefill", 32768, 32),
    "decode_32k": InputShape("decode_32k", "decode", 32768, 128),
    "long_500k": InputShape("long_500k", "decode", 524288, 1),
}


def cell_supported(cfg: ModelConfig, shape: InputShape) -> Tuple[bool, str]:
    """Is (arch x shape) runnable? (long_500k needs sub-quadratic attention.)"""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "full-attention arch: 512k decode KV infeasible (DESIGN.md)"
    return True, ""


# ---------------------------------------------------------------------------
# Input specs (meta tensors only -- never allocates)
# ---------------------------------------------------------------------------


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _cache_specs(cfg: ModelConfig, batch: int, s_max: int):
    """List (one entry per segment) of meta tensors in the decode cache
    layout (must mirror models.transformer.init_cache).  As in the JAX
    package, the activation dtype here is bfloat16 for ``dtype="bfloat16"``
    and float32 for every other dtype."""
    sds = _sds
    act = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    segs = []
    for kind, count in cfg.segments():
        if kind == "mamba2":
            conv_ch = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
            segs.append(
                {
                    "conv": sds((count, batch, 3, conv_ch), act),
                    "h": sds(
                        (count, batch, cfg.ssm_heads, cfg.ssm_head_p, cfg.ssm_state),
                        torch.float32,
                    ),
                }
            )
        elif kind.startswith("pattern"):
            n_sub = (
                len(cfg.layer_pattern)
                if kind == "pattern"
                else int(kind.replace("pattern_tail", ""))
            )
            sub = {}
            for i in range(n_sub):
                sk = cfg.layer_pattern[i]
                if sk == "rec":
                    sub[f"sub{i}"] = {
                        "h": sds((count, batch, cfg.d_rnn), torch.float32),
                        "conv": sds((count, batch, 3, cfg.d_rnn), act),
                    }
                else:  # local attn, rolling window
                    w = min(cfg.local_window, s_max)
                    sub[f"sub{i}"] = {
                        "k": sds((count, batch, cfg.n_kv_heads, w, cfg.head_dim), act),
                        "v": sds((count, batch, cfg.n_kv_heads, w, cfg.head_dim), act),
                    }
            segs.append(sub)
        elif cfg.attn_type == "mla":
            segs.append(
                {
                    "c": sds((count, batch, s_max, cfg.kv_lora_rank), act),
                    "kr": sds((count, batch, s_max, cfg.qk_rope_dim), act),
                }
            )
        else:
            w = s_max if cfg.local_window is None else min(cfg.local_window, s_max)
            segs.append(
                {
                    "k": sds((count, batch, cfg.n_kv_heads, w, cfg.head_dim), act),
                    "v": sds((count, batch, cfg.n_kv_heads, w, cfg.head_dim), act),
                }
            )
    return segs


def input_specs(cfg: ModelConfig, shape: InputShape):
    """Meta-tensor stand-ins for every model input of this cell."""
    sds = _sds
    b = shape.global_batch
    s = shape.seq_len
    act = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    if shape.kind == "train":
        specs = {
            "tokens": sds((b, s), torch.int32),
            "labels": sds((b, s), torch.int32),
        }
        if cfg.frontend != "none":
            nf = cfg.n_frontend_tokens or 1024
            specs["frontend_embeds"] = sds((b, nf, cfg.d_model), act)
            specs["tokens"] = sds((b, s - nf), torch.int32)
            specs["labels"] = sds((b, s - nf), torch.int32)
        return specs
    if shape.kind == "prefill":
        specs = {"tokens": sds((b, s), torch.int32)}
        if cfg.frontend != "none":
            nf = cfg.n_frontend_tokens or 1024
            specs["frontend_embeds"] = sds((b, nf, cfg.d_model), act)
            specs["tokens"] = sds((b, s - nf), torch.int32)
        return specs
    # decode: one new token against a cache of size seq_len
    return {
        "tokens": sds((b, 1), torch.int32),
        "pos": sds((), torch.int32),
        "cache": _cache_specs(cfg, b, s),
    }
