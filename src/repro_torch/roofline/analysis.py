"""Roofline analysis from counted dry-run traces.

Three terms per (arch x shape x mesh), on NVIDIA H100 constants:

  compute term    = dot_FLOPs_per_rank       / peak_FLOPs_per_card
  memory term     = HBM_bytes_per_rank       / HBM_bw_per_card
  collective term = collective_bytes_per_rank / NVLink_bw_per_card

The per-rank numbers come from ``roofline.counting.CostCounter``, which
counts the local ops one rank runs (the JAX package parses the optimized
HLO of an SPMD module, whose numbers are per device too).  Collective
bytes are operand sizes of all-gather / all-reduce / reduce-scatter /
all-to-all / collective-permute, the JAX package's convention.

The eager trace runs every layer, so a full-depth trace counts every
layer's FLOPs and collectives; the dry run still traces two shallow
*probe* depths and extrapolates linearly (``launch/dryrun.py``), which
keeps a deep cell's count short.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

# --- NVIDIA H100 SXM5 80 GB: datasheet peaks, not measurements ---
PEAK_FLOPS_BF16 = 989e12       # dense bf16 tensor-core FLOP/s per card (no sparsity)
HBM_BW = 3.35e12               # HBM3 bytes/s per card
NVLINK_BW = 450e9              # NVLink 4 bytes/s per card per direction (900 GB/s both)
ICI_BW = NVLINK_BW             # the JAX package's name for the collective link rate


def collective_bytes(record) -> Dict[str, float]:
    """Sum of collective *operand* bytes by op type (per rank) of a counted
    run: a ``roofline.counting.CostCounter`` or its ``CostRecord``."""
    rec = getattr(record, "record", record)
    return rec.collective_bytes()


@dataclasses.dataclass
class RooflineTerms:
    flops: float               # per device
    bytes_hbm: float           # per device
    bytes_coll: float          # per device
    t_compute: float = 0.0
    t_memory: float = 0.0
    t_collective: float = 0.0

    def finalize(self) -> "RooflineTerms":
        self.t_compute = self.flops / PEAK_FLOPS_BF16
        self.t_memory = self.bytes_hbm / HBM_BW
        self.t_collective = self.bytes_coll / ICI_BW
        return self

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        """Roofline lower-bound step time (max of the three terms)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    def as_dict(self) -> dict:
        return {
            "flops_per_device": self.flops,
            "hbm_bytes_per_device": self.bytes_hbm,
            "collective_bytes_per_device": self.bytes_coll,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "t_bound_s": self.t_bound,
        }


def extrapolate(f1: float, f2: float, n1: int, n2: int, n_full: int) -> float:
    """Linear per-segment-unit extrapolation: cost(n) = f1 + (n-n1)*delta."""
    delta = (f2 - f1) / max(1, (n2 - n1))
    return f1 + (n_full - n1) * delta


def model_flops(n_active_params: int, tokens: int, kind: str) -> float:
    """MODEL_FLOPS convention: 6*N*D train (fwd+bwd), 2*N*D inference."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_active_params * tokens
