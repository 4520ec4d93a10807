"""Roofline analysis: the three-term model on NVIDIA H100 datasheet peaks
(``analysis``), per-rank counting of an eager step (``counting``, the
counterpart of the JAX package's HLO parsers) and the dry-run tables
(``report``)."""
from .analysis import (
    HBM_BW,
    ICI_BW,
    PEAK_FLOPS_BF16,
    RooflineTerms,
    collective_bytes,
    extrapolate,
    model_flops,
)
