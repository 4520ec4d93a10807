"""Hand-written Hopper kernels of the fused propagation round (``csrc/``),
their PyTorch wrappers and plain versions (``prop_round``, ``ref``), and the
single-instance block-ELL engine (``ops``)."""
from . import ref
from .ops import (
    LRU,
    SCATTER_MAX_NPAD,
    DeviceBlockEll,
    PreparedBlockEll,
    cache_info,
    clear_prepare_cache,
    device_block_ell,
    prepare_block_ell,
    propagate_block_ell,
    round_fn_for,
    rows_fit_one_chunk,
)
from .prop_round import (
    KERNELS,
    activities_gather_tiles,
    apply_updates_tiles,
    candidates_scatter_tiles,
    fused_scatter_round_tiles,
    launch_counts,
    reset_launch_counts,
)

__all__ = [
    "ref",
    "LRU",
    "SCATTER_MAX_NPAD",
    "DeviceBlockEll",
    "PreparedBlockEll",
    "cache_info",
    "clear_prepare_cache",
    "device_block_ell",
    "prepare_block_ell",
    "propagate_block_ell",
    "round_fn_for",
    "rows_fit_one_chunk",
    "KERNELS",
    "activities_gather_tiles",
    "apply_updates_tiles",
    "candidates_scatter_tiles",
    "fused_scatter_round_tiles",
    "launch_counts",
    "reset_launch_counts",
]
