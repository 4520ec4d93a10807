"""Synthetic MIP instance generation (MIPLIB-like structural mixes) and a
free-format MPS reader/writer, numpy.  The deterministic LM token pipeline
is ``data.tokens`` (not exported here, as in the JAX package)."""
from .instances import (
    FAMILIES,
    SIZE_SETS,
    InstanceSpec,
    instances_for_set,
    make_assignment,
    make_banded,
    make_bin_packing,
    make_cascade_chain,
    make_instance,
    make_knapsack,
    make_mixed,
    make_pseudo_boolean,
    make_random_mip,
    make_set_cover,
)
from .mps import read_mps, write_mps

__all__ = [
    "FAMILIES",
    "SIZE_SETS",
    "InstanceSpec",
    "instances_for_set",
    "make_assignment",
    "make_banded",
    "make_bin_packing",
    "make_cascade_chain",
    "make_instance",
    "make_knapsack",
    "make_mixed",
    "make_pseudo_boolean",
    "make_random_mip",
    "make_set_cover",
    "read_mps",
    "write_mps",
]
