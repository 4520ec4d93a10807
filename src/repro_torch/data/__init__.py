"""Synthetic MIP instance generation (MIPLIB-like structural mixes), numpy."""
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
]
