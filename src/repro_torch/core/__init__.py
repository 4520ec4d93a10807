"""Core library of the PyTorch port: value types, the host-side sparse
layouts (numpy), and the plain-PyTorch propagation round and loop drivers.
Imports torch and numpy only."""
from .activities import activity_values, compute_activities
from .bounds import apply_updates, canonical_infinite, progress_measure, widen_outward
from .propagator import (
    DeviceProblem,
    bounds_equal,
    check_infeasible,
    initial_bounds,
    propagate,
    propagation_round,
)
from .sparse import (
    CSC,
    CSR,
    LANE,
    BlockEll,
    Problem,
    chunk_stream,
    col_pad,
    csr_from_coo,
    csr_from_dense,
    csr_to_block_ell,
    csr_to_csc,
    problem_from_reference,
)
from .types import (
    DEFAULT_CONFIG,
    INF,
    Activities,
    Bounds,
    PropagationResult,
    PropagatorConfig,
    int_round_slack,
)

__all__ = [
    "activity_values",
    "compute_activities",
    "apply_updates",
    "canonical_infinite",
    "progress_measure",
    "widen_outward",
    "DeviceProblem",
    "bounds_equal",
    "check_infeasible",
    "initial_bounds",
    "propagate",
    "propagation_round",
    "CSC",
    "CSR",
    "LANE",
    "BlockEll",
    "Problem",
    "chunk_stream",
    "col_pad",
    "csr_from_coo",
    "csr_from_dense",
    "csr_to_block_ell",
    "csr_to_csc",
    "problem_from_reference",
    "DEFAULT_CONFIG",
    "INF",
    "Activities",
    "Bounds",
    "PropagationResult",
    "PropagatorConfig",
    "int_round_slack",
]
