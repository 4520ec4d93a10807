"""PyTorch/CUDA port of the GPU-parallel domain propagation system.

A package of its own beside the JAX reference (``src/repro``): it imports
torch and numpy, never JAX or the reference.  Layout mirrors the reference:

  * ``core``    -- value types, host-side sparse layouts, the plain-PyTorch
                   round and loop drivers (``propagate``), warm-started node
                   batches (``propagate_nodes``) and the device-resident
                   branch-and-bound ``solve``;
  * ``data``    -- seeded instance generators (byte-identical to the
                   reference's);
  * ``kernels`` -- the block-ELL engines (``propagate_block_ell``, the node
                   engine) over hand-written CUDA kernels for Hopper
                   (``csrc/``).

Entry points run on CUDA unless called with ``device="cpu"``.
"""
from .core import (
    BranchRule,
    Problem,
    bounds_equal,
    problem_from_reference,
    propagate,
    propagate_nodes,
    solve,
)
from .kernels import prepare_block_ell, propagate_block_ell

__all__ = [
    "BranchRule",
    "Problem",
    "bounds_equal",
    "problem_from_reference",
    "propagate",
    "propagate_nodes",
    "solve",
    "prepare_block_ell",
    "propagate_block_ell",
]
