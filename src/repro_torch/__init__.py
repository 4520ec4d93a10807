"""PyTorch/CUDA port of the GPU-parallel domain propagation system.

A package of its own beside the JAX reference (``src/repro``): it imports
torch and numpy, never JAX or the reference.  Layout mirrors the reference:

  * ``core``    -- value types, host-side sparse layouts, the plain-PyTorch
                   round and loop drivers (``propagate``), batches of
                   instances (``propagate_batch``) and the continuous-
                   batching ``PropagationService``, warm-started node
                   batches (``propagate_nodes``) and the device-resident
                   branch-and-bound ``solve``;
  * ``data``    -- seeded instance generators (byte-identical to the
                   reference's);
  * ``kernels`` -- the block-ELL engines (``propagate_block_ell``, the batched
                   and node engines) over hand-written CUDA kernels for
                   Hopper (``csrc/``);
  * ``obs``     -- the device telemetry of every fixed point
                   (``telemetry=``), span tracing, the metrics registry
                   behind the service's ``stats()``, run metadata and
                   fenced timing.

Entry points run on CUDA unless called with ``device="cpu"``.
"""
from .core import (
    BranchRule,
    BucketSpec,
    Problem,
    PropagationService,
    bounds_equal,
    evict_slot,
    pack_into_slot,
    pack_problems,
    problem_from_reference,
    propagate,
    propagate_batch,
    propagate_nodes,
    solve,
)
from .kernels import prepare_block_ell, propagate_block_ell

__all__ = [
    "BranchRule",
    "BucketSpec",
    "Problem",
    "PropagationService",
    "bounds_equal",
    "evict_slot",
    "pack_into_slot",
    "pack_problems",
    "problem_from_reference",
    "propagate",
    "propagate_batch",
    "propagate_nodes",
    "solve",
    "prepare_block_ell",
    "propagate_block_ell",
]
