"""PyTorch/CUDA port of the GPU-parallel domain propagation system.

A package of its own beside the JAX reference (``src/repro``): it imports
torch and numpy, never JAX or the reference.  Layout mirrors the reference:

  * ``core``    -- value types, host-side sparse layouts, the plain-PyTorch
                   round and loop drivers (``propagate``);
  * ``data``    -- seeded instance generators (byte-identical to the
                   reference's);
  * ``kernels`` -- the block-ELL engine (``propagate_block_ell``) over four
                   hand-written CUDA kernels for Hopper (``csrc/``).

Entry points run on CUDA unless called with ``device="cpu"``.
"""
from .core import Problem, bounds_equal, problem_from_reference, propagate
from .kernels import prepare_block_ell, propagate_block_ell

__all__ = [
    "Problem",
    "bounds_equal",
    "problem_from_reference",
    "propagate",
    "prepare_block_ell",
    "propagate_block_ell",
]
