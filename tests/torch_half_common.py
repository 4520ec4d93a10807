"""Helpers shared by the CPU tests of the port's 16-bit value types
(``test_torch_half.py``: the single-instance engines;
``test_torch_half_batch.py``: the batched, node, service and sharded entry
points): the instances, 16-bit arrays crossing between the packages
through their bits, the float16 ulp distance and the contract's
comparison, the reference's round closure driven to its fixed point, and
the one-thread fixture."""
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.core as rc
import repro.core.bounds as rbnd
import repro.data as rd
import repro_torch as rt

DTYPES = {"bf16": (torch.bfloat16, jnp.bfloat16), "f16": (torch.float16, jnp.float16)}
CFG = rt.core.DEFAULT_CONFIG
RCFG = rc.DEFAULT_CONFIG
_REF_PROGRESS = jax.jit(rbnd.progress_measure)
# The reference's own float16 spread (plain round closure against its Pallas
# kernels at their fixed points, mixed, every engine): 1 ulp.
F16_ULPS = 1

# name: (generator, kwargs, bitwise at float16).
INSTANCES = {
    "set_cover": ("make_set_cover", dict(seed=0), True),
    "knapsack": ("make_knapsack", dict(seed=0), True),
    "cascade": ("make_cascade_chain", dict(length=24), True),
    "pb": ("make_pseudo_boolean", dict(n=120, m=240, seed=0), True),
    "banded": ("make_banded", dict(n=150, m=300, row_nnz=12, band=40, seed=0), False),
    "mixed": ("make_mixed", dict(m=300, n=150, seed=0, density=0.02), False),
}


@functools.lru_cache(maxsize=None)
def _instance(name):
    gen, kw, _ = INSTANCES[name]
    pr = getattr(rd, gen)(**kw)
    return pr, rt.problem_from_reference(pr)


def _t(x):
    """A reference array as a tensor, 16-bit ones through their bits."""
    a = np.asarray(x)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _j(x):
    """A tensor as a reference array, bfloat16 through its bits."""
    if x.dtype == torch.bfloat16:
        return jnp.asarray(x.contiguous().view(torch.int16).numpy().view(ml_dtypes.bfloat16))
    return jnp.asarray(x.numpy())


def _ulps(a, b):
    """Distances in units in the last place of two 16-bit tensors; both
    infinite (same sign) count 0."""
    def ordered(x):
        bits = x.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)

    both = torch.isinf(a) & torch.isinf(b) & (torch.sign(a) == torch.sign(b))
    return torch.where(both, 0, (ordered(a) - ordered(b)).abs())


def _assert_same(got, want, bitwise=True, nan=False):
    """16-bit values equal by value, or within F16_ULPS; NaN nowhere, or
    (``nan``) where both hold it."""
    for g, w in zip(got, want):
        g, w = _t(g) if not isinstance(g, torch.Tensor) else g, (
            _t(w) if not isinstance(w, torch.Tensor) else w)
        assert g.shape == w.shape
        if not g.is_floating_point():  # counts: the reference's are int64 under x64
            assert bool((g.long() == w.long()).all())
            continue
        assert g.dtype == w.dtype
        both = torch.isnan(g) & torch.isnan(w)
        assert (nan or not both.any()) and not (torch.isnan(g) ^ torch.isnan(w)).any()
        g, w = torch.where(both, 0, g), torch.where(both, 0, w)
        if bitwise:
            assert bool((g == w).all()), int((g != w).sum())
        else:
            assert g.numel() == 0 or int(_ulps(g, w).max()) <= F16_ULPS


def _bitwise(name, dtype):
    return dtype == "bf16" or INSTANCES[name][2]


def _drive(fn, lb, ub, max_rounds=CFG.max_rounds, stop=None, patience=1):
    """A reference round closure driven to its fixed point as its while loop
    runs it (the early stop folded per round, src/repro/kernels/ops.py:
    1290-1310): ``(lb, ub, rounds, changed, progress history)``."""
    rounds, changed, flat, hist = 0, True, 0, []
    while changed and rounds < max_rounds and (stop is None or flat < patience):
        nlb, nub, ch = fn(lb, ub)
        prog = _REF_PROGRESS(lb, ub, nlb, nub)
        hist.append(prog)
        if stop is not None:
            flat = flat + 1 if bool(prog < stop) else 0
        lb, ub, changed, rounds = nlb, nub, bool(ch), rounds + 1
    return lb, ub, rounds, changed, hist


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The port's CPU runs in one thread: the test workers share the host's
    cores, and torch's threads at every small 16-bit op then cost more
    than they save (a fixed point ran 15x slower with the default)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
