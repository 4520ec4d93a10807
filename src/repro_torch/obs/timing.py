"""Fenced timing utilities for the benchmarks (and anything else).

CUDA launches are asynchronous: a wall clock around ``fn()`` times the
enqueue unless the result is fenced.  :func:`fence` waits for the card of
every CUDA tensor in a result (it does nothing for CPU tensors), and the
rest keeps the reference's method (``src/repro/obs/timing.py``):
:func:`time_fenced` takes the best of ``repeats`` after ``warmup``
unmeasured calls (the minimum: the least-noise estimate for deterministic
work); :func:`paired_trials` interleaves the variants A/B/A/B per trial so
that drift hits each alike, and :func:`median_ratio` reduces the per-trial
ratios by their median, robust to one noisy trial.
"""
from __future__ import annotations

import dataclasses
import statistics
import time

import torch


def _cuda_devices(x, out: set) -> None:
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            out.add(x.device)
    elif isinstance(x, dict):
        for v in x.values():
            _cuda_devices(v, out)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _cuda_devices(v, out)
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            _cuda_devices(getattr(x, f.name), out)


def fence(x):
    """Wait until ``x`` (a tensor, or any nesting of tuples, lists, dicts
    and dataclasses holding tensors) has materialized: synchronize the CUDA
    device of every CUDA tensor in it.  CPU tensors need nothing.  Returns
    ``x``."""
    devices: set = set()
    _cuda_devices(x, devices)
    for dev in devices:
        torch.cuda.synchronize(dev)
    return x


def time_fenced(fn, repeats: int = 3, warmup: int = 1) -> float:
    """Best-of-``repeats`` wall seconds of ``fn()``, fencing its result
    inside the timed region, after ``warmup`` unmeasured calls."""
    for _ in range(warmup):
        fence(fn())
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fence(fn())
        best = min(best, time.perf_counter() - t0)
    return best


def paired_trials(fns, trials: int = 5, repeats: int = 3, warmup: int = 1):
    """Interleaved timing of variants: ``trials`` rows of per-variant
    seconds.  Each trial times the zero-argument callables ``fns`` in order
    (each by :func:`time_fenced`), so slow drift lands on every variant.
    Returns a list of ``len(fns)``-tuples, one per trial."""
    fns = list(fns)
    for fn in fns:  # shared warmup, outside every timed region
        for _ in range(warmup):
            fence(fn())
    return [
        tuple(time_fenced(fn, repeats=repeats, warmup=0) for fn in fns)
        for _ in range(trials)
    ]


def median_of(trials, idx: int) -> float:
    """Median across trials of variant ``idx``'s seconds."""
    return statistics.median(t[idx] for t in trials)


def median_ratio(trials, num: int = 0, den: int = 1) -> float:
    """Median across trials of the per-trial ratio ``t[num] / t[den]``."""
    return statistics.median(t[num] / t[den] for t in trials)


def time_phases(phases, repeats: int = 3, warmup: int = 1, tracer=None) -> dict:
    """Time named zero-argument callables: ``{name: microseconds}``, each
    fenced and best-of timed on its own.  With a ``tracer``
    (``obs.trace.Tracer``) each phase's timed region is also a span named
    ``phase:<name>``."""
    out = {}
    for name, fn in dict(phases).items():
        if tracer is not None:
            with tracer.span(f"phase:{name}", repeats=repeats):
                t = time_fenced(fn, repeats=repeats, warmup=warmup)
        else:
            t = time_fenced(fn, repeats=repeats, warmup=warmup)
        out[name] = t * 1e6
    return out
