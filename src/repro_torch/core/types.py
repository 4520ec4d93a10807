"""Shared value types and numeric conventions for domain propagation.

Conventions (SCIP / PaPILO style, see paper §3.4):
  * Infinite bounds are encoded with the finite sentinel ``INF = 1e20``.
    Any value ``|v| >= INF`` is treated as infinite.  All arithmetic therefore
    stays finite (no NaNs from ``0 * inf``), and "counting infinite
    contributions" is a plain comparison against the sentinel.
  * A *bound change* only counts if it improves the bound by more than a
    scale-aware epsilon -- the tolerance-based termination that guarantees
    finite convergence (§1.1).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

# SCIP-style infinity sentinel.  Values beyond this magnitude are "infinite".
INF = 1e20


def _is_low_precision(dtype) -> bool:
    return dtype in (torch.float32, torch.bfloat16)


# The 16-bit value types.  Their arithmetic rounds to the type after every
# operation (computed in float32, which holds at least 2p + 2 bits of both
# formats, so rounding twice is exact); their sums over a chunk or a merge
# accumulate in float32 and round once, as XLA's reductions of them do.
HALF_DTYPES = (torch.bfloat16, torch.float16)


def is_half(dtype) -> bool:
    return dtype in HALF_DTYPES


def plane_dtype(dtype) -> torch.dtype:
    """The value type of the column max / min planes that the scatters of a
    fixed point at ``dtype`` reduce into: float32 for the 16-bit types (the
    card's atomics take 32-bit words; a 16-bit value widens and narrows
    back exactly), else ``dtype`` itself."""
    return torch.float32 if is_half(dtype) else dtype


@functools.lru_cache(maxsize=256)
def _rounded(x: float, dtype) -> float:
    if dtype == torch.float16:
        with np.errstate(over="ignore"):  # INF overflows to inf, as in the reference
            return float(np.float16(x))  # numpy rounds float64 to float16 once
    return float(torch.tensor(x, dtype=torch.float64).to(dtype))


def rounded(x, dtype) -> float:
    """The Python float ``x`` rounded to ``dtype`` (a torch float type):
    the value that a weakly typed Python scalar takes in the reference's
    arithmetic at that type.  At float16, ``1e-9`` and ``1e-8`` round to
    0.0 and ``INF`` to ``inf``."""
    x = float(x)
    return x if dtype == torch.float64 else _rounded(x, dtype)


def as_values(x, dtype, device=None) -> torch.Tensor:
    """``x`` (numbers, a numpy array or a tensor) as a tensor of ``dtype`` on
    ``device`` (``x``'s own for a tensor, else the CPU).  float16 converts
    through numpy, which rounds float64 once, as the reference's
    ``jnp.asarray`` does (torch goes through float32 first)."""
    if device is None:
        device = x.device if isinstance(x, torch.Tensor) else "cpu"
    if dtype == torch.float16 and not (isinstance(x, torch.Tensor) and x.dtype in
                                       (torch.float16, torch.float32, torch.bfloat16)):
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()
        with np.errstate(over="ignore"):
            x = np.asarray(x, dtype=np.float64).astype(np.float16)
    return torch.as_tensor(x if isinstance(x, torch.Tensor) else np.asarray(x), dtype=dtype,
                           device=device)


def int_round_slack(dtype) -> float:
    """Scale-aware integrality-rounding slack of a tier dtype: ``2**-17`` for
    float32, ``2**-6`` for bfloat16, 0.0 for float64 (exact rounding).  Low
    precision subtracts (adds) ``slack * max(1, |candidate|)`` before the
    ceil (floor), so tier arithmetic error cannot cross an integer."""
    if dtype == torch.float32:
        return 2.0**-17
    if dtype == torch.bfloat16:
        return 2.0**-6
    return 0.0


@dataclasses.dataclass(frozen=True)
class PropagatorConfig:
    """Numeric + termination knobs shared by all propagator implementations."""

    max_rounds: int = 100          # paper §4.1: round cap
    tighten_eps: float = 1e-9      # scale-aware minimum improvement (fp64)
    tighten_eps_f32: float = 1e-5  # minimum improvement when running in fp32
    int_eps: float = 1e-6          # integrality rounding tolerance
    feas_eps: float = 1e-8         # empty-domain detection: l > u + feas_eps
    inf: float = INF
    # fp32-tier outward rounding width (see ``bounds.widen_outward``); must
    # stay < tighten_eps_f32 so accepted updates still make strict progress.
    outward_eps_f32: float = 2.0**-17

    def eps_for(self, dtype) -> float:
        if _is_low_precision(dtype):
            return self.tighten_eps_f32
        return self.tighten_eps

    def outward_for(self, dtype) -> float:
        """Outward-rounding width for a tier dtype (0.0 = exact merge)."""
        return self.outward_eps_f32 if _is_low_precision(dtype) else 0.0


DEFAULT_CONFIG = PropagatorConfig()


@dataclasses.dataclass(frozen=True)
class TierPolicy:
    """Runtime policy for two-tier adaptive precision + progress control
    (the reference's, src/repro/core/types.py:84).

    The *measure of progress* (``bounds.progress_measure``) is a per-round
    device scalar, the scale-normalized total bound movement of the round.
    Two decisions hang off it:

      * **tier switch** (``two_tier``): rounds run in float32 while the
        per-round progress stays >= ``switch_progress``; once it drops below
        for ``patience`` consecutive rounds the bounds are promoted (an
        exact cast: they are outward-rounded, so never inside the float64
        fixed point) and the float64 engine finishes the endgame.
      * **early stop** (``stop_progress``): a fixed point whose progress
        stays below this for ``patience`` rounds stops even though
        epsilon-level changes continue.  ``None`` disables it.
    """

    two_tier: bool = True          # run an fp32 tier before the fp64 endgame
    switch_progress: float = 1e-3  # fp32 tier: promote below this progress
    stop_progress: float | None = None  # early stop threshold (None = off)
    patience: int = 2              # consecutive low-progress rounds to act
    fp32_round_frac: float = 0.5   # fp32 tier's share of the round cap


DEFAULT_TIER_POLICY = TierPolicy()


class Bounds(NamedTuple):
    """Variable domains ``lb <= x <= ub`` (sentinel-infinite)."""

    lb: torch.Tensor  # (n,)
    ub: torch.Tensor  # (n,)


class Activities(NamedTuple):
    """Per-row activity aggregates with infinity counters (paper §3.4).

    ``min_act = -inf`` iff ``min_inf_count > 0`` else ``min_finite``;
    symmetric for the maximum activity."""

    min_finite: torch.Tensor     # (m,) finite part of the minimum activity
    min_inf_count: torch.Tensor  # (m,) int32 number of -inf contributions
    max_finite: torch.Tensor     # (m,) finite part of the maximum activity
    max_inf_count: torch.Tensor  # (m,) int32 number of +inf contributions


class PropagationResult(NamedTuple):
    """Outcome of one propagation fixed point (any engine, any driver).

    Every field is a tensor on the device the fixed point ran on, so a
    result can be returned without reading anything back to the host.
    ``infeasible`` means some variable's domain emptied
    (``lb > ub + feas_eps``)."""

    lb: torch.Tensor          # (n,) tightened lower bounds
    ub: torch.Tensor          # (n,) tightened upper bounds
    rounds: torch.Tensor      # () int32: propagation rounds executed
    converged: torch.Tensor   # () bool: fixed point reached within the cap
    infeasible: torch.Tensor  # () bool: some variable domain became empty
    progress: torch.Tensor    # () last round's progress measure (NaN if none)
    tier_rounds: torch.Tensor  # () int32: rounds run in the fp32 tier (0 if none ran)
    # obs.telemetry.TelemetrySnapshot when the driver was called with a
    # telemetry capacity (lazy: holds device tensors, no read on attach).
    telemetry: object | None = None


def is_pos_inf(v, inf: float = INF):
    return v >= inf


def is_neg_inf(v, inf: float = INF):
    return v <= -inf


def is_inf(v, inf: float = INF):
    return v.abs() >= inf if isinstance(v, torch.Tensor) else abs(v) >= inf


def clamp_to_sentinel(v, inf: float = INF):
    """Clamp values into the representable range [-INF, INF] (a tensor in
    the dtype of ``v``, float64 for Python floats)."""
    t = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
    return torch.clamp(t, -inf, inf)


def np_is_inf(v: np.ndarray, inf: float = INF) -> np.ndarray:
    return np.abs(v) >= inf
