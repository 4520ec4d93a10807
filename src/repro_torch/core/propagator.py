"""GPU-parallel domain propagation (paper Algorithm 2), in plain PyTorch.

One *round* (Alg. 3 at nonzero granularity):

  1. activities + infinity counters per row        (segment-sum over nonzeros)
  2. residual activities + bound candidates        (elementwise over nonzeros)
  3. column-wise best candidate                    (segment-max/min over nonzeros)
  4. integrality rounding + monotone update        (elementwise over columns)

This is the port's own oracle for the block-ELL kernel engine
(``kernels.propagate_block_ell``): it shares no code with the tile layout.

Loop drivers (paper §3.7 / App. C), as the reference's:

  * ``host_loop``   -- one round per iteration; the host reads the round's
                       flag to decide the exit (:func:`fixed_point`).
  * ``device_loop`` -- the round's last kernel keeps the reference's
                       ``while_loop`` carry on the device (``core.carry``):
                       the host enqueues rounds and reads the carry once per
                       :func:`loop_group` check groups
                       (:func:`device_fixed_point`).  Rounds enqueued after
                       convergence change nothing and count nothing.
  * ``unrolled``    -- ``device_loop`` with ``unroll`` rounds per check.

Every host read is reported to ``on_sync``.  The batched fixed point
(``batched_fixed_point``, the node engine's, the solver's and the service's
loop) still reads its ``active.any()`` flag on the host once per round; its
per-row early stop (``stop_progress``) follows the reference's loop body,
each row's measure taken by the round's merge (#9) where the round closure
is ``measured``.

The precision tiers (the reference's, src/repro/core/propagator.py:595):
every driver takes the progress-based early stop (``stop_progress``,
``patience``: the loop carry's ``FLAT``, folded by the round's last kernel
or by :func:`core.carry.fold`), and :func:`propagate` the two-tier
:class:`~repro_torch.core.types.TierPolicy` (:func:`run_tiers`): a float32
tier that stops below ``switch_progress``, promotion by exact cast, and the
float64 endgame.
"""
from __future__ import annotations

import dataclasses
import math
import threading
from typing import Callable

import numpy as np
import torch

from . import activities as act
from . import bounds as bnd
from .carry import GO, LAST, ROUNDS, EarlyStop, LoopCarry, early_stop, fold, go_flag, progress_of
from .sparse import Problem
from .types import DEFAULT_CONFIG, INF, PropagationResult, PropagatorConfig, TierPolicy

# The drivers of ``propagate`` and of ``kernels.propagate_block_ell`` (and
# the batched front ends), as the reference's.
DRIVERS = ("host_loop", "device_loop", "unrolled")
KERNEL_DRIVERS = ("host_loop", "device_loop")

# Check groups that device_fixed_point enqueues between two host reads of
# the loop carry (read at call time, by loop_group).  More means fewer
# reads and up to that many groups less one enqueued after convergence.
# Where every kernel of such a round returns at once (a closure whose
# ``gated`` is true) a wasted round costs its launches; elsewhere (the
# plain rounds, the segment engine's gather and column reduction) it costs
# a whole round.  chip_smoke.py times 1, 2, 4, 8 and 16 for both on the
# H100 (PERF.md).
DEVICE_LOOP_GROUP = 8
UNGATED_LOOP_GROUP = 2


def loop_group(round_fn) -> int:
    """Check groups between two host reads of the device loop for the round
    closure ``round_fn``: :data:`DEVICE_LOOP_GROUP` where a round enqueued
    after convergence is skipped on the device (``round_fn.gated``), else
    :data:`UNGATED_LOOP_GROUP`."""
    return DEVICE_LOOP_GROUP if getattr(round_fn, "gated", False) else UNGATED_LOOP_GROUP


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  CUDA is never silently replaced
    by the CPU: asking for it without a GPU raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev


# The part of ROADMAP Queue 1 item 5 (precision tiers) still to port: every
# value type but float32 and float64 (bfloat16; float16 is no tier of the
# reference).
TIERS_REMAINDER = "item 5, remainder"

_DTYPES = {"float64": torch.float64, "float32": torch.float32, "float16": torch.float16,
           "bfloat16": torch.bfloat16}


def torch_dtype(dtype) -> torch.dtype | None:
    """``dtype`` (a torch or numpy dtype, or None for float64) as a torch
    dtype; None for a type that is none of the floats."""
    if dtype is None:
        return torch.float64
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _DTYPES.get(np.dtype(dtype).name)
    except TypeError:
        return None


def check_dtype(dtype) -> torch.dtype:
    """The value type of a fixed point: float64 (the default) or float32 (the
    fp32 tier); any other raises ``NotImplementedError``."""
    dt = torch_dtype(dtype)
    if dt in (torch.float64, torch.float32):
        return dt
    raise NotImplementedError(
        f"dtype={dtype!r}: float64 and float32 are ported; other value types are "
        f"ROADMAP Queue 1 {TIERS_REMAINDER}"
    )


class DeviceProblem:
    """A :class:`Problem` as tensors on one device (nonzero-level layout)."""

    def __init__(self, p: Problem, dtype=None, device="cuda"):
        dev = resolve_device(device)
        dt = check_dtype(dtype)
        csr = p.csr
        t = lambda x, d=dt: torch.as_tensor(np.asarray(x), dtype=d, device=dev)
        self.m = csr.m
        self.n = csr.n
        self.nnz = csr.nnz
        self.row_id = t(csr.row_ids(), torch.int64)
        self.col = t(csr.col, torch.int64)
        self.val = t(csr.val)
        self.lhs = t(p.lhs)
        self.rhs = t(p.rhs)
        self.lb0 = t(p.lb)
        self.ub0 = t(p.ub)
        self.is_int = t(p.is_int, torch.bool)
        self.dtype = dt
        self.device = dev


def propagation_round(
    row_id, col, val, lhs, rhs, is_int, lb, ub,
    m: int, n: int, eps: float, int_eps: float, inf: float = INF,
    outward: float = 0.0,
):
    """Pure function: one parallel propagation round.  Returns (lb, ub, changed)."""
    min_fin, min_inf, max_fin, max_inf = act.nnz_contributions(val, lb[col], ub[col], inf)
    seg = lambda x: act.segment_sum(x, row_id, m)[row_id]
    min_res = act.residual_activities(
        val, min_fin, min_inf, seg(min_fin), seg(min_inf), "min", inf
    )
    max_res = act.residual_activities(
        val, max_fin, max_inf, seg(max_fin), seg(max_inf), "max", inf
    )
    lcand, ucand = bnd.bound_candidates(val, lhs[row_id], rhs[row_id], min_res, max_res, inf)
    lcand, ucand = bnd.round_candidates(lcand, ucand, is_int[col], int_eps, inf)
    # Columns with no nonzeros keep the IEEE identity (-inf / +inf), which
    # never passes the improvement test.
    best_l = torch.full((n,), -math.inf, dtype=lb.dtype, device=lb.device)
    best_u = torch.full((n,), math.inf, dtype=lb.dtype, device=lb.device)
    best_l.scatter_reduce_(0, col, lcand, "amax")
    best_u.scatter_reduce_(0, col, ucand, "amin")
    return bnd.apply_updates(lb, ub, best_l, best_u, eps, inf, outward)


def check_infeasible(lb, ub, feas_eps: float):
    return (lb > ub + feas_eps).any()


def initial_bounds(defaults, lb0=None, ub0=None):
    """Resolve the warm-start bound overrides of a driver call.

    ``(lb0, ub0)`` are runtime arguments: ``None`` falls back to the
    default bounds.  The returned tensors are private copies, so a fixed
    point that updates its bounds in place never touches caller-held or
    cached buffers."""
    default_lb, default_ub = defaults

    def pick(override, default):
        if override is None:
            return default.clone()
        arr = torch.as_tensor(override, dtype=default.dtype, device=default.device)
        if arr.shape != default.shape:
            raise ValueError(
                f"bounds override has shape {tuple(arr.shape)}, expected {tuple(default.shape)}"
            )
        return arr.clone()

    return pick(lb0, default_lb), pick(ub0, default_ub)


def _stop_carry(round_fn, stop: EarlyStop | None):
    """The loop carry of ``round_fn`` (None if it has none); an early stop
    needs one."""
    carry = getattr(round_fn, "carry", None)
    if stop is not None and carry is None:
        raise ValueError("the early stop needs a round closure with a loop carry")
    return carry


def _carried_progress(state: list, like: torch.Tensor) -> torch.Tensor:
    """The progress measure the carry kept (read on the host as ``state``),
    as a 0-d tensor of ``like``'s dtype and device."""
    return torch.tensor(progress_of(state, like.dtype), dtype=like.dtype, device=like.device)


def fixed_point(
    round_fn, lb, ub, max_rounds: int, on_sync: Callable[[], None] | None = None,
    with_progress: bool = True, stop: EarlyStop | None = None,
):
    """Iterate ``round_fn(lb, ub) -> (lb, ub, changed)`` until a round changes
    nothing or ``max_rounds`` rounds ran.

    ``round_fn`` may update its bound tensors in place.  The progress
    measure is that of the last round, which needs its pre-round bounds only
    if it changed something, that is only if ``max_rounds`` cut the loop:
    so the bounds are copied before the last allowed round alone.
    ``with_progress=False`` skips the measure (progress NaN).  Each round
    reads ``changed`` on the host once (one sync, reported to ``on_sync``).
    A round closure with a loop carry (its ``carry``) has it armed for the
    fixed point, one round per check group.  With an early stop ``stop``
    (:class:`core.carry.EarlyStop`) armed in that carry, each round's last
    kernel (or :func:`core.carry.fold`) computes the round's measure and
    clears GO once it stayed low ``stop.patience`` rounds: the host reads
    the whole carry instead of the flag (still one read a round) and stops
    on GO, and the measure is the carry's.  Returns ``(lb, ub, rounds,
    changed, progress)``."""
    prog = torch.tensor(math.nan, dtype=lb.dtype, device=lb.device)
    lb_in, ub_in = lb, ub
    rounds, changed = 0, True
    carry = _stop_carry(round_fn, stop)
    if carry is not None:
        carry.arm(lb.device, stop=stop)
    try:
        while changed and rounds < max_rounds:
            if with_progress and stop is None and rounds + 1 == max_rounds:
                lb_in, ub_in = lb.clone(), ub.clone()
            lb, ub, ch = round_fn(lb, ub)
            rounds += 1
            if stop is None:
                changed = bool(ch)
            else:
                state = carry.read()
                changed = bool(state[LAST])
            if on_sync is not None:
                on_sync()
            if stop is not None and not state[GO]:
                break
    finally:
        if carry is not None:
            carry.release()
    if rounds and stop is not None:
        prog = _carried_progress(state, lb)
    elif rounds and with_progress:
        # A round that changed nothing left its bounds as they were.
        prog = bnd.progress_measure(lb_in, ub_in, lb, ub) if changed else (
            bnd.progress_measure(lb, ub, lb, ub)
        )
    return lb, ub, rounds, changed, prog


def device_fixed_point(
    round_fn, lb, ub, max_rounds: int, unroll: int = 1,
    on_sync: Callable[[], None] | None = None, with_progress: bool = True,
    stop: EarlyStop | None = None,
):
    """The reference's ``_device_fixed_point``
    (src/repro/core/propagator.py:272) over a round closure with a loop
    carry (``round_fn.carry``, :class:`core.carry.LoopCarry`): check groups
    of ``unroll`` rounds, each begun while the carry's GO is set, until a
    group changes nothing or ``ceil(max_rounds / unroll)`` groups ran.

    The host enqueues :func:`loop_group` groups (read at call time), then
    reads the carry once (one pinned copy and a wait, reported to
    ``on_sync``), and stops when GO is clear or the groups are spent; the
    round's last kernel keeps the carry, so a group enqueued after
    convergence changes neither the bounds nor the counts.  ``rounds`` is
    the reference's: a multiple of ``unroll``, which may pass
    ``max_rounds``.  The progress measure is the last check group's, which
    needs its starting bounds only if it changed something, that is only if
    the cap cut the loop: so the bounds are copied before the last allowed
    group alone.  With an early stop ``stop`` armed in the carry (as in
    :func:`fixed_point`, per check group) GO also clears once the measure
    stayed low ``stop.patience`` groups; ``changed`` is then the carry's
    ``LAST`` and the measure its own.  Returns ``(lb, ub, rounds, changed,
    progress)``."""
    if unroll < 1:
        raise ValueError(f"unroll={unroll}: a check group holds at least one round")
    prog = torch.tensor(math.nan, dtype=lb.dtype, device=lb.device)
    groups = -(-max_rounds // unroll) if max_rounds > 0 else 0
    if groups == 0:
        return lb, ub, 0, True, prog
    carry: LoopCarry = _stop_carry(round_fn, stop) or round_fn.carry
    lb_in = ub_in = None
    done, per_read = 0, loop_group(round_fn)
    carry.arm(lb.device, unroll, stop)
    try:
        while True:
            batch = min(per_read, groups - done)
            for g in range(done, done + batch):
                if with_progress and stop is None and g + 1 == groups:
                    lb_in, ub_in = lb.clone(), ub.clone()
                for _ in range(unroll):
                    lb, ub, _ = round_fn(lb, ub)
            done += batch
            state = carry.read()
            if on_sync is not None:
                on_sync()
            if not state[GO] or done == groups:
                break
    finally:
        carry.release()
    if stop is not None:
        return lb, ub, state[ROUNDS], bool(state[LAST]), _carried_progress(state, lb)
    changed = bool(state[GO])
    if with_progress:
        # A group that changed nothing left its bounds as they were.
        prog = bnd.progress_measure(lb_in, ub_in, lb, ub) if changed else (
            bnd.progress_measure(lb, ub, lb, ub)
        )
    return lb, ub, state[ROUNDS], changed, prog


def _batched_rounds(
    round_fn, lb, ub, active, last_changed, rounds, max_rounds: int, *,
    rounds_hi: int, with_progress: bool, progress, on_sync, budget: int | None = None,
):
    """The loop of :func:`batched_step_rounds`: one round, then one host
    read of ``active.any()``, until no row is active or ``budget`` rounds
    ran.  The first round runs unconditionally; with no active row it
    changes nothing.

    Rounds update the bound planes in place where ``round_fn`` does, so the
    progress measure keeps pre-round copies, and only of the rounds that
    may be a row's last in this call: those in which an active row may run
    its last allowed round (``rounds_hi`` is the largest incoming round
    count of an active row), and the budget's last round.  A row whose last
    round changed nothing has progress exactly 0.0; a row cut by
    ``max_rounds`` or still active at the budget's end gets the measure of
    its last round."""
    lb_in = ub_in = None
    ran = torch.zeros_like(active)
    k = 0
    while True:
        last_step = budget is not None and k + 1 >= budget
        if with_progress and (last_step or rounds_hi + k + 1 >= max_rounds):
            if lb_in is None:
                lb_in, ub_in = lb.clone(), ub.clone()
            else:
                lb_in = torch.where(active[:, None], lb, lb_in)
                ub_in = torch.where(active[:, None], ub, ub_in)
        lb, ub, changed = round_fn(lb, ub, active)
        rounds = rounds + active.to(rounds.dtype)
        ran = ran | active
        last_changed = torch.where(active, changed, last_changed)
        active = active & changed & (rounds < max_rounds)
        k += 1
        go = bool(active.any())
        if on_sync is not None:
            on_sync()
        if not go or last_step:
            break
    if with_progress:
        cut = ran & last_changed
        last = torch.zeros_like(progress)
        if lb_in is not None:
            last = torch.where(cut, bnd.progress_measure(lb_in, ub_in, lb, ub), last)
        progress = torch.where(ran, last, progress)
    return lb, ub, active, last_changed, rounds, progress


def _batched_stop_rounds(
    round_fn, lb, ub, active, last_changed, rounds, max_rounds: int, *, stop: EarlyStop,
    progress, flat, on_sync, budget: int | None = None,
):
    """The loop of :func:`batched_step_rounds` with the per-row early stop
    armed: the reference's loop body (src/repro/core/propagator.py:388-414).
    Every round measures each active row's progress: by the round's merge
    where ``round_fn`` is ``measured`` (it takes ``progress=``, a ``(B,)``
    tensor, and writes the active rows' measures into it: #9's kernel, or
    its plain version in the same order), else from copies of the planes
    (:func:`bounds.progress_measure`).  Then, as ``(B,)`` operations on the
    device, ``flat = where(active, where(prog < stop, flat + 1, 0), flat)``
    and ``active &= changed & (rounds < max_rounds) & (flat < patience)``;
    one host read of ``active.any()`` a round.  Returns the state and
    ``(progress, flat)``."""
    measured = getattr(round_fn, "measured", False)
    progress = progress.clone()
    k = 0
    while True:
        if measured:
            lb, ub, changed = round_fn(lb, ub, active, progress=progress)
        else:
            lb_in, ub_in = lb.clone(), ub.clone()
            lb, ub, changed = round_fn(lb, ub, active)
            progress = torch.where(active, bnd.progress_measure(lb_in, ub_in, lb, ub), progress)
        rounds = rounds + active.to(rounds.dtype)
        last_changed = torch.where(active, changed, last_changed)
        flat = torch.where(active, torch.where(progress < stop.progress, flat + 1, 0), flat)
        active = active & changed & (rounds < max_rounds) & (flat < stop.patience)
        k += 1
        go = bool(active.any())
        if on_sync is not None:
            on_sync()
        if not go or (budget is not None and k >= budget):
            break
    return lb, ub, active, last_changed, rounds, progress, flat


def _check_plane(plane):
    if plane is not None:
        not_ported("plane=", "item 6 (observability)")


def batched_step_rounds(
    round_fn, lb, ub, active, last_changed, rounds, max_rounds: int,
    budget: int | None = None, *,
    stop_progress: float | None = None, patience: int = 1,
    progress=None, flat=None, with_progress: bool = False,
    plane=None, feas_eps: float | None = None,
    on_sync: Callable[[], None] | None = None,
):
    """Run up to ``budget`` rounds of a batched fixed point from a carried
    state (all of them to the end when ``budget`` is None).

    ``round_fn(lb, ub, active) -> (lb, ub, changed)`` works on ``(B, n_pad)``
    bound planes and ``(B,)`` masks; it may update the planes in place and
    must leave inactive rows as they are.  The state ``(lb, ub, active,
    last_changed, rounds)`` is the reference's loop carry; rows drop out of
    ``active`` when a round changes nothing or ``max_rounds`` is reached.
    Returns that state, and with ``with_progress=True`` also ``(progress,
    flat)``: each row's last-round progress measure (the carried
    ``progress``, NaN by default, for rows that ran no round) and the
    carried low-progress streak.  The state is resumable: feeding one
    call's output to the next continues every row's trajectory bit for
    bit, so a fixed point chunked by any budget ends where one call does,
    progress included.  This is the service's bounded step.

    ``stop_progress``/``patience`` arm the per-row early stop, as the
    reference's: a row whose round's progress measure stays below
    ``stop_progress`` for ``patience`` consecutive rounds drops out of
    ``active`` with ``last_changed`` still true (stopped, not converged);
    every round a row runs is then measured, and ``(progress, flat)`` are
    carried as the rest of the state (:func:`_batched_stop_rounds`).

    The loop reads ``active.any()`` on the host once per round, reported to
    ``on_sync``; without a stop, ``with_progress`` takes one more read of
    the incoming round counts.  ``plane=`` (item 6) raises
    ``NotImplementedError``."""
    del feas_eps  # the telemetry probe's tolerance; telemetry is not ported
    _check_plane(plane)
    stop = early_stop(stop_progress, patience)
    bsz = lb.shape[0]
    if progress is None:
        progress = torch.full((bsz,), math.nan, dtype=lb.dtype, device=lb.device)
    if flat is None:
        flat = torch.zeros((bsz,), dtype=torch.int32, device=lb.device)
    if budget is not None and budget < 1:
        out = (lb, ub, active, last_changed, rounds)
        return out + (progress, flat) if with_progress else out
    if stop is not None:
        out = _batched_stop_rounds(round_fn, lb, ub, active, last_changed, rounds, max_rounds,
                                   stop=stop, progress=progress, flat=flat, on_sync=on_sync,
                                   budget=budget)
        return out if with_progress else out[:5]
    rounds_hi = 0
    if with_progress:
        rounds_hi = int(torch.where(active, rounds, 0).max())
        if on_sync is not None:
            on_sync()
    lb, ub, active, last_changed, rounds, progress = _batched_rounds(
        round_fn, lb, ub, active, last_changed, rounds, max_rounds,
        rounds_hi=rounds_hi, with_progress=with_progress, progress=progress,
        on_sync=on_sync, budget=budget,
    )
    if with_progress:
        return lb, ub, active, last_changed, rounds, progress, flat
    return lb, ub, active, last_changed, rounds


def batched_fixed_point(
    round_fn, lb0, ub0, max_rounds: int, active0=None, *,
    stop_progress: float | None = None, patience: int = 1,
    with_progress: bool = False, plane=None, feas_eps: float | None = None,
    on_sync: Callable[[], None] | None = None,
):
    """Batched fixed point with a per-row convergence mask.

    ``round_fn(lb, ub, active) -> (lb, ub, changed)`` as in
    :func:`batched_step_rounds`.  The loop runs until every row has
    converged or hit ``max_rounds``; a row whose round changed nothing
    drops out of ``active`` and its bounds are frozen.  Per-row ``rounds``
    and ``converged`` match what each row would see in its own
    single-instance fixed point.  ``active0`` (default: all rows) freezes
    rows from the start.

    Returns ``(lb, ub, rounds, converged)``; ``with_progress=True`` appends
    the per-row last-round progress measure.  ``stop_progress``/
    ``patience`` arm the per-row early stop (:func:`batched_step_rounds`):
    a stopped row reports ``converged=False`` at ``rounds < max_rounds``.
    One host read of ``active.any()`` per round, reported to
    ``on_sync``."""
    del feas_eps
    _check_plane(plane)
    bsz = lb0.shape[0]
    dev = lb0.device
    if active0 is None:
        active0 = torch.ones((bsz,), dtype=torch.bool, device=dev)
    progress = torch.full((bsz,), math.nan, dtype=lb0.dtype, device=dev)
    stop = early_stop(stop_progress, patience)
    if stop is not None:
        lb, ub, _, last_changed, rounds, progress, _ = _batched_stop_rounds(
            round_fn, lb0, ub0, active0, active0,
            torch.zeros((bsz,), dtype=torch.int32, device=dev), max_rounds, stop=stop,
            progress=progress, flat=torch.zeros((bsz,), dtype=torch.int32, device=dev),
            on_sync=on_sync,
        )
        return (lb, ub, rounds, ~last_changed) + ((progress,) if with_progress else ())
    lb, ub, _, last_changed, rounds, progress = _batched_rounds(
        round_fn, lb0, ub0, active0, active0,
        torch.zeros((bsz,), dtype=torch.int32, device=dev), max_rounds,
        rounds_hi=0, with_progress=with_progress, progress=progress,
        on_sync=on_sync,
    )
    if with_progress:
        return lb, ub, rounds, ~last_changed, progress
    return lb, ub, rounds, ~last_changed


def propagate_batch(
    problems,
    cfg: PropagatorConfig = DEFAULT_CONFIG,
    tile_rows: int = 8,
    tile_width: int = 128,
    dtype=None,
    use_kernels: bool = True,
    driver: str = "device_loop",
    bounds=None,
    slab: int | None = None,
    stop_progress: float | None = None,
    patience: int = 1,
    policy=None,
    telemetry=None,
    device="cuda",
    on_sync: Callable[[], None] | None = None,
) -> "list[PropagationResult]":
    """Propagate a batch of instances, a whole bucket per fixed point.

    Front end over the batched block-ELL engine: instances are bucketed by
    padded column width (``core.sparse.pack_problems``), each bucket runs
    its fixed point with a per-instance convergence mask, and results come
    back as one ``PropagationResult`` per instance, input order (``(n_i,)``
    bounds each, tensors on ``device``).  Buckets past
    ``kernels.ops.SCATTER_MAX_NPAD`` columns run the column-slab
    partitioned round.  ``bounds`` (one ``(lb_i, ub_i)`` pair or ``None``
    per problem) warm-starts instances without repacking; packing, upload
    and runners are cached on the identity of the problem list
    (``kernels.cache_info()``).  ``use_kernels=False`` runs the kernels'
    plain versions.  ``device`` defaults to CUDA and raises where there is
    none.  ``dtype`` is float64 (the default) or float32;
    ``stop_progress``/``patience`` arm the per-instance early stop and
    ``policy`` (a :class:`TierPolicy`) the two tiers (``tier_rounds`` per
    instance).  ``telemetry=`` raises ``NotImplementedError``.  See
    ``kernels.ops.propagate_batch_block_ell``."""
    from ..kernels.ops import propagate_batch_block_ell  # lazy: kernels imports core

    return propagate_batch_block_ell(
        problems, cfg=cfg, tile_rows=tile_rows, tile_width=tile_width, dtype=dtype,
        use_kernels=use_kernels, driver=driver, bounds=bounds, slab=slab,
        stop_progress=stop_progress, patience=patience, policy=policy, telemetry=telemetry,
        device=device, on_sync=on_sync,
    )


def _result(lb, ub, rounds, changed, prog, feas_eps) -> PropagationResult:
    dev = lb.device
    return PropagationResult(
        lb=lb,
        ub=ub,
        rounds=torch.tensor(rounds, dtype=torch.int32, device=dev),
        converged=torch.tensor(not changed, device=dev),
        infeasible=check_infeasible(lb, ub, feas_eps),
        progress=prog,
        tier_rounds=torch.zeros((), dtype=torch.int32, device=dev),
    )


def not_ported(name: str, entry: str):
    raise NotImplementedError(f"{name} is not ported yet: ROADMAP Queue 1 {entry}")


def _refuse_telemetry(telemetry) -> None:
    if telemetry is not None:
        not_ported("telemetry=", "item 6 (observability)")


def _plain_round_fn(dp: DeviceProblem, eps: float, int_eps: float, inf: float,
                    outward: float):
    """The plain round (:func:`propagation_round`) as a ``(lb, ub) -> (lb,
    ub, changed)`` closure with a loop carry (its ``carry``): the round's
    bounds where the carry's GO is set (else the bounds as they were), its
    flag folded into the carry (``core.carry.fold``), ``changed`` the
    carry's GO.  With an early stop armed in the carry, the last round of
    each check group folds the group's progress measure
    (:func:`bounds.progress_measure` from the bounds the group started
    from).  Torch ops only, no kernel."""
    carry = LoopCarry()
    group = threading.local()  # the bounds each check group starts from

    def round_fn(lb, ub):
        state, k, unroll = carry.step(lb.device)
        stop = carry.stop
        if stop is not None and k == 0:
            group.start = (lb, ub)  # the round allocates its outputs
        new_lb, new_ub, ch = propagation_round(
            dp.row_id, dp.col, dp.val, dp.lhs, dp.rhs, dp.is_int, lb, ub,
            dp.m, dp.n, eps, int_eps, inf, outward,
        )
        go = go_flag(state)
        new_lb, new_ub = torch.where(go, new_lb, lb), torch.where(go, new_ub, ub)
        prog = None
        if stop is not None and k == unroll - 1:
            prog = bnd.progress_measure(*group.start, new_lb, new_ub)
        fold(state, ch, k, unroll, stop, prog)
        return new_lb, new_ub, go

    round_fn.carry = carry
    return round_fn


def _round_fn(dp: DeviceProblem, cfg: PropagatorConfig):
    return _plain_round_fn(dp, cfg.eps_for(dp.dtype), cfg.int_eps, cfg.inf,
                           cfg.outward_for(dp.dtype))


def propagate_host_loop(
    dp: DeviceProblem,
    cfg: PropagatorConfig = DEFAULT_CONFIG,
    lb0=None,
    ub0=None,
    stop_progress: float | None = None,
    patience: int = 1,
    telemetry=None,
    *,
    on_sync: Callable[[], None] | None = None,
) -> PropagationResult:
    """cpu_loop analogue (the reference's, src/repro/core/propagator.py:200):
    the host runs the plain round and reads its flag once per round
    (:func:`fixed_point`, each read reported to ``on_sync``).  ``lb0``/
    ``ub0`` warm-start the fixed point from ``(n,)`` bounds.
    ``stop_progress``/``patience`` arm the progress-based early stop (the
    round's measure read with its flag, in the same read); progress is NaN
    without it, as the reference's.  ``telemetry=`` (item 6) raises
    ``NotImplementedError``."""
    _refuse_telemetry(telemetry)
    lb, ub = initial_bounds((dp.lb0, dp.ub0), lb0, ub0)
    out = fixed_point(_round_fn(dp, cfg), lb, ub, cfg.max_rounds, on_sync, with_progress=False,
                      stop=early_stop(stop_progress, patience))
    return _result(*out, cfg.feas_eps)


def propagate_device_loop(
    dp: DeviceProblem,
    cfg: PropagatorConfig = DEFAULT_CONFIG,
    unroll: int = 1,
    lb0=None,
    ub0=None,
    stop_progress: float | None = None,
    patience: int = 1,
    telemetry=None,
    *,
    on_sync: Callable[[], None] | None = None,
) -> PropagationResult:
    """gpu_loop analogue (the reference's, src/repro/core/propagator.py:533):
    the plain round's check groups of ``unroll`` rounds enqueued against
    the loop carry on the device (:func:`device_fixed_point`), the carry
    read on the host once per :data:`UNGATED_LOOP_GROUP` groups (each read
    reported to ``on_sync``).  ``rounds`` is the reference's (a multiple of
    ``unroll``), ``progress`` the last check group's measure.  Options as
    in :func:`propagate_host_loop` (the early stop per check group)."""
    _refuse_telemetry(telemetry)
    lb, ub = initial_bounds((dp.lb0, dp.ub0), lb0, ub0)
    out = device_fixed_point(_round_fn(dp, cfg), lb, ub, cfg.max_rounds, unroll, on_sync,
                             stop=early_stop(stop_progress, patience))
    return _result(*out, cfg.feas_eps)


def propagate_unrolled(
    dp: DeviceProblem,
    cfg: PropagatorConfig = DEFAULT_CONFIG,
    unroll: int = 4,
    lb0=None,
    ub0=None,
    stop_progress: float | None = None,
    patience: int = 1,
    telemetry=None,
    *,
    on_sync: Callable[[], None] | None = None,
) -> PropagationResult:
    """The reference's megakernel-flavored driver
    (src/repro/core/propagator.py:578): :func:`propagate_device_loop` with
    ``unroll`` rounds per convergence check."""
    return propagate_device_loop(
        dp, cfg, unroll=unroll, lb0=lb0, ub0=ub0, stop_progress=stop_progress,
        patience=patience, telemetry=telemetry, on_sync=on_sync,
    )


def two_tier_bounds_dtypes(policy: TierPolicy, dtype):
    """The ``(fp32 tier, endgame)`` dtype pair of a tiered run, or None where
    the policy degenerates to one tier (disabled, or the requested dtype is
    already low-precision): the reference's
    (src/repro/core/propagator.py:595)."""
    final = torch_dtype(dtype)
    if final is None:
        check_dtype(dtype)  # raises: not a float type
    if not policy.two_tier or final in (torch.float32, torch.bfloat16):
        return None
    return torch.float32, final


def run_tiers(single: Callable, cfg: PropagatorConfig, dtype, lb0, ub0, policy,
              stop_progress: float | None = None, patience: int = 1,
              on_sync: Callable[[], None] | None = None) -> PropagationResult:
    """The two-tier front end of :func:`propagate` and
    ``kernels.propagate_block_ell`` (the reference's,
    src/repro/core/propagator.py:612-680 and src/repro/kernels/ops.py:1201-1245)
    over ``single(cfg, dtype, lb0, ub0, stop_progress, patience) ->
    PropagationResult``, one single-dtype fixed point.

    Without a two-tier ``policy`` one fixed point runs, with the policy's
    early stop where one is given.  Otherwise a float32 tier of at most
    ``max(1, int(max_rounds * fp32_round_frac))`` rounds runs, early-stopped
    below ``switch_progress`` for ``patience`` rounds (its merges widen
    outward, so its bounds never pass the float64 fixed point).  An fp32
    infeasible verdict is never trusted: the endgame reruns from the
    original bounds in the final dtype.  Otherwise the tier's bounds are
    promoted by an exact cast with the infinite sentinels restored
    (:func:`bounds.canonical_infinite`), and the endgame runs at most
    ``max(1, max_rounds - tier_rounds)`` rounds from them; ``rounds`` is
    both tiers' and ``tier_rounds`` the tier's.  The tier's verdict and
    round count are read on the host at once (one read, reported to
    ``on_sync``)."""
    pair = two_tier_bounds_dtypes(policy, dtype) if policy is not None else None
    if pair is None:
        if policy is not None:
            stop_progress, patience = policy.stop_progress, policy.patience
        return single(cfg, dtype, lb0, ub0, stop_progress, patience)
    dt32, final = pair
    cap32 = max(1, int(cfg.max_rounds * policy.fp32_round_frac))
    r32 = single(dataclasses.replace(cfg, max_rounds=cap32), dt32, lb0, ub0,
                 policy.switch_progress, policy.patience)
    infeasible, tier_rounds = torch.stack([r32.infeasible.to(torch.int32), r32.rounds]).tolist()
    if on_sync is not None:
        on_sync()
    if infeasible:
        r = single(cfg, final, lb0, ub0, policy.stop_progress, policy.patience)
        return r._replace(tier_rounds=r32.rounds)
    rem = dataclasses.replace(cfg, max_rounds=max(1, cfg.max_rounds - tier_rounds))
    warm_lb, warm_ub = bnd.canonical_infinite(r32.lb.to(final), r32.ub.to(final))
    r = single(rem, final, warm_lb, warm_ub, policy.stop_progress, policy.patience)
    return r._replace(rounds=r.rounds + r32.rounds, tier_rounds=r32.rounds)


def propagate(
    p: Problem,
    cfg: PropagatorConfig = DEFAULT_CONFIG,
    driver: str = "device_loop",
    dtype=None,
    lb0=None,
    ub0=None,
    policy: TierPolicy | None = None,
    telemetry=None,
    device="cuda",
    on_sync: Callable[[], None] | None = None,
) -> PropagationResult:
    """Problem -> PropagationResult with the plain-PyTorch round (no tiles,
    no kernels).

    ``driver`` picks the loop as the reference's does: ``host_loop`` reads
    a flag on the host each round, ``device_loop`` keeps the loop state on
    the device and reads it once per :data:`UNGATED_LOOP_GROUP` rounds,
    ``unrolled`` checks convergence every 4 rounds.  ``dtype`` is float64
    (the default) or float32.  ``lb0``/``ub0`` are ``(n,)`` warm-start
    overrides for this call only.  ``device`` defaults to CUDA and raises
    where there is none; pass ``device="cpu"`` to run on the CPU.
    ``on_sync`` is called once per host read of the loop state.
    ``progress`` is the last check's measure on ``device_loop`` and
    ``unrolled`` and NaN on ``host_loop``, as in the reference.

    ``policy`` (a :class:`TierPolicy`) turns on the runtime progress
    control: with ``two_tier`` an fp32 tier, promotion and the endgame in
    ``dtype`` (:func:`run_tiers`; ``result.tier_rounds`` counts the tier's
    rounds), and ``stop_progress`` early-stops flatlined runs.
    ``telemetry=`` (item 6) raises ``NotImplementedError``."""
    _refuse_telemetry(telemetry)
    if driver not in DRIVERS:
        raise ValueError(f"unknown driver: {driver}")

    def single(cfg_, dtype_, lb0_, ub0_, stop_progress, patience):
        return _propagate_single(p, cfg_, driver, dtype_, lb0_, ub0_, stop_progress, patience,
                                 device=device, on_sync=on_sync)

    return run_tiers(single, cfg, dtype, lb0, ub0, policy, on_sync=on_sync)


def _propagate_single(
    p: Problem, cfg, driver, dtype, lb0, ub0, stop_progress=None, patience: int = 1, *,
    device="cuda", on_sync: Callable[[], None] | None = None,
) -> PropagationResult:
    """One single-dtype fixed point of :func:`propagate` (the tiered front
    end calls this twice)."""
    dp = DeviceProblem(p, dtype=dtype, device=device)
    run = {"host_loop": propagate_host_loop, "device_loop": propagate_device_loop,
           "unrolled": propagate_unrolled}[driver]
    return run(dp, cfg, lb0=lb0, ub0=ub0, stop_progress=stop_progress, patience=patience,
               on_sync=on_sync)


def fresh_instance_runner(p: Problem, cfg: PropagatorConfig = DEFAULT_CONFIG, device="cuda"):
    """The reference's re-upload baseline (src/repro/core/propagator.py:724):
    returns ``propagate_fresh(lb, ub) -> (lb, ub, rounds)``.  Each call
    expands the CSR row structure on the host again and uploads the whole
    matrix again, treating the node as a brand-new instance, then runs the
    plain round's device loop (:func:`device_fixed_point`, one round per
    check) from ``(n,)`` bounds ``lb``/``ub``.  The round is the
    reference's: eps of float64, no outward widening.  This is the
    baseline the warm-start engines are measured against."""
    dev = resolve_device(device)
    eps = cfg.eps_for(torch.float64)

    def propagate_fresh(lb, ub):
        # The per-node repack: row expansion on the host + full re-upload.
        dp = DeviceProblem(p, device=dev)
        lb_t, ub_t = initial_bounds((dp.lb0, dp.ub0), lb, ub)
        out = device_fixed_point(_plain_round_fn(dp, eps, cfg.int_eps, cfg.inf, 0.0), lb_t,
                                 ub_t, cfg.max_rounds, with_progress=False)
        return out[0], out[1], torch.tensor(out[2], dtype=torch.int32, device=dev)

    return propagate_fresh


def bounds_equal(
    a_lb, a_ub, b_lb, b_ub, t_abs: float = 1e-8, t_rel: float = 1e-5, inf: float = INF
) -> bool:
    """Paper §4.3: |a-b| <= t_abs + t_rel*|b|, with both-infinite counted equal."""
    f = lambda x: (
        x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    ).astype(np.float64)
    a_lb, a_ub, b_lb, b_ub = f(a_lb), f(a_ub), f(b_lb), f(b_ub)

    def eq(a, b):
        both_pinf = (a >= inf) & (b >= inf)
        both_ninf = (a <= -inf) & (b <= -inf)
        close = np.abs(a - b) <= (t_abs + t_rel * np.abs(b))
        return both_pinf | both_ninf | close

    return bool(np.all(eq(a_lb, b_lb)) and np.all(eq(a_ub, b_ub)))
