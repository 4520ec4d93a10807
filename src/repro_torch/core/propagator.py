"""GPU-parallel domain propagation (paper Algorithm 2), in plain PyTorch.

One *round* (Alg. 3 at nonzero granularity):

  1. activities + infinity counters per row        (segment-sum over nonzeros)
  2. residual activities + bound candidates        (elementwise over nonzeros)
  3. column-wise best candidate                    (segment-max/min over nonzeros)
  4. integrality rounding + monotone update        (elementwise over columns)

This is the port's own oracle for the block-ELL kernel engine
(``kernels.propagate_block_ell``): it shares no code with the tile layout.

Loop drivers: ``host_loop`` and ``device_loop`` both run one round per
iteration and read the round's ``changed`` flag on the host to decide the
exit -- one host sync per round, counted through ``on_sync``.  The batched
fixed point (``batched_fixed_point``, the node engine's and the solver's
loop) reads its ``active.any()`` flag the same way, once per round.
(Deciding the exit on the device is a later slice of the port.)
"""
from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from . import activities as act
from . import bounds as bnd
from .sparse import Problem
from .types import DEFAULT_CONFIG, INF, PropagationResult, PropagatorConfig

DRIVERS = ("host_loop", "device_loop")


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  CUDA is never silently replaced
    by the CPU: asking for it without a GPU raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev


def check_dtype(dtype) -> torch.dtype:
    """This slice of the port runs float64 only."""
    if dtype is None or dtype is torch.float64:
        return torch.float64
    if not isinstance(dtype, torch.dtype) and np.dtype(dtype) == np.float64:
        return torch.float64
    raise NotImplementedError(
        f"dtype={dtype!r}: only float64 is ported; lower precision tiers are "
        "ROADMAP Queue 1 item 5 (precision tiers)"
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


def fixed_point(
    round_fn, lb, ub, max_rounds: int, on_sync: Callable[[], None] | None = None,
    with_progress: bool = True,
):
    """Iterate ``round_fn(lb, ub) -> (lb, ub, changed)`` until a round changes
    nothing or ``max_rounds`` rounds ran.

    ``round_fn`` may update its bound tensors in place.  The progress
    measure is that of the last round, which needs its pre-round bounds only
    if it changed something, that is only if ``max_rounds`` cut the loop:
    so the bounds are copied before the last allowed round alone.
    ``with_progress=False`` skips the measure (progress NaN).  Each round
    reads ``changed`` on the host once (one sync, reported to ``on_sync``).
    Returns ``(lb, ub, rounds, changed, progress)``."""
    prog = torch.tensor(math.nan, dtype=lb.dtype, device=lb.device)
    lb_in, ub_in = lb, ub
    rounds, changed = 0, True
    while changed and rounds < max_rounds:
        if with_progress and rounds + 1 == max_rounds:
            lb_in, ub_in = lb.clone(), ub.clone()
        lb, ub, ch = round_fn(lb, ub)
        rounds += 1
        changed = bool(ch)
        if on_sync is not None:
            on_sync()
    if rounds and with_progress:
        # A round that changed nothing left its bounds as they were.
        prog = bnd.progress_measure(lb_in, ub_in, lb, ub) if changed else (
            bnd.progress_measure(lb, ub, lb, ub)
        )
    return lb, ub, rounds, changed, prog


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


def _check_batched_options(stop_progress, patience, plane):
    if stop_progress is not None or patience != 1:
        not_ported("stop_progress= / patience=", "item 5 (precision tiers)")
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

    The loop reads ``active.any()`` on the host once per round, reported to
    ``on_sync``; with ``with_progress`` one more read takes the incoming
    round counts.  ``stop_progress=``/``patience=`` and ``plane=`` are not
    ported yet and raise ``NotImplementedError``."""
    del feas_eps  # the telemetry probe's tolerance; telemetry is not ported
    _check_batched_options(stop_progress, patience, plane)
    bsz = lb.shape[0]
    if progress is None:
        progress = torch.full((bsz,), math.nan, dtype=lb.dtype, device=lb.device)
    if flat is None:
        flat = torch.zeros((bsz,), dtype=torch.int32, device=lb.device)
    if budget is not None and budget < 1:
        out = (lb, ub, active, last_changed, rounds)
        return out + (progress, flat) if with_progress else out
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
    the per-row last-round progress measure.  One host read of
    ``active.any()`` per round, reported to ``on_sync``."""
    del feas_eps
    _check_batched_options(stop_progress, patience, plane)
    bsz = lb0.shape[0]
    dev = lb0.device
    if active0 is None:
        active0 = torch.ones((bsz,), dtype=torch.bool, device=dev)
    progress = torch.full((bsz,), math.nan, dtype=lb0.dtype, device=dev)
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
    none.  ``policy=``, ``stop_progress=``, ``patience != 1`` and
    ``telemetry=`` raise ``NotImplementedError``.  See
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
    )


def not_ported(name: str, entry: str):
    raise NotImplementedError(f"{name} is not ported yet: ROADMAP Queue 1 {entry}")


def propagate(
    p: Problem,
    cfg: PropagatorConfig = DEFAULT_CONFIG,
    driver: str = "device_loop",
    dtype=None,
    lb0=None,
    ub0=None,
    policy=None,
    telemetry=None,
    device="cuda",
    on_sync: Callable[[], None] | None = None,
) -> PropagationResult:
    """Problem -> PropagationResult with the plain-PyTorch round (no tiles,
    no kernels).

    ``lb0``/``ub0`` are ``(n,)`` warm-start overrides for this call only.
    ``device`` defaults to CUDA and raises where there is none; pass
    ``device="cpu"`` to run on the CPU.  ``on_sync`` is called once per host
    read of the loop's exit flag.  ``progress`` is the last round's measure
    on ``device_loop`` and NaN on ``host_loop``, as in the reference."""
    if policy is not None:
        not_ported("policy=", "item 5 (precision tiers)")
    if telemetry is not None:
        not_ported("telemetry=", "item 6 (observability)")
    if driver not in DRIVERS:
        if driver == "unrolled":
            not_ported("driver='unrolled'", "item 2 (propagate_unrolled)")
        raise ValueError(f"unknown driver: {driver}")
    dp = DeviceProblem(p, dtype=dtype, device=device)
    eps = cfg.eps_for(dp.dtype)
    outward = cfg.outward_for(dp.dtype)

    def round_fn(lb, ub):
        return propagation_round(
            dp.row_id, dp.col, dp.val, dp.lhs, dp.rhs, dp.is_int, lb, ub,
            dp.m, dp.n, eps, cfg.int_eps, cfg.inf, outward,
        )

    lb, ub = initial_bounds((dp.lb0, dp.ub0), lb0, ub0)
    # As the reference's: the host loop reports NaN progress (it would
    # measure only for an early stop, which is not ported).
    out = fixed_point(
        round_fn, lb, ub, cfg.max_rounds, on_sync, with_progress=driver != "host_loop"
    )
    return _result(*out, cfg.feas_eps)


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
