"""Device-resident branch-and-bound: the search state lives on the device.

:func:`solve` keeps the node pool, the incumbent and the pseudo-cost
statistics in device tensors (:class:`SearchCarry`):

  * a fixed-capacity **node pool**: ``(cap, n_pad)`` lower/upper bound planes
    plus per-node ``status`` / ``depth`` / branching / objective lanes, with
    freed slots recycled in place;
  * one **level step**: ``batched_fixed_point`` over the OPEN rows (frozen
    rows cost the node kernels nothing), the node-objective kernel
    (``kernels.prop_round.node_objective_tiles``), incumbent update, bound
    and infeasibility pruning, branching-variable selection
    (:class:`BranchRule`) and child expansion, all on device tensors;
  * the **outer search loop** on the host reads the search's scalars once
    every ``sync_every`` levels, so a depth-``d`` search costs at most
    ``ceil(d / sync_every)`` such syncs.

PyTorch runs eagerly, so the loops are Python loops that decide their exit
on the host: the inner fixed point reads its ``active.any()`` flag once per
round, and each level reads once whether any node is OPEN (which is true
exactly while the search is neither done nor stuck).  Those flag reads are
counted apart from the outer syncs (``solve(on_flag_read=...)``); removing
them is ROADMAP H1.

Exactness contract, as the reference's: :func:`solve` targets pure-integer
instances with integral data (coefficients, sides, bounds, objective).
There every activity, candidate, objective sum and pseudo-cost gain is an
exact f64 integer, so the order of the sums does not matter and the kernel
path, the plain path and the reference search the same tree.
"""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from .propagator import batched_fixed_point, not_ported
from .sparse import Problem
from .types import DEFAULT_CONFIG, INF, PropagatorConfig

# Node-pool slot states.  FREE slots are recyclable; OPEN nodes propagate
# next level; READY nodes are propagated survivors awaiting expansion.
FREE, OPEN, READY = 0, 1, 2


class BranchRule(enum.Enum):
    """Branching-variable selection rule (see ``kernels.ref``):
    ``MOST_FRACTIONAL`` scores unfixed integer columns by their domain
    midpoint's distance to integrality, ``PSEUDO_COST`` by the product of
    the average bound gains of their two child directions so far.  Both
    break ties to the lowest column, so searches are deterministic."""

    MOST_FRACTIONAL = "most_fractional"
    PSEUDO_COST = "pseudo_cost"


class SearchCarry(NamedTuple):
    """The device-resident search state.  Pool planes are ``(cap, n_pad)``;
    per-node lanes ``(cap,)``; pseudo-cost statistics ``(2, n_pad)``
    (direction 0 = down child); the rest are 0-d tensors.  ``nbound`` is
    each node's objective lower bound, ``pbound`` its parent's."""

    lb: torch.Tensor        # (cap, n_pad) per-node lower bounds
    ub: torch.Tensor        # (cap, n_pad) per-node upper bounds
    status: torch.Tensor    # (cap,) int32: FREE / OPEN / READY
    depth: torch.Tensor     # (cap,) int32 node depth (root = 0)
    bvar: torch.Tensor      # (cap,) int32 branching column (-1 at root)
    bdir: torch.Tensor      # (cap,) int32 branch direction (0 down, 1 up)
    pbound: torch.Tensor    # (cap,) parent objective bound
    nbound: torch.Tensor    # (cap,) node objective bound
    pc_sum: torch.Tensor    # (2, n_pad) pseudo-cost gain sums
    pc_cnt: torch.Tensor    # (2, n_pad) pseudo-cost observation counts
    inc: torch.Tensor       # () incumbent objective (INF = none yet)
    inc_x: torch.Tensor     # (n_pad,) incumbent solution plane
    expanded: torch.Tensor  # () int32 nodes branched
    created: torch.Tensor   # () int32 nodes created (root + children)
    leaves: torch.Tensor    # () int32 feasible all-fixed nodes reached
    pruned_bound: torch.Tensor   # () int32 nodes pruned on bound
    pruned_infeas: torch.Tensor  # () int32 nodes pruned infeasible
    levels: torch.Tensor    # () int32 search levels executed
    done: torch.Tensor      # () bool: nothing left to expand
    stuck: torch.Tensor     # () bool: READY nodes but no FREE slots


@dataclasses.dataclass
class SolveResult:
    """Outcome of one :func:`solve` search (host side, built at the final
    sync).  ``status`` is ``'optimal'``, ``'infeasible'``,
    ``'pool_exhausted'`` (READY nodes but no FREE slot) or ``'level_limit'``.
    ``created == 1 + 2 * expanded``; on a completed search ``created ==
    leaves + pruned_infeasible + pruned_bound + expanded``.
    ``incumbent_trajectory`` holds the incumbent at each host sync
    (``host_syncs`` entries).  ``telemetry`` is not ported (None);
    ``carry`` is the final :class:`SearchCarry` on the device."""

    status: str
    objective: float
    x: "np.ndarray | None"
    feasible: bool
    nodes_expanded: int
    nodes_created: int
    leaves: int
    pruned_bound: int
    pruned_infeasible: int
    levels: int
    host_syncs: int
    incumbent_trajectory: "list[float]"
    telemetry: object = None
    carry: "SearchCarry | None" = None


def _plan_expansion(status, depth, nbound, width=None):
    """Slot planning for one expansion wave.

    Ranks READY nodes deepest-first, then best-bound, then slot id (three
    chained STABLE argsorts, least significant key first); FREE slots rank
    by slot id.  ``k = min(#READY, #FREE)`` pairs expand (clamped to
    ``width`` when given): rank ``r``'s parent slot is ``parent[r]``, its
    up-child's slot ``child[r]``; ranks ``>= k`` carry the out-of-range
    sentinel ``cap``, which the scatters drop.  Returns ``(parent, child,
    k, n_ready, n_free)``."""
    cap = status.shape[0]
    ready = status == READY
    free = status == FREE
    order = torch.argsort(nbound, stable=True)
    order = order[torch.argsort(-depth[order], stable=True)]
    order = order[torch.argsort((~ready[order]).to(torch.int32), stable=True)]
    slots = torch.argsort((~free).to(torch.int32), stable=True)
    n_ready = ready.sum(dtype=torch.int32)
    n_free = free.sum(dtype=torch.int32)
    k = torch.minimum(n_ready, n_free)
    if width is not None:
        k = k.clamp_max(int(width))
    r = torch.arange(cap, device=status.device)
    parent = torch.where(r < k, order, cap)
    child = torch.where(r < k, slots, cap)
    return parent, child, k, n_ready, n_free


def _set_drop(lane, idx, vals):
    """``lane.at[idx].set(vals, mode='drop')``: entries whose index is the
    out-of-range sentinel ``len(lane)`` are dropped (they land in a scratch
    slot past the end)."""
    ext = torch.cat([lane, lane[:1]])
    ext[idx] = vals
    return ext[:-1]


def _add_drop(plane, flat, vals):
    """``plane.flat.at[flat].add(vals, mode='drop')`` for the sentinel
    ``plane.numel()``.  Sums of duplicates may take any order; under the
    integral-data contract the gains are exact integers."""
    ext = torch.cat([plane.reshape(-1), plane.new_zeros(1)])
    ext.index_put_((flat,), vals, accumulate=True)
    return ext[:-1].reshape(plane.shape)


def _make_level_step(prep, cfg, rule, use_kernels, prune_gap, expand_width, on_flag_read):
    """Build the level step ``(carry, c_pad) -> carry`` over one prepared
    instance: propagate OPEN rows to their fixed points, score them, update
    the incumbent, prune, select branching variables and expand.  It
    returns None, having changed nothing, when no node is OPEN -- exactly
    when the search is done or stuck."""
    from ..kernels import ref as kref
    from ..kernels.ops import node_round_fn_for
    from ..kernels.prop_round import node_objective_tiles

    n_pad, n = prep.n_pad, prep.n
    dev = prep.lb0.device
    valid = torch.arange(n_pad, device=dev) < n
    ii = torch.zeros(n_pad, dtype=torch.bool, device=dev)
    ii[:n] = prep.d.is_int
    round_fn = node_round_fn_for(prep, cfg, use_kernels)
    objective = node_objective_tiles if use_kernels else kref.node_objective_ref

    def flag(x) -> bool:
        if on_flag_read is not None:
            on_flag_read()
        return bool(x)

    def step(c: SearchCarry, c_pad):
        cap = c.status.shape[0]
        open_m = c.status == OPEN
        if not flag(open_m.any()):
            return None

        # (1) All OPEN nodes to their fixed points; other rows are frozen.
        lb, ub, _, _ = batched_fixed_point(
            round_fn, c.lb, c.ub, cfg.max_rounds, active0=open_m, on_sync=on_flag_read
        )

        # (2) Objective bound + leaf / infeasibility predicates.
        obj, fixed, crossed = objective(lb, ub, c_pad, ii, valid, cfg.feas_eps, cfg.inf)
        infeas = crossed & open_m
        nb = torch.where(open_m, torch.maximum(obj, c.pbound), c.nbound)

        # (3) Pseudo-cost statistics: each propagated child credits its
        # branching (direction, column) with its bound gain.
        contrib = open_m & (c.bvar >= 0) & ~infeas
        gain = torch.where(contrib, torch.clamp_min(nb - c.pbound, 0.0), 0.0)
        flat = torch.where(
            contrib, c.bdir.clamp(0, 1).long() * n_pad + c.bvar.long(), 2 * n_pad
        )
        pc_sum = _add_drop(c.pc_sum, flat, gain)
        pc_cnt = _add_drop(c.pc_cnt, flat, contrib.to(c.pc_cnt.dtype))

        # (4) Incumbent: best feasible all-fixed node this level.
        leaf = open_m & ~infeas & fixed
        inc, inc_x, _ = kref.incumbent_update_ref(leaf, obj, c.inc, c.inc_x, lb, cfg.inf)

        # (5) Pruning + status transitions.
        survivor = open_m & ~infeas & ~leaf
        pruned_o = survivor & (nb >= inc - prune_gap)
        to_ready = survivor & ~pruned_o
        pruned_r = (c.status == READY) & (c.nbound >= inc - prune_gap)
        status = torch.where(open_m, torch.where(to_ready, READY, FREE).to(torch.int32),
                             c.status)
        status = torch.where(pruned_r, FREE, status).to(torch.int32)

        # (6) Expansion: slot plan + branching selection.
        parent, child, k, n_ready, _ = _plan_expansion(status, c.depth, nb, expand_width)
        if rule is BranchRule.PSEUDO_COST:
            var_all, _ = kref.pseudo_cost_select_ref(lb, ub, ii, valid, pc_sum, pc_cnt)
        else:
            var_all, _ = kref.most_fractional_ref(lb, ub, ii, valid)
        pg = parent.clamp_max(cap - 1)
        r = torch.arange(cap, device=dev)
        pv = var_all[pg]
        plbv, pubv = lb[pg, pv], ub[pg, pv]
        bv = torch.minimum(torch.maximum(torch.floor(0.5 * (plbv + pubv)), plbv), pubv - 1.0)
        pdep, pnb = c.depth[pg], nb[pg]
        # Parent planes gathered BEFORE the down-child write below.
        up_lb = lb[pg]
        pub_rows = ub[pg]
        up_lb[r, pv] = bv + 1.0
        # Down child reuses the parent slot: only ub[bvar] moves.  Every slot
        # writes its own row once (non-parents write back what they hold).
        is_par = _set_drop(torch.zeros_like(open_m), parent, True)
        par_var = _set_drop(torch.zeros_like(pv), parent, pv)
        par_bv = _set_drop(torch.zeros_like(bv), parent, bv)
        ub[r, par_var] = torch.where(is_par, par_bv, ub[r, par_var])
        # Up child fills a FREE slot with the parent's planes + lb[bvar].
        is_child = _set_drop(torch.zeros_like(open_m), child, True)
        rank = _set_drop(torch.zeros_like(r), child, r)
        lb = torch.where(is_child[:, None], up_lb[rank], lb)
        ub = torch.where(is_child[:, None], pub_rows[rank], ub)

        def stamp(lane, down_val, up_val):
            return _set_drop(_set_drop(lane, parent, down_val), child, up_val)

        bvar_new = pv.to(torch.int32)
        i32 = lambda x: x.to(torch.int32)
        return SearchCarry(
            lb=lb, ub=ub,
            status=stamp(status, OPEN, OPEN),
            depth=stamp(c.depth, pdep + 1, pdep + 1),
            bvar=stamp(c.bvar, bvar_new, bvar_new),
            bdir=stamp(c.bdir, 0, 1),
            pbound=stamp(c.pbound, pnb, pnb),
            nbound=stamp(nb, pnb, pnb),
            pc_sum=pc_sum, pc_cnt=pc_cnt, inc=inc, inc_x=inc_x,
            expanded=i32(c.expanded + k),
            created=i32(c.created + 2 * k),
            leaves=i32(c.leaves + leaf.sum(dtype=torch.int32)),
            pruned_bound=i32(c.pruned_bound + pruned_o.sum(dtype=torch.int32)
                             + pruned_r.sum(dtype=torch.int32)),
            pruned_infeas=i32(c.pruned_infeas + infeas.sum(dtype=torch.int32)),
            levels=i32(c.levels + 1),
            done=n_ready == 0,
            stuck=(n_ready > 0) & (k == 0),
        )

    return step


def _init_carry(prep, cap: int) -> SearchCarry:
    """A fresh pool: the root (the prepared bounds) OPEN in slot 0."""
    n_pad, dev, dt = prep.n_pad, prep.lb0.device, prep.lb0.dtype
    zi = lambda: torch.zeros((), dtype=torch.int32, device=dev)
    lb = torch.zeros((cap, n_pad), dtype=dt, device=dev)
    ub = torch.zeros((cap, n_pad), dtype=dt, device=dev)
    lb[0], ub[0] = prep.lb0, prep.ub0
    status = torch.zeros(cap, dtype=torch.int32, device=dev)
    status[0] = OPEN
    return SearchCarry(
        lb=lb, ub=ub, status=status,
        depth=torch.zeros(cap, dtype=torch.int32, device=dev),
        bvar=torch.full((cap,), -1, dtype=torch.int32, device=dev),
        bdir=torch.zeros(cap, dtype=torch.int32, device=dev),
        pbound=torch.full((cap,), -INF, dtype=dt, device=dev),
        nbound=torch.full((cap,), -INF, dtype=dt, device=dev),
        pc_sum=torch.zeros((2, n_pad), dtype=dt, device=dev),
        pc_cnt=torch.zeros((2, n_pad), dtype=dt, device=dev),
        inc=torch.tensor(INF, dtype=dt, device=dev),
        inc_x=torch.zeros(n_pad, dtype=dt, device=dev),
        expanded=zi(), created=zi() + 1, leaves=zi(), pruned_bound=zi(),
        pruned_infeas=zi(), levels=zi(),
        done=torch.zeros((), dtype=torch.bool, device=dev),
        stuck=torch.zeros((), dtype=torch.bool, device=dev),
    )


_SCALARS = ("done", "stuck", "levels", "inc", "expanded", "created", "leaves",
            "pruned_bound", "pruned_infeas")


def solve(
    p: Problem,
    c,
    *,
    cfg: PropagatorConfig = DEFAULT_CONFIG,
    rule: BranchRule = BranchRule.MOST_FRACTIONAL,
    node_cap: int = 256,
    max_levels: int = 64,
    sync_every: int = 8,
    prune_gap: float = 0.0,
    expand_width: int | None = None,
    tile_rows: int = 8,
    tile_width: int = 8,
    use_kernels: bool = True,
    telemetry: int | None = None,
    on_sync: "Callable[[dict], None] | None" = None,
    on_flag_read: "Callable[[], None] | None" = None,
    device="cuda",
) -> SolveResult:
    """Branch-and-bound minimization of ``c @ x`` with device-resident
    search state.

    ``p`` must be pure-integer; ``c`` is the ``(n,)`` objective.  The search
    lives in a ``node_cap``-slot pool on the device and advances one LEVEL
    at a time: every OPEN node propagates to its fixed point, feasible
    all-fixed nodes update the incumbent, nodes are pruned on bound and
    infeasibility, and the survivors expand depth-first (down child in the
    parent's slot, up child in a recycled FREE slot).  The host reads the
    search's scalars every ``sync_every`` levels -- at most ``ceil(levels /
    sync_every)`` times (``host_syncs``); ``on_sync``, when given, gets a
    progress dict at exactly those points.

    Inside each level the host also reads one flag per propagation round
    and one per level (see the module docstring); ``on_flag_read`` is
    called for each.  Removing those reads is ROADMAP H1.

    ``rule`` picks the branching rule; ``prune_gap`` widens fathoming to
    ``bound >= incumbent - prune_gap``; ``expand_width`` clamps each
    expansion wave (a DFS beam; completeness is kept).  ``use_kernels=False``
    runs the plain PyTorch versions of the kernels.  ``device`` defaults to
    CUDA and raises where there is none.  ``telemetry=`` is not ported."""
    from ..kernels.ops import prepare_block_ell

    if telemetry is not None:
        not_ported("telemetry=", "item 6 (observability)")
    if not bool(np.all(np.asarray(p.is_int, bool))):
        raise ValueError("solve() requires a pure-integer problem (is_int all True)")
    c = np.asarray(c, np.float64)
    if c.shape != (p.n,):
        raise ValueError(f"objective has shape {c.shape}, expected {(p.n,)}")
    cap = int(node_cap)
    if cap < 2:
        raise ValueError("node_cap must be >= 2")
    sync_every = max(1, int(sync_every))
    if expand_width is not None:
        expand_width = int(expand_width)
        if expand_width < 1:
            raise ValueError("expand_width must be >= 1 (or None)")

    prep = prepare_block_ell(p, tile_rows, tile_width, None, device)
    c_pad = torch.zeros(prep.n_pad, dtype=prep.lb0.dtype, device=prep.lb0.device)
    c_pad[: p.n] = torch.as_tensor(c, dtype=c_pad.dtype)
    carry = _init_carry(prep, cap)
    step = _make_level_step(
        prep, cfg, rule, use_kernels, float(prune_gap), expand_width, on_flag_read
    )

    syncs, levels = 0, 0
    traj: "list[float]" = []
    target = 0
    while True:
        target = min(target + sync_every, max_levels)
        while levels < target:
            nxt = step(carry, c_pad)
            if nxt is None:
                break
            carry, levels = nxt, levels + 1
        # THE host sync: one copy of the scalars + status lane.
        host = torch.cat([
            torch.stack([getattr(carry, f).to(torch.float64) for f in _SCALARS]),
            carry.status.to(torch.float64),
        ]).cpu().numpy()
        done, stuck, inc = bool(host[0]), bool(host[1]), float(host[3])
        assert int(host[2]) == levels
        syncs += 1
        traj.append(inc)
        if on_sync is not None:
            st = host[len(_SCALARS):]
            on_sync({
                "sync": syncs,
                "levels": levels,
                "incumbent": inc,
                "done": done,
                "stuck": stuck,
                "expanded": int(host[4]),
                "created": int(host[5]),
                "open": int((st == OPEN).sum()),
                "ready": int((st == READY).sum()),
                "free": int((st == FREE).sum()),
            })
        if done or stuck or levels >= max_levels:
            break

    feasible = inc < INF
    if stuck:
        status = "pool_exhausted"
    elif not done:
        status = "level_limit"
    elif feasible:
        status = "optimal"
    else:
        status = "infeasible"
    x = carry.inc_x[: p.n].cpu().numpy().copy() if feasible else None
    assert syncs <= max(1, math.ceil(levels / sync_every))
    return SolveResult(
        status=status,
        objective=inc if feasible else INF,
        x=x,
        feasible=feasible,
        nodes_expanded=int(host[4]),
        nodes_created=int(host[5]),
        leaves=int(host[6]),
        pruned_bound=int(host[7]),
        pruned_infeasible=int(host[8]),
        levels=levels,
        host_syncs=syncs,
        incumbent_trajectory=traj,
        carry=carry,
    )


__all__ = [
    "FREE",
    "OPEN",
    "READY",
    "BranchRule",
    "SearchCarry",
    "SolveResult",
    "solve",
]
