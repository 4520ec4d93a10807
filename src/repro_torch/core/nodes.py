"""Warm-start node-batch propagation: the tree-search serving shape.

Domain propagation runs at every node of a branch-and-bound search, and a
node differs from its parent by one branching bound.  So the matrix is
prepared once per instance (``kernels.prepare_block_ell``, keyed on
structure) and stays on the device; a :class:`NodeBatch` carries B nodes as
``(B, n)`` bound planes, the only per-node state; :func:`propagate_nodes`
runs all B fixed points together over the shared tiles, with a per-node
active mask (converged nodes cost the kernels nothing) and per-node
infeasibility reported for pruning.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from .propagator import not_ported, two_tier_bounds_dtypes
from .sparse import Problem
from .types import DEFAULT_CONFIG, INF, PropagationResult, PropagatorConfig, TierPolicy


class NodeBatchResult(NamedTuple):
    """Per-node results of one node-batch propagation (node axis leading).
    ``telemetry`` and ``fp32_telemetry`` belong to the telemetry plane (item
    6), not ported yet: always None."""

    lb: torch.Tensor          # (B, n) propagated lower bounds
    ub: torch.Tensor          # (B, n) propagated upper bounds
    rounds: torch.Tensor      # (B,) int32 rounds to each node's fixed point
    converged: torch.Tensor   # (B,) bool
    infeasible: torch.Tensor  # (B,) bool: domain emptied -> prune this node
    progress: torch.Tensor | None = None  # (B,) last-round progress measure
    tier_rounds: object = 0   # (B,) int32 fp32-tier rounds (two-tier runs), else 0
    telemetry: object = None
    fp32_telemetry: object = None

    @property
    def size(self) -> int:
        return int(self.lb.shape[0])

    def result(self, i: int) -> PropagationResult:
        """Node ``i``'s result in single-instance form."""
        prog = self.progress[i] if self.progress is not None else torch.tensor(
            math.nan, dtype=self.lb.dtype, device=self.lb.device
        )
        return PropagationResult(
            self.lb[i], self.ub[i], self.rounds[i], self.converged[i],
            self.infeasible[i], prog, torch.zeros_like(self.rounds[i]),
        )

    def results(self) -> "list[PropagationResult]":
        return [self.result(i) for i in range(self.size)]


class NodeBatch(NamedTuple):
    """B nodes of ONE instance: the shared problem + per-node bound planes
    (host ``(B, n)`` numpy arrays: node bookkeeping is host-side search
    logic; only propagation runs on the device)."""

    problem: Problem
    lb: np.ndarray  # (B, n)
    ub: np.ndarray  # (B, n)

    @property
    def size(self) -> int:
        return int(self.lb.shape[0])

    @classmethod
    def from_root(cls, p: Problem, copies: int = 1) -> "NodeBatch":
        """``copies`` identical nodes at the problem's root bounds."""
        lb = np.repeat(np.asarray(p.lb, np.float64)[None, :], copies, axis=0)
        ub = np.repeat(np.asarray(p.ub, np.float64)[None, :], copies, axis=0)
        return cls(problem=p, lb=lb, ub=ub)

    @classmethod
    def from_nodes(cls, p: Problem, nodes: Sequence[tuple]) -> "NodeBatch":
        """Stack ``(lb_i, ub_i)`` pairs into one batch."""
        lb = np.stack([np.asarray(l, np.float64) for l, _ in nodes])
        ub = np.stack([np.asarray(u, np.float64) for _, u in nodes])
        return cls(problem=p, lb=lb, ub=ub)

    def select(self, mask) -> "NodeBatch":
        """Keep the nodes where ``mask`` is True (pruning survivors)."""
        mask = np.asarray(mask)
        return NodeBatch(self.problem, self.lb[mask], self.ub[mask])


def branch_children(lb, ub, var: int, value: float) -> "tuple[tuple, tuple]":
    """The two children of branching ``x[var]`` at ``value``: the *down*
    child gets ``ub[var] = floor(value)``, the *up* child ``lb[var] =
    floor(value) + 1``.  Returns ``((lb_down, ub_down), (lb_up, ub_up))`` as
    fresh host arrays."""
    lb = np.asarray(lb, np.float64)
    ub = np.asarray(ub, np.float64)
    f = float(np.floor(value))
    down_lb, down_ub = lb.copy(), ub.copy()
    down_ub[var] = min(down_ub[var], f)
    up_lb, up_ub = lb.copy(), ub.copy()
    up_lb[var] = max(up_lb[var], f + 1.0)
    return (down_lb, down_ub), (up_lb, up_ub)


def pick_most_fractional(lb, ub, is_int) -> "int | None":
    """Host-side branching rule: the unfixed integer variable whose domain
    midpoint is most fractional, ties to the lowest index (the host twin of
    ``kernels.ref.most_fractional_ref``).  ``None`` when every integer
    variable is fixed."""
    lb = np.asarray(lb, np.float64)
    ub = np.asarray(ub, np.float64)
    cand = np.asarray(is_int, bool) & (ub - lb > 0.5)
    if not cand.any():
        return None
    mid = 0.5 * (lb + ub)
    frac = mid - np.floor(mid)
    score = np.where(cand, 0.5 - np.abs(frac - 0.5), -1.0)
    return int(np.argmax(score))


def propagate_nodes(
    p: Problem,
    lb_nodes,
    ub_nodes,
    cfg: PropagatorConfig = DEFAULT_CONFIG,
    tile_rows: int = 8,
    tile_width: int = 128,
    dtype=None,
    use_kernels: bool = True,
    slab: int | None = None,
    stop_progress: float | None = None,
    patience: int = 1,
    policy: TierPolicy | None = None,
    telemetry: int | None = None,
    device="cuda",
    on_sync: Callable[[], None] | None = None,
) -> NodeBatchResult:
    """Propagate B warm-started nodes of ONE instance together.

    ``lb_nodes``/``ub_nodes`` are ``(B, n)`` per-node bound planes (or a
    :class:`NodeBatch`'s fields).  The instance's tiles and hoisted gathers
    are cached per matrix structure (``kernels.cache_info()`` reports hits),
    so successive frontiers of one search pay only the two plane uploads.
    Instances past ``kernels.ops.SCATTER_MAX_NPAD`` ride the column-slab
    partitioned node kernels (``slab`` overrides the window width).
    Per-node ``rounds``/``converged`` match each node's own single-instance
    run, and so do its bounds, bitwise; ``infeasible`` nodes are reported
    for pruning and leave the other nodes untouched.

    ``use_kernels=False`` runs the kernels' plain PyTorch versions.
    ``device`` defaults to CUDA and raises where there is none.  ``on_sync``
    is called once per host read of the loop's exit flag (one per round).
    ``dtype`` is float64 (the default) or float32.  ``stop_progress``/
    ``patience`` arm the per-node early stop; ``policy`` (a
    :class:`TierPolicy`) runs the frontier through the two tiers, as the
    reference's (src/repro/core/nodes.py:203-241): a float32 pass of at
    most ``max(1, int(max_rounds * fp32_round_frac))`` rounds stopped per
    node below ``switch_progress``, per-node promotion by an exact cast
    with the infinite sentinels restored (a node with an fp32 infeasible
    verdict restarts from its original bounds, its ``tier_rounds`` 0), and
    the endgame of at most ``max(1, max_rounds - cap)`` rounds in
    ``dtype``; ``rounds`` includes ``tier_rounds``; past ``SCATTER_MAX_NPAD``
    too (the partitioned node round).  ``telemetry`` (item 6) raises
    ``NotImplementedError``."""
    from ..kernels.ops import prepare_block_ell, propagate_nodes_prepared

    if telemetry is not None:
        not_ported("telemetry=", "item 6 (observability)")
    run = dict(use_kernels=use_kernels, with_progress=True, on_sync=on_sync, slab=slab)
    pair = two_tier_bounds_dtypes(policy, dtype) if policy is not None else None
    if pair is not None:
        dt32, final = pair
        cap32 = max(1, int(cfg.max_rounds * policy.fp32_round_frac))
        prep32 = prepare_block_ell(p, tile_rows, tile_width, dt32, device)
        lb32, ub32, r32, _, inf32, _ = propagate_nodes_prepared(
            prep32, lb_nodes, ub_nodes, dataclasses.replace(cfg, max_rounds=cap32),
            stop_progress=policy.switch_progress, patience=policy.patience, **run,
        )
        # Per-node promotion in float64; a node whose fp32 tier declared
        # infeasibility restarts from its original bounds.
        dev = lb32.device
        bad = inf32[:, None]
        as64 = lambda x: torch.as_tensor(x, dtype=torch.float64, device=dev)
        warm_lb = torch.where(bad, as64(lb_nodes), lb32.to(torch.float64))
        warm_ub = torch.where(bad, as64(ub_nodes), ub32.to(torch.float64))
        warm_lb = torch.where(warm_lb <= -INF, -INF, warm_lb)
        warm_ub = torch.where(warm_ub >= INF, INF, warm_ub)
        r32 = torch.where(inf32, 0, r32).to(torch.int32)
        rem = dataclasses.replace(cfg, max_rounds=max(1, cfg.max_rounds - cap32))
        prep = prepare_block_ell(p, tile_rows, tile_width, final, device)
        lb, ub, rounds, converged, infeasible, progress = propagate_nodes_prepared(
            prep, warm_lb, warm_ub, rem, stop_progress=policy.stop_progress,
            patience=policy.patience, **run,
        )
        return NodeBatchResult(lb, ub, rounds + r32, converged, infeasible, progress=progress,
                               tier_rounds=r32)
    if policy is not None:
        stop_progress, patience = policy.stop_progress, policy.patience
    prep = prepare_block_ell(p, tile_rows, tile_width, dtype, device)
    lb, ub, rounds, converged, infeasible, progress = propagate_nodes_prepared(
        prep, lb_nodes, ub_nodes, cfg, stop_progress=stop_progress, patience=patience, **run,
    )
    return NodeBatchResult(lb, ub, rounds, converged, infeasible, progress=progress)


def propagate_node_batch(
    batch: NodeBatch, cfg: PropagatorConfig = DEFAULT_CONFIG, **kwargs
) -> NodeBatchResult:
    """:func:`propagate_nodes` over a :class:`NodeBatch`."""
    return propagate_nodes(batch.problem, batch.lb, batch.ub, cfg, **kwargs)
