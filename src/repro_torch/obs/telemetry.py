"""Device-resident telemetry for the fixed-point loops.

The fixed points keep their loop state on the device and the host reads it
only now and then (``core.carry``), so every per-round signal is out of the
host's sight.  The fix (Sofranac et al. arXiv:2106.07573) is to keep the
statistics on the device too: a fixed-capacity :class:`TelemetryPlane` of
tensors, one sample appended per round (per check group) by
:func:`record_round` -- on the card by the hand-written record kernels of
``kernels.prop_round`` after each round's last kernel -- and read back only
where the host already reads: at the fixed point's end, or at the
service's retirement.

Recording never touches the bound dataflow: the progress measure it stores
is the one the loop's merge already computes for the early stop (armed
without a threshold when only telemetry asks for it), and the
infeasibility probe is a reduction over the bound planes the round just
produced.  Telemetry on therefore returns every result field bitwise equal
to telemetry off.

The branch-and-bound solver (``core.solver.solve``) records the scalar
plane at search granularity: one sample per search level, the next
frontier's width; ``stop_round`` latches the first level that improved the
incumbent and ``infeas_round`` the first that fathomed an infeasible node.

Plane layout (``capacity`` = ring size, per instance or slot when batched):

========================  =======================================================
field                     meaning
========================  =======================================================
``ring[..., capacity]``   per-round progress measure, ring buffer (NaN = unused)
``ticks[...]``            rounds recorded so far (keeps counting past capacity)
``stop_round[...]``       round the early stop tripped, ``-1`` if it never did
``infeas_round[...]``     first round the bounds crossed, ``-1`` if never
========================  =======================================================
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

#: Ring capacity when a driver is asked for telemetry without a size.
DEFAULT_CAPACITY = 64


class TelemetryPlane(NamedTuple):
    """The device half of the telemetry.

    Scalar engines hold ``ring (cap,), ticks (), stop_round (),
    infeas_round ()``; batched engines and the service a leading ``(B,)``
    axis on every field.  The record kernels update the tensors in place."""

    ring: torch.Tensor
    ticks: torch.Tensor
    stop_round: torch.Tensor
    infeas_round: torch.Tensor

    @property
    def capacity(self) -> int:
        """Ring size."""
        return int(self.ring.shape[-1])


def device_plane(capacity: int, batch: int | None = None, dtype=torch.float32,
                 device="cuda") -> TelemetryPlane:
    """Fresh all-empty plane on ``device``: NaN ring, zero ticks, ``-1``
    event rounds.  ``batch=None`` builds the scalar layout, an int the
    batched one.  ``dtype`` is the ring's sample type: drivers pass their
    bound dtype, so a stored sample is exactly the measure they computed."""
    shape = () if batch is None else (int(batch),)
    dev = torch.device(device)
    return TelemetryPlane(
        ring=torch.full(shape + (int(capacity),), float("nan"), dtype=dtype, device=dev),
        ticks=torch.zeros(shape, dtype=torch.int32, device=dev),
        stop_round=torch.full(shape, -1, dtype=torch.int32, device=dev),
        infeas_round=torch.full(shape, -1, dtype=torch.int32, device=dev),
    )


def _like(x, ref: torch.Tensor, dtype) -> torch.Tensor:
    return torch.as_tensor(x, dtype=dtype, device=ref.device)


def record_round(plane: TelemetryPlane, progress, rounds, infeasible, stopped=None,
                 active=None) -> TelemetryPlane:
    """Append one round's sample to the plane; returns a new plane (plain
    tensor operations, no host read).

    ``progress`` is the round's progress measure, ``rounds`` the 1-based
    round counter after this round, ``infeasible`` the crossed-bounds
    predicate over the post-round planes, ``stopped`` the early-stop
    predicate (optional).  Batched callers pass ``active``, the per-row
    mask of who ran this round, so frozen rows' rings stay untouched and
    their ticks do not advance.

    At capacity the ring wraps (``ticks % capacity``): the plane keeps the
    last ``capacity`` samples.  ``stop_round`` / ``infeas_round`` latch the
    first round their event fired and never move again."""
    ring, ticks = plane.ring, plane.ticks
    cap = plane.capacity
    prog = _like(progress, ring, ring.dtype)
    rounds = _like(rounds, ticks, torch.int32)
    infeasible = _like(infeasible, ticks, torch.bool)
    idx = (ticks % cap).long()
    if active is None:
        ring = ring.clone()
        ring.index_put_((idx.reshape(1),), prog.reshape(1))
        ticks = ticks + 1
        infeas_round = torch.where((plane.infeas_round < 0) & infeasible, rounds,
                                   plane.infeas_round)
        stop_round = plane.stop_round
        if stopped is not None:
            stopped = _like(stopped, ticks, torch.bool)
            stop_round = torch.where((stop_round < 0) & stopped, rounds, stop_round)
    else:
        active = _like(active, ticks, torch.bool)
        rows = torch.arange(ring.shape[0], device=ring.device)
        ring = ring.clone()
        ring[rows, idx] = torch.where(active, prog, ring[rows, idx])
        ticks = ticks + active.to(torch.int32)
        infeas_round = torch.where((plane.infeas_round < 0) & infeasible & active, rounds,
                                   plane.infeas_round)
        stop_round = plane.stop_round
        if stopped is not None:
            stopped = _like(stopped, ticks, torch.bool)
            stop_round = torch.where((stop_round < 0) & stopped & active, rounds, stop_round)
    return TelemetryPlane(ring, ticks.to(torch.int32), stop_round, infeas_round)


def reset_rows(plane: TelemetryPlane, rows) -> TelemetryPlane:
    """Re-empty the given batch rows (the service's admission reset);
    returns a new plane.  ``rows`` is an integer index tensor; the named
    rows return to the fresh :func:`device_plane` state and every other row
    is untouched."""
    rows = torch.as_tensor(rows, dtype=torch.int64, device=plane.ring.device)
    ring = plane.ring.clone()
    ring[rows] = float("nan")
    ticks, stop_round, infeas_round = (t.clone() for t in plane[1:])
    ticks[rows] = 0
    stop_round[rows] = -1
    infeas_round[rows] = -1
    return TelemetryPlane(ring, ticks, stop_round, infeas_round)


def _host(arr) -> np.ndarray:
    if isinstance(arr, torch.Tensor):
        if arr.dtype == torch.bfloat16:  # numpy has none: float32 holds it exactly
            arr = arr.float()
        return arr.detach().cpu().numpy()
    return np.asarray(arr)


@dataclasses.dataclass
class TelemetrySnapshot:
    """Host-side handle on a plane, attached to ``PropagationResult.telemetry``.

    Lazy: the fields hold whatever the driver produced (tensors on the
    device at a fixed point's end, host copies after a service retirement)
    and nothing is read until an accessor is called -- attaching a snapshot
    adds no host read.  ``index`` selects one row of a batched plane, so
    the per-instance results of a batch share one plane.

    ``tier_switch_round`` is the round the two-tier scheme promoted the
    fp32 tier to the endgame dtype (``-1`` single-tier), stamped on the
    host where the tier's round count is read anyway; ``fp32`` then holds
    the fp32 tier's own snapshot."""

    plane: TelemetryPlane
    index: int | None = None
    tier_switch_round: int = -1
    fp32: "TelemetrySnapshot | None" = None

    def _field(self, arr):
        a = _host(arr)
        return a[self.index] if self.index is not None else a

    @property
    def capacity(self) -> int:
        """Ring size of the underlying plane."""
        return int(self.plane.ring.shape[-1])

    @property
    def rounds_recorded(self) -> int:
        """Total rounds the loop recorded (may exceed :attr:`capacity`)."""
        return int(self._field(self.plane.ticks))

    @property
    def stop_round(self) -> int:
        """Round the early stop tripped, ``-1`` if it never did."""
        return int(self._field(self.plane.stop_round))

    @property
    def infeasible_round(self) -> int:
        """First round the bounds crossed, ``-1`` if never."""
        return int(self._field(self.plane.infeas_round))

    def progress_history(self) -> np.ndarray:
        """Per-round progress, oldest to newest, unused tail trimmed.

        Length ``min(rounds_recorded, capacity)``; past capacity the ring
        wrapped, so this is the last ``capacity`` rounds in order."""
        ring = self._field(self.plane.ring)
        ticks = self.rounds_recorded
        cap = ring.shape[-1]
        if ticks <= cap:
            return ring[:ticks]
        head = ticks % cap
        return np.concatenate([ring[head:], ring[:head]])

    def summary(self) -> dict:
        """Plain-dict digest (the registry / benchmark row form)."""
        hist = self.progress_history()
        return {
            "capacity": self.capacity,
            "rounds_recorded": self.rounds_recorded,
            "stop_round": self.stop_round,
            "infeasible_round": self.infeasible_round,
            "last_progress": float(hist[-1]) if hist.size else float("nan"),
            "tier_switch_round": self.tier_switch_round,
        }


def host_snapshot(history, capacity: int, stop_round: int = -1,
                  infeas_round: int = -1) -> TelemetrySnapshot:
    """Snapshot from host-recorded per-round progress (the host loop).

    Reproduces the device plane's semantics -- same ring layout, same wrap
    position -- from a list of per-round progress values, so a host_loop
    run's telemetry reads as a device_loop run's does."""
    arr = np.asarray(history, np.float64)
    cap = int(capacity)
    ring = np.full(cap, np.nan, np.float64)
    k = int(arr.shape[0])
    if k and cap:
        keep = arr[-min(k, cap):]
        idx = np.arange(k - keep.shape[0], k) % cap
        ring[idx] = keep
    plane = TelemetryPlane(
        ring=ring,
        ticks=np.int32(k),
        stop_round=np.int32(stop_round),
        infeas_round=np.int32(infeas_round),
    )
    return TelemetrySnapshot(plane=plane)
