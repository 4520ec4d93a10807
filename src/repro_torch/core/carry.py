"""The loop carry: a fixed point's loop state kept on the device.

The reference's device driver is a ``lax.while_loop`` whose carry holds
``changed_any`` over a check group of ``unroll`` rounds, the round count and
the condition ``changed & (rounds < max_rounds)``
(``src/repro/core/propagator.py:272``).  Here the carry is a small int32
tensor that the round closure owns; the round's last kernel (F, or #15 for
a single instance past ``SCATTER_MAX_NPAD``) updates it on the device, so the
host only enqueues rounds and reads the carry now and then:

  ``FLAG``    this round tightened a bound (set by the merge, then cleared)
  ``ANY``     ``changed_any`` over the current check group
  ``ROUNDS``  rounds counted: ``unroll`` for each check group begun with GO
  ``GO``      the reference's ``cond`` without its round cap, which stays
              on the host (it stops enqueueing): a round enqueued while GO
              is 0 changes neither the bounds nor the counts
  ``TICKET``  blocks of the merge's launch that are done; its last block
              folds ``FLAG`` into the rest and sets it back to 0

With the progress-based early stop armed (:class:`EarlyStop`: the
reference's ``stop_progress`` and ``patience``,
``src/repro/kernels/ops.py:1292-1308``) a check group's end also keeps:

  ``PROG``    the group's progress measure, in the bounds' dtype, as raw
              bits at int32 field 8 (fields 8-9 for float64)
  ``FLAT``    consecutive check groups whose measure fell below the
              threshold; GO clears once it reaches ``patience``
  ``LAST``    the group's ``changed_any`` (the result's ``converged`` is
              its negation: GO no longer says it once the stop fired)

:func:`fold` is the plain form of that last block's work.  Nothing here
allocates or fills per round: the carry is armed once per fixed point.
"""
from __future__ import annotations

import threading
from typing import NamedTuple

import numpy as np
import torch

FLAG, ANY, ROUNDS, GO, TICKET, FLAT, LAST = range(7)
PROG = 8     # the progress measure's first int32 field (byte offset 32)
FIELDS = 16  # int32 fields, padded to 64 bytes


class EarlyStop(NamedTuple):
    """The progress-based early stop of a fixed point: stop once the
    progress measure of ``patience`` consecutive check groups falls below
    ``progress`` (compared in the bounds' dtype)."""

    progress: float
    patience: int = 1


def early_stop(stop_progress: float | None, patience: int = 1) -> EarlyStop | None:
    """The :class:`EarlyStop` of a driver's ``stop_progress=`` /
    ``patience=``, or None where no threshold is given."""
    return None if stop_progress is None else EarlyStop(float(stop_progress), int(patience))


def progress_view(state: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The carry's ``PROG`` slot as a ``(1,)`` tensor of ``dtype`` (a view
    of ``state``, on its device)."""
    width = torch.empty((), dtype=dtype).element_size() // 4
    return state[PROG : PROG + width].view(dtype)


def progress_of(fields: list, dtype: torch.dtype) -> float:
    """The ``PROG`` slot of the carry's fields as read on the host
    (:meth:`LoopCarry.read`), as a float of ``dtype``."""
    np_dt = np.dtype(str(dtype).removeprefix("torch."))
    width = np_dt.itemsize // 4
    return float(np.array(fields[PROG : PROG + width], dtype=np.int32).view(np_dt)[0])


# One armed carry per device, which a fresh or re-armed carry copies: one
# launch.
_armed: dict = {}


def _armed_template(device) -> torch.Tensor:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    template = _armed.get(dev)
    if template is None:
        template = torch.zeros(FIELDS, dtype=torch.int32, device=dev)
        template[GO] = 1
        _armed[dev] = template
    return template


def armed_state(device) -> torch.Tensor:
    """A fresh carry at the start of a fixed point: GO set, the rest 0."""
    return _armed_template(device).clone()


# The views of the carries that drivers arm, by storage address: each round
# takes them, and building a view costs a few microseconds of host time.  An
# entry is used only for the identical tensor; a fresh carry's views are
# built and not kept.
_views: dict = {}


def _make_views(state: torch.Tensor) -> tuple:
    as_bool = state.view(torch.bool)
    return state, as_bool[4 * GO : 4 * GO + 1], as_bool[4 * GO]


def _keep_views(state: torch.Tensor) -> None:
    if len(_views) >= 64:
        _views.clear()
    _views[state.data_ptr()] = _make_views(state)


def _go_views(state: torch.Tensor) -> tuple:
    hit = _views.get(state.data_ptr())
    return hit if hit is not None and hit[0] is state else _make_views(state)


def go_mask(state: torch.Tensor) -> torch.Tensor:
    """``GO`` as a ``(1,)`` bool view (the low byte of the little-endian
    int32 field, 0 or 1): the active mask of a single instance's
    partitioned round, and the gate of the round's kernels."""
    return _go_views(state)[1]


def go_flag(state: torch.Tensor) -> torch.Tensor:
    """``GO`` as a 0-d bool view: with ``unroll`` 1, whether the round just
    folded tightened a bound (while the loop went on)."""
    return _go_views(state)[2]


def fold(state: torch.Tensor, flag: torch.Tensor, k: int, unroll: int,
         stop: EarlyStop | None = None, prog: torch.Tensor | None = None) -> None:
    """Fold a round's ``changed`` flag into the carry, in place, as the
    merge's last block does on the card: nothing while GO is 0; else
    ``ANY |= flag`` and, for the last round of a check group (``k ==
    unroll - 1``), ``ROUNDS += unroll``, ``GO = ANY`` and ``ANY = 0``.
    With an early stop ``stop`` armed, the group's end also stores its
    progress measure ``prog`` (a 0-d tensor of the bounds' dtype, needed
    then only), counts ``FLAT`` (``prog < stop.progress``, compared in that
    dtype), keeps ``LAST = ANY`` and clears GO once ``FLAT`` reaches
    ``stop.patience``.  Torch ops only, so the carry stays on its device."""
    go = state[GO : GO + 1]
    any_ = state[ANY : ANY + 1] | (flag.reshape(1).to(torch.int32) & go)
    if k == unroll - 1:
        state[ROUNDS : ROUNDS + 1] += unroll * go
        if stop is None:
            state[GO : GO + 1] = any_ & go
        else:
            on = go.bool()
            slot = progress_view(state, prog.dtype)
            slot.copy_(torch.where(on, prog.reshape(1), slot))
            low = (prog.reshape(1) < stop.progress).to(torch.int32)
            flat = torch.where(on, (state[FLAT : FLAT + 1] + 1) * low, state[FLAT : FLAT + 1])
            state[FLAT : FLAT + 1] = flat
            state[LAST : LAST + 1] = torch.where(on, any_, state[LAST : LAST + 1])
            state[GO : GO + 1] = any_ & go & (flat < stop.patience).to(torch.int32)
        state[ANY] = 0
    else:
        state[ANY : ANY + 1] = any_
    state[FLAG] = 0
    state[TICKET] = 0


class LoopCarry:
    """A round closure's loop carry: one per thread (a cached closure may
    run in several threads), with the host's place in the check group.

    A driver arms it for one fixed point (:meth:`arm`), reads it with
    :meth:`read` and releases it at the end.  Between, each round takes
    ``(state, k, unroll)`` from :meth:`step`: the carry, the round's index
    within its check group and the group's length.  A round run outside a
    driver gets a fresh carry of its own (one round, one group), so its
    ``changed`` view is not overwritten by a later round."""

    def __init__(self):
        self._local = threading.local()

    @property
    def state(self) -> torch.Tensor | None:
        """This thread's carry, or None before the first fixed point."""
        return getattr(self._local, "state", None)

    @property
    def armed(self) -> bool:
        return getattr(self._local, "armed", False)

    @property
    def stop(self) -> EarlyStop | None:
        """The early stop the armed fixed point runs with, or None."""
        return getattr(self._local, "stop", None) if self.armed else None

    def arm(self, device, unroll: int = 1, stop: EarlyStop | None = None) -> None:
        """Start a fixed point of check groups of ``unroll`` rounds: the
        carry set to :func:`armed_state` (allocated at the first use on
        ``device``), with the early stop ``stop`` armed where given."""
        if unroll < 1:
            raise ValueError(f"unroll={unroll}: a check group holds at least one round")
        loc = self._local
        dev = torch.device(device)
        state = getattr(loc, "state", None)
        if state is None or state.device != dev:
            state = loc.state = torch.empty(FIELDS, dtype=torch.int32, device=dev)
        state.copy_(_armed_template(dev))
        _keep_views(state)
        loc.k, loc.unroll, loc.stop, loc.armed = 0, unroll, stop, True

    def release(self) -> None:
        self._local.armed = False

    def step(self, device) -> tuple:
        """``(state, k, unroll)`` for the next round."""
        loc = self._local
        if not self.armed:
            return armed_state(device), 0, 1
        k = loc.k
        loc.k = (k + 1) % loc.unroll
        return loc.state, k, loc.unroll

    def read(self) -> list:
        """The carry's fields on the host: one copy, through a pinned
        buffer on the card, after which the host waits for the stream."""
        state = self._local.state
        if state.device.type != "cuda":
            return state.tolist()
        host = getattr(self._local, "host", None)
        if host is None:
            host = self._local.host = torch.empty(FIELDS, dtype=torch.int32, pin_memory=True)
        host.copy_(state, non_blocking=True)
        torch.cuda.current_stream(state.device).synchronize()
        return host.tolist()
