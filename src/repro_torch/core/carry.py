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

:func:`fold` is the plain form of that last block's work.  Nothing here
allocates or fills per round: the carry is armed once per fixed point.
"""
from __future__ import annotations

import threading

import torch

FLAG, ANY, ROUNDS, GO, TICKET = range(5)
FIELDS = 8  # int32 fields, padded to 32 bytes


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


def fold(state: torch.Tensor, flag: torch.Tensor, k: int, unroll: int) -> None:
    """Fold a round's ``changed`` flag into the carry, in place, as the
    merge's last block does on the card: nothing while GO is 0; else
    ``ANY |= flag`` and, for the last round of a check group (``k ==
    unroll - 1``), ``ROUNDS += unroll``, ``GO = ANY`` and ``ANY = 0``.
    Torch ops only, so the carry stays on its device."""
    go = state[GO : GO + 1]
    any_ = state[ANY : ANY + 1] | (flag.reshape(1).to(torch.int32) & go)
    if k == unroll - 1:
        state[ROUNDS : ROUNDS + 1] += unroll * go
        state[GO : GO + 1] = any_ & go
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

    def arm(self, device, unroll: int = 1) -> None:
        """Start a fixed point of check groups of ``unroll`` rounds: the
        carry set to :func:`armed_state` (allocated at the first use on
        ``device``)."""
        if unroll < 1:
            raise ValueError(f"unroll={unroll}: a check group holds at least one round")
        loc = self._local
        dev = torch.device(device)
        state = getattr(loc, "state", None)
        if state is None or state.device != dev:
            state = loc.state = torch.empty(FIELDS, dtype=torch.int32, device=dev)
        state.copy_(_armed_template(dev))
        _keep_views(state)
        loc.k, loc.unroll, loc.armed = 0, unroll, True

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
