"""Continuous-batching propagation service: slot-recycled buckets resident
on the device.

A fixed-batch driver (:func:`~repro_torch.core.propagator.propagate_batch`)
stops at batch boundaries: every new batch repacks and re-uploads, and the
whole batch waits for its slowest instance.  This module is the serving
loop that removes those stalls:

* Each :class:`BucketSpec` keeps ONE device-resident stream of ``slots``
  fixed-shape slots.  An arriving instance is packed on the host to the
  slot shape (:func:`~repro_torch.core.sparse.pack_into_slot`) and admitted
  by in-place copies of its tiles and bounds into a free slot -- the
  resident bucket is never repacked, reshaped or reallocated.
* The per-instance ``active`` mask of the batched kernels IS the
  slot-occupancy mask: a free (or just-retired) slot is an inactive
  instance, so kernel #8 skips its tiles on the device and #9 leaves its
  rows alone.  Retirement is host bookkeeping plus one read-back of the
  retiring rows.
* Each bucket's engine (its round and the admission staging buffers) is
  built and warmed when the service is constructed and cached process-wide
  by bucket shape -- admission and backfill build nothing
  (:meth:`PropagationService.compile_counts`).
* Each pump runs a bounded number of rounds per bucket
  (:func:`~repro_torch.core.propagator.batched_step_rounds` with a
  ``budget``), so one slow instance cannot hold a bucket hostage: converged
  co-residents retire and their slots backfill at the next step boundary
  while the slow instance keeps iterating.

Bitwise contract: a slot-resident instance follows the exact round
trajectory of a one-shot ``propagate_batch`` of the same instance with the
same tile parameters.  A round reads only the instance's own tiles, bounds
and rows, every kernel sums in one fixed order (a chunk in the warp's
order, a long row's chunks left to right), and the budgeted step is
resumable bit for bit, so co-residents and step boundaries cannot change
an instance's arithmetic.

Precision tiers (the reference's, src/repro/core/service.py:580-606): the
whole service runs at ``dtype=np.float32`` (the engines widen the merge
outward), and ``stop_progress``/``patience`` arm the progress-based early
retire: a slot whose per-round progress measure stays below
``stop_progress`` for ``patience`` rounds drops out of the occupancy mask
inside the step and retires stopped, not converged (``stats()`` counts
``early_stopped``).

Observability: a host-side tracer (``obs.trace``) emits
pump/admit/step/readback spans and one ``ticket`` span per request, and
``stats()`` carries a metrics-registry snapshot (``obs.metrics``).
``telemetry=`` (a ring capacity) arms the per-slot device telemetry
(``obs.telemetry``, state entries 13-16): admission resets a slot's rows,
every round of a step records each slot that ran with the batched record
kernel, and retirement copies the slot's rows out in the pinned read-back
it already makes, into a scalar-layout snapshot per ticket.  Without it
the entries are zero-width or idle.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Callable, Sequence

import numpy as np
import torch

from ..obs.metrics import default_registry
from ..obs.telemetry import TelemetryPlane, TelemetrySnapshot
from ..obs.trace import NULL_TRACER
from .lru import LRU
from .propagator import batched_step_rounds, check_dtype, resolve_device
from .sparse import Problem, SlotPayload, col_pad, pack_into_slot
from .types import DEFAULT_CONFIG, PropagationResult, PropagatorConfig

# Resident bucket state: a list of 17 tensors, allocated once per bucket and
# updated in place (the reference's layout):
#   0 val    (slots*slot_tiles, R, K)  tile values; 0 == padding
#   1 col    (slots*slot_tiles, R, K)  int32 SLOT-LOCAL columns
#   2 ii     (slots*slot_tiles, R, K)  int32 integrality gather
#   3 crow   (slots*slot_tiles, R)    int32 GLOBAL rows (slot offset applied)
#   4 lhs_c  (slots*slot_tiles, R)    per-chunk lhs (0 at dummy rows)
#   5 rhs_c  (slots*slot_tiles, R)    per-chunk rhs
#   6 lb     (slots, n_pad)           bound planes
#   7 ub     (slots, n_pad)
#   8 active (slots,) bool            occupancy mask == still-running mask
#   9 last_changed (slots,) bool      convergence evidence (as in fixed point)
#  10 rounds (slots,) int32           per-slot rounds executed
#  11 progress (slots,)               last round's progress measure (NaN fresh)
#  12 flat   (slots,) int32           consecutive low-progress rounds (the early retire)
#  13 ring   (slots, cap)             telemetry progress rings (cap may be 0)
#  14 ticks  (slots,) int32           telemetry rounds recorded per slot
#  15 stop_round (slots,) int32       early-stop round latch (-1 = never)
#  16 infeas_round (slots,) int32     first crossed-bounds round (-1 = never)
_LB, _UB, _ACTIVE, _LAST_CHANGED, _ROUNDS = 6, 7, 8, 9, 10
_PROGRESS, _FLAT = 11, 12
_RING, _TICKS, _STOPR, _INFSR = 13, 14, 15, 16
# The payload fields copied into a slot, in state order (val .. rhs_c, lb, ub).
_PAYLOAD_FIELDS = ("val", "col", "ii", "chunk_row", "lhs_c", "rhs_c", "lb", "ub")

_TW_CANDIDATES = (8, 16, 32, 64, 128)


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """Fixed slot geometry of one resident bucket.

    Slot ``i`` of a bucket owns tiles ``[i*slot_tiles, (i+1)*slot_tiles)``
    of the flat tile stream, the column window ``[i*n_pad, (i+1)*n_pad)``
    of the bound plane and the row range ``[i*(slot_rows+1),
    (i+1)*(slot_rows+1))`` (one dummy row per slot, at the resident
    instance's local ``m``).  Payloads are slot-local
    (:class:`~repro_torch.core.sparse.SlotPayload`); the admission scatter adds
    the slot offsets on device, so any payload fits any free slot.

    ``fits_one_chunk`` is the engine-path policy bit: when True the bucket
    runs the fused round (every row of every admitted instance must fit one
    ``tile_width`` chunk -- :meth:`admits` enforces it); otherwise the
    multichunk dataflow round handles split rows.
    """

    n_pad: int
    slots: int
    slot_tiles: int
    slot_rows: int
    tile_rows: int = 8
    tile_width: int = 128
    fits_one_chunk: bool = False

    @property
    def m_total(self) -> int:
        """Total rows of the resident bucket (one dummy row per slot)."""
        return self.slots * (self.slot_rows + 1)

    def chunks_needed(self, row_lengths: np.ndarray) -> int:
        """Chunks an instance with these row lengths occupies at this tile
        width (the :func:`~repro_torch.core.sparse.csr_to_block_ell` count: every
        row gets ``max(1, ceil(len/K))`` chunks, empty rows included)."""
        lengths = np.asarray(row_lengths, dtype=np.int64)
        return int(np.maximum(1, -(-lengths // self.tile_width)).sum())

    def tiles_needed(self, row_lengths: np.ndarray) -> int:
        """Tiles an instance with these row lengths occupies in a slot."""
        return max(1, -(-self.chunks_needed(row_lengths) // self.tile_rows))

    def fits_problem(self, p: Problem) -> bool:
        """Whether one instance fits a slot of this bucket (dimension,
        tile-count and -- on fused buckets -- row-width checks)."""
        if p.m > self.slot_rows or p.n > self.n_pad:
            return False
        lengths = np.diff(p.csr.row_ptr)
        max_row = int(lengths.max()) if lengths.size else 0
        if self.fits_one_chunk and max_row > self.tile_width:
            return False
        return self.tiles_needed(lengths) <= self.slot_tiles

    def admits(self, payload: SlotPayload) -> bool:
        """Whether an already-packed payload can occupy a slot: exact slot
        shape match plus the fused-path row-width contract."""
        if payload.val.shape != (self.slot_tiles, self.tile_rows, self.tile_width):
            return False
        if payload.n_pad != self.n_pad or payload.m > self.slot_rows:
            return False
        return not (self.fits_one_chunk and payload.max_row_nnz > self.tile_width)

    def pack(self, p: Problem, dtype=None) -> SlotPayload:
        """Pack one instance to this bucket's slot shape."""
        return pack_into_slot(
            p, self.slot_tiles, self.slot_rows, self.n_pad,
            tile_rows=self.tile_rows, tile_width=self.tile_width, dtype=dtype,
        )

    @classmethod
    def for_problems(
        cls,
        problems: Sequence[Problem],
        slots: int = 8,
        tile_rows: int = 8,
        tile_width: int | None = None,
        size_classes: int = 1,
    ) -> "list[BucketSpec]":
        """Derive bucket specs from a sample population: one spec per
        ``col_pad(n)`` class, slot capacity = the max over the class, tile
        width chosen (when not pinned) to maximize estimated slot fill --
        the same padding model as ``csr_to_block_ell`` -- so resident
        super-tiles stay dense instead of inheriting the default layout's
        worst-case padding.

        ``size_classes > 1`` additionally splits each ``col_pad`` class
        into that many tile-count quantiles with their own slot shapes.
        Slot capacity is the max over a bucket's population, so one
        outsized instance otherwise pads EVERY slot to its size; with
        quantile sub-buckets a small instance routes to a small slot
        (``fits_problem`` picks the first -- tightest -- fitting spec) and
        the resident super-tiles stay near the population's density."""
        groups: dict[int, list[Problem]] = {}
        for p in problems:
            groups.setdefault(col_pad(p.n), []).append(p)
        specs = []
        for n_pad in sorted(groups):
            ps = groups[n_pad]
            all_lens = [np.diff(p.csr.row_ptr) for p in ps]
            nnz = float(sum(p.nnz for p in ps))
            if tile_width is not None:
                tw = tile_width
            else:
                def padded(tw_):
                    tot = 0
                    for ls in all_lens:
                        chunks = int(np.maximum(1, -(-ls.astype(np.int64) // tw_)).sum())
                        tot += max(1, -(-chunks // tile_rows)) * tile_rows * tw_
                    return tot
                tw = max(_TW_CANDIDATES, key=lambda t: (nnz / padded(t), t))
            probe = cls(
                n_pad=n_pad, slots=slots, slot_tiles=1, slot_rows=1,
                tile_rows=tile_rows, tile_width=tw,
            )
            by_tiles = sorted(ps, key=lambda p: probe.tiles_needed(
                np.diff(p.csr.row_ptr)
            ))
            q = max(1, -(-len(by_tiles) // max(1, size_classes)))
            subs = [by_tiles[i:i + q] for i in range(0, len(by_tiles), q)]
            # Suffix-max slot_rows: classes are split by TILE count, so a
            # small-tiles instance may still carry more rows than its own
            # class max; widening every class to the row max of itself and
            # all larger classes guarantees each sampled instance fits the
            # first spec whose tile capacity admits it.
            row_caps = [max(p.m for p in sub) for sub in subs]
            for i in range(len(row_caps) - 2, -1, -1):
                row_caps[i] = max(row_caps[i], row_caps[i + 1])
            for sub, slot_rows in zip(subs, row_caps):
                lens = [np.diff(p.csr.row_ptr) for p in sub]
                slot_tiles = max(probe.tiles_needed(ls) for ls in lens)
                max_row = max((int(ls.max()) if ls.size else 0) for ls in lens)
                specs.append(cls(
                    n_pad=n_pad, slots=slots, slot_tiles=slot_tiles,
                    slot_rows=slot_rows, tile_rows=tile_rows, tile_width=tw,
                    fits_one_chunk=max_row <= tw,
                ))
        # Tightest spec first, so routing admits each instance to the
        # smallest slot shape that fits it.
        specs.sort(key=lambda s: (s.n_pad, s.slot_tiles, s.slot_rows))
        return specs


def _pow2_decomposition(n: int) -> list[int]:
    """``n`` as descending powers of two (the admission group sizes)."""
    return [1 << b for b in range(n.bit_length() - 1, -1, -1) if (n >> b) & 1]


class ServiceTicket:
    """Future for one submitted instance.

    Carries the packed payload until admission and the
    :class:`~repro_torch.core.types.PropagationResult` (tensors on the CPU)
    after retirement; ``submit_t``/``admit_t``/``done_t`` are
    ``perf_counter`` stamps for the latency percentiles.
    """

    __slots__ = (
        "problem", "payload", "submit_t", "admit_t", "done_t",
        "slot", "_result", "_event",
    )

    def __init__(self, problem: Problem | None, payload: SlotPayload):
        self.problem = problem
        self.payload = payload
        self.submit_t = time.perf_counter()
        self.admit_t: float | None = None
        self.done_t: float | None = None
        self.slot: int | None = None
        self._result: PropagationResult | None = None
        self._event = threading.Event()

    def done(self) -> bool:
        """Whether the instance has retired (result available)."""
        return self._event.is_set()

    def result(self, timeout: float | None = None) -> PropagationResult:
        """Block until the instance retires and return its result."""
        if not self._event.wait(timeout):
            raise TimeoutError("instance has not retired yet")
        assert self._result is not None
        return self._result

    def latency(self) -> float | None:
        """Submit-to-retire wall seconds (``None`` until retirement)."""
        if self.done_t is None:
            return None
        return self.done_t - self.submit_t

    def queue_latency(self) -> float | None:
        """Submit-to-admit wall seconds (``None`` until admission) -- how
        long the instance waited for a free slot."""
        if self.admit_t is None:
            return None
        return self.admit_t - self.submit_t

    def service_latency(self) -> float | None:
        """Admit-to-retire wall seconds (``None`` until retirement) -- the
        resident time actually spent propagating."""
        if self.done_t is None or self.admit_t is None:
            return None
        return self.done_t - self.admit_t


class _BucketEngine:
    """What one bucket shape needs to run, built once and shared by every
    bucket of that shape (:func:`_get_engine`): its round, the admission
    staging buffers on the device (one payload group of the largest
    power-of-two size, smaller groups use a leading part), and the index
    constants.  PyTorch runs eagerly, so nothing is traced or compiled;
    ``builds`` counts how often an engine of this shape was built
    (:meth:`PropagationService.compile_counts`).

    The round is the port's ``batched_reference_round``: kernel #8 then #9
    on a bucket whose rows fit one chunk, otherwise A', the combine and E
    on the flat stream with global columns, then #9, whose combine segments
    and their short/long classes follow the resident rows: recomputed on
    the device at each admission (:meth:`_resegment`).  #8 walks each
    occupied slot's chunk range (slot ``i`` owns chunks ``[i * slot_tiles *
    R, (i + 1) * slot_tiles * R)``, fixed at construction) and scatters
    into accumulator planes the engine keeps (``kept``, one pair per thread,
    shared by the buckets of its shape: #9 hands the rows #8 scattered into
    back at the sentinels, so every round finds them clean; a round that
    raises drops them).  The engine runs at ``dtype`` (float64 or float32:
    tiles, bounds and the round's eps and outward widening); with
    ``stop_progress`` its step arms the per-slot early stop, #9 measuring
    every round (its partials kept with the planes)."""

    builds: "dict[tuple, int]" = {}

    def __init__(self, spec: "BucketSpec", cfg: PropagatorConfig, rounds_per_step: int,
                 use_kernels: bool, device: torch.device, key: tuple,
                 dtype: torch.dtype = torch.float64, stop_progress: float | None = None,
                 patience: int = 1):
        # lazy: kernels imports core
        from ..kernels import ops as kops, prop_round as kern, ref as kref

        self.spec, self.cfg, self.device, self.key = spec, cfg, device, key
        self.rounds_per_step = rounds_per_step
        self.dtype, self.stop_progress, self.patience = dtype, stop_progress, patience
        self._lock = threading.RLock()
        self.warmed = False
        s, t, r, k = spec.slots, spec.slot_tiles, spec.tile_rows, spec.tile_width
        dt = dtype
        n_pad, eps, int_eps, inf = spec.n_pad, cfg.eps_for(dt), cfg.int_eps, cfg.inf
        outward = cfg.outward_for(dt)
        ti = torch.arange(s, dtype=torch.int32, device=device).repeat_interleave(t)
        self.tile_inst = ti
        self.tile_arange = torch.arange(t, device=device)
        self.positions = torch.arange(s * t * r, device=device)
        self.chunk_slot = self.positions // (t * r)
        kmax = 1 << (s.bit_length() - 1)
        z = lambda shape, d: torch.zeros(shape, dtype=d, device=device)
        self.stage = {
            "val": z((kmax, t, r, k), dt), "col": z((kmax, t, r, k), torch.int32),
            "ii": z((kmax, t, r, k), torch.int32), "chunk_row": z((kmax, t, r), torch.int32),
            "lhs_c": z((kmax, t, r), dt), "rhs_c": z((kmax, t, r), dt),
            "lb": z((kmax, n_pad), dt), "ub": z((kmax, n_pad), dt),
            "slot_ids": z((kmax,), torch.int64), "m": z((kmax,), torch.int32),
        }
        ops = kops.KERNEL_OPS if use_kernels else kops.PLAIN_OPS
        self.chunk_lengths = kref.chunk_lengths
        self.segment_classes = kref.segment_classes
        slot_chunks = torch.arange(s + 1, dtype=torch.int64, device=device) * (t * r)
        self.kept = kops.KeptPlanes(inf)

        def round_fn(state, aux, lb, ub, act, progress=None):
            col_g, seg, seg_start, _, clen, classes, max_len = aux
            row_start = None if seg_start is None else seg_start[:-1]
            return kops.batched_reference_round(
                state[0], state[1], col_g, ti, state[2], seg, row_start, state[4], state[5],
                lb, ub, act, n_pad=n_pad, fits_one_chunk=spec.fits_one_chunk, eps=eps,
                int_eps=int_eps, inf=inf, kept=self.kept, outward=outward, ops=ops,
                chunk_len=clen, max_chunk_len=max_len[0], chunks=slot_chunks, classes=classes,
                progress=progress,
            )

        self.round_fn = self.kept.guard(round_fn)
        self.record_batch = kern.RecordBatchLaunch if use_kernels else None
        _BucketEngine.builds[key] = _BucketEngine.builds.get(key, 0) + 1

    def init_state(self, telemetry: int = 0) -> "tuple[list, tuple]":
        """A fresh all-empty resident state: zero tiles, every chunk parked
        on its slot's dummy row, every slot inactive (== unoccupied); and
        its derived tensors ``(col_g, seg, seg_start, dummy, chunk_len,
        classes, max_chunk_len)``: the first four and ``classes`` for the
        multi-chunk round (Nones on a bucket whose rows fit one chunk);
        ``chunk_len`` is where #8, or A' and E, stop each resident chunk,
        ``telemetry`` the width of the slots' telemetry rings (0: none),
        ``classes`` (a list) the combine's short and long segments (fixed
        lengths, padded with -1), and ``max_chunk_len`` (a one-entry list)
        the longest chunk admitted so far, which only grows; all kept
        current at each admission."""
        spec, dev = self.spec, self.device
        s, t, r, k = spec.slots, spec.slot_tiles, spec.tile_rows, spec.tile_width
        dt = self.dtype
        z = lambda shape, d=dt: torch.zeros(shape, dtype=d, device=dev)
        dummy = torch.arange(s, dtype=torch.int32, device=dev) * (spec.slot_rows + 1)
        dummy += spec.slot_rows
        crow = dummy.repeat_interleave(t)[:, None].repeat(1, r)
        state = [
            z((s * t, r, k)), z((s * t, r, k), torch.int32), z((s * t, r, k), torch.int32),
            crow.contiguous(), z((s * t, r)), z((s * t, r)),
            z((s, spec.n_pad)), z((s, spec.n_pad)),
            z((s,), torch.bool), z((s,), torch.bool), z((s,), torch.int32),
            torch.full((s,), float("nan"), dtype=dt, device=dev), z((s,), torch.int32),
            torch.full((s, int(telemetry)), float("nan"), dtype=dt, device=dev),
            z((s,), torch.int32),
            torch.full((s,), -1, dtype=torch.int32, device=dev),
            torch.full((s,), -1, dtype=torch.int32, device=dev),
        ]
        clen = z((s * t, r), torch.int32)
        aux = (None, None, None, None, clen, None, [0])
        if not spec.fits_one_chunk:
            col_g = state[1] + (self.tile_inst * spec.n_pad)[:, None, None]
            aux = (col_g, torch.empty_like(crow), self.positions.new_empty(s * t * r + 2), dummy,
                   clen, [None, None], [0])
            self._resegment(state, aux)
        return state, aux

    def _resegment(self, state: list, aux: tuple) -> None:
        """The long-row combine's segments over the resident chunks, in
        place: a segment starts where the row changes or at a chunk on its
        slot's dummy row (``aux[3]``: the resident payload's ``m``, or the
        last local row of an empty slot).  Each real row stays one segment,
        whatever its
        values (explicit zeros included), summed left to right as in the
        one-shot batch; a payload's padding chunks and a slot's unused tail,
        all on the dummy row, become one-chunk segments (zeros), so no
        thread of the combine walks them in series.  ``seg`` is each chunk's
        segment id (in place of its row), ``seg_start[:-1]`` the
        ``row_start`` of the segments, padded with empty ones at the end,
        and ``classes`` their short and long segments."""
        _, seg, start, dummy, _, classes, _ = aux
        n = seg.numel()
        crow = state[3].view(-1)
        new = crow == dummy.index_select(0, self.chunk_slot)
        new[1:] |= crow[1:] != crow[:-1]
        new[0] = True
        ids = torch.cumsum(new, 0) - 1
        seg.view(-1).copy_(ids)
        start.fill_(n)
        start.scatter_(0, torch.where(new, ids, n + 1), self.positions)
        classes[:] = self.segment_classes(start[:-1], n_chunks=n)

    def admit(self, state: list, aux: tuple, payloads: "Sequence[SlotPayload]",
              slot_ids: "Sequence[int]") -> None:
        """Copy ``k`` payloads (a power of two) into slots ``slot_ids``, in
        place: host stacking into the staging buffers, the slot offset of
        each chunk's row added on the device, one ``index_copy_`` per
        field; the slots' loop state is reset, the chunk lengths and the
        longest chunk follow the new tiles (the latter from the host's
        payloads), and the multi-chunk round's ``col_g`` and combine
        segments follow the new rows."""
        spec = self.spec
        t, r, k = spec.slot_tiles, spec.tile_rows, spec.tile_width
        g = len(payloads)
        with self._lock:
            st = {f: x[:g] for f, x in self.stage.items()}
            for f in _PAYLOAD_FIELDS:
                st[f].copy_(torch.from_numpy(np.stack([getattr(p, f) for p in payloads])))
            ids = st["slot_ids"]
            ids.copy_(torch.as_tensor(list(slot_ids), dtype=torch.int64))
            st["chunk_row"].add_((ids * (spec.slot_rows + 1)).to(torch.int32)[:, None, None])
            tix = (ids[:, None] * t + self.tile_arange).view(-1)
            for i, f in enumerate(_PAYLOAD_FIELDS[:6]):
                state[i].index_copy_(0, tix, st[f].view(g * t, *state[i].shape[1:]))
            state[_LB].index_copy_(0, ids, st["lb"])
            state[_UB].index_copy_(0, ids, st["ub"])
            for idx, value in ((_ACTIVE, True), (_LAST_CHANGED, True), (_ROUNDS, 0),
                               (_PROGRESS, float("nan")), (_FLAT, 0), (_RING, float("nan")),
                               (_TICKS, 0), (_STOPR, -1), (_INFSR, -1)):
                state[idx].index_fill_(0, ids, value)
            col_g, _, _, dummy, clen, _, max_len = aux
            clen.index_copy_(0, tix, self.chunk_lengths(st["val"].view(g * t, r, k)))
            max_len[0] = max(max_len[0], *(_longest_chunk(p.val) for p in payloads))
            if col_g is not None:
                col_g.index_copy_(0, tix, (st["col"] + (ids * spec.n_pad).to(torch.int32)
                                           [:, None, None, None]).view(g * t, r, k))
                st["m"].copy_(torch.as_tensor([p.m for p in payloads], dtype=torch.int32))
                dummy.index_copy_(0, ids, st["m"] + (ids * (spec.slot_rows + 1)).to(torch.int32))
                self._resegment(state, aux)

    def step(self, state: list, aux: tuple, on_sync: Callable[[], None] | None = None) -> None:
        """Up to ``rounds_per_step`` occupancy-masked rounds over the
        resident state, in place (bounds and loop state), with the early
        stop where the engine arms one; where the state's telemetry rings
        have a width, every round records each slot that ran into them (the
        batched record kernel, in place)."""
        planes = state[_LB:_FLAT + 1]

        def round_fn(lb, ub, act, **kw):
            return self.round_fn(state, aux, lb, ub, act, **kw)

        round_fn.measured = True
        if self.record_batch is not None:
            round_fn.record_batch = self.record_batch
        plane = TelemetryPlane(*state[_RING:_INFSR + 1]) if state[_RING].shape[1] else None
        out = batched_step_rounds(
            round_fn, *planes[:5], self.cfg.max_rounds, budget=self.rounds_per_step,
            stop_progress=self.stop_progress, patience=self.patience,
            progress=planes[5], flat=planes[6], with_progress=True, plane=plane,
            feas_eps=self.cfg.feas_eps, on_sync=on_sync,
        )
        for dst, src in zip(planes, out):
            if src is not dst:
                dst.copy_(src)

    def warm(self) -> None:
        """Build the kernel library (on a CUDA device) and run one step over
        a throwaway empty state (idempotent): after this, admission,
        backfill and steps build nothing."""
        with self._lock:
            if self.warmed:
                return
            if self.device.type == "cuda":
                from ..kernels import _build

                _build.lib()
            self.step(*self.init_state())
            self.warmed = True


def _longest_chunk(val: np.ndarray) -> int:
    """One past the last nonzero slot of the longest chunk of ``(T, R, K)``
    host tiles (0 for all padding): the host's view of ``max(chunk_len)``."""
    used = np.flatnonzero((val != 0).reshape(-1, val.shape[-1]).any(axis=0))
    return int(used[-1]) + 1 if used.size else 0


# Process-wide engine cache, by bucket shape.
_engine_cache = LRU(16)


def _get_engine(spec, cfg, rounds_per_step, use_kernels, device, dtype=torch.float64,
                stop_progress=None, patience=1) -> _BucketEngine:
    """Fetch-or-build the warmed engine of one bucket shape, dtype and early
    stop."""
    key = (spec, dataclasses.astuple(cfg), rounds_per_step, use_kernels, str(device), str(dtype),
           stop_progress, patience)
    eng = _engine_cache.get(key, ())
    if eng is None:
        eng = _BucketEngine(spec, cfg, rounds_per_step, use_kernels, device, key, dtype,
                            stop_progress, patience)
        _engine_cache.put(key, (), eng)
    eng.warm()
    return eng


def _label(spec: "BucketSpec") -> str:
    return f"n_pad={spec.n_pad}/tw={spec.tile_width}/slot_tiles={spec.slot_tiles}"


class _Bucket:
    """Runtime state of one resident bucket: the device state and its
    derived tensors, the slot -> ticket table (the host half of the
    occupancy mask) and the admission queue."""

    def __init__(self, spec: BucketSpec, engine: _BucketEngine, telemetry: int = 0):
        self.spec = spec
        self.engine = engine
        self.state, self.aux = engine.init_state(telemetry)
        self.slot_tickets: list[ServiceTicket | None] = [None] * spec.slots
        self.queue: deque[ServiceTicket] = deque()
        self.retired = 0
        self.early_stopped = 0
        self.occupancy_sum = 0.0
        self.pumps = 0

    def occupied(self) -> int:
        return sum(t is not None for t in self.slot_tickets)


class PropagationService:
    """Continuous-batching domain-propagation service.

    Construct with bucket specs (or :meth:`from_problems`), then either
    drive it synchronously (``submit`` + ``pump``/``drain``/``serve``) or
    start the background pump thread (``start``/``stop``, or the context
    manager) and treat ``submit`` as an asynchronous request API.  Every
    engine is built and warmed at construction; steady-state operation
    builds nothing, never repacks a batch and never reallocates a bucket.

    ``device`` defaults to CUDA and raises where there is none;
    ``use_kernels=False`` runs the kernels' plain versions.  ``on_sync`` is
    called for every host read of a flag: each round of a step reads
    ``active.any()`` (and, without an early stop, each step once more for
    the round counts), and each pump reads a stepped bucket's ``active``
    mask once.  ``dtype`` is float64 (the default) or float32 (the whole
    service's fp32 tier; payloads are packed at it).  ``stop_progress``/
    ``patience`` arm the early retire: a slot whose progress measure stays
    below ``stop_progress`` for ``patience`` rounds retires stopped, not
    converged, counted in ``stats()["early_stopped"]`` (a retired slot with
    ``last_changed`` set and ``rounds < max_rounds``).  There is no
    per-slot tier promotion (no ``policy=``), as in the reference.
    ``telemetry`` (a ring capacity) arms the per-slot device telemetry:
    each retired ticket's result carries an ``obs.TelemetrySnapshot`` (a
    host copy in the scalar layout, taken in the retirement's read-back);
    the engines and reads are the same as without it.

    Observability: ``tracer`` (an ``obs.trace.Tracer``) records a span for
    every pump/admit/step/readback plus one ``ticket`` span per retired
    instance; the default ``NULL_TRACER`` records nothing.  ``metrics`` is
    an :class:`~repro_torch.obs.metrics.MetricsRegistry` preloaded with the
    kernel and engine caches, build counts and service counters; its
    snapshot rides ``stats()['metrics']``.
    """

    def __init__(
        self,
        specs: Sequence[BucketSpec],
        cfg: PropagatorConfig = DEFAULT_CONFIG,
        dtype=np.float64,
        rounds_per_step: int = 8,
        use_kernels: bool = True,
        stop_progress: float | None = None,
        patience: int = 1,
        telemetry: int | None = None,
        tracer=None,
        device="cuda",
        on_sync: Callable[[], None] | None = None,
    ):
        if not specs:
            raise ValueError("PropagationService needs at least one BucketSpec")
        self._telemetry = int(telemetry or 0)
        self._dtype = check_dtype(dtype)
        self._np_dtype = np.float32 if self._dtype == torch.float32 else np.float64
        self._stop_progress = stop_progress
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            # The pump thread selects this card by index (``start``).
            dev = torch.device("cuda", torch.cuda.current_device())
        self._device = dev
        self._cfg = cfg
        self._on_sync = on_sync
        self._tracer = NULL_TRACER if tracer is None else tracer
        self._lock = threading.RLock()
        self._wake = threading.Event()
        self._stop_evt = threading.Event()
        self._thread: threading.Thread | None = None
        self._submitted = 0
        self._buckets = [
            _Bucket(spec, _get_engine(spec, cfg, rounds_per_step, use_kernels, self._device,
                                      self._dtype, stop_progress, patience), self._telemetry)
            for spec in specs
        ]
        self.metrics = default_registry()
        self.metrics.register("engine_cache", _engine_cache.info)
        self.metrics.register("compile_counts", self.compile_counts)
        self.metrics.register("service", self._counters)

    @classmethod
    def from_problems(
        cls,
        problems: Sequence[Problem],
        slots: int = 8,
        tile_rows: int = 8,
        tile_width: int | None = None,
        size_classes: int = 1,
        **kwargs,
    ) -> "PropagationService":
        """Build a service sized for a sample population (one bucket per
        ``col_pad`` class -- or per tile-count quantile within it when
        ``size_classes > 1`` -- with fill-tuned tile width; see
        :meth:`BucketSpec.for_problems`)."""
        specs = BucketSpec.for_problems(
            problems, slots=slots, tile_rows=tile_rows,
            tile_width=tile_width, size_classes=size_classes,
        )
        return cls(specs, **kwargs)

    # -- request path ------------------------------------------------------

    def submit(
        self, problem: Problem | None = None, payload: SlotPayload | None = None
    ) -> ServiceTicket:
        """Enqueue one instance and return its ticket.

        Routing picks the first bucket that fits; packing to the slot shape
        happens here (on the host, outside the service lock) unless a
        pre-packed ``payload`` is supplied, as a caller timing the device
        loop does."""
        if payload is None:
            if problem is None:
                raise ValueError("submit() needs a problem or a payload")
            for bk in self._buckets:
                if bk.spec.fits_problem(problem):
                    payload = bk.spec.pack(problem, dtype=self._np_dtype)
                    break
            else:
                raise ValueError(f"no bucket fits instance m={problem.m} n={problem.n}")
        ticket = ServiceTicket(problem, payload)
        with self._lock:
            for bk in self._buckets:
                if bk.spec.admits(payload):
                    bk.queue.append(ticket)
                    self._submitted += 1
                    break
            else:
                raise ValueError("no bucket admits the given payload")
        self._wake.set()
        return ticket

    # -- device loop -------------------------------------------------------

    def _sync(self) -> None:
        if self._on_sync is not None:
            self._on_sync()

    def pump(self) -> dict:
        """One service cycle over every bucket: admit into free slots
        (power-of-two groups), run one budgeted step where any slot is
        occupied, read the ``active`` mask once and retire the slots that
        stopped (their rows are copied out before any later admission can
        overwrite them).  Returns the cycle's counters.

        With a tracer attached the cycle records one ``pump`` span with
        nested ``admit``/``step``/``readback`` spans per bucket, plus one
        ``ticket`` span per retirement."""
        admitted = retired = stepped = 0
        tr = self._tracer
        with tr.span("pump"), self._lock:
            for bk in self._buckets:
                label = _label(bk.spec)
                free = [i for i, tk in enumerate(bk.slot_tickets) if tk is None]
                take = min(len(free), len(bk.queue))
                if take:
                    with tr.span("admit", bucket=label, count=take):
                        tickets = [bk.queue.popleft() for _ in range(take)]
                        pos = 0
                        for k in _pow2_decomposition(take):
                            group, slot_ids = tickets[pos:pos + k], free[pos:pos + k]
                            pos += k
                            bk.engine.admit(bk.state, bk.aux, [tk.payload for tk in group],
                                            slot_ids)
                            now = time.perf_counter()
                            for s, tk in zip(slot_ids, group):
                                bk.slot_tickets[s] = tk
                                tk.admit_t = now
                                tk.slot = s
                    admitted += take
                occ = bk.occupied()
                bk.occupancy_sum += occ / bk.spec.slots
                bk.pumps += 1
                if not occ:
                    continue
                with tr.span("step", bucket=label, occupied=occ):
                    bk.engine.step(bk.state, bk.aux, self._on_sync)
                stepped += 1
                active_h = bk.state[_ACTIVE].cpu()
                self._sync()
                done_slots = [i for i, tk in enumerate(bk.slot_tickets)
                              if tk is not None and not active_h[i]]
                if not done_slots:
                    continue
                with tr.span("readback", bucket=label, retired=len(done_slots)):
                    rows = self._read_rows(bk, done_slots)
                lb_h, ub_h, lc_h, rd_h, pg_h = rows[:5]
                now = time.perf_counter()
                for j, i in enumerate(done_slots):
                    tk = bk.slot_tickets[i]
                    n = tk.payload.n
                    lb_i, ub_i = lb_h[j, :n].clone(), ub_h[j, :n].clone()
                    # An early-retired slot leaves last_changed set with
                    # rounds below the cap: stopped, not converged.
                    conv = not bool(lc_h[j])
                    if (self._stop_progress is not None and not conv
                            and int(rd_h[j]) < self._cfg.max_rounds):
                        bk.early_stopped += 1
                    tel = None
                    if self._telemetry:
                        # The slot will be recycled: its rows, copied out
                        # of the shared plane, in the scalar layout.
                        tel = TelemetrySnapshot(plane=TelemetryPlane(
                            *(x[j].clone() for x in rows[5:])))
                    tk._result = PropagationResult(
                        lb=lb_i, ub=ub_i, rounds=rd_h[j].clone(), converged=~lc_h[j],
                        infeasible=(lb_i > ub_i + self._cfg.feas_eps).any(),
                        progress=pg_h[j].clone(), tier_rounds=torch.zeros_like(rd_h[j]),
                        telemetry=tel,
                    )
                    tk.done_t = now
                    tr.record(
                        "ticket", tk.submit_t, now, bucket=label, slot=i,
                        queue_ms=(tk.admit_t - tk.submit_t) * 1e3,
                        service_ms=(now - tk.admit_t) * 1e3,
                        rounds=int(rd_h[j]), converged=conv,
                    )
                    bk.slot_tickets[i] = None
                    bk.retired += 1
                    tk._event.set()
                retired += len(done_slots)
            pending = sum(len(bk.queue) for bk in self._buckets)
            occupied = sum(bk.occupied() for bk in self._buckets)
        return {
            "admitted": admitted,
            "retired": retired,
            "stepped": stepped,
            "pending": pending,
            "occupied": occupied,
        }

    def _read_rows(self, bk: _Bucket, rows: "list[int]"):
        """The retiring rows of the bound planes and loop state (and, with
        telemetry, of the telemetry plane), on the host: one gather and one
        copy per plane (into pinned memory, without blocking, on a CUDA
        device), then one synchronize."""
        cuda = self._device.type == "cuda"
        idx = torch.as_tensor(rows, dtype=torch.int64).to(self._device)
        out = []
        planes = (_LB, _UB, _LAST_CHANGED, _ROUNDS, _PROGRESS)
        if self._telemetry:
            planes += (_RING, _TICKS, _STOPR, _INFSR)
        for plane in planes:
            src = bk.state[plane].index_select(0, idx)
            host = torch.empty(src.shape, dtype=src.dtype, pin_memory=cuda)
            host.copy_(src, non_blocking=cuda)
            out.append(host)
        if cuda:
            torch.cuda.current_stream(self._device).synchronize()
        return out

    def drain(self, max_pumps: int | None = None) -> None:
        """Pump until every submitted instance has retired."""
        pumps = 0
        while True:
            res = self.pump()
            pumps += 1
            if res["pending"] == 0 and res["occupied"] == 0:
                return
            if max_pumps is not None and pumps >= max_pumps:
                raise RuntimeError(f"drain did not finish in {max_pumps} pumps")

    def serve(self, problems: Sequence[Problem]) -> list[PropagationResult]:
        """Submit a population and return results in submit order (pumps
        inline unless the background thread is running)."""
        tickets = [self.submit(p) for p in problems]
        if self._thread is not None and self._thread.is_alive():
            return [tk.result() for tk in tickets]
        while not all(tk.done() for tk in tickets):
            self.pump()
        return [tk.result() for tk in tickets]

    # -- background thread -------------------------------------------------

    def start(self) -> None:
        """Start the background pump thread (idempotent): pumps continuously
        while work exists, parks on an event when idle."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return
            self._stop_evt.clear()
            self._thread = threading.Thread(
                target=self._loop, name="propagation-service", daemon=True
            )
            self._thread.start()

    def _loop(self) -> None:
        if self._device.type == "cuda":
            torch.cuda.set_device(self._device)
        while not self._stop_evt.is_set():
            res = self.pump()
            if not (res["admitted"] or res["stepped"]):
                self._wake.wait(timeout=0.002)
                self._wake.clear()

    def stop(self, timeout: float = 10.0) -> None:
        """Stop the background thread (idempotent; queued work stays)."""
        self._stop_evt.set()
        self._wake.set()
        th = self._thread
        if th is not None:
            th.join(timeout)
        self._thread = None

    def __enter__(self) -> "PropagationService":
        """Context manager: run the background loop for the block."""
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- observability -----------------------------------------------------

    @property
    def tracer(self):
        """The attached span tracer (``NULL_TRACER`` when tracing is off)."""
        return self._tracer

    def _counters(self) -> dict:
        """The registry's ``service`` source: the live global counters."""
        with self._lock:
            return {
                "submitted": self._submitted,
                "retired": sum(bk.retired for bk in self._buckets),
                "early_stopped": sum(bk.early_stopped for bk in self._buckets),
                "pending": sum(len(bk.queue) for bk in self._buckets),
                "occupied": sum(bk.occupied() for bk in self._buckets),
                "telemetry_capacity": self._telemetry,
            }

    def stats(self) -> dict:
        """Service stats endpoint: per-bucket occupancy/padding histogram in
        the shape of ``batch_stats()['per_bucket']`` (over the RESIDENT
        instances), queue depths, retire counters, mean occupancy, the
        engine-cache and kernel-cache counters, and the ``metrics`` registry
        snapshot (pinned schema -- see ``obs.metrics``)."""
        from ..kernels.ops import cache_info  # lazy: kernels imports core

        with self._lock:
            buckets = []
            for bk in self._buckets:
                spec = bk.spec
                resident = [tk for tk in bk.slot_tickets if tk is not None]
                nnz = int(sum(tk.payload.nnz for tk in resident))
                padded = len(resident) * spec.slot_tiles * spec.tile_rows * spec.tile_width
                fill = nnz / padded if padded else 0.0
                buckets.append({
                    "n_pad": spec.n_pad,
                    "slots": spec.slots,
                    "slot_tiles": spec.slot_tiles,
                    "slot_rows": spec.slot_rows,
                    "tile_rows": spec.tile_rows,
                    "tile_width": spec.tile_width,
                    "occupied": bk.occupied(),
                    "pending": len(bk.queue),
                    "retired": bk.retired,
                    "early_stopped": bk.early_stopped,
                    "mean_occupancy": bk.occupancy_sum / bk.pumps if bk.pumps else 0.0,
                    "histogram": {
                        "n_pad": spec.n_pad,
                        "instances": len(resident),
                        "tiles": len(resident) * spec.slot_tiles,
                        "tile_rows": spec.tile_rows,
                        "tile_width": spec.tile_width,
                        "nnz": nnz,
                        "padded_slots": padded,
                        "fill": fill,
                        "padding_fraction": 1.0 - fill if padded else 0.0,
                    },
                })
            return {
                "submitted": self._submitted,
                "retired": sum(bk.retired for bk in self._buckets),
                "early_stopped": sum(bk.early_stopped for bk in self._buckets),
                "pending": sum(len(bk.queue) for bk in self._buckets),
                "occupied": sum(bk.occupied() for bk in self._buckets),
                "buckets": buckets,
                "engine_cache": _engine_cache.info(),
                "kernel_caches": cache_info(),
                "metrics": self.metrics.snapshot(),
            }

    def compile_counts(self) -> dict:
        """Per bucket: how many times an engine of its shape was built and
        how many times the kernel library was compiled in this process.
        Both stay constant after construction through any number of
        admissions and backfills -- the port's form of the reference's
        "backfill never compiles"."""
        from ..kernels import _build

        return {
            _label(bk.spec): {
                "engine_builds": _BucketEngine.builds[bk.engine.key],
                "library_builds": _build.build_count,
            }
            for bk in self._buckets
        }
