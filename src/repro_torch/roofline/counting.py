"""Per-rank cost counting of an eager step: the counterpart of the JAX
package's ``roofline/hlo_flops.py``, which parses optimized HLO text.

:class:`CostCounter` is a ``TorchDispatchMode``.  It steps aside for
DTensor (returns ``NotImplemented`` for it), so DTensor's dispatch runs
and the mode sees the *local* ops each rank runs, on local shapes:
one rank's share of the work, as the JAX package's per-device numbers
are (``torch.utils.flop_counter.FlopCounterMode`` on a DTensor counts
the global product).  The shape-only tensors that DTensor's sharding
propagation runs ops on, to learn an output's global shape, are not
counted.  It records:

  * dot FLOPs (``2 * prod(result) * contraction``) of ``mm``, ``addmm``,
    ``bmm``, ``baddbmm`` (``einsum`` and ``matmul`` lower to these) and
    the fused attention ops, from ``torch.utils.flop_counter``'s registry,
    by label: the innermost ``torch.autograd.profiler.record_function``
    scope (the model labels each layer ``segments/<i>/<kind>``), with
    ``backward/`` before it for an op of the autograd engine -- the
    counterpart of the HLO ``op_name`` prefix;
  * HBM traffic by the JAX package's fusion-aware rule: operand and result
    bytes of dots, gathers (``index``, ``embedding``, ``gather``,
    ``index_select``), scatters (``index_put``, ``scatter*``,
    ``index_add``) and dynamic slice updates (``slice_scatter``, a
    ``copy_`` into a view), elementwise chains assumed fused;
  * collective operand bytes by type (the ``_c10d_functional`` ops DTensor
    issues, the ``c10d`` ops of ``torch.distributed``), under the keys of
    ``roofline.analysis.collective_bytes``;
  * with ``track_memory=True``, the peak of the bytes of the storages the
    step's ops allocate and still hold (views and in-place results
    allocate nothing; arguments made before the step are not counted: the
    dry run adds them).

The record works on ``meta`` tensors too, so a dry run counts a 256-rank
step without allocating it.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

COLLECTIVE_KEYS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                   "collective-permute")

_DOTS = ("mm", "addmm", "bmm", "baddbmm")
_GATHERS = ("index", "embedding", "gather", "index_select")
_SCATTERS = ("index_put", "index_put_", "_index_put_impl_", "scatter", "scatter_",
             "scatter_add", "scatter_add_", "scatter_reduce", "scatter_reduce_",
             "index_add", "index_add_", "slice_scatter", "select_scatter")
# op name (overload packet) -> (collective key, position of the operand).
# The JAX package counts all-gather and reduce-scatter by their operand
# (result / group, result x group) and the others by their result, which
# for these equals the operand; ``torch.distributed``'s ``c10d`` ops take
# lists of tensors, their inputs after their outputs where they have both.
_COLLECTIVES = {
    "all_gather_into_tensor": ("all-gather", 0),
    "all_gather_into_tensor_coalesced": ("all-gather", 0),
    "allgather_": ("all-gather", 1), "_allgather_base_": ("all-gather", 1),
    "allgather_into_tensor_coalesced_": ("all-gather", 1),
    "all_reduce": ("all-reduce", 0), "all_reduce_coalesced": ("all-reduce", 0),
    "allreduce_": ("all-reduce", 0), "allreduce_coalesced_": ("all-reduce", 0),
    "reduce_scatter_tensor": ("reduce-scatter", 0),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", 0),
    "reduce_scatter_": ("reduce-scatter", 1), "_reduce_scatter_base_": ("reduce-scatter", 1),
    "all_to_all_single": ("all-to-all", 0), "alltoall_": ("all-to-all", 1),
    "alltoall_base_": ("all-to-all", 1), "shard_dim_alltoall": ("all-to-all", 0),
    "broadcast": ("collective-permute", 0), "broadcast_": ("collective-permute", 0),
    "send": ("collective-permute", 0), "recv_": ("collective-permute", 0),
}


def _tensors(obj) -> list:
    return [t for t in tree_flatten(obj)[0] if isinstance(t, torch.Tensor)]


def _bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclasses.dataclass
class CostRecord:
    """What a :class:`CostCounter` counted, per rank."""

    flops_by_label: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    hbm_bytes: float = 0.0
    collectives: Dict[str, float] = dataclasses.field(
        default_factory=lambda: dict.fromkeys(COLLECTIVE_KEYS, 0.0))
    peak_bytes: int = 0  # with track_memory: peak bytes allocated in the run

    @property
    def dot_flops(self) -> float:
        return float(sum(self.flops_by_label.values()))

    def collective_bytes(self) -> Dict[str, float]:
        """The keys of ``roofline.analysis.collective_bytes`` and ``total``."""
        out = dict(self.collectives)
        out["total"] = sum(self.collectives.values())
        return out


class CostCounter(TorchDispatchMode):
    """Counts one rank's dot FLOPs, HBM traffic and collective bytes (the
    module's docstring); ``counter.record`` holds them."""

    def __init__(self, track_memory: bool = False):
        super().__init__()
        self.record = CostRecord()
        self.track_memory = track_memory
        self._labels: list = []
        self._shadow = 0
        self._live = 0
        self._seen: set = set()
        self._patched: list = []

    # DTensor's sharding propagation runs ops of its own on global-shaped
    # stand-ins (an output's shape, a decomposed op's strategy), once per
    # new signature; those runs are not this rank's work.
    _PROPAGATION = ("propagate_op_sharding_non_cached", "_propagate_tensor_meta_non_cached")

    def __enter__(self):
        from torch.distributed.tensor import DTensor

        prop = DTensor._op_dispatcher.sharding_propagator

        def shadowed(inner):
            def run(*args, **kwargs):
                self._shadow += 1
                try:
                    return inner(*args, **kwargs)
                finally:
                    self._shadow -= 1
            return run

        self._patched = [name for name in self._PROPAGATION if hasattr(prop, name)]
        for name in self._patched:
            setattr(prop, name, shadowed(getattr(prop, name)))
        self._prop = prop
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            for name in self._patched:
                delattr(self._prop, name)
            self._patched = []

    def _label(self) -> str:
        label = self._labels[-1] if self._labels else "step"
        if torch._C._current_autograd_node() is not None:
            return f"backward/{label}"
        return label

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        packet = func.overloadpacket.__name__
        if packet == "_record_function_enter_new":
            self._labels.append(args[0])
        elif packet == "_record_function_exit" and self._labels:
            self._labels.pop()
        out = func(*args, **kwargs)
        if self._shadow:
            return out
        self._count(func, packet, args, kwargs, out)
        if self.track_memory and not any(r.alias_info for r in func._schema.returns):
            self._track(out)  # a fresh output (a view or an in-place result is not)
        return out

    def _count(self, func, packet, args, kwargs, out):
        rec = self.record
        if func.overloadpacket in flop_registry:
            flop = flop_registry[func.overloadpacket]  # takes tensors, reads shapes
            rec.flops_by_label[self._label()] += float(flop(*args, **kwargs, out_val=out))
        if packet in _COLLECTIVES:
            key, at = _COLLECTIVES[packet]
            rec.collectives[key] += float(sum(map(_bytes, _tensors(args[at]))))
            return
        traffic = packet in _DOTS or packet in _GATHERS or packet in _SCATTERS
        if packet == "copy_" and args[0]._is_view():  # a write into a slice
            traffic = True
        if traffic:
            operands = _tensors(args)[:4]
            results = _tensors(out)
            rec.hbm_bytes += float(sum(map(_bytes, operands)) + sum(map(_bytes, results)))

    def _track(self, out):
        for t in _tensors(out):
            st = t.untyped_storage()
            key = id(st)
            if key in self._seen:
                continue
            n = st.nbytes()
            self._seen.add(key)
            self._live += n
            self.record.peak_bytes = max(self.record.peak_bytes, self._live)
            weakref.finalize(st, self._free, key, n)

    def _free(self, key, n):
        self._seen.discard(key)
        self._live -= n


def _record(obj) -> CostRecord:
    return obj.record if isinstance(obj, CostCounter) else obj


def dot_flops_by_op(record):
    """Returns (total dot FLOPs, Counter label -> FLOPs) of a counted run
    (a :class:`CostCounter` or its :class:`CostRecord`)."""
    rec = _record(record)
    return rec.dot_flops, collections.Counter(rec.flops_by_label)


def hbm_traffic_estimate(record) -> float:
    """Fusion-aware lower-bound HBM traffic (per rank): operand + result
    bytes of dots, gathers, scatters and slice updates."""
    return _record(record).hbm_bytes


def print_flops_report(record, top: int = 25):
    total, by_op = dot_flops_by_op(record)
    print(f"total dot FLOPs (per device): {total:.3e}")
    for label, fl in by_op.most_common(top):
        print(f"  {fl:12.3e} ({100 * fl / max(total, 1):5.1f}%)  {label}")
    return total, by_op


def tensor_bytes(tree) -> int:
    """Bytes of the local parts of every tensor in ``tree`` (one rank's)."""
    from torch.distributed.tensor import DTensor

    from ..train.tree import leaves

    total = 0
    for t in leaves(tree):
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            total += math.prod(t.shape) * t.element_size()
    return total
