"""Sharding rules on DTensor: parameter specs (FSDP over "data" x TP over
"model"), activation constraints and cache specs -- the JAX package's
``launch/sharding.py`` with its rules unchanged.

A *spec* is a tuple with one entry per tensor dim, as a ``PartitionSpec``
is: an axis name, a tuple of axis names (the dim split over several mesh
axes, major first) or ``None`` (not split).  :func:`placements` turns a
spec into DTensor placements on a
:class:`~torch.distributed.device_mesh.DeviceMesh`; :func:`shard_tree`
puts a tree of tensors on a mesh (the counterpart of ``jax.device_put``
with shardings).

Parameters are 2D-sharded: the contraction-side dimension over "data"
(ZeRO-3-style -- DTensor all-gathers on use) and the parallel dimension
over "model" (megatron-style TP).  Optimizer state inherits parameter
sharding, so the full optimizer is sharded over all 256/512 ranks.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from ..models.config import ModelConfig
from ..models.transformer import param_spec
from ..train.tree import map_with_path, tree_map

# Parameter names whose trailing dims follow (d_in -> "data", d_out -> "model")
_IN_OUT = ("wq/w", "wk/w", "wv/w", "w_gate", "w_up", "in_proj", "w_in",
           "w_gate_branch")
# (d_in -> "model", d_out -> "data"): output projections
_OUT_IN = ("wo/w", "w_down", "out_proj", "w_out")


def spec_for_param(pathstr: str, ndim: int) -> tuple:
    """The spec of one parameter leaf (trailing dims; stacked layer dims
    are padded with None on the left)."""

    def pad(*trailing):
        return (None,) * (ndim - len(trailing)) + trailing

    # Replicated small params: norms, gates, biases, scalars.
    for frag in ("ln1", "ln2", "final_norm", "q_norm", "kv_norm", "gate_norm",
                 "a_log", "dt_bias", "d_skip", "lam", "b_x", "b_a", "conv_b"):
        if frag in pathstr:
            return (None,) * ndim

    if pathstr.endswith("embed/table"):
        # Vocab-only sharding, as the JAX package's (its 2D-sharded table
        # tripped a full rematerialization on the gather).
        return ("model", None)
    if pathstr.endswith("lm_head/w"):
        return ("data", "model")
    if pathstr.endswith("/wo"):  # MLA out projection (bare array)
        return pad("model", "data")
    if "router" in pathstr:
        return pad("data", None)
    if "conv_w" in pathstr:
        return pad(None, "model")
    if pathstr.endswith("w_x") or pathstr.endswith("w_a"):
        return pad("model", None)
    if "wq_a" in pathstr or "wkv_a" in pathstr:
        # Lora-rank outputs replicated over "model": each TP rank redundantly
        # computes the tiny latent instead of all-gathering (B,S,rank)
        # activations every layer.
        return pad("data", None)
    if "wq_b" in pathstr or "wkv_b" in pathstr:
        return pad("data", "model")

    for frag in _OUT_IN:
        if frag in pathstr:
            if ndim >= 3 and ("moe" in pathstr and "shared" not in pathstr):
                return pad("model", None, "data")   # (E, F, D) experts
            return pad("model", "data")
    for frag in _IN_OUT:
        if frag in pathstr:
            if ndim >= 3 and ("moe" in pathstr and "shared" not in pathstr):
                return pad("model", "data", None)   # (E, D, F) experts
            return pad("data", "model")
    if pathstr.endswith("/b"):  # qkv biases: follow the output dim
        return pad("model")
    # Fallback: replicate.
    return (None,) * ndim


def P(*entries) -> tuple:
    """A spec from its entries, normalized as ``PartitionSpec`` normalizes
    them: a tuple of one axis name is that name, an empty one ``None``."""
    def norm(e):
        if isinstance(e, tuple):
            return None if not e else e[0] if len(e) == 1 else e
        return e

    return tuple(norm(e) for e in entries)


def _widen_data_axis(spec: tuple, mesh) -> tuple:
    """On the multi-pod mesh, FSDP-shard params over ("pod","data") jointly
    (ZeRO across pods: halves state residency, pays cross-pod all-gathers)."""
    if "pod" not in mesh.mesh_dim_names:
        return spec
    return tuple(("pod", "data") if ax == "data" else ax for ax in spec)


def cache_spec(cfg: ModelConfig, pathstr: str, shape, dp) -> tuple:
    """Decode-cache sharding.

    GQA K/V (L,B,H,S,D): batch over data; when kv-heads >= |model| shard
    heads over model, otherwise shard the *sequence* dim over model (long
    caches; keeps per-rank KV bounded).  MLA latent (L,B,S,r): sequence over
    model.  SSM/RG-LRU states: channels/heads over model.
    """
    nd = len(shape)
    b = shape[1] if nd >= 2 else 1
    bspec = dp if b > 1 else None
    last = pathstr.rsplit("/", 1)[-1]
    if last in ("k", "v") and nd == 5:
        n_kv, seq = shape[2], shape[3]
        if n_kv % 16 == 0:
            return P(None, bspec, "model", None, None)
        if seq % 16 == 0:  # few/odd KV heads: shard the sequence dim
            return P(None, bspec, None, "model", None)
        return P(None, bspec, None, None, None)
    if last == "c" and nd == 4:   # MLA latent
        return P(None, bspec, "model", None)
    if last == "kr" and nd == 4:
        return P(None, bspec, "model", None)
    if last == "h" and nd == 5:   # mamba2 state (L,B,H,P,N)
        return P(None, bspec, "model", None, None)
    if last == "h" and nd == 3:   # rg-lru state (L,B,dr)
        return P(None, bspec, "model")
    if last == "conv" and nd == 4:
        return P(None, bspec, None, "model")
    return P(*((None,) * nd))


# ---------------------------------------------------------------------------
# Specs on a DeviceMesh
# ---------------------------------------------------------------------------


def placements(spec: tuple, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``: one per mesh dim,
    ``Shard(d)`` where tensor dim ``d`` names that axis, else
    ``Replicate()``.  A dim over several axes (``("pod", "data")``) is
    ``Shard(d)`` on each, which DTensor splits in mesh order: the axes
    must be named in that order (major first), as a ``PartitionSpec``
    splits them."""
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) if a in names else -1 for a in axes]
        if -1 in idx:
            raise ValueError(f"spec {spec}: axis {axes[idx.index(-1)]!r} is not in the mesh "
                             f"{names}")
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} must follow the mesh order {names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {spec}: mesh axis {names[i]!r} named twice")
            out[i] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``); a leaf of the
    trees below, not a container."""

    mesh: object
    spec: tuple

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def _meta_params(cfg: ModelConfig):
    """The parameter tree of ``cfg`` as meta tensors (allocates nothing)."""

    def leaf(x):
        if isinstance(x, dict):
            return {k: leaf(v) for k, v in x.items()}
        if isinstance(x, list):
            return [leaf(v) for v in x]
        return torch.empty(x[0], dtype=torch.float32, device="meta")

    return leaf(param_spec(cfg))


def param_spec_tree(cfg: ModelConfig):
    """Spec tree of the parameters (mesh-independent; its leaves are the
    spec tuples)."""
    return map_with_path(lambda p, t: spec_for_param(p, t.ndim), _meta_params(cfg))


def param_shardings(cfg: ModelConfig, mesh):
    """:class:`NamedSharding` tree matching ``init_params(cfg, ...).tree()``."""
    return map_with_path(
        lambda p, t: NamedSharding(mesh, _widen_data_axis(spec_for_param(p, t.ndim), mesh)),
        _meta_params(cfg))


def opt_state_shardings(cfg: ModelConfig, mesh, opt_cfg=None):
    """OptState shardings: m/v/ef mirror the params; step is replicated."""
    from ..train.optimizer import OptimizerConfig, OptState

    opt_cfg = opt_cfg or OptimizerConfig()
    p_sh = param_shardings(cfg, mesh)
    rep = NamedSharding(mesh, ())
    ef_sh = p_sh if opt_cfg.grad_compress else tree_map(lambda _: rep, p_sh)
    return OptState(m=p_sh, v=p_sh, step=rep, ef=ef_sh)


def batch_shardings(cfg: ModelConfig, mesh, specs: dict):
    """Shardings for an ``input_specs()`` dict (batch over data axes)."""
    dp = tuple(a for a in mesh.mesh_dim_names if a != "model")

    def shard_leaf(path, leaf):
        nd = leaf.ndim
        if "cache" in path:
            return NamedSharding(mesh, cache_spec(cfg, path, leaf.shape, dp))
        if nd == 0 or leaf.shape[0] == 1:  # scalar, or batch 1: nothing to shard
            return NamedSharding(mesh, P(*((None,) * nd)))
        return NamedSharding(mesh, P(dp, *((None,) * (nd - 1))))

    return map_with_path(shard_leaf, specs)


def shard_tree(tree, shardings):
    """``tree`` (tensors; a ``Transformer`` is taken as its tree) with each
    leaf a DTensor on its sharding: a :class:`NamedSharding` for every
    leaf, or a tree of them shaped like ``tree``.  Each rank takes its own
    part of the whole tensor it was given (every rank passes the same
    values), so nothing is sent.  ``None`` leaves stay ``None``."""
    from ..models.transformer import _params

    tree = _params(tree)

    def put(t, sh):
        if t is None:
            return None
        if isinstance(t, DTensor):
            return t.redistribute(sh.mesh, sh.placements)
        t = torch.as_tensor(t).detach()
        if sh.mesh.device_type != t.device.type and t.device.type != "meta":
            raise ValueError(f"a {t.device.type} tensor on a {sh.mesh.device_type} mesh")
        return distribute_tensor(t, sh.mesh, sh.placements, src_data_rank=None)

    if isinstance(shardings, NamedSharding):
        return tree_map(lambda t: put(t, shardings), tree)
    return tree_map(put, tree, shardings)


# ---------------------------------------------------------------------------
# Activation constraints
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _implicit_replication():
    """DTensor's implicit replication: plain tensors meet DTensors as
    replicated ones (the library's context does not nest; this one
    restores what it found)."""
    dispatcher = DTensor._op_dispatcher
    prev = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = prev


class _Constrain(torch.autograd.Function):
    """``with_sharding_constraint``: the value redistributed to the spec,
    and its gradient too (JAX transposes the constraint into the same
    constraint).  DTensor's own ``redistribute`` hands a gradient back in
    the input's placement, e.g. a pending sum (``Partial``) where the
    forward reduced one, and DTensor then gathers weights in the backward
    rather than reduce that gradient."""

    @staticmethod
    def forward(ctx, x, mesh, place, grad_place=None):
        ctx.mesh, ctx.place = mesh, place if grad_place is None else grad_place
        return x.redistribute(mesh, place)

    @staticmethod
    def backward(ctx, grad):
        return grad.redistribute(ctx.mesh, ctx.place), None, None, None


class Sharder:
    """Activation sharding-constraint helper; no-ops without a mesh.

    ``seq_shard=True`` = Megatron sequence parallelism: the residual stream
    between blocks is sharded (B over data, S over "model"), turning the
    per-layer TP all-reduces into reduce-scatter/all-gather pairs (half the
    bytes) and dividing the per-layer saved activations by |model|.

    Parameters are all-gathered over the data axes at use (:meth:`gather`,
    each layer's within the layer), as XLA all-gathers the JAX package's
    FSDP-sharded weights; left to itself, DTensor would rather gather the
    activations and contract over the weights' data-sharded dim, which
    replicates the batch.

    A constraint is ``x.redistribute(mesh, placements)``.  Tensors the
    model makes for itself (positions, masks, scan states) are plain; under
    :meth:`region` DTensor takes them as replicated where they meet a
    DTensor, as GSPMD takes a constant.  An op that DTensor has no rule for
    at its inputs' placements raises: the model redistributes explicitly
    where it needs to (:meth:`heads`).
    """

    def __init__(self, mesh=None, seq_shard: bool = False):
        if mesh is not None and not isinstance(mesh, DeviceMesh):
            raise TypeError(f"mesh= takes a torch.distributed DeviceMesh, not "
                            f"{type(mesh).__name__}")
        self.mesh = mesh
        self.seq_shard = seq_shard
        if mesh is None:
            self.dp: tuple = ()
            self.model_size = 1
        else:
            self.dp = tuple(a for a in mesh.mesh_dim_names if a != "model")
            self.model_size = dict(zip(mesh.mesh_dim_names, mesh.shape)).get("model", 1)

    def region(self):
        """The context a sharded model runs in (nothing without a mesh)."""
        return contextlib.nullcontext() if self.mesh is None else _implicit_replication()

    def _ws(self, x, spec: tuple):
        if self.mesh is None:
            return x
        if not isinstance(x, DTensor):
            x = DTensor.from_local(x, self.mesh, [Replicate()] * self.mesh.ndim,
                                   run_check=False)
        return _Constrain.apply(x, self.mesh, placements(spec, self.mesh))

    def gather(self, tree):
        """``tree``'s DTensor leaves all-gathered over the data axes, kept
        split over "model": FSDP's (ZeRO-3's) gather on use, before a
        layer's weights meet its activations.  Its backward reduce-scatters
        each gradient back to its parameter's placement (DTensor's own
        would leave it a pending sum over the data axes, which the
        optimizer's elementwise ops then reduce one by one)."""
        if self.mesh is None:
            return tree
        names = self.mesh.mesh_dim_names

        def leaf(t):
            if not isinstance(t, DTensor):
                return t
            want = tuple(Replicate() if names[i] in self.dp else p
                         for i, p in enumerate(t.placements))
            if want == tuple(t.placements):
                return t
            return _Constrain.apply(t, self.mesh, want, tuple(t.placements))

        return tree_map(leaf, tree)

    def heads(self, x, n: int):  # (B, S, n * hd) before its split into n heads
        """``x`` with its last dim whole on every "model" rank where the
        ``n`` heads it splits into do not divide over the "model" ranks:
        DTensor's view rule cannot split a sharded dim unevenly (GSPMD
        pads it).  The other dims keep their placements; the gradient
        returns to ``x``'s (each rank keeps its own slice of it)."""
        if self.mesh is None or n % self.model_size == 0:
            return x
        last = x.ndim - 1
        return x.redistribute(self.mesh, [p if isinstance(p, Shard) and p.dim != last
                                          else Replicate() for p in x.placements])

    def hidden(self, x):  # (B, S, D)
        if self.seq_shard and x.shape[1] % self.model_size == 0 and x.shape[1] > 1:
            return self._ws(x, P(self.dp, "model", None))
        return self._ws(x, P(self.dp, None, None))

    def kv(self, x):  # (B, Hkv, S, D): hoist the SP KV all-gather out of the
        # attention chunk loop (one gather per layer, not per tile pair).
        if self.seq_shard:
            return self._ws(x, P(self.dp, None, None, None))
        return x

    def logits(self, x):  # (B, S, V): vocab TP-sharded
        return self._ws(x, P(self.dp, None, "model"))

    def whole(self, x):  # every dim unsplit on every rank
        return self._ws(x, P(*((None,) * x.ndim)))

    def batch(self, x):  # (B, ...): batch over the data axes
        return self._ws(x, self.batch_spec(x.ndim))

    def batch_spec(self, ndim: int) -> tuple:
        return P(self.dp, *((None,) * (ndim - 1)))
