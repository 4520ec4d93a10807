"""The kernels of the fused propagation round, of its node-batch and packed-
batch forms, of the segment (seed) round, of the column-slab partitioned
round and of the solver's node objective, behind PyTorch wrappers.

Each wrapper of a TPU kernel keeps the signature of its Pallas twin in the
JAX package (``src/repro/kernels/prop_round.py``) minus ``interpret`` and
``block``, plus keyword arguments for what the engines hoist (chunk
lengths, the longest chunk, instance chunk ranges, the copy tiles' windows)
and, for D, E, #8, #10, #12 and #14, the accumulator planes they scatter
into (``acc``, :func:`accumulator_planes`), for F (and #12 with #15 for
one instance) the fixed point's loop carry (``carry``, ``core/carry.py``),
for #9 and #15 a kept pair of flag buffers (``flags``,
:class:`FlagPair`), and for D, A', the combine and E the carry's gate
(``go``); the long-row and straddle combines replace XLA segment sums.  On
a CPU tensor it runs the kernel's plain-PyTorch version (``ref.py``); on a
CUDA tensor it launches the hand-written Hopper kernel of
``csrc/prop_round.cu``, ``csrc/slab_round.cu``, ``csrc/tier_round.cu``,
``csrc/batch_tier_round.cu`` or ``csrc/slab_tier_round.cu`` on the current
stream, or raises -- it never falls back.  Each wrapper counts
its kernel launches in a plain integer attribute, ``<wrapper>.launches``
(see :func:`launch_counts`), and by form (:func:`form_counts`).

The precision tiers (ROADMAP Queue 1 item 5): every wrapper but #16's
(the solver's node objective, float64 only) also takes float32 values (the
fp32 tier), with int32 columns and marks or, where the tier's ``n_pad``
fits int16 (D, A', E, the node forms, and B and C's marks), the compact
int16 columns and int8 marks (:data:`TIER_FORMS`); the slab kernels take
int32 ids at both value types.  F and #15 for one instance take the
progress-based early stop (``stop``), #9 and #15 over a batch the batched
one's per-row measure (``progress``).

Layout of the tile arguments: ``val`` (T, R, K) float64 with 0 at padding,
``col`` (T, R, K) int32 with every id in ``[0, n_pad)``, ``is_int_g``
(T, R, K) int32 integrality of each slot's column, per-chunk sides and row
aggregates (T, R), bound vectors (n_pad,) float64, or for the segment
round's kernels the bounds gathered at each slot, ``lb_g``/``ub_g``
(T, R, K) float64; node batches carry
(B, n_pad) float64 planes and a (B,) bool ``active`` mask, packed batches
also a (T,) int32 ``tile_inst`` map.  The slab
kernels take a partition's copy tiles (slab-local ``col_s``), its (n_runs,)
int32 run maps and (B, W) planes (W the partition's ``n_pad_part`` or the
instance's ``n_pad``).  All contiguous, all on one device.
"""
from __future__ import annotations

import torch

from ..core import bounds as bnd
from ..core import carry as _carry
from ..core.types import INF
from . import _build
from . import ref


def _on_cuda(*tensors: torch.Tensor) -> bool:
    """True for CUDA operands, False for CPU ones; anything else raises."""
    first = tensors[0]
    if first.is_cuda:
        idx = first.get_device()
        if all(t.is_cuda and t.get_device() == idx for t in tensors):
            return True
    elif all(t.device.type == "cpu" for t in tensors):
        return False
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"operands lie on several devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type in ("cpu", "cuda"):
        return dev.type == "cuda"
    raise ValueError(f"unsupported device {dev}")


def _expect(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_tiles(val, col, lb, ub, n_pad, is_int_g=None):
    t, r, k = val.shape
    _expect("val", val, torch.float64, (t, r, k))
    _expect("col", col, torch.int32, (t, r, k))
    if is_int_g is not None:
        _expect("is_int_g", is_int_g, torch.int32, (t, r, k))
    _expect("lb", lb, torch.float64, (n_pad,))
    _expect("ub", ub, torch.float64, (n_pad,))
    return t * r, k


# The forms of the tier kernels (every kernel but #16): float64 values with
# int32 columns and marks, float32 with int32, and float32 with the compact
# int16 columns and int8 marks; their C entry points carry the suffix.  The
# early stop of F, #9 and #15 adds "+stop" to the form it counts (#15's
# per-row measure of a batch "+stop_rows").
TIER_FORMS = ("f64", "f32", "f32c")
_FORM_SUFFIX = {"f64": "", "f32": "_f32", "f32c": "_f32c"}
_FLOATS = (torch.float64, torch.float32)


def _float_dtype(name: str, t: torch.Tensor) -> torch.dtype:
    """The value type of a tier kernel's operand ``t``: float64 or float32."""
    if t.dtype not in _FLOATS:
        raise TypeError(f"{name}: expected float64 or float32, got {t.dtype}")
    return t.dtype


def _check_tier_stream(val, col, is_int_g=None, compact_ok: bool = True):
    """A tile stream in one of :data:`TIER_FORMS` (the compact ids only with
    float32 values, and only where ``compact_ok``); returns ``(T, R, K,
    form)``."""
    t, r, k = val.shape
    dt = _float_dtype("val", val)
    compact = compact_ok and dt == torch.float32 and col.dtype == torch.int16
    _expect("val", val, dt, (t, r, k))
    _expect("col", col, torch.int16 if compact else torch.int32, (t, r, k))
    if is_int_g is not None:
        _expect("is_int_g", is_int_g, torch.int8 if compact else torch.int32, (t, r, k))
    form = "f64" if dt == torch.float64 else "f32c" if compact else "f32"
    return t, r, k, form


def _check_tier_tiles(val, col, lb, ub, n_pad, is_int_g=None):
    """The tiles and bound vectors of D, A' or E in one of :data:`TIER_FORMS`
    (the compact ids only with float32 values); returns ``(chunks, K,
    form)``."""
    t, r, k, form = _check_tier_stream(val, col, is_int_g)
    _expect("lb", lb, val.dtype, (n_pad,))
    _expect("ub", ub, val.dtype, (n_pad,))
    return t * r, k, form


def _value_form(name: str, t: torch.Tensor) -> str:
    """The form of a kernel without index streams (the merges, the
    combines): f64 or f32, by the value type of ``t``."""
    return "f64" if _float_dtype(name, t) is torch.float64 else "f32"


def _tier_entry(name: str, form: str):
    """The C entry point of a tier kernel's form, and its name."""
    symbol = name + _FORM_SUFFIX[form]
    return getattr(_build.lib(), symbol), symbol


# Launches per (wrapper, form) since the last reset_launch_counts.
FORM_LAUNCHES: dict = {}


def _launched(fn, form: str = "f64") -> None:
    """Count one launch of ``fn``'s kernel, in its total and by form."""
    fn.launches += 1
    key = (fn.__name__, form)
    FORM_LAUNCHES[key] = FORM_LAUNCHES.get(key, 0) + 1


_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _stream() -> int:
    """The current CUDA stream's handle, the one a kernel launches on (read
    without building a ``torch.cuda.Stream`` where PyTorch allows)."""
    if _raw_stream is not None:
        return _raw_stream(torch._C._cuda_getDevice())
    return torch.cuda.current_stream().cuda_stream


def _p(t: torch.Tensor) -> int:
    return t.data_ptr()


def accumulator_planes(like: torch.Tensor, inf: float = INF):
    """``(best_l, best_u)``: two planes of the dtype and shape of the bound
    vector or planes ``like``, filled with the sentinels ``-inf`` and
    ``inf``, for kernels D, E, #8, #10, #12 and #14 to scatter into (their
    ``acc``).  The engines allocate one pair per round closure and keep it
    for the whole fixed point: the merge that reads the planes (F, #9, #15)
    sets every entry it reads -- every column, or the active rows -- back
    to the sentinel, so they are clean for the next round."""
    shape, dev, dt = tuple(like.shape), like.device, like.dtype
    return (torch.full(shape, -inf, dtype=dt, device=dev),
            torch.full(shape, inf, dtype=dt, device=dev))


def _fold(acc, best):
    """The plain form of a scatter into kept planes ``acc``: their column
    max / min with this launch's candidates ``best``, in place."""
    torch.maximum(acc[0], best[0], out=acc[0])
    torch.minimum(acc[1], best[1], out=acc[1])
    return acc


def _hand_back(best_l, best_u, active, inf: float) -> None:
    """The plain form of the batched merges' hand-back: the active rows of
    the accumulator planes set back to the sentinels, in place (#9, #15;
    F's is :func:`ref.merge_carry_ref`)."""
    rows = active[:, None]
    best_l.masked_fill_(rows, -inf)
    best_u.masked_fill_(rows, inf)


def _go(go):
    """The gate of a round's kernel (D, A', the combine, E): the pointer to
    the loop carry's ``GO`` as a ``(1,)`` bool view
    (:func:`~repro_torch.core.carry.go_mask`), or null for no gate."""
    if go is None:
        return None
    _expect("go", go, torch.bool, (1,))
    return _p(go)


class FlagPair:
    """Two flag buffers that a merge kept across rounds (#9, #15) writes in
    turn: each launch writes one and zeroes the other, the previous
    launch's, which its caller has read by then in stream order.  So no
    launch is preceded by a fill.  A launch's flags stay valid until the
    next launch with the pair.  Both start at 0."""

    def __init__(self, shape, dtype: torch.dtype, device):
        self.bufs = (torch.zeros(shape, dtype=dtype, device=device),
                     torch.zeros(shape, dtype=dtype, device=device))
        self.turn = 0

    def take(self):
        """``(out, clear)``: the buffer this launch writes and the one it
        zeroes."""
        out, clear = self.bufs[self.turn], self.bufs[1 - self.turn]
        self.turn ^= 1
        return out, clear


def _flag_buffers(flags: FlagPair | None, shape, dtype, device):
    """``(out, clear)`` of a merge's launch: from the kept pair, or a fresh
    zeroed buffer and nothing to clear."""
    if flags is None:
        return torch.zeros(shape, dtype=dtype, device=device), None
    out, clear = flags.take()
    _expect("flags", out, dtype, shape)
    return out, clear


def _plain_flags(flags: FlagPair | None, result):
    """The CPU branch's flags, through the kept pair as the kernel's are."""
    if flags is None:
        return result
    out, clear = flags.take()
    out.copy_(result)
    clear.zero_()
    return out


def _acc_vectors(acc, lb, inf: float):
    """The ``(n_pad,)`` accumulator pair of D or E: the kept pair ``acc``,
    checked, or a fresh pair at the sentinels, shaped like the bounds
    ``lb``, when none is given."""
    if acc is None:
        return accumulator_planes(lb, inf)
    for name, t in zip(("acc[0]", "acc[1]"), acc):
        _expect(name, t, lb.dtype, tuple(lb.shape))
    return acc


# ---------------------------------------------------------------------------
# Kernel D: the whole round for rows that fit one chunk
# ---------------------------------------------------------------------------


def fused_scatter_round_tiles(
    val, col, is_int_g, lhs_g, rhs_g, lb, ub, n_pad: int, int_eps: float,
    inf: float = INF, *, acc=None, chunk_len=None, max_chunk_len: int | None = None, go=None,
):
    """Fully fused round: (T, R, K) tiles + (n_pad,) bounds -> (n_pad,)
    ``best_l`` / ``best_u``, the column max/min of the lower/upper bound
    candidates (sentinel where a column has none).  Requires every row to
    fit its chunk.  ``acc`` is the pair of accumulator planes to scatter
    into (:func:`accumulator_planes`, kept by the round closure; they must
    hold the sentinels, as F leaves them), returned; without it the wrapper
    allocates a fresh pair.  ``chunk_len`` (``(T, R)`` int32, one past each
    chunk's last nonzero) is where each chunk stops and ``max_chunk_len``
    (its largest entry) sets the lanes and strides a chunk gets; the
    engines hoist both at prepare time, and they are computed from ``val``
    when omitted.  ``go`` (the loop carry's ``GO``, :func:`_go`) gates the
    launch: where it is false the kernel returns at once and scatters
    nothing.  The plain version ignores it (F's merges nothing then).

    Replaces ``fused_scatter_round_tiles`` / ``_fused_scatter_kernel``
    (src/repro/kernels/prop_round.py:580 / :556).  Bound on the H100: the
    bytes of the tile stream, read once per round: ``val``, ``col`` and
    ``is_int_g`` at the nonzeros (16 B; each chunk stops at its length) and
    20 B of length and sides per chunk, or ``val`` at every padded slot
    for a kernel that walks every slot; the bound and accumulator vectors
    (4 x 8 B x n_pad).  At float32 (``csrc/tier_round.cu``, the same
    template) values take 4 B, and the compact streams (``col`` int16,
    ``is_int_g`` int8, where ``n_pad <= 2**15``) 2 B and 1 B.  Design: one
    bound gather per nonzero, held in
    registers from the activity sums to the candidates (values, columns
    and marks loaded together); each chunk stopped at its length; a group
    of lanes per chunk sized by the longest chunk, not by K (where no chunk
    holds more than 16 slots, 32 / G chunks share a warp: four at ``pb``'s
    eight slots of K = 128), lanes on consecutive slots, row sums by
    shuffles in the group in ``ref.warp_order_sum`` order; the one-hot
    scatter of the TPU kernel as 64-bit integer max/min reductions that
    padding and sentinel candidates skip; no plane filled per launch when
    the planes are kept."""
    operands = (val, col, is_int_g, lhs_g, rhs_g, lb, ub, *(acc or ()))
    if not _on_cuda(*operands):
        best = ref.fused_scatter_round_tiles_ref(
            val, col, is_int_g, lhs_g, rhs_g, lb, ub, n_pad, int_eps, inf
        )
        return best if acc is None else _fold(acc, best)
    n_chunks, k, form = _check_tier_tiles(val, col, lb, ub, n_pad, is_int_g)
    _expect("lhs_g", lhs_g, val.dtype, val.shape[:2])
    _expect("rhs_g", rhs_g, val.dtype, val.shape[:2])
    clen = _chunk_len(val, chunk_len)
    if max_chunk_len is None:
        max_chunk_len = int(clen.max()) if n_chunks else 0
    best_l, best_u = _acc_vectors(acc, lb, inf)
    entry, symbol = _tier_entry("fused_scatter_round", form)
    err = entry(
        _p(val), _p(col), _p(is_int_g), _p(clen), _p(lhs_g), _p(rhs_g), _p(lb), _p(ub),
        _p(best_l), _p(best_u), _go(go), n_chunks, k, int(max_chunk_len), int_eps, inf,
        _stream(),
    )
    _launched(fused_scatter_round_tiles, form)
    _build.check(err, symbol)
    return best_l, best_u


fused_scatter_round_tiles.launches = 0


# ---------------------------------------------------------------------------
# Kernel A': activity partials of rows that span chunks
# ---------------------------------------------------------------------------


def _chunk_len(val, chunk_len):
    """The per-chunk length kernels D, A' and E stop at: ``chunk_len`` as the
    caller hoisted it (``(T, R)`` int32, :func:`ref.chunk_lengths`), or
    computed here from ``val`` when not given."""
    if chunk_len is None:
        return ref.chunk_lengths(val)
    _expect("chunk_len", chunk_len, torch.int32, val.shape[:2])
    return chunk_len


def _max_len(k: int, max_chunk_len) -> int:
    """The longest chunk a launch of #8, #10, #12, #13 or #14 meets, which
    sets the strides a lane holds (and #13's lanes per chunk): as hoisted by
    the caller, or the width K."""
    return k if max_chunk_len is None else int(max_chunk_len)


def _paired(lb, ub):
    """The bound vectors interleaved, ``(n, 2)``: kernels A' and E gather a
    column's two bounds as one 16-byte pair (8 bytes at float32; a fresh
    allocation, so every pair is aligned to its size).  A copy per launch
    (6 us at n_pad 60,032 on an H100), paid for by halving the gathers."""
    return torch.stack((lb, ub), dim=-1)


def activities_gather_tiles(val, col, lb, ub, n_pad: int, inf: float = INF, chunk_len=None,
                            *, go=None):
    """Per-chunk activity partials with the bound gather inside the kernel:
    (T, R, K) tiles + (n_pad,) bounds -> ``(mf, mc, xf, xc)``, each (T, R):
    finite min/max sums (float64) and infinity counts (int32).
    ``chunk_len`` ((T, R) int32, one past each chunk's last nonzero) is
    where each chunk's walk stops; the engines hoist it at prepare time,
    and it is computed from ``val`` when omitted.  ``go`` gates the launch
    as D's does (the partials are then left unwritten).

    Replaces ``activities_gather_tiles`` / ``_activities_gather_kernel``
    (src/repro/kernels/prop_round.py:269 / :252).  Bound on the H100: the
    bytes of the tile stream (8 B of ``val`` per padded slot, 4 B of ``col``
    per nonzero; at most the slots below each chunk's length are read).  On
    the card the scattered bound gathers bound it, one cache-line request
    per lane and load.  Design: kernel D's lane group per chunk; each group
    stops at its chunk's length; a lane issues the ``val``/``col`` loads of
    four strides (K = 128) before their bound gathers, and gathers a
    column's two bounds as one pair from an interleaved copy (half the
    requests); shuffle sums in the same order; the group's first lane
    writes the chunk's four partials."""
    if not _on_cuda(val, col, lb, ub):
        return ref.activities_gather_tiles_ref(val, col, lb, ub, n_pad, inf)
    n_chunks, k, form = _check_tier_tiles(val, col, lb, ub, n_pad)
    clen = _chunk_len(val, chunk_len)
    shape, dev = val.shape[:2], val.device
    mf = torch.empty(shape, dtype=val.dtype, device=dev)
    xf = torch.empty(shape, dtype=val.dtype, device=dev)
    mc = torch.empty(shape, dtype=torch.int32, device=dev)
    xc = torch.empty(shape, dtype=torch.int32, device=dev)
    lub = _paired(lb, ub)
    entry, symbol = _tier_entry("activities_gather", form)
    err = entry(
        _p(val), _p(col), _p(clen), _p(lub), _p(mf), _p(mc), _p(xf), _p(xc), _go(go), n_chunks,
        k, inf, _stream(),
    )
    _launched(activities_gather_tiles, form)
    _build.check(err, symbol)
    return mf, mc, xf, xc


activities_gather_tiles.launches = 0


# ---------------------------------------------------------------------------
# Kernel E: candidates from completed row aggregates, then the column scatter
# ---------------------------------------------------------------------------


def _check_rows(rows, dtype=torch.float64, **tensors):
    """Row data of shape ``rows``: int32 counts (``*_cnt``), ``dtype`` else."""
    for name, t in tensors.items():
        _expect(name, t, torch.int32 if name.endswith("_cnt") else dtype, rows)


def candidates_scatter_tiles(
    val, col, is_int_g,
    row_min_fin, row_min_cnt, row_max_fin, row_max_cnt,
    lhs_g, rhs_g, lb, ub, n_pad: int, int_eps: float, inf: float = INF, chunk_len=None,
    *, acc=None, go=None,
):
    """Candidates + column reduction: (T, R, K) tiles + (T, R) completed row
    aggregates + (n_pad,) bounds -> (n_pad,) ``best_l`` / ``best_u``
    (``chunk_len`` as in :func:`activities_gather_tiles`), scattered into
    the kept accumulator planes ``acc`` as in :func:`fused_scatter_round_tiles`,
    or into a fresh pair when none is given.  ``go`` gates the launch as
    D's does.

    Replaces ``candidates_scatter_tiles`` / ``_candidates_scatter_kernel``
    (src/repro/kernels/prop_round.py:651 / :628).  Bound on the H100: the
    bytes of the tile stream (as kernel D's) plus 40 B of row data per
    chunk.  Design: A''s loads (stopped at each chunk's length, four
    strides in flight, the bounds as one pair), the candidates of kernel
    D, and the column max/min by 64-bit integer atomics (one reduction, no
    compare-and-swap loop) behind a pre-check read from L2 that skips
    candidates that cannot win; no plane filled per launch when the planes
    are kept."""
    operands = (val, col, is_int_g, row_min_fin, row_min_cnt, row_max_fin,
                row_max_cnt, lhs_g, rhs_g, lb, ub)
    if not _on_cuda(*operands, *(acc or ())):
        best = ref.candidates_scatter_tiles_ref(*operands, n_pad, int_eps, inf)
        return best if acc is None else _fold(acc, best)
    n_chunks, k, form = _check_tier_tiles(val, col, lb, ub, n_pad, is_int_g)
    _check_rows(val.shape[:2], val.dtype, row_min_fin=row_min_fin, row_min_cnt=row_min_cnt,
                row_max_fin=row_max_fin, row_max_cnt=row_max_cnt, lhs_g=lhs_g, rhs_g=rhs_g)
    clen = _chunk_len(val, chunk_len)
    best_l, best_u = _acc_vectors(acc, lb, inf)
    lub = _paired(lb, ub)
    entry, symbol = _tier_entry("candidates_scatter", form)
    err = entry(
        _p(val), _p(col), _p(is_int_g), _p(clen), _p(row_min_fin), _p(row_min_cnt),
        _p(row_max_fin), _p(row_max_cnt), _p(lhs_g), _p(rhs_g), _p(lub), _p(best_l),
        _p(best_u), _go(go), n_chunks, k, int_eps, inf, _stream(),
    )
    _launched(candidates_scatter_tiles, form)
    _build.check(err, symbol)
    return best_l, best_u


candidates_scatter_tiles.launches = 0


# ---------------------------------------------------------------------------
# Kernels A, B, C: the segment (seed) round over pre-gathered bounds
# ---------------------------------------------------------------------------


def _int_operand(x: torch.Tensor) -> torch.Tensor:
    """Integrality marks as the kernels take them: bool widens to int32, as
    the reference's ``_int_operand`` does; other dtypes pass through (and
    the checks below refuse anything but int32, or int8 beside float32
    values, on the card)."""
    return x.to(torch.int32) if x.dtype == torch.bool else x


def _check_gathered(val, lb_g, ub_g, is_int_g=None):
    """(T, R, K) tiles with their bounds gathered at each slot, float64 or
    float32, and the marks int32 (or int8 beside float32 values: the
    compact form); returns (chunks, K, form)."""
    t, r, k = val.shape
    dt = _float_dtype("val", val)
    compact = (dt == torch.float32 and is_int_g is not None and is_int_g.dtype == torch.int8)
    _expect("val", val, dt, (t, r, k))
    _expect("lb_g", lb_g, dt, (t, r, k))
    _expect("ub_g", ub_g, dt, (t, r, k))
    if is_int_g is not None:
        _expect("is_int_g", is_int_g, torch.int8 if compact else torch.int32, (t, r, k))
    form = "f64" if dt == torch.float64 else "f32c" if compact else "f32"
    return t * r, k, form


def activities_tiles(val, lb_g, ub_g, inf: float = INF, *, go=None):
    """Per-chunk activity partials from pre-gathered bounds: (T, R, K)
    ``val``, ``lb_g``, ``ub_g`` -> ``(mf, mc, xf, xc)``, each (T, R): finite
    min/max sums (of ``val``'s dtype, in ``ref.warp_order_sum`` order) and infinity
    counts (int32).  ``go`` (the loop carry's ``GO``, as for D) skips the
    launch's work where it is false; the outputs are then not written.

    Replaces ``activities_tiles`` / ``_activities_kernel``
    (src/repro/kernels/prop_round.py:226 / :217).  Bound on the H100: 8 B of
    ``val`` per padded slot, 16 B of bounds per nonzero (padding's are never
    read) and 24 B of partials per chunk.  Design: kernel A''s lane group
    per chunk and shuffle sums, each slot's bounds read at the slot instead
    of gathered at its column; the group's first lane writes the partials.
    Float64 or float32 (``csrc/tier_round.cu`` ``activities_f32``, the same
    template), at 4 B a value; A reads no marks, so it has no compact
    form."""
    if not _on_cuda(val, lb_g, ub_g):
        return ref.activities_tiles_ref(val, lb_g, ub_g, inf)
    n_chunks, k, form = _check_gathered(val, lb_g, ub_g)
    shape, dev = val.shape[:2], val.device
    mf = torch.empty(shape, dtype=val.dtype, device=dev)
    xf = torch.empty(shape, dtype=val.dtype, device=dev)
    mc = torch.empty(shape, dtype=torch.int32, device=dev)
    xc = torch.empty(shape, dtype=torch.int32, device=dev)
    if n_chunks == 0:
        return mf, mc, xf, xc
    entry, symbol = _tier_entry("activities", form)
    err = entry(
        _p(val), _p(lb_g), _p(ub_g), _p(mf), _p(mc), _p(xf), _p(xc), _go(go), n_chunks, k,
        inf, _stream(),
    )
    _launched(activities_tiles, form)
    _build.check(err, symbol)
    return mf, mc, xf, xc


activities_tiles.launches = 0


def candidates_tiles(
    val, lb_g, ub_g, is_int_g,
    row_min_fin, row_min_cnt, row_max_fin, row_max_cnt,
    lhs_g, rhs_g, int_eps: float, inf: float = INF, *, go=None,
):
    """Candidates from completed row aggregates and pre-gathered bounds,
    written out: (T, R, K) ``val``, ``lb_g``, ``ub_g``, ``is_int_g`` (int32;
    bool widens) + (T, R) aggregates and sides -> (T, R, K) ``lcand`` /
    ``ucand``, the sentinels at padding and at invalid entries.  ``go`` as
    in :func:`activities_tiles`.

    Replaces ``candidates_tiles`` / ``_candidates_kernel``
    (src/repro/kernels/prop_round.py:347 / :314).  Bound on the H100: 8 B of
    ``val`` per padded slot, 20 B of bounds and mark per nonzero, 40 B of row
    data per chunk and the two (T, R, K) outputs (16 B per slot).  Design:
    kernel E's lane group per chunk and its candidate arithmetic, each lane
    storing both candidates of its slots (coalesced) instead of scattering
    them.  Float64 or float32 (``csrc/tier_round.cu``, the same template;
    with a float32 prep's compact int8 marks as they are), at 4 B a value
    and 1 B a compact mark."""
    is_int_g = _int_operand(is_int_g)
    operands = (val, lb_g, ub_g, is_int_g, row_min_fin, row_min_cnt, row_max_fin,
                row_max_cnt, lhs_g, rhs_g)
    if not _on_cuda(*operands):
        return ref.candidates_tiles_ref(*operands, int_eps, inf)
    n_chunks, k, form = _check_gathered(val, lb_g, ub_g, is_int_g)
    _check_rows(val.shape[:2], val.dtype, row_min_fin=row_min_fin, row_min_cnt=row_min_cnt,
                row_max_fin=row_max_fin, row_max_cnt=row_max_cnt, lhs_g=lhs_g, rhs_g=rhs_g)
    lcand = torch.empty_like(val)
    ucand = torch.empty_like(val)
    if n_chunks == 0:
        return lcand, ucand
    entry, symbol = _tier_entry("candidates", form)
    err = entry(
        _p(val), _p(lb_g), _p(ub_g), _p(is_int_g), _p(row_min_fin), _p(row_min_cnt),
        _p(row_max_fin), _p(row_max_cnt), _p(lhs_g), _p(rhs_g), _p(lcand), _p(ucand),
        _go(go), n_chunks, k, int_eps, inf, _stream(),
    )
    _launched(candidates_tiles, form)
    _build.check(err, symbol)
    return lcand, ucand


candidates_tiles.launches = 0


def fused_round_tiles(val, lb_g, ub_g, is_int_g, lhs_g, rhs_g, int_eps: float,
                      inf: float = INF, *, go=None):
    """Activities and candidates in one pass, from pre-gathered bounds,
    candidates written out: (T, R, K) ``val``, ``lb_g``, ``ub_g``,
    ``is_int_g`` + (T, R) sides -> (T, R, K) ``lcand`` / ``ucand``.
    Requires every row to fit its chunk.  ``go`` as in
    :func:`activities_tiles`.

    Replaces ``fused_round_tiles`` / ``_fused_round_kernel``
    (src/repro/kernels/prop_round.py:414 / :400).  Bound on the H100: 8 B of
    ``val`` per padded slot, 20 B of bounds and mark per nonzero, 16 B of
    sides per chunk and the two outputs (16 B per slot).  Design: kernel D's
    lane group per chunk (row sums by shuffles, in ``ref.warp_order_sum``
    order), each slot's bounds read at the slot, both candidates stored per
    slot instead of scattered.  Float64 or float32 (``csrc/tier_round.cu``,
    the same template; the compact int8 marks as B's), at 4 B a value."""
    is_int_g = _int_operand(is_int_g)
    operands = (val, lb_g, ub_g, is_int_g, lhs_g, rhs_g)
    if not _on_cuda(*operands):
        return ref.fused_round_tiles_ref(*operands, int_eps, inf)
    n_chunks, k, form = _check_gathered(val, lb_g, ub_g, is_int_g)
    _expect("lhs_g", lhs_g, val.dtype, val.shape[:2])
    _expect("rhs_g", rhs_g, val.dtype, val.shape[:2])
    lcand = torch.empty_like(val)
    ucand = torch.empty_like(val)
    if n_chunks == 0:
        return lcand, ucand
    entry, symbol = _tier_entry("fused_round", form)
    err = entry(
        _p(val), _p(lb_g), _p(ub_g), _p(is_int_g), _p(lhs_g), _p(rhs_g), _p(lcand), _p(ucand),
        _go(go), n_chunks, k, int_eps, inf, _stream(),
    )
    _launched(fused_round_tiles, form)
    _build.check(err, symbol)
    return lcand, ucand


fused_round_tiles.launches = 0


# ---------------------------------------------------------------------------
# Kernel F: merge -- fold best bounds into (lb, ub) in place
# ---------------------------------------------------------------------------


def apply_updates_tiles(lb, ub, best_l, best_u, eps: float, inf: float = INF, outward: float = 0.0,
                        *, carry=None, k: int = 0, unroll: int = 1, stop=None, partials=None):
    """Bound merge with ``bounds.apply_updates`` semantics, IN PLACE, folded
    into a fixed point's loop carry: ``lb``/``ub`` (n_pad,) are overwritten
    and returned with the carry's ``GO`` as a 0-d bool view
    (:func:`~repro_torch.core.carry.go_flag`).  ``carry`` is the round
    closure's int32 carry (:mod:`repro_torch.core.carry`), ``k`` the round's
    index within its check group of ``unroll`` rounds; where the carry's
    ``GO`` is already false (a round enqueued after convergence) nothing is
    merged or counted.  Without a carry the wrapper arms a fresh one, so
    the returned flag says whether this round tightened a bound.  Every
    entry of ``best_l``/``best_u`` is set back to the sentinels once read
    (the planes of D and E are kept for the whole fixed point): a caller
    that reads them afterwards clones them first.

    Replaces ``apply_updates_tiles`` / ``_apply_updates_kernel``
    (src/repro/kernels/prop_round.py:721 / :710), whose bound buffers are
    donated; the loop state is the reference's ``while_loop`` carry
    (src/repro/core/propagator.py:272).  Bound on the H100: 32 B of reads
    per column (bounds and candidates), 8 B per bound that tightens and 8 B
    per accumulator entry that held a candidate (set back to the sentinel)
    -- under a microsecond at n_pad = 60,032, so its time is launch
    latency.  Design: the merge body of #9 and #15 (``round_common.cuh``
    ``merge_item``) on a grid over one plane, no mask read, four columns a
    thread, loaded before any is merged; a warp that tightens stores the
    carry's flag once, and the launch's last block (an atomic ticket)
    folds the flag into the carry and clears it: no fill before the launch,
    one launch per round.

    Float64 or float32 (the fp32 tier, whose merges widen outward by
    ``outward``).  ``stop`` (a :class:`~repro_torch.core.carry.EarlyStop`,
    one round per check group) arms the progress-based early stop: the
    kernel (``csrc/tier_round.cu`` ``apply_updates_stop``) also sums the
    round's progress measure over the columns it merges, each block into
    ``partials`` (``(ceil(n / ref.MERGE_BLOCK),)`` of the bounds' dtype,
    kept by the round closure; allocated here when omitted), and its last
    block sums them in block order (``ref.merge_order_sum``) and folds the
    measure into the carry, clearing GO once it stayed below
    ``stop.progress`` for ``stop.patience`` rounds.  Without it F runs as
    before, to the bit."""
    own = carry is None
    if own:
        carry, k, unroll = _carry.armed_state(lb.device), 0, 1
    if stop is not None and unroll != 1:
        raise ValueError(f"unroll={unroll}: kernel F's early stop takes one round a check group")
    if stop is not None and partials is not None:
        _expect("partials", partials, lb.dtype, (-(-lb.shape[0] // ref.MERGE_BLOCK),))
    if not _on_cuda(lb, ub, best_l, best_u, carry):
        new_lb, new_ub, go = ref.merge_carry_ref(lb, ub, best_l, best_u, eps, inf, outward,
                                                 carry, k, unroll, stop)
        lb.copy_(new_lb)
        ub.copy_(new_ub)
        return lb, ub, go
    (n,) = lb.shape
    dt = lb.dtype
    for name, t in (("lb", lb), ("ub", ub), ("best_l", best_l), ("best_u", best_u)):
        if t.dtype is not dt or dt not in _FLOATS or t.shape != lb.shape or not t.is_contiguous():
            _expect(name, t, _float_dtype("lb", lb), (n,))
    if carry.dtype is not torch.int32 or carry.shape != (_carry.FIELDS,):
        _expect("carry", carry, torch.int32, (_carry.FIELDS,))
    form = "f64" if dt is torch.float64 else "f32"
    if stop is None:
        entry, symbol = _tier_entry("apply_updates", form)
        err = entry(_p(lb), _p(ub), _p(best_l), _p(best_u), _p(carry), n, k, unroll, eps, inf,
                    outward, _stream())
    else:
        blocks = -(-n // ref.MERGE_BLOCK)
        if partials is None:
            partials = torch.empty(blocks, dtype=dt, device=lb.device)
        symbol = "apply_updates_stop" + ("" if form == "f64" else "_f32")
        err = getattr(_build.lib(), symbol)(
            _p(lb), _p(ub), _p(best_l), _p(best_u), _p(carry), _p(partials), n, eps, inf,
            outward, stop.progress, int(stop.patience), _stream(),
        )
        form += "+stop"
    _launched(apply_updates_tiles, form)
    _build.check(err, symbol)
    return lb, ub, _carry.go_flag(carry)


apply_updates_tiles.launches = 0


# ---------------------------------------------------------------------------
# The long-row combine: chunk partials -> completed row aggregates
# ---------------------------------------------------------------------------


def _classes(row_start, n_chunks: int, classes):
    """The combine's segment classes ``(short, long)``: as the caller
    hoisted them (:func:`ref.segment_classes`, 1-D int32 each), or computed
    here on the device, padded, when not given."""
    if classes is None:
        return ref.segment_classes(row_start, n_chunks=n_chunks)
    for name, t in zip(("short", "long"), classes):
        _expect(f"classes[{name}]", t, torch.int32, (t.shape[0],))
    return classes


def _check_partials(mf, mc, xf, xc, shape, dtype=torch.float64) -> None:
    for name, t, dt in (("mf", mf, dtype), ("mc", mc, torch.int32),
                        ("xf", xf, dtype), ("xc", xc, torch.int32)):
        _expect(name, t, dt, shape)


def combine_chunk_partials_tiles(mf, mc, xf, xc, chunk_row, row_start, classes=None, *,
                                 go=None):
    """Kernel A' partials ``(T, R)`` -> each chunk's completed row aggregates
    ``(T, R)``: every row's partials summed left to right over its adjacent
    chunks (``row_start`` ``(m + 2,)`` int64: each row's first chunk, the
    padding row ``m`` included).  ``classes`` is the segments' split into
    short and long (:func:`ref.segment_classes`), hoisted by the engines;
    computed here when omitted.  It decides which segments a warp sums, not
    the sums.  ``go`` gates the launch as D's does.

    Replaces the XLA ``segment_sum`` of the reference's
    ``_combine_chunk_partials`` (src/repro/kernels/ops.py:821), not a Pallas
    kernel: an atomic segment sum has no fixed order on the card.  Bound on
    the H100: 48 B per chunk (four partials read, four aggregates written).
    A row's sum is one chain of dependent adds, so a row of thousands of
    chunks walked by one thread costs that thread's load latency per chunk.
    Design: one thread per short segment walks its chunks in stream order
    (sum, then write back); one warp per long segment loads 32 chunks'
    partials per step, coalesced, four steps ahead, and every lane adds the
    step's 32 values in chunk order by shuffles (the same order, so the same
    bits); counts by a warp reduction; a coalesced write-back."""
    operands = (mf, mc, xf, xc, chunk_row, row_start)
    if not _on_cuda(*operands):
        return ref.combine_chunk_partials_ref(mf, mc, xf, xc, chunk_row, row_start)
    form = _value_form("mf", mf)
    _check_partials(mf, mc, xf, xc, tuple(mf.shape), mf.dtype)
    _expect("chunk_row", chunk_row, torch.int32, tuple(mf.shape))
    _expect("row_start", row_start, torch.int64, (row_start.shape[0],))
    short, long = _classes(row_start, mf.numel(), classes)
    omf, oxf = torch.empty_like(mf), torch.empty_like(xf)
    omc, oxc = torch.empty_like(mc), torch.empty_like(xc)
    if short.numel() + long.numel() == 0:
        return omf, omc, oxf, oxc
    entry, symbol = _tier_entry("combine_chunk_partials", form)
    err = entry(
        _p(mf), _p(mc), _p(xf), _p(xc), _p(row_start), _p(short), _p(long), _p(omf), _p(omc),
        _p(oxf), _p(oxc), _go(go), short.numel(), long.numel(), _stream(),
    )
    _launched(combine_chunk_partials_tiles, form)
    _build.check(err, symbol)
    return omf, omc, oxf, oxc


combine_chunk_partials_tiles.launches = 0


# ---------------------------------------------------------------------------
# Kernel #10: kernel D over a node batch (one matrix, B bound planes)
# ---------------------------------------------------------------------------


def _check_planes(bsz: int, n_pad: int, dtype=torch.float64, **planes) -> None:
    for name, t in planes.items():
        _expect(name, t, dtype, (bsz, n_pad))


def node_fused_scatter_round_tiles(
    val, col, is_int_g, lhs_g, rhs_g, lb, ub, active, n_pad: int, int_eps: float,
    inf: float = INF, *, acc, chunk_len=None, max_chunk_len: int | None = None,
):
    """Fully fused round over a node batch: ONE instance's ``(T, R, K)``
    tiles + ``(B, n_pad)`` per-node bound planes + ``(B,)`` bool ``active``
    mask -> ``(B, n_pad)`` ``best_l`` / ``best_u``, scattered into the
    accumulator planes ``acc`` (:func:`accumulator_planes`; their active
    rows must hold the sentinels) and returned.  Per node exactly
    :func:`fused_scatter_round_tiles`; inactive nodes' rows are not
    touched.  ``chunk_len`` (``(T, R)`` int32, the prep's, the same tiles
    as D's) is where each chunk stops; computed from ``val`` when omitted.
    ``max_chunk_len`` (its largest entry, hoisted with it; K when omitted)
    sets how many strides of 32 slots a lane holds.  Requires every row to
    fit its chunk.

    Replaces ``node_fused_scatter_round_tiles`` /
    ``_node_fused_scatter_kernel`` (src/repro/kernels/prop_round.py:964 /
    :923).  Bound on the H100: the tile stream once per launch (it fits the
    50 MB L2 at the solver's sizes; ``val`` per slot, or at the nonzeros
    with the chunks stopped at their length), plus each active node's two
    bound rows read and two accumulator rows written.  Design: kernel D's
    lane group per chunk, node-major: each block ballots the mask into
    shared memory and walks (active node, chunk block) items node by node
    over a grid of at most the resident blocks, so the items in flight
    share one or a few nodes' rows in L2; each nonzero's bounds are
    gathered once and held from the sums to the candidates (as many strides
    as the longest chunk needs, the values, columns and marks loaded
    together); the column max/min by fire-and-forget 64-bit integer
    reductions; no plane is allocated or filled per launch.  Float64 or
    float32 (``csrc/batch_tier_round.cu``, the same template; with the
    compact ids of a float32 prep whose ``n_pad`` fits int16), at 4 B a
    value, 2 B a compact column and 1 B a compact mark."""
    operands = (val, col, is_int_g, lhs_g, rhs_g, lb, ub, active, *acc)
    if not _on_cuda(*operands):
        return _fold(acc, ref.node_fused_scatter_round_ref(
            val, col, is_int_g, lhs_g, rhs_g, lb, ub, n_pad, int_eps, inf, active=active
        ))
    t, r, k, form = _check_tier_stream(val, col, is_int_g)
    _expect("lhs_g", lhs_g, val.dtype, (t, r))
    _expect("rhs_g", rhs_g, val.dtype, (t, r))
    bsz = lb.shape[0]
    best_l, best_u = acc
    _check_planes(bsz, n_pad, val.dtype, lb=lb, ub=ub, best_l=best_l, best_u=best_u)
    _expect("active", active, torch.bool, (bsz,))
    clen = _chunk_len(val, chunk_len)
    entry, symbol = _tier_entry("node_fused_scatter_round", form)
    err = entry(
        _p(val), _p(col), _p(is_int_g), _p(clen), _p(lhs_g), _p(rhs_g), _p(lb), _p(ub),
        _p(active), _p(best_l), _p(best_u), t * r, k, _max_len(k, max_chunk_len), bsz, n_pad,
        int_eps, inf, _stream(),
    )
    _launched(node_fused_scatter_round_tiles, form)
    _build.check(err, symbol)
    return best_l, best_u


node_fused_scatter_round_tiles.launches = 0


# ---------------------------------------------------------------------------
# Kernels A', the combine and E over a node batch: the multi-chunk node round
# ---------------------------------------------------------------------------
#
# The reference runs its single-instance jnp round vmapped over the nodes
# here (src/repro/kernels/ops.py:2031): these three have no Pallas twin.
# Their (B, T, R) partial and aggregate planes are written for the active
# nodes only; the rows of inactive nodes are left as allocated.


def _check_node_tiles(val, col, lb, ub, active, n_pad, is_int_g=None):
    """One instance's tiles in one of :data:`TIER_FORMS` and its node
    planes; returns ``(T, R, K, B, form)``."""
    t, r, k, form = _check_tier_stream(val, col, is_int_g)
    bsz = lb.shape[0]
    _check_planes(bsz, n_pad, val.dtype, lb=lb, ub=ub)
    _expect("active", active, torch.bool, (bsz,))
    return t, r, k, bsz, form


def node_activities_gather_tiles(val, col, lb, ub, active, n_pad: int, inf: float = INF,
                                 chunk_len=None):
    """Kernel A' over a node batch: ONE instance's ``(T, R, K)`` tiles +
    ``(B, n_pad)`` per-node bound planes + ``(B,)`` bool ``active`` -> 4 x
    ``(B, T, R)`` partials (``chunk_len`` as in
    :func:`activities_gather_tiles`).  Per active node exactly
    :func:`activities_gather_tiles` on its row; inactive nodes' rows are
    not written (the plain version leaves them at zero).

    No Pallas twin (the reference vmaps its jnp round over the nodes).
    Bound on the H100: the tile stream once per launch (in L2 at the
    solver's sizes), each active node's gathers from its bound rows and 24
    B of partials per (active node, chunk).  Design: kernel #10's scheme
    over A''s loads: each warp loads its chunks' strides once, ballots the
    mask 32 nodes at a time and visits the active nodes only.  Float64 or
    float32 (``csrc/batch_tier_round.cu``), with the compact ids as
    #10's."""
    if not _on_cuda(val, col, lb, ub, active):
        return ref.node_activities_gather_ref(val, col, lb, ub, active, n_pad, inf)
    t, r, k, bsz, form = _check_node_tiles(val, col, lb, ub, active, n_pad)
    clen = _chunk_len(val, chunk_len)
    dev = val.device
    mf = torch.empty((bsz, t, r), dtype=val.dtype, device=dev)
    xf = torch.empty((bsz, t, r), dtype=val.dtype, device=dev)
    mc = torch.empty((bsz, t, r), dtype=torch.int32, device=dev)
    xc = torch.empty((bsz, t, r), dtype=torch.int32, device=dev)
    if t == 0 or bsz == 0:
        return mf, mc, xf, xc
    entry, symbol = _tier_entry("node_activities_gather", form)
    err = entry(
        _p(val), _p(col), _p(clen), _p(lb), _p(ub), _p(active), _p(mf), _p(mc), _p(xf),
        _p(xc), t * r, k, bsz, n_pad, inf, _stream(),
    )
    _launched(node_activities_gather_tiles, form)
    _build.check(err, symbol)
    return mf, mc, xf, xc


node_activities_gather_tiles.launches = 0


def node_combine_chunk_partials_tiles(mf, mc, xf, xc, chunk_row, row_start, active,
                                      classes=None):
    """The long-row combine over a node batch: ``(B, T, R)`` partials ->
    ``(B, T, R)`` completed aggregates, every node's segments those of
    ``row_start`` (one instance, split by ``classes`` as in
    :func:`combine_chunk_partials_tiles`), summed left to right; per active
    node exactly :func:`combine_chunk_partials_tiles` on its planes,
    inactive nodes' planes not written (zeros in the plain version).

    No Pallas twin (the reference's XLA ``segment_sum``, vmapped).  Bound
    on the H100: 48 B per (active node, chunk) (32 B at float32).  Design:
    a (segment block, group of 32 nodes) grid; each warp ballots its
    group's flags and, for each active node, runs the single-instance
    combine's thread (short segments) or warp (long segments) on the
    node's planes.  Float64 or float32 (``csrc/batch_tier_round.cu``)."""
    operands = (mf, mc, xf, xc, chunk_row, row_start, active)
    if not _on_cuda(*operands):
        return ref.node_combine_chunk_partials_ref(*operands)
    bsz = mf.shape[0]
    shape = (bsz, *chunk_row.shape)
    form = _value_form("mf", mf)
    _check_partials(mf, mc, xf, xc, shape, mf.dtype)
    _expect("chunk_row", chunk_row, torch.int32, shape[1:])
    _expect("row_start", row_start, torch.int64, (row_start.shape[0],))
    _expect("active", active, torch.bool, (bsz,))
    short, long = _classes(row_start, chunk_row.numel(), classes)
    omf, oxf = torch.empty_like(mf), torch.empty_like(xf)
    omc, oxc = torch.empty_like(mc), torch.empty_like(xc)
    if bsz == 0 or short.numel() + long.numel() == 0:
        return omf, omc, oxf, oxc
    entry, symbol = _tier_entry("node_combine_chunk_partials", form)
    err = entry(
        _p(mf), _p(mc), _p(xf), _p(xc), _p(row_start), _p(short), _p(long), _p(active),
        _p(omf), _p(omc), _p(oxf), _p(oxc), short.numel(), long.numel(), chunk_row.numel(), bsz,
        _stream(),
    )
    _launched(node_combine_chunk_partials_tiles, form)
    _build.check(err, symbol)
    return omf, omc, oxf, oxc


node_combine_chunk_partials_tiles.launches = 0


def node_candidates_scatter_tiles(
    val, col, is_int_g, row_min_fin, row_min_cnt, row_max_fin, row_max_cnt, lhs_g, rhs_g,
    lb, ub, active, n_pad: int, int_eps: float, inf: float = INF, chunk_len=None,
):
    """Kernel E over a node batch: ONE instance's ``(T, R, K)`` tiles +
    ``(B, T, R)`` completed row aggregates + shared ``(T, R)`` sides +
    ``(B, n_pad)`` planes + ``(B,)`` ``active`` -> ``(B, n_pad)`` ``best_l``
    / ``best_u``.  Per active node exactly :func:`candidates_scatter_tiles`
    on its rows; inactive nodes get sentinel rows.

    No Pallas twin (the reference vmaps its jnp round over the nodes).
    Bound on the H100: the tile stream once per launch (in L2 at the
    solver's sizes), 32 B of aggregates per (active node, chunk), each
    active node's bound rows read and accumulator rows written.  Design:
    kernel #10's ballot over E's loads (strides loaded once per warp) and
    E's integer-atomic scatter into each node's row; the accumulator
    planes are filled with the sentinel before the launch.  Float64 or
    float32 (``csrc/batch_tier_round.cu``), with the compact ids as
    #10's."""
    operands = (val, col, is_int_g, row_min_fin, row_min_cnt, row_max_fin, row_max_cnt,
                lhs_g, rhs_g, lb, ub, active)
    if not _on_cuda(*operands):
        return ref.node_candidates_scatter_ref(*operands, n_pad, int_eps, inf)
    t, r, k, bsz, form = _check_node_tiles(val, col, lb, ub, active, n_pad, is_int_g)
    _check_rows((bsz, t, r), val.dtype, row_min_fin=row_min_fin, row_min_cnt=row_min_cnt,
                row_max_fin=row_max_fin, row_max_cnt=row_max_cnt)
    _check_rows((t, r), val.dtype, lhs_g=lhs_g, rhs_g=rhs_g)
    clen = _chunk_len(val, chunk_len)
    best_l = torch.full((bsz, n_pad), -inf, dtype=val.dtype, device=val.device)
    best_u = torch.full((bsz, n_pad), inf, dtype=val.dtype, device=val.device)
    if t == 0 or bsz == 0:
        return best_l, best_u
    entry, symbol = _tier_entry("node_candidates_scatter", form)
    err = entry(
        _p(val), _p(col), _p(is_int_g), _p(clen), _p(row_min_fin), _p(row_min_cnt),
        _p(row_max_fin), _p(row_max_cnt), _p(lhs_g), _p(rhs_g), _p(lb), _p(ub), _p(active),
        _p(best_l), _p(best_u), t * r, k, bsz, n_pad, int_eps, inf, _stream(),
    )
    _launched(node_candidates_scatter_tiles, form)
    _build.check(err, symbol)
    return best_l, best_u


node_candidates_scatter_tiles.launches = 0


# ---------------------------------------------------------------------------
# Kernel #8: kernel D over a packed batch (many matrices, one flat stream)
# ---------------------------------------------------------------------------


def _instance_chunks(tile_inst, r: int, bsz: int, chunks):
    """Each instance's chunk range of a packed stream, ``(B + 1,)`` int64:
    ``chunks`` as the caller hoisted it, or computed from ``tile_inst``
    (whose tiles of one instance must be contiguous, in instance order)."""
    if chunks is None:
        if tile_inst.numel() > 1 and not bool((tile_inst[1:] >= tile_inst[:-1]).all()):
            raise ValueError("tile_inst: an instance's tiles must be contiguous, in order")
        return ref.instance_chunks(tile_inst, r, bsz)
    _expect("chunks", chunks, torch.int64, (bsz + 1,))
    return chunks


def batched_fused_scatter_round_tiles(
    val, col, is_int_g, lhs_g, rhs_g, lb, ub, tile_inst, active, n_pad: int,
    int_eps: float, inf: float = INF, *, acc, chunk_len=None,
    max_chunk_len: int | None = None, chunks=None,
):
    """Fully fused round over a packed batch: ``(T, R, K)`` flat tile stream
    (instance-local columns) + ``(B, n_pad)`` bound planes + ``(T,)`` int32
    ``tile_inst`` + ``(B,)`` bool ``active`` -> ``(B, n_pad)`` ``best_l`` /
    ``best_u``, scattered into the accumulator planes ``acc``
    (:func:`accumulator_planes`; their active rows must hold the sentinels)
    and returned.  Per instance exactly :func:`fused_scatter_round_tiles`
    (every row of every instance must fit its chunk); inactive instances'
    rows are not touched.  ``active`` is also the service's slot-occupancy
    mask (:func:`batched_occupancy_round_tiles`).  An instance's tiles are
    contiguous and in instance order (packing and the service's slots lay
    them out so); ``chunks`` is each instance's chunk range (``(B + 1,)``
    int64, :func:`ref.instance_chunks`), ``chunk_len`` where each chunk
    stops and ``max_chunk_len`` the longest, all hoisted by the caller
    (computed from ``tile_inst`` and ``val``, and K, when omitted).

    Replaces ``batched_fused_scatter_round_tiles`` /
    ``_batched_fused_scatter_kernel`` (src/repro/kernels/prop_round.py:816
    / :766), whose grid walks the stream in order and flushes its resident
    accumulator block at each instance boundary.  Bound on the H100: for the
    tiles of active instances, ``val`` at the nonzeros (each chunk stopped
    at its length; or per padded slot, the bound beside it), ``col`` and
    ``is_int_g`` per nonzero, the length and sides per chunk (20 B); per
    active instance its two bound rows read and two accumulator rows
    written.  Design: kernel D's lane group per chunk, instance-major: each
    block ballots the mask into shared memory with the active instances'
    chunk blocks summed per ballot word, and walks (active instance, chunk
    block) items over a grid of at most the resident blocks, so no warp is
    launched over a converged instance's tiles; each nonzero's bounds are
    gathered once and held from the sums to the candidates (values, columns
    and marks loaded together, each chunk stopped at its length); the
    column max/min by fire-and-forget 64-bit integer reductions; no plane
    is allocated or filled per launch.  Float64 or float32
    (``csrc/batch_tier_round.cu``, the same template, int32 ids as the
    reference's packed batch keeps them), at 4 B a value."""
    operands = (val, col, is_int_g, lhs_g, rhs_g, lb, ub, tile_inst, active, *acc)
    if not _on_cuda(*operands):
        return _fold(acc, ref.batched_fused_scatter_round_ref(
            val, ref.global_columns(col, tile_inst, n_pad), is_int_g, lhs_g, rhs_g, lb, ub,
            n_pad, int_eps, inf, active=active,
        ))
    t, r, k, form = _check_tier_stream(val, col, is_int_g, compact_ok=False)
    _expect("lhs_g", lhs_g, val.dtype, (t, r))
    _expect("rhs_g", rhs_g, val.dtype, (t, r))
    _expect("tile_inst", tile_inst, torch.int32, (t,))
    bsz = lb.shape[0]
    best_l, best_u = acc
    _check_planes(bsz, n_pad, val.dtype, lb=lb, ub=ub, best_l=best_l, best_u=best_u)
    _expect("active", active, torch.bool, (bsz,))
    start = _instance_chunks(tile_inst, r, bsz, chunks)
    clen = _chunk_len(val, chunk_len)
    entry, symbol = _tier_entry("batched_fused_scatter_round", form)
    err = entry(
        _p(val), _p(col), _p(is_int_g), _p(clen), _p(lhs_g), _p(rhs_g), _p(lb), _p(ub),
        _p(start), _p(active), _p(best_l), _p(best_u), t * r, k, _max_len(k, max_chunk_len),
        bsz, n_pad, int_eps, inf, _stream(),
    )
    _launched(batched_fused_scatter_round_tiles, form)
    _build.check(err, symbol)
    return best_l, best_u


batched_fused_scatter_round_tiles.launches = 0


def batched_occupancy_round_tiles(
    val, col, is_int_g, lhs_g, rhs_g, lb, ub, tile_inst, occupied, n_pad: int,
    eps: float, int_eps: float, inf: float = INF, outward: float = 0.0, *, acc, **hoisted,
):
    """One occupancy-masked round over a slot-resident stream, IN PLACE:
    kernel #8 into the kept planes ``acc``, then the batched merge #9,
    which hands them back -> ``(lb, ub, changed)`` with ``(S,)`` per-slot
    flags.  A free or retired slot is an inactive instance: its tiles
    compute nothing and its rows pass through.  ``hoisted`` goes to #8
    (``chunk_len``, ``max_chunk_len``, ``chunks``).  The counterpart of the
    reference's ``batched_occupancy_round_tiles``
    (src/repro/kernels/prop_round.py:878), which launches no kernel of its
    own."""
    best_l, best_u = batched_fused_scatter_round_tiles(
        val, col, is_int_g, lhs_g, rhs_g, lb, ub, tile_inst, occupied, n_pad, int_eps, inf,
        acc=acc, **hoisted,
    )
    return apply_updates_batch_tiles(lb, ub, best_l, best_u, occupied, eps, inf, outward)


# ---------------------------------------------------------------------------
# Kernel #9: the batched merge, in place, with an active mask
# ---------------------------------------------------------------------------

def apply_updates_batch_tiles(
    lb, ub, best_l, best_u, active, eps: float, inf: float = INF, outward: float = 0.0,
    *, flags: FlagPair | None = None, progress=None, partials=None, ticket=None,
):
    """Batched merge with ``bounds.apply_updates_batch`` semantics, IN
    PLACE: ``(B, n_pad)`` ``lb``/``ub`` are overwritten and returned with a
    ``(B,)`` bool ``changed``.  Inactive rows are neither read nor written
    and report unchanged.  The active rows of ``best_l``/``best_u`` are set
    back to the sentinels once read (the planes of #8 and #10 are kept for
    the whole fixed point).  ``flags`` is the ``(B,)`` bool pair that the
    round closure keeps (:class:`FlagPair`): the flags are written into one
    buffer, which is returned, and the other is zeroed, so no fill precedes
    the launch; without it the wrapper allocates zeroed flags.

    Replaces ``apply_updates_batch_tiles`` / ``_apply_updates_batch_kernel``
    (src/repro/kernels/prop_round.py:1666 / :1652), whose bound buffers are
    donated.  Bound on the H100: 32 B of reads per active (node, column)
    (its bounds and candidates), 8 B per entry that tightens, and the mask
    and flags, and 8 B written back per accumulator entry that held a
    candidate.  Design: the active-only walk of #8, #10 and #14 over
    (active row, block of 1,024 columns) items: each block ballots the mask
    into shared memory and walks the items row by row over a grid of at
    most the resident blocks, so no block is spent on an inactive row; a
    thread loads its four columns' bounds and candidates before it merges
    any; a warp that takes a tightening stores ``true`` to its row's flag
    once, into flags zeroed by the previous launch.  The body is the one #15 runs
    (``round_common.cuh``), templated on where the flag goes; for at most
    16 rows (``kMergeGridRows``) it runs on a (column block, row) grid
    instead, whose few blocks of inactive rows cost less than the walk's
    ballot ahead of the first load.

    Float64 or float32 (the fp32 tier, whose merges widen outward by
    ``outward``; ``csrc/batch_tier_round.cu``), at 4 B a value.
    ``progress`` (a ``(B,)`` tensor of the bounds' dtype) arms the batched
    early stop's measure: the kernel (``apply_updates_batch_stop``) also
    writes each active row's progress measure of this merge into it, in
    place, summed in the order of ``ref.merge_order_sum`` per row: each
    (row, block of 1,024 columns) item's sum into ``partials`` (``(B,
    ceil(n_pad / ref.MERGE_BLOCK))``, kept by the round closure; allocated
    here when omitted), then the launch's last block sums each active
    row's in block order.  ``ticket`` (a ``(1,)`` int32 holding 0, kept
    with them; the last block sets it back to 0) counts the blocks.
    Inactive rows' entries are not written.  The streak and the mask are
    the caller's (``core.propagator.batched_step_rounds``).  Without it #9
    runs as before, to the bit."""
    if not _on_cuda(lb, ub, best_l, best_u, active):
        new_lb, new_ub, changed = bnd.apply_updates_batch(
            lb, ub, best_l, best_u, eps, inf, outward, active=active
        )
        if progress is not None:
            _plain_row_progress(lb, ub, new_lb, new_ub, active, progress, partials)
        _hand_back(best_l, best_u, active, inf)
        lb.copy_(new_lb)
        ub.copy_(new_ub)
        return lb, ub, _plain_flags(flags, changed)
    bsz, n_pad = lb.shape
    form = _value_form("lb", lb)
    _check_planes(bsz, n_pad, lb.dtype, lb=lb, ub=ub, best_l=best_l, best_u=best_u)
    _expect("active", active, torch.bool, (bsz,))
    changed, clear = _flag_buffers(flags, (bsz,), torch.bool, lb.device)
    head = (_p(lb), _p(ub), _p(best_l), _p(best_u), _p(active), _p(changed),
            None if clear is None else _p(clear))
    if progress is None:
        entry, symbol = _tier_entry("apply_updates_batch", form)
        err = entry(*head, bsz, n_pad, eps, inf, outward, _stream())
    else:
        blocks = -(-n_pad // ref.MERGE_BLOCK)
        if partials is None:
            partials = torch.empty((bsz, blocks), dtype=lb.dtype, device=lb.device)
        if ticket is None:
            ticket = torch.zeros(1, dtype=torch.int32, device=lb.device)
        _expect("progress", progress, lb.dtype, (bsz,))
        _expect("partials", partials, lb.dtype, (bsz, blocks))
        _expect("ticket", ticket, torch.int32, (1,))
        symbol = "apply_updates_batch_stop" + ("" if form == "f64" else "_f32")
        err = getattr(_build.lib(), symbol)(
            *head, _p(partials), _p(progress), _p(ticket), bsz, n_pad, eps, inf, outward,
            _stream(),
        )
        form += "+stop"
    _launched(apply_updates_batch_tiles, form)
    _build.check(err, symbol)
    return lb, ub, changed


apply_updates_batch_tiles.launches = 0


# ---------------------------------------------------------------------------
# Kernel #16: the solver's node objective and leaf / prune predicates
# ---------------------------------------------------------------------------


def node_objective_tiles(lb, ub, c, is_int, valid, feas_eps: float, inf: float = INF):
    """Per-node objective bound + leaf/prune predicates: ``(B, n_pad)``
    planes + ``(n_pad,)`` objective ``c`` (float64) and ``is_int`` /
    ``valid`` (bool) -> ``(obj, fixed, crossed)``, each ``(B,)``; semantics
    of ``ref.node_objective_ref``, whose sum takes the kernel's order.

    Replaces ``node_objective_tiles`` / ``_node_objective_kernel``
    (src/repro/kernels/prop_round.py:1730 / :1711).  Bound on the H100:
    16 B per (node, column) plus the three shared vectors (10 B per
    column).  Design: one 1024-thread block per node, strided column loop,
    warp-shuffle and shared-memory sum, ``__syncthreads_or`` for the
    flags."""
    if not _on_cuda(lb, ub, c, is_int, valid):
        return ref.node_objective_ref(lb, ub, c, is_int, valid, feas_eps, inf)
    bsz, n_pad = lb.shape
    _check_planes(bsz, n_pad, lb=lb, ub=ub)
    _expect("c", c, torch.float64, (n_pad,))
    _expect("is_int", is_int, torch.bool, (n_pad,))
    _expect("valid", valid, torch.bool, (n_pad,))
    obj = torch.empty((bsz,), dtype=torch.float64, device=lb.device)
    fixed = torch.empty((bsz,), dtype=torch.bool, device=lb.device)
    crossed = torch.empty((bsz,), dtype=torch.bool, device=lb.device)
    err = _build.lib().node_objective(
        _p(lb), _p(ub), _p(c), _p(is_int), _p(valid), _p(obj), _p(fixed), _p(crossed),
        bsz, n_pad, feas_eps, inf, _stream(),
    )
    node_objective_tiles.launches += 1
    _build.check(err, "node_objective")
    return obj, fixed, crossed


node_objective_tiles.launches = 0


# ---------------------------------------------------------------------------
# The column-slab partitioned round: kernels #11-#15 (csrc/slab_round.cu)
# ---------------------------------------------------------------------------

MAX_GRID_Y = 65535


def _check_runs(n_tiles: int, **runs) -> int:
    """Run maps are (n_runs,) int32 and cover the copy tiles; returns
    n_runs."""
    n_runs = None
    for name, t in runs.items():
        n_runs = t.shape[0] if n_runs is None else n_runs
        _expect(name, t, torch.int32, (n_runs,))
    if n_runs == 0 and n_tiles:
        raise ValueError("copy tiles without runs")
    return n_runs


def _check_copies(val, col_s, lb, ub, active):
    """Copy tiles (float64 or float32 values, int32 slab-local columns) and
    their ``(B, W)`` planes; returns ``(T, R, K, B, W)``."""
    t, r, k = val.shape
    dt = _float_dtype("val", val)
    _expect("val", val, dt, (t, r, k))
    _expect("col_s", col_s, torch.int32, (t, r, k))
    bsz, width = lb.shape
    _check_planes(bsz, width, dt, lb=lb, ub=ub)
    _expect("active", active, torch.bool, (bsz,))
    if bsz > MAX_GRID_Y:
        raise ValueError(f"{bsz} planes exceed the grid's {MAX_GRID_Y}")
    return t, r, k, bsz, width


def _n_slabs(width: int, slab: int) -> int:
    return -(-width // slab)


def _outputs(out, specs, dev):
    """A wrapper's output tensors: ``out`` (kept by the caller across
    rounds, each checked against its ``(shape, dtype)`` of ``specs``), or
    fresh ones."""
    if out is None:
        return tuple(torch.empty(shape, dtype=dt, device=dev) for shape, dt in specs)
    for i, (t, (shape, dt)) in enumerate(zip(out, specs)):
        _expect(f"out[{i}]", t, dt, shape)
    return tuple(out)


def batched_slab_partials_tiles(
    val, col_s, run_start, run_len, run_inst, run_slab, active, lb, ub, slab: int,
    max_run_len: int, inf: float = INF, *, out=None, go=None,
):
    """Per-copy activity partials of a slab-partitioned sub-stream:
    ``(Ta, R, K)`` copies with slab-local columns + the run maps (one run
    per populated ``(instance, slab)`` window, ``(n_runs,)`` int32) + ``(B,
    W)`` bound planes + ``(B,)`` bool ``active`` -> 4 x ``(Ta, R)`` partials
    (float64 sums, int32 counts); the copies of inactive instances get
    zeros.  ``W`` is ``n_pad_part`` or the instance's ``n_pad``; a copy's
    window starts at ``inst * W + slab_id * slab``.  ``max_run_len`` sizes
    the TPU's grid and is not used here.  ``out`` (the four partials, kept
    by the round closure) is written instead of fresh tensors.  ``go`` (a
    single instance's loop carry's ``GO``, as for D) skips the launch's
    work where it is false; the partials are then not written.  Float64 or
    float32 (``csrc/slab_tier_round.cu``, the same template, int32 ids), at
    4 B a value.

    Replaces ``batched_slab_partials_tiles`` /
    ``_batched_slab_partials_kernel`` (src/repro/kernels/prop_round.py:1129
    / :1090).  Bound on the H100: the sub-stream's bytes (8 B of ``val`` per
    slot, 4 B of ``col_s`` per nonzero) plus 24 B of partials per chunk.
    Design: kernel A''s lane group per chunk; a copy finds its run by a
    binary search over ``run_start`` and gathers from its window by an
    indexed load; no grid step is padded."""
    operands = (val, col_s, run_start, run_len, run_inst, run_slab, active, lb, ub)
    if not _on_cuda(*operands):
        return ref.batched_slab_partials_ref(*operands, slab, max_run_len, inf)
    t, r, k, _, width = _check_copies(val, col_s, lb, ub, active)
    n_runs = _check_runs(t, run_start=run_start, run_len=run_len, run_inst=run_inst,
                         run_slab=run_slab)
    mf, mc, xf, xc = _outputs(out, partial_specs((t, r), val.dtype), val.device)
    if t == 0:
        return mf, mc, xf, xc
    form = _value_form("val", val)
    entry, symbol = _tier_entry("slab_partials", form)
    err = entry(
        _p(val), _p(col_s), _p(run_start), _p(run_inst), _p(run_slab), _p(active), _p(lb),
        _p(ub), _p(mf), _p(mc), _p(xf), _p(xc), _go(go), n_runs, t * r, r, k, width, slab, inf,
        _stream(),
    )
    _launched(batched_slab_partials_tiles, form)
    _build.check(err, symbol)
    return mf, mc, xf, xc


batched_slab_partials_tiles.launches = 0


def _slab_merge(lb, ub, best_l, best_u, active, slab: int, eps: float, inf: float,
                outward: float, flags: FlagPair | None = None, carry=None, k: int = 0,
                unroll: int = 1, stop=None, partials=None, progress=None, ticket=None):
    """Launch kernel #15 on ``(B, W)`` planes, in place; returns the ``(B,
    n_slabs)`` int32 window flags (from the pair ``flags`` where given), or
    with a loop ``carry`` (one instance, ``active`` its ``GO``) folds the
    flag into it, as F does, and returns the carry's ``GO``.  With the
    carry's early stop ``stop`` (one round a check group) the fold also
    takes the round's progress measure, each block's sum into ``partials``
    (``(ceil(W / ref.MERGE_BLOCK),)``), as F's
    (``csrc/slab_tier_round.cu`` ``slab_merge_stop``).  Without a carry,
    ``progress`` (a ``(B,)`` tensor) takes each active row's measure, as
    #9's, through ``partials`` (``(B, ceil(W / ref.MERGE_BLOCK))``) and
    ``ticket`` (``slab_merge_rows_stop``); both are allocated when omitted.
    Counted as a launch of :func:`apply_updates_slab_tiles`, whichever
    wrapper calls it.  The slab must be a multiple of 32: a warp flags the
    one window its 32 columns lie in (partition slabs are multiples of
    LANE, 128)."""
    if slab <= 0 or slab % ref.WARP:
        raise ValueError(f"slab={slab}: the window merge takes multiples of {ref.WARP}")
    bsz, width = lb.shape
    form = _value_form("lb", lb)
    suffix = _FORM_SUFFIX[form]
    lib = _build.lib()
    ptr = lambda t: None if t is None else _p(t)
    head = (_p(lb), _p(ub), _p(best_l), _p(best_u), _p(active))
    blocks = -(-width // ref.MERGE_BLOCK)
    out = None
    if carry is not None:
        if bsz != 1:
            raise ValueError(f"a loop carry folds one instance's flags, got {bsz} planes")
        _expect("carry", carry, torch.int32, (_carry.FIELDS,))
        if stop is None:
            symbol = "slab_merge" + suffix
            err = getattr(lib, symbol)(*head, None, None, _p(carry), bsz, width, slab, k, unroll,
                                       eps, inf, outward, _stream())
        else:
            if unroll != 1:
                raise ValueError(f"unroll={unroll}: #15's early stop takes one round a check "
                                 "group")
            if partials is None:
                partials = torch.empty(blocks, dtype=lb.dtype, device=lb.device)
            _expect("partials", partials, lb.dtype, (blocks,))
            symbol = "slab_merge_stop" + suffix
            err = getattr(lib, symbol)(*head, _p(carry), _p(partials), width, eps, inf, outward,
                                       stop.progress, int(stop.patience), _stream())
            form += "+stop"
    else:
        out, clear = _flag_buffers(flags, (bsz, _n_slabs(width, slab)), torch.int32, lb.device)
        if progress is None:
            symbol = "slab_merge" + suffix
            err = getattr(lib, symbol)(*head, _p(out), ptr(clear), None, bsz, width, slab, k,
                                       unroll, eps, inf, outward, _stream())
        else:
            if partials is None:
                partials = torch.empty((bsz, blocks), dtype=lb.dtype, device=lb.device)
            if ticket is None:
                ticket = torch.zeros(1, dtype=torch.int32, device=lb.device)
            _expect("progress", progress, lb.dtype, (bsz,))
            _expect("partials", partials, lb.dtype, (bsz, blocks))
            _expect("ticket", ticket, torch.int32, (1,))
            symbol = "slab_merge_rows_stop" + suffix
            err = getattr(lib, symbol)(*head, _p(out), ptr(clear), _p(partials), _p(progress),
                                       _p(ticket), bsz, width, slab, eps, inf, outward, _stream())
            form += "+stop_rows"
    _launched(apply_updates_slab_tiles, form)
    _build.check(err, symbol)
    return _carry.go_flag(carry) if carry is not None else out


def _plain_slab_merge(lb, ub, best_l, best_u, active, slab: int, eps: float, inf: float,
                      outward: float, flags: FlagPair | None = None, carry=None, k: int = 0,
                      unroll: int = 1, stop=None, partials=None, progress=None):
    """#15's plain version, in place, as :func:`_slab_merge` launches it
    (the CPU branch of the slab rounds and of #15's wrapper): the window
    merge (:func:`ref.apply_updates_slab_ref`), the active rows' hand-back,
    and the window flags through the kept pair ``flags``; or, with a loop
    ``carry``, its fold (with the carry's ``stop``, of the round's measure
    in #15's order, :func:`ref.merge_progress`), returning the carry's
    ``GO``; ``progress`` as :func:`_plain_row_progress`."""
    blocks = -(-lb.shape[1] // ref.MERGE_BLOCK)
    if partials is not None and carry is not None and stop is not None:
        _expect("partials", partials, lb.dtype, (blocks,))
    elif partials is not None and carry is None and progress is not None:
        _expect("partials", partials, lb.dtype, (lb.shape[0], blocks))
    new_lb, new_ub, win = ref.apply_updates_slab_ref(lb, ub, best_l, best_u, active, slab, eps,
                                                     inf, outward)
    _hand_back(best_l, best_u, active, inf)
    prog = None
    if carry is not None and stop is not None:
        prog = ref.merge_progress(lb, ub, new_lb, new_ub)
    elif carry is None and progress is not None:
        _plain_row_progress(lb, ub, new_lb, new_ub, active, progress, partials)
    lb.copy_(new_lb)
    ub.copy_(new_ub)
    if carry is not None:
        _carry.fold(carry, win.any(), k, unroll, stop, prog)
        return _carry.go_flag(carry)
    return _plain_flags(flags, win)


def _plain_row_progress(lb, ub, new_lb, new_ub, active, progress, partials=None) -> None:
    """The plain form of the batched merges' early-stop measure (#9, #15):
    each active row's block partials and measure
    (:func:`ref.merge_rows_progress`) written into ``partials`` (where
    given) and ``progress``, in place; inactive rows' entries kept."""
    blocks, prog = ref.merge_rows_progress(lb, ub, new_lb, new_ub)
    progress.copy_(torch.where(active, prog, progress))
    if partials is not None:
        partials.copy_(torch.where(active[:, None], blocks, partials))


def _check_round(val, col_s, is_int_g, row_done, lhs_g, rhs_g, strs, str_lead, lb, ub, active):
    t, r, k, bsz, width = _check_copies(val, col_s, lb, ub, active)
    dt = val.dtype
    _expect("is_int_g", is_int_g, torch.int32, (t, r, k))
    _expect("row_done", row_done, torch.int32, (t, r))
    _expect("lhs_g", lhs_g, dt, (t, r))
    _expect("rhs_g", rhs_g, dt, (t, r))
    for name, x, d in zip(("str_min_fin", "str_min_cnt", "str_max_fin", "str_max_cnt"), strs,
                          (dt, torch.int32, dt, torch.int32)):
        _expect(name, x, d, (*str_lead, t, r))
    return t, r, k, bsz, width


def batched_slab_round_tiles(
    val, col_s, is_int_g, row_done, str_min_fin, str_min_cnt, str_max_fin, str_max_cnt,
    lhs_g, rhs_g, run_start, run_len, run_inst, run_slab, active, lb, ub, slab: int,
    max_run_len: int, eps: float, int_eps: float, inf: float = INF, outward: float = 0.0,
    *, acc, tiles, chunk_len=None, max_chunk_len: int | None = None,
    flags: FlagPair | None = None, carry=None, k: int = 0, unroll: int = 1, go=None,
    stop=None, partials=None, progress=None, ticket=None,
):
    """The slab round over a partitioned stream, IN PLACE: ``(T'', R, K)``
    copies + ``(T'', R)`` ``row_done`` and straddle aggregates ``str_*``
    (read where ``row_done == 0``) + sides + the run maps (one run per
    ``(instance, slab)`` window, in window order) + ``(B, W)`` planes +
    ``(B,)`` ``active`` -> the planes, updated, and ``(n_runs,)`` int32
    per-run changed flags (``n_runs == B * n_slabs``).  Inactive instances
    pass through.  ``acc`` is the pair of ``(B, W)`` accumulator planes
    (:func:`accumulator_planes`; sentinels in every active row), scattered
    into and set back to the sentinels by the merge; ``tiles`` the copy
    tiles' ``(tile_inst, tile_slab)``, ``chunk_len`` the copy stream's
    chunk lengths and ``max_chunk_len`` the longest, all hoisted by the
    partition (the last two computed from ``val``, and K, when omitted).
    ``flags`` is the window flags' pair kept by the round closure
    (:class:`FlagPair`, ``(B, n_slabs)`` int32).  With a loop ``carry``
    (``B == 1``: a single instance's fixed point, ``active`` its ``GO``,
    ``k``/``unroll`` as for F) the window flags are folded into the carry
    instead, as F folds its flag, and the third output is the carry's
    ``GO``; ``go`` (that ``GO``) then skips the scatter's work where it is
    false.  With the carry, ``stop`` (its early stop, one round a check
    group) folds the round's progress measure into it as F does
    (``partials`` its kept block sums); without one, ``progress`` (a ``(B,)``
    tensor) takes each active instance's measure of the round, as #9's
    (``partials``, ``ticket`` kept with it): :func:`_slab_merge`.  Float64
    or float32 (``csrc/slab_tier_round.cu``, the same templates, int32
    ids), at 4 B a value.

    Replaces ``batched_slab_round_tiles`` / ``_batched_slab_round_kernel``
    (src/repro/kernels/prop_round.py:1258 / :1195), whose merge at each
    run's last grid step relies on the TPU running a run's tiles in order.
    Bound on the H100: the copy stream (``val`` per slot, or at the
    nonzeros with the chunks stopped at their length; 8 B of ``col_s`` and
    ``is_int_g`` per kept nonzero; 44 B of row data per chunk), the window
    bounds read and written, and the accumulator planes written and read
    once.  Design: two launches -- the scatter, then kernel #15's window
    merge once every copy has scattered, in place (counted as #15's
    launch).  The scatter runs kernel D's lane groups; each lane reads its
    window from ``tile_inst``/``tile_slab`` (no search over the runs),
    stops at its chunk's length, loads values, columns and marks together,
    gathers each nonzero's bounds once and holds them from the sums to the
    candidates (as many strides as the longest copy needs: one on the
    copy streams seen so far), and reduces by fire-and-forget 64-bit
    integer reductions into the kept planes."""
    strs = (str_min_fin, str_min_cnt, str_max_fin, str_max_cnt)
    operands = (val, col_s, is_int_g, row_done, *strs, lhs_g, rhs_g, run_start, run_len,
                run_inst, run_slab, active, lb, ub, *acc)
    if stop is not None and unroll != 1:
        raise ValueError(f"unroll={unroll}: #15's early stop takes one round a check group")
    if not _on_cuda(*operands):
        best_l, best_u = _fold(acc, ref.batched_slab_scatter_ref(
            val, col_s, is_int_g, row_done, *strs, lhs_g, rhs_g, run_start, run_inst, run_slab,
            active, lb, ub, slab, int_eps, inf,
        ))
        out = _plain_slab_merge(lb, ub, best_l, best_u, active, slab, eps, inf, outward, flags,
                                carry, k, unroll, stop, partials, progress)
        return lb, ub, out if carry is not None else out.reshape(-1)
    form = _value_form("val", val)
    t, r, kw, bsz, width = _check_round(val, col_s, is_int_g, row_done, lhs_g, rhs_g, strs, (),
                                        lb, ub, active)
    n_runs = _check_runs(t, run_start=run_start, run_len=run_len, run_inst=run_inst,
                         run_slab=run_slab)
    if n_runs != bsz * _n_slabs(width, slab):
        raise ValueError(f"{n_runs} runs, expected one per window ({bsz} x "
                         f"{_n_slabs(width, slab)})")
    best_l, best_u = acc
    _check_planes(bsz, width, val.dtype, best_l=best_l, best_u=best_u)
    for name, x in zip(("tile_inst", "tile_slab"), tiles):
        _expect(name, x, torch.int32, (t,))
    clen = _chunk_len(val, chunk_len)
    entry, symbol = _tier_entry("slab_scatter", form)
    err = entry(
        _p(val), _p(col_s), _p(is_int_g), _p(clen), _p(row_done), *map(_p, strs), _p(lhs_g),
        _p(rhs_g), *map(_p, tiles), _p(active), _p(lb), _p(ub), _p(best_l), _p(best_u), _go(go),
        t * r, r, kw, _max_len(kw, max_chunk_len), width, slab, int_eps, inf, _stream(),
    )
    _launched(batched_slab_round_tiles, form)
    _build.check(err, symbol)
    out = _slab_merge(lb, ub, best_l, best_u, active, slab, eps, inf, outward, flags, carry, k,
                      unroll, stop, partials, progress, ticket)
    return lb, ub, out if carry is not None else out.reshape(-1)


batched_slab_round_tiles.launches = 0


def node_slab_partials_tiles(
    val, col_s, run_start, run_len, run_slab, active, lb, ub, slab: int, max_run_len: int,
    inf: float = INF, *, tile_slab=None, chunk_len=None, max_chunk_len: int | None = None,
):
    """Per-copy, per-node activity partials of ONE instance's straddle
    sub-stream: ``(Ta, R, K)`` copies + run maps + ``(B, W)`` per-node
    planes + ``(B,)`` ``active`` -> 4 x ``(B, Ta, R)``; inactive nodes'
    planes are not written (zeros in the plain version).  Per node exactly
    :func:`batched_slab_partials_tiles`.  ``tile_slab`` is the copy tiles'
    slabs (``a_tile_slab``), ``chunk_len`` the copies' lengths and
    ``max_chunk_len`` the longest (``a_chunk_len``, ``a_max_chunk_len``),
    all hoisted by the partition; computed from the run maps, from ``val``
    and as K when omitted.  Float64 or float32 (``csrc/slab_tier_round.cu``,
    the same template, int32 ids), at 4 B a value.

    Replaces ``node_slab_partials_tiles`` / ``_node_slab_partials_kernel``
    (src/repro/kernels/prop_round.py:1383 / :1351).  Bound on the H100: the
    sub-stream once per launch (``val`` at the nonzeros, each copy stopped
    at its length; ``col_s`` per nonzero; it fits the 50 MB L2 at the
    solver's sizes) plus each active node's window gathers and 24 B of
    partials per (node, chunk).  Design: the active-only walk of #14 over
    (active node, chunk block) items, node-major, so with no node active
    every block returns after its ballot; each copy's window from
    ``tile_slab`` (no search over the runs); each copy stopped at its
    length and summed by ``chunk_round``'s routine (values and columns
    loaded together, every bound gather of a lane issued before any is
    added), in ``ref.warp_order_sum``'s order; the lane group keyed on the
    longest copy, as D's is.  The outputs are allocated, not filled: the
    straddle combine reads the active planes only."""
    operands = (val, col_s, run_start, run_len, run_slab, active, lb, ub)
    if not _on_cuda(*operands):
        return ref.node_slab_partials_ref(*operands, slab, max_run_len, inf)
    t, r, k, bsz, width = _check_copies(val, col_s, lb, ub, active)
    _check_runs(t, run_start=run_start, run_len=run_len, run_slab=run_slab)
    if tile_slab is None:
        tile_slab = torch.repeat_interleave(run_slab, run_len).to(torch.int32)
    _expect("tile_slab", tile_slab, torch.int32, (t,))
    clen = _chunk_len(val, chunk_len)
    mf, mc, xf, xc = _outputs(None, partial_specs((bsz, t, r), val.dtype), val.device)
    if t == 0:
        return mf, mc, xf, xc
    form = _value_form("val", val)
    entry, symbol = _tier_entry("node_slab_partials", form)
    err = entry(
        _p(val), _p(col_s), _p(clen), _p(tile_slab), _p(active), _p(lb), _p(ub), _p(mf),
        _p(mc), _p(xf), _p(xc), t * r, r, k, _max_len(k, max_chunk_len), bsz, width, slab, inf,
        _stream(),
    )
    _launched(node_slab_partials_tiles, form)
    _build.check(err, symbol)
    return mf, mc, xf, xc


node_slab_partials_tiles.launches = 0


def partial_specs(shape, dtype: torch.dtype = torch.float64) -> tuple:
    """``(shape, dtype)`` of the four partials or aggregates: min sums,
    min counts, max sums, max counts (the sums of value type ``dtype``)."""
    return ((shape, dtype), (shape, torch.int32), (shape, dtype), (shape, torch.int32))


def straddle_specs(part_shape, agg_shape, n_slots: int,
                   dtype: torch.dtype = torch.float64) -> tuple:
    """``(shape, dtype)`` of the straddle combine's outputs (the aggregates
    spread to ``agg_shape``, leading node axis included) and of its
    compact tables, for partials of ``part_shape`` with sums of
    ``dtype``."""
    nb = part_shape[0] if len(part_shape) == 3 else 1
    return partial_specs(tuple(agg_shape), dtype) + partial_specs((nb, n_slots), dtype)


def straddle_combine_tiles(mf, mc, xf, xc, a_order, a_seg, agg_slot, active=None, *,
                           out=None):
    """The straddle combine of the partitioned round: per-copy partials of
    #11 (``(Ta, R)``) or #13 (``(nb, Ta, R)``) + the partition's straddle
    index (``a_order`` ``(Ta*R,)`` int64, ``a_seg`` ``(n_straddle + 2,)``
    int64, ``agg_slot`` ``(T'', R)`` int32) + ``(nb,)`` bool ``active``
    (None: every plane) -> 4 x ``(T'', R)`` or ``(nb, T'', R)`` straddle
    aggregates, the ``str_*`` inputs of #12 and #14.  On every active plane
    and every chunk with ``row_done == 0`` (``agg_slot != 0``) bitwise equal
    to :func:`ref.straddle_tables`: each straddle row's copy partials summed
    left to right from 0 in sub-stream order.  Chunks with ``row_done ==
    1`` hold the dummy slot's +0.0 and 0 (#12 and #14 never read them);
    inactive planes are not written (zeros in the plain version,
    :func:`ref.straddle_combine_ref`).  ``out`` (the four aggregates and
    the four compact tables, :func:`straddle_specs`, kept by the round
    closure) is written instead of fresh tensors.

    Replaces the reference's straddle ``segment_sum``
    (``_straddle_aggregates``, src/repro/kernels/ops.py:830), not a Pallas
    kernel.  Bound on the H100: per active plane the partials at the
    straddle positions read once and the aggregates written once, plus the
    index (``a_order`` at those positions, ``a_seg``, ``agg_slot``).
    Design: two launches and no PyTorch gather -- one thread per (active
    plane, table slot) walks the slot's positions through ``a_order`` into
    a compact ``(nb, n_straddle + 1)`` table, then one thread per (active
    plane, chunk) copies its slot's entry; each warp ballots its group of
    32 planes' flags.  Float64 or float32 (``csrc/slab_tier_round.cu``
    ``straddle_combine_f32``, the same template: each slot's partials summed
    from +0.0 in sub-stream order), at 4 B a value."""
    operands = (mf, mc, xf, xc, a_order, a_seg, agg_slot)
    if active is not None:
        operands += (active,)
    if not _on_cuda(*operands):
        return ref.straddle_combine_ref(mf, mc, xf, xc, a_order, a_seg, agg_slot, active)
    lead = tuple(mf.shape[:-2])
    form = _value_form("mf", mf)
    _check_partials(mf, mc, xf, xc, tuple(mf.shape), mf.dtype)
    if len(lead) > 1:
        raise ValueError(f"partials: expected (Ta, R) or (nb, Ta, R), got {tuple(mf.shape)}")
    nb = lead[0] if lead else 1
    n_pos = mf.shape[-2] * mf.shape[-1]
    _expect("a_order", a_order, torch.int64, (n_pos,))
    _expect("a_seg", a_seg, torch.int64, (a_seg.shape[0],))
    if a_seg.shape[0] < 2:
        raise ValueError("a_seg: expected n_straddle + 2 >= 2 entries")
    _expect("agg_slot", agg_slot, torch.int32, (agg_slot.shape[0], agg_slot.shape[1]))
    if active is not None:
        _expect("active", active, torch.bool, (nb,))
    n_slots = a_seg.shape[0] - 1
    dev = mf.device
    specs = straddle_specs(tuple(mf.shape), (*lead, *agg_slot.shape), n_slots, mf.dtype)
    omf, omc, oxf, oxc, tmf, tmc, txf, txc = _outputs(out, specs, dev)
    if nb == 0:
        return omf, omc, oxf, oxc
    entry, symbol = _tier_entry("straddle_combine", form)
    err = entry(
        _p(mf), _p(mc), _p(xf), _p(xc), _p(a_order), _p(a_seg), _p(agg_slot),
        None if active is None else _p(active), _p(tmf), _p(tmc), _p(txf), _p(txc), _p(omf),
        _p(omc), _p(oxf), _p(oxc), n_slots, n_pos, agg_slot.numel(), nb, _stream(),
    )
    _launched(straddle_combine_tiles, form)
    _build.check(err, symbol)
    return omf, omc, oxf, oxc


straddle_combine_tiles.launches = 0


def node_slab_round_tiles(
    val, col_s, is_int_g, row_done, str_min_fin, str_min_cnt, str_max_fin, str_max_cnt,
    lhs_g, rhs_g, run_start, run_len, run_slab, active, lb, ub, slab: int, max_run_len: int,
    eps: float, int_eps: float, inf: float = INF, outward: float = 0.0,
    *, acc, tile_slab, chunk_len=None, max_chunk_len: int | None = None,
    flags: FlagPair | None = None, progress=None, partials=None, ticket=None,
):
    """The slab round over a node batch, IN PLACE: ONE instance's ``(T'',
    R, K)`` copies + ``(B, T'', R)`` per-node straddle aggregates + shared
    ``row_done`` / sides / run maps + ``(B, W)`` per-node planes + ``(B,)``
    ``active`` -> the planes, updated, and ``(B, n_runs)`` int32 changed
    flags.  Per node exactly :func:`batched_slab_round_tiles` at ``B ==
    1``; inactive nodes pass through.  ``acc`` is the pair of ``(B, W)``
    accumulator planes (:func:`accumulator_planes`; sentinels in every
    active row), scattered into and set back to the sentinels by the merge;
    ``tile_slab`` the copy tiles' slabs, ``chunk_len`` the copy stream's
    chunk lengths and ``max_chunk_len`` the longest, all hoisted by the
    partition (the last two computed from ``val``, and K, when omitted);
    ``flags`` the window flags' pair kept by the round closure
    (:class:`FlagPair`).  ``progress`` (a ``(B,)`` tensor; ``partials`` and
    ``ticket`` kept with it) takes each active node's early-stop measure of
    the round, as #9's (:func:`_slab_merge`).  Float64 or float32
    (``csrc/slab_tier_round.cu``, the same templates, int32 ids), at 4 B a
    value.

    Replaces ``node_slab_round_tiles`` / ``_node_slab_round_kernel``
    (src/repro/kernels/prop_round.py:1498 / :1443).  Bound on the H100: the
    copy stream once per launch (``val`` at the kept nonzeros, each copy
    stopped at its length, or at every slot, the bound beside it; ``col_s``
    and ``is_int_g`` per kept nonzero; 20 B of length, ``row_done`` and
    sides per chunk), plus per active node 24 B of straddle aggregates per
    straddle chunk, the window bounds read and written, and the accumulator
    rows written and read once.  Design: #12's two launches.  The scatter
    is node-major, as #10 is: each block ballots the mask into shared
    memory and walks (active node, chunk block) items node by node over a
    grid of at most the resident blocks; each item runs #12's chunk round
    (the window from ``tile_slab``, no search over the runs; each nonzero's
    bounds gathered once and held; chunks stopped at their length; 64-bit
    integer reductions) into the kept planes; #15's merge skips the
    inactive rows and hands the active ones back (counted as #15's
    launch).  No plane is allocated or filled per launch."""
    strs = (str_min_fin, str_min_cnt, str_max_fin, str_max_cnt)
    operands = (val, col_s, is_int_g, row_done, *strs, lhs_g, rhs_g, run_start, run_len,
                run_slab, active, lb, ub, *acc, tile_slab)
    if not _on_cuda(*operands):
        best_l, best_u = _fold(acc, ref.node_slab_scatter_ref(
            val, col_s, is_int_g, row_done, *strs, lhs_g, rhs_g, run_start, run_slab, active,
            lb, ub, slab, int_eps, inf,
        ))
        return lb, ub, _plain_slab_merge(lb, ub, best_l, best_u, active, slab, eps, inf, outward,
                                         flags, progress=progress, partials=partials)
    form = _value_form("val", val)
    bsz = lb.shape[0]
    t, r, k, bsz, width = _check_round(val, col_s, is_int_g, row_done, lhs_g, rhs_g, strs,
                                       (bsz,), lb, ub, active)
    n_runs = _check_runs(t, run_start=run_start, run_len=run_len, run_slab=run_slab)
    if n_runs != _n_slabs(width, slab):
        raise ValueError(f"{n_runs} runs, expected one per slab ({_n_slabs(width, slab)})")
    best_l, best_u = acc
    _check_planes(bsz, width, val.dtype, best_l=best_l, best_u=best_u)
    _expect("tile_slab", tile_slab, torch.int32, (t,))
    clen = _chunk_len(val, chunk_len)
    entry, symbol = _tier_entry("node_slab_scatter", form)
    err = entry(
        _p(val), _p(col_s), _p(is_int_g), _p(clen), _p(row_done), *map(_p, strs), _p(lhs_g),
        _p(rhs_g), _p(tile_slab), _p(active), _p(lb), _p(ub), _p(best_l), _p(best_u), t * r, r,
        k, _max_len(k, max_chunk_len), bsz, width, slab, int_eps, inf, _stream(),
    )
    _launched(node_slab_round_tiles, form)
    _build.check(err, symbol)
    return lb, ub, _slab_merge(lb, ub, best_l, best_u, active, slab, eps, inf, outward, flags,
                               progress=progress, partials=partials, ticket=ticket)


node_slab_round_tiles.launches = 0


def apply_updates_slab_tiles(
    lb, ub, best_l, best_u, active, slab: int, eps: float, inf: float = INF,
    outward: float = 0.0, *, flags: FlagPair | None = None, carry=None, k: int = 0,
    unroll: int = 1, stop=None, partials=None, progress=None, ticket=None,
):
    """Merge over ``(instance, slab)`` windows, IN PLACE: ``(B, W)``
    bounds and best candidates + ``(B,)`` ``active`` -> the planes, updated,
    and ``(B,)`` bool per-instance changed flags (the per-window flags
    OR-ed).  ``bounds.apply_updates`` semantics; inactive rows pass
    through.  The active rows of ``best_l``/``best_u`` are set back to the
    sentinels once read (the planes of #12 and #14 are kept for the whole
    fixed point).  ``flags`` is a kept pair for the window flags
    (:class:`FlagPair`, ``(B, n_slabs)`` int32).  With a loop ``carry``
    (``B == 1``, ``active`` its ``GO``; ``k``/``unroll`` as for F) the flags
    are folded into the carry, its early stop ``stop`` with the round's
    measure (``partials`` its block sums), and the third output is the
    carry's ``GO``; without one, ``progress`` takes each active row's
    measure (``partials``, ``ticket`` kept with it): :func:`_slab_merge`.

    Replaces ``apply_updates_slab_tiles`` / ``_apply_updates_slab_kernel``
    (src/repro/kernels/prop_round.py:1595 / :1581).  The same kernel is the
    second launch of #12 and #14.  Bound on the H100: 32 B of reads per
    active (row, column), 8 B per entry that tightens, the flags, and 16 B
    written back per accumulator entry that held a candidate.
    Design: #9's merge body on the active-only walk over (active row,
    block of 1,024 columns) items, so no block is spent on an inactive row
    (for at most 16 rows, a single instance or a small batch, a (column
    block, row) grid instead, as #9's); a thread loads its four columns'
    bounds and candidates before it merges any; a warp that takes a
    tightening in a column stride stores its window's flag once (``slab``
    a multiple of 32), into flags zeroed by the previous launch with the
    pair (or allocated zeroed without one).  For one instance's fixed
    point the flags are folded into the loop carry instead (F's
    ``CarryFlags``, or with the early stop F's ``StopCarryFlags``); a
    batch's per-row measure is #9's (``WindowStopFlags``).  Float64 or
    float32 (``csrc/slab_tier_round.cu``), at 4 B a value."""
    if stop is not None and unroll != 1:
        raise ValueError(f"unroll={unroll}: #15's early stop takes one round a check group")
    if not _on_cuda(lb, ub, best_l, best_u, active):
        out = _plain_slab_merge(lb, ub, best_l, best_u, active, slab, eps, inf, outward, flags,
                                carry, k, unroll, stop, partials, progress)
        return lb, ub, out if carry is not None else out.any(dim=1)
    bsz, width = lb.shape
    if bsz > MAX_GRID_Y:
        raise ValueError(f"{bsz} planes exceed the grid's {MAX_GRID_Y}")
    _check_planes(bsz, width, _float_dtype("lb", lb), lb=lb, ub=ub, best_l=best_l, best_u=best_u)
    _expect("active", active, torch.bool, (bsz,))
    out = _slab_merge(lb, ub, best_l, best_u, active, slab, eps, inf, outward, flags, carry, k,
                      unroll, stop, partials, progress, ticket)
    return lb, ub, out if carry is not None else out.any(dim=1)


apply_updates_slab_tiles.launches = 0


KERNELS = (
    fused_scatter_round_tiles,
    activities_gather_tiles,
    candidates_scatter_tiles,
    apply_updates_tiles,
    combine_chunk_partials_tiles,
    node_fused_scatter_round_tiles,
    apply_updates_batch_tiles,
    node_objective_tiles,
    batched_fused_scatter_round_tiles,
    batched_slab_partials_tiles,
    batched_slab_round_tiles,
    node_slab_partials_tiles,
    node_slab_round_tiles,
    apply_updates_slab_tiles,
    straddle_combine_tiles,
    activities_tiles,
    candidates_tiles,
    fused_round_tiles,
    node_activities_gather_tiles,
    node_combine_chunk_partials_tiles,
    node_candidates_scatter_tiles,
)


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last :func:`reset_launch_counts`."""
    return {fn.__name__: fn.launches for fn in KERNELS}


def form_counts() -> dict:
    """Launches of the tier kernels (every kernel but #16) by form since
    the last :func:`reset_launch_counts`, keyed ``"<wrapper>[<form>]"``
    (:data:`TIER_FORMS`, the early stop of F, #9 and #15 as ``"+stop"``,
    #15's per-row measure of a batch as ``"+stop_rows"``)."""
    return {f"{name}[{form}]": n for (name, form), n in FORM_LAUNCHES.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
    FORM_LAUNCHES.clear()
