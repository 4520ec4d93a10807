#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Run from the root of a checkout.  It imports ``src/repro_torch`` (torch and
numpy only, nothing of JAX) and, on one CUDA card:

  1. prints the card's name and power limit, builds the CUDA kernels of
     ``src/repro_torch/csrc/prop_round.cu``, ``slab_round.cu``,
     ``tier_round.cu``, ``batch_tier_round.cu``, ``slab_tier_round.cu`` and
     ``telemetry.cu`` from source (one ``nvcc`` per file, in parallel) and
     prints the build time and the compilers' register report;
  2. generates three instances at n = 60,000 columns, 150,000 rows (the
     paper's Set-5 size): ``pb`` (pseudo-boolean, exact arithmetic, rows in
     one chunk), ``banded`` (rows in one chunk) and ``mixed`` (MIPLIB-like,
     rows spanning chunks);
  3. holds each kernel against its plain PyTorch version on the card, at the
     shapes the main path gives it, and times both with CUDA events: the
     kernel's own launch, the wrapper call as a whole, and the plain
     version (D, A' and E beside the times of the kernels they replace).
     D and E scatter into accumulator planes kept as the round closure
     keeps them (at the sentinels before each timed launch), D with the
     hoisted chunk lengths and longest chunk (its lanes per chunk printed:
     chunks of at most 16 slots share a warp), and again into fresh planes
     and with a warp per chunk; F must hand its planes back at the
     sentinels;
  4. resets the launch counters, runs ``propagate_block_ell`` with its
     defaults on the three instances (the main path), reads the counters,
     and holds each result against the plain-version path
     (``use_kernels=False``) and the plain-PyTorch ``propagate``, all on the
     card: rounds, converged and infeasible exactly; bounds bitwise against
     the plain-version path (the long-row combine of ``mixed`` sums in one
     fixed order) and between two runs of the kernel path, under
     ``bounds_equal`` against ``propagate``, which sums in another order; on
     ``pb`` also bitwise against ``propagate`` over the rounds whose sums are
     exact; the round closure's kept planes must be clean after each of its
     first three rounds; then one warm-started branch-and-bound node on
     ``pb``;
  5. prints per-round times, host syncs per fixed point and the card's idle
     share per fixed point;
  6. (phase 5) builds ``pbf``, a pseudo-boolean instance at the same size
     that is feasible at the root, and holds the node-batch kernels against
     their plain versions at the solver's shapes: the node round (#10, into
     accumulator planes kept across its launches as the engine keeps them,
     reset between timed launches) and the batched merge (#9, which must
     hand the active rows back and leave the others) on its (18,750, 8, 8)
     tiles over a (128, 60,032) pool
     of warm-started node bounds with 0, 8 and 128 active rows, #10's bound
     with ``val`` read at the nonzeros (each chunk stopped at its length)
     beside the bound with ``val`` at every slot, and the node objective (#16)
     on the same pool, all bitwise, timed; then (5b)
     the multi-chunk node round's kernels -- A', the combine and E over a
     node batch -- on pbf's tiles at tile width 4 over the same pool with 8
     and 128 active rows, bitwise against their plain versions and, node by
     node, against the single-instance kernels, timed, and one node round
     of 4 and of 128 nodes, which must make the same launches; then the
     long-row combine at the shapes of its longest rows (5c): the flat form
     on two of the service's mixed requests packed at tile width 8 (rows of
     3,000 chunks), the node form on ``mixed`` under 4 node planes (tile
     width 128, rows of 375 chunks), bitwise and timed beside
     ``torch.segment_reduce``'s float64 sums and spread (a yardstick);
  7. (phase 6) runs ``propagate_nodes`` on 64 ``pbf`` nodes, 16 ``banded``
     nodes and 4 ``mixed`` nodes (the multi-chunk node round) and holds
     every node bitwise against its own single-instance
     ``propagate_block_ell`` and against the plain-version path;
  8. (phase 7) runs ``solve`` on the small instances whose reference results
     are hard-coded below and on ``pbf`` at full width (128 pool slots),
     holds the search against the reference's counts and the kernel path
     against the plain path (result and final pool), and prints levels,
     nodes, host syncs, flag reads, ms per level, nodes per second and the
     idle share; then the same search at tile width 4, where rows span two
     chunks and each round runs A', the combine and E over the whole pool
     and #9 (one launch each per round, checked), held against the
     tile-width-8 search (result and final pool), timed and profiled;
  9. (phase 8) past 2^16 columns, where ``scatter="auto"`` takes the
     column-slab partitioned engine: builds ``bandw`` and ``pbw``
     (n = m = 150,000; n_pad 150,016, three slabs of 50,048 columns) and
     their slab partitions (build seconds printed); holds kernels #11 and
     #12 (with #15's window merge, into kept planes, with the nonzero bound
     beside the all-slot bound) against their plain versions on both
     partitions at K = 128, #15 alone on both single planes, kernel D + F
     at n_pad 150,016, and #13 (the partition's hoisted sub-stream tile
     slabs and copy lengths), #14 (into kept planes) and #15 on pbw's
     K = 8 partition over a (128, 150,016) pool with 0, 8 and 128 active
     rows (#13 and #14 with the nonzero bound beside the all-slot bound),
     all bitwise, timed; the straddle combine on both
     single planes and on that pool, bitwise against its plain version on
     the active planes and against ``straddle_tables`` where ``row_done ==
     0``, timed; runs ``propagate_block_ell`` with
     its defaults on both (30 and 6 rounds, as the reference) against the
     plain path and a second run (bitwise) and the explicit fused engine
     (``bounds_equal``, differing entries counted), with ms per round for
     both engines, host syncs and the idle share; ``propagate_nodes`` on 16
     branched pbw nodes, each bitwise against its single-instance run and
     the plain path; ``solve`` on pbw (128 slots, 8 levels) against the
     reference's counts, the plain path and the same search through the
     fused node round (#10 + #9), same result and final pool;
 10. (phase 11, run after phase 8) the segment (seed) dataflow on the
     instances of phases 2 and 8: kernel C on ``pb`` and ``banded`` and
     kernels A and B on ``mixed`` against their plain versions (bitwise),
     timed, with the segment round's column reduction timed over the
     nonzero slots (as the engine runs it) and over every slot;
     ``propagate_block_ell(scatter="segment")`` on the three instances,
     held bitwise (as values, rounds, converged and infeasible exactly)
     against the fused main-path run and its plain path, with ms per round
     beside the fused engine's, slots and peak device memory; ``bandw``
     through ``scatter="auto"`` under ``REPRO_AUTO_LARGE_SCATTER=segment``
     (kernel C, not #11/#12), against the partitioned run of phase 8 and,
     bitwise, the explicit fused engine; one ``legacy_round_fn_for`` round
     on ``pb`` against one prepared segment round;
 11. (phase 9) runs ``propagate_batch`` with its defaults on three buckets:
     ``pb``, ``pbf``, ``banded`` and a second banded instance at n_pad
     60,032 (kernel #8 then #9), ``mixed`` and a second mixed instance
     (A', the combine and E over the flat stream, then #9), ``bandw`` and
     ``pbw`` past 2^16 (the partitioned round with two planes); holds #8
     (into kept planes, the prep's hoisted chunk ranges and lengths, both
     bounds) against its plain version at the fused bucket's shapes with
     0, 2 and 4 instances active (timed), and the straddle combine on the
     partitioned bucket and every instance bitwise against its own
     ``propagate_block_ell`` and the plain path, plus one ``bounds=`` warm
     start; prints batch and summed single-instance fixed-point times, flag
     reads and the idle share;
 12. (phase 10) serves 24 requests (12 pseudo-boolean at n = 60,000 and 12
     banded at n = 40,000, 30,000 to 90,000 rows) through
     ``PropagationService.from_problems(slots=4, size_classes=2,
     rounds_per_step=8)`` and 4 mixed requests through a 2-slot service;
     holds every ticket bitwise against a one-shot ``propagate_batch`` on
     the kernels and on the plain versions; prints instances/s at
     saturation (pre-packed, all submitted, then drained) against
     sequential ``propagate_block_ell``, latency percentiles, pumps, flag
     reads per pump, the idle share and per-bucket stats;
 13. (phase 12, last) the named drivers: kernel F with the loop carry
     against its plain version over the rounds of one fixed point (groups
     of 3, through convergence and two rounds enqueued after it: bounds,
     handed-back planes and the carry bitwise), the round closures of
     ``banded``, the partitioned ``pbw`` and the segment engine on
     ``mixed`` on the kernels against the plain versions with their
     carries armed (through convergence and rounds enqueued after it);
     every single-instance fixed point above (``pb``, ``banded``,
     ``mixed``, ``bandw``, ``pbw``, and the segment engine on the first
     three) on ``driver="device_loop"`` against its ``host_loop`` run
     (bitwise, progress included), host reads counted (``pb`` must read
     fewer times than its 33 rounds); the read groups
     (``DEVICE_LOOP_GROUP`` for the gated engines, ``UNGATED_LOOP_GROUP``
     for the segment engine and the plain round) timed over 1, 2, 4, 8 and
     16 on those runs and on ``propagate``'s plain round (the module's
     values printed beside the fastest); ``propagate``'s three drivers on
     ``pb`` (``tools/driver_profile.py`` traces the same runs per driver
     in a fresh process);
 14. (phase 13) the precision tiers: the float32 forms of D, A', the
     combine, E and F (int32 ids on ``pb`` and ``mixed``, the compact int16
     / int8 streams on ``pb30`` and ``mixed30``, n_pad 30,080; the float64
     forms timed on the same instances) and F with the early stop (float64
     and float32) against their plain versions, bitwise, with their times
     and bounds at 4 B a value, 2 B a compact column and 1 B a compact
     mark; then, with the launch counters at zero, the float32-only fixed
     points on both drivers against the plain float32 path on the card
     (rounds, flags, bounds and progress bitwise), the two-tier runs
     (``TierPolicy()``) on ``pb`` (infeasible: the guard path), ``pbf``
     and ``mixed`` against the float64-only runs (same verdict, integer
     bounds bitwise, continuous ones within 1e-6 (1 + |b|), at least one
     fp32 round), and the early stop (``TierPolicy(two_tier=False,
     stop_progress=0.05, patience=1)``) on both drivers (same rounds and
     bounds); every float form must have been launched; the walls of the
     float64-only, float32-only and two-tier fixed points by driver;
 15. (phase 14) the precision tiers on the batched engines: the float32
     forms of #8 (phase 9's fused bucket, 2 and 4 of 4 active), of #10 and
     the node-batched A', combine and E (128-slot pools of ``pbf``, int32
     ids, and ``pb30``, compact, with 8 and 128 active) and of #9, the flat
     A', combine and E at float32 on phase 9's multi-chunk bucket, and #9
     with the early stop's measure (float64 and float32, through two rounds
     of a stop: partials, measure and the streak) against their plain
     versions, bitwise, timed beside the float64 forms; then, with the
     launches counted, ``propagate_batch`` (the fused bucket at float32,
     under ``TierPolicy()`` and with ``stop_progress=0.05``; the multi-chunk
     bucket at float32), ``propagate_nodes`` (8 nodes of ``pbf`` and
     ``pb30`` at tile widths 8 and 4) and a four-request service stream (at
     float32 and with the early retire, ``early_stopped >= 1``) against
     the plain path (bitwise) and the float64-only runs (never falsely
     infeasible at float32; two tiers: the same verdict, integer bounds
     bitwise, continuous within 1e-6 (1 + |b|); the early stop: no more
     rounds, an uncut run bitwise); the walls of the fused batch and the
     ``pbf`` nodes by variant; every float form must have been launched;
 16. (phase 15, last) the precision tiers on the segment and partitioned
     engines: the float32 forms of A, B and C (``pb``, ``banded``, ``mixed``
     with int32 ids; ``pb30``, ``mixed30`` with the compact int8 marks), of
     #11, the straddle combine, #12 and #15 (``bandw``, ``pbw``), of #13 and
     #14 (the ``pbw`` pool, 8 and 128 of 128 active), #15 with the early
     stop folded into one instance's loop carry (float64 and float32, two
     rounds: bounds, planes and the whole carry) and #15 with the per-row
     measure (the partitioned bucket's two planes, timed, and the pool's
     128 on the walk) against their plain versions, bitwise, timed beside
     the float64 forms; then, with the launches counted, the segment engine
     (float32-only on the five instances, ``TierPolicy()`` and the early
     stop on ``pb`` and ``mixed``), ``scatter="auto"`` past 2^16 on
     ``bandw`` and ``pbw`` (float32, two tiers, the early stop at float32
     and float64), ``propagate_batch`` on ``[bandw, pbw]`` and
     ``propagate_nodes`` on 8 ``pbw`` nodes, each on both drivers where it
     has two, bitwise against the plain path and held to the float64-only
     runs; the walls of each by variant; every new float form must have
     been launched;
 17. (phase 16, last) the device telemetry: the record kernels
     (``record_round`` on ``pb``'s final and root bounds at float64 and at
     float32, across a wrap, gated, with both latches and the host loop's
     probe; ``record_round_batch`` on the fused bucket at 4 and 2 of 4
     active) against their plain versions, bitwise, timed; then telemetry
     on against off, every result field bitwise and the host reads equal,
     the launches counted per run: ``pb``, ``mixed`` and ``bandw``
     (partitioned) on both drivers, the fused batch, the 64 ``pbf`` nodes,
     the ``pbf`` search and the service stream; the fp32 tier's and the
     endgame's trajectories under ``TierPolicy()`` on ``pb``, ``pbf``,
     ``mixed`` and ``bandw``; and the walls with telemetry on and off
     (``pb`` and ``mixed`` device_loop, the fused batch);
 18. (phase 17, last) the sharded engines (``repro_torch.core.sharded``)
     on worlds started by ``run_world`` after the kernels are built: one
     rank on NCCL, and four ranks sharing the card over ``gloo`` with CUDA
     tensors (NCCL refuses two ranks on one card).  Each rank runs
     ``propagate_sharded`` on ``mixed`` (A', the combine, the SUM
     all-reduce, E, the MAX/MIN all-reduce, F) and ``pb``,
     ``propagate_sharded_rows`` on ``pb`` and ``banded`` (D, MAX/MIN, F) and
     ``propagate_batch_sharded`` on the fused bucket ``[pb, pbf, banded,
     banded1]`` (#8 + #9) and the multi-chunk bucket ``[mixed, mixed1]``,
     with its launches counted per run; every rank's results must be rank
     0's bitwise, the row and batch partitions the unsharded port's
     (``propagate_block_ell``, ``propagate_batch``) bitwise, the nnz
     partition ``bounds_equal`` with equal rounds on ``mixed`` and bitwise
     on ``pb``; walls are CUDA events after a barrier, medians of 5 (the
     world of one beside the unsharded ``propagate_block_ell`` and
     ``propagate_batch`` timed the same way in its process), with the
     seconds each world took to start, run and stop;
 19. prints a ``kernels`` JSON line (the float forms as ``<wrapper>[<form>]``),
     and last ``{"ok": true, "device": {...}}``.

Each path runs with the launch counters at zero just before it and read just
after; every kernel must have been launched by the main-path runs.

Any failed check raises, so the exit code is not 0 and no result is printed.
Without a CUDA device it exits with code 2 before doing anything.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and the dense float64
# and float32 rates outside the tensor cores, the rates of this vector
# arithmetic.
HBM_BYTES_PER_S = 3.35e12
F64_FLOPS = 34e12
F32_FLOPS = 67e12

# The three smoke instances: (name, generator, kwargs).
SPECS = [
    ("pb", "make_pseudo_boolean", dict(n=60_000, m=150_000, seed=0)),
    ("banded", "make_banded", dict(n=60_000, m=150_000, row_nnz=24, band=7_500, seed=0)),
    ("mixed", "make_mixed", dict(m=150_000, n=60_000, seed=0, density=0.0005)),
]
# Rounds the JAX reference's pure-jnp propagate takes on these instances
# (on a CPU); pb must also end infeasible.
REFERENCE_ROUNDS = {"pb": 33, "banded": 6, "mixed": 16}
# Rounds of pb over which every sum stays exact (verified at run time).
PB_EXACT_ROUNDS = 24

# pbf: the pseudo-boolean family at the same size with fewer unit clauses,
# feasible at the root (pb is not), so a search on it goes deeper than one
# level.  The solver's default tile width is 8.
PBF = dict(n=60_000, m=150_000, seed=0, unit_frac=0.002)
PBF_ROUNDS = 9  # the reference's propagate on pbf: 9 rounds, feasible
SOLVER_TILE_WIDTH = 8
MULTI_CHUNK_TILE_WIDTH = 4  # pbf's rows of 5-8 nonzeros span two chunks
POOL = 128

# The reference's repro.core.solve on the small instances (on a CPU, tile
# width 8, node_cap 256, the objective c_j = (j+1)(-1 if j % 3 == 0 else 1)):
# status, objective, expanded, created, leaves, pruned bound, pruned
# infeasible, levels.
SOLVE_REFERENCE = [
    ("make_pseudo_boolean", dict(n=12, m=16, seed=0), "most_fractional",
     ("optimal", -2.0, 29, 59, 16, 14, 0, 7)),
    ("make_pseudo_boolean", dict(n=12, m=16, seed=0), "pseudo_cost",
     ("optimal", -2.0, 27, 55, 15, 13, 0, 7)),
    ("make_random_mip", dict(n=9, m=12, seed=1), "most_fractional",
     ("optimal", 10.0, 4, 9, 4, 1, 0, 4)),
    ("make_random_mip", dict(n=9, m=12, seed=1), "pseudo_cost",
     ("optimal", 10.0, 4, 9, 4, 1, 0, 4)),
    ("make_random_mip", dict(n=9, m=12, seed=0), "most_fractional",
     ("infeasible", 1e20, 0, 1, 0, 0, 1, 1)),
    ("make_random_mip", dict(n=9, m=12, seed=0), "pseudo_cost",
     ("infeasible", 1e20, 0, 1, 0, 0, 1, 1)),
    ("make_pseudo_boolean", dict(n=40, m=56, seed=7), "most_fractional",
     ("pool_exhausted", 1e20, 255, 511, 0, 0, 0, 9)),
    ("make_pseudo_boolean", dict(n=40, m=56, seed=7), "pseudo_cost",
     ("pool_exhausted", 1e20, 255, 511, 0, 0, 0, 9)),
]
# The full-width search on pbf and the reference's result for it:
# status, expanded, created, levels, host syncs.
FULL_SEARCH = dict(node_cap=POOL, expand_width=4, max_levels=16, sync_every=8)
FULL_REFERENCE = ("level_limit", 59, 119, 16, 2)

# Phase 8, past 2^16 columns, where scatter="auto" takes the partitioned
# engine: bandw is banded at 2.5 times the columns (rows rarely cross a slab
# edge: the engine's intended case), pbw is pbf at 2.5 times the columns
# (rows draw columns from the whole range, so nearly every row straddles
# slabs: its worst case; pure-integer, so solve runs on it).
WIDE_SPECS = [
    ("bandw", "make_banded", dict(n=150_000, m=150_000, row_nnz=24, band=7_500, seed=0)),
    ("pbw", "make_pseudo_boolean", dict(n=150_000, m=150_000, seed=0, unit_frac=0.002)),
]
# The reference's propagate_block_ell (its partitioned engine, on a CPU):
# rounds; both converge feasible.
WIDE_ROUNDS = {"bandw": 30, "pbw": 6}
WIDE_BRANCHED = 4  # 2**4 = 16 pbw nodes
# The reference's repro.core.solve on pbw with this call (on a CPU, tile
# width 8): status, expanded, created, levels, host syncs.
WIDE_SEARCH = dict(node_cap=POOL, expand_width=4, max_levels=8, sync_every=4)
WIDE_REFERENCE = ("level_limit", 27, 55, 8, 2)

# Phase 9: the batched engine's three buckets (instances of earlier phases
# plus a second banded and a second mixed instance of the same size).
BANDED1 = dict(n=60_000, m=150_000, row_nnz=24, band=7_500, seed=1)
MIXED1 = dict(m=150_000, n=60_000, seed=1, density=0.0005)
# Phase 10: the service's request streams (the paper's Set-3/Set-4 scale):
# rows drawn from [30,000, 90,000) by default_rng(0), 12 + 12 requests in two
# col_pad classes split into size classes, and 4 mixed requests whose long
# rows span chunks.  The reference bench's service settings.
SERVICE_REQUESTS = 12
SERVICE_ROWS = (30_000, 90_000)
SERVICE_SLOTS = 4
SERVICE_SIZE_CLASSES = 2
SERVICE_ROUNDS_PER_STEP = 8
SERVICE_MIXED = 4
SERVICE_TIMED_RUNS = 2

SOURCE = "src/repro_torch/csrc/prop_round.cu"
SLAB_SOURCE = "src/repro_torch/csrc/slab_round.cu"
TIER_SOURCE = "src/repro_torch/csrc/tier_round.cu"
BATCH_TIER_SOURCE = "src/repro_torch/csrc/batch_tier_round.cu"
REPLACES = {
    "fused_scatter_round_tiles": "src/repro/kernels/prop_round.py:580",
    "activities_gather_tiles": "src/repro/kernels/prop_round.py:269",
    "candidates_scatter_tiles": "src/repro/kernels/prop_round.py:651",
    "apply_updates_tiles": "src/repro/kernels/prop_round.py:721",
    # Not a Pallas kernel: the XLA segment_sum of the long-row combine.
    "combine_chunk_partials_tiles": "src/repro/kernels/ops.py:821",
    "node_fused_scatter_round_tiles": "src/repro/kernels/prop_round.py:964",
    "apply_updates_batch_tiles": "src/repro/kernels/prop_round.py:1666",
    "node_objective_tiles": "src/repro/kernels/prop_round.py:1730",
    "batched_slab_partials_tiles": "src/repro/kernels/prop_round.py:1129",
    "batched_slab_round_tiles": "src/repro/kernels/prop_round.py:1258",
    "node_slab_partials_tiles": "src/repro/kernels/prop_round.py:1383",
    "node_slab_round_tiles": "src/repro/kernels/prop_round.py:1498",
    "apply_updates_slab_tiles": "src/repro/kernels/prop_round.py:1595",
    "batched_fused_scatter_round_tiles": "src/repro/kernels/prop_round.py:816",
    "activities_tiles": "src/repro/kernels/prop_round.py:226",
    "candidates_tiles": "src/repro/kernels/prop_round.py:347",
    "fused_round_tiles": "src/repro/kernels/prop_round.py:414",
    # No Pallas twin: the reference vmaps its single-instance jnp round over
    # the nodes there (A', the XLA combine and E per node).
    "node_activities_gather_tiles": "src/repro/kernels/ops.py:2031",
    "node_combine_chunk_partials_tiles": "src/repro/kernels/ops.py:2031",
    "node_candidates_scatter_tiles": "src/repro/kernels/ops.py:2031",
    # Not a Pallas kernel: the XLA segment_sum of the straddle aggregates.
    "straddle_combine_tiles": "src/repro/kernels/ops.py:830",
    # No Pallas twin: the reference records telemetry with jnp ops
    # (obs.record_round) in its while_loop bodies.
    "record_round_tiles": "src/repro/obs/telemetry.py:93",
    "record_round_batch_tiles": "src/repro/obs/telemetry.py:93",
}
# The C entry point that launches each wrapper's kernel (the slab rounds
# launch two: their scatter, then #15's window merge).
SYMBOL = {
    "fused_scatter_round_tiles": "fused_scatter_round",
    "activities_gather_tiles": "activities_gather",
    "candidates_scatter_tiles": "candidates_scatter",
    "apply_updates_tiles": "apply_updates",
    "combine_chunk_partials_tiles": "combine_chunk_partials",
    "node_fused_scatter_round_tiles": "node_fused_scatter_round",
    "apply_updates_batch_tiles": "apply_updates_batch",
    "node_objective_tiles": "node_objective",
    "batched_slab_partials_tiles": "slab_partials",
    "batched_slab_round_tiles": "slab_scatter",
    "node_slab_partials_tiles": "node_slab_partials",
    "node_slab_round_tiles": "node_slab_scatter",
    "apply_updates_slab_tiles": "slab_merge",
    "batched_fused_scatter_round_tiles": "batched_fused_scatter_round",
    "activities_tiles": "activities",
    "candidates_tiles": "candidates",
    "fused_round_tiles": "fused_round",
    "node_activities_gather_tiles": "node_activities_gather",
    "node_combine_chunk_partials_tiles": "node_combine_chunk_partials",
    "node_candidates_scatter_tiles": "node_candidates_scatter",
    "straddle_combine_tiles": "straddle_combine",
    "record_round_tiles": "record_round",
    "record_round_batch_tiles": "record_round_batch",
}
# Nominal float64 operations per real nonzero (products, sums, residual
# subtractions, divisions, rounding) -- the compute side of each bound.
OPS_PER_NNZ = {
    "fused_scatter_round_tiles": 16,
    "activities_gather_tiles": 4,
    "candidates_scatter_tiles": 12,
    "apply_updates_tiles": 0,
    "combine_chunk_partials_tiles": 0,  # four adds per chunk: bytes bound it
    "activities_tiles": 4,
    "candidates_tiles": 12,
    "fused_round_tiles": 16,
    "node_activities_gather_tiles": 4,
    "node_candidates_scatter_tiles": 12,
    "node_combine_chunk_partials_tiles": 0,
    "straddle_combine_tiles": 0,  # four adds per straddle position: bytes bound it
}
# Kernels that stop each chunk at its length: their bound counts val at the
# nonzeros, and the bound with val at every slot is printed beside it.
STOPPED = ("fused_scatter_round_tiles", "activities_gather_tiles", "candidates_scatter_tiles")
# Times before their redesign (one dependent chain per stride over every
# slot, compare-and-swap max/min; NVIDIA H100 80GB HBM3, 700 W): A' and E
# on mixed, D on pb, printed beside this run's.
BEFORE_REDESIGN_MS = {("activities_gather_tiles", "mixed"): 0.1695,
                      ("candidates_scatter_tiles", "mixed"): 0.2150,
                      ("fused_scatter_round_tiles", "pb"): 0.1430}


def log(*args):
    print(*args, flush=True)


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def time_ms(torch, fn, reps: int = 10, trials: int = 5) -> float:
    """Median over ``trials`` of the mean CUDA-event time of ``reps`` calls."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / reps)
    return statistics.median(out)


def device_items(torch, fn) -> list[tuple[str, float]]:
    """``(name, microseconds)`` of every device item (kernel, memset, copy)
    that ``torch.profiler`` records over one call of ``fn``.  Only the
    device's own events count: a CPU op's device time repeats theirs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == DeviceType.CUDA]


class EventTimedLib:
    """Stands in for the kernel library while a kernel is timed: brackets
    each C entry call with CUDA events on the current stream, so an event
    pair holds the kernel's own device time, not the wrapper's fills."""

    def __init__(self, torch, lib):
        from repro_torch.kernels import _build

        self.torch, self.lib, self.pairs = torch, lib, []
        # The kernels' entry points: SYMBOL's and the float forms'.
        self.timed = (set(SYMBOL.values()) | set(_build.SIGNATURES["tier_round.cu"])
                      | set(_build.SIGNATURES["batch_tier_round.cu"])
                      | set(_build.SIGNATURES["slab_tier_round.cu"])
                      | set(_build.SIGNATURES["telemetry.cu"]))

    def __getattr__(self, name):
        entry = getattr(self.lib, name)
        if name not in self.timed:
            return entry

        def timed(*args):
            start = self.torch.cuda.Event(enable_timing=True)
            end = self.torch.cuda.Event(enable_timing=True)
            start.record()
            err = entry(*args)
            end.record()
            self.pairs.append((start, end))
            return err

        return timed


def kernel_ms(torch, build, fn, reps: int = 20, reset=None, launches: int = 1) -> float:
    """Median device time of the kernel launches in each of ``reps`` calls
    of the wrapper call ``fn`` (``launches`` per call, summed: the slab
    rounds launch their scatter and the window merge).  Each call is queued
    behind a sleep on the card, so no host time falls between the events
    around a launch; ``reset`` (untimed) runs before each call."""
    real = build.lib
    timed = EventTimedLib(torch, real())
    build.lib = lambda: timed
    try:
        for _ in range(reps):
            if reset is not None:
                reset()
            torch.cuda._sleep(1_000_000)
            fn()
        torch.cuda.synchronize()
    finally:
        build.lib = real
    if len(timed.pairs) != reps * launches:
        fail(f"timed {len(timed.pairs)} launches, expected {reps * launches}")
    ms = [start.elapsed_time(end) for start, end in timed.pairs]
    return statistics.median(sum(ms[i : i + launches]) for i in range(0, len(ms), launches))


def fresh_inputs(torch, pairs):
    """A ``reset`` for :func:`kernel_ms` of an in-place merge: copy each
    pristine tensor over its scratch copy, so every timed launch does the
    stores of this run's inputs, then evict the L2 (64 MiB of zeros) so the
    launch reads from device memory, as its bound assumes."""
    flush = torch.empty(64 << 17, dtype=torch.float64, device=pairs[0][0].device)

    def reset():
        for scratch, pristine in pairs:
            scratch.copy_(pristine)
        flush.zero_()

    return reset


def merge_bytes(torch, bnd, lb, ub, best_l, best_u, eps, active=None, inf=None) -> dict:
    """Bytes an in-place merge must move on these inputs: the bounds and
    candidates of every active column read, and a value (8 B at float64, 4
    at float32) for each entry that tightens (most store nothing); with
    ``inf``, the batched merges' hand-back too: a value for each active
    accumulator entry that holds a candidate (set back to the sentinel
    ``-inf`` or ``inf``)."""
    take_l, take_u = bnd.improved_lb(best_l, lb, eps), bnd.improved_ub(best_u, ub, eps)
    held_l, held_u = best_l != -(inf or 0.0), best_u != (inf or 0.0)
    if active is not None:
        take_l, take_u = take_l & active[:, None], take_u & active[:, None]
        held_l, held_u = held_l & active[:, None], held_u & active[:, None]
        cols = int(active.sum()) * lb.shape[-1]
    else:
        cols = lb.shape[-1]
    v = lb.element_size()
    out = dict(bounds=2 * v * cols, best=2 * v * cols,
               stores=v * int(take_l.sum() + take_u.sum()))
    if inf is not None:
        out["handback"] = v * int(held_l.sum() + held_u.sum())
    return out


def call_ms(torch, fn, reset, reps: int = 10) -> float:
    """Median time of one wrapper call ``fn`` between synchronisations (CUDA
    events around the call, so the host's work counts where the card waits
    for it), with ``reset`` (untimed) before each: the kept-plane scatters,
    whose repeated calls would otherwise find their planes full."""
    out = []
    for _ in range(reps):
        reset()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end))
    return statistics.median(out)


def max_abs_err(torch, got, want) -> float:
    """Largest |kernel - plain| over a tuple of outputs, after requiring that
    they are equal as values: the plain versions sum in the kernels' order
    (``ref.warp_order_sum``), so the two round alike on any data."""
    err = 0.0
    for g, w in zip(got, want):
        if g.dtype != w.dtype or g.shape != w.shape:
            fail(f"output mismatch: {g.dtype}{tuple(g.shape)} vs {w.dtype}{tuple(w.shape)}")
        if not torch.equal(g, w):
            d = (g.double() - w.double()).abs().max().item()
            fail(f"kernel disagrees with its plain version: max abs diff {d}")
        if g.numel():
            err = max(err, (g.double() - w.double()).abs().max().item())
    return err


def bound(nbytes: int, ops: float, flops: float = F64_FLOPS) -> tuple[float, str]:
    """The least time for ``nbytes`` of device memory traffic and ``ops``
    operations at the rate ``flops`` (float64's by default), and which of
    the two sets it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def needed_bytes(kname: str, prep, nnz: int) -> dict:
    """Bytes the kernel's function must move, each input read once and each
    output written once: ``val`` for every padded slot (its zeros mark the
    padding), ``col`` and the integrality marks for each real nonzero only,
    the per-chunk row data, and the (n_pad,) vectors -- for the segment
    kernels A, B and C the gathered bounds at each nonzero instead, and B's
    and C's two (T, R, K) candidate outputs.  D, A' and E stop each chunk at
    its length (an input, 4 B per chunk), so they need ``val`` at the
    nonzeros only: :func:`padded_val_bytes` gives their bound with ``val``
    at every slot, the one the kernels before the redesign were held to.
    Values take the prep's width (8 B at float64, 4 at float32), columns
    and marks theirs (4 B, or 2 B and 1 B on the compact float32 streams).
    """
    t, r, k = prep.d.val.shape
    v, c, mk = prep.d.val.element_size(), prep.d.col.element_size(), prep.ii_g.element_size()
    slots, chunks, vec = t * r * k, t * r, v * prep.n_pad
    if kname == "fused_scatter_round_tiles":
        return dict(val=v * nnz, col=c * nnz, is_int=mk * nnz, chunk_len=4 * chunks,
                    rows=2 * v * chunks, bounds=2 * vec, out=2 * vec)
    if kname == "activities_gather_tiles":
        return dict(val=v * nnz, col=c * nnz, chunk_len=4 * chunks, bounds=2 * vec,
                    out=(2 * v + 8) * chunks)
    if kname == "candidates_scatter_tiles":
        return dict(val=v * nnz, col=c * nnz, is_int=mk * nnz, chunk_len=4 * chunks,
                    rows=(4 * v + 8) * chunks, bounds=2 * vec, out=2 * vec)
    if kname == "combine_chunk_partials_tiles":
        return dict(partials=(2 * v + 8) * chunks, row_start=8 * (prep.m + 2),
                    classes=4 * (prep.m + 1), out=(2 * v + 8) * chunks)
    if kname == "activities_tiles":
        return dict(val=v * slots, bounds=2 * v * nnz, out=(2 * v + 8) * chunks)
    if kname == "candidates_tiles":
        return dict(val=v * slots, bounds_ii=(2 * v + mk) * nnz, rows=(4 * v + 8) * chunks,
                    out=2 * v * slots)
    if kname == "fused_round_tiles":
        return dict(val=v * slots, bounds_ii=(2 * v + mk) * nnz, sides=2 * v * chunks,
                    out=2 * v * slots)
    raise KeyError(kname)


def padded_val_bytes(moved: dict, prep) -> dict:
    """D, A' or E's bytes with ``val`` read at every padded slot and no
    lengths: the bound of the kernels before the redesign, which walked
    every slot."""
    t, r, k = prep.d.val.shape
    out = {key: v for key, v in moved.items() if key != "chunk_len"}
    out["val"] = prep.d.val.element_size() * t * r * k
    return out


def segment_reduce_ms(torch, partials, chunk_row, row_start, active=None):
    """The long-row combine's yardstick (used nowhere in the port): time of
    ``torch.segment_reduce``'s float64 sums of the two float partials over
    the segments (``offsets=row_start``, on the active planes of a node
    batch), spread back to the chunks; the counts left out, the sums in
    PyTorch's own order.  None where this PyTorch build has no such
    reduction on the card."""
    crow = chunk_row.reshape(-1).long()
    floats = (partials[0], partials[2])
    if active is None:
        data = [x.reshape(-1) for x in floats]
        offsets, axis = row_start, 0
    else:
        data = [x[active].reshape(int(active.sum()), -1) for x in floats]
        offsets, axis = row_start.expand(data[0].shape[0], -1).contiguous(), 1

    def run():
        return [torch.segment_reduce(x, "sum", offsets=offsets, axis=axis, unsafe=True)[
            ..., crow] for x in data]

    try:
        run()
    except (RuntimeError, NotImplementedError) as exc:
        log(f"segment_reduce yardstick not measured: {exc}")
        return None
    return time_ms(torch, run)


def check_kernels(torch, tk, tref, ops, build, name, p, prep, lb, ub, timed, plain_trials=5):
    """Each kernel of the instance's branch against its plain version on the
    card, on the tiles of ``prep`` and the padded bounds ``lb``/``ub``;
    ``timed`` also times both (the plain version over ``plain_trials``).
    Returns {kernel: row of measurements}."""
    from repro_torch.core import carry as rt_carry

    d = prep.d
    n_pad, cfg = prep.n_pad, ops.DEFAULT_CONFIG
    nnz = int((d.val != 0).sum().item())  # real nonzeros in the tiles
    flops = F64_FLOPS if d.val.dtype == torch.float64 else F32_FLOPS
    rows = {}

    def row(kname, got, want, fn_k, fn_p, moved=None, reset=None):
        r = dict(instance=name, max_abs_err=max_abs_err(torch, got, want))
        if timed:
            moved = moved or needed_bytes(kname, prep, nnz)
            b_ms, b_by = bound(sum(moved.values()), OPS_PER_NNZ[kname] * nnz, flops)
            r.update(ms=kernel_ms(torch, build, fn_k, reset=reset),
                     wrapper_ms=time_ms(torch, fn_k),
                     plain_ms=time_ms(torch, fn_p, trials=plain_trials), bound_ms=b_ms,
                     bound_by=b_by, bytes=moved)
            if kname in STOPPED:
                r["bound_all_slots_ms"] = bound(sum(padded_val_bytes(moved, prep).values()),
                                                OPS_PER_NNZ[kname] * nnz, flops)[0]
        rows[kname] = r

    # The accumulator planes of D and E, kept as the round closure keeps
    # them: at the sentinels before each timed launch, as F leaves them (the
    # wrapper's time is taken over back-to-back calls into the same planes).
    acc = tk.accumulator_planes(lb)
    sentinels = lambda: (acc[0].fill_(-cfg.inf), acc[1].fill_(cfg.inf))
    clean = lambda what: planes_clean(torch, acc, cfg.inf, f"{name}: {what}")
    k = d.val.shape[-1]
    if prep.fits_one_chunk:
        args = (d.val, d.col, prep.ii_g, prep.lhs_g, prep.rhs_g, lb, ub, n_pad, cfg.int_eps)
        # The lengths and the longest chunk hoisted at prepare time: where
        # no chunk holds more than 16 slots, several chunks share a warp.
        hoisted = dict(chunk_len=prep.chunk_len, max_chunk_len=prep.max_chunk_len)
        want = tref.fused_scatter_round_tiles_ref(*args)
        got = tk.fused_scatter_round_tiles(*args, acc=acc, **hoisted)
        # Fresh planes and the lengths computed by the wrapper; and a warp
        # with four strides per chunk whatever the chunks hold (no packing).
        max_abs_err(torch, tk.fused_scatter_round_tiles(*args), want)
        max_abs_err(torch, tk.fused_scatter_round_tiles(*args, chunk_len=prep.chunk_len,
                                                        max_chunk_len=k), want)
        row("fused_scatter_round_tiles", got, want,
            lambda: tk.fused_scatter_round_tiles(*args, acc=acc, **hoisted),
            lambda: tref.fused_scatter_round_tiles_ref(*args), reset=sentinels)
        rows["fused_scatter_round_tiles"].update(
            lanes=lanes_per_chunk(min(prep.max_chunk_len, k)), max_chunk_len=prep.max_chunk_len)
        best_l, best_u = want
    else:
        # Each chunk's length as the engine hoists it (prepare time).
        clen = dict(chunk_len=prep.chunk_len)
        a_args = (d.val, d.col, lb, ub, n_pad)
        got = tk.activities_gather_tiles(*a_args, **clen)
        want = tref.activities_gather_tiles_ref(*a_args)
        row("activities_gather_tiles", got, want,
            lambda: tk.activities_gather_tiles(*a_args, **clen),
            lambda: tref.activities_gather_tiles_ref(*a_args))
        c_args = (*want, d.chunk_row, prep.row_start)
        cls = dict(classes=prep.seg_classes)  # the split hoisted at prepare time
        got = tk.combine_chunk_partials_tiles(*c_args, **cls)
        aggs = tref.combine_chunk_partials_ref(*c_args)
        row("combine_chunk_partials_tiles", got, aggs,
            lambda: tk.combine_chunk_partials_tiles(*c_args, **cls),
            lambda: tref.combine_chunk_partials_ref(*c_args))
        if timed:
            rows["combine_chunk_partials_tiles"]["segment_reduce_ms"] = segment_reduce_ms(
                torch, want, d.chunk_row, prep.row_start)
        e_args = (d.val, d.col, prep.ii_g, *aggs, prep.lhs_g, prep.rhs_g, lb, ub, n_pad,
                  cfg.int_eps)
        want = tref.candidates_scatter_tiles_ref(*e_args)
        got = tk.candidates_scatter_tiles(*e_args, **clen, acc=acc)
        max_abs_err(torch, tk.candidates_scatter_tiles(*e_args, **clen), want)  # fresh planes
        row("candidates_scatter_tiles", got, want,
            lambda: tk.candidates_scatter_tiles(*e_args, **clen, acc=acc),
            lambda: tref.candidates_scatter_tiles_ref(*e_args), reset=sentinels)
        best_l, best_u = want

    eps, outward = cfg.eps_for(lb.dtype), cfg.outward_for(lb.dtype)
    want = ops.bnd.apply_updates(lb, ub, best_l, best_u, eps, cfg.inf, outward)
    # F hands the planes it reads back at the sentinels: here the kept
    # planes that the scatter filled (and the timing left full).  It folds
    # its flag into a loop carry, kept as the round closure keeps it: the
    # first round of a check group of two, so the carry's GO stays set and
    # every timed launch merges.
    acc[0].copy_(best_l)
    acc[1].copy_(best_u)
    carry = rt_carry.armed_state(lb.device)
    armed = carry.clone()
    got = tk.apply_updates_tiles(lb.clone(), ub.clone(), *acc, eps, cfg.inf, outward, carry=carry,
                                 k=0, unroll=2)
    clean("F did not hand its planes back")
    changed = bool(want[2])
    if carry.tolist()[:5] != [0, int(changed), 0, 1, 0]:
        fail(f"{name}: F left the carry at {carry.tolist()}")
    # Kernel time on scratch copies restored before each launch; the
    # wrapper's time on repeated calls, where nothing tightens and no
    # accumulator entry is handed back after the first.
    lbw, ubw = lb.clone(), ub.clone()
    row("apply_updates_tiles", got[:2], want[:2],
        lambda: tk.apply_updates_tiles(lbw, ubw, *acc, eps, cfg.inf, outward, carry=carry, k=0,
                                       unroll=2),
        lambda: ops.bnd.apply_updates(lb, ub, best_l, best_u, eps, cfg.inf, outward),
        moved=dict(merge_bytes(torch, ops.bnd, lb, ub, best_l, best_u, eps, inf=cfg.inf),
                   carry=4 * 5),
        reset=fresh_inputs(torch, [(lbw, lb), (ubw, ub), (acc[0], best_l), (acc[1], best_u),
                                   (carry, armed)]))
    return rows


def lanes_per_chunk(max_len: int) -> int:
    """Kernel D's lanes per chunk for chunks of at most ``max_len`` slots:
    ``max_len`` rounded up to a power of two, at most a warp."""
    g = 1
    while g < max_len and g < 32:
        g *= 2
    return g


def planes_clean(torch, acc, inf: float, what: str) -> None:
    """Fail unless every entry of the accumulator planes ``acc`` holds its
    sentinel (``-inf`` / ``inf``)."""
    if not (bool((acc[0] == -inf).all()) and bool((acc[1] == inf).all())):
        fail(what)


def check_same(rt, name, got, want, bitwise, what):
    for f in ("rounds", "converged", "infeasible"):
        if getattr(got, f).item() != getattr(want, f).item():
            fail(f"{name}: {f} {getattr(got, f).item()} != {what} {getattr(want, f).item()}")
    if bitwise:
        import torch

        if not (torch.equal(got.lb, want.lb) and torch.equal(got.ub, want.ub)):
            fail(f"{name}: bounds differ bitwise from {what}")
    elif not rt.bounds_equal(got.lb, got.ub, want.lb, want.ub):
        fail(f"{name}: bounds not bounds_equal to {what}")


def require_launched(per_run: dict, need: dict) -> None:
    """Fail unless each run launched each kernel it must."""
    for run, kernels in need.items():
        for k in kernels:
            if per_run[run][k] <= 0:
                fail(f"main path {run} never launched {k}: {per_run[run]}")


def smoke(torch, dev):
    import numpy as np

    import repro_torch as rt
    import repro_torch.data as td
    from repro_torch.kernels import _build, ops, prop_round as tk, ref as tref

    t0 = time.perf_counter()
    _build.lib()
    info = _build.build_info
    log(f"build: {time.perf_counter() - t0:.1f} s (nvcc {info.get('seconds', 0.0):.1f} s, "
        f"cached={info.get('cached')}) -> {_build.build_path()}")
    for line in info.get("log", "").splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            log("  ptxas:", line.strip())

    problems, preps = {}, {}
    for name, gen, kw in SPECS:
        t = time.perf_counter()
        p = getattr(td, gen)(**kw)
        t_gen = time.perf_counter() - t
        t = time.perf_counter()
        prep = rt.prepare_block_ell(p, device=dev)
        torch.cuda.synchronize()
        t_prep = time.perf_counter() - t
        problems[name], preps[name] = p, prep
        log(f"instance {name}: m={p.m} n={p.n} nnz={p.nnz} "
            f"max_row={int(np.diff(p.csr.row_ptr).max())} tiles={tuple(prep.d.val.shape)} "
            f"n_pad={prep.n_pad} fits_one_chunk={prep.fits_one_chunk} "
            f"generate={t_gen:.1f}s prepare={t_prep:.2f}s")

    # Phase 1: kernel vs plain version on the card, at the main path's shapes
    # and initial bounds, timed.
    measured = {}
    for name in problems:
        prep = preps[name]
        rows = check_kernels(torch, tk, tref, ops, _build, name, problems[name], prep,
                             prep.lb0, prep.ub0, timed=True)
        for kname, r in rows.items():
            extra = ""
            if kname in STOPPED:
                extra = f" bound_all_slots_ms={r['bound_all_slots_ms']:.4f}"
            if (kname, name) in BEFORE_REDESIGN_MS:
                extra += f" (before the redesign: {BEFORE_REDESIGN_MS[kname, name]:.4f} ms)"
            if "lanes" in r:
                extra += f" lanes_per_chunk={r['lanes']} (longest chunk {r['max_chunk_len']})"
            log(f"kernel {kname} on {name}: max_abs_err={r['max_abs_err']} ms={r['ms']:.4f} "
                f"wrapper_ms={r['wrapper_ms']:.4f} plain_ms={r['plain_ms']:.4f} "
                f"bound_ms={r['bound_ms']:.4f} "
                f"({r['bound_by']}, {sum(r['bytes'].values())} B: {r['bytes']}){extra}")
            measured.setdefault(kname, {})[name] = r

    # Phase 2: the main path, with every launch counter at zero before it.
    tk.reset_launch_counts()
    results, syncs, per_instance = {}, {}, {}
    for name, p in problems.items():
        before = tk.launch_counts()
        n_sync = [0]
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = rt.propagate_block_ell(
            p, device=dev, on_sync=lambda: n_sync.__setitem__(0, n_sync[0] + 1)
        )
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        after = tk.launch_counts()
        per_instance[name] = {k: after[k] - before[k] for k in after}
        results[name], syncs[name] = r, n_sync[0]
        log(f"main path {name}: rounds={r.rounds.item()} (reference {REFERENCE_ROUNDS[name]}) "
            f"converged={r.converged.item()} infeasible={r.infeasible.item()} "
            f"host_syncs={n_sync[0]} wall_s={wall:.4f} launches={per_instance[name]}")
    need = {
        "pb": ("fused_scatter_round_tiles", "apply_updates_tiles"),
        "banded": ("fused_scatter_round_tiles", "apply_updates_tiles"),
        "mixed": ("activities_gather_tiles", "combine_chunk_partials_tiles",
                  "candidates_scatter_tiles", "apply_updates_tiles"),
    }
    require_launched(per_instance, need)
    if results["pb"].rounds.item() != REFERENCE_ROUNDS["pb"] or not results["pb"].infeasible.item():
        fail("pb must take 33 rounds and end infeasible")

    # Phase 3: each kernel again at the main path's final bounds (general
    # floats on banded and mixed, magnitudes up to 1e20 on pb), then the same
    # instances through the plain versions and the plain-PyTorch propagate.
    for name, p in problems.items():
        prep = preps[name]
        lb_f, ub_f = prep.pad_bounds(results[name].lb, results[name].ub)
        for kname, r in check_kernels(torch, tk, tref, ops, _build, name, p, prep, lb_f, ub_f,
                                      timed=True).items():
            log(f"kernel {kname} on {name} at the final bounds: max_abs_err={r['max_abs_err']} "
                f"ms={r['ms']:.4f} wrapper_ms={r['wrapper_ms']:.4f} plain_ms={r['plain_ms']:.4f}")
        # The round closure's kept planes after each of its first rounds: F
        # (after D, or A', the combine and E) hands every entry back.
        round_fn = ops.round_fn_for(prep)
        lbr, ubr = prep.lb0.clone(), prep.ub0.clone()
        for i in range(3):
            lbr, ubr, _ = round_fn(lbr, ubr)
            planes_clean(torch, round_fn.kept.planes, ops.DEFAULT_CONFIG.inf,
                         f"{name}: the closure's planes are not clean after round {i + 1}")
        plain = rt.propagate_block_ell(p, use_kernels=False, device=dev)
        # Same tiles and summation order, long rows included: bitwise.
        check_same(rt, name, results[name], plain, True, "the plain-version path")
        again = rt.propagate_block_ell(p, device=dev)
        check_same(rt, name, results[name], again, True, "a second run of the kernel path")
        pure = rt.propagate(p, device=dev)
        check_same(rt, name, results[name], pure, False, "plain-PyTorch propagate")
        exact = torch.equal(results[name].lb, plain.lb) and torch.equal(results[name].ub, plain.ub)
        diff = [(getattr(results[name], f) != getattr(pure, f)).sum().item() for f in ("lb", "ub")]
        log(f"compare {name}: matches plain path (bitwise: {exact}) and propagate (bounds_equal; "
            f"entries not bitwise equal: lb {diff[0]}, ub {diff[1]})")

    # pb is exact arithmetic only while its bounds stay small: nearly every
    # variable's domain crosses within a few rounds and the crossed bounds
    # then grow geometrically, past 2**53 before round 33.  Bounds only
    # tighten, so no bound of the first PB_EXACT_ROUNDS rounds exceeds the
    # largest finite magnitude at their end or start; a round's sums and
    # candidates stay below (max_row + 1) times that, and are exact while it
    # is under 2**53.  There the independent propagate must agree bitwise.
    p = problems["pb"]
    cap = rt.core.PropagatorConfig(max_rounds=PB_EXACT_ROUNDS)
    capped = rt.propagate_block_ell(p, cap, device=dev)
    seen = torch.cat([capped.lb, capped.ub, preps["pb"].lb0, preps["pb"].ub0]).abs()
    big = seen[seen < cap.inf].max().item()
    max_row = int(np.diff(p.csr.row_ptr).max())
    if (max_row + 1) * big >= 2.0**53:
        fail(f"pb capped at {PB_EXACT_ROUNDS} rounds reached |bound| {big}: sums not exact")
    check_same(rt, "pb capped", capped, rt.propagate(p, cap, device=dev), True,
               "plain-PyTorch propagate")
    log(f"compare pb over {PB_EXACT_ROUNDS} rounds (max |bound| {big:.4g}, exact sums): "
        f"bitwise equal to propagate")

    # One warm-started branch-and-bound node on pb, through the cached tiles.
    p = problems["pb"]
    rng = np.random.default_rng(1)
    ub0 = np.array(p.ub)
    ub0[rng.choice(p.n, size=p.n // 20, replace=False)] = 0.0
    hits = ops.cache_info()["prepare_block_ell"]["hits"]
    node = rt.propagate_block_ell(p, lb0=p.lb, ub0=ub0, device=dev)
    if ops.cache_info()["prepare_block_ell"]["hits"] != hits + 1:
        fail("the warm-started node did not reuse the prepared tiles")
    node_plain = rt.propagate_block_ell(p, lb0=p.lb, ub0=ub0, use_kernels=False, device=dev)
    check_same(rt, "pb node", node, node_plain, True, "the plain-version path")
    log(f"node pb: rounds={node.rounds.item()} infeasible={node.infeasible.item()} "
        "(matches plain path)")

    # Phase 4: per-round times of the whole fixed point, kernels vs plain
    # (CUDA events bracket each fixed point, host syncs included), and one
    # profiled fixed point for the card's busy time and idle share.
    for name, p in problems.items():
        rounds = results[name].rounds.item()
        k_ms = time_ms(torch, lambda: rt.propagate_block_ell(p, device=dev), reps=1, trials=3)
        p_ms = time_ms(
            torch, lambda: rt.propagate_block_ell(p, use_kernels=False, device=dev),
            reps=1, trials=3,
        )
        log(f"round time {name}: kernels {k_ms / rounds:.4f} ms/round, plain {p_ms / rounds:.4f} "
            f"ms/round, fixed point {k_ms:.3f} ms vs {p_ms:.3f} ms, {rounds} rounds, "
            f"{syncs[name]} host syncs")
        prof = busy_profile(torch, lambda: rt.propagate_block_ell(p, device=dev))
        if prof is None:
            log(f"profile {name}: the profiler recorded no device time; idle share not measured")
            continue
        busy, top = prof
        log(f"profile {name}: device busy {busy:.3f} ms of {k_ms:.3f} ms fixed point, "
            f"idle share {1 - busy / k_ms:.3f}; top: {top}")

    # Phases 5-7: the node engine and the solver, at the solver's tile width.
    t = time.perf_counter()
    pbf = td.make_pseudo_boolean(**PBF)
    prep8 = rt.prepare_block_ell(pbf, tile_width=SOLVER_TILE_WIDTH, device=dev)
    torch.cuda.synchronize()
    log(f"instance pbf: m={pbf.m} n={pbf.n} nnz={pbf.nnz} "
        f"max_row={int(np.diff(pbf.csr.row_ptr).max())} tiles={tuple(prep8.d.val.shape)} "
        f"n_pad={prep8.n_pad} fits_one_chunk={prep8.fits_one_chunk} "
        f"set-up={time.perf_counter() - t:.1f}s")
    for k, rows in node_kernel_phase(torch, np, rt, tk, tref, ops, _build, pbf, prep8, dev).items():
        measured.setdefault(k, {}).update(rows)
    for k, rows in node_multichunk_phase(torch, np, rt, tk, tref, ops, _build, pbf, dev).items():
        measured.setdefault(k, {}).update(rows)
    for k, rows in combine_shapes_phase(torch, np, td, tk, tref, ops, _build, preps["mixed"],
                                        dev).items():
        measured.setdefault(k, {}).update(rows)
    runs = {f"propagate_block_ell {k}": v for k, v in per_instance.items()}
    runs.update(node_batch_phase(torch, np, rt, tk, pbf, problems, dev))
    runs.update(solve_phase(torch, np, rt, td, tk, pbf, dev))
    wide_runs, wide, wide_results = wide_phase(torch, np, rt, td, tk, tref, ops, _build, dev,
                                               measured)
    runs.update(wide_runs)
    runs.update(segment_phase(torch, rt, tk, tref, ops, _build, dev, measured, problems, preps,
                              results, wide["bandw"], wide_results["bandw"]))
    batch_runs, batch_pops = batch_phase(torch, np, rt, td, tk, tref, ops, _build, dev, measured,
                                         {**problems, "pbf": pbf, **wide})
    runs.update(batch_runs)
    service_runs, stream = service_phase(torch, np, rt, td, tk, dev)
    runs.update(service_runs)
    runs.update(drivers_phase(torch, np, rt, tk, tref, ops, dev, problems, preps, wide))
    tier_rows, tier_launches, tier_probs = precision_phase(torch, np, rt, td, tk, tref, ops,
                                                           _build, dev, problems, preps, results,
                                                           pbf, measured)
    batch_tier_rows, batch_tier_launches = batch_tiers_phase(
        torch, np, rt, tk, tref, ops, _build, dev, batch_pops, pbf, prep8, tier_probs, results,
        measured)
    engine_tier_rows, engine_tier_launches = engine_tiers_phase(
        torch, np, rt, tk, tref, ops, _build, dev, problems, tier_probs, wide, wide_results,
        batch_pops, measured)
    telemetry_rows, telemetry_runs, telemetry_launches = telemetry_phase(
        torch, np, rt, tk, tref, _build, dev, problems, wide, batch_pops, pbf, stream)
    runs.update(telemetry_runs)
    sharded_phase(torch, np, rt, dev, problems, results, batch_pops, pbf)
    slab_path = ("batched_slab_partials_tiles", "straddle_combine_tiles",
                 "batched_slab_round_tiles", "apply_updates_slab_tiles")
    node_slab_path = ("node_slab_partials_tiles", "straddle_combine_tiles",
                      "node_slab_round_tiles", "apply_updates_slab_tiles")
    require_launched(runs, {
        "propagate_block_ell bandw": slab_path,
        "propagate_block_ell pbw": slab_path,
        "nodes pbw": node_slab_path,
        "solve pbw": node_slab_path + ("node_objective_tiles",),
    })
    fused_batch = ("batched_fused_scatter_round_tiles", "apply_updates_batch_tiles")
    multi_batch = ("activities_gather_tiles", "combine_chunk_partials_tiles",
                   "candidates_scatter_tiles", "apply_updates_batch_tiles")
    require_launched(runs, {
        "batch fused": fused_batch,
        "batch multi-chunk": multi_batch,
        "batch partitioned": slab_path,
        "service stream": fused_batch,
        "service mixed": multi_batch,
    })
    node_multi = ("node_activities_gather_tiles", "node_combine_chunk_partials_tiles",
                  "node_candidates_scatter_tiles", "apply_updates_batch_tiles")
    require_launched(runs, {
        "nodes pbf": ("node_fused_scatter_round_tiles", "apply_updates_batch_tiles"),
        "nodes banded": ("node_fused_scatter_round_tiles", "apply_updates_batch_tiles"),
        "nodes mixed": node_multi,
        "solve pbf": ("node_fused_scatter_round_tiles", "apply_updates_batch_tiles",
                      "node_objective_tiles"),
        "solve pbf multi-chunk": node_multi + ("node_objective_tiles",),
    })
    launches = {fn.__name__: sum(r[fn.__name__] for r in runs.values()) for fn in tk.KERNELS}
    if any(v <= 0 for v in launches.values()):
        fail(f"a kernel of the main path was never launched: {launches}")
    log(f"launches per main-path run: {json.dumps(runs)}")

    primary = {
        "fused_scatter_round_tiles": "pb", "apply_updates_tiles": "pb",
        "activities_gather_tiles": "mixed", "candidates_scatter_tiles": "mixed",
        "combine_chunk_partials_tiles": "mixed",
        "node_fused_scatter_round_tiles": f"pbf pool, 8 of {POOL} active",
        "apply_updates_batch_tiles": f"pbf pool, 8 of {POOL} active",
        "node_objective_tiles": f"pbf pool, {POOL} rows",
        "batched_slab_partials_tiles": "pbw",
        "batched_slab_round_tiles": "pbw",
        "node_slab_partials_tiles": f"pbw pool, 8 of {POOL} active",
        "node_slab_round_tiles": f"pbw pool, 8 of {POOL} active",
        "apply_updates_slab_tiles": f"pbw pool, 8 of {POOL} active",
        "batched_fused_scatter_round_tiles": "fused bucket, 4 of 4 active",
        "fused_round_tiles": "pb", "activities_tiles": "mixed", "candidates_tiles": "mixed",
        "node_activities_gather_tiles": f"pbf K={MULTI_CHUNK_TILE_WIDTH} pool, 8 of {POOL} active",
        "node_combine_chunk_partials_tiles":
            f"pbf K={MULTI_CHUNK_TILE_WIDTH} pool, 8 of {POOL} active",
        "node_candidates_scatter_tiles":
            f"pbf K={MULTI_CHUNK_TILE_WIDTH} pool, 8 of {POOL} active",
        "straddle_combine_tiles": f"pbw pool, 8 of {POOL} active",
    }
    for key, (r, inst) in telemetry_rows.items():
        if "[" not in key:
            measured.setdefault(key, {})[inst] = r
            primary[key] = inst
    kernels = []
    for fn in tk.KERNELS:
        k = fn.__name__
        r = measured[k][primary[k]]
        source = (TELEMETRY_SOURCE if k.startswith("record_round")
                  else SLAB_SOURCE if "slab" in k else SOURCE)
        kernels.append(dict(
            name=k, route="cuda", source=source,
            replaces=REPLACES[k],
            launches=launches[k],
            max_abs_err=max(v["max_abs_err"] for v in measured[k].values()),
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=None, instance=primary[k],
            wrapper_ms=r["wrapper_ms"], bytes=r["bytes"],
            **{key: r[key] for key in ("segment_reduce_ms", "bound_all_slots_ms") if key in r},
        ))
    for key, (r, inst) in tier_rows.items():
        base = key.split("[")[0]
        kernels.append(dict(
            name=key, route="cuda", source=TIER_SOURCE, replaces=REPLACES[base],
            launches=tier_launches[key], max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=None, instance=inst, wrapper_ms=r["wrapper_ms"], bytes=r["bytes"],
            float64_ms=r.get("float64_ms"),
        ))
    for key, (r, inst) in batch_tier_rows.items():
        base = key.split("[")[0]
        kernels.append(dict(
            name=key, route="cuda", source=BATCH_TIER_SOURCE, replaces=REPLACES[base],
            launches=batch_tier_launches[key], max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=None, instance=inst, wrapper_ms=r["wrapper_ms"], bytes=r["bytes"],
            float64_ms=r.get("float64_ms"),
        ))
    for key, (r, inst) in engine_tier_rows.items():
        base = key.split("[")[0]
        kernels.append(dict(
            name=key, route="cuda",
            source=TIER_SOURCE if base in ("activities_tiles", "candidates_tiles",
                                           "fused_round_tiles") else SLAB_TIER_SOURCE,
            replaces=REPLACES[base], launches=engine_tier_launches[key],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=None, instance=inst,
            wrapper_ms=r["wrapper_ms"], bytes=r["bytes"], float64_ms=r.get("float64_ms"),
        ))
    for key, (r, inst) in telemetry_rows.items():
        if "[" in key:
            kernels.append(dict(
                name=key, route="cuda", source=TELEMETRY_SOURCE,
                replaces=REPLACES[key.split("[")[0]], launches=telemetry_launches[key],
                max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
                bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=None, instance=inst,
                wrapper_ms=r["wrapper_ms"], bytes=r["bytes"], float64_ms=r.get("float64_ms"),
            ))
    log(json.dumps({"kernels": kernels}))


def busy_profile(torch, fn, count=None):
    """``(device busy ms, the four largest items)`` of one profiled call of
    ``fn``, or None when the profiler recorded no device item.  With
    ``count`` (a substring of kernel names, or several) the top list ends
    with the number and time of the items whose names hold each."""
    items = device_items(torch, fn)
    if not items:
        return None
    by_name = {}
    for item, us in items:
        key = item.replace("(anonymous namespace)::", "").split("(")[0][:48]
        total, n = by_name.get(key, (0.0, 0))
        by_name[key] = (total + us, n + 1)
    busy = sum(total for total, _ in by_name.values()) / 1e3
    top = ", ".join(
        f"{key} {total / 1e3:.3f} ms x{n}"
        for key, (total, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:4]
    )
    for name in (count,) if isinstance(count, str) else count or ():
        hits = [us for item, us in items if name in item]
        top += f"; items named *{name}*: {len(hits)}, {sum(hits) / 1e3:.3f} ms"
    return busy, top


def objective(np, n: int):
    """The solver tests' objective: c_j = (j + 1), negated where j % 3 == 0."""
    return np.arange(1, n + 1, dtype=np.float64) * np.where(np.arange(n) % 3 == 0, -1.0, 1.0)


def node_pool(np, rt, p, cap: int, seed: int):
    """``cap`` warm-started node bound rows (host arrays): the root bounds
    with one to six random branchings each."""
    rng = np.random.default_rng(seed)
    ints = np.flatnonzero(p.is_int)
    lbs, ubs = [], []
    for i in range(cap):
        lb, ub = np.array(p.lb, np.float64), np.array(p.ub, np.float64)
        for var in rng.choice(ints, size=1 + i % 6, replace=False):
            down, up = rt.core.branch_children(lb, ub, int(var), lb[var])
            lb, ub = down if rng.random() < 0.5 else up
        lbs.append(lb)
        ubs.append(ub)
    return np.stack(lbs), np.stack(ubs)


def node_kernel_phase(torch, np, rt, tk, tref, ops, build, pbf, prep, dev):
    """Phase 5: kernels #10, #9 and #16 against their plain versions on the
    pbf tiles and a (POOL, n_pad) pool of warm-started node bounds, with 0, 8
    and POOL active rows; every active row of #10 also against kernel D on
    that node's bounds.  Returns {kernel: {shape: row of measurements}}."""
    cfg = ops.DEFAULT_CONFIG
    d, n_pad, n = prep.d, prep.n_pad, prep.n
    lb_h, ub_h = node_pool(np, rt, pbf, POOL, seed=3)
    lbp, ubp = ops._node_planes(prep, lb_h, ub_h)
    t, r, k = d.val.shape
    nnz = int((d.val != 0).sum().item())
    tiles = 8 * t * r * k + 8 * nnz + 16 * t * r  # val per slot, col+is_int per nnz, sides
    eps = cfg.eps_for(lbp.dtype)
    out = {"node_fused_scatter_round_tiles": {}, "apply_updates_batch_tiles": {},
           "node_objective_tiles": {}}

    def measure(kname, shape, got, want, fn_k, fn_p, moved, n_ops, plain_reps, reset=None,
                all_slots=None, kept=False):
        b_ms, b_by = bound(sum(moved.values()), n_ops)
        row = dict(max_abs_err=max_abs_err(torch, got, want),
                   ms=kernel_ms(torch, build, fn_k, reset=reset),
                   wrapper_ms=call_ms(torch, fn_k, reset) if kept else time_ms(torch, fn_k),
                   plain_ms=time_ms(torch, fn_p, reps=plain_reps, trials=3),
                   bound_ms=b_ms, bound_by=b_by, bytes=moved)
        extra = ""
        if all_slots is not None:
            row["bound_all_slots_ms"] = bound(sum(all_slots.values()), n_ops)[0]
            extra = f" bound_all_slots_ms={row['bound_all_slots_ms']:.4f}"
        out[kname][shape] = row
        log(f"kernel {kname} on {shape}: max_abs_err={row['max_abs_err']} ms={row['ms']:.4f} "
            f"wrapper_ms={row['wrapper_ms']:.4f} plain_ms={row['plain_ms']:.4f} "
            f"bound_ms={b_ms:.4f} ({b_by}, {sum(moved.values())} B: {moved}){extra}")

    # The accumulator planes of #10, kept across the launches as the engine
    # keeps them across rounds: at the sentinels before each timed launch.
    acc = tk.accumulator_planes(lbp)
    sentinels = lambda: (acc[0].fill_(-cfg.inf), acc[1].fill_(cfg.inf))
    for n_act in (0, 8, POOL):
        act = torch.zeros(POOL, dtype=torch.bool, device=dev)
        if n_act:
            act[:: POOL // n_act] = True
        shape = f"pbf pool, {n_act} of {POOL} active"
        args = (d.val, d.col, prep.ii_g, prep.lhs_g, prep.rhs_g, lbp, ubp, act, n_pad,
                cfg.int_eps)
        kw = dict(acc=acc, chunk_len=prep.chunk_len, max_chunk_len=prep.max_chunk_len)
        sentinels()
        got = tuple(x.clone() for x in tk.node_fused_scatter_round_tiles(*args, **kw))
        want = tref.node_fused_scatter_round_ref(*args[:7], n_pad, cfg.int_eps, active=act)
        for i in act.nonzero().flatten().tolist():
            one = tk.fused_scatter_round_tiles(d.val, d.col, prep.ii_g, prep.lhs_g, prep.rhs_g,
                                               lbp[i], ubp[i], n_pad, cfg.int_eps)
            max_abs_err(torch, (got[0][i], got[1][i]), one)
        # The tile stream is 18 MB: it stays in the 50 MB L2 across the
        # nodes, so it counts once per launch, with val at the nonzeros (each
        # chunk stops at its length, 4 B per chunk) or, for the all-slot
        # bound, at every slot; each active node reads its two bound rows
        # and writes its two accumulator rows.
        node_rows = dict(bounds=16 * n_act * n_pad, out=16 * n_act * n_pad)
        moved = dict(tiles=(16 * nnz + 20 * t * r) if n_act else 0, **node_rows)
        measure("node_fused_scatter_round_tiles", shape, got, want,
                lambda: tk.node_fused_scatter_round_tiles(*args, **kw),
                lambda: tref.node_fused_scatter_round_ref(*args[:7], n_pad, cfg.int_eps,
                                                          active=act),
                moved, 16 * nnz * n_act, 1, reset=sentinels,
                all_slots=dict(tiles=tiles if n_act else 0, **node_rows), kept=True)

        best_l, best_u = want
        want_m = ops.bnd.apply_updates_batch(lbp, ubp, best_l, best_u, eps, active=act)
        handed = (best_l.clone(), best_u.clone())
        got_m = tk.apply_updates_batch_tiles(lbp.clone(), ubp.clone(), *handed, act, eps)
        # #9 hands the active rows back at the sentinels and leaves the
        # others as they were.
        planes_clean(torch, (handed[0][act], handed[1][act]), cfg.inf,
                     f"#9 on {shape} did not hand the active rows back")
        if not (torch.equal(handed[0][~act], best_l[~act])
                and torch.equal(handed[1][~act], best_u[~act])):
            fail(f"#9 on {shape} wrote an inactive row")
        # In place on scratch planes and candidates (the merge hands the
        # active rows back at the sentinels), restored before each timed
        # launch; the mask is read and the per-row flags written.
        lbw, ubw, blw, buw = lbp.clone(), ubp.clone(), best_l.clone(), best_u.clone()
        measure("apply_updates_batch_tiles", shape, got_m, want_m,
                lambda: tk.apply_updates_batch_tiles(lbw, ubw, blw, buw, act, eps),
                lambda: ops.bnd.apply_updates_batch(lbp, ubp, best_l, best_u, eps, active=act),
                dict(merge_bytes(torch, ops.bnd, lbp, ubp, best_l, best_u, eps, act, cfg.inf),
                     flags=2 * POOL),
                6 * n_act * n_pad, 10,
                reset=fresh_inputs(torch, [(lbw, lbp), (ubw, ubp), (blw, best_l),
                                           (buw, best_u)]))

    valid = torch.arange(n_pad, device=dev) < n
    ii = torch.zeros(n_pad, dtype=torch.bool, device=dev)
    ii[:n] = d.is_int
    c_pad = torch.zeros(n_pad, dtype=torch.float64, device=dev)
    c_pad[:n] = torch.as_tensor(objective(np, n), device=dev)
    o_args = (lbp, ubp, c_pad, ii, valid, cfg.feas_eps)
    measure("node_objective_tiles", f"pbf pool, {POOL} rows", tk.node_objective_tiles(*o_args),
            tref.node_objective_ref(*o_args), lambda: tk.node_objective_tiles(*o_args),
            lambda: tref.node_objective_ref(*o_args),
            dict(planes=16 * POOL * n_pad, shared=10 * n_pad, out=10 * POOL),
            3 * POOL * n_pad, 10)
    return out


def node_multichunk_phase(torch, np, rt, tk, tref, ops, build, pbf, dev):
    """Phase 5b: the multi-chunk node round's kernels -- A', the combine and
    E over a node batch -- against their plain versions on pbf's tiles at
    tile width MULTI_CHUNK_TILE_WIDTH (rows of 5 to 8 nonzeros span two
    chunks) and a (POOL, n_pad) pool of warm-started node bounds with 8 and
    POOL rows active: bitwise on the active nodes' planes (the kernels
    leave the partials of inactive nodes unwritten) and on every
    accumulator row; the first eight active nodes also against the
    single-instance kernels on their own rows.  Timed.  Then one node round
    over 4 and over POOL nodes, whose launches must be the same.  Returns
    {kernel: {shape: row of measurements}}."""
    cfg = ops.DEFAULT_CONFIG
    t0 = time.perf_counter()
    prep = rt.prepare_block_ell(pbf, tile_width=MULTI_CHUNK_TILE_WIDTH, device=dev)
    d, n_pad = prep.d, prep.n_pad
    t, r, k = d.val.shape
    chunks = t * r
    nnz = int((d.val != 0).sum().item())
    log(f"pbf at tile width {k}: tiles={(t, r, k)} fits_one_chunk={prep.fits_one_chunk} "
        f"prepare={time.perf_counter() - t0:.2f}s")
    lb_h, ub_h = node_pool(np, rt, pbf, POOL, seed=3)
    lbp, ubp = ops._node_planes(prep, lb_h, ub_h)
    clen = dict(chunk_len=prep.chunk_len)
    names = ("node_activities_gather_tiles", "node_combine_chunk_partials_tiles",
             "node_candidates_scatter_tiles")
    out = {name: {} for name in names}
    for n_act in (8, POOL):
        act = torch.zeros(POOL, dtype=torch.bool, device=dev)
        act[:: POOL // n_act] = True
        shape = f"pbf K={k} pool, {n_act} of {POOL} active"
        reps = 1 if n_act == POOL else 3
        on = lambda xs: tuple(x[act] for x in xs)
        a_args = (d.val, d.col, lbp, ubp, act, n_pad)
        parts = tref.node_activities_gather_ref(*a_args)
        got_p = tk.node_activities_gather_tiles(*a_args, **clen)
        out[names[0]][shape] = measured_row(
            torch, build, on(got_p), on(parts),
            lambda: tk.node_activities_gather_tiles(*a_args, **clen),
            lambda: tref.node_activities_gather_ref(*a_args),
            dict(val=8 * nnz, col=4 * nnz, chunk_len=4 * chunks, bounds=16 * n_act * n_pad,
                 out=24 * n_act * chunks),
            4 * nnz * n_act, plain_reps=reps)
        c_args = (*parts, d.chunk_row, prep.row_start, act)
        cls = dict(classes=prep.seg_classes)  # the split the engine hoists
        aggs = tref.node_combine_chunk_partials_ref(*c_args)
        got_a = tk.node_combine_chunk_partials_tiles(*c_args, **cls)
        out[names[1]][shape] = measured_row(
            torch, build, on(got_a), on(aggs),
            lambda: tk.node_combine_chunk_partials_tiles(*c_args, **cls),
            lambda: tref.node_combine_chunk_partials_ref(*c_args),
            dict(partials=24 * n_act * chunks, row_start=8 * (prep.m + 2),
                 classes=4 * (prep.m + 1), out=24 * n_act * chunks, mask=POOL),
            0, plain_reps=reps)
        e_args = (d.val, d.col, prep.ii_g, *aggs, prep.lhs_g, prep.rhs_g, lbp, ubp, act, n_pad,
                  cfg.int_eps)
        want = tref.node_candidates_scatter_ref(*e_args)
        got = tk.node_candidates_scatter_tiles(*e_args, **clen)
        out[names[2]][shape] = measured_row(
            torch, build, got, want,
            lambda: tk.node_candidates_scatter_tiles(*e_args, **clen),
            lambda: tref.node_candidates_scatter_ref(*e_args),
            dict(val=8 * nnz, col=4 * nnz, is_int=4 * nnz, chunk_len=4 * chunks,
                 sides=16 * chunks, aggregates=24 * n_act * chunks, bounds=16 * n_act * n_pad,
                 out=16 * n_act * n_pad),
            12 * nnz * n_act, plain_reps=reps)
        for i in act.nonzero().flatten().tolist()[:8]:
            one = tk.activities_gather_tiles(d.val, d.col, lbp[i], ubp[i], n_pad, **clen)
            max_abs_err(torch, tuple(x[i] for x in got_p), one)
            done = tk.combine_chunk_partials_tiles(*one, d.chunk_row, prep.row_start)
            max_abs_err(torch, tuple(x[i] for x in got_a), done)
            best = tk.candidates_scatter_tiles(d.val, d.col, prep.ii_g, *done, prep.lhs_g,
                                               prep.rhs_g, lbp[i], ubp[i], n_pad, cfg.int_eps,
                                               **clen)
            max_abs_err(torch, (got[0][i], got[1][i]), best)
        for name in names:
            out[name][shape]["instance"] = shape
            log_row(name, shape, out[name][shape])

    round_fn = ops.node_round_fn_for(prep)
    counts = {}
    for bsz in (4, POOL):
        act = torch.ones(bsz, dtype=torch.bool, device=dev)
        tk.reset_launch_counts()
        round_fn(lbp[:bsz].clone(), ubp[:bsz].clone(), act)
        torch.cuda.synchronize()
        counts[bsz] = {name: v for name, v in tk.launch_counts().items() if v}
    if counts[4] != counts[POOL]:
        fail(f"a multi-chunk node round's launches grow with the batch: {counts}")
    log(f"multi-chunk node round (tile width {k}): launches with 4 nodes {counts[4]}, with "
        f"{POOL} nodes {counts[POOL]}: the same")
    return out


def combine_shapes_phase(torch, np, td, tk, tref, ops, build, prep, dev):
    """Phase 5c: the long-row combine at the shapes of its longest rows,
    each with the segment split its engine hoists: the node form on
    ``mixed`` (``prep``, tile width 128, rows of up to 375 chunks) under 4
    node planes, as ``nodes mixed`` runs it; the flat form on the first two
    of the service's mixed requests packed at tile width 8 (rows of 3,000
    chunks; the service holds them in two slots, its padding in one-chunk
    segments).  Bitwise against the plain versions, timed, beside the
    ``torch.segment_reduce`` yardstick.  Returns {kernel: {shape: row}}."""
    out = {"combine_chunk_partials_tiles": {}, "node_combine_chunk_partials_tiles": {}}

    def measure(kname, shape, fn_k, fn_p, parts, chunk_row, row_start, planes, act=None):
        n_seg = row_start.numel() - 1
        chunks = chunk_row.numel()
        moved = dict(partials=24 * planes * chunks, row_start=8 * (n_seg + 1),
                     classes=4 * n_seg, out=24 * planes * chunks,
                     **({} if act is None else {"mask": act.numel()}))
        row = measured_row(torch, build, fn_k(), fn_p(), fn_k, fn_p, moved, 0, plain_reps=1)
        row["segment_reduce_ms"] = segment_reduce_ms(torch, parts, chunk_row, row_start, act)
        row["instance"] = shape
        longest = int((row_start[1:] - row_start[:-1]).max().item())
        log_row(kname, shape, row)
        log(f"kernel {kname} on {shape}: {n_seg} segments, longest {longest} chunks; "
            f"segment_reduce yardstick {row['segment_reduce_ms']} ms")
        out[kname][shape] = row

    d = prep.d
    bsz = 4
    act = torch.ones(bsz, dtype=torch.bool, device=dev)
    parts = tk.node_activities_gather_tiles(d.val, d.col, prep.lb0.repeat(bsz, 1),
                                            prep.ub0.repeat(bsz, 1), act, prep.n_pad,
                                            chunk_len=prep.chunk_len)
    c_args = (*parts, d.chunk_row, prep.row_start, act)
    measure("node_combine_chunk_partials_tiles", f"nodes mixed K={d.val.shape[2]}, {bsz} nodes",
            lambda: tk.node_combine_chunk_partials_tiles(*c_args, classes=prep.seg_classes),
            lambda: tref.node_combine_chunk_partials_ref(*c_args), parts, d.chunk_row,
            prep.row_start, bsz, act)

    t = time.perf_counter()
    rows = service_rows(np)[2 * SERVICE_REQUESTS:][:2]
    mixed = [td.make_mixed(m=int(m), n=30_000, seed=100 + i, density=0.0005)
             for i, m in enumerate(rows)]
    (batch,) = ops.packed_problems(mixed, tile_width=8)
    bp = ops.prepare_problem_batch(batch, device=dev)
    bd = bp.d
    width = bp.size * bp.n_pad
    parts = tk.activities_gather_tiles(bd.val, bd.col_g, bd.lb0.reshape(width),
                                       bd.ub0.reshape(width), width, chunk_len=bd.chunk_len)
    log(f"service mixed requests packed at tile width 8: tiles={tuple(bd.val.shape)}, set-up "
        f"{time.perf_counter() - t:.1f}s")
    c_args = (*parts, bd.chunk_row, bp.row_start)
    measure("combine_chunk_partials_tiles", "service mixed K=8, 2 requests",
            lambda: tk.combine_chunk_partials_tiles(*c_args, classes=bp.seg_classes),
            lambda: tref.combine_chunk_partials_ref(*c_args), parts, bd.chunk_row,
            bp.row_start, 1)
    return out


def most_fractional_order(np, lb, ub, is_int):
    """Columns by the most-fractional rule's preference (ties to the lowest
    column), unfixed integer columns first."""
    cand = np.asarray(is_int, bool) & (ub - lb > 0.5)
    mid = 0.5 * (lb + ub)
    frac = mid - np.floor(mid)
    score = np.where(cand, 0.5 - np.abs(frac - 0.5), -1.0)
    return np.argsort(-score, kind="stable")[: int(cand.sum())]


def branched(np, rt, lb, ub, cols):
    """All 2**len(cols) nodes that branch each of ``cols`` at its domain
    midpoint, down or up."""
    lbs, ubs = [], []
    for bits in range(2 ** len(cols)):
        l, u = lb.copy(), ub.copy()
        for j, v in enumerate(cols):
            down, up = rt.core.branch_children(l, u, int(v), 0.5 * (l[v] + u[v]))
            l, u = up if bits >> j & 1 else down
        lbs.append(l)
        ubs.append(u)
    return np.stack(lbs), np.stack(ubs)


def node_batch_phase(torch, np, rt, tk, pbf, problems, dev):
    """Phase 6: propagate_nodes on branched nodes of pbf (64), banded (16) and
    mixed (4, the multi-chunk branch); each node bitwise against its own
    single-instance propagate_block_ell and against the plain-version path.
    Returns the launch counts of each kernel-path run."""
    root = rt.propagate_block_ell(pbf, tile_width=SOLVER_TILE_WIDTH, device=dev)
    if root.rounds.item() != PBF_ROUNDS or root.infeasible.item():
        fail(f"pbf root: {root.rounds.item()} rounds, infeasible={root.infeasible.item()}; "
             f"the reference takes {PBF_ROUNDS} rounds and stays feasible")
    lb_r, ub_r = root.lb.cpu().numpy(), root.ub.cpu().numpy()
    sets = {"pbf": (pbf, SOLVER_TILE_WIDTH,
                    branched(np, rt, lb_r, ub_r, most_fractional_order(np, lb_r, ub_r,
                                                                       pbf.is_int)[:6]))}
    for name, count in (("banded", 4), ("mixed", 2)):
        p = problems[name]
        res = rt.propagate_block_ell(p, device=dev)
        lb, ub = res.lb.cpu().numpy(), res.ub.cpu().numpy()
        cols = np.flatnonzero((ub - lb > 1.0) & (np.abs(lb) < 1e6) & (np.abs(ub) < 1e6))[:count]
        sets[name] = (p, 128, branched(np, rt, lb, ub, cols))

    runs = {}
    for name, (p, tw, (lb, ub)) in sets.items():
        reads = [0]
        tk.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = rt.propagate_nodes(p, lb, ub, tile_width=tw, device=dev,
                                 on_sync=lambda: reads.__setitem__(0, reads[0] + 1))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        runs[f"nodes {name}"] = tk.launch_counts()
        plain = rt.propagate_nodes(p, lb, ub, tile_width=tw, device=dev, use_kernels=False)
        for f in ("lb", "ub", "rounds", "converged", "infeasible"):
            if not torch.equal(getattr(got, f), getattr(plain, f)):
                fail(f"nodes {name}: {f} differs from the plain-version path")
        if not torch.allclose(got.progress, plain.progress, rtol=0, atol=0, equal_nan=True):
            fail(f"nodes {name}: progress differs from the plain-version path")
        for i in range(lb.shape[0]):
            one = rt.propagate_block_ell(p, tile_width=tw, lb0=lb[i], ub0=ub[i], device=dev)
            if not (torch.equal(got.lb[i], one.lb) and torch.equal(got.ub[i], one.ub)):
                fail(f"nodes {name}: node {i} differs from its single-instance run")
            for f in ("rounds", "converged", "infeasible"):
                if getattr(got, f)[i].item() != getattr(one, f).item():
                    fail(f"nodes {name}: node {i} {f} differs from its single-instance run")
        rounds = int(got.rounds.max())
        k_ms = time_ms(torch, lambda: rt.propagate_nodes(p, lb, ub, tile_width=tw, device=dev),
                       reps=1, trials=3)
        p_ms = time_ms(torch, lambda: rt.propagate_nodes(p, lb, ub, tile_width=tw, device=dev,
                                                          use_kernels=False), reps=1, trials=1)
        log(f"nodes {name}: {lb.shape[0]} nodes, rounds {int(got.rounds.min())}-{rounds}, "
            f"infeasible {int(got.infeasible.sum())}, flag reads {reads[0]}, first wall "
            f"{wall * 1e3:.3f} ms; kernels {k_ms:.3f} ms ({k_ms / rounds:.4f} ms/round), plain "
            f"{p_ms:.3f} ms ({p_ms / rounds:.4f} ms/round); every node bitwise equal to its "
            f"single-instance run and to the plain path; launches {runs[f'nodes {name}']}")
    return runs


SOLVE_FIELDS = ("status", "objective", "feasible", "nodes_expanded", "nodes_created", "leaves",
                "pruned_bound", "pruned_infeasible", "levels", "host_syncs",
                "incumbent_trajectory")


def solve_phase(torch, np, rt, td, tk, pbf, dev):
    """Phase 7: solve on the small instances against the reference's results,
    and on pbf at full width against the reference's counts and the plain
    path.  Returns the launch counts of the full-width kernel-path search."""
    for gen, kw, rule, want in SOLVE_REFERENCE:
        p = getattr(td, gen)(**kw)
        res = rt.solve(p, objective(np, p.n), rule=rt.BranchRule(rule), device=dev)
        got = (res.status, res.objective, res.nodes_expanded, res.nodes_created, res.leaves,
               res.pruned_bound, res.pruned_infeasible, res.levels)
        if got != want:
            fail(f"solve {gen}{kw} {rule}: {got} != reference {want}")
    log(f"solve: the {len(SOLVE_REFERENCE)} small searches reproduce the reference's results")

    c = objective(np, pbf.n)
    reads, syncs = [0], []
    tk.reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = rt.solve(pbf, c, device=dev, on_sync=syncs.append,
                   on_flag_read=lambda: reads.__setitem__(0, reads[0] + 1), **FULL_SEARCH)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    runs = {"solve pbf": tk.launch_counts()}
    got = (res.status, res.nodes_expanded, res.nodes_created, res.levels, res.host_syncs)
    if got != FULL_REFERENCE:
        fail(f"solve pbf: {got} != reference {FULL_REFERENCE}")
    t = time.perf_counter()
    plain = rt.solve(pbf, c, device=dev, use_kernels=False, **FULL_SEARCH)
    torch.cuda.synchronize()
    p_wall = time.perf_counter() - t
    for f in SOLVE_FIELDS:
        if getattr(res, f) != getattr(plain, f):
            fail(f"solve pbf: {f} {getattr(res, f)} != plain path {getattr(plain, f)}")
    for f, x, y in zip(res.carry._fields, res.carry, plain.carry):
        if not torch.equal(x, y):
            fail(f"solve pbf: final pool {f} differs from the plain path")
    k_ms = time_ms(torch, lambda: rt.solve(pbf, c, device=dev, **FULL_SEARCH), reps=1, trials=3)
    log(f"solve pbf: {res.status}, levels {res.levels}, expanded {res.nodes_expanded}, created "
        f"{res.nodes_created}, host syncs {res.host_syncs}, flag reads {reads[0]}; kernels "
        f"{k_ms:.3f} ms ({k_ms / res.levels:.3f} ms/level, "
        f"{res.nodes_created / (k_ms / 1e3):.1f} nodes/s; first call {wall * 1e3:.3f} ms), plain "
        f"{p_wall * 1e3:.3f} ms; same result and final pool as the plain path; "
        f"launches {runs['solve pbf']}")
    prof = busy_profile(torch, lambda: rt.solve(pbf, c, device=dev, **FULL_SEARCH))
    if prof is None:
        log("profile solve pbf: the profiler recorded no device time; idle share not measured")
    else:
        busy, top = prof
        log(f"profile solve pbf: device busy {busy:.3f} ms of {k_ms:.3f} ms search, idle share "
            f"{1 - busy / k_ms:.3f}; top: {top}")

    # The same search at tile width 4, where pbf's rows of 5 to 8 nonzeros
    # span two chunks: every round runs A', the combine and E over the whole
    # pool of POOL slots, then #9 -- four launches, whatever the slots hold.
    # The data are integral, so the search and the final pool equal the
    # one-chunk search's.
    reads4 = [0]
    tk.reset_launch_counts()
    multi = rt.solve(pbf, c, device=dev, tile_width=MULTI_CHUNK_TILE_WIDTH,
                     on_flag_read=lambda: reads4.__setitem__(0, reads4[0] + 1), **FULL_SEARCH)
    torch.cuda.synchronize()
    runs["solve pbf multi-chunk"] = tk.launch_counts()
    for f in SOLVE_FIELDS:
        if getattr(multi, f) != getattr(res, f):
            fail(f"solve pbf at tile width {MULTI_CHUNK_TILE_WIDTH}: {f} {getattr(multi, f)} != "
                 f"tile width {SOLVER_TILE_WIDTH}'s {getattr(res, f)}")
    for f, x, y in zip(res.carry._fields, multi.carry, res.carry):
        if not torch.equal(x, y):
            fail(f"solve pbf at tile width {MULTI_CHUNK_TILE_WIDTH}: final pool {f} differs")
    m_ms = time_ms(torch, lambda: rt.solve(pbf, c, device=dev, tile_width=MULTI_CHUNK_TILE_WIDTH,
                                           **FULL_SEARCH), reps=1, trials=3)
    rounds = reads4[0] - multi.levels  # one flag read per round and one per level
    counts4 = runs["solve pbf multi-chunk"]
    for name in ("node_activities_gather_tiles", "node_combine_chunk_partials_tiles",
                 "node_candidates_scatter_tiles", "apply_updates_batch_tiles"):
        if counts4[name] != rounds:
            fail(f"solve pbf multi-chunk: {counts4[name]} launches of {name} in {rounds} rounds")
    if counts4["activities_gather_tiles"] or counts4["candidates_scatter_tiles"]:
        fail(f"solve pbf multi-chunk ran the single-instance round: {counts4}")
    log(f"solve pbf multi-chunk (tile width {MULTI_CHUNK_TILE_WIDTH}, {POOL} slots): "
        f"{multi.status}, levels {multi.levels}, rounds {rounds}, flag reads {reads4[0]}; "
        f"{m_ms:.3f} ms ({m_ms / multi.levels:.3f} ms/level, {m_ms / rounds:.3f} ms/round, "
        f"{m_ms / rounds / POOL:.4f} ms per slot and round, "
        f"{multi.nodes_created / (m_ms / 1e3):.1f} nodes/s; with a per-slot loop: 1808.981 ms); "
        f"{m_ms / k_ms:.2f}x the tile-width-{SOLVER_TILE_WIDTH} search; one launch of each "
        f"node kernel per round; same result and final pool as tile width "
        f"{SOLVER_TILE_WIDTH}; launches {runs['solve pbf multi-chunk']}")
    prof = busy_profile(torch, lambda: rt.solve(pbf, c, device=dev,
                                                tile_width=MULTI_CHUNK_TILE_WIDTH, **FULL_SEARCH))
    if prof is None:
        log("profile solve pbf multi-chunk: the profiler recorded no device time; idle share not "
            "measured")
    else:
        busy, top = prof
        log(f"profile solve pbf multi-chunk: device busy {busy:.3f} ms of {m_ms:.3f} ms search, "
            f"idle share {1 - busy / m_ms:.3f}; top: {top}")
    return runs

# ---------------------------------------------------------------------------
# Phase 8: past 2^16 columns (the column-slab partitioned engine)
# ---------------------------------------------------------------------------


def log_row(kname, shape, r):
    extra = ""
    if "bound_all_slots_ms" in r:
        extra = f" bound_all_slots_ms={r['bound_all_slots_ms']:.4f}"
    log(f"kernel {kname} on {shape}: max_abs_err={r['max_abs_err']} ms={r['ms']:.4f} "
        f"wrapper_ms={r['wrapper_ms']:.4f} plain_ms={r['plain_ms']:.4f} "
        f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}, {sum(r['bytes'].values())} B: "
        f"{r['bytes']}){extra}")


def measured_row(torch, build, got, want, fn_k, fn_p, moved, n_ops, plain_reps=3, reset=None,
                 launches=1, flops=F64_FLOPS):
    """Kernel against plain version (equal as values), then timed: the
    kernel's launches (CUDA events around the C entries), the wrapper call,
    the plain version; and the bound of ``moved`` bytes and ``n_ops``
    operations at the rate ``flops`` (float64's by default)."""
    b_ms, b_by = bound(sum(moved.values()), n_ops, flops)
    return dict(max_abs_err=max_abs_err(torch, got, want),
                ms=kernel_ms(torch, build, fn_k, reset=reset, launches=launches),
                wrapper_ms=time_ms(torch, fn_k, reps=3, trials=3),
                plain_ms=time_ms(torch, fn_p, reps=1, trials=plain_reps),
                bound_ms=b_ms, bound_by=b_by, bytes=moved)


def straddle_row(torch, tk, tref, build, part, partials, act, plain_reps=3):
    """The straddle combine against its plain version on the active planes
    (all of a single plane, ``act`` None) and against ``straddle_tables``
    where ``row_done == 0``, then timed.  Its bound counts the active
    planes only: the partials at the straddle positions and the
    aggregates, once each, plus the index (``a_order`` at those positions,
    ``a_seg``, ``agg_slot``) and the mask."""
    index = (part.a_order, part.a_seg, part.agg_slot)
    got = tk.straddle_combine_tiles(*partials, *index, act)
    want = tref.straddle_combine_ref(*partials, *index, act)
    tables = tref.straddle_tables(part, *partials)
    done = part.row_done == 0
    if act is None:
        on, pick, n_act, mask = (lambda x: x), (lambda x: x[done]), 1, 0
    else:
        on, pick, n_act, mask = (lambda x: x[act]), (lambda x: x[act][:, done]), int(
            act.sum()), act.numel()
    max_abs_err(torch, tuple(map(pick, got)), tuple(map(pick, tables)))
    pos = int((part.a_seg[-1] - part.a_seg[1]).item())
    chunks = part.agg_slot.numel()
    index_bytes = 8 * pos + 8 * part.a_seg.numel() + 4 * chunks
    agg = 2 * partials[0].element_size() + 8  # two sums and two int32 counts
    moved = dict(partials=agg * pos * n_act, index=index_bytes if n_act else 0,
                 out=agg * chunks * n_act, mask=mask)
    return measured_row(torch, build, tuple(map(on, got)), tuple(map(on, want)),
                        lambda: tk.straddle_combine_tiles(*partials, *index, act),
                        lambda: tref.straddle_combine_ref(*partials, *index, act), moved, 0,
                        plain_reps=plain_reps)


def stores(torch, new, old) -> int:
    """Entries a merge changed: 8 B each of the bytes it must store."""
    return int(sum((n != o).sum().item() for n, o in zip(new, old)))


def check_slab_kernels(torch, tk, tref, ops, build, name, prep, part):
    """Kernels #11, the straddle combine, #12 (with #15's merge) and #15
    alone against their plain versions on the instance's partition at its
    initial bounds, the single-instance shapes of the main path; timed.
    Returns {kernel: row}."""
    cfg = ops.DEFAULT_CONFIG
    dt = prep.lb0.dtype
    eps, outward, width = cfg.eps_for(dt), cfg.outward_for(dt), prep.n_pad
    v, flops = prep.lb0.element_size(), F64_FLOPS if dt == torch.float64 else F32_FLOPS
    act = torch.ones(1, dtype=torch.bool, device=prep.lb0.device)
    lbp, ubp = prep.lb0[None].clone(), prep.ub0[None].clone()
    rows = {}
    ta, r, k = part.a_val.shape
    a_nnz = int((part.a_val != 0).sum().item())
    a_args = (part.a_val, part.a_col_s, part.a_run_start, part.a_run_len, part.a_run_inst,
              part.a_run_slab, act, lbp, ubp, part.slab, part.a_max_run_len)
    partials = tref.batched_slab_partials_ref(*a_args)
    rows["batched_slab_partials_tiles"] = measured_row(
        torch, build, tk.batched_slab_partials_tiles(*a_args), partials,
        lambda: tk.batched_slab_partials_tiles(*a_args),
        lambda: tref.batched_slab_partials_ref(*a_args),
        dict(val=v * ta * r * k, col=4 * a_nnz, bounds=2 * v * width,
             out=(2 * v + 8) * ta * r),
        4 * a_nnz, flops=flops)
    rows["straddle_combine_tiles"] = straddle_row(torch, tk, tref, build, part, partials, None)
    strs = tref.straddle_tables(part, *partials)
    t, r, k = part.val.shape
    nnz = int((part.val != 0).sum().item())
    r_args = (part.val, part.col_s, part.ii_g, part.row_done, *strs, part.lhs_g, part.rhs_g,
              part.run_start, part.run_len, part.run_inst, part.run_slab, act)
    tail = (part.slab, part.max_run_len, eps, cfg.int_eps, cfg.inf, outward)
    want = tref.batched_slab_round_ref(*r_args, lbp, ubp, *tail)
    # The accumulator planes kept across the launches, as the round closure
    # keeps them (the merge hands them back); the tile maps and chunk
    # lengths hoisted by the partition.
    kw = dict(acc=tk.accumulator_planes(lbp), tiles=(part.tile_inst, part.tile_slab),
              chunk_len=part.chunk_len, max_chunk_len=part.max_chunk_len)
    got = tk.batched_slab_round_tiles(*r_args, lbp.clone(), ubp.clone(), *tail, **kw)
    lbw, ubw = lbp.clone(), ubp.clone()
    held = tref.batched_slab_scatter_ref(
        part.val, part.col_s, part.ii_g, part.row_done, *strs, part.lhs_g, part.rhs_g,
        part.run_start, part.run_inst, part.run_slab, act, lbp, ubp, part.slab, cfg.int_eps)
    # val at the nonzeros (each copy stops at its length, 4 B per chunk) or,
    # for the all-slot bound, at every slot; col_s and is_int_g per kept
    # nonzero; row_done, the straddle aggregates and the sides per chunk;
    # the window of each tile; the bounds; the accumulators written and read
    # once and handed back where they hold a candidate.
    common = dict(col_ii=8 * nnz, rows=(12 + 4 * v) * t * r, tiles=8 * t, bounds=2 * v * width,
                  stores=v * stores(torch, want[:2], (lbp, ubp)), accumulators=4 * v * width,
                  handback=v * int((held[0] != -cfg.inf).sum() + (held[1] != cfg.inf).sum()),
                  flags=4 * part.n_slabs)
    rows["batched_slab_round_tiles"] = measured_row(
        torch, build, got, want,
        lambda: tk.batched_slab_round_tiles(*r_args, lbw, ubw, *tail, **kw),
        lambda: tref.batched_slab_round_ref(*r_args, lbp, ubp, *tail),
        dict(val=v * nnz, chunk_len=4 * t * r, **common),
        16 * nnz, reset=fresh_inputs(torch, [(lbw, lbp), (ubw, ubp)]), launches=2, flops=flops)
    rows["batched_slab_round_tiles"]["bound_all_slots_ms"] = bound(
        v * t * r * k + sum(common.values()), 16 * nnz, flops)[0]
    # #15 alone on the single plane, the scatter's candidates as its input
    # (it hands them back at the sentinels), restored before each timed
    # launch.
    m_args = (act, part.slab, eps, cfg.inf, outward)
    want_m = tref.apply_updates_slab_ref(lbp, ubp, *held, *m_args)
    want_m = (*want_m[:2], want_m[2].any(dim=1))
    got_m = tk.apply_updates_slab_tiles(lbp.clone(), ubp.clone(), held[0].clone(),
                                        held[1].clone(), *m_args)
    lbw, ubw, blw, buw = lbp.clone(), ubp.clone(), held[0].clone(), held[1].clone()
    rows["apply_updates_slab_tiles"] = measured_row(
        torch, build, got_m, want_m,
        lambda: tk.apply_updates_slab_tiles(lbw, ubw, blw, buw, *m_args),
        lambda: tref.apply_updates_slab_ref(lbp, ubp, *held, *m_args),
        dict(merge_bytes(torch, ops.bnd, lbp, ubp, *held, eps, act, cfg.inf),
             flags=4 * part.n_slabs + 1),
        6 * width,
        reset=fresh_inputs(torch, [(lbw, lbp), (ubw, ubp), (blw, held[0]), (buw, held[1])]),
        flops=flops)
    for kname, row in rows.items():
        row["instance"] = name
        log_row(kname, name, row)
    return rows


def check_node_slab_kernels(torch, np, rt, tk, tref, ops, build, pbw, prep, part,
                            acts=(0, 8, POOL)):
    """Kernels #13, the straddle combine, #14 (with #15's merge) and #15
    alone against their plain versions on pbw's K = 8 partition over a
    (POOL, n_pad) pool of warm-started node bounds, with ``acts`` rows
    active (#13 and the straddle combine on the active planes: they leave
    the others unwritten); timed, at the prep's value type.  Returns
    {kernel: {shape: row}}."""
    cfg = ops.DEFAULT_CONFIG
    width = prep.n_pad
    lb_h, ub_h = node_pool(np, rt, pbw, POOL, seed=3)
    lbp, ubp = ops._node_planes(prep, lb_h, ub_h)
    dt = lbp.dtype
    eps, outward = cfg.eps_for(dt), cfg.outward_for(dt)
    v, flops = lbp.element_size(), F64_FLOPS if dt == torch.float64 else F32_FLOPS
    ta, r, k = part.a_val.shape
    a_nnz = int((part.a_val != 0).sum().item())
    t, _, _ = part.val.shape
    nnz = int((part.val != 0).sum().item())
    out = {"node_slab_partials_tiles": {}, "straddle_combine_tiles": {},
           "node_slab_round_tiles": {}, "apply_updates_slab_tiles": {}}
    fill = time_ms(torch, lambda: (torch.full_like(lbp, -cfg.inf), torch.full_like(ubp, cfg.inf)))
    log(f"accumulator fill #14's wrapper no longer makes per launch: two ({POOL}, {width}) "
        f"sentinel planes, {fill:.4f} ms")
    # The accumulator planes kept across the launches, as the round closure
    # keeps them (#15 hands the active rows back); the tile slabs and chunk
    # lengths hoisted by the partition.
    kw = dict(acc=tk.accumulator_planes(lbp), tile_slab=part.tile_slab,
              chunk_len=part.chunk_len, max_chunk_len=part.max_chunk_len)
    a_kw = dict(tile_slab=part.a_tile_slab, chunk_len=part.a_chunk_len,
                max_chunk_len=part.a_max_chunk_len)
    straddle_chunks = int((part.row_done == 0).sum().item())
    for n_act in acts:
        act = torch.zeros(POOL, dtype=torch.bool, device=lbp.device)
        if n_act:
            act[:: POOL // n_act] = True
        shape = f"pbw pool, {n_act} of {POOL} active"
        reps = 1 if n_act == POOL else 3
        a_args = (part.a_val, part.a_col_s, part.a_run_start, part.a_run_len, part.a_run_slab,
                  act, lbp, ubp, part.slab, part.a_max_run_len)
        partials = tref.node_slab_partials_ref(*a_args)
        on = lambda xs: tuple(x[act] for x in xs)
        # The sub-stream is read once per launch (val at the nonzeros, each
        # copy stopped at its hoisted length, col_s per nonzero, the length
        # per chunk and the slab per tile); each active node gathers its
        # bound row and writes its partials.
        sub = dict(val=v * a_nnz, col=4 * a_nnz, chunk_len=4 * ta * r, tiles=4 * ta)
        rest = dict(bounds=2 * v * n_act * width, out=(2 * v + 8) * n_act * ta * r)
        out["node_slab_partials_tiles"][shape] = row = measured_row(
            torch, build, on(tk.node_slab_partials_tiles(*a_args, **a_kw)), on(partials),
            lambda: tk.node_slab_partials_tiles(*a_args, **a_kw),
            lambda: tref.node_slab_partials_ref(*a_args),
            dict(**(sub if n_act else {}), **rest), 4 * a_nnz * n_act, plain_reps=reps,
            flops=flops)
        row["bound_all_slots_ms"] = bound(
            (v * ta * r * k + sum(sub.values()) - sub["val"] if n_act else 0)
            + sum(rest.values()), 4 * a_nnz * n_act, flops)[0]
        out["straddle_combine_tiles"][shape] = straddle_row(torch, tk, tref, build, part,
                                                            partials, act, plain_reps=reps)
        strs = tref.straddle_tables(part, *partials)
        r_args = (part.val, part.col_s, part.ii_g, part.row_done, *strs, part.lhs_g,
                  part.rhs_g, part.run_start, part.run_len, part.run_slab, act)
        tail = (part.slab, part.max_run_len, eps, cfg.int_eps, cfg.inf, outward)
        want = tref.node_slab_round_ref(*r_args, lbp, ubp, *tail)
        got = tk.node_slab_round_tiles(*r_args, lbp.clone(), ubp.clone(), *tail, **kw)
        for i in act.nonzero().flatten().tolist()[:8]:
            one = tref.batched_slab_round_ref(
                part.val, part.col_s, part.ii_g, part.row_done, *(x[i] for x in strs),
                part.lhs_g, part.rhs_g, part.run_start, part.run_len, part.run_inst,
                part.run_slab, act[i : i + 1], lbp[i : i + 1], ubp[i : i + 1], *tail)
            max_abs_err(torch, (got[0][i], got[1][i]), (one[0][0], one[1][0]))
        lbw, ubw = lbp.clone(), ubp.clone()
        # The copy stream once (val at the kept nonzeros, each copy stopped
        # at its length; col_s and is_int_g per kept nonzero; length,
        # row_done and sides per chunk); per active node the straddle
        # aggregates of the straddle chunks, the window bounds, the stores,
        # the accumulators written and read once and handed back.
        stream = dict(val=v * nnz, col_ii=8 * nnz, rows=(4 + 2 * v) * t * r, tiles=4 * t)
        common = dict(aggregates=(2 * v + 8) * n_act * straddle_chunks,
                      bounds=2 * v * n_act * width,
                      stores=v * stores(torch, want[:2], (lbp, ubp)),
                      accumulators=4 * v * n_act * width, flags=4 * POOL * part.n_slabs + POOL)
        row = out["node_slab_round_tiles"][shape] = measured_row(
            torch, build, got, want,
            lambda: tk.node_slab_round_tiles(*r_args, lbw, ubw, *tail, **kw),
            lambda: tref.node_slab_round_ref(*r_args, lbp, ubp, *tail),
            dict(**(stream if n_act else {}), **common),
            16 * nnz * n_act, plain_reps=reps,
            reset=fresh_inputs(torch, [(lbw, lbp), (ubw, ubp)]), launches=2, flops=flops)
        row["bound_all_slots_ms"] = bound(
            (v * t * r * k + sum(stream.values()) - stream["val"] if n_act else 0)
            + sum(common.values()), 16 * nnz * n_act, flops)[0]
        bl, bu = tref.node_partitioned_round_ref(part, lbp, ubp, cfg.int_eps, cfg.inf,
                                                 active=act)
        bl, bu = bl[:, :width].contiguous(), bu[:, :width].contiguous()
        m_args = (act, part.slab, eps, cfg.inf, outward)
        want_m = tref.apply_updates_slab_ref(lbp, ubp, bl, bu, *m_args)
        want_m = (*want_m[:2], want_m[2].any(dim=1))
        got_m = tk.apply_updates_slab_tiles(lbp.clone(), ubp.clone(), bl.clone(), bu.clone(),
                                            *m_args)
        # Scratch planes and candidates (the merge hands the active rows
        # back at the sentinels), restored before each timed launch.
        lbw, ubw, blw, buw = lbp.clone(), ubp.clone(), bl.clone(), bu.clone()
        out["apply_updates_slab_tiles"][shape] = measured_row(
            torch, build, got_m, want_m,
            lambda: tk.apply_updates_slab_tiles(lbw, ubw, blw, buw, *m_args),
            lambda: tref.apply_updates_slab_ref(lbp, ubp, bl, bu, *m_args),
            dict(merge_bytes(torch, ops.bnd, lbp, ubp, bl, bu, eps, act, cfg.inf),
                 flags=4 * POOL * part.n_slabs + POOL),
            6 * n_act * width,
            reset=fresh_inputs(torch, [(lbw, lbp), (ubw, ubp), (blw, bl), (buw, bu)]),
            flops=flops)
        for kname in out:
            log_row(kname, shape, out[kname][shape])
    return out


def wide_phase(torch, np, rt, td, tk, tref, ops, build, dev, measured):
    """Phase 8: bandw and pbw past 2^16 columns.  Kernels #11-#15 against
    their plain versions at the engine's shapes (and D + F at n_pad
    150,016); propagate_block_ell with its defaults (the partitioned engine)
    against the plain path, a second run and the explicit fused engine;
    propagate_nodes on 16 pbw nodes; solve on pbw against the reference's
    counts, the plain path and the fused node path.  Adds to ``measured``;
    returns the launch counts of each main-path run."""
    problems, preps, parts = {}, {}, {}
    for name, gen, kw in WIDE_SPECS:
        t = time.perf_counter()
        p = getattr(td, gen)(**kw)
        t_gen = time.perf_counter() - t
        t = time.perf_counter()
        prep = rt.prepare_block_ell(p, device=dev)
        torch.cuda.synchronize()
        t_prep = time.perf_counter() - t
        t = time.perf_counter()
        part = prep.slab_partition()
        torch.cuda.synchronize()
        t_part = time.perf_counter() - t
        problems[name], preps[name], parts[name] = p, prep, part
        log(f"instance {name}: m={p.m} n={p.n} nnz={p.nnz} "
            f"max_row={int(np.diff(p.csr.row_ptr).max())} tiles={tuple(prep.d.val.shape)} "
            f"n_pad={prep.n_pad} slab={part.slab} x {part.n_slabs} copies={part.num_copies} "
            f"straddle_tiles={part.a_val.shape[0]} straddle_rows={part.n_straddle} "
            f"duplication={part.duplication:.4f} generate={t_gen:.1f}s prepare={t_prep:.2f}s "
            f"partition_build={t_part:.2f}s")
        if ops._resolve_scatter("auto", prep) != "partitioned":
            fail(f"{name}: scatter='auto' does not take the partitioned engine")

    for name, p in problems.items():
        prep = preps[name]
        for kname, r in check_kernels(torch, tk, tref, ops, build, name, p, prep, prep.lb0,
                                      prep.ub0, timed=True).items():
            log(f"kernel {kname} on {name} (n_pad {prep.n_pad}): max_abs_err="
                f"{r['max_abs_err']} ms={r['ms']:.4f} wrapper_ms={r['wrapper_ms']:.4f} "
                f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f}")
            measured.setdefault(kname, {})[name] = r
        for kname, r in check_slab_kernels(torch, tk, tref, ops, build, name, prep,
                                           parts[name]).items():
            measured.setdefault(kname, {})[name] = r

    runs = {}
    results = {}
    for name, p in problems.items():
        n_sync = [0]
        tk.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = rt.propagate_block_ell(p, device=dev,
                                   on_sync=lambda: n_sync.__setitem__(0, n_sync[0] + 1))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        runs[f"propagate_block_ell {name}"] = tk.launch_counts()
        results[name] = r
        rounds = r.rounds.item()
        if (rounds, r.converged.item(), r.infeasible.item()) != (WIDE_ROUNDS[name], True, False):
            fail(f"{name}: rounds={rounds} converged={r.converged.item()} "
                 f"infeasible={r.infeasible.item()}; the reference takes {WIDE_ROUNDS[name]} "
                 "rounds and converges feasible")
        check_same(rt, name, r, rt.propagate_block_ell(p, use_kernels=False, device=dev), True,
                   "the plain-version path")
        check_same(rt, name, r, rt.propagate_block_ell(p, device=dev), True,
                   "a second run of the kernel path")
        fused = rt.propagate_block_ell(p, scatter="fused", device=dev)
        check_same(rt, name, r, fused, False, "the explicit fused engine")
        diff = [(getattr(r, f) != getattr(fused, f)).sum().item() for f in ("lb", "ub")]
        k_ms = time_ms(torch, lambda: rt.propagate_block_ell(p, device=dev), reps=1, trials=3)
        f_ms = time_ms(torch, lambda: rt.propagate_block_ell(p, scatter="fused", device=dev),
                       reps=1, trials=3)
        p_ms = time_ms(torch, lambda: rt.propagate_block_ell(p, use_kernels=False, device=dev),
                       reps=1, trials=1)
        fixed = int((r.lb == r.ub).sum().item())
        log(f"main path {name}: partitioned, rounds={rounds} (reference {WIDE_ROUNDS[name]}) "
            f"converged feasible, {fixed} variables fixed, host_syncs={n_sync[0]}, first wall "
            f"{wall * 1e3:.3f} ms; bitwise equal to the plain path and a second run; explicit "
            f"fused: same rounds, bounds_equal, entries not bitwise equal: lb {diff[0]}, "
            f"ub {diff[1]}; launches {runs[f'propagate_block_ell {name}']}")
        log(f"round time {name}: partitioned {k_ms / rounds:.4f} ms/round ({k_ms:.3f} ms), "
            f"fused {f_ms / rounds:.4f} ms/round ({f_ms:.3f} ms), plain {p_ms / rounds:.4f} "
            f"ms/round, {rounds} rounds, {n_sync[0]} host syncs")
        prof = busy_profile(torch, lambda: rt.propagate_block_ell(p, device=dev))
        if prof is None:
            log(f"profile {name}: the profiler recorded no device time; idle share not measured")
        else:
            busy, top = prof
            log(f"profile {name}: device busy {busy:.3f} ms of {k_ms:.3f} ms fixed point, "
                f"idle share {1 - busy / k_ms:.3f}; top: {top}")

    # The node engine and the solver at the solver's tile width.
    pbw = problems["pbw"]
    t = time.perf_counter()
    prep8 = rt.prepare_block_ell(pbw, tile_width=SOLVER_TILE_WIDTH, device=dev)
    part8 = prep8.slab_partition()
    torch.cuda.synchronize()
    log(f"pbw at tile width {SOLVER_TILE_WIDTH}: tiles={tuple(prep8.d.val.shape)} "
        f"copies={part8.num_copies} straddle_tiles={part8.a_val.shape[0]} "
        f"straddle_rows={part8.n_straddle} duplication={part8.duplication:.4f} "
        f"prepare + partition_build={time.perf_counter() - t:.2f}s")
    for k, rows in check_node_slab_kernels(torch, np, rt, tk, tref, ops, build, pbw, prep8,
                                           part8).items():
        measured.setdefault(k, {}).update(rows)

    root = rt.propagate_block_ell(pbw, tile_width=SOLVER_TILE_WIDTH, device=dev)
    check_same(rt, "pbw at tile width 8", root, results["pbw"], True, "tile width 128")
    lb_r, ub_r = root.lb.cpu().numpy(), root.ub.cpu().numpy()
    lb, ub = branched(np, rt, lb_r, ub_r,
                      most_fractional_order(np, lb_r, ub_r, pbw.is_int)[:WIDE_BRANCHED])
    reads = [0]
    tk.reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    got = rt.propagate_nodes(pbw, lb, ub, tile_width=SOLVER_TILE_WIDTH, device=dev,
                             on_sync=lambda: reads.__setitem__(0, reads[0] + 1))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    runs["nodes pbw"] = tk.launch_counts()
    plain = rt.propagate_nodes(pbw, lb, ub, tile_width=SOLVER_TILE_WIDTH, device=dev,
                               use_kernels=False)
    for f in ("lb", "ub", "rounds", "converged", "infeasible"):
        if not torch.equal(getattr(got, f), getattr(plain, f)):
            fail(f"nodes pbw: {f} differs from the plain-version path")
    for i in range(lb.shape[0]):
        one = rt.propagate_block_ell(pbw, tile_width=SOLVER_TILE_WIDTH, lb0=lb[i], ub0=ub[i],
                                     device=dev)
        if not (torch.equal(got.lb[i], one.lb) and torch.equal(got.ub[i], one.ub)):
            fail(f"nodes pbw: node {i} differs from its single-instance run")
        for f in ("rounds", "converged", "infeasible"):
            if getattr(got, f)[i].item() != getattr(one, f).item():
                fail(f"nodes pbw: node {i} {f} differs from its single-instance run")
    rounds = int(got.rounds.max())
    k_ms = time_ms(torch, lambda: rt.propagate_nodes(pbw, lb, ub, tile_width=SOLVER_TILE_WIDTH,
                                                     device=dev), reps=1, trials=3)
    log(f"nodes pbw: {lb.shape[0]} nodes, rounds {int(got.rounds.min())}-{rounds}, infeasible "
        f"{int(got.infeasible.sum())}, flag reads {reads[0]}, first wall {wall * 1e3:.3f} ms; "
        f"kernels {k_ms:.3f} ms ({k_ms / rounds:.4f} ms/round); every node bitwise equal to "
        f"its single-instance run and to the plain path; launches {runs['nodes pbw']}")

    c = objective(np, pbw.n)
    reads, syncs = [0], []
    tk.reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = rt.solve(pbw, c, device=dev, on_sync=syncs.append,
                   on_flag_read=lambda: reads.__setitem__(0, reads[0] + 1), **WIDE_SEARCH)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    runs["solve pbw"] = tk.launch_counts()
    got = (res.status, res.nodes_expanded, res.nodes_created, res.levels, res.host_syncs)
    if got != WIDE_REFERENCE:
        fail(f"solve pbw: {got} != reference {WIDE_REFERENCE}")
    plain = rt.solve(pbw, c, device=dev, use_kernels=False, **WIDE_SEARCH)
    # The same search through the fused node round (#10 + #9): the limit is
    # raised past pbw's n_pad for this call alone.
    limit = ops.SCATTER_MAX_NPAD
    ops.SCATTER_MAX_NPAD = 1 << 18
    try:
        tk.reset_launch_counts()
        fused = rt.solve(pbw, c, device=dev, **WIDE_SEARCH)
        fused_counts = tk.launch_counts()
        f_ms = time_ms(torch, lambda: rt.solve(pbw, c, device=dev, **WIDE_SEARCH), reps=1,
                       trials=3)
    finally:
        ops.SCATTER_MAX_NPAD = limit
    if fused_counts["node_fused_scatter_round_tiles"] <= 0 or fused_counts[
            "node_slab_round_tiles"] != 0:
        fail(f"solve pbw through the fused node round launched {fused_counts}")
    for other, what in ((plain, "the plain path"), (fused, "the fused node path")):
        for f in SOLVE_FIELDS:
            if getattr(res, f) != getattr(other, f):
                fail(f"solve pbw: {f} {getattr(res, f)} != {what} {getattr(other, f)}")
        for f, x, y in zip(res.carry._fields, res.carry, other.carry):
            if not torch.equal(x, y):
                fail(f"solve pbw: final pool {f} differs from {what}")
    k_ms = time_ms(torch, lambda: rt.solve(pbw, c, device=dev, **WIDE_SEARCH), reps=1, trials=3)
    log(f"solve pbw: {res.status}, levels {res.levels}, expanded {res.nodes_expanded}, created "
        f"{res.nodes_created}, host syncs {res.host_syncs}, flag reads {reads[0]} (reference "
        f"{WIDE_REFERENCE}); partitioned {k_ms:.3f} ms ({k_ms / res.levels:.3f} ms/level, "
        f"{res.nodes_created / (k_ms / 1e3):.1f} nodes/s; first call {wall * 1e3:.3f} ms), "
        f"fused node path {f_ms:.3f} ms ({f_ms / res.levels:.3f} ms/level); same result and "
        f"final pool on the kernel path, the plain path and the fused node path; launches "
        f"{runs['solve pbw']}")
    # PyTorch's index gathers (index_elementwise_kernel): eight a round were
    # the straddle tables' before the straddle combine kernel.
    prof = busy_profile(torch, lambda: rt.solve(pbw, c, device=dev, **WIDE_SEARCH),
                        count="index_elementwise")
    if prof is None:
        log("profile solve pbw: the profiler recorded no device time; idle share not measured")
    else:
        busy, top = prof
        log(f"profile solve pbw: device busy {busy:.3f} ms of {k_ms:.3f} ms search, idle share "
            f"{1 - busy / k_ms:.3f}; top: {top}")
    return runs, problems, results


# ---------------------------------------------------------------------------
# Phase 11: the segment (seed) dataflow, kernels A, B and C
# ---------------------------------------------------------------------------


def check_segment_kernels(torch, tk, tref, ops, build, name, prep):
    """Kernel C (rows in one chunk) or A and B (rows spanning chunks)
    against their plain versions on the card, at the segment round's shapes
    and the instance's initial bounds, timed; then the round's column
    reduction both ways (over the nonzero slots, as the engine runs it, and
    over every slot), held equal as values and timed.  Returns {kernel:
    row}."""
    cfg = ops.DEFAULT_CONFIG
    d = prep.d
    nnz = int((d.val != 0).sum().item())
    cols = prep.gather_columns()  # d.col, or a compact prep's widened once
    lb_g, ub_g = ops.gather_bounds(prep.lb0, prep.ub0, cols)
    flops = F64_FLOPS if d.val.dtype == torch.float64 else F32_FLOPS
    rows = {}

    def row(kname, got, want, fn_k, fn_p):
        rows[kname] = r = measured_row(torch, build, got, want, fn_k, fn_p,
                                       needed_bytes(kname, prep, nnz),
                                       OPS_PER_NNZ[kname] * nnz, flops=flops)
        r["instance"] = name
        log_row(kname, f"{name} (segment)", r)

    if prep.fits_one_chunk:
        args = (d.val, lb_g, ub_g, prep.ii_g, prep.lhs_g, prep.rhs_g, cfg.int_eps)
        want = tref.fused_round_tiles_ref(*args)
        row("fused_round_tiles", tk.fused_round_tiles(*args), want,
            lambda: tk.fused_round_tiles(*args), lambda: tref.fused_round_tiles_ref(*args))
    else:
        a_args = (d.val, lb_g, ub_g)
        partials = tref.activities_tiles_ref(*a_args)
        row("activities_tiles", tk.activities_tiles(*a_args), partials,
            lambda: tk.activities_tiles(*a_args), lambda: tref.activities_tiles_ref(*a_args))
        aggs = tref.combine_chunk_partials_ref(*partials, d.chunk_row, prep.row_start)
        b_args = (d.val, lb_g, ub_g, prep.ii_g, *aggs, prep.lhs_g, prep.rhs_g, cfg.int_eps)
        want = tref.candidates_tiles_ref(*b_args)
        row("candidates_tiles", tk.candidates_tiles(*b_args), want,
            lambda: tk.candidates_tiles(*b_args), lambda: tref.candidates_tiles_ref(*b_args))
    index = prep.segment_index()
    kept = ops.segment_reduce(*want, index, prep.n_pad, cfg.inf)
    every = tref.scatter_round_ref(*want, d.col, prep.n_pad, cfg.inf)
    max_abs_err(torch, kept, every)
    kept_ms = time_ms(torch, lambda: ops.segment_reduce(*want, index, prep.n_pad, cfg.inf))
    every_ms = time_ms(torch, lambda: tref.scatter_round_ref(*want, d.col, prep.n_pad, cfg.inf),
                       reps=1, trials=3)
    gather_ms = time_ms(torch, lambda: ops.gather_bounds(prep.lb0, prep.ub0, cols))
    # Its bound: the two candidates and the int64 position and column of
    # each nonzero slot read once, the two (n_pad,) results written once.
    v = d.val.element_size()
    red_ms, _ = bound((2 * v + 16) * index[0].numel() + 2 * v * prep.n_pad, 0)
    log(f"segment reduction on {name}: {index[0].numel()} nonzero slots of "
        f"{d.val.numel()}; over the nonzero slots {kept_ms:.4f} ms (bound {red_ms:.4f} ms), "
        f"over every slot {every_ms:.4f} ms (equal as values); bound gather {gather_ms:.4f} ms")
    return rows


def segment_phase(torch, rt, tk, tref, ops, build, dev, measured, problems, preps, results,
                  bandw, bandw_part):
    """Phase 11: the segment (seed) dataflow on the instances of phases 2
    and 8.  Kernels C (``pb``, ``banded``), A and B (``mixed``) against
    their plain versions, timed, with the column reduction both ways;
    ``propagate_block_ell(scatter="segment")`` on the three instances
    against the fused main-path run of phase 2 (rounds, converged and
    infeasible exactly, bounds bitwise as values) and its own plain path;
    ``bandw`` under ``REPRO_AUTO_LARGE_SCATTER=segment`` through
    ``scatter="auto"``; one ``legacy_round_fn_for`` round on ``pb``.  Adds
    to ``measured``; returns the launch counts of each run."""
    for name in problems:
        for kname, r in check_segment_kernels(torch, tk, tref, ops, build, name,
                                              preps[name]).items():
            measured.setdefault(kname, {})[name] = r

    runs = {}
    for name, p in problems.items():
        prep = preps[name]
        n_sync = [0]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        tk.reset_launch_counts()
        t = time.perf_counter()
        r = rt.propagate_block_ell(p, scatter="segment", device=dev,
                                   on_sync=lambda: n_sync.__setitem__(0, n_sync[0] + 1))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        runs[f"segment {name}"] = tk.launch_counts()
        peak = torch.cuda.max_memory_allocated() - base_mem
        # The same summation order and combine as the fused engine: bitwise.
        check_same(rt, f"segment {name}", r, results[name], True, "the fused main-path run")
        check_same(rt, f"segment {name}", r,
                   rt.propagate_block_ell(p, scatter="segment", use_kernels=False, device=dev),
                   True, "the segment plain-version path")
        rounds = r.rounds.item()
        s_ms = time_ms(torch, lambda: rt.propagate_block_ell(p, scatter="segment", device=dev),
                       reps=1, trials=3)
        f_ms = time_ms(torch, lambda: rt.propagate_block_ell(p, device=dev), reps=1, trials=3)
        log(f"segment {name}: rounds={rounds} converged={r.converged.item()} "
            f"infeasible={r.infeasible.item()} host_syncs={n_sync[0]}; T*R*K="
            f"{prep.d.val.numel()} slots, peak device memory above the prepared tiles "
            f"{peak / 2**20:.1f} MiB; bitwise equal to the fused engine and the plain path; "
            f"first wall {wall * 1e3:.3f} ms; launches {runs[f'segment {name}']}")
        log(f"round time {name}: segment {s_ms / rounds:.4f} ms/round ({s_ms:.3f} ms), fused "
            f"{f_ms / rounds:.4f} ms/round ({f_ms:.3f} ms), ratio {s_ms / f_ms:.2f}")
        prof = busy_profile(torch, lambda: rt.propagate_block_ell(p, scatter="segment",
                                                                  device=dev))
        if prof is None:
            log(f"profile segment {name}: the profiler recorded no device time; idle share "
                "not measured")
        else:
            busy, top = prof
            log(f"profile segment {name}: device busy {busy:.3f} ms of {s_ms:.3f} ms fixed "
                f"point, idle share {1 - busy / s_ms:.3f}; top: {top}")

    # Past 2^16 columns the override routes scatter="auto" to the segment
    # engine; restored afterwards.
    prep = rt.prepare_block_ell(bandw, device=dev)
    old = os.environ.get(ops.AUTO_LARGE_SCATTER_ENV)
    os.environ[ops.AUTO_LARGE_SCATTER_ENV] = "segment"
    try:
        if ops._resolve_scatter("auto", prep) != "segment":
            fail("bandw: the override does not route scatter='auto' to the segment engine")
        tk.reset_launch_counts()
        r = rt.propagate_block_ell(bandw, device=dev)
        torch.cuda.synchronize()
        runs["segment bandw auto"] = counts = tk.launch_counts()
        a_ms = time_ms(torch, lambda: rt.propagate_block_ell(bandw, device=dev), reps=1,
                       trials=3)
    finally:
        if old is None:
            os.environ.pop(ops.AUTO_LARGE_SCATTER_ENV, None)
        else:
            os.environ[ops.AUTO_LARGE_SCATTER_ENV] = old
    if ops._resolve_scatter("auto", prep) != "partitioned":
        fail("bandw: scatter='auto' did not return to the partitioned engine")
    if counts["batched_slab_partials_tiles"] or counts["batched_slab_round_tiles"]:
        fail(f"bandw under the override launched the partitioned kernels: {counts}")
    # Against the partitioned run of phase 8 (whose straddle rows sum in
    # another order; bandw's sides are not integral) and bitwise against
    # the explicit fused engine.
    check_same(rt, "segment bandw auto", r, bandw_part, False, "the partitioned run")
    check_same(rt, "segment bandw auto", r,
               rt.propagate_block_ell(bandw, scatter="fused", device=dev), True,
               "the explicit fused engine")
    diff = [(getattr(r, f) != getattr(bandw_part, f)).sum().item() for f in ("lb", "ub")]
    log(f"segment bandw auto (REPRO_AUTO_LARGE_SCATTER=segment, n_pad {prep.n_pad}): "
        f"rounds={r.rounds.item()}, {a_ms / r.rounds.item():.4f} ms/round; same rounds and "
        f"bounds_equal to the partitioned run (entries not bitwise equal: lb {diff[0]}, ub "
        f"{diff[1]}); bitwise equal to the explicit fused engine; launches {counts}")

    # One seed round in the unpadded (n,) domain against one prepared
    # segment round on the same bounds.
    prep = preps["pb"]
    want = ops.round_fn_for(prep, scatter="segment")(prep.lb0.clone(), prep.ub0.clone())
    tk.reset_launch_counts()
    got = ops.legacy_round_fn_for(prep)(prep.d.lb0.clone(), prep.d.ub0.clone())
    torch.cuda.synchronize()
    runs["segment legacy pb"] = tk.launch_counts()
    max_abs_err(torch, got[:2], (want[0][: prep.n], want[1][: prep.n]))
    if bool(got[2]) != bool(want[2]):
        fail("legacy round pb: changed flag differs from the prepared segment round")
    log(f"legacy round pb: equal to one prepared segment round (changed={bool(got[2])}); "
        f"launches {runs['segment legacy pb']}")

    fused_seg = ("fused_round_tiles", "apply_updates_tiles")
    require_launched(runs, {
        "segment pb": fused_seg,
        "segment banded": fused_seg,
        "segment mixed": ("activities_tiles", "combine_chunk_partials_tiles",
                          "candidates_tiles", "apply_updates_tiles"),
        "segment bandw auto": fused_seg,
        "segment legacy pb": fused_seg,
    })
    return runs


# ---------------------------------------------------------------------------
# Phase 9: the batched engine (propagate_batch)
# ---------------------------------------------------------------------------


def batched_fused_bytes(np, batch, active) -> tuple[dict, int, int]:
    """Bytes kernel #8 must move on a packed bucket with ``active`` (host
    bool per instance): for the tiles of active instances ``val`` at the
    nonzeros (each chunk stops at its length), ``col`` and ``is_int`` per
    nonzero, the length and the two sides per chunk; per active instance
    its two bound rows read and its two accumulator rows written; the
    chunk ranges and the mask.  Also the nonzeros and the bytes of ``val``
    at every slot of those tiles (the all-slot bound)."""
    ell = batch.ell
    t, r, k = ell.val.shape
    on = np.asarray(active)[ell.tile_inst]
    nnz = int((ell.val[on] != 0).sum())
    tiles = int(on.sum())
    n_act = int(np.asarray(active).sum())
    return (dict(val=8 * nnz, col_ii=8 * nnz, rows=20 * tiles * r,
                 planes=32 * n_act * batch.n_pad, maps=8 * (batch.size + 1) + batch.size),
            nnz, 8 * tiles * r * k)


def check_batched_fused(torch, np, rt, tk, tref, build, batch, prep, singles, dev):
    """Kernel #8 against its plain version at the fused bucket's shapes and
    initial planes, with 0, 2 and 4 instances active, bitwise; each active
    row also against kernel D on that instance's own tiles.  The kernel
    scatters into one pair of accumulator planes kept across the launches,
    as the round closure keeps them (#9 hands them back; here they are set
    back to the sentinels before each timed launch), with the chunk ranges,
    lengths and longest chunk the prep hoisted.  Timed: the kernel's
    launch, the wrapper call, the plain version.  Returns {shape: row}."""
    d, cfg = prep.d, rt.core.DEFAULT_CONFIG
    acc = tk.accumulator_planes(d.lb0)
    kw = dict(acc=acc, chunk_len=d.chunk_len, max_chunk_len=prep.max_chunk_len,
              chunks=d.chunks)

    def clean():
        acc[0].fill_(-cfg.inf)
        acc[1].fill_(cfg.inf)

    rows = {}
    for n_act in (0, 2, batch.size):
        act_h = np.zeros(batch.size, bool)
        act_h[:: max(1, batch.size // max(n_act, 1))][:n_act] = True
        act = torch.as_tensor(act_h, device=dev)
        args = (d.val, d.col, d.ii_g, d.lhs_g, d.rhs_g, d.lb0, d.ub0, d.tile_inst, act,
                prep.n_pad, cfg.int_eps)
        clean()
        got = tuple(x.clone() for x in tk.batched_fused_scatter_round_tiles(*args, **kw))
        want = tref.batched_fused_scatter_round_ref(
            d.val, d.col_g, d.ii_g, d.lhs_g, d.rhs_g, d.lb0, d.ub0, prep.n_pad, cfg.int_eps,
            active=act)
        for i in np.flatnonzero(act_h):
            sp = singles[i]
            one = tk.fused_scatter_round_tiles(sp.d.val, sp.d.col, sp.ii_g, sp.lhs_g, sp.rhs_g,
                                               sp.lb0, sp.ub0, sp.n_pad, cfg.int_eps)
            max_abs_err(torch, (got[0][i], got[1][i]), one)
        moved, nnz, all_val = batched_fused_bytes(np, batch, act_h)
        shape = f"fused bucket, {n_act} of {batch.size} active"
        rows[shape] = r = measured_row(
            torch, build, got, want, lambda: tk.batched_fused_scatter_round_tiles(*args, **kw),
            lambda: tref.batched_fused_scatter_round_ref(
                d.val, d.col_g, d.ii_g, d.lhs_g, d.rhs_g, d.lb0, d.ub0, prep.n_pad,
                cfg.int_eps, active=act),
            moved, 16 * nnz, plain_reps=1, reset=clean)
        r["bound_all_slots_ms"] = bound(sum(moved.values()) - moved["val"] + all_val,
                                        16 * nnz)[0]
        log_row("batched_fused_scatter_round_tiles", shape, r)
    clean()
    fill = time_ms(torch, lambda: (torch.full_like(d.lb0, -cfg.inf),
                                   torch.full_like(d.ub0, cfg.inf)))
    log(f"accumulator fill the wrapper no longer makes per launch: two "
        f"{tuple(d.lb0.shape)} sentinel planes, {fill:.4f} ms")
    return rows


def batch_phase(torch, np, rt, td, tk, tref, ops, build, dev, measured, problems):
    """Phase 9: propagate_batch with its defaults on three buckets -- one
    fused (#8 + #9), one multi-chunk (A', combine, E over the flat stream,
    then #9), one past 2^16 columns (the partitioned round with two planes).
    Every instance bitwise against its own propagate_block_ell and against
    the plain path; a bounds= warm start; #8 against its plain version,
    timed.  Adds to ``measured``; returns the launch counts of each run and
    the three populations."""
    t = time.perf_counter()
    banded1 = td.make_banded(**BANDED1)
    mixed1 = td.make_mixed(**MIXED1)
    log(f"instances banded1, mixed1: generate={time.perf_counter() - t:.1f}s")
    pops = {
        "fused": [problems["pb"], problems["pbf"], problems["banded"], banded1],
        "multi-chunk": [problems["mixed"], mixed1],
        "partitioned": [problems["bandw"], problems["pbw"]],
    }
    preps = {}
    for name, pop in pops.items():
        t = time.perf_counter()
        (batch,) = ops.packed_problems(pop)
        t_pack = time.perf_counter() - t
        t = time.perf_counter()
        prep = ops.prepare_problem_batch(batch, device=dev)
        torch.cuda.synchronize()
        t_prep = time.perf_counter() - t
        t = time.perf_counter()
        extra = ""
        if prep.n_pad > ops.SCATTER_MAX_NPAD:
            part = prep.slab_partition()
            extra = (f" slab={part.slab} x {part.n_slabs} copies={part.num_copies} "
                     f"straddle_tiles={part.a_val.shape[0]} straddle_rows={part.n_straddle} "
                     f"partition_build={time.perf_counter() - t:.2f}s")
        got = ("partitioned" if prep.n_pad > ops.SCATTER_MAX_NPAD
               else "fused" if prep.fits_one_chunk else "multi-chunk")
        if got != name:
            fail(f"batch {name}: the bucket takes the {got} round")
        preps[name] = (batch, prep)
        log(f"batch {name}: {batch.size} instances, nnz={[q.nnz for q in pop]}, "
            f"tiles={tuple(prep.d.val.shape)} "
            f"n_pad={prep.n_pad} m_total={prep.m_total} fits_one_chunk={prep.fits_one_chunk} "
            f"pack={t_pack:.2f}s prepare={t_prep:.2f}s{extra}")

    # The straddle combine on the partitioned bucket's single plane of
    # partials (#11's plain version at the initial bounds).
    _, prep = preps["partitioned"]
    part = prep.slab_partition()
    on = torch.ones(prep.size, dtype=torch.bool, device=dev)
    partials = tref.batched_slab_partials_ref(
        part.a_val, part.a_col_s, part.a_run_start, part.a_run_len, part.a_run_inst,
        part.a_run_slab, on, prep.d.lb0, prep.d.ub0, part.slab, part.a_max_run_len)
    row = straddle_row(torch, tk, tref, build, part, partials, None)
    row["instance"] = "partitioned bucket"
    log_row("straddle_combine_tiles", "partitioned bucket", row)
    measured.setdefault("straddle_combine_tiles", {})["partitioned bucket"] = row

    batch, prep = preps["fused"]
    singles = [rt.prepare_block_ell(p, device=dev) for p in pops["fused"]]
    measured["batched_fused_scatter_round_tiles"] = check_batched_fused(
        torch, np, rt, tk, tref, build, batch, prep, singles, dev)

    runs = {}
    for name, pop in pops.items():
        reads = [0]
        tk.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = rt.propagate_batch(pop, device=dev,
                                 on_sync=lambda: reads.__setitem__(0, reads[0] + 1))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        runs[f"batch {name}"] = tk.launch_counts()
        plain = rt.propagate_batch(pop, device=dev, use_kernels=False)
        singles = [rt.propagate_block_ell(p, device=dev) for p in pop]
        for i, (g, w, one) in enumerate(zip(got, plain, singles)):
            for f in ("lb", "ub", "rounds", "converged", "infeasible"):
                if not torch.equal(getattr(g, f), getattr(w, f)):
                    fail(f"batch {name}: instance {i} {f} differs from the plain path")
                if not torch.equal(getattr(g, f), getattr(one, f)):
                    fail(f"batch {name}: instance {i} {f} differs from its propagate_block_ell")
            if not torch.equal(g.progress, w.progress):
                fail(f"batch {name}: instance {i} progress differs from the plain path")
        b_ms = time_ms(torch, lambda: rt.propagate_batch(pop, device=dev), reps=1, trials=3)
        s_ms = [time_ms(torch, lambda p=p: rt.propagate_block_ell(p, device=dev), reps=1,
                        trials=3) for p in pop]
        rounds = [int(r.rounds) for r in got]
        log(f"batch {name}: rounds {rounds}, converged {[bool(r.converged) for r in got]}, "
            f"infeasible {[bool(r.infeasible) for r in got]}, flag reads {reads[0]}, first wall "
            f"{wall * 1e3:.3f} ms; batch fixed point {b_ms:.3f} ms ({b_ms / max(rounds):.4f} "
            f"ms/round), sum of single-instance fixed points {sum(s_ms):.3f} ms "
            f"({', '.join(f'{x:.3f}' for x in s_ms)}); every instance bitwise equal to its "
            f"propagate_block_ell and to the plain path; launches {runs[f'batch {name}']}")
        prof = busy_profile(torch, lambda: rt.propagate_batch(pop, device=dev))
        if prof is None:
            log(f"profile batch {name}: the profiler recorded no device time; idle share not "
                "measured")
        else:
            busy, top = prof
            log(f"profile batch {name}: device busy {busy:.3f} ms of {b_ms:.3f} ms fixed point, "
                f"idle share {1 - busy / b_ms:.3f}; top: {top}")

    # A warm start of one instance through the same packed tiles.
    pop = pops["fused"]
    p = pop[0]
    rng = np.random.default_rng(1)
    ub0 = np.array(p.ub)
    ub0[rng.choice(p.n, size=p.n // 20, replace=False)] = 0.0
    hits = ops.cache_info()["prepare_problem_batch"]["hits"]
    warm = rt.propagate_batch(pop, bounds=[(p.lb, ub0), None, None, None], device=dev)
    if ops.cache_info()["prepare_problem_batch"]["hits"] != hits + 1:
        fail("the warm start did not reuse the prepared bucket")
    one = rt.propagate_block_ell(p, lb0=p.lb, ub0=ub0, device=dev)
    cold = rt.propagate_batch(pop, device=dev)
    for f in ("lb", "ub", "rounds", "converged", "infeasible"):
        if not torch.equal(getattr(warm[0], f), getattr(one, f)):
            fail(f"batch warm start: {f} differs from the warm-started propagate_block_ell")
        for i in range(1, len(pop)):
            if not torch.equal(getattr(warm[i], f), getattr(cold[i], f)):
                fail(f"batch warm start: instance {i} {f} moved")
    log(f"batch warm start: pb with {p.n // 20} upper bounds at 0, rounds "
        f"{int(warm[0].rounds)}, infeasible {bool(warm[0].infeasible)}; equal to its "
        "warm-started propagate_block_ell, the other instances unchanged")
    return runs, pops


# ---------------------------------------------------------------------------
# Phase 10: the continuous-batching service
# ---------------------------------------------------------------------------


def percentiles(np, xs) -> str:
    q = np.percentile(np.asarray(xs) * 1e3, [50, 95, 99])
    return f"p50 {q[0]:.3f} / p95 {q[1]:.3f} / p99 {q[2]:.3f} ms"


def serve_once(torch, svc, payloads):
    """Submit every pre-packed payload, then pump until all retired.
    Returns (tickets, wall seconds, pumps)."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    tickets = [svc.submit(payload=pay) for pay in payloads]
    pumps = 0
    while not all(tk_.done() for tk_ in tickets):
        svc.pump()
        pumps += 1
    torch.cuda.synchronize()
    return tickets, time.perf_counter() - t, pumps


def service_run(torch, np, rt, tk, name, stream, dev, **kw):
    """One service over ``stream``: build, a checked serve (every ticket
    bitwise against one-shot propagate_batch on the kernels and on the
    plain versions), timed saturation runs against sequential
    propagate_block_ell, profile and stats.  Returns the checked serve's
    launch counts."""
    reads = [0]
    t = time.perf_counter()
    specs = rt.BucketSpec.for_problems(stream, **{k: v for k, v in kw.items()
                                                  if k in ("slots", "size_classes")})
    svc = rt.PropagationService(specs, rounds_per_step=SERVICE_ROUNDS_PER_STEP, device=dev,
                                on_sync=lambda: reads.__setitem__(0, reads[0] + 1))
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t
    for s in specs:
        log(f"service {name} bucket: n_pad={s.n_pad} slots={s.slots} slot_tiles={s.slot_tiles} "
            f"slot_rows={s.slot_rows} tile_width={s.tile_width} "
            f"fits_one_chunk={s.fits_one_chunk}")
    spec_of = [next(s for s in specs if s.fits_problem(p)) for p in stream]
    t = time.perf_counter()
    payloads = [s.pack(p) for s, p in zip(spec_of, stream)]
    t_pack = time.perf_counter() - t
    cc0 = svc.compile_counts()

    tk.reset_launch_counts()
    reads[0] = 0
    tickets, wall, pumps = serve_once(torch, svc, payloads)
    counts = tk.launch_counts()
    first_reads = reads[0]
    for i, (p, s, tkt) in enumerate(zip(stream, spec_of, tickets)):
        r = tkt.result()
        for use_kernels in (True, False):
            one = rt.propagate_batch([p], tile_rows=8, tile_width=s.tile_width,
                                     use_kernels=use_kernels, device=dev)[0]
            for f in ("lb", "ub", "rounds", "converged", "infeasible", "progress"):
                if not torch.equal(getattr(r, f), getattr(one, f).cpu()):
                    fail(f"service {name}: ticket {i} {f} differs from the one-shot batch "
                         f"({'kernels' if use_kernels else 'plain versions'})")
    if svc.compile_counts() != cc0:
        fail(f"service {name}: builds after construction: {cc0} -> {svc.compile_counts()}")

    rates, lat, queue, resident, pump_counts = [], [], [], [], []
    for _ in range(SERVICE_TIMED_RUNS):
        reads[0] = 0
        tickets, wall_t, pumps_t = serve_once(torch, svc, payloads)
        rates.append(len(stream) / wall_t)
        pump_counts.append((pumps_t, reads[0]))
        lat += [x.latency() for x in tickets]
        queue += [x.queue_latency() for x in tickets]
        resident += [x.service_latency() for x in tickets]
    for s, p in zip(spec_of, stream):  # prepare once, outside the timer
        rt.propagate_block_ell(p, tile_width=s.tile_width, device=dev)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for s, p in zip(spec_of, stream):
        rt.propagate_block_ell(p, tile_width=s.tile_width, device=dev)
    torch.cuda.synchronize()
    seq = len(stream) / (time.perf_counter() - t)
    rounds = [int(x.result().rounds) for x in tickets]
    log(f"service {name}: {len(stream)} requests, rounds {min(rounds)}-{max(rounds)}, "
        f"build {t_build:.2f}s, pack {t_pack:.2f}s; checked serve {wall * 1e3:.1f} ms, "
        f"{pumps} pumps, {first_reads} flag reads ({first_reads / pumps:.2f} per pump); every "
        f"ticket bitwise equal to the one-shot batch on the kernels and on the plain versions; "
        f"no build after construction {cc0}; launches {counts}")
    log(f"service {name}: saturation {', '.join(f'{x:.2f}' for x in rates)} instances/s "
        f"(pumps, flag reads per run: {pump_counts}); sequential propagate_block_ell "
        f"{seq:.2f} instances/s; latency submit->retire {percentiles(np, lat)}, queue "
        f"{percentiles(np, queue)}, resident {percentiles(np, resident)}")
    prof = busy_profile(torch, lambda: serve_once(torch, svc, payloads))
    if prof is None:
        log(f"profile service {name}: the profiler recorded no device time; idle share not "
            "measured")
    else:
        busy, top = prof
        wall_p = len(stream) / statistics.median(rates) * 1e3
        log(f"profile service {name}: device busy {busy:.3f} ms of {wall_p:.3f} ms saturation "
            f"run, idle share {1 - busy / wall_p:.3f}; top: {top}")
    st = svc.stats()
    for b in st["buckets"]:
        log(f"service {name} stats: n_pad={b['n_pad']} tile_width={b['tile_width']} "
            f"slot_tiles={b['slot_tiles']} retired={b['retired']} "
            f"mean_occupancy={b['mean_occupancy']:.3f}")
    log(f"service {name} stats: submitted={st['submitted']} retired={st['retired']} "
        f"pending={st['pending']} occupied={st['occupied']} engine_cache={st['engine_cache']}")
    if st["retired"] != st["submitted"] or st["occupied"] or st["pending"]:
        fail(f"service {name}: not drained: {st}")
    return counts, specs


def service_rows(np):
    """Rows of the service's requests: 12 + 12 + 4 draws from
    [30,000, 90,000) by default_rng(0)."""
    rng = np.random.default_rng(0)
    return rng.integers(*SERVICE_ROWS, size=2 * SERVICE_REQUESTS + SERVICE_MIXED)


def service_streams(np, td):
    """The service's two request streams: 12 pseudo-boolean and 12 banded
    requests, interleaved, and 4 mixed ones."""
    rows = service_rows(np)
    pbs = [td.make_pseudo_boolean(n=60_000, m=int(m), seed=100 + i, unit_frac=0.002)
           for i, m in enumerate(rows[:SERVICE_REQUESTS])]
    bands = [td.make_banded(n=40_000, m=int(m), row_nnz=24, band=5_000, seed=100 + i)
             for i, m in enumerate(rows[SERVICE_REQUESTS:2 * SERVICE_REQUESTS])]
    stream = [p for pair in zip(pbs, bands) for p in pair]
    mixed = [td.make_mixed(m=int(m), n=30_000, seed=100 + i, density=0.0005)
             for i, m in enumerate(rows[2 * SERVICE_REQUESTS:])]
    return stream, mixed


def service_phase(torch, np, rt, td, tk, dev):
    """Phase 10: the continuous-batching service on two request streams.
    Returns the launch counts of each checked serve, and the first stream."""
    rows = service_rows(np)
    t = time.perf_counter()
    stream, mixed = service_streams(np, td)
    log(f"service streams: {len(stream)} + {len(mixed)} requests, rows "
        f"{[int(x) for x in rows]}, nnz {sum(p.nnz for p in stream)} + "
        f"{sum(p.nnz for p in mixed)}, generate={time.perf_counter() - t:.1f}s")
    runs = {}
    counts, specs = service_run(torch, np, rt, tk, "stream", stream, dev, slots=SERVICE_SLOTS,
                                size_classes=SERVICE_SIZE_CLASSES)
    runs["service stream"] = counts
    if not any(s.fits_one_chunk for s in specs):
        fail("service stream: no bucket runs the fused round")
    if not all(s.fits_one_chunk for s in specs):
        require_launched({"service stream": counts}, {"service stream": (
            "activities_gather_tiles", "combine_chunk_partials_tiles",
            "candidates_scatter_tiles")})
    counts, _ = service_run(torch, np, rt, tk, "mixed", mixed, dev, slots=2)
    runs["service mixed"] = counts
    return runs, stream


# ---------------------------------------------------------------------------
# Phase 12: the named drivers, and the loop carry that kernel F keeps
# ---------------------------------------------------------------------------

DEVICE_LOOP_GROUPS = (1, 2, 4, 8, 16)
DRIVER_TRIALS = 7


def wall_ms(torch, fn) -> float:
    """One call of ``fn`` between synchronisations, CUDA events around it."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def carry_sequence_check(torch, np, tk, tref, dev):
    """Kernel F against its plain version over the rounds of one fixed point
    of check groups of 3 rounds at n_pad 60,032: six rounds whose
    candidates tighten, three that do not (the loop stops), two enqueued
    after it whose candidates would tighten; bounds, handed-back planes,
    the returned GO and the carry bitwise after every round."""
    from repro_torch.core import carry as rt_carry

    rng = np.random.default_rng(12)
    n, unroll, inf = 60_032, 3, tk.INF
    lb = torch.zeros(n, dtype=torch.float64, device=dev)
    ub = torch.full((n,), 10.0, dtype=torch.float64, device=dev)
    st_k, st_p = rt_carry.armed_state(dev), rt_carry.armed_state(dev)
    plan = [True] * 6 + [False] * 3 + [True] * 2
    for i, tighten in enumerate(plan):
        bl = torch.full((n,), -inf, dtype=torch.float64, device=dev)
        bu = torch.full((n,), inf, dtype=torch.float64, device=dev)
        if tighten:
            pick = torch.from_numpy(rng.random(n) < 0.3).to(dev)
            bl[pick] = lb[pick] + 1.0
            bu[~pick] = ub[~pick] - 0.5
        want = tref.merge_carry_ref(lb, ub, bl.clone(), bu.clone(), 1e-9, inf, 0.0, st_p,
                                    i % unroll, unroll)
        acc = (bl.clone(), bu.clone())
        got = tk.apply_updates_tiles(lb.clone(), ub.clone(), *acc, 1e-9, inf, 0.0, carry=st_k,
                                     k=i % unroll, unroll=unroll)
        max_abs_err(torch, (*got, st_k), (*want, st_p))
        planes_clean(torch, acc, inf, f"F with the carry: planes not clean after round {i + 1}")
        lb, ub = want[0], want[1]
    fields = st_k.tolist()[:5]
    if fields != [0, 0, 9, 0, 0]:
        fail(f"F with the carry: fields {fields} after the sequence, expected rounds 9, GO 0")
    log(f"kernel F with the loop carry: bitwise its plain version over {len(plan)} rounds "
        f"(groups of {unroll}; converged after 9, two rounds after it changed nothing); "
        f"carry [flag, any, rounds, go, ticket] = {fields}")


def closure_carry_check(torch, ops, prep, name, dev, rounds: int = 16, unroll: int = 4,
                        scatter: str = "fused"):
    """The round closure on the kernels against the one on the plain
    versions, both carries armed for groups of ``unroll``: bounds and carry
    bitwise, the kept planes (where the engine keeps them) clean after
    every round, through convergence and rounds enqueued after it (every
    kernel gated on the carry)."""
    fk = ops.round_fn_for(prep, scatter=scatter)
    fp = ops.round_fn_for(prep, use_kernels=False, scatter=scatter)
    lbk, ubk = prep.lb0.clone(), prep.ub0.clone()
    lbp, ubp = prep.lb0.clone(), prep.ub0.clone()
    fk.carry.arm(dev, unroll)
    fp.carry.arm(dev, unroll)
    try:
        for i in range(rounds):
            lbk, ubk, _ = fk(lbk, ubk)
            lbp, ubp, _ = fp(lbp, ubp)
            max_abs_err(torch, (lbk, ubk, fk.carry.state), (lbp, ubp, fp.carry.state))
            if hasattr(fk, "kept"):
                planes_clean(torch, fk.kept.planes, ops.DEFAULT_CONFIG.inf,
                             f"{name}: the closure's planes are not clean after round {i + 1}")
    finally:
        fk.carry.release()
        fp.carry.release()
    log(f"round closure {name} ({scatter}): kernels bitwise the plain versions over {rounds} "
        f"rounds in "
        f"groups of {unroll}; carry [flag, any, rounds, go, ticket] = "
        f"{fk.carry.state.tolist()[:5]}")


def drivers_phase(torch, np, rt, tk, tref, ops, dev, problems, preps, wide):
    """Phase 12: kernel F with the loop carry against its plain version
    (direct calls, and the round closures of banded, pbw and the segment
    engine); each single-instance fixed point on ``device_loop`` against
    its ``host_loop`` run (bitwise, progress included) with host reads
    counted; the read groups timed over 1, 2, 4, 8 and 16; and
    ``propagate``'s three drivers.  Returns the launch counts of each
    device_loop run."""
    from repro_torch.core import propagator as rt_prop

    carry_sequence_check(torch, np, tk, tref, dev)
    closure_carry_check(torch, ops, preps["banded"], "banded", dev)
    closure_carry_check(torch, ops, rt.prepare_block_ell(wide["pbw"], device=dev), "pbw", dev,
                        rounds=9, unroll=2, scatter="partitioned")
    closure_carry_check(torch, ops, preps["mixed"], "mixed", dev, rounds=18, unroll=3,
                        scatter="segment")

    all_problems = {**problems, **wide}
    cases = [(name, name, {}) for name in ("pb", "banded", "mixed", "bandw", "pbw")]
    cases += [(f"segment {name}", name, dict(scatter="segment"))
              for name in ("pb", "banded", "mixed")]
    gated = {label: not kw for label, _, kw in cases}
    group_of = lambda label: (rt_prop.DEVICE_LOOP_GROUP if gated[label]
                              else rt_prop.UNGATED_LOOP_GROUP)
    runs, reads, host_ms, table = {}, {}, {}, {}
    for label, name, kw in cases:
        p = all_problems[name]
        counts = {}
        out = {}
        for driver in ("host_loop", "device_loop"):
            n = [0]
            tk.reset_launch_counts()
            out[driver] = rt.propagate_block_ell(
                p, driver=driver, device=dev, on_sync=lambda: n.__setitem__(0, n[0] + 1), **kw)
            torch.cuda.synchronize()
            counts[driver] = tk.launch_counts()
            reads[label, driver] = n[0]
        runs[f"device_loop {label}"] = counts["device_loop"]
        host, devl = out["host_loop"], out["device_loop"]
        check_same(rt, f"device_loop {label}", devl, host, True, "its host_loop run")
        if not torch.equal(devl.progress, host.progress):
            fail(f"device_loop {label}: progress {devl.progress.item()} != host_loop "
                 f"{host.progress.item()}")
        rounds = reads[label, "rounds"] = host.rounds.item()
        want = -(-rounds // group_of(label))
        if reads[label, "host_loop"] != rounds or reads[label, "device_loop"] != want:
            fail(f"device_loop {label}: {reads[label, 'device_loop']} reads (expected {want}), "
                 f"host_loop {reads[label, 'host_loop']} (expected {rounds})")
        f_name = "apply_updates_tiles" if name not in wide else "apply_updates_slab_tiles"
        log(f"drivers {label}: rounds={rounds} converged={host.converged.item()}; device_loop "
            f"bitwise host_loop (progress included); host reads {reads[label, 'host_loop']} -> "
            f"{reads[label, 'device_loop']} (read group {group_of(label)}, "
            f"{'gated' if gated[label] else 'not gated'}); "
            f"merge launches {counts['host_loop'][f_name]} -> {counts['device_loop'][f_name]}")
    if reads["pb", "device_loop"] >= REFERENCE_ROUNDS["pb"]:
        fail(f"device_loop pb read the host {reads['pb', 'device_loop']} times")

    # Wall per fixed point (CUDA events, host reads included) by read group
    # (both module groups set alike: each run reads its engine's), with
    # propagate's plain round on pb: every variant of a run once per trial,
    # in an order that rotates between trials, so the host's drift spreads
    # over all of them; medians over the trials.
    saved = rt_prop.DEVICE_LOOP_GROUP, rt_prop.UNGATED_LOOP_GROUP
    variants = [("host_loop", None)] + [("device_loop", g) for g in DEVICE_LOOP_GROUPS]
    plain_variants = variants + [("unrolled", None)]
    timed = [(label, (lambda p=all_problems[name], kw=kw: lambda driver: rt.propagate_block_ell(
        p, driver=driver, device=dev, **kw))(), variants) for label, name, kw in cases]
    timed.append(("propagate pb", lambda driver: rt.propagate(problems["pb"], driver=driver,
                                                              device=dev), plain_variants))
    gated["propagate pb"] = False
    samples = {}
    try:
        for trial in range(DRIVER_TRIALS):
            for label, run, vs in timed:
                order = vs[trial % len(vs):] + vs[:trial % len(vs)]
                for driver, g in order:
                    rt_prop.DEVICE_LOOP_GROUP, rt_prop.UNGATED_LOOP_GROUP = (
                        saved if g is None else (g, g))
                    samples.setdefault((label, driver, g), []).append(
                        wall_ms(torch, lambda: run(driver)))
    finally:
        rt_prop.DEVICE_LOOP_GROUP, rt_prop.UNGATED_LOOP_GROUP = saved
    med = {key: statistics.median(v) for key, v in samples.items()}
    for label, _, vs in timed:
        host_ms[label] = med[label, "host_loop", None]
        for g in DEVICE_LOOP_GROUPS:
            table[label, g] = med[label, "device_loop", g]
        cells = ", ".join(f"{g}: {table[label, g]:.3f}" for g in DEVICE_LOOP_GROUPS)
        extra = (f"; unrolled (group {saved[1]}) {med[label, 'unrolled', None]:.3f}"
                 if (label, "unrolled", None) in med else "")
        log(f"device_loop wall ms {label} by read group: {cells}; host_loop "
            f"{host_ms[label]:.3f}{extra} (medians of {DRIVER_TRIALS})")
    # The group whose walls, each relative to the host loop's, have the
    # least geometric mean: over the gated runs (the fused and partitioned
    # engines: DEVICE_LOOP_GROUP) and over the others (the segment engine,
    # whose gathers and column reduction are not gated, and the plain
    # round: UNGATED_LOOP_GROUP).
    for which, value, want_gated in (("gated runs", saved[0], True),
                                     ("ungated runs", saved[1], False)):
        labels = [label for label, _, _ in timed if gated[label] == want_gated]
        score = {g: float(np.exp(np.mean([np.log(table[label, g] / host_ms[label])
                                          for label in labels])))
                 for g in DEVICE_LOOP_GROUPS}
        best = min(score, key=score.get)
        log(f"read group over the {which} ({', '.join(labels)}): {value} chosen (fastest "
            f"measured: {best}); geometric mean of device_loop / host_loop wall by group: "
            + ", ".join(f"{g}: {score[g]:.3f}" for g in DEVICE_LOOP_GROUPS))

    # propagate's three drivers (the plain round, no kernel): rounds and
    # reads; host_loop and device_loop against each other.
    p = problems["pb"]
    res = {}
    for driver in ("host_loop", "device_loop", "unrolled"):
        n = [0]
        res[driver] = rt.propagate(p, driver=driver, device=dev,
                                   on_sync=lambda: n.__setitem__(0, n[0] + 1))
        g = saved[1] if driver == "device_loop" else None
        log(f"propagate pb driver={driver}: rounds={res[driver].rounds.item()} "
            f"converged={res[driver].converged.item()} "
            f"infeasible={res[driver].infeasible.item()} reads={n[0]} wall "
            f"{med['propagate pb', driver, g]:.3f} ms (median of {DRIVER_TRIALS})")
    check_same(rt, "propagate pb device_loop", res["device_loop"], res["host_loop"], False,
               "its host_loop run")
    if res["device_loop"].rounds.item() != REFERENCE_ROUNDS["pb"]:
        fail(f"propagate pb device_loop took {res['device_loop'].rounds.item()} rounds")
    return runs


# ---------------------------------------------------------------------------
# Phase 13: the precision tiers (float32 forms, the early stop, two tiers)
# ---------------------------------------------------------------------------

# Instances whose n_pad (30,080) fits int16, so their float32 preps hold the
# compact index streams (int16 columns, int8 marks): pb and mixed at half the
# columns and rows.
COMPACT_SPECS = [
    ("pb30", "make_pseudo_boolean", dict(n=30_000, m=75_000, seed=0)),
    ("mixed30", "make_mixed", dict(m=75_000, n=30_000, seed=0, density=0.0005)),
]
# The two-tier contract of tests/test_precision.py: continuous bounds of the
# tiered run within this band (relative, 1 + |b|) of the float64-only run's.
F32_BAND = 1e-6
EARLY_STOP = dict(two_tier=False, stop_progress=0.05, patience=1)
TIER_TRIALS = 5
# The instance each float form's kernels-line entry is measured on.
TIER_PRIMARY = {
    "fused_scatter_round_tiles[f32]": "pb", "fused_scatter_round_tiles[f32c]": "pb30",
    "activities_gather_tiles[f32]": "mixed", "activities_gather_tiles[f32c]": "mixed30",
    "combine_chunk_partials_tiles[f32]": "mixed",
    "candidates_scatter_tiles[f32]": "mixed", "candidates_scatter_tiles[f32c]": "mixed30",
    "apply_updates_tiles[f32]": "pb", "apply_updates_tiles[f32+stop]": "pb",
    "apply_updates_tiles[f64+stop]": "pb",
}


def form_of(prep) -> str:
    """The tier form of a prep's D, A' and E: f64, f32 or f32c (compact)."""
    import torch

    if prep.d.val.dtype == torch.float64:
        return "f64"
    return "f32c" if prep.d.col.dtype == torch.int16 else "f32"


def f_stop_check(torch, tk, tref, ops, build, name, lb, ub, best, timed):
    """Kernel F with the early stop armed against its plain version on the
    candidates ``best`` of a round from ``lb``/``ub``: a round that merges
    them, then one with no candidate (its measure 0 stops the loop): bounds,
    handed-back planes and the whole carry (its progress bits included)
    bitwise.  Returns the timed row."""
    from repro_torch.core import carry as rt_carry

    cfg = ops.DEFAULT_CONFIG
    eps, outward, inf = cfg.eps_for(lb.dtype), cfg.outward_for(lb.dtype), cfg.inf
    # A threshold that only the second round's zero measure falls below.
    stop = rt_carry.EarlyStop(1e-30, 1)
    st_k, st_p = rt_carry.armed_state(lb.device), rt_carry.armed_state(lb.device)
    cur_k, cur_p = (lb.clone(), ub.clone()), (lb.clone(), ub.clone())
    empty = (torch.full_like(lb, -inf), torch.full_like(ub, inf))
    for cand in (best, empty):
        acc = (cand[0].clone(), cand[1].clone())
        got = tk.apply_updates_tiles(*cur_k, *acc, eps, inf, outward, carry=st_k, stop=stop)
        want = tref.merge_carry_ref(*cur_p, cand[0].clone(), cand[1].clone(), eps, inf, outward,
                                    st_p, 0, 1, stop)
        err = max_abs_err(torch, (*got[:2], st_k), (*want[:2], st_p))
        planes_clean(torch, acc, inf, f"{name}: F with the early stop kept a candidate")
        cur_p = want[:2]
    fields = st_k.tolist()
    if fields[rt_carry.GO] != 0 or fields[rt_carry.ROUNDS] != 2:
        fail(f"{name}: F with the early stop left the carry at {fields[:8]}")
    row = dict(instance=name, max_abs_err=err)
    if timed:
        armed = rt_carry.armed_state(lb.device)
        carry = armed.clone()
        lbw, ubw = lb.clone(), ub.clone()
        acc = (best[0].clone(), best[1].clone())
        partials = torch.empty(-(-lb.numel() // tref.MERGE_BLOCK), dtype=lb.dtype,
                               device=lb.device)
        reset = fresh_inputs(torch, [(lbw, lb), (ubw, ub), (acc[0], best[0]), (acc[1], best[1]),
                                     (carry, armed)])
        moved = dict(merge_bytes(torch, ops.bnd, lb, ub, best[0], best[1], eps, inf=inf),
                     carry=4 * 8, partials=2 * lb.element_size() * partials.numel())
        b_ms, b_by = bound(sum(moved.values()), 10 * lb.numel(),
                           F64_FLOPS if lb.dtype == torch.float64 else F32_FLOPS)
        run = lambda: tk.apply_updates_tiles(lbw, ubw, *acc, eps, inf, outward, carry=carry,
                                             stop=stop, partials=partials)
        row.update(ms=kernel_ms(torch, build, run, reset=reset),
                   wrapper_ms=call_ms(torch, run, reset),
                   plain_ms=time_ms(torch, lambda: tref.merge_carry_ref(
                       lb, ub, best[0].clone(), best[1].clone(), eps, inf, outward,
                       armed.clone(), 0, 1, stop)),
                   bound_ms=b_ms, bound_by=b_by, bytes=moved)
    return row


def tier_kernel_rows(torch, tk, tref, ops, build, problems, preps32, preps64, measured):
    """Each float form of D, A', the combine, E and F (and F with the early
    stop) against its plain version at the instances' initial bounds,
    timed, beside the float64 form on the same instance (phase 1's rows
    where it timed the instance).  Returns {form key: {instance: row}}."""
    rows = {}
    for name, prep in preps32.items():
        got = check_kernels(torch, tk, tref, ops, build, name, problems[name], prep, prep.lb0,
                            prep.ub0, timed=True, plain_trials=2)
        if all(name in measured.get(k, {}) for k in got):
            base = {k: measured[k][name] for k in got}
        else:
            base = check_kernels(torch, tk, tref, ops, build, name, problems[name],
                                 preps64[name], preps64[name].lb0, preps64[name].ub0,
                                 timed=True, plain_trials=2)
        form = form_of(prep)
        for kname, r in got.items():
            key = f"{kname}[{'f32' if kname in NO_INDEX_STREAMS else form}]"
            r["float64_ms"] = base[kname]["ms"]
            rows.setdefault(key, {})[name] = r
            log(f"kernel {key} on {name}: max_abs_err={r['max_abs_err']} ms={r['ms']:.4f} "
                f"(float64 form {r['float64_ms']:.4f}) wrapper_ms={r['wrapper_ms']:.4f} "
                f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} ({r['bound_by']}, "
                f"{sum(r['bytes'].values())} B: {r['bytes']})")
        if prep.fits_one_chunk:
            for label, pr in (("f32", prep), ("f64", preps64[name])):
                best = tref.fused_scatter_round_tiles_ref(
                    pr.d.val, pr.d.col, pr.ii_g, pr.lhs_g, pr.rhs_g, pr.lb0, pr.ub0, pr.n_pad,
                    ops.DEFAULT_CONFIG.int_eps)
                r = f_stop_check(torch, tk, tref, ops, build, name, pr.lb0, pr.ub0, best,
                                 timed=name == "pb")
                if "ms" in r:
                    key = f"apply_updates_tiles[{label}+stop]"
                    rows.setdefault(key, {})[name] = r
                    log(f"kernel {key} on {name}: max_abs_err={r['max_abs_err']} "
                        f"ms={r['ms']:.4f} wrapper_ms={r['wrapper_ms']:.4f} "
                        f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} "
                        f"({r['bound_by']}, {sum(r['bytes'].values())} B: {r['bytes']})")
                else:
                    log(f"kernel apply_updates_tiles[{label}+stop] on {name}: bitwise its plain "
                        "version over two rounds (carry included)")
    rows["apply_updates_tiles[f64+stop]"]["pb"]["float64_ms"] = None
    rows["apply_updates_tiles[f32+stop]"]["pb"]["float64_ms"] = (
        rows["apply_updates_tiles[f64+stop]"]["pb"]["ms"])
    return rows


# Kernels of the tier whose form does not depend on the index streams.
NO_INDEX_STREAMS = ("apply_updates_tiles", "combine_chunk_partials_tiles")


def check_tier_contract(torch, np, name, p, tiered, base):
    """Two-tier against float64-only: the same verdict; where feasible,
    integer bounds bitwise and continuous ones within F32_BAND (1 + |b|);
    at least one fp32 round.  Returns the largest relative gap."""
    if bool(tiered.infeasible) != bool(base.infeasible):
        fail(f"two-tier {name}: infeasible {bool(tiered.infeasible)} != {bool(base.infeasible)}")
    if int(tiered.tier_rounds) < 1:
        fail(f"two-tier {name}: no fp32 round ran")
    if bool(base.infeasible):
        return 0.0
    is_int = np.asarray(p.is_int, bool)
    gap = 0.0
    for f in ("lb", "ub"):
        t = getattr(tiered, f).cpu().numpy()
        b = getattr(base, f).cpu().numpy()
        if not np.array_equal(t[is_int], b[is_int]):
            fail(f"two-tier {name}: integer {f} differ from the float64-only run")
        rel = np.abs(t - b) / (1.0 + np.abs(b))
        if (rel > F32_BAND).any():
            fail(f"two-tier {name}: continuous {f} off by {rel.max():.3e} relative")
        gap = max(gap, float(rel.max(initial=0.0)))
    return gap


def precision_phase(torch, np, rt, td, tk, tref, ops, build, dev, problems, preps, results, pbf,
                    measured):
    """Phase 13: the precision tiers.  Returns ({form key: (row, instance)},
    {form key: launches on the phase's main-path runs}, the instances)."""
    t_phase = time.perf_counter()
    probs = {"pb": problems["pb"], "mixed": problems["mixed"], "pbf": pbf}
    for name, gen, kw in COMPACT_SPECS:
        t = time.perf_counter()
        probs[name] = getattr(td, gen)(**kw)
        log(f"instance {name}: m={probs[name].m} n={probs[name].n} nnz={probs[name].nnz} "
            f"generate={time.perf_counter() - t:.1f}s")
    kernel_names = ("pb", "mixed", "pb30", "mixed30")
    preps32 = {n: rt.prepare_block_ell(probs[n], dtype=torch.float32, device=dev)
               for n in kernel_names}
    preps64 = {n: preps[n] if n in preps else rt.prepare_block_ell(probs[n], device=dev)
               for n in kernel_names}
    for n, pr in preps32.items():
        log(f"float32 prep {n}: n_pad={pr.n_pad} col {pr.d.col.dtype} ii_g {pr.ii_g.dtype} "
            f"form {form_of(pr)} fits_one_chunk={pr.fits_one_chunk}")
    rows = tier_kernel_rows(torch, tk, tref, ops, build, probs, preps32, preps64, measured)

    policy = rt.core.TierPolicy()
    stop = rt.core.TierPolicy(**EARLY_STOP)
    tk.reset_launch_counts()
    # Float32-only fixed points: each driver against the plain float32 path.
    for n in kernel_names:
        plain = rt.propagate_block_ell(probs[n], dtype=torch.float32, driver="host_loop",
                                       use_kernels=False, device=dev)
        out = {}
        for driver in ("host_loop", "device_loop"):
            out[driver] = rt.propagate_block_ell(probs[n], dtype=torch.float32, driver=driver,
                                                 device=dev)
            check_same(rt, f"float32 {n} {driver}", out[driver], plain, True,
                       "the plain float32 path")
            if not torch.equal(out[driver].progress, plain.progress):
                fail(f"float32 {n} {driver}: progress differs from the plain float32 path")
        r = out["device_loop"]
        log(f"float32 {n}: rounds={r.rounds.item()} converged={r.converged.item()} "
            f"infeasible={r.infeasible.item()}; both drivers bitwise the plain float32 path")
    # Two tiers against float64-only.
    tiered = {}
    for n in ("pb", "pbf", "mixed"):
        base = results[n] if n in results else rt.propagate_block_ell(probs[n], device=dev)
        out = {d: rt.propagate_block_ell(probs[n], policy=policy, driver=d, device=dev)
               for d in ("host_loop", "device_loop")}
        check_same(rt, f"two-tier {n} device_loop", out["device_loop"], out["host_loop"], True,
                   "its host_loop run")
        gap = check_tier_contract(torch, np, n, probs[n], out["device_loop"], base)
        r = tiered[n] = out["device_loop"]
        path = "guard (fp32 verdict infeasible, endgame from the root)" if (
            r.rounds.item() == base.rounds.item() and bool(base.infeasible)) else "promotion"
        log(f"two-tier {n}: rounds={r.rounds.item()} tier_rounds={r.tier_rounds.item()} "
            f"infeasible={r.infeasible.item()} (float64-only: rounds={base.rounds.item()}); "
            f"path: {path}; largest continuous gap {gap:.3e}")
    # The early stop, both dtypes: host_loop against device_loop.
    for n, dtype in (("pb", torch.float64), ("mixed", torch.float64), ("pbf", torch.float64),
                     ("mixed30", torch.float32)):
        out = {d: rt.propagate_block_ell(probs[n], policy=stop, dtype=dtype, driver=d, device=dev)
               for d in ("host_loop", "device_loop")}
        check_same(rt, f"early stop {n}", out["device_loop"], out["host_loop"], True,
                   "its host_loop run")
        if not torch.equal(out["device_loop"].progress, out["host_loop"].progress):
            fail(f"early stop {n}: progress differs between the drivers")
        r = out["device_loop"]
        log(f"early stop {n} ({str(dtype).removeprefix('torch.')}): rounds={r.rounds.item()} "
            f"converged={r.converged.item()} progress={r.progress.item():.6g}; device_loop "
            "bitwise host_loop")
    launches = tk.form_counts()
    log(f"phase 13 launches by form: {json.dumps(launches)}")
    missing = [k for k in TIER_PRIMARY if launches.get(k, 0) <= 0]
    if missing:
        fail(f"the precision tiers' runs never launched {missing}")

    # Walls by driver: float64-only, float32-only and two-tier, every
    # variant once per trial in an order that rotates between trials.
    variants = [("float64", {}), ("float32", dict(dtype=torch.float32)), ("two-tier",
                                                                           dict(policy=policy))]
    runs = [(n, v, d) for n in ("pb", "pbf", "mixed") for v in variants
            for d in ("host_loop", "device_loop")]
    samples = {}
    for trial in range(TIER_TRIALS):
        order = runs[trial % len(runs):] + runs[: trial % len(runs)]
        for n, (label, kw), d in order:
            samples.setdefault((n, label, d), []).append(wall_ms(
                torch, lambda: rt.propagate_block_ell(probs[n], driver=d, device=dev, **kw)))
    for n in ("pb", "pbf", "mixed"):
        cells = "; ".join(
            f"{label} " + ", ".join(f"{d} {statistics.median(samples[n, label, d]):.3f}"
                                    for d in ("host_loop", "device_loop"))
            for label, _ in variants)
        log(f"tier walls {n} (ms, medians of {TIER_TRIALS}): {cells}")
    out_rows = {key: (rows[key][inst], inst) for key, inst in TIER_PRIMARY.items()}
    for key, (r, _) in out_rows.items():
        r["max_abs_err"] = max(v["max_abs_err"] for v in rows[key].values())
    log(f"phase 13: {time.perf_counter() - t_phase:.1f} s")
    return out_rows, {key: launches.get(key, 0) for key in TIER_PRIMARY}, probs


# ---------------------------------------------------------------------------
# Phase 14: the precision tiers on the batched engines
# ---------------------------------------------------------------------------

# The float32 forms of #8, #9, #10 and the node-batched A', combine and E,
# and #9 with the early stop, each with the instance its kernels-line entry
# is measured on.
BATCH_TIER_PRIMARY = {
    "batched_fused_scatter_round_tiles[f32]": "fused bucket, 4 of 4 active",
    "node_fused_scatter_round_tiles[f32]": f"pbf pool, 8 of {POOL} active",
    "node_fused_scatter_round_tiles[f32c]": f"pb30 pool, 8 of {POOL} active",
    "node_activities_gather_tiles[f32]": f"pbf K=4 pool, 8 of {POOL} active",
    "node_activities_gather_tiles[f32c]": f"pb30 K=4 pool, 8 of {POOL} active",
    "node_combine_chunk_partials_tiles[f32]": f"pbf K=4 pool, 8 of {POOL} active",
    "node_candidates_scatter_tiles[f32]": f"pbf K=4 pool, 8 of {POOL} active",
    "node_candidates_scatter_tiles[f32c]": f"pb30 K=4 pool, 8 of {POOL} active",
    "apply_updates_batch_tiles[f32]": f"pbf pool, 8 of {POOL} active",
    "apply_updates_batch_tiles[f64+stop]": f"pbf pool, 8 of {POOL} active",
    "apply_updates_batch_tiles[f32+stop]": f"pbf pool, 8 of {POOL} active",
}
BATCH_STOP = dict(stop_progress=0.05, patience=1)
# Nodes of the phase's propagate_nodes runs (random branchings of the root).
TIER_NODES = 8


def tier_row(torch, build, got, want, fn_k, fn_p, moved, n_ops, dtype, reset=None,
             plain_reps=3, float64_ms=None):
    """A float form against its plain version (equal as values), timed as
    :func:`measured_row` times a float64 kernel, its bound at the rate of
    ``dtype``, beside the float64 form's time ``float64_ms``."""
    flops = F64_FLOPS if dtype == torch.float64 else F32_FLOPS
    b_ms, b_by = bound(sum(moved.values()), n_ops, flops)
    return dict(max_abs_err=max_abs_err(torch, got, want),
                ms=kernel_ms(torch, build, fn_k, reset=reset),
                wrapper_ms=(call_ms(torch, fn_k, reset) if reset is not None
                            else time_ms(torch, fn_k, reps=3, trials=3)),
                plain_ms=time_ms(torch, fn_p, reps=1, trials=plain_reps),
                bound_ms=b_ms, bound_by=b_by, bytes=moved, float64_ms=float64_ms)


def log_tier_row(key, inst, r):
    f64 = r.get("float64_ms")
    log(f"kernel {key} on {inst}: max_abs_err={r['max_abs_err']} ms={r['ms']:.4f} "
        f"(float64 form {'not measured' if f64 is None else f'{f64:.4f}'}) "
        f"wrapper_ms={r['wrapper_ms']:.4f} plain_ms={r['plain_ms']:.4f} "
        f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}, {sum(r['bytes'].values())} B: "
        f"{r['bytes']})")


def pool_mask(torch, n_act, dev):
    act = torch.zeros(POOL, dtype=torch.bool, device=dev)
    if n_act:
        act[:: POOL // n_act] = True
    return act


def stream_bytes(prep, nnz: int) -> dict:
    """Bytes of a node round's shared tile stream at the prep's widths:
    the values at the nonzeros, the ids per nonzero (2 B + 1 B compact, 4 B
    + 4 B else), the length and sides per chunk."""
    d = prep.d
    chunks = d.val.shape[0] * d.val.shape[1]
    v = d.val.element_size()
    return dict(val=v * nnz, col_ii=(d.col.element_size() + prep.ii_g.element_size()) * nnz,
                rows=(4 + 2 * v) * chunks)


def batched_tier_kernels(torch, np, rt, tk, tref, ops, build, dev, pops, pbf, prep8_64, pb30,
                         measured):
    """Phase 14's kernel checks.  Returns {form key: {instance: row}}."""
    cfg = ops.DEFAULT_CONFIG
    f32 = torch.float32
    rows = {}

    def add(key, inst, r):
        rows.setdefault(key, {})[inst] = r
        log_tier_row(key, inst, r)

    # #8 at float32 on phase 9's fused bucket, 2 and 4 of 4 active.
    (batch,) = ops.packed_problems(pops["fused"])
    prep = ops.prepare_problem_batch(batch, f32, device=dev)
    d = prep.d
    acc = tk.accumulator_planes(d.lb0)
    clean = lambda: (acc[0].fill_(-cfg.inf), acc[1].fill_(cfg.inf))
    kw = dict(acc=acc, chunk_len=d.chunk_len, max_chunk_len=prep.max_chunk_len, chunks=d.chunks)
    for n_act in (2, batch.size):
        act_h = np.zeros(batch.size, bool)
        act_h[:: max(1, batch.size // n_act)][:n_act] = True
        act = torch.as_tensor(act_h, device=dev)
        args = (d.val, d.col, d.ii_g, d.lhs_g, d.rhs_g, d.lb0, d.ub0, d.tile_inst, act,
                prep.n_pad, cfg.int_eps)
        clean()
        got = tuple(x.clone() for x in tk.batched_fused_scatter_round_tiles(*args, **kw))
        plain = lambda: tref.batched_fused_scatter_round_ref(  # noqa: E731
            d.val, d.col_g, d.ii_g, d.lhs_g, d.rhs_g, d.lb0, d.ub0, prep.n_pad, cfg.int_eps,
            active=act)
        m64, nnz, _ = batched_fused_bytes(np, batch, act_h)
        moved = dict(val=m64["val"] // 2, col_ii=m64["col_ii"], rows=m64["rows"] * 12 // 20,
                     planes=m64["planes"] // 2, maps=m64["maps"])
        shape = f"fused bucket, {n_act} of {batch.size} active"
        add("batched_fused_scatter_round_tiles[f32]", shape, tier_row(
            torch, build, got, plain(), lambda: tk.batched_fused_scatter_round_tiles(*args, **kw),
            plain, moved, 16 * nnz, f32, reset=clean, plain_reps=1,
            float64_ms=measured["batched_fused_scatter_round_tiles"][shape]["ms"]))
    clean()

    # The flat A', combine and E at float32 on phase 9's multi-chunk bucket
    # (global int32 columns over the (B * n_pad,) planes).
    (mbatch,) = ops.packed_problems(pops["multi-chunk"])
    mprep = ops.prepare_problem_batch(mbatch, f32, device=dev)
    md = mprep.d
    width = mprep.size * mprep.n_pad
    lbf, ubf = md.lb0.reshape(-1), md.ub0.reshape(-1)
    want_p = tref.activities_gather_tiles_ref(md.val, md.col_g, lbf, ubf, width)
    err = max_abs_err(torch, tk.activities_gather_tiles(md.val, md.col_g, lbf, ubf, width,
                                                        chunk_len=md.chunk_len), want_p)
    want_a = tref.combine_chunk_partials_ref(*want_p, md.chunk_row, mprep.row_start)
    err = max(err, max_abs_err(torch, tk.combine_chunk_partials_tiles(
        *want_p, md.chunk_row, mprep.row_start, classes=mprep.seg_classes), want_a))
    e_args = (md.val, md.col_g, md.ii_g, *want_a, md.lhs_g, md.rhs_g, lbf, ubf, width,
              cfg.int_eps)
    err = max(err, max_abs_err(torch, tk.candidates_scatter_tiles(*e_args,
                                                                  chunk_len=md.chunk_len),
                               tref.candidates_scatter_tiles_ref(*e_args)))
    log(f"flat A', combine and E at float32 on the multi-chunk bucket ({tuple(md.val.shape)} "
        f"tiles, {width} columns): bitwise their plain versions (max_abs_err {err})")

    # #10 at float32 on pbf (n_pad 60,032: int32 ids) and on pb30 (n_pad
    # 30,080: the compact ids), then #9 at float32 and #9's stop forms.
    lb_h, ub_h = node_pool(np, rt, pbf, POOL, seed=3)
    lb30, ub30 = node_pool(np, rt, pb30, POOL, seed=3)
    node_sets = [
        ("pbf", rt.prepare_block_ell(pbf, tile_width=SOLVER_TILE_WIDTH, dtype=f32, device=dev),
         (lb_h, ub_h), prep8_64),
        ("pb30", rt.prepare_block_ell(pb30, tile_width=SOLVER_TILE_WIDTH, dtype=f32, device=dev),
         (lb30, ub30), rt.prepare_block_ell(pb30, tile_width=SOLVER_TILE_WIDTH, device=dev)),
    ]
    best8 = {}
    for name, pr, (lbh, ubh), pr64 in node_sets:
        form = "f32c" if pr.d.col.dtype == torch.int16 else "f32"
        lbp, ubp = ops._node_planes(pr, lbh, ubh)
        nacc = tk.accumulator_planes(lbp)
        sentinels = lambda nacc=nacc: (nacc[0].fill_(-cfg.inf), nacc[1].fill_(cfg.inf))
        nnz = int((pr.d.val != 0).sum().item())
        for n_act in (8, POOL):
            act = pool_mask(torch, n_act, dev)
            args = (pr.d.val, pr.d.col, pr.ii_g, pr.lhs_g, pr.rhs_g, lbp, ubp, act, pr.n_pad,
                    cfg.int_eps)
            nkw = dict(acc=nacc, chunk_len=pr.chunk_len, max_chunk_len=pr.max_chunk_len)
            sentinels()
            got = tuple(x.clone() for x in tk.node_fused_scatter_round_tiles(*args, **nkw))
            want = tref.node_fused_scatter_round_ref(*args[:7], pr.n_pad, cfg.int_eps,
                                                     active=act)
            shape = f"{name} pool, {n_act} of {POOL} active"
            if n_act != 8:
                log(f"kernel node_fused_scatter_round_tiles[{form}] on {shape}: max_abs_err="
                    f"{max_abs_err(torch, got, want)}")
                continue
            best8[name] = (want, act, lbp, ubp)
            if name == "pbf":
                f64 = measured["node_fused_scatter_round_tiles"][shape]["ms"]
            else:  # the float64 form on the same pool and nodes
                lb64, ub64 = ops._node_planes(pr64, lbh, ubh)
                acc64 = tk.accumulator_planes(lb64)
                a64 = (pr64.d.val, pr64.d.col, pr64.ii_g, pr64.lhs_g, pr64.rhs_g, lb64, ub64, act,
                       pr64.n_pad, cfg.int_eps)
                k64 = dict(acc=acc64, chunk_len=pr64.chunk_len, max_chunk_len=pr64.max_chunk_len)
                f64 = kernel_ms(torch, build, lambda: tk.node_fused_scatter_round_tiles(
                    *a64, **k64), reset=lambda: (acc64[0].fill_(-cfg.inf),
                                                 acc64[1].fill_(cfg.inf)))
            moved = dict(stream_bytes(pr, nnz), bounds=8 * n_act * pr.n_pad,
                         out=8 * n_act * pr.n_pad)
            add(f"node_fused_scatter_round_tiles[{form}]", shape, tier_row(
                torch, build, got, want, lambda: tk.node_fused_scatter_round_tiles(*args, **nkw),
                lambda: tref.node_fused_scatter_round_ref(*args[:7], pr.n_pad, cfg.int_eps,
                                                          active=act),
                moved, 16 * nnz * n_act, f32, reset=sentinels, plain_reps=1, float64_ms=f64))
        sentinels()

    # #9 at float32 on the pbf pool's #10 candidates, 8 active.
    want, act, lbp, ubp = best8["pbf"]
    eps, outward = cfg.eps_for(f32), cfg.outward_for(f32)
    shape = f"pbf pool, 8 of {POOL} active"
    lbw, ubw, blw, buw = lbp.clone(), ubp.clone(), want[0].clone(), want[1].clone()
    reset = fresh_inputs(torch, [(lbw, lbp), (ubw, ubp), (blw, want[0]), (buw, want[1])])
    got_m = tk.apply_updates_batch_tiles(lbp.clone(), ubp.clone(), want[0].clone(),
                                         want[1].clone(), act, eps, cfg.inf, outward)
    want_m = ops.bnd.apply_updates_batch(lbp, ubp, *want, eps, cfg.inf, outward, active=act)
    moved = dict(merge_bytes(torch, ops.bnd, lbp, ubp, *want, eps, act, cfg.inf), flags=2 * POOL)
    add("apply_updates_batch_tiles[f32]", shape, tier_row(
        torch, build, got_m, want_m,
        lambda: tk.apply_updates_batch_tiles(lbw, ubw, blw, buw, act, eps, cfg.inf, outward),
        lambda: ops.bnd.apply_updates_batch(lbp, ubp, *want, eps, cfg.inf, outward, active=act),
        moved, 6 * 8 * lbp.shape[1], f32, reset=reset, plain_reps=3,
        float64_ms=measured["apply_updates_batch_tiles"][shape]["ms"]))
    stop_rows = merge_stop_checks(torch, np, tk, tref, ops, build, dev, pbf, prep8_64,
                                  node_sets[0][1], lb_h, ub_h)
    for key, r in stop_rows.items():
        add(key, shape, r)

    # The node-batched A', combine and E at float32 on pbf (int32 ids) and
    # pb30 (compact) at tile width 4.
    for name, p, (lbh, ubh) in (("pbf", pbf, (lb_h, ub_h)), ("pb30", pb30, (lb30, ub30))):
        pr = rt.prepare_block_ell(p, tile_width=MULTI_CHUNK_TILE_WIDTH, dtype=f32, device=dev)
        form = "f32c" if pr.d.col.dtype == torch.int16 else "f32"
        t, r, _ = pr.d.val.shape
        chunks, nnz = t * r, int((pr.d.val != 0).sum().item())
        lbp, ubp = ops._node_planes(pr, lbh, ubh)
        for n_act in (8, POOL):
            act = pool_mask(torch, n_act, dev)
            shape = f"{name} K={MULTI_CHUNK_TILE_WIDTH} pool, {n_act} of {POOL} active"
            on = lambda xs, act=act: tuple(x[act] for x in xs)
            a_args = (pr.d.val, pr.d.col, lbp, ubp, act, pr.n_pad)
            parts = tref.node_activities_gather_ref(*a_args)
            got_p = tk.node_activities_gather_tiles(*a_args, chunk_len=pr.chunk_len)
            c_args = (*parts, pr.d.chunk_row, pr.row_start, act)
            aggs = tref.node_combine_chunk_partials_ref(*c_args)
            got_a = tk.node_combine_chunk_partials_tiles(*c_args, classes=pr.seg_classes)
            e_args = (pr.d.val, pr.d.col, pr.ii_g, *aggs, pr.lhs_g, pr.rhs_g, lbp, ubp, act,
                      pr.n_pad, cfg.int_eps)
            got_e = tk.node_candidates_scatter_tiles(*e_args, chunk_len=pr.chunk_len)
            want_e = tref.node_candidates_scatter_ref(*e_args)
            if n_act != 8:
                err = max(max_abs_err(torch, on(got_p), on(parts)),
                          max_abs_err(torch, on(got_a), on(aggs)),
                          max_abs_err(torch, got_e, want_e))
                log(f"kernels node_activities_gather_tiles[{form}], "
                    f"node_combine_chunk_partials_tiles[f32], node_candidates_scatter_tiles"
                    f"[{form}] on {shape}: max_abs_err={err}")
                continue
            base = lambda k: (measured[k].get(shape, {}).get("ms") if name == "pbf" else None)
            ids = stream_bytes(pr, nnz)
            add(f"node_activities_gather_tiles[{form}]", shape, tier_row(
                torch, build, on(got_p), on(parts),
                lambda: tk.node_activities_gather_tiles(*a_args, chunk_len=pr.chunk_len),
                lambda: tref.node_activities_gather_ref(*a_args),
                dict(val=ids["val"], col=pr.d.col.element_size() * nnz, chunk_len=4 * chunks,
                     bounds=8 * n_act * pr.n_pad, out=16 * n_act * chunks),
                4 * nnz * n_act, f32, float64_ms=base("node_activities_gather_tiles")))
            if form == "f32":
                add("node_combine_chunk_partials_tiles[f32]", shape, tier_row(
                    torch, build, on(got_a), on(aggs),
                    lambda: tk.node_combine_chunk_partials_tiles(*c_args,
                                                                 classes=pr.seg_classes),
                    lambda: tref.node_combine_chunk_partials_ref(*c_args),
                    dict(partials=16 * n_act * chunks, row_start=8 * (pr.m + 2),
                         classes=4 * (pr.m + 1), out=16 * n_act * chunks, mask=POOL),
                    0, f32, float64_ms=base("node_combine_chunk_partials_tiles")))
            else:
                max_abs_err(torch, on(got_a), on(aggs))
            add(f"node_candidates_scatter_tiles[{form}]", shape, tier_row(
                torch, build, got_e, want_e,
                lambda: tk.node_candidates_scatter_tiles(*e_args, chunk_len=pr.chunk_len),
                lambda: tref.node_candidates_scatter_ref(*e_args),
                dict(ids, aggregates=16 * n_act * chunks, bounds=8 * n_act * pr.n_pad,
                     out=8 * n_act * pr.n_pad),
                12 * nnz * n_act, f32, float64_ms=base("node_candidates_scatter_tiles")))
    return rows


def merge_stop_checks(torch, np, tk, tref, ops, build, dev, pbf, prep64, prep32, lb_h, ub_h):
    """#9 with the early stop's measure, float64 and float32, on the pbf
    pool with 8 and POOL rows active, through two rounds of a stop (the #10
    candidates of the pool, then none: a measure of 0): bounds, flags, each
    active row's block partials and measure bitwise the plain version's,
    and the streak ``flat`` folded from either the same; inactive rows'
    entries untouched, the ticket back at 0.  Timed at 8 active.  Returns
    {form key: row}."""
    cfg = ops.DEFAULT_CONFIG
    out = {}
    for dt, prep in ((torch.float64, prep64), (torch.float32, prep32)):
        eps, outward = cfg.eps_for(dt), cfg.outward_for(dt)
        lbp, ubp = ops._node_planes(prep, lb_h, ub_h)
        blocks = -(-prep.n_pad // tref.MERGE_BLOCK)
        key = f"apply_updates_batch_tiles[{'f64' if dt == torch.float64 else 'f32'}+stop]"
        for n_act in (8, POOL):
            act = pool_mask(torch, n_act, dev)
            best = tref.node_fused_scatter_round_ref(
                prep.d.val, prep.d.col, prep.ii_g, prep.lhs_g, prep.rhs_g, lbp, ubp, prep.n_pad,
                cfg.int_eps, active=act)
            none = (torch.full_like(lbp, -cfg.inf), torch.full_like(ubp, cfg.inf))
            prog_k = torch.zeros(POOL, dtype=dt, device=dev)
            prog_p = prog_k.clone()
            part_k = torch.zeros((POOL, blocks), dtype=dt, device=dev)
            ticket = torch.zeros(1, dtype=torch.int32, device=dev)
            flat_k = torch.zeros(POOL, dtype=torch.int32, device=dev)
            flat_p = flat_k.clone()
            lk, uk, lp, up = lbp.clone(), ubp.clone(), lbp, ubp
            for cand in (best, none):
                got = tk.apply_updates_batch_tiles(lk, uk, cand[0].clone(), cand[1].clone(), act,
                                                   eps, cfg.inf, outward, progress=prog_k,
                                                   partials=part_k, ticket=ticket)
                new = ops.bnd.apply_updates_batch(lp, up, *cand, eps, cfg.inf, outward,
                                                  active=act)
                blocks_p, rows_p = tref.merge_rows_progress(lp, up, new[0], new[1])
                prog_p = torch.where(act, rows_p, prog_p)
                err = max_abs_err(torch, (*got, prog_k, part_k[act]),
                                  (*new, prog_p, blocks_p[act]))
                for flat, prog in ((flat_k, prog_k), (flat_p, prog_p)):
                    flat.copy_(torch.where(act, torch.where(prog < BATCH_STOP["stop_progress"],
                                                            flat + 1, 0), flat))
                if not torch.equal(flat_k, flat_p) or int(ticket.item()) != 0:
                    fail(f"{key}: flat or the ticket differs from the plain fold")
                lk, uk, lp, up = got[0], got[1], new[0], new[1]
            if bool((part_k[~act] != 0).any()) or bool((prog_k[~act] != 0).any()):
                fail(f"{key}: an inactive row's partials or measure were written")
            if not bool((flat_k[act] == 1).all()):
                fail(f"{key}: the round without candidates did not count as low progress")
            log(f"kernel {key} on pbf pool, {n_act} of {POOL} active: two rounds of a stop "
                f"bitwise the plain version (bounds, flags, partials, measure {prog_k[act][:2]}, "
                f"flat {flat_k[act][:2].tolist()}); max_abs_err={err}")
            if n_act != 8:
                continue
            lbw, ubw = lbp.clone(), ubp.clone()
            blw, buw = best[0].clone(), best[1].clone()
            reset = fresh_inputs(torch, [(lbw, lbp), (ubw, ubp), (blw, best[0]), (buw, best[1])])
            moved = dict(merge_bytes(torch, ops.bnd, lbp, ubp, *best, eps, act, cfg.inf),
                         flags=2 * POOL, partials=2 * lbp.element_size() * n_act * blocks,
                         measure=lbp.element_size() * n_act)
            plain = lambda: tref.merge_rows_progress(  # noqa: E731
                lbp, ubp, *ops.bnd.apply_updates_batch(lbp, ubp, *best, eps, cfg.inf, outward,
                                                       active=act)[:2])
            out[key] = tier_row(
                torch, build, (prog_k,), (prog_p,),
                lambda: tk.apply_updates_batch_tiles(lbw, ubw, blw, buw, act, eps, cfg.inf,
                                                     outward, progress=prog_k, partials=part_k,
                                                     ticket=ticket),
                plain, moved, 16 * n_act * lbp.shape[1], dt, reset=reset)
    out["apply_updates_batch_tiles[f32+stop]"]["float64_ms"] = (
        out["apply_updates_batch_tiles[f64+stop]"]["ms"])
    return out


def check_tier_runs(torch, np, label, mode, got, base, is_int):
    """Batched tier runs against their float64-only runs, per instance or
    node (``got``/``base``: lists of ``(lb, ub, rounds, converged,
    infeasible, tier_rounds)``).  Float32: never falsely infeasible (an
    fp32 infeasible verdict only where float64 says so).  Two tiers: the
    same verdict; where feasible, integer bounds bitwise, continuous ones
    within F32_BAND (1 + |b|), and at least one fp32 round.  The early stop:
    no more rounds than float64; a run the stop did not cut (converged)
    bitwise the float64 run.  Returns the largest relative gap."""
    is_int = np.asarray(is_int, bool)
    gap = 0.0
    for i, (g, b) in enumerate(zip(got, base)):
        g_lb, g_ub, g_rounds, g_conv, g_inf, g_tier = g
        b_lb, b_ub, b_rounds, _, b_inf, _ = b
        where = f"{label} #{i}"
        if mode == "float32" and bool(g_inf) and not bool(b_inf):
            fail(f"{where}: float32 infeasible where float64 is feasible")
        if mode == "early stop":
            if int(g_rounds) > int(b_rounds):
                fail(f"{where}: the early stop ran past the float64 run's rounds")
            if bool(g_conv) and not (int(g_rounds) == int(b_rounds) and torch.equal(g_lb, b_lb)
                                     and torch.equal(g_ub, b_ub)):
                fail(f"{where}: a run the stop did not cut differs from the float64 run")
        if mode != "two-tier":
            continue
        if bool(g_inf) != bool(b_inf):
            fail(f"{where}: infeasible {bool(g_inf)} != float64-only {bool(b_inf)}")
        if bool(b_inf):
            continue
        if int(g_tier) < 1:
            fail(f"{where}: no fp32 round ran")
        for t, w in ((g_lb, b_lb), (g_ub, b_ub)):
            t, w = t.double().cpu().numpy(), w.double().cpu().numpy()
            if not np.array_equal(t[is_int], w[is_int]):
                fail(f"{where}: integer bounds differ from the float64-only run")
            rel = np.abs(t - w) / (1.0 + np.abs(w))
            if (rel > F32_BAND).any():
                fail(f"{where}: continuous bounds off by {rel.max():.3e} relative")
            gap = max(gap, float(rel.max(initial=0.0)))
    return gap


def same_results(torch, label, got, want, fields):
    for i, (g, w) in enumerate(zip(got, want)):
        for f in fields:
            a, b = getattr(g, f), getattr(w, f)
            if isinstance(a, torch.Tensor) and a.is_floating_point():
                ok = torch.equal(a.isnan(), b.isnan()) and torch.equal(a.nan_to_num(),
                                                                      b.nan_to_num())
            else:
                ok = torch.equal(torch.as_tensor(a), torch.as_tensor(b))
            if not ok:
                fail(f"{label}: #{i} {f} differs from the plain float path")


def batch_tiers_phase(torch, np, rt, tk, tref, ops, build, dev, pops, pbf, prep8_64, probs13,
                      results, measured):
    """Phase 14: the precision tiers on the batched engines.  The float32
    forms of #8, #9, #10 and the node-batched A', combine and E and #9's
    early-stop forms against their plain versions, timed; then, with the
    launch counters at zero, propagate_batch, propagate_nodes and a short
    service stream at float32, under TierPolicy() and with the early stop,
    against the plain path (bitwise) and the float64-only runs.  Returns
    ({form key: (row, instance)}, {form key: launches on the phase's
    main-path runs})."""
    t_phase = time.perf_counter()
    f32 = torch.float32
    pb30 = probs13["pb30"]
    rows = batched_tier_kernels(torch, np, rt, tk, tref, ops, build, dev, pops, pbf, prep8_64,
                                pb30, measured)
    policy = rt.core.TierPolicy()
    fields = ("lb", "ub", "rounds", "converged", "infeasible", "progress", "tier_rounds")
    modes_kw = {"float32": dict(dtype=f32), "two-tier": dict(policy=policy),
                "early stop": dict(BATCH_STOP)}
    launches = {}

    def main_path(fn):
        """Run one main-path call, adding its launches by form."""
        before = tk.form_counts()
        out = fn()
        for k, v in tk.form_counts().items():
            launches[k] = launches.get(k, 0) + v - before.get(k, 0)
        return out

    # propagate_batch on phase 9's fused and multi-chunk buckets.
    for bucket, modes in (("fused", ("float32", "two-tier", "early stop")),
                          ("multi-chunk", ("float32",))):
        pop = pops[bucket]
        base = rt.propagate_batch(pop, device=dev)
        for mode in modes:
            kw = modes_kw[mode]
            got = main_path(lambda: rt.propagate_batch(pop, device=dev, **kw))
            plain = rt.propagate_batch(pop, device=dev, use_kernels=False, **kw)
            label = f"batch {bucket} {mode}"
            same_results(torch, label, got, plain, fields)
            for p, g, b in zip(pop, got, base):
                check_tier_runs(torch, np, label, mode,
                                [(g.lb, g.ub, g.rounds, g.converged, g.infeasible,
                                  g.tier_rounds)],
                                [(b.lb, b.ub, b.rounds, b.converged, b.infeasible,
                                  b.tier_rounds)], p.is_int)
            log(f"{label}: rounds {[int(r.rounds) for r in got]} (float64-only "
                f"{[int(r.rounds) for r in base]}), tier_rounds "
                f"{[int(r.tier_rounds) for r in got]}, converged "
                f"{[bool(r.converged) for r in got]}, infeasible "
                f"{[bool(r.infeasible) for r in got]} (float64-only "
                f"{[bool(r.infeasible) for r in base]}); bitwise the plain path")
    # propagate_nodes on pbf (int32 ids) and pb30 (compact), at the solver's
    # tile width and at the multi-chunk width.
    node_runs = [("pbf", pbf, SOLVER_TILE_WIDTH, ("float32", "two-tier", "early stop")),
                 ("pb30", pb30, SOLVER_TILE_WIDTH, ("float32",)),
                 ("pbf", pbf, MULTI_CHUNK_TILE_WIDTH, ("float32",)),
                 ("pb30", pb30, MULTI_CHUNK_TILE_WIDTH, ("float32",))]
    for name, p, tw, modes in node_runs:
        lb, ub = node_pool(np, rt, p, TIER_NODES, seed=5)
        base = rt.propagate_nodes(p, lb, ub, tile_width=tw, device=dev)
        zeros = torch.zeros(TIER_NODES, dtype=torch.int32)
        for mode in modes:
            kw = modes_kw[mode]
            got = main_path(lambda: rt.propagate_nodes(p, lb, ub, tile_width=tw, device=dev,
                                                       **kw))
            plain = rt.propagate_nodes(p, lb, ub, tile_width=tw, device=dev, use_kernels=False,
                                       **kw)
            label = f"nodes {name} K={tw} {mode}"
            same_results(torch, label, [got], [plain], fields[:-1])
            if not torch.equal(torch.as_tensor(got.tier_rounds).cpu(),
                               torch.as_tensor(plain.tier_rounds).cpu()):
                fail(f"{label}: tier_rounds differ from the plain path")
            tr = got.tier_rounds if mode == "two-tier" else zeros
            gap = check_tier_runs(
                torch, np, label, mode,
                list(zip(got.lb, got.ub, got.rounds, got.converged, got.infeasible, tr)),
                list(zip(base.lb, base.ub, base.rounds, base.converged, base.infeasible, zeros)),
                p.is_int)
            log(f"{label}: {TIER_NODES} nodes, rounds {got.rounds.tolist()} (float64-only "
                f"{base.rounds.tolist()}), infeasible {int(got.infeasible.sum())} (float64-only "
                f"{int(base.infeasible.sum())}); bitwise the plain path; largest continuous "
                f"gap {gap:.3e}")
    # Walls of the fused batch and the pbf nodes by variant, every variant
    # once per trial in an order that rotates between trials.
    nodes_pbf = node_pool(np, rt, pbf, TIER_NODES, seed=5)
    walls = [(label, kind, kw) for kind in ("batch fused", "nodes pbf")
             for label, kw in (("float64", {}), *modes_kw.items())]
    samples = {}
    for trial in range(TIER_TRIALS):
        order = walls[trial % len(walls):] + walls[: trial % len(walls)]
        for label, kind, kw in order:
            run = (lambda kw=kw: rt.propagate_batch(pops["fused"], device=dev, **kw)) if (
                kind == "batch fused") else (lambda kw=kw: rt.propagate_nodes(
                    pbf, *nodes_pbf, tile_width=SOLVER_TILE_WIDTH, device=dev, **kw))
            samples.setdefault((kind, label), []).append(wall_ms(torch, run))
    for kind in ("batch fused", "nodes pbf"):
        cells = ", ".join(f"{label} {statistics.median(samples[kind, label]):.3f}"
                          for label in ("float64", *modes_kw))
        log(f"tier walls {kind} (ms, medians of {TIER_TRIALS}): {cells}")
    # A short service stream (one multi-chunk bucket: mixed, mixed1, pb,
    # banded through 2 slots) at float32 and with the early retire.
    stream = pops["multi-chunk"] + pops["fused"][:1] + pops["fused"][2:3]
    specs = rt.BucketSpec.for_problems(stream, slots=2)
    spec_of = [next(s for s in specs if s.fits_problem(p)) for p in stream]
    for mode, kw in (("float32", dict(dtype=f32)), ("early retire", dict(BATCH_STOP))):
        svc = rt.PropagationService(specs, rounds_per_step=SERVICE_ROUNDS_PER_STEP, device=dev,
                                    **kw)
        t = time.perf_counter()
        out = main_path(lambda: svc.serve(stream))
        wall = time.perf_counter() - t
        for i, (p, s, r) in enumerate(zip(stream, spec_of, out)):
            one = rt.propagate_batch([p], tile_width=s.tile_width, device=dev, **kw)[0]
            for f in ("lb", "ub", "rounds", "converged", "infeasible"):
                if not torch.equal(getattr(r, f), getattr(one, f).cpu()):
                    fail(f"service {mode}: ticket {i} {f} differs from the one-shot batch")
        st = svc.stats()
        early = sum(1 for r in out if not bool(r.converged)
                    and int(r.rounds) < rt.core.DEFAULT_CONFIG.max_rounds)
        if st["early_stopped"] != (early if mode == "early retire" else 0):
            fail(f"service {mode}: early_stopped {st['early_stopped']}, evidence {early}")
        if mode == "early retire" and early < 1:
            fail("service early retire: no slot retired early")
        log(f"service {mode}: {len(stream)} requests (tile width {specs[0].tile_width}, "
            f"fits_one_chunk {specs[0].fits_one_chunk}), rounds {[int(r.rounds) for r in out]}, "
            f"converged {[bool(r.converged) for r in out]}, early_stopped "
            f"{st['early_stopped']}, wall {wall * 1e3:.1f} ms; every ticket bitwise its "
            "one-shot batch")
    log(f"phase 14 launches by form: {json.dumps(launches)}")
    missing = [k for k in BATCH_TIER_PRIMARY if launches.get(k, 0) <= 0]
    if missing:
        fail(f"the batched tiers' runs never launched {missing}")
    out_rows = {key: (rows[key][inst], inst) for key, inst in BATCH_TIER_PRIMARY.items()}
    for key, (r, _) in out_rows.items():
        r["max_abs_err"] = max(v["max_abs_err"] for v in rows[key].values())
    log(f"phase 14: {time.perf_counter() - t_phase:.1f} s")
    return out_rows, {key: launches.get(key, 0) for key in BATCH_TIER_PRIMARY}


# ---------------------------------------------------------------------------
# Phase 15: the precision tiers on the segment and partitioned engines
# ---------------------------------------------------------------------------

SLAB_TIER_SOURCE = "src/repro_torch/csrc/slab_tier_round.cu"
# The float32 forms of A, B, C, #11-#15 and the straddle combine, and #15's
# early-stop forms (one instance's carry; a batch's per-row measure), each
# with the instance its kernels-line entry is measured on.
ENGINE_TIER_PRIMARY = {
    "activities_tiles[f32]": "mixed",
    "candidates_tiles[f32]": "mixed", "candidates_tiles[f32c]": "mixed30",
    "fused_round_tiles[f32]": "pb", "fused_round_tiles[f32c]": "pb30",
    "batched_slab_partials_tiles[f32]": "pbw",
    "straddle_combine_tiles[f32]": "pbw",
    "batched_slab_round_tiles[f32]": "pbw",
    "apply_updates_slab_tiles[f32]": "pbw",
    "apply_updates_slab_tiles[f64+stop]": "pbw",
    "apply_updates_slab_tiles[f32+stop]": "pbw",
    "apply_updates_slab_tiles[f64+stop_rows]": "partitioned bucket",
    "apply_updates_slab_tiles[f32+stop_rows]": "partitioned bucket",
    "node_slab_partials_tiles[f32]": f"pbw pool, 8 of {POOL} active",
    "node_slab_round_tiles[f32]": f"pbw pool, 8 of {POOL} active",
}
SEGMENT_TIER = ("pb", "banded", "mixed", "pb30", "mixed30")


def slab_stop_check(torch, tk, tref, ops, build, name, prep, part, timed, float64_ms=None):
    """#15 with the early stop armed, for one instance's fixed point
    (``slab_merge_stop``), against its plain fold on the candidates of the
    plain partitioned round from the root, then on none (a measure of 0
    that stops the loop): bounds, handed-back planes and the whole carry
    (the measure's bits included) bitwise.  Returns the timed row (empty
    when not ``timed``)."""
    from repro_torch.core import carry as rt_carry

    cfg = ops.DEFAULT_CONFIG
    dt = prep.lb0.dtype
    eps, outward, inf = cfg.eps_for(dt), cfg.outward_for(dt), cfg.inf
    width = prep.n_pad
    lbp, ubp = prep.lb0[None].clone(), prep.ub0[None].clone()
    bl, bu = tref.partitioned_round_ref(part, lbp, ubp, cfg.int_eps, inf)
    best = (bl[:, :width].contiguous(), bu[:, :width].contiguous())
    empty = (torch.full_like(lbp, -inf), torch.full_like(ubp, inf))
    stop = rt_carry.EarlyStop(1e-30, 1)
    blocks = -(-width // tref.MERGE_BLOCK)
    partials = torch.empty(blocks, dtype=dt, device=lbp.device)
    st_k, st_p = rt_carry.armed_state(lbp.device), rt_carry.armed_state(lbp.device)
    cur_k, cur_p = (lbp.clone(), ubp.clone()), (lbp, ubp)
    for cand in (best, empty):
        acc = (cand[0].clone(), cand[1].clone())
        tk.apply_updates_slab_tiles(*cur_k, *acc, rt_carry.go_mask(st_k), part.slab, eps, inf,
                                    outward, carry=st_k, stop=stop, partials=partials)
        new = tref.apply_updates_slab_ref(*cur_p, *cand, rt_carry.go_mask(st_p), part.slab, eps,
                                          inf, outward)
        rt_carry.fold(st_p, new[2].any(), 0, 1, stop,
                      tref.merge_progress(cur_p[0], cur_p[1], new[0], new[1]))
        err = max_abs_err(torch, (*cur_k, st_k), (new[0], new[1], st_p))
        planes_clean(torch, acc, inf, f"{name}: #15 with the early stop kept a candidate")
        cur_p = new[:2]
    fields = st_k.tolist()
    if fields[rt_carry.GO] != 0 or fields[rt_carry.ROUNDS] != 2:
        fail(f"{name}: #15 with the early stop left the carry at {fields[:8]}")
    if not timed:
        return {}
    armed = rt_carry.armed_state(lbp.device)
    carry = armed.clone()
    lbw, ubw = lbp.clone(), ubp.clone()
    acc = (best[0].clone(), best[1].clone())
    reset = fresh_inputs(torch, [(lbw, lbp), (ubw, ubp), (acc[0], best[0]), (acc[1], best[1]),
                                 (carry, armed)])
    go = rt_carry.go_mask(carry)
    moved = dict(merge_bytes(torch, ops.bnd, lbp, ubp, *best, eps, inf=inf), carry=4 * 8,
                 partials=2 * lbp.element_size() * blocks)

    def plain():
        new = tref.apply_updates_slab_ref(lbp, ubp, *best, go, part.slab, eps, inf, outward)
        return tref.merge_progress(lbp, ubp, new[0], new[1])

    r = tier_row(torch, build, (st_k,), (st_p,),
                 lambda: tk.apply_updates_slab_tiles(lbw, ubw, *acc, go, part.slab, eps, inf,
                                                     outward, carry=carry, stop=stop,
                                                     partials=partials),
                 plain, moved, 10 * width, dt, reset=reset, float64_ms=float64_ms)
    r["max_abs_err"] = err
    return r


def slab_rows_stop_check(torch, tk, tref, ops, build, label, lbp, ubp, best, act, slab, timed,
                         float64_ms=None):
    """#15 with the early stop's per-row measure (``slab_merge_rows_stop``)
    on ``(B, W)`` planes against its plain version, through two rounds
    (the candidates ``best``, then none): bounds, changed flags, each active
    row's block partials and measure bitwise; inactive rows' entries
    untouched, the ticket back at 0.  Returns the timed row (empty when
    not ``timed``)."""
    cfg = ops.DEFAULT_CONFIG
    dt = lbp.dtype
    eps, outward, inf = cfg.eps_for(dt), cfg.outward_for(dt), cfg.inf
    bsz, width = lbp.shape
    blocks = -(-width // tref.MERGE_BLOCK)
    prog_k = torch.full((bsz,), 9.0, dtype=dt, device=lbp.device)
    prog_p = prog_k.clone()
    part_k = torch.full((bsz, blocks), 7.0, dtype=dt, device=lbp.device)
    ticket = torch.zeros(1, dtype=torch.int32, device=lbp.device)
    none = (torch.full_like(lbp, -inf), torch.full_like(ubp, inf))
    lk, uk, lp, up = lbp.clone(), ubp.clone(), lbp, ubp
    err = 0.0
    for cand in (best, none):
        flags = tk.apply_updates_slab_tiles(lk, uk, cand[0].clone(), cand[1].clone(), act,
                                            slab, eps, inf, outward, progress=prog_k,
                                            partials=part_k, ticket=ticket)[2]
        new = tref.apply_updates_slab_ref(lp, up, *cand, act, slab, eps, inf, outward)
        blocks_p, rows_p = tref.merge_rows_progress(lp, up, new[0], new[1])
        prog_p = torch.where(act, rows_p, prog_p)
        err = max(err, max_abs_err(torch, (lk, uk, flags, prog_k, part_k[act]),
                                   (new[0], new[1], new[2].any(dim=1), prog_p, blocks_p[act])))
        if int(ticket.item()) != 0:
            fail(f"{label}: #15's row measure left its ticket at {int(ticket.item())}")
        lp, up = new[0], new[1]
    if bool((part_k[~act] != 7.0).any()) or bool((prog_k[~act] != 9.0).any()):
        fail(f"{label}: #15's row measure wrote an inactive row's entries")
    log(f"kernel apply_updates_slab_tiles[{'f64' if dt == torch.float64 else 'f32'}+stop_rows] "
        f"on {label}: two rounds bitwise the plain version (bounds, changed flags, partials, "
        f"measure {prog_k[act][:2].tolist()}); max_abs_err={err}")
    if not timed:
        return {}
    lbw, ubw, blw, buw = lbp.clone(), ubp.clone(), best[0].clone(), best[1].clone()
    reset = fresh_inputs(torch, [(lbw, lbp), (ubw, ubp), (blw, best[0]), (buw, best[1])])
    n_act = int(act.sum())
    n_slabs = -(-width // slab)
    moved = dict(merge_bytes(torch, ops.bnd, lbp, ubp, *best, eps, act, inf),
                 flags=4 * bsz * n_slabs + bsz,
                 partials=2 * lbp.element_size() * n_act * blocks,
                 measure=lbp.element_size() * n_act)
    plain = lambda: tref.merge_rows_progress(  # noqa: E731
        lbp, ubp, *tref.apply_updates_slab_ref(lbp, ubp, *best, act, slab, eps, inf,
                                               outward)[:2])
    r = tier_row(torch, build, (prog_k,), (prog_p,),
                 lambda: tk.apply_updates_slab_tiles(lbw, ubw, blw, buw, act, slab, eps, inf,
                                                     outward, progress=prog_k,
                                                     partials=part_k, ticket=ticket),
                 plain, moved, 16 * n_act * width, dt, reset=reset, float64_ms=float64_ms)
    r["max_abs_err"] = err
    return r


def engine_tiers_phase(torch, np, rt, tk, tref, ops, build, dev, problems, probs13, wide,
                       wide_results, pops, measured):
    """Phase 15: the precision tiers on the segment and partitioned engines.
    The float32 forms of A, B and C (int32 ids on pb, banded, mixed; the
    compact int8 marks on pb30, mixed30), of #11, the straddle combine, #12
    and #15 (bandw, pbw), of #13 and #14 (the pbw pool at 8 and 128 of 128
    active) and #15's early-stop forms against their plain versions, timed;
    then, with the launches counted, the segment engine, the partitioned
    engine through ``auto`` (both drivers), the partitioned batch [bandw,
    pbw] and the pbw node batch at float32, under TierPolicy() and with the
    early stop, against the plain path (bitwise) and the float64-only runs;
    and their walls.  Returns ({form key: (row, instance)}, {form key:
    launches on the phase's main-path runs})."""
    t_phase = time.perf_counter()
    f32 = torch.float32
    cfg = ops.DEFAULT_CONFIG
    policy = rt.core.TierPolicy()
    stop_pol = rt.core.TierPolicy(**EARLY_STOP)
    rows = {}

    def add(key, inst, r):
        rows.setdefault(key, {})[inst] = r
        log_tier_row(key, inst, r)

    # A, B and C at float32.
    seg_probs = {n: problems[n] if n in problems else probs13[n] for n in SEGMENT_TIER}
    for name, p in seg_probs.items():
        prep = rt.prepare_block_ell(p, dtype=f32, device=dev)
        form = "f32c" if prep.ii_g.dtype == torch.int8 else "f32"
        for kname, r in check_segment_kernels(torch, tk, tref, ops, build, name, prep).items():
            r["float64_ms"] = measured.get(kname, {}).get(name, {}).get("ms")
            add(f"{kname}[{'f32' if kname == 'activities_tiles' else form}]", name, r)
    # #11, the straddle combine, #12 and #15 at float32 on bandw and pbw, and
    # #15 with the early stop (float64 and float32) on their partitions.
    wide32 = {}
    for name in ("bandw", "pbw"):
        prep = wide32[name] = rt.prepare_block_ell(wide[name], dtype=f32, device=dev)
        part = prep.slab_partition()
        for kname, r in check_slab_kernels(torch, tk, tref, ops, build, name, prep,
                                           part).items():
            r["float64_ms"] = measured[kname][name]["ms"]
            add(f"{kname}[f32]", name, r)
        prep64 = rt.prepare_block_ell(wide[name], device=dev)
        r64 = slab_stop_check(torch, tk, tref, ops, build, name, prep64,
                              prep64.slab_partition(), name == "pbw")
        r32 = slab_stop_check(torch, tk, tref, ops, build, name, prep, part, name == "pbw",
                              float64_ms=r64.get("ms"))
        if name == "pbw":
            add("apply_updates_slab_tiles[f64+stop]", name, r64)
            add("apply_updates_slab_tiles[f32+stop]", name, r32)
        else:
            log(f"kernel apply_updates_slab_tiles[f64+stop], [f32+stop] on {name}: two rounds "
                "bitwise the plain fold (bounds, planes, carry)")
    # #15's per-row measure on the partitioned bucket's two planes (the
    # grid) and on the pbw pool (the walk).
    (batch,) = ops.packed_problems(pops["partitioned"])
    on2 = torch.ones(batch.size, dtype=torch.bool, device=dev)
    row64 = None
    for dt in (torch.float64, f32):
        bprep = ops.prepare_problem_batch(batch, dt, device=dev)
        bpart = bprep.slab_partition()
        lbp, ubp = bprep.d.lb0.clone(), bprep.d.ub0.clone()
        bl, bu = tref.partitioned_round_ref(bpart, lbp, ubp, cfg.int_eps, cfg.inf)
        best = (bl[:, : bprep.n_pad].contiguous(), bu[:, : bprep.n_pad].contiguous())
        r = slab_rows_stop_check(torch, tk, tref, ops, build, "partitioned bucket", lbp, ubp,
                                 best, on2, bpart.slab, True,
                                 float64_ms=None if row64 is None else row64["ms"])
        label = "f64" if dt == torch.float64 else "f32"
        add(f"apply_updates_slab_tiles[{label}+stop_rows]", "partitioned bucket", r)
        row64 = row64 or r
    # #13, the straddle combine, #14 and #15 at float32 on the pbw pool (K = 8).
    pbw = wide["pbw"]
    prep8 = rt.prepare_block_ell(pbw, tile_width=SOLVER_TILE_WIDTH, dtype=f32, device=dev)
    part8 = prep8.slab_partition()
    for k, by_shape in check_node_slab_kernels(torch, np, rt, tk, tref, ops, build, pbw, prep8,
                                               part8, acts=(8, POOL)).items():
        for shape, r in by_shape.items():
            r["float64_ms"] = measured.get(k, {}).get(shape, {}).get("ms")
            rows.setdefault(f"{k}[f32]", {})[shape] = r
    lb_h, ub_h = node_pool(np, rt, pbw, POOL, seed=3)
    lbp, ubp = ops._node_planes(prep8, lb_h, ub_h)
    act = pool_mask(torch, 8, dev)
    bl, bu = tref.node_partitioned_round_ref(part8, lbp, ubp, cfg.int_eps, cfg.inf, active=act)
    slab_rows_stop_check(torch, tk, tref, ops, build, f"pbw pool, 8 of {POOL} active", lbp, ubp,
                         (bl[:, : prep8.n_pad].contiguous(), bu[:, : prep8.n_pad].contiguous()),
                         act, part8.slab, False)

    launches = {}

    def main_path(fn):
        """Run one main-path call, adding its launches by form."""
        before = tk.form_counts()
        out = fn()
        for key, v in tk.form_counts().items():
            launches[key] = launches.get(key, 0) + v - before.get(key, 0)
        return out

    def drivers(label, fn, plain):
        """fn(driver) on both drivers, each bitwise ``plain`` (progress
        included); returns the device_loop run."""
        out = {d: main_path(lambda d=d: fn(d)) for d in ("host_loop", "device_loop")}
        for d, r in out.items():
            check_same(rt, f"{label} {d}", r, plain, True, "the plain path")
            if not torch.equal(r.progress.isnan(), plain.progress.isnan()) or not torch.equal(
                    r.progress.nan_to_num(), plain.progress.nan_to_num()):
                fail(f"{label} {d}: progress differs from the plain path")
            if int(r.tier_rounds) != int(plain.tier_rounds):
                fail(f"{label} {d}: tier_rounds differ from the plain path")
        return out["device_loop"]

    # The segment engine: float32-only, two tiers and the early stop.
    for name, p in seg_probs.items():
        seg = dict(scatter="segment", device=dev)
        modes = [("float32", dict(dtype=f32))]
        if name in ("pb", "mixed"):
            modes += [("two-tier", dict(policy=policy)),
                      ("early stop", dict(policy=stop_pol, dtype=f32))]
        base = None
        for mode, kw in modes:
            plain = rt.propagate_block_ell(p, use_kernels=False, driver="host_loop", **seg, **kw)
            r = drivers(f"segment {name} {mode}", lambda d, kw=kw: rt.propagate_block_ell(
                p, driver=d, **seg, **kw), plain)
            extra = ""
            if mode == "two-tier":
                base = rt.propagate_block_ell(p, **seg)
                gap = check_tier_contract(torch, np, name, p, r, base)
                extra = (f" (float64-only: rounds={base.rounds.item()}, largest continuous "
                         f"gap {gap:.3e})")
            log(f"segment {name} {mode}: rounds={r.rounds.item()} tier_rounds="
                f"{r.tier_rounds.item()} converged={r.converged.item()} infeasible="
                f"{r.infeasible.item()}{extra}; both drivers bitwise the plain path")
    # The partitioned engine through scatter="auto".
    for name in ("bandw", "pbw"):
        p, base = wide[name], wide_results[name]
        for mode, kw in (("float32", dict(dtype=f32)), ("two-tier", dict(policy=policy)),
                         ("early stop", dict(policy=stop_pol, dtype=f32)),
                         ("early stop f64", dict(policy=stop_pol))):
            plain = rt.propagate_block_ell(p, use_kernels=False, driver="host_loop", device=dev,
                                           **kw)
            r = drivers(f"partitioned {name} {mode}", lambda d, kw=kw: rt.propagate_block_ell(
                p, driver=d, device=dev, **kw), plain)
            extra = ""
            if mode == "two-tier":
                gap = check_tier_contract(torch, np, name, p, r, base)
                extra = f", largest continuous gap {gap:.3e}"
            elif mode.startswith("early stop") and int(r.rounds) > int(base.rounds):
                fail(f"partitioned {name} {mode}: more rounds than the float64-only run")
            log(f"partitioned {name} {mode}: rounds={r.rounds.item()} (float64-only "
                f"{base.rounds.item()}) tier_rounds={r.tier_rounds.item()} converged="
                f"{r.converged.item()} infeasible={r.infeasible.item()} progress="
                f"{r.progress.item():.6g}{extra}; both drivers bitwise the plain path")
    # The partitioned batch [bandw, pbw] and the pbw node batch.
    fields = ("lb", "ub", "rounds", "converged", "infeasible", "progress", "tier_rounds")
    pop = pops["partitioned"]
    base = rt.propagate_batch(pop, device=dev)
    for mode, kw in (("float32", dict(dtype=f32)), ("two-tier", dict(policy=policy)),
                     ("early stop", dict(BATCH_STOP)),
                     ("early stop", dict(BATCH_STOP, dtype=f32))):
        got = main_path(lambda kw=kw: rt.propagate_batch(pop, device=dev, **kw))
        plain = rt.propagate_batch(pop, device=dev, use_kernels=False, **kw)
        label = f"batch partitioned {mode}{' f32' if kw.get('dtype') == f32 else ''}"
        same_results(torch, label, got, plain, fields)
        # A float32 stop is held as float32 runs are: never falsely infeasible.
        check = "float32" if kw.get("dtype") == f32 else mode
        for q, g, b in zip(pop, got, base):
            check_tier_runs(torch, np, label, check,
                            [(g.lb, g.ub, g.rounds, g.converged, g.infeasible, g.tier_rounds)],
                            [(b.lb, b.ub, b.rounds, b.converged, b.infeasible, b.tier_rounds)],
                            q.is_int)
        log(f"{label}: rounds {[int(r.rounds) for r in got]} (float64-only "
            f"{[int(r.rounds) for r in base]}), tier_rounds {[int(r.tier_rounds) for r in got]}, "
            f"converged {[bool(r.converged) for r in got]}; bitwise the plain path")
    lb, ub = node_pool(np, rt, pbw, TIER_NODES, seed=5)
    base = rt.propagate_nodes(pbw, lb, ub, tile_width=SOLVER_TILE_WIDTH, device=dev)
    zeros = torch.zeros(TIER_NODES, dtype=torch.int32)
    for mode, kw in (("float32", dict(dtype=f32)), ("early stop", dict(BATCH_STOP)),
                     ("early stop", dict(BATCH_STOP, dtype=f32))):
        got = main_path(lambda kw=kw: rt.propagate_nodes(pbw, lb, ub,
                                                         tile_width=SOLVER_TILE_WIDTH,
                                                         device=dev, **kw))
        plain = rt.propagate_nodes(pbw, lb, ub, tile_width=SOLVER_TILE_WIDTH, device=dev,
                                   use_kernels=False, **kw)
        label = f"nodes pbw {mode}{' f32' if kw.get('dtype') == f32 else ''}"
        same_results(torch, label, [got], [plain], fields[:-1])
        check_tier_runs(
            torch, np, label, "float32" if kw.get("dtype") == f32 else mode,
            list(zip(got.lb, got.ub, got.rounds, got.converged, got.infeasible, zeros)),
            list(zip(base.lb, base.ub, base.rounds, base.converged, base.infeasible, zeros)),
            pbw.is_int)
        log(f"{label}: {TIER_NODES} nodes, rounds {got.rounds.tolist()} (float64-only "
            f"{base.rounds.tolist()}), infeasible {int(got.infeasible.sum())}; bitwise the plain "
            "path")
    log(f"phase 15 launches by form: {json.dumps(launches)}")
    missing = [k for k in ENGINE_TIER_PRIMARY if launches.get(k, 0) <= 0]
    if missing:
        fail(f"the engine tiers' runs never launched {missing}")

    # Walls: the single-instance fixed points by driver, the partitioned
    # batch and the pbw nodes, every variant once per trial in an order
    # that rotates between trials.
    variants = [("float64", {}), ("float32", dict(dtype=f32)), ("two-tier", dict(policy=policy)),
                ("early stop", dict(BATCH_STOP))]
    walls = [(kind, label, d) for kind in ("segment mixed", "bandw", "pbw")
             for label, _ in variants for d in ("host_loop", "device_loop")]
    walls += [(kind, label, None) for kind in ("batch partitioned", "nodes pbw")
              for label, _ in variants if not (kind == "nodes pbw" and label == "two-tier")]
    kws = dict(variants)
    nodes = node_pool(np, rt, pbw, TIER_NODES, seed=5)

    def call(kind, label, d):
        kw = kws[label]
        if kind == "segment mixed":
            return rt.propagate_block_ell(problems["mixed"], scatter="segment", driver=d,
                                          device=dev, **kw)
        if kind in ("bandw", "pbw"):
            return rt.propagate_block_ell(wide[kind], driver=d, device=dev, **kw)
        if kind == "batch partitioned":
            return rt.propagate_batch(pop, device=dev, **kw)
        return rt.propagate_nodes(pbw, *nodes, tile_width=SOLVER_TILE_WIDTH, device=dev, **kw)

    samples = {}
    for trial in range(TIER_TRIALS):
        order = walls[trial % len(walls):] + walls[: trial % len(walls)]
        for kind, label, d in order:
            samples.setdefault((kind, label, d), []).append(
                wall_ms(torch, lambda: call(kind, label, d)))
    for kind in ("segment mixed", "bandw", "pbw", "batch partitioned", "nodes pbw"):
        cells = []
        for label, _ in variants:
            ds = [d for k, lab, d in walls if k == kind and lab == label]
            if ds:
                cells.append(f"{label} " + ", ".join(
                    (f"{d} " if d else "") + f"{statistics.median(samples[kind, label, d]):.3f}"
                    for d in ds))
        log(f"engine tier walls {kind} (ms, medians of {TIER_TRIALS}): {'; '.join(cells)}")
    out_rows = {key: (rows[key][inst], inst) for key, inst in ENGINE_TIER_PRIMARY.items()}
    for key, (r, _) in out_rows.items():
        r["max_abs_err"] = max(v["max_abs_err"] for v in rows[key].values())
    log(f"phase 15: {time.perf_counter() - t_phase:.1f} s")
    return out_rows, {key: launches.get(key, 0) for key in ENGINE_TIER_PRIMARY}


# ---------------------------------------------------------------------------
# Phase 16: the device telemetry (Queue 1 item 6) and the record kernels
# ---------------------------------------------------------------------------

TELEMETRY_SOURCE = "src/repro_torch/csrc/telemetry.cu"
TELEMETRY_CAP = 64
TELEMETRY_TRIALS = 9
# The record kernels' kernels-line entries and the instance each is
# measured on.
TELEMETRY_PRIMARY = {
    "record_round_tiles": "pb",
    "record_round_tiles[f32]": "pb",
    "record_round_batch_tiles": "fused bucket, 4 of 4 active",
}


def plane_bits(torch, plane) -> tuple:
    """A telemetry plane's fields as integers (the ring's bits: its unused
    slots are NaN), for :func:`max_abs_err`'s bitwise comparison."""
    ring = plane.ring
    as_int = torch.int64 if ring.dtype == torch.float64 else torch.int32
    return (ring.view(as_int),) + tuple(plane[1:])


def record_check(torch, tk, tref, build, label, lb, ub, timed):
    """``record_round`` against its plain version on ``(n_pad,)`` bounds: a
    carry one round past the plane's ticks (its measure, a low-progress
    streak at patience 1), a plane with ``ticks`` already past the ring's
    capacity (the wrap), and a second launch that must record nothing;
    plane and carry bitwise.  Then the host loop's probe into the carry.
    Returns the timed row (empty when not ``timed``)."""
    from repro_torch.core import DEFAULT_CONFIG, carry as rt_carry
    from repro_torch.obs import device_plane

    feas = DEFAULT_CONFIG.feas_eps
    dt, dev = lb.dtype, lb.device
    carry = rt_carry.armed_state(dev)
    carry[rt_carry.ROUNDS] = TELEMETRY_CAP + 3
    carry[rt_carry.FLAT] = 1
    rt_carry.progress_view(carry, dt).fill_(0.125)
    planes = []
    for _ in range(2):
        plane = device_plane(TELEMETRY_CAP, dtype=dt, device=dev)
        plane.ticks.fill_(TELEMETRY_CAP + 2)
        planes.append(plane)
    got, want = planes
    scratch = torch.zeros(2, dtype=torch.int32, device=dev)
    for _ in range(2):
        tk.record_round_tiles(lb, ub, carry, got, feas, patience=1, scratch=scratch)
        tref.record_round_ref(lb, ub, carry, want, feas, 1, 1)
    err = max_abs_err(torch, plane_bits(torch, got), plane_bits(torch, want))
    state = carry.clone()
    tk.record_round_tiles(lb, ub, carry, None, feas, scratch=scratch)
    tref.record_round_ref(lb, ub, state, None, feas)
    err = max(err, max_abs_err(torch, (carry,), (state,)))
    if int(got.ticks) != TELEMETRY_CAP + 3:
        fail(f"{label}: record_round recorded {int(got.ticks)} ticks")
    if not timed:
        return {}
    pristine = [t.clone() for t in got]
    pristine[1].fill_(TELEMETRY_CAP + 2)
    reset = fresh_inputs(torch, list(zip(got, pristine)))
    v = lb.element_size()
    moved = dict(bounds=2 * v * lb.numel(), carry=64, plane=v + 3 * 4)
    flops = F64_FLOPS if dt == torch.float64 else F32_FLOPS
    r = measured_row(
        torch, build, plane_bits(torch, got), plane_bits(torch, want),
        lambda: tk.record_round_tiles(lb, ub, carry, got, feas, patience=1,
                                      scratch=scratch),
        lambda: tref.record_round_ref(lb, ub, carry, want, feas, 1, 1),
        moved, 2 * lb.numel(), reset=reset, flops=flops)
    r["max_abs_err"] = err
    return r


def record_batch_check(torch, tk, tref, build, lb, ub, prog, rounds, ran, timed):
    """``record_round_batch`` against its plain version on a bucket's
    ``(B, n_pad)`` planes with the mask ``ran``: plane bitwise, the scratch
    left zeroed.  Returns the timed row (empty when not ``timed``)."""
    from repro_torch.core import DEFAULT_CONFIG
    from repro_torch.obs import device_plane

    feas = DEFAULT_CONFIG.feas_eps
    dev, dt = lb.device, lb.dtype
    bsz = lb.shape[0]
    flat = torch.ones(bsz, dtype=torch.int32, device=dev)
    got = device_plane(TELEMETRY_CAP, batch=bsz, dtype=dt, device=dev)
    want = device_plane(TELEMETRY_CAP, batch=bsz, dtype=dt, device=dev)
    scratch = torch.zeros(bsz + 1, dtype=torch.int32, device=dev)
    for _ in range(2):
        tk.record_round_batch_tiles(lb, ub, prog, ran, rounds, flat, got, feas,
                                    patience=1, scratch=scratch)
        tref.record_round_batch_ref(lb, ub, prog, ran, rounds, flat, want, feas, 1)
    err = max_abs_err(torch, plane_bits(torch, got), plane_bits(torch, want))
    if bool(scratch.any()):
        fail("record_round_batch left its scratch dirty")
    if not timed:
        return {}
    pristine = [t.clone() for t in got]
    reset = fresh_inputs(torch, list(zip(got, pristine)))
    v = lb.element_size()
    active = int(ran.sum())
    moved = dict(bounds=2 * v * active * lb.shape[1], lanes=(v + 1 + 8) * bsz,
                 plane=(v + 3 * 4) * active)
    r = measured_row(
        torch, build, plane_bits(torch, got), plane_bits(torch, want),
        lambda: tk.record_round_batch_tiles(lb, ub, prog, ran, rounds, flat, got,
                                            feas, patience=1, scratch=scratch),
        lambda: tref.record_round_batch_ref(lb, ub, prog, ran, rounds, flat, want,
                                            feas, 1),
        moved, 2 * active * lb.shape[1], reset=reset)
    r["max_abs_err"] = err
    return r


def telemetry_same(torch, label, off, on, reads_off, reads_on):
    """Fail unless every field of the telemetry-on results ``on`` is bitwise
    the telemetry-off results' ``off`` (NaNs in the same places) and the
    host reads agree."""
    if reads_off != reads_on:
        fail(f"{label}: telemetry on made {reads_on} host reads, off {reads_off}")

    def bits(x):
        x = torch.as_tensor(x).reshape(-1)
        return x.view(torch.uint8) if x.dtype.is_floating_point else x

    for i, (a, b) in enumerate(zip(off, on)):
        for f in ("lb", "ub", "rounds", "converged", "infeasible", "progress", "tier_rounds"):
            x, y = bits(getattr(a, f)), bits(getattr(b, f))
            if x.dtype != y.dtype or x.shape != y.shape or not torch.equal(x, y):
                fail(f"{label}[{i}]: {f} differs with telemetry on")
        if b.telemetry is None or b.telemetry.rounds_recorded != (
                int(b.rounds) - int(b.tier_rounds)):
            fail(f"{label}[{i}]: the snapshot recorded "
                 f"{None if b.telemetry is None else b.telemetry.rounds_recorded} rounds of "
                 f"{int(b.rounds)}")


def telemetry_phase(torch, np, rt, tk, tref, build, dev, problems, wide, pops, pbf, stream):
    """Phase 16: the device telemetry.  The record kernels against their
    plain versions (``pb`` at float64 and float32, the fused bucket at 4
    and 2 of 4 active), timed; then telemetry on against off, bitwise in
    every field with equal host reads, with the launches counted per run:
    ``pb``, ``mixed`` and ``bandw`` (partitioned) under both drivers, the
    fused batch, the pbf nodes, the pbf search and the service stream; the
    fp32 tier's trajectory under ``TierPolicy()`` on pb, pbf, mixed and
    bandw; and the walls of telemetry on and off (CUDA events, medians of
    rotating trials) on pb and mixed device_loop and the fused batch.
    Returns ({kernels-line key: (row, instance)}, {run: launch counts})."""
    t_phase = time.perf_counter()
    f32 = torch.float32
    cap = TELEMETRY_CAP
    rows = {}
    prep = rt.prepare_block_ell(problems["pb"], device=dev)
    final = rt.propagate_block_ell(problems["pb"], device=dev)
    lb_f, ub_f = prep.pad_bounds(final.lb, final.ub)
    rows["record_round_tiles"] = record_check(torch, tk, tref, build, "pb", lb_f, ub_f, True)
    record_check(torch, tk, tref, build, "pb root", prep.lb0, prep.ub0, False)
    prep32 = rt.prepare_block_ell(problems["pb"], dtype=f32, device=dev)
    rows["record_round_tiles[f32]"] = record_check(torch, tk, tref, build, "pb f32",
                                                   prep32.lb0, prep32.ub0, True)
    rows["record_round_tiles[f32]"]["float64_ms"] = rows["record_round_tiles"]["ms"]
    (batch,) = rt.kernels.packed_problems(pops["fused"])
    bprep = rt.kernels.prepare_problem_batch(batch, device=dev)
    out = rt.kernels.batched_device_runner(bprep)(bprep.d.lb0.clone(), bprep.d.ub0.clone())
    blb, bub, brounds, _, _, bprog = out
    bprog = torch.nan_to_num(bprog)
    for n_act in (4, 2):
        ran = torch.arange(4, device=dev) < n_act
        r = record_batch_check(torch, tk, tref, build, blb, bub, bprog, brounds, ran,
                               n_act == 4)
        if r:
            rows["record_round_batch_tiles"] = r
    for key, r in rows.items():
        if "float64_ms" in r:
            log_tier_row(key, TELEMETRY_PRIMARY[key], r)
        else:
            log_row(key, TELEMETRY_PRIMARY[key], r)

    runs = {}

    def counted(label, fn):
        """Telemetry off, then on (its launches counted alone); both
        bitwise equal with equal host reads.  Returns the on run."""
        reads = [[], []]
        off = fn(None, lambda: reads[0].append(1))
        tk.reset_launch_counts()
        on = fn(cap, lambda: reads[1].append(1))
        torch.cuda.synchronize()
        runs[label] = tk.launch_counts()
        many = isinstance(on, list)
        telemetry_same(torch, label, off if many else [off], on if many else [on],
                       len(reads[0]), len(reads[1]))
        return on

    for name, p in (("pb", problems["pb"]), ("mixed", problems["mixed"]),
                    ("bandw", wide["bandw"])):
        for driver in ("host_loop", "device_loop"):
            r = counted(f"telemetry {name} {driver}", lambda tel, s, p=p, d=driver:
                        rt.propagate_block_ell(p, driver=d, telemetry=tel, device=dev,
                                               on_sync=s))
            t = r.telemetry
            hist = t.progress_history()
            log(f"telemetry {name} {driver}: rounds={r.rounds.item()} recorded="
                f"{t.rounds_recorded} infeasible_round={t.infeasible_round} stop_round="
                f"{t.stop_round}; history head {np.round(hist[:4], 6).tolist()} tail "
                f"{np.round(hist[-3:], 9).tolist()}; bitwise telemetry off, equal reads")
    got = counted("telemetry batch fused", lambda tel, s: rt.propagate_batch(
        pops["fused"], telemetry=tel, device=dev, on_sync=s))
    log(f"telemetry batch fused: recorded {[b.telemetry.rounds_recorded for b in got]} of "
        f"rounds {[int(b.rounds) for b in got]}; bitwise telemetry off")
    root = rt.propagate_block_ell(pbf, tile_width=SOLVER_TILE_WIDTH, device=dev)
    lb_r, ub_r = root.lb.cpu().numpy(), root.ub.cpu().numpy()
    lb, ub = branched(np, rt, lb_r, ub_r, most_fractional_order(np, lb_r, ub_r, pbf.is_int)[:6])
    res = counted("telemetry nodes pbf", lambda tel, s: rt.propagate_nodes(
        pbf, lb, ub, tile_width=SOLVER_TILE_WIDTH, telemetry=tel, device=dev,
        on_sync=s).results())
    log(f"telemetry nodes pbf: {len(res)} nodes, recorded "
        f"{sorted({b.telemetry.rounds_recorded for b in res})}; bitwise telemetry off")
    c = objective(np, pbf.n)
    solved = {}
    for tel in (None, cap):
        reads = []
        tk.reset_launch_counts()
        solved[tel] = rt.solve(pbf, c, telemetry=tel, device=dev,
                               on_flag_read=lambda: reads.append(1), **FULL_SEARCH)
        solved[tel].reads = len(reads)
        runs["telemetry solve pbf"] = tk.launch_counts()
    a, b = solved[None], solved[cap]
    for f in ("status", "objective", "nodes_expanded", "nodes_created", "levels", "host_syncs",
              "incumbent_trajectory", "reads"):
        if getattr(a, f) != getattr(b, f):
            fail(f"telemetry solve pbf: {f} differs with telemetry on")
    for x, y in zip(a.carry, b.carry):
        if not torch.equal(x, y):
            fail("telemetry solve pbf: the final pool differs with telemetry on")
    t = b.telemetry
    if t.rounds_recorded != b.levels:
        fail(f"telemetry solve pbf: {t.rounds_recorded} samples for {b.levels} levels")
    log(f"telemetry solve pbf: {b.levels} levels, frontier widths "
        f"{t.progress_history().astype(int).tolist()}, first incumbent level {t.stop_round}, "
        f"first infeasible fathom {t.infeasible_round}; the search bitwise telemetry off")
    specs = rt.BucketSpec.for_problems(stream, slots=SERVICE_SLOTS,
                                       size_classes=SERVICE_SIZE_CLASSES)
    served = counted("telemetry service stream", lambda tel, s: rt.PropagationService(
        specs, rounds_per_step=SERVICE_ROUNDS_PER_STEP, telemetry=tel, device=dev,
        on_sync=s).serve(stream))
    log(f"telemetry service stream: {len(served)} tickets, recorded "
        f"{[x.telemetry.rounds_recorded for x in served]}; bitwise telemetry off")
    need = ("record_round_tiles",)
    require_launched(runs, {k: need for k in runs if not k.startswith(
        ("telemetry batch", "telemetry nodes", "telemetry solve", "telemetry service"))})
    require_launched(runs, {k: ("record_round_batch_tiles",) for k in (
        "telemetry batch fused", "telemetry nodes pbf", "telemetry service stream")})

    # The fp32 tier's trajectory under TierPolicy().
    policy = rt.core.TierPolicy()
    tk.reset_launch_counts()
    for name, p in (("pb", problems["pb"]), ("pbf", pbf), ("mixed", problems["mixed"]),
                    ("bandw", wide["bandw"])):
        r = rt.propagate_block_ell(p, policy=policy, telemetry=cap, device=dev)
        t, t32 = r.telemetry, r.telemetry.fp32
        log(f"tier trajectory {name}: tier_rounds={r.tier_rounds.item()} rounds="
            f"{r.rounds.item()} tier_switch_round={t.tier_switch_round} fp32 recorded "
            f"{t32.rounds_recorded} infeasible_round={t32.infeasible_round} stop_round="
            f"{t32.stop_round}")
        log(f"  fp32 tier progress: {[float(f'{x:.4g}') for x in t32.progress_history()]}")
        log(f"  endgame progress: {[float(f'{x:.4g}') for x in t.progress_history()]}")
    runs["telemetry tier trajectories"] = tk.launch_counts()
    f32_launches = tk.form_counts().get("record_round_tiles[f32]", 0)
    if f32_launches <= 0:
        fail("the fp32 tiers never launched record_round's float32 form")

    # Walls, telemetry on against off.
    variants = [("pb", "off"), ("pb", "on"), ("mixed", "off"), ("mixed", "on"),
                ("batch fused", "off"), ("batch fused", "on")]

    def call(kind, mode):
        tel = cap if mode == "on" else None
        if kind == "batch fused":
            return rt.propagate_batch(pops["fused"], telemetry=tel, device=dev)
        return rt.propagate_block_ell(problems[kind], telemetry=tel, device=dev)

    samples = {}
    for trial in range(TELEMETRY_TRIALS):
        order = variants[trial % len(variants):] + variants[: trial % len(variants)]
        for kind, mode in order:
            samples.setdefault((kind, mode), []).append(wall_ms(torch, lambda: call(kind, mode)))
    for kind in ("pb", "mixed", "batch fused"):
        on, off = samples[kind, "on"], samples[kind, "off"]
        ratio = statistics.median(a / b for a, b in zip(on, off))
        log(f"telemetry walls {kind} device_loop (ms, medians of {TELEMETRY_TRIALS}): off "
            f"{statistics.median(off):.3f} on {statistics.median(on):.3f}; median ratio "
            f"on/off {ratio:.4f}")
    out = {key: (rows[key], inst) for key, inst in TELEMETRY_PRIMARY.items()}
    launches = {"record_round_tiles[f32]": f32_launches}
    log(f"phase 16: {time.perf_counter() - t_phase:.1f} s")
    return out, runs, launches


# ---------------------------------------------------------------------------
# Phase 17: the sharded engines on worlds of ranks
# ---------------------------------------------------------------------------

# (label, entry point, instance or bucket) of each run a rank makes.
SHARDED_RUNS = (
    ("nnz mixed", "propagate_sharded", "mixed"),
    ("nnz pb", "propagate_sharded", "pb"),
    ("rows pb", "propagate_sharded_rows", "pb"),
    ("rows banded", "propagate_sharded_rows", "banded"),
    ("batch fused", "propagate_batch_sharded", "fused"),
    ("batch multi-chunk", "propagate_batch_sharded", "multi-chunk"),
)
SHARDED_BUCKETS = {"fused": ("pb", "pbf", "banded", "banded1"),
                   "multi-chunk": ("mixed", "mixed1")}
SHARDED_REPS = 5
SHARDED_NEED = {
    "nnz": ("activities_gather_tiles", "combine_chunk_partials_tiles",
            "candidates_scatter_tiles", "apply_updates_tiles"),
    "rows": ("fused_scatter_round_tiles", "apply_updates_tiles"),
    "batch fused": ("batched_fused_scatter_round_tiles", "apply_updates_batch_tiles"),
    "batch multi-chunk": ("activities_gather_tiles", "combine_chunk_partials_tiles",
                          "candidates_scatter_tiles", "apply_updates_batch_tiles"),
}


def sharded_rank(rank, world_size, instances, unsharded):
    """One rank of phase 17: each run of :data:`SHARDED_RUNS` once with the
    launch counters at zero (its result, launches and first wall), then its
    wall as CUDA events after a barrier, the median of
    :data:`SHARDED_REPS`; with ``unsharded`` also ``propagate_block_ell`` on
    ``mixed``, ``pb`` and ``banded`` and ``propagate_batch`` on both buckets,
    timed the same way.  ``clock`` holds the wall-clock times at which the
    rank began and ended its runs."""
    import torch
    import torch.distributed as dist

    import repro_torch as rt
    from repro_torch import core
    from repro_torch.kernels import prop_round as tk

    del rank, world_size
    ready = time.time()

    def call(entry, arg):
        if entry == "propagate_batch_sharded":
            return core.propagate_batch_sharded([instances[n] for n in SHARDED_BUCKETS[arg]])
        return getattr(core, entry)(instances[arg])

    def wall(fn):
        times = []
        for _ in range(SHARDED_REPS):
            dist.barrier()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    out = {}
    for label, entry, arg in SHARDED_RUNS:
        dist.barrier()
        tk.reset_launch_counts()
        t = time.perf_counter()
        res = call(entry, arg)
        torch.cuda.synchronize()
        first = time.perf_counter() - t
        launched = {k: v for k, v in tk.launch_counts().items() if v}
        out[label] = dict(result=res, launches=launched, first_s=first,
                          ms=wall(lambda: call(entry, arg)))
    if unsharded:
        out["unsharded"] = {name: wall(lambda name=name: rt.propagate_block_ell(instances[name]))
                            for name in ("mixed", "pb", "banded")}
        for bucket, names in SHARDED_BUCKETS.items():
            pop = [instances[n] for n in names]
            out["unsharded"][bucket] = wall(lambda pop=pop: rt.propagate_batch(pop))
    out["clock"] = (ready, time.time())
    return out


def sharded_phase(torch, np, rt, dev, problems, results, pops, pbf):
    """Phase 17: the sharded engines on a world of one NCCL rank and a world
    of four ``gloo`` ranks sharing the card (:func:`sharded_rank`), held to
    rank 0, to the unsharded port and to their kernels (module docstring)."""
    from repro_torch.core import run_world

    t_phase = time.perf_counter()
    instances = {**problems, "pbf": pbf}
    for bucket, names in SHARDED_BUCKETS.items():
        instances.update(zip(names, pops[bucket]))
    want = {"pb": results["pb"], "banded": results["banded"], "mixed": results["mixed"]}
    batches = {b: rt.propagate_batch(pops[b], device=dev) for b in SHARDED_BUCKETS}
    host = lambda t: t.cpu().numpy()

    def same(a, b, bitwise=True):
        """Result ``a`` (numpy, from a rank) against ``b`` (tensors)."""
        if any(int(getattr(a, f)) != int(getattr(b, f).item())
               for f in ("rounds", "converged", "infeasible")):
            return False
        if bitwise:
            return bool(np.array_equal(a.lb, host(b.lb)) and np.array_equal(a.ub, host(b.ub)))
        return rt.bounds_equal(a.lb, a.ub, b.lb, b.ub)

    for size, backend in ((1, "nccl"), (4, "gloo")):
        t = time.time()
        ranks = run_world(sharded_rank, size, backend=backend, device="cuda",
                          args=(instances, size == 1), timeout=600)
        ready = max(rk["clock"][0] for rk in ranks)
        done = max(rk["clock"][1] for rk in ranks)
        log(f"sharded world {size} ({backend}, one card): {time.time() - t:.1f} s: the ranks "
            f"started and took their instances in {ready - t:.1f} s, ran in {done - ready:.1f} "
            f"s, returned and stopped in {time.time() - done:.1f} s")
        first = ranks[0]
        for label, entry, arg in SHARDED_RUNS:
            got = first[label]["result"]
            listed = got if isinstance(got, list) else [got]
            for r, other in enumerate(ranks[1:], start=1):
                theirs = other[label]["result"]
                for a, b in zip(listed, theirs if isinstance(theirs, list) else [theirs]):
                    for f in ("lb", "ub", "rounds", "converged", "infeasible", "progress"):
                        if not np.array_equal(getattr(a, f), getattr(b, f), equal_nan=True):
                            fail(f"sharded world {size} {label}: rank {r} {f} differs from "
                                 "rank 0's")
            if entry == "propagate_batch_sharded":
                for i, (a, b) in enumerate(zip(got, batches[arg])):
                    if not same(a, b):
                        fail(f"sharded world {size} {label}: instance {i} differs from "
                             "propagate_batch")
            elif not same(got, want[arg], bitwise=label != "nnz mixed"):
                fail(f"sharded world {size} {label}: differs from propagate_block_ell")
            if arg == "pb" and not (int(got.rounds) == REFERENCE_ROUNDS["pb"]
                                    and bool(got.infeasible)):
                fail(f"sharded world {size} {label}: pb must take 33 rounds and end infeasible")
            launched = first[label]["launches"]
            need = SHARDED_NEED.get(label, SHARDED_NEED.get(label.split()[0]))
            missing = [k for k in need if launched.get(k, 0) <= 0]
            if missing:
                fail(f"sharded world {size} {label}: rank 0 never launched {missing}: {launched}")
            walls = [rk[label]["ms"] for rk in ranks]
            rounds = ([int(x.rounds) for x in got] if isinstance(got, list)
                      else int(got.rounds))
            log(f"sharded world {size} {label}: rounds={rounds} wall_ms (median of "
                f"{SHARDED_REPS}) rank 0 {walls[0]:.3f}, slowest rank {max(walls):.3f}; first "
                f"call {first[label]['first_s']:.2f} s (partition and prepare included); rank 0 "
                f"launches {launched}; every rank equals rank 0 bitwise, "
                + ("bounds_equal to" if label == "nnz mixed" else "bitwise equal to")
                + (" propagate_batch" if isinstance(got, list) else " propagate_block_ell"))
        if size == 1:
            for label, entry, arg in SHARDED_RUNS:
                ms = first["unsharded"][arg]
                base = "propagate_batch" if arg in SHARDED_BUCKETS else "propagate_block_ell"
                log(f"sharded world 1 {label} against the unsharded {base} (same process, "
                    f"timed alike): {first[label]['ms']:.3f} ms against {ms:.3f} ms, ratio "
                    f"{first[label]['ms'] / ms:.3f}")
    log(f"phase 17: {time.perf_counter() - t_phase:.1f} s")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    log(f"gpu: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    smoke(torch, torch.device("cuda"))
    log(f"total: {time.perf_counter() - t0:.1f} s")
    log(f"gpu: {smi}")
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
