#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Run from the root of a checkout.  It imports ``src/repro_torch`` (torch and
numpy only, nothing of JAX) and, on one CUDA card:

  1. prints the card's name and power limit, builds the CUDA kernels of
     ``src/repro_torch/csrc/prop_round.cu``, ``slab_round.cu``,
     ``tier_round.cu``, ``batch_tier_round.cu``, ``slab_tier_round.cu``,
     ``telemetry.cu`` and ``half_round.cu`` from source (one ``nvcc`` per
     file, in parallel) and
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
 19. (phase 18) the LM serving path (``repro_torch.models``,
     ``repro_torch.train.serve_step``; plain PyTorch, no kernel of its own)
     at full width on the card, weights from a seeded ``torch.Generator``:
     ``qwen2-0.5b`` and ``mamba2-780m`` FULL and ``recurrentgemma-9b`` at
     full width cut to 5 layers (one pattern period and its 2-layer tail,
     printed as ``reduced``).  Float32 gates, TF32 off: prefill of 24 tokens
     + 4 decode steps against ``forward_train`` over all 28 on each of the
     three (5e-2, greedy agreement >= 0.99, the reference test's property);
     the port on the card against the port on the CPU, same weights, on
     the ten SMOKE archs (forward, prefill and 4 decode logits) and on
     ``qwen2-0.5b`` FULL (one 8-token prompt), within 1e-3;
     every logit finite.  Then, at the configs' bfloat16, ``generate`` at
     ``serve_lm``'s shape (b = 4, prompt 16, 24 steps) on the three and
     ``qwen2-0.5b`` at b = 32, prompt 512, 64 steps: prefill ms, decode ms
     per step, tokens/s and peak memory (CUDA events, medians of 5), and
     four decode steps traced (device items, busy time, idle share).  The
     four example twins run meanwhile in processes of their own on the
     card (and the presolve twin on the CPU), their launch counts printed:
     exit 0, ``bounds match: True``, bnb's equal optimum of -126.0, the
     presolve table equal to the CPU twin's;
 20. (phase 19, last: after the ``kernels`` line, once the engines' caches
     that pin phases 1-18's device buffers are released) the archs with
     experts and MLA and the training path
     (``repro_torch.nn.moe``/``mla``, ``repro_torch.train``; plain
     PyTorch, no kernel of its own), weights from a seeded
     ``torch.Generator``: ``qwen3-moe-30b-a3b`` at full width cut to 4 of
     48 layers and ``deepseek-v2-236b`` cut to 2 of 60 (its dense first
     layer and one MoE layer), printed as ``reduced``, each freed before the
     next.  Float32 gates, TF32 off: prefill + 4 decodes against the full
     forward (5e-2, greedy agreement >= 0.99); ``moe_apply`` of one qwen3
     layer at t = 4,608 (the capacity path, at the config's capacity factor
     and at 1.0, where routings drop) on the card against the CPU, the
     routing and the drops compared first (a token routed apart must be a
     near-tie), the outputs within 1e-3; the ``qwen2-0.5b`` FULL float32
     loss, gradient (leaf by leaf) and one step's loss and gradient norm on
     the card against the CPU within 1e-3.  ``examples/torch_train_lm.py``
     runs meanwhile in a process of its own on the card and must end
     ``improved``.  Then, at bfloat16, ``generate`` of both MoE models at
     ``serve_lm``'s shape (prefill ms, decode ms a step, tokens/s, peak
     memory, a traced decode step), and training steps of ``qwen2-0.5b``
     FULL (b = 8, s = 512, 5 steps) and ``qwen3-moe-30b-a3b`` cut to 2
     layers (b = 2, s = 1,024, 3 steps): step ms (CUDA events), tokens/s,
     peak memory, finite losses, one step traced;
 21. (phase 20, after phase 19) the sharded LM models, the counted
     propagation rounds and the dry run (``repro_torch.launch``,
     ``repro_torch.roofline``): (a) on a world of one NCCL rank,
     ``qwen2-0.5b`` FULL (float32) through ``make_train_step(..., mesh=)``
     on a ``(1, 1)`` mesh, its loss and every gradient leaf against the
     unsharded port step within 1e-5 of the leaf's scale, one step's params
     likewise (entries whose gradient is at the rounding level held to
     Adam's bound), a prefill and 4 decodes through ``make_prefill_fn`` /
     ``make_serve_step`` with the mesh against the unsharded ones; (c)
     ``launch.perf.run_propagation_variants("single")``: one round of each
     partition on rank 0 of a 256-rank fake world at the reference's size,
     its kernels on the card, the counted collective bytes equal to
     ``lower_sharded``'s, the launches printed; (d) ``launch.dryrun.run_cell
     ("granite-3-2b", "train_4k", "single")``, run in a process of its own
     from the start of the script (no card: minutes of one CPU core), and
     ``run_propagation_dryrun``, their records and seconds printed, with the
     card's ``total_memory``; (b) on four gloo ranks with CPU tensors
     (gloo dies on DTensor's all-gather of CUDA tensors with the card's
     PyTorch: ``tools/dtensor_gloo.py``), ``granite-3-2b`` SMOKE on a
     ``(2, 2)`` mesh, one step and a prefill plus 4 decodes (the cache split
     over its sequence) against the unsharded port within 1e-5;
 22. (phase 21, after phase 16) bfloat16 and float16 on the single-instance
     engines: every 16-bit form (``half_round.cu``) of D, A', the combine,
     E and F (``pb``, ``banded``, ``mixed``; at bfloat16 the compact forms
     on ``pb30`` and ``mixed30``), F with the early stop, A, B and C (the
     segment round on ``pb``, ``mixed`` and, compact, ``pb30``,
     ``mixed30``), #11, the straddle combine, #12, #15 and #15 with the
     early stop (``bandw``, ``pbw``) and the record kernel (``pb``) against
     its plain version on the card, bitwise (the scatters' float32 planes
     hold the candidates widened), each timed on its float32 form's
     instance beside this run's float32 and float64 times, its bound at 2 B
     a value; then, with the launch counters at zero, ``propagate_block_ell``
     at both types on ``pb``, ``mixed``, ``bandw`` (and ``pb30``,
     ``mixed30`` at bfloat16), both drivers, against the plain path on the
     card (bitwise), the segment engine against the fused one, the early
     stop (F on ``pb``, #15 on ``bandw``) and telemetry on ``pb``; the
     fixed points of ``pb``, ``mixed`` and ``bandw`` against the CPU plain
     runs of the same instances (a process started with the script):
     rounds, converged and infeasible exactly; every 16-bit form must have
     been launched; the walls at float32, bfloat16 and float16;
 23. prints (before phase 19) a ``kernels`` JSON line (the float forms as
     ``<wrapper>[<form>]``), and last ``{"ok": true, "device": {...}}``.

Each path runs with the launch counters at zero just before it and read just
after; every kernel must have been launched by the main-path runs.

Any failed check raises, so the exit code is not 0 and no result is printed.
Without a CUDA device it exits with code 2 before doing anything.
"""
from __future__ import annotations

import contextlib
import ctypes
import json
import math
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
                      | set(_build.SIGNATURES["telemetry.cu"])
                      | set(_build.SIGNATURES["half_round.cu"])
                      | set(_build.SIGNATURES["half_batch_round.cu"]))

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


def round_scalars(ops, dt) -> tuple:
    """``(eps, int_eps, inf, outward)`` of a round at ``dt``, rounded to it
    as the engines pass them (the reference's weakly typed scalars; exact
    at float64 and float32 as PyTorch and ctypes round them anyway)."""
    from repro_torch.core.propagator import round_scalars as scalars

    return scalars(ops.DEFAULT_CONFIG, dt)


def flops_of(torch, dt) -> float:
    """The vector rate of a kernel's arithmetic at ``dt``: float64's, or
    float32's (the 16-bit forms compute in float32 and round)."""
    return F64_FLOPS if dt == torch.float64 else F32_FLOPS


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
    n_pad = prep.n_pad
    eps, int_eps, inf, outward = round_scalars(ops, d.val.dtype)
    nnz = int((d.val != 0).sum().item())  # real nonzeros in the tiles
    flops = flops_of(torch, d.val.dtype)
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
    # Beside 16-bit bounds they are float32, holding the candidates widened.
    acc = tk.accumulator_planes(lb, inf)
    wide = lambda xs: tuple(x.to(acc[0].dtype) for x in xs)
    sentinels = lambda: (acc[0].fill_(-inf), acc[1].fill_(inf))
    clean = lambda what: planes_clean(torch, acc, inf, f"{name}: {what}")
    k = d.val.shape[-1]
    if prep.fits_one_chunk:
        args = (d.val, d.col, prep.ii_g, prep.lhs_g, prep.rhs_g, lb, ub, n_pad, int_eps, inf)
        # The lengths and the longest chunk hoisted at prepare time: where
        # no chunk holds more than 16 slots, several chunks share a warp.
        hoisted = dict(chunk_len=prep.chunk_len, max_chunk_len=prep.max_chunk_len)
        want = tref.fused_scatter_round_tiles_ref(*args)
        got = tk.fused_scatter_round_tiles(*args, acc=acc, **hoisted)
        # Fresh planes and the lengths computed by the wrapper; and a warp
        # with four strides per chunk whatever the chunks hold (no packing).
        max_abs_err(torch, tk.fused_scatter_round_tiles(*args), wide(want))
        max_abs_err(torch, tk.fused_scatter_round_tiles(*args, chunk_len=prep.chunk_len,
                                                        max_chunk_len=k), wide(want))
        row("fused_scatter_round_tiles", got, wide(want),
            lambda: tk.fused_scatter_round_tiles(*args, acc=acc, **hoisted),
            lambda: tref.fused_scatter_round_tiles_ref(*args), reset=sentinels)
        rows["fused_scatter_round_tiles"].update(
            lanes=lanes_per_chunk(min(prep.max_chunk_len, k)), max_chunk_len=prep.max_chunk_len)
        best_l, best_u = want
    else:
        # Each chunk's length as the engine hoists it (prepare time).
        clen = dict(chunk_len=prep.chunk_len)
        a_args = (d.val, d.col, lb, ub, n_pad, inf)
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
                  int_eps, inf)
        want = tref.candidates_scatter_tiles_ref(*e_args)
        got = tk.candidates_scatter_tiles(*e_args, **clen, acc=acc)
        max_abs_err(torch, tk.candidates_scatter_tiles(*e_args, **clen), wide(want))  # fresh
        row("candidates_scatter_tiles", got, wide(want),
            lambda: tk.candidates_scatter_tiles(*e_args, **clen, acc=acc),
            lambda: tref.candidates_scatter_tiles_ref(*e_args), reset=sentinels)
        best_l, best_u = want

    want = ops.bnd.apply_updates(lb, ub, best_l, best_u, eps, inf, outward)
    # F hands the planes it reads back at the sentinels: here the kept
    # planes that the scatter filled (and the timing left full).  It folds
    # its flag into a loop carry, kept as the round closure keeps it: the
    # first round of a check group of two, so the carry's GO stays set and
    # every timed launch merges.
    acc[0].copy_(best_l)
    acc[1].copy_(best_u)
    carry = rt_carry.armed_state(lb.device)
    armed = carry.clone()
    got = tk.apply_updates_tiles(lb.clone(), ub.clone(), *acc, eps, inf, outward, carry=carry,
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
        lambda: tk.apply_updates_tiles(lbw, ubw, *acc, eps, inf, outward, carry=carry, k=0,
                                       unroll=2),
        lambda: ops.bnd.apply_updates(lb, ub, best_l, best_u, eps, inf, outward),
        moved=dict(merge_bytes(torch, ops.bnd, lb, ub, best_l, best_u, eps, inf=inf),
                   carry=4 * 5),
        reset=fresh_inputs(torch, [(lbw, lb), (ubw, ub), (acc[0], wide((best_l,))[0]),
                                   (acc[1], wide((best_u,))[0]), (carry, armed)]))
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


def smoke(torch, dev, half_cpu, half_batch_cpu, parent):
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
    for k, rows in node_multichunk_phase(torch, np, rt, tk, tref, ops, _build, pbf, dev,
                                         parent).items():
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
        measured, parent)
    engine_tier_rows, engine_tier_launches = engine_tiers_phase(
        torch, np, rt, tk, tref, ops, _build, dev, problems, tier_probs, wide, wide_results,
        batch_pops, measured)
    telemetry_rows, telemetry_runs, telemetry_launches = telemetry_phase(
        torch, np, rt, tk, tref, _build, dev, problems, wide, batch_pops, pbf, stream)
    runs.update(telemetry_runs)
    half_rows, half_launches = half_phase(
        torch, np, rt, tk, tref, ops, _build, dev, problems, tier_probs, wide,
        {**tier_rows, **engine_tier_rows, **telemetry_rows}, half_cpu)
    half_batch_rows, half_batch_launches = half_batch_phase(
        torch, np, rt, td, tk, tref, ops, _build, dev, problems, batch_pops, pbf, tier_probs,
        wide, {**batch_tier_rows, **engine_tier_rows, **telemetry_rows}, half_batch_cpu,
        parent)
    sharded_phase(torch, np, rt, dev, problems, results, batch_pops, pbf)
    lm_phase(torch, dev)
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
            **{key: r[key] for key in ("segment_reduce_ms", "bound_all_slots_ms", "parent_ms",
                                       "parent_wrapper_ms") if key in r},
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
    parents = lambda r: {k: r[k] for k in ("parent_ms", "parent_wrapper_ms") if k in r}  # noqa
    for key, (r, inst) in batch_tier_rows.items():
        base = key.split("[")[0]
        kernels.append(dict(
            name=key, route="cuda", source=BATCH_TIER_SOURCE, replaces=REPLACES[base],
            launches=batch_tier_launches[key], max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=None, instance=inst, wrapper_ms=r["wrapper_ms"], bytes=r["bytes"],
            float64_ms=r.get("float64_ms"), **parents(r),
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
    for key, (r, inst) in half_rows.items():
        kernels.append(dict(
            name=key, route="cuda", source=HALF_SOURCE, replaces=REPLACES[key.split("[")[0]],
            launches=half_launches[key], max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=None, instance=inst, wrapper_ms=r["wrapper_ms"], bytes=r["bytes"],
            float32_ms=r["float32_ms"], float64_ms=r["float64_ms"],
        ))
    for key, (r, inst) in half_batch_rows.items():
        kernels.append(dict(
            name=key, route="cuda", source=HALF_BATCH_SOURCE,
            replaces=REPLACES[key.split("[")[0]], launches=half_batch_launches[key],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=None, instance=inst,
            wrapper_ms=r["wrapper_ms"], bytes=r["bytes"], float32_ms=r["float32_ms"],
            float64_ms=r["float64_ms"], **parents(r),
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


PARENT_SOURCE = "tools/round_variants.cu"
# The forms of node A' and node E, as variant 0 of the tool's entries takes them.
PARENT_FORMS = {"f64": 0, "f32": 1, "f32c": 2, "bf16": 3, "bf16c": 4, "f16": 5}


class ParentNodeKernels:
    """Node A' and node E as the port shipped them before their redesign
    (variant 0 of ``tools/round_variants.cu``, compiled with
    ``-DNODE_ROUND_ONLY``: those kernels alone, at every form), timed beside
    the redesigned kernels in the same run.  The compiler starts with the
    script, beside the kernel library's; :meth:`lib` waits for it."""

    def __init__(self):
        from repro_torch.kernels import _build

        root = Path(__file__).resolve().parent
        self.out = _build.BUILD_DIR / "node_round_parent" / "libnode_round_parent.so"
        self.out.parent.mkdir(parents=True, exist_ok=True)
        self.proc = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-DNODE_ROUND_ONLY", "-o", str(self.out),
             str(root / PARENT_SOURCE)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        self._lib = None

    def lib(self):
        if self._lib is None:
            log_text, _ = self.proc.communicate()
            if self.proc.returncode != 0:
                fail(f"nvcc failed on {PARENT_SOURCE} (-DNODE_ROUND_ONLY): {log_text[-3000:]}")
            lib = ctypes.CDLL(str(self.out))
            P, I64, I32, F64 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_double
            lib.node_gather_variant.argtypes = [I32, I32] + [P] * 10 + [I64, I32, I32, I64, I64,
                                                                        F64, P]
            lib.node_scatter_variant.argtypes = [I32, I32] + [P] * 15 + [I64, I32, I32, I64,
                                                                         I64, F64, F64, P]
            lib.node_gather_variant.restype = lib.node_scatter_variant.restype = I32
            self._lib = lib
        return self._lib

    def gather(self, form, val, col, clen, lb, ub, act, outs, n_pad, inf):
        t, r, k = val.shape
        return self.lib().node_gather_variant(
            0, PARENT_FORMS[form], val.data_ptr(), col.data_ptr(), clen.data_ptr(),
            lb.data_ptr(), ub.data_ptr(), act.data_ptr(), *(o.data_ptr() for o in outs),
            t * r, k, k, lb.shape[0], n_pad, float(inf), _raw_stream())

    def scatter(self, form, val, col, ii, clen, aggs, lhs, rhs, lb, ub, act, acc, n_pad,
                int_eps, inf):
        t, r, k = val.shape
        return self.lib().node_scatter_variant(
            0, PARENT_FORMS[form], val.data_ptr(), col.data_ptr(), ii.data_ptr(),
            clen.data_ptr(), *(a.data_ptr() for a in aggs), lhs.data_ptr(), rhs.data_ptr(),
            lb.data_ptr(), ub.data_ptr(), act.data_ptr(), acc[0].data_ptr(), acc[1].data_ptr(),
            t * r, k, k, lb.shape[0], n_pad, float(int_eps), float(inf), _raw_stream())

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def _raw_stream() -> int:
    import torch

    return torch.cuda.current_stream().cuda_stream


def launch_ms(torch, launch, reset=None, reps: int = 20) -> float:
    """Median device time of ``launch`` (a C entry call, checked), queued
    behind a sleep on the card, CUDA events around it; ``reset`` (untimed)
    first."""
    out = []
    for _ in range(reps):
        if reset is not None:
            reset()
        torch.cuda._sleep(1_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        err = launch()
        end.record()
        if err:
            fail(f"a parent kernel failed to launch: CUDA error {err}")
        out.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in out)


def parent_rows(torch, tk, parent, form, row_a, row_e, pr, lbp, ubp, act, parts, aggs, want_e,
                inf, int_eps):
    """The parents of node A' and node E on the same inputs as ``row_a`` /
    ``row_e`` (the redesigned kernels' rows): held against the plain
    versions (A' on the active rows, E on whole planes fresh at the
    sentinels) and timed, kernel (``parent_ms``: E after a fill of its
    planes, as the parent's wrapper filled them) and wrapper
    (``parent_wrapper_ms``: A''s four outputs allocated, E's two planes
    allocated at the sentinels, then the launch)."""
    d, n_pad = pr.d, pr.n_pad
    err = half_err if form in ("bf16", "bf16c", "f16") else max_abs_err
    on = lambda xs: tuple(x[act] for x in xs)
    outs = [torch.empty_like(x) for x in parts]
    g_args = (form, d.val, d.col, pr.chunk_len, lbp, ubp, act)
    if parent.gather(*g_args, outs, n_pad, inf):
        fail(f"the parent node A' [{form}] failed to launch")
    err(torch, on(outs), on(parts))
    row_a["parent_ms"] = launch_ms(torch, lambda: parent.gather(*g_args, outs, n_pad, inf))
    row_a["parent_wrapper_ms"] = time_ms(torch, lambda: parent.gather(
        *g_args, [torch.empty_like(x) for x in parts], n_pad, inf), reps=3, trials=3)
    if row_e is None:
        return
    acc = tk.accumulator_planes(lbp, inf)
    fill = lambda: (acc[0].fill_(-inf), acc[1].fill_(inf))  # noqa: E731
    e_args = (form, d.val, d.col, pr.ii_g, pr.chunk_len, aggs, pr.lhs_g, pr.rhs_g, lbp, ubp,
              act)
    fill()
    if parent.scatter(*e_args, acc, n_pad, int_eps, inf):
        fail(f"the parent node E [{form}] failed to launch")
    err(torch, acc, want_e)
    row_e["parent_ms"] = launch_ms(torch, lambda: parent.scatter(*e_args, acc, n_pad, int_eps,
                                                                 inf), reset=fill)
    row_e["parent_wrapper_ms"] = time_ms(torch, lambda: parent.scatter(
        *e_args, tk.accumulator_planes(lbp, inf), n_pad, int_eps, inf), reps=3, trials=3)


def node_multichunk_phase(torch, np, rt, tk, tref, ops, build, pbf, dev, parent):
    """Phase 5b: the multi-chunk node round's kernels -- A', the combine and
    E over a node batch -- against their plain versions on pbf's tiles at
    tile width MULTI_CHUNK_TILE_WIDTH (rows of 5 to 8 nonzeros span two
    chunks) and a (POOL, n_pad) pool of warm-started node bounds with 0, 8
    and POOL rows active, called as the node round calls them (the longest
    chunk hoisted, E into kept planes): bitwise on the active nodes' planes
    (the kernels leave the partials of inactive nodes unwritten) and on
    every accumulator row; the first eight active nodes also against the
    single-instance kernels on their own rows.  Timed, beside the parents
    of A' and E (the kernels before their redesign, ``parent``) on the same
    inputs.  Then one node round over 4 and over POOL nodes, whose launches
    must be the same, and a second round over POOL nodes, which must
    allocate nothing on the card.  Returns {kernel: {shape: row of
    measurements}}."""
    cfg = ops.DEFAULT_CONFIG
    t0 = time.perf_counter()
    prep = rt.prepare_block_ell(pbf, tile_width=MULTI_CHUNK_TILE_WIDTH, device=dev)
    d, n_pad = prep.d, prep.n_pad
    t, r, k = d.val.shape
    chunks = t * r
    nnz = int((d.val != 0).sum().item())
    log(f"pbf at tile width {k}: tiles={(t, r, k)} fits_one_chunk={prep.fits_one_chunk} "
        f"longest chunk {prep.max_chunk_len} prepare={time.perf_counter() - t0:.2f}s")
    lb_h, ub_h = node_pool(np, rt, pbf, POOL, seed=3)
    lbp, ubp = ops._node_planes(prep, lb_h, ub_h)
    clen = dict(chunk_len=prep.chunk_len)
    hoisted = dict(clen, max_chunk_len=prep.max_chunk_len)
    acc = tk.accumulator_planes(lbp)
    fill = lambda: (acc[0].fill_(-cfg.inf), acc[1].fill_(cfg.inf))  # noqa: E731
    names = ("node_activities_gather_tiles", "node_combine_chunk_partials_tiles",
             "node_candidates_scatter_tiles")
    out = {name: {} for name in names}
    for n_act in (0, 8, POOL):
        act = pool_mask(torch, n_act, dev)
        shape = f"pbf K={k} pool, {n_act} of {POOL} active"
        reps = 1 if n_act == POOL else 3
        on = lambda xs: tuple(x[act] for x in xs)
        # With no node active A' and E read the mask alone: every block
        # returns after the ballot, so their bound is the mask's bytes and
        # the launch sets their time.
        stream = (dict(val=8 * nnz, col=4 * nnz, chunk_len=4 * chunks) if n_act
                  else dict(val=0, col=0, chunk_len=0))
        a_args = (d.val, d.col, lbp, ubp, act, n_pad)
        parts = tref.node_activities_gather_ref(*a_args)
        got_p = tk.node_activities_gather_tiles(*a_args, **hoisted)
        out[names[0]][shape] = measured_row(
            torch, build, on(got_p), on(parts),
            lambda: tk.node_activities_gather_tiles(*a_args, **hoisted),
            lambda: tref.node_activities_gather_ref(*a_args),
            dict(stream, bounds=16 * n_act * n_pad, out=24 * n_act * chunks, mask=POOL),
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
        fill()
        got = tk.node_candidates_scatter_tiles(*e_args, **hoisted, acc=acc)
        # Timed after a fill of the kept planes, as the parent after its
        # wrapper's; the wrapper as the round calls it, into the kept planes.
        out[names[2]][shape] = measured_row(
            torch, build, got, want,
            lambda: tk.node_candidates_scatter_tiles(*e_args, **hoisted, acc=acc),
            lambda: tref.node_candidates_scatter_ref(*e_args),
            dict(stream, is_int=4 * nnz if n_act else 0, sides=16 * chunks if n_act else 0,
                 aggregates=24 * n_act * chunks, bounds=16 * n_act * n_pad,
                 out=16 * n_act * n_pad, mask=POOL),
            12 * nnz * n_act, plain_reps=reps, reset=fill)
        fill()
        got = tk.node_candidates_scatter_tiles(*e_args, **hoisted, acc=acc)
        max_abs_err(torch, got, want)
        parent_rows(torch, tk, parent, "f64", out[names[0]][shape], out[names[2]][shape], prep, lbp,
                    ubp, act, parts, aggs, want, cfg.inf, cfg.int_eps)
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
    lbr, ubr = lbp.clone(), ubp.clone()
    act = torch.ones(POOL, dtype=torch.bool, device=dev)
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()["allocation.all.allocated"]
    round_fn(lbr, ubr, act)
    torch.cuda.synchronize()
    grown = torch.cuda.memory_stats()["allocation.all.allocated"] - before
    if grown:
        fail(f"a second multi-chunk node round over {POOL} nodes allocated {grown} blocks")
    log(f"multi-chunk node round over {POOL} nodes, the second: no allocation on the card "
        "(A' and the combine into buffers kept by the closure, E into its kept planes)")
    return out


def combine_shapes_phase(torch, np, td, tk, tref, ops, build, prep, dev):
    """Phase 5c: the long-row combine at the shapes of its longest rows,
    each with the segment split its engine hoists: the node form on
    ``mixed`` (``prep``, tile width 128, rows of up to 375 chunks) under 4
    node planes, as ``nodes mixed`` runs it; the flat form on the first two
    of the service's mixed requests packed at tile width 8 (rows of 3,000
    chunks; the service holds them in two slots, its padding in one-chunk
    segments).  Bitwise against the plain versions, timed, beside the
    ``torch.segment_reduce`` yardstick.  With the node form, node A' and
    node E on the same 4 nodes (E into kept planes), where chunks of 128
    slots take their G-lane kernels: bitwise, timed.  Returns {kernel:
    {shape: row}}."""
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
    t, r, k = d.val.shape
    chunks, nnz = t * r, int((d.val != 0).sum().item())
    shape = f"nodes mixed K={k}, {bsz} nodes"
    act = torch.ones(bsz, dtype=torch.bool, device=dev)
    lbp, ubp = prep.lb0.repeat(bsz, 1), prep.ub0.repeat(bsz, 1)
    hoisted = dict(chunk_len=prep.chunk_len, max_chunk_len=prep.max_chunk_len)
    # A' and E where chunks are wider than kSerialWidth (8 slots): their
    # G-lane kernels, which the pbf K = 4 cells of phase 5b never take.
    a_args = (d.val, d.col, lbp, ubp, act, prep.n_pad)
    parts = tk.node_activities_gather_tiles(*a_args, **hoisted)
    stream = dict(val=8 * nnz, col=4 * nnz, chunk_len=4 * chunks)
    out["node_activities_gather_tiles"] = {shape: measured_row(
        torch, build, parts, tref.node_activities_gather_ref(*a_args),
        lambda: tk.node_activities_gather_tiles(*a_args, **hoisted),
        lambda: tref.node_activities_gather_ref(*a_args),
        dict(stream, bounds=16 * bsz * prep.n_pad, out=24 * bsz * chunks, mask=bsz),
        4 * nnz * bsz, plain_reps=1)}
    c_args = (*parts, d.chunk_row, prep.row_start, act)
    measure("node_combine_chunk_partials_tiles", shape,
            lambda: tk.node_combine_chunk_partials_tiles(*c_args, classes=prep.seg_classes),
            lambda: tref.node_combine_chunk_partials_ref(*c_args), parts, d.chunk_row,
            prep.row_start, bsz, act)
    aggs = tref.node_combine_chunk_partials_ref(*c_args)
    cfg = ops.DEFAULT_CONFIG
    e_args = (d.val, d.col, prep.ii_g, *aggs, prep.lhs_g, prep.rhs_g, lbp, ubp, act, prep.n_pad,
              cfg.int_eps)
    acc = tk.accumulator_planes(lbp)
    fill = lambda: (acc[0].fill_(-cfg.inf), acc[1].fill_(cfg.inf))  # noqa: E731
    fill()
    out["node_candidates_scatter_tiles"] = {shape: measured_row(
        torch, build, tk.node_candidates_scatter_tiles(*e_args, **hoisted, acc=acc),
        tref.node_candidates_scatter_ref(*e_args),
        lambda: tk.node_candidates_scatter_tiles(*e_args, **hoisted, acc=acc),
        lambda: tref.node_candidates_scatter_ref(*e_args),
        dict(stream, is_int=4 * nnz, sides=16 * chunks, aggregates=24 * bsz * chunks,
             bounds=16 * bsz * prep.n_pad, out=16 * bsz * prep.n_pad, mask=bsz),
        12 * nnz * bsz, plain_reps=1, reset=fill)}
    for name in ("node_activities_gather_tiles", "node_candidates_scatter_tiles"):
        out[name][shape]["instance"] = shape
        log_row(name, shape, out[name][shape])
    log(f"kernels node_activities_gather_tiles, node_candidates_scatter_tiles on {shape}: "
        f"longest chunk {prep.max_chunk_len} slots, G-lane kernels")

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
        log(f"profile solve pbf multi-chunk: wall {m_ms:.3f} ms, device busy {busy:.3f} ms, "
            f"idle share {1 - busy / m_ms:.3f}; top: {top}")
    return runs

# ---------------------------------------------------------------------------
# Phase 8: past 2^16 columns (the column-slab partitioned engine)
# ---------------------------------------------------------------------------


def log_row(kname, shape, r):
    extra = ""
    if "bound_all_slots_ms" in r:
        extra = f" bound_all_slots_ms={r['bound_all_slots_ms']:.4f}"
    if "parent_ms" in r:
        extra += (f" (before the redesign, same run: ms={r['parent_ms']:.4f} "
                  f"wrapper_ms={r['parent_wrapper_ms']:.4f})")
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
    dt = prep.lb0.dtype
    eps, int_eps, inf, outward = round_scalars(ops, dt)
    width = prep.n_pad
    v, flops = prep.lb0.element_size(), flops_of(torch, dt)
    act = torch.ones(1, dtype=torch.bool, device=prep.lb0.device)
    lbp, ubp = prep.lb0[None].clone(), prep.ub0[None].clone()
    rows = {}
    ta, r, k = part.a_val.shape
    a_nnz = int((part.a_val != 0).sum().item())
    a_args = (part.a_val, part.a_col_s, part.a_run_start, part.a_run_len, part.a_run_inst,
              part.a_run_slab, act, lbp, ubp, part.slab, part.a_max_run_len, inf)
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
    tail = (part.slab, part.max_run_len, eps, int_eps, inf, outward)
    want = tref.batched_slab_round_ref(*r_args, lbp, ubp, *tail)
    # The accumulator planes kept across the launches, as the round closure
    # keeps them (the merge hands them back); the tile maps and chunk
    # lengths hoisted by the partition.
    kw = dict(acc=tk.accumulator_planes(lbp, inf), tiles=(part.tile_inst, part.tile_slab),
              chunk_len=part.chunk_len, max_chunk_len=part.max_chunk_len)
    got = tk.batched_slab_round_tiles(*r_args, lbp.clone(), ubp.clone(), *tail, **kw)
    lbw, ubw = lbp.clone(), ubp.clone()
    held = tref.batched_slab_scatter_ref(
        part.val, part.col_s, part.ii_g, part.row_done, *strs, part.lhs_g, part.rhs_g,
        part.run_start, part.run_inst, part.run_slab, act, lbp, ubp, part.slab, int_eps, inf)
    # val at the nonzeros (each copy stops at its length, 4 B per chunk) or,
    # for the all-slot bound, at every slot; col_s and is_int_g per kept
    # nonzero; row_done, the straddle aggregates and the sides per chunk;
    # the window of each tile; the bounds; the accumulators written and read
    # once and handed back where they hold a candidate.
    common = dict(col_ii=8 * nnz, rows=(12 + 4 * v) * t * r, tiles=8 * t, bounds=2 * v * width,
                  stores=v * stores(torch, want[:2], (lbp, ubp)), accumulators=4 * v * width,
                  handback=v * int((held[0] != -inf).sum() + (held[1] != inf).sum()),
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
    m_args = (act, part.slab, eps, inf, outward)
    want_m = tref.apply_updates_slab_ref(lbp, ubp, *held, *m_args)
    want_m = (*want_m[:2], want_m[2].any(dim=1))
    # The candidates as #12 leaves them: planes of the scatters' value type.
    planes = tuple(x.to(kw["acc"][0].dtype) for x in held)
    got_m = tk.apply_updates_slab_tiles(lbp.clone(), ubp.clone(), planes[0].clone(),
                                        planes[1].clone(), *m_args)
    lbw, ubw, blw, buw = lbp.clone(), ubp.clone(), planes[0].clone(), planes[1].clone()
    rows["apply_updates_slab_tiles"] = measured_row(
        torch, build, got_m, want_m,
        lambda: tk.apply_updates_slab_tiles(lbw, ubw, blw, buw, *m_args),
        lambda: tref.apply_updates_slab_ref(lbp, ubp, *held, *m_args),
        dict(merge_bytes(torch, ops.bnd, lbp, ubp, *held, eps, act, inf),
             flags=4 * part.n_slabs + 1),
        6 * width,
        reset=fresh_inputs(torch, [(lbw, lbp), (ubw, ubp), (blw, planes[0]),
                                   (buw, planes[1])]),
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
    d = prep.d
    _, int_eps, inf, _ = round_scalars(ops, d.val.dtype)
    nnz = int((d.val != 0).sum().item())
    cols = prep.gather_columns()  # d.col, or a compact prep's widened once
    lb_g, ub_g = ops.gather_bounds(prep.lb0, prep.ub0, cols)
    flops = flops_of(torch, d.val.dtype)
    rows = {}

    def row(kname, got, want, fn_k, fn_p):
        rows[kname] = r = measured_row(torch, build, got, want, fn_k, fn_p,
                                       needed_bytes(kname, prep, nnz),
                                       OPS_PER_NNZ[kname] * nnz, flops=flops)
        r["instance"] = name
        log_row(kname, f"{name} (segment)", r)

    if prep.fits_one_chunk:
        args = (d.val, lb_g, ub_g, prep.ii_g, prep.lhs_g, prep.rhs_g, int_eps, inf)
        want = tref.fused_round_tiles_ref(*args)
        row("fused_round_tiles", tk.fused_round_tiles(*args), want,
            lambda: tk.fused_round_tiles(*args), lambda: tref.fused_round_tiles_ref(*args))
    else:
        a_args = (d.val, lb_g, ub_g, inf)
        partials = tref.activities_tiles_ref(*a_args)
        row("activities_tiles", tk.activities_tiles(*a_args), partials,
            lambda: tk.activities_tiles(*a_args), lambda: tref.activities_tiles_ref(*a_args))
        aggs = tref.combine_chunk_partials_ref(*partials, d.chunk_row, prep.row_start)
        b_args = (d.val, lb_g, ub_g, prep.ii_g, *aggs, prep.lhs_g, prep.rhs_g, int_eps, inf)
        want = tref.candidates_tiles_ref(*b_args)
        row("candidates_tiles", tk.candidates_tiles(*b_args), want,
            lambda: tk.candidates_tiles(*b_args), lambda: tref.candidates_tiles_ref(*b_args))
    index = prep.segment_index()
    kept = ops.segment_reduce(*want, index, prep.n_pad, inf)
    every = tref.scatter_round_ref(*want, d.col, prep.n_pad, inf)
    max_abs_err(torch, kept, tuple(e.to(kept[0].dtype) for e in every))
    kept_ms = time_ms(torch, lambda: ops.segment_reduce(*want, index, prep.n_pad, inf))
    every_ms = time_ms(torch, lambda: tref.scatter_round_ref(*want, d.col, prep.n_pad, inf),
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

    eps, _, inf, outward = round_scalars(ops, lb.dtype)
    # A threshold that only the second round's zero measure falls below
    # (float16's smallest subnormal: 1e-30 would round to 0 there).
    stop = rt_carry.EarlyStop(1e-30 if lb.element_size() > 2 else 2.0**-24, 1)
    st_k, st_p = rt_carry.armed_state(lb.device), rt_carry.armed_state(lb.device)
    cur_k, cur_p = (lb.clone(), ub.clone()), (lb.clone(), ub.clone())
    # The candidates as D leaves them: planes of the scatters' value type
    # (float32 beside 16-bit bounds).
    best = tuple(tk.accumulator_planes(lb, inf)[0].copy_(b) for b in best)
    empty = tk.accumulator_planes(lb, inf)
    for cand in (best, empty):
        acc = (cand[0].clone(), cand[1].clone())
        got = tk.apply_updates_tiles(*cur_k, *acc, eps, inf, outward, carry=st_k, stop=stop)
        want = tref.merge_carry_ref(*cur_p, cand[0].clone(), cand[1].clone(), eps, inf, outward,
                                    st_p, 0, 1, stop)
        err = max_abs_err(torch, (*got[:2], st_k), (*want[:2], st_p))
        planes_clean(torch, acc, inf, f"{name}: F with the early stop kept a candidate")
        cur_p = want[:2]
        first = first if cand is empty else st_p.tolist()[rt_carry.LAST]
    # Two rounds counted, or one where the first tightened nothing.
    fields = st_k.tolist()
    if fields[rt_carry.GO] != 0 or fields[rt_carry.ROUNDS] != 1 + first:
        fail(f"{name}: F with the early stop left the carry at {fields[:8]}")
    row = dict(instance=name, max_abs_err=err)
    if timed:
        armed = rt_carry.armed_state(lb.device)
        carry = armed.clone()
        lbw, ubw = lb.clone(), ub.clone()
        acc = (best[0].clone(), best[1].clone())
        partials = torch.empty(-(-lb.numel() // tref.MERGE_BLOCK), dtype=best[0].dtype,
                               device=lb.device)
        reset = fresh_inputs(torch, [(lbw, lb), (ubw, ub), (acc[0], best[0]), (acc[1], best[1]),
                                     (carry, armed)])
        narrow = (best[0].to(lb.dtype), best[1].to(lb.dtype))
        moved = dict(merge_bytes(torch, ops.bnd, lb, ub, *narrow, eps, inf=inf),
                     carry=4 * 8, partials=2 * partials.element_size() * partials.numel())
        b_ms, b_by = bound(sum(moved.values()), 10 * lb.numel(), flops_of(torch, lb.dtype))
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
    parent = (f" (before the redesign, same run: ms={r['parent_ms']:.4f} "
              f"wrapper_ms={r['parent_wrapper_ms']:.4f})" if "parent_ms" in r else "")
    log(f"kernel {key} on {inst}: max_abs_err={r['max_abs_err']} ms={r['ms']:.4f}{parent} "
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
                         measured, parent):
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
        hoisted = dict(chunk_len=pr.chunk_len, max_chunk_len=pr.max_chunk_len)
        acc = tk.accumulator_planes(lbp)
        fill = lambda acc=acc: (acc[0].fill_(-cfg.inf), acc[1].fill_(cfg.inf))  # noqa: E731
        for n_act in (8, POOL):
            act = pool_mask(torch, n_act, dev)
            shape = f"{name} K={MULTI_CHUNK_TILE_WIDTH} pool, {n_act} of {POOL} active"
            on = lambda xs, act=act: tuple(x[act] for x in xs)
            a_args = (pr.d.val, pr.d.col, lbp, ubp, act, pr.n_pad)
            parts = tref.node_activities_gather_ref(*a_args)
            got_p = tk.node_activities_gather_tiles(*a_args, **hoisted)
            c_args = (*parts, pr.d.chunk_row, pr.row_start, act)
            aggs = tref.node_combine_chunk_partials_ref(*c_args)
            got_a = tk.node_combine_chunk_partials_tiles(*c_args, classes=pr.seg_classes)
            e_args = (pr.d.val, pr.d.col, pr.ii_g, *aggs, pr.lhs_g, pr.rhs_g, lbp, ubp, act,
                      pr.n_pad, cfg.int_eps)
            fill()
            got_e = tk.node_candidates_scatter_tiles(*e_args, **hoisted, acc=acc)
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
            row_a = tier_row(
                torch, build, on(got_p), on(parts),
                lambda: tk.node_activities_gather_tiles(*a_args, **hoisted),
                lambda: tref.node_activities_gather_ref(*a_args),
                dict(val=ids["val"], col=pr.d.col.element_size() * nnz, chunk_len=4 * chunks,
                     bounds=8 * n_act * pr.n_pad, out=16 * n_act * chunks),
                4 * nnz * n_act, f32, float64_ms=base("node_activities_gather_tiles"))
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
            e_call = lambda: tk.node_candidates_scatter_tiles(*e_args, **hoisted, acc=acc)
            row_e = tier_row(
                torch, build, got_e, want_e, e_call,
                lambda: tref.node_candidates_scatter_ref(*e_args),
                dict(ids, aggregates=16 * n_act * chunks, bounds=8 * n_act * pr.n_pad,
                     out=8 * n_act * pr.n_pad),
                12 * nnz * n_act, f32, reset=fill,
                float64_ms=base("node_candidates_scatter_tiles"))
            # The wrapper as the round calls it: into its kept planes.
            row_e["wrapper_ms"] = time_ms(torch, e_call, reps=3, trials=3)
            parent_rows(torch, tk, parent, form, row_a, row_e, pr, lbp, ubp, act, parts, aggs,
                        want_e, cfg.inf, cfg.int_eps)
            add(f"node_activities_gather_tiles[{form}]", shape, row_a)
            add(f"node_candidates_scatter_tiles[{form}]", shape, row_e)
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
                      results, measured, parent):
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
                                pb30, measured, parent)
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

    dt = prep.lb0.dtype
    eps, int_eps, inf, outward = round_scalars(ops, dt)
    width = prep.n_pad
    lbp, ubp = prep.lb0[None].clone(), prep.ub0[None].clone()
    bl, bu = tref.partitioned_round_ref(part, lbp, ubp, int_eps, inf)
    # The candidates as #12 leaves them: planes of the scatters' value type
    # (float32 beside 16-bit bounds).
    empty = tk.accumulator_planes(lbp, inf)
    best = tuple(b[:, :width].to(empty[0].dtype).contiguous() for b in (bl, bu))
    stop = rt_carry.EarlyStop(1e-30 if lbp.element_size() > 2 else 2.0**-24, 1)
    blocks = -(-width // tref.MERGE_BLOCK)
    partials = torch.empty(blocks, dtype=empty[0].dtype, device=lbp.device)
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
        first = first if cand is empty else st_p.tolist()[rt_carry.LAST]
    # Two rounds counted, or one where the first tightened nothing (float16
    # on bandw: an infinite bound never tightens, its eps being 0).
    fields = st_k.tolist()
    if fields[rt_carry.GO] != 0 or fields[rt_carry.ROUNDS] != 1 + first:
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
    moved = dict(merge_bytes(torch, ops.bnd, lbp, ubp, *(b.to(dt) for b in best), eps,
                             inf=inf), carry=4 * 8, partials=2 * partials.element_size() * blocks)

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
    as_int = {8: torch.int64, 4: torch.int32, 2: torch.int16}[ring.element_size()]
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
    flops = flops_of(torch, dt)
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
# Phase 21: bfloat16 and float16 on the single-instance engines
# ---------------------------------------------------------------------------

HALF_SOURCE = "src/repro_torch/csrc/half_round.cu"
# The 16-bit types: (form label, torch dtype name).
HALF_TYPES = (("bf16", "bfloat16"), ("f16", "float16"))
# The instances whose 16-bit fixed points are held to the CPU plain run.
HALF_FIXED = ("pb", "mixed", "bandw")
HALF_TRIALS = 3
HALF_STOP = 0.05
# Each 16-bit form's kernels-line entry and the instance it is measured on:
# the instance of its float32 form's entry (phases 13, 15 and 16), so the
# three times stand side by side.
HALF_PRIMARY = {}
for _label, _compact in (("bf16", True), ("f16", False)):
    for _k, _inst, _c_inst in (
            ("fused_scatter_round_tiles", "pb", "pb30"),
            ("activities_gather_tiles", "mixed", "mixed30"),
            ("combine_chunk_partials_tiles", "mixed", None),
            ("candidates_scatter_tiles", "mixed", "mixed30"),
            ("apply_updates_tiles", "pb", None),
            ("activities_tiles", "mixed", None),
            ("candidates_tiles", "mixed", "mixed30"),
            ("fused_round_tiles", "pb", "pb30"),
            ("batched_slab_partials_tiles", "pbw", None),
            ("straddle_combine_tiles", "pbw", None),
            ("batched_slab_round_tiles", "pbw", None),
            ("apply_updates_slab_tiles", "pbw", None),
            ("record_round_tiles", "pb", None)):
        HALF_PRIMARY[f"{_k}[{_label}]"] = _inst
        if _compact and _c_inst:
            HALF_PRIMARY[f"{_k}[{_label}c]"] = _c_inst
    HALF_PRIMARY[f"apply_updates_tiles[{_label}+stop]"] = "pb"
    HALF_PRIMARY[f"apply_updates_slab_tiles[{_label}+stop]"] = "pbw"

# The CPU plain runs of HALF_FIXED, in a process of their own started with
# the script (minutes of a few CPU cores), so they overlap the card's
# phases.
HALF_CPU_CODE = r"""
import json, sys, time
import torch
out, src, specs = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
sys.path.insert(0, src)
import repro_torch as rt, repro_torch.data as td
torch.set_num_threads(4)
res = {}
for name, gen, kw in specs:
    p = getattr(td, gen)(**kw)
    for dt in ("bfloat16", "float16"):
        t = time.perf_counter()
        r = rt.propagate_block_ell(p, dtype=getattr(torch, dt), use_kernels=False, device="cpu")
        res[f"{name} {dt}"] = dict(rounds=int(r.rounds), converged=bool(r.converged),
                                   infeasible=bool(r.infeasible), lb=r.lb, ub=r.ub,
                                   seconds=time.perf_counter() - t)
torch.save(res, out)
"""


class HalfCpuRuns:
    """The process of phase 21's (or, with ``batched``, phase 22's) CPU
    plain runs, its output and its log."""

    def __init__(self, batched: bool = False):
        import tempfile

        import numpy as np

        self.phase = 22 if batched else 21
        self.dir = tempfile.mkdtemp(prefix=f"chip_smoke_phase{self.phase}_cpu_")
        self.out = os.path.join(self.dir, "runs.pt")
        self.err = open(os.path.join(self.dir, "stderr.txt"), "w")
        # Phase 22's child takes 3 threads beside phase 21's 4: the card's
        # host-bound phases need the rest of the host's 8 cores.
        threads = "3" if batched else "4"
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS=threads)
        root = Path(__file__).resolve().parent
        src = str(root / "src")
        if batched:
            argv = [HALF_BATCH_CPU_CODE, self.out, src, str(root),
                    json.dumps(half_batch_cpu_specs(np, None))]
        else:
            specs = [s for s in SPECS + WIDE_SPECS if s[0] in HALF_FIXED]
            argv = [HALF_CPU_CODE, self.out, src, json.dumps(specs)]
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen([sys.executable, "-c", *argv],
                                     env=env, stdout=subprocess.DEVNULL, stderr=self.err,
                                     preexec_fn=lambda: os.nice(19))

    def result(self, torch, timeout: float) -> dict:
        try:
            code = self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            fail(f"phase {self.phase}: the CPU plain runs did not finish "
                 f"{time.perf_counter() - self.t0:.0f} s after they started")
        if code != 0:
            self.err.flush()
            with open(self.err.name) as f:
                fail(f"phase {self.phase}: the CPU plain runs exited {code}: "
                     f"{f.read()[-3000:]}")
        return torch.load(self.out)

    def close(self):
        import shutil

        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.err.close()
        shutil.rmtree(self.dir, ignore_errors=True)


def half_form(prep) -> str:
    """The form of a 16-bit prep's D, A' and E: bf16, bf16c (compact) or f16."""
    import torch

    label = "bf16" if prep.d.val.dtype == torch.bfloat16 else "f16"
    return label + ("c" if prep.d.col.dtype == torch.int16 else "")


def half_phase(torch, np, rt, tk, tref, ops, build, dev, problems, probs13, wide, f32_rows, cpu):
    """Phase 21: bfloat16 and float16.  Every 16-bit form of D, A', the
    combine, E, F (and its stop form), A, B, C, #11, the straddle combine,
    #12, #15 (and its stop form) and the record kernel against its plain
    version on the card, bitwise (the scatters' float32 planes holding the
    candidates widened), timed on its float32 form's instance beside the
    float32 and float64 forms' times of this run; then, with the launch
    counters at zero, the fixed points at both types (each against the
    plain path on the card, bitwise, and ``pb``, ``mixed`` and ``bandw``
    against the CPU plain run of the same instance: rounds and verdicts
    exactly), and their walls beside float32's.  Returns ({form key: (row,
    instance)}, {form key: launches})."""
    t_phase = time.perf_counter()
    probs = {**problems, "pb30": probs13["pb30"], "mixed30": probs13["mixed30"], **wide}
    rows = {}

    def keep(kname, label, r, inst):
        key = f"{kname}[{label}]"
        rows.setdefault(key, {})[inst] = r
        f32 = f32_rows.get(half_float32_key(key))
        times = (f32[0]["ms"] if f32 is not None and f32[1] == inst else None,
                 half_float64_ms(f32_rows, key, inst))
        cell = lambda x: "not measured" if x is None else f"{x:.4f}"
        log(f"kernel {key} on {inst}: max_abs_err={r['max_abs_err']} ms={r['ms']:.4f} "
            f"(float32 form {cell(times[0])}, float64 form {cell(times[1])}) "
            f"wrapper_ms={r['wrapper_ms']:.4f} plain_ms={r['plain_ms']:.4f} "
            f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}, {sum(r['bytes'].values())} B: "
            f"{r['bytes']})")

    preps = {}
    for label, dtn in HALF_TYPES:
        dt = getattr(torch, dtn)
        names = ("pb", "banded", "mixed") + (("pb30", "mixed30") if label == "bf16" else ())
        for n in names:
            preps[n, label] = pr = rt.prepare_block_ell(probs[n], dtype=dt, device=dev)
            log(f"{dtn} prep {n}: n_pad={pr.n_pad} col {pr.d.col.dtype} ii_g {pr.ii_g.dtype} "
                f"form {half_form(pr)} fits_one_chunk={pr.fits_one_chunk}")
        # D, or A', the combine and E, then F, at the root bounds.
        for n in names:
            pr = preps[n, label]
            timed = n != "banded"
            got = check_kernels(torch, tk, tref, ops, build, n, probs[n], pr, pr.lb0, pr.ub0,
                                timed=timed, plain_trials=2)
            for kname, r in got.items():
                form = label if kname in NO_INDEX_STREAMS else half_form(pr)
                if timed:
                    keep(kname, form, r, n)
                else:
                    log(f"kernel {kname}[{form}] on {n}: bitwise its plain version")
        # F with the early stop on pb.
        pr = preps["pb", label]
        _, int_eps, inf, _ = round_scalars(ops, dt)
        best = tref.fused_scatter_round_tiles_ref(pr.d.val, pr.d.col, pr.ii_g, pr.lhs_g,
                                                  pr.rhs_g, pr.lb0, pr.ub0, pr.n_pad, int_eps,
                                                  inf)
        keep("apply_updates_tiles", f"{label}+stop",
             f_stop_check(torch, tk, tref, ops, build, "pb", pr.lb0, pr.ub0, best, timed=True),
             "pb")
        # The segment round's A, B and C.
        for n in ("pb", "mixed") + (("pb30", "mixed30") if label == "bf16" else ()):
            for kname, r in check_segment_kernels(torch, tk, tref, ops, build, n,
                                                  preps[n, label]).items():
                form = label if kname == "activities_tiles" else half_form(preps[n, label])
                keep(kname, form, r, n)
        # The partitioned round's kernels and #15's stop form.
        for n in ("bandw", "pbw"):
            t = time.perf_counter()
            pr = rt.prepare_block_ell(probs[n], dtype=dt, device=dev)
            part = pr.slab_partition()
            log(f"{dtn} partition {n}: slab {part.slab}, {part.n_straddle} straddle rows, "
                f"{time.perf_counter() - t:.1f} s")
            for kname, r in check_slab_kernels(torch, tk, tref, ops, build, n, pr, part).items():
                keep(kname, label, r, n)
            r = slab_stop_check(torch, tk, tref, ops, build, n, pr, part, timed=n == "pbw")
            if r:
                keep("apply_updates_slab_tiles", f"{label}+stop", r, "pbw")
        # The record kernel on pb's root bounds.
        pr = preps["pb", label]
        keep("record_round_tiles", label,
             record_check(torch, tk, tref, build, f"pb {label}", pr.lb0, pr.ub0, timed=True),
             "pb")

    # The fixed points, with the launches counted.
    tk.reset_launch_counts()
    fixed = {}
    for label, dtn in HALF_TYPES:
        dt = getattr(torch, dtn)
        for n in HALF_FIXED + (("pb30", "mixed30") if label == "bf16" else ()):
            r = rt.propagate_block_ell(probs[n], dtype=dt, device=dev)
            check_same(rt, f"{n} {label}", r, rt.propagate_block_ell(
                probs[n], dtype=dt, use_kernels=False, device=dev), True, "the plain path")
            check_same(rt, f"{n} {label} host_loop", rt.propagate_block_ell(
                probs[n], dtype=dt, driver="host_loop", device=dev), r, True, "device_loop")
            fixed[n, label] = r
            log(f"{dtn} {n}: rounds={r.rounds.item()} converged={r.converged.item()} "
                f"infeasible={r.infeasible.item()}; device_loop, host_loop and the plain path "
                "bitwise")
        for n in ("pb", "mixed") + (("pb30", "mixed30") if label == "bf16" else ()):
            seg = rt.propagate_block_ell(probs[n], dtype=dt, scatter="segment", device=dev)
            base = fixed[n, label] if (n, label) in fixed else rt.propagate_block_ell(
                probs[n], dtype=dt, device=dev)
            check_same(rt, f"segment {n} {label}", seg, base, True, "the fused engine")
        for n in ("pb", "bandw"):
            kw = dict(dtype=dt, stop_progress=HALF_STOP, device=dev)
            r = rt.propagate_block_ell(probs[n], **kw)
            check_same(rt, f"early stop {n} {label}", r,
                       rt.propagate_block_ell(probs[n], use_kernels=False, **kw), True,
                       "the plain path")
            log(f"early stop {n} {label}: rounds={r.rounds.item()} "
                f"progress={r.progress.item():.6g}; bitwise the plain path")
        tel = rt.propagate_block_ell(probs["pb"], dtype=dt, telemetry=TELEMETRY_CAP, device=dev)
        telemetry_same(torch, f"telemetry pb {label}", [fixed["pb", label]], [tel], 0, 0)
    launches = tk.form_counts()
    log(f"phase 21 launches by form: {json.dumps(launches)}")
    missing = [k for k in HALF_PRIMARY if launches.get(k, 0) <= 0]
    if missing:
        fail(f"the 16-bit runs never launched {missing}")

    # Against the CPU plain runs of the same instances.
    t = time.perf_counter()
    cpu_res = cpu.result(torch, timeout=900)
    log(f"phase 21: waited {time.perf_counter() - t:.1f} s for the CPU plain runs")
    for label, dtn in HALF_TYPES:
        for n in HALF_FIXED:
            c, r = cpu_res[f"{n} {dtn}"], fixed[n, label]
            got = (r.rounds.item(), r.converged.item(), r.infeasible.item())
            want = (c["rounds"], c["converged"], c["infeasible"])
            if got != want:
                fail(f"{n} {label}: (rounds, converged, infeasible) {got} on the card, "
                     f"{want} on the CPU")
            diff = int((r.lb.cpu() != c["lb"]).sum() + (r.ub.cpu() != c["ub"]).sum())
            log(f"{n} {label} against the CPU plain run ({c['seconds']:.1f} s there): rounds, "
                f"converged and infeasible equal; bounds differing as values: {diff}")

    # Walls: float32 and the 16-bit types, one each per trial, rotating.
    variants = [("float32", torch.float32), ("bfloat16", torch.bfloat16),
                ("float16", torch.float16)]
    runs = [(n, v) for n in HALF_FIXED for v in variants]
    samples = {}
    for trial in range(HALF_TRIALS):
        order = runs[trial % len(runs):] + runs[: trial % len(runs)]
        for n, (vname, dt) in order:
            samples.setdefault((n, vname), []).append(wall_ms(
                torch, lambda: rt.propagate_block_ell(probs[n], dtype=dt, device=dev)))
    for n in HALF_FIXED:
        cells = ", ".join(f"{v} {statistics.median(samples[n, v]):.3f}" for v, _ in variants)
        log(f"half walls {n} device_loop (ms, medians of {HALF_TRIALS}): {cells}")
    out = {}
    for key, inst in HALF_PRIMARY.items():
        r = dict(rows[key][inst])
        r["max_abs_err"] = max(v["max_abs_err"] for v in rows[key].values())
        f32 = f32_rows.get(half_float32_key(key))
        r["float32_ms"] = f32[0]["ms"] if f32 is not None and f32[1] == inst else None
        r["float64_ms"] = half_float64_ms(f32_rows, key, inst)
        out[key] = (r, inst)
    log(f"phase 21: {time.perf_counter() - t_phase:.1f} s")
    return out, {key: launches.get(key, 0) for key in HALF_PRIMARY}


def half_float32_key(key: str) -> str:
    """The float32 form's key of a 16-bit form's key."""
    base, form = key[:-1].split("[")
    form = form.replace("bf16c", "f32c").replace("bf16", "f32").replace("f16", "f32")
    return f"{base}[{form}]"


def half_float64_ms(f32_rows: dict, key: str, inst: str):
    """The float64 form's time of this run on ``inst`` where an earlier
    phase measured it there: the float32 entry's ``float64_ms``, or the
    float64 stop forms' and record kernels' own entries."""
    base, form = key[:-1].split("[")
    if "+" in form:  # the stop forms: the float64 stop form's own entry
        f64 = f32_rows.get(f"{base}[f64{form[form.index('+'):]}]")
        return f64[0]["ms"] if f64 is not None and f64[1] == inst else None
    if base.startswith("record_round"):
        f64 = f32_rows.get(base)
        return f64[0]["ms"] if f64 is not None and f64[1] == inst else None
    f32 = f32_rows.get(half_float32_key(key))
    return f32[0].get("float64_ms") if f32 is not None and f32[1] == inst else None


# ---------------------------------------------------------------------------
# Phase 22: bfloat16 and float16 on the batched, node, service and sharded
# entry points
# ---------------------------------------------------------------------------

HALF_BATCH_SOURCE = "src/repro_torch/csrc/half_batch_round.cu"
HALF_BATCH_NODES = 4  # pbf nodes of the fixed points held to the CPU plain run
HALF_BATCH_WIDE_NODES = 17  # pbw nodes: past the merge grid's 16 rows (#15 on the walk)
HALF_BATCH_SERVICE = 4  # requests of the short service stream: phase 10's first pb ones
# Each new 16-bit form's kernels-line entry and the shape it is measured on:
# its float32 form's (phases 14 and 15), so the three times stand side by
# side.
HALF_BATCH_PRIMARY = {}
for _label in ("bf16", "f16"):
    HALF_BATCH_PRIMARY.update({
        f"batched_fused_scatter_round_tiles[{_label}]": "fused bucket, 4 of 4 active",
        f"record_round_batch_tiles[{_label}]": "fused bucket, 4 of 4 active",
        f"node_fused_scatter_round_tiles[{_label}]": f"pbf pool, 8 of {POOL} active",
        f"apply_updates_batch_tiles[{_label}]": f"pbf pool, 8 of {POOL} active",
        f"apply_updates_batch_tiles[{_label}+stop]": f"pbf pool, 8 of {POOL} active",
        f"node_activities_gather_tiles[{_label}]": f"pbf K=4 pool, 8 of {POOL} active",
        f"node_combine_chunk_partials_tiles[{_label}]": f"pbf K=4 pool, 8 of {POOL} active",
        f"node_candidates_scatter_tiles[{_label}]": f"pbf K=4 pool, 8 of {POOL} active",
        f"node_slab_partials_tiles[{_label}]": f"pbw pool, 8 of {POOL} active",
        f"node_slab_round_tiles[{_label}]": f"pbw pool, 8 of {POOL} active",
        f"apply_updates_slab_tiles[{_label}+stop_rows]": "partitioned bucket",
    })
HALF_BATCH_PRIMARY.update({
    "node_fused_scatter_round_tiles[bf16c]": f"pb30 pool, 8 of {POOL} active",
    "node_activities_gather_tiles[bf16c]": f"pb30 K=4 pool, 8 of {POOL} active",
    "node_candidates_scatter_tiles[bf16c]": f"pb30 K=4 pool, 8 of {POOL} active",
})

# The CPU plain runs of phase 22's fixed points (the same calls as on the
# card, ``use_kernels=False`` on the CPU), in a process of their own started
# with the script, on a world of one gloo rank for the sharded ones.  The
# plain 16-bit rounds take the host seconds a round at these sizes (a
# batched round computes every slot of every instance), so the host runs
# the longest of them at float16 only, where they end in a few rounds: the
# bfloat16 fused and multi-chunk buckets (35 and 12 rounds) and nnz
# partition (12) are held to the card's plain path alone, as every run of
# the phase is.
HALF_BATCH_CPU_RUNS = (
    ("batch fused", "float16"), ("batch multi-chunk", "float16"), ("nodes pbf", "float16"),
    ("service pb", "float16"), ("propagate_sharded_rows banded", "float16"),
    ("propagate_sharded mixed", "float16"), ("nodes pbf", "bfloat16"),
    ("service pb", "bfloat16"), ("propagate_sharded_rows banded", "bfloat16"))
HALF_BATCH_CPU_CODE = r"""
import json, sys, time
import numpy as np
import torch
import torch.distributed as dist
out, src, root, specs = sys.argv[1], sys.argv[2], sys.argv[3], json.loads(sys.argv[4])
sys.path[:0] = [src, root]
import repro_torch as rt, repro_torch.data as td
import chip_smoke as cs
torch.set_num_threads(3)
dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
made = {}
def make(spec):
    key = json.dumps(spec)
    if key not in made:
        made[key] = getattr(td, spec[0])(**spec[1])
    return made[key]
def nodes(dt):
    pbf = make(specs["pbf"])
    lb, ub = cs.node_pool(np, rt, pbf, cs.HALF_BATCH_NODES, seed=3)
    n = rt.propagate_nodes(pbf, lb, ub, tile_width=cs.SOLVER_TILE_WIDTH, dtype=dt,
                           use_kernels=False, device="cpu")
    return [n.result(i) for i in range(cs.HALF_BATCH_NODES)]
def service(dt):
    stream = [make(s) for s in specs["service"]]
    return rt.PropagationService.from_problems(stream, slots=2, dtype=dt, use_kernels=False,
                                               device="cpu").serve(stream)
calls = {
    "batch fused": lambda dt: rt.propagate_batch([make(s) for s in specs["fused"]], dtype=dt,
                                                 use_kernels=False, device="cpu"),
    "batch multi-chunk": lambda dt: rt.propagate_batch([make(s) for s in specs["multi-chunk"]],
                                                       dtype=dt, use_kernels=False, device="cpu"),
    "nodes pbf": nodes,
    "service pb": service,
    "propagate_sharded_rows banded": lambda dt: [rt.core.propagate_sharded_rows(
        make(specs["banded"]), dtype=dt, device="cpu")],
    "propagate_sharded mixed": lambda dt: [rt.core.propagate_sharded(
        make(specs["mixed"]), dtype=dt, device="cpu")],
}
res = {}
for label, dtn in specs["runs"]:
    t = time.perf_counter()
    rs = calls[label](getattr(torch, dtn))
    res[f"{label} {dtn}"] = dict(
        flags=[(int(r.rounds), bool(r.converged), bool(r.infeasible)) for r in rs],
        seconds=time.perf_counter() - t)
dist.destroy_process_group()
torch.save(res, out)
"""


def half_batch_cpu_specs(np, td=None) -> dict:
    """The generator specs of phase 22's CPU plain runs (by name, as the
    card's instances are built)."""
    del td
    spec = {name: (gen, kw) for name, gen, kw in SPECS}
    return {
        "fused": [spec["pb"], ("make_pseudo_boolean", PBF), spec["banded"],
                  ("make_banded", BANDED1)],
        "multi-chunk": [spec["mixed"], ("make_mixed", MIXED1)],
        "pbf": ("make_pseudo_boolean", PBF),
        "service": [("make_pseudo_boolean", dict(n=60_000, m=int(m), seed=100 + i,
                                                 unit_frac=0.002))
                    for i, m in enumerate(service_rows(np)[:HALF_BATCH_SERVICE])],
        "banded": spec["banded"],
        "mixed": spec["mixed"],
        "runs": HALF_BATCH_CPU_RUNS,
    }


def half_err(torch, got, want) -> float:
    """:func:`max_abs_err` of 16-bit outputs: the scatters' float32 planes
    against the plain version's 16-bit candidates widened (exactly), and a
    NaN (the progress measure where a float16 bound is infinite) equal
    where both hold it."""
    got, want = list(got), list(want)
    for i, (g, w) in enumerate(zip(got, want)):
        if g.dtype == torch.float32 and w.dtype in (torch.bfloat16, torch.float16):
            want[i] = w = w.float()
        if g.is_floating_point() and g.dtype == w.dtype and g.shape == w.shape:
            both = torch.isnan(g) & torch.isnan(w)
            got[i], want[i] = g.masked_fill(both, 0), w.masked_fill(both, 0)
    return max_abs_err(torch, got, want)


def half_row(torch, build, got, want, fn_k, fn_p, moved, n_ops, reset=None, launches=1,
             plain_reps=1):
    """A 16-bit form against its plain version (:func:`half_err`), timed:
    the kernel's launches, the wrapper call and the plain version; its bound
    at float32's rate (the 16-bit forms compute in float32 and round)."""
    b_ms, b_by = bound(sum(moved.values()), n_ops, F32_FLOPS)
    return dict(max_abs_err=half_err(torch, got, want),
                ms=kernel_ms(torch, build, fn_k, reset=reset, launches=launches),
                wrapper_ms=(call_ms(torch, fn_k, reset) if reset is not None
                            else time_ms(torch, fn_k, reps=3, trials=3)),
                plain_ms=time_ms(torch, fn_p, reps=1, trials=plain_reps),
                bound_ms=b_ms, bound_by=b_by, bytes=moved)


def half_merge_bytes(torch, bnd, lb, ub, best_l, best_u, eps, active, inf) -> dict:
    """:func:`merge_bytes` at 16 bits: 2 B a bound, 4 B a float32
    candidate (read, and written back at the sentinel where one was
    held)."""
    out = merge_bytes(torch, bnd, lb, ub, best_l.to(lb.dtype), best_u.to(ub.dtype), eps, active,
                      inf)
    out["best"] *= 2
    out["handback"] *= 2
    return out


def half_batch_kernels(torch, np, rt, tk, tref, ops, build, dev, pops, pbf, pb30, pbw, pools,
                       dt, label, parent):
    """Phase 22's kernel checks at one 16-bit type ``dt``: every new form
    against its plain version on the card, timed.  Returns {form key:
    {shape: row}}."""
    eps, int_eps, inf, outward = round_scalars(ops, dt)
    rows = {}

    def add(key, shape, r):
        rows.setdefault(key, {})[shape] = r
        parent = (f" (before the redesign, same run: ms={r['parent_ms']:.4f} "
                  f"wrapper_ms={r['parent_wrapper_ms']:.4f})" if "parent_ms" in r else "")
        log(f"kernel {key} on {shape}: max_abs_err={r['max_abs_err']} ms={r['ms']:.4f}{parent} "
            f"wrapper_ms={r['wrapper_ms']:.4f} plain_ms={r['plain_ms']:.4f} "
            f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}, {sum(r['bytes'].values())} B: "
            f"{r['bytes']})")

    # #8 (int32 ids) on the fused bucket, 4 of 4 and 2 of 4 active, then the
    # batched record kernel on its planes.
    (batch,) = ops.packed_problems(pops["fused"])
    prep = ops.prepare_problem_batch(batch, dt, device=dev)
    d = prep.d
    if d.col.dtype != torch.int32 or d.val.dtype != dt:
        fail(f"{label} fused bucket: values {d.val.dtype}, ids {d.col.dtype}")
    acc = tk.accumulator_planes(d.lb0, inf)
    clean = lambda: (acc[0].fill_(-inf), acc[1].fill_(inf))
    kw = dict(acc=acc, chunk_len=d.chunk_len, max_chunk_len=prep.max_chunk_len, chunks=d.chunks)
    for n_act in (batch.size, 2):
        act_h = np.zeros(batch.size, bool)
        act_h[:: max(1, batch.size // n_act)][:n_act] = True
        act = torch.as_tensor(act_h, device=dev)
        args = (d.val, d.col, d.ii_g, d.lhs_g, d.rhs_g, d.lb0, d.ub0, d.tile_inst, act,
                prep.n_pad, int_eps, inf)
        clean()
        got = tuple(x.clone() for x in tk.batched_fused_scatter_round_tiles(*args, **kw))
        plain = lambda act=act: tref.batched_fused_scatter_round_ref(  # noqa: E731
            d.val, d.col_g, d.ii_g, d.lhs_g, d.rhs_g, d.lb0, d.ub0, prep.n_pad, int_eps, inf,
            active=act)
        shape = f"fused bucket, {n_act} of {batch.size} active"
        if n_act != batch.size:
            log(f"kernel batched_fused_scatter_round_tiles[{label}] on {shape}: max_abs_err="
                f"{half_err(torch, got, tuple(x.float() for x in plain()))}")
            continue
        chunks = int(d.chunks[-1].item())
        nnz = int((d.val != 0).sum().item())
        moved = dict(val=2 * nnz, col_ii=8 * nnz, rows=8 * chunks,
                     bounds=4 * n_act * prep.n_pad, planes=8 * n_act * prep.n_pad)
        add(f"batched_fused_scatter_round_tiles[{label}]", shape, half_row(
            torch, build, got, plain(), lambda: tk.batched_fused_scatter_round_tiles(*args, **kw),
            plain, moved, 16 * nnz, reset=clean))
    clean()
    bsz = batch.size
    ran = torch.tensor([True, False, True, True], device=dev)
    prog = torch.tensor([0.5, 0.25, 0.125, 2.0**-9], dtype=dt, device=dev)
    rounds = torch.full((bsz,), 3, dtype=torch.int32, device=dev)
    r = record_batch_check(torch, tk, tref, build, d.lb0, d.ub0, prog, rounds, ran, timed=True)
    r["bound_ms"], r["bound_by"] = bound(sum(r["bytes"].values()), 2 * 3 * d.lb0.shape[1],
                                         F32_FLOPS)
    add(f"record_round_batch_tiles[{label}]", "fused bucket, 4 of 4 active", r)

    # #10 on the pbf pool (int32 ids) and, at bfloat16, the pb30 pool (the
    # compact ids), 8 and 128 active; #9 and its stop form on pbf's.
    sets = [("pbf", pbf)] + ([("pb30", pb30)] if dt == torch.bfloat16 else [])
    best8 = None
    for name, p in sets:
        pr = rt.prepare_block_ell(p, tile_width=SOLVER_TILE_WIDTH, dtype=dt, device=dev)
        form = half_form(pr)
        lbp, ubp = ops._node_planes(pr, *pools[name])
        nacc = tk.accumulator_planes(lbp, inf)
        sentinels = lambda nacc=nacc: (nacc[0].fill_(-inf), nacc[1].fill_(inf))
        nnz = int((pr.d.val != 0).sum().item())
        for n_act in (8, POOL):
            act = pool_mask(torch, n_act, dev)
            args = (pr.d.val, pr.d.col, pr.ii_g, pr.lhs_g, pr.rhs_g, lbp, ubp, act, pr.n_pad,
                    int_eps, inf)
            nkw = dict(acc=nacc, chunk_len=pr.chunk_len, max_chunk_len=pr.max_chunk_len)
            sentinels()
            got = tuple(x.clone() for x in tk.node_fused_scatter_round_tiles(*args, **nkw))
            plain = lambda act=act: tref.node_fused_scatter_round_ref(  # noqa: E731
                *args[:7], pr.n_pad, int_eps, inf, active=act)
            want = plain()
            shape = f"{name} pool, {n_act} of {POOL} active"
            if n_act != 8:
                log(f"kernel node_fused_scatter_round_tiles[{form}] on {shape}: max_abs_err="
                    f"{half_err(torch, got, tuple(x.float() for x in want))}")
                continue
            if name == "pbf":
                best8 = (tuple(x.float() for x in want), act, lbp, ubp)
            moved = dict(stream_bytes(pr, nnz), bounds=4 * n_act * pr.n_pad,
                         out=8 * n_act * pr.n_pad)
            add(f"node_fused_scatter_round_tiles[{form}]", shape, half_row(
                torch, build, got, want, lambda: tk.node_fused_scatter_round_tiles(*args, **nkw),
                plain, moved, 16 * nnz * n_act, reset=sentinels))
        sentinels()
    want, act, lbp, ubp = best8
    shape = f"pbf pool, 8 of {POOL} active"
    lbw, ubw, blw, buw = lbp.clone(), ubp.clone(), want[0].clone(), want[1].clone()
    reset = fresh_inputs(torch, [(lbw, lbp), (ubw, ubp), (blw, want[0]), (buw, want[1])])
    m_plain = lambda: ops.bnd.apply_updates_batch(  # noqa: E731
        lbp, ubp, want[0].to(dt), want[1].to(dt), eps, inf, outward, active=act)
    got_m = tk.apply_updates_batch_tiles(lbp.clone(), ubp.clone(), want[0].clone(),
                                         want[1].clone(), act, eps, inf, outward)
    moved = dict(half_merge_bytes(torch, ops.bnd, lbp, ubp, *want, eps, act, inf),
                 flags=2 * POOL)
    add(f"apply_updates_batch_tiles[{label}]", shape, half_row(
        torch, build, got_m, m_plain(),
        lambda: tk.apply_updates_batch_tiles(lbw, ubw, blw, buw, act, eps, inf, outward),
        m_plain, moved, 6 * 8 * lbp.shape[1], reset=reset, plain_reps=3))
    # #9's stop form through two rounds of a stop (the candidates, then
    # none: a measure of 0), with 8 and 128 active.
    blocks = -(-lbp.shape[1] // tref.MERGE_BLOCK)
    for n_act in (8, POOL):
        act_s = pool_mask(torch, n_act, dev)
        pr = rt.prepare_block_ell(pbf, tile_width=SOLVER_TILE_WIDTH, dtype=dt, device=dev)
        cand = tuple(x.float() for x in tref.node_fused_scatter_round_ref(
            pr.d.val, pr.d.col, pr.ii_g, pr.lhs_g, pr.rhs_g, lbp, ubp, pr.n_pad, int_eps, inf,
            active=act_s))
        none = (torch.full_like(cand[0], -inf), torch.full_like(cand[1], inf))
        prog_k = torch.zeros(POOL, dtype=dt, device=dev)
        prog_p = prog_k.clone()
        part_k = torch.zeros((POOL, blocks), dtype=torch.float32, device=dev)
        ticket = torch.zeros(1, dtype=torch.int32, device=dev)
        lk, uk, lp, up = lbp.clone(), ubp.clone(), lbp, ubp
        err = 0.0
        for c in (cand, none):
            got = tk.apply_updates_batch_tiles(lk, uk, c[0].clone(), c[1].clone(), act_s, eps,
                                               inf, outward, progress=prog_k, partials=part_k,
                                               ticket=ticket)
            new = ops.bnd.apply_updates_batch(lp, up, c[0].to(dt), c[1].to(dt), eps, inf,
                                              outward, active=act_s)
            blocks_p, rows_p = tref.merge_rows_progress(lp, up, new[0], new[1])
            prog_p = torch.where(act_s, rows_p, prog_p)
            err = max(err, half_err(torch, (*got, prog_k, part_k[act_s]),
                                       (*new, prog_p, blocks_p[act_s])))
            if int(ticket.item()) != 0:
                fail(f"apply_updates_batch_tiles[{label}+stop]: the ticket is not back at 0")
            lk, uk, lp, up = got[0], got[1], new[0], new[1]
        if bool((part_k[~act_s] != 0).any()) or bool((prog_k[~act_s] != 0).any()):
            fail(f"apply_updates_batch_tiles[{label}+stop]: an inactive row was written")
        shape_s = f"pbf pool, {n_act} of {POOL} active"
        log(f"kernel apply_updates_batch_tiles[{label}+stop] on {shape_s}: two rounds of a stop "
            f"bitwise the plain version (bounds, flags, float32 partials, measure "
            f"{prog_k[act_s][:2].tolist()}); max_abs_err={err}")
        if n_act != 8:
            continue
        lbw, ubw, blw, buw = lbp.clone(), ubp.clone(), cand[0].clone(), cand[1].clone()
        reset = fresh_inputs(torch, [(lbw, lbp), (ubw, ubp), (blw, cand[0]), (buw, cand[1])])
        moved = dict(half_merge_bytes(torch, ops.bnd, lbp, ubp, *cand, eps, act_s, inf),
                     flags=2 * POOL, partials=8 * n_act * blocks, measure=2 * n_act)
        plain = lambda: tref.merge_rows_progress(  # noqa: E731
            lbp, ubp, *ops.bnd.apply_updates_batch(lbp, ubp, cand[0].to(dt), cand[1].to(dt),
                                                   eps, inf, outward, active=act_s)[:2])
        r = half_row(torch, build, (prog_k,), (prog_p,),
                     lambda: tk.apply_updates_batch_tiles(lbw, ubw, blw, buw, act_s, eps, inf,
                                                          outward, progress=prog_k,
                                                          partials=part_k, ticket=ticket),
                     plain, moved, 16 * n_act * lbp.shape[1], reset=reset)
        r["max_abs_err"] = err
        add(f"apply_updates_batch_tiles[{label}+stop]", shape_s, r)

    # The node-batched A', combine and E at tile width 4 on pbf (int32 ids)
    # and, at bfloat16, pb30 (compact), 8 and 128 active.
    for name, p in sets:
        pr = rt.prepare_block_ell(p, tile_width=MULTI_CHUNK_TILE_WIDTH, dtype=dt, device=dev)
        form = half_form(pr)
        t, r_, _ = pr.d.val.shape
        chunks, nnz = t * r_, int((pr.d.val != 0).sum().item())
        lbp, ubp = ops._node_planes(pr, *pools[name])
        hoisted = dict(chunk_len=pr.chunk_len, max_chunk_len=pr.max_chunk_len)
        acc = tk.accumulator_planes(lbp, inf)
        fill = lambda acc=acc: (acc[0].fill_(-inf), acc[1].fill_(inf))  # noqa: E731
        for n_act in (8, POOL):
            act = pool_mask(torch, n_act, dev)
            shape = f"{name} K={MULTI_CHUNK_TILE_WIDTH} pool, {n_act} of {POOL} active"
            on = lambda xs, act=act: tuple(x[act] for x in xs)
            a_args = (pr.d.val, pr.d.col, lbp, ubp, act, pr.n_pad, inf)
            parts = tref.node_activities_gather_ref(*a_args)
            got_p = tk.node_activities_gather_tiles(*a_args, **hoisted)
            c_args = (*parts, pr.d.chunk_row, pr.row_start, act)
            aggs = tref.node_combine_chunk_partials_ref(*c_args)
            got_a = tk.node_combine_chunk_partials_tiles(*c_args, classes=pr.seg_classes)
            e_args = (pr.d.val, pr.d.col, pr.ii_g, *aggs, pr.lhs_g, pr.rhs_g, lbp, ubp, act,
                      pr.n_pad, int_eps, inf)
            fill()
            got_e = tk.node_candidates_scatter_tiles(*e_args, **hoisted, acc=acc)
            want_e = tref.node_candidates_scatter_ref(*e_args)
            if n_act != 8:
                err = max(half_err(torch, on(got_p), on(parts)),
                          half_err(torch, on(got_a), on(aggs)),
                          half_err(torch, got_e, want_e))
                log(f"kernels node_activities_gather_tiles[{form}], node_combine_chunk_partials"
                    f"_tiles[{label}], node_candidates_scatter_tiles[{form}] on {shape}: "
                    f"max_abs_err={err}")
                continue
            ids = stream_bytes(pr, nnz)
            row_a = half_row(
                torch, build, on(got_p), on(parts),
                lambda: tk.node_activities_gather_tiles(*a_args, **hoisted),
                lambda: tref.node_activities_gather_ref(*a_args),
                dict(val=ids["val"], col=pr.d.col.element_size() * nnz, chunk_len=4 * chunks,
                     bounds=4 * n_act * pr.n_pad, out=12 * n_act * chunks),
                4 * nnz * n_act)
            if form == label:
                add(f"node_combine_chunk_partials_tiles[{label}]", shape, half_row(
                    torch, build, on(got_a), on(aggs),
                    lambda: tk.node_combine_chunk_partials_tiles(*c_args,
                                                                 classes=pr.seg_classes),
                    lambda: tref.node_combine_chunk_partials_ref(*c_args),
                    dict(partials=12 * n_act * chunks, row_start=8 * (pr.m + 2),
                         classes=4 * (pr.m + 1), out=12 * n_act * chunks, mask=POOL), 0))
            else:
                half_err(torch, on(got_a), on(aggs))
            e_call = lambda: tk.node_candidates_scatter_tiles(*e_args, **hoisted, acc=acc)
            row_e = half_row(
                torch, build, got_e, want_e, e_call,
                lambda: tref.node_candidates_scatter_ref(*e_args),
                dict(ids, aggregates=12 * n_act * chunks, bounds=4 * n_act * pr.n_pad,
                     out=8 * n_act * pr.n_pad),
                12 * nnz * n_act, reset=fill)
            # The wrapper as the round calls it: into its kept planes.
            row_e["wrapper_ms"] = time_ms(torch, e_call, reps=3, trials=3)
            parent_rows(torch, tk, parent, form, row_a, row_e, pr, lbp, ubp, act, parts, aggs,
                        want_e, inf, int_eps)
            add(f"node_activities_gather_tiles[{form}]", shape, row_a)
            add(f"node_candidates_scatter_tiles[{form}]", shape, row_e)

    # #13, the straddle combine over the active planes, #14 (with #15's
    # window merge, on the grid at 8 rows and the walk at 128) on the pbw
    # pool at tile width 8; #15's row-stop form there and on the
    # partitioned bucket.
    pr = rt.prepare_block_ell(pbw, tile_width=SOLVER_TILE_WIDTH, dtype=dt, device=dev)
    part = pr.slab_partition()
    lbp, ubp = ops._node_planes(pr, *pools["pbw"])
    width = pr.n_pad
    ta, r_, k = part.a_val.shape
    a_nnz = int((part.a_val != 0).sum().item())
    t, _, _ = part.val.shape
    nnz = int((part.val != 0).sum().item())
    straddle_chunks = int((part.row_done == 0).sum().item())
    kw = dict(acc=tk.accumulator_planes(lbp, inf), tile_slab=part.tile_slab,
              chunk_len=part.chunk_len, max_chunk_len=part.max_chunk_len)
    a_kw = dict(tile_slab=part.a_tile_slab, chunk_len=part.a_chunk_len,
                max_chunk_len=part.a_max_chunk_len)
    for n_act in (8, POOL):
        act = pool_mask(torch, n_act, dev)
        shape = f"pbw pool, {n_act} of {POOL} active"
        on = lambda xs, act=act: tuple(x[act] for x in xs)
        a_args = (part.a_val, part.a_col_s, part.a_run_start, part.a_run_len, part.a_run_slab,
                  act, lbp, ubp, part.slab, part.a_max_run_len, inf)
        partials = tref.node_slab_partials_ref(*a_args)
        got_p = tk.node_slab_partials_tiles(*a_args, **a_kw)
        index = (part.a_order, part.a_seg, part.agg_slot)
        strs_k = tk.straddle_combine_tiles(*partials, *index, act)
        strs = tref.straddle_combine_ref(*partials, *index, act)
        err = max(half_err(torch, on(got_p), on(partials)),
                  half_err(torch, on(strs_k), on(strs)))
        r_args = (part.val, part.col_s, part.ii_g, part.row_done, *strs, part.lhs_g,
                  part.rhs_g, part.run_start, part.run_len, part.run_slab, act)
        tail = (part.slab, part.max_run_len, eps, int_eps, inf, outward)
        want = tref.node_slab_round_ref(*r_args, lbp, ubp, *tail)
        got = tk.node_slab_round_tiles(*r_args, lbp.clone(), ubp.clone(), *tail, **kw)
        planes_clean(torch, kw["acc"], inf, f"#14 [{label}] on {shape}: planes not handed back")
        err = max(err, half_err(torch, got, want))
        log(f"kernels node_slab_partials_tiles[{label}], straddle_combine_tiles[{label}] (the "
            f"active planes), node_slab_round_tiles[{label}] with #15's "
            f"{'walk' if n_act > 16 else 'grid'} on {shape}: bitwise their plain versions "
            f"(max_abs_err {err})")
        if n_act != 8:
            continue
        sub = dict(val=2 * a_nnz, col=4 * a_nnz, chunk_len=4 * ta * r_, tiles=4 * ta)
        add(f"node_slab_partials_tiles[{label}]", shape, half_row(
            torch, build, on(got_p), on(partials),
            lambda: tk.node_slab_partials_tiles(*a_args, **a_kw),
            lambda: tref.node_slab_partials_ref(*a_args),
            dict(sub, bounds=4 * n_act * width, out=12 * n_act * ta * r_), 4 * a_nnz * n_act))
        lbw, ubw = lbp.clone(), ubp.clone()
        stream = dict(val=2 * nnz, col_ii=8 * nnz, rows=8 * t * r_, tiles=4 * t)
        common = dict(aggregates=12 * n_act * straddle_chunks, bounds=4 * n_act * width,
                      stores=2 * stores(torch, want[:2], (lbp, ubp)),
                      accumulators=16 * n_act * width, flags=4 * POOL * part.n_slabs + POOL)
        add(f"node_slab_round_tiles[{label}]", shape, half_row(
            torch, build, got, want, lambda: tk.node_slab_round_tiles(*r_args, lbw, ubw, *tail,
                                                                      **kw),
            lambda: tref.node_slab_round_ref(*r_args, lbp, ubp, *tail), dict(stream, **common),
            16 * nnz * n_act, reset=fresh_inputs(torch, [(lbw, lbp), (ubw, ubp)]), launches=2))
    # #15's row-stop form on the partitioned bucket's two planes (the grid).
    (pbatch,) = ops.packed_problems(pops["partitioned"])
    bprep = ops.prepare_problem_batch(pbatch, dt, device=dev)
    bpart = bprep.slab_partition()
    lbp, ubp = bprep.d.lb0.clone(), bprep.d.ub0.clone()
    bl, bu = tref.partitioned_round_ref(bpart, lbp, ubp, int_eps, inf)
    best = (bl[:, : bprep.n_pad].float().contiguous(), bu[:, : bprep.n_pad].float().contiguous())
    on2 = torch.ones(pbatch.size, dtype=torch.bool, device=dev)
    bsz, width = lbp.shape
    blocks = -(-width // tref.MERGE_BLOCK)
    prog_k = torch.full((bsz,), 9.0, dtype=dt, device=dev)
    prog_p = prog_k.clone()
    part_k = torch.full((bsz, blocks), 7.0, dtype=torch.float32, device=dev)
    ticket = torch.zeros(1, dtype=torch.int32, device=dev)
    none = (torch.full_like(best[0], -inf), torch.full_like(best[1], inf))
    lk, uk, lp, up = lbp.clone(), ubp.clone(), lbp, ubp
    err = 0.0
    for cand in (best, none):
        flags = tk.apply_updates_slab_tiles(lk, uk, cand[0].clone(), cand[1].clone(), on2,
                                            bpart.slab, eps, inf, outward, progress=prog_k,
                                            partials=part_k, ticket=ticket)[2]
        new = tref.apply_updates_slab_ref(lp, up, *cand, on2, bpart.slab, eps, inf, outward)
        blocks_p, rows_p = tref.merge_rows_progress(lp, up, new[0], new[1])
        prog_p = torch.where(on2, rows_p, prog_p)
        err = max(err, half_err(torch, (lk, uk, flags, prog_k, part_k),
                                   (new[0], new[1], new[2].any(dim=1), prog_p, blocks_p)))
        if int(ticket.item()) != 0:
            fail(f"#15's row measure [{label}] left its ticket at {int(ticket.item())}")
        lp, up = new[0], new[1]
    log(f"kernel apply_updates_slab_tiles[{label}+stop_rows] on the partitioned bucket: two "
        f"rounds bitwise the plain version (bounds, flags, float32 partials, measure "
        f"{prog_k.tolist()}); max_abs_err={err}")
    lbw, ubw, blw, buw = lbp.clone(), ubp.clone(), best[0].clone(), best[1].clone()
    reset = fresh_inputs(torch, [(lbw, lbp), (ubw, ubp), (blw, best[0]), (buw, best[1])])
    moved = dict(half_merge_bytes(torch, ops.bnd, lbp, ubp, *best, eps, on2, inf),
                 flags=4 * bsz * bpart.n_slabs + bsz, partials=8 * bsz * blocks,
                 measure=2 * bsz)
    plain = lambda: tref.merge_rows_progress(  # noqa: E731
        lbp, ubp, *tref.apply_updates_slab_ref(lbp, ubp, *best, on2, bpart.slab, eps, inf,
                                               outward)[:2])
    r = half_row(torch, build, (prog_k,), (prog_p,),
                 lambda: tk.apply_updates_slab_tiles(lbw, ubw, blw, buw, on2, bpart.slab, eps,
                                                     inf, outward, progress=prog_k,
                                                     partials=part_k, ticket=ticket),
                 plain, moved, 16 * bsz * width, reset=reset)
    r["max_abs_err"] = err
    add(f"apply_updates_slab_tiles[{label}+stop_rows]", "partitioned bucket", r)
    return rows


def half_sharded_rank(rank, world_size, instances, dtypes):
    """One rank of phase 22's sharded runs (a world of one NCCL rank): the
    row partition on banded and the nnz partition on mixed at each 16-bit
    type, with the launch counters at zero; each result, its launches and
    its wall (the median of :data:`SHARDED_REPS` after a barrier)."""
    import torch
    import torch.distributed as dist

    from repro_torch import core
    from repro_torch.kernels import prop_round as tk

    del rank, world_size
    out = {}
    for dtn in dtypes:
        dt = getattr(torch, dtn)
        for entry, name in (("propagate_sharded_rows", "banded"), ("propagate_sharded", "mixed")):
            fn = lambda: getattr(core, entry)(instances[name], dtype=dt)  # noqa: E731
            dist.barrier()
            tk.reset_launch_counts()
            res = fn()
            torch.cuda.synchronize()
            launched = {k: v for k, v in tk.form_counts().items() if v}
            times = []
            for _ in range(SHARDED_REPS):
                dist.barrier()
                torch.cuda.synchronize()
                t = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t) * 1e3)
            out[f"{entry} {name} {dtn}"] = dict(result=res, launches=launched,
                                                ms=statistics.median(times))
    return out


def half_batch_phase(torch, np, rt, td, tk, tref, ops, build, dev, problems, pops, pbf, probs13,
                     wide, f32_rows, cpu, parent):
    """Phase 22: bfloat16 and float16 on the batched, node, service and
    sharded entry points.  Every new 16-bit form (#8, #9 and its stop form,
    #10, the node-batched A', combine and E, #13, #14's scatter, #15's row
    stop form and the batched record kernel; bfloat16's compact node forms)
    against its plain version on the card, bitwise, timed beside the float32
    and float64 forms' times of this run; then, with the launch counters at
    zero, the fixed points at both types: ``propagate_batch`` on the fused,
    multi-chunk and partitioned buckets (the fused one also with telemetry,
    the partitioned one with the early stop), ``propagate_nodes`` on pbf
    (K = 8 and 4), pb30 and 17 pbw nodes, a short service stream and
    the sharded row and nnz partitions on one NCCL rank, each against the
    plain path on the card (bitwise) and those of
    :data:`HALF_BATCH_CPU_RUNS` against the CPU plain run of the same call
    (rounds and verdicts exactly), with walls beside float32's.  Returns
    ({form key: (row, instance)}, {form key: launches})."""
    from repro_torch.core import run_world

    t_phase = time.perf_counter()
    pb30, pbw = probs13["pb30"], wide["pbw"]
    rows = {}
    pools = {name: node_pool(np, rt, p, POOL, seed=3)
             for name, p in (("pbf", pbf), ("pb30", pb30), ("pbw", pbw))}
    for label, dtn in HALF_TYPES:
        dt = getattr(torch, dtn)
        for key, by_shape in half_batch_kernels(torch, np, rt, tk, tref, ops, build, dev, pops,
                                                pbf, pb30, pbw, pools, dt, label,
                                                parent).items():
            for shape, r in by_shape.items():
                rows.setdefault(key, {})[shape] = r
    log(f"phase 22 kernels: {time.perf_counter() - t_phase:.1f} s")

    # The fixed points, with the launches counted.
    stream = [getattr(td, gen)(**kw) for gen, kw in half_batch_cpu_specs(np)["service"]]
    nodes = node_pool(np, rt, pbf, HALF_BATCH_NODES, seed=3)
    nodes30 = node_pool(np, rt, pb30, 8, seed=3)
    nodesw = node_pool(np, rt, pbw, HALF_BATCH_WIDE_NODES, seed=3)
    calls = {
        "batch fused": lambda dt, **kw: rt.propagate_batch(pops["fused"], dtype=dt, **kw),
        "batch multi-chunk": lambda dt, **kw: rt.propagate_batch(pops["multi-chunk"], dtype=dt,
                                                                 **kw),
        "batch partitioned": lambda dt, **kw: rt.propagate_batch(pops["partitioned"], dtype=dt,
                                                                 **kw),
        "nodes pbf": lambda dt, **kw: rt.propagate_nodes(
            pbf, *nodes, tile_width=SOLVER_TILE_WIDTH, dtype=dt, **kw),
        "nodes pbf K=4": lambda dt, **kw: rt.propagate_nodes(
            pbf, *nodes, tile_width=MULTI_CHUNK_TILE_WIDTH, dtype=dt, **kw),
        "nodes pb30": lambda dt, **kw: rt.propagate_nodes(
            pb30, *nodes30, tile_width=SOLVER_TILE_WIDTH, dtype=dt, **kw),
        "nodes pb30 K=4": lambda dt, **kw: rt.propagate_nodes(
            pb30, *nodes30, tile_width=MULTI_CHUNK_TILE_WIDTH, dtype=dt, **kw),
        "nodes pbw": lambda dt, **kw: rt.propagate_nodes(
            pbw, *nodesw, tile_width=SOLVER_TILE_WIDTH, dtype=dt, **kw),
        "service pb": lambda dt, **kw: rt.PropagationService.from_problems(
            stream, slots=2, dtype=dt, **kw).serve(stream),
    }
    listed = lambda res: ([res.result(i) for i in range(res.lb.shape[0])]
                          if hasattr(res, "result") else list(res))
    flags_of = lambda rs: [(int(r.rounds), bool(r.converged), bool(r.infeasible)) for r in rs]
    tk.reset_launch_counts()
    fixed = {}
    for label, dtn in HALF_TYPES:
        dt = getattr(torch, dtn)
        for name, call in calls.items():
            got = listed(call(dt, device=dev))
            plain = listed(call(dt, device=dev, use_kernels=False))
            for i, (a, b) in enumerate(zip(got, plain)):
                check_same(rt, f"{name} {label} [{i}]", a, b, True, "the plain path")
            fixed[name, label] = got
            log(f"{dtn} {name}: (rounds, converged, infeasible) {flags_of(got)}; bitwise the "
                "plain path")
        # Telemetry on the fused bucket (T2, and #9 measuring every round),
        # the early stop on the partitioned one (#15's row-stop form).
        for name, kw in (("batch fused", dict(telemetry=TELEMETRY_CAP)),
                         ("batch partitioned", dict(stop_progress=HALF_STOP))):
            got = listed(calls[name](dt, device=dev, **kw))
            plain = listed(calls[name](dt, device=dev, use_kernels=False, **kw))
            for i, (a, b) in enumerate(zip(got, plain)):
                check_same(rt, f"{name} {label} {kw} [{i}]", a, b, True, "the plain path")
            log(f"{dtn} {name} {kw}: rounds {[int(r.rounds) for r in got]}; bitwise the plain "
                "path")
    launches = tk.form_counts()
    log(f"phase 22 launches by form: {json.dumps(launches)}")
    missing = [k for k in HALF_BATCH_PRIMARY if launches.get(k, 0) <= 0]
    if missing:
        fail(f"the 16-bit batched runs never launched {missing}")
    need = {"straddle_combine_tiles[bf16]", "straddle_combine_tiles[f16]",
            "apply_updates_slab_tiles[bf16]", "apply_updates_slab_tiles[f16]"}
    if any(launches.get(k, 0) <= 0 for k in need):
        fail(f"the 16-bit node and batch partitions never launched {sorted(need)}")

    # The sharded partitions on a world of one NCCL rank.
    instances = {"banded": problems["banded"], "mixed": problems["mixed"]}
    t = time.perf_counter()
    (rank0,) = run_world(half_sharded_rank, 1, backend="nccl", device="cuda",
                         args=(instances, [dtn for _, dtn in HALF_TYPES]), timeout=600)
    log(f"phase 22 sharded world 1 (nccl): {time.perf_counter() - t:.1f} s")
    sharded_need = {"propagate_sharded_rows": ("fused_scatter_round_tiles", "apply_updates_tiles"),
                    "propagate_sharded": ("activities_gather_tiles", "combine_chunk_partials_tiles",
                                          "candidates_scatter_tiles", "apply_updates_tiles")}
    for label, dtn in HALF_TYPES:
        for entry, name in (("propagate_sharded_rows", "banded"), ("propagate_sharded", "mixed")):
            run = rank0[f"{entry} {name} {dtn}"]
            res = run["result"]
            lb = res.lb if isinstance(res.lb, torch.Tensor) else torch.from_numpy(res.lb)
            if lb.dtype != getattr(torch, dtn):
                fail(f"{entry} {name} {label}: bounds of {lb.dtype}")
            fixed[f"{entry} {name}", label] = [res]
            missing = [k for k in sharded_need[entry] if run["launches"].get(f"{k}[{label}]", 0)
                       <= 0]
            if missing:
                fail(f"{entry} {name} {label}: never launched {missing}: {run['launches']}")
            log(f"{dtn} {entry} {name} (one NCCL rank): rounds={int(res.rounds)} "
                f"converged={bool(res.converged)} infeasible={bool(res.infeasible)} wall_ms "
                f"{run['ms']:.3f}; launches {run['launches']}")

    # Against the CPU plain runs of the same calls.
    t = time.perf_counter()
    cpu_res = cpu.result(torch, timeout=600)
    log(f"phase 22: waited {time.perf_counter() - t:.1f} s for the CPU plain runs")
    labels = {dtn: label for label, dtn in HALF_TYPES}
    for key, dtn in HALF_BATCH_CPU_RUNS:
        label = labels[dtn]
        c = cpu_res[f"{key} {dtn}"]
        got = flags_of(fixed[key, label])
        if got != [tuple(x) for x in c["flags"]]:
            fail(f"{key} {label}: (rounds, converged, infeasible) {got} on the card, "
                 f"{c['flags']} on the CPU")
        log(f"{key} {label} against the CPU plain run ({c['seconds']:.1f} s there): rounds, "
            f"converged and infeasible equal {got}")

    # Walls: float32 and the 16-bit types, one each per trial, rotating.
    variants = [("float32", torch.float32), ("bfloat16", torch.bfloat16),
                ("float16", torch.float16)]
    walled = ("batch fused", "batch multi-chunk", "nodes pbf", "service pb")
    runs_w = [(n, v) for n in walled for v in variants]
    for n, (_, dt) in runs_w:  # prepared and warm before the timed trials
        calls[n](dt, device=dev)
    samples = {}
    for trial in range(HALF_TRIALS):
        order = runs_w[trial % len(runs_w):] + runs_w[: trial % len(runs_w)]
        for n, (vname, dt) in order:
            samples.setdefault((n, vname), []).append(
                wall_ms(torch, lambda: calls[n](dt, device=dev)))
    for n in walled:
        cells = ", ".join(f"{v} {statistics.median(samples[n, v]):.3f}" for v, _ in variants)
        log(f"half walls {n} (ms, medians of {HALF_TRIALS}): {cells}")
    out = {}
    for key, shape in HALF_BATCH_PRIMARY.items():
        r = dict(rows[key][shape])
        r["max_abs_err"] = max(v["max_abs_err"] for v in rows[key].values())
        f32 = f32_rows.get(half_float32_key(key))
        r["float32_ms"] = f32[0]["ms"] if f32 is not None and f32[1] == shape else None
        r["float64_ms"] = half_float64_ms(f32_rows, key, shape)
        cell = lambda x: "not measured" if x is None else f"{x:.4f}"
        log(f"kernel {key} on {shape}: ms={r['ms']:.4f} (float32 form {cell(r['float32_ms'])}, "
            f"float64 form {cell(r['float64_ms'])})")
        out[key] = (r, shape)
    log(f"phase 22: {time.perf_counter() - t_phase:.1f} s")
    return out, {key: launches.get(key, 0) for key in HALF_BATCH_PRIMARY}


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


# Phase 18: the LM serving path (no kernel of its own: plain PyTorch).
# (arch, layers kept or None for the full depth); recurrentgemma-9b keeps
# its full width with one pattern period and the pattern_tail2 tail.
LM_MODELS = (("qwen2-0.5b", None), ("mamba2-780m", None), ("recurrentgemma-9b", 5))
LM_SEED = 0
LM_REPS = 5
LM_EXAMPLES = ("torch_quickstart.py", "torch_bnb_dive.py", "torch_presolve_service.py",
               "torch_serve_lm.py")
# The example twins' lines that carry a time or depend on it (the filter of
# tests/test_torch_examples.py).
LM_UNTIMED_DROP = ("ms wall", "latency p50=")


def lm_close(torch, got, want, tol: float, phase: int = 18):
    """Largest ``|got - want| - tol * |want|`` over ``tol``-scaled entries
    is at most ``tol`` (``allclose`` with ``rtol = atol = tol``); returns the
    largest absolute difference."""
    g, w = got.double(), want.double()
    if not (bool(torch.isfinite(g).all()) and bool(torch.isfinite(w).all())):
        fail(f"phase {phase}: non-finite values")
    diff = (g - w).abs()
    if bool((diff > tol + tol * w.abs()).any()):
        fail(f"phase {phase}: values differ by {float(diff.max()):.3e} (tolerance {tol})")
    return float(diff.max())


def lm_prefill_decode_gate(torch, tf, ss, model, cfg, dev, label, phase: int = 18):
    """Gate 1: prefill of 24 tokens + 4 decode steps against
    ``forward_train`` over all 28 (the reference test's property: 5e-2,
    greedy agreement >= 0.99)."""
    gen = torch.Generator(device=dev).manual_seed(LM_SEED + 2)
    toks = torch.randint(0, cfg.vocab_size, (2, 28), generator=gen, device=dev)
    with torch.no_grad():
        full, _ = tf.forward_train(model, cfg, toks)
    lg, caches = tf.prefill(model, cfg, toks[:, :24])
    errs = [lm_close(torch, lg[:, 0], full[:, 23], 5e-2, phase)]
    cache = ss.prefill_to_decode_cache(cfg, caches, 24, 48)
    agree = []
    for i in range(4):
        lg, cache = tf.decode_step(model, cfg, toks[:, 24 + i : 25 + i], cache, 24 + i)
        errs.append(lm_close(torch, lg[:, 0], full[:, 24 + i], 5e-2, phase))
        agree.append(float((lg[:, 0].argmax(-1) == full[:, 24 + i].argmax(-1)).float().mean()))
    if min(agree) < 0.99:
        fail(f"phase {phase} {label}: greedy agreement {agree}")
    log(f"phase {phase} {label}: float32 prefill 24 + 4 decode steps against forward_train over "
        f"28 tokens: max |diff| {max(errs):.3e} (tolerance 5e-2), greedy agreement "
        f"{min(agree):.2f}, logits scale {float(full.abs().max()):.1f}")


def lm_card_against_cpu(torch, tf, ss, model, cfg, dev, steps=4, s_prompt=16, b=2):
    """Gate 2: the port on the card against the port on the CPU, same
    weights: forward_train, prefill and ``steps`` decode logits within 1e-3."""
    host = tf.params_from_reference(cfg, model.numpy_tree(), device="cpu")
    gen = torch.Generator().manual_seed(LM_SEED + 3)
    toks = torch.randint(0, cfg.vocab_size, (b, s_prompt + steps), generator=gen)
    fe = None
    if cfg.frontend != "none":
        fe = torch.randn((b, cfg.n_frontend_tokens, cfg.d_model), generator=gen) * 0.1
    errs = []
    for m, d in ((model, dev), (host, "cpu")):
        with torch.no_grad():
            out = [tf.forward_train(m, cfg, toks.to(d), None if fe is None else fe.to(d))[0]]
        if steps:
            lg, caches = tf.prefill(m, cfg, toks[:, :s_prompt].to(d),
                                    None if fe is None else fe.to(d))
            out.append(lg)
            s0 = s_prompt + (0 if fe is None else fe.shape[1])
            cache = ss.prefill_to_decode_cache(cfg, caches, s0, s0 + steps)
            for i in range(steps):
                lg, cache = tf.decode_step(m, cfg, toks[:, s_prompt + i : s_prompt + i + 1].to(d),
                                           cache, s0 + i)
                out.append(lg)
        errs.append([o.cpu() for o in out])
    err = max(lm_close(torch, g, w, 1e-3) for g, w in zip(*errs))
    return err


def lm_serve_times(torch, ss, model, cfg, dev, b, s_prompt, steps, s_max):
    """``generate`` at bfloat16 after a warm-up, and its prefill (with the
    cache conversion) alone, as CUDA events: medians of :data:`LM_REPS`.
    The decode time per step is the rest of ``generate`` over its
    ``steps - 1`` decode steps.  Returns (prefill ms, decode ms per step,
    generate ms, tokens per second, peak MiB, a traced decode step)."""
    gen = torch.Generator(device=dev).manual_seed(LM_SEED + 1)
    prompt = torch.randint(0, cfg.vocab_size, (b, s_prompt), generator=gen, device=dev)
    fe = (torch.zeros((b, cfg.n_frontend_tokens, cfg.d_model), device=dev)
          if cfg.frontend != "none" else None)
    s0 = s_prompt + (0 if fe is None else fe.shape[1])
    prefill_fn = ss.make_prefill_fn(cfg)

    def timed(fn):
        e = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        with torch.inference_mode():
            e[0].record()
            out = fn()
            e[1].record()
        torch.cuda.synchronize()
        return e[0].elapsed_time(e[1]), out

    def prefill():
        _, caches = prefill_fn(model, prompt, fe)
        return ss.prefill_to_decode_cache(cfg, caches, s0, s_max)

    def whole():
        return ss.generate(model, cfg, prompt, steps=steps, s_max=s_max, frontend_embeds=fe)

    timed(whole)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    runs = [timed(whole) for _ in range(LM_REPS)]
    if any(tuple(out.shape) != (b, steps) for _, out in runs):
        fail(f"phase 18: generate returned {tuple(runs[0][1].shape)}")
    gen_ms = statistics.median(ms for ms, _ in runs)
    pre_ms = statistics.median(timed(prefill)[0] for _ in range(LM_REPS))
    peak = torch.cuda.max_memory_allocated() / 2**20

    # Four decode steps traced: device items and busy time per step beside
    # their CUDA-event wall, the device's idle share.
    serve_fn, cache = ss.make_serve_step(cfg), timed(prefill)[1]
    tok = prompt[:, -1:].to(torch.int32)

    def four_steps():
        c = cache
        for i in range(4):
            _, c = serve_fn(model, tok, c, s0 + i)

    four_steps()
    wall = statistics.median(timed(four_steps)[0] for _ in range(3)) / 4
    items = device_items(torch, four_steps)
    busy = sum(us for _, us in items) / 4e3
    names = {}
    for name, us in items:
        key = name.replace("(anonymous namespace)::", "").split("(")[0][:40]
        names[key] = names.get(key, 0.0) + us / 4e3
    top = ", ".join(f"{k} {v:.3f} ms" for k, v in sorted(names.items(), key=lambda kv: -kv[1])[:3])
    trace = dict(items=len(items) / 4, busy=busy, wall=wall, top=top)
    return (pre_ms, (gen_ms - pre_ms) / (steps - 1), gen_ms, b * steps / (gen_ms / 1e3), peak,
            trace)


def lm_examples():
    """Starts the four example twins on the card (their default device) and
    the presolve twin on the CPU, each in a process of its own that resets
    the kernels' launch counters and prints them on its standard error."""
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    wrapper = ("import json, runpy, sys\n"
               "from repro_torch.kernels import prop_round as tk\n"
               "path = sys.argv[1]\n"
               "sys.argv = sys.argv[1:]\n"
               "tk.reset_launch_counts()\n"
               "runpy.run_path(path, run_name='__main__')\n"
               "print('LAUNCHES ' + json.dumps({k: v for k, v in tk.launch_counts().items() "
               "if v}), file=sys.stderr)\n")
    runs = {name: [name] for name in LM_EXAMPLES}
    runs["torch_presolve_service.py --device cpu"] = ["torch_presolve_service.py", "--device",
                                                      "cpu"]
    return {label: subprocess.Popen(
        [sys.executable, "-c", wrapper, str(root / "examples" / argv[0]), *argv[1:]],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for label, argv in runs.items()}


def lm_untimed(text: str) -> list:
    import re

    out = []
    for line in text.splitlines():
        if any(s in line for s in LM_UNTIMED_DROP):
            continue
        line = re.sub(r"service up in [0-9.]+s:", "service up:", line)
        out.append(re.sub(r"mean occupancy=[0-9.]+ ", "", line))
    return out


def lm_examples_check(procs) -> None:
    outs = {}
    for label, proc in procs.items():
        try:
            out, err = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            fail(f"phase 18: example {label} did not finish in 300 s")
        if proc.returncode != 0:
            fail(f"phase 18: example {label} exited {proc.returncode}: {err[-2000:]}")
        launches = [line for line in err.splitlines() if line.startswith("LAUNCHES ")]
        outs[label] = out
        log(f"phase 18 example {label}: exit 0, kernel launches "
            f"{launches[-1][len('LAUNCHES '):] if launches else '{}'}")
        for line in out.splitlines():
            log(f"  | {line}")
    if "bounds match: True" not in outs["torch_quickstart.py"]:
        fail("phase 18: torch_quickstart.py: the bounds do not match the sequential reference")
    bnb = outs["torch_bnb_dive.py"]
    if "same optimum" not in bnb or "objective=-126.0" not in bnb:
        fail("phase 18: torch_bnb_dive.py: no equal optimum of -126.0")
    card = lm_untimed(outs["torch_presolve_service.py"])
    host = lm_untimed(outs["torch_presolve_service.py --device cpu"])
    if card != host:
        fail(f"phase 18: the presolve table on the card differs from the CPU twin's: "
             f"{card} != {host}")
    if len(outs["torch_serve_lm.py"].splitlines()) != 3:
        fail("phase 18: torch_serve_lm.py did not print its three archs")


def lm_phase(torch, dev):
    """Phase 18: the LM serving path (``repro_torch.models``,
    ``repro_torch.train.serve_step``) at full width on the card, its float32
    gates, its bfloat16 serving times, and the four example twins."""
    import dataclasses

    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.models import transformer as tf
    from repro_torch.train import serve_step as ss

    t_phase = time.perf_counter()
    procs = lm_examples()  # the twins run beside the gates, not the timed runs
    try:
        tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            models = {}
            for arch, layers in LM_MODELS:
                full = get_config(arch)
                cfg = full if layers is None else dataclasses.replace(full, num_layers=layers)
                cfg32 = dataclasses.replace(cfg, dtype="float32")
                t = time.perf_counter()
                gen = torch.Generator(device=dev).manual_seed(LM_SEED)
                model = tf.init_params(cfg32, gen, device=dev)
                torch.cuda.synchronize()
                n = tf.param_count(cfg32)
                log(f"phase 18 model {arch}: d_model={cfg.d_model} layers={cfg.num_layers} "
                    f"segments={cfg.segments()} vocab={cfg.vocab_size} params={n} "
                    f"({n * 4 / 2**30:.2f} GiB as fp32 masters), initialised on the card in "
                    f"{time.perf_counter() - t:.1f} s")
                if layers is not None:
                    log(f"phase 18 reduced: {arch} num_layers {full.num_layers} -> {layers} "
                        f"(segments {cfg.segments()}; full width kept: d_model {cfg.d_model}, "
                        f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size})")
                lm_prefill_decode_gate(torch, tf, ss, model, cfg32, dev, arch)
                models[arch] = (model, cfg)
            qwen, qcfg = models["qwen2-0.5b"]
            qcfg32 = dataclasses.replace(qcfg, dtype="float32")
            err = lm_card_against_cpu(torch, tf, ss, qwen, qcfg32, dev, steps=0, s_prompt=8,
                                      b=1)
            log(f"phase 18 qwen2-0.5b FULL, card against CPU on one 8-token prompt (float32, "
                f"same weights): forward logits max |diff| {err:.3e} (tolerance 1e-3)")
            for arch in ARCH_IDS:
                cfg = get_config(arch, smoke=True)
                model = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(LM_SEED),
                                       device=dev)
                err = lm_card_against_cpu(torch, tf, ss, model, cfg, dev)
                log(f"phase 18 {arch} SMOKE, card against CPU (float32, same weights): "
                    f"forward, prefill and 4 decode logits max |diff| {err:.3e} (tolerance "
                    "1e-3)")
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
        lm_examples_check(procs)

        shapes = ([(arch, 4, 16, 24, 64) for arch, _ in LM_MODELS]
                  + [("qwen2-0.5b", 32, 512, 64, 576)])
        for arch, b, s_prompt, steps, s_max in shapes:
            model, cfg = models[arch]
            pre, dec, gen_ms, tps, peak, tr = lm_serve_times(torch, ss, model, cfg, dev, b, s_prompt,
                                                             steps, s_max)
            log(f"phase 18 serve {arch} ({cfg.dtype}, b={b}, prompt {s_prompt}, {steps} "
                f"steps, s_max {s_max}): prefill {pre:.3f} ms, decode {dec:.3f} ms/step "
                f"(generate less prefill, over {steps - 1} steps), "
                f"generate {gen_ms:.3f} ms, {tps:.1f} tokens/s, peak {peak:.0f} MiB (medians "
                f"of {LM_REPS}, CUDA events); a decode step traced: {tr['items']:.0f} device "
                f"items, busy {tr['busy']:.3f} ms of {tr['wall']:.3f} ms wall, idle share "
                f"{1 - tr['busy'] / tr['wall']:.3f}; largest: {tr['top']}")
        del models
        torch.cuda.empty_cache()
    finally:  # stop every example process still running (a failed gate)
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    log(f"phase 18: {time.perf_counter() - t_phase:.1f} s")


# Phase 19: MoE/MLA serving and the training path (no kernel of their own).
# Serving: (arch, layers kept), full width; deepseek keeps its dense first
# layer and one MoE layer.  Training: (arch, layers kept or None, batch,
# sequence, steps) at bfloat16.
LM_MOE_MODELS = (("qwen3-moe-30b-a3b", 4), ("deepseek-v2-236b", 2))
LM_SERVE_SHAPE = (4, 16, 24, 64)  # serve_lm's: b, prompt, steps, s_max
LM_CAPACITY_TOKENS = (2, 2304)    # t = 4,608 > 4,096: the capacity path
LM_TRAIN_RUNS = (("qwen2-0.5b", None, 8, 512, 5), ("qwen3-moe-30b-a3b", 2, 2, 1024, 3))
LM_TRAIN_GATE = (1, 64)           # b, s of the float32 card-against-CPU step
LM_TRAIN_TOL = 1e-3


def lm_example_train():
    """``examples/torch_train_lm.py`` on the card in a process of its own."""
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    return subprocess.Popen([sys.executable, str(root / "examples" / "torch_train_lm.py")],
                            cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def lm_reduced(cfg, full, phase: int = 19):
    if cfg.num_layers != full.num_layers:
        log(f"phase {phase} reduced: {cfg.name} num_layers {full.num_layers} -> "
            f"{cfg.num_layers} (segments {cfg.segments()}; full width kept: d_model "
            f"{cfg.d_model}, n_experts {cfg.n_experts}, d_ff_expert {cfg.d_ff_expert}, "
            f"vocab {cfg.vocab_size})")


def lm_moe_capacity_check(torch, moe, tree_map, model, cfg, dev, capacity_factor):
    """``moe_apply`` of the first MoE layer at full width past 4,096 tokens
    (the capacity path, at ``capacity_factor``) on the card against the CPU,
    float32, same weights and input.  The routing and each routing's keep flag are compared
    first: a token whose routing differs must be a near-tie of its
    ``k``-th and ``k+1``-th probabilities (< 1e-5) and is left out of the
    output comparison with every token whose keep flags differ; the rest
    within 1e-3, the aux loss too."""
    from repro_torch.models.transformer import _moe_cfg

    mcfg = _moe_cfg(cfg)._replace(capacity_factor=capacity_factor)
    seg = cfg.segments().index(("moe", cfg.num_layers - cfg.first_k_dense))
    card = tree_map(lambda w: w[0].detach(), model.tree()["segments"][seg]["moe"])
    host = tree_map(lambda w: w.cpu(), card)
    gen = torch.Generator(device=dev).manual_seed(LM_SEED + 4)
    x = torch.randn(LM_CAPACITY_TOKENS + (cfg.d_model,), generator=gen, device=dev)
    t = x.shape[0] * x.shape[1]
    out = {}
    with torch.no_grad():
        for name, p, xx in (("card", card, x), ("cpu", host, x.cpu())):
            y, aux = moe.moe_apply(p, xx, mcfg)
            probs, _, experts = moe.route(p, xx.reshape(t, -1), mcfg)
            slot, keep = moe.slots(experts, mcfg.n_experts, moe.capacity(mcfg, t))
            out[name] = (y.cpu().reshape(t, -1), aux.cpu(), probs.cpu(), experts.cpu(),
                         keep.cpu().reshape(t, -1))
    (yc, auxc, pc, ec, kc), (yh, auxh, ph, eh, kh) = out["card"], out["cpu"]
    routed = (ec == eh).all(-1)
    for i in torch.nonzero(~routed).flatten().tolist():
        top = torch.sort(ph[i], descending=True).values
        gap = float(top[mcfg.top_k - 1] - top[mcfg.top_k])
        if gap >= 1e-5:
            fail(f"phase 19: token {i} routed apart on card and CPU (gap {gap:.3e})")
    same = routed & (kc == kh).all(-1)
    err = lm_close(torch, yc[same], yh[same], LM_TRAIN_TOL, 19)
    lm_close(torch, auxc, auxh, LM_TRAIN_TOL, 19)
    cap = moe.capacity(mcfg, t)
    log(f"phase 19 moe_apply {cfg.name} layer 0 at t = {t}, capacity factor "
        f"{capacity_factor} (cap {cap} per expert, "
        f"{mcfg.n_experts} experts, top {mcfg.top_k}), card against CPU (float32): "
        f"{int((~kc).sum())} of {t * mcfg.top_k} routings dropped on the card, "
        f"{int((~kh).sum())} on the CPU; {int((~routed).sum())} tokens routed apart (near-ties), "
        f"{int((routed & ~same).sum())} with other drops; outputs max |diff| {err:.3e} over "
        f"{int(same.sum())} tokens (tolerance {LM_TRAIN_TOL}), aux {float(auxc):.6f} against "
        f"{float(auxh):.6f}")


def lm_train_gate(torch, tf, ts, opt, tree_map, paths, model, cfg, dev):
    """The port's float32 loss and gradient, then one ``make_train_step``
    step, on the card against the CPU, same weights and batch: the loss,
    the gradient norm and each leaf's gradient within 1e-3 (``atol`` scaled
    by the leaf's largest magnitude, floored at 1e-6 of the model's largest
    gradient: the key bias's exact gradient is zero, and its rounding noise
    differs between the devices)."""
    from repro_torch.data.tokens import DataConfig, make_batch

    b, s = LM_TRAIN_GATE
    batch = make_batch(DataConfig(vocab_size=cfg.vocab_size, seq_len=s, global_batch=b,
                                  seed=LM_SEED), 0)
    host = tree_map(lambda w: w.detach(),
                    tf.params_from_reference(cfg, model.numpy_tree(), device="cpu").tree())
    card = tree_map(lambda w: w.detach(), model.tree())
    grad_fn = ts.value_and_grad(ts.make_loss_fn(cfg))
    opt_cfg = opt.OptimizerConfig(lr_peak=1e-4, warmup_steps=1, total_steps=10)
    step = ts.make_train_step(cfg, opt_cfg)
    res = {}
    for name, p in (("card", card), ("cpu", host)):
        (loss, _), g = grad_fn(p, batch)
        _, _, metrics = step(p, opt.init_opt_state(p, opt_cfg), batch)
        res[name] = (loss.cpu(), dict((k, v.cpu()) for k, v in paths(g)),
                     {k: v.cpu() for k, v in metrics.items()})
    (lc, gc, mc), (lh, gh, mh) = res["card"], res["cpu"]
    lm_close(torch, lc, lh, LM_TRAIN_TOL, 19)
    for k in ("loss", "grad_norm"):
        lm_close(torch, mc[k], mh[k], LM_TRAIN_TOL, 19)
    worst = 0.0
    top = max(float(v.abs().max()) for v in gh.values())
    for k, want in gh.items():
        scale = float(want.abs().max())
        diff = (gc[k].double() - want.double()).abs()
        if not bool(torch.isfinite(gc[k]).all()) or bool(
                (diff > LM_TRAIN_TOL * (scale + want.double().abs()) + 1e-6 * top).any()):
            fail(f"phase 19: gradient {k} on the card differs from the CPU's by "
                 f"{float(diff.max()):.3e} (leaf scale {scale:.3e})")
        worst = max(worst, float(diff.max()) / max(scale, 1e-30))
    log(f"phase 19 train gate {cfg.name} FULL (float32, b={b}, s={s}), card against CPU: loss "
        f"{float(lc):.6f} against {float(lh):.6f}, step loss {float(mc['loss']):.6f}, grad norm "
        f"{float(mc['grad_norm']):.6f} against {float(mh['grad_norm']):.6f}; {len(gh)} gradient "
        f"leaves, largest |diff| / leaf scale {worst:.3e} (tolerance {LM_TRAIN_TOL})")


def lm_train_times(torch, ts, opt, make_params, cfg, dev, b, s, steps):
    """``steps`` bfloat16 train steps on the tree ``make_params()`` on
    make_batch's tokens (nothing else holds the masters, so each step's
    update frees the last): each step's CUDA-event ms, then one step
    traced.  Returns (first ms, median ms of the rest, tokens/s, peak MiB,
    losses, trace)."""
    from repro_torch.data.tokens import DataConfig, make_batch

    opt_cfg = opt.OptimizerConfig(lr_peak=1e-4, warmup_steps=1, total_steps=steps + 1)
    step = ts.make_train_step(cfg, opt_cfg)
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=s, global_batch=b, seed=LM_SEED)
    state = [make_params(), None]
    state[1] = opt.init_opt_state(state[0], opt_cfg)
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []

    def one(i):
        batch = {k: torch.as_tensor(v, device=dev) for k, v in make_batch(data, i).items()}
        state[0], state[1], metrics = step(state[0], state[1], batch)
        return metrics

    for i in range(steps):
        e = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        e[0].record()
        metrics = one(i)
        e[1].record()
        torch.cuda.synchronize()
        times.append(e[0].elapsed_time(e[1]))
        losses.append(float(metrics["loss"]))
    peak = torch.cuda.max_memory_allocated() / 2**20
    if not all(math.isfinite(x) for x in losses):
        fail(f"phase 19: {cfg.name} train losses {losses}")
    items = device_items(torch, lambda: one(steps))
    busy = sum(us for _, us in items) / 1e3
    names = {}
    for name, us in items:
        key = name.replace("(anonymous namespace)::", "").split("(")[0][:40]
        names[key] = names.get(key, 0.0) + us / 1e3
    top = ", ".join(f"{k} {v:.3f} ms" for k, v in sorted(names.items(), key=lambda kv: -kv[1])[:3])
    rest = statistics.median(times[1:])
    return (times[0], rest, b * s / (rest / 1e3), peak, losses,
            dict(items=len(items), busy=busy, top=top))


def release_propagation_memory(torch):
    """Drops what phases 1-18 leave on the card -- the engines' caches pin
    their instances' prepared device buffers -- so phase 19's models have
    the card to themselves."""
    import gc

    from repro_torch.core import service, sharded
    from repro_torch.kernels import ops

    before = torch.cuda.memory_allocated() / 2**20
    for cache in (ops._prep_cache, ops._batch_prep_cache, ops._batch_runner_cache,
                  ops._pack_cache, service._engine_cache, sharded._shard_cache,
                  sharded._batch_shard_cache):
        cache.clear()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 19: {before:.0f} MiB allocated after phases 1-18, "
        f"{torch.cuda.memory_allocated() / 2**20:.0f} MiB after releasing their caches")


def lm_train_phase(torch, dev):
    """Phase 19: serving for the two archs with experts and MLA at full width
    (cut in depth), the capacity path of ``moe_apply``, and the training
    path (``repro_torch.train``): a float32 step on the card against the
    CPU, bfloat16 step times, and ``examples/torch_train_lm.py``.  The
    float32 gates run while the example runs; the timed runs after it."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.nn import moe
    from repro_torch.train import optimizer as opt
    from repro_torch.train import serve_step as ss
    from repro_torch.train import train_step as ts
    from repro_torch.train.tree import paths, tree_map

    def cut(arch, layers):
        full = get_config(arch)
        return full, (full if layers is None else dataclasses.replace(full, num_layers=layers))

    def make(cfg):
        return tf.init_params(dataclasses.replace(cfg, dtype="float32"),
                              torch.Generator(device=dev).manual_seed(LM_SEED), device=dev)

    t_phase = time.perf_counter()
    proc = lm_example_train()
    try:
        tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            for arch, layers in LM_MOE_MODELS:
                full, cfg = cut(arch, layers)
                cfg32 = dataclasses.replace(cfg, dtype="float32")
                torch.cuda.reset_peak_memory_stats()
                t = time.perf_counter()
                model = make(cfg)
                torch.cuda.synchronize()
                n = tf.param_count(cfg32)
                log(f"phase 19 model {arch}: d_model={cfg.d_model} layers={cfg.num_layers} "
                    f"segments={cfg.segments()} experts={cfg.n_experts} top_k={cfg.top_k} "
                    f"attn={cfg.attn_type} vocab={cfg.vocab_size} params={n} "
                    f"({n * 4 / 2**30:.2f} GiB as fp32 masters), initialised on the card in "
                    f"{time.perf_counter() - t:.1f} s")
                lm_reduced(cfg, full)
                lm_prefill_decode_gate(torch, tf, ss, model, cfg32, dev, arch, phase=19)
                if arch == "qwen3-moe-30b-a3b":  # the config's factor, and one that drops
                    for factor in (cfg.capacity_factor, 1.0):
                        lm_moe_capacity_check(torch, moe, tree_map, model, cfg32, dev, factor)
                log(f"phase 19 {arch}: peak {torch.cuda.max_memory_allocated() / 2**20:.0f} "
                    f"MiB over its float32 gates")
                del model
                torch.cuda.empty_cache()
            _, cfg = cut("qwen2-0.5b", None)
            model = make(cfg)
            lm_train_gate(torch, tf, ts, opt, tree_map, paths, model,
                          dataclasses.replace(cfg, dtype="float32"), dev)
            del model
            torch.cuda.empty_cache()
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32

        try:
            out, err = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            fail("phase 19: examples/torch_train_lm.py did not finish in 300 s")
        if proc.returncode != 0:
            fail(f"phase 19: examples/torch_train_lm.py exited {proc.returncode}: {err[-2000:]}")
        lines = out.strip().splitlines()
        log("phase 19 example torch_train_lm.py (the card): exit 0")
        for line in lines:
            log(f"  | {line}")
        if not lines or "(improved)" not in lines[-1]:
            fail("phase 19: examples/torch_train_lm.py did not end with 'improved'")

        b, s_prompt, steps, s_max = LM_SERVE_SHAPE
        for arch, layers in LM_MOE_MODELS:
            _, cfg = cut(arch, layers)
            model = make(cfg)
            pre, dec, gen_ms, tps, peak, tr = lm_serve_times(torch, ss, model, cfg, dev,
                                                             *LM_SERVE_SHAPE)
            del model
            torch.cuda.empty_cache()
            log(f"phase 19 serve {arch} ({cfg.dtype}, {cfg.num_layers} layers, b={b}, prompt "
                f"{s_prompt}, {steps} steps, s_max {s_max}): prefill {pre:.3f} ms, decode "
                f"{dec:.3f} ms/step (generate less prefill, over {steps - 1} steps), generate "
                f"{gen_ms:.3f} ms, {tps:.1f} tokens/s, peak {peak:.0f} MiB (medians of "
                f"{LM_REPS}, CUDA events); a decode step traced: {tr['items']:.0f} device "
                f"items, busy {tr['busy']:.3f} ms of {tr['wall']:.3f} ms wall, idle share "
                f"{1 - tr['busy'] / tr['wall']:.3f}; largest: {tr['top']}")

        for arch, layers, b, s, steps in LM_TRAIN_RUNS:
            full, cfg = cut(arch, layers)
            lm_reduced(cfg, full)
            first, ms, tps, peak, losses, tr = lm_train_times(
                torch, ts, opt, lambda: tree_map(lambda w: w.detach(), make(cfg).tree()), cfg,
                dev, b, s, steps)
            torch.cuda.empty_cache()
            log(f"phase 19 train {arch} ({cfg.dtype}, {cfg.num_layers} layers, b={b}, s={s}, "
                f"{steps} steps): first step {first:.3f} ms, then {ms:.3f} ms/step (median of "
                f"{steps - 1}, CUDA events), {tps:.1f} tokens/s, peak {peak:.0f} MiB, losses "
                f"{[round(x, 4) for x in losses]}; one more step traced: {tr['items']} device "
                f"items, busy {tr['busy']:.3f} ms; largest: {tr['top']}")
    finally:  # stop the example if a gate failed
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    log(f"phase 19: {time.perf_counter() - t_phase:.1f} s")


# Phase 20: sharded LM models on DTensor, the propagation rounds counted on a
# fake world, and the dry run.
LAUNCH_ARCH = "qwen2-0.5b"        # (a): FULL width on a (1, 1) mesh, float32
LAUNCH_TRAIN = (2, 64)            # b, s of (a)'s train step
LAUNCH_SERVE = (2, 16, 4, 32)     # b, prompt, decodes, cache slots of (a)'s serving
LAUNCH_TOL = 1e-5                 # (a), (b) against the unsharded port
LAUNCH_GLOO = "granite-3-2b"      # (b): SMOKE on a (2, 2) mesh of four gloo ranks, CPU tensors
LAUNCH_GLOO_TRAIN = (4, 32)       # b, s of (b)'s train step


def _launch_full(tree):
    from torch.distributed.tensor import DTensor

    from repro_torch.train.tree import tree_map

    return tree_map(lambda t: t.full_tensor() if isinstance(t, DTensor) else t, tree)


def _launch_leaf_gap(torch, got, want, top) -> float:
    """Largest ``|got - want|`` over the leaf's scale; raises past
    ``LAUNCH_TOL`` of the scale (floored at 1e-6 of the model's largest)."""
    scale = float(want.abs().max())
    diff = float((got.double() - want.double()).abs().max())
    if not bool(torch.isfinite(got).all()) or diff > LAUNCH_TOL * scale + 1e-6 * top:
        raise AssertionError(f"gap {diff:.3e} at leaf scale {scale:.3e}")
    return diff / max(scale, 1e-30)


def _launch_serve_gap(cfg, tree, placed, mesh, toks, steps: int, s_max: int) -> float:
    """A prefill of ``toks`` and ``steps`` greedy decodes (a cache of
    ``s_max`` slots) through ``make_prefill_fn`` / ``make_serve_step``
    unsharded on ``tree`` and with ``mesh`` on ``placed`` (the decode cache
    placed by ``cache_spec``): the largest |difference| of their logits
    over the unsharded logits' scale; raises past LAUNCH_TOL."""
    import torch

    from repro_torch.launch import sharding as sh
    from repro_torch.train import serve_step as ss

    shd = sh.Sharder(mesh)
    prompt = toks.shape[1]
    runs = []
    for m in (None, mesh):
        params = tree if m is None else placed
        tk = toks if m is None else shd.batch(toks)
        logits, caches = ss.make_prefill_fn(cfg, m)(params, tk)
        with shd.region() if m is not None else contextlib.nullcontext():
            cache = ss.prefill_to_decode_cache(cfg, caches, prompt, s_max)
        if m is not None:  # placed by cache_spec: KV heads or the sequence over "model"
            cache = sh.shard_tree(cache, sh.batch_shardings(cfg, m, {"cache": cache})["cache"])
        seen = [_launch_full({"x": logits})["x"]]
        serve = ss.make_serve_step(cfg, m)
        for i in range(steps):
            tok = torch.argmax(seen[-1][:, -1], dim=-1)[:, None].to(torch.int32)
            logits, cache = serve(params, tok if m is None else shd.batch(tok), cache,
                                  prompt + i)
            seen.append(_launch_full({"x": logits})["x"])
        runs.append(seen)
    gap = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
              for a, b in zip(runs[1], runs[0]))
    if gap > LAUNCH_TOL:
        raise AssertionError(f"serving logits differ by {gap:.3e} of their scale")
    return gap


def launch_gloo_rank(rank, world_size):
    """Phase 20 (b), on a world of four gloo ranks with CPU tensors:
    ``granite-3-2b`` SMOKE (float32) on a ``(2, 2)`` mesh through
    ``make_train_step(..., mesh=)``, one step against the unsharded port
    step on the same weights in this rank (loss within LAUNCH_TOL relative,
    every new parameter within LAUNCH_TOL), then a prefill and decodes with
    the decode cache split over its sequence, as ``_launch_serve_gap``
    holds them.  CPU tensors: with the card's PyTorch, gloo dies on
    DTensor's all-gather, reduce-scatter and all-to-all of CUDA tensors
    (``tools/dtensor_gloo.py``)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import DataConfig, make_batch
    from repro_torch.launch import mesh as lmesh
    from repro_torch.launch import sharding as sh
    from repro_torch.models import transformer as tf
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts
    from repro_torch.train.tree import paths, tree_map

    del rank, world_size
    cfg = get_config(LAUNCH_GLOO, smoke=True)
    tree = tree_map(lambda w: w.detach(), tf.init_params(cfg, LM_SEED, device="cpu").tree())
    mesh = lmesh.make_test_mesh((2, 2), device_type="cpu")
    placed = sh.shard_tree(tree, sh.param_shardings(cfg, mesh))
    b, s = LAUNCH_GLOO_TRAIN
    batch = make_batch(DataConfig(vocab_size=cfg.vocab_size, seq_len=s, global_batch=b,
                                  seed=LM_SEED), 0)
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    oc = opt.OptimizerConfig(lr_peak=1e-3, warmup_steps=1, total_steps=10)
    p0, _, m0 = ts.make_train_step(cfg, oc)(tree, opt.init_opt_state(tree, oc), batch)
    state = sh.shard_tree(opt.init_opt_state(tree, oc), sh.opt_state_shardings(cfg, mesh, oc))
    p1, _, m1 = ts.make_train_step(cfg, oc, mesh)(
        placed, state, sh.shard_tree(batch, sh.batch_shardings(cfg, mesh, batch)))
    p1 = dict(paths(_launch_full(p1)))
    out = {"loss": (float(m0["loss"]), float(_launch_full({"l": m1["loss"]})["l"])),
           "param_gap": max(float((p1[k] - v).abs().max()) for k, v in paths(p0))}
    if out["param_gap"] > LAUNCH_TOL:
        raise AssertionError(f"params differ by {out['param_gap']:.3e}")
    bs, prompt, steps, s_max = LAUNCH_SERVE
    toks = torch.randint(0, cfg.vocab_size, (bs, prompt),
                         generator=torch.Generator().manual_seed(LM_SEED))
    out["serve_gap"] = _launch_serve_gap(cfg, tree, placed, mesh, toks, steps, s_max)
    return out


def launch_nccl_rank(rank, world_size):
    """Phase 20 (a), on a world of one NCCL rank: ``qwen2-0.5b`` FULL width
    (float32) through ``make_train_step(..., mesh=)`` on a ``(1, 1)`` mesh
    against the unsharded port step on the same weights (loss, every
    gradient leaf and the new params within LAUNCH_TOL of the leaf's
    scale), then a prefill and decodes through ``make_prefill_fn`` /
    ``make_serve_step`` with the mesh against the unsharded ones."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import DataConfig, make_batch
    from repro_torch.launch import mesh as lmesh
    from repro_torch.launch import sharding as sh
    from repro_torch.models import transformer as tf
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts
    from repro_torch.train.tree import paths, tree_map

    del rank, world_size
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = dataclasses.replace(get_config(LAUNCH_ARCH), dtype="float32")
    model = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(LM_SEED), device=dev)
    tree = tree_map(lambda w: w.detach(), model.tree())
    del model
    mesh = lmesh.make_test_mesh((1, 1), device_type="cuda")
    shd = sh.Sharder(mesh)
    placed = sh.shard_tree(tree, sh.param_shardings(cfg, mesh))
    b, s = LAUNCH_TRAIN
    batch = make_batch(DataConfig(vocab_size=cfg.vocab_size, seq_len=s, global_batch=b,
                                  seed=LM_SEED), 0)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    placed_batch = sh.shard_tree(batch, sh.batch_shardings(cfg, mesh, batch))
    out = {}
    t = time.perf_counter()
    (l0, _), g0 = ts.value_and_grad(ts.make_loss_fn(cfg))(tree, batch)
    with shd.region():
        (l1, _), g1 = ts.value_and_grad(ts.make_loss_fn(cfg, shd))(placed, placed_batch)
    g0, g1 = dict(paths(g0)), dict(paths(_launch_full(g1)))
    top = max(float(v.abs().max()) for v in g0.values())
    out["grad_gap"] = max(_launch_leaf_gap(torch, g1[k], g0[k], top) for k in g0)
    out["leaves"] = len(g0)
    out["loss"] = (float(l0), float(_launch_full({"l": l1})["l"]))
    # Entries whose gradient is at the rounding level (the key bias's is
    # exactly zero) take Adam's ~lr * sign(g) either way: held to 2 lr.
    noise = {k: g.abs() <= 1e-6 * top for k, g in g0.items()}
    out["noise_entries"] = int(sum(int(m.sum()) for m in noise.values()))
    del g0, g1
    opt_cfg = opt.OptimizerConfig(lr_peak=1e-4, warmup_steps=1, total_steps=10)
    p0, _, m0 = ts.make_train_step(cfg, opt_cfg)(tree, opt.init_opt_state(tree, opt_cfg), batch)
    state = sh.shard_tree(opt.init_opt_state(tree, opt_cfg),
                          sh.opt_state_shardings(cfg, mesh, opt_cfg))
    p1, _, m1 = ts.make_train_step(cfg, opt_cfg, mesh)(placed, state, placed_batch)
    del state
    p0, p1 = dict(paths(p0)), dict(paths(_launch_full(p1)))
    top = max(float(v.abs().max()) for v in p0.values())
    bound = 2 * opt_cfg.lr_peak
    for k in p0:
        if bool(((p1[k] - p0[k]).abs()[noise[k]] > bound).any()):
            raise AssertionError(f"param {k}: a rounding-level entry moved past Adam's bound")
        p1[k] = torch.where(noise[k], p0[k], p1[k])
    out["param_gap"] = max(_launch_leaf_gap(torch, p1[k], p0[k], top) for k in p0)
    out["step_loss"] = (float(m0["loss"]), float(_launch_full({"l": m1["loss"]})["l"]))
    del p0, p1
    torch.cuda.synchronize()
    out["train_s"] = time.perf_counter() - t
    bs, prompt, steps, s_max = LAUNCH_SERVE
    toks = torch.randint(0, cfg.vocab_size, (bs, prompt), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(LM_SEED))
    out["serve_gap"] = _launch_serve_gap(cfg, tree, placed, mesh, toks, steps, s_max)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return out


def launch_phase(torch, dev, parts: str = "abcd", dry: "DryRun | None" = None):
    """Phase 20: (a) the sharded step and serving at full width on one NCCL
    rank, (b) a SMOKE step and serving on a (2, 2) mesh of four gloo ranks
    on the host (CPU tensors), (c) one counted round of each propagation partition on the card
    at the reference's size (256 fake ranks) and (d) the dry run itself
    (``parts`` picks some)."""
    from repro_torch.core import run_world
    from repro_torch.launch import dryrun, perf

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    log(f"phase 20 card memory: total_memory {torch.cuda.get_device_properties(0).total_memory} B "
        f"({torch.cuda.get_device_name(0)})")
    if "a" in parts:
        launch_a(run_world)
    if "b" in parts:
        launch_b(run_world)
    if "c" in parts:
        launch_c(perf)
    if "d" in parts:
        launch_d(dryrun, dry)
    log(f"phase 20: {time.perf_counter() - t_phase:.1f} s")


def launch_a(run_world):
    t = time.perf_counter()
    try:
        (a,) = run_world(launch_nccl_rank, 1, backend="nccl", device="cuda", timeout=600)
    except RuntimeError as e:
        fail(f"phase 20 (a): {e}")
    log(f"phase 20 (a) {LAUNCH_ARCH} FULL (float32, b={LAUNCH_TRAIN[0]}, s={LAUNCH_TRAIN[1]}) "
        f"on a (1, 1) mesh, one NCCL rank, against the unsharded port: loss {a['loss'][1]:.6f} "
        f"against {a['loss'][0]:.6f}; {a['leaves']} gradient leaves, largest |diff| / leaf "
        f"scale {a['grad_gap']:.3e}; step loss {a['step_loss'][1]:.6f} against "
        f"{a['step_loss'][0]:.6f}, params {a['param_gap']:.3e} ({a['noise_entries']} entries with "
        f"a rounding-level gradient held to Adam's bound 2 lr); prefill + "
        f"{LAUNCH_SERVE[2]} decodes: logits {a['serve_gap']:.3e} of their scale (tolerance "
        f"{LAUNCH_TOL}); peak {a['peak_gib']:.1f} GiB; {time.perf_counter() - t:.1f} s")
    if abs(a["loss"][1] - a["loss"][0]) > LAUNCH_TOL * abs(a["loss"][0]):
        fail(f"phase 20 (a): sharded loss {a['loss'][1]} against {a['loss'][0]}")


def launch_b(run_world):
    t = time.perf_counter()
    try:
        ranks = run_world(launch_gloo_rank, 4, backend="gloo", device="cpu", timeout=300)
    except RuntimeError as e:
        fail(f"phase 20 (b): {e}")
    b = ranks[0]
    log(f"phase 20 (b) {LAUNCH_GLOO} SMOKE (float32, b={LAUNCH_GLOO_TRAIN[0]}, "
        f"s={LAUNCH_GLOO_TRAIN[1]}) on a (2, 2) mesh, four gloo ranks with CPU tensors, against "
        f"the unsharded port: loss {b['loss'][1]:.6f} against {b['loss'][0]:.6f}; params "
        f"{b['param_gap']:.3e}; prefill + {LAUNCH_SERVE[2]} decodes (cache of {LAUNCH_SERVE[3]} "
        f"slots split over its sequence): logits {b['serve_gap']:.3e} of their scale "
        f"(tolerance {LAUNCH_TOL}); {time.perf_counter() - t:.1f} s")
    losses = {r["loss"][1] for r in ranks}
    if len(losses) != 1 or abs(b["loss"][1] - b["loss"][0]) > LAUNCH_TOL * abs(b["loss"][0]):
        fail(f"phase 20 (b): sharded losses {losses} against {b['loss'][0]}")


def launch_c(perf):
    t = time.perf_counter()
    recs = perf.run_propagation_variants("single", device="cuda")
    for r in recs:
        log(f"phase 20 (c) {r['variant']} (m=250000, n=125000, nnz=4000000, float32, "
            f"{r['world']} fake ranks, rank 0 on the card): counted "
            f"{r['per_round_collective_bytes']} B per round; lower_sharded "
            f"{r['lower_sharded_bytes']:.0f} B: equal={r['matches_lower_sharded']}; launches "
            f"{r['launches']}; round host {r['round_host_s'] * 1e3:.1f} ms")
        if not r["matches_lower_sharded"] or not r["launches"]:
            fail(f"phase 20 (c): {r['variant']} counted or launched wrong")
    log(f"phase 20 (c): {time.perf_counter() - t:.1f} s")


# Phase 20 (d)'s dry-run cell: it needs no card and its trace takes minutes
# of one CPU core, so it runs in a process of its own from the start of the
# script (the card hidden from it), beside phases 1-19.
DRYRUN_CELL = ("granite-3-2b", "train_4k", "single")
DRYRUN_CODE = """
import json, sys, time
sys.path.insert(0, sys.argv[2])
from repro_torch.launch import dryrun
t = time.perf_counter()
rec = dryrun.run_cell(*json.loads(sys.argv[3]))
rec["wall_s"] = time.perf_counter() - t
with open(sys.argv[1], "w") as f:
    json.dump(rec, f)
"""


class DryRun:
    """The dry-run cell's process, its output file and its log."""

    def __init__(self):
        import tempfile

        self.dir = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
        self.out = os.path.join(self.dir, "record.json")
        self.err = open(os.path.join(self.dir, "stderr.txt"), "w")
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
        src = str(Path(__file__).resolve().parent / "src")
        self.t0 = time.perf_counter()
        # At the lowest priority: the phases beside it keep the host's cores.
        self.proc = subprocess.Popen([sys.executable, "-c", DRYRUN_CODE, self.out, src,
                                      json.dumps(DRYRUN_CELL)],
                                     env=env, stdout=subprocess.DEVNULL, stderr=self.err,
                                     preexec_fn=lambda: os.nice(19))

    def result(self, timeout: float) -> dict:
        try:
            code = self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            fail(f"phase 20 (d): the dry run of {DRYRUN_CELL} did not finish "
                 f"{time.perf_counter() - self.t0:.0f} s after it started")
        if code != 0:
            self.err.flush()
            with open(self.err.name) as f:
                fail(f"phase 20 (d): the dry run exited {code}: {f.read()[-3000:]}")
        with open(self.out) as f:
            return json.load(f)

    def close(self):
        import shutil

        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.err.close()
        shutil.rmtree(self.dir, ignore_errors=True)


def launch_d(dryrun, cell: "DryRun | None" = None):
    t = time.perf_counter()
    own = cell is None
    cell = cell or DryRun()
    try:
        rec = cell.result(timeout=900)
    finally:
        if own:
            cell.close()
    log(f"phase 20 (d) dry run of {DRYRUN_CELL} (a model of 256 H100s from datasheet peaks, not "
        f"a measurement): {json.dumps(rec)}; {rec['wall_s']:.1f} s in its own process (started "
        f"with the script, waited {time.perf_counter() - t:.1f} s here)")
    if not rec.get("fits_hbm") or not rec.get("flops_per_device"):
        fail(f"phase 20 (d): the dry-run record is incomplete: {rec}")
    t = time.perf_counter()
    prop = dryrun.run_propagation_dryrun([], None, ["single"])
    log(f"phase 20 (d) propagation dry run: {json.dumps(prop)}; {time.perf_counter() - t:.1f} s")


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
    parent = ParentNodeKernels()
    dry = DryRun()
    half_cpu = HalfCpuRuns()
    half_batch_cpu = HalfCpuRuns(batched=True)
    try:
        smoke(torch, torch.device("cuda"), half_cpu, half_batch_cpu, parent)
        release_propagation_memory(torch)
        lm_train_phase(torch, torch.device("cuda"))
        launch_phase(torch, torch.device("cuda"), dry=dry)
    finally:
        parent.close()
        half_cpu.close()
        half_batch_cpu.close()
        dry.close()
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
