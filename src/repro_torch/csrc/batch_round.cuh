// The kernels of the batched rounds, templated on the value type T (double,
// float for the fp32 tier, or round_common.cuh's Bf16 / F16 for the 16-bit
// types) and on the index types (C for the columns, M for the integrality
// marks: int32, or the compact int16 and int8 streams of a float32 or
// bfloat16 prep, widened in registers): kernel #8 (D over a packed batch),
// kernel #10 (D over a node batch), and A', the long-row combine and E over
// a node batch (the multi-chunk node round; A' and E on the active-only
// walk over groups of active nodes), with one launcher each; and
// the launchers of #9, the batched merge, with and without the early
// stop's per-row progress measure (round_common.cuh RowFlags,
// RowStopFlags).  prop_round.cu instantiates them at double and int32 (its
// entry points node_activities_gather, node_candidates_scatter,
// node_combine_chunk_partials, node_fused_scatter_round,
// batched_fused_scatter_round, apply_updates_batch), and
// batch_tier_round.cu at float with both index forms and #9 with the early
// stop at both value types, and half_batch_round.cu everything at the
// 16-bit types.  The arithmetic runs in T throughout (at 16 bits each
// operation rounds to T; a chunk's sums and #9's row measure accumulate in
// Num<T>::Acc and round once), so an instantiation rounds as the plain
// version does at its type, and the double ones are the float64 kernels
// unchanged.  #8, #10 and the node E scatter into planes of
// Num<T>::Plane kept by the round closure, which #9 reads and hands back at
// the sentinels.

#pragma once

#include "single_round.cuh"

namespace {

// The same over (B, T, R) node planes of one instance: node b's segments
// are row_start offset by b * n_chunks.  Grid (segment blocks, groups of 32
// nodes): each warp reads its group's 32 flags of the active mask (one
// ballot) and, for the active nodes only, runs the single-instance
// combine's thread or warp on the segment; an inactive node's planes are
// not written.  (A block per node would launch 75,000 empty blocks for 128
// nodes at 150,000 segments; a single group would walk a full pool's 128
// nodes in series.)
template <typename T>
__global__ void __launch_bounds__(kThreads)
node_combine_chunk_partials_kernel(const T* __restrict__ mf, const int* __restrict__ mc,
                                   const T* __restrict__ xf, const int* __restrict__ xc,
                                   const int64_t* __restrict__ row_start,
                                   const int* __restrict__ short_seg,
                                   const int* __restrict__ long_seg,
                                   const bool* __restrict__ active, T* __restrict__ omf,
                                   int* __restrict__ omc, T* __restrict__ oxf,
                                   int* __restrict__ oxc, int64_t n_short, int64_t n_long,
                                   unsigned int long_blocks, int64_t n_chunks, int64_t bsz) {
  __shared__ T sm[kWarpsPerBlock][2 * kCombineGroup];
  const int lane = threadIdx.x % kWarp;
  const int64_t b0 = static_cast<int64_t>(blockIdx.y) * kWarp;
  unsigned int todo = __ballot_sync(0xffffffffu, b0 + lane < bsz && active[b0 + lane]);
  if (blockIdx.x < long_blocks) {
    const int64_t w = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
    if (w >= n_long) return;  // the whole warp
    const int seg = long_seg[w];
    if (seg < 0) return;
    const int64_t s = row_start[seg], e = row_start[seg + 1];
    while (todo != 0u) {
      const int64_t off = (b0 + __ffs(todo) - 1) * n_chunks;
      todo &= todo - 1u;
      combine_segment_warp(mf, mc, xf, xc, omf, omc, oxf, oxc, off + s, off + e, lane,
                           sm[threadIdx.x / kWarp]);
    }
    return;
  }
  const int64_t r = static_cast<int64_t>(blockIdx.x - long_blocks) * blockDim.x + threadIdx.x;
  if (r >= n_short) return;
  const int seg = short_seg[r];
  if (seg < 0) return;
  const int64_t s = row_start[seg], e = row_start[seg + 1];
  while (todo != 0u) {
    const int64_t off = (b0 + __ffs(todo) - 1) * n_chunks;
    todo &= todo - 1u;
    combine_segment(mf, mc, xf, xc, omf, omc, oxf, oxc, off + s, off + e);
  }
}

// Kernels A' and E for B nodes sharing one matrix: the multi-chunk node
// round.  Both run on the active-only walk of round_common.cuh, counting
// the active nodes (one walk item each, so a cursor finds an active node by
// its rank); an item is one (group of Q consecutive active nodes, chunk
// block) pair, numbered group by group, so no warp runs for an inactive
// node, the rows in flight are those of one or a few groups (they stay in
// L2), and with no node active every block returns after the ballot.  An
// item loads its chunks (values, columns and, for E, the integrality marks
// together, each chunk stopped at its hoisted length) once and holds them
// for the group's nodes, then runs each node on its own rows: A' sums in
// ref.warp_order_sum's order and stores the node's partials at [b, chunk]
// of the (B, T, R) planes (consecutive threads on consecutive chunks), E
// reads b's completed aggregates there, gathers each nonzero's bounds once
// and scatters the candidates into b's accumulator row by fire-and-forget
// integer reductions (no L2 pre-check).  Per node the arithmetic and its
// order are A''s and E's, so each node's result equals its single-instance
// launch bit for bit.  Inactive nodes' rows are not written.
//
// The lanes are keyed on the longest chunk (hoisted), G = group_width of
// it.  Where G is at most kSerialWidth (K of 4 or 8, or short rows: the
// search's multi-chunk round on `pbf` at K = 4) one thread owns a chunk and
// runs the G-lane butterfly on its slots' sums in registers (bitwise the
// shuffles' sums): a node costs the thread its slots' gathers, all issued
// together, and one store, where G lanes spent two shuffle levels and a
// predicated store on one nonzero each (tools/round_variants.py --only
// node_ae, variant 11, G lanes at Q = 1: A' 8% and E 5% slower than one
// thread at Q = 1 summed over the pbf search's masks).  Either
// way a node costs ~13 us on `pbf` K = 4, its 1.5 M bound gathers of 8 B
// (and E's 1.5 M reductions) from L2 setting the pace, not the bytes from
// device memory.  Wider chunks take G lanes (a warp past 16 slots, U
// strides held, as #10's and #13's), one node an item (Q = 1).
// Q = 1 is #13's node-major order; a large Q is the chunk-once order of the
// kernels before the redesign (each warp's chunks run for every active
// node in turn), which won when few nodes were active (#13's finding).

// The group sizes of the one-thread kernels, A''s and E's: the least time
// summed over the 41 launches of the pbf search at tile width 4 (1 to 8
// nodes active), warm and cold, on an H100 at 700 W (tools/round_variants.py
// --only node_ae, sums of each launch's median over 30 repetitions, the
// variants of each launch in turn): A' 5.268 ms at Q = 2 (Q = 1, 4, 8:
// 5.306, 5.330, 5.398; the kernel before the redesign 5.460), faster than
// Q = 1 in 30 of 30 repetitions by 0.028 to 0.052 ms; E 8.859 at Q = 4
// (Q = 1, 2, 8: 9.213, 8.963, 8.946; before 10.094), faster than Q = 1 in
// 30 of 30 by 0.341 to 0.372.
constexpr int kNodeGatherGroup = 2;
constexpr int kNodeScatterGroup = 4;

// The widest lane group that one thread runs serially.
constexpr int kSerialWidth = 8;

// The groups of the walk over n_chunks chunks, G lanes a chunk (1 for the
// serial kernels): blocks per group, items.
template <int G, int Q>
struct NodeGroups {
  const EqualItems ones{1};
  Walk walk;
  int64_t n_blocks, items;

  __device__ __forceinline__ NodeGroups(const bool* __restrict__ active, int64_t bsz,
                                        int64_t n_chunks)
      : walk(ballot_walk(active, bsz, EqualItems{1})),
        n_blocks((n_chunks + block_chunks<G>() - 1) / block_chunks<G>()),
        items((walk.items + Q - 1) / Q * n_blocks) {}

  // Item `item`'s group g, this thread's chunk of it and the group's
  // number of nodes (Q but for the last group).
  __device__ __forceinline__ int64_t group(int64_t item) const { return item / n_blocks; }
  __device__ __forceinline__ int64_t chunk(int64_t item, int64_t g) const {
    const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
    return (item - g * n_blocks) * block_chunks<G>() + warp * (kWarp / G) + lane / G;
  }
  __device__ __forceinline__ int size(int64_t g) const {
    const int64_t left = walk.items - g * Q;
    return left < Q ? static_cast<int>(left) : Q;
  }
};

// A chunk of at most G slots held by one thread: its values, columns and
// marks (ii null: none) below the length, read together.
template <int G, typename T, typename C, typename M>
__device__ __forceinline__ void load_chunk(Loaded<G, T>& s, const T* __restrict__ val,
                                           const C* __restrict__ col, const M* __restrict__ ii,
                                           int64_t base, int len) {
#pragma unroll
  for (int u = 0; u < G; ++u) {
    const bool in = u < len;
    s.v[u] = in ? val[base + u] : T(0);
    s.c[u] = in ? static_cast<int>(col[base + u]) : 0;
    s.m[u] = ii != nullptr && in ? static_cast<int>(ii[base + u]) : 0;
  }
}

// group_reduce over G lanes' sums held by one thread: at each level lane i
// adds lane i + off's sum, as the butterfly's shuffles do, so the sums are
// the same bit for bit.
template <int G, typename T>
__device__ __forceinline__ RowAggT<T> serial_reduce(RowSumT<T> (&p)[G]) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int i = 0; i < off; ++i) {
      p[i].mf += p[i + off].mf;
      p[i].xf += p[i + off].xf;
      p[i].mc += p[i + off].mc;
      p[i].xc += p[i + off].xc;
    }
  }
  return RowAggT<T>{T(p[0].mf), T(p[0].xf), p[0].mc, p[0].xc};
}

// A' with one thread a chunk (G <= kSerialWidth).
template <int G, int Q, typename T, typename C>
__global__ void __launch_bounds__(kThreads)
node_activities_serial_kernel(const T* __restrict__ val, const C* __restrict__ col,
                              const int* __restrict__ clen, const T* __restrict__ lb,
                              const T* __restrict__ ub, const bool* __restrict__ active,
                              T* __restrict__ mf, int* __restrict__ mc, T* __restrict__ xf,
                              int* __restrict__ xc, int64_t n_chunks, int k, int64_t bsz,
                              int64_t n_pad, T inf) {
  const NodeGroups<1, Q> groups(active, bsz, n_chunks);
  WalkCursor first;
  for (int64_t item = blockIdx.x; item < groups.items; item += gridDim.x) {
    const int64_t g = groups.group(item), c = groups.chunk(item, g);
    first.seek(g * Q, groups.walk, groups.ones);
    if (c >= n_chunks) continue;  // no shuffle follows
    Loaded<G, T> held;
    load_chunk(held, val, col, static_cast<const int*>(nullptr), c * k, clen[c]);
    const int size = groups.size(g);
    WalkCursor cur = first;
    for (int j = 0; j < size; ++j) {
      cur.seek(g * Q + j, groups.walk, groups.ones);
      const int64_t row = cur.plane * n_pad;
      T l[G], h[G];
      gather_strides(held, SplitBoundsT<T>{lb + row, ub + row}, l, h);
      RowSumT<T> lanes[G];
#pragma unroll
      for (int u = 0; u < G; ++u) {
        lanes[u] = RowSumT<T>{};
        add_slot(lanes[u], held.v[u], l[u], h[u], inf);
      }
      const RowAggT<T> a = serial_reduce<G>(lanes);
      const int64_t o = cur.plane * n_chunks + c;
      mf[o] = a.mf;
      mc[o] = a.mc;
      xf[o] = a.xf;
      xc[o] = a.xc;
    }
  }
}

// E with one thread a chunk (G <= kSerialWidth).
template <int G, int Q, typename T, typename C, typename M>
__global__ void __launch_bounds__(kThreads)
node_candidates_serial_kernel(const T* __restrict__ val, const C* __restrict__ col,
                              const M* __restrict__ ii, const int* __restrict__ clen,
                              const T* __restrict__ rmf, const int* __restrict__ rmc,
                              const T* __restrict__ rxf, const int* __restrict__ rxc,
                              const T* __restrict__ lhs, const T* __restrict__ rhs,
                              const T* __restrict__ lb, const T* __restrict__ ub,
                              const bool* __restrict__ active, typename Num<T>::Plane* best_l,
                              typename Num<T>::Plane* best_u, int64_t n_chunks, int k,
                              int64_t bsz, int64_t n_pad, T int_eps, T inf) {
  const NodeGroups<1, Q> groups(active, bsz, n_chunks);
  WalkCursor first;
  for (int64_t item = blockIdx.x; item < groups.items; item += gridDim.x) {
    const int64_t g = groups.group(item), c = groups.chunk(item, g);
    first.seek(g * Q, groups.walk, groups.ones);
    if (c >= n_chunks) continue;
    const T lo = lhs[c], hi = rhs[c];
    Loaded<G, T> held;
    load_chunk(held, val, col, ii, c * k, clen[c]);
    const int size = groups.size(g);
    WalkCursor cur = first;
    for (int j = 0; j < size; ++j) {
      cur.seek(g * Q + j, groups.walk, groups.ones);
      const int64_t row = cur.plane * n_pad, o = cur.plane * n_chunks + c;
      const RowAggT<T> a{rmf[o], rxf[o], rmc[o], rxc[o]};
      T l[G], h[G];
      gather_strides(held, SplitBoundsT<T>{lb + row, ub + row}, l, h);
      scatter_gathered<G, false>(held, l, h, a, lo, hi, best_l + row, best_u + row, int_eps,
                                 inf);
    }
  }
}

// A' and E with G lanes a chunk (chunks wider than kSerialWidth),
// node-major: one active node an item (Q = 1, #13's order), the chunk's
// first U strides loaded together, the rest stride by stride.  (Groups of
// Q > 1 nodes cost registers here, 160 against 124 for E at U = 4, and
// time: E 0.99 against 0.75 ms on `mixed` K = 128 with 4 of 4 nodes
// active, tools/round_variants.py --only node_ae.)
template <int G, int U, typename T, typename C>
__global__ void __launch_bounds__(kThreads)
node_activities_gather_kernel(const T* __restrict__ val, const C* __restrict__ col,
                              const int* __restrict__ clen, const T* __restrict__ lb,
                              const T* __restrict__ ub, const bool* __restrict__ active,
                              T* __restrict__ mf, int* __restrict__ mc, T* __restrict__ xf,
                              int* __restrict__ xc, int64_t n_chunks, int k, int64_t bsz,
                              int64_t n_pad, T inf) {
  const NodeGroups<G, 1> nodes(active, bsz, n_chunks);
  const int sl = threadIdx.x % kWarp % G;
  WalkCursor cur;
  for (int64_t item = blockIdx.x; item < nodes.items; item += gridDim.x) {
    const int64_t g = nodes.group(item), c = nodes.chunk(item, g);
    cur.seek(g, nodes.walk, nodes.ones);
    const bool live = c < n_chunks;
    const int kk = live ? k : 0, len = live ? clen[c] : 0;
    const int64_t row = cur.plane * n_pad;
    const SplitBoundsT<T> bounds{lb + row, ub + row};
    Loaded<U, T> held;
    load_strides<U, true>(held, val, col, nullptr, c * k, 0, len, kk, sl);
    RowSumT<T> sums{};
    add_strides(sums, held, bounds, inf);
    for (int s0 = U * kWarp; s0 < len; s0 += U * kWarp) {
      Loaded<U, T> s;
      load_strides<U, true>(s, val, col, nullptr, c * k, s0, len, kk, sl);
      add_strides(sums, s, bounds, inf);
    }
    const RowAggT<T> a = group_reduce<G>(sums);
    if (live && sl == 0) {
      const int64_t o = cur.plane * n_chunks + c;
      mf[o] = a.mf;
      mc[o] = a.mc;
      xf[o] = a.xf;
      xc[o] = a.xc;
    }
  }
}

template <int G, int U, typename T, typename C, typename M>
__global__ void __launch_bounds__(kThreads)
node_candidates_scatter_kernel(const T* __restrict__ val, const C* __restrict__ col,
                               const M* __restrict__ ii, const int* __restrict__ clen,
                               const T* __restrict__ rmf, const int* __restrict__ rmc,
                               const T* __restrict__ rxf, const int* __restrict__ rxc,
                               const T* __restrict__ lhs, const T* __restrict__ rhs,
                               const T* __restrict__ lb, const T* __restrict__ ub,
                               const bool* __restrict__ active, typename Num<T>::Plane* best_l,
                               typename Num<T>::Plane* best_u, int64_t n_chunks, int k, int64_t bsz,
                               int64_t n_pad, T int_eps, T inf) {
  const NodeGroups<G, 1> nodes(active, bsz, n_chunks);
  const int sl = threadIdx.x % kWarp % G;
  WalkCursor cur;
  for (int64_t item = blockIdx.x; item < nodes.items; item += gridDim.x) {
    const int64_t g = nodes.group(item), c = nodes.chunk(item, g);
    cur.seek(g, nodes.walk, nodes.ones);
    // No shuffle follows: a lane past the last chunk is done.
    if (c >= n_chunks) continue;
    const int len = clen[c];
    const T lo = lhs[c], hi = rhs[c];
    const int64_t row = cur.plane * n_pad, o = cur.plane * n_chunks + c;
    const SplitBoundsT<T> bounds{lb + row, ub + row};
    const RowAggT<T> a{rmf[o], rxf[o], rmc[o], rxc[o]};
    Loaded<U, T> held;
    load_strides<U, true>(held, val, col, ii, c * k, 0, len, k, sl);
    scatter_strides<U, false>(held, bounds, a, lo, hi, best_l + row, best_u + row, int_eps,
                              inf);
    for (int s0 = U * kWarp; s0 < len; s0 += U * kWarp) {
      Loaded<U, T> s;
      load_strides<U, true>(s, val, col, ii, c * k, s0, len, k, sl);
      scatter_strides<U, false>(s, bounds, a, lo, hi, best_l + row, best_u + row, int_eps,
                                inf);
    }
  }
}

// Kernel D for B nodes sharing one matrix, node-major: the active-only walk
// of round_common.cuh over (active node, chunk block) items, every node's
// chunks the stream's, so the items running at any time belong to one or a
// few nodes and their bound and accumulator rows stay in L2, where a warp
// that loops over every node would touch all B rows at once.  Each item
// runs chunk_round (U strides held) on its node's rows with D's arithmetic,
// so each row equals D's result for that node bit for bit.
template <int G, int U, typename T, typename C, typename M>
__global__ void __launch_bounds__(kThreads)
node_fused_scatter_round_kernel(const T* __restrict__ val, const C* __restrict__ col,
                                const M* __restrict__ ii, const int* __restrict__ clen,
                                const T* __restrict__ lhs, const T* __restrict__ rhs,
                                const T* __restrict__ lb, const T* __restrict__ ub,
                                const bool* __restrict__ active,
                                typename Num<T>::Plane* best_l, typename Num<T>::Plane* best_u,
                                int64_t n_chunks, int k, int64_t bsz, int64_t n_pad,
                                T int_eps, T inf) {
  const EqualItems items_of{(n_chunks + block_chunks<G>() - 1) / block_chunks<G>()};
  const Walk walk = ballot_walk(active, bsz, items_of);
  WalkCursor cur;
  for (int64_t item = blockIdx.x; item < walk.items; item += gridDim.x) {
    cur.seek(item, walk, items_of);
    const WalkLanes L = walk_lanes<G>(item, cur, items_of, n_chunks);
    const int64_t c = L.chunk, row = cur.plane * n_pad;
    chunk_round<G, U>(val, col, ii, SplitBoundsT<T>{lb + row, ub + row}, c * k,
                      L.live ? k : 0, L.live ? clen[c] : 0, true, RowAggT<T>{},
                      L.live ? lhs[c] : T(0), L.live ? rhs[c] : T(0), best_l + row,
                      best_u + row, L.sl, int_eps, inf);
  }
}

// Kernel D over a packed batch, instance-major: one flat stream of T tiles
// of R chunks, instance b's tiles contiguous, its chunks [start[b],
// start[b + 1]) (hoisted by the caller) and its columns local to its
// n_pad-wide window.  The active-only walk of round_common.cuh runs over
// (active instance, chunk block) items, the instances' item counts summed
// per ballot word, so no warp is launched over a converged instance's or a
// free slot's tiles; each item runs chunk_round (U strides held, each chunk
// stopped at its hoisted length) on its instance's rows with D's
// arithmetic, so each row equals D's result for that instance bit for bit.
// At one stride held the kernel is capped at 64 registers, four blocks an
// SM (71 uncapped, three blocks: 0.3549 -> 0.3007 ms with 4 of 4 active on
// the fused bucket, tools/round_variants.py).
template <int G, int U, typename T, typename C, typename M>
__global__ void __launch_bounds__(kThreads, U == 1 ? 4 : 1)
batched_fused_scatter_round_kernel(const T* __restrict__ val, const C* __restrict__ col,
                                   const M* __restrict__ ii, const int* __restrict__ clen,
                                   const T* __restrict__ lhs, const T* __restrict__ rhs,
                                   const T* __restrict__ lb, const T* __restrict__ ub,
                                   const int64_t* __restrict__ start,
                                   const bool* __restrict__ active,
                                   typename Num<T>::Plane* best_l, typename Num<T>::Plane* best_u,
                                   int64_t bsz, int k, int64_t n_pad, T int_eps, T inf) {
  const RangeItems items_of{start, block_chunks<G>()};
  const Walk walk = ballot_walk(active, bsz, items_of);
  WalkCursor cur;
  for (int64_t item = blockIdx.x; item < walk.items; item += gridDim.x) {
    cur.seek(item, walk, items_of);
    const WalkLanes L = walk_lanes<G>(item, cur, items_of, 0);
    const int64_t c = L.chunk, row = cur.plane * n_pad;
    chunk_round<G, U>(val, col, ii, SplitBoundsT<T>{lb + row, ub + row}, c * k,
                      L.live ? k : 0, L.live ? clen[c] : 0, true, RowAggT<T>{},
                      L.live ? lhs[c] : T(0), L.live ? rhs[c] : T(0), best_l + row,
                      best_u + row, L.sl, int_eps, inf);
  }
}

// The launchers, one per kernel; each returns cudaGetLastError() after its
// launch.

// The node kernels for the group width of the longest chunk: one thread a
// chunk up to kSerialWidth, G lanes past it.
#define NODE_WIDTHS(SERIAL_KERNEL, LANE_KERNEL, width, held)                             \
  switch (width) {                                                                       \
    case 1: return SERIAL_KERNEL(1);                                                     \
    case 2: return SERIAL_KERNEL(2);                                                     \
    case 4: return SERIAL_KERNEL(4);                                                     \
    case 8: return SERIAL_KERNEL(8);                                                     \
    case 16: return LANE_KERNEL(16, 1);                                                  \
    default:                                                                             \
      return (held) <= 1 ? LANE_KERNEL(32, 1) : (held) == 2 ? LANE_KERNEL(32, 2)         \
                                                            : LANE_KERNEL(32, 4);        \
  }

template <typename T, typename C, int Q = kNodeGatherGroup>
int launch_node_activities_gather(const T* val, const C* col, const int* clen, const T* lb,
                                  const T* ub, const bool* active, T* mf, int* mc, T* xf,
                                  int* xc, int64_t n_chunks, int k, int max_len, int64_t bsz,
                                  int64_t n_pad, T inf, cudaStream_t stream) {
  // The group width of the longest chunk (at most K's); at most one pass
  // over the chunk stream.
  const int g = max_len < k ? max_len : k;
  const int width = group_width(g);
  const int64_t most = width <= kSerialWidth ? (n_chunks + kThreads - 1) / kThreads
                                             : chunk_blocks(n_chunks, g);
#define GATHER_SERIAL(G)                                                                     \
  launch_walk<node_activities_serial_kernel<G, Q, T, C>>(most, bsz, stream, val, col, clen,   \
                                                         lb, ub, active, mf, mc, xf, xc,      \
                                                         n_chunks, k, bsz, n_pad, inf)
#define GATHER_LANES(G, U)                                                                   \
  launch_walk<node_activities_gather_kernel<G, U, T, C>>(most, bsz, stream, val, col, clen,    \
                                                         lb, ub, active, mf, mc, xf, xc,      \
                                                         n_chunks, k, bsz, n_pad, inf)
  NODE_WIDTHS(GATHER_SERIAL, GATHER_LANES, width, held_strides(max_len))
#undef GATHER_SERIAL
#undef GATHER_LANES
}

template <typename T, typename C, typename M, int Q = kNodeScatterGroup>
int launch_node_candidates_scatter(const T* val, const C* col, const M* ii, const int* clen,
                                   const T* rmf, const int* rmc, const T* rxf, const int* rxc,
                                   const T* lhs, const T* rhs, const T* lb, const T* ub,
                                   const bool* active, typename Num<T>::Plane* best_l,
                                   typename Num<T>::Plane* best_u, int64_t n_chunks, int k,
                                   int max_len, int64_t bsz, int64_t n_pad, T int_eps, T inf,
                                   cudaStream_t stream) {
  const int g = max_len < k ? max_len : k;
  const int width = group_width(g);
  const int64_t most = width <= kSerialWidth ? (n_chunks + kThreads - 1) / kThreads
                                             : chunk_blocks(n_chunks, g);
#define SCATTER_SERIAL(G)                                                                    \
  launch_walk<node_candidates_serial_kernel<G, Q, T, C, M>>(                                 \
      most, bsz, stream, val, col, ii, clen, rmf, rmc, rxf, rxc, lhs, rhs, lb, ub, active,    \
      best_l, best_u, n_chunks, k, bsz, n_pad, int_eps, inf)
#define SCATTER_LANES(G, U)                                                                  \
  launch_walk<node_candidates_scatter_kernel<G, U, T, C, M>>(                                \
      most, bsz, stream, val, col, ii, clen, rmf, rmc, rxf, rxc, lhs, rhs, lb, ub, active,    \
      best_l, best_u, n_chunks, k, bsz, n_pad, int_eps, inf)
  NODE_WIDTHS(SCATTER_SERIAL, SCATTER_LANES, width, held_strides(max_len))
#undef SCATTER_SERIAL
#undef SCATTER_LANES
}

#undef NODE_WIDTHS

template <typename T>
int launch_node_combine_chunk_partials(const T* mf, const int* mc, const T* xf, const int* xc,
                                       const int64_t* row_start, const int* short_seg,
                                       const int* long_seg, const bool* active, T* omf,
                                       int* omc, T* oxf, int* oxc, int64_t n_short,
                                       int64_t n_long, int64_t n_chunks, int64_t bsz,
                                       cudaStream_t stream) {
  const CombineGrid g = combine_grid(n_short, n_long);
  const dim3 grid(g.blocks, static_cast<unsigned int>((bsz + kWarp - 1) / kWarp));
  node_combine_chunk_partials_kernel<T><<<grid, kThreads, 0, stream>>>(
      mf, mc, xf, xc, row_start, short_seg, long_seg, active, omf, omc, oxf, oxc, n_short,
      n_long, g.long_blocks, n_chunks, bsz);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename C, typename M>
int launch_node_fused_scatter_round(const T* val, const C* col, const M* ii, const int* clen,
                                    const T* lhs, const T* rhs, const T* lb, const T* ub,
                                    const bool* active, typename Num<T>::Plane* best_l,
                                    typename Num<T>::Plane* best_u, int64_t n_chunks, int k,
                                    int max_len, int64_t bsz, int64_t n_pad, T int_eps, T inf,
                                    cudaStream_t stream) {
  // At most one pass over the chunk stream.
  const int64_t most = chunk_blocks(n_chunks, k);
#define NODE_FUSED(G, U)                                                                    \
  launch_walk<node_fused_scatter_round_kernel<G, U, T, C, M>>(                              \
      most, bsz, stream, val, col, ii, clen, lhs, rhs, lb, ub, active, best_l, best_u,      \
      n_chunks, k, bsz, n_pad, int_eps, inf)
  DISPATCH_HELD(NODE_FUSED, k, held_strides(max_len))
#undef NODE_FUSED
}

template <typename T, typename C, typename M>
int launch_batched_fused_scatter_round(const T* val, const C* col, const M* ii, const int* clen,
                                       const T* lhs, const T* rhs, const T* lb, const T* ub,
                                       const int64_t* start, const bool* active,
                                       typename Num<T>::Plane* best_l,
                                       typename Num<T>::Plane* best_u, int64_t n_chunks, int k,
                                       int max_len, int64_t bsz, int64_t n_pad, T int_eps,
                                       T inf, cudaStream_t stream) {
  // At most one pass over the stream: its chunk blocks, plus one partial
  // block per instance.
  const int64_t most = chunk_blocks(n_chunks, k) + bsz;
  if (n_chunks == 0) return static_cast<int>(cudaGetLastError());
#define BATCHED_FUSED(G, U)                                                                  \
  launch_walk<batched_fused_scatter_round_kernel<G, U, T, C, M>>(                            \
      most, bsz, stream, val, col, ii, clen, lhs, rhs, lb, ub, start, active, best_l, best_u, \
      bsz, k, n_pad, int_eps, inf)
  DISPATCH_HELD(BATCHED_FUSED, k, held_strides(max_len))
#undef BATCHED_FUSED
}

// Kernel #9 over (B, n_pad) planes: the merges' body (round_common.cuh), on
// the walk or, for a few rows, the grid; a warp that tightened a bound
// stores its row's flag once per item, and the launch zeroes the other flag
// buffer of the pair (`clear`, bsz entries; null for none).
template <typename T>
int launch_apply_updates_batch(T* lb, T* ub, typename Num<T>::Plane* best_l,
                               typename Num<T>::Plane* best_u, const bool* active, bool* changed,
                               bool* clear, int64_t bsz, int64_t n_pad, T eps, T inf, T outward,
                               cudaStream_t stream) {
  return launch_merge(lb, ub, best_l, best_u, active, RowFlags{changed, clear, bsz}, bsz, n_pad,
                      eps, inf, outward, stream);
}

// #9 with the early stop's measure (RowStopFlags): as above, and each
// active row's progress measure over its columns into prog[row], through
// the (bsz, n_blocks) block partials (of Num<T>::Acc) and the launch's
// ticket.
template <typename T>
int launch_apply_updates_batch_stop(T* lb, T* ub, typename Num<T>::Plane* best_l,
                                    typename Num<T>::Plane* best_u, const bool* active,
                                    bool* changed, bool* clear, typename Num<T>::Acc* partials,
                                    T* prog, int* ticket,
                                    int64_t bsz, int64_t n_pad, T eps, T inf, T outward,
                                    cudaStream_t stream) {
  const int64_t n_blocks = (n_pad + kMergeBlock - 1) / kMergeBlock;
  const RowStopFlags<T> flags{changed, clear, bsz, partials, prog, ticket, active, n_blocks};
  return launch_merge(lb, ub, best_l, best_u, active, flags, bsz, n_pad, eps, inf, outward,
                      stream);
}

}  // namespace
