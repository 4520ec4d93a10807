// The kernels of the batched rounds, templated on the value type T (double,
// float for the fp32 tier, or round_common.cuh's Bf16 / F16 for the 16-bit
// types) and on the index types (C for the columns, M for the integrality
// marks: int32, or the compact int16 and int8 streams of a float32 or
// bfloat16 prep, widened in registers): kernel #8 (D over a packed batch),
// kernel #10 (D over a node batch), and A', the long-row combine and E over
// a node batch (the multi-chunk node round), with one launcher each; and
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
// Num<T>::Plane, which #9 reads.

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

// Kernels A' and E for B nodes sharing one matrix (kernel #10's scheme):
// each warp loads its chunks' first U strides once, reads the active mask
// 32 nodes at a time (one ballot) and visits only the active nodes, each
// gathering from its own row of the (B, n_pad) planes.  A' writes node b's
// partials at [b, chunk] of (B, T, R) planes; E reads b's completed
// aggregates there and scatters into b's accumulator row.  Per node the
// arithmetic and its order are A''s and E's, so each node's result equals
// its single-instance launch bit for bit.  Inactive nodes' rows are not
// written.
template <int G, typename T, typename C>
__global__ void __launch_bounds__(kThreads)
node_activities_gather_kernel(const T* __restrict__ val, const C* __restrict__ col,
                              const int* __restrict__ clen, const T* __restrict__ lb,
                              const T* __restrict__ ub, const bool* __restrict__ active,
                              T* __restrict__ mf, int* __restrict__ mc, T* __restrict__ xf,
                              int* __restrict__ xc, int64_t n_chunks, int k, int64_t bsz,
                              int64_t n_pad, T inf) {
  constexpr int U = Strides<G>::U;
  const Lanes L = lanes_for<G>(n_chunks);
  const int lane = threadIdx.x % kWarp;
  const int64_t base = L.chunk * k;
  const int kk = L.live ? k : 0;
  const int len = L.live ? clen[L.chunk] : 0;
  Loaded<U, T> first;
  load_strides(first, val, col, nullptr, base, 0, len, kk, L.sl);
  for (int64_t b0 = 0; b0 < bsz; b0 += kWarp) {
    unsigned int todo = __ballot_sync(0xffffffffu, b0 + lane < bsz && active[b0 + lane]);
    while (todo != 0u) {
      const int64_t b = b0 + __ffs(todo) - 1;
      todo &= todo - 1u;
      const SplitBoundsT<T> bounds{lb + b * n_pad, ub + b * n_pad};
      RowSumT<T> sums{};
      add_strides(sums, first, bounds, inf);
      for (int j0 = U * kWarp; j0 < len; j0 += U * kWarp) {
        Loaded<U, T> s;
        load_strides(s, val, col, nullptr, base, j0, len, kk, L.sl);
        add_strides(sums, s, bounds, inf);
      }
      const RowAggT<T> a = group_reduce<G>(sums);
      if (L.live && L.sl == 0) {
        const int64_t o = b * n_chunks + L.chunk;
        mf[o] = a.mf;
        mc[o] = a.mc;
        xf[o] = a.xf;
        xc[o] = a.xc;
      }
    }
  }
}

template <int G, typename T, typename C, typename M>
__global__ void __launch_bounds__(kThreads, kEMinBlocks)
node_candidates_scatter_kernel(const T* __restrict__ val, const C* __restrict__ col,
                               const M* __restrict__ ii, const int* __restrict__ clen,
                               const T* __restrict__ rmf, const int* __restrict__ rmc,
                               const T* __restrict__ rxf, const int* __restrict__ rxc,
                               const T* __restrict__ lhs, const T* __restrict__ rhs,
                               const T* __restrict__ lb, const T* __restrict__ ub,
                               const bool* __restrict__ active, typename Num<T>::Plane* best_l,
                               typename Num<T>::Plane* best_u, int64_t n_chunks, int k, int64_t bsz,
                               int64_t n_pad, T int_eps, T inf) {
  constexpr int U = Strides<G>::U;
  const Lanes L = lanes_for<G>(n_chunks);
  const int lane = threadIdx.x % kWarp;
  const int64_t c = L.chunk;
  const int kk = L.live ? k : 0;
  const int len = L.live ? clen[c] : 0;
  const T lo = L.live ? lhs[c] : T(0), hi = L.live ? rhs[c] : T(0);
  Loaded<U, T> first;
  load_strides(first, val, col, ii, c * k, 0, len, kk, L.sl);
  for (int64_t b0 = 0; b0 < bsz; b0 += kWarp) {
    // Ballot first: every lane takes part, live or not.
    unsigned int todo = __ballot_sync(0xffffffffu, b0 + lane < bsz && active[b0 + lane]);
    if (!L.live) continue;
    while (todo != 0u) {
      const int64_t b = b0 + __ffs(todo) - 1;
      todo &= todo - 1u;
      const int64_t o = b * n_chunks + c, row = b * n_pad;
      const RowAggT<T> a{rmf[o], rxf[o], rmc[o], rxc[o]};
      const SplitBoundsT<T> bounds{lb + row, ub + row};
      scatter_strides(first, bounds, a, lo, hi, best_l + row, best_u + row, int_eps, inf);
      for (int j0 = U * kWarp; j0 < len; j0 += U * kWarp) {
        Loaded<U, T> s;
        load_strides(s, val, col, ii, c * k, j0, len, kk, L.sl);
        scatter_strides(s, bounds, a, lo, hi, best_l + row, best_u + row, int_eps, inf);
      }
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

// Run LAUNCH(G) for the group width of k slots.
#define DISPATCH_WIDTH(LAUNCH, k)      \
  switch (group_width(k)) {            \
    case 1: return LAUNCH(1);          \
    case 2: return LAUNCH(2);          \
    case 4: return LAUNCH(4);          \
    case 8: return LAUNCH(8);          \
    case 16: return LAUNCH(16);        \
    default: return LAUNCH(32);        \
  }

template <typename T, typename C>
int launch_node_activities_gather(const T* val, const C* col, const int* clen, const T* lb,
                                  const T* ub, const bool* active, T* mf, int* mc, T* xf,
                                  int* xc, int64_t n_chunks, int k, int64_t bsz, int64_t n_pad,
                                  T inf, cudaStream_t stream) {
  const unsigned int blocks = chunk_blocks(n_chunks, k);
#define NODE_GATHER(G)                                                                          \
  launch_blocks<node_activities_gather_kernel<G, T, C>>(blocks, stream, val, col, clen, lb, ub, \
                                                        active, mf, mc, xf, xc, n_chunks, k,    \
                                                        bsz, n_pad, inf)
  DISPATCH_WIDTH(NODE_GATHER, k)
#undef NODE_GATHER
}

template <typename T, typename C, typename M>
int launch_node_candidates_scatter(const T* val, const C* col, const M* ii, const int* clen,
                                   const T* rmf, const int* rmc, const T* rxf, const int* rxc,
                                   const T* lhs, const T* rhs, const T* lb, const T* ub,
                                   const bool* active, typename Num<T>::Plane* best_l,
                                   typename Num<T>::Plane* best_u, int64_t n_chunks, int k,
                                   int64_t bsz, int64_t n_pad, T int_eps, T inf,
                                   cudaStream_t stream) {
  const unsigned int blocks = chunk_blocks(n_chunks, k);
#define NODE_SCATTER(G)                                                                        \
  launch_blocks<node_candidates_scatter_kernel<G, T, C, M>>(                                   \
      blocks, stream, val, col, ii, clen, rmf, rmc, rxf, rxc, lhs, rhs, lb, ub, active, best_l, \
      best_u, n_chunks, k, bsz, n_pad, int_eps, inf)
  DISPATCH_WIDTH(NODE_SCATTER, k)
#undef NODE_SCATTER
}

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
