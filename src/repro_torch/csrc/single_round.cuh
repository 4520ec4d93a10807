// The kernels of one instance's fused and segment rounds, templated on the
// value type T (double, float for the fp32 tier, or round_common.cuh's
// Bf16 / F16 for the 16-bit types) and on the index types (C for the
// columns, M for the integrality marks: int32, or the compact int16 and
// int8 streams of a float32 or bfloat16 prep, widened in registers): D,
// A', E, the long-row combine and the segment round's A, B and C, with one
// launcher each.  prop_round.cu instantiates them at double and int32 (its
// entry points fused_scatter_round, activities_gather, candidates_scatter,
// combine_chunk_partials, activities, candidates, fused_round),
// tier_round.cu at float with both index forms, and half_round.cu at the
// 16-bit types.  The arithmetic runs in T throughout (at 16 bits each
// operation rounds to T; a chunk's sums accumulate in Num<T>::Acc and
// round once), so an instantiation rounds as the plain version does at its
// type, and the double ones are the float64 kernels unchanged.  D and E
// scatter into planes of Num<T>::Plane.  F is round_common.cuh's merge
// body (launch_merge_grid).

#pragma once

#include "round_common.cuh"

namespace {

// Kernel D on chunk_round (round_common.cuh): each nonzero's bounds
// gathered once and held from the sums to the candidates, values, columns
// and marks loaded together, each chunk stopped at its hoisted length
// clen[c], the column max / min by integer reductions into the planes
// best_l / best_u (kept by the round closure: F hands them back at the
// sentinels).  The group width is keyed on the longest chunk, not on K:
// where no chunk holds more than 16 slots (pb's hold at most 8 of K = 128)
// a group of G = group_width(max_len) lanes owns a chunk, 32 / G chunks a
// warp.  The sums stay ref.warp_order_sum's: every slot of a chunk lies in
// its group's first stride, lane sl adds slot sl to +0.0, and the 32-lane
// butterfly over lanes that hold +0.0 past the group reduces to the G-lane
// one.  Longer chunks take a warp and held_strides(max_len) strides.  At
// one stride held it takes 52-64 registers, four blocks an SM, without a
// cap (a cap of 64 changes nothing; one of 40 spills and runs 22% slower
// on pb: tools/round_variants.py).
template <int G, int U, typename T, typename C, typename M>
__global__ void __launch_bounds__(kThreads)
fused_scatter_round_kernel(const T* __restrict__ val, const C* __restrict__ col,
                           const M* __restrict__ ii, const int* __restrict__ clen,
                           const T* __restrict__ lhs, const T* __restrict__ rhs,
                           const T* __restrict__ lb, const T* __restrict__ ub,
                           typename Num<T>::Plane* best_l, typename Num<T>::Plane* best_u,
                           const bool* __restrict__ go, int64_t n_chunks, int k, T int_eps,
                           T inf) {
  if (skip_round(go)) return;
  const Lanes L = lanes_for<G>(n_chunks);
  const int64_t c = L.chunk;
  chunk_round<G, U>(val, col, ii, SplitBoundsT<T>{lb, ub}, c * k, L.live ? k : 0,
                    L.live ? clen[c] : 0, true, RowAggT<T>{}, L.live ? lhs[c] : T(0),
                    L.live ? rhs[c] : T(0), best_l, best_u, L.sl, int_eps, inf);
}

// Kernel A' (and E below) stop each lane group at its chunk's length
// clen[c], keep U strides' loads in flight and gather each column's two
// bounds as one pair from the interleaved (n_pad, 2) lub (round_common.cuh).
template <int G, typename T, typename C>
__global__ void __launch_bounds__(kThreads)
activities_gather_kernel(const T* __restrict__ val, const C* __restrict__ col,
                         const int* __restrict__ clen,
                         const typename Num<T>::Pair* __restrict__ lub, T* __restrict__ mf,
                         int* __restrict__ mc, T* __restrict__ xf, int* __restrict__ xc,
                         const bool* __restrict__ go, int64_t n_chunks, int k, T inf) {
  if (skip_round(go)) return;
  constexpr int U = Strides<G>::U;
  const Lanes L = lanes_for<G>(n_chunks);
  const int64_t base = L.chunk * k;
  const int kk = L.live ? k : 0;
  const int len = L.live ? clen[L.chunk] : 0;
  RowSumT<T> sums{};
  for (int j0 = 0; j0 < kk; j0 += U * kWarp) {
    if (j0 > 0 && j0 >= len) break;
    Loaded<U, T> s;
    load_strides(s, val, col, nullptr, base, j0, len, kk, L.sl);
    add_strides(sums, s, PairedBoundsT<T>{lub}, inf);
  }
  const RowAggT<T> a = group_reduce<G>(sums);
  if (L.live && L.sl == 0) {
    mf[L.chunk] = a.mf;
    mc[L.chunk] = a.mc;
    xf[L.chunk] = a.xf;
    xc[L.chunk] = a.xc;
  }
}

// E caps its registers at 64 (four blocks, 32 warps an SM): unbounded it
// takes 66-70 and three blocks, and runs 14% slower on `mixed` on an H100
// (tools/ae_variants.py).
constexpr int kEMinBlocks = 4;

template <int G, typename T, typename C, typename M>
__global__ void __launch_bounds__(kThreads, kEMinBlocks)
candidates_scatter_kernel(const T* __restrict__ val, const C* __restrict__ col,
                          const M* __restrict__ ii, const int* __restrict__ clen,
                          const T* __restrict__ rmf, const int* __restrict__ rmc,
                          const T* __restrict__ rxf, const int* __restrict__ rxc,
                          const T* __restrict__ lhs, const T* __restrict__ rhs,
                          const typename Num<T>::Pair* __restrict__ lub,
                          typename Num<T>::Plane* best_l, typename Num<T>::Plane* best_u,
                          const bool* __restrict__ go, int64_t n_chunks, int k, T int_eps,
                          T inf) {
  if (skip_round(go)) return;
  constexpr int U = Strides<G>::U;
  const Lanes L = lanes_for<G>(n_chunks);
  if (!L.live) return;
  const int64_t c = L.chunk;
  const RowAggT<T> a{rmf[c], rxf[c], rmc[c], rxc[c]};
  const T lo = lhs[c], hi = rhs[c];
  const int len = clen[c];
  for (int j0 = 0; j0 < k; j0 += U * kWarp) {
    if (j0 > 0 && j0 >= len) break;
    Loaded<U, T> s;
    load_strides(s, val, col, ii, c * k, j0, len, k, L.sl);
    scatter_strides(s, PairedBoundsT<T>{lub}, a, lo, hi, best_l, best_u, int_eps, inf);
  }
}

// The long-row combine: each row segment's chunk partials summed left to
// right from 0 (chunks of a row are adjacent in the stream), then written
// back to every chunk of the row.  Fixed order on every run, unlike an
// atomic segment sum.  The segments come classified (hoisted, not per
// round): the first long_blocks blocks give each long segment one warp
// (combine_segment_warp, 2 KB of shared memory a warp at double), first so
// that the longest chains start at once; the rest give each short segment
// one thread.  Both take the same sums in the same order.  A class entry of
// -1 is empty.
template <typename T>
__global__ void __launch_bounds__(kThreads)
combine_chunk_partials_kernel(const T* __restrict__ mf, const int* __restrict__ mc,
                              const T* __restrict__ xf, const int* __restrict__ xc,
                              const int64_t* __restrict__ row_start,
                              const int* __restrict__ short_seg, const int* __restrict__ long_seg,
                              T* __restrict__ omf, int* __restrict__ omc, T* __restrict__ oxf,
                              int* __restrict__ oxc, const bool* __restrict__ go,
                              int64_t n_short, int64_t n_long, unsigned int long_blocks) {
  __shared__ T sm[kWarpsPerBlock][2 * kCombineGroup];
  if (skip_round(go)) return;
  if (blockIdx.x < long_blocks) {
    const int64_t w = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
    if (w >= n_long) return;  // the whole warp
    const int seg = long_seg[w];
    if (seg < 0) return;
    combine_segment_warp(mf, mc, xf, xc, omf, omc, oxf, oxc, row_start[seg],
                         row_start[seg + 1], threadIdx.x % kWarp, sm[threadIdx.x / kWarp]);
    return;
  }
  const int64_t r = static_cast<int64_t>(blockIdx.x - long_blocks) * blockDim.x + threadIdx.x;
  if (r >= n_short) return;
  const int seg = short_seg[r];
  if (seg < 0) return;
  combine_segment(mf, mc, xf, xc, omf, omc, oxf, oxc, row_start[seg], row_start[seg + 1]);
}

// Kernels A, B and C of the segment (seed) round: the bounds were gathered
// at each slot's column before the launch ((T, R, K) lb_g / ub_g), and B and
// C store both candidates at every slot -- the sentinels at padding -- for
// the column max/min that follows outside.  The arithmetic is D's, A''s and
// E's (round_common.cuh), with SlotBounds in place of ColumnBounds, so the
// same bounds give the same bits.  Each returns at once on a clear `go` (a
// round enqueued after the fixed point converged), as D does: its outputs
// are then not written, and F merges nothing.  B and C read the marks as M
// (int32, or the fp32 tier's compact int8); A reads none.
template <int G, typename T>
__global__ void __launch_bounds__(kThreads)
activities_kernel(const T* __restrict__ val, const T* __restrict__ lb_g,
                  const T* __restrict__ ub_g, T* __restrict__ mf, int* __restrict__ mc,
                  T* __restrict__ xf, int* __restrict__ xc, const bool* __restrict__ go,
                  int64_t n_chunks, int k, T inf) {
  if (skip_round(go)) return;
  const Lanes L = lanes_for<G>(n_chunks);
  const RowAggT<T> a = chunk_aggregates<G>(val, SlotBoundsT<T>{lb_g, ub_g}, L.chunk * k,
                                           L.live ? k : 0, L, inf);
  if (L.live && L.sl == 0) {
    mf[L.chunk] = a.mf;
    mc[L.chunk] = a.mc;
    xf[L.chunk] = a.xf;
    xc[L.chunk] = a.xc;
  }
}

template <int G, typename T, typename M>
__global__ void __launch_bounds__(kThreads)
candidates_kernel(const T* __restrict__ val, const T* __restrict__ lb_g,
                  const T* __restrict__ ub_g, const M* __restrict__ ii,
                  const T* __restrict__ rmf, const int* __restrict__ rmc,
                  const T* __restrict__ rxf, const int* __restrict__ rxc,
                  const T* __restrict__ lhs, const T* __restrict__ rhs, T* __restrict__ lcand,
                  T* __restrict__ ucand, const bool* __restrict__ go, int64_t n_chunks, int k,
                  T int_eps, T inf) {
  if (skip_round(go)) return;
  const Lanes L = lanes_for<G>(n_chunks);
  if (!L.live) return;
  const int64_t c = L.chunk;
  const RowAggT<T> a{rmf[c], rxf[c], rmc[c], rxc[c]};
  chunk_candidates_store(val, SlotBoundsT<T>{lb_g, ub_g}, ii, a, lhs[c], rhs[c], lcand, ucand,
                         c * k, k, L, int_eps, inf);
}

template <int G, typename T, typename M>
__global__ void __launch_bounds__(kThreads)
fused_round_kernel(const T* __restrict__ val, const T* __restrict__ lb_g,
                   const T* __restrict__ ub_g, const M* __restrict__ ii,
                   const T* __restrict__ lhs, const T* __restrict__ rhs,
                   T* __restrict__ lcand, T* __restrict__ ucand, const bool* __restrict__ go,
                   int64_t n_chunks, int k, T int_eps, T inf) {
  if (skip_round(go)) return;
  const Lanes L = lanes_for<G>(n_chunks);
  const SlotBoundsT<T> b{lb_g, ub_g};
  const int64_t base = L.chunk * k;
  const RowAggT<T> a = chunk_aggregates<G>(val, b, base, L.live ? k : 0, L, inf);
  if (!L.live) return;
  chunk_candidates_store(val, b, ii, a, lhs[L.chunk], rhs[L.chunk], lcand, ucand, base, k, L,
                         int_eps, inf);
}

// Blocks of the combine: one warp per long segment, then one thread per
// short segment.
struct CombineGrid {
  unsigned int long_blocks, blocks;
};

CombineGrid combine_grid(int64_t n_short, int64_t n_long) {
  const unsigned int sb = static_cast<unsigned int>((n_short + kThreads - 1) / kThreads);
  const unsigned int lb =
      static_cast<unsigned int>((n_long + kWarpsPerBlock - 1) / kWarpsPerBlock);
  return CombineGrid{lb, lb + sb};
}

// The launchers, one per kernel; each returns cudaGetLastError() after its
// launch.

template <typename T, typename C, typename M>
int launch_fused_scatter_round(const T* val, const C* col, const M* ii, const int* clen,
                               const T* lhs, const T* rhs, const T* lb, const T* ub,
                               typename Num<T>::Plane* best_l, typename Num<T>::Plane* best_u,
                               const bool* go, int64_t n_chunks, int k, int max_len, T int_eps,
                               T inf, cudaStream_t stream) {
  // The group width of the longest chunk (at most K's).
  const int width = max_len < k ? max_len : k;
  const unsigned int blocks = chunk_blocks(n_chunks, width);
#define FUSED(G, U)                                                                           \
  launch_blocks<fused_scatter_round_kernel<G, U, T, C, M>>(blocks, stream, val, col, ii, clen, \
                                                           lhs, rhs, lb, ub, best_l, best_u, \
                                                           go, n_chunks, k, int_eps, inf)
  DISPATCH_HELD(FUSED, width, held_strides(max_len))
#undef FUSED
}

template <typename T, typename C>
int launch_activities_gather(const T* val, const C* col, const int* clen, const T* lub, T* mf,
                             int* mc, T* xf, int* xc, const bool* go, int64_t n_chunks, int k,
                             T inf, cudaStream_t stream) {
  using Pair = typename Num<T>::Pair;
  const Pair* pairs = reinterpret_cast<const Pair*>(lub);
  const unsigned int blocks = chunk_blocks(n_chunks, k);
#define GATHER(G) \
  launch_blocks<activities_gather_kernel<G, T, C>>(blocks, stream, val, col, clen, pairs, mf, mc, \
                                                   xf, xc, go, n_chunks, k, inf)
  switch (group_width(k)) {
    case 1: return GATHER(1);
    case 2: return GATHER(2);
    case 4: return GATHER(4);
    case 8: return GATHER(8);
    case 16: return GATHER(16);
    default: return GATHER(32);
  }
#undef GATHER
}

template <typename T, typename C, typename M>
int launch_candidates_scatter(const T* val, const C* col, const M* ii, const int* clen,
                              const T* rmf, const int* rmc, const T* rxf, const int* rxc,
                              const T* lhs, const T* rhs, const T* lub,
                              typename Num<T>::Plane* best_l, typename Num<T>::Plane* best_u,
                              const bool* go, int64_t n_chunks, int k, T int_eps, T inf,
                              cudaStream_t stream) {
  using Pair = typename Num<T>::Pair;
  const Pair* pairs = reinterpret_cast<const Pair*>(lub);
  const unsigned int blocks = chunk_blocks(n_chunks, k);
#define SCATTER(G)                                                                      \
  launch_blocks<candidates_scatter_kernel<G, T, C, M>>(blocks, stream, val, col, ii, clen, rmf, \
                                                       rmc, rxf, rxc, lhs, rhs, pairs, best_l, \
                                                       best_u, go, n_chunks, k, int_eps, inf)
  switch (group_width(k)) {
    case 1: return SCATTER(1);
    case 2: return SCATTER(2);
    case 4: return SCATTER(4);
    case 8: return SCATTER(8);
    case 16: return SCATTER(16);
    default: return SCATTER(32);
  }
#undef SCATTER
}

template <typename T>
int launch_combine_chunk_partials(const T* mf, const int* mc, const T* xf, const int* xc,
                                  const int64_t* row_start, const int* short_seg,
                                  const int* long_seg, T* omf, int* omc, T* oxf, int* oxc,
                                  const bool* go, int64_t n_short, int64_t n_long,
                                  cudaStream_t stream) {
  const CombineGrid g = combine_grid(n_short, n_long);
  combine_chunk_partials_kernel<T><<<g.blocks, kThreads, 0, stream>>>(
      mf, mc, xf, xc, row_start, short_seg, long_seg, omf, omc, oxf, oxc, go, n_short, n_long,
      g.long_blocks);
  return static_cast<int>(cudaGetLastError());
}

// Run LAUNCH(G) for the group width of k slots (A, B, C).
#define DISPATCH_GROUP(LAUNCH, k)  \
  switch (group_width(k)) {         \
    case 1: return LAUNCH(1);       \
    case 2: return LAUNCH(2);       \
    case 4: return LAUNCH(4);       \
    case 8: return LAUNCH(8);       \
    case 16: return LAUNCH(16);     \
    default: return LAUNCH(32);     \
  }

template <typename T>
int launch_activities(const T* val, const T* lb_g, const T* ub_g, T* mf, int* mc, T* xf, int* xc,
                      const bool* go, int64_t n_chunks, int k, T inf, cudaStream_t stream) {
  const unsigned int blocks = chunk_blocks(n_chunks, k);
#define ACTIVITIES(G)                                                                   \
  launch_blocks<activities_kernel<G, T>>(blocks, stream, val, lb_g, ub_g, mf, mc, xf, xc, go, \
                                         n_chunks, k, inf)
  DISPATCH_GROUP(ACTIVITIES, k)
#undef ACTIVITIES
}

template <typename T, typename M>
int launch_candidates(const T* val, const T* lb_g, const T* ub_g, const M* ii, const T* rmf,
                      const int* rmc, const T* rxf, const int* rxc, const T* lhs, const T* rhs,
                      T* lcand, T* ucand, const bool* go, int64_t n_chunks, int k, T int_eps,
                      T inf, cudaStream_t stream) {
  const unsigned int blocks = chunk_blocks(n_chunks, k);
#define CANDIDATES(G)                                                                         \
  launch_blocks<candidates_kernel<G, T, M>>(blocks, stream, val, lb_g, ub_g, ii, rmf, rmc, rxf, \
                                            rxc, lhs, rhs, lcand, ucand, go, n_chunks, k,       \
                                            int_eps, inf)
  DISPATCH_GROUP(CANDIDATES, k)
#undef CANDIDATES
}

template <typename T, typename M>
int launch_fused_round(const T* val, const T* lb_g, const T* ub_g, const M* ii, const T* lhs,
                       const T* rhs, T* lcand, T* ucand, const bool* go, int64_t n_chunks, int k,
                       T int_eps, T inf, cudaStream_t stream) {
  const unsigned int blocks = chunk_blocks(n_chunks, k);
#define FUSED_ROUND(G)                                                                          \
  launch_blocks<fused_round_kernel<G, T, M>>(blocks, stream, val, lb_g, ub_g, ii, lhs, rhs, lcand, \
                                             ucand, go, n_chunks, k, int_eps, inf)
  DISPATCH_GROUP(FUSED_ROUND, k)
#undef FUSED_ROUND
}

}  // namespace
