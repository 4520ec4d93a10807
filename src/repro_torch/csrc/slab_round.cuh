// The kernels of the column-slab partitioned round, templated on the value
// type T (double, or float for the fp32 tier): #11 (slab_partials), #13
// (node_slab_partials), the scatters of #12 and #14 (slab_scatter,
// node_slab_scatter), the straddle combine's two launches, and the
// launchers of #15, the window merge, without and with the early stop's
// measure (a single instance's loop carry, StopCarryFlags; a batch's rows,
// WindowStopFlags).  slab_round.cu instantiates them at double (its entry
// points slab_partials, node_slab_partials, slab_scatter,
// node_slab_scatter, slab_merge), prop_round.cu the straddle combine at
// double (straddle_combine), and slab_tier_round.cu everything at float
// and #15's early-stop forms at both.  Ids are int32 at every value type:
// the partition widens a compact prep's int16 columns, as the reference's
// does.  The arithmetic runs in T throughout, so a float instantiation
// rounds as the plain version does at float32, and the double ones are the
// float64 kernels unchanged.  See slab_round.cu for the design.

#pragma once

#include "round_common.cuh"

namespace {

// The run holding copy tile `tile`: the last run starting at or before it.
__device__ __forceinline__ int run_of(const int* __restrict__ run_start, int n_runs,
                                      int64_t tile) {
  int lo = 0, hi = n_runs - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (run_start[mid] <= tile) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// A live lane's copy (#11): its window's instance and the window's flat
// offset in the (B, W) planes.
struct Copy {
  int64_t inst, off;
};

__device__ __forceinline__ Copy copy_window(const Lanes& L, int r,
                                            const int* __restrict__ run_start,
                                            const int* __restrict__ run_inst,
                                            const int* __restrict__ run_slab, int n_runs,
                                            int64_t width, int64_t slab) {
  Copy c{0, 0};
  if (L.live) {
    const int run = run_of(run_start, n_runs, L.chunk / r);
    c.inst = run_inst[run];
    c.off = c.inst * width + static_cast<int64_t>(run_slab[run]) * slab;
  }
  return c;
}

template <typename T>
__device__ __forceinline__ void store_partials(const RowAggT<T>& a, int64_t o, T* mf, int* mc,
                                               T* xf, int* xc) {
  mf[o] = a.mf;
  mc[o] = a.mc;
  xf[o] = a.xf;
  xc[o] = a.xc;
}

template <int G, typename T>
__global__ void __launch_bounds__(kThreads)
slab_partials_kernel(const T* __restrict__ val, const int* __restrict__ col,
                     const int* __restrict__ run_start, const int* __restrict__ run_inst,
                     const int* __restrict__ run_slab, const bool* __restrict__ active,
                     const T* __restrict__ lb, const T* __restrict__ ub, T* __restrict__ mf,
                     int* __restrict__ mc, T* __restrict__ xf, int* __restrict__ xc,
                     const bool* __restrict__ go, int n_runs, int64_t n_chunks, int r, int k,
                     int64_t width, int64_t slab, T inf) {
  if (skip_round(go)) return;
  const Lanes L = lanes_for<G>(n_chunks);
  const Copy c = copy_window(L, r, run_start, run_inst, run_slab, n_runs, width, slab);
  const bool act = L.live && active[c.inst];
  // An inactive instance's copies sum nothing: their partials are zeros.
  const RowAggT<T> a =
      chunk_aggregates<G>(val, col, lb + c.off, ub + c.off, L.chunk * k, act ? k : 0, L, inf);
  if (L.live && L.sl == 0) store_partials(a, L.chunk, mf, mc, xf, xc);
}

// #13: #11's partials for B nodes of one instance, on the active-only walk
// of #14 (round_common.cuh): an item is one (active node, chunk block)
// pair, node-major, so no warp runs for an inactive node and with no node
// active every block returns after the ballot.  A lane's copy tile t =
// chunk / r gives its window at once, node * W + a_tile_slab[t] * slab (no
// search over the runs); each copy stops at its hoisted length and sums by
// chunk_sums, the first half of chunk_round (the first strides' values and
// columns loaded together, their bounds gathered before any is added), so
// the partials are chunk_aggregates', ref.warp_order_sum's, which the
// straddle combine and #14 read.  The lane group is keyed on the longest
// straddle copy, as D's is on the longest chunk: copies of at most 16
// slots share a warp, 32 / G to a warp, at any K.  Inactive nodes' rows
// are not written.  Node-major reads the sub-stream once per active node;
// the kernel before it ran each warp's chunk for every active node in
// turn, reading it once a launch, and is faster at 2 to 32 of 128 active:
// over the 15 launches of pbw's search (1 to 8 active) 1.34 ms against
// node-major's 1.71 on an H100 (tools/round_variants.py --only 13).
template <int G, int U, typename T>
__global__ void __launch_bounds__(kThreads)
node_slab_partials_kernel(const T* __restrict__ val, const int* __restrict__ col,
                          const int* __restrict__ clen, const int* __restrict__ tile_slab,
                          const bool* __restrict__ active, const T* __restrict__ lb,
                          const T* __restrict__ ub, T* __restrict__ mf, int* __restrict__ mc,
                          T* __restrict__ xf, int* __restrict__ xc, int64_t n_chunks, int r,
                          int k, int64_t bsz, int64_t width, int64_t slab, T inf) {
  const EqualItems items_of{(n_chunks + block_chunks<G>() - 1) / block_chunks<G>()};
  const Walk walk = ballot_walk(active, bsz, items_of);
  WalkCursor cur;
  for (int64_t item = blockIdx.x; item < walk.items; item += gridDim.x) {
    cur.seek(item, walk, items_of);
    const WalkLanes L = walk_lanes<G>(item, cur, items_of, n_chunks);
    const int64_t c = L.chunk;
    const int64_t off =
        L.live ? cur.plane * width + static_cast<int64_t>(tile_slab[c / r]) * slab : 0;
    Loaded<U, T> first;
    T l[U], h[U];
    const RowAggT<T> a = chunk_sums<G, U>(first, l, h, val, col, nullptr,
                                          SplitBoundsT<T>{lb + off, ub + off}, c * k,
                                          L.live ? k : 0, L.live ? clen[c] : 0, true, L.sl, inf);
    if (L.live && L.sl == 0) store_partials(a, cur.plane * n_chunks + c, mf, mc, xf, xc);
  }
}

// #12's scatter.  A lane's copy tile t = chunk / r gives its window at once,
// inst = tile_inst[t] and slab tile_slab[t] (hoisted by the partition; no
// search over the runs), and its chunk stops at the copy stream's hoisted
// length.  chunk_round gathers each nonzero's bounds once: a chunk whose
// copy holds its whole row (row_done == 1) sums its own aggregates from
// them, a straddle chunk reads the completed straddle aggregates and
// gathers only for its candidates.  A warp with no active lane returns
// before the shuffles.
template <int G, int U, typename T>
__global__ void __launch_bounds__(kThreads)
slab_scatter_kernel(const T* __restrict__ val, const int* __restrict__ col,
                    const int* __restrict__ ii, const int* __restrict__ clen,
                    const int* __restrict__ done, const T* __restrict__ smf,
                    const int* __restrict__ smc, const T* __restrict__ sxf,
                    const int* __restrict__ sxc, const T* __restrict__ lhs,
                    const T* __restrict__ rhs, const int* __restrict__ tile_inst,
                    const int* __restrict__ tile_slab, const bool* __restrict__ active,
                    const T* __restrict__ lb, const T* __restrict__ ub, T* best_l, T* best_u,
                    const bool* __restrict__ go, int64_t n_chunks, int r, int k, int64_t width,
                    int64_t slab, T int_eps, T inf) {
  if (skip_round(go)) return;
  const Lanes L = lanes_for<G>(n_chunks);
  bool use = false;
  int64_t off = 0;
  if (L.live) {
    const int64_t t = L.chunk / r;
    const int64_t inst = tile_inst[t];
    use = active[inst];
    off = inst * width + static_cast<int64_t>(tile_slab[t]) * slab;
  }
  if (!__any_sync(0xffffffffu, use)) return;  // the whole warp: no shuffle follows
  const int64_t c = L.chunk;
  const bool local = use && done[c] != 0;
  const RowAggT<T> given =
      use && !local ? RowAggT<T>{smf[c], sxf[c], smc[c], sxc[c]} : RowAggT<T>{};
  chunk_round<G, U>(val, col, ii, SplitBoundsT<T>{lb + off, ub + off}, c * k, use ? k : 0,
                    use ? clen[c] : 0, local, given, use ? lhs[c] : T(0), use ? rhs[c] : T(0),
                    best_l + off, best_u + off, L.sl, int_eps, inf);
}

// #14's scatter: #12's chunk round for B nodes of one instance, node-major.
// The active-only walk of round_common.cuh runs over (active node, chunk
// block) items, every node's chunks the copy stream's; an item's copy tile
// t = chunk / r gives its window at once, tile_slab[t] * slab offset by the
// node's plane (no search over the runs), each chunk stops at the copy
// stream's hoisted length, and chunk_round gathers each nonzero's bounds
// once: a chunk whose copy holds its whole row (row_done == 1) sums its own
// aggregates, a straddle chunk reads the node's straddle aggregates at b *
// n_chunks + c and gathers only for its candidates.  At one stride held the
// kernel is capped at 64 registers, four blocks an SM (72 uncapped, three
// blocks; the cap pays 16% at 8 of 128 nodes active and 12% at 128 on pbw:
// tools/round_variants.py).
template <int G, int U, typename T>
__global__ void __launch_bounds__(kThreads, U == 1 ? 4 : 1)
node_slab_scatter_kernel(const T* __restrict__ val, const int* __restrict__ col,
                         const int* __restrict__ ii, const int* __restrict__ clen,
                         const int* __restrict__ done, const T* __restrict__ smf,
                         const int* __restrict__ smc, const T* __restrict__ sxf,
                         const int* __restrict__ sxc, const T* __restrict__ lhs,
                         const T* __restrict__ rhs, const int* __restrict__ tile_slab,
                         const bool* __restrict__ active, const T* __restrict__ lb,
                         const T* __restrict__ ub, T* best_l, T* best_u, int64_t n_chunks,
                         int r, int k, int64_t bsz, int64_t width, int64_t slab, T int_eps,
                         T inf) {
  const EqualItems items_of{(n_chunks + block_chunks<G>() - 1) / block_chunks<G>()};
  const Walk walk = ballot_walk(active, bsz, items_of);
  WalkCursor cur;
  for (int64_t item = blockIdx.x; item < walk.items; item += gridDim.x) {
    cur.seek(item, walk, items_of);
    const WalkLanes L = walk_lanes<G>(item, cur, items_of, n_chunks);
    const int64_t c = L.chunk;
    int64_t off = 0;
    bool local = false;
    RowAggT<T> given{};
    if (L.live) {
      off = cur.plane * width + static_cast<int64_t>(tile_slab[c / r]) * slab;
      local = done[c] != 0;
      if (!local) {
        const int64_t s = cur.plane * n_chunks + c;
        given = RowAggT<T>{smf[s], sxf[s], smc[s], sxc[s]};
      }
    }
    chunk_round<G, U>(val, col, ii, SplitBoundsT<T>{lb + off, ub + off}, c * k,
                      L.live ? k : 0, L.live ? clen[c] : 0, local, given,
                      L.live ? lhs[c] : T(0), L.live ? rhs[c] : T(0), best_l + off,
                      best_u + off, L.sl, int_eps, inf);
  }
}

// The straddle combine of the partitioned round, over nb planes of copy
// partials (n_pos = Ta * R per plane), in two launches.  First the compact
// table: one thread per (active plane, table slot s) sums the partials at
// positions a_seg[s] .. a_seg[s + 1] of the slot order a_order left to
// right from 0, into (nb, n_slots) tables (slot 0, the dummy, gets +0.0 and
// 0).  Then the spread: one thread per (active plane, main-stream chunk)
// copies its slot's entry (agg_slot) to the chunk.  Grid (blocks, groups of
// 32 planes); each warp ballots its group's flags (all planes when active
// is null), and inactive planes are neither read nor written.
template <typename T>
__global__ void __launch_bounds__(kThreads)
straddle_table_kernel(const T* __restrict__ mf, const int* __restrict__ mc,
                      const T* __restrict__ xf, const int* __restrict__ xc,
                      const int64_t* __restrict__ a_order, const int64_t* __restrict__ a_seg,
                      const bool* __restrict__ active, T* __restrict__ tmf,
                      int* __restrict__ tmc, T* __restrict__ txf, int* __restrict__ txc,
                      int64_t n_slots, int64_t n_pos, int64_t nb) {
  const int64_t s = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x % kWarp;
  const int64_t b0 = static_cast<int64_t>(blockIdx.y) * kWarp;
  unsigned int todo =
      __ballot_sync(0xffffffffu, b0 + lane < nb && (active == nullptr || active[b0 + lane]));
  if (s >= n_slots || todo == 0u) return;
  const int64_t p0 = s == 0 ? 0 : a_seg[s], p1 = s == 0 ? 0 : a_seg[s + 1];
  while (todo != 0u) {
    const int64_t b = b0 + __ffs(todo) - 1;
    todo &= todo - 1u;
    const int64_t off = b * n_pos;
    T a = T(0), c = T(0);
    int ca = 0, cc = 0;
    for (int64_t p = p0; p < p1; ++p) {
      const int64_t i = off + a_order[p];
      a += mf[i];
      ca += mc[i];
      c += xf[i];
      cc += xc[i];
    }
    const int64_t o = b * n_slots + s;
    tmf[o] = a;
    tmc[o] = ca;
    txf[o] = c;
    txc[o] = cc;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
straddle_spread_kernel(const T* __restrict__ tmf, const int* __restrict__ tmc,
                       const T* __restrict__ txf, const int* __restrict__ txc,
                       const int* __restrict__ agg_slot, const bool* __restrict__ active,
                       T* __restrict__ omf, int* __restrict__ omc, T* __restrict__ oxf,
                       int* __restrict__ oxc, int64_t n_slots, int64_t n_chunks, int64_t nb) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x % kWarp;
  const int64_t b0 = static_cast<int64_t>(blockIdx.y) * kWarp;
  unsigned int todo =
      __ballot_sync(0xffffffffu, b0 + lane < nb && (active == nullptr || active[b0 + lane]));
  if (c >= n_chunks || todo == 0u) return;
  const int64_t slot = agg_slot[c];
  while (todo != 0u) {
    const int64_t b = b0 + __ffs(todo) - 1;
    todo &= todo - 1u;
    const int64_t t = b * n_slots + slot, o = b * n_chunks + c;
    omf[o] = tmf[t];
    omc[o] = tmc[t];
    oxf[o] = txf[t];
    oxc[o] = txc[t];
  }
}

// The launchers, one per kernel or pair; each returns cudaGetLastError()
// after its launch.

template <typename T>
int launch_slab_partials(const T* val, const int* col, const int* run_start, const int* run_inst,
                         const int* run_slab, const bool* active, const T* lb, const T* ub,
                         T* mf, int* mc, T* xf, int* xc, const bool* go, int n_runs,
                         int64_t n_chunks, int r, int k, int64_t width, int64_t slab, T inf,
                         cudaStream_t stream) {
  const unsigned int blocks = chunk_blocks(n_chunks, k);
#define PARTIALS(G)                                                                       \
  launch_blocks<slab_partials_kernel<G, T>>(blocks, stream, val, col, run_start, run_inst, \
                                            run_slab, active, lb, ub, mf, mc, xf, xc, go,  \
                                            n_runs, n_chunks, r, k, width, slab, inf)
  switch (group_width(k)) {
    case 1: return PARTIALS(1);
    case 2: return PARTIALS(2);
    case 4: return PARTIALS(4);
    case 8: return PARTIALS(8);
    case 16: return PARTIALS(16);
    default: return PARTIALS(32);
  }
#undef PARTIALS
}

template <typename T>
int launch_node_slab_partials(const T* val, const int* col, const int* clen,
                              const int* tile_slab, const bool* active, const T* lb,
                              const T* ub, T* mf, int* mc, T* xf, int* xc, int64_t n_chunks,
                              int r, int k, int max_len, int64_t bsz, int64_t width,
                              int64_t slab, T inf, cudaStream_t stream) {
  // The group width of the longest straddle copy (at most K's); at most
  // one pass over the sub-stream.
  const int g = max_len < k ? max_len : k;
  const int64_t most = chunk_blocks(n_chunks, g);
#define NODE_PARTIALS(G, U)                                                                    \
  launch_walk<node_slab_partials_kernel<G, U, T>>(most, bsz, stream, val, col, clen, tile_slab, \
                                                  active, lb, ub, mf, mc, xf, xc, n_chunks, r, \
                                                  k, bsz, width, slab, inf)
  DISPATCH_HELD(NODE_PARTIALS, g, held_strides(max_len))
#undef NODE_PARTIALS
}

template <typename T>
int launch_slab_scatter(const T* val, const int* col, const int* ii, const int* clen,
                        const int* done, const T* smf, const int* smc, const T* sxf,
                        const int* sxc, const T* lhs, const T* rhs, const int* tile_inst,
                        const int* tile_slab, const bool* active, const T* lb, const T* ub,
                        T* best_l, T* best_u, const bool* go, int64_t n_chunks, int r, int k,
                        int max_len, int64_t width, int64_t slab, T int_eps, T inf,
                        cudaStream_t stream) {
  const unsigned int blocks = chunk_blocks(n_chunks, k);
#define SLAB_SCATTER(G, U)                                                                     \
  launch_blocks<slab_scatter_kernel<G, U, T>>(blocks, stream, val, col, ii, clen, done, smf,   \
                                              smc, sxf, sxc, lhs, rhs, tile_inst, tile_slab,   \
                                              active, lb, ub, best_l, best_u, go, n_chunks, r, \
                                              k, width, slab, int_eps, inf)
  DISPATCH_HELD(SLAB_SCATTER, k, held_strides(max_len))
#undef SLAB_SCATTER
}

template <typename T>
int launch_node_slab_scatter(const T* val, const int* col, const int* ii, const int* clen,
                             const int* done, const T* smf, const int* smc, const T* sxf,
                             const int* sxc, const T* lhs, const T* rhs, const int* tile_slab,
                             const bool* active, const T* lb, const T* ub, T* best_l,
                             T* best_u, int64_t n_chunks, int r, int k, int max_len,
                             int64_t bsz, int64_t width, int64_t slab, T int_eps, T inf,
                             cudaStream_t stream) {
  // At most one pass over the copy stream.
  const int64_t most = chunk_blocks(n_chunks, k);
#define NODE_SLAB(G, U)                                                                         \
  launch_walk<node_slab_scatter_kernel<G, U, T>>(most, bsz, stream, val, col, ii, clen, done, \
                                                 smf, smc, sxf, sxc, lhs, rhs, tile_slab,     \
                                                 active, lb, ub, best_l, best_u, n_chunks, r, \
                                                 k, bsz, width, slab, int_eps, inf)
  DISPATCH_HELD(NODE_SLAB, k, held_strides(max_len))
#undef NODE_SLAB
}

// #15: one flag per window into `flags` (the pair's other buffer zeroed),
// or for one instance's fixed point (`carry` not null) the flag folded into
// its loop carry (the mask is then the carry's go, so a converged
// instance's blocks return at once, as an inactive one's do).
template <typename T>
int launch_slab_merge(T* lb, T* ub, T* best_l, T* best_u, const bool* active, int* flags,
                      int* clear, int* carry, int64_t bsz, int64_t width, int64_t slab, int k,
                      int unroll, T eps, T inf, T outward, cudaStream_t stream) {
  // A warp's 32 columns of one stride must lie in one window.
  if (slab <= 0 || slab % kWarp != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (carry != nullptr) {
    if (bsz != 1) return static_cast<int>(cudaErrorInvalidValue);
    return launch_merge_grid<CarryFlags, WindowFlags::kGridCols>(
        lb, ub, best_l, best_u, active, CarryFlags{carry, k, unroll}, 1, width, eps, inf,
        outward, stream);
  }
  const int64_t n_slabs = (width + slab - 1) / slab;
  return launch_merge(lb, ub, best_l, best_u, active,
                      WindowFlags{flags, n_slabs, slab, clear, bsz * n_slabs}, bsz, width, eps,
                      inf, outward, stream);
}

// #15 for one instance's fixed point with the early stop armed: F's
// StopCarryFlags on the (column block) grid over the plane, masked by the
// carry's go, four columns a thread, so the measure's block partials and
// their sum take F's order (ref.merge_order_sum).
template <typename T>
int launch_slab_merge_stop(T* lb, T* ub, T* best_l, T* best_u, const bool* active, int* carry,
                           T* partials, int64_t width, T eps, T inf, T outward, T stop,
                           int patience, cudaStream_t stream) {
  using Flags = StopCarryFlags<T>;
  return launch_merge_grid<Flags>(lb, ub, best_l, best_u, active,
                                  Flags{carry, partials, stop, patience}, 1, width, eps, inf,
                                  outward, stream);
}

// #15 over a batch's (B, W) planes with the early stop's measure: the
// window flags and each active row's measure into prog[row], through the
// (bsz, n_blocks) block partials and the launch's ticket (WindowStopFlags).
template <typename T>
int launch_slab_merge_rows_stop(T* lb, T* ub, T* best_l, T* best_u, const bool* active,
                                int* flags, int* clear, T* partials, T* prog, int* ticket,
                                int64_t bsz, int64_t width, int64_t slab, T eps, T inf,
                                T outward, cudaStream_t stream) {
  if (slab <= 0 || slab % kWarp != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n_slabs = (width + slab - 1) / slab;
  const int64_t n_blocks = (width + kMergeBlock - 1) / kMergeBlock;
  const WindowStopFlags<T> f{flags,    n_slabs, slab,   clear,  bsz * n_slabs,
                             partials, prog,    ticket, active, n_blocks};
  return launch_merge(lb, ub, best_l, best_u, active, f, bsz, width, eps, inf, outward, stream);
}

template <typename T>
int launch_straddle_combine(const T* mf, const int* mc, const T* xf, const int* xc,
                            const int64_t* a_order, const int64_t* a_seg, const int* agg_slot,
                            const bool* active, T* tmf, int* tmc, T* txf, int* txc, T* omf,
                            int* omc, T* oxf, int* oxc, int64_t n_slots, int64_t n_pos,
                            int64_t n_chunks, int64_t nb, cudaStream_t stream) {
  const unsigned int groups = static_cast<unsigned int>((nb + kWarp - 1) / kWarp);
  const dim3 tgrid(static_cast<unsigned int>((n_slots + kThreads - 1) / kThreads), groups);
  straddle_table_kernel<T><<<tgrid, kThreads, 0, stream>>>(mf, mc, xf, xc, a_order, a_seg,
                                                           active, tmf, tmc, txf, txc, n_slots,
                                                           n_pos, nb);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_chunks == 0) return static_cast<int>(err);
  const dim3 sgrid(static_cast<unsigned int>((n_chunks + kThreads - 1) / kThreads), groups);
  straddle_spread_kernel<T><<<sgrid, kThreads, 0, stream>>>(tmf, tmc, txf, txc, agg_slot,
                                                            active, omf, omc, oxf, oxc, n_slots,
                                                            n_chunks, nb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
