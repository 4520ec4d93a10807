// Timed variants of kernels D (fused_scatter_round), #8
// (batched_fused_scatter_round), #10 (node_fused_scatter_round) and #13
// (node_slab_partials), of the scatters of #12 (slab_scatter) and #14
// (node_slab_scatter), and of the batched merges #9 and #15: which design
// step of their redesign pays.
// Built and driven by tools/round_variants.py; not part of the port's
// kernel library.
//
// D variants (fused_variant), one instance's (n_pad,) vectors:
//   0  the kernel before the redesign: a group of group_width(K) lanes per
//      chunk; chunk_aggregates, then chunk_candidates_scatter (every slot
//      loaded and its bounds gathered twice, compare-and-swap max/min)
//   1  the same grid; bounds gathered once and held, values, columns and
//      marks loaded together (chunk_round's routine), compare-and-swap,
//      every slot
//   2  as 1, each chunk stopped at its hoisted length
//   3  as 2, 64-bit integer atomics (no pre-check)
//   4  as 3, packed groups: group_width(longest chunk) lanes per chunk,
//      32 / G chunks a warp where no chunk holds more than 16 slots (the
//      port's)
//   5  as 4, at most 64 registers a thread, four blocks an SM
//   6  as 4, at most 40 registers a thread, six blocks an SM
//   7  as 3 (a warp per chunk), at most 64 registers a thread
// #10 variants (node_variant), one matrix over B node planes:
//   0  the kernel before the redesign: each warp ballots the mask and loops
//      over the active nodes; chunk_aggregates, then
//      chunk_candidates_scatter (every slot loaded and its bounds gathered
//      twice, float64 compare-and-swap max/min)
//   1  the same order; bounds gathered once and held (chunk_round's
//      routine), compare-and-swap, every slot
//   2  as 1, 64-bit integer atomics behind the L2 pre-check
//   3  as 2, each chunk stopped at its hoisted length
//   4  node-major over at most the resident blocks
//   5  node-major over one block per chunk block (no resident cap)
//   6, 7, 8  as 4, at most 64, 40, 32 registers a thread (4, 6, 8 blocks)
//   9  as 4, columns and marks loaded with the values (EAGER)
//   10 as 9, no pre-check before the atomics (the port's kernel before it
//      moved onto the walk #8 and #14 share)
//   11 as 9, at most 40 registers a thread
//   12 as 4, no pre-check
//   13 as 10 on the active-only walk of round_common.cuh (the port's kernel
//      since #8 and #14 share that walk)
// #12 scatter variants (slab_variant), one copy stream over B planes:
//   0  the kernel before the redesign: a binary search over the runs, then
//      window_round (two loads and gathers per slot, compare-and-swap,
//      every slot)
//   1  the search; bounds held, compare-and-swap, every slot
//   2  as 1, integer atomics
//   3  as 2, stopped at the copy stream's hoisted length
//   4  the window from tile_inst / tile_slab, no search (four strides held
//      at K = 128)
//   5  as 4, at most 64 registers a thread
//   6  as 4, one stride held (U = 1; later strides gathered again)
//   7  as 6, EAGER column loads
//   8  as 7, no pre-check (the port's kernel)
//   9, 10, 11  as 7, at most 64, 40, 32 registers a thread
//   12 as 6, no pre-check
// #8 variants (batched_variant), a packed stream over B instance planes:
//   0  the kernel before the redesign: a lane group per chunk of the whole
//      stream, its instance read from tile_inst; chunk_aggregates, then
//      chunk_candidates_scatter (every slot, compare-and-swap)
//   1  the same grid; bounds gathered once and held, values, columns and
//      marks loaded together, compare-and-swap, every slot
//   2  as 1, integer atomics (no pre-check)
//   3  as 2, stopped at the chunk length
//   4  instance-major over the active instances' chunk blocks
//   5  as 4, at most 64 registers a thread (the port's)
// #14 scatter variants (node_slab_variant), one copy stream over B node
// planes:
//   0  the kernel before the redesign: each warp ballots the mask and loops
//      over the active nodes; a binary search over the runs, then
//      window_round (two loads and gathers per slot, compare-and-swap,
//      every slot)
//   1  the same order and search; chunk_round (bounds held, integer
//      atomics, stopped at the length)
//   2  as 1, the window from tile_slab (no search)
//   3  node-major over the active nodes' chunk blocks
//   4  as 3, at most 64 registers, four blocks an SM (the port's)
//   5  as 3, at most 40 registers, six blocks an SM
//   6  node-major over groups of 8 active nodes: a warp runs its chunks for
//      the group's nodes in turn
//   7  as 6, each chunk's data and first strides loaded once per group
//   8  as 7, at most 64 registers
//   9  one group of every active node (ballot order over the resident
//      blocks), at most 64 registers
// #13 variants (partials_variant), one straddle sub-stream over B node
// planes:
//   0  the kernel before the redesign: each warp ballots the mask and loops
//      over the active nodes on its fixed chunk; a binary search over the
//      runs, chunk_aggregates over every slot (K's group width)
//   1  node-major on the active-only walk (#14's order), the window from
//      a_tile_slab, chunk_sums stopped at the copy's length, the group keyed
//      on the longest copy (the port's)
//   2  chunk once: an item is (group of 4 active nodes, chunk block); a warp
//      loads its chunks' values and columns once, issues the bound gathers
//      of the 4 nodes, then sums each
// Node A' and node E variants (node_gather_variant, node_scatter_variant),
// one matrix over B node planes, the multi-chunk node round:
//   0  the kernels before the redesign: a group of group_width(K) lanes per
//      chunk over the whole chunk grid; each warp loads its chunks' first
//      strides once, ballots the mask 32 nodes at a time and runs every
//      active node in turn (E: integer atomics behind the L2 pre-check); at
//      every value type and index form of the port (`form`)
//   1, 2, 4, 8  the port's kernels (batch_round.cuh) at Q = 1, 2, 4, 8: the
//      active-only walk over (group of Q active nodes, chunk block) items,
//      the chunk loaded once for the group, the lanes keyed on the longest
//      chunk (one thread a chunk up to 8 slots; wider chunks G lanes, one
//      node an item whatever Q), E without the pre-check; at float64
//   11  as 1 with G lanes a chunk at every width (short chunks too)
// Built with -DNODE_ROUND_ONLY, the file holds these alone (chip_smoke.py
// times the parents beside the port's kernels).
// Merge variants (merge_variant):
//   0  #9 reading the accumulator planes only (before the hand-back)
//   1  #9 handing them back at the sentinels, a (column block, row) grid
//      (the port's #9 before the walk)
//   2  #15 reading only
//   3  #15 handing back, a (column block, row) grid (the port's #15 before
//      the walk)
//   4  #9 on the active-only walk over (active row, column block) items,
//      each thread that tightens storing its row's flag
//   5  as 4, one flag store per warp that tightened
//   6, 7, 8  as 5, an item of 2, 4, 8 column blocks: a thread loads the
//      bounds and candidates of its 2, 4, 8 columns before it merges any
//      (7 is the port's #9, now the body it shares with #15: 11)
//   9  a (column block, group of 32 rows) grid: each warp ballots its
//      group's flags and merges its column of each active row in turn
//   10 #15 on the active-only walk, one column a thread, its window's flag
//      stored once per warp
//   11 #15 on the merge body it shares with #9 (round_common.cuh), on the
//      walk: four columns a thread, loaded before any merge, a flag store
//      per warp and column stride (the port's for more than kMergeGridRows
//      rows)
//   12 as 11 on a (column block, row) grid, four columns a thread
//   13, 14 #9 on the shared body (a bool flag per row), on the grid at four
//      columns a thread (the port's #9 for at most kMergeGridRows rows) /
//      on the walk (past them)
//   15, 16 #15 / #9 on the shared body's grid, one column a thread (15: the
//      port's #15 for at most kMergeGridRows rows)

#include "../src/repro_torch/csrc/batch_round.cuh"

namespace {

#ifndef NODE_ROUND_ONLY

// PRE: the integer atomics behind the L2 pre-check (the port's); without it
// each candidate goes to the atomic unit.
template <bool RED, bool PRE>
__device__ __forceinline__ void put(double* bl, double* bu, const Cands& q, double inf) {
  if (q.lc > -inf) {
    if (!RED) {
      atomic_max_f64(bl, q.lc);
    } else if (PRE) {
      red_max(bl, q.lc);
    } else {
      const double v = q.lc == 0.0 ? 0.0 : q.lc;
      const long long bits = __double_as_longlong(v);
      if (v >= 0.0) atomicMax(reinterpret_cast<long long*>(bl), bits);
      else atomicMin(reinterpret_cast<unsigned long long*>(bl), static_cast<unsigned long long>(bits));
    }
  }
  if (q.uc < inf) {
    if (!RED) {
      atomic_min_f64(bu, q.uc);
    } else if (PRE) {
      red_min(bu, q.uc);
    } else {
      const double v = q.uc == 0.0 ? 0.0 : q.uc;
      const long long bits = __double_as_longlong(v);
      if (v >= 0.0) atomicMin(reinterpret_cast<long long*>(bu), bits);
      else atomicMax(reinterpret_cast<unsigned long long*>(bu), static_cast<unsigned long long>(bits));
    }
  }
}

template <int U, bool RED, bool PRE>
__device__ __forceinline__ void put_batch(const Loaded<U>& s, const double (&l)[U],
                                          const double (&h)[U], const RowAgg& a, double lhs,
                                          double rhs, double* best_l, double* best_u,
                                          double int_eps, double inf) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (s.v[u] == 0.0) continue;
    const Cands q = slot_candidates(s.v[u], make_slot(s.v[u], l[u], h[u], inf), a, lhs, rhs,
                                    s.m[u] != 0, int_eps, inf);
    put<RED, PRE>(best_l + s.c[u], best_u + s.c[u], q, inf);
  }
}

// load_strides with EAGER: the columns and marks loaded with the values,
// not after them (padding holds column 0), so the gather waits for one
// load instead of two.
template <int U, bool EAGER>
__device__ __forceinline__ void load_batch(Loaded<U>& s, const double* __restrict__ val,
                                           const int* __restrict__ col,
                                           const int* __restrict__ ii, int64_t base, int j0,
                                           int len, int k, int sl) {
  if (!EAGER) {
    load_strides(s, val, col, ii, base, j0, len, k, sl);
    return;
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int j = j0 + sl + u * kWarp;
    const bool in = j < (j0 == 0 && u == 0 ? k : len);
    const int64_t i = base + j;
    s.v[u] = in ? val[i] : 0.0;
    s.c[u] = in ? col[i] : 0;
    s.m[u] = in && ii != nullptr ? ii[i] : 0;
  }
}

// chunk_round with its switches: U strides held (the rest gathered again
// for the candidates), RED integer atomics (else compare-and-swap), LEN
// stopped at the chunk's length (else every slot), EAGER column loads, PRE
// the pre-check.
template <int G, int U, bool RED, bool LEN, bool EAGER, bool PRE>
__device__ __forceinline__ void held_chunk(const double* __restrict__ val,
                                           const int* __restrict__ col,
                                           const int* __restrict__ ii,
                                           const int* __restrict__ clen, const double* lb,
                                           const double* ub, int64_t c, int k, bool use,
                                           bool sum, const RowAgg& given, double lhs, double rhs,
                                           double* best_l, double* best_u, int sl,
                                           double int_eps, double inf) {
  const SplitBounds b{lb, ub};
  const int64_t base = c * k;
  const int kk = use ? k : 0;
  const int len = use ? (LEN ? clen[c] : k) : 0;
  Loaded<U> first;
  load_batch<U, EAGER>(first, val, col, ii, base, 0, len, kk, sl);
  double l[U], h[U];
  gather_strides(first, b, l, h);
  RowSumT<double> sums{};
  if (sum) {
    add_gathered(sums, first, l, h, inf);
    for (int j0 = U * kWarp; j0 < len; j0 += U * kWarp) {
      Loaded<U> s;
      load_batch<U, EAGER>(s, val, col, nullptr, base, j0, len, kk, sl);
      add_strides(sums, s, b, inf);
    }
  }
  RowAgg a = group_reduce<G>(sums);
  if (kk == 0) return;
  if (!sum) a = given;
  put_batch<U, RED, PRE>(first, l, h, a, lhs, rhs, best_l, best_u, int_eps, inf);
  for (int j0 = U * kWarp; j0 < len; j0 += U * kWarp) {
    Loaded<U> s;
    load_batch<U, EAGER>(s, val, col, ii, base, j0, len, kk, sl);
    double l2[U], h2[U];
    gather_strides(s, b, l2, h2);
    put_batch<U, RED, PRE>(s, l2, h2, a, lhs, rhs, best_l, best_u, int_eps, inf);
  }
}

// chunk_round's steps: U1 strides held (0: Strides<G>::U, four at K > 16),
// integer atomics, stopped at the length, EAGER, PRE.
template <int G, int U1, bool EAGER, bool PRE>
__device__ __forceinline__ void round_variant(const double* __restrict__ val,
                                              const int* __restrict__ col,
                                              const int* __restrict__ ii,
                                              const int* __restrict__ clen, const double* lb,
                                              const double* ub, int64_t c, int k, bool use,
                                              bool sum, const RowAgg& given, double lhs,
                                              double rhs, double* best_l, double* best_u,
                                              int sl, double int_eps, double inf) {
  constexpr int U = U1 > 0 ? U1 : Strides<G>::U;
  held_chunk<G, U, true, true, EAGER, PRE>(val, col, ii, clen, lb, ub, c, k, use, sum, given,
                                           lhs, rhs, best_l, best_u, sl, int_eps, inf);
}

// ---- #10 --------------------------------------------------------------------

template <int G, int V>
__global__ void __launch_bounds__(kThreads)
node_ballot(const double* __restrict__ val, const int* __restrict__ col,
            const int* __restrict__ ii, const int* __restrict__ clen,
            const double* __restrict__ lhs, const double* __restrict__ rhs,
            const double* __restrict__ lb, const double* __restrict__ ub,
            const bool* __restrict__ active, double* best_l, double* best_u, int64_t n_chunks,
            int k, int64_t bsz, int64_t n_pad, double int_eps, double inf) {
  const Lanes L = lanes_for<G>(n_chunks);
  const int lane = threadIdx.x % kWarp;
  const int64_t base = L.chunk * k;
  const int kk = L.live ? k : 0;
  const double lo = L.live ? lhs[L.chunk] : 0.0, hi = L.live ? rhs[L.chunk] : 0.0;
  for (int64_t b0 = 0; b0 < bsz; b0 += kWarp) {
    unsigned int todo = __ballot_sync(0xffffffffu, b0 + lane < bsz && active[b0 + lane]);
    while (todo != 0u) {
      const int64_t row = (b0 + __ffs(todo) - 1) * n_pad;
      todo &= todo - 1u;
      if (V == 0) {
        const RowAgg a = chunk_aggregates<G>(val, col, lb + row, ub + row, base, kk, L, inf);
        if (L.live)
          chunk_candidates_scatter(val, col, ii, lb + row, ub + row, a, lo, hi, best_l + row,
                                   best_u + row, base, k, L, int_eps, inf);
      } else {
        held_chunk<G, Strides<G>::U, (V >= 2), (V >= 3), false, true>(
            val, col, ii, clen, lb + row, ub + row, L.chunk, k, L.live, true, RowAgg{}, lo, hi,
            best_l + row, best_u + row, L.sl, int_eps, inf);
      }
    }
  }
}

// The port's node-major kernel body (prop_round.cu), its register budget and
// its chunk routine's switches parameters (MINB 1, U1 0, EAGER true, PRE
// false: the port's at K <= 32).
template <int G, int MINB, int U1, bool EAGER, bool PRE>
__global__ void __launch_bounds__(kThreads, MINB)
node_major(const double* __restrict__ val, const int* __restrict__ col,
           const int* __restrict__ ii, const int* __restrict__ clen,
           const double* __restrict__ lhs, const double* __restrict__ rhs,
           const double* __restrict__ lb, const double* __restrict__ ub,
           const bool* __restrict__ active, double* best_l, double* best_u, int64_t n_chunks,
           int k, int64_t bsz, int64_t n_pad, double int_eps, double inf) {
  extern __shared__ unsigned int words[];
  __shared__ int n_active;
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int n_words = static_cast<int>((bsz + kWarp - 1) / kWarp);
  if (threadIdx.x == 0) n_active = 0;
  __syncthreads();
  for (int w = warp; w < n_words; w += kWarpsPerBlock) {
    const int64_t b = static_cast<int64_t>(w) * kWarp + lane;
    const unsigned int m = __ballot_sync(0xffffffffu, b < bsz && active[b]);
    if (lane == 0) {
      words[w] = m;
      atomicAdd(&n_active, __popc(m));
    }
  }
  __syncthreads();
  const int64_t per_block = static_cast<int64_t>(kWarpsPerBlock) * (kWarp / G);
  const int64_t n_blocks = (n_chunks + per_block - 1) / per_block;
  const int64_t items = n_active * n_blocks;
  int64_t rank = -1;
  int word = -1;
  unsigned int left = 0u;
  for (int64_t item = blockIdx.x; item < items; item += gridDim.x) {
    const int64_t want = item / n_blocks;
    while (rank < want) {
      left &= left - 1u;
      while (left == 0u) left = words[++word];
      ++rank;
    }
    const int64_t node = static_cast<int64_t>(word) * kWarp + __ffs(left) - 1;
    const int64_t chunk = (item % n_blocks) * per_block + warp * (kWarp / G) + lane / G;
    const bool live = chunk < n_chunks;
    const int64_t row = node * n_pad;
    round_variant<G, U1, EAGER, PRE>(val, col, ii, clen, lb + row, ub + row, chunk, k, live,
                                     true, RowAgg{}, live ? lhs[chunk] : 0.0,
                                     live ? rhs[chunk] : 0.0, best_l + row, best_u + row,
                                     lane % G, int_eps, inf);
  }
}

// The port's #10 (prop_round.cu) on the walk #8 and #14 share.
template <int G, int U>
__global__ void __launch_bounds__(kThreads)
node_walk(const double* __restrict__ val, const int* __restrict__ col,
          const int* __restrict__ ii, const int* __restrict__ clen,
          const double* __restrict__ lhs, const double* __restrict__ rhs,
          const double* __restrict__ lb, const double* __restrict__ ub,
          const bool* __restrict__ active, double* best_l, double* best_u, int64_t n_chunks,
          int k, int64_t bsz, int64_t n_pad, double int_eps, double inf) {
  const EqualItems items_of{(n_chunks + block_chunks<G>() - 1) / block_chunks<G>()};
  const Walk walk = ballot_walk(active, bsz, items_of);
  WalkCursor cur;
  for (int64_t item = blockIdx.x; item < walk.items; item += gridDim.x) {
    cur.seek(item, walk, items_of);
    const WalkLanes L = walk_lanes<G>(item, cur, items_of, n_chunks);
    const int64_t c = L.chunk, row = cur.plane * n_pad;
    chunk_round<G, U>(val, col, ii, SplitBounds{lb + row, ub + row}, c * k, L.live ? k : 0,
                      L.live ? clen[c] : 0, true, RowAgg{}, L.live ? lhs[c] : 0.0,
                      L.live ? rhs[c] : 0.0, best_l + row, best_u + row, L.sl, int_eps, inf);
  }
}

template <typename Kernel>
unsigned int resident_blocks(Kernel kernel, size_t shm) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, shm);
  return static_cast<unsigned int>(sms * per_sm > 0 ? sms * per_sm : 1);
}

// A node-major launch over at most the resident blocks.
template <auto Kernel, typename... Args>
int major(unsigned int blocks, size_t shm, cudaStream_t stream, Args... args) {
  const unsigned int r = resident_blocks(Kernel, shm);
  Kernel<<<blocks < r ? blocks : r, kThreads, shm, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <int G>
int node_variant_g(int v, const double* val, const int* col, const int* ii, const int* clen,
                   const double* lhs, const double* rhs, const double* lb, const double* ub,
                   const bool* active, double* best_l, double* best_u, int64_t n_chunks, int k,
                   int64_t bsz, int64_t n_pad, double int_eps, double inf, cudaStream_t stream) {
  const unsigned int blocks = chunk_blocks(n_chunks, k);
  const size_t shm = sizeof(unsigned int) * static_cast<size_t>((bsz + kWarp - 1) / kWarp);
#define ARGS val, col, ii, clen, lhs, rhs, lb, ub, active, best_l, best_u, n_chunks, k, bsz, \
             n_pad, int_eps, inf
  switch (v) {
    case 0: node_ballot<G, 0><<<blocks, kThreads, 0, stream>>>(ARGS); break;
    case 1: node_ballot<G, 1><<<blocks, kThreads, 0, stream>>>(ARGS); break;
    case 2: node_ballot<G, 2><<<blocks, kThreads, 0, stream>>>(ARGS); break;
    case 3: node_ballot<G, 3><<<blocks, kThreads, 0, stream>>>(ARGS); break;
    case 4: return major<node_major<G, 1, 0, false, true>>(blocks, shm, stream, ARGS);
    case 5: node_major<G, 1, 0, false, true><<<blocks, kThreads, shm, stream>>>(ARGS); break;
    case 6: return major<node_major<G, 4, 0, false, true>>(blocks, shm, stream, ARGS);
    case 7: return major<node_major<G, 6, 0, false, true>>(blocks, shm, stream, ARGS);
    case 8: return major<node_major<G, 8, 0, false, true>>(blocks, shm, stream, ARGS);
    case 9: return major<node_major<G, 1, 0, true, true>>(blocks, shm, stream, ARGS);
    case 10: return major<node_major<G, 1, 0, true, false>>(blocks, shm, stream, ARGS);
    case 11: return major<node_major<G, 6, 0, true, true>>(blocks, shm, stream, ARGS);
    case 12: return major<node_major<G, 1, 0, false, false>>(blocks, shm, stream, ARGS);
    case 13: return launch_walk<node_walk<G, Strides<G>::U>>(blocks, bsz, stream, ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef ARGS
  return static_cast<int>(cudaGetLastError());
}

// ---- #12's scatter ----------------------------------------------------------

// slab_round.cu before the redesign: the run of a copy tile by a binary
// search, and the chunk's round by window_round.
__device__ __forceinline__ int run_of(const int* __restrict__ run_start, int n_runs,
                                      int64_t tile) {
  int lo = 0, hi = n_runs - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (run_start[mid] <= tile) lo = mid; else hi = mid - 1;
  }
  return lo;
}

struct Slab {
  const double *val, *smf, *sxf, *lhs, *rhs, *lb, *ub;
  const int *col, *ii, *clen, *done, *smc, *sxc, *run_start, *run_inst, *run_slab, *tile_inst,
      *tile_slab;
  const bool* active;
  double *best_l, *best_u;
  int n_runs, r, k;
  int64_t n_chunks, width, slab;
  double int_eps, inf;
  int64_t bsz;  // node planes (#14 only)
};

// V: 0 before the redesign, 1-3 the search with the routine's steps, 4 and
// up the tile maps with the routine's switches U1, EAGER, PRE.
template <int G, int V, int MINB, int U1 = 0, bool EAGER = false, bool PRE = true>
__global__ void __launch_bounds__(kThreads, MINB) slab_kernel(const Slab s) {
  const Lanes L = lanes_for<G>(s.n_chunks);
  bool use = false;
  int64_t off = 0;
  if (L.live) {
    const int64_t t = L.chunk / s.r;
    int64_t inst, sl;
    if (V >= 4) {
      inst = s.tile_inst[t];
      sl = s.tile_slab[t];
    } else {
      const int run = run_of(s.run_start, s.n_runs, t);
      inst = s.run_inst[run];
      sl = s.run_slab[run];
    }
    use = s.active[inst];
    off = inst * s.width + sl * s.slab;
  }
  const int64_t c = L.chunk;
  if (V == 0) {
    const int64_t base = c * s.k;
    const bool local = use && s.done[c] != 0;
    RowAgg a = chunk_aggregates<G>(s.val, s.col, s.lb + off, s.ub + off, base, local ? s.k : 0,
                                   L, s.inf);
    if (!use) return;
    if (!local) a = RowAgg{s.smf[c], s.sxf[c], s.smc[c], s.sxc[c]};
    chunk_candidates_scatter(s.val, s.col, s.ii, s.lb + off, s.ub + off, a, s.lhs[c], s.rhs[c],
                             s.best_l + off, s.best_u + off, base, s.k, L, s.int_eps, s.inf);
    return;
  }
  if (!__any_sync(0xffffffffu, use)) return;
  const bool local = use && s.done[c] != 0;
  const RowAgg given =
      use && !local ? RowAgg{s.smf[c], s.sxf[c], s.smc[c], s.sxc[c]} : RowAgg{};
  if (V >= 4) {
    round_variant<G, U1, EAGER, PRE>(s.val, s.col, s.ii, s.clen, s.lb + off, s.ub + off, c,
                                     s.k, use, local, given, use ? s.lhs[c] : 0.0,
                                     use ? s.rhs[c] : 0.0, s.best_l + off, s.best_u + off,
                                     L.sl, s.int_eps, s.inf);
    return;
  }
  held_chunk<G, Strides<G>::U, (V >= 2), (V >= 3), false, true>(
      s.val, s.col, s.ii, s.clen, s.lb + off, s.ub + off, c, s.k, use, local, given,
      use ? s.lhs[c] : 0.0, use ? s.rhs[c] : 0.0, s.best_l + off, s.best_u + off, L.sl,
      s.int_eps, s.inf);
}

template <int G>
int slab_variant_g(int v, const Slab& s, cudaStream_t stream) {
  const unsigned int blocks = chunk_blocks(s.n_chunks, s.k);
  switch (v) {
    case 0: slab_kernel<G, 0, 1><<<blocks, kThreads, 0, stream>>>(s); break;
    case 1: slab_kernel<G, 1, 1><<<blocks, kThreads, 0, stream>>>(s); break;
    case 2: slab_kernel<G, 2, 1><<<blocks, kThreads, 0, stream>>>(s); break;
    case 3: slab_kernel<G, 3, 1><<<blocks, kThreads, 0, stream>>>(s); break;
    case 4: slab_kernel<G, 4, 1><<<blocks, kThreads, 0, stream>>>(s); break;
    case 5: slab_kernel<G, 4, 4><<<blocks, kThreads, 0, stream>>>(s); break;
    case 6: slab_kernel<G, 4, 1, 1><<<blocks, kThreads, 0, stream>>>(s); break;
    case 7: slab_kernel<G, 4, 1, 1, true><<<blocks, kThreads, 0, stream>>>(s); break;
    case 8: slab_kernel<G, 4, 1, 1, true, false><<<blocks, kThreads, 0, stream>>>(s); break;
    case 9: slab_kernel<G, 4, 4, 1, true><<<blocks, kThreads, 0, stream>>>(s); break;
    case 10: slab_kernel<G, 4, 6, 1, true><<<blocks, kThreads, 0, stream>>>(s); break;
    case 11: slab_kernel<G, 4, 8, 1, true><<<blocks, kThreads, 0, stream>>>(s); break;
    case 12: slab_kernel<G, 4, 1, 1, false, false><<<blocks, kThreads, 0, stream>>>(s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---- #8 ---------------------------------------------------------------------

struct Batched {
  const double *val, *lhs, *rhs, *lb, *ub;
  const int *col, *ii, *clen, *tile_inst;
  const int64_t* start;
  const bool* active;
  double *best_l, *best_u;
  int64_t n_chunks, bsz, n_pad;
  int r, k;
  double int_eps, inf;
};

// V 0: the kernel before the redesign; 1-3 chunk_round's steps over the
// same grid (RED: integer atomics, LEN: stopped at the length).
template <int G, int U, int V>
__global__ void __launch_bounds__(kThreads) batched_stream(const Batched s) {
  const Lanes L = lanes_for<G>(s.n_chunks);
  bool on = false;
  int64_t row = 0;
  if (L.live) {
    const int64_t inst = s.tile_inst[L.chunk / s.r];
    on = s.active[inst];
    row = inst * s.n_pad;
  }
  if (!__any_sync(0xffffffffu, on)) return;
  const int64_t c = L.chunk;
  if (V == 0) {
    const int64_t base = c * s.k;
    const RowAgg a = chunk_aggregates<G>(s.val, s.col, s.lb + row, s.ub + row, base,
                                         on ? s.k : 0, L, s.inf);
    if (!on) return;
    chunk_candidates_scatter(s.val, s.col, s.ii, s.lb + row, s.ub + row, a, s.lhs[c], s.rhs[c],
                             s.best_l + row, s.best_u + row, base, s.k, L, s.int_eps, s.inf);
    return;
  }
  held_chunk<G, U, (V >= 2), (V >= 3), true, false>(
      s.val, s.col, s.ii, s.clen, s.lb + row, s.ub + row, c, s.k, on, true, RowAgg{},
      on ? s.lhs[c] : 0.0, on ? s.rhs[c] : 0.0, s.best_l + row, s.best_u + row, L.sl,
      s.int_eps, s.inf);
}

// #8 on the active-only walk over (instance, chunk block) items, chunk_round
// on each; MINB 4 (at most 64 registers) is the port's (prop_round.cu).
template <int G, int U, int MINB = 1>
__global__ void __launch_bounds__(kThreads, MINB) batched_walk(const Batched s) {
  const RangeItems items_of{s.start, block_chunks<G>()};
  const Walk walk = ballot_walk(s.active, s.bsz, items_of);
  WalkCursor cur;
  for (int64_t item = blockIdx.x; item < walk.items; item += gridDim.x) {
    cur.seek(item, walk, items_of);
    const WalkLanes L = walk_lanes<G>(item, cur, items_of, 0);
    const int64_t c = L.chunk, row = cur.plane * s.n_pad;
    chunk_round<G, U>(s.val, s.col, s.ii, SplitBounds{s.lb + row, s.ub + row}, c * s.k,
                      L.live ? s.k : 0, L.live ? s.clen[c] : 0, true, RowAgg{},
                      L.live ? s.lhs[c] : 0.0, L.live ? s.rhs[c] : 0.0, s.best_l + row,
                      s.best_u + row, L.sl, s.int_eps, s.inf);
  }
}

template <int G, int U>
int batched_variant_gu(int v, const Batched& s, cudaStream_t stream) {
  const unsigned int blocks = chunk_blocks(s.n_chunks, s.k);
  switch (v) {
    case 0: batched_stream<G, U, 0><<<blocks, kThreads, 0, stream>>>(s); break;
    case 1: batched_stream<G, U, 1><<<blocks, kThreads, 0, stream>>>(s); break;
    case 2: batched_stream<G, U, 2><<<blocks, kThreads, 0, stream>>>(s); break;
    case 3: batched_stream<G, U, 3><<<blocks, kThreads, 0, stream>>>(s); break;
    case 4: return launch_walk<batched_walk<G, U>>(blocks + s.bsz, s.bsz, stream, s);
    case 5: return launch_walk<batched_walk<G, U, 4>>(blocks + s.bsz, s.bsz, stream, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---- #14's scatter ------------------------------------------------------------

// slab_round.cu before the redesign: a copy's window by the search, and
// its chunk's round by kernel D's routine (window_round).
template <int G>
__device__ __forceinline__ void window_round(const Slab& s, const Lanes& L, int64_t row,
                                             int64_t agg, bool use) {
  const int64_t base = L.chunk * s.k;
  const bool local = use && s.done[L.chunk] != 0;
  RowAgg a = chunk_aggregates<G>(s.val, s.col, s.lb + row, s.ub + row, base, local ? s.k : 0,
                                 L, s.inf);
  if (!use) return;
  if (!local) a = RowAgg{s.smf[agg], s.sxf[agg], s.smc[agg], s.sxc[agg]};
  chunk_candidates_scatter(s.val, s.col, s.ii, s.lb + row, s.ub + row, a, s.lhs[L.chunk],
                           s.rhs[L.chunk], s.best_l + row, s.best_u + row, base, s.k, L,
                           s.int_eps, s.inf);
}

// V 0: the kernel before the redesign; 1: the same order and search,
// chunk_round; 2: as 1, the window from tile_slab.
template <int G, int U, int V>
__global__ void __launch_bounds__(kThreads) node_slab_ballot(const Slab s) {
  const Lanes L = lanes_for<G>(s.n_chunks);
  const int lane = threadIdx.x % kWarp;
  int64_t off = 0;
  if (L.live) {
    const int64_t t = L.chunk / s.r;
    off = static_cast<int64_t>(V == 2 ? s.tile_slab[t] : s.run_slab[run_of(s.run_start,
                                                                            s.n_runs, t)]) *
          s.slab;
  }
  const int64_t c = L.chunk;
  for (int64_t b0 = 0; b0 < s.bsz; b0 += kWarp) {
    unsigned int todo = __ballot_sync(0xffffffffu, b0 + lane < s.bsz && s.active[b0 + lane]);
    while (todo != 0u) {
      const int64_t b = b0 + __ffs(todo) - 1;
      todo &= todo - 1u;
      const int64_t row = b * s.width + off, agg = b * s.n_chunks + c;
      if (V == 0) {
        window_round<G>(s, L, row, agg, L.live);
        continue;
      }
      const bool local = L.live && s.done[c] != 0;
      const RowAgg given = L.live && !local
                               ? RowAgg{s.smf[agg], s.sxf[agg], s.smc[agg], s.sxc[agg]}
                               : RowAgg{};
      chunk_round<G, U>(s.val, s.col, s.ii, SplitBounds{s.lb + row, s.ub + row}, c * s.k,
                        L.live ? s.k : 0, L.live ? s.clen[c] : 0, local, given,
                        L.live ? s.lhs[c] : 0.0, L.live ? s.rhs[c] : 0.0, s.best_l + row,
                        s.best_u + row, L.sl, s.int_eps, s.inf);
    }
  }
}

// #14's scatter on the node-major walk; MINB 4 (at most 64 registers, four
// blocks an SM) is the port's (slab_round.cu).
template <int G, int U, int MINB = 1>
__global__ void __launch_bounds__(kThreads, MINB) node_slab_walk(const Slab s) {
  const EqualItems items_of{(s.n_chunks + block_chunks<G>() - 1) / block_chunks<G>()};
  const Walk walk = ballot_walk(s.active, s.bsz, items_of);
  WalkCursor cur;
  for (int64_t item = blockIdx.x; item < walk.items; item += gridDim.x) {
    cur.seek(item, walk, items_of);
    const WalkLanes L = walk_lanes<G>(item, cur, items_of, s.n_chunks);
    const int64_t c = L.chunk;
    int64_t off = 0;
    bool local = false;
    RowAgg given{};
    if (L.live) {
      off = cur.plane * s.width + static_cast<int64_t>(s.tile_slab[c / s.r]) * s.slab;
      local = s.done[c] != 0;
      if (!local) {
        const int64_t a = cur.plane * s.n_chunks + c;
        given = RowAgg{s.smf[a], s.sxf[a], s.smc[a], s.sxc[a]};
      }
    }
    chunk_round<G, U>(s.val, s.col, s.ii, SplitBounds{s.lb + off, s.ub + off}, c * s.k,
                      L.live ? s.k : 0, L.live ? s.clen[c] : 0, local, given,
                      L.live ? s.lhs[c] : 0.0, L.live ? s.rhs[c] : 0.0, s.best_l + off,
                      s.best_u + off, L.sl, s.int_eps, s.inf);
  }
}

// Node-major over groups of NB active nodes: an item is (group, chunk
// block); each warp runs its chunks for the group's nodes in turn, so the
// copy stream's loads after the first node hit L1, and the rows in flight
// are those of NB nodes.  NB = 1 is the node-major walk.
template <int G, int U, int NB, int MINB = 1>
__global__ void __launch_bounds__(kThreads, MINB) node_slab_groups(const Slab s) {
  const EqualItems ones{1};
  const Walk walk = ballot_walk(s.active, s.bsz, ones);  // items: the active ranks
  const int64_t n_blocks = (s.n_chunks + block_chunks<G>() - 1) / block_chunks<G>();
  const int64_t items = (walk.items + NB - 1) / NB * n_blocks;
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  WalkCursor first;
  for (int64_t item = blockIdx.x; item < items; item += gridDim.x) {
    const int64_t g = item / n_blocks;
    first.seek(g * NB, walk, ones);
    const int64_t c = (item % n_blocks) * block_chunks<G>() + warp * (kWarp / G) + lane / G;
    const bool live = c < s.n_chunks;
    const int sl = lane % G;
    const int64_t slab_off = live ? static_cast<int64_t>(s.tile_slab[c / s.r]) * s.slab : 0;
    const bool local = live && s.done[c] != 0;
    const int kk = live ? s.k : 0, len = live ? s.clen[c] : 0;
    const double lo = live ? s.lhs[c] : 0.0, hi = live ? s.rhs[c] : 0.0;
    WalkCursor cur = first;
    for (int j = 0; j < NB; ++j) {
      const int64_t rank = g * NB + j;
      if (rank >= walk.items) break;
      if (j > 0) cur.seek(rank, walk, ones);
      const int64_t off = cur.plane * s.width + slab_off;
      RowAgg given{};
      if (live && !local) {
        const int64_t a = cur.plane * s.n_chunks + c;
        given = RowAgg{s.smf[a], s.sxf[a], s.smc[a], s.sxc[a]};
      }
      chunk_round<G, U>(s.val, s.col, s.ii, SplitBounds{s.lb + off, s.ub + off}, c * s.k, kk,
                        len, local, given, lo, hi, s.best_l + off, s.best_u + off, sl,
                        s.int_eps, s.inf);
    }
  }
}

// chunk_round with its first U strides loaded by the caller, so that a warp
// running one chunk for several nodes loads them once.
template <int G, int U>
__device__ __forceinline__ void held_round(const Loaded<U>& first, const Slab& s, int64_t c,
                                           int kk, int len, bool sum, const RowAgg& given,
                                           double lhs, double rhs, int64_t off, int sl) {
  const SplitBounds b{s.lb + off, s.ub + off};
  double l[U], h[U];
  gather_strides(first, b, l, h);
  RowSumT<double> sums{};
  if (sum) {
    add_gathered(sums, first, l, h, s.inf);
    for (int j0 = U * kWarp; j0 < len; j0 += U * kWarp) {
      Loaded<U> t;
      load_strides<U, true>(t, s.val, s.col, nullptr, c * s.k, j0, len, kk, sl);
      add_strides(sums, t, b, s.inf);
    }
  }
  RowAgg a = group_reduce<G>(sums);
  if (kk == 0) return;
  if (!sum) a = given;
  scatter_gathered<U, false>(first, l, h, a, lhs, rhs, s.best_l + off, s.best_u + off,
                             s.int_eps, s.inf);
  for (int j0 = U * kWarp; j0 < len; j0 += U * kWarp) {
    Loaded<U> t;
    load_strides<U, true>(t, s.val, s.col, s.ii, c * s.k, j0, len, kk, sl);
    scatter_strides<U, false>(t, b, a, lhs, rhs, s.best_l + off, s.best_u + off, s.int_eps,
                              s.inf);
  }
}

// As node_slab_groups, each chunk's data (window slab, row_done, length,
// sides) and first strides loaded once per item and held while the warp
// runs the group's nodes.
template <int G, int U, int NB, int MINB = 1>
__global__ void __launch_bounds__(kThreads, MINB) node_slab_held(const Slab s) {
  const EqualItems ones{1};
  const Walk walk = ballot_walk(s.active, s.bsz, ones);
  const int64_t n_blocks = (s.n_chunks + block_chunks<G>() - 1) / block_chunks<G>();
  const int64_t items = (walk.items + NB - 1) / NB * n_blocks;
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int sl = lane % G;
  WalkCursor first;
  for (int64_t item = blockIdx.x; item < items; item += gridDim.x) {
    const int64_t g = item / n_blocks;
    first.seek(g * NB, walk, ones);
    const int64_t c = (item - g * n_blocks) * block_chunks<G>() + warp * (kWarp / G) + lane / G;
    const bool live = c < s.n_chunks;
    const int64_t slab_off = live ? static_cast<int64_t>(s.tile_slab[c / s.r]) * s.slab : 0;
    const bool local = live && s.done[c] != 0;
    const int kk = live ? s.k : 0, len = live ? s.clen[c] : 0;
    const double lo = live ? s.lhs[c] : 0.0, hi = live ? s.rhs[c] : 0.0;
    Loaded<U> held;
    load_strides<U, true>(held, s.val, s.col, s.ii, c * s.k, 0, len, kk, sl);
    WalkCursor cur = first;
    const int64_t rest = walk.items - g * NB, last = rest < NB ? rest : NB;
    for (int64_t j = 0; j < last; ++j) {
      if (j > 0) cur.seek(g * NB + j, walk, ones);
      RowAgg given{};
      if (live && !local) {
        const int64_t a = cur.plane * s.n_chunks + c;
        given = RowAgg{s.smf[a], s.sxf[a], s.smc[a], s.sxc[a]};
      }
      held_round<G, U>(held, s, c, kk, len, local, given, lo, hi,
                       cur.plane * s.width + slab_off, sl);
    }
  }
}

template <int G, int U>
int node_slab_variant_gu(int v, const Slab& s, cudaStream_t stream) {
  const unsigned int blocks = chunk_blocks(s.n_chunks, s.k);
  switch (v) {
    case 0: node_slab_ballot<G, U, 0><<<blocks, kThreads, 0, stream>>>(s); break;
    case 1: node_slab_ballot<G, U, 1><<<blocks, kThreads, 0, stream>>>(s); break;
    case 2: node_slab_ballot<G, U, 2><<<blocks, kThreads, 0, stream>>>(s); break;
    case 3: return launch_walk<node_slab_walk<G, U>>(blocks, s.bsz, stream, s);
    case 4: return launch_walk<node_slab_walk<G, U, 4>>(blocks, s.bsz, stream, s);
    case 5: return launch_walk<node_slab_walk<G, U, 6>>(blocks, s.bsz, stream, s);
    case 6: return launch_walk<node_slab_groups<G, U, 8>>(blocks, s.bsz, stream, s);
    case 7: return launch_walk<node_slab_held<G, U, 8>>(blocks, s.bsz, stream, s);
    case 8: return launch_walk<node_slab_held<G, U, 8, 4>>(blocks, s.bsz, stream, s);
    case 9: return launch_walk<node_slab_groups<G, U, 1024, 4>>(blocks, s.bsz, stream, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---- D ----------------------------------------------------------------------

struct Fused {
  const double *val, *lhs, *rhs, *lb, *ub;
  const int *col, *ii, *clen;
  double *best_l, *best_u;
  int64_t n_chunks;
  int k;
  double int_eps, inf;
};

// V 0: the kernel before the redesign; 1-3 chunk_round's steps over G lanes
// a chunk (RED: integer atomics, LEN: stopped at the length); MINB blocks
// an SM.
template <int G, int U, int V, int MINB = 1>
__global__ void __launch_bounds__(kThreads, MINB) fused_kernel(const Fused s) {
  const Lanes L = lanes_for<G>(s.n_chunks);
  const int64_t c = L.chunk;
  if (V == 0) {
    const int64_t base = c * s.k;
    const RowAgg a = chunk_aggregates<G>(s.val, s.col, s.lb, s.ub, base, L.live ? s.k : 0, L,
                                         s.inf);
    if (!L.live) return;
    chunk_candidates_scatter(s.val, s.col, s.ii, s.lb, s.ub, a, s.lhs[c], s.rhs[c], s.best_l,
                             s.best_u, base, s.k, L, s.int_eps, s.inf);
    return;
  }
  held_chunk<G, U, (V >= 3), (V >= 2), true, false>(
      s.val, s.col, s.ii, s.clen, s.lb, s.ub, c, s.k, L.live, true, RowAgg{},
      L.live ? s.lhs[c] : 0.0, L.live ? s.rhs[c] : 0.0, s.best_l, s.best_u, L.sl, s.int_eps,
      s.inf);
}

// The variants of G lanes a chunk and U strides held; v picks the step.
template <int G, int U>
int fused_variant_gu(int v, const Fused& s, cudaStream_t stream) {
  const unsigned int blocks = chunk_blocks(s.n_chunks, G);
  switch (v) {
    case 0: fused_kernel<G, U, 0><<<blocks, kThreads, 0, stream>>>(s); break;
    case 1: fused_kernel<G, U, 1><<<blocks, kThreads, 0, stream>>>(s); break;
    case 2: fused_kernel<G, U, 2><<<blocks, kThreads, 0, stream>>>(s); break;
    case 3: case 4: fused_kernel<G, U, 3><<<blocks, kThreads, 0, stream>>>(s); break;
    case 5: case 7: fused_kernel<G, U, 3, 4><<<blocks, kThreads, 0, stream>>>(s); break;
    case 6: fused_kernel<G, U, 3, 6><<<blocks, kThreads, 0, stream>>>(s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int G>
int fused_variant_g(int v, const Fused& s, int held, cudaStream_t stream) {
  if constexpr (G < kWarp) {
    return fused_variant_gu<G, 1>(v, s, stream);
  } else {
    return held <= 1   ? fused_variant_gu<G, 1>(v, s, stream)
           : held == 2 ? fused_variant_gu<G, 2>(v, s, stream)
                       : fused_variant_gu<G, 4>(v, s, stream);
  }
}

// ---- #13 ----------------------------------------------------------------------

struct Partials {
  const double *val, *lb, *ub;
  const int *col, *clen, *run_start, *run_slab, *tile_slab;
  const bool* active;
  double *mf, *xf;
  int *mc, *xc;
  int n_runs, r, k;
  int64_t n_chunks, bsz, width, slab;
  double inf;
};

__device__ __forceinline__ void put_partials(const Partials& s, const RowAgg& a, int64_t o) {
  s.mf[o] = a.mf;
  s.mc[o] = a.mc;
  s.xf[o] = a.xf;
  s.xc[o] = a.xc;
}

// The kernel before the redesign: each warp ballots the mask and runs its
// fixed chunk for every active node in turn; the window by a binary search
// over the runs, chunk_aggregates over every slot.
template <int G>
__global__ void __launch_bounds__(kThreads) partials_ballot(const Partials s) {
  const Lanes L = lanes_for<G>(s.n_chunks);
  const int lane = threadIdx.x % kWarp;
  const int64_t off =
      L.live ? static_cast<int64_t>(s.run_slab[run_of(s.run_start, s.n_runs, L.chunk / s.r)]) *
                   s.slab
             : 0;
  const int kk = L.live ? s.k : 0;
  for (int64_t b0 = 0; b0 < s.bsz; b0 += kWarp) {
    unsigned int todo = __ballot_sync(0xffffffffu, b0 + lane < s.bsz && s.active[b0 + lane]);
    while (todo != 0u) {
      const int64_t b = b0 + __ffs(todo) - 1;
      todo &= todo - 1u;
      const int64_t row = b * s.width + off;
      const RowAgg a =
          chunk_aggregates<G>(s.val, s.col, s.lb + row, s.ub + row, L.chunk * s.k, kk, L, s.inf);
      if (L.live && L.sl == 0) put_partials(s, a, b * s.n_chunks + L.chunk);
    }
  }
}

// Node-major on the active-only walk (#14's order; the port's #13).
template <int G, int U>
__global__ void __launch_bounds__(kThreads) partials_walk(const Partials s) {
  const EqualItems items_of{(s.n_chunks + block_chunks<G>() - 1) / block_chunks<G>()};
  const Walk walk = ballot_walk(s.active, s.bsz, items_of);
  WalkCursor cur;
  for (int64_t item = blockIdx.x; item < walk.items; item += gridDim.x) {
    cur.seek(item, walk, items_of);
    const WalkLanes L = walk_lanes<G>(item, cur, items_of, s.n_chunks);
    const int64_t c = L.chunk;
    const int64_t off =
        L.live ? cur.plane * s.width + static_cast<int64_t>(s.tile_slab[c / s.r]) * s.slab : 0;
    Loaded<U> first;
    double l[U], h[U];
    const RowAgg a = chunk_sums<G, U>(first, l, h, s.val, s.col, nullptr,
                                      SplitBounds{s.lb + off, s.ub + off}, c * s.k,
                                      L.live ? s.k : 0, L.live ? s.clen[c] : 0, true, L.sl,
                                      s.inf);
    if (L.live && L.sl == 0) put_partials(s, a, cur.plane * s.n_chunks + c);
  }
}

// Chunk once: an item is (group of NB active nodes, chunk block).  A warp
// loads its chunks' first strides once, issues the bound gathers of the
// group's nodes, then sums each node in turn (strides past the first U are
// loaded again per node).
template <int G, int U, int NB>
__global__ void __launch_bounds__(kThreads) partials_once(const Partials s) {
  const EqualItems ones{1};
  const Walk walk = ballot_walk(s.active, s.bsz, ones);  // items: the active ranks
  const int64_t n_blocks = (s.n_chunks + block_chunks<G>() - 1) / block_chunks<G>();
  const int64_t items = (walk.items + NB - 1) / NB * n_blocks;
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int sl = lane % G;
  WalkCursor first;
  for (int64_t item = blockIdx.x; item < items; item += gridDim.x) {
    const int64_t g = item / n_blocks;
    first.seek(g * NB, walk, ones);
    const int64_t c = (item - g * n_blocks) * block_chunks<G>() + warp * (kWarp / G) + lane / G;
    const bool live = c < s.n_chunks;
    const int64_t slab_off = live ? static_cast<int64_t>(s.tile_slab[c / s.r]) * s.slab : 0;
    const int kk = live ? s.k : 0, len = live ? s.clen[c] : 0;
    Loaded<U> held;
    load_strides<U, true>(held, s.val, s.col, nullptr, c * s.k, 0, len, kk, sl);
    const int64_t rest = walk.items - g * NB, last = rest < NB ? rest : NB;
    int64_t plane[NB];
    double l[NB][U], h[NB][U];
    WalkCursor cur = first;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      plane[j] = 0;
      if (j < last) {
        if (j > 0) cur.seek(g * NB + j, walk, ones);
        plane[j] = cur.plane;
        const int64_t off = cur.plane * s.width + slab_off;
        gather_strides(held, SplitBounds{s.lb + off, s.ub + off}, l[j], h[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      if (j >= last) break;
      const int64_t off = plane[j] * s.width + slab_off;
      const SplitBounds b{s.lb + off, s.ub + off};
      RowSumT<double> sums{};
      add_gathered(sums, held, l[j], h[j], s.inf);
      for (int j0 = U * kWarp; j0 < len; j0 += U * kWarp) {
        Loaded<U> t;
        load_strides<U, true>(t, s.val, s.col, nullptr, c * s.k, j0, len, kk, sl);
        add_strides(sums, t, b, s.inf);
      }
      if (live && sl == 0) put_partials(s, group_reduce<G>(sums), plane[j] * s.n_chunks + c);
    }
  }
}

template <int G, int U>
int partials_variant_gu(int v, const Partials& s, cudaStream_t stream) {
  const int64_t most = chunk_blocks(s.n_chunks, G);
  switch (v) {
    case 1: return launch_walk<partials_walk<G, U>>(most, s.bsz, stream, s);
    case 2: return launch_walk<partials_once<G, U, 4>>(most, s.bsz, stream, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---- #9 and #15 -------------------------------------------------------------

// #9 on the active-only walk over (active row, V blocks of kThreads
// columns) items, a thread's V columns loaded before any is merged; ANY:
// one flag store per warp that tightened (the port's #9 before it shared
// #15's body); WIN: #15's flags, one per warp and window of `slab` columns.
template <bool ANY, int V = 1, bool WIN = false>
__global__ void __launch_bounds__(kThreads)
merge_walk(double* __restrict__ lb, double* __restrict__ ub, double* __restrict__ best_l,
           double* __restrict__ best_u, const bool* __restrict__ active, int* __restrict__ flags,
           int64_t bsz, int64_t width, double eps, double inf, double outward, int64_t slab,
           int64_t n_slabs) {
  constexpr int64_t kCols = static_cast<int64_t>(kThreads) * V;
  const EqualItems items_of{(width + kCols - 1) / kCols};
  const Walk walk = ballot_walk(active, bsz, items_of);
  WalkCursor cur;
  for (int64_t item = blockIdx.x; item < walk.items; item += gridDim.x) {
    cur.seek(item, walk, items_of);
    const int64_t j0 = (item - cur.first) * kCols + threadIdx.x, row = cur.plane * width;
    double l[V], u[V], bl[V], bu[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int64_t j = j0 + v * kThreads;
      const bool in = j < width;
      l[v] = in ? lb[row + j] : 0.0;
      u[v] = in ? ub[row + j] : 0.0;
      bl[v] = in ? best_l[row + j] : -inf;
      bu[v] = in ? best_u[row + j] : inf;
    }
    bool ch = false;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int64_t i = row + j0 + v * kThreads;
      if (bl[v] != -inf) best_l[i] = -inf;
      if (bu[v] != inf) best_u[i] = inf;
      const bool c = j0 + v * kThreads < width &&
                     merge_loaded(lb, ub, i, l[v], u[v], bl[v], bu[v], eps, inf, outward);
      ch |= c;
      if (WIN && __any_sync(0xffffffffu, c) && threadIdx.x % kWarp == 0)
        flags[cur.plane * n_slabs + (j0 - threadIdx.x % kWarp + v * kThreads) / slab] = 1;
    }
    if (!WIN && ANY) {
      if (__any_sync(0xffffffffu, ch) && threadIdx.x % kWarp == 0) flags[cur.plane] = 1;
    } else if (!WIN && ch) {
      flags[cur.plane] = 1;
    }
  }
}

template <bool RESET>
__global__ void __launch_bounds__(kThreads)
merge_batch(double* __restrict__ lb, double* __restrict__ ub, double* __restrict__ best_l,
            double* __restrict__ best_u, const bool* __restrict__ active,
            int* __restrict__ flags, int64_t width, int64_t slab, int64_t n_slabs, double eps,
            double inf, double outward) {
  const int64_t b = blockIdx.y;
  if (!active[b]) return;
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= width) return;
  const int64_t i = b * width + j;
  const bool ch = RESET ? merge_reset(lb, ub, best_l, best_u, i, eps, inf, outward)
                        : merge_one(lb, ub, best_l, best_u, i, eps, inf, outward);
  if (ch) flags[b * n_slabs + j / slab] = 1;
}

// #9 over a (column block, group of 32 rows) grid: each warp ballots its
// group's flags and merges its column of each active row in turn.
__global__ void __launch_bounds__(kThreads)
merge_groups(double* __restrict__ lb, double* __restrict__ ub, double* __restrict__ best_l,
             double* __restrict__ best_u, const bool* __restrict__ active,
             int* __restrict__ flags, int64_t bsz, int64_t width, double eps, double inf,
             double outward) {
  const int lane = threadIdx.x % kWarp;
  const int64_t b0 = static_cast<int64_t>(blockIdx.y) * kWarp;
  unsigned int todo = __ballot_sync(0xffffffffu, b0 + lane < bsz && active[b0 + lane]);
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  while (todo != 0u) {
    const int64_t b = b0 + __ffs(todo) - 1;
    todo &= todo - 1u;
    const bool ch =
        j < width && merge_reset(lb, ub, best_l, best_u, b * width + j, eps, inf, outward);
    if (__any_sync(0xffffffffu, ch) && lane == 0) flags[b] = 1;
  }
}

#endif  // NODE_ROUND_ONLY

// ---- node A' and node E -------------------------------------------------------

// The kernels before the redesign (variant 0), as the port shipped them.
template <int G, typename T, typename C>
__global__ void __launch_bounds__(kThreads)
parent_gather_kernel(const T* __restrict__ val, const C* __restrict__ col,
                     const int* __restrict__ clen, const T* __restrict__ lb,
                     const T* __restrict__ ub, const bool* __restrict__ active,
                     T* __restrict__ mf, int* __restrict__ mc, T* __restrict__ xf,
                     int* __restrict__ xc, int64_t n_chunks, int k, int64_t bsz, int64_t n_pad,
                     T inf) {
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
parent_scatter_kernel(const T* __restrict__ val, const C* __restrict__ col,
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

// A scalar of the entries (a double holding a value of T) as T.
template <typename T>
T scalar(double x) {
  if constexpr (std::is_same_v<T, double>) return x;
  else return T(static_cast<float>(x));
}

struct GatherArgs {
  const void *val, *col;
  const int* clen;
  const void *lb, *ub;
  const bool* active;
  void* mf;
  int* mc;
  void* xf;
  int* xc;
  int64_t n_chunks;
  int k, max_len;
  int64_t bsz, n_pad;
  double inf;
};

struct ScatterArgs {
  const void *val, *col, *ii;
  const int* clen;
  const void* rmf;
  const int* rmc;
  const void* rxf;
  const int* rxc;
  const void *lhs, *rhs, *lb, *ub;
  const bool* active;
  void *best_l, *best_u;
  int64_t n_chunks;
  int k, max_len;
  int64_t bsz, n_pad;
  double int_eps, inf;
};

template <typename T, typename C>
int gather_parent(const GatherArgs& a, cudaStream_t stream) {
  const T *val = static_cast<const T*>(a.val), *lb = static_cast<const T*>(a.lb),
          *ub = static_cast<const T*>(a.ub);
  const C* col = static_cast<const C*>(a.col);
  T *mf = static_cast<T*>(a.mf), *xf = static_cast<T*>(a.xf);
  const unsigned int blocks = chunk_blocks(a.n_chunks, a.k);
#define PARENT_GATHER(G)                                                                         \
  launch_blocks<parent_gather_kernel<G, T, C>>(blocks, stream, val, col, a.clen, lb, ub,         \
                                               a.active, mf, a.mc, xf, a.xc, a.n_chunks, a.k,    \
                                               a.bsz, a.n_pad, scalar<T>(a.inf))
  switch (group_width(a.k)) {
    case 1: return PARENT_GATHER(1);
    case 2: return PARENT_GATHER(2);
    case 4: return PARENT_GATHER(4);
    case 8: return PARENT_GATHER(8);
    case 16: return PARENT_GATHER(16);
    default: return PARENT_GATHER(32);
  }
#undef PARENT_GATHER
}

template <typename T, typename C, typename M>
int scatter_parent(const ScatterArgs& a, cudaStream_t stream) {
  using P = typename Num<T>::Plane;
  const T *val = static_cast<const T*>(a.val), *rmf = static_cast<const T*>(a.rmf),
          *rxf = static_cast<const T*>(a.rxf), *lhs = static_cast<const T*>(a.lhs),
          *rhs = static_cast<const T*>(a.rhs), *lb = static_cast<const T*>(a.lb),
          *ub = static_cast<const T*>(a.ub);
  const C* col = static_cast<const C*>(a.col);
  const M* ii = static_cast<const M*>(a.ii);
  P *best_l = static_cast<P*>(a.best_l), *best_u = static_cast<P*>(a.best_u);
  const unsigned int blocks = chunk_blocks(a.n_chunks, a.k);
#define PARENT_SCATTER(G)                                                                       \
  launch_blocks<parent_scatter_kernel<G, T, C, M>>(                                             \
      blocks, stream, val, col, ii, a.clen, rmf, a.rmc, rxf, a.rxc, lhs, rhs, lb, ub, a.active, \
      best_l, best_u, a.n_chunks, a.k, a.bsz, a.n_pad, scalar<T>(a.int_eps), scalar<T>(a.inf))
  switch (group_width(a.k)) {
    case 1: return PARENT_SCATTER(1);
    case 2: return PARENT_SCATTER(2);
    case 4: return PARENT_SCATTER(4);
    case 8: return PARENT_SCATTER(8);
    case 16: return PARENT_SCATTER(16);
    default: return PARENT_SCATTER(32);
  }
#undef PARENT_SCATTER
}

// The port's kernels at group size Q, float64.
template <int Q>
int gather_groups(const GatherArgs& a, cudaStream_t stream) {
  return launch_node_activities_gather<double, int, Q>(
      static_cast<const double*>(a.val), static_cast<const int*>(a.col), a.clen,
      static_cast<const double*>(a.lb), static_cast<const double*>(a.ub), a.active,
      static_cast<double*>(a.mf), a.mc, static_cast<double*>(a.xf), a.xc, a.n_chunks, a.k,
      a.max_len, a.bsz, a.n_pad, a.inf, stream);
}

template <int Q>
int scatter_groups(const ScatterArgs& a, cudaStream_t stream) {
  return launch_node_candidates_scatter<double, int, int, Q>(
      static_cast<const double*>(a.val), static_cast<const int*>(a.col),
      static_cast<const int*>(a.ii), a.clen, static_cast<const double*>(a.rmf), a.rmc,
      static_cast<const double*>(a.rxf), a.rxc, static_cast<const double*>(a.lhs),
      static_cast<const double*>(a.rhs), static_cast<const double*>(a.lb),
      static_cast<const double*>(a.ub), a.active, static_cast<double*>(a.best_l),
      static_cast<double*>(a.best_u), a.n_chunks, a.k, a.max_len, a.bsz, a.n_pad, a.int_eps,
      a.inf, stream);
}

// The port's lane-group kernels at every width (G lanes a chunk, short
// chunks too), float64.
int gather_lanes(const GatherArgs& a, cudaStream_t stream) {
  const int g = a.max_len < a.k ? a.max_len : a.k;
  const int64_t most = chunk_blocks(a.n_chunks, g);
  const double *val = static_cast<const double*>(a.val), *lb = static_cast<const double*>(a.lb),
               *ub = static_cast<const double*>(a.ub);
  const int* col = static_cast<const int*>(a.col);
  double *mf = static_cast<double*>(a.mf), *xf = static_cast<double*>(a.xf);
#define LANES(G, U)                                                                            \
  launch_walk<node_activities_gather_kernel<G, U, double, int>>(                               \
      most, a.bsz, stream, val, col, a.clen, lb, ub, a.active, mf, a.mc, xf, a.xc, a.n_chunks, \
      a.k, a.bsz, a.n_pad, a.inf)
  DISPATCH_HELD(LANES, g, held_strides(a.max_len))
#undef LANES
}

int scatter_lanes(const ScatterArgs& a, cudaStream_t stream) {
  const int g = a.max_len < a.k ? a.max_len : a.k;
  const int64_t most = chunk_blocks(a.n_chunks, g);
  const double *val = static_cast<const double*>(a.val), *rmf = static_cast<const double*>(a.rmf),
               *rxf = static_cast<const double*>(a.rxf), *lhs = static_cast<const double*>(a.lhs),
               *rhs = static_cast<const double*>(a.rhs), *lb = static_cast<const double*>(a.lb),
               *ub = static_cast<const double*>(a.ub);
  const int *col = static_cast<const int*>(a.col), *ii = static_cast<const int*>(a.ii);
  double *best_l = static_cast<double*>(a.best_l), *best_u = static_cast<double*>(a.best_u);
#define LANES(G, U)                                                                             \
  launch_walk<node_candidates_scatter_kernel<G, U, double, int, int>>(                          \
      most, a.bsz, stream, val, col, ii, a.clen, rmf, a.rmc, rxf, a.rxc, lhs, rhs, lb, ub,      \
      a.active, best_l, best_u, a.n_chunks, a.k, a.bsz, a.n_pad, a.int_eps, a.inf)
  DISPATCH_HELD(LANES, g, held_strides(a.max_len))
#undef LANES
}

}  // namespace

extern "C" {

// form: 0 float64, 1 float32, 2 float32 compact ids, 3 bfloat16, 4 bfloat16
// compact ids, 5 float16 (variant 0 only; the others run at float64).
int node_gather_variant(int v, int form, const void* val, const void* col, const int* clen,
                        const void* lb, const void* ub, const bool* active, void* mf, int* mc,
                        void* xf, int* xc, int64_t n_chunks, int k, int max_len, int64_t bsz,
                        int64_t n_pad, double inf, cudaStream_t stream) {
  const GatherArgs a{val, col, clen, lb, ub, active, mf, mc, xf, xc, n_chunks, k, max_len,
                     bsz, n_pad, inf};
  if (v != 0 && form != 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (v) {
    case 0:
      switch (form) {
        case 0: return gather_parent<double, int>(a, stream);
        case 1: return gather_parent<float, int>(a, stream);
        case 2: return gather_parent<float, int16_t>(a, stream);
        case 3: return gather_parent<Bf16, int>(a, stream);
        case 4: return gather_parent<Bf16, int16_t>(a, stream);
        case 5: return gather_parent<F16, int>(a, stream);
        default: return static_cast<int>(cudaErrorInvalidValue);
      }
    case 1: return gather_groups<1>(a, stream);
    case 2: return gather_groups<2>(a, stream);
    case 4: return gather_groups<4>(a, stream);
    case 8: return gather_groups<8>(a, stream);
    case 11: return gather_lanes(a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int node_scatter_variant(int v, int form, const void* val, const void* col, const void* ii,
                         const int* clen, const void* rmf, const int* rmc, const void* rxf,
                         const int* rxc, const void* lhs, const void* rhs, const void* lb,
                         const void* ub, const bool* active, void* best_l, void* best_u,
                         int64_t n_chunks, int k, int max_len, int64_t bsz, int64_t n_pad,
                         double int_eps, double inf, cudaStream_t stream) {
  const ScatterArgs a{val, col, ii, clen, rmf, rmc, rxf, rxc, lhs, rhs, lb, ub, active,
                      best_l, best_u, n_chunks, k, max_len, bsz, n_pad, int_eps, inf};
  if (v != 0 && form != 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (v) {
    case 0:
      switch (form) {
        case 0: return scatter_parent<double, int, int>(a, stream);
        case 1: return scatter_parent<float, int, int>(a, stream);
        case 2: return scatter_parent<float, int16_t, int8_t>(a, stream);
        case 3: return scatter_parent<Bf16, int, int>(a, stream);
        case 4: return scatter_parent<Bf16, int16_t, int8_t>(a, stream);
        case 5: return scatter_parent<F16, int, int>(a, stream);
        default: return static_cast<int>(cudaErrorInvalidValue);
      }
    case 1: return scatter_groups<1>(a, stream);
    case 2: return scatter_groups<2>(a, stream);
    case 4: return scatter_groups<4>(a, stream);
    case 8: return scatter_groups<8>(a, stream);
    case 11: return scatter_lanes(a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

#ifndef NODE_ROUND_ONLY

int node_variant(int v, const double* val, const int* col, const int* ii, const int* clen,
                 const double* lhs, const double* rhs, const double* lb, const double* ub,
                 const bool* active, double* best_l, double* best_u, int64_t n_chunks, int k,
                 int64_t bsz, int64_t n_pad, double int_eps, double inf, cudaStream_t stream) {
  switch (group_width(k)) {
    case 8:
      return node_variant_g<8>(v, val, col, ii, clen, lhs, rhs, lb, ub, active, best_l, best_u,
                               n_chunks, k, bsz, n_pad, int_eps, inf, stream);
    case 32:
      return node_variant_g<32>(v, val, col, ii, clen, lhs, rhs, lb, ub, active, best_l,
                                best_u, n_chunks, k, bsz, n_pad, int_eps, inf, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int slab_variant(int v, const double* val, const int* col, const int* ii, const int* clen,
                 const int* done, const double* smf, const int* smc, const double* sxf,
                 const int* sxc, const double* lhs, const double* rhs, const int* run_start,
                 const int* run_inst, const int* run_slab, const int* tile_inst,
                 const int* tile_slab, const bool* active, const double* lb, const double* ub,
                 double* best_l, double* best_u, int n_runs, int64_t n_chunks, int r, int k,
                 int64_t width, int64_t slab, double int_eps, double inf, cudaStream_t stream) {
  const Slab s{val, smf, sxf, lhs, rhs, lb, ub, col, ii, clen, done, smc, sxc, run_start,
               run_inst, run_slab, tile_inst, tile_slab, active, best_l, best_u, n_runs, r, k,
               n_chunks, width, slab, int_eps, inf};
  switch (group_width(k)) {
    case 8: return slab_variant_g<8>(v, s, stream);
    case 32: return slab_variant_g<32>(v, s, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int batched_variant(int v, const double* val, const int* col, const int* ii, const int* clen,
                    const double* lhs, const double* rhs, const double* lb, const double* ub,
                    const int* tile_inst, const int64_t* start, const bool* active,
                    double* best_l, double* best_u, int64_t n_chunks, int r, int k,
                    int max_len, int64_t bsz, int64_t n_pad, double int_eps, double inf,
                    cudaStream_t stream) {
  const Batched s{val, lhs, rhs, lb, ub, col, ii, clen, tile_inst, start, active, best_l,
                  best_u, n_chunks, bsz, n_pad, r, k, int_eps, inf};
  switch (group_width(k)) {
    case 8: return batched_variant_gu<8, 1>(v, s, stream);
    case 32: {
      const int held = held_strides(max_len);
      return held == 1 ? batched_variant_gu<32, 1>(v, s, stream)
             : held == 2 ? batched_variant_gu<32, 2>(v, s, stream)
                         : batched_variant_gu<32, 4>(v, s, stream);
    }
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int node_slab_variant(int v, const double* val, const int* col, const int* ii, const int* clen,
                      const int* done, const double* smf, const int* smc, const double* sxf,
                      const int* sxc, const double* lhs, const double* rhs,
                      const int* run_start, const int* run_slab, const int* tile_slab,
                      const bool* active, const double* lb, const double* ub, double* best_l,
                      double* best_u, int n_runs, int64_t n_chunks, int r, int k, int max_len,
                      int64_t bsz, int64_t width, int64_t slab, double int_eps, double inf,
                      cudaStream_t stream) {
  const Slab s{val, smf, sxf, lhs, rhs, lb, ub, col, ii, clen, done, smc, sxc, run_start,
               nullptr, run_slab, nullptr, tile_slab, active, best_l, best_u, n_runs, r, k,
               n_chunks, width, slab, int_eps, inf, bsz};
  switch (group_width(k)) {
    case 8: return node_slab_variant_gu<8, 1>(v, s, stream);
    case 32: {
      const int held = held_strides(max_len);
      return held == 1 ? node_slab_variant_gu<32, 1>(v, s, stream)
             : held == 2 ? node_slab_variant_gu<32, 2>(v, s, stream)
                         : node_slab_variant_gu<32, 4>(v, s, stream);
    }
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// #13 over one straddle sub-stream: v 0 keeps K's group width, the others
// take the longest copy's.
int partials_variant(int v, const double* val, const int* col, const int* clen,
                     const int* run_start, const int* run_slab, const int* tile_slab,
                     const bool* active, const double* lb, const double* ub, double* mf,
                     int* mc, double* xf, int* xc, int n_runs, int64_t n_chunks, int r, int k,
                     int max_len, int64_t bsz, int64_t width, int64_t slab, double inf,
                     cudaStream_t stream) {
  const Partials s{val, lb, ub, col, clen, run_start, run_slab, tile_slab, active, mf, xf, mc,
                   xc, n_runs, r, k, n_chunks, bsz, width, slab, inf};
  if (v == 0) {
    const unsigned int blocks = chunk_blocks(n_chunks, k);
    switch (group_width(k)) {
      case 8: return launch_blocks<partials_ballot<8>>(blocks, stream, s);
      case 32: return launch_blocks<partials_ballot<32>>(blocks, stream, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
#define PARTIALS(G, U) partials_variant_gu<G, U>(v, s, stream)
  DISPATCH_HELD(PARTIALS, max_len < k ? max_len : k, held_strides(max_len))
#undef PARTIALS
}

// D over one instance's chunk stream: v 0-3 keep the parent's group of
// group_width(K) lanes, v 4-6 take group_width(longest chunk), v 7 K's
// again; every variant holds held_strides(max_len) strides.
int fused_variant(int v, const double* val, const int* col, const int* ii, const int* clen,
                  const double* lhs, const double* rhs, const double* lb, const double* ub,
                  double* best_l, double* best_u, int64_t n_chunks, int k, int max_len,
                  double int_eps, double inf, cudaStream_t stream) {
  const Fused s{val, lhs, rhs, lb, ub, col, ii, clen, best_l, best_u, n_chunks, k, int_eps, inf};
  const int held = held_strides(max_len);
  const bool packed = v >= 4 && v <= 6;
  switch (group_width(packed && max_len < k ? max_len : k)) {
    case 8: return fused_variant_g<8>(v, s, held, stream);
    case 16: return fused_variant_g<16>(v, s, held, stream);
    case 32: return fused_variant_g<32>(v, s, held, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// v 0/1: #9 over (B, width) planes (one window a row), without / with the
// hand-back; v 2/3: #15 (windows of `slab` columns), the same; v 4/5: #9 on
// the walk, a flag store per thread / per warp; v 6-8: the walk, 2, 4, 8
// column blocks an item; v 9: the (column block, group of 32 rows) grid;
// v 10: #15 on the walk, one column a thread; v 11 / 12: #15 on the port's
// merge body (four columns a thread), walk / grid; v 13 / 14: #9 on it,
// grid / walk, `flags` then holding one bool per row; v 15 / 16: #15 / #9
// on its grid, one column a thread.
int merge_variant(int v, double* lb, double* ub, double* best_l, double* best_u,
                  const bool* active, int* flags, int64_t bsz, int64_t width, int64_t slab,
                  double eps, double inf, double outward, cudaStream_t stream) {
  const int64_t n_slabs = (width + slab - 1) / slab;
  const WindowFlags win_flags{flags, n_slabs, slab};
  const RowFlags rows{reinterpret_cast<bool*>(flags)};
  switch (v) {
    case 11:
      return launch_merge_walk(lb, ub, best_l, best_u, active, win_flags, bsz, width, eps, inf,
                               outward, stream);
    case 12:
      return launch_merge_grid<WindowFlags, 4>(lb, ub, best_l, best_u, active, win_flags, bsz,
                                               width, eps, inf, outward, stream);
    case 13:
      return launch_merge_grid<RowFlags, 4>(lb, ub, best_l, best_u, active, rows, bsz, width,
                                            eps, inf, outward, stream);
    case 15:
      return launch_merge_grid<WindowFlags, 1>(lb, ub, best_l, best_u, active, win_flags, bsz,
                                               width, eps, inf, outward, stream);
    case 16:
      return launch_merge_grid<RowFlags, 1>(lb, ub, best_l, best_u, active, rows, bsz, width,
                                            eps, inf, outward, stream);
    case 14:
      return launch_merge_walk(lb, ub, best_l, best_u, active, rows, bsz, width, eps, inf,
                               outward, stream);
    default: break;
  }
  if (v >= 4) {
    const int64_t most = (width + kThreads - 1) / kThreads * bsz;
#define WALK(ANY, V)                                                                     \
  launch_walk<merge_walk<ANY, V>>(most, bsz, stream, lb, ub, best_l, best_u, active, flags, \
                                  bsz, width, eps, inf, outward, slab, n_slabs)
    switch (v) {
      case 4: return WALK(false, 1);
      case 5: return WALK(true, 1);
      case 6: return WALK(true, 2);
      case 7: return WALK(true, 4);
      case 8: return WALK(true, 8);
      case 10:
        return launch_walk<merge_walk<true, 1, true>>(most, bsz, stream, lb, ub, best_l, best_u,
                                                      active, flags, bsz, width, eps, inf,
                                                      outward, slab, n_slabs);
      case 9: {
        const dim3 grid(static_cast<unsigned int>((width + kThreads - 1) / kThreads),
                        static_cast<unsigned int>((bsz + kWarp - 1) / kWarp));
        merge_groups<<<grid, kThreads, 0, stream>>>(lb, ub, best_l, best_u, active, flags, bsz,
                                                    width, eps, inf, outward);
        return static_cast<int>(cudaGetLastError());
      }
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef WALK
  }
  const int64_t s = v < 2 ? width : slab;
  const int64_t windows = (width + s - 1) / s;
  const dim3 grid(static_cast<unsigned int>((width + kThreads - 1) / kThreads),
                  static_cast<unsigned int>(bsz));
  if (v % 2 == 0)
    merge_batch<false><<<grid, kThreads, 0, stream>>>(lb, ub, best_l, best_u, active, flags,
                                                      width, s, windows, eps, inf, outward);
  else
    merge_batch<true><<<grid, kThreads, 0, stream>>>(lb, ub, best_l, best_u, active, flags,
                                                     width, s, windows, eps, inf, outward);
  return static_cast<int>(cudaGetLastError());
}

#endif  // NODE_ROUND_ONLY

}  // extern "C"
