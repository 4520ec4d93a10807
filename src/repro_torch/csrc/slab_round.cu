// Hopper (sm_90a) kernels of the column-slab partitioned round, the engine
// of instances past 2^16 columns (kernels/ops.py, _partitioned_round).
//
// Each is the CUDA counterpart of a Pallas kernel of the JAX package
// (src/repro/kernels/prop_round.py), held against a plain-PyTorch oracle
// (src/repro_torch/kernels/ref.py):
//
//   slab_partials       (#11) per-copy activity partials of the straddle
//                       sub-stream, each copy gathering from its run's
//                       (instance, slab) window; the copies of inactive
//                       instances write zeros
//   node_slab_partials  (#13) #11 per node of one instance, the (B,) mask
//                       balloted on the device, node-major on the
//                       active-only walk; inactive nodes' rows are not
//                       written
//   slab_scatter        the first launch of #12: per copy, the local row
//                       aggregates or, where row_done == 0, the straddle
//                       row's completed aggregates; candidates; the column
//                       max/min into (B, W) accumulator planes
//   node_slab_scatter   the first launch of #14: the same per active node,
//                       node-major
//   slab_merge          (#15, and the second launch of #12 and #14)
//                       bounds.apply_updates over the active rows'
//                       (instance, slab) windows, in place, on the merge
//                       body #9 runs (round_common.cuh: the walk, or a
//                       grid for a few rows), one flag per window (for
//                       a single instance, its loop carry's flag, as F's);
//                       each accumulator entry it reads goes back to the
//                       sentinel
//
// The TPU kernels walk a run's copy tiles in grid order, keep the window's
// accumulators in VMEM and merge at the run's last step.  Blocks of one run
// run concurrently here, so a round is two launches: the scatter into
// accumulator planes in global memory, then the window merge, once every
// copy has scattered.  Every gather of the round has finished by then, so
// the merge runs in place.  An empty window's all-padding tile scatters
// nothing and its merge changes nothing.  The planes of #12 and #14 are
// kept by the engine's round closure for a whole fixed point: filled with
// the sentinel once, scattered into by 64-bit integer atomics (exact in
// any order), and set back to the sentinel by the merge that reads them
// (merge_item's hand-back).
//
// The scatters of #12 and #14 and the partials of #13 find a copy tile's
// window from tile_inst / tile_slab (#13: a_tile_slab), hoisted by the
// partition, at inst * W + slab_id * slab of the (B, W) planes (#13, #14:
// node * W + slab_id * slab); #11 finds the tile's run by a binary search
// over run_start (runs cover contiguous, ascending tile ranges; the TPU's
// padded grid steps do not exist here).
// W is the partition's n_pad_part or the instance's n_pad: no real nonzero
// reaches past n_pad.  Flat indices are 64-bit wherever two sizes multiply
// (B * W passes 2^31 at large pools).
//
// The chunk arithmetic is kernel D's (round_common.cuh): lane groups of G
// lanes per chunk, shuffle sums in ref.warp_order_sum's order, division-first
// candidates, --fmad=false.  The scatters of #12 and #14 run chunk_round:
// each nonzero's bounds gathered once and held from the sums to the
// candidates, each copy stopped at its hoisted length (the partition's
// chunk_len); #13 sums by its first half, chunk_sums, each straddle copy
// stopped at a_chunk_len; #13, #14 and #15 walk the active planes' items
// only (round_common.cuh).
// #11 and #12 take a single instance's loop carry's `go` (null in a batch):
// on a clear one (a round enqueued after its fixed point converged) every
// block returns before it reads a tile, as D's do, and #15 merges nothing.
// Each entry point returns cudaGetLastError().

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

__device__ __forceinline__ void store_partials(const RowAgg& a, int64_t o, double* mf, int* mc,
                                               double* xf, int* xc) {
  mf[o] = a.mf;
  mc[o] = a.mc;
  xf[o] = a.xf;
  xc[o] = a.xc;
}

template <int G>
__global__ void __launch_bounds__(kThreads)
slab_partials_kernel(const double* __restrict__ val, const int* __restrict__ col,
                     const int* __restrict__ run_start, const int* __restrict__ run_inst,
                     const int* __restrict__ run_slab, const bool* __restrict__ active,
                     const double* __restrict__ lb, const double* __restrict__ ub,
                     double* __restrict__ mf, int* __restrict__ mc, double* __restrict__ xf,
                     int* __restrict__ xc, const bool* __restrict__ go, int n_runs,
                     int64_t n_chunks, int r, int k, int64_t width, int64_t slab, double inf) {
  if (skip_round(go)) return;
  const Lanes L = lanes_for<G>(n_chunks);
  const Copy c = copy_window(L, r, run_start, run_inst, run_slab, n_runs, width, slab);
  const bool act = L.live && active[c.inst];
  // An inactive instance's copies sum nothing: their partials are zeros.
  const RowAgg a =
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
template <int G, int U>
__global__ void __launch_bounds__(kThreads)
node_slab_partials_kernel(const double* __restrict__ val, const int* __restrict__ col,
                          const int* __restrict__ clen, const int* __restrict__ tile_slab,
                          const bool* __restrict__ active, const double* __restrict__ lb,
                          const double* __restrict__ ub, double* __restrict__ mf,
                          int* __restrict__ mc, double* __restrict__ xf, int* __restrict__ xc,
                          int64_t n_chunks, int r, int k, int64_t bsz, int64_t width,
                          int64_t slab, double inf) {
  const EqualItems items_of{(n_chunks + block_chunks<G>() - 1) / block_chunks<G>()};
  const Walk walk = ballot_walk(active, bsz, items_of);
  WalkCursor cur;
  for (int64_t item = blockIdx.x; item < walk.items; item += gridDim.x) {
    cur.seek(item, walk, items_of);
    const WalkLanes L = walk_lanes<G>(item, cur, items_of, n_chunks);
    const int64_t c = L.chunk;
    const int64_t off =
        L.live ? cur.plane * width + static_cast<int64_t>(tile_slab[c / r]) * slab : 0;
    Loaded<U> first;
    double l[U], h[U];
    const RowAgg a = chunk_sums<G, U>(first, l, h, val, col, nullptr,
                                      SplitBounds{lb + off, ub + off}, c * k, L.live ? k : 0,
                                      L.live ? clen[c] : 0, true, L.sl, inf);
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
template <int G, int U>
__global__ void __launch_bounds__(kThreads)
slab_scatter_kernel(const double* __restrict__ val, const int* __restrict__ col,
                    const int* __restrict__ ii, const int* __restrict__ clen,
                    const int* __restrict__ done, const double* __restrict__ smf,
                    const int* __restrict__ smc, const double* __restrict__ sxf,
                    const int* __restrict__ sxc, const double* __restrict__ lhs,
                    const double* __restrict__ rhs, const int* __restrict__ tile_inst,
                    const int* __restrict__ tile_slab, const bool* __restrict__ active,
                    const double* __restrict__ lb, const double* __restrict__ ub,
                    double* best_l, double* best_u, const bool* __restrict__ go,
                    int64_t n_chunks, int r, int k, int64_t width, int64_t slab,
                    double int_eps, double inf) {
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
  const RowAgg given = use && !local ? RowAgg{smf[c], sxf[c], smc[c], sxc[c]} : RowAgg{};
  chunk_round<G, U>(val, col, ii, SplitBounds{lb + off, ub + off}, c * k, use ? k : 0,
                    use ? clen[c] : 0, local, given, use ? lhs[c] : 0.0, use ? rhs[c] : 0.0,
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
template <int G, int U>
__global__ void __launch_bounds__(kThreads, U == 1 ? 4 : 1)
node_slab_scatter_kernel(const double* __restrict__ val, const int* __restrict__ col,
                         const int* __restrict__ ii, const int* __restrict__ clen,
                         const int* __restrict__ done, const double* __restrict__ smf,
                         const int* __restrict__ smc, const double* __restrict__ sxf,
                         const int* __restrict__ sxc, const double* __restrict__ lhs,
                         const double* __restrict__ rhs, const int* __restrict__ tile_slab,
                         const bool* __restrict__ active, const double* __restrict__ lb,
                         const double* __restrict__ ub, double* best_l, double* best_u,
                         int64_t n_chunks, int r, int k, int64_t bsz, int64_t width,
                         int64_t slab, double int_eps, double inf) {
  const EqualItems items_of{(n_chunks + block_chunks<G>() - 1) / block_chunks<G>()};
  const Walk walk = ballot_walk(active, bsz, items_of);
  WalkCursor cur;
  for (int64_t item = blockIdx.x; item < walk.items; item += gridDim.x) {
    cur.seek(item, walk, items_of);
    const WalkLanes L = walk_lanes<G>(item, cur, items_of, n_chunks);
    const int64_t c = L.chunk;
    int64_t off = 0;
    bool local = false;
    RowAgg given{};
    if (L.live) {
      off = cur.plane * width + static_cast<int64_t>(tile_slab[c / r]) * slab;
      local = done[c] != 0;
      if (!local) {
        const int64_t s = cur.plane * n_chunks + c;
        given = RowAgg{smf[s], sxf[s], smc[s], sxc[s]};
      }
    }
    chunk_round<G, U>(val, col, ii, SplitBounds{lb + off, ub + off}, c * k, L.live ? k : 0,
                      L.live ? clen[c] : 0, local, given, L.live ? lhs[c] : 0.0,
                      L.live ? rhs[c] : 0.0, best_l + off, best_u + off, L.sl, int_eps, inf);
  }
}

}  // namespace

extern "C" {

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

int slab_partials(const double* val, const int* col, const int* run_start, const int* run_inst,
                  const int* run_slab, const bool* active, const double* lb, const double* ub,
                  double* mf, int* mc, double* xf, int* xc, const bool* go, int n_runs,
                  int64_t n_chunks, int r, int k, int64_t width, int64_t slab, double inf,
                  cudaStream_t stream) {
  LAUNCH_FOR_WIDTH(slab_partials_kernel, k, n_chunks, stream, val, col, run_start, run_inst,
                   run_slab, active, lb, ub, mf, mc, xf, xc, go, n_runs, n_chunks, r, k, width,
                   slab, inf);
  return static_cast<int>(cudaGetLastError());
}

int node_slab_partials(const double* val, const int* col, const int* clen, const int* tile_slab,
                       const bool* active, const double* lb, const double* ub, double* mf,
                       int* mc, double* xf, int* xc, int64_t n_chunks, int r, int k,
                       int max_len, int64_t bsz, int64_t width, int64_t slab, double inf,
                       cudaStream_t stream) {
  // The group width of the longest straddle copy (at most K's); at most
  // one pass over the sub-stream.
  const int g = max_len < k ? max_len : k;
  const int64_t most = chunk_blocks(n_chunks, g);
#define NODE_PARTIALS(G, U)                                                                 \
  launch_walk<node_slab_partials_kernel<G, U>>(most, bsz, stream, val, col, clen, tile_slab, \
                                               active, lb, ub, mf, mc, xf, xc, n_chunks, r, \
                                               k, bsz, width, slab, inf)
  DISPATCH_HELD(NODE_PARTIALS, g, held_strides(max_len))
#undef NODE_PARTIALS
}

int slab_scatter(const double* val, const int* col, const int* ii, const int* clen,
                 const int* done, const double* smf, const int* smc, const double* sxf,
                 const int* sxc, const double* lhs, const double* rhs, const int* tile_inst,
                 const int* tile_slab, const bool* active, const double* lb, const double* ub,
                 double* best_l, double* best_u, const bool* go, int64_t n_chunks, int r, int k,
                 int max_len, int64_t width, int64_t slab, double int_eps, double inf,
                 cudaStream_t stream) {
  const unsigned int blocks = chunk_blocks(n_chunks, k);
#define SLAB_SCATTER(G, U)                                                                  \
  (slab_scatter_kernel<G, U><<<blocks, kThreads, 0, stream>>>(                              \
       val, col, ii, clen, done, smf, smc, sxf, sxc, lhs, rhs, tile_inst, tile_slab, active, \
       lb, ub, best_l, best_u, go, n_chunks, r, k, width, slab, int_eps, inf),              \
   static_cast<int>(cudaGetLastError()))
  DISPATCH_HELD(SLAB_SCATTER, k, held_strides(max_len))
#undef SLAB_SCATTER
}

int node_slab_scatter(const double* val, const int* col, const int* ii, const int* clen,
                      const int* done, const double* smf, const int* smc, const double* sxf,
                      const int* sxc, const double* lhs, const double* rhs,
                      const int* tile_slab, const bool* active, const double* lb,
                      const double* ub, double* best_l, double* best_u, int64_t n_chunks,
                      int r, int k, int max_len, int64_t bsz, int64_t width, int64_t slab,
                      double int_eps, double inf, cudaStream_t stream) {
  // At most one pass over the copy stream.
  const int64_t most = chunk_blocks(n_chunks, k);
#define NODE_SLAB(G, U)                                                                      \
  launch_walk<node_slab_scatter_kernel<G, U>>(most, bsz, stream, val, col, ii, clen, done, \
                                              smf, smc, sxf, sxc, lhs, rhs, tile_slab,     \
                                              active, lb, ub, best_l, best_u, n_chunks, r, \
                                              k, bsz, width, slab, int_eps, inf)
  DISPATCH_HELD(NODE_SLAB, k, held_strides(max_len))
#undef NODE_SLAB
}

int slab_merge(double* lb, double* ub, double* best_l, double* best_u, const bool* active,
               int* flags, int* clear, int* carry, int64_t bsz, int64_t width, int64_t slab,
               int k, int unroll, double eps, double inf, double outward, cudaStream_t stream) {
  // A warp's 32 columns of one stride must lie in one window.
  if (slab <= 0 || slab % kWarp != 0) return static_cast<int>(cudaErrorInvalidValue);
  // One instance's fixed point: the flag folded into its loop carry (the
  // mask is the carry's go, so a converged instance's blocks return at
  // once, as an inactive one's do).
  if (carry != nullptr) {
    if (bsz != 1) return static_cast<int>(cudaErrorInvalidValue);
    return launch_merge_grid<CarryFlags, WindowFlags::kGridCols>(
        lb, ub, best_l, best_u, active, CarryFlags{carry, k, unroll}, 1, width, eps, inf,
        outward, stream);
  }
  // Else one flag per window into `flags`, the pair's other buffer zeroed.
  const int64_t n_slabs = (width + slab - 1) / slab;
  return launch_merge(lb, ub, best_l, best_u, active,
                      WindowFlags{flags, n_slabs, slab, clear, bsz * n_slabs}, bsz, width, eps,
                      inf, outward, stream);
}

}  // extern "C"
