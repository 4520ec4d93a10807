// Hopper (sm_90a) kernels of the fused propagation round (paper Alg. 3), of
// its node-batch and packed-batch forms, of the segment (seed) round and of
// the solver's node objective.
//
// Each kernel but the two combines is the CUDA counterpart of one Pallas
// kernel of the JAX package (src/repro/kernels/prop_round.py); every kernel
// is held against a plain-PyTorch oracle (src/repro_torch/kernels/ref.py):
//
//   fused_scatter_round  (D)  bound gather, row activities with infinity
//                             counters, candidates, integrality rounding and
//                             the column max/min, for rows that fit one chunk
//   activities_gather    (A') per-chunk activity partials, for rows that
//                             span chunks
//   candidates_scatter   (E)  candidates from completed row aggregates, then
//                             the column max/min (64-bit integer atomics)
//   apply_updates        (F)  the bound merge, in place, on the merges' body
//                             over one plane; its flag folded into the
//                             fixed point's loop carry on the device
//   combine_chunk_partials    the long-row combine of A' partials, left to
//                             right over each row's chunks (not a TPU
//                             kernel: the reference's XLA segment_sum); a
//                             thread per short row, a warp per long row
//   straddle_combine          the partitioned round's straddle combine: the
//                             copy partials of each straddle row summed left
//                             to right into a compact table, then spread to
//                             the main stream's chunks, active planes only
//                             (the reference's XLA segment_sum again)
//   node_fused_scatter_round  (#10) D over a node batch: one matrix, B bound
//                             planes, an active mask read on the device;
//                             node-major, into accumulator planes kept for
//                             the whole fixed point
//   batched_fused_scatter_round  (#8) D over a packed batch: instance-major
//                             over the active instances' chunk ranges, each
//                             into its own row of the (B, n_pad) planes kept
//                             for the whole fixed point; converged instances
//                             and free slots launch no warp
//   apply_updates_batch  (#9) F over (B, n_pad) planes with an active mask
//                             and a changed flag per row; hands the
//                             accumulator rows it reads back at the
//                             sentinel; active rows only, on the merge
//                             body it shares with #15 (round_common.cuh):
//                             the walk, or a grid for a few rows
//   node_objective       (#16) per node: objective bound, all-fixed and
//                             crossed flags, by a block reduction
//   activities           (A)  A' on bounds gathered before the launch: each
//                             slot's bounds read at the slot of (T, R, K)
//                             tiles (the segment round, rows spanning chunks)
//   candidates           (B)  E's candidates from completed row aggregates
//                             and pre-gathered bounds, stored per slot
//                             instead of scattered
//   fused_round          (C)  A and B in one pass for rows that fit one
//                             chunk: D on pre-gathered bounds, candidates
//                             stored per slot
//   node_activities_gather, node_combine_chunk_partials,
//   node_candidates_scatter   A', the combine and E over a node batch (one
//                             matrix, B bound planes, an active mask read on
//                             the device): the multi-chunk node round.  No
//                             Pallas twin: the reference vmaps its jnp round
//                             there (src/repro/kernels/ops.py:2031)
//
// Layout: block-ELL tiles (T, R, K) flattened to T*R chunks of K slots.  A
// chunk is owned by a group of G lanes, G = K rounded up to a power of two
// and at most 32 (so a warp holds 32 / G chunks: four at K = 8); each lane
// walks the slots sl, sl + 32, ... (sl < G) so a group's loads of val/col
// are coalesced.  Row sums are reduced by shuffles within the group.  For
// K <= 16 the sum is the same as the one-warp-per-chunk butterfly of
// ref.warp_order_sum: lanes past K hold +0.0, and adding +0.0 to a lane sum
// (never -0.0, since each starts at +0.0) leaves it unchanged.  The group
// width is a template parameter, so the shuffles unroll.  D keys its group
// width on the longest chunk instead of K: chunks of at most 16 slots are
// packed 32 / G to a warp at any K, by the same argument.  The TPU kernels'
// one-hot gather becomes an indexed load (the (n_pad,) bound vectors stay
// in L2), and their one-hot column scatter becomes a double-precision
// max/min by 64-bit integer atomics (red_max / red_min, -0.0
// entering as +0.0, so -0.0 and +0.0 compare equal, as they do in the
// oracle).  Max and min do not depend on order, so the scatter is exact.
// D, A', E, #8 and #10 stop each chunk at its length (one past its last
// nonzero, an (T, R) int32 input hoisted from structure) and issue several
// strides' loads before their bound gathers; D, #8 and #10 gather each
// nonzero's bounds once and hold them from the sums to the candidates
// (chunk_round).  D and E accumulate into (n_pad,) planes that the round
// closure keeps for the whole fixed point, which F hands back at the
// sentinel; #8 and #10 into (B, n_pad) planes kept the same way, which #9
// hands back.
// The device code the chunk kernels share with slab_round.cu (lane groups,
// chunk aggregates, candidates + scatter, chunk_round, the active-only
// walk, the one-column merges) is in round_common.cuh; kernels D, A', E and
// the long-row combine are in single_round.cuh, and #8, #10, the node
// forms of A', the combine and E and #9's launchers in batch_round.cuh,
// templated on the value and index types, which tier_round.cu and
// batch_tier_round.cu instantiate at float32.
//
// Build with --fmad=false: the activity products and the merge's
// old + eps * max(1, |old|) must round like the oracle's separate multiply
// and add.  The candidate chain is division-first and has no multiply
// feeding an add.
//
// Every entry point returns cudaGetLastError() after its launch.

#include "batch_round.cuh"

namespace {

// The straddle combine of the partitioned round, over nb planes of copy
// partials (n_pos = Ta * R per plane), in two launches.  First the compact
// table: one thread per (active plane, table slot s) sums the partials at
// positions a_seg[s] .. a_seg[s + 1] of the slot order a_order left to
// right from 0, into (nb, n_slots) tables (slot 0, the dummy, gets +0.0 and
// 0).  Then the spread: one thread per (active plane, main-stream chunk)
// copies its slot's entry (agg_slot) to the chunk.  Grid (blocks, groups of
// 32 planes); each warp ballots its group's flags (all planes when active
// is null), and inactive planes are neither read nor written.
__global__ void __launch_bounds__(kThreads)
straddle_table_kernel(const double* __restrict__ mf, const int* __restrict__ mc,
                      const double* __restrict__ xf, const int* __restrict__ xc,
                      const int64_t* __restrict__ a_order, const int64_t* __restrict__ a_seg,
                      const bool* __restrict__ active, double* __restrict__ tmf,
                      int* __restrict__ tmc, double* __restrict__ txf, int* __restrict__ txc,
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
    double a = 0.0, c = 0.0;
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

__global__ void __launch_bounds__(kThreads)
straddle_spread_kernel(const double* __restrict__ tmf, const int* __restrict__ tmc,
                       const double* __restrict__ txf, const int* __restrict__ txc,
                       const int* __restrict__ agg_slot, const bool* __restrict__ active,
                       double* __restrict__ omf, int* __restrict__ omc, double* __restrict__ oxf,
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

constexpr int kObjThreads = 1024;

// One block per node: thread t sums the objective contributions of columns
// t, t + 1024, ... from 0.0, each warp reduces by shuffles, then the first
// warp reduces the 32 warp sums (ref.block_order_sum is this order).  The
// three predicates are block-wide OR / AND reductions.
__global__ void __launch_bounds__(kObjThreads)
node_objective_kernel(const double* __restrict__ lb, const double* __restrict__ ub,
                      const double* __restrict__ c, const bool* __restrict__ is_int,
                      const bool* __restrict__ valid, double* __restrict__ obj,
                      bool* __restrict__ fixed, bool* __restrict__ crossed, int64_t n_pad,
                      double feas_eps, double inf) {
  __shared__ double warp_sums[kObjThreads / kWarp];
  const int64_t row = static_cast<int64_t>(blockIdx.x) * n_pad;
  double acc = 0.0;
  int unbounded = 0, loose = 0, cross = 0;
  for (int64_t j = threadIdx.x; j < n_pad; j += kObjThreads) {
    if (!valid[j]) continue;  // invalid columns add 0.0 and flag nothing
    const double cj = c[j], l = lb[row + j], u = ub[row + j];
    if (cj != 0.0) acc += cj > 0.0 ? cj * l : cj * u;
    unbounded |= (cj > 0.0 && l <= -inf) || (cj < 0.0 && u >= inf);
    loose |= is_int[j] && !(u - l <= 0.5);
    cross |= l > u + feas_eps;
  }
  acc = warp_sum(acc);
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  if (lane == 0) warp_sums[warp] = acc;
  unbounded = __syncthreads_or(unbounded);
  loose = __syncthreads_or(loose);
  cross = __syncthreads_or(cross);
  if (warp == 0) {
    const double total = warp_sum(warp_sums[lane]);
    if (lane == 0) {
      obj[blockIdx.x] = unbounded ? -inf : total;
      fixed[blockIdx.x] = !loose;
      crossed[blockIdx.x] = cross != 0;
    }
  }
}

// Kernels A, B and C of the segment (seed) round: the bounds were gathered
// at each slot's column before the launch ((T, R, K) lb_g / ub_g), and B and
// C store both candidates at every slot -- the sentinels at padding -- for
// the column max/min that follows outside.  The arithmetic is D's, A''s and
// E's (round_common.cuh), with SlotBounds in place of ColumnBounds, so the
// same bounds give the same bits.  Each returns at once on a clear `go` (a
// round enqueued after the fixed point converged), as D does: its outputs
// are then not written, and F merges nothing.
template <int G>
__global__ void __launch_bounds__(kThreads)
activities_kernel(const double* __restrict__ val, const double* __restrict__ lb_g,
                  const double* __restrict__ ub_g, double* __restrict__ mf, int* __restrict__ mc,
                  double* __restrict__ xf, int* __restrict__ xc, const bool* __restrict__ go,
                  int64_t n_chunks, int k, double inf) {
  if (skip_round(go)) return;
  const Lanes L = lanes_for<G>(n_chunks);
  const RowAgg a = chunk_aggregates<G>(val, SlotBounds{lb_g, ub_g}, L.chunk * k,
                                       L.live ? k : 0, L, inf);
  if (L.live && L.sl == 0) {
    mf[L.chunk] = a.mf;
    mc[L.chunk] = a.mc;
    xf[L.chunk] = a.xf;
    xc[L.chunk] = a.xc;
  }
}

template <int G>
__global__ void __launch_bounds__(kThreads)
candidates_kernel(const double* __restrict__ val, const double* __restrict__ lb_g,
                  const double* __restrict__ ub_g, const int* __restrict__ ii,
                  const double* __restrict__ rmf, const int* __restrict__ rmc,
                  const double* __restrict__ rxf, const int* __restrict__ rxc,
                  const double* __restrict__ lhs, const double* __restrict__ rhs,
                  double* __restrict__ lcand, double* __restrict__ ucand,
                  const bool* __restrict__ go, int64_t n_chunks, int k, double int_eps,
                  double inf) {
  if (skip_round(go)) return;
  const Lanes L = lanes_for<G>(n_chunks);
  if (!L.live) return;
  const int64_t c = L.chunk;
  const RowAgg a{rmf[c], rxf[c], rmc[c], rxc[c]};
  chunk_candidates_store(val, SlotBounds{lb_g, ub_g}, ii, a, lhs[c], rhs[c], lcand, ucand,
                         c * k, k, L, int_eps, inf);
}

template <int G>
__global__ void __launch_bounds__(kThreads)
fused_round_kernel(const double* __restrict__ val, const double* __restrict__ lb_g,
                   const double* __restrict__ ub_g, const int* __restrict__ ii,
                   const double* __restrict__ lhs, const double* __restrict__ rhs,
                   double* __restrict__ lcand, double* __restrict__ ucand,
                   const bool* __restrict__ go, int64_t n_chunks, int k, double int_eps,
                   double inf) {
  if (skip_round(go)) return;
  const Lanes L = lanes_for<G>(n_chunks);
  const SlotBounds b{lb_g, ub_g};
  const int64_t base = L.chunk * k;
  const RowAgg a = chunk_aggregates<G>(val, b, base, L.live ? k : 0, L, inf);
  if (!L.live) return;
  chunk_candidates_store(val, b, ii, a, lhs[L.chunk], rhs[L.chunk], lcand, ucand, base, k, L,
                         int_eps, inf);
}

}  // namespace

extern "C" {

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

int fused_scatter_round(const double* val, const int* col, const int* ii, const int* clen,
                        const double* lhs, const double* rhs, const double* lb, const double* ub,
                        double* best_l, double* best_u, const bool* go, int64_t n_chunks, int k,
                        int max_len, double int_eps, double inf, cudaStream_t stream) {
  return launch_fused_scatter_round(val, col, ii, clen, lhs, rhs, lb, ub, best_l, best_u, go,
                                    n_chunks, k, max_len, int_eps, inf, stream);
}

int activities_gather(const double* val, const int* col, const int* clen, const double* lub,
                      double* mf, int* mc, double* xf, int* xc, const bool* go, int64_t n_chunks,
                      int k, double inf, cudaStream_t stream) {
  return launch_activities_gather(val, col, clen, lub, mf, mc, xf, xc, go, n_chunks, k, inf,
                                  stream);
}

int candidates_scatter(const double* val, const int* col, const int* ii, const int* clen,
                       const double* rmf, const int* rmc, const double* rxf, const int* rxc,
                       const double* lhs, const double* rhs, const double* lub, double* best_l,
                       double* best_u, const bool* go, int64_t n_chunks, int k, double int_eps,
                       double inf, cudaStream_t stream) {
  return launch_candidates_scatter(val, col, ii, clen, rmf, rmc, rxf, rxc, lhs, rhs, lub, best_l,
                                   best_u, go, n_chunks, k, int_eps, inf, stream);
}

int node_activities_gather(const double* val, const int* col, const int* clen, const double* lb,
                           const double* ub, const bool* active, double* mf, int* mc,
                           double* xf, int* xc, int64_t n_chunks, int k, int64_t bsz,
                           int64_t n_pad, double inf, cudaStream_t stream) {
  return launch_node_activities_gather(val, col, clen, lb, ub, active, mf, mc, xf, xc, n_chunks,
                                       k, bsz, n_pad, inf, stream);
}

int node_candidates_scatter(const double* val, const int* col, const int* ii, const int* clen,
                            const double* rmf, const int* rmc, const double* rxf,
                            const int* rxc, const double* lhs, const double* rhs,
                            const double* lb, const double* ub, const bool* active,
                            double* best_l, double* best_u, int64_t n_chunks, int k,
                            int64_t bsz, int64_t n_pad, double int_eps, double inf,
                            cudaStream_t stream) {
  return launch_node_candidates_scatter(val, col, ii, clen, rmf, rmc, rxf, rxc, lhs, rhs, lb, ub,
                                        active, best_l, best_u, n_chunks, k, bsz, n_pad, int_eps,
                                        inf, stream);
}

int apply_updates(double* lb, double* ub, double* best_l, double* best_u, int* carry, int64_t n,
                  int k, int unroll, double eps, double inf, double outward,
                  cudaStream_t stream) {
  // Kernel F: the merges' body on a grid over one plane, no mask, four
  // columns a thread; its flag folded into the loop carry (CarryFlags).
  return launch_merge_grid<CarryFlags, CarryFlags::kGridCols, false>(
      lb, ub, best_l, best_u, nullptr, CarryFlags{carry, k, unroll}, 1, n, eps, inf, outward,
      stream);
}

int combine_chunk_partials(const double* mf, const int* mc, const double* xf, const int* xc,
                           const int64_t* row_start, const int* short_seg, const int* long_seg,
                           double* omf, int* omc, double* oxf, int* oxc, const bool* go,
                           int64_t n_short, int64_t n_long, cudaStream_t stream) {
  return launch_combine_chunk_partials(mf, mc, xf, xc, row_start, short_seg, long_seg, omf, omc,
                                       oxf, oxc, go, n_short, n_long, stream);
}

int node_combine_chunk_partials(const double* mf, const int* mc, const double* xf,
                                const int* xc, const int64_t* row_start, const int* short_seg,
                                const int* long_seg, const bool* active, double* omf, int* omc,
                                double* oxf, int* oxc, int64_t n_short, int64_t n_long,
                                int64_t n_chunks, int64_t bsz, cudaStream_t stream) {
  return launch_node_combine_chunk_partials(mf, mc, xf, xc, row_start, short_seg, long_seg,
                                            active, omf, omc, oxf, oxc, n_short, n_long,
                                            n_chunks, bsz, stream);
}

int straddle_combine(const double* mf, const int* mc, const double* xf, const int* xc,
                     const int64_t* a_order, const int64_t* a_seg, const int* agg_slot,
                     const bool* active, double* tmf, int* tmc, double* txf, int* txc,
                     double* omf, int* omc, double* oxf, int* oxc, int64_t n_slots,
                     int64_t n_pos, int64_t n_chunks, int64_t nb, cudaStream_t stream) {
  const unsigned int groups = static_cast<unsigned int>((nb + kWarp - 1) / kWarp);
  const dim3 tgrid(static_cast<unsigned int>((n_slots + kThreads - 1) / kThreads), groups);
  straddle_table_kernel<<<tgrid, kThreads, 0, stream>>>(mf, mc, xf, xc, a_order, a_seg, active,
                                                        tmf, tmc, txf, txc, n_slots, n_pos, nb);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_chunks == 0) return static_cast<int>(err);
  const dim3 sgrid(static_cast<unsigned int>((n_chunks + kThreads - 1) / kThreads), groups);
  straddle_spread_kernel<<<sgrid, kThreads, 0, stream>>>(tmf, tmc, txf, txc, agg_slot, active,
                                                         omf, omc, oxf, oxc, n_slots, n_chunks,
                                                         nb);
  return static_cast<int>(cudaGetLastError());
}

int node_fused_scatter_round(const double* val, const int* col, const int* ii, const int* clen,
                             const double* lhs, const double* rhs, const double* lb,
                             const double* ub, const bool* active, double* best_l,
                             double* best_u, int64_t n_chunks, int k, int max_len, int64_t bsz,
                             int64_t n_pad, double int_eps, double inf, cudaStream_t stream) {
  return launch_node_fused_scatter_round(val, col, ii, clen, lhs, rhs, lb, ub, active, best_l,
                                         best_u, n_chunks, k, max_len, bsz, n_pad, int_eps, inf,
                                         stream);
}

int batched_fused_scatter_round(const double* val, const int* col, const int* ii,
                                const int* clen, const double* lhs, const double* rhs,
                                const double* lb, const double* ub, const int64_t* start,
                                const bool* active, double* best_l, double* best_u,
                                int64_t n_chunks, int k, int max_len, int64_t bsz,
                                int64_t n_pad, double int_eps, double inf, cudaStream_t stream) {
  return launch_batched_fused_scatter_round(val, col, ii, clen, lhs, rhs, lb, ub, start, active,
                                            best_l, best_u, n_chunks, k, max_len, bsz, n_pad,
                                            int_eps, inf, stream);
}

int apply_updates_batch(double* lb, double* ub, double* best_l, double* best_u,
                        const bool* active, bool* changed, bool* clear, int64_t bsz,
                        int64_t n_pad, double eps, double inf, double outward,
                        cudaStream_t stream) {
  return launch_apply_updates_batch(lb, ub, best_l, best_u, active, changed, clear, bsz, n_pad,
                                    eps, inf, outward, stream);
}

int node_objective(const double* lb, const double* ub, const double* c, const bool* is_int,
                   const bool* valid, double* obj, bool* fixed, bool* crossed, int64_t bsz,
                   int64_t n_pad, double feas_eps, double inf, cudaStream_t stream) {
  node_objective_kernel<<<static_cast<unsigned int>(bsz), kObjThreads, 0, stream>>>(
      lb, ub, c, is_int, valid, obj, fixed, crossed, n_pad, feas_eps, inf);
  return static_cast<int>(cudaGetLastError());
}

int activities(const double* val, const double* lb_g, const double* ub_g, double* mf, int* mc,
               double* xf, int* xc, const bool* go, int64_t n_chunks, int k, double inf,
               cudaStream_t stream) {
  LAUNCH_FOR_WIDTH(activities_kernel, k, n_chunks, stream, val, lb_g, ub_g, mf, mc, xf, xc, go,
                   n_chunks, k, inf);
  return static_cast<int>(cudaGetLastError());
}

int candidates(const double* val, const double* lb_g, const double* ub_g, const int* ii,
               const double* rmf, const int* rmc, const double* rxf, const int* rxc,
               const double* lhs, const double* rhs, double* lcand, double* ucand,
               const bool* go, int64_t n_chunks, int k, double int_eps, double inf,
               cudaStream_t stream) {
  LAUNCH_FOR_WIDTH(candidates_kernel, k, n_chunks, stream, val, lb_g, ub_g, ii, rmf, rmc, rxf,
                   rxc, lhs, rhs, lcand, ucand, go, n_chunks, k, int_eps, inf);
  return static_cast<int>(cudaGetLastError());
}

int fused_round(const double* val, const double* lb_g, const double* ub_g, const int* ii,
                const double* lhs, const double* rhs, double* lcand, double* ucand,
                const bool* go, int64_t n_chunks, int k, double int_eps, double inf,
                cudaStream_t stream) {
  LAUNCH_FOR_WIDTH(fused_round_kernel, k, n_chunks, stream, val, lb_g, ub_g, ii, lhs, rhs, lcand,
                   ucand, go, n_chunks, k, int_eps, inf);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
