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
// walk, the one-column merges) is in round_common.cuh; kernels D, A', E,
// the long-row combine and the segment round's A, B and C are in
// single_round.cuh, #8, #10, the node forms of A', the combine and E and
// #9's launchers in batch_round.cuh, and the straddle combine with the
// slab kernels in slab_round.cuh, templated on the value and index types,
// which tier_round.cu, batch_tier_round.cu and slab_tier_round.cu
// instantiate at float32.
//
// Build with --fmad=false: the activity products and the merge's
// old + eps * max(1, |old|) must round like the oracle's separate multiply
// and add.  The candidate chain is division-first and has no multiply
// feeding an add.
//
// Every entry point returns cudaGetLastError() after its launch.

#include "batch_round.cuh"
#include "slab_round.cuh"

namespace {

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
                           double* xf, int* xc, int64_t n_chunks, int k, int max_len,
                           int64_t bsz, int64_t n_pad, double inf, cudaStream_t stream) {
  return launch_node_activities_gather(val, col, clen, lb, ub, active, mf, mc, xf, xc, n_chunks,
                                       k, max_len, bsz, n_pad, inf, stream);
}

int node_candidates_scatter(const double* val, const int* col, const int* ii, const int* clen,
                            const double* rmf, const int* rmc, const double* rxf,
                            const int* rxc, const double* lhs, const double* rhs,
                            const double* lb, const double* ub, const bool* active,
                            double* best_l, double* best_u, int64_t n_chunks, int k,
                            int max_len, int64_t bsz, int64_t n_pad, double int_eps,
                            double inf, cudaStream_t stream) {
  return launch_node_candidates_scatter(val, col, ii, clen, rmf, rmc, rxf, rxc, lhs, rhs, lb, ub,
                                        active, best_l, best_u, n_chunks, k, max_len, bsz, n_pad,
                                        int_eps, inf, stream);
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
  return launch_straddle_combine(mf, mc, xf, xc, a_order, a_seg, agg_slot, active, tmf, tmc, txf,
                                 txc, omf, omc, oxf, oxc, n_slots, n_pos, n_chunks, nb, stream);
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
  return launch_activities(val, lb_g, ub_g, mf, mc, xf, xc, go, n_chunks, k, inf, stream);
}

int candidates(const double* val, const double* lb_g, const double* ub_g, const int* ii,
               const double* rmf, const int* rmc, const double* rxf, const int* rxc,
               const double* lhs, const double* rhs, double* lcand, double* ucand,
               const bool* go, int64_t n_chunks, int k, double int_eps, double inf,
               cudaStream_t stream) {
  return launch_candidates(val, lb_g, ub_g, ii, rmf, rmc, rxf, rxc, lhs, rhs, lcand, ucand, go,
                           n_chunks, k, int_eps, inf, stream);
}

int fused_round(const double* val, const double* lb_g, const double* ub_g, const int* ii,
                const double* lhs, const double* rhs, double* lcand, double* ucand,
                const bool* go, int64_t n_chunks, int k, double int_eps, double inf,
                cudaStream_t stream) {
  return launch_fused_round(val, lb_g, ub_g, ii, lhs, rhs, lcand, ucand, go, n_chunks, k,
                            int_eps, inf, stream);
}

}  // extern "C"
