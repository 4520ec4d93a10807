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
// The kernels and their launchers are slab_round.cuh's templates,
// instantiated here at double; slab_tier_round.cu instantiates them at
// float.  Each entry point returns cudaGetLastError().

#include "slab_round.cuh"

extern "C" {

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

int slab_partials(const double* val, const int* col, const int* run_start, const int* run_inst,
                  const int* run_slab, const bool* active, const double* lb, const double* ub,
                  double* mf, int* mc, double* xf, int* xc, const bool* go, int n_runs,
                  int64_t n_chunks, int r, int k, int64_t width, int64_t slab, double inf,
                  cudaStream_t stream) {
  return launch_slab_partials(val, col, run_start, run_inst, run_slab, active, lb, ub, mf, mc,
                              xf, xc, go, n_runs, n_chunks, r, k, width, slab, inf, stream);
}

int node_slab_partials(const double* val, const int* col, const int* clen, const int* tile_slab,
                       const bool* active, const double* lb, const double* ub, double* mf,
                       int* mc, double* xf, int* xc, int64_t n_chunks, int r, int k,
                       int max_len, int64_t bsz, int64_t width, int64_t slab, double inf,
                       cudaStream_t stream) {
  return launch_node_slab_partials(val, col, clen, tile_slab, active, lb, ub, mf, mc, xf, xc,
                                   n_chunks, r, k, max_len, bsz, width, slab, inf, stream);
}

int slab_scatter(const double* val, const int* col, const int* ii, const int* clen,
                 const int* done, const double* smf, const int* smc, const double* sxf,
                 const int* sxc, const double* lhs, const double* rhs, const int* tile_inst,
                 const int* tile_slab, const bool* active, const double* lb, const double* ub,
                 double* best_l, double* best_u, const bool* go, int64_t n_chunks, int r, int k,
                 int max_len, int64_t width, int64_t slab, double int_eps, double inf,
                 cudaStream_t stream) {
  return launch_slab_scatter(val, col, ii, clen, done, smf, smc, sxf, sxc, lhs, rhs, tile_inst,
                             tile_slab, active, lb, ub, best_l, best_u, go, n_chunks, r, k,
                             max_len, width, slab, int_eps, inf, stream);
}

int node_slab_scatter(const double* val, const int* col, const int* ii, const int* clen,
                      const int* done, const double* smf, const int* smc, const double* sxf,
                      const int* sxc, const double* lhs, const double* rhs,
                      const int* tile_slab, const bool* active, const double* lb,
                      const double* ub, double* best_l, double* best_u, int64_t n_chunks,
                      int r, int k, int max_len, int64_t bsz, int64_t width, int64_t slab,
                      double int_eps, double inf, cudaStream_t stream) {
  return launch_node_slab_scatter(val, col, ii, clen, done, smf, smc, sxf, sxc, lhs, rhs,
                                  tile_slab, active, lb, ub, best_l, best_u, n_chunks, r, k,
                                  max_len, bsz, width, slab, int_eps, inf, stream);
}

int slab_merge(double* lb, double* ub, double* best_l, double* best_u, const bool* active,
               int* flags, int* clear, int* carry, int64_t bsz, int64_t width, int64_t slab,
               int k, int unroll, double eps, double inf, double outward, cudaStream_t stream) {
  return launch_slab_merge(lb, ub, best_l, best_u, active, flags, clear, carry, bsz, width, slab,
                           k, unroll, eps, inf, outward, stream);
}

}  // extern "C"
