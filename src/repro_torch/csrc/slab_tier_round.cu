// Hopper (sm_90a) kernels of the precision tiers on the column-slab
// partitioned round (ROADMAP Queue 1 item 5): the float32 forms of the
// partitioned round's kernels, and kernel #15 with the early stop.
//
//   slab_partials_f32         (#11) at float32
//   node_slab_partials_f32    (#13) at float32
//   slab_scatter_f32          the first launch of #12 at float32
//   node_slab_scatter_f32     the first launch of #14 at float32
//   slab_merge_f32            (#15, and the second launch of #12 and #14) at
//                             float32
//   straddle_combine_f32      the straddle combine at float32 (not a TPU
//                             kernel: the reference's XLA segment_sum,
//                             src/repro/kernels/ops.py:830); each slot's
//                             partials summed from +0.0 in sub-stream order
//   slab_merge_stop[_f32]     #15 for one instance's fixed point with the
//                             early stop armed, float64 and float32
//   slab_merge_rows_stop[_f32]  #15 over a batch's or node batch's planes
//                             with the early stop's per-row measure,
//                             float64 and float32
//
// Each is slab_round.cuh's template (on round_common.cuh's routines)
// instantiated at float, so it keeps the float64 kernel's layout, lane
// groups, walks, summation order and division-first candidates, and does
// all its arithmetic in float: the scalars eps, int_eps, inf, outward and
// the early stop's threshold come rounded to float by the caller, as the
// reference's weakly typed Python scalars are at float32.  The fp32 tier's
// rounding slack and its outward widening of the merge are separate
// multiplies and adds, which --fmad=false keeps from contracting.  The
// column max / min use 32-bit integer atomics on the order-preserving
// encoding (round_common.cuh red_max / red_min).  Ids are int32: the
// partition widens a compact prep's int16 columns, as the reference's
// build_slab_partition does (src/repro/kernels/ops.py:390).
//
// #15 with the early stop, one instance (slab_merge_stop): F's
// StopCarryFlags on the grid over the plane, masked by the carry's go: each
// block's sum of the progress measure over its 1,024 columns into a
// partials buffer that the round closure keeps, and the last block's fold
// of the measure into the loop carry, as apply_updates_stop (tier_round.cu)
// does; ref.merge_order_sum is its order.  Over a batch
// (slab_merge_rows_stop): WindowStopFlags, #15's window flags and #9's
// per-row measure (apply_updates_batch_stop, batch_tier_round.cu): each
// (row, block of 1,024 columns) item's sum into a (B, blocks) partials
// buffer, then the launch's last block sums each active row's in block
// order into prog[row], so a row's measure is summed over all its windows
// in one fixed order.  Without a stop, #15 runs slab_merge (slab_round.cu)
// or slab_merge_f32, unchanged.
//
// Bound on the H100: as the float64 forms', at 4 B a value; the stop forms
// add a value per (active row, column block) written and read.
//
// Build with --fmad=false (kernels/_build.py).  Every entry point returns
// cudaGetLastError() after its launch.

#include "slab_round.cuh"

extern "C" {

int slab_partials_f32(const float* val, const int* col, const int* run_start,
                      const int* run_inst, const int* run_slab, const bool* active,
                      const float* lb, const float* ub, float* mf, int* mc, float* xf, int* xc,
                      const bool* go, int n_runs, int64_t n_chunks, int r, int k, int64_t width,
                      int64_t slab, float inf, cudaStream_t stream) {
  return launch_slab_partials(val, col, run_start, run_inst, run_slab, active, lb, ub, mf, mc,
                              xf, xc, go, n_runs, n_chunks, r, k, width, slab, inf, stream);
}

int node_slab_partials_f32(const float* val, const int* col, const int* clen,
                           const int* tile_slab, const bool* active, const float* lb,
                           const float* ub, float* mf, int* mc, float* xf, int* xc,
                           int64_t n_chunks, int r, int k, int max_len, int64_t bsz,
                           int64_t width, int64_t slab, float inf, cudaStream_t stream) {
  return launch_node_slab_partials(val, col, clen, tile_slab, active, lb, ub, mf, mc, xf, xc,
                                   n_chunks, r, k, max_len, bsz, width, slab, inf, stream);
}

int slab_scatter_f32(const float* val, const int* col, const int* ii, const int* clen,
                     const int* done, const float* smf, const int* smc, const float* sxf,
                     const int* sxc, const float* lhs, const float* rhs, const int* tile_inst,
                     const int* tile_slab, const bool* active, const float* lb, const float* ub,
                     float* best_l, float* best_u, const bool* go, int64_t n_chunks, int r,
                     int k, int max_len, int64_t width, int64_t slab, float int_eps, float inf,
                     cudaStream_t stream) {
  return launch_slab_scatter(val, col, ii, clen, done, smf, smc, sxf, sxc, lhs, rhs, tile_inst,
                             tile_slab, active, lb, ub, best_l, best_u, go, n_chunks, r, k,
                             max_len, width, slab, int_eps, inf, stream);
}

int node_slab_scatter_f32(const float* val, const int* col, const int* ii, const int* clen,
                          const int* done, const float* smf, const int* smc, const float* sxf,
                          const int* sxc, const float* lhs, const float* rhs,
                          const int* tile_slab, const bool* active, const float* lb,
                          const float* ub, float* best_l, float* best_u, int64_t n_chunks,
                          int r, int k, int max_len, int64_t bsz, int64_t width, int64_t slab,
                          float int_eps, float inf, cudaStream_t stream) {
  return launch_node_slab_scatter(val, col, ii, clen, done, smf, smc, sxf, sxc, lhs, rhs,
                                  tile_slab, active, lb, ub, best_l, best_u, n_chunks, r, k,
                                  max_len, bsz, width, slab, int_eps, inf, stream);
}

int slab_merge_f32(float* lb, float* ub, float* best_l, float* best_u, const bool* active,
                   int* flags, int* clear, int* carry, int64_t bsz, int64_t width, int64_t slab,
                   int k, int unroll, float eps, float inf, float outward, cudaStream_t stream) {
  return launch_slab_merge(lb, ub, best_l, best_u, active, flags, clear, carry, bsz, width, slab,
                           k, unroll, eps, inf, outward, stream);
}

int straddle_combine_f32(const float* mf, const int* mc, const float* xf, const int* xc,
                         const int64_t* a_order, const int64_t* a_seg, const int* agg_slot,
                         const bool* active, float* tmf, int* tmc, float* txf, int* txc,
                         float* omf, int* omc, float* oxf, int* oxc, int64_t n_slots,
                         int64_t n_pos, int64_t n_chunks, int64_t nb, cudaStream_t stream) {
  return launch_straddle_combine(mf, mc, xf, xc, a_order, a_seg, agg_slot, active, tmf, tmc, txf,
                                 txc, omf, omc, oxf, oxc, n_slots, n_pos, n_chunks, nb, stream);
}

int slab_merge_stop(double* lb, double* ub, double* best_l, double* best_u, const bool* active,
                    int* carry, double* partials, int64_t width, double eps, double inf,
                    double outward, double stop, int patience, cudaStream_t stream) {
  return launch_slab_merge_stop(lb, ub, best_l, best_u, active, carry, partials, width, eps, inf,
                                outward, stop, patience, stream);
}

int slab_merge_stop_f32(float* lb, float* ub, float* best_l, float* best_u, const bool* active,
                        int* carry, float* partials, int64_t width, float eps, float inf,
                        float outward, float stop, int patience, cudaStream_t stream) {
  return launch_slab_merge_stop(lb, ub, best_l, best_u, active, carry, partials, width, eps, inf,
                                outward, stop, patience, stream);
}

int slab_merge_rows_stop(double* lb, double* ub, double* best_l, double* best_u,
                         const bool* active, int* flags, int* clear, double* partials,
                         double* prog, int* ticket, int64_t bsz, int64_t width, int64_t slab,
                         double eps, double inf, double outward, cudaStream_t stream) {
  return launch_slab_merge_rows_stop(lb, ub, best_l, best_u, active, flags, clear, partials,
                                     prog, ticket, bsz, width, slab, eps, inf, outward, stream);
}

int slab_merge_rows_stop_f32(float* lb, float* ub, float* best_l, float* best_u,
                             const bool* active, int* flags, int* clear, float* partials,
                             float* prog, int* ticket, int64_t bsz, int64_t width, int64_t slab,
                             float eps, float inf, float outward, cudaStream_t stream) {
  return launch_slab_merge_rows_stop(lb, ub, best_l, best_u, active, flags, clear, partials,
                                     prog, ticket, bsz, width, slab, eps, inf, outward, stream);
}

}  // extern "C"
