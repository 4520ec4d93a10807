// Hopper (sm_90a) kernels of the precision tiers on the batched engines
// (ROADMAP Queue 1 item 5): the float32 forms of the packed batch's, the
// node batch's and the service's rounds, and kernel #9 with the early
// stop's per-row progress measure.
//
//   batched_fused_scatter_round_f32      (#8)  at float32, int32 ids (the
//                                              reference's packed batch never
//                                              narrows them)
//   node_fused_scatter_round_f32[c]      (#10) at float32
//   node_activities_gather_f32[c]        A' over a node batch at float32
//   node_combine_chunk_partials_f32      the long-row combine over a node
//                                        batch at float32
//   node_candidates_scatter_f32[c]       E over a node batch at float32
//   apply_updates_batch_f32              (#9)  at float32
//   apply_updates_batch_stop[_f32]       (#9)  with the early stop's measure,
//                                              float64 and float32
//
// The node-batched A', combine and E have no Pallas twin: the reference
// vmaps its jnp round there (src/repro/kernels/ops.py:2031).  The `c` forms
// read the compact index streams of a float32 prep whose padded columns fit
// int16 (n_pad <= 2^15): int16 columns and int8 integrality marks, widened
// to int in registers; the others read int32.  Each is the float64
// kernel's template (batch_round.cuh, round_common.cuh) instantiated at
// float, so it keeps the float64 kernel's layout, lane groups, walks,
// summation order and division-first candidates, and does all its
// arithmetic in float: the scalars eps, int_eps, inf and outward come
// rounded to float by the caller, as the reference's weakly typed Python
// scalars are at float32.  The fp32 tier's rounding slack and its outward
// widening of the merge are separate multiplies and adds, which
// --fmad=false keeps from contracting.  The column max / min use 32-bit
// integer atomics on the order-preserving encoding (round_common.cuh
// red_max / red_min).  The flat stream's A', combine and E at float32 are
// tier_round.cu's.
//
// #9 with the early stop (RowStopFlags): #9's merge body, each (row, block
// of 1,024 columns) item's sum of the progress measure over its columns
// into a (B, blocks) partials buffer that the round closure keeps, and the
// launch's last block's sum of each active row's partials in block order
// (ref.merge_order_sum per row) into prog[row].  The caller folds the
// measure into the rows' streak and mask, as the reference's loop body
// does.  Without it, #9 runs apply_updates_batch (prop_round.cu) or
// apply_updates_batch_f32, unchanged.
//
// Bound on the H100: as the float64 forms', at 4 B a value, 2 B a compact
// column and 1 B a compact mark; the stop form adds a value per (active
// row, column block) written and read.
//
// Build with --fmad=false (kernels/_build.py).  Every entry point returns
// cudaGetLastError() after its launch.

#include "batch_round.cuh"

extern "C" {

int batched_fused_scatter_round_f32(const float* val, const int* col, const int* ii,
                                    const int* clen, const float* lhs, const float* rhs,
                                    const float* lb, const float* ub, const int64_t* start,
                                    const bool* active, float* best_l, float* best_u,
                                    int64_t n_chunks, int k, int max_len, int64_t bsz,
                                    int64_t n_pad, float int_eps, float inf,
                                    cudaStream_t stream) {
  return launch_batched_fused_scatter_round(val, col, ii, clen, lhs, rhs, lb, ub, start, active,
                                            best_l, best_u, n_chunks, k, max_len, bsz, n_pad,
                                            int_eps, inf, stream);
}

int node_fused_scatter_round_f32(const float* val, const int* col, const int* ii,
                                 const int* clen, const float* lhs, const float* rhs,
                                 const float* lb, const float* ub, const bool* active,
                                 float* best_l, float* best_u, int64_t n_chunks, int k,
                                 int max_len, int64_t bsz, int64_t n_pad, float int_eps,
                                 float inf, cudaStream_t stream) {
  return launch_node_fused_scatter_round(val, col, ii, clen, lhs, rhs, lb, ub, active, best_l,
                                         best_u, n_chunks, k, max_len, bsz, n_pad, int_eps, inf,
                                         stream);
}

int node_fused_scatter_round_f32c(const float* val, const int16_t* col, const int8_t* ii,
                                  const int* clen, const float* lhs, const float* rhs,
                                  const float* lb, const float* ub, const bool* active,
                                  float* best_l, float* best_u, int64_t n_chunks, int k,
                                  int max_len, int64_t bsz, int64_t n_pad, float int_eps,
                                  float inf, cudaStream_t stream) {
  return launch_node_fused_scatter_round(val, col, ii, clen, lhs, rhs, lb, ub, active, best_l,
                                         best_u, n_chunks, k, max_len, bsz, n_pad, int_eps, inf,
                                         stream);
}

int node_activities_gather_f32(const float* val, const int* col, const int* clen,
                               const float* lb, const float* ub, const bool* active, float* mf,
                               int* mc, float* xf, int* xc, int64_t n_chunks, int k,
                               int max_len, int64_t bsz, int64_t n_pad, float inf,
                               cudaStream_t stream) {
  return launch_node_activities_gather(val, col, clen, lb, ub, active, mf, mc, xf, xc, n_chunks,
                                       k, max_len, bsz, n_pad, inf, stream);
}

int node_activities_gather_f32c(const float* val, const int16_t* col, const int* clen,
                                const float* lb, const float* ub, const bool* active, float* mf,
                                int* mc, float* xf, int* xc, int64_t n_chunks, int k,
                                int max_len, int64_t bsz, int64_t n_pad, float inf,
                                cudaStream_t stream) {
  return launch_node_activities_gather(val, col, clen, lb, ub, active, mf, mc, xf, xc, n_chunks,
                                       k, max_len, bsz, n_pad, inf, stream);
}

int node_combine_chunk_partials_f32(const float* mf, const int* mc, const float* xf,
                                    const int* xc, const int64_t* row_start,
                                    const int* short_seg, const int* long_seg,
                                    const bool* active, float* omf, int* omc, float* oxf,
                                    int* oxc, int64_t n_short, int64_t n_long, int64_t n_chunks,
                                    int64_t bsz, cudaStream_t stream) {
  return launch_node_combine_chunk_partials(mf, mc, xf, xc, row_start, short_seg, long_seg,
                                            active, omf, omc, oxf, oxc, n_short, n_long,
                                            n_chunks, bsz, stream);
}

int node_candidates_scatter_f32(const float* val, const int* col, const int* ii, const int* clen,
                                const float* rmf, const int* rmc, const float* rxf,
                                const int* rxc, const float* lhs, const float* rhs,
                                const float* lb, const float* ub, const bool* active,
                                float* best_l, float* best_u, int64_t n_chunks, int k,
                                int max_len, int64_t bsz, int64_t n_pad, float int_eps,
                                float inf, cudaStream_t stream) {
  return launch_node_candidates_scatter(val, col, ii, clen, rmf, rmc, rxf, rxc, lhs, rhs, lb, ub,
                                        active, best_l, best_u, n_chunks, k, max_len, bsz, n_pad,
                                        int_eps, inf, stream);
}

int node_candidates_scatter_f32c(const float* val, const int16_t* col, const int8_t* ii,
                                 const int* clen, const float* rmf, const int* rmc,
                                 const float* rxf, const int* rxc, const float* lhs,
                                 const float* rhs, const float* lb, const float* ub,
                                 const bool* active, float* best_l, float* best_u,
                                 int64_t n_chunks, int k, int max_len, int64_t bsz,
                                 int64_t n_pad, float int_eps, float inf, cudaStream_t stream) {
  return launch_node_candidates_scatter(val, col, ii, clen, rmf, rmc, rxf, rxc, lhs, rhs, lb, ub,
                                        active, best_l, best_u, n_chunks, k, max_len, bsz, n_pad,
                                        int_eps, inf, stream);
}

int apply_updates_batch_f32(float* lb, float* ub, float* best_l, float* best_u,
                            const bool* active, bool* changed, bool* clear, int64_t bsz,
                            int64_t n_pad, float eps, float inf, float outward,
                            cudaStream_t stream) {
  return launch_apply_updates_batch(lb, ub, best_l, best_u, active, changed, clear, bsz, n_pad,
                                    eps, inf, outward, stream);
}

int apply_updates_batch_stop(double* lb, double* ub, double* best_l, double* best_u,
                             const bool* active, bool* changed, bool* clear, double* partials,
                             double* prog, int* ticket, int64_t bsz, int64_t n_pad, double eps,
                             double inf, double outward, cudaStream_t stream) {
  return launch_apply_updates_batch_stop(lb, ub, best_l, best_u, active, changed, clear,
                                         partials, prog, ticket, bsz, n_pad, eps, inf, outward,
                                         stream);
}

int apply_updates_batch_stop_f32(float* lb, float* ub, float* best_l, float* best_u,
                                 const bool* active, bool* changed, bool* clear, float* partials,
                                 float* prog, int* ticket, int64_t bsz, int64_t n_pad, float eps,
                                 float inf, float outward, cudaStream_t stream) {
  return launch_apply_updates_batch_stop(lb, ub, best_l, best_u, active, changed, clear,
                                         partials, prog, ticket, bsz, n_pad, eps, inf, outward,
                                         stream);
}

}  // extern "C"
