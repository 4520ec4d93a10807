// Hopper (sm_90a) kernels of the precision tiers (ROADMAP Queue 1 item 5):
// the float32 forms of one instance's fused round, and kernel F with the
// progress-based early stop.
//
//   fused_scatter_round_f32[c]     (D)  at float32
//   activities_gather_f32[c]       (A') at float32
//   candidates_scatter_f32[c]      (E)  at float32
//   combine_chunk_partials_f32          the long-row combine at float32 (not
//                                       a TPU kernel: the reference's XLA
//                                       segment_sum, src/repro/kernels/ops.py:821)
//   apply_updates_f32              (F)  at float32
//   apply_updates_stop[_f32]       (F)  with the early stop armed, float64
//                                       and float32
//   activities_f32                 (A)  the segment round's activities at
//                                       float32 (it reads no marks)
//   candidates_f32[c]              (B)  the segment round's candidates at
//                                       float32
//   fused_round_f32[c]             (C)  the segment round's fused pass at
//                                       float32
//
// The `c` forms read the compact index streams of a float32 tier whose
// padded columns fit int16 (n_pad <= 2^15): int16 columns and int8
// integrality marks, widened to int in registers; the others read int32.
// B and C read no columns (their bounds come gathered per slot), so their
// `c` forms differ in the int8 marks alone.
// Each is the float64 kernel's template (single_round.cuh, round_common.cuh)
// instantiated at float, so it keeps the float64 kernel's layout, lane
// groups, summation order and division-first candidates, and does all its
// arithmetic in float: the scalars eps, int_eps, inf, outward and the
// early stop's threshold come rounded to float by the caller, as the
// reference's weakly typed Python scalars are at float32.  The fp32 tier's
// rounding slack (2**-17 * max(1, |c|) below a lower integral candidate,
// above an upper one) and its outward widening of the merge are separate
// multiplies and adds, which --fmad=false keeps from contracting, so each
// kernel rounds as its plain version (kernels/ref.py) does at float32.  The
// column max / min use 32-bit integer atomics on the order-preserving
// encoding (round_common.cuh red_max / red_min).
//
// F with the early stop (StopCarryFlags): F's merge body, each block's sum
// of the progress measure over its columns into a partials buffer that the
// round closure keeps, and the last block's fold of the measure into the
// loop carry: rounds, the measure, the low-progress streak, the last
// group's changed flag and GO cleared once the streak reaches `patience`.
// Without it, F runs apply_updates (prop_round.cu) or apply_updates_f32,
// unchanged.
//
// Bound on the H100: as the float64 forms', at 4 B a value, 2 B a compact
// column and 1 B a compact mark.
//
// Build with --fmad=false (kernels/_build.py).  Every entry point returns
// cudaGetLastError() after its launch.

#include "single_round.cuh"

extern "C" {

int fused_scatter_round_f32(const float* val, const int* col, const int* ii, const int* clen,
                            const float* lhs, const float* rhs, const float* lb, const float* ub,
                            float* best_l, float* best_u, const bool* go, int64_t n_chunks, int k,
                            int max_len, float int_eps, float inf, cudaStream_t stream) {
  return launch_fused_scatter_round(val, col, ii, clen, lhs, rhs, lb, ub, best_l, best_u, go,
                                    n_chunks, k, max_len, int_eps, inf, stream);
}

int fused_scatter_round_f32c(const float* val, const int16_t* col, const int8_t* ii,
                             const int* clen, const float* lhs, const float* rhs, const float* lb,
                             const float* ub, float* best_l, float* best_u, const bool* go,
                             int64_t n_chunks, int k, int max_len, float int_eps, float inf,
                             cudaStream_t stream) {
  return launch_fused_scatter_round(val, col, ii, clen, lhs, rhs, lb, ub, best_l, best_u, go,
                                    n_chunks, k, max_len, int_eps, inf, stream);
}

int activities_gather_f32(const float* val, const int* col, const int* clen, const float* lub,
                          float* mf, int* mc, float* xf, int* xc, const bool* go,
                          int64_t n_chunks, int k, float inf, cudaStream_t stream) {
  return launch_activities_gather(val, col, clen, lub, mf, mc, xf, xc, go, n_chunks, k, inf,
                                  stream);
}

int activities_gather_f32c(const float* val, const int16_t* col, const int* clen,
                           const float* lub, float* mf, int* mc, float* xf, int* xc,
                           const bool* go, int64_t n_chunks, int k, float inf,
                           cudaStream_t stream) {
  return launch_activities_gather(val, col, clen, lub, mf, mc, xf, xc, go, n_chunks, k, inf,
                                  stream);
}

int candidates_scatter_f32(const float* val, const int* col, const int* ii, const int* clen,
                           const float* rmf, const int* rmc, const float* rxf, const int* rxc,
                           const float* lhs, const float* rhs, const float* lub, float* best_l,
                           float* best_u, const bool* go, int64_t n_chunks, int k, float int_eps,
                           float inf, cudaStream_t stream) {
  return launch_candidates_scatter(val, col, ii, clen, rmf, rmc, rxf, rxc, lhs, rhs, lub, best_l,
                                   best_u, go, n_chunks, k, int_eps, inf, stream);
}

int candidates_scatter_f32c(const float* val, const int16_t* col, const int8_t* ii,
                            const int* clen, const float* rmf, const int* rmc, const float* rxf,
                            const int* rxc, const float* lhs, const float* rhs, const float* lub,
                            float* best_l, float* best_u, const bool* go, int64_t n_chunks, int k,
                            float int_eps, float inf, cudaStream_t stream) {
  return launch_candidates_scatter(val, col, ii, clen, rmf, rmc, rxf, rxc, lhs, rhs, lub, best_l,
                                   best_u, go, n_chunks, k, int_eps, inf, stream);
}

int combine_chunk_partials_f32(const float* mf, const int* mc, const float* xf, const int* xc,
                               const int64_t* row_start, const int* short_seg,
                               const int* long_seg, float* omf, int* omc, float* oxf, int* oxc,
                               const bool* go, int64_t n_short, int64_t n_long,
                               cudaStream_t stream) {
  return launch_combine_chunk_partials(mf, mc, xf, xc, row_start, short_seg, long_seg, omf, omc,
                                       oxf, oxc, go, n_short, n_long, stream);
}

int apply_updates_f32(float* lb, float* ub, float* best_l, float* best_u, int* carry, int64_t n,
                      int k, int unroll, float eps, float inf, float outward,
                      cudaStream_t stream) {
  return launch_merge_grid<CarryFlags, CarryFlags::kGridCols, false>(
      lb, ub, best_l, best_u, nullptr, CarryFlags{carry, k, unroll}, 1, n, eps, inf, outward,
      stream);
}

int apply_updates_stop(double* lb, double* ub, double* best_l, double* best_u, int* carry,
                       double* partials, int64_t n, double eps, double inf, double outward,
                       double stop, int patience, cudaStream_t stream) {
  using Flags = StopCarryFlags<double>;
  return launch_merge_grid<Flags, Flags::kGridCols, false>(
      lb, ub, best_l, best_u, nullptr, Flags{carry, partials, stop, patience}, 1, n, eps, inf,
      outward, stream);
}

int apply_updates_stop_f32(float* lb, float* ub, float* best_l, float* best_u, int* carry,
                           float* partials, int64_t n, float eps, float inf, float outward,
                           float stop, int patience, cudaStream_t stream) {
  using Flags = StopCarryFlags<float>;
  return launch_merge_grid<Flags, Flags::kGridCols, false>(
      lb, ub, best_l, best_u, nullptr, Flags{carry, partials, stop, patience}, 1, n, eps, inf,
      outward, stream);
}

int activities_f32(const float* val, const float* lb_g, const float* ub_g, float* mf, int* mc,
                   float* xf, int* xc, const bool* go, int64_t n_chunks, int k, float inf,
                   cudaStream_t stream) {
  return launch_activities(val, lb_g, ub_g, mf, mc, xf, xc, go, n_chunks, k, inf, stream);
}

int candidates_f32(const float* val, const float* lb_g, const float* ub_g, const int* ii,
                   const float* rmf, const int* rmc, const float* rxf, const int* rxc,
                   const float* lhs, const float* rhs, float* lcand, float* ucand, const bool* go,
                   int64_t n_chunks, int k, float int_eps, float inf, cudaStream_t stream) {
  return launch_candidates(val, lb_g, ub_g, ii, rmf, rmc, rxf, rxc, lhs, rhs, lcand, ucand, go,
                           n_chunks, k, int_eps, inf, stream);
}

int candidates_f32c(const float* val, const float* lb_g, const float* ub_g, const int8_t* ii,
                    const float* rmf, const int* rmc, const float* rxf, const int* rxc,
                    const float* lhs, const float* rhs, float* lcand, float* ucand,
                    const bool* go, int64_t n_chunks, int k, float int_eps, float inf,
                    cudaStream_t stream) {
  return launch_candidates(val, lb_g, ub_g, ii, rmf, rmc, rxf, rxc, lhs, rhs, lcand, ucand, go,
                           n_chunks, k, int_eps, inf, stream);
}

int fused_round_f32(const float* val, const float* lb_g, const float* ub_g, const int* ii,
                    const float* lhs, const float* rhs, float* lcand, float* ucand,
                    const bool* go, int64_t n_chunks, int k, float int_eps, float inf,
                    cudaStream_t stream) {
  return launch_fused_round(val, lb_g, ub_g, ii, lhs, rhs, lcand, ucand, go, n_chunks, k,
                            int_eps, inf, stream);
}

int fused_round_f32c(const float* val, const float* lb_g, const float* ub_g, const int8_t* ii,
                     const float* lhs, const float* rhs, float* lcand, float* ucand,
                     const bool* go, int64_t n_chunks, int k, float int_eps, float inf,
                     cudaStream_t stream) {
  return launch_fused_round(val, lb_g, ub_g, ii, lhs, rhs, lcand, ucand, go, n_chunks, k,
                            int_eps, inf, stream);
}

}  // extern "C"
