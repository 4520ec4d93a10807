// Hopper (sm_90a) kernels of the 16-bit value types: bfloat16 and float16
// forms of every kernel of the single-instance engines (the batched, node
// and service rounds' own kernels are half_batch_round.cu's; #15's batched
// walk and the straddle combine over a node batch run these entries).
//
//   fused_scatter_round_{bf16,bf16c,f16}  (D)
//   activities_gather_{bf16,bf16c,f16}    (A')
//   candidates_scatter_{bf16,bf16c,f16}   (E)
//   combine_chunk_partials_{bf16,f16}     the long-row combine (the
//                                         reference's XLA segment_sum,
//                                         src/repro/kernels/ops.py:821)
//   apply_updates_{bf16,f16}              (F)
//   apply_updates_stop_{bf16,f16}         (F) with the early stop armed
//   activities_{bf16,f16}                 (A)
//   candidates_{bf16,bf16c,f16}           (B)
//   fused_round_{bf16,bf16c,f16}          (C)
//   slab_partials_{bf16,f16}              (#11)
//   slab_scatter_{bf16,f16}               the first launch of #12
//   slab_merge_{bf16,f16}                 (#15, and the second launch of #12),
//                                         one instance's loop carry or
//                                         window flags
//   slab_merge_stop_{bf16,f16}            #15 for one instance's fixed point
//                                         with the early stop armed
//   straddle_combine_{bf16,f16}           the straddle combine (the
//                                         reference's XLA segment_sum,
//                                         src/repro/kernels/ops.py:830)
//   record_round_{bf16,f16}               the telemetry's record kernel
//                                         (no Pallas twin)
//
// The `c` forms read the compact index streams of a bfloat16 prep whose
// padded columns fit int16 (int16 columns, int8 marks), as the float32
// tier's do; float16 preps never hold them (the reference compacts on
// _is_low_precision, which leaves float16 out).
//
// Each is the float64 kernel's template (single_round.cuh, slab_round.cuh,
// record_round.cuh, round_common.cuh) instantiated at round_common.cuh's
// Bf16 or F16: the values are stored in 2 bytes and every operation runs in
// float and rounds to the type (to nearest even) at once, which is the
// per-operation rounding of the plain versions (kernels/ref.py: PyTorch's
// 16-bit arithmetic) and of the reference's XLA elementwise code at
// bfloat16.  The sums that XLA reduces in float32 -- a chunk's activity
// partials and the merge's progress measure -- accumulate in float in the
// kernels' fixed order (ref.warp_order_sum, ref.merge_order_sum) and round
// once; the long-row and straddle combines round after every add, in chunk
// order, as the reference's segment_sum does.  The scalars eps, int_eps,
// inf, outward, feas_eps and the early stop's threshold arrive as floats
// holding 16-bit values (the wrappers round them, as the reference's weakly
// typed scalars are: at float16 eps and feas_eps are 0 and inf is inf).
// bfloat16's integrality slack is 2**-6 * max(1, |c|); float16 has none
// (core.types.int_round_slack).
//
// The column max / min of D, E and #12 reduce into float32 planes: the
// card has no 16-bit atomic max, and a 16-bit candidate widens to float
// exactly, so the 32-bit integer atomics on the order-preserving encoding
// (round_common.cuh red_max / red_min) serve; F and #15 narrow the planes
// back exactly and hand them back at the sentinels.
//
// Bound on the H100: as the float64 forms', at 2 B a value (the compact
// forms 2 B a column and 1 B a mark), 4 B per accumulator entry.
//
// Build with --fmad=false (kernels/_build.py).  Every entry point returns
// cudaGetLastError() after its launch.

#include "record_round.cuh"
#include "single_round.cuh"
#include "slab_round.cuh"

// The entries of value type T (suffix S) with int32 ids.
#define HALF_ENTRIES(S, T)                                                                        \
  int fused_scatter_round_##S(const T* val, const int* col, const int* ii, const int* clen,       \
                              const T* lhs, const T* rhs, const T* lb, const T* ub,               \
                              float* best_l, float* best_u, const bool* go, int64_t n_chunks,     \
                              int k, int max_len, float int_eps, float inf,                       \
                              cudaStream_t stream) {                                              \
    return launch_fused_scatter_round(val, col, ii, clen, lhs, rhs, lb, ub, best_l, best_u, go,   \
                                      n_chunks, k, max_len, T(int_eps), T(inf), stream);          \
  }                                                                                               \
  int activities_gather_##S(const T* val, const int* col, const int* clen, const T* lub, T* mf,   \
                            int* mc, T* xf, int* xc, const bool* go, int64_t n_chunks, int k,     \
                            float inf, cudaStream_t stream) {                                     \
    return launch_activities_gather(val, col, clen, lub, mf, mc, xf, xc, go, n_chunks, k, T(inf), \
                                    stream);                                                      \
  }                                                                                               \
  int candidates_scatter_##S(const T* val, const int* col, const int* ii, const int* clen,        \
                             const T* rmf, const int* rmc, const T* rxf, const int* rxc,          \
                             const T* lhs, const T* rhs, const T* lub, float* best_l,             \
                             float* best_u, const bool* go, int64_t n_chunks, int k,              \
                             float int_eps, float inf, cudaStream_t stream) {                     \
    return launch_candidates_scatter(val, col, ii, clen, rmf, rmc, rxf, rxc, lhs, rhs, lub,       \
                                     best_l, best_u, go, n_chunks, k, T(int_eps), T(inf),         \
                                     stream);                                                     \
  }                                                                                               \
  int combine_chunk_partials_##S(const T* mf, const int* mc, const T* xf, const int* xc,          \
                                 const int64_t* row_start, const int* short_seg,                  \
                                 const int* long_seg, T* omf, int* omc, T* oxf, int* oxc,         \
                                 const bool* go, int64_t n_short, int64_t n_long,                 \
                                 cudaStream_t stream) {                                           \
    return launch_combine_chunk_partials(mf, mc, xf, xc, row_start, short_seg, long_seg, omf,     \
                                         omc, oxf, oxc, go, n_short, n_long, stream);             \
  }                                                                                               \
  int apply_updates_##S(T* lb, T* ub, float* best_l, float* best_u, int* carry, int64_t n, int k, \
                        int unroll, float eps, float inf, float outward, cudaStream_t stream) {   \
    return launch_merge_grid<CarryFlags, CarryFlags::kGridCols, false>(                           \
        lb, ub, best_l, best_u, nullptr, CarryFlags{carry, k, unroll}, 1, n, T(eps), T(inf),      \
        T(outward), stream);                                                                      \
  }                                                                                               \
  int apply_updates_stop_##S(T* lb, T* ub, float* best_l, float* best_u, int* carry,             \
                             float* partials, int64_t n, float eps, float inf, float outward,     \
                             float stop, int patience, cudaStream_t stream) {                     \
    using Flags = StopCarryFlags<T>;                                                              \
    return launch_merge_grid<Flags, Flags::kGridCols, false>(                                     \
        lb, ub, best_l, best_u, nullptr, Flags{carry, partials, T(stop), patience}, 1, n, T(eps), \
        T(inf), T(outward), stream);                                                              \
  }                                                                                               \
  int activities_##S(const T* val, const T* lb_g, const T* ub_g, T* mf, int* mc, T* xf, int* xc, \
                     const bool* go, int64_t n_chunks, int k, float inf, cudaStream_t stream) {   \
    return launch_activities(val, lb_g, ub_g, mf, mc, xf, xc, go, n_chunks, k, T(inf), stream);   \
  }                                                                                               \
  int candidates_##S(const T* val, const T* lb_g, const T* ub_g, const int* ii, const T* rmf,     \
                     const int* rmc, const T* rxf, const int* rxc, const T* lhs, const T* rhs,    \
                     T* lcand, T* ucand, const bool* go, int64_t n_chunks, int k, float int_eps,  \
                     float inf, cudaStream_t stream) {                                            \
    return launch_candidates(val, lb_g, ub_g, ii, rmf, rmc, rxf, rxc, lhs, rhs, lcand, ucand, go, \
                             n_chunks, k, T(int_eps), T(inf), stream);                            \
  }                                                                                               \
  int fused_round_##S(const T* val, const T* lb_g, const T* ub_g, const int* ii, const T* lhs,    \
                      const T* rhs, T* lcand, T* ucand, const bool* go, int64_t n_chunks, int k,  \
                      float int_eps, float inf, cudaStream_t stream) {                            \
    return launch_fused_round(val, lb_g, ub_g, ii, lhs, rhs, lcand, ucand, go, n_chunks, k,       \
                              T(int_eps), T(inf), stream);                                        \
  }                                                                                               \
  int slab_partials_##S(const T* val, const int* col, const int* run_start, const int* run_inst, \
                        const int* run_slab, const bool* active, const T* lb, const T* ub, T* mf, \
                        int* mc, T* xf, int* xc, const bool* go, int n_runs, int64_t n_chunks,    \
                        int r, int k, int64_t width, int64_t slab, float inf,                     \
                        cudaStream_t stream) {                                                    \
    return launch_slab_partials(val, col, run_start, run_inst, run_slab, active, lb, ub, mf, mc,  \
                                xf, xc, go, n_runs, n_chunks, r, k, width, slab, T(inf), stream); \
  }                                                                                               \
  int slab_scatter_##S(const T* val, const int* col, const int* ii, const int* clen,              \
                       const int* done, const T* smf, const int* smc, const T* sxf,               \
                       const int* sxc, const T* lhs, const T* rhs, const int* tile_inst,          \
                       const int* tile_slab, const bool* active, const T* lb, const T* ub,        \
                       float* best_l, float* best_u, const bool* go, int64_t n_chunks, int r,     \
                       int k, int max_len, int64_t width, int64_t slab, float int_eps, float inf, \
                       cudaStream_t stream) {                                                     \
    return launch_slab_scatter(val, col, ii, clen, done, smf, smc, sxf, sxc, lhs, rhs, tile_inst, \
                               tile_slab, active, lb, ub, best_l, best_u, go, n_chunks, r, k,     \
                               max_len, width, slab, T(int_eps), T(inf), stream);                 \
  }                                                                                               \
  int slab_merge_##S(T* lb, T* ub, float* best_l, float* best_u, const bool* active, int* flags,  \
                     int* clear, int* carry, int64_t bsz, int64_t width, int64_t slab, int k,     \
                     int unroll, float eps, float inf, float outward, cudaStream_t stream) {      \
    return launch_slab_merge(lb, ub, best_l, best_u, active, flags, clear, carry, bsz, width,     \
                             slab, k, unroll, T(eps), T(inf), T(outward), stream);                \
  }                                                                                               \
  int slab_merge_stop_##S(T* lb, T* ub, float* best_l, float* best_u, const bool* active,         \
                          int* carry, float* partials, int64_t width, float eps, float inf,       \
                          float outward, float stop, int patience, cudaStream_t stream) {         \
    return launch_slab_merge_stop(lb, ub, best_l, best_u, active, carry, partials, width, T(eps), \
                                  T(inf), T(outward), T(stop), patience, stream);                 \
  }                                                                                               \
  int straddle_combine_##S(const T* mf, const int* mc, const T* xf, const int* xc,                \
                           const int64_t* a_order, const int64_t* a_seg, const int* agg_slot,     \
                           const bool* active, T* tmf, int* tmc, T* txf, int* txc, T* omf,        \
                           int* omc, T* oxf, int* oxc, int64_t n_slots, int64_t n_pos,            \
                           int64_t n_chunks, int64_t nb, cudaStream_t stream) {                   \
    return launch_straddle_combine(mf, mc, xf, xc, a_order, a_seg, agg_slot, active, tmf, tmc,    \
                                   txf, txc, omf, omc, oxf, oxc, n_slots, n_pos, n_chunks, nb,    \
                                   stream);                                                       \
  }                                                                                               \
  int record_round_##S(const T* lb, const T* ub, int* carry, T* ring, int* ticks,                 \
                       int* stop_round, int* infeas_round, int* scratch, int64_t n, int cap,      \
                       int unroll, int patience, float feas_eps, cudaStream_t stream) {           \
    return launch_record_round(lb, ub, carry, ring, ticks, stop_round, infeas_round, scratch, n,  \
                               cap, unroll, patience, T(feas_eps), stream);                       \
  }

// The compact forms of value type T (suffix S): int16 columns, int8 marks.
#define HALF_COMPACT_ENTRIES(S, T)                                                                \
  int fused_scatter_round_##S(const T* val, const int16_t* col, const int8_t* ii,                 \
                              const int* clen, const T* lhs, const T* rhs, const T* lb,           \
                              const T* ub, float* best_l, float* best_u, const bool* go,          \
                              int64_t n_chunks, int k, int max_len, float int_eps, float inf,     \
                              cudaStream_t stream) {                                              \
    return launch_fused_scatter_round(val, col, ii, clen, lhs, rhs, lb, ub, best_l, best_u, go,   \
                                      n_chunks, k, max_len, T(int_eps), T(inf), stream);          \
  }                                                                                               \
  int activities_gather_##S(const T* val, const int16_t* col, const int* clen, const T* lub,       \
                            T* mf, int* mc, T* xf, int* xc, const bool* go, int64_t n_chunks,     \
                            int k, float inf, cudaStream_t stream) {                              \
    return launch_activities_gather(val, col, clen, lub, mf, mc, xf, xc, go, n_chunks, k, T(inf), \
                                    stream);                                                      \
  }                                                                                               \
  int candidates_scatter_##S(const T* val, const int16_t* col, const int8_t* ii, const int* clen, \
                             const T* rmf, const int* rmc, const T* rxf, const int* rxc,          \
                             const T* lhs, const T* rhs, const T* lub, float* best_l,             \
                             float* best_u, const bool* go, int64_t n_chunks, int k,              \
                             float int_eps, float inf, cudaStream_t stream) {                     \
    return launch_candidates_scatter(val, col, ii, clen, rmf, rmc, rxf, rxc, lhs, rhs, lub,       \
                                     best_l, best_u, go, n_chunks, k, T(int_eps), T(inf),         \
                                     stream);                                                     \
  }                                                                                               \
  int candidates_##S(const T* val, const T* lb_g, const T* ub_g, const int8_t* ii, const T* rmf,  \
                     const int* rmc, const T* rxf, const int* rxc, const T* lhs, const T* rhs,    \
                     T* lcand, T* ucand, const bool* go, int64_t n_chunks, int k, float int_eps,  \
                     float inf, cudaStream_t stream) {                                            \
    return launch_candidates(val, lb_g, ub_g, ii, rmf, rmc, rxf, rxc, lhs, rhs, lcand, ucand, go, \
                             n_chunks, k, T(int_eps), T(inf), stream);                            \
  }                                                                                               \
  int fused_round_##S(const T* val, const T* lb_g, const T* ub_g, const int8_t* ii, const T* lhs, \
                      const T* rhs, T* lcand, T* ucand, const bool* go, int64_t n_chunks, int k,  \
                      float int_eps, float inf, cudaStream_t stream) {                            \
    return launch_fused_round(val, lb_g, ub_g, ii, lhs, rhs, lcand, ucand, go, n_chunks, k,       \
                              T(int_eps), T(inf), stream);                                        \
  }

extern "C" {

HALF_ENTRIES(bf16, Bf16)
HALF_COMPACT_ENTRIES(bf16c, Bf16)
HALF_ENTRIES(f16, F16)

}  // extern "C"
