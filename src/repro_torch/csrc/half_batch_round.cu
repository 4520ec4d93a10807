// Hopper (sm_90a) kernels of the 16-bit value types on the batched, node
// and service rounds: bfloat16 and float16 forms of every kernel those
// rounds launch beyond the single-instance ones of half_round.cu.
//
//   batched_fused_scatter_round_{bf16,f16}   (#8) over a packed batch, int32
//                                            ids (the reference's packed batch
//                                            never narrows them)
//   node_fused_scatter_round_{bf16,bf16c,f16} (#10)
//   node_activities_gather_{bf16,bf16c,f16}  A' over a node batch
//   node_combine_chunk_partials_{bf16,f16}   the long-row combine over a node
//                                            batch
//   node_candidates_scatter_{bf16,bf16c,f16} E over a node batch
//   apply_updates_batch_{bf16,f16}           (#9)
//   apply_updates_batch_stop_{bf16,f16}      (#9) with the early stop's
//                                            per-row measure
//   node_slab_partials_{bf16,f16}            (#13)
//   node_slab_scatter_{bf16,f16}             the first launch of #14
//   slab_merge_rows_stop_{bf16,f16}          #15 over a batch's or node
//                                            batch's planes with the early
//                                            stop's per-row measure
//   record_round_batch_{bf16,f16}            the telemetry's batched record
//                                            kernel (no Pallas twin)
//
// The node-batched A', combine and E have no Pallas twin: the reference
// vmaps its jnp round there (src/repro/kernels/ops.py:2031).  #15 without
// a stop (its batched walk and grid) and the straddle combine over a node
// batch's active planes run half_round.cu's slab_merge and
// straddle_combine entries, whose launchers take both.  The `c` forms read
// the compact index streams of a bfloat16 prep whose padded columns fit
// int16 (int16 columns, int8 marks), as the float32 tier's do; float16
// preps never hold them (the reference compacts on _is_low_precision,
// which leaves float16 out), and the slab kernels take int32 ids at every
// type.
//
// Each is the float64 kernel's template (batch_round.cuh, slab_round.cuh,
// record_round.cuh, round_common.cuh) instantiated at round_common.cuh's
// Bf16 or F16, as half_round.cu's are: the values are stored in 2 bytes and
// every operation runs in float and rounds to the type at once; a chunk's
// activity partials accumulate in float in the kernels' fixed order
// (ref.warp_order_sum) and round once; the node combine rounds after every
// add, in chunk order, as the reference's segment_sum does.  #9's and #15's
// per-row measure (RowStopFlags, WindowStopFlags) sums its terms in float
// (float partials, the rows' sums in ref.merge_order_sum's order) and
// rounds each row's measure to the type once.  The scalars eps, int_eps,
// inf, outward and feas_eps arrive as floats holding 16-bit values (the
// wrappers round them: at float16 eps and feas_eps are 0 and inf is inf).
//
// #8, #10, the node E and #14's scatter reduce into float32 planes by the
// 32-bit integer atomics (a 16-bit candidate widens to float exactly); #9
// and #15 narrow them back exactly and hand them back at the sentinels.
//
// Bound on the H100: as the float64 forms', at 2 B a value (the compact
// forms 2 B a column and 1 B a mark), 4 B per accumulator entry and per
// stop partial.
//
// Build with --fmad=false (kernels/_build.py).  Every entry point returns
// cudaGetLastError() after its launch.

#include "batch_round.cuh"
#include "record_round.cuh"
#include "slab_round.cuh"

// The entries of value type T (suffix S) with int32 ids.
#define HALF_BATCH_ENTRIES(S, T)                                                                  \
  int batched_fused_scatter_round_##S(const T* val, const int* col, const int* ii,                \
                                      const int* clen, const T* lhs, const T* rhs, const T* lb,   \
                                      const T* ub, const int64_t* start, const bool* active,      \
                                      float* best_l, float* best_u, int64_t n_chunks, int k,      \
                                      int max_len, int64_t bsz, int64_t n_pad, float int_eps,     \
                                      float inf, cudaStream_t stream) {                           \
    return launch_batched_fused_scatter_round(val, col, ii, clen, lhs, rhs, lb, ub, start,        \
                                              active, best_l, best_u, n_chunks, k, max_len, bsz,  \
                                              n_pad, T(int_eps), T(inf), stream);                 \
  }                                                                                               \
  int node_fused_scatter_round_##S(const T* val, const int* col, const int* ii, const int* clen,  \
                                   const T* lhs, const T* rhs, const T* lb, const T* ub,          \
                                   const bool* active, float* best_l, float* best_u,              \
                                   int64_t n_chunks, int k, int max_len, int64_t bsz,             \
                                   int64_t n_pad, float int_eps, float inf,                       \
                                   cudaStream_t stream) {                                         \
    return launch_node_fused_scatter_round(val, col, ii, clen, lhs, rhs, lb, ub, active, best_l,  \
                                           best_u, n_chunks, k, max_len, bsz, n_pad,              \
                                           T(int_eps), T(inf), stream);                           \
  }                                                                                               \
  int node_activities_gather_##S(const T* val, const int* col, const int* clen, const T* lb,      \
                                 const T* ub, const bool* active, T* mf, int* mc, T* xf, int* xc, \
                                 int64_t n_chunks, int k, int max_len, int64_t bsz,               \
                                 int64_t n_pad, float inf, cudaStream_t stream) {                 \
    return launch_node_activities_gather(val, col, clen, lb, ub, active, mf, mc, xf, xc,          \
                                         n_chunks, k, max_len, bsz, n_pad, T(inf), stream);       \
  }                                                                                               \
  int node_combine_chunk_partials_##S(const T* mf, const int* mc, const T* xf, const int* xc,     \
                                      const int64_t* row_start, const int* short_seg,             \
                                      const int* long_seg, const bool* active, T* omf, int* omc,  \
                                      T* oxf, int* oxc, int64_t n_short, int64_t n_long,          \
                                      int64_t n_chunks, int64_t bsz, cudaStream_t stream) {       \
    return launch_node_combine_chunk_partials(mf, mc, xf, xc, row_start, short_seg, long_seg,     \
                                              active, omf, omc, oxf, oxc, n_short, n_long,        \
                                              n_chunks, bsz, stream);                             \
  }                                                                                               \
  int node_candidates_scatter_##S(const T* val, const int* col, const int* ii, const int* clen,   \
                                  const T* rmf, const int* rmc, const T* rxf, const int* rxc,     \
                                  const T* lhs, const T* rhs, const T* lb, const T* ub,           \
                                  const bool* active, float* best_l, float* best_u,               \
                                  int64_t n_chunks, int k, int max_len, int64_t bsz,              \
                                  int64_t n_pad, float int_eps, float inf, cudaStream_t stream) { \
    return launch_node_candidates_scatter(val, col, ii, clen, rmf, rmc, rxf, rxc, lhs, rhs, lb,   \
                                          ub, active, best_l, best_u, n_chunks, k, max_len, bsz,  \
                                          n_pad, T(int_eps), T(inf), stream);                     \
  }                                                                                               \
  int apply_updates_batch_##S(T* lb, T* ub, float* best_l, float* best_u, const bool* active,     \
                              bool* changed, bool* clear, int64_t bsz, int64_t n_pad, float eps,  \
                              float inf, float outward, cudaStream_t stream) {                    \
    return launch_apply_updates_batch(lb, ub, best_l, best_u, active, changed, clear, bsz, n_pad, \
                                      T(eps), T(inf), T(outward), stream);                        \
  }                                                                                               \
  int apply_updates_batch_stop_##S(T* lb, T* ub, float* best_l, float* best_u,                    \
                                   const bool* active, bool* changed, bool* clear,                \
                                   float* partials, T* prog, int* ticket, int64_t bsz,            \
                                   int64_t n_pad, float eps, float inf, float outward,            \
                                   cudaStream_t stream) {                                         \
    return launch_apply_updates_batch_stop(lb, ub, best_l, best_u, active, changed, clear,        \
                                           partials, prog, ticket, bsz, n_pad, T(eps), T(inf),    \
                                           T(outward), stream);                                   \
  }                                                                                               \
  int node_slab_partials_##S(const T* val, const int* col, const int* clen, const int* tile_slab, \
                             const bool* active, const T* lb, const T* ub, T* mf, int* mc, T* xf, \
                             int* xc, int64_t n_chunks, int r, int k, int max_len, int64_t bsz,   \
                             int64_t width, int64_t slab, float inf, cudaStream_t stream) {       \
    return launch_node_slab_partials(val, col, clen, tile_slab, active, lb, ub, mf, mc, xf, xc,   \
                                     n_chunks, r, k, max_len, bsz, width, slab, T(inf), stream);  \
  }                                                                                               \
  int node_slab_scatter_##S(const T* val, const int* col, const int* ii, const int* clen,         \
                            const int* done, const T* smf, const int* smc, const T* sxf,          \
                            const int* sxc, const T* lhs, const T* rhs, const int* tile_slab,     \
                            const bool* active, const T* lb, const T* ub, float* best_l,          \
                            float* best_u, int64_t n_chunks, int r, int k, int max_len,           \
                            int64_t bsz, int64_t width, int64_t slab, float int_eps, float inf,   \
                            cudaStream_t stream) {                                                \
    return launch_node_slab_scatter(val, col, ii, clen, done, smf, smc, sxf, sxc, lhs, rhs,       \
                                    tile_slab, active, lb, ub, best_l, best_u, n_chunks, r, k,    \
                                    max_len, bsz, width, slab, T(int_eps), T(inf), stream);       \
  }                                                                                               \
  int slab_merge_rows_stop_##S(T* lb, T* ub, float* best_l, float* best_u, const bool* active,    \
                               int* flags, int* clear, float* partials, T* prog, int* ticket,     \
                               int64_t bsz, int64_t width, int64_t slab, float eps, float inf,    \
                               float outward, cudaStream_t stream) {                              \
    return launch_slab_merge_rows_stop(lb, ub, best_l, best_u, active, flags, clear, partials,    \
                                       prog, ticket, bsz, width, slab, T(eps), T(inf),            \
                                       T(outward), stream);                                       \
  }                                                                                               \
  int record_round_batch_##S(const T* lb, const T* ub, const T* prog, const bool* ran,            \
                             const int* rounds, const int* flat, T* ring, int* ticks,             \
                             int* stop_round, int* infeas_round, int* scratch, int64_t bsz,       \
                             int64_t n, int cap, int patience, float feas_eps,                    \
                             cudaStream_t stream) {                                               \
    return launch_record_round_batch(lb, ub, prog, ran, rounds, flat, ring, ticks, stop_round,    \
                                     infeas_round, scratch, bsz, n, cap, patience, T(feas_eps),   \
                                     stream);                                                     \
  }

// The compact forms of value type T (suffix S): int16 columns, int8 marks.
#define HALF_BATCH_COMPACT_ENTRIES(S, T)                                                          \
  int node_fused_scatter_round_##S(const T* val, const int16_t* col, const int8_t* ii,            \
                                   const int* clen, const T* lhs, const T* rhs, const T* lb,      \
                                   const T* ub, const bool* active, float* best_l,                \
                                   float* best_u, int64_t n_chunks, int k, int max_len,           \
                                   int64_t bsz, int64_t n_pad, float int_eps, float inf,          \
                                   cudaStream_t stream) {                                         \
    return launch_node_fused_scatter_round(val, col, ii, clen, lhs, rhs, lb, ub, active, best_l,  \
                                           best_u, n_chunks, k, max_len, bsz, n_pad,              \
                                           T(int_eps), T(inf), stream);                           \
  }                                                                                               \
  int node_activities_gather_##S(const T* val, const int16_t* col, const int* clen, const T* lb,  \
                                 const T* ub, const bool* active, T* mf, int* mc, T* xf, int* xc, \
                                 int64_t n_chunks, int k, int max_len, int64_t bsz,               \
                                 int64_t n_pad, float inf, cudaStream_t stream) {                 \
    return launch_node_activities_gather(val, col, clen, lb, ub, active, mf, mc, xf, xc,          \
                                         n_chunks, k, max_len, bsz, n_pad, T(inf), stream);       \
  }                                                                                               \
  int node_candidates_scatter_##S(const T* val, const int16_t* col, const int8_t* ii,             \
                                  const int* clen, const T* rmf, const int* rmc, const T* rxf,    \
                                  const int* rxc, const T* lhs, const T* rhs, const T* lb,        \
                                  const T* ub, const bool* active, float* best_l, float* best_u,  \
                                  int64_t n_chunks, int k, int max_len, int64_t bsz,              \
                                  int64_t n_pad, float int_eps, float inf, cudaStream_t stream) { \
    return launch_node_candidates_scatter(val, col, ii, clen, rmf, rmc, rxf, rxc, lhs, rhs, lb,   \
                                          ub, active, best_l, best_u, n_chunks, k, max_len, bsz,  \
                                          n_pad, T(int_eps), T(inf), stream);                     \
  }

extern "C" {

HALF_BATCH_ENTRIES(bf16, Bf16)
HALF_BATCH_COMPACT_ENTRIES(bf16c, Bf16)
HALF_BATCH_ENTRIES(f16, F16)

}  // extern "C"
