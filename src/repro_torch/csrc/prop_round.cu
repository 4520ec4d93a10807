// Hopper (sm_90a) kernels of the fused propagation round (paper Alg. 3), of
// its node-batch form and of the solver's node objective.
//
// Each kernel but the combine is the CUDA counterpart of one Pallas kernel
// of the JAX package (src/repro/kernels/prop_round.py); every kernel is held
// against a plain-PyTorch oracle (src/repro_torch/kernels/ref.py):
//
//   fused_scatter_round  (D)  bound gather, row activities with infinity
//                             counters, candidates, integrality rounding and
//                             the column max/min, for rows that fit one chunk
//   activities_gather    (A') per-chunk activity partials, for rows that
//                             span chunks
//   candidates_scatter   (E)  candidates from completed row aggregates, then
//                             the column max/min
//   apply_updates        (F)  the bound merge, in place, with a changed flag
//   combine_chunk_partials    the long-row combine of A' partials, left to
//                             right over each row's chunks (not a TPU
//                             kernel: the reference's XLA segment_sum)
//   node_fused_scatter_round  (#10) D over a node batch: one matrix, B bound
//                             planes, an active mask read on the device
//   batched_fused_scatter_round  (#8) D over a packed batch: each tile's
//                             instance routes it to its own row of the
//                             (B, n_pad) planes, an active mask read on the
//                             device skips converged instances and free slots
//   apply_updates_batch  (#9) F over (B, n_pad) planes with an active mask
//                             and a changed flag per row
//   node_objective       (#16) per node: objective bound, all-fixed and
//                             crossed flags, by a block reduction
//
// Layout: block-ELL tiles (T, R, K) flattened to T*R chunks of K slots.  A
// chunk is owned by a group of G lanes, G = K rounded up to a power of two
// and at most 32 (so a warp holds 32 / G chunks: four at K = 8); each lane
// walks the slots sl, sl + 32, ... (sl < G) so a group's loads of val/col
// are coalesced.  Row sums are reduced by shuffles within the group.  For
// K <= 16 the sum is the same as the one-warp-per-chunk butterfly of
// ref.warp_order_sum: lanes past K hold +0.0, and adding +0.0 to a lane sum
// (never -0.0, since each starts at +0.0) leaves it unchanged.  The group
// width is a template parameter, so the shuffles unroll.  The TPU kernels'
// one-hot gather becomes an indexed load (the (n_pad,) bound vectors stay
// in L2), and their one-hot column scatter
// becomes a double-precision atomic max/min (compare-and-swap loop on the
// value, so -0.0 and +0.0 compare equal, as they do in the oracle).  Max and
// min do not depend on order, so the scatter is exact.  The device code the
// chunk kernels share with slab_round.cu (lane groups, chunk aggregates,
// candidates + scatter, the one-column merge) is in round_common.cuh.
//
// Build with --fmad=false: the activity products and the merge's
// old + eps * max(1, |old|) must round like the oracle's separate multiply
// and add.  The candidate chain is division-first and has no multiply
// feeding an add.
//
// Every entry point returns cudaGetLastError() after its launch.

#include "round_common.cuh"

namespace {

template <int G>
__global__ void __launch_bounds__(kThreads)
fused_scatter_round_kernel(const double* __restrict__ val, const int* __restrict__ col,
                           const int* __restrict__ ii, const double* __restrict__ lhs,
                           const double* __restrict__ rhs, const double* __restrict__ lb,
                           const double* __restrict__ ub, double* best_l, double* best_u,
                           int64_t n_chunks, int k, double int_eps, double inf) {
  const Lanes L = lanes_for<G>(n_chunks);
  const int64_t base = L.chunk * k;
  const RowAgg a = chunk_aggregates<G>(val, col, lb, ub, base, L.live ? k : 0, L, inf);
  if (!L.live) return;
  chunk_candidates_scatter(val, col, ii, lb, ub, a, lhs[L.chunk], rhs[L.chunk], best_l, best_u,
                           base, k, L, int_eps, inf);
}

template <int G>
__global__ void __launch_bounds__(kThreads)
activities_gather_kernel(const double* __restrict__ val, const int* __restrict__ col,
                         const double* __restrict__ lb, const double* __restrict__ ub,
                         double* __restrict__ mf, int* __restrict__ mc, double* __restrict__ xf,
                         int* __restrict__ xc, int64_t n_chunks, int k, double inf) {
  const Lanes L = lanes_for<G>(n_chunks);
  const RowAgg a = chunk_aggregates<G>(val, col, lb, ub, L.chunk * k, L.live ? k : 0, L, inf);
  if (L.live && L.sl == 0) {
    mf[L.chunk] = a.mf;
    mc[L.chunk] = a.mc;
    xf[L.chunk] = a.xf;
    xc[L.chunk] = a.xc;
  }
}

template <int G>
__global__ void __launch_bounds__(kThreads)
candidates_scatter_kernel(const double* __restrict__ val, const int* __restrict__ col,
                          const int* __restrict__ ii, const double* __restrict__ rmf,
                          const int* __restrict__ rmc, const double* __restrict__ rxf,
                          const int* __restrict__ rxc, const double* __restrict__ lhs,
                          const double* __restrict__ rhs, const double* __restrict__ lb,
                          const double* __restrict__ ub, double* best_l, double* best_u,
                          int64_t n_chunks, int k, double int_eps, double inf) {
  const Lanes L = lanes_for<G>(n_chunks);
  if (!L.live) return;
  const int64_t c = L.chunk;
  const RowAgg a{rmf[c], rxf[c], rmc[c], rxc[c]};
  chunk_candidates_scatter(val, col, ii, lb, ub, a, lhs[c], rhs[c], best_l, best_u, c * k, k, L,
                           int_eps, inf);
}

__global__ void __launch_bounds__(kThreads)
apply_updates_kernel(double* __restrict__ lb, double* __restrict__ ub,
                     const double* __restrict__ best_l, const double* __restrict__ best_u,
                     bool* __restrict__ changed, int64_t n, double eps, double inf,
                     double outward) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (merge_one(lb, ub, best_l, best_u, i, eps, inf, outward)) *changed = true;
}

// One thread per row segment: its chunk partials summed left to right
// (chunks of a row are adjacent in the stream), then written back to every
// chunk of the row.  Fixed order on every run, unlike an atomic segment sum.
__global__ void __launch_bounds__(kThreads)
combine_chunk_partials_kernel(const double* __restrict__ mf, const int* __restrict__ mc,
                              const double* __restrict__ xf, const int* __restrict__ xc,
                              const int64_t* __restrict__ row_start, double* __restrict__ omf,
                              int* __restrict__ omc, double* __restrict__ oxf,
                              int* __restrict__ oxc, int64_t n_seg) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= n_seg) return;
  const int64_t s = row_start[r], e = row_start[r + 1];
  double a = 0.0, b = 0.0;
  int ca = 0, cb = 0;
  for (int64_t i = s; i < e; ++i) {
    a += mf[i];
    ca += mc[i];
    b += xf[i];
    cb += xc[i];
  }
  for (int64_t i = s; i < e; ++i) {
    omf[i] = a;
    omc[i] = ca;
    oxf[i] = b;
    oxc[i] = cb;
  }
}

// Kernel D for B nodes sharing one matrix.  Each warp reads the active mask
// 32 nodes at a time (one ballot) and visits only the active nodes; each
// gathers from and scatters into its own row of the (B, n_pad) planes, with
// D's arithmetic, so each row equals D's result for that node bit for bit.
template <int G>
__global__ void __launch_bounds__(kThreads)
node_fused_scatter_round_kernel(const double* __restrict__ val, const int* __restrict__ col,
                                const int* __restrict__ ii, const double* __restrict__ lhs,
                                const double* __restrict__ rhs, const double* __restrict__ lb,
                                const double* __restrict__ ub, const bool* __restrict__ active,
                                double* best_l, double* best_u, int64_t n_chunks, int k,
                                int64_t bsz, int64_t n_pad, double int_eps, double inf) {
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
      const RowAgg a = chunk_aggregates<G>(val, col, lb + row, ub + row, base, kk, L, inf);
      if (L.live)
        chunk_candidates_scatter(val, col, ii, lb + row, ub + row, a, lo, hi, best_l + row,
                                 best_u + row, base, k, L, int_eps, inf);
    }
  }
}

// Kernel D over a packed batch: one flat stream of T tiles of R chunks, tile t
// belonging to instance tile_inst[t] (its columns local to that instance's
// n_pad-wide window).  A lane group reads its chunk's instance and that
// instance's active flag; an inactive group loads nothing from the tiles,
// and a warp whose groups are all inactive returns at once.  Active groups
// gather from and scatter into their instance's rows with D's arithmetic,
// so each row equals D's result for that instance bit for bit.  Blocks run
// in no order, so nothing needs an instance's tiles to be contiguous.
template <int G>
__global__ void __launch_bounds__(kThreads)
batched_fused_scatter_round_kernel(const double* __restrict__ val, const int* __restrict__ col,
                                   const int* __restrict__ ii, const double* __restrict__ lhs,
                                   const double* __restrict__ rhs, const double* __restrict__ lb,
                                   const double* __restrict__ ub,
                                   const int* __restrict__ tile_inst,
                                   const bool* __restrict__ active, double* best_l,
                                   double* best_u, int64_t n_chunks, int r, int k, int64_t n_pad,
                                   double int_eps, double inf) {
  const Lanes L = lanes_for<G>(n_chunks);
  bool on = false;
  int64_t row = 0;
  if (L.live) {
    const int64_t inst = tile_inst[L.chunk / r];
    on = active[inst];
    row = inst * n_pad;
  }
  if (!__any_sync(0xffffffffu, on)) return;  // the whole warp: no shuffle follows
  const int64_t base = L.chunk * k;
  const RowAgg a = chunk_aggregates<G>(val, col, lb + row, ub + row, base, on ? k : 0, L, inf);
  if (!on) return;
  chunk_candidates_scatter(val, col, ii, lb + row, ub + row, a, lhs[L.chunk], rhs[L.chunk],
                           best_l + row, best_u + row, base, k, L, int_eps, inf);
}

// Kernel F over (B, n_pad) planes: grid (column blocks, B); the blocks of an
// inactive row return at once, so it is neither read nor written.
__global__ void __launch_bounds__(kThreads)
apply_updates_batch_kernel(double* __restrict__ lb, double* __restrict__ ub,
                           const double* __restrict__ best_l, const double* __restrict__ best_u,
                           const bool* __restrict__ active, bool* __restrict__ changed,
                           int64_t n_pad, double eps, double inf, double outward) {
  const int64_t b = blockIdx.y;
  if (!active[b]) return;
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= n_pad) return;
  if (merge_one(lb, ub, best_l, best_u, b * n_pad + j, eps, inf, outward)) changed[b] = true;
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

}  // namespace

extern "C" {

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

int fused_scatter_round(const double* val, const int* col, const int* ii, const double* lhs,
                        const double* rhs, const double* lb, const double* ub, double* best_l,
                        double* best_u, int64_t n_chunks, int k, double int_eps, double inf,
                        cudaStream_t stream) {
  LAUNCH_FOR_WIDTH(fused_scatter_round_kernel, k, n_chunks, stream, val, col, ii, lhs, rhs, lb,
                   ub, best_l, best_u, n_chunks, k, int_eps, inf);
  return static_cast<int>(cudaGetLastError());
}

int activities_gather(const double* val, const int* col, const double* lb, const double* ub,
                      double* mf, int* mc, double* xf, int* xc, int64_t n_chunks, int k,
                      double inf, cudaStream_t stream) {
  LAUNCH_FOR_WIDTH(activities_gather_kernel, k, n_chunks, stream, val, col, lb, ub, mf, mc, xf,
                   xc, n_chunks, k, inf);
  return static_cast<int>(cudaGetLastError());
}

int candidates_scatter(const double* val, const int* col, const int* ii, const double* rmf,
                       const int* rmc, const double* rxf, const int* rxc, const double* lhs,
                       const double* rhs, const double* lb, const double* ub, double* best_l,
                       double* best_u, int64_t n_chunks, int k, double int_eps, double inf,
                       cudaStream_t stream) {
  LAUNCH_FOR_WIDTH(candidates_scatter_kernel, k, n_chunks, stream, val, col, ii, rmf, rmc, rxf,
                   rxc, lhs, rhs, lb, ub, best_l, best_u, n_chunks, k, int_eps, inf);
  return static_cast<int>(cudaGetLastError());
}

int apply_updates(double* lb, double* ub, const double* best_l, const double* best_u,
                  bool* changed, int64_t n, double eps, double inf, double outward,
                  cudaStream_t stream) {
  const unsigned int blocks = static_cast<unsigned int>((n + kThreads - 1) / kThreads);
  apply_updates_kernel<<<blocks, kThreads, 0, stream>>>(lb, ub, best_l, best_u, changed, n, eps,
                                                        inf, outward);
  return static_cast<int>(cudaGetLastError());
}

int combine_chunk_partials(const double* mf, const int* mc, const double* xf, const int* xc,
                           const int64_t* row_start, double* omf, int* omc, double* oxf,
                           int* oxc, int64_t n_seg, cudaStream_t stream) {
  const unsigned int blocks = static_cast<unsigned int>((n_seg + kThreads - 1) / kThreads);
  combine_chunk_partials_kernel<<<blocks, kThreads, 0, stream>>>(mf, mc, xf, xc, row_start, omf,
                                                                 omc, oxf, oxc, n_seg);
  return static_cast<int>(cudaGetLastError());
}

int node_fused_scatter_round(const double* val, const int* col, const int* ii, const double* lhs,
                             const double* rhs, const double* lb, const double* ub,
                             const bool* active, double* best_l, double* best_u,
                             int64_t n_chunks, int k, int64_t bsz, int64_t n_pad,
                             double int_eps, double inf, cudaStream_t stream) {
  LAUNCH_FOR_WIDTH(node_fused_scatter_round_kernel, k, n_chunks, stream, val, col, ii, lhs, rhs,
                   lb, ub, active, best_l, best_u, n_chunks, k, bsz, n_pad, int_eps, inf);
  return static_cast<int>(cudaGetLastError());
}

int batched_fused_scatter_round(const double* val, const int* col, const int* ii,
                                const double* lhs, const double* rhs, const double* lb,
                                const double* ub, const int* tile_inst, const bool* active,
                                double* best_l, double* best_u, int64_t n_chunks, int r, int k,
                                int64_t n_pad, double int_eps, double inf, cudaStream_t stream) {
  LAUNCH_FOR_WIDTH(batched_fused_scatter_round_kernel, k, n_chunks, stream, val, col, ii, lhs, rhs,
                   lb, ub, tile_inst, active, best_l, best_u, n_chunks, r, k, n_pad, int_eps,
                   inf);
  return static_cast<int>(cudaGetLastError());
}

int apply_updates_batch(double* lb, double* ub, const double* best_l, const double* best_u,
                        const bool* active, bool* changed, int64_t bsz, int64_t n_pad,
                        double eps, double inf, double outward, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned int>((n_pad + kThreads - 1) / kThreads),
                  static_cast<unsigned int>(bsz));
  apply_updates_batch_kernel<<<grid, kThreads, 0, stream>>>(lb, ub, best_l, best_u, active,
                                                            changed, n_pad, eps, inf, outward);
  return static_cast<int>(cudaGetLastError());
}

int node_objective(const double* lb, const double* ub, const double* c, const bool* is_int,
                   const bool* valid, double* obj, bool* fixed, bool* crossed, int64_t bsz,
                   int64_t n_pad, double feas_eps, double inf, cudaStream_t stream) {
  node_objective_kernel<<<static_cast<unsigned int>(bsz), kObjThreads, 0, stream>>>(
      lb, ub, c, is_int, valid, obj, fixed, crossed, n_pad, feas_eps, inf);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
