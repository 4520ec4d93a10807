// Hopper (sm_90a) kernels of the fused propagation round (paper Alg. 3).
//
// Four kernels, each the CUDA counterpart of one Pallas kernel of the JAX
// package (src/repro/kernels/prop_round.py) and held against the same
// plain-PyTorch oracle (src/repro_torch/kernels/ref.py):
//
//   fused_scatter_round  (D)  bound gather, row activities with infinity
//                             counters, candidates, integrality rounding and
//                             the column max/min, for rows that fit one chunk
//   activities_gather    (A') per-chunk activity partials, for rows that
//                             span chunks
//   candidates_scatter   (E)  candidates from completed row aggregates, then
//                             the column max/min
//   apply_updates        (F)  the bound merge, in place, with a changed flag
//
// Layout: block-ELL tiles (T, R, K) flattened to T*R chunks of K slots.  One
// warp owns one chunk; each lane walks the slots lane, lane+32, ... so a
// warp's loads of val/col are coalesced.  Row sums are reduced by warp
// shuffles.  The TPU kernels' one-hot gather becomes an indexed load (the
// two (n_pad,) bound vectors stay in L2), and their one-hot column scatter
// becomes a double-precision atomic max/min (compare-and-swap loop on the
// value, so -0.0 and +0.0 compare equal, as they do in the oracle).  Max and
// min do not depend on order, so the scatter is exact.
//
// Build with --fmad=false: the activity products and the merge's
// old + eps * max(1, |old|) must round like the oracle's separate multiply
// and add.  The candidate chain is division-first and has no multiply
// feeding an add.
//
// Every entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarp * kWarpsPerBlock;

struct Slot {
  bool pos, min_inf, max_inf;
  double bmin, bmax;
};

// tile_contributions of one real nonzero (val != 0; padding is skipped
// before its col is read).
__device__ __forceinline__ Slot load_slot(double v, int c, const double* __restrict__ lb,
                                          const double* __restrict__ ub, double inf) {
  Slot s;
  s.pos = v > 0.0;
  const double l = lb[c], u = ub[c];
  s.bmin = s.pos ? l : u;
  s.bmax = s.pos ? u : l;
  s.min_inf = fabs(s.bmin) >= inf;
  s.max_inf = fabs(s.bmax) >= inf;
  return s;
}

__device__ __forceinline__ double warp_sum(double x) {
  for (int off = kWarp / 2; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ int warp_sum(int x) {
  for (int off = kWarp / 2; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

struct RowAgg {
  double mf, xf;
  int mc, xc;
};

// tile_row_aggregates of one chunk; every lane of the warp gets the result.
__device__ __forceinline__ RowAgg chunk_aggregates(const double* __restrict__ val,
                                                   const int* __restrict__ col,
                                                   const double* __restrict__ lb,
                                                   const double* __restrict__ ub,
                                                   int64_t base, int k, int lane, double inf) {
  RowAgg a{0.0, 0.0, 0, 0};
  for (int j = lane; j < k; j += kWarp) {
    const double v = val[base + j];
    if (v == 0.0) continue;  // padding adds nothing; its col is never read
    const Slot s = load_slot(v, col[base + j], lb, ub, inf);
    if (s.min_inf) a.mc += 1; else a.mf += v * s.bmin;
    if (s.max_inf) a.xc += 1; else a.xf += v * s.bmax;
  }
  a.mf = warp_sum(a.mf);
  a.xf = warp_sum(a.xf);
  a.mc = warp_sum(a.mc);
  a.xc = warp_sum(a.xc);
  return a;
}

__device__ __forceinline__ void atomic_max_f64(double* addr, double v) {
  unsigned long long* a = reinterpret_cast<unsigned long long*>(addr);
  unsigned long long old = *a;
  while (v > __longlong_as_double(old)) {
    const unsigned long long assumed = old;
    old = atomicCAS(a, assumed, __double_as_longlong(v));
    if (old == assumed) break;
  }
}

__device__ __forceinline__ void atomic_min_f64(double* addr, double v) {
  unsigned long long* a = reinterpret_cast<unsigned long long*>(addr);
  unsigned long long old = *a;
  while (v < __longlong_as_double(old)) {
    const unsigned long long assumed = old;
    old = atomicCAS(a, assumed, __double_as_longlong(v));
    if (old == assumed) break;
  }
}

__device__ __forceinline__ double clip(double x, double inf) { return fmin(fmax(x, -inf), inf); }

// tile_candidates of one chunk followed by the column max/min.  Slots whose
// candidate is the sentinel (padding, invalid residual or side) skip the
// atomic: the accumulators start at the sentinel, so skipping is exact.
__device__ __forceinline__ void chunk_candidates_scatter(
    const double* __restrict__ val, const int* __restrict__ col, const int* __restrict__ ii,
    const double* __restrict__ lb, const double* __restrict__ ub, const RowAgg& a, double lhs,
    double rhs, double* best_l, double* best_u, int64_t base, int k, int lane, double int_eps,
    double inf) {
  for (int j = lane; j < k; j += kWarp) {
    const double v = val[base + j];
    if (v == 0.0) continue;  // padding: both candidates are the sentinel
    const int c = col[base + j];  // col and is_int are read at nonzeros only
    const Slot s = load_slot(v, c, lb, ub, inf);
    const bool ok_min = s.min_inf ? a.mc == 1 : a.mc == 0;
    const bool ok_max = s.max_inf ? a.xc == 1 : a.xc == 0;
    const double inc_min = s.min_inf ? 0.0 : s.bmin;
    const double inc_max = s.max_inf ? 0.0 : s.bmax;
    const double q_min = (rhs - a.mf) / v + inc_min;
    const double q_max = (lhs - a.xf) / v + inc_max;
    double lc = s.pos ? q_max : q_min;
    double uc = s.pos ? q_min : q_max;
    const bool valid_l = s.pos ? (lhs > -inf && ok_max) : (rhs < inf && ok_min);
    const bool valid_u = s.pos ? (rhs < inf && ok_min) : (lhs > -inf && ok_max);
    lc = valid_l ? clip(lc, inf) : -inf;
    uc = valid_u ? clip(uc, inf) : inf;
    if (ii[base + j] != 0) {
      if (fabs(lc) < inf) lc = ceil(lc - int_eps);
      if (fabs(uc) < inf) uc = floor(uc + int_eps);
    }
    if (lc > -inf) atomic_max_f64(best_l + c, lc);
    if (uc < inf) atomic_min_f64(best_u + c, uc);
  }
}

__global__ void __launch_bounds__(kThreads)
fused_scatter_round_kernel(const double* __restrict__ val, const int* __restrict__ col,
                           const int* __restrict__ ii, const double* __restrict__ lhs,
                           const double* __restrict__ rhs, const double* __restrict__ lb,
                           const double* __restrict__ ub, double* best_l, double* best_u,
                           int64_t n_chunks, int k, double int_eps, double inf) {
  const int64_t chunk = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  if (chunk >= n_chunks) return;
  const int lane = threadIdx.x % kWarp;
  const int64_t base = chunk * k;
  const RowAgg a = chunk_aggregates(val, col, lb, ub, base, k, lane, inf);
  chunk_candidates_scatter(val, col, ii, lb, ub, a, lhs[chunk], rhs[chunk], best_l, best_u,
                           base, k, lane, int_eps, inf);
}

__global__ void __launch_bounds__(kThreads)
activities_gather_kernel(const double* __restrict__ val, const int* __restrict__ col,
                         const double* __restrict__ lb, const double* __restrict__ ub,
                         double* __restrict__ mf, int* __restrict__ mc, double* __restrict__ xf,
                         int* __restrict__ xc, int64_t n_chunks, int k, double inf) {
  const int64_t chunk = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  if (chunk >= n_chunks) return;
  const int lane = threadIdx.x % kWarp;
  const RowAgg a = chunk_aggregates(val, col, lb, ub, chunk * k, k, lane, inf);
  if (lane == 0) {
    mf[chunk] = a.mf;
    mc[chunk] = a.mc;
    xf[chunk] = a.xf;
    xc[chunk] = a.xc;
  }
}

__global__ void __launch_bounds__(kThreads)
candidates_scatter_kernel(const double* __restrict__ val, const int* __restrict__ col,
                          const int* __restrict__ ii, const double* __restrict__ rmf,
                          const int* __restrict__ rmc, const double* __restrict__ rxf,
                          const int* __restrict__ rxc, const double* __restrict__ lhs,
                          const double* __restrict__ rhs, const double* __restrict__ lb,
                          const double* __restrict__ ub, double* best_l, double* best_u,
                          int64_t n_chunks, int k, double int_eps, double inf) {
  const int64_t chunk = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  if (chunk >= n_chunks) return;
  const int lane = threadIdx.x % kWarp;
  const RowAgg a{rmf[chunk], rxf[chunk], rmc[chunk], rxc[chunk]};
  chunk_candidates_scatter(val, col, ii, lb, ub, a, lhs[chunk], rhs[chunk], best_l, best_u,
                           chunk * k, k, lane, int_eps, inf);
}

__global__ void __launch_bounds__(kThreads)
apply_updates_kernel(double* __restrict__ lb, double* __restrict__ ub,
                     const double* __restrict__ best_l, const double* __restrict__ best_u,
                     bool* __restrict__ changed, int64_t n, double eps, double inf,
                     double outward) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const double l = lb[i], u = ub[i];
  double bl = best_l[i], bu = best_u[i];
  const bool take_l = bl > l + eps * fmax(1.0, fabs(l));
  const bool take_u = bu < u - eps * fmax(1.0, fabs(u));
  if (outward != 0.0) {
    bl = bl - outward * fmax(1.0, fabs(bl));
    bu = bu + outward * fmax(1.0, fabs(bu));
  }
  if (take_l) lb[i] = clip(bl, inf);
  if (take_u) ub[i] = clip(bu, inf);
  if (take_l || take_u) *changed = true;
}

unsigned int chunk_blocks(int64_t n_chunks) {
  return static_cast<unsigned int>((n_chunks + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

}  // namespace

extern "C" {

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

int fused_scatter_round(const double* val, const int* col, const int* ii, const double* lhs,
                        const double* rhs, const double* lb, const double* ub, double* best_l,
                        double* best_u, int64_t n_chunks, int k, double int_eps, double inf,
                        cudaStream_t stream) {
  fused_scatter_round_kernel<<<chunk_blocks(n_chunks), kThreads, 0, stream>>>(
      val, col, ii, lhs, rhs, lb, ub, best_l, best_u, n_chunks, k, int_eps, inf);
  return static_cast<int>(cudaGetLastError());
}

int activities_gather(const double* val, const int* col, const double* lb, const double* ub,
                      double* mf, int* mc, double* xf, int* xc, int64_t n_chunks, int k,
                      double inf, cudaStream_t stream) {
  activities_gather_kernel<<<chunk_blocks(n_chunks), kThreads, 0, stream>>>(
      val, col, lb, ub, mf, mc, xf, xc, n_chunks, k, inf);
  return static_cast<int>(cudaGetLastError());
}

int candidates_scatter(const double* val, const int* col, const int* ii, const double* rmf,
                       const int* rmc, const double* rxf, const int* rxc, const double* lhs,
                       const double* rhs, const double* lb, const double* ub, double* best_l,
                       double* best_u, int64_t n_chunks, int k, double int_eps, double inf,
                       cudaStream_t stream) {
  candidates_scatter_kernel<<<chunk_blocks(n_chunks), kThreads, 0, stream>>>(
      val, col, ii, rmf, rmc, rxf, rxc, lhs, rhs, lb, ub, best_l, best_u, n_chunks, k, int_eps,
      inf);
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

}  // extern "C"
