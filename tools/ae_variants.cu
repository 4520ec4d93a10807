// Timed variants of kernels A' (activities_gather) and E (candidates_scatter)
// at K = 128: which of their traits holds each back on the card.  Built and
// driven by tools/ae_variants.py; not part of the port's kernel library.
//
// A' variants (a_variant):
//   0  the kernel before the redesign: chunk_aggregates, one dependent
//      val -> col -> lb/ub chain per stride, every slot of the chunk walked
//   1  the new helpers, one stride per batch, every slot walked
//   2  four strides per batch (loads in flight), every slot walked
//   3  one stride per batch, stopped at the chunk's length
//   4  four strides per batch, stopped at the length (the port's kernel)
//   5  as 4, the two bounds of a column read as one 16-byte pair from an
//      (n_pad, 2) interleaved copy (one gather per nonzero instead of two)
//   6  as 5, at most 32 registers a thread (eight blocks, 64 warps an SM)
//   7  as 5, at most 40 registers a thread (six blocks an SM)
// E variants (e_variant):
//   0  the kernel before the redesign: chunk_candidates_scatter, one chain
//      per stride, every slot, compare-and-swap max/min
//   1  four strides, stopped at the length, compare-and-swap
//   2  four strides, stopped, integer atomics behind an L2 pre-check (the
//      port's kernel)
//   3  four strides, stopped, integer atomics with no pre-check
//   4  one stride per batch, every slot, integer atomics behind the pre-check
//   5  as 2, the bounds read as one 16-byte pair (interleaved copy)
//   6  as 3, the bounds read as one pair
//   7  as 5, the pre-check read through L1 (a stale line only costs an
//      atomic that does not win)
//   8  as 5, at most 32 registers a thread
//   9  as 5, at most 64 registers a thread (four blocks an SM)
//  10  as 5, at most 80 registers a thread (three blocks an SM)
//  11  as 5, at most 48 registers a thread (five blocks an SM)
//  12  as 5, at most 40 registers a thread (six blocks an SM)

#include "../src/repro_torch/csrc/round_common.cuh"

namespace {

constexpr int G = kWarp;  // K > 16: one warp per chunk

template <int U, bool LEN>
__global__ void __launch_bounds__(kThreads)
a_kernel(const double* __restrict__ val, const int* __restrict__ col, const int* __restrict__ clen,
         const double* __restrict__ lb, const double* __restrict__ ub, double* __restrict__ mf,
         int* __restrict__ mc, double* __restrict__ xf, int* __restrict__ xc, int64_t n_chunks,
         int k, double inf) {
  const Lanes L = lanes_for<G>(n_chunks);
  const int64_t base = L.chunk * k;
  const int kk = L.live ? k : 0;
  const int len = !L.live ? 0 : LEN ? clen[L.chunk] : k;
  RowAgg a{0.0, 0.0, 0, 0};
  for (int j0 = 0; j0 < kk; j0 += U * kWarp) {
    if (j0 > 0 && j0 >= len) break;
    Loaded<U> s;
    load_strides(s, val, col, nullptr, base, j0, len, kk, L.sl);
    add_strides(a, s, SplitBounds{lb, ub}, inf);
  }
  a = group_reduce<G>(a);
  if (L.live && L.sl == 0) {
    mf[L.chunk] = a.mf;
    mc[L.chunk] = a.mc;
    xf[L.chunk] = a.xf;
    xc[L.chunk] = a.xc;
  }
}

template <int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
a_pair(const double* __restrict__ val, const int* __restrict__ col, const int* __restrict__ clen,
       const double2* __restrict__ lub, double* __restrict__ mf, int* __restrict__ mc,
       double* __restrict__ xf, int* __restrict__ xc, int64_t n_chunks, int k, double inf) {
  constexpr int U = 4;
  const Lanes L = lanes_for<G>(n_chunks);
  const int64_t base = L.chunk * k;
  const int kk = L.live ? k : 0;
  const int len = L.live ? clen[L.chunk] : 0;
  RowAgg a{0.0, 0.0, 0, 0};
  for (int j0 = 0; j0 < kk; j0 += U * kWarp) {
    if (j0 > 0 && j0 >= len) break;
    Loaded<U> s;
    load_strides(s, val, col, nullptr, base, j0, len, kk, L.sl);
    add_strides(a, s, PairedBounds{lub}, inf);
  }
  a = group_reduce<G>(a);
  if (L.live && L.sl == 0) {
    mf[L.chunk] = a.mf;
    mc[L.chunk] = a.mc;
    xf[L.chunk] = a.xf;
    xc[L.chunk] = a.xc;
  }
}

__global__ void __launch_bounds__(kThreads)
a_old(const double* __restrict__ val, const int* __restrict__ col, const double* __restrict__ lb,
      const double* __restrict__ ub, double* __restrict__ mf, int* __restrict__ mc,
      double* __restrict__ xf, int* __restrict__ xc, int64_t n_chunks, int k, double inf) {
  const Lanes L = lanes_for<G>(n_chunks);
  const RowAgg a = chunk_aggregates<G>(val, col, lb, ub, L.chunk * k, L.live ? k : 0, L, inf);
  if (L.live && L.sl == 0) {
    mf[L.chunk] = a.mf;
    mc[L.chunk] = a.mc;
    xf[L.chunk] = a.xf;
    xc[L.chunk] = a.xc;
  }
}

// ATOM: 0 compare-and-swap, 1 integer atomics behind the pre-check, 2 integer
// atomics without it, 3 integer atomics behind a pre-check through L1.
template <int ATOM>
__device__ __forceinline__ void put(double* bl, double* bu, const Cands& q, double inf) {
  if (q.lc > -inf) {
    if (ATOM == 0) {
      atomic_max_f64(bl, q.lc);
    } else if (ATOM == 1) {
      red_max(bl, q.lc);
    } else if (ATOM == 3) {
      const double v = q.lc == 0.0 ? 0.0 : q.lc;
      if (v > *bl) {
        const long long bits = __double_as_longlong(v);
        if (v >= 0.0) atomicMax(reinterpret_cast<long long*>(bl), bits);
        else atomicMin(reinterpret_cast<unsigned long long*>(bl), static_cast<unsigned long long>(bits));
      }
    } else {
      const double v = q.lc == 0.0 ? 0.0 : q.lc;
      const long long bits = __double_as_longlong(v);
      if (v >= 0.0) atomicMax(reinterpret_cast<long long*>(bl), bits);
      else atomicMin(reinterpret_cast<unsigned long long*>(bl), static_cast<unsigned long long>(bits));
    }
  }
  if (q.uc < inf) {
    if (ATOM == 0) {
      atomic_min_f64(bu, q.uc);
    } else if (ATOM == 1) {
      red_min(bu, q.uc);
    } else if (ATOM == 3) {
      const double v = q.uc == 0.0 ? 0.0 : q.uc;
      if (v < *bu) {
        const long long bits = __double_as_longlong(v);
        if (v >= 0.0) atomicMin(reinterpret_cast<long long*>(bu), bits);
        else atomicMax(reinterpret_cast<unsigned long long*>(bu), static_cast<unsigned long long>(bits));
      }
    } else {
      const double v = q.uc == 0.0 ? 0.0 : q.uc;
      const long long bits = __double_as_longlong(v);
      if (v >= 0.0) atomicMin(reinterpret_cast<long long*>(bu), bits);
      else atomicMax(reinterpret_cast<unsigned long long*>(bu), static_cast<unsigned long long>(bits));
    }
  }
}

template <int U, bool LEN, int ATOM>
__global__ void __launch_bounds__(kThreads)
e_kernel(const double* __restrict__ val, const int* __restrict__ col, const int* __restrict__ ii,
         const int* __restrict__ clen, const double* __restrict__ rmf, const int* __restrict__ rmc,
         const double* __restrict__ rxf, const int* __restrict__ rxc,
         const double* __restrict__ lhs, const double* __restrict__ rhs,
         const double* __restrict__ lb, const double* __restrict__ ub, double* best_l,
         double* best_u, int64_t n_chunks, int k, double int_eps, double inf) {
  const Lanes L = lanes_for<G>(n_chunks);
  if (!L.live) return;
  const int64_t c = L.chunk;
  const RowAgg a{rmf[c], rxf[c], rmc[c], rxc[c]};
  const double lo = lhs[c], hi = rhs[c];
  const int len = LEN ? clen[c] : k;
  for (int j0 = 0; j0 < k; j0 += U * kWarp) {
    if (j0 > 0 && j0 >= len) break;
    Loaded<U> s;
    load_strides(s, val, col, ii, c * k, j0, len, k, L.sl);
    double l[U], h[U];
    gather_strides(s, SplitBounds{lb, ub}, l, h);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (s.v[u] == 0.0) continue;
      const Cands q = slot_candidates(s.v[u], make_slot(s.v[u], l[u], h[u], inf), a, lo, hi,
                                      s.m[u] != 0, int_eps, inf);
      put<ATOM>(best_l + s.c[u], best_u + s.c[u], q, inf);
    }
  }
}

template <int ATOM, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
e_pair(const double* __restrict__ val, const int* __restrict__ col, const int* __restrict__ ii,
       const int* __restrict__ clen, const double* __restrict__ rmf, const int* __restrict__ rmc,
       const double* __restrict__ rxf, const int* __restrict__ rxc,
       const double* __restrict__ lhs, const double* __restrict__ rhs,
       const double2* __restrict__ lub, double* best_l, double* best_u, int64_t n_chunks, int k,
       double int_eps, double inf) {
  constexpr int U = 4;
  const Lanes L = lanes_for<G>(n_chunks);
  if (!L.live) return;
  const int64_t c = L.chunk;
  const RowAgg a{rmf[c], rxf[c], rmc[c], rxc[c]};
  const double lo = lhs[c], hi = rhs[c];
  const int len = clen[c];
  for (int j0 = 0; j0 < k; j0 += U * kWarp) {
    if (j0 > 0 && j0 >= len) break;
    Loaded<U> s;
    load_strides(s, val, col, ii, c * k, j0, len, k, L.sl);
    double l[U], h[U];
    gather_strides(s, PairedBounds{lub}, l, h);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (s.v[u] == 0.0) continue;
      const Cands q = slot_candidates(s.v[u], make_slot(s.v[u], l[u], h[u], inf), a, lo, hi,
                                      s.m[u] != 0, int_eps, inf);
      put<ATOM>(best_l + s.c[u], best_u + s.c[u], q, inf);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
e_old(const double* __restrict__ val, const int* __restrict__ col, const int* __restrict__ ii,
      const double* __restrict__ rmf, const int* __restrict__ rmc, const double* __restrict__ rxf,
      const int* __restrict__ rxc, const double* __restrict__ lhs, const double* __restrict__ rhs,
      const double* __restrict__ lb, const double* __restrict__ ub, double* best_l,
      double* best_u, int64_t n_chunks, int k, double int_eps, double inf) {
  const Lanes L = lanes_for<G>(n_chunks);
  if (!L.live) return;
  const int64_t c = L.chunk;
  const RowAgg a{rmf[c], rxf[c], rmc[c], rxc[c]};
  chunk_candidates_scatter(val, col, ii, lb, ub, a, lhs[c], rhs[c], best_l, best_u, c * k, k, L,
                           int_eps, inf);
}

}  // namespace

extern "C" {

int a_variant(int variant, const double* val, const int* col, const int* clen, const double* lb,
              const double* ub, const double* lub, double* mf, int* mc, double* xf, int* xc,
              int64_t n_chunks, int k, double inf, cudaStream_t stream) {
  const double2* pairs = reinterpret_cast<const double2*>(lub);
  const unsigned int blocks = chunk_blocks(n_chunks, k);
  switch (variant) {
    case 0: a_old<<<blocks, kThreads, 0, stream>>>(val, col, lb, ub, mf, mc, xf, xc, n_chunks, k, inf); break;
    case 1: a_kernel<1, false><<<blocks, kThreads, 0, stream>>>(val, col, clen, lb, ub, mf, mc, xf, xc, n_chunks, k, inf); break;
    case 2: a_kernel<4, false><<<blocks, kThreads, 0, stream>>>(val, col, clen, lb, ub, mf, mc, xf, xc, n_chunks, k, inf); break;
    case 3: a_kernel<1, true><<<blocks, kThreads, 0, stream>>>(val, col, clen, lb, ub, mf, mc, xf, xc, n_chunks, k, inf); break;
    case 4: a_kernel<4, true><<<blocks, kThreads, 0, stream>>>(val, col, clen, lb, ub, mf, mc, xf, xc, n_chunks, k, inf); break;
    case 5: a_pair<1><<<blocks, kThreads, 0, stream>>>(val, col, clen, pairs, mf, mc, xf, xc, n_chunks, k, inf); break;
    case 6: a_pair<8><<<blocks, kThreads, 0, stream>>>(val, col, clen, pairs, mf, mc, xf, xc, n_chunks, k, inf); break;
    default: a_pair<6><<<blocks, kThreads, 0, stream>>>(val, col, clen, pairs, mf, mc, xf, xc, n_chunks, k, inf); break;
  }
  return static_cast<int>(cudaGetLastError());
}

int e_variant(int variant, const double* val, const int* col, const int* ii, const int* clen,
              const double* rmf, const int* rmc, const double* rxf, const int* rxc,
              const double* lhs, const double* rhs, const double* lb, const double* ub,
              const double* lub, double* best_l, double* best_u, int64_t n_chunks, int k,
              double int_eps, double inf, cudaStream_t stream) {
  const double2* pairs = reinterpret_cast<const double2*>(lub);
  const unsigned int blocks = chunk_blocks(n_chunks, k);
#define E_ARGS val, col, ii, clen, rmf, rmc, rxf, rxc, lhs, rhs, lb, ub, best_l, best_u, n_chunks, k, int_eps, inf
#define P_ARGS val, col, ii, clen, rmf, rmc, rxf, rxc, lhs, rhs, pairs, best_l, best_u, n_chunks, k, int_eps, inf
  switch (variant) {
    case 0: e_old<<<blocks, kThreads, 0, stream>>>(val, col, ii, rmf, rmc, rxf, rxc, lhs, rhs, lb, ub, best_l, best_u, n_chunks, k, int_eps, inf); break;
    case 1: e_kernel<4, true, 0><<<blocks, kThreads, 0, stream>>>(E_ARGS); break;
    case 2: e_kernel<4, true, 1><<<blocks, kThreads, 0, stream>>>(E_ARGS); break;
    case 3: e_kernel<4, true, 2><<<blocks, kThreads, 0, stream>>>(E_ARGS); break;
    case 4: e_kernel<1, false, 1><<<blocks, kThreads, 0, stream>>>(E_ARGS); break;
    case 5: e_pair<1, 1><<<blocks, kThreads, 0, stream>>>(P_ARGS); break;
    case 6: e_pair<2, 1><<<blocks, kThreads, 0, stream>>>(P_ARGS); break;
    case 7: e_pair<3, 1><<<blocks, kThreads, 0, stream>>>(P_ARGS); break;
    case 8: e_pair<1, 8><<<blocks, kThreads, 0, stream>>>(P_ARGS); break;
    case 9: e_pair<1, 4><<<blocks, kThreads, 0, stream>>>(P_ARGS); break;
    case 10: e_pair<1, 3><<<blocks, kThreads, 0, stream>>>(P_ARGS); break;
    case 11: e_pair<1, 5><<<blocks, kThreads, 0, stream>>>(P_ARGS); break;
    default: e_pair<1, 6><<<blocks, kThreads, 0, stream>>>(P_ARGS); break;
  }
#undef P_ARGS
#undef E_ARGS
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
