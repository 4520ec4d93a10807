// Device code shared by the chunk kernels of prop_round.cu and
// slab_round.cu: the lane groups that own a chunk, where a slot's bounds
// come from (its column, or pre-gathered tiles), the chunk's activity
// aggregates, its candidates with the column max/min scatter or stored per
// slot, one chunk's activity sums (chunk_sums, #13) and whole
// round with a single bound gather per nonzero (chunk_round, kernels D, #8,
// #10, #12 and #14), the active-only walk over (plane, item) pairs (#8, #9,
// #10, #13, #14, #15), the bound merge of one column, with or without
// handing the accumulator entry back (merge_reset), the merges' body (F,
// #9, #15) on the walk or on a (column block, row) grid, and the loop
// carry that F folds its flag into (CarryFlags), with the early stop's
// progress measure where one is armed (StopCarryFlags), and #9's per-row
// measure of the batched early stop (RowStopFlags, and #15's
// WindowStopFlags).  The routines the port's kernels run are templated on
// the value type T (double, float for the fp32 tier, or Lo16<F> for
// bfloat16 and float16: see Num<T>), the chunk routines also on the index
// types (int32 columns and marks, or the compact int16 / int8 streams);
// the double-only ones (chunk_candidates_scatter,
// atomic_max_f64 / atomic_min_f64, merge_one, merge_reset) are the
// "before" variants that tools/*_variants.cu time.
// See prop_round.cu for the layout and the rounding rules (--fmad=false,
// division-first candidates).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstddef>
#include <type_traits>

// A 16-bit value of format F (__nv_bfloat16 or __half), held as its bits.
// Its arithmetic runs in float and rounds to F (to nearest even) after
// every operation: float holds at least 2p + 2 bits of both formats, so
// rounding twice gives the once-rounded result, the per-operation rounding
// of the plain versions (PyTorch's at 16 bits, and XLA's for the
// reference).  Sums that the plain versions take in float32 (a chunk's
// activities, the merge's progress measure) accumulate in Num<T>::Acc.
template <typename F>
struct Lo16 {
  unsigned short bits;
  Lo16() = default;
  __host__ __device__ __forceinline__ Lo16(float x) {
    if constexpr (std::is_same_v<F, __half>) bits = __half_as_ushort(__float2half_rn(x));
    else bits = __bfloat16_as_ushort(__float2bfloat16_rn(x));
  }
  __host__ __device__ __forceinline__ float f() const {
    if constexpr (std::is_same_v<F, __half>) return __half2float(__ushort_as_half(bits));
    else return __bfloat162float(__ushort_as_bfloat16(bits));
  }
  __device__ __forceinline__ Lo16& operator+=(Lo16 b) { return *this = Lo16(f() + b.f()); }
};

using Bf16 = Lo16<__nv_bfloat16>;
using F16 = Lo16<__half>;

template <typename F>
__device__ __forceinline__ Lo16<F> operator+(Lo16<F> a, Lo16<F> b) {
  return Lo16<F>(a.f() + b.f());
}
template <typename F>
__device__ __forceinline__ Lo16<F> operator-(Lo16<F> a, Lo16<F> b) {
  return Lo16<F>(a.f() - b.f());
}
template <typename F>
__device__ __forceinline__ Lo16<F> operator*(Lo16<F> a, Lo16<F> b) {
  return Lo16<F>(a.f() * b.f());
}
template <typename F>
__device__ __forceinline__ Lo16<F> operator/(Lo16<F> a, Lo16<F> b) {
  return Lo16<F>(a.f() / b.f());
}
template <typename F>
__host__ __device__ __forceinline__ Lo16<F> operator-(Lo16<F> a) {
  a.bits ^= 0x8000u;
  return a;
}
template <typename F>
__device__ __forceinline__ bool operator<(Lo16<F> a, Lo16<F> b) { return a.f() < b.f(); }
template <typename F>
__device__ __forceinline__ bool operator>(Lo16<F> a, Lo16<F> b) { return a.f() > b.f(); }
template <typename F>
__device__ __forceinline__ bool operator<=(Lo16<F> a, Lo16<F> b) { return a.f() <= b.f(); }
template <typename F>
__device__ __forceinline__ bool operator>=(Lo16<F> a, Lo16<F> b) { return a.f() >= b.f(); }
template <typename F>
__device__ __forceinline__ bool operator==(Lo16<F> a, Lo16<F> b) { return a.f() == b.f(); }
template <typename F>
__device__ __forceinline__ bool operator!=(Lo16<F> a, Lo16<F> b) { return a.f() != b.f(); }

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarp * kWarpsPerBlock;

// The value types: float64 (the propagation contract), float32 (the fp32
// tier), bfloat16 and float16.  Pair: a column's two bounds as one vector
// load (ldg loads a value or a pair through the read-only path); SBits /
// UBits: the integer words of the order-preserving column max / min
// (64-bit for double, 32-bit for float); Plane: the value type of the
// column max / min planes the scatters reduce into, and Acc: the type the
// chunk sums and the progress measure accumulate in (both float for the
// 16-bit types, whose values widen to float exactly and narrow back
// exactly; T itself otherwise); wide(x): x as an Acc or Plane value;
// kExact: integrality rounding without the tier's slack
// (core.types.int_round_slack), float64's (and float16's: the reference
// gives it none) exact `ceil(l - int_eps)`.  A kernel does all its
// arithmetic in T: its scalars (eps, int_eps, inf, outward) arrive already
// rounded to T, as the reference's weakly typed Python scalars are.
template <typename T>
struct Num;

template <>
struct Num<double> {
  using Pair = double2;
  using SBits = long long;
  using UBits = unsigned long long;
  using Acc = double;
  using Plane = double;
  static constexpr bool kExact = true;
  static constexpr double kSlack = 0.0;
  __device__ static __forceinline__ Pair pair(double a, double b) { return make_double2(a, b); }
  __device__ static __forceinline__ SBits bits(double v) { return __double_as_longlong(v); }
  __device__ static __forceinline__ double ldg(const double* p) { return __ldg(p); }
  __device__ static __forceinline__ Pair ldg(const Pair* p) { return __ldg(p); }
  __device__ static __forceinline__ double wide(double x) { return x; }
};

template <>
struct Num<float> {
  using Pair = float2;
  using SBits = int;
  using UBits = unsigned int;
  using Acc = float;
  using Plane = float;
  static constexpr bool kExact = false;
  static constexpr float kSlack = 7.62939453125e-06f;  // 2**-17
  __device__ static __forceinline__ Pair pair(float a, float b) { return make_float2(a, b); }
  __device__ static __forceinline__ SBits bits(float v) { return __float_as_int(v); }
  __device__ static __forceinline__ float ldg(const float* p) { return __ldg(p); }
  __device__ static __forceinline__ Pair ldg(const Pair* p) { return __ldg(p); }
  __device__ static __forceinline__ float wide(float x) { return x; }
};

template <typename F>
struct Num<Lo16<F>> {
  using T = Lo16<F>;
  struct alignas(4) Pair {
    T x, y;
  };
  using Acc = float;
  using Plane = float;
  static constexpr bool kExact = std::is_same_v<F, __half>;
  static constexpr float kSlack = 0.015625f;  // 2**-6, bfloat16's (float16 has none)
  __device__ static __forceinline__ Pair pair(T a, T b) { return Pair{a, b}; }
  __device__ static __forceinline__ T ldg(const T* p) {
    T v;
    v.bits = __ldg(reinterpret_cast<const unsigned short*>(p));
    return v;
  }
  __device__ static __forceinline__ Pair ldg(const Pair* p) {
    const unsigned int w = __ldg(reinterpret_cast<const unsigned int*>(p));
    Pair q;
    q.x.bits = static_cast<unsigned short>(w & 0xFFFFu);  // little-endian: x first
    q.y.bits = static_cast<unsigned short>(w >> 16);
    return q;
  }
  __device__ static __forceinline__ float wide(T x) { return x.f(); }
};

// The math of both value types, by overload (so a float is never promoted
// to double by a double literal or a double function).
__device__ __forceinline__ double vabs(double x) { return fabs(x); }
__device__ __forceinline__ float vabs(float x) { return fabsf(x); }
__device__ __forceinline__ double vmax(double a, double b) { return fmax(a, b); }
__device__ __forceinline__ float vmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double vmin(double a, double b) { return fmin(a, b); }
__device__ __forceinline__ float vmin(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double vceil(double x) { return ceil(x); }
__device__ __forceinline__ float vceil(float x) { return ceilf(x); }
__device__ __forceinline__ double vfloor(double x) { return floor(x); }
__device__ __forceinline__ float vfloor(float x) { return floorf(x); }
// The 16-bit types: abs flips no bit but the sign; max and min return one
// of their operands; the ceil and floor of a 16-bit value are 16-bit
// values again (every value at or past 2^p is an integer), so each is
// exact.
template <typename F>
__device__ __forceinline__ Lo16<F> vabs(Lo16<F> x) {
  x.bits &= 0x7FFFu;
  return x;
}
template <typename F>
__device__ __forceinline__ Lo16<F> vmax(Lo16<F> a, Lo16<F> b) {
  return Lo16<F>(fmaxf(a.f(), b.f()));
}
template <typename F>
__device__ __forceinline__ Lo16<F> vmin(Lo16<F> a, Lo16<F> b) {
  return Lo16<F>(fminf(a.f(), b.f()));
}
template <typename F>
__device__ __forceinline__ Lo16<F> vceil(Lo16<F> x) { return Lo16<F>(ceilf(x.f())); }
template <typename F>
__device__ __forceinline__ Lo16<F> vfloor(Lo16<F> x) { return Lo16<F>(floorf(x.f())); }

// The gate of a round's kernels (D, A', the combine, E): true where the
// loop carry's `go` (the low byte of its int32 field, passed as a bool
// pointer; null for no gate) says the fixed point has stopped, so a round
// enqueued after convergence returns at once.
__device__ __forceinline__ bool skip_round(const bool* go) { return go != nullptr && !*go; }

template <typename T>
struct SlotT {
  bool pos, min_inf, max_inf;
  T bmin, bmax;
};
using Slot = SlotT<double>;

// tile_contributions of one real nonzero (val != 0) whose column has the
// bounds l, u.
template <typename T>
__device__ __forceinline__ SlotT<T> make_slot(T v, T l, T u, T inf) {
  SlotT<T> s;
  s.pos = v > T(0);
  s.bmin = s.pos ? l : u;
  s.bmax = s.pos ? u : l;
  s.min_inf = vabs(s.bmin) >= inf;
  s.max_inf = vabs(s.bmax) >= inf;
  return s;
}

// The same, gathered at column c of the bound vectors (padding is skipped
// before its col is read).
template <typename T>
__device__ __forceinline__ SlotT<T> load_slot(T v, int c, const T* __restrict__ lb,
                                              const T* __restrict__ ub, T inf) {
  return make_slot(v, lb[c], ub[c], inf);
}

// Where a slot's bounds come from.  ColumnBounds gathers them at the slot's
// column from the (n_pad,) vectors (kernels D, A', E and the slab kernels);
// SlotBounds reads them at the slot itself from (T, R, K) tiles gathered
// before the launch (kernels A, B and C of the segment round).  Both feed
// the same arithmetic.  i is the slot's flat index; only real nonzeros are
// loaded.
template <typename T>
struct ColumnBoundsT {
  const int* col;
  const T* lb;
  const T* ub;
  __device__ __forceinline__ SlotT<T> at(T v, int64_t i, T inf) const {
    return load_slot(v, col[i], lb, ub, inf);
  }
};
using ColumnBounds = ColumnBoundsT<double>;

template <typename T>
struct SlotBoundsT {
  const T* lb_g;
  const T* ub_g;
  __device__ __forceinline__ SlotT<T> at(T v, int64_t i, T inf) const {
    return make_slot(v, lb_g[i], ub_g[i], inf);
  }
};
using SlotBounds = SlotBoundsT<double>;

// Butterfly sum over aligned groups of G lanes (a power of two); every lane
// of the warp must take part.
template <int G, typename T>
__device__ __forceinline__ T group_sum(T x) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ double warp_sum(double x) { return group_sum<kWarp>(x); }

// Lanes per chunk: K rounded up to a power of two, at most a warp.
int group_width(int k) {
  int g = 1;
  while (g < k && g < kWarp) g <<= 1;
  return g;
}

// This thread's chunk and its lane within the chunk's group of G lanes.
// Lanes of a group past the last chunk are not live: they still take part
// in the shuffles (as empty chunks) but load and store nothing.
struct Lanes {
  int64_t chunk;
  int sl;
  bool live;
};

template <int G>
__device__ __forceinline__ Lanes lanes_for(int64_t n_chunks) {
  Lanes L;
  const int lane = threadIdx.x % kWarp;
  const int64_t warp = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  L.chunk = warp * (kWarp / G) + lane / G;
  L.sl = lane % G;
  L.live = L.chunk < n_chunks;
  return L;
}

template <typename T>
struct RowAggT {
  T mf, xf;
  int mc, xc;
};
using RowAgg = RowAggT<double>;

// A lane's running activity sums, in Num<T>::Acc (each contribution
// v * bound rounded to T first, as the plain version's product is).
template <typename T>
struct RowSumT {
  typename Num<T>::Acc mf, xf;
  int mc, xc;
};

// The group's sums of its lanes' running sums (the butterfly), rounded to
// T once.
template <int G, typename T>
__device__ __forceinline__ RowAggT<T> group_reduce(const RowSumT<T>& a) {
  return RowAggT<T>{T(group_sum<G>(a.mf)), T(group_sum<G>(a.xf)), group_sum<G>(a.mc),
                    group_sum<G>(a.xc)};
}

// tile_row_aggregates of one chunk, its bounds from B (ColumnBounds or
// SlotBounds); every lane of the group gets the result.  All lanes of the
// warp must call it (dead lanes with k = 0).
template <int G, typename B, typename T>
__device__ __forceinline__ RowAggT<T> chunk_aggregates(const T* __restrict__ val, const B& b,
                                                       int64_t base, int k, const Lanes& L,
                                                       T inf) {
  RowSumT<T> a{};
  for (int j = L.sl; j < k; j += kWarp) {
    const T v = val[base + j];
    if (v == T(0)) continue;  // padding adds nothing; its bounds are never read
    const SlotT<T> s = b.at(v, base + j, inf);
    if (s.min_inf) a.mc += 1; else a.mf += Num<T>::wide(v * s.bmin);
    if (s.max_inf) a.xc += 1; else a.xf += Num<T>::wide(v * s.bmax);
  }
  return group_reduce<G>(a);
}

template <int G, typename T>
__device__ __forceinline__ RowAggT<T> chunk_aggregates(const T* __restrict__ val,
                                                       const int* __restrict__ col,
                                                       const T* __restrict__ lb,
                                                       const T* __restrict__ ub, int64_t base,
                                                       int k, const Lanes& L, T inf) {
  return chunk_aggregates<G>(val, ColumnBoundsT<T>{col, lb, ub}, base, k, L, inf);
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

template <typename T>
__device__ __forceinline__ T clip(T x, T inf) { return vmin(vmax(x, -inf), inf); }

template <typename T>
struct CandsT {
  T lc, uc;
};
using Cands = CandsT<double>;

// The integrality rounding's margin below a lower candidate c (above an
// upper one): int_eps, plus the tier's slack * max(1, |c|) where the tier
// is not exact (round_candidates: a separate multiply and add, so
// --fmad=false rounds them as the plain version does).
template <typename T>
__device__ __forceinline__ T round_margin(T c, T int_eps) {
  if constexpr (Num<T>::kExact) {
    return int_eps;
  } else {
    return int_eps + T(Num<T>::kSlack) * vmax(T(1), vabs(c));
  }
}

// tile_candidates of one real nonzero v with bounds s, from its row's
// completed aggregates a and sides; is_int rounds inward.
template <typename T>
__device__ __forceinline__ CandsT<T> slot_candidates(T v, const SlotT<T>& s, const RowAggT<T>& a,
                                                     T lhs, T rhs, bool is_int, T int_eps,
                                                     T inf) {
  const bool ok_min = s.min_inf ? a.mc == 1 : a.mc == 0;
  const bool ok_max = s.max_inf ? a.xc == 1 : a.xc == 0;
  const T inc_min = s.min_inf ? T(0) : s.bmin;
  const T inc_max = s.max_inf ? T(0) : s.bmax;
  const T q_min = (rhs - a.mf) / v + inc_min;
  const T q_max = (lhs - a.xf) / v + inc_max;
  T lc = s.pos ? q_max : q_min;
  T uc = s.pos ? q_min : q_max;
  const bool valid_l = s.pos ? (lhs > -inf && ok_max) : (rhs < inf && ok_min);
  const bool valid_u = s.pos ? (rhs < inf && ok_min) : (lhs > -inf && ok_max);
  lc = valid_l ? clip(lc, inf) : -inf;
  uc = valid_u ? clip(uc, inf) : inf;
  if (is_int) {
    if (vabs(lc) < inf) lc = vceil(lc - round_margin(lc, int_eps));
    if (vabs(uc) < inf) uc = vfloor(uc + round_margin(uc, int_eps));
  }
  return CandsT<T>{lc, uc};
}

// tile_candidates of one chunk followed by the column max/min by
// compare-and-swap loops: kernel D's routine before it moved onto
// chunk_round, kept as the "before" variant of tools/round_variants.cu.
// Slots whose candidate is the sentinel (padding, invalid residual or side)
// skip the atomic: the accumulators start at the sentinel, so skipping is
// exact.
__device__ __forceinline__ void chunk_candidates_scatter(
    const double* __restrict__ val, const int* __restrict__ col, const int* __restrict__ ii,
    const double* __restrict__ lb, const double* __restrict__ ub, const RowAgg& a, double lhs,
    double rhs, double* best_l, double* best_u, int64_t base, int k, const Lanes& L,
    double int_eps, double inf) {
  for (int j = L.sl; j < k; j += kWarp) {
    const double v = val[base + j];
    if (v == 0.0) continue;  // padding: both candidates are the sentinel
    const int c = col[base + j];  // col and is_int are read at nonzeros only
    const Cands q = slot_candidates(v, load_slot(v, c, lb, ub, inf), a, lhs, rhs,
                                    ii[base + j] != 0, int_eps, inf);
    if (q.lc > -inf) atomic_max_f64(best_l + c, q.lc);
    if (q.uc < inf) atomic_min_f64(best_u + c, q.uc);
  }
}

// tile_candidates of one chunk, stored at each slot of the (T, R, K)
// outputs: one store per lane per slot, a group's lanes on consecutive
// slots.  Padding stores the sentinels without reading its bounds or mark.
template <typename B, typename T, typename M>
__device__ __forceinline__ void chunk_candidates_store(
    const T* __restrict__ val, const B& b, const M* __restrict__ ii, const RowAggT<T>& a, T lhs,
    T rhs, T* __restrict__ lcand, T* __restrict__ ucand, int64_t base, int k, const Lanes& L,
    T int_eps, T inf) {
  for (int j = L.sl; j < k; j += kWarp) {
    const int64_t i = base + j;
    const T v = val[i];
    CandsT<T> q{-inf, inf};
    if (v != T(0)) q = slot_candidates(v, b.at(v, i, inf), a, lhs, rhs, ii[i] != 0, int_eps, inf);
    lcand[i] = q.lc;
    ucand[i] = q.uc;
  }
}


// bounds.apply_updates for column i, whose bounds l, u and best candidates
// bl, bu are loaded already, in place; true if a bound tightened.
// The merged bounds come back in nl, nu (the early stop's progress measure
// reads them).
template <typename T>
__device__ __forceinline__ bool merge_loaded_into(T* __restrict__ lb, T* __restrict__ ub,
                                                  int64_t i, T l, T u, T bl, T bu, T eps, T inf,
                                                  T outward, T& nl, T& nu) {
  const bool take_l = bl > l + eps * vmax(T(1), vabs(l));
  const bool take_u = bu < u - eps * vmax(T(1), vabs(u));
  if (outward != T(0)) {
    bl = bl - outward * vmax(T(1), vabs(bl));
    bu = bu + outward * vmax(T(1), vabs(bu));
  }
  nl = take_l ? clip(bl, inf) : l;
  nu = take_u ? clip(bu, inf) : u;
  if (take_l) lb[i] = nl;
  if (take_u) ub[i] = nu;
  return take_l || take_u;
}

// The same without them.
template <typename T>
__device__ __forceinline__ bool merge_loaded(T* __restrict__ lb, T* __restrict__ ub, int64_t i,
                                             T l, T u, T bl, T bu, T eps, T inf, T outward) {
  T nl, nu;
  return merge_loaded_into(lb, ub, i, l, u, bl, bu, eps, inf, outward, nl, nu);
}

// The same, loading the bounds.
template <typename T>
__device__ __forceinline__ bool merge_values(T* __restrict__ lb, T* __restrict__ ub, int64_t i,
                                             T bl, T bu, T eps, T inf, T outward) {
  return merge_loaded(lb, ub, i, lb[i], ub[i], bl, bu, eps, inf, outward);
}

// The merge that only reads its accumulator entry (the merges before they
// handed the planes back; tools/round_variants.cu times it).
__device__ __forceinline__ bool merge_one(double* __restrict__ lb, double* __restrict__ ub,
                                          const double* __restrict__ best_l,
                                          const double* __restrict__ best_u, int64_t i,
                                          double eps, double inf, double outward) {
  return merge_values(lb, ub, i, best_l[i], best_u[i], eps, inf, outward);
}

// merge_one that hands its accumulator entry back: the candidates are read,
// the entry is set to the sentinel again (a store only where a candidate
// landed), then merged: the one-column form of merge_item's hand-back
// (F's kernel before it ran merge_item; tools/round_variants.cu times it).
__device__ __forceinline__ bool merge_reset(double* __restrict__ lb, double* __restrict__ ub,
                                            double* __restrict__ best_l,
                                            double* __restrict__ best_u, int64_t i, double eps,
                                            double inf, double outward) {
  const double bl = best_l[i], bu = best_u[i];
  if (bl != -inf) best_l[i] = -inf;
  if (bu != inf) best_u[i] = inf;
  return merge_values(lb, ub, i, bl, bu, eps, inf, outward);
}

// ---------------------------------------------------------------------------
// Kernels A' and E and their node-batched forms.  The loop above runs one
// dependent chain (val -> col -> lb/ub) per stride and walks every slot of
// the chunk; these helpers stop each lane group at its chunk's length (one
// past its last nonzero, hoisted from structure before the round: every
// slot past it is padding, which the sums skip anyway) and issue the val /
// col / mark loads of up to U strides before the dependent bound gathers,
// so a lane keeps U gathers in flight.  A lane still adds its slots in the
// order j = sl, sl + 32, ... and the group reduces by the same butterfly, so
// the sums are chunk_aggregates' bit for bit.
// ---------------------------------------------------------------------------

// Strides a lane holds at once: a group narrower than a warp (K <= 16)
// covers its chunk in one stride; at K = 128 four strides are the chunk.
template <int G>
struct Strides {
  static constexpr int U = G < kWarp ? 1 : 4;
};

// One batch of U strides of a lane: slot values, their columns and
// integrality marks (both read at nonzeros only; 0 elsewhere), the ids
// widened to int in registers whatever their width in memory (int32, or
// the fp32 tier's compact int16 columns and int8 marks).
template <int U, typename T = double>
struct Loaded {
  T v[U];
  int c[U];
  int m[U];
};

// The lane's slots j0 + sl + 32u (u < U) below len.  The first stride of the
// chunk is read up to k whatever len says (past len it holds zeros), so its
// load does not wait for the length's.  ii may be null (no marks wanted).
// Columns and marks are read at nonzeros only, after their values; EAGER
// reads them with the values (padding holds column 0), so that the bound
// gather waits for one load instead of two.
template <int U, bool EAGER = false, typename T, typename C, typename M>
__device__ __forceinline__ void load_strides(Loaded<U, T>& s, const T* __restrict__ val,
                                             const C* __restrict__ col,
                                             const M* __restrict__ ii, int64_t base, int j0,
                                             int len, int k, int sl) {
  bool in[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int j = j0 + sl + u * kWarp;
    in[u] = j < (j0 == 0 && u == 0 ? k : len);
    s.v[u] = in[u] ? val[base + j] : T(0);
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int64_t i = base + j0 + sl + u * kWarp;
    const bool read = EAGER ? in[u] : s.v[u] != T(0);
    s.c[u] = read ? static_cast<int>(col[i]) : 0;
    s.m[u] = ii != nullptr && read ? static_cast<int>(ii[i]) : 0;
  }
}

// The same without marks.
template <int U, bool EAGER = false, typename T, typename C>
__device__ __forceinline__ void load_strides(Loaded<U, T>& s, const T* __restrict__ val,
                                             const C* __restrict__ col, std::nullptr_t,
                                             int64_t base, int j0, int len, int k, int sl) {
  load_strides<U, EAGER>(s, val, col, static_cast<const int*>(nullptr), base, j0, len, k, sl);
}

// Where a batch's bounds come from.  SplitBounds gathers them from the two
// (n_pad,) vectors, two 8-byte loads per nonzero; PairedBounds from an
// interleaved (n_pad, 2) copy, one 16-byte load.  On the card the gathers,
// not the bytes, bound A' and E: each lane's load of a scattered column is a
// cache-line request of its own, and a pair halves them (A' on `mixed`,
// an H100 at 700 W: 0.1535 -> 0.0982 ms, tools/ae_variants.py).
// (Both also in float32: a float pair is one 8-byte load, aligned since
// the (n_pad, 2) copy starts a fresh allocation.)
template <typename T>
struct SplitBoundsT {
  const T* lb;
  const T* ub;
  __device__ __forceinline__ typename Num<T>::Pair at(int c) const {
    return Num<T>::pair(Num<T>::ldg(lb + c), Num<T>::ldg(ub + c));
  }
};
using SplitBounds = SplitBoundsT<double>;

template <typename T>
struct PairedBoundsT {
  const typename Num<T>::Pair* lub;
  __device__ __forceinline__ typename Num<T>::Pair at(int c) const {
    return Num<T>::ldg(lub + c);
  }
};
using PairedBounds = PairedBoundsT<double>;

// The bounds of a batch's nonzeros, gathered at their columns, all issued
// before any is used.
template <int U, typename B, typename T>
__device__ __forceinline__ void gather_strides(const Loaded<U, T>& s, const B& b, T (&l)[U],
                                               T (&h)[U]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const typename Num<T>::Pair p = s.v[u] != T(0) ? b.at(s.c[u]) : Num<T>::pair(T(0), T(0));
    l[u] = p.x;
    h[u] = p.y;
  }
}

// One slot's activity contribution (value v, its column's bounds l, h),
// added to the sums a; padding (v == 0) adds nothing.
template <typename T>
__device__ __forceinline__ void add_slot(RowSumT<T>& a, T v, T l, T h, T inf) {
  if (v == T(0)) return;
  const SlotT<T> t = make_slot(v, l, h, inf);
  if (t.min_inf) a.mc += 1; else a.mf += Num<T>::wide(v * t.bmin);
  if (t.max_inf) a.xc += 1; else a.xf += Num<T>::wide(v * t.bmax);
}

// A batch's activity contributions, from its gathered bounds l, h, added to
// the lane's sums in slot order.
template <int U, typename T>
__device__ __forceinline__ void add_gathered(RowSumT<T>& a, const Loaded<U, T>& s,
                                             const T (&l)[U], const T (&h)[U], T inf) {
#pragma unroll
  for (int u = 0; u < U; ++u) add_slot(a, s.v[u], l[u], h[u], inf);
}

// The same, gathering the batch's bounds first.
template <int U, typename B, typename T>
__device__ __forceinline__ void add_strides(RowSumT<T>& a, const Loaded<U, T>& s, const B& b,
                                            T inf) {
  T l[U], h[U];
  gather_strides(s, b, l, h);
  add_gathered(a, s, l, h, inf);
}

// Column max / min of candidates by the card's integer atomics (64-bit
// words for float64, 32-bit for float32 and for the float planes of the
// 16-bit types: a 16-bit candidate widens exactly, so the planes hold
// 16-bit values and narrow back exactly), one fire-and-forget reduction
// each (no compare-and-swap loop, no returned value).  A non-negative
// float orders as its bits read as a signed integer; a negative one in
// reverse as its bits read unsigned, and above every non-negative one: so
// max takes the signed max for v >= 0 and the unsigned min for v < 0, min
// the other way round, whatever the stored value.  -0.0 would order below
// every float, so it enters as +0.0 (equal as a value).  CHECK: a
// pre-check reads the accumulator from L2 (not a stale L1 line) and skips
// a candidate that cannot win; accumulators only move towards the
// candidates, so skipping is exact.  E keeps it; #10 and #12 go without,
// since waiting for the read costs them more than the atomics it saves
// (tools/round_variants.py).
template <bool CHECK = true, typename T>
__device__ __forceinline__ void red_max(T* addr, T v) {
  using SB = typename Num<T>::SBits;
  using UB = typename Num<T>::UBits;
  if (v == T(0)) v = T(0);
  if (CHECK && !(v > __ldcg(addr))) return;
  const SB bits = Num<T>::bits(v);
  if (v >= T(0)) atomicMax(reinterpret_cast<SB*>(addr), bits);
  else atomicMin(reinterpret_cast<UB*>(addr), static_cast<UB>(bits));
}

template <bool CHECK = true, typename T>
__device__ __forceinline__ void red_min(T* addr, T v) {
  using SB = typename Num<T>::SBits;
  using UB = typename Num<T>::UBits;
  if (v == T(0)) v = T(0);
  if (CHECK && !(v < __ldcg(addr))) return;
  const SB bits = Num<T>::bits(v);
  if (v >= T(0)) atomicMin(reinterpret_cast<SB*>(addr), bits);
  else atomicMax(reinterpret_cast<UB*>(addr), static_cast<UB>(bits));
}

// A batch's candidates, from its gathered bounds l, h and the row's
// completed aggregates a and sides, scattered into the column max / min.
// Sentinel candidates skip the reduction: the accumulators start at the
// sentinels.
template <int U, bool CHECK = true, typename T>
__device__ __forceinline__ void scatter_gathered(const Loaded<U, T>& s, const T (&l)[U],
                                                 const T (&h)[U], const RowAggT<T>& a, T lhs,
                                                 T rhs, typename Num<T>::Plane* best_l,
                                                 typename Num<T>::Plane* best_u, T int_eps,
                                                 T inf) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (s.v[u] == T(0)) continue;
    const CandsT<T> q = slot_candidates(s.v[u], make_slot(s.v[u], l[u], h[u], inf), a, lhs, rhs,
                                        s.m[u] != 0, int_eps, inf);
    if (q.lc > -inf) red_max<CHECK>(best_l + s.c[u], Num<T>::wide(q.lc));
    if (q.uc < inf) red_min<CHECK>(best_u + s.c[u], Num<T>::wide(q.uc));
  }
}

// The same, gathering the batch's bounds first.
template <int U, bool CHECK = true, typename B, typename T>
__device__ __forceinline__ void scatter_strides(const Loaded<U, T>& s, const B& b,
                                                const RowAggT<T>& a, T lhs, T rhs,
                                                typename Num<T>::Plane* best_l,
                                                typename Num<T>::Plane* best_u, T int_eps,
                                                T inf) {
  T l[U], h[U];
  gather_strides(s, b, l, h);
  scatter_gathered<U, CHECK>(s, l, h, a, lhs, rhs, best_l, best_u, int_eps, inf);
}

// ---------------------------------------------------------------------------
// Kernels D, #8, #10, #12 and #14: one chunk's whole round, each nonzero's
// bounds gathered once.  chunk_aggregates followed by
// chunk_candidates_scatter (D's routine before) loads every
// slot of the chunk twice and gathers its two bounds twice, two 8-byte
// loads each time, and reduces by compare-and-swap loops.  Here a lane loads its first U
// strides (values, columns and integrality marks together; stopped at the
// chunk's hoisted length), gathers their bounds once and holds them in
// registers from the activity sums to the candidates, which go to the
// column max / min by fire-and-forget integer reductions.  The launch picks
// U from the longest chunk of the stream (1, 2 or 4 strides of 32 slots:
// held_strides), so every nonzero of a chunk of up to 128 slots is gathered
// once; only a wider chunk's slots past the first 128 are gathered again
// for the candidates.  Holding four strides whatever the chunks need took
// 104-106 registers a thread, two blocks an SM, and ran #12 at K = 128 25%
// slower than D's routine, while the copy streams' chunks hold at most 32
// slots (tools/round_variants.py).  A lane adds its slots in the order sl,
// sl + 32, ... and the group reduces by the same butterfly, so the sums are
// ref.warp_order_sum's.
// ---------------------------------------------------------------------------

// Strides a lane holds for chunks of at most max_len slots: 1, 2 or 4.
inline int held_strides(int max_len) {
  return max_len <= kWarp ? 1 : max_len <= 2 * kWarp ? 2 : 4;
}

// One chunk's activity sums, U strides held: the first U strides loaded
// (values, columns and, where ii is not null, marks together; stopped at
// the length) into `first` and their bounds gathered into l, h, all issued
// before any is used, then added with the later strides' when `sum` (else
// the sums stay zero), and reduced over the group.  The caller may keep
// first, l, h for the chunk's candidates (chunk_round) or drop them (#13's
// partials).  Every lane of the warp calls it (the group shuffles); len
// and kk are 0 for a lane with nothing to do, which loads nothing.  A lane
// adds its slots in the order sl, sl + 32, ... and the group reduces by
// chunk_aggregates' butterfly, so the sums are its own bit for bit, and
// ref.warp_order_sum's.
template <int G, int U, typename T, typename C, typename MP, typename B>
__device__ __forceinline__ RowAggT<T> chunk_sums(Loaded<U, T>& first, T (&l)[U], T (&h)[U],
                                                 const T* __restrict__ val,
                                                 const C* __restrict__ col, MP ii, const B& b,
                                                 int64_t base, int kk, int len, bool sum,
                                                 int sl, T inf) {
  load_strides<U, true>(first, val, col, ii, base, 0, len, kk, sl);
  gather_strides(first, b, l, h);
  RowSumT<T> a{};
  if (sum) {
    add_gathered(a, first, l, h, inf);
    for (int j0 = U * kWarp; j0 < len; j0 += U * kWarp) {
      Loaded<U, T> s;
      load_strides<U, true>(s, val, col, nullptr, base, j0, len, kk, sl);
      add_strides(a, s, b, inf);
    }
  }
  return group_reduce<G>(a);
}

// One chunk's round, U strides held.  Every lane of the warp calls it (the
// aggregates shuffle).  len is the chunk's length and kk its width, both 0
// for a lane with nothing to do (dead, or an inactive node or window),
// which loads nothing and scatters nothing.  sum: the row's aggregates are
// the chunk's own sums; else they are given (the straddle aggregates of
// #12 and #14, whose chunk gathers only for its candidates).
template <int G, int U, typename T, typename C, typename M, typename B>
__device__ __forceinline__ void chunk_round(const T* __restrict__ val,
                                            const C* __restrict__ col,
                                            const M* __restrict__ ii, const B& b,
                                            int64_t base, int kk, int len, bool sum,
                                            const RowAggT<T>& given, T lhs, T rhs,
                                            typename Num<T>::Plane* best_l,
                                            typename Num<T>::Plane* best_u, int sl, T int_eps,
                                            T inf) {
  Loaded<U, T> first;
  T l[U], h[U];
  RowAggT<T> a = chunk_sums<G, U>(first, l, h, val, col, ii, b, base, kk, len, sum, sl, inf);
  if (kk == 0) return;
  if (!sum) a = given;
  scatter_gathered<U, false>(first, l, h, a, lhs, rhs, best_l, best_u, int_eps, inf);
  for (int j0 = U * kWarp; j0 < len; j0 += U * kWarp) {
    Loaded<U, T> s;
    load_strides<U, true>(s, val, col, ii, base, j0, len, kk, sl);
    scatter_strides<U, false>(s, b, a, lhs, rhs, best_l, best_u, int_eps, inf);
  }
}

// Run LAUNCH(G, U) for the group width of k slots and the strides held,
// held (1, 2 or 4; a group narrower than a warp covers its chunk in one).
#define DISPATCH_HELD(LAUNCH, k, held)                                                  \
  switch (group_width(k)) {                                                             \
    case 1: return LAUNCH(1, 1);                                                        \
    case 2: return LAUNCH(2, 1);                                                        \
    case 4: return LAUNCH(4, 1);                                                        \
    case 8: return LAUNCH(8, 1);                                                        \
    case 16: return LAUNCH(16, 1);                                                      \
    default:                                                                            \
      return (held) <= 1 ? LAUNCH(32, 1) : (held) == 2 ? LAUNCH(32, 2) : LAUNCH(32, 4); \
  }

// ---------------------------------------------------------------------------
// The active-only walks of #8, #9, #10, #13, #14 and #15.  A work item is
// one (active plane, chunk block) pair, a chunk block being the chunks of
// one kThreads-thread block (32 / G per warp; #9's and #15's item is a
// block of columns, four per thread); items are numbered plane by
// plane, and the blocks walk them with a grid-stride loop over a grid of at
// most the resident blocks, so the items in flight belong to one or a few
// planes and those planes' rows stay in L2.  Each block first ballots the
// (B,) mask into shared memory, one word per 32 planes, with the items of
// each word's active planes summed into an exclusive prefix; a block's
// items only grow, so a cursor over the words finds each item's plane, and
// no warp is launched for an inactive plane's chunks.  No active plane:
// every block returns after the ballot.
// ---------------------------------------------------------------------------

// Chunks of one chunk block.
template <int G>
__device__ __forceinline__ int64_t block_chunks() {
  return static_cast<int64_t>(kWarpsPerBlock) * (kWarp / G);
}

// Items of a plane whose chunks are the stream's first n_chunks (#10, #13,
// #14: one matrix shared by every node; #9, #15: the column blocks of every
// row).
struct EqualItems {
  int64_t n_blocks;
  __device__ __forceinline__ int64_t operator()(int64_t) const { return n_blocks; }
  __device__ __forceinline__ int64_t first_chunk(int64_t) const { return 0; }
  __device__ __forceinline__ int64_t end_chunk(int64_t, int64_t n_chunks) const {
    return n_chunks;
  }
};

// Items of instance b of a packed stream, whose chunks are
// [start[b], start[b + 1]) (#8: an instance's tiles are contiguous).
struct RangeItems {
  const int64_t* start;
  int64_t per_block;
  __device__ __forceinline__ int64_t operator()(int64_t b) const {
    return (start[b + 1] - start[b] + per_block - 1) / per_block;
  }
  __device__ __forceinline__ int64_t first_chunk(int64_t b) const { return start[b]; }
  __device__ __forceinline__ int64_t end_chunk(int64_t b, int64_t) const { return start[b + 1]; }
};

// Dynamic shared memory of a walk over bsz planes: the item prefix (one
// entry per word and a total), then the ballot words.
inline size_t walk_shared(int64_t bsz) {
  const size_t n_words = static_cast<size_t>((bsz + kWarp - 1) / kWarp);
  return (n_words + 1) * sizeof(long long) + n_words * sizeof(unsigned int);
}

struct Walk {
  const long long* before;  // items of the active planes of words < w
  const unsigned int* words;
  int64_t items;
};

// The block's ballot: every thread calls it.  Warp w takes words w, w + 8,
// ...; warp 0 then scans the word totals 32 at a time.
template <typename Items>
__device__ __forceinline__ Walk ballot_walk(const bool* __restrict__ active, int64_t bsz,
                                            const Items& items_of) {
  extern __shared__ long long walk_smem[];
  const int n_words = static_cast<int>((bsz + kWarp - 1) / kWarp);
  long long* before = walk_smem;
  unsigned int* words = reinterpret_cast<unsigned int*>(walk_smem + n_words + 1);
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  for (int w = warp; w < n_words; w += kWarpsPerBlock) {
    const int64_t b = static_cast<int64_t>(w) * kWarp + lane;
    const bool on = b < bsz && active[b];
    const unsigned int m = __ballot_sync(0xffffffffu, on);
    long long n = on ? static_cast<long long>(items_of(b)) : 0;
    n = group_sum<kWarp>(n);
    if (lane == 0) {
      words[w] = m;
      before[w + 1] = n;
    }
  }
  __syncthreads();
  if (warp == 0) {
    long long carry = 0;
    for (int w0 = 0; w0 < n_words; w0 += kWarp) {
      const int w = w0 + lane;
      long long x = w < n_words ? before[w + 1] : 0;
#pragma unroll
      for (int off = 1; off < kWarp; off <<= 1) {
        const long long y = __shfl_up_sync(0xffffffffu, x, off);
        if (lane >= off) x += y;
      }
      if (w < n_words) before[w + 1] = x + carry;
      carry += __shfl_sync(0xffffffffu, x, kWarp - 1);
    }
    if (lane == 0) before[0] = 0;
  }
  __syncthreads();
  return Walk{before, words, static_cast<int64_t>(before[n_words])};
}

// A block's position in the walk: the plane of its current item and the
// items before that plane.  seek() takes ascending items only.
struct WalkCursor {
  int word = -1;
  unsigned int left = 0u;  // bits of words[word] not yet passed
  int64_t plane = -1, first = 0, end = 0;

  template <typename Items>
  __device__ __forceinline__ void seek(int64_t item, const Walk& walk, const Items& items_of) {
    while (item >= end) {
      if (left == 0u) {
        do ++word; while (walk.before[word + 1] <= item);
        left = walk.words[word];
        end = walk.before[word];
      }
      plane = static_cast<int64_t>(word) * kWarp + __ffs(left) - 1;
      left &= left - 1u;
      first = end;
      end = first + items_of(plane);
    }
  }
};

// This thread's chunk of item `item` under the cursor, and its lane within
// the chunk's group; live is false past the plane's last chunk.
struct WalkLanes {
  int64_t chunk;
  int sl;
  bool live;
};

template <int G, typename Items>
__device__ __forceinline__ WalkLanes walk_lanes(int64_t item, const WalkCursor& cur,
                                                const Items& items_of, int64_t n_chunks) {
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  WalkLanes L;
  L.chunk = items_of.first_chunk(cur.plane) + (item - cur.first) * block_chunks<G>() +
            warp * (kWarp / G) + lane / G;
  L.sl = lane % G;
  L.live = L.chunk < items_of.end_chunk(cur.plane, n_chunks);
  return L;
}

// Launch Kernel over `blocks` blocks of kThreads (none for an empty grid).
template <auto Kernel, typename... Args>
int launch_blocks(unsigned int blocks, cudaStream_t stream, Args... args) {
  if (blocks > 0) Kernel<<<blocks, kThreads, 0, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// Launch a walk kernel over a grid of at most `most` blocks and at most the
// blocks the card holds resident at once (counted once per instantiation).
template <auto Kernel, typename... Args>
int launch_walk(int64_t most, int64_t bsz, cudaStream_t stream, Args... args) {
  static int resident = 0;
  const size_t shm = walk_shared(bsz);
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kernel, kThreads, shm);
    resident = sms * per_sm > 0 ? sms * per_sm : 1;
  }
  const int64_t grid = most < resident ? most : resident;
  if (grid <= 0 || bsz == 0) return static_cast<int>(cudaGetLastError());
  Kernel<<<static_cast<unsigned int>(grid), kThreads, shm, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The merges F, #9 and #15: bounds.apply_updates over (B, W) planes, in
// place.  One body, templated on where a warp's tightenings are flagged,
// over (row, block of C * kThreads columns) items, C columns a thread:
// kMergeCols on the walk, the merge's own kGridCols on the grid.  A thread
// loads the bounds and candidates of its C columns j0 + v * kThreads
// before it merges any (on the walk, one column per thread ran 3% slower
// with a full pool and 22% slower with 4 of 4 rows of the fused batch
// active: tools/round_variants.py).  Each accumulator entry it reads goes
// back to the sentinel (merge_reset's hand-back), so planes kept for the
// whole fixed point are clean for their next round; fresh planes do not
// mind.  An inactive row is neither read nor written.  Two launches of the
// body, chosen by the row count:
// - the active-only walk above, for more than kMergeGridRows rows, so no
//   block is spent on an inactive row (a (column block, row) grid launches
//   every row's blocks: with 8 of 128 rows active, 94% of them read the
//   mask and return);
// - a (column block, row) grid for at most kMergeGridRows rows (a single
//   instance, a small batch), where those blocks are few and the walk's
//   ballot and prefix, ahead of the first load, cost more than they save.
//   F is the grid over one plane with no mask at all.
//
// The flags: #9 and #15 write theirs into one of two buffers that the
// round closure keeps and hands over in turn, and zero the other one (the
// previous launch's, read by then in stream order), so no launch is
// preceded by a fill.  F, and #15 for a single instance, fold their flag
// into the loop carry instead (CarryFlags).
// ---------------------------------------------------------------------------

constexpr int kMergeCols = 4;
constexpr int64_t kMergeBlock = static_cast<int64_t>(kThreads) * kMergeCols;
constexpr int64_t kMergeGridRows = 16;

// Zero the n entries of `clear` (the other buffer of a flag pair; null for
// none), spread over every block of the launch.
template <typename T>
__device__ __forceinline__ void clear_flags(T* clear, int64_t n) {
  if (clear == nullptr) return;
  const int64_t blk = static_cast<int64_t>(blockIdx.y) * gridDim.x + blockIdx.x;
  const int64_t step = static_cast<int64_t>(gridDim.x) * gridDim.y * blockDim.x;
  for (int64_t i = blk * blockDim.x + threadIdx.x; i < n; i += step) clear[i] = 0;
}

// #9: one changed flag per row, stored once per warp and item.  On the
// grid it takes four columns a thread (one: 17% slower over the fused
// batch's 33 rounds on an H100, tools/path_times.py).
struct RowFlags {
  static constexpr int kGridCols = 4;
  static constexpr bool kProgress = false;
  static constexpr bool kRowProgress = false;
  bool* changed;
  bool* clear;
  int64_t n_clear;
  __device__ __forceinline__ void prologue() const { clear_flags(clear, n_clear); }
  __device__ __forceinline__ bool live() const { return true; }
  __device__ __forceinline__ void finish() const {}
  template <int C>
  __device__ __forceinline__ void mark(int64_t plane, int64_t, const bool (&ch)[C]) const {
    bool any = false;
#pragma unroll
    for (int v = 0; v < C; ++v) any |= ch[v];
    if (__any_sync(0xffffffffu, any) && threadIdx.x % kWarp == 0) changed[plane] = true;
  }
};

// #15: one flag per (row, window of `slab` columns), stored once per warp
// and column stride.  A warp's 32 columns of one stride start at w0, a
// multiple of 32, so where slab % 32 == 0 (the entry checks it) they lie in
// one window, w0 / slab.  On the grid it takes one column a thread (four:
// 9% slower over bandw's 30 rounds and 15% over the partitioned batch's
// on an H100, tools/path_times.py).
struct WindowFlags {
  static constexpr int kGridCols = 1;
  static constexpr bool kProgress = false;
  static constexpr bool kRowProgress = false;
  int* flags;
  int64_t n_slabs, slab;
  int* clear;
  int64_t n_clear;
  __device__ __forceinline__ void prologue() const { clear_flags(clear, n_clear); }
  __device__ __forceinline__ bool live() const { return true; }
  __device__ __forceinline__ void finish() const {}
  template <int C>
  __device__ __forceinline__ void mark(int64_t plane, int64_t w0, const bool (&ch)[C]) const {
#pragma unroll
    for (int v = 0; v < C; ++v)
      if (__any_sync(0xffffffffu, ch[v]) && threadIdx.x % kWarp == 0)
        flags[plane * n_slabs + (w0 + v * kThreads) / slab] = 1;
  }
};

// The loop carry of a single instance's fixed point: int32 fields, kept by
// the round closure for the whole fixed point (core/carry.py).
constexpr int kCarryFlag = 0;    // this round tightened a bound
constexpr int kCarryAny = 1;     // changed_any over the current check group
constexpr int kCarryRounds = 2;  // rounds counted
constexpr int kCarryGo = 3;      // the reference's cond: the loop goes on
constexpr int kCarryTicket = 4;  // blocks of this launch that are done
constexpr int kCarryFlat = 5;    // the early stop: consecutive low-progress check groups
constexpr int kCarryLast = 6;    // the early stop: the last check group's changed_any
constexpr int kCarryProg = 8;    // the early stop: the last round's progress, a T at int 8
constexpr int kCarryCross = 10;  // telemetry on the host loop: the round's bounds crossed

// The carry's measure, a T at int32 field kCarryProg (a 16-bit one in the
// field's low half: the card is little-endian), stored and loaded through
// volatile accesses.
template <typename T>
__device__ __forceinline__ void store_prog(int* carry, T v) {
  *reinterpret_cast<volatile T*>(carry + kCarryProg) = v;
}
template <typename F>
__device__ __forceinline__ void store_prog(int* carry, Lo16<F> v) {
  *reinterpret_cast<volatile unsigned short*>(carry + kCarryProg) = v.bits;
}
template <typename T>
__device__ __forceinline__ T load_prog(const int* carry) {
  if constexpr (std::is_same_v<T, double> || std::is_same_v<T, float>) {
    return *reinterpret_cast<const volatile T*>(carry + kCarryProg);
  } else {
    T v;
    v.bits = *reinterpret_cast<const volatile unsigned short*>(carry + kCarryProg);
    return v;
  }
}

// F's flags, and #15's for one instance: a warp that tightens stores the
// carry's flag once.  A launch whose carry says `go` is false (a round
// enqueued after the fixed point converged) merges nothing and counts
// nothing.  Otherwise the launch's last block (a ticket taken after a
// fence) folds the flag into the carry as the reference's while_loop
// does: changed_any |= flag; at the end of a check group of `unroll`
// rounds (k == unroll - 1) rounds += unroll and go = changed_any, and
// changed_any restarts; the flag and the ticket go back to 0.  So no
// fill precedes a round, and nothing is read on the host.
struct CarryFlags {
  static constexpr int kGridCols = 4;
  static constexpr bool kProgress = false;
  static constexpr bool kRowProgress = false;
  int* carry;
  int k, unroll;
  __device__ __forceinline__ void prologue() const {}
  __device__ __forceinline__ bool live() const {
    return *reinterpret_cast<volatile int*>(carry + kCarryGo) != 0;
  }
  template <int C>
  __device__ __forceinline__ void mark(int64_t, int64_t, const bool (&ch)[C]) const {
    bool any = false;
#pragma unroll
    for (int v = 0; v < C; ++v) any |= ch[v];
    if (__any_sync(0xffffffffu, any) && threadIdx.x % kWarp == 0) carry[kCarryFlag] = 1;
  }
  // Every thread of every live block calls it, last.  Every thread fences
  // before the barrier, so the ticket is taken once the block's flag stores
  // are visible to the card (fencing only the storing lanes was 7% slower
  // on pb's first round on an H100: tools/f_variants.py).
  __device__ __forceinline__ void finish() const {
    __shared__ bool last;
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
      const int blocks = static_cast<int>(gridDim.x * gridDim.y);
      last = atomicAdd(carry + kCarryTicket, 1) == blocks - 1;
    }
    __syncthreads();
    if (!last || threadIdx.x != 0) return;
    __threadfence();
    volatile int* c = carry;
    int any = c[kCarryAny] | c[kCarryFlag];
    if (k == unroll - 1) {
      c[kCarryRounds] = c[kCarryRounds] + unroll;
      c[kCarryGo] = any;
      any = 0;
    }
    c[kCarryAny] = any;
    c[kCarryFlag] = 0;
    c[kCarryTicket] = 0;
  }
};

// F's flags with the early stop armed (the reference's
// `flat = prog < stop ? flat + 1 : 0` and `cond &= flat < patience`,
// src/repro/kernels/ops.py:1292-1308): CarryFlags, and the round's
// progress measure over the columns the launch merges, in one fixed order.
// Each block sums its threads' terms (merge_item: each thread its C
// columns in order), then each warp by the butterfly of group_sum, then
// its eight warp sums left to right, into its entry of `partials` (one per
// block, kept by the round closure: nothing allocated per round).  The
// last block's first warp sums the partials in block order as
// ref.warp_order_sum does (lane l takes blocks l, l + 32, ..., then the
// butterfly) and folds: rounds += 1, the measure stored at kCarryProg, flat
// updated, last = changed_any, go = changed_any && flat < patience.
// ref.merge_order_sum is this order.  A check group is one round here (the
// wrapper takes unroll 1 only).  The sums run in Num<T>::Acc (float for
// the 16-bit types, whose measure is then rounded to T once, as the
// reference's progress_measure reduces its terms in float32).
template <typename T>
struct StopCarryFlags {
  using Acc = typename Num<T>::Acc;
  static constexpr int kGridCols = 4;
  static constexpr bool kProgress = true;
  static constexpr bool kRowProgress = false;
  int* carry;
  Acc* partials;
  T stop;
  int patience;
  __device__ __forceinline__ void prologue() const {}
  __device__ __forceinline__ bool live() const {
    return *reinterpret_cast<volatile int*>(carry + kCarryGo) != 0;
  }
  template <int C>
  __device__ __forceinline__ void mark(int64_t, int64_t, const bool (&ch)[C]) const {
    bool any = false;
#pragma unroll
    for (int v = 0; v < C; ++v) any |= ch[v];
    if (__any_sync(0xffffffffu, any) && threadIdx.x % kWarp == 0) carry[kCarryFlag] = 1;
  }
  // Every thread of every live block calls it, last, with its own sum.
  __device__ __forceinline__ void finish_progress(Acc prog) const {
    __shared__ Acc warp_sums[kWarpsPerBlock];
    __shared__ bool last;
    const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
    prog = group_sum<kWarp>(prog);
    if (lane == 0) warp_sums[warp] = prog;
    __syncthreads();
    if (threadIdx.x == 0) {
      Acc sum = warp_sums[0];
#pragma unroll
      for (int w = 1; w < kWarpsPerBlock; ++w) sum += warp_sums[w];
      partials[static_cast<int64_t>(blockIdx.y) * gridDim.x + blockIdx.x] = sum;
    }
    __threadfence();
    __syncthreads();
    const int blocks = static_cast<int>(gridDim.x * gridDim.y);
    if (threadIdx.x == 0) last = atomicAdd(carry + kCarryTicket, 1) == blocks - 1;
    __syncthreads();
    if (!last || warp != 0) return;
    __threadfence();
    Acc sum = Acc(0);
    for (int b = lane; b < blocks; b += kWarp) sum += __ldcg(partials + b);
    sum = group_sum<kWarp>(sum);
    if (lane != 0) return;
    const T total = T(sum);
    volatile int* c = carry;
    const int any = c[kCarryAny] | c[kCarryFlag];
    store_prog(carry, total);
    const int flat = total < stop ? c[kCarryFlat] + 1 : 0;
    c[kCarryRounds] = c[kCarryRounds] + 1;
    c[kCarryFlat] = flat;
    c[kCarryLast] = any;
    c[kCarryGo] = any != 0 && flat < patience;
    c[kCarryAny] = 0;
    c[kCarryFlag] = 0;
    c[kCarryTicket] = 0;
  }
};

// #9's flags with the early stop's measure armed (the reference's per-row
// stop, src/repro/core/propagator.py:388-414): RowFlags, and each active
// row's progress measure over its columns, in one fixed order.  Each
// (row, block of 1,024 columns) item sums its threads' terms (merge_item:
// each thread its four columns in order), then each warp by the butterfly
// of group_sum, then its eight warp sums left to right, into its entry of
// the (bsz, n_blocks) `partials` (kept by the round closure: nothing
// allocated per round).  The launch's last block (an atomic ticket taken
// after every block's fence, reset by that block) sums each active row's
// partials in block order as ref.warp_order_sum does (a warp per row: lane
// l takes blocks l, l + 32, ..., then the butterfly; the warps ballot the
// mask a word at a time) into prog[row];
// ref.merge_order_sum is this order, row by row.  Inactive rows' partials
// and prog entries are not written.  The walk (kMergeCols) and the grid
// (kGridCols) both take 1,024 columns an item, so one layout serves both.
// The streak and the mask are the caller's (B,) operations on prog.  The
// sums run in Num<T>::Acc (float partials for the 16-bit types, each row's
// measure rounded to T once, as the reference's progress_measure reduces
// its terms in float32).
template <typename T>
struct RowStopFlags {
  using Acc = typename Num<T>::Acc;
  static constexpr int kGridCols = 4;
  static constexpr bool kProgress = true;
  static constexpr bool kRowProgress = true;
  bool* changed;
  bool* clear;
  int64_t n_clear;
  Acc* partials;
  T* prog;
  int* ticket;
  const bool* active;
  int64_t n_blocks;
  __device__ __forceinline__ void prologue() const { clear_flags(clear, n_clear); }
  __device__ __forceinline__ bool live() const { return true; }
  __device__ __forceinline__ void finish() const {}
  template <int C>
  __device__ __forceinline__ void mark(int64_t plane, int64_t, const bool (&ch)[C]) const {
    bool any = false;
#pragma unroll
    for (int v = 0; v < C; ++v) any |= ch[v];
    if (__any_sync(0xffffffffu, any) && threadIdx.x % kWarp == 0) changed[plane] = true;
  }
  // Every thread of the block calls it after each item, with its own sum.
  __device__ __forceinline__ void item_progress(Acc prog_t, int64_t plane, int64_t blk) const {
    __shared__ Acc warp_sums[kWarpsPerBlock];
    const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
    prog_t = group_sum<kWarp>(prog_t);
    if (lane == 0) warp_sums[warp] = prog_t;
    __syncthreads();
    if (threadIdx.x == 0) {
      Acc sum = warp_sums[0];
#pragma unroll
      for (int w = 1; w < kWarpsPerBlock; ++w) sum += warp_sums[w];
      partials[plane * n_blocks + blk] = sum;
    }
    __syncthreads();  // warp_sums serves the block's next item
  }
  // Every thread of every block calls it, last (the blocks of an inactive
  // row on the grid included).
  __device__ __forceinline__ void finish_rows(int64_t bsz) const {
    __shared__ bool last;
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
      const int blocks = static_cast<int>(gridDim.x * gridDim.y);
      last = atomicAdd(ticket, 1) == blocks - 1;
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    if (threadIdx.x == 0) *ticket = 0;
    // Warp w takes the mask's words w, w + 8, ...: one ballot reads its 32
    // flags at once, then it sums each active row of the word in turn.
    const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
    for (int64_t b0 = static_cast<int64_t>(warp) * kWarp; b0 < bsz;
         b0 += static_cast<int64_t>(kWarpsPerBlock) * kWarp) {
      unsigned int todo = __ballot_sync(0xffffffffu, b0 + lane < bsz && active[b0 + lane]);
      while (todo != 0u) {
        const int64_t b = b0 + __ffs(todo) - 1;
        todo &= todo - 1u;
        const Acc* row = partials + b * n_blocks;
        Acc total = Acc(0);
        for (int64_t i = lane; i < n_blocks; i += kWarp) total += __ldcg(row + i);
        total = group_sum<kWarp>(total);
        if (lane == 0) prog[b] = T(total);
      }
    }
  }
};

// #15's flags with the batched early stop's measure armed: WindowFlags'
// window flags and RowStopFlags' per-row measure, so a row's measure is
// summed over all its windows in #9's fixed order (each (row, block of
// 1,024 columns) item's sum into `partials`, then the launch's last block
// sums each active row's items in block order; ref.merge_order_sum per
// row).  On the grid as on the walk an item is 1,024 columns, four a
// thread, so one layout serves both, as #9's.
template <typename T>
struct WindowStopFlags {
  using Acc = typename Num<T>::Acc;
  static constexpr int kGridCols = 4;
  static constexpr bool kProgress = true;
  static constexpr bool kRowProgress = true;
  int* flags;
  int64_t n_slabs, slab;
  int* clear;
  int64_t n_clear;
  Acc* partials;
  T* prog;
  int* ticket;
  const bool* active;
  int64_t n_blocks;
  __device__ __forceinline__ WindowFlags windows() const {
    return WindowFlags{flags, n_slabs, slab, clear, n_clear};
  }
  __device__ __forceinline__ RowStopFlags<T> rows() const {
    return RowStopFlags<T>{nullptr, nullptr, 0, partials, prog, ticket, active, n_blocks};
  }
  __device__ __forceinline__ void prologue() const { clear_flags(clear, n_clear); }
  __device__ __forceinline__ bool live() const { return true; }
  __device__ __forceinline__ void finish() const {}
  template <int C>
  __device__ __forceinline__ void mark(int64_t plane, int64_t w0, const bool (&ch)[C]) const {
    windows().template mark<C>(plane, w0, ch);
  }
  __device__ __forceinline__ void item_progress(Acc prog_t, int64_t plane, int64_t blk) const {
    rows().item_progress(prog_t, plane, blk);
  }
  __device__ __forceinline__ void finish_rows(int64_t bsz) const { rows().finish_rows(bsz); }
};

// The merge of block `blk` of C * kThreads columns of row `plane`, C
// columns a thread; every thread of the block calls it.  Where the flags
// take the early stop's progress (Flags::kProgress), it returns this
// thread's sum of the progress measure's terms over its columns, in column
// order from +0.0 (bounds.progress_measure's term: (l' - l) / (1 + max(|l|,
// |l'|)) + (u - u') / (1 + max(|u|, |u'|)), in T; the sum in
// Num<T>::Acc); else 0.  The candidates come from planes of Num<T>::Plane
// (float beside 16-bit bounds: they narrow back exactly).
template <int C, typename Flags, typename T>
__device__ __forceinline__ typename Num<T>::Acc merge_item(
    T* __restrict__ lb, T* __restrict__ ub, typename Num<T>::Plane* __restrict__ best_l,
    typename Num<T>::Plane* __restrict__ best_u, const Flags& flags, int64_t plane,
    int64_t blk, int64_t width, T eps, T inf, T outward) {
  const int64_t j0 = blk * C * kThreads + threadIdx.x, row = plane * width;
  T l[C], u[C], bl[C], bu[C];
#pragma unroll
  for (int v = 0; v < C; ++v) {
    const int64_t j = j0 + v * kThreads;
    const bool in = j < width;
    l[v] = in ? lb[row + j] : T(0);
    u[v] = in ? ub[row + j] : T(0);
    bl[v] = in ? T(best_l[row + j]) : -inf;
    bu[v] = in ? T(best_u[row + j]) : inf;
  }
  bool ch[C];
  typename Num<T>::Acc prog = 0;
#pragma unroll
  for (int v = 0; v < C; ++v) {
    const int64_t j = j0 + v * kThreads, i = row + j;
    if (bl[v] != -inf) best_l[i] = Num<T>::wide(-inf);  // merge_reset's hand-back
    if (bu[v] != inf) best_u[i] = Num<T>::wide(inf);
    if constexpr (Flags::kProgress) {
      T nl = l[v], nu = u[v];
      ch[v] = j < width &&
              merge_loaded_into(lb, ub, i, l[v], u[v], bl[v], bu[v], eps, inf, outward, nl, nu);
      if (j < width)
        prog += Num<T>::wide((nl - l[v]) / (T(1) + vmax(vabs(l[v]), vabs(nl))) +
                             (u[v] - nu) / (T(1) + vmax(vabs(u[v]), vabs(nu))));
    } else {
      ch[v] = j < width && merge_loaded(lb, ub, i, l[v], u[v], bl[v], bu[v], eps, inf, outward);
    }
  }
  flags.template mark<C>(plane, j0 - threadIdx.x % kWarp, ch);
  return prog;
}

// The hand-back alone, for a launch that merges nothing (F after the fixed
// point converged: D or E may still have scattered).
template <int C, typename T>
__device__ __forceinline__ void hand_back_item(typename Num<T>::Plane* __restrict__ best_l,
                                               typename Num<T>::Plane* __restrict__ best_u,
                                               int64_t plane, int64_t blk, int64_t width,
                                               T inf) {
  const int64_t j0 = blk * C * kThreads + threadIdx.x, row = plane * width;
  const typename Num<T>::Plane lo = Num<T>::wide(-inf), hi = Num<T>::wide(inf);
#pragma unroll
  for (int v = 0; v < C; ++v) {
    const int64_t j = j0 + v * kThreads;
    if (j >= width) break;
    if (best_l[row + j] != lo) best_l[row + j] = lo;
    if (best_u[row + j] != hi) best_u[row + j] = hi;
  }
}

template <typename Flags, typename T>
__global__ void __launch_bounds__(kThreads)
merge_walk_kernel(T* __restrict__ lb, T* __restrict__ ub,
                  typename Num<T>::Plane* __restrict__ best_l,
                  typename Num<T>::Plane* __restrict__ best_u, const bool* __restrict__ active,
                  Flags flags, int64_t bsz, int64_t width, T eps, T inf, T outward) {
  flags.prologue();
  const EqualItems items_of{(width + kMergeBlock - 1) / kMergeBlock};
  const Walk walk = ballot_walk(active, bsz, items_of);
  WalkCursor cur;
  for (int64_t item = blockIdx.x; item < walk.items; item += gridDim.x) {
    cur.seek(item, walk, items_of);
    const auto prog = merge_item<kMergeCols>(lb, ub, best_l, best_u, flags, cur.plane,
                                             item - cur.first, width, eps, inf, outward);
    if constexpr (Flags::kRowProgress) flags.item_progress(prog, cur.plane, item - cur.first);
  }
  if constexpr (Flags::kRowProgress) flags.finish_rows(bsz);
}

// Grid (column blocks, rows), C columns a thread: the blocks of an
// inactive row return at once.  kMasked false (F) reads no mask.  A block
// whose flags are not live (a converged carry) only hands its entries back.
template <int C, typename Flags, bool kMasked, typename T>
__global__ void __launch_bounds__(kThreads)
merge_grid_kernel(T* __restrict__ lb, T* __restrict__ ub,
                  typename Num<T>::Plane* __restrict__ best_l,
                  typename Num<T>::Plane* __restrict__ best_u, const bool* __restrict__ active,
                  Flags flags, int64_t width, T eps, T inf, T outward) {
  flags.prologue();
  if (kMasked && !active[blockIdx.y]) {
    if constexpr (Flags::kRowProgress) flags.finish_rows(gridDim.y);
    return;
  }
  if (!flags.live()) {
    hand_back_item<C>(best_l, best_u, blockIdx.y, blockIdx.x, width, inf);
    return;
  }
  const auto prog = merge_item<C>(lb, ub, best_l, best_u, flags, blockIdx.y, blockIdx.x, width,
                                  eps, inf, outward);
  if constexpr (Flags::kRowProgress) {
    flags.item_progress(prog, blockIdx.y, blockIdx.x);
    flags.finish_rows(gridDim.y);
  } else if constexpr (Flags::kProgress) {
    flags.finish_progress(prog);
  } else {
    flags.finish();
  }
}

// Zero a flag buffer where the launch has no block to do it.
template <typename T>
inline cudaError_t clear_without_blocks(T* clear, int64_t n, cudaStream_t stream) {
  if (clear == nullptr || n <= 0) return cudaSuccess;
  return cudaMemsetAsync(clear, 0, static_cast<size_t>(n) * sizeof(T), stream);
}

// The merge over (bsz, width) planes on the walk: at most one block per
// item.
template <typename Flags, typename T>
int launch_merge_walk(T* lb, T* ub, typename Num<T>::Plane* best_l,
                      typename Num<T>::Plane* best_u, const bool* active, Flags flags,
                      int64_t bsz, int64_t width, T eps, T inf, T outward, cudaStream_t stream) {
  const int64_t most = (width + kMergeBlock - 1) / kMergeBlock * bsz;
  if (most <= 0) clear_without_blocks(flags.clear, flags.n_clear, stream);
  return launch_walk<merge_walk_kernel<Flags, T>>(most, bsz, stream, lb, ub, best_l, best_u,
                                                  active, flags, bsz, width, eps, inf, outward);
}

// The merge over (bsz, width) planes on the (column block, row) grid, C
// columns a thread; no mask read where kMasked is false.
template <typename Flags, int C = Flags::kGridCols, bool kMasked = true, typename T>
int launch_merge_grid(T* lb, T* ub, typename Num<T>::Plane* best_l,
                      typename Num<T>::Plane* best_u, const bool* active, Flags flags,
                      int64_t bsz, int64_t width, T eps, T inf, T outward, cudaStream_t stream) {
  const int64_t blocks = (width + C * kThreads - 1) / (C * kThreads);
  if (blocks > 0 && bsz > 0)
    merge_grid_kernel<C, Flags, kMasked, T><<<dim3(static_cast<unsigned int>(blocks),
                                                   static_cast<unsigned int>(bsz)),
                                              kThreads, 0, stream>>>(
        lb, ub, best_l, best_u, active, flags, width, eps, inf, outward);
  return static_cast<int>(cudaGetLastError());
}

// The merge over (bsz, width) planes: the grid for at most kMergeGridRows
// rows, else the walk.
template <typename Flags, typename T>
int launch_merge(T* lb, T* ub, typename Num<T>::Plane* best_l, typename Num<T>::Plane* best_u,
                 const bool* active, Flags flags, int64_t bsz, int64_t width, T eps, T inf,
                 T outward, cudaStream_t stream) {
  if (bsz <= kMergeGridRows) {
    const int64_t blocks = (width + Flags::kGridCols * kThreads - 1) /
                           (Flags::kGridCols * kThreads);
    if (blocks <= 0 || bsz <= 0) clear_without_blocks(flags.clear, flags.n_clear, stream);
    return launch_merge_grid<Flags>(lb, ub, best_l, best_u, active, flags, bsz, width, eps, inf,
                                    outward, stream);
  }
  return launch_merge_walk<Flags>(lb, ub, best_l, best_u, active, flags, bsz, width, eps, inf,
                                  outward, stream);
}

// One short row segment [s, e) of chunk partials summed left to right from
// 0 by one thread (the long-row combine's order), written back to each of
// its chunks.
template <typename T>
__device__ __forceinline__ void combine_segment(const T* __restrict__ mf,
                                                const int* __restrict__ mc,
                                                const T* __restrict__ xf,
                                                const int* __restrict__ xc, T* __restrict__ omf,
                                                int* __restrict__ omc, T* __restrict__ oxf,
                                                int* __restrict__ oxc, int64_t s, int64_t e) {
  T a = T(0), b = T(0);
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

// Steps of 32 chunks whose partials a warp of the long-row combine loads at
// once; the next group's loads are in flight during this group's adds.
constexpr int kCombineSteps = 4;
constexpr int kCombineGroup = kCombineSteps * kWarp;

template <int U, typename T = double>
struct StepPartials {
  T mf[U], xf[U];
  int mc[U], xc[U];
};

// Chunks e0 + 32 u + lane of the segment ending at e (0 past it).
template <int U, typename T>
__device__ __forceinline__ void load_steps(StepPartials<U, T>& p, const T* __restrict__ mf,
                                           const int* __restrict__ mc,
                                           const T* __restrict__ xf,
                                           const int* __restrict__ xc, int64_t e0, int64_t e,
                                           int lane) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int64_t i = e0 + u * kWarp + lane;
    const bool in = i < e;
    p.mf[u] = in ? mf[i] : T(0);
    p.xf[u] = in ? xf[i] : T(0);
    p.mc[u] = in ? mc[i] : 0;
    p.xc[u] = in ? xc[i] : 0;
  }
}

// One long row segment [s, e) by a whole warp (every lane calls it with the
// same s, e; sm is the warp's own 2 * kCombineGroup values of shared
// memory): the partials of kCombineGroup chunks loaded coalesced, the next
// group's loads in flight while this group is summed; the group's float
// partials staged in shared memory, from which every lane reads them back
// in chunk order (broadcast loads), so every lane holds the float sums
// taken left to right from +0.0, exactly as combine_segment takes them; the
// integer counts by a warp reduction (exact in any order); then a
// coalesced write-back to every chunk.
template <typename T>
__device__ __forceinline__ void combine_segment_warp(
    const T* __restrict__ mf, const int* __restrict__ mc, const T* __restrict__ xf,
    const int* __restrict__ xc, T* __restrict__ omf, int* __restrict__ omc,
    T* __restrict__ oxf, int* __restrict__ oxc, int64_t s, int64_t e, int lane, T* sm) {
  constexpr int U = kCombineSteps;
  T a = T(0), b = T(0);
  int ca = 0, cb = 0;
  StepPartials<U, T> next;
  load_steps(next, mf, mc, xf, xc, s, e, lane);
  for (int64_t j0 = s; j0 < e; j0 += kCombineGroup) {
    const StepPartials<U, T> cur = next;
    if (j0 + kCombineGroup < e) load_steps(next, mf, mc, xf, xc, j0 + kCombineGroup, e, lane);
    __syncwarp();  // every lane has read the previous group
#pragma unroll
    for (int u = 0; u < U; ++u) {
      sm[u * kWarp + lane] = cur.mf[u];
      sm[kCombineGroup + u * kWarp + lane] = cur.xf[u];
      ca += cur.mc[u];
      cb += cur.xc[u];
    }
    __syncwarp();
    if (e - j0 >= kCombineGroup) {
#pragma unroll
      for (int i = 0; i < kCombineGroup; ++i) {
        a += sm[i];
        b += sm[kCombineGroup + i];
      }
    } else {
      const int n = static_cast<int>(e - j0);
      for (int i = 0; i < n; ++i) {
        a += sm[i];
        b += sm[kCombineGroup + i];
      }
    }
  }
  ca = __reduce_add_sync(0xffffffffu, ca);
  cb = __reduce_add_sync(0xffffffffu, cb);
  for (int64_t i = s + lane; i < e; i += kWarp) {
    omf[i] = a;
    omc[i] = ca;
    oxf[i] = b;
    oxc[i] = cb;
  }
}

// Blocks that cover n_chunks chunks of k slots, 32 / G chunks per warp.
unsigned int chunk_blocks(int64_t n_chunks, int k) {
  const int64_t per_block = static_cast<int64_t>(kWarpsPerBlock) * (kWarp / group_width(k));
  return static_cast<unsigned int>((n_chunks + per_block - 1) / per_block);
}

// Launch KERNEL<G> for the group width of k slots, with ARGS.
#define LAUNCH_FOR_WIDTH(KERNEL, k, n_chunks, stream, ...)                              \
  do {                                                                                \
    const unsigned int blocks_ = chunk_blocks(n_chunks, k);                           \
    switch (group_width(k)) {                                                         \
      case 1: KERNEL<1><<<blocks_, kThreads, 0, stream>>>(__VA_ARGS__); break;        \
      case 2: KERNEL<2><<<blocks_, kThreads, 0, stream>>>(__VA_ARGS__); break;        \
      case 4: KERNEL<4><<<blocks_, kThreads, 0, stream>>>(__VA_ARGS__); break;        \
      case 8: KERNEL<8><<<blocks_, kThreads, 0, stream>>>(__VA_ARGS__); break;        \
      case 16: KERNEL<16><<<blocks_, kThreads, 0, stream>>>(__VA_ARGS__); break;      \
      default: KERNEL<32><<<blocks_, kThreads, 0, stream>>>(__VA_ARGS__); break;      \
    }                                                                                 \
  } while (0)

}  // namespace
