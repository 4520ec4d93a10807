// The record kernels of the device telemetry (see telemetry.cu for the
// design), templated on the value type T of the bounds and the ring:
// telemetry.cu instantiates them at double and float, half_round.cu
// record_round at the 16-bit types (the carry's measure in its field's
// low half, round_common.cuh load_prog).

#pragma once

#include "round_common.cuh"

namespace {

constexpr int64_t kRecordCols = 2048;  // columns a block tests (8 a thread)
constexpr int64_t kRecordMaxBlocks = 1024;

inline int record_blocks(int64_t n) {
  const int64_t b = (n + kRecordCols - 1) / kRecordCols;
  return static_cast<int>(b < 1 ? 1 : (b > kRecordMaxBlocks ? kRecordMaxBlocks : b));
}

// Whether any column of [lb, ub) this thread visits crosses, ORed over the
// block (every thread of the block returns the same).
template <typename T>
__device__ __forceinline__ bool block_crossed(const T* __restrict__ lb, const T* __restrict__ ub,
                                              int64_t n, T feas_eps, bool visit) {
  bool hit = false;
  if (visit) {
    const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
    for (int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; j < n;
         j += stride)
      hit |= lb[j] > ub[j] + feas_eps;
  }
  return __syncthreads_or(hit) != 0;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    record_round_kernel(const T* __restrict__ lb, const T* __restrict__ ub, int* carry, T* ring,
                        int* ticks, int* stop_round, int* infeas_round, int* scratch, int64_t n,
                        int cap, int unroll, int patience, T feas_eps) {
  volatile int* c = carry;
  int t = 0;
  if (cap > 0) {
    t = *reinterpret_cast<volatile int*>(ticks);
    if (c[kCarryRounds] <= t * unroll) return;  // every block sees the same
  }
  const bool hit = block_crossed(lb, ub, n, feas_eps, true);
  __shared__ bool last;
  if (threadIdx.x == 0) {
    if (hit) atomicOr(scratch + 1, 1);
    __threadfence();
    last = atomicAdd(scratch, 1) == static_cast<int>(gridDim.x) - 1;
  }
  __syncthreads();
  if (!last || threadIdx.x != 0) return;
  __threadfence();
  const bool crossed = atomicExch(scratch + 1, 0) != 0;
  scratch[0] = 0;
  if (cap == 0) {
    c[kCarryCross] = crossed ? 1 : 0;
    return;
  }
  const int rounds = c[kCarryRounds];
  ring[t % cap] = load_prog<T>(carry);
  *ticks = t + 1;
  if (crossed && *infeas_round < 0) *infeas_round = rounds;
  if (patience > 0 && c[kCarryFlat] >= patience && *stop_round < 0) *stop_round = rounds;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    record_round_batch_kernel(const T* __restrict__ lb, const T* __restrict__ ub,
                              const T* __restrict__ prog, const bool* __restrict__ ran,
                              const int* __restrict__ rounds, const int* __restrict__ flat,
                              T* ring, int* ticks, int* stop_round, int* infeas_round,
                              int* scratch, int64_t bsz, int64_t n, int cap, int patience,
                              T feas_eps) {
  const int64_t row = blockIdx.y;
  const bool hit = block_crossed(lb + row * n, ub + row * n, n, feas_eps, ran[row]);
  __shared__ bool last;
  if (threadIdx.x == 0) {
    if (hit) atomicOr(scratch + 1 + row, 1);
    __threadfence();
    last = atomicAdd(scratch, 1) == static_cast<int>(gridDim.x * gridDim.y) - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int64_t b = threadIdx.x; b < bsz; b += kThreads) {
    const bool crossed = atomicExch(scratch + 1 + b, 0) != 0;
    if (!ran[b]) continue;
    const int t = ticks[b];
    ring[b * cap + t % cap] = prog[b];
    ticks[b] = t + 1;
    if (crossed && infeas_round[b] < 0) infeas_round[b] = rounds[b];
    if (patience > 0 && flat[b] >= patience && stop_round[b] < 0) stop_round[b] = rounds[b];
  }
  if (threadIdx.x == 0) scratch[0] = 0;
}

template <typename T>
int launch_record_round(const T* lb, const T* ub, int* carry, T* ring, int* ticks,
                        int* stop_round, int* infeas_round, int* scratch, int64_t n, int cap,
                        int unroll, int patience, T feas_eps, cudaStream_t stream) {
  record_round_kernel<T><<<record_blocks(n), kThreads, 0, stream>>>(
      lb, ub, carry, ring, ticks, stop_round, infeas_round, scratch, n, cap, unroll, patience,
      feas_eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_record_round_batch(const T* lb, const T* ub, const T* prog, const bool* ran,
                              const int* rounds, const int* flat, T* ring, int* ticks,
                              int* stop_round, int* infeas_round, int* scratch, int64_t bsz,
                              int64_t n, int cap, int patience, T feas_eps,
                              cudaStream_t stream) {
  const dim3 grid(record_blocks(n), static_cast<unsigned>(bsz));
  record_round_batch_kernel<T><<<grid, kThreads, 0, stream>>>(
      lb, ub, prog, ran, rounds, flat, ring, ticks, stop_round, infeas_round, scratch, bsz, n,
      cap, patience, feas_eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
