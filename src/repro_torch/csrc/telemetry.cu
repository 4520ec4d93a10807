// Hopper (sm_90a) kernels of the device telemetry (ROADMAP Queue 1 item 6):
// one launch per round records the round's sample into a telemetry plane
// (repro_torch/obs/telemetry.py), after the round's last kernel, with no
// host read.  The reference records with jnp ops inside its while_loop
// body (src/repro/obs/telemetry.py:93, called at
// src/repro/kernels/ops.py:1302 and src/repro/core/propagator.py:309,
// :408); it has no Pallas kernel.
//
//   record_round[_f32]        one instance's fixed point, reading the loop
//                             carry (core/carry.py): float64 and float32
//                             bounds, the ring in the bounds' dtype
//   record_round_batch[_f32]  one round of a batched fixed point over
//                             (B, n) planes
//
// record_round: a grid over the n columns.  Where the carry's ROUNDS has
// not passed unroll * ticks (a check group enqueued after GO cleared: the
// merge counted nothing) every block returns before reading a column:
// nothing is recorded.  Otherwise each thread tests its columns for
// lb > ub + feas_eps (in T, padding included, as the reference's
// jnp.any(nlb > nub + feas_eps)), each block ORs its threads' hits into
// scratch[1] and takes a ticket (scratch[0]) after a fence; the last block
// (StopCarryFlags::finish_progress's pattern, round_common.cuh) writes the
// carry's PROG to ring[ticks % cap], counts ticks, latches infeas_round at
// ROUNDS on a hit and, with an early stop armed (patience > 0),
// stop_round at ROUNDS where FLAT >= patience, and resets the scratch.
// With cap == 0 (the host loop, no plane) it records nothing: the last
// block writes the probe into the carry's CROSS field, which the host reads
// with the rest of the carry.
//
// record_round_batch: a (column block, row) grid; the rows that did not
// run this round (ran[row] == false) read nothing but take their ticket.
// The last block records each row that ran, as
// obs.telemetry.record_round(..., active=ran) does: prog[row] (the row's
// measure, written by #9's or #15's row form) to its ring, ticks counted,
// infeas_round and stop_round latched at rounds[row] (stop_round where
// flat[row] >= patience, patience > 0), and resets the scratch (a ticket
// and one hit flag per row).
//
// Bound on the H100: the two bound planes read once (2 * n * sizeof(T) per
// recorded row) plus the carry or the (B,) lanes; launch latency dominates.
//
// Build with --fmad=false (kernels/_build.py).  Every entry point returns
// cudaGetLastError() after its launch.

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
  ring[t % cap] = *reinterpret_cast<volatile T*>(carry + kCarryProg);
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

extern "C" {

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

int record_round(const double* lb, const double* ub, int* carry, double* ring, int* ticks,
                 int* stop_round, int* infeas_round, int* scratch, int64_t n, int cap,
                 int unroll, int patience, double feas_eps, cudaStream_t stream) {
  return launch_record_round(lb, ub, carry, ring, ticks, stop_round, infeas_round, scratch, n,
                             cap, unroll, patience, feas_eps, stream);
}

int record_round_f32(const float* lb, const float* ub, int* carry, float* ring, int* ticks,
                     int* stop_round, int* infeas_round, int* scratch, int64_t n, int cap,
                     int unroll, int patience, float feas_eps, cudaStream_t stream) {
  return launch_record_round(lb, ub, carry, ring, ticks, stop_round, infeas_round, scratch, n,
                             cap, unroll, patience, feas_eps, stream);
}

int record_round_batch(const double* lb, const double* ub, const double* prog, const bool* ran,
                       const int* rounds, const int* flat, double* ring, int* ticks,
                       int* stop_round, int* infeas_round, int* scratch, int64_t bsz,
                       int64_t n, int cap, int patience, double feas_eps, cudaStream_t stream) {
  return launch_record_round_batch(lb, ub, prog, ran, rounds, flat, ring, ticks, stop_round,
                                   infeas_round, scratch, bsz, n, cap, patience, feas_eps,
                                   stream);
}

int record_round_batch_f32(const float* lb, const float* ub, const float* prog, const bool* ran,
                           const int* rounds, const int* flat, float* ring, int* ticks,
                           int* stop_round, int* infeas_round, int* scratch, int64_t bsz,
                           int64_t n, int cap, int patience, float feas_eps,
                           cudaStream_t stream) {
  return launch_record_round_batch(lb, ub, prog, ran, rounds, flat, ring, ticks, stop_round,
                                   infeas_round, scratch, bsz, n, cap, patience, feas_eps,
                                   stream);
}

}  // extern "C"
