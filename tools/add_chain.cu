// Latency of the long-row combine's in-order float64 sum on one warp, in
// clock cycles per chunk (tools/add_chain.py): the dependent adds alone,
// their operands in registers; and the same adds fed from shared memory
// (the combine's staging) and by shuffles.  One warp, one block.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;

__global__ void chain_kernel(const double* __restrict__ x, double* out, long long* cycles,
                             int n, int mode) {
  __shared__ double sm[kWarp];
  const int lane = threadIdx.x;
  const double mine = x[lane];
  sm[lane] = mine;
  double v[kWarp];
#pragma unroll
  for (int k = 0; k < kWarp; ++k) v[k] = x[k];
  __syncwarp();
  double a = 0.0;
  const long long t0 = clock64();
  for (int r = 0; r < n; r += kWarp) {
    if (mode == 0) {
#pragma unroll
      for (int k = 0; k < kWarp; ++k) a += v[k];
    } else if (mode == 1) {
#pragma unroll
      for (int k = 0; k < kWarp; ++k) a += sm[k];
    } else {
#pragma unroll
      for (int k = 0; k < kWarp; ++k) a += __shfl_sync(0xffffffffu, mine, k);
    }
  }
  const long long t1 = clock64();
  if (lane == 0) {
    out[0] = a;
    cycles[0] = t1 - t0;
  }
}

}  // namespace

extern "C" int add_chain(const double* x, double* out, long long* cycles, int n, int mode,
                         cudaStream_t stream) {
  chain_kernel<<<1, kWarp, 0, stream>>>(x, out, cycles, n, mode);
  return static_cast<int>(cudaGetLastError());
}
