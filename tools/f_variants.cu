// Kernel F (apply_updates, the single instance's bound merge) before its
// redesign and as the port ships it, timed side by side.  Built and driven
// by tools/f_variants.py; not part of the port's kernel library.
//
//   0  the kernel before the redesign: one thread per column (merge_reset);
//      every thread that tightens a bound stores the bool flag, which a
//      fill zeroes before the launch
//   1  the port's F: the merge body of #9 and #15 (merge_item) on a grid
//      over one plane, four columns a thread, no mask, one flag store per
//      warp, the flag folded into the loop carry by the launch's last block
//      (an atomic ticket)
#include "../src/repro_torch/csrc/round_common.cuh"

namespace {

__global__ void __launch_bounds__(kThreads)
f_before_kernel(double* __restrict__ lb, double* __restrict__ ub, double* __restrict__ best_l,
                double* __restrict__ best_u, bool* __restrict__ changed, int64_t n, double eps,
                double inf, double outward) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (merge_reset(lb, ub, best_l, best_u, i, eps, inf, outward)) *changed = true;
}

}  // namespace

extern "C" {

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

int f_variant(int variant, double* lb, double* ub, double* best_l, double* best_u,
              bool* changed, int* carry, int64_t n, double eps, double inf,
              cudaStream_t stream) {
  switch (variant) {
    case 0: {
      const unsigned int blocks = static_cast<unsigned int>((n + kThreads - 1) / kThreads);
      f_before_kernel<<<blocks, kThreads, 0, stream>>>(lb, ub, best_l, best_u, changed, n, eps,
                                                      inf, 0.0);
      return static_cast<int>(cudaGetLastError());
    }
    case 1:
      return launch_merge_grid<CarryFlags, 4, false>(lb, ub, best_l, best_u, nullptr,
                                                     CarryFlags{carry, 0, 1}, 1, n, eps, inf,
                                                     0.0, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
