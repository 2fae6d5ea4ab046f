// launch_floor.cu — an empty kernel, for Hopper (sm_90a).
//
// Replaces no TPU kernel and no path launches it. chip_smoke.py times it
// on a kernel's grid, launched through ctypes as the port's wrappers
// launch theirs, beside kernels whose work is far below a launch's cost
// (K4's warp tier, K8b): its time is the card's launch floor in that
// window, the least a launch of that grid can take whatever its body.

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" int launch_floor(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
