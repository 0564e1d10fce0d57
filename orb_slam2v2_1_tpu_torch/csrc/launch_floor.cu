// An empty kernel: what one launch costs on the device when it does nothing.
//
// It replaces no TPU kernel and no module calls it. `kernel_times.py` and
// `chip_smoke.py` time it the way they time the real kernels (many launches in
// one CUDA graph, replayed between two events), because the bounds of both
// real kernels are a few microseconds and this is the floor under them.

#include <cuda_runtime.h>

namespace {
__global__ void empty_kernel() {}
}  // namespace

// Launches on `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int empty_launch(cudaStream_t stream) {
  empty_kernel<<<1, 32, 0, stream>>>();
  return (int)cudaGetLastError();
}
