// K5: the build-and-launch health probe, y = 2 x, for Hopper (sm_90a).
//
// Replaces the TPU kernel bench.py::_pallas_health_probe (:148,
// pallas_call at :162), which doubles one (8, 128) f32 block to check
// that the TPU's compile service builds and runs a kernel. Here it checks
// that the library built from csrc/ loads and that a launch on the card
// runs and returns exact results (utils/health.py::health_probe).
//
// Bound on the card: bytes, 8 KB (4 KB read, 4 KB written) at 3.35 TB/s,
// about 2.4 ns; any launch takes microseconds, so launch latency sets the
// time. The design is the TPU block's: one CUDA block per row of 128
// lanes, one thread per element, an exact multiply by 2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;  // threads per block: one TPU lane row

__global__ void health_kernel(const float* __restrict__ x,
                              float* __restrict__ y, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * kLanes + threadIdx.x;
  if (i < n) y[i] = 2.0f * x[i];
}

}  // namespace

extern "C" int health_f32(const void* x, void* y, int64_t n, void* stream) {
  if (n <= 0) return 0;
  const int64_t blocks = (n + kLanes - 1) / kLanes;
  health_kernel<<<(unsigned)blocks, kLanes, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)y, n);
  return (int)cudaGetLastError();
}
