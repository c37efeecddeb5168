// K1: DIA SpMV for Hopper (sm_90a).
//
// Replaces the TPU kernel gnnla_tpu/ops/pallas_spmv.py::_build_padded_call
// (pallas_call at :109): y[i] = sum_k diags[k, i] * x[i + off_k].
//
// Bound on the card: bytes. The function reads the K x n diagonal array
// once, x once and writes y once: (K*n + 2n) * 4 bytes (+ 4K for the
// offsets), against 2*K*n flops — about half a flop per byte, far below
// the H100's ridge point, so the kernel can at best stream the diagonals
// at the memory rate.
//
// What the design does about it:
//   * One thread per row (grid-stride). For a fixed k the threads of a
//     warp read diags[k, i..i+31] and x[i+off_k .. i+off_k+31]: both are
//     contiguous, so every load coalesces and the diagonal stream — the
//     K*n term that dominates the bytes — is read exactly once.
//   * x is small next to the diagonals (n floats vs K*n) and is re-read
//     K times at shifted positions; those re-reads hit L1/L2 (the x of
//     the 1024^2 problem is 4 MB, the L2 50 MB), so device memory sees
//     x about once.
//   * The offsets (K <= a few hundred) are staged in shared memory once
//     per block instead of being re-read from global memory per row.
//   * No halo padding: the guard 0 <= i + off_k < n replaces the TPU's
//     zeroed halo tiles (DIA stores structural zeros there anyway), so
//     the caller passes plain [n] vectors.
//   * Accumulation is f32, in k order — the order of the plain PyTorch
//     version (ops/dia.py::dia_matvec). The compiler contracts each
//     step into an FMA, so the two agree to f32 rounding, not bitwise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
dia_spmv_kernel(const float* __restrict__ diags,
                const int* __restrict__ offsets, int K, int n,
                const float* __restrict__ x, float* __restrict__ y) {
  extern __shared__ int s_off[];
  for (int k = threadIdx.x; k < K; k += blockDim.x) s_off[k] = offsets[k];
  __syncthreads();

  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const float* d = diags + i;
    float acc = 0.0f;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const int j = i + s_off[k];
      if (j >= 0 && j < n) acc += d[(int64_t)k * n] * __ldg(x + j);
    }
    y[i] = acc;
  }
}

}  // namespace

// diags [K, n] f32, offsets [K] int32, x [n] f32, y [n] f32, all on the
// current device; `stream` is a cudaStream_t. Returns cudaGetLastError().
extern "C" int dia_spmv_f32(const void* diags, const void* offsets, int K,
                            int n, const void* x, void* y, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  const size_t smem = (size_t)K * sizeof(int);
  dia_spmv_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)diags, (const int*)offsets, K, n, (const float*)x,
      (float*)y);
  return (int)cudaGetLastError();
}
