// K1: DIA SpMV for Hopper (sm_90a).
//
// Replaces the TPU kernel gnnla_tpu/ops/pallas_spmv.py::_build_padded_call
// (pallas_call at :109): y[i] = sum_k diags[k, i] * x[i + off_k], with the
// diagonals stored in f32 or, as its `diag_dtype=bfloat16`, in bf16.
//
// Bound on the card: bytes. The function reads the K x n diagonal array
// once, x once and writes y once: (K*n*d + 2n*4) bytes for d-byte
// diagonals (+ 4K for the offsets), against 2*K*n flops — at most half a
// flop per byte, far below the H100's ridge point, so the kernel can at
// best stream the diagonals at the memory rate. bf16 storage halves the
// dominant K*n term.
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
//     version (ops/dia.py::dia_matvec). A bf16 diagonal is widened to f32
//     exactly before its product (JAX's bf16 * f32 promotion), so on
//     bf16-exact values (the integer Laplacian) both storages give the
//     same bits. The compiler contracts each step into an FMA, so kernel
//     and plain version agree to f32 rounding, not bitwise.
//
// The gradient needs no other kernel: x's cotangent is this kernel on the
// transposed diagonals (ops/dia.py::dia_transpose), the diagonals'
// cotangent plain elementwise products, as in the JAX package.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename D>
__global__ void __launch_bounds__(kThreads)
dia_spmv_kernel(const D* __restrict__ diags, const int* __restrict__ offsets,
                int K, int n, const float* __restrict__ x,
                float* __restrict__ y) {
  extern __shared__ int s_off[];
  for (int k = threadIdx.x; k < K; k += blockDim.x) s_off[k] = offsets[k];
  __syncthreads();

  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const D* d = diags + i;
    float acc = 0.0f;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const int j = i + s_off[k];
      if (j >= 0 && j < n) acc += widen(d[(int64_t)k * n]) * __ldg(x + j);
    }
    y[i] = acc;
  }
}

template <typename D>
int launch(const void* diags, const void* offsets, int K, int n,
           const void* x, void* y, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  const size_t smem = (size_t)K * sizeof(int);
  dia_spmv_kernel<D><<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const D*)diags, (const int*)offsets, K, n, (const float*)x,
      (float*)y);
  return (int)cudaGetLastError();
}

}  // namespace

// diags [K, n] (f32 or bf16), offsets [K] int32, x [n] f32, y [n] f32, all
// on the current device; `stream` is a cudaStream_t. Each returns
// cudaGetLastError().
extern "C" int dia_spmv_f32(const void* diags, const void* offsets, int K,
                            int n, const void* x, void* y, void* stream) {
  return launch<float>(diags, offsets, K, n, x, y, stream);
}

extern "C" int dia_spmv_bf16(const void* diags, const void* offsets, int K,
                             int n, const void* x, void* y, void* stream) {
  return launch<__nv_bfloat16>(diags, offsets, K, n, x, y, stream);
}
