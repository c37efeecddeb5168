// K3: multi-RHS CSR SpMM Y = A X for Hopper (sm_90a).
//
// Replaces the TPU kernel gnnla_tpu/ops/pallas_stream.py::_make_call_mrhs
// (:635, pallas_call at :813), the stream SpMM that runs the Gelfand
// damping-factor loss of the learned Jacobi smoother (T Y over m probe
// columns). Its VJP runs this same kernel on a CSR of A^T built once at
// setup, as the JAX package runs it on the transposed pack, so neither
// direction needs atomics. The TPU design (1024-row tiles, sublane windows
// DMA'd into VMEM, one-hot MXU routing, segmented lane scans) serves the
// TPU's 8x128 registers and is not kept: a CSR row is what a lane group
// walks.
//
// Bound on the card: bytes. One apply reads nnz column indices and values
// (8 bytes per nonzero), rows+1 row pointers and X [n_cols, M] once, and
// writes Y [n_rows, M] once, against 2 * nnz * M flops (M = 20 on a
// 5-point operator: about 1 flop per byte, far below the card's 20 flops
// per byte in f32).
//
// What the design does about it:
//   * A group of G = ceil(M / 4) lanes serves a row (at most 32), and a
//     warp holds floor(32 / G) rows: at M = 20, 5 lanes per row and 6 rows
//     per warp, so 30 of 32 lanes work. Each lane moves one float4 of
//     X[col, :] per nonzero and one of Y[row, :] (columns 4g .. 4g+3; past
//     M = 128 a lane takes every G-th quad).
//   * Loads in flight: a group loads 8 of its row's (col, val) pairs into
//     registers (the lanes of a group read the same addresses, which the
//     warp's load serves once), then issues the 8 gathers of X, then does
//     the arithmetic. A 5-point row is one such batch: one dependent round
//     trip for the pairs and one for X, not one per nonzero.
//   * X is gathered through the read-only path (__ldg); in RCM order a
//     row's columns lie in a narrow band, so the rows of X a block reads
//     are mostly in L2.
//   * M not a multiple of 4, or an X or Y pointer not 16-byte aligned,
//     takes the scalar variant: the same lane groups, each lane moving its
//     (up to) 4 columns one float at a time.
//   * Each output sums in CSR order with separate multiply and add
//     (__fmul_rn, __fadd_rn), so the result is deterministic and equals a
//     sequential sum in CSR order, product by product, in either variant.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // warps per block
constexpr int kNz = 8;     // nonzeros whose gathers issue together

template <bool kVec>
__device__ __forceinline__ float4 load4(const float* __restrict__ p,
                                        int left) {
  if constexpr (kVec) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  float4 r = make_float4(__ldg(p), 0.0f, 0.0f, 0.0f);
  if (left > 1) r.y = __ldg(p + 1);
  if (left > 2) r.z = __ldg(p + 2);
  if (left > 3) r.w = __ldg(p + 3);
  return r;
}

template <bool kVec>
__device__ __forceinline__ void store4(float* __restrict__ p, float4 a,
                                       int left) {
  if constexpr (kVec) {
    *reinterpret_cast<float4*>(p) = a;
    return;
  }
  p[0] = a.x;
  if (left > 1) p[1] = a.y;
  if (left > 2) p[2] = a.z;
  if (left > 3) p[3] = a.w;
}

__device__ __forceinline__ float mac(float acc, float v, float xv) {
  return __fadd_rn(acc, __fmul_rn(v, xv));
}

// kVec: M % 4 == 0 and X, Y 16-byte aligned (float4 moves); otherwise
// scalar moves of the same columns.
template <bool kVec>
__global__ void __launch_bounds__(kWarps * 32)
csr_spmm_kernel(const int* __restrict__ row_ptr, const int* __restrict__ cols,
                const float* __restrict__ vals, int n_rows, int n_rhs,
                int group, const float* __restrict__ x,
                float* __restrict__ y) {
  const int lane = threadIdx.x & 31;
  const int rows_per_warp = 32 / group;
  const int slot = lane / group;
  const int g = lane - slot * group;
  if (slot >= rows_per_warp) return;  // the lanes no group fills
  const int64_t row =
      ((int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5)) * rows_per_warp +
      slot;
  if (row >= n_rows) return;
  const int start = __ldg(row_ptr + row);
  const int end = __ldg(row_ptr + row + 1);
  const int n_quads = (n_rhs + 3) / 4;
  for (int q = g; q < n_quads; q += group) {
    const int m0 = 4 * q;
    const int left = n_rhs - m0;
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int base = start; base < end; base += kNz) {
      int c[kNz];
      float v[kNz];
      float4 xv[kNz];
#pragma unroll
      for (int u = 0; u < kNz; ++u) {
        const bool live = base + u < end;
        c[u] = live ? __ldg(cols + base + u) : 0;
        v[u] = live ? __ldg(vals + base + u) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kNz; ++u) {
        xv[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (base + u < end) {
          xv[u] = load4<kVec>(x + (int64_t)c[u] * n_rhs + m0, left);
        }
      }
#pragma unroll
      for (int u = 0; u < kNz; ++u) {
        if (base + u < end) {
          acc.x = mac(acc.x, v[u], xv[u].x);
          acc.y = mac(acc.y, v[u], xv[u].y);
          acc.z = mac(acc.z, v[u], xv[u].z);
          acc.w = mac(acc.w, v[u], xv[u].w);
        }
      }
    }
    store4<kVec>(y + row * n_rhs + m0, acc, left);
  }
}

}  // namespace

// row_ptr [n_rows+1] int32, cols [nnz] int32, vals [nnz] f32, x [n_cols,
// n_rhs] f32 row-major, y [n_rows, n_rhs] f32 row-major, all on the current
// device (any alignment); `stream` is a cudaStream_t. Returns
// cudaGetLastError().
extern "C" int csr_spmm_f32(const void* row_ptr, const void* cols,
                            const void* vals, int n_rows, int n_rhs,
                            const void* x, void* y, void* stream) {
  if (n_rows <= 0 || n_rhs <= 0) return 0;
  const int quads = (n_rhs + 3) / 4;
  const int group = quads < 32 ? quads : 32;
  const int64_t rows_per_block = (int64_t)kWarps * (32 / group);
  const int blocks = (int)((n_rows + rows_per_block - 1) / rows_per_block);
  const bool vec = n_rhs % 4 == 0 && (uintptr_t)x % 16 == 0 &&
                   (uintptr_t)y % 16 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (vec) {
    csr_spmm_kernel<true><<<blocks, kWarps * 32, 0, s>>>(
        (const int*)row_ptr, (const int*)cols, (const float*)vals, n_rows,
        n_rhs, group, (const float*)x, (float*)y);
  } else {
    csr_spmm_kernel<false><<<blocks, kWarps * 32, 0, s>>>(
        (const int*)row_ptr, (const int*)cols, (const float*)vals, n_rows,
        n_rhs, group, (const float*)x, (float*)y);
  }
  return (int)cudaGetLastError();
}
