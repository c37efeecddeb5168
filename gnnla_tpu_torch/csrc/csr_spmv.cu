// K2: general-pattern SpMV (CSR) for Hopper (sm_90a).
//
// Replaces the TPU kernel gnnla_tpu/ops/pallas_stream.py::_make_call
// (pallas_call at :629), the stream SpMV y = A x on a general sparsity
// pattern, together with its apply_t contract: A^T y runs this same kernel
// on a CSR of the transpose built once at setup (as the JAX package
// builds a transposed pack), so there are no atomics and the result is
// deterministic. The TPU pack layout (1024-row tiles, 8x128 lane groups,
// segmented lane scans) exists for the TPU's vector unit and is not kept:
// a CSR row is what a CUDA thread can walk directly.
//
// Bound on the card: bytes. It reads nnz values and column indices
// (8 bytes per nonzero), the rows+1 row pointers and x once, and writes y
// once: nnz*8 + (rows+1)*4 + cols*4 + rows*4 bytes, against 2*nnz flops.
//
// What the design does about it:
//   * One thread per row (grid-stride). The prolongation P of the AMG
//     V-cycle and its transpose carry 2-4 nonzeros per row, too few to
//     share a warp across a row; neighbouring threads walk neighbouring
//     rows, so row_ptr, cols and vals reads stay within a few cache lines
//     per warp, and y is written coalesced.
//   * x is gathered through the read-only path (__ldg); the columns of a
//     prolongation follow its rows (a sloped band), so the gathers of a
//     warp land in few lines and mostly hit L2.
//   * Accumulation is f32 in the row's column order.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
csr_spmv_kernel(const int* __restrict__ row_ptr, const int* __restrict__ cols,
                const float* __restrict__ vals, int n_rows,
                const float* __restrict__ x, float* __restrict__ y) {
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n_rows;
       i += stride) {
    const int start = row_ptr[i];
    const int end = row_ptr[i + 1];
    float acc = 0.0f;
    for (int p = start; p < end; ++p) acc += vals[p] * __ldg(x + cols[p]);
    y[i] = acc;
  }
}

}  // namespace

// row_ptr [n_rows+1] int32, cols [nnz] int32, vals [nnz] f32, x [n_cols]
// f32, y [n_rows] f32, all on the current device; `stream` is a
// cudaStream_t. Returns cudaGetLastError().
extern "C" int csr_spmv_f32(const void* row_ptr, const void* cols,
                            const void* vals, int n_rows, const void* x,
                            void* y, void* stream) {
  if (n_rows <= 0) return 0;
  const int blocks = (n_rows + kThreads - 1) / kThreads;
  csr_spmv_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)row_ptr, (const int*)cols, (const float*)vals, n_rows,
      (const float*)x, (float*)y);
  return (int)cudaGetLastError();
}
