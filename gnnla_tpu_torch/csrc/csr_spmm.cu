// K3: multi-RHS CSR SpMM Y = A X for Hopper (sm_90a).
//
// Replaces the TPU kernel gnnla_tpu/ops/pallas_stream.py::_make_call_mrhs
// (:635, pallas_call at :813), the stream SpMM that runs the Gelfand
// damping-factor loss of the learned Jacobi smoother (T Y over m probe
// columns). Its VJP runs this same kernel on a CSR of A^T built once at
// setup, as the JAX package runs it on the transposed pack, so neither
// direction needs atomics. The TPU design (1024-row tiles, sublane windows
// DMA'd into VMEM, one-hot MXU routing, segmented lane scans) serves the
// TPU's 8x128 registers and is not kept: a CSR row is what a warp walks.
//
// Bound on the card: bytes. One apply reads nnz column indices and values
// (8 bytes per nonzero), rows+1 row pointers and X [n_cols, M] once, and
// writes Y [n_rows, M] once, against 2 * nnz * M flops (M = 20 on a
// 5-point operator: about 1 flop per byte, far below the card's 20 flops
// per byte in f32).
//
// What the design does about it:
//   * One warp per row, 8 rows per block. The lanes split the row's M
//     columns (in chunks of 32 when M > 32), so each X[col, :] gather is
//     one contiguous run of M floats across the lanes, and Y[row, :] is
//     stored the same way.
//   * The row's (col, val) pairs are read once per nonzero: lane j loads
//     pair j of each 32-pair chunk (one coalesced load), and __shfl_sync
//     hands each pair to every lane. The pack stream, the largest of the
//     TPU kernel's reads, is thus read once and shared across columns, as
//     the TPU kernel shares its decoded metadata across columns.
//   * X is gathered through the read-only path (__ldg); in RCM order a
//     row's columns lie in a narrow band, so the rows of X a block reads
//     are mostly in L2.
//   * Each output sums in CSR order with separate multiply and add
//     (__fmul_rn, __fadd_rn), so the result is deterministic and equals a
//     sequential sum in CSR order, product by product.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // rows per block

__global__ void __launch_bounds__(kWarps * 32)
csr_spmm_kernel(const int* __restrict__ row_ptr, const int* __restrict__ cols,
                const float* __restrict__ vals, int n_rows, int n_rhs,
                const float* __restrict__ x, float* __restrict__ y) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= n_rows) return;  // whole warps leave together
  const int start = row_ptr[row];
  const int end = row_ptr[row + 1];
  for (int c0 = 0; c0 < n_rhs; c0 += 32) {
    const int m = c0 + lane;
    const bool active = m < n_rhs;
    float acc = 0.0f;
    for (int base = start; base < end; base += 32) {
      int c = 0;
      float v = 0.0f;
      if (base + lane < end) {
        c = __ldg(cols + base + lane);
        v = __ldg(vals + base + lane);
      }
      const int cnt = min(32, end - base);
      for (int j = 0; j < cnt; ++j) {
        const int cj = __shfl_sync(0xffffffffu, c, j);
        const float vj = __shfl_sync(0xffffffffu, v, j);
        if (active) {
          acc = __fadd_rn(acc, __fmul_rn(
                                   vj, __ldg(x + (size_t)cj * n_rhs + m)));
        }
      }
    }
    if (active) y[(size_t)row * n_rhs + m] = acc;
  }
}

}  // namespace

// row_ptr [n_rows+1] int32, cols [nnz] int32, vals [nnz] f32, x [n_cols,
// n_rhs] f32 row-major, y [n_rows, n_rhs] f32 row-major, all on the current
// device; `stream` is a cudaStream_t. Returns cudaGetLastError().
extern "C" int csr_spmm_f32(const void* row_ptr, const void* cols,
                            const void* vals, int n_rows, int n_rhs,
                            const void* x, void* y, void* stream) {
  if (n_rows <= 0 || n_rhs <= 0) return 0;
  const int blocks = (n_rows + kWarps - 1) / kWarps;
  csr_spmm_kernel<<<blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const int*)row_ptr, (const int*)cols, (const float*)vals, n_rows,
      n_rhs, (const float*)x, (float*)y);
  return (int)cudaGetLastError();
}
