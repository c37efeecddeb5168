// K2: general-pattern SpMV (CSR) for Hopper (sm_90a).
//
// Replaces the TPU kernel gnnla_tpu/ops/pallas_stream.py::_make_call
// (pallas_call at :629), the stream SpMV y = A x on a general sparsity
// pattern, together with its apply_t contract: A^T y runs this same kernel
// on a CSR of the transpose built once at setup (as the JAX package
// builds a transposed pack), so there are no atomics and the result is
// deterministic. The TPU pack layout (1024-row tiles, 8x128 lane groups,
// segmented lane scans) exists for the TPU's vector unit and is not kept.
//
// Bound on the card: bytes. It reads nnz values and column indices
// (8 bytes per nonzero), the rows+1 row pointers, the row blocks and x
// once, and writes y once: nnz*8 + (rows+1)*4 + (blocks+1)*4 + cols*4 +
// rows*4 bytes, against 2*nnz flops.
//
// What the design does about it. A thread that walks its own row waits,
// per nonzero, on three dependent loads (row pointer, column, x), and a
// warp's column and value reads are strided by the row lengths. Here the
// rows are cut once per CSR into row blocks (ops/stream_spmv.py::
// csr_row_blocks): runs of consecutive rows whose nonzeros fit a budget
// of kBudget, at most kThreads rows, and alone any row longer than
// kLongRow. One CUDA block takes one row block:
//   1. Its nonzeros [p0, p1) are one contiguous range of cols and vals:
//      the threads read it with coalesced 16-byte loads (4 nonzeros a
//      thread), gather x at the 4 columns, all loads in flight at once,
//      and store the products v * x (__fmul_rn) in shared memory.
//   2. Each row's thread sums its products in CSR order with __fadd_rn,
//      from 0, and the block writes its rows' y coalesced.
// So per nonzero the loads are independent: the only chain is row block
// -> row pointers -> the block's range. A row block longer than the
// budget (a caller's own blocks) is staged in chunks of kBudget; each row
// carries its sum from chunk to chunk, so the order stays CSR order.
// The sums are therefore bitwise the CSR-order mul-then-add (chip_smoke.py
// ::csr_sequential), the arithmetic K3 keeps. Before this design K2 summed
// with fused multiply-adds: its last bits changed, deterministically.
// A long row (a block of one row of more than kLongRow nonzeros) is
// summed by the whole block: thread t adds nonzeros t, t + 256, ... in
// order, then the block adds its threads' sums in a fixed tree. Such rows
// agree with the plain version to f32 rounding, not bitwise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // rows per short-row block, at most
constexpr int kBudget = 2048;  // nonzeros staged at once (8 KB)
constexpr int kLongRow = 64;   // longer rows are summed by a whole block

__device__ __forceinline__ float block_sum(float v) {
  __shared__ float s_warp[kThreads / 32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) s_warp[warp] = v;
  __syncthreads();
  v = 0.0f;
  if (warp == 0) {
    v = lane < kThreads / 32 ? s_warp[lane] : 0.0f;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
csr_spmv_blocks(const int* __restrict__ row_ptr, const int* __restrict__ cols,
                const float* __restrict__ vals,
                const int* __restrict__ row_blocks, int nnz,
                const float* __restrict__ x, float* __restrict__ y) {
  __shared__ float prod[kBudget];
  const int r0 = __ldg(row_blocks + blockIdx.x);
  const int r1 = __ldg(row_blocks + blockIdx.x + 1);
  const int p0 = __ldg(row_ptr + r0), p1 = __ldg(row_ptr + r1);

  if (r1 - r0 == 1 && p1 - p0 > kLongRow) {  // a long row
    float acc = 0.0f;
    for (int p = p0 + threadIdx.x; p < p1; p += kThreads) {
      const float v = __ldg(vals + p);
      acc = __fadd_rn(acc, __fmul_rn(v, __ldg(x + __ldg(cols + p))));
    }
    acc = block_sum(acc);
    if (threadIdx.x == 0) y[r0] = acc;
    return;
  }

  // 16-byte loads where both arrays allow them (the port's own tensors do)
  const bool vec = (((uintptr_t)cols | (uintptr_t)vals) & 15) == 0;
  const int r = r0 + threadIdx.x;  // this thread's row, if r < r1
  const int rs = r < r1 ? __ldg(row_ptr + r) : 0;
  const int re = r < r1 ? __ldg(row_ptr + r + 1) : 0;
  float acc = 0.0f;
  for (int q = p0; q < p1; q += kBudget) {  // one chunk for the port's blocks
    const int qe = min(q + kBudget, p1);
    // products of [q, qe) into prod[p - q], 4 aligned nonzeros a thread
    for (int g = (q >> 2) + threadIdx.x; 4 * g < qe; g += kThreads) {
      const int b = 4 * g;
      int c4[4];
      float v4[4];
      if (vec && b + 4 <= nnz) {
        const int4 c = __ldg(reinterpret_cast<const int4*>(cols) + g);
        const float4 v = __ldg(reinterpret_cast<const float4*>(vals) + g);
        c4[0] = c.x;
        c4[1] = c.y;
        c4[2] = c.z;
        c4[3] = c.w;
        v4[0] = v.x;
        v4[1] = v.y;
        v4[2] = v.z;
        v4[3] = v.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool in = b + e >= q && b + e < qe;
          c4[e] = in ? __ldg(cols + b + e) : 0;
          v4[e] = in ? __ldg(vals + b + e) : 0.0f;
        }
      }
      float x4[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool in = b + e >= q && b + e < qe;
        x4[e] = in ? __ldg(x + c4[e]) : 0.0f;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (b + e >= q && b + e < qe)
          prod[b + e - q] = __fmul_rn(v4[e], x4[e]);
      }
    }
    __syncthreads();
    for (int p = max(rs, q); p < min(re, qe); ++p)
      acc = __fadd_rn(acc, prod[p - q]);
    __syncthreads();
  }
  if (r < r1) y[r] = acc;
}

}  // namespace

// row_ptr [n_rows+1] int32, cols [nnz] int32, vals [nnz] f32, row_blocks
// [n_blocks+1] int32 (increasing from 0 to n_rows, at most 256 rows a
// block: ops/stream_spmv.py::csr_row_blocks), x [n_cols] f32, y [n_rows]
// f32, all on the current device; `stream` is a cudaStream_t. Returns
// cudaGetLastError().
extern "C" int csr_spmv_f32(const void* row_ptr, const void* cols,
                            const void* vals, int n_rows,
                            const void* row_blocks, int n_blocks, int nnz,
                            const void* x, void* y, void* stream) {
  if (n_rows <= 0) return 0;
  if (n_blocks <= 0 || nnz < 0 || !row_blocks)
    return (int)cudaErrorInvalidValue;
  csr_spmv_blocks<<<n_blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)row_ptr, (const int*)cols, (const float*)vals,
      (const int*)row_blocks, nnz, (const float*)x, (float*)y);
  return (int)cudaGetLastError();
}
