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
// of kBudget, at most kThreads rows; warp blocks, each a row of kLongRow
// + 1 to kWarpRow nonzeros and up to kWarps - 1 rows after it; and alone
// any row longer than kWarpRow. One CUDA block takes one row block. A
// block of short rows:
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
// A warp block (at most kWarps rows, the first longer than kLongRow) gives
// each row a warp: the lanes load kWarpChunk of its nonzeros at once,
// coalesced, gather x and stage the rounded products in shared memory,
// and the warp adds them to the row's sum in CSR order (warp_row_sum), so
// these rows too are bitwise the sequential sum. Only the additions are
// serial, ~4 cycles each, read four at a time from the stage. A whole
// block for each such row would hold an SM to 8 rows at a time, in waves
// of dependent loads: ten times the time of the bytes on a CSR whose rows
// mostly hold 65 to 120 nonzeros. Past kWarpRow nonzeros a warp's serial
// sum takes longer than the whole block's tree.
// A long row (a block of one row of more than kWarpRow nonzeros) is
// summed by the whole block: thread t adds nonzeros t, t + 256, ... in
// order, then the block adds its threads' sums in a fixed tree. Such rows
// agree with the plain version to f32 rounding, not bitwise.
// The block's form follows from its first row: more than kWarpRow
// nonzeros in a block of one row, the whole block; more than kLongRow in
// a block of at most kWarps rows, a warp block; else short rows (a caller's
// own blocks included, staged in chunks as above).

// The kernel body is in csr_spmv_body.cuh, shared with K9's stage
// ablation (csr_ablate.cu); K2 is its instantiation with every stage.
#include "csr_spmv_body.cuh"

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
  csr_spmv_blocks<true, true, true>
      <<<n_blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)row_ptr, (const int*)cols, (const float*)vals,
      (const int*)row_blocks, nnz, (const float*)x, (float*)y);
  return (int)cudaGetLastError();
}
