// K9: the stage ablation of K2 (csr_spmv.cu) for Hopper (sm_90a).
//
// Replaces the TPU kernel scratch/ablate_stream.py::make_call(variant)
// (pallas_call at :149): the stream SpMV compiled once per variant with
// stages removed, timed to split its time by stage. Here the kernel is
// K2's own body (csr_spmv_body.cuh) instantiated once per variant with
// compile-time stage flags, on the same CSR and row blocks:
//   full      — every stage: K2, bitwise;
//   nomatmul  — the TPU's one-hot MXU accumulation has no counterpart in
//               K2, so this variant is K2 unchanged;
//   nogather  — no x loads: a term is v + x[0] (as :81-82);
//   noscan    — no row sums: a row keeps its first product;
//   nodeposit — no round trip of the products through shared memory: each
//               row's thread reads its own nonzeros (the walk);
//   minimal   — none of the three: each thread sums the terms v + x[0] it
//               staged and writes the sum to the row of its own index.
// Each variant's plain version (ops/stream_ablate.py) defines what it
// computes; every variant equals its plain version bitwise.
//
// Bound on the card: bytes, as K2's (the full variant moves K2's bytes;
// the others move as many or fewer). What the design does about it: it is
// K2's design; the ablation measures which part of it costs the time.

#include "csr_spmv_body.cuh"

namespace {

template <bool kGather, bool kDeposit, bool kScan>
int launch(const void* row_ptr, const void* cols, const void* vals,
           const void* row_blocks, int n_blocks, int nnz, const void* x,
           void* y, cudaStream_t stream) {
  csr_spmv_blocks<kGather, kDeposit, kScan><<<n_blocks, kThreads, 0, stream>>>(
      (const int*)row_ptr, (const int*)cols, (const float*)vals,
      (const int*)row_blocks, nnz, (const float*)x, (float*)y);
  return (int)cudaGetLastError();
}

}  // namespace

// variant: 0 full, 1 nomatmul, 2 nogather, 3 noscan, 4 nodeposit,
// 5 minimal (ops/stream_ablate.py::VARIANTS). The arrays are K2's
// (csr_spmv.cu::csr_spmv_f32). Returns cudaGetLastError().
extern "C" int csr_ablate_f32(int variant, const void* row_ptr,
                              const void* cols, const void* vals, int n_rows,
                              const void* row_blocks, int n_blocks, int nnz,
                              const void* x, void* y, void* stream) {
  if (n_rows <= 0) return 0;
  if (n_blocks <= 0 || nnz < 0 || !row_blocks)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
#define K9_LAUNCH(G, D, S)                                               \
  launch<G, D, S>(row_ptr, cols, vals, row_blocks, n_blocks, nnz, x, y, s)
  switch (variant) {
    case 0:
    case 1:
      return K9_LAUNCH(true, true, true);
    case 2:
      return K9_LAUNCH(false, true, true);
    case 3:
      return K9_LAUNCH(true, true, false);
    case 4:
      return K9_LAUNCH(true, false, true);
    case 5:
      return K9_LAUNCH(false, false, false);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef K9_LAUNCH
}
