// K1: DIA SpMV for Hopper (sm_90a), on a tile-compressed layout.
//
// Replaces the TPU kernel gnnla_tpu/ops/pallas_spmv.py::_build_padded_call
// (pallas_call at :109): y[i] = sum_k diags[k, i] * x[i + off_k], with the
// diagonals stored in f32 or, as its `diag_dtype=bfloat16`, in bf16.
//
// Layout (built once per operator by ops/dia_spmv.py::dia_tiles, never in
// a cycle). The rows are cut into tiles of 32, a warp's rows. Each tile
// keeps only the diagonals that hold a nonzero value in its rows, as
// segments:
//   seg_ptr  [n_tiles + 1] int32    tile t owns segments seg_ptr[t] ..
//                                   seg_ptr[t+1] - 1
//   seg_off  [n_segs] int32         each segment's offset, increasing
//                                   within a tile (the k order)
//   seg_vals [n_segs, 32] f32|bf16  the diagonal's values in the tile's
//                                   32 rows (zero past row n)
//
// Bound on the card: bytes. A Galerkin coarse operator's band is mostly
// structural zeros: the fast setup's Ac (K = 415 diagonals, 637,355 rows)
// stores 264.5 M dense values for 5.25 M nonzeros, and a walk over all K
// offsets streams 1,058 MB per apply. The compact layout keeps the tiles'
// nonzero segments only (about 19 per tile there: 48 MB in f32), so one
// apply moves n_segs * 32 * d + 4 * (n_segs + n_tiles + 1) + 8n bytes for
// d-byte values, at 2 flops per stored value: far below the card's ridge
// point, so the kernel can at best stream the segments at the memory rate.
//
// What the design does about it:
//   * Warp-per-tile form: one warp per tile, lane = row. For each segment
//     the warp reads 32 contiguous values (one 128 B line in f32) and
//     x[i0 + off .. i0 + off + 31], contiguous too, so every load
//     coalesces and each stored value is read once. x's re-reads at
//     shifted positions hit L1/L2.
//   * Loads in flight: a lane loads 32 segment offsets at once and the
//     warp shuffles them round; the values and x of 8 segments are loaded
//     before their 8 FMAs, so each lane keeps up to 16 loads in flight
//     instead of one dependent pair per segment.
//   * Split form, for operators too small to fill the card (fewer tiles
//     than a few warps per SM, as on the SA hierarchy's coarse levels):
//     a block of 8 warps takes one tile and splits its segments into 8
//     contiguous runs; the partial sums combine in shared memory in warp
//     order, so the result is deterministic. The host picks the form
//     from n once, when the layout is built.
//   * Accumulation is f32 in segment order, which is the k order of the
//     plain PyTorch version (ops/dia.py::dia_matvec); the bounds guard
//     0 <= i + off < n replaces the TPU's zeroed halo. A skipped segment
//     holds exact zeros, which add nothing to an FMA for finite x, so the
//     warp-per-tile form gives the dense walk's bits; the split form
//     differs from it only by the f32 reassociation of 8 partial sums.
//     A bf16 value is widened to f32 exactly before its FMA (JAX's bf16 *
//     f32 promotion), so on bf16-exact values (the integer Laplacian)
//     both storages give the same bits. Kernel and plain version agree to
//     f32 rounding, not bitwise: the kernel fuses each product and add.
//
// The gradient needs no other kernel: x's cotangent is this kernel on the
// compact layout of the transposed diagonals (ops/dia.py::dia_transpose),
// the diagonals' cotangent plain elementwise products, as in the JAX
// package.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;       // rows per tile: one per lane
constexpr int kWarps = 8;       // tiles per block, warp-per-tile form
constexpr int kSplitWarps = 8;  // warps sharing one tile, split form
constexpr int kBatch = 8;       // segments whose loads issue together
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Row i's sum over the segments [s0, s1) of its tile, in segment order.
// The whole warp calls it with the same s0 and s1 (for the shuffles).
template <typename D>
__device__ __forceinline__ float walk(const int* __restrict__ seg_off,
                                      const D* __restrict__ seg_vals,
                                      int s0, int s1, int i, int n,
                                      const float* __restrict__ x,
                                      int lane) {
  float acc = 0.0f;
  for (int base = s0; base < s1; base += kTile) {
    const int cnt = min(kTile, s1 - base);
    const int my_off = lane < cnt ? __ldg(seg_off + base + lane) : 0;
    for (int j = 0; j < cnt; j += kBatch) {
      float v[kBatch], xv[kBatch];
      bool on[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int off = __shfl_sync(kFull, my_off, (j + u) & (kTile - 1));
        const int64_t c = (int64_t)i + off;
        on[u] = j + u < cnt && c >= 0 && c < n;
        v[u] = 0.0f;
        xv[u] = 0.0f;
        if (on[u]) {
          v[u] = widen(seg_vals[(int64_t)(base + j + u) * kTile + lane]);
          xv[u] = __ldg(x + c);
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (on[u]) acc = fmaf(v[u], xv[u], acc);
      }
    }
  }
  return acc;
}

template <typename D>
__global__ void __launch_bounds__(kWarps * kTile)
dia_tiles_kernel(const int* __restrict__ seg_ptr,
                 const int* __restrict__ seg_off,
                 const D* __restrict__ seg_vals, int n, int n_tiles,
                 const float* __restrict__ x, float* __restrict__ y) {
  const int lane = threadIdx.x & (kTile - 1);
  const int tile = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (tile >= n_tiles) return;  // whole warps leave together
  const int i = tile * kTile + lane;
  const float acc = walk<D>(seg_off, seg_vals, __ldg(seg_ptr + tile),
                            __ldg(seg_ptr + tile + 1), i, n, x, lane);
  if (i < n) y[i] = acc;
}

template <typename D>
__global__ void __launch_bounds__(kSplitWarps * kTile)
dia_tiles_split_kernel(const int* __restrict__ seg_ptr,
                       const int* __restrict__ seg_off,
                       const D* __restrict__ seg_vals, int n,
                       const float* __restrict__ x, float* __restrict__ y) {
  __shared__ float part[kSplitWarps][kTile];
  const int lane = threadIdx.x & (kTile - 1);
  const int warp = threadIdx.x >> 5;
  const int tile = blockIdx.x;
  const int i = tile * kTile + lane;
  const int start = __ldg(seg_ptr + tile);
  const int end = __ldg(seg_ptr + tile + 1);
  const int run = (end - start + kSplitWarps - 1) / kSplitWarps;
  const int s0 = min(end, start + warp * run);
  const int s1 = min(end, s0 + run);
  part[warp][lane] = walk<D>(seg_off, seg_vals, s0, s1, i, n, x, lane);
  __syncthreads();
  if (warp == 0) {
    float acc = part[0][lane];
#pragma unroll
    for (int w = 1; w < kSplitWarps; ++w) acc += part[w][lane];
    if (i < n) y[i] = acc;
  }
}

template <typename D>
int launch(const void* seg_ptr, const void* seg_off, const void* seg_vals,
           int n, int split, const void* x, void* y, void* stream) {
  if (n <= 0) return 0;
  const int n_tiles = (n - 1) / kTile + 1;
  cudaStream_t s = (cudaStream_t)stream;
  if (split) {
    dia_tiles_split_kernel<D><<<n_tiles, kSplitWarps * kTile, 0, s>>>(
        (const int*)seg_ptr, (const int*)seg_off, (const D*)seg_vals, n,
        (const float*)x, (float*)y);
  } else {
    dia_tiles_kernel<D><<<(n_tiles - 1) / kWarps + 1, kWarps * kTile, 0,
                          s>>>(
        (const int*)seg_ptr, (const int*)seg_off, (const D*)seg_vals, n,
        n_tiles, (const float*)x, (float*)y);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// seg_ptr [n_tiles+1] int32, seg_off [n_segs] int32, seg_vals [n_segs, 32]
// (f32 or bf16), x [n] f32, y [n] f32, all on the current device, with
// n_tiles = ceil(n / 32); `split` != 0 takes the split form; `stream` is a
// cudaStream_t. Each returns cudaGetLastError().
extern "C" int dia_spmv_f32(const void* seg_ptr, const void* seg_off,
                            const void* seg_vals, int n, int split,
                            const void* x, void* y, void* stream) {
  return launch<float>(seg_ptr, seg_off, seg_vals, n, split, x, y, stream);
}

extern "C" int dia_spmv_bf16(const void* seg_ptr, const void* seg_off,
                             const void* seg_vals, int n, int split,
                             const void* x, void* y, void* stream) {
  return launch<__nv_bfloat16>(seg_ptr, seg_off, seg_vals, n, split, x, y,
                               stream);
}
