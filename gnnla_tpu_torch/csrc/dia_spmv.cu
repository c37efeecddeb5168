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
//     0 <= i + off < n replaces the TPU's zeroed halo. For finite x a
//     skipped segment's exact zeros add nothing to an FMA, so the
//     warp-per-tile form gives the dense walk's bits; the split form
//     differs from it only by the f32 reassociation of 8 partial sums.
//     A bf16 value is widened to f32 exactly before its FMA (JAX's bf16 *
//     f32 promotion), so on bf16-exact values (the integer Laplacian)
//     both storages give the same bits. Kernel and plain version agree to
//     f32 rounding, not bitwise: the kernel fuses each product and add.
//   * Non-finite x. The reference multiplies every stored diagonal, so a
//     zero there times an inf or NaN of x makes its row NaN; a skipped
//     segment would hide that product. The rule this kernel keeps: row r
//     is NaN whenever a diagonal k has 0 <= r + off_k < n, x[r + off_k]
//     not finite and diags[k, r] == 0 (a skipped segment counts as zero).
//     Rows that reach a non-finite x through a stored value already get
//     the reference's inf or NaN: such sums do not depend on their order.
//     Each lane checks its own x[i] (K1 is square, so the lanes cover all
//     of x; the load hits L1 where the tile keeps offset 0), and a warp
//     vote raises a flag in `state` only when one is not finite. Each
//     block then takes a ticket; the last block to finish reads the flag
//     and, in the rare case it is set, walks x's non-finite entries and
//     writes NaN into every row that the rule names, finding whether
//     (tile(r), k) was skipped by a binary search of the tile's offsets.
//     It then resets `state` for the next launch. On finite x this costs
//     one load, one vote and one ticket per block: no host sync and no
//     extra launch. The rare path costs O(non-finite entries x K) in one
//     block. `state` (flag, ticket) belongs to the layout, so one layout
//     must not run on two streams at once. A layout that skips no segment
//     a row reaches in range (the Laplacian's: it skips only diagonals
//     past its first and last grid rows) can need no repair; its caller
//     passes no `state`, and the kernel takes no ticket.
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

// The layout the kernels read, with what the non-finite repair needs: the
// operator's K dense offsets and the layout's int32 state (flag, ticket).
template <typename D>
struct Layout {
  const int* seg_ptr;
  const int* seg_off;
  const D* seg_vals;
  const int* offsets;
  int* state;
  int n, K;
};

// The last block's repair: NaN into every row r = j - off_k that reaches a
// non-finite x[j] through a segment the tile skipped.
template <typename D>
__device__ void repair_nonfinite(const Layout<D>& L,
                                 const float* __restrict__ x,
                                 float* __restrict__ y) {
  const float nan = __int_as_float(0x7fffffff);
  for (int j = threadIdx.x; j < L.n; j += blockDim.x) {
    if (isfinite(__ldg(x + j))) continue;
    for (int k = 0; k < L.K; ++k) {
      const int off = __ldg(L.offsets + k);
      const int64_t r = (int64_t)j - off;
      if (r < 0 || r >= L.n) continue;
      const int t = (int)(r / kTile);
      const int end = __ldg(L.seg_ptr + t + 1);
      int lo = __ldg(L.seg_ptr + t), hi = end;
      while (lo < hi) {  // the first segment of the tile at >= off
        const int mid = (lo + hi) >> 1;
        if (__ldg(L.seg_off + mid) < off) lo = mid + 1; else hi = mid;
      }
      if (lo == end || __ldg(L.seg_off + lo) != off) y[r] = nan;
    }
  }
}

// Every thread of the block calls it once, after the block's y writes,
// when the layout has a `state`. `bad`: this thread's row i < n has a
// non-finite x[i]. Each thread fences its own writes before the block's
// ticket (a single fence by thread 0 after the barrier measured slower
// on the H100: it waits for the block's writes one after the other).
template <typename D>
__device__ __forceinline__ void finish(bool bad, const Layout<D>& L,
                                       const float* __restrict__ x,
                                       float* __restrict__ y) {
  __shared__ int s_last;
  if (__any_sync(kFull, bad) && (threadIdx.x & (kTile - 1)) == 0)
    atomicOr(L.state, 1);
  __threadfence();  // this thread's y and flag, before the ticket
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(L.state + 1, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;  // the whole block
  __threadfence();      // every other block's y and flag are visible
  if (*(volatile int*)L.state) repair_nonfinite<D>(L, x, y);
  __syncthreads();
  if (threadIdx.x == 0) {
    L.state[0] = 0;
    L.state[1] = 0;
  }
}

// REPAIR: the layout has a `state` (the host picks the instantiation, so
// a layout that needs no repair runs no epilogue at all).
template <typename D, bool REPAIR>
__global__ void __launch_bounds__(kWarps * kTile)
dia_tiles_kernel(Layout<D> L, int n_tiles, const float* __restrict__ x,
                 float* __restrict__ y) {
  const int lane = threadIdx.x & (kTile - 1);
  const int tile = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int i = tile * kTile + lane;
  if (tile < n_tiles) {  // whole warps
    const float acc = walk<D>(L.seg_off, L.seg_vals, __ldg(L.seg_ptr + tile),
                              __ldg(L.seg_ptr + tile + 1), i, L.n, x, lane);
    if (i < L.n) y[i] = acc;
  }
  if (REPAIR) finish<D>(i < L.n && !isfinite(__ldg(x + i)), L, x, y);
}

template <typename D, bool REPAIR>
__global__ void __launch_bounds__(kSplitWarps * kTile)
dia_tiles_split_kernel(Layout<D> L, const float* __restrict__ x,
                       float* __restrict__ y) {
  __shared__ float part[kSplitWarps][kTile];
  const int lane = threadIdx.x & (kTile - 1);
  const int warp = threadIdx.x >> 5;
  const int tile = blockIdx.x;
  const int i = tile * kTile + lane;
  const int start = __ldg(L.seg_ptr + tile);
  const int end = __ldg(L.seg_ptr + tile + 1);
  const int run = (end - start + kSplitWarps - 1) / kSplitWarps;
  const int s0 = min(end, start + warp * run);
  const int s1 = min(end, s0 + run);
  part[warp][lane] = walk<D>(L.seg_off, L.seg_vals, s0, s1, i, L.n, x, lane);
  __syncthreads();
  if (warp == 0) {
    float acc = part[0][lane];
#pragma unroll
    for (int w = 1; w < kSplitWarps; ++w) acc += part[w][lane];
    if (i < L.n) y[i] = acc;
  }
  if (REPAIR)
    finish<D>(warp == 0 && i < L.n && !isfinite(__ldg(x + i)), L, x, y);
}

template <typename D>
int launch(const void* seg_ptr, const void* seg_off, const void* seg_vals,
           int n, int split, const void* offsets, int K, void* state,
           const void* x, void* y, void* stream) {
  if (n <= 0) return 0;
  if (state && (K < 1 || !offsets)) return (int)cudaErrorInvalidValue;
  const int n_tiles = (n - 1) / kTile + 1;
  cudaStream_t s = (cudaStream_t)stream;
  const Layout<D> L{(const int*)seg_ptr, (const int*)seg_off,
                    (const D*)seg_vals, (const int*)offsets, (int*)state, n,
                    K};
  const int blocks = split ? n_tiles : (n_tiles - 1) / kWarps + 1;
  const int threads = (split ? kSplitWarps : kWarps) * kTile;
  const float* xf = (const float*)x;
  float* yf = (float*)y;
  if (split && state)
    dia_tiles_split_kernel<D, true><<<blocks, threads, 0, s>>>(L, xf, yf);
  else if (split)
    dia_tiles_split_kernel<D, false><<<blocks, threads, 0, s>>>(L, xf, yf);
  else if (state)
    dia_tiles_kernel<D, true><<<blocks, threads, 0, s>>>(L, n_tiles, xf, yf);
  else
    dia_tiles_kernel<D, false><<<blocks, threads, 0, s>>>(L, n_tiles, xf, yf);
  return (int)cudaGetLastError();
}

}  // namespace

// seg_ptr [n_tiles+1] int32, seg_off [n_segs] int32, seg_vals [n_segs, 32]
// (f32 or bf16), offsets [K] int32 (the operator's sorted dense offsets),
// state [2] int32 (zero before the first launch; each launch leaves it
// zero) or null for a layout that skips no segment in range (no repair),
// x [n] f32, y [n] f32, all on the current device, with n_tiles =
// ceil(n / 32); `split` != 0 takes the split form; `stream` is a
// cudaStream_t. Each returns cudaGetLastError().
extern "C" int dia_spmv_f32(const void* seg_ptr, const void* seg_off,
                            const void* seg_vals, int n, int split,
                            const void* offsets, int K, void* state,
                            const void* x, void* y, void* stream) {
  return launch<float>(seg_ptr, seg_off, seg_vals, n, split, offsets, K,
                       state, x, y, stream);
}

extern "C" int dia_spmv_bf16(const void* seg_ptr, const void* seg_off,
                             const void* seg_vals, int n, int split,
                             const void* offsets, int K, void* state,
                             const void* x, void* y, void* stream) {
  return launch<__nv_bfloat16>(seg_ptr, seg_off, seg_vals, n, split, offsets,
                               K, state, x, y, stream);
}
