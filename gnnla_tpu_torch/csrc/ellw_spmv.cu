// K6: windowed ELL SpMV for Hopper (sm_90a).
//
// Replaces the TPU kernel scratch/proto_ellw.py::make_call (pallas_call at
// :129): y = A x on a general graph in the windowed-gather ELL layout of
// proto_ellw.py::build_ellw (ops/ellw_spmv.py::build_ellw, the same arrays
// bit for bit). Rows are cut into 1024-row tiles; tile t's columns lie in
// the window [start[t], start[t] + W) of x, and its K slots hold, for
// slot k, the 1024 words idx[t, 8k:8k+8, :] and val[t, 8k:8k+8, :]: row
// r of the tile at word 128 * (r / 128) + r % 128 = r. idx is the column
// less start[t]; a padded slot has value 0 and the row's first column.
//
// Bound on the card: bytes. It reads idx and val (8 bytes a slot,
// n_tiles * 1024 * K slots, padding included: the layout's cost), start
// and x once, and writes y: against 2 flops a slot.
//
// The design. One CUDA block of 1024 threads takes one tile, one thread a
// row. The TPU gathered from its window in 128-lane chunk passes over
// `bounds` (:91-96); the card gathers any word of shared memory directly,
// so the passes (and `bounds`) are not carried over, but the arrays keep
// their layout and the kernel reads the same bytes. With kShared the block
// first stages x[start : start + W] in shared memory with coalesced
// 16-byte loads, then every row gathers from it; without it (W * 4 bytes
// over the budget ops/ellw_spmv.py states) the rows gather x through the
// read-only cache. For slot k a thread reads idx and val at k * 1024 + r:
// a warp reads 128 consecutive bytes of each. Each row sums val * x[idx]
// over the slots in order from 0 with __fmul_rn and __fadd_rn, the order
// of proto_ellw.py:87-99, so the kernel equals the plain version bit for
// bit. x is read unpadded: a column at or past n_x reads 0, which is what
// the TPU's zero-padded x_pad holds there.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 1024;  // rows a tile, threads a block

template <bool kShared>
__global__ void __launch_bounds__(kTile)
ellw_spmv(const int* __restrict__ idx, const float* __restrict__ val,
          const int* __restrict__ start, int K, int W,
          const float* __restrict__ x, int n_x, float* __restrict__ y) {
  extern __shared__ float win[];
  const int t = blockIdx.x;
  const int s = __ldg(start + t);
  if constexpr (kShared) {
    const bool vec = (((uintptr_t)(x + s)) & 15) == 0;
    for (int i = 4 * threadIdx.x; i < W; i += 4 * kTile) {
      if (vec && s + i + 4 <= n_x) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(x + s + i));
        win[i] = v.x;
        win[i + 1] = v.y;
        win[i + 2] = v.z;
        win[i + 3] = v.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          win[i + e] = s + i + e < n_x ? __ldg(x + s + i + e) : 0.0f;
      }
    }
    __syncthreads();
  }
  const size_t base = (size_t)t * K * kTile + threadIdx.x;
  float acc = 0.0f;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const int j = __ldg(idx + base + (size_t)k * kTile);
    const float v = __ldg(val + base + (size_t)k * kTile);
    float xv;
    if constexpr (kShared) {
      xv = win[j];
    } else {
      xv = s + j < n_x ? __ldg(x + s + j) : 0.0f;
    }
    acc = __fadd_rn(acc, __fmul_rn(v, xv));
  }
  y[(size_t)t * kTile + threadIdx.x] = acc;
}

}  // namespace

// idx int32 and val f32 [n_tiles, 8K, 128], start int32 [n_tiles]
// (multiples of 128), x f32 [n_x], y f32 [n_tiles * 1024], all on the
// current device; every idx in [0, W). shared = 1 stages the window in
// shared memory (W * 4 bytes of it), 0 reads x through the read-only
// cache. `stream` is a cudaStream_t. Returns cudaGetLastError().
extern "C" int ellw_spmv_f32(const void* idx, const void* val,
                             const void* start, int n_tiles, int K, int W,
                             int shared, const void* x, int n_x, void* y,
                             void* stream) {
  if (n_tiles <= 0) return 0;
  if (K <= 0 || W <= 0 || W % 128 || n_x < 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (shared) {
    const size_t bytes = (size_t)W * sizeof(float);
    if (bytes > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          ellw_spmv<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)bytes);
      if (e != cudaSuccess) return (int)e;
    }
    ellw_spmv<true><<<n_tiles, kTile, bytes, st>>>(
        (const int*)idx, (const float*)val, (const int*)start, K, W,
        (const float*)x, n_x, (float*)y);
  } else {
    ellw_spmv<false><<<n_tiles, kTile, 0, st>>>(
        (const int*)idx, (const float*)val, (const int*)start, K, W,
        (const float*)x, n_x, (float*)y);
  }
  return (int)cudaGetLastError();
}
