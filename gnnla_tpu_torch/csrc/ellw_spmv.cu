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
// Bound on the card: bytes. The layout stores K slots a row (8 bytes
// each), but K is the longest row of the whole matrix: most tiles' rows
// end long before it, and their last slots are padding. The kernel reads
// only the slots a block needs (below), start, its part of x and writes
// y: against 2 flops a slot.
//
// The design (ellw_spmv_trim). One CUDA block takes a tile, one thread a
// row. ops/ellw_spmv.py::slot_extents gives each tile, once, at
// construction:
//   T      the smallest k >= 1 such that every slot k..K-1 of the tile's
//          rows is padding: value bits exactly +0.0 and the column of the
//          row's slot 0. The block sums slots 0..T-1 in order from 0 with
//          __fmul_rn and __fadd_rn (proto_ellw.py:87-99) and, if T < K,
//          adds the one term 0 * x0, x0 being the x its slot 0 gathered.
//          That is the plain sum over all K slots bit for bit: each skipped
//          slot adds c = +0 * x0, which is +0, -0 or NaN; adding c again
//          after adding it once changes nothing (a + -0 = a; a + +0
//          changes only a -0, which the first addition already did; NaN
//          stays NaN). An explicit zero on another column is not padding.
//   lo, hi the window words its rows read, lo rounded down and hi up to a
//          multiple of 4, so the block stages only x[start + lo, start +
//          hi), not all W words.
// With kShared, thread 0 stages that part of x in shared memory with one
// TMA bulk copy (cp.async.bulk, completion on an mbarrier) while every
// thread already has its first kAhead slots' idx and val loads in flight:
// they do not depend on the window. The last few words past the end of x
// (which the TPU's zero-padded x_pad holds as 0) and a window of an x not
// 16-byte aligned are filled by the threads. Without kShared (a window
// over the shared-memory budget ops/ellw_spmv.py states) the rows gather x
// through the read-only cache. In the loop each thread keeps the next
// kAhead slots' idx and val in registers, loaded kAhead slots ahead, and
// adds in slot order. idx and val are read once: they are loaded with the
// evict-first hint, so x stays in L2 for the windows of the other blocks.
// Blocks of 1024 threads run two to an SM (a window of at most ~112 KB
// each, 32 registers a thread) with 4 slots in flight. A grid of no more
// blocks than SMs holds one block an SM whatever it uses, so there each
// thread keeps 16 slots in flight (up to 64 registers): such a launch is
// bound by the chain of loads a row waits on, not by the bytes. (Two
// blocks a tile, each with extents of its own, measured no faster on the
// 1M-row fixtures of PERF.md §6.)
//
// ellw_spmv_full is the earlier body, kept so that a timing can set the
// two side by side: every block walks all K slots and stages the whole
// window with plain loads before it reads a slot.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 1024;  // rows a tile

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               :: "r"(smem_u32(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  }
}

template <bool kShared, int kAhead, int kMinBlocks>
__global__ void __launch_bounds__(kTile, kMinBlocks)
ellw_spmv_trim(const int* __restrict__ idx, const float* __restrict__ val,
               const int* __restrict__ start, const int4* __restrict__ seg,
               int K, const float* __restrict__ x, int n_x,
               float* __restrict__ y) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* win = reinterpret_cast<float*>(smem + 16);
  const int t = blockIdx.x, row = threadIdx.x;
  const int s = __ldg(start + t);
  const int4 g = __ldg(seg + t);
  const int T = g.x, lo = g.y, hi = g.z;

  // window words [lo, bulk_end) come by one bulk copy, the rest from the
  // threads: past the end of x, or all of them if x is not 16-byte aligned
  const int avail = min(hi, n_x - s);
  const bool aligned = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const int bulk_end = aligned && avail > lo ? lo + ((avail - lo) & ~3) : lo;
  if constexpr (kShared) {
    if (threadIdx.x == 0) {
      mbar_init(bar);
      const uint32_t bytes = (uint32_t)(bulk_end - lo) * 4u;
      mbar_arrive(bar, bytes);
      if (bytes) bulk_copy(win, x + s + lo, bytes, bar);
    }
  }

  const size_t base = (size_t)t * K * kTile + row;
  const int* ip = idx + base;
  const float* vp = val + base;
  int j[kAhead];
  float v[kAhead];
#pragma unroll
  for (int d = 0; d < kAhead; ++d) {
    j[d] = 0;
    v[d] = 0.0f;
    if (d < T) {
      j[d] = __ldcs(ip + (size_t)d * kTile);
      v[d] = __ldcs(vp + (size_t)d * kTile);
    }
  }

  if constexpr (kShared) {
    for (int i = bulk_end + threadIdx.x; i < hi; i += kTile)
      win[i - lo] = s + i < n_x ? __ldg(x + s + i) : 0.0f;
    __syncthreads();  // the threads' words and the initialised barrier
    mbar_wait(bar, 0);
  }

  float acc = 0.0f, x0 = 0.0f;
  for (int k0 = 0; k0 < T; k0 += kAhead) {
#pragma unroll
    for (int d = 0; d < kAhead; ++d) {
      const int k = k0 + d;
      if (k < T) {
        float xv;
        if constexpr (kShared) {
          xv = win[j[d] - lo];
        } else {
          xv = s + j[d] < n_x ? __ldg(x + s + j[d]) : 0.0f;
        }
        if (k == 0) x0 = xv;
        acc = __fadd_rn(acc, __fmul_rn(v[d], xv));
        if (k + kAhead < T) {
          j[d] = __ldcs(ip + (size_t)(k + kAhead) * kTile);
          v[d] = __ldcs(vp + (size_t)(k + kAhead) * kTile);
        }
      }
    }
  }
  if (T < K) acc = __fadd_rn(acc, __fmul_rn(0.0f, x0));
  __stcs(y + (size_t)t * kTile + row, acc);
}

template <bool kShared>
__global__ void __launch_bounds__(kTile)
ellw_spmv_full(const int* __restrict__ idx, const float* __restrict__ val,
               const int* __restrict__ start, int K, int W,
               const float* __restrict__ x, int n_x, float* __restrict__ y) {
  extern __shared__ float win_full[];
  const int t = blockIdx.x;
  const int s = __ldg(start + t);
  if constexpr (kShared) {
    const bool vec = (((uintptr_t)(x + s)) & 15) == 0;
    for (int i = 4 * threadIdx.x; i < W; i += 4 * kTile) {
      if (vec && s + i + 4 <= n_x) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(x + s + i));
        win_full[i] = v.x;
        win_full[i + 1] = v.y;
        win_full[i + 2] = v.z;
        win_full[i + 3] = v.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          win_full[i + e] = s + i + e < n_x ? __ldg(x + s + i + e) : 0.0f;
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
      xv = win_full[j];
    } else {
      xv = s + j < n_x ? __ldg(x + s + j) : 0.0f;
    }
    acc = __fadd_rn(acc, __fmul_rn(v, xv));
  }
  y[(size_t)t * kTile + threadIdx.x] = acc;
}

// the card's SM count, read once
int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms > 0 ? sms : 1;
}

template <bool kShared, int kAhead, int kMinBlocks>
int launch_trim(const void* idx, const void* val, const void* start,
                const void* seg, int n_tiles, int K, int W, const void* x,
                int n_x, void* y, cudaStream_t st) {
  auto kernel = ellw_spmv_trim<kShared, kAhead, kMinBlocks>;
  const size_t bytes = kShared ? 16 + (size_t)W * sizeof(float) : 0;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<n_tiles, kTile, bytes, st>>>(
      (const int*)idx, (const float*)val, (const int*)start,
      (const int4*)seg, K, (const float*)x, n_x, (float*)y);
  return (int)cudaGetLastError();
}

}  // namespace

// idx int32 and val f32 [n_tiles, 8K, 128], start int32 [n_tiles]
// (multiples of 128), seg int32 [n_tiles, 4] (T, lo, hi, 0 of each tile:
// ops/ellw_spmv.py::slot_extents), x f32 [n_x], y f32 [n_tiles * 1024],
// all on the current device; every idx of a tile in [lo, hi), 0 <= lo <
// hi <= W. shared = 1 stages each tile's window in shared memory (W * 4
// bytes are reserved), 0 reads x through the read-only cache. `stream` is
// a cudaStream_t. Returns cudaGetLastError().
extern "C" int ellw_spmv_trim_f32(const void* idx, const void* val,
                                  const void* start, const void* seg,
                                  int n_tiles, int K, int W, int shared,
                                  const void* x, int n_x, void* y,
                                  void* stream) {
  if (n_tiles <= 0) return 0;
  if (K <= 0 || W <= 0 || W % 128 || n_x < 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (n_tiles <= sm_count())
    return shared ? launch_trim<true, 16, 1>(idx, val, start, seg, n_tiles,
                                             K, W, x, n_x, y, st)
                  : launch_trim<false, 16, 1>(idx, val, start, seg, n_tiles,
                                              K, W, x, n_x, y, st);
  return shared ? launch_trim<true, 4, 2>(idx, val, start, seg, n_tiles, K,
                                          W, x, n_x, y, st)
                : launch_trim<false, 4, 2>(idx, val, start, seg, n_tiles, K,
                                           W, x, n_x, y, st);
}

// The earlier body on the same arrays (no seg): every block walks all K
// slots; shared = 1 stages the whole window (W * 4 bytes), 0 reads x
// through the read-only cache. Returns cudaGetLastError().
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
          ellw_spmv_full<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)bytes);
      if (e != cudaSuccess) return (int)e;
    }
    ellw_spmv_full<true><<<n_tiles, kTile, bytes, st>>>(
        (const int*)idx, (const float*)val, (const int*)start, K, W,
        (const float*)x, n_x, (float*)y);
  } else {
    ellw_spmv_full<false><<<n_tiles, kTile, 0, st>>>(
        (const int*)idx, (const float*)val, (const int*)start, K, W,
        (const float*)x, n_x, (float*)y);
  }
  return (int)cudaGetLastError();
}
