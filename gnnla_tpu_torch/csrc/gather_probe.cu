// K7 and K8: the gather probes for Hopper (sm_90a).
//
// Replace the TPU kernels of scratch/probe_dyngather.py, which measure how
// fast the TPU gathers inside a kernel (tpu.dynamic_gather):
//   K7 — probe_axis1 (:14, pallas_call :37): out[b, r, l] =
//        win[128 * hi[b, r, l] + lo[b, r, l]] * vals[b, r, l], win f32
//        [W = 128 * n_chunks], lo, hi int32 and vals f32 [B, R, 128];
//   K8 — probe_axis0 (:67, pallas_call :77): out[b, r, l] =
//        win[idx[b, r, l], l], win f32 [R, 128], idx int32 [B, R, 128].
//
// Bound on the card: bytes. K7 reads 12 bytes and writes 4 an element (and
// win once); K8 reads 4 and writes 4 (and win once).
//
// K7's design. The TPU gathered 128 lanes at a time in chunk passes over
// its window; the card gathers any word of shared memory, so each thread
// takes 4 consecutive elements (16-byte loads and stores, a warp's
// accesses coalesced), in a grid-stride loop over blocks that each stage
// the window in shared memory first.
//
// K8's design: lane slabs (gather_axis0_slab). Lane l only ever reads
// column l of win, so a block that owns the 32 lanes of lane group c needs
// only the slab win[:, 32c : 32c + 32], R * 128 bytes (64 KB at R = 512,
// where the whole window, 256 KB, fits no block). The grid is persistent:
// 4 lane groups x as many blocks as the SMs hold at once. A block stages
// its slab once with coalesced loads, after each warp has the idx loads of
// its first rows in flight; then each warp takes the 32 lanes of one
// (b, r) row at a time: one 128-byte idx load, the gather slab[idx * 32 +
// lane] (the bank is the lane: no conflicts), one 128-byte store, with
// kRowsAhead rows' idx loads in flight. idx and out pass once, with the
// evict-first hint, so win stays in L2 for the other blocks' slabs. Up to
// the slab limit ops/gather_probe.py states (R <= 1,816) the wrapper takes
// this path; past it, gather_axis0 reads win through the read-only cache.
// gather_axis0 with its whole window in shared memory (4 elements a
// thread) is the earlier design at small R, kept for the comparison. All
// are copies and K7 one f32 multiply (__fmul_rn), so each equals its
// plain version bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
gather_axis1(const float* __restrict__ win, int W, const int4* __restrict__ lo,
             const int4* __restrict__ hi, const float4* __restrict__ vals,
             float4* __restrict__ out, long long n4) {
  extern __shared__ float s_win[];
  for (int i = threadIdx.x; i < W; i += kThreads) s_win[i] = __ldg(win + i);
  __syncthreads();
  for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x; e < n4;
       e += (long long)gridDim.x * kThreads) {
    const int4 l = __ldg(lo + e), h = __ldg(hi + e);
    const float4 v = __ldg(vals + e);
    float4 o;
    o.x = __fmul_rn(s_win[128 * h.x + l.x], v.x);
    o.y = __fmul_rn(s_win[128 * h.y + l.y], v.y);
    o.z = __fmul_rn(s_win[128 * h.z + l.z], v.z);
    o.w = __fmul_rn(s_win[128 * h.w + l.w], v.w);
    out[e] = o;
  }
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
gather_axis0(const float* __restrict__ win, int R,
             const int4* __restrict__ idx, float4* __restrict__ out,
             long long n4) {
  extern __shared__ float s_win[];
  if constexpr (kShared) {
    for (int i = threadIdx.x; i < R * 128; i += kThreads)
      s_win[i] = __ldg(win + i);
    __syncthreads();
  }
  for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x; e < n4;
       e += (long long)gridDim.x * kThreads) {
    const int4 r = __ldg(idx + e);
    const int l = (int)((4 * e) & 127);  // lane of the first of the four
    float4 o;
    if constexpr (kShared) {
      o.x = s_win[128 * r.x + l];
      o.y = s_win[128 * r.y + l + 1];
      o.z = s_win[128 * r.z + l + 2];
      o.w = s_win[128 * r.w + l + 3];
    } else {
      o.x = __ldg(win + 128 * r.x + l);
      o.y = __ldg(win + 128 * r.y + l + 1);
      o.z = __ldg(win + 128 * r.z + l + 2);
      o.w = __ldg(win + 128 * r.w + l + 3);
    }
    out[e] = o;
  }
}

constexpr int kSlabThreads = 1024;
constexpr int kSlabWarps = kSlabThreads / 32;
constexpr int kSlabLanes = 32;
constexpr int kRowsAhead = 4;

__global__ void __launch_bounds__(kSlabThreads, 2)
gather_axis0_slab(const float* __restrict__ win, int R,
                  const int* __restrict__ idx, float* __restrict__ out,
                  long long rows) {
  extern __shared__ float slab[];  // [R, 32]
  const int c = blockIdx.x & 3;    // lane group
  const int lane = threadIdx.x & 31;
  const int col = kSlabLanes * c + lane;
  const long long first =
      (long long)(blockIdx.x >> 2) * kSlabWarps + (threadIdx.x >> 5);
  const long long stride = (long long)(gridDim.x >> 2) * kSlabWarps;
  int j[kRowsAhead];
#pragma unroll
  for (int u = 0; u < kRowsAhead; ++u) {
    const long long row = first + u * stride;
    j[u] = row < rows ? __ldcs(idx + row * 128 + col) : 0;
  }
  for (int i = threadIdx.x; i < R * kSlabLanes; i += kSlabThreads)
    slab[i] = __ldg(win + (i >> 5) * 128 + kSlabLanes * c + (i & 31));
  __syncthreads();
  for (long long row0 = first; row0 < rows; row0 += kRowsAhead * stride) {
#pragma unroll
    for (int u = 0; u < kRowsAhead; ++u) {
      const long long row = row0 + u * stride;
      if (row < rows) {
        __stcs(out + row * 128 + col, slab[j[u] * kSlabLanes + lane]);
        const long long next = row + kRowsAhead * stride;
        if (next < rows) j[u] = __ldcs(idx + next * 128 + col);
      }
    }
  }
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

// one wave of resident blocks (8 of 256 threads fill an SM's 2,048): the
// grid-stride loop covers the rest
int grid_for(long long n4) {
  const long long want = (n4 + kThreads - 1) / kThreads;
  const long long wave = 8LL * sm_count();
  return (int)(want < wave ? want : wave);
}

}  // namespace

// K7. win f32 [W] (W a multiple of 128, at most the shared-memory limit),
// lo, hi int32 and vals f32 [n] with every 128 * hi + lo in [0, W), out f32
// [n]; n a multiple of 4, every pointer 16-byte aligned, all on the
// current device. Returns cudaGetLastError().
extern "C" int gather_axis1_f32(const void* win, int W, const void* lo,
                                const void* hi, const void* vals, void* out,
                                long long n, void* stream) {
  if (n <= 0) return 0;
  if (W <= 0 || n % 4) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)W * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gather_axis1, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int grid = grid_for(n / 4);
  gather_axis1<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)win, W, (const int4*)lo, (const int4*)hi,
      (const float4*)vals, (float4*)out, n / 4);
  return (int)cudaGetLastError();
}

// K8. win f32 [R, 128], idx int32 [n] (n a multiple of 128, lane = position
// % 128) with every idx in [0, R), out f32 [n]; 16-byte aligned, on the
// current device. mode 2 gathers from lane slabs (R * 128 bytes of shared
// memory a block), 1 stages all of win in shared memory (R * 512 bytes),
// 0 reads it through the read-only cache. Returns cudaGetLastError().
extern "C" int gather_axis0_f32(const void* win, int R, const void* idx,
                                void* out, long long n, int mode,
                                void* stream) {
  if (n <= 0) return 0;
  if (R <= 0 || n % 128 || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (mode == 2) {
    const size_t smem = (size_t)R * kSlabLanes * sizeof(float);
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          gather_axis0_slab, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    // blocks a lane group: a warp for every row, at most one wave of the
    // blocks the SMs hold at once (the count for this slab size kept)
    static size_t known_smem = 0;
    static int per_sm = 0;
    if (smem != known_smem) {
      const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, gather_axis0_slab, kSlabThreads, smem);
      if (e != cudaSuccess) return (int)e;
      if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
      known_smem = smem;
    }
    const long long rows = n / 128;
    const long long want = (rows + kSlabWarps - 1) / kSlabWarps;
    const long long wave = (long long)per_sm * sm_count() / 4;
    const long long m = want < wave ? want : (wave > 0 ? wave : 1);
    gather_axis0_slab<<<(int)(4 * m), kSlabThreads, smem, st>>>(
        (const float*)win, R, (const int*)idx, (float*)out, rows);
  } else if (mode == 1) {
    const size_t smem = (size_t)R * 128 * sizeof(float);
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          gather_axis0<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    const int grid = grid_for(n / 4);
    gather_axis0<true><<<grid, kThreads, smem, st>>>(
        (const float*)win, R, (const int4*)idx, (float4*)out, n / 4);
  } else {
    const int grid = grid_for(n / 4);
    gather_axis0<false><<<grid, kThreads, 0, st>>>(
        (const float*)win, R, (const int4*)idx, (float4*)out, n / 4);
  }
  return (int)cudaGetLastError();
}
