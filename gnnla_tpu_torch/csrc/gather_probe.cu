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
// The design. The TPU gathered 128 lanes at a time in chunk passes over
// its window; the card gathers any word of shared memory, so each thread
// takes 4 consecutive elements (16-byte loads and stores, a warp's
// accesses coalesced), in a grid-stride loop over blocks that each stage
// the window in shared memory first. K8's window is R * 128 * 4 bytes;
// over the budget ops/gather_probe.py states (at R = 512 it is 256 KB,
// more than a block's 227 KB) the threads read it through the read-only
// cache instead. Both are copies and one f32 multiply (__fmul_rn), so
// each equals its plain version bit for bit.

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

// one wave of resident blocks (8 of 256 threads fill an SM's 2,048), the
// SM count read once: the grid-stride loop covers the rest
int grid_for(long long n4) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const long long want = (n4 + kThreads - 1) / kThreads;
  const long long wave = 8LL * (sms > 0 ? sms : 1);
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
// current device. shared = 1 stages win in shared memory (R * 512 bytes),
// 0 reads it through the read-only cache. Returns cudaGetLastError().
extern "C" int gather_axis0_f32(const void* win, int R, const void* idx,
                                void* out, long long n, int shared,
                                void* stream) {
  if (n <= 0) return 0;
  if (R <= 0 || n % 128) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (shared) {
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
