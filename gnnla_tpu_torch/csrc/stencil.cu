// K4: fused grid stencil for Hopper (sm_90a).
//
// Replaces the TPU kernel gnnla_tpu/ops/pallas_stencil.py::
// _build_stencil_call (:126, pallas_call at :231): n_steps of
//
//   y[r, c] = sum_k tap_k[r, c] * x[(r + dy_k) % H, (c + dx_k) % W]
//
// on an H x W grid with K <= 64 modular shift classes, in three modes:
// plain (x <- T x), affine (x <- T x + c: the Jacobi sweep with
// M = I - w D^-1 A, and the residual with taps = -A, c = b) and normalize
// (x <- T x / ||T x||_2 over the whole grid, per step: the power method).
// Taps are f32 or bf16 (widened exactly; f32 arithmetic throughout).
//
// Bound on the card: bytes. A fused call reads the K tap planes, x (and
// c) once and writes y once: (K * tap_bytes + 2 (+1 for c)) * H * W bytes,
// against 2 K H W flops — a quarter of a flop per byte, far below the
// ridge point. At 1024^2 the 3-step Jacobi (K = 5) moves 33.6 MB, about
// 10 us at 3.35 TB/s.
//
// What the design does about it:
//   * The TPU kernel keeps the iterate and all planes in VMEM for every
//     step and never touches HBM in between. A Hopper block has at most
//     227 KB of shared memory, blocks run in no order, and a step needs
//     all of the previous one (a periodic wrap reads row H-1 from row 0),
//     so here each step is one launch, ping-ponging between two buffers
//     the wrapper allocates; the caller's x is never written. The last
//     step always writes `out`, whatever the parity of n_steps. At 1024^2
//     five f32 planes plus x, y and c (34 MB) fit the 50 MB L2, which
//     plays the part of VMEM for the steps after the first.
//   * One thread per grid point, columns fastest: for a fixed k the
//     threads of a warp read tap_k[r, c..c+31] and x[r', c'..c'+31], both
//     contiguous, so every load coalesces and each plane is read once.
//   * The shifts are staged in shared memory once per block (read with a
//     warp-uniform index: a broadcast), reduced there to 0 <= dy < H,
//     0 <= dx < W (the plain version's roll semantics for any shift, and
//     no read outside x whatever the caller passes). The wrap in the inner
//     loop is then a compare-and-subtract, not a `%`.
//   * Summation order is the JAX kernel's: acc starts as tap_0 * v_0, the
//     taps add in shift order, affine adds c after the tap sum. Products
//     and sums are rounded separately (__fmul_rn / __fadd_rn, no FMA
//     contraction), so plain and affine give the plain PyTorch version's
//     bits exactly.
//   * normalize needs the norm of the whole grid inside every step. Each
//     step kernel writes its block's partial sum of acc^2; a one-block
//     finalize sums the partials in a fixed order and stores 1/sqrt(sum);
//     the next step folds that scale into its reads of x (v * scale is the
//     value the TPU stores), and one last pass scales `out`. No float
//     atomics, so repeated runs give the same bits. Launches per call:
//     n_steps (plain, affine) or 2 n_steps + 1 (normalize).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;       // step and scale kernels
constexpr int kFinalThreads = 1024; // the one-block finalize
constexpr int kMaxTaps = 64;

enum Mode { kPlain = 0, kAffine = 1, kNormalize = 2 };

__device__ __forceinline__ float widen(float t) { return t; }
__device__ __forceinline__ float widen(__nv_bfloat16 t) {
  return __bfloat162float(t);
}

// Sum over the block; every thread must call it. The result is valid in
// thread 0. Fixed order: warp shuffles, then the warps' sums in order.
template <int THREADS>
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float s_warp[THREADS / 32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) s_warp[warp] = v;
  __syncthreads();
  v = 0.0f;
  if (warp == 0) {
    v = lane < THREADS / 32 ? s_warp[lane] : 0.0f;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;
}

// One step. shifts: device int32 [2K], the dy's then the dx's. in_scale:
// null, or the previous normalize step's 1/||.|| folded into the reads.
template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads)
stencil_step(const T* __restrict__ taps, const int* __restrict__ shifts,
             int K, int H, int W, const float* __restrict__ x,
             const float* __restrict__ in_scale,
             const float* __restrict__ c, float* __restrict__ y,
             float* __restrict__ partial) {
  __shared__ int s_dy[kMaxTaps], s_dx[kMaxTaps];
  if (threadIdx.x < K) {
    const int dy = shifts[threadIdx.x] % H, dx = shifts[K + threadIdx.x] % W;
    s_dy[threadIdx.x] = dy < 0 ? dy + H : dy;
    s_dx[threadIdx.x] = dx < 0 ? dx + W : dx;
  }
  __syncthreads();

  const int n = H * W;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  float acc = 0.0f;
  if (i < n) {
    const int r = i / W;
    const int col = i - r * W;
    const float scale = (MODE == kNormalize && in_scale) ? *in_scale : 1.0f;
    const T* t = taps + i;
    for (int k = 0; k < K; ++k) {
      int rr = r + s_dy[k];
      if (rr >= H) rr -= H;
      int cc = col + s_dx[k];
      if (cc >= W) cc -= W;
      float v = __ldg(x + rr * W + cc);
      if (MODE == kNormalize && in_scale) v = __fmul_rn(v, scale);
      const float term = __fmul_rn(widen(t[(size_t)k * n]), v);
      acc = k == 0 ? term : __fadd_rn(acc, term);
    }
    if (MODE == kAffine) acc = __fadd_rn(acc, c[i]);
    y[i] = acc;
  }
  if (MODE == kNormalize) {
    const float s = block_sum<kThreads>(__fmul_rn(acc, acc));
    if (threadIdx.x == 0) partial[blockIdx.x] = s;
  }
}

__global__ void __launch_bounds__(kFinalThreads)
norm_finalize(const float* __restrict__ partial, int n_partial,
              float* __restrict__ scale) {
  float s = 0.0f;
  for (int j = threadIdx.x; j < n_partial; j += kFinalThreads) s += partial[j];
  s = block_sum<kFinalThreads>(s);
  if (threadIdx.x == 0) *scale = 1.0f / sqrtf(s);
}

__global__ void __launch_bounds__(kThreads)
scale_inplace(float* __restrict__ y, int n, const float* __restrict__ scale) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < n) y[i] = __fmul_rn(y[i], *scale);
}

template <typename T, int MODE>
int run(const void* taps, const int* shifts, int K, int H, int W,
        const float* x, const float* c, float* out, float* tmp,
        float* scratch, int n_steps, cudaStream_t stream) {
  const int n = H * W;
  const int blocks = (n + kThreads - 1) / kThreads;
  float* partial = scratch;
  float* scale = scratch ? scratch + blocks : nullptr;
  const float* src = x;
  for (int s = 0; s < n_steps; ++s) {
    // the last step lands in `out`: alternate backwards from it
    float* dst = ((n_steps - 1 - s) % 2 == 0) ? out : tmp;
    const float* in_scale = (MODE == kNormalize && s > 0) ? scale : nullptr;
    stencil_step<T, MODE><<<blocks, kThreads, 0, stream>>>(
        (const T*)taps, shifts, K, H, W, src, in_scale, c, dst, partial);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (MODE == kNormalize) {
      norm_finalize<<<1, kFinalThreads, 0, stream>>>(partial, blocks, scale);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    src = dst;
  }
  if (MODE == kNormalize) {
    scale_inplace<<<blocks, kThreads, 0, stream>>>(out, n, scale);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int run_mode(int mode, const void* taps, const int* shifts, int K, int H,
             int W, const float* x, const float* c, float* out, float* tmp,
             float* scratch, int n_steps, cudaStream_t stream) {
  switch (mode) {
    case kPlain:
      return run<T, kPlain>(taps, shifts, K, H, W, x, c, out, tmp, scratch,
                            n_steps, stream);
    case kAffine:
      return run<T, kAffine>(taps, shifts, K, H, W, x, c, out, tmp, scratch,
                             n_steps, stream);
    case kNormalize:
      return run<T, kNormalize>(taps, shifts, K, H, W, x, c, out, tmp,
                                scratch, n_steps, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// taps [K, H, W] f32 (tap_bf16 = 0) or bf16 (tap_bf16 = 1); shifts [2K]
// int32 (dy's, then dx's; taken modulo H and W); x, out [H, W] f32;
// c [H, W] f32 for mode 1 (affine), else null; tmp [H, W] f32 when
// n_steps > 1; scratch f32 of at least ceil(H W / 256) + 1 entries for
// mode 2 (normalize). All on the current device; `stream` is a
// cudaStream_t. Launches n_steps step kernels (plus 1 + n_steps for
// normalize) and returns the first non-zero cudaGetLastError(), or
// cudaErrorInvalidValue for arguments it cannot take.
extern "C" int stencil_f32(const void* taps, int tap_bf16, const void* shifts,
                           int K, int H, int W, const void* x, const void* c,
                           void* out, void* tmp, void* scratch,
                           int scratch_len, int n_steps, int mode,
                           void* stream) {
  const long long n = (long long)H * W;
  if (K < 1 || K > kMaxTaps || H < 1 || W < 1 || n >= (1LL << 31) ||
      n_steps < 1 || (n_steps > 1 && !tmp) || (mode == kAffine && !c))
    return (int)cudaErrorInvalidValue;
  if (mode == kNormalize &&
      (!scratch || scratch_len < (n + kThreads - 1) / kThreads + 1))
    return (int)cudaErrorInvalidValue;
  float* sc = mode == kNormalize ? (float*)scratch : nullptr;
  if (tap_bf16)
    return run_mode<__nv_bfloat16>(mode, taps, (const int*)shifts, K, H, W,
                                   (const float*)x, (const float*)c,
                                   (float*)out, (float*)tmp, sc, n_steps,
                                   (cudaStream_t)stream);
  return run_mode<float>(mode, taps, (const int*)shifts, K, H, W,
                         (const float*)x, (const float*)c, (float*)out,
                         (float*)tmp, sc, n_steps, (cudaStream_t)stream);
}
