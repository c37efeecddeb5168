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
// against 2 K H W flops per step, far below the ridge point. At 1024^2
// the 3-step Jacobi (K = 5) moves 33.6 MB, about 10 us at 3.35 TB/s.
//
// What the design does about it. The TPU kernel loads the planes, x and c
// into VMEM once and runs every step there. A Hopper block has at most
// 227 KB of shared memory and blocks run in no order, so the grid is cut
// into tiles, and each call takes one of two forms (chosen once per call
// object by ops/stencil_kernel.py::stencil_form):
//   * Tile form (plain and affine, any n_steps): one launch. A block owns
//     an output tile and stages x over the tile plus a halo in shared
//     memory with cp.async. Per side the halo is n_steps times that
//     side's reach (a shift dy in [0, H) reaches dy or dy - H, whichever
//     is smaller in magnitude; columns are rounded up to the vector width
//     V). Every halo index is taken modulo H and W, so periodic wraps and
//     grids smaller than the halo stay exact: a halo point holds the value
//     of the grid point it wraps to. The block then runs all n_steps in
//     shared memory, over a region that shrinks by one reach per step,
//     ping-ponging between two buffers, and writes only the tile to y. So
//     x is read from device memory once, the taps (and c) once per step,
//     the later steps from L2 (the tile's planes were just read), and the
//     steps in between never touch device memory. A thread computes V
//     consecutive columns (V = 4 for f32 taps, 8 for bf16: one 16-byte
//     tap load per shift; V = 1 where W or an operand is not aligned), and
//     reads x from shared memory as aligned float4s, so a warp's reads do
//     not conflict. The walk over a region is 2-D, with no division per
//     point. Redundant work: the halo points of the steps before the last,
//     13% at 1024^2, K = 5, 3 steps, a 16 x 128 tile.
//   * Per-step form (normalize, whose norm spans the whole grid in every
//     step; operators whose halo the tile form will not take; one-step
//     calls, which have no step to save and run faster without staging x
//     before their tap loads): one launch per step, ping-ponging through
//     device memory; one thread per point, columns fastest, so every load
//     coalesces. normalize: each
//     step kernel writes its block's partial sum of acc^2; a one-block
//     finalize sums the partials in a fixed order and stores 1/sqrt(sum);
//     the next step folds that scale into its reads of x (v * scale is the
//     value the TPU stores), and one last pass scales `out`. No float
//     atomics, so repeated runs give the same bits. Launches per call:
//     n_steps (plain, affine) or 2 n_steps + 1 (normalize).
// Both forms keep the JAX kernel's summation order: acc starts as
// tap_0 * v_0, the taps add in shift order, affine adds c after the tap
// sum. Products and sums are rounded separately (__fmul_rn / __fadd_rn,
// no FMA contraction), so plain and affine give the plain PyTorch
// version's bits exactly, in either form. The caller's x is never written.
// The shifts come by value in the kernel's parameters (a broadcast read).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;       // step, scale and tile kernels
constexpr int kFinalThreads = 1024; // the one-block finalize
constexpr int kMaxTaps = 64;
constexpr int kMaxSmem = 227 * 1024;  // a block's shared memory on sm_90

enum Mode { kPlain = 0, kAffine = 1, kNormalize = 2 };
enum Form { kStep = 0, kTile = 1 };

// The shift classes: in [0, H) x [0, W) for the per-step form, signed
// (the reach of each) for the tile form.
struct Shifts {
  int dy[kMaxTaps];
  int dx[kMaxTaps];
};

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

// ------------------------------------------------------------ per-step form
// One step. in_scale: null, or the previous normalize step's 1/||.||
// folded into the reads.
template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads)
stencil_step(const T* __restrict__ taps, Shifts sh, int K, int H, int W,
             const float* __restrict__ x,
             const float* __restrict__ in_scale,
             const float* __restrict__ c, float* __restrict__ y,
             float* __restrict__ partial) {
  const int n = H * W;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  float acc = 0.0f;
  if (i < n) {
    const int r = i / W;
    const int col = i - r * W;
    const float scale = (MODE == kNormalize && in_scale) ? *in_scale : 1.0f;
    const T* t = taps + i;
    for (int k = 0; k < K; ++k) {
      int rr = r + sh.dy[k];
      if (rr >= H) rr -= H;
      int cc = col + sh.dx[k];
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
int run_steps(const void* taps, const Shifts& sh, int K, int H, int W,
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
        (const T*)taps, sh, K, H, W, src, in_scale, c, dst, partial);
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

// ---------------------------------------------------------------- tile form
// A tile call's geometry. Per step the region grows by (ru, rd) rows and
// (cl, cr) columns (multiples of V) on each side of the tile; the staged
// region is the tile grown n_steps times: rh0 x rw0 points, rw0 also the
// pitch of both shared buffers.
struct TileGeom {
  int th, tw;          // the output tile
  int ru, rd, cl, cr;  // per-step growth: rows up, down; columns left, right
  int rh0, rw0;        // the staged region
  int n_steps;
};

// v modulo n in [0, n); a division only off the grid.
__device__ __forceinline__ int wrap(int v, int n) {
  if ((unsigned)v < (unsigned)n) return v;
  v %= n;
  return v < 0 ? v + n : v;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

// A 2-D walk over rows x groups items, kThreads apart, with no division
// per item: the caller advances (row, g) by next().
struct Walk {
  int row, g, drow, dg, groups;
  __device__ __forceinline__ explicit Walk(int groups_) : groups(groups_) {
    row = threadIdx.x / groups;
    g = threadIdx.x - row * groups;
    drow = kThreads / groups;
    dg = kThreads - drow * groups;
  }
  __device__ __forceinline__ void next() {
    g += dg;
    row += drow;
    if (g >= groups) {
      g -= groups;
      ++row;
    }
  }
};

// V values of plane `t` (f32 or bf16) at point p, widened to f32: 16-byte
// loads when V > 1 (p a multiple of V, the plane 16-byte aligned). A bf16
// value is the upper half of its f32.
template <typename T, int V>
__device__ __forceinline__ void load_taps(const T* __restrict__ t, size_t p,
                                          float (&out)[V]) {
  if constexpr (V == 1) {
    out[0] = widen(__ldg(t + p));
  } else {
    constexpr int PER = 16 / (int)sizeof(T);  // values per 16 bytes
    const uint4* q = reinterpret_cast<const uint4*>(t + p);
#pragma unroll
    for (int j = 0; j < V / PER; ++j) {
      const uint4 u = __ldg(q + j);
      const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (sizeof(T) == 4) {
          out[j * 4 + e] = __uint_as_float(w[e]);
        } else {
          out[j * 8 + 2 * e] = __uint_as_float(w[e] << 16);
          out[j * 8 + 2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
        }
      }
    }
  }
}

// V consecutive f32 values of shared memory from index i. For V > 1 the
// reads are aligned float4s; s = i & 3 is the same across the warp (every
// thread's base is a multiple of 4; the shift is warp-uniform).
template <int V>
__device__ __forceinline__ void read_x(const float* src, int i,
                                       float (&out)[V]) {
  if constexpr (V == 1) {
    out[0] = src[i];
  } else {
    const int s = i & 3;
    const float4* p = reinterpret_cast<const float4*>(src + (i - s));
    float w[V + 4];
#pragma unroll
    for (int q = 0; q < V / 4; ++q) {
      const float4 f = p[q];
      w[4 * q] = f.x;
      w[4 * q + 1] = f.y;
      w[4 * q + 2] = f.z;
      w[4 * q + 3] = f.w;
    }
    if (s == 0) {
#pragma unroll
      for (int v = 0; v < V; ++v) out[v] = w[v];
      return;
    }
    const float4 f = p[V / 4];  // inside the row: i + V - 1 < the row's end
    w[V] = f.x;
    w[V + 1] = f.y;
    w[V + 2] = f.z;
    w[V + 3] = f.w;
    switch (s) {
      case 1:
#pragma unroll
        for (int v = 0; v < V; ++v) out[v] = w[v + 1];
        break;
      case 2:
#pragma unroll
        for (int v = 0; v < V; ++v) out[v] = w[v + 2];
        break;
      default:
#pragma unroll
        for (int v = 0; v < V; ++v) out[v] = w[v + 3];
        break;
    }
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* dst, const float (&a)[V]) {
  if constexpr (V == 1) {
    dst[0] = a[0];
  } else {
#pragma unroll
    for (int q = 0; q < V / 4; ++q)
      reinterpret_cast<float4*>(dst)[q] =
          make_float4(a[4 * q], a[4 * q + 1], a[4 * q + 2], a[4 * q + 3]);
  }
}

template <typename T, int MODE, int V>
__global__ void __launch_bounds__(kThreads)
stencil_tile(const T* __restrict__ taps, Shifts sh, int K, int H, int W,
             TileGeom g, const float* __restrict__ x,
             const float* __restrict__ c, float* __restrict__ y) {
  extern __shared__ float4 smem4[];
  float* const buf0 = reinterpret_cast<float*>(smem4);
  float* const buf1 = buf0 + g.rh0 * g.rw0;
  const size_t n = (size_t)H * W;
  const int S = g.n_steps;
  const int r0 = blockIdx.y * g.th, c0 = blockIdx.x * g.tw;
  // the staged region's corner on the unwrapped grid
  const int gr0 = r0 - S * g.ru, gc0 = c0 - S * g.cl;

  {  // stage x over the region: 16-byte copies of 4 columns when V > 1
    constexpr int E = V == 1 ? 1 : 4;
    Walk w(g.rw0 / E);
    for (int it = threadIdx.x; it < g.rh0 * (g.rw0 / E);
         it += kThreads, w.next()) {
      const int lc = w.g * E;
      const float* src = x + (size_t)wrap(gr0 + w.row, H) * W +
                         wrap(gc0 + lc, W);
      float* dst = buf0 + w.row * g.rw0 + lc;
      if (E == 4) cp_async16(dst, src); else cp_async4(dst, src);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
  }

  for (int s = 1; s <= S; ++s) {
    const int m = S - s;  // steps still to come
    const float* src = (s & 1) ? buf0 : buf1;
    float* dst = (s & 1) ? buf1 : buf0;
    // this step's region, in the staged region's coordinates
    const int lr0 = s * g.ru, lc0 = s * g.cl;
    const int rows = g.th + m * (g.ru + g.rd);
    const int groups = (g.tw + m * (g.cl + g.cr)) / V;
    Walk w(groups);
    for (int it = threadIdx.x; it < rows * groups;
         it += kThreads, w.next()) {
      const int lr = lr0 + w.row, lc = lc0 + w.g * V;
      const int gr = gr0 + lr, gc = gc0 + lc;
      if (s == S && (gr >= H || gc >= W)) continue;  // past the grid's end
      const size_t p = (size_t)wrap(gr, H) * W + wrap(gc, W);
      float acc[V];
#pragma unroll 4
      for (int k = 0; k < K; ++k) {
        float t[V], v[V];
        load_taps<T, V>(taps + k * n, p, t);
        read_x<V>(src, (lr + sh.dy[k]) * g.rw0 + lc + sh.dx[k], v);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float term = __fmul_rn(t[e], v[e]);
          acc[e] = k == 0 ? term : __fadd_rn(acc[e], term);
        }
      }
      if (MODE == kAffine) {
        float cv[V];
        load_taps<float, V>(c, p, cv);
#pragma unroll
        for (int e = 0; e < V; ++e) acc[e] = __fadd_rn(acc[e], cv[e]);
      }
      store_vec<V>(s == S ? y + p : dst + lr * g.rw0 + lc, acc);
    }
    __syncthreads();
  }
}

template <typename T, int MODE, int V>
int launch_tile(const void* taps, const Shifts& sh, int K, int H, int W,
                const TileGeom& g, const float* x, const float* c,
                float* out, size_t smem, cudaStream_t stream) {
  // above 48 KB only after the opt-in; once per kernel and process
  static bool opted = false;
  if (!opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        stencil_tile<T, MODE, V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    opted = true;
  }
  const dim3 grid((W + g.tw - 1) / g.tw, (H + g.th - 1) / g.th);
  stencil_tile<T, MODE, V><<<grid, kThreads, smem, stream>>>(
      (const T*)taps, sh, K, H, W, g, x, c, out);
  return (int)cudaGetLastError();
}

template <typename T, int MODE>
int run_tile(const void* taps, const Shifts& sh, int K, int H, int W,
             int tile_h, int tile_w, const float* x, const float* c,
             float* out, int n_steps, cudaStream_t stream) {
  // V columns a thread: one 16-byte tap load per shift, where W and every
  // operand allow it
  constexpr int VEC = 16 / (int)sizeof(T);
  const uintptr_t addr = (uintptr_t)taps | (uintptr_t)x | (uintptr_t)out |
                         (uintptr_t)(MODE == kAffine ? c : nullptr);
  const int V = (W % VEC == 0 && addr % 16 == 0) ? VEC : 1;
  // signed shifts: dy or dy - H, whichever is smaller in magnitude
  Shifts sg;
  int ru = 0, rd = 0, rl = 0, rr = 0;
  for (int k = 0; k < K; ++k) {
    sg.dy[k] = 2 * sh.dy[k] <= H ? sh.dy[k] : sh.dy[k] - H;
    sg.dx[k] = 2 * sh.dx[k] <= W ? sh.dx[k] : sh.dx[k] - W;
    ru = max(ru, -sg.dy[k]);
    rd = max(rd, sg.dy[k]);
    rl = max(rl, -sg.dx[k]);
    rr = max(rr, sg.dx[k]);
  }
  TileGeom g;
  g.th = tile_h;
  g.tw = tile_w;
  g.ru = ru;
  g.rd = rd;
  g.cl = (rl + V - 1) / V * V;
  g.cr = (rr + V - 1) / V * V;
  g.n_steps = n_steps;
  const long long rh0 = tile_h + (long long)n_steps * (ru + rd);
  const long long rw0 = tile_w + (long long)n_steps * (g.cl + g.cr);
  const long long smem = 2 * rh0 * rw0 * (long long)sizeof(float);
  if (tile_h < 1 || tile_w < 1 || tile_w % V != 0 || smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  g.rh0 = (int)rh0;
  g.rw0 = (int)rw0;
  if (V == 1)
    return launch_tile<T, MODE, 1>(taps, sg, K, H, W, g, x, c, out,
                                   (size_t)smem, stream);
  return launch_tile<T, MODE, VEC>(taps, sg, K, H, W, g, x, c, out,
                                   (size_t)smem, stream);
}

template <typename T>
int run_mode(int mode, int form, const void* taps, const Shifts& sh, int K,
             int H, int W, int tile_h, int tile_w, const float* x,
             const float* c, float* out, float* tmp, float* scratch,
             int n_steps, cudaStream_t stream) {
  if (form == kTile) {
    if (mode == kPlain)
      return run_tile<T, kPlain>(taps, sh, K, H, W, tile_h, tile_w, x, c,
                                 out, n_steps, stream);
    if (mode == kAffine)
      return run_tile<T, kAffine>(taps, sh, K, H, W, tile_h, tile_w, x, c,
                                  out, n_steps, stream);
    return (int)cudaErrorInvalidValue;  // normalize runs per step
  }
  switch (mode) {
    case kPlain:
      return run_steps<T, kPlain>(taps, sh, K, H, W, x, c, out, tmp,
                                  scratch, n_steps, stream);
    case kAffine:
      return run_steps<T, kAffine>(taps, sh, K, H, W, x, c, out, tmp,
                                   scratch, n_steps, stream);
    case kNormalize:
      return run_steps<T, kNormalize>(taps, sh, K, H, W, x, c, out, tmp,
                                      scratch, n_steps, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// taps [K, H, W] f32 (tap_bf16 = 0) or bf16 (tap_bf16 = 1) on the device;
// shifts [2K] int32 in HOST memory (dy's, then dx's; taken modulo H and
// W); x, out [H, W] f32; c [H, W] f32 for mode 1 (affine), else null.
// form 1 (tile; modes 0 and 1 only) runs every step in one launch on
// tile_h x tile_w output tiles; form 0 (per step) needs tmp [H, W] f32
// when n_steps > 1 and, for mode 2 (normalize), scratch f32 of at least
// ceil(H W / 256) + 1 entries. Device pointers on the current device;
// `stream` is a cudaStream_t. Launches 1 kernel (tile form) or n_steps
// (plus 1 + n_steps for normalize) and returns the first non-zero
// cudaGetLastError(), or cudaErrorInvalidValue for arguments it cannot
// take (a tile whose halo region exceeds a block's shared memory among
// them).
extern "C" int stencil_f32(const void* taps, int tap_bf16, const int* shifts,
                           int K, int H, int W, const void* x, const void* c,
                           void* out, void* tmp, void* scratch,
                           int scratch_len, int n_steps, int mode, int form,
                           int tile_h, int tile_w, void* stream) {
  const long long n = (long long)H * W;
  if (K < 1 || K > kMaxTaps || H < 1 || W < 1 || n >= (1LL << 31) ||
      n_steps < 1 || !shifts || (mode == kAffine && !c) ||
      (form != kStep && form != kTile) ||
      (form == kStep && n_steps > 1 && !tmp))
    return (int)cudaErrorInvalidValue;
  if (form == kStep && mode == kNormalize &&
      (!scratch || scratch_len < (n + kThreads - 1) / kThreads + 1))
    return (int)cudaErrorInvalidValue;
  // reduced modulo H and W: the plain version's roll semantics for any
  // shift, and no read outside x whatever the caller passes
  Shifts sh;
  for (int k = 0; k < K; ++k) {
    const int dy = shifts[k] % H, dx = shifts[K + k] % W;
    sh.dy[k] = dy < 0 ? dy + H : dy;
    sh.dx[k] = dx < 0 ? dx + W : dx;
  }
  float* sc = mode == kNormalize ? (float*)scratch : nullptr;
  if (tap_bf16)
    return run_mode<__nv_bfloat16>(mode, form, taps, sh, K, H, W, tile_h,
                                   tile_w, (const float*)x, (const float*)c,
                                   (float*)out, (float*)tmp, sc, n_steps,
                                   (cudaStream_t)stream);
  return run_mode<float>(mode, form, taps, sh, K, H, W, tile_h, tile_w,
                         (const float*)x, (const float*)c, (float*)out,
                         (float*)tmp, sc, n_steps, (cudaStream_t)stream);
}
