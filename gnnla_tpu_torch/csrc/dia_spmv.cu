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
// Vertex-update forms. In a multigrid cycle the kernel's result feeds a
// pass over n-vectors: a Jacobi sweep x + w (b - A x), w = omega / d, runs
// b - y, w * r and x + t after it (and omega / d, two more kernels, at
// each call), the residual b - A x one b - y. As PyTorch kernels those
// passes each read two or three vectors and write one, and on the small
// levels they are launch-bound. So the kernel applies an update to row
// i's sum while it is in a register, and a sweep or a residual is one
// launch that reads x, b (and d) once and writes one vector, `out`:
//   * plain: out[i] = acc_i (y = A x);
//   * Jacobi: out[i] = x[i] + w_i (b[i] - acc_i), w_i = rn(rcp(d[i]) omega);
//   * residual: out[i] = b[i] - acc_i.
// Each rounds step by step as the eager chain does (the _rn intrinsics
// keep the compiler from contracting a product and a sum into an FMA):
// rcp(d) then * omega is torch's `omega / d` (`d.reciprocal() * omega`),
// then b - y, w * r and x + t; so on the same sums the fused forms give
// the eager chain's bits. There is one body per shape (warp-per-tile,
// split), templated on the update, and one launcher; each form and shape
// keeps a kernel name of its own for traces. One C entry per storage
// takes every form: the operands pick it (no b: plain; b: residual; b and
// d: Jacobi). `out` is never x or b: other rows read x at shifted
// offsets. The non-finite repair writes NaN into `out`'s rows, which is
// what the eager chain gives for a NaN y.
//
// The gradient needs no other kernel: x's cotangent is this kernel on the
// compact layout of the transposed diagonals (ops/dia.py::dia_transpose),
// the diagonals' cotangent plain elementwise products, as in the JAX
// package.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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
// SHARED_X: x lies in shared memory (the Chebyshev form), else in device
// memory, read through the read-only cache.
template <typename D, bool SHARED_X = false>
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
          if constexpr (SHARED_X)
            xv[u] = x[c];
          else
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

// Whether the tile's segments [start, end) hold offset `off` (a binary
// search: the offsets increase within a tile).
__device__ __forceinline__ bool holds(const int* __restrict__ seg_off,
                                      int start, int end, int off) {
  int lo = start, hi = end;
  while (lo < hi) {  // the first segment of the tile at >= off
    const int mid = (lo + hi) >> 1;
    if (__ldg(seg_off + mid) < off) lo = mid + 1; else hi = mid;
  }
  return lo < end && __ldg(seg_off + lo) == off;
}

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
      if (!holds(L.seg_off, __ldg(L.seg_ptr + t), __ldg(L.seg_ptr + t + 1),
                 off))
        y[r] = nan;
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

// The updates (see the header): row i's new value from its sum. `load`
// fetches the row's own operands before the walk, so that their loads are
// in flight with the walk's and not one more round trip after it; `apply`
// forms the new value from them and the sum.
struct PlainUpdate {
  struct Row {};
  __device__ __forceinline__ Row load(int, const float*) const { return {}; }
  __device__ __forceinline__ float apply(const Row&, float acc) const {
    return acc;
  }
};

struct JacobiUpdate {
  const float* b;
  const float* d;
  float omega;
  struct Row {
    float x, b, d;
  };
  __device__ __forceinline__ Row load(int i, const float* x) const {
    return {__ldg(x + i), __ldg(b + i), __ldg(d + i)};
  }
  __device__ __forceinline__ float apply(const Row& r, float acc) const {
    const float w = __fmul_rn(__frcp_rn(r.d), omega);
    return __fadd_rn(r.x, __fmul_rn(w, __fsub_rn(r.b, acc)));
  }
};

struct ResidualUpdate {
  const float* b;
  struct Row {
    float b;
  };
  __device__ __forceinline__ Row load(int i, const float*) const {
    return {__ldg(b + i)};
  }
  __device__ __forceinline__ float apply(const Row& r, float acc) const {
    return __fsub_rn(r.b, acc);
  }
};

// Warp-per-tile shape: one warp per tile, lane = row, U applied to each
// row's sum. REPAIR: the layout has a `state` (the host picks the
// instantiation, so a layout that needs no repair runs no epilogue).
template <typename D, bool REPAIR, typename U>
__device__ __forceinline__ void tiles_body(const Layout<D>& L, int n_tiles,
                                           const float* __restrict__ x,
                                           const U& u,
                                           float* __restrict__ out) {
  const int lane = threadIdx.x & (kTile - 1);
  const int tile = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int i = tile * kTile + lane;
  if (tile < n_tiles) {  // whole warps
    typename U::Row row{};
    if (i < L.n) row = u.load(i, x);
    const float acc = walk<D>(L.seg_off, L.seg_vals, __ldg(L.seg_ptr + tile),
                              __ldg(L.seg_ptr + tile + 1), i, L.n, x, lane);
    if (i < L.n) out[i] = u.apply(row, acc);
  }
  if (REPAIR) finish<D>(i < L.n && !isfinite(__ldg(x + i)), L, x, out);
}

// Split shape: a block of 8 warps per tile, each walking one run of its
// segments; warp 0 adds the partial sums in warp order and applies U.
template <typename D, bool REPAIR, typename U>
__device__ __forceinline__ void split_body(const Layout<D>& L,
                                           const float* __restrict__ x,
                                           const U& u,
                                           float* __restrict__ out) {
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
  typename U::Row row{};
  if (warp == 0 && i < L.n) row = u.load(i, x);
  part[warp][lane] = walk<D>(L.seg_off, L.seg_vals, s0, s1, i, L.n, x, lane);
  __syncthreads();
  if (warp == 0) {
    float acc = part[0][lane];
#pragma unroll
    for (int w = 1; w < kSplitWarps; ++w) acc += part[w][lane];
    if (i < L.n) out[i] = u.apply(row, acc);
  }
  if (REPAIR)
    finish<D>(warp == 0 && i < L.n && !isfinite(__ldg(x + i)), L, x, out);
}

// One name per form and shape, so that a trace tells them apart; each
// holds "dia_tiles", which the benchmark's K1 readers match.
template <typename D, bool REPAIR>
__global__ void __launch_bounds__(kWarps * kTile)
dia_tiles_kernel(Layout<D> L, int n_tiles, const float* __restrict__ x,
                 float* __restrict__ y) {
  tiles_body<D, REPAIR>(L, n_tiles, x, PlainUpdate{}, y);
}

template <typename D, bool REPAIR>
__global__ void __launch_bounds__(kSplitWarps * kTile)
dia_tiles_split_kernel(Layout<D> L, const float* __restrict__ x,
                       float* __restrict__ y) {
  split_body<D, REPAIR>(L, x, PlainUpdate{}, y);
}

template <typename D, bool REPAIR>
__global__ void __launch_bounds__(kWarps * kTile)
dia_tiles_jacobi_kernel(Layout<D> L, int n_tiles, const float* __restrict__ x,
                        JacobiUpdate u, float* __restrict__ out) {
  tiles_body<D, REPAIR>(L, n_tiles, x, u, out);
}

template <typename D, bool REPAIR>
__global__ void __launch_bounds__(kSplitWarps * kTile)
dia_tiles_split_jacobi_kernel(Layout<D> L, const float* __restrict__ x,
                              JacobiUpdate u, float* __restrict__ out) {
  split_body<D, REPAIR>(L, x, u, out);
}

template <typename D, bool REPAIR>
__global__ void __launch_bounds__(kWarps * kTile)
dia_tiles_residual_kernel(Layout<D> L, int n_tiles,
                          const float* __restrict__ x, ResidualUpdate u,
                          float* __restrict__ out) {
  tiles_body<D, REPAIR>(L, n_tiles, x, u, out);
}

template <typename D, bool REPAIR>
__global__ void __launch_bounds__(kSplitWarps * kTile)
dia_tiles_split_residual_kernel(Layout<D> L, const float* __restrict__ x,
                                ResidualUpdate u, float* __restrict__ out) {
  split_body<D, REPAIR>(L, x, u, out);
}

// Each update's two kernels, for the launcher.
template <typename D, bool R>
auto tiles_kernel(PlainUpdate) { return dia_tiles_kernel<D, R>; }
template <typename D, bool R>
auto split_kernel(PlainUpdate) { return dia_tiles_split_kernel<D, R>; }
template <typename D, bool R>
auto tiles_kernel(JacobiUpdate) { return dia_tiles_jacobi_kernel<D, R>; }
template <typename D, bool R>
auto split_kernel(JacobiUpdate) { return dia_tiles_split_jacobi_kernel<D, R>; }
template <typename D, bool R>
auto tiles_kernel(ResidualUpdate) { return dia_tiles_residual_kernel<D, R>; }
template <typename D, bool R>
auto split_kernel(ResidualUpdate) {
  return dia_tiles_split_residual_kernel<D, R>;
}

// The one launcher. The operands pick the form (no b: plain; b without d:
// residual; both: Jacobi), the layout's shape (`split`) and repair (a
// `state`) the form's kernel.
template <typename D>
int launch(const void* seg_ptr, const void* seg_off, const void* seg_vals,
           int n, int split, const void* offsets, int K, void* state,
           const void* x, const void* b, const void* d, float omega,
           void* out, void* stream) {
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
  const float* bf = (const float*)b;
  float* of = (float*)out;
  auto run = [&](auto u) {
    auto go = [&](auto kernel, auto... shape) {
      if constexpr (std::is_same<decltype(u), PlainUpdate>::value)
        kernel<<<blocks, threads, 0, s>>>(L, shape..., xf, of);  // no u
      else
        kernel<<<blocks, threads, 0, s>>>(L, shape..., xf, u, of);
    };
    if (split && state)
      go(split_kernel<D, true>(u));
    else if (split)
      go(split_kernel<D, false>(u));
    else if (state)
      go(tiles_kernel<D, true>(u), n_tiles);
    else
      go(tiles_kernel<D, false>(u), n_tiles);
  };
  if (!b)
    run(PlainUpdate{});
  else if (!d)
    run(ResidualUpdate{bf});
  else
    run(JacobiUpdate{bf, (const float*)d, omega});
  return (int)cudaGetLastError();
}

// The Chebyshev form: the whole degree-deg recurrence of
// models/chebyshev.py::chebyshev in one launch, on an operator small enough
// for one block (a multigrid hierarchy's coarsest level):
//   r = b - A x ; p = r ; x += alpha_1 p
//   k = 2 .. deg: z = A p ; r -= alpha_{k-1} z ; p = r + beta_k p ;
//                 x += alpha_k p
// In the eager chain each of those steps is a PyTorch kernel beside the
// deg K1 launches: 4 + 7 (deg - 1) launches (53 at degree 8) for a few
// hundred flops, so on the coarsest level the time is all launch latency
// and the gaps between them. Here the deg applies depend on each other
// inside one block, with barriers between them, and what bounds the
// launch is the latency of each apply. So each apply is the split
// form's, tile by tile in the same block: 8 warps a tile, each walking
// one contiguous run of the tile's segments in segment order, the runs'
// sums added in run order by the tile's warp 0. That is the sum K1 takes
// at these sizes, so every apply gives K1's bits; and the layout, read
// through L1 from the first apply on, is walked 8 runs at once. The
// applied vector (x, then each p) sits in shared memory, since a row reads
// its neighbours'; b, r, p and x of a row stay in the registers of the
// tile's warp 0. The host computes alpha and beta in double, in the
// chain's order, and each travels in the launch's arguments as the f32
// that PyTorch's f32 product rounds it to, so a captured graph holds
// them. Each step rounds as the chain does (the scalar product, then the
// sum or difference; the _rn intrinsics keep them apart), so the form
// gives the chain's x bit for bit. A layout that needs the non-finite
// repair (see the header) applies its rule row by row after each apply,
// when one entry of the applied vector is not finite.
constexpr int kChebTiles = 4;  // x 8 warps x 32 lanes: one block's 1,024
constexpr int kChebRows = kChebTiles * kTile;
constexpr int kChebMaxDeg = 32;  // the schedule's room

struct ChebSchedule {
  float alpha[kChebMaxDeg];  // alpha_1 .. alpha_deg
  float beta[kChebMaxDeg];   // beta_2 .. beta_deg, at 0 .. deg - 2
  int deg;
};

// One block of 8 warps for each of the layout's ceil(n / 32) <= 4 tiles.
// REPAIR: the layout skips a segment that a row reaches.
template <bool REPAIR>
__global__ void __launch_bounds__(kChebTiles * kSplitWarps * kTile)
dia_tiles_chebyshev_kernel(Layout<float> L, const float* __restrict__ b,
                           const float* __restrict__ x0, ChebSchedule s,
                           float* __restrict__ out) {
  __shared__ float v[kChebRows];  // the applied vector
  __shared__ float part[kChebTiles][kSplitWarps][kTile];
  const int lane = threadIdx.x & (kTile - 1);
  const int warp = (threadIdx.x >> 5) & (kSplitWarps - 1);
  const int tile = threadIdx.x / (kSplitWarps * kTile);
  const int i = tile * kTile + lane;
  const bool owner = warp == 0 && i < L.n;  // keeps row i's vectors
  const int start = __ldg(L.seg_ptr + tile);
  const int end = __ldg(L.seg_ptr + tile + 1);
  const int run = (end - start + kSplitWarps - 1) / kSplitWarps;
  const int s0 = min(end, start + warp * run);
  const int s1 = min(end, s0 + run);
  float bi = 0.0f, x = 0.0f;
  if (owner) {
    bi = __ldg(b + i);
    x = __ldg(x0 + i);
    v[i] = x;
  }
  __syncthreads();
  // (A v)_i for the owner, NaN where the non-finite rule names row i
  auto apply = [&]() {
    part[tile][warp][lane] =
        walk<float, true>(L.seg_off, L.seg_vals, s0, s1, i, L.n, v, lane);
    bool bad = false;
    if constexpr (REPAIR)
      bad = __syncthreads_or(owner && !isfinite(v[i]));
    else
      __syncthreads();
    float acc = 0.0f;
    if (owner) {
      acc = part[tile][0][lane];
#pragma unroll
      for (int w = 1; w < kSplitWarps; ++w) acc += part[tile][w][lane];
      for (int k = 0; bad && k < L.K; ++k) {
        const int off = __ldg(L.offsets + k);
        const int64_t c = (int64_t)i + off;
        if (c >= 0 && c < L.n && !isfinite(v[c]) &&
            !holds(L.seg_off, start, end, off))
          acc = __int_as_float(0x7fffffff);
      }
    }
    return acc;
  };
  float r = __fsub_rn(bi, apply());
  float p = r;
  x = __fadd_rn(x, __fmul_rn(s.alpha[0], p));
  for (int k = 1; k < s.deg; ++k) {
    __syncthreads();  // every warp has read v and every owner its parts
    if (owner) v[i] = p;
    __syncthreads();
    const float z = apply();
    r = __fsub_rn(r, __fmul_rn(s.alpha[k - 1], z));
    p = __fadd_rn(r, __fmul_rn(s.beta[k - 1], p));
    x = __fadd_rn(x, __fmul_rn(s.alpha[k], p));
  }
  if (owner) out[i] = x;
}

}  // namespace

// seg_ptr [n_tiles+1] int32, seg_off [n_segs] int32, seg_vals [n_segs, 32]
// (f32 or bf16), offsets [K] int32 (the operator's sorted dense offsets),
// state [2] int32 (zero before the first launch; each launch leaves it
// zero) or null for a layout that skips no segment in range (no repair),
// x [n] f32, all on the current device, with n_tiles = ceil(n / 32);
// `split` != 0 takes the split form. b [n] f32 or null, d [n] f32 (the
// smoother's diagonal) or null, and omega pick the form: null b, out = A x;
// b and null d, out = b - A x; both, out = x + rn(rcp(d) omega) (b - A x).
// out [n] f32 is neither x nor b; `stream` is a cudaStream_t. Each returns
// cudaGetLastError().
extern "C" int dia_spmv_f32(const void* seg_ptr, const void* seg_off,
                            const void* seg_vals, int n, int split,
                            const void* offsets, int K, void* state,
                            const void* x, const void* b, const void* d,
                            float omega, void* out, void* stream) {
  return launch<float>(seg_ptr, seg_off, seg_vals, n, split, offsets, K,
                       state, x, b, d, omega, out, stream);
}

extern "C" int dia_spmv_bf16(const void* seg_ptr, const void* seg_off,
                             const void* seg_vals, int n, int split,
                             const void* offsets, int K, void* state,
                             const void* x, const void* b, const void* d,
                             float omega, void* out, void* stream) {
  return launch<__nv_bfloat16>(seg_ptr, seg_off, seg_vals, n, split,
                               offsets, K, state, x, b, d, omega, out,
                               stream);
}

// The Chebyshev form on an f32 layout of n <= 128 rows (split shape):
// seg_ptr, seg_off, seg_vals and offsets [K] as above, `repair` != 0
// where the layout needs the non-finite rule; b [n] and x [n] f32 on the
// device; alpha [deg] and beta [deg - 1] f32 on the host (copied into the
// launch's arguments), 1 <= deg <= 32; out [n] f32, neither b nor x.
// Refuses (cudaErrorInvalidValue) a shape past the block; returns
// cudaGetLastError().
extern "C" int dia_chebyshev_f32(const void* seg_ptr, const void* seg_off,
                                 const void* seg_vals, int n,
                                 const void* offsets, int K, int repair,
                                 const void* b, const void* x,
                                 const float* alpha, const float* beta,
                                 int deg, void* out, void* stream) {
  if (n < 1 || n > kChebRows || K < 1 || deg < 1 || deg > kChebMaxDeg)
    return (int)cudaErrorInvalidValue;
  ChebSchedule s{};
  for (int k = 0; k < deg; ++k) s.alpha[k] = alpha[k];
  for (int k = 0; k + 1 < deg; ++k) s.beta[k] = beta[k];
  s.deg = deg;
  const Layout<float> L{(const int*)seg_ptr, (const int*)seg_off,
                        (const float*)seg_vals, (const int*)offsets,
                        nullptr, n, K};
  const int threads = ((n - 1) / kTile + 1) * kSplitWarps * kTile;
  auto kernel = repair ? dia_tiles_chebyshev_kernel<true>
                       : dia_tiles_chebyshev_kernel<false>;
  kernel<<<1, threads, 0, (cudaStream_t)stream>>>(
      L, (const float*)b, (const float*)x, s, (float*)out);
  return (int)cudaGetLastError();
}
