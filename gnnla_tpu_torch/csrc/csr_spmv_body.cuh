// K2's row-block kernel body, shared by K2 (csr_spmv.cu, all stages) and
// K9 (csr_ablate.cu, the stage ablation). See csr_spmv.cu for the design.
//
// The three stages a template flag can remove (each `if constexpr`, so
// the all-stages instantiation is K2's code and arithmetic unchanged):
//   kGather  — the x loads: a product v * x[c] becomes v + x[0] (the
//              column indices are still read);
//   kDeposit — the products' round trip through shared memory: without
//              it each row's thread reads its own nonzeros (the walk);
//   kScan    — each row's sum: without it a row keeps one product (its
//              first), or, with no deposit either, each thread writes the
//              sum of the terms it staged to the row of its own index.
// Warp blocks and long rows (see csr_spmv.cu) keep K2's sums in every
// instantiation; K9 takes no row of more than kLongRow nonzeros.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {


constexpr int kThreads = 256;   // rows per short-row block, at most
constexpr int kBudget = 2048;   // nonzeros staged at once (8 KB)
constexpr int kLongRow = 64;    // longer rows are summed by a warp each
constexpr int kWarpRow = 256;   // longer rows are summed by a whole block
constexpr int kWarps = kThreads / 32;  // rows per warp block, at most
constexpr int kWarpLoads = 8;   // nonzeros a lane loads at once
constexpr int kWarpChunk = 32 * kWarpLoads;  // products a warp stages
static_assert(kWarps * kWarpChunk <= kBudget, "warp stages share prod");

__device__ __forceinline__ float block_sum(float v) {
  __shared__ float s_warp[kThreads / 32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) s_warp[warp] = v;
  __syncthreads();
  v = 0.0f;
  if (warp == 0) {
    v = lane < kThreads / 32 ? s_warp[lane] : 0.0f;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;
}

// Row [rs, re) summed by one warp in CSR order, its products staged in
// `stage` (kWarpChunk floats of shared memory, 16-byte aligned, the
// warp's own). The lanes load kWarpChunk consecutive nonzeros at once
// (lane l the l-th of each 32: coalesced), gather x and round each product
// once (__fmul_rn) into the stage; then every lane reads the stage in
// order, four products a load, and adds them to the sum with __fadd_rn.
// Only the additions are serial, one after another with no load between.
// The stage's tail past the row holds +0.0f, and adding +0.0f leaves the
// sum bit for bit (a sum that starts at +0.0f is never -0.0f), so the sum
// is the sequential one. Every lane returns it.
__device__ __forceinline__ float warp_row_sum(const int* __restrict__ cols,
                                             const float* __restrict__ vals,
                                             const float* __restrict__ x,
                                             int rs, int re, float* stage) {
  const int lane = threadIdx.x & 31;
  const float4* stage4 = reinterpret_cast<const float4*>(stage);
  float acc = 0.0f;
  for (int q = rs; q < re; q += kWarpChunk) {
    int c[kWarpLoads];
    float v[kWarpLoads];
#pragma unroll
    for (int e = 0; e < kWarpLoads; ++e) {
      const int p = q + 32 * e + lane;
      c[e] = p < re ? __ldg(cols + p) : -1;  // no valid column is negative
      v[e] = p < re ? __ldg(vals + p) : 0.0f;
    }
    __syncwarp();  // the last chunk's reads are done
#pragma unroll
    for (int e = 0; e < kWarpLoads; ++e)
      stage[32 * e + lane] =
          c[e] >= 0 ? __fmul_rn(v[e], __ldg(x + c[e])) : 0.0f;
    __syncwarp();
    const int n4 = (min(re - q, kWarpChunk) + 3) >> 2;
#pragma unroll 8
    for (int k = 0; k < n4; ++k) {
      const float4 t = stage4[k];
      acc = __fadd_rn(acc, t.x);
      acc = __fadd_rn(acc, t.y);
      acc = __fadd_rn(acc, t.z);
      acc = __fadd_rn(acc, t.w);
    }
  }
  return acc;
}

template <bool kGather, bool kDeposit, bool kScan>
__global__ void __launch_bounds__(kThreads)
csr_spmv_blocks(const int* __restrict__ row_ptr, const int* __restrict__ cols,
                const float* __restrict__ vals,
                const int* __restrict__ row_blocks, int nnz,
                const float* __restrict__ x, float* __restrict__ y) {
  __shared__ __align__(16) float prod[kBudget];
  const int r0 = __ldg(row_blocks + blockIdx.x);
  const int r1 = __ldg(row_blocks + blockIdx.x + 1);
  const int p0 = __ldg(row_ptr + r0), p1 = __ldg(row_ptr + r1);

  if (r1 - r0 <= kWarps) {  // the block's form from its first row
    const int len0 = __ldg(row_ptr + r0 + 1) - p0;
    if (r1 - r0 == 1 && len0 > kWarpRow) {  // a long row: the whole block
      float acc = 0.0f;
      for (int p = p0 + threadIdx.x; p < p1; p += kThreads) {
        const float v = __ldg(vals + p);
        acc = __fadd_rn(acc, __fmul_rn(v, __ldg(x + __ldg(cols + p))));
      }
      acc = block_sum(acc);
      if (threadIdx.x == 0) y[r0] = acc;
      return;
    }
    if (len0 > kLongRow) {  // a warp block: warp w sums row r0 + w
      const int r = r0 + (threadIdx.x >> 5);
      if (r < r1) {
        const float acc = warp_row_sum(
            cols, vals, x, __ldg(row_ptr + r), __ldg(row_ptr + r + 1),
            prod + (threadIdx.x >> 5) * kWarpChunk);
        if ((threadIdx.x & 31) == 0) y[r] = acc;
      }
      return;
    }
  }

  const int r = r0 + threadIdx.x;  // this thread's row, if r < r1
  const int rs = r < r1 ? __ldg(row_ptr + r) : 0;
  const int re = r < r1 ? __ldg(row_ptr + r + 1) : 0;
  float acc = 0.0f;
  // without the gather a term is v + x[0]; the column is still read (no
  // valid column is negative, so the test never changes a term)
  [[maybe_unused]] const float x0 = kGather ? 0.0f : __ldg(x);
  if constexpr (!kDeposit && kScan) {  // the walk: a row's own nonzeros
    for (int p = rs; p < re; ++p) {
      const float v = __ldg(vals + p);
      const int c = __ldg(cols + p);
      float t;
      if constexpr (kGather) {
        t = __fmul_rn(v, __ldg(x + c));
      } else {
        t = __fadd_rn(v, c < 0 ? 0.0f : x0);
      }
      acc = __fadd_rn(acc, t);
    }
    if (r < r1) y[r] = acc;
    return;
  }

  // 16-byte loads where both arrays allow them (the port's own tensors do)
  const bool vec = (((uintptr_t)cols | (uintptr_t)vals) & 15) == 0;
  for (int q = p0; q < p1; q += kBudget) {  // one chunk for the port's blocks
    const int qe = min(q + kBudget, p1);
    // products of [q, qe) into prod[p - q], 4 aligned nonzeros a thread
    for (int g = (q >> 2) + threadIdx.x; 4 * g < qe; g += kThreads) {
      const int b = 4 * g;
      int c4[4];
      float v4[4];
      if (vec && b + 4 <= nnz) {
        const int4 c = __ldg(reinterpret_cast<const int4*>(cols) + g);
        const float4 v = __ldg(reinterpret_cast<const float4*>(vals) + g);
        c4[0] = c.x;
        c4[1] = c.y;
        c4[2] = c.z;
        c4[3] = c.w;
        v4[0] = v.x;
        v4[1] = v.y;
        v4[2] = v.z;
        v4[3] = v.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool in = b + e >= q && b + e < qe;
          c4[e] = in ? __ldg(cols + b + e) : 0;
          v4[e] = in ? __ldg(vals + b + e) : 0.0f;
        }
      }
      float t4[4];
      if constexpr (kGather) {
        float x4[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool in = b + e >= q && b + e < qe;
          x4[e] = in ? __ldg(x + c4[e]) : 0.0f;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) t4[e] = __fmul_rn(v4[e], x4[e]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          t4[e] = __fadd_rn(v4[e], c4[e] < 0 ? 0.0f : x0);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (b + e >= q && b + e < qe) {
          if constexpr (kDeposit) {
            prod[b + e - q] = t4[e];
          } else {  // no deposit, no scan: the thread's own terms
            acc = __fadd_rn(acc, t4[e]);
          }
        }
      }
    }
    if constexpr (kDeposit) {
      __syncthreads();
      if constexpr (kScan) {
        for (int p = max(rs, q); p < min(re, qe); ++p)
          acc = __fadd_rn(acc, prod[p - q]);
      } else {  // one product a row: its first
        if (rs < re && rs >= q && rs < qe) acc = prod[rs - q];
      }
      __syncthreads();
    }
  }
  if (r < r1) y[r] = acc;
}

}  // namespace
