// The walk of one work item's rows, shared by K1 (stage_kernels.cu,
// reduce_kernel) and K6 (paper_kernels.cu, ttmc_kernel).
//
// A work item is a run of at most a fixed number of consecutive blocks of
// one output segment (ir.chain_items, cut on the host from the layout
// alone); it covers the padded rows [n0, n1).  One 256-thread block sums
// an item's rows into the item's partial row, and the segment combine
// (stage_kernels.cu, combine_kernel) adds each segment's partial rows in
// ascending item order.  threadIdx.x takes an output column, a 16-byte
// column vector or a register block, threadIdx.y one of the block's row
// lanes: lane y takes rows y, y + lanes, ... of the item in ascending
// order and issues the loads of kReduceRows rows before it adds them.  A
// fixed shared-memory tree then adds the lanes (lane y + lane y + h, for
// h = lanes/2 .. 1; add_lanes).  No atomics: the same bits on every call.
//
// reduce_outer is the outer product of the walk, column d*E + e of the
// partial row the sum of A[n, d] * B[n, e]: a thread keeps a 4 x 4 block
// of (d, e) sums in registers, fed by 16-byte loads of its 4 columns of
// A and of B (two loads of shared L1 lines for 16 multiply-adds).  Its
// row weight is a template flag: K1 weighs row n by mask[n] (its pad
// rows gather a real fiber's values), K6 by 1 (its pad rows are zero).

#pragma once

#include <cuda_runtime.h>

namespace spttn {

constexpr int kReduceThreads = 256;
constexpr int kReduceRows = 4;
constexpr int kOuterBlock = 4;

template <typename T, int V>
struct alignas(sizeof(T) * V) ReduceVec {
  T x[V];
};

// Add the lanes of a 256-thread block: every thread holds W sums in acc
// (shared slot i * 256 + thread); afterwards lane 0 holds the block's.
template <typename T, int W>
__device__ __forceinline__ void add_lanes(T (&acc)[W], T* red) {
  const int me = threadIdx.y * blockDim.x + threadIdx.x;
#pragma unroll
  for (int i = 0; i < W; ++i) red[i * kReduceThreads + me] = acc[i];
  __syncthreads();
  for (int h = blockDim.y / 2; h > 0; h >>= 1) {
    if (threadIdx.y < h) {
#pragma unroll
      for (int i = 0; i < W; ++i) {
        acc[i] += red[i * kReduceThreads + me + h * blockDim.x];
        red[i * kReduceThreads + me] = acc[i];
      }
    }
    __syncthreads();
  }
}

// This thread's register block c of the rows [n0, n1): rows d0 .. d0 + 3
// of A's columns times columns e0 .. e0 + 3 of B's (D = a_rs, E = b_rs,
// both multiples of kOuterBlock; A, B and prow on 16-byte boundaries).
// Column tiles of the partial row go across blockIdx.y.  MASKED weighs
// row n by mask[n]; otherwise mask is not read.
template <typename T, bool MASKED>
__device__ __forceinline__ void reduce_outer(
    const T* __restrict__ a, long long a_rs, const T* __restrict__ b,
    long long b_rs, const float* __restrict__ mask, long long n0,
    long long n1, T* __restrict__ prow) {
  constexpr int V = 16 / sizeof(T), RB = kOuterBlock, NV = RB / V;
  using P = ReduceVec<T, V>;
  __shared__ T red[RB * RB * kReduceThreads];
  const int lanes = blockDim.y;
  const int E = (int)b_rs, nbe = E / RB, nblk = (int)(a_rs / RB) * nbe;
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  const int d0 = c / nbe * RB, e0 = c % nbe * RB;
  T acc[RB * RB];
#pragma unroll
  for (int i = 0; i < RB * RB; ++i) acc[i] = T(0);
  if (c < nblk) {
    const P* ap = reinterpret_cast<const P*>(a + d0);
    const P* bp = reinterpret_cast<const P*>(b + e0);
    const long long ars = a_rs / V, brs = b_rs / V;
    for (long long n = n0 + threadIdx.y; n < n1;
         n += (long long)lanes * kReduceRows) {
      P av[kReduceRows][NV], bv[kReduceRows][NV];
      [[maybe_unused]] T w[kReduceRows];
#pragma unroll
      for (int k = 0; k < kReduceRows; ++k) {
        const long long m = n + (long long)k * lanes;
        if (m < n1) {
#pragma unroll
          for (int v = 0; v < NV; ++v) {
            av[k][v] = ap[m * ars + v];
            bv[k][v] = bp[m * brs + v];
          }
          if constexpr (MASKED) w[k] = T(mask[m]);
        }
      }
#pragma unroll
      for (int k = 0; k < kReduceRows; ++k) {
        if (n + (long long)k * lanes < n1) {
#pragma unroll
          for (int i = 0; i < RB; ++i) {
            T x = av[k][i / V].x[i % V];
            if constexpr (MASKED) x = w[k] * x;
#pragma unroll
            for (int j = 0; j < RB; ++j)
              acc[i * RB + j] += x * bv[k][j / V].x[j % V];
          }
        }
      }
    }
  }
  add_lanes(acc, red);
  if (threadIdx.y == 0 && c < nblk) {
#pragma unroll
    for (int i = 0; i < RB; ++i)
#pragma unroll
      for (int j = 0; j < RB; ++j)
        prow[(long long)(d0 + i) * E + e0 + j] = acc[i * RB + j];
  }
}

}  // namespace spttn
