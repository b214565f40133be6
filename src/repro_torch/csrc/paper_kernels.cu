// Hand-written SpTTN kernels of the paper (sm_90a): the fixtures the
// stage code generator grew out of, kept as a second entry point of the
// same pipeline (repro_torch/kernels/ops.py).
//
//   mttkrp  K5  src/repro/kernels/mttkrp.py  mttkrp_pallas
//   ttmc    K6  src/repro/kernels/ttmc.py    ttmc_pallas
//   tttp    K7  src/repro/kernels/tttp.py    tttp_pallas
//
// The factor rows are gathered by PyTorch outside the kernels (as XLA
// gathers them in the JAX package), so every kernel reads row-major
// (rows, width) operands in the padded per-segment layout of
// kernels/util.py: segment s owns the contiguous blocks
// [block_ptr[s], block_ptr[s+1]), ``block`` rows each.
//
// What bounds them on the H100: bytes.  K5 and K7 do two or three
// multiply-adds per element read; K6 does R*S per fiber against R+S
// elements read (16 for R = S = 16: still far below the card's ~20
// operations per byte in float32).  So each kernel reads every operand
// element once, with neighbouring threads on neighbouring elements, and
// writes each output element once.  No atomics: every sum is taken in a
// fixed order, so results are the same on every run.
//
// K5 runs over work items rather than segments.  The patterns it meets
// are skewed (at nell-2's shape one mode-0 slice of 714 holds about 1.1 M
// of the 16 M nonzeros), and one thread block per segment left one SM
// streaming that slice alone while the others idled.  So each segment's
// block range is cut, from the layout alone (ir.chain_items with a fixed
// cap, kernels/paper.py), into items of at most a fixed number of
// consecutive blocks; one thread block sums one item into a partial row,
// and the segment combine (stage_kernels.cu) adds each segment's partial
// rows in ascending item order.  K6 runs over work items too, cut at K1's
// cap, and walks them with K1's outer product (item_walk.cuh).
//
// Every entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "item_walk.cuh"

namespace spttn {

// K5, the order-3 MTTKRP leaf, over work items: partials[i, r] = sum over
// the rows n of item i (blocks [item_block[i], item_block[i+1])) of
// (vals[n] * mask[n]) * bg[n, r] * cg[n, r].  Bound by bytes: it reads
// 2 R + 2 elements a row for 3 R operations.  One 256-thread block per
// (item, column tile).  threadIdx.x takes a vector of V columns (16 bytes:
// float4, double2; V = 1 where R is not a multiple of the vector or a base
// is not 16-byte aligned), threadIdx.y one of the block's row lanes: lane
// y takes rows y, y + lanes, ... of the item in ascending order, and keeps
// kMttkrpRows rows' loads of bg, cg, vals and mask in flight before it
// adds them (32 KB a block at R = 64 in float32).  A fixed shared-memory
// tree then adds the lanes, and the block writes the item's partial row.
constexpr int kMttkrpThreads = 256;
constexpr int kMttkrpRows = 4;

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T x[V];
};

template <typename T, int V>
__global__ void __launch_bounds__(kMttkrpThreads)
    mttkrp_kernel(const T* __restrict__ vals, const T* __restrict__ bg,
                  const T* __restrict__ cg, const float* __restrict__ mask,
                  const long long* __restrict__ item_block, int block, int R,
                  T* __restrict__ partials) {
  using P = Pack<T, V>;
  __shared__ P red[kMttkrpThreads];
  const int nvec = R / V;
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  const long long item = blockIdx.x;
  const long long n1 = item_block[item + 1] * block;
  const int lanes = blockDim.y;
  P acc;
#pragma unroll
  for (int i = 0; i < V; ++i) acc.x[i] = T(0);
  if (c < nvec) {
    const P* b = reinterpret_cast<const P*>(bg) + c;
    const P* d = reinterpret_cast<const P*>(cg) + c;
    for (long long n = item_block[item] * block + threadIdx.y; n < n1;
         n += (long long)lanes * kMttkrpRows) {
      P bv[kMttkrpRows], cv[kMttkrpRows];
      T w[kMttkrpRows];
#pragma unroll
      for (int k = 0; k < kMttkrpRows; ++k) {
        const long long m = n + (long long)k * lanes;
        if (m < n1) {
          bv[k] = b[m * nvec];
          cv[k] = d[m * nvec];
          w[k] = vals[m] * T(mask[m]);
        }
      }
#pragma unroll
      for (int k = 0; k < kMttkrpRows; ++k) {
        if (n + (long long)k * lanes < n1) {
#pragma unroll
          for (int i = 0; i < V; ++i)
            acc.x[i] += w[k] * bv[k].x[i] * cv[k].x[i];
        }
      }
    }
  }
  const int me = threadIdx.y * blockDim.x + threadIdx.x;
  red[me] = acc;
  __syncthreads();
  for (int h = lanes / 2; h > 0; h >>= 1) {
    if (threadIdx.y < h) {
      const P o = red[me + h * blockDim.x];
#pragma unroll
      for (int i = 0; i < V; ++i) acc.x[i] += o.x[i];
      red[me] = acc;
    }
    __syncthreads();
  }
  if (threadIdx.y == 0 && c < nvec)
    reinterpret_cast<P*>(partials + item * R)[c] = acc;
}

// K5's launch: threadIdx.x over the row's vectors (the smallest power of
// two covering them, at most 256), the rest of the 256 threads row lanes.
template <typename T, int V>
int mttkrp_launch(const void* vals, const void* bg, const void* cg,
                  const void* mask, const void* item_block, long long nitems,
                  int block, int R, void* partials, cudaStream_t stream) {
  const int nvec = R / V;
  int tx = 1;
  while (tx < nvec && tx < kMttkrpThreads) tx *= 2;
  const dim3 threads(tx, kMttkrpThreads / tx);
  const dim3 grid((unsigned)nitems, (nvec + tx - 1) / tx);
  mttkrp_kernel<T, V><<<grid, threads, 0, stream>>>(
      (const T*)vals, (const T*)bg, (const T*)cg, (const float*)mask,
      (const long long*)item_block, block, R, (T*)partials);
  return (int)cudaGetLastError();
}

template <typename T>
int mttkrp_entry(const void* vals, const void* bg, const void* cg,
                 const void* mask, const void* item_block, long long nitems,
                 int block, int R, void* partials, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = R % V == 0 &&
                   ((uintptr_t)bg | (uintptr_t)cg | (uintptr_t)partials) %
                           16 == 0;
  return vec ? mttkrp_launch<T, V>(vals, bg, cg, mask, item_block, nitems,
                                   block, R, partials, stream)
             : mttkrp_launch<T, 1>(vals, bg, cg, mask, item_block, nitems,
                                   block, R, partials, stream);
}

// K6 over work items: partials[i, r * S + t] = sum over the rows n of
// item i (blocks [item_block[i], item_block[i+1]), in the padded layout
// whose pad rows are zero) of ug[n, r] * xf[n, t]; the segment combine
// then adds each segment's partial rows in ascending item order, giving
// out[s, r, t] = sum over the fibers of segment s of ug^T xf.  It is K1's
// outer product (Zd,Ze->de) with no mask, cut at K1's cap
// (ir.REDUCE_ITEM_ROWS rows an item) and walked by the same code
// (item_walk.cuh), so one thread block no longer walks a heavy segment
// alone.  One 256-thread block per (item, column tile); paths:
//   kTtmcOuter   R and S multiples of kOuterBlock, ug, xf and partials on
//                16-byte boundaries: a thread keeps a 4 x 4 register block
//                of (r, t) sums (reduce_outer);
//   kTtmcScalar  anything else: a thread sums one output (r, t), with the
//                same row lanes, kReduceRows rows' loads in flight and the
//                same lane tree.
// Column tiles go across blockIdx.y, so R * S may exceed one block's
// columns (R = S = 128: 1,024 register blocks in 4 tiles).
constexpr int kTtmcScalar = 0, kTtmcOuter = 1;

// kTtmcScalar: this thread's output o = r * S + t of the rows [n0, n1).
template <typename T>
__device__ __forceinline__ void ttmc_scalar(const T* __restrict__ ug,
                                            const T* __restrict__ xf,
                                            long long n0, long long n1,
                                            int R, int S,
                                            T* __restrict__ prow) {
  __shared__ T red[kReduceThreads];
  const int lanes = blockDim.y;
  const int o = blockIdx.y * blockDim.x + threadIdx.x;
  T acc[1] = {T(0)};
  if (o < R * S) {
    const int r = o / S, t = o - r * S;
    for (long long n = n0 + threadIdx.y; n < n1;
         n += (long long)lanes * kReduceRows) {
      T u[kReduceRows], x[kReduceRows];
#pragma unroll
      for (int k = 0; k < kReduceRows; ++k) {
        const long long m = n + (long long)k * lanes;
        if (m < n1) {
          u[k] = ug[m * R + r];
          x[k] = xf[m * S + t];
        }
      }
#pragma unroll
      for (int k = 0; k < kReduceRows; ++k)
        if (n + (long long)k * lanes < n1) acc[0] += u[k] * x[k];
    }
  }
  add_lanes(acc, red);
  if (threadIdx.y == 0 && o < R * S) prow[o] = acc[0];
}

template <typename T, int PATH>
__global__ void __launch_bounds__(kReduceThreads)
    ttmc_kernel(const T* __restrict__ ug, const T* __restrict__ xf,
                const long long* __restrict__ item_block, int block, int R,
                int S, T* __restrict__ partials) {
  const long long item = blockIdx.x;
  const long long n0 = item_block[item] * block;
  const long long n1 = item_block[item + 1] * block;
  T* prow = partials + item * R * S;
  if constexpr (PATH == kTtmcOuter)
    reduce_outer<T, false>(ug, R, xf, S, nullptr, n0, n1, prow);
  else
    ttmc_scalar(ug, xf, n0, n1, R, S, prow);
}

// K6's launch: threadIdx.x over the path's columns (outputs or register
// blocks; the smallest power of two covering them, at most 256:
// paper.ttmc_columns), the rest of the 256 threads row lanes.  The
// register-block path on what it cannot read (R or S off kOuterBlock, a
// base off 16 bytes) is refused, not run.
template <typename T>
int ttmc_entry(const void* ug, const void* xf, const void* item_block,
               long long nitems, int block, int R, int S, int path,
               void* partials, cudaStream_t stream) {
  int cols = R * S;
  if (path == kTtmcOuter) {
    if (((uintptr_t)ug | (uintptr_t)xf | (uintptr_t)partials) % 16 ||
        R <= 0 || S <= 0 || R % kOuterBlock || S % kOuterBlock)
      return (int)cudaErrorInvalidValue;
    cols = R * S / (kOuterBlock * kOuterBlock);
  } else if (path != kTtmcScalar) {
    return (int)cudaErrorInvalidValue;
  }
  int tx = 1;
  while (tx < cols && tx < kReduceThreads) tx *= 2;
  const dim3 threads(tx, kReduceThreads / tx);
  const dim3 grid((unsigned)nitems, (cols + tx - 1) / tx);
  const auto go = [&](auto kernel) {
    kernel<<<grid, threads, 0, stream>>>(
        (const T*)ug, (const T*)xf, (const long long*)item_block, block, R,
        S, (T*)partials);
    return (int)cudaGetLastError();
  };
  if (path == kTtmcOuter) return go(ttmc_kernel<T, kTtmcOuter>);
  return go(ttmc_kernel<T, kTtmcScalar>);
}

// K7: out[n] = vals[n] * sum_r ug[n, r] * vg[n, r] * wg[n, r].  One thread
// block per ``block`` rows; each warp takes every 8th row of them, its
// lanes take neighbouring columns (coalesced), and a shuffle tree adds
// the lanes.  No state crosses rows.
template <typename T>
__global__ void tttp_kernel(const T* __restrict__ vals,
                            const T* __restrict__ ug,
                            const T* __restrict__ vg,
                            const T* __restrict__ wg, long long n,
                            int block, int R, T* __restrict__ out) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;
  const long long n0 = (long long)blockIdx.x * block;
  const long long n1 = n0 + block < n ? n0 + block : n;
  for (long long row = n0 + warp; row < n1; row += nwarps) {
    T acc = T(0);
    for (int r = lane; r < R; r += 32)
      acc += ug[row * R + r] * vg[row * R + r] * wg[row * R + r];
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0) out[row] = vals[row] * acc;
  }
}

}  // namespace spttn

// --------------------------------------------------------------------------
// C entry points (bound with ctypes).
// --------------------------------------------------------------------------
#define SPTTN_PAPER_ENTRY_POINTS(T, SUFFIX)                                    \
  extern "C" int spttn_mttkrp_##SUFFIX(                                        \
      const void* vals, const void* bg, const void* cg, const void* mask,      \
      const void* item_block, long long nitems, int block, int R,              \
      void* partials, void* stream) {                                          \
    return spttn::mttkrp_entry<T>(vals, bg, cg, mask, item_block, nitems,      \
                                  block, R, partials, (cudaStream_t)stream);   \
  }                                                                            \
  extern "C" int spttn_ttmc_##SUFFIX(                                          \
      const void* ug, const void* xf, const void* item_block,                  \
      long long nitems, int block, int R, int S, int path, void* partials,     \
      void* stream) {                                                          \
    return spttn::ttmc_entry<T>(ug, xf, item_block, nitems, block, R, S,       \
                                path, partials, (cudaStream_t)stream);         \
  }                                                                            \
  extern "C" int spttn_tttp_##SUFFIX(                                          \
      const void* vals, const void* ug, const void* vg, const void* wg,        \
      long long n, int block, int R, void* out, void* stream) {                \
    const unsigned nblocks = (unsigned)((n + block - 1) / block);              \
    spttn::tttp_kernel<T><<<nblocks, 256, 0, (cudaStream_t)stream>>>(          \
        (const T*)vals, (const T*)ug, (const T*)vg, (const T*)wg, n, block, R, \
        (T*)out);                                                              \
    return (int)cudaGetLastError();                                            \
  }

SPTTN_PAPER_ENTRY_POINTS(float, f32)
SPTTN_PAPER_ENTRY_POINTS(double, f64)
