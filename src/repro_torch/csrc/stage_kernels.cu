// Hopper stage kernels of the SpTTN code generator (sm_90a).
//
// Every stage the plan executor emits is a two-operand einsum over one
// fiber axis Z and a few small dense axes (repro_torch/kernels/codegen/
// ir.py).  The host enumerates the stage's dense index space once and
// hands the kernels an index table in CSR form:
//
//   out_ptr[o] .. out_ptr[o+1]   the terms of output column o
//   a_idx[t], b_idx[t]           the column each term reads in A and B
//
// so one output column of one fiber is  sum_t A[z, a_idx[t]] * B[z, b_idx[t]].
// A broadcast operand (no fiber axis) has row stride 0.  That one table
// covers every stage family the paper kernels emit: scale (Z,Zd->Zd),
// row dot (Zd,Zd->Z) and per-fiber outer product (Zd,Ze->de).
//
// Kernels (each replaces one Pallas TPU kernel of the JAX package):
//
//   reduce    K1  src/repro/kernels/codegen/stages.py  run_reduce_stage
//   product   K2  src/repro/kernels/codegen/stages.py  run_product_stage
//   splitk    K4  src/repro/kernels/codegen/lower_gpu.py  splitk_partials
//   combine   K4  src/repro/kernels/codegen/lower_gpu.py  segment_combine
//
// What bounds them on the H100: bytes.  A stage does O(1) multiply-adds
// per operand element it reads — a few operations per byte, far below
// the ratio of float32 rate to memory rate in NVIDIA's H100 SXM data
// sheet (67 TFLOP/s over 3.35 TB/s, about 20) — so the design goal is
// to read each operand element once, with
// neighbouring threads on neighbouring columns so that the reads of one
// fiber row coalesce, and to write each output element once.  There are
// no atomics: every reduction is owned by one thread block and runs in a
// fixed order, so results are deterministic run to run.
//
// Every entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() so that a refused launch is reported.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// One output column of one fiber: sum over the column's terms.  The
// accumulator has the operand type: float32 stages accumulate in float32
// and float64 stages in float64, as accumulator_type() prescribes.
template <typename T>
__device__ __forceinline__ T fiber_column(const T* __restrict__ a_row,
                                          const T* __restrict__ b_row,
                                          const int* __restrict__ a_idx,
                                          const int* __restrict__ b_idx,
                                          int t0, int t1) {
  T s = T(0);
  for (int t = t0; t < t1; ++t) s += a_row[a_idx[t]] * b_row[b_idx[t]];
  return s;
}

// The partial of fiber block ``blk`` (``block`` fibers starting at
// blk*block) for this thread's column o.  Threads of one column split the
// block's fibers by threadIdx.y, then a fixed shared-memory tree adds
// them; the result is returned to every thread of the column.  The mask
// zeroes pad slots (they gather a real fiber's values).  blockDim.y must
// be a power of two.
template <typename T>
__device__ T block_partial(const T* __restrict__ a, long long a_rs,
                           const T* __restrict__ b, long long b_rs,
                           const float* __restrict__ mask, long long blk,
                           int block, const int* __restrict__ out_ptr,
                           const int* __restrict__ a_idx,
                           const int* __restrict__ b_idx, int o, int out_w,
                           T* red) {
  T s = T(0);
  if (o < out_w) {
    const int t0 = out_ptr[o], t1 = out_ptr[o + 1];
    for (int j = threadIdx.y; j < block; j += blockDim.y) {
      const long long z = blk * block + j;
      s += T(mask[z]) * fiber_column(a + z * a_rs, b + z * b_rs, a_idx,
                                     b_idx, t0, t1);
    }
  }
  const int me = threadIdx.y * blockDim.x + threadIdx.x;
  red[me] = s;
  __syncthreads();
  for (int h = blockDim.y / 2; h > 0; h >>= 1) {
    if (threadIdx.y < h) red[me] += red[me + h * blockDim.x];
    __syncthreads();
  }
  const T r = red[threadIdx.x];
  __syncthreads();  // red is reused by the next call
  return r;
}

// K1: one thread block per (output segment, column tile).  It walks the
// segment's contiguous block range [block_ptr[s], block_ptr[s+1]) in
// ascending order and adds each block's partial to the row, the order in
// which the TPU's sequential grid adds them; the row is written once.
template <typename T>
__global__ void reduce_kernel(const T* __restrict__ a, long long a_rs,
                              const T* __restrict__ b, long long b_rs,
                              const float* __restrict__ mask,
                              const long long* __restrict__ block_ptr,
                              int block, const int* __restrict__ out_ptr,
                              const int* __restrict__ a_idx,
                              const int* __restrict__ b_idx, int out_w,
                              T* __restrict__ out) {
  extern __shared__ unsigned char smem[];
  T* red = reinterpret_cast<T*>(smem);
  const long long s = blockIdx.x;
  const int o = blockIdx.y * blockDim.x + threadIdx.x;
  T acc = T(0);
  for (long long blk = block_ptr[s]; blk < block_ptr[s + 1]; ++blk)
    acc += block_partial(a, a_rs, b, b_rs, mask, blk, block, out_ptr, a_idx,
                         b_idx, o, out_w, red);
  if (threadIdx.y == 0 && o < out_w) out[s * out_w + o] = acc;
}

// K4 partials: one thread block per (fiber block, column tile), writing
// that block's partial to its own row.  No two blocks share an output.
template <typename T>
__global__ void splitk_kernel(const T* __restrict__ a, long long a_rs,
                              const T* __restrict__ b, long long b_rs,
                              const float* __restrict__ mask, int block,
                              const int* __restrict__ out_ptr,
                              const int* __restrict__ a_idx,
                              const int* __restrict__ b_idx, int out_w,
                              T* __restrict__ partials) {
  extern __shared__ unsigned char smem[];
  T* red = reinterpret_cast<T*>(smem);
  const long long blk = blockIdx.x;
  const int o = blockIdx.y * blockDim.x + threadIdx.x;
  const T p = block_partial(a, a_rs, b, b_rs, mask, blk, block, out_ptr,
                            a_idx, b_idx, o, out_w, red);
  if (threadIdx.y == 0 && o < out_w) partials[blk * out_w + o] = p;
}

// K2: per-fiber product, one thread per (fiber, output column); blocks
// of fibers map 1:1 to blocks of output rows.
template <typename T>
__global__ void product_kernel(const T* __restrict__ a, long long a_rs,
                               const T* __restrict__ b, long long b_rs,
                               long long nrows,
                               const int* __restrict__ out_ptr,
                               const int* __restrict__ a_idx,
                               const int* __restrict__ b_idx, int out_w,
                               T* __restrict__ out) {
  const int o = blockIdx.y * blockDim.x + threadIdx.x;
  const long long z = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  if (o >= out_w || z >= nrows) return;
  out[z * out_w + o] = fiber_column(a + z * a_rs, b + z * b_rs, a_idx, b_idx,
                                    out_ptr[o], out_ptr[o + 1]);
}

// Segment combine: out[s, :] = sum of rows [ptr[s], ptr[s+1]) in ascending
// order, one thread per (segment, column).  An empty segment is zero.
template <typename T>
__global__ void combine_kernel(const T* __restrict__ rows,
                               const long long* __restrict__ ptr,
                               long long nseg, int w, T* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nseg * w) return;
  const long long s = i / w;
  const int o = (int)(i - s * w);
  T acc = T(0);
  for (long long r = ptr[s]; r < ptr[s + 1]; ++r) acc += rows[r * w + o];
  out[i] = acc;
}

}  // namespace

// --------------------------------------------------------------------------
// C entry points (bound with ctypes).  Launch geometry comes from the
// caller: tx threads over output columns (a power of two), 256 / tx over
// fibers.
// --------------------------------------------------------------------------
#define SPTTN_ENTRY_POINTS(T, SUFFIX)                                          \
  extern "C" int spttn_reduce_##SUFFIX(                                        \
      const void* a, long long a_rs, const void* b, long long b_rs,            \
      const void* mask, const void* block_ptr, long long nseg, int block,      \
      const void* out_ptr, const void* a_idx, const void* b_idx, int out_w,    \
      int tx, void* out, void* stream) {                                       \
    const dim3 threads(tx, 256 / tx);                                          \
    const dim3 grid((unsigned)nseg, (out_w + tx - 1) / tx);                    \
    reduce_kernel<T><<<grid, threads, 256 * sizeof(T),                         \
                       (cudaStream_t)stream>>>(                                \
        (const T*)a, a_rs, (const T*)b, b_rs, (const float*)mask,              \
        (const long long*)block_ptr, block, (const int*)out_ptr,               \
        (const int*)a_idx, (const int*)b_idx, out_w, (T*)out);                 \
    return (int)cudaGetLastError();                                            \
  }                                                                            \
  extern "C" int spttn_splitk_##SUFFIX(                                        \
      const void* a, long long a_rs, const void* b, long long b_rs,            \
      const void* mask, long long nblocks, int block, const void* out_ptr,     \
      const void* a_idx, const void* b_idx, int out_w, int tx,                 \
      void* partials, void* stream) {                                          \
    const dim3 threads(tx, 256 / tx);                                          \
    const dim3 grid((unsigned)nblocks, (out_w + tx - 1) / tx);                 \
    splitk_kernel<T><<<grid, threads, 256 * sizeof(T),                         \
                       (cudaStream_t)stream>>>(                                \
        (const T*)a, a_rs, (const T*)b, b_rs, (const float*)mask, block,       \
        (const int*)out_ptr, (const int*)a_idx, (const int*)b_idx, out_w,      \
        (T*)partials);                                                         \
    return (int)cudaGetLastError();                                            \
  }                                                                            \
  extern "C" int spttn_product_##SUFFIX(                                       \
      const void* a, long long a_rs, const void* b, long long b_rs,            \
      long long nrows, const void* out_ptr, const void* a_idx,                 \
      const void* b_idx, int out_w, int tx, void* out, void* stream) {         \
    const dim3 threads(tx, 256 / tx);                                          \
    const dim3 grid((unsigned)((nrows + threads.y - 1) / threads.y),           \
                    (out_w + tx - 1) / tx);                                    \
    product_kernel<T><<<grid, threads, 0, (cudaStream_t)stream>>>(             \
        (const T*)a, a_rs, (const T*)b, b_rs, nrows, (const int*)out_ptr,      \
        (const int*)a_idx, (const int*)b_idx, out_w, (T*)out);                 \
    return (int)cudaGetLastError();                                            \
  }                                                                            \
  extern "C" int spttn_combine_##SUFFIX(const void* rows, const void* ptr,     \
                                        long long nseg, int w, void* out,      \
                                        void* stream) {                        \
    const long long n = nseg * w;                                              \
    combine_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0,                   \
                        (cudaStream_t)stream>>>(                               \
        (const T*)rows, (const long long*)ptr, nseg, w, (T*)out);              \
    return (int)cudaGetLastError();                                            \
  }

SPTTN_ENTRY_POINTS(float, f32)
SPTTN_ENTRY_POINTS(double, f64)
