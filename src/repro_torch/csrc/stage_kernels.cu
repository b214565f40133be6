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
//   chain     K3  src/repro/kernels/codegen/stages.py  run_fused_chain_stage
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

#include <type_traits>

namespace spttn {

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

// K2: per-fiber product, a persistent grid walking tiles of R
// consecutive fiber rows.  The fiber operands are contiguous (nrows,
// width) rows, so one tile of an operand is one contiguous chunk: the
// block copies it into shared memory with cp.async (16 bytes a copy when
// every fiber operand's base is 16-byte aligned, VEC; one element a copy
// otherwise), double-buffered so that tile k+1 is in flight while tile k
// is computed.  R is a multiple of 4, so every tile starts 16-byte
// aligned in every operand and in the output.  A broadcast operand
// (a_fiber / b_fiber 0: one row for every fiber) and, when they fit
// (SMEM_TABLES), the index tables are staged once per block.  Each
// output element of the tile is one thread's sum of its terms in table
// order, rounded after every multiply and every add (no fused
// multiply-add), so a float64 result equals the table-order sum bit for
// bit; the tile is written back from shared memory as one contiguous
// chunk with 16-byte stores.  When out_w divides the block, each thread
// keeps one output column for the whole walk: a column of one term
// (scale, outer product) keeps its two operand columns in registers, and
// terms that come in whole 16-byte chunks of both operands (CHUNKS, the
// row dot) are read a chunk per load.
//
// Shared layout (each region a multiple of 16 bytes): A's two tile
// buffers (one row when broadcast), B's, the R x out_w output tile, the
// tables.  Within a row whose width is a whole number of 16-byte chunks,
// chunk c of row r sits at c ^ (r & swz): a warp walking one column down
// 32 rows (the row dot) then spreads over eight chunk positions instead
// of one bank.
constexpr int kProductThreads = 256;

__device__ __forceinline__ float mul_rn(float x, float y) {
  return __fmul_rn(x, y);
}
__device__ __forceinline__ double mul_rn(double x, double y) {
  return __dmul_rn(x, y);
}
__device__ __forceinline__ float add_rn(float x, float y) {
  return __fadd_rn(x, y);
}
__device__ __forceinline__ double add_rn(double x, double y) {
  return __dadd_rn(x, y);
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                 "l"(src), "n"(BYTES)
                 : "memory");
}

// Index in a staged tile of element (r, col) of a row of width w: chunk
// c = col / V of row r sits at c ^ (r & swz), which is col ^ ((r & swz) V).
template <typename T>
__device__ __forceinline__ int tile_index(int r, int col, int w, int swz) {
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte chunk
  return r * w + (col ^ ((r & swz) * V));
}

// Queue the copy of n consecutive elements (whole rows of width w) from
// src into the tile dst.
template <typename T, bool VEC>
__device__ __forceinline__ void stage_tile(T* dst, const T* __restrict__ src,
                                           int n, int w, int swz) {
  constexpr int V = 16 / sizeof(T);
  int e0 = 0;
  if (VEC) {
    const int nq = n / V;
    for (int q = threadIdx.x; q < nq; q += blockDim.x) {
      const int e = q * V, r = e / w;
      cp_async<16>(dst + tile_index<T>(r, e - r * w, w, swz), src + e);
    }
    e0 = nq * V;  // a tail exists only when swz == 0
  }
  for (int e = e0 + threadIdx.x; e < n; e += blockDim.x) {
    const int r = e / w;
    cp_async<sizeof(T)>(dst + tile_index<T>(r, e - r * w, w, swz), src + e);
  }
}

// s + x . y over the components of one 16-byte chunk, in order.
__device__ __forceinline__ float chunk_dot(float s, float4 x, float4 y) {
  s = add_rn(s, mul_rn(x.x, y.x));
  s = add_rn(s, mul_rn(x.y, y.y));
  s = add_rn(s, mul_rn(x.z, y.z));
  return add_rn(s, mul_rn(x.w, y.w));
}
__device__ __forceinline__ double chunk_dot(double s, double2 x, double2 y) {
  s = add_rn(s, mul_rn(x.x, y.x));
  return add_rn(s, mul_rn(x.y, y.y));
}

// One output element of a staged tile: its terms t0 .. t1 in table order
// (rows ra, rb of the A and B tiles; 0 for a broadcast operand).  With
// CHUNKS the terms come in runs of one 16-byte chunk of both operands
// (stages.term_chunks), read with one 16-byte load each; otherwise the
// unrolled loop issues the loads of eight terms before their sums.
template <typename T, bool CHUNKS>
__device__ __forceinline__ T tile_term_sum(const T* ac, const T* bc, int ra,
                                           int rb, const int* AI,
                                           const int* BI, int t0, int t1,
                                           int wa, int a_swz, int wb,
                                           int b_swz) {
  T s = T(0);
  if constexpr (CHUNKS) {
    using Chunk = typename std::conditional<sizeof(T) == 4, float4,
                                            double2>::type;
    constexpr int V = 16 / sizeof(T);
#pragma unroll 4
    for (int t = t0; t < t1; t += V)
      s = chunk_dot(
          s,
          *reinterpret_cast<const Chunk*>(ac +
                                          tile_index<T>(ra, AI[t], wa, a_swz)),
          *reinterpret_cast<const Chunk*>(bc +
                                          tile_index<T>(rb, BI[t], wb, b_swz)));
  } else {
#pragma unroll 8
    for (int t = t0; t < t1; ++t)
      s = add_rn(s, mul_rn(ac[tile_index<T>(ra, AI[t], wa, a_swz)],
                           bc[tile_index<T>(rb, BI[t], wb, b_swz)]));
  }
  return s;
}

__host__ __device__ inline size_t round16(size_t n) {
  return (n + 15) / 16 * 16;
}

// Dynamic shared memory of product_kernel (the same sum as the wrapper's
// stages.product_tiling).
__host__ __device__ inline size_t product_smem(size_t isz, int a_fiber,
                                               int wa, int b_fiber, int wb,
                                               int R, int out_w, int nterms,
                                               bool smem_tables) {
  return round16((a_fiber ? 2 * (size_t)R : 1) * wa * isz) +
         round16((b_fiber ? 2 * (size_t)R : 1) * wb * isz) +
         round16((size_t)R * out_w * isz) +
         (smem_tables ? round16(4 * ((size_t)out_w + 1 + 2 * (size_t)nterms))
                      : 0);
}

template <typename T, bool VEC, bool SMEM_TABLES, bool CHUNKS>
__global__ void __launch_bounds__(kProductThreads)
    product_kernel(const T* __restrict__ a, int a_fiber, int wa, int a_swz,
                   const T* __restrict__ b, int b_fiber, int wb, int b_swz,
                   long long nrows, int R, const int* __restrict__ out_ptr,
                   const int* __restrict__ a_idx,
                   const int* __restrict__ b_idx, int out_w, int nterms,
                   T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int a_len = a_fiber ? R * wa : wa, b_len = b_fiber ? R * wb : wb;
  T* as = reinterpret_cast<T*>(smem);
  size_t off = round16((a_fiber ? 2 : 1) * (size_t)a_len * sizeof(T));
  T* bs = reinterpret_cast<T*>(smem + off);
  off += round16((b_fiber ? 2 : 1) * (size_t)b_len * sizeof(T));
  T* os = reinterpret_cast<T*>(smem + off);
  off += round16((size_t)R * out_w * sizeof(T));
  const int* P = out_ptr;
  const int* AI = a_idx;
  const int* BI = b_idx;
  if (SMEM_TABLES) {
    int* ts = reinterpret_cast<int*>(smem + off);
    for (int i = threadIdx.x; i <= out_w; i += blockDim.x) ts[i] = out_ptr[i];
    for (int i = threadIdx.x; i < nterms; i += blockDim.x) {
      ts[out_w + 1 + i] = a_idx[i];
      ts[out_w + 1 + nterms + i] = b_idx[i];
    }
    P = ts;
    AI = ts + out_w + 1;
    BI = AI + nterms;
  }
  if (!a_fiber)
    for (int i = threadIdx.x; i < wa; i += blockDim.x) as[i] = a[i];
  if (!b_fiber)
    for (int i = threadIdx.x; i < wb; i += blockDim.x) bs[i] = b[i];

  const long long ntiles = (nrows + R - 1) / R;
  auto load = [&](long long tile, int buf) {
    const long long r0 = tile * R;
    const int rows = (int)(nrows - r0 < R ? nrows - r0 : R);
    if (a_fiber)
      stage_tile<T, VEC>(as + buf * a_len, a + r0 * wa, rows * wa, wa, a_swz);
    if (b_fiber)
      stage_tile<T, VEC>(bs + buf * b_len, b + r0 * wb, rows * wb, wb, b_swz);
  };
  // the thread's first element of a tile, and its step (blockDim apart)
  const int o_first = threadIdx.x % out_w, r_first = threadIdx.x / out_w;
  const int o_step = blockDim.x % out_w, r_step = blockDim.x / out_w;

  long long tile = blockIdx.x;
  if (tile < ntiles) load(tile, 0);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int k = 0; tile < ntiles; ++k, tile += gridDim.x) {
    if (tile + gridDim.x < ntiles) load(tile + gridDim.x, (k + 1) & 1);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();  // tile k (and the tables, the broadcast rows) landed
    const T* ac = a_fiber ? as + (k & 1) * a_len : as;
    const T* bc = b_fiber ? bs + (k & 1) * b_len : bs;
    const long long r0 = tile * R;
    const int rows = (int)(nrows - r0 < R ? nrows - r0 : R);
    const int n = rows * out_w;
    if (o_step == 0) {  // out_w divides blockDim: each thread keeps its o
      const int t0 = P[o_first], t1 = P[o_first + 1];
      if (t1 - t0 == 1) {  // one term: its two columns stay in registers
        const int ca = AI[t0], cb = BI[t0];
#pragma unroll 4
        for (int i = threadIdx.x, r = r_first; i < n;
             i += blockDim.x, r += r_step)
          os[i] = add_rn(
              T(0),
              mul_rn(ac[tile_index<T>(a_fiber ? r : 0, ca, wa, a_swz)],
                     bc[tile_index<T>(b_fiber ? r : 0, cb, wb, b_swz)]));
      } else {
        for (int i = threadIdx.x, r = r_first; i < n;
             i += blockDim.x, r += r_step)
          os[i] = tile_term_sum<T, CHUNKS>(ac, bc, a_fiber ? r : 0,
                                           b_fiber ? r : 0, AI, BI, t0, t1,
                                           wa, a_swz, wb, b_swz);
      }
    } else {
      int o = o_first, r = r_first;
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        os[i] = tile_term_sum<T, CHUNKS>(ac, bc, a_fiber ? r : 0,
                                         b_fiber ? r : 0, AI, BI, P[o],
                                         P[o + 1], wa, a_swz, wb, b_swz);
        o += o_step;
        r += r_step;
        if (o >= out_w) {
          o -= out_w;
          ++r;
        }
      }
    }
    __syncthreads();  // the output tile is complete; buffer k & 1 is free
    constexpr int V = 16 / sizeof(T);
    T* dst = out + r0 * out_w;
    const int nq = n / V;
    for (int q = threadIdx.x; q < nq; q += blockDim.x)
      reinterpret_cast<uint4*>(dst)[q] = reinterpret_cast<const uint4*>(os)[q];
    for (int i = nq * V + threadIdx.x; i < n; i += blockDim.x) dst[i] = os[i];
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The largest dynamic shared memory product_kernel is ever launched with
// (native.MAX_SHARED_BYTES, the most stages.product_tiling returns).
constexpr int kProductMaxSmem = 232448;

template <typename T, bool VEC, bool SMEM_TABLES, bool CHUNKS>
static int launch_product(const T* a, int a_fiber, int wa, int a_swz,
                          const T* b, int b_fiber, int wb, int b_swz,
                          long long nrows, int R, const int* out_ptr,
                          const int* a_idx, const int* b_idx, int out_w,
                          int nterms, int smem, T* out, cudaStream_t stream) {
  const auto kernel = product_kernel<T, VEC, SMEM_TABLES, CHUNKS>;
  // The shared-memory limit is a property of the kernel for the whole
  // process, so it is set once per device to the most any launch asks
  // for (every thread sets the same value).  The resident blocks for
  // (device, shared bytes) are kept per host thread: the occupancy query
  // costs more than a launch.
  static thread_local int limit_dev = -1, last_dev = -1, last_smem = -1;
  static thread_local long long resident = 0;
  if (smem > kProductMaxSmem) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && dev != limit_dev) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kProductMaxSmem);
    if (e == cudaSuccess) limit_dev = dev;
  }
  if (e == cudaSuccess && (dev != last_dev || smem != last_smem)) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, kProductThreads, smem);
    if (e == cudaSuccess && per_sm < 1) e = cudaErrorInvalidConfiguration;
    if (e == cudaSuccess) {
      last_dev = dev;
      last_smem = smem;
      resident = (long long)per_sm * sms;
    }
  }
  if (e != cudaSuccess) return (int)e;
  const long long ntiles = (nrows + R - 1) / R;
  const unsigned grid = (unsigned)(ntiles < resident ? ntiles : resident);
  kernel<<<grid, kProductThreads, smem, stream>>>(
      a, a_fiber, wa, a_swz, b, b_fiber, wb, b_swz, nrows, R, out_ptr, a_idx,
      b_idx, out_w, nterms, out);
  return (int)cudaGetLastError();
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

// K3: a fused chain of reducing stages, one thread block per outermost
// segment s, walking the segment's contiguous block range in ascending
// order (the TPU's sequential grid, restricted to one output row).  Per
// block, as the TPU kernel does it:
//   1. every inner level j whose segment opens here zeroes buffer j;
//   2. the innermost stage's block partial is added to buffer 0;
//   3. every inner level j whose segment closes here (inner levels
//      first) flushes buffer j through link j's einsum — buffer j times
//      the link operand's row at the block's level-j segment — into
//      buffer j+1, or into the output row for the last link.
// The buffers live in shared memory after the 256-element reduction
// scratch; the output row is this block's own, so it is accumulated in
// place.  A segment with no blocks leaves its row zero.
//
// levels is (3 * nlinks, nblocks) int32: per inner level j the block's
// segment id (row 3j), opens flag (3j+1) and closes flag (3j+2).  desc
// holds kLinkFields int64 per link: the link operand's row pointer and
// row stride (0 = broadcast), its index table (out_ptr, a_idx, b_idx),
// then the buffer it reads (width, offset) and the one it writes
// (width, offset; offset -1 = the output row).
constexpr int kLinkFields = 9;

template <typename T>
__global__ void chain_kernel(const T* __restrict__ a, long long a_rs,
                             const T* __restrict__ b, long long b_rs,
                             const float* __restrict__ mask, int block,
                             const int* __restrict__ out_ptr,
                             const int* __restrict__ a_idx,
                             const int* __restrict__ b_idx, int stage_w,
                             int nlinks, const int* __restrict__ levels,
                             long long nblocks,
                             const long long* __restrict__ desc,
                             const long long* __restrict__ out_block_ptr,
                             int out_w, T* __restrict__ out) {
  extern __shared__ unsigned char smem[];
  T* red = reinterpret_cast<T*>(smem);
  T* bufs = red + blockDim.x * blockDim.y;
  const long long s = blockIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  T* orow = out + s * out_w;
  for (int o = tid; o < out_w; o += nthreads) orow[o] = T(0);
  for (long long blk = out_block_ptr[s]; blk < out_block_ptr[s + 1];
       ++blk) {
    for (int j = 0; j < nlinks; ++j) {
      if (levels[(3LL * j + 1) * nblocks + blk]) {
        const long long* d = desc + j * kLinkFields;
        T* buf = bufs + d[6];
        for (int o = tid; o < (int)d[5]; o += nthreads) buf[o] = T(0);
      }
    }
    __syncthreads();
    for (int c0 = 0; c0 < stage_w; c0 += blockDim.x) {
      const int o = c0 + threadIdx.x;
      const T p = block_partial(a, a_rs, b, b_rs, mask, blk, block, out_ptr,
                                a_idx, b_idx, o, stage_w, red);
      if (threadIdx.y == 0 && o < stage_w) bufs[o] += p;
    }
    __syncthreads();
    for (int j = 0; j < nlinks; ++j) {
      if (!levels[(3LL * j + 2) * nblocks + blk]) continue;
      const long long* d = desc + j * kLinkFields;
      const T* row = reinterpret_cast<const T*>(d[0]) +
                     (long long)levels[3LL * j * nblocks + blk] * d[1];
      const int* lp = reinterpret_cast<const int*>(d[2]);
      const int* la = reinterpret_cast<const int*>(d[3]);
      const int* lb = reinterpret_cast<const int*>(d[4]);
      const T* src = bufs + d[6];
      T* dst = d[8] >= 0 ? bufs + d[8] : orow;
      for (int o = tid; o < (int)d[7]; o += nthreads)
        dst[o] += fiber_column(src, row, la, lb, lp[o], lp[o + 1]);
      __syncthreads();
    }
  }
}

}  // namespace spttn

// --------------------------------------------------------------------------
// C entry points (bound with ctypes).  Launch geometry comes from the
// caller: for K1, K3 and K4 tx threads over output columns (a power of
// two), 256 / tx over fibers; for K2 the tile rows R, the table and
// chunk modes and the shared bytes (stages.product_tiling).
// --------------------------------------------------------------------------
#define SPTTN_ENTRY_POINTS(T, SUFFIX)                                          \
  extern "C" int spttn_reduce_##SUFFIX(                                        \
      const void* a, long long a_rs, const void* b, long long b_rs,            \
      const void* mask, const void* block_ptr, long long nseg, int block,      \
      const void* out_ptr, const void* a_idx, const void* b_idx, int out_w,    \
      int tx, void* out, void* stream) {                                       \
    const dim3 threads(tx, 256 / tx);                                          \
    const dim3 grid((unsigned)nseg, (out_w + tx - 1) / tx);                    \
    spttn::reduce_kernel<T><<<grid, threads, 256 * sizeof(T),                  \
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
    spttn::splitk_kernel<T><<<grid, threads, 256 * sizeof(T),                  \
                       (cudaStream_t)stream>>>(                                \
        (const T*)a, a_rs, (const T*)b, b_rs, (const float*)mask, block,       \
        (const int*)out_ptr, (const int*)a_idx, (const int*)b_idx, out_w,      \
        (T*)partials);                                                         \
    return (int)cudaGetLastError();                                            \
  }                                                                            \
  extern "C" int spttn_product_##SUFFIX(                                       \
      const void* a, int a_fiber, int wa, int a_swz, const void* b,            \
      int b_fiber, int wb, int b_swz, long long nrows, int R,                  \
      const void* out_ptr, const void* a_idx, const void* b_idx, int out_w,    \
      int nterms, int vec, int smem_tables, int chunks, int smem, void* out,   \
      void* stream) {                                                          \
    if (R < 4 || R % 4 ||                                                      \
        (size_t)smem < spttn::product_smem(sizeof(T), a_fiber, wa, b_fiber,    \
                                           wb, R, out_w, nterms, smem_tables)) \
      return (int)cudaErrorInvalidValue;                                       \
    const auto go = [&](auto v, auto tab, auto ch) {                           \
      return spttn::launch_product<T, decltype(v)::value,                      \
                                   decltype(tab)::value, decltype(ch)::value>( \
          (const T*)a, a_fiber, wa, a_swz, (const T*)b, b_fiber, wb, b_swz,    \
          nrows, R, (const int*)out_ptr, (const int*)a_idx,                    \
          (const int*)b_idx, out_w, nterms, smem, (T*)out,                     \
          (cudaStream_t)stream);                                               \
    };                                                                         \
    const auto with_tables = [&](auto v, auto ch) {                            \
      return smem_tables ? go(v, std::true_type{}, ch)                         \
                         : go(v, std::false_type{}, ch);                       \
    };                                                                         \
    const auto with_chunks = [&](auto v) {                                     \
      return chunks ? with_tables(v, std::true_type{})                         \
                    : with_tables(v, std::false_type{});                       \
    };                                                                         \
    return vec ? with_chunks(std::true_type{})                                 \
               : with_chunks(std::false_type{});                               \
  }                                                                            \
  extern "C" int spttn_chain_##SUFFIX(                                         \
      const void* a, long long a_rs, const void* b, long long b_rs,            \
      const void* mask, int block, const void* out_ptr, const void* a_idx,     \
      const void* b_idx, int stage_w, int tx, int nlinks, const void* levels,  \
      long long nblocks, const void* desc, const void* out_block_ptr,          \
      long long nseg_out, int out_w, int smem, void* out, void* stream) {      \
    if (smem > 48 * 1024) {                                                    \
      const cudaError_t e = cudaFuncSetAttribute(                              \
          spttn::chain_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, \
          smem);                                                               \
      if (e != cudaSuccess) return (int)e;                                     \
    }                                                                          \
    const dim3 threads(tx, 256 / tx);                                          \
    spttn::chain_kernel<T><<<(unsigned)nseg_out, threads, smem,                \
                      (cudaStream_t)stream>>>(                                 \
        (const T*)a, a_rs, (const T*)b, b_rs, (const float*)mask, block,       \
        (const int*)out_ptr, (const int*)a_idx, (const int*)b_idx, stage_w,    \
        nlinks, (const int*)levels, nblocks, (const long long*)desc,           \
        (const long long*)out_block_ptr, out_w, (T*)out);                      \
    return (int)cudaGetLastError();                                            \
  }                                                                            \
  extern "C" int spttn_combine_##SUFFIX(const void* rows, const void* ptr,     \
                                        long long nseg, int w, void* out,      \
                                        void* stream) {                        \
    const long long n = nseg * w;                                              \
    spttn::combine_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0,            \
                        (cudaStream_t)stream>>>(                               \
        (const T*)rows, (const long long*)ptr, nseg, w, (T*)out);              \
    return (int)cudaGetLastError();                                            \
  }

SPTTN_ENTRY_POINTS(float, f32)
SPTTN_ENTRY_POINTS(double, f64)
