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
// no atomics: every reduction across thread blocks is cut into fixed
// parts that a second pass adds in a fixed order (K1, K3, K4), so
// results are deterministic run to run.
//
// Every entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() so that a refused launch is reported.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "item_walk.cuh"

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
// be a power of two; with one thread a column there is nothing to add.
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
  if (blockDim.y == 1) return s;  // one thread a column: nothing to add
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

// K1 over work items: each output segment's contiguous block range is
// cut, on the host and from the layout alone (ir.reduce_items), into
// items of at most a fixed number of consecutive blocks; partials[i] is
// the sum over the rows z of item i (blocks [item_block[i],
// item_block[i+1])) of mask[z] * einsum(stage)(z), and the segment
// combine adds each segment's partial rows in ascending item order.  Why:
// one thread block per segment left a heavy segment's walk (or a row
// dot's single segment) to one SM while the others idled.
//
// One 256-thread block per (item, column tile).  threadIdx.x takes a
// column, a 16-byte column vector or a register block (below), threadIdx.y
// one of the block's row lanes: lane y takes rows y, y + lanes, ... of
// the item in ascending order and issues the loads of kReduceRows rows
// before it adds them.  A fixed shared-memory tree then adds the lanes
// (lane 0 + lane h, for h = lanes/2 .. 1), and the block writes the
// item's partial row.  No atomics: the same bits on every call.  The walk
// of the outer path and the lane tree live in item_walk.cuh, shared with
// K6 (paper_kernels.cu), which runs the same outer product.  Paths:
//   kReduceVectors  every output column is one term, and runs of V
//                   columns read V consecutive columns of A and of B from
//                   a multiple of V (Zd,Zd->d): a thread sums one 16-byte
//                   vector of columns, its A and B vectors found once;
//   kReduceOuter    column d*E + e is A[d] * B[e], D and E multiples of
//                   kOuterBlock (Zd,Ze->de): a thread keeps a 4 x 4 block
//                   of (d, e) sums in registers, fed by 16-byte loads of
//                   its 4 columns of A and of B (two loads of shared L1
//                   lines for 16 multiply-adds), where one thread a column
//                   read two scalars for each one;
//   kReduceTables   anything else, through the index tables: a column of
//                   at most kReduceHoist terms keeps its table entries in
//                   registers, a longer one reads them once for the
//                   kReduceRows rows in flight.
constexpr int kReduceHoist = 4;
constexpr int kReduceTables = 0, kReduceVectors = 1, kReduceOuter = 2;

// kReduceTables: this thread's column o of the item's rows [n0, n1).
template <typename T>
__device__ __forceinline__ void reduce_tables(
    const T* __restrict__ a, long long a_rs, const T* __restrict__ b,
    long long b_rs, const float* __restrict__ mask, long long n0,
    long long n1, const int* __restrict__ out_ptr,
    const int* __restrict__ a_idx, const int* __restrict__ b_idx, int out_w,
    T* __restrict__ prow) {
  __shared__ T red[kReduceThreads];
  const int lanes = blockDim.y;
  const int o = blockIdx.y * blockDim.x + threadIdx.x;
  T acc[1] = {T(0)};
  if (o < out_w) {
    const int t0 = out_ptr[o], nt = out_ptr[o + 1] - t0;
    int ca[kReduceHoist], cb[kReduceHoist];
#pragma unroll
    for (int j = 0; j < kReduceHoist; ++j) {
      ca[j] = j < nt ? a_idx[t0 + j] : 0;
      cb[j] = j < nt ? b_idx[t0 + j] : 0;
    }
    for (long long n = n0 + threadIdx.y; n < n1;
         n += (long long)lanes * kReduceRows) {
      const T* ar[kReduceRows];
      const T* br[kReduceRows];
      T w[kReduceRows], s[kReduceRows];
#pragma unroll
      for (int k = 0; k < kReduceRows; ++k) {
        const long long m = n + (long long)k * lanes;
        const long long z = m < n1 ? m : n;  // a real row, not added
        ar[k] = a + z * a_rs;
        br[k] = b + z * b_rs;
        w[k] = T(mask[z]);
        s[k] = T(0);
      }
      if (nt <= kReduceHoist) {
#pragma unroll
        for (int j = 0; j < kReduceHoist; ++j) {
          if (j < nt) {
#pragma unroll
            for (int k = 0; k < kReduceRows; ++k)
              s[k] += ar[k][ca[j]] * br[k][cb[j]];
          }
        }
      } else {
        for (int t = t0; t < t0 + nt; ++t) {
          const int xa = a_idx[t], xb = b_idx[t];
#pragma unroll
          for (int k = 0; k < kReduceRows; ++k) s[k] += ar[k][xa] * br[k][xb];
        }
      }
#pragma unroll
      for (int k = 0; k < kReduceRows; ++k)
        if (n + (long long)k * lanes < n1) acc[0] += w[k] * s[k];
    }
  }
  add_lanes(acc, red);
  if (threadIdx.y == 0 && o < out_w) prow[o] = acc[0];
}

// kReduceVectors: this thread's vector c of V output columns.
template <typename T>
__device__ __forceinline__ void reduce_vectors(
    const T* __restrict__ a, long long a_rs, const T* __restrict__ b,
    long long b_rs, const float* __restrict__ mask, long long n0,
    long long n1, const int* __restrict__ a_idx,
    const int* __restrict__ b_idx, int out_w, T* __restrict__ prow) {
  constexpr int V = 16 / sizeof(T);
  using P = ReduceVec<T, V>;
  __shared__ T red[V * kReduceThreads];
  const int lanes = blockDim.y;
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  T acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = T(0);
  if (c < out_w / V) {
    const P* ap = reinterpret_cast<const P*>(a) + a_idx[c * V] / V;
    const P* bp = reinterpret_cast<const P*>(b) + b_idx[c * V] / V;
    const long long ars = a_rs / V, brs = b_rs / V;
    for (long long n = n0 + threadIdx.y; n < n1;
         n += (long long)lanes * kReduceRows) {
      P av[kReduceRows], bv[kReduceRows];
      T w[kReduceRows];
#pragma unroll
      for (int k = 0; k < kReduceRows; ++k) {
        const long long m = n + (long long)k * lanes;
        if (m < n1) {
          av[k] = ap[m * ars];
          bv[k] = bp[m * brs];
          w[k] = T(mask[m]);
        }
      }
#pragma unroll
      for (int k = 0; k < kReduceRows; ++k) {
        if (n + (long long)k * lanes < n1) {
#pragma unroll
          for (int i = 0; i < V; ++i) acc[i] += w[k] * av[k].x[i] * bv[k].x[i];
        }
      }
    }
  }
  add_lanes(acc, red);
  if (threadIdx.y == 0 && c < out_w / V) {
    P out;
#pragma unroll
    for (int i = 0; i < V; ++i) out.x[i] = acc[i];
    reinterpret_cast<P*>(prow)[c] = out;
  }
}

template <typename T, int PATH>
__global__ void __launch_bounds__(kReduceThreads)
    reduce_kernel(const T* __restrict__ a, long long a_rs,
                  const T* __restrict__ b, long long b_rs,
                  const float* __restrict__ mask,
                  const long long* __restrict__ item_block, int block,
                  const int* __restrict__ out_ptr,
                  const int* __restrict__ a_idx,
                  const int* __restrict__ b_idx, int out_w,
                  T* __restrict__ partials) {
  const long long item = blockIdx.x;
  const long long n0 = item_block[item] * block;
  const long long n1 = item_block[item + 1] * block;
  T* prow = partials + item * out_w;
  if constexpr (PATH == kReduceVectors)
    reduce_vectors(a, a_rs, b, b_rs, mask, n0, n1, a_idx, b_idx, out_w,
                   prow);
  else if constexpr (PATH == kReduceOuter)
    reduce_outer<T, true>(a, a_rs, b, b_rs, mask, n0, n1, prow);
  else
    reduce_tables(a, a_rs, b, b_rs, mask, n0, n1, out_ptr, a_idx, b_idx,
                  out_w, prow);
}

// K1's launch: threadIdx.x over the path's columns (the smallest power of
// two covering them, at most 256: stages.reduce_columns), the rest of the
// 256 threads row lanes.  A vector path on what it cannot read (a width
// off the vector, a base off 16 bytes) is refused, not run.
template <typename T>
int reduce_entry(const void* a, long long a_rs, const void* b,
                 long long b_rs, const void* mask, const void* item_block,
                 long long nitems, int block, const void* out_ptr,
                 const void* a_idx, const void* b_idx, int out_w, int path,
                 void* partials, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool aligned =
      ((uintptr_t)a | (uintptr_t)b | (uintptr_t)partials) % 16 == 0;
  int cols = out_w;
  if (path == kReduceVectors) {
    if (!aligned || out_w % V || a_rs % V || b_rs % V)
      return (int)cudaErrorInvalidValue;
    cols = out_w / V;
  } else if (path == kReduceOuter) {
    if (!aligned || a_rs <= 0 || b_rs <= 0 || a_rs % kOuterBlock ||
        b_rs % kOuterBlock || (long long)out_w != a_rs * b_rs)
      return (int)cudaErrorInvalidValue;
    cols = out_w / (kOuterBlock * kOuterBlock);
  } else if (path != kReduceTables) {
    return (int)cudaErrorInvalidValue;
  }
  int tx = 1;
  while (tx < cols && tx < kReduceThreads) tx *= 2;
  const dim3 threads(tx, kReduceThreads / tx);
  const dim3 grid((unsigned)nitems, (cols + tx - 1) / tx);
  const auto go = [&](auto kernel) {
    kernel<<<grid, threads, 0, stream>>>(
        (const T*)a, a_rs, (const T*)b, b_rs, (const float*)mask,
        (const long long*)item_block, block, (const int*)out_ptr,
        (const int*)a_idx, (const int*)b_idx, out_w, (T*)partials);
    return (int)cudaGetLastError();
  };
  if (path == kReduceVectors) return go(reduce_kernel<T, kReduceVectors>);
  if (path == kReduceOuter) return go(reduce_kernel<T, kReduceOuter>);
  return go(reduce_kernel<T, kReduceTables>);
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

// K3: a fused chain of reducing stages as fixed work items.  Each
// outermost segment's contiguous block range is cut, on the host and from
// the layout alone (ir.chain_items), into items of at most a fixed number
// of consecutive blocks; one thread block runs one item, walking its
// blocks in ascending order as the TPU's sequential grid walks them.  Per
// block:
//   1. every inner level j whose segment opens here, and every level at
//      the item's first block, zeroes buffer j;
//   2. the innermost stage's block partial is added to buffer 0;
//   3. every inner level j whose segment closes here, and every level at
//      the item's last block (inner levels first), flushes buffer j
//      through link j's einsum — buffer j times the link operand's row at
//      the block's level-j segment — into buffer j+1, or into the item's
//      partial row for the last link.
// Every link is linear in the buffer it reads, so a segment cut by item
// boundaries is flushed in parts whose sum is its whole flush.  The
// partial rows (one per item, nothing shared between thread blocks, no
// atomics) are then added per outermost segment in ascending item order
// by the segment combine.  Why: a skewed pattern puts most of the blocks
// in a few outermost segments, and one thread block per segment left
// those few walking nearly all the work alone.
//
// The buffers live in shared memory after the 256-element reduction
// scratch.  levels is (3 * nlinks, nblocks) int32: per inner level j the
// block's segment id (row 3j), opens flag (3j+1) and closes flag (3j+2).
// desc holds kLinkFields int64 per link: the link operand's row pointer
// and row stride (0 = broadcast), its index table (out_ptr, a_idx,
// b_idx), then the buffer it reads (width, offset) and the one it writes
// (width, offset; offset -1 = the partial row).
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
                             const long long* __restrict__ item_block,
                             int out_w, T* __restrict__ partials) {
  extern __shared__ unsigned char smem[];
  T* red = reinterpret_cast<T*>(smem);
  T* bufs = red + blockDim.x * blockDim.y;
  const long long item = blockIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const long long first = item_block[item], last = item_block[item + 1] - 1;
  T* prow = partials + item * out_w;
  for (int o = tid; o < out_w; o += nthreads) prow[o] = T(0);
  for (long long blk = first; blk <= last; ++blk) {
    for (int j = 0; j < nlinks; ++j) {
      if (blk == first || levels[(3LL * j + 1) * nblocks + blk]) {
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
      if (blk != last && !levels[(3LL * j + 2) * nblocks + blk]) continue;
      const long long* d = desc + j * kLinkFields;
      const T* row = reinterpret_cast<const T*>(d[0]) +
                     (long long)levels[3LL * j * nblocks + blk] * d[1];
      const int* lp = reinterpret_cast<const int*>(d[2]);
      const int* la = reinterpret_cast<const int*>(d[3]);
      const int* lb = reinterpret_cast<const int*>(d[4]);
      const T* src = bufs + d[6];
      T* dst = d[8] >= 0 ? bufs + d[8] : prow;
      for (int o = tid; o < (int)d[7]; o += nthreads)
        dst[o] += fiber_column(src, row, la, lb, lp[o], lp[o + 1]);
      __syncthreads();
    }
  }
}

}  // namespace spttn

// --------------------------------------------------------------------------
// C entry points (bound with ctypes).  K1 sets its own geometry from its
// path (reduce_entry).  For K3 and K4 the caller gives tx threads over
// output columns (a power of two); K4 adds 256 / tx over fibers, K3 only
// enough to fill one warp (32 / tx; one over fibers from 32 columns up):
// a K3 thread block walks one item's blocks in order with a barrier or
// three a block, so small thread blocks, up to 32 of them on an SM, hide
// that walk's latency where large ones would spend their threads waiting
// at the barriers.  For K2 the tile rows R, the table and chunk modes and
// the shared bytes (stages.product_tiling).
// --------------------------------------------------------------------------
#define SPTTN_ENTRY_POINTS(T, SUFFIX)                                          \
  extern "C" int spttn_reduce_##SUFFIX(                                        \
      const void* a, long long a_rs, const void* b, long long b_rs,            \
      const void* mask, const void* item_block, long long nitems, int block,   \
      const void* out_ptr, const void* a_idx, const void* b_idx, int out_w,    \
      int path, void* partials, void* stream) {                                \
    return spttn::reduce_entry<T>(a, a_rs, b, b_rs, mask, item_block, nitems,  \
                                  block, out_ptr, a_idx, b_idx, out_w, path,   \
                                  partials, (cudaStream_t)stream);             \
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
      long long nblocks, const void* desc, const void* item_block,             \
      long long nitems, int out_w, int smem, void* partials, void* stream) {   \
    if (smem > 48 * 1024) {                                                    \
      const cudaError_t e = cudaFuncSetAttribute(                              \
          spttn::chain_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, \
          smem);                                                               \
      if (e != cudaSuccess) return (int)e;                                     \
    }                                                                          \
    const dim3 threads(tx, tx < 32 ? 32 / tx : 1);                             \
    spttn::chain_kernel<T><<<(unsigned)nitems, threads, smem,                  \
                      (cudaStream_t)stream>>>(                                 \
        (const T*)a, a_rs, (const T*)b, b_rs, (const float*)mask, block,       \
        (const int*)out_ptr, (const int*)a_idx, (const int*)b_idx, stage_w,    \
        nlinks, (const int*)levels, nblocks, (const long long*)desc,           \
        (const long long*)item_block, out_w, (T*)partials);                    \
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
