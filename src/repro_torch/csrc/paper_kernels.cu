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
// writes each output element once.  No atomics: a segment's rows are
// summed by one thread block in a fixed order, so results are the same
// on every run.
//
// Every entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace spttn {

// K5: out[s, r] = sum over the rows n of segment s of
// (vals[n] * mask[n]) * bg[n, r] * cg[n, r].  One thread block of 1024
// threads per (segment, column tile): threadIdx.x takes a column,
// threadIdx.y a lane of rows; each lane sums its rows in ascending
// order, then a fixed shared-memory tree adds the lanes.  A block has as
// many row lanes as it can (1024 / tx), because a skewed pattern puts a
// large share of the rows in one segment, which one block walks alone.
template <typename T>
__global__ void mttkrp_kernel(const T* __restrict__ vals,
                              const T* __restrict__ bg,
                              const T* __restrict__ cg,
                              const float* __restrict__ mask,
                              const long long* __restrict__ block_ptr,
                              int block, int R, T* __restrict__ out) {
  extern __shared__ unsigned char smem[];
  T* red = reinterpret_cast<T*>(smem);
  const long long s = blockIdx.x;
  const int r = blockIdx.y * blockDim.x + threadIdx.x;
  T acc = T(0);
  if (r < R) {
    const long long n1 = block_ptr[s + 1] * block;
    for (long long n = block_ptr[s] * block + threadIdx.y; n < n1;
         n += blockDim.y)
      acc += (vals[n] * T(mask[n])) * bg[n * R + r] * cg[n * R + r];
  }
  const int me = threadIdx.y * blockDim.x + threadIdx.x;
  red[me] = acc;
  __syncthreads();
  for (int h = blockDim.y / 2; h > 0; h >>= 1) {
    if (threadIdx.y < h) red[me] += red[me + h * blockDim.x];
    __syncthreads();
  }
  if (threadIdx.y == 0 && r < R) out[s * R + r] = red[threadIdx.x];
}

// K6: out[s, r, t] = sum over the fibers f of segment s of
// ug[f, r] * xf[f, t] — per block of fibers the product ug^T xf, added
// to the row.  One thread block per (segment, tile of 256 outputs); the
// block stages ``chunk`` fibers of ug and xf in shared memory with
// coalesced loads, then each thread adds its (r, t) over those fibers in
// ascending order.
template <typename T>
__global__ void ttmc_kernel(const T* __restrict__ ug,
                            const T* __restrict__ xf,
                            const long long* __restrict__ block_ptr,
                            int block, int R, int S, int chunk,
                            T* __restrict__ out) {
  extern __shared__ unsigned char smem[];
  T* us = reinterpret_cast<T*>(smem);
  T* xs = us + chunk * R;
  const long long s = blockIdx.x;
  const int o = blockIdx.y * blockDim.x + threadIdx.x;
  const int r = o / S, t = o - (o / S) * S;
  T acc = T(0);
  const long long n1 = block_ptr[s + 1] * block;
  for (long long c = block_ptr[s] * block; c < n1; c += chunk) {
    const int m = (int)(n1 - c < chunk ? n1 - c : chunk);
    for (int i = threadIdx.x; i < m * R; i += blockDim.x)
      us[i] = ug[c * R + i];
    for (int i = threadIdx.x; i < m * S; i += blockDim.x)
      xs[i] = xf[c * S + i];
    __syncthreads();
    if (o < R * S)
      for (int f = 0; f < m; ++f) acc += us[f * R + r] * xs[f * S + t];
    __syncthreads();
  }
  if (o < R * S) out[s * R * S + o] = acc;
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
      const void* block_ptr, long long nseg, int block, int R, int tx,         \
      void* out, void* stream) {                                               \
    const dim3 threads(tx, 1024 / tx);                                         \
    const dim3 grid((unsigned)nseg, (R + tx - 1) / tx);                        \
    spttn::mttkrp_kernel<T><<<grid, threads, 1024 * sizeof(T),                 \
                       (cudaStream_t)stream>>>(                                \
        (const T*)vals, (const T*)bg, (const T*)cg, (const float*)mask,        \
        (const long long*)block_ptr, block, R, (T*)out);                       \
    return (int)cudaGetLastError();                                            \
  }                                                                            \
  extern "C" int spttn_ttmc_##SUFFIX(                                          \
      const void* ug, const void* xf, const void* block_ptr, long long nseg,   \
      int block, int R, int S, int chunk, void* out, void* stream) {           \
    const dim3 grid((unsigned)nseg, (R * S + 255) / 256);                      \
    spttn::ttmc_kernel<T><<<grid, 256, chunk * (R + S) * sizeof(T),            \
                     (cudaStream_t)stream>>>(                                  \
        (const T*)ug, (const T*)xf, (const long long*)block_ptr, block, R, S,  \
        chunk, (T*)out);                                                       \
    return (int)cudaGetLastError();                                            \
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
