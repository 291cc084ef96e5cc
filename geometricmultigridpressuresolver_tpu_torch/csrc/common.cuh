// Shared pieces of the hand-written Hopper kernels (sm_90a).
//
// Grid convention (same as the Python package): a cell field is a
// C-contiguous (nx, ny, nz) array, z fastest.  Edge weights are stored
// CELL-shaped: e[i] along an axis is the weight of the face between cells i
// and i+1, so the off-diagonal neighbour sum is
//     S[i] = e[i] * x[i+1] + e[i-1] * x[i-1]      (per axis)
// with reads past the array edge taken as zero.
//
// Reductions never use float atomics: every kernel that emits a dot writes
// one partial per block (a fixed shuffle tree inside the block), and
// sum_partials adds the partials in a fixed order in one block, so a
// conjugate-gradient trajectory is reproducible from run to run.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gmg {

// Threads per block of every cell kernel; one partial per block.
constexpr int kBlock = 256;
// Threads of the single block that sums the partials.
constexpr int kSumBlock = 1024;

// Field dtype codes shared with the Python wrappers.
enum DType : int { kF32 = 0, kF64 = 1, kBF16 = 2 };

template <typename T>
__device__ __forceinline__ T load_w(const float* p, long long q) { return T(p[q]); }
template <typename T>
__device__ __forceinline__ T load_w(const double* p, long long q) { return T(p[q]); }
template <typename T>
__device__ __forceinline__ T load_w(const __nv_bfloat16* p, long long q) {
  return T(__bfloat162float(p[q]));
}

// Cell coordinates of a linear index.
struct Cell {
  int i, j, k;
};

__device__ __forceinline__ Cell cell_of(long long idx, int ny, int nz) {
  Cell c;
  c.k = int(idx % nz);
  long long t = idx / nz;
  c.j = int(t % ny);
  c.i = int(t / ny);
  return c;
}

// Off-diagonal neighbour sum at `idx`, in the association order of
// ops/stencil.neighbor_sum: axis 0 upper, axis 0 lower, axis 1 upper, ...
// `val(q)` returns the field value at linear index q.
template <typename T, typename E, typename F>
__device__ __forceinline__ T neighbor_sum(F val, const E* e0, const E* e1,
                                          const E* e2, long long idx, Cell c,
                                          int nx, int ny, int nz) {
  const long long sx = (long long)ny * nz;
  const long long sy = nz;
  T s = T(0);
  if (c.i + 1 < nx) s += load_w<T>(e0, idx) * val(idx + sx);
  if (c.i > 0) s += load_w<T>(e0, idx - sx) * val(idx - sx);
  if (c.j + 1 < ny) s += load_w<T>(e1, idx) * val(idx + sy);
  if (c.j > 0) s += load_w<T>(e1, idx - sy) * val(idx - sy);
  if (c.k + 1 < nz) s += load_w<T>(e2, idx) * val(idx + 1);
  if (c.k > 0) s += load_w<T>(e2, idx - 1) * val(idx - 1);
  return s;
}

// Block-wide sum in a fixed order; the result is valid in thread 0.
// Every thread of the block must call it.
template <typename T>
__device__ __forceinline__ T block_sum(T v) {
  __shared__ T warp_sums[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  const int nwarps = (blockDim.x + 31) >> 5;
  v = (threadIdx.x < nwarps) ? warp_sums[lane] : T(0);
  if (warp == 0) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

inline unsigned int num_blocks(long long n) {
  return (unsigned int)((n + kBlock - 1) / kBlock);
}

}  // namespace gmg
