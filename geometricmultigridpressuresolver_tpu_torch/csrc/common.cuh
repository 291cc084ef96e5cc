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
// one partial per block (a fixed shuffle tree inside the block), and the
// partials are added in a fixed order -- by sum_partials in one block after
// the chunk kernel, by the CG step's last block in the same launch -- so a
// conjugate-gradient trajectory is reproducible from run to run.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gmg {

// Threads per block of the CG-step and residual kernels.
constexpr int kBlock = 256;
// Threads of the single block that sums the partials.
constexpr int kSumBlock = 1024;

// Field dtype codes shared with the Python wrappers.
enum DType : int { kF32 = 0, kF64 = 1, kBF16 = 2 };

// Load element q of a float, double or bfloat16 array as compute type T.
template <typename T>
__device__ __forceinline__ T load_as(const float* p, long long q) { return T(p[q]); }
template <typename T>
__device__ __forceinline__ T load_as(const double* p, long long q) { return T(p[q]); }
template <typename T>
__device__ __forceinline__ T load_as(const __nv_bfloat16* p, long long q) {
  return T(__bfloat162float(p[q]));
}

// Store a computed value into a field of the storage type; bfloat16 rounds
// to nearest even, as torch's float -> bfloat16 conversion does.
__device__ __forceinline__ void store_as(float* p, long long q, float v) { p[q] = v; }
__device__ __forceinline__ void store_as(double* p, long long q, double v) { p[q] = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, long long q, float v) {
  p[q] = __float2bfloat16_rn(v);
}

// Cell coordinates.
struct Cell {
  int i, j, k;
};

// Core window of a stacked block grid (parallel/halo.py): the haloed
// blocks of a one-card block mesh lie one after another along x, each
// `period` rows long; a cell is a core cell when its row within its block
// is in [lo_x, hi_x) and its y index in [lo_y, hi_y).  Only core cells add
// to a dot.  The full window (period = nx, [0, nx) x [0, ny)) admits every
// cell, which is the plain grid.
struct CoreWindow {
  int period, lo_x, hi_x, lo_y, hi_y;
};

__device__ __forceinline__ bool in_core(const CoreWindow& w, Cell c) {
  const int r = c.i % w.period;
  return r >= w.lo_x && r < w.hi_x && c.j >= w.lo_y && c.j < w.hi_y;
}

// A launch counter (ops/_cuda.py `LaunchCounter`): thread 0 of block 0
// adds one as the kernel starts, so a launch counts where it runs, eagerly
// or from a replayed CUDA graph, and a launch that never runs (a skipped
// IF body) does not.  Null: not counted.
__device__ __forceinline__ void count_launch(unsigned long long* launches) {
  if (launches != nullptr && blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 &&
      threadIdx.x == 0 && threadIdx.y == 0 && threadIdx.z == 0)
    atomicAdd(launches, 1ull);
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

}  // namespace gmg
