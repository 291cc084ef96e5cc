// Kernels 2 and 3 -- the fused CG step and the residual -- plus the
// fixed-order sum of the per-block dot partials that the chunk kernel
// (smoother.cu) emits.
//
// Kernel 2 replaces ops/pallas_cg.py::fused_search_matvec_dot (kernel body
// _make_kernel) of the JAX package:
//     p' = z + beta*p,   Ap' = diag*p' - S(p'),   <p', Ap'>.
// Kernel 3 replaces ops/pallas_cg.py::fused_residual (kernel body
// _make_residual_kernel):  r = b - (diag*x - S(x)): the CG's initial and
// recomputed residuals, and the downstroke's where the smoother cannot fuse
// it (the chunk kernel forms it otherwise).  x and diag are in the compute
// type T; b and r in the storage type S: T itself, or bfloat16 over float
// when the V-cycle stores its fields narrow -- then x is the smoother's
// unrounded float x and only r narrows, as the Pallas kernel forms the
// residual before it narrows x (ops/pallas_smoother.py:582-590).
//
// Design (both kernels).  The Pallas kernels walk a compacted list of the
// slabs that hold a solvable cell, write zeros elsewhere through aliased
// zero buffers, and form p' once per slab with a one-cell halo.  Here one
// CUDA block takes one tile of kTX x kTY x kTZ = (8, 8, 32) cells, the
// chunk kernel's tile (ops/fused_smoother.py::CHUNK_TILE): the grid is the
// level's tile count, blocks [0, n_active) take the active tiles of the
// level's `Tiles` (those holding a solvable cell; n_active is read from
// the device, so a launch needs no host count), the others its dead tiles, where they store zeros with
// 16-byte stores and read nothing -- each output is a fresh tensor written
// once on every cell.  An active block stages its stencil input (p' for the
// CG step, formed once per cell as it loads; x for the residual) over the
// tile and a one-cell halo on its six faces in shared memory, then thread
// (j, k) = (warp, lane) walks the kTX planes of its column: a warp's z row
// is one 128-byte line, the lower x edge weight carries over from the plane
// before, the lower z one comes from the next lane down by a shuffle.  Cell
// indices are 32-bit, from the tile id once per block.  Under the wrappers'
// precondition (inputs zero off the solvable set, edge weights zero across
// its border) the dead tiles' outputs are the plain function's there.
//
// The CG step's dot, over the cells of the CoreWindow (common.cuh; on the
// stacked grid of a block mesh, parallel/fused_sharded.py::cg_step_sharded,
// it counts each global cell once), is finished in the same launch: each
// active block writes its partial, fences and takes a ticket from an
// integer atomic; the block that takes the last ticket sums the partials in
// index order and resets the ticket.  No float atomics: two launches on the
// same inputs give the same bits.  beta arrives by device pointer, so the
// CG loop needs no host read to launch the step.
//
// Bound: device memory.  Per active cell the CG step reads z, p, diag and
// three edge weights (24 B in fp32 with fp32 weights) plus the halo faces
// (~1.5x the cells of z and p, mostly from L2) and the lower edge-weight
// row along y (L1); each output is written once on every cell (8 B).  The
// residual reads x, b, diag and the weights, and writes r.
#include "common.cuh"

namespace gmg {

// The tile (x planes, y rows, z columns) and the staged box around it.
constexpr int kTX = 8, kTY = 8, kTZ = 32;
constexpr int kBX = kTX + 2, kBY = kTY + 2, kBZ = kTZ + 2;
constexpr int kPlane = kBY * kBZ;  // box cells per x plane
static_assert(kTY * kTZ == kBlock && kTZ == 32, "one thread per (y, z) column, one warp per y row");

template <typename T> __device__ __forceinline__ T ldg_as(const float* p, int q) { return T(__ldg(p + q)); }
template <typename T> __device__ __forceinline__ T ldg_as(const double* p, int q) { return T(__ldg(p + q)); }
template <typename T> __device__ __forceinline__ T ldg_as(const __nv_bfloat16* p, int q) {
  return T(__bfloat162float(__ldg(p + q)));
}

// The level's tiling: the active and dead tile ids (x-major over the
// (kTX, kTY, kTZ) tiling, each list padded to the tile count), their
// lengths on the device (counts[0] active, counts[1] dead) and the grid.
struct TileList {
  const int* active;
  const int* dead;
  const int* counts;
  int nx, ny, nz, gy, gz;
};

struct Origin {
  int x0, y0, z0;
  bool active;
  int n_active;  // the level's active tiles (read from the device)
};

// The tile of this CUDA block: active tiles first, then the dead ones (the
// grid is the tile count, so every tile has its block whatever the split).
__device__ __forceinline__ Origin tile_origin(const TileList& t) {
  const int b = blockIdx.x;
  const int n_active = __ldg(t.counts);
  const bool active = b < n_active;
  const int tile = active ? __ldg(t.active + b) : __ldg(t.dead + (b - n_active));
  const int per_x = t.gy * t.gz;
  const int tx = tile / per_x, r = tile - tx * per_x, ty = r / t.gz;
  return {tx * kTX, ty * kTY, (r - ty * t.gz) * kTZ, active, n_active};
}

// Zeros on the tile's cells that lie in the grid; 16-byte stores where the
// tile is whole and its rows start 16-byte aligned (the output is a fresh
// tensor, aligned).  Nothing is read.
template <typename S>
__device__ __forceinline__ void zero_tile(S* out, const Origin& o, const TileList& t) {
  constexpr int kVec = 16 / sizeof(S);
  if (o.x0 + kTX <= t.nx && o.y0 + kTY <= t.ny && o.z0 + kTZ <= t.nz && t.nz % kVec == 0) {
    constexpr int kRowVecs = kTZ / kVec;
    for (int v = threadIdx.x; v < kTX * kTY * kRowVecs; v += kBlock) {
      const int row = v / kRowVecs;
      const int q = ((o.x0 + row / kTY) * t.ny + o.y0 + row % kTY) * t.nz + o.z0 + v % kRowVecs * kVec;
      *reinterpret_cast<uint4*>(out + q) = make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }
  const int gj = o.y0 + threadIdx.x / kTZ, gk = o.z0 + threadIdx.x % kTZ;
  if (gj >= t.ny || gk >= t.nz) return;
  for (int gi = o.x0; gi < o.x0 + kTX && gi < t.nx; ++gi) store_as(out, (gi * t.ny + gj) * t.nz + gk, 0.0f);
}

// Stages val(q) over the tile and its one-cell halo on the six faces into
// box[kBX][kBY][kBZ] (zero past the grid edge).  The box's edges, which no
// 7-point stencil reads, are left unwritten.  Warp w loads box rows w,
// w + 8, ...: a row's 32 core columns in one coalesced line, and for the
// tile's own rows the two z-halo cells.
template <typename T, typename F>
__device__ __forceinline__ void stage_box(T* box, const Origin& o, const TileList& t, F val) {
  constexpr int kWarps = kBlock / 32, kRows = kBX * kBY;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int n = 0; n < (kRows + kWarps - 1) / kWarps; ++n) {
    const int row = warp + n * kWarps;
    const int a = row / kBY, c = row % kBY;
    const bool x_halo = a == 0 || a == kBX - 1, y_halo = c == 0 || c == kBY - 1;
    if (row < kRows && !(x_halo && y_halo)) {
      const int i = o.x0 + a - 1, j = o.y0 + c - 1;
      const bool in_row = i >= 0 && i < t.nx && j >= 0 && j < t.ny;
      const int q = (i * t.ny + j) * t.nz + o.z0;
      T* dst = box + row * kBZ + 1;
      dst[lane] = in_row && o.z0 + lane < t.nz ? val(q + lane) : T(0);
      if (!x_halo && !y_halo && lane < 2) {
        const int dk = lane ? kTZ : -1;
        dst[dk] = in_row && o.z0 + dk >= 0 && o.z0 + dk < t.nz ? val(q + dk) : T(0);
      }
    }
  }
  __syncthreads();
}

// Calls emit(q, i, v, s) for each cell of the tile that lies in the grid,
// thread (j, k) = (warp, lane) over planes i = 0..kTX-1 of its column: v is
// the staged value at the cell, s its off-diagonal neighbour sum in the
// order of ops/stencil.neighbor_sum_ew (axis 0 upper, axis 0 lower, axis 1
// upper, ...; terms past the grid edge absent).
template <typename T, typename E, typename F>
__device__ __forceinline__ void tile_stencil(const T* box, const E* __restrict__ e0, const E* __restrict__ e1,
                                             const E* __restrict__ e2, const Origin& o, const TileList& t,
                                             F emit) {
  const int j = threadIdx.x / kTZ, k = threadIdx.x % kTZ;
  const int gj = o.y0 + j, gk = o.z0 + k;
  const bool in_col = gj < t.ny && gk < t.nz;
  const int sx = t.ny * t.nz;
  int q = (o.x0 * t.ny + gj) * t.nz + gk;
  T e0_lo = in_col && o.x0 > 0 ? ldg_as<T>(e0, q - sx) : T(0);
  const T* c = box + (kBY + j + 1) * kBZ + k + 1;
#pragma unroll
  for (int i = 0; i < kTX; ++i, q += sx, c += kPlane) {
    const int gi = o.x0 + i;
    const bool in = in_col && gi < t.nx;
    const T e2_c = in ? ldg_as<T>(e2, q) : T(0);
    T e2_lo = __shfl_up_sync(0xffffffffu, e2_c, 1);
    if (k == 0) e2_lo = in && gk > 0 ? ldg_as<T>(e2, q - 1) : T(0);
    if (in) {
      const T e0_c = ldg_as<T>(e0, q);
      T s = T(0);
      if (gi + 1 < t.nx) s += e0_c * c[kPlane];
      if (gi > 0) s += e0_lo * c[-kPlane];
      if (gj + 1 < t.ny) s += ldg_as<T>(e1, q) * c[kBZ];
      if (gj > 0) s += ldg_as<T>(e1, q - t.nz) * c[-kBZ];
      if (gk + 1 < t.nz) s += e2_c * c[1];
      if (gk > 0) s += e2_lo * c[-1];
      emit(q, i, *c, s);
      e0_lo = e0_c;
    }
  }
}

template <typename T, typename E>
struct StepArgs {
  const T* z;
  const T* p;
  const T* beta;
  const T* diag;
  const E* e0;
  const E* e1;
  const E* e2;
  T* p_out;
  T* ap_out;
  T* partials;  // one entry per tile (n_active used)
  T* dot;
  unsigned int* ticket;  // zero between launches
  TileList t;
  CoreWindow win;
  unsigned long long* launches;  // the launch counter, or null
};

template <typename T, typename E>
__global__ void __launch_bounds__(kBlock) cg_step_kernel(const StepArgs<T, E> a) {
  __shared__ T box[kBX * kPlane];
  __shared__ bool last;
  count_launch(a.launches);
  const Origin o = tile_origin(a.t);
  if (!o.active) {
    if (o.n_active == 0 && blockIdx.x == 0 && threadIdx.x == 0) *a.dot = T(0);
    zero_tile(a.p_out, o, a.t);
    zero_tile(a.ap_out, o, a.t);
    return;
  }
  const T beta = __ldg(a.beta);
  stage_box(box, o, a.t, [&](int q) { return __ldg(a.z + q) + beta * __ldg(a.p + q); });
  // The core window: the row of plane 0 within its stacked block, once per
  // tile; the planes after it step through the period.
  const int y = o.y0 + threadIdx.x / kTZ;
  const bool core_y = y >= a.win.lo_y && y < a.win.hi_y;
  const int row0 = o.x0 % a.win.period;
  T contrib = T(0);
  tile_stencil(box, a.e0, a.e1, a.e2, o, a.t, [&](int q, int i, T pc, T s) {
    const T ap = __ldg(a.diag + q) * pc - s;
    a.p_out[q] = pc;
    a.ap_out[q] = ap;
    int r = row0 + i;
    while (r >= a.win.period) r -= a.win.period;
    if (core_y && r >= a.win.lo_x && r < a.win.hi_x) contrib += pc * ap;
  });
  const T total = block_sum(contrib);
  if (threadIdx.x == 0) {
    a.partials[blockIdx.x] = total;
    __threadfence();
    last = atomicAdd(a.ticket, 1u) == unsigned(o.n_active - 1);
  }
  __syncthreads();
  if (!last) return;
  // The last block: every partial is written; sum them in index order.
  T v = T(0);
  for (int b = threadIdx.x; b < o.n_active; b += kBlock) v += __ldcg(a.partials + b);
  v = block_sum(v);
  if (threadIdx.x == 0) {
    *a.dot = v;
    *a.ticket = 0u;
  }
}

template <typename T, typename S, typename E>
struct ResidualArgs {
  const T* x;
  const S* b;
  const T* diag;
  const E* e0;
  const E* e1;
  const E* e2;
  S* r;
  TileList t;
  unsigned long long* launches;  // the launch counter, or null
};

template <typename T, typename S, typename E>
__global__ void __launch_bounds__(kBlock) residual_kernel(const ResidualArgs<T, S, E> a) {
  __shared__ T box[kBX * kPlane];
  count_launch(a.launches);
  const Origin o = tile_origin(a.t);
  if (!o.active) {
    zero_tile(a.r, o, a.t);
    return;
  }
  stage_box(box, o, a.t, [&](int q) { return __ldg(a.x + q); });
  tile_stencil(box, a.e0, a.e1, a.e2, o, a.t, [&](int q, int, T xc, T s) {
    store_as(a.r, q, ldg_as<T>(a.b, q) - (__ldg(a.diag + q) * xc - s));
  });
}

template <typename T>
__global__ void __launch_bounds__(kSumBlock)
sum_partials_kernel(const T* __restrict__ partials, long long count,
                    T* __restrict__ out) {
  T v = T(0);
  for (long long q = threadIdx.x; q < count; q += blockDim.x) v += partials[q];
  v = block_sum(v);
  if (threadIdx.x == 0) *out = v;
}

// The TileList of an (nx, ny, nz) grid, or false when the tiles are not
// the kernels' tile, the lists' capacity n_tiles is not the grid's tile
// count, or the tiled grid is too large for 32-bit cell indices.
inline bool tile_list(const void* active, const void* dead, const void* counts, int n_tiles, int nx,
                      int ny, int nz, int lx, int ty, int tz, TileList* t) {
  if (lx != kTX || ty != kTY || tz != kTZ || nx < 0 || ny < 0 || nz < 0 || counts == nullptr) return false;
  const long long gx = (nx + kTX - 1) / kTX, gy = (ny + kTY - 1) / kTY, gz = (nz + kTZ - 1) / kTZ;
  if (gx * gy * gz != n_tiles || (gx * kTX + 1) * ny * nz >= (1LL << 31)) return false;
  *t = TileList{static_cast<const int*>(active), static_cast<const int*>(dead),
                static_cast<const int*>(counts), nx, ny, nz, int(gy), int(gz)};
  return true;
}

template <typename T, typename E>
cudaError_t launch_cg_step(StepArgs<T, E> a, int n_tiles, cudaStream_t stream) {
  if (n_tiles == 0) return cudaMemsetAsync(a.dot, 0, sizeof(T), stream);
  cg_step_kernel<T, E><<<n_tiles, kBlock, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, typename S, typename E>
cudaError_t launch_residual(ResidualArgs<T, S, E> a, int n_tiles, cudaStream_t stream) {
  if (n_tiles == 0) return cudaSuccess;
  residual_kernel<T, S, E><<<n_tiles, kBlock, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace gmg

#define GMG_DISPATCH(CALL)                                                   \
  if (fdt == kF32 && edt == kF32) return CALL(float, float);                 \
  if (fdt == kF32 && edt == kBF16) return CALL(float, __nv_bfloat16);        \
  if (fdt == kF64 && edt == kF64) return CALL(double, double);               \
  if (fdt == kF64 && edt == kF32) return CALL(double, float);                \
  if (fdt == kF64 && edt == kBF16) return CALL(double, __nv_bfloat16);       \
  return (int)cudaErrorInvalidValue;

// active / dead: the active and dead tile ids of the (lx, ty, tz) tiling,
// which must be the kernels' (8, 8, 32), each list padded to the n_tiles
// tiles of the grid; counts: their lengths on the device (n_active,
// n_dead, ...), read by the kernel, which launches one block per tile;
// partials: n_tiles entries of the field type; dot: the 0-d output;
// ticket: one 32-bit word, zero before the launch (the launch leaves it
// zero).
// period, lo_x, hi_x, lo_y, hi_y: the dot's core window.  launches: the
// launch counter (one unsigned 64-bit word, raised by one per launch), or
// null.
extern "C" int gmg_cg_step(int fdt, int edt, const void* z, const void* p,
                           const void* beta, const void* diag, const void* e0,
                           const void* e1, const void* e2, void* p_out,
                           void* ap_out, void* partials, void* dot, void* ticket,
                           const void* active, const void* dead, const void* counts,
                           int n_tiles, int nx, int ny, int nz, int lx, int ty,
                           int tz, int period, int lo_x, int hi_x, int lo_y,
                           int hi_y, void* launches, void* stream) {
  using namespace gmg;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  TileList t;
  if (period <= 0 || !tile_list(active, dead, counts, n_tiles, nx, ny, nz, lx, ty, tz, &t))
    return (int)cudaErrorInvalidValue;
  const CoreWindow win{period, lo_x, hi_x, lo_y, hi_y};
#define GMG_STEP(T, E)                                                                       \
  launch_cg_step<T, E>(                                                                      \
      StepArgs<T, E>{static_cast<const T*>(z), static_cast<const T*>(p),                     \
                     static_cast<const T*>(beta), static_cast<const T*>(diag),               \
                     static_cast<const E*>(e0), static_cast<const E*>(e1),                   \
                     static_cast<const E*>(e2), static_cast<T*>(p_out),                      \
                     static_cast<T*>(ap_out), static_cast<T*>(partials), static_cast<T*>(dot), \
                     static_cast<unsigned int*>(ticket), t, win,                             \
                     static_cast<unsigned long long*>(launches)},                            \
      n_tiles, s)
  GMG_DISPATCH(GMG_STEP)
#undef GMG_STEP
}

// fdt: type of x and diag; sdt: type of b and r (fdt, or bf16 over f32);
// the tiles and launches as for gmg_cg_step.
extern "C" int gmg_residual(int fdt, int sdt, int edt, const void* x,
                            const void* b, const void* diag, const void* e0,
                            const void* e1, const void* e2, void* r,
                            const void* active, const void* dead, const void* counts,
                            int n_tiles, int nx, int ny, int nz, int lx, int ty,
                            int tz, void* launches, void* stream) {
  using namespace gmg;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  TileList t;
  if (!tile_list(active, dead, counts, n_tiles, nx, ny, nz, lx, ty, tz, &t))
    return (int)cudaErrorInvalidValue;
#define GMG_RES_ST(T, S, E)                                                                \
  launch_residual<T, S, E>(                                                                \
      ResidualArgs<T, S, E>{static_cast<const T*>(x), static_cast<const S*>(b),            \
                            static_cast<const T*>(diag), static_cast<const E*>(e0),        \
                            static_cast<const E*>(e1), static_cast<const E*>(e2),          \
                            static_cast<S*>(r), t,                                         \
                            static_cast<unsigned long long*>(launches)},                   \
      n_tiles, s)
#define GMG_RES(T, E) GMG_RES_ST(T, T, E)
  if (sdt == fdt) {
    GMG_DISPATCH(GMG_RES)
  }
#undef GMG_RES
  if (fdt == kF32 && sdt == kBF16) {
    if (edt == kF32) return GMG_RES_ST(float, __nv_bfloat16, float);
    if (edt == kBF16) return GMG_RES_ST(float, __nv_bfloat16, __nv_bfloat16);
  }
#undef GMG_RES_ST
  return (int)cudaErrorInvalidValue;
}

// Sum `count` per-block partials into the 0-d `out` in a fixed order
// (one block; thread t adds partials t, t+1024, ... then a shuffle tree).
extern "C" int gmg_sum_partials(int fdt, const void* partials, long long count,
                                void* out, void* stream) {
  using namespace gmg;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fdt == kF32) {
    sum_partials_kernel<float><<<1, kSumBlock, 0, s>>>(
        static_cast<const float*>(partials), count, static_cast<float*>(out));
  } else if (fdt == kF64) {
    sum_partials_kernel<double><<<1, kSumBlock, 0, s>>>(
        static_cast<const double*>(partials), count, static_cast<double*>(out));
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
