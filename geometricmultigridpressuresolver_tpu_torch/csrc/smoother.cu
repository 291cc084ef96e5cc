// Kernel 1: the multigrid smoothing block, a chunk of its pass stack per
// launch.
//
// Replaces ops/pallas_smoother.py::fused_smooth (kernel body _make_kernel)
// of the JAX package, with its band-strip variant (b_strip_pass) and its
// bfloat16 field storage.  The Pallas kernel runs a chunk of at most H = 8
// passes on a VMEM slab with an H-cell halo, skips slabs without a solvable
// cell, and forms the downstroke residual from the same slab.  One launch of
// this kernel computes what a chunk of `n_pass` consecutive passes of the
// schedule computes over the whole grid, skips the tiles without a cell any
// pass can change, and forms the residual and the dot in the same launch.
// Pass kinds, with S the off-diagonal neighbour sum:
//   'b' (code 0): a*x + wb*(b+S), a = 1 - w*band, wb = w*band*inv_diag --
//                 the identity off the band, so it runs over the band cells
//                 alone (the band-strip variant: band-restricted and
//                 full-grid configurations give the same launches and the
//                 same numbers);
//   'r'/'k' (codes 1/2): where(colour, inv_diag*(b+S), x), colour =
//                 (i+j+k)%2 (red = 0), over the cells of the colour alone;
//   'j' (code 3): (1-w)*x + w*inv_diag*(b+S), over every cell.
// Every pass is a simultaneous update, as in the plain version
// (ops/fused_smoother.py::smooth_level_torch).
//
// Design.  The block is one cooperative launch: a grid of co-resident CUDA
// blocks that walks the pass list with a grid-wide barrier between passes,
// instead of a halo per tile.  A first design kept each tile's pass stack
// in shared memory (tiles streamed along x, a trapezoid of stages, the
// coefficients of the planes in flight staged in shared memory): on the
// 256^3 fine level it took 1.7-2.8 ms per block, against 1.65 ms for one
// launch per pass -- the halo recomputed at every stage (2-2.5x the cells),
// a block barrier per stage and plane (40-odd planes of 4-5 stages per
// tile), and the 'b' passes, which change only the band (2.4% of the fine
// level), computed and copied the whole window at every stage.  Here each
// pass touches what it changes: a 'b' pass the compacted list of band
// cells, a GS pass the cells of its colour in the active tiles, a 'j' pass
// every cell of the active tiles.  Two work buffers A and B hold x; they
// agree everywhere except, after 'b' passes, on band cells: a 'b' pass
// reads the current buffer and writes the band cells of the other, which
// then becomes current (the target already agrees off the band); a GS pass
// updates its colour in place in both (a colour reads only the other
// colour), after the band cells are made to agree; a 'j' pass writes the
// other buffer everywhere and copies it back.  The work buffers are zero on
// dead tiles (the wrapper allocates them zeroed), which is the pass
// sequence's output there (fields are zero outside the solvable set, edge
// weights zero across its border).  The lists' lengths come from the
// device (`counts`, written by the kernels that built the lists; the JAX
// package's `_compact_blocks` keeps its active-slab count on the device
// too), read once per launch; the grid does not depend on them and tile t
// goes to block t % gridDim.x whatever they are, so a launch gives the bits
// it gave with host counts, and a captured frame replays with lengths the
// host never saw.  Buffer reads after a barrier bypass L1
// (ld.global.cg): another SM may have written the line.
//
// Variants.  A null x_in is a zero start (x == 0, the downstroke): nothing
// is read for x, and the first pass reads no neighbour.  With `partials`,
// the last step also writes one partial of <x_new, b> per CUDA block over
// the cells of the CoreWindow (the CG rho on the fine upstroke; a stacked
// grid of haloed blocks counts each global cell once), summed in a fixed
// order by sum_partials (each block owns a fixed set of tiles).  With r_out
// it writes r = b - (diag*x' - S(x')) with the plain residual's arithmetic
// (the Pallas kernel's :582-588); no spare halo ring is needed.
//
// Types: T computes; b, inv_diag, x_store and r are stored as S; x_in is XI;
// the work buffers and diag (the residual's) are T.  S = T for float and
// double fields.  With bfloat16 field storage S is bfloat16 and T float:
// the first chunk reads the stored x, chunks between keep x in float
// buffers, the last narrows once into x_store, and the residual is formed
// from the unrounded float x (the Pallas kernel's compute_dtype,
// ops/pallas_smoother.py:466-480 and :590).
//
// What bounds it on the H100.  Device memory: per 8-pass block with bf16
// edge weights and fp32 fields, a copy of x into both buffers over the
// active tiles (4 B read, 8 B written a cell), each GS pass about 19 B read
// and 8 B written per cell of its colour (the colour's loads use half of
// each sector), each 'b' pass about 30 B per band cell, and the final pass
// with the dot or the residual; plus one grid barrier (a few microseconds)
// per pass.  On an H100 80GB HBM3 at 700 W the 256^3 fine block with its
// dot takes 0.54 ms, about 8x the time to read its inputs once on the
// solvable cells (chip_smoke.py phase 4, PERF.md section 6).
#include "common.cuh"

namespace gmg {

constexpr int kCoopThreads = 512;

template <typename T, typename S, typename XI, typename E>
struct ChunkArgs {
  const XI* x_in;  // null: x == 0 (no x read)
  T* buf_a;        // work buffers, zero on dead tiles; A holds the result
  T* buf_b;
  S* x_store;  // null: none
  S* r_out;    // null: no residual
  const S* b;
  const S* inv_diag;
  const T* diag;
  const E* e0;
  const E* e1;
  const E* e2;
  const int* band_cells;  // flat indices of the band cells, ascending (padded)
  const int* tiles;  // active tiles, ascending (x-major over the (lx, ty, tz) tiling; padded)
  const int* counts;  // device: n_active, n_dead, n_band
  T* partials;  // one per CUDA block, or null
  unsigned int* barrier;  // two zeroed words: arrival count, generation
  int nx, ny, nz;
  int lx_shift, ty_shift, tz_shift;  // the core tile, powers of two
  int gy, gz;                        // tiles along y and z
  int n_pass;
  int kinds;  // 2 bits per pass, pass 0 lowest: 0 b, 1 r, 2 k, 3 j
  T w, one_minus_w;
  CoreWindow win;
  unsigned long long* launches;  // the launch counter, or null
};

__device__ __forceinline__ float load_cg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ double load_cg(const double* p) { return __ldcg(p); }

// Wait until every block of the grid has arrived (all are co-resident: the
// launch is cooperative).  Writes before it are visible to reads after it.
__device__ __forceinline__ void grid_barrier(unsigned int* barrier) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned int* gen = barrier + 1;
    const unsigned int seen = *gen;
    __threadfence();
    if (atomicAdd(barrier, 1u) == gridDim.x - 1) {
      atomicExch(barrier, 0u);
      __threadfence();
      atomicAdd(barrier + 1, 1u);
    } else {
      while (*gen == seen) __nanosleep(64);
    }
    __threadfence();
  }
  __syncthreads();
}

// The neighbour sum of buffer x at cell (i, j, k), flat index q, in the
// order of ops/stencil.neighbor_sum (axis 0 upper, axis 0 lower, axis 1
// upper, ...); reads past the grid edge are absent.
template <typename T, typename E>
__device__ __forceinline__ T neighbor_sum_cg(const T* x, const E* e0, const E* e1, const E* e2,
                                             long long q, int i, int j, int k, int nx, int ny,
                                             int nz) {
  const long long sx = (long long)ny * nz;
  T v = T(0);
  if (i + 1 < nx) v += load_as<T>(e0, q) * load_cg(x + q + sx);
  if (i > 0) v += load_as<T>(e0, q - sx) * load_cg(x + q - sx);
  if (j + 1 < ny) v += load_as<T>(e1, q) * load_cg(x + q + nz);
  if (j > 0) v += load_as<T>(e1, q - nz) * load_cg(x + q - nz);
  if (k + 1 < nz) v += load_as<T>(e2, q) * load_cg(x + q + 1);
  if (k > 0) v += load_as<T>(e2, q - 1) * load_cg(x + q - 1);
  return v;
}

// Calls f(q, i, j, k) for every cell of the n_active active tiles that lies
// in the grid (with `color` >= 0 only the cells of that colour), each block
// over its own tiles: tile t goes to block t % gridDim.x.
template <typename A, typename F>
__device__ __forceinline__ void for_active_cells(const A& a, int n_active, int color, F f) {
  const int per_tile = 1 << (a.lx_shift + a.ty_shift + a.tz_shift);
  const int cells = color >= 0 ? per_tile >> 1 : per_tile;
  const int zs = color >= 0 ? a.tz_shift - 1 : a.tz_shift;
  const long long sx = (long long)a.ny * a.nz;
  for (int t = blockIdx.x; t < n_active; t += gridDim.x) {
    const int tile = a.tiles[t];
    const int x0 = tile / (a.gy * a.gz) << a.lx_shift;
    const int y0 = tile / a.gz % a.gy << a.ty_shift;
    const int z0 = tile % a.gz << a.tz_shift;
    for (int n = threadIdx.x; n < cells; n += blockDim.x) {
      const int i = x0 + (n >> (a.ty_shift + zs));
      const int j = y0 + ((n >> zs) & ((1 << a.ty_shift) - 1));
      int k = z0 + (n & ((1 << zs) - 1));
      if (color >= 0) k = z0 + 2 * (k - z0) + ((color + i + j + z0) & 1);
      if (i < a.nx && j < a.ny && k < a.nz) f(i * sx + (long long)j * a.nz + k, i, j, k);
    }
  }
}

// Calls f(q, i, j, k) for each of the n_band band cells, spread over the
// whole grid.
template <typename A, typename F>
__device__ __forceinline__ void for_band_cells(const A& a, int n_band, F f) {
  const int plane = a.ny * a.nz;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < n_band; e += gridDim.x * blockDim.x) {
    const int q = a.band_cells[e];
    const int i = q / plane, r = q - i * plane, j = r / a.nz;
    f((long long)q, i, j, r - j * a.nz);
  }
}

template <typename T, typename S, typename XI, typename E>
__global__ void __launch_bounds__(kCoopThreads)
smooth_chunk_kernel(const ChunkArgs<T, S, XI, E> a) {
  count_launch(a.launches);
  // The lists' lengths, written on the device by whatever built them.
  const int n_active = __ldg(a.counts), n_band = __ldg(a.counts + 2);
  const bool zero = a.x_in == nullptr;
  // The buffer that holds the current x, and the other one; `agree`: they
  // are equal on the band cells too.
  T* cur = a.buf_a;
  T* oth = a.buf_b;
  bool agree = true;
  if (!zero) {
    for_active_cells(a, n_active, -1, [&](long long q, int, int, int) {
      const T v = load_as<T>(a.x_in, q);
      a.buf_a[q] = v;
      a.buf_b[q] = v;
    });
    grid_barrier(a.barrier);
  }
  for (int s = 0; s < a.n_pass; ++s) {
    const int code = (a.kinds >> (2 * s)) & 3;
    const bool from_zero = zero && s == 0;  // x == 0: no x, no neighbour
    if (code == 0) {
      // Band cells: read cur, write oth, which then is current.
      for_band_cells(a, n_band, [&](long long q, int i, int j, int k) {
        const T xc = from_zero ? T(0) : load_cg(cur + q);
        const T v = from_zero ? T(0) : neighbor_sum_cg(cur, a.e0, a.e1, a.e2, q, i, j, k, a.nx, a.ny, a.nz);
        const T id = load_as<T>(a.inv_diag, q);
        // band == 1 here: a = 1 - w, wb = w * inv_diag (the Pallas kernel's
        // hoisted a/wb products, :507-509).
        oth[q] = (T(1) - a.w) * xc + (a.w * id) * (load_as<T>(a.b, q) + v);
      });
      T* t = cur;
      cur = oth;
      oth = t;
      agree = false;
    } else if (code == 3) {
      // Every cell: read cur, write oth; then copy oth back into cur.
      for_active_cells(a, n_active, -1, [&](long long q, int i, int j, int k) {
        const T xc = from_zero ? T(0) : load_cg(cur + q);
        const T v = from_zero ? T(0) : neighbor_sum_cg(cur, a.e0, a.e1, a.e2, q, i, j, k, a.nx, a.ny, a.nz);
        const T id = load_as<T>(a.inv_diag, q);
        oth[q] = a.one_minus_w * xc + (a.w * id) * (load_as<T>(a.b, q) + v);
      });
      grid_barrier(a.barrier);
      for_active_cells(a, n_active, -1, [&](long long q, int, int, int) { cur[q] = load_cg(oth + q); });
      agree = true;
    } else {
      if (!agree) {
        for_band_cells(a, n_band, [&](long long q, int, int, int) { oth[q] = load_cg(cur + q); });
        grid_barrier(a.barrier);
        agree = true;
      }
      // The cells of one colour, in place in both buffers.
      for_active_cells(a, n_active, code - 1, [&](long long q, int i, int j, int k) {
        const T v = from_zero ? T(0) : neighbor_sum_cg(cur, a.e0, a.e1, a.e2, q, i, j, k, a.nx, a.ny, a.nz);
        const T xn = load_as<T>(a.inv_diag, q) * (load_as<T>(a.b, q) + v);
        cur[q] = xn;
        oth[q] = xn;
      });
    }
    grid_barrier(a.barrier);
  }
  if (cur != a.buf_a) {
    // A differs from the current buffer on band cells at most.
    for_band_cells(a, n_band, [&](long long q, int, int, int) { a.buf_a[q] = load_cg(cur + q); });
    grid_barrier(a.barrier);
  }
  T contrib = T(0);
  if (a.x_store || a.partials || a.r_out) {
    for_active_cells(a, n_active, -1, [&](long long q, int i, int j, int k) {
      const T xv = load_cg(a.buf_a + q);
      if (a.x_store) store_as(a.x_store, q, xv);
      if (a.partials && in_core(a.win, Cell{i, j, k})) contrib += xv * load_as<T>(a.b, q);
      if (a.r_out) {
        const T v = neighbor_sum_cg(a.buf_a, a.e0, a.e1, a.e2, q, i, j, k, a.nx, a.ny, a.nz);
        store_as(a.r_out, q, load_as<T>(a.b, q) - (a.diag[q] * xv - v));
      }
    });
  }
  if (a.partials) {
    const T total = block_sum(contrib);
    if (threadIdx.x == 0) a.partials[blockIdx.x] = total;
  }
}

inline int log2_exact(int v) {
  int s = 0;
  while ((1 << s) < v) ++s;
  return (1 << s) == v ? s : -1;
}

// Blocks of the cooperative grid: as many as can be resident together.
template <typename T, typename S, typename XI, typename E>
int chunk_grid() {
  int per_sm = 0, sms = 0, dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, smooth_chunk_kernel<T, S, XI, E>,
                                                    kCoopThreads, 0) != cudaSuccess)
    return -1;
  return per_sm * sms;
}

template <typename T, typename S, typename XI, typename E>
cudaError_t launch_chunk(int n_pass, int kinds, double damping, const void* x_in,
                         void* buf_a, void* buf_b, void* x_store, void* r_out,
                         const void* b, const void* inv_diag, const void* diag,
                         const void* e0, const void* e1, const void* e2,
                         const void* band_cells, const void* tiles,
                         const void* counts, int nx, int ny, int nz, int lx, int ty,
                         int tz, void* partials, int grid, void* barrier,
                         CoreWindow win, void* launches, cudaStream_t stream) {
  ChunkArgs<T, S, XI, E> a;
  a.lx_shift = log2_exact(lx), a.ty_shift = log2_exact(ty), a.tz_shift = log2_exact(tz);
  if (a.lx_shift < 0 || a.ty_shift < 0 || a.tz_shift < 1 || grid <= 0 ||
      (long long)nx * ny * nz >= (1LL << 31))
    return cudaErrorInvalidValue;
  a.x_in = static_cast<const XI*>(x_in);
  a.buf_a = static_cast<T*>(buf_a);
  a.buf_b = static_cast<T*>(buf_b);
  a.x_store = static_cast<S*>(x_store);
  a.r_out = static_cast<S*>(r_out);
  a.b = static_cast<const S*>(b);
  a.inv_diag = static_cast<const S*>(inv_diag);
  a.diag = static_cast<const T*>(diag);
  a.e0 = static_cast<const E*>(e0);
  a.e1 = static_cast<const E*>(e1);
  a.e2 = static_cast<const E*>(e2);
  a.band_cells = static_cast<const int*>(band_cells);
  a.tiles = static_cast<const int*>(tiles);
  a.counts = static_cast<const int*>(counts);
  a.partials = static_cast<T*>(partials);
  a.barrier = static_cast<unsigned int*>(barrier);
  a.nx = nx, a.ny = ny, a.nz = nz;
  a.gy = (ny + ty - 1) / ty, a.gz = (nz + tz - 1) / tz;
  a.n_pass = n_pass;
  a.kinds = kinds;
  a.w = T(damping);
  a.one_minus_w = T(1.0 - damping);
  a.win = win;
  a.launches = static_cast<unsigned long long*>(launches);
  void* args[] = {&a};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(smooth_chunk_kernel<T, S, XI, E>),
                                     dim3(grid), dim3(kCoopThreads), args, 0, stream);
}

}  // namespace gmg

#define GMG_CHUNK_TYPES(CALL)                                                          \
  if (fdt == kF32 && sdt == kF32 && xdt == kF32) {                                     \
    if (edt == kF32) return CALL(float, float, float, float);                          \
    if (edt == kBF16) return CALL(float, float, float, __nv_bfloat16);                 \
  }                                                                                    \
  if (fdt == kF64 && sdt == kF64 && xdt == kF64) {                                     \
    if (edt == kF64) return CALL(double, double, double, double);                      \
    if (edt == kF32) return CALL(double, double, double, float);                       \
    if (edt == kBF16) return CALL(double, double, double, __nv_bfloat16);              \
  }                                                                                    \
  if (fdt == kF32 && sdt == kBF16 && xdt == kBF16) {                                   \
    if (edt == kF32) return CALL(float, __nv_bfloat16, __nv_bfloat16, float);         \
    if (edt == kBF16) return CALL(float, __nv_bfloat16, __nv_bfloat16, __nv_bfloat16); \
  }                                                                                    \
  if (fdt == kF32 && sdt == kBF16 && xdt == kF32) {                                    \
    if (edt == kF32) return CALL(float, __nv_bfloat16, float, float);                  \
    if (edt == kBF16) return CALL(float, __nv_bfloat16, float, __nv_bfloat16);         \
  }

// The number of CUDA blocks (and dot partials) of a chunk launch for these
// types, or -1.
extern "C" int gmg_smooth_chunk_grid(int fdt, int sdt, int xdt, int edt) {
  using namespace gmg;
#define GMG_GRID(T, S, XI, E) chunk_grid<T, S, XI, E>()
  GMG_CHUNK_TYPES(GMG_GRID)
#undef GMG_GRID
  return -1;
}

// One chunk of the pass stack.  fdt: compute type T; sdt: storage type S of
// b / inv_diag / x_store / r_out; xdt: type of x_in; edt: edge-weight type.
// Instances: float and double fields (S = XI = T) with float/bf16 (and
// double) edge weights, and bfloat16 storage over float compute with x_in
// bfloat16 (the stored x) or float (an intermediate buffer).  kinds: the
// n_pass pass codes, 2 bits each, first pass lowest.  A null x_in is a zero
// start, a null r_out no residual.  buf_a, buf_b: zeroed work buffers of
// type T; buf_a holds the result.  band_cells: the band cells; tiles: the
// active tiles of the (lx, ty, tz) tiling (powers of two); counts: three
// int32 on the device, (n_active, n_dead, n_band), the lengths of the two
// lists, read by the kernel (the lists may be padded past them).  grid: the CUDA blocks of the launch, gmg_smooth_chunk_grid(...)
// for these types (a larger grid cannot be co-resident and the launch
// fails); partials: grid entries, or null.  barrier: two zeroed 32-bit
// words.  period, lo_x, hi_x, lo_y, hi_y: the dot's core window (the full
// grid without a stacked layout).  launches: the launch counter (one
// unsigned 64-bit word, raised by one per launch), or null.
extern "C" int gmg_smooth_chunk(int fdt, int sdt, int xdt, int edt, int n_pass,
                                int kinds, double damping, const void* x_in,
                                void* buf_a, void* buf_b, void* x_store,
                                void* r_out, const void* b,
                                const void* inv_diag, const void* diag,
                                const void* e0, const void* e1, const void* e2,
                                const void* band_cells, const void* tiles,
                                const void* counts, int nx,
                                int ny, int nz, int lx, int ty, int tz,
                                void* partials, int grid, void* barrier,
                                int period, int lo_x, int hi_x, int lo_y,
                                int hi_y, void* launches, void* stream) {
  using namespace gmg;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (period <= 0 || n_pass < 1 || n_pass > 15 || counts == nullptr)
    return (int)cudaErrorInvalidValue;
  const CoreWindow win{period, lo_x, hi_x, lo_y, hi_y};
#define GMG_CHUNK(T, S, XI, E)                                                          \
  launch_chunk<T, S, XI, E>(n_pass, kinds, damping, x_in, buf_a, buf_b, x_store, r_out, \
                            b, inv_diag, diag, e0, e1, e2, band_cells, tiles, counts,   \
                            nx, ny, nz, lx, ty, tz, partials, grid,                     \
                            barrier, win, launches, s)
  GMG_CHUNK_TYPES(GMG_CHUNK)
#undef GMG_CHUNK
  return (int)cudaErrorInvalidValue;
}
