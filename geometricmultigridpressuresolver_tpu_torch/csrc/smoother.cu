// Kernel 1: one pass of the multigrid smoothing block, and its
// band-restricted boundary pass.
//
// Replaces ops/pallas_smoother.py::fused_smooth (kernel body _make_kernel)
// of the JAX package.  The Pallas kernel runs the whole pass stack of a
// level (b^k, r, k, b^k) on VMEM-resident slabs with an H-cell halo; here
// each pass is one launch, one thread per cell with z fastest so that loads
// coalesce.  Pass kinds, with S the off-diagonal neighbour sum:
//   'b' (kind 0): a*x + wb*(b+S), a = 1 - w*band, wb = w*band*inv_diag.
//                 The identity off the band, so non-band cells skip S.
//                 A simultaneous update: must not run in place.
//   'r'/'k' (kind 1): where(color, inv_diag*(b+S), x), colour = (i+j+k)%2
//                 (red = 0).  A colour reads only the other colour, so the
//                 pass may run in place (x_in == x_out).
//   'j' (kind 2): (1-w)*x + w*inv_diag*(b+S).  Simultaneous, not in place.
// A null x_in reads as x == 0 (the V-cycle downstroke's zero start).
// With `partials` the pass also writes one partial of <x_new, b> per block
// (the CG rho when this is the fine upstroke's last pass); only cells in
// the core window add to it (common.cuh: CoreWindow), so on a stacked grid
// of haloed blocks the dot counts each global cell once.  The full window
// makes it the plain dot, bit for bit.
//
// Types: T computes; b, inv_diag and the optional narrow output `x_store`
// are stored as S; x_in is XI and x_out is T.  S = T for float and double
// fields.  With bfloat16 field storage (config.mg_field_dtype, the Pallas
// kernel's compute_dtype, ops/pallas_smoother.py:466-480) S is bfloat16 and
// T float: the first pass reads the stored x, the passes between keep x in
// float buffers, and the last pass narrows once into x_store -- the Pallas
// kernel keeps the whole chunk in fp32 on its slab and narrows once
// (:590).  The dot partials are float products of the unrounded x.
//
// The band pass (band_pass_kernel) replaces the band-strip variant of the
// same kernel (b_strip_pass, ops/pallas_smoother.py:513-554, launched over
// the split slabs at :751-771).  It is a 'b' pass over a compacted int32
// list of the level's band cells, built once per solve in ascending linear
// order so that z-neighbours coalesce; other cells of x_out are not
// written.  That is right only when x_out already equals x_in off the band
// (the wrapper's buffer plan, ops/fused_smoother.py::pass_plan, says when).
// Its arithmetic is the full pass's expression, so it gives the same
// numbers.
//
// What bounds it on the H100: device memory.  A full pass reads x (7 points,
// mostly from L1/L2), b, inv_diag, three edge-weight grids and the band, and
// writes x: about 4+4+4+3*2+1+4 = 23 B/cell with bf16 edge weights and fp32
// fields (bf16 fields: 2 B for each of b and inv_diag).  A band pass moves
// ~23 B plus a 4-byte index per band cell and nothing for the others.
#include "common.cuh"

namespace gmg {

template <typename T, typename S, typename XI, typename E, int KIND>
__global__ void __launch_bounds__(kBlock)
smooth_pass_kernel(const XI* x_in, T* x_out, S* __restrict__ x_store,
                   const S* __restrict__ b, const S* __restrict__ inv_diag,
                   const E* __restrict__ e0, const E* __restrict__ e1,
                   const E* __restrict__ e2, const int8_t* __restrict__ band,
                   int nx, int ny, int nz, int color, T w, T one_minus_w,
                   T* __restrict__ partials, CoreWindow win) {
  const long long n = (long long)nx * ny * nz;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  T contrib = T(0);
  if (idx < n) {
    const Cell c = cell_of(idx, ny, nz);
    const T xc = x_in ? load_as<T>(x_in, idx) : T(0);
    bool update;
    if (KIND == 0) {
      update = band[idx] != 0;
    } else if (KIND == 1) {
      update = ((c.i + c.j + c.k) & 1) == color;
    } else {
      update = true;
    }
    T xn = xc;
    if (update) {
      auto val = [x_in](long long q) { return x_in ? load_as<T>(x_in, q) : T(0); };
      const T s = neighbor_sum<T, E>(val, e0, e1, e2, idx, c, nx, ny, nz);
      const T bb = load_as<T>(b, idx);
      const T id = load_as<T>(inv_diag, idx);
      if (KIND == 0) {
        // band == 1 here: a = 1 - w, wb = w * inv_diag (the Pallas kernel's
        // hoisted a/wb products, ops/pallas_smoother.py:507-509).
        const T a = T(1) - w;
        const T wb = w * id;
        xn = a * xc + wb * (bb + s);
      } else if (KIND == 1) {
        xn = id * (bb + s);
      } else {
        xn = one_minus_w * xc + (w * id) * (bb + s);
      }
    }
    // In place, the cells this pass does not update are already right.
    if (x_out && (update || (const void*)x_out != (const void*)x_in)) x_out[idx] = xn;
    if (x_store) store_as(x_store, idx, xn);
    if (partials && in_core(win, c)) contrib = xn * load_as<T>(b, idx);
  }
  if (partials) {
    const T total = block_sum(contrib);
    if (threadIdx.x == 0) partials[blockIdx.x] = total;
  }
}

template <typename T, typename S, typename E>
__global__ void __launch_bounds__(kBlock)
band_pass_kernel(const T* __restrict__ x_in, T* __restrict__ x_out,
                 const S* __restrict__ b, const S* __restrict__ inv_diag,
                 const E* __restrict__ e0, const E* __restrict__ e1,
                 const E* __restrict__ e2, const int* __restrict__ cells,
                 long long count, int nx, int ny, int nz, T w) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= count) return;
  const long long idx = cells[t];
  const Cell c = cell_of(idx, ny, nz);
  auto val = [x_in](long long q) { return x_in[q]; };
  // The full pass's expression, term for term (see smooth_pass_kernel).
  const T xc = x_in[idx];
  const T s = neighbor_sum<T, E>(val, e0, e1, e2, idx, c, nx, ny, nz);
  const T bb = load_as<T>(b, idx);
  const T id = load_as<T>(inv_diag, idx);
  const T a = T(1) - w;
  const T wb = w * id;
  x_out[idx] = a * xc + wb * (bb + s);
}

template <typename T, typename S, typename XI, typename E>
cudaError_t launch_pass(int kind, int color, double damping, const void* x_in,
                        void* x_out, void* x_store, const void* b,
                        const void* inv_diag, const void* e0, const void* e1,
                        const void* e2, const void* band, int nx, int ny,
                        int nz, void* partials, CoreWindow win,
                        cudaStream_t stream) {
  const long long n = (long long)nx * ny * nz;
  if (n == 0) return cudaSuccess;
  const T w = T(damping);
  const T omw = T(1.0 - damping);
  const dim3 grid(num_blocks(n));
  const XI* xi = static_cast<const XI*>(x_in);
  T* xo = static_cast<T*>(x_out);
  S* xs = static_cast<S*>(x_store);
  const S* bp = static_cast<const S*>(b);
  const S* ip = static_cast<const S*>(inv_diag);
  const E* w0 = static_cast<const E*>(e0);
  const E* w1 = static_cast<const E*>(e1);
  const E* w2 = static_cast<const E*>(e2);
  const int8_t* bd = static_cast<const int8_t*>(band);
  T* pp = static_cast<T*>(partials);
  switch (kind) {
    case 0:
      smooth_pass_kernel<T, S, XI, E, 0><<<grid, kBlock, 0, stream>>>(
          xi, xo, xs, bp, ip, w0, w1, w2, bd, nx, ny, nz, color, w, omw, pp, win);
      break;
    case 1:
      smooth_pass_kernel<T, S, XI, E, 1><<<grid, kBlock, 0, stream>>>(
          xi, xo, xs, bp, ip, w0, w1, w2, bd, nx, ny, nz, color, w, omw, pp, win);
      break;
    case 2:
      smooth_pass_kernel<T, S, XI, E, 2><<<grid, kBlock, 0, stream>>>(
          xi, xo, xs, bp, ip, w0, w1, w2, bd, nx, ny, nz, color, w, omw, pp, win);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T, typename S, typename E>
cudaError_t launch_band(double damping, const void* x_in, void* x_out,
                        const void* b, const void* inv_diag, const void* e0,
                        const void* e1, const void* e2, const void* cells,
                        long long count, int nx, int ny, int nz,
                        cudaStream_t stream) {
  if (count == 0) return cudaSuccess;
  band_pass_kernel<T, S, E><<<num_blocks(count), kBlock, 0, stream>>>(
      static_cast<const T*>(x_in), static_cast<T*>(x_out),
      static_cast<const S*>(b), static_cast<const S*>(inv_diag),
      static_cast<const E*>(e0), static_cast<const E*>(e1),
      static_cast<const E*>(e2), static_cast<const int*>(cells), count, nx,
      ny, nz, T(damping));
  return cudaGetLastError();
}

}  // namespace gmg

// fdt: compute type T; sdt: storage type S of b / inv_diag / x_store; xdt:
// type of x_in; edt: edge-weight type.  Instances: float and double fields
// (S = XI = T) with float/bf16 (and double) edge weights, and bfloat16
// storage over float compute with x_in bfloat16 (the stored x) or float
// (an intermediate buffer).  period, lo_x, hi_x, lo_y, hi_y: the dot's
// core window (the full grid without a stacked layout).
extern "C" int gmg_smooth_pass(int fdt, int sdt, int xdt, int edt, int kind,
                               int color, double damping, const void* x_in,
                               void* x_out, void* x_store, const void* b,
                               const void* inv_diag, const void* e0,
                               const void* e1, const void* e2,
                               const void* band, int nx, int ny, int nz,
                               void* partials, int period, int lo_x,
                               int hi_x, int lo_y, int hi_y, void* stream) {
  using namespace gmg;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (period <= 0) return (int)cudaErrorInvalidValue;
  const CoreWindow win{period, lo_x, hi_x, lo_y, hi_y};
#define GMG_PASS(T, S, XI, E)                                                  \
  launch_pass<T, S, XI, E>(kind, color, damping, x_in, x_out, x_store, b,     \
                           inv_diag, e0, e1, e2, band, nx, ny, nz, partials,  \
                           win, s)
  if (fdt == kF32 && sdt == kF32 && xdt == kF32) {
    if (edt == kF32) return GMG_PASS(float, float, float, float);
    if (edt == kBF16) return GMG_PASS(float, float, float, __nv_bfloat16);
  }
  if (fdt == kF64 && sdt == kF64 && xdt == kF64) {
    if (edt == kF64) return GMG_PASS(double, double, double, double);
    if (edt == kF32) return GMG_PASS(double, double, double, float);
    if (edt == kBF16) return GMG_PASS(double, double, double, __nv_bfloat16);
  }
  if (fdt == kF32 && sdt == kBF16 && xdt == kBF16) {
    if (edt == kF32) return GMG_PASS(float, __nv_bfloat16, __nv_bfloat16, float);
    if (edt == kBF16) return GMG_PASS(float, __nv_bfloat16, __nv_bfloat16, __nv_bfloat16);
  }
  if (fdt == kF32 && sdt == kBF16 && xdt == kF32) {
    if (edt == kF32) return GMG_PASS(float, __nv_bfloat16, float, float);
    if (edt == kBF16) return GMG_PASS(float, __nv_bfloat16, float, __nv_bfloat16);
  }
#undef GMG_PASS
  return (int)cudaErrorInvalidValue;
}

// The band-restricted 'b' pass: x_out[cells[t]] = b-pass update of x_in at
// that cell, for t < count.  x_in and x_out are compute-type buffers.
extern "C" int gmg_band_pass(int fdt, int sdt, int edt, double damping,
                             const void* x_in, void* x_out, const void* b,
                             const void* inv_diag, const void* e0,
                             const void* e1, const void* e2,
                             const void* cells, long long count, int nx,
                             int ny, int nz, void* stream) {
  using namespace gmg;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GMG_BAND(T, S, E)                                                      \
  launch_band<T, S, E>(damping, x_in, x_out, b, inv_diag, e0, e1, e2, cells,  \
                       count, nx, ny, nz, s)
  if (fdt == kF32 && sdt == kF32) {
    if (edt == kF32) return GMG_BAND(float, float, float);
    if (edt == kBF16) return GMG_BAND(float, float, __nv_bfloat16);
  }
  if (fdt == kF64 && sdt == kF64) {
    if (edt == kF64) return GMG_BAND(double, double, double);
    if (edt == kF32) return GMG_BAND(double, double, float);
    if (edt == kBF16) return GMG_BAND(double, double, __nv_bfloat16);
  }
  if (fdt == kF32 && sdt == kBF16) {
    if (edt == kF32) return GMG_BAND(float, __nv_bfloat16, float);
    if (edt == kBF16) return GMG_BAND(float, __nv_bfloat16, __nv_bfloat16);
  }
#undef GMG_BAND
  return (int)cudaErrorInvalidValue;
}
