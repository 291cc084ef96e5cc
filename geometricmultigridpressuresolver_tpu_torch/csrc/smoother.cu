// Kernel 1: one pass of the multigrid smoothing block.
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
// With `partials` the pass also writes one partial of <x_out, b> per block
// (the CG rho when this is the fine upstroke's last pass).
//
// What bounds it on the H100: device memory.  A pass reads x (7 points,
// mostly from L1/L2), b, inv_diag, three edge-weight grids and the band, and
// writes x: about 4+4+4+3*2+1+4 = 23 B/cell with bf16 edge weights, against
// the card's 3.35 TB/s.  An 8-pass block therefore moves ~8x what the
// Pallas kernel moves once per slab; keeping the pass stack in shared
// memory (temporal blocking) is the planned follow-up.
#include "common.cuh"

namespace gmg {

template <typename T, typename E, int KIND>
__global__ void __launch_bounds__(kBlock)
smooth_pass_kernel(const T* x_in, T* x_out, const T* __restrict__ b,
                   const T* __restrict__ inv_diag, const E* __restrict__ e0,
                   const E* __restrict__ e1, const E* __restrict__ e2,
                   const int8_t* __restrict__ band, int nx, int ny, int nz,
                   int color, T w, T one_minus_w, T* __restrict__ partials) {
  const long long n = (long long)nx * ny * nz;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  T contrib = T(0);
  if (idx < n) {
    const Cell c = cell_of(idx, ny, nz);
    const T xc = x_in ? x_in[idx] : T(0);
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
      auto val = [x_in](long long q) { return x_in ? x_in[q] : T(0); };
      const T s = neighbor_sum<T, E>(val, e0, e1, e2, idx, c, nx, ny, nz);
      const T bb = b[idx];
      const T id = inv_diag[idx];
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
    if (update || x_out != x_in) x_out[idx] = xn;
    if (partials) contrib = xn * b[idx];
  }
  if (partials) {
    const T total = block_sum(contrib);
    if (threadIdx.x == 0) partials[blockIdx.x] = total;
  }
}

template <typename T, typename E>
cudaError_t launch_pass(int kind, int color, double damping, const void* x_in,
                        void* x_out, const void* b, const void* inv_diag,
                        const void* e0, const void* e1, const void* e2,
                        const void* band, int nx, int ny, int nz,
                        void* partials, cudaStream_t stream) {
  const long long n = (long long)nx * ny * nz;
  if (n == 0) return cudaSuccess;
  const T w = T(damping);
  const T omw = T(1.0 - damping);
  const dim3 grid(num_blocks(n));
  const T* xi = static_cast<const T*>(x_in);
  T* xo = static_cast<T*>(x_out);
  const T* bp = static_cast<const T*>(b);
  const T* ip = static_cast<const T*>(inv_diag);
  const E* w0 = static_cast<const E*>(e0);
  const E* w1 = static_cast<const E*>(e1);
  const E* w2 = static_cast<const E*>(e2);
  const int8_t* bd = static_cast<const int8_t*>(band);
  T* pp = static_cast<T*>(partials);
  switch (kind) {
    case 0:
      smooth_pass_kernel<T, E, 0><<<grid, kBlock, 0, stream>>>(
          xi, xo, bp, ip, w0, w1, w2, bd, nx, ny, nz, color, w, omw, pp);
      break;
    case 1:
      smooth_pass_kernel<T, E, 1><<<grid, kBlock, 0, stream>>>(
          xi, xo, bp, ip, w0, w1, w2, bd, nx, ny, nz, color, w, omw, pp);
      break;
    case 2:
      smooth_pass_kernel<T, E, 2><<<grid, kBlock, 0, stream>>>(
          xi, xo, bp, ip, w0, w1, w2, bd, nx, ny, nz, color, w, omw, pp);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace gmg

extern "C" int gmg_smooth_pass(int fdt, int edt, int kind, int color,
                               double damping, const void* x_in, void* x_out,
                               const void* b, const void* inv_diag,
                               const void* e0, const void* e1, const void* e2,
                               const void* band, int nx, int ny, int nz,
                               void* partials, void* stream) {
  using namespace gmg;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GMG_PASS(T, E)                                                       \
  launch_pass<T, E>(kind, color, damping, x_in, x_out, b, inv_diag, e0, e1, \
                    e2, band, nx, ny, nz, partials, s)
  if (fdt == kF32 && edt == kF32) return GMG_PASS(float, float);
  if (fdt == kF32 && edt == kBF16) return GMG_PASS(float, __nv_bfloat16);
  if (fdt == kF64 && edt == kF64) return GMG_PASS(double, double);
  if (fdt == kF64 && edt == kF32) return GMG_PASS(double, float);
  if (fdt == kF64 && edt == kBF16) return GMG_PASS(double, __nv_bfloat16);
#undef GMG_PASS
  return (int)cudaErrorInvalidValue;
}
