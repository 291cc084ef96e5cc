// Kernels 2 and 3 -- the fused CG step and the residual -- plus the
// fixed-order sum of per-block dot partials that kernels 1 and 2 emit.
//
// Kernel 2 replaces ops/pallas_cg.py::fused_search_matvec_dot (kernel body
// _make_kernel) of the JAX package:
//     p' = z + beta*p,   Ap' = diag*p' - S(p'),   <p', Ap'>.
// The Pallas kernel forms p' once per VMEM slab (with a one-cell halo) and
// then applies the stencil.  Blocks on the H100 run in no order and share
// nothing, so each thread recomputes p' at itself and its six neighbours
// (z + beta*p is the same expression everywhere, hence the same value) and
// no grid-wide sync is needed.  beta arrives by device pointer, so the CG
// loop needs no host read to launch the step.  Bound: device memory, about
// 6*4 B read + 2*4 B written = 32 B/cell in fp32 with fp32 edge weights;
// the six neighbour reads of z and p hit L1/L2.
//
// Kernel 3 replaces ops/pallas_cg.py::fused_residual (kernel body
// _make_residual_kernel):  r = b - (diag*x - S(x)).  It is also the
// smoother's emit_residual epilogue (the port's smoother is one launch per
// pass).  Bound: device memory, about 3*4 + 3*2 + 4 = 22 B/cell with bf16
// edge weights.
#include "common.cuh"

namespace gmg {

template <typename T, typename E>
__global__ void __launch_bounds__(kBlock)
cg_step_kernel(const T* __restrict__ z, const T* __restrict__ p,
               const T* __restrict__ beta_ptr, const T* __restrict__ diag,
               const E* __restrict__ e0, const E* __restrict__ e1,
               const E* __restrict__ e2, T* __restrict__ p_out,
               T* __restrict__ ap_out, T* __restrict__ partials, int nx, int ny,
               int nz) {
  const long long n = (long long)nx * ny * nz;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const T beta = *beta_ptr;
  T contrib = T(0);
  if (idx < n) {
    const Cell c = cell_of(idx, ny, nz);
    auto pn = [z, p, beta](long long q) { return z[q] + beta * p[q]; };
    const T pc = pn(idx);
    const T s = neighbor_sum<T, E>(pn, e0, e1, e2, idx, c, nx, ny, nz);
    const T ap = diag[idx] * pc - s;
    p_out[idx] = pc;
    ap_out[idx] = ap;
    contrib = pc * ap;
  }
  const T total = block_sum(contrib);
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

template <typename T, typename E>
__global__ void __launch_bounds__(kBlock)
residual_kernel(const T* __restrict__ x, const T* __restrict__ b,
                const T* __restrict__ diag, const E* __restrict__ e0,
                const E* __restrict__ e1, const E* __restrict__ e2,
                T* __restrict__ r, int nx, int ny, int nz) {
  const long long n = (long long)nx * ny * nz;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const Cell c = cell_of(idx, ny, nz);
  auto val = [x](long long q) { return x[q]; };
  const T s = neighbor_sum<T, E>(val, e0, e1, e2, idx, c, nx, ny, nz);
  r[idx] = b[idx] - (diag[idx] * x[idx] - s);
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

template <typename T, typename E>
cudaError_t launch_cg_step(const void* z, const void* p, const void* beta,
                           const void* diag, const void* e0, const void* e1,
                           const void* e2, void* p_out, void* ap_out,
                           void* partials, int nx, int ny, int nz,
                           cudaStream_t stream) {
  const long long n = (long long)nx * ny * nz;
  if (n == 0) return cudaSuccess;
  cg_step_kernel<T, E><<<num_blocks(n), kBlock, 0, stream>>>(
      static_cast<const T*>(z), static_cast<const T*>(p),
      static_cast<const T*>(beta), static_cast<const T*>(diag),
      static_cast<const E*>(e0), static_cast<const E*>(e1),
      static_cast<const E*>(e2), static_cast<T*>(p_out),
      static_cast<T*>(ap_out), static_cast<T*>(partials), nx, ny, nz);
  return cudaGetLastError();
}

template <typename T, typename E>
cudaError_t launch_residual(const void* x, const void* b, const void* diag,
                            const void* e0, const void* e1, const void* e2,
                            void* r, int nx, int ny, int nz,
                            cudaStream_t stream) {
  const long long n = (long long)nx * ny * nz;
  if (n == 0) return cudaSuccess;
  residual_kernel<T, E><<<num_blocks(n), kBlock, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(b),
      static_cast<const T*>(diag), static_cast<const E*>(e0),
      static_cast<const E*>(e1), static_cast<const E*>(e2),
      static_cast<T*>(r), nx, ny, nz);
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

extern "C" int gmg_block_size() { return gmg::kBlock; }

extern "C" int gmg_cg_step(int fdt, int edt, const void* z, const void* p,
                           const void* beta, const void* diag, const void* e0,
                           const void* e1, const void* e2, void* p_out,
                           void* ap_out, void* partials, int nx, int ny,
                           int nz, void* stream) {
  using namespace gmg;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GMG_STEP(T, E)                                                     \
  launch_cg_step<T, E>(z, p, beta, diag, e0, e1, e2, p_out, ap_out,        \
                       partials, nx, ny, nz, s)
  GMG_DISPATCH(GMG_STEP)
#undef GMG_STEP
}

extern "C" int gmg_residual(int fdt, int edt, const void* x, const void* b,
                            const void* diag, const void* e0, const void* e1,
                            const void* e2, void* r, int nx, int ny, int nz,
                            void* stream) {
  using namespace gmg;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GMG_RES(T, E) \
  launch_residual<T, E>(x, b, diag, e0, e1, e2, r, nx, ny, nz, s)
  GMG_DISPATCH(GMG_RES)
#undef GMG_RES
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
