// Kernel 4: the halo gather and the core scatter of a one-card block mesh.
//
// Replaces parallel/halo.py::exchange_halos (ppermute of H-deep boundary
// slabs along each sharded mesh axis, zeros at the mesh edges, corners
// filled transitively by exchanging y after x) and the core slicing and
// out_specs assembly of parallel/pallas_sharded.py (:144-147, :299-305)
// of the JAX package.  On one card the blocks of a level are not on other
// devices: they are windows of one global grid.  So the "exchange" is an
// indexed copy of the global grid into the stacked layout of
// parallel/halo.py:
//
//   stacked[(b * bxh + li), lj, k] = global[ix*bx + li - hx, iy*by + lj - hy, k]
//
// for block b = ix * my + iy, bxh = bx + 2 hx, byh = by + 2 hy, and zero
// where the global index falls outside the grid -- exactly what the
// transitive x-then-y exchange gives, corners included, since every halo
// cell is its global neighbour's value (or zero past the domain edge).
// core_scatter is the inverse on the cores: each global cell is read back
// from the one block that owns it.
//
// One block per z-line of the output (a stacked (row, column) line for the
// gather, a global (i, j) line for the scatter) and one thread per cell of
// the line, z fastest, so loads and stores coalesce; the block and halo
// index arithmetic is done once per line, not once per element (a 64-bit
// division chain per element held a first, thread-per-element version to
// a third of the H100's memory rate at 256^3).
// The copy takes any element size (int8 band, bf16 edge weights, fp32 and
// fp64 fields) and moves each line in units of up to 16 bytes
// (dispatch_halo).  Bound: device memory -- each output
// element written once and each input element read about once (the halo
// rows are read again by the next block: 1.25x the level at 256^3 with 2x2
// blocks).
#include "common.cuh"

namespace gmg {

template <typename V>
__global__ void halo_gather_kernel(const V* __restrict__ in, V* __restrict__ out,
                                   int nx, int ny, int nz, int my, int bx,
                                   int by, int hx, int hy, unsigned long long* launches) {
  count_launch(launches);
  const long long line = blockIdx.x;  // stacked row * byh + lj
  const int bxh = bx + 2 * hx;
  const int byh = by + 2 * hy;
  const int lj = int(line % byh);
  const int s = int(line / byh);
  const int blk = s / bxh;
  const int li = s % bxh;
  const int gi = (blk / my) * bx + li - hx;
  const int gj = (blk % my) * by + lj - hy;
  V* dst = out + line * nz;
  if (gi >= 0 && gi < nx && gj >= 0 && gj < ny) {
    const V* src = in + ((long long)gi * ny + gj) * nz;
    for (int k = threadIdx.x; k < nz; k += blockDim.x) dst[k] = src[k];
  } else {
    for (int k = threadIdx.x; k < nz; k += blockDim.x) dst[k] = V{};
  }
}

template <typename V>
__global__ void core_scatter_kernel(const V* __restrict__ in, V* __restrict__ out,
                                    int ny, int nz, int my, int bx, int by,
                                    int hx, int hy, unsigned long long* launches) {
  count_launch(launches);
  const long long line = blockIdx.x;  // i * ny + j
  const int i = int(line / ny);
  const int j = int(line % ny);
  const int bxh = bx + 2 * hx;
  const int byh = by + 2 * hy;
  const int blk = (i / bx) * my + j / by;
  const long long row = (long long)blk * bxh + i % bx + hx;
  const V* src = in + (row * byh + j % by + hy) * nz;
  V* dst = out + line * nz;
  for (int k = threadIdx.x; k < nz; k += blockDim.x) dst[k] = src[k];
}

template <typename V>
cudaError_t launch_halo(bool gather, const void* in, void* out, int nx, int ny,
                        int nz, int mx, int my, int bx, int by, int hx, int hy,
                        unsigned long long* launches, cudaStream_t stream) {
  const long long lines =
      gather ? (long long)mx * my * (bx + 2 * hx) * (long long)(by + 2 * hy)
             : (long long)nx * ny;
  if (lines == 0 || nz == 0) return cudaSuccess;
  if (lines > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int threads = nz >= 1024 ? 1024 : (nz + 31) / 32 * 32;
  if (gather) {
    halo_gather_kernel<V><<<(unsigned int)lines, threads, 0, stream>>>(
        static_cast<const V*>(in), static_cast<V*>(out), nx, ny, nz, my, bx,
        by, hx, hy, launches);
  } else {
    core_scatter_kernel<V><<<(unsigned int)lines, threads, 0, stream>>>(
        static_cast<const V*>(in), static_cast<V*>(out), ny, nz, my, bx, by,
        hx, hy, launches);
  }
  return cudaGetLastError();
}

// The kernels copy bytes: a line of nz elements of `itemsize` bytes moves
// in the widest unit (16, 8, 4, 2 or 1 bytes) that divides the line's
// length and the two pointers' alignment, so a 384-wide fp32 line is 96
// 16-byte copies and each thread keeps 16 bytes in flight.
cudaError_t dispatch_halo(bool gather, int itemsize, const void* in, void* out,
                          int nx, int ny, int nz, int mx, int my, int bx,
                          int by, int hx, int hy, void* launches_p, cudaStream_t s) {
  if (mx <= 0 || my <= 0 || bx * mx != nx || by * my != ny) return cudaErrorInvalidValue;
  if (itemsize != 1 && itemsize != 2 && itemsize != 4 && itemsize != 8) return cudaErrorInvalidValue;
  const long long line_bytes = (long long)nz * itemsize;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(in) | reinterpret_cast<uintptr_t>(out);
  int w = 16;
  while (w > 1 && (line_bytes % w || addr % w)) w /= 2;
  const int n = int(line_bytes / w);
  auto* launches = static_cast<unsigned long long*>(launches_p);
  switch (w) {
    case 16: return launch_halo<uint4>(gather, in, out, nx, ny, n, mx, my, bx, by, hx, hy, launches, s);
    case 8: return launch_halo<uint2>(gather, in, out, nx, ny, n, mx, my, bx, by, hx, hy, launches, s);
    case 4: return launch_halo<uint32_t>(gather, in, out, nx, ny, n, mx, my, bx, by, hx, hy, launches, s);
    case 2: return launch_halo<uint16_t>(gather, in, out, nx, ny, n, mx, my, bx, by, hx, hy, launches, s);
    default: return launch_halo<uint8_t>(gather, in, out, nx, ny, n, mx, my, bx, by, hx, hy, launches, s);
  }
}

}  // namespace gmg

// Global (nx, ny, nz) grid -> stacked haloed blocks (mx*my*(bx+2hx),
// by+2hy, nz); mx*bx = nx, my*by = ny; hx, hy: halo depth on each axis (0
// on an axis that is not split).  launches: the launch counter (one
// unsigned 64-bit word, raised by one per launch), or null.
extern "C" int gmg_halo_gather(int itemsize, const void* in, void* out, int nx,
                               int ny, int nz, int mx, int my, int bx, int by,
                               int hx, int hy, void* launches, void* stream) {
  return (int)gmg::dispatch_halo(true, itemsize, in, out, nx, ny, nz, mx, my,
                                 bx, by, hx, hy, launches,
                                 static_cast<cudaStream_t>(stream));
}

// Stacked haloed blocks -> the global grid of their cores.
extern "C" int gmg_core_scatter(int itemsize, const void* in, void* out, int nx,
                                int ny, int nz, int mx, int my, int bx, int by,
                                int hx, int hy, void* launches, void* stream) {
  return (int)gmg::dispatch_halo(false, itemsize, in, out, nx, ny, nz, mx, my,
                                 bx, by, hx, hy, launches,
                                 static_cast<cudaStream_t>(stream));
}
