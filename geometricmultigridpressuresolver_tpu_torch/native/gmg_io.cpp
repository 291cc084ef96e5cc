// Tiled voxel-field serialization (the framework's native data-loader).
//
// The reference's grid substrate (Houdini UT_VoxelArray, 16^3 tiles with
// constant-tile compression -- SURVEY.md section 2.1) owns field I/O
// through Houdini's .sim/.hip formats.  This standalone C++ library plays
// that role for the TPU framework: cell/face fields stream to disk in a
// tiled format where constant tiles (far-field SDF regions, exterior
// padding, zero velocity) collapse to a single value.  Python binds via
// ctypes (geometricmultigridpressuresolver_tpu/io.py) -- no pybind11
// dependency.
//
// Format (little-endian):
//   magic   "GMGF"            4 bytes
//   version u32 = 2  (v1 accepted on read: same 40-byte layout, but only
//                     guaranteed from ABIs with 8-byte uint64_t alignment;
//                     v2 pins the layout with an explicit reserved field)
//   dtype   u32  (0 = f32, 1 = f64, 2 = i8, 3 = i32)
//   tile    u32  (tile edge length, 1..4096)
//   reserved u32 = 0  (alignment; must be written as 0, ignored on read)
//   shape   u64 x 3  (nx, ny, nz; row-major C order)
//   tiles in lexicographic (tx, ty, tz) order, each:
//     flag  u8  (0 = constant, 1 = dense)
//     constant: one element
//     dense:    clipped-tile elements, row-major within the tile
//
// Build:  g++ -O3 -shared -fPIC -o libgmg_io.so gmg_io.cpp
// (io.py compiles this on first use; no build system required.)

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr char kMagic[4] = {'G', 'M', 'G', 'F'};
// v1 files lacked the explicit reserved field; on every ABI this library
// supports (8-byte-aligned uint64_t) the compiler inserted identical
// padding, so v1 and v2 share the 40-byte layout and both are readable.
// v1 writers on 4-byte-alignment ABIs (32-bit x86) produced a 36-byte
// header this layout would misparse -- the version bump exists so such
// files can never be written again; kMinVersion keeps old valid files
// loading.
constexpr uint32_t kVersion = 2;
constexpr uint32_t kMinVersion = 1;

bool version_ok(uint32_t v) { return v >= kMinVersion && v <= kVersion; }

size_t dtype_size(uint32_t dtype) {
  switch (dtype) {
    case 0: return 4;  // float32
    case 1: return 8;  // float64
    case 2: return 1;  // int8
    case 3: return 4;  // int32
    default: return 0;
  }
}

// Tile edges beyond this are certainly corrupt (a 4096^3 dense tile is
// already 0.5 TB); rejecting them also bounds the tile-buffer allocation.
constexpr uint32_t kMaxTile = 4096;

struct Header {
  uint32_t version = kVersion;
  uint32_t dtype = 0;
  uint32_t tile = 16;
  // Explicit alignment field: without it the compiler inserts 4 padding
  // bytes before shape[] anyway, making the on-disk layout ABI-dependent.
  // Writing it explicitly pins the 40-byte layout to the spec above.
  uint32_t reserved = 0;
  uint64_t shape[3] = {0, 0, 0};
};
static_assert(sizeof(Header) == 40, "on-disk header layout must be 40 bytes");

bool write_all(FILE* f, const void* p, size_t n) {
  return fwrite(p, 1, n, f) == n;
}

bool read_all(FILE* f, void* p, size_t n) {
  return fread(p, 1, n, f) == n;
}

}  // namespace

extern "C" {

// Returns 0 on success, negative error code otherwise.
//  -1 cannot open file    -2 write failed        -3 bad dtype/tile
int64_t gmg_save(const char* path, const void* data, int64_t nx, int64_t ny,
                 int64_t nz, int32_t dtype, int32_t tile) {
  const size_t esz = dtype_size(dtype);
  if (esz == 0 || tile <= 0 || static_cast<uint32_t>(tile) > kMaxTile ||
      nx <= 0 || ny <= 0 || nz <= 0)
    return -3;

  FILE* f = fopen(path, "wb");
  if (!f) return -1;

  Header h;
  h.dtype = static_cast<uint32_t>(dtype);
  h.tile = static_cast<uint32_t>(tile);
  h.shape[0] = nx; h.shape[1] = ny; h.shape[2] = nz;
  if (!write_all(f, kMagic, 4) || !write_all(f, &h, sizeof(h))) {
    fclose(f);
    return -2;
  }

  const char* src = static_cast<const char*>(data);
  const int64_t t = tile;
  std::vector<char> buf(static_cast<size_t>(t) * t * t * esz);

  for (int64_t tx = 0; tx < nx; tx += t) {
    const int64_t ex = std::min<int64_t>(tx + t, nx);
    for (int64_t ty = 0; ty < ny; ty += t) {
      const int64_t ey = std::min<int64_t>(ty + t, ny);
      for (int64_t tz = 0; tz < nz; tz += t) {
        const int64_t ez = std::min<int64_t>(tz + t, nz);
        // Gather the clipped tile contiguously (rows along z).
        char* dst = buf.data();
        const size_t row = static_cast<size_t>(ez - tz) * esz;
        for (int64_t x = tx; x < ex; ++x) {
          for (int64_t y = ty; y < ey; ++y) {
            const char* r = src + ((x * ny + y) * nz + tz) * esz;
            std::memcpy(dst, r, row);
            dst += row;
          }
        }
        const size_t tile_bytes = static_cast<size_t>(dst - buf.data());
        // Constant-tile check: every element equals the first.
        bool constant = true;
        for (size_t off = esz; off < tile_bytes && constant; off += esz) {
          constant = std::memcmp(buf.data(), buf.data() + off, esz) == 0;
        }
        const uint8_t flag = constant ? 0 : 1;
        if (!write_all(f, &flag, 1) ||
            !write_all(f, buf.data(), constant ? esz : tile_bytes)) {
          fclose(f);
          return -2;
        }
      }
    }
  }
  if (fclose(f) != 0) return -2;
  return 0;
}

// Fills shape[3], dtype, tile.  Returns 0 on success.
//  -1 cannot open   -4 bad magic/version
int64_t gmg_info(const char* path, int64_t* shape, int32_t* dtype,
                 int32_t* tile) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  char magic[4];
  Header h;
  if (!read_all(f, magic, 4) || std::memcmp(magic, kMagic, 4) != 0 ||
      !read_all(f, &h, sizeof(h)) || !version_ok(h.version) ||
      dtype_size(h.dtype) == 0 || h.tile == 0 || h.tile > kMaxTile) {
    fclose(f);
    return -4;
  }
  shape[0] = h.shape[0]; shape[1] = h.shape[1]; shape[2] = h.shape[2];
  *dtype = h.dtype;
  *tile = h.tile;
  fclose(f);
  return 0;
}

// `out` must hold nx*ny*nz elements matching the stored dtype/shape
// (validate via gmg_info first).  Returns 0 on success.
//  -1 open   -4 bad header   -5 shape/dtype mismatch   -6 truncated file
int64_t gmg_load(const char* path, void* out, int64_t nx, int64_t ny,
                 int64_t nz, int32_t dtype) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  char magic[4];
  Header h;
  if (!read_all(f, magic, 4) || std::memcmp(magic, kMagic, 4) != 0 ||
      !read_all(f, &h, sizeof(h)) || !version_ok(h.version) ||
      h.tile == 0 || h.tile > kMaxTile) {
    fclose(f);
    return -4;
  }
  const size_t esz = dtype_size(h.dtype);
  if (esz == 0 || h.dtype != static_cast<uint32_t>(dtype) ||
      h.shape[0] != static_cast<uint64_t>(nx) ||
      h.shape[1] != static_cast<uint64_t>(ny) ||
      h.shape[2] != static_cast<uint64_t>(nz)) {
    fclose(f);
    return -5;
  }

  char* dst_base = static_cast<char*>(out);
  const int64_t t = h.tile;
  std::vector<char> buf(static_cast<size_t>(t) * t * t * esz);

  for (int64_t tx = 0; tx < nx; tx += t) {
    const int64_t ex = std::min<int64_t>(tx + t, nx);
    for (int64_t ty = 0; ty < ny; ty += t) {
      const int64_t ey = std::min<int64_t>(ty + t, ny);
      for (int64_t tz = 0; tz < nz; tz += t) {
        const int64_t ez = std::min<int64_t>(tz + t, nz);
        const size_t row = static_cast<size_t>(ez - tz) * esz;
        const size_t cells =
            static_cast<size_t>(ex - tx) * (ey - ty) * (ez - tz);
        uint8_t flag;
        if (!read_all(f, &flag, 1)) { fclose(f); return -6; }
        if (flag == 0) {
          char value[16];
          if (!read_all(f, value, esz)) { fclose(f); return -6; }
          char* p = buf.data();
          for (size_t i = 0; i < cells; ++i, p += esz)
            std::memcpy(p, value, esz);
        } else {
          if (!read_all(f, buf.data(), cells * esz)) { fclose(f); return -6; }
        }
        const char* srcp = buf.data();
        for (int64_t x = tx; x < ex; ++x) {
          for (int64_t y = ty; y < ey; ++y) {
            char* r = dst_base + ((x * ny + y) * nz + tz) * esz;
            std::memcpy(r, srcp, row);
            srcp += row;
          }
        }
      }
    }
  }
  fclose(f);
  return 0;
}

}  // extern "C"
