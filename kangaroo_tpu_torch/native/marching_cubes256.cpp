// Isosurface extraction: classic 256-case marching cubes over a (D, H, W)
// scalar volume.
//
// Native-runtime core for kangaroo_tpu_torch/fusion/marching_cubes256.py (a
// copy of kangaroo_tpu/native/marching_cubes256.cpp) — the
// mesh-level parity option beside marching_tets.cpp (the reference's
// vMarchCube walks the same per-cube case structure,
// include/kangaroo/MarchingCubes.h:43-144). The 256-case triangle table is
// NOT compiled in: Python DERIVES it at import time (face-arc loop tracing,
// see marching_cubes256._build_tables) and passes it through ctypes, so the
// cases have a single source of truth and nothing here can drift from the
// NumPy golden model.
//
// Build: g++ -O3 -shared -fPIC -o libmarching_cubes256.so marching_cubes256.cpp

#include <cstdint>
#include <cstdlib>
#include <vector>

namespace {

struct V3 {
  float x, y, z;
};

inline V3 lerp_edge(const V3 &a, const V3 &b, float va, float vb, float iso) {
  float t = (iso - va) / (vb - va);
  if (t < 0.f) t = 0.f;
  if (t > 1.f) t = 1.f;
  return V3{a.x + t * (b.x - a.x), a.y + t * (b.y - a.y), a.z + t * (b.z - a.z)};
}

}  // namespace

extern "C" {

// Extracts the iso-surface. Returns number of triangles; *verts_out receives
// a malloc'd array of 9 floats per triangle. tri_flat/tri_offset encode the
// derived case table (tri_offset[case]..tri_offset[case+1] indexes edge ids,
// 3 per triangle); edge_a/edge_b give each edge's two corner indices
// (corner i = (x + (i&1), y + ((i>>1)&1), z + ((i>>2)&1))). Voxels with
// weight <= wmin (if weights given) are suppressed. Caller frees with mc_free.
int64_t mc_extract(const float *vol, const float *weight, int64_t d, int64_t h,
                   int64_t w, const float *lo, const float *hi, float iso,
                   float wmin, const int32_t *tri_flat,
                   const int32_t *tri_offset, const int32_t *edge_a,
                   const int32_t *edge_b, float **verts_out) {
  std::vector<float> tris;
  tris.reserve(1 << 16);

  const float sx = (hi[0] - lo[0]) / (float)(w - 1);
  const float sy = (hi[1] - lo[1]) / (float)(h - 1);
  const float sz = (hi[2] - lo[2]) / (float)(d - 1);

  auto at = [&](int64_t z, int64_t y, int64_t x) -> int64_t {
    return (z * h + y) * w + x;
  };

  for (int64_t z = 0; z + 1 < d; ++z) {
    for (int64_t y = 0; y + 1 < h; ++y) {
      for (int64_t x = 0; x + 1 < w; ++x) {
        float cv[8];
        V3 cp[8];
        bool valid = true;
        int code = 0;
        for (int i = 0; i < 8; ++i) {
          int64_t xi = x + (i & 1), yi = y + ((i >> 1) & 1),
                  zi = z + ((i >> 2) & 1);
          int64_t idx = at(zi, yi, xi);
          cv[i] = vol[idx];
          if (weight && weight[idx] <= wmin) valid = false;
          if (cv[i] < iso) code |= 1 << i;
          cp[i] = V3{lo[0] + sx * (float)xi, lo[1] + sy * (float)yi,
                     lo[2] + sz * (float)zi};
        }
        if (!valid || code == 0 || code == 255) continue;

        for (int32_t k = tri_offset[code]; k < tri_offset[code + 1]; ++k) {
          int e = tri_flat[k];
          int a = edge_a[e], b = edge_b[e];
          V3 p = lerp_edge(cp[a], cp[b], cv[a], cv[b], iso);
          tris.push_back(p.x);
          tris.push_back(p.y);
          tris.push_back(p.z);
        }
      }
    }
  }

  int64_t ntri = (int64_t)(tris.size() / 9);
  float *buf = (float *)std::malloc(tris.size() * sizeof(float));
  for (size_t i = 0; i < tris.size(); ++i) buf[i] = tris[i];
  *verts_out = buf;
  return ntri;
}

void mc_free(float *p) { std::free(p); }

}  // extern "C"
