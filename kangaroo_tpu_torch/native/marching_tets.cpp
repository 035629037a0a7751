// Isosurface extraction: marching tetrahedra over a (D, H, W) scalar volume.
//
// Native-runtime equivalent of the reference's host-side marching cubes
// (include/kangaroo/MarchingCubes.h:43-262). We use marching tetrahedra
// (6 tets per cube) instead of the 256-case cube tables: the case table is
// derivable (no ambiguous configurations, watertight output) at the cost of
// more triangles. Exposed to Python via ctypes (kangaroo_tpu_torch/fusion/
// marching_cubes.py), which also carries a NumPy implementation of the same
// algorithm for parity testing. A copy of kangaroo_tpu/native/
// marching_tets.cpp: the two packages build their own.
//
// Build: g++ -O3 -shared -fPIC -o libmarching_tets.so marching_tets.cpp

#include <cstdint>
#include <cstdlib>
#include <vector>

namespace {

// The 6 tetrahedra decomposing a cube, as indices into the cube's 8 corners
// (corner i = (x + (i&1), y + ((i>>1)&1), z + ((i>>2)&1))). All six share the
// main diagonal 0-7, giving a consistent (crack-free) decomposition across
// neighbouring cubes.
const int kTets[6][4] = {
    {0, 5, 1, 7}, {0, 1, 3, 7}, {0, 3, 2, 7},
    {0, 2, 6, 7}, {0, 6, 4, 7}, {0, 4, 5, 7},
};

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
// a malloc'd array of 9 floats per triangle (3 vertices, xyz each, in world
// units spanned by bbox lo/hi with the reference's (n-1) voxel spacing,
// BoundedVolume.h:115-125). Voxels with weight <= wmin (if weights given) are
// treated as empty space and suppressed. Caller frees with mt_free.
int64_t mt_extract(const float *vol, const float *weight, int64_t d, int64_t h,
                   int64_t w, const float *lo, const float *hi, float iso,
                   float wmin, float **verts_out) {
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
        for (int i = 0; i < 8; ++i) {
          int64_t xi = x + (i & 1), yi = y + ((i >> 1) & 1), zi = z + ((i >> 2) & 1);
          int64_t idx = at(zi, yi, xi);
          cv[i] = vol[idx];
          if (weight && weight[idx] <= wmin) valid = false;
          cp[i] = V3{lo[0] + sx * (float)xi, lo[1] + sy * (float)yi,
                     lo[2] + sz * (float)zi};
        }
        if (!valid) continue;

        for (int t = 0; t < 6; ++t) {
          const int *T = kTets[t];
          float tv[4] = {cv[T[0]], cv[T[1]], cv[T[2]], cv[T[3]]};
          V3 tp[4] = {cp[T[0]], cp[T[1]], cp[T[2]], cp[T[3]]};
          int code = 0;
          for (int i = 0; i < 4; ++i)
            if (tv[i] < iso) code |= 1 << i;
          if (code == 0 || code == 15) continue;

          // Edges of the tetrahedron between vertex pairs.
          auto E = [&](int a, int b) { return lerp_edge(tp[a], tp[b], tv[a], tv[b], iso); };
          V3 out[6];
          int n = 0;
          // Enumerate the 14 non-trivial sign configurations. One-inside and
          // one-outside cases give a triangle; two-inside gives a quad
          // (two triangles). Vertex winding (r5): every kTets entry is
          // positively oriented, and each case's triangles are ordered so
          // normals point toward the val > iso side (per-case verified
          // against the linear interpolant's gradient; mirrors the Python
          // _CASES table exactly).
          switch (code) {
            case 1:  out[0]=E(0,1); out[1]=E(0,2); out[2]=E(0,3); n=3; break;
            case 14: out[0]=E(0,2); out[1]=E(0,1); out[2]=E(0,3); n=3; break;
            case 2:  out[0]=E(1,0); out[1]=E(1,3); out[2]=E(1,2); n=3; break;
            case 13: out[0]=E(1,3); out[1]=E(1,0); out[2]=E(1,2); n=3; break;
            case 4:  out[0]=E(2,0); out[1]=E(2,1); out[2]=E(2,3); n=3; break;
            case 11: out[0]=E(2,1); out[1]=E(2,0); out[2]=E(2,3); n=3; break;
            case 8:  out[0]=E(3,0); out[1]=E(3,2); out[2]=E(3,1); n=3; break;
            case 7:  out[0]=E(3,2); out[1]=E(3,0); out[2]=E(3,1); n=3; break;
            case 3:  // 0,1 inside
              out[0]=E(0,2); out[1]=E(1,3); out[2]=E(1,2);
              out[3]=E(0,2); out[4]=E(0,3); out[5]=E(1,3); n=6; break;
            case 12:
              out[0]=E(1,2); out[1]=E(1,3); out[2]=E(0,2);
              out[3]=E(1,3); out[4]=E(0,3); out[5]=E(0,2); n=6; break;
            case 5:  // 0,2 inside
              out[0]=E(0,1); out[1]=E(2,1); out[2]=E(2,3);
              out[3]=E(0,1); out[4]=E(2,3); out[5]=E(0,3); n=6; break;
            case 10:
              out[0]=E(2,3); out[1]=E(2,1); out[2]=E(0,1);
              out[3]=E(0,3); out[4]=E(2,3); out[5]=E(0,1); n=6; break;
            case 6:  // 1,2 inside
              out[0]=E(1,0); out[1]=E(2,3); out[2]=E(2,0);
              out[3]=E(1,0); out[4]=E(1,3); out[5]=E(2,3); n=6; break;
            case 9:
              out[0]=E(2,0); out[1]=E(2,3); out[2]=E(1,0);
              out[3]=E(2,3); out[4]=E(1,3); out[5]=E(1,0); n=6; break;
          }
          for (int i = 0; i < n; ++i) {
            tris.push_back(out[i].x);
            tris.push_back(out[i].y);
            tris.push_back(out[i].z);
          }
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

void mt_free(float *p) { std::free(p); }

}  // extern "C"
