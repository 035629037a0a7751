// The plane-sweep TSDF fuse: every voxel of the plane window, in place.
//
// Replaces kangaroo_tpu/fusion/separable_pallas.py:_make_fuse_kernel
// (driven by fuse_planes_pallas there). It computes what the kernel's
// plane_body computes, which is what the XLA scan of
// kangaroo_tpu/fusion/separable.py:_sdf_fuse_axis computes, per voxel, for
// the planes k in [window[0], window[1]):
//   denom = 1 + k g2, s(i) = (i + k g0) / denom, t(j) = (j + k g1) / denom,
//   si = (s - s_lo) / ds, tj = (t - t_lo) / dt   (positions on the grid),
//   md, ct = the banded-lerp samples of the warped (depth, cos theta) grids
//            at (tj, si): grid_h contracted first, then grid_w, as the two
//            matmuls do; each lerp row has at most two non-zero taps, so the
//            sample is four taps, weights at or below 1e-6 snapped to 0,
//   qz = denom (A20 s + A21 t + A22), (uu, vv) = the voxel's pixel,
//   sd = ct (md - qz), w = ct / qz, and the update gate of the scan:
//   plane_ok & in_img (border 2) & win_ok & sd > -trunc & finite md & finite
//   w & ct > mincos & enable, then SDF += and LimitWeight (separable._blend).
// A voxel without an update keeps its value and gets min(weight, max_w), as
// the scan writes back; planes outside the window are not touched. Every
// product, sum and quotient is rounded on its own (__fmul_rn, __fadd_rn,
// __fdiv_rn), in the order of the JAX expressions, so the compiler forms no
// FMA; the matmuls' zero products do not change a float sum, so the result
// is the scan's up to the rounding of each product and sum (the CPU's
// matmul may fuse them).
//
// What bounds it on the H100: the bytes it must move are few. Each voxel of
// the window reads its weight (its limit applies to all), and the voxels
// updated read val and write both: at most 16 bytes a voxel, at 256^3 over
// every plane 268 MB, 0.080 ms at 3.35 TB/s. The warped grids (2 x gh x gw
// floats, 2.4 MB at VGA) stay in the 50 MB L2 and are read through __ldg.
// What takes the time is the four taps: a warp's lanes fall about 2.5 grid
// columns apart, so each tap load spans some three 128-byte lines, and the
// taps take more than half the kernel (chip_smoke.py phase 4 times builds
// cut short after the projection and after the taps). One thread a voxel
// over the whole volume (the design it replaced, below) also spent some
// 200 instructions a voxel on its index (64-bit divisions), eight IEEE
// divisions and twenty parameter loads.
//
// Design (kt_separable_fuse): the TPU kernel streams (P, Hv, Wv) slabs of
// the volume in sweep layout through VMEM and rebuilds the lerp matrices for
// MXU matmuls. Here a block owns one plane k and a kPlaneRows x kPlaneCols
// tile of (j, i) on the z and y sweeps, or kSweepPlanes consecutive planes
// by a kSweepRows x kSweepCols tile on the x sweep, where k runs along x,
// the contiguous axis. It checks the window (a device
// tensor: no host read) once and returns before touching memory when its
// planes lie outside.
// What depends on (k, i) alone (s and its three products with A, the lerp
// column b and its two weights) or on (k, j) alone (t and its products, the
// row a gw and its two weights, plane_ok and enable folded into the column
// and row as -1) goes into tables in shared memory, from the expressions of
// fuse_sample below, so the bits do not change. The voxel loop keeps what
// depends on all three: the projection (two divisions), the four taps, sd
// and w (one division) and the blend (one division). Lanes run along x on
// every sweep, so loads and stores coalesce; a voxel's index is a
// multiply-add from the block's base, with no division. A thread takes its
// voxels kChunk at a time and issues their loads together (the weights,
// then the values of those that update, the four taps of each at once), so
// it waits for memory once a chunk, not once a voxel.
//
// kt_separable_fuse_voxel, the design it replaced, stays as the yardstick
// that the card checks hold the tiles against; no path launches it. There
// one thread takes one voxel and reads its four grid taps directly: no
// matmul, no transposed copy of the volume (the thread maps its [z, y, x]
// index to the sweep's (k, j, i) for the axis, so x, the contiguous axis,
// is the fastest thread index on every axis), no host round trip (the 20
// params and the window are device tensors). Threads outside the window
// return at once; the grid covers the whole volume because the window is
// only known on the device.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// voxels a thread loads together, and the blocks an SM should hold (the
// bound on registers that follows)
constexpr int kChunk = 4;
constexpr int kMinBlocks = 4;
// a block's voxels on the z and y sweeps: one plane by kPlaneRows rows j by
// kPlaneCols columns i (i runs along x); these, the chunk and the blocks an
// SM measured fastest (chip_smoke.py phase 4)
constexpr int kPlaneRows = 128;
constexpr int kPlaneCols = 64;
// on the x sweep: kSweepPlanes planes k (k runs along x, one a lane) by
// kSweepRows rows j by kSweepCols columns i
constexpr int kSweepPlanes = 32;
constexpr int kSweepRows = 16;
constexpr int kSweepCols = 16;
constexpr int kTableI = kSweepPlanes * kSweepCols > kPlaneCols ? kSweepPlanes * kSweepCols
                                                               : kPlaneCols;
constexpr int kTableJ = kSweepPlanes * kSweepRows > kPlaneRows ? kSweepPlanes * kSweepRows
                                                               : kPlaneRows;

__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fdiv(float a, float b) { return __fdiv_rn(a, b); }
// jnp.minimum / jnp.maximum: a NaN in either operand gives NaN
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : (a < b ? a : b);
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : (a > b ? a : b);
}

// separable._lerp_weight of the offset d: max(0, 1 - |d|), snapped to 0 at
// or below 1e-6 (a NaN gives 0)
__device__ __forceinline__ float lerp_weight(float d) {
  const float w = nan_max(0.f, fsub(1.f, fabsf(d)));
  return w > 1e-6f ? w : 0.f;
}

// The gate of the scan for one voxel; on success the new sd and weight.
__device__ __forceinline__ bool fuse_sample(const float* __restrict__ p,
                                            const float* __restrict__ gmd,
                                            const float* __restrict__ gct, int k, int j, int i,
                                            int gh, int gw, int Wi, int Hi, float* sd_out,
                                            float* w_out) {
  if (!(__ldg(p + 19) > 0.5f)) return false;  // enable
  const float kf = static_cast<float>(k);
  const float denom = fadd(1.f, fmul(kf, __ldg(p + 11)));
  const float off_s = fmul(kf, __ldg(p + 9));
  const float off_t = fmul(kf, __ldg(p + 10));
  if (!(fabsf(denom) > 1e-6f)) return false;  // plane_ok
  const float s = fdiv(fadd(static_cast<float>(i), off_s), denom);
  const float t = fdiv(fadd(static_cast<float>(j), off_t), denom);
  const float si = fdiv(fsub(s, __ldg(p + 12)), __ldg(p + 13));
  const float tj = fdiv(fsub(t, __ldg(p + 14)), __ldg(p + 15));
  // win_ok: the lerp position lies on the grid window
  if (!(tj >= 0.f && tj <= static_cast<float>(gh - 1) && si >= 0.f &&
        si <= static_cast<float>(gw - 1)))
    return false;

  // voxel camera depth and projection (in_img, border 2)
  const float den_uv = fadd(fadd(fmul(__ldg(p + 6), s), fmul(__ldg(p + 7), t)), __ldg(p + 8));
  const float qz = fmul(denom, den_uv);
  const float den_safe = fabsf(den_uv) < 1e-12f ? __int_as_float(0x7fc00000) : den_uv;
  const float uu =
      fdiv(fadd(fadd(fmul(__ldg(p + 0), s), fmul(__ldg(p + 1), t)), __ldg(p + 2)), den_safe);
  const float vv =
      fdiv(fadd(fadd(fmul(__ldg(p + 3), s), fmul(__ldg(p + 4), t)), __ldg(p + 5)), den_safe);
  if (!(uu >= 2.f && uu < static_cast<float>(Wi - 2) && vv >= 2.f &&
        vv < static_cast<float>(Hi - 2)))
    return false;

  // the four taps: rows a, a + 1 of grid_h, columns b, b + 1 of grid_w
  const int a = static_cast<int>(floorf(tj));
  const int b = static_cast<int>(floorf(si));
  const float ra0 = lerp_weight(fsub(tj, static_cast<float>(a)));
  const float ra1 = a + 1 < gh ? lerp_weight(fsub(tj, static_cast<float>(a + 1))) : 0.f;
  const float cb0 = lerp_weight(fsub(si, static_cast<float>(b)));
  const float cb1 = b + 1 < gw ? lerp_weight(fsub(si, static_cast<float>(b + 1))) : 0.f;
  const size_t r0 = static_cast<size_t>(a) * gw + b;
  const size_t r1 = r0 + gw;
  // pass 1 (contract grid_h) at columns b and b + 1; a tap of weight 0 adds
  // an exact zero to the matmul's sum, so it is skipped
  float md0 = fmul(ra0, __ldg(gmd + r0)), ct0 = fmul(ra0, __ldg(gct + r0));
  float md1 = 0.f, ct1 = 0.f;
  if (cb1 != 0.f) {
    md1 = fmul(ra0, __ldg(gmd + r0 + 1));
    ct1 = fmul(ra0, __ldg(gct + r0 + 1));
  }
  if (ra1 != 0.f) {
    md0 = fadd(md0, fmul(ra1, __ldg(gmd + r1)));
    ct0 = fadd(ct0, fmul(ra1, __ldg(gct + r1)));
    if (cb1 != 0.f) {
      md1 = fadd(md1, fmul(ra1, __ldg(gmd + r1 + 1)));
      ct1 = fadd(ct1, fmul(ra1, __ldg(gct + r1 + 1)));
    }
  }
  // pass 2 (contract grid_w)
  const float md = fadd(fmul(cb0, md0), fmul(cb1, md1));
  const float ct = fadd(fmul(cb0, ct0), fmul(cb1, ct1));

  const float sd = fmul(ct, fsub(md, qz));
  const float w = fdiv(ct, qz);
  if (!(sd > -__ldg(p + 16) && isfinite(md) && isfinite(w) && ct > __ldg(p + 18))) return false;
  *sd_out = sd;
  *w_out = w;
  return true;
}

__global__ void separable_fuse_voxel_kernel(float* __restrict__ val, float* __restrict__ weight,
                                      const float* __restrict__ gmd,
                                      const float* __restrict__ gct,
                                      const float* __restrict__ params,
                                      const int* __restrict__ window, int D, int H, int W,
                                      int axis, int gh, int gw, int Wi, int Hi) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<size_t>(D) * H * W) return;
  const int x = static_cast<int>(idx % W);
  const int y = static_cast<int>((idx / W) % H);
  const int z = static_cast<int>(idx / (static_cast<size_t>(W) * H));
  // (k, j, i) of the voxel in sweep layout (separable._PERM)
  int k, j, i;
  if (axis == 0) {
    k = z; j = y; i = x;
  } else if (axis == 1) {
    k = y; j = z; i = x;
  } else {
    k = x; j = z; i = y;
  }
  if (k < __ldg(window) || k >= __ldg(window + 1)) return;

  const float max_w = __ldg(params + 17);
  float sd, w_new;
  if (!fuse_sample(params, gmd, gct, k, j, i, gh, gw, Wi, Hi, &sd, &w_new)) {
    // no update: the value passes through, the weight is limited
    if (weight[idx] > max_w) weight[idx] = max_w;
    return;
  }
  const float trunc = __ldg(params + 16);
  const float new_sd = nan_min(nan_max(sd, -trunc), trunc);
  const float old_val = val[idx];
  const float old_w = weight[idx];
  const float old_val_safe = old_w > 0.f ? old_val : 0.f;
  const float w_tot = fadd(old_w, w_new);
  float v = old_val;
  if (w_tot > 0.f && w_new > 0.f)
    v = fdiv(fadd(fmul(old_w, old_val_safe), fmul(w_new, new_sd)), nan_max(w_tot, 1e-20f));
  val[idx] = v;
  weight[idx] = nan_min(w_tot, max_w);
}


// The per-(k, i) and per-(k, j) values of fuse_sample, in shared memory.
struct Tables {
  float s0[kTableI], s3[kTableI], s6[kTableI];  // A00 s, A10 s, A20 s
  float cb0[kTableI], cb1[kTableI];             // the lerp column weights
  int b[kTableI];                               // the lerp column; -1: no update
  float t1[kTableJ], t4[kTableJ], t7[kTableJ];  // A01 t, A11 t, A21 t
  float ra0[kTableJ], ra1[kTableJ];             // the lerp row weights
  int row[kTableJ];                             // a gw; -1: no update
};

// The 20 params: those the voxel loop reads, in registers.
struct Params {
  float p2, p5, p8, trunc, max_w, mincos;
};

// denom = 1 + k g2 and whether the plane may update (enable, plane_ok)
__device__ __forceinline__ float plane_denom(const float* __restrict__ p, int k, bool* ok) {
  const float denom = fadd(1.f, fmul(static_cast<float>(k), __ldg(p + 11)));
  *ok = __ldg(p + 19) > 0.5f && fabsf(denom) > 1e-6f;
  return denom;
}

// Entry e of the (k, i) table, as fuse_sample computes s, si, b, cb0, cb1.
__device__ __forceinline__ void fill_column(Tables& tab, int e, const float* __restrict__ p, int k,
                                            int i, int gw) {
  bool ok;
  const float denom = plane_denom(p, k, &ok);
  const float off_s = fmul(static_cast<float>(k), __ldg(p + 9));
  const float s = fdiv(fadd(static_cast<float>(i), off_s), denom);
  const float si = fdiv(fsub(s, __ldg(p + 12)), __ldg(p + 13));
  tab.s0[e] = fmul(__ldg(p + 0), s);
  tab.s3[e] = fmul(__ldg(p + 3), s);
  tab.s6[e] = fmul(__ldg(p + 6), s);
  tab.b[e] = -1;
  if (!(ok && si >= 0.f && si <= static_cast<float>(gw - 1))) return;
  const int b = static_cast<int>(floorf(si));
  tab.b[e] = b;
  tab.cb0[e] = lerp_weight(fsub(si, static_cast<float>(b)));
  tab.cb1[e] = b + 1 < gw ? lerp_weight(fsub(si, static_cast<float>(b + 1))) : 0.f;
}

// Entry e of the (k, j) table, as fuse_sample computes t, tj, a, ra0, ra1.
__device__ __forceinline__ void fill_row(Tables& tab, int e, const float* __restrict__ p, int k,
                                         int j, int gh, int gw) {
  bool ok;
  const float denom = plane_denom(p, k, &ok);
  const float off_t = fmul(static_cast<float>(k), __ldg(p + 10));
  const float t = fdiv(fadd(static_cast<float>(j), off_t), denom);
  const float tj = fdiv(fsub(t, __ldg(p + 14)), __ldg(p + 15));
  tab.t1[e] = fmul(__ldg(p + 1), t);
  tab.t4[e] = fmul(__ldg(p + 4), t);
  tab.t7[e] = fmul(__ldg(p + 7), t);
  tab.row[e] = -1;
  if (!(ok && tj >= 0.f && tj <= static_cast<float>(gh - 1))) return;
  const int a = static_cast<int>(floorf(tj));
  tab.row[e] = a * gw;
  tab.ra0[e] = lerp_weight(fsub(tj, static_cast<float>(a)));
  tab.ra1[e] = a + 1 < gh ? lerp_weight(fsub(tj, static_cast<float>(a + 1))) : 0.f;
}

// fuse_sample's projection, taps and gate for one voxel of the window, from
// its table entries; on success the new sd and weight. The four taps load
// together: a tap of weight 0 reads its row's or column's first tap instead
// (in the grid), and its product is skipped as fuse_sample skips it.
__device__ __forceinline__ bool sample(const Tables& tab, int ei, int ej, float denom,
                                       const Params& q, const float* __restrict__ gmd,
                                       const float* __restrict__ gct, int gw, int Wi, int Hi,
                                       float* sd_out, float* w_out) {
  const int b = tab.b[ei], row = tab.row[ej];
  if (b < 0 || row < 0) return false;
  const float den_uv = fadd(fadd(tab.s6[ei], tab.t7[ej]), q.p8);
  const float qz = fmul(denom, den_uv);
  const float den_safe = fabsf(den_uv) < 1e-12f ? __int_as_float(0x7fc00000) : den_uv;
  const float uu = fdiv(fadd(fadd(tab.s0[ei], tab.t1[ej]), q.p2), den_safe);
  const float vv = fdiv(fadd(fadd(tab.s3[ei], tab.t4[ej]), q.p5), den_safe);
  if (!(uu >= 2.f && uu < static_cast<float>(Wi - 2) && vv >= 2.f &&
        vv < static_cast<float>(Hi - 2)))
    return false;
  const float ra0 = tab.ra0[ej], ra1 = tab.ra1[ej], cb0 = tab.cb0[ei], cb1 = tab.cb1[ei];
  const int r0 = row + b;
  const int r1 = r0 + (ra1 != 0.f ? gw : 0);  // a + 1 < gh where ra1 != 0
  const int dc = cb1 != 0.f ? 1 : 0;          // b + 1 < gw where cb1 != 0
  const float m00 = __ldg(gmd + r0), m01 = __ldg(gmd + r0 + dc);
  const float m10 = __ldg(gmd + r1), m11 = __ldg(gmd + r1 + dc);
  const float c00 = __ldg(gct + r0), c01 = __ldg(gct + r0 + dc);
  const float c10 = __ldg(gct + r1), c11 = __ldg(gct + r1 + dc);
  // pass 1 (contract grid_h) at columns b and b + 1, then pass 2 (grid_w)
  float md0 = fmul(ra0, m00), ct0 = fmul(ra0, c00);
  float md1 = 0.f, ct1 = 0.f;
  if (cb1 != 0.f) {
    md1 = fmul(ra0, m01);
    ct1 = fmul(ra0, c01);
  }
  if (ra1 != 0.f) {
    md0 = fadd(md0, fmul(ra1, m10));
    ct0 = fadd(ct0, fmul(ra1, c10));
    if (cb1 != 0.f) {
      md1 = fadd(md1, fmul(ra1, m11));
      ct1 = fadd(ct1, fmul(ra1, c11));
    }
  }
  const float md = fadd(fmul(cb0, md0), fmul(cb1, md1));
  const float ct = fadd(fmul(cb0, ct0), fmul(cb1, ct1));
  const float sd = fmul(ct, fsub(md, qz));
  const float w = fdiv(ct, qz);
  if (!(sd > -q.trunc && isfinite(md) && isfinite(w) && ct > q.mincos)) return false;
  *sd_out = sd;
  *w_out = w;
  return true;
}

// kChunk voxels of one thread at a time: their weights load together, then
// the values of those that update; then the blend (or the weight limit) of
// the voxel kernel. voxel(c, &idx, &ei, &ej) names the chunk's c-th voxel
// and whether it is one of the thread's.
template <class Voxel>
__device__ __forceinline__ void fuse_chunk(float* __restrict__ val, float* __restrict__ weight,
                                           Voxel voxel, const Tables& tab, float denom,
                                           const Params& q, const float* __restrict__ gmd,
                                           const float* __restrict__ gct, int gw, int Wi,
                                           int Hi) {
  float old_w[kChunk], old_val[kChunk], sd[kChunk], w_new[kChunk];
  unsigned live = 0, update = 0;
  size_t idx;
  int ei, ej;
#pragma unroll
  for (int c = 0; c < kChunk; ++c) {
    old_w[c] = 0.f;
    if (voxel(c, &idx, &ei, &ej)) {
      live |= 1u << c;
      old_w[c] = weight[idx];
    }
  }
#pragma unroll
  for (int c = 0; c < kChunk; ++c) {
    voxel(c, &idx, &ei, &ej);
    if ((live >> c & 1) && sample(tab, ei, ej, denom, q, gmd, gct, gw, Wi, Hi, &sd[c], &w_new[c]))
      update |= 1u << c;
  }
#pragma unroll
  for (int c = 0; c < kChunk; ++c) {
    voxel(c, &idx, &ei, &ej);
    old_val[c] = update >> c & 1 ? val[idx] : 0.f;
  }
#pragma unroll
  for (int c = 0; c < kChunk; ++c) {
    if (!(live >> c & 1)) continue;
    voxel(c, &idx, &ei, &ej);
    if (!(update >> c & 1)) {
      // no update: the value passes through, the weight is limited
      if (old_w[c] > q.max_w) weight[idx] = q.max_w;
      continue;
    }
    const float new_sd = nan_min(nan_max(sd[c], -q.trunc), q.trunc);
    const float old_val_safe = old_w[c] > 0.f ? old_val[c] : 0.f;
    const float w_tot = fadd(old_w[c], w_new[c]);
    float v = old_val[c];
    if (w_tot > 0.f && w_new[c] > 0.f)
      v = fdiv(fadd(fmul(old_w[c], old_val_safe), fmul(w_new[c], new_sd)),
               nan_max(w_tot, 1e-20f));
    val[idx] = v;
    weight[idx] = nan_min(w_tot, q.max_w);
  }
}

// The sweep's extents and the strides of k, j, i in the [z, y, x] volume.
struct Sweep {
  int nk, nj, ni;
  size_t sk, sj, si;
};

// kAlongX: the x sweep (k runs along x); else the z or y sweep.
template <bool kAlongX>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    separable_fuse_kernel(float* __restrict__ val, float* __restrict__ weight,
                          const float* __restrict__ gmd, const float* __restrict__ gct,
                          const float* __restrict__ params, const int* __restrict__ window,
                          Sweep sw, int gh, int gw, int Wi, int Hi) {
  constexpr int TK = kAlongX ? kSweepPlanes : 1;
  constexpr int TJ = kAlongX ? kSweepRows : kPlaneRows;
  constexpr int TI = kAlongX ? kSweepCols : kPlaneCols;
  __shared__ Tables tab;
  const int nbi = (sw.ni + TI - 1) / TI, nbj = (sw.nj + TJ - 1) / TJ;
  const int bi = static_cast<int>(blockIdx.x % nbi);
  const int bj = static_cast<int>(blockIdx.x / nbi % nbj);
  const int bk = static_cast<int>(blockIdx.x / nbi / nbj);
  const int k0 = bk * TK, j0 = bj * TJ, i0 = bi * TI;
  const int k_lo = __ldg(window), k_hi = __ldg(window + 1);
  if (k0 + TK <= k_lo || k0 >= k_hi) return;  // every plane outside the window
  const int tid = static_cast<int>(threadIdx.x);
  // the tables: entry kk + TK ii of (k0 + kk, i0 + ii), kk + TK jj of (k0 + kk, j0 + jj)
  for (int e = tid; e < TK * TI; e += kThreads)
    fill_column(tab, e, params, k0 + e % TK, i0 + e / TK, gw);
  for (int e = tid; e < TK * TJ; e += kThreads)
    fill_row(tab, e, params, k0 + e % TK, j0 + e / TK, gh, gw);
  const Params q{__ldg(params + 2),  __ldg(params + 5),  __ldg(params + 8),
                 __ldg(params + 16), __ldg(params + 17), __ldg(params + 18)};
  __syncthreads();
  const size_t base = k0 * sw.sk + j0 * sw.sj + i0 * sw.si;
  if constexpr (kAlongX) {
    // lane kk: plane k0 + kk; each warp takes (jj, ii) pairs, kChunk at a time
    const int kk = tid % 32, k = k0 + kk;
    if (k >= sw.nk || k < k_lo || k >= k_hi) return;
    bool ok;
    const float denom = plane_denom(params, k, &ok);
    constexpr int kWarps = kThreads / 32;
    for (int first = tid / 32; first < TJ * TI; first += kWarps * kChunk) {
      const auto voxel = [&](int c, size_t* idx, int* ei, int* ej) {
        const int pair = first + c * kWarps;
        const int jj = pair / TI, ii = pair % TI;
        *idx = base + jj * sw.sj + ii * sw.si + kk;
        *ei = kk + TK * ii;
        *ej = kk + TK * jj;
        return pair < TJ * TI && j0 + jj < sw.nj && i0 + ii < sw.ni;
      };
      fuse_chunk(val, weight, voxel, tab, denom, q, gmd, gct, gw, Wi, Hi);
    }
  } else {
    // one plane; lanes along i, each thread kChunk rows of its column at a
    // time
    constexpr int kRowStep = kThreads / TI;
    static_assert(TJ % (kChunk * kRowStep) == 0, "a thread's rows are whole chunks");
    bool ok;
    const float denom = plane_denom(params, k0, &ok);
    const int ii = tid % TI;
    if (i0 + ii >= sw.ni) return;
    for (int first = tid / TI; first < TJ; first += kChunk * kRowStep) {
      const auto voxel = [&](int c, size_t* idx, int* ei, int* ej) {
        const int jj = first + c * kRowStep;
        *idx = base + jj * sw.sj + ii;
        *ei = ii;
        *ej = jj;
        return j0 + jj < sw.nj;
      };
      fuse_chunk(val, weight, voxel, tab, denom, q, gmd, gct, gw, Wi, Hi);
    }
  }
}

}  // namespace

// The design it replaced, the same arguments.
extern "C" int kt_separable_fuse_voxel(void* val, void* weight, const void* gmd,
                                       const void* gct, const void* params, const void* window,
                                       int D, int H, int W, int axis, int gh, int gw, int Wi,
                                       int Hi, void* stream) {
  if (D < 1 || H < 1 || W < 1 || gh < 2 || gw < 2 || axis < 0 || axis > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t n = static_cast<size_t>(D) * H * W;
  const size_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffULL) return static_cast<int>(cudaErrorInvalidValue);
  separable_fuse_voxel_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(val), static_cast<float*>(weight), static_cast<const float*>(gmd),
      static_cast<const float*>(gct), static_cast<const float*>(params),
      static_cast<const int*>(window), D, H, W, axis, gh, gw, Wi, Hi);
  return static_cast<int>(cudaGetLastError());
}

// val, weight: (D, H, W) float32 [z, y, x], updated in place; gmd, gct:
// (gh, gw) float32; params: 20 float32 (separable.N_PARAMS); window: 2
// int32, the planes [k_lo, k_hi) of the sweep along axis 0 (z), 1 (y) or 2 (x).
extern "C" int kt_separable_fuse(void* val, void* weight, const void* gmd, const void* gct,
                                 const void* params, const void* window, int D, int H, int W,
                                 int axis, int gh, int gw, int Wi, int Hi, void* stream) {
  if (D < 1 || H < 1 || W < 1 || gh < 2 || gw < 2 || axis < 0 || axis > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t plane = static_cast<size_t>(H) * W;
  // (k, j, i) of the sweep (separable._PERM) and their strides
  Sweep sw;
  if (axis == 0) {
    sw = Sweep{D, H, W, plane, static_cast<size_t>(W), 1};
  } else if (axis == 1) {
    sw = Sweep{H, D, W, static_cast<size_t>(W), plane, 1};
  } else {
    sw = Sweep{W, D, H, 1, plane, static_cast<size_t>(W)};
  }
  const int TK = axis == 2 ? kSweepPlanes : 1;
  const int TJ = axis == 2 ? kSweepRows : kPlaneRows;
  const int TI = axis == 2 ? kSweepCols : kPlaneCols;
  const size_t blocks = static_cast<size_t>((sw.nk + TK - 1) / TK) * ((sw.nj + TJ - 1) / TJ) *
                        ((sw.ni + TI - 1) / TI);
  if (blocks > 0x7fffffffULL) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = axis == 2 ? &separable_fuse_kernel<true> : &separable_fuse_kernel<false>;
  kernel<<<static_cast<unsigned>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(val), static_cast<float*>(weight), static_cast<const float*>(gmd),
      static_cast<const float*>(gct), static_cast<const float*>(params),
      static_cast<const int*>(window), sw, gh, gw, Wi, Hi);
  return static_cast<int>(cudaGetLastError());
}
