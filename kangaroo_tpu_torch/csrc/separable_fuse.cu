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
// What bounds it on the H100: memory. Each voxel of the window reads and
// writes val and weight once (16 bytes); at 256^3 over every plane that is
// 268 MB, 0.080 ms at 3.35 TB/s. The warped grids (2 x gh x gw floats,
// 2.4 MB at VGA) stay in the 50 MB L2 and are read through __ldg.
//
// Design: the TPU kernel streams (P, Hv, Wv) slabs of the volume in sweep
// layout through VMEM and rebuilds the lerp matrices for MXU matmuls. Here
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

__global__ void separable_fuse_kernel(float* __restrict__ val, float* __restrict__ weight,
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

}  // namespace

// val, weight: (D, H, W) float32 [z, y, x], updated in place; gmd, gct:
// (gh, gw) float32; params: 20 float32 (separable.N_PARAMS); window: 2
// int32, the planes [k_lo, k_hi) of the sweep along axis 0 (z), 1 (y) or 2 (x).
extern "C" int kt_separable_fuse(void* val, void* weight, const void* gmd, const void* gct,
                                 const void* params, const void* window, int D, int H, int W,
                                 int axis, int gh, int gw, int Wi, int Hi, void* stream) {
  if (D < 1 || H < 1 || W < 1 || gh < 2 || gw < 2 || axis < 0 || axis > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t n = static_cast<size_t>(D) * H * W;
  const size_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffULL) return static_cast<int>(cudaErrorInvalidValue);
  separable_fuse_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(val), static_cast<float*>(weight), static_cast<const float*>(gmd),
      static_cast<const float*>(gct), static_cast<const float*>(params),
      static_cast<const int*>(window), D, H, W, axis, gh, gw, Wi, Hi);
  return static_cast<int>(cudaGetLastError());
}
