// The running-mean update of a keyframe's cost volume by one posed view
// (MultiViewStereo.add): for each (d, v, u), unproject the keyframe pixel
// at depth z = fu * baseline / max(d, 1e-9), project it through KT_cv
// (3, 4) into the contributing image, and where it lands in front of the
// camera and 5 pixels inside the image, add 1 to n and the zero-mean SAD
// over the (2 rad + 1)^2 patch (keyframe at integer taps with clamped
// borders, contributing image bilinear) over the patch area to s.
//
// No Pallas kernel is replaced: the JAX package leaves cost_volume_add to
// XLA (kangaroo_tpu/stereo/costvolume.py). It was written because the
// plain PyTorch version, about 470 elementwise passes over (D, H, W)
// float32 temporaries a view, took 99 % of the keyframe cell's device time.
//
// Bit-equal to the plain version on the card
// (stereo/costvolume.py:_cost_volume_add_plain): every product, sum and
// division rounds once, in the plain version's order, through __fmul_rn,
// __fadd_rn, __fsub_rn and __fdiv_rn, so that nvcc contracts nothing into
// a fused multiply-add; torch.addcmul(a, b, c) on the card is one, and is
// __fmaf_rn(b, c, a) here. A tap's coordinate is pu + dx in float32, its
// floor, fraction, clamps and row offset as the plain version's float
// arithmetic computes them, and the gathered index that float sum
// truncated.
//
// What bounds it on the H100: bytes, n and s read once and written once
// (4 x 157.3 MB at VGA/128: 0.188 ms at 3.35 TB/s). The ALU holds it at
// about 2.4 times that: the projection's four IEEE divisions in every
// cell, and in a cell in view the taps' coordinates, 21 lerps (at rad 1)
// and two more divisions. The contributing image (1.2 MB) stays in L2.
//
// Design: one thread a pixel (v, u), consecutive u on consecutive threads,
// so each d-plane load and store of n and s is one contiguous segment a
// warp, the next d's loaded before this d's work; a block's threads share
// a row and a chunk of kDChunk disparities (blockIdx.z), whose depths z(d)
// the block computes once into shared memory. Per pixel, outside the d
// loop: the keyframe's taps, their mean and each tap less the mean, and
// (u - u0), (v - v0). A cell that is not in view takes no tap: it writes
// n + 0 and s + 0. At rad 1 (the keyframe cell's) the taps live in
// registers, a cell in view loads the 4x4 pixels around (floor(pu),
// floor(pv)) once, and its taps share the lerps along x of those rows (R = 1
// below); other radii take the keyframe's taps from the image (L1) and
// compute the contributing image's taps twice, for the mean and for the
// SAD.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kDChunk = 32;
static_assert(kDChunk <= kThreads, "a block's threads fill its depths");

// torch.addcmul(a, b, c) with value 1 on the card: a + b * c, rounded once
__device__ __forceinline__ float addcmul(float a, float b, float c) {
  return __fmaf_rn(b, c, a);
}

// torch.clamp(x, lo, hi) of a finite x
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// the two rows lerped along x, then along y
__device__ __forceinline__ float lerp2(float tl, float tr, float bl, float br, float fx,
                                       float fy) {
  const float top = addcmul(tl, __fsub_rn(tr, tl), fx);
  const float bot = addcmul(bl, __fsub_rn(br, bl), fx);
  return addcmul(top, __fsub_rn(bot, top), fy);
}

// _bilinear_finite of the (H, W) image at (x, y): float offsets r + c of
// clamped corners, each corner gathered at that sum truncated
__device__ __forceinline__ float bilinear(const float* __restrict__ img, float Wf, float Wm,
                                          float Hm, float x, float y) {
  const float x0 = floorf(x), y0 = floorf(y);
  const float ix0 = clampf(x0, 0.0f, Wm), ix1 = clampf(__fadd_rn(x0, 1.0f), 0.0f, Wm);
  const float r0 = __fmul_rn(clampf(y0, 0.0f, Hm), Wf);
  const float r1 = __fmul_rn(clampf(__fadd_rn(y0, 1.0f), 0.0f, Hm), Wf);
  return lerp2(__ldg(img + static_cast<long long>(__fadd_rn(r0, ix0))),
               __ldg(img + static_cast<long long>(__fadd_rn(r0, ix1))),
               __ldg(img + static_cast<long long>(__fadd_rn(r1, ix0))),
               __ldg(img + static_cast<long long>(__fadd_rn(r1, ix1))), __fsub_rn(x, x0),
               __fsub_rn(y, y0));
}

// R = 1: the cell's radius, its taps in registers, and the window: the
// (2R + 2)^2 pixels of the contributing image around (floor(pu), floor(pv))
// are loaded once a cell, and a tap whose floors are floor(pu) + dx and
// floor(pv) + dy takes its corners from them: its lerps along x are those
// of the window's rows at its dx, which the taps of one dx share (the same
// corners, the same fraction, the same bits). Launched only where that is
// the plain version's gather: H W <= 2^24 (the float offsets r + c are
// exact; a cell in view keeps every such corner inside the image, so no
// clamp acts). A tap whose coordinate rounded across an integer (pu + dx up
// to the next integer) gathers on its own. R < 0: the radius ``rad``, the
// taps gathered as the plain version gathers them.
template <int R>
__global__ void __launch_bounds__(kThreads)
cost_volume_add_kernel(const float* __restrict__ n, const float* __restrict__ s,
                       const float* __restrict__ img_v, const float* __restrict__ img_c,
                       const float* __restrict__ M, float* __restrict__ n_out,
                       float* __restrict__ s_out, int D, int H, int W, int rad, float fu, float fv,
                       float u0, float v0, float baseline, float tiny) {
  constexpr bool kWindow = R >= 0;
  constexpr int kTaps = kWindow ? (2 * R + 1) * (2 * R + 1) : 1;
  constexpr int kWin = kWindow ? 2 * R + 2 : 1;
  __shared__ float zs[kDChunk];
  const int u = blockIdx.x * kThreads + threadIdx.x;
  const int v = blockIdx.y;
  const int d0 = blockIdx.z * kDChunk;
  const int d1 = min(d0 + kDChunk, D);
  if (kWindow) rad = R;
  if (threadIdx.x < d1 - d0) {
    // fu * baseline / max(d, 1e-9), the product rounded first
    zs[threadIdx.x] = __fdiv_rn(__fmul_rn(fu, baseline),
                                fmaxf(static_cast<float>(d0 + threadIdx.x), tiny));
  }
  __syncthreads();
  if (u >= W) return;

  const int side = 2 * rad + 1;
  const int taps = side * side;
  const float area = static_cast<float>(taps);
  const float Wf = static_cast<float>(W), Wm = static_cast<float>(W - 1);
  const float Hm = static_cast<float>(H - 1);
  const float u_hi = static_cast<float>(W - 5), v_hi = static_cast<float>(H - 5);

  // the keyframe's taps at clamped integer offsets, their mean (summed from
  // 0 in tap order), and each tap less the mean
  auto key_tap = [&](int k) {
    const int yy = min(max(v + k / side - rad, 0), H - 1);
    const int xx = min(max(u + k % side - rad, 0), W - 1);
    return __ldg(img_v + static_cast<size_t>(yy) * W + xx);
  };
  float mean_v = 0.0f;
  float a[kTaps];
#pragma unroll
  for (int k = 0; k < taps; ++k) {
    const float t = key_tap(k);
    if (kWindow) a[k] = t;
    mean_v = __fadd_rn(mean_v, t);
  }
  mean_v = __fdiv_rn(mean_v, area);
  if (kWindow) {
#pragma unroll
    for (int k = 0; k < kTaps; ++k) a[k] = __fsub_rn(a[k], mean_v);
  }

  float m[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) m[i] = __ldg(M + i);
  const float du = __fsub_rn(static_cast<float>(u), u0);
  const float dv = __fsub_rn(static_cast<float>(v), v0);
  const size_t HW = static_cast<size_t>(H) * W;
  size_t at = static_cast<size_t>(d0) * HW + static_cast<size_t>(v) * W + u;

  // n and s of the next d are loaded before this d's work, so that a
  // warp keeps two loads of each in flight
  float n_next = n[at], s_next = s[at];
  for (int d = d0; d < d1; ++d, at += HW) {
    const float n_in = n_next, s_in = s_next;
    if (d + 1 < d1) {
      n_next = n[at + HW];
      s_next = s[at + HW];
    }
    const float z = zs[d - d0];
    const float p0 = __fdiv_rn(__fmul_rn(z, du), fu);
    const float p1 = __fdiv_rn(__fmul_rn(z, dv), fv);
    // (P @ M[:, :3].T + M[:, 3])[i]: the products summed as the plain
    // version's addcmuls, then the translation added
    float row[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float* r = m + 4 * i;
      row[i] = __fadd_rn(addcmul(addcmul(__fmul_rn(p0, r[0]), p1, r[1]), z, r[2]), r[3]);
    }
    const float kz = row[2];
    const float pu = __fdiv_rn(row[0], kz), pv = __fdiv_rn(row[1], kz);
    const bool ok = kz > 0.0f && pu >= 5.0f && pu < u_hi && pv >= 5.0f && pv < v_hi;
    float add = 0.0f;
    if (ok) {
      // the contributing image's taps at (pu + dx, pv + dy), their mean
      const float fu0 = floorf(pu), fv0 = floorf(pv);
      // with the window: each dx's fraction along x and whether its floor is
      // fu0 + dx, each dy's along y, and the lerps along x of the window's
      // rows at each dx (a tap's top and bottom when both floors match)
      float hor[kWin][kWindow ? 2 * R + 1 : 1], fx[kWin], fy[kWin];
      bool on_x[kWin], on_y[kWin];
      if constexpr (kWindow) {
        const float* w0 = img_c + static_cast<size_t>(static_cast<int>(fv0) - R) * W +
                          (static_cast<int>(fu0) - R);
        float win[kWin][kWin];
#pragma unroll
        for (int i = 0; i < kWin; ++i) {
#pragma unroll
          for (int j = 0; j < kWin; ++j) win[i][j] = __ldg(w0 + static_cast<size_t>(i) * W + j);
        }
#pragma unroll
        for (int j = 0; j <= 2 * R; ++j) {
          const float x = __fadd_rn(pu, static_cast<float>(j - R)), x0 = floorf(x);
          const float y = __fadd_rn(pv, static_cast<float>(j - R)), y0 = floorf(y);
          fx[j] = __fsub_rn(x, x0);
          fy[j] = __fsub_rn(y, y0);
          on_x[j] = x0 == __fadd_rn(fu0, static_cast<float>(j - R));
          on_y[j] = y0 == __fadd_rn(fv0, static_cast<float>(j - R));
#pragma unroll
          for (int i = 0; i < kWin; ++i)
            hor[i][j] = addcmul(win[i][j], __fsub_rn(win[i][j + 1], win[i][j]), fx[j]);
        }
      }
      auto view_tap = [&](int k) {
        const int i = k / side, j = k % side;
        if constexpr (kWindow) {
          if (on_x[j] && on_y[i])
            return addcmul(hor[i][j], __fsub_rn(hor[i + 1][j], hor[i][j]), fy[i]);
        }
        return bilinear(img_c, Wf, Wm, Hm, __fadd_rn(pu, static_cast<float>(j - rad)),
                        __fadd_rn(pv, static_cast<float>(i - rad)));
      };
      float b[kTaps];
      float mean_c = 0.0f;
#pragma unroll
      for (int k = 0; k < taps; ++k) {
        const float t = view_tap(k);
        if (kWindow) b[k] = t;
        mean_c = __fadd_rn(mean_c, t);
      }
      mean_c = __fdiv_rn(mean_c, area);
      // sum of |(a_k - mean_v) - (b_k - mean_c)| from 0 in tap order
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < taps; ++k) {
        const float ak = kWindow ? a[k] : __fsub_rn(key_tap(k), mean_v);
        const float bk = kWindow ? b[k] : view_tap(k);
        acc = __fadd_rn(acc, fabsf(__fsub_rn(ak, __fsub_rn(bk, mean_c))));
      }
      add = __fdiv_rn(acc, area);
    }
    n_out[at] = __fadd_rn(n_in, ok ? 1.0f : 0.0f);
    s_out[at] = __fadd_rn(s_in, add);
  }
}

}  // namespace

extern "C" int kt_cost_volume_add(const void* n, const void* s, const void* img_v,
                                  const void* img_c, const void* M, void* n_out, void* s_out,
                                  int D, int H, int W, int rad, float fu, float fv, float u0,
                                  float v0, float baseline, float tiny, void* stream) {
  if (D < 1 || H < 1 || W < 1 || rad < 0 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((W + kThreads - 1) / kThreads, H, (D + kDChunk - 1) / kDChunk);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* nn = static_cast<const float*>(n);
  const auto* ss = static_cast<const float*>(s);
  const auto* iv = static_cast<const float*>(img_v);
  const auto* ic = static_cast<const float*>(img_c);
  const auto* mm = static_cast<const float*>(M);
  auto* no = static_cast<float*>(n_out);
  auto* so = static_cast<float*>(s_out);
  if (rad == 1 && static_cast<long long>(H) * W <= (1LL << 24))
    cost_volume_add_kernel<1><<<grid, kThreads, 0, st>>>(nn, ss, iv, ic, mm, no, so, D, H, W, rad,
                                                         fu, fv, u0, v0, baseline, tiny);
  else
    cost_volume_add_kernel<-1><<<grid, kThreads, 0, st>>>(nn, ss, iv, ic, mm, no, so, D, H, W,
                                                          rad, fu, fv, u0, v0, baseline, tiny);
  return static_cast<int>(cudaGetLastError());
}
