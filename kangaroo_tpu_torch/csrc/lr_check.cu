// Left-right consistency check of two float disparity images.
//
// Replaces kangaroo_tpu/stereo/lr_pallas.py:_lr_kernel (called through
// left_right_check there). Per pixel: xr = x + sd*dl; dl is kept iff xr is
// inside [0, W), the partner dr[y, trunc(min(xr, W-1))] is finite, and
// |dl - dr| <= max_diff; otherwise the output is NaN. The TPU kernel reads
// the partner through a sweep over the column offsets k = x - xi in
// [k_min, k_max] ([-1, max_disp) for sd = -1, [-max_disp, 2) for sd = +1),
// so a pixel whose offset lies outside the sweep reads NaN and is
// rejected; this kernel keeps that bound.
//
// What bounds it on the H100: bytes, three f32 images (two reads, one
// write) with a few operations per pixel.
//
// Design: a direct gather, one thread per pixel; the partner read is
// row-local, so it mostly hits in L1/L2. The in-bounds test comes first:
// a NaN dl never reaches the float-to-int conversion.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;

__global__ void lr_check_kernel(const float* __restrict__ disp_l, const float* __restrict__ disp_r,
                                float* __restrict__ out, int H, int W, int sd, float max_diff,
                                int k_min, int k_max) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= W) return;
  const size_t row = static_cast<size_t>(y) * W;
  const float dl = disp_l[row + x];
  const float xr = static_cast<float>(x) + static_cast<float>(sd) * dl;
  float result = CUDART_NAN_F;
  if (xr >= 0.f && xr < static_cast<float>(W)) {  // false for a NaN dl
    const int xi = static_cast<int>(fminf(xr, static_cast<float>(W - 1)));  // truncation
    const int k = x - xi;
    if (k >= k_min && k <= k_max) {
      const float dr = disp_r[row + xi];
      if (isfinite(dr) && fabsf(dl - dr) <= max_diff) result = dl;
    }
  }
  out[row + x] = result;
}

}  // namespace

extern "C" int kt_lr_check(const void* disp_l, const void* disp_r, void* out, int H, int W, int sd,
                           float max_diff, int k_min, int k_max, void* stream) {
  if (H < 1 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((W + kThreads - 1) / kThreads, H);
  lr_check_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(disp_l), static_cast<const float*>(disp_r),
      static_cast<float*>(out), H, W, sd, max_diff, k_min, k_max);
  return static_cast<int>(cudaGetLastError());
}
