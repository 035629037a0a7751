// Winner-take-all disparity with parabola subpixel refinement.
//
// Replaces kangaroo_tpu/stereo/wta_pallas.py:_wta_kernel (called through
// cost_vol_minimum_subpix there). Per pixel: the first d attaining the
// minimum of the volume with entries off the lattice (x + sd*d outside the
// image) held at 1e10; then, reading the unmasked volume at the clamped
// neighbours bestd-1 and bestd+1, the parabola step
//   sub = bestd - (c+ - c-) / (2 (c+ - 2 c0 + c-)),
// kept only if the match x + sd*bestd is strictly interior and
// bestd-1 < sub < bestd+1.
//
// What bounds it on the H100: bytes. Each volume element is read once
// (plus three re-reads per pixel); there are a handful of operations per
// element, far below the card's operations-per-byte balance.
//
// Design: one thread per pixel, consecutive x on consecutive threads, so
// every d-plane read of a warp is one contiguous segment. The loop over d
// is sequential inside the thread; entries off the lattice are not loaded.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kBig = 1e10f;
constexpr int kThreads = 128;

__device__ __forceinline__ float load_cost(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float load_cost(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}

template <typename T>
__global__ void wta_kernel(const T* __restrict__ vol, float* __restrict__ out, int D, int H, int W,
                           int sd) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= W) return;
  const size_t HW = static_cast<size_t>(H) * W;
  const size_t p = static_cast<size_t>(y) * W + x;

  float best_c = kBig;
  int best_d = 0;
  for (int d = 0; d < D; ++d) {
    const int xr = x + sd * d;
    const float v = (xr >= 0 && xr < W) ? load_cost(vol, static_cast<size_t>(d) * HW + p) : kBig;
    if (d == 0 || v < best_c) {  // strict: the first index attaining the min
      best_c = v;
      best_d = d;
    }
  }
  const int dl = max(best_d - 1, 0);
  const int dr = min(best_d + 1, D - 1);
  const float sl = load_cost(vol, static_cast<size_t>(dl) * HW + p);
  const float sr = load_cost(vol, static_cast<size_t>(dr) * HW + p);
  const float c0 = load_cost(vol, static_cast<size_t>(best_d) * HW + p);
  const float denom = 2.0f * (sr - 2.0f * c0 + sl);
  const float sub = static_cast<float>(best_d) - (sr - sl) / denom;
  const int best_xr = x + sd * best_d;
  const bool interior = best_xr > 0 && best_xr < W - 1;
  const bool sensible = sub > static_cast<float>(best_d - 1) && sub < static_cast<float>(best_d + 1);
  out[p] = interior && sensible ? sub : static_cast<float>(best_d);
}

}  // namespace

extern "C" int kt_wta_subpix(const void* vol, int vol_is_bf16, void* out, int D, int H, int W,
                             int sd, void* stream) {
  if (D < 1 || H < 1 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((W + kThreads - 1) / kThreads, H);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (vol_is_bf16)
    wta_kernel<<<grid, kThreads, 0, s>>>(static_cast<const __nv_bfloat16*>(vol), o, D, H, W, sd);
  else
    wta_kernel<<<grid, kThreads, 0, s>>>(static_cast<const float*>(vol), o, D, H, W, sd);
  return static_cast<int>(cudaGetLastError());
}
