// ROF / Huber-ROF primal-dual denoising (Chambolle-Pock), the whole solve.
//
// Replaces kangaroo_tpu/variational/pallas_solvers.py:_make_rof_kernel
// (driven by rof_denoise there). Per iteration, from u = g, p = 0:
//   n = p + sigma grad+ u            ('tv')
//   n = (p + sigma grad+ u) / (1 + sigma alpha)    ('huber')
//   p = n / max(1, |n|)
//   u = (u + tau (div- p + lam' g)) / (1 + tau lam'),  lam' = lam [* weight]
// with the forward gradient zero at the far edge and the backward
// divergence dropping the out-of-image term at the near edge. The
// arithmetic follows the Pallas body op for op but one: the divergence sums
// in the order of the JAX package's ops.divergence and of the plain
// version, (px + py) - px(x-1) - py(y-1), where the Pallas body sums
// (px - px(x-1)) + py - py(y-1); the two round differently in the last
// bit. Products are rounded on their own (__fmul_rn) so the compiler does
// not contract them into FMAs that the plain PyTorch version does not have.
//
// What bounds it on the H100: memory traffic per iteration. At 640x480 the
// state (u, p0, p1, g and the weight, 1.2 MB each) stays in the 50 MB L2,
// so each half-step streams a few MB from L2; the 2 x iterations launches
// add a launch gap each.
//
// Design: the TPU kernel keeps the state in VMEM and its loop orders the
// iterations; GPU blocks have no grid-wide barrier. Both half-steps update
// in place without a race: the dual step writes p(x) from p(x), u(x),
// u(x+1), u(y+1); the primal step writes u(x) from u(x), p(x), p(x-1),
// p(y-1). So one kernel per half-step, one thread per pixel, and the C
// entry launches the pair once per iteration in-stream: stream order is
// the grid-wide barrier.
#include <cuda_runtime.h>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }
// max(1, s) that keeps a NaN, as jnp.maximum does
__device__ __forceinline__ float max1(float s) { return s < 1.f ? 1.f : s; }

__global__ void rof_dual_kernel(const float* __restrict__ u, float* __restrict__ p0,
                                float* __restrict__ p1, int H, int W, float sigma, float alpha,
                                bool huber) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= W || y >= H) return;
  const size_t i = static_cast<size_t>(y) * W + x;
  const float uc = u[i];
  const float gx = x < W - 1 ? u[i + 1] - uc : 0.f;
  const float gy = y < H - 1 ? u[i + W] - uc : 0.f;
  float n0 = p0[i] + fmul(sigma, gx);
  float n1 = p1[i] + fmul(sigma, gy);
  if (huber) {
    const float shrink = 1.f + fmul(sigma, alpha);
    n0 = n0 / shrink;
    n1 = n1 / shrink;
  }
  const float den = max1(sqrtf(fmul(n0, n0) + fmul(n1, n1)));
  p0[i] = n0 / den;
  p1[i] = n1 / den;
}

__global__ void rof_primal_kernel(float* __restrict__ u, const float* __restrict__ p0,
                                  const float* __restrict__ p1, const float* __restrict__ g,
                                  const float* __restrict__ lam_weight, int H, int W, float lam,
                                  float tau) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= W || y >= H) return;
  const size_t i = static_cast<size_t>(y) * W + x;
  const float prev_x = x > 0 ? p0[i - 1] : 0.f;
  const float prev_y = y > 0 ? p1[i - W] : 0.f;
  const float divp = p0[i] + p1[i] - prev_x - prev_y;
  const float lam_px = lam_weight ? fmul(lam, lam_weight[i]) : lam;
  u[i] = (u[i] + fmul(tau, divp + fmul(lam_px, g[i]))) / (1.f + fmul(tau, lam_px));
}

}  // namespace

// g, lam_weight (may be null), u (out), p (2 planes of scratch): (H, W) f32.
extern "C" int kt_rof_denoise(const void* g, const void* lam_weight, void* u, void* p, int H,
                              int W, float lam, float sigma, float tau, float alpha, int huber,
                              int iterations, void* stream) {
  if (H < 1 || W < 1 || iterations < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t plane = static_cast<size_t>(H) * W;
  float* uu = static_cast<float*>(u);
  float* p0 = static_cast<float*>(p);
  float* p1 = p0 + plane;
  const float* gg = static_cast<const float*>(g);
  const float* lw = static_cast<const float*>(lam_weight);
  cudaError_t err = cudaMemcpyAsync(uu, gg, plane * sizeof(float), cudaMemcpyDeviceToDevice, s);
  if (err == cudaSuccess) err = cudaMemsetAsync(p0, 0, 2 * plane * sizeof(float), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((W + kBlockX - 1) / kBlockX, (H + kBlockY - 1) / kBlockY);
  for (int it = 0; it < iterations; ++it) {
    rof_dual_kernel<<<grid, block, 0, s>>>(uu, p0, p1, H, W, sigma, alpha, huber != 0);
    rof_primal_kernel<<<grid, block, 0, s>>>(uu, p0, p1, gg, lw, H, W, lam, tau);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
