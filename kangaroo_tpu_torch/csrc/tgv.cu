// Second-order TGV-L1 primal-dual denoising, the whole solve.
//
// Replaces kangaroo_tpu/variational/pallas_solvers.py:_make_tgv_kernel
// (driven by tgv_denoise there). Nine field planes, from u = f and every
// other plane 0; per iteration:
//   AscentP  p = Pi(p + sigma a1 (grad+ u - v))
//   AscentQ  q = Pi_sym(q + sigma a0 Epsilon(v)),  |q|^2 = q0^2 + q1^2 + 2 q2^2
//   AscentR  r = Pi((r + sigma (u - f)) / (1 + sigma delta))
//   DescentU u = u - tau (r - a1 div- p)
//   DescentV v = v - tau (-a1 p - a0 div-_sym q)
// with the forward differences zero at the far edge and the backward
// divergences dropping the out-of-image term at the near edge. The
// arithmetic follows the Pallas body op for op but one: each divergence
// sums in the order of the JAX package's ops.divergence(_sym) and of the
// plain version, (px + py) - px(x-1) - py(y-1), where the Pallas body sums
// (px - px(x-1)) + py - py(y-1). TGV amplifies that last-bit difference:
// after 100 iterations at 640x480 the two orders end up 4e-3 apart (a
// float32 NumPy transcription of both), past the 1e-4 the kernel is held
// to, while with the plain order the transcription equals the plain
// version bit for bit. Products are rounded on their own (__fmul_rn) so the
// compiler does not contract them into FMAs that the plain PyTorch version
// does not have.
//
// What bounds it on the H100: memory traffic per iteration. At 640x480 the
// ten planes (f and the nine fields, 1.2 MB each) stay in the 50 MB L2, so
// each half-step streams about ten planes from L2; the 2 x iterations
// launches add a launch gap each.
//
// Design: the TPU kernel keeps the nine planes in VMEM and its loop orders
// the iterations; GPU blocks have no grid-wide barrier. Both halves update
// in place without a race: the ascent writes p, q, r at x from u and v
// (at x, x+1, y+1) and their own old values; the descent writes u and v at
// x from p, q (at x, x-1, y-1), r and their own old values. So one kernel
// per half, one thread per pixel, and the C entry launches the pair once
// per iteration in-stream: stream order is the grid-wide barrier.
#include <cuda_runtime.h>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }
// max(1, s) that keeps a NaN, as jnp.maximum does
__device__ __forceinline__ float max1(float s) { return s < 1.f ? 1.f : s; }

// v0, v1, p0, p1, q0, q1, q2, r: the eight planes besides u
struct Planes {
  float* v0;
  float* v1;
  float* p0;
  float* p1;
  float* q0;
  float* q1;
  float* q2;
  float* r;
};

__global__ void tgv_ascent_kernel(const float* __restrict__ u, const float* __restrict__ f,
                                  Planes s, int H, int W, float alpha0, float alpha1,
                                  float sigma, float delta) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= W || y >= H) return;
  const size_t i = static_cast<size_t>(y) * W + x;
  const bool has_x = x < W - 1, has_y = y < H - 1;
  const float uc = u[i], v0 = s.v0[i], v1 = s.v1[i];
  // AscentP
  const float sa1 = fmul(sigma, alpha1);
  const float n0 = s.p0[i] + fmul(sa1, (has_x ? u[i + 1] - uc : 0.f) - v0);
  const float n1 = s.p1[i] + fmul(sa1, (has_y ? u[i + W] - uc : 0.f) - v1);
  const float den = max1(sqrtf(fmul(n0, n0) + fmul(n1, n1)));
  s.p0[i] = n0 / den;
  s.p1[i] = n1 / den;
  // AscentQ
  const float e0 = has_x ? s.v0[i + 1] - v0 : 0.f;
  const float e1 = has_y ? s.v1[i + W] - v1 : 0.f;
  const float e2 = ((has_y ? s.v0[i + W] - v0 : 0.f) + (has_x ? s.v1[i + 1] - v1 : 0.f)) / 2.f;
  const float sa0 = fmul(sigma, alpha0);
  const float m0 = s.q0[i] + fmul(sa0, e0);
  const float m1 = s.q1[i] + fmul(sa0, e1);
  const float m2 = s.q2[i] + fmul(sa0, e2);
  const float qden = max1(sqrtf(fmul(m0, m0) + fmul(m1, m1) + fmul(fmul(2.f, m2), m2)));
  s.q0[i] = m0 / qden;
  s.q1[i] = m1 / qden;
  s.q2[i] = m2 / qden;
  // AscentR
  const float rn = (s.r[i] + fmul(sigma, uc - f[i])) / (1.f + fmul(sigma, delta));
  s.r[i] = rn / max1(fabsf(rn));
}

// px + py - px(x-1) - py(y-1), the out-of-image terms dropped
__device__ __forceinline__ float div_back(const float* px, const float* py, size_t i, int x,
                                          int y, int W) {
  const float prev_x = x > 0 ? px[i - 1] : 0.f;
  const float prev_y = y > 0 ? py[i - W] : 0.f;
  return px[i] + py[i] - prev_x - prev_y;
}

__global__ void tgv_descent_kernel(float* __restrict__ u, Planes s, int H, int W, float alpha0,
                                   float alpha1, float tau) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= W || y >= H) return;
  const size_t i = static_cast<size_t>(y) * W + x;
  // DescentU
  u[i] = u[i] - fmul(tau, s.r[i] - fmul(alpha1, div_back(s.p0, s.p1, i, x, y, W)));
  // DescentV
  const float d0 = div_back(s.q0, s.q2, i, x, y, W);
  const float d1 = div_back(s.q2, s.q1, i, x, y, W);
  s.v0[i] = s.v0[i] - fmul(tau, fmul(-alpha1, s.p0[i]) - fmul(alpha0, d0));
  s.v1[i] = s.v1[i] - fmul(tau, fmul(-alpha1, s.p1[i]) - fmul(alpha0, d1));
}

}  // namespace

// f, u (out): (H, W) f32; state: 8 planes of scratch (v0, v1, p0, p1, q0, q1, q2, r).
extern "C" int kt_tgv_denoise(const void* f, void* u, void* state, int H, int W, float alpha0,
                              float alpha1, float sigma, float tau, float delta, int iterations,
                              void* stream) {
  if (H < 1 || W < 1 || iterations < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t plane = static_cast<size_t>(H) * W;
  float* uu = static_cast<float*>(u);
  float* base = static_cast<float*>(state);
  const float* ff = static_cast<const float*>(f);
  const Planes s{base,             base + plane,     base + 2 * plane, base + 3 * plane,
                 base + 4 * plane, base + 5 * plane, base + 6 * plane, base + 7 * plane};
  cudaError_t err = cudaMemcpyAsync(uu, ff, plane * sizeof(float), cudaMemcpyDeviceToDevice, st);
  if (err == cudaSuccess) err = cudaMemsetAsync(base, 0, 8 * plane * sizeof(float), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((W + kBlockX - 1) / kBlockX, (H + kBlockY - 1) / kBlockY);
  for (int it = 0; it < iterations; ++it) {
    tgv_ascent_kernel<<<grid, block, 0, st>>>(uu, ff, s, H, W, alpha0, alpha1, sigma, delta);
    tgv_descent_kernel<<<grid, block, 0, st>>>(uu, s, H, W, alpha0, alpha1, tau);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
