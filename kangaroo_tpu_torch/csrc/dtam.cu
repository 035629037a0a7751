// The whole DTAM alternation (variational stereo), run in place over a
// number of iterations from one C call.
//
// Replaces kangaroo_tpu/stereo/dtam_pallas.py:_make_kernel (driven by
// dtam_solve and dtam_step there). Its reference semantics are the JAX
// package's XLA loop (apps/stereo.py dtam_solve / dtam_increment), which
// the port's plain version (apps/stereo.py:dtam_iterate_plain) transcribes.
// Iteration i, with theta_i given:
//   q = Pi((q + (sigma_q g) grad+ d) / (1 + sigma_q alpha))      dual
//   d = (d + sigma_d (g div- q + a / theta_i)) / (1 + sigma_d / theta_i)
//   a = argmin_z (d - z)^2 / (2 theta_i) + lam C(z), parabola-refined
// Products, sums, quotients and the square root are rounded on their own
// (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn), as the plain version's
// separate PyTorch ops are; the divergence sums in ops.divergence's order,
// (q0 + q1) - q0(x-1) - q1(y-1), not the Pallas body's. The anneal
// theta_{i+1} = theta_i (1 - beta (n0 + i)) is computed by the Python
// wrapper as a float32 array, one entry per iteration, and read here.
//
// What bounds it on the H100: float32 operations. The volume is read once
// per iteration; counting each input byte once (the volume and five (H, W)
// planes in, four out), the 50-iteration VGA/64 bf16 solve moves 50 MB,
// 15 us at 3.35 TB/s, against 7.4 GFLOP of float32 work, 0.11 ms at
// 67 TFLOP/s. In practice each iteration re-streams the 39.3 MB volume from
// L2 or HBM, so the volume traffic (~12 us per iteration from HBM) sets
// the pace.
//
// Design: a GPU grid has no barrier, so each dependent step is its own
// launch and stream order is the barrier, three per iteration: the dual
// step writes q(x) from d(x), d(x+1), d(y+1); the primal step writes d(x)
// from q(x), q(x-1), q(y-1) and a(x); the auxiliary search (wta_sq.cuh,
// the very kernel of kt_wta_sq) writes a(x) from the new d(x) and the
// volume column at x. Each step writes only what no other pixel of the
// same launch reads, so all three update in place. The primal step and
// the search could be one launch; they are kept apart so that the search
// launched here is kernel 8 itself, counted as such, at the cost of one
// launch and one (H, W) round trip per iteration.
#include <cuda_runtime.h>

#include "wta_sq.cuh"

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fdiv(float a, float b) { return __fdiv_rn(a, b); }
// max(1, s) that keeps a NaN, as torch.clamp does
__device__ __forceinline__ float max1(float s) { return s < 1.f ? 1.f : s; }

// weighted Huber dual ascent: q from d (rof.weighted_huber_dual_ascent_p)
__global__ void dtam_dual_kernel(const float* __restrict__ d, const float* __restrict__ g,
                                 float* __restrict__ q0, float* __restrict__ q1, int H, int W,
                                 float sigma_q, float alpha) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= W || y >= H) return;
  const size_t i = static_cast<size_t>(y) * W + x;
  const float dc = d[i];
  const float gx = x < W - 1 ? fsub(d[i + 1], dc) : 0.f;
  const float gy = y < H - 1 ? fsub(d[i + W], dc) : 0.f;
  const float sw = fmul(sigma_q, g[i]);
  const float shrink = fadd(1.f, fmul(sigma_q, alpha));
  const float n0 = fdiv(fadd(q0[i], fmul(sw, gx)), shrink);
  const float n1 = fdiv(fadd(q1[i], fmul(sw, gy)), shrink);
  const float den = max1(__fsqrt_rn(fadd(fmul(n0, n0), fmul(n1, n1))));
  q0[i] = fdiv(n0, den);
  q1[i] = fdiv(n1, den);
}

// weighted L2 primal descent towards a with weight 1/theta
// (rof.weighted_l2_primal_descent)
__global__ void dtam_primal_kernel(float* __restrict__ d, const float* __restrict__ a,
                                   const float* __restrict__ q0, const float* __restrict__ q1,
                                   const float* __restrict__ g, int H, int W, float sigma_d,
                                   float theta) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= W || y >= H) return;
  const size_t i = static_cast<size_t>(y) * W + x;
  const float lam_t = fdiv(1.f, theta);
  const float prev_x = x > 0 ? q0[i - 1] : 0.f;
  const float prev_y = y > 0 ? q1[i - W] : 0.f;
  const float divq = fsub(fsub(fadd(q0[i], q1[i]), prev_x), prev_y);
  const float num = fadd(d[i], fmul(sigma_d, fadd(fmul(g[i], divq), fmul(lam_t, a[i]))));
  d[i] = fdiv(num, fadd(1.f, fmul(sigma_d, lam_t)));
}

}  // namespace

// vol (D, H, W) f32 or bf16; g, d, a (H, W) f32; q (2, H, W) f32 (the
// two planes of the dual); d, a and q are updated in place. thetas: host
// array of `iterations` float32 values, theta for each iteration.
extern "C" int kt_dtam_run(const void* vol, int vol_is_bf16, const void* g, void* d, void* a,
                           void* q, const float* thetas, int D, int H, int W, int sd, float lam,
                           float sigma_q, float sigma_d, float huber_alpha, int iterations,
                           void* stream) {
  if (D < 1 || H < 1 || W < 1 || iterations < 0 || (iterations > 0 && thetas == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t plane = static_cast<size_t>(H) * W;
  const float* gg = static_cast<const float*>(g);
  float* dd = static_cast<float*>(d);
  float* aa = static_cast<float*>(a);
  float* q0 = static_cast<float*>(q);
  float* q1 = q0 + plane;
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((W + kBlockX - 1) / kBlockX, (H + kBlockY - 1) / kBlockY);
  for (int it = 0; it < iterations; ++it) {
    dtam_dual_kernel<<<grid, block, 0, s>>>(dd, gg, q0, q1, H, W, sigma_q, huber_alpha);
    dtam_primal_kernel<<<grid, block, 0, s>>>(dd, aa, q0, q1, gg, H, W, sigma_d, thetas[it]);
    wta_sq::launch(vol, vol_is_bf16 != 0, dd, aa, D, H, W, sd, lam, thetas[it], s);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
