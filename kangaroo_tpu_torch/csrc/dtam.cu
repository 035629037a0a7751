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
// What bounds it on the H100: the volume's bytes, once per iteration.
// Counting each input byte once (the volume and five (H, W) planes in,
// four out), the 50-iteration VGA/64 bf16 solve moves 50 MB, 15 us at
// 3.35 TB/s, against 7.6 GFLOP of float32 work, 0.11 ms at 67 TFLOP/s. But
// each iteration re-reads the 39.3 MB volume and 13 planes of 1.23 MB, so
// the chained floor is ~2.77 GB, 0.83 ms; the search is most of it.
//
// Design: a GPU grid has no barrier, so a step that reads a neighbour's
// new value is its own launch, and stream order is the barrier. The dual
// step writes q(x) from d(x), d(x+1), d(y+1): its own launch. The primal
// step writes d(x) from q(x), q(x-1), q(y-1) and a(x), and the auxiliary
// search writes a(x) from the new d(x) alone, so both run in one launch
// (dtam_primal_search_kernel): each thread takes the search's span of P
// pixels (wta_sq.cuh, search_span, the very function of kt_wta_sq), runs
// the primal update on them in registers and the search from the new d,
// then writes d and a. Two launches an iteration, and d never makes the
// round trip to memory between the primal step and the search. Each step
// writes only what no other thread of the same launch reads, so d, a and
// q update in place.
//
// The design it replaced (kt_dtam_run_split, kept for the card checks):
// three launches an iteration, the primal step on its own (dtam_primal_kernel)
// and then the one-thread-per-pixel search (wta_sq.cuh, wta_sq_kernel).
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
// (rof.weighted_l2_primal_descent), from the divergence's terms
__device__ __forceinline__ float primal(float d, float a, float g, float q0, float q1,
                                        float prev_x, float prev_y, float sigma_d,
                                        float lam_t) {
  const float divq = fsub(fsub(fadd(q0, q1), prev_x), prev_y);
  const float num = fadd(d, fmul(sigma_d, fadd(fmul(g, divq), fmul(lam_t, a))));
  return fdiv(num, fadd(1.f, fmul(sigma_d, lam_t)));
}

// the primal step alone, one thread per pixel (the replaced design)
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
  d[i] = primal(d[i], a[i], g[i], q0[i], q1[i], prev_x, prev_y, sigma_d, lam_t);
}

// The primal step and then the search from the new d, on the search's span
// of P pixels a thread: reads d, a, g, q0, q1 at the span, q0 at x-1 and q1
// at y-1; writes d and a at the span.
template <typename T, int G>
__global__ void __launch_bounds__(wta_sq::kSpanThreads)
    dtam_primal_search_kernel(const T* __restrict__ vol, float* __restrict__ d,
                              float* __restrict__ a, const float* __restrict__ q0,
                              const float* __restrict__ q1, const float* __restrict__ g, int D,
                              int H, int W, int sd, float lam, float sigma_d, float theta) {
  constexpr int P = wta_sq::kPixels;
  const size_t HW = static_cast<size_t>(H) * W;
  const wta_sq::Span sp = wta_sq::span_of_thread<T, G>(HW);
  float dv[P], av[P];
  wta_sq::load_floats(d, sp, dv);
  wta_sq::load_floats(a, sp, av);
  const float lam_t = fdiv(1.f, theta);
  const int x0 = static_cast<int>(sp.p0 % W);
#pragma unroll
  for (int k = 0; k < P; ++k) {
    if (k < sp.lo || k >= sp.count) continue;
    const size_t i = sp.p0 + k;
    const float prev_x = wta_sq::column(x0, k, W) > 0 ? q0[i - 1] : 0.f;
    const float prev_y = i >= static_cast<size_t>(W) ? q1[i - W] : 0.f;
    dv[k] = primal(dv[k], av[k], g[i], q0[i], q1[i], prev_x, prev_y, sigma_d, lam_t);
  }
  wta_sq::search_span<T, G>(vol, HW, sp.p0, sp.count, W, D, sd, lam,
                            wta_sq::inv_two_theta(theta), dv, av);
  wta_sq::store_floats(d, sp, dv);
  wta_sq::store_floats(a, sp, av);
}

template <typename T, int G>
struct PrimalSearch {
  static void run(const void* vol, float* d, float* a, const float* q0, const float* q1,
                  const float* g, int D, int H, int W, int sd, float lam, float sigma_d,
                  float theta, cudaStream_t s) {
    const size_t HW = static_cast<size_t>(H) * W;
    dtam_primal_search_kernel<T, G>
        <<<wta_sq::span_blocks(HW, wta_sq::kPixels), wta_sq::kSpanThreads, 0, s>>>(
            static_cast<const T*>(vol), d, a, q0, q1, g, D, H, W, sd, lam, sigma_d, theta);
  }
};

bool bad_arguments(int D, int H, int W, int iterations, const float* thetas) {
  return D < 1 || H < 1 || W < 1 || iterations < 0 || (iterations > 0 && thetas == nullptr);
}

}  // namespace

// vol (D, H, W) f32 or bf16; g, d, a (H, W) f32; q (2, H, W) f32 (the
// two planes of the dual); d, a and q are updated in place. thetas: host
// array of `iterations` float32 values, theta for each iteration. Two
// launches an iteration: the dual step, then the primal step fused with
// the search.
extern "C" int kt_dtam_run(const void* vol, int vol_is_bf16, const void* g, void* d, void* a,
                           void* q, const float* thetas, int D, int H, int W, int sd, float lam,
                           float sigma_q, float sigma_d, float huber_alpha, int iterations,
                           void* stream) {
  if (bad_arguments(D, H, W, iterations, thetas)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t plane = static_cast<size_t>(H) * W;
  const float* gg = static_cast<const float*>(g);
  float* dd = static_cast<float*>(d);
  float* aa = static_cast<float*>(a);
  float* q0 = static_cast<float*>(q);
  float* q1 = q0 + plane;
  const int width = wta_sq::load_width(vol, vol_is_bf16 != 0, plane);
  const auto primal_search = vol_is_bf16 ? wta_sq::instance<PrimalSearch, __nv_bfloat16>(width)
                                         : wta_sq::instance<PrimalSearch, float>(width);
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((W + kBlockX - 1) / kBlockX, (H + kBlockY - 1) / kBlockY);
  for (int it = 0; it < iterations; ++it) {
    dtam_dual_kernel<<<grid, block, 0, s>>>(dd, gg, q0, q1, H, W, sigma_q, huber_alpha);
    primal_search(vol, dd, aa, q0, q1, gg, D, H, W, sd, lam, sigma_d, thetas[it], s);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// kt_dtam_run's arguments and results through the replaced design: three
// launches an iteration (dual, primal, the one-thread-per-pixel search).
// Launched only by the card checks.
extern "C" int kt_dtam_run_split(const void* vol, int vol_is_bf16, const void* g, void* d,
                                 void* a, void* q, const float* thetas, int D, int H, int W,
                                 int sd, float lam, float sigma_q, float sigma_d,
                                 float huber_alpha, int iterations, void* stream) {
  if (bad_arguments(D, H, W, iterations, thetas)) return static_cast<int>(cudaErrorInvalidValue);
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
    wta_sq::launch_pixel(vol, vol_is_bf16 != 0, dd, aa, D, H, W, sd, lam, thetas[it], s);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
