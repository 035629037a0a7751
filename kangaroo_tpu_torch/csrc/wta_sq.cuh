// The DTAM auxiliary search (kernel and launcher), shared by its own C entry
// (wta_sq.cu, kt_wta_sq) and the whole-alternation entry (dtam.cu,
// kt_dtam_run), which launches this same kernel once per iteration.
//
// Replaces kangaroo_tpu/stereo/wta_pallas.py:_wta_sq_kernel (called through
// cost_vol_minimum_square_penalty_subpix there). Per pixel, with
// inv2theta = 1 / (2 theta) and last the current primal disparity:
//   cost(d) = inv2theta * ((last - d) * (last - d)) + lam * C(d)
// held at 1e10 where x + sd*d leaves the image; bestd is the first d
// attaining the minimum (NaN first, as torch.argmin takes it). The parabola
// runs through the penalised costs at bestd-1 and bestd+1, the volume read
// at the clamped index and the penalty at the unclamped one:
//   sub = bestd - (cr - cl) / (2 ((cr - 2 best) + cl)),
// kept where x + sd*bestd is strictly interior and bestd-1 < sub < bestd+1.
// The arithmetic is that of the plain version
// (stereo/costvolume.py:cost_vol_minimum_square_penalty_subpix) op for op:
// every product, sum and quotient is rounded on its own (__fmul_rn,
// __fadd_rn, __fdiv_rn), so nothing is contracted into an FMA the plain
// version lacks. This is the JAX package's XLA formulation; its Pallas
// body computes (inv2theta * dd) * dd, which rounds differently.
//
// What bounds it on the H100: bytes. One pass over the volume (bf16 or
// f32) with about 7 float operations per element: at VGA/64 bf16 that is
// 39.3 MB against 0.14 GFLOP, 11.7 us of HBM time against 2 us of float32
// work at 67 TFLOP/s.
//
// Design: one thread per pixel, consecutive x on consecutive threads, so
// every d-plane read of a warp is one contiguous segment; the loop over d
// is sequential inside the thread. The parabola's neighbours are tracked
// in the same pass, as the Pallas kernel does: C(bestd-1) is the previous
// slice when a new best is taken, C(bestd+1) is caught one slice later, and
// a best at D-1 reads its own slice. Every slice is loaded, masked or not,
// since a neighbour of the best may lie off the lattice.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace wta_sq {
// internal linkage: each source that includes this header has its own copy
namespace {

constexpr float kBig = 1e10f;
constexpr int kThreads = 128;

__device__ __forceinline__ float load_cost(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float load_cost(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}

// inv2theta * ((last - d)^2) + lam * c, each operation rounded on its own
__device__ __forceinline__ float penalised(float last, float d, float c, float lam,
                                          float inv2theta) {
  const float e = __fsub_rn(last, d);
  return __fadd_rn(__fmul_rn(inv2theta, __fmul_rn(e, e)), __fmul_rn(lam, c));
}

// The search for the pixel at flat index p (column x) of a (D, H*W) volume.
template <typename T>
__device__ __forceinline__ float search(const T* __restrict__ vol, size_t HW, size_t p, int x,
                                        int W, int D, int sd, float last, float lam,
                                        float inv2theta) {
  float best = 0.f, vl = 0.f, vr = 0.f, cprev = 0.f;
  int bestd = 0;
  for (int d = 0; d < D; ++d) {
    const float c = load_cost(vol, static_cast<size_t>(d) * HW + p);
    const int xr = x + sd * d;
    const float v =
        (xr >= 0 && xr < W) ? penalised(last, static_cast<float>(d), c, lam, inv2theta) : kBig;
    if (d == bestd + 1) vr = c;  // the slice after the best so far
    // strict: the first index attaining the min; a NaN wins over a number
    if (d == 0 || v < best || (v != v && best == best)) {
      best = v;
      bestd = d;
      vl = d > 0 ? cprev : c;  // C(clamp(bestd - 1, 0))
    }
    cprev = c;
  }
  if (bestd == D - 1) vr = cprev;  // C(clamp(bestd + 1, D - 1))
  const float bf = static_cast<float>(bestd);
  const float dlf = bf - 1.f, drf = bf + 1.f;  // exact
  const float cl = penalised(last, dlf, vl, lam, inv2theta);
  const float cr = penalised(last, drf, vr, lam, inv2theta);
  const float denom = __fmul_rn(2.f, __fadd_rn(__fsub_rn(cr, __fmul_rn(2.f, best)), cl));
  const float sub = __fsub_rn(bf, __fdiv_rn(__fsub_rn(cr, cl), denom));
  const int best_xr = x + sd * bestd;
  const bool interior = best_xr > 0 && best_xr < W - 1;
  const bool sensible = sub > dlf && sub < drf;
  return interior && sensible ? sub : bf;
}

// out[y, x] = the search at (y, x) with last = last[y, x]. out may alias
// last: each thread reads its own pixel before writing it.
template <typename T>
__global__ void wta_sq_kernel(const T* __restrict__ vol, const float* last, float* out, int D,
                              int H, int W, int sd, float lam, float theta) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= W) return;
  const size_t p = static_cast<size_t>(y) * W + x;
  const float inv2theta = __fdiv_rn(1.f, __fmul_rn(2.f, theta));
  out[p] = search(vol, static_cast<size_t>(H) * W, p, x, W, D, sd, last[p], lam, inv2theta);
}

inline void launch(const void* vol, bool vol_is_bf16, const float* last, float* out, int D,
                   int H, int W, int sd, float lam, float theta, cudaStream_t s) {
  const dim3 grid((W + kThreads - 1) / kThreads, H);
  if (vol_is_bf16)
    wta_sq_kernel<<<grid, kThreads, 0, s>>>(static_cast<const __nv_bfloat16*>(vol), last, out,
                                             D, H, W, sd, lam, theta);
  else
    wta_sq_kernel<<<grid, kThreads, 0, s>>>(static_cast<const float*>(vol), last, out, D, H,
                                             W, sd, lam, theta);
}

}  // namespace
}  // namespace wta_sq
