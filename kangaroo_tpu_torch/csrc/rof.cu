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
// What bounds it on the H100: not bytes (the state, 3 planes of 1.2 MB at
// 640x480, fits in the 50 MB L2) and not the 27 operations a pixel and
// iteration the bound counts, but instruction issue and the steps'
// dependence. A cell and step takes about 90 instructions, five IEEE
// divisions and a square root among them (divisions that may be an ulp
// off would take a third off a solve), and each iteration reads its
// neighbours' results of the one before. One thread a pixel with a launch
// a half-step (the design it replaced, below) spent most of a solve on its
// 200 launch gaps and grid drains.
//
// Design (kt_rof_denoise): the TPU kernel keeps u, p0, p1 in VMEM and runs
// every iteration in one call. Dual and primal steps together reach one
// pixel further each iteration (the dual step reads u(x+1), u(y+1), the
// primal step p0(x-1), p1(y-1)), so kSteps iterations of a tile need the
// state of a halo kSteps wide around it and nothing else. A block owns a
// kTileX x kTileY tile: it loads u, p0, p1 of the tile and its halo into
// shared memory, runs min(kSteps, iterations left) dual + primal steps
// there with a barrier between the half-steps, and writes the tile back, so
// a solve takes ceil(iterations / kSteps) launches. The halo's cells are
// work done twice (1.9x the image's cells at 32x16 and kSteps 4, 2.9x at
// kSteps 8) and each launch reloads the state: kSteps 4 and 512 threads a
// block measured fastest (chip_smoke.py phase 4 builds the others). Each thread keeps the
// state, lam' g and 1 + tau lam' of its cells in registers; shared memory
// only passes neighbours' values. Step s is right only at cells at least s
// from a side of the halo that has image beyond it (the cone); the steps
// skip the cells outside it, and the image's own edges follow the rules
// above by global coordinate (a cell beyond the image is never read).
// Neighbouring blocks read each other's halos in the same launch, so a
// launch reads one copy of the state and writes the other (ping-pong): the
// C entry alternates two copies and lets the last launch write u. Every
// expression is the one the per-pixel kernels below evaluate, so the two
// designs agree bit for bit.
//
// kt_rof_denoise_steps, the design it replaced (a dual kernel and a primal
// kernel per iteration, one thread a pixel, in place: the dual step writes
// p(x) from p(x), u(x), u(x+1), u(y+1); the primal step writes u(x) from
// u(x), p(x), p(x-1), p(y-1)), stays as the yardstick that the card checks
// hold the tiles against; no path launches it.
#include <cuda_runtime.h>

namespace {

// The tile a block owns, and the iterations a launch runs (its halo).
constexpr int kTileX = 32;
constexpr int kTileY = 16;
constexpr int kSteps = 4;
constexpr int kThreads = 512;
constexpr int kExtX = kTileX + 2 * kSteps;  // the tile and its halo
constexpr int kExtY = kTileY + 2 * kSteps;
constexpr int kCells = kExtX * kExtY;
constexpr int kPerThread = (kCells + kThreads - 1) / kThreads;
static_assert(3 * kCells * sizeof(float) <= 48 * 1024, "static shared memory");

// a cell's flags: in the image, its neighbours in the tile and the image,
// in the tile's interior; above kDepthShift, its distance from the nearest
// side of the halo that has image beyond it (capped)
constexpr unsigned kInside = 1, kRight = 2, kDown = 4, kLeft = 8, kUp = 16, kInterior = 32;
constexpr int kDepthShift = 8;
constexpr int kMaxDepth = 255;

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }
// max(1, s) that keeps a NaN, as jnp.maximum does
__device__ __forceinline__ float max1(float s) { return s < 1.f ? 1.f : s; }

// The state read by a launch and the state it writes.
struct State {
  const float* u_in;
  const float* p0_in;
  const float* p1_in;
  float* u_out;
  float* p0_out;
  float* p1_out;
};

template <bool kHuber, bool kWeighted>
__global__ void __launch_bounds__(kThreads)
    rof_tile_kernel(const float* __restrict__ g, const float* __restrict__ lam_weight, State st,
                    int H, int W, float lam, float sigma, float tau, float alpha, int steps,
                    bool first, bool write_p) {
  __shared__ float su[kCells], sp0[kCells], sp1[kCells];
  const int ox = static_cast<int>(blockIdx.x) * kTileX - kSteps;
  const int oy = static_cast<int>(blockIdx.y) * kTileY - kSteps;
  // the sides of the halo with image beyond them
  const bool cut_l = ox > 0, cut_r = ox + kExtX < W, cut_t = oy > 0, cut_b = oy + kExtY < H;
  float u[kPerThread], p0[kPerThread], p1[kPerThread], lg[kPerThread], den[kPerThread];
  unsigned flags[kPerThread];
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const int c = static_cast<int>(threadIdx.x) + r * kThreads;
    const int ex = c % kExtX, ey = c / kExtX;
    const int x = ox + ex, y = oy + ey;
    flags[r] = 0;
    u[r] = p0[r] = p1[r] = lg[r] = den[r] = 0.f;
    if (c >= kCells || x < 0 || x >= W || y < 0 || y >= H) continue;
    int depth = kMaxDepth;
    if (cut_l) depth = min(depth, ex);
    if (cut_r) depth = min(depth, kExtX - 1 - ex);
    if (cut_t) depth = min(depth, ey);
    if (cut_b) depth = min(depth, kExtY - 1 - ey);
    flags[r] = kInside | (x < W - 1 && ex < kExtX - 1 ? kRight : 0u) |
               (y < H - 1 && ey < kExtY - 1 ? kDown : 0u) | (x > 0 && ex > 0 ? kLeft : 0u) |
               (y > 0 && ey > 0 ? kUp : 0u) |
               (ex >= kSteps && ex < kSteps + kTileX && ey >= kSteps && ey < kSteps + kTileY
                    ? kInterior
                    : 0u) |
               (static_cast<unsigned>(depth) << kDepthShift);
    const size_t i = static_cast<size_t>(y) * W + x;
    const float gi = g[i];
    const float lam_px = kWeighted ? fmul(lam, lam_weight[i]) : lam;
    lg[r] = fmul(lam_px, gi);
    den[r] = 1.f + fmul(tau, lam_px);
    if (first) {
      u[r] = gi;
    } else {
      u[r] = st.u_in[i];
      p0[r] = st.p0_in[i];
      p1[r] = st.p1_in[i];
    }
    su[c] = u[r];
  }
  __syncthreads();
  for (int m = 0; m < steps; ++m) {
    // dual step on the cells at depth m and more
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) {
      const unsigned f = flags[r];
      if (!(f & kInside) || static_cast<int>(f >> kDepthShift) < m) continue;
      const int c = static_cast<int>(threadIdx.x) + r * kThreads;
      const float uc = u[r];
      const float gx = f & kRight ? su[c + 1] - uc : 0.f;
      const float gy = f & kDown ? su[c + kExtX] - uc : 0.f;
      float n0 = p0[r] + fmul(sigma, gx);
      float n1 = p1[r] + fmul(sigma, gy);
      if (kHuber) {
        const float shrink = 1.f + fmul(sigma, alpha);
        n0 = n0 / shrink;
        n1 = n1 / shrink;
      }
      const float d = max1(sqrtf(fmul(n0, n0) + fmul(n1, n1)));
      p0[r] = n0 / d;
      p1[r] = n1 / d;
      sp0[c] = p0[r];
      sp1[c] = p1[r];
    }
    __syncthreads();
    // primal step on the cells at depth m + 1 and more
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) {
      const unsigned f = flags[r];
      if (!(f & kInside) || static_cast<int>(f >> kDepthShift) <= m) continue;
      const int c = static_cast<int>(threadIdx.x) + r * kThreads;
      const float prev_x = f & kLeft ? sp0[c - 1] : 0.f;
      const float prev_y = f & kUp ? sp1[c - kExtX] : 0.f;
      const float divp = p0[r] + p1[r] - prev_x - prev_y;
      u[r] = (u[r] + fmul(tau, divp + lg[r])) / den[r];
      su[c] = u[r];
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    if (!(flags[r] & kInterior) || !(flags[r] & kInside)) continue;
    const int c = static_cast<int>(threadIdx.x) + r * kThreads;
    const size_t i = static_cast<size_t>(oy + c / kExtX) * W + (ox + c % kExtX);
    st.u_out[i] = u[r];
    if (write_p) {
      st.p0_out[i] = p0[r];
      st.p1_out[i] = p1[r];
    }
  }
}

// --- the design it replaced: two launches an iteration, in place ----------

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

using TileKernel = void (*)(const float*, const float*, State, int, int, float, float, float,
                            float, int, bool, bool);

}  // namespace

// g, lam_weight (may be null), u (out): (H, W) f32; state: 5 planes of
// scratch, the second copy of u and both copies of p0, p1. Launch l reads
// one copy and writes the other; the last launch writes u.
extern "C" int kt_rof_denoise(const void* g, const void* lam_weight, void* u, void* state, int H,
                              int W, float lam, float sigma, float tau, float alpha, int huber,
                              int iterations, void* stream) {
  if (H < 1 || W < 1 || iterations < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t plane = static_cast<size_t>(H) * W;
  const float* gg = static_cast<const float*>(g);
  float* uu = static_cast<float*>(u);
  if (iterations == 0)
    return static_cast<int>(
        cudaMemcpyAsync(uu, gg, plane * sizeof(float), cudaMemcpyDeviceToDevice, s));
  float* sc = static_cast<float*>(state);
  float* copies[2][3] = {{uu, sc + plane, sc + 2 * plane}, {sc, sc + 3 * plane, sc + 4 * plane}};
  const bool weighted = lam_weight != nullptr;
  const TileKernel kernel = huber ? (weighted ? rof_tile_kernel<true, true>
                                              : rof_tile_kernel<true, false>)
                                  : (weighted ? rof_tile_kernel<false, true>
                                              : rof_tile_kernel<false, false>);
  const dim3 grid((W + kTileX - 1) / kTileX, (H + kTileY - 1) / kTileY);
  const int launches = (iterations + kSteps - 1) / kSteps;
  for (int l = 0; l < launches; ++l) {
    float* const* dst = copies[(launches - 1 - l) % 2];
    float* const* src = copies[(launches - l) % 2];
    const State st{src[0], src[1], src[2], dst[0], dst[1], dst[2]};
    const int steps = iterations - l * kSteps < kSteps ? iterations - l * kSteps : kSteps;
    kernel<<<grid, kThreads, 0, s>>>(gg, static_cast<const float*>(lam_weight), st, H, W, lam,
                                     sigma, tau, alpha, steps, l == 0, l < launches - 1);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

// The design it replaced, the same arguments but for p: 2 planes of scratch.
extern "C" int kt_rof_denoise_steps(const void* g, const void* lam_weight, void* u, void* p,
                                    int H, int W, float lam, float sigma, float tau, float alpha,
                                    int huber, int iterations, void* stream) {
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
