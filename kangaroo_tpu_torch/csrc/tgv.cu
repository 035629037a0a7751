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
// What bounds it on the H100: not bytes (the state, 17 planes of 1.2 MB at
// 640x480 with both copies, fits in the 50 MB L2) and not the 72
// operations a pixel and iteration the bound counts, but instruction issue
// and the steps' dependence, as builds of csrc/rof.cu cut short showed for
// ROF: a cell and iteration runs seven IEEE divisions and two square roots,
// each a sequence of instructions, and each iteration reads its
// neighbours' results of the one before. One thread a pixel with a launch
// a half-step (the design it replaced, below) spends a launch gap and a
// grid drain on each of its 2 x iterations launches.
//
// Design (kt_tgv_denoise), csrc/rof.cu's tiles: the TPU kernel keeps the
// nine planes in VMEM and runs every iteration in one call. The ascent
// writes p, q, r at x from u and v at x, x+1 and y+1; the descent writes u
// and v at x from p and q at x, x-1 and y-1 and r at x. So an iteration
// reaches one pixel further each way, and kSteps iterations of a tile need
// the state of a halo kSteps wide around it and nothing else. A block owns
// a kTileX x kTileY tile: it loads the nine planes (and f) of the tile and
// its halo, runs min(kSteps, iterations left) iterations there with a
// barrier after each half, and writes the tile back, so a solve takes
// ceil(iterations / kSteps) launches. Each thread keeps the state and f of
// its cells in registers; shared memory only passes neighbours' values: u,
// v0, v1 to the ascent and p0, p1, q0, q1, q2 to the descent, eight planes
// (30 KB at 32x16 and kSteps 4), so that a half-step reads one set while it
// writes the other and two barriers an iteration suffice (five planes
// shared by both halves would need four). r is never read by a neighbour.
// Step m is right only at cells at least m from a side of the halo that
// has image beyond it (the cone): the ascent of step m runs on the cells
// at depth m and more, the descent on depth m + 1 and more, and the
// image's own edges follow the rules above by global coordinate (a cell
// beyond the image is never read). Neighbouring blocks read each other's
// halos in the same launch, so a launch reads one copy of the state and
// writes the other (ping-pong): the first launch reads f (u = f, the rest
// 0), the C entry alternates two copies and lets the last launch write u
// only. Every expression is the one the per-pixel kernels below evaluate,
// so the two designs agree bit for bit.
//
// kt_tgv_denoise_steps, the design it replaced (an ascent kernel and a
// descent kernel per iteration, one thread a pixel, in place: the ascent
// writes p, q, r at x from u and v at x, x+1, y+1 and their own old values;
// the descent writes u and v at x from p, q at x, x-1, y-1, r and their own
// old values), stays as the yardstick that the card checks hold the tiles
// against; no path launches it.
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
static_assert(8 * kCells * sizeof(float) <= 48 * 1024, "static shared memory");

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

// u and v0, v1, p0, p1, q0, q1, q2, r: the nine planes of a copy of the state
struct Copy {
  float* u;
  float* v0;
  float* v1;
  float* p0;
  float* p1;
  float* q0;
  float* q1;
  float* q2;
  float* r;
};

// the scalars of a solve, passed as one struct: with the five floats as
// separate arguments nvcc built the tile kernel with 47 registers in place
// of 54, and each 512-thread configuration ran 7-16 % slower on the H100
// (chip_smoke.py phase 4's builds; the same bits)
struct Params {
  float alpha0, alpha1, sigma, tau, delta;
};

__global__ void __launch_bounds__(kThreads)
    tgv_tile_kernel(const float* __restrict__ f, Copy src, Copy dst, int H, int W, Params k,
                    int steps, bool first, bool write_state) {
  // u, v0, v1 for the ascent; p0, p1, q0, q1, q2 for the descent
  __shared__ float su[kCells], sv0[kCells], sv1[kCells];
  __shared__ float sp0[kCells], sp1[kCells], sq0[kCells], sq1[kCells], sq2[kCells];
  const int ox = static_cast<int>(blockIdx.x) * kTileX - kSteps;
  const int oy = static_cast<int>(blockIdx.y) * kTileY - kSteps;
  // the sides of the halo with image beyond them
  const bool cut_l = ox > 0, cut_r = ox + kExtX < W, cut_t = oy > 0, cut_b = oy + kExtY < H;
  float u[kPerThread], v0[kPerThread], v1[kPerThread], p0[kPerThread], p1[kPerThread];
  float q0[kPerThread], q1[kPerThread], q2[kPerThread], r[kPerThread], fc[kPerThread];
  unsigned flags[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int c = static_cast<int>(threadIdx.x) + j * kThreads;
    const int ex = c % kExtX, ey = c / kExtX;
    const int x = ox + ex, y = oy + ey;
    flags[j] = 0;
    u[j] = v0[j] = v1[j] = p0[j] = p1[j] = q0[j] = q1[j] = q2[j] = r[j] = fc[j] = 0.f;
    if (c >= kCells || x < 0 || x >= W || y < 0 || y >= H) continue;
    int depth = kMaxDepth;
    if (cut_l) depth = min(depth, ex);
    if (cut_r) depth = min(depth, kExtX - 1 - ex);
    if (cut_t) depth = min(depth, ey);
    if (cut_b) depth = min(depth, kExtY - 1 - ey);
    flags[j] = kInside | (x < W - 1 && ex < kExtX - 1 ? kRight : 0u) |
               (y < H - 1 && ey < kExtY - 1 ? kDown : 0u) | (x > 0 && ex > 0 ? kLeft : 0u) |
               (y > 0 && ey > 0 ? kUp : 0u) |
               (ex >= kSteps && ex < kSteps + kTileX && ey >= kSteps && ey < kSteps + kTileY
                    ? kInterior
                    : 0u) |
               (static_cast<unsigned>(depth) << kDepthShift);
    const size_t i = static_cast<size_t>(y) * W + x;
    fc[j] = f[i];
    if (first) {
      u[j] = fc[j];
    } else {
      u[j] = src.u[i];
      v0[j] = src.v0[i];
      v1[j] = src.v1[i];
      p0[j] = src.p0[i];
      p1[j] = src.p1[i];
      q0[j] = src.q0[i];
      q1[j] = src.q1[i];
      q2[j] = src.q2[i];
      r[j] = src.r[i];
    }
    su[c] = u[j];
    sv0[c] = v0[j];
    sv1[c] = v1[j];
  }
  __syncthreads();
  const float sa1 = fmul(k.sigma, k.alpha1), sa0 = fmul(k.sigma, k.alpha0);
  const float rden = 1.f + fmul(k.sigma, k.delta);
  for (int m = 0; m < steps; ++m) {
    // ascent on the cells at depth m and more
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const unsigned fl = flags[j];
      if (!(fl & kInside) || static_cast<int>(fl >> kDepthShift) < m) continue;
      const int c = static_cast<int>(threadIdx.x) + j * kThreads;
      const bool has_x = fl & kRight, has_y = fl & kDown;
      const float uc = u[j], v0c = v0[j], v1c = v1[j];
      // AscentP
      const float n0 = p0[j] + fmul(sa1, (has_x ? su[c + 1] - uc : 0.f) - v0c);
      const float n1 = p1[j] + fmul(sa1, (has_y ? su[c + kExtX] - uc : 0.f) - v1c);
      const float den = max1(sqrtf(fmul(n0, n0) + fmul(n1, n1)));
      p0[j] = n0 / den;
      p1[j] = n1 / den;
      // AscentQ
      const float e0 = has_x ? sv0[c + 1] - v0c : 0.f;
      const float e1 = has_y ? sv1[c + kExtX] - v1c : 0.f;
      const float e2 =
          ((has_y ? sv0[c + kExtX] - v0c : 0.f) + (has_x ? sv1[c + 1] - v1c : 0.f)) / 2.f;
      const float m0 = q0[j] + fmul(sa0, e0);
      const float m1 = q1[j] + fmul(sa0, e1);
      const float m2 = q2[j] + fmul(sa0, e2);
      const float qden = max1(sqrtf(fmul(m0, m0) + fmul(m1, m1) + fmul(fmul(2.f, m2), m2)));
      q0[j] = m0 / qden;
      q1[j] = m1 / qden;
      q2[j] = m2 / qden;
      // AscentR
      const float rn = (r[j] + fmul(k.sigma, uc - fc[j])) / rden;
      r[j] = rn / max1(fabsf(rn));
      sp0[c] = p0[j];
      sp1[c] = p1[j];
      sq0[c] = q0[j];
      sq1[c] = q1[j];
      sq2[c] = q2[j];
    }
    __syncthreads();
    // descent on the cells at depth m + 1 and more
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const unsigned fl = flags[j];
      if (!(fl & kInside) || static_cast<int>(fl >> kDepthShift) <= m) continue;
      const int c = static_cast<int>(threadIdx.x) + j * kThreads;
      const bool has_l = fl & kLeft, has_u = fl & kUp;
      // DescentU: px + py - px(x-1) - py(y-1), the out-of-image terms dropped
      const float divp = p0[j] + p1[j] - (has_l ? sp0[c - 1] : 0.f) -
                         (has_u ? sp1[c - kExtX] : 0.f);
      u[j] = u[j] - fmul(k.tau, r[j] - fmul(k.alpha1, divp));
      // DescentV
      const float d0 = q0[j] + q2[j] - (has_l ? sq0[c - 1] : 0.f) -
                       (has_u ? sq2[c - kExtX] : 0.f);
      const float d1 = q2[j] + q1[j] - (has_l ? sq2[c - 1] : 0.f) -
                       (has_u ? sq1[c - kExtX] : 0.f);
      v0[j] = v0[j] - fmul(k.tau, fmul(-k.alpha1, p0[j]) - fmul(k.alpha0, d0));
      v1[j] = v1[j] - fmul(k.tau, fmul(-k.alpha1, p1[j]) - fmul(k.alpha0, d1));
      su[c] = u[j];
      sv0[c] = v0[j];
      sv1[c] = v1[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    if (!(flags[j] & kInterior) || !(flags[j] & kInside)) continue;
    const int c = static_cast<int>(threadIdx.x) + j * kThreads;
    const size_t i = static_cast<size_t>(oy + c / kExtX) * W + (ox + c % kExtX);
    dst.u[i] = u[j];
    if (write_state) {
      dst.v0[i] = v0[j];
      dst.v1[i] = v1[j];
      dst.p0[i] = p0[j];
      dst.p1[i] = p1[j];
      dst.q0[i] = q0[j];
      dst.q1[i] = q1[j];
      dst.q2[i] = q2[j];
      dst.r[i] = r[j];
    }
  }
}

// --- the design it replaced: two launches an iteration, in place ----------

__global__ void tgv_ascent_kernel(const float* __restrict__ u, const float* __restrict__ f,
                                  Copy s, int H, int W, float alpha0, float alpha1,
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

__global__ void tgv_descent_kernel(float* __restrict__ u, Copy s, int H, int W, float alpha0,
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

// the copy of the state whose u is `u` and whose other eight planes start at `rest`
Copy copy_at(float* u, float* rest, size_t plane) {
  return Copy{u,
              rest,
              rest + plane,
              rest + 2 * plane,
              rest + 3 * plane,
              rest + 4 * plane,
              rest + 5 * plane,
              rest + 6 * plane,
              rest + 7 * plane};
}

}  // namespace

// f, u (out): (H, W) f32; state: 17 planes of scratch, the second copy of u
// and both copies of the other eight (v0, v1, p0, p1, q0, q1, q2, r).
// Launch l reads one copy and writes the other; the last launch writes u.
extern "C" int kt_tgv_denoise(const void* f, void* u, void* state, int H, int W, float alpha0,
                              float alpha1, float sigma, float tau, float delta, int iterations,
                              void* stream) {
  if (H < 1 || W < 1 || iterations < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t plane = static_cast<size_t>(H) * W;
  const float* ff = static_cast<const float*>(f);
  float* uu = static_cast<float*>(u);
  if (iterations == 0)
    return static_cast<int>(
        cudaMemcpyAsync(uu, ff, plane * sizeof(float), cudaMemcpyDeviceToDevice, st));
  float* sc = static_cast<float*>(state);
  const Copy copies[2] = {copy_at(uu, sc + plane, plane), copy_at(sc, sc + 9 * plane, plane)};
  const Params k{alpha0, alpha1, sigma, tau, delta};
  const dim3 grid((W + kTileX - 1) / kTileX, (H + kTileY - 1) / kTileY);
  const int launches = (iterations + kSteps - 1) / kSteps;
  for (int l = 0; l < launches; ++l) {
    const Copy& dst = copies[(launches - 1 - l) % 2];
    const Copy& src = copies[(launches - l) % 2];
    const int steps = iterations - l * kSteps < kSteps ? iterations - l * kSteps : kSteps;
    tgv_tile_kernel<<<grid, kThreads, 0, st>>>(ff, src, dst, H, W, k, steps, l == 0,
                                               l < launches - 1);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

// The design it replaced, the same arguments but for the state: 8 planes of
// scratch (v0, v1, p0, p1, q0, q1, q2, r), updated in place.
extern "C" int kt_tgv_denoise_steps(const void* f, void* u, void* state, int H, int W,
                                    float alpha0, float alpha1, float sigma, float tau,
                                    float delta, int iterations, void* stream) {
  if (H < 1 || W < 1 || iterations < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t plane = static_cast<size_t>(H) * W;
  float* uu = static_cast<float*>(u);
  float* base = static_cast<float*>(state);
  const float* ff = static_cast<const float*>(f);
  const Copy s = copy_at(uu, base, plane);
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
