// Semi-global matching: one path direction per launch, straight or diagonal.
//
// Replaces kangaroo_tpu/stereo/sgm_pallas.py:_make_kernel (the straight
// paths, driven by _aggregate_direction) and _make_multi_diag_kernel (the
// 8-path mode's vertical pair and four diagonals, driven by
// _multi_diag_direction). A direction is a step (sx, sy), each in
// {-1, 0, +1}: pixel (x, y) continues the path from (x - sx, y - sy). Per
// path step:
//   CM(d) = min(prev(d), min(prev(d-1), prev(d+1)) + P1, lastBest + P2')
//   Lr(d) = CM(d) + C(d) - lastBest,   P2' = P2 / (1 + |I(p) - I(p-r)|)
// with entries off the disparity lattice (d <= x for sd = -1, x + d < W for
// sd = +1, x the pixel's own column) held at 1e30 in the carry and written
// as 0. A pixel whose predecessor is off the image starts a path: it writes
// C and leaves lastBest at 0.
//
// What bounds it on the H100: the recurrence is sequential along a path,
// so the time is the length of the dependent chain (up to H or W steps),
// not bytes: each direction streams the volume in (bf16 or f32) and the
// f32 aggregate in and out once, far less than HBM moves in that time.
//
// Design: one warp owns one whole path line and loops along it, so nothing
// carries between blocks, which run in no order. A direction's lines start
// on its entry row (y = 0 going down, H - 1 going up; W lines) and, for a
// diagonal, also on its entry column (H - 1 more lines); the first pixel of
// a line is exactly the pixel whose predecessor is off the image, so every
// re-seed of the TPU kernel is this kernel's first step. Diagonal lines
// differ in length; neighbouring warps hold neighbouring lines of similar
// length. Each lane holds DPT consecutive disparities of the carry in
// registers; the d-1 / d+1 neighbours across lanes come from warp shuffles
// and lastBest from a five-step xor-shuffle min, so a step needs no shared
// memory and no block barrier. The next step's costs are loaded before the
// current step's arithmetic to hide their latency. The volume is read in
// its (D,H,W) layout for every direction; the TPU's transposes and its
// several-directions-per-pass are layout and HBM-traffic work this design
// does not copy. Directions chain through one f32 output: the first launch
// writes, later launches add, in the plain version's sum order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kBig = 1e30f;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kWarpsPerBlock = 4;

__device__ __forceinline__ float load_cost(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float load_cost(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}

// Number of path lines of direction (sx, sy) over an H x W image.
__host__ __device__ __forceinline__ int n_lines(int H, int W, int sx, int sy) {
  return sy == 0 ? H : (sx == 0 ? W : W + H - 1);
}

template <typename T, int DPT>
__global__ void sgm_path_kernel(const T* __restrict__ vol, const float* __restrict__ img,
                                float* __restrict__ out, int D, int H, int W, int sx, int sy,
                                int sd, float P1, float P2, bool accumulate) {
  const int line = blockIdx.x * blockDim.y + threadIdx.y;
  if (line >= n_lines(H, W, sx, sy)) return;  // uniform across the warp
  const int lane = threadIdx.x;
  // the line's first pixel (x0, y0): on the entry row, or on the entry column
  const int entry_x = sx > 0 ? 0 : W - 1;
  const int entry_y = sy > 0 ? 0 : H - 1;
  int x0, y0;
  if (sy == 0) {
    x0 = entry_x;
    y0 = line;
  } else if (line < W) {
    x0 = line;
    y0 = entry_y;
  } else {  // a diagonal line entering through the entry column below/above the corner
    x0 = entry_x;
    y0 = entry_y + sy * (line - W + 1);
  }
  const int len_x = sx > 0 ? W - x0 : (sx < 0 ? x0 + 1 : W);
  const int len_y = sy > 0 ? H - y0 : (sy < 0 ? y0 + 1 : H);
  const int L = sx == 0 ? len_y : (sy == 0 ? len_x : min(len_x, len_y));
  const size_t HW = static_cast<size_t>(H) * W;
  const long long step = static_cast<long long>(sy) * W + sx;  // offset of one path step
  const size_t off0 = static_cast<size_t>(y0) * W + x0;
  const int d0 = lane * DPT;

  float prev[DPT];
  float cost[DPT];
  float next_cost[DPT];
  float best = 0.f;

  auto load_step = [&](int t, float* dst) {
    const size_t off = off0 + t * step;
#pragma unroll
    for (int k = 0; k < DPT; ++k) {
      const int d = d0 + k;
      dst[k] = d < D ? load_cost(vol, static_cast<size_t>(d) * HW + off) : kBig;
    }
  };

  load_step(0, next_cost);
  for (int t = 0; t < L; ++t) {
#pragma unroll
    for (int k = 0; k < DPT; ++k) cost[k] = next_cost[k];
    if (t + 1 < L) load_step(t + 1, next_cost);

    const int x = x0 + t * sx;
    const size_t off = off0 + t * step;

    if (t == 0) {
#pragma unroll
      for (int k = 0; k < DPT; ++k) {
        const int d = d0 + k;
        const bool valid = d < D && (sd < 0 ? d <= x : x + d < W);
        prev[k] = valid ? cost[k] : kBig;
        if (d < D) {
          float* o = out + static_cast<size_t>(d) * HW + off;
          const float v = valid ? cost[k] : 0.f;
          *o = accumulate ? *o + v : v;
        }
      }
      best = 0.f;  // a path's first pixel does not update lastBest
      continue;
    }

    const float p2 = P2 / (1.0f + fabsf(img[off - step] - img[off]));
    const float best_p2 = best + p2;
    // carry of d0 - 1 (from the lane below) and d0 + DPT (from the lane above)
    const float below = __shfl_up_sync(kFullMask, prev[DPT - 1], 1);
    const float above = __shfl_down_sync(kFullMask, prev[0], 1);

    float cr[DPT];
    float local_min = kBig;
#pragma unroll
    for (int k = 0; k < DPT; ++k) {
      const int d = d0 + k;
      const float down = d == 0 ? kBig : (k == 0 ? below : prev[k - 1]);
      const float up = d >= D - 1 ? kBig : (k == DPT - 1 ? above : prev[k + 1]);
      const float cm = fminf(fminf(prev[k], fminf(down, up) + P1), best_p2);
      const bool valid = d < D && (sd < 0 ? d <= x : x + d < W);
      const float v = valid ? cm + cost[k] - best : kBig;
      cr[k] = v;
      local_min = fminf(local_min, v);
      if (d < D) {
        float* o = out + static_cast<size_t>(d) * HW + off;
        const float w = valid ? v : 0.f;
        *o = accumulate ? *o + w : w;
      }
    }
#pragma unroll
    for (int k = 0; k < DPT; ++k) prev[k] = cr[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) local_min = fminf(local_min, __shfl_xor_sync(kFullMask, local_min, o));
    best = local_min;
  }
}

template <typename T>
cudaError_t launch_typed(const void* vol, const float* img, float* out, int D, int H, int W,
                         int sx, int sy, int sd, float P1, float P2, bool accumulate,
                         cudaStream_t stream) {
  const dim3 block(32, kWarpsPerBlock);
  const dim3 grid((n_lines(H, W, sx, sy) + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const T* v = static_cast<const T*>(vol);
#define KT_SGM_LAUNCH(DPT)                                                                   \
  sgm_path_kernel<T, DPT><<<grid, block, 0, stream>>>(v, img, out, D, H, W, sx, sy, sd, P1, \
                                                      P2, accumulate)
  if (D <= 32) KT_SGM_LAUNCH(1);
  else if (D <= 64) KT_SGM_LAUNCH(2);
  else if (D <= 128) KT_SGM_LAUNCH(4);
  else KT_SGM_LAUNCH(8);
#undef KT_SGM_LAUNCH
  return cudaGetLastError();
}

}  // namespace

extern "C" int kt_sgm_path(const void* vol, int vol_is_bf16, const void* img, void* out, int D,
                           int H, int W, int sx, int sy, int sd, float P1, float P2,
                           int accumulate, void* stream) {
  if (D < 1 || D > 256 || H < 1 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (sx < -1 || sx > 1 || sy < -1 || sy > 1 || (sx == 0 && sy == 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* im = static_cast<const float*>(img);
  float* o = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      vol_is_bf16 ? launch_typed<__nv_bfloat16>(vol, im, o, D, H, W, sx, sy, sd, P1, P2,
                                                accumulate, s)
                  : launch_typed<float>(vol, im, o, D, H, W, sx, sy, sd, P1, P2, accumulate, s);
  return static_cast<int>(err);
}
