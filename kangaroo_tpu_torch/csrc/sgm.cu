// Semi-global matching: one straight path direction per launch.
//
// Replaces kangaroo_tpu/stereo/sgm_pallas.py:_make_kernel (driven by
// _aggregate_direction and semi_global_matching there). Per path step:
//   CM(d) = min(prev(d), min(prev(d-1), prev(d+1)) + P1, lastBest + P2')
//   Lr(d) = CM(d) + C(d) - lastBest,   P2' = P2 / (1 + |I(p) - I(p-r)|)
// with entries off the disparity lattice (d <= x for sd = -1, x + d < W for
// sd = +1) held at 1e30 in the carry and written as 0. The first position
// of a path writes C and leaves lastBest at 0.
//
// What bounds it on the H100: the recurrence is sequential along the scan
// axis, so the time is the length of the dependent chain (H or W steps),
// not bytes: each direction streams the volume in (bf16 or f32) and the
// f32 aggregate in and out once, far less than HBM moves in that time.
//
// Design: one warp owns one whole line (a column for the vertical pair, a
// row for the horizontal pair) and loops over the scan axis itself, so
// nothing carries between blocks, which run in no order. Each lane holds
// DPT consecutive disparities of the carry in registers; the d-1 / d+1
// neighbours across lanes come from warp shuffles and lastBest from a
// five-step xor-shuffle min, so a step needs no shared memory and no block
// barrier. The next step's costs are loaded before the current step's
// arithmetic to hide their latency. The horizontal pair reads the (D,H,W)
// volume in place (the lattice mask follows the scan position); the TPU's
// transpose to (D,W,H) is layout work the GPU does not need. Directions
// chain through one f32 output: the first launch writes, later launches
// add, so the sum order is ((vf + vr) + hf) + hr.
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

template <typename T, int DPT>
__global__ void sgm_direction_kernel(const T* __restrict__ vol, const float* __restrict__ img,
                                     float* __restrict__ out, int D, int H, int W, bool vertical,
                                     bool reverse, int sd, float P1, float P2, bool accumulate) {
  const int line = blockIdx.x * blockDim.y + threadIdx.y;
  const int n_lines = vertical ? W : H;
  if (line >= n_lines) return;  // uniform across the warp
  const int lane = threadIdx.x;
  const int L = vertical ? H : W;  // scan length
  const size_t HW = static_cast<size_t>(H) * W;
  // element (d, s) of this line lives at d * HW + s * s_stride + line * l_stride
  const size_t s_stride = vertical ? W : 1;
  const size_t line_off = static_cast<size_t>(line) * (vertical ? 1 : W);
  const int d0 = lane * DPT;

  float prev[DPT];
  float cost[DPT];
  float next_cost[DPT];
  float best = 0.f;

  auto load_step = [&](int t, float* dst) {
    const int s = reverse ? L - 1 - t : t;
    const size_t off = line_off + static_cast<size_t>(s) * s_stride;
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

    const int s = reverse ? L - 1 - t : t;
    const int x = vertical ? line : s;
    const size_t off = line_off + static_cast<size_t>(s) * s_stride;

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
      best = 0.f;  // the seed row does not update lastBest
      continue;
    }

    const size_t pred = line_off + static_cast<size_t>(reverse ? s + 1 : s - 1) * s_stride;
    const float p2 = P2 / (1.0f + fabsf(img[pred] - img[off]));
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
                         bool vertical, bool reverse, int sd, float P1, float P2, bool accumulate,
                         cudaStream_t stream) {
  const int n_lines = vertical ? W : H;
  const dim3 block(32, kWarpsPerBlock);
  const dim3 grid((n_lines + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const T* v = static_cast<const T*>(vol);
#define KT_SGM_LAUNCH(DPT)                                                                    \
  sgm_direction_kernel<T, DPT><<<grid, block, 0, stream>>>(v, img, out, D, H, W, vertical, \
                                                           reverse, sd, P1, P2, accumulate)
  if (D <= 32) KT_SGM_LAUNCH(1);
  else if (D <= 64) KT_SGM_LAUNCH(2);
  else if (D <= 128) KT_SGM_LAUNCH(4);
  else KT_SGM_LAUNCH(8);
#undef KT_SGM_LAUNCH
  return cudaGetLastError();
}

}  // namespace

extern "C" int kt_sgm_direction(const void* vol, int vol_is_bf16, const void* img, void* out,
                                int D, int H, int W, int vertical, int reverse, int sd, float P1,
                                float P2, int accumulate, void* stream) {
  if (D < 1 || D > 256 || H < 1 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  const float* im = static_cast<const float*>(img);
  float* o = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      vol_is_bf16 ? launch_typed<__nv_bfloat16>(vol, im, o, D, H, W, vertical, reverse, sd, P1,
                                                P2, accumulate, s)
                  : launch_typed<float>(vol, im, o, D, H, W, vertical, reverse, sd, P1, P2,
                                        accumulate, s);
  return static_cast<int>(err);
}
