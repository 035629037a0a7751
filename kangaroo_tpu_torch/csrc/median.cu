// Median filter that rejects invalid (non-finite) taps.
//
// Replaces kangaroo_tpu/ops/median_pallas.py:_median_kernel (called through
// median_filter there, reject mode). Per pixel, over the (2r+1)^2 window
// with edge-replicated borders: non-finite taps become +inf and are
// counted as bad; the window goes through Batcher's odd-even mergesort
// network; the output is sorted element min((k + bad) / 2, k - 1), or NaN
// when bad >= max_bad or bad >= k.
//
// What bounds it on the H100: operations. A 5x5 window is 25 reads (mostly
// L1 hits, shared with the neighbouring pixels) against the network's
// ~140 compare-exchanges, so it is arithmetic-bound, and small: an image
// is a few hundred thousand pixels.
//
// Design: one thread per pixel with the window in registers. The network
// is a straight-line sequence of min/max pairs with constant indices,
// generated from the same pair list as the TPU kernel
// (kangaroo_tpu_torch/ops/median_cuda.py writes median_network.cuh into the
// build directory), so the array never leaves registers. Borders clamp the
// read index instead of reading a padded copy. The output element is picked
// with a select chain over constant indices, as the TPU kernel does.
#include <cuda_runtime.h>
#include <math_constants.h>

#include "median_network.cuh"

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

template <int R>
__global__ void median_reject_kernel(const float* __restrict__ img, float* __restrict__ out, int H,
                                     int W, int max_bad) {
  constexpr int S = 2 * R + 1;
  constexpr int K = S * S;
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= W || y >= H) return;

  float v[K];
  int bad = 0;
#pragma unroll
  for (int dy = 0; dy < S; ++dy) {
    const int yy = min(max(y + dy - R, 0), H - 1);
#pragma unroll
    for (int dx = 0; dx < S; ++dx) {
      const int xx = min(max(x + dx - R, 0), W - 1);
      const float t = img[static_cast<size_t>(yy) * W + xx];
      const bool is_bad = !isfinite(t);
      bad += is_bad;
      v[dy * S + dx] = is_bad ? CUDART_INF_F : t;
    }
  }
  batcher_sort<K>(v);
  const int idx = min((K + bad) / 2, K - 1);
  float med = 0.f;
#pragma unroll
  for (int i = 0; i < K; ++i) med = idx == i ? v[i] : med;
  out[static_cast<size_t>(y) * W + x] = (bad < max_bad && bad < K) ? med : CUDART_NAN_F;
}

}  // namespace

extern "C" int kt_median_reject_invalid(const void* img, void* out, int H, int W, int rad,
                                        int max_bad, void* stream) {
  if (H < 1 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((W + kBlockX - 1) / kBlockX, (H + kBlockY - 1) / kBlockY);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* in = static_cast<const float*>(img);
  float* o = static_cast<float*>(out);
  switch (rad) {
    case 1: median_reject_kernel<1><<<grid, block, 0, s>>>(in, o, H, W, max_bad); break;
    case 2: median_reject_kernel<2><<<grid, block, 0, s>>>(in, o, H, W, max_bad); break;
    case 3: median_reject_kernel<3><<<grid, block, 0, s>>>(in, o, H, W, max_bad); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
