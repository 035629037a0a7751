// Median filter that rejects invalid (non-finite) taps.
//
// Replaces kangaroo_tpu/ops/median_pallas.py:_median_kernel (called through
// median_filter there, reject mode). Per pixel, over the (2r+1)^2 window
// with edge-replicated borders: non-finite taps become +inf and are
// counted as bad; the output is sorted element min((k + bad) / 2, k - 1),
// or NaN when bad >= max_bad or bad >= k. That index is never below k / 2,
// so only the top (k + 1) / 2 positions of the sorted window matter.
//
// What bounds it on the H100: instruction issue. A 5x5 window is 25 reads
// against a sorting network of min/max pairs, and min, max, compares and
// selects all issue on the ALU pipe (64 lanes a clock an SM, half the FMA
// rate); an image is a few hundred thousand pixels.
//
// Design (median_tile_kernel): a block takes a tile of (32 kPix) x kRows
// pixels of one image of a stack (blockIdx.z) and
//   1. stages the tile and a halo of r into shared memory with coalesced,
//      clamped loads, each tap converted once (+inf where not finite);
//   2. sorts each column of 2r+1 staged taps once (batcher_sort) and counts
//      its bad taps: a column serves the 2r+1 pixels beside it;
//   3. gives each thread kPix pixels side by side. A thread loads the
//      kPix + 2r sorted columns its pixels cover and runs median_top<r,
//      kPix>, generated by kangaroo_tpu_torch/ops/median_cuda.py
//      (median_network.cuh in the build directory): odd-even merges of the
//      columns, the ones its pixels share merged once, cut to the top
//      positions. A pixel's bad count is the sum of its columns' counts;
//      a select tree over the top positions picks the output.
// At r = 2 and kPix = 2 that is 18 + 101.5 min/max a pixel against the
// replaced design's 280 (median_cuda.network_counts). On the H100 (700 W,
// 640x480, r = 2) 2 pixels a thread and 64x4 tiles measured fastest among
// 1, 2 and 4 pixels and 4, 8 and 16 rows (chip_smoke.py phase 4, PERF.md
// section 6, PR 12). Sorting is exact, so
// the value is the replaced design's; only the sign of a zero may come
// from another tap (the checks take +0 and -0 as equal).
//
// The replaced design (median_reject_kernel, kt_median_reject_invalid_pixel)
// stays for the card checks: one thread per pixel, the whole window through
// Batcher's network and a select chain over every position.
#include <cuda_runtime.h>
#include <math_constants.h>

#include "median_network.cuh"

namespace {

// --- the tile design ---------------------------------------------------------

constexpr int kPix = 2;   // pixels a thread, side by side along x (1, 2 or 4)
constexpr int kRows = 4;  // rows a block; a block is 32 x kRows threads
constexpr int kTileW = 32 * kPix;

template <int R>
struct Tile {
  static constexpr int S = 2 * R + 1;
  static constexpr int kInW = kTileW + 2 * R;  // staged columns
  // sorted-column rows: room for the last thread's widest loads, 16-byte rows
  static constexpr int kPitch = (kInW + kPix - 1 + 3) / 4 * 4;
  float col[S][kRows][kPitch];  // column (y, x) sorted, ascending along its first index
  int bad[kRows][kPitch];       // bad taps of column (y, x)
  float tap[kRows + 2 * R][kInW];
};

// N consecutive values from shared memory at a multiple of N
template <int N>
__device__ __forceinline__ void load_vec(const float* p, float* out) {
  if constexpr (N == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;
  } else if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x, out[1] = v.y;
  } else {
    out[0] = *p;
  }
}

template <int N>
__device__ __forceinline__ void load_vec(const int* p, int* out) {
  if constexpr (N == 4) {
    const int4 v = *reinterpret_cast<const int4*>(p);
    out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;
  } else if constexpr (N == 2) {
    const int2 v = *reinterpret_cast<const int2*>(p);
    out[0] = v.x, out[1] = v.y;
  } else {
    out[0] = *p;
  }
}

template <int R>
__global__ void __launch_bounds__(32 * kRows)
    median_tile_kernel(const float* __restrict__ img, float* __restrict__ out, int H, int W,
                       int max_bad) {
  constexpr int S = 2 * R + 1;
  constexpr int K = S * S;
  constexpr int T = K - K / 2;        // the positions the output can take
  constexpr int kCols = kPix + 2 * R;  // the columns a thread's pixels cover
  constexpr int kLoads = (kCols + kPix - 1) / kPix;
  constexpr int kThreads = 32 * kRows;
  using Sh = Tile<R>;
  __shared__ __align__(16) Sh sh;

  const size_t plane = static_cast<size_t>(H) * W;
  img += blockIdx.z * plane;
  out += blockIdx.z * plane;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kRows;
  const int tid = threadIdx.y * 32 + threadIdx.x;

  // 1. the tile and its halo, clamped at the image's edges
  for (int i = tid; i < (kRows + 2 * R) * Sh::kInW; i += kThreads) {
    const int ly = i / Sh::kInW, lx = i - ly * Sh::kInW;
    const int gy = min(max(y0 - R + ly, 0), H - 1);
    const int gx = min(max(x0 - R + lx, 0), W - 1);
    const float t = img[static_cast<size_t>(gy) * W + gx];
    sh.tap[ly][lx] = isfinite(t) ? t : CUDART_INF_F;
  }
  __syncthreads();

  // 2. each column of S taps sorted once, its bad taps counted
  for (int i = tid; i < kRows * Sh::kInW; i += kThreads) {
    const int ly = i / Sh::kInW, lx = i - ly * Sh::kInW;
    float v[S];
    int n = 0;
#pragma unroll
    for (int k = 0; k < S; ++k) {
      v[k] = sh.tap[ly + k][lx];
      n += v[k] == CUDART_INF_F;
    }
    batcher_sort<S>(v);
#pragma unroll
    for (int k = 0; k < S; ++k) sh.col[k][ly][lx] = v[k];
    sh.bad[ly][lx] = n;
  }
  __syncthreads();

  // 3. kPix pixels a thread from the kCols sorted columns they cover
  const int ly = threadIdx.y, lx = threadIdx.x * kPix;
  float c[kCols * S];
  int nb[kLoads * kPix];
#pragma unroll
  for (int k = 0; k < S; ++k) {
    float row[kLoads * kPix];
#pragma unroll
    for (int j = 0; j < kLoads; ++j) load_vec<kPix>(&sh.col[k][ly][lx + j * kPix], row + j * kPix);
#pragma unroll
    for (int j = 0; j < kCols; ++j) c[j * S + k] = row[j];
  }
#pragma unroll
  for (int j = 0; j < kLoads; ++j) load_vec<kPix>(&sh.bad[ly][lx + j * kPix], nb + j * kPix);

  float top[kPix * T];
  median_top<R, kPix>(c, top);

  const int gy = y0 + ly;
  int bad = 0;
#pragma unroll
  for (int j = 0; j < S; ++j) bad += nb[j];
#pragma unroll
  for (int p = 0; p < kPix; ++p) {
    if (p > 0) bad += nb[p + 2 * R] - nb[p - 1];
    // a select tree over positions K/2..K-1: v[0] ends as v[idx - K/2]
    float* v = top + p * T;
    const int j = min((K + bad) / 2, K - 1) - K / 2;
#pragma unroll
    for (int s = 1; s < T; s *= 2) {
      const bool hi = j & s;
#pragma unroll
      for (int i = 0; i + s < T; i += 2 * s) v[i] = hi ? v[i + s] : v[i];
    }
    const int gx = x0 + lx + p;
    if (gx < W && gy < H)
      out[static_cast<size_t>(gy) * W + gx] = (bad < max_bad && bad < K) ? v[0] : CUDART_NAN_F;
  }
}

// --- the replaced design: one thread per pixel --------------------------------

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

// N images of H x W, each filtered alone
extern "C" int kt_median_reject_invalid(const void* img, void* out, int N, int H, int W, int rad,
                                        int max_bad, void* stream) {
  if (N < 1 || N > 65535 || H < 1 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(32, kRows);
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kRows - 1) / kRows, N);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* in = static_cast<const float*>(img);
  float* o = static_cast<float*>(out);
  switch (rad) {
    case 1: median_tile_kernel<1><<<grid, block, 0, s>>>(in, o, H, W, max_bad); break;
    case 2: median_tile_kernel<2><<<grid, block, 0, s>>>(in, o, H, W, max_bad); break;
    case 3: median_tile_kernel<3><<<grid, block, 0, s>>>(in, o, H, W, max_bad); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int kt_median_reject_invalid_pixel(const void* img, void* out, int H, int W, int rad,
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
