// The census transform and its Hamming cost volume (stereo/census.py:
// census, census_cost_volume) on the card.
//
// No Pallas kernel is replaced: the JAX package computes both as XLA
// (kangaroo_tpu/stereo/census.py). They were written because the plain
// PyTorch versions, one pass a window offset (128 at 16x16: two gathers, a
// compare, a shift and an OR each) and one a disparity (a roll, an XOR and
// a SWAR popcount over int64 words), took 250 of the 274 ms of device time
// of a batch of 8 KITTI pairs at 128 disparities, in 28,000 launches.
//
// Words: the plain version's layout, (..., H, W, K) int64, each holding 32
// bits: bit i of word k is comparison 32 k + i, the window's offsets taken
// row by row (rows outer, columns inner); a bit is set where the neighbour,
// its row and column each clamped to the frame's own borders, is less than
// the centre (false where either is NaN, as torch's <). uint8 and float32
// images are compared as float32, which is exact for both. The volume
// kernel reads the low 32 bits of each word.
//
// vol[d, y, x] = popcount(L[y, x] xor R[y, x + sd d]) * inv_bits, the
// product in float32 (__fmul_rn: inv_bits is the plain version's scalar in
// float32) and then rounded to the volume's type (round to nearest even,
// as torch's cast), 0.5 where x + sd d lies outside the row: the plain
// version's bits.
//
// What bounds them on the H100: bytes. kt_census reads the image once and
// writes 8 K bytes a pixel (the int64 words; 4 K would do for their bits);
// its 63-128 compares a pixel read shared memory. kt_census_volume writes
// the (D, H, W) volume once (2 bytes a cell in bfloat16: 954 MB for a batch
// of 8 KITTI pairs at 128 disparities) and reads the census images about
// once; K xors, K popcounts, a conversion and a product a cell come next.
//
// Design. kt_census: a block takes a 32x8 tile of one frame (blockIdx.z),
// stages the tile and its window's halo, clamped at the frame's borders, in
// shared memory as float, and each thread forms one pixel's K words, its
// loop over the window's offsets unrolled; a warp is one row of the tile,
// so each shared read is 32 consecutive floats. kt_census_volume: a block
// takes 128 columns of one row and kDChunk disparities, stages the right
// image's words over the 128 + kDChunk - 1 columns those read in shared
// memory (one plane a word, padded so that the staging stores spread over
// the banks), keeps its pixel's left words in registers, and writes each
// disparity's cell: consecutive columns on consecutive threads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kTileX = 32;
constexpr int kTileY = 8;
constexpr int kVolThreads = 128;
constexpr int kDChunk = 32;
constexpr int kMaxGrid = 65535;

// rows R0..R1 and columns C0..C1 of a window, both inclusive
template <int R0, int R1, int C0, int C1>
struct Window {
  static constexpr int kRows = R1 - R0 + 1;
  static constexpr int kCols = C1 - C0 + 1;
  static constexpr int kWords = (kRows * kCols + 31) / 32;
};

template <typename T, int R0, int R1, int C0, int C1>
__global__ void __launch_bounds__(kTileX* kTileY)
    census_kernel(const T* __restrict__ img, long long* __restrict__ out, int B, int H, int W) {
  using Win = Window<R0, R1, C0, C1>;
  constexpr int kSH = kTileY + Win::kRows - 1;
  constexpr int kSW = kTileX + Win::kCols - 1;
  static_assert(Win::kWords % 2 == 0, "the words are stored two at a time");
  __shared__ float tile[kSH][kSW];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTileX + tx;
  const int x0 = blockIdx.x * kTileX;
  const int x = x0 + tx;
  for (int b = blockIdx.z; b < B; b += gridDim.z) {
    const T* frame = img + static_cast<long long>(b) * H * W;
    for (int y0 = blockIdx.y * kTileY; y0 < H; y0 += gridDim.y * kTileY) {
      __syncthreads();  // the previous tile is read
      for (int i = tid; i < kSH * kSW; i += kTileX * kTileY) {
        const int r = i / kSW, c = i - r * kSW;
        const int sy = min(max(y0 + R0 + r, 0), H - 1);
        const int sx = min(max(x0 + C0 + c, 0), W - 1);
        tile[r][c] = static_cast<float>(frame[static_cast<long long>(sy) * W + sx]);
      }
      __syncthreads();
      const int y = y0 + ty;
      if (x >= W || y >= H) continue;
      const float centre = tile[ty - R0][tx - C0];
      unsigned words[Win::kWords];
#pragma unroll
      for (int k = 0; k < Win::kWords; ++k) words[k] = 0u;
#pragma unroll
      for (int r = 0; r < Win::kRows; ++r) {
#pragma unroll
        for (int c = 0; c < Win::kCols; ++c) {
          const int k = r * Win::kCols + c;
          words[k / 32] |= static_cast<unsigned>(tile[ty + r][tx + c] < centre) << (k % 32);
        }
      }
      auto* o = reinterpret_cast<longlong2*>(
          out + ((static_cast<long long>(b) * H + y) * W + x) * Win::kWords);
#pragma unroll
      for (int k = 0; k < Win::kWords; k += 2)
        o[k / 2] = make_longlong2(static_cast<long long>(words[k]),
                                  static_cast<long long>(words[k + 1]));
    }
  }
}

template <typename T, int R0, int R1, int C0, int C1>
void launch_census(const void* img, void* out, int B, int H, int W, cudaStream_t st) {
  const dim3 block(kTileX, kTileY);
  const dim3 grid((W + kTileX - 1) / kTileX, std::min((H + kTileY - 1) / kTileY, kMaxGrid),
                  std::min(B, kMaxGrid));
  census_kernel<T, R0, R1, C0, C1><<<grid, block, 0, st>>>(static_cast<const T*>(img),
                                                           static_cast<long long*>(out), B, H, W);
}

template <typename T>
int census_window(int window, const void* img, void* out, int B, int H, int W,
                  cudaStream_t st) {
  switch (window) {
    case 0:  // 9x7: rows -3..3, columns -4..4
      launch_census<T, -3, 3, -4, 4>(img, out, B, H, W, st);
      return 0;
    case 1:  // 11x11: rows -5..5, columns -5..5
      launch_census<T, -5, 5, -5, 5>(img, out, B, H, W, st);
      return 0;
    case 2:  // 16x16: rows -8..7, columns -4..3 (128 comparisons)
      launch_census<T, -8, 7, -4, 3>(img, out, B, H, W, st);
      return 0;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename OutT, int K>
__global__ void __launch_bounds__(kVolThreads)
    census_volume_kernel(const long long* __restrict__ left, const long long* __restrict__ right,
                         OutT* __restrict__ vol, int D, int rows, int W, int sd,
                         float inv_bits) {
  constexpr int kSpan = kVolThreads + kDChunk - 1;
  // a word plane's stride in shared memory: the span padded to 32 n + 32 / K,
  // so that a warp's staging stores (consecutive words of consecutive
  // columns) fall in distinct banks
  constexpr int kStride = (kSpan + 31) / 32 * 32 + 32 / K;
  __shared__ unsigned rs[K * kStride];
  const int tx = threadIdx.x;
  const int x0 = blockIdx.x * kVolThreads;
  const int x = x0 + tx;
  const int d0 = blockIdx.z * kDChunk;
  const int nd = min(kDChunk, D - d0);
  // the first column the block reads: x + sd d over its columns and depths
  const int c0 = sd < 0 ? x0 - d0 - (kDChunk - 1) : x0 + d0;
  const long long plane = static_cast<long long>(rows) * W;
  for (int y = blockIdx.y; y < rows; y += gridDim.y) {
    const long long* rrow = right + static_cast<long long>(y) * W * K;
    __syncthreads();  // the previous row's words are read
    for (int i = tx; i < kSpan * K; i += kVolThreads) {
      const int j = i / K, k = i - j * K;
      const int c = c0 + j;
      rs[k * kStride + j] =
          (c >= 0 && c < W) ? static_cast<unsigned>(rrow[static_cast<long long>(c) * K + k]) : 0u;
    }
    __syncthreads();
    if (x >= W) continue;
    unsigned l[K];
    const long long* lp = left + (static_cast<long long>(y) * W + x) * K;
#pragma unroll
    for (int k = 0; k < K; ++k) l[k] = static_cast<unsigned>(lp[k]);
    OutT* o = vol + static_cast<long long>(d0) * plane + static_cast<long long>(y) * W + x;
    for (int t = 0; t < nd; ++t) {
      const int c = x + sd * (d0 + t);
      float v = 0.5f;
      if (c >= 0 && c < W) {
        const int j = c - c0;
        int n = 0;
#pragma unroll
        for (int k = 0; k < K; ++k) n += __popc(l[k] ^ rs[k * kStride + j]);
        v = __fmul_rn(static_cast<float>(n), inv_bits);
      }
      store(o + t * plane, v);
    }
  }
}

template <typename OutT, int K>
void launch_volume(const void* left, const void* right, void* vol, int D, int rows, int W,
                   int sd, float inv_bits, cudaStream_t st) {
  const dim3 grid((W + kVolThreads - 1) / kVolThreads, std::min(rows, kMaxGrid),
                  (D + kDChunk - 1) / kDChunk);
  census_volume_kernel<OutT, K><<<grid, kVolThreads, 0, st>>>(
      static_cast<const long long*>(left), static_cast<const long long*>(right),
      static_cast<OutT*>(vol), D, rows, W, sd, inv_bits);
}

template <typename OutT>
int volume_words(int K, const void* left, const void* right, void* vol, int D, int rows, int W,
                 int sd, float inv_bits, cudaStream_t st) {
  switch (K) {
    case 1:
      launch_volume<OutT, 1>(left, right, vol, D, rows, W, sd, inv_bits, st);
      return 0;
    case 2:
      launch_volume<OutT, 2>(left, right, vol, D, rows, W, sd, inv_bits, st);
      return 0;
    case 3:
      launch_volume<OutT, 3>(left, right, vol, D, rows, W, sd, inv_bits, st);
      return 0;
    case 4:
      launch_volume<OutT, 4>(left, right, vol, D, rows, W, sd, inv_bits, st);
      return 0;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// img (B, H, W) uint8 (img_is_u8) or float32; out (B, H, W, K) int64 with
// the window's K; window 0: 9x7, 1: 11x11, 2: 16x16
extern "C" int kt_census(const void* img, int img_is_u8, void* out, int B, int H, int W,
                         int window, void* stream) {
  if (B < 1 || H < 1 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rc = img_is_u8 ? census_window<unsigned char>(window, img, out, B, H, W, st)
                           : census_window<float>(window, img, out, B, H, W, st);
  return rc ? rc : static_cast<int>(cudaGetLastError());
}

// left, right (rows, W, K) int64 census words; vol (D, rows, W) bfloat16
// (vol_is_bf16) or float32; sd -1 or +1; K 1..4
extern "C" int kt_census_volume(const void* left, const void* right, void* vol, int vol_is_bf16,
                                int D, int rows, int W, int K, int sd, float inv_bits,
                                void* stream) {
  if (D < 1 || rows < 1 || W < 1 || (sd != -1 && sd != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(D + kDChunk - 1) / kDChunk > kMaxGrid)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rc =
      vol_is_bf16
          ? volume_words<__nv_bfloat16>(K, left, right, vol, D, rows, W, sd, inv_bits, st)
          : volume_words<float>(K, left, right, vol, D, rows, W, sd, inv_bits, st);
  return rc ? rc : static_cast<int>(cudaGetLastError());
}
