// Left-right consistency check of two float disparity images.
//
// Replaces kangaroo_tpu/stereo/lr_pallas.py:_lr_kernel (called through
// left_right_check there). Per pixel: xr = x + sd*dl; dl is kept iff xr is
// inside [0, W), the partner dr[y, trunc(min(xr, W-1))] is finite, and
// |dl - dr| <= max_diff; otherwise the output is NaN. The TPU kernel reads
// the partner through a sweep over the column offsets k = x - xi in
// [k_min, k_max] ([-1, max_disp) for sd = -1, [-max_disp, 2) for sd = +1),
// so a pixel whose offset lies outside the sweep reads NaN and is
// rejected; this kernel keeps that bound. The in-bounds test comes first:
// a NaN dl never reaches the float-to-int conversion.
//
// What bounds it on the H100: bytes, two f32 images read and one written a
// direction, with a few operations per pixel; at VGA a launch is a few
// microseconds, so its ramp and drain weigh as much as its bytes.
//
// Design (lr_rows_kernel): a block takes kRows rows (fewer where the rows
// would not fit in the default 48 KB of shared memory) and kThreads threads
// a row. It stages both rows of each in shared memory with loads as wide as
// the images' bases and row stride allow (16, 8 or 4 bytes: KITTI's W = 1242
// takes 8), then gathers each pixel's partner there. In pair mode (sd = 0)
// it runs both directions of the frame in the reference's order: the right
// row against the left first (sd = +1), written to the right output and
// over the staged right row; a barrier; then the left row against the
// checked right one (sd = -1). One launch a frame replaces two, and the
// right image is not read back. With sd = +1 or -1 it is the one-way check.
// A row must fit in shared memory: W <= 29056 (two rows of floats in 227
// KB); the entry refuses wider ones.
//
// The replaced design (lr_check_kernel, kt_lr_check_pixel) stays for the
// card checks: one thread per pixel of one direction, the partner read
// from global memory.
#include <cstdint>

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

// the check of one pixel: own[x] against the partner row
__device__ __forceinline__ float check(const float* own, const float* partner, int x, int W, int sd,
                                       float max_diff, int k_min, int k_max) {
  const float dl = own[x];
  const float xr = static_cast<float>(x) + static_cast<float>(sd) * dl;
  float result = CUDART_NAN_F;
  if (xr >= 0.f && xr < static_cast<float>(W)) {  // false for a NaN dl
    const int xi = static_cast<int>(fminf(xr, static_cast<float>(W - 1)));  // truncation
    const int k = x - xi;
    if (k >= k_min && k <= k_max) {
      const float dr = partner[xi];
      if (isfinite(dr) && fabsf(dl - dr) <= max_diff) result = dl;
    }
  }
  return result;
}

// --- the row design ----------------------------------------------------------

constexpr int kThreads = 128;  // threads a row
constexpr int kRows = 2;       // rows a block, at most
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 232448;  // the most a block can have (227 KB), opted in

// G floats of src to dst, both at a multiple of G
template <int G>
__device__ __forceinline__ void copy_vec(const float* src, float* dst) {
  if constexpr (G == 4) {
    *reinterpret_cast<float4*>(dst) = __ldg(reinterpret_cast<const float4*>(src));
  } else if constexpr (G == 2) {
    *reinterpret_cast<float2*>(dst) = __ldg(reinterpret_cast<const float2*>(src));
  } else {
    *dst = __ldg(src);
  }
}

template <int G>
__global__ void __launch_bounds__(kThreads * kRows)
    lr_rows_kernel(const float* __restrict__ disp_l, const float* __restrict__ disp_r,
                   float* __restrict__ out_l, float* __restrict__ out_r, int H, int W, int pitch,
                   int sd, float max_diff, int max_disp) {
  extern __shared__ __align__(16) float smem[];
  float* l = smem + threadIdx.y * 2 * pitch;
  float* r = l + pitch;
  const int y = blockIdx.x * blockDim.y + threadIdx.y;
  const bool row = y < H;  // no early return: the pair mode has a barrier
  const size_t base = static_cast<size_t>(y) * W;
  if (row) {
    for (int i = threadIdx.x * G; i < W; i += kThreads * G) {
      copy_vec<G>(disp_l + base + i, l + i);
      copy_vec<G>(disp_r + base + i, r + i);
    }
  }
  __syncthreads();
  if (sd != 0) {
    const int k_min = sd < 0 ? -1 : -max_disp, k_max = sd < 0 ? max_disp - 1 : 1;
    if (row)
      for (int x = threadIdx.x; x < W; x += kThreads)
        out_l[base + x] = check(l, r, x, W, sd, max_diff, k_min, k_max);
    return;
  }
  // the right row against the left first; each thread reads only its own
  // pixels of r, so they are overwritten in place
  if (row) {
    for (int x = threadIdx.x; x < W; x += kThreads) {
      const float v = check(r, l, x, W, 1, max_diff, -max_disp, 1);
      out_r[base + x] = v;
      r[x] = v;
    }
  }
  __syncthreads();
  if (row)
    for (int x = threadIdx.x; x < W; x += kThreads)
      out_l[base + x] = check(l, r, x, W, -1, max_diff, -1, max_disp - 1);
}

// --- the replaced design: one thread per pixel, one direction ----------------

constexpr int kPixelThreads = 128;

__global__ void lr_check_kernel(const float* __restrict__ disp_l, const float* __restrict__ disp_r,
                                float* __restrict__ out, int H, int W, int sd, float max_diff,
                                int k_min, int k_max) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= W) return;
  const size_t row = static_cast<size_t>(y) * W;
  out[row + x] = check(disp_l + row, disp_r + row, x, W, sd, max_diff, k_min, k_max);
}

}  // namespace

// sd = +1 or -1: out_l = check(disp_l, disp_r, sd); sd = 0: out_r =
// check(disp_r, disp_l, +1), then out_l = check(disp_l, out_r, -1)
extern "C" int kt_lr_check(const void* disp_l, const void* disp_r, void* out_l, void* out_r, int H,
                           int W, int sd, float max_diff, int max_disp, void* stream) {
  if (H < 1 || W < 1 || sd < -1 || sd > 1 || (sd == 0 && out_r == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int pitch = (W + 3) / 4 * 4;  // 16-byte rows in shared memory
  const size_t row_bytes = 2 * static_cast<size_t>(pitch) * sizeof(float);
  if (row_bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  int rows = kRows;
  while (rows > 1 && rows * row_bytes > kDefaultSmem) --rows;
  const size_t smem = rows * row_bytes;
  // the widest load that both images' bases and the row stride allow
  const uintptr_t both = reinterpret_cast<uintptr_t>(disp_l) | reinterpret_cast<uintptr_t>(disp_r) |
                         (static_cast<uintptr_t>(W) * sizeof(float));
  auto kernel = both % 16 == 0 ? &lr_rows_kernel<4>
                : both % 8 == 0  ? &lr_rows_kernel<2>
                                 : &lr_rows_kernel<1>;
  if (smem > kDefaultSmem) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 block(kThreads, rows);
  kernel<<<(H + rows - 1) / rows, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(disp_l), static_cast<const float*>(disp_r),
      static_cast<float*>(out_l), static_cast<float*>(out_r), H, W, pitch, sd, max_diff, max_disp);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int kt_lr_check_pixel(const void* disp_l, const void* disp_r, void* out, int H, int W,
                                 int sd, float max_diff, int k_min, int k_max, void* stream) {
  if (H < 1 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((W + kPixelThreads - 1) / kPixelThreads, H);
  lr_check_kernel<<<grid, kPixelThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(disp_l), static_cast<const float*>(disp_r),
      static_cast<float*>(out), H, W, sd, max_diff, k_min, k_max);
  return static_cast<int>(cudaGetLastError());
}
