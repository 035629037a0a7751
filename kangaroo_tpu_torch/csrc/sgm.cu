// Semi-global matching over one segment of a sharded or stacked image, one
// path direction per launch, by one warp per path line: the comparison
// design for csrc/sgm_path.cu's kt_sgm_segment (kernels 6 and 7), launched
// by no path of the package. chip_smoke.py and the card tests hold
// kt_sgm_segment and kt_sgm_path against it bit for bit and time it beside
// them (kt_sgm_segment_lines, the same C signature as kt_sgm_segment).
//
// Computes what kangaroo_tpu/stereo/sgm_pallas.py:_make_kernel's
// with_offset / seam_blocks / carry_in / carry_out variants and
// _make_diag_kernel compute. A direction is a step (sx, sy), each in
// {-1, 0, +1}: pixel (x, y) continues the path from (x - sx, y - sy). Per
// path step:
//   CM(d) = min(prev(d), min(prev(d-1), prev(d+1)) + P1, lastBest + P2')
//   Lr(d) = CM(d) + C(d) - lastBest,   P2' = P2 / (1 + |I(p) - I(p-r)|)
// with entries off the disparity lattice held at 1e30 in the carry and
// written as 0. The lattice is d <= xa for sd = -1 and xa + d < width for
// sd = +1, xa = x + xoff the pixel's column in the whole image (a column
// shard passes its offset). A pixel whose predecessor is off the image, or
// at or past column `width` on a diagonal, starts a path: it writes C and
// leaves lastBest at 0. Run over a whole image with no offset, seam or
// carry, it gives the bits of kt_sgm_path (the same operations per element
// in the same order).
//
// Segments: with a carry in, the first row of the scan continues from the
// upstream segment's last row instead of seeding: prev and lastBest from
// the carry at the predecessor's column, P2' from the upstream last
// intensity there; a diagonal continues only where the carry's has-path
// mask is set (an all-zero mask is a seed). With a carry out, the pixels of
// the scan's last row write their prev and lastBest for the downstream
// segment. With a seam period, a vertical line restarts every `seam` rows,
// so frames stacked along the rows aggregate in one launch as if each were
// alone.
//
// Why it is slow on the H100: memory transactions. Each path step reads D
// costs and reads and writes D accumulator values, each a 4-byte access at
// stride S·N, one 32-byte sector apiece; and the step waits for those
// loads (only the costs are loaded a step ahead). csrc/sgm_path.cu reads
// contiguous runs of adjacent lines through a ring in shared memory.
//
// Design: one warp owns one whole path line and loops along it, so nothing
// carries between blocks, which run in no order. A direction's lines start
// on its entry row (y = 0 going down, S - 1 going up; N lines, or N per
// frame with a seam period) and, for a diagonal, also on its entry column
// (S - 1 more lines); the first pixel of a line is exactly the pixel whose
// predecessor is off the segment, so every re-seed of the TPU kernel is
// this kernel's first step, and the carry enters there. Diagonal lines
// differ in length; neighbouring warps hold neighbouring lines of similar
// length. Each lane holds DPT consecutive disparities of the carry in
// registers; the d-1 / d+1 neighbours across lanes come from warp shuffles
// and lastBest from a five-step xor-shuffle min, so a step needs no shared
// memory and no block barrier. The next step's costs are loaded before the
// current step's arithmetic to hide their latency. The volume is read in
// its (D, S, N) layout for every direction, through strides, so a column
// block of a wider array is read and written in place (an upward segment
// is sy = -1). Directions chain through one f32 output: a launch writes
// Lr, or adds it onto an accumulator (which may be the output itself).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kBig = 1e30f;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kWarpsPerBlock = 4;

__device__ __forceinline__ float load_cost(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float load_cost(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}

struct PathArgs {
  const void* vol;   // (D, S, N), element strides vol_sd, vol_sy, 1
  const float* img;  // (S, N), strides img_sy, 1
  float* out;        // (D, S, N), strides out_sd, out_sy, 1
  const float* acc;  // null: out = Lr; else out = acc + Lr (same strides; may be out)
  long long vol_sd, vol_sy, img_sy, out_sd, out_sy;
  int D, S, N;
  int sx, sy, sd;
  int xoff, width;  // the lattice's column offset and image width
  int seam;         // vertical lines restart every `seam` rows; 0: never
  float P1, P2;
  const float* cin_prev;  // (D, N) contiguous, or null: the lines seed
  const float* cin_best;  // (N,)
  const float* cin_img;   // (N,) the upstream last intensity row
  const float* cin_has;   // (N,) 0/1, diagonals only; null: every column continues
  float* cout_prev;       // (D, N) contiguous, or null: no carry out
  float* cout_best;       // (N,)
};

// Number of path lines of direction (sx, sy) over an S x N segment.
__host__ __device__ __forceinline__ int n_lines(const PathArgs& a) {
  if (a.sy == 0) return a.S;
  if (a.sx == 0) return a.seam ? (a.S / a.seam) * a.N : a.N;
  return a.N + a.S - 1;
}

template <typename T, int DPT>
__global__ void sgm_path_kernel(const PathArgs a) {
  const int line = blockIdx.x * blockDim.y + threadIdx.y;
  if (line >= n_lines(a)) return;  // uniform across the warp
  const int lane = threadIdx.x;
  const int D = a.D, S = a.S, N = a.N, sx = a.sx, sy = a.sy;
  const T* __restrict__ vol = static_cast<const T*>(a.vol);
  const float* __restrict__ img = a.img;
  const int entry_x = sx > 0 ? 0 : N - 1;
  const int entry_y = sy > 0 ? 0 : S - 1;
  const int last_y = sy > 0 ? S - 1 : 0;
  // the line's first pixel (x0, y0) and its length L
  int x0, y0, L;
  if (sy == 0) {
    x0 = entry_x;
    y0 = line;
    L = N;
  } else if (sx == 0) {
    const int len = a.seam ? a.seam : S;
    x0 = line % N;
    y0 = (line / N) * len + (sy > 0 ? 0 : len - 1);
    L = len;
  } else {
    if (line < N) {
      x0 = line;
      y0 = entry_y;
    } else {  // a diagonal line entering through the entry column below/above the corner
      x0 = entry_x;
      y0 = entry_y + sy * (line - N + 1);
    }
    L = min(sx > 0 ? N - x0 : x0 + 1, sy > 0 ? S - y0 : y0 + 1);
  }
  const int d0 = lane * DPT;
  const int width = a.width;

  float prev[DPT];
  float cost[DPT];
  float next_cost[DPT];
  float best = 0.f;

  auto load_step = [&](int t, float* dst) {
    const long long off = static_cast<long long>(y0 + t * sy) * a.vol_sy + (x0 + t * sx);
#pragma unroll
    for (int k = 0; k < DPT; ++k) {
      const int d = d0 + k;
      dst[k] = d < D ? load_cost(vol, d * a.vol_sd + off) : kBig;
    }
  };

  load_step(0, next_cost);
  for (int t = 0; t < L; ++t) {
#pragma unroll
    for (int k = 0; k < DPT; ++k) cost[k] = next_cost[k];
    if (t + 1 < L) load_step(t + 1, next_cost);

    const int x = x0 + t * sx;
    const int y = y0 + t * sy;
    const int xp = x - sx;       // the predecessor's column
    const int xa = x + a.xoff;  // the lattice's column
    const long long ooff = static_cast<long long>(y) * a.out_sy + x;
    const float here = img[static_cast<long long>(y) * a.img_sy + x];
    // a diagonal's predecessor must lie inside the image width
    const bool pred_in = sx == 0 || sy == 0 || (xp >= 0 && xp < N && xp < width);
    bool cont;
    float p2 = 0.f;
    if (t > 0) {
      cont = pred_in;
      if (cont) {
        const float there = img[static_cast<long long>(y - sy) * a.img_sy + xp];
        p2 = a.P2 / (1.0f + fabsf(there - here));
      }
    } else {
      cont = a.cin_prev != nullptr && y == entry_y && pred_in &&
             (a.cin_has == nullptr || a.cin_has[xp] > 0.5f);
      if (cont) {
#pragma unroll
        for (int k = 0; k < DPT; ++k) {
          const int d = d0 + k;
          prev[k] = d < D ? a.cin_prev[static_cast<long long>(d) * N + xp] : kBig;
        }
        best = a.cin_best[xp];
        p2 = a.P2 / (1.0f + fabsf(a.cin_img[xp] - here));
      }
    }

    if (!cont) {  // a path starts here: Lr = C, lastBest = 0
#pragma unroll
      for (int k = 0; k < DPT; ++k) {
        const int d = d0 + k;
        const bool valid = d < D && (a.sd < 0 ? d <= xa : xa + d < width);
        prev[k] = valid ? cost[k] : kBig;
        if (d < D) {
          const long long i = d * a.out_sd + ooff;
          const float v = valid ? cost[k] : 0.f;
          a.out[i] = a.acc ? a.acc[i] + v : v;
        }
      }
      best = 0.f;
    } else {
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
        const float cm = fminf(fminf(prev[k], fminf(down, up) + a.P1), best_p2);
        const bool valid = d < D && (a.sd < 0 ? d <= xa : xa + d < width);
        const float v = valid ? cm + cost[k] - best : kBig;
        cr[k] = v;
        local_min = fminf(local_min, v);
        if (d < D) {
          const long long i = d * a.out_sd + ooff;
          const float w = valid ? v : 0.f;
          a.out[i] = a.acc ? a.acc[i] + w : w;
        }
      }
#pragma unroll
      for (int k = 0; k < DPT; ++k) prev[k] = cr[k];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        local_min = fminf(local_min, __shfl_xor_sync(kFullMask, local_min, o));
      best = local_min;
    }

    if (a.cout_prev != nullptr && y == last_y) {  // the carry for the next segment
#pragma unroll
      for (int k = 0; k < DPT; ++k) {
        const int d = d0 + k;
        if (d < D) a.cout_prev[static_cast<long long>(d) * N + x] = prev[k];
      }
      if (lane == 0) a.cout_best[x] = best;
    }
  }
}

template <typename T>
cudaError_t launch_typed(const PathArgs& a, cudaStream_t stream) {
  const dim3 block(32, kWarpsPerBlock);
  const dim3 grid((n_lines(a) + kWarpsPerBlock - 1) / kWarpsPerBlock);
#define KT_SGM_LAUNCH(DPT) sgm_path_kernel<T, DPT><<<grid, block, 0, stream>>>(a)
  if (a.D <= 32) KT_SGM_LAUNCH(1);
  else if (a.D <= 64) KT_SGM_LAUNCH(2);
  else if (a.D <= 128) KT_SGM_LAUNCH(4);
  else KT_SGM_LAUNCH(8);
#undef KT_SGM_LAUNCH
  return cudaGetLastError();
}

int launch(const PathArgs& a, int vol_is_bf16, void* stream) {
  if (a.D < 1 || a.D > 256 || a.S < 1 || a.N < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (a.sx < -1 || a.sx > 1 || a.sy < -1 || a.sy > 1 || (a.sx == 0 && a.sy == 0))
    return static_cast<int>(cudaErrorInvalidValue);
  // seams re-seed vertical lines only, and a seamed scan has no carry
  if (a.seam < 0 || (a.seam && (a.sx != 0 || a.S % a.seam || a.cin_prev || a.cout_prev)))
    return static_cast<int>(cudaErrorInvalidValue);
  // a carry crosses rows: horizontal lines have none
  if (a.sy == 0 && (a.cin_prev || a.cout_prev)) return static_cast<int>(cudaErrorInvalidValue);
  if ((a.cin_prev && (!a.cin_best || !a.cin_img)) || (a.cout_prev && !a.cout_best))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(vol_is_bf16 ? launch_typed<__nv_bfloat16>(a, s)
                                      : launch_typed<float>(a, s));
}

}  // namespace

// One direction over a (D, S, N) segment given by strides: a lattice offset
// and width, a seam period, a carry in (cin_prev null: none; cin_has null: a
// straight carry) and out (cout_prev null: none), and an accumulator (null:
// none; it may be out itself). Any step, horizontal too.
extern "C" int kt_sgm_segment_lines(const void* vol, int vol_is_bf16, long long vol_sd,
                              long long vol_sy, const void* img, long long img_sy, void* out,
                              const void* acc, long long out_sd, long long out_sy, int D, int S,
                              int N, int sx, int sy, int sd, int xoff, int width, int seam,
                              float P1, float P2, const void* cin_prev, const void* cin_best,
                              const void* cin_img, const void* cin_has, void* cout_prev,
                              void* cout_best, void* stream) {
  PathArgs a{};
  a.vol = vol;
  a.img = static_cast<const float*>(img);
  a.out = static_cast<float*>(out);
  a.acc = static_cast<const float*>(acc);
  a.vol_sd = vol_sd;
  a.vol_sy = vol_sy;
  a.img_sy = img_sy;
  a.out_sd = out_sd;
  a.out_sy = out_sy;
  a.D = D;
  a.S = S;
  a.N = N;
  a.sx = sx;
  a.sy = sy;
  a.sd = sd;
  a.xoff = xoff;
  a.width = width;
  a.seam = seam;
  a.P1 = P1;
  a.P2 = P2;
  a.cin_prev = static_cast<const float*>(cin_prev);
  a.cin_best = static_cast<const float*>(cin_best);
  a.cin_img = static_cast<const float*>(cin_img);
  a.cin_has = static_cast<const float*>(cin_has);
  a.cout_prev = static_cast<float*>(cout_prev);
  a.cout_best = static_cast<float*>(cout_best);
  return launch(a, vol_is_bf16, stream);
}
