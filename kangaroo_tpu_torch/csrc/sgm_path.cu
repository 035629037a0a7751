// Semi-global matching, one path direction per launch, straight or
// diagonal: over a whole image, or a row block of one read and written in
// place through strides (kt_sgm_path, kernels 1 and 5); and over one segment
// of a sharded or stacked image (kt_sgm_segment, kernels 6 and 7).
//
// Replaces kangaroo_tpu/stereo/sgm_pallas.py:_make_kernel (the straight
// paths, driven by _aggregate_direction) and _make_multi_diag_kernel (the
// 8-path mode's diagonals, driven by _multi_diag_direction); and
// _make_kernel's with_offset / seam_blocks / carry_in / carry_out variants
// (sgm_aggregate_scan's lane offset and seam period, sgm_aggregate_block)
// and _make_diag_kernel (one diagonal segment with a carry,
// sgm_aggregate_diag_block). A direction is a step (sx, sy), each in
// {-1, 0, +1}: pixel (x, y) continues the path from (x - sx, y - sy). Per
// path step:
//   CM(d) = min(prev(d), min(prev(d-1), prev(d+1)) + P1, lastBest + P2')
//   Lr(d) = CM(d) + C(d) - lastBest,   P2' = P2 / (1 + |I(p) - I(p-r)|)
// with entries off the disparity lattice (d <= xa for sd = -1, xa + d <
// width for sd = +1; xa = x and width = N on a whole image, xa = x + xoff on
// a column shard) held at 1e30 in the carry and written as 0. A pixel whose
// predecessor is off the image (on a segment's diagonal also at or past
// column `width`) starts a path: it writes C and leaves lastBest at 0. A
// launch writes Lr, or adds it onto the output in place (a segment: onto an
// accumulator read through the output's strides, which may be the output).
// The operations per element and their order are those of csrc/sgm.cu's
// warp-per-line kernel (kt_sgm_segment_lines), so the two give the same bits.
//
// Segments (kt_sgm_segment: vertical and diagonal steps; a horizontal one is
// whole rows, kt_sgm_path's). With a carry in, the entry row continues the
// upstream segment's last row instead of seeding: prev and lastBest from
// the carry at the predecessor's column, P2' from the upstream last
// intensity there; a diagonal continues only where the carry's has-path
// mask is set (an all-zero mask is a seed). With a carry out, the scan's
// last row writes its prev and lastBest for the downstream segment. With a
// seam period, frames of `seam` rows stacked along the rows aggregate in
// one launch as if each were alone: the grid's y is the frame.
//
// What bounds it on the H100: each step of a path line reads D costs and D
// accumulator values and writes D outputs, and the recurrence is sequential
// along the line (up to H or W steps). The byte floor (the volume, and the
// f32 aggregate in and out once a direction) is far below the measured
// time, which does not change when the data fits in L2: the SM's copy
// instructions bound it (one 4-byte cp.async a thread and element; a
// step's dependent chain, two shuffles, the recurrence and a five-step
// xor-shuffle min, is the smaller part). PERF.md has the measurements.
//
// Design. A warp follows one line; lane l holds disparities d = 32k + l, so
// d - 1 and d + 1 come from the lanes beside it (warp shuffles, the last
// lane's from the first lane's next k) and lastBest from a five-step
// xor-shuffle min. The lines a block follows are adjacent in memory at every
// step, and the block stages their data through a ring of stages in shared
// memory that kCopiers more warps fill with cp.async several stages ahead
// and write back, while the line warps step through the stage at hand; one
// barrier a stage hands stages over. So nothing from device memory is on a
// step's chain, and every access to device memory is a run along a row:
// - Vertical and diagonal directions (sgm_rows_kernel): lines are numbered
//   by their intercept k = x - sx*sy*y (N lines, N + S - 1 on a diagonal)
//   and all step one row at a time from the entry row. A block owns
//   kLines adjacent intercepts, so at each row its pixels are kLines
//   adjacent columns of that row: a stage is up to kRowsPerStage rows, each
//   a (D, kLines) tile of costs and accumulator read as runs of kLines. A
//   line whose column is off the image at a row idles there; its first
//   pixel in the image is exactly the pixel whose predecessor is off the
//   image: a seed. A segment's line warps read the carry in with plain
//   loads at the entry row and write the carry out at the last, once a
//   line; a seam period's frames are the grid's y, each block stepping the
//   rows of one frame.
// - Horizontal directions (sgm_cols_kernel): a block owns up to kMaxRows
//   rows; a stage is kChunk columns of them, a (rows, D, kChunk) tile read
//   as runs of kChunk.
// The outputs go into the stage's accumulator tile and are written back as
// runs once the block has passed its next barrier. A tile's rows are an odd
// number of words apart, so the 32 lanes reading one column hit 32 banks.
// A bf16 run is copied as the 4-byte words that cover it, starting half a
// word in where the run's first element is odd: its element offset is the
// parity of its address in half-words. So the word of a run's first or last
// element may also hold the half-word before or after the run, which can lie
// outside the tensor's storage. Each such word is 4-byte aligned and holds
// an element of the tensor, so it never crosses an aligned 4-byte boundary
// of the buffer: on the card no read leaves the page an element lies in.
// The extra half-word lands in shared memory and is never read from there.
// A seed's values are selected, not branched to, so a step has no branch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <type_traits>

namespace {

constexpr float kBig = 1e30f;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kLines = 8;           // adjacent lines a block of the row-stepped kernel (PERF.md)
constexpr int kCopiers = 4;         // copying warps a block
constexpr int kRowsPerStage = 8;    // image rows a stage of the row-stepped kernel, at most
constexpr int kChunk = 16;          // columns a stage of the horizontal kernel
constexpr int kMaxRows = 4;         // rows a block of the horizontal kernel
constexpr int kMaxAhead = 8;        // stages in flight, at most
constexpr int kRingBudget = 112 * 1024;  // two blocks fit on an SM
constexpr int kMaxSmem = 227 * 1024;
constexpr int kCopierThreads = 32 * kCopiers;
static_assert(kLines + kCopiers <= 32 && kMaxRows + kCopiers <= 32, "32 warps a block");

struct PathArgs {
  const void* vol;   // (D, S, N), element strides vol_sd, vol_sy, 1
  const float* img;  // (S, N), strides img_sy, 1
  float* out;        // (D, S, N), strides out_sd, out_sy, 1
  long long vol_sd, vol_sy, img_sy, out_sd, out_sy;
  int D, S, N;
  int sx, sy, sd;
  float P1, P2;
  int accumulate;  // out += Lr instead of out = Lr
  // the segment entry's alone (kt_sgm_segment; kt_sgm_path leaves them 0)
  const float* acc;       // what accumulate adds onto, through out's strides (may be out)
  int xoff, width;        // the lattice's column offset and image width
  int seam;               // frames of `seam` rows aggregate alone; 0: one frame
  const float* cin_prev;  // (D, N) contiguous, or null: the entry row seeds
  const float* cin_best;  // (N,)
  const float* cin_img;   // (N,) the upstream segment's last intensity row
  const float* cin_has;   // (N,) 0/1 (diagonals), or null: every column continues
  float* cout_prev;       // (D, N) contiguous, or null: no carry out
  float* cout_best;       // (N,)
};

// words of a staged run of n elements, and the pitch of a tile's rows
template <typename T>
__host__ __device__ constexpr int run_words(int n) {
  return std::is_same<T, float>::value ? n : n / 2 + 1;  // bf16: pairs, one more for an odd start
}
__host__ __device__ constexpr int odd_pitch(int words) { return words | 1; }

// the parity of element e of src in half-words: a bf16 run starting there
// begins half a word into its first 4-byte word
template <typename T>
__device__ __forceinline__ int half_parity(const T* src, long long e) {
  if constexpr (std::is_same<T, float>::value) {
    return 0;
  } else {
    return static_cast<int>(((reinterpret_cast<uintptr_t>(src) >> 1) + e) & 1);
  }
}

__device__ __forceinline__ void cp_async4(float* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// waits until at most n of this thread's copy groups are in flight
__device__ __forceinline__ void cp_async_wait_dyn(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

// Starts copying nruns runs of kSlots elements into shared memory: slot s
// of run q is element e0 + q * q_stride + s of src, and only slots
// [s_lo, s_hi) are wanted. Run q lands at dst + q * pitch words (a bf16 run
// half_parity elements in). kSlots (a power of two) of the kCopierThreads
// copying threads share a run; tid is the thread's index among them.
template <typename T, int kSlots>
__device__ __forceinline__ void stage_runs(float* dst, int pitch, const T* src, long long e0,
                                           long long q_stride, int nruns, int s_lo, int s_hi,
                                           int tid) {
  constexpr int kStep = kCopierThreads / kSlots;  // runs a pass
  const int w = tid % kSlots;
  int q = tid / kSlots;
  if constexpr (std::is_same<T, float>::value) {
    if (w < s_lo || w >= s_hi) return;
    const float* p = src + (e0 + q * q_stride + w);
    float* d = dst + q * pitch + w;
#pragma unroll 4
    for (; q < nruns; q += kStep, p += kStep * q_stride, d += kStep * pitch) cp_async4(d, p);
  } else {
    if (w >= run_words<T>(kSlots)) return;
    const long long e = e0 + q * q_stride;
    const T* p = src + e;  // slot 0 of run q
    int o = half_parity(src, e);
    const int o_step = static_cast<int>((kStep * q_stride) & 1);
    float* d = dst + q * pitch + w;
    // word w holds slots 2w - o and 2w + 1 - o
#pragma unroll 4
    for (; q < nruns; q += kStep, p += kStep * q_stride, d += kStep * pitch, o ^= o_step)
      if (2 * w + 1 - o >= s_lo && 2 * w - o < s_hi) cp_async4(d, p + (2 * w - o));
  }
}

// Writes slots [s_lo, s_hi) of nruns staged float runs back: slot s of run
// q to dst[e0 + q * q_stride + s]; tid as for stage_runs.
template <int kSlots>
__device__ __forceinline__ void store_runs(float* dst, long long e0, long long q_stride,
                                           const float* src, int pitch, int nruns, int s_lo,
                                           int s_hi, int tid) {
  constexpr int kStep = kCopierThreads / kSlots;
  const int s = tid % kSlots;
  int q = tid / kSlots;
  if (s < s_lo || s >= s_hi) return;
  float* p = dst + (e0 + q * q_stride + s);
  const float* r = src + q * pitch + s;
#pragma unroll 4
  for (; q < nruns; q += kStep, p += kStep * q_stride, r += kStep * pitch) *p = *r;
}

// slot s of a staged run (o: its half-word offset)
__device__ __forceinline__ float tile_cost(const float* run, int, int s, float) { return run[s]; }
__device__ __forceinline__ float tile_cost(const float* run, int o, int s, __nv_bfloat16) {
  return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(run)[o + s]);
}

// One path step of one line: cost[k] is the cost at d = 32k + lane (kBig
// for d >= D); lim the largest d on the lattice at this pixel; the pixel's
// output (and accumulator) is slot[d * stride] in shared memory. A seed
// takes Lr = C and lastBest = 0; the recurrence's value is computed on
// every step and selected, so the step has no branch.
template <int DPT>
__device__ __forceinline__ void path_step(float (&prev)[DPT], float& best, const float (&cost)[DPT],
                                          bool seed, float p2, int lim, const PathArgs& a,
                                          int lane, float* slot, int stride) {
  const int D = a.D;
  const float best_p2 = best + p2;
  // the carry at d - 1 and d + 1: from the lane below and above, and across
  // the wrap from lane 31 of k - 1 and lane 0 of k + 1
  float below[DPT], above[DPT];
#pragma unroll
  for (int k = 0; k < DPT; ++k) {
    below[k] = __shfl_sync(kFullMask, prev[k], (lane + 31) & 31);
    above[k] = __shfl_sync(kFullMask, prev[k], (lane + 1) & 31);
  }
  float local_min = kBig;
#pragma unroll
  for (int k = 0; k < DPT; ++k) {
    const int d = 32 * k + lane;
    const float down = d == 0 ? kBig : (lane > 0 ? below[k] : below[k > 0 ? k - 1 : 0]);
    const float up = d >= D - 1 ? kBig : (lane < 31 ? above[k] : above[k + 1 < DPT ? k + 1 : k]);
    const float cm = fminf(fminf(prev[k], fminf(down, up) + a.P1), best_p2);
    const bool valid = d <= lim && d < D;
    const float v = valid ? (seed ? cost[k] : cm + cost[k] - best) : kBig;
    prev[k] = v;
    local_min = fminf(local_min, v);
    if (d < D) {
      float* o = slot + d * stride;
      const float prior = *o;
      const float w = valid ? v : 0.f;
      *o = a.accumulate ? prior + w : w;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    local_min = fminf(local_min, __shfl_xor_sync(kFullMask, local_min, o));
  best = seed ? 0.f : local_min;
}

// the largest d on the lattice at column x: a segment's lattice is that of
// column xa = x + xoff of an image `width` wide
template <bool kSeg>
__device__ __forceinline__ int lattice_lim(const PathArgs& a, int x) {
  if constexpr (kSeg) {
    const int xa = x + a.xoff;
    return a.sd < 0 ? xa : a.width - 1 - xa;
  } else {
    return a.sd < 0 ? x : a.N - 1 - x;
  }
}

// Vertical and diagonal directions: block b follows the kLines lines of
// intercepts kmin + b * kLines + c, c < kLines, warp c line c, one row a
// step; kCopiers more warps copy. A stage is `rows` image rows; a row
// of it: costs (D, pc words), accumulator / output (D, pa), the
// intensities (kLines). kSeg compiles in the segment entry's features: the
// lattice offset and width, the frames of a seam period (blockIdx.y is the
// frame), the carry in at the entry row and out at the last.
template <typename T, int DPT, bool kSeg>
__global__ void __launch_bounds__(32 * (kLines + kCopiers))
    sgm_rows_kernel(const PathArgs a, int rows, int ring) {
  extern __shared__ float smem[];
  constexpr int pc = odd_pitch(run_words<T>(kLines)), pa = odd_pitch(kLines);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool copier = warp >= kLines;
  const int ctid = threadIdx.x - 32 * kLines;
  const int D = a.D, N = a.N, sx = a.sx, sy = a.sy;
  // the frame's rows: yb .. yb + S - 1 of the volume
  const int S = kSeg && a.seam ? a.seam : a.S;
  const int yb = kSeg ? static_cast<int>(blockIdx.y) * S : 0;
  const T* __restrict__ vol = static_cast<const T*>(a.vol);
  const float* acc = kSeg ? a.acc : a.out;  // may be a.out
  const int row_words = D * (pc + pa) + kLines, stage_words = rows * row_words;
  const int y_e = sy > 0 ? 0 : S - 1;
  // slot 0's column at step t (row y_e + sy * t) is x0 + sx * t
  const int x0 = (sx * sy > 0 ? 1 - S : 0) + static_cast<int>(blockIdx.x) * kLines + sx * sy * y_e;
  // the steps at which some slot lies in the image
  int t_first = 0, t_last = S - 1;
  if (sx > 0) {
    t_first = max(0, 1 - kLines - x0);
    t_last = min(S - 1, N - 1 - x0);
  } else if (sx < 0) {
    t_first = max(0, x0 - N + 1);
    t_last = min(S - 1, x0 + kLines - 1);
  }
  if (t_first > t_last) return;  // uniform across the block
  const int n_stages = (t_last - t_first) / rows + 1;
  const int ahead = ring - 2;

  auto stage = [&](int n) { return smem + (n % ring) * stage_words; };
  auto load = [&](int n) {
    float* st = stage(n);
    for (int j = 0; j < rows; ++j) {
      const int t = t_first + n * rows + j;
      if (t > t_last) break;
      float* sr = st + j * row_words;
      const long long y = yb + y_e + sy * t;
      const int x_lo = x0 + sx * t, s_lo = max(0, -x_lo), s_hi = min(kLines, N - x_lo);
      stage_runs<T, kLines>(sr, pc, vol, y * a.vol_sy + x_lo, a.vol_sd, D, s_lo, s_hi, ctid);
      if (a.accumulate)
        stage_runs<float, kLines>(sr + D * pc, pa, acc, y * a.out_sy + x_lo, a.out_sd, D, s_lo,
                                  s_hi, ctid);
      stage_runs<float, kLines>(sr + D * (pc + pa), kLines, a.img, y * a.img_sy + x_lo, 0, 1,
                                s_lo, s_hi, ctid);
    }
  };
  auto store = [&](int n) {
    const float* st = stage(n);
    for (int j = 0; j < rows; ++j) {
      const int t = t_first + n * rows + j;
      if (t > t_last) break;
      const long long y = yb + y_e + sy * t;
      const int x_lo = x0 + sx * t, s_lo = max(0, -x_lo), s_hi = min(kLines, N - x_lo);
      store_runs<kLines>(a.out, y * a.out_sy + x_lo, a.out_sd, st + j * row_words + D * pc, pa,
                         D, s_lo, s_hi, ctid);
    }
  };

  // the half-word parity of a bf16 run: that of its row and column start,
  // plus d's share (vol_sd odd)
  const int par_base = half_parity(vol, 0);
  const int par_sd = static_cast<int>(a.vol_sd & 1), par_sy = static_cast<int>(a.vol_sy & 1);
  float prev[DPT];
#pragma unroll
  for (int k = 0; k < DPT; ++k) prev[k] = kBig;
  float best = 0.f, there = 0.f;

  if (copier) {
    for (int i = 0; i < ahead; ++i) {
      if (i < n_stages) load(i);
      cp_async_commit();
    }
  }
  for (int n = 0; n < n_stages; ++n) {
    if (copier) cp_async_wait_dyn(ahead - 1);  // this stage has landed
    __syncthreads();  // for every thread; the stage of n - 2 is free
    if (copier) {
      if (n > 0) store(n - 1);
      if (n + ahead < n_stages) load(n + ahead);
      cp_async_commit();
      continue;
    }
    float* st = stage(n);
    for (int j = 0; j < rows; ++j) {
      const int t = t_first + n * rows + j;
      if (t > t_last) break;
      const int y = yb + y_e + sy * t, x_lo = x0 + sx * t, x = x_lo + warp;
      if (x < 0 || x >= N) continue;  // uniform across the warp
      float* sr = st + j * row_words;
      const float here = sr[D * (pc + pa) + warp];
      // the predecessor is off the image, or at or past a segment's width
      // on a diagonal: a path starts here, as on the entry row
      const int xp = x - sx;
      const bool off = xp < 0 || xp >= N || (kSeg && sx != 0 && xp >= a.width);
      bool seed = off || t == 0;
      if constexpr (kSeg) {
        // the entry row continues the upstream segment's line where the
        // carry has one (uniform across the warp; once a line)
        if (t == 0 && !off && a.cin_prev && (!a.cin_has || a.cin_has[xp] > 0.5f)) {
#pragma unroll
          for (int k = 0; k < DPT; ++k) {
            const int d = 32 * k + lane;
            prev[k] = d < D ? a.cin_prev[static_cast<long long>(d) * N + xp] : kBig;
          }
          best = a.cin_best[xp];
          there = a.cin_img[xp];
          seed = false;
        }
      }
      const float p2 = a.P2 / (1.0f + fabsf(there - here));
      const int par_row = (par_base + (y & par_sy) + x_lo) & 1;
      float cost[DPT];
#pragma unroll
      for (int k = 0; k < DPT; ++k) {
        const int d = 32 * k + lane;
        cost[k] = d < D ? tile_cost(sr + d * pc, par_row ^ (d & par_sd), warp, T{}) : kBig;
      }
      path_step<DPT>(prev, best, cost, seed, p2, lattice_lim<kSeg>(a, x), a, lane,
                     sr + D * pc + warp, pa);
      there = here;
      if constexpr (kSeg) {
        if (a.cout_prev && t == S - 1) {  // the carry for the downstream segment
#pragma unroll
          for (int k = 0; k < DPT; ++k) {
            const int d = 32 * k + lane;
            if (d < D) a.cout_prev[static_cast<long long>(d) * N + x] = prev[k];
          }
          if (lane == 0) a.cout_best[x] = best;
        }
      }
    }
  }
  __syncthreads();
  if (copier) store(n_stages - 1);
}

// Horizontal directions: block b follows rows b * R .. b * R + R - 1, warp
// r row r, kChunk columns a stage; kCopiers more warps copy. A stage
// holds, per row, costs (D, pc words), accumulator / output (D, pa) and the
// intensities (kChunk).
template <typename T, int DPT>
__global__ void __launch_bounds__(32 * (kMaxRows + kCopiers))
    sgm_cols_kernel(const PathArgs a, int R, int ring) {
  extern __shared__ float smem[];
  constexpr int pc = odd_pitch(run_words<T>(kChunk)), pa = odd_pitch(kChunk);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool copier = warp >= R;
  const int ctid = threadIdx.x - 32 * R;
  const int D = a.D, S = a.S, N = a.N, sx = a.sx;
  const T* __restrict__ vol = static_cast<const T*>(a.vol);
  const int y0 = static_cast<int>(blockIdx.x) * R, rows = min(R, S - y0);
  const int row_words = D * (pc + pa) + kChunk, stage_words = R * row_words;
  const int n_chunks = (N + kChunk - 1) / kChunk;
  const int ahead = ring - 2;
  // chunk n holds steps t = n * kChunk + j (column sx > 0 ? t : N - 1 - t)
  // at slot x - x_lo(n)
  auto x_lo = [&](int n) { return sx > 0 ? n * kChunk : N - (n + 1) * kChunk; };
  auto stage = [&](int n) { return smem + (n % ring) * stage_words; };
  auto load = [&](int n) {
    float* st = stage(n);
    const int xl = x_lo(n), s_lo = max(0, -xl), s_hi = min(kChunk, N - xl);
    for (int r = 0; r < rows; ++r) {
      float* sr = st + r * row_words;
      const long long y = y0 + r;
      stage_runs<T, kChunk>(sr, pc, vol, y * a.vol_sy + xl, a.vol_sd, D, s_lo, s_hi, ctid);
      if (a.accumulate)
        stage_runs<float, kChunk>(sr + D * pc, pa, a.out, y * a.out_sy + xl, a.out_sd, D, s_lo,
                                  s_hi, ctid);
      stage_runs<float, kChunk>(sr + D * (pc + pa), kChunk, a.img, y * a.img_sy + xl, 0, 1, s_lo,
                                s_hi, ctid);
    }
  };
  auto store = [&](int n) {
    const float* st = stage(n);
    const int xl = x_lo(n), s_lo = max(0, -xl), s_hi = min(kChunk, N - xl);
    for (int r = 0; r < rows; ++r)
      store_runs<kChunk>(a.out, static_cast<long long>(y0 + r) * a.out_sy + xl, a.out_sd,
                         st + r * row_words + D * pc, pa, D, s_lo, s_hi, ctid);
  };

  const int par_base = half_parity(vol, 0);
  const int par_sd = static_cast<int>(a.vol_sd & 1), par_sy = static_cast<int>(a.vol_sy & 1);
  float prev[DPT];
#pragma unroll
  for (int k = 0; k < DPT; ++k) prev[k] = kBig;
  float best = 0.f, there = 0.f;

  if (copier) {
    for (int i = 0; i < ahead; ++i) {
      if (i < n_chunks) load(i);
      cp_async_commit();
    }
  }
  for (int n = 0; n < n_chunks; ++n) {
    if (copier) cp_async_wait_dyn(ahead - 1);
    __syncthreads();
    if (copier) {
      if (n > 0) store(n - 1);
      if (n + ahead < n_chunks) load(n + ahead);
      cp_async_commit();
      continue;
    }
    if (warp >= rows) continue;  // uniform across the warp
    float* sr = stage(n) + warp * row_words;
    const int xl = x_lo(n), y = y0 + warp;
    const int par_row = (par_base + (y & par_sy) + xl) & 1;
    for (int j = 0; j < kChunk; ++j) {
      const int t = n * kChunk + j;
      if (t >= N) break;
      const int x = sx > 0 ? t : N - 1 - t, s = x - xl;
      const float here = sr[D * (pc + pa) + s];
      const float p2 = a.P2 / (1.0f + fabsf(there - here));
      float cost[DPT];
#pragma unroll
      for (int k = 0; k < DPT; ++k) {
        const int d = 32 * k + lane;
        cost[k] = d < D ? tile_cost(sr + d * pc, par_row ^ (d & par_sd), s, T{}) : kBig;
      }
      path_step<DPT>(prev, best, cost, t == 0, p2, lattice_lim<false>(a, x), a, lane,
                     sr + D * pc + s, pa);
      there = here;
    }
  }
  __syncthreads();
  if (copier) store(n_chunks - 1);
}

// stages in the ring: up to kMaxAhead + 2 within the budget, at least 3
// (0: three do not fit)
int ring_depth(size_t stage_bytes) {
  const int fit = static_cast<int>(kRingBudget / stage_bytes);
  if (fit >= 3) return fit < kMaxAhead + 2 ? fit : kMaxAhead + 2;
  return 3 * stage_bytes <= static_cast<size_t>(kMaxSmem) ? 3 : 0;
}

using PathKernel = void (*)(PathArgs, int, int);

// Launches kernel; above the default 48 KB of dynamic shared memory, first
// raises its limit to kMaxSmem, once for each device (`raised`: one bit a
// device, kept by the caller for this kernel).
cudaError_t launch_kernel(PathKernel kernel, std::atomic<unsigned long long>& raised, dim3 grid,
                          int warps, size_t bytes, cudaStream_t stream, const PathArgs& a,
                          int per_block, int ring) {
  if (bytes > 48 * 1024) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
    if (!bit || !(raised.load(std::memory_order_relaxed) & bit)) {
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
      if (e != cudaSuccess) return e;
      raised.fetch_or(bit, std::memory_order_relaxed);
    }
  }
  kernel<<<grid, 32 * warps, bytes, stream>>>(a, per_block, ring);
  return cudaGetLastError();
}

// how many of `most` units of `unit_bytes` a stage holds so that a ring of
// four stages stays within the budget (at least one)
int units_per_stage(size_t unit_bytes, int most) {
  const int n = static_cast<int>(kRingBudget / (4 * unit_bytes));
  return n < 1 ? 1 : (n > most ? most : n);
}

// the row-stepped kernel over each frame of S rows (a.S / S of them)
template <typename T, int DPT, bool kSeg>
cudaError_t launch_rows(const PathArgs& a, cudaStream_t stream) {
  static std::atomic<unsigned long long> raised{0};
  const int S = a.seam ? a.seam : a.S;
  const size_t row =
      4 * (static_cast<size_t>(a.D) * (odd_pitch(run_words<T>(kLines)) + odd_pitch(kLines)) +
           kLines);
  const int rows = units_per_stage(row, kRowsPerStage > S ? S : kRowsPerStage);
  const int ring = ring_depth(rows * row);
  if (!ring) return cudaErrorInvalidValue;
  const int lines = a.N + (a.sx ? S - 1 : 0);
  return launch_kernel(sgm_rows_kernel<T, DPT, kSeg>, raised,
                       dim3((lines + kLines - 1) / kLines, a.S / S), kLines + kCopiers,
                       ring * rows * row, stream, a, rows, ring);
}

// a segment (vertical or diagonal) through the row-stepped kernel's segment
// build; a whole-image direction through the row-stepped or the horizontal
// kernel
template <typename T, int DPT>
cudaError_t launch_typed(const PathArgs& a, bool segment, cudaStream_t stream) {
  static std::atomic<unsigned long long> cols_raised{0};
  if (segment) return launch_rows<T, DPT, true>(a, stream);
  if (a.sy != 0) return launch_rows<T, DPT, false>(a, stream);
  const size_t row =
      4 * (static_cast<size_t>(a.D) * (odd_pitch(run_words<T>(kChunk)) + odd_pitch(kChunk)) +
           kChunk);
  const int rows = units_per_stage(row, kMaxRows > a.S ? a.S : kMaxRows);
  const int ring = ring_depth(rows * row);
  if (!ring) return cudaErrorInvalidValue;
  return launch_kernel(sgm_cols_kernel<T, DPT>, cols_raised, dim3((a.S + rows - 1) / rows),
                       rows + kCopiers, ring * rows * row, stream, a, rows, ring);
}

template <typename T>
cudaError_t launch_dtype(const PathArgs& a, bool segment, cudaStream_t stream) {
  if (a.D <= 32) return launch_typed<T, 1>(a, segment, stream);
  if (a.D <= 64) return launch_typed<T, 2>(a, segment, stream);
  if (a.D <= 128) return launch_typed<T, 4>(a, segment, stream);
  return launch_typed<T, 8>(a, segment, stream);
}

}  // namespace

// One direction over a (D, S, N) volume given by strides (unit stride along
// N): writes Lr into out, or adds it when `accumulate` is set.
extern "C" int kt_sgm_path(const void* vol, int vol_is_bf16, long long vol_sd, long long vol_sy,
                           const void* img, long long img_sy, void* out, long long out_sd,
                           long long out_sy, int D, int S, int N, int sx, int sy, int sd,
                           float P1, float P2, int accumulate, void* stream) {
  if (!vol || !img || !out || D < 1 || D > 256 || S < 1 || N < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (sx < -1 || sx > 1 || sy < -1 || sy > 1 || (sx == 0 && sy == 0))
    return static_cast<int>(cudaErrorInvalidValue);
  PathArgs a{};
  a.vol = vol;
  a.img = static_cast<const float*>(img);
  a.out = static_cast<float*>(out);
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
  a.P1 = P1;
  a.P2 = P2;
  a.accumulate = accumulate != 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(vol_is_bf16 ? launch_dtype<__nv_bfloat16>(a, false, s)
                                      : launch_dtype<float>(a, false, s));
}

// One direction over a (D, S, N) segment given by strides (kernels 6 and 7):
// a lattice offset and width, a seam period, a carry in (cin_prev null: none;
// cin_has null: a straight carry) and out (cout_prev null: none), and an
// accumulator (null: none; it may be out itself). Vertical and diagonal
// steps only: a horizontal direction is whole rows, kt_sgm_path's.
extern "C" int kt_sgm_segment(const void* vol, int vol_is_bf16, long long vol_sd,
                              long long vol_sy, const void* img, long long img_sy, void* out,
                              const void* acc, long long out_sd, long long out_sy, int D, int S,
                              int N, int sx, int sy, int sd, int xoff, int width, int seam,
                              float P1, float P2, const void* cin_prev, const void* cin_best,
                              const void* cin_img, const void* cin_has, void* cout_prev,
                              void* cout_best, void* stream) {
  if (D < 1 || D > 256 || S < 1 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (sx < -1 || sx > 1 || sy < -1 || sy > 1 || sy == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // seams re-seed vertical lines only, and a seamed scan has no carry
  if (seam < 0 || (seam && (sx != 0 || S % seam || cin_prev || cout_prev)))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((cin_prev && (!cin_best || !cin_img)) || (cout_prev && !cout_best))
    return static_cast<int>(cudaErrorInvalidValue);
  PathArgs a{};
  a.vol = vol;
  a.img = static_cast<const float*>(img);
  a.out = static_cast<float*>(out);
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
  a.P1 = P1;
  a.P2 = P2;
  a.accumulate = acc != nullptr;
  a.acc = static_cast<const float*>(acc);
  a.xoff = xoff;
  a.width = width;
  a.seam = seam;
  a.cin_prev = static_cast<const float*>(cin_prev);
  a.cin_best = static_cast<const float*>(cin_best);
  a.cin_img = static_cast<const float*>(cin_img);
  a.cin_has = static_cast<const float*>(cin_has);
  a.cout_prev = static_cast<float*>(cout_prev);
  a.cout_best = static_cast<float*>(cout_best);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(vol_is_bf16 ? launch_dtype<__nv_bfloat16>(a, true, s)
                                      : launch_dtype<float>(a, true, s));
}
