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
// along the line (up to H or W steps); a step's dependent chain is two
// shuffles, the recurrence and a five-step xor-shuffle min.
// - The row-stepped kernel (vertical and diagonal directions): its byte floor
//   (the volume, and the f32 aggregate in and out once a direction) is far
//   below the measured time, which does not change when the data fits in
//   L2: the SM's copy instructions bound it (one 4-byte cp.async a thread
//   and element, and the stage's reads and writes in shared memory).
// - The horizontal kernel (one warp a row, each lane's costs and outputs
//   straight between device memory and registers): a row's step chain
//   alone takes ≈ 0.34 µs (as long with the data in L2), so a row takes
//   ≈ 0.42 ms at W = 1242 and a stack of rows needs several rows on each
//   SM at once. But each 16-byte access of a lane lies in its own d-plane,
//   planes lie megabytes apart (7.5 MB in the SGM cell's stacked bf16
//   volume, 15 MB in its aggregate), so every vector instruction touches
//   32 pages; address translation, not bytes, bounds it: more than 4 rows
//   an SM run slower, and the same kernel on an aggregate laid out with
//   its 32 planes in one page runs ≈ 1.6 x faster. Adding each interior
//   output vector onto the aggregate by one vector reduction, where a load
//   and a store touched those pages twice, is the largest gain found.
// PERF.md has the measurements.
//
// Design. A warp follows one line; lane l holds disparities d = 32k + l, so
// d - 1 and d + 1 come from the lanes beside it (warp shuffles, the last
// lane's from the first lane's next k) and lastBest from a five-step
// xor-shuffle min. A seed's values are selected, not branched to, so a step
// has no branch. Nothing from device memory is on a step's chain, and every
// access to device memory is a run along a row.
// - Vertical and diagonal directions (sgm_rows_kernel): lines are numbered
//   by their intercept k = x - sx*sy*y (N lines, N + S - 1 on a diagonal)
//   and all step one row at a time from the entry row. A block owns
//   kLines adjacent intercepts, so at each row its pixels are kLines
//   adjacent columns of that row. The block stages their data through a
//   ring of stages in shared memory that kCopiers more warps fill with
//   cp.async several stages ahead and write back, while the line warps step
//   through the stage at hand; one barrier a stage hands stages over. A
//   stage is up to kRowsPerStage rows, each a (D, kLines) tile of costs and
//   accumulator read as runs of kLines. A line whose column is off the
//   image at a row idles there; its first pixel in the image is exactly the
//   pixel whose predecessor is off the image: a seed. A segment's line warps
//   read the carry in with plain loads at the entry row and write the carry
//   out at the last, once a line; a seam period's frames are the grid's y,
//   each block stepping the rows of one frame. The outputs go into the
//   stage's accumulator tile and are written back as runs once the block has
//   passed its next barrier. A tile's rows are an odd number of words apart,
//   so the 32 lanes reading one column hit 32 banks. A bf16 run is copied as
//   the 4-byte words that cover it, starting half a word in where the run's
//   first element is odd (the parity of its address in half-words).
// - Horizontal directions (sgm_cols_kernel): a warp follows one row, and no
//   warp shares anything; kColsRowsPerSm rows are resident on each SM, the
//   grid's warps taking the rows in turn. A lane's costs at its d-planes
//   are runs along the row, each read as aligned vectors of W words (16
//   bytes; 8 for a bf16 volume at D > 128, to stay within the registers),
//   one vector a chunk of C columns, loaded a chunk ahead of the steps that
//   use it. Each run starts at its own byte phase (rows and planes lie any
//   number of elements apart, a view at any element), so a chunk's costs
//   are the window at that phase of two neighbouring vectors: whole words
//   picked by a barrel shifter of selects, a bf16 run odd in half-words
//   shifted half a word by a funnel shift. The outputs go the other way:
//   each group of 4 columns' Lr is shifted into the aligned 16-byte vector
//   of the output run that it completes, which is stored whole, or added
//   onto the aggregate by one red.global.add.v4.f32 (round to nearest, as
//   prior + Lr; subnormal sums flush to zero, which no aggregate of costs
//   in [0, 1] and penalties reaches), or word by word where the vector
//   reaches past the row's ends. The intensities of a chunk are read by C
//   lanes, each computing the P2' of its column once.
// Every vector read holds an element of the row it serves and is aligned
// to its size, so it never crosses the page that element lies in; the
// elements it holds beyond the row, which can lie outside the tensor's
// storage, are never used, and are never written.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <type_traits>


namespace {

constexpr float kBig = 1e30f;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kLines = 8;           // adjacent lines a block of the row-stepped kernel (PERF.md)
constexpr int kCopiers = 4;         // copying warps a block of the row-stepped kernel
constexpr int kRowsPerStage = 8;    // image rows a stage of the row-stepped kernel, at most
constexpr int kMaxAhead = 8;        // stages in flight, at most
constexpr int kRingBudget = 112 * 1024;  // two blocks fit on an SM
constexpr int kMaxSmem = 227 * 1024;
constexpr int kCopierThreads = 32 * kCopiers;
static_assert(kLines + kCopiers <= 32, "32 warps a block");
constexpr int kColsRowsPerSm = 4;   // rows resident an SM in the horizontal kernel (PERF.md)

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
// for d >= D); lim the largest d on the lattice at this pixel; w[k] gets the
// pixel's Lr (0 off the lattice). A seed takes Lr = C and lastBest = 0; the
// recurrence's value is computed on every step and selected, so the step
// has no branch.
template <int DPT>
__device__ __forceinline__ void path_recur(float (&prev)[DPT], float& best,
                                           const float (&cost)[DPT], bool seed, float p2, int lim,
                                           int D, float P1, int lane, float (&w)[DPT]) {
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
    const float cm = fminf(fminf(prev[k], fminf(down, up) + P1), best_p2);
    const bool valid = d <= lim && d < D;
    const float v = valid ? (seed ? cost[k] : cm + cost[k] - best) : kBig;
    prev[k] = v;
    local_min = fminf(local_min, v);
    w[k] = valid ? v : 0.f;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    local_min = fminf(local_min, __shfl_xor_sync(kFullMask, local_min, o));
  best = seed ? 0.f : local_min;
}

// path_recur, with the pixel's output (and accumulator) at slot[d * stride]
// in shared memory
template <int DPT>
__device__ __forceinline__ void path_step(float (&prev)[DPT], float& best, const float (&cost)[DPT],
                                          bool seed, float p2, int lim, const PathArgs& a,
                                          int lane, float* slot, int stride) {
  float w[DPT];
  path_recur<DPT>(prev, best, cost, seed, p2, lim, a.D, a.P1, lane, w);
#pragma unroll
  for (int k = 0; k < DPT; ++k) {
    const int d = 32 * k + lane;
    if (d < a.D) {
      float* o = slot + d * stride;
      const float prior = *o;
      *o = a.accumulate ? prior + w[k] : w[k];
    }
  }
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

// x[s .. s + kOut) for a run-time s in [0, kMaxShift]: a barrel shifter of
// selects, a stage a bit of s
template <int kIn, int kOut, int kMaxShift>
__device__ __forceinline__ void shift_words(const unsigned (&x)[kIn], int s,
                                            unsigned (&out)[kOut]) {
  static_assert(kOut + kMaxShift <= kIn, "the shifted words lie in x");
  unsigned t[kIn];
#pragma unroll
  for (int i = 0; i < kIn; ++i) t[i] = x[i];
#pragma unroll
  for (int b = 1; b <= kMaxShift; b <<= 1) {
#pragma unroll
    for (int i = 0; i + b < kIn; ++i) t[i] = (s & b) ? t[i + b] : t[i];
  }
#pragma unroll
  for (int i = 0; i < kOut; ++i) out[i] = t[i];
}

// bytes [p, p + 4W) of the 8W bytes of lo then hi as W words; p < 4W, a
// multiple of the element's size
template <typename T, int W>
__device__ __forceinline__ void window(const unsigned (&lo)[W], const unsigned (&hi)[W], int p,
                                       unsigned (&out)[W]) {
  unsigned x[2 * W];
#pragma unroll
  for (int i = 0; i < W; ++i) {
    x[i] = lo[i];
    x[W + i] = hi[i];
  }
  if constexpr (std::is_same<T, float>::value) {
    shift_words<2 * W, W, W - 1>(x, p >> 2, out);
  } else {  // whole words, then half a word where p is odd in half-words
    unsigned s[W + 1];
    shift_words<2 * W, W + 1, W - 1>(x, p >> 2, s);
    const unsigned half = (p & 2) << 3;
#pragma unroll
    for (int i = 0; i < W; ++i) out[i] = __funnelshift_r(s[i], s[i + 1], half);
  }
}

// element e of a window, as float32
template <typename T, int W>
__device__ __forceinline__ float window_cost(const unsigned (&win)[W], int e) {
  if constexpr (std::is_same<T, float>::value) {
    return __uint_as_float(win[e]);
  } else {
    return __uint_as_float(e & 1 ? win[e >> 1] & 0xffff0000u : win[e >> 1] << 16);
  }
}

// W aligned words from p, as 16-byte (W = 2: one 8-byte) loads
template <int W>
__device__ __forceinline__ void load_words(const char* p, unsigned (&v)[W]) {
  if constexpr (W == 2) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    v[0] = u.x;
    v[1] = u.y;
  } else {
#pragma unroll
    for (int i = 0; i < W; i += 4) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(p) + i / 4);
      v[i] = u.x;
      v[i + 1] = u.y;
      v[i + 2] = u.z;
      v[i + 3] = u.w;
    }
  }
}

// A lane's runs along its row of the volume (costs) and of the output, one
// a k, as aligned vectors numbered from the run's anchor, column 0 (SX > 0)
// or column N (SX < 0), in the direction of the steps: cost vector m is
// W words at cv + SX * 4W * m, its first element column crel + SX * C * m;
// output vector h 4 words at ov + SX * 4 * h, its first column
// orel + SX * 4 * h.
template <int DPT>
struct Runs {
  const char* cv[DPT];
  float* ov[DPT];
  int cp[DPT];  // the cost run's anchor's byte phase
  int crel[DPT];
  int oq[DPT];  // the output run's anchor's phase in words
  int orel[DPT];
};

// the cost vectors m of each k (zero where a vector holds no element of
// the row)
template <int DPT, int W, int C, int SX>
__device__ __forceinline__ void load_costs(const Runs<DPT>& r, int m, int N,
                                           unsigned (&v)[DPT][W]) {
#pragma unroll
  for (int k = 0; k < DPT; ++k) {
    const int rel = r.crel[k] + SX * C * m;
    if (rel < N && rel + C > 0) {
      load_words<W>(r.cv[k] + SX * 4 * W * m, v[k]);
    } else {
#pragma unroll
      for (int i = 0; i < W; ++i) v[k][i] = 0u;
    }
  }
}

// Output vector h of each k: the columns of the groups before (wprev) and
// at h (wcur) that it holds, each group's Lr in memory order, shifted by
// the run's phase. A vector inside the row is written whole, or added onto
// the output by one vector reduction (red.global.add.v4.f32: the same
// round-to-nearest sum as prior + Lr); one reaching past the row's ends
// word by word.
template <int DPT, int SX>
__device__ __forceinline__ void store_outputs(const Runs<DPT>& r, int h, int N, int D, int lane,
                                              bool accumulate, const float (&wprev)[DPT][4],
                                              const float (&wcur)[DPT][4]) {
#pragma unroll
  for (int k = 0; k < DPT; ++k) {
    const int rel = r.orel[k] + SX * 4 * h;
    if (32 * k + lane >= D || rel >= N || rel + 4 <= 0) continue;
    // memory order: the lower group, then the higher; the vector starts
    // 4 - oq words into the lower, so 3 - oq words into x
    const float(&lo)[4] = SX > 0 ? wprev[k] : wcur[k];
    const float(&hi)[4] = SX > 0 ? wcur[k] : wprev[k];
    const unsigned x[7] = {__float_as_uint(lo[1]), __float_as_uint(lo[2]), __float_as_uint(lo[3]),
                           __float_as_uint(hi[0]), __float_as_uint(hi[1]), __float_as_uint(hi[2]),
                           __float_as_uint(hi[3])};
    unsigned v[4];
    shift_words<7, 4, 3>(x, 3 - r.oq[k], v);
    const float4 w = make_float4(__uint_as_float(v[0]), __uint_as_float(v[1]),
                                 __uint_as_float(v[2]), __uint_as_float(v[3]));
    float* p = r.ov[k] + SX * 4 * h;
    if (rel >= 0 && rel + 4 <= N) {
      if (accumulate) {
        atomicAdd(reinterpret_cast<float4*>(p), w);
      } else {
        *reinterpret_cast<float4*>(p) = w;
      }
    } else {
      const float o[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (rel + i >= 0 && rel + i < N) p[i] = accumulate ? p[i] + o[i] : o[i];
    }
  }
}

// One row y of a horizontal direction, step (SX, 0), by one warp. A chunk
// is C columns: one cost vector of W words a k, kGroups output vectors of 4
// columns. Its costs are loaded a chunk ahead, its outputs stored at each
// group's end.
template <typename T, int DPT, int SX>
__device__ __forceinline__ void cols_row(const PathArgs& a, int y, int lane) {
  constexpr int W = std::is_same<T, float>::value || DPT <= 4 ? 4 : 2;
  constexpr int C = 4 * W / static_cast<int>(sizeof(T));
  constexpr int kGroups = C / 4;
  const int D = a.D, N = a.N;
  const bool accumulate = a.accumulate;

  Runs<DPT> r;
#pragma unroll
  for (int k = 0; k < DPT; ++k) {
    // lanes past D read the last plane's run, and never store
    const int d = min(32 * k + lane, D - 1);
    const T* row = static_cast<const T*>(a.vol) + d * a.vol_sd + y * a.vol_sy;
    const uintptr_t c = reinterpret_cast<uintptr_t>(SX > 0 ? row : row + N);
    r.cp[k] = static_cast<int>(c % (4 * W));
    r.cv[k] = reinterpret_cast<const char*>(c - r.cp[k]);
    r.crel[k] = (SX > 0 ? 0 : N) - r.cp[k] / static_cast<int>(sizeof(T));
    float* orow = a.out + d * a.out_sd + y * a.out_sy;
    const uintptr_t o = reinterpret_cast<uintptr_t>(SX > 0 ? orow : orow + N);
    r.oq[k] = static_cast<int>(o % 16) / 4;
    r.ov[k] = reinterpret_cast<float*>(o - 4 * r.oq[k]);
    r.orel[k] = (SX > 0 ? 0 : N) - r.oq[k];
  }
  // lane j < C reads the intensity of step g * C + j
  const float* irow = a.img + y * a.img_sy;
  auto intensity = [&](int g) {
    const int t = g * C + lane;
    return lane < C && t < N ? __ldg(irow + (SX > 0 ? t : N - 1 - t)) : 0.f;
  };

  unsigned cur[DPT][W], nxt[DPT][W];
  load_costs<DPT, W, C, SX>(r, 0, N, cur);
  load_costs<DPT, W, C, SX>(r, 1, N, nxt);
  float next_here = intensity(0), last_here = 0.f;
  float prev[DPT], wprev[DPT][4], wcur[DPT][4];
#pragma unroll
  for (int k = 0; k < DPT; ++k) {
    prev[k] = kBig;
#pragma unroll
    for (int i = 0; i < 4; ++i) wprev[k][i] = wcur[k][i] = 0.f;
  }
  float best = 0.f;
  const int n_chunks = (N + C - 1) / C;
  for (int g = 0; g < n_chunks; ++g) {
    // the chunk's costs, the window of its vectors g and g + 1 in memory
    // order; then vector g + 2 for the next chunk
    unsigned win[DPT][W];
#pragma unroll
    for (int k = 0; k < DPT; ++k) {
      if constexpr (SX > 0) {
        window<T, W>(cur[k], nxt[k], r.cp[k], win[k]);
      } else {
        window<T, W>(nxt[k], cur[k], r.cp[k], win[k]);
      }
#pragma unroll
      for (int i = 0; i < W; ++i) cur[k][i] = nxt[k][i];
    }
    load_costs<DPT, W, C, SX>(r, g + 2, N, nxt);
    // lane j's P2' for step g * C + j, from its intensity and the step's
    // before (lane j - 1's, or the last chunk's last)
    const float here = next_here;
    next_here = intensity(g + 1);
    const float before = __shfl_sync(kFullMask, here, (lane + 31) & 31);
    const float p2_lane = a.P2 / (1.0f + fabsf((lane == 0 ? last_here : before) - here));
    last_here = __shfl_sync(kFullMask, here, C - 1);
#pragma unroll
    for (int q = 0; q < kGroups; ++q) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int e = 4 * q + j, t = g * C + e;
        if (t < N) {  // uniform across the warp
          float cost[DPT], w[DPT];
#pragma unroll
          for (int k = 0; k < DPT; ++k)
            cost[k] = 32 * k + lane < D ? window_cost<T, W>(win[k], SX > 0 ? e : C - 1 - e) : kBig;
          path_recur<DPT>(prev, best, cost, t == 0, __shfl_sync(kFullMask, p2_lane, e),
                          lattice_lim<false>(a, SX > 0 ? t : N - 1 - t), D, a.P1, lane, w);
#pragma unroll
          for (int k = 0; k < DPT; ++k) wcur[k][SX > 0 ? j : 3 - j] = w[k];
        }
      }
      store_outputs<DPT, SX>(r, g * kGroups + q, N, D, lane, accumulate, wprev, wcur);
#pragma unroll
      for (int k = 0; k < DPT; ++k)
#pragma unroll
        for (int i = 0; i < 4; ++i) wprev[k][i] = wcur[k][i];
    }
  }
  // the vector past the last group: the tail of the last group's columns
  store_outputs<DPT, SX>(r, n_chunks * kGroups, N, D, lane, accumulate, wprev, wcur);
}

// Horizontal directions, step (SX, 0): the grid's warps take the rows in
// turn, warp w rows w, w + (warps in the grid), ...
template <typename T, int DPT, int SX>
__global__ void __launch_bounds__(32 * kColsRowsPerSm) sgm_cols_kernel(const PathArgs a) {
  const int lane = threadIdx.x & 31;
  const int warps = static_cast<int>(gridDim.x * (blockDim.x >> 5));
  for (int y = static_cast<int>(blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5)); y < a.S;
       y += warps)
    cols_row<T, DPT, SX>(a, y, lane);
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

// the current device's SM count, read once
cudaError_t sm_count(int& n) {
  static std::atomic<int> sms{0};
  n = sms.load(std::memory_order_relaxed);
  if (n) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) sms.store(n, std::memory_order_relaxed);
  return e;
}

// The horizontal kernel: kColsRowsPerSm rows resident on each SM, or
// fewer where the rows are few, spread over every SM (a block a SM).
template <typename T, int DPT>
cudaError_t launch_cols(const PathArgs& a, cudaStream_t stream) {
  int n = 0;
  const cudaError_t e = sm_count(n);
  if (e != cudaSuccess) return e;
  const int warps = a.S < n * kColsRowsPerSm ? a.S : n * kColsRowsPerSm;
  const int rows = (warps + n - 1) / n;
  const dim3 grid((warps + rows - 1) / rows);
  if (a.sx > 0) {
    sgm_cols_kernel<T, DPT, 1><<<grid, 32 * rows, 0, stream>>>(a);
  } else {
    sgm_cols_kernel<T, DPT, -1><<<grid, 32 * rows, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

// a segment (vertical or diagonal) through the row-stepped kernel's segment
// build; a whole-image direction through the row-stepped or the horizontal
// kernel
template <typename T, int DPT>
cudaError_t launch_typed(const PathArgs& a, bool segment, cudaStream_t stream) {
  if (segment) return launch_rows<T, DPT, true>(a, stream);
  if (a.sy != 0) return launch_rows<T, DPT, false>(a, stream);
  return launch_cols<T, DPT>(a, stream);
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
