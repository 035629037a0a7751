// The DTAM auxiliary search: the device function and kernels shared by its
// own C entries (wta_sq.cu: kt_wta_sq, and kt_wta_sq_pixel, the design it
// replaced) and the whole-alternation entries (dtam.cu), which run the same
// search once per iteration.
//
// Replaces kangaroo_tpu/stereo/wta_pallas.py:_wta_sq_kernel (called through
// cost_vol_minimum_square_penalty_subpix there). Per pixel, with
// inv2theta = 1 / (2 theta) and last the current primal disparity:
//   cost(d) = inv2theta * ((last - d) * (last - d)) + lam * C(d)
// held at 1e10 where x + sd*d leaves the image; bestd is the first d
// attaining the minimum (NaN first, as torch.argmin takes it). The parabola
// runs through the penalised costs at bestd-1 and bestd+1, the volume read
// at the clamped index and the penalty at the unclamped one:
//   sub = bestd - (cr - cl) / (2 ((cr - 2 best) + cl)),
// kept where x + sd*bestd is strictly interior and bestd-1 < sub < bestd+1.
// The arithmetic is that of the plain version
// (stereo/costvolume.py:cost_vol_minimum_square_penalty_subpix) op for op:
// every product, sum and quotient is rounded on its own (__fmul_rn,
// __fadd_rn, __fdiv_rn), so nothing is contracted into an FMA the plain
// version lacks. This is the JAX package's XLA formulation; its Pallas
// body computes (inv2theta * dd) * dd, which rounds differently.
//
// What bounds it on the H100: bytes, closely followed by issue. One pass
// over the volume (bf16 or f32): at VGA/64 bf16 that is 39.3 MB, 11.7 us
// of HBM time. Each element costs about 12 instructions (the penalty's five
// roundings, two compares, four selects, the bf16 widening), half of them
// on the SM's 16-lane integer/select pipe: ~8 us of issue on 132 SMs, and
// more where too few warps hide the select chains' latency. So the loop
// body has to stay lean and the card full of warps, as well as keep loads
// in flight.
//
// Design (search_span; kernels wta_sq_span_kernel and dtam.cu's fused
// primal step): a thread owns a span of P = 4 consecutive pixels of the
// flattened (H*W) plane, one 8-byte (bf16) or 16-byte (f32) load a slice;
// the slice loop is unrolled by kUnroll = 8 with the next group's loads
// issued before the current group is reduced, so 8-16 loads a thread are
// in flight (the one-thread-per-pixel design kept one 2-byte load in
// flight). 8 bf16 pixels a thread (16-byte loads) measured slower on the
// H100: half the warps, too few to hide the select chains. Loads are as
// wide as the volume's base and plane stride allow (16, 8 or 4 bytes, else
// one element: a view at an odd offset): the entry picks the instance from
// the pointer and H*W, and a whole-span load never straddles the plane's
// end, since the last spans are moved back to end there. The lattice test
// is hoisted: a pixel's valid slices are a prefix [0, n) (d = 0 is always
// valid), so groups below the warp's smallest n run unmasked and only the
// rest compare d with n; the 1e10 tail keeps both of its effects (it wins
// when every valid cost exceeds 1e10, and its first slice can be
// C(bestd+1)). The parabola's neighbours are tracked in the same pass: on
// a new best, C(bestd-1) is the previous slice and C(bestd+1) the next one,
// both already in registers inside a group (across a group edge a flag
// carries the pending right neighbour, and a best at D-1 reads its own
// slice).
//
// The design it replaced (wta_sq_kernel, kept for the card checks): one
// thread per pixel, consecutive x on consecutive threads, the loop over d
// sequential inside the thread, one 2- or 4-byte load a slice.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace wta_sq {
// internal linkage: each source that includes this header has its own copy
namespace {

constexpr float kBig = 1e10f;

// inv2theta * ((last - d)^2) + lam * c, each operation rounded on its own
__device__ __forceinline__ float penalised(float last, float d, float c, float lam,
                                          float inv2theta) {
  const float e = __fsub_rn(last, d);
  return __fadd_rn(__fmul_rn(inv2theta, __fmul_rn(e, e)), __fmul_rn(lam, c));
}

// 1 / (2 theta) as the plain version takes it, a float32 division
__device__ __forceinline__ float inv_two_theta(float theta) {
  return __fdiv_rn(1.f, __fmul_rn(2.f, theta));
}

// the parabola step and the interior and sensible tests, from the best
// (bestd, best) and the volume at its clamped neighbours (vl, vr)
__device__ __forceinline__ float refine(float last, float best, int bestd, float vl, float vr,
                                        int x, int W, int sd, float lam, float inv2theta) {
  const float bf = static_cast<float>(bestd);
  const float dlf = bf - 1.f, drf = bf + 1.f;  // exact
  const float cl = penalised(last, dlf, vl, lam, inv2theta);
  const float cr = penalised(last, drf, vr, lam, inv2theta);
  const float denom = __fmul_rn(2.f, __fadd_rn(__fsub_rn(cr, __fmul_rn(2.f, best)), cl));
  const float sub = __fsub_rn(bf, __fdiv_rn(__fsub_rn(cr, cl), denom));
  const int best_xr = x + sd * bestd;
  const bool interior = best_xr > 0 && best_xr < W - 1;
  const bool sensible = sub > dlf && sub < drf;
  return interior && sensible ? sub : bf;
}

// --- the design it replaced: one thread per pixel ---------------------------

constexpr int kThreads = 128;

__device__ __forceinline__ float load_cost(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float load_cost(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}

// The search for the pixel at flat index p (column x) of a (D, H*W) volume.
template <typename T>
__device__ __forceinline__ float search(const T* __restrict__ vol, size_t HW, size_t p, int x,
                                        int W, int D, int sd, float last, float lam,
                                        float inv2theta) {
  float best = 0.f, vl = 0.f, vr = 0.f, cprev = 0.f;
  int bestd = 0;
  for (int d = 0; d < D; ++d) {
    const float c = load_cost(vol, static_cast<size_t>(d) * HW + p);
    const int xr = x + sd * d;
    const float v =
        (xr >= 0 && xr < W) ? penalised(last, static_cast<float>(d), c, lam, inv2theta) : kBig;
    if (d == bestd + 1) vr = c;  // the slice after the best so far
    // strict: the first index attaining the min; a NaN wins over a number
    if (d == 0 || v < best || (v != v && best == best)) {
      best = v;
      bestd = d;
      vl = d > 0 ? cprev : c;  // C(clamp(bestd - 1, 0))
    }
    cprev = c;
  }
  if (bestd == D - 1) vr = cprev;  // C(clamp(bestd + 1, D - 1))
  return refine(last, best, bestd, vl, vr, x, W, sd, lam, inv2theta);
}

// out[y, x] = the search at (y, x) with last = last[y, x]. out may alias
// last: each thread reads its own pixel before writing it.
template <typename T>
__global__ void wta_sq_kernel(const T* __restrict__ vol, const float* last, float* out, int D,
                              int H, int W, int sd, float lam, float theta) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= W) return;
  const size_t p = static_cast<size_t>(y) * W + x;
  const float inv2theta = inv_two_theta(theta);
  out[p] = search(vol, static_cast<size_t>(H) * W, p, x, W, D, sd, last[p], lam, inv2theta);
}

inline void launch_pixel(const void* vol, bool vol_is_bf16, const float* last, float* out, int D,
                         int H, int W, int sd, float lam, float theta, cudaStream_t s) {
  const dim3 grid((W + kThreads - 1) / kThreads, H);
  if (vol_is_bf16)
    wta_sq_kernel<<<grid, kThreads, 0, s>>>(static_cast<const __nv_bfloat16*>(vol), last, out,
                                             D, H, W, sd, lam, theta);
  else
    wta_sq_kernel<<<grid, kThreads, 0, s>>>(static_cast<const float*>(vol), last, out, D, H,
                                             W, sd, lam, theta);
}

// --- the design: P pixels a thread, wide loads -----------------------------

// 64 threads a block: at VGA/64, 1,200 blocks on 132 SMs, 9-10 a SM
constexpr int kSpanThreads = 64;
constexpr int kUnroll = 8;  // slices a group

// pixels a thread (its span): 8 bytes of a bf16 slice, 16 of an f32 one
constexpr int kPixels = 4;

// a span's values of one slice, as 32-bit words
template <typename T>
struct Slice {
  static constexpr int kWords = (kPixels * static_cast<int>(sizeof(T)) + 3) / 4;
  uint32_t w[kWords];
};

// the k-th value of T in a slice, widened to float32 (for bf16 the bits
// shifted up, which is what __bfloat162float does)
__device__ __forceinline__ float value(const Slice<float>& s, int k) {
  return __uint_as_float(s.w[k]);
}
__device__ __forceinline__ float value(const Slice<__nv_bfloat16>& s, int k) {
  const uint32_t u = s.w[k >> 1];
  return __uint_as_float((k & 1) ? (u & 0xffff0000u) : (u << 16));
}

// one load of G bytes at p (G-aligned), into words
template <int G>
__device__ __forceinline__ void load_bytes(const void* p, uint32_t* w) {
  if constexpr (G == 16) {
    const uint4 v = __ldg(static_cast<const uint4*>(p));
    w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
  } else if constexpr (G == 8) {
    const uint2 v = __ldg(static_cast<const uint2*>(p));
    w[0] = v.x, w[1] = v.y;
  } else {
    w[0] = __ldg(static_cast<const unsigned int*>(p));
  }
}

__device__ __forceinline__ uint32_t element_bits(const float* p) {
  return __float_as_uint(__ldg(p));
}
__device__ __forceinline__ uint32_t element_bits(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned short*>(p));
}

// The span's values of a plane of T from flat index p0. G is the widest
// load the volume's base and plane stride allow: 16, 8 or 4 bytes take
// whole spans (every thread has one: see Span), one element (G =
// sizeof(T)) takes the first `count` values, 0 past them.
template <typename T, int G>
__device__ __forceinline__ Slice<T> load_slice(const T* plane, size_t p0, int count) {
  constexpr int P = kPixels;
  static_assert(G <= P * static_cast<int>(sizeof(T)), "a load wider than the span");
  Slice<T> s;
  if constexpr (G > static_cast<int>(sizeof(T))) {
    const char* base = reinterpret_cast<const char*>(plane + p0);
#pragma unroll
    for (int c = 0; c < P * static_cast<int>(sizeof(T)) / G; ++c)
      load_bytes<G>(base + c * G, s.w + c * G / 4);
  } else {
    uint32_t v[P];
#pragma unroll
    for (int k = 0; k < P; ++k) v[k] = k < count ? element_bits(plane + p0 + k) : 0u;
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int k = 0; k < P; ++k) s.w[k] = v[k];
    } else {
#pragma unroll
      for (int j = 0; j < P / 2; ++j) s.w[j] = v[2 * j] | (v[2 * j + 1] << 16);
    }
  }
  return s;
}

// the column of pixel k of a span whose first pixel is at column x0
__device__ __forceinline__ int column(int x0, int k, int W) {
  int x = x0 + k;
  while (x >= W) x -= W;
  return x;
}

// a pixel's valid slices: x + sd*d in [0, W) for d in [0, n)
__device__ __forceinline__ int valid_prefix(int x, int W, int D, int sd) {
  const int n = sd > 0 ? (W - 1 - x) / sd + 1 : sd < 0 ? x / (-sd) + 1 : D;
  return n < D ? n : D;
}

// the running state of a thread's P searches
template <int P>
struct State {
  float last[P], best[P], vl[P], vr[P], cprev[P];
  int bestd[P], n[P];
  bool pending[P];  // the best is the last slice seen: C(bestd+1) is the next one
};

// one group of kUnroll slices from d0; kFirst: d0 = 0, whose slice is the
// first best; kMasked: compare d with each pixel's valid prefix
template <bool kMasked, bool kFirst, typename T, int P>
__device__ __forceinline__ void group(State<P>& s, const Slice<T> (&raw)[kUnroll], int d0,
                                      float lam, float inv2theta) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int d = d0 + u;
    const float df = static_cast<float>(d);
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const float c = value(raw[u], k);
      float v = penalised(s.last[k], df, c, lam, inv2theta);
      if (kMasked) v = d < s.n[k] ? v : kBig;
      const bool first = kFirst && u == 0;
      if (u == 0 && !first) s.vr[k] = s.pending[k] ? c : s.vr[k];
      // the first index attaining the min; a NaN wins over a number. Equal
      // to v < best || (v != v && best == best) in two compares
      const bool take = first || (!(v >= s.best[k]) && s.best[k] == s.best[k]);
      s.best[k] = take ? v : s.best[k];
      s.bestd[k] = take ? d : s.bestd[k];
      const float left = first ? c : u == 0 ? s.cprev[k] : value(raw[u > 0 ? u - 1 : 0], k);
      s.vl[k] = take ? left : s.vl[k];
      if (u + 1 < kUnroll)
        s.vr[k] = take ? value(raw[u + 1 < kUnroll ? u + 1 : u], k) : s.vr[k];
      else
        s.pending[k] = take;
    }
  }
#pragma unroll
  for (int k = 0; k < P; ++k) s.cprev[k] = value(raw[kUnroll - 1], k);
}

// one slice d, masked, d = 0 included (D < kUnroll, or the slices after
// the last whole group)
template <typename T, int P>
__device__ __forceinline__ void single(State<P>& s, const Slice<T>& raw, int d, float lam,
                                       float inv2theta) {
  const float df = static_cast<float>(d);
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const float c = value(raw, k);
    const float pen = penalised(s.last[k], df, c, lam, inv2theta);
    const float v = d < s.n[k] ? pen : kBig;
    if (d == 0) {
      s.best[k] = v;
      s.bestd[k] = 0;
      s.vl[k] = c;
      s.pending[k] = true;
    } else {
      s.vr[k] = s.pending[k] ? c : s.vr[k];
      const bool take = !(v >= s.best[k]) && s.best[k] == s.best[k];
      s.best[k] = take ? v : s.best[k];
      s.bestd[k] = take ? d : s.bestd[k];
      s.vl[k] = take ? s.cprev[k] : s.vl[k];
      s.pending[k] = take;
    }
    s.cprev[k] = c;
  }
}

template <typename T, int G>
__device__ __forceinline__ void load_group(Slice<T> (&raw)[kUnroll], const T* vol, size_t HW,
                                           size_t p0, int count, int d0) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u)
    raw[u] = load_slice<T, G>(vol + static_cast<size_t>(d0 + u) * HW, p0, count);
}

// The searches of the P = kPixels pixels p0 .. p0+P-1 of a (D, H*W)
// volume, the first `count` of them real, each from last[k]; writes out[k].
// Every thread of the warp must call it (the warp agrees on the masked
// groups); with element loads a thread with count = 0 loads nothing.
template <typename T, int G>
__device__ __forceinline__ void search_span(const T* __restrict__ vol, size_t HW, size_t p0,
                                            int count, int W, int D, int sd, float lam,
                                            float inv2theta, const float* last, float* out) {
  constexpr int P = kPixels;
  State<P> s;
  const int x0 = static_cast<int>(p0 % W);
  int nmin = D;
#pragma unroll
  for (int k = 0; k < P; ++k) {
    s.last[k] = last[k];
    s.n[k] = k < count ? valid_prefix(column(x0, k, W), W, D, sd) : D;
    nmin = min(nmin, s.n[k]);
  }
  // groups below every lane's valid prefix run unmasked
  nmin = __reduce_min_sync(0xffffffffu, nmin);
  int d = 0;
  if (D >= kUnroll) {
    Slice<T> raw[kUnroll], next[kUnroll];
    load_group<T, G>(raw, vol, HW, p0, count, 0);
    if (D >= 2 * kUnroll) load_group<T, G>(next, vol, HW, p0, count, kUnroll);
    if (kUnroll <= nmin)
      group<false, true>(s, raw, 0, lam, inv2theta);
    else
      group<true, true>(s, raw, 0, lam, inv2theta);
    for (d = kUnroll; d + kUnroll <= D; d += kUnroll) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) raw[u] = next[u];
      // the next group's loads go out before this group is reduced
      if (d + 2 * kUnroll <= D) load_group<T, G>(next, vol, HW, p0, count, d + kUnroll);
      if (d + kUnroll <= nmin)
        group<false, false>(s, raw, d, lam, inv2theta);
      else
        group<true, false>(s, raw, d, lam, inv2theta);
    }
  }
  for (; d < D; ++d)
    single(s, load_slice<T, G>(vol + static_cast<size_t>(d) * HW, p0, count), d, lam,
           inv2theta);
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const float vr = s.pending[k] ? s.cprev[k] : s.vr[k];  // C(clamp(bestd + 1, D - 1))
    out[k] = refine(s.last[k], s.best[k], s.bestd[k], s.vl[k], vr, column(x0, k, W), W, sd,
                    lam, inv2theta);
  }
}

// The pixels a thread computes, p0 .. p0+P-1 with the first `count` real,
// and those it owns (writes), k in [lo, count). With whole-span loads (G
// wider than one element) every thread loads a whole span inside the
// plane: the last spans are moved back to end at H*W, owning only the
// pixels no earlier thread owns (none past H*W). With element loads a
// thread's span starts at its own pixels and may be short.
struct Span {
  size_t p0;
  int count, lo;
};

template <typename T, int G>
__device__ __forceinline__ Span span_of_thread(size_t HW) {
  constexpr int P = kPixels;
  const size_t own = (static_cast<size_t>(blockIdx.x) * kSpanThreads + threadIdx.x) * P;
  if constexpr (G > static_cast<int>(sizeof(T))) {
    const size_t last = HW - P;  // H*W >= P on this path
    if (own <= last) return {own, P, 0};
    return {last, P, own >= HW ? P : static_cast<int>(own - last)};
  } else {
    const size_t left = own >= HW ? 0 : HW - own;
    return {own, left < static_cast<size_t>(P) ? static_cast<int>(left) : P, 0};
  }
}

// the span's float32 values of an (H, W) plane at the pixels the thread
// owns (0 elsewhere); coherent loads (the fused DTAM step writes planes it
// reads, each thread only its own pixels)
template <int P>
__device__ __forceinline__ void load_floats(const float* plane, const Span& sp, float (&v)[P]) {
#pragma unroll
  for (int k = 0; k < P; ++k) v[k] = k >= sp.lo && k < sp.count ? plane[sp.p0 + k] : 0.f;
}

template <int P>
__device__ __forceinline__ void store_floats(float* plane, const Span& sp, const float (&v)[P]) {
#pragma unroll
  for (int k = 0; k < P; ++k)
    if (k >= sp.lo && k < sp.count) plane[sp.p0 + k] = v[k];
}

// blocks of a span kernel over H*W pixels
inline unsigned span_blocks(size_t HW, int P) {
  const size_t threads = (HW + P - 1) / P;
  return static_cast<unsigned>((threads + kSpanThreads - 1) / kSpanThreads);
}

// out = the search with last; out may alias last: a thread reads all its
// last values before it writes any output
template <typename T, int G>
__global__ void __launch_bounds__(kSpanThreads)
    wta_sq_span_kernel(const T* __restrict__ vol, const float* last, float* out, int D, int H,
                       int W, int sd, float lam, float theta) {
  constexpr int P = kPixels;
  const size_t HW = static_cast<size_t>(H) * W;
  const Span sp = span_of_thread<T, G>(HW);
  float l[P], o[P];
  load_floats(last, sp, l);
  search_span<T, G>(vol, HW, sp.p0, sp.count, W, D, sd, lam, inv_two_theta(theta), l, o);
  store_floats(out, sp, o);
}

// the widest load of a span of T: its bytes, at most 16
template <typename T>
constexpr int kMaxWidth = kPixels * static_cast<int>(sizeof(T)) < 16
                              ? kPixels * static_cast<int>(sizeof(T)) : 16;

// The widest load (bytes) of a span that the volume's base and plane
// stride allow: kMaxWidth, half of it, ..., down to one element (also
// where H*W is under a span).
inline int load_width(const void* vol, bool vol_is_bf16, size_t HW) {
  const int elem = vol_is_bf16 ? 2 : 4;
  const uintptr_t both = reinterpret_cast<uintptr_t>(vol) | (HW * elem);
  if (HW < static_cast<size_t>(kPixels)) return elem;
  int g = vol_is_bf16 ? kMaxWidth<__nv_bfloat16> : kMaxWidth<float>;
  while (g > elem && both % g != 0) g /= 2;
  return g;
}

// &K<T, G>::run for the widest G <= width: the instances of a span
// kernel's launcher, from kMaxWidth<T> down to one element
template <template <typename, int> class K, typename T, int G = kMaxWidth<T>>
auto instance(int width) -> decltype(&K<T, G>::run) {
  if constexpr (G > static_cast<int>(sizeof(T)))
    if (width < G) return instance<K, T, G / 2>(width);
  return &K<T, G>::run;
}

}  // namespace
}  // namespace wta_sq
