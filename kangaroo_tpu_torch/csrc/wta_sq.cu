// C entries of the DTAM auxiliary search; the kernels and their note (the
// TPU kernel they replace, the bound, the design) are in wta_sq.cuh, which
// dtam.cu shares.
#include "wta_sq.cuh"

namespace {

bool bad_sizes(int D, int H, int W) { return D < 1 || H < 1 || W < 1; }

template <typename T, int G>
struct SpanSearch {
  static void run(const void* vol, const float* last, float* out, int D, int H, int W, int sd,
                  float lam, float theta, cudaStream_t s) {
    const size_t HW = static_cast<size_t>(H) * W;
    wta_sq::wta_sq_span_kernel<T, G>
        <<<wta_sq::span_blocks(HW, wta_sq::kPixels), wta_sq::kSpanThreads, 0, s>>>(
            static_cast<const T*>(vol), last, out, D, H, W, sd, lam, theta);
  }
};

// the search on spans: the instance for the volume's type and load width
void launch_span(const void* vol, bool vol_is_bf16, const float* last, float* out, int D,
                        int H, int W, int sd, float lam, float theta, cudaStream_t s) {
  const size_t HW = static_cast<size_t>(H) * W;
  const int width = wta_sq::load_width(vol, vol_is_bf16, HW);
  (vol_is_bf16 ? wta_sq::instance<SpanSearch, __nv_bfloat16>(width)
               : wta_sq::instance<SpanSearch, float>(width))(
      vol, last, out, D, H, W, sd, lam, theta, s);
}

}  // namespace

// vol (D, H, W) f32 or bf16, last and out (H, W) f32; lam and theta as
// given (1 / (2 theta) is taken on the card, a float32 division). The
// search on spans of pixels (wta_sq_span_kernel).
extern "C" int kt_wta_sq(const void* vol, int vol_is_bf16, const void* last, void* out, int D,
                         int H, int W, int sd, float lam, float theta, void* stream) {
  if (bad_sizes(D, H, W)) return static_cast<int>(cudaErrorInvalidValue);
  launch_span(vol, vol_is_bf16 != 0, static_cast<const float*>(last), static_cast<float*>(out),
              D, H, W, sd, lam, theta, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// kt_wta_sq's arguments and result through the replaced design, one
// thread per pixel (wta_sq_kernel). Launched only by the card checks.
extern "C" int kt_wta_sq_pixel(const void* vol, int vol_is_bf16, const void* last, void* out,
                               int D, int H, int W, int sd, float lam, float theta,
                               void* stream) {
  if (bad_sizes(D, H, W)) return static_cast<int>(cudaErrorInvalidValue);
  wta_sq::launch_pixel(vol, vol_is_bf16 != 0, static_cast<const float*>(last),
                       static_cast<float*>(out), D, H, W, sd, lam, theta,
                       static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
