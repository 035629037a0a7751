// C entry of the DTAM auxiliary-search kernel; the kernel, its note (the
// TPU kernel it replaces, its bound, its design) and its launcher are in
// wta_sq.cuh, which dtam.cu shares.
#include "wta_sq.cuh"

// vol (D, H, W) f32 or bf16, last and out (H, W) f32; lam and theta as
// given (1 / (2 theta) is taken on the card, a float32 division).
extern "C" int kt_wta_sq(const void* vol, int vol_is_bf16, const void* last, void* out, int D,
                         int H, int W, int sd, float lam, float theta, void* stream) {
  if (D < 1 || H < 1 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  wta_sq::launch(vol, vol_is_bf16 != 0, static_cast<const float*>(last),
                 static_cast<float*>(out), D, H, W, sd, lam, theta,
                 static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
