// Shared by the DCNv2 forward (deform_fwd.cu) and backward (deform_bwd.cu)
// kernels: the element conversions and the per-(pixel, tap) sampling fields,
// so both directions sample at exactly the same corners with the same
// weights. The plain PyTorch version of these fields is
// `_sample_fields` in mgdt_yolo_tpu_torch/ops/deform.py.
//
// utils/build.py hashes this header into every kernel's build digest, so an
// edit here rebuilds both libraries.
#pragma once

#include <cuda_bf16.h>

namespace deform {

constexpr int KT = 9;  // 3x3 taps

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// v rounded to T's precision and widened back to float
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// Where tap k of output pixel (i, j) samples, for offsets (oy, ox).
struct Tap {
  int y0, x0;          // top-left bilinear corner (may lie outside the image)
  float fy, fx;        // weights toward row y0 + 1 and column x0 + 1
  bool valid;          // the unclamped position is inside (-1, H) x (-1, W)
  bool pass_y, pass_x; // d fy / d oy = 1 (windowed: the fraction was not clipped)
};

// windowed: floor and fraction are taken in the window-relative coordinate
// r = t + off + 2 (window of pixel i starts at row i - 3), the floor clamped
// per tap to [t, t + 4] and the fraction clipped to [0, 1]; exact: an
// unbounded bilinear sample at i - 1 + ty + oy.
__device__ __forceinline__ Tap tap_fields(int i, int j, int k, float oy, float ox,
                                          int H, int W, int windowed) {
  const int ty = k / 3, tx = k % 3;
  const float py = (float)(i - 1 + ty) + oy;
  const float px = (float)(j - 1 + tx) + ox;
  Tap t;
  t.valid = py > -1.f && py < (float)H && px > -1.f && px < (float)W;
  if (windowed) {
    const float ry = ((float)ty + oy) + 2.f;
    const float rx = ((float)tx + ox) + 2.f;
    const float ry0 = fminf(fmaxf(floorf(ry), (float)ty), (float)ty + 4.f);
    const float rx0 = fminf(fmaxf(floorf(rx), (float)tx), (float)tx + 4.f);
    const float fy = ry - ry0, fx = rx - rx0;
    t.pass_y = fy >= 0.f && fy <= 1.f;
    t.pass_x = fx >= 0.f && fx <= 1.f;
    t.fy = fminf(fmaxf(fy, 0.f), 1.f);
    t.fx = fminf(fmaxf(fx, 0.f), 1.f);
    t.y0 = (int)ry0 + i - 3;
    t.x0 = (int)rx0 + j - 3;
  } else {
    const float y0 = floorf(py), x0 = floorf(px);
    t.fy = py - y0;
    t.fx = px - x0;
    t.pass_y = t.pass_x = true;
    t.y0 = (int)y0;
    t.x0 = (int)x0;
  }
  return t;
}

}  // namespace deform
