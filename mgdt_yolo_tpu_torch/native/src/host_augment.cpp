// The host augmentation pipeline's hot loops in C++: the bilinear sampling
// of the warps, the HSV jitter and the median filter of
// `mgdt_yolo_tpu_torch/data/imgproc.py`, each the numpy function's
// arithmetic step for step, so its output is that function's bit for bit
// (`tests/test_torch_imgproc.py` holds them so):
//
// * a float32 multiply-add `a * b + c` is taken as numpy takes it there:
//   the operands widened to double, the product and the sum in double,
//   the sum rounded once to float32 (`fma_f32`); every other operation is
//   the float32 or integer one numpy performs. The build turns floating
//   point contraction off (`-ffp-contract=off`), so the compiler fuses
//   nothing numpy does not;
// * rounding to an integer is to nearest, ties to even (`std::nearbyint`
//   in the default rounding mode, numpy's `rint`), truncation is `trunc`.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -ffp-contract=off host_augment.cpp
//        (see mgdt_yolo_tpu_torch/utils/build.py, which builds it at first use).

#include <algorithm>
#include <cmath>
#include <cstdint>

extern "C" {

static inline float fma_f32(float a, float b, float c) {
  return static_cast<float>(static_cast<double>(a) * static_cast<double>(b) +
                            static_cast<double>(c));
}

static inline uint8_t round_u8(float v) {
  float r = std::nearbyint(v);
  return static_cast<uint8_t>(r < 0.f ? 0.f : (r > 255.f ? 255.f : r));
}

// imgproc._sample: `src` (H, W, C) uint8, the source coordinates `sx`, `sy`
// (n float32 each), into `dst` (n, C); a tap outside the image takes
// `border` (C values).
void mgdt_sample(const uint8_t* src, int H, int W, int C, const float* sx, const float* sy,
                 int64_t n, const uint8_t* border, uint8_t* dst) {
  for (int64_t i = 0; i < n; ++i) {
    float fx = std::floor(sx[i]), fy = std::floor(sy[i]);
    float ax = sx[i] - fx, ay = sy[i] - fy;
    int ix = static_cast<int>(std::min(std::max(fx, -2.f), static_cast<float>(W)));
    int iy = static_cast<int>(std::min(std::max(fy, -2.f), static_cast<float>(H)));
    bool in_x0 = ix >= 0 && ix < W, in_x1 = ix + 1 >= 0 && ix + 1 < W;
    bool in_y0 = iy >= 0 && iy < H, in_y1 = iy + 1 >= 0 && iy + 1 < H;
    const uint8_t* r0 = in_y0 ? src + static_cast<int64_t>(iy) * W * C : border;
    const uint8_t* r1 = in_y1 ? src + static_cast<int64_t>(iy + 1) * W * C : border;
    for (int c = 0; c < C; ++c) {
      float p00 = (in_y0 && in_x0) ? r0[ix * C + c] : border[c];
      float p01 = (in_y0 && in_x1) ? r0[(ix + 1) * C + c] : border[c];
      float p10 = (in_y1 && in_x0) ? r1[ix * C + c] : border[c];
      float p11 = (in_y1 && in_x1) ? r1[(ix + 1) * C + c] : border[c];
      float a = fma_f32(ax, p01 - p00, p00);
      float b = fma_f32(ax, p11 - p10, p10);
      dst[i * C + c] = round_u8(fma_f32(ay, b - a, a));
    }
  }
}

// imgproc.hsv_luts: each BGR pixel of `src` (n, 3) to HSV
// (bgr_to_hsv, cv2's 12-bit fixed point), through the three LUTs, and back
// to BGR (hsv_to_bgr, cv2's float32 vector code), into `dst` (n, 3).
void mgdt_hsv_luts(const uint8_t* src, int64_t n, const uint8_t* lut_h, const uint8_t* lut_s,
                   const uint8_t* lut_v, const int32_t* sdiv, const int32_t* hdiv,
                   uint8_t* dst) {
  static const int sectors[6][3] = {{1, 3, 0}, {1, 0, 2}, {3, 0, 1},
                                    {0, 2, 1}, {0, 1, 3}, {2, 1, 0}};
  for (int64_t i = 0; i < n; ++i) {
    int b = src[3 * i], g = src[3 * i + 1], r = src[3 * i + 2];
    int v = std::max(std::max(b, g), r);
    int diff = v - std::min(std::min(b, g), r);
    int s = (diff * sdiv[v] + (1 << 11)) >> 12;
    int h = v == r ? g - b : (v == g ? b - r + 2 * diff : r - g + 4 * diff);
    h = (h * hdiv[diff] + (1 << 11)) >> 12;
    h += h < 0 ? 180 : 0;
    // the LUTs, then hsv_to_bgr
    float hf = static_cast<float>(lut_h[h]) * static_cast<float>(6.0 / 180);
    float sf = static_cast<float>(lut_s[s]) * static_cast<float>(1.0 / 255);
    float vf = static_cast<float>(lut_v[v]) * static_cast<float>(1.0 / 255);
    float pre = std::trunc(hf);
    hf = hf - pre;
    float tab[4] = {vf, vf * (1.f - sf), vf * fma_f32(-sf, hf, 1.f),
                    vf * fma_f32(-sf, 1.f - hf, 1.f)};
    int sector = static_cast<int>(fma_f32(-std::trunc(pre * static_cast<float>(1.0 / 6)), 6.f,
                                          pre));
    sector = std::min(std::max(sector, 0), 5);
    for (int c = 0; c < 3; ++c) {
      float o = sf == 0.f ? vf : tab[sectors[sector][c]];
      float t = std::trunc(o * 255.f);
      dst[3 * i + c] = static_cast<uint8_t>(t < 0.f ? 0.f : (t > 255.f ? 255.f : t));
    }
  }
}

// imgproc.median_blur: the median of each k x k window of `src` (H, W, C),
// the edge pixels replicated, into `dst`: a histogram of the window slid
// along each row (one column out, one in), its median moved from the last.
void mgdt_median(const uint8_t* src, int H, int W, int C, int k, uint8_t* dst) {
  const int p = k / 2, half = k * k / 2;
  auto at = [&](int y, int x, int c) {
    y = std::min(std::max(y, 0), H - 1);
    x = std::min(std::max(x, 0), W - 1);
    return src[(static_cast<int64_t>(y) * W + x) * C + c];
  };
  for (int c = 0; c < C; ++c) {
    for (int y = 0; y < H; ++y) {
      int hist[256] = {0};
      for (int dy = -p; dy <= p; ++dy)
        for (int dx = -p; dx <= p; ++dx) ++hist[at(y + dy, dx, c)];
      int med = 0, below = 0;  // below: the window's values under med
      for (int x = 0; x < W; ++x) {
        if (x > 0) {
          for (int dy = -p; dy <= p; ++dy) {
            const int out = at(y + dy, x - 1 - p, c), in = at(y + dy, x + p, c);
            --hist[out];
            below -= out < med;
            ++hist[in];
            below += in < med;
          }
        }
        while (below > half) below -= hist[--med];
        while (below + hist[med] <= half) below += hist[med++];
        dst[(static_cast<int64_t>(y) * W + x) * C + c] = static_cast<uint8_t>(med);
      }
    }
  }
}

}  // extern "C"
