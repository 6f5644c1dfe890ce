// cv2's BGR of a decoded 4:2:0 video frame. cv2.VideoCapture converts each
// `yuv420p` frame ffmpeg decodes to BGR24 with swscale (SWS_BICUBIC, the
// same size): for an even height swscale takes its unscaled YUV-to-RGB
// path, whose x86 code (used wherever the CPU has SSSE3) works in 16-bit
// lanes: each term (Y - 16, U - 128, V - 128, scaled by 8) times its BT.601
// limited-range coefficient keeps the product's high 16 bits (pmulhw), the
// terms are added and the sum saturated to 0..255; two pixels of a row and
// two rows share a chroma sample. The coefficients are swscale's, from its
// inverse table {104597, 132201, 25675, 53279} (16.16) and luma gain
// 255/219, rounded to 13 fraction bits. Here the chroma terms come from
// tables by their 8-bit sample, and a row runs 16 pixels at a time in that
// arithmetic where the CPU has SSSE3, else by tables (the two give the same
// bits: `tests/test_torch_video_codecs.py` holds them to each other). (cv2's writer makes even sizes only; a stream of odd
// height from another encoder is converted the same way here, where
// swscale takes its scaler instead: ROADMAP queue 3, known differences.)
#pragma once

#include <algorithm>
#include <cstdint>
#include <vector>
#if defined(__x86_64__) || defined(__i386__)
#include <tmmintrin.h>
#endif

#include "host_codecs.h"

namespace mgdt_codec {

namespace yuv {
constexpr int Y_COEFF = 9539, VR = 13075, UB = 16525, UG = -3209, VG = -6660;
inline int mulhi(int a, int c) { return (a * c) >> 16; }

// each term by its 8-bit sample, and the saturation to 0..255 of a sum of
// them (-300..600 covers every sum)
struct Tables {
  int16_t y[256], ub[256], ug[256], vg[256], vr[256];
  uint8_t sat[1024];
  Tables() {
    for (int i = 0; i < 256; i++) {
      const int c = (i << 3) - 1024;
      y[i] = (int16_t)mulhi((i << 3) - 128, Y_COEFF);
      ub[i] = (int16_t)mulhi(c, UB);
      ug[i] = (int16_t)mulhi(c, UG);
      vg[i] = (int16_t)mulhi(c, VG);
      vr[i] = (int16_t)mulhi(c, VR);
    }
    for (int i = 0; i < 1024; i++) sat[i] = (uint8_t)std::min(std::max(i - 384, 0), 255);
  }
};
inline const Tables& tables() {
  static const Tables t;
  return t;
}
}  // namespace yuv

// Pixels x0..w-1 of a row from its chroma row's terms (cb, cg, cr: blue,
// green and red by chroma sample) and the luma table.
inline void row_scalar(const uint8_t* py, const int16_t* cb, const int16_t* cg,
                       const int16_t* cr, int x0, int w, uint8_t* bgr) {
  const yuv::Tables& t = yuv::tables();
  const uint8_t* sat = t.sat + 384;
  uint8_t* o = bgr + 3 * x0;
  int x = x0;
  for (; x + 1 < w; x += 2, o += 6) {  // the two pixels of a chroma sample
    const int c = x >> 1, y0 = t.y[py[x]], y1 = t.y[py[x + 1]];
    o[0] = sat[y0 + cb[c]];
    o[1] = sat[y0 + cg[c]];
    o[2] = sat[y0 + cr[c]];
    o[3] = sat[y1 + cb[c]];
    o[4] = sat[y1 + cg[c]];
    o[5] = sat[y1 + cr[c]];
  }
  if (x < w) {  // an odd width's last pixel
    const int y0 = t.y[py[x]];
    o[0] = sat[y0 + cb[x >> 1]];
    o[1] = sat[y0 + cg[x >> 1]];
    o[2] = sat[y0 + cr[x >> 1]];
  }
}

#if defined(__x86_64__) || defined(__i386__)
// The same, 16 pixels at a time in 16-bit lanes as swscale's x86 code runs
// it (pmulhw, saturating adds, packuswb), where the CPU has SSSE3 (its byte
// shuffle interleaves B, G and R); returns how many pixels it wrote.
__attribute__((target("ssse3"))) inline int row_ssse3(const uint8_t* py, const int16_t* cb,
                                                      const int16_t* cg, const int16_t* cr,
                                                      int w, uint8_t* bgr) {
  struct Masks {  // output byte k of 48 takes pixel k / 3 of channel k % 3
    alignas(16) uint8_t m[3][3][16];
    Masks() {
      for (int j = 0; j < 3; j++)
        for (int c = 0; c < 3; c++)
          for (int i = 0; i < 16; i++) {
            const int k = 16 * j + i;
            m[j][c][i] = (uint8_t)(k % 3 == c ? k / 3 : 0x80);
          }
    }
  };
  static const Masks masks;
  const __m128i yoff = _mm_set1_epi16(128), yc = _mm_set1_epi16(yuv::Y_COEFF);
  const __m128i zero = _mm_setzero_si128();
  int x = 0;
  for (; x + 16 <= w; x += 16) {
    const __m128i yv = _mm_loadu_si128((const __m128i*)(py + x));
    const __m128i ylo = _mm_mulhi_epi16(
        _mm_sub_epi16(_mm_slli_epi16(_mm_unpacklo_epi8(yv, zero), 3), yoff), yc);
    const __m128i yhi = _mm_mulhi_epi16(
        _mm_sub_epi16(_mm_slli_epi16(_mm_unpackhi_epi8(yv, zero), 3), yoff), yc);
    __m128i ch[3];
    const int16_t* terms[3] = {cb, cg, cr};
    for (int c = 0; c < 3; c++) {
      const __m128i t = _mm_loadu_si128((const __m128i*)(terms[c] + x / 2));
      ch[c] = _mm_packus_epi16(_mm_adds_epi16(ylo, _mm_unpacklo_epi16(t, t)),
                               _mm_adds_epi16(yhi, _mm_unpackhi_epi16(t, t)));
    }
    for (int j = 0; j < 3; j++) {
      __m128i out = zero;
      for (int c = 0; c < 3; c++)
        out = _mm_or_si128(out, _mm_shuffle_epi8(
                                    ch[c], _mm_load_si128((const __m128i*)masks.m[j][c])));
      _mm_storeu_si128((__m128i*)(bgr + 3 * x + 16 * j), out);
    }
  }
  return x;
}

inline bool has_ssse3() {
  static const bool yes = __builtin_cpu_supports("ssse3");
  return yes;
}
#endif

inline void yuv420_to_bgr(const Picture& p, uint8_t* bgr) {
  const yuv::Tables& t = yuv::tables();
  const int cw = (p.w + 1) / 2;
  std::vector<int16_t> cb(cw + 8), cg(cw + 8), cr(cw + 8);  // a chroma row's terms
  for (int y = 0; y < p.h; y++) {
    if (!(y & 1)) {
      const uint8_t* pu = p.u + (ptrdiff_t)(y >> 1) * p.cstride;
      const uint8_t* pv = p.v + (ptrdiff_t)(y >> 1) * p.cstride;
      for (int c = 0; c < cw; c++) {
        cb[c] = t.ub[pu[c]];
        cg[c] = (int16_t)(t.ug[pu[c]] + t.vg[pv[c]]);
        cr[c] = t.vr[pv[c]];
      }
    }
    const uint8_t* py = p.y + (ptrdiff_t)y * p.stride;
    uint8_t* o = bgr + (ptrdiff_t)y * p.w * 3;
    int x0 = 0;
#if defined(__x86_64__) || defined(__i386__)
    if (has_ssse3()) x0 = row_ssse3(py, cb.data(), cg.data(), cr.data(), p.w, o);
#endif
    row_scalar(py, cb.data(), cg.data(), cr.data(), x0, p.w, o);
  }
}

}  // namespace mgdt_codec
