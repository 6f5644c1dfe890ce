// ORB and SIFT features and their brute-force matcher for BoT-SORT's `orb`
// and `sift` camera-motion compensation (`tracker/gmc.py`), without OpenCV:
// the calls `cv2.ORB_create().detectAndCompute`, `cv2.SIFT_create().
// detectAndCompute` and `cv2.BFMatcher(NORM_HAMMING | NORM_L2).match` make,
// each following OpenCV's own arithmetic (`tests/test_torch_gmc_features.py`
// holds each stage against cv2):
//
// * ORB (500 features, 8 levels of factor 1.2, FAST threshold 20, Harris
//   score, patch 31): the pyramid by INTER_LINEAR_EXACT resizes, FAST-9/16
//   with non-maximum suppression, the border filter and `retainBest` (the
//   same std::nth_element and std::partition on the same order as OpenCV's,
//   so the survivors and their order are OpenCV's), Harris responses of 7 x
//   7 blocks, the per-level quotas, the intensity-centroid angle through
//   fastAtan2, the 7 x 7 sigma 2 blur of each level through sepFilter2D's
//   float path, and the 256 rotated tests of `orb_pattern.inc`. ORB's own
//   code is OpenCV's baseline scalar code, so its float operations are
//   rounded one by one here (the build turns contraction off); the blur is
//   its default (AVX2) build's, whose multiply-adds are fused: bit for bit.
// * SIFT (3 layers an octave, contrast 0.04, edge 10, sigma 1.6, the image
//   doubled): the float pyramid by INTER_LINEAR and GaussianBlur's float
//   separable filter, the difference of Gaussians, extrema refined by
//   OpenCV's 3 x 3 Cramer solve, the 36-bin orientation histogram, the sort
//   and de-duplication, and the 4 x 4 x 8 descriptors. OpenCV dispatches
//   SIFT's loops and filters by CPU; this follows its default build on an
//   AVX-512 machine (AVX2 filters, AVX-512 SIFT loops, their 8- and 16-lane
//   splits), whose multiply-adds the compiler fuses (`fmaf` here, where it
//   fuses there), and IPP's exp by the correctly rounded one. So the
//   keypoints, their order, positions, sizes and descriptors are those of
//   cv2 bit for bit on the tested frames, and the orientations within a few
//   1e-5 degrees.
// * The matcher: for each query in order the nearest train descriptor (the
//   lowest index among equals), Hamming or float L2.
//
// Every loop that runs on the pool (`mgdt_gmc::parallel_chunks`, in
// host_gmc.cpp) keeps its results per index, so nothing depends on the
// number of threads.
//
// Build: compiled with host_gmc.cpp into one library (see
// mgdt_yolo_tpu_torch/utils/build.py: g++ -O3 -shared -fPIC -std=c++17
// -ffp-contract=off [-mfma] host_gmc.cpp host_features.cpp -lpthread).

#include <algorithm>
#include <cfloat>
#include <climits>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <vector>

#include "orb_pattern.inc"

namespace mgdt_gmc {
void parallel_chunks(int n, const std::function<void(int, int)>& fn);
}

namespace {

using mgdt_gmc::parallel_chunks;

// cv::KeyPoint's fields, in its order
struct KeyPoint {
  float x, y, size, angle, response;
  int octave, class_id;
};

inline int reflect101(int p, int n) {
  if (n == 1) return 0;
  while (p < 0 || p >= n) p = p < 0 ? -p : 2 * n - 2 - p;
  return p;
}

inline int cv_round(float v) { return static_cast<int>(std::lrintf(v)); }
inline int cv_round(double v) { return static_cast<int>(std::lrint(v)); }
inline int cv_floor(float v) {
  const int i = static_cast<int>(v);
  return i - (static_cast<float>(i) > v);
}
inline int cv_floor(double v) {
  const int i = static_cast<int>(v);
  return i - (static_cast<double>(i) > v);
}
inline int cv_ceil(float v) {
  const int i = static_cast<int>(v);
  return i + (static_cast<float>(i) < v);
}
inline uint8_t sat_u8(int v) { return static_cast<uint8_t>(std::min(255, std::max(0, v))); }

// ---------------------------------------------------------------------------
// Shared pieces
// ---------------------------------------------------------------------------

// getGaussianKernel(n, sigma, CV_32F): OpenCV's bit-exact kernel, in double
// and then float.
std::vector<float> gaussian_kernel(int n, double sigma) {
  const double sigma_x = sigma > 0 ? sigma : 0.15 * n + 0.35;
  const double scale2x = -0.125 / (sigma_x * sigma_x);
  const int n2 = (n - 1) / 2;
  std::vector<double> values(n2 + 1);
  double sum = 0;
  for (int i = 0, x = 1 - n; i < n2; ++i, x += 2) {
    const double t = std::exp(static_cast<double>(x * x) * scale2x);
    values[i] = t;
    sum += t;
  }
  sum *= 2;
  sum += 1;
  if ((n & 1) == 0) sum += 1;
  const double mul1 = 1 / sum;
  std::vector<float> k(n);
  for (int i = 0; i < n2; ++i) k[i] = k[n - 1 - i] = static_cast<float>(values[i] * mul1);
  k[n2] = static_cast<float>(mul1);
  return k;
}

// fastAtan2's polynomial (degrees), OpenCV's constants
const float kAtanP1 = 0.9997878412794807f * static_cast<float>(180 / M_PI);
const float kAtanP3 = -0.3258083974640975f * static_cast<float>(180 / M_PI);
const float kAtanP5 = 0.1555786518463281f * static_cast<float>(180 / M_PI);
const float kAtanP7 = -0.04432655554792128f * static_cast<float>(180 / M_PI);

// cv::fastAtan2(y, x) (every operation rounded on its own, as in OpenCV's
// baseline code, whose array form computes the same)
float fast_atan2(float y, float x) {
  const float ax = std::abs(x), ay = std::abs(y);
  float a, c, c2;
  if (ax >= ay) {
    c = ay / (ax + static_cast<float>(DBL_EPSILON));
    c2 = c * c;
    a = (((kAtanP7 * c2 + kAtanP5) * c2 + kAtanP3) * c2 + kAtanP1) * c;
  } else {
    c = ax / (ay + static_cast<float>(DBL_EPSILON));
    c2 = c * c;
    a = 90.f - (((kAtanP7 * c2 + kAtanP5) * c2 + kAtanP3) * c2 + kAtanP1) * c;
  }
  if (x < 0) a = 180.f - a;
  if (y < 0) a = 360.f - a;
  return a;
}

// hal::fastAtan32f(Y, X, angle, n, degrees) of OpenCV's dispatched code: the
// polynomial by fused multiply-adds
float fast_atan2_fused(float y, float x) {
  const float ax = std::abs(x), ay = std::abs(y);
  const float c = std::min(ax, ay) / (std::max(ax, ay) + static_cast<float>(DBL_EPSILON));
  const float cc = c * c;
  float a = std::fmaf(std::fmaf(std::fmaf(cc, kAtanP7, kAtanP5), cc, kAtanP3), cc, kAtanP1) * c;
  if (!(ax >= ay)) a = 90.f - a;
  if (x < 0) a = 180.f - a;
  if (y < 0) a = 360.f - a;
  return a;
}

// hal::exp32f where OpenCV's optimized build calls IPP's ippsExp_32f_A21
// (within about an ulp of exp): exp rounded to the nearest float
float exp_ipp(float v) { return static_cast<float>(std::exp(static_cast<double>(v))); }

// ---------------------------------------------------------------------------
// ORB
// ---------------------------------------------------------------------------

// resize(src, dst, (dw, dh), INTER_LINEAR_EXACT) of a gray uint8 image:
// 8-bit fixed-point weights from the double source coordinate, rows
// interpolated to 8 fractional bits, then columns to 16, rounded half up
void resize_linear_exact(const uint8_t* src, int sw, int sh, uint8_t* dst, int dw, int dh) {
  struct Axis {
    std::vector<int> ofs;
    std::vector<uint32_t> c0, c1;
    int lo = 0, hi = 0;
  };
  auto axis = [](int s, int d) {
    Axis a;
    a.ofs.assign(d, 0), a.c0.assign(d, 0), a.c1.assign(d, 0);
    const double scale = 1.0 / (static_cast<double>(d) / s);
    int minofst = 0, maxofst = d;
    for (int v = 0; v < d; ++v) {
      const double f = scale * (static_cast<double>(v) + 0.5) - 0.5;
      const int iv = cv_floor(f);
      if (iv >= 0 && s > 1) {
        if (iv < s - 1) {
          a.ofs[v] = iv;
          const int c1 = cv_round((f - iv) * 256.0);
          a.c1[v] = static_cast<uint32_t>(c1);
          a.c0[v] = c1 < 256 ? static_cast<uint32_t>(256 - c1) : 0u;
        } else {
          a.ofs[v] = s - 1;
          maxofst = std::min(maxofst, v);
        }
      } else {
        minofst = std::max(minofst, v + 1);
      }
    }
    a.lo = minofst, a.hi = maxofst;
    return a;
  };
  const Axis ax = axis(sw, dw), ay = axis(sh, dh);
  auto hline = [&](int row, uint32_t* out) {
    const uint8_t* s = src + static_cast<size_t>(row) * sw;
    const uint32_t first = static_cast<uint32_t>(s[0]) << 8;
    const uint32_t last = static_cast<uint32_t>(s[ax.ofs[dw - 1]]) << 8;
    for (int x = 0; x < dw; ++x) {
      if (x < ax.lo) out[x] = first;
      else if (x >= ax.hi) out[x] = last;
      else out[x] = std::min(65535u, ax.c0[x] * s[ax.ofs[x]] + ax.c1[x] * s[ax.ofs[x] + 1]);
    }
  };
  parallel_chunks(dh, [&](int b, int e) {
    std::vector<uint32_t> l0(dw), l1(dw);
    for (int y = b; y < e; ++y) {
      uint8_t* d = dst + static_cast<size_t>(y) * dw;
      if (y < ay.lo || y >= ay.hi) {
        hline(y < ay.lo ? 0 : sh - 1, l0.data());
        for (int x = 0; x < dw; ++x) d[x] = sat_u8(static_cast<int>((l0[x] + 128) >> 8));
        continue;
      }
      hline(ay.ofs[y], l0.data());
      hline(ay.ofs[y] + 1, l1.data());
      const uint32_t c0 = ay.c0[y], c1 = ay.c1[y];
      for (int x = 0; x < dw; ++x) {
        const uint64_t v = static_cast<uint64_t>(l0[x]) * c0 + static_cast<uint64_t>(l1[x]) * c1;
        d[x] = sat_u8(static_cast<int>(std::min<uint64_t>((v + 32768) >> 16, 255)));
      }
    }
  });
}

// The 7 x 7, sigma 2 blur ORB gives each level: sepFilter2D with the float
// kernel (whose sum is not 1 within FLT_EPSILON, so OpenCV keeps it float),
// reflect-101 borders: each row a chain of multiply-adds from the leftmost
// tap, each column a symmetric one from the centre out, rounded half to
// even and saturated. As OpenCV's default build (AVX2) computes it, the
// multiply-adds are fused but for the last W % 4 columns, its scalar tails
// (its baseline code fuses none: the two differ on about 1 pixel in 10^5)
void orb_blur(const uint8_t* src, int W, int H, uint8_t* dst) {
  static const std::vector<float> k = gaussian_kernel(7, 2.0);
  const int vec = W - W % 4;
  std::vector<float> rows(static_cast<size_t>(W) * H);
  parallel_chunks(H, [&](int b, int e) {
    std::vector<float> ext(W + 6);
    for (int y = b; y < e; ++y) {
      const uint8_t* s = src + static_cast<size_t>(y) * W;
      for (int x = -3; x < W + 3; ++x) ext[x + 3] = s[x >= 0 && x < W ? x : reflect101(x, W)];
      float* o = &rows[static_cast<size_t>(y) * W];
      for (int x = 0; x < W; ++x) {
        float acc = ext[x] * k[0];
        if (x < vec)
          for (int t = 1; t < 7; ++t) acc = std::fmaf(k[t], ext[x + t], acc);
        else
          for (int t = 1; t < 7; ++t) acc = acc + k[t] * ext[x + t];
        o[x] = acc;
      }
    }
  });
  parallel_chunks(H, [&](int b, int e) {
    for (int y = b; y < e; ++y) {
      uint8_t* d = dst + static_cast<size_t>(y) * W;
      const float* c = &rows[static_cast<size_t>(y) * W];
      const float* up[3];
      const float* dn[3];
      for (int t = 1; t <= 3; ++t) {
        up[t - 1] = &rows[static_cast<size_t>(reflect101(y - t, H)) * W];
        dn[t - 1] = &rows[static_cast<size_t>(reflect101(y + t, H)) * W];
      }
      for (int x = 0; x < W; ++x) {
        float acc = k[3] * c[x];
        if (x < vec)
          for (int t = 1; t <= 3; ++t) acc = std::fmaf(k[3 + t], dn[t - 1][x] + up[t - 1][x], acc);
        else
          for (int t = 1; t <= 3; ++t) acc = acc + k[3 + t] * (dn[t - 1][x] + up[t - 1][x]);
        d[x] = sat_u8(cv_round(acc));
      }
    }
  });
}

// FAST-9/16's offsets around a pixel, OpenCV's order
const int kFast16[16][2] = {{0, 3},  {1, 3},   {2, 2},   {3, 1},  {3, 0},  {3, -1},
                            {2, -2}, {1, -3},  {0, -3},  {-1, -3}, {-2, -2}, {-3, -1},
                            {-3, 0}, {-3, 1},  {-2, 2},  {-1, 3}};

// cornerScore<16>: the largest threshold at which the pixel is still a
// corner, less one
int fast_score(const uint8_t* p, const int* pixel, int threshold) {
  const int K = 8, N = K * 3 + 1;
  const int v = p[0];
  int d[N];
  for (int k = 0; k < N; ++k) d[k] = v - p[pixel[k]];
  int a0 = threshold;
  for (int k = 0; k < 16; k += 2) {
    int a = std::min(d[k + 1], d[k + 2]);
    a = std::min(a, d[k + 3]);
    if (a <= a0) continue;
    a = std::min(a, d[k + 4]);
    a = std::min(a, d[k + 5]);
    a = std::min(a, d[k + 6]);
    a = std::min(a, d[k + 7]);
    a = std::min(a, d[k + 8]);
    a0 = std::max(a0, std::min(a, d[k]));
    a0 = std::max(a0, std::min(a, d[k + 9]));
  }
  int b0 = -a0;
  for (int k = 0; k < 16; k += 2) {
    int b = std::max(d[k + 1], d[k + 2]);
    b = std::max(b, d[k + 3]);
    b = std::max(b, d[k + 4]);
    b = std::max(b, d[k + 5]);
    if (b >= b0) continue;
    b = std::max(b, d[k + 6]);
    b = std::max(b, d[k + 7]);
    b = std::max(b, d[k + 8]);
    b0 = std::min(b0, std::max(b, d[k]));
    b0 = std::min(b0, std::max(b, d[k + 9]));
  }
  return -b0 - 1;
}

// FAST(img, threshold, nonmaxSuppression=true, TYPE_9_16): corners in row
// order, each (x, y, size 7, angle -1, response = its score)
std::vector<KeyPoint> fast_detect(const uint8_t* img, int W, int H, int threshold) {
  std::vector<KeyPoint> out;
  if (H < 7 || W < 7) return out;
  threshold = std::min(std::max(threshold, 0), 255);
  int pixel[25];
  for (int k = 0; k < 16; ++k) pixel[k] = kFast16[k][0] + kFast16[k][1] * W;
  for (int k = 16; k < 25; ++k) pixel[k] = pixel[k - 16];
  // the score of every corner (0 elsewhere), rows 3 .. H - 4
  std::vector<uint8_t> score(static_cast<size_t>(W) * H, 0);
  std::vector<std::vector<int>> corners(H);
  parallel_chunks(H, [&](int b, int e) {
    for (int i = std::max(b, 3); i < std::min(e, H - 3); ++i) {
      for (int j = 3; j < W - 3; ++j) {
        const uint8_t* ptr = img + static_cast<size_t>(i) * W + j;
        const int v = ptr[0];
        auto tab = [&](int q) { const int dd = q - v; return dd < -threshold ? 1 : dd > threshold ? 2 : 0; };
        int d = tab(ptr[pixel[0]]) | tab(ptr[pixel[8]]);
        if (d == 0) continue;
        d &= tab(ptr[pixel[2]]) | tab(ptr[pixel[10]]);
        d &= tab(ptr[pixel[4]]) | tab(ptr[pixel[12]]);
        d &= tab(ptr[pixel[6]]) | tab(ptr[pixel[14]]);
        if (d == 0) continue;
        d &= tab(ptr[pixel[1]]) | tab(ptr[pixel[9]]);
        d &= tab(ptr[pixel[3]]) | tab(ptr[pixel[11]]);
        d &= tab(ptr[pixel[5]]) | tab(ptr[pixel[13]]);
        d &= tab(ptr[pixel[7]]) | tab(ptr[pixel[15]]);
        bool corner = false;
        if (d & 1) {
          const int vt = v - threshold;
          int count = 0;
          for (int k = 0; k < 25; ++k) {
            if (ptr[pixel[k]] < vt) {
              if (++count > 8) { corner = true; break; }
            } else {
              count = 0;
            }
          }
        }
        if (!corner && (d & 2)) {
          const int vt = v + threshold;
          int count = 0;
          for (int k = 0; k < 25; ++k) {
            if (ptr[pixel[k]] > vt) {
              if (++count > 8) { corner = true; break; }
            } else {
              count = 0;
            }
          }
        }
        if (corner) {
          corners[i].push_back(j);
          score[static_cast<size_t>(i) * W + j] =
              static_cast<uint8_t>(fast_score(ptr, pixel, threshold));
        }
      }
    }
  });
  for (int i = 4; i < H - 2; ++i) {
    const int y = i - 1;
    const uint8_t* prev = &score[static_cast<size_t>(y) * W];
    const uint8_t* pprev = prev - W;
    const uint8_t* curr = prev + W;
    for (int j : corners[y]) {
      const int s = prev[j];
      if (s > prev[j + 1] && s > prev[j - 1] && s > pprev[j - 1] && s > pprev[j] &&
          s > pprev[j + 1] && s > curr[j - 1] && s > curr[j] && s > curr[j + 1])
        out.push_back({static_cast<float>(j), static_cast<float>(y), 7.f, -1.f,
                       static_cast<float>(s), 0, -1});
    }
  }
  return out;
}

// KeyPointsFilter::runByImageBorder
void run_by_image_border(std::vector<KeyPoint>& kps, int W, int H, int border) {
  if (H <= border * 2 || W <= border * 2) {
    kps.clear();
    return;
  }
  const float x0 = static_cast<float>(border), y0 = static_cast<float>(border);
  const float x1 = static_cast<float>(W - border), y1 = static_cast<float>(H - border);
  kps.erase(std::remove_if(kps.begin(), kps.end(),
                           [&](const KeyPoint& k) {
                             return !(x0 <= k.x && k.x < x1 && y0 <= k.y && k.y < y1);
                           }),
            kps.end());
}

// KeyPointsFilter::retainBest: std::nth_element by descending response,
// then every point at the boundary's response kept by std::partition
void retain_best(std::vector<KeyPoint>& kps, int n) {
  if (n < 0 || kps.size() <= static_cast<size_t>(n)) return;
  if (n == 0) {
    kps.clear();
    return;
  }
  std::nth_element(kps.begin(), kps.begin() + n - 1, kps.end(),
                   [](const KeyPoint& a, const KeyPoint& b) { return a.response > b.response; });
  const float amb = kps[n - 1].response;
  auto end = std::partition(kps.begin() + n, kps.end(),
                            [amb](const KeyPoint& k) { return k.response >= amb; });
  kps.resize(end - kps.begin());
}

struct Features {
  std::vector<KeyPoint> kps;
  std::vector<uint8_t> desc;  // n x 32 (ORB) or n x 128 float32 (SIFT)
};

struct OrbLevel {
  int w, h;
  float scale;
  std::vector<uint8_t> img;
};

// ORB's image pyramid: level 0 the image, each next one resized from the one
// before to round(size / 1.2^level)
std::vector<OrbLevel> orb_pyramid(const uint8_t* img, int W, int H, int nlevels,
                                  double scale_factor) {
  std::vector<OrbLevel> lv(nlevels);
  for (int l = 0; l < nlevels; ++l) {
    OrbLevel& L = lv[l];
    L.scale = static_cast<float>(std::pow(scale_factor, static_cast<double>(l)));
    const float inv = 1.0f / L.scale;
    L.w = cv_round(static_cast<float>(W) * inv);
    L.h = cv_round(static_cast<float>(H) * inv);
    L.img.resize(static_cast<size_t>(L.w) * L.h);
    if (l == 0) {
      std::memcpy(L.img.data(), img, L.img.size());
    } else {
      const OrbLevel& P = lv[l - 1];
      resize_linear_exact(P.img.data(), P.w, P.h, L.img.data(), L.w, L.h);
    }
  }
  return lv;
}

// ORB_create() (500 features) detectAndCompute on a gray image
void orb_detect_and_compute(const uint8_t* img, int W, int H, int nfeatures, Features& out) {
  const int nlevels = 8, edge = 31, patch = 31, half = patch / 2, fast_threshold = 20;
  const double scale_factor = static_cast<double>(1.2f);
  const float harris_k = 0.04f;
  out.kps.clear(), out.desc.clear();
  std::vector<OrbLevel> lv = orb_pyramid(img, W, H, nlevels, scale_factor);

  // the quotas: geometric over the levels, the last taking the rest
  std::vector<int> quota(nlevels);
  const float factor = static_cast<float>(1.0 / scale_factor);
  float per = static_cast<float>(nfeatures) * (1 - factor) /
              (1 - static_cast<float>(std::pow(static_cast<double>(factor),
                                               static_cast<double>(nlevels))));
  int sum = 0;
  for (int l = 0; l < nlevels - 1; ++l) {
    quota[l] = cv_round(per);
    sum += quota[l];
    per *= factor;
  }
  quota[nlevels - 1] = std::max(nfeatures - sum, 0);

  // the half-width of the patch's circle on each row
  std::vector<int> umax(half + 2);
  const int vmax = cv_floor(static_cast<float>(half) * std::sqrt(2.f) / 2 + 1);
  const int vmin = cv_ceil(static_cast<float>(half) * std::sqrt(2.f) / 2);
  for (int v = 0; v <= vmax; ++v)
    umax[v] = cv_round(std::sqrt(static_cast<double>(half) * half - v * v));
  for (int v = half, v0 = 0; v >= vmin; --v) {
    while (umax[v0] == umax[v0 + 1]) ++v0;
    umax[v] = v0;
    ++v0;
  }

  // FAST on each level, the border filter and twice the quota by FAST score
  std::vector<std::vector<KeyPoint>> found(nlevels);
  for (int l = 0; l < nlevels; ++l) {
    std::vector<KeyPoint> k = fast_detect(lv[l].img.data(), lv[l].w, lv[l].h, fast_threshold);
    run_by_image_border(k, lv[l].w, lv[l].h, edge);
    retain_best(k, 2 * quota[l]);
    for (KeyPoint& p : k) p.octave = l, p.size = static_cast<float>(patch) * lv[l].scale;
    found[l] = std::move(k);
  }
  // Harris responses (7 x 7 block), then the quota by them
  const int bs = 7, r = bs / 2;
  const float hs = 1.f / (static_cast<float>((1 << 2) * bs) * 255.f);
  const float hs4 = hs * hs * hs * hs;
  for (int l = 0; l < nlevels; ++l) {
    const OrbLevel& L = lv[l];
    for (KeyPoint& p : found[l]) {
      const int x0 = cv_round(p.x), y0 = cv_round(p.y);
      int a = 0, b = 0, c = 0;
      for (int i = 0; i < bs; ++i)
        for (int j = 0; j < bs; ++j) {
          const uint8_t* q = L.img.data() + static_cast<size_t>(y0 - r + i) * L.w + (x0 - r + j);
          const int st = L.w;
          const int ix = (q[1] - q[-1]) * 2 + (q[-st + 1] - q[-st - 1]) + (q[st + 1] - q[st - 1]);
          const int iy = (q[st] - q[-st]) * 2 + (q[st - 1] - q[-st - 1]) + (q[st + 1] - q[-st + 1]);
          a += ix * ix, b += iy * iy, c += ix * iy;
        }
      const float fa = static_cast<float>(a), fb = static_cast<float>(b), fc = static_cast<float>(c);
      const float t1 = fa * fb, t2 = fc * fc;
      const float s = fa + fb;
      const float t3 = harris_k * s * s;
      p.response = ((t1 - t2) - t3) * hs4;
    }
    retain_best(found[l], quota[l]);
  }
  // the intensity-centroid angle
  for (int l = 0; l < nlevels; ++l) {
    const OrbLevel& L = lv[l];
    const int st = L.w;
    for (KeyPoint& p : found[l]) {
      const uint8_t* center = L.img.data() + static_cast<size_t>(cv_round(p.y)) * st + cv_round(p.x);
      int m01 = 0, m10 = 0;
      for (int u = -half; u <= half; ++u) m10 += u * center[u];
      for (int v = 1; v <= half; ++v) {
        int v_sum = 0;
        const int d = umax[v];
        for (int u = -d; u <= d; ++u) {
          const int vp = center[u + v * st], vm = center[u - v * st];
          v_sum += vp - vm;
          m10 += u * (vp + vm);
        }
        m01 += v * v_sum;
      }
      p.angle = fast_atan2(static_cast<float>(m01), static_cast<float>(m10));
    }
  }
  for (int l = 0; l < nlevels; ++l)
    for (KeyPoint& p : found[l]) {
      p.x *= lv[l].scale;
      p.y *= lv[l].scale;
      out.kps.push_back(p);
    }
  if (out.kps.empty()) return;

  // the descriptors, on each level blurred
  std::vector<std::vector<uint8_t>> blurred(nlevels);
  for (int l = 0; l < nlevels; ++l) {
    if (found[l].empty()) continue;
    blurred[l].resize(lv[l].img.size());
    orb_blur(lv[l].img.data(), lv[l].w, lv[l].h, blurred[l].data());
  }
  const int n = static_cast<int>(out.kps.size());
  out.desc.assign(static_cast<size_t>(n) * 32, 0);
  parallel_chunks(n, [&](int b, int e) {
    for (int j = b; j < e; ++j) {
      const KeyPoint& k = out.kps[j];
      const OrbLevel& L = lv[k.octave];
      const float scale = 1.f / L.scale;
      const float angle = k.angle * static_cast<float>(M_PI / 180.f);
      const float a = static_cast<float>(std::cos(static_cast<double>(angle)));
      const float bb = static_cast<float>(std::sin(static_cast<double>(angle)));
      const uint8_t* center = blurred[k.octave].data() +
                              static_cast<size_t>(cv_round(k.y * scale)) * L.w +
                              cv_round(k.x * scale);
      auto value = [&](const int* p) {
        const float x = static_cast<float>(p[0]) * a - static_cast<float>(p[1]) * bb;
        const float y = static_cast<float>(p[0]) * bb + static_cast<float>(p[1]) * a;
        return center[cv_round(y) * L.w + cv_round(x)];
      };
      uint8_t* desc = &out.desc[static_cast<size_t>(j) * 32];
      for (int i = 0; i < 32; ++i) {
        int val = 0;
        for (int bit = 0; bit < 8; ++bit) {
          const int* pair = kOrbPattern + 4 * (8 * i + bit);
          val |= (value(pair) < value(pair + 2)) << bit;
        }
        desc[i] = static_cast<uint8_t>(val);
      }
    }
  });
}

// ---------------------------------------------------------------------------
// SIFT
// ---------------------------------------------------------------------------

struct FImg {
  int w = 0, h = 0;
  std::vector<float> d;
  void create(int W, int H) { w = W, h = H, d.assign(static_cast<size_t>(W) * H, 0.f); }
  float* row(int y) { return &d[static_cast<size_t>(y) * w]; }
  const float* row(int y) const { return &d[static_cast<size_t>(y) * w]; }
  float at(int y, int x) const { return d[static_cast<size_t>(y) * w + x]; }
};

// GaussianBlur(src, dst, Size(), sigma, sigma) of a float image: the size
// from sigma, OpenCV's kernel, reflect-101 borders; the row pass a chain of
// fused multiply-adds from the leftmost tap, the column pass a symmetric one
// from the centre out, as OpenCV's AVX2 code computes them. Its scalar tails
// are not fused: the last W % 4 columns of the row pass, the last W % 8 of
// the column pass
void gauss_blur_f32(const FImg& src, FImg& dst, double sigma) {
  const int ks = cv_round(sigma * 4 * 2 + 1) | 1;
  const std::vector<float> k = gaussian_kernel(ks, sigma);
  const int r = ks / 2, W = src.w, H = src.h;
  const int row_vec = W - W % 4, col_vec = W - W % 8;
  FImg rows;
  rows.create(W, H);
  parallel_chunks(H, [&](int b, int e) {
    std::vector<float> ext(W + 2 * r);
    for (int y = b; y < e; ++y) {
      const float* s = src.row(y);
      for (int x = -r; x < W + r; ++x) ext[x + r] = s[x >= 0 && x < W ? x : reflect101(x, W)];
      float* o = rows.row(y);
      for (int x = 0; x < W; ++x) o[x] = ext[x] * k[0];
      for (int t = 1; t < ks; ++t) {
        const float kt = k[t];
        const float* e2 = &ext[t];
        for (int x = 0; x < row_vec; ++x) o[x] = std::fmaf(e2[x], kt, o[x]);
        for (int x = row_vec; x < W; ++x) o[x] = o[x] + e2[x] * kt;
      }
    }
  });
  dst.create(W, H);
  parallel_chunks(H, [&](int b, int e) {
    for (int y = b; y < e; ++y) {
      float* o = dst.row(y);
      const float* c = rows.row(y);
      for (int x = 0; x < W; ++x) o[x] = c[x] * k[r];
      for (int t = 1; t <= r; ++t) {
        const float* up = rows.row(reflect101(y - t, H));
        const float* dn = rows.row(reflect101(y + t, H));
        const float kt = k[r + t];
        for (int x = 0; x < col_vec; ++x) o[x] = std::fmaf(dn[x] + up[x], kt, o[x]);
        for (int x = col_vec; x < W; ++x) o[x] = o[x] + (dn[x] + up[x]) * kt;
      }
    }
  });
}

constexpr int kLayers = 3;
constexpr float kSigma = 1.6f;
constexpr double kContrast = 0.04, kEdge = 10;
constexpr int kBorder = 5, kMaxInterp = 5, kOriBins = 36;
constexpr float kOriSig = 1.5f, kOriRadius = 3 * kOriSig, kOriPeak = 0.8f;
constexpr int kDescWidth = 4, kDescBins = 8;
constexpr float kDescScale = 3.f, kDescMagThr = 0.2f, kDescIntFactor = 512.f;

// createInitialImage: the gray image as float, doubled by INTER_LINEAR (its
// weights are quarters, so every value is exact), then blurred up to sigma
void sift_base(const uint8_t* img, int W, int H, FImg& base) {
  FImg dbl;
  dbl.create(2 * W, 2 * H);
  auto src = [&](int y, int x) { return static_cast<float>(img[static_cast<size_t>(y) * W + x]); };
  auto coord = [](int d, int s, int& i0, int& i1, float& f) {
    f = static_cast<float>((d + 0.5) * 0.5 - 0.5);
    int i = cv_floor(f);
    f -= static_cast<float>(i);
    i0 = std::min(std::max(i, 0), s - 1), i1 = std::min(std::max(i + 1, 0), s - 1);
  };
  parallel_chunks(2 * H, [&](int b, int e) {
    for (int y = b; y < e; ++y) {
      int y0, y1;
      float fy;
      coord(y, H, y0, y1, fy);
      float* o = dbl.row(y);
      for (int x = 0; x < 2 * W; ++x) {
        // cv2 clamps the column's source and weight at the edges, and only
        // the row's source
        float fx = static_cast<float>((x + 0.5) * 0.5 - 0.5);
        int sx = cv_floor(fx);
        fx -= static_cast<float>(sx);
        if (sx < 0) fx = 0, sx = 0;
        if (sx >= W - 1) fx = 0, sx = W - 1;
        const int sx1 = std::min(sx + 1, W - 1);
        const float h0 = src(y0, sx) * (1.f - fx) + src(y0, sx1) * fx;
        const float h1 = src(y1, sx) * (1.f - fx) + src(y1, sx1) * fx;
        o[x] = h0 * (1.f - fy) + h1 * fy;
      }
    }
  });
  const float sig_diff = std::sqrt(std::max(kSigma * kSigma - 0.5f * 0.5f * 4, 0.01f));
  gauss_blur_f32(dbl, base, static_cast<double>(sig_diff));
}

// resize(src, dst, (w / 2, h / 2), INTER_NEAREST)
void half_nearest(const FImg& src, FImg& dst) {
  const int dw = src.w / 2, dh = src.h / 2;
  dst.create(dw, dh);
  const double ifx = 1. / (static_cast<double>(dw) / src.w);
  const double ify = 1. / (static_cast<double>(dh) / src.h);
  for (int y = 0; y < dh; ++y) {
    const float* s = src.row(std::min(cv_floor(y * ify), src.h - 1));
    float* o = dst.row(y);
    for (int x = 0; x < dw; ++x) o[x] = s[std::min(cv_floor(x * ifx), src.w - 1)];
  }
}

// Matx33f::solve(b, DECOMP_LU): Cramer's rule in float, with the
// multiply-adds the compiler fuses in OpenCV's dispatched code: the first
// product of each sum or difference, where the products shared between the
// three solutions are computed once (b1 * a21 is fused into both of its
// differences)
bool solve3(const float a[3][3], const float b[3], float x[3]) {
  auto fms = [](float p, float q, float r) { return std::fmaf(p, q, -r); };
  const float t1 = fms(a[1][1], a[2][2], a[2][1] * a[1][2]);
  const float t2 = fms(a[1][0], a[2][2], a[2][0] * a[1][2]);
  const float t3 = fms(a[1][0], a[2][1], a[2][0] * a[1][1]);
  float d = std::fmaf(a[0][2], t3, fms(a[0][0], t1, a[0][1] * t2));
  if (d == 0) return false;
  d = 1 / d;
  const float u1 = fms(a[1][1], a[2][2], a[1][2] * a[2][1]);
  const float u2 = fms(b[1], a[2][2], a[1][2] * b[2]);
  const float u3 = fms(b[1], a[2][1], a[1][1] * b[2]);
  x[0] = d * std::fmaf(a[0][2], u3, fms(b[0], u1, a[0][1] * u2));
  const float v2 = fms(a[1][0], a[2][2], a[1][2] * a[2][0]);
  const float v3 = fms(a[1][0], b[2], b[1] * a[2][0]);
  x[1] = d * std::fmaf(a[0][2], v3, fms(a[0][0], u2, b[0] * v2));
  const float w1 = std::fmaf(-b[1], a[2][1], a[1][1] * b[2]);
  const float w3 = fms(a[1][0], a[2][1], a[1][1] * a[2][0]);
  x[2] = d * std::fmaf(b[0], w3, fms(a[0][0], w1, a[0][1] * v3));
  return true;
}

struct SiftPyramid {
  int octaves = 0;
  std::vector<FImg> gauss, dog;  // octave * (kLayers + 3) + i, octave * (kLayers + 2) + i
};

// adjustLocalExtrema: the sub-pixel, sub-scale extremum by up to 5 Newton
// steps, the contrast and edge tests, the keypoint in the doubled image's
// coordinates
bool adjust_local_extrema(const SiftPyramid& P, KeyPoint& kpt, int octv, int& layer, int& r,
                          int& c) {
  const float img_scale = 1.f / 255.f, deriv_scale = img_scale * 0.5f;
  const float second_deriv_scale = img_scale, cross_deriv_scale = img_scale * 0.25f;
  float xi = 0, xr = 0, xc = 0, contr = 0;
  int i = 0;
  for (; i < kMaxInterp; ++i) {
    const int idx = octv * (kLayers + 2) + layer;
    const FImg &img = P.dog[idx], &prev = P.dog[idx - 1], &next = P.dog[idx + 1];
    const float dD[3] = {(img.at(r, c + 1) - img.at(r, c - 1)) * deriv_scale,
                         (img.at(r + 1, c) - img.at(r - 1, c)) * deriv_scale,
                         (next.at(r, c) - prev.at(r, c)) * deriv_scale};
    const float v2 = img.at(r, c) * 2;
    const float dxx = (img.at(r, c + 1) + img.at(r, c - 1) - v2) * second_deriv_scale;
    const float dyy = (img.at(r + 1, c) + img.at(r - 1, c) - v2) * second_deriv_scale;
    const float dss = (next.at(r, c) + prev.at(r, c) - v2) * second_deriv_scale;
    const float dxy = (img.at(r + 1, c + 1) - img.at(r + 1, c - 1) - img.at(r - 1, c + 1) +
                       img.at(r - 1, c - 1)) * cross_deriv_scale;
    const float dxs = (next.at(r, c + 1) - next.at(r, c - 1) - prev.at(r, c + 1) +
                       prev.at(r, c - 1)) * cross_deriv_scale;
    const float dys = (next.at(r + 1, c) - next.at(r - 1, c) - prev.at(r + 1, c) +
                       prev.at(r - 1, c)) * cross_deriv_scale;
    const float H[3][3] = {{dxx, dxy, dxs}, {dxy, dyy, dys}, {dxs, dys, dss}};
    float X[3];
    if (!solve3(H, dD, X)) X[0] = X[1] = X[2] = 0;
    xi = -X[2], xr = -X[1], xc = -X[0];
    if (std::abs(xi) < 0.5f && std::abs(xr) < 0.5f && std::abs(xc) < 0.5f) break;
    const float big = static_cast<float>(INT_MAX / 3);
    if (std::abs(xi) > big || std::abs(xr) > big || std::abs(xc) > big) return false;
    c += cv_round(xc);
    r += cv_round(xr);
    layer += cv_round(xi);
    if (layer < 1 || layer > kLayers || c < kBorder || c >= img.w - kBorder || r < kBorder ||
        r >= img.h - kBorder)
      return false;
  }
  if (i >= kMaxInterp) return false;
  {
    const int idx = octv * (kLayers + 2) + layer;
    const FImg &img = P.dog[idx], &prev = P.dog[idx - 1], &next = P.dog[idx + 1];
    const float dD[3] = {(img.at(r, c + 1) - img.at(r, c - 1)) * deriv_scale,
                         (img.at(r + 1, c) - img.at(r - 1, c)) * deriv_scale,
                         (next.at(r, c) - prev.at(r, c)) * deriv_scale};
    float t = dD[0] * xc;
    t = std::fmaf(dD[1], xr, t);
    t = std::fmaf(dD[2], xi, t);
    contr = std::fmaf(img.at(r, c), img_scale, t * 0.5f);
    if (std::abs(contr) * kLayers < static_cast<float>(kContrast)) return false;
    const float v2 = img.at(r, c) * 2.f;
    const float dxx = (img.at(r, c + 1) + img.at(r, c - 1) - v2) * second_deriv_scale;
    const float dyy = (img.at(r + 1, c) + img.at(r - 1, c) - v2) * second_deriv_scale;
    const float dxy = (img.at(r + 1, c + 1) - img.at(r + 1, c - 1) - img.at(r - 1, c + 1) +
                       img.at(r - 1, c - 1)) * cross_deriv_scale;
    const float tr = dxx + dyy;
    const float det = std::fmaf(dxx, dyy, -(dxy * dxy));
    const float edge = static_cast<float>(kEdge);
    if (det <= 0 || tr * tr * edge >= (edge + 1) * (edge + 1) * det) return false;
  }
  kpt.x = (static_cast<float>(c) + xc) * static_cast<float>(1 << octv);
  kpt.y = (static_cast<float>(r) + xr) * static_cast<float>(1 << octv);
  kpt.octave = octv + (layer << 8) + (cv_round((xi + 0.5) * 255) << 16);
  kpt.size = kSigma * std::pow(2.f, (static_cast<float>(layer) + xi) / kLayers) *
             static_cast<float>(1 << octv) * 2;
  kpt.response = std::abs(contr);
  kpt.angle = -1, kpt.class_id = -1;
  return true;
}

// calcOrientationHist: a 36-bin histogram of gradient directions weighted by
// magnitude and a Gaussian, smoothed; returns its maximum. The vector
// part's products are rounded before they are added, its tail's fused
constexpr int kLanes = 16;  // float lanes of OpenCV's AVX-512 code

float orientation_hist(const FImg& img, int px, int py, int radius, float sigma, float* hist) {
  const int n = kOriBins;
  const float expf_scale = -1.f / (2.f * sigma * sigma);
  std::vector<float> X, Y, W;
  for (int i = -radius; i <= radius; ++i) {
    const int y = py + i;
    if (y <= 0 || y >= img.h - 1) continue;
    for (int j = -radius; j <= radius; ++j) {
      const int x = px + j;
      if (x <= 0 || x >= img.w - 1) continue;
      X.push_back(img.at(y, x + 1) - img.at(y, x - 1));
      Y.push_back(img.at(y - 1, x) - img.at(y + 1, x));
      W.push_back(static_cast<float>(i * i + j * j) * expf_scale);
    }
  }
  const int len = static_cast<int>(X.size());
  float tmp[kOriBins + 4] = {0};
  float* temphist = tmp + 2;
  const int vec = len - len % kLanes;
  for (int k = 0; k < len; ++k) {
    const float w = exp_ipp(W[k]);
    const float ori = fast_atan2_fused(Y[k], X[k]);
    const float mag = std::sqrt(std::fmaf(X[k], X[k], Y[k] * Y[k]));
    int bin = cv_round((n / 360.f) * ori);
    if (bin >= n) bin -= n;
    if (bin < 0) bin += n;
    if (k < vec)
      temphist[bin] += w * mag;
    else
      temphist[bin] = std::fmaf(w, mag, temphist[bin]);
  }
  temphist[-1] = temphist[n - 1];
  temphist[-2] = temphist[n - 2];
  temphist[n] = temphist[0];
  temphist[n + 1] = temphist[1];
  const int hvec = n - n % kLanes;
  for (int i = 0; i < n; ++i) {
    const float a = temphist[i - 2] + temphist[i + 2], b = temphist[i - 1] + temphist[i + 1];
    const float t = temphist[i];
    if (i < hvec)
      hist[i] = std::fmaf(a, 1.f / 16.f, std::fmaf(b, 4.f / 16.f, t * (6.f / 16.f)));
    else
      hist[i] = std::fmaf(t, 6.f / 16.f, std::fmaf(a, 1.f / 16.f, b * (4.f / 16.f)));
  }
  float maxval = hist[0];
  for (int i = 1; i < n; ++i) maxval = std::max(maxval, hist[i]);
  return maxval;
}

// calcSIFTDescriptor: the 4 x 4 x 8 histogram of the rotated patch with
// trilinear spreading, normalised, clipped at 0.2, renormalised and scaled
// by 512, rounded and saturated to 0 .. 255
void sift_descriptor(const FImg& img, float ptx, float pty, float ori, float scl, float* dst) {
  const int d = kDescWidth, n = kDescBins;
  const int px = cv_round(ptx), py = cv_round(pty);
  float cos_t = std::cos(ori * static_cast<float>(M_PI / 180));
  float sin_t = std::sin(ori * static_cast<float>(M_PI / 180));
  const float bins_per_rad = n / 360.f;
  const float exp_scale = -1.f / (d * d * 0.5f);
  const float hist_width = kDescScale * scl;
  int radius = cv_round(hist_width * 1.4142135623730951f * (d + 1) * 0.5f);
  radius = std::min(radius, static_cast<int>(std::sqrt(static_cast<double>(img.w) * img.w +
                                                       static_cast<double>(img.h) * img.h)));
  cos_t /= hist_width;
  sin_t /= hist_width;
  const int rows = img.h, cols = img.w;
  std::vector<float> X, Y, RB, CB, W;
  for (int i = -radius; i <= radius; ++i) {
    const float isin = static_cast<float>(i) * sin_t, icos = static_cast<float>(i) * cos_t;
    for (int j = -radius; j <= radius; ++j) {
      const float c_rot = std::fmaf(static_cast<float>(j), cos_t, -isin);
      const float r_rot = std::fmaf(static_cast<float>(j), sin_t, icos);
      const float rbin = r_rot + static_cast<float>(d / 2) - 0.5f;
      const float cbin = c_rot + static_cast<float>(d / 2) - 0.5f;
      const int r = py + i, c = px + j;
      if (rbin > -1 && rbin < d && cbin > -1 && cbin < d && r > 0 && r < rows - 1 && c > 0 &&
          c < cols - 1) {
        X.push_back(img.at(r, c + 1) - img.at(r, c - 1));
        Y.push_back(img.at(r - 1, c) - img.at(r + 1, c));
        RB.push_back(rbin), CB.push_back(cbin);
        W.push_back(std::fmaf(c_rot, c_rot, r_rot * r_rot) * exp_scale);
      }
    }
  }
  const int len = static_cast<int>(X.size());
  const int hl = (d + 2) * (d + 2) * (n + 2);
  std::vector<float> hist(hl, 0.f);
  const int vec = len - len % kLanes;
  for (int k = 0; k < len; ++k) {
    const float o = fast_atan2_fused(Y[k], X[k]);
    const float m = std::sqrt(std::fmaf(X[k], X[k], Y[k] * Y[k]));
    const float w = exp_ipp(W[k]);
    float rbin = RB[k], cbin = CB[k];
    float obin = (o - ori) * bins_per_rad;
    const float mag = m * w;
    const int r0 = cv_floor(rbin), c0 = cv_floor(cbin);
    int o0 = cv_floor(obin);
    rbin -= static_cast<float>(r0);
    cbin -= static_cast<float>(c0);
    obin -= static_cast<float>(o0);
    if (o0 < 0) o0 += n;
    if (o0 >= n) o0 -= n;
    const float v_r1 = mag * rbin, v_r0 = mag - v_r1;
    const float v_rc11 = v_r1 * cbin, v_rc10 = v_r1 - v_rc11;
    const float v_rc01 = v_r0 * cbin, v_rc00 = v_r0 - v_rc01;
    const int idx = ((r0 + 1) * (d + 2) + c0 + 1) * (n + 2) + o0;
    const int at[8] = {idx, idx + 1, idx + (n + 2), idx + (n + 3), idx + (d + 2) * (n + 2),
                       idx + (d + 2) * (n + 2) + 1, idx + (d + 3) * (n + 2),
                       idx + (d + 3) * (n + 2) + 1};
    const float base[4] = {v_rc00, v_rc01, v_rc10, v_rc11};
    for (int q = 0; q < 4; ++q) {
      float* h0 = &hist[at[2 * q]];
      float* h1 = &hist[at[2 * q + 1]];
      if (k < vec) {
        const float hi = base[q] * obin;
        *h0 += base[q] - hi;
        *h1 += hi;
      } else {  // the scalar tail, where the compiler fuses the product
        *h0 += std::fmaf(-base[q], obin, base[q]);
        *h1 = std::fmaf(base[q], obin, *h1);
      }
    }
  }
  float raw[kDescWidth * kDescWidth * kDescBins];
  for (int i = 0; i < d; ++i)
    for (int j = 0; j < d; ++j) {
      const int idx = ((i + 1) * (d + 2) + (j + 1)) * (n + 2);
      hist[idx] += hist[idx + n];
      hist[idx + 1] += hist[idx + n + 1];
      for (int k = 0; k < n; ++k) raw[(i * d + j) * n + k] = hist[idx + k];
    }
  const int dl = d * d * n;
  // the norm: 16 lanes of fused products, summed as OpenCV's AVX-512
  // v_reduce_sum sums them
  float lane[kLanes] = {0};
  for (int k = 0; k < dl; ++k) lane[k % kLanes] = std::fmaf(raw[k], raw[k], lane[k % kLanes]);
  float half8[8], quarter[4];
  for (int i = 0; i < 8; ++i) half8[i] = lane[i] + lane[i + 8];
  for (int i = 0; i < 4; ++i) quarter[i] = half8[i] + half8[i + 4];
  float nrm2 = (quarter[0] + quarter[1]) + (quarter[2] + quarter[3]);
  const float thr = std::sqrt(nrm2) * kDescMagThr;
  nrm2 = 0;
  for (int i = 0; i < dl; ++i) {
    const float v = std::min(raw[i], thr);
    raw[i] = v;
    nrm2 = std::fmaf(v, v, nrm2);
  }
  nrm2 = kDescIntFactor / std::max(std::sqrt(nrm2), FLT_EPSILON);
  for (int k = 0; k < dl; ++k) {
    const float v = static_cast<float>(cv_round(raw[k] * nrm2));
    dst[k] = std::min(std::max(v, 0.f), 255.f);
  }
}

// KeyPoint_LessThan of removeDuplicatedSorted
bool keypoint_less(const KeyPoint& a, const KeyPoint& b) {
  if (a.x != b.x) return a.x < b.x;
  if (a.y != b.y) return a.y < b.y;
  if (a.size != b.size) return a.size > b.size;
  if (a.angle != b.angle) return a.angle < b.angle;
  if (a.response != b.response) return a.response > b.response;
  if (a.octave != b.octave) return a.octave > b.octave;
  return a.class_id > b.class_id;
}

void build_pyramid(const uint8_t* img, int W, int H, SiftPyramid& P) {
  FImg base;
  sift_base(img, W, H, base);
  const int first = -1;
  int octaves = cv_round(std::log(static_cast<double>(std::min(base.w, base.h))) / std::log(2.) - 2) -
                first;
  // octaves too small for an extremum inside the border change nothing
  int used = 0;
  for (int o = 0, w = base.w, h = base.h; o < octaves; ++o, w /= 2, h /= 2)
    if (h - kBorder > kBorder && w - kBorder > kBorder) used = o + 1;
  P.octaves = octaves = std::max(0, std::min(octaves, used));
  std::vector<double> sig(kLayers + 3);
  const double sigma = 1.6;  // the detector's own (double) sigma; the rest take it as float
  sig[0] = sigma;
  const double k = std::pow(2., 1. / kLayers);
  for (int i = 1; i < kLayers + 3; ++i) {
    const double sig_prev = std::pow(k, static_cast<double>(i - 1)) * sigma;
    const double sig_total = sig_prev * k;
    sig[i] = std::sqrt(sig_total * sig_total - sig_prev * sig_prev);
  }
  P.gauss.assign(octaves * (kLayers + 3), FImg());
  for (int o = 0; o < octaves; ++o)
    for (int i = 0; i < kLayers + 3; ++i) {
      FImg& dst = P.gauss[o * (kLayers + 3) + i];
      if (o == 0 && i == 0)
        dst = std::move(base);
      else if (i == 0)
        half_nearest(P.gauss[(o - 1) * (kLayers + 3) + kLayers], dst);
      else
        gauss_blur_f32(P.gauss[o * (kLayers + 3) + i - 1], dst, sig[i]);
    }
  P.dog.assign(octaves * (kLayers + 2), FImg());
  for (int o = 0; o < octaves; ++o)
    for (int i = 0; i < kLayers + 2; ++i) {
      const FImg& a = P.gauss[o * (kLayers + 3) + i];
      const FImg& b = P.gauss[o * (kLayers + 3) + i + 1];
      FImg& dst = P.dog[o * (kLayers + 2) + i];
      dst.create(a.w, a.h);
      parallel_chunks(a.h, [&](int y0, int y1) {
        for (size_t q = static_cast<size_t>(y0) * a.w; q < static_cast<size_t>(y1) * a.w; ++q)
          dst.d[q] = b.d[q] - a.d[q];
      });
    }
}

// findScaleSpaceExtrema: the candidates of each row, refined and given
// their orientations
void find_extrema(const SiftPyramid& P, std::vector<KeyPoint>& kps) {
  const float threshold = static_cast<float>(cv_floor(0.5 * kContrast / kLayers * 255 * 1));
  for (int o = 0; o < P.octaves; ++o)
    for (int i = 1; i <= kLayers; ++i) {
      const int idx = o * (kLayers + 2) + i;
      const FImg &img = P.dog[idx], &prev = P.dog[idx - 1], &next = P.dog[idx + 1];
      const int rows = img.h, cols = img.w;
      if (rows - kBorder <= kBorder) continue;
      std::vector<std::vector<KeyPoint>> found(rows);
      parallel_chunks(rows - 2 * kBorder, [&](int b, int e) {
        float hist[kOriBins];
        for (int r = b + kBorder; r < e + kBorder; ++r) {
          for (int c = kBorder; c < cols - kBorder; ++c) {
            const float val = img.at(r, c);
            if (!(std::abs(val) > threshold)) continue;
            bool ext = true;
            const FImg* layers[3] = {&img, &prev, &next};
            for (int q = 0; q < 3 && ext; ++q)
              for (int dy = -1; dy <= 1 && ext; ++dy)
                for (int dx = -1; dx <= 1 && ext; ++dx) {
                  if (q == 0 && dy == 0 && dx == 0) continue;
                  const float v = layers[q]->at(r + dy, c + dx);
                  ext = val > 0 ? val >= v : val <= v;
                }
            if (!ext) continue;
            KeyPoint kpt;
            int r1 = r, c1 = c, layer = i;
            if (!adjust_local_extrema(P, kpt, o, layer, r1, c1)) continue;
            const float scl_octv = kpt.size * 0.5f / static_cast<float>(1 << o);
            const float omax = orientation_hist(P.gauss[o * (kLayers + 3) + layer], c1, r1,
                                                cv_round(kOriRadius * scl_octv),
                                                kOriSig * scl_octv, hist);
            const float mag_thr = omax * kOriPeak;
            const int n = kOriBins;
            for (int j = 0; j < n; ++j) {
              const int l = j > 0 ? j - 1 : n - 1, r2 = j < n - 1 ? j + 1 : 0;
              if (hist[j] > hist[l] && hist[j] > hist[r2] && hist[j] >= mag_thr) {
                float bin = static_cast<float>(j) + 0.5f * (hist[l] - hist[r2]) /
                                                        (hist[l] - 2 * hist[j] + hist[r2]);
                bin = bin < 0 ? n + bin : bin >= n ? bin - n : bin;
                kpt.angle = std::fmaf(-(360.f / n), bin, 360.f);
                if (std::abs(kpt.angle - 360.f) < FLT_EPSILON) kpt.angle = 0.f;
                found[r].push_back(kpt);
              }
            }
          }
        }
      });
      for (auto& v : found) kps.insert(kps.end(), v.begin(), v.end());
    }
}

// SIFT_create() detectAndCompute on a gray image
void sift_detect_and_compute(const uint8_t* img, int W, int H, Features& out) {
  out.kps.clear(), out.desc.clear();
  SiftPyramid P;
  build_pyramid(img, W, H, P);
  std::vector<KeyPoint> kps;
  find_extrema(P, kps);
  // removeDuplicatedSorted
  if (kps.size() >= 2) {
    std::sort(kps.begin(), kps.end(), keypoint_less);
    size_t i = 0;
    for (size_t j = 1; j < kps.size(); ++j) {
      const KeyPoint &a = kps[i], &b = kps[j];
      if (a.x != b.x || a.y != b.y || a.size != b.size || a.angle != b.angle) kps[++i] = kps[j];
    }
    kps.resize(i + 1);
  }
  const int first = -1;
  for (KeyPoint& k : kps) {
    const float scale = 1.f / static_cast<float>(1 << -first);
    k.octave = (k.octave & ~255) | ((k.octave + first) & 255);
    k.x *= scale, k.y *= scale, k.size *= scale;
  }
  out.kps = kps;
  const int n = static_cast<int>(kps.size());
  out.desc.assign(static_cast<size_t>(n) * 128 * 4, 0);
  float* desc = reinterpret_cast<float*>(out.desc.data());
  parallel_chunks(n, [&](int b, int e) {
    for (int i = b; i < e; ++i) {
      const KeyPoint& k = kps[i];
      int octave = k.octave & 255;
      const int layer = (k.octave >> 8) & 255;
      octave = octave < 128 ? octave : (-128 | octave);
      const float scale = octave >= 0 ? 1.f / static_cast<float>(1 << octave)
                                      : static_cast<float>(1 << -octave);
      const float size = k.size * scale;
      const FImg& g = P.gauss[(octave - first) * (kLayers + 3) + layer];
      float angle = 360.f - k.angle;
      if (std::abs(angle - 360.f) < FLT_EPSILON) angle = 0.f;
      sift_descriptor(g, k.x * scale, k.y * scale, angle, size * 0.5f, desc + 128 * i);
    }
  });
}

}  // namespace

extern "C" {

// A detector's result: keypoints and descriptors, kept until freed.
void* mgdt_feat_orb(const uint8_t* img, int H, int W, int nfeatures) {
  Features* f = new Features;
  orb_detect_and_compute(img, W, H, nfeatures, *f);
  return f;
}

void* mgdt_feat_sift(const uint8_t* img, int H, int W) {
  Features* f = new Features;
  sift_detect_and_compute(img, W, H, *f);
  return f;
}

int mgdt_feat_count(const void* h) {
  return static_cast<int>(static_cast<const Features*>(h)->kps.size());
}

// the keypoints as (n, 7) float64 (x, y, size, angle, response, octave,
// class_id) and the descriptors ((n, 32) uint8 or (n, 128) float32)
void mgdt_feat_get(const void* h, double* kps, void* desc) {
  const Features* f = static_cast<const Features*>(h);
  for (size_t i = 0; i < f->kps.size(); ++i) {
    const KeyPoint& k = f->kps[i];
    double* o = kps + 7 * i;
    o[0] = k.x, o[1] = k.y, o[2] = k.size, o[3] = k.angle, o[4] = k.response;
    o[5] = k.octave, o[6] = k.class_id;
  }
  if (!f->desc.empty()) std::memcpy(desc, f->desc.data(), f->desc.size());
}

void mgdt_feat_free(void* h) { delete static_cast<Features*>(h); }

// BFMatcher(NORM_HAMMING for kind 0 on (n, 32) uint8, NORM_L2 for kind 1
// on (n, 128) float32).match(query, train): the nearest train row of each
// query row, the first among equals, and its distance
void mgdt_feat_match(const void* query, int nq, const void* train, int nt, int kind, int* idx,
                     float* dist) {
  parallel_chunks(nq, [&](int b, int e) {
    for (int q = b; q < e; ++q) {
      int best = -1;
      if (kind == 0) {
        const uint8_t* a = static_cast<const uint8_t*>(query) + 32 * static_cast<size_t>(q);
        int bd = INT_MAX;
        for (int t = 0; t < nt; ++t) {
          const uint8_t* c = static_cast<const uint8_t*>(train) + 32 * static_cast<size_t>(t);
          int dd = 0;
          for (int i = 0; i < 32; ++i) dd += __builtin_popcount(static_cast<unsigned>(a[i] ^ c[i]));
          if (dd < bd) bd = dd, best = t;
        }
        dist[q] = static_cast<float>(bd);
      } else {
        const float* a = static_cast<const float*>(query) + 128 * static_cast<size_t>(q);
        float bd = FLT_MAX;
        for (int t = 0; t < nt; ++t) {
          const float* c = static_cast<const float*>(train) + 128 * static_cast<size_t>(t);
          // the descriptors hold integers, so this sum is exact in any order
          double s = 0;
          for (int i = 0; i < 128; ++i) {
            const double dd = static_cast<double>(a[i]) - c[i];
            s += dd * dd;
          }
          const float dd = std::sqrt(static_cast<float>(s));
          if (dd < bd) bd = dd, best = t;
        }
        dist[q] = bd;
      }
      idx[q] = best;
    }
  });
}

// The stages, for the tests: resize(INTER_LINEAR_EXACT), ORB's level blur,
// FAST's corners (x, y, response; returns the count, at most cap),
// fastAtan2 (scalar), SIFT's hal::fastAtan32f and hal::exp32f (arrays),
// GaussianBlur of a float image and SIFT's base image
void mgdt_feat_resize_exact(const uint8_t* src, int sh, int sw, uint8_t* dst, int dh, int dw) {
  resize_linear_exact(src, sw, sh, dst, dw, dh);
}

void mgdt_feat_orb_blur(const uint8_t* src, int H, int W, uint8_t* dst) { orb_blur(src, W, H, dst); }

int mgdt_feat_fast(const uint8_t* src, int H, int W, int threshold, float* xyr, int cap) {
  const std::vector<KeyPoint> k = fast_detect(src, W, H, threshold);
  const int n = std::min(cap, static_cast<int>(k.size()));
  for (int i = 0; i < n; ++i) xyr[3 * i] = k[i].x, xyr[3 * i + 1] = k[i].y, xyr[3 * i + 2] = k[i].response;
  return static_cast<int>(k.size());
}

float mgdt_feat_fast_atan2(float y, float x) { return fast_atan2(y, x); }

void mgdt_feat_phase(const float* y, const float* x, int n, float* out) {
  for (int i = 0; i < n; ++i) out[i] = fast_atan2_fused(y[i], x[i]);
}

void mgdt_feat_exp(const float* x, int n, float* out) {
  for (int i = 0; i < n; ++i) out[i] = exp_ipp(x[i]);
}

void mgdt_feat_gauss_f32(const float* src, int H, int W, double sigma, float* dst) {
  FImg s, d;
  s.create(W, H);
  std::memcpy(s.d.data(), src, s.d.size() * 4);
  gauss_blur_f32(s, d, sigma);
  std::memcpy(dst, d.d.data(), d.d.size() * 4);
}

// the SIFT base image (2H, 2W) float32
void mgdt_feat_sift_base(const uint8_t* img, int H, int W, float* dst) {
  FImg b;
  sift_base(img, W, H, b);
  std::memcpy(dst, b.d.data(), b.d.size() * 4);
}

}  // extern "C"
