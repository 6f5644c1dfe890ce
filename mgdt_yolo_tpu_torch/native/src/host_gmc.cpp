// The camera-motion compensation of BoT-SORT (`tracker/gmc.py`) in C++,
// without OpenCV: the four OpenCV calls the tracker's GMC makes, each
// following OpenCV's own arithmetic so its result is OpenCV's
// (`tests/test_torch_gmc.py` holds each against cv2):
//
// * `mgdt_gmc_corners`: goodFeaturesToTrack(maxCorners, qualityLevel,
//   minDistance 1, blockSize 3, gradientSize 3) on a gray uint8 image: the
//   minimum eigenvalue of the 2 x 2 structure tensor of 3 x 3 Sobel
//   derivatives scaled by 1 / (4 * 3 * 255), summed over a 3 x 3 block
//   (reflect-101 borders), its local maxima of a 3 x 3 dilation above
//   qualityLevel times the largest, sorted by value (ties: the later pixel
//   first).
// * `mgdt_gmc_lk`: calcOpticalFlowPyrLK at OpenCV's defaults (21 x 21
//   window, 3 levels, 30 iterations or a step under 0.01 px, minimum
//   eigenvalue 1e-4): pyrDown's pyramid padded by reflect-101, Scharr
//   derivatives in int16 padded by zeros, 14-bit fixed-point bilinear
//   weights, the per-point status rules.
// * `mgdt_gmc_affine_partial`: estimateAffinePartial2D(method=RANSAC) at
//   OpenCV's defaults (3 px, 2000 iterations, confidence 0.99, 10
//   Levenberg-Marquardt steps on the inliers), with OpenCV's
//   multiply-with-carry generator seeded as OpenCV seeds it, so the
//   subsets drawn and the inliers found are OpenCV's.
// * `mgdt_gmc_ecc`: findTransformECC(MOTION_EUCLIDEAN) with its 5 x 5
//   Gaussian pre-filter, returning 1 where OpenCV raises.
//
// The float arithmetic follows OpenCV's builds for x86-64: where OpenCV's
// vector code fuses a multiply and an add (its AVX2 paths), `fmaf` does
// here, and nowhere else; the build turns the compiler's own contraction
// off (`-ffp-contract=off`).
//
// The loops run on a pool of up to 8 threads (`parallel_for`); every sum
// is kept per row or per point and combined in order, so the results do
// not depend on the number of threads.
//
// The ORB and SIFT features and their matcher are host_features.cpp, built
// into the same library.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -ffp-contract=off [-mfma] host_gmc.cpp
//        host_features.cpp -lpthread (see mgdt_yolo_tpu_torch/utils/build.py,
//        which builds it at first use, with -mfma where the CPU has the
//        instruction: the same bits, faster).

#include <algorithm>
#include <condition_variable>
#include <cfloat>
#include <cstddef>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <mutex>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

inline int reflect101(int p, int n) {
  if (n == 1) return 0;
  while (p < 0 || p >= n) p = p < 0 ? -p : 2 * n - 2 - p;
  return p;
}

// the threads of `parallel_for`: set by the caller (`mgdt_gmc_set_threads`,
// from the CPUs the process may run on), else the hardware's count
int g_threads = 0;

int thread_count() {
  const int hw =
      g_threads > 0 ? g_threads : static_cast<int>(std::thread::hardware_concurrency());
  return std::max(1, std::min(hw > 0 ? hw : 1, 8));
}

// A pool of workers that stay up between calls (a thread's start costs
// more than a small loop on some hosts): `run(nt, job)` runs job(t) for t
// in [0, nt) on the caller and nt - 1 workers and returns when all are done.
// It is never destroyed: its workers wait until the process ends, and a
// child made by fork() (which has none of them) makes a pool of its own.
class Pool {
 public:
  const pid_t pid = getpid();
  void run(int nt, const std::function<void(int)>& job) {
    std::lock_guard<std::mutex> serial(run_mu_);  // one loop at a time
    while (static_cast<int>(workers_.size()) < nt - 1) {
      const int id = static_cast<int>(workers_.size()) + 1;
      workers_.emplace_back([this, id] { loop(id); });
    }
    {
      std::lock_guard<std::mutex> lk(mu_);
      job_ = &job, nt_ = nt, pending_ = nt - 1, ++gen_;
    }
    cv_.notify_all();
    job(0);
    std::unique_lock<std::mutex> lk(mu_);
    done_.wait(lk, [this] { return pending_ == 0; });
    job_ = nullptr;
  }

 private:
  void loop(int id) {
    unsigned seen = 0;
    for (;;) {
      const std::function<void(int)>* job;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [&] { return gen_ != seen; });
        seen = gen_;
        if (id >= nt_) continue;
        job = job_;
      }
      (*job)(id);
      std::lock_guard<std::mutex> lk(mu_);
      if (--pending_ == 0) done_.notify_one();
    }
  }
  std::vector<std::thread> workers_;
  std::mutex mu_, run_mu_;
  std::condition_variable cv_, done_;
  const std::function<void(int)>* job_ = nullptr;
  int nt_ = 0, pending_ = 0;
  unsigned gen_ = 0;
};

Pool& pool() {
  static Pool* p = new Pool;
  if (p->pid != getpid()) p = new Pool;
  return *p;
}

// fn(begin, end) over [0, n) in contiguous chunks, one a thread of
// `thread_count()`. Every caller keeps its results per index and combines
// them in index order, so the result does not depend on the number of
// threads.
template <typename F>
void parallel_for(int n, F fn) {
  const int nt = std::max(1, std::min(thread_count(), n));
  if (nt == 1) {
    fn(0, n);
    return;
  }
  const int chunk = (n + nt - 1) / nt;
  pool().run(nt, [&](int t) {
    const int b = t * chunk, e = std::min(n, b + chunk);
    if (b < e) fn(b, e);
  });
}

// ---------------------------------------------------------------------------
// cornerMinEigenVal(src, blockSize 3, ksize 3), BORDER_REFLECT_101
// ---------------------------------------------------------------------------

// Sobel(src, CV_32F, dx, dy, 3, scale): OpenCV's separable filter. The row
// pass of an 8-bit source to float runs its vector code (a chain of fused
// multiply-adds) on the first (W / 32) * 32 columns and plain float code on
// the rest; the column pass of the smoothing kernel is
// fma(S0 + S2, f1, S1 * f0).
void sobel3(const uint8_t* src, int H, int W, float scale, float* dx, float* dy) {
  const float f = scale, f2 = 2.0f * scale;
  const int vec = (W / 32) * 32;
  std::vector<float> rx(static_cast<size_t>(H) * W), ry(static_cast<size_t>(H) * W);
  parallel_for(H, [&](int b, int e) {
    for (int y = b; y < e; ++y) {
      const uint8_t* s = src + static_cast<size_t>(y) * W;
      float* ox = &rx[static_cast<size_t>(y) * W];
      float* oy = &ry[static_cast<size_t>(y) * W];
      for (int x = 0; x < W; ++x) {
        const float a = s[x > 0 ? x - 1 : reflect101(-1, W)], m = s[x];
        const float c = s[x < W - 1 ? x + 1 : reflect101(W, W)];
        ox[x] = c - a;  // [-1, 0, 1]: exact
        if (x < vec) {
          oy[x] = std::fmaf(c, f, std::fmaf(m, f2, a * f));
        } else {
          float t = a * f;
          t = t + m * f2;
          oy[x] = t + c * f;
        }
      }
    }
  });
  parallel_for(H, [&](int b, int e) {
    for (int y = b; y < e; ++y) {
      const float* x0 = &rx[static_cast<size_t>(reflect101(y - 1, H)) * W];
      const float* x1 = &rx[static_cast<size_t>(y) * W];
      const float* x2 = &rx[static_cast<size_t>(reflect101(y + 1, H)) * W];
      const float* y0 = &ry[static_cast<size_t>(reflect101(y - 1, H)) * W];
      const float* y2 = &ry[static_cast<size_t>(reflect101(y + 1, H)) * W];
      float* odx = dx + static_cast<size_t>(y) * W;
      float* ody = dy + static_cast<size_t>(y) * W;
      for (int x = 0; x < W; ++x) {
        odx[x] = std::fmaf(x0[x] + x2[x], f, x1[x] * f2);
        ody[x] = y2[x] - y0[x];
      }
    }
  });
}

}  // namespace

// `parallel_for` for the other source of this library (host_features.cpp)
namespace mgdt_gmc {
void parallel_chunks(int n, const std::function<void(int, int)>& fn) { parallel_for(n, fn); }
}  // namespace mgdt_gmc

extern "C" {

// the number of threads `parallel_for` uses (at most 8); returns the count
// it will use for a large loop
int mgdt_gmc_set_threads(int n) {
  g_threads = n;
  return thread_count();
}

// cornerMinEigenVal(src (H, W) uint8, 3, 3) into eig (H, W) float32.
void mgdt_gmc_min_eig(const uint8_t* src, int H, int W, float* eig) {
  const size_t n = static_cast<size_t>(H) * W;
  std::vector<float> dx(n), dy(n);
  sobel3(src, H, W, static_cast<float>(1.0 / (4.0 * 3.0 * 255.0)), dx.data(), dy.data());
  // the products (float), summed over a 3 x 3 block in double as boxFilter
  // sums them: the row sums of three, then OpenCV's sliding column sum,
  // where the running sum of two rows plus the next row is the output and
  // the oldest row is then taken off. The products can be as small as 1e-16
  // beside values near 1, so the sums round, and their order is kept
  std::vector<double> rs(3 * n);
  parallel_for(H, [&](int b, int e) {
    std::vector<float> c(3 * static_cast<size_t>(W));
    for (int y = b; y < e; ++y) {
      const size_t r = static_cast<size_t>(y) * W;
      for (int x = 0; x < W; ++x) {
        const float gx = dx[r + x], gy = dy[r + x];
        c[3 * x] = gx * gx, c[3 * x + 1] = gx * gy, c[3 * x + 2] = gy * gy;
      }
      double* o = &rs[3 * r];
      for (int x = 0; x < W; ++x) {
        const float* ca = &c[3 * (x > 0 ? x - 1 : reflect101(-1, W))];
        const float* cb = &c[3 * x];
        const float* cc = &c[3 * (x < W - 1 ? x + 1 : reflect101(W, W))];
        for (int k = 0; k < 3; ++k) o[3 * x + k] = (static_cast<double>(ca[k]) + cb[k]) + cc[k];
      }
    }
  });
  const size_t w3 = 3 * static_cast<size_t>(W);
  parallel_for(W, [&](int b, int e) {  // the columns are independent
    const size_t c0 = 3 * static_cast<size_t>(b), c1 = 3 * static_cast<size_t>(e);
    std::vector<double> sum(c1 - c0, 0.0);
    for (int k = -1; k < 1; ++k) {
      const double* sp = &rs[static_cast<size_t>(reflect101(k, H)) * w3];
      for (size_t i = c0; i < c1; ++i) sum[i - c0] += sp[i];
    }
    for (int y = 0; y < H; ++y) {
      const double* sp = &rs[static_cast<size_t>(reflect101(y + 1, H)) * w3];
      const double* sm = &rs[static_cast<size_t>(reflect101(y - 1, H)) * w3];
      float* out = eig + static_cast<size_t>(y) * W;
      for (int x = b; x < e; ++x) {
        float box[3];
        for (int k = 0; k < 3; ++k) {
          const size_t i = 3 * static_cast<size_t>(x) + k;
          const double s0 = sum[i - c0] + sp[i];
          box[k] = static_cast<float>(s0);
          sum[i - c0] = s0 - sm[i];
        }
        const float a = box[0] * 0.5f, bb = box[1], c = box[2] * 0.5f;
        const float t = a - c;
        out[x] = (a + c) - std::sqrt(t * t + bb * bb);
      }
    }
  });
}

// cvtColor(BGR2GRAY) of src (H, W, 3) uint8, then with `half` resize to
// (W / 2, H / 2) by INTER_LINEAR, which cv2 takes by INTER_AREA's rounded
// mean of each 2 x 2 block at this ratio (H and W even), into dst
void mgdt_gmc_gray(const uint8_t* src, int H, int W, int half, uint8_t* dst) {
  auto gray = [](const uint8_t* p) {
    return (p[0] * 3735 + p[1] * 19235 + p[2] * 9798 + (1 << 14)) >> 15;
  };
  if (!half) {
    parallel_for(H, [&](int b, int e) {
      for (size_t i = static_cast<size_t>(b) * W; i < static_cast<size_t>(e) * W; ++i)
        dst[i] = static_cast<uint8_t>(gray(src + 3 * i));
    });
    return;
  }
  const int h = H / 2, w = W / 2;
  parallel_for(h, [&](int b, int e) {
    for (int y = b; y < e; ++y) {
      const uint8_t* r0 = src + static_cast<size_t>(2 * y) * W * 3;
      const uint8_t* r1 = r0 + static_cast<size_t>(W) * 3;
      for (int x = 0; x < w; ++x) {
        const int s = gray(r0 + 6 * x) + gray(r0 + 6 * x + 3) + gray(r1 + 6 * x) +
                      gray(r1 + 6 * x + 3);
        dst[static_cast<size_t>(y) * w + x] = static_cast<uint8_t>((s + 2) >> 2);
      }
    }
  });
}

// goodFeaturesToTrack(src (H, W) uint8, max_corners, quality, minDistance 1,
// blockSize 3) into xy (max_corners, 2) float32; returns the count.
int mgdt_gmc_corners(const uint8_t* src, int H, int W, int max_corners, double quality,
                     float* xy) {
  const size_t n = static_cast<size_t>(H) * W;
  std::vector<float> eig(n);
  mgdt_gmc_min_eig(src, H, W, eig.data());
  std::vector<float> row_max(H, 0.f);  // minMaxLoc's maximum, over every pixel
  parallel_for(H, [&](int b, int e) {
    for (int y = b; y < e; ++y)
      for (int x = 0; x < W; ++x)
        row_max[y] = std::max(row_max[y], eig[static_cast<size_t>(y) * W + x]);
  });
  double max_val = 0;
  for (float v : row_max) max_val = std::max(max_val, static_cast<double>(v));
  const float thresh = static_cast<float>(max_val * quality);  // THRESH_TOZERO
  for (size_t i = 0; i < n; ++i)
    if (!(eig[i] > thresh)) eig[i] = 0.f;
  // a local maximum of the 3 x 3 dilation, not on the image's edge; the
  // candidates of each row, then the rows in order
  std::vector<std::vector<int>> rows(H);
  parallel_for(H, [&](int b, int e) {
    for (int y = std::max(b, 1); y < std::min(e, H - 1); ++y) {
      for (int x = 1; x < W - 1; ++x) {
        const size_t i = static_cast<size_t>(y) * W + x;
        const float v = eig[i];
        if (v == 0.f) continue;
        float m = v;
        for (int dy = -1; dy <= 1; ++dy)
          for (int dx = -1; dx <= 1; ++dx) m = std::max(m, eig[i + dy * W + dx]);
        if (v == m) rows[y].push_back(static_cast<int>(i));
      }
    }
  });
  std::vector<int> cand;
  for (const auto& r : rows) cand.insert(cand.end(), r.begin(), r.end());
  // descending value; of equal values the later pixel (the higher address)
  // first. At minDistance 1 cv2's distance grid rejects no corner (two
  // pixels are never closer than 1), so the first max_corners are taken
  const size_t k = std::min(cand.size(), static_cast<size_t>(std::max(max_corners, 0)));
  std::partial_sort(cand.begin(), cand.begin() + k, cand.end(), [&](int a, int b) {
    return eig[a] > eig[b] || (eig[a] == eig[b] && a > b);
  });
  for (size_t i = 0; i < k; ++i) {
    xy[2 * i] = static_cast<float>(cand[i] % W);
    xy[2 * i + 1] = static_cast<float>(cand[i] / W);
  }
  return static_cast<int>(k);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// calcOpticalFlowPyrLK
// ---------------------------------------------------------------------------

namespace {

// An image of one pyramid level with `pad` pixels of border on each side,
// stored as OpenCV stores it: rows of (w + 2 pad) elements of `cn`
// channels, one after another, with spare zeroed rows after the last so
// that a read past the end (which OpenCV makes into memory beyond its
// buffer, with a weight that is then 0 or nearly) stays in bounds.
template <typename T>
struct Padded {
  int w = 0, h = 0, pad = 0, cn = 1;
  std::vector<T> buf;
  int step() const { return (w + 2 * pad) * cn; }
  void alloc(int w_, int h_, int pad_, int cn_) {
    w = w_, h = h_, pad = pad_, cn = cn_;
    buf.assign(static_cast<size_t>(h + 2 * pad + 2) * step() + 2 * cn, T(0));
  }
  T* at(int y, int x) {
    return buf.data() + static_cast<ptrdiff_t>(y + pad) * step() + (x + pad) * cn;
  }
  const T* at(int y, int x) const {
    return buf.data() + static_cast<ptrdiff_t>(y + pad) * step() + (x + pad) * cn;
  }
  // copyMakeBorder(BORDER_REFLECT_101) of the interior into the border
  void reflect_border() {
    for (int y = 0; y < h; ++y) {
      T* row = at(y, 0);
      for (int x = -pad; x < 0; ++x) row[x] = row[reflect101(x, w)];
      for (int x = w; x < w + pad; ++x) row[x] = row[reflect101(x, w)];
    }
    for (int y = -pad; y < 0; ++y)
      std::memcpy(at(y, -pad), at(reflect101(y, h), -pad), step() * sizeof(T));
    for (int y = h; y < h + pad; ++y)
      std::memcpy(at(y, -pad), at(reflect101(y, h), -pad), step() * sizeof(T));
  }
};

// pyrDown: the 5 x 5 kernel [1 4 6 4 1]^2 / 256 at every second pixel,
// reflect-101 borders, into ((w + 1) / 2, (h + 1) / 2)
void pyr_down(const Padded<uint8_t>& src, Padded<uint8_t>& dst, int pad) {
  const int sw = src.w, sh = src.h, dw = (sw + 1) / 2, dh = (sh + 1) / 2;
  dst.alloc(dw, dh, pad, 1);
  // the horizontal pass of every source row, then the vertical one
  std::vector<int> rows(static_cast<size_t>(sh) * dw);
  parallel_for(sh, [&](int b, int e) {
    for (int y = b; y < e; ++y) {
      const uint8_t* s = src.at(y, 0);
      int* r = &rows[static_cast<size_t>(y) * dw];
      for (int x = 0; x < dw; ++x) {
        const int c = 2 * x;
        if (c >= 2 && c + 2 < sw) {
          r[x] = s[c - 2] + 4 * s[c - 1] + 6 * s[c] + 4 * s[c + 1] + s[c + 2];
        } else {
          r[x] = s[reflect101(c - 2, sw)] + 4 * s[reflect101(c - 1, sw)] + 6 * s[c] +
                 4 * s[reflect101(c + 1, sw)] + s[reflect101(c + 2, sw)];
        }
      }
    }
  });
  parallel_for(dh, [&](int b, int e) {
    for (int y = b; y < e; ++y) {
      const int* r[5];
      for (int t = 0; t < 5; ++t)
        r[t] = &rows[static_cast<size_t>(reflect101(2 * y + t - 2, sh)) * dw];
      uint8_t* d = dst.at(y, 0);
      for (int x = 0; x < dw; ++x)
        d[x] = static_cast<uint8_t>(
            (r[0][x] + 4 * r[1][x] + 6 * r[2][x] + 4 * r[3][x] + r[4][x] + 128) >> 8);
    }
  });
  dst.reflect_border();
}

// calcSharrDeriv: (Ix, Iy) int16 of the 3 x 3 Scharr kernels [3 10 3] x
// [-1 0 1], reflect-101 borders; the border of the result stays 0
void scharr(const Padded<uint8_t>& src, Padded<int16_t>& dst, int pad) {
  const int w = src.w, h = src.h;
  dst.alloc(w, h, pad, 2);
  std::vector<int> t0(w + 2), t1(w + 2);
  for (int y = 0; y < h; ++y) {
    const uint8_t* s0 = src.at(reflect101(y - 1, h), 0);
    const uint8_t* s1 = src.at(y, 0);
    const uint8_t* s2 = src.at(reflect101(y + 1, h), 0);
    for (int x = 0; x < w; ++x) {
      t0[x + 1] = static_cast<int16_t>((s0[x] + s2[x]) * 3 + s1[x] * 10);
      t1[x + 1] = static_cast<int16_t>(s2[x] - s0[x]);
    }
    const int x0 = w > 1 ? 1 : 0, x1 = w > 1 ? w - 2 : 0;
    t0[0] = t0[x0 + 1], t0[w + 1] = t0[x1 + 1];
    t1[0] = t1[x0 + 1], t1[w + 1] = t1[x1 + 1];
    int16_t* d = dst.at(y, 0);
    for (int x = 0; x < w; ++x) {
      d[2 * x] = static_cast<int16_t>(t0[x + 2] - t0[x]);
      d[2 * x + 1] = static_cast<int16_t>((t1[x + 2] + t1[x]) * 3 + t1[x + 1] * 10);
    }
  }
}

inline int descale(int x, int n) { return (x + (1 << (n - 1))) >> n; }

// OpenCV's SSE2 horizontal sum of four float lanes: (l0 + l2) + (l1 + l3)
inline float reduce4(const float* l) { return (l[0] + l[2]) + (l[1] + l[3]); }

struct LKParams {
  int win, max_level, max_count;
  double eps2;
  float min_eig;
};

// one point at one level: LKTrackerInvoker's body
void lk_point(const Padded<uint8_t>& I, const Padded<int16_t>& dI, const Padded<uint8_t>& J,
              const LKParams& p, int level, const float* prev_pt, float* next_pt,
              uint8_t* status) {
  const int win = p.win, W_BITS = 14, W_BITS1 = 14;
  const float FLT_SCALE = 1.f / (1 << 20);
  const float half = (win - 1) * 0.5f;
  const float lscale = static_cast<float>(1. / (1 << level));
  float px = prev_pt[0] * lscale, py = prev_pt[1] * lscale;
  float nx, ny;
  if (level == p.max_level) {
    nx = px, ny = py;
  } else {
    nx = next_pt[0] * 2.f, ny = next_pt[1] * 2.f;
  }
  next_pt[0] = nx, next_pt[1] = ny;
  px -= half, py -= half;
  const int ipx = static_cast<int>(std::floor(px)), ipy = static_cast<int>(std::floor(py));
  if (ipx < -win || ipx >= dI.w || ipy < -win || ipy >= dI.h) {
    if (level == 0) *status = 0;
    return;
  }
  float a = px - ipx, b = py - ipy;
  int iw00 = static_cast<int>(std::nearbyint((1.f - a) * (1.f - b) * (1 << W_BITS)));
  int iw01 = static_cast<int>(std::nearbyint(a * (1.f - b) * (1 << W_BITS)));
  int iw10 = static_cast<int>(std::nearbyint((1.f - a) * b * (1 << W_BITS)));
  int iw11 = (1 << W_BITS) - iw00 - iw01 - iw10;
  const int stepI = I.step(), dstep = dI.step(), stepJ = J.step();
  const size_t area = static_cast<size_t>(win) * win;
  std::vector<int16_t> Iwin(area), dIwin(2 * area);
  // A: four vector lanes over the columns below the last multiple of 8
  // (lane k takes the columns k mod 4), the rest in one scalar sum
  float qA11[4] = {0, 0, 0, 0}, qA12[4] = {0, 0, 0, 0}, qA22[4] = {0, 0, 0, 0};
  float iA11 = 0, iA12 = 0, iA22 = 0;
  const int vec = (win / 8) * 8;
  for (int y = 0; y < win; ++y) {
    const uint8_t* src = I.at(ipy + y, ipx);
    const int16_t* dsrc = dI.at(ipy + y, ipx);
    for (int x = 0; x < win; ++x) {
      int ival = descale(src[x] * iw00 + src[x + 1] * iw01 + src[x + stepI] * iw10 +
                         src[x + stepI + 1] * iw11, W_BITS1 - 5);
      const int16_t* d = dsrc + 2 * x;
      int ixval = descale(d[0] * iw00 + d[2] * iw01 + d[dstep] * iw10 + d[dstep + 2] * iw11,
                          W_BITS1);
      int iyval = descale(d[1] * iw00 + d[3] * iw01 + d[dstep + 1] * iw10 +
                          d[dstep + 3] * iw11, W_BITS1);
      Iwin[static_cast<size_t>(y) * win + x] = static_cast<int16_t>(ival);
      dIwin[2 * (static_cast<size_t>(y) * win + x)] = static_cast<int16_t>(ixval);
      dIwin[2 * (static_cast<size_t>(y) * win + x) + 1] = static_cast<int16_t>(iyval);
      const float fx = static_cast<float>(static_cast<int16_t>(ixval));
      const float fy = static_cast<float>(static_cast<int16_t>(iyval));
      if (x < vec) {
        const int l = x & 3;
        qA22[l] = qA22[l] + fy * fy;
        qA12[l] = qA12[l] + fx * fy;
        qA11[l] = qA11[l] + fx * fx;
      } else {
        iA11 += static_cast<float>(ixval * ixval);
        iA12 += static_cast<float>(ixval * iyval);
        iA22 += static_cast<float>(iyval * iyval);
      }
    }
  }
  if (vec > 0) {
    iA11 += reduce4(qA11);
    iA12 += reduce4(qA12);
    iA22 += reduce4(qA22);
  }
  float A11 = iA11 * FLT_SCALE, A12 = iA12 * FLT_SCALE, A22 = iA22 * FLT_SCALE;
  float D = A11 * A22 - A12 * A12;
  float t = A11 - A22;
  float minEig = (A22 + A11 - std::sqrt(t * t + 4.f * A12 * A12)) /
                 static_cast<float>(2 * win * win);
  if (minEig < p.min_eig || D < FLT_EPSILON) {
    if (level == 0) *status = 0;
    return;
  }
  D = 1.f / D;
  nx -= half, ny -= half;
  float pdx = 0, pdy = 0;
  for (int j = 0; j < p.max_count; ++j) {
    const int inx = static_cast<int>(std::floor(nx)), iny = static_cast<int>(std::floor(ny));
    if (inx < -win || inx >= J.w || iny < -win || iny >= J.h) {
      if (level == 0) *status = 0;
      break;
    }
    a = nx - inx, b = ny - iny;
    iw00 = static_cast<int>(std::nearbyint((1.f - a) * (1.f - b) * (1 << W_BITS)));
    iw01 = static_cast<int>(std::nearbyint(a * (1.f - b) * (1 << W_BITS)));
    iw10 = static_cast<int>(std::nearbyint((1.f - a) * b * (1 << W_BITS)));
    iw11 = (1 << W_BITS) - iw00 - iw01 - iw10;
    // b: per 8 columns, pairs (k, k + 4) summed in int32, then to float in
    // four lanes; lanes 0 and 2 hold the x terms of the pairs (0, 4),
    // (2, 6) and (1, 5), (3, 7) summed, 1 and 3 the y terms
    float qb0[4] = {0, 0, 0, 0}, qb1[4] = {0, 0, 0, 0};
    float ib1 = 0, ib2 = 0;
    for (int y = 0; y < win; ++y) {
      const uint8_t* Jp = J.at(iny + y, inx);
      const int16_t* Ip = &Iwin[static_cast<size_t>(y) * win];
      const int16_t* dIp = &dIwin[2 * static_cast<size_t>(y) * win];
      int diff[32];
      for (int x = 0; x < win; ++x)
        diff[x] = descale(Jp[x] * iw00 + Jp[x + 1] * iw01 + Jp[x + stepJ] * iw10 +
                          Jp[x + stepJ + 1] * iw11, W_BITS1 - 5) - Ip[x];
      for (int x0 = 0; x0 < vec; x0 += 8) {
        int16_t d16[8];
        for (int k = 0; k < 8; ++k) d16[k] = static_cast<int16_t>(diff[x0 + k]);
        const int16_t* g = dIp + 2 * x0;
        for (int k = 0; k < 4; ++k) {
          const int px0 = k, px1 = k + 4;
          const float sx = static_cast<float>(d16[px0] * g[2 * px0] + d16[px1] * g[2 * px1]);
          const float sy =
              static_cast<float>(d16[px0] * g[2 * px0 + 1] + d16[px1] * g[2 * px1 + 1]);
          float* q = k < 2 ? qb0 : qb1;
          const int l = (k & 1) * 2;
          q[l] = q[l] + sx;
          q[l + 1] = q[l + 1] + sy;
        }
      }
      for (int x = vec; x < win; ++x) {
        ib1 += static_cast<float>(diff[x] * dIp[2 * x]);
        ib2 += static_cast<float>(diff[x] * dIp[2 * x + 1]);
      }
    }
    if (vec > 0) {
      const float s0 = qb0[0] + qb1[0], s1 = qb0[1] + qb1[1];
      const float s2 = qb0[2] + qb1[2], s3 = qb0[3] + qb1[3];
      ib1 += (s0 + 0.f) + (s2 + 0.f);
      ib2 += (s1 + 0.f) + (s3 + 0.f);
    }
    const float b1 = ib1 * FLT_SCALE, b2 = ib2 * FLT_SCALE;
    const float dx = (A12 * b2 - A22 * b1) * D, dy = (A12 * b1 - A11 * b2) * D;
    nx += dx, ny += dy;
    next_pt[0] = nx + half, next_pt[1] = ny + half;
    if (static_cast<double>(dx) * dx + static_cast<double>(dy) * dy <= p.eps2) break;
    if (j > 0 && std::fabs(dx + pdx) < 0.01 && std::fabs(dy + pdy) < 0.01) {
      next_pt[0] -= dx * 0.5f, next_pt[1] -= dy * 0.5f;
      break;
    }
    pdx = dx, pdy = dy;
  }
}

// buildOpticalFlowPyramid(img, (win, win), max_level, false): the levels,
// each padded by `win` pixels of reflect-101; returns the levels built - 1
int build_pyramid(const uint8_t* img, int H, int W, int win, int max_level,
                  std::vector<Padded<uint8_t>>& pyr) {
  pyr.assign(1, Padded<uint8_t>());
  pyr[0].alloc(W, H, win, 1);
  for (int y = 0; y < H; ++y) std::memcpy(pyr[0].at(y, 0), img + static_cast<size_t>(y) * W, W);
  pyr[0].reflect_border();
  int w = W, h = H;
  for (int level = 0; level <= max_level; ++level) {
    if (level != 0) {
      pyr.emplace_back();
      pyr_down(pyr[level - 1], pyr[level], win);
    }
    w = (w + 1) / 2, h = (h + 1) / 2;
    if (w <= win || h <= win) return level;
  }
  return max_level;
}

}  // namespace

extern "C" {

// calcOpticalFlowPyrLK(prev, next (H, W) uint8, pts (n, 2) float32) with
// the window `win`, `max_level`, `max_count` iterations or a step of at
// most `eps` px, and the eigenvalue floor `min_eig`: next_pts (n, 2) and
// status (n,).
void mgdt_gmc_lk(const uint8_t* prev, const uint8_t* next, int H, int W, const float* pts,
                 int n, int win, int max_level, int max_count, double eps, double min_eig,
                 float* next_pts, uint8_t* status) {
  for (int i = 0; i < n; ++i) status[i] = 1;
  if (n == 0) return;
  max_count = std::min(std::max(max_count, 0), 100);
  eps = std::min(std::max(eps, 0.), 10.);
  std::vector<Padded<uint8_t>> pp, np_;
  max_level = build_pyramid(prev, H, W, win, max_level, pp);
  max_level = build_pyramid(next, H, W, win, max_level, np_);
  const LKParams p{win, max_level, max_count, eps * eps, static_cast<float>(min_eig)};
  for (int level = max_level; level >= 0; --level) {
    Padded<int16_t> dI;
    scharr(pp[level], dI, win);
    parallel_for(n, [&](int b, int e) {
      for (int i = b; i < e; ++i)
        lk_point(pp[level], dI, np_[level], p, level, pts + 2 * i, next_pts + 2 * i, status + i);
    });
  }
}

// the level-`level` image of the pyramid of `img` and its Scharr
// derivatives, for the tests: out (h, w) uint8, deriv (h, w, 2) int16;
// returns 0, or -1 where the pyramid stops before `level`
int mgdt_gmc_pyramid_level(const uint8_t* img, int H, int W, int win, int level,
                           uint8_t* out, int16_t* deriv) {
  std::vector<Padded<uint8_t>> pyr;
  if (build_pyramid(img, H, W, win, level, pyr) < level) return -1;
  const Padded<uint8_t>& L = pyr[level];
  Padded<int16_t> d;
  scharr(L, d, win);
  for (int y = 0; y < L.h; ++y) {
    std::memcpy(out + static_cast<size_t>(y) * L.w, L.at(y, 0), L.w);
    std::memcpy(deriv + 2 * static_cast<size_t>(y) * L.w, d.at(y, 0), 4 * static_cast<size_t>(L.w));
  }
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// estimateAffinePartial2D(method=RANSAC)
// ---------------------------------------------------------------------------

namespace {

// cv::RNG: multiply-with-carry on 64 bits
struct MwcRng {
  uint64_t state;
  explicit MwcRng(uint64_t s) : state(s ? s : 0xffffffffu) {}
  unsigned next() {
    state = static_cast<uint64_t>(static_cast<unsigned>(state)) * 4164903690u +
            static_cast<unsigned>(state >> 32);
    return static_cast<unsigned>(state);
  }
  int uniform(int a, int b) { return a == b ? a : static_cast<int>(next() % (b - a)) + a; }
};

// AffinePartial2DEstimatorCallback::runKernel on two pairs: M (2, 3)
void partial_kernel(const float* from, const float* to, double* M) {
  const double x1 = from[0], y1 = from[1], x2 = from[2], y2 = from[3];
  const double X1 = to[0], Y1 = to[1], X2 = to[2], Y2 = to[3];
  const double d = 1. / ((x1 - x2) * (x1 - x2) + (y1 - y2) * (y1 - y2));
  const double S0 = d * ((X1 - X2) * (x1 - x2) + (Y1 - Y2) * (y1 - y2));
  const double S1 = d * ((Y1 - Y2) * (x1 - x2) - (X1 - X2) * (y1 - y2));
  const double S2 = d * ((Y1 - Y2) * (x1 * y2 - x2 * y1) - (X1 * y2 - X2 * y1) * (y1 - y2) -
                         (X1 * x2 - X2 * x1) * (x1 - x2));
  const double S3 = d * (-(X1 - X2) * (x1 * y2 - x2 * y1) - (Y1 * x2 - Y2 * x1) * (x1 - x2) -
                         (Y1 * y2 - Y2 * y1) * (y1 - y2));
  M[0] = M[4] = S0;
  M[1] = -S1;
  M[2] = S2;
  M[3] = S1;
  M[5] = S3;
}

// Affine2DEstimatorCallback::computeError and RANSAC's findInliers
int find_inliers(const float* from, const float* to, int n, const double* M, double thresh,
                 uint8_t* mask) {
  const float F0 = static_cast<float>(M[0]), F1 = static_cast<float>(M[1]),
              F2 = static_cast<float>(M[2]), F3 = static_cast<float>(M[3]),
              F4 = static_cast<float>(M[4]), F5 = static_cast<float>(M[5]);
  const float t = static_cast<float>(thresh * thresh);
  int nz = 0;
  for (int i = 0; i < n; ++i) {
    const float fx = from[2 * i], fy = from[2 * i + 1];
    const float a = F0 * fx + F1 * fy + F2 - to[2 * i];
    const float b = F3 * fx + F4 * fy + F5 - to[2 * i + 1];
    const int f = (a * a + b * b) <= t;
    mask[i] = static_cast<uint8_t>(f);
    nz += f;
  }
  return nz;
}

int ransac_update_num_iters(double p, double ep, int model_points, int max_iters) {
  p = std::min(std::max(p, 0.), 1.);
  ep = std::min(std::max(ep, 0.), 1.);
  double num = std::max(1. - p, DBL_MIN);
  double denom = 1. - std::pow(1. - ep, model_points);
  if (denom < DBL_MIN) return 0;
  num = std::log(num);
  denom = std::log(denom);
  if (denom >= 0 || -num >= max_iters * (-denom)) return max_iters;
  return static_cast<int>(std::nearbyint(num / denom));
}

// solve the symmetric 4 x 4 system A x = b (Gaussian elimination with
// partial pivoting); false if singular
bool solve4(double A[4][4], double b[4], double x[4]) {
  double M[4][5];
  for (int i = 0; i < 4; ++i) {
    for (int j = 0; j < 4; ++j) M[i][j] = A[i][j];
    M[i][4] = b[i];
  }
  for (int c = 0; c < 4; ++c) {
    int piv = c;
    for (int r = c + 1; r < 4; ++r)
      if (std::fabs(M[r][c]) > std::fabs(M[piv][c])) piv = r;
    if (M[piv][c] == 0) return false;
    if (piv != c)
      for (int j = 0; j < 5; ++j) std::swap(M[c][j], M[piv][j]);
    for (int r = c + 1; r < 4; ++r) {
      const double f = M[r][c] / M[c][c];
      for (int j = c; j < 5; ++j) M[r][j] -= f * M[c][j];
    }
  }
  for (int i = 3; i >= 0; --i) {
    double s = M[i][4];
    for (int j = i + 1; j < 4; ++j) s -= M[i][j] * x[j];
    x[i] = s / M[i][i];
  }
  return true;
}

// AffinePartial2DRefineCallback: residuals (2n) and, with J, the Jacobian
// (2n, 4) of [a, b, tx, ty] for x' = a x - b y + tx, y' = b x + a y + ty
void refine_residuals(const float* from, const float* to, int n, const double* h, double* err,
                      double* J) {
  for (int i = 0; i < n; ++i) {
    const double Mx = from[2 * i], My = from[2 * i + 1];
    err[2 * i] = h[0] * Mx - h[1] * My + h[2] - to[2 * i];
    err[2 * i + 1] = h[1] * Mx + h[0] * My + h[3] - to[2 * i + 1];
    if (J) {
      double* r0 = J + 8 * i;
      r0[0] = Mx, r0[1] = -My, r0[2] = 1, r0[3] = 0;
      r0[4] = My, r0[5] = Mx, r0[6] = 0, r0[7] = 1;
    }
  }
}

// LMSolver::run on the four parameters (OpenCV's Levenberg-Marquardt:
// lambda halved on a good step, raised by nu on a poor one; stop after
// `max_iters` or a step or residual under FLT_EPSILON)
void lm_refine(const float* from, const float* to, int n, double* x, int max_iters) {
  const int m = 2 * n;
  std::vector<double> r(m), rd(m), J(static_cast<size_t>(m) * 4);
  auto normal = [&](double A[4][4], double v[4]) {
    for (int i = 0; i < 4; ++i) {
      v[i] = 0;
      for (int j = 0; j < 4; ++j) A[i][j] = 0;
    }
    for (int k = 0; k < m; ++k) {
      const double* jr = &J[static_cast<size_t>(k) * 4];
      for (int i = 0; i < 4; ++i) {
        v[i] += jr[i] * r[k];
        for (int j = 0; j < 4; ++j) A[i][j] += jr[i] * jr[j];
      }
    }
  };
  auto sq = [](const std::vector<double>& e) {
    double s = 0;
    for (double v : e) s += v * v;
    return s;
  };
  refine_residuals(from, to, n, x, r.data(), J.data());
  double S = sq(r);
  double A[4][4], v[4], D[4];
  normal(A, v);
  for (int i = 0; i < 4; ++i) D[i] = A[i][i];
  const double Rlo = 0.25, Rhi = 0.75, eps = FLT_EPSILON;
  double lambda = 1, lc = 0.75;
  int iter = 0;
  for (;;) {
    double Ap[4][4], d[4] = {0, 0, 0, 0}, xd[4];
    for (int i = 0; i < 4; ++i)
      for (int j = 0; j < 4; ++j) Ap[i][j] = A[i][j] + (i == j ? lambda * D[i] : 0.);
    solve4(Ap, v, d);
    for (int i = 0; i < 4; ++i) xd[i] = x[i] - d[i];
    refine_residuals(from, to, n, xd, rd.data(), nullptr);
    const double Sd = sq(rd);
    double dS = 0;  // d . (2 v - A d)
    for (int i = 0; i < 4; ++i) {
      double Ad = 0;
      for (int j = 0; j < 4; ++j) Ad += A[i][j] * d[j];
      dS += d[i] * (2 * v[i] - Ad);
    }
    const double R = (S - Sd) / (std::fabs(dS) > DBL_EPSILON ? dS : 1);
    if (R > Rhi) {
      lambda *= 0.5;
      if (lambda < lc) lambda = 0;
    } else if (R < Rlo) {
      double t = 0;
      for (int i = 0; i < 4; ++i) t += d[i] * v[i];
      double nu = (Sd - S) / (std::fabs(t) > DBL_EPSILON ? t : 1) + 2;
      nu = std::min(std::max(nu, 2.), 10.);
      if (lambda == 0) {
        // lambda = lc = 1 / max |diag(A^-1)|
        double maxval = DBL_EPSILON;
        for (int c = 0; c < 4; ++c) {
          double e[4] = {0, 0, 0, 0}, col[4];
          e[c] = 1;
          double Ac[4][4];
          std::memcpy(Ac, A, sizeof(Ac));
          if (solve4(Ac, e, col)) maxval = std::max(maxval, std::fabs(col[c]));
        }
        lambda = lc = 1. / maxval;
        nu *= 0.5;
      }
      lambda *= nu;
    }
    if (Sd < S) {
      S = Sd;
      std::memcpy(x, xd, sizeof(xd));
      refine_residuals(from, to, n, x, r.data(), J.data());
      normal(A, v);
    }
    ++iter;
    double dmax = 0, rmax = 0;
    for (int i = 0; i < 4; ++i) dmax = std::max(dmax, std::fabs(d[i]));
    for (double e : r) rmax = std::max(rmax, std::fabs(e));
    if (!(iter < max_iters && dmax >= eps && rmax >= eps)) break;
  }
}

}  // namespace

extern "C" {

// estimateAffinePartial2D(from, to (n, 2) float32, method=RANSAC,
// ransacReprojThreshold, maxIters, confidence, refineIters): M (2, 3)
// double and the inlier mask (n,); returns 1, or 0 where OpenCV returns
// no model.
int mgdt_gmc_affine_partial(const float* from_in, const float* to_in, int n, double thresh,
                            int max_iters, double confidence, int refine_iters, double* M,
                            uint8_t* inliers) {
  const int model_points = 2;
  if (n < model_points) return 0;
  std::vector<float> from(from_in, from_in + 2 * n), to(to_in, to_in + 2 * n);
  std::vector<uint8_t> mask(n), best_mask(n, 0);
  double best[6] = {0, 0, 0, 0, 0, 0};
  int max_good = 0;
  if (n == model_points) {
    partial_kernel(from.data(), to.data(), best);
    std::fill(best_mask.begin(), best_mask.end(), 1);
    max_good = n;
  } else {
    MwcRng rng(~static_cast<uint64_t>(0));
    int niters = std::max(max_iters, 1);
    for (int iter = 0; iter < niters; ++iter) {
      // getSubset: two distinct indices (no collinearity test applies to two points)
      int idx[2];
      idx[0] = rng.uniform(0, n);
      do {
        idx[1] = rng.uniform(0, n);
      } while (idx[1] == idx[0]);
      const float ms1[4] = {from[2 * idx[0]], from[2 * idx[0] + 1], from[2 * idx[1]],
                            from[2 * idx[1] + 1]};
      const float ms2[4] = {to[2 * idx[0]], to[2 * idx[0] + 1], to[2 * idx[1]],
                            to[2 * idx[1] + 1]};
      double model[6];
      partial_kernel(ms1, ms2, model);
      const int good = find_inliers(from.data(), to.data(), n, model, thresh, mask.data());
      if (good > std::max(max_good, model_points - 1)) {
        std::swap(mask, best_mask);
        std::memcpy(best, model, sizeof(best));
        max_good = good;
        niters = ransac_update_num_iters(confidence, static_cast<double>(n - good) / n,
                                         model_points, niters);
      }
    }
  }
  if (max_good <= 0) {
    std::fill(inliers, inliers + n, 0);
    return 0;
  }
  std::memcpy(inliers, best_mask.data(), n);
  std::memcpy(M, best, sizeof(best));
  if (n > 2 && refine_iters > 0) {
    // the inliers first (compressElems), then Levenberg-Marquardt on them
    std::vector<float> fi, ti;
    for (int i = 0; i < n; ++i) {
      if (!best_mask[i]) continue;
      fi.push_back(from[2 * i]), fi.push_back(from[2 * i + 1]);
      ti.push_back(to[2 * i]), ti.push_back(to[2 * i + 1]);
    }
    const int k = static_cast<int>(fi.size() / 2);
    if (k > 0) {
      double h[4] = {M[0], M[3], M[2], M[5]};
      lm_refine(fi.data(), ti.data(), k, h, refine_iters);
      M[0] = M[4] = h[0];
      M[1] = -h[1];
      M[3] = h[1];
      M[2] = h[2];
      M[5] = h[3];
    }
  }
  return 1;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// findTransformECC(template, input, warp, MOTION_EUCLIDEAN, criteria, none, 5)
// ---------------------------------------------------------------------------

namespace {

// GaussianBlur(ksize 5, sigma 0) of a uint8 image to float: the kernel
// [1 4 6 4 1] / 16 each way, reflect-101 borders (exact in float)
void gauss5(const uint8_t* src, int H, int W, float* dst) {
  static const float k[5] = {0.0625f, 0.25f, 0.375f, 0.25f, 0.0625f};
  std::vector<float> rows(static_cast<size_t>(H) * W);
  parallel_for(H, [&](int b, int e) {
    for (int y = b; y < e; ++y) {
      const uint8_t* s = src + static_cast<size_t>(y) * W;
      for (int x = 0; x < W; ++x) {
        float acc = 0;
        for (int u = 0; u < 5; ++u) acc += k[u] * s[reflect101(x + u - 2, W)];
        rows[static_cast<size_t>(y) * W + x] = acc;
      }
    }
  });
  parallel_for(H, [&](int b, int e) {
    for (int y = b; y < e; ++y) {
      const float* r[5];
      for (int u = 0; u < 5; ++u) r[u] = &rows[static_cast<size_t>(reflect101(y + u - 2, H)) * W];
      for (int x = 0; x < W; ++x) {
        float acc = 0;
        for (int u = 0; u < 5; ++u) acc += k[u] * r[u][x];
        dst[static_cast<size_t>(y) * W + x] = acc;
      }
    }
  });
}

// warpAffine(src, map, WARP_INVERSE_MAP | INTER_LINEAR, BORDER_CONSTANT 0)
// of float images as OpenCV 5 computes it: the source coordinate in float,
// fma(m0, x, y * m1 + m2), and the bilinear blend of the four taps by fused
// lerps, a tap outside the image taken as 0
inline float sample_bilinear(const float* img, int H, int W, float sx, float sy) {
  const float fx = std::floor(sx), fy = std::floor(sy);
  const float ax = sx - fx, ay = sy - fy;
  const int ix = static_cast<int>(std::min(std::max(fx, -2.f), static_cast<float>(W)));
  const int iy = static_cast<int>(std::min(std::max(fy, -2.f), static_cast<float>(H)));
  auto at = [&](int y, int x) {
    return (x >= 0 && x < W && y >= 0 && y < H) ? img[static_cast<size_t>(y) * W + x] : 0.f;
  };
  const float p00 = at(iy, ix), p01 = at(iy, ix + 1);
  const float p10 = at(iy + 1, ix), p11 = at(iy + 1, ix + 1);
  const float a = std::fmaf(ax, p01 - p00, p00);
  const float b = std::fmaf(ax, p11 - p10, p10);
  return std::fmaf(ay, b - a, a);
}

}  // namespace

extern "C" {

// findTransformECC(tmpl, img (H, W) uint8, warp (2, 3) float32 in and out,
// MOTION_EUCLIDEAN, (COUNT | EPS, max_count, eps), no mask, gaussFiltSize
// 5). Returns 0, or 1 where OpenCV raises (a NaN correlation, or a step
// that would lower the correlation); warp then holds the last estimate.
//
// Each iteration is one pass over the pixels: the warped input and
// gradients (never stored), the mask, the Jacobian [gx * hatX + gy * hatY,
// gx, gy] in float as OpenCV forms it, and the raw sums every product of
// OpenCV's iteration is made of; the zero-mean projections and the error's
// projection follow from them exactly (the error's is lambda times the
// template's minus the input's), in double where OpenCV rounds each
// pixel's zero-mean value to float.
int mgdt_gmc_ecc(const uint8_t* tmpl, const uint8_t* img, int H, int W, float* warp,
                 int max_count, double eps) {
  const size_t n = static_cast<size_t>(H) * W;
  std::vector<float> T(n), I(n), gx(n), gy(n);
  gauss5(tmpl, H, W, T.data());
  gauss5(img, H, W, I.data());
  // filter2D with (-0.5, 0, 0.5) each way, reflect-101 borders (exact)
  parallel_for(H, [&](int b, int e) {
    for (int y = b; y < e; ++y) {
      const float* up = &I[static_cast<size_t>(reflect101(y - 1, H)) * W];
      const float* dn = &I[static_cast<size_t>(reflect101(y + 1, H)) * W];
      const size_t r = static_cast<size_t>(y) * W;
      for (int x = 0; x < W; ++x) {
        gx[r + x] = -0.5f * I[r + reflect101(x - 1, W)] + 0.5f * I[r + reflect101(x + 1, W)];
        gy[r + x] = -0.5f * up[x] + 0.5f * dn[x];
      }
    }
  });
  // per-row partial sums, combined in row order: over the mask the count,
  // the warped input and the template and their squares, the template
  // times the input; over every pixel the Hessian's upper triangle and the
  // Jacobian times the input; over the mask the Jacobian and the Jacobian
  // times the template
  enum { kN, kSI, kSQI, kST, kSQT, kTI, kH, kJI = kH + 6, kJM = kJI + 3, kJT = kJM + 3,
         kSUMS = kJT + 3 };
  std::vector<double> part(static_cast<size_t>(H) * kSUMS);
  auto total = [&](int k) {
    double t = 0;
    for (int y = 0; y < H; ++y) t += part[static_cast<size_t>(y) * kSUMS + k];
    return t;
  };
  double rho = -1, last_rho = -eps;
  for (int it = 1; it <= max_count && std::fabs(rho - last_rho) >= eps; ++it) {
    const float m0 = warp[0], m1 = warp[1], m2 = warp[2], m3 = warp[3], m4 = warp[4], m5 = warp[5];
    const float h0 = m0, h1 = m3;  // cos, sin
    std::fill(part.begin(), part.end(), 0.0);
    parallel_for(H, [&](int yb, int ye) {
      for (int y = yb; y < ye; ++y) {
        double* ps = &part[static_cast<size_t>(y) * kSUMS];
        const float fy = static_cast<float>(y);
        const float bx = fy * m1 + m2, by = fy * m4 + m5;
        for (int x = 0; x < W; ++x) {
          const size_t i = static_cast<size_t>(y) * W + x;
          const float sx = std::fmaf(m0, static_cast<float>(x), bx);
          const float sy = std::fmaf(m3, static_cast<float>(x), by);
          const double iw = sample_bilinear(I.data(), H, W, sx, sy);
          const float gxw = sample_bilinear(gx.data(), H, W, sx, sy);
          const float gyw = sample_bilinear(gy.data(), H, W, sx, sy);
          const double X = x, Y = y;
          const float hatX = static_cast<float>(-(X * h1) - Y * h0);
          const float hatY = static_cast<float>(X * h0 - Y * h1);
          const double J[3] = {gxw * hatX + gyw * hatY, gxw, gyw};
          int k = kH;
          for (int a = 0; a < 3; ++a) {
            for (int c = a; c < 3; ++c) ps[k++] += J[a] * J[c];
            ps[kJI + a] += J[a] * iw;
          }
          const float rx = std::nearbyint(sx), ry = std::nearbyint(sy);  // INTER_NEAREST
          if (rx >= 0.f && rx < static_cast<float>(W) && ry >= 0.f && ry < static_cast<float>(H)) {
            const double t = T[i];
            ps[kN] += 1;
            ps[kSI] += iw, ps[kSQI] += iw * iw;
            ps[kST] += t, ps[kSQT] += t * t;
            ps[kTI] += t * iw;
            for (int a = 0; a < 3; ++a) ps[kJM + a] += J[a], ps[kJT + a] += J[a] * t;
          }
        }
      }
    });
    // meanStdDev over the mask; the warped input is zero-mean inside the
    // mask and keeps its values outside it, the template is 0 outside it
    const double cnt = total(kN);
    const double im = cnt > 0 ? total(kSI) / cnt : 0, tm = cnt > 0 ? total(kST) / cnt : 0;
    const double istd = std::sqrt(std::max(cnt > 0 ? total(kSQI) / cnt - im * im : 0., 0.));
    const double tstd = std::sqrt(std::max(cnt > 0 ? total(kSQT) / cnt - tm * tm : 0., 0.));
    const double imf = static_cast<float>(im), tmf = static_cast<float>(tm);
    const double tmp_norm = std::sqrt(cnt * tstd * tstd), img_norm = std::sqrt(cnt * istd * istd);
    double Hs[3][3], ip[3], tp[3];
    {
      int k = kH;
      for (int a = 0; a < 3; ++a) {
        for (int c = a; c < 3; ++c) Hs[a][c] = total(k++);
        const double jm = total(kJM + a);
        ip[a] = total(kJI + a) - imf * jm;
        tp[a] = total(kJT + a) - tmf * jm;
      }
    }
    const double corr = total(kTI) - imf * total(kST) - tmf * total(kSI) + cnt * imf * tmf;
    float hess[3][3];
    for (int a = 0; a < 3; ++a)
      for (int b = a; b < 3; ++b) hess[a][b] = hess[b][a] = static_cast<float>(Hs[a][b]);
    // Mat::inv of a 3 x 3: the cofactors of the float Hessian in double,
    // over its determinant
    double hi[3][3];
    {
      double h[3][3];
      for (int r = 0; r < 3; ++r)
        for (int c = 0; c < 3; ++c) h[r][c] = hess[r][c];
      auto minor = [&](int r0, int c0, int r1, int c1) {
        return h[r0][c0] * h[r1][c1] - h[r0][c1] * h[r1][c0];
      };
      const double d = h[0][0] * minor(1, 1, 2, 2) - h[0][1] * minor(1, 0, 2, 2) +
                       h[0][2] * minor(1, 0, 2, 1);
      const double id = d != 0 ? 1. / d : 0.;
      hi[0][0] = minor(1, 1, 2, 2) * id, hi[0][1] = -minor(0, 1, 2, 2) * id;
      hi[0][2] = minor(0, 1, 1, 2) * id, hi[1][0] = -minor(1, 0, 2, 2) * id;
      hi[1][1] = minor(0, 0, 2, 2) * id, hi[1][2] = -minor(0, 0, 1, 2) * id;
      hi[2][0] = minor(1, 0, 2, 1) * id, hi[2][1] = -minor(0, 0, 2, 1) * id;
      hi[2][2] = minor(0, 0, 1, 1) * id;
    }
    float hinv[3][3];
    for (int a = 0; a < 3; ++a)
      for (int b = 0; b < 3; ++b) hinv[a][b] = static_cast<float>(hi[a][b]);
    last_rho = rho;
    rho = corr / (img_norm * tmp_norm);
    if (std::isnan(rho)) return 1;
    float ipf[3], tpf[3], iph[3];
    for (int a = 0; a < 3; ++a) {
      ipf[a] = static_cast<float>(ip[a]);
      tpf[a] = static_cast<float>(tp[a]);
    }
    for (int a = 0; a < 3; ++a) {
      double acc = 0;
      for (int b = 0; b < 3; ++b) acc += static_cast<double>(hinv[a][b]) * ipf[b];
      iph[a] = static_cast<float>(acc);
    }
    double ipd = 0, tpd = 0;
    for (int a = 0; a < 3; ++a) {
      ipd += static_cast<double>(ipf[a]) * iph[a];
      tpd += static_cast<double>(tpf[a]) * iph[a];
    }
    const double lambda_n = img_norm * img_norm - ipd;
    const double lambda_d = corr - tpd;
    if (lambda_d <= 0.0) return 1;
    const double lambda = lambda_n / lambda_d;
    float epf[3], dp[3];
    for (int a = 0; a < 3; ++a) epf[a] = static_cast<float>(lambda * tp[a] - ip[a]);
    for (int a = 0; a < 3; ++a) {
      double acc = 0;
      for (int b = 0; b < 3; ++b) acc += static_cast<double>(hinv[a][b]) * epf[b];
      dp[a] = static_cast<float>(acc);
    }
    const double theta = dp[0] + std::asin(static_cast<double>(warp[3]));
    warp[2] += dp[1];
    warp[5] += dp[2];
    warp[0] = warp[4] = static_cast<float>(std::cos(theta));
    warp[3] = static_cast<float>(std::sin(theta));
    warp[1] = -warp[3];
  }
  return 0;
}

}  // extern "C"
