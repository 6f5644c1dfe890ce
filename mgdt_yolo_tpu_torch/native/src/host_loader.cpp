// Host-side image ingest for the port's data pipeline: a copy of the JAX
// package's `mgdt_yolo_tpu/native/src/host_loader.cpp`, rebuilt for the
// GPU host, which has neither libjpeg nor libpng.
//
// * JPEG is decoded by nvJPEG (CUDA toolkit) on the card into its Y, Cb
//   and Cr planes, copied back to the host, where the chroma is upsampled
//   and converted to RGB as libjpeg-turbo (cv2's decoder) does it; the
//   build without MGDT_NVJPEG (a machine without CUDA) returns
//   MGDT_ERR_NO_JPEG for every JPEG.
// * PNG is decoded here: chunks parsed, IDAT inflated by zlib, rows
//   unfiltered (None, Sub, Up, Average, Paeth; Adam7 passes), then the
//   IMREAD_COLOR set of transforms libpng applies for cv2: palette
//   expanded, 1/2/4-bit grey scaled to 8 bits, 16 bits cut to their high
//   byte, alpha dropped, grey copied to the three channels.
// * The long-side bilinear `resize_into`, the paste into the 114-filled
//   RGB canvas, the per-image status codes and the thread pool are the JAX
//   loader's, unchanged: `mgdt_load_batch` gives its bits on PNG.
// * `mgdt_decode` / `mgdt_decode_batch` are the full-size decode to BGR
//   that `cv2.imread` gives, with a JPEG's EXIF orientation applied as cv2
//   applies it; `mgdt_load_one` declines such a JPEG (MGDT_ERR_EXIF), as
//   the JAX loader does, so its caller redoes it through the Python path.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 host_loader.cpp -lz -lpthread
//        [-DMGDT_NVJPEG -I<cuda>/include -L<cuda>/lib64 -lnvjpeg -lcudart]
//        (see mgdt_yolo_tpu_torch/utils/build.py, which builds it at first use).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

#include <zlib.h>

#ifdef MGDT_NVJPEG
#include <cuda_runtime.h>
#include <nvjpeg.h>
#endif

extern "C" {

enum {
  MGDT_OK = 0,
  MGDT_ERR_OPEN = -1,
  MGDT_ERR_EXIF = -2,     // EXIF orientation != 1: the canvas path declines it
  MGDT_ERR_DECODE = -3,
  MGDT_ERR_FORMAT = -4,   // not a JPEG or a PNG
  MGDT_ERR_COLORSPACE = -5,
  MGDT_ERR_NO_JPEG = -6,  // a JPEG, and this build has no JPEG decoder
};

int mgdt_version(void) { return 104; }

int mgdt_has_jpeg(void) {
#ifdef MGDT_NVJPEG
  return 1;
#else
  return 0;
#endif
}

}  // extern "C"

// ---------------------------------------------------------------------------
// EXIF orientation (JPEG APP1), as the JAX loader reads it.
// ---------------------------------------------------------------------------

static int exif_orientation(const uint8_t* data, unsigned len) {
  // data: APP1 payload (after the 2-byte length), starts with "Exif\0\0".
  if (len < 14 || memcmp(data, "Exif\0\0", 6) != 0) return 1;
  const uint8_t* tiff = data + 6;
  unsigned tlen = len - 6;
  bool be;
  if (tiff[0] == 'I' && tiff[1] == 'I') be = false;
  else if (tiff[0] == 'M' && tiff[1] == 'M') be = true;
  else return 1;
  auto rd16 = [&](unsigned off) -> unsigned {
    if (off + 2 > tlen) return 0;
    return be ? (tiff[off] << 8) | tiff[off + 1]
              : (tiff[off + 1] << 8) | tiff[off];
  };
  auto rd32 = [&](unsigned off) -> unsigned {
    if (off + 4 > tlen) return 0;
    return be ? (tiff[off] << 24) | (tiff[off + 1] << 16) | (tiff[off + 2] << 8) | tiff[off + 3]
              : (tiff[off + 3] << 24) | (tiff[off + 2] << 16) | (tiff[off + 1] << 8) | tiff[off];
  };
  if (rd16(2) != 42) return 1;
  unsigned ifd = rd32(4);
  if (ifd == 0 || ifd + 2 > tlen) return 1;
  unsigned n = rd16(ifd);
  for (unsigned i = 0; i < n; i++) {
    unsigned e = ifd + 2 + i * 12;
    if (e + 12 > tlen) break;
    if (rd16(e) == 0x0112) {  // Orientation tag, SHORT
      unsigned v = rd16(e + 8);
      return (v >= 1 && v <= 8) ? (int)v : 1;
    }
  }
  return 1;
}

// The orientation of the first APP1 segment before the frame header, 1 if
// there is none (libjpeg's saved markers, read without libjpeg).
static int jpeg_orientation(const uint8_t* d, size_t n) {
  size_t p = 2;
  while (p + 4 <= n) {
    if (d[p] != 0xFF) return 1;
    uint8_t m = d[p + 1];
    if (m == 0xFF) { p++; continue; }
    if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) { p += 2; continue; }
    if (m == 0xDA || m == 0xD9) return 1;  // scan data: no more markers
    unsigned len = (d[p + 2] << 8) | d[p + 3];
    if (len < 2 || p + 2 + len > n) return 1;
    if (m == 0xE1) {
      int o = exif_orientation(d + p + 4, len - 2);
      if (o != 1) return o;
    }
    p += 2 + len;
  }
  return 1;
}

// ---------------------------------------------------------------------------
// YCbCr planes -> RGB rows, as libjpeg-turbo (cv2's decoder) makes them:
// its "fancy" triangle-filter chroma upsampling (jdsample.c, the edge rows
// and columns replicated as its context rows are) and its fixed-point
// YCbCr -> RGB tables (jdcolor.c). nvJPEG decodes the planes; only its
// IDCT then differs from libjpeg's.
// ---------------------------------------------------------------------------

// Output row `r` of a chroma plane (cw x ch, rows `pitch` bytes apart)
// upsampled by (hs, vs) into `o` (cw * hs bytes): h2v1, h1v2 and h2v2 by
// the fancy filters, the rest (and planes of <= 2 columns, where libjpeg
// takes the plain path for h2v1 and h2v2) by replication.
static void upsample_row(const uint8_t* in, size_t pitch, int cw, int ch, int hs, int vs,
                         int r, uint8_t* o) {
  const bool fancy_h = hs == 2 && cw > 2;
  const int y = r / vs, v = r % vs;
  const uint8_t* r0 = in + (size_t)y * pitch;
  if (vs == 2 && (hs == 1 || fancy_h)) {
    // the next nearest row: above for the first output row, below for the
    // second (the edge row itself past the plane)
    const uint8_t* r1 = in + (size_t)std::clamp(v == 0 ? y - 1 : y + 1, 0, ch - 1) * pitch;
    if (hs == 1) {
      const int bias = v == 0 ? 1 : 2;
      for (int x = 0; x < cw; x++) o[x] = (uint8_t)((r0[x] * 3 + r1[x] + bias) >> 2);
      return;
    }
    int this_sum = r0[0] * 3 + r1[0], next_sum = r0[1] * 3 + r1[1], last_sum;
    o[0] = (uint8_t)((this_sum * 4 + 8) >> 4);
    o[1] = (uint8_t)((this_sum * 3 + next_sum + 7) >> 4);
    last_sum = this_sum;
    this_sum = next_sum;
    for (int x = 1; x < cw - 1; x++) {
      next_sum = r0[x + 1] * 3 + r1[x + 1];
      o[2 * x] = (uint8_t)((this_sum * 3 + last_sum + 8) >> 4);
      o[2 * x + 1] = (uint8_t)((this_sum * 3 + next_sum + 7) >> 4);
      last_sum = this_sum;
      this_sum = next_sum;
    }
    o[2 * cw - 2] = (uint8_t)((this_sum * 3 + last_sum + 8) >> 4);
    o[2 * cw - 1] = (uint8_t)((this_sum * 4 + 7) >> 4);
  } else if (vs == 1 && fancy_h) {
    int iv = r0[0];
    o[0] = (uint8_t)iv;
    o[1] = (uint8_t)((iv * 3 + r0[1] + 2) >> 2);
    for (int x = 1; x < cw - 1; x++) {
      iv = r0[x] * 3;
      o[2 * x] = (uint8_t)((iv + r0[x - 1] + 1) >> 2);
      o[2 * x + 1] = (uint8_t)((iv + r0[x + 1] + 2) >> 2);
    }
    iv = r0[cw - 1];
    o[2 * cw - 2] = (uint8_t)((iv * 3 + r0[cw - 2] + 1) >> 2);
    o[2 * cw - 1] = (uint8_t)iv;
  } else if (hs == 1) {
    memcpy(o, r0, cw);
  } else {
    for (int x = 0; x < cw; x++)
      for (int k = 0; k < hs; k++) o[x * hs + k] = r0[x];
  }
}

// Y, Cb, Cr planes (the chroma ones cw x ch, subsampled by (hs, vs), the
// pitches given) -> (h, w) RGB rows, a row at a time; `ncomp` 1 for a grey
// image (Y copied to the three channels).
[[maybe_unused]] static void ycc_to_rgb(const uint8_t* y, size_t ypitch, const uint8_t* cb,
                                        const uint8_t* cr, size_t cpitch, int cw, int ch,
                                        int hs, int vs, int ncomp, int w, int h, uint8_t* rgb) {
  if (ncomp == 1) {
    for (int r = 0; r < h; r++) {
      const uint8_t* yr = y + (size_t)r * ypitch;
      uint8_t* o = rgb + (size_t)r * w * 3;
      for (int x = 0; x < w; x++) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = yr[x];
    }
    return;
  }
  // jdcolor.c's tables, as arithmetic: FIX(c) = round(c * 2^16), ONE_HALF
  // = 2^15, the shifts arithmetic (floor), all within int32
  constexpr int kCrR = 91881, kCbB = 116130, kCrG = 46802, kCbG = 22554, kHalf = 1 << 15;
  std::vector<uint8_t> ub((size_t)cw * hs), vb((size_t)cw * hs), planes((size_t)w * 3);
  uint8_t *pr = planes.data(), *pg = pr + w, *pb = pg + w;
  for (int r = 0; r < h; r++) {
    upsample_row(cb, cpitch, cw, ch, hs, vs, r, ub.data());
    upsample_row(cr, cpitch, cw, ch, hs, vs, r, vb.data());
    const uint8_t* yr = y + (size_t)r * ypitch;
    const uint8_t *U = ub.data(), *V = vb.data();
    for (int x = 0; x < w; x++) {  // planar, so the compiler vectorises it
      const int Y = yr[x], u = U[x] - 128, v = V[x] - 128;
      pr[x] = (uint8_t)std::min(std::max(Y + ((kCrR * v + kHalf) >> 16), 0), 255);
      pg[x] = (uint8_t)std::min(std::max(Y + ((kHalf - kCbG * u - kCrG * v) >> 16), 0), 255);
      pb[x] = (uint8_t)std::min(std::max(Y + ((kCbB * u + kHalf) >> 16), 0), 255);
    }
    uint8_t* o = rgb + (size_t)r * w * 3;
    for (int x = 0; x < w; x++) {
      o[3 * x] = pr[x];
      o[3 * x + 1] = pg[x];
      o[3 * x + 2] = pb[x];
    }
  }
}

// ---------------------------------------------------------------------------
// JPEG decode (nvJPEG planes) -> RGB rows
// ---------------------------------------------------------------------------

#ifdef MGDT_NVJPEG
namespace {

struct NvCtx {
  nvjpegJpegState_t state = nullptr;
  cudaStream_t stream = nullptr;
  unsigned char* dbuf = nullptr;
  size_t cap = 0;
};

std::mutex g_mu;
nvjpegHandle_t g_handle = nullptr;
std::vector<NvCtx*> g_free;  // decode states, reused across threads and calls

NvCtx* acquire() {
  std::lock_guard<std::mutex> lk(g_mu);
  if (!g_handle && nvjpegCreateSimple(&g_handle) != NVJPEG_STATUS_SUCCESS) {
    g_handle = nullptr;
    return nullptr;
  }
  if (!g_free.empty()) {
    NvCtx* c = g_free.back();
    g_free.pop_back();
    return c;
  }
  NvCtx* c = new NvCtx();
  if (nvjpegJpegStateCreate(g_handle, &c->state) != NVJPEG_STATUS_SUCCESS ||
      cudaStreamCreateWithFlags(&c->stream, cudaStreamNonBlocking) != cudaSuccess) {
    delete c;
    return nullptr;
  }
  return c;
}

void release(NvCtx* c) {
  std::lock_guard<std::mutex> lk(g_mu);
  g_free.push_back(c);
}

}  // namespace

static int decode_jpeg(const std::vector<uint8_t>& file, std::vector<uint8_t>& rgb,
                       int& w, int& h) {
  // a JPEG cut short of its end marker gets one, so the decoder takes
  // what is there
  std::vector<uint8_t> patched;
  const std::vector<uint8_t>* src = &file;
  size_t n = file.size();
  if (n < 2 || file[n - 2] != 0xFF || file[n - 1] != 0xD9) {
    patched = file;
    patched.push_back(0xFF);
    patched.push_back(0xD9);
    src = &patched;
  }
  NvCtx* c = acquire();
  if (!c) return MGDT_ERR_DECODE;
  int nc = 0;
  nvjpegChromaSubsampling_t ss;
  int ws[NVJPEG_MAX_COMPONENT], hs[NVJPEG_MAX_COMPONENT];
  int rc = MGDT_OK;
  if (nvjpegGetImageInfo(g_handle, src->data(), src->size(), &nc, &ss, ws, hs) !=
      NVJPEG_STATUS_SUCCESS) {
    rc = MGDT_ERR_DECODE;
  } else if (nc != 1 && nc != 3) {
    rc = MGDT_ERR_COLORSPACE;  // CMYK / YCCK
  } else {
    w = ws[0];
    h = hs[0];
    const int cw = nc == 3 ? ws[1] : 0, ch = nc == 3 ? hs[1] : 0;
    int fh = 1, fv = 1;  // the chroma's subsampling factors
    switch (ss) {
      case NVJPEG_CSS_444: case NVJPEG_CSS_GRAY: break;
      case NVJPEG_CSS_422: fh = 2; break;
      case NVJPEG_CSS_420: fh = fv = 2; break;
      case NVJPEG_CSS_440: fv = 2; break;
      case NVJPEG_CSS_411: fh = 4; break;
      case NVJPEG_CSS_410: fh = 4; fv = 2; break;
      default: rc = MGDT_ERR_COLORSPACE;
    }
    const size_t ybytes = (size_t)w * h, cbytes = (size_t)cw * ch;
    const size_t bytes = ybytes + 2 * cbytes;
    if (rc == MGDT_OK && bytes > c->cap) {
      cudaFree(c->dbuf);
      c->dbuf = nullptr;
      c->cap = 0;
      if (cudaMalloc(&c->dbuf, bytes) != cudaSuccess) rc = MGDT_ERR_DECODE;
      else c->cap = bytes;
    }
    if (rc == MGDT_OK) {
      nvjpegImage_t img;
      memset(&img, 0, sizeof(img));
      img.channel[0] = c->dbuf;
      img.pitch[0] = (size_t)w;
      if (nc == 3) {
        img.channel[1] = c->dbuf + ybytes;
        img.channel[2] = c->dbuf + ybytes + cbytes;
        img.pitch[1] = img.pitch[2] = (size_t)cw;
      }
      std::vector<uint8_t> planes(bytes);
      if (nvjpegDecode(g_handle, c->state, src->data(), src->size(),
                       nc == 3 ? NVJPEG_OUTPUT_YUV : NVJPEG_OUTPUT_Y, &img,
                       c->stream) != NVJPEG_STATUS_SUCCESS ||
          cudaMemcpyAsync(planes.data(), c->dbuf, bytes, cudaMemcpyDeviceToHost,
                          c->stream) != cudaSuccess ||
          cudaStreamSynchronize(c->stream) != cudaSuccess) {
        rc = MGDT_ERR_DECODE;
      } else {
        rgb.resize(ybytes * 3);
        ycc_to_rgb(planes.data(), w, planes.data() + ybytes, planes.data() + ybytes + cbytes,
                   cw, cw, ch, fh, fv, nc, w, h, rgb.data());
      }
    }
  }
  release(c);
  return rc;
}
#else
static int decode_jpeg(const std::vector<uint8_t>&, std::vector<uint8_t>&, int&, int&) {
  return MGDT_ERR_NO_JPEG;
}
#endif

// ---------------------------------------------------------------------------
// PNG decode (zlib) -> RGB rows
// ---------------------------------------------------------------------------

static inline uint32_t be32(const uint8_t* p) {
  return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) | ((uint32_t)p[2] << 8) | p[3];
}

static inline uint8_t paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return (uint8_t)a;
  if (pb <= pc) return (uint8_t)b;
  return (uint8_t)c;
}

// Undo the filters of `rows` rows of `stride` bytes (each led by its filter
// byte) in place; `bpp` is the filter's byte distance. Returns false on an
// unknown filter type.
static bool unfilter(uint8_t* data, int rows, size_t stride, int bpp) {
  std::vector<uint8_t> zero(stride, 0);
  const uint8_t* prev = zero.data();
  for (int y = 0; y < rows; y++) {
    uint8_t* row = data + (size_t)y * (stride + 1);
    uint8_t ft = row[0];
    uint8_t* r = row + 1;
    switch (ft) {
      case 0: break;
      case 1:
        for (size_t i = bpp; i < stride; i++) r[i] = (uint8_t)(r[i] + r[i - bpp]);
        break;
      case 2:
        for (size_t i = 0; i < stride; i++) r[i] = (uint8_t)(r[i] + prev[i]);
        break;
      case 3:
        for (size_t i = 0; i < stride; i++) {
          int left = i >= (size_t)bpp ? r[i - bpp] : 0;
          r[i] = (uint8_t)(r[i] + ((left + prev[i]) >> 1));
        }
        break;
      case 4:
        for (size_t i = 0; i < stride; i++) {
          int left = i >= (size_t)bpp ? r[i - bpp] : 0;
          int upleft = i >= (size_t)bpp ? prev[i - bpp] : 0;
          r[i] = (uint8_t)(r[i] + paeth(left, prev[i], upleft));
        }
        break;
      default:
        return false;
    }
    prev = r;
  }
  return true;
}

struct PngInfo {
  int w = 0, h = 0, depth = 0, ctype = 0, interlace = 0;
  std::vector<uint8_t> plte;  // 3 bytes an entry
};

static int png_channels(int ctype) {
  switch (ctype) {
    case 0: return 1;
    case 2: return 3;
    case 3: return 1;
    case 4: return 2;
    case 6: return 4;
  }
  return 0;
}

// One unfiltered row of `pw` pixels -> RGB at out[x * xstep] for x < pw.
static void convert_row(const PngInfo& pi, const uint8_t* r, int pw, uint8_t* out,
                        int xstep) {
  const int d = pi.depth, ch = png_channels(pi.ctype);
  const int bpc = d == 16 ? 2 : 1;  // bytes a sample at depth >= 8
  for (int x = 0; x < pw; x++) {
    uint8_t* o = out + (size_t)x * xstep * 3;
    if (d < 8) {  // grey or palette, packed from the high bits
      int per = 8 / d;
      int v = (r[x / per] >> ((per - 1 - x % per) * d)) & ((1 << d) - 1);
      if (pi.ctype == 3) {
        size_t k = (size_t)v * 3;
        bool ok = k + 2 < pi.plte.size();
        o[0] = ok ? pi.plte[k] : 0;
        o[1] = ok ? pi.plte[k + 1] : 0;
        o[2] = ok ? pi.plte[k + 2] : 0;
      } else {
        uint8_t g = (uint8_t)(v * (255 / ((1 << d) - 1)));
        o[0] = o[1] = o[2] = g;
      }
      continue;
    }
    const uint8_t* s = r + (size_t)x * ch * bpc;  // 16 bits: the high byte first
    if (pi.ctype == 3) {
      size_t k = (size_t)s[0] * 3;
      bool ok = k + 2 < pi.plte.size();
      o[0] = ok ? pi.plte[k] : 0;
      o[1] = ok ? pi.plte[k + 1] : 0;
      o[2] = ok ? pi.plte[k + 2] : 0;
    } else if (pi.ctype == 0 || pi.ctype == 4) {
      o[0] = o[1] = o[2] = s[0];
    } else {
      o[0] = s[0];
      o[1] = s[bpc];
      o[2] = s[2 * bpc];
    }
  }
}

static int decode_png(const std::vector<uint8_t>& file, std::vector<uint8_t>& rgb, int& w,
                      int& h) {
  static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1A, '\n'};
  const uint8_t* d = file.data();
  size_t n = file.size(), p = 8;
  if (n < 8 || memcmp(d, sig, 8) != 0) return MGDT_ERR_FORMAT;
  PngInfo pi;
  std::vector<uint8_t> idat;
  bool ihdr = false;
  while (p + 8 <= n) {
    uint32_t len = be32(d + p);
    const uint8_t* type = d + p + 4;
    if (len > n || p + 12 + (size_t)len > n) return MGDT_ERR_DECODE;
    const uint8_t* body = d + p + 8;
    if (!memcmp(type, "IHDR", 4)) {
      if (len < 13) return MGDT_ERR_DECODE;
      pi.w = (int)be32(body);
      pi.h = (int)be32(body + 4);
      pi.depth = body[8];
      pi.ctype = body[9];
      pi.interlace = body[12];
      ihdr = true;
    } else if (!memcmp(type, "PLTE", 4)) {
      pi.plte.assign(body, body + len);
    } else if (!memcmp(type, "IDAT", 4)) {
      idat.insert(idat.end(), body, body + len);
    } else if (!memcmp(type, "IEND", 4)) {
      break;
    }
    p += 12 + (size_t)len;
  }
  const int ch = png_channels(pi.ctype);
  if (!ihdr || pi.w <= 0 || pi.h <= 0 || !ch || pi.interlace > 1 ||
      !(pi.depth == 1 || pi.depth == 2 || pi.depth == 4 || pi.depth == 8 || pi.depth == 16) ||
      (pi.depth < 8 && pi.ctype != 0 && pi.ctype != 3) || (pi.ctype == 3 && pi.depth > 8) ||
      (pi.ctype == 3 && pi.plte.empty()))
    return MGDT_ERR_DECODE;
  w = pi.w;
  h = pi.h;
  const int bits = ch * pi.depth;
  const int bpp = std::max(1, bits / 8);
  // the passes: Adam7's seven, or one
  static const int ax0[7] = {0, 4, 0, 2, 0, 1, 0}, ay0[7] = {0, 0, 4, 0, 2, 0, 1};
  static const int adx[7] = {8, 8, 4, 4, 2, 2, 1}, ady[7] = {8, 8, 8, 4, 4, 2, 2};
  const int npass = pi.interlace ? 7 : 1;
  size_t total = 0;
  int pw[7], ph[7];
  size_t stride[7];
  for (int k = 0; k < npass; k++) {
    pw[k] = pi.interlace ? (w - ax0[k] + adx[k] - 1) / adx[k] : w;
    ph[k] = pi.interlace ? (h - ay0[k] + ady[k] - 1) / ady[k] : h;
    if (pw[k] <= 0 || ph[k] <= 0) pw[k] = ph[k] = 0;
    stride[k] = ((size_t)pw[k] * bits + 7) / 8;
    total += ph[k] ? (size_t)ph[k] * (stride[k] + 1) : 0;
  }
  std::vector<uint8_t> raw(total);
  z_stream zs;
  memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) return MGDT_ERR_DECODE;
  zs.next_in = idat.data();
  zs.avail_in = (uInt)idat.size();
  zs.next_out = raw.data();
  zs.avail_out = (uInt)raw.size();
  int zr = inflate(&zs, Z_FINISH);
  size_t got = raw.size() - zs.avail_out;
  inflateEnd(&zs);
  if ((zr != Z_STREAM_END && zr != Z_BUF_ERROR && zr != Z_OK) || got < raw.size())
    return MGDT_ERR_DECODE;
  rgb.assign((size_t)w * h * 3, 0);
  size_t off = 0;
  for (int k = 0; k < npass; k++) {
    if (!ph[k]) continue;
    uint8_t* pass = raw.data() + off;
    if (!unfilter(pass, ph[k], stride[k], bpp)) return MGDT_ERR_DECODE;
    const int x0 = pi.interlace ? ax0[k] : 0, y0 = pi.interlace ? ay0[k] : 0;
    const int dx = pi.interlace ? adx[k] : 1, dy = pi.interlace ? ady[k] : 1;
    for (int y = 0; y < ph[k]; y++) {
      const uint8_t* r = pass + (size_t)y * (stride[k] + 1) + 1;
      uint8_t* out = rgb.data() + ((size_t)(y0 + y * dy) * w + x0) * 3;
      convert_row(pi, r, pw[k], out, dx);
    }
    off += (size_t)ph[k] * (stride[k] + 1);
  }
  return MGDT_OK;
}

// ---------------------------------------------------------------------------
// Whole-file decode and EXIF orientation
// ---------------------------------------------------------------------------

static int read_file(const char* path, std::vector<uint8_t>& buf) {
  FILE* f = fopen(path, "rb");
  if (!f) return MGDT_ERR_OPEN;
  if (fseek(f, 0, SEEK_END) != 0) {
    fclose(f);
    return MGDT_ERR_OPEN;
  }
  long n = ftell(f);
  rewind(f);
  if (n < 0) {
    fclose(f);
    return MGDT_ERR_OPEN;
  }
  buf.resize((size_t)n);
  size_t got = n ? fread(buf.data(), 1, (size_t)n, f) : 0;
  fclose(f);
  return got == (size_t)n ? MGDT_OK : MGDT_ERR_OPEN;
}

// Decode a file's bytes to RGB rows; `orientation` receives a JPEG's EXIF
// orientation (1 for a PNG).
static int decode_rgb(const std::vector<uint8_t>& file, std::vector<uint8_t>& rgb, int& w,
                      int& h, int& orientation) {
  orientation = 1;
  if (file.size() < 2) return MGDT_ERR_DECODE;
  int rc;
  if (file[0] == 0xFF && file[1] == 0xD8) {
    orientation = jpeg_orientation(file.data(), file.size());
    rc = decode_jpeg(file, rgb, w, h);
  } else if (file[0] == 0x89 && file[1] == 'P') {
    rc = decode_png(file, rgb, w, h);
  } else {
    rc = MGDT_ERR_FORMAT;
  }
  if (rc == MGDT_OK && (w <= 0 || h <= 0)) rc = MGDT_ERR_DECODE;
  return rc;
}

// `src` (h, w) RGB rows reoriented as cv2's ExifTransform does, into `dst`
// (channels reversed to BGR); returns the new (h, w) through nh, nw.
static void orient_bgr(const uint8_t* src, int h, int w, int o, uint8_t* dst, int& nh,
                       int& nw) {
  const bool t = o >= 5;  // the orientations that transpose
  nh = t ? w : h;
  nw = t ? h : w;
  for (int y = 0; y < nh; y++) {
    for (int x = 0; x < nw; x++) {
      // flips of the (transposed) image: 2 / 6 left-right, 3 / 7 both,
      // 4 / 8 up-down
      int fy = y, fx = x;
      if (o == 2 || o == 3 || o == 6 || o == 7) fx = nw - 1 - x;
      if (o == 3 || o == 4 || o == 7 || o == 8) fy = nh - 1 - y;
      int sy = t ? fx : fy, sx = t ? fy : fx;
      const uint8_t* s = src + ((size_t)sy * w + sx) * 3;
      uint8_t* q = dst + ((size_t)y * nw + x) * 3;
      q[0] = s[2];
      q[1] = s[1];
      q[2] = s[0];
    }
  }
}

// ---------------------------------------------------------------------------
// Bilinear resize (half-pixel centers, matching cv2.INTER_LINEAR geometry)
// from (sh, sw) RGB rows into the top-left (dh, dw) region of the canvas.
// Canvas rows have stride canvas_w*3.
// ---------------------------------------------------------------------------

static void resize_into(const uint8_t* src, int sh, int sw,
                        uint8_t* dst, int dh, int dw, int canvas_w) {
  const float sx = (float)sw / dw, sy = (float)sh / dh;
  std::vector<int> x0v(dw), x1v(dw);
  std::vector<float> fxv(dw);
  for (int x = 0; x < dw; x++) {
    float fx = (x + 0.5f) * sx - 0.5f;
    int x0 = (int)std::floor(fx);
    fxv[x] = fx - x0;
    x0v[x] = std::clamp(x0, 0, sw - 1);
    x1v[x] = std::clamp(x0 + 1, 0, sw - 1);
  }
  for (int y = 0; y < dh; y++) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = (int)std::floor(fy);
    float wy = fy - y0;
    const uint8_t* r0 = src + (size_t)std::clamp(y0, 0, sh - 1) * sw * 3;
    const uint8_t* r1 = src + (size_t)std::clamp(y0 + 1, 0, sh - 1) * sw * 3;
    uint8_t* out = dst + (size_t)y * canvas_w * 3;
    for (int x = 0; x < dw; x++) {
      const int a = x0v[x] * 3, b = x1v[x] * 3;
      const float wx = fxv[x];
      const float w00 = (1 - wy) * (1 - wx), w01 = (1 - wy) * wx;
      const float w10 = wy * (1 - wx), w11 = wy * wx;
      for (int c = 0; c < 3; c++) {
        float v = w00 * r0[a + c] + w01 * r0[b + c] +
                  w10 * r1[a + c] + w11 * r1[b + c];
        out[x * 3 + c] = (uint8_t)std::clamp((int)std::lround(v), 0, 255);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Public API
// ---------------------------------------------------------------------------

extern "C" {

// Decode `path`, long-side resize to imgsz (r = imgsz/max(h,w);
// w' = min(ceil(w*r), imgsz) etc. -- reference load_image rounding as
// implemented in data/augment.py resize_long_side), paste top-left into
// `out` (imgsz*imgsz*3 RGB uint8, pre-filled by the caller or by
// mgdt_load_batch).  out_hw receives the pasted (h', w') as floats.
int mgdt_load_one(const char* path, int imgsz, unsigned char* out,
                  float* out_hw) {
  std::vector<uint8_t> file, rgb;
  int rc = read_file(path, file);
  if (rc != MGDT_OK) return rc;
  int w = 0, h = 0, orientation = 1;
  rc = decode_rgb(file, rgb, w, h, orientation);
  if (rc != MGDT_OK) return rc;
  if (orientation != 1) return MGDT_ERR_EXIF;

  const float r = (float)imgsz / (float)std::max(h, w);
  const int dw = std::min((int)std::ceil(w * r), imgsz);
  const int dh = std::min((int)std::ceil(h * r), imgsz);
  if (dw == w && dh == h) {
    for (int y = 0; y < h; y++)
      memcpy(out + (size_t)y * imgsz * 3, rgb.data() + (size_t)y * w * 3,
             (size_t)w * 3);
  } else {
    resize_into(rgb.data(), h, w, out, dh, dw, imgsz);
  }
  out_hw[0] = (float)dh;
  out_hw[1] = (float)dw;
  return MGDT_OK;
}

// Threaded batch ingest.  out: n*imgsz*imgsz*3 uint8 (filled with `fill`
// first), out_hw: n*2 float32, status: n ints (MGDT_OK or an error code
// per image; callers redo failed indices through the Python path).
void mgdt_load_batch(const char** paths, int n, int imgsz, unsigned char fill,
                     unsigned char* out, float* out_hw, int* status,
                     int nthreads) {
  const size_t plane = (size_t)imgsz * imgsz * 3;
  memset(out, fill, (size_t)n * plane);
  std::atomic<int> next(0);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      out_hw[i * 2] = out_hw[i * 2 + 1] = 0.f;
      status[i] = mgdt_load_one(paths[i], imgsz, out + (size_t)i * plane,
                                out_hw + (size_t)i * 2);
    }
  };
  int t = std::max(1, std::min(nthreads, n));
  if (t == 1) {
    worker();
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(t);
  for (int k = 0; k < t; k++) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
}

// Full-size decode of `path` to BGR rows, EXIF orientation applied, as
// cv2.imread(path) gives them: *out receives a malloc'd (h, w, 3) buffer
// (free it with mgdt_free), *out_h and *out_w its size.
int mgdt_decode(const char* path, unsigned char** out, int* out_h, int* out_w) {
  *out = nullptr;
  *out_h = *out_w = 0;
  std::vector<uint8_t> file, rgb;
  int rc = read_file(path, file);
  if (rc != MGDT_OK) return rc;
  int w = 0, h = 0, orientation = 1;
  rc = decode_rgb(file, rgb, w, h, orientation);
  if (rc != MGDT_OK) return rc;
  unsigned char* buf = (unsigned char*)malloc((size_t)w * h * 3);
  if (!buf) return MGDT_ERR_DECODE;
  int nh, nw;
  orient_bgr(rgb.data(), h, w, orientation, buf, nh, nw);
  *out = buf;
  *out_h = nh;
  *out_w = nw;
  return MGDT_OK;
}

void mgdt_free(unsigned char* p) { free(p); }

// mgdt_decode over n paths on a thread pool.
void mgdt_decode_batch(const char** paths, int n, unsigned char** outs, int* hs, int* ws,
                       int* status, int nthreads) {
  std::atomic<int> next(0);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      status[i] = mgdt_decode(paths[i], outs + i, hs + i, ws + i);
    }
  };
  int t = std::max(1, std::min(nthreads, n));
  if (t == 1) {
    worker();
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(t);
  for (int k = 0; k < t; k++) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
}

}  // extern "C"
