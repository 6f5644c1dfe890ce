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
// * BMP and TIFF are decoded here to the bits `cv2.imread` gives: BMP as
//   cv2's own reader takes it (12/40/108/124-byte headers; 1, 4, 8, 16,
//   24 and 32 bits; palettes; RLE4 and RLE8; bit fields; either row
//   order), TIFF as cv2 reads it through libtiff's RGBA interface (the
//   first IFD; strips or tiles; planar configurations 1 and 2; none, LZW,
//   Deflate or PackBits, with the horizontal predictor; 1-16-bit grey,
//   palette, RGB and RGBA, 16 bits cut to 8 and unassociated alpha
//   premultiplied as libtiff does; orientations 2-4 flipped, 5-8 refused
//   as cv2 5.0 refuses them). Any other TIFF compression or photometric
//   gives MGDT_ERR_UNSUPPORTED.
// * WebP (lossy, lossless, extended, animated) is decoded by
//   `host_webp.cpp`, compiled beside this file, to the bits cv2 reads
//   through libwebp; a VP8X file's EXIF orientation is applied as a JPEG's.
// * The long-side bilinear `resize_into`, the paste into the 114-filled
//   RGB canvas, the per-image status codes and the thread pool are the JAX
//   loader's, unchanged: `mgdt_load_batch` gives its bits on PNG.
// * `mgdt_decode` / `mgdt_decode_batch` are the full-size decode to BGR
//   that `cv2.imread` gives, with a JPEG's or a WebP's EXIF orientation
//   applied as cv2 applies it; `mgdt_load_one` declines an EXIF-rotated
//   JPEG (MGDT_ERR_EXIF) and every WebP (MGDT_ERR_FORMAT), as the JAX
//   loader does, so its caller redoes them through the Python path (cv2's
//   resize, where this one resizes in float).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 host_loader.cpp host_webp.cpp -lz -lpthread
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
  MGDT_ERR_FORMAT = -4,   // not a JPEG, PNG, BMP, TIFF or WebP
  MGDT_ERR_COLORSPACE = -5,
  MGDT_ERR_NO_JPEG = -6,  // a JPEG, and this build has no JPEG decoder
  MGDT_ERR_UNSUPPORTED = -7,  // a TIFF whose compression or colour model is not decoded
};

int mgdt_version(void) { return 106; }

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

// The orientation (tag 0x0112) of the first IFD of a TIFF header, as a
// JPEG's EXIF or a WebP's EXIF chunk holds it; 1 where there is none.
static int tiff_orientation(const uint8_t* tiff, size_t tlen) {
  if (tlen < 8) return 1;
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
  size_t ifd = rd32(4);
  if (ifd == 0 || ifd + 2 > tlen) return 1;
  unsigned n = rd16(ifd);
  for (unsigned i = 0; i < n; i++) {
    size_t e = ifd + 2 + (size_t)i * 12;
    if (e + 12 > tlen) break;
    if (rd16(e) == 0x0112) {  // Orientation tag, SHORT
      unsigned v = rd16(e + 8);
      return (v >= 1 && v <= 8) ? (int)v : 1;
    }
  }
  return 1;
}

static int exif_orientation(const uint8_t* data, unsigned len) {
  // data: APP1 payload (after the 2-byte length), starts with "Exif\0\0".
  if (len < 14 || memcmp(data, "Exif\0\0", 6) != 0) return 1;
  return tiff_orientation(data + 6, len - 6);
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
// Motion JPEG frames without Huffman tables (AVI1 style) get JPEG's standard
// tables (ITU T.81, K.3) before their first scan, as ffmpeg inserts them;
// nvJPEG refuses a scan without tables.
// ---------------------------------------------------------------------------

static const uint8_t DC_LUMA_BITS[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
static const uint8_t DC_CHROMA_BITS[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
static const uint8_t DC_VALS[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
static const uint8_t AC_LUMA_BITS[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
static const uint8_t AC_LUMA_VALS[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
    0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52,
    0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25,
    0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64,
    0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
    0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3,
    0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8,
    0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
static const uint8_t AC_CHROMA_BITS[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
static const uint8_t AC_CHROMA_VALS[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61,
    0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33,
    0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18,
    0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63,
    0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97,
    0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca,
    0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7,
    0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};


// `in` with a DHT segment of the four standard tables before its first scan
// where no DHT comes before it; returns false (and leaves `out` empty)
// where the frame has its own tables.
static bool with_standard_dht(const uint8_t* d, size_t n, std::vector<uint8_t>& out) {
  size_t p = 2;
  while (p + 4 <= n) {
    if (d[p] != 0xFF) return false;
    const uint8_t m = d[p + 1];
    if (m == 0xFF) { p++; continue; }
    if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) { p += 2; continue; }
    if (m == 0xC4) return false;
    if (m == 0xDA) {
      out.assign(d, d + p);
      const struct { int id; const uint8_t *bits, *vals; } t[4] = {
          {0x00, DC_LUMA_BITS, DC_VALS}, {0x10, AC_LUMA_BITS, AC_LUMA_VALS},
          {0x01, DC_CHROMA_BITS, DC_VALS}, {0x11, AC_CHROMA_BITS, AC_CHROMA_VALS}};
      size_t len = 2;
      for (const auto& k : t) {
        len += 17;
        for (int i = 0; i < 16; i++) len += k.bits[i];
      }
      out.push_back(0xFF);
      out.push_back(0xC4);
      out.push_back((uint8_t)(len >> 8));
      out.push_back((uint8_t)len);
      for (const auto& k : t) {
        int m2 = 0;
        for (int i = 0; i < 16; i++) m2 += k.bits[i];
        out.push_back((uint8_t)k.id);
        out.insert(out.end(), k.bits, k.bits + 16);
        out.insert(out.end(), k.vals, k.vals + m2);
      }
      out.insert(out.end(), d + p, d + n);
      return true;
    }
    p += 2 + ((size_t)d[p + 2] << 8 | d[p + 3]);
  }
  return false;
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
  if (with_standard_dht(file.data(), file.size(), patched)) src = &patched;
  size_t n = src->size();
  if (n < 2 || (*src)[n - 2] != 0xFF || (*src)[n - 1] != 0xD9) {
    if (src != &patched) patched = file;
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
// BMP decode -> RGB rows, as cv2's own BMP reader (grfmt_bmp.cpp) gives them
// ---------------------------------------------------------------------------

static inline uint32_t le32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24);
}
static inline uint16_t le16(const uint8_t* p) { return (uint16_t)(p[0] | (p[1] << 8)); }

static int decode_bmp(const std::vector<uint8_t>& file, std::vector<uint8_t>& rgb, int& w,
                      int& h) {
  const uint8_t* d = file.data();
  const size_t n = file.size();
  if (n < 26 || d[0] != 'B' || d[1] != 'M') return MGDT_ERR_FORMAT;
  const size_t offset = le32(d + 10);
  const uint32_t hsize = le32(d + 14);
  int width, height, bpp, rle = 0;
  uint8_t pal[256][3] = {};  // b, g, r; entries past the file's are black
  size_t p = 18;
  if (hsize >= 36) {
    if (n < 14 + (size_t)hsize) return MGDT_ERR_DECODE;
    width = (int32_t)le32(d + 18);
    height = (int32_t)le32(d + 22);
    bpp = le16(d + 28);
    rle = (int)le32(d + 30);
    const uint32_t clrused = le32(d + 46);
    p = 14 + hsize;
    const bool ok = width > 0 && height != 0 &&
        (((bpp == 1 || bpp == 4 || bpp == 8 || bpp == 24 || bpp == 32) && rle == 0) ||
         ((bpp == 16 || bpp == 32) && rle == 3) || (bpp == 4 && rle == 2) ||
         (bpp == 8 && rle == 1) || (bpp == 16 && rle == 0));
    if (!ok) return MGDT_ERR_DECODE;
    if (bpp <= 8) {
      if (clrused > 256) return MGDT_ERR_DECODE;
      const size_t k = clrused ? clrused : (1u << bpp);
      if (p + 4 * k > n) return MGDT_ERR_DECODE;
      for (size_t i = 0; i < k; i++)
        for (int c = 0; c < 3; c++) pal[i][c] = d[p + 4 * i + c];
    } else if (bpp == 16 && rle == 3) {
      // the masks are read after the header, whatever its size, as cv2 reads them
      if (p + 12 > n) return MGDT_ERR_DECODE;
      const uint32_t rm = le32(d + p), gm = le32(d + p + 4), bm = le32(d + p + 8);
      if (bm == 0x1f && gm == 0x3e0 && rm == 0x7c00) bpp = 15;
      else if (!(bm == 0x1f && gm == 0x7e0 && rm == 0xf800)) return MGDT_ERR_DECODE;
    } else if (bpp == 16) {
      bpp = 15;
    }
  } else if (hsize == 12) {  // OS/2 BITMAPCOREHEADER
    width = le16(d + 18);
    height = le16(d + 20);
    const int planes = le16(d + 22);
    bpp = le16(d + 24);
    p = 26;
    if (!(width > 0 && height != 0 && planes == 1 &&
          (bpp == 1 || bpp == 4 || bpp == 8 || bpp == 24 || bpp == 32)))
      return MGDT_ERR_DECODE;
    if (bpp <= 8) {
      const size_t k = 1u << bpp;
      if (p + 3 * k > n) return MGDT_ERR_DECODE;
      for (size_t i = 0; i < k; i++)
        for (int c = 0; c < 3; c++) pal[i][c] = d[p + 3 * i + c];
    }
  } else {
    return MGDT_ERR_DECODE;
  }
  const bool bottom_up = height > 0;
  height = std::abs(height);
  if ((int64_t)width * height > (int64_t)1 << 30) return MGDT_ERR_DECODE;
  w = width;
  h = height;
  rgb.assign((size_t)w * h * 3, 0);
  // row r of the file (in its order) -> output row
  auto out_row = [&](int r) { return rgb.data() + (size_t)(bottom_up ? h - 1 - r : r) * w * 3; };
  auto put = [](uint8_t* o, const uint8_t* bgr) { o[0] = bgr[2]; o[1] = bgr[1]; o[2] = bgr[0]; };
  if (offset >= n) return MGDT_ERR_DECODE;
  const uint8_t* src = d + offset;
  const size_t avail = n - offset;
  if (rle == 1 || rle == 2) {
    // RLE8 / RLE4: runs, absolute runs, end of line, delta and end of
    // bitmap; skipped pixels take palette entry 0, as cv2 fills them
    const bool r4 = rle == 2;
    size_t q = 0;
    int x = 0, y = 0;
    bool wrapped = false;  // the last RLE8 run ended its line (cv2's line_end_flag)
    auto fill0 = [&](int64_t count) {  // palette 0 over `count` pixels, across lines
      while (count > 0 && y < h) {
        const int k = (int)std::min<int64_t>(count, w - x);
        uint8_t* o = out_row(y);
        for (int i = 0; i < k; i++) put(o + 3 * (x + i), pal[0]);
        x += k;
        count -= k;
        if (x >= w) { x = 0; y++; }
      }
    };
    while (y < h) {
      if (q + 2 > avail) return MGDT_ERR_DECODE;
      const int len = src[q], code = src[q + 1];
      q += 2;
      if (len) {  // a run
        if (x + len > w) return MGDT_ERR_DECODE;
        uint8_t* o = out_row(y);
        for (int i = 0; i < len; i++)
          put(o + 3 * (x + i), pal[r4 ? ((i & 1) ? code & 15 : code >> 4) : code]);
        x += len;
        wrapped = false;
        if (!r4 && x == w) { x = 0; y++; wrapped = true; }
      } else if (code > 2) {  // absolute
        if (x + code > w) return MGDT_ERR_DECODE;
        const size_t bytes = r4 ? ((((size_t)code + 1) >> 1) + 1) & ~(size_t)1
                                : ((size_t)code + 1) & ~(size_t)1;
        if (q + bytes > avail) return MGDT_ERR_DECODE;
        uint8_t* o = out_row(y);
        for (int i = 0; i < code; i++) {
          const int v = r4 ? ((i & 1) ? src[q + i / 2] & 15 : src[q + i / 2] >> 4) : src[q + i];
          put(o + 3 * (x + i), pal[v]);
        }
        x += code;
        q += bytes;
        wrapped = false;
      } else if (code == 0) {  // end of line
        if (!(wrapped && x == 0)) {
          fill0(w - x);
          if (x) { x = 0; y++; }  // a line already full moves on as cv2 does
        }
        wrapped = false;
      } else if (code == 1) {  // end of bitmap
        fill0((int64_t)(w - x) + (int64_t)(h - y) * w);
        break;
      } else {  // delta
        if (q + 2 > avail) return MGDT_ERR_DECODE;
        fill0((int64_t)src[q] + (int64_t)src[q + 1] * w);
        q += 2;
        wrapped = false;
      }
    }
    return MGDT_OK;
  }
  const size_t pitch = (((size_t)w * (bpp == 15 ? 16 : bpp) + 7) / 8 + 3) & ~(size_t)3;
  if (pitch * h > avail) return MGDT_ERR_DECODE;
  for (int r = 0; r < h; r++) {
    const uint8_t* s = src + (size_t)r * pitch;
    uint8_t* o = out_row(r);
    for (int x = 0; x < w; x++, o += 3) {
      switch (bpp) {
        case 1: put(o, pal[(s[x >> 3] >> (7 - (x & 7))) & 1]); break;
        case 4: put(o, pal[(x & 1) ? s[x >> 1] & 15 : s[x >> 1] >> 4]); break;
        case 8: put(o, pal[s[x]]); break;
        case 15: case 16: {
          const int t = le16(s + 2 * x);
          o[2] = (uint8_t)((t << 3) & 0xf8);
          if (bpp == 15) {
            o[1] = (uint8_t)((t >> 2) & 0xf8);
            o[0] = (uint8_t)((t >> 7) & 0xf8);
          } else {
            o[1] = (uint8_t)((t >> 3) & 0xfc);
            o[0] = (uint8_t)((t >> 8) & 0xf8);
          }
          break;
        }
        case 24: put(o, s + 3 * x); break;
        case 32: put(o, s + 4 * x); break;  // alpha (or a fourth byte) dropped
      }
    }
  }
  return MGDT_OK;
}

// ---------------------------------------------------------------------------
// TIFF decode -> RGB rows, as cv2 reads it through libtiff's RGBA interface
// ---------------------------------------------------------------------------

struct TiffIfd {
  bool be = false;
  uint32_t width = 0, height = 0, spp = 1, bps = 1, compression = 1, photometric = 1;
  uint32_t planar = 1, predictor = 1, orientation = 1, sample_format = 1, extra = 0;
  uint32_t rows_per_strip = 0xFFFFFFFFu, tile_w = 0, tile_h = 0;
  std::vector<uint64_t> offsets, counts;
  std::vector<uint16_t> cmap;
};

static bool tiff_ifd(const uint8_t* d, size_t n, TiffIfd& t) {
  if (n < 8) return false;
  if (d[0] == 'I' && d[1] == 'I') t.be = false;
  else if (d[0] == 'M' && d[1] == 'M') t.be = true;
  else return false;
  auto u16 = [&](size_t o) -> uint32_t {
    return t.be ? (uint32_t)(d[o] << 8 | d[o + 1]) : (uint32_t)(d[o] | d[o + 1] << 8);
  };
  auto u32 = [&](size_t o) -> uint32_t {
    return t.be ? ((uint32_t)d[o] << 24 | (uint32_t)d[o + 1] << 16 | (uint32_t)d[o + 2] << 8 | d[o + 3])
                : ((uint32_t)d[o + 3] << 24 | (uint32_t)d[o + 2] << 16 | (uint32_t)d[o + 1] << 8 | d[o]);
  };
  if (u16(2) != 42) return false;
  const size_t ifd = u32(4);
  if (ifd + 2 > n) return false;
  const uint32_t count = u16(ifd);
  if (ifd + 2 + (size_t)count * 12 > n) return false;
  bool bps_seen = false;
  for (uint32_t i = 0; i < count; i++) {
    const size_t e = ifd + 2 + (size_t)i * 12;
    const uint32_t tag = u16(e), type = u16(e + 2), cnt = u32(e + 4);
    const size_t size = type == 3 ? 2 : (type == 4 ? 4 : (type == 1 || type == 7 ? 1 : 0));
    if (!size || (uint64_t)size * cnt > n) continue;
    const size_t at = (size_t)size * cnt <= 4 ? e + 8 : u32(e + 8);
    if (at + (size_t)size * cnt > n) return false;
    auto val = [&](uint32_t k) -> uint32_t {
      const size_t o = at + (size_t)k * size;
      return size == 2 ? u16(o) : (size == 4 ? u32(o) : d[o]);
    };
    auto vec = [&](std::vector<uint64_t>& v) {
      v.resize(cnt);
      for (uint32_t k = 0; k < cnt; k++) v[k] = val(k);
    };
    switch (tag) {
      case 256: t.width = val(0); break;
      case 257: t.height = val(0); break;
      case 258:
        t.bps = val(0);
        for (uint32_t k = 1; k < cnt; k++)
          if (val(k) != t.bps) return false;  // mixed sample sizes
        bps_seen = true;
        break;
      case 259: t.compression = val(0); break;
      case 262: t.photometric = val(0); break;
      case 273: vec(t.offsets); break;
      case 274: t.orientation = val(0); break;
      case 277: t.spp = val(0); break;
      case 278: t.rows_per_strip = val(0); break;
      case 279: vec(t.counts); break;
      case 284: t.planar = val(0); break;
      case 317: t.predictor = val(0); break;
      case 320:
        t.cmap.resize(cnt);
        for (uint32_t k = 0; k < cnt; k++) t.cmap[k] = (uint16_t)val(k);
        break;
      case 322: t.tile_w = val(0); break;
      case 323: t.tile_h = val(0); break;
      case 324: vec(t.offsets); break;
      case 325: vec(t.counts); break;
      case 338: t.extra = val(0); break;
      case 339: t.sample_format = val(0); break;
    }
  }
  (void)bps_seen;
  return t.width && t.height;
}

// LZW as TIFF writes it (MSB first, codes widen one code early); returns
// the bytes made, at most `want`.
static size_t tiff_lzw(const uint8_t* in, size_t n, uint8_t* out, size_t want) {
  std::vector<int16_t> prefix(4096, -1);
  std::vector<uint8_t> suffix(4096), first(4096), stack(4097);
  for (int i = 0; i < 256; i++) suffix[i] = first[i] = (uint8_t)i;
  size_t made = 0, bitpos = 0;
  int bits = 9, next = 258, old = -1;
  auto emit = [&](int code) {  // the string of `code`, through its prefixes
    int sp = 0;
    for (int c = code; c >= 0 && sp < 4096; c = prefix[c]) stack[sp++] = suffix[c];
    while (sp && made < want) out[made++] = stack[--sp];
  };
  while (made < want && (bitpos + bits + 7) / 8 <= n) {
    int code = 0;
    for (int b = 0; b < bits; b++, bitpos++)
      code = (code << 1) | ((in[bitpos >> 3] >> (7 - (bitpos & 7))) & 1);
    if (code == 257) break;
    if (code == 256) {
      bits = 9;
      next = 258;
      old = -1;
      continue;
    }
    if (old < 0) {
      if (code > 255) break;
      emit(code);
      old = code;
      continue;
    }
    uint8_t f;
    if (code < next) {
      emit(code);
      f = first[code];
    } else if (code == next) {
      emit(old);
      f = first[old];
      if (made < want) out[made++] = f;
    } else {
      break;
    }
    if (next < 4096) {
      prefix[next] = (int16_t)old;
      suffix[next] = f;
      first[next] = first[old];
      next++;
    }
    if (next >= (1 << bits) - 1 && bits < 12) bits++;
    old = code;
  }
  return made;
}

static size_t tiff_packbits(const uint8_t* in, size_t n, uint8_t* out, size_t want) {
  size_t i = 0, made = 0;
  while (i < n && made < want) {
    const int c = (int8_t)in[i++];
    if (c >= 0) {
      for (int k = 0; k <= c && i < n && made < want; k++) out[made++] = in[i++];
    } else if (c != -128) {
      if (i >= n) break;
      const uint8_t v = in[i++];
      for (int k = 0; k < 1 - c && made < want; k++) out[made++] = v;
    }
  }
  return made;
}

static int decode_tiff(const std::vector<uint8_t>& file, std::vector<uint8_t>& rgb, int& w,
                       int& h) {
  const uint8_t* d = file.data();
  const size_t n = file.size();
  TiffIfd t;
  if (!tiff_ifd(d, n, t)) return MGDT_ERR_DECODE;
  const uint32_t c = t.compression;
  if (!(c == 1 || c == 5 || c == 8 || c == 32946 || c == 32773)) return MGDT_ERR_UNSUPPORTED;
  if (t.photometric > 3 || t.sample_format != 1 || (t.predictor != 1 && t.predictor != 2))
    return MGDT_ERR_UNSUPPORTED;
  const uint32_t bps = t.bps, spp = t.spp;
  const bool grey = t.photometric <= 1, palette = t.photometric == 3;
  if (!(bps == 1 || bps == 2 || bps == 4 || bps == 8 || bps == 16) || spp < 1 || spp > 8 ||
      (t.photometric == 2 && (spp < 3 || bps < 8)) || (palette && (bps > 8 || spp != 1)))
    return MGDT_ERR_UNSUPPORTED;
  if (palette && t.cmap.size() < 3 * ((size_t)1 << bps)) return MGDT_ERR_DECODE;
  // cv2's header check: 1, 8 or 16 bits, or 4 with a palette
  if (bps == 2 || (bps == 4 && !palette)) return MGDT_ERR_DECODE;
  if (t.orientation >= 5 && t.orientation <= 8) return MGDT_ERR_DECODE;  // cv2 5.0 refuses them
  if ((uint64_t)t.width * t.height > (uint64_t)1 << 30) return MGDT_ERR_DECODE;
  w = (int)t.width;
  h = (int)t.height;
  const bool tiled = t.tile_w && t.tile_h;
  const uint32_t cw = tiled ? t.tile_w : t.width;
  const uint32_t ch = tiled ? t.tile_h : std::min(t.rows_per_strip ? t.rows_per_strip : t.height,
                                                   t.height);
  const uint32_t across = tiled ? (t.width + cw - 1) / cw : 1, down = (t.height + ch - 1) / ch;
  const uint32_t planes = t.planar == 2 ? spp : 1, chunk_spp = t.planar == 2 ? 1 : spp;
  const size_t row_bytes = ((size_t)cw * chunk_spp * bps + 7) / 8;
  const size_t chunk_bytes = row_bytes * ch;
  if (t.offsets.size() < (size_t)across * down * planes || t.counts.size() < t.offsets.size())
    return MGDT_ERR_DECODE;
  std::vector<uint16_t> samples((size_t)w * h * spp, 0);
  std::vector<uint8_t> buf(chunk_bytes);
  for (uint32_t pl = 0; pl < planes; pl++) {
    for (uint32_t ty = 0; ty < down; ty++) {
      for (uint32_t tx = 0; tx < across; tx++) {
        const size_t k = ((size_t)pl * down + ty) * across + tx;
        const uint64_t off = t.offsets[k], cnt = t.counts[k];
        if (off > n || cnt > n - off) return MGDT_ERR_DECODE;
        const uint8_t* in = d + off;
        std::fill(buf.begin(), buf.end(), 0);
        // a strip at the image's end holds only the rows left
        const uint32_t rows = tiled ? ch : std::min(ch, t.height - ty * ch);
        const size_t want = row_bytes * rows;
        size_t got = 0;
        if (c == 1) {
          got = std::min<size_t>(cnt, want);
          memcpy(buf.data(), in, got);
        } else if (c == 5) {
          got = tiff_lzw(in, cnt, buf.data(), want);
        } else if (c == 8 || c == 32946) {
          uLongf dl = (uLongf)want;
          z_stream zs;
          memset(&zs, 0, sizeof(zs));
          if (inflateInit(&zs) != Z_OK) return MGDT_ERR_DECODE;
          zs.next_in = const_cast<uint8_t*>(in);
          zs.avail_in = (uInt)cnt;
          zs.next_out = buf.data();
          zs.avail_out = (uInt)dl;
          inflate(&zs, Z_FINISH);
          got = want - zs.avail_out;
          inflateEnd(&zs);
        } else {
          got = tiff_packbits(in, cnt, buf.data(), want);
        }
        if (got < want) return MGDT_ERR_DECODE;
        // each row's samples, the predictor undone, into the image
        std::vector<uint32_t> row((size_t)cw * chunk_spp);
        for (uint32_t r = 0; r < rows; r++) {
          const uint8_t* s = buf.data() + r * row_bytes;
          const size_t m = row.size();
          for (size_t i = 0; i < m; i++) {
            if (bps == 16) row[i] = t.be ? (s[2 * i] << 8 | s[2 * i + 1]) : (s[2 * i] | s[2 * i + 1] << 8);
            else if (bps == 8) row[i] = s[i];
            else row[i] = (s[i * bps / 8] >> (8 - bps - (i * bps) % 8)) & ((1u << bps) - 1);
          }
          if (t.predictor == 2) {
            const uint32_t mask = bps == 16 ? 0xFFFF : (bps == 8 ? 0xFF : 0);
            if (!mask) return MGDT_ERR_UNSUPPORTED;
            for (size_t i = chunk_spp; i < m; i++) row[i] = (row[i] + row[i - chunk_spp]) & mask;
          }
          const uint32_t y = ty * ch + r;
          if (y >= t.height) break;
          for (uint32_t x = 0; x < cw; x++) {
            const uint32_t X = tx * cw + x;
            if (X >= t.width) break;
            uint16_t* o = samples.data() + ((size_t)y * w + X) * spp;
            if (t.planar == 2) o[pl] = (uint16_t)row[x];
            else for (uint32_t s2 = 0; s2 < spp; s2++) o[s2] = (uint16_t)row[(size_t)x * spp + s2];
          }
        }
      }
    }
  }
  // libtiff's RGBA conversion: grey through its map (16 bits: the high
  // byte), RGB 16 bits by (v + 128) / 257, the palette's 16-bit entries cut
  // to their high byte unless all are below 256, unassociated alpha
  // premultiplied ((v * a + 127) / 255)
  rgb.resize((size_t)w * h * 3);
  const uint32_t range = bps == 16 ? 255 : (1u << bps) - 1;
  bool cmap16 = false;
  const size_t ncol = palette ? (size_t)1 << bps : 0;
  for (size_t i = 0; i < 3 * ncol; i++) cmap16 |= t.cmap[i] >= 256;
  auto c8 = [](uint32_t v) { return (uint8_t)((v + 128) / 257); };
  const bool unassoc = t.photometric == 2 && spp >= 4 && t.extra == 2;
  for (size_t i = 0; i < (size_t)w * h; i++) {
    const uint16_t* s = samples.data() + i * spp;
    uint8_t* o = rgb.data() + i * 3;
    if (grey) {
      uint32_t v = bps == 16 ? s[0] >> 8 : s[0];
      if (t.photometric == 0) v = range - v;
      o[0] = o[1] = o[2] = (uint8_t)(v * 255 / range);
    } else if (palette) {
      for (int k = 0; k < 3; k++) {
        const uint16_t e = t.cmap[k * ncol + s[0]];
        o[k] = (uint8_t)(cmap16 ? e >> 8 : e);
      }
    } else {
      for (int k = 0; k < 3; k++) o[k] = bps == 16 ? c8(s[k]) : (uint8_t)s[k];
      if (unassoc) {
        const uint32_t a = bps == 16 ? c8(s[3]) : s[3];
        for (int k = 0; k < 3; k++) o[k] = (uint8_t)((o[k] * a + 127) / 255);
      }
    }
  }
  // orientations 2-4: flips, as cv2 applies them
  const uint32_t o = t.orientation;
  if (o == 2 || o == 3 || o == 4) {
    std::vector<uint8_t> src(rgb);
    for (int y = 0; y < h; y++)
      for (int x = 0; x < w; x++) {
        const int sy = (o == 3 || o == 4) ? h - 1 - y : y, sx = (o == 2 || o == 3) ? w - 1 - x : x;
        memcpy(rgb.data() + ((size_t)y * w + x) * 3, src.data() + ((size_t)sy * w + sx) * 3, 3);
      }
  }
  return MGDT_OK;
}

// ---------------------------------------------------------------------------
// Whole-file decode and EXIF orientation
// ---------------------------------------------------------------------------

static bool is_webp(const uint8_t* d, size_t n) {
  return n >= 12 && !memcmp(d, "RIFF", 4) && !memcmp(d + 8, "WEBP", 4);
}

// The whole file into `buf`; with `decline_webp`, a WebP gives
// MGDT_ERR_FORMAT from its first 12 bytes, before the rest is read.
static int read_file(const char* path, std::vector<uint8_t>& buf, bool decline_webp = false) {
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
  const size_t head = std::min((size_t)n, (size_t)12);
  size_t got = fread(buf.data(), 1, head, f);
  if (decline_webp && got == head && is_webp(buf.data(), head)) {
    fclose(f);
    return MGDT_ERR_FORMAT;
  }
  if (got == head && (size_t)n > head) got += fread(buf.data() + head, 1, (size_t)n - head, f);
  fclose(f);
  return got == (size_t)n ? MGDT_OK : MGDT_ERR_OPEN;
}

// host_webp.cpp: a WebP file's bytes to RGB rows, and its EXIF chunk
// (nullptr where cv2 applies none)
int mgdt_decode_webp(const uint8_t* d, size_t n, std::vector<uint8_t>& rgb, int& w, int& h,
                     const uint8_t*& exif, size_t& exif_n);

// Decode a file's bytes to RGB rows; `orientation` receives a JPEG's or a
// WebP's EXIF orientation (1 for the other formats: a TIFF's is applied in
// its decoder).
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
  } else if (file[0] == 'B' && file[1] == 'M') {
    rc = decode_bmp(file, rgb, w, h);
  } else if (file.size() >= 4 && ((file[0] == 'I' && file[1] == 'I' && file[2] == 42 && file[3] == 0) ||
                                  (file[0] == 'M' && file[1] == 'M' && file[2] == 0 && file[3] == 42))) {
    rc = decode_tiff(file, rgb, w, h);
  } else if (is_webp(file.data(), file.size())) {
    const uint8_t* exif;
    size_t exif_n;
    rc = mgdt_decode_webp(file.data(), file.size(), rgb, w, h, exif, exif_n);
    if (exif) orientation = tiff_orientation(exif, exif_n);
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
  int rc = read_file(path, file, true);  // the JAX loader's cv2 path takes WebP
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
static int decode_bgr(const std::vector<uint8_t>& file, unsigned char** out, int* out_h,
                      int* out_w);

int mgdt_decode(const char* path, unsigned char** out, int* out_h, int* out_w) {
  *out = nullptr;
  *out_h = *out_w = 0;
  std::vector<uint8_t> file;
  int rc = read_file(path, file);
  if (rc != MGDT_OK) return rc;
  return decode_bgr(file, out, out_h, out_w);
}

// mgdt_decode of a file's bytes in memory (a video's frame).
int mgdt_decode_mem(const unsigned char* data, int64_t n, unsigned char** out, int* out_h,
                    int* out_w) {
  *out = nullptr;
  *out_h = *out_w = 0;
  if (n < 0) return MGDT_ERR_DECODE;
  std::vector<uint8_t> file(data, data + n);
  return decode_bgr(file, out, out_h, out_w);
}

// `data` (n bytes) with the standard Huffman tables inserted where a JPEG
// frame has none: a malloc'd copy (free it with mgdt_free) and its size,
// or null where the frame has its own tables.
unsigned char* mgdt_jpeg_standard_dht(const unsigned char* data, int64_t n, int64_t* out_n) {
  std::vector<uint8_t> out;
  *out_n = 0;
  if (n < 4 || !with_standard_dht(data, (size_t)n, out)) return nullptr;
  unsigned char* buf = (unsigned char*)malloc(out.size());
  if (!buf) return nullptr;
  memcpy(buf, out.data(), out.size());
  *out_n = (int64_t)out.size();
  return buf;
}

static int decode_bgr(const std::vector<uint8_t>& file, unsigned char** out, int* out_h,
                      int* out_w) {
  std::vector<uint8_t> rgb;
  int w = 0, h = 0, orientation = 1;
  int rc = decode_rgb(file, rgb, w, h, orientation);
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

// mgdt_decode_mem over n buffers on a thread pool.
void mgdt_decode_mem_batch(const unsigned char** datas, const int64_t* sizes, int n,
                           unsigned char** outs, int* hs, int* ws, int* status, int nthreads) {
  std::atomic<int> next(0);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      status[i] = mgdt_decode_mem(datas[i], sizes[i], outs + i, hs + i, ws + i);
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
