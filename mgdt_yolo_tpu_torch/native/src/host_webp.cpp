// WebP decode for the port's image ingest: the bits `cv2.imread` gives (cv2
// decodes WebP through libwebp), written from the public specifications and
// linked against no WebP library.
//
// * The container (RFC 9649): the RIFF header and its size, chunk padding,
//   a simple file (`VP8 ` or `VP8L`) and the extended one (`VP8X`: its
//   canvas and flags; `ICCP` and `XMP ` skipped; `ALPH`; `ANIM`/`ANMF`;
//   `EXIF`). A file whose `VP8X` carries the EXIF flag gives its first
//   `EXIF` chunk to the caller, which reads the orientation there (a bare
//   TIFF header, as cv2 reads it: a payload that starts with `Exif\0\0`
//   gives none) and applies it as it applies a JPEG's. An animation reads as its first
//   frame on a zeroed canvas (the first frame is not blended, and the
//   background colour is not used), the whole file checked as a demuxer
//   checks it.
// * VP8L (lossless, RFC 9649 section 3): prefix codes (simple and normal,
//   repeat codes 16/17/18), meta prefix codes, LZ77 backward references with
//   the 120-entry distance map, the colour cache, and the predictor,
//   cross-colour, subtract-green and colour-indexing transforms undone in
//   reverse order.
// * VP8 (lossy key frames, RFC 6386): decoded by the VP8 decoder the video
//   library shares (`host_vp8.h`); then the 4:2:0 planes to RGB with the
//   "fancy" upsampler and the 14-bit fixed-point conversion that libwebp's
//   RGB output applies.
// * `ALPH` is decoded to check it (a corrupt one refuses the file, as it
//   does in cv2); cv2's colour read drops alpha, so it changes no pixel.
// A file that breaks any of these rules, or is cut short, is refused where
// cv2 refuses it (MGDT_ERR_DECODE).
//
// Compiled beside `host_loader.cpp` into one library; `decode_rgb` there
// calls `mgdt_decode_webp`.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <new>
#include <vector>

#include "host_vp8.h"

namespace {

constexpr int OK = 0;
constexpr int ERR = -3;  // MGDT_ERR_DECODE

inline uint32_t le16(const uint8_t* p) { return p[0] | (p[1] << 8); }
inline uint32_t le24(const uint8_t* p) { return p[0] | (p[1] << 8) | (p[2] << 16); }
inline uint32_t le32(const uint8_t* p) { return le24(p) | ((uint32_t)p[3] << 24); }

static const uint8_t kCodeToPlane[120] = {
    24, 7, 23, 25, 40, 6, 39, 41, 22, 26, 38, 42, 56, 5, 55, 57,
    21, 27, 54, 58, 37, 43, 72, 4, 71, 73, 20, 28, 53, 59, 70, 74,
    36, 44, 88, 69, 75, 52, 60, 3, 87, 89, 19, 29, 86, 90, 35, 45,
    68, 76, 85, 91, 51, 61, 104, 2, 103, 105, 18, 30, 102, 106, 34, 46,
    84, 92, 67, 77, 101, 107, 50, 62, 120, 1, 119, 121, 83, 93, 17, 31,
    100, 108, 66, 78, 118, 122, 33, 47, 117, 123, 49, 63, 99, 109, 82, 94,
    0, 116, 124, 65, 79, 16, 32, 98, 110, 48, 115, 125, 81, 95, 64, 114,
    126, 97, 111, 80, 113, 127, 96, 112,
};

// ---------------------------------------------------------------------------
// VP8L: the lossless bitstream
// ---------------------------------------------------------------------------

// Bits LSB first; reads past the end give zeros. `eos` is the reference
// decoder's end-of-stream condition: more bits used than the stream holds
// (at least the 64 it buffers at its start).
struct LBits {
  const uint8_t* d;
  size_t n, pos = 0;
  uint64_t val = 0, used = 0, limit;
  int nb = 0;
  LBits(const uint8_t* data, size_t size) : d(data), n(size) {
    limit = std::max<uint64_t>(64, (uint64_t)size * 8);
  }
  inline void fill() {
    while (nb <= 56) {
      const uint64_t b = pos < n ? d[pos] : 0;
      pos++;
      val |= b << nb;
      nb += 8;
    }
  }
  inline uint32_t peek(int k) {
    if (nb < k) fill();
    return (uint32_t)(val & ((1ull << k) - 1));
  }
  inline void skip(int k) {
    val >>= k;
    nb -= k;
    used += k;
  }
  inline uint32_t read(int k) {
    if (k == 0) return 0;
    const uint32_t v = peek(k);
    skip(k);
    return v;
  }
  bool eos() const { return used > limit; }
};

// A canonical prefix code as a two-level table: 256 root entries read on
// the next 8 bits, links to second-level tables for longer codes. An entry
// is (length << 16) | symbol, or LINK | (subtable bits << 16) | offset.
constexpr uint32_t LINK = 1u << 24;
struct Huff {
  std::vector<uint32_t> t;
  bool single = false;  // one symbol, read on no bits
};

// Builds `h` from the code lengths; false where they are no code (all zero,
// over-subscribed or incomplete, as the reference decoder refuses them).
static bool build_huffman(const int* lens, int nsym, Huff& h) {
  int count[16] = {0};
  for (int s = 0; s < nsym; s++) {
    if (lens[s] > 15 || lens[s] < 0) return false;
    count[lens[s]]++;
  }
  if (count[0] == nsym) return false;
  for (int l = 1; l < 15; l++)
    if (count[l] > (1 << l)) return false;
  h.t.assign(256, 0);
  if (nsym - count[0] == 1) {
    int sym = 0;
    while (lens[sym] == 0) sym++;
    for (auto& e : h.t) e = (uint32_t)sym;
    h.single = true;
    return true;
  }
  h.single = false;
  int open = 1;
  for (int l = 1; l <= 15; l++) {
    open = 2 * open - count[l];
    if (open < 0) return false;
  }
  if (open != 0) return false;
  // canonical codes in (length, symbol) order, written bit-reversed
  int next[16];
  int code = 0;
  for (int l = 1; l <= 15; l++) {
    next[l] = code;
    code = (code + count[l]) << 1;
  }
  std::vector<int> rev(nsym, 0);
  int maxsub[256] = {0};
  for (int s = 0; s < nsym; s++) {
    const int l = lens[s];
    if (!l) continue;
    const int c = next[l]++;
    int r = 0;
    for (int b = 0; b < l; b++) r |= ((c >> b) & 1) << (l - 1 - b);
    rev[s] = r;
    if (l > 8) maxsub[r & 255] = std::max(maxsub[r & 255], l - 8);
  }
  int offs[256];
  for (int p = 0; p < 256; p++) {
    if (maxsub[p]) {
      offs[p] = (int)h.t.size();
      h.t[p] = LINK | ((uint32_t)maxsub[p] << 16) | (uint32_t)offs[p];
      h.t.resize(h.t.size() + ((size_t)1 << maxsub[p]), 0);
    }
  }
  for (int s = 0; s < nsym; s++) {
    const int l = lens[s];
    if (!l) continue;
    const uint32_t e = ((uint32_t)l << 16) | (uint32_t)s;
    if (l <= 8) {
      for (int k = rev[s]; k < 256; k += 1 << l) h.t[k] = e;
    } else {
      const int p = rev[s] & 255, sb = maxsub[p], rest = rev[s] >> 8;
      for (int k = rest; k < (1 << sb); k += 1 << (l - 8)) h.t[offs[p] + k] = e;
    }
  }
  return true;
}

static inline int read_symbol(const Huff& h, LBits& br) {
  const uint32_t bits = br.peek(15);
  uint32_t e = h.t[bits & 255];
  if (e & LINK) {
    const int sb = (e >> 16) & 0xff;
    e = h.t[(e & 0xffff) + ((bits >> 8) & ((1u << sb) - 1))];
  }
  br.skip((e >> 16) & 0xff);
  return (int)(e & 0xffff);
}

static const uint8_t kCodeLengthOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6,
                                             7, 8, 9, 10, 11, 12, 13, 14, 15};

static bool read_code_lengths(LBits& br, const int* cl, int nsym, int* lens) {
  Huff t;
  if (!build_huffman(cl, 19, t)) return false;
  int max_symbol = nsym;
  if (br.read(1)) {
    const int nbits = 2 + 2 * (int)br.read(3);
    max_symbol = 2 + (int)br.read(nbits);
    if (max_symbol > nsym) return false;
  }
  int prev = 8, sym = 0;
  while (sym < nsym) {
    if (max_symbol-- == 0) break;
    const int c = read_symbol(t, br);
    if (c < 16) {
      lens[sym++] = c;
      if (c) prev = c;
    } else {
      static const int kExtra[3] = {2, 3, 7}, kOffset[3] = {3, 3, 11};
      const int slot = c - 16;
      const int rep = (int)br.read(kExtra[slot]) + kOffset[slot];
      if (sym + rep > nsym) return false;
      const int v = c == 16 ? prev : 0;
      for (int k = 0; k < rep; k++) lens[sym++] = v;
    }
  }
  return true;
}

static bool read_huffman_code(LBits& br, int nsym, Huff& h) {
  std::vector<int> lens(std::max(nsym, 256), 0);
  if (br.read(1)) {  // simple code: one or two symbols of length 1
    const int n = (int)br.read(1) + 1;
    const int first_bits = br.read(1) ? 8 : 1;
    lens[br.read(first_bits)] = 1;
    if (n == 2) lens[br.read(8)] = 1;
  } else {
    int cl[19] = {0};
    const int ncodes = (int)br.read(4) + 4;
    for (int i = 0; i < ncodes; i++) cl[kCodeLengthOrder[i]] = (int)br.read(3);
    if (!read_code_lengths(br, cl, nsym, lens.data())) return false;
  }
  if (br.eos()) return false;
  return build_huffman(lens.data(), nsym, h);
}

static inline int subsample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

struct Transform {
  int type, bits, xsize;
  std::vector<uint32_t> data;
};

struct LDecoder {
  LBits br;
  int seen = 0;
  std::vector<Transform> transforms;
  explicit LDecoder(const uint8_t* d, size_t n) : br(d, n) {}
  bool decode_stream(int xsize, int ysize, bool level0, std::vector<uint32_t>& out,
                     bool alpha = false);
  bool read_transform(int& xsize, int ysize);
};

static inline uint32_t cache_key(uint32_t argb, int shift) { return (argb * 0x1e35a7bdu) >> shift; }

static int copy_distance(int sym, LBits& br) {
  if (sym < 4) return sym + 1;
  const int extra = (sym - 2) >> 1;
  const int offset = (2 + (sym & 1)) << extra;
  return offset + (int)br.read(extra) + 1;
}

static int plane_to_distance(int xsize, int code) {
  if (code > 120) return code - 120;
  const int c = kCodeToPlane[code - 1];
  const int dist = (c >> 4) * xsize + (8 - (c & 0xf));
  return dist >= 1 ? dist : 1;
}

bool LDecoder::decode_stream(int xsize, int ysize, bool level0, std::vector<uint32_t>& out,
                             bool alpha) {
  int tx = xsize;
  if (level0) {
    while (br.read(1)) {
      if (!read_transform(tx, ysize)) return false;
    }
  }
  int cache_bits = 0;
  if (br.read(1)) {
    cache_bits = (int)br.read(4);
    if (cache_bits < 1 || cache_bits > 11) return false;
  }
  // meta prefix codes
  int meta_bits = 0, meta_x = 0;
  std::vector<uint32_t> meta;
  int ngroups = 1;
  if (level0 && br.read(1)) {
    meta_bits = (int)br.read(3) + 2;
    meta_x = subsample(tx, meta_bits);
    if (!decode_stream(meta_x, subsample(ysize, meta_bits), false, meta)) return false;
    for (auto& m : meta) {
      m = (m >> 8) & 0xffff;
      ngroups = std::max(ngroups, (int)m + 1);
    }
  }
  if (br.eos()) return false;
  // the groups the entropy image uses are kept; the others are read and checked
  std::vector<int> slot(ngroups, -1);
  int nused = 0;
  if (meta.empty()) {
    slot[0] = nused++;
  } else {
    for (auto& m : meta) {
      if (slot[m] < 0) slot[m] = nused++;
      m = (uint32_t)slot[m];
    }
  }
  static const int kAlphabet[5] = {256 + 24, 256, 256, 256, 40};
  std::vector<Huff> codes((size_t)nused * 5);
  Huff scratch;
  for (int g = 0; g < ngroups; g++) {
    for (int j = 0; j < 5; j++) {
      const int nsym = kAlphabet[j] + (j == 0 && cache_bits ? 1 << cache_bits : 0);
      Huff& h = slot[g] >= 0 ? codes[(size_t)slot[g] * 5 + j] : scratch;
      if (!read_huffman_code(br, nsym, h)) return false;
    }
  }
  // the 8-bit alpha path of the reference decoder stops at the end of the
  // stream only where pixels remain
  bool lenient = false;
  if (alpha && transforms.size() == 1 && transforms[0].type == 3 && !cache_bits) {
    lenient = true;
    for (int g = 0; g < nused; g++)
      for (int j = 1; j <= 3; j++) lenient = lenient && codes[(size_t)g * 5 + j].single;
  }

  const size_t total = (size_t)tx * ysize;
  out.assign(total, 0);
  std::vector<uint32_t> cache(cache_bits ? (size_t)1 << cache_bits : 0);
  const int shift = 32 - cache_bits;
  size_t pos = 0, cached = 0;
  int col = 0, row = 0;
  const int mask = meta_bits ? (1 << meta_bits) - 1 : -1;
  const Huff* grp = codes.data();
  auto group_at = [&](int x, int y) {
    return meta.empty() ? codes.data()
                        : codes.data() + (size_t)meta[(size_t)(y >> meta_bits) * meta_x +
                                                      (x >> meta_bits)] * 5;
  };
  auto insert_cached = [&]() {
    if (cache_bits)
      for (; cached < pos; cached++) cache[cache_key(out[cached], shift)] = out[cached];
  };
  while (pos < total) {
    if ((col & mask) == 0) grp = group_at(col, row);
    const int code = read_symbol(grp[0], br);
    if (code < 256) {
      const int r = read_symbol(grp[1], br);
      const int b = read_symbol(grp[2], br);
      const int a = read_symbol(grp[3], br);
      out[pos++] = ((uint32_t)a << 24) | (r << 16) | (code << 8) | b;
      if (++col >= tx) {
        col = 0;
        row++;
      }
    } else if (code < 256 + 24) {
      const int length = copy_distance(code - 256, br);
      const int dsym = read_symbol(grp[4], br);
      const int dist = plane_to_distance(tx, copy_distance(dsym, br));
      if (br.eos() && !lenient) return false;
      if (pos < (size_t)dist || total - pos < (size_t)length) return false;
      for (int k = 0; k < length; k++, pos++) out[pos] = out[pos - dist];
      col += length;
      while (col >= tx) {
        col -= tx;
        row++;
      }
      if (pos < total) grp = group_at(col, row);
    } else {
      const int key = code - 280;
      if (key >= (int)cache.size()) return false;
      insert_cached();
      out[pos++] = cache[key];
      if (++col >= tx) {
        col = 0;
        row++;
      }
    }
    insert_cached();
    if (br.eos() && (!lenient || pos < total)) return false;
  }
  return !(br.eos() && !lenient);
}

bool LDecoder::read_transform(int& xsize, int ysize) {
  const int type = (int)br.read(2);
  if (seen & (1 << type)) return false;
  seen |= 1 << type;
  Transform t;
  t.type = type;
  t.xsize = xsize;
  t.bits = 0;
  if (type == 0 || type == 1) {  // predictor, cross-colour
    t.bits = (int)br.read(3) + 2;
    if (!decode_stream(subsample(xsize, t.bits), subsample(ysize, t.bits), false, t.data))
      return false;
  } else if (type == 3) {  // colour indexing
    const int ncolors = (int)br.read(8) + 1;
    t.bits = ncolors > 16 ? 0 : ncolors > 4 ? 1 : ncolors > 2 ? 2 : 3;
    xsize = subsample(xsize, t.bits);
    std::vector<uint32_t> pal;
    if (!decode_stream(ncolors, 1, false, pal)) return false;
    // the palette is delta-coded; entries past it are transparent black
    t.data.assign((size_t)1 << (8 >> t.bits), 0);
    uint8_t* dst = (uint8_t*)t.data.data();
    const uint8_t* src = (const uint8_t*)pal.data();
    for (int i = 0; i < 4; i++) dst[i] = src[i];
    for (int i = 4; i < 4 * ncolors; i++) dst[i] = (uint8_t)(src[i] + dst[i - 4]);
  }
  transforms.push_back(std::move(t));
  return true;
}

static inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  return (((a & 0xff00ff00u) + (b & 0xff00ff00u)) & 0xff00ff00u) |
         (((a & 0x00ff00ffu) + (b & 0x00ff00ffu)) & 0x00ff00ffu);
}
static inline uint32_t average2(uint32_t a, uint32_t b) {
  return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}
static inline int clip255(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }
static inline uint32_t select_pred(uint32_t t, uint32_t l, uint32_t tl) {
  int d = 0;
  for (int s = 0; s < 32; s += 8) {
    const int a = (t >> s) & 0xff, b = (l >> s) & 0xff, c = (tl >> s) & 0xff;
    d += std::abs(b - c) - std::abs(a - c);
  }
  return d <= 0 ? t : l;
}
static inline uint32_t add_subtract_full(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8)
    out |= (uint32_t)clip255((int)((a >> s) & 0xff) + (int)((b >> s) & 0xff) -
                             (int)((c >> s) & 0xff)) << s;
  return out;
}
static inline uint32_t add_subtract_half(uint32_t a, uint32_t b, uint32_t c) {
  const uint32_t ave = average2(a, b);
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int x = (ave >> s) & 0xff, y = (c >> s) & 0xff;
    out |= (uint32_t)clip255(x + (x - y) / 2) << s;
  }
  return out;
}

static inline uint32_t predict(int mode, const uint32_t* p, int w) {
  const uint32_t L = p[-1], T = p[-w], TL = p[-w - 1], TR = p[-w + 1];
  switch (mode) {
    case 1: return L;
    case 2: return T;
    case 3: return TR;
    case 4: return TL;
    case 5: return average2(average2(L, TR), T);
    case 6: return average2(L, TL);
    case 7: return average2(L, T);
    case 8: return average2(TL, T);
    case 9: return average2(T, TR);
    case 10: return average2(average2(L, TL), average2(T, TR));
    case 11: return select_pred(T, L, TL);
    case 12: return add_subtract_full(L, T, TL);
    case 13: return add_subtract_half(L, T, TL);
    default: return 0xff000000u;  // 0, and 14 and 15
  }
}

// Undoes the transforms in reverse order; `px` holds the coded image of
// width `width` and receives the ARGB image.
static void inverse_transforms(std::vector<Transform>& ts, std::vector<uint32_t>& px, int height) {
  for (int i = (int)ts.size() - 1; i >= 0; i--) {
    const Transform& t = ts[i];
    const int w = t.xsize;
    if (t.type == 0) {  // predictor
      uint32_t* p = px.data();
      p[0] = add_pixels(p[0], 0xff000000u);
      for (int x = 1; x < w; x++) p[x] = add_pixels(p[x], p[x - 1]);
      const int tiles = subsample(w, t.bits);
      for (int y = 1; y < height; y++) {
        uint32_t* r = p + (size_t)y * w;
        const uint32_t* modes = t.data.data() + (size_t)(y >> t.bits) * tiles;
        r[0] = add_pixels(r[0], r[-w]);
        for (int x = 1; x < w; x++) {
          const int mode = (modes[x >> t.bits] >> 8) & 0xf;
          r[x] = add_pixels(r[x], predict(mode, r + x, w));
        }
      }
    } else if (t.type == 1) {  // cross-colour
      const int tiles = subsample(w, t.bits);
      for (int y = 0; y < height; y++) {
        uint32_t* r = px.data() + (size_t)y * w;
        const uint32_t* codes = t.data.data() + (size_t)(y >> t.bits) * tiles;
        for (int x = 0; x < w; x++) {
          const uint32_t c = codes[x >> t.bits];
          const int g2r = (int8_t)(c & 0xff), g2b = (int8_t)((c >> 8) & 0xff),
                    r2b = (int8_t)((c >> 16) & 0xff);
          const uint32_t argb = r[x];
          const int green = (int8_t)((argb >> 8) & 0xff);
          int red = (argb >> 16) & 0xff, blue = argb & 0xff;
          red = (red + ((g2r * green) >> 5)) & 0xff;
          blue += (g2b * green) >> 5;
          blue += (r2b * (int8_t)red) >> 5;
          blue &= 0xff;
          r[x] = (argb & 0xff00ff00u) | ((uint32_t)red << 16) | (uint32_t)blue;
        }
      }
    } else if (t.type == 2) {  // subtract green
      for (auto& v : px) {
        const uint32_t g = (v >> 8) & 0xff;
        v = (v & 0xff00ff00u) | ((((v >> 16) + g) & 0xff) << 16) | (((v & 0xff) + g) & 0xff);
      }
    } else {  // colour indexing, pixel bundling below 17 colours
      const int bits = t.bits, packed_w = subsample(w, bits);
      std::vector<uint32_t> out((size_t)w * height);
      const int per = 8 >> bits, mask = (1 << per) - 1;
      for (int y = 0; y < height; y++) {
        const uint32_t* s = px.data() + (size_t)y * packed_w;
        uint32_t* o = out.data() + (size_t)y * w;
        for (int x = 0; x < w; x++) {
          const uint32_t idx = (s[x >> bits] >> 8) & 0xff;
          o[x] = t.data[(idx >> ((x & ((1 << bits) - 1)) * per)) & mask];
        }
      }
      px.swap(out);
    }
  }
}

// A VP8L image stream from its header on: ARGB pixels, or false.
static bool decode_vp8l(const uint8_t* d, size_t n, std::vector<uint32_t>& argb, int& w, int& h) {
  if (n < 5 || d[0] != 0x2f) return false;
  LDecoder dec(d, n);
  dec.br.read(8);  // the signature
  w = (int)dec.br.read(14) + 1;
  h = (int)dec.br.read(14) + 1;
  dec.br.read(1);  // alpha hint
  if (dec.br.read(3) != 0) return false;
  if (!dec.decode_stream(w, h, true, argb)) return false;
  inverse_transforms(dec.transforms, argb, h);
  return true;
}

// Checks an `ALPH` payload for an image of (w, h) as the reference decoder
// reads it: its header, and a compressed plane's whole VP8L stream. The
// values are not needed: the colour read drops alpha.
static bool alpha_ok(const uint8_t* a, size_t n, int w, int h) {
  if (n <= 1) return false;
  const int method = a[0] & 3, pre = (a[0] >> 4) & 3, reserved = a[0] >> 6;
  if (method > 1 || pre > 1 || reserved) return false;
  if (method == 0) return n - 1 >= (size_t)w * h;
  LDecoder dec(a + 1, n - 1);
  std::vector<uint32_t> px;
  return dec.decode_stream(w, h, true, px, true);
}


// libwebp's RGB output of 4:2:0: the 14-bit fixed-point conversion ...
static inline int mult_hi(int v, int c) { return (v * c) >> 8; }
static inline uint8_t yuv_clip(int v) {
  return ((v & ~16383) == 0) ? (uint8_t)(v >> 6) : (v < 0) ? 0 : 255;
}
static inline void yuv_to_rgb(int y, int u, int v, uint8_t* rgb) {
  rgb[0] = yuv_clip(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
  rgb[1] = yuv_clip(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
  rgb[2] = yuv_clip(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
}

// ... and its "fancy" upsampler: one output row from the chroma row nearest
// it and the one beyond, each sample (9a + 3b + 3c + d) / 16 in its two
// rounding stages; the first and the last columns from their nearest
// chroma column alone.
static void upsample_row(const uint8_t* y, const uint8_t* nu, const uint8_t* nv,
                         const uint8_t* fu, const uint8_t* fv, uint8_t* out, int len) {
  auto edge_px = [&](int yi, int c) {
    yuv_to_rgb(y[yi], (3 * nu[c] + fu[c] + 2) >> 2, (3 * nv[c] + fv[c] + 2) >> 2, out + 3 * yi);
  };
  edge_px(0, 0);
  const int pairs = (len - 1) >> 1;
  for (int x = 1; x <= pairs; x++) {
    int uv[2][2];
    const uint8_t* near[2] = {nu, nv};
    const uint8_t* far[2] = {fu, fv};
    for (int c = 0; c < 2; c++) {
      const int a = near[c][x - 1], b = near[c][x], cc = far[c][x - 1], d = far[c][x];
      const int avg = a + b + cc + d + 8;
      const int diag_ad = (avg + 2 * (b + cc)) >> 3;  // towards a (and d)
      const int diag_bc = (avg + 2 * (a + d)) >> 3;   // towards b (and c)
      uv[0][c] = (diag_ad + a) >> 1;
      uv[1][c] = (diag_bc + b) >> 1;
    }
    yuv_to_rgb(y[2 * x - 1], uv[0][0], uv[0][1], out + 3 * (2 * x - 1));
    yuv_to_rgb(y[2 * x], uv[1][0], uv[1][1], out + 3 * (2 * x));
  }
  if (!(len & 1)) edge_px(len - 1, pairs);
}

// A VP8 key frame (its bytes run to the end of the file) to RGB rows;
// `alpha`, where non-null, is the image's ALPH payload, checked.
static int decode_vp8(const uint8_t* d, size_t n, const uint8_t* alpha, size_t alpha_n,
                      std::vector<uint8_t>& rgb, int& w, int& h) {
  vp8::VP8Decoder dec;
  if (dec.decode_frame(d, n) != vp8::OK) return ERR;
  if (alpha && !alpha_ok(alpha, alpha_n, dec.width, dec.height)) return ERR;
  w = dec.width;
  h = dec.height;
  rgb.resize((size_t)w * h * 3);
  const int uvh = (h + 1) / 2;
  for (int y = 0; y < h; y++) {
    int nr, fr;  // the nearest chroma row and the one beyond it
    if (y == 0) {
      nr = fr = 0;
    } else if (y & 1) {
      nr = (y - 1) / 2;
      fr = std::min((y + 1) / 2, uvh - 1);
    } else {
      nr = y / 2;
      fr = y / 2 - 1;
    }
    upsample_row(&dec.Y[(size_t)y * dec.ys], &dec.U[(size_t)nr * dec.uvs], &dec.V[(size_t)nr * dec.uvs],
                 &dec.U[(size_t)fr * dec.uvs], &dec.V[(size_t)fr * dec.uvs],
                 &rgb[(size_t)y * w * 3], w);
  }
  return OK;
}

// ---------------------------------------------------------------------------
// The container (RFC 9649 section 2)
// ---------------------------------------------------------------------------

constexpr uint32_t MAX_PAYLOAD = 0xfffffff6u;
constexpr uint32_t FLAG_ANIMATION = 0x02, FLAG_EXIF = 0x08, FLAG_ALL = 0x3e;

inline bool is_tag(const uint8_t* p, const char* tag) { return memcmp(p, tag, 4) == 0; }

// The header checks of a VP8 or VP8L bitstream (`d`, `n` bytes to the end
// of the data; `chunk` its chunk's size): its size, or false.
static bool bitstream_info(const uint8_t* d, size_t n, size_t chunk, bool lossless, int& w,
                           int& h) {
  if (lossless) {
    if (n < 5 || d[0] != 0x2f || (d[4] >> 5) != 0) return false;
    LBits br(d, n);
    br.read(8);
    w = (int)br.read(14) + 1;
    h = (int)br.read(14) + 1;
    br.read(1);
    return br.read(3) == 0;
  }
  if (n < 10 || d[3] != 0x9d || d[4] != 0x01 || d[5] != 0x2a) return false;
  const uint32_t tag = le24(d);
  if ((tag & 1) || ((tag >> 1) & 7) > 3 || !((tag >> 4) & 1) || (tag >> 5) >= chunk) return false;
  w = le16(d + 6) & 0x3fff;
  h = le16(d + 8) & 0x3fff;
  return w && h;
}

// Decodes one image: `alpha` (or null) its ALPH payload, `d` its VP8 or
// VP8L bytes to the end of the data.
static int decode_image(const uint8_t* alpha, size_t alpha_n, const uint8_t* d, size_t n,
                        bool lossless, std::vector<uint8_t>& rgb, int& w, int& h) {
  if (!lossless) return decode_vp8(d, n, alpha, alpha_n, rgb, w, h);
  std::vector<uint32_t> argb;
  if (!decode_vp8l(d, n, argb, w, h)) return ERR;
  rgb.resize((size_t)w * h * 3);
  for (size_t i = 0; i < argb.size(); i++) {
    rgb[3 * i] = (uint8_t)(argb[i] >> 16);
    rgb[3 * i + 1] = (uint8_t)(argb[i] >> 8);
    rgb[3 * i + 2] = (uint8_t)argb[i];
  }
  return OK;
}

struct Frame {
  int x = 0, y = 0, w = 0, h = 0;
  const uint8_t *alpha = nullptr, *image = nullptr;
  size_t alpha_n = 0, image_n = 0;  // payload sizes (the image's to its chunk's end)
  bool lossless = false;
};

// Walks the chunks after VP8X to the end of the RIFF data as a demuxer
// does: false where one does not fit. Collects the first EXIF payload and,
// for an animation, its frames.
static bool walk_extended(const uint8_t* d, size_t end, uint32_t flags, const uint8_t*& exif,
                          size_t& exif_n, std::vector<Frame>* frames) {
  const bool anim = flags & FLAG_ANIMATION;
  size_t p = 12 + 18;
  int anim_chunks = 0;
  exif = nullptr;
  exif_n = 0;
  while (p < end) {
    if (end - p < 8) return false;
    const uint32_t size = le32(d + p + 4);
    if (size > MAX_PAYLOAD) return false;
    const size_t padded = (size_t)size + (size & 1);
    if (padded > end - p - 8) return false;
    const uint8_t* tag = d + p;
    const size_t body = p + 8;
    if (is_tag(tag, "VP8X")) return false;
    if (is_tag(tag, "ALPH") || is_tag(tag, "VP8 ") || is_tag(tag, "VP8L")) {
      if (anim_chunks > 0 || anim) return false;
    } else if (is_tag(tag, "ANIM")) {
      if (size < 6) return false;
      anim_chunks++;
    } else if (is_tag(tag, "ANMF")) {
      if (anim_chunks == 0 || padded < 16) return false;
      if (frames) {
        Frame f;
        f.x = 2 * (int)le24(d + body);
        f.y = 2 * (int)le24(d + body + 3);
        // the frame's sub-chunks: an optional ALPH, then its image
        const size_t fend = body + padded;
        size_t q = body + 16;
        bool have_alpha = false, have_image = false;
        while (fend - q >= 8) {
          const uint32_t s = le32(d + q + 4);
          if (s > MAX_PAYLOAD) return false;
          const size_t sp = (size_t)s + (s & 1);
          if (sp > fend - q - 8) return false;
          if (is_tag(d + q, "ALPH") && !have_alpha && !have_image) {
            have_alpha = true;
            f.alpha = d + q + 8;
            f.alpha_n = s;
          } else if ((is_tag(d + q, "VP8 ") || is_tag(d + q, "VP8L")) && !have_image) {
            f.lossless = is_tag(d + q, "VP8L");
            if (f.lossless && have_alpha) return false;
            f.image = d + q + 8;
            f.image_n = sp;
            if (!bitstream_info(f.image, sp, s, f.lossless, f.w, f.h)) return false;
            have_image = true;
          } else {
            break;
          }
          q += 8 + sp;
        }
        if (!have_image) return false;
        frames->push_back(f);
      }
    } else if (is_tag(tag, "EXIF")) {
      if ((flags & FLAG_EXIF) && !exif) {
        exif = d + body;
        exif_n = size;
      }
    }
    p = body + padded;
  }
  return true;
}

static int decode_animation(const uint8_t* d, size_t end, uint32_t flags, int cw, int ch,
                            std::vector<uint8_t>& rgb, int& w, int& h, const uint8_t*& exif,
                            size_t& exif_n) {
  // cv2 refuses (raises) a canvas beyond 2^20 a side or 2^30 pixels
  if (cw > (1 << 20) || ch > (1 << 20) || (uint64_t)cw * ch > (1ull << 30)) return ERR;
  if (flags & ~FLAG_ALL) return ERR;
  std::vector<Frame> frames;
  if (!walk_extended(d, end, flags, exif, exif_n, &frames) || frames.empty()) return ERR;
  for (const Frame& f : frames)
    if (f.x + f.w > cw || f.y + f.h > ch) return ERR;
  // the first frame on a zeroed canvas, not blended
  const Frame& f = frames[0];
  std::vector<uint8_t> px;
  int fw, fh;
  if (decode_image(f.alpha, f.alpha_n, f.image, f.image_n, f.lossless, px, fw, fh) != OK)
    return ERR;
  rgb.assign((size_t)cw * ch * 3, 0);
  for (int y = 0; y < fh; y++)
    memcpy(&rgb[((size_t)(f.y + y) * cw + f.x) * 3], &px[(size_t)y * fw * 3], (size_t)fw * 3);
  w = cw;
  h = ch;
  return OK;
}

static int decode_file(const uint8_t* d, size_t n, std::vector<uint8_t>& rgb, int& w, int& h,
                       const uint8_t*& exif, size_t& exif_n) {
  exif = nullptr;
  exif_n = 0;
  // cv2 reads a 32-byte header first
  if (n < 32 || !is_tag(d, "RIFF") || !is_tag(d + 8, "WEBP")) return ERR;
  const uint32_t riff = le32(d + 4);
  if (riff < 12 || riff > MAX_PAYLOAD || riff > n - 8) return ERR;
  const size_t riff_end = (size_t)riff + 8;
  const uint8_t* p = d + 12;
  size_t left = n - 12;
  bool vp8x = false;
  uint32_t flags = 0;
  int cw = 0, ch = 0;
  if (is_tag(p, "VP8X")) {
    if (le32(p + 4) != 10) return ERR;
    flags = le32(p + 8);
    cw = 1 + (int)le24(p + 12);
    ch = 1 + (int)le24(p + 15);
    if ((uint64_t)cw * ch >= (1ull << 32)) return ERR;
    vp8x = true;
    p += 18;
    left -= 18;
    if (flags & FLAG_ANIMATION)
      return decode_animation(d, riff_end, flags, cw, ch, rgb, w, h, exif, exif_n);
  }
  if (left < 4) return ERR;
  const uint8_t* alpha = nullptr;
  size_t alpha_n = 0;
  if (vp8x) {  // the chunks before the image: the last ALPH is its alpha
    uint32_t total = 4 + 8 + 10;
    for (;;) {
      if (left < 8) return ERR;
      const uint32_t size = le32(p + 4);
      if (size > MAX_PAYLOAD) return ERR;
      const uint32_t disk = (8 + size + 1) & ~1u;
      total += disk;
      if (total > riff) return ERR;
      if (is_tag(p, "VP8 ") || is_tag(p, "VP8L")) break;
      if (left < disk) return ERR;
      if (is_tag(p, "ALPH")) {
        alpha = p + 8;
        alpha_n = size;
      }
      p += disk;
      left -= disk;
    }
  }
  if (left < 8) return ERR;
  bool lossless = is_tag(p, "VP8L");
  size_t chunk;
  if (lossless || is_tag(p, "VP8 ")) {
    const uint32_t size = le32(p + 4);
    if (size > riff - 12 || size > left - 8) return ERR;
    chunk = size;
    p += 8;
    left -= 8;
  } else {  // a bare bitstream
    lossless = left >= 5 && p[0] == 0x2f && (p[4] >> 5) == 0;
    chunk = left;
  }
  int iw, ih;
  if (!bitstream_info(p, left, chunk, lossless, iw, ih)) return ERR;
  if (vp8x && (iw != cw || ih != ch)) return ERR;
  const int rc = decode_image(lossless ? nullptr : alpha, alpha_n, p, left, lossless, rgb, w, h);
  if (rc != OK) return rc;
  if (vp8x && (flags & FLAG_EXIF) &&
      !walk_extended(d, std::min(riff_end, n), flags, exif, exif_n, nullptr))
    exif = nullptr;
  return OK;
}

}  // namespace

// A WebP file's bytes to RGB rows, as `cv2.imread` reads them; `exif`
// (`exif_n` bytes) receives the EXIF chunk whose orientation cv2 applies,
// nullptr where there is none. Returns 0, or -3 (MGDT_ERR_DECODE) for a
// file cv2 refuses.
int mgdt_decode_webp(const uint8_t* d, size_t n, std::vector<uint8_t>& rgb, int& w, int& h,
                     const uint8_t*& exif, size_t& exif_n) {
  try {
    return decode_file(d, n, rgb, w, h, exif, exif_n);
  } catch (const std::bad_alloc&) {  // a corrupt header's size: refused, not thrown past C
    return ERR;
  }
}
