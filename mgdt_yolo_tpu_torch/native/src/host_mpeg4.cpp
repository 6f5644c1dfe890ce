// MPEG-4 Part 2 video (ISO/IEC 14496-2) for the port's video sources: the
// Simple Profile, decoded as ffmpeg decodes it, since the JAX package reads
// these videos through cv2.VideoCapture (ffmpeg). Written from the
// standard; linked against no codec library.
//
// * Headers: visual object sequence, visual object, video object layer
//   (with its `vop_time_increment_resolution` and any size, the picture
//   kept in whole macroblocks and cut to the layer's size), group of VOPs,
//   user data (which names the encoder), VOP.
// * Macroblocks of I- and P-VOPs: not-coded macroblocks, MCBPC, CBPY and
//   DQUANT; intra DC by its own VLC or as the first coefficient (by the
//   VOP's `intra_dc_vlc_thr`), DC and AC prediction with their direction and
//   the AC rescaled between quantisers; the intra and inter TCOEF tables
//   with the three escape modes; H.263 dequantisation.
// * Motion: median prediction of one or four vectors a macroblock (4MV,
//   with its chroma vector), `f_code`, half-pel compensation with the VOP's
//   `rounding_type`, unrestricted vectors over a reference extended at its
//   edges; resync markers and the video packets they start.
// * The IDCT is the one ffmpeg chooses for the stream: its "simple" IDCT,
//   or Xvid's where the user data (or, without any, an AVI's `XVID` fourcc)
//   names Xvid. The standard leaves the IDCT's last bit to the decoder, and
//   P-VOPs carry a difference on to the next I-VOP, so the choice is kept.
// * ffmpeg's workarounds that these encoders' versions turn on: picture
//   edges at the layer's size (old Xvid, DivX 4, old ffmpeg) and unclipped
//   intra DC (old Xvid and ffmpeg).
// * Every tool outside the Simple Profile is refused by name (C_UNSUPPORTED):
//   B-VOPs, S(GMC)-VOPs and sprites, quarter-pel, MPEG quantisation
//   matrices, interlace, data partitioning and reversible VLC, NEWPRED,
//   reduced resolution, scalability, arbitrary shape, not-8-bit, the
//   complexity estimation header, short_video_header (H.263), and packed
//   bitstreams (two coded VOPs in one sample).
//
// Compiled into the video library (`host_video.cpp`, utils/build.py's
// HOST_VIDEO).

#include <algorithm>
#include <cstdio>
#include <cstdlib>
#include <cstring>

#include "host_codecs.h"

namespace mgdt_codec {
namespace {

// ---------------------------------------------------------------- bits

struct Bits {
  const uint8_t* d = nullptr;
  size_t nbytes = 0;
  int64_t nbits = 0, pos = 0;
  void init(const uint8_t* p, size_t n) {
    d = p;
    nbytes = n;
    nbits = (int64_t)n * 8;
    pos = 0;
  }
  uint32_t peek32() const {  // the next 32 bits, zeros past the end
    const size_t byte = (size_t)(pos >> 3);
    uint64_t v = 0;
    for (size_t i = 0; i < 5; i++) v = v << 8 | (byte + i < nbytes ? d[byte + i] : 0);
    return (uint32_t)(v >> (8 - (pos & 7)));
  }
  uint32_t show(int k) const { return k ? peek32() >> (32 - k) : 0; }
  uint32_t get(int k) {
    const uint32_t v = show(k);
    pos += k;
    return v;
  }
  int get1() { return (int)get(1); }
  int sget(int k) {  // two's complement
    const int v = (int)get(k);
    return v >= (1 << (k - 1)) ? v - (1 << k) : v;
  }
  int xbits(int k) {  // MPEG's DC differential: a leading 0 marks a negative value
    const int v = (int)get(k);
    return (v >> (k - 1)) ? v : v - (1 << k) + 1;
  }
  void align() { pos = (pos + 7) & ~(int64_t)7; }
  int64_t left() const { return nbits - pos; }
};

// ---------------------------------------------------------------- VLCs

struct Vlc {
  int bits = 0;
  std::vector<int16_t> sym;
  std::vector<uint8_t> len;
  // codes[i] = {code, length} of symbol i
  Vlc(const uint16_t (*codes)[2], int n, int maxbits) : bits(maxbits) {
    sym.assign((size_t)1 << maxbits, -1);
    len.assign((size_t)1 << maxbits, 0);
    for (int i = 0; i < n; i++) {
      const int l = codes[i][1];
      if (!l) continue;
      const uint32_t first = (uint32_t)codes[i][0] << (maxbits - l);
      for (uint32_t k = 0; k < (1u << (maxbits - l)); k++) {
        sym[first + k] = (int16_t)i;
        len[first + k] = (uint8_t)l;
      }
    }
  }
  int read(Bits& b) const {
    const uint32_t c = b.show(bits);
    const int s = sym[c];
    if (s >= 0) b.pos += len[c];
    return s;
  }
};

// MCBPC of I-VOPs (H.263 table 7): index = dquant << 2 | cbpc, 8 stuffing
const uint16_t kIntraMcbpc[9][2] = {{1, 1}, {1, 3}, {2, 3}, {3, 3}, {1, 4},
                                    {1, 6}, {2, 6}, {3, 6}, {1, 9}};
// MCBPC of P-VOPs (H.263 table 8): index = 4mv << 4 | dquant << 3 | intra << 2
// | cbpc, 20 stuffing
const uint16_t kInterMcbpc[28][2] = {
    {1, 1}, {3, 4}, {2, 4}, {5, 6}, {3, 5}, {4, 8}, {3, 8}, {3, 7}, {3, 3}, {7, 7},
    {6, 7}, {5, 9}, {4, 6}, {4, 9}, {3, 9}, {2, 9}, {2, 3}, {5, 7}, {4, 7}, {5, 8},
    {1, 9}, {0, 0}, {0, 0}, {0, 0}, {0, 0}, {0, 0}, {0, 0}, {0, 0}};
// CBPY (H.263 table 9), of intra macroblocks; inverted for inter ones
const uint16_t kCbpy[16][2] = {{3, 4}, {5, 5}, {4, 5}, {9, 4}, {3, 5}, {7, 4},
                               {2, 6}, {11, 4}, {2, 5}, {3, 6}, {5, 4}, {10, 4},
                               {4, 4}, {8, 4}, {6, 4}, {3, 2}};
// motion vector data, |MVD| 0..32 (table B-12)
const uint16_t kMv[33][2] = {
    {1, 1},   {1, 2},   {1, 3},   {1, 4},   {3, 6},   {5, 7},   {4, 7},   {3, 7},   {11, 9},
    {10, 9},  {9, 9},   {17, 10}, {16, 10}, {15, 10}, {14, 10}, {13, 10}, {12, 10}, {11, 10},
    {10, 10}, {9, 10},  {8, 10},  {7, 10},  {6, 10},  {5, 10},  {4, 10},  {7, 11},  {6, 11},
    {5, 11},  {4, 11},  {3, 11},  {2, 11},  {3, 12},  {2, 12}};
// dct_dc_size of luma and chroma (tables B-13, B-14)
const uint16_t kDcLum[13][2] = {{3, 3}, {3, 2}, {2, 2}, {2, 3}, {1, 3},  {1, 4}, {1, 5},
                                {1, 6}, {1, 7}, {1, 8}, {1, 9}, {1, 10}, {1, 11}};
const uint16_t kDcChrom[13][2] = {{3, 2}, {2, 2}, {1, 2}, {1, 3}, {1, 4},  {1, 5}, {1, 6},
                                  {1, 7}, {1, 8}, {1, 9}, {1, 10}, {1, 11}, {1, 12}};

// TCOEF: the inter table (B-17, H.263's) and the intra table (B-16), the
// last entry each the escape; their (last, run, level) follow from the
// count of levels of each run, in code order
const uint16_t kInterTcoef[103][2] = {
    {0x2, 2},   {0xf, 4},   {0x15, 6},  {0x17, 7},  {0x1f, 8},  {0x25, 9},  {0x24, 9},
    {0x21, 10}, {0x20, 10}, {0x7, 11},  {0x6, 11},  {0x20, 11}, {0x6, 3},   {0x14, 6},
    {0x1e, 8},  {0xf, 10},  {0x21, 11}, {0x50, 12}, {0xe, 4},   {0x1d, 8},  {0xe, 10},
    {0x51, 12}, {0xd, 5},   {0x23, 9},  {0xd, 10},  {0xc, 5},   {0x22, 9},  {0x52, 12},
    {0xb, 5},   {0xc, 10},  {0x53, 12}, {0x13, 6},  {0xb, 10},  {0x54, 12}, {0x12, 6},
    {0xa, 10},  {0x11, 6},  {0x9, 10},  {0x10, 6},  {0x8, 10},  {0x16, 7},  {0x55, 12},
    {0x15, 7},  {0x14, 7},  {0x1c, 8},  {0x1b, 8},  {0x21, 9},  {0x20, 9},  {0x1f, 9},
    {0x1e, 9},  {0x1d, 9},  {0x1c, 9},  {0x1b, 9},  {0x1a, 9},  {0x22, 11}, {0x23, 11},
    {0x56, 12}, {0x57, 12}, {0x7, 4},   {0x19, 9},  {0x5, 11},  {0xf, 6},   {0x4, 11},
    {0xe, 6},   {0xd, 6},   {0xc, 6},   {0x13, 7},  {0x12, 7},  {0x11, 7},  {0x10, 7},
    {0x1a, 8},  {0x19, 8},  {0x18, 8},  {0x17, 8},  {0x16, 8},  {0x15, 8},  {0x14, 8},
    {0x13, 8},  {0x18, 9},  {0x17, 9},  {0x16, 9},  {0x15, 9},  {0x14, 9},  {0x13, 9},
    {0x12, 9},  {0x11, 9},  {0x7, 10},  {0x6, 10},  {0x5, 10},  {0x4, 10},  {0x24, 11},
    {0x25, 11}, {0x26, 11}, {0x27, 11}, {0x58, 12}, {0x59, 12}, {0x5a, 12}, {0x5b, 12},
    {0x5c, 12}, {0x5d, 12}, {0x5e, 12}, {0x5f, 12}, {0x3, 7}};
const uint8_t kInterLevels[2][41] = {
    {12, 6, 4, 3, 3, 3, 3, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1},
    {3, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
     1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1}};
const uint16_t kIntraTcoef[103][2] = {
    {0x2, 2},   {0x6, 3},   {0xf, 4},   {0xd, 5},   {0xc, 5},   {0x15, 6},  {0x13, 6},
    {0x12, 6},  {0x17, 7},  {0x1f, 8},  {0x1e, 8},  {0x1d, 8},  {0x25, 9},  {0x24, 9},
    {0x23, 9},  {0x21, 9},  {0x21, 10}, {0x20, 10}, {0xf, 10},  {0xe, 10},  {0x7, 11},
    {0x6, 11},  {0x20, 11}, {0x21, 11}, {0x50, 12}, {0x51, 12}, {0x52, 12}, {0xe, 4},
    {0x14, 6},  {0x16, 7},  {0x1c, 8},  {0x20, 9},  {0x1f, 9},  {0xd, 10},  {0x22, 11},
    {0x53, 12}, {0x55, 12}, {0xb, 5},   {0x15, 7},  {0x1e, 9},  {0xc, 10},  {0x56, 12},
    {0x11, 6},  {0x1b, 8},  {0x1d, 9},  {0xb, 10},  {0x10, 6},  {0x22, 9},  {0xa, 10},
    {0xd, 6},   {0x1c, 9},  {0x8, 10},  {0x12, 7},  {0x1b, 9},  {0x54, 12}, {0x14, 7},
    {0x1a, 9},  {0x57, 12}, {0x19, 8},  {0x9, 10},  {0x18, 8},  {0x23, 11}, {0x17, 8},
    {0x19, 9},  {0x18, 9},  {0x7, 10},  {0x58, 12}, {0x7, 4},   {0xc, 6},   {0x16, 8},
    {0x17, 9},  {0x6, 10},  {0x5, 11},  {0x4, 11},  {0x59, 12}, {0xf, 6},   {0x16, 9},
    {0x5, 10},  {0xe, 6},   {0x4, 10},  {0x11, 7},  {0x24, 11}, {0x10, 7},  {0x25, 11},
    {0x13, 7},  {0x5a, 12}, {0x15, 8},  {0x5b, 12}, {0x14, 8},  {0x13, 8},  {0x1a, 8},
    {0x15, 9},  {0x14, 9},  {0x13, 9},  {0x12, 9},  {0x11, 9},  {0x26, 11}, {0x27, 11},
    {0x5c, 12}, {0x5d, 12}, {0x5e, 12}, {0x5f, 12}, {0x3, 7}};
const uint8_t kIntraLevels[2][41] = {
    {27, 10, 5, 4, 3, 3, 3, 3, 2, 2, 1, 1, 1, 1, 1},
    {8, 3, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1}};
constexpr int ESC = 102;

struct RunLevel {
  Vlc vlc;
  uint8_t last[102], run[102], level[102];
  uint8_t max_level[2][64], max_run[2][65];
  RunLevel(const uint16_t (*codes)[2], const uint8_t (*levels)[41])
      : vlc(codes, 103, 12) {
    memset(max_level, 0, sizeof max_level);
    memset(max_run, 0, sizeof max_run);
    int i = 0;
    for (int l = 0; l < 2; l++)
      for (int r = 0; r < 41; r++)
        for (int k = 1; k <= levels[l][r]; k++, i++) {
          last[i] = (uint8_t)l;
          run[i] = (uint8_t)r;
          level[i] = (uint8_t)k;
          max_level[l][r] = std::max<uint8_t>(max_level[l][r], (uint8_t)k);
          max_run[l][k] = std::max<uint8_t>(max_run[l][k], (uint8_t)r);
        }
  }
};

const Vlc& vlc_intra_mcbpc() { static const Vlc v(kIntraMcbpc, 9, 9); return v; }
const Vlc& vlc_inter_mcbpc() { static const Vlc v(kInterMcbpc, 28, 9); return v; }
const Vlc& vlc_cbpy() { static const Vlc v(kCbpy, 16, 6); return v; }
const Vlc& vlc_mv() { static const Vlc v(kMv, 33, 12); return v; }
const Vlc& vlc_dc(int chroma) {
  static const Vlc l(kDcLum, 13, 12), c(kDcChrom, 13, 12);
  return chroma ? c : l;
}
const RunLevel& rl_intra() { static const RunLevel r(kIntraTcoef, kIntraLevels); return r; }
const RunLevel& rl_inter() { static const RunLevel r(kInterTcoef, kInterLevels); return r; }

const uint8_t kZigzag[64] = {0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
                             12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
                             35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
                             58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};
const uint8_t kAltHorizontal[64] = {
    0,  1,  2,  3,  8,  9,  16, 17, 10, 11, 4,  5,  6,  7,  15, 14, 13, 12, 19, 18, 24, 25,
    32, 33, 26, 27, 20, 21, 22, 23, 28, 29, 30, 31, 34, 35, 40, 41, 48, 49, 42, 43, 36, 37,
    38, 39, 44, 45, 46, 47, 50, 51, 56, 57, 58, 59, 52, 53, 54, 55, 60, 61, 62, 63};
const uint8_t kAltVertical[64] = {
    0,  8,  16, 24, 1,  9,  2,  10, 17, 25, 32, 40, 48, 56, 57, 49, 41, 33, 26, 18, 3,  11,
    4,  12, 19, 27, 34, 42, 50, 58, 35, 43, 51, 59, 20, 28, 5,  13, 6,  14, 21, 29, 36, 44,
    52, 60, 37, 45, 53, 61, 22, 30, 7,  15, 23, 31, 38, 46, 54, 62, 39, 47, 55, 63};
const uint8_t kYDcScale[32] = {0,  8,  8,  8,  8,  10, 12, 14, 16, 17, 18, 19, 20, 21, 22, 23,
                               24, 25, 26, 27, 28, 29, 30, 31, 32, 34, 36, 38, 40, 42, 44, 46};
const uint8_t kCDcScale[32] = {0,  8,  8,  8,  8,  9,  9,  10, 10, 11, 11, 12, 12, 13, 13, 14,
                               14, 15, 15, 16, 16, 17, 17, 18, 18, 19, 20, 21, 22, 23, 24, 25};
const int kDcThreshold[8] = {99, 13, 15, 17, 19, 21, 23, 0};
const int kDquant[4] = {-1, -2, 1, 2};

inline uint8_t clip_u8(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }
inline int mid_pred(int a, int b, int c) {
  return std::max(std::min(a, b), std::min(std::max(a, b), c));
}

// ---------------------------------------------------------------- IDCTs

// ffmpeg's "simple" IDCT (8-bit): rows, each with its DC-only shortcut,
// then columns; 16-bit coefficients, 32-bit products and sums
namespace simple {
constexpr int W1 = 22725, W2 = 21407, W3 = 19266, W4 = 16383, W5 = 12873, W6 = 8867, W7 = 4520;
constexpr int ROW_SHIFT = 11, COL_SHIFT = 20;

inline void row(int16_t* r) {
  if (!(r[1] | r[2] | r[3] | r[4] | r[5] | r[6] | r[7])) {
    const int16_t t = (int16_t)(uint16_t)((uint32_t)r[0] << 3);
    for (int i = 0; i < 8; i++) r[i] = t;
    return;
  }
  uint32_t a0 = (uint32_t)(W4 * r[0]) + (1u << (ROW_SHIFT - 1));
  uint32_t a1 = a0, a2 = a0, a3 = a0;
  a0 += (uint32_t)(W2 * r[2]);
  a1 += (uint32_t)(W6 * r[2]);
  a2 -= (uint32_t)(W6 * r[2]);
  a3 -= (uint32_t)(W2 * r[2]);
  uint32_t b0 = (uint32_t)(W1 * r[1]) + (uint32_t)(W3 * r[3]);
  uint32_t b1 = (uint32_t)(W3 * r[1]) - (uint32_t)(W7 * r[3]);
  uint32_t b2 = (uint32_t)(W5 * r[1]) - (uint32_t)(W1 * r[3]);
  uint32_t b3 = (uint32_t)(W7 * r[1]) - (uint32_t)(W5 * r[3]);
  if (r[4] | r[5] | r[6] | r[7]) {
    a0 += (uint32_t)(W4 * r[4]) + (uint32_t)(W6 * r[6]);
    a1 += (uint32_t)(-W4 * r[4]) - (uint32_t)(W2 * r[6]);
    a2 += (uint32_t)(-W4 * r[4]) + (uint32_t)(W2 * r[6]);
    a3 += (uint32_t)(W4 * r[4]) - (uint32_t)(W6 * r[6]);
    b0 += (uint32_t)(W5 * r[5]) + (uint32_t)(W7 * r[7]);
    b1 += (uint32_t)(-W1 * r[5]) - (uint32_t)(W5 * r[7]);
    b2 += (uint32_t)(W7 * r[5]) + (uint32_t)(W3 * r[7]);
    b3 += (uint32_t)(W3 * r[5]) - (uint32_t)(W1 * r[7]);
  }
  r[0] = (int16_t)((int)(a0 + b0) >> ROW_SHIFT);
  r[7] = (int16_t)((int)(a0 - b0) >> ROW_SHIFT);
  r[1] = (int16_t)((int)(a1 + b1) >> ROW_SHIFT);
  r[6] = (int16_t)((int)(a1 - b1) >> ROW_SHIFT);
  r[2] = (int16_t)((int)(a2 + b2) >> ROW_SHIFT);
  r[5] = (int16_t)((int)(a2 - b2) >> ROW_SHIFT);
  r[3] = (int16_t)((int)(a3 + b3) >> ROW_SHIFT);
  r[4] = (int16_t)((int)(a3 - b3) >> ROW_SHIFT);
}

// one column to eight values (before clipping)
inline void col(const int16_t* c, int out[8]) {
  uint32_t a0 = (uint32_t)(W4 * (c[0] + ((1 << (COL_SHIFT - 1)) / W4)));
  uint32_t a1 = a0, a2 = a0, a3 = a0;
  a0 += (uint32_t)(W2 * c[16]);
  a1 += (uint32_t)(W6 * c[16]);
  a2 += (uint32_t)(-W6 * c[16]);
  a3 += (uint32_t)(-W2 * c[16]);
  uint32_t b0 = (uint32_t)(W1 * c[8]) + (uint32_t)(W3 * c[24]);
  uint32_t b1 = (uint32_t)(W3 * c[8]) - (uint32_t)(W7 * c[24]);
  uint32_t b2 = (uint32_t)(W5 * c[8]) - (uint32_t)(W1 * c[24]);
  uint32_t b3 = (uint32_t)(W7 * c[8]) - (uint32_t)(W5 * c[24]);
  a0 += (uint32_t)(W4 * c[32]) + (uint32_t)(W6 * c[48]);
  a1 += (uint32_t)(-W4 * c[32]) - (uint32_t)(W2 * c[48]);
  a2 += (uint32_t)(-W4 * c[32]) + (uint32_t)(W2 * c[48]);
  a3 += (uint32_t)(W4 * c[32]) - (uint32_t)(W6 * c[48]);
  b0 += (uint32_t)(W5 * c[40]) + (uint32_t)(W7 * c[56]);
  b1 += (uint32_t)(-W1 * c[40]) - (uint32_t)(W5 * c[56]);
  b2 += (uint32_t)(W7 * c[40]) + (uint32_t)(W3 * c[56]);
  b3 += (uint32_t)(W3 * c[40]) - (uint32_t)(W1 * c[56]);
  out[0] = (int)(a0 + b0) >> COL_SHIFT;
  out[1] = (int)(a1 + b1) >> COL_SHIFT;
  out[2] = (int)(a2 + b2) >> COL_SHIFT;
  out[3] = (int)(a3 + b3) >> COL_SHIFT;
  out[4] = (int)(a3 - b3) >> COL_SHIFT;
  out[5] = (int)(a2 - b2) >> COL_SHIFT;
  out[6] = (int)(a1 - b1) >> COL_SHIFT;
  out[7] = (int)(a0 - b0) >> COL_SHIFT;
}

void idct(int16_t* b, uint8_t* dst, int stride, bool add) {
  for (int i = 0; i < 8; i++) row(b + 8 * i);
  for (int i = 0; i < 8; i++) {
    int v[8];
    col(b + i, v);
    for (int j = 0; j < 8; j++) {
      uint8_t& p = dst[j * stride + i];
      p = clip_u8(add ? p + v[j] : v[j]);
    }
  }
}
}  // namespace simple

// Xvid's IDCT, as ffmpeg runs it for Xvid streams: rows by their own
// scaled tables and rounding, columns by tangent butterflies whose products
// keep the high 16 bits (pmulhw's)
namespace xvid {
constexpr int ROW_SHIFT = 11, COL_SHIFT = 6;
const int kTab04[7] = {22725, 21407, 19266, 16384, 12873, 8867, 4520};
const int kTab17[7] = {31521, 29692, 26722, 22725, 17855, 12299, 6270};
const int kTab26[7] = {29692, 27969, 25172, 21407, 16819, 11585, 5906};
const int kTab35[7] = {26722, 25172, 22654, 19266, 15137, 10426, 5315};
const int* const kRowTab[8] = {kTab04, kTab17, kTab26, kTab35, kTab04, kTab35, kTab26, kTab17};
const int kRowRnd[8] = {65536, 3597, 2260, 1203, 0, 120, 512, 512};
constexpr int TAN1 = 0x32EC, TAN2 = 0x6A0A, TAN3 = 0xAB0E, SQRT2 = 0x5A82;

inline int mult(int c, int x) { return (int)((unsigned)(c * x)) >> 16; }

inline void row(int16_t* in, const int* tab, int rnd) {
  const unsigned c1 = tab[0], c2 = tab[1], c3 = tab[2], c4 = tab[3], c5 = tab[4], c6 = tab[5],
                 c7 = tab[6];
  const int right = in[5] | in[6] | in[7], left = in[1] | in[2] | in[3];
  if (!(right | in[4])) {
    const int k = (int)(c4 * in[0]) + rnd;
    if (left) {
      const unsigned a0 = k + c2 * in[2], a1 = k + c6 * in[2], a2 = k - c6 * in[2],
                     a3 = k - c2 * in[2];
      const int b0 = (int)(c1 * in[1] + c3 * in[3]), b1 = (int)(c3 * in[1] - c7 * in[3]),
                b2 = (int)(c5 * in[1] - c1 * in[3]), b3 = (int)(c7 * in[1] - c5 * in[3]);
      in[0] = (int16_t)((int)(a0 + b0) >> ROW_SHIFT);
      in[1] = (int16_t)((int)(a1 + b1) >> ROW_SHIFT);
      in[2] = (int16_t)((int)(a2 + b2) >> ROW_SHIFT);
      in[3] = (int16_t)((int)(a3 + b3) >> ROW_SHIFT);
      in[4] = (int16_t)((int)(a3 - b3) >> ROW_SHIFT);
      in[5] = (int16_t)((int)(a2 - b2) >> ROW_SHIFT);
      in[6] = (int16_t)((int)(a1 - b1) >> ROW_SHIFT);
      in[7] = (int16_t)((int)(a0 - b0) >> ROW_SHIFT);
    } else {
      const int a0 = k >> ROW_SHIFT;
      if (a0)
        for (int i = 0; i < 8; i++) in[i] = (int16_t)a0;
    }
    return;
  }
  const unsigned a0 = c4 * in[0] + c2 * in[2] + c4 * in[4] + c6 * in[6] + rnd;
  const unsigned a1 = c4 * in[0] + c6 * in[2] - c4 * in[4] - c2 * in[6] + rnd;
  const unsigned a2 = c4 * in[0] - c6 * in[2] - c4 * in[4] + c2 * in[6] + rnd;
  const unsigned a3 = c4 * in[0] - c2 * in[2] + c4 * in[4] - c6 * in[6] + rnd;
  const int b0 = (int)(c1 * in[1] + c3 * in[3] + c5 * in[5] + c7 * in[7]);
  const int b1 = (int)(c3 * in[1] - c7 * in[3] - c1 * in[5] - c5 * in[7]);
  const int b2 = (int)(c5 * in[1] - c1 * in[3] + c7 * in[5] + c3 * in[7]);
  const int b3 = (int)(c7 * in[1] - c5 * in[3] + c3 * in[5] - c1 * in[7]);
  in[0] = (int16_t)((int)(a0 + b0) >> ROW_SHIFT);
  in[1] = (int16_t)((int)(a1 + b1) >> ROW_SHIFT);
  in[2] = (int16_t)((int)(a2 + b2) >> ROW_SHIFT);
  in[3] = (int16_t)((int)(a3 + b3) >> ROW_SHIFT);
  in[4] = (int16_t)((int)(a3 - b3) >> ROW_SHIFT);
  in[5] = (int16_t)((int)(a2 - b2) >> ROW_SHIFT);
  in[6] = (int16_t)((int)(a1 - b1) >> ROW_SHIFT);
  in[7] = (int16_t)((int)(a0 - b0) >> ROW_SHIFT);
}

inline void col(int16_t* in) {
  int mm0, mm1, mm2, mm3, mm4, mm5, mm6, mm7, t;
  mm4 = in[7 * 8];
  mm5 = in[5 * 8];
  mm6 = in[3 * 8];
  mm7 = in[1 * 8];
  mm0 = mult(TAN1, mm4) + mm7;
  mm1 = mult(TAN1, mm7) - mm4;
  mm2 = mult(TAN3, mm5) + mm6;
  mm3 = mult(TAN3, mm6) - mm5;
  mm7 = mm0 + mm2;
  mm4 = mm1 - mm3;
  mm0 = mm0 - mm2;
  mm1 = mm1 + mm3;
  mm6 = mm0 + mm1;
  mm5 = mm0 - mm1;
  mm5 = 2 * mult(SQRT2, mm5);
  mm6 = 2 * mult(SQRT2, mm6);
  mm1 = in[2 * 8];
  mm2 = in[6 * 8];
  mm3 = mult(TAN2, mm2) + mm1;
  mm2 = mult(TAN2, mm1) - mm2;
  mm0 = in[0] + in[4 * 8];
  mm1 = in[0] - in[4 * 8];
  t = mm0 + mm3; mm3 = mm0 - mm3; mm0 = t;
  t = mm0 + mm7; mm7 = mm0 - mm7; mm0 = t;
  in[0] = (int16_t)(mm0 >> COL_SHIFT);
  in[7 * 8] = (int16_t)(mm7 >> COL_SHIFT);
  t = mm3 + mm4; mm4 = mm3 - mm4; mm3 = t;
  in[3 * 8] = (int16_t)(mm3 >> COL_SHIFT);
  in[4 * 8] = (int16_t)(mm4 >> COL_SHIFT);
  t = mm1 + mm2; mm2 = mm1 - mm2; mm1 = t;
  t = mm1 + mm6; mm6 = mm1 - mm6; mm1 = t;
  in[1 * 8] = (int16_t)(mm1 >> COL_SHIFT);
  in[6 * 8] = (int16_t)(mm6 >> COL_SHIFT);
  t = mm2 + mm5; mm5 = mm2 - mm5; mm2 = t;
  in[2 * 8] = (int16_t)(mm2 >> COL_SHIFT);
  in[5 * 8] = (int16_t)(mm5 >> COL_SHIFT);
}

void idct(int16_t* b, uint8_t* dst, int stride, bool add) {
  for (int i = 0; i < 8; i++) row(b + 8 * i, kRowTab[i], kRowRnd[i]);
  for (int i = 0; i < 8; i++) col(b + i);
  for (int j = 0; j < 8; j++)
    for (int i = 0; i < 8; i++) {
      uint8_t& p = dst[j * stride + i];
      p = clip_u8(add ? p + b[8 * j + i] : b[8 * j + i]);
    }
}
}  // namespace xvid

// ---------------------------------------------------------------- motion

// (bw + 1) x (bh + 1) samples at (sx, sy) of a plane whose samples outside
// [0, ew) x [0, eh) repeat its edge: a pointer into the plane, or the samples
// copied into `tmp` (stride 24)
const uint8_t* fetch(const uint8_t* plane, int stride, int ew, int eh, int sx, int sy, int bw,
                     int bh, uint8_t* tmp, int& ostride) {
  if (sx >= 0 && sy >= 0 && sx + bw + 1 <= ew && sy + bh + 1 <= eh) {
    ostride = stride;
    return plane + (ptrdiff_t)sy * stride + sx;
  }
  for (int j = 0; j <= bh; j++) {
    const int y = std::min(std::max(sy + j, 0), eh - 1);
    for (int i = 0; i <= bw; i++) {
      const int x = std::min(std::max(sx + i, 0), ew - 1);
      tmp[j * 24 + i] = plane[(ptrdiff_t)y * stride + x];
    }
  }
  ostride = 24;
  return tmp;
}

// half-pel prediction of a bw x bh block: dxy bit 0 horizontal, bit 1
// vertical; `no_rnd` the VOP's rounding_type. Without rounding, ffmpeg's x86
// code (which it uses unless asked to be bit-exact, and cv2 does not ask)
// averages two samples as pavgb(a - 1, b), the 1 taken off with unsigned
// saturation from the left sample, or from the odd row of the block's rows:
// (a + b) >> 1 but where that sample is 0.
void hpel(uint8_t* dst, int ds, const uint8_t* s, int ss, int bw, int bh, int dxy, int no_rnd) {
  const int r = 1 - no_rnd;
  switch (dxy) {
    case 0:
      for (int j = 0; j < bh; j++, dst += ds, s += ss) memcpy(dst, s, (size_t)bw);
      break;
    case 1:
      for (int j = 0; j < bh; j++, dst += ds, s += ss)
        for (int i = 0; i < bw; i++)
          dst[i] = (uint8_t)((std::max(s[i] - no_rnd, 0) + s[i + 1] + 1) >> 1);
      break;
    case 2:
      for (int j = 0; j < bh; j++, dst += ds, s += ss) {
        const int cur = no_rnd & j, next = no_rnd & ~j;  // the odd row loses the 1
        for (int i = 0; i < bw; i++)
          dst[i] = (uint8_t)((std::max(s[i] - cur, 0) + std::max(s[i + ss] - next, 0) + 1) >> 1);
      }
      break;
    default:
      for (int j = 0; j < bh; j++, dst += ds, s += ss)
        for (int i = 0; i < bw; i++)
          dst[i] = (uint8_t)((s[i] + s[i + 1] + s[i + ss] + s[i + ss + 1] + 1 + r) >> 2);
  }
}

inline int round_chroma(int x) {  // a 4MV macroblock's chroma vector from its four
  static const uint8_t tab[16] = {0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2};
  return tab[x & 15] + ((x >> 3) & ~1);
}

int sign_extend(int v, int bits) {
  const int s = 32 - bits;
  return (int)((unsigned)v << s) >> s;
}

}  // namespace

// ---------------------------------------------------------------- decoder

struct Mpeg4Decoder {
  std::string tag;
  // the video object layer
  bool have_vol = false;
  int width = 0, height = 0, mb_w = 0, mb_h = 0, mb_num = 0;
  int time_bits = 1;
  bool resync_marker = false, vol_control = false;
  int vo_type = 0;
  // the encoder, from user data (-1: not named)
  int xvid_build = -1, lavc_build = -1, divx_version = -1;
  bool xvid_idct = false, edge_bug = false, dc_clip_bug = false;
  // the VOP
  int pict_type = 0, no_rounding = 0, f_code = 1, intra_dc_thr = 99, qscale = 1;
  bool have_ref = false;
  // pictures, whole macroblocks
  std::vector<uint8_t> cur[3], ref[3];
  int ls = 0, cs = 0;
  // per-block and per-macroblock state, laid out as ffmpeg lays it out: a
  // luma block grid of b8s = 2 * mb_w + 1 a row (the last column off the
  // picture, the left neighbour of the next row's first), a chroma and
  // macroblock grid of mbs = mb_w + 1
  int b8s = 0, mbs = 0;
  std::vector<int16_t> dc_buf[3], ac_buf[3], mv_buf;
  std::vector<int8_t> qtab;
  int16_t *dc[3] = {}, *ac[3] = {}, *mv = nullptr;
  // the macroblock being decoded
  int mb_x = 0, mb_y = 0, resync_x = 0, resync_y = 0;
  bool first_slice_line = true, ac_pred = false, use_dc_vlc = false;
  int y_dc_scale = 8, c_dc_scale = 8;
  int16_t block[6][64];
  int last_index[6];
  Bits b;
  std::string why;

  int unsupported(const std::string& tool) {
    why = tool;
    return C_UNSUPPORTED;
  }
  int error(const std::string& what) {
    why = what;
    return C_ERR;
  }
  void set_qscale(int q) {
    qscale = std::min(std::max(q, 1), 31);
    y_dc_scale = kYDcScale[qscale];
    c_dc_scale = kCDcScale[qscale];
  }
  int bidx(int n) const {  // block n's index in the grid of its plane
    return n < 4 ? (2 * mb_y + (n >> 1)) * b8s + 2 * mb_x + (n & 1) : mb_y * mbs + mb_x;
  }

  int parse_vol(Bits& g);
  void parse_user_data(Bits& g);
  void workarounds();
  int parse_headers(Bits& g, bool stop_at_vop, int& found_vop);
  int decode_vop(Picture& out);
  int pred_dc(int n, int& dir);
  int level_dc(int n, int pred, int level);
  void pred_ac(int16_t* blk, int n, int dir);
  int decode_block(int16_t* blk, int n, bool coded, bool intra);
  int decode_motion(int pred);
  void pred_motion(int n, int& px, int& py);
  int decode_mb(int& mv_type, int mvs[4][2], bool& intra);
  void reconstruct(bool intra, int mv_type, int mvs[4][2]);
  bool at_resync();
  int video_packet_header();
  void clean_buffers();
  void clean_intra();
};

int Mpeg4Decoder::parse_vol(Bits& g) {
  g.get1();                   // random_accessible_vol
  vo_type = (int)g.get(8);    // video_object_type_indication
  int verid = 1;
  if (g.get1()) {             // is_object_layer_identifier
    verid = (int)g.get(4);
    g.get(3);
  }
  if (g.get(4) == 15) g.get(16);  // aspect_ratio_info: extended PAR
  vol_control = g.get1();
  if (vol_control) {
    if (g.get(2) != 1) return unsupported("a chroma format other than 4:2:0");
    g.get1();  // low_delay
    if (g.get1()) g.get(15), g.get1(), g.get(15), g.get1(), g.get(15), g.get1(), g.get(3),
        g.get(11), g.get1(), g.get(15), g.get1();  // vbv_parameters
  }
  const int shape = (int)g.get(2);
  if (shape != 0) return unsupported("arbitrary shape (video_object_layer_shape " +
                                     std::to_string(shape) + ")");
  g.get1();
  const int res = (int)g.get(16);
  if (!res) return error("a zero vop_time_increment_resolution");
  time_bits = 1;
  while ((1 << time_bits) < res) time_bits++;  // av_log2(res - 1) + 1
  g.get1();
  if (g.get1()) g.get(time_bits);  // fixed_vop_rate
  g.get1();
  const int w = (int)g.get(13);
  g.get1();
  const int h = (int)g.get(13);
  g.get1();
  if (g.get1()) return unsupported("interlace");
  g.get1();  // obmc_disable
  if (g.get(verid == 1 ? 1 : 2)) return unsupported("sprites (S(GMC)-VOPs)");
  if (g.get1()) return unsupported("not-8-bit video");
  if (g.get1()) return unsupported("MPEG quantisation matrices (mpeg_quant)");
  if (verid != 1 && g.get1()) return unsupported("quarter-pel motion");
  if (!g.get1()) return unsupported("the complexity estimation header");
  resync_marker = !g.get1();
  if (g.get1()) return unsupported("data partitioning");
  if (verid != 1) {
    if (g.get1()) return unsupported("NEWPRED");
    if (g.get1()) return unsupported("reduced resolution VOPs");
  }
  if (g.get1()) return unsupported("scalability");
  if (g.left() < 0) return error("a truncated video object layer header");
  if (w <= 0 || h <= 0 || w > 8192 || h > 8192) return error("a picture size out of range");
  have_vol = true;
  if (w == width && h == height) return C_OK;  // a repeated header (each I-VOP's, in AVIs)
  have_ref = false;
  width = w;
  height = h;
  mb_w = (w + 15) / 16;
  mb_h = (h + 15) / 16;
  mb_num = mb_w * mb_h;
  ls = mb_w * 16;
  cs = mb_w * 8;
  for (int p = 0; p < 3; p++) {
    const size_t n = p ? (size_t)cs * mb_h * 8 : (size_t)ls * mb_h * 16;
    cur[p].assign(n, 0);
    ref[p].assign(n, 0);
  }
  b8s = 2 * mb_w + 1;
  mbs = mb_w + 1;
  // a border row above each grid and a few entries before it
  const size_t lum = (size_t)(2 * mb_h + 2) * b8s + 8, chr = (size_t)(mb_h + 2) * mbs + 8;
  dc_buf[0].assign(lum, 1024);
  ac_buf[0].assign(lum * 16, 0);
  mv_buf.assign(lum * 2, 0);
  for (int p = 1; p < 3; p++) {
    dc_buf[p].assign(chr, 1024);
    ac_buf[p].assign(chr * 16, 0);
  }
  dc[0] = dc_buf[0].data() + b8s + 4;
  ac[0] = ac_buf[0].data() + (b8s + 4) * 16;
  mv = mv_buf.data() + (b8s + 4) * 2;
  for (int p = 1; p < 3; p++) {
    dc[p] = dc_buf[p].data() + mbs + 4;
    ac[p] = ac_buf[p].data() + (mbs + 4) * 16;
  }
  qtab.assign((size_t)mb_h * mbs + 1, 1);
  return C_OK;
}

void Mpeg4Decoder::parse_user_data(Bits& g) {
  char buf[256];
  int i = 0;
  while (i < 255 && g.left() >= 24 && g.show(23)) buf[i++] = (char)g.get(8);
  buf[i] = 0;
  int ver = 0, build = 0, ver2 = 0, ver3 = 0;
  char last = 0;
  int e = sscanf(buf, "DivX%dBuild%d%c", &ver, &build, &last);
  if (e < 2) e = sscanf(buf, "DivX%db%d%c", &ver, &build, &last);
  if (e >= 2) divx_version = ver;
  if (sscanf(buf, "FFmpe%*[^b]b%d", &build) == 1) {
    lavc_build = build;
  } else if (sscanf(buf, "FFmpeg v%d.%d.%d / libavcodec build: %d", &ver, &ver2, &ver3,
                    &build) == 4) {
    lavc_build = build;
  } else if (sscanf(buf, "Lavc%d.%d.%d", &ver, &ver2, &ver3) == 3) {
    lavc_build = ver * 256 * 256 + ver2 * 256 + ver3;
  }
  if (sscanf(buf, "XviD%d", &build) == 1) xvid_build = build;
}

// ffmpeg's choices by the encoder that wrote the stream (its
// ff_mpeg4_workaround_bugs, the parts Simple Profile streams reach)
void Mpeg4Decoder::workarounds() {
  if (xvid_build == -1 && divx_version == -1 && lavc_build == -1) {
    if (tag == "XVID" || tag == "XVIX" || tag == "RMP4" || tag == "ZMP4" || tag == "SIPP")
      xvid_build = 0;
    else if (tag == "DIVX" && vo_type == 0 && !vol_control)
      divx_version = 400;
  }
  edge_bug = (unsigned)xvid_build <= 12u || (unsigned)lavc_build < 4670u ||
             (unsigned)divx_version < 500u;
  dc_clip_bug = (unsigned)xvid_build <= 32u || (unsigned)lavc_build <= 4712u;
  xvid_idct = xvid_build >= 0;
}

// Walks start codes from the reader's position: VOS, VO, VOL, user data and
// GOV are read; with `stop_at_vop`, stops after a VOP start code
// (found_vop = 1). C_OK, or an error / refusal.
int Mpeg4Decoder::parse_headers(Bits& g, bool stop_at_vop, int& found_vop) {
  found_vop = 0;
  for (;;) {
    g.align();
    while (g.left() >= 32 && (g.show(24) != 1)) g.pos += 8;
    if (g.left() < 32) return C_OK;
    const uint32_t code = g.get(32) & 0xFF;
    if (code == 0xB6) {
      if (stop_at_vop) {
        found_vop = 1;
        return C_OK;
      }
    } else if (code >= 0x20 && code <= 0x2F) {
      const int rc = parse_vol(g);
      if (rc != C_OK) return rc;
    } else if (code == 0xB2) {
      parse_user_data(g);
    } else if (code >= 0x30 && code <= 0xAF) {
      return unsupported("a still texture or mesh object (start code 0x" + std::to_string(code) +
                         ")");
    }
  }
}

int Mpeg4Decoder::pred_dc(int n, int& dir) {
  const int wrap = n < 4 ? b8s : mbs;
  const int16_t* v = dc[n < 4 ? 0 : n - 3] + bidx(n);
  int a = v[-1], bb = v[-1 - wrap], c = v[-wrap];
  if (first_slice_line && n != 3) {
    if (n != 2) bb = c = 1024;
    if (n != 1 && mb_x == resync_x) bb = a = 1024;
  }
  if (mb_x == resync_x && mb_y == resync_y + 1 && (n == 0 || n == 4 || n == 5)) bb = 1024;
  if (std::abs(a - bb) < std::abs(bb - c)) {
    dir = 1;
    return c;
  }
  dir = 0;
  return a;
}

int Mpeg4Decoder::level_dc(int n, int pred, int level) {
  const int scale = n < 4 ? y_dc_scale : c_dc_scale;
  pred = (pred + (scale >> 1)) / scale;
  level += pred;
  const int ret = level;
  level *= scale;
  if (level & ~2047) {
    if (level < 0) level = 0;
    else if (!dc_clip_bug) level = 2047;
  }
  dc[n < 4 ? 0 : n - 3][bidx(n)] = (int16_t)level;
  return ret;
}

void Mpeg4Decoder::pred_ac(int16_t* blk, int n, int dir) {
  const int p = n < 4 ? 0 : n - 3, wrap = n < 4 ? b8s : mbs;
  int16_t* v = ac[p] + (ptrdiff_t)bidx(n) * 16;
  if (ac_pred) {
    if (dir == 0) {
      const int16_t* l = v - 16;
      const int q = mb_x ? qtab[mb_y * mbs + mb_x - 1] : 0;
      if (mb_x == 0 || qscale == q || n == 1 || n == 3) {
        for (int i = 1; i < 8; i++) blk[i << 3] += l[i];
      } else {
        for (int i = 1; i < 8; i++) {
          const int x = l[i] * q;
          blk[i << 3] += (int16_t)((x > 0 ? x + (qscale >> 1) : x - (qscale >> 1)) / qscale);
        }
      }
    } else {
      const int16_t* t = v - 16 * wrap;
      const int q = mb_y ? qtab[(mb_y - 1) * mbs + mb_x] : 0;
      if (mb_y == 0 || qscale == q || n == 2 || n == 3) {
        for (int i = 1; i < 8; i++) blk[i] += t[i + 8];
      } else {
        for (int i = 1; i < 8; i++) {
          const int x = t[i + 8] * q;
          blk[i] += (int16_t)((x > 0 ? x + (qscale >> 1) : x - (qscale >> 1)) / qscale);
        }
      }
    }
  }
  for (int i = 1; i < 8; i++) v[i] = blk[i << 3];
  for (int i = 1; i < 8; i++) v[8 + i] = blk[i];
}

// One block's coefficients (intra ones not yet dequantised, inter ones
// dequantised) into `blk`; last_index[n] the last coded position.
int Mpeg4Decoder::decode_block(int16_t* blk, int n, bool coded, bool intra) {
  int i, dir = 0, pred = 0, qmul, qadd;
  const RunLevel& rl = intra ? rl_intra() : rl_inter();
  const uint8_t* scan = kZigzag;
  if (intra) {
    if (use_dc_vlc) {
      const int size = vlc_dc(n >= 4).read(b);
      if (size < 0 || size > 9) return error("an illegal DC size");
      int level = 0;
      if (size) {
        level = b.xbits(size);
        if (size > 8) b.get1();  // marker
      }
      pred = pred_dc(n, dir);
      blk[0] = (int16_t)level_dc(n, pred, level);
      i = 0;
    } else {
      i = -1;
      pred = pred_dc(n, dir);
    }
    if (ac_pred) scan = dir == 0 ? kAltVertical : kAltHorizontal;
    qmul = 1;
    qadd = 0;
  } else {
    i = -1;
    qmul = qscale << 1;
    qadd = (qscale - 1) | 1;
  }
  if (coded) {
    for (;;) {
      int sym = rl.vlc.read(b);
      if (sym < 0) return error("an illegal TCOEF code");
      int last, run, level;
      if (sym != ESC) {
        last = rl.last[sym];
        run = rl.run[sym];
        level = rl.level[sym] * qmul + qadd;
        if (b.get1()) level = -level;
      } else if (!b.show(1)) {  // escape mode 1: level + LMAX
        b.pos += 1;
        sym = rl.vlc.read(b);
        if (sym < 0 || sym == ESC) return error("an illegal escaped TCOEF code");
        last = rl.last[sym];
        run = rl.run[sym];
        level = (rl.level[sym] + rl.max_level[last][run]) * qmul + qadd;
        if (b.get1()) level = -level;
      } else if (b.show(2) == 2) {  // escape mode 2 ('10'): run + RMAX + 1
        b.pos += 2;
        sym = rl.vlc.read(b);
        if (sym < 0 || sym == ESC) return error("an illegal escaped TCOEF code");
        last = rl.last[sym];
        run = rl.run[sym] + rl.max_run[last][rl.level[sym]] + 1;
        level = rl.level[sym] * qmul + qadd;
        if (b.get1()) level = -level;
      } else {  // escape mode 3 ('11'): fixed length
        b.pos += 2;
        last = b.get1();
        run = (int)b.get(6);
        b.get1();
        level = b.sget(12);
        b.get1();
        level = level > 0 ? level * qmul + qadd : level * qmul - qadd;
        if ((unsigned)(level + 2048) > 4095) level = level < 0 ? -2048 : 2047;
      }
      i += run + 1;
      if (i > 63) return error("a TCOEF run past the block's end");
      blk[scan[i]] = (int16_t)level;
      if (last) break;
      if (b.left() < 0) return error("a truncated block");
    }
  }
  if (intra) {
    if (!use_dc_vlc) {
      blk[0] = (int16_t)level_dc(n, pred, blk[0]);
      if (i < 0) i = 0;
    }
    pred_ac(blk, n, dir);
    if (ac_pred) i = 63;
  }
  last_index[n] = i;
  return C_OK;
}

int Mpeg4Decoder::decode_motion(int pred) {
  const int code = vlc_mv().read(b);
  if (code < 0) return 0xffff;
  if (code == 0) return pred;
  const int sign = b.get1(), shift = f_code - 1;
  int val = code;
  if (shift) {
    val = (val - 1) << shift;
    val |= (int)b.get(shift);
    val++;
  }
  if (sign) val = -val;
  val += pred;
  return sign_extend(val, 5 + f_code);
}

// the median of the neighbours' vectors (ffmpeg's ff_h263_pred_motion)
void Mpeg4Decoder::pred_motion(int n, int& px, int& py) {
  static const int off[4] = {2, 1, 1, -1};
  const int wrap = b8s;
  int16_t* m = mv + 2 * (ptrdiff_t)bidx(n);
  int16_t* A = m - 2;
  if (first_slice_line && n < 3) {
    if (n == 0) {
      if (mb_x == resync_x) {
        px = py = 0;
      } else if (mb_x + 1 == resync_x) {
        const int16_t* C = m + 2 * (off[n] - wrap);
        if (mb_x == 0) {
          px = C[0];
          py = C[1];
        } else {
          px = mid_pred(A[0], 0, C[0]);
          py = mid_pred(A[1], 0, C[1]);
        }
      } else {
        px = A[0];
        py = A[1];
      }
    } else if (n == 1) {
      if (mb_x + 1 == resync_x) {
        const int16_t* C = m + 2 * (off[n] - wrap);
        px = mid_pred(A[0], 0, C[0]);
        py = mid_pred(A[1], 0, C[1]);
      } else {
        px = A[0];
        py = A[1];
      }
    } else {
      const int16_t* B = m - 2 * wrap;
      const int16_t* C = m + 2 * (off[n] - wrap);
      if (mb_x == resync_x) A[0] = A[1] = 0;
      px = mid_pred(A[0], B[0], C[0]);
      py = mid_pred(A[1], B[1], C[1]);
    }
  } else {
    const int16_t* B = m - 2 * wrap;
    const int16_t* C = m + 2 * (off[n] - wrap);
    px = mid_pred(A[0], B[0], C[0]);
    py = mid_pred(A[1], B[1], C[1]);
  }
}

void Mpeg4Decoder::clean_intra() {
  // an inter macroblock's blocks predict nothing: DC 1024, AC 0
  for (int n = 0; n < 6; n++) {
    const int p = n < 4 ? 0 : n - 3;
    dc[p][bidx(n)] = 1024;
    memset(ac[p] + (ptrdiff_t)bidx(n) * 16, 0, 16 * sizeof(int16_t));
  }
}

// ffmpeg's ff_mpeg4_clean_buffers at a video packet's first macroblock
void Mpeg4Decoder::clean_buffers() {
  const ptrdiff_t l_xy = (ptrdiff_t)(2 * mb_y - 1) * b8s + mb_x * 2 - 1;
  const ptrdiff_t c_xy = (ptrdiff_t)(mb_y - 1) * mbs + mb_x - 1;
  memset(ac[0] + l_xy * 16, 0, (size_t)(b8s * 2 + 1) * 16 * sizeof(int16_t));
  memset(ac[1] + c_xy * 16, 0, (size_t)(mbs + 1) * 16 * sizeof(int16_t));
  memset(ac[2] + c_xy * 16, 0, (size_t)(mbs + 1) * 16 * sizeof(int16_t));
}

int Mpeg4Decoder::decode_mb(int& mv_type, int mvs[4][2], bool& intra) {
  int cbpc, dquant;
  memset(block, 0, sizeof block);
  for (int n = 0; n < 6; n++) last_index[n] = -1;
  mv_type = 0;
  memset(mvs, 0, sizeof(int) * 8);
  if (pict_type == 1) {
    do {
      if (b.get1()) {  // not coded: the reference's macroblock, vector 0
        intra = false;
        return C_OK;
      }
      cbpc = vlc_inter_mcbpc().read(b);
      if (cbpc < 0) return error("an illegal MCBPC");
    } while (cbpc == 20);
    dquant = cbpc & 8;
    intra = (cbpc & 4) != 0;
    if (!intra) {
      int cbpy = vlc_cbpy().read(b);
      if (cbpy < 0) return error("an illegal CBPY");
      cbpy ^= 15;
      const int cbp = (cbpc & 3) | (cbpy << 2);
      if (dquant) set_qscale(qscale + kDquant[b.get(2)]);
      int px, py;
      if (!(cbpc & 16)) {
        pred_motion(0, px, py);
        const int mx = decode_motion(px);
        if (mx >= 0xffff) return error("an illegal motion vector");
        const int my = decode_motion(py);
        if (my >= 0xffff) return error("an illegal motion vector");
        mvs[0][0] = mx;
        mvs[0][1] = my;
      } else {
        mv_type = 1;
        for (int k = 0; k < 4; k++) {
          pred_motion(k, px, py);
          const int mx = decode_motion(px);
          if (mx >= 0xffff) return error("an illegal motion vector");
          const int my = decode_motion(py);
          if (my >= 0xffff) return error("an illegal motion vector");
          mvs[k][0] = mx;
          mvs[k][1] = my;
          int16_t* m = mv + 2 * (ptrdiff_t)bidx(k);
          m[0] = (int16_t)mx;
          m[1] = (int16_t)my;
        }
      }
      for (int n = 0, c = cbp; n < 6; n++, c += c) {
        const int rc = decode_block(block[n], n, (c & 32) != 0, false);
        if (rc != C_OK) return rc;
      }
      return C_OK;
    }
  } else {
    do {
      cbpc = vlc_intra_mcbpc().read(b);
      if (cbpc < 0) return error("an illegal MCBPC");
    } while (cbpc == 8);
    dquant = cbpc & 4;
    intra = true;
  }
  ac_pred = b.get1();
  const int cbpy = vlc_cbpy().read(b);
  if (cbpy < 0) return error("an illegal CBPY");
  const int cbp = (cbpc & 3) | (cbpy << 2);
  use_dc_vlc = qscale < intra_dc_thr;
  if (dquant) set_qscale(qscale + kDquant[b.get(2)]);
  for (int n = 0, c = cbp; n < 6; n++, c += c) {
    const int rc = decode_block(block[n], n, (c & 32) != 0, true);
    if (rc != C_OK) return rc;
  }
  return C_OK;
}

void Mpeg4Decoder::reconstruct(bool intra, int mv_type, int mvs[4][2]) {
  uint8_t* dy = cur[0].data() + (ptrdiff_t)mb_y * 16 * ls + mb_x * 16;
  uint8_t* du = cur[1].data() + (ptrdiff_t)mb_y * 8 * cs + mb_x * 8;
  uint8_t* dv = cur[2].data() + (ptrdiff_t)mb_y * 8 * cs + mb_x * 8;
  auto idct = [&](int16_t* blk, uint8_t* dst, int stride, bool add) {
    if (xvid_idct) xvid::idct(blk, dst, stride, add);
    else simple::idct(blk, dst, stride, add);
  };
  qtab[mb_y * mbs + mb_x] = (int8_t)qscale;
  if (intra) {
    const int qmul = qscale << 1, qadd = (qscale - 1) | 1;
    for (int n = 0; n < 6; n++) {
      int16_t* blk = block[n];
      blk[0] = (int16_t)(blk[0] * (n < 4 ? y_dc_scale : c_dc_scale));
      for (int i = 1; i < 64; i++) {
        const int l = blk[i];
        if (l) blk[i] = (int16_t)(l < 0 ? l * qmul - qadd : l * qmul + qadd);
      }
      uint8_t* dst = n < 4 ? dy + (n & 1) * 8 + (n >> 1) * 8 * ls : n == 4 ? du : dv;
      idct(blk, dst, n < 4 ? ls : cs, false);
    }
    return;
  }
  clean_intra();
  // motion compensation from the reference, edges repeated past
  // [0, ew) x [0, eh)
  const int ew = edge_bug ? width : mb_w * 16, eh = edge_bug ? height : mb_h * 16;
  uint8_t tmp[24 * 24];
  int ss;
  if (mv_type == 0) {
    const int mx = mvs[0][0], my = mvs[0][1];
    const int dxy = ((my & 1) << 1) | (mx & 1);
    const int sx = mb_x * 16 + (mx >> 1), sy = mb_y * 16 + (my >> 1);
    const uint8_t* s = fetch(ref[0].data(), ls, ew, eh, sx, sy, 16, 16, tmp, ss);
    hpel(dy, ls, s, ss, 16, 16, dxy, no_rounding);
    const int uvdxy = dxy | (my & 2) | ((mx & 2) >> 1);
    const int ux = sx >> 1, uy = sy >> 1;
    for (int p = 1; p < 3; p++) {
      s = fetch(ref[p].data(), cs, ew >> 1, eh >> 1, ux, uy, 8, 8, tmp, ss);
      hpel(p == 1 ? du : dv, cs, s, ss, 8, 8, uvdxy, no_rounding);
    }
  } else {
    int sumx = 0, sumy = 0;
    for (int k = 0; k < 4; k++) {
      const int mx = mvs[k][0], my = mvs[k][1];
      int sx = mb_x * 16 + (k & 1) * 8 + (mx >> 1), sy = mb_y * 16 + (k >> 1) * 8 + (my >> 1);
      int dxy = 0;
      sx = std::min(std::max(sx, -16), width);
      if (sx != width) dxy |= mx & 1;
      sy = std::min(std::max(sy, -16), height);
      if (sy != height) dxy |= (my & 1) << 1;
      const uint8_t* s = fetch(ref[0].data(), ls, ew, eh, sx, sy, 8, 8, tmp, ss);
      hpel(dy + (k & 1) * 8 + (k >> 1) * 8 * ls, ls, s, ss, 8, 8, dxy, no_rounding);
      sumx += mx;
      sumy += my;
    }
    int mx = round_chroma(sumx), my = round_chroma(sumy);
    int dxy = ((my & 1) << 1) | (mx & 1);
    mx >>= 1;
    my >>= 1;
    int sx = mb_x * 8 + mx, sy = mb_y * 8 + my;
    sx = std::min(std::max(sx, -8), width >> 1);
    if (sx == (width >> 1)) dxy &= ~1;
    sy = std::min(std::max(sy, -8), height >> 1);
    if (sy == (height >> 1)) dxy &= ~2;
    for (int p = 1; p < 3; p++) {
      const uint8_t* s = fetch(ref[p].data(), cs, ew >> 1, eh >> 1, sx, sy, 8, 8, tmp, ss);
      hpel(p == 1 ? du : dv, cs, s, ss, 8, 8, dxy, no_rounding);
    }
  }
  for (int n = 0; n < 6; n++) {
    if (last_index[n] < 0) continue;
    uint8_t* dst = n < 4 ? dy + (n & 1) * 8 + (n >> 1) * 8 * ls : n == 4 ? du : dv;
    idct(block[n], dst, n < 4 ? ls : cs, true);
  }
}

// Whether a resync marker follows the macroblock just read: stuffing (a 0
// and 1s to the byte's end), then the VOP type's count of zeros and a 1.
bool Mpeg4Decoder::at_resync() {
  Bits g = b;
  const int stuff = 8 - (int)(g.pos & 7);
  const uint32_t s = g.get(stuff);
  if (s != (1u << (stuff - 1)) - 1) return false;
  const int prefix = pict_type == 0 ? 16 : f_code + 15;
  int zeros = 0;
  while (zeros < 32 && g.left() > 0 && !g.get1()) zeros++;
  return zeros == prefix && g.left() > 0;
}

int Mpeg4Decoder::video_packet_header() {
  b.get1();
  b.align();
  const int prefix = pict_type == 0 ? 16 : f_code + 15;
  int zeros = 0;
  while (zeros < 32 && !b.get1()) zeros++;
  if (zeros != prefix) return error("a resync marker that does not match f_code");
  int bits = 1;
  while ((1 << bits) < mb_num) bits++;  // av_log2(mb_num - 1) + 1
  const int n = (int)b.get(bits);
  if (n <= 0 || n >= mb_num) return error("a video packet's macroblock number out of range");
  mb_x = n % mb_w;
  mb_y = n / mb_w;
  const int q = (int)b.get(5);
  if (q) qscale = q;
  if (b.get1()) {  // header_extension_code
    while (b.get1()) {
    }
    b.get1();
    b.get(time_bits);
    b.get1();
    b.get(2);
    b.get(3);
    if (pict_type != 0) b.get(3);
  }
  if (b.left() < 0) return error("a truncated video packet header");
  return C_OK;
}

int Mpeg4Decoder::decode_vop(Picture& out) {
  // the VOP header, after its start code
  const int type = (int)b.get(2);
  if (type == 2) return unsupported("B-VOPs");
  if (type == 3) return unsupported("S(GMC)-VOPs");
  while (b.get1()) {
  }  // modulo_time_base
  b.get1();
  b.get(time_bits);
  b.get1();
  if (!b.get1()) return C_NO_FRAME;  // vop_coded
  if (type == 1 && !have_ref) return error("a P-VOP without an I-VOP before it");
  pict_type = type;
  no_rounding = type == 1 ? b.get1() : 0;
  intra_dc_thr = kDcThreshold[b.get(3)];
  const int q = (int)b.get(5);
  if (!q) return error("a zero vop_quant");
  f_code = type == 1 ? (int)b.get(3) : 1;
  if (!f_code) return error("a zero vop_fcode_forward");
  if (b.left() < 0) return error("a truncated VOP header");
  workarounds();
  set_qscale(q);
  std::fill(mv_buf.begin(), mv_buf.end(), 0);
  std::fill(dc_buf[0].begin(), dc_buf[0].end(), 1024);
  for (int p = 1; p < 3; p++) std::fill(dc_buf[p].begin(), dc_buf[p].end(), 1024);
  for (int p = 0; p < 3; p++) std::fill(ac_buf[p].begin(), ac_buf[p].end(), 0);
  mb_x = mb_y = resync_x = resync_y = 0;
  first_slice_line = true;
  while (mb_y < mb_h) {
    if (resync_x == mb_x && resync_y + 1 == mb_y) first_slice_line = false;
    int mv_type, mvs[4][2];
    bool intra;
    const int rc = decode_mb(mv_type, mvs, intra);
    if (rc != C_OK) return rc;
    if (b.left() < 0) return error("a truncated VOP");
    // the vectors the next macroblocks predict from
    if (mv_type == 0) {
      const int mx = intra ? 0 : mvs[0][0], my = intra ? 0 : mvs[0][1];
      for (int k = 0; k < 4; k++) {
        int16_t* m = mv + 2 * (ptrdiff_t)bidx(k);
        m[0] = (int16_t)mx;
        m[1] = (int16_t)my;
      }
    }
    reconstruct(intra, mv_type, mvs);
    const bool packet_end = resync_marker && mb_x + mb_y * mb_w + 1 < mb_num && at_resync();
    if (++mb_x == mb_w) {
      mb_x = 0;
      mb_y++;
    }
    if (packet_end) {
      const int prev = mb_y * mb_w + mb_x;
      const int rc2 = video_packet_header();
      if (rc2 != C_OK) return rc2;
      if (mb_y * mb_w + mb_x != prev) return error("a video packet that skips macroblocks");
      resync_x = mb_x;
      resync_y = mb_y;
      first_slice_line = true;
      set_qscale(qscale);
      clean_buffers();
    }
  }
  for (int p = 0; p < 3; p++) std::swap(cur[p], ref[p]);
  have_ref = true;
  out.w = width;
  out.h = height;
  out.stride = ls;
  out.cstride = cs;
  out.y = ref[0].data();
  out.u = ref[1].data();
  out.v = ref[2].data();
  return C_OK;
}

Mpeg4Decoder* mpeg4_new(const std::string& tag) {
  Mpeg4Decoder* d = new Mpeg4Decoder();
  d->tag = tag;
  return d;
}

void mpeg4_free(Mpeg4Decoder* d) { delete d; }

static bool short_header(const uint8_t* data, size_t n) {
  // H.263's picture start code (22 bits 0000 0000 0000 0000 1000 00)
  for (size_t i = 0; i + 3 <= n; i++) {
    if (data[i] || data[i + 1]) continue;
    if (data[i + 2] == 1) return false;
    if ((data[i + 2] & 0xFC) == 0x80) return true;
  }
  return false;
}

int mpeg4_config(Mpeg4Decoder* d, const uint8_t* data, size_t n, std::string& why) {
  if (short_header(data, n)) {
    why = "short_video_header (H.263 baseline)";
    return C_UNSUPPORTED;
  }
  Bits g;
  g.init(data, n);
  int vop;
  const int rc = d->parse_headers(g, false, vop);
  why = d->why;
  return rc;
}

int mpeg4_decode(Mpeg4Decoder* d, const uint8_t* data, size_t n, Picture& out, std::string& why) {
  d->b.init(data, n);
  int vop;
  int rc = d->parse_headers(d->b, true, vop);
  if (rc == C_OK && !vop) {
    if (short_header(data, n)) {
      d->why = "short_video_header (H.263 baseline)";
      rc = C_UNSUPPORTED;
    } else {
      rc = C_NO_FRAME;
    }
  } else if (rc == C_OK && !d->have_vol) {
    rc = d->error("a VOP before any video object layer header");
  } else if (rc == C_OK) {
    rc = d->decode_vop(out);
    if (rc == C_OK) {
      // a second coded VOP in the sample: a packed bitstream
      Bits g = d->b;
      int more;
      Mpeg4Decoder& dd = *d;
      const int rc2 = dd.parse_headers(g, true, more);
      if (rc2 == C_OK && more) {
        int type;
        if (mpeg4_sample_kind(data + (g.pos >> 3) - 4, n - (size_t)(g.pos >> 3) + 4,
                              d->time_bits, type) == 1)
          rc = d->unsupported("packed bitstreams (two coded VOPs in one sample)");
      }
    }
  }
  why = d->why;
  return rc;
}

int mpeg4_sample_kind(const uint8_t* data, size_t n, int time_bits, int& type) {
  for (size_t i = 0; i + 4 < n; i++) {
    if (data[i] || data[i + 1] || data[i + 2] != 1 || data[i + 3] != 0xB6) continue;
    Bits g;
    g.init(data + i + 4, n - i - 4);
    type = (int)g.get(2);
    while (g.left() > 0 && g.get1()) {
    }
    g.get1();
    g.get(time_bits);
    g.get1();
    const int coded = g.get1();
    if (g.left() < 0) return -1;
    return coded;
  }
  return -1;
}

int mpeg4_time_bits(const Mpeg4Decoder* d) { return d->time_bits; }
int mpeg4_width(const Mpeg4Decoder* d) { return d->width; }
int mpeg4_height(const Mpeg4Decoder* d) { return d->height; }

}  // namespace mgdt_codec
