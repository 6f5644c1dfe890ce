// Video files for the port's inference sources: demuxers that give each
// frame's sample and place in its file, a GIF decoder, the inter-coded
// videos' decoding (MPEG-4 Part 2 by `host_mpeg4.cpp`, VP8 by `host_vp8.h`,
// each frame to BGR by `host_yuv.h`), and a Motion JPEG MP4 writer. The
// JAX package reads and writes videos through cv2.VideoCapture /
// cv2.VideoWriter (ffmpeg); the card's host has neither, so this library
// does the container work and these codecs on the host, and a Motion JPEG
// frame's JPEG goes to the decoder's nvJPEG path (host_loader.cpp).
//
// * AVI (RIFF `AVI ` and OpenDML `AVIX`): the first video stream's `##dc`
//   and `##db` chunks, from `idx1` (with its key-frame flags) or, where
//   there is none, a scan of the `movi` lists; fps is `strh`'s dwRate /
//   dwScale. Motion JPEG by its fourccs, MPEG-4 Part 2 under `XVID`,
//   `XVIX`, `DIVX`, `DX50`, `FMP4`, `MP4V`, `MP4S` and `M4S2` (any case),
//   `strf`'s bytes past its header the decoder configuration.
// * ISO BMFF (`mov`, `mp4`, `m4v`): the first video track's samples, from
//   `stsz`, `stsc` and `stco`/`co64`, cut by the edit list as ffmpeg cuts
//   it, their sync flags from `stss`; fps is ffmpeg's: samples x `mdhd`
//   timescale / `stts` duration. Sample entries `jpeg`, `mjpa`, and `mp4v`
//   whose `esds` object type is 0x6C (Motion JPEG) or 0x20 (MPEG-4 Part 2,
//   its DecoderSpecificInfo the configuration).
// * Matroska and WebM: the first video track's SimpleBlocks and Blocks
//   (key frames by the SimpleBlock flag, or a Block without a
//   ReferenceBlock); fps from its DefaultDuration as ffmpeg reduces it.
//   `V_MJPEG`, `V_MPEG4/ISO/{SP,ASP,AP}` (CodecPrivate the configuration)
//   and `V_VP8`.
// * GIF: LZW, global and local palettes, interlace, transparency and
//   disposal methods 0-3 composed on a canvas as ffmpeg's decoder composes
//   it (and cv2 drops its alpha); fps as cv2 reports it through ffmpeg:
//   100 / floor(mean delay in 1/100 s). Every image is a frame, where
//   ffmpeg's GIF parser joins an image without a graphic control extension
//   to the frame before it in some cases (such files are rare: encoders of
//   animations write the extension before every image).
// * MPEG-4 Part 2 and VP8: at open, each sample's header says whether it
//   gives a frame (cv2 counts a coded VOP, a shown VP8 frame) and whether a
//   decoder can start there (an I-VOP or key frame the container marks),
//   and refuses a B- or S-VOP; a read decodes forward from the decoder's
//   last sample, or from the key frame at or before the frame asked for.
// * Everything else in these containers (H.264, HEVC, VP9, AV1, MPEG-1/2,
//   ..., fragmented MP4, interlaced two-field Motion JPEG, laced Matroska
//   blocks) gives MGDT_V_UNSUPPORTED with the container and codec named.
// * The writer: `ftyp`, `mdat`, `moov` with one `jpeg` track, its frames
//   given as JPEG bytes, fps as cv2's writer turns it into a rational.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 host_video.cpp host_mpeg4.cpp
//        (see mgdt_yolo_tpu_torch/utils/build.py, which builds it at first use).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <string>
#include <vector>

#include "host_codecs.h"
#include "host_vp8.h"
#include "host_yuv.h"

namespace {

using namespace mgdt_codec;

enum { V_OK = 0, V_ERR_OPEN = -1, V_ERR_PARSE = -3, V_UNSUPPORTED = -7, V_END = -8 };

struct File {
  FILE* f = nullptr;
  int64_t size = 0;
  explicit File(const char* path) {
    f = fopen(path, "rb");
    if (f && fseeko(f, 0, SEEK_END) == 0) size = ftello(f);
  }
  ~File() {
    if (f) fclose(f);
  }
  bool read(int64_t off, void* out, size_t n) const {
    if (off < 0 || off + (int64_t)n > size || fseeko(f, off, SEEK_SET) != 0) return false;
    return fread(out, 1, n, f) == n;
  }
  std::vector<uint8_t> bytes(int64_t off, size_t n) const {
    std::vector<uint8_t> v(n);
    if (!read(off, v.data(), n)) v.clear();
    return v;
  }
};

inline uint32_t be32(const uint8_t* p) {
  return (uint32_t)p[0] << 24 | (uint32_t)p[1] << 16 | (uint32_t)p[2] << 8 | p[3];
}
inline uint64_t be64(const uint8_t* p) { return (uint64_t)be32(p) << 32 | be32(p + 4); }
inline uint16_t be16(const uint8_t* p) { return (uint16_t)(p[0] << 8 | p[1]); }
inline uint32_t le32(const uint8_t* p) {
  return (uint32_t)p[0] | (uint32_t)p[1] << 8 | (uint32_t)p[2] << 16 | (uint32_t)p[3] << 24;
}
inline uint16_t le16(const uint8_t* p) { return (uint16_t)(p[0] | p[1] << 8); }
inline std::string fourcc(const uint8_t* p) {
  std::string s;
  for (int i = 0; i < 4; i++) s += (p[i] >= 32 && p[i] < 127) ? (char)p[i] : '?';
  return s;
}

// ffmpeg's av_reduce: num/den as the nearest fraction with both terms <= max
void av_reduce(int64_t& rn, int64_t& rd, int64_t num, int64_t den, int64_t max) {
  int64_t a0n = 0, a0d = 1, a1n = 1, a1d = 0;
  int64_t a = std::llabs(num), b = std::llabs(den), g = a, h = b;
  while (h) { int64_t t = g % h; g = h; h = t; }
  if (g) { num = std::llabs(num) / g; den = std::llabs(den) / g; }
  if (num <= max && den <= max) {
    a1n = num;
    a1d = den;
    den = 0;
  }
  while (den) {
    const uint64_t x = (uint64_t)num / den;
    const int64_t next_den = num - den * (int64_t)x;
    const int64_t a2n = (int64_t)x * a1n + a0n, a2d = (int64_t)x * a1d + a0d;
    if (a2n > max || a2d > max) {
      int64_t y = INT64_MAX;
      if (a1n) y = (max - a0n) / a1n;
      if (a1d) y = std::min(y, (max - a0d) / a1d);
      if (den * (2 * y * a1d + a0d) > num * a1d) {
        a1n = y * a1n + a0n;
        a1d = y * a1d + a0d;
      }
      break;
    }
    a0n = a1n; a0d = a1d;
    a1n = a2n; a1d = a2d;
    num = den;
    den = next_den;
  }
  rn = a1n;
  rd = a1d;
}

enum { K_MJPEG = 0, K_GIF = 1, K_MPEG4 = 2, K_VP8 = 3 };

struct Video {
  std::string container, codec, message;
  int kind = K_MJPEG;
  int w = 0, h = 0;
  double fps = 0;
  std::vector<int64_t> offsets, sizes;
  // inter-coded video (MPEG-4 Part 2, VP8): the container's fourcc and
  // decoder configuration (MPEG-4: the container's, else the first sample
  // that holds a VOL), its key-frame flags (empty: none given), each frame's
  // sample and which samples a decoder can start from; the file and the
  // decoder are opened at the first read, so an open reader holds neither
  std::string path, tag;
  std::vector<uint8_t> extradata, keys;
  std::vector<int64_t> display;
  std::vector<uint8_t> sync;
  std::unique_ptr<File> file;
  Mpeg4Decoder* m4 = nullptr;
  std::unique_ptr<vp8::VP8Decoder> vp8;
  int64_t next_sample = 0;  // the decoder's next sample
  bool broken = true;       // the decoder must restart at a sync sample
  std::vector<uint8_t> sample, bgr;
  ~Video() {
    if (m4) mpeg4_free(m4);
  }
  // GIF
  std::vector<uint8_t> gif;
  std::vector<size_t> gif_frames;  // each frame's first block (extensions included)
  size_t gif_next = 0;
  std::vector<uint32_t> canvas, stored;
  uint32_t bg = 0;
  int prev_disposal = 0, gl = 0, gt = 0, gw = 0, gh = 0;
  uint32_t stored_bg = 0;
  std::vector<uint32_t> gpal;
  bool has_gpal = false;
};

int unsupported(Video& v, const std::string& container, const std::string& codec,
                const std::string& why) {
  v.container = container;
  v.codec = codec;
  v.message = why;
  return V_UNSUPPORTED;
}

static const char* kMjpegAviTags[] = {"MJPG", "AVRN", "AVDJ", "DMB1", "JPGL", "ACDV", "QIVG",
                                      "SLMJ", "CJPG", "IJPG", "MVJP", "AVI1", "JPEG", nullptr};
// MPEG-4 Part 2 (Xvid, DivX 4/5, ffmpeg's own)
static const char* kMpeg4AviTags[] = {"XVID", "XVIX", "DIVX", "DX50", "FMP4", "MP4V", "MP4S",
                                      "M4S2", nullptr};

std::string upper4(const std::string& t) {
  std::string u(t);
  for (auto& c : u) c = (char)toupper(c);
  return u;
}

bool avi_tag_in(const std::string& t, const char* const* tags) {
  const std::string u = upper4(t);
  for (int i = 0; tags[i]; i++)
    if (u == tags[i]) return true;
  return false;
}
bool mjpeg_avi_tag(const std::string& t) { return avi_tag_in(t, kMjpegAviTags); }

// ---------------------------------------------------------------- AVI

int avi_scan(const File& f, int64_t off, int64_t end, const std::string& want, Video& v) {
  uint8_t hd[12];
  v.keys.clear();  // a scan has no key-frame flags
  while (off + 8 <= end && f.read(off, hd, 8)) {
    const uint32_t sz = le32(hd + 4);
    const std::string id = fourcc(hd);
    if (id == "LIST" || id == "RIFF") {
      if (f.read(off + 8, hd + 8, 4) && fourcc(hd + 8) == "rec ")
        avi_scan(f, off + 12, std::min<int64_t>(off + 8 + sz, end), want, v);
    } else if (id.compare(0, 2, want) == 0 && (id.compare(2, 2, "dc") == 0 ||
                                               id.compare(2, 2, "db") == 0)) {
      if (sz) {
        v.offsets.push_back(off + 8);
        v.sizes.push_back(sz);
      }
    }
    off += 8 + sz + (sz & 1);
  }
  return V_OK;
}

int open_avi(const File& f, Video& v) {
  v.container = "AVI";
  uint8_t hd[12];
  int64_t off = 0;
  int stream = -1, vids = -1;
  int64_t movi = -1, movi_end = -1, idx1 = -1;
  uint32_t idx1_size = 0;
  double rate = 0, scale = 0;
  std::vector<std::pair<int64_t, int64_t>> avix;  // later RIFF AVIX movi lists
  // walk RIFF AVI / AVIX, their hdrl and movi lists and idx1
  while (off + 12 <= f.size && f.read(off, hd, 12) && fourcc(hd) == "RIFF") {
    const int64_t riff_end = std::min<int64_t>(off + 8 + le32(hd + 4), f.size);
    const bool first = fourcc(hd + 8) == "AVI ";
    int64_t p = off + 12;
    while (p + 8 <= riff_end && f.read(p, hd, 8)) {
      const uint32_t sz = le32(hd + 4);
      const std::string id = fourcc(hd);
      if (id == "LIST" && f.read(p + 8, hd + 8, 4)) {
        const std::string kind = fourcc(hd + 8);
        if (kind == "hdrl" && first) {
          // the strl lists, in stream order
          int64_t q = p + 12, hend = p + 8 + sz;
          int n = 0;
          while (q + 12 <= hend && f.read(q, hd, 12)) {
            const uint32_t qs = le32(hd + 4);
            if (fourcc(hd) == "LIST" && fourcc(hd + 8) == "strl") {
              auto body = f.bytes(q + 12, std::min<int64_t>(qs - 4, 4096));
              size_t r = 0;
              std::string type, handler, comp;
              uint32_t s_scale = 0, s_rate = 0;
              int bw = 0, bh = 0;
              std::vector<uint8_t> extra;
              while (r + 8 <= body.size()) {
                const uint32_t cs = le32(&body[r + 4]);
                const std::string cid = fourcc(&body[r]);
                if (cid == "strh" && r + 8 + 28 <= body.size()) {
                  type = fourcc(&body[r + 8]);
                  handler = fourcc(&body[r + 12]);
                  s_scale = le32(&body[r + 8 + 20]);
                  s_rate = le32(&body[r + 8 + 24]);
                } else if (cid == "strf" && r + 8 + 20 <= body.size()) {
                  bw = (int32_t)le32(&body[r + 8 + 4]);
                  bh = (int32_t)le32(&body[r + 8 + 8]);
                  comp = fourcc(&body[r + 8 + 16]);
                  if (cs > 40 && r + 8 + cs <= body.size())
                    extra.assign(body.begin() + r + 8 + 40, body.begin() + r + 8 + cs);
                }
                r += 8 + cs + (cs & 1);
              }
              if (type == "vids" && vids < 0) {
                vids = n;
                v.codec = (comp.empty() || comp == "????") ? handler : comp;
                if (avi_tag_in(v.codec, kMpeg4AviTags) ||
                    (!mjpeg_avi_tag(v.codec) && avi_tag_in(handler, kMpeg4AviTags))) {
                  v.kind = K_MPEG4;
                  v.tag = upper4(v.codec);
                  v.extradata = extra;
                } else if (!mjpeg_avi_tag(v.codec) && !mjpeg_avi_tag(handler)) {
                  std::string what = v.codec;
                  const std::string u = upper4(v.codec);
                  if (u == "H264" || u == "AVC1" || u == "X264") what += " (H.264)";
                  else if (u == "HEVC" || u == "H265" || u == "HVC1") what += " (HEVC)";
                  else if (u == "VP80") what += " (VP8 in AVI)";
                  else if (u == "DIV3" || u == "DIV4" || u == "MP43" || u == "MP42")
                    what += " (MS MPEG-4)";
                  return unsupported(v, "AVI", what,
                                     "a codec other than Motion JPEG and MPEG-4 Part 2");
                }
                v.w = bw;
                v.h = std::abs(bh);
                scale = s_scale;
                rate = s_rate;
              }
              n++;
            }
            q += 8 + qs + (qs & 1);
          }
          stream = vids;
        } else if (kind == "movi") {
          if (first) {
            movi = p + 8;  // the 'movi' fourcc, where idx1 offsets count from
            movi_end = p + 8 + sz;
          } else {
            avix.emplace_back(p + 12, std::min<int64_t>(p + 8 + sz, riff_end));
          }
        }
      } else if (id == "idx1" && first) {
        idx1 = p + 8;
        idx1_size = sz;
      }
      p += 8 + sz + (sz & 1);
    }
    off = riff_end + ((riff_end - off) & 1);
  }
  if (stream < 0 || movi < 0) return V_ERR_PARSE;
  char want[12];
  snprintf(want, sizeof want, "%02d", stream);
  bool indexed = false;
  if (idx1 >= 0 && idx1_size >= 16) {
    auto idx = f.bytes(idx1, idx1_size);
    // offsets from the 'movi' fourcc, or from the file's start
    int64_t base = -1;
    for (size_t k = 0; k + 16 <= idx.size() && base < 0; k += 16) {
      if (idx[k] != want[0] || idx[k + 1] != want[1]) continue;
      const int64_t o = le32(&idx[k + 8]);
      uint8_t c[4];
      if (f.read(movi + o, c, 4) && !memcmp(c, &idx[k], 4)) base = movi;
      else if (f.read(o, c, 4) && !memcmp(c, &idx[k], 4)) base = 0;
      else break;
    }
    if (base >= 0) {
      indexed = true;
      for (size_t k = 0; k + 16 <= idx.size(); k += 16) {
        if (idx[k] != want[0] || idx[k + 1] != want[1]) continue;
        if (!(idx[k + 2] == 'd' && (idx[k + 3] == 'c' || idx[k + 3] == 'b'))) continue;
        const uint32_t sz = le32(&idx[k + 12]);
        if (!sz) continue;
        v.offsets.push_back(base + le32(&idx[k + 8]) + 8);
        v.sizes.push_back(sz);
        v.keys.push_back((le32(&idx[k + 4]) & 0x10) != 0);  // AVIIF_KEYFRAME
      }
    }
  }
  if (!indexed) avi_scan(f, movi + 4, std::min(movi_end, f.size), want, v);
  for (auto& a : avix) avi_scan(f, a.first, a.second, want, v);
  if (v.keys.size() != v.offsets.size()) v.keys.clear();
  v.fps = scale > 0 ? rate / scale : 0;
  return V_OK;
}

// ---------------------------------------------------------------- ISO BMFF

struct Box {
  int64_t start, body, end;
  std::string type;
};

bool next_box(const File& f, int64_t off, int64_t end, Box& b) {
  uint8_t hd[16];
  if (off + 8 > end || !f.read(off, hd, 8)) return false;
  uint64_t size = be32(hd);
  int64_t body = off + 8;
  if (size == 1) {
    if (!f.read(off + 8, hd + 8, 8)) return false;
    size = be64(hd + 8);
    body = off + 16;
  } else if (size == 0) {
    size = end - off;
  }
  if (size < (uint64_t)(body - off) || off + (int64_t)size > end) return false;
  b = {off, body, off + (int64_t)size, fourcc(hd + 4)};
  return true;
}

bool find_child(const File& f, const Box& parent, const char* type, Box& out, int64_t skip = 0) {
  int64_t off = parent.body + skip;
  Box b;
  while (next_box(f, off, parent.end, b)) {
    if (b.type == type) {
      out = b;
      return true;
    }
    off = b.end;
  }
  return false;
}

// the objectTypeIndication of an esds box's DecoderConfigDescriptor, -1 if
// none; `dsi` receives its DecoderSpecificInfo
int esds_object_type(const std::vector<uint8_t>& e, std::vector<uint8_t>* dsi = nullptr) {
  size_t p = 4;  // version and flags
  auto tag = [&](int want, size_t& len) -> bool {
    if (p >= e.size() || e[p] != want) return false;
    p++;
    len = 0;
    for (int i = 0; i < 4 && p < e.size(); i++) {
      const uint8_t c = e[p++];
      len = len << 7 | (c & 0x7F);
      if (!(c & 0x80)) break;
    }
    return true;
  };
  size_t len;
  if (!tag(0x03, len)) return -1;
  if (p + 3 > e.size()) return -1;
  const uint8_t flags = e[p + 2];
  p += 3;
  if (flags & 0x80) p += 2;
  if (flags & 0x40) { if (p >= e.size()) return -1; p += 1 + e[p]; }
  if (flags & 0x20) p += 2;
  if (!tag(0x04, len) || p >= e.size()) return -1;
  const int oti = e[p];
  p += 13;  // objectTypeIndication, streamType, buffer size, bit rates
  if (dsi && tag(0x05, len) && p + len <= e.size()) dsi->assign(e.begin() + p, e.begin() + p + len);
  return oti;
}

int open_mp4(const File& f, Video& v) {
  v.container = "MP4/MOV";
  Box top, moov{-1, -1, -1, ""};
  int64_t off = 0;
  bool fragmented = false;
  while (next_box(f, off, f.size, top)) {
    if (top.type == "moov") moov = top;
    if (top.type == "moof") fragmented = true;
    off = top.end;
  }
  if (moov.start < 0) return V_ERR_PARSE;
  Box b;
  if (fragmented || find_child(f, moov, "mvex", b))
    return unsupported(v, "MP4/MOV (fragmented)", "", "fragmented MP4");
  uint32_t movie_scale = 0;
  if (find_child(f, moov, "mvhd", b)) {
    auto m = f.bytes(b.body, 24);
    if (m.size() == 24) movie_scale = m[0] == 1 ? be32(&m[20]) : be32(&m[12]);
  }
  // the first video track
  Box trak, mdia, minf, stbl, hdlr, mdhd;
  off = moov.body;
  bool found = false;
  while (next_box(f, off, moov.end, trak)) {
    off = trak.end;
    if (trak.type != "trak" || !find_child(f, trak, "mdia", mdia)) continue;
    if (!find_child(f, mdia, "hdlr", hdlr)) continue;
    auto hb = f.bytes(hdlr.body, 12);
    if (hb.size() < 12 || fourcc(&hb[8]) != "vide") continue;
    if (!find_child(f, mdia, "mdhd", mdhd) || !find_child(f, mdia, "minf", minf) ||
        !find_child(f, minf, "stbl", stbl))
      return V_ERR_PARSE;
    found = true;
    break;
  }
  if (!found) return V_ERR_PARSE;
  auto md = f.bytes(mdhd.body, 24);
  if (md.size() < 24) return V_ERR_PARSE;
  const uint32_t timescale = md[0] == 1 ? be32(&md[20]) : be32(&md[12]);
  // the sample entry
  Box stsd, entry;
  if (!find_child(f, stbl, "stsd", stsd) || !next_box(f, stsd.body + 8, stsd.end, entry))
    return V_ERR_PARSE;
  const std::string fmt = entry.type;
  auto eb = f.bytes(entry.body, 78);
  if (eb.size() == 78) {
    v.w = be16(&eb[24]);
    v.h = be16(&eb[26]);
  }
  Box sub{entry.start, entry.body + 78, entry.end, fmt};
  if (fmt == "mp4v") {
    Box esds;
    const int oti = find_child(f, sub, "esds", esds)
                        ? esds_object_type(f.bytes(esds.body, (size_t)(esds.end - esds.body)),
                                           &v.extradata)
                        : -1;
    if (oti == 0x20) {
      v.kind = K_MPEG4;
    } else if (oti != 0x6C) {
      char buf[64];
      const char* name = (oti >= 0x60 && oti <= 0x65) ? ": MPEG-2" : oti == 0x6A ? ": MPEG-1"
                                                                                : "";
      snprintf(buf, sizeof buf, "mp4v (object type 0x%02X%s)", oti & 0xFF, name);
      return unsupported(v, "MP4/MOV", buf,
                         "an mp4v codec other than MPEG-4 Part 2 and Motion JPEG");
    }
  } else if (fmt != "jpeg" && fmt != "mjpa") {
    std::string what = fmt;
    if (fmt == "avc1" || fmt == "avc3") what += " (H.264)";
    else if (fmt == "hvc1" || fmt == "hev1") what += " (HEVC)";
    else if (fmt == "av01") what += " (AV1)";
    else if (fmt == "vp09") what += " (VP9)";
    return unsupported(v, "MP4/MOV", what, "a codec other than Motion JPEG and MPEG-4 Part 2");
  }
  Box fiel;
  if (find_child(f, sub, "fiel", fiel)) {
    auto fb = f.bytes(fiel.body, 1);
    if (!fb.empty() && fb[0] == 2)
      return unsupported(v, "MP4/MOV", fmt + " (two fields)", "interlaced two-field Motion JPEG");
  }
  v.codec = fmt;
  // sample sizes, chunks, chunk offsets, durations
  Box stsz, stsc, stco, stts;
  if (!find_child(f, stbl, "stsz", stsz) || !find_child(f, stbl, "stsc", stsc) ||
      !find_child(f, stbl, "stts", stts))
    return V_ERR_PARSE;
  const bool co64 = !find_child(f, stbl, "stco", stco);
  if (co64 && !find_child(f, stbl, "co64", stco)) return V_ERR_PARSE;
  auto zs = f.bytes(stsz.body, (size_t)(stsz.end - stsz.body));
  auto sc = f.bytes(stsc.body, (size_t)(stsc.end - stsc.body));
  auto co = f.bytes(stco.body, (size_t)(stco.end - stco.body));
  auto ts = f.bytes(stts.body, (size_t)(stts.end - stts.body));
  if (zs.size() < 12 || sc.size() < 8 || co.size() < 8 || ts.size() < 8) return V_ERR_PARSE;
  const uint32_t fixed = be32(&zs[4]), nsamples = be32(&zs[8]);
  if (!fixed && zs.size() < 12 + 4 * (size_t)nsamples) return V_ERR_PARSE;
  const uint32_t nchunks = be32(&co[4]), nsc = be32(&sc[4]);
  if (co.size() < 8 + (size_t)nchunks * (co64 ? 8 : 4) || sc.size() < 8 + (size_t)nsc * 12)
    return V_ERR_PARSE;
  std::vector<int64_t> off_all, size_all;
  uint32_t s = 0;
  for (uint32_t e = 0; e < nsc && s < nsamples; e++) {
    const uint32_t first = be32(&sc[8 + 12 * e]), per = be32(&sc[12 + 12 * e]);
    const uint32_t last = e + 1 < nsc ? be32(&sc[8 + 12 * (e + 1)]) - 1 : nchunks;
    for (uint32_t c = first; c <= last && c <= nchunks && s < nsamples; c++) {
      int64_t o = co64 ? (int64_t)be64(&co[8 + 8 * (c - 1)]) : be32(&co[8 + 4 * (c - 1)]);
      for (uint32_t k = 0; k < per && s < nsamples; k++, s++) {
        const int64_t sz = fixed ? fixed : be32(&zs[12 + 4 * s]);
        off_all.push_back(o);
        size_all.push_back(sz);
        o += sz;
      }
    }
  }
  // decode times; fps as ffmpeg's mov demuxer sets avg_frame_rate
  const uint32_t nts = be32(&ts[4]);
  std::vector<int64_t> dts;
  int64_t t = 0, total = 0, counted = 0;
  for (uint32_t e = 0; e < nts && 8 + 8 * (size_t)e + 8 <= ts.size(); e++) {
    const uint32_t count = be32(&ts[8 + 8 * e]), delta = be32(&ts[12 + 8 * e]);
    for (uint32_t k = 0; k < count; k++, t += delta) dts.push_back(t);
    total += (int64_t)count * delta;
    counted += count;
  }
  if (total > 0 && counted > 0 && timescale) {
    int64_t n, d;
    av_reduce(n, d, (int64_t)timescale * counted, total, INT32_MAX);
    v.fps = d ? (double)n / (double)d : 0;
  }
  dts.resize(off_all.size(), t);
  // the edit list: samples whose time falls in an edit, edit after edit
  Box edts, elst;
  std::vector<size_t> order;
  if (find_child(f, trak, "edts", edts) && find_child(f, edts, "elst", elst) && movie_scale) {
    auto el = f.bytes(elst.body, (size_t)(elst.end - elst.body));
    if (el.size() >= 8) {
      const bool v1 = el[0] == 1;
      const uint32_t n = be32(&el[4]);
      const size_t step = v1 ? 20 : 12;
      bool any = false;
      for (uint32_t e = 0; e < n && 8 + step * (e + 1) <= el.size(); e++) {
        const uint8_t* p = &el[8 + step * e];
        const int64_t seg = v1 ? (int64_t)be64(p) : be32(p);
        const int64_t media = v1 ? (int64_t)be64(p + 8) : (int32_t)be32(p + 4);
        if (media < 0) continue;  // an empty edit: no samples
        any = true;
        const int64_t span = seg ? seg * (int64_t)timescale / movie_scale : INT64_MAX / 2;
        for (size_t k = 0; k < dts.size(); k++)
          if (dts[k] >= media && dts[k] < media + span) order.push_back(k);
      }
      if (!any) order.clear();
    }
  }
  // sync samples: `stss`, or every sample where it is absent
  std::vector<uint8_t> keys_all(off_all.size(), 1);
  Box stss;
  if (find_child(f, stbl, "stss", stss)) {
    auto ss = f.bytes(stss.body, (size_t)(stss.end - stss.body));
    std::fill(keys_all.begin(), keys_all.end(), 0);
    const uint32_t n = ss.size() >= 8 ? be32(&ss[4]) : 0;
    for (uint32_t e = 0; e < n && 8 + 4 * (size_t)e + 4 <= ss.size(); e++) {
      const uint32_t k = be32(&ss[8 + 4 * e]);
      if (k >= 1 && k <= keys_all.size()) keys_all[k - 1] = 1;
    }
  }
  if (order.empty()) {
    v.offsets = off_all;
    v.sizes = size_all;
    v.keys = keys_all;
  } else {
    for (size_t k : order) {
      v.offsets.push_back(off_all[k]);
      v.sizes.push_back(size_all[k]);
      v.keys.push_back(keys_all[k]);
    }
  }
  return V_OK;
}

// ---------------------------------------------------------------- Matroska

bool ebml_vint(const File& f, int64_t& off, int64_t end, uint64_t& value, bool keep_marker,
               bool* unknown = nullptr) {
  uint8_t c;
  if (off >= end || !f.read(off, &c, 1) || !c) return false;
  int len = 1;
  while (!(c & (0x80 >> (len - 1)))) len++;
  uint8_t buf[8];
  if (off + len > end || !f.read(off, buf, len)) return false;
  value = keep_marker ? buf[0] : (buf[0] & (0xFF >> len));
  bool all_ones = (buf[0] & (0xFF >> len)) == (0xFF >> len);
  for (int i = 1; i < len; i++) {
    value = value << 8 | buf[i];
    all_ones &= buf[i] == 0xFF;
  }
  if (unknown) *unknown = all_ones && !keep_marker;
  off += len;
  return true;
}

uint64_t ebml_uint(const File& f, int64_t off, uint64_t size) {
  uint8_t b[8];
  uint64_t v = 0;
  if (size > 8 || !f.read(off, b, (size_t)size)) return 0;
  for (uint64_t i = 0; i < size; i++) v = v << 8 | b[i];
  return v;
}

int open_mkv(const File& f, Video& v) {
  v.container = "Matroska";
  int64_t off = 0;
  uint64_t id, size;
  bool unknown;
  int64_t seg_body = -1, seg_end = f.size;
  std::string doctype = "matroska";
  while (off < f.size) {
    if (!ebml_vint(f, off, f.size, id, true) || !ebml_vint(f, off, f.size, size, false, &unknown))
      return V_ERR_PARSE;
    if (id == 0x1A45DFA3) {
      int64_t p = off, e = off + (int64_t)size;
      uint64_t cid, cs;
      while (p < e && ebml_vint(f, p, e, cid, true) && ebml_vint(f, p, e, cs, false)) {
        if (cid == 0x4282) {
          auto s = f.bytes(p, (size_t)cs);
          doctype.assign(s.begin(), s.end());
          doctype = doctype.c_str();
        }
        p += (int64_t)cs;
      }
      off = e;
    } else if (id == 0x18538067) {
      seg_body = off;
      seg_end = unknown ? f.size : std::min<int64_t>(off + (int64_t)size, f.size);
      break;
    } else {
      off += (int64_t)size;
    }
  }
  if (doctype != "matroska" && doctype != "webm")
    return unsupported(v, "Matroska (" + doctype + ")", "", "the " + doctype + " container");
  if (doctype == "webm") v.container = "WebM";
  if (seg_body < 0) return V_ERR_PARSE;
  uint64_t track = 0, default_duration = 0;
  bool have_track = false;
  // level-1 elements of the segment; clusters may have an unknown size
  off = seg_body;
  while (off < seg_end) {
    if (!ebml_vint(f, off, seg_end, id, true) || !ebml_vint(f, off, seg_end, size, false, &unknown))
      break;
    int64_t end = unknown ? seg_end : std::min<int64_t>(off + (int64_t)size, seg_end);
    if (id == 0x1654AE6B && !have_track) {  // Tracks
      int64_t p = off;
      uint64_t tid, ts;
      while (p < end && ebml_vint(f, p, end, tid, true) && ebml_vint(f, p, end, ts, false)) {
        const int64_t te = p + (int64_t)ts;
        if (tid == 0xAE) {  // TrackEntry
          uint64_t number = 0, type = 0, dd = 0;
          std::string codec;
          std::vector<uint8_t> priv;
          bool encoded = false, interlaced = false;
          int w = 0, h = 0;
          int64_t q = p;
          uint64_t cid, cs;
          while (q < te && ebml_vint(f, q, te, cid, true) && ebml_vint(f, q, te, cs, false)) {
            if (cid == 0xD7) number = ebml_uint(f, q, cs);
            else if (cid == 0x83) type = ebml_uint(f, q, cs);
            else if (cid == 0x23E383) dd = ebml_uint(f, q, cs);
            else if (cid == 0x86) {
              auto s = f.bytes(q, (size_t)cs);
              codec.assign(s.begin(), s.end());
              codec = codec.c_str();
            } else if (cid == 0x63A2) {
              priv = f.bytes(q, (size_t)std::min<uint64_t>(cs, 1 << 20));
            } else if (cid == 0x6D80) encoded = true;
            else if (cid == 0xE0) {
              int64_t r = q;
              uint64_t vid, vs;
              while (r < q + (int64_t)cs && ebml_vint(f, r, q + (int64_t)cs, vid, true) &&
                     ebml_vint(f, r, q + (int64_t)cs, vs, false)) {
                if (vid == 0xB0) w = (int)ebml_uint(f, r, vs);
                else if (vid == 0xBA) h = (int)ebml_uint(f, r, vs);
                else if (vid == 0x9A) interlaced = ebml_uint(f, r, vs) == 1;
                r += (int64_t)vs;
              }
            }
            q += (int64_t)cs;
          }
          if (type == 1 && !have_track) {
            if (codec == "V_MPEG4/ISO/SP" || codec == "V_MPEG4/ISO/ASP" ||
                codec == "V_MPEG4/ISO/AP") {
              v.kind = K_MPEG4;
              v.extradata = priv;
            } else if (codec == "V_VP8") {
              v.kind = K_VP8;
            } else if (codec != "V_MJPEG") {
              std::string what = codec;
              if (codec == "V_VP9") what += " (VP9)";
              else if (codec == "V_AV1") what += " (AV1)";
              else if (codec == "V_MPEG4/ISO/AVC") what += " (H.264)";
              else if (codec == "V_MPEGH/ISO/HEVC") what += " (HEVC)";
              return unsupported(v, v.container, what,
                                 "a codec other than Motion JPEG, MPEG-4 Part 2 and VP8");
            }
            if (encoded)
              return unsupported(v, v.container, codec + " (content encoding)",
                                 "compressed or encrypted track content");
            if (interlaced && v.kind == K_MJPEG)
              return unsupported(v, v.container, codec + " (interlaced)",
                                 "interlaced two-field Motion JPEG");
            have_track = true;
            track = number;
            default_duration = dd;
            v.codec = codec;
            v.w = w;
            v.h = h;
          }
        }
        p = te;
      }
    } else if (id == 0x1F43B675) {  // Cluster
      int64_t p = off;
      uint64_t cid, cs;
      bool cu;
      while (p < end) {
        const int64_t start = p;
        if (!ebml_vint(f, p, end, cid, true) || !ebml_vint(f, p, end, cs, false, &cu)) break;
        if (unknown && (cid == 0x1F43B675 || cid == 0x1C53BB6B || cid == 0x1254C367 ||
                        cid == 0x1654AE6B || cid == 0x1941A469 || cid == 0x1043A770)) {
          end = start;  // the next level-1 element ends a cluster of unknown size
          break;
        }
        int64_t block = -1, bend = -1;
        bool key = false;
        if (cid == 0xA3) {
          block = p;
          bend = p + (int64_t)cs;
          key = true;  // SimpleBlock: its keyframe flag, below
        } else if (cid == 0xA0) {
          int64_t q = p;
          uint64_t gid, gs;
          key = true;  // a Block is a key frame unless it names a ReferenceBlock
          while (q < p + (int64_t)cs && ebml_vint(f, q, p + (int64_t)cs, gid, true) &&
                 ebml_vint(f, q, p + (int64_t)cs, gs, false)) {
            if (gid == 0xA1) { block = q; bend = q + (int64_t)gs; }
            if (gid == 0xFB) key = false;
            q += (int64_t)gs;
          }
        }
        if (block >= 0 && have_track) {
          uint64_t tn;
          int64_t q = block;
          uint8_t hd[3];
          if (ebml_vint(f, q, bend, tn, false) && tn == track && f.read(q, hd, 3)) {
            if ((hd[2] >> 1) & 3)
              return unsupported(v, v.container, v.codec + " (laced blocks)", "laced blocks");
            v.offsets.push_back(q + 3);
            v.sizes.push_back(bend - q - 3);
            v.keys.push_back(cid == 0xA3 ? (hd[2] & 0x80) != 0 : key);
          }
        }
        p += (int64_t)cs;
      }
    }
    off = end;
  }
  if (!have_track) return V_ERR_PARSE;
  if (default_duration) {
    int64_t n, d;
    av_reduce(n, d, 1000000000LL, (int64_t)default_duration, 30000);
    v.fps = d ? (double)n / (double)d : 0;
  }
  return V_OK;
}

// ---------------------------------------------------------------- GIF

// Walk a GIF's blocks from `p`: the image of the next frame (with the
// extensions before it) ends where the function returns; -1 at the trailer
// or where the data ends, -2 on a broken block.
int64_t gif_skip_frame(const std::vector<uint8_t>& g, size_t p, int& delay, bool& has_gce) {
  auto skip_sub = [&](size_t& q) -> bool {
    while (q < g.size()) {
      const uint8_t n = g[q++];
      if (!n) return true;
      q += n;
    }
    return false;
  };
  has_gce = false;
  delay = 0;
  while (p < g.size()) {
    const uint8_t b = g[p];
    if (b == 0x3B) return -1;
    if (b == 0x21) {
      if (p + 2 > g.size()) return -2;
      if (g[p + 1] == 0xF9 && p + 8 <= g.size() && g[p + 2] == 4) {
        has_gce = true;
        delay = le16(&g[p + 4]);
      }
      size_t q = p + 2;
      if (!skip_sub(q)) return -2;
      p = q;
    } else if (b == 0x2C) {
      if (p + 10 > g.size()) return -2;
      size_t q = p + 10;
      const uint8_t flags = g[p + 9];
      if (flags & 0x80) q += 3 * (1u << ((flags & 7) + 1));
      q += 1;  // LZW minimum code size
      if (!skip_sub(q)) return -2;
      return (int64_t)q;
    } else {
      return -2;
    }
  }
  return -1;
}

int open_gif(const File& f, Video& v) {
  v.container = "GIF";
  v.codec = "gif";
  v.kind = 1;
  v.gif = f.bytes(0, (size_t)f.size);
  const auto& g = v.gif;
  if (g.size() < 13) return V_ERR_PARSE;
  v.w = le16(&g[6]);
  v.h = le16(&g[8]);
  const uint8_t flags = g[10];
  size_t p = 13;
  v.gpal.assign(256, 0xFF000000u);
  if (flags & 0x80) {
    const size_t n = 1u << ((flags & 7) + 1);
    if (p + 3 * n > g.size()) return V_ERR_PARSE;
    for (size_t i = 0; i < n; i++)
      v.gpal[i] = 0xFF000000u | (uint32_t)g[p + 3 * i] << 16 | (uint32_t)g[p + 3 * i + 1] << 8 |
                  g[p + 3 * i + 2];
    p += 3 * n;
    v.has_gpal = true;
    v.bg = v.gpal[g[11]];
  }
  int64_t sum = 0;
  for (;;) {
    int delay;
    bool gce;
    const int64_t end = gif_skip_frame(g, p, delay, gce);
    if (end < 0) break;
    v.gif_frames.push_back(p);
    // ffmpeg's frame durations: a GCE's delay, 10 (1/10 s) where it is 0,
    // nothing where a frame has no GCE
    sum += gce ? (delay ? delay : 10) : 0;
    p = (size_t)end;
  }
  const int64_t n = (int64_t)v.gif_frames.size();
  if (!n || !v.w || !v.h) return V_ERR_PARSE;
  v.fps = 100.0 / (double)std::max<int64_t>(sum / n, 1);
  v.canvas.assign((size_t)v.w * v.h, 0);
  return V_OK;
}

// The LZW of one GIF image: `width` indices a row, rows given to `row`;
// returns the rows decoded (fewer where the data ends early).
template <class RowFn>
int gif_lzw(const uint8_t* data, size_t n, int min_code, int width, int height, RowFn row) {
  if (min_code < 2 || min_code > 11) return 0;
  const int clear = 1 << min_code, eoi = clear + 1;
  std::vector<int16_t> prefix(4096, -1);
  std::vector<uint8_t> suffix(4096), first(4096), stack(4097), line(width);
  for (int i = 0; i < clear; i++) suffix[i] = first[i] = (uint8_t)i;
  int bits = min_code + 1, next = clear + 2, old = -1, x = 0, y = 0;
  uint32_t acc = 0;
  int nacc = 0;
  size_t p = 0;
  auto put = [&](uint8_t v) {
    if (y >= height) return;
    line[x++] = v;
    if (x == width) {
      row(y++, line.data());
      x = 0;
    }
  };
  while (y < height) {
    while (nacc < bits && p < n) {
      acc |= (uint32_t)data[p++] << nacc;
      nacc += 8;
    }
    if (nacc < bits) break;
    const int code = acc & ((1u << bits) - 1);
    acc >>= bits;
    nacc -= bits;
    if (code == clear) {
      bits = min_code + 1;
      next = clear + 2;
      old = -1;
      continue;
    }
    if (code == eoi) break;
    int sp = 0;
    if (old < 0) {
      if (code >= clear) break;
      put((uint8_t)code);
      old = code;
      continue;
    }
    uint8_t fch;
    int c = code;
    if (code < next) {
      fch = first[code];
    } else if (code == next) {
      fch = first[old];
      c = old;
      stack[sp++] = fch;
    } else {
      break;
    }
    for (; c >= 0 && sp < 4096; c = prefix[c]) stack[sp++] = suffix[c];
    while (sp) put(stack[--sp]);
    if (next < 4096) {
      prefix[next] = (int16_t)old;
      suffix[next] = fch;
      first[next] = first[old];
      next++;
      if (next == (1 << bits) && bits < 12) bits++;
    }
    old = code;
  }
  return y;
}

// ffmpeg's transparent colour (white, alpha 0): what shows where no frame
// has painted, once cv2 drops the alpha
constexpr uint32_t kTransparent = 0x00FFFFFFu;

int gif_next(Video& v, uint8_t* bgr) {
  if (v.gif_next >= v.gif_frames.size()) return V_END;
  const auto& g = v.gif;
  size_t p = v.gif_frames[v.gif_next];
  const bool key = v.gif_next == 0;
  v.gif_next++;
  int transparent = -1, disposal = 0;
  while (p < g.size() && g[p] == 0x21) {  // extensions
    if (g[p + 1] == 0xF9 && p + 8 <= g.size() && g[p + 2] == 4) {
      const uint8_t fl = g[p + 3];
      transparent = (fl & 1) ? g[p + 6] : -1;
      disposal = (fl >> 2) & 7;
      if (disposal > 3) disposal = 0;
    }
    size_t q = p + 2;
    while (q < g.size() && g[q]) q += 1 + g[q];
    p = q + 1;
  }
  if (p + 10 > g.size() || g[p] != 0x2C) return V_ERR_PARSE;
  int left = le16(&g[p + 1]), top = le16(&g[p + 3]), width = le16(&g[p + 5]),
      height = le16(&g[p + 7]);
  const uint8_t flags = g[p + 9];
  p += 10;
  std::vector<uint32_t> lpal;
  const std::vector<uint32_t>* pal = &v.gpal;
  if (flags & 0x80) {
    const size_t n = 1u << ((flags & 7) + 1);
    lpal.assign(256, 0xFF000000u);
    for (size_t i = 0; i < n && p + 3 * i + 2 < g.size(); i++)
      lpal[i] = 0xFF000000u | (uint32_t)g[p + 3 * i] << 16 | (uint32_t)g[p + 3 * i + 1] << 8 |
                g[p + 3 * i + 2];
    p += 3 * n;
    pal = &lpal;
  } else if (!v.has_gpal) {
    return V_ERR_PARSE;
  }
  const int W = v.w, H = v.h;
  auto& cv = v.canvas;
  if (key) std::fill(cv.begin(), cv.end(), (transparent < 0 && v.has_gpal) ? v.bg : kTransparent);
  // ffmpeg's clipping of an image to the screen
  if (!width || width > W) width = W;
  if (left >= W || top >= H) return V_ERR_PARSE;
  if (!height || height > H) height = H;
  const int pw = left + width > W ? W - left : width;
  if (top + height > H) height = H - top;
  // the previous frame's disposal, then this frame's to come
  if (v.prev_disposal == 2) {
    for (int y = v.gt; y < v.gt + v.gh; y++)
      std::fill(cv.begin() + (size_t)y * W + v.gl, cv.begin() + (size_t)y * W + v.gl + v.gw,
                v.stored_bg);
  } else if (v.prev_disposal == 3) {
    for (int y = v.gt; y < v.gt + v.gh; y++)
      memcpy(&cv[(size_t)y * W + v.gl], &v.stored[(size_t)y * W + v.gl], v.gw * 4);
  }
  v.prev_disposal = disposal;
  if (disposal) {
    v.gl = left; v.gt = top; v.gw = pw; v.gh = height;
    if (disposal == 2) {
      v.stored_bg = transparent >= 0 ? kTransparent : v.bg;
    } else if (disposal == 3) {
      v.stored.resize(cv.size());
      for (int y = top; y < top + height; y++)
        memcpy(&v.stored[(size_t)y * W + left], &cv[(size_t)y * W + left], pw * 4);
    }
  }
  if (p >= g.size()) return V_ERR_PARSE;
  const int min_code = g[p++];
  std::vector<uint8_t> data;
  while (p < g.size() && g[p]) {
    const size_t k = g[p];
    if (p + 1 + k > g.size()) break;
    data.insert(data.end(), g.begin() + p + 1, g.begin() + p + 1 + k);
    p += 1 + k;
  }
  const bool interlaced = flags & 0x40;
  // row k of the image -> its line: Adam-like passes 0, 4, 2, 1 every 8, 8, 4, 2
  auto line_of = [&](int k) {
    if (!interlaced) return k;
    const int n0 = (height + 7) / 8, n1 = (height + 3) / 8, n2 = (height + 1) / 4;
    if (k < n0) return 8 * k;
    k -= n0;
    if (k < n1) return 4 + 8 * k;
    k -= n1;
    if (k < n2) return 2 + 4 * k;
    return 1 + 2 * (k - n2);
  };
  gif_lzw(data.data(), data.size(), min_code, width, height, [&](int k, const uint8_t* idx) {
    const int y = line_of(k);
    if (y >= height) return;
    uint32_t* o = &cv[(size_t)(top + y) * W + left];
    for (int x = 0; x < pw; x++)
      if (idx[x] != transparent) o[x] = (*pal)[idx[x]];
  });
  for (size_t i = 0; i < cv.size(); i++) {
    bgr[3 * i] = (uint8_t)cv[i];
    bgr[3 * i + 1] = (uint8_t)(cv[i] >> 8);
    bgr[3 * i + 2] = (uint8_t)(cv[i] >> 16);
  }
  return V_OK;
}

// ---------------------------------------------------------------- MP4 writer

struct Writer {
  FILE* f = nullptr;
  int w = 0, h = 0;
  int64_t rate = 0, base = 0, mdat = 0;
  std::vector<int64_t> offsets;
  std::vector<uint32_t> sizes;
};

void put32(std::vector<uint8_t>& o, uint32_t v) {
  for (int s = 24; s >= 0; s -= 8) o.push_back((uint8_t)(v >> s));
}
void put16(std::vector<uint8_t>& o, uint32_t v) {
  o.push_back((uint8_t)(v >> 8));
  o.push_back((uint8_t)v);
}
void put64(std::vector<uint8_t>& o, uint64_t v) {
  put32(o, (uint32_t)(v >> 32));
  put32(o, (uint32_t)v);
}
void put4(std::vector<uint8_t>& o, const char* s) { o.insert(o.end(), s, s + 4); }
// a box around what `body` writes
template <class Fn>
void box(std::vector<uint8_t>& o, const char* type, Fn body) {
  const size_t at = o.size();
  put32(o, 0);
  put4(o, type);
  body();
  const uint32_t n = (uint32_t)(o.size() - at);
  for (int i = 0; i < 4; i++) o[at + i] = (uint8_t)(n >> (24 - 8 * i));
}
void matrix(std::vector<uint8_t>& o) {
  const uint32_t m[9] = {0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000};
  for (uint32_t x : m) put32(o, x);
}

std::vector<uint8_t> moov(const Writer& wr) {
  std::vector<uint8_t> o;
  const uint32_t n = (uint32_t)wr.sizes.size();
  const uint64_t duration = (uint64_t)n * wr.base;  // in the track's timescale (= rate)
  const uint32_t movie_scale = 1000;
  const uint64_t movie_duration = wr.rate ? duration * movie_scale / wr.rate : 0;
  bool large = false;
  for (int64_t x : wr.offsets) large |= x > 0xFFFFFFFFLL;
  box(o, "moov", [&] {
    box(o, "mvhd", [&] {
      put32(o, 0);
      put32(o, 0); put32(o, 0);
      put32(o, movie_scale); put32(o, (uint32_t)movie_duration);
      put32(o, 0x10000); put16(o, 0x100); put16(o, 0);
      put32(o, 0); put32(o, 0);
      matrix(o);
      for (int i = 0; i < 6; i++) put32(o, 0);
      put32(o, 2);
    });
    box(o, "trak", [&] {
      box(o, "tkhd", [&] {
        put32(o, 3);  // enabled, in movie
        put32(o, 0); put32(o, 0);
        put32(o, 1); put32(o, 0);
        put32(o, (uint32_t)movie_duration);
        put32(o, 0); put32(o, 0);
        put16(o, 0); put16(o, 0); put16(o, 0); put16(o, 0);
        matrix(o);
        put32(o, (uint32_t)wr.w << 16); put32(o, (uint32_t)wr.h << 16);
      });
      box(o, "edts", [&] {
        box(o, "elst", [&] {
          put32(o, 0); put32(o, 1);
          put32(o, (uint32_t)movie_duration); put32(o, 0); put32(o, 0x10000);
        });
      });
      box(o, "mdia", [&] {
        box(o, "mdhd", [&] {
          put32(o, 0);
          put32(o, 0); put32(o, 0);
          put32(o, (uint32_t)wr.rate); put32(o, (uint32_t)duration);
          put16(o, 0x55C4); put16(o, 0);  // language "und"
        });
        box(o, "hdlr", [&] {
          put32(o, 0); put32(o, 0);
          put4(o, "vide");
          put32(o, 0); put32(o, 0); put32(o, 0);
          const char name[] = "VideoHandler";
          o.insert(o.end(), name, name + sizeof name);
        });
        box(o, "minf", [&] {
          box(o, "vmhd", [&] { put32(o, 1); put32(o, 0); put32(o, 0); });
          box(o, "dinf", [&] {
            box(o, "dref", [&] {
              put32(o, 0); put32(o, 1);
              box(o, "url ", [&] { put32(o, 1); });
            });
          });
          box(o, "stbl", [&] {
            box(o, "stsd", [&] {
              put32(o, 0); put32(o, 1);
              box(o, "jpeg", [&] {
                for (int i = 0; i < 6; i++) o.push_back(0);
                put16(o, 1);
                for (int i = 0; i < 4; i++) put32(o, 0);
                put16(o, (uint32_t)wr.w); put16(o, (uint32_t)wr.h);
                put32(o, 0x480000); put32(o, 0x480000);
                put32(o, 0);
                put16(o, 1);
                for (int i = 0; i < 32; i++) o.push_back(0);
                put16(o, 0x18); put16(o, 0xFFFF);
              });
            });
            box(o, "stts", [&] {
              put32(o, 0); put32(o, n ? 1 : 0);
              if (n) { put32(o, n); put32(o, (uint32_t)wr.base); }
            });
            box(o, "stsc", [&] {
              put32(o, 0); put32(o, n ? 1 : 0);
              if (n) { put32(o, 1); put32(o, 1); put32(o, 1); }
            });
            box(o, "stsz", [&] {
              put32(o, 0); put32(o, 0); put32(o, n);
              for (uint32_t s : wr.sizes) put32(o, s);
            });
            box(o, large ? "co64" : "stco", [&] {
              put32(o, 0); put32(o, n);
              for (int64_t x : wr.offsets) {
                if (large) put64(o, (uint64_t)x);
                else put32(o, (uint32_t)x);
              }
            });
          });
        });
      });
    });
  });
  return o;
}

// ---------------------------------------------------------------- inter-coded video

// Index an MPEG-4 Part 2 or VP8 video's samples: which give a frame (cv2
// counts those), which a decoder can start from (a key frame by the
// container's flag and the codec's own header), and the stream's refusals.
int prepare_inter(const char* path, Video& v) {
  v.path = path;
  const File f(path);
  for (size_t i = 0; i < v.offsets.size(); i++)
    if (v.offsets[i] < 0 || v.offsets[i] + v.sizes[i] > f.size) {
      v.offsets.resize(i);  // a sample past the file's end ends the video there
      v.sizes.resize(i);
      break;
    }
  const size_t n = v.offsets.size();
  if (v.keys.size() < n) v.keys.assign(n, 1);
  v.sync.assign(n, 0);
  std::string why;
  const std::string codec = v.codec + (v.kind == K_MPEG4 ? " (MPEG-4 Part 2)" : " (VP8)");
  if (v.kind == K_MPEG4) {
    v.m4 = mpeg4_new(v.tag);
    bool have_vol = false;
    if (!v.extradata.empty()) {
      const int rc = mpeg4_config(v.m4, v.extradata.data(), v.extradata.size(), why);
      if (rc == C_UNSUPPORTED) return unsupported(v, v.container, codec, why);
      have_vol = rc == C_OK && mpeg4_width(v.m4) > 0;
    }
    for (size_t i = 0; i < n; i++) {
      const auto head = f.bytes(v.offsets[i], (size_t)std::min<int64_t>(v.sizes[i], 1024));
      bool vol = false;
      for (size_t k = 0; k + 4 <= head.size() && !vol; k++)
        vol = !head[k] && !head[k + 1] && head[k + 2] == 1 && (head[k + 3] & 0xF0) == 0x20;
      if (vol || (!have_vol && i == 0)) {
        const int rc = mpeg4_config(v.m4, head.data(), head.size(), why);
        if (rc == C_UNSUPPORTED) return unsupported(v, v.container, codec, why);
        if (rc == C_OK && mpeg4_width(v.m4) > 0 && !have_vol) {
          have_vol = true;
          v.extradata = head;
        }
      }
      int type = 0;
      const int coded = mpeg4_sample_kind(head.data(), head.size(), mpeg4_time_bits(v.m4), type);
      if (coded == 1 && type == 2) return unsupported(v, v.container, codec, "B-VOPs");
      if (coded == 1 && type == 3) return unsupported(v, v.container, codec, "S(GMC)-VOPs");
      if (coded == 1 || (coded < 0 && (int64_t)head.size() < v.sizes[i])) {
        v.display.push_back((int64_t)i);
        v.sync[i] = coded == 1 && type == 0 && v.keys[i];
      }
    }
    if (!have_vol) return V_ERR_PARSE;
    v.w = mpeg4_width(v.m4);
    v.h = mpeg4_height(v.m4);
    mpeg4_free(v.m4);
    v.m4 = nullptr;
  } else {
    bool sized = false;
    for (size_t i = 0; i < n; i++) {
      const auto head = f.bytes(v.offsets[i], (size_t)std::min<int64_t>(v.sizes[i], 10));
      if (head.size() < 3) continue;
      const bool key = !(head[0] & 1), show = (head[0] >> 4) & 1;
      if ((head[0] >> 1 & 7) > 3) return unsupported(v, v.container, codec,
                                                      "a VP8 version above 3");
      if (key && head.size() == 10 && !sized) {
        v.w = le16(&head[6]) & 0x3fff;
        v.h = le16(&head[8]) & 0x3fff;
        sized = true;
      }
      if (show) v.display.push_back((int64_t)i);
      v.sync[i] = key;
    }
    if (!sized) return V_ERR_PARSE;
  }
  v.broken = true;
  return V_OK;
}

// One VP8 frame: C_OK and its picture, C_NO_FRAME for a frame not shown
// (show_frame 0), or C_ERR.
int decode_vp8(vp8::VP8Decoder& dec, const uint8_t* data, size_t n, Picture& out,
               std::string& why) {
  if (dec.decode_frame(data, n) != vp8::OK) {
    why = "a VP8 frame that cannot be decoded";
    return C_ERR;
  }
  if (!dec.show) return C_NO_FRAME;
  out.w = dec.width;
  out.h = dec.height;
  out.stride = dec.ys;
  out.cstride = dec.uvs;
  out.y = dec.cur->Y.data();
  out.u = dec.cur->U.data();
  out.v = dec.cur->V.data();
  return C_OK;
}

// Decode the video's frame `index` into v.bgr (its size in w, h): from the
// decoder's next sample where the frame lies ahead with no key frame
// between, else from the last key frame at or before it.
int read_inter(Video& v, int64_t index, int& w, int& h) {
  if (index < 0 || index >= (int64_t)v.display.size()) return V_END;
  const int64_t target = v.display[(size_t)index];
  int64_t start = -1;
  for (int64_t s = target; s >= 0; s--)
    if (v.sync[(size_t)s]) {
      start = s;
      break;
    }
  if (v.broken || target < v.next_sample || start > v.next_sample) {
    if (start < 0) {
      v.message = "no key frame at or before the frame";
      return V_ERR_PARSE;
    }
    if (!v.file) {  // the first read
      v.file.reset(new File(v.path.c_str()));
      if (v.kind == K_MPEG4) {
        std::string why;
        v.m4 = mpeg4_new(v.tag);
        mpeg4_config(v.m4, v.extradata.data(), v.extradata.size(), why);
      } else {
        v.vp8.reset(new vp8::VP8Decoder());
        v.vp8->webp = false;
      }
    }
    v.next_sample = start;
    v.broken = false;
  }
  while (v.next_sample <= target) {
    const int64_t s = v.next_sample++;
    v.sample.resize((size_t)v.sizes[(size_t)s]);
    Picture pic;
    std::string why;
    int rc;
    if (!v.file->read(v.offsets[(size_t)s], v.sample.data(), v.sample.size())) {
      rc = C_ERR;
      why = "a sample that cannot be read from the file";
    } else if (v.kind == K_MPEG4) {
      rc = mpeg4_decode(v.m4, v.sample.data(), v.sample.size(), pic, why);
    } else {
      rc = decode_vp8(*v.vp8, v.sample.data(), v.sample.size(), pic, why);
    }
    if (rc == C_UNSUPPORTED || rc == C_ERR) {
      v.broken = true;
      v.message = why;
      return rc == C_ERR ? V_ERR_PARSE : V_UNSUPPORTED;
    }
    if (s == target) {
      if (rc != C_OK) {
        v.broken = true;
        v.message = "a frame that gives no picture";
        return V_ERR_PARSE;
      }
      w = pic.w;
      h = pic.h;
      v.bgr.resize((size_t)w * h * 3);
      yuv420_to_bgr(pic, v.bgr.data());
      return V_OK;
    }
  }
  return V_ERR_PARSE;
}

}  // namespace

extern "C" {

int mgdt_video_version(void) { return 1; }

// Open a video: its index of Motion JPEG frames, or a GIF decoder. *status
// receives 0, -1 (cannot open), -3 (cannot parse) or -7 (not supported:
// mgdt_video_describe names the container and codec).
void* mgdt_video_open(const char* path, int* status) {
  File f(path);
  Video* v = new Video();
  if (!f.f) {
    *status = V_ERR_OPEN;
    return v;
  }
  uint8_t sig[12] = {0};
  f.read(0, sig, std::min<int64_t>(12, f.size));
  int rc;
  if (!memcmp(sig, "RIFF", 4) && !memcmp(sig + 8, "AVI ", 4)) {
    rc = open_avi(f, *v);
  } else if (be32(sig) == 0x1A45DFA3) {
    rc = open_mkv(f, *v);
  } else if (!memcmp(sig, "GIF87a", 6) || !memcmp(sig, "GIF89a", 6)) {
    rc = open_gif(f, *v);
  } else {
    static const char* boxes[] = {"ftyp", "moov", "mdat", "free", "wide", "skip", "pnot", nullptr};
    bool iso = false;
    for (int i = 0; boxes[i]; i++) iso |= !memcmp(sig + 4, boxes[i], 4);
    rc = iso ? open_mp4(f, *v)
             : unsupported(*v, "unknown", "", "a container other than AVI, MP4/MOV, Matroska "
                                              "and GIF");
  }
  if (rc == V_OK && (v->kind == K_MPEG4 || v->kind == K_VP8)) rc = prepare_inter(path, *v);
  if (rc == V_OK && v->kind == K_MJPEG) {
    // interlaced Motion JPEG: two fields (two JPEG images) in a frame
    if (!v->sizes.empty()) {
      auto fr = f.bytes(v->offsets[0], (size_t)std::min<int64_t>(v->sizes[0], 1 << 24));
      for (size_t i = 2; i + 4 <= fr.size(); i++)
        if (fr[i] == 0xFF && fr[i + 1] == 0xD9 && fr[i + 2] == 0xFF && fr[i + 3] == 0xD8 &&
            i + 4 < fr.size()) {
          rc = unsupported(*v, v->container, v->codec + " (two fields)",
                           "interlaced two-field Motion JPEG");
          break;
        }
    }
    for (size_t i = 0; rc == V_OK && i < v->offsets.size(); i++)
      if (v->offsets[i] < 0 || v->offsets[i] + v->sizes[i] > f.size) {
        // a frame past the file's end ends the video there, as a read fails
        v->offsets.resize(i);
        v->sizes.resize(i);
      }
  }
  *status = rc;
  return v;
}

// container, codec and message (each up to `cap` bytes, NUL-terminated)
void mgdt_video_describe(void* p, char* container, char* codec, char* message, int cap) {
  Video* v = (Video*)p;
  snprintf(container, cap, "%s", v->container.c_str());
  snprintf(codec, cap, "%s", v->codec.c_str());
  snprintf(message, cap, "%s", v->message.c_str());
}

// kind (0 Motion JPEG, 1 GIF, 2 MPEG-4 Part 2, 3 VP8), frames, fps, width
// and height
void mgdt_video_info(void* p, int* kind, int64_t* frames, double* fps, int* w, int* h) {
  Video* v = (Video*)p;
  *kind = v->kind;
  *frames = v->kind == K_GIF     ? (int64_t)v->gif_frames.size()
            : v->kind == K_MJPEG ? (int64_t)v->offsets.size()
                                 : (int64_t)v->display.size();
  *fps = v->fps;
  *w = v->w;
  *h = v->h;
}

// each Motion JPEG frame's byte offset in the file and its size
void mgdt_video_index(void* p, int64_t* offsets, int64_t* sizes) {
  Video* v = (Video*)p;
  std::copy(v->offsets.begin(), v->offsets.end(), offsets);
  std::copy(v->sizes.begin(), v->sizes.end(), sizes);
}

// the GIF's next composed frame, (h, w, 3) BGR; 0, or -8 after the last,
// or -3 for a frame that cannot be read
int mgdt_video_gif_next(void* p, uint8_t* bgr) { return gif_next(*(Video*)p, bgr); }

// Decode frame `index` of an MPEG-4 Part 2 or VP8 video: 0 and its size
// (mgdt_video_copy then gives its BGR), -3 where it cannot be read or -7
// where it uses what the port does not decode (mgdt_video_describe's
// message says what), -8 past the last frame.
int mgdt_video_read(void* p, int64_t index, int* w, int* h) {
  return read_inter(*(Video*)p, index, *w, *h);
}

// The BGR (h, w, 3) of the frame mgdt_video_read decoded.
void mgdt_video_copy(void* p, uint8_t* bgr) {
  Video* v = (Video*)p;
  std::copy(v->bgr.begin(), v->bgr.end(), bgr);
}

void mgdt_video_close(void* p) { delete (Video*)p; }

// A Motion JPEG MP4 at `rate / base` frames a second; null if the file
// cannot be made.
void* mgdt_mp4_open(const char* path, int w, int h, int64_t rate, int64_t base) {
  Writer* wr = new Writer();
  wr->f = fopen(path, "wb");
  if (!wr->f || rate <= 0 || base <= 0) {
    if (wr->f) fclose(wr->f);
    delete wr;
    return nullptr;
  }
  wr->w = w;
  wr->h = h;
  wr->rate = rate;
  wr->base = base;
  std::vector<uint8_t> o;
  box(o, "ftyp", [&] {
    put4(o, "isom");
    put32(o, 0x200);
    put4(o, "isom"); put4(o, "iso2"); put4(o, "mp41");
  });
  wr->mdat = (int64_t)o.size();
  put32(o, 1);
  put4(o, "mdat");
  put64(o, 16);  // its size, set at the end
  fwrite(o.data(), 1, o.size(), wr->f);
  return wr;
}

// Append one frame's JPEG bytes; 0, or -1 where the write failed.
int mgdt_mp4_write(void* p, const uint8_t* data, int64_t n) {
  Writer* wr = (Writer*)p;
  const int64_t at = ftello(wr->f);
  if (n <= 0 || n > 0xFFFFFFFFLL || fwrite(data, 1, (size_t)n, wr->f) != (size_t)n) return -1;
  wr->offsets.push_back(at);
  wr->sizes.push_back((uint32_t)n);
  return 0;
}

// Finish the file (the mdat's size, the moov) and close it; 0 or -1.
int mgdt_mp4_close(void* p) {
  Writer* wr = (Writer*)p;
  const int64_t end = ftello(wr->f);
  std::vector<uint8_t> size;
  put64(size, (uint64_t)(end - wr->mdat));
  std::vector<uint8_t> m = moov(*wr);
  int rc = (fwrite(m.data(), 1, m.size(), wr->f) == m.size() &&
            fseeko(wr->f, wr->mdat + 8, SEEK_SET) == 0 &&
            fwrite(size.data(), 1, 8, wr->f) == 8) ? 0 : -1;
  if (fclose(wr->f) != 0) rc = -1;
  delete wr;
  return rc;
}

}  // extern "C"
