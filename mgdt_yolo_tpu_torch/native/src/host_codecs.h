// The MPEG-4 Part 2 decoder of the video library (`host_mpeg4.cpp`, called
// from `host_video.cpp`) and the picture the video decoders give, which
// `host_yuv.h` turns to BGR as cv2's ffmpeg reading does.
#pragma once

#include <cstddef>
#include <cstdint>
#include <memory>
#include <string>
#include <vector>

namespace mgdt_codec {

enum { C_OK = 0, C_NO_FRAME = 1, C_ERR = -3, C_UNSUPPORTED = -7 };

// A decoded 4:2:0 picture: planes of `stride` / `cstride` bytes a row,
// `w` x `h` visible pixels (the chroma planes (w + 1) / 2 x (h + 1) / 2).
struct Picture {
  int w = 0, h = 0, stride = 0, cstride = 0;
  const uint8_t *y = nullptr, *u = nullptr, *v = nullptr;
};

// An MPEG-4 Part 2 (ISO/IEC 14496-2) Simple Profile decoder.
struct Mpeg4Decoder;
// `tag` is the container's fourcc (an AVI's compression), which names the
// encoder where the stream's user data does not.
Mpeg4Decoder* mpeg4_new(const std::string& tag);
void mpeg4_free(Mpeg4Decoder* d);
// The decoder configuration (VOS, VO, VOL and user data) from the
// container's header; C_OK, C_ERR or C_UNSUPPORTED (with `why`).
int mpeg4_config(Mpeg4Decoder* d, const uint8_t* data, size_t n, std::string& why);
// Decode one sample: C_OK and the picture, C_NO_FRAME for a sample that
// gives no picture (a VOP that is not coded), C_ERR or C_UNSUPPORTED.
int mpeg4_decode(Mpeg4Decoder* d, const uint8_t* data, size_t n, Picture& out, std::string& why);
// The first VOP of a sample (its header only): 1 where it is coded, 0
// where not, -1 where the sample holds none; `type` its vop_coding_type
// (0 I, 1 P, 2 B, 3 S).
int mpeg4_sample_kind(const uint8_t* data, size_t n, int time_bits, int& type);
int mpeg4_time_bits(const Mpeg4Decoder* d);
int mpeg4_width(const Mpeg4Decoder* d);
int mpeg4_height(const Mpeg4Decoder* d);

}  // namespace mgdt_codec
