// VP8 (RFC 6386): the decoder of the WebP images' lossy frames
// (`host_webp.cpp`, a key frame each) and of the VP8 videos' frames
// (`host_video.cpp`, key and inter frames). Written from the
// specification; linked against no VP8 library. One source, compiled by
// both libraries (utils/build.py: HOST_LOADER_SOURCES and HOST_VIDEO's).
//
// * Frame header: key frames (size, colour space, clamping), segments with
//   their quantiser and filter values and map, the loop filter with its
//   reference and mode deltas, 1-8 token partitions, quantisers, the
//   coefficient probability updates, and for inter frames the golden and
//   altref refresh and copy flags, their sign bias, refresh_entropy_probs
//   (probabilities kept for the next frame or restored after this one),
//   refresh_last, and the intra, reference, mode and motion vector
//   probabilities. Segments, loop filter deltas and probabilities persist
//   from frame to frame, as the specification has them, until a key frame
//   resets them.
// * Macroblocks: intra modes (contextual in key frames, fixed probabilities
//   in inter frames); inter macroblocks on the last, golden or altref frame,
//   the near, nearest and best vectors from the neighbours (with sign bias),
//   clamped to the frame, new vectors, and split vectors (16x8, 8x16, 8x8,
//   4x4) with their left/above contexts; the boolean decoder, tokens,
//   dequantisation, the inverse WHT and DCT.
// * Prediction: the intra predictors on the unfiltered picture; the six-tap
//   sub-pixel filters (version 0) or bilinear ones (versions 1-3; version 3
//   full-pixel chroma) over references whose samples repeat past their
//   macroblock-aligned edges; chroma vectors as the luma vector, or the
//   rounded mean of four for 4x4 splits.
// * The simple and normal loop filters, their strengths by segment,
//   reference and mode, and the key and inter frames' edge variance
//   thresholds.
// * A WebP image keeps libwebp's one difference for a lone key frame (a
//   segment header without values is absolute); frames that are not shown
//   (show_frame 0) are decoded and give no picture.

#pragma once

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <vector>

namespace {
namespace vp8 {

constexpr int OK = 0;
constexpr int ERR = -3;  // MGDT_ERR_DECODE

inline uint32_t le16(const uint8_t* p) { return p[0] | (p[1] << 8); }
inline uint32_t le24(const uint8_t* p) { return p[0] | (p[1] << 8) | (p[2] << 16); }

static const uint8_t kBModesProba[10][10][9] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112,
    152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103,
    56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173,
    121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26,
    170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226,
    81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148,
    72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128,
    41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157,
    65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7,
    87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194,
    66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205,
    43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171,
    56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64,
    34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31,
    68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124,
    62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111,
    60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114,
    40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154,
    61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71,
    142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221,
    51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229,
    67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154,
    40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183,
    46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37,
    65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223,
    87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226,
    64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213,
    30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255,
    31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51,
    88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192,
    55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82,
    95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1,
    57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85,
    41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6,
    101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43,
    117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192,
    69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171,
    62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1,
    63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16,
    86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128,
    58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218,
    51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128,
    22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197,
    56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28,
    85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246,
    35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45,
    85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85,
    56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138,
    101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20,
    138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163,
    112, 19, 12, 61, 195, 128, 48, 4, 24,
};
static const uint8_t kCoeffsProba0[4][8][3][11] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128,
    106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128,
    181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128,
    1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128,
    77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128,
    170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
    1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128,
    102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128,
    177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62,
    131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
    1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128,
    81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128,
    99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
    1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128,
    44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128,
    94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
    1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128,
    35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128,
    121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128,
    1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128,
    175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128,
    1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128,
    155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128,
    201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
    1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128,
    141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128,
    213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255,
    126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128,
    1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128,
    39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128,
    124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128,
    1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128,
    28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128,
    123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128,
    1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128,
    47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
    141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};
static const uint8_t kCoeffsUpdateProba[4][8][3][11] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
    250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};
static const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};
static const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};

// inter frames' defaults and trees (RFC 6386 sections 16-17)
static const uint8_t kYModeProbaInter0[4] = {112, 86, 140, 37};
static const uint8_t kUVModeProbaInter0[3] = {162, 101, 204};
static const uint8_t kBModesProbaInter[9] = {120, 90, 79, 133, 87, 85, 80, 111, 151};
static const uint8_t kMVProba0[2][19] = {
    {162, 128, 225, 146, 172, 147, 214, 39, 156, 128, 129, 132, 75, 145, 178, 206, 239, 254, 254},
    {164, 128, 204, 170, 119, 235, 140, 230, 228, 128, 130, 130, 74, 148, 180, 203, 236, 254, 254}};
static const uint8_t kMVUpdateProba[2][19] = {
    {237, 246, 253, 253, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 250, 250, 252, 254, 254},
    {231, 243, 245, 253, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 251, 251, 254, 254, 254}};
static const uint8_t kModeContexts[6][4] = {{7, 1, 1, 143},    {14, 18, 14, 107}, {135, 64, 57, 68},
                                            {60, 56, 128, 65}, {159, 134, 128, 34}, {234, 188, 128, 28}};
static const uint8_t kSplitProba[3] = {110, 111, 150};
static const uint8_t kSubMVProba[5][3] = {
    {147, 136, 18}, {106, 145, 1}, {179, 121, 1}, {223, 1, 34}, {208, 1, 1}};
// each 4x4 block's partition, by split: 16x8, 8x16, 8x8, 4x4, none
static const uint8_t kSplits[5][16] = {{0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1},
                                       {0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1},
                                       {0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 3, 3, 2, 2, 3, 3},
                                       {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
                                       {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0}};
static const uint8_t kSplitCount[4] = {2, 2, 4, 16};
static const uint8_t kSplitFirst[4][16] = {
    {0, 8}, {0, 2}, {0, 2, 8, 10}, {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15}};
// six-tap sub-pixel filters by eighth (1-7); taps 1 and 4 subtract
static const uint8_t kSubpel6[7][6] = {{0, 6, 123, 12, 1, 0},  {2, 11, 108, 36, 8, 1},
                                       {0, 9, 93, 50, 6, 0},   {3, 16, 77, 77, 16, 3},
                                       {0, 6, 50, 93, 9, 0},   {1, 8, 36, 108, 11, 2},
                                       {0, 1, 12, 123, 6, 0}};

// The boolean decoder, in the reference decoder's arithmetic: `range` holds
// the range less one, `bits` the bits buffered past the next byte, and
// `eof` is set the first time a bit is needed past the end of the data.
struct BoolDec {
  const uint8_t *buf = nullptr, *end = nullptr;
  uint64_t value = 0;
  uint32_t range = 254;
  int bits = -8;
  bool eof = false;
  void init(const uint8_t* s, size_t n) {
    buf = s;
    end = s + n;
    value = 0;
    range = 254;
    bits = -8;
    eof = false;
    load();
  }
  void load() {
    if (end - buf >= 8) {
      uint64_t v = 0;
      for (int k = 0; k < 7; k++) v = (v << 8) | buf[k];
      buf += 7;
      value = (value << 56) | v;
      bits += 56;
    } else if (buf < end) {
      value = (value << 8) | *buf++;
      bits += 8;
    } else if (!eof) {
      value <<= 8;
      bits += 8;
      eof = true;
    } else {
      bits = 0;
    }
  }
  inline int bit(int prob) {
    uint32_t r = range;
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = (r * (uint32_t)prob) >> 8;
    const uint32_t v = (uint32_t)(value >> pos);
    int b = 0;
    if (v > split) {
      r -= split;
      value -= (uint64_t)(split + 1) << pos;
      b = 1;
    } else {
      r = split + 1;
    }
    const int shift = 7 ^ (31 - __builtin_clz(r));
    r <<= shift;
    bits -= shift;
    range = r - 1;
    return b;
  }
  int literal(int n) {
    int v = 0;
    while (n-- > 0) v |= bit(0x80) << n;
    return v;
  }
  int signed_literal(int n) {
    const int v = literal(n);
    return bit(0x80) ? -v : v;
  }
};

// intra modes, in this order throughout (the probability table's)
enum { B_DC, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU };
static const int8_t kYModesIntra4[18] = {-B_DC, 1, -B_TM, 2, -B_VE, 3, 4, 6, -B_HE, 5,
                                         -B_RD, -B_VR, -B_LD, 7, -B_VL, 8, -B_HD, -B_HU};
static const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
static const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
static const uint8_t kCat3[] = {173, 148, 140, 0};
static const uint8_t kCat4[] = {176, 155, 140, 135, 0};
static const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
static const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
static const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};

constexpr int BPS = 32;  // the reconstruction workspace's stride
constexpr int Y_OFF = BPS * 1 + 8, U_OFF = Y_OFF + BPS * 16 + BPS, V_OFF = U_OFF + 16;
constexpr int WORK_SIZE = BPS * 17 + BPS * 9;
static const int kScan[16] = {0,           4,           8,           12,
                              4 * BPS,     4 + 4 * BPS, 8 + 4 * BPS, 12 + 4 * BPS,
                              8 * BPS,     4 + 8 * BPS, 8 + 8 * BPS, 12 + 8 * BPS,
                              12 * BPS,    4 + 12 * BPS, 8 + 12 * BPS, 12 + 12 * BPS};

static inline uint8_t clip8(int v) { return v < 0 ? 0 : v > 255 ? 255 : (uint8_t)v; }

// Inverse transforms, adding into the prediction at `dst` (stride BPS), as
// the reference decoder runs them on x86: the full transform in 16-bit
// lanes (SSE2: its sums wrap, which only a corrupt stream reaches), the
// DC-only and three-coefficient ones in int. All agree on a valid stream.
static inline int wrap16(int v) { return (int16_t)(uint16_t)v; }
static inline int mulhi(int a, int k) { return (a * k) >> 16; }
static void idct_add(const int16_t* in, uint8_t* dst) {
  int tmp[16];
  for (int i = 0; i < 4; i++) {  // vertical pass
    const int a = in[i] + in[8 + i];
    const int b = in[i] - in[8 + i];
    const int c = in[4 + i] - in[12 + i] + mulhi(in[4 + i], -30068) - mulhi(in[12 + i], 20091);
    const int d = in[4 + i] + in[12 + i] + mulhi(in[4 + i], 20091) + mulhi(in[12 + i], -30068);
    tmp[4 * i + 0] = wrap16(a + d);
    tmp[4 * i + 1] = wrap16(b + c);
    tmp[4 * i + 2] = wrap16(b - c);
    tmp[4 * i + 3] = wrap16(a - d);
  }
  for (int i = 0; i < 4; i++) {  // horizontal pass
    const int dc = tmp[i] + 4;
    const int a = dc + tmp[8 + i];
    const int b = dc - tmp[8 + i];
    const int c = tmp[4 + i] - tmp[12 + i] + mulhi(tmp[4 + i], -30068) - mulhi(tmp[12 + i], 20091);
    const int d = tmp[4 + i] + tmp[12 + i] + mulhi(tmp[4 + i], 20091) + mulhi(tmp[12 + i], -30068);
    uint8_t* r = dst + i * BPS;
    r[0] = clip8(r[0] + (wrap16(a + d) >> 3));
    r[1] = clip8(r[1] + (wrap16(b + c) >> 3));
    r[2] = clip8(r[2] + (wrap16(b - c) >> 3));
    r[3] = clip8(r[3] + (wrap16(a - d) >> 3));
  }
}
static inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
static inline int mul2(int a) { return (a * 35468) >> 16; }
static void idct_ac3_add(const int16_t* in, uint8_t* dst) {  // in[0], in[1], in[4] only
  const int a = in[0] + 4;
  const int c4 = mul2(in[4]), d4 = mul1(in[4]);
  const int c1 = mul2(in[1]), d1 = mul1(in[1]);
  const int rows[4] = {a + d4, a + c4, a - c4, a - d4};
  for (int y = 0; y < 4; y++) {
    uint8_t* r = dst + y * BPS;
    r[0] = clip8(r[0] + ((rows[y] + d1) >> 3));
    r[1] = clip8(r[1] + ((rows[y] + c1) >> 3));
    r[2] = clip8(r[2] + ((rows[y] - c1) >> 3));
    r[3] = clip8(r[3] + ((rows[y] - d1) >> 3));
  }
}
static void idct_dc_add(const int16_t* in, uint8_t* dst) {
  const int dc = (in[0] + 4) >> 3;
  for (int y = 0; y < 4; y++)
    for (int x = 0; x < 4; x++) dst[x + y * BPS] = clip8(dst[x + y * BPS] + dc);
}
// by a block's code: 3 more than three coefficients, 2 two or three, 1 the DC
static inline void transform_add(uint32_t code, const int16_t* in, uint8_t* dst) {
  if (code == 3) idct_add(in, dst);
  else if (code == 2) idct_ac3_add(in, dst);
  else if (code == 1) idct_dc_add(in, dst);
}
static void iwht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; i++) {
    const int a0 = in[0 + i] + in[12 + i];
    const int a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i];
    const int a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; i++) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4];
    const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
    const int a3 = dc - tmp[3 + i * 4];
    out[0] = (int16_t)((a0 + a1) >> 3);
    out[16] = (int16_t)((a3 + a2) >> 3);
    out[32] = (int16_t)((a0 - a1) >> 3);
    out[48] = (int16_t)((a3 - a2) >> 3);
    out += 64;
  }
}

// intra predictors on the workspace (the row above and the column to the
// left of `dst` hold the edge)
#define AVG3(a, b, c) ((uint8_t)(((a) + 2 * (b) + (c) + 2) >> 2))
#define AVG2(a, b) ((uint8_t)(((a) + (b) + 1) >> 1))
#define DST(x, y) dst[(x) + (y) * BPS]
static void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  const int tl = top[-1];
  for (int y = 0; y < size; y++, dst += BPS)
    for (int x = 0; x < size; x++) dst[x] = clip8(dst[-1] + top[x] - tl);
}
static void fill(uint8_t* dst, int size, int v) {
  for (int y = 0; y < size; y++) memset(dst + y * BPS, v, size);
}
static void predict4(int mode, uint8_t* dst) {
  const uint8_t* top = dst - BPS;
  const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS];
  const int X = top[-1], A = top[0], B = top[1], C = top[2], D = top[3];
  const int E = top[4], F = top[5], G = top[6], H = top[7];
  switch (mode) {
    case B_DC: {
      int dc = 4;
      for (int i = 0; i < 4; i++) dc += top[i] + dst[-1 + i * BPS];
      fill(dst, 4, dc >> 3);
      break;
    }
    case B_TM: true_motion(dst, 4); break;
    case B_VE: {
      const uint8_t v[4] = {AVG3(X, A, B), AVG3(A, B, C), AVG3(B, C, D), AVG3(C, D, E)};
      for (int i = 0; i < 4; i++) memcpy(dst + i * BPS, v, 4);
      break;
    }
    case B_HE:
      memset(dst, AVG3(X, I, J), 4);
      memset(dst + BPS, AVG3(I, J, K), 4);
      memset(dst + 2 * BPS, AVG3(J, K, L), 4);
      memset(dst + 3 * BPS, AVG3(K, L, L), 4);
      break;
    case B_RD:
      DST(0, 3) = AVG3(J, K, L);
      DST(1, 3) = DST(0, 2) = AVG3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = AVG3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = AVG3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = AVG3(B, A, X);
      DST(3, 1) = DST(2, 0) = AVG3(C, B, A);
      DST(3, 0) = AVG3(D, C, B);
      break;
    case B_LD:
      DST(0, 0) = AVG3(A, B, C);
      DST(1, 0) = DST(0, 1) = AVG3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = AVG3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = AVG3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = AVG3(E, F, G);
      DST(3, 2) = DST(2, 3) = AVG3(F, G, H);
      DST(3, 3) = AVG3(G, H, H);
      break;
    case B_VR:
      DST(0, 0) = DST(1, 2) = AVG2(X, A);
      DST(1, 0) = DST(2, 2) = AVG2(A, B);
      DST(2, 0) = DST(3, 2) = AVG2(B, C);
      DST(3, 0) = AVG2(C, D);
      DST(0, 3) = AVG3(K, J, I);
      DST(0, 2) = AVG3(J, I, X);
      DST(0, 1) = DST(1, 3) = AVG3(I, X, A);
      DST(1, 1) = DST(2, 3) = AVG3(X, A, B);
      DST(2, 1) = DST(3, 3) = AVG3(A, B, C);
      DST(3, 1) = AVG3(B, C, D);
      break;
    case B_VL:
      DST(0, 0) = AVG2(A, B);
      DST(1, 0) = DST(0, 2) = AVG2(B, C);
      DST(2, 0) = DST(1, 2) = AVG2(C, D);
      DST(3, 0) = DST(2, 2) = AVG2(D, E);
      DST(0, 1) = AVG3(A, B, C);
      DST(1, 1) = DST(0, 3) = AVG3(B, C, D);
      DST(2, 1) = DST(1, 3) = AVG3(C, D, E);
      DST(3, 1) = DST(2, 3) = AVG3(D, E, F);
      DST(3, 2) = AVG3(E, F, G);
      DST(3, 3) = AVG3(F, G, H);
      break;
    case B_HD:
      DST(0, 0) = DST(2, 1) = AVG2(I, X);
      DST(0, 1) = DST(2, 2) = AVG2(J, I);
      DST(0, 2) = DST(2, 3) = AVG2(K, J);
      DST(0, 3) = AVG2(L, K);
      DST(3, 0) = AVG3(A, B, C);
      DST(2, 0) = AVG3(X, A, B);
      DST(1, 0) = DST(3, 1) = AVG3(I, X, A);
      DST(1, 1) = DST(3, 2) = AVG3(J, I, X);
      DST(1, 2) = DST(3, 3) = AVG3(K, J, I);
      DST(1, 3) = AVG3(L, K, J);
      break;
    default:  // B_HU
      DST(0, 0) = AVG2(I, J);
      DST(2, 0) = DST(0, 1) = AVG2(J, K);
      DST(2, 1) = DST(0, 2) = AVG2(K, L);
      DST(1, 0) = AVG3(I, J, K);
      DST(3, 0) = DST(1, 1) = AVG3(J, K, L);
      DST(3, 1) = DST(1, 2) = AVG3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = L;
      break;
  }
}
#undef DST
#undef AVG2
#undef AVG3

// 16x16 luma or 8x8 chroma prediction; DC falls back where the macroblock
// has no row above or column to the left
static void predict_block(int mode, uint8_t* dst, int size, int mb_x, int mb_y) {
  const int lg = size == 16 ? 4 : 3;
  switch (mode) {
    case B_DC: {
      int dc = 0;
      if (mb_x > 0 && mb_y > 0) {
        for (int j = 0; j < size; j++) dc += dst[-1 + j * BPS] + dst[j - BPS];
        dc = (dc + size) >> (lg + 1);
      } else if (mb_y > 0) {
        for (int j = 0; j < size; j++) dc += dst[j - BPS];
        dc = (dc + (size >> 1)) >> lg;
      } else if (mb_x > 0) {
        for (int j = 0; j < size; j++) dc += dst[-1 + j * BPS];
        dc = (dc + (size >> 1)) >> lg;
      } else {
        dc = 0x80;
      }
      fill(dst, size, dc);
      break;
    }
    case B_TM: true_motion(dst, size); break;
    case B_VE:
      for (int j = 0; j < size; j++) memcpy(dst + j * BPS, dst - BPS, size);
      break;
    default:  // B_HE
      for (int j = 0; j < size; j++) memset(dst + j * BPS, dst[-1 + j * BPS], size);
      break;
  }
}

// loop filters (RFC 6386 section 15), on a plane of stride `s`
static inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
static inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }
static inline void filter2(uint8_t* p, int s) {
  const int p1 = p[-2 * s], p0 = p[-s], q0 = p[0], q1 = p[s];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
  p[-s] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}
static inline void filter4(uint8_t* p, int s) {
  const int p1 = p[-2 * s], p0 = p[-s], q0 = p[0], q1 = p[s];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3), a3 = (a1 + 1) >> 1;
  p[-2 * s] = clip8(p1 + a3);
  p[-s] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
  p[s] = clip8(q1 - a3);
}
static inline void filter6(uint8_t* p, int s) {
  const int p2 = p[-3 * s], p1 = p[-2 * s], p0 = p[-s], q0 = p[0], q1 = p[s], q2 = p[2 * s];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7, a2 = (18 * a + 63) >> 7, a3 = (9 * a + 63) >> 7;
  p[-3 * s] = clip8(p2 + a3);
  p[-2 * s] = clip8(p1 + a2);
  p[-s] = clip8(p0 + a1);
  p[0] = clip8(q0 - a1);
  p[s] = clip8(q1 - a2);
  p[2 * s] = clip8(q2 - a3);
}
static inline bool hev(const uint8_t* p, int s, int t) {
  return std::abs(p[-2 * s] - p[-s]) > t || std::abs(p[s] - p[0]) > t;
}
static inline bool needs_filter(const uint8_t* p, int s, int t) {
  return 4 * std::abs(p[-s] - p[0]) + std::abs(p[-2 * s] - p[s]) <= t;
}
static inline bool needs_filter2(const uint8_t* p, int s, int t, int it) {
  const int p3 = p[-4 * s], p2 = p[-3 * s], p1 = p[-2 * s], p0 = p[-s];
  const int q0 = p[0], q1 = p[s], q2 = p[2 * s], q3 = p[3 * s];
  if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it && std::abs(p1 - p0) <= it &&
         std::abs(q3 - q2) <= it && std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}
// `hs` steps across the edge, `vs` along it
static void simple_edge(uint8_t* p, int hs, int vs, int thresh) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < 16; i++, p += vs)
    if (needs_filter(p, hs, t2)) filter2(p, hs);
}
static void edge(uint8_t* p, int hs, int vs, int n, int thresh, int ithresh, int hev_t, bool mb) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < n; i++, p += vs) {
    if (!needs_filter2(p, hs, t2, ithresh)) continue;
    if (hev(p, hs, hev_t)) filter2(p, hs);
    else if (mb) filter6(p, hs);
    else filter4(p, hs);
  }
}

struct FInfo {
  int limit = 0, ilevel = 0, hev = 0;
  bool inner = false;
};

enum { REF_INTRA = 0, REF_LAST = 1, REF_GOLDEN = 2, REF_ALTREF = 3 };
enum { SPLIT_16x8 = 0, SPLIT_8x16 = 1, SPLIT_8x8 = 2, SPLIT_4x4 = 3, SPLIT_NONE = 4 };
// an inter macroblock's mode, which is also its loop filter mode delta's
// index (B_PRED takes delta 0)
enum { MODE_INTRA = 0, MODE_ZERO = 1, MODE_MV = 2, MODE_SPLIT = 3 };

struct MV {
  int16_t x = 0, y = 0;  // quarter samples
  bool operator==(const MV& o) const { return x == o.x && y == o.y; }
  bool zero() const { return !x && !y; }
};

// what later macroblocks read of a macroblock: its reference, mode, split
// and vectors (bmv by partition; bmv[0] the vector where it has one)
struct MBInfo {
  uint8_t ref = REF_INTRA, mode = MODE_INTRA, part = SPLIT_NONE;
  MV mv, bmv[16];
};

struct MBData {
  int16_t coeffs[384];
  uint8_t imodes[16];
  uint8_t is_i4x4, uvmode, segment, skip, has_y2;
  uint32_t nz_y, nz_uv;
};

struct Planes {
  std::vector<uint8_t> Y, U, V;
};

struct Probs {
  uint8_t coeff[4][8][3][11];
  uint8_t ymode[4], uvmode[3], mv[2][19];
};

struct VP8Decoder {
  bool webp = true;  // a WebP image: one key frame, libwebp's defaults
  int width = 0, height = 0, mb_w = 0, mb_h = 0;
  bool keyframe = true, show = true, have_refs = false;
  int version = 0;
  BoolDec br, parts[8];
  int num_parts = 1;
  // segment header (persistent)
  bool use_segment = false, update_map = false, absolute_delta = true;
  int seg_quant[4] = {0}, seg_filter[4] = {0};
  uint8_t seg_proba[3] = {255, 255, 255};
  // filter header (the deltas persistent)
  bool simple = false;
  int level = 0, sharpness = 0;
  bool use_lf_delta = false;
  int ref_lf_delta[4] = {0}, mode_lf_delta[4] = {0};
  int filter_type = 0;
  // quantisers: [segment] {y1 dc, y1 ac, y2 dc, y2 ac, uv dc, uv ac}
  int dq[4][6];
  Probs prob, saved;
  bool refresh_probs = true, update_last = true;
  bool use_skip = false;
  int skip_p = 0, prob_intra = 0, prob_last = 0, prob_golden = 0;
  int sign_bias[4] = {0};
  int golden_src = 0, altref_src = 0;  // -1 kept, else the frame it becomes (0 this one)
  // per-column state
  std::vector<uint8_t> intra_t, nz_t, nz_dc_t;
  uint8_t intra_l[4], nz_l = 0, nz_dc_l = 0;
  std::vector<MBData> row;
  std::vector<FInfo> finfo;  // every macroblock, for the filter pass
  std::vector<MBInfo> mbi;   // (mb_h + 1) x (mb_w + 1): a border row above, a column left
  std::vector<uint8_t> segmap;
  std::vector<uint8_t> top_y, top_u, top_v;  // unfiltered bottom rows, per column
  uint8_t work[WORK_SIZE];
  // the frame being decoded and the references, macroblock-aligned planes
  std::shared_ptr<Planes> cur, ref[4];
  uint8_t *Y = nullptr, *U = nullptr, *V = nullptr;
  int ys = 0, uvs = 0;

  MBInfo& info(int mb_x, int mb_y) { return mbi[(size_t)(mb_y + 1) * (mb_w + 1) + mb_x + 1]; }
  void resize(int w, int h);
  int headers(const uint8_t* d, size_t n);
  void parse_modes(int mb_x, int mb_y);
  void parse_inter(MBInfo& m, int mb_x, int mb_y);
  int get_coeffs(BoolDec& b, int type, int ctx, int dqdc, int dqac, int n, int16_t* out);
  bool parse_residuals(int mb_x, BoolDec& b);
  FInfo strength(int segment, int ref, int mode) const;
  void inter_predict(const MBInfo& m, int mb_x, int mb_y, uint8_t* y, uint8_t* u, uint8_t* v);
  void reconstruct(int mb_y);
  void filter_frame();
  int decode_frame(const uint8_t* d, size_t n);
};

void VP8Decoder::resize(int w, int h) {
  width = w;
  height = h;
  mb_w = (w + 15) >> 4;
  mb_h = (h + 15) >> 4;
  ys = 16 * mb_w;
  uvs = 8 * mb_w;
  mbi.assign((size_t)(mb_w + 1) * (mb_h + 1), MBInfo());
  segmap.assign((size_t)mb_w * mb_h, 0);
  row.resize(mb_w);
  finfo.resize((size_t)mb_w * mb_h);
  for (auto& r : ref) r.reset();
  have_refs = false;
}

static int read_mv(BoolDec& b, const uint8_t* p) {
  int x = 0;
  if (b.bit(p[0])) {
    for (int i = 0; i < 3; i++) x += b.bit(p[9 + i]) << i;
    for (int i = 9; i > 3; i--) x += b.bit(p[9 + i]) << i;
    if (!(x & 0xFFF0) || b.bit(p[12])) x += 8;
  } else {
    const uint8_t* ps = p + 2;
    int bit = b.bit(*ps);
    ps += 1 + 3 * bit;
    x += 4 * bit;
    bit = b.bit(*ps);
    ps += 1 + bit;
    x += 2 * bit;
    x += b.bit(*ps);
  }
  return (x && b.bit(p[1])) ? -x : x;
}

int VP8Decoder::headers(const uint8_t* d, size_t n) {
  if (n < 3) return ERR;
  const uint32_t tag = le24(d);
  keyframe = !(tag & 1);
  version = (tag >> 1) & 7;
  show = (tag >> 4) & 1;
  const uint32_t part0 = tag >> 5;
  if (version > 3 || (webp && (!keyframe || !show))) return ERR;
  d += 3;
  n -= 3;
  if (keyframe) {
    if (n < 7 || d[0] != 0x9d || d[1] != 0x01 || d[2] != 0x2a) return ERR;
    const int w = le16(d + 3) & 0x3fff, h = le16(d + 5) & 0x3fff;
    if (!w || !h) return ERR;
    if (w != width || h != height || mbi.empty()) resize(w, h);
    d += 7;
    n -= 7;
    // a key frame resets what persists
    memcpy(prob.coeff, kCoeffsProba0, sizeof prob.coeff);
    memcpy(prob.ymode, kYModeProbaInter0, sizeof prob.ymode);
    memcpy(prob.uvmode, kUVModeProbaInter0, sizeof prob.uvmode);
    memcpy(prob.mv, kMVProba0, sizeof prob.mv);
    use_segment = update_map = false;
    absolute_delta = webp;
    memset(seg_quant, 0, sizeof seg_quant);
    memset(seg_filter, 0, sizeof seg_filter);
    memset(ref_lf_delta, 0, sizeof ref_lf_delta);
    memset(mode_lf_delta, 0, sizeof mode_lf_delta);
    std::fill(segmap.begin(), segmap.end(), 0);
  } else if (!have_refs) {
    return ERR;  // an inter frame with no key frame before it
  }
  if (part0 > n) return ERR;
  br.init(d, part0);
  d += part0;
  n -= part0;
  if (keyframe) {
    br.bit(0x80);  // colour space
    br.bit(0x80);  // clamping type
  }
  // segments
  use_segment = br.bit(0x80);
  update_map = false;
  if (use_segment) {
    update_map = br.bit(0x80);
    if (br.bit(0x80)) {
      absolute_delta = br.bit(0x80);
      for (int s = 0; s < 4; s++) seg_quant[s] = br.bit(0x80) ? br.signed_literal(7) : 0;
      for (int s = 0; s < 4; s++) seg_filter[s] = br.bit(0x80) ? br.signed_literal(6) : 0;
    }
    if (update_map)
      for (int s = 0; s < 3; s++) seg_proba[s] = br.bit(0x80) ? (uint8_t)br.literal(8) : 255;
  }
  if (br.eof) return ERR;
  // loop filter
  simple = br.bit(0x80);
  level = br.literal(6);
  sharpness = br.literal(3);
  use_lf_delta = br.bit(0x80);
  if (use_lf_delta && br.bit(0x80)) {
    for (int i = 0; i < 4; i++)
      if (br.bit(0x80)) ref_lf_delta[i] = br.signed_literal(6);
    for (int i = 0; i < 4; i++)
      if (br.bit(0x80)) mode_lf_delta[i] = br.signed_literal(6);
  }
  filter_type = level == 0 ? 0 : simple ? 1 : 2;
  if (br.eof) return ERR;
  // token partitions: all but the last sized; the last runs to the end
  num_parts = 1 << br.literal(2);
  const size_t last = num_parts - 1;
  if (n < 3 * last) return ERR;
  const uint8_t* start = d + 3 * last;
  size_t left = n - 3 * last;
  for (size_t p = 0; p < last; p++) {
    size_t psize = le24(d + 3 * p);
    if (psize > left) psize = left;
    parts[p].init(start, psize);
    start += psize;
    left -= psize;
  }
  parts[last].init(start, left);
  if (!(start < d + n)) return ERR;
  // quantisers
  const int base_q = br.literal(7);
  int delta[5];
  for (int i = 0; i < 5; i++) delta[i] = br.bit(0x80) ? br.signed_literal(4) : 0;
  auto clip = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
  for (int s = 0; s < 4; s++) {
    int q = base_q;
    if (use_segment) q = seg_quant[s] + (absolute_delta ? 0 : base_q);
    else if (s > 0) {
      memcpy(dq[s], dq[0], sizeof(dq[0]));
      continue;
    }
    dq[s][0] = kDcTable[clip(q + delta[0], 127)];
    dq[s][1] = kAcTable[clip(q, 127)];
    dq[s][2] = kDcTable[clip(q + delta[1], 127)] * 2;
    dq[s][3] = std::max(8, (kAcTable[clip(q + delta[2], 127)] * 101581) >> 16);
    dq[s][4] = kDcTable[clip(q + delta[3], 117)];
    dq[s][5] = kAcTable[clip(q + delta[4], 127)];
  }
  // references (inter frames): which frames the golden and altref become
  golden_src = altref_src = 0;
  if (!keyframe) {
    const bool refresh_golden = br.bit(0x80), refresh_altref = br.bit(0x80);
    if (!refresh_golden) {
      const int c = br.literal(2);
      golden_src = c == 1 ? REF_LAST : c == 2 ? REF_ALTREF : -1;
    }
    if (!refresh_altref) {
      const int c = br.literal(2);
      altref_src = c == 1 ? REF_LAST : c == 2 ? REF_GOLDEN : -1;
    }
    sign_bias[REF_GOLDEN] = br.bit(0x80);
    sign_bias[REF_ALTREF] = br.bit(0x80);
  }
  refresh_probs = br.bit(0x80);
  if (!refresh_probs) saved = prob;  // restored after this frame
  update_last = keyframe || br.bit(0x80);
  for (int t = 0; t < 4; t++)
    for (int b = 0; b < 8; b++)
      for (int c = 0; c < 3; c++)
        for (int p = 0; p < 11; p++)
          if (br.bit(kCoeffsUpdateProba[t][b][c][p])) prob.coeff[t][b][c][p] = (uint8_t)br.literal(8);
  use_skip = br.bit(0x80);
  if (use_skip) skip_p = br.literal(8);
  if (!keyframe) {
    prob_intra = br.literal(8);
    prob_last = br.literal(8);
    prob_golden = br.literal(8);
    if (br.bit(0x80))
      for (int i = 0; i < 4; i++) prob.ymode[i] = (uint8_t)br.literal(8);
    if (br.bit(0x80))
      for (int i = 0; i < 3; i++) prob.uvmode[i] = (uint8_t)br.literal(8);
    for (int i = 0; i < 2; i++)
      for (int j = 0; j < 19; j++)
        if (br.bit(kMVUpdateProba[i][j])) {
          const int v = br.literal(7) << 1;
          prob.mv[i][j] = (uint8_t)(v ? v : 1);
        }
  }
  return br.eof ? ERR : OK;
}

// the loop filter's strength for a macroblock of `segment`, on reference
// `ref`, of mode `mode` (0 B_PRED, 1-3 the inter modes, -1 the 16x16 intra)
FInfo VP8Decoder::strength(int segment, int rf, int mode) const {
  FInfo f;
  int lv = level;
  if (use_segment) lv = seg_filter[segment] + (absolute_delta ? 0 : level);
  if (use_lf_delta) {
    lv += ref_lf_delta[rf];
    if (mode >= 0) lv += mode_lf_delta[mode];
  }
  lv = lv < 0 ? 0 : lv > 63 ? 63 : lv;
  if (lv > 0) {
    int il = lv;
    if (sharpness > 0) {
      il >>= sharpness > 4 ? 2 : 1;
      if (il > 9 - sharpness) il = 9 - sharpness;
    }
    if (il < 1) il = 1;
    f.ilevel = il;
    f.limit = 2 * lv + il;
    f.hev = keyframe ? (lv >= 40 ? 2 : lv >= 15 ? 1 : 0)
                     : (lv >= 40 ? 3 : lv >= 20 ? 2 : lv >= 15 ? 1 : 0);
  }
  return f;
}

void VP8Decoder::parse_modes(int mb_x, int mb_y) {
  MBData& m = row[mb_x];
  MBInfo& inf = info(mb_x, mb_y);
  uint8_t* top = &intra_t[4 * mb_x];
  uint8_t& seg = segmap[(size_t)mb_y * mb_w + mb_x];
  if (update_map) seg = !br.bit(seg_proba[0]) ? br.bit(seg_proba[1]) : br.bit(seg_proba[2]) + 2;
  m.segment = use_segment ? seg : 0;
  m.skip = use_skip ? br.bit(skip_p) : 0;
  inf = MBInfo();
  if (!keyframe && br.bit(prob_intra)) {
    m.is_i4x4 = 0;
    m.uvmode = B_DC;
    parse_inter(inf, mb_x, mb_y);
    m.has_y2 = inf.mode != MODE_SPLIT;
    return;
  }
  if (keyframe) {
    m.is_i4x4 = !br.bit(145);
    if (!m.is_i4x4) {
      const int ymode = br.bit(156) ? (br.bit(128) ? B_TM : B_HE) : (br.bit(163) ? B_VE : B_DC);
      m.imodes[0] = ymode;
      memset(top, ymode, 4);
      memset(intra_l, ymode, 4);
    } else {
      uint8_t* modes = m.imodes;
      for (int y = 0; y < 4; y++) {
        int ymode = intra_l[y];
        for (int x = 0; x < 4; x++) {
          const uint8_t* p = kBModesProba[top[x]][ymode];
          int i = kYModesIntra4[br.bit(p[0])];
          while (i > 0) i = kYModesIntra4[2 * i + br.bit(p[i])];
          ymode = -i;
          top[x] = ymode;
        }
        memcpy(modes, top, 4);
        modes += 4;
        intra_l[y] = ymode;
      }
    }
    m.uvmode = !br.bit(142) ? B_DC : !br.bit(114) ? B_VE : br.bit(183) ? B_TM : B_HE;
  } else {
    const uint8_t* p = prob.ymode;
    int ymode = -1;
    if (!br.bit(p[0])) ymode = B_DC;
    else if (!br.bit(p[1])) ymode = br.bit(p[2]) ? B_HE : B_VE;
    else if (!br.bit(p[3])) ymode = B_TM;
    m.is_i4x4 = ymode < 0;
    if (!m.is_i4x4) {
      m.imodes[0] = (uint8_t)ymode;
    } else {
      for (int k = 0; k < 16; k++) {
        int i = kYModesIntra4[br.bit(kBModesProbaInter[0])];
        while (i > 0) i = kYModesIntra4[2 * i + br.bit(kBModesProbaInter[i])];
        m.imodes[k] = (uint8_t)-i;
      }
    }
    const uint8_t* q = prob.uvmode;
    m.uvmode = !br.bit(q[0]) ? B_DC : !br.bit(q[1]) ? B_VE : br.bit(q[2]) ? B_TM : B_HE;
  }
  m.has_y2 = !m.is_i4x4;
}

// An inter macroblock's reference, mode and vectors (RFC 6386 section 16.3,
// as ffmpeg's vp8_decode_mvs reads them).
void VP8Decoder::parse_inter(MBInfo& m, int mb_x, int mb_y) {
  m.ref = br.bit(prob_last) ? (br.bit(prob_golden) ? REF_ALTREF : REF_GOLDEN) : REF_LAST;
  const MBInfo& top = info(mb_x, mb_y - 1);
  const MBInfo& left = info(mb_x - 1, mb_y);
  const MBInfo& top_left = info(mb_x - 1, mb_y - 1);
  const MBInfo* edges[3] = {&top, &left, &top_left};
  MV near_mv[4];
  int cnt[4] = {0, 0, 0, 0}, idx = 0;
  for (int n = 0; n < 3; n++) {
    const MBInfo& e = *edges[n];
    if (e.ref == REF_INTRA) continue;
    MV mv = e.mv;
    if (!mv.zero()) {
      if (sign_bias[e.ref] != sign_bias[m.ref]) {
        mv.x = (int16_t)-mv.x;
        mv.y = (int16_t)-mv.y;
      }
      if (!n || !(mv == near_mv[idx])) near_mv[++idx] = mv;
      cnt[idx] += 1 + (n != 2);
    } else {
      cnt[0] += 1 + (n != 2);
    }
  }
  // vectors point at most 16 samples past the macroblock-aligned frame
  auto clamp = [&](MV v) {
    const int min_x = -((mb_x << 6) + 64), max_x = ((mb_w - 1 - mb_x) << 6) + 64;
    const int min_y = -((mb_y << 6) + 64), max_y = ((mb_h - 1 - mb_y) << 6) + 64;
    v.x = (int16_t)std::min(std::max((int)v.x, min_x), max_x);
    v.y = (int16_t)std::min(std::max((int)v.y, min_y), max_y);
    return v;
  };
  m.part = SPLIT_NONE;
  if (!br.bit(kModeContexts[cnt[0]][0])) {
    m.mode = MODE_ZERO;
    return;
  }
  m.mode = MODE_MV;
  if (cnt[3] && near_mv[1] == near_mv[3]) cnt[1] += 1;
  if (cnt[2] > cnt[1]) {
    std::swap(cnt[1], cnt[2]);
    std::swap(near_mv[1], near_mv[2]);
  }
  if (!br.bit(kModeContexts[cnt[1]][1])) {  // nearest
    m.mv = clamp(near_mv[1]);
  } else if (!br.bit(kModeContexts[cnt[2]][2])) {  // near
    m.mv = clamp(near_mv[2]);
  } else {
    m.mv = clamp(near_mv[cnt[1] >= cnt[0] ? 1 : 0]);  // the best vector
    const int split_ctx = ((left.mode == MODE_SPLIT) + (top.mode == MODE_SPLIT)) * 2 +
                          (top_left.mode == MODE_SPLIT);
    if (br.bit(kModeContexts[split_ctx][3])) {
      m.mode = MODE_SPLIT;
      int part;
      if (br.bit(kSplitProba[0])) part = br.bit(kSplitProba[1]) ? SPLIT_16x8 + br.bit(kSplitProba[2])
                                                                 : SPLIT_8x8;
      else part = SPLIT_4x4;
      m.part = (uint8_t)part;
      const uint8_t *sl = kSplits[left.part], *st = kSplits[top.part], *sc = kSplits[part];
      const int num = kSplitCount[part];
      for (int n = 0; n < num; n++) {
        const int k = kSplitFirst[part][n];
        const MV l = (k & 3) ? m.bmv[sc[k - 1]] : left.bmv[sl[k + 3]];
        const MV a = k > 3 ? m.bmv[sc[k - 4]] : top.bmv[st[k + 12]];
        const uint8_t* p = l == a ? kSubMVProba[4 - !l.zero()]
                           : a.zero() ? kSubMVProba[2]
                                      : kSubMVProba[1 - !l.zero()];
        MV& b = m.bmv[n];
        if (!br.bit(p[0])) {
          b = l;
        } else if (!br.bit(p[1])) {
          b = a;
        } else if (!br.bit(p[2])) {
          b = MV();
        } else {
          b.y = (int16_t)(m.mv.y + read_mv(br, prob.mv[0]));
          b.x = (int16_t)(m.mv.x + read_mv(br, prob.mv[1]));
        }
      }
      m.mv = m.bmv[num - 1];
      return;
    }
    m.mv.y = (int16_t)(m.mv.y + read_mv(br, prob.mv[0]));
    m.mv.x = (int16_t)(m.mv.x + read_mv(br, prob.mv[1]));
  }
  m.bmv[0] = m.mv;
}

static int large_value(BoolDec& b, const uint8_t* p) {
  if (!b.bit(p[3])) {
    if (!b.bit(p[4])) return 2;
    return 3 + b.bit(p[5]);
  }
  if (!b.bit(p[6])) {
    if (!b.bit(p[7])) return 5 + b.bit(159);
    int v = 7 + 2 * b.bit(165);
    return v + b.bit(145);
  }
  const int bit1 = b.bit(p[8]);
  const int bit0 = b.bit(p[9 + bit1]);
  const int cat = 2 * bit1 + bit0;
  int v = 0;
  for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + b.bit(*tab);
  return v + 3 + (8 << cat);
}

// The coefficients of one block from position n: the position past the last
// one coded (0 where none is).
int VP8Decoder::get_coeffs(BoolDec& b, int type, int ctx, int dqdc, int dqac, int n,
                           int16_t* out) {
  const uint8_t* p = prob.coeff[type][kBands[n]][ctx];
  for (; n < 16; ++n) {
    if (!b.bit(p[0])) return n;
    while (!b.bit(p[1])) {
      p = prob.coeff[type][kBands[++n]][0];
      if (n == 16) return 16;
    }
    int v;
    if (!b.bit(p[2])) {
      v = 1;
      p = prob.coeff[type][kBands[n + 1]][1];
    } else {
      v = large_value(b, p);
      p = prob.coeff[type][kBands[n + 1]][2];
    }
    if (b.bit(0x80)) v = -v;
    out[kZigzag[n]] = (int16_t)(v * (n > 0 ? dqac : dqdc));
  }
  return 16;
}

static inline uint32_t nz_code(uint32_t bits, int nz, int dc_nz) {
  return (bits << 2) | (nz > 3 ? 3 : nz > 1 ? 2 : dc_nz);
}

// Reads one macroblock's coefficients; true where all are zero.
bool VP8Decoder::parse_residuals(int mb_x, BoolDec& b) {
  MBData& m = row[mb_x];
  const int* q = dq[m.segment];
  int16_t* dst = m.coeffs;
  memset(dst, 0, sizeof(m.coeffs));
  uint8_t& tnz_ref = nz_t[mb_x];
  int first, ac_type;
  if (m.has_y2) {
    int16_t dc[16] = {0};
    const int ctx = nz_dc_t[mb_x] + nz_dc_l;
    const int nz = get_coeffs(b, 1, ctx, q[2], q[3], 0, dc);
    nz_dc_t[mb_x] = nz_dc_l = nz > 0;
    if (nz > 1) {
      iwht(dc, dst);
    } else {
      const int dc0 = (dc[0] + 3) >> 3;
      for (int i = 0; i < 256; i += 16) dst[i] = (int16_t)dc0;
    }
    first = 1;
    ac_type = 0;
  } else {
    first = 0;
    ac_type = 3;
  }
  uint32_t tnz = tnz_ref & 0x0f, lnz = nz_l & 0x0f, nz_y = 0, nz_uv = 0;
  for (int y = 0; y < 4; y++) {
    int l = lnz & 1;
    uint32_t bits = 0;
    for (int x = 0; x < 4; x++) {
      const int ctx = l + (tnz & 1);
      const int nz = get_coeffs(b, ac_type, ctx, q[0], q[1], first, dst);
      l = nz > first;
      tnz = (tnz >> 1) | (l << 7);
      bits = nz_code(bits, nz, dst[0] != 0);
      dst += 16;
    }
    tnz >>= 4;
    lnz = (lnz >> 1) | (l << 7);
    nz_y = (nz_y << 8) | bits;
  }
  uint32_t out_t = tnz, out_l = lnz >> 4;
  for (int ch = 0; ch < 4; ch += 2) {
    uint32_t bits = 0;
    tnz = tnz_ref >> (4 + ch);
    lnz = nz_l >> (4 + ch);
    for (int y = 0; y < 2; y++) {
      int l = lnz & 1;
      for (int x = 0; x < 2; x++) {
        const int ctx = l + (tnz & 1);
        const int nz = get_coeffs(b, 2, ctx, q[4], q[5], 0, dst);
        l = nz > 0;
        tnz = (tnz >> 1) | (l << 3);
        bits = nz_code(bits, nz, dst[0] != 0);
        dst += 16;
      }
      tnz >>= 2;
      lnz = (lnz >> 1) | (l << 5);
    }
    nz_uv |= bits << (4 * ch);
    out_t |= (tnz << 4) << ch;
    out_l |= (lnz & 0xf0) << ch;
  }
  tnz_ref = (uint8_t)out_t;
  nz_l = (uint8_t)out_l;
  m.nz_y = nz_y;
  m.nz_uv = nz_uv;
  return !(nz_y | nz_uv);
}

// the motion-compensated prediction of a bw x bh block at (x, y) of a
// plane of pw x ph samples (its samples repeating past that), displaced by
// (fx, fy) eighths beyond: six-tap or bilinear filters, horizontal first
// the six-tap filter over `rows` rows of `bw` samples, taps `step` apart
// (1 across a row, the stride down a column)
template <int BW>
static void sixtap_w(uint8_t* d, int ds, const uint8_t* s, int ss, int step, int rows,
                     const uint8_t* F) {
  const int f0 = F[0], f1 = F[1], f2 = F[2], f3 = F[3], f4 = F[4], f5 = F[5];
  for (int j = 0; j < rows; j++, d += ds, s += ss)
    for (int i = 0; i < BW; i++) {
      const uint8_t* p = s + i;
      const int v = (f2 * p[0] - f1 * p[-step] + f0 * p[-2 * step] + f3 * p[step] -
                     f4 * p[2 * step] + f5 * p[3 * step] + 64) >> 7;
      d[i] = (uint8_t)std::min(std::max(v, 0), 255);
    }
}
static void sixtap(uint8_t* d, int ds, const uint8_t* s, int ss, int step, int bw, int rows,
                   const uint8_t* F) {
  if (bw == 16) sixtap_w<16>(d, ds, s, ss, step, rows, F);
  else if (bw == 8) sixtap_w<8>(d, ds, s, ss, step, rows, F);
  else sixtap_w<4>(d, ds, s, ss, step, rows, F);
}

static void mc_block(uint8_t* dst, const uint8_t* src, int stride, int pw, int ph, int x, int y,
                     int bw, int bh, int fx, int fy, bool bilinear) {
  uint8_t patch[21 * 21], tmp[21 * 16];
  const uint8_t* s;  // (x, y), with 2 samples before and 3 after it each way
  int ss;
  if (x >= 2 && y >= 2 && x + bw + 3 <= pw && y + bh + 3 <= ph) {
    s = src + (size_t)y * stride + x;
    ss = stride;
  } else {
    for (int j = 0; j < bh + 5; j++) {
      const int sy = std::min(std::max(y - 2 + j, 0), ph - 1);
      for (int i = 0; i < bw + 5; i++)
        patch[j * 21 + i] = src[(size_t)sy * stride + std::min(std::max(x - 2 + i, 0), pw - 1)];
    }
    s = patch + 2 * 21 + 2;
    ss = 21;
  }
  if (bilinear) {
    const uint8_t* h = s;
    int hs = ss;
    if (fx) {
      for (int j = 0; j < bh + 1; j++)
        for (int i = 0; i < bw; i++)
          tmp[j * 16 + i] = (uint8_t)((s[j * ss + i] * (8 - fx) + s[j * ss + i + 1] * fx + 4) >> 3);
      h = tmp;
      hs = 16;
    }
    for (int j = 0; j < bh; j++)
      for (int i = 0; i < bw; i++)
        dst[j * BPS + i] = fy ? (uint8_t)((h[j * hs + i] * (8 - fy) + h[(j + 1) * hs + i] * fy + 4) >> 3)
                              : h[j * hs + i];
    return;
  }
  const uint8_t* h = s;
  int hs = ss;
  if (fx) {  // rows -2 .. bh + 2 where a vertical pass follows
    const int j0 = fy ? -2 : 0, j1 = fy ? bh + 3 : bh;
    sixtap(tmp + (j0 + 2) * 16, 16, s + j0 * ss, ss, 1, bw, j1 - j0, kSubpel6[fx - 1]);
    h = tmp + 2 * 16;
    hs = 16;
  }
  if (fy) {
    sixtap(dst, BPS, h, hs, hs, bw, bh, kSubpel6[fy - 1]);
  } else {
    for (int j = 0; j < bh; j++) memcpy(dst + j * BPS, h + j * hs, (size_t)bw);
  }
}

// An inter macroblock's prediction into the workspace (ffmpeg's
// inter_predict): luma by partition, chroma by the partition's vector (full
// samples in version 3) or, in 4x4 splits, by the rounded mean of four.
void VP8Decoder::inter_predict(const MBInfo& m, int mb_x, int mb_y, uint8_t* y, uint8_t* u,
                               uint8_t* v) {
  const Planes& r = *ref[m.ref];
  const bool bil = version != 0;
  const int lw = 16 * mb_w, lh = 16 * mb_h;
  auto luma = [&](int bx, int by, int bw, int bh, MV mv) {
    const int px = ((mb_x * 16 + bx) << 3) + 2 * mv.x, py = ((mb_y * 16 + by) << 3) + 2 * mv.y;
    mc_block(y + by * BPS + bx, r.Y.data(), ys, lw, lh, px >> 3, py >> 3, bw, bh, px & 7, py & 7,
             bil);
  };
  auto chroma = [&](int bx, int by, int bw, int bh, MV mv) {
    if (version == 3) {
      mv.x = (int16_t)(mv.x & ~7);
      mv.y = (int16_t)(mv.y & ~7);
    }
    const int px = ((mb_x * 8 + bx) << 3) + mv.x, py = ((mb_y * 8 + by) << 3) + mv.y;
    mc_block(u + by * BPS + bx, r.U.data(), uvs, lw / 2, lh / 2, px >> 3, py >> 3, bw, bh, px & 7,
             py & 7, bil);
    mc_block(v + by * BPS + bx, r.V.data(), uvs, lw / 2, lh / 2, px >> 3, py >> 3, bw, bh, px & 7,
             py & 7, bil);
  };
  const MV* b = m.bmv;
  switch (m.part) {
    case SPLIT_NONE:
      luma(0, 0, 16, 16, m.mv);
      chroma(0, 0, 8, 8, m.mv);
      break;
    case SPLIT_16x8:
      luma(0, 0, 16, 8, b[0]);
      chroma(0, 0, 8, 4, b[0]);
      luma(0, 8, 16, 8, b[1]);
      chroma(0, 4, 8, 4, b[1]);
      break;
    case SPLIT_8x16:
      luma(0, 0, 8, 16, b[0]);
      chroma(0, 0, 4, 8, b[0]);
      luma(8, 0, 8, 16, b[1]);
      chroma(4, 0, 4, 8, b[1]);
      break;
    case SPLIT_8x8:
      for (int k = 0; k < 4; k++) {
        luma((k & 1) * 8, (k >> 1) * 8, 8, 8, b[k]);
        chroma((k & 1) * 4, (k >> 1) * 4, 4, 4, b[k]);
      }
      break;
    default:  // 4x4
      for (int k = 0; k < 16; k++) luma((k & 3) * 4, (k >> 2) * 4, 4, 4, b[k]);
      for (int cy = 0; cy < 2; cy++)
        for (int cx = 0; cx < 2; cx++) {
          const int k = 8 * cy + 2 * cx;
          int sx = b[k].x + b[k + 1].x + b[k + 4].x + b[k + 5].x;
          int sy = b[k].y + b[k + 1].y + b[k + 4].y + b[k + 5].y;
          MV uv;
          uv.x = (int16_t)((sx + 2 + (sx < 0 ? -1 : 0)) >> 2);
          uv.y = (int16_t)((sy + 2 + (sy < 0 ? -1 : 0)) >> 2);
          chroma(cx * 4, cy * 4, 4, 4, uv);
        }
  }
}

void VP8Decoder::reconstruct(int mb_y) {
  uint8_t* const y_dst = work + Y_OFF;
  uint8_t* const u_dst = work + U_OFF;
  uint8_t* const v_dst = work + V_OFF;
  for (int j = 0; j < 16; j++) y_dst[j * BPS - 1] = 129;
  for (int j = 0; j < 8; j++) u_dst[j * BPS - 1] = v_dst[j * BPS - 1] = 129;
  if (mb_y > 0) {
    y_dst[-1 - BPS] = u_dst[-1 - BPS] = v_dst[-1 - BPS] = 129;
  } else {
    memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
    memset(u_dst - BPS - 1, 127, 8 + 1);
    memset(v_dst - BPS - 1, 127, 8 + 1);
  }
  for (int mb_x = 0; mb_x < mb_w; mb_x++) {
    const MBData& m = row[mb_x];
    if (mb_x > 0) {  // the previous macroblock's right columns become the left edge
      for (int j = -1; j < 16; j++) memcpy(y_dst + j * BPS - 4, y_dst + j * BPS + 12, 4);
      for (int j = -1; j < 8; j++) {
        memcpy(u_dst + j * BPS - 4, u_dst + j * BPS + 4, 4);
        memcpy(v_dst + j * BPS - 4, v_dst + j * BPS + 4, 4);
      }
    }
    if (mb_y > 0) {
      memcpy(y_dst - BPS, &top_y[16 * mb_x], 16);
      memcpy(u_dst - BPS, &top_u[8 * mb_x], 8);
      memcpy(v_dst - BPS, &top_v[8 * mb_x], 8);
    }
    uint32_t bits = m.nz_y;
    const MBInfo& inf = info(mb_x, mb_y);
    if (inf.ref != REF_INTRA) {
      inter_predict(inf, mb_x, mb_y, y_dst, u_dst, v_dst);
      for (int n = 0; n < 16; n++, bits <<= 2)
        transform_add(bits >> 30, m.coeffs + n * 16, y_dst + kScan[n]);
    } else if (m.is_i4x4) {
      uint8_t* const top_right = y_dst - BPS + 16;
      if (mb_y > 0) {
        if (mb_x >= mb_w - 1) memset(top_right, top_y[16 * mb_x + 15], 4);
        else memcpy(top_right, &top_y[16 * (mb_x + 1)], 4);
      }
      // the sub-blocks of the right column take the same pixels above-right
      for (int r = 1; r < 4; r++) memcpy(top_right + 4 * r * BPS, top_right, 4);
      for (int n = 0; n < 16; n++, bits <<= 2) {
        uint8_t* const dst = y_dst + kScan[n];
        predict4(m.imodes[n], dst);
        transform_add(bits >> 30, m.coeffs + n * 16, dst);
      }
    } else {
      predict_block(m.imodes[0], y_dst, 16, mb_x, mb_y);
      for (int n = 0; n < 16; n++, bits <<= 2)
        transform_add(bits >> 30, m.coeffs + n * 16, y_dst + kScan[n]);
    }
    if (inf.ref == REF_INTRA) {
      predict_block(m.uvmode, u_dst, 8, mb_x, mb_y);
      predict_block(m.uvmode, v_dst, 8, mb_x, mb_y);
    }
    // chroma: the full transform on all four blocks where any has an AC
    // coefficient, else the DC one on those whose DC is not zero
    for (int ch = 0; ch < 2; ch++) {
      const uint32_t bits_uv = (m.nz_uv >> (8 * ch)) & 0xff;
      const int16_t* in = m.coeffs + 256 + 64 * ch;
      uint8_t* dst = ch ? v_dst : u_dst;
      if (!bits_uv) continue;
      for (int k = 0; k < 4; k++) {
        uint8_t* d = dst + (k & 1) * 4 + (k >> 1) * 4 * BPS;
        if (bits_uv & 0xaa) idct_add(in + 16 * k, d);
        else if (in[16 * k]) idct_dc_add(in + 16 * k, d);
      }
    }
    if (mb_y < mb_h - 1) {
      memcpy(&top_y[16 * mb_x], y_dst + 15 * BPS, 16);
      memcpy(&top_u[8 * mb_x], u_dst + 7 * BPS, 8);
      memcpy(&top_v[8 * mb_x], v_dst + 7 * BPS, 8);
    }
    for (int j = 0; j < 16; j++)
      memcpy(&Y[(size_t)(mb_y * 16 + j) * ys + mb_x * 16], y_dst + j * BPS, 16);
    for (int j = 0; j < 8; j++) {
      memcpy(&U[(size_t)(mb_y * 8 + j) * uvs + mb_x * 8], u_dst + j * BPS, 8);
      memcpy(&V[(size_t)(mb_y * 8 + j) * uvs + mb_x * 8], v_dst + j * BPS, 8);
    }
  }
}

// Filters every macroblock in raster order: its left edge, its inner
// vertical edges, its top edge, its inner horizontal edges.
void VP8Decoder::filter_frame() {
  if (filter_type == 0) return;
  for (int mb_y = 0; mb_y < mb_h; mb_y++) {
    for (int mb_x = 0; mb_x < mb_w; mb_x++) {
      const FInfo& f = finfo[(size_t)mb_y * mb_w + mb_x];
      if (f.limit == 0) continue;
      uint8_t* y = &Y[(size_t)mb_y * 16 * ys + mb_x * 16];
      if (filter_type == 1) {
        if (mb_x > 0) simple_edge(y, 1, ys, f.limit + 4);
        if (f.inner)
          for (int k = 4; k < 16; k += 4) simple_edge(y + k, 1, ys, f.limit);
        if (mb_y > 0) simple_edge(y, ys, 1, f.limit + 4);
        if (f.inner)
          for (int k = 4; k < 16; k += 4) simple_edge(y + k * ys, ys, 1, f.limit);
        continue;
      }
      uint8_t* u = &U[(size_t)mb_y * 8 * uvs + mb_x * 8];
      uint8_t* v = &V[(size_t)mb_y * 8 * uvs + mb_x * 8];
      const int lim = f.limit, il = f.ilevel, hv = f.hev;
      if (mb_x > 0) {
        edge(y, 1, ys, 16, lim + 4, il, hv, true);
        edge(u, 1, uvs, 8, lim + 4, il, hv, true);
        edge(v, 1, uvs, 8, lim + 4, il, hv, true);
      }
      if (f.inner) {
        for (int k = 4; k < 16; k += 4) edge(y + k, 1, ys, 16, lim, il, hv, false);
        edge(u + 4, 1, uvs, 8, lim, il, hv, false);
        edge(v + 4, 1, uvs, 8, lim, il, hv, false);
      }
      if (mb_y > 0) {
        edge(y, ys, 1, 16, lim + 4, il, hv, true);
        edge(u, uvs, 1, 8, lim + 4, il, hv, true);
        edge(v, uvs, 1, 8, lim + 4, il, hv, true);
      }
      if (f.inner) {
        for (int k = 4; k < 16; k += 4) edge(y + k * ys, ys, 1, 16, lim, il, hv, false);
        edge(u + 4 * uvs, uvs, 1, 8, lim, il, hv, false);
        edge(v + 4 * uvs, uvs, 1, 8, lim, il, hv, false);
      }
    }
  }
}

// Decode one frame into `cur` (filtered), and update the references.
int VP8Decoder::decode_frame(const uint8_t* d, size_t n) {
  if (headers(d, n) != OK) return ERR;
  cur = std::make_shared<Planes>();
  cur->Y.assign((size_t)ys * 16 * mb_h, 0);
  cur->U.assign((size_t)uvs * 8 * mb_h, 0);
  cur->V.assign((size_t)uvs * 8 * mb_h, 0);
  Y = cur->Y.data();
  U = cur->U.data();
  V = cur->V.data();
  intra_t.assign(4 * (size_t)mb_w, B_DC);
  nz_t.assign(mb_w, 0);
  nz_dc_t.assign(mb_w, 0);
  top_y.assign(16 * (size_t)mb_w, 0);
  top_u.assign(8 * (size_t)mb_w, 0);
  top_v.assign(8 * (size_t)mb_w, 0);
  memset(work, 0, sizeof(work));
  for (int mb_y = 0; mb_y < mb_h; mb_y++) {
    BoolDec& tokens = parts[mb_y & (num_parts - 1)];
    memset(intra_l, B_DC, 4);
    for (int mb_x = 0; mb_x < mb_w; mb_x++) parse_modes(mb_x, mb_y);
    if (br.eof) return ERR;
    nz_l = nz_dc_l = 0;
    for (int mb_x = 0; mb_x < mb_w; mb_x++) {
      MBData& m = row[mb_x];
      bool skip = m.skip;
      if (!skip) {
        skip = parse_residuals(mb_x, tokens);
      } else {
        nz_l = nz_t[mb_x] = 0;
        if (m.has_y2) nz_dc_l = nz_dc_t[mb_x] = 0;
        m.nz_y = m.nz_uv = 0;
      }
      if (filter_type > 0) {
        const MBInfo& inf = info(mb_x, mb_y);
        FInfo f = strength(m.segment, inf.ref,
                           inf.ref != REF_INTRA ? inf.mode : m.is_i4x4 ? 0 : -1);
        f.inner = m.is_i4x4 || inf.mode == MODE_SPLIT || !skip;
        finfo[(size_t)mb_y * mb_w + mb_x] = f;
      }
      if (tokens.eof) return ERR;
    }
    reconstruct(mb_y);
  }
  filter_frame();
  // the references: the golden and altref from the old ones or this frame
  std::shared_ptr<Planes> next[4] = {nullptr, ref[1], ref[2], ref[3]};
  if (golden_src >= 0) next[REF_GOLDEN] = golden_src ? ref[golden_src] : cur;
  if (altref_src >= 0) next[REF_ALTREF] = altref_src ? ref[altref_src] : cur;
  if (update_last) next[REF_LAST] = cur;
  for (int k = 1; k < 4; k++) ref[k] = next[k];
  if (!refresh_probs) prob = saved;
  have_refs = true;
  return OK;
}

}  // namespace vp8
}  // namespace
