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
// * VP8 (lossy key frames, RFC 6386): frame header, boolean decoder,
//   segments, loop-filter deltas, 1-8 token partitions, coefficient
//   probability updates, intra prediction, dequantisation, the inverse WHT
//   and DCT, and the simple and normal loop filters; then the 4:2:0 planes
//   to RGB with the "fancy" upsampler and the 14-bit fixed-point conversion
//   that libwebp's RGB output applies.
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

namespace {

constexpr int OK = 0;
constexpr int ERR = -3;  // MGDT_ERR_DECODE

inline uint32_t le16(const uint8_t* p) { return p[0] | (p[1] << 8); }
inline uint32_t le24(const uint8_t* p) { return p[0] | (p[1] << 8) | (p[2] << 16); }
inline uint32_t le32(const uint8_t* p) { return le24(p) | ((uint32_t)p[3] << 24); }

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

// ---------------------------------------------------------------------------
// VP8: lossy key frames (RFC 6386)
// ---------------------------------------------------------------------------

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

struct MBData {
  int16_t coeffs[384];
  uint8_t imodes[16];
  uint8_t is_i4x4, uvmode, segment, skip;
  uint32_t nz_y, nz_uv;
};

struct VP8Decoder {
  int width = 0, height = 0, mb_w = 0, mb_h = 0;
  BoolDec br, parts[8];
  int num_parts = 1;
  // segment header
  bool use_segment = false, update_map = false, absolute_delta = true;
  int seg_quant[4] = {0}, seg_filter[4] = {0};
  uint8_t seg_proba[3] = {255, 255, 255};
  // filter header
  bool simple = false;
  int level = 0, sharpness = 0;
  bool use_lf_delta = false;
  int ref_lf_delta[4] = {0}, mode_lf_delta[4] = {0};
  int filter_type = 0;
  // quantisers: [segment] {y1 dc, y1 ac, y2 dc, y2 ac, uv dc, uv ac}
  int dq[4][6];
  uint8_t proba[4][8][3][11];
  bool use_skip = false;
  int skip_p = 0;
  FInfo fstrengths[4][2];
  // per-column state
  std::vector<uint8_t> intra_t, nz_t, nz_dc_t;
  uint8_t intra_l[4], nz_l = 0, nz_dc_l = 0;
  std::vector<MBData> row;
  std::vector<FInfo> finfo;  // every macroblock, for the filter pass
  std::vector<uint8_t> top_y, top_u, top_v;  // unfiltered bottom rows, per column
  uint8_t work[WORK_SIZE];
  // the frame, macroblock-aligned
  std::vector<uint8_t> Y, U, V;
  int ys = 0, uvs = 0;

  int headers(const uint8_t* d, size_t n);
  void parse_modes(int mb_x);
  int get_coeffs(BoolDec& b, int type, int ctx, int dqdc, int dqac, int n, int16_t* out);
  bool parse_residuals(int mb_x, BoolDec& b);
  void reconstruct(int mb_y);
  void filter_frame();
};

int VP8Decoder::headers(const uint8_t* d, size_t n) {
  if (n < 10) return ERR;
  const uint32_t tag = le24(d);
  if ((tag & 1) || ((tag >> 1) & 7) > 3 || !((tag >> 4) & 1)) return ERR;
  const uint32_t part0 = tag >> 5;
  if (d[3] != 0x9d || d[4] != 0x01 || d[5] != 0x2a) return ERR;
  width = le16(d + 6) & 0x3fff;
  height = le16(d + 8) & 0x3fff;
  if (!width || !height) return ERR;
  mb_w = (width + 15) >> 4;
  mb_h = (height + 15) >> 4;
  d += 10;
  n -= 10;
  if (part0 > n) return ERR;
  br.init(d, part0);
  d += part0;
  n -= part0;
  br.bit(0x80);  // colour space
  br.bit(0x80);  // clamping type
  // segments
  use_segment = br.bit(0x80);
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
  br.bit(0x80);  // refresh entropy probabilities: one frame, no effect
  for (int t = 0; t < 4; t++)
    for (int b = 0; b < 8; b++)
      for (int c = 0; c < 3; c++)
        for (int p = 0; p < 11; p++)
          proba[t][b][c][p] = br.bit(kCoeffsUpdateProba[t][b][c][p])
                                  ? (uint8_t)br.literal(8)
                                  : kCoeffsProba0[t][b][c][p];
  use_skip = br.bit(0x80);
  if (use_skip) skip_p = br.literal(8);
  // filter strengths by segment and by 4x4 prediction
  if (filter_type > 0) {
    for (int s = 0; s < 4; s++) {
      int base = level;
      if (use_segment) base = seg_filter[s] + (absolute_delta ? 0 : level);
      for (int i4 = 0; i4 <= 1; i4++) {
        FInfo& f = fstrengths[s][i4];
        int lv = base;
        if (use_lf_delta) {
          lv += ref_lf_delta[0];
          if (i4) lv += mode_lf_delta[0];
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
          f.hev = lv >= 40 ? 2 : lv >= 15 ? 1 : 0;
        } else {
          f.limit = 0;
        }
        f.inner = i4;
      }
    }
  }
  return OK;
}

void VP8Decoder::parse_modes(int mb_x) {
  MBData& m = row[mb_x];
  uint8_t* top = &intra_t[4 * mb_x];
  if (update_map)
    m.segment = !br.bit(seg_proba[0]) ? br.bit(seg_proba[1]) : br.bit(seg_proba[2]) + 2;
  else
    m.segment = 0;
  m.skip = use_skip ? br.bit(skip_p) : 0;
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
        const uint8_t* prob = kBModesProba[top[x]][ymode];
        int i = kYModesIntra4[br.bit(prob[0])];
        while (i > 0) i = kYModesIntra4[2 * i + br.bit(prob[i])];
        ymode = -i;
        top[x] = ymode;
      }
      memcpy(modes, top, 4);
      modes += 4;
      intra_l[y] = ymode;
    }
  }
  m.uvmode = !br.bit(142) ? B_DC : !br.bit(114) ? B_VE : br.bit(183) ? B_TM : B_HE;
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
  const uint8_t* p = proba[type][kBands[n]][ctx];
  for (; n < 16; ++n) {
    if (!b.bit(p[0])) return n;
    while (!b.bit(p[1])) {
      p = proba[type][kBands[++n]][0];
      if (n == 16) return 16;
    }
    int v;
    if (!b.bit(p[2])) {
      v = 1;
      p = proba[type][kBands[n + 1]][1];
    } else {
      v = large_value(b, p);
      p = proba[type][kBands[n + 1]][2];
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
  if (!m.is_i4x4) {
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
    if (m.is_i4x4) {
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
    predict_block(m.uvmode, u_dst, 8, mb_x, mb_y);
    predict_block(m.uvmode, v_dst, 8, mb_x, mb_y);
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
  VP8Decoder dec;
  if (dec.headers(d, n) != OK) return ERR;
  const int mb_w = dec.mb_w, mb_h = dec.mb_h;
  dec.intra_t.assign(4 * (size_t)mb_w, B_DC);
  dec.nz_t.assign(mb_w, 0);
  dec.nz_dc_t.assign(mb_w, 0);
  dec.row.resize(mb_w);
  dec.finfo.resize((size_t)mb_w * mb_h);
  dec.top_y.assign(16 * (size_t)mb_w, 0);
  dec.top_u.assign(8 * (size_t)mb_w, 0);
  dec.top_v.assign(8 * (size_t)mb_w, 0);
  dec.ys = 16 * mb_w;
  dec.uvs = 8 * mb_w;
  dec.Y.assign((size_t)dec.ys * 16 * mb_h, 0);
  dec.U.assign((size_t)dec.uvs * 8 * mb_h, 0);
  dec.V.assign((size_t)dec.uvs * 8 * mb_h, 0);
  memset(dec.work, 0, sizeof(dec.work));
  for (int mb_y = 0; mb_y < mb_h; mb_y++) {
    BoolDec& tokens = dec.parts[mb_y & (dec.num_parts - 1)];
    memset(dec.intra_l, B_DC, 4);
    for (int mb_x = 0; mb_x < mb_w; mb_x++) dec.parse_modes(mb_x);
    if (dec.br.eof) return ERR;
    dec.nz_l = dec.nz_dc_l = 0;
    for (int mb_x = 0; mb_x < mb_w; mb_x++) {
      MBData& m = dec.row[mb_x];
      bool skip = m.skip;
      if (!skip) {
        skip = dec.parse_residuals(mb_x, tokens);
      } else {
        dec.nz_l = dec.nz_t[mb_x] = 0;
        if (!m.is_i4x4) dec.nz_dc_l = dec.nz_dc_t[mb_x] = 0;
        m.nz_y = m.nz_uv = 0;
      }
      if (dec.filter_type > 0) {
        FInfo f = dec.fstrengths[m.segment][m.is_i4x4];
        f.inner = f.inner || !skip;
        dec.finfo[(size_t)mb_y * mb_w + mb_x] = f;
      }
      if (tokens.eof) return ERR;
    }
    dec.reconstruct(mb_y);
  }
  if (alpha && !alpha_ok(alpha, alpha_n, dec.width, dec.height)) return ERR;
  dec.filter_frame();
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
