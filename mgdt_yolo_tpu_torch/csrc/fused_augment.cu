// K3: flips, continuous HSV gain and /255 of uint8 training images, NHWC,
// redesigned for Hopper.
//
// Replaces: mgdt_yolo_tpu/ops/pallas_image.py, `fused_augment_pallas` (its
// inner `kernel`), whose live twin `fused_augment` the JAX device augment
// calls (ops/device_augment.py). The TPU kernel flips the uint8 batch in a
// separate pass, transposes it to channel planes so W fills the lanes, and
// walks one image per grid step. Plain PyTorch version: ops/image.py,
// `fused_augment_plain`.
//
// Bound on this card (H100 SXM, 3.35 TB/s): memory. Per pixel 3 B are read
// and 12 B written; at (32, 640, 640) that is 196.6 MB, ~0.059 ms, against
// ~54 float32 operations per pixel (~0.7 GFLOP, ~0.011 ms at 67 TFLOP/s).
//
// What the first design (fused_augment_simt.cu, "SIMT K3") left on the
// table, and what this one does about it:
// * SIMT K3 takes one pixel per thread: three 1-byte loads at a 3-byte
//   stride and three 4-byte stores at a 12-byte stride, so a warp's store
//   instruction spreads over 384 B. Here a thread takes 4 consecutive output
//   pixels: their 12 source bytes are three aligned 32-bit loads (for a
//   left-right flip, the mirrored group, its pixels reversed in registers),
//   and their 48 output bytes go through a per-warp staging buffer in shared
//   memory, so the warp writes its 1,536 B as three fully contiguous float4
//   stores. A width that is not a multiple of 4 (or an unaligned pointer)
//   takes a pixel-per-thread path.
// * SIMT K3 divides a 64-bit pixel index twice per pixel (a software
//   routine) and re-reads the image's gains and flips for every pixel. Here
//   the grid is (row groups, images): image and row come from blockIdx, and
//   a block reads its image's gains and flips once.
// * SIMT K3 issues about 200 instructions per pixel, seven IEEE divisions
//   and three to four fmodf calls among them. Here: the three /255 are a
//   256-entry table in shared memory filled with the same __fdiv_rn(i, 255);
//   the hue branch is one division (numerator and addend chosen by the max
//   channel); /6 is q = RN(x / 6) without a division (q1 = RN(x z), z =
//   RN(1/6), r = fma(-q1, 6, x) exact, q = fma(r, z, q1): Markstein's
//   correction, correctly rounded for normal quotients, and checked on every
//   hue the 2^24 RGB triples give); the floor-mods by 1 and 2 are the exact
//   x - n trunc(x / n) (the fmodf result is representable, so the
//   subtraction is exact), by 6 of the hue ratio fmodf's identity below 6,
//   and the hue sector an integer remainder. Every other operation is the
//   SIMT K3's IEEE-rounded intrinsic in its order, with no FMA contraction,
//   so the two designs give the same bits; chip_smoke.py holds them to that
//   over all 2^24 RGB triples.
//
// Built by mgdt_yolo_tpu_torch/utils/build.py with nvcc for sm_90a; called
// through ctypes from mgdt_yolo_tpu_torch/ops/cuda_image.py (`fused_augment`).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 4;          // image rows per block
constexpr int MAX_THREADS = 256;
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr float INV6 = 1.0f / 6.0f;  // RN(1/6)

__device__ __forceinline__ float clip01(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }

// floor-mod (the sign of the divisor, as jnp.remainder) by 1: fmodf(x, 1)
// is x - trunc(x) with x's sign, exactly
__device__ __forceinline__ float floor_mod1(float x) {
  float r = copysignf(__fsub_rn(x, truncf(x)), x);
  if (r < 0.0f) r = __fadd_rn(r, 1.0f);
  return r;
}

// floor-mod by 2: fmodf(x, 2) is x - 2 trunc(x / 2) with x's sign, exactly
__device__ __forceinline__ float floor_mod2(float x) {
  float r = copysignf(__fsub_rn(x, __fmul_rn(2.0f, truncf(__fmul_rn(x, 0.5f)))), x);
  if (r < 0.0f) r = __fadd_rn(r, 2.0f);
  return r;
}

// floor-mod by 6 of the hue ratio (|x| <= 1): fmodf(x, 6) is x below 6
__device__ __forceinline__ float floor_mod6(float x) {
  float r = fabsf(x) < 6.0f ? x : fmodf(x, 6.0f);
  if (r < 0.0f) r = __fadd_rn(r, 6.0f);
  return r;
}

// __fdiv_rn(x, 6) without a division (see the head of this file)
__device__ __forceinline__ float div6(float x) {
  const float q1 = __fmul_rn(x, INV6);
  const float r = __fmaf_rn(-q1, 6.0f, x);
  return copysignf(__fmaf_rn(r, INV6, q1), x);
}

// the hue sector, floor_mod(floor(h6), 6), as the index of the first k with
// sector < k + 0.5 (5 if none: the SIMT K3's cascade)
__device__ __forceinline__ int sector_of(float h6) {
  const float n = floorf(h6);
  if (!(fabsf(n) < 16777216.0f)) {  // not an exact int (NaN): the cascade itself
    float s = fmodf(n, 6.0f);
    if (s != 0.0f && s < 0.0f) s = __fadd_rn(s, 6.0f);
    return s < 0.5f ? 0 : s < 1.5f ? 1 : s < 2.5f ? 2 : s < 3.5f ? 3 : s < 4.5f ? 4 : 5;
  }
  int m = (int)n % 6;
  if (m < 0) m += 6;
  return m;
}

// one pixel: [0, 1] RGB in, the HSV-adjusted RGB out, in the SIMT K3's order
__device__ __forceinline__ void hsv_pixel(float r, float g, float bl, float gh, float gs,
                                          float gv, float* o) {
  const float cmax = fmaxf(r, fmaxf(g, bl));
  const float cmin = fminf(r, fminf(g, bl));
  const float delta = __fadd_rn(__fsub_rn(cmax, cmin), 1e-12f);
  const bool is_r = cmax == r, is_g = !is_r && cmax == g;
  const float num = is_r ? __fsub_rn(g, bl) : is_g ? __fsub_rn(bl, r) : __fsub_rn(r, g);
  const float q = __fdiv_rn(num, delta);
  float h = is_r ? floor_mod6(q) : __fadd_rn(q, is_g ? 2.0f : 4.0f);
  h = div6(h);
  const float s0 = __fdiv_rn(delta, __fadd_rn(cmax, 1e-12f));
  h = floor_mod1(__fmul_rn(h, gh));
  const float s = clip01(__fmul_rn(s0, gs));
  const float v = clip01(__fmul_rn(cmax, gv));
  const float h6 = __fmul_rn(h, 6.0f);
  const float c = __fmul_rn(v, s);
  const float xx = __fmul_rn(c, __fsub_rn(1.0f, fabsf(__fsub_rn(floor_mod2(h6), 1.0f))));
  const float m = __fsub_rn(v, c);
  const int sec = sector_of(h6);
  const float z = __fmul_rn(c, 0.0f);
  // the cases by sector: r [c, xx, z, z, xx, c], g [xx, c, c, xx, z, z],
  // b [z, z, xx, c, c, xx]
  const float pr = (sec == 0 || sec == 5) ? c : (sec == 1 || sec == 4) ? xx : z;
  const float pg = (sec == 1 || sec == 2) ? c : (sec == 0 || sec == 3) ? xx : z;
  const float pb = (sec == 3 || sec == 4) ? c : (sec == 2 || sec == 5) ? xx : z;
  o[0] = __fadd_rn(pr, m);
  o[1] = __fadd_rn(pg, m);
  o[2] = __fadd_rn(pb, m);
}

// VEC: W % 4 == 0, images 4-byte and out 16-byte aligned: 4 pixels a thread
template <bool VEC>
__global__ void __launch_bounds__(MAX_THREADS)
fused_augment_kernel(const uint8_t* __restrict__ img, const float* __restrict__ gains,
                     const int32_t* __restrict__ flips, float* __restrict__ out, int B, int H,
                     int W) {
  __shared__ float inv255[256];
  __shared__ float4 stage[VEC ? MAX_WARPS * 96 : 1];  // per warp: 32 groups x 3 float4
  for (int i = threadIdx.x; i < 256; i += blockDim.x) inv255[i] = __fdiv_rn((float)i, 255.0f);
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float4* st = stage + (VEC ? warp * 96 : 0);

  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    const float gh = gains[3 * b], gs = gains[3 * b + 1], gv = gains[3 * b + 2];
    const bool lr = flips[2 * b] > 0, ud = flips[2 * b + 1] > 0;
    const int y_end = min(H, ((int)blockIdx.x + 1) * ROWS);
    for (int y = blockIdx.x * ROWS; y < y_end; ++y) {
      const uint8_t* src = img + ((size_t)b * H + (ud ? H - 1 - y : y)) * W * 3;
      float* dst = out + ((size_t)b * H + y) * W * 3;
      if (VEC) {
        const int G = W / 4;  // 4-pixel groups of the row
        for (int g0 = 0; g0 < G; g0 += blockDim.x) {
          const int gw = g0 + warp * 32;  // the warp's first group
          if (gw >= G) continue;          // warp-uniform
          const int g = gw + lane, n = min(32, G - gw);
          if (g < G) {
            const uint32_t* w = reinterpret_cast<const uint32_t*>(src) + 3 * (lr ? G - 1 - g : g);
            const uint32_t wd[3] = {w[0], w[1], w[2]};
            unsigned by[12];  // source byte k: pixel k / 3, channel k % 3
#pragma unroll
            for (int k = 0; k < 12; ++k) by[k] = (wd[k >> 2] >> (8 * (k & 3))) & 0xffu;
            float v[12];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int j = 3 - i;  // the source pixel under a left-right flip
              hsv_pixel(inv255[lr ? by[3 * j] : by[3 * i]],
                        inv255[lr ? by[3 * j + 1] : by[3 * i + 1]],
                        inv255[lr ? by[3 * j + 2] : by[3 * i + 2]], gh, gs, gv, v + 3 * i);
            }
#pragma unroll
            for (int k = 0; k < 3; ++k)
              st[3 * lane + k] = make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
          }
          __syncwarp();
          float4* drow = reinterpret_cast<float4*>(dst) + 3 * gw;
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            const int e = lane + 32 * k;
            if (e < 3 * n) drow[e] = st[e];
          }
          __syncwarp();  // the stage is read before the next group refills it
        }
      } else {
        for (int x = threadIdx.x; x < W; x += blockDim.x) {
          const uint8_t* p = src + (size_t)(lr ? W - 1 - x : x) * 3;
          hsv_pixel(inv255[p[0]], inv255[p[1]], inv255[p[2]], gh, gs, gv,
                    dst + (size_t)x * 3);
        }
      }
    }
  }
}

template <bool VEC>
int launch(const void* images, const void* gains, const void* flips, void* out, int B, int H,
           int W, cudaStream_t stream) {
  const int work = VEC ? W / 4 : W;  // threads' items per row
  int threads = (work + 31) / 32 * 32;
  threads = threads < 32 ? 32 : threads > MAX_THREADS ? MAX_THREADS : threads;
  const dim3 grid((unsigned)((H + ROWS - 1) / ROWS), (unsigned)(B < 65535 ? B : 65535));
  fused_augment_kernel<VEC><<<grid, threads, 0, stream>>>(
      static_cast<const uint8_t*>(images), static_cast<const float*>(gains),
      static_cast<const int32_t*>(flips), static_cast<float*>(out), B, H, W);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// images (B,H,W,3) uint8, gains (B,3) float32, flips (B,2) int32
// [left-right, up-down], out (B,H,W,3) float32: all contiguous. Returns a
// cudaError_t.
int fused_augment(const void* images, const void* gains, const void* flips, void* out, int B,
                  int H, int W, void* stream) {
  if ((long long)B * H * W == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = W % 4 == 0 && reinterpret_cast<uintptr_t>(images) % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec) return launch<true>(images, gains, flips, out, B, H, W, s);
  return launch<false>(images, gains, flips, out, B, H, W, s);
}

}  // extern "C"
