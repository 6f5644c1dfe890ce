// K3's first design ("SIMT K3"): flips, continuous HSV gain and /255 of
// uint8 training images, NHWC, one thread per pixel. The main path runs the
// Hopper design in fused_augment.cu; this one stays as its A/B baseline and
// its bitwise reference, reached only through `fused_augment_simt` in
// mgdt_yolo_tpu_torch/ops/cuda_image.py.
//
// Replaces: mgdt_yolo_tpu/ops/pallas_image.py, `fused_augment_pallas` (its
// inner `kernel`), whose live twin `fused_augment` the JAX device augment
// calls (ops/device_augment.py). The TPU kernel flips the uint8 batch in a
// separate pass, transposes it to channel planes so W fills the lanes, and
// walks one image per grid step. Here one thread takes one output pixel:
// it reads the 3 bytes at the flipped source index (the flips are folded
// into the index, so no flipped copy is made), does the HSV arithmetic in
// float32 in registers and writes the 3 float32 values in place, NHWC, the
// layout the model takes. Gains and flips are per image.
//
// Bound on this card: memory. Per pixel 3 B are read and 12 B written; at
// (32, 640, 640) that is 196.6 MB, ~0.059 ms at 3.35 TB/s, against ~60
// float32 operations per pixel (~0.8 GFLOP, ~0.012 ms at 67 TFLOP/s). The
// design moves exactly those bytes once: no intermediate (flipped uint8,
// float32 planes, transposed output) reaches device memory.
//
// Arithmetic: every operation is the IEEE-rounded intrinsic of the JAX
// expression, in its order (__fdiv_rn for the divisions, __fmul_rn /
// __fadd_rn / __fsub_rn so nvcc cannot contract a product and a sum into an
// FMA), floor-mod written out as XLA's `%`, and the five-step
// `sector < k + 0.5` cascade. See ops/image.py for the plain PyTorch version
// this kernel is held against.
//
// Built by mgdt_yolo_tpu_torch/utils/build.py with nvcc for sm_90a; called
// through ctypes from mgdt_yolo_tpu_torch/ops/cuda_image.py (`fused_augment_simt`).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// x % y with the sign of y, as jnp.remainder and torch.remainder compute it
__device__ __forceinline__ float floor_mod(float x, float y) {
  float r = fmodf(x, y);
  if (r != 0.0f && ((r < 0.0f) != (y < 0.0f))) r = __fadd_rn(r, y);
  return r;
}

__device__ __forceinline__ float clip01(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }

// cases[sector], by the JAX cascade: start at case 5, then for k = 4..0
// take case k where sector < k + 0.5
__device__ __forceinline__ float pick(float sector, float c0, float c1, float c2, float c3,
                                      float c4, float c5) {
  float out = c5;
  if (sector < 4.5f) out = c4;
  if (sector < 3.5f) out = c3;
  if (sector < 2.5f) out = c2;
  if (sector < 1.5f) out = c1;
  if (sector < 0.5f) out = c0;
  return out;
}

__global__ void fused_augment_simt_kernel(const uint8_t* __restrict__ img,
                                     const float* __restrict__ gains,
                                     const int32_t* __restrict__ flips,
                                     float* __restrict__ out, int B, int H, int W) {
  const long long HW = (long long)H * W;
  const long long total = (long long)B * HW;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x; p < total; p += step) {
    const int b = (int)(p / HW);
    const long long rem = p - (long long)b * HW;
    const int y = (int)(rem / W);
    const int x = (int)(rem - (long long)y * W);
    const int sy = flips[2 * b + 1] > 0 ? H - 1 - y : y;
    const int sx = flips[2 * b] > 0 ? W - 1 - x : x;
    const uint8_t* src = img + ((long long)b * HW + (long long)sy * W + sx) * 3;
    const float r = __fdiv_rn((float)src[0], 255.0f);
    const float g = __fdiv_rn((float)src[1], 255.0f);
    const float bl = __fdiv_rn((float)src[2], 255.0f);
    const float gh = gains[3 * b], gs = gains[3 * b + 1], gv = gains[3 * b + 2];

    const float cmax = fmaxf(r, fmaxf(g, bl));
    const float cmin = fminf(r, fminf(g, bl));
    const float delta = __fadd_rn(__fsub_rn(cmax, cmin), 1e-12f);
    float h;
    if (cmax == r)
      h = floor_mod(__fdiv_rn(__fsub_rn(g, bl), delta), 6.0f);
    else if (cmax == g)
      h = __fadd_rn(__fdiv_rn(__fsub_rn(bl, r), delta), 2.0f);
    else
      h = __fadd_rn(__fdiv_rn(__fsub_rn(r, g), delta), 4.0f);
    h = __fdiv_rn(h, 6.0f);
    const float s0 = __fdiv_rn(delta, __fadd_rn(cmax, 1e-12f));
    h = floor_mod(__fmul_rn(h, gh), 1.0f);
    const float s = clip01(__fmul_rn(s0, gs));
    const float v = clip01(__fmul_rn(cmax, gv));
    const float h6 = __fmul_rn(h, 6.0f);
    const float c = __fmul_rn(v, s);
    const float xx =
        __fmul_rn(c, __fsub_rn(1.0f, fabsf(__fsub_rn(floor_mod(h6, 2.0f), 1.0f))));
    const float m = __fsub_rn(v, c);
    const float sector = floor_mod(floorf(h6), 6.0f);
    const float z = __fmul_rn(c, 0.0f);

    float* o = out + p * 3;
    o[0] = __fadd_rn(pick(sector, c, xx, z, z, xx, c), m);
    o[1] = __fadd_rn(pick(sector, xx, c, c, xx, z, z), m);
    o[2] = __fadd_rn(pick(sector, z, z, xx, c, c, xx), m);
  }
}

}  // namespace

extern "C" {

// images (B,H,W,3) uint8, gains (B,3) float32, flips (B,2) int32
// [left-right, up-down], out (B,H,W,3) float32: all contiguous. Returns a
// cudaError_t.
int fused_augment_simt(const void* images, const void* gains, const void* flips, void* out,
                       int B, int H, int W, void* stream) {
  const long long total = (long long)B * H * W;
  if (total == 0) return 0;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) blocks = 0x7fffffffLL;
  fused_augment_simt_kernel<<<(unsigned)blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(images), static_cast<const float*>(gains),
      static_cast<const int32_t*>(flips), static_cast<float*>(out), B, H, W);
  return (int)cudaGetLastError();
}

}  // extern "C"
