// DCNv2 forward (3x3, stride 1, padding 1), NHWC, with the contraction
// against the weight done inside the kernel: the first design of K1, on the
// CUDA cores ("SIMT K1"). The main path now runs the tensor-core redesign in
// deform_fwd.cu; this kernel stays as its A/B baseline and as the float32
// order that the K1 variants (deform_fwd_variants.cu) are held to bit for
// bit, reached only through `ops.cuda_deform.deform_fwd_simt`.
//
// Replaces: mgdt_yolo_tpu/ops/pallas_deform.py, `_kernel_fused` (called by
// `modulated_deform_conv2d_pallas`). The TPU kernel walks 36 one-hot window
// slots per tap because gathers are slow there; Hopper gathers well, so each
// (pixel, tap) here computes its four bilinear corners once and reads them
// directly. One flag selects the semantics: windowed (floor clamped per tap
// to [i-3+ty, i+1+ty], fraction clipped to [0, 1]) or exact (unbounded).
// Both scale a sample by mask * valid, with valid taken on the unclamped
// position, and read 0 outside the image. See ops/deform.py for the plain
// PyTorch version this kernel is held against.
//
// Bound on this card: memory. Per image on the main path (80x80, C = 32,
// bf16) the kernel must move 80*80*(32 + 18 + 9 + 32)*2 B ~ 1.2 MB (x,
// offset, mask in, output out) against ~0.12 GFLOP of contraction
// (2 * 6400 * 288 * 32), far below the ~295 FLOP/B the tensor cores need
// before they, and not the memory, become the limit.
//
// Design against that bound: x, offset and mask are read once from device
// memory per block that needs them (neighbouring blocks share rows through
// L2); the (tile, 9*Cin) sampled tile and the (9*Cin, Cout) weight live only
// in shared memory, so the 9x-larger tap tensor never reaches device memory,
// and only the (tile, Cout) output is written. Threads of a warp gather
// consecutive channels of one corner (NHWC keeps them contiguous), and in the
// contraction a warp shares one sampled row (broadcast) and reads
// consecutive weight columns. wgmma, TMA and pipelining are left for later.
//
// Built by mgdt_yolo_tpu_torch/utils/build.py with nvcc for sm_90a; called
// through ctypes from mgdt_yolo_tpu_torch/ops/cuda_deform.py (`deform_fwd_simt`).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "deform_common.cuh"

namespace {

using deform::from_f32;
using deform::KT;
using deform::to_f32;

constexpr int TILE = 32;      // output pixels per block
constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
deform_fwd_kernel(const T* __restrict__ x, const T* __restrict__ offset,
                  const T* __restrict__ mask, const T* __restrict__ weight,
                  const float* __restrict__ bias, T* __restrict__ out,
                  int H, int W, int Cin, int Cout, int windowed) {
  extern __shared__ float smem[];
  const int KC = KT * Cin;
  float* w_s = smem;                                  // (KC, Cout)
  float* s_s = w_s + KC * Cout;                       // (TILE, KC) sampled taps
  float* c_w = s_s + TILE * KC;                       // (TILE*KT, 4) corner weights
  int* c_i = reinterpret_cast<int*>(c_w + TILE * KT * 4);  // (TILE*KT, 4) pixel, -1 = 0

  const int b = blockIdx.y;
  const int P = H * W;
  const int p0 = blockIdx.x * TILE;
  const int np = min(TILE, P - p0);

  for (int e = threadIdx.x; e < KC * Cout; e += THREADS) w_s[e] = to_f32(weight[e]);

  // fields: one thread per (pixel, tap)
  for (int e = threadIdx.x; e < TILE * KT; e += THREADS) {
    const int pl = e / KT, k = e % KT;
    float cw[4] = {0.f, 0.f, 0.f, 0.f};
    int ci[4] = {-1, -1, -1, -1};
    if (pl < np) {
      const int p = p0 + pl, i = p / W, j = p % W;
      const size_t pix = (size_t)b * P + p;
      const float m = to_f32(mask[pix * KT + k]);
      const deform::Tap t = deform::tap_fields(i, j, k, to_f32(offset[pix * (2 * KT) + 2 * k]),
                                               to_f32(offset[pix * (2 * KT) + 2 * k + 1]),
                                               H, W, windowed);
      const float wv = t.valid ? m : 0.f;
      if (wv != 0.f) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int dy = q >> 1, dx = q & 1;
          const int yy = t.y0 + dy, xx = t.x0 + dx;
          if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
            ci[q] = yy * W + xx;
            cw[q] = (dy ? t.fy : 1.f - t.fy) * (dx ? t.fx : 1.f - t.fx) * wv;
          }
        }
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      c_w[e * 4 + q] = cw[q];
      c_i[e * 4 + q] = ci[q];
    }
  }
  __syncthreads();

  // gather: one thread per (pixel, tap, channel), channels fastest
  const T* xb = x + (size_t)b * P * Cin;
  for (int e = threadIdx.x; e < TILE * KC; e += THREADS) {
    const int pl = e / KC, r = e % KC;
    const int k = r / Cin, c = r % Cin;
    const int f = (pl * KT + k) * 4;
    float acc = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int src = c_i[f + q];
      if (src >= 0) acc += c_w[f + q] * to_f32(xb[(size_t)src * Cin + c]);
    }
    s_s[e] = acc;
  }
  __syncthreads();

  // contraction with the weight: one thread per (pixel, output channel)
  for (int e = threadIdx.x; e < np * Cout; e += THREADS) {
    const int pl = e / Cout, o = e % Cout;
    const float* sp = s_s + pl * KC;
    float acc = 0.f;
    for (int r = 0; r < KC; ++r) acc += sp[r] * w_s[r * Cout + o];
    if (bias != nullptr) acc += bias[o];
    out[((size_t)b * P + p0 + pl) * Cout + o] = from_f32<T>(acc);
  }
}

template <typename T>
int launch(const void* x, const void* offset, const void* mask, const void* weight,
           const float* bias, void* out, int B, int H, int W, int Cin, int Cout,
           int windowed, cudaStream_t stream) {
  const size_t KC = (size_t)KT * Cin;
  const size_t smem = (KC * Cout + TILE * KC + (size_t)TILE * KT * 4) * sizeof(float) +
                      (size_t)TILE * KT * 4 * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      deform_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((H * W + TILE - 1) / TILE, B);
  deform_fwd_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(offset), static_cast<const T*>(mask),
      static_cast<const T*>(weight), bias, static_cast<T*>(out), H, W, Cin, Cout, windowed);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one block needs for these channel counts, in bytes.
long long deform_fwd_simt_smem_bytes(int Cin, int Cout) {
  const long long KC = (long long)KT * Cin;
  return (KC * Cout + TILE * KC + (long long)TILE * KT * 4) * 4 + (long long)TILE * KT * 4 * 4;
}

// x (B,H,W,Cin), offset (B,H,W,18), mask (B,H,W,9), weight (3,3,Cin,Cout),
// out (B,H,W,Cout): all contiguous, all float32 (is_bf16 = 0) or all bf16
// (is_bf16 = 1). bias is float32 (Cout,) or null. Returns a cudaError_t.
int deform_fwd_simt(const void* x, const void* offset, const void* mask, const void* weight,
               const void* bias, void* out, int B, int H, int W, int Cin, int Cout,
               int windowed, int is_bf16, void* stream) {
  const float* b = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(x, offset, mask, weight, b, out, B, H, W, Cin, Cout,
                                 windowed, s);
  return launch<float>(x, offset, mask, weight, b, out, B, H, W, Cin, Cout, windowed, s);
}

}  // extern "C"
