// DCNv2 backward (3x3, stride 1, padding 1), NHWC: from the output gradient
// g, the gradients of x, offset, mask and weight, with both contractions
// against the weight done inside the kernel: the first design of K2, on the
// CUDA cores ("SIMT K2"). The main path now runs the tensor-core redesign in
// deform_bwd.cu; this kernel stays as its A/B baseline, reached only through
// `ops.cuda_deform.deform_bwd_simt`.
//
// Replaces: mgdt_yolo_tpu/ops/pallas_deform.py, `_bwd_kernel` (called by
// `deform_sample_bwd`) together with the two einsums and the overlap-add of
// its glue `_mdcv2_bwd`. The TPU kernel walks 64 one-hot window slots
// because gathers are slow there, and writes dx as per-row-block slabs that
// are overlap-added afterwards; here each (pixel, tap) reads its four
// bilinear corners directly (deform_common.cuh, the same fields as the
// forward kernel) and dx is scattered with float32 atomicAdd into a zeroed
// buffer, the GPU's form of the overlap-add. What it computes, per tile:
//
//   ds      = round_to_x_type(g . W^T)              (TILE, 9*Cin)
//   sampled = round_to_x_type(sum_q w_q x[corner_q]) (recomputed, for dW)
//   dw_q    = sum_c ds[k, c] * x[corner_q, c]       (warp-shuffle reduction)
//   dx[corner_q, c]  += w_q * ds[k, c]              (atomicAdd)
//   d offset_y = wv * sum_q (+/-) dw_q * ax_q * pass_y, likewise x
//   d mask     = sum_q dw_q * ay_q * ax_q * valid
//   dW      += sampled^T . g                        (per block, then atomicAdd)
//
// with w_q = ay_q * ax_q * wv and wv = mask * valid. See ops/deform.py,
// `modulated_deform_conv2d_plain_bwd`, for the plain PyTorch version this
// kernel is held against.
//
// Bound on this card: memory. Per pixel on the main path (C = 32, bf16) the
// function must read x, offset, mask and g (91 values) and write dx, d
// offset and d mask (59 values), ~300 B, against ~0.04 MFLOP of contraction
// and sampling: far below the ~295 FLOP/B at which the tensor cores would
// become the limit.
//
// Design against that bound: the (TILE, 9*Cin) tap-gradient and sampled
// tiles live only in shared memory, so neither 9x-wide tap tensor reaches
// device memory; the (9*Cin, Cout) weight and this block's dW partial stay
// in shared memory for the whole kernel. Blocks are persistent (one grid of
// about one block per SM walks all tiles), so dW leaves each block once, as
// 9*Cin*Cout atomic adds, instead of once per tile. A warp takes one (pixel,
// tap) at a time with lanes over channels, so its x reads, dx atomics and
// tap-gradient reads are contiguous (NHWC). wgmma, TMA and shared-memory
// accumulation of dx are left for later.
//
// Built by mgdt_yolo_tpu_torch/utils/build.py with nvcc for sm_90a; called
// through ctypes from mgdt_yolo_tpu_torch/ops/cuda_deform.py (`deform_bwd_simt`).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "deform_common.cuh"

namespace {

using deform::from_f32;
using deform::KT;
using deform::round_to;
using deform::to_f32;

constexpr int TILE = 32;      // output pixels per tile
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int NF = 8;         // per-tap floats: ay0 ay1 ax0 ax1 wv pass_y pass_x valid

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__host__ __device__ inline long long smem_floats(int Cin, int Cout) {
  const long long KC = (long long)KT * Cin;
  return KC * (Cout + 1) + KC * Cout + (long long)TILE * Cout + 2LL * TILE * KC +
         (long long)TILE * KT * NF + (long long)TILE * KT * 4;  // last: int corners
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
deform_bwd_kernel(const T* __restrict__ x, const T* __restrict__ offset,
                  const T* __restrict__ mask, const T* __restrict__ weight,
                  const T* __restrict__ grad, float* __restrict__ dx,
                  T* __restrict__ doffset, T* __restrict__ dmask,
                  float* __restrict__ dweight, int B, int H, int W, int Cin, int Cout,
                  int windowed) {
  extern __shared__ float smem[];
  const int KC = KT * Cin;
  const int WS = Cout + 1;                            // padded: no bank conflicts below
  float* w_s = smem;                                  // (KC, WS) weight
  float* dw_s = w_s + KC * WS;                        // (KC, Cout) this block's dW
  float* g_s = dw_s + KC * Cout;                      // (TILE, Cout) output gradient
  float* ds_s = g_s + TILE * Cout;                    // (TILE, KC) tap gradient
  float* s_s = ds_s + TILE * KC;                      // (TILE, KC) sampled taps
  float* f_s = s_s + TILE * KC;                       // (TILE*KT, NF) per-tap fields
  int* i_s = reinterpret_cast<int*>(f_s + TILE * KT * NF);  // (TILE*KT, 4) pixel, -1 = 0

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int P = H * W;
  const int tiles_per_image = (P + TILE - 1) / TILE;
  const int tiles = B * tiles_per_image;

  for (int e = tid; e < KC * Cout; e += THREADS) {
    w_s[(e / Cout) * WS + e % Cout] = to_f32(weight[e]);
    dw_s[e] = 0.f;
  }

  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int b = t / tiles_per_image;
    const int p0 = (t % tiles_per_image) * TILE;
    const int np = min(TILE, P - p0);
    const size_t pix0 = (size_t)b * P + p0;
    __syncthreads();  // the previous tile's readers are done

    for (int e = tid; e < TILE * Cout; e += THREADS)
      g_s[e] = e / Cout < np ? to_f32(grad[pix0 * Cout + e]) : 0.f;

    // fields: one thread per (pixel, tap)
    for (int e = tid; e < TILE * KT; e += THREADS) {
      const int pl = e / KT, k = e % KT;
      float f[NF] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      int ci[4] = {-1, -1, -1, -1};
      if (pl < np) {
        const int p = p0 + pl, i = p / W, j = p % W;
        const size_t pix = pix0 + pl;
        const deform::Tap tp = deform::tap_fields(
            i, j, k, to_f32(offset[pix * (2 * KT) + 2 * k]),
            to_f32(offset[pix * (2 * KT) + 2 * k + 1]), H, W, windowed);
        if (tp.valid) {  // an invalid tap has no gradient and samples 0
          f[0] = 1.f - tp.fy;
          f[1] = tp.fy;
          f[2] = 1.f - tp.fx;
          f[3] = tp.fx;
          f[4] = to_f32(mask[pix * KT + k]);
          f[5] = tp.pass_y ? 1.f : 0.f;
          f[6] = tp.pass_x ? 1.f : 0.f;
          f[7] = 1.f;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int yy = tp.y0 + (q >> 1), xx = tp.x0 + (q & 1);
            if (yy >= 0 && yy < H && xx >= 0 && xx < W) ci[q] = yy * W + xx;
          }
        }
      }
#pragma unroll
      for (int n = 0; n < NF; ++n) f_s[e * NF + n] = f[n];
#pragma unroll
      for (int q = 0; q < 4; ++q) i_s[e * 4 + q] = ci[q];
    }
    __syncthreads();

    // tap gradient ds = g . W^T, rounded to x's type as the JAX glue does
    for (int e = tid; e < np * KC; e += THREADS) {
      const int pl = e / KC, r = e % KC;
      const float* gp = g_s + pl * Cout;
      const float* wr = w_s + r * WS;
      float acc = 0.f;
      for (int o = 0; o < Cout; ++o) acc += gp[o] * wr[o];
      ds_s[e] = round_to<T>(acc);
    }
    __syncthreads();

    // corners: one warp per (pixel, tap), lanes over channels
    const T* xb = x + (size_t)b * P * Cin;
    float* dxb = dx + (size_t)b * P * Cin;
    for (int e = warp; e < np * KT; e += WARPS) {
      const int pl = e / KT, k = e % KT;
      const float* f = f_s + e * NF;
      const int* ci = i_s + e * 4;
      float wq[4], part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int q = 0; q < 4; ++q) wq[q] = f[q >> 1] * f[2 + (q & 1)] * f[4];
      const float* dsp = ds_s + pl * KC + k * Cin;
      float* sp = s_s + pl * KC + k * Cin;
      for (int c = lane; c < Cin; c += 32) {
        const float d = dsp[c];
        float s = 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (ci[q] < 0) continue;
          const float xv = to_f32(xb[(size_t)ci[q] * Cin + c]);
          part[q] += d * xv;
          s += wq[q] * xv;
          if (wq[q] != 0.f) atomicAdd(dxb + (size_t)ci[q] * Cin + c, wq[q] * d);
        }
        sp[c] = round_to<T>(s);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) part[q] = warp_sum(part[q]);
      if (lane == 0) {
        const float ay0 = f[0], ay1 = f[1], ax0 = f[2], ax1 = f[3], wv = f[4];
        const float dfy = wv * ((part[2] * ax0 + part[3] * ax1) - (part[0] * ax0 + part[1] * ax1));
        const float dfx = wv * ((part[1] * ay0 + part[3] * ay1) - (part[0] * ay0 + part[2] * ay1));
        const float dwv = part[0] * ay0 * ax0 + part[1] * ay0 * ax1 +
                          part[2] * ay1 * ax0 + part[3] * ay1 * ax1;
        const size_t pix = pix0 + pl;
        doffset[pix * (2 * KT) + 2 * k] = from_f32<T>(dfy * f[5]);
        doffset[pix * (2 * KT) + 2 * k + 1] = from_f32<T>(dfx * f[6]);
        dmask[pix * KT + k] = from_f32<T>(dwv * f[7]);
      }
    }
    __syncthreads();

    // dW += sampled^T . g over this tile; each thread owns its entries
    for (int e = tid; e < KC * Cout; e += THREADS) {
      const int r = e / Cout, o = e % Cout;
      float acc = 0.f;
      for (int pl = 0; pl < np; ++pl) acc += s_s[pl * KC + r] * g_s[pl * Cout + o];
      dw_s[e] += acc;
    }
  }
  __syncthreads();
  for (int e = tid; e < KC * Cout; e += THREADS) atomicAdd(dweight + e, dw_s[e]);
}

template <typename T>
int launch(const void* x, const void* offset, const void* mask, const void* weight,
           const void* grad, float* dx, void* doffset, void* dmask, float* dweight,
           int B, int H, int W, int Cin, int Cout, int windowed, cudaStream_t stream) {
  const size_t smem = (size_t)smem_floats(Cin, Cout) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      deform_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
      cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, deform_bwd_kernel<T>,
                                                           THREADS, smem)) != cudaSuccess)
    return (int)err;
  const long long tiles = (long long)B * ((H * W + TILE - 1) / TILE);
  const long long blocks = tiles < (long long)sms * per_sm ? tiles : (long long)sms * per_sm;
  if (blocks < 1) return (int)cudaErrorInvalidConfiguration;
  deform_bwd_kernel<T><<<(unsigned)blocks, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(offset), static_cast<const T*>(mask),
      static_cast<const T*>(weight), static_cast<const T*>(grad), dx,
      static_cast<T*>(doffset), static_cast<T*>(dmask), dweight, B, H, W, Cin, Cout,
      windowed);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one block needs for these channel counts, in bytes.
long long deform_bwd_simt_smem_bytes(int Cin, int Cout) { return smem_floats(Cin, Cout) * 4; }

// x (B,H,W,Cin), offset (B,H,W,18), mask (B,H,W,9), weight (3,3,Cin,Cout) and
// grad (B,H,W,Cout): contiguous, all float32 (is_bf16 = 0) or all bf16
// (is_bf16 = 1). Outputs: dx float32 (B,H,W,Cin) and dweight float32
// (3,3,Cin,Cout), both zeroed by the caller (accumulated atomically);
// doffset and dmask in the inputs' type, fully written. Returns a cudaError_t.
int deform_bwd_simt(const void* x, const void* offset, const void* mask, const void* weight,
               const void* grad, void* dx, void* doffset, void* dmask, void* dweight,
               int B, int H, int W, int Cin, int Cout, int windowed, int is_bf16,
               void* stream) {
  float* dxf = static_cast<float*>(dx);
  float* dwf = static_cast<float*>(dweight);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(x, offset, mask, weight, grad, dxf, doffset, dmask, dwf, B,
                                 H, W, Cin, Cout, windowed, s);
  return launch<float>(x, offset, mask, weight, grad, dxf, doffset, dmask, dwf, B, H, W, Cin,
                       Cout, windowed, s);
}

}  // extern "C"
