// Five variants of the DCNv2 forward (K1, csrc/deform_fwd.cu), 3x3, stride 1,
// padding 1, NHWC, windowed semantics only. Each is the Hopper counterpart of
// one TPU prototype that tested a schedule of K1's function against K1 at the
// flagship's DCN shape (80x80, C = 32):
//
//   V1 deform_fwd_bf16_fma_simt  tools/proto_deform_bf16_fma.py `variant`
//                                (`_kernel_bf16`)
//   V2 deform_fwd_qxhoist_simt  tools/proto_deform_qxhoist.py `deform_qxhoist`
//                               (`_kernel_fused_qxhoist`)
//   V3 deform_fwd_cvt1_simt     tools/proto_deform_qxhoist.py `deform_cvt1`
//                               (`_kernel_fused_cvt1`)
//   V4 deform_fwd_slot_skip_simt  tools/proto_deform_slot_skip.py `variant`
//                                 (`_kernel_skip`)
//   V5 deform_fwd_tapwalk_simt    tools/proto_deform_tapwalk.py `variant`
//                                 (`_kernel_tap`)
//
// All five here are their first designs, on the CUDA cores; their Hopper
// designs are K1's tensor-core contraction fed from a ring of input rows (V2
// and V3, deform_fwd_slab.cu, behind `deform_fwd_qxhoist` and
// `deform_fwd_cvt1`), with dead work skipped, the taps walked outermost or
// the bf16 corner products fed to the tensor cores as they are (V4, V5 and
// V1, deform_fwd_tc_variants.cu, behind `deform_fwd_slot_skip`,
// `deform_fwd_tapwalk` and `deform_fwd_bf16_fma`). These stay as their A/B
// baseline (the `_simt` names).
//
// The TPU prototypes walk one-hot window slots because gathers are slow
// there; none of that walk is carried over. Each variant keeps K1's gather of
// four bilinear corners per (pixel, tap) and changes one thing, the
// prototype's idea in Hopper's terms:
//
//   V1: packed bf16 arithmetic. A corner weight is rounded to bf16 and
//       broadcast, a thread multiplies a pair of channels with one __hmul2
//       (round to nearest), the products are widened and summed in float32
//       with __fadd_rn, so nvcc cannot fuse them into __hfma2; bf16 x needs
//       an even Cin and 4-byte alignment. float32 x: a scalar loop with the
//       same rounding (bf16 weight, float32 product, float32 add). V1
//       computes its own function; its plain version is
//       ops/deform_variants.py `deform_bf16_fma_plain`.
//   V2: the data-movement hoist. A block owns RB output rows of one image and
//       stages their input slab once in shared memory, in x's type: rows
//       r0-3 .. r0+RB+3 by columns -3 .. W+3 (the windowed reach plus the +1
//       corner), zero outside the image, (RB+7) x (W+7) x Cin, the TPU's
//       2*RB-row slab of `_pad_cf`. Every gather then reads shared memory.
//       RB is 8 for a bf16 slab and 4 for a float32 one, so that the slab,
//       K1's float32 weight and sampled tile fit at the flagship's 80x80,
//       C 32 (a float32 slab of 8 rows would take 167 KB of the 227 KB).
//   V3: V2 with the slab converted to float32 once, at staging.
//   V4: dead work skipped at run time. A corner whose weight is exactly 0
//       (fy or fx exactly 0 or 1 after the clip, or wv 0) issues no load, and
//       a (pixel, tap) with no live corner is skipped as a whole in the
//       contraction, from flags the fields set (one pixel per warp at
//       Cout = 32, so the branch is warp-uniform there); a pixel with all nine
//       taps live runs K1's contraction loop as it is.
//   V5: the per-tap contraction. A block samples one tap's (TILE, Cin) slice
//       into shared memory, contracts it with that tap's (Cin, Cout) weight
//       slice, and carries the (TILE, Cout) sums in registers over the 9 taps:
//       its shared tile is 9x smaller than K1's (TILE, 9*Cin), and at C = 64
//       six blocks fit on an SM by shared memory where K1 fits one.
//
// V2-V5 compute K1's function and keep K1's order of every float32 sum:
// corners in the order (0,0), (0,1), (1,0), (1,1) from 0, then the
// contraction over r = k*Cin + c from 0, then the bias. So on finite inputs
// each gives K1's bits: a skipped term of V4 is a product with an exact 0,
// which leaves a float32 sum that started at +0 unchanged (with an infinite
// or NaN input, 0 * inf would have been NaN, so the claim holds for finite
// inputs only). chip_smoke.py holds V4 and V5 here bitwise to the SIMT K1.
//
// Bound on this card: memory, as K1's (the same inputs read and the same
// output written; see deform_fwd.cu).
//
// Built by mgdt_yolo_tpu_torch/utils/build.py with nvcc for sm_90a; called
// through ctypes from mgdt_yolo_tpu_torch/ops/cuda_deform_variants.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "deform_common.cuh"

namespace {

using deform::from_f32;
using deform::KT;
using deform::to_f32;

constexpr int TILE = 32;           // output pixels per block (per sub-tile in V2/V3)
constexpr int THREADS = 256;
constexpr int SLAB_THREADS = 512;  // V2/V3: one large block per SM
constexpr int MAX_ACC = 16;        // V5: outputs a thread carries over the taps
constexpr long long MAX_SMEM = 232448;

// K1's shared memory: weight (KC, Cout), sampled tile (TILE, KC), corner
// weights and indices (TILE*KT, 4) each.
long long k1_smem(int Cin, int Cout) {
  const long long KC = (long long)KT * Cin;
  return (KC * Cout + TILE * KC + (long long)TILE * KT * 4) * 4 + (long long)TILE * KT * 4 * 4;
}

// K1's fields of tap k of output pixel (i, j), `pix` its flat index over the
// batch: the four corner weights, (ay * ax) * wv as K1 computes them, and the
// corners' indices (yy - y0) * stride + (xx - x0) in the layout the gather
// reads (K1's: the image, y0 = x0 = 0, stride W), -1 where the corner lies
// outside the image or wv is 0 (the corner then adds nothing).
template <typename T>
__device__ __forceinline__ void k1_corners(const T* __restrict__ offset,
                                           const T* __restrict__ mask, size_t pix, int i,
                                           int j, int k, int H, int W, int y0, int x0,
                                           int stride, float cw[4], int ci[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    cw[q] = 0.f;
    ci[q] = -1;
  }
  const float m = to_f32(mask[pix * KT + k]);
  const deform::Tap t = deform::tap_fields(i, j, k, to_f32(offset[pix * (2 * KT) + 2 * k]),
                                           to_f32(offset[pix * (2 * KT) + 2 * k + 1]), H, W, 1);
  const float wv = t.valid ? m : 0.f;
  if (wv != 0.f) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int dy = q >> 1, dx = q & 1;
      const int yy = t.y0 + dy, xx = t.x0 + dx;
      if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
        ci[q] = (yy - y0) * stride + (xx - x0);
        cw[q] = (dy ? t.fy : 1.f - t.fy) * (dx ? t.fx : 1.f - t.fx) * wv;
      }
    }
  }
}

// Fields of the tile's pixels [p0, p0 + np) of image b, one thread per
// (pixel, tap), into c_w / c_i (TILE*KT, 4), the indices in the layout
// (y0, x0, stride) of k1_corners. SKIP_ZERO drops corners whose weight is
// exactly 0 and marks in tap_live (TILE*KT) the (pixel, tap) pairs with a
// corner left (V4); ROUND_BF16 rounds each weight to bf16 (V1).
template <typename T, bool SKIP_ZERO, bool ROUND_BF16>
__device__ __forceinline__ void tile_fields(const T* __restrict__ offset,
                                            const T* __restrict__ mask, int b, int p0, int np,
                                            int H, int W, int y0, int x0, int stride,
                                            float* c_w, int* c_i,
                                            unsigned char* tap_live = nullptr) {
  for (int e = threadIdx.x; e < TILE * KT; e += blockDim.x) {
    const int pl = e / KT, k = e % KT;
    float cw[4] = {0.f, 0.f, 0.f, 0.f};
    int ci[4] = {-1, -1, -1, -1};
    if (pl < np) {
      const int p = p0 + pl;
      k1_corners(offset, mask, (size_t)b * H * W + p, p / W, p % W, k, H, W, y0, x0, stride,
                 cw, ci);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (SKIP_ZERO && cw[q] == 0.f) ci[q] = -1;
      c_w[e * 4 + q] = ROUND_BF16 ? deform::round_to<__nv_bfloat16>(cw[q]) : cw[q];
      c_i[e * 4 + q] = ci[q];
    }
    if constexpr (SKIP_ZERO)
      tap_live[e] = ci[0] >= 0 || ci[1] >= 0 || ci[2] >= 0 || ci[3] >= 0;
  }
}

// K1's contraction of the sampled tile (np, KC) with the weight (KC, Cout),
// one thread per (pixel, output channel); writes out[p0 + pixel].
template <typename T>
__device__ __forceinline__ void k1_contract(const float* s_s, const float* w_s,
                                            const float* __restrict__ bias, T* __restrict__ out,
                                            size_t out_pix0, int np, int KC, int Cout) {
  for (int e = threadIdx.x; e < np * Cout; e += blockDim.x) {
    const int pl = e / Cout, o = e % Cout;
    const float* sp = s_s + pl * KC;
    float acc = 0.f;
    for (int r = 0; r < KC; ++r) acc += sp[r] * w_s[r * Cout + o];
    if (bias != nullptr) acc += bias[o];
    out[(out_pix0 + pl) * Cout + o] = from_f32<T>(acc);
  }
}

// ---------------------------------------------------------------- V1

template <typename T>
__global__ void __launch_bounds__(THREADS)
bf16_fma_kernel(const T* __restrict__ x, const T* __restrict__ offset,
                const T* __restrict__ mask, const T* __restrict__ weight,
                const float* __restrict__ bias, T* __restrict__ out, int H, int W, int Cin,
                int Cout) {
  extern __shared__ float smem[];
  const int KC = KT * Cin;
  float* w_s = smem;
  float* s_s = w_s + KC * Cout;
  float* c_w = s_s + TILE * KC;
  int* c_i = reinterpret_cast<int*>(c_w + TILE * KT * 4);

  const int b = blockIdx.y;
  const int P = H * W;
  const int p0 = blockIdx.x * TILE;
  const int np = min(TILE, P - p0);

  for (int e = threadIdx.x; e < KC * Cout; e += THREADS) w_s[e] = to_f32(weight[e]);
  tile_fields<T, false, true>(offset, mask, b, p0, np, H, W, 0, 0, W, c_w, c_i);
  __syncthreads();

  const T* xb = x + (size_t)b * P * Cin;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    // a thread per (pixel, tap, channel pair): one __hmul2 per corner (Cin
    // even and x 4-byte aligned, which the launch checks)
    const int CP = Cin / 2;
    for (int e = threadIdx.x; e < TILE * KT * CP; e += THREADS) {
      const int pl = e / (KT * CP), r = e % (KT * CP);
      const int k = r / CP, cp = r % CP;
      const int f = (pl * KT + k) * 4;
      float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int src = c_i[f + q];
        if (src >= 0) {
          const __nv_bfloat162 w2 = __bfloat162bfloat162(__float2bfloat16(c_w[f + q]));
          const __nv_bfloat162 x2 =
              reinterpret_cast<const __nv_bfloat162*>(xb + (size_t)src * Cin)[cp];
          const float2 p = __bfloat1622float2(__hmul2(w2, x2));
          acc0 = __fadd_rn(acc0, p.x);
          acc1 = __fadd_rn(acc1, p.y);
        }
      }
      s_s[pl * KC + k * Cin + 2 * cp] = acc0;
      s_s[pl * KC + k * Cin + 2 * cp + 1] = acc1;
    }
  } else {
    // float32 x: the bf16 weight times x in float32, rounded, then added
    for (int e = threadIdx.x; e < TILE * KC; e += THREADS) {
      const int pl = e / KC, r = e % KC;
      const int k = r / Cin, c = r % Cin;
      const int f = (pl * KT + k) * 4;
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int src = c_i[f + q];
        if (src >= 0) acc = __fadd_rn(acc, __fmul_rn(c_w[f + q], xb[(size_t)src * Cin + c]));
      }
      s_s[e] = acc;
    }
  }
  __syncthreads();
  k1_contract(s_s, w_s, bias, out, (size_t)b * P + p0, np, KC, Cout);
}

// ---------------------------------------------------------------- V2, V3

// S is the slab's type: T for V2, float for V3.
template <typename S, typename T>
__device__ __forceinline__ S slab_value(T v) {
  if constexpr (std::is_same<S, T>::value) {
    return v;
  } else {
    return to_f32(v);
  }
}

// Output rows per block: 8 for a bf16 slab, 4 for a float32 one.
constexpr int slab_rows(int slab_esize) { return slab_esize == 2 ? 8 : 4; }

long long slab_smem(int W, int Cin, int Cout, int slab_esize) {
  return k1_smem(Cin, Cout) +
         (long long)(slab_rows(slab_esize) + 7) * (W + 7) * Cin * slab_esize;
}

template <typename T, typename S>
__global__ void __launch_bounds__(SLAB_THREADS)
slab_kernel(const T* __restrict__ x, const T* __restrict__ offset, const T* __restrict__ mask,
            const T* __restrict__ weight, const float* __restrict__ bias, T* __restrict__ out,
            int H, int W, int Cin, int Cout, int RB) {
  extern __shared__ float smem[];
  const int KC = KT * Cin;
  float* w_s = smem;
  float* s_s = w_s + KC * Cout;
  float* c_w = s_s + TILE * KC;
  int* c_i = reinterpret_cast<int*>(c_w + TILE * KT * 4);
  S* slab = reinterpret_cast<S*>(c_i + TILE * KT * 4);  // (RB+7, W+7, Cin)

  const int b = blockIdx.y;
  const int r0 = blockIdx.x * RB;
  const int SW = W + 7;
  const int P = H * W;
  const T* xb = x + (size_t)b * P * Cin;

  for (int e = threadIdx.x; e < KC * Cout; e += SLAB_THREADS) w_s[e] = to_f32(weight[e]);
  const int n_slab = (RB + 7) * SW * Cin;
  for (int e = threadIdx.x; e < n_slab; e += SLAB_THREADS) {
    const int c = e % Cin, s = e / Cin;
    const int yy = r0 - 3 + s / SW, xx = s % SW - 3;
    slab[e] = (yy >= 0 && yy < H && xx >= 0 && xx < W)
                  ? slab_value<S>(xb[((size_t)yy * W + xx) * Cin + c])
                  : from_f32<S>(0.f);
  }

  const int p_end = min(r0 + RB, H) * W;
  for (int p0 = r0 * W; p0 < p_end; p0 += TILE) {
    const int np = min(TILE, p_end - p0);
    // corner indices into the slab, whose origin is pixel (r0 - 3, -3)
    tile_fields<T, false, false>(offset, mask, b, p0, np, H, W, r0 - 3, -3, SW, c_w, c_i);
    __syncthreads();  // also orders the slab and weight stores before the gathers
    for (int e = threadIdx.x; e < TILE * KC; e += SLAB_THREADS) {
      const int pl = e / KC, r = e % KC;
      const int k = r / Cin, c = r % Cin;
      const int f = (pl * KT + k) * 4;
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int src = c_i[f + q];
        if (src >= 0) acc += c_w[f + q] * to_f32(slab[(size_t)src * Cin + c]);
      }
      s_s[e] = acc;
    }
    __syncthreads();
    k1_contract(s_s, w_s, bias, out, (size_t)b * P + p0, np, KC, Cout);
    __syncthreads();  // the next sub-tile overwrites the fields and the tile
  }
}

// ---------------------------------------------------------------- V4

template <typename T>
__global__ void __launch_bounds__(THREADS)
slot_skip_kernel(const T* __restrict__ x, const T* __restrict__ offset,
                 const T* __restrict__ mask, const T* __restrict__ weight,
                 const float* __restrict__ bias, T* __restrict__ out, int H, int W, int Cin,
                 int Cout) {
  extern __shared__ float smem[];
  const int KC = KT * Cin;
  float* w_s = smem;
  float* s_s = w_s + KC * Cout;
  float* c_w = s_s + TILE * KC;
  int* c_i = reinterpret_cast<int*>(c_w + TILE * KT * 4);
  unsigned char* tap_live = reinterpret_cast<unsigned char*>(c_i + TILE * KT * 4);

  const int b = blockIdx.y;
  const int P = H * W;
  const int p0 = blockIdx.x * TILE;
  const int np = min(TILE, P - p0);

  for (int e = threadIdx.x; e < KC * Cout; e += THREADS) w_s[e] = to_f32(weight[e]);
  tile_fields<T, true, false>(offset, mask, b, p0, np, H, W, 0, 0, W, c_w, c_i, tap_live);
  __syncthreads();

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

  // K1's contraction, less the taps with no live corner: their samples are
  // +0, and acc += +0 * w leaves acc as it was. A pixel whose nine taps are
  // all live (almost every pixel off the border) runs K1's loop as it is.
  for (int e = threadIdx.x; e < np * Cout; e += THREADS) {
    const int pl = e / Cout, o = e % Cout;
    const float* sp = s_s + pl * KC;
    unsigned live = 0;
    for (int k = 0; k < KT; ++k) live |= (unsigned)tap_live[pl * KT + k] << k;
    float acc = 0.f;
    if (live == (1u << KT) - 1) {
      for (int r = 0; r < KC; ++r) acc += sp[r] * w_s[r * Cout + o];
    } else {
      for (int k = 0; k < KT; ++k) {
        if (!((live >> k) & 1u)) continue;
        for (int c = 0; c < Cin; ++c) {
          const int r = k * Cin + c;
          acc += sp[r] * w_s[r * Cout + o];
        }
      }
    }
    if (bias != nullptr) acc += bias[o];
    out[((size_t)b * P + p0 + pl) * Cout + o] = from_f32<T>(acc);
  }
}

// ---------------------------------------------------------------- V5

long long tapwalk_smem(int Cin, int Cout) {
  if ((long long)TILE * Cout > (long long)THREADS * MAX_ACC) return -1;
  return ((long long)Cin * Cout + TILE * Cin + (long long)TILE * KT * 4) * 4 +
         (long long)TILE * KT * 4 * 4;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
tapwalk_kernel(const T* __restrict__ x, const T* __restrict__ offset,
               const T* __restrict__ mask, const T* __restrict__ weight,
               const float* __restrict__ bias, T* __restrict__ out, int H, int W, int Cin,
               int Cout) {
  extern __shared__ float smem[];
  float* w_s = smem;                    // (Cin, Cout): this tap's weight slice
  float* s_s = w_s + Cin * Cout;        // (TILE, Cin): this tap's samples
  float* c_w = s_s + TILE * Cin;
  int* c_i = reinterpret_cast<int*>(c_w + TILE * KT * 4);

  const int b = blockIdx.y;
  const int P = H * W;
  const int p0 = blockIdx.x * TILE;
  const int np = min(TILE, P - p0);
  const int n_out = np * Cout;

  tile_fields<T, false, false>(offset, mask, b, p0, np, H, W, 0, 0, W, c_w, c_i);

  const T* xb = x + (size_t)b * P * Cin;
  float acc[MAX_ACC];
#pragma unroll
  for (int a = 0; a < MAX_ACC; ++a) acc[a] = 0.f;

  for (int k = 0; k < KT; ++k) {
    const T* wk = weight + (size_t)k * Cin * Cout;
    for (int e = threadIdx.x; e < Cin * Cout; e += THREADS) w_s[e] = to_f32(wk[e]);
    __syncthreads();  // the fields (first tap) and the last tap's contraction are done
    for (int e = threadIdx.x; e < TILE * Cin; e += THREADS) {
      const int pl = e / Cin, c = e % Cin;
      const int f = (pl * KT + k) * 4;
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int src = c_i[f + q];
        if (src >= 0) s += c_w[f + q] * to_f32(xb[(size_t)src * Cin + c]);
      }
      s_s[e] = s;
    }
    __syncthreads();
#pragma unroll
    for (int a = 0; a < MAX_ACC; ++a) {
      const int e = threadIdx.x + a * THREADS;
      if (e < n_out) {
        const int pl = e / Cout, o = e % Cout;
        const float* sp = s_s + pl * Cin;
        for (int c = 0; c < Cin; ++c) acc[a] += sp[c] * w_s[c * Cout + o];
      }
    }
    __syncthreads();  // the next tap overwrites the weight slice and the samples
  }
#pragma unroll
  for (int a = 0; a < MAX_ACC; ++a) {
    const int e = threadIdx.x + a * THREADS;
    if (e < n_out) {
      const int pl = e / Cout, o = e % Cout;
      float v = acc[a];
      if (bias != nullptr) v += bias[o];
      out[((size_t)b * P + p0 + pl) * Cout + o] = from_f32<T>(v);
    }
  }
}

// ---------------------------------------------------------------- launch

enum Variant { BF16_FMA, QXHOIST, CVT1, SLOT_SKIP, TAPWALK };

long long smem_bytes(Variant v, int W, int Cin, int Cout, int is_bf16) {
  switch (v) {
    case QXHOIST:
      return slab_smem(W, Cin, Cout, is_bf16 ? 2 : 4);
    case CVT1:
      return slab_smem(W, Cin, Cout, 4);
    case TAPWALK:
      return tapwalk_smem(Cin, Cout);
    case SLOT_SKIP:
      return k1_smem(Cin, Cout) + TILE * KT;  // and the live-tap flags
    case BF16_FMA:
      return is_bf16 && Cin % 2 ? -1 : k1_smem(Cin, Cout);  // bf16: channel pairs
    default:
      return k1_smem(Cin, Cout);
  }
}

template <typename K, typename... Args>
int launch_kernel(K kernel, dim3 grid, int threads, long long smem, cudaStream_t stream,
                  Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(Variant v, const void* x_, const void* offset_, const void* mask_,
           const void* weight_, const float* bias, void* out_, int B, int H, int W, int Cin,
           int Cout, cudaStream_t stream) {
  const T* x = static_cast<const T*>(x_);
  const T* offset = static_cast<const T*>(offset_);
  const T* mask = static_cast<const T*>(mask_);
  const T* weight = static_cast<const T*>(weight_);
  T* out = static_cast<T*>(out_);
  const long long smem = smem_bytes(v, W, Cin, Cout, std::is_same<T, __nv_bfloat16>::value);
  if (smem < 0 || smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  const dim3 tiles((H * W + TILE - 1) / TILE, B);
  switch (v) {
    case BF16_FMA:
      if (std::is_same<T, __nv_bfloat16>::value && reinterpret_cast<uintptr_t>(x) % 4 != 0)
        return (int)cudaErrorMisalignedAddress;
      return launch_kernel(bf16_fma_kernel<T>, tiles, THREADS, smem, stream, x, offset, mask,
                           weight, bias, out, H, W, Cin, Cout);
    case QXHOIST: {
      const int RB = slab_rows(sizeof(T));
      return launch_kernel(slab_kernel<T, T>, dim3((H + RB - 1) / RB, B), SLAB_THREADS, smem,
                           stream, x, offset, mask, weight, bias, out, H, W, Cin, Cout, RB);
    }
    case CVT1: {
      const int RB = slab_rows(4);
      return launch_kernel(slab_kernel<T, float>, dim3((H + RB - 1) / RB, B), SLAB_THREADS,
                           smem, stream, x, offset, mask, weight, bias, out, H, W, Cin, Cout,
                           RB);
    }
    case SLOT_SKIP:
      return launch_kernel(slot_skip_kernel<T>, tiles, THREADS, smem, stream, x, offset, mask,
                           weight, bias, out, H, W, Cin, Cout);
    case TAPWALK:
      return launch_kernel(tapwalk_kernel<T>, tiles, THREADS, smem, stream, x, offset, mask,
                           weight, bias, out, H, W, Cin, Cout);
  }
  return (int)cudaErrorInvalidValue;
}

int run(Variant v, const void* x, const void* offset, const void* mask, const void* weight,
        const void* bias, void* out, int B, int H, int W, int Cin, int Cout, int windowed,
        int is_bf16, void* stream) {
  if (!windowed) return (int)cudaErrorInvalidValue;  // windowed semantics only
  const float* bs = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(v, x, offset, mask, weight, bs, out, B, H, W, Cin, Cout, s);
  return launch<float>(v, x, offset, mask, weight, bs, out, B, H, W, Cin, Cout, s);
}

}  // namespace

// Each variant: x (B,H,W,Cin), offset (B,H,W,18), mask (B,H,W,9), weight
// (3,3,Cin,Cout), out (B,H,W,Cout), all contiguous, all float32 (is_bf16 = 0)
// or all bf16 (is_bf16 = 1); bias float32 (Cout,) or null; windowed must be
// 1. Returns a cudaError_t. `<name>_smem_bytes(W, Cin, Cout, is_bf16)` is the
// shared memory one block needs, or -1 where the variant does not take the
// channel counts.
#define VARIANT_ENTRY(name, v)                                                               \
  extern "C" int name(const void* x, const void* offset, const void* mask,                  \
                      const void* weight, const void* bias, void* out, int B, int H, int W, \
                      int Cin, int Cout, int windowed, int is_bf16, void* stream) {         \
    return run(v, x, offset, mask, weight, bias, out, B, H, W, Cin, Cout, windowed,         \
               is_bf16, stream);                                                            \
  }                                                                                          \
  extern "C" long long name##_smem_bytes(int W, int Cin, int Cout, int is_bf16) {           \
    return smem_bytes(v, W, Cin, Cout, is_bf16);                                            \
  }

VARIANT_ENTRY(deform_fwd_bf16_fma_simt, BF16_FMA)
VARIANT_ENTRY(deform_fwd_qxhoist_simt, QXHOIST)
VARIANT_ENTRY(deform_fwd_cvt1_simt, CVT1)
VARIANT_ENTRY(deform_fwd_slot_skip_simt, SLOT_SKIP)
VARIANT_ENTRY(deform_fwd_tapwalk_simt, TAPWALK)
