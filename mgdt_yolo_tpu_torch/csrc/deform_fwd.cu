// DCNv2 forward (3x3, stride 1, padding 1), NHWC, redesigned for Hopper:
// the contraction with the weight on the tensor cores, tap by tap, fed by
// double-buffered cp.async gathers of the bilinear corner rows.
//
// Replaces: mgdt_yolo_tpu/ops/pallas_deform.py, `_kernel_fused` (:79, called
// by `modulated_deform_conv2d_pallas`, :155). The TPU kernel walks one-hot
// window slots because gathers are slow there; here each (pixel, tap) reads
// its four bilinear corners directly, at the fields of deform_common.cuh
// (the same fields as the backward kernel). One flag selects windowed or
// exact semantics. Plain PyTorch version: ops/deform.py,
// `modulated_deform_conv2d_plain`.
//
// Bound on this card (H100 SXM, 3.35 TB/s, 989 TFLOP/s bf16): memory. At the
// main path's shape (80x80, C 32 -> 32, bf16) the function must move 91 values
// per pixel, 2.33 MB per image (0.0111 ms at batch 32), against 0.12 GFLOP of
// contraction per image (0.004 ms at batch 32 on the tensor cores).
//
// What the first design (deform_fwd_simt.cu, "SIMT K1") left on the table, and
// what this one does about it:
// * SIMT K1 contracts on the CUDA cores, one thread per (pixel, output
//   channel), two shared loads per FMA over 288 terms: bound by shared-load
//   issue. Here each tap's (16 pixels, Cin) sample block is contracted with
//   the tap's (Cin, Cout) weight slice by `mma.sync.m16n8k16`
//   (deform_mma.cuh), the (16, 32) sums staying in registers over the 9
//   taps. The samples are float32 (the TPU kernel contracts in float32,
//   pallas_deform.py:97-101) and are carried as two bf16 terms, hi = bf16(s)
//   and lo = bf16(s - hi): ~16 bits of every sample, where one bf16 term would
//   be another function. A bf16 weight is bf16-exact, so the bf16 path takes
//   2 products per term; a float32 weight is split the same way and takes 3
//   (hi.hi, lo.hi, hi.lo).
// * SIMT K1 re-reads and widens the whole weight for every 32-pixel block and
//   fits 2 blocks per SM. Here blocks are persistent (SMs x resident blocks,
//   one 16-warp block per SM at the main path's shape): each converts the
//   weight once into shared memory, as bf16 (hi, and lo for float32) in the
//   n-major, padded layout the B fragments are read from.
// * SIMT K1 gathers 2-byte values, one per (pixel, tap, channel, corner),
//   between block barriers. Here each warp walks its own items, 16 output
//   pixels by up to 32 output channels, with no block barrier after the
//   weight's: it reads the 16 pixels' offsets and mask once, then for each
//   tap one lane per (pixel, corner) computes the corner's weight and issues
//   the copy of its Cin-wide row with 16-byte cp.async (4-byte, or plain
//   loads, where the row or x is not 16-byte aligned) into the warp's
//   double-buffered stage: tap k + 1's corners are in flight while tap k's
//   are combined (float32, K1's corner order) and multiplied. The epilogue
//   adds the bias, rounds to x's type and stores 16-byte vectors of NHWC
//   rows. Cout past 32 is taken in further items of the same pixels.
// * Wide channels: the resident weight, 9 (Cin, Cout) slices, outgrows a
//   block's shared memory above C 64 (313,344 B in bf16 at C 128) and leaves
//   room for one warp in float32 at C 64. There a second plan ("streamed")
//   holds one tap's slice: the block's warps take their items in lockstep
//   and, at each tap, wait at a block barrier, load the tap's slice, wait
//   again and contract with it, so the slice is re-read once per tap per
//   round of items. Where the resident plan fits 4 warps or more (every
//   channel count up to 32, and bf16 at 64) it runs as before. Square C up
//   to 172 (float32) and 256 (bf16) fits one of the two.
//
// The device code the staged-slab forwards V2 and V3 (deform_fwd_slab.cu)
// share with this kernel (the weight staging, the corner weights, the
// combine, the per-tap contraction and the epilogue) is in deform_k1.cuh.
//
// Built by mgdt_yolo_tpu_torch/utils/build.py with nvcc for sm_90a; called
// through ctypes from mgdt_yolo_tpu_torch/ops/cuda_deform.py (`deform_fwd`).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "deform_common.cuh"
#include "deform_k1.cuh"
#include "deform_mma.cuh"

namespace {

using namespace deform;

constexpr int MAX_WARPS = 16;     // warps per block
constexpr int MIN_RESIDENT_WARPS = 4;  // below this the streamed plan is taken, where it fits
constexpr long long MAX_SMEM = 232448;  // shared memory one block may use

// The launch's shape, from (Cin, Cout, type): per-warp regions after the
// block's weight. A warp item is 16 output pixels by NTW * 8 output channels.
struct FwdPlan {
  int stream;   // 0: the 9 taps' weight resident; 1: one tap's slice, staged by tap
  int NWB;      // warps per block: 16, or fewer where shared memory forces it
  int groups;   // column groups of NTW n-tiles (each warp item takes one)
  int CK;       // Cin padded to 16: the contraction depth per tap
  int SA;       // row stride of the sample blocks and of the weight, CK + 8
  int NP;       // Cout padded to 8
  int NT;       // n-tiles, NP / 8
  int RS;       // stage row stride in elements: Cin padded to 16 bytes
  int OS;       // output staging row stride (floats), NTW * 8 + 4
  int vec;      // corner-row copies: 16 or 4 byte cp.async, 0 plain loads
  long long w_bytes;               // the weight, hi (and lo for float32)
  long long a_off, f_off, o_off, s_off, warp_bytes;  // one warp's regions
  long long smem;
};

bool plan_for(int Cin, int Cout, int es, int stream, FwdPlan* out) {
  FwdPlan p{};
  p.stream = stream;
  p.CK = (int)round_up(Cin, 16);
  p.SA = p.CK + 8;
  p.NP = (int)round_up(Cout, 8);
  p.NT = p.NP / 8;
  p.groups = (p.NT + NTW - 1) / NTW;
  p.RS = (int)round_up(Cin, 16 / es);
  p.OS = NTW * 8 + 4;
  p.w_bytes = (stream ? 1LL : 9LL) * p.NP * p.SA * 2 * (es == 4 ? 2 : 1);
  p.a_off = 0;                                        // a_hi, a_lo: (16, SA) bf16 each
  p.f_off = p.a_off + 2LL * 16 * p.SA * 2;            // fw, fi: (2, 16, 4) each
  p.o_off = p.f_off + 2LL * 2 * 16 * 4 * 4;           // offsets (16, 18) and mask (16, 9)
  p.s_off = p.o_off + round_up(16LL * 27 * es, 16);   // stage (2, 16, 4, RS)
  const long long stage = 2LL * 16 * 4 * p.RS * es, ostage = 16LL * p.OS * 4;
  p.warp_bytes = p.s_off + (stage > ostage ? stage : ostage);
  for (int nw = MAX_WARPS; nw >= 1; --nw) {
    p.NWB = nw;
    p.smem = p.w_bytes + nw * p.warp_bytes;
    if (p.smem <= MAX_SMEM) {
      *out = p;
      return true;
    }
  }
  return false;
}

// the resident plan where it fits MIN_RESIDENT_WARPS warps, else the
// streamed one, else the resident one with fewer warps
bool make_plan(int Cin, int Cout, int es, FwdPlan* out) {
  FwdPlan resident, streamed;
  const bool fits = plan_for(Cin, Cout, es, 0, &resident);
  if (fits && resident.NWB >= MIN_RESIDENT_WARPS) {
    *out = resident;
    return true;
  }
  if (plan_for(Cin, Cout, es, 1, &streamed)) {
    *out = streamed;
    return true;
  }
  if (fits) *out = resident;
  return fits;
}

template <typename T, bool STREAM>
__global__ void __launch_bounds__(MAX_WARPS * 32)
deform_fwd_mma_kernel(const T* __restrict__ x, const T* __restrict__ offset,
                      const T* __restrict__ mask, const T* __restrict__ weight,
                      const float* __restrict__ bias, T* __restrict__ out, int B, int H,
                      int W, int Cin, int Cout, int windowed, const FwdPlan pl) {
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int WTAPS = STREAM ? 1 : KT;  // taps of the weight held in shared memory
  extern __shared__ __align__(16) unsigned char smem[];
  const int CK = pl.CK, SA = pl.SA, NP = pl.NP, RS = pl.RS;
  __nv_bfloat16* w_hi = reinterpret_cast<__nv_bfloat16*>(smem);   // (WTAPS, NP, SA): [k][o][c]
  __nv_bfloat16* w_lo = w_hi + WTAPS * NP * SA;                    // float32 weights only

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned char* mine = smem + pl.w_bytes + warp * pl.warp_bytes;  // this warp's regions
  __nv_bfloat16* a_hi = reinterpret_cast<__nv_bfloat16*>(mine + pl.a_off);  // (16, SA)
  __nv_bfloat16* a_lo = a_hi + 16 * SA;
  float* fw = reinterpret_cast<float*>(mine + pl.f_off);  // (2, 16, 4) corner weights
  int* fi = reinterpret_cast<int*>(fw + 2 * 16 * 4);      // (2, 16, 4) pixel, -1 = none
  T* off_s = reinterpret_cast<T*>(mine + pl.o_off);       // (16, 18)
  T* m_s = off_s + 16 * 2 * KT;                           // (16, 9)
  T* stage = reinterpret_cast<T*>(mine + pl.s_off);       // (2, 16, 4, RS)
  float* o_s = reinterpret_cast<float*>(stage);           // (16, OS) after the last tap

  // taps k0 .. k0 + taps - 1 of the weight, zero-padded: w[k0 + k][c][o] -> w_hi[k][o][c]
  auto load_weight = [&](int k0, int taps) {
    stage_weight(w_hi, w_lo, weight, k0, taps, NP, CK, SA, Cin, Cout, tid, (int)blockDim.x);
  };
  if (!STREAM) {
    load_weight(0, KT);  // once per block
    __syncthreads();     // the resident plan's only block barrier: from here each warp runs alone
  }

  const int P = H * W;
  const int tiles = (P + 15) / 16;
  const long long items = (long long)B * tiles * pl.groups;
  const int CK4 = CK / 4;
  // the streamed plan's warps run in lockstep, one round of NWB items at a
  // time, so a warp past the last item still takes the block's barriers
  for (long long item = (long long)blockIdx.x * pl.NWB + warp;
       (STREAM ? item - warp : item) < items; item += (long long)gridDim.x * pl.NWB) {
    const bool live = !STREAM || item < items;
    const int ng = (int)(item % pl.groups);
    const long long t = item / pl.groups;
    const int b = (int)(t / tiles);
    const int p0 = (int)(t % tiles) * 16;
    const int np = min(16, P - p0);
    const size_t pix0 = (size_t)b * P + p0;
    const T* xb = x + (size_t)b * P * Cin;

    // the 16 pixels' offsets and mask, one read for all 9 taps
    if (live) {
      for (int e = lane; e < np * 2 * KT; e += 32) off_s[e] = offset[pix0 * (2 * KT) + e];
      for (int e = lane; e < np * KT; e += 32) m_s[e] = mask[pix0 * KT + e];
    }
    __syncwarp();

    // tap k's corner weights and row copies into buffer buf, one lane per
    // (pixel, corner): pixels lane / 4 and lane / 4 + 8, whose coordinates
    // hold for all 9 taps. Corner q of pixel p goes to row slot q ^ (p & 1),
    // so the combine's neighbouring pixels read different banks. A corner
    // outside the image, or of a dead tap, copies nothing and is skipped.
    int pi[2], pj[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      pi[h] = (p0 + (lane >> 2) + 8 * h) / W;
      pj[h] = (p0 + (lane >> 2) + 8 * h) % W;
    }
    auto gather = [&](int k, int buf) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = (lane >> 2) + 8 * h, q = lane & 3;
        float wq = 0.f;
        int src = -1;
        if (p < np) {
          const Tap tp = tap_fields(pi[h], pj[h], k, to_f32(off_s[p * 2 * KT + 2 * k]),
                                    to_f32(off_s[p * 2 * KT + 2 * k + 1]), H, W, windowed);
          const float wv = tp.valid ? to_f32(m_s[p * KT + k]) : 0.f;
          int yy, xx;
          if (corner(tp, wv, q, H, W, wq, yy, xx)) src = yy * W + xx;
        }
        fw[(buf * 16 + p) * 4 + q] = wq;
        fi[(buf * 16 + p) * 4 + q] = src;
        if (src >= 0) {
          T* dst = stage + ((size_t)(buf * 16 + p) * 4 + (q ^ (p & 1))) * RS;
          const T* row = xb + (size_t)src * Cin;
          const int nbytes = Cin * (int)sizeof(T);
          if (pl.vec == 16) {
            for (int o = 0; o < nbytes; o += 16)
              cp_async16(reinterpret_cast<char*>(dst) + o, reinterpret_cast<const char*>(row) + o);
          } else if (pl.vec == 4) {
            for (int o = 0; o < nbytes; o += 4)
              cp_async4(reinterpret_cast<char*>(dst) + o, reinterpret_cast<const char*>(row) + o);
          } else {
            for (int c = 0; c < Cin; ++c) dst[c] = row[c];
          }
        }
      }
    };

    // one (pixel, 4 channels) of the tap in buffer buf: float32 in K1's
    // corner order, split into the bf16 hi and lo blocks (zero past np, Cin)
    auto combine_one = [&](int buf, int p, int c) {
      const float4 wq = *reinterpret_cast<const float4*>(fw + (buf * 16 + p) * 4);
      const int4 src = *reinterpret_cast<const int4*>(fi + (buf * 16 + p) * 4);
      const T* row = stage + (size_t)(buf * 16 + p) * 4 * RS;
      const int sw = p & 1;
      const float w4[4] = {wq.x, wq.y, wq.z, wq.w};
      const bool live[4] = {src.x >= 0, src.y >= 0, src.z >= 0, src.w >= 0};
      const T* const rows[4] = {row + (0 ^ sw) * RS, row + (1 ^ sw) * RS, row + (2 ^ sw) * RS,
                                row + (3 ^ sw) * RS};
      combine<true>(rows, w4, live, c, Cin, p, SA, a_hi, a_lo);
    };

    const int n0 = ng * NTW;  // this item's first n-tile
    float acc[NTW][4];
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[j][r] = 0.f;

    if (live) {
      gather(0, 0);
      cp_async_commit();
    }
    for (int k = 0; k < KT; ++k) {
      if (live) {
        if (k + 1 < KT) gather(k + 1, (k + 1) & 1);
        cp_async_commit();
      }
      if (STREAM) {
        __syncthreads();  // every warp's products with the last tap's slice are done
        load_weight(k, 1);
        __syncthreads();
      }
      if (!live) continue;
      cp_async_wait<1>();  // tap k's copies have landed (this lane's) ...
      __syncwarp();        // ... and every lane's; the last tap's products are done
      if (32 % CK4 == 0) {
        const int c = 4 * (lane % CK4);
        for (int p = lane / CK4; p < 16; p += 32 / CK4) combine_one(k & 1, p, c);
      } else {
        for (int e = lane; e < 16 * CK4; e += 32) combine_one(k & 1, e / CK4, 4 * (e % CK4));
      }
      __syncwarp();
      const __nv_bfloat16* wk_hi = w_hi + (STREAM ? 0 : k) * NP * SA;
      const __nv_bfloat16* wk_lo = w_lo + (STREAM ? 0 : k) * NP * SA;
      contract_tap<F32>(acc, a_hi, a_lo, wk_hi, wk_lo, SA, CK, n0, pl.NT, lane);
    }

    if (!live) continue;  // the last round's idle warps: no barrier follows
    // epilogue: the sums through this warp's staging (the stage is free:
    // every lane passed the last combine), then bias, x's type, 16-byte rows
    store_item(acc, o_s, pl.OS, out + pix0 * Cout, bias, np, Cout, n0, lane);
    __syncwarp();  // the staging and the offsets are read before the next item refills them
  }
}

template <typename T, bool STREAM>
int launch_plan(const void* x, const void* offset, const void* mask, const void* weight,
                const float* bias, void* out, int B, int H, int W, int Cin, int Cout,
                int windowed, const FwdPlan& pl, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(deform_fwd_mma_kernel<T, STREAM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return (int)err;
  const int threads = pl.NWB * 32;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, deform_fwd_mma_kernel<T, STREAM>, threads, (size_t)pl.smem)) != cudaSuccess)
    return (int)err;
  const long long items = (long long)B * ((H * W + 15) / 16) * pl.groups;
  const long long need = (items + pl.NWB - 1) / pl.NWB, cap = (long long)sms * per_sm;
  const long long blocks = need < cap ? need : cap;
  if (blocks < 1) return (int)cudaErrorInvalidConfiguration;
  deform_fwd_mma_kernel<T, STREAM><<<(unsigned)blocks, threads, (size_t)pl.smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(offset), static_cast<const T*>(mask),
      static_cast<const T*>(weight), bias, static_cast<T*>(out), B, H, W, Cin, Cout, windowed,
      pl);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* offset, const void* mask, const void* weight,
           const float* bias, void* out, int B, int H, int W, int Cin, int Cout,
           int windowed, cudaStream_t stream) {
  FwdPlan pl;
  if (!make_plan(Cin, Cout, (int)sizeof(T), &pl)) return (int)cudaErrorInvalidValue;
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const int row_bytes = Cin * (int)sizeof(T);
  pl.vec = (row_bytes % 16 == 0 && xa % 16 == 0) ? 16 : (row_bytes % 4 == 0 && xa % 4 == 0) ? 4 : 0;
  if (pl.stream)
    return launch_plan<T, true>(x, offset, mask, weight, bias, out, B, H, W, Cin, Cout, windowed,
                                pl, stream);
  return launch_plan<T, false>(x, offset, mask, weight, bias, out, B, H, W, Cin, Cout, windowed,
                               pl, stream);
}

}  // namespace

extern "C" {

// Shared memory one block needs at these channel counts and type, in bytes;
// -1 where no tile fits in a block's shared memory.
long long deform_fwd_smem_bytes(int Cin, int Cout, int is_bf16) {
  FwdPlan pl;
  return make_plan(Cin, Cout, is_bf16 ? 2 : 4, &pl) ? pl.smem : -1;
}

// The plan these channel counts and type take: 0 the resident weight, 1 the
// weight staged by tap; -1 where neither fits.
long long deform_fwd_plan(int Cin, int Cout, int is_bf16) {
  FwdPlan pl;
  return make_plan(Cin, Cout, is_bf16 ? 2 : 4, &pl) ? pl.stream : -1;
}

// x (B,H,W,Cin), offset (B,H,W,18), mask (B,H,W,9), weight (3,3,Cin,Cout),
// out (B,H,W,Cout): all contiguous, all float32 (is_bf16 = 0) or all bf16
// (is_bf16 = 1), out 16-byte aligned. bias is float32 (Cout,) or null.
// Returns a cudaError_t.
int deform_fwd(const void* x, const void* offset, const void* mask, const void* weight,
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
