// The device code of the Hopper DCNv2 forward (K1, deform_fwd.cu) that the
// staged-slab forwards (V2 and V3, deform_fwd_slab.cu) share with it: the
// weight staged as bf16 B fragments, one corner's sampling weight, the
// combine of a (pixel, 4 channels) sample from its corner rows in K1's
// corner order and its bf16 hi/lo split, the per-tap contraction on the
// tensor cores and the epilogue. K1 reads its corner rows from a per-warp
// stage that cp.async fills from global memory and skips a dead corner
// (`combine`); V2 and V3 read them from a ring of input rows in shared
// memory and read a dead corner as a zero row (`combine_ring`), which sums
// the same terms in the same order. So the three give the same bits on
// finite inputs.
//
// utils/build.py hashes this header into every kernel's build digest.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "deform_common.cuh"
#include "deform_mma.cuh"

namespace deform {

constexpr int NTW = 4;  // n-tiles (8 output channels each) per warp item

// The weight's taps k0 .. k0 + taps - 1, zero-padded to (NP, CK), as the
// B fragments read it: w[k0 + k][c][o] -> w_hi[k][o][c] (row stride SA), and
// for a float32 weight its bf16 remainder in w_lo. Threads tid, tid + nth, ...
template <typename T>
__device__ __forceinline__ void stage_weight(__nv_bfloat16* w_hi, __nv_bfloat16* w_lo,
                                             const T* __restrict__ weight, int k0, int taps,
                                             int NP, int CK, int SA, int Cin, int Cout,
                                             int tid, int nth) {
  constexpr bool F32 = sizeof(T) == 4;
  for (int e = tid; e < taps * NP * CK; e += nth) {
    const int k = e / (NP * CK), r = e % (NP * CK), o = r / CK, c = r % CK;
    const float v =
        (o < Cout && c < Cin) ? to_f32(weight[((size_t)(k0 + k) * Cin + c) * Cout + o]) : 0.f;
    __nv_bfloat16 hi, lo;
    split_bf16(v, hi, lo);
    w_hi[(k * NP + o) * SA + c] = hi;
    if (F32) w_lo[(k * NP + o) * SA + c] = lo;
  }
}

// Corner q (dy = q >> 1, dx = q & 1) of tap tp of a pixel whose mask value
// for the tap is wv (0 for a tap outside the image): its weight wq and image
// position (yy, xx). False where it adds nothing (a dead tap, or the corner
// outside the image); K1 then skips it.
__device__ __forceinline__ bool corner(const Tap& tp, float wv, int q, int H, int W,
                                       float& wq, int& yy, int& xx) {
  if (wv == 0.f) return false;
  const int dy = q >> 1, dx = q & 1;
  yy = tp.y0 + dy;
  xx = tp.x0 + dx;
  if (yy < 0 || yy >= H || xx < 0 || xx >= W) return false;
  wq = (dy ? tp.fy : 1.f - tp.fy) * (dx ? tp.fx : 1.f - tp.fx) * wv;
  return true;
}

// four consecutive channels c..c+3 (c a multiple of 4) of a corner row, 0
// past Cin; VEC: the row + c is aligned for one 8-byte (bf16) or 16-byte
// (float32) load wherever c + 3 < Cin
template <bool VEC>
__device__ __forceinline__ void load4(const __nv_bfloat16* row, int c, int Cin, float (&v)[4]) {
  if (VEC && c + 3 < Cin) {
    const uint2 u = *reinterpret_cast<const uint2*>(row + c);
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
    v[0] = __low2float(a);
    v[1] = __high2float(a);
    v[2] = __low2float(b);
    v[3] = __high2float(b);
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = c + u < Cin ? __bfloat162float(row[c + u]) : 0.f;
  }
}
template <bool VEC>
__device__ __forceinline__ void load4(const float* row, int c, int Cin, float (&v)[4]) {
  if (VEC && c + 3 < Cin) {
    const float4 u = *reinterpret_cast<const float4*>(row + c);
    v[0] = u.x;
    v[1] = u.y;
    v[2] = u.z;
    v[3] = u.w;
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = c + u < Cin ? row[c + u] : 0.f;
  }
}

// One (pixel p, channels c..c+3) sample: the live corners' rows (live[q])
// weighted by w4[q], summed in float32 in K1's corner order (0,0), (0,1),
// (1,0), (1,1) from +0, then split into the bf16 hi and lo sample blocks
// (row stride SA).
template <bool VEC, typename S>
__device__ __forceinline__ void combine(const S* const (&rows)[4], const float (&w4)[4],
                                        const bool (&live)[4], int c, int Cin, int p, int SA,
                                        __nv_bfloat16* a_hi, __nv_bfloat16* a_lo) {
  float s[4] = {0.f, 0.f, 0.f, 0.f}, v[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (live[q]) {
      load4<VEC>(rows[q], c, Cin, v);
#pragma unroll
      for (int u = 0; u < 4; ++u) s[u] += w4[q] * v[u];
    }
  }
  __nv_bfloat16 h[4], l[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) split_bf16(s[u], h[u], l[u]);
  *reinterpret_cast<uint2*>(a_hi + p * SA + c) =
      make_uint2(pack_bf16(h[0], h[1]), pack_bf16(h[2], h[3]));
  *reinterpret_cast<uint2*>(a_lo + p * SA + c) =
      make_uint2(pack_bf16(l[0], l[1]), pack_bf16(l[2], l[3]));
}

// The same sample where the corner rows lie in one shared-memory array
// (the slab kernels' ring), without the branches: every corner row is read,
// a dead corner's from a zero row with weight 0 (offsets src from `ring`,
// weights from fw). The float32 sum is `combine`'s bit for bit: it starts at
// +0, a sum of products rounded to nearest is never -0, and s + 0 * 0 is s.
// The hi/lo split is split_bf16's, two values to a conversion. With no
// branch, a lane's pixels unroll into independent loads and sums.
template <bool VEC, typename S>
__device__ __forceinline__ void combine_ring(const S* ring, const float* fw, const int* fi,
                                             int p, int c, int Cin, int SA,
                                             __nv_bfloat16* a_hi, __nv_bfloat16* a_lo) {
  const float4 wq = *reinterpret_cast<const float4*>(fw + p * 4);
  const int4 src = *reinterpret_cast<const int4*>(fi + p * 4);
  float v[4][4];
  load4<VEC>(ring + src.x, c, Cin, v[0]);
  load4<VEC>(ring + src.y, c, Cin, v[1]);
  load4<VEC>(ring + src.z, c, Cin, v[2]);
  load4<VEC>(ring + src.w, c, Cin, v[3]);
  const float w4[4] = {wq.x, wq.y, wq.z, wq.w};
  float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int u = 0; u < 4; ++u) s[u] += w4[q] * v[q][u];
  const __nv_bfloat162 h01 = __floats2bfloat162_rn(s[0], s[1]);
  const __nv_bfloat162 h23 = __floats2bfloat162_rn(s[2], s[3]);
  const float2 f01 = __bfloat1622float2(h01), f23 = __bfloat1622float2(h23);
  const __nv_bfloat162 l01 = __floats2bfloat162_rn(s[0] - f01.x, s[1] - f01.y);
  const __nv_bfloat162 l23 = __floats2bfloat162_rn(s[2] - f23.x, s[3] - f23.y);
  *reinterpret_cast<uint2*>(a_hi + p * SA + c) = make_uint2(
      *reinterpret_cast<const uint32_t*>(&h01), *reinterpret_cast<const uint32_t*>(&h23));
  *reinterpret_cast<uint2*>(a_lo + p * SA + c) = make_uint2(
      *reinterpret_cast<const uint32_t*>(&l01), *reinterpret_cast<const uint32_t*>(&l23));
}

// One tap's contraction: the warp's (16, CK) hi/lo samples times the tap's
// weight slice (wk_hi, and wk_lo for a float32 weight, (NP, SA) n-major)
// into acc, n-tiles n0 .. n0 + NTW - 1 below NT. Terms hi.hi, lo.hi (and
// hi.lo for a float32 weight) in that order.
template <bool F32>
__device__ __forceinline__ void contract_tap(float (&acc)[NTW][4], const __nv_bfloat16* a_hi,
                                             const __nv_bfloat16* a_lo,
                                             const __nv_bfloat16* wk_hi,
                                             const __nv_bfloat16* wk_lo, int SA, int CK,
                                             int n0, int NT, int lane) {
  for (int kk = 0; kk < CK; kk += 16) {
    uint32_t ah[4], al[4];
    load_a(ah, a_hi, SA, 0, kk, lane);
    load_a(al, a_lo, SA, 0, kk, lane);
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
      if (n0 + j < NT) {
        uint32_t bh[2];
        load_b(bh, wk_hi, SA, (n0 + j) * 8, kk, lane);
        mma_bf16(acc[j], ah, bh);
        mma_bf16(acc[j], al, bh);
        if (F32) {
          uint32_t bl[2];
          load_b(bl, wk_lo, SA, (n0 + j) * 8, kk, lane);
          mma_bf16(acc[j], ah, bl);
        }
      }
    }
  }
}

// 16 bytes of output from floats already biased
__device__ __forceinline__ void store16(__nv_bfloat16* dst, const float* v) {
  uint4 u;
  u.x = pack_bf16(__float2bfloat16_rn(v[0]), __float2bfloat16_rn(v[1]));
  u.y = pack_bf16(__float2bfloat16_rn(v[2]), __float2bfloat16_rn(v[3]));
  u.z = pack_bf16(__float2bfloat16_rn(v[4]), __float2bfloat16_rn(v[5]));
  u.w = pack_bf16(__float2bfloat16_rn(v[6]), __float2bfloat16_rn(v[7]));
  *reinterpret_cast<uint4*>(dst) = u;
}
__device__ __forceinline__ void store16(float* dst, const float* v) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}

// The epilogue of one warp item: the (16, NTW * 8) sums through the warp's
// staging o_s (row stride OS floats, free for the warp's use), then the bias,
// x's type and 16-byte stores of the np pixels' NHWC rows from ob (the item's
// first pixel), output channels n0 * 8 .. below Cout.
template <typename T>
__device__ __forceinline__ void store_item(const float (&acc)[NTW][4], float* o_s, int OS,
                                           T* __restrict__ ob, const float* __restrict__ bias,
                                           int np, int Cout, int n0, int lane) {
  const int row = lane >> 2;
#pragma unroll
  for (int j = 0; j < NTW; ++j) {
    const int col = j * 8 + 2 * (lane & 3);
    o_s[row * OS + col] = acc[j][0];
    o_s[row * OS + col + 1] = acc[j][1];
    o_s[(row + 8) * OS + col] = acc[j][2];
    o_s[(row + 8) * OS + col + 1] = acc[j][3];
  }
  __syncwarp();
  const int c_lo = n0 * 8;
  const int c_hi = min(Cout, c_lo + NTW * 8);
  constexpr int VO = 16 / (int)sizeof(T);
  if (Cout % VO == 0) {
    const int nv = (c_hi - c_lo) / VO;
    for (int e = lane; e < np * nv; e += 32) {
      const int p = e / nv, o = (e % nv) * VO;
      float v[VO];
#pragma unroll
      for (int u = 0; u < VO; ++u)
        v[u] = o_s[p * OS + o + u] + (bias != nullptr ? bias[c_lo + o + u] : 0.f);
      store16(ob + (size_t)p * Cout + c_lo + o, v);
    }
  } else {
    const int nc = c_hi - c_lo;
    for (int e = lane; e < np * nc; e += 32) {
      const int p = e / nc, o = e % nc;
      float v = o_s[p * OS + o];
      if (bias != nullptr) v += bias[c_lo + o];
      ob[(size_t)p * Cout + c_lo + o] = from_f32<T>(v);
    }
  }
}

}  // namespace deform
