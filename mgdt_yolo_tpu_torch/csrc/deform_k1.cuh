// The device code of the Hopper DCNv2 forward (K1, deform_fwd.cu) that the
// staged-slab forwards (V2 and V3, deform_fwd_slab.cu) and the slot-skip and
// tap-walk forwards (V4 and V5, deform_fwd_tc_variants.cu) share with it:
// the weight staged as bf16 B fragments, one corner's sampling weight, the
// combine of a (pixel, 4 channels) sample from its corner rows in K1's
// corner order and its bf16 hi/lo split, the per-tap contraction on the
// tensor cores and the epilogue. K1 reads its corner rows from a per-warp
// stage that cp.async fills from global memory and skips a dead corner
// (`combine`); V2 and V3 read them from a ring of input rows in shared
// memory and read a dead corner as a zero row (`combine_ring`), which sums
// the same terms in the same order; V4 and V5 fill and read K1's stage
// through `gather_corner` and `combine_stage` (K1 keeps its own copies of
// those two steps, so that its code stays as it was compiled). So all five
// give the same bits on finite inputs.
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


// `corner`, and also false where the corner's weight is exactly 0 (fy or fx
// exactly 0 or 1 after the clip, or a product that underflows): V4 skips
// such a corner. The term it would add to a sample is a product with an
// exact 0, +-0 for a finite row value, and s + (+-0) is s for every s but
// -0, which a sum that starts at +0 is only where an underflowed product
// made it so; the sample is then +-0 either way. So on finite inputs the
// skip leaves every sample's value as K1's.
__device__ __forceinline__ bool corner_nonzero(const Tap& tp, float wv, int q, int H, int W,
                                               float& wq, int& yy, int& xx) {
  return corner(tp, wv, q, H, W, wq, yy, xx) && wq != 0.f;
}

// One lane's share of K1's gather of tap k for a warp item (windowed
// semantics): pixel p of the item's np (its offsets in off_s (16, 18), its
// mask in m_s (16, 9), its position (pi, pj) in image xb) and corner q. The
// corner's weight and source pixel go to the tap buffer's fw and fi ((16, 4)
// each, -1 for a corner that adds nothing), and its Cin-wide row is copied
// into row slot q ^ (p & 1) of the buffer's stage ((16, 4, RS)) by 16- or
// 4-byte cp.async (vec), or by plain loads (vec 0). With SKIP_ZERO a corner
// of weight 0 also copies nothing (`corner_nonzero`). Returns whether the
// corner is live.
template <bool SKIP_ZERO, typename T>
__device__ __forceinline__ bool gather_corner(const T* off_s, const T* m_s, int p, int q, int np,
                                              int pi, int pj, int k, int H, int W, int Cin,
                                              int RS, int vec, const T* __restrict__ xb,
                                              T* stage, float* fw, int* fi) {
  float wq = 0.f;
  int src = -1;
  if (p < np) {
    const Tap tp = tap_fields(pi, pj, k, to_f32(off_s[p * 2 * KT + 2 * k]),
                              to_f32(off_s[p * 2 * KT + 2 * k + 1]), H, W, 1);
    const float wv = tp.valid ? to_f32(m_s[p * KT + k]) : 0.f;
    int yy, xx;
    const bool live = SKIP_ZERO ? corner_nonzero(tp, wv, q, H, W, wq, yy, xx)
                                : corner(tp, wv, q, H, W, wq, yy, xx);
    if (live) src = yy * W + xx;
  }
  fw[p * 4 + q] = wq;
  fi[p * 4 + q] = src;
  if (src >= 0) {
    T* dst = stage + ((size_t)p * 4 + (q ^ (p & 1))) * RS;
    const T* row = xb + (size_t)src * Cin;
    const int nbytes = Cin * (int)sizeof(T);
    if (vec == 16) {
      for (int o = 0; o < nbytes; o += 16)
        cp_async16(reinterpret_cast<char*>(dst) + o, reinterpret_cast<const char*>(row) + o);
    } else if (vec == 4) {
      for (int o = 0; o < nbytes; o += 4)
        cp_async4(reinterpret_cast<char*>(dst) + o, reinterpret_cast<const char*>(row) + o);
    } else {
      for (int c = 0; c < Cin; ++c) dst[c] = row[c];
    }
  }
  return src >= 0;
}

// K1's combine of one tap for a warp item: the 16 pixels' samples of
// channels 0 .. CK - 1 from the corner rows `gather_corner` left in the tap
// buffer (stage, fw, fi), in K1's corner order, split into the bf16 hi and
// lo blocks (row stride SA; zero past Cin and for pixels past the item's).
// The lanes take (pixel, 4 channels) pairs.
template <typename T>
__device__ __forceinline__ void combine_stage(const T* stage, const float* fw, const int* fi,
                                              int Cin, int CK, int RS, int SA,
                                              __nv_bfloat16* a_hi, __nv_bfloat16* a_lo,
                                              int lane) {
  auto one = [&](int p, int c) {
    const float4 wq = *reinterpret_cast<const float4*>(fw + p * 4);
    const int4 src = *reinterpret_cast<const int4*>(fi + p * 4);
    const T* row = stage + (size_t)p * 4 * RS;
    const int sw = p & 1;
    const float w4[4] = {wq.x, wq.y, wq.z, wq.w};
    const bool live[4] = {src.x >= 0, src.y >= 0, src.z >= 0, src.w >= 0};
    const T* const rows[4] = {row + (0 ^ sw) * RS, row + (1 ^ sw) * RS, row + (2 ^ sw) * RS,
                              row + (3 ^ sw) * RS};
    combine<true>(rows, w4, live, c, Cin, p, SA, a_hi, a_lo);
  };
  const int CK4 = CK / 4;
  if (32 % CK4 == 0) {
    const int c = 4 * (lane % CK4);
    for (int p = lane / CK4; p < 16; p += 32 / CK4) one(p, c);
  } else {
    for (int e = lane; e < 16 * CK4; e += 32) one(e / CK4, 4 * (e % CK4));
  }
}

}  // namespace deform
