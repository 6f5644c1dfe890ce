// V2 and V3 of the DCNv2 forward (3x3, stride 1, padding 1, NHWC, windowed
// semantics), redesigned for Hopper: K1's tensor-core design (deform_k1.cuh)
// fed from a ring of input rows carried in shared memory and loaded
// asynchronously, in place of K1's per-tap gathers from global memory.
//
//   V2 deform_fwd_qxhoist  tools/proto_deform_qxhoist.py `deform_qxhoist` (:163,
//                          body `_kernel_fused_qxhoist` :53): the slab in x's type
//   V3 deform_fwd_cvt1     tools/proto_deform_qxhoist.py `deform_cvt1` (:128,
//                          body `_kernel_fused_cvt1` :89): the slab in float32,
//                          converted once as each row lands
//
// Both compute K1's windowed function. Their first designs, on the CUDA
// cores, stay in deform_fwd_variants.cu (`deform_fwd_qxhoist_simt`,
// `deform_fwd_cvt1_simt`) as their A/B baseline. Plain PyTorch version: K1's,
// ops/deform_variants.py `windowed_plain`.
//
// Bound on this card (H100 SXM, 3.35 TB/s): memory, as K1's; the function
// reads x, the offsets and the mask once and writes the output once (see
// deform_fwd.cu). K1 reads each pixel's 9 x 4 corner rows (~2.3 KB at C 32
// in bf16) from L2, with a warp waiting on them every tap; here every corner
// is read from shared memory, and x from global memory about once.
//
// The design:
// * Persistent blocks, one per SM at the flagship's shape. Each converts the
//   weight once into K1's bf16 B-fragment layout (hi, and lo for float32),
//   then walks a run of consecutive bands of RB output rows; the runs split
//   the batch's bands evenly over the blocks.
// * A ring of R input rows in shared memory, each a whole NHWC image row (W x
//   Cin, one contiguous span of x), slot y mod R. The windowed reach puts
//   every corner of output row i in rows [i - 3, i + 4], so a band reads
//   RB + 7 rows. Columns and rows outside the image are not held: a corner
//   there (or of a dead tap) reads one zero row with weight 0 instead, which
//   leaves the sum as K1's skip does, so the ring is W wide, not W + 7.
// * V2 (and V3 on float32 x, where the slab already is float32): R = 2 RB + 7.
//   While band n is computed, the RB rows band n + 1 adds are copied into the
//   slots band n - 1 alone read, with 16-byte cp.async (4-byte, or plain
//   loads, where a row or x is not so aligned, as K1 does); one block barrier
//   per band, after which those rows have landed and the slots of the band
//   before are free. The ring carries over from band to band, so x is read
//   once per run plus 7 rows where a run starts.
// * V3 on bf16 x: a cp.async copy cannot convert, so the RB new rows land raw
//   in a stage of RB rows, and after the band's barrier each is converted
//   once into the float32 ring (R = RB + 7), with a second barrier.
// * Warp-private items, as in K1: 16 output pixels by up to 32 output
//   channels. The item's offsets and mask were fetched with cp.async while
//   the warp's previous item was computed. Taps go in pairs: lane l computes
//   K1's fields (deform_common.cuh) of pixel l % 16 for tap k + l / 16 and
//   its four corners' weights and ring offsets (K1 has four lanes redo a
//   pixel's fields, one per corner); then for each tap the warp combines
//   the corner rows read from the ring in float32 in K1's corner order, with
//   no branch (`combine_ring`, a lane's four pixels unrolled), splits the
//   samples into bf16 hi/lo and contracts them with `mma.sync`; K1's
//   epilogue adds the bias, rounds and stores 16-byte vectors. No block
//   barrier per item.
//
// Bits: only where a corner row is read from changes (V3's float32 row holds
// the bf16 value exactly), so on finite inputs V2 and V3 give K1's bits
// (chip_smoke.py holds them to `cuda_deform.deform_fwd` bit for bit).
//
// The plan (RB, R, warps per block, blocks) is chosen in Python
// (ops/cuda_deform_variants.py `slab_plan`) and passed in; `layout` below
// recomputes the shared memory from it and the launch refuses a plan whose
// bytes disagree, a ring too small for the schedule, or a block above 227 KB.
//
// Built by mgdt_yolo_tpu_torch/utils/build.py with nvcc for sm_90a; called
// through ctypes from mgdt_yolo_tpu_torch/ops/cuda_deform_variants.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "deform_common.cuh"
#include "deform_k1.cuh"
#include "deform_mma.cuh"

namespace {

using namespace deform;

constexpr int MAX_WARPS = 16;
constexpr long long MAX_SMEM = 232448;  // shared memory one block may use

// One launch's shared-memory layout: the weight, the ring, a zero row (what a
// dead corner reads), V3's stage of raw rows (bf16 x only), then each warp's
// regions.
struct SlabPlan {
  int RB, R, NWB;  // output rows per band, ring rows, warps per block
  int convert;     // rows land raw in the stage and are converted into the ring
  int vec;         // row copies: 16- or 4-byte cp.async, 0 plain loads (set at launch)
  int CK, SA, NP, NT, groups, OS;  // K1's: contraction depth, strides, n-tiles
  int RWS;         // ring row stride in slab elements: W * Cin padded to 16 bytes
  int SWS;         // stage row stride in x's elements
  long long w_bytes, ring_off, zero_off, stage_off, warps_off;
  long long f_off, o_off, o_bytes, warp_bytes;  // in a warp's region: fields, offsets
  long long smem;
};

// es: x's element size; ss: the slab's
bool layout(int W, int Cin, int Cout, int es, int ss, int RB, int R, int NWB, SlabPlan* out) {
  if (W < 1 || Cin < 1 || Cout < 1 || RB < 1 || R < 1 || NWB < 1 || NWB > MAX_WARPS)
    return false;
  SlabPlan p{};
  p.RB = RB;
  p.R = R;
  p.NWB = NWB;
  p.convert = es != ss;
  p.CK = (int)round_up(Cin, 16);
  p.SA = p.CK + 8;
  p.NP = (int)round_up(Cout, 8);
  p.NT = p.NP / 8;
  p.groups = (p.NT + NTW - 1) / NTW;
  p.OS = NTW * 8 + 4;
  p.RWS = (int)(round_up((long long)W * Cin * ss, 16) / ss);
  p.SWS = (int)(round_up((long long)W * Cin * es, 16) / es);
  p.w_bytes = (long long)KT * p.NP * p.SA * 2 * (es == 4 ? 2 : 1);
  p.ring_off = p.w_bytes;
  p.zero_off = p.ring_off + (long long)R * p.RWS * ss;  // one zero row of Cin, after the ring
  p.stage_off = p.zero_off + round_up((long long)Cin * ss, 16);
  p.warps_off = p.stage_off + (p.convert ? (long long)RB * p.SWS * es : 0);
  const long long a_bytes = 2LL * 16 * p.SA * 2, o_bytes = 16LL * p.OS * 4;
  p.f_off = a_bytes > o_bytes ? a_bytes : o_bytes;  // the samples, or the output staging
  p.o_off = p.f_off + 2LL * 2 * 16 * 4 * 4;          // fw, fi: (2 taps, 16, 4) each
  p.o_bytes = round_up(16LL * 27 * es, 16);          // one item's offsets and mask
  p.warp_bytes = p.o_off + 2 * p.o_bytes;            // two items': this one, the next
  p.smem = p.warps_off + NWB * p.warp_bytes;
  *out = p;
  return p.smem <= MAX_SMEM;
}

// chunk e of a row from src to dst: 16 or 4 bytes by cp.async (vec; both
// aligned so), or element e by a plain load and store (vec 0)
template <typename T>
__device__ __forceinline__ void copy_chunk(T* dst, const T* src, int e, int vec) {
  if (vec == 16)
    cp_async16(reinterpret_cast<char*>(dst) + 16 * e, reinterpret_cast<const char*>(src) + 16 * e);
  else if (vec == 4)
    cp_async4(reinterpret_cast<char*>(dst) + 4 * e, reinterpret_cast<const char*>(src) + 4 * e);
  else
    dst[e] = src[e];
}

// n bytes from src to dst by the warp's lanes: 16- or 4-byte cp.async where
// both ends and n allow it, else plain loads and stores of T
template <typename T>
__device__ __forceinline__ void warp_copy(T* dst, const T* src, int n, int lane) {
  const unsigned a = (unsigned)(reinterpret_cast<uintptr_t>(dst) |
                                reinterpret_cast<uintptr_t>(src)) | (unsigned)n;
  char* d = reinterpret_cast<char*>(dst);
  const char* g = reinterpret_cast<const char*>(src);
  if ((a & 15) == 0) {
    for (int o = 16 * lane; o < n; o += 16 * 32) cp_async16(d + o, g + o);
  } else if ((a & 3) == 0) {
    for (int o = 4 * lane; o < n; o += 4 * 32) cp_async4(d + o, g + o);
  } else {
    for (int e = lane; e < n / (int)sizeof(T); e += 32) dst[e] = src[e];
  }
}

template <typename T, typename S>
__global__ void __launch_bounds__(MAX_WARPS * 32, 1)
slab_kernel(const T* __restrict__ x, const T* __restrict__ offset, const T* __restrict__ mask,
            const T* __restrict__ weight, const float* __restrict__ bias, T* __restrict__ out,
            int B, int H, int W, int Cin, int Cout, const SlabPlan pl) {
  constexpr bool F32 = sizeof(T) == 4;
  constexpr bool CONVERT = !std::is_same<T, S>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  const int CK = pl.CK, SA = pl.SA, NP = pl.NP, RB = pl.RB, R = pl.R, RWS = pl.RWS;
  __nv_bfloat16* w_hi = reinterpret_cast<__nv_bfloat16*>(smem);  // (9, NP, SA): [k][o][c]
  __nv_bfloat16* w_lo = w_hi + KT * NP * SA;                      // float32 weights only
  S* ring = reinterpret_cast<S*>(smem + pl.ring_off);             // (R, RWS)
  T* stage = reinterpret_cast<T*>(smem + pl.stage_off);           // (RB, SWS), V3 on bf16 x

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nth = blockDim.x;
  unsigned char* mine = smem + pl.warps_off + warp * pl.warp_bytes;  // this warp's regions
  __nv_bfloat16* a_hi = reinterpret_cast<__nv_bfloat16*>(mine);      // (16, SA)
  __nv_bfloat16* a_lo = a_hi + 16 * SA;
  float* o_s = reinterpret_cast<float*>(mine);  // (16, OS): the epilogue's, over the samples
  float* fw = reinterpret_cast<float*>(mine + pl.f_off);  // (2, 16, 4) corner weights
  int* fi = reinterpret_cast<int*>(fw + 2 * 16 * 4);      // (2, 16, 4) offsets from the ring
  // two items' offsets (16, 18) and mask (16, 9): this item's and the next's
  auto off_buf = [&](int i) { return reinterpret_cast<T*>(mine + pl.o_off + i * pl.o_bytes); };

  // once per block; the first band's barrier orders them before any product
  stage_weight(w_hi, w_lo, weight, 0, KT, NP, CK, SA, Cin, Cout, tid, nth);
  const int zero_src = R * RWS;  // the zero row, as an offset from the ring
  for (int c = tid; c < Cin; c += nth) ring[zero_src + c] = from_f32<S>(0.f);

  const int P = H * W, row_len = W * Cin;
  const int NB = (H + RB - 1) / RB;  // bands per image
  const long long bands = (long long)B * NB;
  const long long first = bands * blockIdx.x / gridDim.x;
  const long long last = bands * (blockIdx.x + 1) / gridDim.x;
  const int vec = pl.vec;
  const int chunks = vec ? row_len * (int)sizeof(T) / vec : row_len;  // per row
  const bool vec4 = Cin % 4 == 0;  // a ring row + 4-channel group takes one vector load

  // image rows y0 .. y1 of image b, copied into their ring slots (V2), or
  // into the stage from slot 0 (V3 on bf16 x)
  auto copy_rows = [&](int b, int y0, int y1) {
    const T* xb = x + (size_t)b * P * Cin;
    for (int e = tid; e < (y1 - y0 + 1) * chunks; e += nth) {
      const int y = y0 + e / chunks, ch = e % chunks;
      T* dst = CONVERT ? stage + (size_t)(y - y0) * pl.SWS
                       : reinterpret_cast<T*>(ring) + (size_t)(y % R) * RWS;
      copy_chunk(dst, xb + (size_t)y * row_len, ch, vec);
    }
  };
  // V3 on bf16 x: rows y0 .. y1, landed in the stage from slot 0, converted
  // into their ring slots
  auto convert_rows = [&](int y0, int y1) {
    if (row_len % 4 == 0) {
      const int n4 = row_len / 4;
      for (int e = tid; e < (y1 - y0 + 1) * n4; e += nth) {
        const int r = e / n4, c = 4 * (e % n4);
        float v[4];
        load4<true>(stage + (size_t)r * pl.SWS, c, row_len, v);
        *reinterpret_cast<float4*>(reinterpret_cast<float*>(ring) +
                                   (size_t)((y0 + r) % R) * RWS + c) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
    } else {
      for (int e = tid; e < (y1 - y0 + 1) * row_len; e += nth) {
        const int r = e / row_len, c = e % row_len;
        reinterpret_cast<float*>(ring)[(size_t)((y0 + r) % R) * RWS + c] =
            to_f32(stage[(size_t)r * pl.SWS + c]);
      }
    }
  };
  // V3 on bf16 x, a new image: rows y0 .. y1 straight from global memory
  auto load_convert = [&](int b, int y0, int y1) {
    const T* xb = x + (size_t)b * P * Cin;
    for (int e = tid; e < (y1 - y0 + 1) * row_len; e += nth) {
      const int y = y0 + e / row_len, c = e % row_len;
      reinterpret_cast<float*>(ring)[(size_t)(y % R) * RWS + c] =
          to_f32(xb[(size_t)y * row_len + c]);
    }
  };

  // this warp's items: w, w + NWB, ... of each band of the run, as (band,
  // item); items_of(n) counts band n's
  auto items_of = [&](long long n) {
    const int r0 = (int)(n % NB) * RB;
    return ((min(r0 + RB, H) - r0) * W + 15) / 16 * pl.groups;
  };
  auto settle = [&](long long& n, int& it) {  // to the warp's first item at or after it
    while (n < last && it >= items_of(n)) {
      ++n;
      it = warp;
    }
  };
  // the item's 16 pixels' offsets and mask into buffer bi, asynchronously
  auto fetch = [&](long long n, int it, int bi) {
    const int r0 = (int)(n % NB) * RB, p_lo = r0 * W, npix = (min(r0 + RB, H) - r0) * W;
    const int p0 = p_lo + (it / pl.groups) * 16, np = min(16, p_lo + npix - p0);
    const size_t pix0 = (size_t)(n / NB) * P + p0;
    warp_copy(off_buf(bi), offset + pix0 * (2 * KT), np * 2 * KT * (int)sizeof(T), lane);
    warp_copy(off_buf(bi) + 16 * 2 * KT, mask + pix0 * KT, np * KT * (int)sizeof(T), lane);
  };
  long long fn = first;  // the warp's first item, fetched before the first band's wait
  int fit = warp, buf = 0;
  settle(fn, fit);
  if (fn < last) fetch(fn, fit, buf);
  cp_async_commit();

  const int CK4 = CK / 4;
  int cur_b = -1, prev_hi = -1;
  for (long long n = first; n < last; ++n) {
    const int b = (int)(n / NB), j = (int)(n % NB);
    const int r0 = j * RB, r1 = min(r0 + RB, H);                // output rows [r0, r1)
    const int lo = max(r0 - 3, 0), hi = min(r1 + 3, H - 1);   // input rows the band reads
    if (b != cur_b) {
      // a new image: its whole window, once every warp is done with the last band
      __syncthreads();
      if (CONVERT) {
        load_convert(b, lo, hi);
        cp_async_wait<0>();  // the first item's offsets
      } else {
        copy_rows(b, lo, hi);
        cp_async_commit();
        cp_async_wait<0>();
      }
      cur_b = b;
    } else {
      cp_async_wait<0>();  // this thread's copies of the band's new rows have landed
      if (CONVERT) {
        __syncthreads();  // every thread's, and every warp is done with the last band
        convert_rows(prev_hi + 1, hi);
      }
    }
    __syncthreads();  // the band's rows are in the ring; the last band's slots are free
    // the rows the next band adds, copied while this one is computed, into
    // slots no row of this band holds (R >= 2 RB + 7 or H), or into the stage
    if (n + 1 < last && (n + 1) / NB == b) {
      const int next_hi = min(min(r1 + RB, H) + 3, H - 1);
      if (next_hi > hi) copy_rows(b, hi + 1, next_hi);
      cp_async_commit();
    }
    prev_hi = hi;
    const int slot_lo = lo % R;  // ring slot of row lo; rows lo .. hi follow cyclically

    const int p_lo = r0 * W, npix = (r1 - r0) * W;
    const int items = (npix + 15) / 16 * pl.groups;
    for (int it = warp; it < items; it += pl.NWB, buf ^= 1) {
      const int ng = it % pl.groups;
      const int p0 = p_lo + (it / pl.groups) * 16;
      const int np = min(16, p_lo + npix - p0);
      const size_t pix0 = (size_t)b * P + p0;
      const T* off_s = off_buf(buf);
      const T* m_s = off_s + 16 * 2 * KT;

      // this item's offsets and mask: fetched with the band's rows for the
      // band's first item (the band's wait), during the last item otherwise
      if (it != warp) cp_async_wait<0>();
      __syncwarp();
      {  // the next item's, while this one is computed
        long long nn = n;
        int nit = it + pl.NWB;
        settle(nn, nit);
        if (nn < last) fetch(nn, nit, buf ^ 1);
        cp_async_commit();
      }

      // fields: lane l takes pixel l % 16 of tap k + l / 16 (two taps a pass)
      const int fp = lane & 15, ft = lane >> 4;
      const int pi = (p0 + fp) / W, pj = (p0 + fp) % W;

      const int n0 = ng * NTW;  // this item's first n-tile
      float acc[NTW][4];
#pragma unroll
      for (int jj = 0; jj < NTW; ++jj)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[jj][r] = 0.f;

      for (int k0 = 0; k0 < KT; k0 += 2) {
        // taps k0 and k0 + 1: each corner's weight and ring offset; a corner
        // outside the image, or of a dead tap, reads the zero row with weight 0
        {
          const int k = k0 + ft;
          float wq[4] = {0.f, 0.f, 0.f, 0.f};
          int src[4] = {zero_src, zero_src, zero_src, zero_src};
          if (fp < np && k < KT) {
            const Tap tp = tap_fields(pi, pj, k, to_f32(off_s[fp * 2 * KT + 2 * k]),
                                      to_f32(off_s[fp * 2 * KT + 2 * k + 1]), H, W, 1);
            const float wv = tp.valid ? to_f32(m_s[fp * KT + k]) : 0.f;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              int yy, xx;
              if (corner(tp, wv, q, H, W, wq[q], yy, xx)) {
                int slot = slot_lo + (yy - lo);  // yy in [lo, hi]: the windowed reach
                if (slot >= R) slot -= R;
                src[q] = slot * RWS + xx * Cin;
              }
            }
          }
          *reinterpret_cast<float4*>(fw + (ft * 16 + fp) * 4) =
              make_float4(wq[0], wq[1], wq[2], wq[3]);
          *reinterpret_cast<int4*>(fi + (ft * 16 + fp) * 4) =
              make_int4(src[0], src[1], src[2], src[3]);
        }
        __syncwarp();  // the fields are written; the last tap's products are done

        for (int t = 0; t < 2 && k0 + t < KT; ++t) {
          const float* tw = fw + t * 16 * 4;
          const int* ti = fi + t * 16 * 4;
          // 16 pixels by CK / 4 channel groups over the lanes: for C 32, lane
          // takes channels 4 (lane % 8) of pixels lane / 8 + 4 i, unrolled
          if (CK4 == 8 && vec4) {
            const int c = 4 * (lane & 7);
#pragma unroll
            for (int i = 0; i < 4; ++i)
              combine_ring<true>(ring, tw, ti, (lane >> 3) + 4 * i, c, Cin, SA, a_hi, a_lo);
          } else {
            for (int e = lane; e < 16 * CK4; e += 32) {
              if (vec4)
                combine_ring<true>(ring, tw, ti, e / CK4, 4 * (e % CK4), Cin, SA, a_hi, a_lo);
              else
                combine_ring<false>(ring, tw, ti, e / CK4, 4 * (e % CK4), Cin, SA, a_hi, a_lo);
            }
          }
          __syncwarp();  // the samples are written
          const int k = k0 + t;
          contract_tap<F32>(acc, a_hi, a_lo, w_hi + k * NP * SA, w_lo + k * NP * SA, SA, CK,
                            n0, pl.NT, lane);
          __syncwarp();  // every lane's fragment loads are done before the next samples
        }
      }
      store_item(acc, o_s, pl.OS, out + pix0 * Cout, bias, np, Cout, n0, lane);
      __syncwarp();  // the staging and the offsets are read before they are refilled
    }
  }
  cp_async_wait<0>();  // nothing left in flight at exit
}

template <typename T, typename S>
int launch(const void* x, const void* offset, const void* mask, const void* weight,
           const float* bias, void* out, int B, int H, int W, int Cin, int Cout, int RB, int R,
           int NWB, int blocks, long long smem, cudaStream_t stream) {
  SlabPlan pl;
  if (!layout(W, Cin, Cout, (int)sizeof(T), (int)sizeof(S), RB, R, NWB, &pl) || pl.smem != smem)
    return (int)cudaErrorInvalidValue;
  // the schedule's ring: the band's RB + 7 rows, and V2's next RB beside them
  const int need = pl.convert ? RB + 7 : 2 * RB + 7;
  if (R < (need < H ? need : H) || blocks < 1) return (int)cudaErrorInvalidValue;
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const long long row_bytes = (long long)W * Cin * (long long)sizeof(T);
  pl.vec = (row_bytes % 16 == 0 && xa % 16 == 0) ? 16 : (row_bytes % 4 == 0 && xa % 4 == 0) ? 4 : 0;
  cudaError_t err = cudaFuncSetAttribute(slab_kernel<T, S>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  slab_kernel<T, S><<<(unsigned)blocks, NWB * 32, (size_t)smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(offset), static_cast<const T*>(mask),
      static_cast<const T*>(weight), bias, static_cast<T*>(out), B, H, W, Cin, Cout, pl);
  return (int)cudaGetLastError();
}

// SLAB_IN_X: the ring is in x's type (V2); else float32 (V3)
template <bool SLAB_IN_X>
int run(const void* x, const void* offset, const void* mask, const void* weight,
        const void* bias, void* out, int B, int H, int W, int Cin, int Cout, int windowed,
        int is_bf16, void* stream, int RB, int R, int NWB, int blocks, long long smem) {
  if (!windowed) return (int)cudaErrorInvalidValue;  // windowed semantics only
  const float* bs = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!is_bf16)
    return launch<float, float>(x, offset, mask, weight, bs, out, B, H, W, Cin, Cout, RB, R,
                                NWB, blocks, smem, s);
  if (SLAB_IN_X)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, offset, mask, weight, bs, out, B, H, W, Cin,
                                                Cout, RB, R, NWB, blocks, smem, s);
  return launch<__nv_bfloat16, float>(x, offset, mask, weight, bs, out, B, H, W, Cin, Cout, RB,
                                      R, NWB, blocks, smem, s);
}

long long smem_bytes(int W, int Cin, int Cout, int es, int ss, int RB, int R, int NWB) {
  SlabPlan pl;
  return layout(W, Cin, Cout, es, ss, RB, R, NWB, &pl) ? pl.smem : -1;
}

}  // namespace

extern "C" {

// x (B,H,W,Cin), offset (B,H,W,18), mask (B,H,W,9), weight (3,3,Cin,Cout),
// out (B,H,W,Cout): all contiguous, all float32 (is_bf16 = 0) or all bf16
// (is_bf16 = 1), out 16-byte aligned; bias float32 (Cout,) or null; windowed
// must be 1. The plan: RB output rows per band, R ring rows, NWB warps per
// block, `blocks` blocks, `smem` bytes of shared memory (`*_smem_bytes` of
// the same plan). Returns a cudaError_t.
int deform_fwd_qxhoist(const void* x, const void* offset, const void* mask, const void* weight,
                       const void* bias, void* out, int B, int H, int W, int Cin, int Cout,
                       int windowed, int is_bf16, void* stream, int RB, int R, int NWB,
                       int blocks, long long smem) {
  return run<true>(x, offset, mask, weight, bias, out, B, H, W, Cin, Cout, windowed, is_bf16,
                   stream, RB, R, NWB, blocks, smem);
}
int deform_fwd_cvt1(const void* x, const void* offset, const void* mask, const void* weight,
                    const void* bias, void* out, int B, int H, int W, int Cin, int Cout,
                    int windowed, int is_bf16, void* stream, int RB, int R, int NWB, int blocks,
                    long long smem) {
  return run<false>(x, offset, mask, weight, bias, out, B, H, W, Cin, Cout, windowed, is_bf16,
                    stream, RB, R, NWB, blocks, smem);
}

// Shared memory of one block of the plan (RB, R, NWB) at these sizes, or -1
// where it exceeds what a block may use.
long long deform_fwd_qxhoist_smem_bytes(int W, int Cin, int Cout, int is_bf16, int RB, int R,
                                        int NWB) {
  const int es = is_bf16 ? 2 : 4;
  return smem_bytes(W, Cin, Cout, es, es, RB, R, NWB);
}
long long deform_fwd_cvt1_smem_bytes(int W, int Cin, int Cout, int is_bf16, int RB, int R,
                                     int NWB) {
  return smem_bytes(W, Cin, Cout, is_bf16 ? 2 : 4, 4, RB, R, NWB);
}

}  // extern "C"
