// V4, V5 and V1 of the DCNv2 forward (3x3, stride 1, padding 1, NHWC,
// windowed semantics), redesigned for Hopper on K1's tensor-core design
// (deform_k1.cuh, deform_mma.cuh): warp items of 16 output pixels by up to
// 32 output channels, each tap's corner rows gathered by cp.async into a
// per-warp double-buffered stage, combined in float32 in K1's corner order,
// split into bf16 hi/lo and contracted with the tap's weight slice by
// `mma.sync.m16n8k16`, the sums kept in registers over the 9 taps (V1 on
// bf16 x feeds its corner products to the tensor cores with no combine).
//
//   V4 deform_fwd_slot_skip  tools/proto_deform_slot_skip.py `variant` (:75,
//                            call :84, body `_kernel_skip` :42): dead work
//                            skipped at run time
//   V5 deform_fwd_tapwalk    tools/proto_deform_tapwalk.py `variant` (:116,
//                            call :125, body `_kernel_tap` :83): the
//                            contraction walked tap-outer with one tap's
//                            weight slice resident
//   V1 deform_fwd_bf16_fma   tools/proto_deform_bf16_fma.py `variant` (:64,
//                            call :73, body `_kernel_bf16` :42): bf16 corner
//                            weights and bf16 corner products
//
// V4 and V5 compute K1's windowed function (per-tap +-2 px clamp), V1 its
// own. Their first designs, on the CUDA cores, stay in
// deform_fwd_variants.cu (`deform_fwd_slot_skip_simt`,
// `deform_fwd_tapwalk_simt`, `deform_fwd_bf16_fma_simt`) as their A/B
// baseline. Plain PyTorch versions: K1's, ops/deform_variants.py
// `windowed_plain` (V4, V5), and `deform_bf16_fma_plain` (V1).
//
// Bound on this card (H100 SXM, 3.35 TB/s): memory, as K1's: the function
// reads x, the offsets and the mask once and writes the output once (see
// deform_fwd.cu).
//
// V4 keeps K1's warp items and the 9 taps' weight resident in shared memory
// (K1's resident plan, the same bytes), and skips three kinds of dead work:
// * a corner whose weight is exactly 0 (fy or fx exactly 0 or 1 after the
//   clip, wv 0, or a product that underflows) starts no cp.async and adds no
//   term (`corner_nonzero`);
// * a tap with no live corner across the warp's 16 pixels, decided by
//   __ballot_sync as its corners are gathered (so the branch is
//   warp-uniform), skips its combine, its hi/lo split and its `mma.sync`;
// * an item with every tap live runs K1's loop as it is.
// K1 already skips a corner outside the image or of a dead tap; on offsets
// drawn from a continuous distribution fy and fx are almost never exactly 0
// or 1, so there V4 does K1's work plus one compare per corner and one
// ballot per tap.
//
// V5 holds one tap's weight slice where K1's resident plan holds all nine,
// and spends the freed shared memory on warps:
// * Persistent blocks walk rounds of NWB x IPW items (IPW items per warp,
//   whose sums all stay in registers over the 9 taps). The warps walk the
//   taps in lockstep; within a tap a warp takes its items in turn, its stage
//   double-buffered over the sequence of (tap, item) pairs, so the next
//   pair's corners are in flight while this one is combined and contracted.
// * The weight: `tapwalk_weight_kernel` writes it once per launch, with
//   stage_weight's arithmetic, into K1's bf16 B-fragment layout (hi, and lo
//   for a float32 weight) in a global scratch tensor the wrapper allocates;
//   cp.async copies bytes and cannot convert. The block holds two slices:
//   tap k + 1's is copied with cp.async while tap k is contracted, so a tap
//   costs one block barrier (K1's streamed plan takes two: deform_fwd.cu).
// * The plan (warps per block, items per warp, blocks, bytes) is chosen in
//   Python (ops/cuda_deform_variants.py `tc_plan`): the most warps that fit,
//   then the most items per warp. Two items a warp carry 16 more float32
//   sums a lane, so that instantiation is bounded at 12 warps (384 threads,
//   168 registers a thread) and the one-item one at K1's 16 (512, 128).
//   At C 64 in bf16 the two slices take 18,432 B where K1's resident weight
//   takes 82,944 B: 9 warps of two items where K1 fits 6 warps of one.
//
// Bits: V4 drops only products with an exact 0 and taps whose samples are
// all zero; V5 feeds each item's sums the same sequence of `mma.sync` calls
// as K1, the same fragments in tap order. So on finite inputs both give the
// Hopper K1's bits (chip_smoke.py holds them to `cuda_deform.deform_fwd`).
//
// V1 computes sum over the 4 corners q of bf16(bf16(w_q) * x_q[c]), summed
// in float32, contracted with the weight in float32 (the TPU prototype's
// function). By distributivity that is one contraction over (corner,
// channel) of the exact bf16 products with the weight, so on bf16 x V1
// keeps K1's resident plan, items and gathers (`gather_corner`, the stage's
// row slot q ^ (p & 1)) and, per tap and 16-channel step, treats the four
// corners as four times the contraction depth: each lane reads its A
// fragment straight from the stage, multiplies it by the corner's weight
// rounded to bf16 with __hmul2 (round to nearest; a bf16 product is what
// `mma.sync`'s A operand takes, so nothing is converted) and contracts it
// with K1's bf16 B fragments (hi only: a bf16 weight is exact). That drops
// K1's float32 combine, its hi/lo split and the A blocks' round trip
// through shared memory, for twice K1's `mma.sync` (4 corner terms against
// hi and lo); the A blocks' bytes stay in the layout, unused. A dead corner
// or a channel past Cin is not in the stage (stale bits, NaN among them), so
// its product is selected as 0, never a product with a zero weight. On
// float32 x a product bf16(w) * x is a float32 value: V1 keeps K1's combine
// with the first design's rounding (__fmul_rn, __fadd_rn in corner order),
// then K1's hi/lo split and three-term contraction. Its output is V1's
// function up to the order of float32 sums (chip_smoke.py holds it to
// `deform_bf16_fma_plain` and to the first design within
// `deform_variants.compare`'s limits, and K1's output outside them).
//
// `layout` recomputes the shared memory of the plan it is given and the
// launch refuses a plan whose bytes disagree, or one above 227 KB.
//
// Built by mgdt_yolo_tpu_torch/utils/build.py with nvcc for sm_90a; called
// through ctypes from mgdt_yolo_tpu_torch/ops/cuda_deform_variants.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "deform_common.cuh"
#include "deform_k1.cuh"
#include "deform_mma.cuh"

namespace {

using namespace deform;

constexpr long long MAX_SMEM = 232448;  // shared memory one block may use

enum Kind { SKIP, WALK, FMA };  // V4, V5, V1

// warps a block may have with IPW items a warp: the launch bound
constexpr int max_warps(int ipw) { return ipw == 1 ? 16 : 12; }

// One launch's shared-memory layout: WT taps of the weight, then each warp's
// regions (K1's, with IPW items' offsets and mask).
struct TcPlan {
  int WT;        // taps of the weight held: 9 (V4, V1), 2 (V5: this tap's and the next)
  int NWB, IPW;  // warps per block, items per warp
  int CK, SA, NP, NT, groups, RS, OS;  // K1's: depth, strides, n-tiles, stage and staging rows
  int vec;       // corner-row copies: 16- or 4-byte cp.async, 0 plain loads (set at launch)
  long long w_bytes;                                    // the weight, hi (and lo)
  long long a_off, f_off, o_off, o_bytes, s_off, warp_bytes;  // one warp's regions
  long long smem;
};

bool layout(int Cin, int Cout, int es, int WT, int NWB, int IPW, TcPlan* out) {
  if (Cin < 1 || Cout < 1 || IPW < 1 || IPW > 2 || NWB < 1 || NWB > max_warps(IPW)) return false;
  TcPlan p{};
  p.WT = WT;
  p.NWB = NWB;
  p.IPW = IPW;
  p.CK = (int)round_up(Cin, 16);
  p.SA = p.CK + 8;
  p.NP = (int)round_up(Cout, 8);
  p.NT = p.NP / 8;
  p.groups = (p.NT + NTW - 1) / NTW;
  p.RS = (int)round_up(Cin, 16 / es);
  p.OS = NTW * 8 + 4;
  p.w_bytes = (long long)WT * p.NP * p.SA * 2 * (es == 4 ? 2 : 1);
  p.a_off = 0;                                 // a_hi, a_lo: (16, SA) bf16 each
  p.f_off = p.a_off + 2LL * 16 * p.SA * 2;     // fw, fi: (2, 16, 4) each
  p.o_off = p.f_off + 2LL * 2 * 16 * 4 * 4;    // per item: offsets (16, 18), mask (16, 9)
  p.o_bytes = round_up(16LL * 27 * es, 16);
  p.s_off = p.o_off + IPW * p.o_bytes;         // stage (2, 16, 4, RS), or the output staging
  const long long stage = 2LL * 16 * 4 * p.RS * es, ostage = 16LL * p.OS * 4;
  p.warp_bytes = p.s_off + (stage > ostage ? stage : ostage);
  p.smem = p.w_bytes + NWB * p.warp_bytes;
  *out = p;
  return p.smem <= MAX_SMEM;
}

// ---------------------------------------------------------------- V4

template <typename T>
__global__ void __launch_bounds__(max_warps(1) * 32)
slot_skip_kernel(const T* __restrict__ x, const T* __restrict__ offset,
                 const T* __restrict__ mask, const T* __restrict__ weight,
                 const float* __restrict__ bias, T* __restrict__ out, int B, int H, int W,
                 int Cin, int Cout, const TcPlan pl) {
  constexpr bool F32 = sizeof(T) == 4;
  extern __shared__ __align__(16) unsigned char smem[];
  const int CK = pl.CK, SA = pl.SA, NP = pl.NP, RS = pl.RS;
  __nv_bfloat16* w_hi = reinterpret_cast<__nv_bfloat16*>(smem);  // (9, NP, SA): [k][o][c]
  __nv_bfloat16* w_lo = w_hi + KT * NP * SA;                      // float32 weights only

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

  stage_weight(w_hi, w_lo, weight, 0, KT, NP, CK, SA, Cin, Cout, tid, (int)blockDim.x);
  __syncthreads();  // the only block barrier: from here each warp runs alone

  const int P = H * W;
  const int tiles = (P + 15) / 16;
  const long long items = (long long)B * tiles * pl.groups;
  for (long long item = (long long)blockIdx.x * pl.NWB + warp; item < items;
       item += (long long)gridDim.x * pl.NWB) {
    const int ng = (int)(item % pl.groups);
    const long long t = item / pl.groups;
    const int b = (int)(t / tiles);
    const int p0 = (int)(t % tiles) * 16;
    const int np = min(16, P - p0);
    const size_t pix0 = (size_t)b * P + p0;
    const T* xb = x + (size_t)b * P * Cin;

    for (int e = lane; e < np * 2 * KT; e += 32) off_s[e] = offset[pix0 * (2 * KT) + e];
    for (int e = lane; e < np * KT; e += 32) m_s[e] = mask[pix0 * KT + e];
    __syncwarp();

    // lane: pixels lane / 4 and lane / 4 + 8, corner lane % 4
    int pi[2], pj[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      pi[h] = (p0 + (lane >> 2) + 8 * h) / W;
      pj[h] = (p0 + (lane >> 2) + 8 * h) % W;
    }
    unsigned live = 0;  // bit k: tap k has a live corner among the item's pixels
    auto gather = [&](int k, int buf) {
      bool any = false;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        any |= gather_corner<true>(off_s, m_s, (lane >> 2) + 8 * h, lane & 3, np, pi[h], pj[h],
                                   k, H, W, Cin, RS, pl.vec, xb, stage + buf * 16 * 4 * RS,
                                   fw + buf * 16 * 4, fi + buf * 16 * 4);
      if (__ballot_sync(0xffffffffu, any)) live |= 1u << k;
    };

    const int n0 = ng * NTW;  // this item's first n-tile
    float acc[NTW][4];
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[j][r] = 0.f;

    gather(0, 0);
    cp_async_commit();
    for (int k = 0; k < KT; ++k) {
      if (k + 1 < KT) gather(k + 1, (k + 1) & 1);
      cp_async_commit();
      // a dead tap copied nothing; its samples would be zeros, whose
      // products leave the sums as they are
      if (!((live >> k) & 1u)) continue;
      cp_async_wait<1>();  // tap k's copies have landed (this lane's) ...
      __syncwarp();        // ... and every lane's; the last live tap's products are done
      const int buf = k & 1;
      combine_stage(stage + buf * 16 * 4 * RS, fw + buf * 16 * 4, fi + buf * 16 * 4, Cin, CK,
                    RS, SA, a_hi, a_lo, lane);
      __syncwarp();
      contract_tap<F32>(acc, a_hi, a_lo, w_hi + k * NP * SA, w_lo + k * NP * SA, SA, CK, n0,
                        pl.NT, lane);
    }
    // epilogue through the stage: no copy is in flight (a dead tap starts
    // none) and every lane passed the last live combine
    store_item(acc, o_s, pl.OS, out + pix0 * Cout, bias, np, Cout, n0, lane);
    __syncwarp();  // the staging and the offsets are read before the next item refills them
  }
}

// ---------------------------------------------------------------- V5

// The weight in K1's B-fragment layout, once per launch: w[k][c][o] ->
// wsl[k][o][c] (hi), and wsl[9 + k][o][c] (lo) for a float32 weight, each
// tap's slice (NP, SA), by stage_weight over the grid's threads. The padding
// columns CK .. SA - 1 are never read.
template <typename T>
__global__ void tapwalk_weight_kernel(const T* __restrict__ weight, __nv_bfloat16* wsl,
                                      int Cin, int Cout, int NP, int CK, int SA) {
  stage_weight(wsl, wsl + KT * NP * SA, weight, 0, KT, NP, CK, SA, Cin, Cout,
               (int)(blockIdx.x * blockDim.x + threadIdx.x), (int)(gridDim.x * blockDim.x));
}

// one warp item: its pixels' offsets and mask, image, output row and n-tiles
template <typename T>
struct Item {
  const T* off;   // (16, 18) in shared memory, then the mask (16, 9)
  const T* xb;    // its image
  size_t pix0;    // its first pixel over the batch
  int np, n0;     // pixels, first n-tile
  int pi[2], pj[2];  // positions of the lane's pixels lane / 4, lane / 4 + 8
};

template <typename T, int IPW>
__global__ void __launch_bounds__(max_warps(IPW) * 32)
tapwalk_kernel(const T* __restrict__ x, const T* __restrict__ offset,
               const T* __restrict__ mask, const __nv_bfloat16* __restrict__ wsl,
               const float* __restrict__ bias, T* __restrict__ out, int B, int H, int W,
               int Cin, int Cout, const TcPlan pl) {
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int PARTS = F32 ? 2 : 1;  // hi, and lo for a float32 weight
  extern __shared__ __align__(16) unsigned char smem[];
  const int CK = pl.CK, SA = pl.SA, RS = pl.RS, NWB = pl.NWB;
  const int slice = pl.NP * SA;  // elements of one tap's slice of one part
  // (PARTS, 2, NP, SA): the slices of taps t and t + 1, in buffers t & 1
  __nv_bfloat16* w_s = reinterpret_cast<__nv_bfloat16*>(smem);
  auto w_buf = [&](int part, int buf) { return w_s + (part * 2 + buf) * slice; };

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nth = blockDim.x;
  unsigned char* mine = smem + pl.w_bytes + warp * pl.warp_bytes;  // this warp's regions
  __nv_bfloat16* a_hi = reinterpret_cast<__nv_bfloat16*>(mine + pl.a_off);  // (16, SA)
  __nv_bfloat16* a_lo = a_hi + 16 * SA;
  float* fw = reinterpret_cast<float*>(mine + pl.f_off);  // (2, 16, 4) corner weights
  int* fi = reinterpret_cast<int*>(fw + 2 * 16 * 4);      // (2, 16, 4) pixel, -1 = none
  T* stage = reinterpret_cast<T*>(mine + pl.s_off);       // (2, 16, 4, RS)
  float* o_s = reinterpret_cast<float*>(stage);           // (16, OS) after the last tap

  // tap k's slice into weight buffer buf, by every thread of the block, as
  // one group of cp.async copies (an empty group where k < 0)
  const int chunks = slice * 2 / 16;  // 16-byte chunks of one part's slice
  auto load_slice = [&](int k, int buf) {
    if (k >= 0) {
      for (int e = tid; e < PARTS * chunks; e += nth) {
        const int part = e / chunks, c = e % chunks;
        cp_async16(reinterpret_cast<char*>(w_buf(part, buf)) + 16 * c,
                   reinterpret_cast<const char*>(wsl + ((size_t)part * KT + k) * slice) + 16 * c);
      }
    }
    cp_async_commit();
  };

  const int P = H * W;
  const int tiles = (P + 15) / 16;
  const long long items = (long long)B * tiles * pl.groups;
  const int per_round = NWB * IPW;
  const long long rounds = (items + per_round - 1) / per_round;

  // tap k's corners of item m into tap buffer buf, one lane per (pixel, corner)
  auto gather = [&](int k, const Item<T>& m, int buf) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      gather_corner<false>(m.off, m.off + 16 * 2 * KT, (lane >> 2) + 8 * h, lane & 3, m.np,
                           m.pi[h], m.pj[h], k, H, W, Cin, RS, pl.vec, m.xb,
                           stage + buf * 16 * 4 * RS, fw + buf * 16 * 4, fi + buf * 16 * 4);
  };
  // pair j of a round, (tap k, item m), from tap buffer j & 1, contracted
  // with the weight in buffer wb into acc
  auto compute = [&](int j, int wb, const Item<T>& m, float (&acc)[NTW][4]) {
    const int buf = j & 1;
    combine_stage(stage + buf * 16 * 4 * RS, fw + buf * 16 * 4, fi + buf * 16 * 4, Cin, CK, RS,
                  SA, a_hi, a_lo, lane);
    __syncwarp();
    contract_tap<F32>(acc, a_hi, a_lo, w_buf(0, wb), w_buf(PARTS - 1, wb), SA, CK, m.n0,
                      pl.NT, lane);
  };

  int t = 0;  // taps this block has walked: tap t contracts with weight buffer t & 1
  load_slice(blockIdx.x < rounds ? 0 : -1, 0);
  for (long long r = blockIdx.x; r < rounds; r += gridDim.x) {
    // the warp's items r * per_round + i * NWB + warp: those below `items`
    // are live, and they are a prefix (i < nlive)
    Item<T> it[IPW];
    int nlive = 0;
#pragma unroll
    for (int i = 0; i < IPW; ++i) {
      const long long item = r * per_round + (long long)i * NWB + warp;
      T* off_s = reinterpret_cast<T*>(mine + pl.o_off + i * pl.o_bytes);
      it[i].off = off_s;
      if (item < items) {
        ++nlive;
        const long long tl = item / pl.groups;
        const int b = (int)(tl / tiles);
        const int p0 = (int)(tl % tiles) * 16;
        it[i].np = min(16, P - p0);
        it[i].n0 = (int)(item % pl.groups) * NTW;
        it[i].pix0 = (size_t)b * P + p0;
        it[i].xb = x + (size_t)b * P * Cin;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          it[i].pi[h] = (p0 + (lane >> 2) + 8 * h) / W;
          it[i].pj[h] = (p0 + (lane >> 2) + 8 * h) % W;
        }
        const int np = it[i].np;
        for (int e = lane; e < np * 2 * KT; e += 32) off_s[e] = offset[it[i].pix0 * (2 * KT) + e];
        for (int e = lane; e < np * KT; e += 32)
          off_s[16 * 2 * KT + e] = mask[it[i].pix0 * KT + e];
      }
    }
    __syncwarp();

    float acc[IPW][NTW][4];
#pragma unroll
    for (int i = 0; i < IPW; ++i)
#pragma unroll
      for (int j = 0; j < NTW; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

    if (nlive > 0) gather(0, it[0], 0);
    cp_async_commit();
    int j = 0;  // (tap, item) pairs this warp has walked in this round
    for (int k = 0; k < KT; ++k, ++t) {
      cp_async_wait<0>();  // this thread's copies: tap t's slice and pair j's corners
      __syncthreads();     // every thread's; every warp is done with tap t - 1's slice
                           // and with the tap buffer pair j + 1 will fill
      // item 0: the next pair's corners, then tap t + 1's slice into the
      // buffer tap t - 1 used (the next round's tap 0 after tap 8), both in
      // flight while this pair is combined and contracted
      if (nlive > 0) {
        if (nlive > 1) gather(k, it[IPW > 1 ? 1 : 0], (j + 1) & 1);
        else if (k + 1 < KT) gather(k + 1, it[0], (j + 1) & 1);
      }
      cp_async_commit();
      load_slice(k + 1 < KT ? k + 1 : (r + gridDim.x < rounds ? 0 : -1), (t + 1) & 1);
      if (nlive > 0) {
        __syncwarp();
        compute(j, t & 1, it[0], acc[0]);
        ++j;
      }
      // item 1 (two items a warp): its corners were gathered during item 0
#pragma unroll
      for (int i = 1; i < IPW; ++i) {
        if (i < nlive) {
          if (i + 1 < nlive) gather(k, it[i + 1 < IPW ? i + 1 : i], (j + 1) & 1);
          else if (k + 1 < KT) gather(k + 1, it[0], (j + 1) & 1);
          cp_async_commit();
          // at most the slice's group and this one's in flight: pair j's
          // corners, committed before both, have landed
          cp_async_wait<2>();
          __syncwarp();  // every lane's; the last pair's products are done
          compute(j, t & 1, it[i], acc[i]);
          ++j;
        }
      }
    }

    // the epilogue through the stage: no corner copy is in flight (tap 8's
    // last pair gathers nothing) and every lane passed the last combine
#pragma unroll
    for (int i = 0; i < IPW; ++i) {
      if (i < nlive) {
        store_item(acc[i], o_s, pl.OS, out + it[i].pix0 * Cout, bias, it[i].np, Cout, it[i].n0,
                   lane);
        __syncwarp();  // the staging is read before the next item's epilogue refills it
      }
    }
  }
  cp_async_wait<0>();  // nothing left in flight at exit
}

// ---------------------------------------------------------------- V1

// Channels c0 .. c0 + 3 (c0 a multiple of 4) of one bf16 corner row of the
// stage, each times the corner's weight w2 (bf16, broadcast) by __hmul2,
// round to nearest: two bf16x2 registers, the lower channel in the low half.
// 0 for a dead corner (`live` false), whose row nobody wrote this tap and
// may hold stale bits, NaN among them (0 * NaN is NaN, so the row is never
// read), and for channels at or past Cin, which the copies did not write
// either. The 8-byte read stays inside the row (RS is Cin rounded up to 8).
__device__ __forceinline__ uint2 corner_products(const __nv_bfloat16* row, int c0, int Cin,
                                                 bool live, __nv_bfloat162 w2) {
  if (!live || c0 >= Cin) return make_uint2(0u, 0u);
  uint2 v = *reinterpret_cast<const uint2*>(row + c0);
  const int n = Cin - c0;  // of the four channels, those below Cin
  if (n < 4) {
    v.y = n == 3 ? (v.y & 0xffffu) : 0u;
    if (n == 1) v.x &= 0xffffu;
  }
  const __nv_bfloat162 lo = __hmul2(w2, *reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const __nv_bfloat162 hi = __hmul2(w2, *reinterpret_cast<const __nv_bfloat162*>(&v.y));
  return make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                    *reinterpret_cast<const uint32_t*>(&hi));
}

// V1's contraction of one tap on bf16 x: the warp's 16 pixels' bf16 corner
// products (stage, fw, fi as `gather_corner` left them) times the tap's
// weight slice wk ((NP, SA) n-major, bf16) into acc, n-tiles n0 .. n0 +
// NTW - 1 below NT, the four corners as four times the depth: per 16-channel
// step kk, corners (0,0), (0,1), (1,0), (1,1) in turn. Lane (g, t) holds the
// A rows g and g + 8, pixels of one parity, so corner q of both lies in row
// slot q ^ (g & 1). Within a step the channels are permuted, the same way in
// A and B (a sum over them does not depend on their order): the fragment's
// depth 2t, 2t + 1 holds channels kk + 4t, kk + 4t + 1 and depth 2t + 8,
// 2t + 9 channels kk + 4t + 2, kk + 4t + 3, so a lane reads each of its A
// rows and B columns as one 8-byte load.
__device__ __forceinline__ void contract_corners(float (&acc)[NTW][4],
                                                 const __nv_bfloat16* stage, const float* fw,
                                                 const int* fi, const __nv_bfloat16* wk,
                                                 int Cin, int CK, int RS, int SA, int n0,
                                                 int NT, int lane) {
  const int g = lane >> 2, c4 = 4 * (lane & 3), sw = g & 1;
  __nv_bfloat162 w2[2][4];
  bool live[2][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float4 wq = *reinterpret_cast<const float4*>(fw + (g + 8 * h) * 4);
    const int4 src = *reinterpret_cast<const int4*>(fi + (g + 8 * h) * 4);
    const float w4[4] = {wq.x, wq.y, wq.z, wq.w};
    const int s4[4] = {src.x, src.y, src.z, src.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      w2[h][q] = __bfloat162bfloat162(__float2bfloat16_rn(w4[q]));
      live[h][q] = s4[q] >= 0;
    }
  }
  const __nv_bfloat16* rows[2] = {stage + (size_t)g * 4 * RS, stage + (size_t)(g + 8) * 4 * RS};
  for (int kk = 0; kk < CK; kk += 16) {
    const int c0 = kk + c4;
    uint32_t b[NTW][2] = {};
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
      if (n0 + j < NT) {
        const uint2 u =
            *reinterpret_cast<const uint2*>(wk + (size_t)((n0 + j) * 8 + g) * SA + c0);
        b[j][0] = u.x;
        b[j][1] = u.y;
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t a[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint2 v = corner_products(rows[h] + (q ^ sw) * RS, c0, Cin, live[h][q], w2[h][q]);
        a[h] = v.x;      // rows g, g + 8 at depth 2t, 2t + 1
        a[h + 2] = v.y;  // and at depth 2t + 8, 2t + 9
      }
#pragma unroll
      for (int j = 0; j < NTW; ++j)
        if (n0 + j < NT) mma_bf16(acc[j], a, b[j]);
    }
  }
}

// V1's combine of one tap on float32 x, the first design's arithmetic
// (deform_fwd_variants.cu `bf16_fma_kernel`): each live corner's weight
// rounded to bf16, its product with the row by __fmul_rn and the sum by
// __fadd_rn from +0 in K1's corner order, so nvcc fuses nothing; then
// split into the bf16 hi and lo sample blocks (row stride SA; zero past Cin
// and for pixels past the item's). The lanes take (pixel, 4 channels) pairs,
// as `combine_stage` does.
__device__ __forceinline__ void combine_rounded(const float* stage, const float* fw,
                                                const int* fi, int Cin, int CK, int RS, int SA,
                                                __nv_bfloat16* a_hi, __nv_bfloat16* a_lo,
                                                int lane) {
  auto one = [&](int p, int c) {
    const float* row = stage + (size_t)p * 4 * RS;
    const int sw = p & 1;
    float s[4] = {0.f, 0.f, 0.f, 0.f}, v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (fi[p * 4 + q] >= 0) {
        const float w = round_to<__nv_bfloat16>(fw[p * 4 + q]);
        load4<true>(row + (q ^ sw) * RS, c, Cin, v);
#pragma unroll
        for (int u = 0; u < 4; ++u) s[u] = __fadd_rn(s[u], __fmul_rn(w, v[u]));
      }
    }
    __nv_bfloat16 h[4], l[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) split_bf16(s[u], h[u], l[u]);
    *reinterpret_cast<uint2*>(a_hi + p * SA + c) =
        make_uint2(pack_bf16(h[0], h[1]), pack_bf16(h[2], h[3]));
    *reinterpret_cast<uint2*>(a_lo + p * SA + c) =
        make_uint2(pack_bf16(l[0], l[1]), pack_bf16(l[2], l[3]));
  };
  const int CK4 = CK / 4;
  if (32 % CK4 == 0) {
    const int c = 4 * (lane % CK4);
    for (int p = lane / CK4; p < 16; p += 32 / CK4) one(p, c);
  } else {
    for (int e = lane; e < 16 * CK4; e += 32) one(e / CK4, 4 * (e % CK4));
  }
}

// V1: K1's resident plan, items and gathers; per tap, on bf16 x the corner
// products go to the tensor cores as they are (`contract_corners`), on
// float32 x through V1's combine and K1's hi/lo contraction.
template <typename T>
__global__ void __launch_bounds__(max_warps(1) * 32)
bf16_fma_kernel(const T* __restrict__ x, const T* __restrict__ offset,
                const T* __restrict__ mask, const T* __restrict__ weight,
                const float* __restrict__ bias, T* __restrict__ out, int B, int H, int W,
                int Cin, int Cout, const TcPlan pl) {
  constexpr bool F32 = sizeof(T) == 4;
  extern __shared__ __align__(16) unsigned char smem[];
  const int CK = pl.CK, SA = pl.SA, NP = pl.NP, RS = pl.RS;
  __nv_bfloat16* w_hi = reinterpret_cast<__nv_bfloat16*>(smem);  // (9, NP, SA): [k][o][c]
  __nv_bfloat16* w_lo = w_hi + KT * NP * SA;                      // float32 weights only

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned char* mine = smem + pl.w_bytes + warp * pl.warp_bytes;  // this warp's regions
  __nv_bfloat16* a_hi = reinterpret_cast<__nv_bfloat16*>(mine + pl.a_off);  // (16, SA), float32 x
  __nv_bfloat16* a_lo = a_hi + 16 * SA;
  float* fw = reinterpret_cast<float*>(mine + pl.f_off);  // (2, 16, 4) corner weights
  int* fi = reinterpret_cast<int*>(fw + 2 * 16 * 4);      // (2, 16, 4) pixel, -1 = none
  T* off_s = reinterpret_cast<T*>(mine + pl.o_off);       // (16, 18)
  T* m_s = off_s + 16 * 2 * KT;                           // (16, 9)
  T* stage = reinterpret_cast<T*>(mine + pl.s_off);       // (2, 16, 4, RS)
  float* o_s = reinterpret_cast<float*>(stage);           // (16, OS) after the last tap

  stage_weight(w_hi, w_lo, weight, 0, KT, NP, CK, SA, Cin, Cout, tid, (int)blockDim.x);
  __syncthreads();  // the only block barrier: from here each warp runs alone

  const int P = H * W;
  const int tiles = (P + 15) / 16;
  const long long items = (long long)B * tiles * pl.groups;
  for (long long item = (long long)blockIdx.x * pl.NWB + warp; item < items;
       item += (long long)gridDim.x * pl.NWB) {
    const int ng = (int)(item % pl.groups);
    const long long t = item / pl.groups;
    const int b = (int)(t / tiles);
    const int p0 = (int)(t % tiles) * 16;
    const int np = min(16, P - p0);
    const size_t pix0 = (size_t)b * P + p0;
    const T* xb = x + (size_t)b * P * Cin;

    for (int e = lane; e < np * 2 * KT; e += 32) off_s[e] = offset[pix0 * (2 * KT) + e];
    for (int e = lane; e < np * KT; e += 32) m_s[e] = mask[pix0 * KT + e];
    __syncwarp();

    // lane: pixels lane / 4 and lane / 4 + 8, corner lane % 4
    int pi[2], pj[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      pi[h] = (p0 + (lane >> 2) + 8 * h) / W;
      pj[h] = (p0 + (lane >> 2) + 8 * h) % W;
    }
    auto gather = [&](int k, int buf) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        gather_corner<false>(off_s, m_s, (lane >> 2) + 8 * h, lane & 3, np, pi[h], pj[h], k, H,
                             W, Cin, RS, pl.vec, xb, stage + buf * 16 * 4 * RS,
                             fw + buf * 16 * 4, fi + buf * 16 * 4);
    };

    const int n0 = ng * NTW;  // this item's first n-tile
    float acc[NTW][4];
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[j][r] = 0.f;

    gather(0, 0);
    cp_async_commit();
    for (int k = 0; k < KT; ++k) {
      if (k + 1 < KT) gather(k + 1, (k + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();  // tap k's copies have landed (this lane's) ...
      __syncwarp();        // ... and every lane's; the last tap's products are done
      const int buf = k & 1;
      const T* st = stage + buf * 16 * 4 * RS;
      if constexpr (F32) {
        combine_rounded(st, fw + buf * 16 * 4, fi + buf * 16 * 4, Cin, CK, RS, SA, a_hi, a_lo,
                        lane);
        __syncwarp();
        contract_tap<true>(acc, a_hi, a_lo, w_hi + k * NP * SA, w_lo + k * NP * SA, SA, CK, n0,
                           pl.NT, lane);
      } else {
        contract_corners(acc, st, fw + buf * 16 * 4, fi + buf * 16 * 4, w_hi + k * NP * SA, Cin,
                         CK, RS, SA, n0, pl.NT, lane);
        __syncwarp();  // every lane has read tap k's stage before tap k + 2's copies refill it
      }
    }
    // epilogue through the stage: no copy is in flight and every lane is
    // done with the last tap's stage
    store_item(acc, o_s, pl.OS, out + pix0 * Cout, bias, np, Cout, n0, lane);
    __syncwarp();  // the staging and the offsets are read before the next item refills them
  }
}

// ---------------------------------------------------------------- launch

template <typename K>
int prepare(K kernel, int threads, long long smem) {
  if (threads < 32 || smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

template <typename T>
int launch(Kind kind, const void* x, const void* offset, const void* mask, const void* weight,
           const float* bias, void* out, void* scratch, int B, int H, int W, int Cin, int Cout,
           int NWB, int IPW, int blocks, long long smem, cudaStream_t stream) {
  const int es = (int)sizeof(T);
  const bool walk = kind == WALK;
  TcPlan pl;
  if (!layout(Cin, Cout, es, walk ? 2 : KT, NWB, IPW, &pl) || pl.smem != smem || blocks < 1 ||
      (!walk && IPW != 1) || (walk && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const int row_bytes = Cin * es;
  pl.vec = (row_bytes % 16 == 0 && xa % 16 == 0) ? 16 : (row_bytes % 4 == 0 && xa % 4 == 0) ? 4 : 0;
  const T* xt = static_cast<const T*>(x);
  const T* ot = static_cast<const T*>(offset);
  const T* mt = static_cast<const T*>(mask);
  T* yt = static_cast<T*>(out);
  const int threads = NWB * 32;
  int err;
  if (kind == SKIP) {
    if ((err = prepare(slot_skip_kernel<T>, threads, smem)) != 0) return err;
    slot_skip_kernel<T><<<(unsigned)blocks, threads, (size_t)smem, stream>>>(
        xt, ot, mt, static_cast<const T*>(weight), bias, yt, B, H, W, Cin, Cout, pl);
    return (int)cudaGetLastError();
  }
  if (kind == FMA) {
    if ((err = prepare(bf16_fma_kernel<T>, threads, smem)) != 0) return err;
    bf16_fma_kernel<T><<<(unsigned)blocks, threads, (size_t)smem, stream>>>(
        xt, ot, mt, static_cast<const T*>(weight), bias, yt, B, H, W, Cin, Cout, pl);
    return (int)cudaGetLastError();
  }
  __nv_bfloat16* wsl = static_cast<__nv_bfloat16*>(scratch);
  const int n = KT * pl.NP * pl.CK;
  tapwalk_weight_kernel<T><<<(n + 255) / 256, 256, 0, stream>>>(
      static_cast<const T*>(weight), wsl, Cin, Cout, pl.NP, pl.CK, pl.SA);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  if (IPW == 1) {
    if ((err = prepare(tapwalk_kernel<T, 1>, threads, smem)) != 0) return err;
    tapwalk_kernel<T, 1><<<(unsigned)blocks, threads, (size_t)smem, stream>>>(
        xt, ot, mt, wsl, bias, yt, B, H, W, Cin, Cout, pl);
  } else {
    if ((err = prepare(tapwalk_kernel<T, 2>, threads, smem)) != 0) return err;
    tapwalk_kernel<T, 2><<<(unsigned)blocks, threads, (size_t)smem, stream>>>(
        xt, ot, mt, wsl, bias, yt, B, H, W, Cin, Cout, pl);
  }
  return (int)cudaGetLastError();
}

int run(Kind kind, const void* x, const void* offset, const void* mask, const void* weight,
        const void* bias, void* out, void* scratch, int B, int H, int W, int Cin, int Cout,
        int windowed, int is_bf16, void* stream, int NWB, int IPW, int blocks, long long smem) {
  if (!windowed) return (int)cudaErrorInvalidValue;  // windowed semantics only
  const float* bs = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(kind, x, offset, mask, weight, bs, out, scratch, B, H, W, Cin,
                                 Cout, NWB, IPW, blocks, smem, s);
  return launch<float>(kind, x, offset, mask, weight, bs, out, scratch, B, H, W, Cin, Cout, NWB,
                       IPW, blocks, smem, s);
}

long long smem_bytes(Kind kind, int Cin, int Cout, int is_bf16, int NWB, int IPW) {
  TcPlan pl;
  const bool walk = kind == WALK;
  if (!walk && IPW != 1) return -1;
  return layout(Cin, Cout, is_bf16 ? 2 : 4, walk ? 2 : KT, NWB, IPW, &pl) ? pl.smem : -1;
}

}  // namespace

extern "C" {

// x (B,H,W,Cin), offset (B,H,W,18), mask (B,H,W,9), weight (3,3,Cin,Cout),
// out (B,H,W,Cout): all contiguous, all float32 (is_bf16 = 0) or all bf16
// (is_bf16 = 1), out 16-byte aligned; bias float32 (Cout,) or null; windowed
// must be 1. The plan: NWB warps per block, IPW items per warp (V4, V1: 1),
// `blocks` blocks, `smem` bytes of shared memory (`*_smem_bytes` of the same
// plan). V5's `scratch` holds (2 for a float32 weight, else 1) x 9 x NP x SA
// bf16 (NP: Cout padded to 8; SA: Cin padded to 16, plus 8), 16-byte
// aligned; V4 and V1 take null. Returns a cudaError_t.
int deform_fwd_slot_skip(const void* x, const void* offset, const void* mask, const void* weight,
                         const void* bias, void* out, void* scratch, int B, int H, int W,
                         int Cin, int Cout, int windowed, int is_bf16, void* stream, int NWB,
                         int IPW, int blocks, long long smem) {
  return run(SKIP, x, offset, mask, weight, bias, out, scratch, B, H, W, Cin, Cout, windowed,
             is_bf16, stream, NWB, IPW, blocks, smem);
}
int deform_fwd_tapwalk(const void* x, const void* offset, const void* mask, const void* weight,
                       const void* bias, void* out, void* scratch, int B, int H, int W, int Cin,
                       int Cout, int windowed, int is_bf16, void* stream, int NWB, int IPW,
                       int blocks, long long smem) {
  return run(WALK, x, offset, mask, weight, bias, out, scratch, B, H, W, Cin, Cout, windowed,
             is_bf16, stream, NWB, IPW, blocks, smem);
}
int deform_fwd_bf16_fma(const void* x, const void* offset, const void* mask, const void* weight,
                        const void* bias, void* out, void* scratch, int B, int H, int W, int Cin,
                        int Cout, int windowed, int is_bf16, void* stream, int NWB, int IPW,
                        int blocks, long long smem) {
  return run(FMA, x, offset, mask, weight, bias, out, scratch, B, H, W, Cin, Cout, windowed,
             is_bf16, stream, NWB, IPW, blocks, smem);
}

// Shared memory of one block of the plan (NWB, IPW) at these channel counts
// and type, or -1 where it exceeds what a block may use or the plan is not
// the kernel's.
long long deform_fwd_slot_skip_smem_bytes(int Cin, int Cout, int is_bf16, int NWB, int IPW) {
  return smem_bytes(SKIP, Cin, Cout, is_bf16, NWB, IPW);
}
long long deform_fwd_tapwalk_smem_bytes(int Cin, int Cout, int is_bf16, int NWB, int IPW) {
  return smem_bytes(WALK, Cin, Cout, is_bf16, NWB, IPW);
}
long long deform_fwd_bf16_fma_smem_bytes(int Cin, int Cout, int is_bf16, int NWB, int IPW) {
  return smem_bytes(FMA, Cin, Cout, is_bf16, NWB, IPW);
}

}  // extern "C"
