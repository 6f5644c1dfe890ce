// DCNv2 backward (3x3, stride 1, padding 1), NHWC, redesigned for Hopper:
// from the output gradient g, the gradients of x, offset, mask and weight,
// with both contractions against the weight on the tensor cores and dx
// accumulated in a shared-memory window of rows.
//
// Replaces: mgdt_yolo_tpu/ops/pallas_deform.py, `_bwd_kernel` (:195, called by
// `deform_sample_bwd`, :272) together with the two einsums and the
// overlap-add of its glue `_mdcv2_bwd` (:336). Per tile, for the 9 taps k:
//
//   ds_k    = round_to_x_type(g . W_k^T)                 (tile, Cin), tensor cores
//   s_k     = round_to_x_type(sum_q w_q x[corner_q])     recomputed, CUDA cores
//   dw_q    = sum_c ds_k[c] x[corner_q, c]               CUDA cores
//   dx[corner_q, c] += w_q ds_k[c]                       shared-memory window
//   d offset_y = wv sum_q (+/-) dw_q ax_q pass_y, likewise x
//   d mask     = sum_q dw_q ay_q ax_q valid
//   dW_k   += s_k^T . g                                  (Cin, Cout), tensor cores
//
// with w_q = ay_q ax_q wv and wv = mask * valid, at the fields of
// deform_common.cuh, the forward kernel's. Plain PyTorch version:
// ops/deform.py, `modulated_deform_conv2d_plain_bwd`.
//
// Bound on this card (H100 SXM, 3.35 TB/s, 989 TFLOP/s bf16): memory. At the
// main path's shape (80x80, C 32 -> 32, bf16) the function must read x,
// offset, mask and g and write dx, d offset and d mask, ~300 B per pixel
// (0.0184 ms at batch 32), against ~0.04 MFLOP per pixel of contraction and
// sampling.
//
// What the first design (deform_bwd_simt.cu, "SIMT K2") left on the table, and
// what this one does about it:
// * SIMT K2 runs both contractions on the CUDA cores out of shared memory,
//   two scalar shared loads per FMA (~1.2M loads per 32-pixel tile). Here
//   ds_k and dW_k are `mma.sync.m16n8k16` products (deform_mma.cuh). On the
//   bf16 path every operand is bf16-exact (g, W, the rounded ds and s), so
//   the tensor cores change only the order of the float32 sums; a float32
//   operand is split into bf16 hi + lo and takes hi.hi + lo.hi + hi.lo.
// * SIMT K2 scatters dx with one float32 global atomic per (pixel, tap,
//   corner, channel): ~236M at batch 32, ~36 per dx element. Here a tile is
//   one row (or a column segment of it). Under windowed semantics tap k's
//   floor is clamped to [t, t + 4] in the window of pixel (i, j) that starts
//   at row i - 3 (deform_common.cuh), so every corner of (i, j) lies in rows
//   [i - 3, i + 4] and columns [j - 3, j + 4]: row r scatters only into rows
//   r - 3 .. r + 4, an 8 x W x Cin float32 window in shared memory, held as
//   a ring indexed by row mod 8 and accumulated with shared atomics. Each
//   block walks a contiguous run of rows, so the window carries from row to
//   row: when row r is done, row r - 3 leaves the ring and is flushed once
//   into dx with float4 global atomics (sm_90), and at the end of a run the
//   rest is: about one global atomic element per dx element, in a quarter
//   as many operations. A segment of WS columns adds 3 columns of halo on
//   each side. Exact semantics can reach further (offsets of +-4 px do); a
//   corner outside the window goes straight to a float32 global atomic, so
//   the window is only a fast path.
// * Shared-memory float atomics are compare-and-swap loops on this card, so
//   they cost little only where no two lanes meet: eight lanes take one
//   (pixel, tap) with four channels each (8- or 16-byte x loads, the four
//   corners' loads issued together); the four groups of a warp take items a
//   quarter of the row's 9 * W apart, consecutive warps pixels 37 (or the
//   next number prime to the row's width) apart, and group g adds its four
//   channels starting at channel g, so a warp's 32 atomics fall on 32
//   different banks and, but for rare overlaps, on cells nobody else is
//   adding to at that moment.
// * SIMT K2 takes 166.5 KB of shared memory for 512 threads, one block per
//   SM, four barriers per 32-pixel tile with the gathers' latency uncovered.
//   Here one persistent 512-thread block per SM (16 warps) takes all 9 taps
//   of an 80-pixel row in each phase (ds for all taps, the corners, dW for
//   all taps): four barriers per row. dW stays in registers over the
//   block's tiles, each warp owning fixed (tap, 16x8 block, k-part)
//   products, and leaves the block once.
// * Wide channels: the 9 taps' weight, s^T and ds outgrow a block's shared
//   memory in float32 from C 64 (the hi/lo weight alone is 165,888 B there)
//   and in bf16 above C 64. Where no tile of that plan fits, a second plan
//   ("streamed") holds one tap at a time: per tile, for each tap, the tap's
//   weight slice is staged, then its ds, its corners and its dW products
//   run, three barriers per tap. The window, the ring of rows and the
//   float32 hi/lo terms are the same. Square C up to 144 (float32) and 194
//   (bf16) fits one of the two plans at every map width.
//
// Built by mgdt_yolo_tpu_torch/utils/build.py with nvcc for sm_90a; called
// through ctypes from mgdt_yolo_tpu_torch/ops/cuda_deform.py (`deform_bwd`).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "deform_common.cuh"
#include "deform_mma.cuh"

namespace {

using namespace deform;

constexpr int THREADS = 512;
constexpr int NW = THREADS / 32;
constexpr int JMAX = 5;                 // dW products a warp keeps in registers
constexpr int WR = 8;                   // dx window rows: a ring over rows r - 3 .. r + 4
constexpr long long MAX_SMEM = 232448;  // shared memory one block may use

// The launch's shape: tile, padding, strides and shared-memory regions.
struct BwdPlan {
  int stream;       // 0: all 9 taps per phase; 1: one tap at a time, its weight staged
  int WS, TP;       // tile: a segment of WS columns of one row; TP = WS padded to 16
  int WW;           // dx window columns: min(W, WS + 7)
  int CinP8, CinM;  // Cin padded to 8 (ds's n) and to 16 (dW's m)
  int CoK, CoN;     // Cout padded to 16 (ds's k) and to 8 (dW's n)
  int SGA;          // row stride of g and of the weight, CoK + 8
  int SST;          // row stride of g^T and of s^T, TP + 8
  int DSR;          // ds row stride per (pixel, tap), in x's type: CinP8 + 8
  int KS;           // each dW product splits the tile's TP / 16 k-steps in KS parts
  int njobs;        // dW products: 9 * (CinM / 16) * (CoN / 8) * KS
  long long off_g, off_gt, off_st, off_ds, off_om, off_win, smem;
};

bool plan_for(int W, int Cin, int Cout, int es, int stream, BwdPlan* out) {
  const int nsplit = es == 4 ? 2 : 1;  // float32 operands: bf16 hi and lo
  const long long nt = stream ? 1 : KT;  // taps of the weight, s^T and ds held at once
  for (int n = 1; ; ++n) {
    const int WS = (W + n - 1) / n;
    if (n > 1 && WS < 8) break;
    BwdPlan p{};
    p.stream = stream;
    p.WS = WS;
    p.TP = (int)round_up(WS, 16);
    p.WW = W < WS + 7 ? W : WS + 7;
    p.CinP8 = (int)round_up(Cin, 8);
    p.CinM = (int)round_up(Cin, 16);
    p.CoK = (int)round_up(Cout, 16);
    p.CoN = (int)round_up(Cout, 8);
    p.SGA = p.CoK + 8;
    p.SST = p.TP + 8;
    p.DSR = p.CinP8 + 8;
    const int per_tap = (p.CinM / 16) * (p.CoN / 8), ksteps = p.TP / 16;
    // split each product's pixels in KS parts while all the products still
    // fit the warps' JMAX register slots (the rest go to dW per tile)
    p.KS = NW / per_tap < 1 ? 1 : (NW / per_tap > ksteps ? ksteps : NW / per_tap);
    while (p.KS > 1 && 9 * per_tap * p.KS > JMAX * NW) --p.KS;
    p.njobs = 9 * per_tap * p.KS;
    p.off_g = nt * p.CinP8 * p.SGA * 2 * nsplit;
    p.off_gt = p.off_g + (long long)p.TP * p.SGA * 2 * nsplit;
    p.off_st = p.off_gt + (long long)p.CoN * p.SST * 2 * nsplit;
    p.off_ds = p.off_st + nt * p.CinM * p.SST * 2 * nsplit;
    p.off_om = p.off_ds + round_up(nt * p.TP * p.DSR * es, 16);
    p.off_win = p.off_om + round_up((long long)p.TP * 3 * KT * es, 16);
    p.smem = p.off_win + (long long)WR * p.WW * Cin * 4;
    if (p.smem <= MAX_SMEM) {
      *out = p;
      return true;
    }
    if (WS <= 8) break;
  }
  return false;
}

// the 9-tap plan where a tile of it fits, else the streamed one
bool make_plan(int W, int Cin, int Cout, int es, BwdPlan* out) {
  return plan_for(W, Cin, Cout, es, 0, out) || plan_for(W, Cin, Cout, es, 1, out);
}

// V consecutive channels as float32
__device__ __forceinline__ void load_v(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  v[0] = __low2float(a);
  v[1] = __high2float(a);
  v[2] = __low2float(b);
  v[3] = __high2float(b);
}
__device__ __forceinline__ void load_v(const float* p, float (&v)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  v[0] = u.x;
  v[1] = u.y;
  v[2] = u.z;
  v[3] = u.w;
}
template <typename T> __device__ __forceinline__ void load_v(const T* p, float (&v)[1]) {
  v[0] = to_f32(*p);
}

// two values of x's type from float32 sums, as one 32- or 64-bit store
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(__float2bfloat16_rn(a), __float2bfloat16_rn(b));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ int gcd(int a, int b) {
  while (b != 0) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return a;
}

// V = 4: four channels per lane (Cin % 4 == 0, x aligned to 4 elements); V = 1 otherwise.
// STREAM: the streamed plan, one tap per phase
template <typename T, int V, bool STREAM>
__global__ void __launch_bounds__(THREADS, 1)
deform_bwd_mma_kernel(const T* __restrict__ x, const T* __restrict__ offset,
                      const T* __restrict__ mask, const T* __restrict__ weight,
                      const T* __restrict__ grad, float* __restrict__ dx,
                      T* __restrict__ doffset, T* __restrict__ dmask,
                      float* __restrict__ dweight, int B, int H, int W, int Cin, int Cout,
                      int windowed, const BwdPlan pl) {
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int NTAP = STREAM ? 1 : KT;  // taps of the weight, s^T and ds held at once
  extern __shared__ __align__(16) unsigned char smem[];
  const int TP = pl.TP, SGA = pl.SGA, SST = pl.SST, DSR = pl.DSR, CinP8 = pl.CinP8;
  const int CinM = pl.CinM, WW = pl.WW;
  __nv_bfloat16* wc_hi = reinterpret_cast<__nv_bfloat16*>(smem);  // (NTAP, CinP8, SGA): [k][c][o]
  __nv_bfloat16* wc_lo = wc_hi + NTAP * CinP8 * SGA;
  __nv_bfloat16* g_hi = reinterpret_cast<__nv_bfloat16*>(smem + pl.off_g);    // (TP, SGA)
  __nv_bfloat16* g_lo = g_hi + TP * SGA;
  __nv_bfloat16* gt_hi = reinterpret_cast<__nv_bfloat16*>(smem + pl.off_gt);  // (CoN, SST)
  __nv_bfloat16* gt_lo = gt_hi + pl.CoN * SST;
  __nv_bfloat16* st_hi = reinterpret_cast<__nv_bfloat16*>(smem + pl.off_st);  // (NTAP * CinM, SST)
  __nv_bfloat16* st_lo = st_hi + NTAP * CinM * SST;
  T* ds_s = reinterpret_cast<T*>(smem + pl.off_ds);       // (TP, NTAP, DSR): ds, x's type
  T* om_s = reinterpret_cast<T*>(smem + pl.off_om);       // (TP, 18) offsets, (TP, 9) mask
  float* win = reinterpret_cast<float*>(smem + pl.off_win);  // (WR, WW, Cin), ring by row

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int P = H * W;

  // taps k0 .. k0 + taps - 1 of the weight in the B layout of ds, zero-padded
  auto load_weight = [&](int k0, int taps) {
    for (int e = tid; e < taps * CinP8 * pl.CoK; e += THREADS) {
      const int k = e / (CinP8 * pl.CoK), r = e % (CinP8 * pl.CoK), c = r / pl.CoK,
                o = r % pl.CoK;
      const float v = (c < Cin && o < Cout)
                          ? to_f32(weight[((size_t)(k0 + k) * Cin + c) * Cout + o]) : 0.f;
      __nv_bfloat16 hi, lo;
      split_bf16(v, hi, lo);
      wc_hi[(k * CinP8 + c) * SGA + o] = hi;
      if (F32) wc_lo[(k * CinP8 + c) * SGA + o] = lo;
    }
  };
  // once per block: the weight (all of it in the 9-tap plan); the window
  // zeroed; s^T zeroed, so its rows past Cin stay 0 and its columns past a
  // narrower tile hold finite values (their g is 0)
  if (!STREAM) load_weight(0, KT);
  for (int e = tid; e < WR * WW * Cin; e += THREADS) win[e] = 0.f;
  for (int e = tid; e < NTAP * CinM * SST * (F32 ? 2 : 1); e += THREADS)
    st_hi[e] = __float2bfloat16_rn(0.f);

  const int MTc = CinM / 16, NTo = pl.CoN / 8, KST = TP / 16;
  const int per_tap = MTc * NTo * pl.KS;          // dW products per tap
  const int kper = (KST + pl.KS - 1) / pl.KS;     // k-steps per product
  float acc[JMAX][4];
#pragma unroll
  for (int i = 0; i < JMAX; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[i][r] = 0.f;

  // one dW product of this tile: tap k's rows mt of s^T (channels), columns
  // nt of g (output channels), its part ks of the tile's pixels; s^T holds
  // the taps from k0 on
  auto dw_product = [&](int job, int k0, float (&d)[4]) {
    const int k = job / per_tap;
    int r = job % per_tap;
    const int ks = r % pl.KS;
    r /= pl.KS;
    const int nt = r % NTo, mt = r / NTo;
    const int k_end = min(KST, (ks + 1) * kper);
    for (int kk = ks * kper; kk < k_end; ++kk) {
      uint32_t ah[4], bh[2];
      load_a(ah, st_hi, SST, (k - k0) * CinM + mt * 16, kk * 16, lane);
      load_b(bh, gt_hi, SST, nt * 8, kk * 16, lane);
      mma_bf16(d, ah, bh);
      if (F32) {
        uint32_t al[4], bl[2];
        load_a(al, st_lo, SST, (k - k0) * CinM + mt * 16, kk * 16, lane);
        load_b(bl, gt_lo, SST, nt * 8, kk * 16, lane);
        mma_bf16(d, al, bh);
        mma_bf16(d, ah, bl);
      }
    }
  };
  // where a product's accumulator lands in dW: (tap, channel row, output column)
  auto dw_add = [&](int job, const float (&d)[4]) {
    const int k = job / per_tap;
    const int r = (job % per_tap) / pl.KS;
    const int nt = r % NTo, mt = r / NTo;
    const int c = mt * 16 + (lane >> 2), o = nt * 8 + 2 * (lane & 3);
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int cc = c + (h >> 1) * 8, oo = o + (h & 1);
      if (cc < Cin && oo < Cout) atomicAdd(dweight + ((size_t)k * Cin + cc) * Cout + oo, d[h]);
    }
  };

  // tiles in (image, segment, row) order; each block takes a contiguous run,
  // so consecutive tiles are consecutive rows and the window carries over
  const int segs = (W + pl.WS - 1) / pl.WS;
  const long long tiles = (long long)B * segs * H;
  const long long t_begin = tiles * blockIdx.x / gridDim.x;
  const long long t_end = tiles * (blockIdx.x + 1) / gridDim.x;
  const int grp = lane >> 3, gl = lane & 7;  // 8-lane group: one (pixel, tap)
  const int NCH = (Cin + V - 1) / V;
  const int MTp = TP / 16, NTc = CinP8 / 8;

  for (long long t = t_begin; t < t_end; ++t) {
    const int r = (int)(t % H);
    const int sg = (int)((t / H) % segs), b = (int)(t / ((long long)H * segs));
    const int c0 = sg * pl.WS, WSX = min(pl.WS, W - c0);  // this tile's pixels
    const int wc0 = c0 - 3 > 0 ? c0 - 3 : 0;
    const int wwc = min(W, c0 + pl.WS + 4) - wc0;  // window columns in use
    const size_t img = (size_t)b * P, pix0 = img + (size_t)r * W + c0;
    __syncthreads();  // the previous tile's readers of g, g^T, s^T and the window are done

    // g: (TP, Cout) row-major for ds, (Cout, TP) for dW, 0 past the tile;
    // the tile's offsets and mask
    for (int e = tid; e < TP * pl.CoK; e += THREADS) {
      const int p = e / pl.CoK, o = e % pl.CoK;
      const float v = (p < WSX && o < Cout) ? to_f32(grad[(pix0 + p) * Cout + o]) : 0.f;
      __nv_bfloat16 hi, lo;
      split_bf16(v, hi, lo);
      g_hi[p * SGA + o] = hi;
      if (F32) g_lo[p * SGA + o] = lo;
      if (o < pl.CoN) {
        gt_hi[o * SST + p] = hi;
        if (F32) gt_lo[o * SST + p] = lo;
      }
    }
    for (int e = tid; e < WSX * 2 * KT; e += THREADS) om_s[e] = offset[pix0 * (2 * KT) + e];
    for (int e = tid; e < WSX * KT; e += THREADS) om_s[TP * 2 * KT + e] = mask[pix0 * KT + e];
    __syncthreads();

    // the taps in phases of NTAP: all 9 at once, or one at a time (streamed)
    for (int k0 = 0; k0 < KT; k0 += NTAP) {
      if (STREAM) {
        load_weight(k0, 1);  // the last tap's ds phase, its reader, passed two barriers
        __syncthreads();
      }
      // ds = g . W_k^T for the phase's taps, rounded to x's type as the JAX glue does
      for (int jb = warp; jb < NTAP * MTp * NTc; jb += NW) {
        const int kl = jb / (MTp * NTc), mt = (jb / NTc) % MTp, nt = jb % NTc;
        const __nv_bfloat16* wk_hi = wc_hi + kl * CinP8 * SGA;
        const __nv_bfloat16* wk_lo = wc_lo + kl * CinP8 * SGA;
        float d[4] = {0.f, 0.f, 0.f, 0.f};
        for (int kk = 0; kk < pl.CoK; kk += 16) {
          uint32_t ah[4], bh[2];
          load_a(ah, g_hi, SGA, mt * 16, kk, lane);
          load_b(bh, wk_hi, SGA, nt * 8, kk, lane);
          mma_bf16(d, ah, bh);
          if (F32) {
            uint32_t al[4], bl[2];
            load_a(al, g_lo, SGA, mt * 16, kk, lane);
            load_b(bl, wk_lo, SGA, nt * 8, kk, lane);
            mma_bf16(d, al, bh);
            mma_bf16(d, ah, bl);
          }
        }
        const int row = mt * 16 + (lane >> 2), col = nt * 8 + 2 * (lane & 3);
        store2(ds_s + (row * NTAP + kl) * DSR + col, d[0], d[1]);
        store2(ds_s + ((row + 8) * NTAP + kl) * DSR + col, d[2], d[3]);
      }
      __syncthreads();

      // corners: an 8-lane group per (pixel, tap), V channels per lane. The
      // four groups of a warp take items a quarter of the tile's 9 * WSX apart,
      // and consecutive warps pixels S apart, so concurrent groups scatter to
      // different cells; group g adds its four channels in the order g, g + 1,
      // ... (mod 4), so the four groups' shared atomics fall in different banks
      const int items = NTAP * WSX, Q = (items + 3) / 4;
      int S = 37;
      while (gcd(S, WSX) != 1) S += 2;
      for (int m = warp; m < Q; m += NW) {  // warp-uniform
        const int e = grp * Q + m;
        const bool live = e < items;
        const int kl = live ? e / WSX : 0, k = k0 + kl;
        const int p = live ? (int)(((long long)(e % WSX) * S) % WSX) : 0;
        const int j = c0 + p;
        Tap tp = {};  // not live: not valid, no corner
        float mk = 0.f;
        if (live) {
          tp = tap_fields(r, j, k, to_f32(om_s[p * 2 * KT + 2 * k]),
                          to_f32(om_s[p * 2 * KT + 2 * k + 1]), H, W, windowed);
          if (tp.valid) mk = to_f32(om_s[TP * 2 * KT + p * KT + k]);
        }
        const float ay[2] = {1.f - tp.fy, tp.fy}, ax[2] = {1.f - tp.fx, tp.fx};
        int src[4], widx[4];
        float wq[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int yy = tp.y0 + (q >> 1), xx = tp.x0 + (q & 1);
          src[q] = (tp.valid && yy >= 0 && yy < H && xx >= 0 && xx < W) ? yy * W + xx : -1;
          wq[q] = ay[q >> 1] * ax[q & 1] * mk;
          const bool inwin = yy >= r - 3 && yy <= r + 4 && xx >= wc0 && xx < wc0 + wwc;
          widx[q] = inwin ? (((yy & (WR - 1)) * WW) + (xx - wc0)) * Cin : -1;
        }
        float part[4] = {0.f, 0.f, 0.f, 0.f};
        for (int ch = gl; ch < NCH; ch += 8) {
          const int c = ch * V;
          float sv[V];
#pragma unroll
          for (int u = 0; u < V; ++u) sv[u] = 0.f;
          if (tp.valid) {
            float d[V], xv[4][V];
            load_v(ds_s + (p * NTAP + kl) * DSR + c, d);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              if (src[q] >= 0) {
                load_v(x + (img + src[q]) * Cin + c, xv[q]);
              } else {
#pragma unroll
                for (int u = 0; u < V; ++u) xv[q][u] = 0.f;
              }
            }
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              if (src[q] < 0) continue;
#pragma unroll
              for (int u = 0; u < V; ++u) {
                part[q] += d[u] * xv[q][u];
                sv[u] += wq[q] * xv[q][u];
              }
              if (wq[q] != 0.f) {
                if (widx[q] >= 0) {
#pragma unroll
                  for (int u = 0; u < V; ++u) {
                    const int uu = (u + grp) & (V - 1);
                    const float dv = V == 1 ? d[0] : uu == 0 ? d[0] : uu == 1 ? d[V > 1 ? 1 : 0]
                                     : uu == 2 ? d[V > 2 ? 2 : 0] : d[V > 3 ? 3 : 0];
                    atomicAdd(win + widx[q] + c + uu, wq[q] * dv);
                  }
                } else {  // beyond the window: exact semantics only
                  float* dst = dx + (img + src[q]) * Cin + c;
#pragma unroll
                  for (int u = 0; u < V; ++u) atomicAdd(dst + u, wq[q] * d[u]);
                }
              }
            }
          }
          // the recomputed sample, rounded to x's type, as s^T for dW
          if (live) {
#pragma unroll
            for (int u = 0; u < V; ++u) {
              if (c + u < Cin) {
                __nv_bfloat16 hi, lo;
                split_bf16(round_to<T>(sv[u]), hi, lo);
                st_hi[(kl * CinM + c + u) * SST + p] = hi;
                if (F32) st_lo[(kl * CinM + c + u) * SST + p] = lo;
              }
            }
          }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int o = 4; o > 0; o >>= 1) part[q] += __shfl_xor_sync(0xffffffffu, part[q], o);
        if (gl == 0 && live) {
          float dfy = 0.f, dfx = 0.f, dwv = 0.f;
          if (tp.valid) {  // an invalid tap has no gradient
            dfy = mk * ((part[2] * ax[0] + part[3] * ax[1]) - (part[0] * ax[0] + part[1] * ax[1]));
            dfx = mk * ((part[1] * ay[0] + part[3] * ay[1]) - (part[0] * ay[0] + part[2] * ay[1]));
            dwv = part[0] * ay[0] * ax[0] + part[1] * ay[0] * ax[1] + part[2] * ay[1] * ax[0] +
                  part[3] * ay[1] * ax[1];
            dfy = tp.pass_y ? dfy : 0.f;
            dfx = tp.pass_x ? dfx : 0.f;
          }
          const size_t pix = pix0 + p;
          doffset[pix * (2 * KT) + 2 * k] = from_f32<T>(dfy);
          doffset[pix * (2 * KT) + 2 * k + 1] = from_f32<T>(dfx);
          dmask[pix * KT + k] = from_f32<T>(dwv);
        }
      }
      __syncthreads();

      // dW += s_k^T . g for the phase's taps: each warp its own products
#pragma unroll
      for (int i = 0; i < JMAX; ++i) {
        const int job = warp + NW * i;
        if (job < pl.njobs && (!STREAM || job / per_tap == k0)) dw_product(job, k0, acc[i]);
      }
      for (int job = warp + NW * JMAX; job < pl.njobs; job += NW) {
        if (STREAM && job / per_tap != k0) continue;
        float d[4] = {0.f, 0.f, 0.f, 0.f};
        dw_product(job, k0, d);
        dw_add(job, d);
      }
    }  // the phases of taps

    // flush into dx the window rows no later tile of this block reaches (the
    // row leaving the ring, or all of it at the end of a run of rows) and
    // zero them; their writers passed the last barrier
    const bool carry = t + 1 < t_end && r + 1 < H;
    const int y_lo = carry ? r - 3 : max(0, r - 3), y_hi = carry ? r - 3 : min(H - 1, r + 4);
    const int NV = Cin / V;
    if (y_lo >= 0) {
      for (int e = tid; e < (y_hi - y_lo + 1) * wwc * NV; e += THREADS) {
        const int yy = y_lo + e / (wwc * NV), rr = e % (wwc * NV), wx = rr / NV, cv = rr % NV;
        float* cell = win + ((yy & (WR - 1)) * WW + wx) * Cin + cv * V;
        float* dst = dx + (img + (size_t)yy * W + wc0 + wx) * Cin + cv * V;
        if (V == 4) {
          const float4 v = *reinterpret_cast<const float4*>(cell);
          if (v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f) {
            atomicAdd(reinterpret_cast<float4*>(dst), v);
            *reinterpret_cast<float4*>(cell) = make_float4(0.f, 0.f, 0.f, 0.f);
          }
        } else if (*cell != 0.f) {
          atomicAdd(dst, *cell);
          *cell = 0.f;
        }
      }
    }
  }

  // dW leaves the block once
#pragma unroll
  for (int i = 0; i < JMAX; ++i) {
    const int job = warp + NW * i;
    if (job < pl.njobs) dw_add(job, acc[i]);
  }
}

template <typename T, int V, bool STREAM>
int launch_v(const void* x, const void* offset, const void* mask, const void* weight,
             const void* grad, float* dx, void* doffset, void* dmask, float* dweight, int B,
             int H, int W, int Cin, int Cout, int windowed, const BwdPlan& pl,
             cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      deform_bwd_mma_kernel<T, V, STREAM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)pl.smem);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, deform_bwd_mma_kernel<T, V, STREAM>, THREADS, (size_t)pl.smem)) != cudaSuccess)
    return (int)err;
  const long long tiles = (long long)B * H * ((W + pl.WS - 1) / pl.WS);
  const long long cap = (long long)sms * per_sm;
  const long long blocks = tiles < cap ? tiles : cap;
  if (blocks < 1) return (int)cudaErrorInvalidConfiguration;
  deform_bwd_mma_kernel<T, V, STREAM><<<(unsigned)blocks, THREADS, (size_t)pl.smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(offset), static_cast<const T*>(mask),
      static_cast<const T*>(weight), static_cast<const T*>(grad), dx, static_cast<T*>(doffset),
      static_cast<T*>(dmask), dweight, B, H, W, Cin, Cout, windowed, pl);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* offset, const void* mask, const void* weight,
           const void* grad, float* dx, void* doffset, void* dmask, float* dweight, int B,
           int H, int W, int Cin, int Cout, int windowed, cudaStream_t stream) {
  BwdPlan pl;
  if (!make_plan(W, Cin, Cout, (int)sizeof(T), &pl)) return (int)cudaErrorInvalidValue;
  const bool vec = Cin % 4 == 0 && reinterpret_cast<uintptr_t>(x) % (4 * sizeof(T)) == 0 &&
                   reinterpret_cast<uintptr_t>(dx) % 16 == 0;
  if (pl.stream) {
    if (vec)
      return launch_v<T, 4, true>(x, offset, mask, weight, grad, dx, doffset, dmask, dweight, B,
                                  H, W, Cin, Cout, windowed, pl, stream);
    return launch_v<T, 1, true>(x, offset, mask, weight, grad, dx, doffset, dmask, dweight, B, H,
                                W, Cin, Cout, windowed, pl, stream);
  }
  if (vec)
    return launch_v<T, 4, false>(x, offset, mask, weight, grad, dx, doffset, dmask, dweight, B,
                                 H, W, Cin, Cout, windowed, pl, stream);
  return launch_v<T, 1, false>(x, offset, mask, weight, grad, dx, doffset, dmask, dweight, B, H,
                               W, Cin, Cout, windowed, pl, stream);
}

}  // namespace

extern "C" {

// Shared memory one block needs at this map width, channel counts and type,
// in bytes; -1 where no tile fits in a block's shared memory.
long long deform_bwd_smem_bytes(int W, int Cin, int Cout, int is_bf16) {
  BwdPlan pl;
  return make_plan(W, Cin, Cout, is_bf16 ? 2 : 4, &pl) ? pl.smem : -1;
}

// The plan this map width, channel counts and type take: 0 all 9 taps per
// phase, 1 one tap at a time with its weight staged; -1 where neither fits.
long long deform_bwd_plan(int W, int Cin, int Cout, int is_bf16) {
  BwdPlan pl;
  return make_plan(W, Cin, Cout, is_bf16 ? 2 : 4, &pl) ? pl.stream : -1;
}

// x (B,H,W,Cin), offset (B,H,W,18), mask (B,H,W,9), weight (3,3,Cin,Cout) and
// grad (B,H,W,Cout): contiguous, all float32 (is_bf16 = 0) or all bf16
// (is_bf16 = 1). Outputs: dx float32 (B,H,W,Cin) and dweight float32
// (3,3,Cin,Cout), both zeroed by the caller (accumulated atomically);
// doffset and dmask in the inputs' type, fully written. Returns a cudaError_t.
int deform_bwd(const void* x, const void* offset, const void* mask, const void* weight,
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
