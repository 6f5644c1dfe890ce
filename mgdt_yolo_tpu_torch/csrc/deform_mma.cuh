// Tensor-core and asynchronous-copy building blocks of the Hopper DCNv2
// kernels (deform_fwd.cu, deform_bwd.cu): bf16 `mma.sync.m16n8k16` with
// float32 accumulation, its fragment loads from padded shared-memory
// layouts, the bf16 hi/lo split that carries float32 operands through it,
// and `cp.async`.
//
// Why `mma.sync` and not `wgmma`: the contractions are about 1% of these
// kernels' work (2 * 288 * 32 FLOP per pixel against ~2.3 KB of gathered
// corner rows), so the tensor cores' rate is not what bounds them; the
// warp-level instruction lets every warp contract its own 16-row slice
// between the gather phases without the warpgroup's 64-row tiles,
// descriptors and fences.
//
// Fragment layouts (PTX ISA, m16n8k16 with .bf16): lane = 4 * g + t.
//   A (16 x 16, row-major): reg 0 (row g, cols 2t, 2t+1), reg 1 (row g+8),
//     reg 2 (row g, cols 2t+8, 2t+9), reg 3 (row g+8, cols 2t+8, 2t+9);
//   B (16 x 8): reg 0 (rows k = 2t, 2t+1, col n = g), reg 1 (k + 8);
//   C/D (16 x 8, float32): d0, d1 (row g, cols 2t, 2t+1), d2, d3 (row g+8).
// Each 32-bit register holds two bf16, the lower column in the low half. A
// is read from a row-major (rows, ld) array and B from an n-major (n, ld)
// array (k contiguous), both with ld = 8 (mod 16) elements: the 32 lanes'
// 32-bit loads then fall in 32 different banks.
//
// utils/build.py hashes this header into every kernel's build digest.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace deform {

// d += a . b
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment: rows r0..r0+15, columns k0..k0+15 of row-major m (row stride ld)
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* m, int ld,
                                       int r0, int k0, int lane) {
  const __nv_bfloat16* p = m + (r0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
  a[0] = ld_u32(p);
  a[1] = ld_u32(p + 8 * ld);
  a[2] = ld_u32(p + 8);
  a[3] = ld_u32(p + 8 * ld + 8);
}

// B fragment: k0..k0+15 by n0..n0+7, element (k, n) at m[(n0 + n) * ld + k0 + k]
__device__ __forceinline__ void load_b(uint32_t (&b)[2], const __nv_bfloat16* m, int ld,
                                       int n0, int k0, int lane) {
  const __nv_bfloat16* p = m + (n0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
  b[0] = ld_u32(p);
  b[1] = ld_u32(p + 8);
}

// v = hi + lo + r with hi = bf16(v), lo = bf16(v - hi), |r| <= 2^-16 |v|:
// a float32 operand as two bf16 terms. For a bf16-exact v, lo is 0.
__device__ __forceinline__ void split_bf16(float v, __nv_bfloat16& hi, __nv_bfloat16& lo) {
  hi = __float2bfloat16_rn(v);
  lo = __float2bfloat16_rn(v - __bfloat162float(hi));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 first, __nv_bfloat16 second) {
  __nv_bfloat162 v = __halves2bfloat162(first, second);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// asynchronous global -> shared copies of 16 (L2 only) or 4 bytes
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are in flight
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__host__ __device__ inline long long round_up(long long v, long long m) {
  return (v + m - 1) / m * m;
}

}  // namespace deform
