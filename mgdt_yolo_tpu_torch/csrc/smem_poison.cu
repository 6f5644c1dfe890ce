// A check, not a kernel of any path: fills the dynamic shared memory of
// each block with one 16-bit pattern (chip_smoke.py uses 0xFFFF, a bf16
// NaN), at the most a block may use, so one block fills an SM; `blocks`
// blocks run one after another on each SM, and each marks in `hit` (one int
// per SM id) the SM it ran on. Shared memory is not cleared between kernels,
// so a kernel launched next on the stream finds the pattern wherever it
// reads shared memory that it did not write itself: chip_smoke.py launches
// the Hopper V1 (deform_fwd_tc_variants.cu) right after it, to show that V1
// never reads the stage rows of dead corners or channels past Cin.
//
// Built by mgdt_yolo_tpu_torch/utils/build.py with nvcc for sm_90a; called
// through ctypes from chip_smoke.py.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void poison_kernel(uint16_t bits, int n, int* hit) {
  extern __shared__ uint16_t s[];
  volatile uint16_t* v = s;  // volatile: the stores are the point, though nothing reads them
  for (int i = threadIdx.x; i < n; i += blockDim.x) v[i] = bits;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    atomicAdd(hit + sm, v[n - 1] == bits ? 1 : 0);
  }
}

}  // namespace

extern "C" {

// Fills `bytes` of dynamic shared memory (even, at most what a block may
// use) in each of `blocks` blocks of 1024 threads with `bits`; hit: int32
// [1024] on the card, zeroed by the caller, indexed by SM id. Returns a
// cudaError_t.
int smem_poison(int bits, long long bytes, int blocks, void* hit, void* stream) {
  if (bytes < 2 || bytes % 2 || blocks < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(poison_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  poison_kernel<<<blocks, 1024, (size_t)bytes, static_cast<cudaStream_t>(stream)>>>(
      (uint16_t)bits, (int)(bytes / 2), static_cast<int*>(hit));
  return (int)cudaGetLastError();
}

}  // extern "C"
