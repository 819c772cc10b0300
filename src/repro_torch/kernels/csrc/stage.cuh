// Asynchronous copies from device to shared memory (cp.async), shared by
// the kernels that stage a query row, a LUT or a tile while they do other
// work: slab.cu and hamming.cu.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

// Start copying `bytes` from device to shared memory with the block's
// threads: 16 or 4 bytes a copy where both ends allow it, else plain byte
// loads.
__device__ __forceinline__ void stage_async(unsigned char* dst,
                                            const unsigned char* src,
                                            int bytes) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  if (a % 16 == 0 && bytes % 16 == 0) {
    for (int e = threadIdx.x; e < bytes / 16; e += blockDim.x)
      cp_async16(dst + 16 * e, src + 16 * e);
  } else if (a % 4 == 0 && bytes % 4 == 0) {
    for (int e = threadIdx.x; e < bytes / 4; e += blockDim.x)
      cp_async4(dst + 4 * e, src + 4 * e);
  } else {
    for (int e = threadIdx.x; e < bytes; e += blockDim.x) dst[e] = src[e];
  }
}

// Wait for every copy this thread started; a __syncthreads() after it
// makes all threads' copies visible to the block.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

}  // namespace
