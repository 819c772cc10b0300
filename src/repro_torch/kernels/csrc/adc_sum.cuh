// The ADC sum shared by adc.cu and slab.cu: one code row held in registers
// and the sum over subspaces m = 0..M-1 of lut[m, code_m], in order, so
// every kernel that includes it gives the same float sums bit for bit.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAXW = 16;                 // code row words in registers

// A code row of cb <= 4 * MAXW bytes as 32-bit words in registers; align is
// 16 (uint4 loads), 4 (word loads) or 1 (byte loads).
__device__ __forceinline__ void load_row(const uint8_t* __restrict__ row,
                                         int cb, int align,
                                         unsigned (&wd)[MAXW]) {
  if (align == 16) {
#pragma unroll
    for (int i = 0; i < MAXW / 4; ++i) {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (16 * i < cb) v = __ldg(reinterpret_cast<const uint4*>(row) + i);
      wd[4 * i] = v.x;
      wd[4 * i + 1] = v.y;
      wd[4 * i + 2] = v.z;
      wd[4 * i + 3] = v.w;
    }
  } else if (align == 4) {
#pragma unroll
    for (int w = 0; w < MAXW; ++w)
      wd[w] = 4 * w < cb ? __ldg(reinterpret_cast<const unsigned*>(row) + w)
                         : 0u;
  } else {
#pragma unroll
    for (int w = 0; w < MAXW; ++w) {
      unsigned v = 0u;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (4 * w + j < cb) v |= (unsigned)__ldg(row + 4 * w + j) << (8 * j);
      wd[w] = v;
    }
  }
}

// sum_m lut[m * kc + code_m], m in order.
template <bool PACK, typename T, typename Acc>
__device__ __forceinline__ Acc adc_sum(const unsigned (&wd)[MAXW], int cb,
                                       const T* lut, int kc) {
  Acc acc = 0;
#pragma unroll
  for (int w = 0; w < MAXW; ++w) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int b = 4 * w + j;
      if (b < cb) {
        const unsigned v = (wd[w] >> (8 * j)) & 0xFFu;
        if (PACK) {
          acc += (Acc)lut[(2 * b) * kc + (v & 0xFu)];
          acc += (Acc)lut[(2 * b + 1) * kc + (v >> 4)];
        } else {
          acc += (Acc)lut[b * kc + v];
        }
      }
    }
  }
  return acc;
}

// Shared memory above the default 48 KB has to be asked for per kernel.
template <typename K>
cudaError_t allow_smem(K kern, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace
