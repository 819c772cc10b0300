// Hamming distance of every (query, table) lane's code to every bucket code
// of that table: out[q, l, b] = sum_k [codes[l, b, k] != qcodes[q, l, k]],
// or K + 1 for padding rows b >= n_buckets[l].
//
// Replaces: src/repro/kernels/hamming.py, function hamming (Pallas body
// _kernel) -- one (B, K) compare-reduce per query code -- generalised to the
// batch of Q*L lanes that ring construction needs, with the n_buckets mask
// of lsh.hamming_to_buckets fused in.
//
// What bounds it on an H100: bytes. At (Q, L, B) = (64, 2, 2^20), K = 10 it
// reads the bucket codes once (84 MB) and writes Q*L*B int32 (537 MB); the
// compares are a few operations per byte.
//
// Design: one thread per bucket row, grid (bucket tiles, tables). Each
// thread loads its row's K codes into registers once (a fully unrolled loop
// over KMAX keeps them out of local memory) and then walks all Q query
// codes of its table, which the block stages in shared memory. So the
// bucket codes are read from device memory once for the whole batch, and
// each query's distances are written as one coalesced row.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int KMAX = 32;

__global__ void __launch_bounds__(THREADS)
hamming_kernel(const int* __restrict__ codes, const int* __restrict__ qcodes,
               const int* __restrict__ n_buckets, int* __restrict__ out,
               int nq, int nl, int64_t nb, int k) {
  extern __shared__ int qs[];        // (Q, K) codes of this table
  const int l = blockIdx.y;
  for (int i = threadIdx.x; i < nq * k; i += THREADS) {
    const int q = i / k, j = i % k;
    qs[i] = qcodes[((int64_t)q * nl + l) * k + j];
  }
  __syncthreads();
  const int64_t b = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (b >= nb) return;
  const bool valid = b < (int64_t)n_buckets[l];
  int c[KMAX];
  const int* row = codes + ((int64_t)l * nb + b) * k;
#pragma unroll
  for (int j = 0; j < KMAX; ++j) c[j] = (j < k && valid) ? row[j] : 0;
  for (int q = 0; q < nq; ++q) {
    int dist = k + 1;
    if (valid) {
      dist = 0;
      const int* qc = qs + q * k;
#pragma unroll
      for (int j = 0; j < KMAX; ++j)
        if (j < k) dist += (c[j] != qc[j]);
    }
    out[((int64_t)q * nl + l) * nb + b] = dist;
  }
}

}  // namespace

extern "C" int hamming_to_buckets_i32(const int* codes, const int* qcodes,
                                      const int* n_buckets, int* out, int nq,
                                      int nl, int64_t nb, int k,
                                      void* stream) {
  const size_t smem = (size_t)nq * k * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        hamming_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((unsigned)((nb + THREADS - 1) / THREADS), (unsigned)nl);
  hamming_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      codes, qcodes, n_buckets, out, nq, nl, nb, k);
  return (int)cudaGetLastError();
}
