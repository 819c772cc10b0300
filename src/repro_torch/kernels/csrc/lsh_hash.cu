// Fused E2LSH hash: codes[n, f] = floor((x[n] . a[:, f] + b[f]*w[f]) / w[f]).
//
// Replaces: src/repro/kernels/lsh_hash.py, function lsh_hash (Pallas body
// _kernel), the fused projection + quantisation of the TPU port.
//
// What bounds it on an H100: at the main path's shapes (64 queries, or the
// 1M-point corpus, d = 128, F = L*K = 20) the work is 2*N*d*F FLOPs against
// N*d*4 bytes of x read once -- 10 FLOP per byte, far below the card's
// fp32 ridge (67 TFLOP/s / 3.35 TB/s = 20), so the bytes of x bound it;
// at 64 queries the launch itself dominates.
//
// Design: one block of 256 threads per tile of ROWS rows. The projection
// matrix a (d*F*4 bytes, 10 KB at d = 128, F = 20) is staged once per block
// in shared memory; x is staged in chunks of 64 columns; each thread keeps
// up to PER outputs in fp32 registers. The epilogue rounds the multiply,
// the add and the divide separately (__fmul_rn / __fadd_rn / __fdiv_rn):
// nvcc would otherwise contract proj + b*w into one FMA, which the
// reference (XLA) does not, and the codes are compared bit for bit. The
// dot's summation order is the only difference left.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int PER = 4;      // outputs per thread: F <= THREADS * PER
constexpr int DCH = 64;     // x columns staged per step

__global__ void __launch_bounds__(THREADS)
lsh_hash_kernel(const float* __restrict__ x, const float* __restrict__ a,
                const float* __restrict__ b, const float* __restrict__ w,
                int* __restrict__ out, int64_t n, int d, int f, int rows) {
  extern __shared__ float smem[];
  float* as = smem;                  // (d, f)
  float* xs = smem + (size_t)d * f;  // (rows, DCH)
  const int tid = threadIdx.x;
  const int64_t row0 = (int64_t)blockIdx.x * rows;
  for (int i = tid; i < d * f; i += THREADS) as[i] = a[i];
  float acc[PER];
#pragma unroll
  for (int p = 0; p < PER; ++p) acc[p] = 0.f;
  for (int j0 = 0; j0 < d; j0 += DCH) {
    const int jn = min(DCH, d - j0);
    __syncthreads();
    for (int i = tid; i < rows * DCH; i += THREADS) {
      const int r = i / DCH, j = i % DCH;
      const int64_t gr = row0 + r;
      xs[i] = (gr < n && j < jn) ? x[gr * d + j0 + j] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int e = tid + p * THREADS;
      if (e < rows * f) {
        const int r = e / f, c = e % f;
        const float* xr = xs + r * DCH;
        const float* ac = as + (size_t)j0 * f + c;
        float s = acc[p];
        for (int j = 0; j < jn; ++j) s = fmaf(xr[j], ac[(size_t)j * f], s);
        acc[p] = s;
      }
    }
  }
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    const int e = tid + p * THREADS;
    if (e < rows * f) {
      const int r = e / f, c = e % f;
      const int64_t gr = row0 + r;
      if (gr < n) {
        const float wc = w[c];
        const float v = __fadd_rn(acc[p], __fmul_rn(b[c], wc));
        out[gr * f + c] = (int)floorf(__fdiv_rn(v, wc));
      }
    }
  }
}

}  // namespace

extern "C" int lsh_hash_f32(const float* x, const float* a, const float* b,
                            const float* w, int* out, int64_t n, int d, int f,
                            void* stream) {
  int rows = (THREADS * PER) / f;
  rows = rows < 1 ? 1 : (rows > 64 ? 64 : rows);
  const size_t smem = ((size_t)d * f + (size_t)rows * DCH) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        lsh_hash_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int64_t blocks = (n + rows - 1) / rows;
  lsh_hash_kernel<<<(unsigned)blocks, THREADS, smem, (cudaStream_t)stream>>>(
      x, a, b, w, out, n, d, f, rows);
  return (int)cudaGetLastError();
}
