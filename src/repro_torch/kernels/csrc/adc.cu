// Asymmetric distance computation (paper Alg. 5): the sum over subspaces
// m = 0..M-1 of lut[m, code_m], with a float32 LUT (float sums) or an
// affine uint8 LUT (int32 sums, exact: M * 255 << 2^31). Codes are uint8,
// one byte per subspace, or packed 4-bit codes read directly (byte j holds
// code 2j in its low nibble and code 2j+1 in its high nibble).
//
// Replaces: src/repro/kernels/adc.py, functions adc, adc_batch, adc_q8 and
// adc_batch_q8 (Pallas bodies _kernel, _batch_kernel, _kernel_q8,
// _batch_kernel_q8). Those build a one-hot iota-compare contraction per
// subspace because a TPU has no fast gather (DESIGN.md section 3); here the
// LUT sits in shared memory and each lookup is one shared-memory load.
//
// Two templates, each for a float32 and a uint8 LUT and for byte or packed
// codes. Every sum runs over m in order, as the plain versions in
// kernels/ref.py do, so float results agree with them bit for bit.
//
// * adc_rows: codes (C, M) or (C, M/2), ids (R, c) int32, the LUT stack
//   (Q, M, Kc) and lane_q (R,) int32 mapping each lane to its query's LUT
//   -> (R, c). The qualification of the prober's slabs and central bucket,
//   the ADC counterpart of l2dist_rows: the candidate gather is fused, and
//   LUTs are not copied per lane. Bound on an H100: bytes, but at the slab
//   shapes (128 lanes x 128 candidates, 32-byte codes: 0.6 MB) the launch
//   dominates. Design: grid (lanes, candidate blocks of 512); a block
//   loads its lane's LUT into shared memory (8 KB f32, 2 KB u8 at M = 32,
//   Kc = 64), then each thread reads one candidate's code row (two 16-byte
//   loads at M = 32) into registers and adds its M lookups.
//
// * adc_batch: codes (N, M) or (N, M/2), LUTs (Q, M, Kc) -> (Q, N), one
//   pass over the codes for all Q queries: the full-ADC-scan baseline.
//   Bound on an H100: bytes of the (Q, N) output (256 MB at Q = 64,
//   N = 2^20) against the 32 MB of codes, but in practice the Q*N*M
//   random shared-memory lookups (2^31 at that shape; bank conflicts are
//   not avoided yet). Design: the f32 stack (512 KB at Q = 64) exceeds the
//   227 KB a block may use, so a grid axis tiles the queries, up to 128 KB
//   of LUTs per block (16 f32 LUTs, or the whole u8 stack), in dynamic
//   shared memory. Each thread keeps one code row in registers across the
//   queries of its tile and writes out[q, n], coalesced across threads;
//   blocks loop over rows so each loads its LUT tile once.
#include <cuda_runtime.h>
#include <stdint.h>

#include "adc_sum.cuh"

namespace {

constexpr int ROWS_THREADS = 128;
constexpr int ROWS_PER_BLOCK = 512;
constexpr int BATCH_THREADS = 512;
constexpr int BATCH_LUT_BYTES = 128 * 1024;

// Copy `bytes` from global to shared memory; 16 bytes a load where both
// ends allow it.
__device__ __forceinline__ void stage(unsigned char* dst,
                                      const unsigned char* __restrict__ src,
                                      int bytes, int nthreads) {
  if (bytes % 16 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0) {
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    for (int e = threadIdx.x; e < bytes / 16; e += nthreads) d4[e] = s4[e];
  } else {
    for (int e = threadIdx.x; e < bytes; e += nthreads) dst[e] = src[e];
  }
}

template <bool PACK, typename T, typename Acc>
__global__ void __launch_bounds__(ROWS_THREADS)
adc_rows_kernel(const uint8_t* __restrict__ codes, const int* __restrict__ ids,
                const T* __restrict__ luts, const int* __restrict__ lane_q,
                Acc* __restrict__ out, int c, int cb, int mk, int kc,
                int align) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int r = blockIdx.x;
  stage(smem, reinterpret_cast<const unsigned char*>(
                  luts + (int64_t)lane_q[r] * mk),
        mk * (int)sizeof(T), ROWS_THREADS);
  __syncthreads();
  const T* lut = reinterpret_cast<const T*>(smem);
  const int i1 = min(c, (int)(blockIdx.y + 1) * ROWS_PER_BLOCK);
  for (int i = blockIdx.y * ROWS_PER_BLOCK + threadIdx.x; i < i1;
       i += ROWS_THREADS) {
    const int64_t e = (int64_t)r * c + i;
    unsigned wd[MAXW];
    load_row(codes + (int64_t)ids[e] * cb, cb, align, wd);
    out[e] = adc_sum<PACK, T, Acc>(wd, cb, lut, kc);
  }
}

template <bool PACK, typename T, typename Acc>
__global__ void __launch_bounds__(BATCH_THREADS)
adc_batch_kernel(const uint8_t* __restrict__ codes, const T* __restrict__ luts,
                 Acc* __restrict__ out, int64_t n, int nq, int qt, int cb,
                 int mk, int kc, int align) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int q0 = blockIdx.y * qt;
  const int nqt = min(qt, nq - q0);
  stage(smem, reinterpret_cast<const unsigned char*>(luts + (int64_t)q0 * mk),
        nqt * mk * (int)sizeof(T), BATCH_THREADS);
  __syncthreads();
  const T* lut = reinterpret_cast<const T*>(smem);
  for (int64_t row = (int64_t)blockIdx.x * BATCH_THREADS + threadIdx.x;
       row < n; row += (int64_t)gridDim.x * BATCH_THREADS) {
    unsigned wd[MAXW];
    load_row(codes + row * cb, cb, align, wd);
    for (int q = 0; q < nqt; ++q)
      out[(int64_t)(q0 + q) * n + row] =
          adc_sum<PACK, T, Acc>(wd, cb, lut + q * mk, kc);
  }
}

template <bool PACK, typename T, typename Acc>
int rows(const uint8_t* codes, const int* ids, const T* luts,
         const int* lane_q, Acc* out, int nr, int c, int cb, int m, int kc,
         int align, cudaStream_t stream) {
  const int mk = m * kc;
  const size_t smem = (size_t)mk * sizeof(T);
  auto kern = adc_rows_kernel<PACK, T, Acc>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)nr, (unsigned)((c + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK));
  kern<<<grid, ROWS_THREADS, smem, stream>>>(codes, ids, luts, lane_q, out, c,
                                             cb, mk, kc, align);
  return (int)cudaGetLastError();
}

template <bool PACK, typename T, typename Acc>
int batch(const uint8_t* codes, const T* luts, Acc* out, int64_t n, int nq,
          int cb, int m, int kc, int align, cudaStream_t stream) {
  const int mk = m * kc;
  const int per = mk * (int)sizeof(T);
  int qt = BATCH_LUT_BYTES / per;
  qt = qt < 1 ? 1 : (qt > nq ? nq : qt);
  const int tiles = (nq + qt - 1) / qt;
  const size_t smem = (size_t)qt * per;
  auto kern = adc_batch_kernel<PACK, T, Acc>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, BATCH_THREADS, smem)) != cudaSuccess)
    return (int)err;
  // one wave: each block stages its LUT tile once and loops over rows
  int64_t bx = ((int64_t)sms * (per_sm > 0 ? per_sm : 1) + tiles - 1) / tiles;
  const int64_t need = (n + BATCH_THREADS - 1) / BATCH_THREADS;
  if (bx > need) bx = need;
  if (bx < 1) bx = 1;
  dim3 grid((unsigned)bx, (unsigned)tiles);
  kern<<<grid, BATCH_THREADS, smem, stream>>>(codes, luts, out, n, nq, qt, cb,
                                              mk, kc, align);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int adc_rows_f32(const uint8_t* codes, const int* ids,
                            const float* luts, const int* lane_q, float* out,
                            int nr, int c, int cb, int m, int kc, int pack,
                            int align, void* stream) {
  auto s = (cudaStream_t)stream;
  return pack ? rows<true>(codes, ids, luts, lane_q, out, nr, c, cb, m, kc,
                           align, s)
              : rows<false>(codes, ids, luts, lane_q, out, nr, c, cb, m, kc,
                            align, s);
}

extern "C" int adc_rows_u8(const uint8_t* codes, const int* ids,
                           const uint8_t* luts, const int* lane_q, int* out,
                           int nr, int c, int cb, int m, int kc, int pack,
                           int align, void* stream) {
  auto s = (cudaStream_t)stream;
  return pack ? rows<true>(codes, ids, luts, lane_q, out, nr, c, cb, m, kc,
                           align, s)
              : rows<false>(codes, ids, luts, lane_q, out, nr, c, cb, m, kc,
                            align, s);
}

extern "C" int adc_batch_f32(const uint8_t* codes, const float* luts,
                             float* out, int64_t n, int nq, int cb, int m,
                             int kc, int pack, int align, void* stream) {
  auto s = (cudaStream_t)stream;
  return pack ? batch<true>(codes, luts, out, n, nq, cb, m, kc, align, s)
              : batch<false>(codes, luts, out, n, nq, cb, m, kc, align, s);
}

extern "C" int adc_batch_u8(const uint8_t* codes, const uint8_t* luts,
                            int* out, int64_t n, int nq, int cb, int m,
                            int kc, int pack, int align, void* stream) {
  auto s = (cudaStream_t)stream;
  return pack ? batch<true>(codes, luts, out, n, nq, cb, m, kc, align, s)
              : batch<false>(codes, luts, out, n, nq, cb, m, kc, align, s);
}
