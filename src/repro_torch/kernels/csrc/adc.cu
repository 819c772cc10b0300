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
//   pass over the codes for each query tile: the full-ADC-scan baseline.
//   Bound on an H100: bytes of the (Q, N) output (256 MB at Q = 64,
//   N = 2^20) and, in practice, the Q*N*M shared-memory lookups (2^31 at
//   that shape; 2^31 words at ~7-8.4e12 words/s is 0.26-0.30 ms, a quarter
//   of that for uint8 LUTs, four queries to a word).
//   Design:
//   - A block stages its query tile transposed, query fastest (read from
//     the (Q, M, Kc) stack 16 bytes a thread): word
//     [m][c][g] holds query g of the tile (float) or queries 4g..4g+3
//     (uint8, one byte each). A tile is G words per (m, c), G a power of two
//     <= 16: 16 float LUTs or 64 uint8 LUTs (128 KB at M = 32, Kc = 64).
//   - The G lanes of a warp that share a code row read the same code word
//     (a broadcast from a staged code tile) and then consecutive words
//     lut[m][code][0..G-1], which lie in consecutive banks. At G = 16 a
//     warp holds two rows, whose two 16-word runs fall in the same 16
//     banks only when their codes differ and have the same parity. Figure
//     of merit at the scan's shape (M = 32, Kc = 64, uniform codes): 1 +
//     31/64 = 1.48 shared-memory wavefronts per warp LUT load (2 at worst),
//     each load serving 32 lookups (float) or 128 (uint8), against 3-4
//     when each thread walks a row of its own. Tiles with G < 16 (Q < 16, or
//     Q < 64 for uint8, or LUTs above 14 KB a query) put 32/G rows in a
//     warp: correct, but their conflicts grow with 32/G.
//   - Each lane adds its (q, n) entries over m = 0..M-1 in order (as
//     adc_sum and the plain versions do, so float sums are bit-equal), two
//     or four rows in flight with independent accumulators. uint8 sums run
//     as SWAR: even and odd bytes of a word in two registers of two 16-bit
//     sums each; exact, since M <= 128 keeps a sum <= 32,640 < 2^16.
//   - Output: results go through a (queries x rows) tile in shared memory,
//     laid out so that both its writes and its reads are conflict-free,
//     and leave as runs of consecutive rows per query: whole 128-byte
//     segments, streaming stores.
//   - Code tiles of up to 512 rows are double-buffered with cp.async, so
//     the next tile's codes load while this one is summed. One block per SM
//     at the scan's shape (the LUT tile takes 128 KB); the blocks of a
//     query tile stride over row tiles.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "adc_sum.cuh"

namespace {

constexpr int ROWS_THREADS = 128;
constexpr int ROWS_PER_BLOCK = 512;
constexpr int BATCH_THREADS = 512;
constexpr int SMEM_LIMIT = 232448;           // a block's shared memory

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

// Start copying `rows` code rows of cb bytes into a tile of row stride cbs
// (cb rounded up to 16 bytes): cp.async where the rows are 16- or 4-byte
// aligned, else plain byte loads.
__device__ __forceinline__ void stage_codes(unsigned char* dst,
                                            const uint8_t* __restrict__ src,
                                            int rows, int cb, int cbs,
                                            int align) {
  if (align == 16) {
    for (int e = threadIdx.x; e < rows * cb / 16; e += BATCH_THREADS)
      cp_async16(dst + 16 * e, src + 16 * e);
  } else if (align == 4) {
    const int words = cb / 4;
    for (int e = threadIdx.x; e < rows * words; e += BATCH_THREADS)
      cp_async4(dst + (e / words) * cbs + 4 * (e % words), src + 4 * e);
  } else {
    for (int e = threadIdx.x; e < rows * cb; e += BATCH_THREADS)
      dst[(e / cb) * cbs + e % cb] = __ldg(src + e);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ unsigned lds32(unsigned a) {
  unsigned v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(a));
  return v;
}

__device__ __forceinline__ uint4 lds128(unsigned a) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(a));
  return v;
}

__host__ __device__ constexpr int align16(int bytes) {
  return (bytes + 15) & ~15;
}

// Shared memory of a block: the LUT tile, two code tiles, the output tile
// ((queries x rows) floats with rows fastest, or (rows x query quads)
// int4s, each padded so that its writes and reads are conflict-free).
__host__ __device__ constexpr int batch_smem(bool q8, int mk, int cbs, int lg,
                                             int rb) {
  return align16(mk * 4 << lg) + 2 * align16(rb * cbs) +
         (q8 ? rb * ((1 << lg) + 1) * 16 : (1 << lg) * (rb + (32 >> lg)) * 4);
}

// out[q, n] = sum_m lut[q, m, codes[n, m]] for the query tile blockIdx.y:
// G = 2^LG LUT words per (m, c), row tiles of rb = 2^lrb rows.
template <bool PACK, bool Q8, int LG>
__global__ void __launch_bounds__(BATCH_THREADS, 1)
adc_batch_kernel(const uint8_t* __restrict__ codes,
                 const void* __restrict__ luts, void* __restrict__ out,
                 int64_t n, int nq, int cb, int mk, int kc, int lrb,
                 int align) {
  using T = typename std::conditional<Q8, uint8_t, float>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int G = 1 << LG, P = 32 >> LG;
  // rows a lane sums at once: two float sums hide the lookups' latency
  // best, four where a code byte gives two lookups or a word four
  constexpr int ROWS_IN_FLIGHT = Q8 || PACK ? 4 : 2;
  const int rb = 1 << lrb;
  const int qt = Q8 ? 4 * G : G;             // queries of a tile
  const int q0 = blockIdx.y * qt;
  const int nqt = min(qt, nq - q0);
  const int cbs = (cb + 15) & ~15;           // code tile row stride
  const int ctile_bytes = align16(rb * cbs);
  unsigned char* ctile = smem + align16(mk * 4 * G);   // two code tiles
  unsigned char* otile = ctile + 2 * ctile_bytes;

  // lane = slot * G + g: the warp's P = 32 / G slots hold adjacent rows,
  // the block's SL = 16 P slots hold SL rows at once
  const int g = threadIdx.x & (G - 1);
  const int sid = (threadIdx.x >> 5) * P + ((threadIdx.x & 31) >> LG);
  const int sl = BATCH_THREADS / 32 * P;
  const int kmax = rb / sl;

  // the query tile, transposed to [m][c][q] (zero past the last query):
  // each thread reads 16 bytes of one query's LUT row where the rows allow
  // it (else one entry), threads of a warp on consecutive queries
  {
    T* lt = reinterpret_cast<T*>(smem);
    const T* src = static_cast<const T*>(luts) + (int64_t)q0 * mk;
    constexpr int V = 16 / sizeof(T);
    if (mk % V == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0) {
      for (int e = threadIdx.x; e < qt * (mk / V); e += BATCH_THREADS) {
        const int q = e & (qt - 1), mc = e / qt * V;
        uint4 x = make_uint4(0u, 0u, 0u, 0u);
        if (q < nqt)
          x = __ldg(reinterpret_cast<const uint4*>(src + q * mk + mc));
        const T* xv = reinterpret_cast<const T*>(&x);
#pragma unroll
        for (int k = 0; k < V; ++k) lt[(mc + k) * qt + q] = xv[k];
      }
    } else {
      for (int e = threadIdx.x; e < qt * mk; e += BATCH_THREADS) {
        const int q = e & (qt - 1), mc = e / qt;
        lt[e] = q < nqt ? __ldg(src + q * mk + mc) : T(0);
      }
    }
  }
  // shared addresses: lane g's word of the LUT of subspace 0, code 0;
  // lut_row bytes per subspace; the code tiles
  const unsigned lut_s = (unsigned)__cvta_generic_to_shared(smem) + 4 * g;
  const unsigned lut_row = (unsigned)kc << (LG + 2);
  const unsigned ctile_s = (unsigned)__cvta_generic_to_shared(ctile);

  // The output tile of rows [row0, row0 + nr) to device memory: each
  // query's run of rows, consecutive threads on consecutive rows.
  auto emit = [&](int64_t row0, int nr) {
    const int elems = (Q8 ? (nqt + 3) >> 2 : nqt) << lrb;
    for (int e = threadIdx.x; e < elems; e += BATCH_THREADS) {
      const int qq = e >> lrb, j = e & (rb - 1);
      if (j >= nr) continue;
      if (Q8) {
        const int4 v = reinterpret_cast<const int4*>(otile)[j * (G + 1) + qq];
        const int vals[4] = {v.x, v.y, v.z, v.w};
        int* o =
            static_cast<int*>(out) + (int64_t)(q0 + 4 * qq) * n + row0 + j;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (4 * qq + i < nqt) __stcs(o + i * n, vals[i]);
      } else {
        __stcs(static_cast<float*>(out) + (int64_t)(q0 + qq) * n + row0 + j,
               reinterpret_cast<const float*>(otile)[qq * (rb + P) + j]);
      }
    }
  };

  // Row tiles t = blockIdx.x, + gridDim.x, ...: tile t + 1's codes arrive
  // while tile t is summed.
  const int64_t ntiles = (n + rb - 1) >> lrb;
  int64_t t = blockIdx.x;
  if (t < ntiles)
    stage_codes(ctile, codes + (t << lrb) * cb,
                (int)min((int64_t)rb, n - (t << lrb)), cb, cbs, align);
  for (int buf = 0; t < ntiles; t += gridDim.x, buf ^= 1) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();     // tile t's codes are in; tile t - 1 is summed
    const int64_t tn = t + gridDim.x;
    if (tn < ntiles)
      stage_codes(ctile + (buf ^ 1) * ctile_bytes, codes + (tn << lrb) * cb,
                  (int)min((int64_t)rb, n - (tn << lrb)), cb, cbs, align);
    const int64_t row0 = t << lrb;
    const int nr = (int)min((int64_t)rb, n - row0);   // rows of the tile
    const unsigned cs = ctile_s + buf * ctile_bytes;

    for (int k0 = 0; k0 < kmax; k0 += ROWS_IN_FLIGHT) {
      int lr[ROWS_IN_FLIGHT];
      bool ok[ROWS_IN_FLIGHT];
      float acc[ROWS_IN_FLIGHT];
      unsigned ev[ROWS_IN_FLIGHT], od[ROWS_IN_FLIGHT];
#pragma unroll
      for (int j = 0; j < ROWS_IN_FLIGHT; ++j) {
        lr[j] = sid + (k0 + j) * sl;
        ok[j] = k0 + j < kmax && lr[j] < nr;
        acc[j] = 0.0f;
        ev[j] = od[j] = 0u;
      }
      // one lookup of row j: the LUT word at shared address a
      auto look = [&](int j, unsigned a) {
        const unsigned w = lds32(a);
        if (Q8) {
          ev[j] += w & 0x00FF00FFu;               // queries 4g, 4g + 2
          od[j] += __byte_perm(w, 0u, 0x4341);    // queries 4g + 1, 4g + 3
        } else {
          acc[j] += __uint_as_float(w);
        }
      };
      // the nb <= 16 code bytes of chunk ch of each row, m in order
      auto chunk = [&](int ch, int nb) {
        uint4 c16[ROWS_IN_FLIGHT];
#pragma unroll
        for (int j = 0; j < ROWS_IN_FLIGHT; ++j)
          c16[j] = ok[j] ? lds128(cs + lr[j] * cbs + 16 * ch)
                         : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          if (i < nb) {
            const int b = 16 * ch + i;
            const unsigned lm = lut_s + (PACK ? 2 * b : b) * lut_row;
#pragma unroll
            for (int j = 0; j < ROWS_IN_FLIGHT; ++j) {
              const unsigned wd = i < 4 ? c16[j].x : i < 8 ? c16[j].y
                                : i < 12 ? c16[j].z : c16[j].w;
              const unsigned v = __byte_perm(wd, 0u, 0x4440 + (i & 3));
              if (PACK) {
                look(j, lm + ((v & 0xFu) << (LG + 2)));
                look(j, lm + lut_row + ((v >> 4) << (LG + 2)));
              } else {
                look(j, lm + (v << (LG + 2)));
              }
            }
          }
        }
      };
      for (int ch = 0; ch < (cb >> 4); ++ch) chunk(ch, 16);
      if (cb & 15) chunk(cb >> 4, cb & 15);
#pragma unroll
      for (int j = 0; j < ROWS_IN_FLIGHT; ++j) {
        if (k0 + j < kmax) {
          if (Q8)
            reinterpret_cast<int4*>(otile)[lr[j] * (G + 1) + g] =
                make_int4((int)(ev[j] & 0xFFFFu), (int)(od[j] & 0xFFFFu),
                          (int)(ev[j] >> 16), (int)(od[j] >> 16));
          else
            reinterpret_cast<float*>(otile)[g * (rb + P) + lr[j]] = acc[j];
        }
      }
    }
    __syncthreads();
    emit(row0, nr);
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

// The tile plan (lg, lrb) comes from the wrapper (ops.adc_batch_plan):
// the widest query tile that fits, then the longest row tile.
template <bool PACK, bool Q8, int LG>
int batch(const uint8_t* codes, const void* luts, void* out, int64_t n,
          int nq, int cb, int m, int kc, int lrb, int align,
          cudaStream_t stream) {
  const int mk = m * kc, cbs = (cb + 15) & ~15;
  if (lrb > 9 || (1 << lrb) < BATCH_THREADS / 32 * (32 >> LG) ||
      batch_smem(Q8, mk, cbs, LG, 1 << lrb) > SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  const size_t smem = batch_smem(Q8, mk, cbs, LG, 1 << lrb);
  const int qt = (Q8 ? 4 : 1) << LG;
  const int tiles = (nq + qt - 1) / qt;
  auto kern = adc_batch_kernel<PACK, Q8, LG>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, BATCH_THREADS, smem)) != cudaSuccess)
    return (int)err;
  // one wave: each block stages its LUT tile once and strides over row tiles
  int64_t bx = ((int64_t)sms * (per_sm > 0 ? per_sm : 1) + tiles - 1) / tiles;
  const int64_t need = (n + (1 << lrb) - 1) >> lrb;
  if (bx > need) bx = need;
  if (bx < 1) bx = 1;
  dim3 grid((unsigned)bx, (unsigned)tiles);
  kern<<<grid, BATCH_THREADS, smem, stream>>>(codes, luts, out, n, nq, cb, mk,
                                              kc, lrb, align);
  return (int)cudaGetLastError();
}

// One instance per tile width G = 2^lg: the lookups' shifts are constants.
template <bool PACK, bool Q8>
int batch(const uint8_t* codes, const void* luts, void* out, int64_t n,
          int nq, int cb, int m, int kc, int lg, int lrb, int align,
          cudaStream_t stream) {
  switch (lg) {
    case 0: return batch<PACK, Q8, 0>(codes, luts, out, n, nq, cb, m, kc,
                                      lrb, align, stream);
    case 1: return batch<PACK, Q8, 1>(codes, luts, out, n, nq, cb, m, kc,
                                      lrb, align, stream);
    case 2: return batch<PACK, Q8, 2>(codes, luts, out, n, nq, cb, m, kc,
                                      lrb, align, stream);
    case 3: return batch<PACK, Q8, 3>(codes, luts, out, n, nq, cb, m, kc,
                                      lrb, align, stream);
    case 4: return batch<PACK, Q8, 4>(codes, luts, out, n, nq, cb, m, kc,
                                      lrb, align, stream);
    default: return (int)cudaErrorInvalidValue;
  }
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
                             int kc, int pack, int lg, int lrb, int align,
                             void* stream) {
  auto s = (cudaStream_t)stream;
  return pack ? batch<true, false>(codes, luts, out, n, nq, cb, m, kc, lg, lrb,
                                   align, s)
              : batch<false, false>(codes, luts, out, n, nq, cb, m, kc, lg,
                                    lrb, align, s);
}

extern "C" int adc_batch_u8(const uint8_t* codes, const uint8_t* luts,
                            int* out, int64_t n, int nq, int cb, int m,
                            int kc, int pack, int lg, int lrb, int align,
                            void* stream) {
  auto s = (cudaStream_t)stream;
  return pack ? batch<true, true>(codes, luts, out, n, nq, cb, m, kc, lg, lrb,
                                  align, s)
              : batch<false, true>(codes, luts, out, n, nq, cb, m, kc, lg, lrb,
                                   align, s);
}
