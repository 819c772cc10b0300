// Squared L2 distances in the difference form sum_k (x_k - q_k)^2, fp32.
//
// Replaces: src/repro/kernels/l2dist.py:41, function l2dist (Pallas body
// _kernel), which uses the MXU expansion |x|^2 - 2 x.q + |q|^2. This port
// keeps the reference's default qualification form (prober.py
// make_exact_qualfn, use_kernels=False; estimator.py true_cardinality) so
// that decisions at tau^2 match the reference; the expansion would round
// differently.
//
// Three entry points:
//
// * l2dist_f32: x (N, d), q (Q, d) -> (N, Q), the tiled kernel. Serves
//   true_cardinality and the query workload (1M x 64 at d = 128), the
//   port's ground truth. Every output is acc = 0; for k = 0..d-1:
//   df = x[n,k] - q[j,k]; acc = fmaf(df, df, acc), in that order, so it is
//   bit-equal to the general kernel below (terms past d are fmaf(0, 0,
//   acc) = acc, exact, since acc >= +0).
//   Bounds on an H100 at 1M x 64 x 128: operations -- 2*N*Q*d = 16.4 GFLOP
//   at 67 TFLOP/s, 0.2445 ms; bytes -- x read once (512 MB) and the output
//   written once (256 MB) at 3.35 TB/s, 0.229 ms. The difference form is
//   one FADD and one FFMA per (row, query, k): 1.64e10 lane instructions,
//   at 132 SMs x 128 FP32 lanes x 1.98 GHz (the card's maximum SM clock)
//   an FP32-issue ceiling of ~0.49 ms. The FP32 pipe at full rate takes
//   every issue slot, so every other instruction (shared loads, address
//   arithmetic, barriers) adds to that ceiling.
//   No tensor cores: they compute the expansion, which cancels at |x|^2 ~
//   1e3-1e4 (~1e-3 absolute error, against the rtol/atol 1e-5 check and
//   the decisions at tau^2), and TF32 rounds the inputs to 10 mantissa
//   bits.
//   Design (blocks of 256 threads, two per SM, 100 KB of shared memory
//   each at d = 128; 116 registers a thread, no spills, as ptxas -v
//   reports them):
//   1. Register tile: each thread holds 8 rows x 4 consecutive queries, 32
//      accumulators. Per four k it issues 256 FP instructions against 12
//      LDS.128 (8 for its rows, 4 for its queries); in SASS the compiled k
//      loop is 96 % FADD/FFMA (chip_smoke.py prints the count). Under
//      this load the card sits at its power limit, below its maximum
//      clock, and the kernel runs at about 0.8 of the ceiling at the
//      clock it holds (PERF.md).
//   2. Resident query tile: a block stages its 64 queries once, transposed
//      (k major, query fastest, zero past Q and d), and keeps them in
//      shared memory. The grid is persistent: as many blocks per query tile
//      as fit the card at once, each walking 128-row tiles with a stride,
//      so q is read from L2 once per block (264 times at Q = 64) rather
//      than once per row tile.
//   3. Corpus staging: chunks of 64 floats of k of a tile's rows go
//      through a ring of 2 stages with cp.async.cg (16 bytes a thread,
//      zero-filled past N and d); the ring runs on across row tiles, so the
//      next tile's loads overlap this tile's compute and stores. Each warp
//      stages only its own 16 rows (thread (tq, tr) copies piece tq of its
//      8 rows), so a chunk needs one cp.async.wait_group and one
//      __syncwarp, and no block barrier: warps never wait for each other.
//      Rows are kept row-major with a pad of 4 floats (row stride 68
//      floats) and read as float4 along k.
//      Bank use: a warp's x load reads two rows (tr, tr + 1), each a
//      broadcast to 16 threads; the pad puts them 17 bank quads apart, so
//      the two 16-byte reads are conflict-free (one wavefront). A warp's q
//      load reads 16 consecutive float4 (256 bytes; both half-warps read
//      the same), conflict-free, two wavefronts, the least for 256 bytes.
//      A half-warp's copies fill one row's 256 contiguous bytes,
//      conflict-free.
//   4. Stores: a thread's 4 queries of a row leave as one float4; a warp's
//      store writes two adjacent rows, 512 contiguous bytes at Q = 64
//      (scalar stores when Q % 4 != 0).
//   5. ops.l2dist_plan (kernels/ops.py) picks this kernel by shape and
//      alignment only: d % 4 == 0, 16-byte aligned x and q, and a query
//      tile that fits shared memory (d <= 576); it masks ragged N and Q
//      itself. Every other shape goes to l2dist_general_f32.
//
// * l2dist_general_f32: the same function at any shape and alignment (the
//   first port of l2dist): 64 x 64 output tiles per block of 256 threads,
//   each thread a 4 x 4 register tile; x and q staged through shared
//   memory 16 columns at a time, transposed, one float per thread per load.
//   It runs at about half of the FP32-issue ceiling.
//
// * l2dist_rows_f32: x (C, d), ids (R, c), qs (R, d) -> (R, c). The exact
//   qualification of every lane's slab (and of the central bucket), with
//   the candidate gather fused: rows are read straight from x, never
//   written out. Bound on an H100: bytes of the gathered rows; at the
//   slab shape (128 lanes x 128 candidates, d = 128) the 8.4 MB take
//   2.5 us, so the launch dominates. Design: one warp per candidate row,
//   one float4 per lane per step (d = 128 is one step), shuffle reduction.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---- l2dist_f32: the tiled kernel ----------------------------------------

// rows per tile, queries per tile, floats of k per staged chunk, ring
// stages, threads; the staged row stride in floats (a pad of 4)
constexpr int T_ROWS = 128, T_QT = 64, T_KC = 64, T_STAGES = 2,
              T_THREADS = 256, T_XS = T_KC + 4;
// thread (tq, tr) copies the 16-byte piece tq of each chunk of its rows
static_assert(T_KC / 4 == 16 && T_ROWS == 8 * 16, "tile layout");

// Dynamic shared memory of one block; ops.l2dist_smem computes the same.
constexpr int tiled_smem(int kch) {
  return 4 * (kch * T_KC * T_QT + T_STAGES * T_ROWS * T_XS);
}

// 16 bytes global -> shared, or 16 zero bytes when !ok
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ float lane_of(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

__global__ void __launch_bounds__(T_THREADS, 2)
l2dist_tiled_kernel(const float* __restrict__ x, const float* __restrict__ q,
                    float* __restrict__ out, int64_t n, int nq, int d,
                    int kch, int64_t row_tiles) {
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                          // [kch * T_KC][T_QT]
  float* ring = smem + kch * T_KC * T_QT;    // [T_STAGES][T_ROWS][T_XS]
  const int tid = threadIdx.x, lane = tid % 32;
  const int tq = lane % 16;                          // queries 4tq .. 4tq+3
  const int tr = 2 * (tid / 32) + lane / 16;         // rows tr + 16i, i < 8
  const int q0 = blockIdx.y * T_QT;

  // the query tile, transposed: qt[k][j] = q[q0 + j][k], zero past Q and d
  for (int e = tid; e < T_QT * kch * (T_KC / 4); e += T_THREADS) {
    const int j = e % T_QT, k = 4 * (e / T_QT);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + j < nq && k < d)
      v = *reinterpret_cast<const float4*>(q + (int64_t)(q0 + j) * d + k);
    qt[(k + 0) * T_QT + j] = v.x;
    qt[(k + 1) * T_QT + j] = v.y;
    qt[(k + 2) * T_QT + j] = v.z;
    qt[(k + 3) * T_QT + j] = v.w;
  }

  __syncthreads();                                   // the query tile
  // a step is (row tile t, chunk c of k, ring stage st); the block's row
  // tiles are blockIdx.x, + gridDim.x, ...; counters, not divisions
  auto next = [kch](int64_t& t, int& c, int& st) {
    st = st + 1 == T_STAGES ? 0 : st + 1;
    if (++c == kch) {
      c = 0;
      t += gridDim.x;
    }
  };
  // each warp stages only the rows its threads read, so one __syncwarp
  // per chunk orders the copies and the reads, and no warp waits for
  // another
  auto load = [&](int64_t t, int c, int st) {
    if (t < row_tiles) {
      const int64_t r0 = t * T_ROWS + tr;
      const int k = c * T_KC + 4 * tq;
      float* dst = ring + st * (T_ROWS * T_XS) + tr * T_XS + 4 * tq;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const bool ok = r0 + 16 * i < n && k < d;
        cp_async16(dst + 16 * i * T_XS, ok ? x + (r0 + 16 * i) * d + k : x,
                   ok);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);   // empty past the end
  };
  int64_t lt = blockIdx.x;                           // the next load's step
  int lc = 0, lst = 0;
  for (int s = 0; s < T_STAGES - 1; ++s) {
    load(lt, lc, lst);
    next(lt, lc, lst);
  }

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  const bool vec = nq % 4 == 0;
  int64_t t = blockIdx.x;
  int c = 0, st = 0;
  while (t < row_tiles) {
    // this step's chunk has landed (the newest group may still be in
    // flight); after the warp barrier every lane is done with the last
    // step's stage, which the next load refills
    asm volatile("cp.async.wait_group %0;\n" ::"n"(T_STAGES - 2) : "memory");
    __syncwarp();
    load(lt, lc, lst);
    next(lt, lc, lst);
    const float* xs = ring + st * (T_ROWS * T_XS) + tr * T_XS;
    const float* qs = qt + c * T_KC * T_QT + 4 * tq;
#pragma unroll
    for (int k4 = 0; k4 < T_KC / 4; ++k4) {
      float4 xv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        xv[i] = *reinterpret_cast<const float4*>(xs + i * 16 * T_XS + 4 * k4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 qv =
            *reinterpret_cast<const float4*>(qs + (4 * k4 + kk) * T_QT);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float xk = lane_of(xv[i], kk);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float df = xk - lane_of(qv, j);
            acc[i][j] = fmaf(df, df, acc[i][j]);
          }
        }
      }
    }
    if (c == kch - 1) {
      const int64_t r0 = t * T_ROWS + tr;
      const int j0 = q0 + 4 * tq;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int64_t r = r0 + 16 * i;
        float* o = out + r * nq + j0;
        if (r < n && j0 < nq) {
          if (vec) {
            *reinterpret_cast<float4*>(o) =
                make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (j0 + j < nq) o[j] = acc[i][j];
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      }
    }
    next(t, c, st);
  }
}

// ---- l2dist_general_f32 --------------------------------------------------

constexpr int TN = 64, TQ = 64, TD = 16, THREADS = 256;

__global__ void __launch_bounds__(THREADS)
l2dist_kernel(const float* __restrict__ x, const float* __restrict__ q,
              float* __restrict__ out, int64_t n, int nq, int d) {
  // +4 pads each row: fewer bank conflicts on the transposed stores, and
  // the row stride (272 bytes) keeps every float4 read 16-byte aligned
  __shared__ __align__(16) float xs[TD][TN + 4];
  __shared__ __align__(16) float qs[TD][TQ + 4];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int64_t n0 = (int64_t)blockIdx.x * TN;
  const int q0 = blockIdx.y * TQ;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int d0 = 0; d0 < d; d0 += TD) {
#pragma unroll
    for (int p = 0; p < (TN * TD) / THREADS; ++p) {
      const int e = tid + p * THREADS;
      const int r = e / TD, k = e % TD;
      const int64_t gr = n0 + r;
      const int gk = d0 + k;
      xs[k][r] = (gr < n && gk < d) ? x[gr * d + gk] : 0.f;
      const int gq = q0 + r;
      qs[k][r] = (gq < nq && gk < d) ? q[(int64_t)gq * d + gk] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < TD; ++k) {
      const float4 xv = *reinterpret_cast<const float4*>(&xs[k][ty * 4]);
      const float4 qv = *reinterpret_cast<const float4*>(&qs[k][tx * 4]);
      const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
      const float qr[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float df = xr[i] - qr[j];
          acc[i][j] = fmaf(df, df, acc[i][j]);
        }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t gr = n0 + ty * 4 + i;
    if (gr >= n) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gq = q0 + tx * 4 + j;
      if (gq < nq) out[gr * nq + gq] = acc[i][j];
    }
  }
}

constexpr int WARPS = 8;

__global__ void __launch_bounds__(WARPS * 32)
l2dist_rows_kernel(const float* __restrict__ x, const int* __restrict__ ids,
                   const float* __restrict__ qs, float* __restrict__ out,
                   int nr, int c, int d, int vec) {
  const int lane = threadIdx.x % 32;
  const int64_t gw = (int64_t)blockIdx.x * WARPS + threadIdx.x / 32;
  if (gw >= (int64_t)nr * c) return;
  const int r = (int)(gw / c);
  const float* xr = x + (int64_t)ids[gw] * d;
  const float* qr = qs + (int64_t)r * d;
  float s = 0.f;
  if (vec) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    const float4* q4 = reinterpret_cast<const float4*>(qr);
    for (int j = lane; j < d / 4; j += 32) {
      const float4 a = x4[j], b = q4[j];
      const float e0 = a.x - b.x, e1 = a.y - b.y, e2 = a.z - b.z,
                  e3 = a.w - b.w;
      s = fmaf(e0, e0, s);
      s = fmaf(e1, e1, s);
      s = fmaf(e2, e2, s);
      s = fmaf(e3, e3, s);
    }
  } else {
    for (int j = lane; j < d; j += 32) {
      const float e = xr[j] - qr[j];
      s = fmaf(e, e, s);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) out[gw] = s;
}

}  // namespace

// The plan (row tiles, query tiles, shared memory) comes from the wrapper
// (ops.l2dist_plan); a plan that disagrees with the kernel is refused.
extern "C" int l2dist_f32(const float* x, const float* q, float* out,
                          int64_t n, int nq, int d, int64_t row_tiles,
                          int q_tiles, int smem, void* stream) {
  const int kch = (d + T_KC - 1) / T_KC;
  if (d % 4 != 0 || smem != tiled_smem(kch) ||
      row_tiles != (n + T_ROWS - 1) / T_ROWS ||
      q_tiles != (nq + T_QT - 1) / T_QT || q_tiles > 65535 ||
      (uintptr_t)x % 16 != 0 || (uintptr_t)q % 16 != 0)
    return (int)cudaErrorInvalidValue;
  auto kern = l2dist_tiled_kernel;
  cudaError_t err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaFuncSetAttribute(
           kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
          cudaSuccess ||
      (err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, T_THREADS, smem)) != cudaSuccess)
    return (int)err;
  // persistent: the blocks the card holds at once, split over query tiles
  int64_t bx = (int64_t)sms * (per_sm > 0 ? per_sm : 1) / q_tiles;
  if (bx > row_tiles) bx = row_tiles;
  if (bx < 1) bx = 1;
  dim3 grid((unsigned)bx, (unsigned)q_tiles);
  kern<<<grid, T_THREADS, smem, (cudaStream_t)stream>>>(x, q, out, n, nq, d,
                                                        kch, row_tiles);
  return (int)cudaGetLastError();
}

extern "C" int l2dist_general_f32(const float* x, const float* q, float* out,
                                  int64_t n, int nq, int d, void* stream) {
  dim3 grid((unsigned)((n + TN - 1) / TN), (unsigned)((nq + TQ - 1) / TQ));
  l2dist_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(x, q, out, n, nq,
                                                            d);
  return (int)cudaGetLastError();
}

extern "C" int l2dist_rows_f32(const float* x, const int* ids,
                               const float* qs, float* out, int nr, int c,
                               int d, int vec, void* stream) {
  const int64_t warps = (int64_t)nr * c;
  const unsigned blocks = (unsigned)((warps + WARPS - 1) / WARPS);
  l2dist_rows_kernel<<<blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(
      x, ids, qs, out, nr, c, d, vec);
  return (int)cudaGetLastError();
}
