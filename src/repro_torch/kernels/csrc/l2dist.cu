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
// * l2dist_f32: x (N, d), q (Q, d) -> (N, Q), the tiled kernel, at every
//   shape and alignment. Serves true_cardinality and the query workload
//   (1M x 64 at d = 128, and the paper's corpora at d = 300, 960, 1770),
//   the port's ground truth. Every output is acc = 0; for k = 0..d-1:
//   df = x[n,k] - q[j,k]; acc = fmaf(df, df, acc), in that order, so it is
//   bit-equal to the general kernel below (terms past d are fmaf(0, 0,
//   acc) = acc, exact, since acc >= +0).
//   Bounds on an H100 at 1M x 64 x 128: operations -- 2*N*Q*d = 16.4 GFLOP
//   at 67 TFLOP/s, 0.2445 ms; bytes -- x read once (512 MB) and the output
//   written once (256 MB) at 3.35 TB/s, 0.229 ms. The difference form is
//   one FADD and one FFMA per (row, query, k): 1.64e10 lane instructions,
//   at 132 SMs x 128 FP32 lanes x 1.98 GHz (the card's maximum SM clock)
//   an FP32-issue ceiling of ~0.49 ms, twice the operations bound. The
//   FP32 pipe at full rate takes every issue slot, so every other
//   instruction (shared loads, address arithmetic, barriers) adds to that
//   ceiling. At 1M x 64 x 960 / x 1770 the operations bound is 1.834 /
//   3.382 ms and the FP32-issue ceiling 3.673 / 6.772 ms; bytes (3.84 /
//   7.08 GB of x) take 1.22 / 2.19 ms, so the ceiling bounds every width.
//   No tensor cores: they compute the expansion, which cancels at |x|^2 ~
//   1e3-1e4 (~1e-3 absolute error, against the rtol/atol 1e-5 check and
//   the decisions at tau^2), and TF32 rounds the inputs to 10 mantissa
//   bits.
//   Design (blocks of 256 threads, two per SM at d <= 128, 100 KB of
//   shared memory each there, one per SM above; 116 registers a thread at
//   16-byte copies, no spills, as ptxas -v reports them):
//   1. Register tile: each thread holds 8 rows x 4 consecutive queries, 32
//      accumulators. Per four k it issues 256 FP instructions against 12
//      LDS.128 (8 for its rows, 4 for its queries); in SASS the compiled k
//      loop is 96 % FADD/FFMA (chip_smoke.py prints the count). Under
//      this load the card sits at its power limit, below its maximum
//      clock, and the kernel runs at about 0.8 of the ceiling at the
//      clock it holds (PERF.md).
//   2. Resident query tile, in k-panels: a block stages the 64 queries of
//      a panel of k once, transposed (k major, query fastest, zero past Q
//      and d), and keeps them in shared memory. A panel is at most 9
//      chunks of 64 floats (576 k), the most whose tile fits beside the
//      ring; wider d is cut into the fewest panels, of equal chunks (d =
//      960: 2 panels of 8 and 7 chunks; d = 1770: 4 of 7). The grid is
//      persistent: as many blocks per query tile as fit the card at once,
//      each walking 128-row tiles with a stride, so q is read from L2 once
//      per block and panel (264 times at Q = 64) rather than once per row
//      tile. A block walks the same row tiles in every panel; after the
//      first, each thread starts its accumulators from the outputs it
//      stored itself in the panel before (program order, no barrier), so
//      the fmaf chain over k runs on unbroken: a stored float reloads
//      exactly, and the result stays bit-equal. The extra traffic is
//      (panels - 1) x 2 x N*Q*4 bytes (+512 MB at d = 960, +1.5 GB at
//      d = 1770), under the FP32 work it overlaps.
//   3. Corpus staging: chunks of 64 floats of k of a tile's rows go
//      through a ring of 2 stages with cp.async, zero-filled past N and d;
//      the ring runs on across row tiles, so the next tile's loads overlap
//      this tile's compute and stores. The copy width W is a template
//      argument, the widest that 4*d and both pointers allow: 16 bytes
//      with cp.async.cg, else 8 or 4 bytes with cp.async.ca (d = 1770
//      rows are 7,080 bytes, 8 mod 16: 8-byte copies). Each warp stages
//      only its own 16 rows (thread (tq, tr) copies pieces tq, tq + 16,
//      ... of its 8 rows: 1, 2 or 4 copies a row), so a chunk needs one
//      cp.async.wait_group and one __syncwarp, and no block barrier: warps
//      never wait for each other except at a panel's query tile.
//      Rows are kept row-major with a pad of 4 floats (row stride 68
//      floats) and read as float4 along k, whatever W.
//      Bank use: a warp's x load reads two rows (tr, tr + 1), each a
//      broadcast to 16 threads; the pad puts them 17 bank quads apart, so
//      the two 16-byte reads are conflict-free (one wavefront). A warp's q
//      load reads 16 consecutive float4 (256 bytes; both half-warps read
//      the same), conflict-free, two wavefronts, the least for 256 bytes.
//      A half-warp's copies fill one row's contiguous bytes,
//      conflict-free.
//   4. Stores: a thread's 4 queries of a row leave as one float4; a warp's
//      store writes two adjacent rows, 512 contiguous bytes at Q = 64
//      (scalar stores when Q % 4 != 0); a later panel loads them the same
//      way.
//   5. ops.l2dist_plan (kernels/ops.py) computes the plan from the shape
//      and the addresses (row and query tiles, panels, chunks a panel,
//      copy width, shared memory); this entry point refuses a plan that
//      disagrees with its own. It masks ragged N and Q itself.
//
// * l2dist_general_f32: the same function at any shape and alignment (the
//   first port of l2dist): 64 x 64 output tiles per block of 256 threads,
//   each thread a 4 x 4 register tile; x and q staged through shared
//   memory 16 columns at a time, transposed, one float per thread per load.
//   It runs at about half of the FP32-issue ceiling. No path launches it:
//   it is the bit-equality witness the card's checks hold l2dist_f32
//   against (ops.l2dist_general).
//
// * l2dist_rows_f32: x (C, d), ids (R, c), qs (R, d) -> (R, c). The exact
//   distances of drawn or gathered rows, the gather fused: rows are read
//   straight from x, never written out. Its path is the Sampling baseline
//   (core/baselines.py: R (query, tau) pairs x c draws each; 768 x 10,000
//   from 1M x 128 in the paper's comparison). Bound on an H100: bytes of
//   the distinct rows drawn (there 999,565 rows, 7.68 draws a row: 0.171
//   ms; 1.19 ms if every draw read its row from memory).
//   Design: a block takes chunk j of R_DRAWS draws of pair r, with the
//   pair the fast index, so the blocks in flight hold about the same chunk
//   of every pair; where each pair's ids are in ascending order (the
//   Sampling path's draws are), they cover a narrow window of row ids, and
//   the rows drawn by several pairs are read from memory once and from L2
//   after. The block stages its pair's query in shared memory once; each
//   warp takes R_UNROLL draws at a time (their loads in flight together),
//   one float4 (or float, off the 16-byte path) per lane per step, then a
//   shuffle reduction per draw: per draw the arithmetic of the first port,
//   so the distances are bit-equal to it, in the order the ids were given.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---- l2dist_f32: the tiled kernel ----------------------------------------

// rows per tile, queries per tile, floats of k per staged chunk, ring
// stages, threads; the staged row stride in floats (a pad of 4)
constexpr int T_ROWS = 128, T_QT = 64, T_KC = 64, T_STAGES = 2,
              T_THREADS = 256, T_XS = T_KC + 4;
// thread (tq, tr) copies pieces tq, tq + 16, ... of each chunk of its rows
static_assert(T_KC / 4 == 16 && T_ROWS == 8 * 16, "tile layout");
// a block's shared memory on the H100, and the most chunks of a panel
constexpr int SMEM_LIMIT = 232448;
constexpr int T_RING = T_STAGES * T_ROWS * T_XS;
constexpr int T_MAX_CHUNKS = (SMEM_LIMIT / 4 - T_RING) / (T_KC * T_QT);
static_assert(T_MAX_CHUNKS == 9, "a panel of 9 chunks fits beside the ring");

// Dynamic shared memory of one block; ops.l2dist_smem computes the same.
constexpr int tiled_smem(int chunks) {
  return 4 * (chunks * T_KC * T_QT + T_RING);
}

// W bytes global -> shared, or W zero bytes when !ok: .cg (L2 only) takes
// 16 bytes alone, .ca takes 4, 8 and 16
template <int W>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (W == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(ok ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
                 "l"(src), "n"(W), "r"(ok ? W : 0));
}

// P consecutive floats of a W = 4P byte aligned address into v
template <int P>
__device__ __forceinline__ void load_piece(float* v, const float* src) {
  if constexpr (P == 4) {
    const float4 t = *reinterpret_cast<const float4*>(src);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else if constexpr (P == 2) {
    const float2 t = *reinterpret_cast<const float2*>(src);
    v[0] = t.x, v[1] = t.y;
  } else {
    v[0] = *src;
  }
}

__device__ __forceinline__ float lane_of(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// One panel of k (floats k0 .. k0 + 64 pc - 1) over the block's row tiles,
// with this panel's query tile resident in qt. The first panel starts its
// accumulators from zero; a later one (CONT) from the sums this thread
// stored for the same outputs in the panel before.
template <int W, bool CONT>
__device__ __forceinline__ void walk_panel(
    const float* __restrict__ x, float* __restrict__ out, int64_t n, int nq,
    int d, int k0, int pc, int64_t row_tiles, const float* qt, float* ring,
    int tq, int tr, int j0) {
  constexpr int P = W / 4;                   // floats a copy
  constexpr int M = T_KC / 16 / P;           // copies a row a thread a chunk
  // a step is (row tile t, chunk c of the panel, ring stage st); the
  // block's row tiles are blockIdx.x, + gridDim.x, ...; counters, not
  // divisions
  auto next = [pc](int64_t& t, int& c, int& st) {
    st = st + 1 == T_STAGES ? 0 : st + 1;
    if (++c == pc) {
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
      float* dst = ring + st * (T_ROWS * T_XS) + tr * T_XS;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int64_t r = r0 + 16 * i;
#pragma unroll
        for (int m = 0; m < M; ++m) {
          const int kk = P * (tq + 16 * m);
          const int k = k0 + c * T_KC + kk;
          const bool ok = r < n && k < d;
          cp_async<W>(dst + 16 * i * T_XS + kk, ok ? x + r * d + k : x, ok);
        }
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
    const int64_t r0 = t * T_ROWS + tr;
    if (CONT && c == 0) {
      // the sums after the panels before, as this thread stored them
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int64_t r = r0 + 16 * i;
        const float* o = out + r * nq + j0;
        if (r < n && j0 < nq) {
          if (vec) {
            const float4 v = *reinterpret_cast<const float4*>(o);
            acc[i][0] = v.x, acc[i][1] = v.y, acc[i][2] = v.z,
            acc[i][3] = v.w;
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (j0 + j < nq) acc[i][j] = o[j];
          }
        }
      }
    }
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
    if (c == pc - 1) {
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

// PANELS: d takes more than one panel (else the continuing walk is not
// compiled in, and the kernel is the one-panel loop alone)
template <int W, bool PANELS>
__global__ void __launch_bounds__(T_THREADS, 2)
l2dist_tiled_kernel(const float* __restrict__ x, const float* __restrict__ q,
                    float* __restrict__ out, int64_t n, int nq, int d,
                    int kch, int pk, int64_t row_tiles) {
  constexpr int P = W / 4;                   // floats a copy
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                          // [pk * T_KC][T_QT]
  float* ring = smem + pk * T_KC * T_QT;     // [T_STAGES][T_ROWS][T_XS]
  const int tid = threadIdx.x, lane = tid % 32;
  const int tq = lane % 16;                          // queries 4tq .. 4tq+3
  const int tr = 2 * (tid / 32) + lane / 16;         // rows tr + 16i, i < 8
  const int q0 = blockIdx.y * T_QT;

  // panel after panel of k: chunks c0 .. c0 + pc - 1, floats k0 ...
  for (int c0 = 0; c0 < kch; c0 += pk) {
    const int pc = kch - c0 < pk ? kch - c0 : pk;
    const int k0 = c0 * T_KC;
    // every warp is done with the last panel's query tile
    if (c0) __syncthreads();
    // this panel's query tile, transposed: qt[k][j] = q[q0 + j][k0 + k],
    // zero past Q and d
    for (int e = tid; e < T_QT * pc * (T_KC / P); e += T_THREADS) {
      const int j = e % T_QT, k = P * (e / T_QT);
      float v[P];
#pragma unroll
      for (int p = 0; p < P; ++p) v[p] = 0.f;
      if (q0 + j < nq && k0 + k < d)
        load_piece<P>(v, q + (int64_t)(q0 + j) * d + k0 + k);
#pragma unroll
      for (int p = 0; p < P; ++p) qt[(k + p) * T_QT + j] = v[p];
    }
    __syncthreads();                                 // the query tile
    if (!PANELS || c0 == 0)
      walk_panel<W, false>(x, out, n, nq, d, k0, pc, row_tiles, qt, ring, tq,
                           tr, q0 + 4 * tq);
    else
      walk_panel<W, true>(x, out, n, nq, d, k0, pc, row_tiles, qt, ring, tq,
                          tr, q0 + 4 * tq);
  }
}

// chunks of a panel: the fewest panels of at most T_MAX_CHUNKS, of equal
// chunks (the last may have fewer); ops.l2dist_plan computes the same
constexpr int panel_chunks(int kch) {
  return (kch + (kch + T_MAX_CHUNKS - 1) / T_MAX_CHUNKS - 1) /
         ((kch + T_MAX_CHUNKS - 1) / T_MAX_CHUNKS);
}

template <int W>
int launch_tiled(const float* x, const float* q, float* out, int64_t n,
                 int nq, int d, int kch, int pk, int64_t row_tiles,
                 int q_tiles, int smem, cudaStream_t stream) {
  auto kern = pk < kch ? l2dist_tiled_kernel<W, true>
                       : l2dist_tiled_kernel<W, false>;
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
  kern<<<grid, T_THREADS, smem, stream>>>(x, q, out, n, nq, d, kch, pk,
                                          row_tiles);
  return (int)cudaGetLastError();
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

// ---- l2dist_rows_f32 -----------------------------------------------------

// warps a block, draws a warp takes at once, draws a block
constexpr int R_WARPS = 8, R_UNROLL = 4, R_DRAWS = 128;
static_assert(R_DRAWS % (R_WARPS * R_UNROLL) == 0, "draws a block");

__global__ void __launch_bounds__(R_WARPS * 32)
l2dist_rows_kernel(const float* __restrict__ x, const int* __restrict__ ids,
                   const float* __restrict__ qs, float* __restrict__ out,
                   int nr, int c, int d, int vec) {
  extern __shared__ __align__(16) float qsh[];       // qs[r], d floats
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int r = (int)(blockIdx.x % (unsigned)nr);   // the pair: fast
  const int64_t j0 = (int64_t)(blockIdx.x / (unsigned)nr) * R_DRAWS;
  const float* qr = qs + (int64_t)r * d;
  if (vec) {
    for (int e = threadIdx.x; e < d / 4; e += R_WARPS * 32)
      reinterpret_cast<float4*>(qsh)[e] =
          reinterpret_cast<const float4*>(qr)[e];
  } else {
    for (int e = threadIdx.x; e < d; e += R_WARPS * 32) qsh[e] = qr[e];
  }
  __syncthreads();
  const int* idr = ids + (int64_t)r * c;
  float* outr = out + (int64_t)r * c;
  for (int w0 = warp * R_UNROLL; w0 < R_DRAWS; w0 += R_WARPS * R_UNROLL) {
    const float* xr[R_UNROLL];
    float s[R_UNROLL];
#pragma unroll
    for (int u = 0; u < R_UNROLL; ++u) {
      const int64_t col = j0 + w0 + u;
      xr[u] = x + (col < c ? (int64_t)idr[col] * d : 0);
      s[u] = 0.f;
    }
    if (vec) {
      const float4* q4 = reinterpret_cast<const float4*>(qsh);
      for (int j = lane; j < d / 4; j += 32) {
        const float4 b = q4[j];
        float4 a[R_UNROLL];
#pragma unroll
        for (int u = 0; u < R_UNROLL; ++u)
          a[u] = reinterpret_cast<const float4*>(xr[u])[j];
#pragma unroll
        for (int u = 0; u < R_UNROLL; ++u) {
          const float e0 = a[u].x - b.x, e1 = a[u].y - b.y,
                      e2 = a[u].z - b.z, e3 = a[u].w - b.w;
          s[u] = fmaf(e0, e0, s[u]);
          s[u] = fmaf(e1, e1, s[u]);
          s[u] = fmaf(e2, e2, s[u]);
          s[u] = fmaf(e3, e3, s[u]);
        }
      }
    } else {
      for (int j = lane; j < d; j += 32) {
        const float b = qsh[j];
        float a[R_UNROLL];
#pragma unroll
        for (int u = 0; u < R_UNROLL; ++u) a[u] = xr[u][j];
#pragma unroll
        for (int u = 0; u < R_UNROLL; ++u) {
          const float e = a[u] - b;
          s[u] = fmaf(e, e, s[u]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < R_UNROLL; ++u) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        s[u] += __shfl_xor_sync(0xffffffffu, s[u], o);
      const int64_t col = j0 + w0 + u;
      if (lane == 0 && col < c) outr[col] = s[u];
    }
  }
}

}  // namespace

// The plan (row tiles, query tiles, panels, chunks a panel, copy width,
// shared memory) comes from the wrapper (ops.l2dist_plan); a plan that
// disagrees with the kernel's own is refused.
extern "C" int l2dist_f32(const float* x, const float* q, float* out,
                          int64_t n, int nq, int d, int64_t row_tiles,
                          int q_tiles, int panels, int pk, int width,
                          int smem, void* stream) {
  const int kch = (d + T_KC - 1) / T_KC;
  const uintptr_t xa = (uintptr_t)x, qa = (uintptr_t)q;
  const int widest = (4 * d) % 16 == 0 && xa % 16 == 0 && qa % 16 == 0 ? 16
                     : (4 * d) % 8 == 0 && xa % 8 == 0 && qa % 8 == 0  ? 8
                     : xa % 4 == 0 && qa % 4 == 0                      ? 4
                                                                       : 0;
  if (d < 1 || pk != panel_chunks(kch) || panels != (kch + pk - 1) / pk ||
      smem != tiled_smem(pk) || width != widest ||
      row_tiles != (n + T_ROWS - 1) / T_ROWS ||
      q_tiles != (nq + T_QT - 1) / T_QT || q_tiles > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (width) {
    case 16:
      return launch_tiled<16>(x, q, out, n, nq, d, kch, pk, row_tiles,
                              q_tiles, smem, s);
    case 8:
      return launch_tiled<8>(x, q, out, n, nq, d, kch, pk, row_tiles,
                             q_tiles, smem, s);
    default:
      return launch_tiled<4>(x, q, out, n, nq, d, kch, pk, row_tiles,
                             q_tiles, smem, s);
  }
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
  const int64_t blocks = (int64_t)nr * ((c + R_DRAWS - 1) / R_DRAWS);
  const int smem = 4 * d;
  if (blocks > 0x7fffffff || smem > SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (smem > 48 * 1024 &&
      (err = cudaFuncSetAttribute(l2dist_rows_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem)) != cudaSuccess)
    return (int)err;
  l2dist_rows_kernel<<<(unsigned)blocks, R_WARPS * 32, smem,
                       (cudaStream_t)stream>>>(x, ids, qs, out, nr, c, d,
                                               vec);
  return (int)cudaGetLastError();
}
