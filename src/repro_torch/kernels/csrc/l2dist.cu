// Squared L2 distances in the difference form sum_j (x_j - q_j)^2, fp32.
//
// Replaces: src/repro/kernels/l2dist.py, function l2dist (Pallas body
// _kernel), which uses the MXU expansion |x|^2 - 2 x.q + |q|^2. This port
// keeps the reference's default qualification form (prober.py
// make_exact_qualfn, use_kernels=False) so that decisions at tau^2 match
// the reference; the expansion would round differently.
//
// Two entry points:
//
// * l2dist_f32: x (N, d), q (Q, d) -> (N, Q). Serves true_cardinality and
//   the query workload (1M x 64 at d = 128). Bound on an H100: operations
//   -- 2*N*Q*d = 16.8 GFLOP against 0.77 GB moved. Design: 64 x 64 output
//   tiles per block of 256 threads, each thread a 4 x 4 register tile;
//   x and q are staged through shared memory 16 columns at a time,
//   transposed so each thread reads its four rows and four queries as two
//   float4 loads. CUDA cores, fp32 (no tensor cores: TF32 would move d^2).
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

extern "C" int l2dist_f32(const float* x, const float* q, float* out,
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
