// One progressive-sampling slab (paper Alg. 2 body) for every active lane,
// fused into one launch: the PRP draws, the search of the ring's size
// cumsum, the CSR lookups and the qualification of the drawn candidates,
// reduced to each lane's weight sum wq_add (float32) and sample count
// w_add (int32). The stopping rule stays in torch (core/prober.py).
//
// Replaces, on the slab path: src/repro/kernels/l2dist.py, function l2dist
// (Pallas body _kernel), and src/repro/kernels/adc.py, function adc (Pallas
// body _kernel), which qualify the candidates that the reference's
// _slab_step (repro/core/prober.py) resolves with jnp gathers. Here the
// resolution is fused too: the ring-cumsum row is searched in place, so no
// (lanes, B) copy of the rows is made, and no candidate id, row or
// distance passes through device memory.
//
// Bound on an H100: bytes -- the candidates' rows (512 B each at d = 128,
// 32 B as PQ codes), their `starts` and `order` entries and the cumsum
// sectors around each draw: ~9 MB at 128 lanes x 128 slots exact, ~2.7 us
// at 3.35 TB/s. In practice a slot is a chain of dependent loads (search,
// starts, order, row), so latency bounds it; the design shortens the chain.
//
// Design:
// * Grid: one block per active lane; a chunk above 128 slots (serve_cfg's
//   512) is split over a cluster of up to 4 blocks, whose partial sums
//   block rank 0 adds through distributed shared memory in rank order. No
//   float atomics: banded sums are deterministic.
// * While the threads run the PRP, cp.async stages the lane's query row
//   (exact) or LUT (ADC) and a sparse index of its cumsum row (the last
//   entry of each of <= 1024 windows) into shared memory. A search is then
//   ~10 steps in shared memory and log2(window) dependent loads in device
//   memory (11 at B = 2^21, against 21 for a plain binary search).
// * Exact route: one warp per candidate, four candidates in flight per
//   warp, one float4 per lane at d = 128, fmaf and __shfl_xor in the order
//   of l2dist_rows_kernel (l2dist.cu), so d^2 is bit-equal to it.
// * ADC route: one thread per candidate, the code row in registers, the sum
//   over m in order (adc_sum.cuh, shared with adc_rows), bit-equal to it.
//   Banded weights use IEEE-rounded sqrt, add and divide and no contraction,
//   so each weight equals torch's.
// * The route is per lane: exact without PQ codes or on a near ring
//   (k <= exact_rings), else ADC; only the routed one is computed.
// * No tensor cores: the work is a gather plus a GEMV per lane in fp32,
//   and TF32 would move d^2 across tau^2.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "adc_sum.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int NIDX = 1024;     // sparse index entries of a cumsum row
constexpr int UNROLL = 4;      // exact route: candidates in flight per warp

enum Mode { EXACT = 0, ADC_F32 = 1, ADC_U8 = 2 };

struct Args {
  const int* k;            // (A,) ring of each active lane
  const int* ci;           // (A,) slab index within the ring
  const int64_t* lanes;    // (A,) lane ids (rows of cums, qs, tau_sq)
  const int64_t* tid;      // (A,) tables
  const int64_t* rks;      // (A, 6) PRP round keys, uint32 values
  const int* prings;       // (A, K) PRP domains
  const int* caps;         // (A, K) sample caps
  const int* nbits;        // (A, K) log2 of the domains
  const int* cums;         // (QL, K+1, B) ring size cumsums
  const int* starts;       // (L, B) bucket starts
  const int* order;        // (L, C) point ids in CSR order
  const float* x;          // (C, d) corpus rows
  const float* qs;         // (QL, d) each lane's query
  const float* tau_sq;     // (QL,)
  const uint8_t* codes;    // (C, cb) byte or packed 4-bit codes
  const void* luts;        // (Q, M, Kc) float32 or uint8
  const int* lane_q;       // (QL,) each lane's LUT
  const float* resid;      // (C,) residual norms: banded weights, or null
  const int* thresh;       // (QL,) uint8-LUT thresholds
  float* wq_add;           // (A,)
  int* w_add;              // (A,)
  int n_rings, nb, n_points, d, chunk, exact_rings, cb, m, kc, align, vec,
      splits, stride, nidx;
};

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

// Start copying `bytes` from device to shared memory: 16 or 4 bytes a copy
// where both ends allow it, else plain byte loads.
__device__ __forceinline__ void stage_async(unsigned char* dst,
                                            const unsigned char* src,
                                            int bytes) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  if (a % 16 == 0 && bytes % 16 == 0) {
    for (int e = threadIdx.x; e < bytes / 16; e += THREADS)
      cp_async16(dst + 16 * e, src + 16 * e);
  } else if (a % 4 == 0 && bytes % 4 == 0) {
    for (int e = threadIdx.x; e < bytes / 4; e += THREADS)
      cp_async4(dst + 4 * e, src + 4 * e);
  } else {
    for (int e = threadIdx.x; e < bytes; e += THREADS) dst[e] = src[e];
  }
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The keyed multiply/xorshift PRP on Z_{2^n} (prober._prp_eval) in native
// uint32: wrap-around then masking keeps the bits the int64 emulation keeps.
__device__ __forceinline__ unsigned prp(unsigned x, const unsigned (&rk)[6],
                                        unsigned mask, int nbits) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    x = (x * (rk[2 * i] | 1u)) & mask;
    x ^= x >> (nbits / 2 + (i % 2) + 1);
    x = (x + rk[2 * i + 1]) & mask;
  }
  return x;
}

// The banded ADC weight of ref.band_weight, rounded as torch rounds it.
__device__ __forceinline__ float band_weight(float adc_sq, float r,
                                             float tau_sq) {
  const float adc = __fsqrt_rn(fmaxf(adc_sq, 0.f));
  const float lo = fmaxf(__fsub_rn(adc, r), 0.f);
  const float hi = __fadd_rn(adc, r);
  const float tau = __fsqrt_rn(tau_sq);
  const float w = hi > lo ? __fdiv_rn(__fsub_rn(tau, lo),
                                      fmaxf(__fsub_rn(hi, lo), 1e-12f))
                          : (adc <= tau ? 1.f : 0.f);
  return fminf(fmaxf(w, 0.f), 1.f);
}

template <int MODE, bool PACK>
__global__ void __launch_bounds__(THREADS) slab_qualify_kernel(Args a) {
  using Lut = typename std::conditional<MODE == ADC_U8, uint8_t, float>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int sidx[NIDX];
  __shared__ float red_wq[WARPS];
  __shared__ int red_w[WARPS];
  __shared__ float part_wq;
  __shared__ int part_w;

  const int la = blockIdx.x / a.splits;
  const int slots = (a.chunk + a.splits - 1) / a.splits;
  const int s0 = (blockIdx.x % a.splits) * slots;
  const int ns = max(0, min(slots, a.chunk - s0));
  const int64_t lane = a.lanes[la];
  const int64_t t = a.tid[la];
  const int kc = min(a.k[la], a.n_rings);
  const int rw = la * a.n_rings + kc - 1;
  const bool exact = MODE == EXACT || kc <= a.exact_rings;
  const int* cum = a.cums + (lane * (a.n_rings + 1) + kc) * (int64_t)a.nb;
  int* ids = reinterpret_cast<int*>(smem);
  float* wt = reinterpret_cast<float*>(smem) + slots;
  unsigned char* stage = smem + (8 * slots + 15) / 16 * 16;
  const int lut_bytes = a.m * a.kc * (int)sizeof(Lut);

  // asynchronous staging: the routed query row or LUT, the sparse index
  if (exact)
    stage_async(stage, reinterpret_cast<const unsigned char*>(
                           a.qs + lane * a.d), 4 * a.d);
  else
    stage_async(stage,
                reinterpret_cast<const unsigned char*>(a.luts) +
                    (int64_t)a.lane_q[lane] * lut_bytes,
                lut_bytes);
  for (int i = threadIdx.x; i < a.nidx; i += THREADS)
    cp_async4(&sidx[i], cum + min((int64_t)(i + 1) * a.stride,
                                  (int64_t)a.nb) - 1);

  // the PRP draws meanwhile: ids[s] holds the draw, or -1 outside the ring
  const int p_ring = a.prings[rw], cap = a.caps[rw], nbits = a.nbits[rw];
  unsigned rk[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) rk[i] = (unsigned)a.rks[6 * la + i];
  const int idx0 = a.ci[la] * a.chunk + s0;
  for (int s = threadIdx.x; s < ns; s += THREADS) {
    const int idx = idx0 + s;
    const unsigned p = prp((unsigned)idx, rk, (unsigned)(p_ring - 1), nbits);
    ids[s] = idx < p_ring && (int)p < cap ? (int)p : -1;
  }
  cp_async_wait_all();
  __syncthreads();

  // resolve each draw: upper bound in the sparse index, then in its window
  // of the cumsum row, then the bucket's start and the point id
  for (int s = threadIdx.x; s < ns; s += THREADS) {
    const int p = ids[s];
    if (p < 0) continue;
    int lo = 0, hi = a.nidx;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (sidx[mid] > p) hi = mid; else lo = mid + 1;
    }
    int64_t j = a.nb - 1;
    if (lo < a.nidx) {
      int64_t wlo = (int64_t)lo * a.stride;
      int64_t whi = min(wlo + a.stride, (int64_t)a.nb) - 1;
      while (wlo < whi) {
        const int64_t mid = (wlo + whi) >> 1;
        if (__ldg(cum + mid) > p) whi = mid; else wlo = mid + 1;
      }
      j = wlo;
    }
    const int prev = j > 0 ? __ldg(cum + j - 1) : 0;
    int pos = __ldg(a.starts + t * a.nb + j) + (p - prev);
    pos = min(max(pos, 0), a.n_points - 1);
    ids[s] = __ldg(a.order + t * a.n_points + pos);
  }
  __syncthreads();

  if (exact) {
    const int wp = threadIdx.x / 32, ln = threadIdx.x % 32;
    const float* q = reinterpret_cast<const float*>(stage);
    const float tsq = a.tau_sq[lane];
    for (int base = wp * UNROLL; base < ns; base += WARPS * UNROLL) {
      const float* xr[UNROLL];
      float acc[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int id = base + u < ns ? ids[base + u] : -1;
        xr[u] = id >= 0 ? a.x + (int64_t)id * a.d : nullptr;
        acc[u] = 0.f;
      }
      if (a.vec) {
        const float4* q4 = reinterpret_cast<const float4*>(q);
        for (int j = ln; j < a.d / 4; j += 32) {
          const float4 b = q4[j];
          float4 v[UNROLL];
#pragma unroll
          for (int u = 0; u < UNROLL; ++u)
            v[u] = xr[u] ? __ldg(reinterpret_cast<const float4*>(xr[u]) + j)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {
            if (!xr[u]) continue;
            const float e0 = v[u].x - b.x, e1 = v[u].y - b.y,
                        e2 = v[u].z - b.z, e3 = v[u].w - b.w;
            acc[u] = fmaf(e0, e0, acc[u]);
            acc[u] = fmaf(e1, e1, acc[u]);
            acc[u] = fmaf(e2, e2, acc[u]);
            acc[u] = fmaf(e3, e3, acc[u]);
          }
        }
      } else {
        for (int j = ln; j < a.d; j += 32) {
          const float b = q[j];
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {
            if (!xr[u]) continue;
            const float e = __ldg(xr[u] + j) - b;
            acc[u] = fmaf(e, e, acc[u]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          acc[u] += __shfl_xor_sync(0xffffffffu, acc[u], o);
        if (ln == 0 && base + u < ns)
          wt[base + u] = xr[u] && acc[u] <= tsq ? 1.f : 0.f;
      }
    }
  } else if (MODE != EXACT) {
    const Lut* lut = reinterpret_cast<const Lut*>(stage);
    const float tsq = a.tau_sq[lane];
    const int th = MODE == ADC_U8 ? a.thresh[lane] : 0;
    for (int s = threadIdx.x; s < ns; s += THREADS) {
      const int id = ids[s];
      float w = 0.f;
      if (id >= 0) {
        unsigned wd[MAXW];
        load_row(a.codes + (int64_t)id * a.cb, a.cb, a.align, wd);
        if (MODE == ADC_U8) {
          w = adc_sum<PACK, Lut, int>(wd, a.cb, lut, a.kc) <= th ? 1.f : 0.f;
        } else {
          const float sq = adc_sum<PACK, Lut, float>(wd, a.cb, lut, a.kc);
          w = a.resid ? band_weight(sq, __ldg(a.resid + id), tsq)
                      : (sq <= tsq ? 1.f : 0.f);
        }
      }
      wt[s] = w;
    }
  }
  __syncthreads();

  // fixed-order block sums: strided per thread, a shuffle tree per warp,
  // the warps in order
  float wsum = 0.f;
  int cnt = 0;
  for (int s = threadIdx.x; s < ns; s += THREADS) {
    wsum += wt[s];
    cnt += ids[s] >= 0;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    wsum += __shfl_xor_sync(0xffffffffu, wsum, o);
    cnt += __shfl_xor_sync(0xffffffffu, cnt, o);
  }
  if (threadIdx.x % 32 == 0) {
    red_wq[threadIdx.x / 32] = wsum;
    red_w[threadIdx.x / 32] = cnt;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float bw = 0.f;
    int bc = 0;
    for (int i = 0; i < WARPS; ++i) {
      bw += red_wq[i];
      bc += red_w[i];
    }
    part_wq = bw;
    part_w = bc;
    if (a.splits == 1) {
      a.wq_add[la] = bw;
      a.w_add[la] = bc;
    }
  }
  if (a.splits == 1) return;
  // a split lane: block rank 0 of the cluster adds the partials in order
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();
  if (cl.block_rank() == 0 && threadIdx.x == 0) {
    float bw = 0.f;
    int bc = 0;
    for (int r = 0; r < a.splits; ++r) {
      bw += *cl.map_shared_rank(&part_wq, r);
      bc += *cl.map_shared_rank(&part_w, r);
    }
    a.wq_add[la] = bw;
    a.w_add[la] = bc;
  }
  cl.sync();  // keep every block's shared memory until rank 0 has read it
}

template <int MODE, bool PACK>
int launch(const Args& args, int na, int smem, cudaStream_t stream) {
  auto kern = slab_qualify_kernel<MODE, PACK>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(na * args.splits));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)args.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// mode: 0 exact only, 1 float32 LUTs, 2 uint8 LUTs (with thresholds).
extern "C" int slab_qualify(
    const int* k, const int* ci, const int64_t* lanes, const int64_t* tid,
    const int64_t* rks, const int* prings, const int* caps, const int* nbits,
    const int* cums, const int* starts, const int* order, const float* x,
    const float* qs, const float* tau_sq, const uint8_t* codes,
    const void* luts, const int* lane_q, const float* resid,
    const int* thresh, float* wq_add, int* w_add, int na, int n_rings,
    int nb, int n_points, int d, int chunk, int exact_rings, int mode,
    int cb, int m, int kc, int packed, int align, int vec, int splits,
    int smem, void* stream) {
  const int stride = (nb + NIDX - 1) / NIDX;
  Args args{k,      ci,     lanes,  tid,   rks,       prings, caps,
            nbits,  cums,   starts, order, x,         qs,     tau_sq,
            codes,  luts,   lane_q, resid, thresh,    wq_add, w_add,
            n_rings, nb,    n_points, d,   chunk,     exact_rings, cb,
            m,      kc,     align,  vec,   splits,    stride,
            (nb + stride - 1) / stride};
  auto s = (cudaStream_t)stream;
  if (mode == EXACT) return launch<EXACT, false>(args, na, smem, s);
  if (mode == ADC_F32)
    return packed ? launch<ADC_F32, true>(args, na, smem, s)
                  : launch<ADC_F32, false>(args, na, smem, s);
  return packed ? launch<ADC_U8, true>(args, na, smem, s)
                : launch<ADC_U8, false>(args, na, smem, s);
}
