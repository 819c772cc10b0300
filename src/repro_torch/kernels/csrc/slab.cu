// One progressive-sampling slab (paper Alg. 2 body) for every active lane,
// fused into one launch: the PRP draws, the search of the ring's size
// cumsum, the CSR lookups and the qualification of the drawn candidates,
// reduced to each lane's weight sum wq_add (float32) and sample count
// w_add (int32). Under pooled stopping the rule stays in torch
// (core/prober.py _slab_step), one launch a step.
//
// The slab loop (LOOP, local stopping): the same kernel runs every lane's
// steps to done in one launch. After each step the lane's owner thread
// applies _slab_step's stopping rule and broadcasts the lane's next ring
// and slab; at the end it writes the lane's state and its counts.
//
// Replaces, on the slab path: src/repro/kernels/l2dist.py, function l2dist
// (Pallas body _kernel), and src/repro/kernels/adc.py, function adc (Pallas
// body _kernel), which qualify the candidates that the reference's
// _slab_step (repro/core/prober.py) resolves with jnp gathers. Here the
// resolution is fused too: the ring-cumsum row is searched in place, so no
// (lanes, B) copy of the rows is made, and no candidate id, row or
// distance passes through device memory. The loop replaces the reference's
// lax.while_loop over the slab steps.
//
// Bound on an H100: bytes -- the candidates' rows (512 B each at d = 128,
// 32 B as PQ codes), their `starts` and `order` entries and the cumsum
// sectors around each draw: ~9 MB at 128 lanes x 128 slots exact, ~2.7 us
// at 3.35 TB/s. In practice a slot is a chain of dependent loads (search,
// starts, order, row), so latency bounds it; the design shortens the chain.
// In the loop a lane's steps are a chain too: the longest lane sets the
// launch's time.
//
// Design:
// * Grid: one block per active lane (every lane in the loop); a chunk
//   above 128 slots (serve_cfg's 512) is split over a cluster of up to 4
//   blocks, whose partial sums block rank 0 adds through distributed
//   shared memory in rank order. No float atomics: banded sums are
//   deterministic.
// * While the threads run the PRP, cp.async stages the lane's query row
//   (exact) or LUT (ADC) and a sparse index of its cumsum row (the last
//   entry of each of <= 1024 windows) into shared memory. A search is then
//   ~10 steps in shared memory and log2(window) dependent loads in device
//   memory (11 at B = 2^21, against 21 for a plain binary search). In the
//   loop the query row stays staged across steps, the LUT is staged once
//   the lane reaches an ADC ring, and the sparse index again only when the
//   ring changes.
// * Exact route: one warp per candidate, four candidates in flight per
//   warp, one float4 per lane at d = 128, fmaf and __shfl_xor in the order
//   of l2dist_rows_kernel (l2dist.cu), so d^2 is bit-equal to it.
// * ADC route: one thread per candidate, the code row in registers, the sum
//   over m in order (adc_sum.cuh, shared with adc_rows), bit-equal to it.
//   Banded weights use IEEE-rounded sqrt, add and divide and no contraction,
//   so each weight equals torch's.
// * The route is per lane: exact without PQ codes or on a near ring
//   (k <= exact_rings), else ADC; only the routed one is computed.
// * The stopping rule (stop_rule) is torch's float32 arithmetic in torch's
//   order, each operation an IEEE-rounded intrinsic (nvcc would contract
//   a*b+c into an FMA), so the loop's state is bit-equal to the host loop's.
// * No tensor cores: the work is a gather plus a GEMV per lane in fp32,
//   and TF32 would move d^2 across tau^2.
//
// central_qualify (below): Alg. 3's exact count inside each lane's central
// bucket, in one launch for every lane.
//
// Replaces, on the central pass: src/repro/kernels/adc.py, function adc_q8
// (and adc for float LUTs, l2dist for the exact count), which qualify the
// ids that the reference's _count_central (repro/core/prober.py) gathers
// from ring 0's size cumsum by searchsorted. Ring 0 holds at most one
// bucket -- codes are unique within a table, so only the bucket whose code
// equals the lane's can lie at distance 0 -- and its points are the
// contiguous slice order[l, start : start + size] of the CSR layout. So
// no cumsum row is copied or searched.
//
// Bound on an H100: bytes -- per lane its code, the matched bucket's code,
// start and size, its min(size, budget) order entries and their rows (512
// B each exact at d = 128, 32 B as PQ codes), its query row or LUT; tens of
// microseconds at most at 128 lanes x 2048 exact, a few at 64 x 512 uint8.
// A lane is a chain: find the bucket, then read its ids, then their rows;
// the design keeps the chain short.
//
// Design:
// * Grid: one block per lane, or a cluster of up to 8 blocks (256 slots
//   each) where the budget is longer; block rank 0 adds the partial sums
//   in rank order through distributed shared memory. No float atomics.
// * The bucket is found by a 256-ary search of the lane's K-int code among
//   the first n_buckets[l] rows of bucket_codes[l], which are sorted
//   lexicographically as signed int32 and unique: each step every thread
//   compares one pivot row, and __syncthreads_count narrows the range; 2
//   steps at 5,000 buckets, 3 at 2^21. Meanwhile cp.async stages the
//   lane's query row (exact) or LUT (ADC).
// * Slots s < min(size, budget) read order[l, start + s]: contiguous, so
//   coalesced. The routes are slab_qualify's (exact in l2dist_rows' order,
//   adc_sum.cuh, the IEEE banded weight), so every sum is bit-equal to the
//   row kernels' and only the weight sum's order differs.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

#include "adc_sum.cuh"
#include "stage.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int NIDX = 1024;     // sparse index entries of a cumsum row
constexpr int UNROLL = 4;      // exact route: candidates in flight per warp
constexpr int KMAX = 32;       // central_qualify: code length

enum Mode { EXACT = 0, ADC_F32 = 1, ADC_U8 = 2 };

// The slab loop's lane state and stopping rule (LOOP): each lane's row of
// the prober's state tensors, read at entry and written when it is done.
struct Loop {
  int* k;                  // (QL,) ring
  int* ci;                 // (QL,) slab index within the ring
  int* w;                  // (QL,) samples drawn in the ring
  float* wq;               // (QL,) their weight sum
  float* target;           // (QL,) next schedule anchor
  float* est;              // (QL,) folded ring estimates
  int* nvisited;           // (QL,) samples of folded rings
  bool* ptf;               // (QL,) stopped by condition (2)
  bool* done;              // (QL,)
  const float* totals_f;   // (QL, K) |N_k|
  const float* w_caps;     // (QL, K) schedule caps
  const float* first;      // (QL, K) first schedule anchors
  int* counts;             // (QL, 3) out: exact and ADC candidates, steps
  float a, a2, eps;        // ln(1/delta), 2a and eps rounded to float32
  int visit_budget, schedule_checks;
};

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
  float* wq_add;           // (A,) one step's sums (not LOOP)
  int* w_add;              // (A,)
  int n_rings, nb, n_points, d, chunk, exact_rings, cb, m, kc, align, vec,
      splits, stride, nidx;
  Loop lp;                 // LOOP: A = QL, every lane
};

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

// Exact route: wt[s] = 1[||x[ids[s]] - q||^2 <= tsq] for s < ns, 0 where
// ids[s] < 0. One warp per candidate, UNROLL candidates in flight per warp,
// one float4 per lane where vec; fmaf and __shfl_xor in the order of
// l2dist_rows_kernel (l2dist.cu), so d^2 is bit-equal to it.
__device__ __forceinline__ void qualify_exact(const float* __restrict__ x,
                                              int d, int vec, const float* q,
                                              float tsq, const int* ids,
                                              float* wt, int ns) {
  const int wp = threadIdx.x / 32, ln = threadIdx.x % 32;
  for (int base = wp * UNROLL; base < ns; base += WARPS * UNROLL) {
    const float* xr[UNROLL];
    float acc[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int id = base + u < ns ? ids[base + u] : -1;
      xr[u] = id >= 0 ? x + (int64_t)id * d : nullptr;
      acc[u] = 0.f;
    }
    if (vec) {
      const float4* q4 = reinterpret_cast<const float4*>(q);
      for (int j = ln; j < d / 4; j += 32) {
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
      for (int j = ln; j < d; j += 32) {
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
}

// ADC route: one thread per candidate, the code row in registers, the sum
// over m in order (adc_sum.cuh, shared with adc_rows), so it is bit-equal
// to it; a hard weight, the banded one where resid is given, or a uint8
// LUT's int32 sum against th.
template <int MODE, bool PACK>
__device__ __forceinline__ void qualify_adc(const uint8_t* __restrict__ codes,
                                            int cb, int align, int kc,
                                            const unsigned char* stage,
                                            const float* __restrict__ resid,
                                            float tsq, int th, const int* ids,
                                            float* wt, int ns) {
  using Lut = typename std::conditional<MODE == ADC_U8, uint8_t, float>::type;
  const Lut* lut = reinterpret_cast<const Lut*>(stage);
  for (int s = threadIdx.x; s < ns; s += THREADS) {
    const int id = ids[s];
    float w = 0.f;
    if (id >= 0) {
      unsigned wd[MAXW];
      load_row(codes + (int64_t)id * cb, cb, align, wd);
      if (MODE == ADC_U8) {
        w = adc_sum<PACK, Lut, int>(wd, cb, lut, kc) <= th ? 1.f : 0.f;
      } else {
        const float sq = adc_sum<PACK, Lut, float>(wd, cb, lut, kc);
        w = resid ? band_weight(sq, __ldg(resid + id), tsq)
                  : (sq <= tsq ? 1.f : 0.f);
      }
    }
    wt[s] = w;
  }
}

struct Red {
  float wq[WARPS];
  int w[WARPS];
  float part_wq;
  int part_w;
};

// A lane's weight sum and count of ids >= 0 over slots s < ns, in a fixed
// order: strided per thread, a shuffle tree per warp, the warps in order;
// for a lane split over a cluster of `splits` blocks, block rank 0 then
// adds the blocks' partials in rank order. True in the one thread that
// holds the lane's sums.
__device__ __forceinline__ bool lane_sums(Red& red, const float* wt,
                                          const int* ids, int ns, int splits,
                                          float& wq, int& w) {
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
    red.wq[threadIdx.x / 32] = wsum;
    red.w[threadIdx.x / 32] = cnt;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float bw = 0.f;
    int bc = 0;
    for (int i = 0; i < WARPS; ++i) {
      bw += red.wq[i];
      bc += red.w[i];
    }
    red.part_wq = bw;
    red.part_w = bc;
    wq = bw;
    w = bc;
  }
  if (splits == 1) return threadIdx.x == 0;
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();
  bool mine = false;
  if (cl.block_rank() == 0 && threadIdx.x == 0) {
    float bw = 0.f;
    int bc = 0;
    for (int r = 0; r < splits; ++r) {
      bw += *cl.map_shared_rank(&red.part_wq, r);
      bc += *cl.map_shared_rank(&red.part_w, r);
    }
    wq = bw;
    w = bc;
    mine = true;
  }
  cl.sync();  // keep every block's shared memory until rank 0 has read it
  return mine;
}

// A lane's loop state, held by its owner thread (thread 0 of block rank 0).
struct LaneState {
  int k, ci, w, nvisited;
  float wq, target, est;
  bool ptf, done;
};

// One application of prober._slab_step's stopping rule to lane `la`,
// whose step in ring kc = min(k, K) (PRP domain p_ring) drew w_add
// candidates of weight sum wq_add. torch's float32 arithmetic in torch's
// order: p_hat = wq / max(wf, 1), mu_upper and mu_lower as in
// core/sampling.py (w clamped to 1e-9, a / (2w), 2a / (9w), a / (18w)),
// ring_est = (|N_k| * wq) / max(wf, 1); each operation an IEEE-rounded
// intrinsic, so none is contracted into an FMA.
__device__ __forceinline__ void stop_rule(LaneState& s, float wq_add,
                                          int w_add, const Loop& lp, int la,
                                          int n_rings, int chunk,
                                          int p_ring) {
  const int rw = la * n_rings + min(s.k, n_rings) - 1;
  const float wq = __fadd_rn(s.wq, wq_add);
  const int w = s.w + w_add;
  const bool exhausted = (s.ci + 1) * chunk >= p_ring;
  const float wf = __int2float_rn(w);
  const float wf1 = fmaxf(wf, 1.f);
  const float ring_est = __fdiv_rn(__fmul_rn(lp.totals_f[rw], wq), wf1);
  const float p_hat = __fdiv_rn(wq, wf1);
  const float w_cap = lp.w_caps[rw];
  const bool at = !lp.schedule_checks || wf >= s.target || wf >= w_cap;
  const float wc = fmaxf(wf, 1e-9f);
  const float t = __fdiv_rn(lp.a, __fmul_rn(2.f, wc));
  const float rt = __fsqrt_rn(t);
  const float su = __fadd_rn(__fsqrt_rn(__fadd_rn(p_hat, t)), rt);
  const float mu_u = __fmul_rn(su, su);
  const float in = __fsub_rn(
      __fsqrt_rn(__fadd_rn(p_hat, __fdiv_rn(lp.a2, __fmul_rn(9.f, wc)))), rt);
  const float mu_l = fmaxf(
      __fsub_rn(__fmul_rn(in, in), __fdiv_rn(lp.a, __fmul_rn(18.f, wc))), 0.f);
  const bool cond1 = __fsub_rn(mu_u, p_hat) <= lp.eps &&
                     __fsub_rn(p_hat, mu_l) <= lp.eps;
  const bool cond2 = mu_u < lp.eps;
  const bool budget_hit = s.nvisited + w >= lp.visit_budget;
  const bool ring_done = (at && (cond1 || cond2)) || wf >= w_cap ||
                         exhausted || budget_hit;
  s.ptf = s.ptf || (at && cond2);
  if (ring_done) {
    s.k += 1;
    s.ci = 0;
    s.w = 0;
    s.wq = 0.f;
    s.target = lp.first[la * n_rings + min(s.k - 1, n_rings - 1)];
    s.est = __fadd_rn(s.est, ring_est);
    s.nvisited += w;
  } else {
    s.ci += 1;
    s.w = w;
    s.wq = wq;
    if (at) s.target = __fmul_rn(s.target, 2.f);
  }
  s.done = s.k > n_rings || s.ptf || budget_hit;
}

// One slab step of lane la (not LOOP), or all of the lane's steps until it
// is done (LOOP), on this block's share of the chunk.
template <int MODE, bool PACK, bool LOOP>
__global__ void __launch_bounds__(THREADS) slab_qualify_kernel(Args a) {
  using Lut = typename std::conditional<MODE == ADC_U8, uint8_t, float>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int sidx[NIDX];
  __shared__ Red red;
  __shared__ int step_next[3];  // LOOP: the lane's k, ci, done after a step

  const int la = blockIdx.x / a.splits;
  const int slots = (a.chunk + a.splits - 1) / a.splits;
  const int s0 = (blockIdx.x % a.splits) * slots;
  const int ns = max(0, min(slots, a.chunk - s0));
  const int64_t lane = a.lanes[la];
  const int64_t t = a.tid[la];
  const bool owner = threadIdx.x == 0 && blockIdx.x % a.splits == 0;
  int* ids = reinterpret_cast<int*>(smem);
  float* wt = reinterpret_cast<float*>(smem) + slots;
  unsigned char* stage = smem + (8 * slots + 15) / 16 * 16;
  const int lut_bytes = a.m * a.kc * (int)sizeof(Lut);
  const float tsq = a.tau_sq[lane];
  const int th = MODE == ADC_U8 ? a.thresh[lane] : 0;
  unsigned rk[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) rk[i] = (unsigned)a.rks[6 * la + i];

  int k = a.k[la], ci = a.ci[la];
  bool done = false;
  LaneState st{};
  int n_exact = 0, n_adc = 0, steps = 0;
  if (LOOP) {
    done = a.lp.done[la];
    if (owner)
      st = LaneState{k,                  ci,
                     a.lp.w[la],         a.lp.nvisited[la],
                     a.lp.wq[la],        a.lp.target[la],
                     a.lp.est[la],       a.lp.ptf[la],
                     done};
  }
  int staged = -1;    // what the stage holds: 0 the query row, 1 the LUT
  int staged_k = 0;   // the ring whose sparse index sidx holds
  while (!done) {
    const int kc = min(k, a.n_rings);
    const int rw = la * a.n_rings + kc - 1;
    const bool exact = MODE == EXACT || kc <= a.exact_rings;
    const int* cum = a.cums + (lane * (a.n_rings + 1) + kc) * (int64_t)a.nb;

    // asynchronous staging: the routed query row or LUT, the sparse index
    if ((int)!exact != staged) {
      if (exact)
        stage_async(stage, reinterpret_cast<const unsigned char*>(
                               a.qs + lane * a.d), 4 * a.d);
      else
        stage_async(stage,
                    reinterpret_cast<const unsigned char*>(a.luts) +
                        (int64_t)a.lane_q[lane] * lut_bytes,
                    lut_bytes);
      staged = !exact;
    }
    if (kc != staged_k) {
      for (int i = threadIdx.x; i < a.nidx; i += THREADS)
        cp_async4(&sidx[i], cum + min((int64_t)(i + 1) * a.stride,
                                      (int64_t)a.nb) - 1);
      staged_k = kc;
    }

    // the PRP draws meanwhile: ids[s] holds the draw, or -1 outside the ring
    const int p_ring = a.prings[rw], cap = a.caps[rw], nbits = a.nbits[rw];
    const int idx0 = ci * a.chunk + s0;
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

    if (exact)
      qualify_exact(a.x, a.d, a.vec, reinterpret_cast<const float*>(stage),
                    tsq, ids, wt, ns);
    else if (MODE != EXACT)
      qualify_adc<MODE, PACK>(a.codes, a.cb, a.align, a.kc, stage, a.resid,
                              tsq, th, ids, wt, ns);
    __syncthreads();

    float wq;
    int w;
    const bool mine = lane_sums(red, wt, ids, ns, a.splits, wq, w);
    if (!LOOP) {
      if (mine) {
        a.wq_add[la] = wq;
        a.w_add[la] = w;
      }
      return;
    }
    if (mine) {
      (exact ? n_exact : n_adc) += w;
      ++steps;
      stop_rule(st, wq, w, a.lp, la, a.n_rings, a.chunk, p_ring);
      step_next[0] = st.k;
      step_next[1] = st.ci;
      step_next[2] = st.done;
    }
    // every block of the lane takes its next step from block rank 0
    if (a.splits == 1) {
      __syncthreads();
      k = step_next[0];
      ci = step_next[1];
      done = step_next[2];
    } else {
      cg::cluster_group cl = cg::this_cluster();
      cl.sync();
      const int* nx = cl.map_shared_rank(step_next, 0);
      k = nx[0];
      ci = nx[1];
      done = nx[2];
      if (done) cl.sync();  // rank 0 stays until every block has read
    }
  }
  if (LOOP && owner) {
    a.lp.k[la] = st.k;
    a.lp.ci[la] = st.ci;
    a.lp.w[la] = st.w;
    a.lp.wq[la] = st.wq;
    a.lp.target[la] = st.target;
    a.lp.est[la] = st.est;
    a.lp.nvisited[la] = st.nvisited;
    a.lp.ptf[la] = st.ptf;
    a.lp.done[la] = st.done;
    a.lp.counts[3 * la] = n_exact;
    a.lp.counts[3 * la + 1] = n_adc;
    a.lp.counts[3 * la + 2] = steps;
  }
}

struct CentralArgs {
  const int* qcodes;       // (QL, K) each lane's code
  const int64_t* tid;      // (QL,) tables
  const int* bcodes;       // (L, B, K) bucket codes, sorted below n_buckets
  const int* n_buckets;    // (L,)
  const int* starts;       // (L, B) bucket starts
  const int* sizes;        // (L, B) bucket sizes
  const int* order;        // (L, C) point ids in CSR order
  const float* x;          // (C, d) corpus rows
  const float* qs;         // (QL, d) each lane's query
  const float* tau_sq;     // (QL,)
  const uint8_t* codes;    // (C, cb) byte or packed 4-bit codes
  const void* luts;        // (Q, M, Kc) float32 or uint8
  const int* lane_q;       // (QL,) each lane's LUT
  const float* resid;      // (C,) residual norms: banded weights, or null
  const int* thresh;       // (QL,) uint8-LUT thresholds
  float* qualified;        // (QL,)
  int* seen;               // (QL,)
  int* total;              // (QL,)
  int nb, n_points, k, d, budget, cb, m, kc, align, vec, splits;
};

// -1, 0 or 1 as bucket row `row` sorts before, equal to or after `code`
// (lexicographic over K signed int32 codes).
__device__ __forceinline__ int compare_row(const int* __restrict__ row,
                                           const int* code, int k) {
  for (int j = 0; j < k; ++j) {
    const int v = __ldg(row + j);
    if (v != code[j]) return v < code[j] ? -1 : 1;
  }
  return 0;
}

template <int MODE, bool PACK>
__global__ void __launch_bounds__(THREADS)
central_qualify_kernel(CentralArgs a) {
  using Lut = typename std::conditional<MODE == ADC_U8, uint8_t, float>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int code[KMAX];
  __shared__ int found;
  __shared__ Red red;

  const int64_t lane = blockIdx.x / a.splits;
  const int rank = blockIdx.x % a.splits;
  const int slots = (a.budget + a.splits - 1) / a.splits;
  const int64_t t = a.tid[lane];
  int* ids = reinterpret_cast<int*>(smem);
  float* wt = reinterpret_cast<float*>(smem) + slots;
  unsigned char* stage = smem + (8 * slots + 15) / 16 * 16;

  // asynchronous staging of the routed query row or LUT, then the search
  if constexpr (MODE == EXACT) {
    stage_async(stage, reinterpret_cast<const unsigned char*>(
                           a.qs + lane * a.d), 4 * a.d);
  } else {
    const int lut_bytes = a.m * a.kc * (int)sizeof(Lut);
    stage_async(stage,
                reinterpret_cast<const unsigned char*>(a.luts) +
                    (int64_t)a.lane_q[lane] * lut_bytes,
                lut_bytes);
  }
  if (threadIdx.x < a.k) code[threadIdx.x] = a.qcodes[lane * a.k + threadIdx.x];
  if (threadIdx.x == 0) found = INT_MAX;
  __syncthreads();

  // 256-ary search: each step every thread compares one pivot row; the
  // pivots <= code are a prefix, and the bucket, if any, is one of them or
  // lies between the last of them and the next pivot
  const int* rows = a.bcodes + t * (int64_t)a.nb * a.k;
  int lo = 0, hi = a.n_buckets[t];
  while (lo < hi) {
    const int stride = (hi - lo + THREADS - 1) / THREADS;
    const int idx = lo + threadIdx.x * stride;
    int cmp = 1;
    if (idx < hi) {
      cmp = compare_row(rows + (int64_t)idx * a.k, code, a.k);
      if (cmp == 0) atomicMin(&found, idx);
    }
    const int c = __syncthreads_count(cmp <= 0);
    if (stride == 1 || c == 0) break;
    const int nlo = lo + (c - 1) * stride + 1;
    hi = min(lo + c * stride, hi);
    lo = nlo;
  }
  __syncthreads();

  // the bucket's slots of this block, as contiguous CSR entries
  const int j = found;
  const int64_t row = t * (int64_t)a.nb + j;
  const int size = j != INT_MAX ? __ldg(a.sizes + row) : 0;
  const int start = j != INT_MAX ? __ldg(a.starts + row) : 0;
  const int seen = min(size, a.budget);
  const int ns = max(0, min(slots, seen - rank * slots));
  const int* ord = a.order + t * (int64_t)a.n_points + start + rank * slots;
  for (int s = threadIdx.x; s < ns; s += THREADS) ids[s] = __ldg(ord + s);
  cp_async_wait_all();
  __syncthreads();

  if constexpr (MODE == EXACT)
    qualify_exact(a.x, a.d, a.vec, reinterpret_cast<const float*>(stage),
                  a.tau_sq[lane], ids, wt, ns);
  else
    qualify_adc<MODE, PACK>(a.codes, a.cb, a.align, a.kc, stage, a.resid,
                            a.tau_sq[lane],
                            MODE == ADC_U8 ? a.thresh[lane] : 0, ids, wt, ns);
  __syncthreads();

  float wq;
  int w;
  if (lane_sums(red, wt, ids, ns, a.splits, wq, w)) {
    a.qualified[lane] = wq;
    a.seen[lane] = seen;
    a.total[lane] = size;
  }
}

// Launch `blocks` blocks of THREADS threads in clusters of `splits`.
template <typename A>
int launch_clusters(void (*kern)(A), const A& args, int blocks, int splits,
                    int smem, cudaStream_t stream) {
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <bool LOOP>
int launch(const Args& args, int na, int mode, int packed, int smem,
           cudaStream_t stream) {
  void (*kern)(Args) = slab_qualify_kernel<EXACT, false, LOOP>;
  if (mode == ADC_F32)
    kern = packed ? &slab_qualify_kernel<ADC_F32, true, LOOP>
                  : &slab_qualify_kernel<ADC_F32, false, LOOP>;
  if (mode == ADC_U8)
    kern = packed ? &slab_qualify_kernel<ADC_U8, true, LOOP>
                  : &slab_qualify_kernel<ADC_U8, false, LOOP>;
  return launch_clusters(kern, args, na * args.splits, args.splits, smem,
                         stream);
}

template <int MODE, bool PACK>
int launch_central(const CentralArgs& args, int nql, int smem,
                   cudaStream_t stream) {
  return launch_clusters(central_qualify_kernel<MODE, PACK>, args,
                         nql * args.splits, args.splits, smem, stream);
}

}  // namespace

// mode: 0 exact only, 1 float32 LUTs, 2 uint8 LUTs (with thresholds).
// One slab step of na active lanes.
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
            (nb + stride - 1) / stride, Loop{}};
  return launch<false>(args, na, mode, packed, smem, (cudaStream_t)stream);
}

// The slab loop: every one of the nql lanes steps until it is done, its
// state (k .. done) read and written in place, its counts written.
extern "C" int slab_loop(
    int* k, int* ci, int* w, float* wq, float* target, float* est,
    int* nvisited, bool* ptf, bool* done, const int64_t* lanes,
    const int64_t* tid, const int64_t* rks, const int* prings,
    const int* caps, const int* nbits, const float* totals_f,
    const float* w_caps, const float* first, const int* cums,
    const int* starts, const int* order, const float* x, const float* qs,
    const float* tau_sq, const uint8_t* codes, const void* luts,
    const int* lane_q, const float* resid, const int* thresh, int* counts,
    float a_const, float a2, float eps, int nql, int n_rings, int nb,
    int n_points, int d, int chunk, int exact_rings, int mode, int cb, int m,
    int kc, int packed, int align, int vec, int splits, int smem,
    int visit_budget, int schedule_checks, void* stream) {
  const int stride = (nb + NIDX - 1) / NIDX;
  Loop lp{k,        ci,     w,      wq,     target,   est,
          nvisited, ptf,    done,   totals_f, w_caps, first,
          counts,   a_const, a2,    eps,    visit_budget, schedule_checks};
  Args args{k,      ci,     lanes,  tid,   rks,       prings, caps,
            nbits,  cums,   starts, order, x,         qs,     tau_sq,
            codes,  luts,   lane_q, resid, thresh,    nullptr, nullptr,
            n_rings, nb,    n_points, d,   chunk,     exact_rings, cb,
            m,      kc,     align,  vec,   splits,    stride,
            (nb + stride - 1) / stride, lp};
  return launch<true>(args, nql, mode, packed, smem, (cudaStream_t)stream);
}

// mode: 0 exact, 1 float32 LUTs, 2 uint8 LUTs (with thresholds). The
// splits (blocks per lane) and the shared memory come from the wrapper
// (ops.central_qualify).
extern "C" int central_qualify(
    const int* qcodes, const int64_t* tid, const int* bcodes,
    const int* n_buckets, const int* starts, const int* sizes,
    const int* order, const float* x, const float* qs, const float* tau_sq,
    const uint8_t* codes, const void* luts, const int* lane_q,
    const float* resid, const int* thresh, float* qualified, int* seen,
    int* total, int nql, int nb, int n_points, int k, int d, int budget,
    int mode, int cb, int m, int kc, int packed, int align, int vec,
    int splits, int smem, void* stream) {
  if (k < 1 || k > KMAX || splits < 1 || splits > 8 || budget < 1)
    return (int)cudaErrorInvalidValue;
  CentralArgs args{qcodes, tid,    bcodes, n_buckets, starts, sizes,
                   order,  x,      qs,     tau_sq,    codes,  luts,
                   lane_q, resid,  thresh, qualified, seen,   total,
                   nb,     n_points, k,    d,         budget, cb,
                   m,      kc,     align,  vec,       splits};
  auto s = (cudaStream_t)stream;
  if (mode == EXACT) return launch_central<EXACT, false>(args, nql, smem, s);
  if (mode == ADC_F32)
    return packed ? launch_central<ADC_F32, true>(args, nql, smem, s)
                  : launch_central<ADC_F32, false>(args, nql, smem, s);
  return packed ? launch_central<ADC_U8, true>(args, nql, smem, s)
                : launch_central<ADC_U8, false>(args, nql, smem, s);
}
