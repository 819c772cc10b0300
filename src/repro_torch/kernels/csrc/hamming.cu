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
//
// query_lanes: the query hash fused into this scan.
//
// Replaces: src/repro/kernels/lsh_hash.py, function lsh_hash, at the query
// shape (64 x 128 -> 20 on the main path), together with the scan above.
//
// What bounds it: the scan's bytes, as above; the hash is Q*d*L*K
// multiply-adds (164 K at the main path's shape), nothing beside them. A
// separate hash kernel cost a launch and its wrapper (~28 us) for ~0.01 us
// of work, so the hash rides in the scan's launch.
//
// Design: the scan's grid, one block per bucket tile of 256 rows, in
// clusters of CLUSTER blocks, with the scan's body unchanged; but only the
// first `workers` blocks of a table (16 per SM over the L tables by
// default) scan live tiles, those holding rows below n_buckets, striding
// over them when there are more, and only their clusters hash. A block past
// them scans its own tile if it is padding (distances all K + 1, no codes
// needed) and else leaves it to worker (tile mod workers). So the prologue
// runs at most workers / CLUSTER times a table, whatever the data: ~6
// clusters per table on the main path's index, whose tiles are all padding
// but ~24 a table, and 264 on an index whose 2^21 rows are all live (one
// block per tile would hash in 2,048 clusters a table there). The padding
// tiles keep one block each, dispatched in order, so that the tiles being
// written at any moment lie together: persistent grids, which spread the
// writes over more tiles at a time, were slower on the main path's index.
// chip_smoke.py times other worker counts beside the default. Where the
// prologue runs, each block stages its quarter of the query rows and table
// l's K columns of a with cp.async (rows padded by four floats, so the hash's reads hit
// distinct banks), hashes that quarter into shared memory, and takes the
// other quarters from its cluster's blocks through distributed shared
// memory. Each code is summed over d in order with fmaf from 0, then
// __fadd_rn(acc, __fmul_rn(b, w)), __fdiv_rn and floorf: the order of
// lsh_hash_kernel (lsh_hash.cu), so the codes are bit-equal to it.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "stage.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int KMAX = 32;
constexpr int CLUSTER = 4;   // query_lanes: blocks that share one hash

// The scan's body: bucket row b of table l against the Q codes qs (Q, K)
// of that table in shared memory, one int32 written per query.
__device__ __forceinline__ void scan_row(const int* __restrict__ codes,
                                         const int* qs, int* __restrict__ out,
                                         int nq, int nl, int64_t nb, int k,
                                         int l, int64_t b, bool valid) {
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
  scan_row(codes, qs, out, nq, nl, nb, k, l, b, b < (int64_t)n_buckets[l]);
}

__host__ __device__ constexpr int align16(int bytes) {
  return (bytes + 15) / 16 * 16;
}

// query_lanes' shared memory: the (Q, K) codes, table l's (d, K) columns of
// a, and a chunk of qch query rows of d + pad floats.
__host__ __device__ constexpr int lanes_smem(int nq, int k, int d, int qch,
                                             int pad) {
  return align16(4 * nq * k) + align16(4 * d * k) + 4 * qch * (d + pad);
}

// Start copying query rows [q0, q0 + qn) into xs (rows of dp floats).
__device__ __forceinline__ void stage_queries(float* xs, const float* x,
                                              int q0, int qn, int d, int dp,
                                              int vec) {
  if (vec) {
    const int pr = d / 4;
    for (int e = threadIdx.x; e < qn * pr; e += THREADS) {
      const int r = e / pr, c4 = e % pr;
      cp_async16(xs + r * dp + 4 * c4, x + (int64_t)(q0 + r) * d + 4 * c4);
    }
  } else {
    for (int e = threadIdx.x; e < qn * d; e += THREADS) {
      const int r = e / d, j = e % d;
      cp_async4(xs + r * dp + j, x + (int64_t)(q0 + r) * d + j);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
query_lanes_kernel(const float* __restrict__ x, const float* __restrict__ a,
                   const float* __restrict__ hb, const float* __restrict__ hw,
                   const int* __restrict__ codes,
                   const int* __restrict__ n_buckets,
                   int* __restrict__ qcodes, int* __restrict__ out, int nq,
                   int nl, int64_t nb, int k, int d, int qch, int vec,
                   int64_t workers) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int l = blockIdx.y;
  const int f = nl * k;
  const int dp = d + (vec ? 4 : 1);
  int* qc = reinterpret_cast<int*>(smem);                        // (Q, K)
  float* as = reinterpret_cast<float*>(smem + align16(4 * nq * k));
  float* xs = reinterpret_cast<float*>(smem + align16(4 * nq * k) +
                                       align16(4 * d * k));      // (qch, dp)
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank();
  // tiles [0, tv) hold the live rows, scanned by the worker blocks [0,
  // workers) (a multiple of CLUSTER); a cluster needs the codes if one of
  // its blocks scans such a tile or writes qcodes, and the others write
  // K + 1 everywhere without them
  const int64_t i = blockIdx.x;
  const int64_t nvalid = n_buckets[l];
  const int64_t tv = (nvalid + THREADS - 1) / THREADS;
  const int64_t c0 = i - rank;
  const bool hash = c0 == 0 || (c0 < workers && c0 < tv);

  if (hash) {
    const int per = (nq + CLUSTER - 1) / CLUSTER;
    const int qa = min(nq, rank * per), qb = min(nq, qa + per);
    for (int i = threadIdx.x; i < d * k; i += THREADS)
      cp_async4(as + i, a + (int64_t)(i / k) * f + l * k + i % k);
    for (int q0 = qa; q0 < qb; q0 += qch) {
      const int qn = min(qch, qb - q0);
      __syncthreads();               // the previous chunk has been read
      stage_queries(xs, x, q0, qn, d, dp, vec);
      cp_async_wait_all();
      __syncthreads();
      for (int e = threadIdx.x; e < qn * k; e += THREADS) {
        const int r = e / k, c = e % k;
        const float* xr = xs + r * dp;
        float s = 0.f;
#pragma unroll 8
        for (int j = 0; j < d; ++j) s = fmaf(xr[j], as[j * k + c], s);
        const float wc = __ldg(hw + l * k + c);
        const float v = __fadd_rn(s, __fmul_rn(__ldg(hb + l * k + c), wc));
        qc[(q0 + r) * k + c] = (int)floorf(__fdiv_rn(v, wc));
      }
    }
    cp_async_wait_all();              // a block without queries
    cl.sync();        // every block's quarter of the codes is in place
    for (int i = threadIdx.x; i < nq * k; i += THREADS) {
      const int owner = (i / k) / per;
      if (owner != rank) qc[i] = *cl.map_shared_rank(qc + i, owner);
    }
    // the other blocks may read this block's codes until they arrive here
    // too: wait for them only before leaving
    asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
    __syncthreads();
    if (blockIdx.x == 0)
      for (int i = threadIdx.x; i < nq * k; i += THREADS)
        qcodes[((int64_t)(i / k) * nl + l) * k + i % k] = qc[i];
  }

  if (i >= tv) {
    // its own tile, padding; `b < nvalid` (false here) stays a runtime
    // value: with the constant, the compiler's store loop ran slower
    const int64_t b = i * THREADS + threadIdx.x;
    if (b < nb) scan_row(codes, qc, out, nq, nl, nb, k, l, b, b < nvalid);
  } else if (i < workers) {           // live tiles i, i + workers, ...
    for (int64_t t = i; t < tv; t += workers) {
      const int64_t b = t * THREADS + threadIdx.x;
      if (b < nb) scan_row(codes, qc, out, nq, nl, nb, k, l, b, b < nvalid);
    }
  }
  if (hash) asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
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

// qch (query rows staged per chunk) comes from the wrapper
// (ops.query_lanes); vec: d % 4 == 0 and x 16-byte aligned; workers: the
// worker blocks per table, 0 for 16 per SM over the nl tables.
extern "C" int query_lanes_i32(const float* x, const float* a,
                               const float* hb, const float* hw,
                               const int* codes, const int* n_buckets,
                               int* qcodes, int* out, int nq, int nl,
                               int64_t nb, int k, int d, int qch, int vec,
                               int64_t workers, void* stream) {
  if (nq < 1 || nl < 1 || k < 1 || k > KMAX || d < 1 || qch < 1 ||
      workers < 0 ||
      (vec && (d % 4 != 0 || (uintptr_t)x % 16 != 0)))
    return (int)cudaErrorInvalidValue;
  const int smem = lanes_smem(nq, k, d, qch, vec ? 4 : 1);
  cudaError_t err = cudaSuccess;
  if (workers == 0) {
    int dev = 0, sms = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    workers = 16 * (int64_t)sms / nl;
  }
  if (workers < CLUSTER) workers = CLUSTER;
  // one block per bucket tile, whole clusters, at least one cluster per
  // table; the workers in whole clusters, at most all of them
  const int64_t tiles = (nb + THREADS - 1) / THREADS;
  int64_t g = (tiles + CLUSTER - 1) / CLUSTER * CLUSTER;
  if (g == 0) g = CLUSTER;
  workers = (workers + CLUSTER - 1) / CLUSTER * CLUSTER;
  if (workers > g) workers = g;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(query_lanes_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)g, (unsigned)nl);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, query_lanes_kernel, x, a, hb, hw, codes,
                           n_buckets, qcodes, out, nq, nl, nb, k, d, qch,
                           vec, workers);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
