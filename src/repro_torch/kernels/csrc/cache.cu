// The estimate cache's CLOCK (second-chance) insert of one flush's probed
// lanes, in lane order, in place on the cache's arrays.
//
// For each active lane: (1) the first valid entry whose key -- tau_key, all
// L*K bucket codes and, with match_qhash, both fingerprint words -- equals
// the lane's is its slot; (2) without one, the hand sweeps from hand + 1 to
// the first position that is not both valid and referenced, clearing ref on
// every position it passed (on all S when none qualifies, taking the first),
// and that victim is the slot, the hand moves to it, and an eviction is
// counted if it was valid; (3) every field of the slot is written, valid
// set and ref cleared.
//
// Replaces: src/repro/cache/estimate_cache.py, function insert -- a
// jax.lax.fori_loop over the lanes, not a pallas_call. As torch ops on the
// card it is ~20 launches a lane, thousands a flush.
//
// What bounds it on an H100: latency. Each lane reads the key columns of
// the S entries (valid, tau_key: 5 bytes each; the codes only of entries
// whose tau key matches) and the CLOCK bits up to the victim, and writes
// one slot; at S = 1024 that is ~5 KB a lane, nanoseconds at 3.35 TB/s. The
// lanes are a chain: each sees the writes of the ones before it.
//
// Design: one launch of one block of 1024 threads that loops over the lanes
// in order. The key match and the sweep are block-wide min-reductions over
// S (each thread scans its strided positions up to its first hit, then a
// warp shuffle and one pass through shared memory); __syncthreads between
// the steps and between lanes makes each write visible to the next read.
// S and the lane count are runtime values; nothing is staged.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 1024;

// The least v over the block; every thread gets it.
__device__ __forceinline__ int block_min(int v, int* red) {
  for (int o = 16; o > 0; o >>= 1)
    v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();                // red may still be read by the last call
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[threadIdx.x & 31];      // THREADS / 32 == 32 partials
  for (int o = 16; o > 0; o >>= 1)
    v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__global__ void __launch_bounds__(THREADS) cache_insert_kernel(
    int* __restrict__ c_qcodes, long long* __restrict__ c_qhash,
    int* __restrict__ c_tau, int* __restrict__ c_ball,
    long long* __restrict__ c_params, int* __restrict__ c_probed,
    float* __restrict__ c_est, int* __restrict__ c_nvis,
    unsigned char* __restrict__ c_valid, unsigned char* __restrict__ c_ref,
    int* __restrict__ c_hand, const int* __restrict__ qcodes,
    const long long* __restrict__ qhash, const int* __restrict__ tau,
    const int* __restrict__ balls, const long long* __restrict__ params_epoch,
    const float* __restrict__ ests, const int* __restrict__ nvis,
    const int* __restrict__ probed, const unsigned char* __restrict__ active,
    int* __restrict__ n_evicted, int s, int n, int nl, int lk,
    int match_qhash) {
  __shared__ int red[32];
  const int tid = threadIdx.x;
  int hand = *c_hand;
  int evicted = 0;
  const long long epoch = *params_epoch;
  for (int i = 0; i < n; ++i) {
    if (!active[i]) continue;     // the same for every thread
    const int* qc = qcodes + (size_t)i * lk;
    const int tk = tau[i];
    const long long h0 = qhash[2 * i], h1 = qhash[2 * i + 1];
    // (1) the first entry with this key
    int first = s;
    for (int p = tid; p < s; p += THREADS) {
      if (!c_valid[p] || c_tau[p] != tk) continue;
      if (match_qhash && (c_qhash[2 * p] != h0 || c_qhash[2 * p + 1] != h1))
        continue;
      const int* ec = c_qcodes + (size_t)p * lk;
      bool eq = true;
      for (int j = 0; j < lk && eq; ++j) eq = ec[j] == qc[j];
      if (eq) {
        first = p;
        break;
      }
    }
    first = block_min(first, red);
    int slot = first;
    if (first == s) {
      // (2) the sweep: the first claimable position in sweep order
      int vpos = s;
      for (int j = tid; j < s; j += THREADS) {
        const int p = (hand + 1 + j) % s;
        if (!(c_ref[p] && c_valid[p])) {
          vpos = j;
          break;
        }
      }
      vpos = block_min(vpos, red);
      const int swept = vpos < s ? vpos : s;
      slot = (hand + 1 + (vpos < s ? vpos : 0)) % s;
      evicted += c_valid[slot];   // read before any thread writes it
      __syncthreads();
      for (int j = tid; j < swept; j += THREADS) c_ref[(hand + 1 + j) % s] = 0;
      hand = slot;
    }
    // (3) write the slot
    for (int j = tid; j < lk; j += THREADS)
      c_qcodes[(size_t)slot * lk + j] = qc[j];
    for (int j = tid; j < nl; j += THREADS) {
      c_ball[(size_t)slot * nl + j] = balls[(size_t)i * nl + j];
      c_probed[(size_t)slot * nl + j] = probed[(size_t)i * nl + j];
    }
    if (tid == 0) {
      c_qhash[2 * slot] = h0;
      c_qhash[2 * slot + 1] = h1;
      c_tau[slot] = tk;
      c_params[slot] = epoch;
      c_est[slot] = ests[i];
      c_nvis[slot] = nvis[i];
      c_valid[slot] = 1;
      c_ref[slot] = 0;
    }
    __syncthreads();
  }
  if (tid == 0) {
    *c_hand = hand;
    *n_evicted = evicted;
  }
}

}  // namespace

extern "C" int cache_insert(int* c_qcodes, long long* c_qhash, int* c_tau,
                            int* c_ball, long long* c_params, int* c_probed,
                            float* c_est, int* c_nvis, unsigned char* c_valid,
                            unsigned char* c_ref, int* c_hand,
                            const int* qcodes, const long long* qhash,
                            const int* tau, const int* balls,
                            const long long* params_epoch, const float* ests,
                            const int* nvis, const int* probed,
                            const unsigned char* active, int* n_evicted,
                            int s, int n, int nl, int lk, int match_qhash,
                            void* stream) {
  if (s < 1 || n < 0 || nl < 1 || lk < 1) return (int)cudaErrorInvalidValue;
  cache_insert_kernel<<<1, THREADS, 0, (cudaStream_t)stream>>>(
      c_qcodes, c_qhash, c_tau, c_ball, c_params, c_probed, c_est, c_nvis,
      c_valid, c_ref, c_hand, qcodes, qhash, tau, balls, params_epoch, ests,
      nvis, probed, active, n_evicted, s, n, nl, lk, match_qhash);
  return (int)cudaGetLastError();
}
