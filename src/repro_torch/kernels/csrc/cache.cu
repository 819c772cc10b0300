// The estimate cache's CLOCK (second-chance) insert of one flush's probed
// lanes, in lane order, in place on the cache's arrays.
//
// For each active lane: (1) the lowest-position valid entry whose key --
// tau_key, all L*K bucket codes and, with match_qhash, both fingerprint
// words -- equals the lane's is its slot; (2) without one, the hand sweeps
// from hand + 1 to the first position that is not both valid and
// referenced, clearing ref on every position it passed (on all S when none
// qualifies, taking hand + 1), and that victim is the slot, the hand moves
// to it, and an eviction is counted if it was valid; (3) every field of the
// slot is written, valid set and ref cleared.
//
// Replaces: src/repro/cache/estimate_cache.py, function insert -- a
// jax.lax.fori_loop over the lanes, not a pallas_call. As torch ops on the
// card it is ~20 launches a lane, thousands a flush.
//
// What bounds it on an H100: latency. The lanes are a chain (each sees the
// writes of the ones before it), so one warp walks them; the bytes (~60 KB
// a flush at S = 1024) are nanoseconds at 3.35 TB/s. A lane's floor is a
// few dependent shared-memory round trips, votes and branches of one warp.
//
// Design: three launches in one call.
//  - keys (a grid, one thread an item): every active lane and every valid
//    entry gets the id of the first active lane whose key equals its own
//    (-1 for none). A 32-bit fingerprint of the key is compared first,
//    against a tile of the lanes' fingerprints in shared memory, and an
//    equal fingerprint is confirmed on the full key.
//  - chain (one block; its 32..1024 threads stage and write back, ~8
//    chunks of 8 entries a thread): the entries' ids (16 bits, plus a
//    "keyed" bit), the claim (not both valid and referenced) and valid
//    bitmaps, the lanes' ids and each key id's candidate slot are staged in
//    shared memory (the candidates in device memory past 227 KB), and
//    warp 0 walks the lanes with no barrier and, but for such candidates,
//    no read of device memory.
//    A lane's match is its key's candidate if that still holds its id
//    (two shared loads; see cache_insert_chain_kernel), else a search of
//    all ids by the warp, else none: then the sweep, by ballots over 32
//    words of claim bits a vote from hand + 1. After the loop the lanes'
//    slots and each slot's last writer go to device memory, with valid,
//    ref, the hand and the eviction count.
//  - write (a grid, one warp a lane): each lane that was its slot's last
//    writer copies its fields into the slot.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KEY_THREADS = 256;
constexpr int WRITE_WARPS = 8;
constexpr int LANE_CHUNK = 1024;   // lanes staged at a time by the chain
constexpr unsigned ACTIVE = 1u << 31;
constexpr int UNROLL = 8;          // staging loads in flight a thread
constexpr unsigned NONE = 0xffffffffu;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ uint32_t mix(uint32_t h, uint32_t w) {
  h = (h ^ w) * 0x9E3779B1u;
  return h ^ (h >> 16);
}

// The fingerprints of two keys (a key marked absent reads nothing), their
// codes loaded 8 at a time and interleaved, so that both cost ceil(lk / 8)
// round trips to device memory together.
__device__ __forceinline__ void fingerprints(
    const int* ca, const int* ta, const long long* ha, bool na,
    const int* cb, const int* tb, const long long* hb, bool nb, int lk,
    int match, uint32_t* fa, uint32_t* fb) {
  uint32_t a = mix(0x811C9DC5u, na ? (uint32_t)*ta : 0u);
  uint32_t b = mix(0x811C9DC5u, nb ? (uint32_t)*tb : 0u);
  for (int j0 = 0; j0 < lk; j0 += 8) {
    int va[8], vb[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const bool in = j0 + e < lk;
      va[e] = na && in ? ca[j0 + e] : 0;
      vb[e] = nb && in ? cb[j0 + e] : 0;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (j0 + e < lk) {
        a = mix(a, (uint32_t)va[e]);
        b = mix(b, (uint32_t)vb[e]);
      }
  }
  if (match) {
    const unsigned long long a0 = na ? ha[0] : 0, a1 = na ? ha[1] : 0;
    const unsigned long long b0 = nb ? hb[0] : 0, b1 = nb ? hb[1] : 0;
    a = mix(mix(a, (uint32_t)a0), (uint32_t)(a0 >> 32));
    a = mix(mix(a, (uint32_t)a1), (uint32_t)(a1 >> 32));
    b = mix(mix(b, (uint32_t)b0), (uint32_t)(b0 >> 32));
    b = mix(mix(b, (uint32_t)b1), (uint32_t)(b1 >> 32));
  }
  *fa = a;
  *fb = b;
}

__device__ __forceinline__ bool key_eq(const int* ca, int ta,
                                       const long long* ha, const int* cb,
                                       int tb, const long long* hb, int lk,
                                       int match) {
  if (ta != tb) return false;
  if (match && (ha[0] != hb[0] || ha[1] != hb[1])) return false;
  bool eq = true;
  for (int j0 = 0; j0 < lk && eq; j0 += 8) {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (j0 + e < lk) eq &= ca[j0 + e] == cb[j0 + e];
  }
  return eq;
}

// Items [0, n) are the lanes, [n, n + s) the entries. The lanes are
// walked in tiles of KEY_THREADS fingerprints in shared memory; an item
// looks for its first candidate in a tile without branching out of the
// loop, then confirms it on the full key (a fingerprint collision resumes
// the search after it).
__global__ void __launch_bounds__(KEY_THREADS) cache_insert_keys_kernel(
    const int* __restrict__ c_qcodes, const long long* __restrict__ c_qhash,
    const int* __restrict__ c_tau, const unsigned char* __restrict__ c_valid,
    const int* __restrict__ qcodes, const long long* __restrict__ qhash,
    const int* __restrict__ tau, const unsigned char* __restrict__ active,
    int* __restrict__ cid, int* __restrict__ eid, int* __restrict__ writer,
    int s, int n, int lk, int match) {
  __shared__ uint2 tkey[KEY_THREADS];   // (fingerprint, active) a lane
  const int tid = threadIdx.x;
  const int item = blockIdx.x * KEY_THREADS + tid;
  const bool is_lane = item < n;
  const int p = item - n;
  const int* my_codes = qcodes;
  const long long* my_qh = qhash;
  const int* my_tau = tau;
  bool need = false;
  if (is_lane) {
    need = active[item];
    my_codes = qcodes + (size_t)item * lk;
    my_qh = qhash + 2 * (size_t)item;
    my_tau = tau + item;
  } else if (p < s) {
    need = c_valid[p];
    my_codes = c_qcodes + (size_t)p * lk;
    my_qh = c_qhash + 2 * (size_t)p;
    my_tau = c_tau + p;
  }
  uint32_t my_fp = 0;
  int found = -1;
  for (int j0 = 0; j0 < n; j0 += KEY_THREADS) {
    // also the barrier before the tile is staged again
    if (j0 > 0 && __syncthreads_and(!need || found >= 0)) break;
    const int j = j0 + tid;
    const bool a = j < n && active[j];
    uint32_t fj, mine;
    fingerprints(qcodes + (size_t)j * lk, tau + j, qhash + 2 * (size_t)j, a,
                 my_codes, my_tau, my_qh, need && j0 == 0, lk, match, &fj,
                 &mine);
    if (j0 == 0) my_fp = mine;
    tkey[tid] = make_uint2(fj, a);
    __syncthreads();
    const int m = min(KEY_THREADS, n - j0);
    for (int t0 = 0; need && found < 0 && t0 < m;) {
      int cand = m;
#pragma unroll 8
      for (int t = t0; t < m; ++t) {
        const uint2 k = tkey[t];
        if (cand == m && k.y && k.x == my_fp) cand = t;
      }
      if (cand == m) break;
      const int jj = j0 + cand;
      if (key_eq(my_codes, *my_tau, my_qh, qcodes + (size_t)jj * lk,
                 tau[jj], qhash + 2 * (size_t)jj, lk, match))
        found = jj;
      t0 = cand + 1;
    }
  }
  if (is_lane) {
    cid[item] = found;
  } else if (p < s) {
    eid[p] = found;
    writer[p] = -1;
  }
}

// Sets the bits of [a, b) in `bits`; lane l of the warp takes the words
// w with w % 32 == l.
__device__ __forceinline__ void set_bits(uint32_t* bits, int a, int b,
                                         int lane) {
  if (a >= b) return;
  const int wa = a >> 5, wb = (b - 1) >> 5;
  if (wa == wb) {                 // the common case: a sweep of a few
    if (lane == (wa & 31)) {      // positions
      const int hi = b - 32 * wa;
      bits[wa] |= (hi == 32 ? FULL : (1u << hi) - 1u) & (FULL << (a & 31));
    }
    return;
  }
#pragma unroll 1
  for (int w = wa + ((lane - wa) & 31); w <= wb; w += 32) {
    const int lo = max(a - 32 * w, 0), hi = min(b - 32 * w, 32);
    const uint32_t upto = hi == 32 ? FULL : (1u << hi) - 1u;
    bits[w] |= upto & ~((1u << lo) - 1u);
  }
}

// The first claimable position of [a, b) (its bit set in `cbits`), with
// its valid bit at bit 31, or NONE; every lane of the warp gets it.
__device__ __forceinline__ unsigned first_claimable(const uint32_t* cbits,
                                                    const uint32_t* vbits,
                                                    int a, int b, int lane) {
  if (a >= b) return NONE;
  const int wa = a >> 5, wb = (b - 1) >> 5;
  for (int w0 = wa; w0 <= wb; w0 += 32) {
    const int w = w0 + lane;
    uint32_t claim = 0, valid = 0;
    if (w <= wb) {
      claim = cbits[w];
      valid = vbits[w];
      if (w == wa) claim &= FULL << (a & 31);
      if (w == wb) claim &= FULL >> (31 - ((b - 1) & 31));
    }
    const unsigned ball = __ballot_sync(FULL, claim != 0);
    if (ball) {
      const int f = __ffs(claim) - 1;
      const unsigned mine =
          claim ? (unsigned)(32 * w + f) | ((valid >> f) & 1u) << 31 : 0u;
      return __shfl_sync(FULL, mine, __ffs(ball) - 1);
    }
  }
  return NONE;
}

// Bits 15 and 31 of the result: the 16-bit halves of w that are zero
// (exact: the add carries out of neither half).
__device__ __forceinline__ unsigned zero_halves(unsigned w) {
  return ~(((w & 0x7fff7fffu) + 0x7fff7fffu) | w) & 0x80008000u;
}

// The positions of an 8-id chunk whose id is c (as 16 bits twice in cc),
// as 8 bits.
__device__ __forceinline__ unsigned chunk_hits(uint4 v, unsigned cc) {
  const unsigned z0 = zero_halves(v.x ^ cc), z1 = zero_halves(v.y ^ cc),
                 z2 = zero_halves(v.z ^ cc), z3 = zero_halves(v.w ^ cc);
  if (!(z0 | z1 | z2 | z3)) return 0;
  return (z0 >> 15 & 1) | (z0 >> 30 & 2) | (z1 >> 13 & 4) | (z1 >> 28 & 8) |
         (z2 >> 11 & 16) | (z2 >> 26 & 32) | (z3 >> 9 & 64) |
         (z3 >> 24 & 128);
}

// 32 bool bytes from p as 32 bits, the loads issued together.
__device__ __forceinline__ uint32_t pack_bools(const unsigned char* p,
                                               int from, int s) {
  uint32_t bits = 0;
#pragma unroll
  for (int e = 0; e < 32; ++e)
    bits |= (uint32_t)(from + e < s && p[from + e] != 0) << e;
  return bits;
}

// Each lane's slot (-1 inactive) from the lanes [i0, i1) of linfo, and
// each slot's last writer: the largest lane that wrote it.
__device__ __forceinline__ void record_slots(const uint32_t* linfo,
                                             int* slot_of, int* writer,
                                             int i0, int i1, int tid, int T) {
  for (int i = i0 + tid; i < i1; i += T) {
    const uint32_t v = linfo[i - i0];
    const int slot = v & ACTIVE ? (int)(v & 0xffffu) : -1;
    slot_of[i] = slot;
    if (slot >= 0) atomicMax(&writer[slot], i);
  }
}

// The least position of the 8-id chunks (ch = lane, lane + 32, ...) whose
// id is c and keyed, or NONE; the warp's lanes share the chunks, four in
// flight a lane.
__device__ __forceinline__ unsigned warp_search(const uint16_t* ids,
                                                const unsigned char* keyed,
                                                int chunks, unsigned c,
                                                int lane) {
  const unsigned cc = c | (c << 16);
  unsigned first = NONE;
#pragma unroll 1
  for (int ch0 = lane; ch0 < chunks && first == NONE; ch0 += 128) {
    uint4 v[4];
    unsigned kb[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int ch = ch0 + 32 * u;
      v[u] = ch < chunks ? reinterpret_cast<const uint4*>(ids)[ch]
                         : make_uint4(0, 0, 0, 0);
      kb[u] = ch < chunks ? keyed[ch] : 0u;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const unsigned h = chunk_hits(v[u], cc) & kb[u];
      if (h && first == NONE) first = 8 * (ch0 + 32 * u) + __ffs(h) - 1;
    }
  }
  return __reduce_min_sync(FULL, first);
}

// Warp 0 walks the lanes; the block stages and writes back. A key id c has
// one candidate slot, cand[c]: at first the least entry holding c, then
// the slot the last lane with c wrote. Holding c still, it is the least
// position that does: a lane with c takes the least, and it evicts only
// when no position holds c, so a second one never appears beside it. A
// lane with no candidate evicts; one whose candidate an earlier lane of
// the flush evicted searches all ids. The CLOCK state is two bitmaps:
// claim (not both valid and referenced: the sweep's stopping points; a
// sweep and a write only ever set its bits) and valid; the final ref of a
// valid entry is its claim bit's complement, and an invalid entry's is
// unchanged (a sweep never passes an invalid entry).
__global__ void __launch_bounds__(1024) cache_insert_chain_kernel(
    const int* __restrict__ cid, const int* __restrict__ eid,
    unsigned char* __restrict__ c_valid, unsigned char* __restrict__ c_ref,
    int* __restrict__ c_hand, int* __restrict__ slot_of,
    int* __restrict__ writer, unsigned* __restrict__ cand_global,
    int* __restrict__ n_evicted, int s, int n, int cand_shared) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = blockDim.x, tid = threadIdx.x, warp = tid >> 5,
            lane = tid & 31;
  const int chunks = (s + 7) >> 3, words = (s + 31) >> 5;
  // layout: ids (chunks x 8 u16), claim, valid and first ref bitmaps, the
  // staged lanes, the candidates (when they fit), keyed bytes (one a
  // chunk)
  uint16_t* ids = reinterpret_cast<uint16_t*>(smem);
  uint32_t* cbits = reinterpret_cast<uint32_t*>(smem + 16 * chunks);
  uint32_t* vbits = cbits + words;
  uint32_t* rbits = vbits + words;
  uint32_t* linfo = rbits + words;
  unsigned* cand = cand_shared ? linfo + LANE_CHUNK : cand_global;
  unsigned char* keyed = reinterpret_cast<unsigned char*>(
      linfo + LANE_CHUNK + (cand_shared ? n : 0));

  // staging: a thread's loads are issued together, so that a block of one
  // warp waits for device memory a few times, not once a word; the hand
  // and the first lanes' ids are loaded first
  const int hand0 = *c_hand;
  int cs0[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const int i = tid + u * T;
    cs0[u] = i < min(n, LANE_CHUNK) ? cid[i] : -1;
  }
  for (int i = tid; i < n; i += T) cand[i] = NONE;
  for (int w = tid; w < words; w += T) {
    const uint32_t v = pack_bools(c_valid, 32 * w, s);
    const uint32_t r = pack_bools(c_ref, 32 * w, s);
    vbits[w] = v;
    rbits[w] = r;
    cbits[w] = ~(v & r);
  }
  __syncthreads();
  for (int ch0 = tid; ch0 < chunks; ch0 += UNROLL / 2 * T) {
    int4 e[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int ch = ch0 + u / 2 * T;
      e[u] = ch < chunks ? reinterpret_cast<const int4*>(eid)[2 * ch + u % 2]
                         : make_int4(-1, -1, -1, -1);
    }
#pragma unroll
    for (int u2 = 0; u2 < UNROLL / 2; ++u2) {
      const int ch = ch0 + u2 * T;
      if (ch >= chunks) break;
      const int4 e0 = e[2 * u2], e1 = e[2 * u2 + 1];
      const int id8[8] = {e0.x, e0.y, e0.z, e0.w, e1.x, e1.y, e1.z, e1.w};
      uint32_t packed[4] = {0, 0, 0, 0};
      unsigned kb = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int id = 8 * ch + j < s ? id8[j] : -1;
        if (id >= 0) {
          kb |= 1u << j;
          packed[j >> 1] |= (uint32_t)id << (16 * (j & 1));
          atomicMin(&cand[id], (unsigned)(8 * ch + j));
        }
      }
      reinterpret_cast<uint4*>(ids)[ch] =
          make_uint4(packed[0], packed[1], packed[2], packed[3]);
      keyed[ch] = (unsigned char)kb;
    }
  }

  int hand = hand0;
  int st = hand0 >= -1 && hand0 < s
               ? (hand0 + 1 == s ? 0 : hand0 + 1)          // hand + 1 mod s
               : (int)((((long long)hand0 + 1) % s + s) % s);
  int evicted = 0;
  for (int i0 = 0; i0 < n; i0 += LANE_CHUNK) {
    const int i1 = min(n, i0 + LANE_CHUNK);
    __syncthreads();   // the candidates complete; the last chunk's lanes done
    if (i0 > 0) record_slots(linfo, slot_of, writer, i0 - LANE_CHUNK, i0, tid,
                             T);
    __syncthreads();
    for (int j0 = i0 + tid; j0 < i1; j0 += UNROLL * T) {
      int cs[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        cs[u] = j0 == tid ? cs0[u]
                          : (j0 + u * T < i1 ? cid[j0 + u * T] : -1);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = j0 + u * T;
        if (i >= i1) break;
        linfo[i - i0] = cs[u] < 0 ? 0u : ACTIVE | (unsigned)cs[u];
      }
    }
    __syncthreads();
    if (warp != 0) continue;
    unsigned next = linfo[0];
    for (int i = i0; i < i1; ++i) {
      const unsigned info = next;
      if (i + 1 < i1) next = linfo[i + 1 - i0];
      if (!(info & ACTIVE)) continue;
      const unsigned c = info & 0xffffu;
      unsigned m = cand[c];
      if (m != NONE && !(ids[m] == c && (keyed[m >> 3] >> (m & 7)) & 1))
        m = warp_search(ids, keyed, chunks, c, lane);
      int slot = (int)m;
      if (m == NONE) {
        // the sweep: the first claimable position from hand + 1, over
        // [st, s) then [0, st); the positions it passed become claimable
        // (their ref cleared), all S when none was (every entry valid)
        unsigned v = NONE;
#pragma unroll 1
        for (int seg = 0; seg < 2 && v == NONE; ++seg)
          v = first_claimable(cbits, vbits, seg ? 0 : st, seg ? st : s,
                              lane);
        slot = v == NONE ? st : (int)(v & 0xffffu);
        evicted += v == NONE ? 1 : (int)(v >> 31);
        const bool wrap = v == NONE || slot < st;
#pragma unroll 1
        for (int seg = 0; seg < 2; ++seg) {
          const int a = v == NONE ? (seg ? s : 0) : (seg ? 0 : st);
          const int b = seg ? (wrap && v != NONE ? slot : 0)
                            : (wrap ? s : slot);
          set_bits(cbits, a, b, lane);
        }
        hand = slot;
        st = slot + 1 == s ? 0 : slot + 1;
      }
      // the slot, by the lane owning its bitmap word (set_bits' too):
      // claimable (ref clear), valid, its id and keyed bit, c's candidate;
      // the lane's slot takes its place in linfo
      if (lane == ((slot >> 5) & 31)) {
        const int w = slot >> 5, ch = slot >> 3;
        const uint32_t cw = cbits[w], vw = vbits[w];
        const unsigned kb = keyed[ch];
        cbits[w] = cw | 1u << (slot & 31);
        vbits[w] = vw | 1u << (slot & 31);
        keyed[ch] = (unsigned char)(kb | 1u << (slot & 7));
        ids[slot] = (uint16_t)c;
        cand[c] = (unsigned)slot;
        linfo[i - i0] = ACTIVE | (unsigned)slot;
      }
      __syncwarp();
    }
  }
  __syncthreads();
  record_slots(linfo, slot_of, writer, (n - 1) / LANE_CHUNK * LANE_CHUNK, n,
               tid, T);
  // valid and ref back, 4 bytes a store where both arrays allow it
  const bool wide = !((reinterpret_cast<uintptr_t>(c_valid) |
                       reinterpret_cast<uintptr_t>(c_ref)) & 3);
  for (int q = tid; q < (s + 3) >> 2; q += T) {
    const int p = 4 * q, sh = p & 31;
    const uint32_t v = vbits[p >> 5] >> sh, c = cbits[p >> 5] >> sh,
                   r = rbits[p >> 5] >> sh;
    const uint32_t ref = ((v & ~c) | (~v & r)) & 0xfu;   // see above
    if (wide && p + 4 <= s) {
      *reinterpret_cast<uint32_t*>(c_valid + p) =
          ((v & 0xfu) * 0x00204081u) & 0x01010101u;
      *reinterpret_cast<uint32_t*>(c_ref + p) =
          (ref * 0x00204081u) & 0x01010101u;
    } else {
      for (int j = 0; j < 4 && p + j < s; ++j) {
        c_valid[p + j] = (v >> j) & 1;
        c_ref[p + j] = (ref >> j) & 1;
      }
    }
  }
  if (tid == 0) {
    *c_hand = hand;
    *n_evicted = evicted;
  }
}

__global__ void __launch_bounds__(WRITE_WARPS * 32) cache_insert_write_kernel(
    int* __restrict__ c_qcodes, long long* __restrict__ c_qhash,
    int* __restrict__ c_tau, int* __restrict__ c_ball,
    long long* __restrict__ c_params, int* __restrict__ c_probed,
    float* __restrict__ c_est, int* __restrict__ c_nvis,
    const int* __restrict__ qcodes, const long long* __restrict__ qhash,
    const int* __restrict__ tau, const int* __restrict__ balls,
    const long long* __restrict__ params_epoch,
    const float* __restrict__ ests, const int* __restrict__ nvis,
    const int* __restrict__ probed, const int* __restrict__ slot_of,
    const int* __restrict__ writer, int n, int nl, int lk) {
  const int i = blockIdx.x * WRITE_WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (i >= n) return;
  const int slot = slot_of[i];
  if (slot < 0 || writer[slot] != i) return;   // inactive, or a later lane
                                               // wrote this slot
  for (int j = lane; j < lk; j += 32)
    c_qcodes[(size_t)slot * lk + j] = qcodes[(size_t)i * lk + j];
  for (int j = lane; j < nl; j += 32) {
    c_ball[(size_t)slot * nl + j] = balls[(size_t)i * nl + j];
    c_probed[(size_t)slot * nl + j] = probed[(size_t)i * nl + j];
  }
  if (lane < 2) c_qhash[2 * (size_t)slot + lane] = qhash[2 * (size_t)i + lane];
  if (lane == 0) {
    c_tau[slot] = tau[i];
    c_params[slot] = *params_epoch;
    c_est[slot] = ests[i];
    c_nvis[slot] = nvis[i];
  }
}

}  // namespace

// scratch: int32 lane ids (n rounded up to 4), entry ids (s rounded up to
// 8), each lane's slot (n), each slot's last writer (s), the candidates
// (n); `threads`, `smem` and `cand_shared` are ops.cache_insert_plan's.
extern "C" int cache_insert(int* c_qcodes, long long* c_qhash, int* c_tau,
                            int* c_ball, long long* c_params, int* c_probed,
                            float* c_est, int* c_nvis, unsigned char* c_valid,
                            unsigned char* c_ref, int* c_hand,
                            const int* qcodes, const long long* qhash,
                            const int* tau, const int* balls,
                            const long long* params_epoch, const float* ests,
                            const int* nvis, const int* probed,
                            const unsigned char* active, int* n_evicted,
                            int* scratch, int s, int n, int nl, int lk,
                            int match_qhash, int threads, int smem,
                            int cand_shared, void* stream) {
  if (s < 1 || s > 65536 || n < 1 || n > 65536 || nl < 1 || lk < 1 ||
      threads < 32 || threads > 1024 || (threads & (threads - 1)) ||
      smem < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  int* cid = scratch;
  int* eid = cid + ((n + 3) & ~3);      // 16-byte aligned: read as int4
  int* slot_of = eid + ((s + 7) & ~7);
  int* writer = slot_of + n;
  unsigned* cand = reinterpret_cast<unsigned*>(writer + s);
  cache_insert_keys_kernel<<<(n + s + KEY_THREADS - 1) / KEY_THREADS,
                             KEY_THREADS, 0, st>>>(
      c_qcodes, c_qhash, c_tau, c_valid, qcodes, qhash, tau, active, cid,
      eid, writer, s, n, lk, match_qhash);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(cache_insert_chain_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  cache_insert_chain_kernel<<<1, threads, smem, st>>>(
      cid, eid, c_valid, c_ref, c_hand, slot_of, writer, cand, n_evicted, s,
      n, cand_shared);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cache_insert_write_kernel<<<(n + WRITE_WARPS - 1) / WRITE_WARPS,
                              WRITE_WARPS * 32, 0, st>>>(
      c_qcodes, c_qhash, c_tau, c_ball, c_params, c_probed, c_est, c_nvis,
      qcodes, qhash, tau, balls, params_epoch, ests, nvis, probed, slot_of,
      writer, n, nl, lk);
  return (int)cudaGetLastError();
}
