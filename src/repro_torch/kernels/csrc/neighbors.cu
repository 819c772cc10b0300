// The bucket-neighbor table of paper §4.7: out[i, j] = sum_k [codes[i, k] !=
// codes[j, k]] as int8 where i, j < n_valid and 0 < d <= max_dist, else 0,
// written for every (i, j) with i or j in the row range [r0, r1): the whole
// (B, B) table for Alg. 6 (r0 = 0, r1 = B), and for Alg. 9 the row strip of
// the new codes plus its symmetric column strip, leaving every other entry
// of `out` as it was.
//
// Replaces: src/repro/core/neighbors.py, _pairwise_hamming and the masks of
// build / update (jnp, no pallas_call). It is the all-pairs form of the
// reference's hamming kernel (src/repro/kernels/hamming.py, function
// hamming: one (B, K) compare-reduce against one code), which the reference
// computes as one (B, B, K) compare for the table.
//
// What bounds it on an H100: bytes. At B = 8,192 rows it writes the 64 MiB
// table once (0.020 ms at 3.35 TB/s) and reads the codes (0.3 MB); the
// live rows' n_valid^2 K code compares (1.8e8 and 3.4e8 for the two tables
// of the 1M state) are of the same order at the SMs' INT32 issue rate.
//
// Design: a tiled all-pairs kernel over a 1-D grid of output tiles of TR
// rows x TC columns: first the tiles of rows [r0, r1) x columns [0, B),
// then, for an Alg. 9 strip, those of rows [0, B) x columns [r0, r1) (the
// new-by-new block is written twice, with equal values). A block stages the
// tile's row codes and, transposed to [k][column] with a pitch of TC + 1
// words, its column codes in shared memory. Thread (ty, tx) counts rows ty
// and ty + 16 against columns tx + 16 e (e < 16): at each k a warp reads 16
// consecutive column codes, distinct banks, once for both rows, and each
// row code is a broadcast. The masked int8 results go to a shared tile,
// and the block stores it as 16-byte pieces, 16 threads to a row: one
// coalesced 256-byte segment a row. A piece that straddles the edge of its
// rectangle, or a table whose rows are not 16-byte aligned, is stored byte
// by byte under the rectangle's mask. A tile whose rows or columns all lie
// at or past n_valid is stored as zeros without staging or counting: at
// the 1M state's 4,281 and 5,812 live buckets of 8,192 rows, 73 % and 50 %
// of the pairs.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TR = 32;         // rows of a tile
constexpr int TC = 256;        // columns of a tile
constexpr int THREADS = 256;   // 16 row pairs x 16 column lanes
constexpr int KMAX = 32;
constexpr int CP = TC + 1;     // column-code pitch: staging stores and the
                               // count's reads both hit distinct banks

struct Rect {
  int r_lo, r_hi, c_lo, c_hi;  // rows [r_lo, r_hi) x columns [c_lo, c_hi)
  int c_base;                  // first column of the rectangle's tiles
  int col_tiles;
};

__device__ __forceinline__ void tile_of(const Rect& rc, int t, int* row0,
                                        int* col0) {
  *row0 = rc.r_lo + (t / rc.col_tiles) * TR;
  *col0 = rc.c_base + (t % rc.col_tiles) * TC;
}

// The tile's masked counts into the shared int8 `tile` (TR x TC).
__device__ __forceinline__ void count_tile(const int* __restrict__ codes,
                                           int8_t* tile, int* colc,
                                           int* rowc, int b, int k,
                                           int n_valid, int max_dist,
                                           int row0, int col0) {
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  for (int i = tid; i < TC * k; i += THREADS) {
    const int c = i / k, kk = i - c * k;
    const int col = col0 + c;
    colc[kk * CP + c] = col < b ? codes[(int64_t)col * k + kk] : 0;
  }
  for (int i = tid; i < TR * k; i += THREADS) {
    const int r = i / k, kk = i - r * k;
    const int row = row0 + r;
    rowc[r * KMAX + kk] = row < b ? codes[(int64_t)row * k + kk] : 0;
  }
  __syncthreads();

  int acc0[16], acc1[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) acc0[e] = acc1[e] = 0;
  for (int kk = 0; kk < k; ++kk) {
    const int a0 = rowc[ty * KMAX + kk];
    const int a1 = rowc[(ty + 16) * KMAX + kk];
    const int* cc = colc + kk * CP + tx;
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int c = cc[16 * e];
      acc0[e] += c != a0;
      acc1[e] += c != a1;
    }
  }
  const bool v0 = row0 + ty < n_valid, v1 = row0 + ty + 16 < n_valid;
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    const bool vc = col0 + tx + 16 * e < n_valid;
    const int d0 = acc0[e], d1 = acc1[e];
    tile[ty * TC + tx + 16 * e] =
        (int8_t)(v0 && vc && d0 > 0 && d0 <= max_dist ? d0 : 0);
    tile[(ty + 16) * TC + tx + 16 * e] =
        (int8_t)(v1 && vc && d1 > 0 && d1 <= max_dist ? d1 : 0);
  }
}

__global__ void __launch_bounds__(THREADS) neighbor_dists_kernel(
    const int* __restrict__ codes, int8_t* __restrict__ out, int b, int k,
    int n_valid, int max_dist, Rect ra, int tiles_a, Rect rb, int aligned) {
  __shared__ int colc[KMAX * CP];
  __shared__ int rowc[TR * KMAX];
  __shared__ __align__(16) int8_t tile[TR * TC];

  const int tid = threadIdx.x;
  const bool in_a = (int)blockIdx.x < tiles_a;
  const Rect rc = in_a ? ra : rb;
  int row0, col0;
  tile_of(rc, (int)blockIdx.x - (in_a ? 0 : tiles_a), &row0, &col0);
  // a tile with no live row or no live column is all zeros: nothing to
  // count (block-uniform, so the barriers inside are reached by all)
  const bool live = row0 < n_valid && col0 < n_valid;
  if (live)
    count_tile(codes, tile, colc, rowc, b, k, n_valid, max_dist, row0, col0);
  __syncthreads();

  // TR x TC bytes = 512 pieces of 16 bytes, two a thread
  for (int p = tid; p < TR * (TC / 16); p += THREADS) {
    const int r = p >> 4, piece = p & 15;
    const int row = row0 + r;
    if (row < rc.r_lo || row >= rc.r_hi) continue;
    const int col = col0 + piece * 16;
    int8_t* dst = out + (int64_t)row * b + col;
    const int8_t* src = tile + r * TC + piece * 16;
    if (aligned && col >= rc.c_lo && col + 16 <= rc.c_hi) {
      *reinterpret_cast<uint4*>(dst) =
          live ? *reinterpret_cast<const uint4*>(src) : make_uint4(0, 0, 0, 0);
    } else {
      for (int j = 0; j < 16; ++j) {
        const int cj = col + j;
        if (cj >= rc.c_lo && cj < rc.c_hi) dst[j] = live ? src[j] : 0;
      }
    }
  }
}

Rect make_rect(int r_lo, int r_hi, int c_lo, int c_hi) {
  Rect rc;
  rc.r_lo = r_lo;
  rc.r_hi = r_hi;
  rc.c_lo = c_lo;
  rc.c_hi = c_hi;
  rc.c_base = c_lo & ~15;
  rc.col_tiles = (c_hi - rc.c_base + TC - 1) / TC;
  return rc;
}

int64_t tiles_of(const Rect& rc) {
  if (rc.r_hi <= rc.r_lo || rc.c_hi <= rc.c_lo) return 0;
  return (int64_t)((rc.r_hi - rc.r_lo + TR - 1) / TR) * rc.col_tiles;
}

}  // namespace

// codes (b, k) int32, out (b, b) int8; writes out[i, j] for i or j in
// [r0, r1). `aligned`: b % 16 == 0 and out 16-byte aligned.
extern "C" int neighbor_dists_i8(const int* codes, int8_t* out, int b, int k,
                                 int n_valid, int max_dist, int r0, int r1,
                                 int aligned, void* stream) {
  if (b < 1 || k < 1 || k > KMAX || r0 < 0 || r1 > b || r0 > r1 ||
      max_dist < 0 || max_dist > 127)
    return (int)cudaErrorInvalidValue;
  const Rect ra = make_rect(r0, r1, 0, b);
  // the column strip, unless the row strip already covers every row
  const bool strip = r0 > 0 || r1 < b;
  const Rect rb = strip ? make_rect(0, b, r0, r1) : make_rect(0, 0, 0, 0);
  const int64_t ta = tiles_of(ra), tb = strip ? tiles_of(rb) : 0;
  if (ta + tb == 0) return (int)cudaSuccess;
  if (ta + tb > 0x7fffffff) return (int)cudaErrorInvalidValue;
  neighbor_dists_kernel<<<(unsigned)(ta + tb), THREADS, 0,
                          (cudaStream_t)stream>>>(codes, out, b, k, n_valid,
                                                  max_dist, ra, (int)ta, rb,
                                                  aligned);
  return (int)cudaGetLastError();
}
