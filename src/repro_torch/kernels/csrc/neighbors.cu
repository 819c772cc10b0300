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
// table once (0.020 ms at 3.35 TB/s) and reads the codes (0.3 MB). Counted
// once a pair (the table is symmetric), the live rows' n_valid (n_valid +
// 1) / 2 K code compares (0.9e8 and 1.7e8 for the two tables of the 1M
// state) take two INT32 instructions each, 11 and 20 us at the SMs' INT32
// issue rate, which the stores of other blocks overlap.
//
// Design: one launch over a 1-D grid of two kinds of 256-thread blocks,
// interleaved evenly so that counting and pure stores share the card.
//  - Tile blocks count a 64 x 64 tile: codes staged in shared memory as
//    [k][row] (16-byte rows), each thread a 4 x 4 block of pairs from two
//    16-byte loads a k. The masked int8 results go to shared memory twice,
//    as the tile and as its transpose, and each is stored as 16-byte pieces,
//    four threads to a 64-byte row segment. For the whole table the tiles
//    are the live square's upper triangle (I <= J): tile (I, J) is stored at
//    (I, J) and, transposed, at (J, I). For an Alg. 9 strip they are the
//    new rows' tiles against every column tile: each is stored in the row
//    strip and, transposed, in the column strip (the new-by-new block gets
//    the same values twice); a tile with no live row or column is stored as
//    zeros without counting.
//  - Fill blocks store the zeros of the whole table's dead region (rows or
//    columns past the live square) as 64 KB of 16-byte stores a block.
// A piece that straddles the edge of its rectangle, a strip column that is
// not 16-byte aligned, or a table whose rows are not 16-byte aligned is
// stored byte by byte.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TS = 64;          // rows and columns of a tile
constexpr int THREADS = 256;    // 16 x 16 threads, a 4 x 4 block each
constexpr int KMAX = 32;
constexpr int CP = TS + 4;      // code pitch in words: [k][row], 16-byte rows
constexpr int VP = TS + 16;     // value pitch in bytes: 16-byte rows
constexpr int FILL_UNITS = THREADS * 16;   // units (16-byte pieces, or bytes
                                           // unaligned) of a fill block

struct Plan {
  int square;        // 1: the whole table (upper triangle + fill)
  int tiles;         // tile blocks
  int side;          // square: live tiles a side; strip: column tiles
  int live;          // square: the live square's side in rows
  long long fill_a;  // fill units of rows [0, live) x columns [live, b)
  long long fill_b;  // fill units of rows [live, b)
  int fill_blocks;
};

// The tile's masked counts, into `tile` (row-major) and `tile_t` (its
// transpose), both TS x VP bytes.
__device__ __forceinline__ void count_tile(const int* __restrict__ codes,
                                           int* rowc, int* colc,
                                           int8_t* tile, int8_t* tile_t,
                                           int b, int k, int n_valid,
                                           int max_dist, int row0, int col0) {
  const int tid = threadIdx.x;
  for (int i = tid; i < TS * k; i += THREADS) {
    const int r = i / k, kk = i - r * k;
    const int row = row0 + r, col = col0 + r;
    rowc[kk * CP + r] = row < b ? codes[(int64_t)row * k + kk] : 0;
    colc[kk * CP + r] = col < b ? codes[(int64_t)col * k + kk] : 0;
  }
  __syncthreads();
  const int tx = tid & 15, ty = tid >> 4;   // columns 4 tx.., rows 4 ty..
  int acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[a][e] = 0;
  for (int kk = 0; kk < k; ++kk) {
    const int4 rv = *reinterpret_cast<const int4*>(rowc + kk * CP + 4 * ty);
    const int4 cv = *reinterpret_cast<const int4*>(colc + kk * CP + 4 * tx);
    const int ra[4] = {rv.x, rv.y, rv.z, rv.w};
    const int ca[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][e] += ra[a] != ca[e];
  }
  uint32_t v[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const bool vr = row0 + 4 * ty + a < n_valid;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = acc[a][e];
      const bool keep = vr && col0 + 4 * tx + e < n_valid && d > 0 &&
                        d <= max_dist;
      v[a][e] = keep ? (uint32_t)d : 0u;
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a)
    *reinterpret_cast<uint32_t*>(tile + (4 * ty + a) * VP + 4 * tx) =
        v[a][0] | v[a][1] << 8 | v[a][2] << 16 | v[a][3] << 24;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    *reinterpret_cast<uint32_t*>(tile_t + (4 * tx + e) * VP + 4 * ty) =
        v[0][e] | v[1][e] << 8 | v[2][e] << 16 | v[3][e] << 24;
}

// Stores a TS x TS shared tile (zeros when `zero`) at rows orow0.. and
// columns ocol0.. of out, the entries with row < rhi and column < chi.
__device__ __forceinline__ void store_tile(int8_t* __restrict__ out,
                                           const int8_t* src, bool zero,
                                           int b, int orow0, int ocol0,
                                           int rhi, int chi, int aligned) {
  const int r = threadIdx.x >> 2, piece = threadIdx.x & 3;
  const int row = orow0 + r, col = ocol0 + 16 * piece;
  if (row >= rhi || col >= chi) return;
  int8_t* dst = out + (int64_t)row * b + col;
  const int8_t* s = src + r * VP + 16 * piece;
  if (aligned && (col & 15) == 0 && col + 16 <= chi) {
    *reinterpret_cast<uint4*>(dst) =
        zero ? make_uint4(0, 0, 0, 0) : *reinterpret_cast<const uint4*>(s);
  } else {
    const int m = min(16, chi - col);
    for (int j = 0; j < m; ++j) dst[j] = zero ? 0 : s[j];
  }
}

// Tile t of the upper triangle, by columns: (I, J) with I <= J.
__device__ __forceinline__ void triangle(int t, int* i, int* j) {
  int jj = (int)((sqrt(8.0 * t + 1.0) - 1.0) * 0.5);
  while ((int64_t)(jj + 1) * (jj + 2) / 2 <= t) ++jj;
  while ((int64_t)jj * (jj + 1) / 2 > t) --jj;
  *j = jj;
  *i = t - (int)((int64_t)jj * (jj + 1) / 2);
}

__device__ void fill_zeros(int8_t* __restrict__ out, const Plan& pl, int f,
                           int b, int aligned) {
  const long long total = pl.fill_a + pl.fill_b;
  const long long end = min(total, (long long)(f + 1) * FILL_UNITS);
  const int wide = aligned ? 16 : 1;
  const unsigned wa = (unsigned)((b - pl.live) / wide);   // units a row of A
  for (long long u = (long long)f * FILL_UNITS + threadIdx.x; u < end;
       u += THREADS) {
    int64_t off;
    if (u < pl.fill_a) {
      const unsigned q = (unsigned)u, row = q / wa;
      off = (int64_t)row * b + pl.live + (int64_t)(q - row * wa) * wide;
    } else {
      off = (int64_t)pl.live * b + (u - pl.fill_a) * wide;
    }
    if (aligned)
      *reinterpret_cast<uint4*>(out + off) = make_uint4(0, 0, 0, 0);
    else
      out[off] = 0;
  }
}

__global__ void __launch_bounds__(THREADS) neighbor_dists_kernel(
    const int* __restrict__ codes, int8_t* __restrict__ out, int b, int k,
    int n_valid, int max_dist, int r0, int r1, Plan pl, int aligned) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* rowc = reinterpret_cast<int*>(smem);
  int* colc = rowc + k * CP;
  int8_t* tile = reinterpret_cast<int8_t*>(colc + k * CP);
  int8_t* tile_t = tile + TS * VP;

  // fill and tile blocks interleaved: block x is fill block f0 when the
  // count of fill blocks up to x steps there
  const long long total = (long long)pl.tiles + pl.fill_blocks;
  const long long x = blockIdx.x;
  const long long f0 = x * pl.fill_blocks / total;
  const long long f1 = (x + 1) * pl.fill_blocks / total;
  if (f1 > f0) {
    fill_zeros(out, pl, (int)f0, b, aligned);
    return;
  }
  const int t = (int)(x - f1);
  int row0, col0, rhi;
  bool mirror;
  if (pl.square) {
    int ti, tj;
    triangle(t, &ti, &tj);
    row0 = ti * TS;
    col0 = tj * TS;
    rhi = min(row0 + TS, b);
    mirror = ti != tj;
  } else {
    row0 = r0 + (t / pl.side) * TS;
    col0 = (t % pl.side) * TS;
    rhi = min(row0 + TS, r1);
    mirror = true;
  }
  const int chi = min(col0 + TS, b);
  // block-uniform, so the barriers inside are reached by all
  const bool live = row0 < n_valid && col0 < n_valid;
  if (live)
    count_tile(codes, rowc, colc, tile, tile_t, b, k, n_valid, max_dist,
               row0, col0);
  __syncthreads();
  store_tile(out, tile, !live, b, row0, col0, rhi, chi, aligned);
  if (mirror) store_tile(out, tile_t, !live, b, col0, row0, chi, rhi, aligned);
}

}  // namespace

// codes (b, k) int32, out (b, b) int8; writes out[i, j] for i or j in
// [r0, r1). The plan's fields come from ops.neighbor_dists_plan; `aligned`:
// b % 16 == 0 and out 16-byte aligned.
extern "C" int neighbor_dists_i8(const int* codes, int8_t* out, int b, int k,
                                 int n_valid, int max_dist, int r0, int r1,
                                 int square, int tiles, int side, int live,
                                 long long fill_a, long long fill_b,
                                 int fill_blocks, int smem, int aligned,
                                 void* stream) {
  if (b < 1 || k < 1 || k > KMAX || r0 < 0 || r1 > b || r0 > r1 ||
      max_dist < 0 || max_dist > 127 || tiles < 0 || fill_blocks < 0 ||
      smem != 2 * k * CP * 4 + 2 * TS * VP)
    return (int)cudaErrorInvalidValue;
  const long long grid = (long long)tiles + fill_blocks;
  if (grid == 0) return (int)cudaSuccess;
  if (grid > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const Plan pl{square, tiles, side, live, fill_a, fill_b, fill_blocks};
  neighbor_dists_kernel<<<(unsigned)grid, THREADS, smem,
                          (cudaStream_t)stream>>>(
      codes, out, b, k, n_valid, max_dist, r0, r1, pl, aligned);
  return (int)cudaGetLastError();
}
