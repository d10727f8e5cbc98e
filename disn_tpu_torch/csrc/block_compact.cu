// K2c: the block compaction both mesh flows end their scan in, on Hopper
// (sm_90a).
//
// Replaces disn_tpu/ops/marching.py::_compact_block_bits (:694), XLA code
// the JAX package wrote for the TPU (a cumsum over the blocks, a scatter of
// their ids, a gather of their bits, 64 shifts a row, a second cumsum over
// every slot and a scatter of the cell ids; ~30 small ops in the port's
// plain version, ops/marching._compact_block_bits_plain). Over the grid of
// 4^3-cell blocks, B3^3 of them, each with 64 change bits (lo, hi):
//   - sel = cand & (bits != 0), the blocks kept in block order (at most
//     cap_b of them: the capped form's b2, or all of them);
//   - blk [cap_b, 3] rows (block id, lo, hi) of the kept blocks;
//   - ids: each kept block's set bits in bit order, at the offset of the
//     popcounts of the selected blocks before it: flat cell ids
//     ((bz*4 + l/16)*E + by*4 + (l/4)%4)*E + bx*4 + l%4 over E^3, or, with
//     srow (the sparse-words flow), srow[coarse cell]*64 + l;
//   - the capped form also pads (zero ids past n, zero rows past the kept
//     blocks) and writes n (the kept blocks' bits) and g_over (the
//     selected blocks past cap_b plus the caller's guard) on the card.
// Bit for bit the plain version: integers only, in the plain version's
// order (nonzero's row-major order of blocks, then of bits).
//
// What bounds it on the H100 (3.35 TB/s): bytes, and in practice launch
// latency. It must read bits and cand (9 B a block: 2.5 MB at 257^3,
// 0.74 us) and srow, and write the ids and the rows; the capped form's
// padded buffers are written whole. What the design does about it: one
// block row a thread, 1,024-row tiles in block order, three launches.
//   bc_count   each tile's selected blocks (__syncthreads_count) and
//              their popcount;
//   bc_write   every tile sums the counts of the tiles before it, ranks its
//              selected blocks (a ballot and the warps' counts) and their
//              bits (a warp scan of the popcounts and the warps' sums),
//              and a thread writes its block's row and its set bits' ids
//              (one __ffs a bit); the capped form adds the tile's kept
//              bits;
//   bc_finish  (capped form) every block sums the tiles' kept bits to n,
//              zeroes its share of the padding, and block 0 writes n and
//              g_over.
// The exact form reads the tiles' counts back once (the caller sizes ids
// [n] and blk [b, 3] from them) between bc_count and bc_write; the capped
// form waits for nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 1024;  // block rows a tile, one a thread

__device__ int block_sum(int x, int* red) {
  for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(~0u, x, o);
  const int warp = threadIdx.x >> 5;
  __syncthreads();  // red may still be read by a previous sum
  if ((threadIdx.x & 31) == 0) red[warp] = x;
  __syncthreads();
  x = 0;
  for (int w = 0; w < TILE / 32; ++w) x += red[w];
  return x;
}

struct Row {
  int i;  // block id
  unsigned lo, hi;
  bool sel;
  int pc;  // its change bits when selected, else 0
};

__device__ __forceinline__ Row read_row(const int* __restrict__ bits,
                                        const uint8_t* __restrict__ cand,
                                        int nb) {
  Row r;
  r.i = blockIdx.x * TILE + threadIdx.x;
  r.lo = r.hi = 0;
  r.sel = false;
  r.pc = 0;
  if (r.i < nb) {
    r.lo = (unsigned)bits[2 * r.i];
    r.hi = (unsigned)bits[2 * r.i + 1];
    r.sel = cand[r.i] && (r.lo | r.hi);
    r.pc = r.sel ? __popc(r.lo) + __popc(r.hi) : 0;
  }
  return r;
}

__global__ void __launch_bounds__(TILE)
bc_count(const int* __restrict__ bits, const uint8_t* __restrict__ cand,
         int nb, int* __restrict__ tile_b, int* __restrict__ tile_n) {
  __shared__ int red[TILE / 32];
  const Row r = read_row(bits, cand, nb);
  const int b = __syncthreads_count(r.sel);
  const int n = block_sum(r.pc, red);
  if (threadIdx.x == 0) {
    tile_b[blockIdx.x] = b;
    tile_n[blockIdx.x] = n;
  }
}

__global__ void __launch_bounds__(TILE)
bc_write(const int* __restrict__ bits, const uint8_t* __restrict__ cand,
         int nb, int B3, int E, const int* __restrict__ srow,
         const int* __restrict__ tile_b, const int* __restrict__ tile_n,
         int cap_b, int* __restrict__ ids, int* __restrict__ blk,
         int* __restrict__ kept_n) {
  __shared__ int red[TILE / 32];
  __shared__ int warp_b[TILE / 32], warp_n[TILE / 32];
  int pre_b = 0, pre_n = 0;
  for (int t = threadIdx.x; t < (int)blockIdx.x; t += TILE) {
    pre_b += tile_b[t];
    pre_n += tile_n[t];
  }
  pre_b = block_sum(pre_b, red);
  pre_n = block_sum(pre_n, red);
  const Row r = read_row(bits, cand, nb);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(~0u, r.sel);
  int incl = r.pc;  // inclusive scan of the popcounts in the warp
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(~0u, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) {
    warp_b[warp] = __popc(ballot);
    warp_n[warp] = incl;
  }
  __syncthreads();
  int rank = pre_b + __popc(ballot & ((1u << lane) - 1));
  int off = pre_n + incl - r.pc;
  for (int w = 0; w < warp; ++w) {
    rank += warp_b[w];
    off += warp_n[w];
  }
  const bool kept = r.sel && rank < cap_b;
  if (kept) {
    blk[3 * rank] = r.i;
    blk[3 * rank + 1] = (int)r.lo;
    blk[3 * rank + 2] = (int)r.hi;
    const int bz = r.i / (B3 * B3), by = (r.i / B3) % B3, bx = r.i % B3;
    long long base;
    if (srow) {
      // a ghost block (coordinate c) holds no bit in this flow; the clamp
      // keeps its arithmetic in range, as the plain version's does
      const int c = B3 - 1;
      const int cid =
          (min(bz, c - 1) * c + min(by, c - 1)) * c + min(bx, c - 1);
      base = (long long)max(srow[cid], 0) * 64;
    } else {
      base = ((long long)(bz * 4) * E + by * 4) * E + bx * 4;
    }
    int k = off;
    for (int half = 0; half < 2; ++half) {
      unsigned m = half ? r.hi : r.lo;
      while (m) {
        const int l = (__ffs(m) - 1) + 32 * half;
        m &= m - 1;
        const long long loff =
            srow ? l
                 : ((long long)(l >> 4) * E + ((l >> 2) & 3)) * E + (l & 3);
        ids[k++] = (int)(base + loff);
      }
    }
  }
  if (kept_n) {
    const int kn = block_sum(kept ? r.pc : 0, red);
    if (threadIdx.x == 0) kept_n[blockIdx.x] = kn;
  }
}

__global__ void __launch_bounds__(TILE)
bc_finish(const int* __restrict__ tile_b, const int* __restrict__ kept_n,
          int tiles, int cap_b, const int* __restrict__ guard,
          int* __restrict__ ids, int* __restrict__ blk,
          int* __restrict__ n_out, int* __restrict__ gov_out) {
  __shared__ int red[TILE / 32];
  int b = 0, n = 0;
  for (int t = threadIdx.x; t < tiles; t += TILE) {
    b += tile_b[t];
    n += kept_n[t];
  }
  b = block_sum(b, red);
  n = block_sum(n, red);
  const long long stride = (long long)gridDim.x * TILE;
  const long long first = (long long)blockIdx.x * TILE + threadIdx.x;
  for (long long r = min(b, cap_b) + first; r < cap_b; r += stride) {
    blk[3 * r] = 0;
    blk[3 * r + 1] = 0;
    blk[3 * r + 2] = 0;
  }
  for (long long s = n + first; s < (long long)cap_b * 64; s += stride)
    ids[s] = 0;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *n_out = n;
    *gov_out = max(b - cap_b, 0) + (guard ? *guard : 0);
  }
}

}  // namespace

// Tiles of nb block rows; the tile scratch holds 3 ints a tile (selected
// blocks, their bits, the kept bits).
extern "C" int compact_tiles(int nb) { return (nb + TILE - 1) / TILE; }

// bc_count: tile_b = scratch[0, tiles), tile_n = scratch[tiles, 2 tiles).
extern "C" int compact_count(const int* bits, const uint8_t* cand, int nb,
                             int* scratch, cudaStream_t stream) {
  const int tiles = compact_tiles(nb);
  bc_count<<<tiles, TILE, 0, stream>>>(bits, cand, nb, scratch,
                                       scratch + tiles);
  return (int)cudaGetLastError();
}

// bc_write of every selected block (the exact form: ids [n], blk [b, 3],
// sized from compact_count's tiles).
extern "C" int compact_write(const int* bits, const uint8_t* cand, int nb,
                             int B3, int E, const int* srow,
                             const int* scratch, int b, int* ids, int* blk,
                             cudaStream_t stream) {
  const int tiles = compact_tiles(nb);
  bc_write<<<tiles, TILE, 0, stream>>>(bits, cand, nb, B3, E, srow, scratch,
                                       scratch + tiles, b, ids, blk, nullptr);
  return (int)cudaGetLastError();
}

// The capped form, with nothing read back: ids [cap_b*64], blk [cap_b, 3],
// out [2] = (n, g_over); g_over adds *guard when it is not null.
extern "C" int compact_capped(const int* bits, const uint8_t* cand, int nb,
                              int B3, int E, const int* srow, int cap_b,
                              const int* guard, int* scratch, int* ids,
                              int* blk, int* out, cudaStream_t stream) {
  const int tiles = compact_tiles(nb);
  int err = compact_count(bits, cand, nb, scratch, stream);
  if (err) return err;
  bc_write<<<tiles, TILE, 0, stream>>>(bits, cand, nb, B3, E, srow, scratch,
                                       scratch + tiles, cap_b, ids, blk,
                                       scratch + 2 * tiles);
  cudaError_t e = cudaGetLastError();
  if (e) return (int)e;
  long long slots = (long long)cap_b * 64;
  int grid = (int)((slots + 8LL * TILE - 1) / (8LL * TILE));
  grid = grid < 1 ? 1 : grid;
  bc_finish<<<grid, TILE, 0, stream>>>(scratch, scratch + 2 * tiles, tiles,
                                       cap_b, guard, ids, blk, out, out + 1);
  return (int)cudaGetLastError();
}
