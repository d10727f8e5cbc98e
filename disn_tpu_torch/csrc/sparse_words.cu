// K5: record words and change bits of the active 4^3 blocks, straight from
// the fine pass's rows, on Hopper (sm_90a).
//
// Replaces disn_tpu/ops/marching.py::_sparse_cell_words (XLA code written
// for the TPU, in [NK, 64] lane form). For each active coarse cell (a 4^3
// block of fine cells) and each of its 64 fine cells, lane l = (z*4+y)*4+x:
//   - the values at the fine cell's 8 corners: its own row at offset 0;
//     at the 7 offsets of the owned edges the row of the cell itself, or of
//     its active "+1" neighbour that holds the point, else the coarse
//     trilinear of the cell's 8 coarse corners, lerped along z, then y,
//     then x as lo*(1-w) + hi*w with every product and sum rounded (the
//     dense volume's sparse._upsample_aligned, so each value equals the
//     volume's bit for bit);
//   - the inside mask (8 bits) and each owned edge's parameter
//     t = (iso - v0) / (vj - v0), 0.5 where |vj - v0| <= 1e-12, clamped to
//     [0, 1], times 255 (grids with R - 1 >= 128) or 65535, rounded half to
//     even, packed into 2 (u8) or 4 (u16) int32 words;
//   - the change bit (corner signs disagree), 64 a block, as (lo, hi);
//   - the own-slot table (each active coarse cell's row slot, -1
//     elsewhere), and the guard: term (1), coarse cells whose corner signs
//     disagree but that are not active; term (2), lanes on a low face whose
//     own value and coarse lerp differ in sign while a "-1" neighbour that
//     reads them is not active.
//
// The count of valid cells comes by value, or from a 0-d int32 on the card
// (count_dev), which every block reads and clamps to [0, nk]: then no
// launch depends on it, so a caller can queue the step behind the work
// that computes the count without waiting for it (the speculative
// dispatch decodes a padded bucket of cells and passes the true count).
//
// The whole step is one host call, sparse_words_step, on the caller's
// stream: a memset of own_tbl to -1; the own-slot scatter, which also zeroes
// the guard; then one grid of two kinds of blocks. Words blocks take a cell
// a warp. Zero blocks walk the (c+1)^3 block grid: they zero bits and cand
// where no active cell writes them (inactive cells, the ghost layer) and
// count guard term (1). Every entry of bits and cand has one writer, and
// both kinds only read own_tbl.
//
// What bounds it on the H100 (3.35 TB/s): bytes. It reads each row once
// (NK*64*4 B) and writes 2 or 4 words a lane (8 or 16 B), bits, cand and
// own_tbl: ~18 MB at the main path's 17,888 active cells at 257^3, 5.5 us.
// Above that the step pays its three launches, the dependent chain cell id
// -> own-slot table -> a neighbour's row, and 7 IEEE divides a lane.
// What the design does about it: no PyTorch op and no barrier wider than a
// warp in a words block. Per cell, 8 lanes load the 8 coarse corners and
// the 8 row slots (own and "+1" neighbours) into shared memory once, 7 more
// the "-1" coverage flags (one ballot), and the warp builds the cell's 5^3
// corner patch once: a point's value is the row of the cell that holds it
// when that cell is active, else the coarse lerp. Each lane (two fine
// lanes a thread) then reads its 7 far corners from the patch. Rows are
// read and words written coalesced. The change bits are one __ballot_sync
// a half cell, written by the warp's lane 0 alone. Each guard term is a
// ballot count a warp and an integer atomicAdd where it is not 0: exact in
// any order. Where every "-1" neighbour is covered, term (2) is 0 and no
// lane computes its lerp.
//
// Rounding: every lerp and the edge parameter use __fmul_rn / __fadd_rn /
// __fsub_rn / __fdiv_rn, so nvcc cannot contract them into FMAs or replace
// the divide; rintf rounds half to even as torch.round does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 64;                 // fine cells a coarse cell
constexpr int THREADS = 256;
constexpr int CELLS = THREADS / 32;       // cells a words block: one a warp
constexpr int ZERO_IDS = 4 * THREADS;     // block ids a zero block
constexpr int PATCH = 5 * 5 * 5;          // corner points of a 4^3 block

// (x, y, z) offsets of the owned edges' far corners, corners 1..7 of the
// marching tables (ops/marching.CORNERS; the wrapper checks the order)
__constant__ int kOff[7][3] = {{1, 0, 0}, {1, 1, 0}, {0, 1, 0}, {0, 0, 1},
                               {1, 0, 1}, {1, 1, 1}, {0, 1, 1}};
// the "-1" directions (x, y, z) of ops/marching._LOW_DIRS: x, y, z, xy, xz,
// yz, xyz
__constant__ int kLow[7][3] = {{1, 0, 0}, {0, 1, 0}, {0, 0, 1}, {1, 1, 0},
                               {1, 0, 1}, {0, 1, 1}, {1, 1, 1}};

__device__ __forceinline__ float lerp1(float lo, float hi, float w) {
  return __fadd_rn(__fmul_rn(lo, __fsub_rn(1.f, w)), __fmul_rn(hi, w));
}

// the coarse trilinear at fine offset (tx, ty, tz) in [0, 4] of the cell
// whose corners are cv[dz*4 + dy*2 + dx]
__device__ __forceinline__ float coarse_lerp(const float* cv, int tx, int ty,
                                             int tz) {
  const float wx = tx * 0.25f, wy = ty * 0.25f, wz = tz * 0.25f;
  float ay[2];
#pragma unroll
  for (int dx = 0; dx < 2; dx++) {
    const float a0 = lerp1(cv[dx], cv[4 + dx], wz);          // dy = 0
    const float a1 = lerp1(cv[2 + dx], cv[6 + dx], wz);      // dy = 1
    ay[dx] = lerp1(a0, a1, wy);
  }
  return lerp1(ay[0], ay[1], wx);
}

// the valid cells: *count_dev clamped to [0, nk], or `count` without it
__device__ __forceinline__ int live_count(const int* count_dev, int count,
                                          int nk) {
  return count_dev ? min(max(*count_dev, 0), nk) : count;
}

// adds the warp's count of `flag` to *guard; every lane of the warp calls it
__device__ __forceinline__ void warp_count(bool flag, int* guard) {
  const int n = __popc(__ballot_sync(0xffffffffu, flag));
  if ((threadIdx.x & 31) == 0 && n) atomicAdd(guard, n);
}

// own_tbl[cell_ids[i]] = i for the valid cells (own_tbl is -1 before);
// zeroes the guard for the grid that follows
__global__ void own_scatter(const int* __restrict__ cell_ids,
                            const int* __restrict__ count_dev, int count,
                            int nk, int* __restrict__ own_tbl,
                            int* __restrict__ guard) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i == 0) *guard = 0;
  if (i < live_count(count_dev, count, nk)) own_tbl[cell_ids[i]] = i;
}

// A zero block: block ids [base, base + ZERO_IDS) of the (c+1)^3 grid.
// Where no active cell writes bits and cand, zero them; an inactive cell of
// the c^3 grid whose 8 coarse corner signs disagree counts in guard term
// (1) (ops/marching._coarse_guard).
__device__ void zero_block(const float* __restrict__ vol_c,
                           const int* __restrict__ own_tbl, int c, float iso,
                           int base, int* __restrict__ bits,
                           uint8_t* __restrict__ cand, int* guard) {
  const int rc = c + 1, b3 = rc * rc * rc;
#pragma unroll
  for (int i = 0; i < ZERO_IDS / THREADS; i++) {
    const int id = base + i * THREADS + threadIdx.x;
    bool bad = false;
    if (id < b3) {
      const int z = id / (rc * rc), y = (id / rc) % rc, x = id % rc;
      const bool inner = z < c && y < c && x < c;
      if (!inner || own_tbl[(z * c + y) * c + x] < 0) {
        reinterpret_cast<int2*>(bits)[id] = make_int2(0, 0);
        cand[id] = 0;
        if (inner) {
          bool any = false, all = true;
#pragma unroll
          for (int k = 0; k < 8; k++) {
            const bool in = vol_c[((z + (k >> 2)) * rc + y + ((k >> 1) & 1))
                                  * rc + x + (k & 1)] < iso;
            any |= in;
            all &= in;
          }
          bad = any && !all;
        }
      }
    }
    warp_count(bad, guard);
  }
}

// Fine lane l's words, from its own value v0 and its cell's corner patch
// (point (x, y, z) at (z*5 + y)*5 + x), written at g, g + n, ...; returns
// its inside mask.
__device__ __forceinline__ uint32_t lane_words(const float* patch, int l,
                                               float v0, float iso, int u8,
                                               size_t n, size_t g,
                                               int* __restrict__ words) {
  const int lx = l & 3, ly = (l >> 2) & 3, lz = l >> 4;
  uint32_t imask = v0 < iso ? 1u : 0u;
  const float scale = u8 ? 255.f : 65535.f;
  uint32_t tq[7];
#pragma unroll
  for (int d = 0; d < 7; d++) {
    const float vj = patch[((lz + kOff[d][2]) * 5 + ly + kOff[d][1]) * 5 +
                           lx + kOff[d][0]];
    imask |= (vj < iso ? 1u : 0u) << (d + 1);
    const float dv = __fsub_rn(vj, v0);
    float t = fabsf(dv) > 1e-12f ? __fdiv_rn(__fsub_rn(iso, v0), dv) : 0.5f;
    t = fminf(fmaxf(t, 0.f), 1.f);
    tq[d] = (uint32_t)(int)rintf(__fmul_rn(t, scale));
  }
  if (u8) {
    words[g] = (int)(tq[0] | (tq[1] << 8) | (tq[2] << 16) | (tq[3] << 24));
    words[n + g] = (int)(tq[4] | (tq[5] << 8) | (tq[6] << 16) | (imask << 24));
  } else {
    words[g] = (int)(tq[0] | (tq[1] << 16));
    words[n + g] = (int)(tq[2] | (tq[3] << 16));
    words[2 * n + g] = (int)(tq[4] | (tq[5] << 16));
    words[3 * n + g] = (int)(tq[6] | (imask << 16));
  }
  return imask;
}

// guard term (2) at fine lane l: on a low face, a "-1" neighbour that reads
// the point is missing (bit d of cov clear: direction kLow[d] neither
// active nor past the grid), and the own value and the coarse lerp there
// differ in sign
__device__ __forceinline__ bool lane_bad(const float* cv, unsigned cov,
                                         int l, float v0, float iso) {
  const int lx = l & 3, ly = (l >> 2) & 3, lz = l >> 4;
  const bool ex = lx == 0, ey = ly == 0, ez = lz == 0;
  const auto miss = [cov](int d) { return ((cov >> d) & 1u) == 0u; };
  const bool badx = ex && (miss(0) || (ey && miss(3)) || (ez && miss(4)) ||
                           (ey && ez && miss(6)));
  const bool bady = ey && (miss(1) || (ex && miss(3)) || (ez && miss(5)) ||
                           (ex && ez && miss(6)));
  const bool badz = ez && (miss(2) || (ex && miss(4)) || (ey && miss(5)) ||
                           (ex && ey && miss(6)));
  return (badx || bady || badz) &&
         (v0 < iso) != (coarse_lerp(cv, lx, ly, lz) < iso);
}

__global__ void __launch_bounds__(THREADS)
sparse_words_grid(const float* __restrict__ rows,
                  const int* __restrict__ cell_ids, int nk,
                  const int* __restrict__ count_dev, int count_arg,
                  const float* __restrict__ vol_c,
                  const int* __restrict__ own_tbl, int c, float iso, int u8,
                  int word_blocks, int* __restrict__ words,
                  int* __restrict__ bits, uint8_t* __restrict__ cand,
                  int* __restrict__ guard) {
  if ((int)blockIdx.x >= word_blocks) {  // uniform across the block
    zero_block(vol_c, own_tbl, c, iso, (blockIdx.x - word_blocks) * ZERO_IDS,
               bits, cand, guard);
    return;
  }
  __shared__ float s_patch[CELLS][PATCH];
  __shared__ float s_cv[CELLS][8];
  __shared__ int s_slot[CELLS][8];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cell = blockIdx.x * CELLS + w;
  if (cell >= nk) return;  // the whole warp
  const int count = live_count(count_dev, count_arg, nk);
  const bool valid = cell < count;
  const int gid = valid ? cell_ids[cell] : 0;
  const int cz = gid / (c * c), cy = (gid / c) % c, cx = gid % c;
  const size_t g = (size_t)cell * LANES + lane;  // fine lanes lane, +32
  const float v0[2] = {rows[g], rows[g + 32]};

  // the cell's header: lanes 0-7 its coarse corners and the row slots of
  // the cells holding its "+1" corners (k = dz*4 + dy*2 + dx; k = 0 is the
  // cell itself; -1 where inactive, past the grid, or the cell is padding),
  // lanes 8-14 whether each "-1" neighbour is active or past the grid
  bool covered = false;
  if (lane < 8) {
    const int z = cz + (lane >> 2), y = cy + ((lane >> 1) & 1),
              x = cx + (lane & 1);
    s_cv[w][lane] = vol_c[(z * (c + 1) + y) * (c + 1) + x];
    int slot = -1;
    if (valid)
      slot = lane == 0 ? cell
             : (z < c && y < c && x < c) ? own_tbl[(z * c + y) * c + x]
                                         : -1;
    s_slot[w][lane] = slot;
  } else if (lane < 15) {
    const int d = lane - 8;
    const int z = cz - kLow[d][2], y = cy - kLow[d][1], x = cx - kLow[d][0];
    covered = z < 0 || y < 0 || x < 0 || own_tbl[(z * c + y) * c + x] >= 0;
  }
  const unsigned cov = (__ballot_sync(0xffffffffu, covered) >> 8) & 0x7Fu;
  __syncwarp();

  // the 5^3 corner patch, a point a lane at a time
  const float* cv = s_cv[w];
  float* patch = s_patch[w];
  for (int p = lane; p < PATCH; p += 32) {
    const int tz = p / 25, ty = (p / 5) % 5, tx = p % 5;
    const int slot = s_slot[w][(tz >> 2) * 4 + (ty >> 2) * 2 + (tx >> 2)];
    patch[p] = slot >= 0 ? rows[(size_t)slot * LANES + ((tz & 3) << 4) +
                                ((ty & 3) << 2) + (tx & 3)]
                         : coarse_lerp(cv, tx, ty, tz);
  }
  __syncwarp();

  const size_t n = (size_t)nk * LANES;
  unsigned mask[2];
  int nbad = 0;
#pragma unroll
  for (int h = 0; h < 2; h++) {
    const int l = lane + 32 * h;
    const uint32_t imask = lane_words(patch, l, v0[h], iso, u8, n, g + 32 * h,
                                      words);
    mask[h] = __ballot_sync(0xffffffffu,
                            valid && imask != 0u && imask != 0xFFu);
    if (valid && cov != 0x7Fu)  // uniform across the warp
      nbad += __popc(__ballot_sync(0xffffffffu,
                                   lane_bad(cv, cov, l, v0[h], iso)));
  }
  if (valid && lane == 0) {
    const int b3id = (cz * (c + 1) + cy) * (c + 1) + cx;
    bits[b3id * 2] = (int)mask[0];
    bits[b3id * 2 + 1] = (int)mask[1];
    cand[b3id] = 1;
    if (nbad) atomicAdd(guard, nbad);
  }
}

}  // namespace

// One K5 step on `stream`. rows [nk*64] f32, cell_ids [nk] i32 (the first
// `count` valid: distinct cells of [0, c^3); with count_dev not null, the
// first *count_dev clamped to [0, nk], read on the card), vol_c [c+1]^3
// f32; outputs
// words [2|4, nk*64] i32, bits [(c+1)^3, 2] i32, cand [(c+1)^3] u8,
// own_tbl [c^3] i32 and guard [1] i32, allocated by the caller and all
// written here. Returns the first CUDA error code (0 on success).
extern "C" int sparse_words_step(const float* rows, const int* cell_ids,
                                 int nk, int count, const int* count_dev,
                                 const float* vol_c,
                                 int c, float iso, int u8, int* words,
                                 int* bits, uint8_t* cand, int* own_tbl,
                                 int* guard, cudaStream_t stream) {
  const size_t c3 = (size_t)c * c * c;
  const long long b3 = (long long)(c + 1) * (c + 1) * (c + 1);
  cudaError_t err =
      cudaMemsetAsync(own_tbl, 0xFF, c3 * sizeof(int), stream);
  if (err) return (int)err;
  const int span = count_dev ? nk : count;  // the most cells that count
  const int scatter_blocks = span > 0 ? (span + THREADS - 1) / THREADS : 1;
  own_scatter<<<scatter_blocks, THREADS, 0, stream>>>(
      cell_ids, count_dev, count, nk, own_tbl, guard);
  err = cudaGetLastError();
  if (err) return (int)err;
  const int word_blocks = (nk + CELLS - 1) / CELLS;
  const int zero_blocks = (int)((b3 + ZERO_IDS - 1) / ZERO_IDS);
  sparse_words_grid<<<word_blocks + zero_blocks, THREADS, 0, stream>>>(
      rows, cell_ids, nk, count_dev, count, vol_c, own_tbl, c, iso, u8,
      word_blocks, words, bits, cand, guard);
  return (int)cudaGetLastError();
}
