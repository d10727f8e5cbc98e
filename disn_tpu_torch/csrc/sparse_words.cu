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
//   - guard term (2): lanes on a low face whose own value and coarse lerp
//     differ in sign while a "-1" neighbour that reads them is not active.
// Term (1) of the guard, the own-slot table and the zero fill of bits and
// cand are PyTorch ops in the wrapper (ops/sparse_words.py).
//
// What bounds it on the H100 (3.35 TB/s): bytes. It reads each row once
// (NK*64*4 B) and writes 2 or 4 words a lane (8 or 16 B); ~14 MB at the
// main path's 17,888 active cells at 257^3, ~4-5 us. There are ~0.1 kflop
// a lane.
// What the design does about it: one thread a lane, 64 threads a cell (two
// warps), 4 cells a 256-thread block, so the rows are read and the words
// written coalesced. The change bits of a cell are one __ballot_sync a
// warp (lane l of the cell is bit l of (lo, hi)), written by that cell's
// thread alone: no race. Guard term (2) is a ballot count a warp, summed
// in shared memory, one integer atomicAdd a block: exact in any order.
// The coarse corners come from vol_c (1.1 MB at 257^3, in L2) and the
// neighbours' slots from the own-slot table.
//
// Rounding: every lerp and the edge parameter use __fmul_rn / __fadd_rn /
// __fsub_rn / __fdiv_rn, so nvcc cannot contract them into FMAs or replace
// the divide; rintf rounds half to even as torch.round does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 64;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// (x, y, z) offsets of the owned edges' far corners, corners 1..7 of the
// marching tables (ops/marching.CORNERS; the wrapper checks the order)
__constant__ int kOff[7][3] = {{1, 0, 0}, {1, 1, 0}, {0, 1, 0}, {0, 0, 1},
                               {1, 0, 1}, {1, 1, 1}, {0, 1, 1}};

__device__ __forceinline__ float lerp1(float lo, float hi, float w) {
  return __fadd_rn(__fmul_rn(lo, __fsub_rn(1.f, w)), __fmul_rn(hi, w));
}

// the coarse trilinear at fine offset (tx, ty, tz) in [0, 4] of the cell
// whose corners are cv[dz*4 + dy*2 + dx]
__device__ __forceinline__ float coarse_lerp(const float cv[8], int tx,
                                             int ty, int tz) {
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

__global__ void __launch_bounds__(THREADS)
sparse_words_kernel(const float* __restrict__ rows,
                    const int* __restrict__ cell_ids, int nk, int count,
                    const float* __restrict__ vol_c,
                    const int* __restrict__ own_tbl, int c, float iso,
                    int u8, int* __restrict__ words, int* __restrict__ bits,
                    uint8_t* __restrict__ cand, int* __restrict__ guard) {
  __shared__ int warp_guard[WARPS];
  const int g = blockIdx.x * THREADS + threadIdx.x;
  const int cell = g / LANES;
  const int l = g % LANES;
  const bool live = cell < nk;   // a warp lies within one cell: uniform
  const bool valid = cell < count;
  int bad = 0;
  if (live) {
    const int rc = c + 1;
    const int gid = valid ? cell_ids[cell] : 0;
    const int cz = gid / (c * c), cy = (gid / c) % c, cx = gid % c;
    float cv[8];
    int slot[8];
#pragma unroll
    for (int k = 0; k < 8; k++) {
      const int dz = k >> 2, dy = (k >> 1) & 1, dx = k & 1;
      const int z = cz + dz, y = cy + dy, x = cx + dx;
      cv[k] = vol_c[(z * rc + y) * rc + x];
      slot[k] = (z < c && y < c && x < c) ? own_tbl[(z * c + y) * c + x] : -1;
    }
    slot[0] = valid ? cell : -1;
#pragma unroll
    for (int k = 1; k < 8; k++) slot[k] = valid ? slot[k] : -1;

    const int lx = l & 3, ly = (l >> 2) & 3, lz = l >> 4;
    const float v0 = rows[(size_t)cell * LANES + l];
    uint32_t imask = v0 < iso ? 1u : 0u;
    const float scale = u8 ? 255.f : 65535.f;
    uint32_t tq[7];
#pragma unroll
    for (int d = 0; d < 7; d++) {
      const int tx = lx + kOff[d][0], ty = ly + kOff[d][1],
                tz = lz + kOff[d][2];
      const int k = (tz >> 2) * 4 + (ty >> 2) * 2 + (tx >> 2);
      const int sl = ((tz & 3) << 4) | ((ty & 3) << 2) | (tx & 3);
      const float vj = slot[k] >= 0 ? rows[(size_t)slot[k] * LANES + sl]
                                    : coarse_lerp(cv, tx, ty, tz);
      imask |= (vj < iso ? 1u : 0u) << (d + 1);
      const float dv = __fsub_rn(vj, v0);
      float t = fabsf(dv) > 1e-12f ? __fdiv_rn(__fsub_rn(iso, v0), dv) : 0.5f;
      t = fminf(fmaxf(t, 0.f), 1.f);
      tq[d] = (uint32_t)(int)rintf(__fmul_rn(t, scale));
    }
    const size_t n = (size_t)nk * LANES;
    if (u8) {
      words[g] = (int)(tq[0] | (tq[1] << 8) | (tq[2] << 16) | (tq[3] << 24));
      words[n + g] =
          (int)(tq[4] | (tq[5] << 8) | (tq[6] << 16) | (imask << 24));
    } else {
      words[g] = (int)(tq[0] | (tq[1] << 16));
      words[n + g] = (int)(tq[2] | (tq[3] << 16));
      words[2 * n + g] = (int)(tq[4] | (tq[5] << 16));
      words[3 * n + g] = (int)(tq[6] | (imask << 16));
    }

    const bool change = valid && imask != 0u && imask != 0xFFu;
    const unsigned ballot = __ballot_sync(0xffffffffu, change);
    if (valid) {
      const int b3 = c + 1;
      const int b3id = (cz * b3 + cy) * b3 + cx;
      if ((l & 31) == 0) bits[b3id * 2 + (l >> 5)] = (int)ballot;
      if (l == 0) cand[b3id] = 1;
    }

    // guard term (2): is each "-1" neighbour active or past the grid?
    // bits x, y, z, xy, xz, yz, xyz as ops/marching._LOW_DIRS
    const int mdir[7][3] = {{1, 0, 0}, {0, 1, 0}, {0, 0, 1}, {1, 1, 0},
                            {1, 0, 1}, {0, 1, 1}, {1, 1, 1}};
    bool cov[7];
#pragma unroll
    for (int d = 0; d < 7; d++) {
      const int z = cz - mdir[d][2], y = cy - mdir[d][1], x = cx - mdir[d][0];
      cov[d] = z < 0 || y < 0 || x < 0 || own_tbl[(z * c + y) * c + x] >= 0;
    }
    const bool ex = lx == 0, ey = ly == 0, ez = lz == 0;
    const bool badx = ex && (!cov[0] || (ey && !cov[3]) || (ez && !cov[4]) ||
                             (ey && ez && !cov[6]));
    const bool bady = ey && (!cov[1] || (ex && !cov[3]) || (ez && !cov[5]) ||
                             (ex && ez && !cov[6]));
    const bool badz = ez && (!cov[2] || (ex && !cov[4]) || (ey && !cov[5]) ||
                             (ex && ey && !cov[6]));
    const bool mm = (v0 < iso) != (coarse_lerp(cv, lx, ly, lz) < iso);
    bad = valid && mm && (badx || bady || badz);
  }
  const int nbad = __popc(__ballot_sync(0xffffffffu, bad));
  if ((threadIdx.x & 31) == 0) warp_guard[threadIdx.x >> 5] = nbad;
  __syncthreads();
  if (threadIdx.x == 0) {
    int sum = 0;
#pragma unroll
    for (int w = 0; w < WARPS; w++) sum += warp_guard[w];
    if (sum) atomicAdd(guard, sum);
  }
}

}  // namespace

// rows [nk*64] f32, cell_ids [nk] i32 (the first `count` valid), vol_c
// [c+1]^3 f32, own_tbl [c^3] i32; words [2|4, nk*64] i32; bits [(c+1)^3, 2]
// i32, cand [(c+1)^3] u8 and guard [1] i32 zeroed by the caller.
extern "C" int sparse_words_launch(const float* rows, const int* cell_ids,
                                   int nk, int count, const float* vol_c,
                                   const int* own_tbl, int c, float iso,
                                   int u8, int* words, int* bits,
                                   uint8_t* cand, int* guard,
                                   cudaStream_t stream) {
  const long long lanes = (long long)nk * LANES;
  const int blocks = (int)((lanes + THREADS - 1) / THREADS);
  sparse_words_kernel<<<blocks, THREADS, 0, stream>>>(
      rows, cell_ids, nk, count, vol_c, own_tbl, c, iso, u8, words, bits,
      cand, guard);
  return (int)cudaGetLastError();
}
