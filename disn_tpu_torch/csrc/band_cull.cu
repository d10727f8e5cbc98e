// K4: the band cull of the sparse pass's coarse grid, on Hopper (sm_90a).
//
// Replaces disn_tpu/infer/sparse.py::_band_tau (:113) and ::_active_cells
// (:67), XLA code the JAX package wrote for the TPU (a hundred-odd small
// ops there and in the port's plain version: seven direction passes of
// slices, masks and maxima, the 8-corner stack, a cumsum and a scatter).
// On the coarse grid vol [rc, rc, rc] f32, axes (z, y, x):
//   - band_tau_step: tau = band_factor x the cell diagonal of the box; with
//     autocal, times max(1, lip), lip the largest near-band slope over 7
//     directions (3 axes, 4 space diagonals), a step counted where
//     min(|a|, |b|) < 4 tau + 2 min|v|;
//   - active_cells_step: the cells (flat over c^3, c = rc - 1) whose
//     corners hold a |v| < tau or disagree in sign (mode band), or whose
//     27 neighbours (themselves included) hold a sign change (mode sign),
//     ascending; ids past `cap` are dropped while the count counts them,
//     and the count is written on the card.
//
// Bit for bit the plain version on the card (infer/sparse._band_tau_plain,
// _active_cells_plain), which is PyTorch's CUDA arithmetic:
//   - span / (rc - 1) is a divide by a host scalar, which PyTorch computes
//     as a multiply by the float reciprocal; the steps' divides are
//     tensor / tensor, IEEE divides;
//   - the sum of the 3 squares of the diagonal is PyTorch's CUDA sum of 3
//     elements, (s0 + s2) + s1; hd is the elementwise (hx hx + hy hy) + hz hz;
//   - every product and sum is __fmul_rn / __fadd_rn (no FMA contraction),
//     the square roots __fsqrt_rn;
//   - min, max, minimum, maximum and clamp give NaN where an operand is
//     NaN, as torch's do (min_nan / max_nan below); a corner compares
//     < 0 and >= 0, so -0.0 counts as not negative and NaN as neither.
// Minima and maxima are exact in any order, so the cross-block reductions
// (per-block partials, reduced in one block) are deterministic.
//
// What bounds it on the H100 (3.35 TB/s): bytes, and in practice launch
// latency. It must read the 65^3 grid once (1.1 MB, 0.33 us) and write
// tau, the ids and the count: ~0.35 us on the main path. Its work is a
// few operations a point. What the design does about it: five launches in
// two host calls, no host synchronisation and no allocation.
//   tau_vmin   min |v| of a grid stride, one partial a block;
//   tau_lip    every block reduces the partials to vmin (the same value in
//              each), then the 7 directions' masked max |b - a| over its
//              stride of points (a point is the low end of each step),
//              7 partials a block;
//   tau_final  one block: each direction's max (a warp each), the
//              slopes in the plain version's order, tau (without autocal
//              the only launch);
//   cull_count one cell a thread, 1,024-cell tiles in row-major order:
//              each tile's active count (__syncthreads_count);
//   cull_write every tile sums the counts of the tiles before it (and all
//              of them, the count), ranks its cells by a ballot and a scan
//              of the warps' counts, and writes its ids at offset + rank;
//              with zero_tail the slots past the count (up to cap) get 0,
//              as the plain version's padding has it.
// A cell's test reads its 8 corners (band) or the 4^3 corner window of its
// 27 neighbours (sign) from L1/L2; the grid is read once from memory.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;   // a tau block
constexpr int PARTS = 256;     // most blocks of a tau pass
constexpr int DIRS = 7;
constexpr int TILE = 1024;     // cells a cull block, one a thread

__device__ __forceinline__ float min_nan(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : (b < a ? b : a));
}

__device__ __forceinline__ float max_nan(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : (b > a ? b : a));
}

struct MinOp {
  __device__ float operator()(float a, float b) const { return min_nan(a, b); }
};
struct MaxOp {
  __device__ float operator()(float a, float b) const { return max_nan(a, b); }
};
struct SumOp {
  __device__ int operator()(int a, int b) const { return a + b; }
};

// The reduction of x over the block, in every thread. red holds 32 values.
template <typename T, typename Op>
__device__ T block_reduce(T x, Op op, T* red) {
  for (int o = 16; o; o >>= 1) x = op(x, __shfl_xor_sync(~0u, x, o));
  const int warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  __syncthreads();  // red may still be read by a previous reduction
  if ((threadIdx.x & 31) == 0) red[warp] = x;
  __syncthreads();
  x = red[0];
  for (int w = 1; w < warps; ++w) x = op(x, red[w]);
  return x;
}

struct Box {
  float h[3];  // the world step along x, y, z
  float tau0;  // band_factor x the cell diagonal
  float hd;    // the space diagonal's step
};

__device__ Box box_geometry(const float* sp, int rc, float band_factor) {
  Box g;
  const float inv = __fdiv_rn(1.0f, (float)(rc - 1));
  for (int i = 0; i < 3; ++i)
    g.h[i] = __fmul_rn(__fsub_rn(sp[3 + i], sp[i]), inv);
  const float s0 = __fmul_rn(g.h[0], g.h[0]), s1 = __fmul_rn(g.h[1], g.h[1]),
              s2 = __fmul_rn(g.h[2], g.h[2]);
  g.tau0 =
      __fmul_rn(band_factor, __fsqrt_rn(__fadd_rn(__fadd_rn(s0, s2), s1)));
  g.hd = __fsqrt_rn(__fadd_rn(__fadd_rn(s0, s1), s2));
  return g;
}

__global__ void __launch_bounds__(THREADS)
tau_vmin(const float* __restrict__ vol, int n, float* __restrict__ part) {
  __shared__ float red[32];
  float m = INFINITY;
  for (int i = blockIdx.x * THREADS + threadIdx.x; i < n;
       i += gridDim.x * THREADS)
    m = min_nan(m, fabsf(vol[i]));
  m = block_reduce(m, MinOp(), red);
  if (threadIdx.x == 0) part[blockIdx.x] = m;
}

__device__ __forceinline__ void step(float a, float b, float win, float& d) {
  const bool near = min_nan(fabsf(a), fabsf(b)) < win;
  d = max_nan(d, near ? fabsf(__fsub_rn(b, a)) : 0.0f);
}

__global__ void __launch_bounds__(THREADS)
tau_lip(const float* __restrict__ vol, int rc, const float* __restrict__ sp,
        float band_factor, const float* __restrict__ part_min,
        float* __restrict__ part_lip) {
  __shared__ float red[32];
  const int parts = gridDim.x;
  float m = INFINITY;
  for (int i = threadIdx.x; i < parts; i += THREADS)
    m = min_nan(m, part_min[i]);
  const float vmin = block_reduce(m, MinOp(), red);
  const Box g = box_geometry(sp, rc, band_factor);
  const float win = __fadd_rn(__fmul_rn(4.0f, g.tau0), __fmul_rn(2.0f, vmin));
  const int n = rc - 1, plane = rc * rc, total = plane * rc;
  float d[DIRS];
  for (int k = 0; k < DIRS; ++k) d[k] = 0.0f;
  for (int p = blockIdx.x * THREADS + threadIdx.x; p < total;
       p += parts * THREADS) {
    const int z = p / plane, y = (p / rc) % rc, x = p % rc;
    if (z >= n && y >= n && x >= n) continue;
    const float a = vol[p];
    if (z < n) step(a, vol[p + plane], win, d[0]);
    if (y < n) step(a, vol[p + rc], win, d[1]);
    if (x < n) step(a, vol[p + 1], win, d[2]);
    if (z < n) {
      if (y < n && x < n) step(a, vol[p + plane + rc + 1], win, d[3]);
      if (y < n && x > 0) step(a, vol[p + plane + rc - 1], win, d[4]);
      if (y > 0 && x < n) step(a, vol[p + plane - rc + 1], win, d[5]);
      if (y > 0 && x > 0) step(a, vol[p + plane - rc - 1], win, d[6]);
    }
  }
  for (int k = 0; k < DIRS; ++k) {
    const float r = block_reduce(d[k], MaxOp(), red);
    if (threadIdx.x == 0) part_lip[k * PARTS + blockIdx.x] = r;
  }
}

__global__ void __launch_bounds__(THREADS)
tau_final(int rc, const float* __restrict__ sp, float band_factor, int parts,
          const float* __restrict__ part_lip, float* __restrict__ tau) {
  __shared__ float red[32];
  const Box g = box_geometry(sp, rc, band_factor);
  if (parts == 0) {  // no autocal
    if (threadIdx.x == 0) *tau = g.tau0;
    return;
  }
  // warp k reduces direction k's partials; then the slopes in order
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < DIRS) {
    float m = 0.0f;
    for (int i = lane; i < parts; i += 32)
      m = max_nan(m, part_lip[warp * PARTS + i]);
    for (int o = 16; o; o >>= 1) m = max_nan(m, __shfl_xor_sync(~0u, m, o));
    if (lane == 0) red[warp] = m;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    // the directions' steps: z, y, x, then the four space diagonals
    const float steps[DIRS] = {g.h[2], g.h[1], g.h[0], g.hd, g.hd, g.hd,
                               g.hd};
    float lip = 0.0f;
    for (int k = 0; k < DIRS; ++k)
      lip = max_nan(lip, __fdiv_rn(red[k], steps[k]));
    *tau = __fmul_rn(g.tau0, isnan(lip) ? lip : fmaxf(lip, 1.0f));
  }
}

// A cell's test; (z, y, x) inside [0, c)^3, rc = c + 1.
__device__ bool cell_active(const float* __restrict__ vol, int c, int sign,
                            float tau, int z, int y, int x) {
  const int rc = c + 1;
  if (!sign) {
    const float* v = vol + ((size_t)z * rc + y) * rc + x;
    const int off[8] = {0, 1, rc, rc + 1, rc * rc, rc * rc + 1, rc * rc + rc,
                        rc * rc + rc + 1};
    float m = INFINITY;
    bool neg = false, pos = false;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float val = v[off[k]];
      m = min_nan(m, fabsf(val));
      neg |= val < 0.0f;
      pos |= val >= 0.0f;
    }
    return m < tau || (neg && pos);
  }
  // the corner window (z-1 .. z+2, y-1 .. y+2, x-1 .. x+2): bit
  // (wz*4 + wy)*4 + wx of neg / pos
  uint64_t neg = 0, pos = 0;
  for (int wz = 0; wz < 4; ++wz) {
    const int pz = z - 1 + wz;
    if (pz < 0 || pz >= rc) continue;
    for (int wy = 0; wy < 4; ++wy) {
      const int py = y - 1 + wy;
      if (py < 0 || py >= rc) continue;
      for (int wx = 0; wx < 4; ++wx) {
        const int px = x - 1 + wx;
        if (px < 0 || px >= rc) continue;
        const float val = vol[((size_t)pz * rc + py) * rc + px];
        const uint64_t bit = 1ull << ((wz * 4 + wy) * 4 + wx);
        if (val < 0.0f) neg |= bit;
        if (val >= 0.0f) pos |= bit;
      }
    }
  }
  for (int dz = 0; dz < 3; ++dz) {
    if (z - 1 + dz < 0 || z - 1 + dz >= c) continue;
    for (int dy = 0; dy < 3; ++dy) {
      if (y - 1 + dy < 0 || y - 1 + dy >= c) continue;
      for (int dx = 0; dx < 3; ++dx) {
        if (x - 1 + dx < 0 || x - 1 + dx >= c) continue;
        // the neighbour's 8 corners: window bits {0,1,4,5,16,17,20,21}
        const uint64_t cm = 0x330033ull << ((dz * 4 + dy) * 4 + dx);
        if ((neg & cm) && (pos & cm)) return true;
      }
    }
  }
  return false;
}

__device__ __forceinline__ bool tile_cell(const float* __restrict__ vol,
                                          int c, int sign, float tau,
                                          int& cell) {
  const int n = c * c * c;
  cell = blockIdx.x * TILE + threadIdx.x;
  if (cell >= n) return false;
  return cell_active(vol, c, sign, tau, cell / (c * c), (cell / c) % c,
                     cell % c);
}

__global__ void __launch_bounds__(TILE)
cull_count(const float* __restrict__ vol, int c, int sign,
           const float* __restrict__ tau_dev, int* __restrict__ tile_n) {
  const float tau = sign ? 0.0f : *tau_dev;
  int cell;
  const int n = __syncthreads_count(tile_cell(vol, c, sign, tau, cell));
  if (threadIdx.x == 0) tile_n[blockIdx.x] = n;
}

__global__ void __launch_bounds__(TILE)
cull_write(const float* __restrict__ vol, int c, int sign,
           const float* __restrict__ tau_dev, const int* __restrict__ tile_n,
           int cap, int zero_tail,
           int* __restrict__ ids, int* __restrict__ count) {
  __shared__ int red[32];
  __shared__ int warp_n[TILE / 32];
  const int tiles = gridDim.x;
  int pre = 0, total = 0;
  for (int t = threadIdx.x; t < tiles; t += TILE) {
    const int k = tile_n[t];
    total += k;
    if (t < (int)blockIdx.x) pre += k;
  }
  pre = block_reduce(pre, SumOp(), red);
  total = block_reduce(total, SumOp(), red);
  const float tau = sign ? 0.0f : *tau_dev;
  int cell;
  const bool act = tile_cell(vol, c, sign, tau, cell);
  const unsigned ballot = __ballot_sync(~0u, act);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_n[warp] = __popc(ballot);
  __syncthreads();
  int rank = __popc(ballot & ((1u << lane) - 1));
  for (int w = 0; w < warp; ++w) rank += warp_n[w];
  const int slot = pre + rank;
  if (act && slot < cap) ids[slot] = cell;
  if (blockIdx.x == 0 && threadIdx.x == 0) *count = total;
  if (zero_tail)
    for (long long s = (long long)min(total, cap) + blockIdx.x * TILE +
                       threadIdx.x;
         s < cap; s += (long long)tiles * TILE)
      ids[s] = 0;
}

}  // namespace

// Floats of the scratch band_tau_step takes.
extern "C" int band_tau_scratch() { return PARTS * (1 + DIRS); }

// tau [1] f32 of the grid vol [rc^3] and the box sp [6] (x0, y0, z0, x1,
// y1, z1); autocal widens it by the observed slope. Returns a CUDA error.
extern "C" int band_tau_step(const float* vol, int rc, const float* sp,
                             float band_factor, int autocal, float* scratch,
                             float* tau, cudaStream_t stream) {
  int parts = 0;
  if (autocal) {
    const int n = rc * rc * rc;
    parts = (n + THREADS * 8 - 1) / (THREADS * 8);
    parts = parts < PARTS ? parts : PARTS;
    tau_vmin<<<parts, THREADS, 0, stream>>>(vol, n, scratch);
    cudaError_t err = cudaGetLastError();
    if (err) return (int)err;
    tau_lip<<<parts, THREADS, 0, stream>>>(vol, rc, sp, band_factor, scratch,
                                           scratch + PARTS);
    err = cudaGetLastError();
    if (err) return (int)err;
  }
  tau_final<<<1, THREADS, 0, stream>>>(rc, sp, band_factor, parts,
                                       scratch + PARTS, tau);
  return (int)cudaGetLastError();
}

// Tiles (ints of tile scratch) active_cells_step takes for c^3 cells.
extern "C" int cull_tiles(int c) { return (c * c * c + TILE - 1) / TILE; }

// The active cells of the grid vol [(c+1)^3]: ids [cap] ascending (ids
// past cap dropped; with zero_tail the slots past the count set to 0) and
// count [1], the cells that pass. Mode band reads tau [1] on the card;
// mode sign (sign != 0) does not read it.
extern "C" int active_cells_step(const float* vol, int c, int sign,
                                 const float* tau, int cap, int zero_tail,
                                 int* tile_n, int* ids, int* count,
                                 cudaStream_t stream) {
  const int tiles = cull_tiles(c);
  cull_count<<<tiles, TILE, 0, stream>>>(vol, c, sign, tau, tile_n);
  cudaError_t err = cudaGetLastError();
  if (err) return (int)err;
  cull_write<<<tiles, TILE, 0, stream>>>(vol, c, sign, tau, tile_n, cap,
                                         zero_tail, ids, count);
  return (int)cudaGetLastError();
}
