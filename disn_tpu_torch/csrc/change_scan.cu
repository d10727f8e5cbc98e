// K2s: the volume flow's candidate scan, on Hopper (sm_90a).
//
// Replaces disn_tpu/ops/marching.py::_sign_change_cells (:540) with the bit
// packing and candidate flags of _active_cells_from_coarse (:608) and the
// full scan of _active_cells_ext (:561): XLA code the JAX package wrote for
// the TPU (separable any/all pairs over the padded sign field, the bits
// packed by two small MXU products, the candidate flags scattered and
// edge-padded; ~54 small ops in the port's plain version,
// ops/marching._candidate_scan_plain). Over the [R,R,R] f32 volume and iso,
// with reads clamped to R-1 (the high ghost layer reads the last plane
// again), and the grid of B3 = ceil(R/4) blocks of 4^3 cells a side:
//   - bits [B3^3, 2] int32: each block's 64 sign-change bits as (lo, hi),
//     bit l = (lz*4 + ly)*4 + lx; a cell changes when its 8 corner signs
//     (value < iso; false for NaN) disagree; cells past R - 1 hold 0;
//   - cand [B3^3] bool: the candidate blocks, the coarse cells
//     ids[:count] (cgrid = B3 - 1 a side) with the ghost blocks taking
//     their low neighbour's flag; every block in the full scan;
//   - counts [3] int32: total (the change cells), inside (the change bits
//     in candidate blocks) and outside (the rest: the scan's guard).
// Bit for bit the plain version: comparisons and integers only.
//
// What bounds it on the H100 (3.35 TB/s): bytes. It must read the volume
// once (67.9 MB at 257^3) and the coarse ids, and write the bits (2.2 MB),
// the flags (0.27 MB) and the counts: 0.021 ms. What the design does about
// it: one thread a block, which walks the block's 5^3 corner neighbourhood
// plane by plane (25 inside bits a plane, the 16 cells of a layer from two
// planes by shifts), so that each plane is read once for two layers and
// the volume about 1.25 times in all, mostly from L1; the counts are
// summed in the CTA and added with one integer atomic each (order-free,
// so deterministic). Launch calls: one memset (the counts, and the flags
// in the coarse form), the marking kernel (coarse form only) and the scan
// kernel: at most 3, nothing read back.
// Nothing is cached per process or per device: no function attribute, no
// cluster fit, no table upload.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

// The 25 inside bits (bit py*5 + px) of plane z of a block's corner
// neighbourhood from (y0, x0), reads clamped to R - 1.
__device__ __forceinline__ unsigned plane_bits(const float* vol, int R, int z,
                                               int y0, int x0, float iso) {
  const float* pl = vol + (size_t)min(z, R - 1) * R * R;
  unsigned p = 0;
#pragma unroll
  for (int py = 0; py < 5; ++py) {
    const float* row = pl + (size_t)min(y0 + py, R - 1) * R;
#pragma unroll
    for (int px = 0; px < 5; ++px)
      p |= (unsigned)(__ldg(row + min(x0 + px, R - 1)) < iso)
           << (py * 5 + px);
  }
  return p;
}

// cand of the coarse cells ids[:count] and of the ghost blocks that copy
// them: a cell on the last coarse plane of an axis also flags the block
// past it.
__global__ void mark_kernel(const int* ids, int n_ids, const int* count,
                            int cgrid, int B3, uint8_t* cand) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = count ? min(max(*count, 0), n_ids) : n_ids;
  if (i >= n) return;
  const int id = ids[i];
  if (id < 0 || id >= cgrid * cgrid * cgrid) return;
  const int cz = id / (cgrid * cgrid), cy = (id / cgrid) % cgrid,
            cx = id % cgrid;
  const int nz = cz == cgrid - 1 ? 2 : 1, ny = cy == cgrid - 1 ? 2 : 1,
            nx = cx == cgrid - 1 ? 2 : 1;
  for (int a = 0; a < nz; ++a)
    for (int b = 0; b < ny; ++b)
      for (int c = 0; c < nx; ++c)
        cand[((size_t)(cz + a) * B3 + cy + b) * B3 + cx + c] = 1;
}

__global__ void scan_kernel(const float* vol, int R, int B3, float iso,
                            int every, uint8_t* cand, int* bits,
                            int* counts) {
  const int nb = B3 * B3 * B3;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  int total = 0, inside = 0, outside = 0;
  if (b < nb) {
    const int bx = b % B3, by = (b / B3) % B3, bz = b / (B3 * B3);
    const int x0 = 4 * bx, y0 = 4 * by, z0 = 4 * bz;
    unsigned valid = 0;  // bit ly*4 + lx: the cell lies inside along y, x
#pragma unroll
    for (int ly = 0; ly < 4; ++ly)
#pragma unroll
      for (int lx = 0; lx < 4; ++lx)
        valid |= (unsigned)((y0 + ly < R) & (x0 + lx < R)) << (ly * 4 + lx);
    unsigned w[2] = {0u, 0u};
    unsigned lo_plane = plane_bits(vol, R, z0, y0, x0, iso);
#pragma unroll
    for (int lz = 0; lz < 4; ++lz) {
      const unsigned hi_plane = plane_bits(vol, R, z0 + lz + 1, y0, x0, iso);
      if (z0 + lz < R) {
        const unsigned o = lo_plane | hi_plane, a = lo_plane & hi_plane;
        const unsigned any = o | (o >> 1) | (o >> 5) | (o >> 6);
        const unsigned all = a & (a >> 1) & (a >> 5) & (a >> 6);
        const unsigned ch = any & ~all;
        unsigned m = 0;
#pragma unroll
        for (int ly = 0; ly < 4; ++ly)
          m |= ((ch >> (ly * 5)) & 0xfu) << (ly * 4);
        w[lz >> 1] |= (m & valid) << ((lz & 1) * 16);
      }
      lo_plane = hi_plane;
    }
    bits[2 * b] = (int)w[0];
    bits[2 * b + 1] = (int)w[1];
    const int pc = __popc(w[0]) + __popc(w[1]);
    int c = 1;
    if (every)
      cand[b] = 1;
    else
      c = cand[b];
    total = pc;
    inside = c ? pc : 0;
    outside = c ? 0 : pc;
  }
  __shared__ int part[3][THREADS / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    total += __shfl_down_sync(FULL, total, off);
    inside += __shfl_down_sync(FULL, inside, off);
    outside += __shfl_down_sync(FULL, outside, off);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    part[0][warp] = total;
    part[1][warp] = inside;
    part[2][warp] = outside;
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    int s = 0;
    for (int k = 0; k < THREADS / 32; ++k) s += part[threadIdx.x][k];
    if (s) atomicAdd(counts + threadIdx.x, s);
  }
}

}  // namespace

// The scan of the [R,R,R] volume at iso -> bits [B3^3, 2], cand [B3^3],
// counts [3] (total, inside, outside), B3 = ceil(R/4). every != 0: every
// block a candidate (the full scan; ids unused). Otherwise the candidates
// are the coarse cells ids[:n] of the (B3 - 1)^3 grid, n = *count clamped
// to [0, n_ids] when count is not null, else n_ids. cand must follow
// counts in memory (one memset zeroes both; 16 bytes between them). Returns
// a CUDA error.
extern "C" int change_scan(const float* vol, int R, float iso, const int* ids,
                           int n_ids, const int* count, int every, int* bits,
                           int* counts, uint8_t* cand, cudaStream_t stream) {
  const int B3 = (R + 3) / 4;
  const int nb = B3 * B3 * B3;
  cudaError_t e = cudaMemsetAsync(counts, 0, every ? 16 : 16 + (size_t)nb,
                                  stream);
  if (e != cudaSuccess) return (int)e;
  if (!every && n_ids > 0) {
    mark_kernel<<<(n_ids + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
        ids, n_ids, count, B3 - 1, B3, cand);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  scan_kernel<<<(nb + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
      vol, R, B3, iso, every, cand, bits, counts);
  return (int)cudaGetLastError();
}
