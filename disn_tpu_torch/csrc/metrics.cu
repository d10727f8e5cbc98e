// K6: the point-cloud metrics of the evaluation protocol on Hopper (sm_90a).
//
// Replaces the XLA code of disn_tpu/eval/metrics.py, which the JAX package
// writes as dense [B,N,M] Gram matrices for the TPU's matrix unit:
//   K6a  nn_distance (:38-44)      nearest neighbour both ways, squared
//   K6b  approx_match (:75-113)    the 10-level auction -> match [B,M,N]
//   K6c  match_cost (:116-122)     sum match * Euclidean distance -> [B]
//   K6d  _mc_bwd (:129-142)        match_cost's gradient wrt both clouds
// At the protocol's sizes (B <= 24 views, N = M = 2048 points) each [B,N,M]
// f32 tensor is 403 MB, and the XLA form makes several a level.
//
// What bounds them on the H100 (80 GB at 3.35 TB/s, 67 TFLOP/s f32 FMA,
// 16 special-function results a clock per SM):
//   K6a ~8 flops a pair and direction, inputs and outputs ~2 MB: operations,
//       ~0.02 ms at the protocol shape.
//   K6b one exp a pair and level (10 levels, 1e9 at the protocol shape) on
//       the special-function units, and the 403 MB match written once.
//   K6c, K6d one read of match (403 MB): bytes, ~0.12 ms each.
// What the design does about it: no kernel stores a [B,N,M] tensor other
// than match itself. Distances are recomputed from the coordinates, held in
// shared memory a tile at a time, in the JAX package's Gram form
// (|a|^2 - 2 a.b) + |b|^2 clamped at 0, with |a|^2 and |b|^2 precomputed by
// the caller exactly as the plain PyTorch versions compute them, so that
// only a.b differs from those by rounding. Rows are reduced by NSPLIT
// neighbouring threads each (merged with shuffles in a fixed order), so a
// pass has B*N*NSPLIT threads in flight; every sum has a fixed order and
// no atomics are used: two runs give the same bits.
//
// K6b's phases per level (the plain version's one_level): a row pass
// (ratio_l from remain_l and remain_r), a column pass (sumr, ratio_r,
// remain_r), and a row pass (sum_m e ratio_r -> remain_l). The last row
// pass of a level shares a launch with the first row pass of the next
// (two exps a pair). The ten levels' ratio_l and ratio_r vectors are kept,
// and match = sum_level e * ratio_l * ratio_r is written once at the end,
// in level order as the plain version adds it up.
//
// Simple and right first: no tensor cores, no asynchronous copies.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NSPLIT = 4;              // threads that share one row
constexpr int ROWS = 64;               // rows a block
constexpr int THREADS = ROWS * NSPLIT; // 256
constexpr int TILE = 512;              // points of the other cloud staged
constexpr int LEVELS = 10;
__constant__ float kLevels[LEVELS] = {-16384.f, -4096.f, -1024.f, -256.f,
                                      -64.f, -16.f, -4.f, -1.f, -0.25f, 0.f};
constexpr int MATCH_ROWS = 8;          // rows m a block of the match write
constexpr int COST_ROWS = 4;           // rows m a block of match_cost

// (|p1|^2 - 2 p1.p2) + |p2|^2, clamped at 0: the plain versions' order, p1
// from the first cloud of _pairwise_sqdist. No contraction across the
// steps: 2*ab is exact, so the fused and the separate subtraction agree.
__device__ __forceinline__ float gram_d(float sq1, float sq2, float ab) {
  return fmaxf(__fadd_rn(__fsub_rn(sq1, 2.f * ab), sq2), 0.f);
}

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return fmaf(az, bz, fmaf(ay, by, ax * bx));
}

__device__ __forceinline__ float split_sum(float v) {
#pragma unroll
  for (int off = 1; off < NSPLIT; off <<= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ---------------------------------------------------------------- K6a ----
// blockIdx.z = batch, blockIdx.y = direction (0: rows of xyz1 against
// xyz2; 1: rows of xyz2 against xyz1), blockIdx.x = tile of ROWS rows.
__global__ void __launch_bounds__(THREADS)
nn_kernel(const float* __restrict__ xyz1, const float* __restrict__ sq1,
          int n, const float* __restrict__ xyz2,
          const float* __restrict__ sq2, int m, float* __restrict__ dist1,
          int* __restrict__ idx1, float* __restrict__ dist2,
          int* __restrict__ idx2) {
  __shared__ float sx[TILE], sy[TILE], sz[TILE], ss[TILE];
  const int b = blockIdx.z;
  const bool first = blockIdx.y == 0;
  const int nr = first ? n : m, no = first ? m : n;
  if (blockIdx.x * ROWS >= nr) return;  // uniform across the block
  const float* rows = first ? xyz1 + (size_t)b * n * 3
                            : xyz2 + (size_t)b * m * 3;
  const float* rsq = first ? sq1 + (size_t)b * n : sq2 + (size_t)b * m;
  const float* oth = first ? xyz2 + (size_t)b * m * 3
                           : xyz1 + (size_t)b * n * 3;
  const float* osq = first ? sq2 + (size_t)b * m : sq1 + (size_t)b * n;
  const int r = blockIdx.x * ROWS + threadIdx.x / NSPLIT;
  const int part = threadIdx.x % NSPLIT;
  const bool live = r < nr;
  float rx = 0.f, ry = 0.f, rz = 0.f, rs = 0.f;
  if (live) {
    rx = rows[3 * r];
    ry = rows[3 * r + 1];
    rz = rows[3 * r + 2];
    rs = rsq[r];
  }
  float best = INFINITY;
  int bi = 0x7fffffff;
  for (int t0 = 0; t0 < no; t0 += TILE) {
    const int cnt = min(TILE, no - t0);
    __syncthreads();
    for (int i = threadIdx.x; i < cnt; i += THREADS) {
      sx[i] = oth[3 * (t0 + i)];
      sy[i] = oth[3 * (t0 + i) + 1];
      sz[i] = oth[3 * (t0 + i) + 2];
      ss[i] = osq[t0 + i];
    }
    __syncthreads();
    if (live) {
      for (int j = part; j < cnt; j += NSPLIT) {
        const float ab = dot3(rx, ry, rz, sx[j], sy[j], sz[j]);
        const float d = first ? gram_d(rs, ss[j], ab) : gram_d(ss[j], rs, ab);
        if (d < best) {  // increasing j: the lowest index wins a tie
          best = d;
          bi = t0 + j;
        }
      }
    }
  }
#pragma unroll
  for (int off = 1; off < NSPLIT; off <<= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, off);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
    if (ob < best || (ob == best && oi < bi)) {
      best = ob;
      bi = oi;
    }
  }
  if (live && part == 0) {
    float* dist = first ? dist1 + (size_t)b * n : dist2 + (size_t)b * m;
    int* idx = first ? idx1 + (size_t)b * n : idx2 + (size_t)b * m;
    dist[r] = best;
    idx[r] = bi;
  }
}

// ---------------------------------------------------------------- K6b ----
// Row pass of level k over the points of xyz1 (blockIdx.y = batch):
//   k > 0: remain_l -= ratio_l[k-1] * sum_m e_{k-1} ratio_r[k-1]  (>= 0)
//   ratio_l[k] = remain_l / (1e-9 + sum_m e_k remain_r)
// ratio_l / ratio_r are [LEVELS][B][n] / [LEVELS][B][m].
__global__ void __launch_bounds__(THREADS)
am_row(const float* __restrict__ xyz1, const float* __restrict__ sq1, int n,
       const float* __restrict__ xyz2, const float* __restrict__ sq2, int m,
       int nb, int k, float* __restrict__ remain_l,
       const float* __restrict__ remain_r, float* __restrict__ ratio_l,
       const float* __restrict__ ratio_r) {
  __shared__ float sx[TILE], sy[TILE], sz[TILE], ss[TILE], w1[TILE],
      w2[TILE];
  const int b = blockIdx.y;
  const float lev = kLevels[k];
  const float lev_prev = k > 0 ? kLevels[k - 1] : 0.f;
  const float* p1 = xyz1 + (size_t)b * n * 3;
  const float* p2 = xyz2 + (size_t)b * m * 3;
  const float* rr_prev =
      k > 0 ? ratio_r + ((size_t)(k - 1) * nb + b) * m : nullptr;
  const float* rem_r = remain_r + (size_t)b * m;
  const int r = blockIdx.x * ROWS + threadIdx.x / NSPLIT;
  const int part = threadIdx.x % NSPLIT;
  const bool live = r < n;
  float rx = 0.f, ry = 0.f, rz = 0.f, rs = 0.f;
  if (live) {
    rx = p1[3 * r];
    ry = p1[3 * r + 1];
    rz = p1[3 * r + 2];
    rs = sq1[(size_t)b * n + r];
  }
  float s_prev = 0.f, s_cur = 0.f;
  for (int t0 = 0; t0 < m; t0 += TILE) {
    const int cnt = min(TILE, m - t0);
    __syncthreads();
    for (int i = threadIdx.x; i < cnt; i += THREADS) {
      sx[i] = p2[3 * (t0 + i)];
      sy[i] = p2[3 * (t0 + i) + 1];
      sz[i] = p2[3 * (t0 + i) + 2];
      ss[i] = sq2[(size_t)b * m + t0 + i];
      w1[i] = rem_r[t0 + i];
      w2[i] = k > 0 ? rr_prev[t0 + i] : 0.f;
    }
    __syncthreads();
    if (live) {
      for (int j = part; j < cnt; j += NSPLIT) {
        const float d = gram_d(rs, ss[j], dot3(rx, ry, rz, sx[j], sy[j],
                                               sz[j]));
        s_cur = fmaf(expf(lev * d), w1[j], s_cur);
        if (k > 0) s_prev = fmaf(expf(lev_prev * d), w2[j], s_prev);
      }
    }
  }
  s_cur = split_sum(s_cur);
  s_prev = split_sum(s_prev);
  if (live && part == 0) {
    const size_t i = (size_t)b * n + r;
    float rem = remain_l[i];
    if (k > 0)
      rem = fmaxf(0.f, rem - ratio_l[(size_t)(k - 1) * nb * n + i] * s_prev);
    remain_l[i] = rem;
    ratio_l[(size_t)k * nb * n + i] = rem / (1e-9f + s_cur);
  }
}

// Column pass of level k over the points of xyz2:
//   sumr = (sum_n e_k ratio_l[k]) * remain_r
//   ratio_r[k] = min(remain_r / (sumr + 1e-9), 1) * remain_r
//   remain_r = max(0, remain_r - sumr)
__global__ void __launch_bounds__(THREADS)
am_col(const float* __restrict__ xyz1, const float* __restrict__ sq1, int n,
       const float* __restrict__ xyz2, const float* __restrict__ sq2, int m,
       int nb, int k, const float* __restrict__ ratio_l,
       float* __restrict__ remain_r, float* __restrict__ ratio_r) {
  __shared__ float sx[TILE], sy[TILE], sz[TILE], ss[TILE], w1[TILE];
  const int b = blockIdx.y;
  const float lev = kLevels[k];
  const float* p1 = xyz1 + (size_t)b * n * 3;
  const float* p2 = xyz2 + (size_t)b * m * 3;
  const float* rl = ratio_l + ((size_t)k * nb + b) * n;
  const int c = blockIdx.x * ROWS + threadIdx.x / NSPLIT;
  const int part = threadIdx.x % NSPLIT;
  const bool live = c < m;
  float cx = 0.f, cy = 0.f, cz = 0.f, cs = 0.f;
  if (live) {
    cx = p2[3 * c];
    cy = p2[3 * c + 1];
    cz = p2[3 * c + 2];
    cs = sq2[(size_t)b * m + c];
  }
  float s = 0.f;
  for (int t0 = 0; t0 < n; t0 += TILE) {
    const int cnt = min(TILE, n - t0);
    __syncthreads();
    for (int i = threadIdx.x; i < cnt; i += THREADS) {
      sx[i] = p1[3 * (t0 + i)];
      sy[i] = p1[3 * (t0 + i) + 1];
      sz[i] = p1[3 * (t0 + i) + 2];
      ss[i] = sq1[(size_t)b * n + t0 + i];
      w1[i] = rl[t0 + i];
    }
    __syncthreads();
    if (live) {
      for (int j = part; j < cnt; j += NSPLIT) {
        const float d = gram_d(ss[j], cs, dot3(sx[j], sy[j], sz[j], cx, cy,
                                               cz));
        s = fmaf(expf(lev * d), w1[j], s);
      }
    }
  }
  s = split_sum(s);
  if (live && part == 0) {
    const size_t i = (size_t)b * m + c;
    const float rem = remain_r[i];
    const float sumr = s * rem;
    const float cons = fminf(rem / (sumr + 1e-9f), 1.f);
    ratio_r[(size_t)k * nb * m + i] = cons * rem;
    remain_r[i] = fmaxf(0.f, rem - sumr);
  }
}

// match[b][c][r] = sum_k (e_k[r,c] * ratio_l[k][r]) * ratio_r[k][c], in
// level order. Threads run along r (the fastest axis of match), a block
// covers MATCH_ROWS columns c (blockIdx.y), blockIdx.z = batch.
__global__ void __launch_bounds__(256)
am_match(const float* __restrict__ xyz1, const float* __restrict__ sq1,
         int n, const float* __restrict__ xyz2,
         const float* __restrict__ sq2, int m, int nb,
         const float* __restrict__ ratio_l,
         const float* __restrict__ ratio_r, float* __restrict__ match) {
  __shared__ float cpt[MATCH_ROWS][4];
  __shared__ float crr[MATCH_ROWS][LEVELS];
  const int b = blockIdx.z;
  const int c0 = blockIdx.y * MATCH_ROWS;
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  for (int i = threadIdx.x; i < MATCH_ROWS * (4 + LEVELS); i += blockDim.x) {
    const int row = i / (4 + LEVELS), f = i % (4 + LEVELS);
    const int c = c0 + row;
    float v = 0.f;
    if (c < m) {
      if (f < 3)
        v = xyz2[((size_t)b * m + c) * 3 + f];
      else if (f == 3)
        v = sq2[(size_t)b * m + c];
      else
        v = ratio_r[((size_t)(f - 4) * nb + b) * m + c];
    }
    if (f < 4)
      cpt[row][f] = v;
    else
      crr[row][f - 4] = v;
  }
  __syncthreads();
  if (r >= n) return;
  const float rx = xyz1[((size_t)b * n + r) * 3];
  const float ry = xyz1[((size_t)b * n + r) * 3 + 1];
  const float rz = xyz1[((size_t)b * n + r) * 3 + 2];
  const float rs = sq1[(size_t)b * n + r];
  float rl[LEVELS];
#pragma unroll
  for (int k = 0; k < LEVELS; k++)
    rl[k] = ratio_l[((size_t)k * nb + b) * n + r];
  for (int row = 0; row < MATCH_ROWS; row++) {
    const int c = c0 + row;
    if (c >= m) break;
    const float d = gram_d(rs, cpt[row][3],
                           dot3(rx, ry, rz, cpt[row][0], cpt[row][1],
                                cpt[row][2]));
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < LEVELS; k++)
      acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(expf(kLevels[k] * d), rl[k]),
                                     crr[row][k]));
    match[((size_t)b * m + c) * n + r] = acc;
  }
}

// ---------------------------------------------------------------- K6c ----
// partial[b][blockIdx.x] = sum over COST_ROWS rows c of match[b] and every
// r of match[b][c][r] * sqrt(d(xyz2_c, xyz1_r)): the plain version's
// _pairwise_sqdist(xyz2, xyz1), so the xyz2 point comes first.
__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < (int)(blockDim.x / 32); w++) t += red[w];
  return t;  // valid in thread 0
}

__global__ void __launch_bounds__(256)
mc_partial(const float* __restrict__ xyz1, const float* __restrict__ sq1,
           int n, const float* __restrict__ xyz2,
           const float* __restrict__ sq2, int m,
           const float* __restrict__ match, float* __restrict__ partial) {
  __shared__ float red[8];
  const int b = blockIdx.y;
  float acc = 0.f;
  for (int row = 0; row < COST_ROWS; row++) {
    const int c = blockIdx.x * COST_ROWS + row;
    if (c >= m) break;
    const float cx = xyz2[((size_t)b * m + c) * 3];
    const float cy = xyz2[((size_t)b * m + c) * 3 + 1];
    const float cz = xyz2[((size_t)b * m + c) * 3 + 2];
    const float cs = sq2[(size_t)b * m + c];
    const float* mrow = match + ((size_t)b * m + c) * n;
    for (int r = threadIdx.x; r < n; r += blockDim.x) {
      const float* p = xyz1 + ((size_t)b * n + r) * 3;
      const float d = gram_d(cs, sq1[(size_t)b * n + r],
                             dot3(cx, cy, cz, p[0], p[1], p[2]));
      acc = fmaf(mrow[r], sqrtf(d), acc);
    }
  }
  const float t = block_sum(acc, red);
  if (threadIdx.x == 0) partial[(size_t)b * gridDim.x + blockIdx.x] = t;
}

__global__ void __launch_bounds__(256)
mc_total(const float* __restrict__ partial, int parts,
         float* __restrict__ cost) {
  __shared__ float red[8];
  const int b = blockIdx.x;
  float acc = 0.f;
  for (int i = threadIdx.x; i < parts; i += blockDim.x)
    acc += partial[(size_t)b * parts + i];
  const float t = block_sum(acc, red);
  if (threadIdx.x == 0) cost[b] = t;
}

// ---------------------------------------------------------------- K6d ----
// unit(x1_r - x2_c): the direct difference, |diff| as sqrt((dx^2 + dy^2)
// + dz^2) with every step rounded, divided by max(|diff|, 1e-12).
__device__ __forceinline__ void unit_diff(float ax, float ay, float az,
                                          float bx, float by, float bz,
                                          float* ux, float* uy, float* uz) {
  const float dx = __fsub_rn(ax, bx), dy = __fsub_rn(ay, by),
              dz = __fsub_rn(az, bz);
  const float dist = sqrtf(__fadd_rn(
      __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz)));
  const float den = fmaxf(dist, 1e-12f);
  *ux = __fdiv_rn(dx, den);
  *uy = __fdiv_rn(dy, den);
  *uz = __fdiv_rn(dz, den);
}

// grad1[b][r] = g[b] * sum_c match[b][c][r] * unit(x1_r - x2_c): a thread a
// point r (consecutive threads read consecutive match entries of a row).
__global__ void __launch_bounds__(256)
mc_grad1(const float* __restrict__ xyz1, int n,
         const float* __restrict__ xyz2, int m,
         const float* __restrict__ match, const float* __restrict__ g,
         float* __restrict__ grad1) {
  const int b = blockIdx.y;
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const float* p = xyz1 + ((size_t)b * n + r) * 3;
  const float ax = p[0], ay = p[1], az = p[2];
  float sx = 0.f, sy = 0.f, sz = 0.f;
  for (int c = 0; c < m; c++) {
    const float* q = xyz2 + ((size_t)b * m + c) * 3;
    float ux, uy, uz;
    unit_diff(ax, ay, az, q[0], q[1], q[2], &ux, &uy, &uz);
    const float w = match[((size_t)b * m + c) * n + r];
    sx = __fadd_rn(sx, __fmul_rn(w, ux));
    sy = __fadd_rn(sy, __fmul_rn(w, uy));
    sz = __fadd_rn(sz, __fmul_rn(w, uz));
  }
  const float gb = g[b];
  float* o = grad1 + ((size_t)b * n + r) * 3;
  o[0] = gb * sx;
  o[1] = gb * sy;
  o[2] = gb * sz;
}

// grad2[b][c] = -g[b] * sum_r match[b][c][r] * unit(x1_r - x2_c): a warp a
// row c, its lanes along r.
__global__ void __launch_bounds__(256)
mc_grad2(const float* __restrict__ xyz1, int n,
         const float* __restrict__ xyz2, int m,
         const float* __restrict__ match, const float* __restrict__ g,
         float* __restrict__ grad2) {
  const int b = blockIdx.y;
  const int c = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (c >= m) return;  // uniform across the warp
  const float* q = xyz2 + ((size_t)b * m + c) * 3;
  const float bx = q[0], by = q[1], bz = q[2];
  const float* mrow = match + ((size_t)b * m + c) * n;
  float sx = 0.f, sy = 0.f, sz = 0.f;
  for (int r = lane; r < n; r += 32) {
    const float* p = xyz1 + ((size_t)b * n + r) * 3;
    float ux, uy, uz;
    unit_diff(p[0], p[1], p[2], bx, by, bz, &ux, &uy, &uz);
    const float w = mrow[r];
    sx = __fadd_rn(sx, __fmul_rn(w, ux));
    sy = __fadd_rn(sy, __fmul_rn(w, uy));
    sz = __fadd_rn(sz, __fmul_rn(w, uz));
  }
  for (int off = 16; off > 0; off >>= 1) {
    sx += __shfl_xor_sync(0xffffffffu, sx, off);
    sy += __shfl_xor_sync(0xffffffffu, sy, off);
    sz += __shfl_xor_sync(0xffffffffu, sz, off);
  }
  if (lane == 0) {
    const float gb = -g[b];
    float* o = grad2 + ((size_t)b * m + c) * 3;
    o[0] = gb * sx;
    o[1] = gb * sy;
    o[2] = gb * sz;
  }
}

inline int blocks(int count, int per) { return (count + per - 1) / per; }

}  // namespace

// Each entry point launches on `stream`, checks every launch and returns
// its CUDA error code (0 on success). The caller allocates every buffer.

extern "C" int nn_distance_launch(const float* xyz1, const float* sq1, int n,
                                  const float* xyz2, const float* sq2, int m,
                                  int batch, float* dist1, int* idx1,
                                  float* dist2, int* idx2,
                                  cudaStream_t stream) {
  const dim3 grid(blocks(n > m ? n : m, ROWS), 2, batch);
  nn_kernel<<<grid, THREADS, 0, stream>>>(xyz1, sq1, n, xyz2, sq2, m, dist1,
                                          idx1, dist2, idx2);
  return (int)cudaGetLastError();
}

// remain_l [B,n] and remain_r [B,m] hold the starting masses on entry
// (multi_l, multi_r) and are scratch; ratio_l [LEVELS,B,n] and ratio_r
// [LEVELS,B,m] are scratch; match is [B,m,n].
extern "C" int approx_match_launch(const float* xyz1, const float* sq1,
                                   int n, const float* xyz2,
                                   const float* sq2, int m, int batch,
                                   float* remain_l, float* remain_r,
                                   float* ratio_l, float* ratio_r,
                                   float* match, cudaStream_t stream) {
  const dim3 grow(blocks(n, ROWS), batch), gcol(blocks(m, ROWS), batch);
  for (int k = 0; k < LEVELS; k++) {
    am_row<<<grow, THREADS, 0, stream>>>(xyz1, sq1, n, xyz2, sq2, m, batch,
                                         k, remain_l, remain_r, ratio_l,
                                         ratio_r);
    int err = (int)cudaGetLastError();
    if (err) return err;
    am_col<<<gcol, THREADS, 0, stream>>>(xyz1, sq1, n, xyz2, sq2, m, batch,
                                         k, ratio_l, remain_r, ratio_r);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  const dim3 gm(blocks(n, 256), blocks(m, MATCH_ROWS), batch);
  am_match<<<gm, 256, 0, stream>>>(xyz1, sq1, n, xyz2, sq2, m, batch, ratio_l,
                                   ratio_r, match);
  return (int)cudaGetLastError();
}

extern "C" int match_cost_parts(int m) { return blocks(m, COST_ROWS); }

// partial is [B, match_cost_parts(m)] scratch; cost is [B].
extern "C" int match_cost_launch(const float* xyz1, const float* sq1, int n,
                                 const float* xyz2, const float* sq2, int m,
                                 int batch, const float* match,
                                 float* partial, float* cost,
                                 cudaStream_t stream) {
  const int parts = blocks(m, COST_ROWS);
  mc_partial<<<dim3(parts, batch), 256, 0, stream>>>(xyz1, sq1, n, xyz2,
                                                     sq2, m, match, partial);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  mc_total<<<batch, 256, 0, stream>>>(partial, parts, cost);
  return (int)cudaGetLastError();
}

extern "C" int match_cost_grad_launch(const float* xyz1, int n,
                                      const float* xyz2, int m, int batch,
                                      const float* match, const float* g,
                                      float* grad1, float* grad2,
                                      cudaStream_t stream) {
  mc_grad1<<<dim3(blocks(n, 256), batch), 256, 0, stream>>>(
      xyz1, n, xyz2, m, match, g, grad1);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  mc_grad2<<<dim3(blocks(m, 8), batch), 256, 0, stream>>>(xyz1, n, xyz2, m,
                                                          match, g, grad2);
  return (int)cudaGetLastError();
}
