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
// 16 special-function results a clock per SM), and each design's floor:
//   K6a ~10 flops a pair (d once, a compare a direction), inputs and
//       outputs ~2 MB: operations, 0.015 ms at the protocol shape. Its
//       floor is issue slots, ~12 a pair (see its kernel): 0.036 ms.
//   K6b one exp a pair and level (10 levels, 1e9 at the protocol shape) on
//       the special-function units, and the 403 MB match written once
//       (see its kernels for its own design).
//   K6c, K6d one read of match (403 MB): bytes, 0.12 ms each. K6c's
//       arithmetic, ~15 issue slots a pair with an IEEE sqrt, is ~0.05 ms;
//       K6d's, ~21 with one rsqrtf and the rows' warp sums, ~0.063 ms.
// No kernel stores a [B,N,M] tensor other than match itself. Distances are
// recomputed from the coordinates in the JAX package's Gram form
// (|a|^2 - 2 a.b) + |b|^2 clamped at 0 (gram_d of dot3; K6d takes the
// direct difference, as the reference's gradient does). |a|^2 and |b|^2 are
// rounded as the plain versions' torch.sum(p * p, -1) rounds them on the
// card: K6a and K6c compute them (sq3), K6b takes them from the caller. So
// only a.b differs from the plain versions by rounding. Where a cloud is
// staged it is one float4 a point (-2x, -2y, -2z, |p|^2): -2 is a power of
// 2, so ((|a|^2 + a.(-2b)) + |b|^2) is gram_d's d to the bit. Every sum has
// a fixed order, a minimum is order-free, and no float atomics are used:
// two runs give the same bits. No tensor cores: the products have depth 3,
// and TF32 would not give gram_d's bits.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int LEVELS = 10;
__constant__ float kLevels[LEVELS] = {-16384.f, -4096.f, -1024.f, -256.f,
                                      -64.f, -16.f, -4.f, -1.f, -0.25f, 0.f};

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

// |p|^2 as torch.sum(p * p, -1) rounds it on the card: PyTorch's reduction
// gives an output of 3 inputs two lanes, the first summing elements 0 and
// 2, so (x^2 + z^2) + y^2, each step rounded (a GPU test holds the bits).
__device__ __forceinline__ float sq3(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(z, z)),
                   __fmul_rn(y, y));
}

// -2 * p and |p|^2 of point i of a cloud [.,3] with norms sq
__device__ __forceinline__ float4 am_stage(const float* __restrict__ xyz,
                                           const float* __restrict__ sq,
                                           size_t i) {
  return make_float4(-2.f * xyz[3 * i], -2.f * xyz[3 * i + 1],
                     -2.f * xyz[3 * i + 2], sq[i]);
}

// d of a point (x, y, z) of xyz1 with norm s1 and a staged point q of xyz2
// (row pass and match), or of a staged point q of xyz1 and a point of xyz2
// with norm s2 (column pass): the parent's gram_d(s1, s2, dot3(p1, p2)).
__device__ __forceinline__ float am_d_row(float x, float y, float z,
                                          float s1, float4 q) {
  const float ab2 = fmaf(z, q.z, fmaf(y, q.y, x * q.x));   // -2 a.b
  return fmaxf(__fadd_rn(__fadd_rn(s1, ab2), q.w), 0.f);
}
__device__ __forceinline__ float am_d_col(float x, float y, float z,
                                          float s2, float4 q) {
  const float ab2 = fmaf(z, q.z, fmaf(y, q.y, x * q.x));
  return fmaxf(__fadd_rn(__fadd_rn(q.w, ab2), s2), 0.f);
}

// am_stage with |p|^2 from sq3 (K6a and K6c take no norms)
__device__ __forceinline__ float4 stage(const float* __restrict__ xyz,
                                        size_t i) {
  const float x = xyz[3 * i], y = xyz[3 * i + 1], z = xyz[3 * i + 2];
  return make_float4(-2.f * x, -2.f * y, -2.f * z, sq3(x, y, z));
}

// ---------------------------------------------------------------- K6a ----
// One pass computes d once a pair and serves both directions: the minimum
// over the columns (points of xyz2) of each row (a point of xyz1: dist1,
// idx1) and over the rows of each column (dist2, idx2).
//
// Bound and floor: the bound counts ~10 flops a pair (0.015 ms at 24 x
// 2048 x 2048). A pair costs at least FMUL + 2 FFMA (a.(-2b)), 2 FADD and
// an FMNMX (the clamp) for d, then a compare and two selects for the row's
// running minimum and its index, and the same for the column's: ~12 issue
// slots, 0.036 ms at the f32 peak's clock (2.4x the bound).
//
// Design: a block holds NN_ROWS rows of xyz1 (a row panel) and walks a
// panel of at most NN_PANEL columns of xyz2, staged once in shared memory;
// grid (row panels, column panels, batch), the column panels cut narrower
// when B is small so that at least NN_TARGET_BLOCKS blocks fill the card.
// A warp holds NN_R rows in registers, the same in every lane, and its
// lanes take a tile's columns, NN_C each, with the row minima in registers
// across the whole panel and each column's minimum over the thread's rows
// taken per tile: a 2-D register tile, GEMM micro-tile style. Each shared
// load of a column serves NN_R pairs. The inner loop is ~13 instructions a
// pair (SASS); on an H100 the pass runs at ~60% of the floor, and panels of
// 512 columns, 8 rows and 4 columns a thread at 3 blocks a SM, 4 columns at
// 1 block, or blocks of 4 warps were no faster.
//
// Merging: a partial minimum is the 64-bit key (bits(d) << 32) | index;
// d >= 0 after the clamp (a -0 is made +0), so keys order as (d, index),
// and the least key is the lowest index among equal d, the plain version's
// tie rule (a thread takes its candidates in increasing index with a
// strict <, so it keeps the lowest of its own). A tile's column keys go to
// shared memory, one row a row group; after the panel a block takes the
// least key over its row groups (columns) and over its lanes (rows) and
// merges it into a [B, N+M] u64 scratch with atomicMin, which the launcher
// fills with all ones first. A minimum is exact and order-free, so two
// runs give the same bits; nn_unpack splits the keys into dist and idx.
constexpr int NN_R = 16;                    // rows a thread (and a warp)
constexpr int NN_C = 2;                     // columns a lane and tile
constexpr int NN_WARPS = 8;                 // row groups a block
constexpr int NN_THREADS = 32 * NN_WARPS;
constexpr int NN_ROWS = NN_WARPS * NN_R;    // 128 rows a block
constexpr int NN_TILE = 32 * NN_C;          // 64 columns a tile
constexpr int NN_PANEL = 1024;              // most columns a block
constexpr int NN_TARGET_BLOCKS = 2 * 132;   // two a SM of the H100
constexpr int NN_KEYS = NN_WARPS * NN_PANEL > 32 * (NN_ROWS + 1)
                            ? NN_WARPS * NN_PANEL
                            : 32 * (NN_ROWS + 1);

typedef unsigned long long u64;

__device__ __forceinline__ u64 nn_key(float d, int i) {
  return ((u64)(__float_as_uint(d) & 0x7fffffffu) << 32) | (unsigned)i;
}

// The dynamic shared memory of a block with a panel of `panel` columns: the
// staged columns, then the keys (by row group and column during the walk,
// by lane and row at the end).
inline size_t nn_smem(int panel) {
  return (size_t)panel * sizeof(float4) + (size_t)NN_KEYS * sizeof(u64);
}

__global__ void __launch_bounds__(NN_THREADS, 2)
nn_pass(const float* __restrict__ xyz1, int n, const float* __restrict__ xyz2,
        int m, int panel, u64* __restrict__ key1, u64* __restrict__ key2) {
  extern __shared__ float4 nn_shared[];
  float4* s_pt = nn_shared;                                  // [panel]
  u64* s_key = reinterpret_cast<u64*>(nn_shared + panel);    // [NN_KEYS]
  const int b = blockIdx.z, w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * NN_ROWS + w * NN_R;            // this warp's
  const int c0 = blockIdx.y * panel;
  const int cnt = min(panel, m - c0);
  const int tiles = (cnt + NN_TILE - 1) / NN_TILE;
  // columns past m: d = inf (|p|^2 = inf), never below a real d
  for (int j = threadIdx.x; j < tiles * NN_TILE; j += NN_THREADS)
    s_pt[j] = j < cnt ? stage(xyz2, (size_t)b * m + c0 + j)
                      : make_float4(0.f, 0.f, 0.f, INFINITY);
  // rows past n: the same
  float rx[NN_R], ry[NN_R], rz[NN_R], rs[NN_R], rb[NN_R];
  int ri[NN_R];
#pragma unroll
  for (int i = 0; i < NN_R; i++) {
    const int r = r0 + i;
    rx[i] = ry[i] = rz[i] = 0.f;
    rs[i] = INFINITY;
    if (r < n) {
      const float* p = xyz1 + 3 * ((size_t)b * n + r);
      rx[i] = p[0];
      ry[i] = p[1];
      rz[i] = p[2];
      rs[i] = sq3(rx[i], ry[i], rz[i]);
    }
    rb[i] = INFINITY;
    ri[i] = 0;
  }
  __syncthreads();
  for (int t = 0; t < tiles; t++) {
    float4 q[NN_C];
    int col[NN_C];
    float cb[NN_C];
    int ci[NN_C];
#pragma unroll
    for (int j = 0; j < NN_C; j++) {
      const int k = t * NN_TILE + j * 32 + lane;
      q[j] = s_pt[k];
      col[j] = c0 + k;
    }
#pragma unroll
    for (int i = 0; i < NN_R; i++) {
#pragma unroll
      for (int j = 0; j < NN_C; j++) {
        const float d = am_d_row(rx[i], ry[i], rz[i], rs[i], q[j]);
        if (d < rb[i]) {  // increasing column: the lowest index wins a tie
          rb[i] = d;
          ri[i] = col[j];
        }
        if (i == 0) {
          cb[j] = d;
          ci[j] = 0;
        } else if (d < cb[j]) {  // increasing row, likewise
          cb[j] = d;
          ci[j] = i;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NN_C; j++)
      s_key[w * panel + t * NN_TILE + j * 32 + lane] = nn_key(cb[j],
                                                              r0 + ci[j]);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < cnt; j += NN_THREADS) {
    u64 k = s_key[j];
#pragma unroll
    for (int g = 1; g < NN_WARPS; g++) k = min(k, s_key[g * panel + j]);
    atomicMin(key2 + (size_t)b * m + c0 + j, k);
  }
  __syncthreads();
  // the rows' keys by lane (a row of NN_ROWS + 1: no bank conflict between
  // lanes), then the least over the lanes
#pragma unroll
  for (int i = 0; i < NN_R; i++)
    s_key[lane * (NN_ROWS + 1) + w * NN_R + i] = nn_key(rb[i], ri[i]);
  __syncthreads();
  const int row = threadIdx.x, r = blockIdx.x * NN_ROWS + row;
  if (row < NN_ROWS && r < n) {
    u64 k = s_key[row];
    for (int l = 1; l < 32; l++) k = min(k, s_key[l * (NN_ROWS + 1) + row]);
    atomicMin(key1 + (size_t)b * n + r, k);
  }
}

// dist = the keys' high words as floats, idx = their low words: the first
// `split` keys to dist1 and idx1, the rest to dist2 and idx2
__global__ void __launch_bounds__(256)
nn_unpack(const u64* __restrict__ keys, size_t split, size_t count,
          float* __restrict__ dist1, int* __restrict__ idx1,
          float* __restrict__ dist2, int* __restrict__ idx2) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  const u64 k = keys[i];
  float* dist = i < split ? dist1 + i : dist2 + (i - split);
  int* idx = i < split ? idx1 + i : idx2 + (i - split);
  *dist = __uint_as_float((unsigned)(k >> 32));
  *idx = (int)(unsigned)k;
}

// For a test: sq3 of each point of a cloud [count, 3].
__global__ void __launch_bounds__(256)
norms_kernel(const float* __restrict__ xyz, size_t count,
             float* __restrict__ out) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < count) out[i] = sq3(xyz[3 * i], xyz[3 * i + 1], xyz[3 * i + 2]);
}

// ---------------------------------------------------------------- K6b ----
// The auction of the plain version (eval/metrics.approx_match_plain), per
// level k with e = exp(level_k * d):
//   row pass k     remain_l -= ratio_l[k-1] * sum_m e_{k-1} ratio_r[k-1]
//                  (clamped at 0; k > 0), ratio_l[k] = remain_l /
//                  (1e-9 + sum_m e_k remain_r)
//   column pass k  sumr = remain_r * sum_n e_k ratio_l[k];
//                  ratio_r[k] = min(remain_r / (sumr + 1e-9), 1) * remain_r;
//                  remain_r = max(remain_r - sumr, 0)
//   match          match[c][r] = sum_k e_k ratio_l[k][r] ratio_r[k][c]
// Three passes a level store no exps: each pass recomputes e from d.
//
// Numbers. d and every e are the plain version's f32 bits: d in its Gram
// order (gram_d of dot3), e = expf(level * d) (level * d is exact: the
// levels are powers of 2), which rounds as torch.exp does. No approximate
// exp, and none derived from another level's. The one skip is the last
// level, 0, where e is exactly 1. The auction's bookkeeping is float64:
// the row and column sums (each e * weight product is exact in f64), the
// epilogues, and the remainders and ratios carried between passes (the
// wrapper's scratch is f64). The match write rounds as the plain
// version's does, from the ratios rounded to f32. The auction amplifies
// rounding (at level -16384 a change delta in d moves e by ~16384 delta).
// Measured on the card (eval/referee.py, 56 clouds), an f32 bookkeeping
// lands up to 10x further from the float64 referee than the plain version
// does (FMA contraction in the epilogues, another sum order, ratios
// rounded between passes); with an f64 one every marginal and EMD stays
// within 1.53x of the plain version's distance. Sums have a fixed order
// (below): two runs give the same bits.
//
// What bounds it on the H100: the special-function units (16 results a
// clock per SM). A pair costs 36 expf (row passes 2 a level, column pass
// and match write 1, none at the last level) and 27 f32 -> f64 conversions for
// the sums on the same units, against the 9 exps a pair of the bound.
// What the design does about it: registers, not shared memory, carry the
// pairs. A thread holds AM_RPT points of its own cloud; the other cloud is
// staged a tile at a time in shared memory as one float4 a point (-2x, -2y,
// -2z, |p|^2: -2 is a power of 2, so ((|a|^2 + a.(-2b)) + |b|^2) is
// gram_d's d to the bit) and its weights as one wide f64 load, and each
// broadcast load serves AM_RPT rows. A block's AM_SPLIT warps take the
// other cloud's points j = w, w + AM_SPLIT, ... in order, and a row's total
// is the warps' partial sums added as a balanced tree in warp order.
constexpr int AM_RPT = 4;                      // rows a thread
constexpr int AM_SPLIT = 8;                    // warps a block
constexpr int AM_ROWS = 32 * AM_RPT;           // rows a block
constexpr int AM_THREADS = 32 * AM_SPLIT;
constexpr int AM_TILE = 512;                   // staged points of the other
constexpr int AM_MATCH_RPT = 2;                // match: rows a thread
constexpr int AM_MATCH_THREADS = 256;
constexpr int AM_MATCH_COLS = 8;               // match: columns a block

// a row's total of the AM_SPLIT warps' partials part[w][row]: a balanced
// tree in warp order
__device__ __forceinline__ double am_total(double (*part)[AM_ROWS],
                                           int row) {
  double t[AM_SPLIT];
#pragma unroll
  for (int w = 0; w < AM_SPLIT; w++) t[w] = part[w][row];
#pragma unroll
  for (int h = 1; h < AM_SPLIT; h <<= 1)
#pragma unroll
    for (int w = 0; w < AM_SPLIT; w += 2 * h) t[w] += t[w + h];
  return t[0];
}

// Row pass of level k over the points of xyz1, blockIdx.y = batch. PREV:
// k > 0 (the remain_l update from level k-1); EXP: k < LEVELS - 1.
template <bool PREV, bool EXP>
__global__ void __launch_bounds__(AM_THREADS)
am_row(const float* __restrict__ xyz1, const float* __restrict__ sq1, int n,
       const float* __restrict__ xyz2, const float* __restrict__ sq2, int m,
       int nb, int k, double multi_l, double multi_r,
       double* __restrict__ remain_l, const double* __restrict__ remain_r,
       double* __restrict__ ratio_l, const double* __restrict__ ratio_r) {
  __shared__ float4 s_pt[AM_TILE];
  __shared__ double2 s_w[AM_TILE];
  __shared__ double s_part[2][AM_SPLIT][AM_ROWS];
  const int b = blockIdx.y, w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * AM_ROWS;
  const float lev = kLevels[k], lev_prev = PREV ? kLevels[k - 1] : 0.f;
  float rx[AM_RPT], ry[AM_RPT], rz[AM_RPT], rs[AM_RPT];
  double cur[AM_RPT], prev[AM_RPT];
#pragma unroll
  for (int i = 0; i < AM_RPT; i++) {
    const int r = min(r0 + i * 32 + lane, n - 1);  // past n: a copy, unused
    const size_t g = (size_t)b * n + r;
    rx[i] = xyz1[3 * g];
    ry[i] = xyz1[3 * g + 1];
    rz[i] = xyz1[3 * g + 2];
    rs[i] = sq1[g];
    cur[i] = prev[i] = 0.0;
  }
  for (int t0 = 0; t0 < m; t0 += AM_TILE) {
    const int cnt = min(AM_TILE, m - t0);
    __syncthreads();
    for (int j = threadIdx.x; j < cnt; j += AM_THREADS) {
      const size_t g = (size_t)b * m + t0 + j;
      s_pt[j] = am_stage(xyz2, sq2, g);
      s_w[j] = make_double2(
          k > 0 ? remain_r[g] : multi_r,
          PREV ? ratio_r[(size_t)(k - 1) * nb * m + g] : 0.0);
    }
    __syncthreads();
#pragma unroll 4
    for (int j = w; j < cnt; j += AM_SPLIT) {
      const float4 q = s_pt[j];
      const double2 wt = s_w[j];
#pragma unroll
      for (int i = 0; i < AM_RPT; i++) {
        const float d = am_d_row(rx[i], ry[i], rz[i], rs[i], q);
        cur[i] = EXP ? fma((double)expf(lev * d), wt.x, cur[i])
                     : cur[i] + wt.x;
        if (PREV) prev[i] = fma((double)expf(lev_prev * d), wt.y, prev[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < AM_RPT; i++) {
    s_part[0][w][i * 32 + lane] = cur[i];
    if (PREV) s_part[1][w][i * 32 + lane] = prev[i];
  }
  __syncthreads();
  for (int row = threadIdx.x; row < AM_ROWS; row += AM_THREADS) {
    const int r = r0 + row;
    if (r >= n) break;
    const size_t g = (size_t)b * n + r;
    double rem = k > 0 ? remain_l[g] : multi_l;
    if (PREV)
      rem = fmax(rem - ratio_l[(size_t)(k - 1) * nb * n + g] *
                           am_total(s_part[1], row), 0.0);
    remain_l[g] = rem;
    ratio_l[(size_t)k * nb * n + g] = rem / (1e-9 + am_total(s_part[0], row));
  }
}

// Column pass of level k over the points of xyz2. EXP: k < LEVELS - 1.
template <bool EXP>
__global__ void __launch_bounds__(AM_THREADS)
am_col(const float* __restrict__ xyz1, const float* __restrict__ sq1, int n,
       const float* __restrict__ xyz2, const float* __restrict__ sq2, int m,
       int nb, int k, double multi_r, const double* __restrict__ ratio_l,
       double* __restrict__ remain_r, double* __restrict__ ratio_r) {
  __shared__ float4 s_pt[AM_TILE];
  __shared__ double s_w[AM_TILE];
  __shared__ double s_part[AM_SPLIT][AM_ROWS];
  const int b = blockIdx.y, w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c0 = blockIdx.x * AM_ROWS;
  const float lev = kLevels[k];
  const double* rl = ratio_l + (size_t)k * nb * n;
  float cx[AM_RPT], cy[AM_RPT], cz[AM_RPT], cs[AM_RPT];
  double acc[AM_RPT];
#pragma unroll
  for (int i = 0; i < AM_RPT; i++) {
    const int c = min(c0 + i * 32 + lane, m - 1);
    const size_t g = (size_t)b * m + c;
    cx[i] = xyz2[3 * g];
    cy[i] = xyz2[3 * g + 1];
    cz[i] = xyz2[3 * g + 2];
    cs[i] = sq2[g];
    acc[i] = 0.0;
  }
  for (int t0 = 0; t0 < n; t0 += AM_TILE) {
    const int cnt = min(AM_TILE, n - t0);
    __syncthreads();
    for (int j = threadIdx.x; j < cnt; j += AM_THREADS) {
      const size_t g = (size_t)b * n + t0 + j;
      s_pt[j] = am_stage(xyz1, sq1, g);
      s_w[j] = rl[g];
    }
    __syncthreads();
#pragma unroll 4
    for (int j = w; j < cnt; j += AM_SPLIT) {
      const float4 q = s_pt[j];
      const double wt = s_w[j];
#pragma unroll
      for (int i = 0; i < AM_RPT; i++)
        acc[i] = EXP ? fma((double)expf(lev * am_d_col(cx[i], cy[i], cz[i],
                                                       cs[i], q)),
                           wt, acc[i])
                     : acc[i] + wt;
    }
  }
#pragma unroll
  for (int i = 0; i < AM_RPT; i++) s_part[w][i * 32 + lane] = acc[i];
  __syncthreads();
  for (int row = threadIdx.x; row < AM_ROWS; row += AM_THREADS) {
    const int c = c0 + row;
    if (c >= m) break;
    const size_t g = (size_t)b * m + c;
    const double rem = k > 0 ? remain_r[g] : multi_r;
    const double sumr = am_total(s_part, row) * rem;
    ratio_r[(size_t)k * nb * m + g] = fmin(rem / (sumr + 1e-9), 1.0) * rem;
    remain_r[g] = fmax(rem - sumr, 0.0);
  }
}

// match[b][c][r] = sum_k (e_k ratio_l[k][r]) ratio_r[k][c] in f32, in
// level order, each product and sum rounded as the plain version's, from
// the f64 ratios rounded to f32 once. Threads run along r (the fastest axis
// of match), AM_MATCH_RPT rows a thread; a block covers AM_MATCH_COLS
// columns c (blockIdx.y), blockIdx.z = batch.
__global__ void __launch_bounds__(AM_MATCH_THREADS)
am_match(const float* __restrict__ xyz1, const float* __restrict__ sq1,
         int n, const float* __restrict__ xyz2,
         const float* __restrict__ sq2, int m, int nb,
         const double* __restrict__ ratio_l,
         const double* __restrict__ ratio_r, float* __restrict__ match) {
  __shared__ float4 s_pt[AM_MATCH_COLS];
  __shared__ float s_rr[AM_MATCH_COLS][LEVELS];
  const int b = blockIdx.z;
  const int c0 = blockIdx.y * AM_MATCH_COLS;
  const int ncol = min(AM_MATCH_COLS, m - c0);
  for (int i = threadIdx.x; i < ncol * (1 + LEVELS); i += AM_MATCH_THREADS) {
    const int col = i / (1 + LEVELS), f = i % (1 + LEVELS);
    const size_t g = (size_t)b * m + c0 + col;
    if (f == 0)
      s_pt[col] = am_stage(xyz2, sq2, g);
    else
      s_rr[col][f - 1] = (float)ratio_r[(size_t)(f - 1) * nb * m + g];
  }
  __syncthreads();
  const int rbase = blockIdx.x * AM_MATCH_THREADS * AM_MATCH_RPT +
                    threadIdx.x;
  float rx[AM_MATCH_RPT], ry[AM_MATCH_RPT], rz[AM_MATCH_RPT],
      rs[AM_MATCH_RPT], rl[AM_MATCH_RPT][LEVELS];
#pragma unroll
  for (int i = 0; i < AM_MATCH_RPT; i++) {
    const int r = min(rbase + i * AM_MATCH_THREADS, n - 1);
    const size_t g = (size_t)b * n + r;
    rx[i] = xyz1[3 * g];
    ry[i] = xyz1[3 * g + 1];
    rz[i] = xyz1[3 * g + 2];
    rs[i] = sq1[g];
#pragma unroll
    for (int k = 0; k < LEVELS; k++)
      rl[i][k] = (float)ratio_l[(size_t)k * nb * n + g];
  }
  for (int col = 0; col < ncol; col++) {
    const float4 q = s_pt[col];
#pragma unroll
    for (int i = 0; i < AM_MATCH_RPT; i++) {
      const float d = am_d_row(rx[i], ry[i], rz[i], rs[i], q);
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < LEVELS - 1; k++)
        acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(expf(kLevels[k] * d),
                                                 rl[i][k]),
                                       s_rr[col][k]));
      acc = __fadd_rn(acc, __fmul_rn(rl[i][LEVELS - 1],               // e = 1
                                     s_rr[col][LEVELS - 1]));
      const int r = rbase + i * AM_MATCH_THREADS;
      if (r < n) match[((size_t)b * m + c0 + col) * n + r] = acc;
    }
  }
}

// For a test: d of the pairs of xyz1's first min(n, AM_ROWS) points and
// xyz2's first min(m, AM_TILE), [rows, cols] each, from the row pass's and
// the match's form (out[0]), the column pass's (out[1]), and gram_d of
// dot3 as K6a and K6c compute it (out[2]).
__global__ void __launch_bounds__(AM_THREADS)
am_d_tile(const float* __restrict__ xyz1, const float* __restrict__ sq1,
          int n, const float* __restrict__ xyz2,
          const float* __restrict__ sq2, int m, float* __restrict__ out) {
  const int rows = min(n, AM_ROWS), cols = min(m, AM_TILE);
  const size_t plane = (size_t)rows * cols;
  for (int p = threadIdx.x; p < rows * cols; p += AM_THREADS) {
    const int r = p / cols, c = p % cols;
    const float4 q2 = am_stage(xyz2, sq2, c), q1 = am_stage(xyz1, sq1, r);
    out[p] = am_d_row(xyz1[3 * r], xyz1[3 * r + 1], xyz1[3 * r + 2], sq1[r],
                      q2);
    out[plane + p] = am_d_col(xyz2[3 * c], xyz2[3 * c + 1], xyz2[3 * c + 2],
                              sq2[c], q1);
    out[2 * plane + p] = gram_d(
        sq1[r], sq2[c],
        dot3(xyz1[3 * r], xyz1[3 * r + 1], xyz1[3 * r + 2], xyz2[3 * c],
             xyz2[3 * c + 1], xyz2[3 * c + 2]));
  }
}

// ---------------------------------------------------------------- K6c ----
// cost[b] = sum over c, r of match[b][c][r] * sqrt(d(xyz2_c, xyz1_r)): the
// plain version's _pairwise_sqdist(xyz2, xyz1), so the xyz2 point comes
// first (am_d_col with xyz2 staged).
//
// Bound and floor: bytes, the 403 MB of match read once at the protocol
// shape, 0.12 ms; the arithmetic (d as in K6a, an IEEE sqrt, an FFMA,
// ~15 issue slots a pair) is ~0.05 ms under it.
//
// Design: a stream of 16-byte loads. A thread owns 4 consecutive points r
// of xyz1 in registers (x, y, z, |p|^2 each) and a block of MC_THREADS
// threads the 4 * MC_THREADS points of a column chunk; a block walks
// MC_ROWS rows c of match, whose xyz2 points are staged in shared memory
// (-2x, -2y, -2z, |c|^2) and read as broadcasts, and reads one float4 of
// a row a thread, MC_UNROLL rows in flight (streaming loads: match is read
// once; on the card 4 read faster than 8 or 16, whose registers leave
// fewer blocks a SM, and than prefetching before the staging or 256-thread
// blocks). Grid (column chunks, row chunks, batch). When n % 4 != 0 (rows do
// not start on 16 bytes) or match is not 16-byte aligned, the same walk
// reads four scalars a row. IEEE sqrt (__fsqrt_rn), as torch.sqrt.
//
// Sums: a row's 4 terms in f32 (an FFMA chain), then f64 across the rows,
// a block's threads in a fixed tree (mc_block_sum), the blocks of a batch
// in a fixed order by mc_total in the same library call. No float atomics:
// two runs give the same bits.
constexpr int MC_THREADS = 128;                // points r: 4 a thread
constexpr int MC_ROWS = 64;                    // rows c a block
constexpr int MC_UNROLL = 4;                   // rows in flight a thread

// a block's total of one double a thread: a fixed tree (valid in thread 0)
__device__ __forceinline__ double mc_block_sum(double v, double* red) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  double t = 0.0;
  if (threadIdx.x == 0)
    for (int w = 0; w < (int)(blockDim.x >> 5); w++) t += red[w];
  return t;
}

// sum_k v_k * sqrt(d(q, p_k)) of one row's four entries, in f32
__device__ __forceinline__ float mc_row(float4 v, float4 q, const float* px,
                                        const float* py, const float* pz,
                                        const float* ps) {
  const float e[4] = {v.x, v.y, v.z, v.w};
  float t = 0.f;
#pragma unroll
  for (int k = 0; k < 4; k++)
    t = fmaf(e[k], __fsqrt_rn(am_d_col(px[k], py[k], pz[k], ps[k], q)), t);
  return t;
}

template <bool VEC>
__device__ __forceinline__ float4 mc_load(const float* p, int left) {
  if (VEC) return __ldcs(reinterpret_cast<const float4*>(p));
  return make_float4(left > 0 ? __ldcs(p) : 0.f,
                     left > 1 ? __ldcs(p + 1) : 0.f,
                     left > 2 ? __ldcs(p + 2) : 0.f,
                     left > 3 ? __ldcs(p + 3) : 0.f);
}

// part[b][blockIdx.y][blockIdx.x] = a block's share of cost[b]. VEC: n % 4
// == 0 and match 16-byte aligned.
template <bool VEC>
__global__ void __launch_bounds__(MC_THREADS)
mc_pass(const float* __restrict__ xyz1, int n, const float* __restrict__ xyz2,
        int m, const float* __restrict__ match, double* __restrict__ part) {
  __shared__ float4 s_pt[MC_ROWS];
  __shared__ double red[MC_THREADS / 32];
  const int b = blockIdx.z, c0 = blockIdx.y * MC_ROWS;
  const int rows = min(MC_ROWS, m - c0);
  const int r0 = (blockIdx.x * MC_THREADS + threadIdx.x) * 4;
  for (int j = threadIdx.x; j < rows; j += MC_THREADS)
    s_pt[j] = stage(xyz2, (size_t)b * m + c0 + j);
  // points past n: zeros (their entries of match read as 0)
  float px[4], py[4], pz[4], ps[4];
#pragma unroll
  for (int k = 0; k < 4; k++) {
    px[k] = py[k] = pz[k] = ps[k] = 0.f;
    if (r0 + k < n) {
      const float* p = xyz1 + 3 * ((size_t)b * n + r0 + k);
      px[k] = p[0];
      py[k] = p[1];
      pz[k] = p[2];
      ps[k] = sq3(px[k], py[k], pz[k]);
    }
  }
  __syncthreads();
  double acc = 0.0;
  if (r0 < n) {
    const int left = n - r0;
    const float* row = match + ((size_t)b * m + c0) * n + r0;
    int j = 0;
    for (; j + MC_UNROLL <= rows; j += MC_UNROLL) {
      float4 v[MC_UNROLL];
#pragma unroll
      for (int u = 0; u < MC_UNROLL; u++)
        v[u] = mc_load<VEC>(row + (size_t)(j + u) * n, left);
#pragma unroll
      for (int u = 0; u < MC_UNROLL; u++)
        acc += (double)mc_row(v[u], s_pt[j + u], px, py, pz, ps);
    }
    for (; j < rows; j++)
      acc += (double)mc_row(mc_load<VEC>(row + (size_t)j * n, left), s_pt[j],
                            px, py, pz, ps);
  }
  const double t = mc_block_sum(acc, red);
  if (threadIdx.x == 0)
    part[((size_t)b * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x] = t;
}

// cost[b] = the sum of batch b's `parts` block shares, in a fixed order
__global__ void __launch_bounds__(256)
mc_total(const double* __restrict__ part, int parts,
         float* __restrict__ cost) {
  __shared__ double red[8];
  const int b = blockIdx.x;
  double acc = 0.0;
  for (int i = threadIdx.x; i < parts; i += blockDim.x)
    acc += part[(size_t)b * parts + i];
  const double t = mc_block_sum(acc, red);
  if (threadIdx.x == 0) cost[b] = (float)t;
}

// ---------------------------------------------------------------- K6d ----
// match_cost's gradient with match held constant (match_cost_grad_plain,
// the reference's MatchCostGrad):
//   grad1[b][r] =  g[b] * sum_c match[b][c][r] * unit(x1_r - x2_c)
//   grad2[b][c] = -g[b] * sum_r match[b][c][r] * unit(x1_r - x2_c)
//   unit(d) = d / max(|d|, 1e-12)
//
// Bound and floor: bytes, the 403 MB of match read once at the protocol
// shape, 0.121 ms. A pair costs 3 FSUB, 5 for |d|^2 in the plain version's
// order ((dx^2 + dy^2) + dz^2, each step rounded), the clamp, one MUFU
// reciprocal square root, w = match * that, 2 x 3 FFMA, and a quarter of a
// global and of a shared load: ~17.5 issue slots; the rows' warp sums (18
// SHFL, 18 FADD and 18 selects a thread for 4 rows, 16 pairs) add ~3.4 and
// the chunk sums ~0.2: ~21 a pair, 0.063 ms at half the f32 flop peak,
// under the bytes. On an H100 (700 W) the pass takes 0.146 ms by the
// profiler (83% of the bound; K6c's 0.133). Both kernels back to back
// there: a shuffle butterfly a row (60 SHFL + 60 FADD for 4 rows) and one
// f32 chain over the panel 0.191 ms, with entries at 2.01x the plain
// version's distance from the float64 referee (8.1x where N = 1); halving
// and chunks 0.180; the next group's loads issued before this group's
// arithmetic 0.155, and 6 blocks a SM (80 registers against 96) 0.149;
// 256-thread blocks no faster.
//
// Design: K6c's stream with two sums. A thread owns 4 consecutive points
// r of xyz1 in registers and their grad1 sums; a block walks MG_ROWS rows
// c of match (a panel), whose xyz2 points it stages in shared memory, and
// reads a float4 of a row a thread, MC_UNROLL rows at a time, the next
// group's loads issued before this group is used (mc_load's scalar walk
// when n % 4 != 0 or match is not 16-byte aligned). A pair
// takes d once, |d|^2, one rsqrtf of max(|d|^2, 1e-24) (1 / max(|d|,
// 1e-12); a zero d gives a zero term, and a denormal |d|^2 meets the clamp
// as it is: the build has no -ftz) and w = match * that; w * d goes to the
// point's grad1 sum and to the row's sum. (__frsqrt_rn, correctly rounded,
// was 12% slower on an H100 and no closer to the referee.) The rows' sums
// over the thread's 4 points are reduced across the warp four rows at a
// time (mg_warp_rows), then across the block's warps through shared memory
// in warp order: the block's share of grad2 from its strip of 4 *
// MG_THREADS points.
//
// Sums: f32 inside a block (a point's share: FFMA chains of MG_CHUNK rows,
// added up over the panel); the shares go to f32 scratch, [B, panels, N,
// 3] for grad1 and [B, strips, M, 3] for grad2 (5.9% of match's bytes at
// the protocol shape, written and read), and mc_grad_total, in the same
// library call, sums them in f64 in a fixed order and applies g[b] and
// -g[b]. No float atomics: two runs give the same bits. The float64 referee
// (eval/referee.py) holds the result to 2x the plain version's distance.
constexpr int MG_THREADS = 128;                // points r: 4 a thread
constexpr int MG_ROWS = 128;                   // rows c a block (a panel)
constexpr int MG_CHUNK = 16;                   // rows a grad1 chunk sum
constexpr int MG_WARPS = MG_THREADS / 32;
static_assert(MC_UNROLL == 4, "mg_warp_rows reduces four rows at a time");
static_assert(MG_ROWS % MG_CHUNK == 0 && MG_CHUNK % MC_UNROLL == 0,
              "a panel is whole chunks of whole groups");

// one row's four pairs: w * (x1_r - x2_c) added to each point's sum (gx,
// gy, gz) and to the row's (row), w = match / max(|x1_r - x2_c|, 1e-12)
__device__ __forceinline__ void mg_row(float4 v, float4 q, const float* px,
                                       const float* py, const float* pz,
                                       float* gx, float* gy, float* gz,
                                       float* row) {
  const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; k++) {
    const float dx = __fsub_rn(px[k], q.x), dy = __fsub_rn(py[k], q.y),
                dz = __fsub_rn(pz[k], q.z);
    const float s = __fadd_rn(
        __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
    const float w = __fmul_rn(e[k], rsqrtf(fmaxf(s, 1e-24f)));
    gx[k] = fmaf(w, dx, gx[k]);
    gy[k] = fmaf(w, dy, gy[k]);
    gz[k] = fmaf(w, dz, gz[k]);
    row[0] = fmaf(w, dx, row[0]);
    row[1] = fmaf(w, dy, row[1]);
    row[2] = fmaf(w, dz, row[2]);
  }
}

// row j of the panel, the thread's 4 entries (zeros past n and past the
// panel's last row)
template <bool VEC>
__device__ __forceinline__ float4 mg_load(const float* row, int j, int rows,
                                          int n, int left) {
  return left > 0 && j < rows ? mc_load<VEC>(row + (size_t)j * n, left)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
}

// The thread's sums r[u] of rows j + u (u < 4) summed across the warp by
// recursive halving: a lane gives the lane 16 apart half of its values
// (two rows) and adds the other half it gets back, then likewise a row
// with the lane 8 apart, and the 8 lanes then holding row u = lane >> 3
// finish with a butterfly over 4, 2, 1 (every one with the same bits);
// lane 8u writes row j + u's sums to s_row[warp]. 18 shuffles for 4 rows
// against 60 for a butterfly a row, in a fixed order.
__device__ __forceinline__ void mg_warp_rows(const float (&r)[4][3],
                                             float* s_row, int j) {
  const int lane = threadIdx.x & 31;
  const bool h16 = lane & 16, h8 = lane & 8;
  float a[6], c[3];
#pragma unroll
  for (int i = 0; i < 6; i++) {
    const float lo = r[i / 3][i % 3], hi = r[2 + i / 3][i % 3];
    a[i] = (h16 ? hi : lo) + __shfl_xor_sync(0xffffffffu, h16 ? lo : hi, 16);
  }
#pragma unroll
  for (int i = 0; i < 3; i++)
    c[i] = (h8 ? a[3 + i] : a[i]) +
           __shfl_xor_sync(0xffffffffu, h8 ? a[i] : a[3 + i], 8);
#pragma unroll
  for (int off = 4; off > 0; off >>= 1)
#pragma unroll
    for (int i = 0; i < 3; i++)
      c[i] += __shfl_xor_sync(0xffffffffu, c[i], off);
  if ((lane & 7) == 0) {
    float* o = s_row + ((threadIdx.x >> 5) * MG_ROWS + j + (lane >> 3)) * 3;
    o[0] = c[0];
    o[1] = c[1];
    o[2] = c[2];
  }
}

// The block's shares: part1[b][blockIdx.y][r] (its panel's sum for each of
// its points r) and part2[b][blockIdx.x][c] (its strip's sum for each row
// c of its panel). VEC: n % 4 == 0 and match 16-byte aligned; its walk
// is held to 80 registers, 6 blocks a SM (the scalar walk would spill).
template <bool VEC>
__global__ void __launch_bounds__(MG_THREADS, VEC ? 6 : 1)
mc_grad_pass(const float* __restrict__ xyz1, int n,
             const float* __restrict__ xyz2, int m,
             const float* __restrict__ match, float* __restrict__ part1,
             float* __restrict__ part2) {
  __shared__ float4 s_pt[MG_ROWS];
  __shared__ float s_row[MG_WARPS * MG_ROWS * 3];
  const int b = blockIdx.z, c0 = blockIdx.y * MG_ROWS;
  const int rows = min(MG_ROWS, m - c0);
  const int r0 = (blockIdx.x * MG_THREADS + threadIdx.x) * 4;
  // rows past the panel's last: zeros, whose entries read as 0
  for (int j = threadIdx.x; j < MG_ROWS; j += MG_THREADS) {
    const float* q = xyz2 + 3 * ((size_t)b * m + c0 + j);
    s_pt[j] = j < rows ? make_float4(q[0], q[1], q[2], 0.f)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  // points past n: zeros, whose entries of match read as 0 (zero terms)
  float px[4], py[4], pz[4], gx[4], gy[4], gz[4];
#pragma unroll
  for (int k = 0; k < 4; k++) {
    px[k] = py[k] = pz[k] = gx[k] = gy[k] = gz[k] = 0.f;
    if (r0 + k < n) {
      const float* p = xyz1 + 3 * ((size_t)b * n + r0 + k);
      px[k] = p[0];
      py[k] = p[1];
      pz[k] = p[2];
    }
  }
  __syncthreads();
  // every lane takes part in the warp sums, those past n with zero terms;
  // a point's share is summed in chunks of MG_CHUNK rows (f32 chains of 16
  // and of panel / 16 terms, not one of the whole panel)
  const int left = n - r0;
  const float* row = match + ((size_t)b * m + c0) * n + r0;
  // the next group's rows are loaded before this group's are used
  float4 v[MC_UNROLL];
#pragma unroll
  for (int u = 0; u < MC_UNROLL; u++)
    v[u] = mg_load<VEC>(row, u, rows, n, left);
  for (int j0 = 0; j0 < rows; j0 += MG_CHUNK) {
    float cx[4] = {0.f, 0.f, 0.f, 0.f}, cy[4] = {0.f, 0.f, 0.f, 0.f},
          cz[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 1
    for (int j = j0; j < min(j0 + MG_CHUNK, rows); j += MC_UNROLL) {
      float4 next[MC_UNROLL];
#pragma unroll
      for (int u = 0; u < MC_UNROLL; u++)
        next[u] = mg_load<VEC>(row, j + MC_UNROLL + u, rows, n, left);
      float r[MC_UNROLL][3] = {};
#pragma unroll
      for (int u = 0; u < MC_UNROLL; u++)
        mg_row(v[u], s_pt[j + u], px, py, pz, cx, cy, cz, r[u]);
      mg_warp_rows(r, s_row, j);
#pragma unroll
      for (int u = 0; u < MC_UNROLL; u++) v[u] = next[u];
    }
#pragma unroll
    for (int k = 0; k < 4; k++) {
      gx[k] += cx[k];
      gy[k] += cy[k];
      gz[k] += cz[k];
    }
  }
  __syncthreads();
  float* p2 = part2 + (((size_t)b * gridDim.x + blockIdx.x) * m + c0) * 3;
  for (int i = threadIdx.x; i < rows * 3; i += MG_THREADS) {
    float t = s_row[i];
#pragma unroll
    for (int w = 1; w < MG_WARPS; w++) t += s_row[w * MG_ROWS * 3 + i];
    p2[i] = t;
  }
  float* p1 = part1 + (((size_t)b * gridDim.y + blockIdx.y) * n + r0) * 3;
#pragma unroll
  for (int k = 0; k < 4; k++)
    if (r0 + k < n) {
      p1[3 * k] = gx[k];
      p1[3 * k + 1] = gy[k];
      p1[3 * k + 2] = gz[k];
    }
}

// grad1 = g[b] * the sum of an entry's `panels` shares, grad2 = -g[b] *
// the sum of its `strips` shares: f64 in share order, rounded once; a
// thread an entry of grad1, then of grad2.
__global__ void __launch_bounds__(256)
mc_grad_total(const float* __restrict__ part1,
              const float* __restrict__ part2, int n, int m, int batch,
              int panels, int strips, const float* __restrict__ g,
              float* __restrict__ grad1, float* __restrict__ grad2) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t e1 = (size_t)3 * n, e2 = (size_t)3 * m;
  const bool first = i < batch * e1;
  const size_t j = first ? i : i - batch * e1, e = first ? e1 : e2;
  if (j >= batch * e) return;
  const size_t b = j / e;
  const int parts = first ? panels : strips;
  const float* p = (first ? part1 : part2) + b * parts * e + (j - b * e);
  double s = 0.0;
  for (int k = 0; k < parts; k++) s += (double)p[k * e];
  const double gb = g[b];
  if (first)
    grad1[j] = (float)(gb * s);
  else
    grad2[j] = (float)(-gb * s);
}

inline int blocks(int count, int per) { return (count + per - 1) / per; }

}  // namespace

// Each entry point launches on `stream`, checks every launch and returns
// its CUDA error code (0 on success). The caller allocates every buffer.

// keys [B*(n+m)] is u64 scratch; dist1, idx1 are [B,n], dist2, idx2 [B,m].
extern "C" int nn_distance_launch(const float* xyz1, int n, const float* xyz2,
                                  int m, int batch, u64* keys, float* dist1,
                                  int* idx1, float* dist2, int* idx2,
                                  cudaStream_t stream) {
  static const int attr = (int)cudaFuncSetAttribute(
      nn_pass, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)nn_smem(NN_PANEL));
  if (attr) return attr;
  const size_t count = (size_t)batch * (n + m);
  int err = (int)cudaMemsetAsync(keys, 0xff, count * sizeof(u64), stream);
  if (err) return err;
  // column panels: as few as NN_PANEL allows, more while the grid has
  // fewer than NN_TARGET_BLOCKS blocks, each a whole number of tiles
  const int rp = blocks(n, NN_ROWS);
  const int want = blocks(NN_TARGET_BLOCKS, rp * batch);
  const int parts = std::max(blocks(m, NN_PANEL),
                             std::min(want, blocks(m, NN_TILE)));
  const int panel = blocks(blocks(m, parts), NN_TILE) * NN_TILE;
  nn_pass<<<dim3(rp, blocks(m, panel), batch), NN_THREADS, nn_smem(panel),
            stream>>>(xyz1, n, xyz2, m, panel, keys,
                      keys + (size_t)batch * n);
  err = (int)cudaGetLastError();
  if (err) return err;
  nn_unpack<<<(unsigned)((count + 255) / 256), 256, 0, stream>>>(
      keys, (size_t)batch * n, count, dist1, idx1, dist2, idx2);
  return (int)cudaGetLastError();
}

// out [count]: sq3 of each point of xyz [count, 3] (for a test)
extern "C" int cloud_norms(const float* xyz, int count, float* out,
                           cudaStream_t stream) {
  norms_kernel<<<blocks(count, 256), 256, 0, stream>>>(xyz, count, out);
  return (int)cudaGetLastError();
}

// remain_l [B,n], remain_r [B,m], ratio_l [LEVELS,B,n] and ratio_r
// [LEVELS,B,m] are f64 scratch; multi_l and multi_r are the starting
// masses; match is [B,m,n].
extern "C" int approx_match_launch(const float* xyz1, const float* sq1,
                                   int n, const float* xyz2,
                                   const float* sq2, int m, int batch,
                                   double multi_l, double multi_r,
                                   double* remain_l, double* remain_r,
                                   double* ratio_l, double* ratio_r,
                                   float* match, cudaStream_t stream) {
  const dim3 grow(blocks(n, AM_ROWS), batch), gcol(blocks(m, AM_ROWS), batch);
  for (int k = 0; k < LEVELS; k++) {
    const bool last = k == LEVELS - 1;
    if (k == 0)
      am_row<false, true><<<grow, AM_THREADS, 0, stream>>>(
          xyz1, sq1, n, xyz2, sq2, m, batch, k, multi_l, multi_r, remain_l,
          remain_r, ratio_l, ratio_r);
    else if (!last)
      am_row<true, true><<<grow, AM_THREADS, 0, stream>>>(
          xyz1, sq1, n, xyz2, sq2, m, batch, k, multi_l, multi_r, remain_l,
          remain_r, ratio_l, ratio_r);
    else
      am_row<true, false><<<grow, AM_THREADS, 0, stream>>>(
          xyz1, sq1, n, xyz2, sq2, m, batch, k, multi_l, multi_r, remain_l,
          remain_r, ratio_l, ratio_r);
    int err = (int)cudaGetLastError();
    if (err) return err;
    if (!last)
      am_col<true><<<gcol, AM_THREADS, 0, stream>>>(
          xyz1, sq1, n, xyz2, sq2, m, batch, k, multi_r, ratio_l, remain_r,
          ratio_r);
    else
      am_col<false><<<gcol, AM_THREADS, 0, stream>>>(
          xyz1, sq1, n, xyz2, sq2, m, batch, k, multi_r, ratio_l, remain_r,
          ratio_r);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  const dim3 gm(blocks(n, AM_MATCH_THREADS * AM_MATCH_RPT),
                blocks(m, AM_MATCH_COLS), batch);
  am_match<<<gm, AM_MATCH_THREADS, 0, stream>>>(
      xyz1, sq1, n, xyz2, sq2, m, batch, ratio_l, ratio_r, match);
  return (int)cudaGetLastError();
}

// out [3, min(n, 128), min(m, 512)]: see am_d_tile (one cloud pair).
extern "C" int approx_match_d_tile(const float* xyz1, const float* sq1,
                                   int n, const float* xyz2,
                                   const float* sq2, int m, float* out,
                                   cudaStream_t stream) {
  am_d_tile<<<1, AM_THREADS, 0, stream>>>(xyz1, sq1, n, xyz2, sq2, m, out);
  return (int)cudaGetLastError();
}

inline dim3 mc_grid(int n, int m, int batch) {
  return dim3(blocks(n, 4 * MC_THREADS), blocks(m, MC_ROWS), batch);
}

// the f64 scratch match_cost_launch takes: doubles a batch
extern "C" int match_cost_parts(int n, int m) {
  const dim3 g = mc_grid(n, m, 1);
  return (int)(g.x * g.y);
}

// part is [B, match_cost_parts(n, m)] f64 scratch; cost is [B].
extern "C" int match_cost_launch(const float* xyz1, int n, const float* xyz2,
                                 int m, int batch, const float* match,
                                 double* part, float* cost,
                                 cudaStream_t stream) {
  const dim3 grid = mc_grid(n, m, batch);
  if (n % 4 == 0 && reinterpret_cast<uintptr_t>(match) % 16 == 0)
    mc_pass<true><<<grid, MC_THREADS, 0, stream>>>(xyz1, n, xyz2, m, match,
                                                   part);
  else
    mc_pass<false><<<grid, MC_THREADS, 0, stream>>>(xyz1, n, xyz2, m, match,
                                                    part);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  mc_total<<<batch, 256, 0, stream>>>(part, (int)(grid.x * grid.y), cost);
  return (int)cudaGetLastError();
}

inline dim3 mg_grid(int n, int m, int batch) {
  return dim3(blocks(n, 4 * MG_THREADS), blocks(m, MG_ROWS), batch);
}

// the f32 scratch match_cost_grad_launch takes: floats a batch entry
extern "C" int match_cost_grad_parts(int n, int m) {
  const dim3 g = mg_grid(n, m, 1);
  return 3 * (int)(g.y * n + g.x * m);
}

// part is [B * match_cost_grad_parts(n, m)] f32 scratch (the grad1 shares
// of every batch entry, then the grad2 shares); g is [B]; grad1 [B,n,3],
// grad2 [B,m,3].
extern "C" int match_cost_grad_launch(const float* xyz1, int n,
                                      const float* xyz2, int m, int batch,
                                      const float* match, const float* g,
                                      float* part, float* grad1,
                                      float* grad2, cudaStream_t stream) {
  const dim3 grid = mg_grid(n, m, batch);
  float* part1 = part;
  float* part2 = part + (size_t)batch * grid.y * n * 3;
  if (n % 4 == 0 && reinterpret_cast<uintptr_t>(match) % 16 == 0)
    mc_grad_pass<true><<<grid, MG_THREADS, 0, stream>>>(xyz1, n, xyz2, m,
                                                        match, part1, part2);
  else
    mc_grad_pass<false><<<grid, MG_THREADS, 0, stream>>>(
        xyz1, n, xyz2, m, match, part1, part2);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  const size_t count = (size_t)batch * 3 * ((size_t)n + m);
  mc_grad_total<<<(unsigned)((count + 255) / 256), 256, 0, stream>>>(
      part1, part2, n, m, batch, (int)grid.y, (int)grid.x, g, grad1, grad2);
  return (int)cudaGetLastError();
}
