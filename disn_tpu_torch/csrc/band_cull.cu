// K4: the band cull of the sparse pass's coarse grid, on Hopper (sm_90a).
//
// Replaces disn_tpu/infer/sparse.py::_band_tau (:113) and ::_active_cells
// (:67), XLA code the JAX package wrote for the TPU (a hundred-odd small
// ops there and in the port's plain version: seven direction passes of
// slices, masks and maxima, the 8-corner stack, a cumsum and a scatter).
// On the coarse grid vol [rc, rc, rc] f32, axes (z, y, x):
//   - tau = band_factor x the cell diagonal of the box; with autocal,
//     times max(1, lip), lip the largest near-band slope over 7 directions
//     (3 axes, 4 space diagonals), a step counted where min(|a|, |b|) <
//     4 tau + 2 min|v|;
//   - the active cells (flat over c^3, c = rc - 1) whose corners hold a
//     |v| < tau or disagree in sign (mode band), or whose 27 neighbours
//     (themselves included) hold a sign change (mode sign), ascending; ids
//     past `cap` are dropped while the count counts them, and the count is
//     written on the card.
// One kernel serves three entries (ops/band_cull.py): tau alone, the cull
// alone (tau read on the card), and both in one launch.
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
//     NaN, as torch's do; a corner compares < 0 and >= 0, so -0.0 counts
//     as not negative and NaN as neither. In the slope pass a NaN step is
//     never near the band, so fmaxf (which drops a NaN) gives the plain
//     version's maxima; a cell's min |v| is min.NaN (NaN if a corner is).
// Minima and maxima are exact in any order, so the cross-CTA reductions
// are deterministic; the ids are ranked by counts, with no atomics.
//
// What bounds it on the H100 (3.35 TB/s): bytes by the count (the 65^3
// grid read once, 1.1 MB, 0.33 us; tau, the ids and the count written),
// in practice launch latency and the 16 SMs one cluster has. What the
// design does about it: one launch of one thread-block cluster of 16 CTAs
// of 1,024 threads (8, the portable size, measured 1.5x slower), no
// global scratch, no atomics, nothing to reset; every phase reads the grid
// through L2 (1.1 MB of its 50 MB), one code path for every rc (rc >= 2,
// rc^3 < 2^31).
//   A  min|v| over each CTA's point planes; cluster barrier; every CTA
//      reduces the posted minima through distributed shared memory.
//   B  the 7 directions' masked max |b - a|: warps walk z down 30-point
//      segments of a plane (lanes on consecutive points, the x neighbours
//      by shuffles, 3 loads a point and step; a step whose warp holds no
//      value near the band is skipped whole); the top plane's segments
//      spread over the cluster; cluster barrier; the maxima reduced the
//      same way.
//   C  tau, in every CTA.
//   D  per round, each CTA a slab of `zr` cell planes (the wrapper's
//      plan): warps walk z down 31-cell segments (band: a cell from its
//      2 x 2 corner pairs, the x + 1 pair by a shuffle, 2 loads a cell
//      and step) or 29-cell ones (sign: the sign-change bits of 3 cell
//      rows from 4 point rows, dilated in x by shuffles and in z along the
//      walk: no 64-load window a cell), count the active cells of each
//      (plane, warp) into shared memory and keep each lane's activity
//      bits (64 at most) in a register; the CTA scans the counts.
//   E  cluster barrier; the CTAs before it give each CTA its offset through
//      distributed shared memory; the same walk, D's bits replayed (or
//      recomputed past 64 steps), writes each active cell's id at offset +
//      rank (a ballot).
// The fixed form zeroes the slots past the count up to cap; CTA 0 writes
// the count, and a last cluster barrier keeps every CTA's shared memory
// alive until no peer reads it.
// Measured (chip_smoke.py [k4], PERF.md): 33 us on the main path's grid,
// about the earlier five grid-wide kernels' 30.5 us; the phase stamps of the
// trace build (ops/cull_trace.py) put 13 us in B and 14 in D and E, well
// above what their instruction counts need on 16 SMs. Tried and no
// faster: staging each CTA's slab in shared memory (so the L2 reads do
// not set it), batched and prefetched loads (they spilled). Short-circuit
// || in the slope test compiled to a divergent branch a direction: the
// bitwise forms below avoid it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 1024;  // 32 warps: the warp-0 scans take one a lane
constexpr int WARPS = THREADS / 32;
constexpr int ZMAX = 64;  // cell planes a CTA takes in a round, at most
constexpr int DIRS = 7;
constexpr unsigned FULL = 0xffffffffu;

enum Flags {
  TAU = 1,        // compute tau (into tau_out when it is not null)
  AUTOCAL = 2,    // widen it by the near-band slope
  CULL = 4,       // the active cells
  SIGN = 8,       // mode sign (tau not read)
  TAU_IN = 16,    // the cull's tau from tau_in
  ZERO_TAIL = 32  // zero ids[count .. cap)
};

struct Args {
  const float* vol;
  int rc;
  const float* sp;
  float band_factor;
  int flags;
  const float* tau_in;
  float* tau_out;
  int cap;
  int* ids;
  int* count;
  int zr;  // cell planes a CTA takes in a round
};

__device__ __forceinline__ float min_nan(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : (b < a ? b : a));
}

__device__ __forceinline__ float max_nan(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : (b > a ? b : a));
}

// min.NaN: NaN when either operand is
__device__ __forceinline__ float min_nan_fast(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Phase stamps of a trace build (-DCULL_TRACE): %globaltimer (ns) in CTA
// 0's thread 0 at the kernel's start, after A's barrier, after tau, after
// round 0's count (D and its scan), after its barrier, after its ids (E),
// and at the end; read with band_cull_trace().
#ifdef CULL_TRACE
__device__ long long cull_trace[16];
#define STAMP(i)                                                     \
  if (blockIdx.x == 0 && threadIdx.x == 0) {                         \
    long long t;                                                     \
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));            \
    cull_trace[i] = t;                                                    \
    cull_trace[8 + (i)] = clock64();                                               \
  }
#else
#define STAMP(i)
#endif

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

// The grid as the walks read it: global memory, through L2 (1.1 MB of its
// 50 MB at 65^3). Staging each CTA's slab in shared memory was measured
// and moved nothing: the time follows the cluster's SMs, not the reads.
struct Grid {
  const float* v;
  int plane;
  __device__ __forceinline__ float at(int z, int p) const {
    return __ldg(v + (long long)z * plane + p);
  }
};

// one slope step a -> b: its |b - a| when it is near the band (written
// without short-circuits: a || here compiled to a divergent branch a
// direction, which set the pass's time). A step
// that does not exist has b = NaN (a = NaN where the lane owns no point):
// |b - a| is then NaN and fmaxf drops it, as the plain version's mask
// does; so does a NaN value of the grid (never near the band there).
__device__ __forceinline__ void slope(float& d, bool sa, float a, float b,
                                      float win) {
  const bool near = sa | (fabsf(b) < win);
  const float step = fabsf(__fsub_rn(b, a));
  d = fmaxf(d, near ? step : 0.0f);
}

// B: the steps from the points of planes [z0, z1); d[k] the masked max of
// direction k. A warp takes 30-point segments of a plane (lanes 0 and 31
// the x neighbours) and walks z; a step where no value of the warp is
// near the band is skipped whole.
__device__ __forceinline__ void slopes(const Args& a, const Grid& g, int z0, int z1, int k0,
                       int kstep, float win, float d[DIRS]) {
  const int lane = threadIdx.x & 31;
  const int rc = a.rc, n = rc - 1, plane = rc * rc;
  const int segs = (plane + 29) / 30;
  const float none = __int_as_float(0x7fffffff);  // NaN: no such step
  if (z0 >= z1) return;
  for (int k = k0; k < segs; k += kstep) {
    const int p = 30 * k - 1 + lane;  // lanes 1..30 own their point
    const bool in = p >= 0 && p < plane;
    const int y = in ? p / rc : 0, x = in ? p - y * rc : 0;
    const bool own = in && lane >= 1 && lane <= 30;
    const bool yl = in && y < n, yg = in && y > 0;
    const bool xl = x < n, xg = x > 0;
    float pa = in ? g.at(z0, p) : none, pY = yl ? g.at(z0, p + rc) : none;
    for (int z = z0; z < z1; ++z) {
      const bool up = z < n;
      const float Z = up && in ? g.at(z + 1, p) : none;
      const float R1 = up && yl ? g.at(z + 1, p + rc) : none;
      const float R2 = up && yg ? g.at(z + 1, p - rc) : none;
      const float va = own ? pa : none;
      const bool sa = fabsf(va) < win;
      if (__any_sync(FULL, (fabsf(pa) < win) | (fabsf(pY) < win) |
                               (fabsf(Z) < win) | (fabsf(R1) < win) |
                               (fabsf(R2) < win))) {
        const float bx = __shfl_down_sync(FULL, pa, 1);
        const float r1p = __shfl_down_sync(FULL, R1, 1);
        const float r1m = __shfl_up_sync(FULL, R1, 1);
        const float r2p = __shfl_down_sync(FULL, R2, 1);
        const float r2m = __shfl_up_sync(FULL, R2, 1);
        slope(d[0], sa, va, Z, win);
        slope(d[1], sa, va, pY, win);
        slope(d[2], sa, va, xl ? bx : none, win);
        slope(d[3], sa, va, xl ? r1p : none, win);
        slope(d[4], sa, va, xg ? r1m : none, win);
        slope(d[5], sa, va, xl ? r2p : none, win);
        slope(d[6], sa, va, xg ? r2m : none, win);
      }
      pa = Z;
      pY = R1;
    }
  }
}

// The cull's walks call emit(plane - z0, active, flat id) for every lane
// of every step; E replays D's activity bits from a 64-bit mask when D
// recorded all of them there, instead of reading the grid again.
struct Bits {
  unsigned long long mask = 0;
  int t = 0;  // emits so far, the same in every lane
  __device__ __forceinline__ bool record(bool act) {
    if (t < 64) mask |= (unsigned long long)act << t;
    ++t;
    return act;
  }
  __device__ __forceinline__ bool replay() { return (mask >> t++) & 1ull; }
};

// Each (plane, warp)'s active cells of a round: D counts them, the CTA
// scans them, E runs on from the offsets (a warp keeps its own column).
// At namespace scope, so that the functors below address it as shared
// memory (through a pointer they used generic loads and stores).
__shared__ int cnt[ZMAX * WARPS];

// D: each (plane, warp)'s active cells
struct Count {
  Bits bits;
  __device__ __forceinline__ void operator()(int zl, bool act, int) {
    const unsigned b = __ballot_sync(FULL, bits.record(act));
    if ((threadIdx.x & 31) == 0)
      cnt[zl * WARPS + (threadIdx.x >> 5)] += __popc(b);
  }
};

// E: each active cell's id at base + the warp's offset in the plane + the
// lanes before it
struct Write {
  Bits bits;
  bool replay;  // act from the bits
  int base, cap;
  int* ids;
  __device__ __forceinline__ void operator()(int zl, bool act, int id) {
    if (replay) act = bits.replay();
    const int lane = threadIdx.x & 31;
    int* slot = cnt + zl * WARPS + (threadIdx.x >> 5);
    const unsigned b = __ballot_sync(FULL, act);
    // lane 0 alone keeps the slot (no __syncwarp: it would wait for the
    // ids' stores)
    int run = lane == 0 ? *slot : 0;
    run = __shfl_sync(FULL, run, 0);
    if (lane == 0) *slot = run + __popc(b);
    const int rank = base + run + __popc(b & ((1u << lane) - 1));
    if (act & (rank < cap)) ids[rank] = id;
  }
};

// D/E, mode band: cell planes [z0, z1), segments [k0, k1) of 31 cells;
// emit(plane - z0, active, flat id) for every lane of every step, the
// activity computed from the grid when `compute` (else left to emit).
template <typename Emit>
__device__ __forceinline__ void walk_band(const Args& a, const Grid& g, float tau, int k0,
                          int k1, int z0, int z1, bool compute, Emit& emit) {
  const int lane = threadIdx.x & 31;
  const int rc = a.rc, c = rc - 1, plane = rc * rc;
  if (z0 >= z1) return;
  for (int k = k0; k < k1; ++k) {
    const int p = 31 * k + lane;  // lane 31 is lane 30's x + 1 corner
    const bool in = p < plane;
    const int y = in ? p / rc : 0, x = in ? p - y * rc : 0;
    const bool cell = in && lane < 31 && y < c && x < c;
    const bool two = in && y < c;  // the y + 1 row exists
    float m = 0.0f, lo = 0.0f, hi = 0.0f;  // the plane below's pairs
    if (compute) {
      const float w0 = in ? g.at(z0, p) : 0.0f;
      const float w1 = two ? g.at(z0, p + rc) : 0.0f;
      m = min_nan_fast(fabsf(w0), fabsf(w1));
      lo = fminf(w0, w1);
      hi = fmaxf(w0, w1);
    }
    for (int z = z0; z < z1; ++z) {
      bool act = false;
      if (compute) {
        const float w0 = in ? g.at(z + 1, p) : 0.0f;
        const float w1 = two ? g.at(z + 1, p + rc) : 0.0f;
        const float m2 = min_nan_fast(fabsf(w0), fabsf(w1));
        const float lo2 = fminf(w0, w1), hi2 = fmaxf(w0, w1);
        float M = min_nan_fast(m, m2), L = fminf(lo, lo2), H = fmaxf(hi, hi2);
        M = min_nan_fast(M, __shfl_down_sync(FULL, M, 1));
        L = fminf(L, __shfl_down_sync(FULL, L, 1));
        H = fmaxf(H, __shfl_down_sync(FULL, H, 1));
        act = cell & ((M < tau) | ((L < 0.0f) & (H >= 0.0f)));
        m = m2;
        lo = lo2;
        hi = hi2;
      }
      emit(z - z0, act, (z * c + y) * c + x);
    }
  }
}

// D/E, mode sign: segments of 29 cells (lane 0 and lanes 30, 31 the x
// neighbours); a lane holds the sign-change bits of its cell rows y - 1,
// y, y + 1 from point rows y - 1 .. y + 2, x-dilated by shuffles, and the
// walk over point planes z0 - 1 .. z1 + 1 z-dilates them.
template <typename Emit>
__device__ __forceinline__ void walk_sign(const Args& a, const Grid& g, int k0, int k1,
                          int z0, int z1, bool compute, Emit& emit) {
  const int lane = threadIdx.x & 31;
  const int rc = a.rc, c = rc - 1, plane = rc * rc;
  if (z0 >= z1) return;
  for (int k = k0; k < k1; ++k) {
    const int p = 29 * k - 1 + lane;
    const bool in = p >= 0 && p < plane;
    const int y = in ? p / rc : 0, x = in ? p - y * rc : 0;
    const bool cell = in && lane >= 1 && lane <= 29 && y < c && x < c;
    bool row[4];   // point rows y - 1 .. y + 2 exist
    bool crow[3];  // cell rows y - 1 .. y + 1 exist (at this x)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      row[i] = in && y - 1 + i >= 0 && y - 1 + i < rc;
#pragma unroll
    for (int i = 0; i < 3; ++i)
      crow[i] = in && x < c && y - 1 + i >= 0 && y - 1 + i < c;
    float pl[3], ph[3];  // the previous point plane's row pairs
    unsigned xa = 0, xb = 0;  // dilated bits of cell planes P - 3, P - 2
    for (int P = z0 - 1; P <= z1 + 1; ++P) {  // cell plane P - 1
      unsigned xd = 0;  // cell plane P - 1's bits, dilated in x and y
      if (compute) {
        float cl[3], ch[3];
        const bool have = P >= 0 && P <= c;
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const float r0 = have && row[j] ? g.at(P, p + (j - 1) * rc) : NAN;
          const float r1 = have && row[j + 1] ? g.at(P, p + j * rc) : NAN;
          cl[j] = fminf(r0, r1);
          ch[j] = fmaxf(r0, r1);
        }
        if (P >= 1 && P - 1 <= c - 1 && P >= z0) {
          unsigned yd = 0;
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            float L = fminf(pl[j], cl[j]), H = fmaxf(ph[j], ch[j]);
            L = fminf(L, __shfl_down_sync(FULL, L, 1));
            H = fmaxf(H, __shfl_down_sync(FULL, H, 1));
            yd |= (unsigned)(crow[j] & (L < 0.0f) & (H >= 0.0f));
          }
          xd = yd | __shfl_up_sync(FULL, yd, 1) |
               __shfl_down_sync(FULL, yd, 1);
        }
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          pl[j] = cl[j];
          ph[j] = ch[j];
        }
      }
      if (P - 2 >= z0)  // cell plane P - 2, between its neighbours
        emit(P - 2 - z0, cell & ((xa | xb | xd) != 0),
             ((P - 2) * c + y) * c + x);
      xa = xb;
      xb = xd;
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1) band_cull_kernel(const Args a) {
  STAMP(0);
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int me = (int)cluster.block_rank();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rc = a.rc, c = rc - 1, plane = rc * rc;
  const int zr = a.zr;
  const int rounds = (c + cs * zr - 1) / (cs * zr);
  const Grid g{a.vol, plane};

  __shared__ float red[DIRS][WARPS];
  __shared__ float posted_f[1 + DIRS];  // this CTA's min|v|, its slopes
  __shared__ int posted[2];  // this CTA's active cells, by round parity
  __shared__ int wsum[WARPS];
  __shared__ float s_tau;
  __shared__ int s_pre, s_all;

  // this CTA's cell planes [z0, z1) of round r; it owns the points of the
  // same planes for tau (A: and of the top plane c with the last slab; B:
  // the top plane's segments are spread over the whole cluster)
  auto slab = [&](int r, int& z0, int& z1) {
    z0 = min((r * cs + me) * zr, c);
    z1 = min(z0 + zr, c);
  };

  float tau = 0.0f;
  if (a.flags & TAU) {
    const Box box = box_geometry(a.sp, rc, a.band_factor);
    tau = box.tau0;
    if (a.flags & AUTOCAL) {
      // A: min |v| over this CTA's points
      float m = INFINITY;
      bool nan = false;
      for (int r = 0; r < rounds; ++r) {
        int z0, z1;
        slab(r, z0, z1);
        const int count = (z1 - z0 + (z1 == c && z0 < z1)) * plane;
        const float* v = a.vol + (long long)z0 * plane;
        for (int i = threadIdx.x; i < count; i += 4 * THREADS) {
          float w[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            w[j] = i + j * THREADS < count ? __ldg(v + i + j * THREADS)
                                           : INFINITY;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            m = fminf(m, fabsf(w[j]));
            nan |= isnan(w[j]);
          }
        }
      }
      for (int o = 16; o; o >>= 1) m = fminf(m, __shfl_xor_sync(FULL, m, o));
      nan = __any_sync(FULL, nan);
      if (lane == 0) red[0][warp] = nan ? NAN : m;
      __syncthreads();
      if (warp == 0) {
        float x = red[0][lane];
        for (int o = 16; o; o >>= 1) x = min_nan(x, __shfl_xor_sync(FULL, x, o));
        if (lane == 0) posted_f[0] = x;
      }
      cluster.sync();  // every CTA's minimum is posted
      STAMP(1);
      if (warp == 0) {
        float x = lane < cs ? *cluster.map_shared_rank(posted_f, lane)
                            : INFINITY;
        for (int o = 16; o; o >>= 1) x = min_nan(x, __shfl_xor_sync(FULL, x, o));
        if (lane == 0) s_tau = x;
      }
      __syncthreads();
      const float vmin = s_tau;
      const float win =
          __fadd_rn(__fmul_rn(4.0f, box.tau0), __fmul_rn(2.0f, vmin));
      // B: the 7 directions' masked maxima from this CTA's points
      float d[DIRS];
#pragma unroll
      for (int k = 0; k < DIRS; ++k) d[k] = 0.0f;
      for (int r = 0; r < rounds; ++r) {
        int z0, z1;
        slab(r, z0, z1);
        slopes(a, g, z0, z1, warp, WARPS, win, d);
      }
      // the top plane c, its segments spread over the whole cluster
      slopes(a, g, c, c + 1, me * WARPS + warp, cs * WARPS, win, d);
#pragma unroll
      for (int k = 0; k < DIRS; ++k) {
        float x = d[k];
        for (int o = 16; o; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
        if (lane == 0) red[k][warp] = x;
      }
      __syncthreads();
      if (warp < DIRS) {
        float x = red[warp][lane];
        for (int o = 16; o; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
        if (lane == 0) posted_f[1 + warp] = x;
      }
      cluster.sync();  // every CTA's slopes are posted
      // C: tau, the same in every CTA
      if (warp < DIRS) {
        float x = lane < cs
                      ? cluster.map_shared_rank(posted_f, lane)[1 + warp]
                      : 0.0f;
        for (int o = 16; o; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
        if (lane == 0) red[warp][0] = x;
      }
      __syncthreads();
      if (threadIdx.x == 0) {
        // the directions' steps: z, y, x, then the four space diagonals
        const float steps[DIRS] = {box.h[2], box.h[1], box.h[0], box.hd,
                                   box.hd, box.hd, box.hd};
        float lip = 0.0f;
        for (int k = 0; k < DIRS; ++k)
          lip = max_nan(lip, __fdiv_rn(red[k][0], steps[k]));
        s_tau = __fmul_rn(box.tau0, isnan(lip) ? lip : fmaxf(lip, 1.0f));
      }
      __syncthreads();
      tau = s_tau;
      STAMP(2);
    }
    if (a.tau_out && me == 0 && threadIdx.x == 0) *a.tau_out = tau;
  } else if ((a.flags & TAU_IN) && !(a.flags & SIGN)) {
    tau = __ldg(a.tau_in);
  }

  int total = 0;
  if (a.flags & CULL) {
    const bool sign = a.flags & SIGN;
    const int S = sign ? 29 : 31;
    const int segs = (c * rc + S - 1) / S;  // over the points of rows y < c
    const int k0 = (int)((long long)segs * warp / WARPS);
    const int k1 = (int)((long long)segs * (warp + 1) / WARPS);
    for (int r = 0; r < rounds; ++r) {
      int z0, z1;
      slab(r, z0, z1);
      // D: each (plane, warp)'s active cells
      for (int zl = lane; zl < zr; zl += 32) cnt[zl * WARPS + warp] = 0;
      __syncwarp();
      Count count{Bits()};
      if (sign)
        walk_sign(a, g, k0, k1, z0, z1, true, count);
      else
        walk_band(a, g, tau, k0, k1, z0, z1, true, count);
      __syncthreads();
      // exclusive scan of cnt in (plane, warp) order; a thread takes a run
      const int entries = zr * WARPS;
      const int per = (entries + THREADS - 1) / THREADS;
      const int t0 = min((int)threadIdx.x * per, entries);
      const int t1 = min(t0 + per, entries);
      int tn = 0;
      for (int i = t0; i < t1; ++i) tn += cnt[i];
      int incl = tn;
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += v;
      }
      if (lane == 31) wsum[warp] = incl;
      __syncthreads();
      if (warp == 0) {
        const int w = wsum[lane];
        int wi = w;
        for (int o = 1; o < 32; o <<= 1) {
          const int v = __shfl_up_sync(FULL, wi, o);
          if (lane >= o) wi += v;
        }
        wsum[lane] = wi - w;
        if (lane == 31) posted[r & 1] = wi;
      }
      __syncthreads();
      int e = wsum[warp] + incl - tn;
      for (int i = t0; i < t1; ++i) {
        const int k = cnt[i];
        cnt[i] = e;
        e += k;
      }
      if (r == 0) STAMP(3);
      cluster.sync();  // every CTA's count of this round is posted
      if (r == 0) STAMP(4);
      if (warp == 0) {
        const int pn =
            lane < cs ? cluster.map_shared_rank(posted, lane)[r & 1] : 0;
        int pi = pn;
        for (int o = 1; o < 32; o <<= 1) {
          const int v = __shfl_up_sync(FULL, pi, o);
          if (lane >= o) pi += v;
        }
        if (lane == me) s_pre = pi - pn;
        if (lane == 31) s_all = pi;
      }
      __syncthreads();
      // E: the ids, by the same walk, D's bits replayed when it kept all
      const bool replay = count.bits.t <= 64;
      Write write{count.bits, replay, total + s_pre, a.cap, a.ids};
      write.bits.t = 0;
      if (sign)
        walk_sign(a, g, k0, k1, z0, z1, !replay, write);
      else
        walk_band(a, g, tau, k0, k1, z0, z1, !replay, write);
      total += s_all;
      if (r == 0) STAMP(5);
    }
  }
  cluster_arrive();  // no peer reads this CTA's shared memory past here
  if (a.flags & CULL) {
    if (me == 0 && threadIdx.x == 0) *a.count = total;
    if (a.flags & ZERO_TAIL)
      for (long long s = (long long)min(total, a.cap) + me * THREADS +
                         threadIdx.x;
           s < a.cap; s += (long long)cs * THREADS)
        a.ids[s] = 0;
  }
  STAMP(6);
  cluster_wait();
}

// 4 bytes of page-locked, device-mapped host memory a host thread, for the
// exact form's count
int* mapped_count() {
  static thread_local int* host = nullptr;
  if (!host && cudaHostAlloc((void**)&host, sizeof(int), cudaHostAllocMapped |
                                                     cudaHostAllocPortable) !=
                   cudaSuccess)
    host = nullptr;
  return host;
}

}  // namespace

#ifdef CULL_TRACE
extern "C" int band_cull_trace(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, cull_trace, sizeof(cull_trace));
}
#endif

// Cell planes a CTA takes in a round, at most (ops/band_cull.cull_plan).
extern "C" int band_cull_zmax() { return ZMAX; }

// One launch of `ctas` CTAs as one cluster on the grid vol [rc^3] and the
// box sp [6] (x0, y0, z0, x1, y1, z1), by `flags` (the Flags above): tau
// into tau_out [1] (when not null), the active cells into ids [cap] and
// their count into count [1] on the card or, with host_count, into
// *host_count after waiting for the stream. Returns a CUDA error (-1: no
// cluster of `ctas` CTAs fits).
extern "C" int band_cull_launch(const float* vol, int rc, const float* sp,
                                float band_factor, int flags,
                                const float* tau_in, float* tau_out, int cap,
                                int* ids, int* count, int zr, int ctas,
                                int* host_count, cudaStream_t stream) {
  static int fits[17];  // 0 not asked yet, 1 fits, -1 does not
  if (ctas < 1 || ctas > 16 || zr < 1 || zr > ZMAX)
    return (int)cudaErrorInvalidValue;
  int* host = nullptr;
  if (host_count) {
    host = mapped_count();
    if (!host) return (int)cudaErrorMemoryAllocation;
    cudaError_t e = cudaHostGetDevicePointer((void**)&count, host, 0);
    if (e != cudaSuccess) return (int)e;
  }
  Args a;
  a.vol = vol;
  a.rc = rc;
  a.sp = sp;
  a.band_factor = band_factor;
  a.flags = flags;
  a.tau_in = tau_in;
  a.tau_out = tau_out;
  a.cap = cap;
  a.ids = ids;
  a.count = count;
  a.zr = zr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (fits[ctas] == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        band_cull_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, band_cull_kernel, &cfg);
    if (err != cudaSuccess) return (int)err;
    fits[ctas] = clusters > 0 ? 1 : -1;
  }
  if (fits[ctas] < 0) return -1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, band_cull_kernel, a);
  if (err != cudaSuccess) return (int)err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (host_count) {
    err = cudaStreamSynchronize(stream);
    if (err != cudaSuccess) return (int)err;
    *host_count = *(volatile int*)host;
  }
  return 0;
}
