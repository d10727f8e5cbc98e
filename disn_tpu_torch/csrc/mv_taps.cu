// K8: the multi-view decode's tap mean, on Hopper (sm_90a).
//
// Replaces the tap mean of disn_tpu/infer/multiview.py:111-119
// (_mv_decode's folded arm): XLA code, not a Pallas kernel, that projects P
// world points through each of V cameras, samples each view's folded
// [137,137,512] map bilinearly at the projection (ops/image.resampler: a
// tap past the image counts zero) and averages the V samples in f32, cast
// to the compute type. Under jit XLA fused the three; the port ran them
// as eager PyTorch ops over [V,P,512] f32 (ops/mv_taps.mv_tap_mean_plain).
// For point p, channel c:
//   out[p,c] = cd(((s_0 + s_1) + ... + s_{V-1}) / V)
// with s_v the bilinear sample of map v at point p's projection through
// trans[v]. Bit for bit the plain version on the card, which computes in
// this order: the projection is core/camera.project_points' term by term
// (x t0j + y t1j + z t2j + t3j), an IEEE divide by w, the clamp to
// [0, W-1] x [0, H-1] with NaN kept; the sample is the resampler's (floor
// for the base tap, NaN to 0; a tap past the last column or row is the
// clamped tap times 0.0, as the resampler multiplies by its mask; top =
// v00 (1 - tx) + v01 tx, bot likewise, top (1 - ty) + bot ty, a bf16 map
// widened to f32 first); the views summed in order (from -0.0, the sum's
// identity), divided by V (IEEE), rounded to nearest even for bf16. Every
// operation is an __f*_rn intrinsic: no contraction into an FMA, which
// would round once where PyTorch rounds twice.
//
// What bounds it on the H100: operations. Per view and channel the three
// lerps and the sum are 8 FLOP at the least: four multiply-adds, with the
// tap weights (1 - tx)(1 - ty), ... formed once a point and view and the
// view sum chained into the accumulator, on the FMA units (67 TFLOP/s):
// 2.083 ms for an object at V = 24 and 1,419,457 points. Its bytes, the V
// maps read once (461 MB in bf16, 923 MB in f32), the points read and the
// [P,512] output written once (1.45 GB in bf16), take 0.58 ms in bf16 at
// 3.35 TB/s.
//
// The floor this arithmetic sets. To round as PyTorch does the kernel
// issues 6 multiplies and 4 adds a view-channel (never an FMA); in bf16
// one unpack a tap value (4) and half a 16-byte shared-memory load: 14.5
// issue slots a view-channel, at 132 SMs x 128 lanes x 1.98 GHz 1.40 ms a
// bf16 step of 262,144 points at V = 24. In f32 the 4 taps are 16 bytes
// read out of shared memory a view-channel, at 128 bytes a clock an SM:
// 1.54 ms a step.
//
// The design: taps staged in shared memory a tile at a time. A warp a
// point, every tap from L1 and L2 (the first design) re-read ~26 GB of
// taps a bf16 coarse step out of a 461 MB set. Here a CTA owns a tile of
// TP = 64 consecutive points in the caller's order (a fine cell in
// fused_decode.cell_points' order; a 4^3 block of the coarse grid in
// core/grids.block_order) and SLICE_C = 128 channels of each pixel (256
// bytes in bf16, 512 in f32): 4 CTAs a tile. First the CTA projects its
// tile under every view (a thread a point and view, the arithmetic above)
// into tables in shared memory, and forms each view's pixel box: the base
// taps' least x and y to the clamped x1 and y1 taps' greatest (a NaN
// projection reads pixel 0; a partial tile's missing points repeat its
// first). A box of at most STAGE_PX pixels is staged: its pixels' slices
// are copied into a stage with 16-byte cp.async copies spread over the
// CTA's threads, one commit group a view. The stages form a ring of
// STAGES over the views: view v + STAGES - 1 is issued before view v is
// summed, so two boxes land while one is summed. Every thread
// sums 2 points x 2 (bf16) or 4 (f32) 16-byte chunks from the stage
// (eight lanes read 128 bytes of a pixel at once), its f32 sums in
// registers: 32 a thread in both types. A tile-view whose box does not
// fit (scattered points: a coarse x row, the dense stream, points near a
// camera) takes the direct path: the same taps read with __ldg from the
// map. A tap past the image is the clamped tap in the box times 0.0, never
// a zero fill. The plan (which tile-views are staged) is
// ops/mv_taps.tile_plan; a -DMV_TRACE build counts staged and direct
// tile-views (slice 0's CTAs) and thread 0's clocks in mv_trace_counts.
//
// Sizing (times on one H100, PERF.md): under 24 cameras around the demo
// camera a fine cell's box holds 20 px (median) to 36 (most), a
// coarse 4^3 block's 90 (median) to 1,932; a stage of 48 px takes every
// fine box and ~27% of the coarse ones. With 3 stages of 48 px a CTA
// holds 57,856 bytes (bf16) or 94,720 (f32): two CTAs an SM at <= 128
// registers. Stages of 88 or 120 px take more coarse boxes and time the
// coarse step no faster (the direct path reads a block's taps from L1 at
// about the staged rate), so the stage is sized for the fine cells, 5 of
// an object's 7 decode steps. In f32, 64 channels a CTA (8 CTAs a
// tile, 16 sums a thread) took 3.77 ms a fine step against 2.91 for 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 512;             // channels of a folded map
constexpr int TP = 64;             // points a tile
constexpr int SLICE_C = 128;       // channels of a pixel a CTA stages
constexpr int SLICES = C / SLICE_C;   // CTAs a tile
// a CTA's bytes of a pixel: 256 in bf16, 512 in f32
template <typename T>
__host__ __device__ constexpr int slice_bytes() {
  return SLICE_C * (int)sizeof(T);
}
constexpr int THREADS = 256;
// a thread sums 16-byte chunks c, c + 8, ... (2 in bf16, 4 in f32) of
// PTS points, p0 + PSTEP j: eight lanes read 128 bytes of a pixel at a
// time, a warp four points
constexpr int PSTEP = THREADS / 8;
constexpr int PTS = TP / PSTEP;
constexpr int STAGES = 3;        // the ring over the views
constexpr int STAGE_PX = 48;     // pixels a stage holds
constexpr int VCH = 24;   // views whose tables a CTA holds at a time
constexpr int VPT = VCH / (THREADS / TP);   // views a thread projects
static_assert(PTS * PSTEP == TP, "items");
static_assert(THREADS % TP == 0 && VPT * (THREADS / TP) == VCH, "views");

// shared memory: each view's box (x, y of its low corner, its width or 0
// for the direct path, its height), the two half-tiles' partial boxes,
// 2^32 / the width rounded up and the camera; the tables (a point's packed
// base pixel and flags, its tx and ty) of VCH views; then the stages
constexpr int BOX_BYTES = VCH * 16 + VCH * 2 * 16 + VCH * 8 + VCH * 48;
constexpr int TABLE_BYTES = VCH * TP * (4 + 8);
constexpr int HEAD_BYTES = (BOX_BYTES + TABLE_BYTES + 127) / 128 * 128;

template <typename T>
constexpr int smem_bytes() {
  return HEAD_BYTES + STAGES * STAGE_PX * slice_bytes<T>();
}

#ifdef MV_TRACE
// staged and direct tile-views (slice 0's CTAs: one a tile and view);
// then thread 0's clocks summed over the CTAs: waiting for a stage (its
// copies and the block barrier), in all, forming the tables and boxes,
// issuing copies
__device__ unsigned long long mv_trace_counts[6];
#endif

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
               "l"(__cvta_generic_to_global(src))
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// until at most N of this thread's groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// ---- values ----
// 16 bytes of a tap as f32: 8 bf16 values widened exactly (a value's bits
// in the high half of the word) or 4 f32 values
template <typename T>
struct Vec;
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void unpack(uint4 a, float* v) {
    const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[2 * j] = __uint_as_float(w[j] << 16);
      v[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ uint4 pack(const float* v) {
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * j]));
      const uint32_t hi =
          __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * j + 1]));
      w[j] = lo | (hi << 16);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};
template <>
struct Vec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void unpack(uint4 a, float* v) {
    v[0] = __uint_as_float(a.x);
    v[1] = __uint_as_float(a.y);
    v[2] = __uint_as_float(a.z);
    v[3] = __uint_as_float(a.w);
  }
  static __device__ __forceinline__ uint4 pack(const float* v) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                      __float_as_uint(v[2]), __float_as_uint(v[3]));
  }
};

// torch.clamp(v, 0, hi): NaN passes through (fminf/fmaxf would swallow it)
__device__ __forceinline__ float clamp_keep_nan(float v, float hi) {
  return (v != v) ? v : (v < 0.f ? 0.f : (v > hi ? hi : v));
}

// One point's taps under one camera t (12 floats): the base pixel (x0,
// y0), whether x0 + 1 and y0 + 1 lie on the image, and the fractions tx,
// ty (the tap weights 1 - tx, tx, 1 - ty, ty).
struct Tap {
  int x0, y0;
  bool vx, vy;
  float tx, ty;
};
__device__ __forceinline__ Tap project(const float* t, float x, float y,
                                       float z, int img_w, int img_h) {
  float uvw[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    float a = __fmul_rn(x, t[j]);
    a = __fadd_rn(a, __fmul_rn(y, t[3 + j]));
    a = __fadd_rn(a, __fmul_rn(z, t[6 + j]));
    uvw[j] = __fadd_rn(a, t[9 + j]);
  }
  const float px = clamp_keep_nan(__fdiv_rn(uvw[0], uvw[2]),
                                  (float)(img_w - 1));
  const float py = clamp_keep_nan(__fdiv_rn(uvw[1], uvw[2]),
                                  (float)(img_h - 1));
  const float x0f = floorf(px), y0f = floorf(py);
  const float tx = __fsub_rn(px, x0f), ty = __fsub_rn(py, y0f);
  Tap r;
  // the clamp keeps x0f in [0, W-1]; NaN becomes 0 (torch.nan_to_num)
  r.x0 = (x0f == x0f) ? (int)x0f : 0;
  r.y0 = (y0f == y0f) ? (int)y0f : 0;
  r.vx = r.x0 + 1 <= img_w - 1;
  r.vy = r.y0 + 1 <= img_h - 1;
  r.tx = tx;
  r.ty = ty;
  return r;
}

// A packed table entry: the base pixel (x0, y0), in the view's box on
// the staged path, in the map on the direct path (bits 0-29), bit 30 x0 +
// 1 on the image, bit 31 y0 + 1 on the image.
constexpr uint32_t VX_BIT = 1u << 30, VY_BIT = 1u << 31;
constexpr uint32_t BASE_MASK = VX_BIT - 1;

#ifdef MV_TRACE
#define TRACE_ADD(i, v) atomicAdd(&mv_trace_counts[i], (unsigned long long)(v))
#endif

// 16 bytes of a tap: from the stage (a shared-memory pointer) or the map
template <bool STAGED>
__device__ __forceinline__ uint4 load16(const unsigned char* base,
                                        uint32_t off) {
  if (STAGED) return *reinterpret_cast<const uint4*>(base + off);
  return __ldg(reinterpret_cast<const uint4*>(base + off));
}

// The thread's PTS points of one view into acc: taps at `base` (the
// stage, or the view's map at the slice, + the thread's first chunk) +
// the point's packed pixel x px_b (in 64 bits on the direct path: a
// view's map may pass 4 GiB); a row is row_b bytes. MASKED: some point
// has a tap past the image (times 0.0); else none has.
template <typename T, bool STAGED, bool MASKED>
__device__ __forceinline__ void sum_view(
    float (&acc)[PTS][sizeof(T)][Vec<T>::N], const uint32_t* tpk,
    const float2* twt, int p0, const unsigned char* base, uint32_t px_b,
    uint32_t row_b) {
  using V = Vec<T>;
  constexpr int N = V::N;
#pragma unroll
  for (int j = 0; j < PTS; ++j) {
    const uint32_t pk = tpk[p0 + PSTEP * j];
    const float2 t = twt[p0 + PSTEP * j];
    const float ux = __fsub_rn(1.f, t.x), uy = __fsub_rn(1.f, t.y);
    const bool vx = pk & VX_BIT, vy = pk & VY_BIT;
    const uint32_t px = pk & BASE_MASK;
    const unsigned char* a =
        base + (STAGED ? (size_t)(px * px_b) : (size_t)px * px_b);
    const uint32_t dx = vx ? px_b : 0u, dy = vy ? row_b : 0u;
#pragma unroll
    for (int h = 0; h < (int)sizeof(T); ++h) {
      const uint32_t o = 128 * h;
      float v00[N], v01[N], v10[N], v11[N];
      V::unpack(load16<STAGED>(a, o), v00);
      V::unpack(load16<STAGED>(a, o + dx), v01);
      V::unpack(load16<STAGED>(a, o + dy), v10);
      V::unpack(load16<STAGED>(a, o + dy + dx), v11);
      if (MASKED) {
        // a tap past the image: the clamped tap times its 0.0 mask, as in
        // the resampler (+-0 keeps the value's sign)
        if (!vx) {
#pragma unroll
          for (int k = 0; k < N; ++k) v01[k] = __fmul_rn(v01[k], 0.f);
        }
        if (!vy) {
#pragma unroll
          for (int k = 0; k < N; ++k) v10[k] = __fmul_rn(v10[k], 0.f);
        }
        if (!(vx && vy)) {
#pragma unroll
          for (int k = 0; k < N; ++k) v11[k] = __fmul_rn(v11[k], 0.f);
        }
      }
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const float top =
            __fadd_rn(__fmul_rn(v00[k], ux), __fmul_rn(v01[k], t.x));
        const float bot =
            __fadd_rn(__fmul_rn(v10[k], ux), __fmul_rn(v11[k], t.x));
        acc[j][h][k] = __fadd_rn(acc[j][h][k], __fadd_rn(__fmul_rn(top, uy),
                                                         __fmul_rn(bot, t.y)));
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
    mv_taps_kernel(const T* __restrict__ maps, const float* __restrict__ trans,
                   const float* __restrict__ pts, T* __restrict__ out,
                   int n_pts, int views, int img_w, int img_h) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int SB = slice_bytes<T>();
  constexpr int CHUNKS = SB / 16;   // 16-byte copies a pixel
  constexpr int H = (int)sizeof(T);   // a thread's 16-byte chunks a point
  constexpr int N = Vec<T>::N;
  int4* box = reinterpret_cast<int4*>(smem);          // [VCH]
  int4* part = box + VCH;                             // [VCH][2]
  uint64_t* magic = reinterpret_cast<uint64_t*>(part + 2 * VCH);   // [VCH]
  float* cams = reinterpret_cast<float*>(magic + VCH);   // [VCH][12]
  uint32_t* tpk = reinterpret_cast<uint32_t*>(smem + BOX_BYTES);
  float2* twt = reinterpret_cast<float2*>(smem + BOX_BYTES + VCH * TP * 4);
  unsigned char* stage0 = smem + HEAD_BYTES;
  constexpr int STAGE_BYTES = STAGE_PX * SB;

  const int tile = blockIdx.x / SLICES, slice = blockIdx.x % SLICES;
  const size_t view_elems = (size_t)img_h * img_w * C;
  const T* slice_maps = maps + slice * SLICE_C;
  const int t = threadIdx.x, lane = t & 31;
  const int chunk = t % 8, p0 = t / 8;   // chunks c + 8 h of p0 + PSTEP j
  // the point this thread projects: past a partial tile's last point,
  // the tile's first again (its taps lie in the box; its sums are not
  // stored)
  const int pp = tile * TP + t % TP < n_pts ? tile * TP + t % TP : tile * TP;
  const float x = __ldg(pts + 3 * (size_t)pp);
  const float y = __ldg(pts + 3 * (size_t)pp + 1);
  const float z = __ldg(pts + 3 * (size_t)pp + 2);
#ifdef MV_TRACE
  const long long t_start = clock64();
  long long t_wait = 0, t_tables = 0, t_copy = 0;
#endif

  float acc[PTS][H][N];
#pragma unroll
  for (int j = 0; j < PTS; ++j)
#pragma unroll
    for (int h = 0; h < H; ++h)
#pragma unroll
      for (int k = 0; k < N; ++k) acc[j][h][k] = -0.f;   // x + -0 = x

  for (int vbeg = 0; vbeg < views; vbeg += VCH) {
    const int nv = min(VCH, views - vbeg);
#ifdef MV_TRACE
    const long long t0 = clock64();
#endif
    // ---- the tables and boxes of views vbeg .. vbeg + nv - 1: a thread
    // projects point t % TP under every (THREADS / TP)-th view, the tile's
    // box a view from the two half-tiles' ----
    for (int k = t; k < 12 * nv; k += THREADS)
      cams[k] = __ldg(trans + 12 * vbeg + k);
    __syncthreads();
    uint32_t raw[VPT];   // x0 | y0 << 15 | flags, of the views below
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int i = t / TP + (THREADS / TP) * k;
      if (i >= nv) break;
      const Tap tp = project(cams + 12 * i, x, y, z, img_w, img_h);
      raw[k] = (uint32_t)tp.x0 | ((uint32_t)tp.y0 << 15) |
               (tp.vx ? VX_BIT : 0u) | (tp.vy ? VY_BIT : 0u);
      twt[i * TP + t % TP] = make_float2(tp.tx, tp.ty);
      const int xlo = __reduce_min_sync(0xffffffffu, tp.x0);
      const int ylo = __reduce_min_sync(0xffffffffu, tp.y0);
      const int xhi = __reduce_max_sync(0xffffffffu, tp.x0 + (int)tp.vx);
      const int yhi = __reduce_max_sync(0xffffffffu, tp.y0 + (int)tp.vy);
      if (lane == 0) part[2 * i + (t % TP) / 32] = make_int4(xlo, ylo, xhi,
                                                             yhi);
    }
    __syncthreads();
    if (t < nv) {
      const int4 a = part[2 * t], b = part[2 * t + 1];
      const int xlo = min(a.x, b.x), ylo = min(a.y, b.y);
      const int bw = max(a.z, b.z) - xlo + 1, bh = max(a.w, b.w) - ylo + 1;
      const bool staged = bw * bh <= STAGE_PX;
      box[t] = make_int4(xlo, ylo, staged ? bw : 0, bh);
      // k / bw = (k magic) >> 32 for every pixel k of the box
      magic[t] = 0xffffffffull / (uint32_t)bw + 1u;
#ifdef MV_TRACE
      if (slice == 0) TRACE_ADD(staged ? 0 : 1, 1);
#endif
    }
    __syncthreads();
    // each point's base pixel in its view's box, or in the map
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int i = t / TP + (THREADS / TP) * k;
      if (i >= nv) break;
      const int4 b = box[i];
      const int x0 = raw[k] & 0x7fff, y0 = (raw[k] >> 15) & 0x7fff;
      tpk[i * TP + t % TP] =
          (uint32_t)(b.z ? (y0 - b.y) * b.z + x0 - b.x : y0 * img_w + x0) |
          (raw[k] & (VX_BIT | VY_BIT));
    }
    __syncthreads();
#ifdef MV_TRACE
    t_tables += clock64() - t0;
#endif

    // ---- the ring: view i's box lands in stage (vbeg + i) % STAGES,
    // issued STAGES - 1 views ahead as one group of 16-byte cp.async
    // copies, thread t chunks t, t + THREADS, ... of the box ----
    auto issue = [&](int i) {
      if (i < nv && box[i].z) {
        const int4 b = box[i];   // x, y, width, height
        const uint64_t m = magic[i];
        const unsigned char* map = reinterpret_cast<const unsigned char*>(
            slice_maps + (size_t)(vbeg + i) * view_elems);
        const uint32_t dst =
            smem_u32(stage0 + ((vbeg + i) % STAGES) * STAGE_BYTES);
        for (int c = t; c < b.z * b.w * CHUNKS; c += THREADS) {
          const int k = c / CHUNKS;
          const int row = (int)(((uint64_t)k * m) >> 32);
          const int col = k - row * b.z;
          cp_async16(dst + c * 16,
                     map + ((size_t)(b.y + row) * img_w + b.x + col) *
                               (C * sizeof(T)) +
                         (c % CHUNKS) * 16);
        }
      }
      cp_async_commit();
    };
#ifdef MV_TRACE
    const long long t1 = clock64();
#endif
    for (int d = 0; d < STAGES - 1; ++d) issue(d);
#ifdef MV_TRACE
    t_copy += clock64() - t1;
#endif
    for (int i = 0; i < nv; ++i) {
#ifdef MV_TRACE
      const long long t2 = clock64();
#endif
      const int g = vbeg + i;
      cp_async_wait<STAGES - 2>();
      __syncthreads();   // view i landed; every thread is past view i - 1
#ifdef MV_TRACE
      const long long t3 = clock64();
      t_wait += t3 - t2;
#endif
      issue(i + STAGES - 1);
#ifdef MV_TRACE
      t_copy += clock64() - t3;
#endif
      const int4 b = box[i];
      const uint32_t* pk = tpk + i * TP;
      const float2* wt = twt + i * TP;
      uint32_t edge = 0;   // a point of this thread's with a tap off the image
#pragma unroll
      for (int j = 0; j < PTS; ++j)
        edge |= ~pk[p0 + PSTEP * j] & (VX_BIT | VY_BIT);
      if (b.z) {
        const unsigned char* base =
            stage0 + (g % STAGES) * STAGE_BYTES + chunk * 16;
        const uint32_t row_b = (uint32_t)b.z * SB;
        if (edge)
          sum_view<T, true, true>(acc, pk, wt, p0, base, SB, row_b);
        else
          sum_view<T, true, false>(acc, pk, wt, p0, base, SB, row_b);
      } else {
        const unsigned char* base =
            reinterpret_cast<const unsigned char*>(
                slice_maps + (size_t)g * view_elems) +
            chunk * 16;
        const uint32_t px_b = C * sizeof(T), row_b = (uint32_t)img_w * px_b;
        if (edge)
          sum_view<T, false, true>(acc, pk, wt, p0, base, px_b, row_b);
        else
          sum_view<T, false, false>(acc, pk, wt, p0, base, px_b, row_b);
      }
    }
    cp_async_wait<0>();
    __syncthreads();   // the tables and stages are free for the next views
  }
#ifdef MV_TRACE
  if (t == 0) {
    TRACE_ADD(2, t_wait);
    TRACE_ADD(3, clock64() - t_start);
    TRACE_ADD(4, t_tables);
    TRACE_ADD(5, t_copy);
  }
#endif
  const float fv = (float)views;
#pragma unroll
  for (int j = 0; j < PTS; ++j) {
    const int p = tile * TP + p0 + PSTEP * j;
    if (p >= n_pts) continue;
#pragma unroll
    for (int h = 0; h < H; ++h) {
#pragma unroll
      for (int k = 0; k < N; ++k) acc[j][h][k] = __fdiv_rn(acc[j][h][k], fv);
      *reinterpret_cast<uint4*>(out + (size_t)p * C + slice * SLICE_C +
                                (chunk + 8 * h) * N) = Vec<T>::pack(acc[j][h]);
    }
  }
}

template <typename T>
int launch(const void* maps, const float* trans, const float* pts, void* out,
           int n_pts, int views, int img_w, int img_h, cudaStream_t stream) {
  // past 48 KB the dynamic size must be allowed, on the current device;
  // set at every launch (a host call of about a microsecond), which needs
  // no cache a device and thread
  const cudaError_t e = cudaFuncSetAttribute(
      mv_taps_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes<T>());
  if (e != cudaSuccess) return (int)e;
  const unsigned tiles = (unsigned)(n_pts / TP + (n_pts % TP != 0));
  mv_taps_kernel<T><<<tiles * SLICES, THREADS, smem_bytes<T>(), stream>>>(
      static_cast<const T*>(maps), trans, pts, static_cast<T*>(out), n_pts,
      views, img_w, img_h);
  return (int)cudaGetLastError();
}

}  // namespace

// The compiled constants, for ops/mv_taps to check its own against:
// points a tile, channels of a pixel a CTA stages, stages, pixels a
// stage.
extern "C" void mv_taps_config(int* out) {
  out[0] = TP;
  out[1] = SLICE_C;
  out[2] = STAGES;
  out[3] = STAGE_PX;
}

// One launch on `stream`: maps [V,img_h,img_w,512] (bf16 when bf16 != 0,
// else f32; 16-byte aligned), trans [V,4,3] f32, pts [n_pts,3] f32 ->
// out [n_pts,512] in the maps' type. Returns cudaGetLastError().
extern "C" int mv_taps_launch(int bf16, const void* maps, const float* trans,
                              const float* pts, void* out, int n_pts,
                              int views, int img_w, int img_h,
                              cudaStream_t stream) {
  if (n_pts <= 0 || views <= 0 || img_w < 2 || img_h < 2 || img_w > 32768 ||
      img_h > 32768)
    return (int)cudaErrorInvalidValue;
  if (bf16)
    return launch<__nv_bfloat16>(maps, trans, pts, out, n_pts, views, img_w,
                                 img_h, stream);
  return launch<float>(maps, trans, pts, out, n_pts, views, img_w, img_h,
                       stream);
}

#ifdef MV_TRACE
// The counts since the last reset into out[6]: staged and direct
// tile-views (slice 0's CTAs: one a tile and view), then thread 0's
// clocks summed over the CTAs: waiting for a stage, in all, forming the
// tables and boxes, issuing copies; reset when `reset` != 0.
extern "C" int mv_taps_trace(unsigned long long* out, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(out, mv_trace_counts,
                                       sizeof(mv_trace_counts));
  if (e == cudaSuccess && reset) {
    const unsigned long long zero[6] = {};
    e = cudaMemcpyToSymbol(mv_trace_counts, zero, sizeof(zero));
  }
  return (int)e;
}
#endif
