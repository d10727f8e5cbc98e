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
// widened to f32 first); the views summed in order, divided by V (IEEE),
// rounded to nearest even for bf16. Every operation is an __f*_rn
// intrinsic: no contraction into an FMA, which would round once where
// PyTorch rounds twice.
//
// What bounds it on the H100: operations. Per view and channel the three
// lerps and the sum are 8 FLOP at the least: four multiply-adds, with the
// tap weights (1 - tx)(1 - ty), ... formed once a point and view and the
// view sum chained into the accumulator (this kernel issues 6 multiplies
// and 4 adds to round as PyTorch does), on the FMA units (67 TFLOP/s):
// 2.083 ms for an object at V = 24 and 1,419,457 points. Its bytes, the V maps read once (461 MB in bf16,
// 923 MB in f32), the points read and the [P,512] output written once
// (1.45 GB in bf16), take 0.58 ms in bf16 at 3.35 TB/s.
//
// The gathers. Every point reads 4 taps of 512 channels from each view:
// 96 KB a point in bf16 at V = 24, ~140 GB an object, if no tap were
// reused. Neighbouring points project to neighbouring pixels, so the
// design keeps them together: a warp a point (a lane 16 channels: two
// 16-byte loads a tap in bf16, four in f32), 8 consecutive points a block
// in the caller's order (a cell's 64 points are consecutive in
// fused_decode.cell_points' order, the coarse grid's rows run along x), so
// that the warps of a block and the blocks resident on an SM read mostly
// the same taps, from L1, and the rest of the card from L2. The f32 sums
// stay in registers; nothing is staged in shared memory, nothing is
// allocated, and there is one launch a call.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 512;        // channels of a folded map
constexpr int CH = C / 32;    // channels a lane
constexpr int WARPS = 8;      // points a block
constexpr int THREADS = WARPS * 32;

// The lane's CH channels of one tap, as f32 (a bf16 value widened
// exactly: its bits in the high half of the word).
__device__ __forceinline__ void load_tap(const float* row, float* v) {
  const float4* q = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int i = 0; i < CH / 4; ++i) {
    const float4 a = __ldg(q + i);
    v[4 * i] = a.x;
    v[4 * i + 1] = a.y;
    v[4 * i + 2] = a.z;
    v[4 * i + 3] = a.w;
  }
}
__device__ __forceinline__ void load_tap(const __nv_bfloat16* row, float* v) {
  const uint4* q = reinterpret_cast<const uint4*>(row);
#pragma unroll
  for (int i = 0; i < CH / 8; ++i) {
    const uint4 a = __ldg(q + i);
    const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[8 * i + 2 * j] = __uint_as_float(w[j] << 16);
      v[8 * i + 2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  }
}

__device__ __forceinline__ void store_row(float* row, const float* v) {
  float4* q = reinterpret_cast<float4*>(row);
#pragma unroll
  for (int i = 0; i < CH / 4; ++i)
    q[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
}
__device__ __forceinline__ void store_row(__nv_bfloat16* row, const float* v) {
  uint4* q = reinterpret_cast<uint4*>(row);
#pragma unroll
  for (int i = 0; i < CH / 8; ++i) {
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(v[8 * i + 2 * j]));
      const uint32_t hi =
          __bfloat16_as_ushort(__float2bfloat16_rn(v[8 * i + 2 * j + 1]));
      w[j] = lo | (hi << 16);
    }
    q[i] = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// torch.clamp(v, 0, hi): NaN passes through (fminf/fmaxf would swallow it)
__device__ __forceinline__ float clamp_keep_nan(float v, float hi) {
  return (v != v) ? v : (v < 0.f ? 0.f : (v > hi ? hi : v));
}

// The lane's CH channels of view v's sample at the projection of
// (x, y, z) through trans[v] -> s.
template <typename T>
__device__ __forceinline__ void sample_view(const T* map, const float* t,
                                            float x, float y, float z,
                                            int img_w, int img_h, float* s) {
  float uvw[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    float a = __fmul_rn(x, __ldg(t + j));
    a = __fadd_rn(a, __fmul_rn(y, __ldg(t + 3 + j)));
    a = __fadd_rn(a, __fmul_rn(z, __ldg(t + 6 + j)));
    uvw[j] = __fadd_rn(a, __ldg(t + 9 + j));
  }
  const float px = clamp_keep_nan(__fdiv_rn(uvw[0], uvw[2]),
                                  (float)(img_w - 1));
  const float py = clamp_keep_nan(__fdiv_rn(uvw[1], uvw[2]),
                                  (float)(img_h - 1));
  const float x0f = floorf(px), y0f = floorf(py);
  const float tx = __fsub_rn(px, x0f), ty = __fsub_rn(py, y0f);
  const float ux = __fsub_rn(1.f, tx), uy = __fsub_rn(1.f, ty);
  // the clamp keeps x0f in [0, W-1]; NaN becomes 0 (torch.nan_to_num)
  const int x0 = (x0f == x0f) ? (int)x0f : 0;
  const int y0 = (y0f == y0f) ? (int)y0f : 0;
  const bool vx = x0 + 1 <= img_w - 1, vy = y0 + 1 <= img_h - 1;
  const int x1 = vx ? x0 + 1 : x0, y1 = vy ? y0 + 1 : y0;
  float v00[CH], v01[CH], v10[CH], v11[CH];
  load_tap(map + ((size_t)y0 * img_w + x0) * C, v00);
  load_tap(map + ((size_t)y0 * img_w + x1) * C, v01);
  load_tap(map + ((size_t)y1 * img_w + x0) * C, v10);
  load_tap(map + ((size_t)y1 * img_w + x1) * C, v11);
  // a tap past the image: the clamped tap times its 0.0 mask, as in the
  // resampler (+-0 keeps the value's sign; the same for every lane)
  if (!vx) {
#pragma unroll
    for (int k = 0; k < CH; ++k) v01[k] = __fmul_rn(v01[k], 0.f);
  }
  if (!vy) {
#pragma unroll
    for (int k = 0; k < CH; ++k) v10[k] = __fmul_rn(v10[k], 0.f);
  }
  if (!(vx && vy)) {
#pragma unroll
    for (int k = 0; k < CH; ++k) v11[k] = __fmul_rn(v11[k], 0.f);
  }
#pragma unroll
  for (int k = 0; k < CH; ++k) {
    const float top = __fadd_rn(__fmul_rn(v00[k], ux), __fmul_rn(v01[k], tx));
    const float bot = __fadd_rn(__fmul_rn(v10[k], ux), __fmul_rn(v11[k], tx));
    s[k] = __fadd_rn(__fmul_rn(top, uy), __fmul_rn(bot, ty));
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    mv_taps_kernel(const T* __restrict__ maps, const float* __restrict__ trans,
                   const float* __restrict__ pts, T* __restrict__ out,
                   int n_pts, int views, int img_w, int img_h) {
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (p >= n_pts) return;
  const float x = __ldg(pts + 3 * (size_t)p);
  const float y = __ldg(pts + 3 * (size_t)p + 1);
  const float z = __ldg(pts + 3 * (size_t)p + 2);
  const size_t view_elems = (size_t)img_h * img_w * C;
  const T* map = maps + lane * CH;
  float acc[CH], s[CH];
  sample_view(map, trans, x, y, z, img_w, img_h, acc);
  for (int v = 1; v < views; ++v) {
    sample_view(map + v * view_elems, trans + 12 * v, x, y, z, img_w, img_h,
                s);
#pragma unroll
    for (int k = 0; k < CH; ++k) acc[k] = __fadd_rn(acc[k], s[k]);
  }
  const float fv = (float)views;
#pragma unroll
  for (int k = 0; k < CH; ++k) acc[k] = __fdiv_rn(acc[k], fv);
  store_row(out + (size_t)p * C + lane * CH, acc);
}

}  // namespace

// One launch on `stream`: maps [V,img_h,img_w,512] (bf16 when bf16 != 0,
// else f32; 16-byte aligned), trans [V,4,3] f32, pts [n_pts,3] f32 ->
// out [n_pts,512] in the maps' type. Returns cudaGetLastError().
extern "C" int mv_taps_launch(int bf16, const void* maps, const float* trans,
                              const float* pts, void* out, int n_pts,
                              int views, int img_w, int img_h,
                              cudaStream_t stream) {
  if (n_pts <= 0 || views <= 0) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)(n_pts / WARPS + (n_pts % WARPS != 0));
  if (bf16)
    mv_taps_kernel<__nv_bfloat16><<<blocks, THREADS, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(maps), trans, pts,
        static_cast<__nv_bfloat16*>(out), n_pts, views, img_w, img_h);
  else
    mv_taps_kernel<float><<<blocks, THREADS, 0, stream>>>(
        static_cast<const float*>(maps), trans, pts, static_cast<float*>(out),
        n_pts, views, img_w, img_h);
  return (int)cudaGetLastError();
}
