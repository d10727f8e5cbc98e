// K1: fused cell decode for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel disn_tpu/ops/pallas_fused.py::_fused_kernel
// (launched by fused_cell_decode). For each stride-4 cell id
// (cz*c^2 + cy*c + cx) it generates the cell's 64 grid points, projects
// them with the 4x3 camera matrix (IEEE divide by w, then clamp to the
// image box), bilinearly samples the folded 137x137x512 feature map (taps
// past the last row/column get zero weight), runs both point MLPs
// (3->64->256->512, + W_p, + bias + extra, ReLU, ->256->out) and writes
// pred_global + pred_local raw as f32 [n*64, out_dim].
//
// Bound. One point costs 2 streams x (3*64 + 64*256 + 256*512 + 512*512 +
// 512*256 + 256*out) = 1,082,240 MACs (~2.16 MFLOP); the map (19 MB in
// bf16, 38 MB in f32) and the weights (2.2 / 4.3 MB) are read once per
// launch, so at any realistic cell count the kernel is bound by operations:
// at 989 TFLOP/s dense bf16 (H100 SXM), 3.079 ms for the 4,096 + 17,888
// cells of one bf16 image at 257^3; at 67 TFLOP/s on the FMA units, 45.45
// ms for the same cells in f32.
//
// Both types share the delivery of the weights: a persistent grid (one
// block per SM, each walking its cells, one 64-point cell at a time), a
// producer feeding a ring of weight tiles with cp.async.bulk and full/empty
// mbarriers, and clusters of CS = 2 blocks that multicast each tile.
//
// bf16: 384 threads per block.
//  * Tensor cores through wgmma (m64n128k16). Two consumer warpgroups each
//    compute 128 output columns for all 64 rows per pass: one pass for the
//    256-wide layers, two for the 512-wide ones. A is the activation
//    buffer, B a weight tile, both read by descriptor from shared memory;
//    the f32 sums stay in registers, 64 a thread. (One m64n256 pass of 128
//    sums a thread made ptxas serialise the wgmmas for want of registers.)
//  * One [64, 512] bf16 activation buffer (64 KB) in the K-major
//    128-byte-swizzled layout a descriptor reads. The first pass's output
//    is packed to bf16 in slices while the second pass's products run, and
//    waits in registers while that pass still reads the input; once both
//    warpgroups are done (named barrier) the epilogue writes the layer
//    over its input: no second buffer, no f32 staging.
//  * Weights stream through a ring of 4 stages of 32 KB, one tile = 64
//    rows x 256 columns of a layer, laid out on the host by tile_weights in
//    consumption order and already in the MN-major swizzled layout wgmma
//    reads. One thread of a producer warpgroup keeps 4 tiles in flight
//    with cp.async.bulk and full/empty mbarriers (~4 x 512 clocks of
//    tensor work, more than an L2 round trip); the stream runs on from one
//    cell to the next (every cell reads the same weights), so the ring
//    never drains. setmaxnreg gives the consumers 232 registers and the
//    producer 40.
//  * A cluster of CS = 2 blocks shares each tile: every block copies half
//    of it with .multicast::cluster into both, so one fetch from L2 serves
//    128 points (weight traffic per bf16 image at 257^3: 24 GB, against
//    48 GB at one block per fetch). Each block's empty barrier counts the
//    consumer warpgroups of all CS blocks before its stage is refilled; the
//    producer waits for the last releases before it exits, so no arrive
//    lands on a finished block. The wrapper pads a launch's cells to whole
//    clusters (fused_decode_cluster() gives CS). Measured on an H100, the
//    weight traffic is not what bounds the kernel: clusters of 1, 2 and 4
//    blocks took 6.3, 6.1 and 6.8 ms per image (PERF.md), hence 2.
//  * The epilogue stays in registers: f32 bias and the small weights from
//    shared memory (small_params, copied once per block), the sampled
//    feature (the local stream's fold2/conv1: each tile's hook in that
//    layer loads the four taps of a slice of columns and sums the slice
//    before, so the gathers run under the products), NaN-keeping ReLU,
//    bf16, stored straight into the swizzled buffer. The last layer (256
//    -> out) runs in the epilogue of the layer before it.
//  * fold1/conv1 (K = 3) runs on the FMA units into the swizzled buffer.
// What still holds it under half the bound (phase stamps of the K1_TRACE
// build, ops/k1_trace.py; PERF.md): the MMA loops run near 80% of the
// tensor peak, close to what shared memory can feed them (the tiles'
// writes, their reads and the two passes' reads of the activations are
// ~5 MB a cell at 128 B a clock), the feature gathers stretch the local
// stream's 512-wide layer, and the epilogues, the first layer and the
// set-up leave the tensor cores idle for ~30% of a cell's time.
//
// f32, the path the default Config() runs (compute_dtype "float32"): the
// FMA units, no tensor cores (no TF32), 384 threads per block: 8 consumer
// warps (232 registers each by setmaxnreg) and a producer warpgroup.
//  * Each consumer thread owns 8 points x N/32 columns of a layer (8 x 8
//    for the 256-wide layers, 8 x 16 for the 512-wide ones), all of N in
//    one pass, the sums in registers (up to 128 a thread). A step of k
//    reads the thread's 8 activations and its columns' weights with 16-byte
//    shared loads, 6 per 128 FFMA (4 per 64 in the 256-wide layers): the 8
//    lanes of a quarter warp share their points and read 128 contiguous
//    bytes of the weight row, and the four quarters share those weights.
//  * One [512, 64] f32 activation buffer (128 KB), K-major (a column's 64
//    points in 256 bytes, 16-byte chunks swizzled by the column, chunk_off),
//    so a step reads one column; each layer is written over its input once
//    every warp has read it (a named barrier), from the registers.
//  * Weights stream through a ring of 4 stages of 16 KB: a tile is 16 rows
//    of a 256-wide weight or 8 of a 512-wide one, i.e. the weights as they
//    lie in memory, concatenated in consumption order by tile_weights. One
//    producer thread keeps the ring full; each block of the cluster copies
//    half of a tile with .multicast::cluster, so one L2 fetch serves 128
//    points (4.33 MB a cluster's cell pair: 47.5 GB per f32 image at 257^3,
//    against 190 GB when each 32-point block fetched them all). Each
//    consumer warp releases a stage to every block of the cluster.
//  * The epilogues stay in registers: f32 bias after the f32 sums, then the
//    sampled feature, NaN-keeping ReLU. The last layer (256 -> out) runs in
//    the epilogue of the layer before it: each thread's partial sums over
//    its columns, a shuffle across the quarter warp and a sum of the four
//    column quarters in shared memory.
//  * The local stream's feature gathers run under the 512-wide fold2/conv1
//    products: a thread gathers its own outputs' features a slice a tile
//    and leaves each sum where its epilogue reads it (Gather).
//  * fold1/conv1 (K = 3) runs on the FMA units into the buffer.
// What holds it at ~72% of the bound (K1_TRACE stamps, PERF.md): the
// product loops, 98% of a cell's time, issue at 0.72-0.78 of the FMA floor
// (their code is 92% FFMA; loading the activations once per 4 steps
// instead of every step gained ~4%, so shared memory is not the limit),
// and the gathers slow the local stream's wp loop from ~0.77 to ~0.70.
//
// Rounding follows _fused_kernel: bilinear weights are cast to the compute
// type, sampled features are stored in the compute type, every ReLU output
// is cast to the compute type, biases are f32 and added after the f32
// accumulation, then the feature; taps past the last row or column weigh 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int PTS_PER_CELL = 64;  // stride 4, 4^3 points
constexpr int STRIDE = 4;
constexpr int C_FEAT = 512;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}
template <typename T>
__device__ __forceinline__ float round_cd(float x) {
  return to_f(from_f<T>(x));
}
// ReLU that keeps NaN, as torch.relu does (fmaxf(v, 0) would give 0)
__device__ __forceinline__ float relu(float v) {
  return (v != v) ? v : (v > 0.f ? v : 0.f);
}

struct Args {
  // w2, w3, wp, w4 of the global stream, then of the local one, as ring
  // tiles in the compute type (tile_weights)
  const void* tiles;
  // small_params: per stream the f32 biases (g_contrib folded into the
  // global stream's fold2/conv1 bias), w1 and w5, [2, P_STREAM]
  const float* params;
  const void* map;
  const float* trans;  // [4,3]
  const float* geom;   // [6] lo_xyz, hi_xyz
  const int* cells;
  float* out;  // [n*64, out_dim]
  int n_cells, fine_r, coarse_c, img_w, img_h, out_dim;
};

// Points (rounded to the compute type), projection and bilinear taps of
// point `i` of the block whose first point is p0 (one thread per point).
template <typename T>
__device__ __forceinline__ void point_taps(const Args& args, size_t p0, int i,
                                           float* pts, int* tidx, float* tw) {
  const size_t gp = p0 + i;
  const int cell = args.cells[gp / PTS_PER_CELL];
  const int off = (int)(gp % PTS_PER_CELL);
  const int c = args.coarse_c;
  const int cz = cell / (c * c), cy = (cell / c) % c, cx = cell % c;
  const int f[3] = {cx * STRIDE + off % STRIDE,
                    cy * STRIDE + (off / STRIDE) % STRIDE,
                    cz * STRIDE + off / (STRIDE * STRIDE)};
  const float denom = (float)(args.fine_r - 1);
  float xyz[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float lo = args.geom[d];
    const float span = __fsub_rn(args.geom[3 + d], lo);
    // lo + f / denom * span, each step rounded (no contraction)
    xyz[d] = __fadd_rn(lo, __fmul_rn(__fdiv_rn((float)f[d], denom), span));
    pts[i * 3 + d] = round_cd<T>(xyz[d]);  // the first layer's input
  }
  const float* t = args.trans;
  float uvw[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    float s = __fmul_rn(xyz[0], t[0 * 3 + j]);
    s = __fadd_rn(s, __fmul_rn(xyz[1], t[1 * 3 + j]));
    s = __fadd_rn(s, __fmul_rn(xyz[2], t[2 * 3 + j]));
    uvw[j] = __fadd_rn(s, t[3 * 3 + j]);
  }
  // IEEE divide, then clamp; NaN passes through as in torch.clamp
  // (fminf/fmaxf would swallow it)
  const float wmax = (float)(args.img_w - 1), hmax = (float)(args.img_h - 1);
  float px = __fdiv_rn(uvw[0], uvw[2]);
  float py = __fdiv_rn(uvw[1], uvw[2]);
  px = (px != px) ? px : (px < 0.f ? 0.f : (px > wmax ? wmax : px));
  py = (py != py) ? py : (py < 0.f ? 0.f : (py > hmax ? hmax : py));
  const float x0f = floorf(px), y0f = floorf(py);
  const float wx = __fsub_rn(px, x0f), wy = __fsub_rn(py, y0f);
  const bool vx1 = x0f + 1.f <= wmax, vy1 = y0f + 1.f <= hmax;
  const int x0 = (x0f >= 0.f && x0f <= wmax) ? (int)x0f : 0;
  const int y0 = (y0f >= 0.f && y0f <= hmax) ? (int)y0f : 0;
  const float ux = __fsub_rn(1.f, wx), uy = __fsub_rn(1.f, wy);
  const int base = y0 * args.img_w + x0;
  tidx[i * 4 + 0] = base;
  tidx[i * 4 + 1] = vx1 ? base + 1 : base;
  tidx[i * 4 + 2] = vy1 ? base + args.img_w : base;
  tidx[i * 4 + 3] = (vx1 && vy1) ? base + args.img_w + 1 : base;
  tw[i * 4 + 0] = round_cd<T>(__fmul_rn(ux, uy));
  tw[i * 4 + 1] = vx1 ? round_cd<T>(__fmul_rn(wx, uy)) : 0.f;
  tw[i * 4 + 2] = vy1 ? round_cd<T>(__fmul_rn(ux, wy)) : 0.f;
  tw[i * 4 + 3] = (vx1 && vy1) ? round_cd<T>(__fmul_rn(wx, wy)) : 0.f;
}

// ================ bf16: wgmma, bulk-copy weight ring, cluster ================

namespace hop {

// Phase stamps for the trace build (-DK1_TRACE, disn_tpu_torch/ops/
// k1_trace.py), in both kernels: threads 0 and 128 (the first thread of
// each consumer warpgroup, or of f32's warps 0 and 4) write clock64() at
// the end of each phase into k1_trace[(block * 2 + w) * TRACE_EVENTS].
// Events: 0 entry, 1 set-up done, then per stream s at 2 + 9 s: +0 first
// layer, +1/+2 product loop / epilogue of w2, +3/+4 w3, +5/+6 wp, +7/+8 w4
// (its epilogue runs the last layer). f32 only, event GATHER_EVENT: the
// clocks the local stream's feature gathers took in its wp layer (a
// duration, not a stamp).
#ifdef K1_TRACE
constexpr int TRACE_EVENTS = 21;
constexpr int GATHER_EVENT = 20;
__device__ long long* k1_trace;
#define K1_RECORD(e, v)                                                 \
  do {                                                                  \
    if ((threadIdx.x & 127) == 0 && threadIdx.x < 256)                  \
      hop::k1_trace[((size_t)blockIdx.x * 2 + (threadIdx.x >> 7)) *     \
                        hop::TRACE_EVENTS + (e)] = (v);                 \
  } while (0)
#define K1_STAMP(e) K1_RECORD(e, clock64())
#else
#define K1_RECORD(e, v) \
  do {                  \
  } while (0)
#define K1_STAMP(e) \
  do {              \
  } while (0)
#endif

constexpr int M = 64;           // points per block (one cell)
constexpr int CS = 2;           // blocks (cells) per cluster sharing a tile
static_assert(CS == 2 || CS == 4, "the ring multicasts within a cluster");
constexpr int CONSUMERS = 256;  // two consumer warpgroups
constexpr int THREADS = 384;    // + one producer warpgroup
constexpr int STAGES = 4;
// setmaxnreg moves registers between the warpgroups within the block's
// launch allocation (384 threads x 168)
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
static_assert(128 * PRODUCER_REGS + 256 * CONSUMER_REGS <= THREADS * 168,
              "register split exceeds the launch allocation");
constexpr int TILE_K = 64, TILE_N = 256;  // one ring tile of a weight
constexpr int TILE_BYTES = TILE_K * TILE_N * 2;
constexpr int TILES_PER_STREAM = 33;  // 1 + 8 + 16 + 8 (w2, w3, wp, w4)
constexpr int TILES = 2 * TILES_PER_STREAM;
constexpr int KBLOCK_BYTES = M * 128;  // 64 activation columns, all rows

// per stream, as f32 (small_params in ops/fused_decode.py lays them out):
// biases b1..b6 (b6 padded to 4), w1 [3, 64] and w5 [256, out] (padded to
// [256, 2])
constexpr int P_B1 = 0, P_B2 = 64, P_B3 = 320, P_B4 = 832, P_B5 = 1344,
              P_B6 = 1600, P_W1 = 1604, P_W5 = 1796, P_STREAM = 2308;

// shared memory, from a 1024-byte-aligned base (swizzle atoms are 1 KB)
constexpr uint32_t off_act = 0;
constexpr uint32_t off_ring = off_act + 8 * KBLOCK_BYTES;
constexpr uint32_t off_par = off_ring + STAGES * TILE_BYTES;
constexpr uint32_t off_pts = off_par + 2 * P_STREAM * 4;
constexpr uint32_t off_tidx = off_pts + M * 3 * 4;
constexpr uint32_t off_tw = off_tidx + M * 4 * 4;
constexpr uint32_t off_pred = off_tw + M * 4 * 4;
constexpr uint32_t off_red = off_pred + M * 2 * 4;
constexpr uint32_t off_bar = off_red + M * 2 * 4;  // full[STAGES], empty[..]
constexpr uint32_t smem_total = off_bar + 2 * STAGES * 8 + 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// byte offset of activation (row m, column k) in the K-major 128-byte
// swizzle: 64-column blocks of [64 rows][128 B], 16-byte chunk ^ (m % 8)
__device__ __forceinline__ uint32_t act_off(int m, int k) {
  return (k >> 6) * KBLOCK_BYTES + m * 128 +
         ((((k >> 3) & 7) ^ (m & 7)) << 4) + ((k & 7) << 1);
}

// wgmma shared-memory descriptor, 128-byte swizzle
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// ---- mbarriers, bulk copies, cluster ----
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}
// Spins until the phase of parity `parity` has completed. A wait that no
// arrival can end (a broken ring) traps after 2^35 clocks (~20 s) instead
// of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  const long long t0 = clock64();
  do {
    if (clock64() - t0 > (1ll << 35)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
// arrive on the barrier at the same offset in block `rank` of the cluster
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar,
                                                    uint32_t rank) {
  asm volatile(
      "{\n.reg .b32 ra;\n"
      "mapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [ra];\n}\n" ::
          "r"(bar),
      "r"(rank)
      : "memory");
}
// the same bytes into every block of `mask`, at the same offsets
__device__ __forceinline__ void bulk_g2s_multicast(uint32_t dst,
                                                   const void* src,
                                                   uint32_t bytes,
                                                   uint32_t bar,
                                                   uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "h"(mask)
      : "memory");
}
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;" ::
          : "memory");
}
// generic-proxy shared-memory writes -> visible to wgmma (async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
// the two consumer warpgroups only (barrier 0 is __syncthreads)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 256;" ::: "memory");
}

// ---- wgmma ----
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define D8(i)                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),       \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// D[64 x 128] += A[64 x 16] (K-major) * B[16 x 128] (MN-major), f32 sums
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56)
      : "l"(da), "l"(db), "r"(1));
}
#undef D8

// What a consumer thread needs across layers.
struct Ctx {
  unsigned char* act;  // generic pointer to the activation buffer
  uint32_t act_s;      // its shared address
  uint32_t ring_s;     // shared address of stage 0
  uint32_t full, empty;
  int wg;              // consumer warpgroup, 0 or 1
  const bf16* map;
  const int* tidx;     // [64, 4] bilinear taps: map rows
  const float* tw;     // [64, 4] and their weights, rounded to bf16
};

// The last layer, 256 -> out, fused into the epilogue of the layer before.
struct Last {
  const float* w5;  // [256, 2] in shared memory
  const float* b6;
  int O;
  float* pred;  // [64, 2] shared: the global stream's output
  float* red;   // [64, 2] shared: warpgroup 1's partial sums
  float* out;   // the block's first output row
  bool to_out;  // local stream: write pred + this to out
};

// Hand stage `s` back: lane 0 of warp q of the warpgroup arrives on block
// q's empty barrier, for q < CS (each block's barrier counts the consumer
// warpgroups of all CS blocks, whose multicast refills it).
__device__ __forceinline__ void release(const Ctx& c, int s) {
  const uint32_t q = (threadIdx.x >> 5) & 3;
  if ((threadIdx.x & 31) == 0 && q < CS)
    mbar_arrive_cluster(c.empty + 8 * s, q);
}

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}
// bf16(relu(a)), bf16(relu(b)): rounding first and then a NaN-keeping max
// with 0 gives the same values in two instructions
__device__ __forceinline__ uint32_t relu2(float a, float b) {
  const __nv_bfloat162 h = __hmax2_nan(__floats2bfloat162_rn(a, b),
                                       __float2bfloat162_rn(0.f));
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ float lo_f(uint32_t u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float hi_f(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}

// One pass of a layer on the tensor cores: this warpgroup's 128 output
// columns for all 64 rows, from K_TILES ring tiles of 64 weight rows.
// hook(t) runs while tile t's products are in flight.
template <int K_TILES, typename Hook>
__device__ __forceinline__ void mma_pass(const Ctx& c, int& it,
                                         float (&d)[64], Hook&& hook) {
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  int prev = 0;
#pragma unroll
  for (int t = 0; t < K_TILES; ++t, ++it) {
    const int s = it % STAGES;
    mbar_wait(c.full + 8 * s, (it / STAGES) & 1);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < TILE_K / 16; ++j) {
      const uint64_t da =
          sw128_desc(c.act_s + t * KBLOCK_BYTES + j * 32, 16, 1024);
      const uint64_t db = sw128_desc(
          c.ring_s + s * TILE_BYTES + c.wg * (TILE_BYTES / 2) + j * 2048,
          TILE_K / 8 * 1024, 1024);
      wgmma_m64n128(d, da, db);
    }
    wgmma_commit();
    hook(t);
    if (t > 0) {  // the previous tile's products are done: free its stage
      wgmma_wait<1>();
      release(c, prev);
    }
    prev = s;
  }
  wgmma_wait<0>();
  fence_acc(d);
  release(c, prev);
}

enum Epilogue { STORE, FEAT, LAST };

// bf16(relu(sum + bias)) of accumulator group j, rows r0 and r1 at
// columns (col, col + 1), as two words
__device__ __forceinline__ void out_pair(const float (&d)[64], int j,
                                         int col, const float* bias,
                                         uint32_t& o0, uint32_t& o1) {
  const float2 b = *reinterpret_cast<const float2*>(bias + col);
  o0 = relu2(d[4 * j] + b.x, d[4 * j + 1] + b.y);
  o1 = relu2(d[4 * j + 2] + b.x, d[4 * j + 3] + b.y);
}

// One layer, [64, K] @ [K, 256 * PASSES], bias in shared memory. Pass p
// gives this warpgroup columns 256 p + 128 wg + [0, 128): 64 accumulators
// a thread. The first pass's output waits packed in bf16 (32 words) while
// the second pass still reads the input. Then, over the input,
// act[:, :256 * PASSES] = bf16(relu(sum + bias)) (STORE), with the sampled
// feature added after the bias (FEAT); LAST instead feeds those values
// straight into the last layer and writes the block's output.
template <int PASSES, int K_TILES, Epilogue EPI>
__device__ __forceinline__ void wg_layer(const Ctx& c, int& it,
                                         const float* bias, int ev,
                                         const Last& last) {
  // accumulator d[4j + e]: row r0 (e < 2) or r1, column col_of(p, j) +
  // (e & 1)
  const int lane = threadIdx.x & 31, wq = (threadIdx.x >> 5) & 3;
  const int r0 = wq * 16 + (lane >> 2), r1 = r0 + 8;
  const int x = lane >> 2;  // r0 % 8 == r1 % 8
  auto col_of = [&](int p, int j) {
    return 256 * p + 128 * c.wg + 8 * j + 2 * (lane & 3);
  };
  // byte offset of (r0, col_of(p, j)) in the swizzled activations
  auto off_of = [&](int p, int j) {
    return (4 * p + 2 * c.wg + (j >> 3)) * KBLOCK_BYTES + r0 * 128 +
           (((j & 7) ^ x) << 4) + (lane & 3) * 4;
  };
  static_assert(PASSES == 1 || PASSES == 2, "one or two passes");
  uint32_t keep[32];
  float d[64];
  if constexpr (PASSES == 1) {
    mma_pass<K_TILES>(c, it, d, [](int) {});
  } else if constexpr (EPI == FEAT) {
    // Each pass's features are gathered under its own products: each
    // tile's hook loads the taps of a slice of columns and sums the slice
    // before, so the loads run while the tensor cores work. The first
    // pass's values (sum, bias, feature) then pack in slices under the
    // second pass.
    constexpr int SLICE = 16 / K_TILES;
    float d0[64];
    uint32_t raw[2][SLICE][2][4];  // [tile parity][slice column][row][tap]
    uint32_t fw[32];  // a pass's feature pairs, rows r0, r1 per group j
    int ti[2][4];
    float wt[2][4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      ti[0][t] = c.tidx[r0 * 4 + t];
      ti[1][t] = c.tidx[r1 * 4 + t];
      wt[0][t] = c.tw[r0 * 4 + t];
      wt[1][t] = c.tw[r1 * 4 + t];
    }
    auto load_slice = [&](int p, int t) {
#pragma unroll
      for (int jj = 0; jj < SLICE; ++jj)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int tp = 0; tp < 4; ++tp)
            raw[t & 1][jj][i][tp] = __ldg(reinterpret_cast<const unsigned*>(
                c.map + (size_t)ti[i][tp] * C_FEAT +
                col_of(p, SLICE * t + jj)));
    };
    auto sum = [&](int t) {
#pragma unroll
      for (int jj = 0; jj < SLICE; ++jj)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float f0 = 0.f, f1 = 0.f;
#pragma unroll
          for (int tp = 0; tp < 4; ++tp) {
            f0 = fmaf(wt[i][tp], lo_f(raw[t & 1][jj][i][tp]), f0);
            f1 = fmaf(wt[i][tp], hi_f(raw[t & 1][jj][i][tp]), f1);
          }
          fw[2 * (SLICE * t + jj) + i] = pack2(f0, f1);  // bf16 features
        }
    };
    mma_pass<K_TILES>(c, it, d0, [&](int t) {
      if (t > 0) sum(t - 1);
      load_slice(0, t);
    });
    sum(K_TILES - 1);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float2 b = *reinterpret_cast<const float2*>(bias + col_of(0, j));
      d0[4 * j] = d0[4 * j] + b.x + lo_f(fw[2 * j]);
      d0[4 * j + 1] = d0[4 * j + 1] + b.y + hi_f(fw[2 * j]);
      d0[4 * j + 2] = d0[4 * j + 2] + b.x + lo_f(fw[2 * j + 1]);
      d0[4 * j + 3] = d0[4 * j + 3] + b.y + hi_f(fw[2 * j + 1]);
    }
    mma_pass<K_TILES>(c, it, d, [&](int t) {
      if (t > 0) sum(t - 1);
      load_slice(1, t);
#pragma unroll
      for (int jj = 0; jj < SLICE; ++jj) {
        const int j = SLICE * t + jj;
        keep[2 * j] = relu2(d0[4 * j], d0[4 * j + 1]);
        keep[2 * j + 1] = relu2(d0[4 * j + 2], d0[4 * j + 3]);
      }
    });
    sum(K_TILES - 1);  // fw: the second pass's features
#pragma unroll
    for (int j = 0; j < 16; ++j) {  // its values get the feature here
      const float2 b = *reinterpret_cast<const float2*>(bias + col_of(1, j));
      d[4 * j] = d[4 * j] + b.x + lo_f(fw[2 * j]);
      d[4 * j + 1] = d[4 * j + 1] + b.y + hi_f(fw[2 * j]);
      d[4 * j + 2] = d[4 * j + 2] + b.x + lo_f(fw[2 * j + 1]);
      d[4 * j + 3] = d[4 * j + 3] + b.y + hi_f(fw[2 * j + 1]);
    }
  } else {
    // the first pass's epilogue values are computed in slices while the
    // second pass's products run
    float d0[64];
    mma_pass<K_TILES>(c, it, d0, [](int) {});
    constexpr int SLICE = 16 / K_TILES;
    mma_pass<K_TILES>(c, it, d, [&](int t) {
#pragma unroll
      for (int jj = 0; jj < SLICE; ++jj) {
        const int j = SLICE * t + jj;
        out_pair(d0, j, col_of(0, j), bias, keep[2 * j], keep[2 * j + 1]);
      }
    });
  }
  K1_STAMP(ev);
  consumer_sync();  // both warpgroups are done reading the activations

  if constexpr (EPI == LAST) {
    float s0[2] = {0.f, 0.f}, s1[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = col_of(0, j);
      uint32_t h0, h1;
      out_pair(d, j, col, bias, h0, h1);
#pragma unroll
      for (int o = 0; o < 2; ++o) {
        if (o < last.O) {
          const float wa = last.w5[col * 2 + o];
          const float wb = last.w5[(col + 1) * 2 + o];
          s0[o] = fmaf(hi_f(h0), wb, fmaf(lo_f(h0), wa, s0[o]));
          s1[o] = fmaf(hi_f(h1), wb, fmaf(lo_f(h1), wa, s1[o]));
        }
      }
    }
    // the four lanes of a row hold its 8-column groups; warpgroup 1 hands
    // its half of K to warpgroup 0, which adds the bias and writes
#pragma unroll
    for (int o = 0; o < 2; ++o) {
#pragma unroll
      for (int dd = 1; dd < 4; dd <<= 1) {
        s0[o] += __shfl_xor_sync(0xffffffff, s0[o], dd);
        s1[o] += __shfl_xor_sync(0xffffffff, s1[o], dd);
      }
    }
    const bool writer = (lane & 3) == 0;
    if (c.wg == 1 && writer) {
      for (int o = 0; o < last.O; ++o) {
        last.red[r0 * 2 + o] = s0[o];
        last.red[r1 * 2 + o] = s1[o];
      }
    }
    consumer_sync();
    if (c.wg == 0 && writer) {
      for (int o = 0; o < last.O; ++o) {
        const float v0 = (s0[o] + last.red[r0 * 2 + o]) + last.b6[o];
        const float v1 = (s1[o] + last.red[r1 * 2 + o]) + last.b6[o];
        if (last.to_out) {
          last.out[r0 * last.O + o] = last.pred[r0 * 2 + o] + v0;
          last.out[r1 * last.O + o] = last.pred[r1 * 2 + o] + v1;
        } else {
          last.pred[r0 * 2 + o] = v0;
          last.pred[r1 * 2 + o] = v1;
        }
      }
    }
    K1_STAMP(ev + 1);
    return;  // no activations written: the next writer syncs before wgmma
  } else {
    if constexpr (PASSES > 1) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        *reinterpret_cast<uint32_t*>(c.act + off_of(0, j)) = keep[2 * j];
        *reinterpret_cast<uint32_t*>(c.act + off_of(0, j) + 8 * 128) =
            keep[2 * j + 1];
      }
    }
    constexpr int P = PASSES - 1;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      uint32_t o0, o1;
      if constexpr (EPI == FEAT) {  // d holds sum + bias + feature
        o0 = relu2(d[4 * j], d[4 * j + 1]);
        o1 = relu2(d[4 * j + 2], d[4 * j + 3]);
      } else {
        out_pair(d, j, col_of(P, j), bias, o0, o1);
      }
      *reinterpret_cast<uint32_t*>(c.act + off_of(P, j)) = o0;
      *reinterpret_cast<uint32_t*>(c.act + off_of(P, j) + 8 * 128) = o1;
    }
  }
  fence_proxy_async();
  consumer_sync();  // the output is complete before the next layer reads it
  K1_STAMP(ev + 1);
}

// Both streams of the cell whose first point is p0; `it` is the ring
// position, carried from cell to cell.
__device__ __forceinline__ void run_consumer(const Args& args, const Ctx& c,
                                             const float* par,
                                             const float* pts, float* pred,
                                             float* red, size_t p0, int& it) {
  const int tid = threadIdx.x;
#pragma unroll 1
  for (int s = 0; s < 2; ++s) {
    const float* ps = par + s * P_STREAM;
    // fold1 conv1, 3 -> 64 (points already rounded to bf16): thread owns
    // column n for rows tid / 64 + 4 i
    {
      const int n = tid & 63;
      const float wa = ps[P_W1 + n], wb = ps[P_W1 + 64 + n];
      const float wc = ps[P_W1 + 128 + n], bn = ps[P_B1 + n];
#pragma unroll
      for (int i = 0; i < M / 4; ++i) {
        const int m = (tid >> 6) + 4 * i;
        float v = fmaf(pts[m * 3], wa, 0.f);
        v = fmaf(pts[m * 3 + 1], wb, v);
        v = fmaf(pts[m * 3 + 2], wc, v);
        *reinterpret_cast<bf16*>(c.act + act_off(m, n)) =
            from_f<bf16>(relu(v + bn));
      }
    }
    fence_proxy_async();
    consumer_sync();
    const int ev = 2 + 9 * s;
    K1_STAMP(ev);
    const Last last = {ps + P_W5, ps + P_B6, args.out_dim, pred, red,
                       args.out + p0 * args.out_dim, s == 1};
    wg_layer<1, 1, STORE>(c, it, ps + P_B2, ev + 1, last);  // 64->256
    wg_layer<2, 4, STORE>(c, it, ps + P_B3, ev + 3, last);  // 256->512
    if (s == 0)                                                 // 512->512
      wg_layer<2, 8, STORE>(c, it, ps + P_B4, ev + 5, last);
    else
      wg_layer<2, 8, FEAT>(c, it, ps + P_B4, ev + 5, last);
    // 512 -> 256 -> out
    wg_layer<1, 8, LAST>(c, it, ps + P_B5, ev + 7, last);
  }
}

__global__ void __launch_bounds__(THREADS, 1) decode_kernel(const Args args) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the same offset in every block of the cluster, so multicast copies
  // land at the same place
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* par = reinterpret_cast<float*>(smem + off_par);
  float* pts = reinterpret_cast<float*>(smem + off_pts);
  int* tidx = reinterpret_cast<int*>(smem + off_tidx);
  float* tw = reinterpret_cast<float*>(smem + off_tw);
  float* pred = reinterpret_cast<float*>(smem + off_pred);
  float* red = reinterpret_cast<float*>(smem + off_red);
  const uint32_t full = smem_u32(smem + off_bar);
  const uint32_t empty = full + 8 * STAGES;
  const int tid = threadIdx.x;
  // Persistent: cluster k of the grid's n_clusters decodes the groups of CS
  // cells k, k + n_clusters, ...; its block of rank r the cell g * CS + r.
  const int n_clusters = gridDim.x / CS;
  const int rank = (int)cluster_rank();
  const int groups = args.n_cells / CS;
  const int first = blockIdx.x / CS;
  const int n_mine = first < groups ? (groups - first - 1) / n_clusters + 1
                                    : 0;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2 * CS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  cluster_sync();  // peers' barriers are initialised

  if (tid >= CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS)
                 : "memory");
    if (tid == CONSUMERS) {  // one thread keeps the ring full
      const unsigned char* src =
          reinterpret_cast<const unsigned char*>(args.tiles);
      const uint32_t ring = smem_u32(smem + off_ring);
      constexpr uint32_t SLICE = TILE_BYTES / CS;
      const int n = n_mine * TILES;  // the same weights for every cell
      for (int i = 0; i < n; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(empty + 8 * s, ((i / STAGES) - 1) & 1);
        mbar_expect_tx(full + 8 * s, TILE_BYTES);
        const uint32_t dst = ring + s * TILE_BYTES + rank * SLICE;
        const unsigned char* from =
            src + (size_t)(i % TILES) * TILE_BYTES + rank * SLICE;
        bulk_g2s_multicast(dst, from, SLICE, full + 8 * s,
                           (uint16_t)((1u << CS) - 1));
      }
      // the last releases, some of them remote, land before this block ends
      for (int i = n; i < n + STAGES; ++i)
        if (i >= STAGES)
          mbar_wait(empty + 8 * (i % STAGES), ((i / STAGES) - 1) & 1);
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS)
                 : "memory");
    for (int i = tid; i < 2 * P_STREAM / 4; i += CONSUMERS)
      reinterpret_cast<float4*>(par)[i] =
          __ldg(reinterpret_cast<const float4*>(args.params) + i);
    Ctx c;
    c.act = smem + off_act;
    c.act_s = smem_u32(c.act);
    c.ring_s = smem_u32(smem + off_ring);
    c.full = full;
    c.empty = empty;
    c.wg = tid >> 7;
    c.map = static_cast<const bf16*>(args.map);
    c.tidx = tidx;
    c.tw = tw;
    int it = 0;
    for (int k = 0; k < n_mine; ++k) {
      const size_t p0 = ((size_t)(first + k * n_clusters) * CS + rank) * M;
      K1_STAMP(0);
      // the previous cell's last reads of the taps are behind a barrier
      if (tid < M) point_taps<bf16>(args, p0, tid, pts, tidx, tw);
      consumer_sync();
      K1_STAMP(1);
      run_consumer(args, c, par, pts, pred, red, p0, it);
    }
  }
}

}  // namespace hop

// ================ f32: FMA units, bulk-copy weight ring, cluster ================

namespace f32 {

using hop::P_B1;
using hop::P_B2;
using hop::P_B3;
using hop::P_B4;
using hop::P_B5;
using hop::P_B6;
using hop::P_STREAM;
using hop::P_W1;
using hop::P_W5;

constexpr int M = 64;            // points per block (one cell)
constexpr int CS = hop::CS;      // blocks (cells) per cluster sharing a tile
constexpr int CONSUMERS = 256;   // 8 warps: 2 point halves x 4 column quarters
constexpr int THREADS = 384;     // + one producer warpgroup
// setmaxnreg moves registers between the warpgroups within the block's
// launch allocation (384 threads x 168): the consumers' sums and a slice
// of gathered taps need more than 168 a thread
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
static_assert(128 * PRODUCER_REGS + CONSUMERS * CONSUMER_REGS <=
                  THREADS * 168,
              "register split exceeds the launch allocation");
constexpr int STAGES = 4;
constexpr int TILE_FLOATS = 4096;  // a ring tile: 4096 / N rows of [K, N]
constexpr int TILE_BYTES = TILE_FLOATS * 4;
constexpr int TILES_PER_STREAM =
    (64 * 256 + 256 * 512 + 512 * 512 + 512 * 256) / TILE_FLOATS;  // 132
constexpr int TILES = 2 * TILES_PER_STREAM;
constexpr int COL_BYTES = M * 4;  // one activation column: 64 points
// the local stream's wp: features of its columns >= F_COL0 (the last its
// products read) wait in their own buffer; the others in the column itself
constexpr int F_COL0 = 448;
constexpr int SLICES = 16;  // a thread's gather slices (Gather)

// shared memory, from a 128-byte-aligned base
constexpr uint32_t off_act = 0;  // [512 columns][64 points], chunk_off
constexpr uint32_t off_ring = off_act + 512 * COL_BYTES;
constexpr uint32_t off_feat = off_ring + STAGES * TILE_BYTES;
constexpr uint32_t off_pts = off_feat + (512 - F_COL0) * COL_BYTES;
constexpr uint32_t off_tidx = off_pts + M * 3 * 4;
constexpr uint32_t off_tw = off_tidx + M * 4 * 4;
constexpr uint32_t off_pred = off_tw + M * 4 * 4;
constexpr uint32_t off_red = off_pred + M * 2 * 4;  // [4 quarters][64][2]
constexpr uint32_t off_bar = off_red + 4 * M * 2 * 4;  // full, empty
constexpr uint32_t smem_total = off_bar + 2 * STAGES * 8 + 128;
static_assert(smem_total <= 232448, "over the 227 KB a block can have");

// Byte offset of the 16-byte chunk of activation column k that holds points
// 4 ch .. 4 ch + 3. Chunks are swizzled by (k / 4) % 8: the 8 lanes of a
// quarter warp store columns 4 apart in an epilogue and so hit 8 different
// bank groups; a product step reads one column, a permutation of its chunks.
__device__ __forceinline__ uint32_t chunk_off(int k, int ch) {
  return k * COL_BYTES + ((ch ^ ((k >> 2) & 7)) << 4);
}

// What a consumer thread needs across layers. Warp w, lane l: point half
// w / 4, column quarter w % 4; quarter warp l / 8 picks 8 points, lane
// l % 8 four columns of each 128.
struct Ctx {
  unsigned char* act;         // [512, 64] f32 activations, K-major
  unsigned char* feat;        // [512 - F_COL0, 64] the late features
  const unsigned char* ring;  // stage 0
  uint32_t full, empty;
  int rc;    // the thread's points: 4 rc .. 4 rc + 7 (chunks rc, rc + 1)
  int col0;  // its columns: 128 j + col0 + [0, 4)
  const float* map;
  const int* tidx;  // [64, 4] bilinear taps: map rows
  const float* tw;  // [64, 4] and their weights
};

// The last layer, 256 -> out, fused into the epilogue of the layer before.
struct Last {
  const float* w5;  // [256, 2] (small_params, device memory)
  const float* b6;
  int O;
  float* pred;  // [64, 2] shared: the global stream's output
  float* red;   // [4, 64, 2] shared: each column quarter's partial sums
  float* out;   // the block's first output row
  bool to_out;  // local stream: write pred + this to out
};

// This warp is done with stage s: lane q < CS arrives on block q's empty
// barrier, which counts the consumer warps of all CS blocks.
__device__ __forceinline__ void release(const Ctx& c, int s) {
  __syncwarp();
  const uint32_t lane = threadIdx.x & 31;
  if (lane < CS) hop::mbar_arrive_cluster(c.empty + 8 * s, lane);
}

// The local stream's sampled features for wp, gathered while its products
// run. A thread's 8 points x 16 columns are SLICES slices of 2 points x 4
// columns x 4 taps (8 loads of 16 bytes). A slice's sums go where the
// thread's epilogue reads them: into activation column n itself once no
// warp reads input column n any more, or, for n >= F_COL0, into feat,
// which is free throughout. When a thread passes tile t's full barrier,
// every warp has released tile t - STAGES (the ring refills a stage only
// then), so the columns below 8 (t - STAGES + 1) are free. A thread takes
// its feat slices first, then its columns in order, each group once the
// whole warp's columns are free (a warp whose lanes took their slices at
// different tiles would run the gather path once for each); it issues a
// slice's loads at one tile and sums and stores them at the next, under
// the products; the last slice, issued at the last tile at the latest
// (gather_fits), is stored after the loop, its place already free.
struct Gather {
  float4 raw[2][4];  // [point][tap]
  int next;          // the next slice to issue
  bool pending;      // slice next - 1 is in flight
};

// Both of a warp's column quarter wq (its columns 128 j + 32 wq + [0, 32)
// lie wholly below or at or past F_COL0): the 4-column group j of slice s,
// the j = 3 group first where it waits in feat, and the first tile (8 input
// columns each) at which group j's place is free.
static_assert(F_COL0 % 32 == 0, "a warp's columns of a group share a place");
__host__ __device__ constexpr int slice_group(int wq, int s) {
  return 384 + 32 * wq >= F_COL0 ? ((s >> 2) + 3) & 3 : s >> 2;
}
__host__ __device__ constexpr int free_tile(int wq, int j) {
  return 128 * j + 32 * wq >= F_COL0
             ? 0
             : (128 * j + 32 * wq + 32 + 7) / 8 + STAGES - 1;
}
// every warp issues its last slice by the wp layer's last tile (64 of 8
// input columns), one slice a tile
constexpr bool gather_fits() {
  for (int wq = 0; wq < 4; ++wq) {
    int next = 0;
    for (int t = 0; t < 64; ++t)
      if (next < SLICES && t >= free_tile(wq, slice_group(wq, next))) ++next;
    if (next < SLICES) return false;
  }
  return true;
}
static_assert(gather_fits(), "a gather slice would miss the wp loop");
__device__ __forceinline__ unsigned char* feat_at(const Ctx& c, int n,
                                                  int ch) {
  return n >= F_COL0 ? c.feat + chunk_off(n - F_COL0, ch)
                     : c.act + chunk_off(n, ch);
}
__device__ __forceinline__ void gather_issue(const Ctx& c, Gather& g,
                                             int s) {
  const int n = 128 * slice_group(c.col0 >> 5, s) + c.col0;
  const int m0 = 4 * c.rc + 2 * (s & 3);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int tp = 0; tp < 4; ++tp)
      g.raw[i][tp] = __ldg(reinterpret_cast<const float4*>(
          c.map + (size_t)c.tidx[(m0 + i) * 4 + tp] * C_FEAT + n));
}
// four taps summed in f32 (the compute type: no rounding between)
__device__ __forceinline__ void gather_store(const Ctx& c, const Gather& g,
                                             int s) {
  const int n = 128 * slice_group(c.col0 >> 5, s) + c.col0;
  const int m0 = 4 * c.rc + 2 * (s & 3);
  float f[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float4 w = *reinterpret_cast<const float4*>(c.tw + (m0 + i) * 4);
    const float wt[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) f[i][e] = 0.f;
#pragma unroll
    for (int tp = 0; tp < 4; ++tp) {
      const float4 v = g.raw[i][tp];
      f[i][0] = fmaf(wt[tp], v.x, f[i][0]);
      f[i][1] = fmaf(wt[tp], v.y, f[i][1]);
      f[i][2] = fmaf(wt[tp], v.z, f[i][2]);
      f[i][3] = fmaf(wt[tp], v.w, f[i][3]);
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e)
    *reinterpret_cast<float2*>(feat_at(c, n + e, m0 >> 2) + (m0 & 3) * 4) =
        make_float2(f[0][e], f[1][e]);
}

enum Epilogue { STORE, FEAT, LAST };

// One layer, act[:, :K] @ W[K, N] on the FMA units, all N columns in one
// pass: the thread's sums acc[point][4 j + e] for its 8 points and columns
// 128 j + col0 + e. Tiles of TK = 4096 / N weight rows come from the ring.
// Then, over the input once every warp has read it, act[:, :N] =
// relu(sum + bias) (STORE), with the sampled feature added after the bias
// (FEAT); LAST instead feeds those values straight into the last layer and
// writes the block's output.
template <int K, int N, Epilogue EPI>
__device__ __forceinline__ void layer(const Ctx& c, int& it,
                                      const float* bias, int ev,
                                      const Last& last) {
  constexpr int CW = N / 32;  // columns a thread
  constexpr int J = CW / 4;   // its 4-column groups, 128 apart
  constexpr int TK = TILE_FLOATS / N;
  constexpr int NT = K / TK;
  static_assert(TK % 4 == 0 && K % TK == 0, "whole tiles of 4-row steps");
  static_assert(EPI != FEAT || (K == 512 && N == 512),
                "the gather schedule is the 512-wide layer's");
  float acc[8][CW];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int i = 0; i < CW; ++i) acc[r][i] = 0.f;
  Gather g;
  g.next = 0;
  g.pending = false;
#ifdef K1_TRACE
  long long gather_clk = 0;
#endif

#pragma unroll 1
  for (int t = 0; t < NT; ++t, ++it) {
    const int s = it % STAGES;
    hop::mbar_wait(c.full + 8 * s, (it / STAGES) & 1);
    if constexpr (EPI == FEAT) {
#ifdef K1_TRACE
      const long long t0 = clock64();
#endif
      if (g.pending) {
        gather_store(c, g, g.next - 1);
        g.pending = false;
      }
      const int wq = c.col0 >> 5;
      if (g.next < SLICES && t >= free_tile(wq, slice_group(wq, g.next))) {
        gather_issue(c, g, g.next);
        ++g.next;
        g.pending = true;
      }
#ifdef K1_TRACE
      gather_clk += clock64() - t0;
#endif
    }
    const unsigned char* w = c.ring + s * TILE_BYTES + c.col0 * 4;
#pragma unroll
    for (int k4 = 0; k4 < TK; k4 += 4) {
      const int k = t * TK + k4;
      const unsigned char* a = c.act + k * COL_BYTES;
      const int ch = c.rc ^ ((k >> 2) & 7);  // chunk_off; rc is even
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(
            a + kk * COL_BYTES + (ch << 4));
        const float4 a1 = *reinterpret_cast<const float4*>(
            a + kk * COL_BYTES + ((ch ^ 1) << 4));
        const float av[8] = {a0.x, a0.y, a0.z, a0.w,
                             a1.x, a1.y, a1.z, a1.w};
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const float4 wv = *reinterpret_cast<const float4*>(
              w + (k4 + kk) * N * 4 + j * 512);
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            acc[r][4 * j + 0] = fmaf(av[r], wv.x, acc[r][4 * j + 0]);
            acc[r][4 * j + 1] = fmaf(av[r], wv.y, acc[r][4 * j + 1]);
            acc[r][4 * j + 2] = fmaf(av[r], wv.z, acc[r][4 * j + 2]);
            acc[r][4 * j + 3] = fmaf(av[r], wv.w, acc[r][4 * j + 3]);
          }
        }
      }
    }
    release(c, s);
  }
  if constexpr (EPI == FEAT) {
    if (g.pending) gather_store(c, g, g.next - 1);  // its place was free
  }
  K1_STAMP(ev);
  hop::consumer_sync();  // every warp has read the layer's input

  if constexpr (EPI == LAST) {
    float sum[8][2];
#pragma unroll
    for (int r = 0; r < 8; ++r) sum[r][0] = sum[r][1] = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const float4 b4 = __ldg(
          reinterpret_cast<const float4*>(bias + 128 * j + c.col0));
      const float bb[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = 128 * j + c.col0 + e;
        const float2 wo = __ldg(reinterpret_cast<const float2*>(last.w5) + n);
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float v = relu(acc[r][4 * j + e] + bb[e]);
          sum[r][0] = fmaf(v, wo.x, sum[r][0]);
          sum[r][1] = fmaf(v, wo.y, sum[r][1]);
        }
      }
    }
    // the 8 lanes of a quarter warp hold a point's column groups; the four
    // column quarters then meet in shared memory
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int o = 0; o < 2; ++o)
#pragma unroll
        for (int d = 1; d < 8; d <<= 1)
          sum[r][o] += __shfl_xor_sync(0xffffffff, sum[r][o], d);
    if ((threadIdx.x & 7) == 0) {
      const int wq = (threadIdx.x >> 5) & 3;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int m = 4 * c.rc + r;
        last.red[(wq * M + m) * 2 + 0] = sum[r][0];
        last.red[(wq * M + m) * 2 + 1] = sum[r][1];
      }
    }
    hop::consumer_sync();
    if (threadIdx.x < M) {
      const int m = threadIdx.x;
      for (int o = 0; o < last.O; ++o) {
        float v = last.red[m * 2 + o];
#pragma unroll
        for (int wq = 1; wq < 4; ++wq) v += last.red[(wq * M + m) * 2 + o];
        v += __ldg(last.b6 + o);
        if (last.to_out)
          last.out[m * last.O + o] = last.pred[m * 2 + o] + v;
        else
          last.pred[m * 2 + o] = v;
      }
    }
    K1_STAMP(ev + 1);
    return;  // no activations written: the next writer follows a barrier
  } else {
#ifdef K1_TRACE
    if constexpr (EPI == FEAT) K1_RECORD(hop::GATHER_EVENT, gather_clk);
#endif
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const float4 b4 = __ldg(
          reinterpret_cast<const float4*>(bias + 128 * j + c.col0));
      const float bb[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = 128 * j + c.col0 + e;
        float v[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) v[r] = acc[r][4 * j + e] + bb[e];
        if constexpr (EPI == FEAT) {
          const float4 f0 =
              *reinterpret_cast<const float4*>(feat_at(c, n, c.rc));
          const float4 f1 =
              *reinterpret_cast<const float4*>(feat_at(c, n, c.rc + 1));
          v[0] += f0.x;
          v[1] += f0.y;
          v[2] += f0.z;
          v[3] += f0.w;
          v[4] += f1.x;
          v[5] += f1.y;
          v[6] += f1.z;
          v[7] += f1.w;
        }
        *reinterpret_cast<float4*>(c.act + chunk_off(n, c.rc)) =
            make_float4(relu(v[0]), relu(v[1]), relu(v[2]), relu(v[3]));
        *reinterpret_cast<float4*>(c.act + chunk_off(n, c.rc + 1)) =
            make_float4(relu(v[4]), relu(v[5]), relu(v[6]), relu(v[7]));
      }
    }
    hop::consumer_sync();  // the output is complete before the next layer
    K1_STAMP(ev + 1);
  }
}

// fold1/conv1, 3 -> 64, into activation columns 0..63: thread owns column
// n = tid % 64 for the points of chunks tid / 64 + 4 i
__device__ __forceinline__ void first_layer(const Ctx& c, const float* ps,
                                            const float* pts) {
  const int n = threadIdx.x & 63;
  const float wa = __ldg(ps + P_W1 + n), wb = __ldg(ps + P_W1 + 64 + n);
  const float wc = __ldg(ps + P_W1 + 128 + n), bn = __ldg(ps + P_B1 + n);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ch = (threadIdx.x >> 6) + 4 * i;
    float v[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int m = 4 * ch + r;
      float x = fmaf(pts[m * 3], wa, 0.f);
      x = fmaf(pts[m * 3 + 1], wb, x);
      x = fmaf(pts[m * 3 + 2], wc, x);
      v[r] = relu(x + bn);
    }
    *reinterpret_cast<float4*>(c.act + chunk_off(n, ch)) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
}

__global__ void __launch_bounds__(THREADS, 1) decode_kernel(const Args args) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // the same offset in every block of the cluster, so multicast copies
  // land at the same place
  unsigned char* smem =
      smem_raw + ((128 - (hop::smem_u32(smem_raw) & 127)) & 127);
  float* pts = reinterpret_cast<float*>(smem + off_pts);
  int* tidx = reinterpret_cast<int*>(smem + off_tidx);
  float* tw = reinterpret_cast<float*>(smem + off_tw);
  float* pred = reinterpret_cast<float*>(smem + off_pred);
  float* red = reinterpret_cast<float*>(smem + off_red);
  const uint32_t full = hop::smem_u32(smem + off_bar);
  const uint32_t empty = full + 8 * STAGES;
  const int tid = threadIdx.x;
  // Persistent: cluster k of the grid's n_clusters decodes the groups of CS
  // cells k, k + n_clusters, ...; its block of rank r the cell g * CS + r.
  const int n_clusters = gridDim.x / CS;
  const int rank = (int)hop::cluster_rank();
  const int groups = args.n_cells / CS;
  const int first = blockIdx.x / CS;
  const int n_mine = first < groups ? (groups - first - 1) / n_clusters + 1
                                    : 0;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hop::mbar_init(full + 8 * s, 1);
      hop::mbar_init(empty + 8 * s, (CONSUMERS / 32) * CS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  hop::cluster_sync();  // peers' barriers are initialised

  if (tid >= CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS)
                 : "memory");
    if (tid == CONSUMERS) {  // one thread keeps the ring full
      const unsigned char* src =
          reinterpret_cast<const unsigned char*>(args.tiles);
      const uint32_t ring = hop::smem_u32(smem + off_ring);
      constexpr uint32_t SLICE = TILE_BYTES / CS;
      const int n = n_mine * TILES;  // the same weights for every cell
      for (int i = 0; i < n; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES)
          hop::mbar_wait(empty + 8 * s, ((i / STAGES) - 1) & 1);
        hop::mbar_expect_tx(full + 8 * s, TILE_BYTES);
        hop::bulk_g2s_multicast(
            ring + s * TILE_BYTES + rank * SLICE,
            src + (size_t)(i % TILES) * TILE_BYTES + rank * SLICE, SLICE,
            full + 8 * s, (uint16_t)((1u << CS) - 1));
      }
      // the last releases, some of them remote, land before this block ends
      for (int i = n; i < n + STAGES; ++i)
        if (i >= STAGES)
          hop::mbar_wait(empty + 8 * (i % STAGES), ((i / STAGES) - 1) & 1);
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS)
               : "memory");
  const int warp = tid >> 5, lane = tid & 31;
  Ctx c;
  c.act = smem + off_act;
  c.feat = smem + off_feat;
  c.ring = smem + off_ring;
  c.full = full;
  c.empty = empty;
  c.rc = 2 * (4 * (warp >> 2) + (lane >> 3));
  c.col0 = 32 * (warp & 3) + 4 * (lane & 7);
  c.map = static_cast<const float*>(args.map);
  c.tidx = tidx;
  c.tw = tw;
  int it = 0;
  for (int k = 0; k < n_mine; ++k) {
    const size_t p0 = ((size_t)(first + k * n_clusters) * CS + rank) * M;
    K1_STAMP(0);
    // the previous cell's last reads of the taps are behind a barrier
    if (tid < M) point_taps<float>(args, p0, tid, pts, tidx, tw);
    hop::consumer_sync();
    K1_STAMP(1);
#pragma unroll 1
    for (int s = 0; s < 2; ++s) {
      const float* ps = args.params + s * P_STREAM;
      first_layer(c, ps, pts);
      hop::consumer_sync();
      const int ev = 2 + 9 * s;
      K1_STAMP(ev);
      const Last last = {ps + P_W5, ps + P_B6, args.out_dim, pred, red,
                         args.out + p0 * args.out_dim, s == 1};
      layer<64, 256, STORE>(c, it, ps + P_B2, ev + 1, last);   // 64->256
      layer<256, 512, STORE>(c, it, ps + P_B3, ev + 3, last);  // 256->512
      if (s == 0)                                               // 512->512
        layer<512, 512, STORE>(c, it, ps + P_B4, ev + 5, last);
      else
        layer<512, 512, FEAT>(c, it, ps + P_B4, ev + 5, last);
      // 512 -> 256 -> out
      layer<512, 256, LAST>(c, it, ps + P_B5, ev + 7, last);
    }
  }
}

}  // namespace f32

// A persistent launch in clusters of CS blocks: as many clusters as fit at
// once (the occupancy query, made once per kernel into `clusters`), or one
// per group of CS cells.
int launch_persistent(void (*kernel)(Args), int threads, uint32_t smem,
                      int& clusters, const Args& a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(hop::CS);  // one cluster, for the occupancy query
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = hop::CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (clusters == 0) {
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (clusters <= 0) return (int)cudaErrorInvalidConfiguration;
  }
  const int groups = a.n_cells / hop::CS;
  cfg.gridDim =
      dim3((unsigned)(hop::CS * (groups < clusters ? groups : clusters)));
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

#ifdef K1_TRACE
extern "C" int fused_decode_set_trace(void* buf) {
  long long* p = static_cast<long long*>(buf);
  return (int)cudaMemcpyToSymbol(hop::k1_trace, &p, sizeof(p));
}
#endif

// tiles: tile_weights' layout of w2..w4 of both streams in the compute
// type; params: small_params' f32 biases, w1 and w5 of both streams;
// n_cells a multiple of fused_decode_cluster(). Returns a cudaError_t code
// (0 on success); launches on `stream`.
extern "C" int fused_decode_launch(int is_bf16, const void* map,
                                   const void* tiles, const void* params,
                                   const void* trans,
                                   const void* geom, const void* cells,
                                   int n_cells, int fine_r, int coarse_c,
                                   int img_w, int img_h, int out_dim,
                                   void* out, void* stream) {
  if (n_cells <= 0) return 0;
  if (!tiles || !params || n_cells % hop::CS != 0)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.tiles = tiles;
  a.params = static_cast<const float*>(params);
  a.map = map;
  a.trans = static_cast<const float*>(trans);
  a.geom = static_cast<const float*>(geom);
  a.cells = static_cast<const int*>(cells);
  a.out = static_cast<float*>(out);
  a.n_cells = n_cells;
  a.fine_r = fine_r;
  a.coarse_c = coarse_c;
  a.img_w = img_w;
  a.img_h = img_h;
  a.out_dim = out_dim;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  static int bf16_clusters = 0, f32_clusters = 0;
  if (is_bf16)
    return launch_persistent(hop::decode_kernel, hop::THREADS,
                             hop::smem_total, bf16_clusters, a, st);
  return launch_persistent(f32::decode_kernel, f32::THREADS, f32::smem_total,
                           f32_clusters, a, st);
}

// blocks per cluster of both kernels: a launch's cell count must be a
// multiple of it
extern "C" int fused_decode_cluster() { return hop::CS; }
