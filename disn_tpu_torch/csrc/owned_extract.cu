// K7: the owned-edge extractor of the volume flow, on Hopper (sm_90a).
//
// Replaces disn_tpu/ops/marching.py::_extract_owned (:780; _pack8 at :765
// is its TPU packing of the corner values): XLA code the JAX package wrote
// for the TPU (the corner rows gathered, both passes over every slot as
// masks, cumsums and scatters; ~130 small ops in the port's plain version,
// ops/marching._extract_owned_fixed_plain). Over the first S slots of the
// cell list ids (flat over the R^3 extended cell grid; slot s is live when
// s < min(n, S)):
//   - a live cell's 8 corner values, reads clamped to R - 1; its inside
//     mask (value < iso), and its crossing mask over the 7 owned edge
//     directions (corner 0 to corner pair_j[d]), aliased directions
//     suppressed in ghost cells (a coordinate at R - 1);
//   - verts [S*7, 3] f32: one vertex a crossing edge, in (slot, direction)
//     order: p_i + t (p_j - p_i) with t = (iso - v0) / (vj - v0) clamped
//     to [0, 1] (0.5 where |vj - v0| <= 1e-12 or NaN) and p = lo + g /
//     (R - 1) * span, each operation rounded as PyTorch rounds it op by
//     op (__fadd_rn, __fsub_rn, __fmul_rn, __fdiv_rn: no contraction into
//     an FMA, an IEEE divide);
//   - faces [S*12, 3] int32: the triangles of each real live cell (not a
//     ghost) in (slot, tet, triangle) order, a corner named vstart[owner]
//     + the rank of its direction in the owner's crossing mask, the owner
//     the slot of the neighbour cell that owns the edge;
//   - out [3] int32: nv, ntri, and missing, the triangle corners whose
//     owner is not a live slot (slot 0 stands in for them, as in the plain
//     version). Rows past nv and ntri are zero.
// Bit for bit the plain version: the rounding above, integer sums only
// (one integer atomic a warp for missing: order-free), rows placed by
// prefixes over the slots as the plain version's cumsum places them.
//
// The owner look-up. With the scan's rows blk [b,3] (block id, mask lo,
// mask hi: ops/marching._compact_block_bits, whose cell list ids is; the
// rows route, the one the main path takes), a neighbour cell (x, y, z) is
// in block B = (z>>2, y>>2, x>>2) of the B3 = ceil(R/4) blocks an axis, at
// bit k = ((z&3)*4 + (y&3))*4 + (x&3); its slot is first[r] + popc(mask_r
// below k), r the row of B and first the exclusive prefix of the rows'
// popcounts. It is missing where B is not a row with a mask, its bit is not
// set, or that slot is at or past min(n, S): the cases where a dense
// [R^3] table of the live slots holds -1. row(B) comes from a [B3^3] table
// (1.1 MB at 257^3) that is never reset: an entry counts only where the
// row it names is a row of this call with that block and a mask, which no
// stale entry can fake. The rows must be those of the scan that produced
// ids, and ids a prefix of their cells in the scan's order: no check sees
// another pairing, which gives wrong slots. Without rows (the dense route:
// hand-built lists) the [R^3] owner table is set to -1 by a memset and
// filled by owned_count, as in the earlier design.
//
// What bounds it on the H100 (3.35 TB/s): bytes. It must read the ids, the
// rows and the corner values (8 floats a live cell) and write the padded
// outputs (S*21*4 + S*36*4 bytes: 18.7 MB at S = 81,920): 0.006 ms. The
// design: three launch calls on the rows route (four on the dense route,
// its memset first), no copy.
//   owned_count: a CTA a run of RUN slots (a thread a slot: the masks, the
//     counts, its run's exclusive offsets, packed in one int; the run's
//     sums), then CTAs of RUN rows (each row's popcount, its table entry,
//     its run's exclusive offset; the run's sum);
//   owned_prefix: one CTA of 1,024 threads, one scan of three channels:
//     the slot runs' first vertex and face rows, the row runs' first
//     slots, the totals, missing reset;
//   owned_write: a CTA of 256 threads a run of RUN slots. A thread a slot
//     reads its cell again (the corners are in L2 after owned_count) and
//     leaves in shared memory its t's, its world
//     coordinates, and for each of its vertex and face rows the slot and
//     the direction, or the (tet, case, triangle). Then every thread takes
//     rows, not slots, and each warp stages 32 rows in shared memory and
//     stores them as 96 consecutive words, neighbouring lanes on
//     neighbouring words. An owner in the same run is read from shared
//     memory, another from the packed slots and the runs' bases. The rows
//     past the counts are zeroed last, by the whole grid in stride.
// The case tables are ops/marching's, passed by the wrapper in the
// kernels' parameters (Args, __grid_constant__: read in place, never
// copied to local memory) and copied to shared memory word by word.
// (Copied byte by byte from a parameter that was not __grid_constant__,
// as in the earlier design, the copy was the largest single part of
// owned_write.)
// Shared memory a CTA (ptxas): owned_write 17,248 bytes; owned_count
// 800; owned_prefix 384. All static, under the 48 KB default: no
// function attribute.
// Measured against (H100 80GB HBM3, 700 W, in turns on a volume-flow
// hit's inputs at 257^3, 81,920 slots): row(B) by a binary search over
// the rows' block ids instead of the [B3^3] table, 40.6-41.7 us of
// kernels against 26.0 (~14 dependent steps a corner); the 7 edge t's
// kept from owned_count (28 B a slot of scratch) instead of a second read
// of the corners, 27.8-28.6 us.
// The earlier design: a dense [R^3] owner table set by a 68 MB memset,
// each write thread storing its own slot's rows (up to 32 scattered runs a
// warp store) and reading its corners again from a volume that L2 no
// longer held after the memset: 71.39 us of kernels at 81,920 slots on an
// H100 80GB HBM3 at 700 W (the memset ~22, write 39.02, count 7.59,
// prefix 2.48), wrapper 0.1249 ms, four launch calls. Before it, the
// prefix in one CTA (a thread a run of 80 slots: 220 us) and each slot
// zeroing its own padding rows (write 100 us).
// Nothing is cached per process or per device: no function attribute, no
// cluster fit, no table upload.

#include <cstring>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int RUN = 128;              // slots (or rows) a run, a count CTA
constexpr int THREADS = 256;          // owned_write's CTA: two threads a slot
constexpr int PREFIX_THREADS = 1024;  // owned_prefix's one CTA
constexpr int D = 7;                  // owned directions a cell
constexpr int MAX_TRI = 12;           // triangles a cell
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

// ops/marching's tables (owned_extract.tables() gives them in this layout)
struct alignas(4) Tables {
  uint8_t corners[8][3];         // (x, y, z) offsets
  uint8_t tets[6][4];            // Kuhn tets' corners
  uint8_t counts[6][16];         // triangles of a tet case
  uint8_t nbdir[6][16][2][3];    // owner corner | direction << 3
  uint8_t pair_j[D];             // an owned edge's far corner
  uint8_t alias[D];              // the axes (x 1, y 2, z 4) it extends on
};
constexpr size_t TABLE_BYTES = offsetof(Tables, alias) + D;

struct Args {
  const float* vol;
  int R;
  const float* sp;  // sdf_params [6]: lo (x, y, z), hi
  const int* ids;
  int S;
  const int* n_ptr;  // live slots: *n_ptr when not null, else n_host
  int n_host;
  float iso;
  const int* blk;  // [b, 3] rows, or null: the dense route
  int b;
  int B3;
  int* owner;  // dense: [R^3] slot or -1; rows: [B3^3] row table
  int4* rows;  // [b]: block id, mask lo, mask hi, first slot in its run
  int* pk;     // [S]: cross | run offset of its vertices << 7 | inside << 18
  int* sums;   // [2*gs + gr]: the slot runs' vertex, face sums; row runs'
  int* base;   // [2*gs + gr]: the slot runs' first vertex and face rows,
               // the row runs' first slots
  int gs, gr;  // slot runs, row runs
  float* verts;
  int* faces;
  int* out;  // nv, ntri, missing
  Tables tb;
};

// a's tables into shared memory, a word a thread (a: __grid_constant__)
__device__ __forceinline__ void load_tables(const Args& a, Tables& tb) {
  const uint32_t* src = reinterpret_cast<const uint32_t*>(&a.tb);
  uint32_t* dst = reinterpret_cast<uint32_t*>(&tb);
  for (int i = threadIdx.x; i < (int)(sizeof(Tables) / 4); i += blockDim.x)
    dst[i] = src[i];
}

__device__ __forceinline__ int live_slots(const Args& a) {
  return min(a.n_ptr ? *a.n_ptr : a.n_host, a.S);
}

struct Cell {
  int id, x, y, z;
  float v[8];
  unsigned inside, cross;
  bool real;
};

__device__ __forceinline__ Cell cell_of(const Args& a, const Tables& tb,
                                        int s) {
  Cell c;
  const int R = a.R;
  c.id = a.ids[s];
  c.x = c.id % R;
  c.y = (c.id / R) % R;
  c.z = c.id / (R * R);
  c.inside = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int gx = min(c.x + tb.corners[k][0], R - 1);
    const int gy = min(c.y + tb.corners[k][1], R - 1);
    const int gz = min(c.z + tb.corners[k][2], R - 1);
    c.v[k] = __ldg(a.vol + ((size_t)gz * R + gy) * R + gx);
    c.inside |= (unsigned)(c.v[k] < a.iso) << k;
  }
  const unsigned ghost = (unsigned)(c.x == R - 1) |
                         (unsigned)(c.y == R - 1) << 1 |
                         (unsigned)(c.z == R - 1) << 2;
  c.cross = 0;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const bool crosses =
        ((c.inside & 1u) != ((c.inside >> tb.pair_j[d]) & 1u)) &&
        !(ghost & tb.alias[d]);
    c.cross |= (unsigned)crosses << d;
  }
  c.real = (c.x <= R - 2) & (c.y <= R - 2) & (c.z <= R - 2);
  return c;
}

__device__ __forceinline__ int tet_case(unsigned inside, const Tables& tb,
                                        int t) {
  int k = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) k |= (int)((inside >> tb.tets[t][i]) & 1u) << i;
  return k;
}

__device__ __forceinline__ int triangles(unsigned inside, const Tables& tb) {
  int n = 0;
  for (int t = 0; t < 6; ++t) n += tb.counts[t][tet_case(inside, tb, t)];
  return n;
}

// (iso - v0) / (vj - v0) clamped to [0, 1]; 0.5 where |vj - v0| <= 1e-12
// or is NaN; NaN stays NaN through the clamp, as torch.clamp keeps it
__device__ __forceinline__ float edge_t(float v0, float vj, float iso) {
  const float dv = __fsub_rn(vj, v0);
  const float t = fabsf(dv) > (float)1e-12 ? __fdiv_rn(__fsub_rn(iso, v0), dv)
                                           : 0.5f;
  return isnan(t) ? t : fminf(fmaxf(t, 0.0f), 1.0f);
}

// v[j] for a j known only at run time, kept in registers (an index into
// v would put the array in local memory)
__device__ __forceinline__ float pick(const float (&v)[8], int j) {
  float r = v[0];
#pragma unroll
  for (int k = 1; k < 8; ++k) r = k == j ? v[k] : r;
  return r;
}

__device__ __forceinline__ float world(const float* lo, const float* span,
                                       float denom, int g, int axis) {
  return __fadd_rn(lo[axis],
                   __fmul_rn(__fdiv_rn((float)g, denom), span[axis]));
}

// The exclusive prefix of v's three channels over a CTA of N threads, and
// the CTA's totals in *total.
template <int N>
__device__ __forceinline__ int3 cta_scan(int3 v, int3* total) {
  __shared__ int3 ws[N / 32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int3 in = v;  // inclusive in the warp, then over the warps
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int x = __shfl_up_sync(FULL, in.x, d);
    const int y = __shfl_up_sync(FULL, in.y, d);
    const int z = __shfl_up_sync(FULL, in.z, d);
    if (lane >= d) {
      in.x += x;
      in.y += y;
      in.z += z;
    }
  }
  __syncthreads();  // ws free again after an earlier call
  if (lane == 31) ws[warp] = in;
  __syncthreads();
  int3 b = make_int3(0, 0, 0), t = make_int3(0, 0, 0);
#pragma unroll
  for (int w = 0; w < N / 32; ++w) {
    const int3 s = ws[w];
    if (w < warp) {
      b.x += s.x;
      b.y += s.y;
      b.z += s.z;
    }
    t.x += s.x;
    t.y += s.y;
    t.z += s.z;
  }
  *total = t;
  return make_int3(b.x + in.x - v.x, b.y + in.y - v.y, b.z + in.z - v.z);
}

__global__ void __launch_bounds__(RUN)
    owned_count(const __grid_constant__ Args a) {
  if ((int)blockIdx.x >= a.gs) {  // a run of rows
    const int g = blockIdx.x - a.gs;
    const int r = g * RUN + threadIdx.x;
    int bid = 0;
    unsigned lo = 0, hi = 0;
    if (r < a.b) {
      bid = a.blk[3 * r];
      lo = (unsigned)a.blk[3 * r + 1];
      hi = (unsigned)a.blk[3 * r + 2];
    }
    const int pop = __popc(lo) + __popc(hi);
    if (pop && (unsigned)bid < (unsigned)(a.B3 * a.B3 * a.B3))
      a.owner[bid] = r;
    int3 tot;
    const int3 ex = cta_scan<RUN>(make_int3(pop, 0, 0), &tot);
    if (r < a.b) a.rows[r] = make_int4(bid, (int)lo, (int)hi, ex.x);
    if (threadIdx.x == 0) a.sums[2 * a.gs + g] = tot.x;
    return;
  }
  __shared__ Tables tb;
  load_tables(a, tb);
  __syncthreads();
  const int s = blockIdx.x * RUN + threadIdx.x;
  int nv = 0, ntri = 0;
  unsigned cross = 0, inside = 0;
  if (s < live_slots(a)) {
    const Cell c = cell_of(a, tb, s);
    cross = c.cross;
    inside = c.inside;
    nv = __popc(cross);
    if (c.real) ntri = triangles(inside, tb);
    if (!a.blk) a.owner[c.id] = s;
  }
  int3 tot;
  const int3 ex = cta_scan<RUN>(make_int3(nv, ntri, 0), &tot);
  if (s < a.S) a.pk[s] = (int)(cross | (unsigned)ex.x << 7 | inside << 18);
  if (threadIdx.x == 0) {
    a.sums[blockIdx.x] = tot.x;
    a.sums[a.gs + blockIdx.x] = tot.y;
  }
}

// One CTA, one scan of three channels: the slot runs' first vertex and
// face rows, the row runs' first slots; the totals, missing reset.
__global__ void __launch_bounds__(PREFIX_THREADS)
    owned_prefix(const __grid_constant__ Args a) {
  int3 c = make_int3(0, 0, 0);
  const int n = max(a.gs, a.gr);
  for (int k0 = 0; k0 < n; k0 += PREFIX_THREADS) {
    const int k = k0 + threadIdx.x;
    const bool ks = k < a.gs, kr = k < a.gr;
    int3 tot;
    const int3 ex = cta_scan<PREFIX_THREADS>(
        make_int3(ks ? a.sums[k] : 0, ks ? a.sums[a.gs + k] : 0,
                  kr ? a.sums[2 * a.gs + k] : 0),
        &tot);
    if (ks) {
      a.base[k] = c.x + ex.x;
      a.base[a.gs + k] = c.y + ex.y;
    }
    if (kr) a.base[2 * a.gs + k] = c.z + ex.z;
    c.x += tot.x;
    c.y += tot.y;
    c.z += tot.z;
  }
  if (threadIdx.x == 0) {
    a.out[0] = c.x;
    a.out[1] = c.y;
    a.out[2] = 0;
  }
}

// The slot of the cell (x, y, z) through the scan's rows, or -1 where it
// is not a live slot.
__device__ __forceinline__ int row_slot(const Args& a, int live, int x, int y,
                                        int z) {
  const int B = ((z >> 2) * a.B3 + (y >> 2)) * a.B3 + (x >> 2);
  const int bit = ((z & 3) * 4 + (y & 3)) * 4 + (x & 3);
  const int r = a.owner[B];
  if ((unsigned)r >= (unsigned)a.b) return -1;
  const int4 w = a.rows[r];
  if (w.x != B || (w.y | w.z) == 0) return -1;
  const unsigned long long m =
      (unsigned long long)(unsigned)w.z << 32 | (unsigned)w.y;
  if (!((m >> bit) & 1ull)) return -1;
  const int o = a.base[2 * a.gs + r / RUN] + w.w +
                __popcll(m & ((1ull << bit) - 1ull));
  return o < live ? o : -1;
}

struct WriteShared {
  Tables tb;
  float t[D][RUN];               // a slot's edge t's
  float p0[3][RUN], p1[3][RUN];  // the world coordinates of g, g + 1
  int x[RUN], y[RUN], z[RUN];
  uint8_t cross[RUN];
  uint16_t lv[RUN];                        // the slot's first vertex row
  uint8_t vslot[RUN * D], vdir[RUN * D];   // a vertex row's slot, direction
  uint8_t fslot[RUN * MAX_TRI];            // a face row's slot,
  uint8_t ftri[RUN * MAX_TRI];             // tet << 5 | case << 1 | triangle
  int stage[WARPS][96];  // a warp's 32 rows of 3 words
};

// The vertex row of the edge in direction dir owned by the cell (x, y, z),
// counting a missing owner in miss (slot 0 stands in).
__device__ __forceinline__ int owner_vertex(const Args& a,
                                            const WriteShared& sh, int live,
                                            int vbase, int x, int y, int z,
                                            int dir, int& miss) {
  int o = a.blk ? row_slot(a, live, x, y, z)
                : a.owner[((size_t)z * a.R + y) * a.R + x];
  if (o < 0) {
    ++miss;
    o = 0;
  }
  unsigned cm;
  int v0;
  if (o / RUN == (int)blockIdx.x) {  // in this run: shared memory
    cm = sh.cross[o % RUN];
    v0 = vbase + sh.lv[o % RUN];
  } else {
    const unsigned p = (unsigned)a.pk[o];
    cm = p & 0x7fu;
    v0 = a.base[o / RUN] + (int)((p >> 7) & 0x7ffu);
  }
  return v0 + __popc(cm & ((1u << dir) - 1u));
}

__global__ void __launch_bounds__(THREADS)
    owned_write(const __grid_constant__ Args a) {
  __shared__ WriteShared sh;
  load_tables(a, sh.tb);
  __syncthreads();
  const Tables& tb = sh.tb;
  const int R = a.R;
  float lo[3], span[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    lo[k] = a.sp[k];
    span[k] = __fsub_rn(a.sp[3 + k], a.sp[k]);
  }
  const float denom = (float)(R - 1);
  const int j = threadIdx.x;  // slot j of the run for j < RUN
  const int s = blockIdx.x * RUN + j;
  const int live = live_slots(a);
  int nv = 0, ntri = 0;
  unsigned cross = 0, inside = 0;
  bool real = false;
  if (j < RUN && s < live) {
    const Cell c = cell_of(a, tb, s);
    cross = c.cross;
    inside = c.inside;
    real = c.real;
    const int g[3] = {c.x, c.y, c.z};
#pragma unroll
    for (int d = 0; d < D; ++d)
      sh.t[d][j] = edge_t(c.v[0], pick(c.v, tb.pair_j[d]), a.iso);
    sh.x[j] = g[0];
    sh.y[j] = g[1];
    sh.z[j] = g[2];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      sh.p0[k][j] = world(lo, span, denom, g[k], k);
      sh.p1[k][j] = world(lo, span, denom, min(g[k] + 1, R - 1), k);
    }
    nv = __popc(cross);
    if (real) ntri = triangles(inside, tb);
  }
  int3 tot;
  const int3 ex = cta_scan<THREADS>(make_int3(nv, ntri, 0), &tot);
  if (j < RUN) {
    sh.cross[j] = (uint8_t)cross;
    sh.lv[j] = (uint16_t)ex.x;
    int r = ex.x;
    for (int d = 0; d < D; ++d)
      if ((cross >> d) & 1u) {
        sh.vslot[r] = (uint8_t)j;
        sh.vdir[r++] = (uint8_t)d;
      }
    r = ex.y;
    if (real)
      for (int t = 0; t < 6; ++t) {
        const int k = tet_case(inside, tb, t);
        for (int q = 0; q < tb.counts[t][k]; ++q) {
          sh.fslot[r] = (uint8_t)j;
          sh.ftri[r++] = (uint8_t)(t << 5 | k << 1 | q);
        }
      }
  }
  __syncthreads();

  const int vbase = a.base[blockIdx.x], fbase = a.base[a.gs + blockIdx.x];
  const int lane = j % 32, warp = j / 32;
  int* st = sh.stage[warp];
  // the run's vertex rows, a warp 32 consecutive ones at a time
  for (int i0 = warp * 32; i0 < tot.x; i0 += THREADS) {
    const int rows = min(32, tot.x - i0);
    if (lane < rows) {
      const int sl = sh.vslot[i0 + lane], d = sh.vdir[i0 + lane];
      const float t = sh.t[d][sl];
      const int jc = tb.pair_j[d];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float pi = sh.p0[k][sl];
        const float pj = tb.corners[jc][k] ? sh.p1[k][sl] : pi;
        st[3 * lane + k] =
            __float_as_int(__fadd_rn(pi, __fmul_rn(t, __fsub_rn(pj, pi))));
      }
    }
    __syncwarp();
    float* dst = a.verts + 3 * ((size_t)vbase + i0);
    for (int w = lane; w < 3 * rows; w += 32) dst[w] = __int_as_float(st[w]);
    __syncwarp();
  }
  // the run's face rows, likewise
  int miss = 0;
  for (int i0 = warp * 32; i0 < tot.y; i0 += THREADS) {
    const int rows = min(32, tot.y - i0);
    if (lane < rows) {
      const int sl = sh.fslot[i0 + lane], code = sh.ftri[i0 + lane];
      const int t = code >> 5, k = (code >> 1) & 15, q = code & 1;
      const int cx = sh.x[sl], cy = sh.y[sl], cz = sh.z[sl];
#pragma unroll
      for (int v = 0; v < 3; ++v) {
        const int nd = tb.nbdir[t][k][q][v];
        const int nb = nd & 7, dir = nd >> 3;
        st[3 * lane + v] = owner_vertex(
            a, sh, live, vbase, cx + tb.corners[nb][0],
            cy + tb.corners[nb][1], cz + tb.corners[nb][2], dir, miss);
      }
    }
    __syncwarp();
    int* dst = a.faces + 3 * ((size_t)fbase + i0);
    for (int w = lane; w < 3 * rows; w += 32) dst[w] = st[w];
    __syncwarp();
  }
  miss = __reduce_add_sync(FULL, miss);
  if (lane == 0 && miss) atomicAdd(a.out + 2, miss);
  // the rows past the counts, zeroed by the whole grid in stride
  const size_t gtid = (size_t)blockIdx.x * THREADS + threadIdx.x;
  const size_t stride = (size_t)gridDim.x * THREADS;
  for (size_t i = 3 * (size_t)a.out[0] + gtid; i < 3 * (size_t)D * a.S;
       i += stride)
    a.verts[i] = 0.0f;
  for (size_t i = 3 * (size_t)a.out[1] + gtid;
       i < 3 * (size_t)MAX_TRI * a.S; i += stride)
    a.faces[i] = 0;
}

size_t runs(long long n) { return (size_t)((n + RUN - 1) / RUN); }

}  // namespace

// Sizes the wrapper checks its table bytes against, and the scratch words
// a call takes (b rows, or dense != 0 for the dense route): the rows
// (first: 16-byte aligned), the row table ([B3^3]) or the dense owner
// table ([R^3]), the packed slots, the runs' sums and bases.
extern "C" int owned_tables_bytes() { return (int)TABLE_BYTES; }
extern "C" long long owned_scratch_words(int R, int S, int b, int dense) {
  const long long gs = (long long)runs(S), gr = dense ? 0 : (long long)runs(b);
  const long long B3 = (R + 3) / 4;
  const long long table = dense ? (long long)R * R * R : B3 * B3 * B3;
  return (dense ? 0 : 4LL * b) + table + S + 2 * (2 * gs + gr);
}

// The extraction of the first S slots of ids over the [R,R,R] volume ->
// verts [S*7, 3], faces [S*12, 3], out [3] = (nv, ntri, missing), all on
// the card, with scratch of owned_scratch_words(R, S, b, blk == null)
// int32. Live slots: min(*n_ptr, S) when n_ptr is not null, else
// min(n_host, S). blk: the scan's rows [b, 3] int32 of the list ids
// (the rows route), or null (the dense route): the rows of the scan that
// produced ids, ids a prefix of their cells. tables: owned_tables_bytes()
// bytes, ops/marching's case tables (owned_extract.tables()), passed in
// the kernels' parameters. Three launch calls on `stream` with
// blk, four without (one memset when S = 0), nothing read back. Returns a
// CUDA error.
extern "C" int owned_extract(const float* vol, int R, const float* sp,
                             const int* ids, int S, const int* n_ptr,
                             int n_host, float iso, const int* blk, int b,
                             int* scratch, float* verts, int* faces,
                             int* out, const void* tables,
                             cudaStream_t stream) {
  if (S == 0) return (int)cudaMemsetAsync(out, 0, 3 * sizeof(int), stream);
  const bool dense = blk == nullptr;
  Args a{};
  std::memcpy(&a.tb, tables, TABLE_BYTES);
  a.vol = vol;
  a.R = R;
  a.sp = sp;
  a.ids = ids;
  a.S = S;
  a.n_ptr = n_ptr;
  a.n_host = n_host;
  a.iso = iso;
  a.blk = blk;
  a.b = dense ? 0 : b;
  a.B3 = (R + 3) / 4;
  a.gs = (int)runs(S);
  a.gr = (int)runs(a.b);
  int* p = scratch;
  a.rows = reinterpret_cast<int4*>(p);
  p += 4 * (size_t)a.b;
  a.owner = p;
  p += dense ? (size_t)R * R * R : (size_t)a.B3 * a.B3 * a.B3;
  a.pk = p;
  p += S;
  a.sums = p;
  p += 2 * (size_t)a.gs + a.gr;
  a.base = p;
  a.verts = verts;
  a.faces = faces;
  a.out = out;
  cudaError_t e;
  if (dense) {
    e = cudaMemsetAsync(a.owner, 0xff, (size_t)R * R * R * sizeof(int),
                        stream);
    if (e != cudaSuccess) return (int)e;
  }
  owned_count<<<a.gs + a.gr, RUN, 0, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  owned_prefix<<<1, PREFIX_THREADS, 0, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  owned_write<<<a.gs, THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}
