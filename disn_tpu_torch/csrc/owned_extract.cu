// K7: the owned-edge extractor of the volume flow, on Hopper (sm_90a).
//
// Replaces disn_tpu/ops/marching.py::_extract_owned (:780; _pack8 at :765
// is its TPU packing of the corner values): XLA code the JAX package wrote
// for the TPU (the corner rows gathered, both passes over every slot as
// masks, cumsums and scatters; ~130 small ops in the port's plain version,
// ops/marching._extract_owned_fixed_plain). Over the first S slots of the
// cell list ids (flat over the R^3 extended cell grid; slot s is live when
// s < n):
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
// (one integer atomic for missing: order-free), rows placed by a prefix
// over the slots as the plain version's cumsum places them.
//
// What bounds it on the H100 (3.35 TB/s): bytes. It must read the ids and
// the corner values (8 floats a live cell) and write the padded outputs
// (S*21*4 + S*36*4 bytes: 18.7 MB at S = 81,920): 0.006 ms. What the
// design does about it: four launch calls, no copy. A memset of the owner
// table ([R^3] int32 to -1: 68 MB at 257^3, the largest term), owned_count
// (a thread a slot: the masks, the slot's vertex and triangle counts
// packed in one int, its entry in the owner table, and each CTA's sums),
// owned_prefix (a CTA the same run of 256 slots: the sum of the runs
// before it, then a CTA scan of its slots; the last CTA writes the totals
// and resets missing) and owned_write (a thread a slot: its vertices and
// faces at their rows; the rows past the counts zeroed by the whole grid
// in stride, so that the stores coalesce). The case tables come from the
// wrapper by value and sit in shared memory. A first design took the
// prefix in one CTA (a thread a run of 80 slots: 220 us at 81,920 slots
// on an H100) and zeroed each slot's own padding rows (owned_write 100
// us there; 39 us strided).
// Nothing is cached per process or per device: no function attribute, no
// cluster fit, no table upload.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // slots a CTA, in every kernel
constexpr int D = 7;  // owned directions a cell
constexpr unsigned FULL = 0xffffffffu;

// ops/marching's tables, filled by the wrapper (owned_extract._tables)
struct Tables {
  uint8_t corners[8][3];         // (x, y, z) offsets
  uint8_t tets[6][4];            // Kuhn tets' corners
  uint8_t counts[6][16];         // triangles of a tet case
  uint8_t nbdir[6][16][2][3];    // owner corner | direction << 3
  uint8_t pair_j[D];             // an owned edge's far corner
  uint8_t alias[D];              // the axes (x 1, y 2, z 4) it extends on
};

struct Args {
  const float* vol;
  int R;
  const float* sp;  // sdf_params [6]: lo (x, y, z), hi
  const int* ids;
  int S;
  const int* n_ptr;  // live slots: *n_ptr when not null, else n_host
  int n_host;
  float iso;
  int* owner;   // [R^3]
  int* packed;  // [S]: inside | cross << 8 | nv << 16 | ntri << 20
  int* vstart;  // [S]
  int* fstart;  // [S]
  int* bsum;    // [2 * CTAs]: each CTA's vertex and triangle counts
  float* verts;
  int* faces;
  int* out;  // nv, ntri, missing
  Tables tb;
};

__device__ __forceinline__ void load_tables(const Args& a, Tables& tb) {
  const uint8_t* src = reinterpret_cast<const uint8_t*>(&a.tb);
  uint8_t* dst = reinterpret_cast<uint8_t*>(&tb);
  for (int i = threadIdx.x; i < (int)sizeof(Tables); i += blockDim.x)
    dst[i] = src[i];
}

__device__ __forceinline__ int live_slots(const Args& a) {
  return a.n_ptr ? *a.n_ptr : a.n_host;
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

// (iso - v0) / (vj - v0) clamped to [0, 1]; 0.5 where |vj - v0| <= 1e-12
// or is NaN; NaN stays NaN through the clamp, as torch.clamp keeps it
__device__ __forceinline__ float edge_t(float v0, float vj, float iso) {
  const float dv = __fsub_rn(vj, v0);
  const float t = fabsf(dv) > (float)1e-12 ? __fdiv_rn(__fsub_rn(iso, v0), dv)
                                           : 0.5f;
  return isnan(t) ? t : fminf(fmaxf(t, 0.0f), 1.0f);
}

// The CTA's sums of (x, y) over its threads, in every thread.
__device__ __forceinline__ int2 cta_sum(int x, int y) {
  __shared__ int wx[THREADS / 32], wy[THREADS / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    x += __shfl_xor_sync(FULL, x, off);
    y += __shfl_xor_sync(FULL, y, off);
  }
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  __syncthreads();  // wx, wy free again after an earlier call
  if (lane == 0) {
    wx[warp] = x;
    wy[warp] = y;
  }
  __syncthreads();
  int sx = 0, sy = 0;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) {
    sx += wx[w];
    sy += wy[w];
  }
  return make_int2(sx, sy);
}

__global__ void owned_count(const Args a) {
  __shared__ Tables tb;
  load_tables(a, tb);
  __syncthreads();
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  int p = 0;
  if (s < a.S && s < live_slots(a)) {
    const Cell c = cell_of(a, tb, s);
    int ntri = 0;
    if (c.real)
      for (int t = 0; t < 6; ++t) ntri += tb.counts[t][tet_case(c.inside, tb, t)];
    p = (int)(c.inside | c.cross << 8 | (unsigned)__popc(c.cross) << 16 |
              (unsigned)ntri << 20);
    a.owner[c.id] = s;
  }
  if (s < a.S) a.packed[s] = p;
  const int2 sum = cta_sum((p >> 16) & 15, (p >> 20) & 15);
  if (threadIdx.x == 0) {
    a.bsum[2 * blockIdx.x] = sum.x;
    a.bsum[2 * blockIdx.x + 1] = sum.y;
  }
}

// A CTA a run of THREADS slots, as in owned_count: its offset, the sum of
// the runs before it (bsum), then a CTA scan of its slots' counts; the
// last CTA writes the totals and resets missing.
__global__ void owned_prefix(const Args a) {
  __shared__ int wv[THREADS / 32], wf[THREADS / 32];
  int ov = 0, of = 0;
  for (int k = threadIdx.x; k < (int)blockIdx.x; k += THREADS) {
    ov += a.bsum[2 * k];
    of += a.bsum[2 * k + 1];
  }
  const int2 off = cta_sum(ov, of);
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  const int p = s < a.S ? a.packed[s] : 0;
  const int cv = (p >> 16) & 15, cf = (p >> 20) & 15;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int iv = cv, jf = cf;  // inclusive in the warp, then over the warps
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(FULL, iv, d);
    const int w = __shfl_up_sync(FULL, jf, d);
    if (lane >= d) {
      iv += u;
      jf += w;
    }
  }
  if (lane == 31) {
    wv[warp] = iv;
    wf[warp] = jf;
  }
  __syncthreads();
  int bv = 0, bf = 0, tv = 0, tf = 0;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) {
    bv += w < warp ? wv[w] : 0;
    bf += w < warp ? wf[w] : 0;
    tv += wv[w];
    tf += wf[w];
  }
  if (s < a.S) {
    a.vstart[s] = off.x + bv + iv - cv;
    a.fstart[s] = off.y + bf + jf - cf;
  }
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x == 0) {
    a.out[0] = off.x + tv;
    a.out[1] = off.y + tf;
    a.out[2] = 0;
  }
}

__device__ __forceinline__ float world(const float* lo, const float* span,
                                       float denom, int g, int axis) {
  return __fadd_rn(lo[axis],
                   __fmul_rn(__fdiv_rn((float)g, denom), span[axis]));
}

__global__ void owned_write(const Args a) {
  __shared__ Tables tb;
  load_tables(a, tb);
  __syncthreads();
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  // the rows past the counts, zeroed by the whole grid in stride
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t i = 3 * (size_t)a.out[0] + s; i < 3 * (size_t)D * a.S;
       i += stride)
    a.verts[i] = 0.0f;
  for (size_t i = 3 * (size_t)a.out[1] + s; i < 36 * (size_t)a.S; i += stride)
    a.faces[i] = 0;
  if (s >= a.S || s >= live_slots(a)) return;
  const Cell c = cell_of(a, tb, s);
  const int R = a.R;
  float lo[3], span[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    lo[k] = a.sp[k];
    span[k] = __fsub_rn(a.sp[3 + k], a.sp[k]);
  }
  const float denom = (float)(R - 1);
  const int gi[3] = {c.x, c.y, c.z};
  int row = a.vstart[s];
  for (int d = 0; d < D; ++d) {
    if (!((c.cross >> d) & 1u)) continue;
    const int j = tb.pair_j[d];
    const float t = edge_t(c.v[0], c.v[j], a.iso);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float pi = world(lo, span, denom, gi[k], k);
      const float pj =
          world(lo, span, denom, min(gi[k] + tb.corners[j][k], R - 1), k);
      a.verts[3 * (size_t)row + k] = __fadd_rn(pi, __fmul_rn(t, __fsub_rn(pj, pi)));
    }
    ++row;
  }
  if (!c.real) return;  // ghost cells emit no triangle
  int frow = a.fstart[s], miss = 0;
  for (int t = 0; t < 6; ++t) {
    const int k = tet_case(c.inside, tb, t);
    for (int q = 0; q < tb.counts[t][k]; ++q) {
#pragma unroll
      for (int v = 0; v < 3; ++v) {
        const int nd = tb.nbdir[t][k][q][v];
        const int nb = nd & 7, dir = nd >> 3;
        const int nid = ((c.z + tb.corners[nb][2]) * R + c.y +
                         tb.corners[nb][1]) * R + c.x + tb.corners[nb][0];
        int o = a.owner[nid];
        if (o < 0) {
          ++miss;
          o = 0;
        }
        const unsigned cm = ((unsigned)a.packed[o] >> 8) & 0x7fu;
        a.faces[3 * (size_t)frow + v] =
            a.vstart[o] + __popc(cm & ((1u << dir) - 1u));
      }
      ++frow;
    }
  }
  if (miss) atomicAdd(a.out + 2, miss);
}

}  // namespace

// Sizes the wrapper checks its table bytes against, and the scratch words
// a call takes: the owner table, then the packed slots, vstart, fstart
// and the CTAs' sums.
extern "C" int owned_tables_bytes() { return (int)sizeof(Tables); }
extern "C" long long owned_scratch_words(int R, int S) {
  return (long long)R * R * R + 3LL * S + 2LL * ((S + THREADS - 1) / THREADS);
}

// The extraction of the first S slots of ids over the [R,R,R] volume ->
// verts [S*7, 3], faces [S*12, 3], out [3] = (nv, ntri, missing), all on
// the card, with scratch of owned_scratch_words(R, S) int32. Live slots:
// *n_ptr when n_ptr is not null, else n_host. tables: sizeof(Tables)
// bytes (owned_tables_bytes). Four launch calls on `stream` (one memset
// when S = 0), nothing read back. Returns a CUDA error.
extern "C" int owned_extract(const float* vol, int R, const float* sp,
                             const int* ids, int S, const int* n_ptr,
                             int n_host, float iso, int* scratch,
                             float* verts, int* faces, int* out,
                             const void* tables, cudaStream_t stream) {
  if (S == 0) return (int)cudaMemsetAsync(out, 0, 3 * sizeof(int), stream);
  Args a;
  a.vol = vol;
  a.R = R;
  a.sp = sp;
  a.ids = ids;
  a.S = S;
  a.n_ptr = n_ptr;
  a.n_host = n_host;
  a.iso = iso;
  const size_t cells = (size_t)R * R * R;
  a.owner = scratch;
  a.packed = scratch + cells;
  a.vstart = a.packed + S;
  a.fstart = a.vstart + S;
  a.bsum = a.fstart + S;
  a.verts = verts;
  a.faces = faces;
  a.out = out;
  const uint8_t* t = static_cast<const uint8_t*>(tables);
  uint8_t* dst = reinterpret_cast<uint8_t*>(&a.tb);
  for (size_t i = 0; i < sizeof(Tables); ++i) dst[i] = t[i];
  cudaError_t e = cudaMemsetAsync(a.owner, 0xff, cells * sizeof(int), stream);
  if (e != cudaSuccess) return (int)e;
  const int grid = (S + THREADS - 1) / THREADS;
  owned_count<<<grid, THREADS, 0, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  owned_prefix<<<grid, THREADS, 0, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  owned_write<<<grid, THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}
