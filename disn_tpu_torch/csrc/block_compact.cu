// K2c: the block compaction both mesh flows end their scan in, on Hopper
// (sm_90a).
//
// Replaces disn_tpu/ops/marching.py::_compact_block_bits (:694), XLA code
// the JAX package wrote for the TPU (a cumsum over the blocks, a scatter of
// their ids, a gather of their bits, 64 shifts a row, a second cumsum over
// every slot and a scatter of the cell ids; ~30 small ops in the port's
// plain version, ops/marching._compact_block_bits_plain). Over the grid of
// 4^3-cell blocks, B3^3 of them, each with 64 change bits (lo, hi):
//   - sel = cand & (bits != 0), the blocks kept in block order (at most
//     cap_b of them: the capped form's b2, or all of them);
//   - blk [cap_b, 3] rows (block id, lo, hi) of the kept blocks;
//   - ids: each kept block's set bits in bit order, at the offset of the
//     popcounts of the selected blocks before it: flat cell ids
//     ((bz*4 + l/16)*E + by*4 + (l/4)%4)*E + bx*4 + l%4 over E^3, or, with
//     srow (the sparse-words flow), srow[coarse cell]*64 + l;
//   - the capped form also pads (zero ids past n, zero rows past the kept
//     blocks) and writes n (the kept blocks' bits) and g_over (the
//     selected blocks past cap_b plus the caller's guard) on the card.
// Bit for bit the plain version: integers only, in the plain version's
// order (nonzero's row-major order of blocks, then of bits).
//
// What bounds it on the H100 (3.35 TB/s): bytes, and in practice launch
// latency. It must read bits and cand (9 B a block: 2.5 MB at 257^3,
// 0.74 us) and srow, and write the ids and the rows; the capped form's
// padded buffers are written whole. What the design does about it: one
// launch of one thread-block cluster (16 CTAs of 1,024 threads; 8, the
// portable size, measured 1.5x slower), no global scratch, no atomics,
// nothing to reset, so the result is deterministic and the launch safe to
// capture.
//   - The rows go in 128-row chunks (4 rows a lane, 16-byte loads), the
//     chunks in units of `group` (one at 257^3), the units dealt to the
//     CTAs in turn (unit U to CTA U % 16), at most MAX_UNITS a CTA: the
//     selected blocks gather where the surface is, and contiguous runs
//     left a few CTAs with all of phase 2.
//   - Phase 1: every warp counts its units' selected blocks and their
//     popcounts into shared memory (and, one chunk a unit, keeps each
//     chunk's selection as 4 ballot words).
//   - Each CTA scans its own units; cluster barrier; a unit's offset in
//     the grid is the sum over the CTAs of their scans at that unit (or
//     the next one, for the CTAs before it), read through distributed
//     shared memory, one read a (unit, CTA) pair; likewise the totals
//     (b, n). Phase 2: every CTA skips the units with no selected block,
//     loads the selected rows' masks alone (from the ballot words; else
//     every row again), ranks them by a warp scan of the lanes' counts,
//     and writes each kept block with the whole warp, a lane a bit (a lane
//     a block, bit by bit, left 31 lanes idle and set phase 2's time).
//   - Loads are issued a batch at a time (B1 chunks a warp when counting,
//     B2 when writing) before any is used.
//   - Capped form: below the cap every CTA zeroes its share of the padding
//     before phase 2; past it (b > cap_b), the CTA holding the first
//     dropped block posts its bit offset (n), a second barrier shares it,
//     and the padding follows; CTA 0 writes (n, g_over), with `guard`
//     added on the card.
//   - A last cluster barrier before exit, so that no CTA's shared memory
//     goes away while a peer may still read it.
// The exact form takes two launches: the count phase alone writes (b, n),
// summed on the card, into page-locked mapped host memory; the host reads
// those 8 bytes once, sizes ids [n] and blk [b, 3], and the second launch
// writes them. The capped form waits for nothing.
// Measured (chip_smoke.py [compact], PERF.md): 24 us on the main path's
// words-flow launch (29 with a contiguous run of units a CTA), 1.7x the
// earlier three grid-wide kernels (14 us): the time follows the cluster's
// CTAs nearly in proportion (ops/cull_trace.py --scale), so its 16 SMs
// set it; the wrapper, host-bound, is faster than theirs.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 1024;  // 32 warps: the warp-0 scans take one a lane
constexpr int WARPS = THREADS / 32;
constexpr int LANE_ROWS = 4;              // rows a lane takes in a chunk
constexpr int CHUNK = 32 * LANE_ROWS;     // rows a chunk, one warp's
constexpr int MAX_UNITS = 2048;           // units a CTA counts in shared
constexpr int B1 = 4;  // units a warp loads at once when it counts
constexpr int B2 = 2;  // units a warp loads at once when it writes
constexpr unsigned FULL = 0xffffffffu;

enum Mode { COUNT = 0, WRITE = 1, CAPPED = 2 };

struct Args {
  const int* bits;
  const uint8_t* cand;
  int nb, B3, E;
  const int* srow;
  int chunks, group;  // the plan: chunks of the grid, chunks a unit
  int cap_b;
  const int* guard;
  int* ids;
  int* blk;
  int* out;  // COUNT: (b, n) host-mapped; CAPPED: (n, g_over) on the card
  int mode;
  int vec;      // bits 16-byte and cand 4-byte aligned
  int ids_vec;  // ids 16-byte aligned
  int masked;   // one chunk a unit: phase 1 keeps the selection masks
};

// With one chunk a unit, phase 1 keeps each chunk's selection as 4 words
// (bit l of word r: lane l's row r) and phase 2 loads the selected rows'
// masks alone (1.7% of the rows on the main path) instead of every row.
extern __shared__ unsigned sel_words[];

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Phase stamps of a trace build (-DCULL_TRACE): %globaltimer (ns) in CTA
// 0's thread 0 at the start, after phase 1 and the scan, after the
// barrier and the offsets, after phase 2, at the end, and (5) after the
// padding when it is zeroed before phase 2; read with compact_trace().
#ifdef CULL_TRACE
__device__ long long compact_trace_ns[16];
#define STAMP(i)                                                     \
  if (blockIdx.x == 0 && threadIdx.x == 0) {                         \
    long long t;                                                     \
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));            \
    compact_trace_ns[i] = t;                                                    \
    compact_trace_ns[8 + (i)] = clock64();                                         \
  }
#else
#define STAMP(i)
#endif

// A lane's 4 rows of a chunk as loaded (two 16-byte loads of masks and a
// 4-byte load of candidate flags), and as counted: masks, selection bits
// (bit r for row r) and the selected rows' popcounts. Loads and counts
// are apart so that a warp issues a batch's loads before it waits on any.
struct Raw {
  int4 p, q;
  unsigned c4;
};

struct Lane {
  unsigned lo[LANE_ROWS], hi[LANE_ROWS];
  unsigned sel;
  int b, n;  // selected rows, their bits
};

__device__ __forceinline__ Raw load_raw(const Args& a, int row0) {
  Raw w;
  if (a.vec && row0 + LANE_ROWS <= a.nb) {
    const int4* p = reinterpret_cast<const int4*>(a.bits + 2 * row0);
    w.p = __ldg(p);
    w.q = __ldg(p + 1);
    w.c4 = __ldg(reinterpret_cast<const unsigned*>(a.cand + row0));
  } else {
    int v[2 * LANE_ROWS];
    w.c4 = 0;
#pragma unroll
    for (int r = 0; r < LANE_ROWS; ++r) {
      const int i = row0 + r;
      const bool in = i < a.nb;
      v[2 * r] = in ? __ldg(a.bits + 2 * i) : 0;
      v[2 * r + 1] = in ? __ldg(a.bits + 2 * i + 1) : 0;
      w.c4 |= (in ? (unsigned)__ldg(a.cand + i) : 0u) << (8 * r);
    }
    w.p = make_int4(v[0], v[1], v[2], v[3]);
    w.q = make_int4(v[4], v[5], v[6], v[7]);
  }
  return w;
}

__device__ __forceinline__ Lane lane_of(const Raw& w) {
  Lane l;
  l.lo[0] = w.p.x; l.hi[0] = w.p.y; l.lo[1] = w.p.z; l.hi[1] = w.p.w;
  l.lo[2] = w.q.x; l.hi[2] = w.q.y; l.lo[3] = w.q.z; l.hi[3] = w.q.w;
  l.sel = 0;
  l.b = l.n = 0;
#pragma unroll
  for (int r = 0; r < LANE_ROWS; ++r) {
    const bool s = (((w.c4 >> (8 * r)) & 0xffu) != 0) & ((l.lo[r] | l.hi[r]) != 0);
    const int pc = __popc(l.lo[r]) + __popc(l.hi[r]);
    l.sel |= (unsigned)s << r;
    l.b += s;
    l.n += s ? pc : 0;
  }
  return l;
}

// The coarse cell of block (bz, by, bx + r) in row-major block order (the
// words flow's srow index): a ghost block (coordinate c) holds no bit in
// this flow; the clamp keeps its arithmetic in range, as the plain
// version's does.
__device__ __forceinline__ int coarse_cell(int bz, int by, int bx, int r,
                                           int B3) {
  int x = bx + r, y = by, z = bz;
  while (x >= B3) {  // at most once when B3 >= 4
    x -= B3;
    if (++y >= B3) {
      y = 0;
      ++z;
    }
  }
  const int c = B3 - 1;
  return (min(z, c - 1) * c + min(y, c - 1)) * c + min(x, c - 1);
}

// The kept blocks of row r of a chunk, written by the whole warp, one
// block at a time: its row by lanes 0-2, its set bits' ids by the lanes of
// those bits (lane l has bit l of lo and bit l of hi; loff the offsets of
// those two bits' cells). rank, off and sv are the lane's own block's.
__device__ __forceinline__ void write_kept(const Args& a, const Lane& l,
                                           int r, int row0, int rank,
                                           int off, int sv,
                                           const long long loff[2]) {
  const int lane = threadIdx.x & 31;
  unsigned todo =
      __ballot_sync(FULL, ((l.sel >> r) & 1) & (rank < a.cap_b));
  while (todo) {
    const int src = __ffs(todo) - 1;
    todo &= todo - 1;
    const unsigned lo = __shfl_sync(FULL, l.lo[r], src);
    const unsigned hi = __shfl_sync(FULL, l.hi[r], src);
    const int rk = __shfl_sync(FULL, rank, src);
    const int k = __shfl_sync(FULL, off, src);
    const int i = __shfl_sync(FULL, row0, src) + r;
    long long base;
    if (a.srow) {
      base = (long long)max(__shfl_sync(FULL, sv, src), 0) * 64;
    } else {
      const int B3 = a.B3, E = a.E;
      const int bz = i / (B3 * B3), by = (i / B3) % B3, bx = i % B3;
      base = ((long long)(bz * 4) * E + by * 4) * E + bx * 4;
    }
    if (lane < 3) a.blk[3 * rk + lane] = lane == 0 ? i : (int)(lane == 1 ? lo : hi);
    const unsigned below = (1u << lane) - 1;
    if ((lo >> lane) & 1) a.ids[k + __popc(lo & below)] = (int)(base + loff[0]);
    if ((hi >> lane) & 1)
      a.ids[k + __popc(lo) + __popc(hi & below)] = (int)(base + loff[1]);
  }
}

// The capped form's padding, this CTA's share: rows past the kept blocks
// and ids past the kept bits (int4 stores from a 16-byte boundary on).
__device__ void zero_padding(const Args& a, int all_b, int n_kept, int me,
                             int cs) {
  const long long stride = (long long)cs * THREADS;
  const long long first = (long long)me * THREADS + threadIdx.x;
  for (long long r = min(all_b, a.cap_b) + first; r < a.cap_b; r += stride) {
    a.blk[3 * r] = 0;
    a.blk[3 * r + 1] = 0;
    a.blk[3 * r + 2] = 0;
  }
  const long long slots = (long long)a.cap_b * 64;
  const long long head =
      a.ids_vec ? min(slots, ((long long)n_kept + 3) & ~3LL) : slots;
  for (long long s = n_kept + first; s < head; s += stride) a.ids[s] = 0;
  int4* v = reinterpret_cast<int4*>(a.ids);
  for (long long q = head / 4 + first; q < slots / 4; q += stride)
    v[q] = make_int4(0, 0, 0, 0);
}

__global__ void __launch_bounds__(THREADS, 1) compact_kernel(const Args a) {
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int me = (int)cluster.block_rank();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // this CTA's units' counts, then (after the cluster barrier) their
  // offsets in the grid
  __shared__ int unit_b[MAX_UNITS], unit_n[MAX_UNITS];
  // the counts' exclusive scan, the totals last: the peers read it
  __shared__ int loc_b[MAX_UNITS + 1], loc_n[MAX_UNITS + 1];
  int* const pre_b = unit_b;
  int* const pre_n = unit_n;
  __shared__ int red_b[WARPS], red_n[WARPS];
  __shared__ int posted;  // the first dropped block's bit offset, or -1
  __shared__ int s_all_b, s_all_n, s_cut_n;

  STAMP(0);
  // units of `group` chunks, dealt to the CTAs in turn: global unit U is
  // CTA U % cs's local unit U / cs (every CTA's work spans the grid, so
  // phase 2's blocks, which gather where the surface is, spread evenly)
  const int nunits = (a.chunks + a.group - 1) / a.group;
  const int units = me < nunits ? (nunits - me + cs - 1) / cs : 0;
  auto chunk = [&](int u, int g) { return (u * cs + me) * a.group + g; };

  // phase 1: each unit's selected blocks and their bits; a warp loads B1
  // units' chunks at once
  for (int u0 = warp; u0 < units; u0 += B1 * WARPS) {
    int b[B1], n[B1];
#pragma unroll
    for (int j = 0; j < B1; ++j) b[j] = n[j] = 0;
    for (int g = 0; g < a.group; ++g) {
      Raw w[B1];
#pragma unroll
      for (int j = 0; j < B1; ++j) {
        const int u = u0 + j * WARPS, ch = chunk(u, g);
        w[j] = load_raw(a, u < units && ch < a.chunks
                               ? ch * CHUNK + lane * LANE_ROWS
                               : a.nb);
      }
#pragma unroll
      for (int j = 0; j < B1; ++j) {
        const Lane l = lane_of(w[j]);
        b[j] += __reduce_add_sync(FULL, l.b);
        n[j] += __reduce_add_sync(FULL, l.n);
        if (a.masked) {
          const int u = u0 + j * WARPS;
#pragma unroll
          for (int r = 0; r < LANE_ROWS; ++r) {
            const unsigned m = __ballot_sync(FULL, (l.sel >> r) & 1);
            if (lane == r && u < units) sel_words[LANE_ROWS * u + r] = m;
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < B1; ++j)
      if (lane == 0 && u0 + j * WARPS < units) {
        unit_b[u0 + j * WARPS] = b[j];
        unit_n[u0 + j * WARPS] = n[j];
      }
  }
  __syncthreads();
  // this CTA's exclusive scan of its units: a thread takes a run of them
  {
    const int per = (units + THREADS - 1) / THREADS;
    const int t0 = min((int)threadIdx.x * per, units);
    const int t1 = min(t0 + per, units);
    int tb = 0, tn = 0;
    for (int u = t0; u < t1; ++u) {
      tb += unit_b[u];
      tn += unit_n[u];
    }
    int ib = tb, in = tn;  // inclusive scan over the warp
    for (int o = 1; o < 32; o <<= 1) {
      const int vb = __shfl_up_sync(FULL, ib, o);
      const int vn = __shfl_up_sync(FULL, in, o);
      if (lane >= o) {
        ib += vb;
        in += vn;
      }
    }
    if (lane == 31) {
      red_b[warp] = ib;
      red_n[warp] = in;
    }
    __syncthreads();
    if (warp == 0) {
      int wb = red_b[lane], wn = red_n[lane];
      for (int o = 1; o < 32; o <<= 1) {
        const int vb = __shfl_up_sync(FULL, wb, o);
        const int vn = __shfl_up_sync(FULL, wn, o);
        if (lane >= o) {
          wb += vb;
          wn += vn;
        }
      }
      red_b[lane] = wb - red_b[lane];  // exclusive, by warp
      red_n[lane] = wn - red_n[lane];
      if (lane == 31) {
        loc_b[units] = wb;
        loc_n[units] = wn;
      }
    }
    __syncthreads();
    int eb = red_b[warp] + ib - tb, en = red_n[warp] + in - tn;
    for (int u = t0; u < t1; ++u) {
      loc_b[u] = eb;
      loc_n[u] = en;
      eb += unit_b[u];
      en += unit_n[u];
    }
  }
  if (threadIdx.x == 0) posted = -1;
  STAMP(1);
  cluster.sync();  // every CTA's scan is in its shared memory

  // unit u of this CTA (global u cs + me) follows, in CTA j, the units
  // before u (j > me) or up to u (j < me): its offset sums loc_j[u] or
  // loc_j[u + 1] over the CTAs, one (u, j) pair a lane, summed over the
  // cs lanes of a unit by shuffles (cs divides 32)
  for (int p0 = warp * 32; p0 < units * cs; p0 += THREADS) {
    const int p = p0 + lane, u = p / cs, j = p % cs;
    int vb = 0, vn = 0;
    if (p < units * cs) {
      const int k = u + (j < me);
      vb = cluster.map_shared_rank(loc_b, j)[k];
      vn = cluster.map_shared_rank(loc_n, j)[k];
    }
    for (int o = cs / 2; o; o >>= 1) {
      vb += __shfl_xor_sync(FULL, vb, o);
      vn += __shfl_xor_sync(FULL, vn, o);
    }
    if (p < units * cs && j == 0) {
      pre_b[u] = vb;
      pre_n[u] = vn;
    }
  }
  if (warp == 0) {  // the totals
    int vb = 0, vn = 0;
    if (lane < cs) {
      const int uj = (nunits - lane + cs - 1) / cs;  // CTA lane's units
      vb = cluster.map_shared_rank(loc_b, lane)[lane < nunits ? uj : 0];
      vn = cluster.map_shared_rank(loc_n, lane)[lane < nunits ? uj : 0];
    }
    for (int o = 16; o; o >>= 1) {
      vb += __shfl_xor_sync(FULL, vb, o);
      vn += __shfl_xor_sync(FULL, vn, o);
    }
    if (lane == 0) {
      s_all_b = vb;
      s_all_n = vn;
    }
  }
  __syncthreads();
  const int all_b = s_all_b, all_n = s_all_n;
  STAMP(2);

  if (a.mode == COUNT) {
    cluster_arrive();
    if (me == 0 && threadIdx.x == 0) {
      a.out[0] = all_b;
      a.out[1] = all_n;
    }
    cluster_wait();
    return;
  }

  // below the cap the padding starts at n: zero it first, under phase 2
  const bool over = all_b > a.cap_b;
  if (a.mode == CAPPED && !over) zero_padding(a, all_b, all_n, me, cs);
  STAMP(5);

  // phase 2: rows and ids; a warp loads B2 units' chunks at once (units
  // without a selected block are skipped), then a chunk's selected
  // blocks' srow entries, and writes each kept block with all its lanes
  long long loff[2];  // the cells of bits lane and lane + 32
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int l = lane + 32 * h;
    loff[h] = a.srow ? l
                     : ((long long)(l >> 4) * a.E + ((l >> 2) & 3)) * a.E +
                           (l & 3);
  }
  for (int u0 = warp; u0 < units; u0 += B2 * WARPS) {
    int run_b[B2], run_n[B2];
    bool some[B2];  // the unit has a selected block
#pragma unroll
    for (int j = 0; j < B2; ++j) {
      const int u = u0 + j * WARPS;
      const int uu = min(u, units - 1);
      run_b[j] = pre_b[uu];
      run_n[j] = pre_n[uu];
      some[j] = u < units && loc_b[uu + 1] > loc_b[uu];
    }
    for (int g = 0; g < a.group; ++g) {
      Raw w[B2];
      int row0[B2];
#pragma unroll
      for (int j = 0; j < B2; ++j) {
        const int ch = chunk(u0 + j * WARPS, g);
        row0[j] = some[j] && ch < a.chunks ? ch * CHUNK + lane * LANE_ROWS
                                           : a.nb;
        if (!a.masked) w[j] = load_raw(a, row0[j]);
      }
#pragma unroll
      for (int j = 0; j < B2; ++j) {
        if (!some[j]) continue;  // uniform: nothing to write
        Lane l;
        if (a.masked) {  // the selected rows' masks alone
          const unsigned* m = sel_words + LANE_ROWS * (u0 + j * WARPS);
          l.sel = 0;
          l.b = l.n = 0;
#pragma unroll
          for (int r = 0; r < LANE_ROWS; ++r) {
            const bool s = (m[r] >> lane) & 1;
            const int i = row0[j] + r;
            l.sel |= (unsigned)s << r;
            l.lo[r] = s ? (unsigned)__ldg(a.bits + 2 * i) : 0u;
            l.hi[r] = s ? (unsigned)__ldg(a.bits + 2 * i + 1) : 0u;
          }
#pragma unroll
          for (int r = 0; r < LANE_ROWS; ++r) {
            l.b += (l.sel >> r) & 1;
            l.n += __popc(l.lo[r]) + __popc(l.hi[r]);
          }
        } else {
          l = lane_of(w[j]);
        }
        int sv[LANE_ROWS] = {0, 0, 0, 0};
        if (a.srow && l.sel) {
          const int B3 = a.B3, i = row0[j];
          const int bz = i / (B3 * B3), by = (i / B3) % B3, bx = i % B3;
#pragma unroll
          for (int r = 0; r < LANE_ROWS; ++r)
            if ((l.sel >> r) & 1)
              sv[r] = __ldg(a.srow + coarse_cell(bz, by, bx, r, B3));
        }
        const int packed = (l.n << 8) | l.b;  // b <= 128, n <= 8192
        int incl = packed;
        for (int o = 1; o < 32; o <<= 1) {
          const int v = __shfl_up_sync(FULL, incl, o);
          if (lane >= o) incl += v;
        }
        const int total = __shfl_sync(FULL, incl, 31);
        int rank = run_b[j] + ((incl - packed) & 0xff);
        int off = run_n[j] + ((incl - packed) >> 8);
#pragma unroll
        for (int r = 0; r < LANE_ROWS; ++r) {
          const bool s = (l.sel >> r) & 1;
          // the first block past the cap: its offset is n of the capped form
          if (s && rank == a.cap_b) posted = off;
          write_kept(a, l, r, row0[j], rank, off, sv[r], loff);
          rank += s;
          off += s ? __popc(l.lo[r]) + __popc(l.hi[r]) : 0;
        }
        run_b[j] += total & 0xff;
        run_n[j] += total >> 8;
      }
    }
  }

  STAMP(3);
  int n_kept = all_n;
  if (a.mode == CAPPED && over) {
    cluster.sync();  // the cut's n is posted
    if (warp == 0) {  // the one CTA that posted it
      int v = lane < cs ? *cluster.map_shared_rank(&posted, lane) : -1;
      for (int o = 16; o; o >>= 1) v = max(v, __shfl_xor_sync(FULL, v, o));
      if (lane == 0) s_cut_n = v;
    }
    __syncthreads();
    n_kept = s_cut_n;
  }
  cluster_arrive();  // no peer reads this CTA's shared memory past here
  if (a.mode == CAPPED) {
    if (over) zero_padding(a, all_b, n_kept, me, cs);
    if (me == 0 && threadIdx.x == 0) {
      a.out[0] = n_kept;
      a.out[1] = max(all_b - a.cap_b, 0) + (a.guard ? *a.guard : 0);
    }
  }
  STAMP(4);
  cluster_wait();
}

// one launch of `ctas` CTAs as one cluster; the occupancy query once for
// each size (0 = not asked yet, -1 = no such cluster fits)
int launch(const Args& a, int ctas, cudaStream_t stream) {
  static int fits[17];
  // a power of two up to 16: the offsets' sums run over lanes in groups
  if (ctas < 1 || ctas > 16 || (ctas & (ctas - 1)))
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = sizeof(unsigned) * LANE_ROWS * MAX_UNITS;
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
        compact_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
    // the masks with the static arrays pass 48 KB: opt in
    err = cudaFuncSetAttribute(compact_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)cfg.dynamicSmemBytes);
    if (err != cudaSuccess) return (int)err;
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, compact_kernel, &cfg);
    if (err != cudaSuccess) return (int)err;
    fits[ctas] = clusters > 0 ? 1 : -1;
  }
  if (fits[ctas] < 0) return -1;
  cfg.dynamicSmemBytes =
      a.masked ? sizeof(unsigned) * LANE_ROWS *
                     ((a.chunks + ctas - 1) / ctas)
               : 0;
  cudaError_t err = cudaLaunchKernelEx(&cfg, compact_kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

Args make_args(const int* bits, const uint8_t* cand, int nb, int B3, int E,
               const int* srow, int chunks, int group, int cap_b,
               const int* guard, int* ids, int* blk, int* out, int mode) {
  Args a;
  a.bits = bits;
  a.cand = cand;
  a.nb = nb;
  a.B3 = B3;
  a.E = E;
  a.srow = srow;
  a.chunks = chunks;
  a.group = group;
  a.cap_b = cap_b;
  a.guard = guard;
  a.ids = ids;
  a.blk = blk;
  a.out = out;
  a.mode = mode;
  a.vec = ((uintptr_t)bits % 16 == 0) && ((uintptr_t)cand % 4 == 0);
  a.ids_vec = (uintptr_t)ids % 16 == 0;
  a.masked = group == 1;
  return a;
}

// 8 bytes of page-locked, device-mapped host memory a host thread, for the
// exact form's (b, n)
int* mapped_counts() {
  static thread_local int* host = nullptr;
  if (!host &&
      cudaHostAlloc((void**)&host, 2 * sizeof(int),
                    cudaHostAllocMapped | cudaHostAllocPortable) != cudaSuccess)
    host = nullptr;
  return host;
}

}  // namespace

#ifdef CULL_TRACE
extern "C" int compact_trace(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, compact_trace_ns,
                                   sizeof(compact_trace_ns));
}
#endif

// Constants of the plan (ops/block_compact.compact_plan): rows a chunk,
// units a CTA holds in shared memory.
extern "C" int compact_chunk_rows() { return CHUNK; }
extern "C" int compact_max_units() { return MAX_UNITS; }

// The exact form's first launch: the selected blocks and their bits over
// the whole grid, summed on the card; waits for them and returns them in
// bn [2] = (b, n). Returns a CUDA error (-1: no cluster of `ctas` fits).
extern "C" int compact_count(const int* bits, const uint8_t* cand, int nb,
                             int chunks, int group, int ctas, int* bn,
                             cudaStream_t stream) {
  int* host = mapped_counts();
  if (!host) return (int)cudaErrorMemoryAllocation;
  int* dev = nullptr;
  cudaError_t e = cudaHostGetDevicePointer((void**)&dev, host, 0);
  if (e != cudaSuccess) return (int)e;
  const Args a = make_args(bits, cand, nb, 0, 0, nullptr, chunks, group, 0,
                           nullptr, nullptr, nullptr, dev, COUNT);
  const int err = launch(a, ctas, stream);
  if (err) return err;
  e = cudaStreamSynchronize(stream);
  if (e != cudaSuccess) return (int)e;
  bn[0] = ((volatile int*)host)[0];
  bn[1] = ((volatile int*)host)[1];
  return 0;
}

// The exact form's second launch: ids [n] and blk [b, 3] of every selected
// block (b, n from compact_count).
extern "C" int compact_write(const int* bits, const uint8_t* cand, int nb,
                             int B3, int E, const int* srow, int chunks,
                             int group, int ctas, int b, int* ids, int* blk,
                             cudaStream_t stream) {
  const Args a = make_args(bits, cand, nb, B3, E, srow, chunks, group, b,
                           nullptr, ids, blk, nullptr, WRITE);
  return launch(a, ctas, stream);
}

// The capped form in one launch, nothing read back: ids [cap_b*64], blk
// [cap_b, 3], out [2] = (n, g_over); g_over adds *guard when it is not
// null.
extern "C" int compact_capped(const int* bits, const uint8_t* cand, int nb,
                              int B3, int E, const int* srow, int chunks,
                              int group, int ctas, int cap_b,
                              const int* guard, int* ids, int* blk, int* out,
                              cudaStream_t stream) {
  const Args a = make_args(bits, cand, nb, B3, E, srow, chunks, group, cap_b,
                           guard, ids, blk, out, CAPPED);
  return launch(a, ctas, stream);
}
