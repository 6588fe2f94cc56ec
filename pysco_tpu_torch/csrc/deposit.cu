// Tile-binned particle deposit (NGP/CIC/TSC) for Hopper, sm_90a.
//
// Replaces pysco_tpu/ops/pallas_pm.py::_deposit_kernel, which walks the
// tiles in order on one TPU core, sums each tile's particles into a VMEM
// window by one-hot MXU contractions and adds the windows into a padded
// grid by DMA. Here one thread block takes one tile (an x-plane, an 8-row
// y-block and, from 512^3 up, a 128-cell z-block; particles are
// tile-sorted, tile t owning columns [starts[t], starts[t+1])).
//
// The acceptance envelope is the TPU kernel's: with drift = k a particle
// lands exactly if its base lies within k cells of its (stale) tile in x,
// and within the 8-rounded y window and 128-rounded z window (wy_pad,
// wz_pad); the cells of a particle beyond that are dropped, and
// tiled_pm.drift_violations counts the particle.
//
// What bounds it on the card: neither bytes (12 N + 4 n^3, 0.64 ms at
// 512^3) nor float32 operations, but the block's own steps on each chunk
// of 512 particles (stage their weights, sort them, find their bins, sum
// them), and on evolved states how evenly a chunk's adds fall on the
// block's threads. A chunk from a halo puts most of its particles in a few
// (y, z) cells: at z = 0 of a 512^3 run the fullest cell of a chunk alone
// holds 8 times a thread's share of its adds, so a walk that leaves each
// cell's particles to one thread leaves the rest of the block waiting at
// the next barrier. The design:
//
// - Bins by cell. A chunk is ordered by its particles' base cell (zl, yl)
//   in the window with a stable block radix sort (CUB's BlockRadixSort:
//   ranks from prefix sums in thread order, no atomics). The starts of
//   the bins come from the run boundaries of the sorted keys: each first
//   particle of a key marks its bin, and each thread fills the empty bins
//   of its own block of bins from the next mark, found by one search of
//   the sorted keys: O(chunk + bins) work a chunk.
// - A thread a z column, as long as the chunk is even: thread z sums the
//   particles of the w z bins that reach column z (one run of keys), w x w
//   cells each, the way a uniform chunk is cheapest.
// - A column holding more than kColumnSkew times a thread's mean share of
//   the chunk's visits is heavy, and its x-lines (y, z), each with its
//   w + 2 drift cells along x, go to every thread: the heavy lines' visits
//   (a particle visits the lines of its w y cells in each heavy column its
//   cells reach) are cut into equal shares in line order. The thread where a line's visits
//   start owns it; a thread whose share starts inside a line sums that
//   part into a partial of its own, which the owner adds in thread order
//   once every share is done. A clumped chunk thus costs about what a
//   uniform one does.
// - Determinism without atomics. Each cell has one writer a chunk (its
//   column's thread, or its line's owner), and the order of its sum
//   follows from the sorted keys alone: the chunks in tile order, then in
//   a column the bins by (zl, yl) and a bin's particles in their order in
//   the tile; in a heavy line the bins by oz, then yl, then the particles,
//   a streak of one x offset summed in registers and added into the
//   window, then the partials in thread order.
// - The live window only. Shared memory holds (w + 2 drift) x-planes x
//   (8 + w - 1 + 2 drift) y-rows x (the z line, or zbs + w - 1 + 2 drift
//   z-cells), the cells a particle that keeps its drift bound can reach,
//   not the 8- and 128-rounded extents; only those are zeroed and added
//   into the padded grid, a warp to a z run. A particle of the envelope
//   that reaches beyond the live window (it broke its drift bound, or a
//   fresh sort holds it off its tile) adds those cells straight into the
//   padded grid from the block's first thread, in the chunk's order.
// - The next chunk's positions are loaded while the block sums this one.
// - The windows are added into the padded grid in a fixed sequence of
//   launches, each one residue class of tiles whose padded windows cannot
//   overlap (x-plane mod the window's x extent, y-block and z-block mod the
//   blocks the padded window spans), so a plain read-modify-write is safe
//   and a deposit is bitwise the same on every run, as the reference's
//   fixed-order deposit is. The periodic fold of the pads is left to
//   PyTorch (tiled_pm._fold_yz, and _fold_axis along x).
// - One kernel for the whole grid and for an x-slab of it
//   (pallas_pm.deposit_slab): the tiles are the slab's n_planes planes, the
//   padded grid is n_planes + wx - 1 planes tall and is not periodic in x
//   (its pads go to the neighbouring slabs, or fold onto the grid itself
//   when the slab is the grid), and only the window's x offset under a stale
//   sort needs the tile's global plane, plane + plane0. The residue classes
//   in x stay disjoint for a slab thinner than the window: a class then
//   holds one plane or none.
// - A counter, when the caller hands one (tracing only): one integer
//   atomicAdd a chunk, and one more when a thread's adds (its column's,
//   its share's and the partials it adds) exceed 4 times the chunk's mean
//   a thread.

#include <cub/block/block_radix_sort.cuh>
#include <cub/block/block_scan.cuh>

#include "tiled_pm.cuh"

namespace {

using pysco::axis_weights;
using pysco::kSentinelMin;
using pysco::kYB;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 2;                  // particles a thread sorts
constexpr int kChunk = kThreads * kItems;  // particles staged per pass
constexpr int kSortScratch = 12288;        // bytes kept for the block sort
constexpr int kMaxKeyBits = 16;            // bin keys and starts are 16-bit
constexpr int kSmemLimit = 232448;         // a block's dynamic opt-in
constexpr int kBlocksPerSM = 4;            // at most 64 registers a thread
constexpr unsigned short kNoStart = 0xFFFF;
// A z column with more visits than this many times a thread's mean share
// of the chunk's (w a particle) is heavy: its x-lines go to every thread.
// A uniform chunk's fullest column holds about 4 times the mean (4, 6 and
// 8 timed at 512^3 in PERF.md).
constexpr unsigned kColumnSkew = 6;

using BlockSort = cub::BlockRadixSort<unsigned, kThreads, kItems, int>;
using BlockScan = cub::BlockScan<int, kThreads, cub::BLOCK_SCAN_WARP_SCANS>;
static_assert(sizeof(BlockSort::TempStorage) <= kSortScratch,
              "the block sort needs more scratch: raise kSortScratch here "
              "and _DEPOSIT_SORT_SCRATCH in ops/tiled_pm.py");

// The arrays that take the sort scratch's place once a chunk is sorted, in
// this order: the sorted packed particles; the counter's sums a warp; the
// prefix sum's scratch; the visits before each thread's block of heavy
// lines (and the total); the heavy columns; the bin starts; and, sharing
// one place, the sorted keys (while the starts are found) and the
// threads' partials (after).
constexpr int kValBytes = 4 * kChunk;
constexpr int kRedBytes = 4 * 2 * kWarps;
constexpr int kScanBytes = 64;
constexpr int kPreBytes = (4 * (kThreads + 1) + 15) / 16 * 16;
constexpr int kHeavyBytes = 2 * kThreads;
constexpr int kHeadBytes =
    kValBytes + kRedBytes + kScanBytes + kPreBytes + kHeavyBytes;
static_assert(sizeof(BlockScan::TempStorage) <= kScanBytes,
              "the prefix sum needs more scratch: raise kScanBytes here "
              "and in ops/tiled_pm.py");

struct DepositGeo {
  int m, w, drift, wx, wy_pad, wz_pad, zbs, nbz, nby, gy, gz;
  int n_planes, plane0;  // the slab's planes, and the global plane of its first
  int wy, wz;    // the live window's y and z extents
  int lines;     // wy * wz x-lines
  int nyb;       // y bins: yl + w - 1 in [0, wy + w - 1)
  int nzb;       // z bins: zl + w - 1 in [0, wz + w - 1), or zl on the z
                 // line when it is the window (nbz == 1)
  int nbins;     // nzb * nyb bins, key zk * nyb + yk; nbins = no live cell
  int key_bits;  // bits of nbins
  int starts;    // bytes of the bin starts, 16-byte rounded
  int scratch;   // bytes of the sort scratch / the arrays that follow it
};

DepositGeo make_geo(int m, int w, int drift, int wy_pad, int wz_pad, int zbs,
                    int nbz, int n_planes = -1, int plane0 = 0) {
  DepositGeo g{};
  g.m = m;
  g.n_planes = n_planes < 0 ? m : n_planes;
  g.plane0 = plane0;
  g.w = w;
  g.drift = drift;
  g.wx = w + 2 * drift;
  g.wy_pad = wy_pad;
  g.wz_pad = wz_pad;
  g.zbs = zbs;
  g.nbz = nbz;
  g.nby = m / kYB;
  g.gy = m + wy_pad - kYB;
  g.gz = nbz == 1 ? m : m + wz_pad - zbs;
  g.wy = kYB + g.wx - 1;
  g.wz = nbz == 1 ? m : zbs + g.wx - 1;
  g.lines = g.wy * g.wz;
  g.nyb = g.wy + w - 1;
  g.nzb = nbz == 1 ? m : g.wz + w - 1;
  g.nbins = g.nzb * g.nyb;
  g.key_bits = 32 - __builtin_clz(static_cast<unsigned>(g.nbins));
  g.starts = (2 * (g.nbins + 1) + 15) / 16 * 16;
  const int shared = 4 * kThreads * g.wx > 2 * kChunk ? 4 * kThreads * g.wx
                                                      : 2 * kChunk;
  const int arrays = kHeadBytes + g.starts + shared;
  g.scratch = ((kSortScratch > arrays ? kSortScratch : arrays) + 15) / 16 * 16;
  return g;
}

// Dynamic shared memory of a block: the scratch, the live window, and 3 w
// weights a staged particle.
size_t smem_bytes(const DepositGeo& g) {
  return static_cast<size_t>(g.scratch) +
         4 * static_cast<size_t>(g.wx) * g.wy * g.wz +
         4 * static_cast<size_t>(kChunk) * 3 * g.w;
}

// Offset of a base cell from its tile's first cell under a stale sort:
// the modular offset mapped to [-drift, m - drift), plus drift.
__device__ __forceinline__ int window_offset(int base, int origin, int m,
                                             int drift) {
  const int raw = (base - origin + 2 * m) % m;
  return (raw >= m - drift ? raw - m : raw) + drift;
}

// A staged particle's x offset dx in [0, m), and its base cell's y and z
// offsets yl, zl from the window's origin.
struct Offsets {
  int dx, yl, zl;
};

// A particle's offsets; writes its 3 w weights to wt.
__device__ __forceinline__ Offsets stage(const DepositGeo& g, float px,
                                         float py, float pz, int plane, int y0,
                                         int zoff, float* wt) {
  const float fm = static_cast<float>(g.m);
  const int bx = axis_weights(g.w, px * fm, wt);
  const int by = axis_weights(g.w, py * fm, wt + g.w);
  const int bz = axis_weights(g.w, pz * fm, wt + 2 * g.w);
  const int zw = bz < 0 ? bz + g.m : bz;
  Offsets o{0, 0, 0};
  if (g.drift) {
    o.dx = window_offset(bx, plane + g.plane0, g.m, g.drift);
    o.yl = window_offset(by, y0, g.m, g.drift);
  } else {  // fresh sort: the base plane is the tile's
    o.yl = (by < 0 ? by + g.m : by) - y0;
  }
  if (g.nbz == 1) {
    o.zl = zw;
  } else {
    o.zl = g.drift ? window_offset(zw, zoff, g.m, g.drift) : zw - zoff;
  }
  return o;
}

// Whether a staged particle may have cells in the envelope beyond the live
// window (the spill path checks each cell).
__device__ __forceinline__ bool beyond_live(const DepositGeo& g,
                                            const Offsets& o) {
  if (o.dx >= g.wx) return false;
  const bool y = o.yl + g.w > g.wy && o.yl < g.wy_pad;
  const bool z = g.nbz > 1 && o.zl + g.w > g.wz && o.zl < g.wz_pad;
  return y || z;
}

// z key of a base cell: zl + w - 1, or zl itself on the z line.
__device__ __forceinline__ int z_key(const DepositGeo& g, int zl) {
  return g.nbz == 1 ? zl : zl + g.w - 1;
}

// The particle's bin key, nbins when no cell of the live window is its.
__device__ __forceinline__ unsigned bin_key(const DepositGeo& g,
                                            const Offsets& o) {
  const int yk = o.yl + g.w - 1, zk = z_key(g, o.zl);
  if (o.dx >= g.wx || yk < 0 || yk >= g.nyb || zk < 0 || zk >= g.nzb) {
    return static_cast<unsigned>(g.nbins);
  }
  return static_cast<unsigned>(zk * g.nyb + yk);
}

// A sorted particle, packed: its slot, x offset, y and z keys.
__device__ __forceinline__ int pack(int slot, int dx, int yk, int zk) {
  return slot | (dx << 9) | (yk << 13) | (zk << 18);
}
__device__ __forceinline__ int slot_of(int v) { return v & (kChunk - 1); }
__device__ __forceinline__ int dx_of(int v) { return (v >> 9) & 15; }
__device__ __forceinline__ int yk_of(int v) { return (v >> 13) & 31; }
__device__ __forceinline__ int zk_of(int v) { return v >> 18; }

// z key of the bins at z offset oz from column z: z - oz + w - 1, or
// (z - oz) mod m on the z line.
__device__ __forceinline__ int z_bin(const DepositGeo& g, int z, int oz) {
  if (g.nbz > 1) return z + g.w - 1 - oz;
  return z >= oz ? z - oz : z - oz + g.m;
}

// The sorted slots of x-line (y, z)'s bins: for each oz, the run of bins
// (y - oy, z - oz) for oy = w - 1, ..., 0 (w consecutive keys).
template <int W>
struct LineRuns {
  int lo[W], hi[W];

  __device__ __forceinline__ LineRuns(const DepositGeo& g,
                                      const unsigned short* s_start, int y,
                                      int z) {
#pragma unroll
    for (int oz = 0; oz < W; ++oz) {
      const int k0 = z_bin(g, z, oz) * g.nyb + y;
      lo[oz] = s_start[k0];
      hi[oz] = s_start[k0 + W];
    }
  }

  __device__ __forceinline__ int visits() const {
    int n = 0;
#pragma unroll
    for (int r = 0; r < W; ++r) n += hi[r] - lo[r];
    return n;
  }
};

// Visits [a, b) of x-line (y, z), summed into cells X * stride (X the x
// offset): a streak of particles with one x offset in registers, then
// added into the cells.
template <int W>
__device__ __forceinline__ void sum_visits(
    const DepositGeo& g, const LineRuns<W>& runs, int a, int b, int y,
    const int* s_val, const float* s_wt, float* cells, int stride) {
  int cur = -1;  // the streak's x offset
  float acc[W];
  int off = 0;
#pragma unroll
  for (int oz = 0; oz < W; ++oz) {
    const int n = runs.hi[oz] - runs.lo[oz];
    const int s0 = runs.lo[oz] + max(a - off, 0);
    const int s1 = runs.lo[oz] + min(b - off, n);
    off += n;
    for (int s = s0; s < s1; ++s) {
      const int v = s_val[s];
      const int dx = dx_of(v), oy = y + W - 1 - yk_of(v);
      if (dx != cur) {
        if (cur >= 0) {
#pragma unroll
          for (int i = 0; i < W; ++i) {
            if (cur + i < g.wx) cells[(cur + i) * stride] += acc[i];
          }
        }
        cur = dx;
#pragma unroll
        for (int i = 0; i < W; ++i) acc[i] = 0.0f;
      }
      const float* wt = s_wt + 3 * W * slot_of(v);
      const float wyv = wt[W + oy], wzv = wt[2 * W + oz];
#pragma unroll
      for (int i = 0; i < W; ++i) acc[i] += (wt[i] * wyv) * wzv;
    }
  }
  if (cur >= 0) {
#pragma unroll
    for (int i = 0; i < W; ++i) {
      if (cur + i < g.wx) cells[(cur + i) * stride] += acc[i];
    }
  }
}

// The sorted slots of z column z's bins, those of z keys z_bin(z, w - 1) to
// z_bin(z, 0) (two runs where they wrap round the z line, else one), and
// their count.
struct ColumnRuns {
  int lo[2], hi[2];

  __device__ __forceinline__ ColumnRuns(const DepositGeo& g,
                                        const unsigned short* s_start,
                                        int z) {
    const int first = z_bin(g, z, g.w - 1), last = z_bin(g, z, 0);
    if (first <= last) {
      lo[0] = s_start[first * g.nyb];
      hi[0] = s_start[(last + 1) * g.nyb];
      lo[1] = hi[1] = 0;
    } else {  // wraps: keys [0, last] and [first, m)
      lo[0] = s_start[0];
      hi[0] = s_start[(last + 1) * g.nyb];
      lo[1] = s_start[first * g.nyb];
      hi[1] = s_start[g.nbins];
    }
  }

  __device__ __forceinline__ int visits() const {
    return hi[0] - lo[0] + hi[1] - lo[1];
  }
};

// Every add of z column z's particles into the window: w x w cells each
// (x offset, y) in the column, in sorted order.
template <int W>
__device__ __forceinline__ void sum_column(const DepositGeo& g,
                                           const ColumnRuns& runs, int z,
                                           const int* s_val,
                                           const float* s_wt, float* win) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    for (int s = runs.lo[r]; s < runs.hi[r]; ++s) {
      const int v = s_val[s];
      const int dx = dx_of(v), yl = yk_of(v) - (W - 1);
      int oz = z - zk_of(v);
      oz = g.nbz > 1 ? oz + W - 1 : (oz < 0 ? oz + g.m : oz);
      const float* wt = s_wt + 3 * W * slot_of(v);
      const float wzv = wt[2 * W + oz];
#pragma unroll
      for (int a = 0; a < W; ++a) {
        if (dx + a >= g.wx) break;
        const float wxa = wt[a];
#pragma unroll
        for (int oy = 0; oy < W; ++oy) {
          const int ya = yl + oy;
          if (ya < 0 || ya >= g.wy) continue;
          win[((dx + a) * g.wy + ya) * g.wz + z] += (wxa * wt[W + oy]) * wzv;
        }
      }
    }
  }
}

// The largest u in [0, kThreads] with pre[u] <= v (pre[0] = 0 <= v).
__device__ __forceinline__ int block_of(const int* pre, int v) {
  int lo = 0, hi = kThreads + 1;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (pre[mid] <= v) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return lo;
}

template <int W>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
deposit_tiles(const float* __restrict__ pos, long long n_up,
              const int* __restrict__ starts, float* __restrict__ gp,
              DepositGeo g, int rx, int ry, int rz, int sx, int sy, int sz,
              int ncy, int ncz, unsigned long long* __restrict__ counts) {
  const int b = blockIdx.x;
  const int plane = rx + sx * (b / (ncy * ncz));  // slab-local
  const int yb = ry + sy * ((b / ncz) % ncy);
  const int zb = rz + sz * (b % ncz);
  const int t = (plane * g.nby + yb) * g.nbz + zb;
  const int start = starts[t], end = starts[t + 1];
  if (end <= start) return;

  extern __shared__ __align__(16) unsigned char smem[];
  auto& sort_tmp = *reinterpret_cast<BlockSort::TempStorage*>(smem);
  int* s_val = reinterpret_cast<int*>(smem);  // after the sort
  unsigned* s_red = reinterpret_cast<unsigned*>(smem + kValBytes);
  auto& scan_tmp = *reinterpret_cast<BlockScan::TempStorage*>(
      smem + kValBytes + kRedBytes);
  int* s_pre = reinterpret_cast<int*>(smem + kValBytes + kRedBytes +
                                     kScanBytes);
  unsigned short* s_heavy = reinterpret_cast<unsigned short*>(
      smem + kHeadBytes - kHeavyBytes);
  unsigned short* s_start =
      reinterpret_cast<unsigned short*>(smem + kHeadBytes);
  unsigned short* s_key =
      reinterpret_cast<unsigned short*>(smem + kHeadBytes + g.starts);
  float* s_part = reinterpret_cast<float*>(smem + kHeadBytes + g.starts);
  float* win = reinterpret_cast<float*>(smem + g.scratch);
  const int rows = g.wx * g.wy;
  float* s_wt = win + rows * g.wz;  // 3 W a particle
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int y0 = yb * kYB;
  const int zoff = g.nbz == 1 ? 0 : zb * g.zbs;
  // this thread's block of bins, whose starts it fills
  const int kb = (g.nbins + 1 + kThreads - 1) / kThreads;
  const int b0 = min(static_cast<int>(threadIdx.x) * kb, g.nbins + 1);
  const int b1 = min(b0 + kb, g.nbins + 1);

  for (int r = warp; r < rows; r += kWarps) {
    for (int z = lane; z < g.wz; z += 32) win[r * g.wz + z] = 0.0f;
  }

  float px[kItems], py[kItems], pz[kItems];
  auto load = [&](int c0) {
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int slot = threadIdx.x * kItems + j;
      px[j] = 2.0f;
      py[j] = pz[j] = 0.0f;
      if (slot < end - c0) {
        const long long c = c0 + slot;
        px[j] = pos[c];
        py[j] = pos[n_up + c];
        pz[j] = pos[2 * n_up + c];
      }
    }
  };
  load(start);

  for (int c0 = start; c0 < end; c0 += kChunk) {
    const int np = min(kChunk, end - c0);
    __syncthreads();  // window zeroed / previous chunk consumed
    bool spill = false;
    unsigned keys[kItems];
    int vals[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int slot = threadIdx.x * kItems + j;
      keys[j] = static_cast<unsigned>(g.nbins);
      vals[j] = slot;
      if (px[j] < kSentinelMin) {
        const Offsets o = stage(g, px[j], py[j], pz[j], plane, y0, zoff,
                                s_wt + 3 * W * slot);
        keys[j] = bin_key(g, o);
        if (keys[j] != static_cast<unsigned>(g.nbins)) {
          vals[j] = pack(slot, o.dx, o.yl + W - 1, z_key(g, o.zl));
        }
        spill = spill || beyond_live(g, o);
      }
    }
    if (c0 + kChunk < end) load(c0 + kChunk);  // in flight while summing
    const bool any_spill = __syncthreads_or(spill);

    // stable sort of the chunk by bin; thread t holds slots t kItems + j
    BlockSort(sort_tmp).Sort(keys, vals, 0, g.key_bits);
    __syncthreads();  // the sort scratch becomes the arrays
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      s_val[threadIdx.x * kItems + j] = vals[j];
      s_key[threadIdx.x * kItems + j] = static_cast<unsigned short>(keys[j]);
    }
    for (int k = b0; k < b1; ++k) s_start[k] = kNoStart;
    __syncthreads();
    // the first slot of every key marks its bin; the first slot with a key
    // at or past b1 starts the bins that follow this thread's
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int s = threadIdx.x * kItems + j;
      if (s == 0 || s_key[s - 1] != keys[j]) {
        s_start[keys[j]] = static_cast<unsigned short>(s);
      }
    }
    int next = 0;
#pragma unroll
    for (int step = kChunk / 2; step >= 1; step >>= 1) {
      if (s_key[next + step - 1] < b1) next += step;
    }
    if (s_key[next] < b1) ++next;
    __syncthreads();
    for (int k = b1 - 1; k >= b0; --k) {
      if (s_start[k] == kNoStart) {
        s_start[k] = static_cast<unsigned short>(next);
      } else {
        next = s_start[k];
      }
    }
    __syncthreads();

    // z columns holding more than kColumnSkew times a thread's mean share
    // of the chunk's visits (w a particle with a live cell) are heavy
    const unsigned heavy_above = kColumnSkew * W * s_start[g.nbins];
    int mine = 0;
    for (int z = threadIdx.x; z < g.wz; z += kThreads) {
      mine += ColumnRuns(g, s_start, z).visits() * kThreads > heavy_above;
    }
    unsigned work = 0;  // this thread's adds
    if (__syncthreads_count(mine) == 0) {  // a thread a column
      for (int z = threadIdx.x; z < g.wz; z += kThreads) {
        const ColumnRuns runs(g, s_start, z);
        sum_column<W>(g, runs, z, s_val, s_wt, win);
        work += runs.visits() * W * W;
      }
    } else {
      // the heavy columns in a list, light ones kept by their threads
      int first, n_heavy;
      BlockScan(scan_tmp).ExclusiveSum(mine, first, n_heavy);
      for (int z = threadIdx.x; z < g.wz; z += kThreads) {
        if (ColumnRuns(g, s_start, z).visits() * kThreads > heavy_above) {
          s_heavy[first++] = static_cast<unsigned short>(z);
        }
      }
      __syncthreads();
      // the x-lines (y, z) of the heavy columns, line h = i wy + y of the
      // i-th: the visits of this thread's block of them; their prefix sum
      const int lines = n_heavy * g.wy;
      const int kl = (lines + kThreads - 1) / kThreads;
      const int l0 = min(static_cast<int>(threadIdx.x) * kl, lines);
      const int l1 = min(l0 + kl, lines);
      int counted = 0;
      for (int h = l0; h < l1; ++h) {
        const int i = h / g.wy;
        counted += LineRuns<W>(g, s_start, h - i * g.wy, s_heavy[i]).visits();
      }
      int before, total;
      BlockScan(scan_tmp).ExclusiveSum(counted, before, total);
      s_pre[threadIdx.x] = before;
      if (threadIdx.x == 0) s_pre[kThreads] = total;
      __syncthreads();

      for (int z = threadIdx.x; z < g.wz; z += kThreads) {
        const ColumnRuns runs(g, s_start, z);
        if (runs.visits() * kThreads > heavy_above) continue;
        sum_column<W>(g, runs, z, s_val, s_wt, win);
        work += runs.visits() * W * W;
      }
      // this thread's share of the heavy lines' visits, [v0, v1)
      const int q = (total + kThreads - 1) / kThreads;
      const int v0 = min(static_cast<int>(threadIdx.x) * q, total);
      const int v1 = min(v0 + q, total);
      int owned = -1, last = 0;  // the line continued past v1, its last share
      if (v0 < v1) {
        int u = block_of(s_pre, v0);
        int h = u * kl, at = s_pre[u];  // line h's first visit is number at
        while (at < v1) {
          const int i = h / g.wy, y = h - i * g.wy, l = y * g.wz + s_heavy[i];
          const LineRuns<W> runs(g, s_start, y, s_heavy[i]);
          const int n = runs.visits();
          const int a = max(v0 - at, 0), e = min(v1 - at, n);
          if (a < e) {
            float* cells = win + l;
            int stride = g.lines;
            if (a > 0) {  // inside a line an earlier share owns
              cells = s_part + threadIdx.x * g.wx;
              stride = 1;
              for (int x = 0; x < g.wx; ++x) cells[x] = 0.0f;
            } else if (at + n > v1) {
              owned = l;
              last = (at + n - 1) / q;
            }
            sum_visits<W>(g, runs, a, e, y, s_val, s_wt, cells, stride);
            work += (e - a) * W;
          }
          at += n;
          if (++h == min((u + 1) * kl, lines) && at < v1) {
            u = block_of(s_pre, at);  // past lines without visits
            h = u * kl;
          }
        }
      }
      __syncthreads();  // every share summed
      if (owned >= 0) {
        for (int x = 0; x < g.wx; ++x) {
          float sum = win[x * g.lines + owned];
          for (int i = threadIdx.x + 1; i <= last; ++i) {
            sum += s_part[i * g.wx + x];
          }
          win[x * g.lines + owned] = sum;
        }
        work += (last - threadIdx.x) * g.wx;
      }
    }

    if (counts != nullptr) {  // the same branch in every thread
      unsigned sum = __reduce_add_sync(0xffffffffu, work);
      unsigned most = __reduce_max_sync(0xffffffffu, work);
      if (lane == 0) {
        s_red[warp] = sum;
        s_red[kWarps + warp] = most;
      }
      __syncthreads();
      if (threadIdx.x == 0) {
        sum = most = 0;
        for (int i = 0; i < kWarps; ++i) {
          sum += s_red[i];
          most = max(most, s_red[kWarps + i]);
        }
        atomicAdd(&counts[0], 1ull);
        if (static_cast<unsigned long long>(most) * kThreads > 4ull * sum) {
          atomicAdd(&counts[1], 1ull);
        }
      }
    }

    if (any_spill && threadIdx.x == 0) {
      // envelope cells beyond the live window: no other block of this
      // launch and no live cell of this one reaches them
      for (int p = 0; p < np; ++p) {
        const long long c = c0 + p;
        const float qx = pos[c];
        if (!(qx < kSentinelMin)) continue;
        float unused[3 * W];
        const Offsets o = stage(g, qx, pos[n_up + c], pos[2 * n_up + c],
                                plane, y0, zoff, unused);
        if (!beyond_live(g, o)) continue;
        const float* wt = s_wt + 3 * W * p;
        for (int a = 0; a < W && o.dx + a < g.wx; ++a) {
          for (int oy = 0; oy < W; ++oy) {
            const int ya = o.yl + oy;
            if (ya < 0 || ya >= g.wy_pad) continue;
            for (int oz = 0; oz < W; ++oz) {
              int za = o.zl + oz;
              bool live_z = true;
              if (g.nbz == 1) {
                if (za >= g.m) za -= g.m;
              } else {
                if (za < 0 || za >= g.wz_pad) continue;
                live_z = za < g.wz;
              }
              if (ya < g.wy && live_z) continue;  // summed in the window
              const long long gi =
                  (static_cast<long long>(plane + o.dx + a) * g.gy + y0 +
                   ya) * g.gz + zoff + za;
              gp[gi] += (wt[a] * wt[W + oy]) * wt[2 * W + oz];
            }
          }
        }
      }
    }
  }
  __syncthreads();
  // this launch's windows are disjoint: a plain read-modify-write is safe
  for (int r = warp; r < rows; r += kWarps) {
    const int xa = r / g.wy, ya = r - xa * g.wy;
    float* row = gp + (static_cast<long long>(plane + xa) * g.gy + y0 + ya) *
                          g.gz + zoff;
    const float* src = win + r * g.wz;
    for (int z = lane; z < g.wz; z += 32) row[z] += src[z];
  }
}

// The launches of one call: one a residue class of tiles.
template <int W>
int launch(const float* pos, long long n_up, const int* starts, float* gp,
           const DepositGeo& g, size_t smem, unsigned long long* counts,
           cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      deposit_tiles<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int sx = g.wx;
  const int sy = (g.wy_pad + kYB - 1) / kYB;
  const int sz = g.nbz == 1 ? 1 : (g.wz_pad + g.zbs - 1) / g.zbs;
  for (int rx = 0; rx < sx; ++rx) {
    for (int ry = 0; ry < sy; ++ry) {
      for (int rz = 0; rz < sz; ++rz) {
        const int ncx = rx < g.n_planes ? (g.n_planes - rx + sx - 1) / sx : 0;
        const int ncy = ry < g.nby ? (g.nby - ry + sy - 1) / sy : 0;
        const int ncz = rz < g.nbz ? (g.nbz - rz + sz - 1) / sz : 0;
        const int nblocks = ncx * ncy * ncz;
        if (nblocks == 0) continue;
        deposit_tiles<W><<<nblocks, kThreads, smem, s>>>(
            pos, n_up, starts, gp, g, rx, ry, rz, sx, sy, sz, ncy, ncz,
            counts);
        err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
      }
    }
  }
  return 0;
}

}  // namespace

// Shared memory of a deposit block in bytes (as tiled_pm._deposit_smem
// reckons it).
extern "C" long long pysco_deposit_smem(int m, int w, int drift, int wy_pad,
                                        int wz, int zbs, int nbz) {
  return static_cast<long long>(
      smem_bytes(make_geo(m, w, drift, wy_pad, wz, zbs, nbz)));
}

// Deposit the tile-sorted column particles pos (4, n_up) of the x-slab of
// n_planes planes from global plane plane0 on (the whole grid: m and 0) into
// the zeroed padded grid gp (n_planes + wx - 1, m + wy_pad - 8, gz): index i
// holds grid plane plane0 + i - drift along x, grid index i - drift along y
// (and z when z-blocked, nbz > 1; gz = m + wz - zbs), the full periodic z
// line otherwise (gz = wz = m). starts holds the slab's
// n_planes * (m / 8) * nbz + 1 tile starts. wy_pad and wz are the padded
// window's y and z extents. counts, when not null, gains the chunks summed
// and those in which a thread's adds exceeded 4 times the mean
// (counts[0], counts[1]). Returns the CUDA error of the launches (0 on
// success), cudaErrorInvalidValue for a slab outside the grid, a window
// beyond a block's shared memory or bin keys beyond 16 bits.
extern "C" int pysco_deposit(const float* pos, long long n_up,
                             const int* starts, float* gp, int m, int w,
                             int drift, int wy_pad, int wz, int zbs, int nbz,
                             int n_planes, int plane0,
                             unsigned long long* counts, void* stream) {
  const DepositGeo g =
      make_geo(m, w, drift, wy_pad, wz, zbs, nbz, n_planes, plane0);
  const size_t smem = smem_bytes(g);
  if (smem > static_cast<size_t>(kSmemLimit) || g.key_bits > kMaxKeyBits ||
      g.nyb > 32 || g.nzb > 8192 || n_planes < 1 || plane0 < 0 || plane0 + n_planes > m) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (w) {
    case 1:
      return launch<1>(pos, n_up, starts, gp, g, smem, counts, s);
    case 2:
      return launch<2>(pos, n_up, starts, gp, g, smem, counts, s);
    case 3:
      return launch<3>(pos, n_up, starts, gp, g, smem, counts, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
