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
// What bounds it on the card: neither bytes nor float32 operations (0.08 ms
// at 256^3 CIC) but the block's own steps. Per chunk of 512 particles a
// block stages their weights in shared memory, sorts them, finds the bins
// and walks them; per tile it zeroes its window and adds it into the
// padded grid. The design:
//
// - Determinism without atomics. Each thread owns whole z columns of the
//   window and sums every cell of its columns itself, so every cell's sum
//   has one fixed order: chunks in order, then the bins of window z offset
//   zl = z, z - 1, ..., z - w + 1 (periodic when the tile spans the z line),
//   then the particles of a bin in their order in the tile.
// - A scan of only the particles that touch a column. A chunk is ordered by
//   its bin with a stable block radix sort (CUB's BlockRadixSort: ranks from
//   prefix sums in thread order, no atomics), the start of every bin is
//   found by a binary search of the sorted keys, and the thread of column z
//   walks only its w bins: particles x w steps a tile, not particles x 256.
// - The live window only. Shared memory holds (w + 2 drift) x-planes x
//   (8 + w - 1 + 2 drift) y-rows x (the z line, or zbs + w - 1 + 2 drift
//   z-cells), the cells a particle that keeps its drift bound can reach,
//   not the 8- and 128-rounded extents; only those are zeroed and added
//   into the padded grid, a warp to a z run. A particle of the envelope
//   that reaches beyond the live window (it broke its drift bound, or a
//   fresh sort holds it off its tile) adds those cells straight into the
//   padded grid from the block's first thread, in the chunk's order.
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

#include <cub/block/block_radix_sort.cuh>

#include "tiled_pm.cuh"

namespace {

using pysco::axis_weights;
using pysco::kSentinelMin;
using pysco::kYB;

constexpr int kThreads = 256;
constexpr int kItems = 2;                  // particles a thread sorts
constexpr int kChunk = kThreads * kItems;  // particles staged per pass
constexpr int kSortScratch = 12288;        // bytes kept for the block sort
constexpr int kNoParticle = -(1 << 29);    // z offset that matches no column
constexpr int kSmemLimit = 232448;         // a block's dynamic opt-in

using BlockSort = cub::BlockRadixSort<unsigned, kThreads, kItems, int>;
static_assert(sizeof(BlockSort::TempStorage) <= kSortScratch,
              "the block sort needs more scratch: raise kSortScratch here "
              "and _DEPOSIT_SORT_SCRATCH in ops/tiled_pm.py");

struct DepositGeo {
  int m, w, drift, wx, wy_pad, wz_pad, zbs, nbz, nby, gy, gz;
  int n_planes, plane0;  // the slab's planes, and the global plane of its first
  int wy, wz;    // the live window's y and z extents
  int nbins;     // z bins: key zl + w - 1 for zl in [1 - w, wz); nbins = none
  int key_bits;  // bits of nbins
  int scratch;   // bytes of the sort scratch / key and bin-start arrays
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
  g.nbins = g.wz + w - 1;
  g.key_bits = 32 - __builtin_clz(static_cast<unsigned>(g.nbins));
  const int arrays = 4 * (kChunk + g.nbins + 1);
  g.scratch = ((kSortScratch > arrays ? kSortScratch : arrays) + 15) / 16 * 16;
  return g;
}

// Dynamic shared memory of a block: the scratch, the live window, and per
// staged particle dx, yl, zl, its sorted slot and 3 w weights.
size_t smem_bytes(const DepositGeo& g) {
  return static_cast<size_t>(g.scratch) +
         4 * static_cast<size_t>(g.wx) * g.wy * g.wz +
         4 * static_cast<size_t>(kChunk) * (4 + 3 * g.w);
}

// Offset of a base cell from its tile's first cell under a stale sort:
// the modular offset mapped to [-drift, m - drift), plus drift.
__device__ __forceinline__ int window_offset(int base, int origin, int m,
                                             int drift) {
  const int raw = (base - origin + 2 * m) % m;
  return (raw >= m - drift ? raw - m : raw) + drift;
}

__device__ __forceinline__ unsigned bin_key(const DepositGeo& g, int zl) {
  return (zl > -g.w && zl < g.wz) ? static_cast<unsigned>(zl + g.w - 1)
                                  : static_cast<unsigned>(g.nbins);
}

// Whether a staged particle may have cells in the envelope beyond the live
// window (the spill path checks each cell).
__device__ __forceinline__ bool beyond_live(const DepositGeo& g, int dx,
                                            int yl, int zl) {
  if (zl == kNoParticle || dx >= g.wx) return false;
  const bool y = yl + g.w > g.wy && yl < g.wy_pad;
  const bool z = g.nbz > 1 && zl + g.w > g.wz && zl < g.wz_pad;
  return y || z;
}

__global__ void __launch_bounds__(kThreads)
deposit_tiles(const float* __restrict__ pos, long long n_up,
              const int* __restrict__ starts, float* __restrict__ gp,
              DepositGeo g, int rx, int ry, int rz, int sx, int sy, int sz,
              int ncy, int ncz) {
  const int b = blockIdx.x;
  const int plane = rx + sx * (b / (ncy * ncz));  // slab-local
  const int yb = ry + sy * ((b / ncz) % ncy);
  const int zb = rz + sz * (b % ncz);
  const int t = (plane * g.nby + yb) * g.nbz + zb;
  const int start = starts[t], end = starts[t + 1];
  if (end <= start) return;

  extern __shared__ __align__(16) unsigned char smem[];
  auto& sort_tmp = *reinterpret_cast<BlockSort::TempStorage*>(smem);
  unsigned* s_key = reinterpret_cast<unsigned*>(smem);  // after the sort
  int* s_start = reinterpret_cast<int*>(s_key + kChunk);
  float* win = reinterpret_cast<float*>(smem + g.scratch);
  const int rows = g.wx * g.wy;
  int* s_dx = reinterpret_cast<int*>(win + rows * g.wz);
  int* s_yl = s_dx + kChunk;
  int* s_zl = s_yl + kChunk;
  int* s_ord = s_zl + kChunk;
  float* s_wt = reinterpret_cast<float*>(s_ord + kChunk);  // 3 w a particle
  const int nw = 3 * g.w;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int kWarps = kThreads / 32;
  const int y0 = yb * kYB;
  const int zoff = g.nbz == 1 ? 0 : zb * g.zbs;

  for (int r = warp; r < rows; r += kWarps) {
    for (int z = lane; z < g.wz; z += 32) win[r * g.wz + z] = 0.0f;
  }

  for (int c0 = start; c0 < end; c0 += kChunk) {
    const int np = min(kChunk, end - c0);
    __syncthreads();  // window zeroed / previous chunk consumed
    bool spill = false;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int slot = threadIdx.x + j * kThreads;
      int dx = 0, yl = 0, zl = kNoParticle;
      if (slot < np) {
        const long long c = c0 + slot;
        const float px = pos[c];
        if (px < kSentinelMin) {
          float* wt = s_wt + nw * slot;
          const float fm = static_cast<float>(g.m);
          const int bx = axis_weights(g.w, px * fm, wt);
          const int by = axis_weights(g.w, pos[n_up + c] * fm, wt + g.w);
          const int bz =
              axis_weights(g.w, pos[2 * n_up + c] * fm, wt + 2 * g.w);
          const int zw = bz < 0 ? bz + g.m : bz;
          if (g.drift) {
            dx = window_offset(bx, plane + g.plane0, g.m, g.drift);
            yl = window_offset(by, y0, g.m, g.drift);
          } else {  // fresh sort: the base plane is the tile's
            yl = (by < 0 ? by + g.m : by) - y0;
          }
          if (g.nbz == 1) {
            zl = zw;
          } else {
            zl = g.drift ? window_offset(zw, zoff, g.m, g.drift) : zw - zoff;
          }
          spill = spill || beyond_live(g, dx, yl, zl);
        }
      }
      s_dx[slot] = dx;
      s_yl[slot] = yl;
      s_zl[slot] = zl;
    }
    const bool any_spill = __syncthreads_or(spill);

    // stable sort of the chunk by bin; thread t holds slots t kItems + j
    unsigned keys[kItems];
    int vals[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int slot = threadIdx.x * kItems + j;
      keys[j] = bin_key(g, s_zl[slot]);
      vals[j] = slot;
    }
    BlockSort(sort_tmp).Sort(keys, vals, 0, g.key_bits);
    __syncthreads();  // the sort scratch becomes s_key and s_start
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      s_key[threadIdx.x * kItems + j] = keys[j];
      s_ord[threadIdx.x * kItems + j] = vals[j];
    }
    __syncthreads();
    for (int bin = threadIdx.x; bin <= g.nbins; bin += kThreads) {
      int lo = 0, hi = kChunk;  // first sorted slot with key >= bin
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (s_key[mid] < static_cast<unsigned>(bin)) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      s_start[bin] = lo;
    }
    __syncthreads();

    for (int z = threadIdx.x; z < g.wz; z += kThreads) {
      for (int oz = 0; oz < g.w; ++oz) {
        int zl = z - oz;
        if (g.nbz == 1 && zl < 0) zl += g.m;  // the window is the z line
        const int key = zl + g.w - 1;
        const int s_end = s_start[key + 1];
        for (int s = s_start[key]; s < s_end; ++s) {
          const int p = s_ord[s];
          const float* wt = s_wt + nw * p;
          const float wzv = wt[2 * g.w + oz];
          const int dx = s_dx[p], yl = s_yl[p];
          for (int a = 0; a < g.w && dx + a < g.wx; ++a) {
            const float wxa = wt[a];
            for (int oy = 0; oy < g.w; ++oy) {
              const int ya = yl + oy;
              if (ya < 0 || ya >= g.wy) continue;
              win[((dx + a) * g.wy + ya) * g.wz + z] +=
                  (wxa * wt[g.w + oy]) * wzv;
            }
          }
        }
      }
    }

    if (any_spill && threadIdx.x == 0) {
      // envelope cells beyond the live window: no other block of this
      // launch and no live cell of this one reaches them
      for (int p = 0; p < np; ++p) {
        const int dx = s_dx[p], yl = s_yl[p], zl = s_zl[p];
        if (!beyond_live(g, dx, yl, zl)) continue;
        const float* wt = s_wt + nw * p;
        for (int a = 0; a < g.w && dx + a < g.wx; ++a) {
          for (int oy = 0; oy < g.w; ++oy) {
            const int ya = yl + oy;
            if (ya < 0 || ya >= g.wy_pad) continue;
            for (int oz = 0; oz < g.w; ++oz) {
              int za = zl + oz;
              bool live_z = true;
              if (g.nbz == 1) {
                if (za >= g.m) za -= g.m;
              } else {
                if (za < 0 || za >= g.wz_pad) continue;
                live_z = za < g.wz;
              }
              if (ya < g.wy && live_z) continue;  // summed in the window
              const long long gi =
                  (static_cast<long long>(plane + dx + a) * g.gy + y0 + ya) *
                      g.gz + zoff + za;
              gp[gi] += (wt[a] * wt[g.w + oy]) * wt[2 * g.w + oz];
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
// window's y and z extents. Returns the CUDA error of the launches (0 on
// success), cudaErrorInvalidValue for a slab outside the grid or a window
// beyond a block's shared memory.
extern "C" int pysco_deposit(const float* pos, long long n_up,
                             const int* starts, float* gp, int m, int w,
                             int drift, int wy_pad, int wz, int zbs, int nbz,
                             int n_planes, int plane0, void* stream) {
  const DepositGeo g =
      make_geo(m, w, drift, wy_pad, wz, zbs, nbz, n_planes, plane0);
  const size_t smem = smem_bytes(g);
  if (smem > static_cast<size_t>(kSmemLimit) || n_planes < 1 || plane0 < 0 ||
      plane0 + n_planes > m) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      deposit_tiles, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int sx = g.wx;
  const int sy = (wy_pad + kYB - 1) / kYB;
  const int sz = nbz == 1 ? 1 : (wz + zbs - 1) / zbs;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int rx = 0; rx < sx; ++rx) {
    for (int ry = 0; ry < sy; ++ry) {
      for (int rz = 0; rz < sz; ++rz) {
        const int ncx = rx < n_planes ? (n_planes - rx + sx - 1) / sx : 0;
        const int ncy = ry < g.nby ? (g.nby - ry + sy - 1) / sy : 0;
        const int ncz = rz < nbz ? (nbz - rz + sz - 1) / sz : 0;
        const int nblocks = ncx * ncy * ncz;
        if (nblocks == 0) continue;
        deposit_tiles<<<nblocks, kThreads, smem, s>>>(
            pos, n_up, starts, gp, g, rx, ry, rz, sx, sy, sz, ncy, ncz);
        err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
      }
    }
  }
  return 0;
}
