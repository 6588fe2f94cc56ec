// Force interpolation (NGP/CIC/TSC) at tile-sorted columns, for Hopper,
// sm_90a.
//
// Replaces pysco_tpu/ops/pallas_pm.py::_gather_kernel, which DMAs each
// tile's field window into VMEM (double-buffering the next tile's window
// while the current one computes), contracts it with one-hot weights on
// the MXU and merges chunks that straddle two tiles back into HBM. Tiles
// are the sort's: an x-plane, an 8-row y-block and, from 512^3 up, a
// 128-cell z-block; tile t owns columns [starts[t], starts[t+1]). The
// straddle merge was a TPU artefact and has no counterpart.
//
// What bounds it on the card: bytes. A call must read the three position
// rows and the field and write the four output rows: at 256^3 CIC with 3
// components that is >= 0.18 ms at 3.35 TB/s (rows 0-2 counted), and the
// float32 operations (~80 a column) take a tenth of that. A kernel with one
// thread a column that reads its w^3 x C values straight from the field
// (24 scattered 4-byte loads for CIC with 3 components, 81 for TSC) is held
// back by the load/store units and their latency, not by DRAM: within a
// tile the columns keep their pre-sort order, so a warp's loads hit up to
// 32 sectors each (0.80 ms at 256^3 CIC on an H100).
//
// The design:
//
// - The live window in shared memory. A block marches one (y, z) column of
//   tiles along x over a run of x-planes. It holds the tile's window --
//   (w + 2 drift) x-planes x (8 + w - 1 + 2 drift) y-rows x (the periodic z
//   line, or zbs + w - 1 + 2 drift z-cells), the cells a particle that keeps
//   its drift bound reaches (tiled_pm.Geometry.live_window, the extent the
//   deposit keeps) -- as a ring of x-planes: from one tile to the next the
//   plane that left the window is replaced by the one that entered it, so
//   each plane of the column is read once per run, not w + 2 drift times.
//   The copies are 16-byte cp.async of aligned 4-cell groups (m is a
//   multiple of 8, so a group never straddles the periodic edge), all in
//   flight at once, wrapping in x, y and z; the z line repeats its first
//   group after its end, so a support never wraps in shared memory.
// - All components at once when their windows fit a block's shared
//   memory (tiled_pm._gather_stage), else one component per pass over the
//   run: one block an SM staging all three beat several staging one each
//   on an H100 (chip_smoke.py times both). A template instance per component count and support
//   width keeps a cell's reads to one shared load, one product and one sum
//   per component. A component is a sum of its own, so passes change no
//   bit.
// - Latency. The columns' positions stream through registers one batch
//   ahead, across tile ends, and the tile starts one tile ahead, so each
//   tile's barrier and plane copy overlap loads in flight. Staging the next
//   plane ahead of the tile (a spare ring slot, as the TPU kernel's double
//   buffer) did not pay on an H100: the other block on the SM hides the
//   copy, and the larger ring costs resident blocks.
// - A column whose support leaves the window (it broke its drift bound, or
//   its tile is not its own) reads those values from device memory, with
//   periodic wrap: the same floats, so the same sum. Beyond the window the
//   TPU kernel returns 0 (or a partial sum) while this one still
//   interpolates at the particle's position; the run aborts on such a step
//   all the same, because tiled_pm.drift_violations counts the particle.
// - The twin's order (tiled_pm.gather_vec_cl_plain): for a, then oy, then
//   oz, acc[c] += field * ((wx[a] * wy[oy]) * wz[oz]). Built with
//   --fmad=false, the kernel is bitwise equal to its twin.
// - Columns outside every tile (the sentinel tail, x >= 1.5) return 0, and
//   rows C..3 of the output are 0; a few blocks past the marching ones
//   write the columns before the first tile and after the last.
// - One kernel, two x modes. Over the periodic field (C, m, m, m) a window's
//   planes wrap in x. Over a slab (pallas_pm.gather_vec_slab) the field is
//   the slab's n_planes planes extended by drift planes of the left
//   neighbour and w - 1 + drift of the right, (C, n_planes + wx - 1, m, m):
//   slot k of local plane p is extended plane p + k, nothing wraps in x, and
//   a column of tiles does not close on itself, so the first wx planes of a
//   run are its prologue in both modes. y and z wrap in both. A support
//   cell beyond the extended field (a particle past its drift bound in x)
//   counts 0, as the twin's (tiled_pm.gather_vec_slab_plain).

#include "tiled_pm.cuh"

namespace {

using pysco::axis_weights;
using pysco::kSentinelMin;
using pysco::kYB;
using pysco::wrap;

constexpr int kThreads = 512;
constexpr int kBatch = 2;           // columns a thread has in flight
constexpr int kVec = 4;             // z cells of a 16-byte group
constexpr int kTailBlocks = 8;      // blocks that zero the columns off tiles
constexpr int kSmemLimit = 232448;  // a block's dynamic opt-in
constexpr int kWaves = 2;           // blocks per resident slot of the card

struct GatherGeo {
  int m, w, drift, nby, nbz, zbs, ntiles;
  int n_planes;    // x-planes of tiles: m, or the slab's
  int plane0;      // global plane of the first (0 over the periodic field)
  int slab;        // 1: the field is a slab's x-extended planes, not periodic
  int nx;          // x-planes the field holds: m, or n_planes + wx - 1
  int wx, wy, wz;  // the live window's extents
  int wzs;         // z stride of a staged row: whole 16-byte groups
  int ncomp;       // field components
  int ncs;         // components staged a pass
  int run, nruns;  // x-planes a block marches, and runs per column
};

GatherGeo make_geo(int m, int w, int drift, int zbs, int nbz, int ncomp,
                   int ncs, int n_planes = -1, int plane0 = 0, int slab = 0) {
  GatherGeo g{};
  g.n_planes = n_planes < 0 ? m : n_planes;
  g.plane0 = plane0;
  g.slab = slab;
  g.nx = slab ? g.n_planes + w + 2 * drift - 1 : m;
  g.m = m;
  g.w = w;
  g.drift = drift;
  g.nby = m / kYB;
  g.nbz = nbz;
  g.zbs = zbs;
  g.ntiles = g.n_planes * g.nby * nbz;
  g.wx = w + 2 * drift;
  g.wy = kYB + g.wx - 1;
  g.wz = nbz == 1 ? m : zbs + g.wx - 1;
  // the z line repeats its first group after its end, so a support never
  // wraps; a z-blocked window starts anywhere in a 16-byte group: room for
  // the 3 cells before it
  g.wzs = nbz == 1 ? m + kVec : (g.wz + 3 + kVec - 1) / kVec * kVec;
  g.ncomp = ncomp;
  g.ncs = ncs;
  return g;
}

// Dynamic shared memory of a block: the ring of the window's wx x-planes,
// each ncs components x wy rows x wzs cells.
size_t smem_bytes(const GatherGeo& g) {
  return 4 * static_cast<size_t>(g.wx) * g.ncs * g.wy * g.wzs;
}

// Runs of x-planes a (y, z) column is cut into: about kWaves blocks for
// every block the card holds at once (sms SMs of smem_sm bytes of shared
// memory, reserved of it kept for each block).
void set_runs(GatherGeo& g, int sms, int smem_sm, int reserved) {
  const size_t smem = smem_bytes(g);
  int per_sm = 2048 / kThreads;
  const int by_smem = static_cast<int>(smem_sm / (smem + reserved));
  if (by_smem < per_sm) per_sm = by_smem > 0 ? by_smem : 1;
  const int columns = g.nby * g.nbz;
  const int want = (kWaves * sms * per_sm + columns - 1) / columns;
  const int np = g.n_planes;
  g.nruns = want < 1 ? 1 : (want > np ? np : want);
  g.run = (np + g.nruns - 1) / g.nruns;
  g.nruns = (np + g.run - 1) / g.run;
}

__device__ __forceinline__ int pmod(int i, int m) {
  const int r = i % m;
  return r < 0 ? r + m : r;
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until this thread's copies have landed.
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Offset of a base cell from its slab's first plane under a stale sort: the
// modular offset mapped to [-drift, m - drift), plus drift (its extended
// plane; tiled_pm._window_offset).
__device__ __forceinline__ int window_offset(int base, int origin, int m,
                                             int drift) {
  const int raw = pmod(base - origin, m);
  return (raw >= m - drift ? raw - m : raw) + drift;
}

// Plane of the field that holds slot k of the window of local plane p: over
// the periodic field plane p - drift + k, wrapped; over a slab extended
// plane p + k.
__device__ __forceinline__ int field_plane(const GatherGeo& g, int p, int k) {
  return g.slab ? p + k : pmod(p - g.drift + k, g.m);
}

// Start copying components [c0, c0 + ncs) of the field's x-plane xf of the
// window whose first (y, z) cell is (y0, z0) into ring
// slot `slot`: row (c, ya) at ((slot * ncs + c) * wy + ya) * wzs, window z
// offset zl at zl + (z0 - za), za the first 16-byte group's first cell.
__device__ __forceinline__ void stage_plane(const float* __restrict__ field,
                                            float* win, const GatherGeo& g,
                                            int c0, int xf, int slot, int y0,
                                            int z0) {
  const long long vol = static_cast<long long>(g.nx) * g.m * g.m;
  const int za = z0 - pmod(z0, kVec);
  const int ngroups = g.wzs / kVec;
  const int rows = g.ncs * g.wy;
  const float* plane =
      field + c0 * vol + static_cast<long long>(xf) * g.m * g.m;
  float* dst0 = win + slot * g.ncs * g.wy * g.wzs;
  for (int idx = threadIdx.x; idx < rows * ngroups; idx += kThreads) {
    const int row = idx / ngroups;
    const int gi = idx - row * ngroups;
    const int c = row / g.wy;
    const int ya = row - c * g.wy;
    const float* src = plane + c * vol +
                       static_cast<long long>(pmod(y0 + ya, g.m)) * g.m +
                       pmod(za + kVec * gi, g.m);
    cp_async16(dst0 + row * g.wzs + kVec * gi, src);
  }
}

// Zero the columns before the first tile and after the last (block tb of
// kTailBlocks).
__device__ void zero_tail(const int* __restrict__ starts, float* out,
                          long long n_up, int ntiles, int tb) {
  const long long lo = starts[0], hi = starts[ntiles];
  const long long stride = static_cast<long long>(kTailBlocks) * kThreads;
  const long long first = static_cast<long long>(tb) * kThreads + threadIdx.x;
  for (long long i = first; i < lo; i += stride) {
#pragma unroll
    for (int c = 0; c < 4; ++c) out[c * n_up + i] = 0.0f;
  }
  for (long long i = hi + first; i < n_up; i += stride) {
#pragma unroll
    for (int c = 0; c < 4; ++c) out[c * n_up + i] = 0.0f;
  }
}

// Positions of the columns a thread sums next: kBatch columns, kThreads
// apart, from first on (x = 2, the sentinel, past the tile's end).
struct Batch {
  float x[kBatch], y[kBatch], z[kBatch];
};

__device__ __forceinline__ void load_batch(Batch& bt,
                                           const float* __restrict__ pos,
                                           long long n_up, int first,
                                           int end) {
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    const int i = first + threadIdx.x + u * kThreads;
    bt.x[u] = i < end ? pos[i] : 2.0f;
    bt.y[u] = i < end ? pos[n_up + i] : 0.0f;
    bt.z[u] = i < end ? pos[2 * n_up + i] : 0.0f;
  }
}

// One batch of a tile's columns against the ring, components
// [c0, c0 + NC): x0, y0, z0 the window's first cell, lead the offset of its
// z cells in a staged row, sbase the ring slot of its first x-plane.
template <int W, int NC>
__device__ __forceinline__ void gather_batch(
    const float* __restrict__ field, const Batch& bt, long long n_up,
    float* __restrict__ out, const float* win, const GatherGeo& g, int first,
    int end, int c0, int x0, int y0, int z0, int lead, int sbase) {
  const long long vol = static_cast<long long>(g.nx) * g.m * g.m;
  const float fm = static_cast<float>(g.m);
  const int cstride = g.wy * g.wzs;
  const int sstride = g.ncs * cstride;
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    const int i = first + threadIdx.x + u * kThreads;
    if (i >= end) break;
    float acc[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[c] = 0.0f;
    if (bt.x[u] < kSentinelMin) {
      float wx[3], wy[3], wz[3];
      const int bx = axis_weights(W, bt.x[u] * fm, wx);
      const int by = axis_weights(W, bt.y[u] * fm, wy);
      const int bz = axis_weights(W, bt.z[u] * fm, wz);
      // offsets from the window's first cell; the window cell at offset o
      // holds the field at (first + o) mod m, so any offset congruent to
      // base - first serves
      const int ox = wrap(bx - x0, g.m), oy = wrap(by - y0, g.m);
      const int oz = wrap(bz - z0, g.m);
      const bool inside =
          ox >= 0 && ox + W <= g.wx && oy >= 0 && oy + W <= g.wy &&
          oz >= 0 && (g.nbz == 1 ? oz < g.m : oz + W <= g.wz);
      if (inside) {
#pragma unroll
        for (int a = 0; a < W; ++a) {
          int s = sbase + ox + a;
          if (s >= g.wx) s -= g.wx;
#pragma unroll
          for (int b = 0; b < W; ++b) {
            const float wxy = wx[a] * wy[b];
            // the support's first z cell; the padded z line needs no wrap
            const float* row =
                win + s * sstride + (oy + b) * g.wzs + lead + oz;
#pragma unroll
            for (int k = 0; k < W; ++k) {
              const float wt = wxy * wz[k];
#pragma unroll
              for (int c = 0; c < NC; ++c) {
                acc[c] += row[c * cstride + k] * wt;
              }
            }
          }
        }
      } else {
        const int ex = g.slab ? window_offset(bx, g.plane0, g.m, g.drift) : 0;
        for (int a = 0; a < W; ++a) {
          const int ix = g.slab ? ex + a : pmod(bx + a, g.m);
          const bool held = ix < g.nx;  // always, over the periodic field
          for (int b = 0; b < W; ++b) {
            const long long row =
                (static_cast<long long>(ix) * g.m + pmod(by + b, g.m)) * g.m;
            const float wxy = wx[a] * wy[b];
            for (int k = 0; k < W; ++k) {
              const long long cell = row + pmod(bz + k, g.m);
              const float wt = wxy * wz[k];
#pragma unroll
              for (int c = 0; c < NC; ++c) {
                acc[c] += (held ? field[(c0 + c) * vol + cell] : 0.0f) * wt;
              }
            }
          }
        }
      }
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) out[(c0 + c) * n_up + i] = acc[c];
    if (c0 == 0) {
      for (int c = g.ncomp; c < 4; ++c) out[c * n_up + i] = 0.0f;
    }
  }
}

// A block marches one (y, z) column of tiles along x over a run of planes,
// keeping the window's planes in a ring in shared memory: from one tile to
// the next one plane enters the ring in place of the one that left the
// window, so each plane of the column is copied once per run. The columns'
// positions stream through registers a batch ahead, across tile ends.
template <int W, int NC>
__global__ void __launch_bounds__(kThreads, 2)
gather_march(const float* __restrict__ field, const float* __restrict__ pos,
             long long n_up, const int* __restrict__ starts,
             float* __restrict__ out, GatherGeo g) {
  const int b = blockIdx.x;
  const int nmarch = g.nruns * g.nby * g.nbz;
  if (b >= nmarch) {
    zero_tail(starts, out, n_up, g.ntiles, b - nmarch);
    return;
  }
  extern __shared__ __align__(16) float win[];
  const int zb = b % g.nbz;
  const int yb = (b / g.nbz) % g.nby;
  const int p0 = (b / (g.nbz * g.nby)) * g.run;
  const int p1 = min(p0 + g.run, g.n_planes);
  const int y0 = yb * kYB - g.drift;
  const int z0 = g.nbz == 1 ? 0 : zb * g.zbs - g.drift;
  const int lead = pmod(z0, kVec);
  const int tstep = g.nby * g.nbz;  // tiles from one x-plane to the next
  const int t0 = (p0 * g.nby + yb) * g.nbz + zb;
  constexpr int kStep = kThreads * kBatch;

  for (int c0 = 0; c0 < g.ncomp; c0 += NC) {
    if (c0) __syncthreads();  // every read of the previous pass done
    // the first tile's planes
    for (int k = 0; k < g.wx; ++k) {
      stage_plane(field, win, g, c0, field_plane(g, p0, k), k, y0, z0);
    }
    cp_async_commit();
    int start = starts[t0], end = starts[t0 + 1];
    int nstart = 0, nend = 0;  // the next tile's columns
    if (p0 + 1 < p1) {
      nstart = starts[t0 + tstep];
      nend = starts[t0 + tstep + 1];
    }
    Batch cur;
    load_batch(cur, pos, n_up, start, end);
    cp_async_wait();
    __syncthreads();
    int p = p0, first = start;
    for (;;) {
      // the batch after this one, in this tile or the next
      const bool same = first + kStep < end;
      Batch nxt;
      if (same) {
        load_batch(nxt, pos, n_up, first + kStep, end);
      } else if (p + 1 < p1) {
        load_batch(nxt, pos, n_up, nstart, nend);
      }
      gather_batch<W, NC>(field, cur, n_up, out, win, g, first, end, c0,
                          p + g.plane0 - g.drift, y0, z0, lead,
                          (p - p0) % g.wx);
      if (same) {
        cur = nxt;
        first += kStep;
        continue;
      }
      if (p + 1 >= p1) break;
      __syncthreads();  // every read of plane p - drift done: slot free
      // the last plane of tile p + 1, whose positions stream in meanwhile
      stage_plane(field, win, g, c0, field_plane(g, p, g.wx),
                  (p - p0) % g.wx, y0, z0);
      cp_async_commit();
      ++p;
      start = nstart;
      end = nend;
      first = start;
      cur = nxt;
      if (p + 1 < p1) {
        const int t = t0 + (p + 1 - p0) * tstep;
        nstart = starts[t];
        nend = starts[t + 1];
      }
      cp_async_wait();  // tile p's planes landed
      __syncthreads();
    }
  }
}

template <int W, int NC>
int launch(const float* field, const float* pos, long long n_up,
           const int* starts, float* out, const GatherGeo& g,
           cudaStream_t st) {
  const size_t smem = smem_bytes(g);
  cudaError_t err = cudaFuncSetAttribute(
      gather_march<W, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = g.nruns * g.nby * g.nbz + kTailBlocks;
  gather_march<W, NC><<<blocks, kThreads, smem, st>>>(field, pos, n_up,
                                                     starts, out, g);
  return static_cast<int>(cudaGetLastError());
}

template <int W>
int launch_w(const float* field, const float* pos, long long n_up,
             const int* starts, float* out, const GatherGeo& g,
             cudaStream_t st) {
  switch (g.ncs) {
    case 1: return launch<W, 1>(field, pos, n_up, starts, out, g, st);
    case 2: return launch<W, 2>(field, pos, n_up, starts, out, g, st);
    case 3: return launch<W, 3>(field, pos, n_up, starts, out, g, st);
    default: return launch<W, 4>(field, pos, n_up, starts, out, g, st);
  }
}

}  // namespace

// Shared memory of a gather block in bytes, staging ncs components (as
// tiled_pm._gather_smem reckons it).
extern "C" long long pysco_gather_smem(int m, int w, int drift, int zbs,
                                       int nbz, int ncs) {
  return static_cast<long long>(
      smem_bytes(make_geo(m, w, drift, zbs, nbz, ncs, ncs)));
}

// Interpolate field (ncomp <= 4 components; 16-byte aligned) at the columns
// of pos (4, n_up), tile-sorted into ntiles = n_planes * (m / 8) * nbz tiles
// of z-block size zbs, into out (4, n_up); drift widens the staged windows
// for a stale sort; ncs (1 or ncomp) components are staged a pass. With
// slab = 0 the field is the periodic (ncomp, m, m, m) grid (n_planes = m,
// plane0 = 0); with slab = 1 it is (ncomp, n_planes + w - 1 + 2 drift, m, m),
// extended plane i holding grid plane plane0 + i - drift. Returns the
// CUDA error of the launch (0 on success), cudaErrorInvalidValue for
// arguments the kernel does not take or a ring beyond a block's shared
// memory.
extern "C" int pysco_gather(const float* field, int ncomp, const float* pos,
                            long long n_up, const int* starts, int ntiles,
                            float* out, int m, int w, int drift, int zbs,
                            int nbz, int ncs, int n_planes, int plane0,
                            int slab, void* stream) {
  GatherGeo g =
      make_geo(m, w, drift, zbs, nbz, ncomp, ncs, n_planes, plane0, slab);
  if (n_planes < 1 || plane0 < 0 || plane0 + n_planes > m ||
      (!slab && (n_planes != m || plane0 != 0)) ||
      ncomp < 1 || ncomp > 4 || (ncs != 1 && ncs != ncomp) || m % kYB ||
      zbs * nbz != m || ntiles != g.ntiles || w < 1 || w > 3 || drift < 0 ||
      smem_bytes(g) > static_cast<size_t>(kSmemLimit) ||
      reinterpret_cast<size_t>(field) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_up == 0) return 0;
  int dev = 0, sms = 0, smem_sm = 0, reserved = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  set_runs(g, sms, smem_sm, reserved);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w == 1) return launch_w<1>(field, pos, n_up, starts, out, g, st);
  if (w == 2) return launch_w<2>(field, pos, n_up, starts, out, g, st);
  return launch_w<3>(field, pos, n_up, starts, out, g, st);
}
