// y + the trilinear prolongation of a coarse grid, for Hopper, sm_90a.
//
// Replaces pysco_tpu/ops/pallas_stencil.py::add_prolongation, which streams
// coarse plane blocks with periodic halo planes through VMEM and, for each
// coarse plane, computes the x-blend of the (even, odd) fine planes once
// before expanding y and z as matrix products on the MXU. Along each axis
// the fine index 2r takes 3/4 of coarse cell r and 1/4 of r - 1, the index
// 2r + 1 3/4 of r and 1/4 of r + 1 (periodic). The axes are applied in the
// order x, y, z, as mesh._prolong_axis does in the twin: x-blends of the
// coarse (y, z) cells, then y-blends of those, then a z-blend, each
// 0.75 a + 0.25 b with its own roundings (--fmad=false). A blend computed
// once and shared is the same float as one recomputed, so both kernels
// here are bitwise equal to the twin.
//
// What bounds it on the card: bytes. A fine cell must read y and write the
// sum (8 B), and the coarse grid adds an eighth of a read: at 256^3 a call
// moves 142 MB, >= 0.043 ms at 3.35 TB/s. With one fine cell a thread
// (the kernel below that takes the other grids) each cell does an integer
// division of its flat index (n is a runtime value), eight coarse loads
// through L1 and seven blends that the eight fine cells sharing them all
// recompute, with scalar loads and stores: 0.119 ms at 256^3 on an H100.
//
// The plane march (n a multiple of 4, y and out 16-byte aligned): a block
// owns a tile of 4 coarse rows x 64 coarse z cells (8 fine rows x 128 fine
// z cells) and marches along x over a run of coarse planes. Each thread
// carries up to two cells of the tile with its one-cell periodic halo in y
// and z (6 x 66 coarse cells) through the planes r - 1, r, r + 1 in
// registers, the loads of plane r + 2 issued a plane ahead. For each
// coarse plane it writes the x-blends of both fine planes 2r and 2r + 1
// into shared memory once (double-buffered: one barrier a plane). A warp
// then takes one fine row: each lane computes the two y-blends at its own
// coarse z cells and takes its neighbours' by shuffle (the warp's end lanes
// compute theirs), z-blends them into 4 consecutive fine cells and adds y,
// read and written as one float4. A 3-D grid of blocks (z tiles, y tiles,
// runs) with about 1024 blocks; ragged tiles are masked, and the halo is
// loaded with the full periodic wrap, so small grids (n = 4) take it too.
//
// Other grids (n not a multiple of 4, or a misaligned y or out) take one
// thread a fine cell.

#include "stencil.cuh"

namespace {

using pysco::kStencilThreads;
using pysco::periodic;

constexpr int kVec = 4;                     // fine z cells of a thread
constexpr int kLanes = 32;                  // threads along z: a warp a row
constexpr int kRows = 8;                    // fine rows of a tile
constexpr int kThreads = kLanes * kRows;
constexpr int kTileZ = kLanes * kVec / 2;   // coarse z cells of a tile
constexpr int kTileY = kRows / 2;           // coarse rows of a tile
constexpr int kHaloZ = kTileZ + 2;
constexpr int kHaloY = kTileY + 2;
constexpr int kHaloCells = kHaloY * kHaloZ;
constexpr int kOwn = (kHaloCells + kThreads - 1) / kThreads;  // a thread's
constexpr int kTargetBlocks = 1024;

__device__ __forceinline__ float blend(float centre, float side) {
  return 0.75f * centre + 0.25f * side;
}

__device__ __forceinline__ int pmod(int i, int n) {
  const int r = i % n;
  return r < 0 ? r + n : r;
}

__global__ void __launch_bounds__(kStencilThreads)
add_prolongation_cells(const float* __restrict__ y,
                       const float* __restrict__ xc, float* __restrict__ out,
                       int n) {
  const int m = n / 2;
  const int idx = blockIdx.x * kStencilThreads + threadIdx.x;
  if (idx >= n * n * n) return;
  const int k = idx % n;
  const int j = (idx / n) % n;
  const int i = idx / (n * n);
  const int ri = i >> 1, si = periodic(ri + ((i & 1) ? 1 : -1), m);
  const int rj = j >> 1, sj = periodic(rj + ((j & 1) ? 1 : -1), m);
  const int rk = k >> 1, sk = periodic(rk + ((k & 1) ? 1 : -1), m);
  auto x_blend = [&](int cj, int ck) {
    return blend(xc[(ri * m + cj) * m + ck], xc[(si * m + cj) * m + ck]);
  };
  const float y_at_rk = blend(x_blend(rj, rk), x_blend(sj, rk));
  const float y_at_sk = blend(x_blend(rj, sk), x_blend(sj, sk));
  out[idx] = y[idx] + blend(y_at_rk, y_at_sk);
}

__global__ void __launch_bounds__(kThreads)
add_prolongation_march(const float* __restrict__ y,
                       const float* __restrict__ xc, float* __restrict__ out,
                       int n, int run) {
  // x-blends of the tile and its halo: [buffer][fine plane parity][row][z]
  __shared__ float xb[2][2][kHaloY][kHaloZ];
  const int m = n / 2;
  const int mm = m * m;
  const int nn = n * n;
  const int lane = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kLanes + lane;
  const int ck0 = blockIdx.x * kTileZ, cj0 = blockIdx.y * kTileY;
  const int r0 = blockIdx.z * run;
  const int r1 = min(r0 + run, m);

  // the halo-tile cells this thread carries: halo row hy, z hz is coarse
  // ((cj0 - 1 + hy) mod m, (ck0 - 1 + hz) mod m)
  int off[kOwn], hy[kOwn], hz[kOwn];
  bool has[kOwn];
#pragma unroll
  for (int q = 0; q < kOwn; ++q) {
    const int h = tid + q * kThreads;
    has[q] = h < kHaloCells;
    hy[q] = h / kHaloZ;
    hz[q] = h - hy[q] * kHaloZ;
    off[q] = has[q] ? pmod(cj0 - 1 + hy[q], m) * m + pmod(ck0 - 1 + hz[q], m)
                    : 0;
  }
  float prev[kOwn], cur[kOwn], next[kOwn];
  {
    const float* pl_prev = xc + periodic(r0 - 1, m) * mm;
    const float* pl_cur = xc + r0 * mm;
    const float* pl_next = xc + periodic(r0 + 1, m) * mm;
#pragma unroll
    for (int q = 0; q < kOwn; ++q) {
      prev[q] = has[q] ? pl_prev[off[q]] : 0.0f;
      cur[q] = has[q] ? pl_cur[off[q]] : 0.0f;
      next[q] = has[q] ? pl_next[off[q]] : 0.0f;
    }
  }

  // this thread's fine row and first fine z cell, and the halo rows of its
  // row's y-centre and y-side; its coarse z centres sit at halo z c + 1 and
  // c + 2, their outer sides at c and c + 3
  const int jf = 2 * cj0 + ty, kf = 2 * ck0 + kVec * lane;
  const bool own = jf < n && kf < n;
  const int rj = (ty >> 1) + 1;
  const int sj = (ty & 1) ? rj + 1 : rj - 1;
  const int c = 2 * lane;
  constexpr unsigned kFull = 0xffffffffu;

  for (int r = r0; r < r1; ++r) {
    // plane r + 2, for the next step (on a run's last step a plane that is
    // not used: a coarse plane is an eighth of a fine one)
    float ahead[kOwn];
    {
      const float* pl = xc + periodic(r + 2, m) * mm;
#pragma unroll
      for (int q = 0; q < kOwn; ++q) ahead[q] = has[q] ? pl[off[q]] : 0.0f;
    }
    const int at = (2 * r * n + jf) * n + kf;  // fine plane 2r
    float4 yv[2] = {make_float4(0.0f, 0.0f, 0.0f, 0.0f),
                    make_float4(0.0f, 0.0f, 0.0f, 0.0f)};
    if (own) {
      yv[0] = *reinterpret_cast<const float4*>(y + at);
      yv[1] = *reinterpret_cast<const float4*>(y + at + nn);
    }
    float(*buf)[kHaloY][kHaloZ] = xb[r & 1];
#pragma unroll
    for (int q = 0; q < kOwn; ++q) {
      if (has[q]) {
        buf[0][hy[q]][hz[q]] = blend(cur[q], prev[q]);  // fine plane 2r
        buf[1][hy[q]][hz[q]] = blend(cur[q], next[q]);  // 2r + 1
      }
    }
    // buffer r & 1 complete; the other one is free again (its readers
    // passed this barrier)
    __syncthreads();
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const float(*xp)[kHaloZ] = buf[p];
      const float y1 = blend(xp[rj][c + 1], xp[sj][c + 1]);
      const float y2 = blend(xp[rj][c + 2], xp[sj][c + 2]);
      float y0 = __shfl_up_sync(kFull, y2, 1);    // lane - 1's y2: halo c
      float y3 = __shfl_down_sync(kFull, y1, 1);  // lane + 1's y1: c + 3
      if (lane == 0) y0 = blend(xp[rj][c], xp[sj][c]);
      if (lane == kLanes - 1) y3 = blend(xp[rj][c + 3], xp[sj][c + 3]);
      if (own) {
        const float4 v = yv[p];
        float4 o;
        o.x = v.x + blend(y1, y0);
        o.y = v.y + blend(y1, y2);
        o.z = v.z + blend(y2, y1);
        o.w = v.w + blend(y2, y3);
        *reinterpret_cast<float4*>(out + at + p * nn) = o;
      }
    }
#pragma unroll
    for (int q = 0; q < kOwn; ++q) {
      prev[q] = cur[q];
      cur[q] = next[q];
      next[q] = ahead[q];
    }
  }
}

}  // namespace

// out = y + prolongation(xc) for a fine (n, n, n) y and a coarse
// (n/2, n/2, n/2) xc: the plane march for n a multiple of 4 with y and out
// 16-byte aligned, one thread a fine cell otherwise. Returns the CUDA
// error of the launch (0 on success).
extern "C" int pysco_add_prolongation(const float* y, const float* xc,
                                      float* out, int n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool aligned = reinterpret_cast<size_t>(y) % 16 == 0 &&
                       reinterpret_cast<size_t>(out) % 16 == 0;
  if (n % kVec || !aligned) {
    const unsigned blocks =
        (n * n * n + kStencilThreads - 1) / kStencilThreads;
    add_prolongation_cells<<<blocks, kStencilThreads, 0, st>>>(y, xc, out, n);
    return static_cast<int>(cudaGetLastError());
  }
  const int m = n / 2;
  const int gx = (m + kTileZ - 1) / kTileZ;
  const int gy = (m + kTileY - 1) / kTileY;
  int run = m;
  while (run > 1 && gx * gy * ((m + run - 1) / run) < kTargetBlocks) {
    run = (run + 1) / 2;
  }
  const dim3 grid(gx, gy, (m + run - 1) / run);
  add_prolongation_march<<<grid, dim3(kLanes, kRows), 0, st>>>(y, xc, out, n,
                                                               run);
  return static_cast<int>(cudaGetLastError());
}
