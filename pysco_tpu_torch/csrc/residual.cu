// Residual norm and fused restriction on the full lattice, for Hopper,
// sm_90a: the multigrid kernels that read a residual of one kind.
//
// Kinds (pysco_tpu/ops/pallas_stencil.py _KINDS): linear b - L(x),
// laplacian L(x), reformulated x + (h^2 b - S)/6, and the f(R) cubic and
// quartic operators, where S is the neighbour sum of x^power; with rhs the
// residual is rhs - op. The kind is a template parameter, so each kind is
// its own instantiation with no per-cell branching.
//
// residual_norm2 replaces pallas_stencil.py::residual_norm2, which streams
// blocks of x-planes with one halo plane each side through VMEM and writes
// a row of partial sums per block. What bounds it on the card: bytes. x
// and b (and rhs) are read once, 2 x 67 MB at 256^3: >= 0.040 ms at 3.35
// TB/s; the ~11 float32 operations a cell take 3 us at 67 TFLOP/s.
//
// The plane march (n a multiple of 4 and at least 32, every array 16-byte
// aligned): a block of 32 x 8 threads owns a tile of 8 rows x 128 z cells
// and marches along x over a run of planes. Each thread owns 4 consecutive
// z cells of one row and moves them as one float4 (x, b, rhs). x^P of the
// plane being evaluated sits in shared memory with a one-row y halo and a
// one-cell z halo; x^P of the planes before and after it stays in the
// thread's registers and moves down the queue, and the loads of the next
// plane start before the current one is computed. So each value of x
// is read from device memory once per run (plus the halo rows and the two
// planes that bound the run) and raised to its power once. A 3-D grid of
// blocks (z tiles, y tiles, runs) needs no runtime division; the run
// length is chosen so that about 1024 blocks fill the card.
//
// The per-cell expressions are the twin's (stencil.cuh: the neighbour sum
// in the order x-, x+, y-, y+, z-, z+, then residual<K>), so r is bitwise
// the twin's r. Each r^2 is rounded to float32 and added in double. The sum
// has one fixed order, set by n alone: a thread adds its cells plane by
// plane, a warp (one row) reduces by shuffles in a fixed tree, the block's
// first thread adds the rows in order into one double partial, and a
// second one-block launch adds the partials in a fixed order. No atomics:
// two calls on the same input are bitwise equal, so the multigrid stop
// test (err <= tol or 2 err > prev) takes the same branch on every run.
//
// Other grids (the coarse multigrid levels n = 4 ... 24, n not a multiple
// of 4, a misaligned array) take one thread a cell in a grid-stride loop
// over the same number of blocks, with the same two-stage sum.
//
// restrict3 replaces pallas_stencil.py::restrict3 and its tiling variant
// _restrict3_yblocked, which form the 2x2x2 pair sums as 0/1 matrix
// products on the MXU. Here one thread takes one coarse cell: it forms the
// residuals of its 8 children (each from 6 periodic neighbours of x^power)
// and writes 0.125 x their sum to R(r), and, when asked, R(x) and R(b).
// The 8 children are summed in pairs as the MXU contraction does: z pairs,
// then y pairs, then x pairs (mesh.restriction in the port, the same
// order).
//
// What bounds the restriction on the card: bytes too. Each fine cell is
// read once as a centre value and its neighbours come mostly from L1/L2; b
// (and rhs) are read once, and each output is 1/8 of a fine grid.

#include "stencil.cuh"

namespace {

using pysco::KindTraits;
using pysco::kStencilThreads;
using pysco::neighbour_sum;
using pysco::periodic;
using pysco::power_of;
using pysco::residual;

constexpr int kMaxNormBlocks = 1024;  // of the per-cell kernel

// the plane march's tile: a warp a row, one float4 a thread
constexpr int kVec = 4;
constexpr int kLanes = 32;
constexpr int kTileZ = kLanes * kVec;
constexpr int kTileY = 8;                // rows of a tile (a block's warps)
constexpr int kMaxTileY = 16;            // the most the kernel is built for
constexpr int kRow = kTileZ + 2 * kVec;  // a float4 of halo room each side
constexpr int kMarchMinN = 32;
constexpr int kTargetBlocks = 1024;

template <int K, bool HasRhs>
__global__ void __launch_bounds__(kStencilThreads)
norm2_partial(const float* __restrict__ x, const float* __restrict__ b,
              const float* __restrict__ rhs, int n, float n2, float h2,
              float q, double* __restrict__ partial) {
  constexpr int P = KindTraits<K>::power;
  const int cells = n * n * n;
  double acc = 0.0;
  for (int idx = blockIdx.x * kStencilThreads + threadIdx.x; idx < cells;
       idx += gridDim.x * kStencilThreads) {
    const int k = idx % n;
    const int j = (idx / n) % n;
    const int i = idx / (n * n);
    const float S = neighbour_sum<P>(x, n, i, j, k);
    const float bb = KindTraits<K>::needs_b ? b[idx] : 0.0f;
    float r = residual<K>(x[idx], S, bb, q, n2, h2);
    if (HasRhs) r = rhs[idx] - r;
    const float r2 = r * r;
    acc += static_cast<double>(r2);
  }
  __shared__ double sh[kStencilThreads];
  sh[threadIdx.x] = acc;
  __syncthreads();
  for (int s = kStencilThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) sh[threadIdx.x] += sh[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) partial[blockIdx.x] = sh[0];
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <int P> __device__ __forceinline__ float4 power4(float4 v) {
  return make_float4(power_of<P>(v.x), power_of<P>(v.y), power_of<P>(v.z),
                     power_of<P>(v.w));
}

__device__ __forceinline__ float lane(const float4& v, int c) {
  return c == 0 ? v.x : (c == 1 ? v.y : (c == 2 ? v.z : v.w));
}

// x values of one plane that a thread loads: its own 4 cells, 4 cells of a
// halo row (threads of rows 0 and 1), and the z halo cells at the ends of
// those rows (the tile's first and last threads)
struct PlaneLoad {
  float4 own, hrow;
  float own_lo, own_hi, h_lo, h_hi;
};

// One double partial a block: the sum of r^2 over its tile and run. The
// block is (kLanes, rows) threads, rows <= kMaxTileY.
template <int K, bool HasRhs>
__global__ void __launch_bounds__(kLanes * kMaxTileY, 2)
norm2_march(const float* __restrict__ x, const float* __restrict__ b,
            const float* __restrict__ rhs, int n, int run, float n2, float h2,
            float q, double* __restrict__ partial) {
  constexpr int P = KindTraits<K>::power;
  constexpr bool kNeedsB = KindTraits<K>::needs_b;
  __shared__ __align__(16) float plane[kMaxTileY + 2][kRow];
  __shared__ double row_sum[kMaxTileY];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int rows = blockDim.y;
  const int z0 = blockIdx.x * kTileZ;
  const int tw = min(n - z0, kTileZ);
  const int j0 = blockIdx.y * rows;
  const int jr = min(n - j0, rows);
  const int i0 = blockIdx.z * run;
  const int i1 = min(i0 + run, n);
  const int k = z0 + kVec * tx;
  const int j = j0 + ty;
  const bool col = kVec * tx < tw;
  const bool own = col && ty < jr;
  const bool lo = tx == 0, hi = kVec * (tx + 1) == tw;
  // threads of row 0 load the row before the tile, of row 1 the row after
  const bool hrow = col && ty < 2;
  const int hj = ty == 0 ? periodic(j0 - 1, n) : periodic(j0 + jr, n);
  const int hr = ty == 0 ? 0 : jr + 1;  // its row in shared memory
  const int zlo = periodic(z0 - 1, n), zhi = periodic(z0 + tw, n);
  const int nn = n * n;

  auto load_plane = [&](int ii, PlaneLoad& L) {
    const float* s = x + ii * nn;
    if (own) {
      L.own = load4(s + j * n + k);
      if (lo) L.own_lo = s[j * n + zlo];
      if (hi) L.own_hi = s[j * n + zhi];
    }
    if (hrow) {
      L.hrow = load4(s + hj * n + k);
      if (lo) L.h_lo = s[hj * n + zlo];
      if (hi) L.h_hi = s[hj * n + zhi];
    }
  };
  // x^P of a loaded plane into shared memory (own cells as given)
  auto store_plane = [&](const PlaneLoad& L, const float4& own_pow) {
    if (own) {
      float* row = plane[ty + 1];
      *reinterpret_cast<float4*>(row + kVec + kVec * tx) = own_pow;
      if (lo) row[kVec - 1] = power_of<P>(L.own_lo);
      if (hi) row[kVec + tw] = power_of<P>(L.own_hi);
    }
    if (hrow) {
      float* row = plane[hr];
      *reinterpret_cast<float4*>(row + kVec + kVec * tx) = power4<P>(L.hrow);
      if (lo) row[kVec - 1] = power_of<P>(L.h_lo);
      if (hi) row[kVec + tw] = power_of<P>(L.h_hi);
    }
  };

  PlaneLoad L = {};
  load_plane(periodic(i0 - 1, n), L);
  float4 pm = power4<P>(L.own);  // x^P of plane i - 1
  load_plane(i0, L);
  float4 xc = L.own;             // x of plane i
  float4 pc = power4<P>(xc);     // and its power
  store_plane(L, pc);
  double acc = 0.0;
  for (int i = i0; i < i1; ++i) {
    PlaneLoad N = {};
    load_plane(periodic(i + 1, n), N);
    const int at = i * nn + j * n + k;
    float4 b4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f), r4 = b4;
    if (own) {
      if (kNeedsB) b4 = load4(b + at);
      if (HasRhs) r4 = load4(rhs + at);
    }
    const float4 pn = power4<P>(N.own);  // x^P of plane i + 1
    __syncthreads();  // plane i complete in shared memory
    if (own) {
      const float* row = plane[ty + 1] + kVec + kVec * tx;
      const float* below = plane[ty] + kVec + kVec * tx;
      const float* above = plane[ty + 2] + kVec + kVec * tx;
#pragma unroll
      for (int c = 0; c < kVec; ++c) {
        float S = lane(pm, c) + lane(pn, c);
        S = S + below[c];
        S = S + above[c];
        S = S + row[c - 1];
        S = S + row[c + 1];
        float r = residual<K>(lane(xc, c), S, lane(b4, c), q, n2, h2);
        if (HasRhs) r = lane(r4, c) - r;
        const float r2 = r * r;
        acc += static_cast<double>(r2);
      }
    }
    __syncthreads();  // every read of plane i done
    if (i + 1 < i1) store_plane(N, pn);
    pm = pc;
    pc = pn;
    xc = N.own;
  }
  // a warp is one row: lanes in a fixed shuffle tree, then the rows in order
#pragma unroll
  for (int d = kLanes / 2; d > 0; d >>= 1) {
    acc += __shfl_down_sync(0xffffffffu, acc, d);
  }
  if (tx == 0) row_sum[ty] = acc;
  __syncthreads();
  if (tx == 0 && ty == 0) {
    double total = 0.0;
    for (int r = 0; r < rows; ++r) total += row_sum[r];
    partial[(blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x] =
        total;
  }
}

__global__ void __launch_bounds__(kStencilThreads)
sum_partials(const double* __restrict__ partial, int count,
             float* __restrict__ out) {
  double acc = 0.0;
  for (int i = threadIdx.x; i < count; i += kStencilThreads) acc += partial[i];
  __shared__ double sh[kStencilThreads];
  sh[threadIdx.x] = acc;
  __syncthreads();
  for (int s = kStencilThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) sh[threadIdx.x] += sh[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = static_cast<float>(sh[0]);
}

// 0.125 x the sum of a 2x2x2 block v[x][y][z]: z pairs, y pairs, x pairs
__device__ __forceinline__ float restrict_block(const float v[2][2][2]) {
  const float p00 = v[0][0][0] + v[0][0][1];
  const float p01 = v[0][1][0] + v[0][1][1];
  const float p10 = v[1][0][0] + v[1][0][1];
  const float p11 = v[1][1][0] + v[1][1][1];
  const float q0 = p00 + p01;
  const float q1 = p10 + p11;
  return 0.125f * (q0 + q1);
}

template <int K, bool HasRhs>
__global__ void __launch_bounds__(kStencilThreads)
restrict3_kernel(const float* __restrict__ x, const float* __restrict__ b,
                 const float* __restrict__ rhs, int n, float n2, float h2,
                 float q, float* __restrict__ rr, float* __restrict__ rx,
                 float* __restrict__ rb) {
  constexpr int P = KindTraits<K>::power;
  constexpr bool kNeedsB = KindTraits<K>::needs_b;
  const int m = n / 2;
  const int idx = blockIdx.x * kStencilThreads + threadIdx.x;
  if (idx >= m * m * m) return;
  const int kc = idx % m;
  const int jc = (idx / m) % m;
  const int ic = idx / (m * m);
  float r[2][2][2], xv[2][2][2], bv[2][2][2];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        const int i = 2 * ic + a, j = 2 * jc + c, k = 2 * kc + d;
        const int cell = (i * n + j) * n + k;
        const float S = neighbour_sum<P>(x, n, i, j, k);
        const float xc = x[cell];
        const float bb = kNeedsB ? b[cell] : 0.0f;
        float res = residual<K>(xc, S, bb, q, n2, h2);
        if (HasRhs) res = rhs[cell] - res;
        r[a][c][d] = res;
        xv[a][c][d] = xc;
        bv[a][c][d] = bb;
      }
    }
  }
  if (rr != nullptr) rr[idx] = restrict_block(r);
  if (rx != nullptr) rx[idx] = restrict_block(xv);
  if (kNeedsB && rb != nullptr) rb[idx] = restrict_block(bv);
}

// How a norm is launched: the plane march over grid blocks of
// (kLanes, rows) threads, or (rows = 0) one thread a cell over grid.x
// blocks.
struct NormPlan {
  int rows, run;
  dim3 grid;
  int blocks() const { return grid.x * grid.y * grid.z; }
};

bool march_takes(int n) { return n >= kMarchMinN && n % kVec == 0; }

NormPlan plan_cells_in(int blocks) { return {0, 0, dim3(blocks)}; }

NormPlan plan_cells(int n) {
  const int cells = n * n * n;
  const int blocks = (cells + kStencilThreads - 1) / kStencilThreads;
  return plan_cells_in(blocks < kMaxNormBlocks ? blocks : kMaxNormBlocks);
}

NormPlan plan_march(int n, int rows) {
  const int gx = (n + kTileZ - 1) / kTileZ;
  const int gy = (n + rows - 1) / rows;
  int run = n;
  while (run > 2 && gx * gy * ((n + run - 1) / run) < kTargetBlocks) run /= 2;
  return {rows, run, dim3(gx, gy, (n + run - 1) / run)};
}

template <int K, bool HasRhs>
void launch_norm2_as(const NormPlan& p, cudaStream_t st, const float* x,
                  const float* b, const float* rhs, int n, float n2, float h2,
                  float q, double* partial) {
  if (p.rows) {
    norm2_march<K, HasRhs><<<p.grid, dim3(kLanes, p.rows), 0, st>>>(
        x, b, rhs, n, p.run, n2, h2, q, partial);
  } else {
    norm2_partial<K, HasRhs><<<p.grid, kStencilThreads, 0, st>>>(
        x, b, rhs, n, n2, h2, q, partial);
  }
}

template <int K>
void launch_norm2(const NormPlan& p, cudaStream_t st, const float* x,
                  const float* b, const float* rhs, int n, float n2, float h2,
                  float q, double* partial) {
  if (rhs != nullptr) {
    launch_norm2_as<K, true>(p, st, x, b, rhs, n, n2, h2, q, partial);
  } else {
    launch_norm2_as<K, false>(p, st, x, b, rhs, n, n2, h2, q, partial);
  }
}

// The partials of plan p, then (finish) their sum into out[0].
int run_norm2(const NormPlan& p, bool finish, int kind, const float* x,
              const float* b, const float* rhs, int n, float n2, float h2,
              float q, double* partial, float* out, cudaStream_t st) {
  switch (kind) {
    case pysco::kLinear:
      launch_norm2<pysco::kLinear>(p, st, x, b, rhs, n, n2, h2, q, partial);
      break;
    case pysco::kLaplacian:
      launch_norm2<pysco::kLaplacian>(p, st, x, b, rhs, n, n2, h2, q,
                                      partial);
      break;
    case pysco::kReformulated:
      launch_norm2<pysco::kReformulated>(p, st, x, b, rhs, n, n2, h2, q,
                                         partial);
      break;
    case pysco::kCubic:
      launch_norm2<pysco::kCubic>(p, st, x, b, rhs, n, n2, h2, q, partial);
      break;
    case pysco::kQuartic:
      launch_norm2<pysco::kQuartic>(p, st, x, b, rhs, n, n2, h2, q, partial);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !finish) return static_cast<int>(err);
  sum_partials<<<1, kStencilThreads, 0, st>>>(partial, p.blocks(), out);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const float* p) {
  return reinterpret_cast<size_t>(p) % 16 == 0;
}

template <int K>
void launch_restrict3(bool has_rhs, unsigned blocks, cudaStream_t st,
                      const float* x, const float* b, const float* rhs, int n,
                      float n2, float h2, float q, float* rr, float* rx,
                      float* rb) {
  if (has_rhs) {
    restrict3_kernel<K, true><<<blocks, kStencilThreads, 0, st>>>(
        x, b, rhs, n, n2, h2, q, rr, rx, rb);
  } else {
    restrict3_kernel<K, false><<<blocks, kStencilThreads, 0, st>>>(
        x, b, rhs, n, n2, h2, q, rr, rx, rb);
  }
}

}  // namespace

// Number of partial sums residual_norm2 writes for an n^3 lattice: the
// wrapper allocates that many doubles of scratch. Set by n alone.
extern "C" int pysco_norm2_blocks(int n) {
  return (march_takes(n) ? plan_march(n, kTileY) : plan_cells(n)).blocks();
}

// out[0] = sum over the n^3 lattice of r^2, r the kind residual (rhs - op
// when rhs is not null). partial holds pysco_norm2_blocks(n) doubles.
// Returns the CUDA error of the launches (0 on success).
extern "C" int pysco_residual_norm2(int kind, const float* x, const float* b,
                                    const float* rhs, int n, float n2,
                                    float h2, float q, double* partial,
                                    float* out, void* stream) {
  NormPlan p = plan_cells(n);
  if (march_takes(n)) {
    p = plan_march(n, kTileY);
    if (!(aligned16(x) && aligned16(b) && aligned16(rhs))) {
      p = plan_cells_in(p.blocks());
    }
  }
  return run_norm2(p, true, kind, x, b, rhs, n, n2, h2, q, partial, out,
                   static_cast<cudaStream_t>(stream));
}

// For timing one design against another (chip_smoke.py): the norm by the
// plane march with tile_rows rows a tile (8 or 16; n a multiple of 4, at
// least 32, aligned arrays) or, tile_rows = 0, by one thread a cell; with
// finish = 0 the partials are written and not added. partial holds
// pysco_norm2_variant_blocks(n, tile_rows) doubles.
extern "C" int pysco_norm2_variant_blocks(int n, int tile_rows) {
  return (tile_rows ? plan_march(n, tile_rows) : plan_cells(n)).blocks();
}

extern "C" int pysco_residual_norm2_variant(int tile_rows, int finish,
                                            int kind, const float* x,
                                            const float* b, const float* rhs,
                                            int n, float n2, float h2,
                                            float q, double* partial,
                                            float* out, void* stream) {
  if (tile_rows != 0 && tile_rows != 8 && tile_rows != kMaxTileY) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (tile_rows && !(march_takes(n) && aligned16(x) && aligned16(b) &&
                     aligned16(rhs))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const NormPlan p = tile_rows ? plan_march(n, tile_rows) : plan_cells(n);
  return run_norm2(p, finish != 0, kind, x, b, rhs, n, n2, h2, q, partial,
                   out, static_cast<cudaStream_t>(stream));
}

// From the n^3 lattice, write the (n/2)^3 restrictions R(r) to rr, R(x) to
// rx and R(b) to rb; a null output is not written (rb is not written for
// the laplacian kind, which reads no b). Returns the CUDA error of the
// launch (0 on success).
extern "C" int pysco_restrict3(int kind, const float* x, const float* b,
                               const float* rhs, int n, float n2, float h2,
                               float q, float* rr, float* rx, float* rb,
                               void* stream) {
  const int m = n / 2;
  const unsigned blocks = (m * m * m + kStencilThreads - 1) / kStencilThreads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool has_rhs = rhs != nullptr;
  switch (kind) {
    case pysco::kLinear:
      launch_restrict3<pysco::kLinear>(has_rhs, blocks, st, x, b, rhs, n, n2,
                                       h2, q, rr, rx, rb);
      break;
    case pysco::kLaplacian:
      launch_restrict3<pysco::kLaplacian>(has_rhs, blocks, st, x, b, rhs, n,
                                          n2, h2, q, rr, rx, rb);
      break;
    case pysco::kReformulated:
      launch_restrict3<pysco::kReformulated>(has_rhs, blocks, st, x, b, rhs,
                                             n, n2, h2, q, rr, rx, rb);
      break;
    case pysco::kCubic:
      launch_restrict3<pysco::kCubic>(has_rhs, blocks, st, x, b, rhs, n, n2,
                                      h2, q, rr, rx, rb);
      break;
    case pysco::kQuartic:
      launch_restrict3<pysco::kQuartic>(has_rhs, blocks, st, x, b, rhs, n,
                                        n2, h2, q, rr, rx, rb);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
