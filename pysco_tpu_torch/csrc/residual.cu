// Residual norm and fused restriction on the full lattice, for Hopper,
// sm_90a: the multigrid kernels that read a residual of one kind.
//
// Kinds (pysco_tpu/ops/pallas_stencil.py _KINDS): linear b - L(x),
// laplacian L(x), reformulated x + (h^2 b - S)/6, and the f(R) cubic and
// quartic operators, where S is the neighbour sum of x^power; with rhs the
// residual is rhs - op. The kind is a template parameter, so each kind is
// its own instantiation with no per-cell branching.
//
// residual_norm2 replaces pallas_stencil.py::residual_norm2 (per
// plane-block partial sums of r^2 on the TPU). Here a fixed number of
// blocks, set by the lattice size alone, walk the cells in a grid-stride
// loop; each thread adds r^2 (rounded to float32 as in the twin) in
// double, each block reduces its threads in a fixed tree into one double
// partial, and a second one-block launch adds the partials in a fixed
// order. No atomics: two calls on the same input are bitwise equal, so the
// multigrid stop test (err <= tol or 2 err > prev) takes the same branch on
// every run.
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
// What bounds both on the card: bytes. Each fine cell is read once as a
// centre value and its neighbours come mostly from L1/L2; b (and rhs) are
// read once. A restriction writes 1/8 of a fine grid per output.

#include "stencil.cuh"

namespace {

using pysco::KindTraits;
using pysco::kStencilThreads;
using pysco::neighbour_sum;
using pysco::residual;

constexpr int kMaxNormBlocks = 1024;

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

template <int K>
void launch_norm2(bool has_rhs, unsigned blocks, cudaStream_t st,
                  const float* x, const float* b, const float* rhs, int n,
                  float n2, float h2, float q, double* partial) {
  if (has_rhs) {
    norm2_partial<K, true><<<blocks, kStencilThreads, 0, st>>>(
        x, b, rhs, n, n2, h2, q, partial);
  } else {
    norm2_partial<K, false><<<blocks, kStencilThreads, 0, st>>>(
        x, b, rhs, n, n2, h2, q, partial);
  }
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
// wrapper allocates that many doubles of scratch.
extern "C" int pysco_norm2_blocks(int n) {
  const int cells = n * n * n;
  const int blocks = (cells + kStencilThreads - 1) / kStencilThreads;
  return blocks < kMaxNormBlocks ? blocks : kMaxNormBlocks;
}

// out[0] = sum over the n^3 lattice of r^2, r the kind residual (rhs - op
// when rhs is not null). partial holds pysco_norm2_blocks(n) doubles.
// Returns the CUDA error of the launches (0 on success).
extern "C" int pysco_residual_norm2(int kind, const float* x, const float* b,
                                    const float* rhs, int n, float n2,
                                    float h2, float q, double* partial,
                                    float* out, void* stream) {
  const int blocks = pysco_norm2_blocks(n);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool has_rhs = rhs != nullptr;
  switch (kind) {
    case pysco::kLinear:
      launch_norm2<pysco::kLinear>(has_rhs, blocks, st, x, b, rhs, n, n2, h2,
                                   q, partial);
      break;
    case pysco::kLaplacian:
      launch_norm2<pysco::kLaplacian>(has_rhs, blocks, st, x, b, rhs, n, n2,
                                      h2, q, partial);
      break;
    case pysco::kReformulated:
      launch_norm2<pysco::kReformulated>(has_rhs, blocks, st, x, b, rhs, n,
                                         n2, h2, q, partial);
      break;
    case pysco::kCubic:
      launch_norm2<pysco::kCubic>(has_rhs, blocks, st, x, b, rhs, n, n2, h2,
                                  q, partial);
      break;
    case pysco::kQuartic:
      launch_norm2<pysco::kQuartic>(has_rhs, blocks, st, x, b, rhs, n, n2,
                                    h2, q, partial);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_partials<<<1, kStencilThreads, 0, st>>>(partial, blocks, out);
  return static_cast<int>(cudaGetLastError());
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
