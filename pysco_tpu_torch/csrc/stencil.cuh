// Shared pieces of the multigrid stencil kernels (half_sweep.cu,
// scalaron_sweep.cu, residual.cu, prolongation.cu). Grids are float32, C
// order, periodic:
// a full lattice is (n, n, n), a packed red-black half-lattice
// (n, n/2, n) (pysco_tpu_torch/models/laplacian.py). Every expression
// here is the one of the plain PyTorch twins in
// pysco_tpu_torch/ops/stencil.py, with the same operands in the same
// order; built with --fmad=false, each product and sum rounds on its own
// as in the twins.
#pragma once

#include <cuda_runtime.h>

namespace pysco {

constexpr int kStencilThreads = 256;

// 1/6 rounded to float32 from the double, as numpy's float32(1/6)
constexpr float kInvSix = static_cast<float>(1.0 / 6.0);

// Residual kinds: the numbering of stencil._KINDS.
enum Kind { kLinear = 0, kLaplacian = 1, kReformulated = 2, kCubic = 3,
            kQuartic = 4 };

// Power of x that enters the neighbour sum, and whether b is read.
template <int K> struct KindTraits {
  static constexpr int power = K == kCubic ? 2 : (K == kQuartic ? 3 : 1);
  static constexpr bool needs_b = K != kLaplacian;
};

// Periodic index of a neighbour at most one period out of range.
__device__ __forceinline__ int periodic(int i, int n) {
  return i < 0 ? i + n : (i >= n ? i - n : i);
}

template <int P> __device__ __forceinline__ float power_of(float v) {
  if (P == 2) return v * v;
  if (P == 3) return v * v * v;
  return v;
}

// Sum of x^P over the 6 periodic neighbours of (i, j, k) on the full
// lattice, in the order x-, x+, y-, y+, z-, z+.
template <int P>
__device__ __forceinline__ float neighbour_sum(const float* __restrict__ x,
                                               int n, int i, int j, int k) {
  auto at = [&](int a, int b, int c) {
    return power_of<P>(x[(a * n + b) * n + c]);
  };
  float s = at(periodic(i - 1, n), j, k);
  s = s + at(periodic(i + 1, n), j, k);
  s = s + at(i, periodic(j - 1, n), k);
  s = s + at(i, periodic(j + 1, n), k);
  s = s + at(i, j, periodic(k - 1, n));
  s = s + at(i, j, periodic(k + 1, n));
  return s;
}

// Residual of kind K at one cell (pysco_tpu/ops/pallas_stencil.py
// _residual_block): x the cell value, S its neighbour sum of x^P, b the
// source (unused by kLaplacian), q the f(R) constant (cubic, quartic),
// n2 = n*n and h2 = float32(1/(n*n)).
template <int K>
__device__ __forceinline__ float residual(float x, float S, float b, float q,
                                          float n2, float h2) {
  if (K == kLinear) return b - (S - 6.0f * x) * n2;
  if (K == kLaplacian) return (S - 6.0f * x) * n2;
  if (K == kReformulated) return x + kInvSix * (h2 * b - S);
  const float p = h2 * b - kInvSix * S;
  if (K == kCubic) return x * x * x + p * x + q * h2;
  const float x2 = x * x;
  return x2 * x2 + p * x + q * h2;
}

}  // namespace pysco
