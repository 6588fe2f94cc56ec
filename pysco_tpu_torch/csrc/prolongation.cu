// y + the trilinear prolongation of a coarse grid, for Hopper, sm_90a.
//
// Replaces pysco_tpu/ops/pallas_stencil.py::add_prolongation, which streams
// coarse plane blocks with periodic halo planes through VMEM and does the
// in-plane 2x expansions as matrix products on the MXU. Here one thread
// takes one fine cell (i, j, k). Along each axis the fine index 2r takes
// 3/4 of coarse cell r and 1/4 of r - 1, the index 2r + 1 3/4 of r and 1/4
// of r + 1 (periodic). The axes are applied in the order x, y, z, as
// mesh._prolong_axis does in the twin: the 4 x-blends of the (y, z)
// corners, then 2 y-blends, then one z-blend, each 0.75 a + 0.25 b with
// its own roundings (--fmad=false). The result is bitwise the twin's.
//
// What bounds it on the card: bytes. A fine cell reads y and writes the
// sum (8 B); the 8 coarse reads are shared by neighbouring threads and
// come from L1/L2.

#include "stencil.cuh"

namespace {

using pysco::kStencilThreads;
using pysco::periodic;

__device__ __forceinline__ float blend(float centre, float side) {
  return 0.75f * centre + 0.25f * side;
}

__global__ void __launch_bounds__(kStencilThreads)
add_prolongation_kernel(const float* __restrict__ y,
                        const float* __restrict__ xc,
                        float* __restrict__ out, int n) {
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

}  // namespace

// out = y + prolongation(xc) for a fine (n, n, n) y and a coarse
// (n/2, n/2, n/2) xc. Returns the CUDA error of the launch (0 on success).
extern "C" int pysco_add_prolongation(const float* y, const float* xc,
                                      float* out, int n, void* stream) {
  const unsigned blocks = (n * n * n + kStencilThreads - 1) / kStencilThreads;
  add_prolongation_kernel<<<blocks, kStencilThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(y, xc, out,
                                                                 n);
  return static_cast<int>(cudaGetLastError());
}
