// One colour half of the packed red-black nonlinear sweep of the f(R)
// scalaron, for Hopper, sm_90a.
//
// Replaces pysco_tpu/ops/pallas_stencil.py::scalaron_half_sweep, which
// streams blocks of x-planes of the (n, n/2, n) half-lattices through VMEM
// with one periodic halo plane on each side, exactly as its linear sibling
// half_sweep. Here, as in half_sweep.cu, one thread takes one cell of the
// output half-lattice and reads its six opposite-colour neighbours straight
// from device memory (the packed y-neighbour rule of stencil.cuh).
//
// Per cell of the to_red colour (else black), with k = Power:
//   p   = hb - (1/6) (x-^k + x+^k + y-^k + y+^k + z-^k + z+^k)
//   x   = dst, then 3 Newton steps on x^(k+1) + p x + c0 = 0
//         cubic   (k = 2): f = x (x x + p) + c0,       f' = (3 x) x + p
//         quartic (k = 3): f = (x2 x2 + p x) + c0,     f' = (4 x2) x + p
//         f' = |f'| < 1e-12 ? 1e-12 : f';  x = x - f / f'
//   out = dst + f_relax (x - dst)
// c0 is one scalar (no FAS rhs: h^2 q) or a plane (h^2 q - rhs), as the
// caller folds it (models/laplacian.py packed_scalaron_smoothing). Every
// expression is the twin's (ops/stencil.py scalaron_half_sweep_plain),
// operand for operand; built with --fmad=false and IEEE division, the two
// agree bitwise.
//
// Each thread reads only its own dst cell and the other colour, so out may
// be dst (an in-place update).
//
// What bounds it on the card: bytes. Per cell it reads 4 B each of dst and
// hb (and the coef plane) and writes 4 B; the six neighbour reads of src
// mostly hit L1/L2. At 256^3 a call moves 4 x 33.5 MB (5 x with the
// plane): >= 0.040 ms (0.050 ms) at 3.35 TB/s. The ~50 float32 operations
// a cell (one division per Newton step) take under 10 us at 67 TFLOP/s.

#include "stencil.cuh"

namespace {

using pysco::kInvSix;
using pysco::kStencilThreads;
using pysco::periodic;
using pysco::power_of;

// float32(1e-12) rounded from the double, as numpy's float32(1e-12)
constexpr float kNewtonEps = static_cast<float>(1e-12);

template <int Power>
__device__ __forceinline__ float newton_root(float x, float p, float c0,
                                             int iters) {
  for (int it = 0; it < iters; ++it) {
    float f, fp;
    if (Power == 2) {
      f = x * (x * x + p) + c0;
      fp = (3.0f * x) * x + p;
    } else {
      const float x2 = x * x;
      f = (x2 * x2 + p * x) + c0;
      fp = (4.0f * x2) * x + p;
    }
    fp = fabsf(fp) < kNewtonEps ? kNewtonEps : fp;
    x = x - f / fp;
  }
  return x;
}

template <int Power, bool CoefPlane>
__global__ void __launch_bounds__(kStencilThreads)
scalaron_sweep_kernel(const float* __restrict__ src, const float* dst,
                      const float* __restrict__ hb,
                      const float* __restrict__ coef_plane, float coef,
                      float* out, int n, int to_red, float f_relax,
                      int newton_iters) {
  const int hp = n / 2;
  const int cells = n * hp * n;
  const int idx = blockIdx.x * kStencilThreads + threadIdx.x;
  if (idx >= cells) return;
  const int k = idx % n;
  const int jp = (idx / n) % hp;
  const int i = idx / (n * hp);
  const bool s1 = ((i + k) & 1) == 1;
  auto at = [&](int a, int b, int c) {
    return power_of<Power>(src[(a * hp + b) * n + c]);
  };
  const float xm = at(periodic(i - 1, n), jp, k);
  const float xp = at(periodic(i + 1, n), jp, k);
  const float cen = power_of<Power>(src[idx]);
  // red with s = 1 and black with s = 0 have their y- neighbour one row
  // down; the others have their y+ neighbour one row up
  const bool down = to_red ? s1 : !s1;
  const float ym = down ? at(i, periodic(jp - 1, hp), k) : cen;
  const float yp = down ? cen : at(i, periodic(jp + 1, hp), k);
  const float zm = at(i, jp, periodic(k - 1, n));
  const float zp = at(i, jp, periodic(k + 1, n));
  float nb = xm + xp;
  nb = nb + ym;
  nb = nb + yp;
  nb = nb + zm;
  nb = nb + zp;
  const float p = hb[idx] - kInvSix * nb;
  const float c0 = CoefPlane ? coef_plane[idx] : coef;
  const float old = dst[idx];
  const float x = newton_root<Power>(old, p, c0, newton_iters);
  out[idx] = old + f_relax * (x - old);
}

template <int Power>
void launch(const float* src, const float* dst, const float* hb,
            const float* coef_plane, float coef, float* out, int n,
            int to_red, float f_relax, int newton_iters, cudaStream_t st) {
  const int cells = n * (n / 2) * n;
  const unsigned blocks = (cells + kStencilThreads - 1) / kStencilThreads;
  if (coef_plane != nullptr) {
    scalaron_sweep_kernel<Power, true><<<blocks, kStencilThreads, 0, st>>>(
        src, dst, hb, coef_plane, coef, out, n, to_red, f_relax,
        newton_iters);
  } else {
    scalaron_sweep_kernel<Power, false><<<blocks, kStencilThreads, 0, st>>>(
        src, dst, hb, coef_plane, coef, out, n, to_red, f_relax,
        newton_iters);
  }
}

}  // namespace

// Update the to_red colour (else black) of the (n, n/2, n) half-lattice
// dst from the other colour src, for the neighbour power 2 (f(R) n = 1) or
// 3 (n = 2). coef_plane may be null, and then the scalar coef is c0. out
// may be dst. Returns the CUDA error of the launch (0 on success), or
// cudaErrorInvalidValue for another power.
extern "C" int pysco_scalaron_half_sweep(const float* src, const float* dst,
                                         const float* hb,
                                         const float* coef_plane, float coef,
                                         float* out, int n, int to_red,
                                         float f_relax, int power,
                                         int newton_iters, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (power == 2) {
    launch<2>(src, dst, hb, coef_plane, coef, out, n, to_red, f_relax,
              newton_iters, st);
  } else if (power == 3) {
    launch<3>(src, dst, hb, coef_plane, coef, out, n, to_red, f_relax,
              newton_iters, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
