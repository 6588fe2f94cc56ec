// One colour half of a packed red-black Gauss-Seidel sweep for the linear
// Poisson operator, for Hopper, sm_90a.
//
// Replaces pysco_tpu/ops/pallas_stencil.py::half_sweep, which streams
// blocks of x-planes of the (n, n/2, n) half-lattices through VMEM with
// one periodic halo plane on each side and rolls the y/z neighbours inside
// the block. Here one thread takes one cell of the output half-lattice and
// reads its six neighbours of the opposite colour straight from device
// memory; the halo planes and the rolls were TPU tiling and have no
// counterpart.
//
// Packed layout (models/laplacian.py): s(i, k) = (i + k) & 1,
// red[i, jp, k] = x[i, 2 jp + 1 - s, k], black[i, jp, k] = x[i, 2 jp + s, k].
// The x and z neighbours of a cell sit at the same packed (jp, k) in the
// planes i -+ 1 and the columns k -+ 1. Of the two y neighbours one is
// src[i, jp, k] and the other src[i, jp -+ 1, k]: for a red cell with
// s = 1 they are (jp - 1, jp), with s = 0 (jp, jp + 1); for a black cell
// the other way round. The sum runs x-, x+, y-, y+, z-, z+ and the update
// is dst + f (((sum - h2b) / 6 [+ rhs]) - dst), as in the twin.
//
// Each thread reads only its own dst cell and the other colour, so out may
// be dst (an in-place update).
//
// What bounds it on the card: bytes. Per cell it reads 4 B of dst, h2b
// (and rhs) and writes 4 B; the 6 neighbour reads of src mostly hit L1/L2,
// since neighbouring threads share planes and rows. At 256^3 a half-sweep
// moves about 4 x 33.5 MB.

#include "stencil.cuh"

namespace {

using pysco::kInvSix;
using pysco::kStencilThreads;
using pysco::periodic;

template <bool HasRhs>
__global__ void __launch_bounds__(kStencilThreads)
half_sweep_kernel(const float* __restrict__ src, const float* dst,
                  const float* __restrict__ h2b,
                  const float* __restrict__ rhs, float* out, int n,
                  int to_red, float f_relax) {
  const int hp = n / 2;
  const int cells = n * hp * n;
  const int idx = blockIdx.x * kStencilThreads + threadIdx.x;
  if (idx >= cells) return;
  const int k = idx % n;
  const int jp = (idx / n) % hp;
  const int i = idx / (n * hp);
  const bool s1 = ((i + k) & 1) == 1;
  auto at = [&](int a, int b, int c) { return src[(a * hp + b) * n + c]; };
  const float xm = at(periodic(i - 1, n), jp, k);
  const float xp = at(periodic(i + 1, n), jp, k);
  const float cen = src[idx];
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
  float tgt = (nb - h2b[idx]) * kInvSix;
  if (HasRhs) tgt = tgt + rhs[idx];
  const float old = dst[idx];
  out[idx] = old + f_relax * (tgt - old);
}

}  // namespace

// Update the to_red colour (else black) of the (n, n/2, n) half-lattice
// dst from the other colour src; rhs may be null. out may be dst. Returns
// the CUDA error of the launch (0 on success).
extern "C" int pysco_half_sweep(const float* src, const float* dst,
                                const float* h2b, const float* rhs,
                                float* out, int n, int to_red, float f_relax,
                                void* stream) {
  const int cells = n * (n / 2) * n;
  const unsigned blocks = (cells + kStencilThreads - 1) / kStencilThreads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rhs != nullptr) {
    half_sweep_kernel<true><<<blocks, kStencilThreads, 0, st>>>(
        src, dst, h2b, rhs, out, n, to_red, f_relax);
  } else {
    half_sweep_kernel<false><<<blocks, kStencilThreads, 0, st>>>(
        src, dst, h2b, rhs, out, n, to_red, f_relax);
  }
  return static_cast<int>(cudaGetLastError());
}
