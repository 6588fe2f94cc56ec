// The QUMOND source div[nu(|grad phi| / g0) grad phi] on face-centred
// points, for Hopper, sm_90a.
//
// Replaces no TPU kernel: the JAX package computes the source in jnp
// (pysco_tpu/models/mond.py). Added because the port's plain PyTorch form,
// models/mond.rhs_plain (~94 torch calls a call, 18 of them rolls, ~212
// grids' worth of traffic), ran at 0.72% of its bound in the QUMOND cell at
// 512^3.
//
// What it computes: for each axis a, with the other two t1 < t2, the flux
// through the A-face of cell c (between c - e_a and c)
//   g_a = invh * (phi[c] - phi[c - e_a])
//   g_t = inv4h * (D_t[c] + D_t[c - e_a]),  D_t = phi[c + e_t] - phi[c - e_t]
//   |g| = sqrt((g_a * g_a + g_t1 * g_t1) + g_t2 * g_t2)
//   F_a = |g| > 0 ? nu(|g| * inv_g0) * g_a : 0
// and out = ((0 + invh (F_0[c + e_0] - F_0[c])) + invh (F_1[c + e_1] -
// F_1[c])) + invh (F_2[c + e_2] - F_2[c]): the plain form's operands in its
// order. Built with --fmad=false every product and sum rounds on its own,
// and sqrtf and / are IEEE (nvcc's defaults), so the simple nu is bitwise
// the plain form. The other families call powf, expf and rsqrtf wherever
// torch's pow and exp do, which may round an ulp away from torch's.
//
// What bounds it on the card: bytes and instructions nearly alike. phi is
// read once and the source written once, 8 n^3 bytes: 1.07 GB at 512^3,
// 0.32 ms at 3.35 TB/s. A face flux takes two IEEE square roots and one
// IEEE division, ~45 instructions; three faces and ~150 instructions a
// cell take ~0.6 ms at 512^3 on 132 SMs, twice that if each cell computed
// both of its faces. Measured on an H100 at 512^3: 1.55 ms, bound by the
// instructions (the IEEE slow-path checks included), not the bytes.
//
// The design: a block of 32 x kRows threads owns a tile of kRows rows (y)
// x 32 columns (x) and marches along z over a run of planes. The planes z
// - 1, z and z + 1 of its tile, each with a one-cell halo, sit in a ring
// of four shared-memory planes; the loads of plane z + 2 are started before
// plane z is computed and stored into the ring after it, so phi comes from
// device memory once a run (and the halo's re-reads from L2). Each face
// flux is computed once: F_0 through a plane's upper face is carried in a
// register to the next plane as its lower face; F_1 (kRows + 1 face rows)
// and F_2 (33 face columns) of the plane go to shared memory, the extra
// row taken by warp 0 and the extra column by warp 1 (two buffers: one
// barrier a plane). Every index wraps by its own axis's length, so any
// (nz, ny, nx) gives the plain form's result, ragged tiles masked; the run
// length is chosen for about kTargetBlocks blocks.

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;                 // tile columns (x): a warp a row
constexpr int kRows = 8;                   // tile rows (y): a block's warps
constexpr int kThreads = kLanes * kRows;
constexpr int kHaloX = kLanes + 2;
constexpr int kHaloY = kRows + 2;
constexpr int kHaloCells = kHaloY * kHaloX;
constexpr int kOwn = (kHaloCells + kThreads - 1) / kThreads;  // a thread's
constexpr int kRing = 4;                   // planes z - 1 .. z + 2
constexpr int kTargetBlocks = 8192;

// Interpolating-function families: the numbering of mond._FAMILIES.
enum Family { kSimple = 0, kN = 1, kBeta = 2, kGamma = 3, kDelta = 4 };

// A family's float32 constants, rounded from alpha in double as the plain
// form rounds them: n: e1 = -n, e2 = 1/n; beta: c = beta; gamma: e1 =
// gamma/2, e2 = -1/gamma, c = 1 - 1/gamma; delta: e1 = delta/2, e2 =
// -1/delta.
struct NuConst {
  float e1, e2, c;
};

__device__ __forceinline__ int pmod(int i, int n) {
  const int r = i % n;
  return r < 0 ? r + n : r;
}

// x ** e as torch's pow of a tensor by a scalar computes it on the card:
// the exponents it takes apart, then powf.
__device__ __forceinline__ float torch_pow(float x, float e) {
  if (e == 1.0f) return x;
  if (e == 0.0f) return 1.0f;
  if (e == 0.5f) return sqrtf(x);
  if (e == 2.0f) return x * x;
  if (e == 3.0f) return x * x * x;
  if (e == -0.5f) return rsqrtf(x);
  if (e == -1.0f) return 1.0f / x;
  if (e == -2.0f) return 1.0f / (x * x);
  return powf(x, e);
}

// nu(y) of family F (mond.nu_simple, nu_n, nu_beta, nu_gamma, nu_delta).
template <int F>
__device__ __forceinline__ float nu(float y, const NuConst& k) {
  if (F == kSimple) return 0.5f + sqrtf(0.25f + 1.0f / y);
  if (F == kN) return torch_pow(0.5f + sqrtf(0.25f + torch_pow(y, k.e1)),
                                k.e2);
  if (F == kBeta) {
    const float e = expf(-y);
    const float one_minus = 1.0f - e;
    return k.c * e + (one_minus > 0.0f ? torch_pow(one_minus, -0.5f) : 0.0f);
  }
  const float e = expf(-torch_pow(y, k.e1));
  if (F == kGamma) return torch_pow(1.0f - e, k.e2) + k.c * e;
  return torch_pow(1.0f - e, k.e2);
}

// the flux of normal gradient ga and tangential ones t1, t2 (the lower
// axis first)
template <int F>
__device__ __forceinline__ float flux(float ga, float t1, float t2,
                                      float inv_g0, const NuConst& k) {
  const float norm = sqrtf(ga * ga + t1 * t1 + t2 * t2);
  // nu(0) is infinite; nu g -> 0 as |g| -> 0
  return norm > 0.0f ? nu<F>(norm * inv_g0, k) * ga : 0.0f;
}

using Plane = float[kHaloY][kHaloX];

// F_0 through the face between plane lo (c - e_0) and plane hi (c), at
// halo cell (r, s)
template <int F>
__device__ __forceinline__ float flux0(const Plane& lo, const Plane& hi,
                                       int r, int s, float invh, float inv4h,
                                       float inv_g0, const NuConst& k) {
  const float ga = invh * (hi[r][s] - lo[r][s]);
  const float t1 = inv4h * ((hi[r + 1][s] - hi[r - 1][s]) +
                            (lo[r + 1][s] - lo[r - 1][s]));
  const float t2 = inv4h * ((hi[r][s + 1] - hi[r][s - 1]) +
                            (lo[r][s + 1] - lo[r][s - 1]));
  return flux<F>(ga, t1, t2, inv_g0, k);
}

// F_1 through the face between halo rows r - 1 and r of plane c
template <int F>
__device__ __forceinline__ float flux1(const Plane& m, const Plane& c,
                                       const Plane& p, int r, int s,
                                       float invh, float inv4h, float inv_g0,
                                       const NuConst& k) {
  const float ga = invh * (c[r][s] - c[r - 1][s]);
  const float t0 = inv4h * ((p[r][s] - m[r][s]) + (p[r - 1][s] - m[r - 1][s]));
  const float t2 = inv4h * ((c[r][s + 1] - c[r][s - 1]) +
                            (c[r - 1][s + 1] - c[r - 1][s - 1]));
  return flux<F>(ga, t0, t2, inv_g0, k);
}

// F_2 through the face between halo columns s - 1 and s of plane c
template <int F>
__device__ __forceinline__ float flux2(const Plane& m, const Plane& c,
                                       const Plane& p, int r, int s,
                                       float invh, float inv4h, float inv_g0,
                                       const NuConst& k) {
  const float ga = invh * (c[r][s] - c[r][s - 1]);
  const float t0 = inv4h * ((p[r][s] - m[r][s]) + (p[r][s - 1] - m[r][s - 1]));
  const float t1 = inv4h * ((c[r + 1][s] - c[r - 1][s]) +
                            (c[r + 1][s - 1] - c[r - 1][s - 1]));
  return flux<F>(ga, t0, t1, inv_g0, k);
}

template <int F>
__global__ void __launch_bounds__(kThreads)
mond_source_march(const float* __restrict__ phi, float* __restrict__ out,
                  int nz, int ny, int nx, int run, float invh, float inv4h,
                  float inv_g0, NuConst k) {
  __shared__ float ring[kRing][kHaloY][kHaloX];
  __shared__ float f1[2][kRows + 1][kLanes];  // F_1 at the face rows
  __shared__ float f2[2][kRows][kLanes + 1];  // F_2 at the face columns
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kLanes + tx;
  const int x0 = blockIdx.x * kLanes, y0 = blockIdx.y * kRows;
  const int z0 = blockIdx.z * run;
  const int z1 = min(z0 + run, nz);
  const size_t plane = static_cast<size_t>(ny) * nx;

  // the halo cells this thread loads: halo (hy, hx) is the cell
  // ((y0 - 1 + hy) mod ny, (x0 - 1 + hx) mod nx) of a plane
  int off[kOwn], hy[kOwn], hx[kOwn];
  bool has[kOwn];
#pragma unroll
  for (int q = 0; q < kOwn; ++q) {
    const int h = tid + q * kThreads;
    has[q] = h < kHaloCells;
    hy[q] = h / kHaloX;
    hx[q] = h - hy[q] * kHaloX;
    off[q] = has[q] ? pmod(y0 - 1 + hy[q], ny) * nx + pmod(x0 - 1 + hx[q], nx)
                    : 0;
  }
  // plane z sits in ring slot (z - z0 + 1) mod 4
  auto load = [&](int z, float (&v)[kOwn]) {
    const float* src = phi + static_cast<size_t>(pmod(z, nz)) * plane;
#pragma unroll
    for (int q = 0; q < kOwn; ++q) v[q] = has[q] ? __ldg(src + off[q]) : 0.0f;
  };
  auto store = [&](int z, const float (&v)[kOwn]) {
    Plane& dst = ring[(z - z0 + 1) & (kRing - 1)];
#pragma unroll
    for (int q = 0; q < kOwn; ++q) {
      if (has[q]) dst[hy[q]][hx[q]] = v[q];
    }
  };
  {
    float v[kOwn];
    for (int z = z0 - 1; z <= z0 + 1; ++z) {
      load(z, v);
      store(z, v);
    }
  }
  __syncthreads();

  const int r = ty + 1, s = tx + 1;  // this thread's cell in the halo tile
  const int y = y0 + ty, x = x0 + tx;
  const bool own = y < ny && x < nx;
  float lower = flux0<F>(ring[0], ring[1], r, s, invh, inv4h, inv_g0, k);

  for (int z = z0; z < z1; ++z) {
    const bool ahead = z + 2 <= z1;  // the run's next plane needs z + 2
    float v[kOwn];
    if (ahead) load(z + 2, v);
    const Plane& pm = ring[(z - z0) & (kRing - 1)];
    const Plane& pc = ring[(z - z0 + 1) & (kRing - 1)];
    const Plane& pp = ring[(z - z0 + 2) & (kRing - 1)];
    const int b = (z - z0) & 1;
    const float upper = flux0<F>(pc, pp, r, s, invh, inv4h, inv_g0, k);
    f1[b][ty][tx] = flux1<F>(pm, pc, pp, r, s, invh, inv4h, inv_g0, k);
    f2[b][ty][tx] = flux2<F>(pm, pc, pp, r, s, invh, inv4h, inv_g0, k);
    if (ty == 0) {
      f1[b][kRows][tx] =
          flux1<F>(pm, pc, pp, kRows + 1, s, invh, inv4h, inv_g0, k);
    } else if (ty == 1 && tx < kRows) {
      f2[b][tx][kLanes] =
          flux2<F>(pm, pc, pp, tx + 1, kLanes + 1, invh, inv4h, inv_g0, k);
    }
    if (ahead) store(z + 2, v);
    // the fluxes of plane z and the ring's plane z + 2 complete; the
    // buffers written next plane were last read before the previous
    // barrier
    __syncthreads();
    if (own) {
      float o = 0.0f + invh * (upper - lower);
      o = o + invh * (f1[b][ty + 1][tx] - f1[b][ty][tx]);
      o = o + invh * (f2[b][ty][tx + 1] - f2[b][ty][tx]);
      out[static_cast<size_t>(z) * plane + static_cast<size_t>(y) * nx + x] =
          o;
    }
    lower = upper;
  }
}

template <int F>
void launch(const float* phi, float* out, int nz, int ny, int nx, float invh,
            float inv4h, float inv_g0, NuConst k, cudaStream_t st) {
  const int gx = (nx + kLanes - 1) / kLanes;
  const int gy = (ny + kRows - 1) / kRows;
  int run = nz;
  while (run > 1 && gx * gy * ((nz + run - 1) / run) < kTargetBlocks) {
    run = (run + 1) / 2;
  }
  const dim3 grid(gx, gy, (nz + run - 1) / run);
  mond_source_march<F><<<grid, dim3(kLanes, kRows), 0, st>>>(
      phi, out, nz, ny, nx, run, invh, inv4h, inv_g0, k);
}

}  // namespace

// out = the QUMOND source of phi, both (nz, ny, nx) float32 in C order,
// periodic on each axis by its own length; invh, inv4h and inv_g0 are the
// plain form's float32 1/h, 1/(4h) and 1/g0, family the numbering of
// mond._FAMILIES and alpha the configuration's mond_alpha (unused by the
// simple family). Returns the CUDA error of the launch (0 on success).
extern "C" int pysco_mond_source(const float* phi, float* out, int nz, int ny,
                                 int nx, float invh, float inv4h,
                                 float inv_g0, int family, double alpha,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  NuConst k{0.0f, 0.0f, 0.0f};
  switch (family) {
    case kSimple:
      launch<kSimple>(phi, out, nz, ny, nx, invh, inv4h, inv_g0, k, st);
      break;
    case kN: {
      const int n = static_cast<int>(alpha);
      k.e1 = static_cast<float>(-n);
      k.e2 = static_cast<float>(1.0 / n);
      launch<kN>(phi, out, nz, ny, nx, invh, inv4h, inv_g0, k, st);
      break;
    }
    case kBeta:
      k.c = static_cast<float>(alpha);
      launch<kBeta>(phi, out, nz, ny, nx, invh, inv4h, inv_g0, k, st);
      break;
    case kGamma:
      k.e1 = static_cast<float>(0.5 * alpha);
      k.e2 = static_cast<float>(-1.0 / alpha);
      k.c = static_cast<float>(1.0 - 1.0 / alpha);
      launch<kGamma>(phi, out, nz, ny, nx, invh, inv4h, inv_g0, k, st);
      break;
    case kDelta:
      k.e1 = static_cast<float>(0.5 * alpha);
      k.e2 = static_cast<float>(-1.0 / alpha);
      launch<kDelta>(phi, out, nz, ny, nx, invh, inv4h, inv_g0, k, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
