// One colour half of the packed red-black nonlinear sweep of the f(R)
// scalaron, for Hopper, sm_90a, with three roots: a float32 Newton polish
// (scalaron_sweep_kernel), the float64 closed-form cubic of n = 1
// (scalaron_exact_sweep_kernel) and the float64 closed-form quartic of
// n = 2 (scalaron_quartic_exact_sweep_kernel). All three share one
// blocking (sweep_march). The guarded Newton root also runs alone, a
// thread a cell (newton_root_kernel), where the caller forms p itself
// (the slab FAS).
//
// The Newton form replaces pysco_tpu/ops/pallas_stencil.py::
// scalaron_half_sweep, which streams blocks of x-planes of the (n, n/2, n)
// half-lattices through VMEM with one periodic halo plane on each side,
// exactly as its linear sibling half_sweep.
//
// Per cell of the to_red colour (else black), with k = Power:
//   p   = hb - (1/6) (x-^k + x+^k + y-^k + y+^k + z-^k + z+^k)
//   x   = dst, then 3 Newton steps on x^(k+1) + p x + c0 = 0
//         cubic   (k = 2): f = x (x x + p) + c0,       f' = (3 x) x + p
//         quartic (k = 3): f = (x2 x2 + p x) + c0,     f' = (4 x2) x + p
//         f' = |f'| < 1e-12 ? 1e-12 : f';  x = x - f / f'
//         guarded where the steps leave the root's bracket [0, top], top
//         = max(2 dst, bracket_top(p, c0)): the first step's f' <= 1e-12
//         before it is held, or the first or the last iterate negative,
//         not finite or above top; a guarded cell takes safe_root(p, c0)
//         instead (float32 Newton steps down from bracket_top)
//   out = dst + f_relax (x - dst)
// c0 is one scalar (no FAS rhs: h^2 q) or a plane (h^2 q - rhs), as the
// caller folds it (models/laplacian.py packed_scalaron_smoothing). Every
// expression is the twin's (ops/stencil.py scalaron_half_sweep_plain),
// operand for operand; built with --fmad=false and IEEE division, the two
// agree bitwise. Deep screening, where the root nears 0 and a cell's seed
// is left over from a larger u, makes seeds below the root with f' near 0
// or below: an unguarded step from there flies far above the root, which
// three steps cannot undo, or below 0, and the FAS V-cycle then diverges
// (f(R) at 512^3 in 500 Mpc/h broke at z ~ 4 so). A guarded cell is rare
// (16 with CIC and 5 with TSC for n = 1, 51 for n = 2, of some 9 million
// cell updates in 32^3 runs from z = 49 to 0 in 32 Mpc/h), and a thread
// that met one adds its count to counts[0] when the caller passes the
// profiler's counters. The guard
// costs a compare a step, the first iterate kept, and bracket_top's square
// roots only where an iterate passes twice the seed.
//
// The exact form replaces no TPU kernel: the JAX package takes these roots
// in plain jnp (models/cubic.py solution_cubic_equation), and so did the
// port, in some 45 torch passes a colour update. It computes the same p
// (k = 2) in float32, widens it, and takes the real root of
// u^3 + p u + d1/27 = 0 in float64, with d1 = 27 h^2 q (a double argument)
// or 27 h^2 q - 27 rhs (rhs read as float32 and widened): only on the
// branch the twin (ops/stencil.py solution_cubic_equation) selects, with
// the libdevice calls torch's float64 kernels make (sqrt, pow, acos, cos),
// then casts the root to float32 and relaxes as above. Built with
// --fmad=false, as the Newton form must be, its libdevice pow(x, 1.5)
// rounds 1 float64 ulp away from torch's (built with the default
// --fmad=true, which contracts a product and a sum inside it) for about
// 4.5 in a million x (50 million x from 1e-12 to 1e3, CUDA 12.8); sqrt,
// acos, cos and pow(x, 1/3) matched on every value tried. A float64 ulp moves
// the float32 result only where it lies within one float64 ulp of a
// float32 rounding boundary, so the sweep's output agrees bitwise with
// the twin's on every state tried, and is held to one float32 ulp on the
// cells where pow differs.
//
// The quartic form replaces no TPU kernel either: the JAX package takes
// n = 2's roots in plain jnp (models/quartic.py solution_quartic_equation),
// and so did the port, in some 35 float64 torch passes a colour update and
// two float64 coefficient planes. It computes p (k = 3) in float32 as the
// Newton form does, widens it, and takes the root of u^4 + p u + c = 0 in
// float64, c = h^2 q (a double argument) or h^2 q - rhs (rhs read as
// float32 and widened), on the branch the twin (ops/stencil.py
// solution_quartic_equation) keeps: the resolvent-cubic root, or the
// fallback |c|^(1/4) where p == 0, where the square root's argument is
// negative, or where Q + d0/Q is not positive (NaN included), each
// computed only on the cells that take it. It casts the root to float32
// and relaxes as above. The twin divides by the Python float 3.0, which
// torch's CUDA kernel takes as a product with the double reciprocal
// 1.0 / 3.0: so does this form. Its libdevice pow (the cube root, and
// the fallback's |c|^(1/4)) may round a float64 ulp away from torch's as
// the cubic's pow(x, 1.5) does (see below); where Q + d0/Q cancels, that
// ulp can move the cell to another branch or a distant root
// (tests/exact_root_states.py quartic_off_cells says which cells may).
//
// What bounds them on the card. The Newton form: bytes. Per cell it must
// read 4 B each of src, dst and hb (and the coef plane) and write 4 B: at
// 256^3 a call moves 4 x 33.5 MB (5 x with the plane), >= 0.040 ms (0.050
// ms) at 3.35 TB/s. The ~50 float32 operations a cell (one division per
// Newton step) take under 10 us at 67 TFLOP/s. The exact form moves the
// same 16 B a cell (20 with the rhs plane: 0.32 / 0.40 ms at 512^3) and
// executes the float64 instructions of its cell's branch (a sqrt and a
// cube root by pow and a division for Cardano; pow, sqrt, acos and cos in
// software for the trigonometric root), which at 132 SMs x 64 float64
// lanes x 1.98 GHz take longer than the bytes (chip_smoke.py counts them
// in the SASS, branch by branch, for the kernel's bound); libdevice's
// pow, acos and cos carry integer and control instructions besides. Its
// design keeps every float64 value in registers (the torch passes wrote
// a dozen float64 planes), computes one branch per cell instead of all
// three, and lets 3 blocks share an SM (at most 85 registers a thread:
// ptxas takes 78-80 and spills nothing; 2 blocks ran 18% slower at 512^3,
// 4 spill) with about 4096 blocks a launch, so that the float64 latencies
// are hidden. The quartic form moves the same bytes; its main branch is a
// pow, three sqrt and three divisions in float64. It takes the same design
// with constants of its own, measured at 512^3 on an H100: 3 blocks an SM
// (80 registers, no spill; 2 blocks ran 20% slower, 4 spill 40-64 bytes for
// a 2-4% gain) and about 8192 blocks a launch (1% faster than 4096, 3%
// than 1024).
//
// The design (2.5-D blocking): a block owns a tile of up to 8 packed rows
// (jp) x 128 z cells and marches along x over a run of planes. Each thread
// owns 4 consecutive z cells of one row and moves them as one float4 (dst,
// hb, the coef plane, out). src^k of the plane being updated sits in shared
// memory with a one-row y halo and a one-cell z halo; src^k of the planes
// before and after it stays in the thread's registers and moves down the
// queue as the block marches. So each src value is read from device memory
// once per run (plus the halo and the two planes that bound the run) and
// raised to the power once; the loads of the next plane are issued before
// the current plane is computed. A 3-D grid of blocks (z tiles, y tiles,
// runs) needs no runtime division. The run length is chosen so that about
// 1024 blocks fill the card (4 blocks of 256 threads an SM for the Newton
// form, the registers bounded to let them in; 4096 and 3 for the exact
// form).
//
// Each thread reads only its own dst cells and the other colour, so out may
// be dst (an in-place update). n must be a multiple of 4 (one float4), and
// every array 16-byte aligned; the wrapper checks both.

#include "stencil.cuh"

namespace {

using pysco::kInvSix;
using pysco::periodic;
using pysco::power_of;

// float32(1e-12) rounded from the double, as numpy's float32(1e-12)
constexpr float kNewtonEps = static_cast<float>(1e-12);
// the Newton steps of a guarded cell's root, at most (the twin's
// SAFE_ROOT_STEPS)
constexpr int kSafeRootSteps = 64;

constexpr int kVec = 4;                    // z cells of a thread: one float4
constexpr int kTileZ = 128;                // z cells of a tile
constexpr int kTileY = 8;                  // packed rows of a tile
constexpr int kThreads = kTileZ / kVec * kTileY;
constexpr int kRow = kTileZ + 2 * kVec;    // a float4 of halo room each side
constexpr int kTargetBlocks = 1024;
// at most 64 registers a thread, so that 4 blocks share an SM (the 72-80
// registers ptxas takes unbounded let only 3 in)
constexpr int kBlocksPerSM = 4;
// the exact form: at most 85 registers a thread, for the float64 code
constexpr int kExactBlocksPerSM = 3;
constexpr int kExactTargetBlocks = 4096;
// the quartic form: at most 85 registers a thread (ptxas takes 80)
constexpr int kQuarticBlocksPerSM = 3;
constexpr int kQuarticTargetBlocks = 8192;

// the twin's Python constants: 1/3, 2 pi (math.pi doubled), both exact
constexpr double kThird = 1.0 / 3.0;
constexpr double kTwoPi = 2.0 * 3.141592653589793;

// f / fp, rounded as IEEE division rounds it. A zero f -- every Newton step
// of a converged cell -- sends the division down its slow path (chip_smoke
// phase 3 times a sweep of converged cells), so its quotient is written
// out: a zero whose sign is the xor of the operands' (fp is never zero
// here; a NaN fp still divides).
__device__ __forceinline__ float quotient(float f, float fp) {
  if (f == 0.0f && fp == fp) {
    return __int_as_float((__float_as_int(f) ^ __float_as_int(fp)) &
                          static_cast<int>(0x80000000u));
  }
  return f / fp;
}

// f and f' of u^(Power+1) + p u + c0 at x, in the twin's order
template <int Power>
__device__ __forceinline__ void poly(float x, float p, float c0, float& f,
                                     float& fp) {
  if (Power == 2) {
    f = x * (x * x + p) + c0;
    fp = (3.0f * x) * x + p;
  } else {
    const float x2 = x * x;
    f = (x2 * x2 + p * x) + c0;
    fp = (4.0f * x2) * x + p;
  }
}

// An upper bound of every positive root of u^(Power+1) + p u + c0 = 0 from
// square roots alone (the twin's _bracket_top): A = max(-p, 0), C = |c0|;
// A^(1/2) + C^(1/3) for the cubic, A^(1/3) + C^(1/4) for the quartic, each
// cube root bounded by the square root above 1 and the fourth root below.
template <int Power>
__device__ __forceinline__ float bracket_top(float p, float c0) {
  const float a = -p > 0.0f ? -p : 0.0f;
  const float c = fabsf(c0);
  if (Power == 2) return sqrtf(a) + (c <= 1.0f ? sqrtf(sqrtf(c)) : sqrtf(c));
  return (a <= 1.0f ? sqrtf(sqrtf(a)) : sqrtf(a)) + sqrtf(sqrtf(c));
}

// iters float32 Newton steps from the seed x. guarded is set where the
// steps leave the root's bracket [0, top], top = max(2 x, bracket_top):
// the first step meets f' at or below kNewtonEps (NaN included), or the
// first or the last iterate is negative, not finite or above top (for c0 <
// 0 and a seed above 0 the first step decides: the steps after it fall
// monotonically). Where it is not set the steps are those of the
// unguarded polish, bit for bit. bracket_top is taken only where an
// iterate passes 2 x: a converging cell never needs it.
template <int Power>
__device__ __forceinline__ float newton_root(float x, float p, float c0,
                                             int iters, bool& guarded) {
  const float seed = x;
  float first = x;
  bool bad = false;
  for (int it = 0; it < iters; ++it) {
    float f, fp;
    poly<Power>(x, p, c0, f, fp);
    if (it == 0) bad = !(fp > kNewtonEps);
    fp = fabsf(fp) < kNewtonEps ? kNewtonEps : fp;
    x = x - quotient(f, fp);
    if (it == 0) first = x;
  }
  const float most = fmaxf(first, x);
  guarded = iters > 0 &&
            (bad || !(fminf(first, x) >= 0.0f) || x != x ||
             (most > 2.0f * seed && most > bracket_top<Power>(p, c0)));
  return x;
}

// sign(v) |v|^(1/3), the twin's _cbrt: torch.sign is (0 < v) - (v < 0),
// so 0 at zeros and NaN
__device__ __forceinline__ double signed_cbrt(double v) {
  const double s = static_cast<double>((0.0 < v) - (v < 0.0));
  return s * pow(fabs(v), kThird);
}

// The roots of u^3 + p u + d1/27 = 0 on the three branches of the twin's
// nested torch.where, d = d1^2 + 108 p^3. d == 0 (or NaN): -cbrt(d1)/3.
__device__ __forceinline__ double zero_root(double d1) {
  return -kThird * signed_cbrt(d1);
}

// d > 0: Cardano; where dd == 0 the twin takes zero_root, here by the same
// one cube root of d1 in place of 0.5 dd
__device__ __forceinline__ double cardano_root(double p, double d1,
                                               double d) {
  const double dd = d1 + sqrt(d);
  const double C = signed_cbrt(dd == 0.0 ? d1 : 0.5 * dd);
  return dd == 0.0 ? -kThird * C : -kThird * (C - 3.0 * p / C);
}

// d < 0: three real roots, the trigonometric one at (theta + 2 pi)/3
__device__ __forceinline__ double trig_root(double p, double d1) {
  const double d0 = -3.0 * p;
  const double dn = d1 / (2.0 * pow(d0, 1.5));
  // torch.clamp keeps a NaN
  const double cl = dn != dn ? dn : fmin(fmax(dn, -1.0), 1.0);
  return -2.0 * kThird * sqrt(d0) * cos(kThird * (acos(cl) + kTwoPi));
}

// The real root on the branch the twin keeps, that branch's work alone
__device__ __forceinline__ double cubic_root(double p, double d1) {
  const double d = d1 * d1 + 108.0 * (p * p * p);
  if (d > 0.0) return cardano_root(p, d1, d);
  if (d < 0.0) return trig_root(p, d1);
  return zero_root(d1);
}

// |c|^(1/4), the quartic twin's fallback (torch.abs(q) ** 0.25)
__device__ __forceinline__ double quartic_fallback(double c) {
  return pow(fabs(c), 0.25);
}

// torch.clamp(v, min=0), which keeps a NaN
__device__ __forceinline__ double clamp_min0(double v) {
  return v != v ? v : fmax(v, 0.0);
}

// d0 = 12 c, d1 = 27 p^2 and the resolvent's square-root argument
// sqrt_term = 1 - 4 d0 (d0 / d1)^2 (the twin's d1_safe is d1: p != 0 here)
struct QuarticHead {
  double d0, d1, sqrt_term;
};

__device__ __forceinline__ QuarticHead quartic_head(double p, double c) {
  const double d0 = 12.0 * c;
  const double d1 = 27.0 * p * p;
  const double ratio = d0 / d1;
  return {d0, d1, 1.0 - 4.0 * d0 * (ratio * ratio)};
}

// Q + d0/Q, Q the resolvent's real cube root (sqrt_term >= 0 or NaN here)
__device__ __forceinline__ double quartic_q_d0oq(const QuarticHead& h) {
  const double Q = signed_cbrt(0.5 * h.d1 * (1.0 + sqrt(h.sqrt_term)));
  const double Q_safe = Q == 0.0 ? 1.0 : Q;
  return Q_safe + h.d0 / Q_safe;
}

// The root from Q + d0/Q > 0, for p > 0 (PPos) or p < 0; the twin's
// "/ 3.0" as torch's CUDA kernel computes it, a product with 1.0 / 3.0
template <bool PPos>
__device__ __forceinline__ double quartic_tail(double p, double q_d0oq) {
  const double S = 0.5 * sqrt(q_d0oq * kThird);
  const double S_safe = S == 0.0 ? 1.0 : S;
  if (PPos) return -S + 0.5 * sqrt(clamp_min0(-4.0 * S * S + p / S_safe));
  return S + 0.5 * sqrt(clamp_min0(-4.0 * S * S - p / S_safe));
}

// The real root of u^4 + p u + c = 0 on the branch the twin's nested
// torch.where keeps (p == 0, then sqrt_term < 0, then Q + d0/Q not
// positive, NaN included: the fallback; else the tail of p's sign), that
// branch's work alone, in the twin's order of operations
__device__ __forceinline__ double quartic_root(double p, double c) {
  if (p == 0.0) return quartic_fallback(c);
  const QuarticHead h = quartic_head(p, c);
  if (h.sqrt_term < 0.0) return quartic_fallback(c);
  const double q_d0oq = quartic_q_d0oq(h);
  if (!(q_d0oq > 0.0)) return quartic_fallback(c);
  return p > 0.0 ? quartic_tail<true>(p, q_d0oq)
                 : quartic_tail<false>(p, q_d0oq);
}

// The root a guarded cell takes (the twin's safe_root): float32 Newton
// steps from bracket_top, which lies above every positive root, while a
// step lowers u (at most kSafeRootSteps). The polynomial is convex for u >
// 0, so the steps fall monotonically onto its largest positive root: for
// c0 < 0 the only one, PySCo's. Where c0 >= 0 (a coarse FAS level's rhs
// above h^2 q) and no positive root exists, they stop where u no longer
// falls. Inline and in float32: a call, or float64 registers, in the
// cell's loop would cost every cell (spills at 64 registers).
template <int Power>
__device__ __forceinline__ float safe_root(float p, float c0) {
  float x = bracket_top<Power>(p, c0);
  for (int it = 0; it < kSafeRootSteps; ++it) {
    float f, fp;
    poly<Power>(x, p, c0, f, fp);
    fp = fabsf(fp) < kNewtonEps ? kNewtonEps : fp;
    const float next = x - quotient(f, fp);
    if (!(next < x)) break;
    x = next;
  }
  return x;
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <int Power>
__device__ __forceinline__ float4 power4(float4 v) {
  return make_float4(power_of<Power>(v.x), power_of<Power>(v.y),
                     power_of<Power>(v.z), power_of<Power>(v.w));
}

__device__ __forceinline__ float lane(const float4& v, int c) {
  return c == 0 ? v.x : (c == 1 ? v.y : (c == 2 ? v.z : v.w));
}

// src values of one plane that a thread loads: its own 4 cells, 4 cells of
// a halo row (threads of rows 0 and 1), and the z halo cells at the ends of
// those rows (the tile's first and last threads)
struct PlaneLoad {
  float4 own, hrow;
  float own_lo, own_hi, h_lo, h_hi;
};

// The blocked march of one colour update over the block's tile and run of
// planes. update(old, p, cv) is a cell's new value from its dst value, its
// p and its coef-plane value cv (0 without the plane).
template <int Power, bool CoefPlane, typename Update>
__device__ __forceinline__ void sweep_march(
    const float* __restrict__ src, const float* dst,
    const float* __restrict__ hb, const float* __restrict__ coef_plane,
    float* out, int n, int run, int to_red, Update update) {
  __shared__ __align__(16) float plane[kTileY + 2][kRow];
  const int hp = n / 2;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int z0 = blockIdx.x * blockDim.x * kVec;
  const int tw = min(n - z0, static_cast<int>(blockDim.x) * kVec);
  const int jp0 = blockIdx.y * blockDim.y;
  const int jr = min(hp - jp0, static_cast<int>(blockDim.y));
  const int i0 = blockIdx.z * run;
  const int i1 = min(i0 + run, n);
  const int k = z0 + kVec * tx;
  const int jp = jp0 + ty;
  const bool col = kVec * tx < tw;
  const bool own = col && ty < jr;
  const bool lo = tx == 0, hi = kVec * (tx + 1) == tw;
  // threads of row 0 load the row before the tile, of row 1 the row after
  const bool hrow = col && ty < 2;
  const int hjp = ty == 0 ? periodic(jp0 - 1, hp) : periodic(jp0 + jr, hp);
  const int hr = ty == 0 ? 0 : jr + 1;  // its row in shared memory
  const int zlo = periodic(z0 - 1, n), zhi = periodic(z0 + tw, n);
  const long long plane_cells = static_cast<long long>(hp) * n;

  auto load_plane = [&](int ii, PlaneLoad& L) {
    const float* s = src + ii * plane_cells;
    if (own) {
      L.own = load4(s + jp * n + k);
      if (lo) L.own_lo = s[jp * n + zlo];
      if (hi) L.own_hi = s[jp * n + zhi];
    }
    if (hrow) {
      L.hrow = load4(s + hjp * n + k);
      if (lo) L.h_lo = s[hjp * n + zlo];
      if (hi) L.h_hi = s[hjp * n + zhi];
    }
  };
  // src^k of a loaded plane into shared memory (own cells as given)
  auto store_plane = [&](const PlaneLoad& L, const float4& own_pow) {
    if (own) {
      float* row = plane[ty + 1];
      *reinterpret_cast<float4*>(row + kVec + kVec * tx) = own_pow;
      if (lo) row[kVec - 1] = power_of<Power>(L.own_lo);
      if (hi) row[kVec + tw] = power_of<Power>(L.own_hi);
    }
    if (hrow) {
      float* row = plane[hr];
      *reinterpret_cast<float4*>(row + kVec + kVec * tx) =
          power4<Power>(L.hrow);
      if (lo) row[kVec - 1] = power_of<Power>(L.h_lo);
      if (hi) row[kVec + tw] = power_of<Power>(L.h_hi);
    }
  };

  PlaneLoad L;
  load_plane(periodic(i0 - 1, n), L);
  float4 pm = power4<Power>(L.own);  // src^k of plane i - 1
  load_plane(i0, L);
  float4 pc = power4<Power>(L.own);  // src^k of plane i
  store_plane(L, pc);
  for (int i = i0; i < i1; ++i) {
    PlaneLoad N;
    load_plane(periodic(i + 1, n), N);
    const long long at = (i * plane_cells + jp * n) + k;
    float4 d4, h4, c4;
    if (own) {
      d4 = load4(dst + at);
      h4 = load4(hb + at);
      if (CoefPlane) c4 = load4(coef_plane + at);
    }
    const float4 pn = power4<Power>(N.own);  // src^k of plane i + 1
    __syncthreads();  // plane i complete in shared memory
    if (own) {
      const float* row = plane[ty + 1] + kVec + kVec * tx;
      const float* below = plane[ty] + kVec + kVec * tx;
      const float* above = plane[ty + 2] + kVec + kVec * tx;
      float r[kVec];
#pragma unroll
      for (int c = 0; c < kVec; ++c) {
        const bool s1 = ((i + k + c) & 1) == 1;
        const float cen = row[c];
        // red with s = 1 and black with s = 0 have their y- neighbour one
        // row down; the others have their y+ neighbour one row up
        const bool down = to_red ? s1 : !s1;
        const float ym = down ? below[c] : cen;
        const float yp = down ? cen : above[c];
        float nb = lane(pm, c) + lane(pn, c);
        nb = nb + ym;
        nb = nb + yp;
        nb = nb + row[c - 1];
        nb = nb + row[c + 1];
        const float p = lane(h4, c) - kInvSix * nb;
        r[c] = update(lane(d4, c), p, CoefPlane ? lane(c4, c) : 0.0f);
      }
      *reinterpret_cast<float4*>(out + at) = make_float4(r[0], r[1], r[2],
                                                         r[3]);
    }
    __syncthreads();  // every read of plane i done
    if (i + 1 < i1) store_plane(N, pn);
    pm = pc;
    pc = pn;
  }
}

template <int Power, bool CoefPlane>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
scalaron_sweep_kernel(const float* __restrict__ src, const float* dst,
                      const float* __restrict__ hb,
                      const float* __restrict__ coef_plane, float coef,
                      float* out, int n, int run, int to_red, float f_relax,
                      int newton_iters,
                      unsigned long long* __restrict__ counts) {
  unsigned int guarded_cells = 0;
  sweep_march<Power, CoefPlane>(
      src, dst, hb, coef_plane, out, n, run, to_red,
      [&](float old, float p, float cv) {
        const float c0 = CoefPlane ? cv : coef;
        bool guarded;
        float x = newton_root<Power>(old, p, c0, newton_iters, guarded);
        if (guarded) {
          x = safe_root<Power>(p, c0);
          ++guarded_cells;
        }
        return old + f_relax * (x - old);
      });
  // a guarded cell is rare: one atomic a thread that met any
  if (counts != nullptr && guarded_cells != 0) {
    atomicAdd(&counts[0], static_cast<unsigned long long>(guarded_cells));
  }
}

// The exact form, f(R) n = 1 (k = 2): d1 = d1_q [- 27 rhs].
template <bool RhsPlane>
__global__ void __launch_bounds__(kThreads, kExactBlocksPerSM)
scalaron_exact_sweep_kernel(const float* __restrict__ src, const float* dst,
                            const float* __restrict__ hb,
                            const float* __restrict__ rhs, double d1_q,
                            float* out, int n, int run, int to_red,
                            float f_relax) {
  sweep_march<2, RhsPlane>(
      src, dst, hb, rhs, out, n, run, to_red,
      [&](float old, float p, float r) {
        const double d1 =
            RhsPlane ? d1_q - 27.0 * static_cast<double>(r) : d1_q;
        const float x =
            static_cast<float>(cubic_root(static_cast<double>(p), d1));
        return old + f_relax * (x - old);
      });
}

// The exact form, f(R) n = 2 (k = 3): c = c_q [- rhs].
template <bool RhsPlane>
__global__ void __launch_bounds__(kThreads, kQuarticBlocksPerSM)
scalaron_quartic_exact_sweep_kernel(const float* __restrict__ src,
                                    const float* dst,
                                    const float* __restrict__ hb,
                                    const float* __restrict__ rhs,
                                    double c_q, float* out, int n, int run,
                                    int to_red, float f_relax) {
  sweep_march<3, RhsPlane>(
      src, dst, hb, rhs, out, n, run, to_red,
      [&](float old, float p, float r) {
        const double c = RhsPlane ? c_q - static_cast<double>(r) : c_q;
        const float x =
            static_cast<float>(quartic_root(static_cast<double>(p), c));
        return old + f_relax * (x - old);
      });
}

// The block and grid of a sweep over the (n, n/2, n) half-lattice, and the
// run of planes a block marches over: about target blocks.
struct Launch {
  dim3 grid, block;
  int run;
};

Launch launch_shape(int n, int target) {
  const int hp = n / 2;
  const dim3 block(min(n, kTileZ) / kVec, min(hp, kTileY));
  const int gx = (n + block.x * kVec - 1) / (block.x * kVec);
  const int gy = (hp + block.y - 1) / block.y;
  int run = n;
  while (run > 2 && gx * gy * ((n + run - 1) / run) < target) {
    run /= 2;
  }
  return {dim3(gx, gy, (n + run - 1) / run), block, run};
}

template <int Power>
void launch(const float* src, const float* dst, const float* hb,
            const float* coef_plane, float coef, float* out, int n,
            int to_red, float f_relax, int newton_iters,
            unsigned long long* counts, cudaStream_t st) {
  const Launch l = launch_shape(n, kTargetBlocks);
  if (coef_plane != nullptr) {
    scalaron_sweep_kernel<Power, true><<<l.grid, l.block, 0, st>>>(
        src, dst, hb, coef_plane, coef, out, n, l.run, to_red, f_relax,
        newton_iters, counts);
  } else {
    scalaron_sweep_kernel<Power, false><<<l.grid, l.block, 0, st>>>(
        src, dst, hb, coef_plane, coef, out, n, l.run, to_red, f_relax,
        newton_iters, counts);
  }
}

// The guarded root alone, a thread a cell over a grid stride: the slab
// FAS (parallel/slab_mg.py) forms p from its shards' halos in torch and
// takes the root here, with no neighbour sum and no relaxation.
template <int Power, bool CoefPlane>
__global__ void __launch_bounds__(256)
newton_root_kernel(const float* __restrict__ x, const float* __restrict__ p,
                   const float* __restrict__ coef_plane, float coef,
                   float* out, long long cells, int newton_iters) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < cells; i += stride) {
    const float pv = p[i];
    const float c0 = CoefPlane ? coef_plane[i] : coef;
    bool guarded;
    const float r = newton_root<Power>(x[i], pv, c0, newton_iters, guarded);
    out[i] = guarded ? safe_root<Power>(pv, c0) : r;
  }
}

template <int Power>
void launch_root(const float* x, const float* p, const float* coef_plane,
                 float coef, float* out, long long cells, int newton_iters,
                 cudaStream_t st) {
  const int block = 256;
  const long long want = (cells + block - 1) / block;
  const int grid = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  if (coef_plane != nullptr) {
    newton_root_kernel<Power, true><<<grid, block, 0, st>>>(
        x, p, coef_plane, coef, out, cells, newton_iters);
  } else {
    newton_root_kernel<Power, false><<<grid, block, 0, st>>>(
        x, p, coef_plane, coef, out, cells, newton_iters);
  }
}

}  // namespace

// The guarded Newton root of u^(power+1) + p u + c0 = 0 for each of cells
// float32 cells, from the seed x: newton_iters steps, or the safe root
// where they leave the root's bracket, as the sweep takes it (the twin:
// ops/stencil.py newton_root_plain). c0 is the plane coef_plane where it
// is not null, else the scalar coef. out may be x. Returns the CUDA error
// of the launch (0 on success), or cudaErrorInvalidValue for another
// power.
extern "C" int pysco_newton_root(const float* x, const float* p,
                                 const float* coef_plane, float coef,
                                 float* out, long long cells, int power,
                                 int newton_iters, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cells <= 0) return 0;
  if (power == 2) {
    launch_root<2>(x, p, coef_plane, coef, out, cells, newton_iters, st);
  } else if (power == 3) {
    launch_root<3>(x, p, coef_plane, coef, out, cells, newton_iters, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Update the to_red colour (else black) of the (n, n/2, n) half-lattice
// dst from the other colour src, for the neighbour power 2 (f(R) n = 1) or
// 3 (n = 2). coef_plane may be null, and then the scalar coef is c0. out
// may be dst. n must be a multiple of 4 and every array 16-byte aligned.
// counts, when not null, gains the cells whose Newton steps left the root's
// bracket and took the safe root (counts[0]). Returns the CUDA error of the
// launch (0 on success), or cudaErrorInvalidValue for another power or n.
extern "C" int pysco_scalaron_half_sweep(const float* src, const float* dst,
                                         const float* hb,
                                         const float* coef_plane, float coef,
                                         float* out, int n, int to_red,
                                         float f_relax, int power,
                                         int newton_iters,
                                         unsigned long long* counts,
                                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < kVec || n % kVec) return static_cast<int>(cudaErrorInvalidValue);
  if (power == 2) {
    launch<2>(src, dst, hb, coef_plane, coef, out, n, to_red, f_relax,
              newton_iters, counts, st);
  } else if (power == 3) {
    launch<3>(src, dst, hb, coef_plane, coef, out, n, to_red, f_relax,
              newton_iters, counts, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The same update of f(R) n = 1 with the float64 closed-form root:
// d1 = d1_q (27 h^2 q) where rhs is null, else d1_q - 27 rhs. out may be
// dst. n must be a multiple of 4 and every array 16-byte aligned. Returns
// the CUDA error of the launch (0 on success), or cudaErrorInvalidValue
// for another n.
extern "C" int pysco_scalaron_exact_half_sweep(
    const float* src, const float* dst, const float* hb, const float* rhs,
    double d1_q, float* out, int n, int to_red, float f_relax,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < kVec || n % kVec) return static_cast<int>(cudaErrorInvalidValue);
  const Launch l = launch_shape(n, kExactTargetBlocks);
  if (rhs != nullptr) {
    scalaron_exact_sweep_kernel<true><<<l.grid, l.block, 0, st>>>(
        src, dst, hb, rhs, d1_q, out, n, l.run, to_red, f_relax);
  } else {
    scalaron_exact_sweep_kernel<false><<<l.grid, l.block, 0, st>>>(
        src, dst, hb, rhs, d1_q, out, n, l.run, to_red, f_relax);
  }
  return static_cast<int>(cudaGetLastError());
}

// The same update of f(R) n = 2 with the float64 closed-form quartic root:
// c = c_q (h^2 q) where rhs is null, else c_q - rhs. out may be dst. n must
// be a multiple of 4 and every array 16-byte aligned. Returns the CUDA
// error of the launch (0 on success), or cudaErrorInvalidValue for
// another n.
extern "C" int pysco_scalaron_quartic_exact_half_sweep(
    const float* src, const float* dst, const float* hb, const float* rhs,
    double c_q, float* out, int n, int to_red, float f_relax,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < kVec || n % kVec) return static_cast<int>(cudaErrorInvalidValue);
  const Launch l = launch_shape(n, kQuarticTargetBlocks);
  if (rhs != nullptr) {
    scalaron_quartic_exact_sweep_kernel<true><<<l.grid, l.block, 0, st>>>(
        src, dst, hb, rhs, c_q, out, n, l.run, to_red, f_relax);
  } else {
    scalaron_quartic_exact_sweep_kernel<false><<<l.grid, l.block, 0, st>>>(
        src, dst, hb, rhs, c_q, out, n, l.run, to_red, f_relax);
  }
  return static_cast<int>(cudaGetLastError());
}
