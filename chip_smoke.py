#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pysco_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, one card

Phases (any failure exits non-zero, and nothing is carried past it):

1. device: require CUDA; print the card's name and power limit;
2. build: compile the hand-written kernels of ``pysco_tpu_torch/csrc``
   with nvcc and print the build time and ptxas report;
3. kernels vs their plain PyTorch twins on the card: deposit and gather
   for NGP/CIC/TSC at drift 0 and 3, uniform and clustered particles, on
   128^3, 256^3 and (z-blocked tiles) 512^3 grids, and both with every
   base on an edge of its window; two deposits must be bitwise equal, and
   the gather bitwise its twin, also with 1, 2 and 4 field components,
   each staging, and particles past their drift bound; kernel and twin
   times at 256^3 particles on 256^3 and at 512^3 on 512^3 (z-blocked),
   with the one-call yardsticks (index_add_ for the deposit, grid_sample
   for the gather);
   then the multigrid stencil kernels (half-sweep, f(R) scalaron
   half-sweep for n = 1 and 2 with a scalar and a plane coefficient,
   residual norm, fused restriction, prolongation) at n = 16, 128, 256
   and 512 (the prolongation and the residual norm also at n = 4, 6, 8,
   24, 36 and 132: the small and ragged grids), every residual kind with
   and without rhs, two residual norms bitwise equal; kernel and twin
   times at 256^3, the scalaron sweep's, the prolongation's and the
   residual norm's at 512^3 too (the sweep on random and converged
   cells; the norm per kind beside its bound, and its designs one
   against another: the plane march with 8 and 16 rows a tile, without
   its second launch, and one thread a cell), the prolongation beside
   the trilinear ``interpolate`` yardstick; the f(R) n = 1 sweep with
   the float64 closed-form root (no TPU kernel) bitwise its twin at n =
   4, 8, 64, 256 and 512 on ``tests/exact_root_states.py``'s states
   (cells on every branch of the closed form, a scalaron-like state), its
   float64 instructions counted branch by branch in its SASS, and its
   times at 256^3 and 512^3 beside its byte and float64 bounds and the
   twin's; the deposit's device time split between its kernel and the torch zeroing and fold; the slab call
   forms of the deposit and the gather (``deposit_slab``,
   ``gather_vec_slab``) at ``plane0 != 0`` on 128^3, 256^3 and 512^3
   (z-blocked), CIC and TSC, drift 0-2, a quarter of the grid and the
   thinnest slab allowed, with bases on the edges of their windows, two
   deposits bitwise equal and the gather bitwise its twin; four slab
   deposits and ``add_spill`` against the single-device deposit; both
   forms' times at 256^3 CIC for a whole grid and a quarter, with bounds;
   the deposit at 512^3 on three states, CIC and TSC at drift 0-3 (uniform,
   the z = 0 state of a seeded run of the benchmark's
   ``newton_fft_cic_512``, that state redrawn inside its tiles): the
   kernel's time beside its bound and, with ``--before-deposit``, an
   earlier kernel's in turns; on the z = 0 state two deposits bitwise
   equal at every drift, the mass kept, the kernel against its twin, the
   twin's and ``index_add_``'s times;
4. golden: the full-horizon configuration of
   ``tests/test_full_run_fidelity.py`` through ``pysco_tpu_torch.run``
   must match ``tests/golden_pk_32.json`` within 1e-4; two P(k) of one
   256^3 density must be bitwise equal;
5. main path at a realistic size: newton, fft, CIC, 2LPT, 256^3
   particles on a 256^3 grid, lazy re-binning, z = 49 -> 2, with
   snapshots (NumPy ``npz``: the format that needs neither h5py nor
   pyarrow) and P(k) in a temporary directory; the kernels must launch
   on every step;
6. multigrid e2e: the ``newton_multigrid_tsc_2lpt`` and
   ``mond_multigrid`` rows of ``tests/test_e2e.py`` (16^3) on the card
   and on the CPU through the port: P(k) within 1e-4, and two card runs
   with bitwise-equal final snapshots;
7. multigrid main path: newton, multigrid V-cycles, TSC, 2LPT, 256^3
   particles on a 256^3 grid, box 500 Mpc/h, lazy re-binning, z = 49 ->
   2, snapshots and P(k); all six kernels must launch on every step; the
   median step time, the V-cycles per solve and the multigrid
   components' times at 256^3;
8. QUMOND: multigrid at 128^3 for a few steps;
9. f(R) e2e: the ``fr_n1`` and ``fr_n2`` rows of ``tests/test_e2e.py``
   (16^3) twice on the card and once on the CPU: bitwise-equal card
   reruns, P(k) within 1e-4 of the CPU;
10. the f(R) main path, this slice's: ``fr_n1_cic_multigrid_512`` of
   ``bench.py``, 512^3 particles on a 512^3 grid, box 500 Mpc/h, CIC,
   2LPT on the device, V-cycles, lazy re-binning, fR_logfR0 = 5, z = 49
   -> 20, no initial snapshot; all seven kernels must launch on every
   step; the median step, V-cycles per FAS and per Poisson solve,
   mean(u), the device-IC seconds, the peak device memory and the FAS
   components' times at 512^3, the gather's at drift 0 and 1; then the
   rest of a lazy step itemised (kick, drift and wrap, the drift-bound
   count, the sources, the truncation error, the diagnostics) beside the
   force evaluation and the step as wholes, by CUDA events and by the
   host clock; then the same configuration with ``fR_root_solver =
   exact`` to z = 30: the exact-root sweep launched on every step, the
   Newton-root one never, its launches counted from zero;
11. f(R) n = 2: TSC, multigrid, 256^3 for a few steps;
12. the run extras: ``run_paired`` at the configuration of
   ``tests/test_e2e.py::test_run_paired`` (three output trees, the
   averaged P(k) the mean and the summed modes of the pair); a 128^3
   multigrid run at verbose = 2 with ``profile_dir`` against the same run
   without them (one residual line a V-cycle, one component-timing line
   with four positive times, a trace file that names the port's kernels,
   launch counts and P(k) unchanged); the scatter engine reordered by
   Morton key every 2 steps, twice, against a run that never reorders;
13. the multi-device modes on the one card: phase 5's configuration with
   ``parallel_mode = slab`` on the mesh ``[cuda:0] * 4`` (four shards
   taking turns), twice: 4 ``deposit_slab`` and 4 ``gather_slab``
   launches a step, P(k) within 1e-5 of phase 5's single-device run and
   bitwise equal between the two runs, the median step beside phase 5's;
   the same configuration with ``parallel_mode = replicated`` on
   ``[cuda:0] * 2`` for a few steps; the golden configuration in both
   modes within 1e-4; a 128^3 slab run whose ``slab_slack`` is so low
   that the capacity re-balancing fires (read in its log);
14. the slab multigrid and FAS with sharded ICs on the one card: phase 10's
   configuration with ``parallel_mode = slab`` on ``[cuda:0] * 4`` (its ICs
   from ``parallel/ic_slab.py``, their seconds beside phase 10's; 4
   ``deposit_slab`` and 4 ``gather_slab`` launches a step and none of the
   single forms; the stencil kernels launched on every step at the
   replicated coarse levels, their counts logged; P(k) within 1e-4 of
   phase 10's run; V-cycles per solve, the median step, the peak memory,
   one slab FAS and one slab Poisson V-cycle beside the single-device
   ones); phase 7's configuration cut to z = 49 -> 30 in slab mode
   against a single-mode run of it (P(k) within 1e-4); the e2e rows of
   phases 6 and 9 in slab mode twice (bitwise equal, within 1e-4 of the
   single-mode card runs);
15. the dense engine and the sort modes: the dense deposit and gather
   (``particle_engine = dense``, no hand-written kernel: ``torch.bmm``)
   at 64^3 and 128^3, NGP/CIC/TSC, against the tiled deposit kernel and
   the scatter gather, bitwise the same in a second call and with global
   TF32 on, an overflow counted on a clustered state, and their
   CUDA-event times at 128^3 and 256^3 CIC beside their FLOP bounds (over
   the padded rows the products run, and over the particles) and the
   tiled kernels; the golden configuration with ``dense``, single and
   replicated on ``[cuda:0] * 2`` (P(k) within 1e-4 of the golden file,
   replicated within 1e-5 of single, no tiled or stencil kernel
   launched); the four ``sort_mode`` values at 256^3 and 512^3 CIC on a
   drifted and a random state (bitwise one result: the port sends all
   four to one stable sort), its time beside that of the JAX package's
   ``nearly`` route rebuilt here (two rounds of block sorts and a check,
   else the full sort), which the port does not take.

The last two lines of standard output are the kernels' JSON record (with
each kernel's bound: the larger of its bytes over 3.35 TB/s and its
float32 operations over 67 TFLOP/s, the H100 SXM's published peaks, or
for the exact-root sweep its float64 instructions over 132 SMs x 64
lanes x 1.98 GHz, for the branch each cell takes; its launches are
those of phase 10's exact-root run) and
the result line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SCHEMES = ("ngp", "cic", "tsc")
KERNELS = {
    "deposit": ("pysco_tpu_torch/csrc/deposit.cu",
                "pysco_tpu/ops/pallas_pm.py:521"),
    "gather": ("pysco_tpu_torch/csrc/gather.cu",
               "pysco_tpu/ops/pallas_pm.py:804"),
    "half_sweep": ("pysco_tpu_torch/csrc/half_sweep.cu",
                   "pysco_tpu/ops/pallas_stencil.py:177"),
    "scalaron_half_sweep": ("pysco_tpu_torch/csrc/scalaron_sweep.cu",
                            "pysco_tpu/ops/pallas_stencil.py:205"),
    "residual_norm2": ("pysco_tpu_torch/csrc/residual.cu",
                       "pysco_tpu/ops/pallas_stencil.py:436"),
    "restrict3": ("pysco_tpu_torch/csrc/residual.cu",
                  "pysco_tpu/ops/pallas_stencil.py:607"),
    "add_prolongation": ("pysco_tpu_torch/csrc/prolongation.cu",
                         "pysco_tpu/ops/pallas_stencil.py:690"),
    # the slab call forms of the first two (their pallas_call sites)
    "deposit_slab": ("pysco_tpu_torch/csrc/deposit.cu",
                     "pysco_tpu/ops/pallas_pm.py:764"),
    "gather_slab": ("pysco_tpu_torch/csrc/gather.cu",
                    "pysco_tpu/ops/pallas_pm.py:1041"),
}
SLAB_KERNELS = ("deposit_slab", "gather_slab")
# the kernels of the single-device f(R) path, and of the Newtonian and
# QUMOND multigrid paths (all but the scalaron sweep)
SINGLE_KERNELS = tuple(k for k in KERNELS if k not in SLAB_KERNELS)
POISSON_KERNELS = tuple(k for k in SINGLE_KERNELS
                        if k != "scalaron_half_sweep")
RESIDUAL_KINDS = (("linear", None), ("laplacian", None),
                  ("reformulated", None), ("cubic", -0.27),
                  ("quartic", -0.27))
# kernels that replace no TPU kernel: the f(R) n = 1 and n = 2 sweeps with
# the float64 closed-form roots (the JAX package takes those roots in jnp)
EXTRA_KERNELS = {
    "scalaron_exact_half_sweep": "pysco_tpu_torch/csrc/scalaron_sweep.cu",
    "scalaron_quartic_exact_half_sweep":
        "pysco_tpu_torch/csrc/scalaron_sweep.cu",
}
# the H100 SXM's published peaks: HBM bytes/s
# and float32 operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# float64 instructions/s: 132 SMs x 64 float64 lanes x 1.98 GHz
F64_INSTR_PER_S = 132 * 64 * 1.98e9
# the float64 pipe's instructions, counted in the exact-root sweep's SASS
F64_OPS = ("DADD", "DMUL", "DFMA", "DSETP", "DMNMX")
# kernels that hold one part each of the exact-root sweep's float64 work
# (csrc/scalaron_sweep.cu): the discriminant and its two comparisons,
# without and with the rhs plane, and the three branches of the root; the
# sweep does the first and one branch a cell
F64_COUNT_SRC = r"""
#include "scalaron_sweep.cu"
extern "C" __global__ void f64_d(const double* p, const double* d1,
                                 int* out) {
  const int i = threadIdx.x;
  const double d = d1[i] * d1[i] + 108.0 * (p[i] * p[i] * p[i]);
  out[i] = (d > 0.0) - (d < 0.0);
}
extern "C" __global__ void f64_d_rhs(const double* p, const float* r,
                                     double d1_q, int* out) {
  const int i = threadIdx.x;
  const double d1 = d1_q - 27.0 * static_cast<double>(r[i]);
  const double d = d1 * d1 + 108.0 * (p[i] * p[i] * p[i]);
  out[i] = (d > 0.0) - (d < 0.0);
}
extern "C" __global__ void f64_cardano(const double* p, const double* d1,
                                       const double* d, double* out) {
  out[threadIdx.x] = cardano_root(p[threadIdx.x], d1[threadIdx.x],
                                  d[threadIdx.x]);
}
extern "C" __global__ void f64_trig(const double* p, const double* d1,
                                    double* out) {
  out[threadIdx.x] = trig_root(p[threadIdx.x], d1[threadIdx.x]);
}
extern "C" __global__ void f64_zero(const double* d1, double* out) {
  out[threadIdx.x] = zero_root(d1[threadIdx.x]);
}
"""
# the same for the quartic sweep (f(R) n = 2): the head and its sqrt_term
# test, without and with the rhs plane; Q + d0/Q and its test; the tail for
# each sign of p; the fallback |c|^(1/4). A cell does the head and then the
# fallback (sqrt_term < 0), or Q + d0/Q and then the fallback or a tail; p
# == 0 takes the fallback alone
F64_QUARTIC_COUNT_SRC = r"""
#include "scalaron_sweep.cu"
extern "C" __global__ void f64_head(const double* p, const double* c,
                                    int* out) {
  const int i = threadIdx.x;
  out[i] = quartic_head(p[i], c[i]).sqrt_term < 0.0;
}
extern "C" __global__ void f64_head_rhs(const double* p, const float* r,
                                        double c_q, int* out) {
  const int i = threadIdx.x;
  const double c = c_q - static_cast<double>(r[i]);
  out[i] = quartic_head(p[i], c).sqrt_term < 0.0;
}
extern "C" __global__ void f64_resolvent(const double* d0, const double* d1,
                                         const double* st, int* out) {
  const int i = threadIdx.x;
  out[i] = quartic_q_d0oq(QuarticHead{d0[i], d1[i], st[i]}) > 0.0;
}
extern "C" __global__ void f64_tail_pos(const double* p, const double* q,
                                        double* out) {
  out[threadIdx.x] = quartic_tail<true>(p[threadIdx.x], q[threadIdx.x]);
}
extern "C" __global__ void f64_tail_neg(const double* p, const double* q,
                                        double* out) {
  out[threadIdx.x] = quartic_tail<false>(p[threadIdx.x], q[threadIdx.x]);
}
extern "C" __global__ void f64_fallback(const double* c, double* out) {
  out[threadIdx.x] = quartic_fallback(c[threadIdx.x]);
}
"""


def bound(nbytes: float, flops: float):
    """(ms, "bytes" or "operations"): the least time the card could take
    for a call that moves ``nbytes`` and computes ``flops``."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / F32_FLOPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device(torch):
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)  # the card's name and power limit, as nvidia-smi prints them
    log(f"[1 device] {torch.cuda.get_device_name(0)}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build():
    from pysco_tpu_torch.ops import cuda_build, stencil, tiled_pm

    t0 = time.perf_counter()
    tiled_pm._kernels()
    stencil._kernels()
    log(f"[2 build] kernels built and loaded in "
        f"{time.perf_counter() - t0:.2f} s (nvcc "
        f"{cuda_build.BUILD_INFO['seconds']} s)")
    for line in cuda_build.BUILD_INFO["log"].splitlines():
        if "ptxas info" in line and ("Used" in line or "Compiling" in line):
            log("    " + line.strip())


def _particles(torch, n, m, clustered, gen):
    pos = torch.rand((n, 3), generator=gen, device="cuda")
    if clustered:
        pos[: n // 2] = 0.2 + 0.25 * pos[: n // 2]
    vel = torch.randn((n, 3), generator=gen, device="cuda")
    return pos, vel


def _state(torch, tp, n, m, scheme, drift, clustered, gen):
    """Tile-sorted column state; with drift > 0 every particle then moves
    up to drift - 0.05 cells per axis without a re-sort."""
    from pysco_tpu_torch.ops.mesh import periodic_wrap

    pos, vel = _particles(torch, n, m, clustered, gen)
    pc, vc = tp.to_columns(pos, vel, n)
    ps, _, ts = tp.sort_particles(pc, vc, m, scheme)
    if drift:
        delta = (drift - 0.05) / m * (
            2 * torch.rand((3, ps.shape[1]), generator=gen, device="cuda")
            - 1)
        real = ps[0] < tp.SENTINEL_MIN
        ps = ps.clone()
        ps[:3] = torch.where(real, periodic_wrap(ps[:3] + delta), ps[:3])
        check(int(tp.drift_violations(ps, ts, m, scheme, drift)) == 0,
              "drifted test state breaks its drift bound")
    return ps, ts


def _edge_state(torch, tp, ps, ts, m, scheme, drift, gen, plane0=0,
                n_planes=None):
    """Every real column of a fresh sort moved so that its base cell sits on
    an edge of its tile's window: x at -drift, 0 or +drift planes; y at
    -drift, the live window's last row (7 + drift) or the envelope's
    (wy_pad - w - drift); z likewise when z-blocked. ``plane0`` and
    ``n_planes``: the tiles are a slab's."""
    g = tp._geometry(m, scheme, drift, None, n_planes)
    n_up = ps.shape[1]
    tile = tp._tile_of_columns(ts, n_up).long()
    real = (ps[0] < tp.SENTINEL_MIN) & (tile < g.ntiles)

    def pick(options):
        i = torch.randint(0, len(options), (n_up,), generator=gen,
                          device="cuda")
        return torch.tensor(options, device="cuda")[i]

    plane = tile // (g.nby * g.nbz) + plane0
    yb = (tile // g.nbz) % g.nby
    by = yb * tp.YB + pick([-drift, 7 + drift, g.wy_pad - g.w - drift])
    if g.nbz > 1:
        bz = (tile % g.nbz) * g.zbs + pick(
            [-drift, g.zbs - 1 + drift, g.wz_pad - g.w - drift])
    else:
        bz = torch.randint(0, m, (n_up,), generator=gen, device="cuda")
    off = 1.5 if scheme == "tsc" else 0.75  # the base cell is the target
    out = ps.clone()
    for axis, base in ((0, plane + pick([-drift, 0, drift])), (1, by),
                       (2, bz)):
        out[axis] = torch.where(real, ((base + off) % m) / m, out[axis])
    return out


def _deposit_check(torch, tp, ps, ts, m, scheme, drift, tag):
    """Two deposits bitwise equal and within 1e-5 x max of the twin, which
    holds the same mass; returns (|kernel - twin|, max count, mass)."""
    grid = tp.deposit(ps, ts, m, scheme, drift)
    again = tp.deposit(ps, ts, m, scheme, drift)
    twin = tp.deposit_plain(ps, ts, m, scheme, drift)
    torch.cuda.synchronize()
    check(torch.equal(grid, again), f"deposit not bitwise reproducible ({tag})")
    d_err = float((grid - twin).abs().max())
    scale = float(twin.abs().max())
    mass = float(grid.double().sum())
    check(d_err <= 1e-5 * scale,
          f"deposit vs twin {d_err:.3e} > 1e-5 x {scale:.3e} ({tag})")
    twin_mass = float(twin.double().sum())
    check(abs(mass - twin_mass) <= 1e-6 * max(twin_mass, 1.0),
          f"deposit mass {mass} != twin's {twin_mass} ({tag})")
    return d_err, scale, mass


def _deposit_split(torch, tp, ps, ts, m, scheme, drift, tag, reps=3):
    """Device time of a deposit call by torch.profiler: the kernel's
    launches against the zeroing of the padded grid and its fold (logged
    only; the profiler's own clock)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    tp.deposit(ps, ts, m, scheme, drift)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            tp.deposit(ps, ts, m, scheme, drift)
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    total = sum(e.time_range.elapsed_us() for e in dev) / reps / 1e3
    kern = sum(e.time_range.elapsed_us() for e in dev
               if "deposit_tiles" in e.name) / reps / 1e3
    log(f"[{tag}] {m}^3 {scheme} drift={drift} deposit, device time by "
        f"torch.profiler: {total:.3f} ms a call, the kernel {kern:.3f} ms, "
        f"zeroing and fold {total - kern:.3f} ms")


def _gather_check(torch, tp, field, ps, ts, scheme, drift, tag):
    """The gather kernel bitwise its twin (the same products and sums in
    the same order, --fmad=false); returns |kernel - twin| (0)."""
    got = tp.gather_vec_cl(field, ps, ts, scheme, drift)
    ref = tp.gather_vec_cl_plain(field, ps, ts, scheme, drift)
    err = float((got - ref).abs().max())
    check(torch.equal(got, ref), f"gather not bitwise its twin: "
          f"{err:.3e} ({tag})")
    return err


def _gather_variants(torch, tp, gen):
    """The gather at 128^3 particles on 128^3 and (z-blocked) 512^3 with
    1, 2 and 4 field components, every staging the kernel takes (all
    components of the window at once, one a pass), and a state whose
    particles moved past their drift bound (the kernel reads their cells
    from the field), each bitwise its twin."""
    from pysco_tpu_torch.ops.mesh import periodic_wrap

    for m in (128, 512):
        for scheme, drift in (("cic", 1), ("tsc", 3)):
            ps, ts = _state(torch, tp, 128 ** 3, m, scheme, drift, True, gen)
            g = tp._geometry(m, scheme, drift)
            for ncomp in (1, 2, 4):
                field = torch.randn((ncomp, m, m, m), generator=gen,
                                    device="cuda")
                ref = tp.gather_vec_cl_plain(field, ps, ts, scheme, drift)
                for ncs in sorted({1, ncomp}):
                    if tp._gather_smem(g, ncs) > tp._SMEM_LIMIT:
                        continue
                    got = tp._gather_cuda(field, ps, ts, drift, g, ncs)
                    check(torch.equal(got, ref), f"gather with {ncomp} "
                          f"components staged {ncs} a pass not bitwise its "
                          f"twin (m={m} {scheme} drift={drift})")
                del field, ref
            # past the bound: up to drift + 1.95 cells of movement
            far, fts = _state(torch, tp, 128 ** 3, m, scheme, 0, False, gen)
            delta = (drift + 1.95) / m * (2 * torch.rand(
                (3, far.shape[1]), generator=gen, device="cuda") - 1)
            real = far[0] < tp.SENTINEL_MIN
            far[:3] = torch.where(real, periodic_wrap(far[:3] + delta),
                                  far[:3])
            bad = int(tp.drift_violations(far, fts, m, scheme, drift))
            check(bad > 0, "no particle past its drift bound")
            field = torch.randn((3, m, m, m), generator=gen, device="cuda")
            _gather_check(torch, tp, field, far, fts, scheme, drift,
                          f"past the bound m={m} {scheme} drift={drift}")
            log(f"[3 kernels] gather m={m} {scheme} drift={drift}: 1, 2 and 4 "
                f"components, each staging, bitwise; {bad} particles past "
                f"their bound bitwise")
            del field, far, fts, ps, ts


def _gather_staging(torch, tp, field, gen):
    """The gather's two stagings timed one against the other at 256^3
    particles on 256^3, where both fit a block: every component of the
    window at once or one a pass (tiled_pm._gather_stage picks all
    whenever they fit)."""
    m, n = 256, 256 ** 3
    for scheme, drift in (("cic", 1), ("tsc", 0)):
        ps, ts = _state(torch, tp, n, m, scheme, drift, False, gen)
        g = tp._geometry(m, scheme, drift)
        t = {ncs: time_ms(torch, lambda: tp._gather_cuda(field, ps, ts, drift,
                                                         g, ncs))
             for ncs in (1, 3)}
        log(f"[3 times] 256^3 {scheme} drift={drift} gather staging: all 3 "
            f"components {t[3]:.3f} ms ({tp._gather_smem(g, 3)} B a block), "
            f"one a pass {t[1]:.3f} ms ({tp._gather_smem(g, 1)} B); the "
            f"wrapper stages {tp._gather_stage(g, 3, m, scheme, drift)}")
        del ps, ts


def _gather_512(torch, tp, gen):
    """The gather at 512^3 particles on the 512^3 grid (z-blocked tiles),
    CIC, uniform: bitwise its twin at drift 0 and 1, its time beside the
    twin's, its bound and grid_sample's (logged: the record holds the
    256^3 numbers)."""
    m = 512
    n = m ** 3
    field = torch.randn((3, m, m, m), generator=gen, device="cuda")
    for drift in (0, 1):
        ps, ts = _state(torch, tp, n, m, "cic", drift, False, gen)
        _gather_check(torch, tp, field, ps, ts, "cic", drift,
                      f"512^3 drift={drift}")
        t_k = time_ms(torch, lambda: tp.gather_vec_cl(field, ps, ts, "cic",
                                                      drift))
        t_p = time_ms(torch, lambda: tp.gather_vec_cl_plain(
            field, ps, ts, "cic", drift), 3)
        gat = bound(12 * n + ts.numel() * 4 + field.numel() * 4 + 12 * n,
                    n * (15 + 8 * 3 + 8 * 3 * 2))
        msg = (f"[3 times] 512^3 particles, 512^3 grid (z-blocked), CIC "
               f"drift={drift}: gather {t_k:.3f} ms (twin {t_p:.3f}), bound "
               f"{gat[0]:.4f} ms ({gat[1]})")
        if drift == 0:
            msg += (f", grid_sample "
                    f"{_grid_sample_yardstick(torch, tp, ps, ts, field, m, False):.3f}"
                    " ms")
        log(msg)
        del ps, ts
    del field
    torch.cuda.empty_cache()


def time_ms(torch, fn, reps: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_kernels(torch):
    from pysco_tpu_torch.ops import tiled_pm as tp

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    err = {"deposit": 0.0, "gather": 0.0}
    cases = [(128, 128 ** 3), (256, 256 ** 3), (512, 256 ** 3)]
    for m, n in cases:
        field = torch.randn((3, m, m, m), generator=gen, device="cuda")
        for scheme in SCHEMES:
            for drift in (0, 3):
                for clustered in (False, True):
                    ps, ts = _state(torch, tp, n, m, scheme, drift,
                                    clustered, gen)
                    d_err, scale, mass = _deposit_check(
                        torch, tp, ps, ts, m, scheme, drift,
                        f"m={m} {scheme} drift={drift} "
                        f"clustered={clustered}")
                    check(abs(mass - n) <= 1e-6 * n,
                          f"deposit mass {mass} != {n} (m={m} {scheme} "
                          f"drift={drift})")
                    g_err = _gather_check(torch, tp, field, ps, ts, scheme,
                                          drift, f"m={m} {scheme} "
                                          f"drift={drift} clustered="
                                          f"{clustered}")
                    err["deposit"] = max(err["deposit"], d_err)
                    err["gather"] = max(err["gather"], g_err)
                    log(f"[3 kernels] m={m} n={n} {scheme} drift={drift} "
                        f"clustered={int(clustered)}: deposit |k-twin| "
                        f"{d_err:.2e} (max count {scale:.3e}), mass "
                        f"{mass:.1f}; gather |k-twin| {g_err:.2e}")
        del field
    # every base on an edge of its window (the spill path past the live
    # window included), 128^3 particles on 128^3 and (z-blocked) 512^3
    for m in (128, 512):
        for scheme in SCHEMES:
            for drift in (0, 3):
                ps, ts = _state(torch, tp, 128 ** 3, m, scheme, 0, False,
                                gen)
                ps = _edge_state(torch, tp, ps, ts, m, scheme, drift, gen)
                check(int(tp.drift_violations(ps, ts, m, scheme, drift)) == 0,
                      "edge test state breaks its envelope")
                d_err, scale, mass = _deposit_check(
                    torch, tp, ps, ts, m, scheme, drift,
                    f"edge m={m} {scheme} drift={drift}")
                field = torch.randn((3, m, m, m), generator=gen,
                                    device="cuda")
                g_err = _gather_check(torch, tp, field, ps, ts, scheme, drift,
                                      f"edge m={m} {scheme} drift={drift}")
                del field
                err["deposit"] = max(err["deposit"], d_err)
                err["gather"] = max(err["gather"], g_err)
                log(f"[3 kernels] edge m={m} {scheme} drift={drift}: deposit"
                    f" |k-twin| {d_err:.2e} (max count {scale:.3e}), mass "
                    f"{mass:.1f}; gather bitwise")
    _gather_variants(torch, tp, gen)
    for m, scheme, drift in ((256, "cic", 0), (256, "tsc", 3), (512, "cic", 0),
                             (512, "cic", 1), (512, "tsc", 3)):
        g = tp._geometry(m, scheme, drift)
        ncs = tp._gather_stage(g, 3, m, scheme, drift)
        log(f"[3 kernels] shared memory {m}^3 {scheme} drift={drift}: "
            f"deposit {tp._deposit_smem(g)} B a block, gather "
            f"{tp._gather_smem(g, ncs)} B staging {ncs} of 3 components "
            f"(live window {g.live_window})")
    # times at the main path's shapes: 256^3 particles on the 256^3 grid
    m, n = 256, 256 ** 3
    times = {}
    field = torch.randn((3, m, m, m), generator=gen, device="cuda")
    for scheme, drift in (("cic", 0), ("cic", 3), ("tsc", 0), ("tsc", 3)):
        ps, ts = _state(torch, tp, n, m, scheme, drift, False, gen)
        t = {
            "deposit": time_ms(torch, lambda: tp.deposit(
                ps, ts, m, scheme, drift)),
            "deposit_plain": time_ms(torch, lambda: tp.deposit_plain(
                ps, ts, m, scheme, drift)),
            "gather": time_ms(torch, lambda: tp.gather_vec_cl(
                field, ps, ts, scheme, drift)),
            "gather_plain": time_ms(torch, lambda: tp.gather_vec_cl_plain(
                field, ps, ts, scheme, drift)),
        }
        times[(scheme, drift)] = t
        if (scheme, drift) == ("cic", 0):
            _deposit_split(torch, tp, ps, ts, m, scheme, drift, "3 times")
        log(f"[3 times] 256^3 particles, 256^3 grid, {scheme} drift={drift}:"
            f" deposit {t['deposit']:.3f} ms (twin "
            f"{t['deposit_plain']:.3f}), gather {t['gather']:.3f} ms (twin "
            f"{t['gather_plain']:.3f})")
        if (scheme, drift) == ("cic", 0):
            meta = _particle_meta(torch, tp, ps, ts, field, m, n, t)
    _gather_staging(torch, tp, field, gen)
    del field, ps, ts
    _gather_512(torch, tp, gen)
    s_err, s_times, s_meta = _slab_kernels(torch, tp, gen)
    err.update(s_err)
    times[("cic", 0)].update(s_times)
    meta.update(s_meta)
    return err, times[("cic", 0)], meta


def _evolved_state(torch, seed: int = 20201):
    """Column positions at z = 0 of a seeded run of the benchmark's
    ``newton_fft_cic_512`` configuration at its ``lazy`` cadence
    (``benchmark/cell.py``'s set-up, then ``benchmark/loop.py`` to the last
    output); returns them and the steps taken."""
    from pathlib import Path

    here = Path(REPO) / "benchmark"
    if str(here) not in sys.path:
        sys.path.insert(0, str(here))
    import cell

    config = cell.load_json(here / "configs" / "newton_fft_cic_512.json")
    traffic = cell.load_json(here / "traffic" / "lazy.json")
    base = tempfile.mkdtemp(prefix="pysco_states_")
    try:
        param = cell._param(config, seed, base, traffic["param"], here)
        sim, _, _ = cell._set_up(param, traffic, seed, torch.device("cuda"),
                                 base)
        steps = len(traffic["warmup_levels"])
        while not sim.finished:
            sim.step()
            steps += 1
        pos = sim.position
        del sim
    finally:
        shutil.rmtree(base, ignore_errors=True)
    return pos, steps


def _tile_redrawn(torch, tp, ps, ts, m, scheme, gen):
    """``ps`` with every real particle drawn anew uniformly inside its own
    tile (its base cell uniform over the tile's cells, its offset in the
    cell uniform): the tile counts and the columns' order are kept, the
    clumping inside a tile is gone."""
    g = tp._geometry(m, scheme)
    n_up = ps.shape[1]
    tile = tp._tile_of_columns(ts, n_up).long()
    real = (ps[0] < tp.SENTINEL_MIN) & (tile < g.ntiles)
    plane = tile // (g.nby * g.nbz)
    by = ((tile // g.nbz) % g.nby) * tp.YB + torch.randint(
        0, tp.YB, (n_up,), generator=gen, device="cuda")
    bz = (tile % g.nbz) * g.zbs + torch.randint(
        0, g.zbs, (n_up,), generator=gen, device="cuda")
    off = {"ngp": 0.0, "cic": 0.5, "tsc": 1.0}[scheme]
    out = ps.clone()
    for axis, base in ((0, plane), (1, by), (2, bz)):
        u = 0.01 + 0.98 * torch.rand(n_up, generator=gen, device="cuda")
        out[axis] = torch.where(
            real, torch.remainder((base + off + u) / m, 1.0), out[axis])
    keys = tp.tile_keys(out, m, scheme)
    check(torch.equal(keys[real], tile[real]),
          f"redrawn state left its tiles ({scheme})")
    return out


def _before_lib(path: str):
    """A deposit kernel source to time beside the package's (an earlier
    ``csrc/deposit.cu`` with its own ``tiled_pm.cuh`` beside it), built
    alone into a library of its own."""
    import ctypes

    from pysco_tpu_torch.ops import cuda_build

    out = os.path.join(tempfile.mkdtemp(prefix="pysco_before_"),
                       "libdeposit_before.so")
    cmd = [cuda_build._nvcc(), *cuda_build.FLAGS, "-shared", "-o", out,
           os.path.abspath(path)]
    r = subprocess.run(cmd, capture_output=True, text=True)
    check(r.returncode == 0, f"building {path} failed:\n{r.stderr[-3000:]}")
    for line in (r.stdout + r.stderr).splitlines():
        if "ptxas info" in line and "Used" in line:
            log("    before: " + line.strip())
    lib = ctypes.CDLL(out)
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.pysco_deposit.argtypes = [P, L, P, P, I, I, I, I, I, I, I, I, I, P]
    lib.pysco_deposit.restype = I
    return lib


def _raw_deposit(torch, tp, lib, ps, ts, m, scheme, drift):
    """A call of ``lib``'s deposit kernel alone into a padded grid zeroed
    once (the call's sums pile up: for timing only). Pointer arguments the
    older signature lacks (after ``plane0``) are passed as null."""
    g = tp._geometry(m, scheme, drift)
    gp = torch.zeros(g.padded_shape(m), device="cuda")
    extra = len(lib.pysco_deposit.argtypes) - 14
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        err = lib.pysco_deposit(ps.data_ptr(), ps.shape[1], ts.data_ptr(),
                                gp.data_ptr(), m, g.w, drift, g.wy_pad, g.wz,
                                g.zbs, g.nbz, g.n_planes, 0,
                                *([None] * extra), stream)
        check(err == 0, f"deposit kernel failed: CUDA error {err}")
    return call


def _index_add_ms(torch, tp, ps, m, scheme, parts=4):
    """``index_add_`` of every (cell, weight) pair of the real particles
    into a zeroed grid, the pairs precomputed (``mesh._contribs``), in
    ``parts`` particle slices whose times add up (a TSC call's pairs
    would not fit the card at once)."""
    from pysco_tpu_torch.ops import mesh

    real = ps[0] < tp.SENTINEL_MIN
    rows = ps[:3, real].T.contiguous()
    grid = torch.zeros(m ** 3, device="cuda")
    total = 0.0
    for sl in torch.chunk(rows, parts):
        contribs = mesh._contribs(sl, m, scheme)
        idx = torch.cat([c[0] for c in contribs])
        wts = torch.cat([c[1] for c in contribs])
        del contribs
        total += time_ms(torch, lambda: grid.index_add_(0, idx, wts), 3)
        del idx, wts
    del rows, grid
    torch.cuda.empty_cache()
    return total


def phase_deposit_states(torch, np, before=None):
    """Phase 3, the deposit at 512^3 particles on the 512^3 grid (z-blocked
    tiles) on three states: uniform; z = 0 of a seeded 512^3 run
    (:func:`_evolved_state`); that state with every particle redrawn
    inside its own tile (:func:`_tile_redrawn`). For CIC and TSC, freshly
    sorted, at drift 0-3: the kernel's time (CUDA events, the kernel
    alone) beside its bound (12 N + 4 n^3 bytes); with ``before``, a
    deposit.cu to compare (:func:`_before_lib`), both timed in turns. On
    the z = 0 state: two deposits bitwise equal at every drift, the
    kernel against its twin at drift 0 with the twin's time and
    ``index_add_``'s. Returns the numbers."""
    from pysco_tpu_torch.ops import tiled_pm as tp

    t0 = time.perf_counter()
    m = 512
    n = m ** 3
    gen = torch.Generator(device="cuda")
    gen.manual_seed(20)
    old = _before_lib(before) if before else None
    z0, steps = _evolved_state(torch)
    log(f"[3 states] z = 0 state of newton_fft_cic_512 (lazy cadence) in "
        f"{steps} steps, {time.perf_counter() - t0:.1f} s")
    uni, _ = tp.to_columns(torch.rand((n, 3), generator=gen, device="cuda"),
                           torch.zeros((1, 3), device="cuda"), n)
    lib = tp._kernels()
    dep_bound = bound(12 * n + 4 * m ** 3, 0)[0]
    out = {"bound_ms": dep_bound, "steps": steps, "ms": {}}
    for scheme in ("cic", "tsc"):
        states = {}
        for name, pos in (("uniform", uni), ("z0", z0)):
            ps, _, ts = tp.sort_particles(pos, pos[:1], m, scheme)
            states[name] = (ps, ts)
        states["redrawn"] = (_tile_redrawn(torch, tp, *states["z0"], m,
                                           scheme, gen), states["z0"][1])
        for drift in range(4):
            for name, (ps, ts) in states.items():
                fns = {"kernel": _raw_deposit(torch, tp, lib, ps, ts, m, scheme,
                                           drift)}
                if old is not None:
                    fns["before"] = _raw_deposit(torch, tp, old, ps, ts, m,
                                                 scheme, drift)
                order = ["kernel", "before", "before", "kernel"] if old \
                    else ["kernel", "kernel"]
                t = {k: [] for k in fns}
                for k in order:
                    t[k].append(time_ms(torch, fns[k], 3))
                del fns
                torch.cuda.empty_cache()
                key = f"{scheme}.{name}.d{drift}"
                out["ms"][key] = {k: sum(v) / len(v) for k, v in t.items()}
                msg = " ".join(f"{k} {v:.3f} ms"
                               for k, v in out["ms"][key].items())
                log(f"[3 states] {scheme} drift={drift} {name}: {msg} "
                    f"(bound {dep_bound:.3f} ms, "
                    f"{100 * dep_bound / out['ms'][key]['kernel']:.2f}%)")
        ps, ts = states["z0"]
        for drift in range(4):
            a = tp.deposit(ps, ts, m, scheme, drift)
            check(torch.equal(a, tp.deposit(ps, ts, m, scheme, drift)),
                  f"512^3 z = 0 {scheme} drift={drift}: deposits differ")
            check(abs(float(a.double().sum()) - n) <= 1e-6 * n,
                  f"512^3 z = 0 {scheme} drift={drift}: mass not kept")
            del a
        d_err, scale, _ = _deposit_check(torch, tp, ps, ts, m, scheme, 0,
                                         f"512^3 z = 0 {scheme}")
        t_twin = time_ms(torch, lambda: tp.deposit_plain(ps, ts, m, scheme),
                         1)
        del states
        torch.cuda.empty_cache()
        t_lib = _index_add_ms(torch, tp, ps, m, scheme)
        out["ms"][f"{scheme}.z0.twin"] = t_twin
        out["ms"][f"{scheme}.z0.index_add"] = t_lib
        log(f"[3 states] {scheme} z = 0: two deposits bitwise equal at drift "
            f"0-3, mass kept; kernel vs twin {d_err:.2e} (max count "
            f"{scale:.3e}); twin {t_twin:.1f} ms, index_add_ {t_lib:.1f} ms")
        del ps, ts
        torch.cuda.empty_cache()
    del z0, uni
    torch.cuda.empty_cache()
    log(f"[3 states] {json.dumps(out)}")
    log(f"[3 states] in {time.perf_counter() - t0:.1f} s")
    return out


def _slab_state(torch, tp, n, m, scheme, drift, plane0, n_planes, gen,
                edge=False, clustered=True):
    """The tile-sorted columns of the slab [plane0, plane0 + n_planes) of a
    box of n particles (the strangers sorted past the end, as
    after a migration), then moved without a re-sort: up to drift - 0.05
    cells per axis, or (``edge``) onto the edges of their windows."""
    from pysco_tpu_torch.ops.mesh import periodic_wrap

    pos, vel = _particles(torch, n, m, clustered, gen)
    pc, vc = tp.to_columns(pos, vel, n)
    del pos, vel
    ps, _, ts = tp.sort_particles(pc, vc, m, scheme, None, plane0, n_planes)
    del pc, vc
    # the slab's own columns and a sentinel tail, as a shard holds them
    keep = tp.padded_cols(int(ts[-1]) + 1)
    ps = ps[:, :keep].clone()
    ps[:3, int(ts[-1]):] = tp.SENTINEL
    if edge:
        ps = _edge_state(torch, tp, ps, ts, m, scheme, drift, gen, plane0,
                         n_planes)
    elif drift:
        delta = (drift - 0.05) / m * (
            2 * torch.rand((3, keep), generator=gen, device="cuda") - 1)
        real = ps[0] < tp.SENTINEL_MIN
        ps[:3] = torch.where(real, periodic_wrap(ps[:3] + delta), ps[:3])
    check(int(tp.drift_violations(ps, ts, m, scheme, drift, None, plane0,
                                  n_planes)) == 0,
          "slab test state breaks its drift bound")
    return ps, ts


def _slab_check(torch, tp, ps, ts, m, scheme, drift, plane0, n_planes, gen,
                tag, mass=True):
    """The slab forms against their twins: two deposits bitwise equal and
    within 1e-5 x max of the twin, the gather bitwise its twin. Returns
    the deposit's and the gather's |kernel - twin|."""
    args = (ps, ts, m, scheme, drift, None, plane0, n_planes)
    gp = tp.deposit_slab(*args)
    check(torch.equal(gp, tp.deposit_slab(*args)),
          f"deposit_slab not bitwise reproducible ({tag})")
    twin = tp.deposit_slab_plain(*args)
    d_err, scale = float((gp - twin).abs().max()), float(twin.abs().max())
    check(d_err <= 1e-5 * scale,
          f"deposit_slab vs twin {d_err:.3e} > 1e-5 x {scale:.3e} ({tag})")
    if mass:
        total, want = float(gp.double().sum()), int(ts[-1])
        check(abs(total - want) <= 1e-6 * want,
              f"deposit_slab mass {total} != {want} ({tag})")
    field = torch.randn((3, gp.shape[0], m, m), generator=gen, device="cuda")
    got = tp.gather_vec_slab(field, ps, ts, scheme, drift, None, plane0)
    twin = tp.gather_vec_slab_plain(field, ps, ts, scheme, drift, plane0)
    g_err = float((got - twin).abs().max())
    check(g_err == 0.0 and torch.equal(got, twin),
          f"gather_vec_slab not bitwise its twin: {g_err:.3e} ({tag})")
    return d_err, g_err


def _slab_kernels(torch, tp, gen):
    """The slab call forms on the card (see the module's phase 3)."""
    from pysco_tpu_torch.parallel import slab

    err = g_err = 0.0
    for m, n in ((128, 128 ** 3), (256, 128 ** 3), (512, 128 ** 3)):
        plane0 = m // 2
        for scheme in ("cic", "tsc"):
            w = tp._WIDTH[scheme]
            worst = 0.0
            for drift in (0, 1, 2):
                for n_planes in (m // 4, w - 1 + drift):
                    for edge in (False, True):
                        if edge and drift == 1:
                            continue
                        ps, ts = _slab_state(torch, tp, n, m, scheme, drift,
                                             plane0, n_planes, gen, edge)
                        d, g = _slab_check(
                            torch, tp, ps, ts, m, scheme, drift, plane0,
                            n_planes, gen, f"m={m} {scheme} drift={drift} "
                            f"planes {plane0}+{n_planes} edge={edge}",
                            mass=not edge)
                        worst, g_err = max(worst, d), max(g_err, g)
            err = max(err, worst)
            log(f"[3 slab] m={m} {scheme}: planes {plane0}+{m // 4} and the "
                f"thinnest (w - 1 + drift), drift 0-2, drifted and on the "
                f"windows' edges: deposit_slab |k-twin| <= {worst:.2e}, two "
                f"calls bitwise; gather_vec_slab |k-twin| <= {g_err:.1e} "
                "(bitwise its twin)")
    # D slab deposits and add_spill against the single-device deposit of
    # the same (stale) state; the slab gathers of the halo-extended field
    # against the single gather, column by column
    m, n, d = 256, 256 ** 3, 4
    planes = m // d
    mesh = (torch.device("cuda", 0),) * d
    for scheme, drift in (("cic", 0), ("tsc", 2)):
        ps, ts = _state(torch, tp, n, m, scheme, drift, True, gen)
        want = tp.deposit(ps, ts, m, scheme, drift)
        field = torch.randn((3, m, m, m), generator=gen, device="cuda")
        acc = tp.gather_vec_cl(field, ps, ts, scheme, drift)
        nt = tp.n_tiles(m, None, planes)
        ext = slab.halo_lr(list(torch.chunk(field, d, dim=1)), drift,
                           tp._WIDTH[scheme] - 1 + drift, mesh, axis=1)
        gps = []
        for r in range(d):
            lo, hi = int(ts[r * nt]), int(ts[(r + 1) * nt])
            cols = torch.full((4, tp.padded_cols(hi - lo + 1)), tp.SENTINEL,
                              device="cuda")
            cols[3] = 0.0
            cols[:, :hi - lo] = ps[:, lo:hi]
            rts = ts[r * nt:(r + 1) * nt + 1] - lo
            gps.append(tp.deposit_slab(cols, rts, m, scheme, drift, None,
                                       r * planes, planes))
            got = tp.gather_vec_slab(ext[r].contiguous(), cols, rts, scheme,
                                     drift, None, r * planes)
            check(torch.equal(got[:, :hi - lo], acc[:, lo:hi]),
                  f"slab {r}'s gather is not the single gather's ({scheme})")
        got = torch.cat(slab.add_spill(gps, planes, mesh, lead=drift))
        d_err, scale = float((got - want).abs().max()), float(want.max())
        check(d_err <= 1e-6 * scale, f"{d} slab deposits + add_spill vs the "
              f"single deposit: {d_err:.3e} > 1e-6 x {scale:.3e}")
        log(f"[3 slab] 256^3 {scheme} drift={drift}: {d} slab deposits + "
            f"add_spill vs the single deposit {d_err:.2e} (max count "
            f"{scale:.3e}); the {d} slab gathers bitwise the single gather")
        del ps, ts, want, field, acc, ext, gps, got
    # times at 256^3 CIC drift 0: the whole grid as one slab, and a quarter
    # (the shapes of 1 and 4 shards); bytes: the columns' positions and the
    # tile starts read, the padded slab written (deposit) or the extended
    # field read and three rows written (gather)
    scheme, times, meta = "cic", {}, {}
    for n_planes, plane0 in ((m, 0), (planes, m // 2)):
        ps, ts = _slab_state(torch, tp, n, m, scheme, 0, plane0, n_planes,
                             gen, clustered=False)
        cnt = int(ts[-1])
        nx = n_planes + 1
        field = torch.randn((3, nx, m, m), generator=gen, device="cuda")
        t = {
            "deposit_slab": time_ms(torch, lambda: tp.deposit_slab(
                ps, ts, m, scheme, 0, None, plane0, n_planes)),
            "deposit_slab_plain": time_ms(
                torch, lambda: tp.deposit_slab_plain(
                    ps, ts, m, scheme, 0, None, plane0, n_planes), 3),
            "gather_slab": time_ms(torch, lambda: tp.gather_vec_slab(
                field, ps, ts, scheme, 0, None, plane0)),
            "gather_slab_plain": time_ms(
                torch, lambda: tp.gather_vec_slab_plain(
                    field, ps, ts, scheme, 0, plane0), 3),
        }
        pos_bytes = 12 * cnt + ts.numel() * 4
        dep = bound(pos_bytes + 4 * nx * m * m, cnt * (15 + 8 * 3))
        gat = bound(pos_bytes + field.numel() * 4 + 12 * cnt,
                    cnt * (15 + 8 * 3 + 8 * 3 * 2))
        log(f"[3 slab times] 256^3 CIC drift 0, planes {plane0}+{n_planes} "
            f"({cnt} particles): deposit_slab {t['deposit_slab']:.3f} ms "
            f"(twin {t['deposit_slab_plain']:.3f}, bound {dep[0]:.4f} "
            f"{dep[1]}), gather_vec_slab {t['gather_slab']:.3f} ms (twin "
            f"{t['gather_slab_plain']:.3f}, bound {gat[0]:.4f} {gat[1]})")
        if n_planes == planes:  # the main path's shape: the record's
            from pysco_tpu_torch.ops import mesh as mesh_ops

            rows = ps[:3, :cnt].T.contiguous()
            contribs = mesh_ops._contribs(rows, m, scheme)
            idx = torch.cat([c[0] for c in contribs])
            wts = torch.cat([c[1] for c in contribs])
            del contribs, rows
            mm = m * m  # the cells re-based onto the slab's nx planes
            idx = ((idx // mm - plane0) % m) * mm + idx % mm
            check(int(idx.max()) < nx * mm, "a slab particle off its slab")
            lib = time_ms(torch, lambda: torch.zeros(
                nx * mm, device="cuda").index_add_(0, idx, wts))
            del idx, wts
            g_lib = _grid_sample_yardstick(torch, tp, ps, ts, field, m,
                                           plane0=plane0)
            log(f"[3 slab times] one-call yardsticks on the quarter slab: "
                f"index_add_ {lib:.3f} ms, grid_sample {g_lib:.3f} ms")
            times = t
            meta = {"deposit_slab": {"bound": dep, "library_ms": lib},
                    "gather_slab": {"bound": gat, "library_ms": g_lib}}
        del ps, ts, field
    torch.cuda.empty_cache()
    return {"deposit_slab": err, "gather_slab": g_err}, times, meta


def _particle_meta(torch, tp, ps, ts, field, m, n, t):
    """Bounds and the one-call PyTorch yardstick of the CIC deposit and
    gather at drift 0 (the inputs of their timed calls). Each needs the
    particles' three position rows once; the deposit writes the grid, the
    gather reads the three-component field and writes three rows. The
    operations: 3 axis weights (~5 each) and 8 cells x (2 products + 1
    sum) for the deposit, 8 cells x 3 components x 2 more for the
    gather. The library call is ``index_add_`` of the 8 n precomputed
    CIC (cell, weight) pairs into a zeroed grid: the weights and cells
    themselves are not timed."""
    from pysco_tpu_torch.ops import mesh

    real = ps[0] < tp.SENTINEL_MIN
    rows = ps[:3, real].T.contiguous()
    cells = m ** 3
    pos_bytes = 12 * n + ts.numel() * ts.element_size()
    dep = bound(pos_bytes + 4 * cells, n * (15 + 8 * 3))
    gat = bound(pos_bytes + field.numel() * 4 + 12 * n,
                n * (15 + 8 * 3 + 8 * 3 * 2))
    contribs = mesh._contribs(rows, m, "cic")
    idx = torch.cat([c[0] for c in contribs])
    w = torch.cat([c[1] for c in contribs])
    del contribs, rows
    lib = time_ms(torch, lambda: torch.zeros(
        cells, device="cuda").index_add_(0, idx, w))
    del idx, w
    g_lib = _grid_sample_yardstick(torch, tp, ps, ts, field, m)
    log(f"[3 bounds] 256^3 CIC drift 0: deposit bound {dep[0]:.4f} ms "
        f"({dep[1]}), index_add_ {lib:.3f} ms; gather bound {gat[0]:.4f} "
        f"ms ({gat[1]}), grid_sample {g_lib:.3f} ms")
    return {"deposit": {"bound": dep, "library_ms": lib},
            "gather": {"bound": gat, "library_ms": g_lib}}


def _grid_sample_yardstick(torch, tp, ps, ts, field, m, checked=True,
                           plane0=None):
    """The gather's one-call yardstick: trilinear ``grid_sample``
    (align_corners=False) of the three-component field padded by one
    periodic cell a side, at the real columns' (z, y, x) positions
    normalised into the padded grid: CIC cell i + 1 of the pad has its
    centre at pixel i + 1, so a position x (cells) sits at pixel x + 1/2.
    The padding and the coordinates are built outside the timed call, as
    the deposit's index_add_ pairs are. Before it is timed it must meet
    gather_vec_cl_plain within 1e-5 x max on a smooth field (the low modes
    of the box): grid_sample unnormalises its coordinate in float32, about
    3e-5 of a cell at 256^3, which a white-noise field turns into errors
    above 1e-5 x max (logged, not checked). checked=False times it
    alone (at 512^3, where the 256^3 check stands for it).

    With ``plane0`` the field is a slab's x-extended one (C, n_planes + 1,
    M, M), at drift 0, and the columns are the slab's own: x is not padded
    (the halo plane is in the field; extended plane i has its centre at
    pixel i, so a position x sits at pixel x - plane0 - 1/2) and the twin
    is gather_vec_slab_plain."""
    import math

    fn = torch.nn.functional
    slab = plane0 is not None
    nx = field.shape[1]
    real = (ps[0] < tp.SENTINEL_MIN) & (
        torch.arange(ps.shape[1], device="cuda") < ts[-1])
    xs = ps[:3, real].double() * m
    coords = (2.0 * (xs + 0.5) + 1.0) / (m + 2) - 1.0  # (x, y, z) rows
    if slab:
        coords[0] = 2.0 * (xs[0] - plane0) / nx - 1.0
    grid = coords.flip(0).T.float().reshape(1, 1, 1, -1, 3).contiguous()
    del xs, coords

    def sample(f):
        pad = fn.pad(f[None], (1, 1, 1, 1, 0, 0) if slab
                     else (1, 1, 1, 1, 1, 1), mode="circular")
        return pad, lambda: fn.grid_sample(pad, grid, mode="bilinear",
                                           padding_mode="zeros",
                                           align_corners=False)

    def error(f):
        _, call = sample(f)
        got = call().reshape(3, -1)
        want = (tp.gather_vec_slab_plain(f, ps, ts, "cic", 0, plane0) if slab
                else tp.gather_vec_cl_plain(f, ps, ts, "cic"))[:3, real]
        return float((got - want).abs().max()), float(want.abs().max())

    if not checked:
        _, call = sample(field)
        return time_ms(torch, call)
    a = torch.arange(m, device="cuda", dtype=torch.float32) * (2 * math.pi / m)
    ax = a if not slab else (torch.arange(nx, device="cuda") + plane0) * (
        2 * math.pi / m)
    x, y, z = torch.meshgrid(ax.float(), a, a, indexing="ij")
    smooth = torch.stack([torch.sin(x + 2 * y), torch.cos(y - z),
                          torch.sin(3 * z + x)])
    del x, y, z
    err, scale = error(smooth)
    check(err <= 1e-5 * scale, f"grid_sample vs gather twin {err:.3e} > "
          f"1e-5 x {scale:.3e} (smooth field, 256^3 CIC drift 0)")
    del smooth
    err_r, scale_r = error(field)
    log(f"[3 bounds] grid_sample vs the gather's twin"
        f"{' on a slab' if slab else ''}, 256^3 CIC drift 0:"
        f" {err:.2e} of max {scale:.3e} on a smooth field (bound 1e-5 x "
        f"max); {err_r:.2e} of max {scale_r:.3e} on the white-noise field")
    _, call = sample(field)
    return time_ms(torch, call)


def _grids(torch, n, gen):
    x = torch.randn((n, n, n), generator=gen, device="cuda")
    b = 5.0 * torch.randn((n, n, n), generator=gen, device="cuda")
    rhs = 0.3 * torch.randn((n, n, n), generator=gen, device="cuda")
    return x, b, rhs


def _agree(name, got, want, rel, what):
    """Max |got - want|, checked against rel x max |want|."""
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    check(err <= rel * scale, f"{name} vs twin {err:.3e} > {rel} x "
          f"{scale:.3e} ({what})")
    return err


def _scalaron_inputs(torch, np, lap, n, gen):
    """A well-conditioned scalaron state (tests/test_pallas_stencil.py):
    u0 ~ 0.2 with |p| << 3 u0^2, so that the Newton root cannot amplify
    rounding; packed, with h^2 b and the FAS rhs packed too."""
    u0 = torch.randn((n, n, n), generator=gen, device="cuda").abs() * 0.003
    u0 += 0.2
    hb = 0.1 * float(np.float32(1.0 / (n * n))) * torch.randn(
        (n, n, n), generator=gen, device="cuda") * 5.0
    rhs = torch.randn((n, n, n), generator=gen, device="cuda")
    return lap.pack_rb(u0), lap.pack_rb(hb), rhs


# (neighbour power, q, FAS rhs scale) of the well-conditioned cases
SCALARON_CASES = ((2, -0.1, 1e-3), (3, -0.05, 1e-4))


def phase_scalaron_kernel(torch, np, lap, st, n, gen):
    """Kernel 4 against its twin at one size: n = 1 and 2, scalar and
    plane c0, both colours, bitwise (--fmad=false, IEEE division). Returns
    the largest |kernel - twin|."""
    (red, black), hb, rhs = _scalaron_inputs(torch, np, lap, n, gen)
    worst = 0.0
    for power, q, scale in SCALARON_CASES:
        c0 = float(np.float32(np.float32(1.0 / (n * n)) * np.float32(q)))
        r_p = lap.pack_rb(scale * rhs)
        for plane in (False, True):
            for to_red, c in ((True, 0), (False, 1)):
                src, dst = (black, red) if to_red else (red, black)
                coef = c0 - r_p[c] if plane else c0
                got = st.scalaron_half_sweep(src, dst, hb[c], coef, to_red,
                                             1.25, power)
                want = st.scalaron_half_sweep_plain(src, dst, hb[c], coef,
                                                    to_red, 1.25, power)
                tag = f"n={n} power={power} plane={plane} red={to_red}"
                e = _agree("scalaron_half_sweep", got, want, 2e-6, tag)
                check(torch.equal(got, want),
                      f"scalaron_half_sweep not bitwise its twin ({tag})")
                worst = max(worst, e)
                log(f"[3 stencil] n={n} scalaron_half_sweep power={power} "
                    f"plane={int(plane)} red={int(to_red)}: |k-twin| "
                    f"{e:.2e}, bitwise {int(torch.equal(got, want))}")
    return worst


def _exact_f64_counts(source=F64_COUNT_SRC,
                      parts=("d", "d_rhs", "cardano", "trig", "zero")):
    """The float64 instructions (:data:`F64_OPS`) in the SASS of each part
    of an exact-root sweep's work, compiled as the library is (``source``,
    by default the n = 1 sweep's :data:`F64_COUNT_SRC`; cuobjdump -sass):
    {part: count} for the ``parts`` its kernels ``f64_<part>`` hold. A
    static count: each instruction of a part's code once, the
    special-value paths inside libdevice's pow, acos and cos among
    them."""
    import re

    from pysco_tpu_torch.ops import cuda_build

    nvcc = cuda_build._nvcc()
    tmp = tempfile.mkdtemp(prefix="pysco_sass_")
    try:
        src = os.path.join(tmp, "count.cu")
        cubin = os.path.join(tmp, "count.cubin")
        with open(src, "w") as f:
            f.write(source)
        cmd = [nvcc, *cuda_build.FLAGS, "-I", str(cuda_build.CSRC),
               "-cubin", "-o", cubin, src]
        r = subprocess.run(cmd, capture_output=True, text=True)
        check(r.returncode == 0, f"count kernels: nvcc {r.stderr[-2000:]}")
        r = subprocess.run(
            [os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass",
             cubin], capture_output=True, text=True)
        check(r.returncode == 0, f"count kernels: cuobjdump {r.stderr}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    counts, name = {}, None
    for line in r.stdout.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)[4:] if m.group(1).startswith("f64_") else None
            if name is not None:
                counts[name] = 0
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)",
                     line)
        if name is not None and m and m.group(1) in F64_OPS:
            counts[name] += 1
    check(set(counts) == set(parts),
          f"count kernels: functions {sorted(counts)}")
    return counts


def _exact_f64_per_cell(torch, st, counts, src, hb, d1):
    """Float64 instructions a cell of one exact-root sweep on this state:
    the discriminant's and that of the branch each cell takes (d1 a float,
    or a float64 plane: the rhs form)."""
    p = (hb - st._INVSIX * st.packed_neighbour_sum(src * src, True)).double()
    d = d1 * d1 + 108.0 * (p * p * p)
    pos, neg = float((d > 0).double().mean()), float((d < 0).double().mean())
    base = counts["d" if isinstance(d1, float) else "d_rhs"]
    return (base + pos * counts["cardano"] + neg * counts["trig"]
            + (1.0 - pos - neg) * counts["zero"]), (pos, neg)


def phase_exact_root_kernel(torch, np, st):
    """The f(R) n = 1 sweep with the float64 closed-form root against its
    twin at n = 4, 8, 64, 256 and 512 on tests/exact_root_states.py's
    states, with a scalar d1 and the rhs plane, both colours: bitwise on
    every branch, within one float32 ulp where libdevice's pow(x, 1.5)
    differs from torch's (the count of cells not bitwise is logged); its
    times at 256^3 and 512^3 on the scalaron-like state (cells of both
    branches in every warp), with the rhs plane, and on a p smooth in x
    (one branch a warp, as in a simulation), beside its byte and float64
    bounds (the float64 work of the branch each cell takes) and the twin's
    time. Returns (ms, twin ms, bound, largest |kernel - twin|), times at
    256^3 without the plane, for the record."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from exact_root_states import exact_states

    worst = 0.0
    for n in (4, 8, 64, 256, 512):
        off = 0
        for name, ((src, dst, hb, rhs), d1_q) in exact_states(
                n, "cuda").items():
            for r in (None, rhs):
                for to_red in (True, False):
                    got = st.scalaron_exact_half_sweep(src, dst, hb, d1_q,
                                                       to_red, 1.25, r)
                    want = st.scalaron_exact_half_sweep_plain(
                        src, dst, hb, d1_q, to_red, 1.25, r)
                    check(bool(torch.isfinite(got).all()),
                          f"scalaron_exact_half_sweep: n={n} {name}: not "
                          "finite")
                    ulps = (got.view(torch.int32).long()
                            - want.view(torch.int32).long()).abs()
                    tag = f"n={n} {name} rhs={r is not None} red={to_red}"
                    check(int(ulps.max()) <= (1 if name == "pow" else 0),
                          f"scalaron_exact_half_sweep vs twin: "
                          f"{int(ulps.max())} float32 ulps ({tag})")
                    off += int((ulps > 0).sum())
                    worst = max(worst, float((got - want).abs().max()))
        log(f"[3 exact] n={n} scalaron_exact_half_sweep: bitwise its twin "
            f"on the branch and scalaron-like states, scalar and plane d1, "
            f"both colours; {off} cells one float32 ulp off on the pow "
            f"state; largest |kernel - twin| so far {worst:.3e}")
    counts = _exact_f64_counts()
    log(f"[3 exact] float64 instructions ({', '.join(F64_OPS)}) in the "
        f"SASS: discriminant {counts['d']} ({counts['d_rhs']} with the rhs "
        f"plane), Cardano {counts['cardano']}, trigonometric "
        f"{counts['trig']}, d == 0 {counts['zero']}")
    out = None
    for n in (256, 512):
        (src, dst, hb, rhs), _ = exact_states(n, "cuda")["scalaron"]
        d1 = 27.0 / (n * n) * -0.1
        i = torch.arange(n, device="cuda", dtype=torch.float32)
        smooth = 0.05 * torch.sin(2 * np.pi * i / n)[:, None, None] + 0 * hb
        t_k = time_ms(torch, lambda: st.scalaron_exact_half_sweep(
            src, dst, hb, d1, True, 1.25))
        t_r = time_ms(torch, lambda: st.scalaron_exact_half_sweep(
            src, dst, hb, d1, True, 1.25, rhs))
        t_s = time_ms(torch, lambda: st.scalaron_exact_half_sweep(
            src, dst, smooth, d1, True, 1.25))
        t_p = time_ms(torch, lambda: st.scalaron_exact_half_sweep_plain(
            src, dst, hb, d1, True, 1.25), 3)
        cells = hb.numel()
        f64 = {}
        for tag, h, dd in (("scalar", hb, d1),
                           ("rhs", hb, d1 - 27.0 * rhs.double()),
                           ("smooth", smooth, d1)):
            per, shares = _exact_f64_per_cell(torch, st, counts, src, h, dd)
            f64[tag] = per * cells / F64_INSTR_PER_S * 1e3
            log(f"[3 exact] {n}^3 {tag}: {per:.1f} float64 instructions a "
                f"cell (d > 0 on {shares[0]:.3f} of the cells, d < 0 on "
                f"{shares[1]:.3f})")
        b16 = 16 * cells / HBM_BYTES_PER_S * 1e3
        b20 = 20 * cells / HBM_BYTES_PER_S * 1e3
        log(f"[3 exact times] {n}^3 scalaron_exact_half_sweep: {t_k:.3f} ms "
            f"(rhs plane {t_r:.3f}, p smooth in x {t_s:.3f}), twin "
            f"{t_p:.3f}; bounds: bytes {b16:.4f} ms ({b20:.4f} with the "
            f"plane), float64 {f64['scalar']:.4f} ms ({f64['rhs']:.4f} with "
            f"the plane, {f64['smooth']:.4f} smooth in x)")
        if out is None:
            out = (t_k, t_p, (max(b16, f64["scalar"]),
                              "bytes" if b16 >= f64["scalar"] else "float64"))
        del src, dst, hb, rhs, smooth
        torch.cuda.empty_cache()
    return (*out, worst)


def _quartic_f64_per_cell(torch, st, counts, src, hb, c, to_red=True):
    """Float64 instructions a cell of one quartic exact-root sweep on this
    state (c a float, or a float64 plane: the rhs form), from the branch
    each cell takes, and the shares of the cells on each branch."""
    from exact_root_states import quartic_branches

    p = hb - st._INVSIX * st.packed_neighbour_sum(src * src * src, to_red)
    br = {k: float(v.double().mean())
          for k, v in quartic_branches(p, c).items()}
    head = counts["head" if isinstance(c, float) else "head_rhs"]
    fb = counts["fallback"]
    per = (br["p_zero"] * fb + br["sqrt_term_neg"] * (head + fb)
           + br["qdq_not_pos"] * (head + counts["resolvent"] + fb)
           + br["p_pos"] * (head + counts["resolvent"] + counts["tail_pos"])
           + br["p_neg"] * (head + counts["resolvent"]
                            + counts["tail_neg"]))
    return per, br


def _quartic_converged(torch, np, lap, n, c_q=-0.5):
    """A packed quartic state its sweep leaves where it is: u* = 1 +
    0.05 noise and b such that u* solves u^4 + p u + c_q = 0, p = h^2 b -
    sum_nb(u*^3)/6 (in float64, cast to float32), as tests/test_torch_fr.py
    builds it. Returns ((red, black), (h^2 b red, black), c_q): a red
    update reads black as its src."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(n)
    u = 1.0 + 0.05 * torch.randn((n, n, n), generator=gen, device="cuda",
                                 dtype=torch.float64)
    u = u.float().double()
    u3 = u * u * u
    S = sum(torch.roll(u3, sh, a) for a in range(3) for sh in (1, -1))
    h2 = float(np.float32(1.0 / (n * n)))
    b = ((S / 6.0) * u - u ** 4 - c_q) / (h2 * u)
    hb = lap.pack_rb((h2 * b).float())
    del S, b
    return lap.pack_rb(u.float()), hb, c_q


def phase_quartic_exact_kernel(torch, np, st):
    """The f(R) n = 2 sweep with the float64 closed-form quartic root
    against its twin at n = 4, 8, 64, 256 and 512 on
    tests/exact_root_states.py's quartic states (every branch of the
    closed form), with a scalar c and the rhs plane, both colours: bitwise
    but where libdevice's pow built with --fmad=false rounds a float64 ulp
    away from torch's (``quartic_off_cells``: within one float32 ulp, or
    bitwise the twin with its cube root one ulp away), those cells counted
    and logged; its times at 256^3 and
    512^3 on a converged state (p < 0 on every cell), on the mixed-branch
    state (every branch in every warp) and with the rhs plane, beside its
    byte and float64 bounds (the float64 work of the branch each cell
    takes) and the twin's time. Returns (ms, twin ms, bound, largest
    |kernel - twin|), times at 256^3 on the converged state without the
    plane, for the record."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from exact_root_states import quartic_off_cells, quartic_states
    from pysco_tpu_torch.models import laplacian as lap

    name_k = "scalaron_quartic_exact_half_sweep"
    worst = 0.0
    for n in (4, 8, 64, 256, 512):
        off = far = cells = 0
        for name, ((src, dst, hb, rhs), c_q) in quartic_states(
                n, "cuda").items():
            for r in (None, rhs):
                for to_red in (True, False):
                    got = st.scalaron_quartic_exact_half_sweep(
                        src, dst, hb, c_q, to_red, 1.25, r)
                    want = st.scalaron_quartic_exact_half_sweep_plain(
                        src, dst, hb, c_q, to_red, 1.25, r)
                    check(bool(torch.isfinite(got).all()),
                          f"{name_k}: n={n} {name}: not finite")
                    k = quartic_off_cells(got, src, dst, hb, c_q, to_red, r)
                    tag = f"n={n} {name} rhs={r is not None} red={to_red}"
                    check(k["explained"] == k["off"],
                          f"{name_k} vs twin: {k} ({tag})")
                    off += k["off"]
                    far += k["far"]
                    cells += got.numel()
                    worst = max(worst, float((got - want).abs().max()))
        log(f"[3 quartic] n={n} {name_k}: bitwise its twin on the branch, "
            f"positive and scalaron-like states, scalar and plane c, both "
            f"colours, but {off} of {cells} cells, each within one float32 "
            f"ulp or ({far} cells) the twin with its cube root one float64 "
            f"ulp away; largest |kernel - twin| so far {worst:.3e}")
    counts = _exact_f64_counts(
        F64_QUARTIC_COUNT_SRC,
        ("head", "head_rhs", "resolvent", "tail_pos", "tail_neg",
         "fallback"))
    log(f"[3 quartic] float64 instructions ({', '.join(F64_OPS)}) in the "
        f"SASS: head {counts['head']} ({counts['head_rhs']} with the rhs "
        f"plane), Q + d0/Q {counts['resolvent']}, tail p > 0 "
        f"{counts['tail_pos']}, p < 0 {counts['tail_neg']}, fallback "
        f"{counts['fallback']}")
    out = None
    for n in (256, 512):
        (dst, src), (hb, _), c_q = _quartic_converged(torch, np, lap, n)
        (msrc, mdst, mhb, mrhs), mc_q = quartic_states(n, "cuda")["branch"]
        rhs = 1e-4 * mrhs
        t_k = time_ms(torch, lambda: st.scalaron_quartic_exact_half_sweep(
            src, dst, hb, c_q, True, 1.25))
        t_r = time_ms(torch, lambda: st.scalaron_quartic_exact_half_sweep(
            src, dst, hb, c_q, True, 1.25, rhs))
        t_m = time_ms(torch, lambda: st.scalaron_quartic_exact_half_sweep(
            msrc, mdst, mhb, mc_q, True, 1.25))
        plain = st.scalaron_quartic_exact_half_sweep_plain
        t_p = time_ms(torch, lambda: plain(src, dst, hb, c_q, True, 1.25), 3)
        moved = st.scalaron_quartic_exact_half_sweep(src, dst, hb, c_q, True,
                                                     1.25)
        dev = float((moved - dst).abs().max())
        cells = hb.numel()
        f64 = {}
        for tag, (s_, h_, c_) in (
                ("converged", (src, hb, c_q)),
                ("rhs", (src, hb, c_q - rhs.double())),
                ("mixed", (msrc, mhb, mc_q))):
            per, br = _quartic_f64_per_cell(torch, st, counts, s_, h_, c_)
            f64[tag] = per * cells / F64_INSTR_PER_S * 1e3
            log(f"[3 quartic] {n}^3 {tag}: {per:.1f} float64 instructions "
                f"a cell (" + ", ".join(f"{k} {v:.3f}" for k, v in br.items())
                + ")")
        b16 = 16 * cells / HBM_BYTES_PER_S * 1e3
        b20 = 20 * cells / HBM_BYTES_PER_S * 1e3
        log(f"[3 quartic times] {n}^3 {name_k}: converged {t_k:.3f} ms "
            f"(largest move {dev:.2e}), rhs plane {t_r:.3f}, mixed branches "
            f"{t_m:.3f}; twin {t_p:.3f}; bounds: bytes {b16:.4f} ms "
            f"({b20:.4f} with the plane), float64 {f64['converged']:.4f} ms "
            f"({f64['rhs']:.4f} with the plane, {f64['mixed']:.4f} mixed)")
        if out is None:
            b = max(b16, f64["converged"])
            out = (t_k, t_p, (b, "bytes" if b16 >= b else "float64"))
        del src, dst, hb, msrc, mdst, mhb, mrhs, rhs, moved
        torch.cuda.empty_cache()
    return (*out, worst)


def _norm2_check(torch, st, x, b, rhs):
    """residual_norm2 against its twin for the five kinds with and without
    rhs: within 5e-6 of the twin's sum (the kernel adds float32 squares
    in double, the twin in float32 by torch's tree), two calls bitwise
    equal. Returns the largest |kernel - twin|."""
    n = x.shape[0]
    worst = 0.0
    for kind, q in RESIDUAL_KINDS:
        bb = None if kind == "laplacian" else b
        for r in (None, rhs):
            tag = f"n={n} {kind} rhs={int(r is not None)}"
            got = st.residual_norm2(kind, x, bb, r, q)
            again = st.residual_norm2(kind, x, bb, r, q)
            want = st.residual_norm2_plain(kind, x, bb, r, q)
            torch.cuda.synchronize()
            check(torch.equal(got, again),
                  f"residual_norm2 not bitwise reproducible ({tag})")
            e = _agree("residual_norm2", got, want, 5e-6, tag)
            worst = max(worst, e)
            log(f"[3 stencil] {tag}: residual_norm2 |k-twin| {e:.2e} (of "
                f"{float(want):.6e})")
    return worst


def _norm2_variant(torch, st, kind, x, b, rhs, q, tile_rows, finish=True):
    """residual_norm2 by one of the designs csrc/residual.cu keeps for
    timing: the plane march with ``tile_rows`` (8 or 16) rows a tile, or
    (0) one thread a cell; ``finish`` False leaves the partials unsummed.
    Not counted in LAUNCHES: the main path never takes it."""
    code, needs_b, n, n2, h2, qf = st._kind_args(kind, x, b, q)
    lib = st._kernels()
    partial = torch.empty(lib.pysco_norm2_variant_blocks(n, tile_rows),
                          dtype=torch.float64, device=x.device)
    out = torch.empty((), dtype=torch.float32, device=x.device)
    e = lib.pysco_residual_norm2_variant(
        tile_rows, int(finish), code, x.data_ptr(),
        st._ptr(b if needs_b else None), st._ptr(rhs), n, n2, h2, qf,
        partial.data_ptr(), out.data_ptr(), st._stream(out))
    st._raise_on(e, "residual_norm2 variant")
    return out


def _norm2_kind_times(torch, st, x, b, rhs):
    """residual_norm2's time for each kind, without and with a rhs, each
    beside its bound: x, b (not ``laplacian``) and rhs read once."""
    n = x.shape[0]
    for kind, q in RESIDUAL_KINDS:
        bb = None if kind == "laplacian" else b
        parts = []
        for r in (None, rhs):
            t = time_ms(torch, lambda: st.residual_norm2(kind, x, bb, r, q))
            reads = 1 + (bb is not None) + (r is not None)
            bnd = bound(reads * x.numel() * 4, 11 * x.numel())
            parts.append(f"{'with' if r is not None else 'no'} rhs {t:.4f} "
                         f"ms (bound {bnd[0]:.4f})")
        log(f"[3 stencil times] {n}^3 residual_norm2 {kind}: "
            + ", ".join(parts))


def _norm2_times(torch, st, x, b, rhs):
    """The norm's designs timed one against another on an n^3 lattice:
    the wrapper's kernel, the march with 8 and 16 rows a tile, the march
    without its second launch, and one thread a cell; ``linear`` and
    ``cubic`` with a rhs, each beside its bound (x, b and rhs read once).
    The 8-row march is the wrapper's kernel, bitwise."""
    n = x.shape[0]
    for kind, r, q in (("linear", None, None), ("cubic", rhs, -0.27)):
        want = st.residual_norm2(kind, x, b, r, q)
        t = {"wrapper": time_ms(torch, lambda: st.residual_norm2(
            kind, x, b, r, q))}
        for name, rows, finish in (("march 8 rows", 8, True),
                                   ("march 16 rows", 16, True),
                                   ("march 8 rows, partials only", 8, False),
                                   ("one thread a cell", 0, True)):
            got = _norm2_variant(torch, st, kind, x, b, r, q, rows, finish)
            if finish:
                _agree("residual_norm2 variant", got, want, 1e-6,
                       f"n={n} {kind} {name}")
            if rows == 8 and finish:
                check(torch.equal(got, want), "the 8-row march is not the "
                      f"wrapper's kernel (n={n} {kind})")
            t[name] = time_ms(torch, lambda: _norm2_variant(
                torch, st, kind, x, b, r, q, rows, finish))
        bnd = bound((2 + (r is not None)) * x.numel() * 4, 11 * x.numel())
        log(f"[3 norm2 designs] {n}^3 {kind} rhs={int(r is not None)}: "
            + ", ".join(f"{k} {v:.4f} ms" for k, v in t.items())
            + f"; bound {bnd[0]:.4f} ms ({bnd[1]})")


def _prolongation_check(torch, st, y, gen):
    """add_prolongation bitwise its twin on a fine y and a random coarse
    grid; returns |kernel - twin| (0)."""
    n = y.shape[0]
    xc = torch.randn((n // 2,) * 3, generator=gen, device="cuda")
    got = st.add_prolongation(y, xc)
    want = st.add_prolongation_plain(y, xc)
    e = float((got - want).abs().max())
    check(torch.equal(got, want),
          f"add_prolongation not bitwise its twin: {e:.3e} (n={n})")
    log(f"[3 stencil] n={n} add_prolongation bitwise its twin")
    return e


def _interpolate_yardstick(torch, y, xc):
    """The prolongation's one-call yardstick: trilinear ``interpolate``
    (scale 2, align_corners=False) of the coarse grid padded by one
    periodic cell a side; fine index 2 + i of its output is
    prolongation(xc)[i] (fine 2r = 3/4 x[r] + 1/4 x[r - 1], the twin's
    weights). The pad is built outside the timed call, and the call adds
    no y. Before it is timed, y plus its crop must meet the twin within
    1e-5 x max: its weights are products of the per-axis fractions, not
    the twin's three rounded blends. Returns (ms, |y + crop - twin|,
    max |twin|)."""
    from pysco_tpu_torch.ops import stencil as st

    fn = torch.nn.functional
    n = y.shape[0]
    pad = fn.pad(xc[None, None], (1, 1, 1, 1, 1, 1), mode="circular")

    def call():
        return fn.interpolate(pad, scale_factor=2, mode="trilinear",
                              align_corners=False)

    crop = call()[0, 0, 2:n + 2, 2:n + 2, 2:n + 2]
    want = st.add_prolongation_plain(y, xc)
    err = float((y + crop - want).abs().max())
    scale = float(want.abs().max())
    check(err <= 1e-5 * scale, f"interpolate vs add_prolongation twin "
          f"{err:.3e} > 1e-5 x {scale:.3e} (n={n})")
    del crop, want
    return time_ms(torch, call), err, scale


def phase_stencil_kernels(torch, np):
    """Kernels 3-7 against their twins at the multigrid sizes."""
    from pysco_tpu_torch.models import laplacian as lap
    from pysco_tpu_torch.ops import stencil as st

    gen = torch.Generator(device="cuda")
    gen.manual_seed(4321)
    err = dict.fromkeys(("half_sweep", "scalaron_half_sweep",
                         "residual_norm2", "restrict3", "add_prolongation"),
                        0.0)
    for n in (16, 128, 256, 512):
        err["scalaron_half_sweep"] = max(
            err["scalaron_half_sweep"],
            phase_scalaron_kernel(torch, np, lap, st, n, gen))
        x, b, rhs = _grids(torch, n, gen)
        red, black = lap.pack_rb(x)
        h2b = lap.pack_rb(b * float(np.float32(1.0 / (n * n))))
        rhs_p = lap.pack_rb(rhs)
        for to_red, c in ((True, 0), (False, 1)):
            src, dst = (black, red) if to_red else (red, black)
            for r in (None, rhs_p[c]):
                got = st.half_sweep(src, dst, h2b[c], to_red, 1.25, r)
                want = st.half_sweep_plain(src, dst, h2b[c], to_red, 1.25, r)
                e = _agree("half_sweep", got, want, 2e-6,
                           f"n={n} red={to_red} rhs={r is not None}")
                err["half_sweep"] = max(err["half_sweep"], e)
                log(f"[3 stencil] n={n} half_sweep red={int(to_red)} "
                    f"rhs={int(r is not None)}: |k-twin| {e:.2e}, bitwise "
                    f"{int(torch.equal(got, want))}")
        del red, black, h2b, rhs_p
        err["residual_norm2"] = max(err["residual_norm2"],
                                    _norm2_check(torch, st, x, b, rhs))
        for kind, q in RESIDUAL_KINDS:
            bb = None if kind == "laplacian" else b
            for r in (None, rhs):
                tag = f"n={n} {kind} rhs={int(r is not None)}"
                outs = st.restrict3(kind, x, bb, r, q)
                twins = st.restrict3_plain(kind, x, bb, r, q)
                check(len(outs) == len(twins), f"restrict3 outputs ({tag})")
                e_r = max(_agree("restrict3", o, t, 2e-6, tag)
                          for o, t in zip(outs, twins))
                (only,) = st.restrict3(kind, x, bb, r, q, residual_only=True)
                check(torch.equal(only, outs[0]),
                      f"restrict3 residual_only differs ({tag})")
                err["restrict3"] = max(err["restrict3"], e_r)
                log(f"[3 stencil] {tag}: restrict3 |k-twin| {e_r:.2e}")
        err["add_prolongation"] = max(err["add_prolongation"],
                                      _prolongation_check(torch, st, x, gen))
        del x, b, rhs
    # the prolongation's ragged tiles and, at n = 6, one thread a cell; the
    # norm's per-cell kernel (n < 32 or not a multiple of 4) and, at n = 36
    # and 132, its march over ragged tiles
    for n in (4, 6, 8, 24, 36, 132):
        x, b, rhs = _grids(torch, n, gen)
        _prolongation_check(torch, st, x, gen)
        err["residual_norm2"] = max(err["residual_norm2"],
                                    _norm2_check(torch, st, x, b, rhs))
    # times at the main path's grid, 256^3
    n = 256
    x, b, rhs = _grids(torch, n, gen)
    red, black = lap.pack_rb(x)
    h2b_r, _ = lap.pack_rb(b * float(np.float32(1.0 / (n * n))))
    xc = torch.randn((n // 2,) * 3, generator=gen, device="cuda")
    (s_red, s_black), s_hb, s_rhs = _scalaron_inputs(torch, np, lap, n, gen)
    c0 = float(np.float32(np.float32(1.0 / (n * n)) * np.float32(-0.1)))
    s_plane = c0 - lap.pack_rb(1e-3 * s_rhs)[0]
    calls = {
        "half_sweep": (lambda: st.half_sweep(black, red, h2b_r, True, 1.25),
                       lambda: st.half_sweep_plain(black, red, h2b_r, True,
                                                   1.25)),
        "scalaron_half_sweep": (
            lambda: st.scalaron_half_sweep(s_black, s_red, s_hb[0], c0,
                                           True, 1.25, 2),
            lambda: st.scalaron_half_sweep_plain(s_black, s_red, s_hb[0],
                                                 c0, True, 1.25, 2)),
        "residual_norm2": (
            lambda: st.residual_norm2("linear", x, b),
            lambda: st.residual_norm2_plain("linear", x, b)),
        "restrict3": (
            lambda: st.restrict3("linear", x, b, residual_only=True),
            lambda: st.restrict3_plain("linear", x, b, residual_only=True)),
        "add_prolongation": (lambda: st.add_prolongation(x, xc),
                             lambda: st.add_prolongation_plain(x, xc)),
    }
    times = {}
    for name, (kern, twin) in calls.items():
        times[name] = time_ms(torch, kern)
        times[f"{name}_plain"] = time_ms(torch, twin)
        log(f"[3 stencil times] 256^3 {name}: {times[name]:.3f} ms (twin "
            f"{times[f'{name}_plain']:.3f})")
    for power in (2, 3):
        t_s = time_ms(torch, lambda: st.scalaron_half_sweep(
            s_black, s_red, s_hb[0], c0, True, 1.25, power))
        t_p = time_ms(torch, lambda: st.scalaron_half_sweep(
            s_black, s_red, s_hb[0], s_plane, True, 1.25, power))
        log(f"[3 stencil times] 256^3 scalaron_half_sweep power={power}: "
            f"scalar c0 {t_s:.3f} ms, plane c0 {t_p:.3f} ms")
    (b_red, b_black), b_hb, _ = _scalaron_inputs(torch, np, lap, 512, gen)
    b_c0 = float(np.float32(np.float32(1.0 / 512 ** 2) * np.float32(-0.1)))
    t_b = time_ms(torch, lambda: st.scalaron_half_sweep(
        b_black, b_red, b_hb[0], b_c0, True, 1.25, 2))
    # converged cells: a uniform u0 that is its own Newton root, f = 0 at
    # every step (the late V-cycles of a solve)
    u0, hbv = np.float32(1.0216), np.float32(3e-6)
    nb0 = np.float32(0.0)
    for _ in range(6):  # the kernel's neighbour sum, in its order
        nb0 = np.float32(nb0 + np.float32(u0 * u0))
    p0 = np.float32(hbv - np.float32(np.float32(1.0 / 6.0) * nb0))
    f0 = float(np.float32(u0 * np.float32(np.float32(u0 * u0) + p0)))
    b_red.fill_(float(u0))
    b_hb[0].fill_(float(hbv))
    t_c = time_ms(torch, lambda: st.scalaron_half_sweep(
        b_red, b_red, b_hb[0], -f0, True, 1.25, 2))
    check(torch.equal(st.scalaron_half_sweep(b_red, b_red, b_hb[0], -f0,
                                             True, 1.25, 2), b_red),
          "converged scalaron cells moved")
    log(f"[3 stencil times] 512^3 scalaron_half_sweep power=2: scalar c0 "
        f"{t_b:.3f} ms, converged cells {t_c:.3f} ms (bound "
        f"{bound(4 * b_red.numel() * 4, 44 * b_red.numel())[0]:.4f} ms)")
    del b_red, b_black, b_hb
    for kind, q in RESIDUAL_KINDS[1:]:
        bb = None if kind == "laplacian" else b
        t_r = time_ms(torch, lambda: st.restrict3(kind, x, bb, q=q))
        t_rr = time_ms(torch, lambda: st.restrict3(kind, x, bb, rhs, q=q))
        log(f"[3 stencil times] 256^3 {kind}: restrict3 {t_r:.3f} ms (with "
            f"rhs {t_rr:.3f} ms)")
    _norm2_kind_times(torch, st, x, b, rhs)
    _norm2_times(torch, st, x, b, rhs)
    x5, b5, rhs5 = _grids(torch, 512, gen)
    _norm2_kind_times(torch, st, x5, b5, rhs5)
    _norm2_times(torch, st, x5, b5, rhs5)
    del x5, b5, rhs5
    torch.cuda.empty_cache()
    # bounds of the timed calls: each operand read once, each output
    # written once, in bytes; the operations per cell (neighbour sum 5,
    # update 4 for the half-sweep; the neighbour cubes 12, p 2 and 3
    # Newton steps of ~10 with a division for the scalaron sweep; the
    # linear residual 9 and its square-sum 2; 8 more a coarse cell for
    # the restriction; 13 a fine cell for the prolongation)
    half = red.numel() * 4
    full = x.numel() * 4
    coarse = xc.numel() * 4
    meta = {
        "half_sweep": bound(4 * half, 9 * red.numel()),
        "scalaron_half_sweep": bound(4 * half, 44 * red.numel()),
        "residual_norm2": bound(2 * full, 11 * x.numel()),
        "restrict3": bound(2 * full + coarse, 9 * x.numel() + 8 * xc.numel()),
        "add_prolongation": bound(2 * full + coarse, 13 * x.numel()),
    }
    for name, (ms, by) in meta.items():
        if name != "add_prolongation":
            log(f"[3 bounds] 256^3 {name}: {ms:.4f} ms ({by}); no single "
                "PyTorch call computes it")
    meta = {k: {"bound": v, "library_ms": None} for k, v in meta.items()}
    meta["add_prolongation"]["library_ms"] = _prolongation_times(
        torch, st, x, xc, meta["add_prolongation"]["bound"], times, gen)
    for name, phase in (("scalaron_exact_half_sweep",
                         phase_exact_root_kernel),
                        ("scalaron_quartic_exact_half_sweep",
                         phase_quartic_exact_kernel)):
        times[name], times[f"{name}_plain"], bnd, err[name] = phase(
            torch, np, st)
        meta[name] = {"bound": bnd, "library_ms": None}
    return err, times, meta


def _prolongation_times(torch, st, x, xc, bnd, times, gen):
    """The prolongation's yardstick at 256^3 (returned, for the record)
    and the kernel, its twin and the yardstick at 512^3 with its bound
    (logged)."""
    lib, e, scale = _interpolate_yardstick(torch, x, xc)
    log(f"[3 bounds] 256^3 add_prolongation: {bnd[0]:.4f} ms ({bnd[1]}); "
        f"kernel {times['add_prolongation']:.4f} ms, interpolate {lib:.4f} "
        f"ms (y + its crop vs the twin {e:.2e} of max {scale:.3e})")
    n = 512
    y = torch.randn((n, n, n), generator=gen, device="cuda")
    xc5 = torch.randn((n // 2,) * 3, generator=gen, device="cuda")
    t_k = time_ms(torch, lambda: st.add_prolongation(y, xc5))
    t_p = time_ms(torch, lambda: st.add_prolongation_plain(y, xc5), 3)
    lib5, e5, scale5 = _interpolate_yardstick(torch, y, xc5)
    b5 = bound(2 * y.numel() * 4 + xc5.numel() * 4, 13 * y.numel())
    log(f"[3 stencil times] 512^3 add_prolongation: {t_k:.4f} ms (twin "
        f"{t_p:.3f}), bound {b5[0]:.4f} ms ({b5[1]}), interpolate "
        f"{lib5:.4f} ms (vs the twin {e5:.2e} of max {scale5:.3e})")
    del y, xc5
    torch.cuda.empty_cache()
    return lib


def phase_pk_bitwise(torch):
    from pysco_tpu_torch.ops import fourier

    gen = torch.Generator(device="cuda")
    gen.manual_seed(99)
    n = 256
    density = 1.0 + 0.3 * torch.randn((n, n, n), generator=gen, device="cuda")
    xk = fourier.rfft3(density)
    first = fourier.power_spectrum(xk, 3)
    again = fourier.power_spectrum(xk, 3)
    for a, c in zip(first, again):
        check(torch.equal(a, c), "P(k) not bitwise reproducible")
    twin = fourier.power_spectrum(xk.cpu(), 3)
    rel = max(float(((a.cpu() - c).abs() / c.abs()).max())
              for a, c in zip(first, twin))
    check(rel < 1e-5, f"P(k) on the card vs the CPU: {rel:.2e}")
    log(f"[4 pk] 256^3: two P(k) bitwise equal ({first[0].shape[0]} bins); "
        f"card vs CPU max rel {rel:.2e}")


GOLDEN_PARAM = {
    "theory": "newton", "H0": 72, "Om_m": 0.25733, "T_cmb": 2.726,
    "N_eff": 3.044, "w0": -1.0, "wa": 0.0, "boxlen": 100,
    "ncoarse": 5, "npart": 16 ** 3, "z_start": 49, "seed": 42,
    "position_ICS": "center", "fixed_ICS": True, "paired_ICS": False,
    "dealiased_ICS": False, "initial_conditions": "2LPT",
    "output_snapshot_format": "npz", "z_out": "[5, 1, 0]",
    "save_power_spectrum": "z_out", "integrator": "leapfrog",
    "mass_scheme": "TSC", "n_reorder": 50, "Courant_factor": 1.0,
    "max_aexp_stepping": 10, "linear_newton_solver": "fft",
    "gradient_stencil_order": 5, "Npre": 2, "Npost": 1,
    "epsrel": 1e-2, "verbose": 0, "particle_engine": "pallas",
    "lazy_sort": True, "pm_precision_widened": "bf16x3",
}


def phase_golden(np, tmp, mode="single", devices=None, tag="4 golden",
                 engine="pallas"):
    """The golden configuration through run(), in any parallel mode and
    with any particle engine, the launch counts zeroed just before and read
    just after. Returns (worst P(k) difference, base, launches)."""
    import pysco_tpu_torch
    from pysco_tpu_torch.cosmo import write_power_spectrum_table
    from pysco_tpu_torch.ops import stencil, tiled_pm

    pk_file = os.path.join(tmp, "pk.dat")
    write_power_spectrum_table(pk_file)
    base = os.path.join(tmp, f"golden_{mode}_{engine}")
    param = dict(GOLDEN_PARAM, power_spectrum_file=pk_file, base=base,
                 parallel_mode=mode, particle_engine=engine)
    tiled_pm.reset_launches()
    stencil.reset_launches()
    t0 = time.perf_counter()
    recs = pysco_tpu_torch.run(param, device="cuda", devices=devices)
    wall = time.perf_counter() - t0
    launches = {**tiled_pm.LAUNCHES, **stencil.LAUNCHES}
    with open(os.path.join(REPO, "tests", "golden_pk_32.json")) as f:
        golden = {k: np.array(v) for k, v in json.load(f).items()}
    got = sorted(os.listdir(os.path.join(base, "power")))
    check(got == sorted(golden), f"P(k) files {got} != {sorted(golden)}")
    worst = 0.0
    for name in got:
        a = np.loadtxt(os.path.join(base, "power", name))
        b = golden[name]
        np.testing.assert_allclose(a[:, 0], b[:, 0], rtol=1e-6)
        sel = a[:, 2] >= 8
        rel = float((np.abs(a[sel, 1] - b[sel, 1]) / np.abs(b[sel, 1])).max())
        check(rel < 1e-4, f"golden {name}: max rel P(k) diff {rel:.2e}")
        worst = max(worst, rel)
    log(f"[{tag}] {mode}"
        f"{' on ' + str(len(devices)) + ' shards' if devices else ''}"
        f"{', ' + engine + ' engine' if engine != 'pallas' else ''}: "
        f"{len(recs)} steps in {wall:.2f} s; max rel P(k) diff "
        f"vs tests/golden_pk_32.json {worst:.2e} (bound 1e-4)")
    return worst, base, launches


def _check_launches(recs, names, tag):
    """Every step of a run must have launched each kernel of ``names``."""
    prev = dict.fromkeys(names, 0)
    for r in recs:
        for k in names:
            check(r.launches[k] > prev[k],
                  f"{tag} step {r.nsteps}: the {k} kernel did not launch")
        prev = {k: r.launches[k] for k in names}
        check(r.overflow == 0, f"{tag} step {r.nsteps}: {r.overflow} "
              "drift-bound violations")


def _check_outputs(torch, np, base, n, scheme, tag):
    """The final npz snapshot re-deposits to mean density 1; every P(k)
    file is finite and positive. Returns the snapshot's arrays."""
    from pysco_tpu_torch.ops import tiled_pm as tp
    from pysco_tpu_torch.utils import io as iostream

    snap = [f for f in os.listdir(os.path.join(base, "output_00001"))
            if f.endswith(".npz")]
    check(len(snap) == 1, f"{tag}: snapshot files {snap}")
    pos, vel = iostream.read_snapshot_particles_npz(
        os.path.join(base, "output_00001", snap[0]))
    check(pos.shape == (n ** 3, 3) and np.isfinite(vel).all(),
          f"{tag}: bad final snapshot")
    pc, vc = tp.to_columns_host(pos, vel, n ** 3)
    ps, _, ts = tp.sort_particles(torch.as_tensor(pc, device="cuda"),
                                  torch.as_tensor(vc, device="cuda"), n,
                                  scheme)
    mean = float(tp.deposit(ps, ts, n, scheme).double().mean())
    check(abs(mean - 1.0) < 1e-5, f"{tag}: density mean {mean}")
    pks = sorted(os.listdir(os.path.join(base, "power")))
    check(pks, f"{tag}: no P(k) written")
    for name in pks:
        data = np.loadtxt(os.path.join(base, "power", name))
        check(np.isfinite(data).all() and (data[:, 1] > 0).all(),
              f"{tag}: bad P(k) in {name}")
    log(f"[{tag}] density mean {mean:.9f}; {len(pks)} finite P(k) files")
    return pos, vel


def _drive(torch, tmp, tag, overrides, names, devices=None):
    """One run of the port on the card at 256^3-class sizes, the launch
    counts and multigrid statistics zeroed just before and read just
    after; ``devices`` is the mesh of a multi-device mode. Returns
    (records, launches, multigrid stats, base)."""
    import pysco_tpu_torch
    from pysco_tpu_torch.cosmo import write_power_spectrum_table
    from pysco_tpu_torch.models import multigrid
    from pysco_tpu_torch.ops import stencil, tiled_pm

    pk_file = os.path.join(tmp, f"pk_{tag}.dat")
    write_power_spectrum_table(pk_file)
    base = os.path.join(tmp, tag)
    param = dict(GOLDEN_PARAM)
    param.update({"fixed_ICS": False, "power_spectrum_file": pk_file,
                  "base": base, "verbose": 0})
    param.update(overrides)
    del param["pm_precision_widened"]  # the production default
    tiled_pm.reset_launches()
    stencil.reset_launches()
    multigrid.reset_stats()
    t0 = time.perf_counter()
    recs = pysco_tpu_torch.run(param, device="cuda", devices=devices)
    wall = time.perf_counter() - t0
    launches = {**tiled_pm.LAUNCHES, **stencil.LAUNCHES}
    stats = dict(multigrid.STATS)
    _check_launches(recs, names, tag)
    drifts = [r.drift for r in recs]
    log(f"[{tag}] {len(recs)} steps in {wall:.1f} s (with ICs and "
        f"I/O); drift levels {drifts}")
    log(f"[{tag}] step wall times ms: "
        + " ".join(f"{1e3 * r.seconds:.1f}" for r in recs))
    return recs, launches, stats, base


MAIN_OVERRIDES = {"boxlen": 500.0, "ncoarse": 8, "npart": 256 ** 3,
                  "z_out": "[2]", "mass_scheme": "CIC"}


def phase_main_path(torch, np, tmp):
    n = 256
    recs, launches, _, base = _drive(torch, tmp, "5 main", MAIN_OVERRIDES,
                                     ("deposit", "gather"))
    drifts = [r.drift for r in recs]
    check(len(recs) >= 8, f"only {len(recs)} steps")
    check(any(drifts), "no stale-bin step")
    check(any(d == 0 for d in drifts[drifts.index(max(drifts)):]),
          "no re-sort after a stale-bin step")
    sorted_ms = [1e3 * r.seconds for r in recs[1:] if r.drift == 0]
    stale_ms = [1e3 * r.seconds for r in recs[1:] if r.drift]
    log(f"[5 main] median step: sorted {np.median(sorted_ms):.1f} ms "
        f"({len(sorted_ms)} steps), stale-bin {np.median(stale_ms):.1f} ms "
        f"({len(stale_ms)} steps); first step excluded")
    _check_outputs(torch, np, base, n, "cic", "5 main")
    log(f"[5 main] launches deposit {launches['deposit']}, gather "
        f"{launches['gather']}")
    return base, float(np.median(stale_ms)), float(np.median(sorted_ms))


E2E_PARAM = {  # tests/test_e2e.py's base configuration, npz snapshots
    "theory": "newton", "fR_logfR0": 5, "fR_n": 1,
    "mond_function": "simple", "mond_g0": 1.2,
    "mond_scale_factor_exponent": 0, "mond_alpha": 1,
    "parametrized_mu0": -0.1, "H0": 72, "Om_m": 0.25733, "T_cmb": 2.726,
    "N_eff": 3.044, "w0": -1.0, "wa": 0.0, "boxlen": 100, "ncoarse": 4,
    "npart": 16 ** 3, "z_start": 49, "seed": 42, "position_ICS": "center",
    "fixed_ICS": False, "paired_ICS": False, "dealiased_ICS": False,
    "initial_conditions": "2LPT", "output_snapshot_format": "npz",
    "z_out": "[40]", "save_power_spectrum": "z_out",
    "integrator": "leapfrog", "mass_scheme": "TSC", "n_reorder": 3,
    "Courant_factor": 1.0, "max_aexp_stepping": 10,
    "linear_newton_solver": "multigrid", "gradient_stencil_order": 5,
    "Npre": 2, "Npost": 1, "epsrel": 1e-2, "verbose": 0,
}


def phase_mg_e2e(np, tmp, rows, tag):
    """tests/test_e2e.py multigrid rows on the card (twice) and on the
    CPU: P(k) within 1e-4, the card's reruns bitwise equal."""
    import pysco_tpu_torch
    from pysco_tpu_torch.utils import io as iostream

    k = np.logspace(-3, 2, 200)
    pk_file = os.path.join(tmp, "pk_e2e.dat")
    np.savetxt(pk_file, np.c_[k, 2e4 * (k / 0.02)
                              / (1 + (k / 0.02) ** 2) ** 2 * 1e2])

    def outputs(base):
        snap = [f for f in os.listdir(os.path.join(base, "output_00001"))
                if f.endswith(".npz")]
        check(len(snap) == 1, f"e2e snapshot files {snap}")
        pks = sorted(os.listdir(os.path.join(base, "power")))
        return (iostream.read_snapshot_particles_npz(
            os.path.join(base, "output_00001", snap[0])),
            {p: np.loadtxt(os.path.join(base, "power", p)) for p in pks})

    for row, over in rows:
        got = {}
        for run, device in (("a", "cuda"), ("b", "cuda"), ("cpu", "cpu")):
            base = os.path.join(tmp, f"e2e_{row}_{run}")
            pysco_tpu_torch.run(dict(E2E_PARAM, power_spectrum_file=pk_file,
                                     base=base, **over), device=device)
            got[run] = outputs(base)
        for x, y in zip(got["a"][0], got["b"][0]):
            check(np.array_equal(x, y),
                  f"{row}: two card runs differ in their final snapshot")
        check(got["a"][1].keys() == got["cpu"][1].keys() and got["a"][1],
              f"{row}: P(k) files differ")
        worst = 0.0
        for name, a in got["a"][1].items():
            check(np.array_equal(a, got["b"][1][name]),
                  f"{row}: two card runs differ in {name}")
            c = got["cpu"][1][name]
            check(np.array_equal(a[:, 2], c[:, 2]), f"{row}: mode counts")
            sel = c[:, 2] >= 8
            rel = float((np.abs(a[sel, 1] - c[sel, 1]) / c[sel, 1]).max())
            check(rel < 1e-4, f"{row} {name}: card vs CPU P(k) {rel:.2e}")
            worst = max(worst, rel)
        log(f"[{tag}] {row}: two card runs bitwise equal; card vs CPU "
            f"max rel P(k) {worst:.2e} (bound 1e-4)")


def phase_mg_main_path(torch, np, tmp):
    """The multigrid main path at 256^3, then its components' times."""
    from pysco_tpu_torch.models import laplacian as lap
    from pysco_tpu_torch.models import multigrid as mg
    from pysco_tpu_torch.ops import stencil as st
    from pysco_tpu_torch.ops import tiled_pm as tp

    n = 256
    recs, launches, stats, base = _drive(
        torch, tmp, "7 mg main", {"boxlen": 500.0, "ncoarse": 8,
                                  "npart": n ** 3, "z_out": "[2]",
                                  "mass_scheme": "TSC",
                                  "linear_newton_solver": "multigrid",
                                  "multigrid_cycle": "V"},
        POISSON_KERNELS)
    check(len(recs) >= 8, f"only {len(recs)} steps")
    steps_ms = [1e3 * r.seconds for r in recs[1:]]
    per_step = {k: (recs[-1].launches[k] - recs[0].launches[k])
                / (len(recs) - 1) for k in POISSON_KERNELS}
    sorted_ms = [t for t, r in zip(steps_ms, recs[1:]) if not r.drift]
    log(f"[7 mg main] median step {np.median(steps_ms):.1f} ms over "
        f"{len(steps_ms)} steps, {len(sorted_ms)} of them sorted (median "
        f"{np.median(sorted_ms) if sorted_ms else float('nan'):.1f} ms); "
        f"first excluded; V-cycles per solve "
        f"{stats['cycles'] / stats['solves']:.2f} ({stats['cycles']} in "
        f"{stats['solves']} solves, first call included)")
    log("[7 mg main] launches per step: " + ", ".join(
        f"{k} {v:.1f}" for k, v in per_step.items()))
    pos, vel = _check_outputs(torch, np, base, n, "tsc", "7 mg main")
    # component times on the final state's Poisson problem
    pc, vc = tp.to_columns_host(pos, vel, n ** 3)
    ps, _, ts = tp.sort_particles(torch.as_tensor(pc, device="cuda"),
                                  torch.as_tensor(vc, device="cuda"), n,
                                  "tsc")
    rhs = 1.5 / 3.0 * 0.25733 * (tp.deposit(ps, ts, n, "tsc") - 1.0)
    del ps, ts, pc, vc
    x = lap.initialise_potential(rhs)
    x = mg.linear(x, rhs, 8, 2, 1, 0.0, "V")  # to the stall
    red, black = lap.pack_rb(x)
    xc = st.restrict3("linear", x, rhs, residual_only=True)[0]
    comps = {
        "pack_rb": lambda: lap.pack_rb(x),
        "unpack_rb": lambda: lap.unpack_rb(red, black),
        "smoothing(Npre=2)": lambda: lap.smoothing(x, rhs, 2),
        "half_sweep": lambda: st.half_sweep(black, red, red, True, 1.25),
        "restrict_residual": lambda: lap.restrict_residual(x, rhs),
        "add_prolongation": lambda: st.add_prolongation(x, xc),
        "residual_error": lambda: lap.residual_error(x, rhs),
        "truncation_error": lambda: lap.truncation_error(x),
        "V_cycle": lambda: mg.V_cycle(x, rhs, 8, 2, 1),
    }
    for name, fn in comps.items():
        log(f"[7 mg components] 256^3 {name}: {time_ms(torch, fn):.3f} ms")
    return launches


def phase_mond(torch, np, tmp):
    n = 128
    recs, _, stats, base = _drive(
        torch, tmp, "8 mond", {"theory": "mond", "boxlen": 250.0,
                               "ncoarse": 7, "npart": n ** 3,
                               "z_out": "[30]", "mass_scheme": "TSC",
                               "linear_newton_solver": "multigrid"},
        POISSON_KERNELS)
    check(len(recs) >= 3, f"only {len(recs)} QUMOND steps")
    log(f"[8 mond] V-cycles per solve {stats['cycles'] / stats['solves']:.2f}"
        f" ({stats['solves']} solves: two per force evaluation)")
    _check_outputs(torch, np, base, n, "tsc", "8 mond")


def _fr_components(torch, np, pos, vel, param, n, scheme, ncoarse):
    """The pieces of an f(R) force evaluation on the final state: the
    snapshot re-sorted and re-deposited, the scalaron and the potential
    solved to the stall, then each piece timed with CUDA events (mean of
    5 after a warm-up)."""
    from pysco_tpu_torch import integrate, solver
    from pysco_tpu_torch.cosmo import generate
    from pysco_tpu_torch.models import cubic
    from pysco_tpu_torch.models import laplacian as lap
    from pysco_tpu_torch.models import multigrid as mg
    from pysco_tpu_torch.ops import mesh
    from pysco_tpu_torch.ops import stencil as st
    from pysco_tpu_torch.ops import tiled_pm as tp
    from pysco_tpu_torch.utils.units import set_units

    pc, vc = tp.to_columns_host(pos, vel, n ** 3)
    pc, vc = (torch.as_tensor(a, device="cuda") for a in (pc, vc))
    ps, vs, ts = tp.sort_particles(pc, vc, n, scheme)
    density = tp.deposit(ps, ts, n, scheme)
    p = dict(param, aexp=1.0 / (1.0 + float(param["z_out"].strip("[]"))))
    generate(p)  # sets Om_lambda, which the f(R) constants read
    set_units(p)
    dyn = solver.compute_dynamics(p)
    b = dyn.fR_f1 * density + dyn.fR_f2
    ops = mg.fas_ops_cubic(dyn.fR_q)
    u = cubic.initialise_potential(b, dyn.fR_q)
    u = mg.FAS(u, b, ops, ncoarse, 2, 1, 0.0)  # to the stall
    rhs = solver._newton_rhs(density, dyn)
    phi = mg.linear(lap.initialise_potential(rhs), rhs, ncoarse, 2, 1, 0.0)
    force = mesh.derivative_fR(phi, u, dyn.fR_half_c2, 1, 5, True)
    red, black = lap.pack_rb(u)
    hb_r, _ = lap.pack_rb(float(np.float32(1.0 / (n * n))) * b)
    c0 = float(np.float32(np.float32(1.0 / (n * n))
                          * np.float32(dyn.fR_q)))
    _deposit_split(torch, tp, ps, ts, n, scheme, 1, "10 fr components")
    comps = {
        "tile sort": lambda: tp.sort_particles(pc, vc, n, scheme),
        "deposit (drift 0)": lambda: tp.deposit(ps, ts, n, scheme),
        "deposit (drift 1)": lambda: tp.deposit(ps, ts, n, scheme, 1),
        "scalaron smoothing(Npre=2)": lambda: ops.smoothing(u, b, 2),
        "scalaron_half_sweep": lambda: st.scalaron_half_sweep(
            black, red, hb_r, c0, True, 1.25, 2),
        "restrict_all": lambda: ops.restrict_all(u, b),
        "residual_error": lambda: ops.residual_error(u, b),
        "truncation_error": lambda: ops.truncation_error(u, b),
        "V_cycle_FAS": lambda: mg.V_cycle_FAS(u, b, ops, ncoarse, 2, 1),
        "V_cycle (Poisson)": lambda: mg.V_cycle(phi, rhs, ncoarse, 2, 1),
        "derivative_fR (5-point)": lambda: mesh.derivative_fR(
            phi, u, dyn.fR_half_c2, 1, 5, True),
        "gather (drift 0)": lambda: tp.gather_vec_cl(force, ps, ts, scheme),
        "gather (drift 1)": lambda: tp.gather_vec_cl(force, ps, ts, scheme, 1),
    }
    times = {}
    for name, fn in comps.items():
        times[name] = time_ms(torch, fn, 5)
        log(f"[10 fr components] {n}^3 {name}: {times[name]:.3f} ms")
    log(f"[10 fr components] mean(u) of the stalled solve "
        f"{float(u.double().mean()):.7f}")
    # the rest of a lazy step, itemised: the eager passes around the force
    # evaluation, then the force evaluation and the step as wholes (a dt
    # too small to move a particle out of its window)
    cfg = solver.config_from_param(p)
    acc = tp.gather_vec_cl(force, ps, ts, scheme, 1)
    dt, half = integrate._half_dt(1e-7)
    rest = {
        "kick (one of two a step)": lambda: vs - acc * half,
        "drift and wrap": lambda: mesh.periodic_wrap(ps + vs * dt),
        "drift-bound count": lambda: tp.drift_violations(ps, ts, n, scheme,
                                                         1),
        "density normalisation": lambda: solver._normalise(cfg, density),
        "scalaron source f1 density + f2": lambda: dyn.fR_f1 * density
        + dyn.fR_f2,
        "Poisson source": lambda: solver._newton_rhs(density, dyn),
        "potential rescaling": lambda: phi * dyn.potential_scaling,
        "truncation_error (Poisson)": lambda: lap.truncation_error(phi),
        "diagnostics (max |acc|, max |vel|, mean u)":
            lambda: integrate._diagnostics(acc, vs, u, 0),
    }
    for name, fn in rest.items():
        log(f"[10 fr step items] {n}^3 {name}: "
            f"{time_ms(torch, fn, 5):.3f} ms")

    def force_eval():
        return solver._pm_lazy_impl(cfg, 1, False, ps, vs, ts, phi, u, dyn)

    def whole_step():
        return integrate.step_lazy_impl(cfg, "leapfrog", 1, False, ps, vs,
                                        acc, phi, u, ts, dyn, 1e-7)

    for name, fn in (("force evaluation, drift 1 (solver._pm_lazy_impl)",
                      force_eval),
                     ("whole lazy step, drift 1 (integrate.step_lazy_impl)",
                      whole_step)):
        mg.reset_stats()
        dev = time_ms(torch, fn, 3)
        cycles = (mg.STATS["fas_cycles"] / 4,
                  (mg.STATS["cycles"] - mg.STATS["fas_cycles"]) / 4)
        t0 = time.perf_counter()
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) / 3 * 1e3
        log(f"[10 fr step items] {n}^3 {name}: {dev:.3f} ms by CUDA events, "
            f"{host:.3f} ms by the host clock; {cycles[0]:.2f} FAS and "
            f"{cycles[1]:.2f} Poisson V-cycles a call")
    return times


def _per_solve(stats):
    """V-cycles per FAS solve and per Poisson (linear) solve."""
    fas = stats["fas_cycles"] / max(stats["fas_solves"], 1)
    lin_solves = stats["solves"] - stats["fas_solves"]
    lin = (stats["cycles"] - stats["fas_cycles"]) / max(lin_solves, 1)
    return fas, lin


FR_OVERRIDES = {"theory": "fr", "fR_logfR0": 5.0,
                "linear_newton_solver": "multigrid", "multigrid_cycle": "V",
                "write_initial_snapshot": False}


def phase_fr_main_path(torch, np, tmp):
    """This slice's main path: fr_n1_cic_multigrid_512 through run()."""
    from pysco_tpu_torch import ic_device

    n = 512
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    over = dict(FR_OVERRIDES, fR_n=1, boxlen=500.0, ncoarse=9,
                npart=n ** 3, z_out="[20]", mass_scheme="CIC")
    recs, launches, stats, base = _drive(torch, tmp, "10 fr main", over,
                                         SINGLE_KERNELS)
    peak = torch.cuda.max_memory_allocated()
    check(len(recs) >= 3, f"only {len(recs)} f(R) steps")
    steps_ms = [1e3 * r.seconds for r in recs[1:]]
    fas, lin = _per_solve(stats)
    per_step = {k: (recs[-1].launches[k] - recs[0].launches[k])
                / (len(recs) - 1) for k in SINGLE_KERNELS}
    mean_u = [r.mean_additional for r in recs]
    check(all(np.isfinite(mean_u)) and all(abs(m - 1) < 0.1 for m in mean_u),
          f"mean(u) off its background value: {mean_u}")
    log(f"[10 fr main] median step {np.median(steps_ms):.1f} ms over "
        f"{len(steps_ms)} steps (first excluded); V-cycles per FAS solve "
        f"{fas:.2f}, per Poisson solve {lin:.2f} ({stats})")
    log(f"[10 fr main] mean(u) per step: "
        + " ".join(f"{m:.7f}" for m in mean_u))
    log(f"[10 fr main] device ICs {ic_device.TIMES['generate_lpt']:.2f} s; "
        f"peak device memory {peak / 2 ** 30:.2f} GiB "
        f"(torch.cuda.max_memory_allocated)")
    log("[10 fr main] launches per step: " + ", ".join(
        f"{k} {v:.1f}" for k, v in per_step.items()))
    pos, vel = _check_outputs(torch, np, base, n, "cic", "10 fr main")
    param = dict(GOLDEN_PARAM, **over)
    times = _fr_components(torch, np, pos, vel, param, n, "cic", 9)
    del pos, vel
    exact = phase_fr_exact(torch, np, tmp, over)
    ref = {"base": base, "median_ms": float(np.median(steps_ms)),
           "fas": fas, "lin": lin, "peak_gib": peak / 2 ** 30,
           "ic_s": ic_device.TIMES["generate_lpt"],
           "fas_cycle_ms": times["V_cycle_FAS"],
           "poisson_cycle_ms": times["V_cycle (Poisson)"]}
    launches["scalaron_exact_half_sweep"] = exact
    return launches, ref


def phase_fr_exact(torch, np, tmp, over):
    """Phase 10's configuration with ``fR_root_solver = exact`` (the
    benchmark's ``fr512.lazy`` solver) to z = 30: every step launches the
    exact-root sweep in place of the Newton one. Returns its launches."""
    names = POISSON_KERNELS + ("scalaron_exact_half_sweep",)
    recs, launches, stats, base = _drive(
        torch, tmp, "10 fr exact", dict(over, fR_root_solver="exact",
                                        z_out="[30]"), names)
    check(len(recs) >= 3, f"only {len(recs)} exact-root f(R) steps")
    check(launches["scalaron_half_sweep"] == 0,
          "the exact-root run launched the Newton-root sweep")
    fas, lin = _per_solve(stats)
    per_step = (recs[-1].launches["scalaron_exact_half_sweep"]
                - recs[0].launches["scalaron_exact_half_sweep"]) / (
                    len(recs) - 1)
    log(f"[10 fr exact] median step "
        f"{np.median([1e3 * r.seconds for r in recs[1:]]):.1f} ms over "
        f"{len(recs) - 1} steps (first excluded); V-cycles per FAS solve "
        f"{fas:.2f}, per Poisson solve {lin:.2f}; scalaron_exact_half_sweep "
        f"{launches['scalaron_exact_half_sweep']} launches, "
        f"{per_step:.1f} a step; mean(u) {recs[-1].mean_additional:.7f}")
    shutil.rmtree(base, ignore_errors=True)
    return launches["scalaron_exact_half_sweep"]


def phase_fr_n2(torch, np, tmp):
    """A 256^3 f(R) n = 2 run with the Newton roots, then the same with
    the exact roots (``fR_root_solver = exact``): every step of the second
    launches the quartic exact-root sweep, and no Newton-root sweep.
    Returns the exact run's launches of the quartic sweep."""
    n = 256
    over = dict(FR_OVERRIDES, fR_n=2, boxlen=500.0, ncoarse=8,
                npart=n ** 3, z_out="[30]", mass_scheme="TSC")
    recs, _, stats, base = _drive(torch, tmp, "11 fr n2", over,
                                  SINGLE_KERNELS)
    check(len(recs) >= 3, f"only {len(recs)} f(R) n = 2 steps")
    fas, lin = _per_solve(stats)
    log(f"[11 fr n2] median step "
        f"{np.median([1e3 * r.seconds for r in recs[1:]]):.1f} ms over "
        f"{len(recs) - 1} steps; V-cycles per FAS solve {fas:.2f}, per "
        f"Poisson solve {lin:.2f}; mean(u) {recs[-1].mean_additional:.7f}")
    _check_outputs(torch, np, base, n, "tsc", "11 fr n2")
    shutil.rmtree(base, ignore_errors=True)
    name = "scalaron_quartic_exact_half_sweep"
    recs, launches, stats, base = _drive(
        torch, tmp, "11 fr n2 exact", dict(over, fR_root_solver="exact"),
        POISSON_KERNELS + (name,))
    check(len(recs) >= 3, f"only {len(recs)} exact-root f(R) n = 2 steps")
    check(launches["scalaron_half_sweep"] == 0,
          "the exact-root n = 2 run launched the Newton-root sweep")
    fas, lin = _per_solve(stats)
    per_step = (recs[-1].launches[name] - recs[0].launches[name]) / (
        len(recs) - 1)
    log(f"[11 fr n2 exact] median step "
        f"{np.median([1e3 * r.seconds for r in recs[1:]]):.1f} ms over "
        f"{len(recs) - 1} steps; V-cycles per FAS solve {fas:.2f}, per "
        f"Poisson solve {lin:.2f}; {name} {launches[name]} launches, "
        f"{per_step:.1f} a step; mean(u) {recs[-1].mean_additional:.7f}")
    _check_outputs(torch, np, base, n, "tsc", "11 fr n2 exact")
    shutil.rmtree(base, ignore_errors=True)
    return launches[name]


def _capture_run(torch, tmp, tag, overrides, names, devices=None):
    """:func:`_drive` with what the run logs (``run`` sends it to the
    standard error stream) returned as lines too."""
    import contextlib
    import io
    import logging

    buf = io.StringIO()
    try:
        with contextlib.redirect_stderr(buf):
            out = _drive(torch, tmp, tag, overrides, names, devices)
    finally:  # the run's handler holds the buffer: back to the real stream
        logging.basicConfig(level=logging.ERROR, format="%(message)s",
                            force=True)
    return out, buf.getvalue().splitlines()


def phase_extras(torch, np, tmp):
    """The run extras on the card: run_paired, the verbose = 2 residual
    log and component breakdown with the profiler hook, and Morton
    reordering of the scatter engine."""
    import pysco_tpu_torch
    from pysco_tpu_torch.cosmo import write_power_spectrum_table

    def pks(base, sub="power"):
        d = os.path.join(base, sub)
        return {f: np.loadtxt(os.path.join(d, f)) for f in sorted(
            os.listdir(d)) if f.startswith("pk_")}

    # run_paired at the configuration of tests/test_e2e.py::test_run_paired
    pk_file = os.path.join(tmp, "pk_extras.dat")
    write_power_spectrum_table(pk_file)
    small = dict(GOLDEN_PARAM, ncoarse=4, seed=7, initial_conditions="1LPT",
                 z_out="[44]", power_spectrum_file=pk_file)
    del small["particle_engine"], small["lazy_sort"]
    del small["pm_precision_widened"], small["fixed_ICS"], small["paired_ICS"]
    base = os.path.join(tmp, "paired")
    pysco_tpu_torch.run_paired(dict(small, base=base), device="cuda")
    avg, a, b = pks(base), pks(base, "pair_A/power"), pks(base, "pair_B/power")
    check(avg and avg.keys() == a.keys() == b.keys(),
          f"run_paired P(k) files: {sorted(avg)} {sorted(a)} {sorted(b)}")
    for name, m in avg.items():
        check(np.array_equal(m[:, 0], a[name][:, 0])
              and np.allclose(m[:, 1], 0.5 * (a[name][:, 1] + b[name][:, 1]),
                              rtol=1e-12, atol=0)
              and np.array_equal(m[:, 2], a[name][:, 2] + b[name][:, 2]),
              f"run_paired {name}: not the mean P(k) and the summed modes")
        check(not np.array_equal(a[name][:, 1], b[name][:, 1]),
              f"run_paired {name}: the two phases are one")
    for tag in ("pair_A", "pair_B"):
        snaps = os.listdir(os.path.join(base, tag, "output_00001"))
        check(any(f.endswith(".npz") for f in snaps),
              f"run_paired {tag}: no snapshot")
    log(f"[12 extras] run_paired: {len(avg)} pair-averaged P(k) file(s), the "
        "mean of pair_A and pair_B with summed mode counts")

    # verbose = 2 with profile_dir against the same run without the hooks
    n = 128
    over = {"boxlen": 250.0, "ncoarse": 7, "npart": n ** 3, "z_out": "[30]",
            "mass_scheme": "TSC", "linear_newton_solver": "multigrid",
            "multigrid_cycle": "V"}
    recs0, launches0, stats0, base0 = _drive(torch, tmp, "12 plain", over,
                                             POISSON_KERNELS)
    trace_dir = os.path.join(tmp, "trace")
    (recs, launches, stats, base1), lines = _capture_run(
        torch, tmp, "12 hooks", dict(over, verbose=2, profile_dir=trace_dir),
        POISSON_KERNELS)
    cycles = [ln for ln in lines if ln.startswith("multigrid: cycle ")]
    check(len(cycles) == stats["cycles"] > 0,
          f"{len(cycles)} residual lines for {stats['cycles']} cycles")
    broke = [ln for ln in lines if "component timings" in ln]
    check(len(broke) == 1, f"{len(broke)} component-timing lines")
    times = json.loads(broke[0].split("timings: ")[1].replace("'", '"'))
    check(sorted(times) == ["deposit_ms", "gather_ms",
                            "solve_plus_gradient_ms", "tile_sort_ms"]
          and all(v > 0 for v in times.values()),
          f"component timings {times}")
    check(stats == stats0 and launches == launches0
          and [r.launches for r in recs] == [r.launches for r in recs0],
          "the verbose = 2 and profiler hooks changed the launch counts: "
          f"{launches} != {launches0}, {stats} != {stats0}")
    for name, p0 in pks(base0).items():
        check(np.array_equal(p0, pks(base1)[name]),
              f"the hooks changed {name}")
    files = os.listdir(trace_dir)
    check(len(files) == 1, f"trace files {files}")
    with open(os.path.join(trace_dir, files[0])) as f:
        trace = f.read()
    for kernel in ("deposit_tiles", "gather_march", "half_sweep_kernel",
                   "norm2_march", "restrict3_kernel",
                   "add_prolongation_march"):
        check(kernel in trace, f"the trace names no {kernel} kernel")
    log(f"[12 extras] verbose = 2: {len(cycles)} residual lines = "
        f"{stats['cycles']} cycles, first: {cycles[0]!r}; {broke[0]}")
    log(f"[12 extras] profile_dir: {files[0]} ({len(trace) / 2 ** 20:.1f} "
        f"MiB) names the port's kernels; step 2 took "
        f"{1e3 * recs[1].seconds:.1f} ms traced, "
        f"{1e3 * recs0[1].seconds:.1f} ms untraced; launch counts and P(k) "
        "as without the hooks")

    # the scatter engine reordered by Morton key every 2 steps, twice,
    # against a run that never reorders
    runs = {}
    for tag, n_reorder in (("a", 2), ("b", 2), ("plain", 10 ** 6)):
        base = os.path.join(tmp, f"reorder_{tag}")
        recs = pysco_tpu_torch.run(
            dict(small, base=base, particle_engine="scatter", z_out="[35]",
                 n_reorder=n_reorder), device="cuda")
        runs[tag] = pks(base)
    check(len(recs) >= 4, f"only {len(recs)} scatter-engine steps")
    worst = same = 0.0
    for name, p in runs["a"].items():
        q, r = runs["plain"][name], runs["b"][name]
        check(np.array_equal(p[:, 2], q[:, 2]), f"reorder {name}: modes")
        sel = q[:, 2] >= 8
        worst = max(worst, float((np.abs(p[sel, 1] - q[sel, 1])
                                  / q[sel, 1]).max()))
        same = max(same, float((np.abs(p[sel, 1] - r[sel, 1])
                                / r[sel, 1]).max()))
    check(worst < 1e-4, f"reordered vs unreordered P(k): {worst:.2e}")
    # index_add_ on the card adds with atomics, in an order that changes
    # from run to run: two runs agree to float32 rounding, not bitwise
    check(same < 1e-5, f"two reordered runs: {same:.2e}")
    log(f"[12 extras] scatter engine, n_reorder = 2, {len(recs)} steps: P(k) "
        f"vs the unreordered run max rel {worst:.2e} (bound 1e-4); two "
        f"reordered runs max rel {same:.2e} (index_add_ atomics; bound 1e-5)")


def _pk_files(np, base):
    d = os.path.join(base, "power")
    return {f: np.loadtxt(os.path.join(d, f)) for f in sorted(os.listdir(d))
            if f.startswith("pk_")}


def _per_step(recs, names):
    """Launches of each kernel in every step of a run whose counts were
    zeroed before it: the first step's count holds the initial force
    evaluation's launches too, as many again, and is halved."""
    prev, out = dict.fromkeys(names, 0), []
    for i, r in enumerate(recs):
        step = {k: r.launches[k] - prev[k] for k in names}
        if i == 0:
            check(all(v % 2 == 0 for v in step.values()),
                  f"the first step and the initial evaluation: {step}")
            step = {k: v // 2 for k, v in step.items()}
        out.append(step)
        prev = {k: r.launches[k] for k in names}
    return out


def _pk_worst(np, got, want, tag):
    """Max relative P(k) difference on the bins with >= 8 modes; the files
    and mode counts must be the same."""
    check(sorted(got) == sorted(want) and got,
          f"{tag}: P(k) files {sorted(got)} != {sorted(want)}")
    worst = 0.0
    for name, a in got.items():
        b = want[name]
        check(np.array_equal(a[:, 2], b[:, 2]), f"{tag} {name}: mode counts")
        sel = b[:, 2] >= 8
        worst = max(worst, float((np.abs(a[sel, 1] - b[sel, 1])
                                  / b[sel, 1]).max()))
    return worst


def phase_parallel(torch, np, tmp, main_base, main_stale, main_sorted):
    """The multi-device modes on the one card."""
    from pysco_tpu_torch.utils import io as iostream

    n, d = 256, 4
    mesh4 = ["cuda:0"] * d
    slab_over = dict(MAIN_OVERRIDES, parallel_mode="slab")
    every = SLAB_KERNELS + ("deposit", "gather")
    runs = []
    for tag in ("13 slab", "13 slab again"):
        recs, launches, _, base = _drive(torch, tmp, tag, slab_over,
                                         SLAB_KERNELS, mesh4)
        for r, step in zip(recs, _per_step(recs, every)):
            check(step == {"deposit_slab": d, "gather_slab": d,
                           "deposit": 0, "gather": 0},
                  f"{tag} step {r.nsteps}: launches {step}, not {d} of each "
                  "slab form and none of the single forms")
        runs.append((recs, launches, base))
    recs, slab_launches, base = runs[0]
    drifts = [r.drift for r in recs]
    check(len(recs) >= 8 and any(drifts) and 0 in drifts[1:],
          f"slab drift levels {drifts}")
    _check_outputs(torch, np, base, n, "cic", "13 slab")
    # against phase 5's single-device run of the same configuration
    mine = _pk_files(np, base)
    worst = _pk_worst(np, mine, _pk_files(np, main_base), "13 slab")
    check(worst <= 1e-5, f"slab vs single-device P(k): {worst:.2e} > 1e-5")
    # two slab runs: bitwise
    again = _pk_files(np, runs[1][2])
    for name, a in mine.items():
        check(np.array_equal(a, again[name]),
              f"two slab runs differ in {name}")
    snaps = []
    for _, _, b in runs:
        f = [x for x in os.listdir(os.path.join(b, "output_00001"))
             if x.endswith(".npz")][0]
        snaps.append(iostream.read_snapshot_particles_npz(
            os.path.join(b, "output_00001", f)))
    check(all(np.array_equal(x, y) for x, y in zip(*snaps)),
          "two slab runs differ in their final snapshots")
    stale = [1e3 * r.seconds for r in recs[1:] if r.drift]
    srt = [1e3 * r.seconds for r in recs[1:] if r.drift == 0]
    log(f"[13 slab] 256^3 on [cuda:0] x {d}: {d} deposit_slab and {d} "
        f"gather_slab launches on every one of {len(recs)} steps "
        f"(totals {slab_launches['deposit_slab']}, "
        f"{slab_launches['gather_slab']}), none of the single forms; P(k) "
        f"vs phase 5's single-device run max rel {worst:.2e} (bound 1e-5); "
        "two slab runs bitwise equal (P(k) and final snapshot)")
    log(f"[13 slab] median step: stale-bin {np.median(stale):.1f} ms "
        f"({len(stale)} steps), sorted {np.median(srt):.1f} ms ({len(srt)} "
        f"steps); phase 5 on the card alone: {main_stale:.1f} and "
        f"{main_sorted:.1f} ms. Four shards taking turns on one card: what "
        "the sharded machinery costs there, no statement about scaling")

    # replicated on two shards, a few steps
    recs, launches, _, base = _drive(
        torch, tmp, "13 replicated",
        dict(MAIN_OVERRIDES, parallel_mode="replicated", z_out="[30]"),
        ("deposit", "gather"), ["cuda:0"] * 2)
    for r, step in zip(recs, _per_step(recs, every)):
        check(step == {"deposit_slab": 0, "gather_slab": 0, "deposit": 2,
                       "gather": 2}, f"replicated step {r.nsteps}: {step}")
    check(len(recs) >= 3 and not any(r.drift for r in recs),
          f"replicated: {len(recs)} steps")
    _check_outputs(torch, np, base, n, "cic", "13 replicated")
    log(f"[13 replicated] 256^3 on [cuda:0] x 2: 2 deposits and 2 gathers a "
        f"step; median step "
        f"{np.median([1e3 * r.seconds for r in recs[1:]]):.1f} ms over "
        f"{len(recs) - 1} steps (every step sorts)")

    # the golden configuration in both modes
    phase_golden(np, tmp, "slab", mesh4, "13 golden")
    phase_golden(np, tmp, "replicated", mesh4, "13 golden")

    # a slack so low that the first occupancy check re-balances
    (recs, _, _, base), lines = _capture_run(
        torch, tmp, "13 rebalance",
        {"boxlen": 250.0, "ncoarse": 7, "npart": 128 ** 3, "z_out": "[30]",
         "mass_scheme": "CIC", "parallel_mode": "slab", "slab_slack": 1.05,
         "verbose": 1}, SLAB_KERNELS, mesh4)
    fired = [ln for ln in lines if "re-balancing with slack" in ln]
    check(fired, "no capacity re-balancing in the run's log")
    _check_outputs(torch, np, base, 128, "cic", "13 rebalance")
    log(f"[13 rebalance] 128^3, slab_slack = 1.05: {len(fired)} "
        f"re-balancing(s) over {len(recs)} steps, first: {fired[0]!r}")


def _slab_cycle_times(torch, np, base, n, scheme, param, mesh):
    """One slab FAS V-cycle and one slab Poisson V-cycle on the final state
    of a slab run, beside the single-device cycles on the same state (mean
    of 3 by CUDA events after a warm-up)."""
    from pysco_tpu_torch import solver
    from pysco_tpu_torch.cosmo import generate
    from pysco_tpu_torch.models import cubic
    from pysco_tpu_torch.models import laplacian as lap
    from pysco_tpu_torch.models import multigrid as mg
    from pysco_tpu_torch.ops import tiled_pm as tp
    from pysco_tpu_torch.parallel import mesh as pmesh
    from pysco_tpu_torch.parallel import slab, slab_mg
    from pysco_tpu_torch.utils import io as iostream
    from pysco_tpu_torch.utils.units import set_units

    snap = [f for f in os.listdir(os.path.join(base, "output_00001"))
            if f.endswith(".npz")][0]
    pos, vel = iostream.read_snapshot_particles_npz(
        os.path.join(base, "output_00001", snap))
    pc, vc = tp.to_columns_host(pos, vel, n ** 3)
    del pos, vel
    ps, _, ts = tp.sort_particles(torch.as_tensor(pc, device="cuda"),
                                  torch.as_tensor(vc, device="cuda"), n,
                                  scheme)
    del pc, vc
    density = tp.deposit(ps, ts, n, scheme)
    del ps, ts
    p = dict(param, aexp=1.0 / (1.0 + float(param["z_out"].strip("[]"))))
    generate(p)
    set_units(p)
    dyn = solver.compute_dynamics(p)
    b = dyn.fR_f1 * density + dyn.fR_f2
    ops = mg.fas_ops_cubic(dyn.fR_q)
    u = mg.FAS(cubic.initialise_potential(b, dyn.fR_q), b, ops, 9, 2, 1, 0.0)
    rhs = solver._newton_rhs(density, dyn)
    del density
    phi = mg.linear(lap.initialise_potential(rhs), rhs, 9, 2, 1, 0.0)
    sops = slab_mg.fas_ops_cubic_slab(dyn.fR_q, mesh)
    us, bs, phis, rhss = (pmesh.scatter(a, mesh, 0) for a in (u, b, phi, rhs))
    times = {
        "slab FAS": time_ms(torch, lambda: slab_mg.V_cycle_FAS_slab(
            us, bs, sops, 9, 2, 1, mesh), 3),
        "single FAS": time_ms(torch, lambda: mg.V_cycle_FAS(
            u, b, ops, 9, 2, 1), 3),
        "slab Poisson": time_ms(torch, lambda: slab_mg.V_cycle_slab(
            phis, rhss, 9, 2, 1, mesh), 3),
        "single Poisson": time_ms(torch, lambda: mg.V_cycle(
            phi, rhs, 9, 2, 1), 3),
    }
    # the slab levels' pieces on the finest grid, each beside the
    # single-device call that does the same work
    reds = slab_mg.pack_rb_slab(us)[0]
    pieces = {
        "scalaron smoothing (Npre=2)": (
            lambda: sops.smoothing(us, bs, 2), lambda: ops.smoothing(u, b, 2)),
        "Poisson smoothing (Npre=2)": (
            lambda: slab_mg.smoothing_slab(phis, rhss, 2, mesh),
            lambda: lap.smoothing(phi, rhs, 2)),
        "pack_rb": (lambda: slab_mg.pack_rb_slab(us),
                    lambda: lap.pack_rb(u)),
        "packed neighbour sum": (
            lambda: slab_mg.packed_neighbour_sum_slab(reds, True, mesh),
            None),
        "one-plane halo of a half-lattice": (
            lambda: slab.exchange_halo_x(reds, 1, mesh), None),
        "scalaron restrict_residual": (
            lambda: sops.restrict_residual(us, bs),
            lambda: ops.restrict_residual(u, b)),
        f"prolongation (to {n}^3)": (
            lambda: slab_mg.prolongation_slab(
                slab_mg.restriction_slab(us), mesh), None),
    }
    for name, (slab_fn, single_fn) in pieces.items():
        t = time_ms(torch, slab_fn, 3)
        beside = (f"; single {time_ms(torch, single_fn, 3):.2f} ms"
                  if single_fn else "")
        log(f"[14 slab components] {n}^3 {name}: slab {t:.2f} ms{beside}")
    _top_kernels(torch, lambda: slab_mg.V_cycle_FAS_slab(
        us, bs, sops, 9, 2, 1, mesh), "one slab FAS V-cycle")
    return times


def _top_kernels(torch, fn, what, top=8):
    """The device time of ``fn`` by kernel name (torch.profiler), the
    largest ``top`` logged with their launch counts."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            t, k = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + e.time_range.elapsed_us() / 1e3, k + 1)
    total = sum(t for t, _ in by_name.values())
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    log(f"[14 slab profile] {what}: device time {total:.2f} ms over "
        f"{sum(k for _, k in by_name.values())} launches; the largest: "
        + "; ".join(f"{name[:60]} {t:.2f} ms x{k}" for name, (t, k) in rows))


# the kernels of the slab multigrid path: the slab transfers on every
# shard, the stencil kernels at the replicated coarse levels on shard 0's
# device (the slab levels are torch operations)
SLAB_MG_KERNELS = SLAB_KERNELS + ("half_sweep", "restrict3",
                                  "add_prolongation")


def phase_slab_mg(torch, np, tmp, fr_ref):
    """The slab multigrid and FAS and the sharded ICs on the card: this
    slice's path (phase 10's configuration in slab mode on [cuda:0] x 4),
    phase 7's in slab mode against a single-mode run of it, and the e2e
    multigrid and f(R) rows in slab mode twice. Returns the launch counts
    of the first run."""
    import pysco_tpu_torch
    from pysco_tpu_torch.parallel import ic_slab
    from pysco_tpu_torch.parallel import mesh as pmesh

    d = 4
    mesh4 = ["cuda:0"] * d
    stencils = ("half_sweep", "scalaron_half_sweep", "restrict3",
                "add_prolongation", "residual_norm2")
    # (a) fr_n1_cic_multigrid_512 in slab mode
    n = 512
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ic_slab.TIMES["generate_lpt_slab"] = None
    over = dict(FR_OVERRIDES, fR_n=1, boxlen=500.0, ncoarse=9, npart=n ** 3,
                z_out="[20]", mass_scheme="CIC", parallel_mode="slab")
    recs, launches, stats, base = _drive(
        torch, tmp, "14 slab fr", over,
        SLAB_MG_KERNELS + ("scalaron_half_sweep",), mesh4)
    peak = torch.cuda.max_memory_allocated()
    ic_s = ic_slab.TIMES["generate_lpt_slab"]
    check(ic_s is not None, "the slab run did not build its ICs with ic_slab")
    for r, step in zip(recs, _per_step(recs, SLAB_KERNELS + ("deposit",
                                                             "gather"))):
        check(step == {"deposit_slab": d, "gather_slab": d, "deposit": 0,
                       "gather": 0},
              f"14 slab fr step {r.nsteps}: launches {step}, not {d} of "
              "each slab form and none of the single forms")
    check(len(recs) >= 3, f"only {len(recs)} slab f(R) steps")
    mean_u = [r.mean_additional for r in recs]
    check(all(np.isfinite(mean_u)) and all(abs(m - 1) < 0.1 for m in mean_u),
          f"slab mean(u) off its background value: {mean_u}")
    _check_outputs(torch, np, base, n, "cic", "14 slab fr")
    worst = _pk_worst(np, _pk_files(np, base), _pk_files(np, fr_ref["base"]),
                      "14 slab fr")
    check(worst < 1e-4, f"slab vs phase 10 P(k): {worst:.2e} >= 1e-4")
    fas, lin = _per_solve(stats)
    steps_ms = [1e3 * r.seconds for r in recs[1:]]
    log(f"[14 slab fr] {n}^3 f(R) n = 1 on [cuda:0] x {d}: ICs by ic_slab "
        f"{ic_s:.2f} s (phase 10's device ICs {fr_ref['ic_s']:.2f} s); "
        f"median step {np.median(steps_ms):.1f} ms over {len(steps_ms)} "
        f"steps (phase 10: {fr_ref['median_ms']:.1f}); V-cycles per FAS "
        f"solve {fas:.2f} (phase 10: {fr_ref['fas']:.2f}), per Poisson "
        f"solve {lin:.2f} ({fr_ref['lin']:.2f}); peak device memory "
        f"{peak / 2 ** 30:.2f} GiB ({fr_ref['peak_gib']:.2f}); P(k) vs "
        f"phase 10 max rel {worst:.2e} (bound 1e-4)")
    log("[14 slab fr] stencil kernel launches per step (the replicated "
        "coarse levels): " + "; ".join(
            f"step {r.nsteps}: " + ", ".join(
                f"{k} {r.launches[k] - p.launches[k]}" for k in stencils)
            for p, r in zip(recs, recs[1:])))
    log(f"[14 slab fr] {d} deposit_slab and {d} gather_slab launches on "
        f"every one of {len(recs)} steps, none of the single forms; "
        "launch totals (the initial evaluation included): "
        + ", ".join(f"{k} {launches[k]}" for k in SLAB_KERNELS + stencils)
        + " (residual_norm2: none expected, the slab norms are torch sums)")
    param = dict(GOLDEN_PARAM, **over)
    cyc = _slab_cycle_times(torch, np, base, n, "cic", param,
                            pmesh.make_mesh(devices=mesh4))
    log(f"[14 slab fr] {n}^3 V-cycles by CUDA events: slab FAS "
        f"{cyc['slab FAS']:.2f} ms, single FAS on the same state "
        f"{cyc['single FAS']:.2f} (phase 10: {fr_ref['fas_cycle_ms']:.2f}); "
        f"slab Poisson {cyc['slab Poisson']:.2f} ms, single "
        f"{cyc['single Poisson']:.2f} (phase 10: "
        f"{fr_ref['poisson_cycle_ms']:.2f})")

    # (b) phase 7's configuration cut to z = 30, single mode and slab mode
    mg7 = {"boxlen": 500.0, "ncoarse": 8, "npart": 256 ** 3,
           "z_out": "[30]", "mass_scheme": "TSC",
           "linear_newton_solver": "multigrid", "multigrid_cycle": "V"}
    single = _drive(torch, tmp, "14 mg single", mg7, POISSON_KERNELS)
    slab_run = _drive(torch, tmp, "14 mg slab",
                      dict(mg7, parallel_mode="slab"), SLAB_MG_KERNELS,
                      mesh4)
    worst7 = _pk_worst(np, _pk_files(np, slab_run[3]),
                       _pk_files(np, single[3]), "14 mg slab")
    check(worst7 < 1e-4, f"slab vs single multigrid P(k): {worst7:.2e}")
    _check_outputs(torch, np, slab_run[3], 256, "tsc", "14 mg slab")
    log(f"[14 mg slab] 256^3 newton multigrid to z = 30: P(k) vs the single "
        f"mode max rel {worst7:.2e} (bound 1e-4); V-cycles per solve "
        f"{slab_run[2]['cycles'] / slab_run[2]['solves']:.2f} (single "
        f"{single[2]['cycles'] / single[2]['solves']:.2f}); median step "
        f"{np.median([1e3 * r.seconds for r in slab_run[0][1:]]):.1f} ms "
        f"(single {np.median([1e3 * r.seconds for r in single[0][1:]]):.1f})")

    # (c) the e2e rows in slab mode, twice: bitwise equal, and within 1e-4
    # of phases 6 and 9 (their first card runs, whose power spectrum table
    # they share)
    pk_file = os.path.join(tmp, "pk_e2e.dat")
    for row, over in (("newton_multigrid_tsc_2lpt", {}),
                      ("mond_multigrid", {"theory": "mond"}),
                      ("fr_n1", {"theory": "fr", "fR_n": 1}),
                      ("fr_n2", {"theory": "fr", "fR_n": 2})):
        got = []
        for run in ("a", "b"):
            base = os.path.join(tmp, f"e2e_slab_{row}_{run}")
            pysco_tpu_torch.run(dict(E2E_PARAM, power_spectrum_file=pk_file,
                                     base=base, parallel_mode="slab", **over),
                                device="cuda", devices=mesh4)
            got.append(_pk_files(np, base))
        for name, a in got[0].items():
            check(np.array_equal(a, got[1][name]),
                  f"{row}: two slab runs differ in {name}")
        worst_e = _pk_worst(np, got[0], _pk_files(
            np, os.path.join(tmp, f"e2e_{row}_a")), row)
        check(worst_e < 1e-4, f"{row} slab vs single: {worst_e:.2e}")
        log(f"[14 e2e slab] {row} on [cuda:0] x {d}: two runs bitwise equal; "
            f"P(k) vs the single-mode card run max rel {worst_e:.2e} "
            "(bound 1e-4)")
    return launches


def _dense_flops(n, m, scheme, ncomp=3):
    """float32 operations of the dense engine's contractions, as
    ((deposit, gather) over the cap rows a plane's products run,
    (deposit, gather) over the n particles): per row a (W M) x M outer
    product for the deposit, a (W M) x (M C) product and the z
    contraction for the gather. Capacity rows past a plane's particles
    are padding the engine multiplies by zero."""
    from pysco_tpu_torch.ops import dense_pm

    wm = dense_pm._WIDTH[scheme] * m
    dep, gat = 2.0 * wm * m, 2.0 * wm * m * ncomp + 2.0 * m * ncomp
    rows = m * dense_pm._capacity(n, m)
    return (rows * dep, rows * gat), (n * dep, n * gat)


def _dense_checks(torch, np, gen):
    """Phase 15 (a): the dense transfers on the card against the tiled
    deposit and the scatter gather; bitwise under a global TF32 setting
    and in a second call; an overflow counted on a clustered state."""
    from pysco_tpu_torch.ops import dense_pm, mesh, tiled_pm as tp

    worst_d = worst_g = 0.0
    for m in (64, 128):
        n = m ** 3
        field = torch.randn((m, m, m, 3), generator=gen, device="cuda")
        for scheme in SCHEMES:
            # a quarter of the particles in a cube of a quarter of the
            # box's side: planes at 1.75 times the mean, inside capacity
            pos, vel = _particles(torch, n, m, False, gen)
            pos[: n // 4] = 0.25 + 0.25 * pos[: n // 4]
            ps, vs, starts = dense_pm.sort_by_plane(pos, m, scheme, vel)
            grid, overflow = dense_pm.deposit(ps, starts, m, scheme)
            check(int(overflow) == 0, f"dense {m}^3 {scheme}: overflow "
                  f"{int(overflow)}")
            pc, vc = tp.to_columns(pos, vel, n)
            pt, _, ts = tp.sort_particles(pc, vc, m, scheme)
            want = tp.deposit(pt, ts, m, scheme)
            err = float((grid - want).abs().max() / want.abs().max())
            check(err < 1e-5, f"dense deposit {m}^3 {scheme} vs tiled: "
                  f"{err:.2e}")
            acc = dense_pm.gather_vec(field, ps, starts, scheme)
            ref = mesh.gather_vec(field, ps, scheme)
            gerr = float((acc - ref).abs().max() / field.abs().max())
            check(gerr < 1e-5, f"dense gather {m}^3 {scheme} vs scatter: "
                  f"{gerr:.2e}")
            worst_d, worst_g = max(worst_d, err), max(worst_g, gerr)
            # a second call and a global TF32 setting change no bit
            check(torch.equal(dense_pm.deposit(ps, starts, m, scheme)[0],
                              grid)
                  and torch.equal(dense_pm.gather_vec(field, ps, starts,
                                                      scheme), acc),
                  f"dense {m}^3 {scheme}: a second call changed a bit")
            flag = torch.backends.cuda.matmul.allow_tf32
            try:
                torch.backends.cuda.matmul.allow_tf32 = True
                same = (torch.equal(dense_pm.deposit(ps, starts, m,
                                                     scheme)[0], grid)
                        and torch.equal(dense_pm.gather_vec(
                            field, ps, starts, scheme), acc))
                check(torch.backends.cuda.matmul.allow_tf32,
                      "the dense engine did not restore TF32")
            finally:
                torch.backends.cuda.matmul.allow_tf32 = flag
            check(same, f"dense {m}^3 {scheme}: TF32 on changed the result")
    log(f"[15 dense] 64^3 and 128^3, NGP/CIC/TSC, clustered: deposit vs "
        f"the tiled kernel max rel {worst_d:.2e}, gather vs the scatter "
        f"gather max rel {worst_g:.2e} (bound 1e-5); bitwise the same "
        "in a second call and with global TF32 on")
    # every particle in 4 of 64 planes: far past the capacity
    m = 64
    pos, vel = _particles(torch, m ** 3, m, False, gen)
    pos[:, 0] = pos[:, 0] * (4.0 / m)
    ps, _, starts = dense_pm.sort_by_plane(pos, m, "cic", vel)
    _, overflow = dense_pm.deposit(ps, starts, m, "cic")
    counts = np.diff(starts.cpu().numpy().astype(np.int64))
    want = int(np.maximum(counts - dense_pm._capacity(m ** 3, m), 0).sum())
    check(int(overflow) == want > 0,
          f"dense overflow {int(overflow)}, expected {want} > 0")
    log(f"[15 dense] clustered 64^3 (4 planes): overflow {int(overflow)} "
        "particles, as the plane counts give")


def _dense_times(torch, gen):
    """Phase 15 (a): CUDA-event times of the dense transfers at 128^3 and
    256^3 CIC beside their FLOP bounds and the tiled kernels."""
    from pysco_tpu_torch.ops import dense_pm, tiled_pm as tp

    for m, reps in ((128, 3), (256, 2)):
        n = m ** 3
        pos, vel = _particles(torch, n, m, False, gen)
        field = torch.randn((m, m, m, 3), generator=gen, device="cuda")
        ps, vs, starts = dense_pm.sort_by_plane(pos, m, "cic", vel)
        pc, vc = tp.to_columns(pos, vel, n)
        pt, _, ts = tp.sort_particles(pc, vc, m, "cic")
        field_cl = field.movedim(-1, 0).contiguous()
        t_dep = time_ms(torch, lambda: dense_pm.deposit(ps, starts, m,
                                                        "cic"), reps)
        t_gat = time_ms(torch, lambda: dense_pm.gather_vec(field, ps, starts,
                                                           "cic"), reps)
        t_sort = time_ms(torch, lambda: dense_pm.sort_by_plane(pos, m, "cic",
                                                               vel), reps)
        k_dep = time_ms(torch, lambda: tp.deposit(pt, ts, m, "cic"))
        k_gat = time_ms(torch, lambda: tp.gather_vec_cl(field_cl, pt, ts,
                                                        "cic"))
        padded, valid = _dense_flops(n, m, "cic")
        parts = []
        for name, t, i in (("deposit", t_dep, 0), ("gather", t_gat, 1)):
            b_pad, b_val = (f[i] / F32_FLOPS_PER_S * 1e3
                            for f in (padded, valid))
            parts.append(
                f"{name} {t:.2f} ms (bound {b_pad:.2f} ms over "
                f"{padded[i]:.2e} FLOPs of padded rows, "
                f"{100 * b_pad / t:.1f}%; {b_val:.2f} ms over "
                f"{valid[i]:.2e} of the particles', {100 * b_val / t:.1f}%)")
        log(f"[15 dense] {m}^3 CIC, {n} particles: " + ", ".join(parts)
            + f", plane sort {t_sort:.2f} ms; the tiled kernels on the same "
            f"particles: deposit {k_dep:.3f} ms, gather {k_gat:.3f} ms")
        del ps, vs, pc, vc, pt, field, field_cl
        torch.cuda.empty_cache()


def _sort_state(torch, tp, m, scenario, gen):
    """m^3 particles in column state: ``random``, or tile-sorted and then
    moved up to 0.25 cell per axis, each keeping its side of the periodic
    wrap of the x and y keys (a particle whose base cell would wrap keeps
    that coordinate): such a particle's sorted place moves by at most about
    one plane's n/m columns."""
    n = m ** 3
    pos, vel = _particles(torch, n, m, False, gen)
    pc, vc = tp.to_columns(pos, vel, n)
    del pos, vel
    if scenario == "random":
        return pc, vc
    pc, vc, _ = tp.sort_particles(pc, vc, m, "cic")
    moved = torch.remainder(pc[:3] + 0.25 / m * (
        2 * torch.rand((3, n), generator=gen, device="cuda") - 1), 1.0)
    for a in (0, 1):
        k0, k1 = (tp._base_axis("cic", x * m) % m for x in (pc[a], moved[a]))
        moved[a] = torch.where((k1 - k0).abs() > 1, pc[a], moved[a])
    pc[:3] = moved
    return pc, vc


def _nearly_route(torch, tp, pc, vc, m, block=1 << 18):
    """The JAX package's ``nearly`` sort route (``pallas_pm._nearly_sort``),
    rebuilt here to time it; the port does not take it. With B the largest
    power-of-two divisor of the column count capped at ``block``: when B
    >= 4096 and the columns make two blocks or more, a stable sort of each
    block of B tile keys, then of the half-shifted blocks, the two
    permutations composed and the keys checked non-decreasing on the host;
    else, or when the check fails, the full sort. Returns (pos, vel,
    tile_starts, branch)."""
    key = tp.tile_keys(pc, m, "cic")
    n = key.shape[0]
    big = min(block, n & -n)
    h = big // 2

    def blocks(k):
        nb = k.shape[0] // big
        sk, o = torch.sort(k.view(nb, big), dim=1, stable=True)
        first = torch.arange(0, nb * big, big, device=k.device)
        return sk.reshape(-1), (o + first.unsqueeze(1)).reshape(-1)

    branch = "fallback"
    if big >= 4096 and n // big >= 2:
        k1, o1 = blocks(key)
        k2, o2 = blocks(k1[h:n - h])
        skey = torch.cat([k1[:h], k2, k1[n - h:]])
        if bool(torch.all(skey[1:] >= skey[:-1])):
            order = torch.cat([o1[:h], o1[h:n - h][o2], o1[n - h:]])
            branch = "nearly"
    if branch == "fallback":
        skey, order = torch.sort(key, stable=True)
    tiles = torch.arange(tp._geometry(m, "cic").ntiles + 1,
                         dtype=skey.dtype, device=skey.device)
    starts = torch.searchsorted(skey, tiles, side="left").to(torch.int32)
    return (pc.index_select(1, order), vc.index_select(1, order), starts,
            branch)


def _sort_modes(torch, gen):
    """Phase 15 (c): the four sort modes at 256^3 and 512^3 CIC on a
    drifted and on a random state: bitwise one result (the port's one
    stable sort), its time beside that of the JAX package's nearly route
    rebuilt here, which must give the same bits, and take its block rounds
    where the displacement bound says they hold: on the drifted state, a
    particle that changes plane moves by about one plane's n/m columns,
    and the rounds reach half a block."""
    from pysco_tpu_torch.ops import tiled_pm as tp

    for m in (256, 512):
        n = m ** 3
        for scenario in ("drifted", "random"):
            pc, vc = _sort_state(torch, tp, m, scenario, gen)
            cols = pc.shape[1]
            big = min(1 << 18, cols & -cols)  # B of _nearly_route
            holds = (scenario == "drifted" and big >= 4096
                     and cols // big >= 2 and n // m < big // 2)
            want = tp.sort_particles(pc, vc, m, "cic")
            for mode in tp.SORT_MODES:
                got = tp.sort_particles(pc, vc, m, "cic", mode=mode)
                check(all(torch.equal(a, b) for a, b in zip(got, want)),
                      f"sort {m}^3 {scenario}: {mode} differs from full")
                del got
            *got, branch = _nearly_route(torch, tp, pc, vc, m)
            check(all(torch.equal(a, b) for a, b in zip(got, want)),
                  f"sort {m}^3 {scenario}: the nearly route differs")
            del got
            expect = "nearly" if holds else "fallback"
            check(branch == expect, f"sort {m}^3 {scenario}: the nearly "
                  f"route took {branch}, expected {expect}")
            t_port = time_ms(torch, lambda: tp.sort_particles(pc, vc, m,
                                                              "cic"), 3)
            t_nearly = time_ms(torch, lambda: _nearly_route(torch, tp, pc,
                                                            vc, m), 3)
            log(f"[15 sort] {m}^3 CIC {scenario}, {n} particles: the four "
                f"modes bitwise equal, {t_port:.2f} ms; JAX's nearly route "
                f"(B = {big}, {branch} branch) {t_nearly:.2f} ms, the same "
                "bits")
            del pc, vc, want
            torch.cuda.empty_cache()


def phase_dense_sort(torch, np, tmp):
    """Phase 15: the dense engine and the sort modes."""
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(15)
    _dense_checks(torch, np, gen)
    _dense_times(torch, gen)

    # (b) the golden configuration with the dense engine, single and
    # replicated: no tiled or stencil kernel launches (the dense path has
    # none), P(k) to the golden file and replicated to single
    runs = {}
    for mode, devices in (("single", None), ("replicated", ["cuda:0"] * 2)):
        _, base, launches = phase_golden(np, tmp, mode, devices,
                                         "15 golden", "dense")
        check(not any(launches.values()),
              f"dense {mode} run launched {launches}")
        runs[mode] = _pk_files(np, base)
    worst = _pk_worst(np, runs["replicated"], runs["single"], "15 golden")
    check(worst <= 1e-5, f"dense replicated vs single P(k) {worst:.2e}")
    log(f"[15 golden] dense replicated vs single max rel P(k) {worst:.2e} "
        "(bound 1e-5); no tiled or stencil kernel launched")

    _sort_modes(torch, gen)
    log(f"[15] phase in {time.perf_counter() - t0:.1f} s")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--before-deposit", metavar="DEPOSIT_CU",
                    help="an earlier csrc/deposit.cu (with its tiled_pm.cuh "
                    "beside it) to time in turns with the package's in "
                    "phase 3's three 512^3 states")
    args = ap.parse_args()
    check(os.path.isdir(os.path.join(REPO, "pysco_tpu_torch")),
          "pysco_tpu_torch not found beside chip_smoke.py")
    sys.path.insert(0, REPO)
    import numpy as np
    import torch

    t_start = time.perf_counter()
    smi = phase_device(torch)
    phase_build()
    err, times, meta = phase_kernels(torch)
    phase_deposit_states(torch, np, args.before_deposit)
    err_st, times_st, meta_st = phase_stencil_kernels(torch, np)
    err.update(err_st)
    times.update(times_st)
    meta.update(meta_st)
    tmp = tempfile.mkdtemp(prefix="pysco_smoke_")
    try:
        phase_golden(np, tmp)
        phase_pk_bitwise(torch)
        main_base, main_stale, main_sorted = phase_main_path(torch, np, tmp)
        phase_mg_e2e(np, tmp, (("newton_multigrid_tsc_2lpt", {}),
                               ("mond_multigrid", {"theory": "mond"})),
                     "6 mg e2e")
        phase_mg_main_path(torch, np, tmp)
        phase_mond(torch, np, tmp)
        phase_mg_e2e(np, tmp, (("fr_n1", {"theory": "fr", "fR_n": 1}),
                               ("fr_n2", {"theory": "fr", "fR_n": 2})),
                     "9 fr e2e")
        launches, fr_ref = phase_fr_main_path(torch, np, tmp)
        launches["scalaron_quartic_exact_half_sweep"] = phase_fr_n2(
            torch, np, tmp)
        phase_extras(torch, np, tmp)
        phase_parallel(torch, np, tmp, main_base, main_stale, main_sorted)
        slab_launches = phase_slab_mg(torch, np, tmp, fr_ref)
        launches.update({k: slab_launches[k] for k in SLAB_KERNELS})
        phase_dense_sort(torch, np, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[done] all phases in {time.perf_counter() - t_start:.1f} s")
    log(smi)  # again near the end, for readers of the output's tail
    record = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": err[name],
         "ms": times[name], "plain_ms": times[f"{name}_plain"],
         "bound_ms": meta[name]["bound"][0],
         "bound_by": meta[name]["bound"][1],
         "library_ms": meta[name]["library_ms"]}
        for name, (src, rep) in KERNELS.items()
    ] + [
        {"name": name, "route": "cuda", "source": src, "replaces": None,
         "launches": launches[name], "max_abs_err": err[name],
         "ms": times[name],
         "plain_ms": times[f"{name}_plain"],
         "bound_ms": meta[name]["bound"][0],
         "bound_by": meta[name]["bound"][1], "library_ms": None}
        for name, src in EXTRA_KERNELS.items()
    ]
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
