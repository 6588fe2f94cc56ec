"""Slab-decomposed PM step: grids and particles sharded in x over a mesh
(PyTorch port of ``pysco_tpu/parallel/slab.py``).

The grid is cut into x-slabs of ``M / D`` planes over a 1-D mesh
(:mod:`.mesh`); shard r owns the particles whose mass-assignment base plane
lies in its slab, runs the tiled kernels' slab forms on them
(``tiled_pm.deposit_slab``, ``tiled_pm.gather_vec_slab``), and the field
solve is a distributed pencil FFT:

- deposit: the local slab deposit, then the w - 1 (+ drift) spill planes go
  to the neighbours (:func:`add_spill`, the slab analogue of the periodic
  fold);
- Poisson: FFTs over the local (y, z) axes, one all-to-all so that x becomes
  local, the FFT over x, the k-space kernel with the shard's y wavenumbers,
  and the chain back;
- force: the gradient stencil with a halo exchange in x (y and z are local
  rolls);
- gather: the local slab gather from the force slab extended by its halo
  planes;
- migration: after the drift of a sorted step, particles whose base plane
  left the slab are packed into fixed-capacity buffers and sent to the two
  neighbours (:func:`migrate`); the tile sort that follows takes the
  arrivals in and pushes sentinels and strangers past the end, so cutting
  back to the shard's capacity drops empty slots only (``overflow`` counts
  anything else).

Where the JAX module is one ``shard_map`` program per device, here every
function takes and returns **lists of per-shard tensors** and loops over the
shards; all traffic between them goes through :mod:`.mesh`. No function
synchronises with the host, so the shards of a mesh of distinct cards
overlap. Force fields are component-leading, (3, P, M, M), as the tiled
gather reads them.

Every theory (newton, parametrized, f(R) n = 1 and 2, QUMOND) and every
solver (fft, fft_7pt, full_fft, and multigrid with V, F or W cycles through
:mod:`.slab_mg`) runs on the slabs.
"""

from __future__ import annotations

import logging
import math

import numpy as np
import torch

from ..integrate import StepDiagnostics, kick_drift
from ..models import cubic, laplacian, mond, quartic
from ..ops import fourier, tiled_pm
from ..ops import mesh as mesh_ops
from ..solver import DynScalars, SolverConfig, _newton_rhs
from . import mesh as pmesh
from .mesh import Mesh

F32 = torch.float32
I32 = torch.int32
_WIDTH = tiled_pm._WIDTH

# ---------------------------------------------------------------------------
# Distributed pencil FFT and the k-space kernels on the pencil layout
# ---------------------------------------------------------------------------

def rfft3_slab(xs: list, mesh: Mesh) -> list:
    """rfftn of an x-slab-sharded real grid: per shard (P, M, M) ->
    (M, M/D, M/2+1), x local and y sharded; one all-to-all does the
    transpose."""
    xk = [torch.fft.fft(torch.fft.rfft(x.to(F32), dim=2), dim=1) for x in xs]
    xk = pmesh.all_to_all(xk, mesh, split_axis=1, concat_axis=0)
    return [torch.fft.fft(x, dim=0) for x in xk]


def irfft3_slab(xk: list, mesh: Mesh, m: int, axis0: int = 0) -> list:
    """Inverse of :func:`rfft3_slab`: per shard (M, M/D, M/2+1) ->
    (P, M, M). ``axis0 = 1`` takes a leading component axis along."""
    xk = [torch.fft.ifft(x, dim=axis0) for x in xk]
    xk = pmesh.all_to_all(xk, mesh, split_axis=axis0, concat_axis=axis0 + 1)
    out = []
    for x in xk:
        x = torch.fft.ifft(x, dim=axis0 + 1)
        # the real transform reads only the real part of its zero and
        # Nyquist frequencies, as numpy's irfftn and cuFFT's 3-D one do;
        # cuFFT's 1-D C2R reads the imaginary parts too, which a spectrum
        # that is not Hermitian there (a gradient's Nyquist plane) has
        x[..., 0].imag.zero_()
        if m % 2 == 0:
            x[..., -1].imag.zero_()
        out.append(torch.fft.irfft(x, n=m, dim=axis0 + 2).to(F32))
    return out


def _wavenumbers_slab(m: int, ny_local: int, r: int, device):
    """Integer wavenumbers of shard r's (M, M/D, M/2+1) pencil: the y axis
    starts at row r * M/D."""
    kx, ky, kz = fourier._wavenumbers(m, device)
    return kx, ky[:, r * ny_local:(r + 1) * ny_local], kz


def _dc(ks):
    kx, ky, kz = ks
    return (kx == 0) & (ky == 0) & (kz == 0)


def _k2_safe(ks):
    """|k|^2 with the DC entry (on the shard that holds it) set to 1."""
    kx, ky, kz = ks
    k2 = kx * kx + ky * ky + kz * kz
    return torch.where(_dc(ks), torch.ones_like(k2), k2)


def _zero_dc(xk, ks):
    return torch.where(_dc(ks), torch.zeros_like(xk), xk)


def _per_pencil(fn, xk: list, m: int):
    """Apply ``fn(pencil, wavenumbers)`` to every shard's pencil."""
    return [fn(x, _wavenumbers_slab(m, x.shape[1], r, x.device))
            for r, x in enumerate(xk)]


def inverse_laplacian_slab(xk: list, m: int, p: int) -> list:
    """-1/(4 pi^2 k^2) with the Jing sinc^-2p compensation of the mass
    assignment (p = 0: none), on the pencil layout; the arithmetic of
    ``fourier.inverse_laplacian_compensated``."""
    c = fourier._f32(-0.25 / math.pi ** 2)

    def one(x, ks):
        ratio = c / _k2_safe(ks)
        if p:
            ratio = fourier._sinc_weight(m, x.device, ks) ** (-2 * p) * ratio
        return _zero_dc(x * ratio, ks)

    return _per_pencil(one, xk, m)


def inverse_laplacian_7pt_slab(xk: list, m: int) -> list:
    """Exact inverse of the discrete 7-point Laplacian on the pencil layout
    (``fourier.inverse_laplacian_7pt``)."""
    pi_h = fourier._f32(math.pi / m)
    h = fourier._f32(1.0 / m)
    minus_h2_inv4 = fourier._f32(-0.25 * h * h)

    def one(x, ks):
        kx, ky, kz = ks
        f = (torch.sin(pi_h * kx) ** 2 + torch.sin(pi_h * ky) ** 2
             + torch.sin(pi_h * kz) ** 2)
        f = torch.where(_dc(ks), torch.ones_like(f), f)
        return _zero_dc(x * (minus_h2_inv4 / f), ks)

    return _per_pencil(one, xk, m)


def gradient_inverse_laplacian_slab(xk: list, mesh: Mesh, m: int,
                                    p: int) -> list:
    """full_fft force on the pencil layout: -i k_n / (2 pi k^2) x with the
    mass-assignment compensation, back to real space as the component-leading
    force slab (3, P, M, M)."""
    c = fourier._f32(0.5 / math.pi)

    def one(x, ks):
        ratio = c / _k2_safe(ks)
        if p:
            ratio = fourier._sinc_weight(m, x.device, ks) ** (-2 * p) * ratio
        tmp = _zero_dc(-1j * (ratio * x), ks)
        return torch.stack([tmp * k for k in ks], dim=0)

    return irfft3_slab(_per_pencil(one, xk, m), mesh, m, axis0=1)


def power_spectrum_slab(xk: list, mesh: Mesh, m: int, p: int):
    """Binned P(k) of the pencil layout: every shard sums its modes per bin
    in the fixed order of ``fourier.power_spectrum``, and the shards' sums
    are added in shard order. Returns (k, Pk, Nmodes) on shard 0's device,
    the estimator and units of ``fourier.power_spectrum``."""
    pksum, ksum, nmodes = [], [], []
    for r, x in enumerate(xk):
        ny = x.shape[1]
        bins = fourier._pk_bins(m, x.device, r * ny, ny)
        if p:
            ks = _wavenumbers_slab(m, ny, r, x.device)
            x = x * fourier._sinc_weight(m, x.device, ks) ** (-p)
        pksum.append(fourier._binned_sum(x.real ** 2 + x.imag ** 2, bins))
        ksum.append(bins.k)
        nmodes.append(bins.nmodes)
    pksum, ksum, nmodes = (pmesh.psum(v, mesh)[0]
                           for v in (pksum, ksum, nmodes))
    n64 = nmodes.double()
    return (ksum / n64).to(F32), (pksum / n64).to(F32), nmodes


# ---------------------------------------------------------------------------
# Halo exchange and slab stencils
# ---------------------------------------------------------------------------

def halo_lr(fs: list, h_l: int, h_r: int, mesh: Mesh, axis: int = 0) -> list:
    """Per shard (P, ...) -> (h_l + P + h_r, ...) along ``axis``: the last
    h_l planes of the left neighbour, the slab, the first h_r planes of the
    right neighbour (periodic around the mesh)."""
    planes = fs[0].shape[axis]
    if max(h_l, h_r) > planes:
        raise ValueError(f"a halo of {max(h_l, h_r)} planes from slabs of "
                         f"{planes}")
    parts = [fs]
    if h_l:
        parts.insert(0, pmesh.ppermute_fwd(
            [f.narrow(axis, planes - h_l, h_l) for f in fs], mesh))
    if h_r:
        parts.append(pmesh.ppermute_bwd(
            [f.narrow(axis, 0, h_r) for f in fs], mesh))
    if len(parts) == 1:
        return list(fs)
    return [torch.cat(p, dim=axis) for p in zip(*parts)]


def exchange_halo_x(fs: list, h: int, mesh: Mesh, axis: int = 0) -> list:
    """Per shard (P, ...) -> (P + 2h, ...): h wrapped planes from each
    side."""
    return halo_lr(fs, h, h, mesh, axis)


def add_spill(gps: list, n_planes: int, mesh: Mesh, lead: int = 0) -> list:
    """Fold every deposit slab's spill planes onto the neighbouring shards.

    A slab is (lead + n_planes + s, M, M), x index i holding grid plane
    (plane0 + i - lead): the leading ``lead`` planes belong to the left
    neighbour's last planes (lazy drift windows), the trailing s to the
    right neighbour's first. On a mesh of one shard this is the
    single-device periodic fold.
    """
    s = gps[0].shape[0] - n_planes - lead
    body = [gp[lead:lead + n_planes].clone() for gp in gps]
    if s:
        spill = pmesh.ppermute_fwd([gp[lead + n_planes:] for gp in gps], mesh)
        for b, sp in zip(body, spill):
            b[:s] += sp
    if lead:
        spill = pmesh.ppermute_bwd([gp[:lead] for gp in gps], mesh)
        for b, sp in zip(body, spill):
            b[n_planes - lead:] += sp
    return body


_STENCIL_HALO = {2: 1, 3: 1, 5: 2, 7: 3}


def derivative_slab(phis: list, order: int, mesh: Mesh) -> list:
    """Gradient stencil on x-slabs, component-leading: per shard (P, M, M)
    -> (3, P, M, M). x through halo-exchanged slices, y and z through
    rolls; the stencils and their order of operations are
    ``mesh.derivative``'s."""
    if order not in _STENCIL_HALO:
        raise NotImplementedError(
            f"gradient stencil order {order}, should be 2, 3, 5 or 7")
    h = _STENCIL_HALO[order]
    out = []
    for phi, ext in zip(phis, exchange_halo_x(phis, h, mesh)):
        planes, m = phi.shape[0], phi.shape[1]

        def sx(shift, ext=ext, planes=planes):
            return ext[h - shift:h - shift + planes]

        comps = [mesh_ops.stencil_diff(sx, m, order)]
        for axis in (1, 2):
            comps.append(mesh_ops.stencil_diff(
                lambda shift, axis=axis, phi=phi: (
                    torch.roll(phi, shift, dims=axis) if shift else phi),
                m, order))
        out.append(torch.stack(comps, dim=0))
    return out


def derivative_fR_slab(phis: list, us: list, f, fR_n: int, order: int,
                       mesh: Mesh) -> list:
    """f(R) force mesh on the slabs: grad(phi + f u^(fR_n+1)), f rounded to
    float32 (``mesh.derivative_fR``)."""
    f = float(np.float32(f))
    if fR_n == 1:
        combined = [phi + f * u * u for phi, u in zip(phis, us)]
    elif fR_n == 2:
        combined = [phi + f * u * u * u for phi, u in zip(phis, us)]
    else:
        raise NotImplementedError(f"fR_n must be 1 or 2, got {fR_n}")
    return derivative_slab(combined, order, mesh)


def mond_rhs_slab(phis: list, g0, mond_function: str, alpha,
                  mesh: Mesh) -> list:
    """QUMOND source on the slabs: a 2-plane halo exchange, then the
    single-device roll kernel on the extended slab (its x rolls spoil only
    the halo planes, which are cut off: every chain of accesses stays within
    2 cells)."""
    return [mond.rhs(ext, g0, mond_function, alpha)[2:-2]
            for ext in exchange_halo_x(phis, 2, mesh)]


# ---------------------------------------------------------------------------
# Particle migration
# ---------------------------------------------------------------------------

def _pack(mask, position, velocity, cap: int):
    """The first ``cap`` columns that ``mask`` selects, in their order, as a
    (4, cap) position and velocity buffer whose unused slots are sentinels;
    no host synchronisation (no ``nonzero``)."""
    dev = position.device
    rank = torch.cumsum(mask, 0) - 1
    # column cap is a dump for everything that is not packed
    dest = torch.where(mask & (rank < cap), rank, torch.full_like(rank, cap))
    p = torch.full((4, cap + 1), tiled_pm.SENTINEL, dtype=F32, device=dev)
    v = torch.zeros((4, cap + 1), dtype=F32, device=dev)
    p.index_copy_(1, dest, position)
    v.index_copy_(1, dest, velocity)
    p, v = p[:, :cap].contiguous(), v[:, :cap].contiguous()
    # a packed column brought its zero row along; an unused slot needs one
    p[3] = 0.0
    return p, v


def migrate(position: list, velocity: list, m: int, planes_per_shard: int,
            cap: int, mesh: Mesh, scheme: str):
    """Exchange the particles whose base plane left their slab.

    The CFL drift bound keeps migration to the adjacent slabs; anything
    farther, and anything beyond a buffer's ``cap`` columns, is counted in
    ``lost`` (and dropped), which a healthy run never sees. Returns
    (position, velocity, lost) per shard, with 2 cap columns of arrivals
    appended (unused slots are sentinels).
    """
    n_dev = len(mesh)
    if n_dev == 1:
        # one slab owns every plane: nothing can migrate, and the two
        # exchanges would deliver each leaver twice
        zero = torch.zeros((), dtype=torch.int64, device=mesh[0])
        return list(position), list(velocity), [zero]
    stay_p, stay_v, send_r, send_l, lost = [], [], [], [], []
    for r, (pos, vel) in enumerate(zip(position, velocity)):
        px = tiled_pm._base_axis(scheme, pos[0] * float(m)) % m
        dest = px // planes_per_shard
        is_real = pos[0] < tiled_pm.SENTINEL_MIN
        if n_dev == 2:
            # both neighbours are the same shard: split the leavers by the
            # edge they crossed (signed plane distance from the slab's
            # first plane), so each is delivered once and each direction
            # keeps its own buffer
            leaver = is_real & (dest != r)
            d_planes = (px - r * planes_per_shard) % m
            go_right = leaver & (d_planes < 3 * planes_per_shard // 2)
            go_left = leaver & ~go_right
        else:
            go_right = is_real & (dest == (r + 1) % n_dev)
            go_left = is_real & (dest == (r - 1) % n_dev)
        stays = is_real & (dest == r)
        lost.append(
            torch.sum(is_real & ~go_right & ~go_left & ~stays)
            + torch.clamp(torch.sum(go_right) - cap, min=0)
            + torch.clamp(torch.sum(go_left) - cap, min=0))
        send_r.append(_pack(go_right, pos, vel, cap))
        send_l.append(_pack(go_left, pos, vel, cap))
        leaving = (go_right | go_left)[None, :]
        pos = torch.where(leaving, torch.full_like(pos, tiled_pm.SENTINEL),
                          pos)
        pos[3] = 0.0
        stay_p.append(pos)
        stay_v.append(torch.where(leaving, torch.zeros_like(vel), vel))
    out_p, out_v = [stay_p], [stay_v]
    for send, permute in ((send_r, pmesh.ppermute_fwd),
                          (send_l, pmesh.ppermute_bwd)):
        out_p.append(permute([s[0] for s in send], mesh))
        out_v.append(permute([s[1] for s in send], mesh))
    return ([torch.cat(p, dim=1) for p in zip(*out_p)],
            [torch.cat(v, dim=1) for v in zip(*out_v)], lost)


# ---------------------------------------------------------------------------
# The sharded step
# ---------------------------------------------------------------------------

def shard_capacity(npart: int, n_dev: int, slack: float = 1.25) -> int:
    """Per-shard particle capacity (slabs are not evenly filled once
    structure forms; an overflow is detected, not silent)."""
    return tiled_pm.padded_cols(int(npart / n_dev * slack))


def migration_capacity(npart: int, ncells_1d: int, n_dev: int) -> int:
    """Per-direction migration buffer: about 4 mean plane populations."""
    del n_dev
    return tiled_pm.padded_cols(max(1024, 4 * npart // (ncells_1d or 1)))


def grow_capacity(cap_new: int, position: list, velocity: list,
                  acceleration: list):
    """Grow every shard's column state to ``cap_new`` columns on its device.

    Re-balancing happens after a sorted step, when every particle sits on
    the shard that owns its plane with its real columns first: growing is
    appending sentinel columns past every tile, ``tile_starts`` stays
    valid, and nothing crosses a device."""
    def pad(a, fill):
        k = cap_new - a.shape[1]
        tail = torch.full((4, k), fill, dtype=F32, device=a.device)
        tail[3] = 0.0
        return torch.cat((a, tail), dim=1)

    return ([pad(p, tiled_pm.SENTINEL) for p in position],
            [pad(v, 0.0) for v in velocity],
            [pad(a, 0.0) for a in acceleration])


def check_supported(cfg: SolverConfig) -> None:
    """Raise for an engine the slab step does not run."""
    if cfg.particle_engine != "pallas":
        raise NotImplementedError(
            f"particle_engine={cfg.particle_engine!r} with "
            "parallel_mode='slab': the slab step runs only 'pallas' (the "
            "tiled kernels; scatter and dense are single-device engines)")


def _tolerance(dyn: DynScalars, error) -> np.float32:
    """epsrel times a truncation error, in float32 (one host fetch)."""
    return np.float32(dyn.epsrel) * np.float32(float(error))


def _multigrid_solve(cfg: SolverConfig, rhs: list, x: list, dyn: DynScalars,
                     mesh: Mesh) -> list:
    """Linear slab multigrid solve of L(x) = rhs from the first guess x, to
    epsrel times the truncation error of x (``solver._multigrid_solve``)."""
    from . import slab_mg

    tolerance = _tolerance(dyn, slab_mg.truncation_error_slab(x, mesh))
    return slab_mg.linear_slab(x, rhs, cfg.ncoarse, cfg.Npre, cfg.Npost,
                               tolerance, mesh, cfg.multigrid_cycle)


def _fft_solve(cfg: SolverConfig, rhs: list, mesh: Mesh, m: int,
               seven_point: bool) -> list:
    rhs_k = rfft3_slab(rhs, mesh)
    if seven_point:
        phi_k = inverse_laplacian_7pt_slab(rhs_k, m)
    else:
        phi_k = inverse_laplacian_slab(rhs_k, m, cfg.mas_index)
    return irfft3_slab(phi_k, mesh, m)


def _linear_solve_slab(cfg: SolverConfig, rhs: list, phi: list,
                       dyn: DynScalars, mesh: Mesh, first_call: bool) -> list:
    """The potential from the Poisson rhs (``solver._linear_solve``):
    multigrid from the previous potential rescaled by the growth since its
    step (a Jacobi first guess on the first call), or a pencil FFT solve."""
    if cfg.linear_newton_solver == "multigrid":
        if first_call:
            phi = [laplacian.initialise_potential(r) for r in rhs]
        else:
            phi = [p * dyn.potential_scaling for p in phi]
        return _multigrid_solve(cfg, rhs, phi, dyn, mesh)
    return _fft_solve(cfg, rhs, mesh, cfg.ncells_1d,
                      seven_point=cfg.linear_newton_solver == "fft_7pt")


def _additional_field_slab(cfg: SolverConfig, density: list, u: list,
                           dyn: DynScalars, mesh: Mesh,
                           first_call: bool) -> list:
    """The extra field of a modified theory on the slabs
    (``solver._additional_field``): the f(R) scalaron by slab FAS; MOND's
    Newtonian potential by slab multigrid or the exact 7-point FFT solve."""
    from . import slab_mg

    if cfg.theory == "fr":
        dens_term = [dyn.fR_f1 * d + dyn.fR_f2 for d in density]
        exact_root = cfg.fR_root_solver == "exact"
        if cfg.fR_n == 1:
            ops = slab_mg.fas_ops_cubic_slab(dyn.fR_q, mesh, exact_root)
            init = cubic.initialise_potential
        else:
            ops = slab_mg.fas_ops_quartic_slab(dyn.fR_q, mesh, exact_root)
            init = quartic.initialise_potential
        if first_call:
            u = [init(d, dyn.fR_q) for d in dens_term]
        tolerance = _tolerance(dyn, ops.truncation_error(u, dens_term))
        return slab_mg.FAS_slab(u, dens_term, ops, cfg.ncoarse, cfg.Npre,
                                cfg.Npost, tolerance, mesh,
                                cfg.multigrid_cycle)
    if cfg.theory != "mond":
        return u
    rhs_newton = [_newton_rhs(d, dyn) for d in density]
    if cfg.linear_newton_solver == "multigrid":
        if first_call:
            u = [laplacian.initialise_potential(r) for r in rhs_newton]
        return _multigrid_solve(cfg, rhs_newton, u, dyn, mesh)
    # the inner Newtonian solve is the discrete one whenever the solver is
    # not multigrid
    return _fft_solve(cfg, rhs_newton, mesh, cfg.ncells_1d, seven_point=True)


def _solve_slab(cfg: SolverConfig, density: list, phi: list, u: list,
                dyn: DynScalars, mesh: Mesh, save_pk: bool,
                first_call: bool):
    """The field solve on the slabs (``solver._solve_fields``): optional
    P(k), the extra field, the Poisson solve, the force mesh. Returns
    (force, phi, u, pk), force component-leading."""
    m = cfg.ncells_1d
    pk = None
    if save_pk:
        pk = power_spectrum_slab(rfft3_slab(density, mesh), mesh, m,
                                 cfg.mas_index)
    u = _additional_field_slab(cfg, density, u, dyn, mesh, first_call)
    if cfg.theory == "mond":
        rhs = mond_rhs_slab(u, dyn.mond_g0, cfg.mond_function,
                            cfg.mond_alpha, mesh)
    else:
        rhs = [_newton_rhs(d, dyn) for d in density]
    order = cfg.gradient_stencil_order
    if cfg.linear_newton_solver == "full_fft":
        force = gradient_inverse_laplacian_slab(rfft3_slab(rhs, mesh), mesh,
                                                m, cfg.mas_index)
        if cfg.theory == "fr":
            force = [f + g for f, g in zip(force, derivative_fR_slab(
                [torch.zeros_like(r) for r in rhs], u, dyn.fR_half_c2,
                cfg.fR_n, order, mesh))]
        return force, phi, u, pk
    phi = _linear_solve_slab(cfg, rhs, phi, dyn, mesh, first_call)
    if cfg.theory == "fr":
        force = derivative_fR_slab(phi, u, dyn.fR_half_c2, cfg.fR_n, order,
                                   mesh)
    else:
        force = derivative_slab(phi, order, mesh)
    return force, phi, u, pk


def make_slab_step(cfg: SolverConfig, mesh: Mesh,
                   integrator: str = "leapfrog", save_pk: bool = False,
                   first_call: bool = False, presorted: int = 0,
                   zbs: int | None = None):
    """Build the slab-sharded KDK step (``slab.make_slab_step``).

    State per shard: position, velocity and acceleration columns (4, C)
    with sentinel empties, the potential slab (M/D, M, M), the
    additional-field slab (the f(R) scalaron, MOND's Newtonian potential;
    a token otherwise) and the slab's tile starts. Returns ``fn(pos, vel,
    acc, phi, u, tstarts, dyn, dt) -> (pos, vel, acc, phi, u, tstarts, pk,
    diag)`` over
    lists of per-shard tensors; ``pk`` is None unless ``save_pk``; the
    diagnostics are tensors on shard 0's device. ``first_call=True``
    starts the multigrid and FAS solves from their first guesses instead
    of the previous fields: the initial force evaluation, a zero-dt step.

    ``presorted = k >= 1`` is the slab form of lazy re-binning: migration
    and the tile sort are skipped, the particles run through k-cell
    drift-widened kernels in their stale bins, the deposit spills up to k
    planes onto both neighbours and the gather takes the matching halo, so a
    binning less than k cells stale (the caller's CFL bound) stays exact
    across slab edges; the violations are counted into ``overflow``.
    ``zbs`` forces small z-blocks (tests only).
    """
    check_supported(cfg)
    n_dev = len(mesh)
    m = cfg.ncells_1d
    planes = m // n_dev
    drift = int(presorted)
    scheme = cfg.mass_scheme
    w = _WIDTH[scheme]
    if planes * n_dev != m or planes < w - 1 + drift:
        raise ValueError(
            f"ncells_1d={m} must be divisible by n_devices={n_dev} with "
            "slabs at least as tall as the (drift-widened) deposit window"
        )
    if integrator not in ("leapfrog", "euler"):
        raise NotImplementedError(
            f"integrator {integrator!r}, must be 'leapfrog' or 'euler'")
    cap_mig = migration_capacity(cfg.npart, m, n_dev)
    norm = float(np.float32(m ** 3 / cfg.npart))
    shards = range(n_dev)

    def step(position, velocity, acceleration, phi, u, tstarts, dyn, dt):
        moved = [kick_drift(integrator, p, v, a, dt)
                 for p, v, a in zip(position, velocity, acceleration)]
        position = [m[0] for m in moved]
        velocity = [m[1] for m in moved]
        last_kick = moved[0][2]

        if presorted:
            # stale bins stay: count the particles outside the widened
            # windows (a broken CFL bound) instead of trusting the bound
            overflow = [
                tiled_pm.drift_violations(position[r], tstarts[r], m, scheme,
                                          drift, zbs, r * planes, planes)
                for r in shards]
        else:
            # migration, then the local tile sort: arrivals ride along,
            # sentinels and strangers sort past the end and are cut off
            cap = position[0].shape[1]
            position, velocity, lost = migrate(
                position, velocity, m, planes, cap_mig, mesh, scheme)
            srt = [tiled_pm.sort_particles(position[r], velocity[r], m,
                                           scheme, zbs, r * planes, planes,
                                           mode=cfg.sort_mode)
                   for r in shards]
            position = [s[0][:, :cap].contiguous() for s in srt]
            velocity = [s[1][:, :cap].contiguous() for s in srt]
            tstarts = [s[2] for s in srt]
            overflow = [lost[r] + torch.clamp(tstarts[r][-1] - cap, min=0)
                        for r in shards]

        gp = [tiled_pm.deposit_slab(position[r], tstarts[r], m, scheme,
                                    drift, zbs, r * planes, planes)
              for r in shards]
        density = [d * norm for d in add_spill(gp, planes, mesh, lead=drift)]
        del gp
        force, phi, u, pk = _solve_slab(cfg, density, phi, u, dyn, mesh,
                                        save_pk, first_call)
        del density
        f_ext = halo_lr(force, drift, w - 1 + drift, mesh, axis=1)
        del force
        acceleration = [
            tiled_pm.gather_vec_slab(f_ext[r].contiguous(), position[r],
                                     tstarts[r], scheme, drift, zbs,
                                     r * planes)
            for r in shards]
        del f_ext
        if last_kick:
            velocity = [v - a * last_kick
                        for v, a in zip(velocity, acceleration)]

        diag = StepDiagnostics(
            max_abs_acc=pmesh.pmax(
                [torch.max(torch.abs(a)) for a in acceleration], mesh)[0],
            max_abs_vel=pmesh.pmax(
                [torch.max(torch.abs(v)) for v in velocity], mesh)[0],
            mean_additional=pmesh.pmean(
                [torch.mean(x) for x in u], mesh)[0],
            overflow=pmesh.psum(
                [torch.as_tensor(o).to(torch.int64) for o in overflow],
                mesh)[0],
        )
        return position, velocity, acceleration, phi, u, tstarts, pk, diag

    return step


class SlabStepper:
    """The run loop's stepper for ``parallel_mode = slab`` (``main._loop``
    says what a stepper gives): grids and particles sharded in x over
    ``mesh``, the steps of :func:`make_slab_step` (every theory and solver,
    the tiled engine only), and the capacity re-balancing after sorted
    steps. ``state`` is the sharded state of ``ic_slab.generate_lpt_slab``;
    without it the host-built rows ``position`` and ``velocity`` are
    distributed by their base plane."""

    def __init__(self, param, cfg: SolverConfig, integrator: str,
                 mesh: Mesh, position, velocity, state=None):
        check_supported(cfg)
        n_dev = len(mesh)
        logging.warning("slab mode: %d devices, %d planes each",
                        n_dev, cfg.ncells_1d // n_dev)
        self.slack = float(param.get("slab_slack", 1.25))
        if state is None:
            state = distribute_particles(mesh, cfg, position, velocity,
                                         self.slack)
        # (position, velocity, acceleration, phi, u, tstarts), per shard
        self.state = list(state)
        self.param, self.cfg, self.mesh = param, cfg, mesh
        self.integrator = integrator
        self.steps = {}
        # lazy re-binning skips migration and the sort; a k-cell window
        # needs slabs of at least w - 1 + k planes
        self.max_drift = 0
        if param.get("lazy_sort", True):
            self.max_drift = min(
                int(cfg.lazy_drift),
                max(cfg.ncells_1d // n_dev - (_WIDTH[cfg.mass_scheme] - 1),
                    0))
        # Capacity re-balancing ahead of need: the slabs take on the
        # density contrast along x as structure forms. Rather than stepping
        # until a shard overflows (an abort), watch the fullest shard after
        # every sorted step and grow every shard's buffers before a particle
        # is at risk; growing appends sentinel columns on each device.
        self.headroom = float(param.get("slab_rebalance_headroom", 0.9))

    def first(self, save_pk: bool, dyn: DynScalars):
        # a zero-dt step (a kick by acc = 0 and no drift) is migrate ->
        # sort -> deposit -> solve -> gather
        pk, diag = self.step(save_pk, 0, dyn, 0.0, first_call=True)
        self.rebalance_if_needed()
        return pk, diag

    def step(self, save_pk: bool, presorted: int, dyn: DynScalars, dt,
             first_call: bool = False):
        key = (save_pk, first_call, presorted)
        if key not in self.steps:
            self.steps[key] = make_slab_step(
                self.cfg, self.mesh, self.integrator, save_pk=save_pk,
                first_call=first_call, presorted=presorted)
        *self.state, pk, diag = self.steps[key](*self.state, dyn, dt)
        return pk, diag

    def after_step(self, nsteps: int, presorted: int) -> None:
        if not presorted:
            # the shards' counts change by migration only: on sorted steps
            self.rebalance_if_needed()

    def rebalance_if_needed(self) -> None:
        """Grow every shard's capacity when the fullest shard holds more
        than ``slab_rebalance_headroom`` of it (0 or 1 and beyond: never)."""
        if not 0.0 < self.headroom < 1.0:
            return
        cfg, n_dev = self.cfg, len(self.mesh)
        cap = self.state[0][0].shape[1]
        max_count = max(int(t[-1]) for t in self.state[5])
        occ = max_count / cap
        if occ <= self.headroom:
            return
        slack_new = self.slack * 1.5
        # capacities come in whole column quanta: grow until one more fits
        while shard_capacity(cfg.npart, n_dev, slack_new) <= cap:
            slack_new *= 1.5
        logging.warning(
            "slab occupancy %.0f%% of capacity (max shard %d / %d): "
            "re-balancing with slack %.2f -> %.2f",
            100 * occ, max_count, cap, self.slack, slack_new,
        )
        self.slack = slack_new
        # a restart inherits the grown capacity
        self.param["slab_slack"] = self.slack
        self.state[:3] = grow_capacity(
            shard_capacity(cfg.npart, n_dev, self.slack), *self.state[:3])

    def rows(self):
        return gather_particles(*self.state[:2])

    def overflow_text(self, presorted: int) -> str:
        if presorted:
            return "slab lazy re-binning drift-bound violation"
        return "slab particle capacity overflow"


# ---------------------------------------------------------------------------
# State
# ---------------------------------------------------------------------------

def _base_plane_host(scheme: str, x: np.ndarray, m: int) -> np.ndarray:
    xs = x * np.float32(m)
    if scheme == "cic":
        return np.floor(xs - np.float32(0.5)).astype(np.int64) % m
    if scheme == "tsc":
        return (np.floor(xs).astype(np.int64) - 1) % m
    return np.floor(xs).astype(np.int64) % m


def slab_state_from_numpy(mesh: Mesh, position, velocity, acceleration, phi,
                          u, tstarts):
    """The JAX package's slab state, its global sharded arrays as NumPy,
    as this package's per-shard lists: columns (4, D C) cut into D column
    blocks, fields (M, M, M) into D slabs of planes (the (D, 1, 1) token of
    the Newtonian theories into D tokens), tile starts (D (ntiles + 1),)
    into D vectors; each on its shard's device."""
    def cut(a, axis, dtype=F32):
        a = torch.as_tensor(np.ascontiguousarray(np.asarray(a)))
        return pmesh.scatter(a.to(dtype), mesh, axis)

    return (cut(position, 1), cut(velocity, 1), cut(acceleration, 1),
            cut(phi, 0), cut(u, 0), cut(tstarts, 0, I32))


def slab_state_to_numpy(position, velocity, acceleration, phi, u, tstarts):
    """Inverse of :func:`slab_state_from_numpy`: the per-shard lists as the
    JAX package's global arrays, in NumPy."""
    def join(xs, axis):
        return pmesh.gather(xs, axis, "cpu").numpy()

    return (join(position, 1), join(velocity, 1), join(acceleration, 1),
            join(phi, 0), join(u, 0), join(tstarts, 0))


def distribute_particles(mesh: Mesh, cfg: SolverConfig, position, velocity,
                         slack: float = 1.25, zbs: int | None = None):
    """Host-side initial distribution: rows (npart, 3) -> the per-shard
    state lists (position, velocity, acceleration, phi, u, tstarts), each
    shard holding the particles whose base plane lies in its slab; the tile
    starts are zeros until the first sorted step fills them."""
    n_dev = len(mesh)
    m = cfg.ncells_1d
    planes = m // n_dev
    cap = shard_capacity(cfg.npart, n_dev, slack)
    position = np.asarray(position, np.float32)
    velocity = np.asarray(velocity, np.float32)
    shard_of = _base_plane_host(cfg.mass_scheme, position[:, 0], m) // planes
    pos_all = np.full((4, n_dev * cap), tiled_pm.SENTINEL, np.float32)
    vel_all = np.zeros((4, n_dev * cap), np.float32)
    pos_all[3] = 0.0
    for d in range(n_dev):
        sel = shard_of == d
        n_local = int(sel.sum())
        if n_local > cap:
            raise ValueError(
                f"shard {d} holds {n_local} particles > capacity {cap}; "
                "raise the slack factor (slab_slack)"
            )
        pos_all[:3, d * cap: d * cap + n_local] = position[sel].T
        vel_all[:3, d * cap: d * cap + n_local] = velocity[sel].T
    # f(R) keeps its scalaron and MOND its Newtonian potential; the
    # Newtonian theories a token
    u_shape = (m, m, m) if cfg.theory in ("fr", "mond") else (n_dev, 1, 1)
    nt_local = tiled_pm.n_tiles(m, zbs, planes) + 1
    return slab_state_from_numpy(
        mesh, pos_all, vel_all, np.zeros_like(pos_all),
        np.zeros((m, m, m), np.float32), np.zeros(u_shape, np.float32),
        np.zeros(n_dev * nt_local, np.int32))


def gather_particles(position: list, velocity=None):
    """Per-shard column state -> (n_real, 3) row arrays in NumPy, shard by
    shard (sentinels dropped)."""
    pos = pmesh.gather(position, 1, "cpu").numpy()
    real = pos[0] < tiled_pm.SENTINEL_MIN
    rows = np.ascontiguousarray(pos[:3, real].T)
    if velocity is None:
        return rows
    vel = pmesh.gather(velocity, 1, "cpu").numpy()
    return rows, np.ascontiguousarray(vel[:3, real].T)
