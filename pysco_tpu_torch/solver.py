"""Particle-mesh force solver (PyTorch port of ``pysco_tpu/solver.py``).

One force evaluation: tile sort (or a stale-bin step), deposit, the
theory's extra field and Poisson source, the Poisson solve (in Fourier
space or by multigrid), gradient stencil, gather. The JAX package traces
it into one XLA program; here it runs eagerly on the device of the
particle tensors. Per-step scalars (aexp, the parametrized mu(z), the
tolerance factor, the f(R) background constants, MOND's g0 in box
units, the growth rescaling of the previous potential) are computed on
the host in float64 and enter the device arithmetic as float32 values.

Conventions identical to the JAX package and the reference:
- density grids hold particle counts normalised to mean 1;
- the Poisson rhs is 1.5 * aexp * Om_m * mu(z) * (delta - 1); MOND's is
  the QUMOND source of the Newtonian potential;
- the "acceleration" is +grad(phi); the kick subtracts it.

Theories: newton, parametrized, fr (Hu-Sawicki n = 1 or 2: the scalaron
by FAS multigrid) and mond; solvers: fft, fft_7pt, full_fft and
multigrid (V, F or W cycles).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from .models import cubic, laplacian, mond, multigrid, quartic
from .ops import dense_pm, fourier, mesh, tiled_pm
from .utils import profiling
from .utils.units import C_KMS

F32 = torch.float32

_THEORIES = ("newton", "parametrized", "fr", "mond")
_SOLVERS = ("fft", "fft_7pt", "full_fft", "multigrid")
_FR_ROOT_SOLVERS = ("newton", "exact")
# accepted for parity with the JAX package's configs; they select TPU
# matrix-unit passes there, and this port computes in float32 throughout
_PM_PRECISIONS = ("f32", "bf16", "bf16x3", "bf16-gather")


@dataclass(frozen=True)
class SolverConfig:
    """Static solver configuration (``pysco_tpu.solver.SolverConfig``)."""

    theory: str
    ncoarse: int
    npart: int
    mass_scheme: str
    linear_newton_solver: str
    gradient_stencil_order: int
    Npre: int = 2
    Npost: int = 1
    # f(R) Hu-Sawicki index: 1 (cubic scalaron equation) or 2 (quartic)
    fR_n: int = 1
    # "newton": three float32 Newton steps from the current value per
    # scalaron cell update (the sweep kernel on the card); "exact": the
    # float64 closed-form roots, in plain torch
    fR_root_solver: str = "newton"
    # multigrid cycle type for the linear and FAS solves: V, F or W
    multigrid_cycle: str = "V"
    mond_function: str = "simple"
    mond_alpha: float = 1.0
    # "pallas": tile-sorted column state through ops/tiled_pm.py (the
    # CUDA kernels on the card); "dense": row particles sorted by x-plane
    # through the one-hot matrix products of ops/dense_pm.py; "scatter":
    # row particles through the index_add deposit of ops/mesh.py
    particle_engine: str = "pallas"
    # the tiled engine's sort (tiled_pm.sort_particles): "full", "index",
    # "nearly" or "nearly_index"; every mode gives the same sorted state
    sort_mode: str = "full"
    pm_precision: str = "bf16x3"
    pm_precision_widened: str = "bf16-gather"
    # largest lazy re-binning window (cells) before the run loop re-sorts
    lazy_drift: int = 3

    @property
    def ncells_1d(self) -> int:
        return 2 ** self.ncoarse

    @property
    def mas_index(self) -> int:
        return {"ngp": 1, "cic": 2, "tsc": 3}[self.mass_scheme]


def config_from_param(param) -> SolverConfig:
    get = param.get if hasattr(param, "get") else param.__getitem__
    cfg = SolverConfig(
        theory=str(param["theory"]).casefold(),
        ncoarse=int(param["ncoarse"]),
        npart=int(param["npart"]),
        mass_scheme=str(param["mass_scheme"]).casefold(),
        linear_newton_solver=str(param["linear_newton_solver"]).casefold(),
        gradient_stencil_order=int(param["gradient_stencil_order"]),
        Npre=int(get("Npre", 2)),
        Npost=int(get("Npost", 1)),
        fR_n=int(get("fR_n", 1)),
        fR_root_solver=str(get("fR_root_solver", "newton")).casefold(),
        multigrid_cycle=str(get("multigrid_cycle", "V")).upper(),
        mond_function=str(get("mond_function", "simple")).casefold(),
        mond_alpha=float(get("mond_alpha", 1.0)),
        particle_engine=str(get("particle_engine", "pallas")).casefold(),
        sort_mode=str(get("sort_mode", "full")).casefold(),
        pm_precision=str(get("pm_precision", "bf16x3")).casefold(),
        pm_precision_widened=str(
            get("pm_precision_widened", "bf16-gather")).casefold(),
        lazy_drift=int(get("lazy_drift", 3)),
    )
    if cfg.theory not in _THEORIES:
        raise NotImplementedError(
            f"theory {cfg.theory!r}, should be newton, parametrized, mond "
            "or fr"
        )
    if cfg.linear_newton_solver not in _SOLVERS:
        raise NotImplementedError(
            f"linear_newton_solver {cfg.linear_newton_solver!r}, should be "
            "multigrid, fft, fft_7pt or full_fft"
        )
    if cfg.theory == "mond" and cfg.linear_newton_solver not in (
            "multigrid", "fft_7pt"):
        raise NotImplementedError(
            "MOND additional field requires multigrid or fft_7pt "
            f"(got {cfg.linear_newton_solver!r})"
        )
    if cfg.theory == "fr" and cfg.fR_n not in (1, 2):
        raise NotImplementedError(
            f"fR_n={cfg.fR_n}: f(R) Hu-Sawicki runs fR_n = 1 or 2")
    if cfg.fR_root_solver not in _FR_ROOT_SOLVERS:
        raise ValueError(f"fR_root_solver={cfg.fR_root_solver!r}, should be "
                         "newton or exact")
    if cfg.multigrid_cycle not in ("V", "F", "W"):
        raise ValueError(f"multigrid_cycle={cfg.multigrid_cycle!r}, should "
                         "be V, F or W")
    if cfg.mass_scheme not in ("ngp", "cic", "tsc"):
        raise NotImplementedError(
            f"mass scheme {cfg.mass_scheme!r}, should be NGP, CIC or TSC"
        )
    if cfg.particle_engine not in ("pallas", "dense", "scatter"):
        raise NotImplementedError(
            f"particle_engine={cfg.particle_engine!r}, should be 'pallas' "
            "(tiled kernels), 'dense' or 'scatter'"
        )
    if cfg.sort_mode not in tiled_pm.SORT_MODES:
        raise ValueError(f"sort_mode={cfg.sort_mode!r}, should be one of "
                         f"{tiled_pm.SORT_MODES}")
    for key in ("pm_precision", "pm_precision_widened"):
        if getattr(cfg, key) not in _PM_PRECISIONS:
            raise ValueError(f"{key}={getattr(cfg, key)!r}: expected one of "
                             f"{_PM_PRECISIONS}")
    return cfg


class DynScalars(NamedTuple):
    """Per-step scalars, float32-rounded host floats."""

    aexp: float
    om_m: float
    mu_z: float  # parametrized mu(z); 1 otherwise
    epsrel: float
    fR_f1: float  # f(R): scalaron source f1 density + f2
    fR_f2: float
    fR_q: float  # f(R): the scalaron equation's constant term
    fR_half_c2: float  # f(R): the fifth-force factor
    mond_g0: float
    potential_scaling: float


def _f32(x) -> float:
    return float(np.float32(x))


def compute_dynamics(param) -> DynScalars:
    """Host-side (float64) per-step scalars, as in
    ``pysco_tpu.solver.compute_dynamics``: parametrized mu(z), the f(R)
    background constants, MOND's g0 converted to box units and scaled by
    aexp, and the growth rescaling of the previous potential
    (``potential_scaling``, set by the run loop)."""
    aexp = float(param["aexp"])
    om_m = float(param["Om_m"])
    theory = str(param["theory"]).casefold()
    mu_z = 1.0
    if theory == "parametrized":
        w0, wa = float(param["w0"]), float(param["wa"])
        om_lambda = float(param["Om_lambda"])
        om_r = float(param["Om_r"])
        evolution_term = aexp ** (-3 * (1 + w0 + wa)) * math.exp(
            -3 * wa * (1 - aexp)
        )
        omega_lambda_z = (
            om_lambda * evolution_term
            / (om_m * aexp ** -3 + om_r * aexp ** -4
               + om_lambda * evolution_term)
        )
        mu_z = 1.0 + float(param["parametrized_mu0"]) * omega_lambda_z / om_lambda
    fR_f1 = fR_f2 = fR_q = fR_half_c2 = 0.0
    if theory == "fr":
        om_lambda = float(param["Om_lambda"])
        Rbar = 3 * om_m * aexp ** -3 + 12 * om_lambda
        Rbar0 = 3 * om_m + 12 * om_lambda
        fR_a = (
            -(aexp ** 2)
            * (Rbar0 / Rbar) ** (int(param["fR_n"]) + 1)
            * 10.0 ** (-float(param["fR_logfR0"]))
        )
        c2 = (C_KMS * param["unit_t"] / (param["unit_l"] * aexp)) ** 2
        fR_f1 = (aexp * om_m / (c2 * 6)) / (-fR_a)
        fR_f2 = (Rbar / 3 * aexp ** 4 - om_m * aexp) / (6 * c2) / (-fR_a)
        fR_q = (-(aexp ** 4) * Rbar / (18 * c2)) / (-fR_a)
        fR_half_c2 = 0.5 * (-fR_a) * c2
    mond_g0 = 0.0
    if theory == "mond":
        mond_g0 = (
            float(param["mond_g0"]) * 1e-3 * 1e-10
            * param["unit_t"] ** 2 / param["unit_l"]
            * aexp ** (1 + float(param["mond_scale_factor_exponent"]))
        )
    get = param.get if hasattr(param, "get") else param.__getitem__
    return DynScalars(
        aexp=_f32(aexp), om_m=_f32(om_m), mu_z=_f32(mu_z),
        epsrel=_f32(get("epsrel", 1e-2)), fR_f1=_f32(fR_f1),
        fR_f2=_f32(fR_f2), fR_q=_f32(fR_q), fR_half_c2=_f32(fR_half_c2),
        mond_g0=_f32(mond_g0),
        potential_scaling=_f32(get("potential_scaling", 1.0)),
    )


# ---------------------------------------------------------------------------
# Field solve
# ---------------------------------------------------------------------------

def _multigrid_solve(cfg: SolverConfig, rhs, x, dyn: DynScalars):
    """Linear multigrid solve of L(x) = rhs from the first guess x, to
    epsrel times the truncation error of x (recomputed on every solve)."""
    tolerance = np.float32(dyn.epsrel) * np.float32(
        float(laplacian.truncation_error(x)))
    profiling.count("host_syncs")
    return multigrid.linear(x, rhs, cfg.ncoarse, cfg.Npre, cfg.Npost,
                            tolerance, cfg.multigrid_cycle)


def _linear_solve(cfg: SolverConfig, rhs: torch.Tensor, potential,
                  dyn: DynScalars, first_call: bool) -> torch.Tensor:
    """Potential from the Poisson rhs: multigrid from the previous
    potential (rescaled by the linear growth since its step; a Jacobi
    first guess on the first call), the Jing-compensated continuous
    inverse Laplacian (``fft``) or the exact discrete 7-point one
    (``fft_7pt``)."""
    if cfg.linear_newton_solver == "multigrid":
        if first_call:
            potential = laplacian.initialise_potential(rhs)
        else:
            potential = potential * dyn.potential_scaling
        return _multigrid_solve(cfg, rhs, potential, dyn)
    rhs_k = fourier.rfft3(rhs)
    if cfg.linear_newton_solver == "fft_7pt":
        rhs_k = fourier.inverse_laplacian_7pt(rhs_k)
    else:
        rhs_k = fourier.inverse_laplacian_compensated(rhs_k, cfg.mas_index)
    return fourier.irfft3(rhs_k)


def _fft_force(cfg: SolverConfig, rhs: torch.Tensor) -> torch.Tensor:
    """full_fft path: solve and differentiate in k-space."""
    force_k = fourier.gradient_inverse_laplacian_compensated(
        fourier.rfft3(rhs), cfg.mas_index
    )
    return fourier.irfft3_vec(force_k)


def _newton_rhs(density, dyn: DynScalars):
    """1.5 aexp Om_m mu(z) (density - 1), the scalar factor formed in
    float32 first."""
    f1 = _f32(np.float32(1.5) * np.float32(dyn.aexp) * np.float32(dyn.om_m)
              * np.float32(dyn.mu_z))
    return f1 * (density - 1.0)


def _scalaron(cfg: SolverConfig, density, u, dyn: DynScalars,
              first_call: bool):
    """The f(R) scalaron u: an FAS solve of the cubic (n = 1) or quartic
    (n = 2) equation with source f1 density + f2, from the previous u
    (not rescaled between steps) or, on the first call, the
    zero-neighbour root; to epsrel times the truncation error of the
    starting u."""
    dens_term = dyn.fR_f1 * density + dyn.fR_f2
    exact_root = cfg.fR_root_solver == "exact"
    if cfg.fR_n == 1:
        ops = multigrid.fas_ops_cubic(dyn.fR_q, exact_root)
        init = cubic.initialise_potential
    else:
        ops = multigrid.fas_ops_quartic(dyn.fR_q, exact_root)
        init = quartic.initialise_potential
    if first_call:
        u = init(dens_term, dyn.fR_q)
    tolerance = np.float32(dyn.epsrel) * np.float32(
        float(ops.truncation_error(u, dens_term)))
    profiling.count("host_syncs")
    return multigrid.FAS(u, dens_term, ops, cfg.ncoarse, cfg.Npre,
                         cfg.Npost, tolerance, cfg.multigrid_cycle)


def _additional_field(cfg: SolverConfig, density, u, dyn: DynScalars,
                      first_call: bool):
    """The extra field of a modified theory: the f(R) scalaron; for MOND,
    the Newtonian potential (multigrid from the previous u, or the exact
    7-point FFT solve)."""
    if cfg.theory == "fr":
        return _scalaron(cfg, density, u, dyn, first_call)
    if cfg.theory != "mond":
        return u
    rhs_newton = _newton_rhs(density, dyn)
    if cfg.linear_newton_solver == "multigrid":
        if first_call:
            u = laplacian.initialise_potential(rhs_newton)
        return _multigrid_solve(cfg, rhs_newton, u, dyn)
    return fourier.irfft3(
        fourier.inverse_laplacian_7pt(fourier.rfft3(rhs_newton)))


def _solve_fields(cfg: SolverConfig, first_call: bool, save_pk: bool,
                  density, potential, u, dyn: DynScalars,
                  leading: bool = False):
    """Force mesh from the normalised density grid; returns
    (force, potential, u, pk). ``leading=True`` lays the force out
    component-leading, (3, M, M, M), as the tiled gather reads it."""
    pk = None
    if save_pk:
        with profiling.span("pm.power_spectrum"):
            pk = fourier.power_spectrum(fourier.rfft3(density),
                                        cfg.mas_index)
    full_fft = cfg.linear_newton_solver == "full_fft"
    with profiling.span("pm.solve"):
        u = _additional_field(cfg, density, u, dyn, first_call)
        if cfg.theory == "mond":
            rhs = mond.rhs(u, dyn.mond_g0, cfg.mond_function,
                           cfg.mond_alpha)
        else:
            rhs = _newton_rhs(density, dyn)
        del density
        if full_fft:
            force = _fft_force(cfg, rhs)
            if leading:
                force = force.movedim(-1, 0).contiguous()
        else:
            potential = _linear_solve(cfg, rhs, potential, dyn, first_call)
    order = cfg.gradient_stencil_order
    with profiling.span("pm.gradient"):
        if full_fft:
            if cfg.theory == "fr":
                force = force + mesh.derivative_fR(
                    torch.zeros_like(rhs), u, dyn.fR_half_c2, cfg.fR_n,
                    order, leading)
        elif cfg.theory == "fr":
            force = mesh.derivative_fR(potential, u, dyn.fR_half_c2,
                                       cfg.fR_n, order, leading)
        else:
            force = mesh.derivative(potential, order, leading)
    return force, potential, u, pk


def _normalise(cfg: SolverConfig, density: torch.Tensor) -> torch.Tensor:
    n = cfg.ncells_1d
    if n ** 3 != cfg.npart:
        density = density * _f32(n ** 3 / cfg.npart)
    return density


def pm(cfg: SolverConfig, first_call: bool, save_pk: bool, position,
       velocity, potential, u, dyn: DynScalars):
    """Full PM force evaluation with a fresh sort (``pysco_tpu.solver.pm``
    and its body ``_pm_impl``). ``first_call`` starts the multigrid solves
    from a Jacobi guess instead of the previous fields.

    Returns (position, velocity, acceleration, potential, u, pk, overflow).
    The tiled engine takes the particles in (4, N_up) column layout
    (``tiled_pm.to_columns`` or :func:`state_from_arrays` make it from
    rows) and returns them tile-sorted, velocity riding along (None is
    zero velocity). The dense engine takes (npart, 3) rows and returns
    them sorted by x-plane, ``overflow`` its count of particles past a
    plane's capacity. The scatter engine keeps (npart, 3) rows in their
    order. A fresh tile sort puts every particle in its window, so the
    other two engines' ``overflow`` is 0.
    """
    n = cfg.ncells_1d
    scheme = cfg.mass_scheme
    if velocity is None:
        velocity = torch.zeros_like(position)
    overflow = 0
    if cfg.particle_engine == "pallas":
        with profiling.span("pm.sort"):
            position, velocity, tstarts = tiled_pm.sort_particles(
                position, velocity, n, scheme, mode=cfg.sort_mode)
        with profiling.span("pm.deposit"):
            density = _normalise(cfg, tiled_pm.deposit(position, tstarts, n,
                                                       scheme))
        force, potential, u, pk = _solve_fields(
            cfg, first_call, save_pk, density, potential, u, dyn,
            leading=True)
        with profiling.span("pm.gather"):
            acceleration = tiled_pm.gather_vec_cl(force, position, tstarts,
                                                  scheme)
    elif cfg.particle_engine == "dense":
        with profiling.span("pm.sort"):
            position, velocity, starts = dense_pm.sort_by_plane(
                position, n, scheme, velocity)
        with profiling.span("pm.deposit"):
            density, overflow = dense_pm.deposit(position, starts, n, scheme)
            density = _normalise(cfg, density)
        force, potential, u, pk = _solve_fields(
            cfg, first_call, save_pk, density, potential, u, dyn)
        with profiling.span("pm.gather"):
            acceleration = dense_pm.gather_vec(force, position, starts,
                                               scheme)
    else:
        with profiling.span("pm.deposit"):
            density = _normalise(cfg, mesh.deposit(position, n, scheme))
        force, potential, u, pk = _solve_fields(
            cfg, first_call, save_pk, density, potential, u, dyn)
        with profiling.span("pm.gather"):
            acceleration = mesh.gather_vec(force, position, scheme)
    return position, velocity, acceleration, potential, u, pk, overflow


def _pm_lazy_impl(cfg: SolverConfig, presorted: int, save_pk: bool,
                  position, velocity, tstarts, potential, u,
                  dyn: DynScalars):
    """Tiled-engine force evaluation with CFL-bounded lazy re-binning.

    ``presorted = k >= 1`` skips the sort and runs k-cell drift-widened
    windows over the stale tiles, exact while every particle moved less
    than k cells since the sort (the run loop bounds that on the host);
    ``overflow`` counts the particles that broke the bound.
    ``presorted = 0`` re-sorts. Never a first call: the multigrid solves
    start from the previous fields. Returns (position, velocity, tstarts,
    acceleration, potential, u, pk, overflow).
    """
    n = cfg.ncells_1d
    scheme = cfg.mass_scheme
    if presorted:
        drift = int(presorted)
        with profiling.span("pm.drift_check"):
            overflow = tiled_pm.drift_violations(position, tstarts, n,
                                                 scheme, drift)
    else:
        with profiling.span("pm.sort"):
            position, velocity, tstarts = tiled_pm.sort_particles(
                position, velocity, n, scheme, mode=cfg.sort_mode)
        drift = 0
        overflow = 0
    with profiling.span("pm.deposit"):
        density = _normalise(cfg, tiled_pm.deposit(position, tstarts, n,
                                                   scheme, drift))
    force, potential, u, pk = _solve_fields(cfg, False, save_pk, density,
                                            potential, u, dyn, leading=True)
    with profiling.span("pm.gather"):
        acceleration = tiled_pm.gather_vec_cl(force, position, tstarts,
                                              scheme, drift)
    return (position, velocity, tstarts, acceleration, potential, u, pk,
            overflow)


def force_3d(rhs, param) -> torch.Tensor:
    """Library utility: solve the Poisson equation for a given rhs grid
    and return the force mesh (N, N, N, 3), with no mass-assignment
    compensation (``pysco_tpu.solver.force_3d``): multigrid (V cycles
    from a Jacobi guess), fft, fft_7pt or full_fft."""
    cfg = dataclasses.replace(config_from_param(param), mass_scheme="ngp")
    rhs = torch.as_tensor(rhs).to(F32)
    solver = cfg.linear_newton_solver
    dyn = compute_dynamics(param)
    if solver == "multigrid":
        potential = _multigrid_solve(
            dataclasses.replace(cfg, multigrid_cycle="V"), rhs,
            laplacian.initialise_potential(rhs), dyn)
    elif solver == "full_fft":
        return fourier.irfft3_vec(
            fourier.gradient_inverse_laplacian(fourier.rfft3(rhs)))
    else:
        rhs_k = fourier.rfft3(rhs)
        if solver == "fft_7pt":
            rhs_k = fourier.inverse_laplacian_7pt(rhs_k)
        else:
            rhs_k = fourier.inverse_laplacian(rhs_k)
        potential = fourier.irfft3(rhs_k)
    return mesh.derivative(potential, cfg.gradient_stencil_order)


# ---------------------------------------------------------------------------
# State
# ---------------------------------------------------------------------------

def particles_to_rows(cfg: SolverConfig, *arrays):
    """Engine-layout particle tensors -> (npart, 3) row-major NumPy arrays
    (for snapshots and analysis)."""
    n_up = tiled_pm.padded_cols(cfg.npart)
    out = []
    for a in arrays:
        # column layout is exactly (3|4, padded_cols(npart)); matching on
        # shape[0] alone would mistake (npart, 3) rows when npart is 3 or 4
        is_cols = a.ndim == 2 and a.shape[0] in (3, 4) and a.shape[1] == n_up
        a = a[:3, : cfg.npart].T if is_cols else a[: cfg.npart]
        out.append(np.ascontiguousarray(a.cpu().numpy()))
    return tuple(out)


def empty_fields(cfg: SolverConfig, device):
    """Potential and additional-field grids before the first call; the
    Newtonian theories have no additional field, so their ``u`` is a
    token; f(R)'s is the scalaron and MOND's the Newtonian potential,
    full grids."""
    n = cfg.ncells_1d
    u_shape = (1, 1, 1) if cfg.theory in ("newton", "parametrized") else (
        n, n, n)
    return (torch.zeros((n, n, n), dtype=F32, device=device),
            torch.zeros(u_shape, dtype=F32, device=device))


def state_from_arrays(cfg: SolverConfig, position, velocity, tstarts,
                      potential, u, device):
    """The JAX package's state (NumPy arrays) as this package's tensors.

    ``position``/``velocity`` are (4, N_up) columns or (npart, 3) rows
    (rows become columns for the tiled engine); ``tstarts`` may be None
    (a sort comes first); ``potential`` and ``u`` are the JAX package's
    fields (the f(R) scalaron and MOND's Newtonian potential full grids,
    the Newtonian theories' a (1, 1, 1) token). Returns (position,
    velocity, tstarts, potential, u).
    """
    position = np.asarray(position, np.float32)
    velocity = np.asarray(velocity, np.float32)
    if cfg.particle_engine == "pallas" and position.shape[0] != 4:
        position, velocity = tiled_pm.to_columns_host(position, velocity,
                                                      cfg.npart)
    if tstarts is None:
        tstarts = np.zeros(tiled_pm.n_tiles(cfg.ncells_1d) + 1, np.int32)

    def t(a, dtype=F32):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device=device,
                                                           dtype=dtype)

    return (t(position), t(velocity), t(tstarts, torch.int32),
            t(potential), t(u))
