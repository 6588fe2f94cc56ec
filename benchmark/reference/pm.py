"""Particle-mesh step of PySCo, in plain torch: NGP, CIC and TSC deposit
and interpolation, the Poisson solves, the 5-point gradient, the
kick-drift and wrap, and the binned power spectrum.

Conventions (PySCo's): positions in box units [0, 1), cell centres at
(i + 1/2)/n; the density is the particle count per cell over its mean;
the Poisson source is 1.5 a Om_m (rho - 1); the "acceleration" is
+grad(phi) and the kick subtracts it. Particles are (3, N) arrays; sums
run over particles in chunks, so a 512^3 step fits beside the program's
outputs.
"""

from __future__ import annotations

import math

import torch

from . import fas
from .cosmology import Cosmology, fr_constants
from .ics import wavenumbers
from .precision import F64, Precision

CHUNK = 1 << 24


MAS_INDEX = {"ngp": 1, "cic": 2, "tsc": 3}


def _support(xs: torch.Tensor, n: int, scheme: str):
    """Per axis, the cells a particle of the (3, c) positions reaches and
    their weights, PySCo's: NGP the occupied cell floor(x n); CIC the cells
    floor(x n - 1/2) and the next, weights 1 - f and f; TSC the occupied
    cell and its two neighbours, weights 1/2 (1/2 - d)^2, 3/4 - d^2 and
    1/2 (1/2 + d)^2, d the offset from the occupied cell's centre."""
    if scheme == "cic":
        s = xs * n - 0.5
        base = torch.floor(s)
        f = s - base
        base = base.to(torch.int64) % n
        return (base, (base + 1) % n), (1.0 - f, f)
    mid = torch.floor(xs * n)
    if scheme == "ngp":
        return (mid.to(torch.int64) % n,), (torch.ones_like(xs),)
    if scheme != "tsc":
        raise NotImplementedError(f"mass scheme {scheme!r}")
    d = xs * n - 0.5 - mid
    mid = mid.to(torch.int64)
    return (((mid - 1) % n, mid % n, (mid + 1) % n),
            (0.5 * (0.5 - d) ** 2, 0.75 - d * d, 0.5 * (0.5 + d) ** 2))


def _each_corner(xs, n, prec, scheme):
    """(flat cell index, weight) of each cell of the scheme's support."""
    cells, weights = _support(xs, n, scheme)
    support = range(len(cells))
    for cx in support:
        for cy in support:
            for cz in support:
                flat = (cells[cx][0] * n + cells[cy][1]) * n + cells[cz][2]
                yield flat, prec.q(weights[cx][0] * weights[cy][1]
                                   * weights[cz][2])


def deposit(pos: torch.Tensor, n: int, weight=None,
            prec: Precision = F64, scheme: str = "cic") -> torch.Tensor:
    """Sum over particles of ``weight`` (1 when None) per cell, assigned by
    the mass scheme."""
    grid = torch.zeros(n ** 3, dtype=prec.real, device=pos.device)
    for c0 in range(0, pos.shape[1], CHUNK):
        xs = prec.t(pos[:3, c0:c0 + CHUNK])
        wp = None if weight is None else prec.t(weight[c0:c0 + CHUNK])
        for flat, w in _each_corner(xs, n, prec, scheme):
            grid.index_add_(0, flat, w if wp is None else prec.q(w * wp))
    return prec.q(grid.reshape(n, n, n))


def density(pos: torch.Tensor, n: int, npart: int,
            prec: Precision = F64, scheme: str = "cic") -> torch.Tensor:
    return prec.q(deposit(pos, n, None, prec, scheme) * (n ** 3 / npart))


def gather(fields: torch.Tensor, pos: torch.Tensor,
           prec: Precision = F64, scheme: str = "cic") -> torch.Tensor:
    """Interpolation of (C, n, n, n) fields at (3, N) positions by the mass
    scheme."""
    c, n = fields.shape[0], fields.shape[1]
    flat_f = fields.reshape(c, -1)
    out = torch.empty((c, pos.shape[1]), dtype=prec.real, device=pos.device)
    for c0 in range(0, pos.shape[1], CHUNK):
        acc = None
        for flat, w in _each_corner(prec.t(pos[:3, c0:c0 + CHUNK]), n, prec,
                                    scheme):
            term = prec.q(w * flat_f[:, flat])
            acc = term if acc is None else prec.q(acc + term)
        out[:, c0:c0 + CHUNK] = acc
    return out


def _sinc_window(n, device, prec):
    kx, ky, kz = wavenumbers(n, device, prec.real)
    return torch.sinc(kx / n) * torch.sinc(ky / n) * torch.sinc(kz / n)


def poisson_fft(rhs: torch.Tensor, p: int, prec: Precision = F64):
    """phi from Laplacian(phi) = rhs by the continuous inverse Laplacian
    with the mass assignment window deconvolved (Jing 2005), W^-2p."""
    n = rhs.shape[0]
    kx, ky, kz = wavenumbers(n, rhs.device, prec.real)
    k2 = kx * kx + ky * ky + kz * kz
    k2[0, 0, 0] = 1.0
    kern = _sinc_window(n, rhs.device, prec) ** (-2 * p) * (
        -0.25 / math.pi ** 2) / k2
    phik = prec.q(torch.fft.rfftn(rhs) * kern)
    phik[0, 0, 0] = 0
    return prec.q(torch.fft.irfftn(phik, s=(n, n, n)))


def poisson_7pt(rhs: torch.Tensor, prec: Precision = F64):
    """The exact periodic solution of the 7-point discrete Poisson
    equation (what multigrid converges to), zero mean."""
    n = rhs.shape[0]
    kx, ky, kz = wavenumbers(n, rhs.device, prec.real)
    s = (torch.sin(math.pi * kx / n) ** 2 + torch.sin(math.pi * ky / n) ** 2
         + torch.sin(math.pi * kz / n) ** 2)
    s[0, 0, 0] = 1.0
    phik = prec.q(torch.fft.rfftn(rhs) * (-0.25 / (n * n) / s))
    phik[0, 0, 0] = 0
    return prec.q(torch.fft.irfftn(phik, s=(n, n, n)))


def gradient(phi: torch.Tensor, prec: Precision = F64) -> torch.Tensor:
    """Fourth-order central differences: (3, n, n, n)."""
    n = phi.shape[0]
    out = []
    for ax in range(3):
        def r(s):
            return torch.roll(phi, -s, ax)  # r(s)[i] = phi[i + s]
        out.append(prec.q(n / 12.0 * (8.0 * (r(1) - r(-1)) + r(-2) - r(2))))
    return torch.stack(out)


def power_spectrum(dens: torch.Tensor, p: int, prec: Precision = F64):
    """Binned |delta_k|^2 of a density grid, W^-p deconvolved: bins of
    round(|k|) from 1 to below 2/3 of the Nyquist index, each mode of the
    half grid counted once. Returns (k, Pk, Nmodes) in grid units, float64
    (the power and each bin's mean rounded to ``prec``)."""
    n = dens.shape[0]
    dk = prec.q(torch.fft.rfftn(dens.to(prec.real)))
    if p:
        dk = dk * _sinc_window(n, dens.device, prec) ** (-p)
    power = prec.q(dk.real ** 2 + dk.imag ** 2).reshape(-1).double()
    kx, ky, kz = wavenumbers(n, dens.device)
    kmag = torch.sqrt(kx * kx + ky * ky + kz * kz).reshape(-1)
    idx = torch.floor(kmag + 0.5).to(torch.int64)
    kmax = int(2 * (n // 2) / 3)
    sel = (idx >= 1) & (idx < kmax)
    b = idx[sel] - 1
    nm = torch.bincount(b, minlength=kmax - 1).to(torch.float64)
    ks = torch.bincount(b, weights=kmag[sel], minlength=kmax - 1)
    ps = torch.bincount(b, weights=power[sel], minlength=kmax - 1)
    return ks / nm, prec.q(ps / nm).double(), nm


class Forces:
    """The force mesh of a configuration from a density grid.

    ``theories`` are those this class accepts; a configuration's own
    reference module subclasses it for another theory and may replace
    ``source``, the right-hand side of the Poisson equation."""

    theories = ("newton", "fr")

    def __init__(self, param, prec: Precision = F64):
        self.param = param
        self.prec = prec
        self.cosmo = Cosmology(param)
        self.theory = str(param["theory"]).casefold()
        self.solver = str(param["linear_newton_solver"]).casefold()
        self.scheme = str(param["mass_scheme"]).casefold()
        if self.scheme not in MAS_INDEX:
            raise NotImplementedError(f"mass scheme {self.scheme!r}")
        self.p = MAS_INDEX[self.scheme]
        if int(param["gradient_stencil_order"]) != 5:
            raise NotImplementedError("the reference runs the 5-point "
                                      "gradient")
        if self.theory not in self.theories or self.solver not in (
                "fft", "multigrid"):
            raise NotImplementedError(f"{self.theory}/{self.solver}")
        if self.theory == "fr" and int(param["fR_n"]) != 1:
            raise NotImplementedError("the reference runs f(R) n = 1")

    def source(self, rho, aexp: float):
        """1.5 a Om_m (rho - 1)."""
        return self.prec.q(1.5 * aexp * self.cosmo.Om * (rho - 1.0))

    def __call__(self, rho, aexp: float, u_start=None):
        """(force (3, n, n, n), u): u is the f(R) scalaron solved from
        ``u_start`` (None: the zero-neighbour root)."""
        prec = self.prec
        rhs = self.source(rho, aexp)
        if self.solver == "fft":
            phi = poisson_fft(rhs, self.p, prec)
        else:
            phi = poisson_7pt(rhs, prec)
        del rhs
        if self.theory != "fr":
            return gradient(phi, prec), None
        c = fr_constants(self.cosmo, self.param, aexp)
        b = prec.q(c["f1"] * rho + c["f2"])
        u = fas.solve(b, c["q"], u_start, int(self.param["ncoarse"]),
                      int(self.param["Npre"]), int(self.param["Npost"]),
                      float(self.param["epsrel"]), prec)
        return gradient(prec.q(phi + c["half_c2"] * u * u), prec), u


def kick_drift(pos, vel, acc, dt: float, prec: Precision = F64):
    """Leapfrog's first half kick, the drift and the periodic wrap."""
    vel = prec.q(prec.t(vel) - prec.t(acc) * (0.5 * dt))
    pos = prec.q(torch.remainder(prec.t(pos) + vel * dt, 1.0))
    return pos, vel


def step(param, forces: Forces, pos, vel, acc, u, dt: float, aexp: float):
    """One leapfrog step of (3, N) particles: (pos, vel, acc, rho, u) after
    it. ``u`` is the scalaron the solve starts from (f(R))."""
    prec = forces.prec
    n = 2 ** int(param["ncoarse"])
    pos, vel = kick_drift(pos, vel, acc, dt, prec)
    rho = density(pos, n, int(param["npart"]), prec, forces.scheme)
    force, u = forces(rho, aexp, u)
    acc = gather(force, pos, prec, forces.scheme)
    del force
    vel = prec.q(vel - acc * (0.5 * dt))
    return pos, vel, acc, rho, u
