"""QUMOND, the reference module of ``mond_tsc_mg_512``: quasi-linear MOND
(Milgrom 2010) as PySCo runs it (Breton 2025), two Poisson
solves a force evaluation.

1. The Newtonian potential phi_N from 1.5 a Om_m (rho - 1).
2. The QUMOND source, the divergence of nu(|g|/g0) g with g = grad phi_N,
   taken over the six faces of each cell (Lueghausen et al. 2014): on the
   face between cells i and i + 1 along an axis, the normal component is
   (phi_N[i + 1] - phi_N[i]) / h and each tangential component is the
   mean of the two cells' centred differences over 2h; the source is the
   sum over the three axes of (F[i + 1/2] - F[i - 1/2]) / h, F the normal
   component times nu of the face's |g| / g0.
3. phi from that source, and the force, the 5-point gradient of phi.

nu is PySCo's "simple" family, nu(y) = 1/2 + sqrt(1/4 + 1/y), the only one
this module follows. g0 is ``mond_g0`` (in 1e-10 m/s^2) in box units at
a, by PySCo's convention: times 1e-13 (to km/s^2), times unit_t^2 /
unit_l of the supercomoving units at a, times a^(1 + exponent), with
``mond_scale_factor_exponent`` the exponent; the units come from this
module's own constants (``cosmology.PC_M``).

Departures from PySCo:
- both Poisson solves are the exact periodic solutions of the 7-point
  equation (``pm.poisson_7pt``): what PySCo's multigrid converges to and
  what its ``fft_7pt`` solver computes; PySCo's multigrid stops at epsrel
  times the truncation error instead;
- on a face where g is exactly 0 the flux is its limit, 0 (nu g grows as
  sqrt(g0 |g|)), where PySCo's 1/y is infinite and the flux not a number.

Deposit, gather, step, P(k) and the 2LPT start (PySCo starts MOND from
LCDM's) are ``pm``'s and ``ics``'s, with the configuration's mass scheme.
"""

from __future__ import annotations

import torch

from . import pm
from .cosmology import PC_M, Cosmology
from .pm import density, gather, power_spectrum, step  # noqa: F401
from .precision import F64, Precision

SOLVERS = ("multigrid", "fft_7pt")
NU = ("simple",)


def g0_box(param, aexp: float) -> float:
    """MOND's acceleration constant in box units at ``aexp``."""
    h0 = float(param["H0"]) / (1e3 * PC_M)  # 1/s
    unit_l = aexp * float(param["boxlen"]) * 100.0 / h0  # km
    unit_t = aexp ** 2 / h0  # s
    exponent = float(param["mond_scale_factor_exponent"])
    return (float(param["mond_g0"]) * 1e-13 * unit_t ** 2 / unit_l
            * aexp ** (1.0 + exponent))


def nu_flux(g_normal, g_norm, g0: float, prec: Precision = F64):
    """nu_simple(|g| / g0) times the normal component, per face: written
    as g_n (1/2 + sqrt(1/4 + g0 / |g|)), 0 where |g| is 0."""
    zero = g_norm == 0
    ratio = prec.q(g0 / torch.where(zero, 1.0, g_norm))
    nu = prec.q(0.5 + prec.q(torch.sqrt(prec.q(0.25 + ratio))))
    return torch.where(zero, 0.0, prec.q(nu * g_normal))


def qumond_source(phi: torch.Tensor, g0: float, prec: Precision = F64):
    """The QUMOND source div[nu(|grad phi| / g0) grad phi] of a periodic
    (n, n, n) potential, from each cell's six faces."""
    n = phi.shape[0]
    phi = prec.t(phi)

    def ahead(x, axis):  # x[i + 1] along axis
        return torch.roll(x, -1, axis)

    def behind(x, axis):  # x[i - 1]
        return torch.roll(x, 1, axis)

    centred = [prec.q((ahead(phi, t) - behind(phi, t)) * (0.5 * n))
               for t in range(3)]
    out = torch.zeros_like(phi)
    for a in range(3):
        # the face between i and i + 1 along a
        g = [None] * 3
        g[a] = prec.q((ahead(phi, a) - phi) * n)
        for t in range(3):
            if t != a:
                g[t] = prec.q(0.5 * (centred[t] + ahead(centred[t], a)))
        norm = prec.q(torch.sqrt(prec.q(g[0] * g[0] + g[1] * g[1]
                                        + g[2] * g[2])))
        flux = nu_flux(g[a], norm, g0, prec)
        del g, norm
        out = prec.q(out + prec.q((flux - behind(flux, a)) * n))
        del flux
    return out


class Forces(pm.Forces):
    """The force mesh of QUMOND with the simple nu: two exact 7-point
    Poisson solves around the face-centred source. Refuses, before any
    set-up, another theory, another nu family and a solver other than
    multigrid or fft_7pt."""

    theories = ("mond",)

    def __init__(self, param, prec: Precision = F64):
        self.param = param
        self.prec = prec
        self.cosmo = Cosmology(param)
        self.theory = str(param["theory"]).casefold()
        self.solver = str(param["linear_newton_solver"]).casefold()
        self.scheme = str(param["mass_scheme"]).casefold()
        if self.theory not in self.theories:
            raise NotImplementedError(f"{self.theory}: this module runs "
                                      "mond")
        if self.solver not in SOLVERS:
            raise NotImplementedError(f"mond/{self.solver}: this module runs "
                                      "the multigrid or fft_7pt solver")
        nu = str(param["mond_function"]).casefold()
        if nu not in NU:
            raise NotImplementedError(f"mond_function {nu!r}: this module "
                                      "runs the simple nu")
        if self.scheme not in pm.MAS_INDEX:
            raise NotImplementedError(f"mass scheme {self.scheme!r}")
        self.p = pm.MAS_INDEX[self.scheme]
        if int(param["gradient_stencil_order"]) != 5:
            raise NotImplementedError("the reference runs the 5-point "
                                      "gradient")

    def __call__(self, rho, aexp: float, u_start=None):
        """(force (3, n, n, n), phi_N): ``u_start``, the program's previous
        phi_N, is not needed by the exact solve."""
        prec = self.prec
        phi_n = pm.poisson_7pt(self.source(rho, aexp), prec)
        rhs = qumond_source(phi_n, g0_box(self.param, aexp), prec)
        phi = pm.poisson_7pt(rhs, prec)
        del rhs
        return pm.gradient(phi, prec), phi_n
