"""Background cosmology, linear growth and the f(R) constants, in float64.

A flat w0waCDM background with photons (from T_cmb) and N_eff massless
neutrinos, the first- and second-order growth factors from their ODEs
(Rampf & Bucher matter-era start at a = 1e-8), the supercomoving box units
and the Hu-Sawicki f(R) constants of PySCo (Breton 2025). Plain NumPy and
SciPy: nothing here is taken from the program under test.
"""

from __future__ import annotations

import math

import numpy as np
from scipy.integrate import solve_ivp

# SI constants (CODATA and IAU values, as astropy has them)
PC_M = 3.0856775814913673e16
G_SI = 6.6743e-11
C_SI = 299792458.0
C_KMS = 299792.458
SIGMA_SB = 5.670374419e-8


class Cosmology:
    """Flat w0waCDM with radiation: densities, E(a), growth D1 and D2."""

    def __init__(self, param):
        self.H0 = float(param["H0"])
        self.Om = float(param["Om_m"])
        self.w0 = float(param["w0"])
        self.wa = float(param["wa"])
        h0_s = self.H0 * 1e3 / (1e6 * PC_M)
        rho_crit = 3.0 * h0_s ** 2 / (8.0 * math.pi * G_SI)
        t_cmb = float(param["T_cmb"])
        rho_gamma = 4.0 * SIGMA_SB / C_SI * t_cmb ** 4 / C_SI ** 2
        self.Og = rho_gamma / rho_crit
        self.Onu = (float(param["N_eff"]) * 0.875 * (4.0 / 11.0) ** (4.0 / 3.0)
                    * self.Og)
        self.Or = self.Og + self.Onu
        self.Ode = 1.0 - self.Om - self.Or
        self._growth = None

    def de_scale(self, a):
        return a ** (-3.0 * (1.0 + self.w0 + self.wa)) * np.exp(
            -3.0 * self.wa * (1.0 - a))

    def E(self, a):
        return np.sqrt(self.Om * a ** -3 + self.Or * a ** -4
                       + self.Ode * self.de_scale(a))

    def mu(self, a):
        """G_eff / G in the growth of structure: 1 in general relativity; a
        configuration's reference module may replace it."""
        return 1.0

    def _solve_growth(self):
        """D1, dD1/dlna, D2, dD2/dlna on a dense ln a solution."""
        a_eq = self.Or / self.Om if self.Or else 2e-7
        d1 = 0.6 * a_eq

        def rhs(lna, y):
            a = math.exp(lna)
            e2 = self.E(a) ** 2
            om = self.Om * a ** -3 / e2
            orad = self.Or * a ** -4 / e2
            ode = self.Ode * self.de_scale(a) / e2
            beta = 1.5 * om * self.mu(a)
            gamma = 0.5 * (1.0 - 3.0 * ode * (self.w0 + self.wa * (1.0 - a))
                           - orad)
            D1, dD1, D2, dD2 = y
            return [dD1, -gamma * dD1 + beta * D1,
                    dD2, -gamma * dD2 + beta * (D2 - D1 * D1)]

        sol = solve_ivp(rhs, (math.log(1e-8), 0.0),
                        [d1, 0.0, -3.0 / 7.0 * d1 * d1, 0.0], method="DOP853",
                        rtol=1e-12, atol=1e-14, dense_output=True)
        self._growth = sol.sol

    def growth(self, a):
        """(D1, f1, D2, f2) at scale factor a, D1 and D2 unnormalised."""
        if self._growth is None:
            self._solve_growth()
        D1, dD1, D2, dD2 = self._growth(math.log(a))
        return D1, dD1 / D1, D2, dD2 / D2

    def lpt_coefficients(self, a):
        """Displacement and velocity factors of 1LPT and 2LPT in box units:
        x = q - D1 psi1 + D2 psi2 and v = -D1 f1 H psi1 + D2 f2 H psi2, D1
        normalised to 1 today and D2 by its square, H = a^2 E(a)."""
        D1_0 = self.growth(1.0)[0]
        D1, f1, D2, f2 = self.growth(a)
        H = a * a * self.E(a)
        d1 = D1 / D1_0
        d2 = D2 / D1_0 ** 2
        return d1, d1 * f1 * H, d2, d2 * f2 * H


def fr_constants(cosmo: Cosmology, param, aexp: float):
    """Hu-Sawicki f(R) constants in box units at aexp: the scalaron source
    b = f1 rho + f2, the equation's constant q and the fifth-force factor
    (the force is grad(phi + half_c2 u^2) for n = 1)."""
    n = int(param["fR_n"])
    Ol = cosmo.Ode
    Rbar = 3.0 * cosmo.Om * aexp ** -3 + 12.0 * Ol
    Rbar0 = 3.0 * cosmo.Om + 12.0 * Ol
    fR_a = -(aexp ** 2) * (Rbar0 / Rbar) ** (n + 1) * 10.0 ** (
        -float(param["fR_logfR0"]))
    c2 = (C_KMS / (100.0 * float(param["boxlen"]))) ** 2
    f1 = aexp * cosmo.Om / (6.0 * c2) / -fR_a
    f2 = (Rbar / 3.0 * aexp ** 4 - cosmo.Om * aexp) / (6.0 * c2) / -fR_a
    q = -(aexp ** 4) * Rbar / (18.0 * c2) / -fR_a
    return {"f1": f1, "f2": f2, "q": q, "half_c2": 0.5 * -fR_a * c2}
