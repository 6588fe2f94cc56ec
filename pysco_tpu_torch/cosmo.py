"""Background cosmology and growth factors.

Copy of ``pysco_tpu/cosmo.py``, kept in this package because importing
anything from ``pysco_tpu`` imports JAX. Keep the two in step.

Replaces the reference's astropy/scipy stack (``cosmotable.py``) with a
self-contained flat w0waCDM implementation (astropy is not a dependency of
this framework). Produces the same 13 interpolation tables in the same
layout: [lna(t), t(lna), H(lna), D1, f1, D2, f2, D3a, f3a, D3b, f3b,
D3c, f3c], the on-disk ``evolution_table_pysco.txt``, and the growth ODE
system (Newtonian and parametrized-mu variants) integrated at
rtol=atol=1e-13 with Rampf & Bucher matter-era initial conditions
(reference: ``cosmotable.py:113-230``).

Everything here is host-side float64 NumPy/SciPy; the run loop uploads
whichever tables it needs to the device as float32 arrays.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass, field
from typing import List

import numpy as np
from scipy.integrate import cumulative_trapezoid, solve_ivp

from .utils import profiling
from .utils.units import C_SI, G_SI, PC_M, SIGMA_SB


@dataclass
class FlatW0WaCDM:
    """Flat w0waCDM background, matching astropy's ``Flatw0waCDM`` densities.

    Radiation includes photons from ``Tcmb0`` and ``Neff`` massless
    neutrino species.
    """

    H0: float  # km/s/Mpc
    Om0: float
    Tcmb0: float = 2.726
    Neff: float = 3.044
    w0: float = -1.0
    wa: float = 0.0
    Ogamma0: float = field(init=False)
    Onu0: float = field(init=False)
    Ode0: float = field(init=False)

    def __post_init__(self) -> None:
        H0_s = self.H0 * 1e3 / (1e6 * PC_M)  # 1/s
        rho_crit = 3.0 * H0_s ** 2 / (8.0 * np.pi * G_SI)  # kg/m^3
        a_rad = 4.0 * SIGMA_SB / C_SI  # radiation constant J m^-3 K^-4
        rho_gamma = a_rad * self.Tcmb0 ** 4 / C_SI ** 2  # kg/m^3
        self.Ogamma0 = rho_gamma / rho_crit
        self.Onu0 = self.Neff * 0.875 * (4.0 / 11.0) ** (4.0 / 3.0) * self.Ogamma0
        self.Ode0 = 1.0 - self.Om0 - self.Ogamma0 - self.Onu0

    # --- density evolution -------------------------------------------------
    def de_density_scale(self, z):
        zp1 = 1.0 + np.asarray(z, dtype=np.float64)
        return zp1 ** (3.0 * (1.0 + self.w0 + self.wa)) * np.exp(
            -3.0 * self.wa * (zp1 - 1.0) / zp1
        )

    def efunc(self, z):
        zp1 = 1.0 + np.asarray(z, dtype=np.float64)
        Or0 = self.Ogamma0 + self.Onu0
        return np.sqrt(
            self.Om0 * zp1 ** 3
            + Or0 * zp1 ** 4
            + self.Ode0 * self.de_density_scale(z)
        )

    def Om(self, z):
        zp1 = 1.0 + np.asarray(z, dtype=np.float64)
        return self.Om0 * zp1 ** 3 / self.efunc(z) ** 2

    def Or(self, z):
        zp1 = 1.0 + np.asarray(z, dtype=np.float64)
        return (self.Ogamma0 + self.Onu0) * zp1 ** 4 / self.efunc(z) ** 2

    def Ode(self, z):
        return self.Ode0 * self.de_density_scale(z) / self.efunc(z) ** 2


class Table1D:
    """Linear interpolator with extrapolation (interp1d-equivalent)."""

    __slots__ = ("x", "y", "_slope0", "_slope1")

    def __init__(self, x: np.ndarray, y: np.ndarray):
        order = np.argsort(x)
        self.x = np.ascontiguousarray(np.asarray(x, dtype=np.float64)[order])
        self.y = np.ascontiguousarray(np.asarray(y, dtype=np.float64)[order])
        self._slope0 = (self.y[1] - self.y[0]) / (self.x[1] - self.x[0])
        self._slope1 = (self.y[-1] - self.y[-2]) / (self.x[-1] - self.x[-2])

    def __call__(self, xq):
        xq = np.asarray(xq, dtype=np.float64)
        out = np.interp(xq, self.x, self.y)
        lo = xq < self.x[0]
        hi = xq > self.x[-1]
        if np.any(lo):
            out = np.where(lo, self.y[0] + (xq - self.x[0]) * self._slope0, out)
        if np.any(hi):
            out = np.where(hi, self.y[-1] + (xq - self.x[-1]) * self._slope1, out)
        return out if out.ndim else float(out)


def generate(param) -> List[Table1D]:
    """Build the 13 background/growth interpolators and write the
    evolution table, mirroring ``cosmotable.generate`` (cosmotable.py:18);
    the seconds go into ``profiling.PHASES["cosmo.generate"]``.
    """
    with profiling.phase("cosmo.generate"):
        return _generate(param)


def _generate(param) -> List[Table1D]:
    cosmo = FlatW0WaCDM(
        H0=float(param["H0"]),
        Om0=float(param["Om_m"]),
        Tcmb0=float(param["T_cmb"]),
        Neff=float(param["N_eff"]),
        w0=float(param["w0"]),
        wa=float(param["wa"]),
    )
    param["Om_r"] = cosmo.Ogamma0 + cosmo.Onu0
    param["Om_lambda"] = cosmo.Ode0

    z_start = 200
    a_start = 1.0 / (1 + z_start)
    lna = np.linspace(np.log(a_start), 0, 100_000)
    a = np.exp(lna)
    dlna = lna[1] - lna[0]
    E_array = cosmo.efunc(1.0 / a - 1)
    dt_supercomoving = dlna / (a ** 2 * E_array)
    t_supercomoving = cumulative_trapezoid(dt_supercomoving, initial=0)
    t_supercomoving -= t_supercomoving[-1]

    growth = compute_growth_functions(cosmo, param)
    mask = growth[0] > lna[0]
    lna_g, d1, f1, d2, f2, d3a, f3a, d3b, f3b, d3c, f3c = growth[:, mask]

    base = param.get("base", ".") if hasattr(param, "get") else param["base"]
    os.makedirs(base, exist_ok=True)
    table_path = os.path.join(base, "evolution_table_pysco.txt")
    logging.warning("Write table in: %s", table_path)
    np.savetxt(
        table_path,
        np.c_[
            a,
            E_array,
            t_supercomoving,
            np.interp(lna, lna_g, d1),
            np.interp(lna, lna_g, f1),
            np.interp(lna, lna_g, d2),
            np.interp(lna, lna_g, f2),
            np.interp(lna, lna_g, d3a),
            np.interp(lna, lna_g, f3a),
            np.interp(lna, lna_g, d3b),
            np.interp(lna, lna_g, f3b),
            np.interp(lna, lna_g, d3c),
            np.interp(lna, lna_g, f3c),
        ],
        header=(
            "aexp, H/H0, t_supercomoving, dplus1, f1, dplus2, f2, "
            "dplus3a, f3a, dplus3b, f3b, dplus3c, f3c"
        ),
    )
    return [
        Table1D(t_supercomoving, lna),
        Table1D(lna, t_supercomoving),
        Table1D(lna, float(param["H0"]) * E_array),
        Table1D(lna_g, d1),
        Table1D(lna_g, f1),
        Table1D(lna_g, d2),
        Table1D(lna_g, f2),
        Table1D(lna_g, d3a),
        Table1D(lna_g, f3a),
        Table1D(lna_g, d3b),
        Table1D(lna_g, f3b),
        Table1D(lna_g, d3c),
        Table1D(lna_g, f3c),
    ]


def eisenstein_hu_transfer(k_hmpc, h: float, Om0: float, Ob0: float,
                           Tcmb: float = 2.726) -> np.ndarray:
    """Eisenstein & Hu (1998) zero-baryon ("no-wiggle") transfer function.

    Used to generate self-contained linear power spectrum tables for the
    examples and benchmarks (the reference ships a pre-computed CAMB-like
    table; we generate ours analytically instead).
    """
    k = np.asarray(k_hmpc, dtype=np.float64) * h  # 1/Mpc
    theta = Tcmb / 2.7
    om_h2 = Om0 * h * h
    ob_h2 = Ob0 * h * h
    fb = Ob0 / Om0
    # sound horizon approximation (EH98 eq. 26)
    s = 44.5 * np.log(9.83 / om_h2) / np.sqrt(1 + 10 * ob_h2 ** 0.75)
    alpha_gamma = (
        1 - 0.328 * np.log(431 * om_h2) * fb
        + 0.38 * np.log(22.3 * om_h2) * fb ** 2
    )
    gamma_eff = Om0 * h * (
        alpha_gamma + (1 - alpha_gamma) / (1 + (0.43 * k * s) ** 4)
    )
    q = k_hmpc * theta ** 2 / gamma_eff
    L0 = np.log(2 * np.e + 1.8 * q)
    C0 = 14.2 + 731.0 / (1 + 62.5 * q)
    return L0 / (L0 + C0 * q * q)


def linear_power_spectrum(k_hmpc, H0: float, Om_m: float, Om_b: float = 0.0486,
                          ns: float = 0.96, sigma8: float = 0.8,
                          T_cmb: float = 2.726) -> np.ndarray:
    """Linear matter P(k) [(Mpc/h)^3] at z=0 from the EH98 shape,
    normalised to the requested sigma8."""
    h = H0 / 100.0
    k = np.asarray(k_hmpc, dtype=np.float64)
    t = eisenstein_hu_transfer(k, h, Om_m, Om_b, T_cmb)
    pk_shape = k ** ns * t ** 2

    kint = np.logspace(-4, 2.5, 4096)
    tint = eisenstein_hu_transfer(kint, h, Om_m, Om_b, T_cmb)
    x = kint * 8.0
    w = 3 * (np.sin(x) - x * np.cos(x)) / x ** 3
    integrand = kint ** (ns + 2) * tint ** 2 * w ** 2 / (2 * np.pi ** 2)
    sigma2 = np.trapezoid(integrand * kint, x=np.log(kint))
    return pk_shape * (sigma8 ** 2 / sigma2)


def write_power_spectrum_table(path: str, H0: float = 72.0,
                               Om_m: float = 0.25733, **kw) -> None:
    """Write a two-column (k [h/Mpc], P(k) [(Mpc/h)^3]) ASCII table."""
    k = np.logspace(-4, 2, 1000)
    pk = linear_power_spectrum(k, H0=H0, Om_m=Om_m, **kw)
    np.savetxt(path, np.c_[k, pk],
               header="k [h/Mpc]   P(k) [(Mpc/h)^3] (EH98, z=0)")


def compute_growth_functions(cosmo: FlatW0WaCDM, param) -> np.ndarray:
    """Integrate the LPT growth ODE system up to third order.

    Matter-era initial conditions from Rampf & Bucher; parametrized-mu
    gravity modifies the source term beta (reference: cosmotable.py:232-383).
    """
    aexp_start = 1e-8
    lnaexp_span = (np.log(aexp_start), 0.0)
    aexp_equality = (cosmo.Ogamma0 + cosmo.Onu0) / cosmo.Om0
    if (cosmo.Ogamma0 + cosmo.Onu0) == 0:
        aexp_equality = 2e-7

    dplus1_ini = 3.0 / 5 * aexp_equality
    y0 = [
        dplus1_ini,
        0.0,
        -3.0 / 7 * dplus1_ini ** 2,
        0.0,
        -1.0 / 3.0 * dplus1_ini ** 3,
        0.0,
        10.0 / 21.0 * dplus1_ini ** 3,
        0.0,
        -1.0 / 7.0 * dplus1_ini ** 3,
        0.0,
    ]
    lnaexp_array = np.linspace(lnaexp_span[0], lnaexp_span[1], 100_000)

    theory = str(param["theory"]).casefold()
    mu0 = float(param["parametrized_mu0"]) if theory == "parametrized" else 0.0

    def rhs(lnaexp, y):
        aexp = np.exp(lnaexp)
        z = 1.0 / aexp - 1
        Om_z = cosmo.Om(z)
        Or_z = cosmo.Or(z)
        Ode_z = cosmo.Ode(z)
        if theory == "parametrized":
            mu = 1.0 + mu0 * Ode_z / cosmo.Ode0
        else:
            mu = 1.0
        beta = 1.5 * mu * Om_z
        gamma = 0.5 * (
            1.0 - 3.0 * Ode_z * (cosmo.w0 + cosmo.wa * (1.0 - aexp)) - Or_z
        )
        (D1, dD1, D2, dD2, D3a, dD3a, D3b, dD3b, D3c, dD3c) = y
        return [
            dD1,
            -gamma * dD1 + beta * D1,
            dD2,
            -gamma * dD2 + beta * (D2 - D1 ** 2),
            dD3a,
            -gamma * dD3a + beta * (D3a - 2.0 * D1 ** 3),
            dD3b,
            -gamma * dD3b + beta * (D3b - 2.0 * D1 * (D2 - D1 ** 2)),
            dD3c,
            (1 - gamma) * dD3c + D2 * dD1 - D1 * dD2 - beta * D1 ** 3,
        ]

    solution = solve_ivp(
        rhs, lnaexp_span, y0, t_eval=lnaexp_array, rtol=1e-13, atol=1e-13
    )
    d1 = solution.y[0]
    d2 = solution.y[2]
    d3a = solution.y[4]
    d3b = solution.y[6]
    d3c = solution.y[8]
    f1 = solution.y[1] / d1
    f2 = solution.y[3] / d2
    f3a = solution.y[5] / d3a
    f3b = solution.y[7] / d3b
    f3c = solution.y[9] / d3c
    return np.array([lnaexp_array, d1, f1, d2, f2, d3a, f3a, d3b, f3b, d3c, f3c])
