"""f(R) Hu-Sawicki n = 2, the reference module of ``fr_n2_tsc_mg_512``:
the quartic scalaron equation solved by Full Approximation Scheme
V-cycles (PySCo, Breton 2025, section 2.3; Ruan et al. 2021 for n = 2).

On a grid of n cells a side (h = 1/n) the reduced scalaron u obeys, per
cell, u^4 + p u + q h^2 = rhs with p = h^2 b - (sum of the 6 neighbours'
u^3) / 6, b = f1 rho + f2 and rhs = 0 on the finest grid; f1, f2, q and
the fifth-force factor c^2/2 are ``cosmology.fr_constants`` with f_R(a)
carrying the exponent n + 1 = 3, and the force is grad(phi + c^2/2 u^3).
A smoothing sweep takes each colour of a red-black lattice in turn and
moves every cell of it towards the largest real root of its quartic,
over-relaxed by 1.25. The coarse grid problem of a V-cycle is that of
``fas``: the full-weighting restriction of u and b, the right-hand side 4
R(rhs - op) + op(R u, R b), and the trilinear prolongation of its change.

The root (:func:`quartic_root`) is not PySCo's resolvent-cubic closed
form but a float64 Newton iteration, safeguarded and run to convergence:
the quartic is convex, so Newton's steps from a point above every real
root fall monotonically onto the largest one. Departures from PySCo:
where the quartic has no real root (possible only on the coarse grids,
where rhs moves the constant above 0) the cell takes PySCo's fallback,
|q h^2 - rhs|^(1/4); where the closed form loses digits to cancellation
(small |p| against the constant) this root does not.

The solve runs V-cycles until the residual falls a thousand times below
the program's stopping point (epsrel times the truncation error of the
starting u), and stops early only where a cycle no longer lowers it at
all (``fas`` stops where a cycle lowers it by less than a tenth).

Deposit, gather, step and P(k) are ``pm``'s, with the configuration's
mass scheme.
"""

from __future__ import annotations

import math

import torch

from . import pm
from .cosmology import Cosmology, fr_constants
from .fas import RELAX, _neighbours, _parity, prolong, restrict
from .pm import density, gather, power_spectrum, step  # noqa: F401
from .precision import F64, Precision

MAX_CYCLES = 60
NEWTON_STEPS = 200


def quartic_root(p, c):
    """The largest real root of u^4 + p u + c = 0, per cell, in float64;
    |c|^(1/4) where the quartic has no real root. Returns (root, has_root).

    Every real root r has r^4 = -p r - c <= |p| |r| + |c|, so |r| is at
    most u0 = max((2 |c|)^(1/4), (2 |p|)^(1/3)), where the quartic is >= 0
    and rising. Newton's steps from u0 then fall onto the largest root and
    never below it; each is held at or above the quartic's minimum, at
    u_min = -(p / 4)^(1/3), which has a real root left of it only where the
    quartic there is <= 0."""
    p = p.double()
    c = (c if torch.is_tensor(c) else torch.full_like(p, c)).double()
    c = c.expand_as(p)
    u_min = -torch.sign(p) * (torch.abs(p) / 4.0) ** (1.0 / 3.0)
    has_root = u_min ** 4 + p * u_min + c <= 0.0
    u = torch.maximum((2.0 * torch.abs(c)) ** 0.25,
                      (2.0 * torch.abs(p)) ** (1.0 / 3.0))
    for _ in range(NEWTON_STEPS):
        g = u ** 4 + p * u + c
        dg = 4.0 * u ** 3 + p
        new = torch.maximum(u - g / torch.where(dg > 0, dg, 1.0), u_min)
        new = torch.where(has_root & (g > 0) & (dg > 0), new, u)
        if torch.equal(new, u):
            break
        u = new
    return torch.where(has_root, u, torch.abs(c) ** 0.25), has_root


def operator(x, b, q, prec: Precision):
    n = x.shape[0]
    h2 = 1.0 / (n * n)
    p = h2 * b - _neighbours(x * x * x) / 6.0
    return prec.q(x ** 4 + p * x + q * h2)


def first_guess(b, q, prec: Precision):
    """The root with every neighbour at zero: u^4 + h^2 b u + h^2 q = 0
    (q < 0: one positive root)."""
    n = b.shape[0]
    h2 = 1.0 / (n * n)
    u, _ = quartic_root(h2 * b.double(), h2 * q)
    return prec.q(u.to(prec.real))


def smooth(x, b, q, rhs, sweeps: int, prec: Precision):
    n = x.shape[0]
    h2 = 1.0 / (n * n)
    parity = _parity(n, x.device)
    c = q * h2 if rhs is None else q * h2 - rhs
    for _ in range(sweeps):
        for colour in (1, 0):
            p = h2 * b - _neighbours(x * x * x) / 6.0
            root = quartic_root(p, c)[0].to(prec.real)
            x = prec.q(torch.where(parity == colour,
                                   x + RELAX * (root - x), x))
    return x


def v_cycle(x, b, q, rhs, depth: int, npre: int, npost: int,
            prec: Precision):
    x = smooth(x, b, q, rhs, npre, prec)
    res = -operator(x, b, q, prec) if rhs is None else rhs - operator(
        x, b, q, prec)
    xc, bc = prec.q(restrict(x)), prec.q(restrict(b))
    rhs_c = prec.q(4.0 * restrict(res) + operator(xc, bc, q, prec))
    if depth <= 1:
        corr = smooth(xc, bc, q, rhs_c, npre, prec)
    else:
        corr = v_cycle(xc, bc, q, rhs_c, depth - 1, npre, npost, prec)
    x = prec.q(x + prolong(corr - xc))
    return smooth(x, b, q, rhs, npost, prec)


def residual(x, b, q, prec: Precision) -> float:
    return float(torch.linalg.vector_norm(operator(x, b, q, prec).double()))


def truncation_error(x, b, q, prec: Precision) -> float:
    xc, bc = restrict(x), restrict(b)
    t = 4.0 * restrict(operator(x, b, q, prec)) - operator(xc, bc, q, prec)
    return float(torch.linalg.vector_norm(t.double()))


def solve(b, q: float, x, ncoarse: int, npre: int, npost: int,
          epsrel: float, prec: Precision, stats: dict | None = None):
    """The scalaron from the first guess ``x`` (None: :func:`first_guess`).
    ``stats``, where given, receives the cycles run, the residual reached
    and the aim."""
    b = prec.t(b)
    x = first_guess(b, q, prec) if x is None else prec.t(x)
    tol = 1e-3 * epsrel * truncation_error(x, b, q, prec)
    err = prev = math.inf
    cycles = 0
    while cycles < MAX_CYCLES:
        x = v_cycle(x, b, q, None, ncoarse - 2, npre, npost, prec)
        cycles += 1
        err = residual(x, b, q, prec)
        if err <= tol or err >= prev:
            break
        prev = err
    if stats is not None:
        stats.update(cycles=cycles, residual=err, aim=tol)
    return x


class Forces(pm.Forces):
    """The force mesh of Hu-Sawicki n = 2 with multigrid Poisson and the
    quartic FAS (``pm.Forces`` takes n = 1 only, so the fields are set
    here)."""

    def __init__(self, param, prec: Precision = F64):
        self.param = param
        self.prec = prec
        self.cosmo = Cosmology(param)
        self.theory = str(param["theory"]).casefold()
        self.solver = str(param["linear_newton_solver"]).casefold()
        self.scheme = str(param["mass_scheme"]).casefold()
        if (self.theory, self.solver) != ("fr", "multigrid"):
            raise NotImplementedError(f"{self.theory}/{self.solver}: this "
                                      "module runs f(R) with multigrid")
        if int(param["fR_n"]) != 2:
            raise NotImplementedError("this module runs f(R) n = 2")
        if self.scheme not in pm.MAS_INDEX:
            raise NotImplementedError(f"mass scheme {self.scheme!r}")
        self.p = pm.MAS_INDEX[self.scheme]
        if int(param["gradient_stencil_order"]) != 5:
            raise NotImplementedError("the reference runs the 5-point "
                                      "gradient")
        self.stats = {}  # the last scalaron solve's cycles and residual

    def __call__(self, rho, aexp: float, u_start=None):
        """(force (3, n, n, n), u): the 5-point gradient of phi + c^2/2 u^3,
        u the scalaron solved from ``u_start`` (None: the zero-neighbour
        root)."""
        prec = self.prec
        phi = pm.poisson_7pt(self.source(rho, aexp), prec)
        c = fr_constants(self.cosmo, self.param, aexp)
        b = prec.q(c["f1"] * rho + c["f2"])
        u = solve(b, c["q"], u_start, int(self.param["ncoarse"]),
                  int(self.param["Npre"]), int(self.param["Npost"]),
                  float(self.param["epsrel"]), prec, self.stats)
        del b
        return pm.gradient(prec.q(phi + c["half_c2"] * u * u * u), prec), u
