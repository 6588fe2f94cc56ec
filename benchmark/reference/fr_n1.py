"""f(R) Hu-Sawicki n = 1 solved to its aim, the reference module of
``fr_n1_tsc_mg_nroot_512``: the cubic scalaron equation by Full
Approximation Scheme V-cycles (PySCo, Breton 2025, section 2.3).

The equation, its smoothing and its coarse-grid problem are ``fas``'s: on
a grid of n cells a side (h = 1/n) the reduced scalaron u obeys, per
cell, u^3 + p u + q h^2 = rhs with p = h^2 b - (sum of the 6 neighbours'
u^2) / 6, b = f1 rho + f2 and rhs = 0 on the finest grid; a sweep moves
each colour of a red-black lattice towards the real root PySCo takes
(Cardano's formula where the discriminant is positive, else the
trigonometric root at (theta + 2 pi)/3; ``fas.cubic_root``), over-relaxed
by 1.25. The root is PySCo's closed form whatever the program's
``fR_root_solver``: the program's float32 Newton polish is what the check
holds against it, not what it imitates. f1, f2, q and the fifth-force
factor c^2/2 are ``cosmology.fr_constants``; the force is grad(phi +
c^2/2 u^2), phi the exact periodic solution of the 7-point Poisson
equation (what the program's multigrid converges to).

The stop rule is not ``fas.solve``'s. That one stops where a cycle lowers
the residual by less than a tenth, which on a clustered 512^3 state
leaves it at 0.013-0.05, never at its aim, and lets the float64
``index_add_`` order move the checked step's numbers run to run. This
module runs V-cycles until the residual falls a thousand times below the
program's stopping point (epsrel times the truncation error of the
starting u), and stops early only where a cycle no longer lowers it at
all, as ``fr_n2`` does.

Deposit, gather, step and P(k) are ``pm``'s, with the configuration's
mass scheme (NGP, CIC or TSC).
"""

from __future__ import annotations

import math

from . import fas, pm
from .cosmology import fr_constants
from .pm import density, gather, power_spectrum, step  # noqa: F401
from .precision import F64, Precision

MAX_CYCLES = 60


def solve(b, q: float, x, ncoarse: int, npre: int, npost: int,
          epsrel: float, prec: Precision, stats: dict | None = None):
    """The scalaron from the first guess ``x`` (None: ``fas.first_guess``).
    ``stats``, where given, receives the cycles run, the residual reached
    and the aim."""
    b = prec.t(b)
    x = fas.first_guess(b, q, prec) if x is None else prec.t(x)
    tol = 1e-3 * epsrel * fas.truncation_error(x, b, q, prec)
    err = prev = math.inf
    cycles = 0
    while cycles < MAX_CYCLES:
        x = fas.v_cycle(x, b, q, None, ncoarse - 2, npre, npost, prec)
        cycles += 1
        err = fas.residual(x, b, q, prec)
        if err <= tol or err >= prev:
            break
        prev = err
    if stats is not None:
        stats.update(cycles=cycles, residual=err, aim=tol)
    return x


class Forces(pm.Forces):
    """The force mesh of Hu-Sawicki n = 1 with multigrid: the Poisson
    equation solved exactly, the scalaron by :func:`solve`."""

    theories = ("fr",)

    def __init__(self, param, prec: Precision = F64):
        super().__init__(param, prec)
        if self.solver != "multigrid":
            raise NotImplementedError(f"{self.theory}/{self.solver}: this "
                                      "module runs f(R) with multigrid")
        self.stats = {}  # the last scalaron solve's cycles and residual

    def __call__(self, rho, aexp: float, u_start=None):
        """(force (3, n, n, n), u): the 5-point gradient of phi + c^2/2 u^2,
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
        return pm.gradient(prec.q(phi + c["half_c2"] * u * u), prec), u
