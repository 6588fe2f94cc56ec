"""A configuration's reference module, as the rehearsal writes it into a
copy of the benchmark (``reference/parametrized.py``): PySCo's
parametrized gravity, G_eff / G = mu(a) = 1 + mu0 Omega_L(a) / Omega_L0,
in the Poisson source and in the growth of the initial conditions."""

from __future__ import annotations

from . import ics, pm
from .cosmology import Cosmology
from .pm import density, gather, power_spectrum, step  # noqa: F401
from .precision import F64, Precision


class MuCosmology(Cosmology):
    def __init__(self, param):
        super().__init__(param)
        self.mu0 = float(param["parametrized_mu0"])

    def mu(self, a):
        ode = self.Ode * self.de_scale(a) / self.E(a) ** 2
        return 1.0 + self.mu0 * ode / self.Ode


class Forces(pm.Forces):
    theories = ("parametrized",)

    def __init__(self, param, prec: Precision = F64):
        super().__init__(param, prec)
        self.cosmo = MuCosmology(param)

    def source(self, rho, aexp: float):
        return self.prec.q(self.cosmo.mu(aexp) * super().source(rho, aexp))


def lpt2(param, seed: int, device, prec: Precision = F64):
    return ics.lpt2(param, seed, device, prec, MuCosmology(param))
