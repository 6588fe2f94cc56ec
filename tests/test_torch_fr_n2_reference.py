"""The f(R) n = 2 port against the benchmark's float64 reference module
(``benchmark/reference/fr_n2.py``), on the CPU at 16^3-32^3: the quartic
root, one packed exact-root smoothing sweep, a converged quartic FAS solve
and a TSC force evaluation. Each comparison is also run with the
reference in bfloat16 in the port's place, which must fail it: the
tolerances are tight enough to tell the two apart."""

import json
import math
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from reference import fr_n2, ics, pm  # noqa: E402
from reference.cosmology import Cosmology, fr_constants  # noqa: E402
from reference.precision import BF16, F64  # noqa: E402

from pysco_tpu_torch import cosmo, solver  # noqa: E402
from pysco_tpu_torch.models import multigrid, quartic  # noqa: E402
from pysco_tpu_torch.utils.config import (  # noqa: E402
    params_from_dict, with_defaults)
from pysco_tpu_torch.utils.units import set_units  # noqa: E402

F32 = torch.float32


def _param(n, tmp_path, **over):
    with open(os.path.join(BENCH, "configs", "fr_n2_tsc_mg_512.json")) as f:
        c = json.load(f)
    p = dict(c["param"], ncoarse=int(math.log2(n)), npart=n ** 3,
             boxlen=float(n), seed=42, base=str(tmp_path), verbose=0,
             write_initial_snapshot=False,
             power_spectrum_file=os.path.join(BENCH, "configs",
                                              c["pk_file"]))
    p.update(over)
    return with_defaults(params_from_dict(p))


def _rel(got, want):
    return float(torch.max(torch.abs(got.double() - want)
                           / torch.abs(want)))


def _bf16(x):
    return BF16.q(x.float()).double()


# ---------------------------------------------------------------------------
# The root
# ---------------------------------------------------------------------------

def _branch(name, n=20000):
    """(p, c) of one branch of u^4 + p u + c = 0. Where a real root exists
    |p| >= 1e-4 |c|^(3/4): below that the port's closed form loses
    digits to the cancellation in Q + d0/Q (as (|c|^(3/4)/|p|)^2 x 1e-16;
    the fields of a run stay above 7e-3)."""
    g = torch.Generator().manual_seed(sum(map(ord, name)))

    def r(lo, hi):
        return 10 ** (lo + (hi - lo) * torch.rand(n, generator=g,
                                                  dtype=torch.float64))

    c = r(-3, 2)
    if name == "c<0, p>0":  # one positive root, the physical branch
        return r(-4, 2) * c ** 0.75, -c
    if name == "c<0, p<0":
        return -r(-4, 2) * c ** 0.75, -c
    if name == "c>0, two positive roots":  # p < -(256 c^3 / 27)^(1/4)
        return -(256.0 / 27.0 * c ** 3) ** 0.25 * (1.0 + r(-3, 1)), c
    if name == "c>0, two negative roots":
        return (256.0 / 27.0 * c ** 3) ** 0.25 * (1.0 + r(-3, 1)), c
    if name == "no real root":  # |p| < (256 c^3 / 27)^(1/4)
        s = torch.sign(torch.randn(n, generator=g, dtype=torch.float64))
        return s * (256.0 / 27.0 * c ** 3) ** 0.25 * (1.0 - r(-3, -0.1)), c
    if name == "p = 0":
        return torch.zeros(n, dtype=torch.float64), -c
    if name == "p = 0, c > 0":
        return torch.zeros(n, dtype=torch.float64), c
    raise ValueError(name)


ROOTED = ["c<0, p>0", "c<0, p<0", "c>0, two positive roots",
          "c>0, two negative roots", "p = 0"]
FALLBACK = ["no real root", "p = 0, c > 0"]


@pytest.mark.parametrize("branch", ROOTED + FALLBACK)
def test_quartic_root_matches_the_reference(branch):
    """The port's float64 closed form against the reference's converged
    Newton root: the largest real root to 1e-6 relative (the root is
    stored in float32, 6e-8; the closed form's cancellation stays under
    1e-7 on these inputs); where there is no real root, both take PySCo's
    fallback |c|^(1/4), bit for bit."""
    p, c = _branch(branch)
    want, has_root = fr_n2.quartic_root(p, c)
    assert bool(has_root.all() if branch in ROOTED else ~has_root.any())
    if branch in ROOTED:  # converged: the quartic vanishes to rounding
        terms = want.abs() ** 4 + (p * want).abs() + c.abs()
        assert float(((want ** 4 + p * want + c).abs() / terms).max()) < 1e-15
    got = quartic.solution_quartic_equation(p, c)
    if branch in ROOTED:
        assert _rel(got, want) < 1e-6
        # the reference in bfloat16 misses by its 3 digits
        ctl = _bf16(fr_n2.quartic_root(_bf16(p), _bf16(c))[0])
        assert _rel(ctl, want) > 1e-6
    else:
        assert torch.equal(got, want)
        assert torch.equal(want, c.abs() ** 0.25)


# ---------------------------------------------------------------------------
# A smoothing sweep, a solve, a force
# ---------------------------------------------------------------------------

def _fields(n, tmp_path, aexp):
    """A clustered TSC density (2LPT particles carried to z = 0) and the
    f(R) n = 2 source and constants at ``aexp``."""
    param = _param(n, tmp_path, z_start=0.0)
    pos, _ = ics.lpt2(param, 42, "cpu")
    rho = pm.density(pos, n, n ** 3, scheme="tsc")
    c = fr_constants(Cosmology(param), param, aexp)
    return param, rho, c["f1"] * rho + c["f2"], c


@pytest.mark.parametrize("with_rhs", [False, True])
def test_packed_exact_sweep_matches_the_reference(with_rhs, tmp_path):
    """One red-black sweep of the port's packed quartic smoothing with
    exact roots against the reference's full-lattice sweep, from the same
    float32 u: 1e-5 relative (the port forms p in float32, whose rounding
    the root passes on a few times over; measured 1.4e-7)."""
    n = 16
    _, _, b, c = _fields(n, tmp_path, 1.0)
    b32 = b.float()
    g = torch.Generator().manual_seed(3)
    u0 = quartic.initialise_potential(b32, c["q"])
    u0 = u0 * (1.0 + 0.05 * torch.randn(u0.shape, generator=g))
    rhs = (1e-3 * float(abs(c["q"])) / n ** 2 * torch.randn(
        u0.shape, generator=g)) if with_rhs else None
    got = quartic.smoothing(u0, b32, c["q"], 1, rhs, exact_root=True)
    rhs64 = None if rhs is None else rhs.double()
    want = fr_n2.smooth(u0.double(), b, c["q"], rhs64, 1, F64)
    assert _rel(got, want) < 1e-5
    ctl = fr_n2.smooth(u0.double(), b, c["q"], rhs64, 1, BF16)
    assert _rel(ctl, want) > 1e-5


@pytest.mark.parametrize("aexp", [0.3, 1.0])
def test_quartic_fas_matches_the_reference(aexp, tmp_path):
    """The port's FAS (exact roots, V-cycles until they stop gaining)
    against the reference's solve to its aim: 1e-4 of max u (the port's
    float32 residual stagnates near 1e-6 of the operator's terms, which
    the screened cells amplify; measured 1.4e-6 here, 2.4e-5 on an
    N-body state at 64^3)."""
    n = 32
    _, _, b, c = _fields(n, tmp_path, aexp)
    stats = {}
    want = fr_n2.solve(b, c["q"], None, 5, 2, 1, 1e-2, F64, stats)
    assert stats["residual"] <= stats["aim"]
    ops = multigrid.fas_ops_quartic(c["q"], exact_root=True)
    b32 = b.float()
    got = multigrid.FAS(quartic.initialise_potential(b32, c["q"]), b32, ops,
                        5, 2, 1, 0.0)
    scale = float(want.abs().max())
    assert float((got.double() - want).abs().max()) / scale < 1e-4
    ctl = fr_n2.solve(b, c["q"], None, 5, 2, 1, 1e-2, BF16)
    assert float((ctl.double() - want).abs().max()) / scale > 1e-4


def test_tsc_force_matches_the_reference(tmp_path):
    """One f(R) n = 2 force evaluation of the port (TSC density, multigrid
    Poisson and the quartic FAS with exact roots, epsrel 1e-6, the
    5-point gradient of phi + c^2/2 u^3) against the reference's:
    1e-3 of the force's rms, as for n = 1 (the port's float32 multigrid
    Poisson solve; measured 4.0e-5)."""
    n = 32
    aexp = 1.0
    param, rho, _, _ = _fields(n, tmp_path, aexp)
    param["epsrel"] = 1e-6
    cosmo.generate(param)
    param["aexp"] = aexp
    set_units(param)
    cfg = solver.config_from_param(param)
    dyn = solver.compute_dynamics(param)
    potential, u = solver.empty_fields(cfg, "cpu")
    force, _, _, _ = solver._solve_fields(cfg, True, False, rho.float(),
                                          potential, u, dyn, leading=True)
    ref, _ = fr_n2.Forces(param)(rho, aexp)
    rms = float(ref.pow(2).mean().sqrt())
    assert float((force.double() - ref).abs().max()) / rms < 1e-3
    ctl, _ = fr_n2.Forces(param, BF16)(rho, aexp)
    assert float((ctl.double() - ref).abs().max()) / rms > 1e-3


def test_reference_refuses_what_it_does_not_follow(tmp_path):
    for over, why in (({"fR_n": 1}, "n = 2"),
                      ({"theory": "newton"}, "f\\(R\\) with multigrid"),
                      ({"linear_newton_solver": "fft"}, "multigrid")):
        with pytest.raises(NotImplementedError, match=why):
            fr_n2.Forces(_param(16, tmp_path, **over))
    assert fr_n2.Forces(_param(16, tmp_path)).p == 3  # TSC
