"""One f(R) PM force evaluation of the port (``solver.pm``, theory fr)
against ``pysco_tpu.solver.pm`` on the same state, handed across with
``state_from_arrays``, for both scalaron equations and every Poisson
solver."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysco_tpu import solver as jsolver
from pysco_tpu_torch import solver
from pysco_tpu_torch.models import multigrid
from pysco_tpu_torch.utils.units import set_units

from test_torch_solver import _assert_acc_close, _by_position, _param, _rows

torch.set_num_threads(1)

N = 16


def _fr_param(fR_n, solver_name, **kw):
    p = _param(theory="fr", fR_n=fR_n, fR_logfR0=5.0,
               linear_newton_solver=solver_name, aexp=0.05, **kw)
    set_units(p)
    return p


def test_fr_dynamics_match_jax():
    """The f(R) background constants, float64 on the host, rounded to
    float32 as the JAX package's DynScalars."""
    for fR_n in (1, 2):
        param = _fr_param(fR_n, "multigrid")
        dyn, jdyn = (solver.compute_dynamics(param),
                     jsolver.compute_dynamics(param))
        for key in ("fR_f1", "fR_f2", "fR_q", "fR_half_c2", "aexp",
                    "epsrel"):
            assert getattr(dyn, key) == float(getattr(jdyn, key)), key
        assert dyn.fR_q < 0 < dyn.fR_f1


@pytest.mark.parametrize("fR_n,solver_name", [
    (1, "multigrid"), (1, "fft"), (2, "multigrid"), (2, "fft"),
    (1, "full_fft"), (2, "fft_7pt"),
])
def test_pm_fr_matches(fR_n, solver_name):
    """A first call (zero-neighbour scalaron guess, Jacobi potential) and
    a second from the first call's fields, through both packages: the
    same FAS scalaron solve and the same fifth force."""
    param = _fr_param(fR_n, solver_name)
    pos, vel = _rows(8)
    cfg_j = jsolver.config_from_param(param)
    cfg = solver.config_from_param(param)
    assert (cfg.theory, cfg.fR_n, cfg.fR_root_solver) == ("fr", fR_n,
                                                          "newton")
    phi0, u0 = jsolver.empty_fields(cfg_j)
    p, v, _, phi, u = solver.state_from_arrays(
        cfg, pos, vel, None, np.array(phi0), np.array(u0), "cpu")
    assert u.shape == (N, N, N)
    state_j = (jnp.asarray(pos), jnp.asarray(vel), phi0, u0)
    state = (p, v, phi, u)
    multigrid.reset_stats()
    for first_call, scaling in ((True, 1.0), (False, 1.07)):
        dyn_param = dict(param, potential_scaling=scaling)
        out_j = jsolver.pm(cfg_j, first_call, False, *state_j,
                           jsolver.compute_dynamics(dyn_param))
        out = solver.pm(cfg, first_call, False, *state,
                        solver.compute_dynamics(dyn_param))
        # the scalaron (and the multigrid potential) to epsrel: float32
        # roundoff through a few cycles
        pairs = [(out[4], out_j[4])]
        if solver_name != "full_fft":
            pairs.append((out[3], out_j[3]))
        for got, want in pairs:
            want = np.array(want)
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=1e-5 * np.abs(want).max())
        pj, aj = _by_position(*jsolver.particles_to_rows(cfg_j, out_j[0],
                                                         out_j[2]))
        pt, at = _by_position(*solver.particles_to_rows(cfg, out[0], out[2]))
        np.testing.assert_array_equal(pt, pj)
        _assert_acc_close(at, aj)
        state_j = (out_j[0], out_j[1], out_j[3], out_j[4])
        state = (out[0], out[1], out[3], out[4])
    # one FAS solve per force evaluation, V-cycles counted on their own
    assert multigrid.STATS["fas_solves"] == 2
    assert multigrid.STATS["fas_cycles"] >= 2
    assert multigrid.STATS["solves"] == 2 + 2 * (solver_name == "multigrid")


def test_fr_exact_root_solver_matches_newton():
    """fR_root_solver = exact (float64 closed forms, plain torch) gives
    the Newton path's forces to the bound of tests/test_scalaron.py."""
    pos, vel = _rows(9)
    accs = {}
    for root in ("newton", "exact"):
        param = _fr_param(1, "fft", fR_root_solver=root)
        cfg = solver.config_from_param(param)
        phi, u = solver.empty_fields(cfg, "cpu")
        p, v, _, _, _ = solver.state_from_arrays(cfg, pos, vel, None,
                                                 phi.numpy(), u.numpy(),
                                                 "cpu")
        out = solver.pm(cfg, True, False, p, v, phi, u,
                        solver.compute_dynamics(param))
        accs[root] = _by_position(*solver.particles_to_rows(cfg, out[0],
                                                           out[2]))[1]
    np.testing.assert_allclose(accs["exact"], accs["newton"], rtol=0,
                               atol=2e-5 * np.abs(accs["newton"]).max())
