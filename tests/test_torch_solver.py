"""One PM force evaluation of the port (pysco_tpu_torch.solver) against
pysco_tpu.solver on the same state, handed across with
``state_from_arrays``. The JAX tiled engine runs its Pallas kernels in
interpret mode; the port runs its plain twins on the CPU."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from pysco_tpu import solver as jsolver
from pysco_tpu.ops import pallas_pm
from pysco_tpu_torch import solver
from pysco_tpu_torch.models import multigrid
from pysco_tpu_torch.utils.units import set_units

torch.set_num_threads(1)

N = 16


def _param(**kw):
    p = {
        "theory": "newton", "ncoarse": 4, "npart": N ** 3,
        "mass_scheme": "tsc", "linear_newton_solver": "fft",
        "gradient_stencil_order": 5, "Npre": 2, "Npost": 1, "fR_n": 1,
        "mond_function": "simple", "mond_alpha": 1.0, "aexp": 0.1,
        "Om_m": 0.3, "Om_lambda": 0.7, "Om_r": 8e-5, "w0": -1.0,
        "wa": 0.0, "parametrized_mu0": -0.1, "epsrel": 1e-2,
        "particle_engine": "pallas", "pm_precision_widened": "bf16x3",
        "mond_g0": 1.2, "mond_scale_factor_exponent": 0.0, "H0": 72.0,
        "boxlen": 100.0,
    }
    p.update(kw)
    set_units(p)  # unit_t and unit_l: MOND's g0 in box units
    return p


def _rows(seed=0):
    rng = np.random.default_rng(seed)
    pos = rng.random((N ** 3, 3), dtype=np.float32)
    pos[: N ** 3 // 2] = 0.3 + 0.3 * pos[: N ** 3 // 2]  # some clustering
    vel = (0.3 * rng.standard_normal((N ** 3, 3))).astype(np.float32)
    return pos, vel


def _by_position(pos, *arrays):
    """Rows reordered by position (the tiled sorts order a tile's
    particles differently: lax.sort is not stable)."""
    order = np.lexsort(pos.T[::-1])
    return (pos[order],) + tuple(a[order] for a in arrays)


def _assert_acc_close(got, want):
    # deposit and gather sums in another order, FFTs by another library:
    # float32 roundoff relative to the largest force
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("engine,solver_name,theory", [
    ("pallas", "fft", "newton"),
    ("pallas", "fft_7pt", "newton"),
    ("pallas", "full_fft", "parametrized"),
    ("scatter", "fft", "newton"),
])
def test_pm_matches(engine, solver_name, theory):
    param = _param(particle_engine=engine, linear_newton_solver=solver_name,
                   theory=theory)
    pos, vel = _rows(1)
    cfg_j = jsolver.config_from_param(param)
    phi0, u0 = jsolver.empty_fields(cfg_j)
    out_j = jsolver.pm(cfg_j, True, True, jnp.asarray(pos), jnp.asarray(vel),
                       phi0, u0, jsolver.compute_dynamics(param))
    cfg = solver.config_from_param(param)
    p, v, _, phi, u = solver.state_from_arrays(
        cfg, pos, vel, None, np.array(phi0), np.array(u0), "cpu")
    out = solver.pm(cfg, True, True, p, v, phi, u,
                    solver.compute_dynamics(param))
    pj, vj, aj = jsolver.particles_to_rows(cfg_j, out_j[0], out_j[1],
                                           out_j[2])
    pt, vt, at = solver.particles_to_rows(cfg, out[0], out[1], out[2])
    if engine == "pallas":
        pj, vj, aj = _by_position(pj, vj, aj)
        pt, vt, at = _by_position(pt, vt, at)
    np.testing.assert_array_equal(pt, pj)
    np.testing.assert_array_equal(vt, vj)
    _assert_acc_close(at, aj)
    if solver_name != "full_fft":
        np.testing.assert_allclose(
            out[3].numpy(), np.array(out_j[3]), rtol=0,
            atol=1e-5 * np.abs(np.array(out_j[3])).max())
    for a, b in zip(out[5], out_j[5]):  # P(k): k, Pk, Nmodes
        np.testing.assert_allclose(a.numpy(), np.array(b), rtol=1e-5)


@pytest.mark.parametrize("presorted", [0, 1, 2, 3])
def test_pm_lazy_matches(presorted):
    """The lazy force evaluation on a stale-bin state: particles sorted,
    then moved up to presorted - 0.05 cells (presorted = 0 re-sorts)."""
    param = _param(mass_scheme="cic")
    pos, vel = _rows(2)
    cfg_j = jsolver.config_from_param(param)
    pc, vc = pallas_pm.to_columns(pos, vel, N ** 3)
    ps, vs, ts = (np.array(a) for a in pallas_pm.sort_particles(
        pc, vc, N, "cic"))
    if presorted:
        rng = np.random.default_rng(3)
        delta = ((presorted - 0.05) / N * rng.uniform(
            -1, 1, (3, ps.shape[1]))).astype(np.float32)
        real = ps[0] < pallas_pm.SENTINEL_MIN
        ps[:3] = np.where(real, (ps[:3] + delta) % np.float32(1), ps[:3])
    phi0, u0 = (np.array(a) for a in jsolver.empty_fields(cfg_j))
    out_j = jsolver._pm_lazy_impl(
        cfg_j, presorted, False, jnp.asarray(ps), jnp.asarray(vs),
        jnp.asarray(ts), jnp.asarray(phi0), jnp.asarray(u0),
        jsolver.compute_dynamics(param))
    cfg = solver.config_from_param(param)
    state = solver.state_from_arrays(cfg, ps, vs, ts, phi0, u0, "cpu")
    out = solver._pm_lazy_impl(cfg, presorted, False, *state,
                               solver.compute_dynamics(param))
    assert int(out[7]) == int(out_j[7]) == 0
    np.testing.assert_array_equal(out[2].numpy(), np.array(out_j[2]))
    pj, aj = jsolver.particles_to_rows(cfg_j, out_j[0], out_j[3])
    pt, at = solver.particles_to_rows(cfg, out[0], out[3])
    if not presorted:  # both re-sorted: match particles by position
        pj, aj = _by_position(pj, aj)
        pt, at = _by_position(pt, at)
    np.testing.assert_array_equal(pt, pj)
    _assert_acc_close(at, aj)


@pytest.mark.parametrize("theory,cycle", [("newton", "V"),
                                          ("parametrized", "F"),
                                          ("mond", "V"), ("mond", "W")])
def test_pm_multigrid_matches(theory, cycle):
    """A first call (Jacobi first guesses) and a second call from the
    first call's fields rescaled by potential_scaling, through both
    packages: the same V/F/W solves on the same density."""
    param = _param(linear_newton_solver="multigrid", theory=theory,
                   multigrid_cycle=cycle, mond_g0=30.0)
    pos, vel = _rows(6)
    cfg_j = jsolver.config_from_param(param)
    cfg = solver.config_from_param(param)
    phi0, u0 = jsolver.empty_fields(cfg_j)
    p, v, _, phi, u = solver.state_from_arrays(
        cfg, pos, vel, None, np.array(phi0), np.array(u0), "cpu")
    assert u.shape == ((N, N, N) if theory == "mond" else (1, 1, 1))
    state_j = (jnp.asarray(pos), jnp.asarray(vel), phi0, u0)
    state = (p, v, phi, u)
    for first_call, scaling in ((True, 1.0), (False, 1.07)):
        dyn_param = dict(param, potential_scaling=scaling)
        out_j = jsolver.pm(cfg_j, first_call, False, *state_j,
                           jsolver.compute_dynamics(dyn_param))
        out = solver.pm(cfg, first_call, False, *state,
                        solver.compute_dynamics(dyn_param))
        # multigrid to epsrel: float32 roundoff through a few cycles
        for got, want in ((out[3], out_j[3]), (out[4], out_j[4])):
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


def test_pm_multigrid_matches_fft7pt():
    """tests/test_solver_oracle.py's oracle through the port: the
    multigrid solve and the exact discrete 7-point spectral solve give
    nearly the same forces (the same discrete operator)."""
    rng = np.random.default_rng(1)
    pos = rng.random((N ** 3, 3), dtype=np.float32)
    accs = {}
    multigrid.reset_stats()
    for name in ("multigrid", "fft_7pt"):
        param = _param(linear_newton_solver=name, epsrel=1e-4)
        cfg = solver.config_from_param(param)
        phi, u = solver.empty_fields(cfg, "cpu")
        p, _, _, _, _ = solver.state_from_arrays(
            cfg, pos, np.zeros_like(pos), None, phi.numpy(), u.numpy(), "cpu")
        out = solver.pm(cfg, True, False, p, None, phi, u,
                        solver.compute_dynamics(param))
        (accs[name],) = solver.particles_to_rows(cfg, out[2])
    assert multigrid.STATS["solves"] == 1 and multigrid.STATS["cycles"] > 1
    scale = np.abs(accs["fft_7pt"]).max()
    np.testing.assert_allclose(accs["multigrid"], accs["fft_7pt"],
                               atol=2e-3 * scale)


@pytest.mark.parametrize("name", ["multigrid", "fft", "fft_7pt", "full_fft"])
def test_force_3d_matches(name):
    rhs = np.random.default_rng(7).standard_normal((N, N, N)).astype(
        np.float32)
    rhs -= rhs.mean()
    param = _param(linear_newton_solver=name)
    got = solver.force_3d(torch.as_tensor(rhs), param)
    want = np.array(jsolver.force_3d(jnp.asarray(rhs), param))
    assert got.shape == (N, N, N, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_state_from_arrays_round_trip():
    cfg = solver.config_from_param(_param())
    pos, vel = _rows(4)
    phi = np.random.default_rng(5).random((N, N, N)).astype(np.float32)
    p, v, ts, phi_t, u = solver.state_from_arrays(
        cfg, pos, vel, None, phi, np.zeros((1, 1, 1), np.float32), "cpu")
    assert p.shape == (4, 4096) and p.dtype == torch.float32
    assert ts.dtype == torch.int32 and ts.shape == (N * (N // 8) + 1,)
    assert (p[3] == 0).all()
    rp, rv = solver.particles_to_rows(cfg, p, v)
    np.testing.assert_array_equal(rp, pos)
    np.testing.assert_array_equal(rv, vel)
    np.testing.assert_array_equal(phi_t.numpy(), phi)
    # column input passes through unchanged
    p2, v2, *_ = solver.state_from_arrays(cfg, p.numpy(), v.numpy(),
                                          ts.numpy(), phi, u.numpy(), "cpu")
    assert torch.equal(p2, p) and torch.equal(v2, v)
    # the scatter engine keeps rows
    cfg_s = solver.config_from_param(_param(particle_engine="scatter"))
    p3, *_ = solver.state_from_arrays(cfg_s, pos, vel, None, phi,
                                      u.numpy(), "cpu")
    assert p3.shape == (N ** 3, 3)


def test_unsupported_configs_raise():
    for kw, what in ((dict(theory="fr", fR_n=3), "fR_n"),
                     (dict(theory="mond", linear_newton_solver="fft"),
                      "multigrid or fft_7pt"),
                     (dict(linear_newton_solver="sor"),
                      "linear_newton_solver"),
                     (dict(particle_engine="cloud"), "particle_engine")):
        with pytest.raises(NotImplementedError, match=what):
            solver.config_from_param(_param(**kw))
    with pytest.raises(ValueError, match="pm_precision_widened"):
        solver.config_from_param(_param(pm_precision_widened="fp8"))
    with pytest.raises(ValueError, match="multigrid_cycle"):
        solver.config_from_param(_param(multigrid_cycle="X"))
    with pytest.raises(ValueError, match="fR_root_solver"):
        solver.config_from_param(_param(theory="fr", fR_root_solver="cbrt"))
    # the JAX package's precision keys are accepted for config parity
    for mode in ("f32", "bf16", "bf16x3", "bf16-gather"):
        solver.config_from_param(_param(pm_precision=mode,
                                        pm_precision_widened=mode))
    # multigrid, QUMOND and f(R) n = 1, 2 are this port's now
    for kw in (dict(linear_newton_solver="multigrid", multigrid_cycle="w"),
               dict(theory="mond", linear_newton_solver="multigrid"),
               dict(theory="mond", linear_newton_solver="fft_7pt"),
               dict(theory="fr", fR_n=1, linear_newton_solver="multigrid"),
               dict(theory="fr", fR_n=2, linear_newton_solver="fft",
                    fR_root_solver="exact")):
        cfg = solver.config_from_param(_param(**kw))
        assert cfg.linear_newton_solver == kw["linear_newton_solver"]
