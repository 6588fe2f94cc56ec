"""The port's device LPT initial conditions (pysco_tpu_torch.ic_device, in
torch on the CPU here) against the JAX package's device path
(pysco_tpu.ic_device) and against the port's host path (ic.py), at 32^3,
at the bounds of tests/test_ic_device.py; and ``run`` taking that path
exactly when the JAX ``run`` does."""

import glob

import numpy as np
import pytest
import torch

import pysco_tpu_torch
from pysco_tpu import cosmo as jcosmo
from pysco_tpu import ic_device as jic_device
from pysco_tpu import solver as jsolver
from pysco_tpu_torch import cosmo, ic, ic_device, main, solver
from pysco_tpu_torch.ops import fourier, tiled_pm

from test_torch_run import _e2e_param

torch.set_num_threads(1)


def _param(tmp_path, tag, order, dealias, fixed=False, paired=False):
    pk_file = tmp_path / "pk.dat"
    if not pk_file.exists():
        cosmo.write_power_spectrum_table(str(pk_file))
    base = tmp_path / tag
    (base / "output_00000").mkdir(parents=True, exist_ok=True)
    return {
        "theory": "newton", "H0": 72, "Om_m": 0.25733, "T_cmb": 2.726,
        "N_eff": 3.044, "w0": -1.0, "wa": 0.0, "boxlen": 100,
        "ncoarse": 5, "npart": 32 ** 3, "z_start": 49, "seed": 42,
        "position_ICS": "center", "fixed_ICS": fixed, "paired_ICS": paired,
        "dealiased_ICS": dealias, "power_spectrum_file": str(pk_file),
        "initial_conditions": order, "base": str(base), "extra": "test",
        "output_snapshot_format": "HDF5", "mass_scheme": "TSC",
        "linear_newton_solver": "fft", "gradient_stencil_order": 5,
        "Npre": 2, "Npost": 1, "fR_n": 1, "mond_function": "simple",
        "mond_alpha": 1.0, "epsrel": 1e-2, "particle_engine": "pallas",
        "parametrized_mu0": 0.0, "Om_r": 0.0, "Om_lambda": 0.74267,
        "unit_l": 1.0, "unit_t": 1.0, "verbose": 0,
        "aexp": 1.0 / 50.0,
    }


def _wrap_dist(a, b):
    d = np.abs(a - b)
    return np.minimum(d, 1.0 - d)


def _assert_ics_close(pos, vel, pos_ref, vel_ref):
    """tests/test_ic_device.py's bounds: float32 FFT roundoff on the
    displacement scale."""
    assert pos.shape == pos_ref.shape
    assert np.all(_wrap_dist(pos, pos_ref) < 5e-6)
    np.testing.assert_allclose(vel, vel_ref, atol=5e-6, rtol=1e-4)


@pytest.mark.parametrize("order,dealias,fixed,paired", [
    ("1LPT", False, False, False),
    ("2LPT", False, False, False),
    ("2LPT", True, False, False),
    ("3LPT", False, False, False),
    ("3LPT", True, False, False),
    ("1LPT", False, True, False),
    ("2LPT", False, True, True),
])
def test_device_ic_matches_jax_and_host(tmp_path, order, dealias, fixed,
                                        paired):
    param = _param(tmp_path, "torch", order, dealias, fixed, paired)
    tables = cosmo.generate(param)
    assert ic_device.supported(param) and jic_device.supported(param)

    pos_cols, vel_cols = ic_device.generate_lpt(param, tables, "cpu")
    assert pos_cols.shape == vel_cols.shape == (4, 32 ** 3)
    assert pos_cols.dtype == torch.float32
    assert torch.all(pos_cols[3] == 0) and torch.all(vel_cols[3] == 0)
    assert float(pos_cols[:3].min()) >= 0 and float(pos_cols[:3].max()) < 1
    cfg = solver.config_from_param(param)
    pos, vel = solver.particles_to_rows(cfg, pos_cols, vel_cols)
    # the snapshot of the host path, written by the device path too
    assert glob.glob(f"{param['base']}/output_00000/particles_*")

    # the JAX package's device path
    param_j = _param(tmp_path, "jax", order, dealias, fixed, paired)
    jpos_cols, jvel_cols = jic_device.generate_lpt(
        param_j, jcosmo.generate(param_j))
    cfg_j = jsolver.config_from_param(param_j)
    jpos, jvel = jsolver.particles_to_rows(cfg_j, jpos_cols, jvel_cols)
    _assert_ics_close(pos, vel, np.asarray(jpos), np.asarray(jvel))

    # the port's host path (the same RNG stream, NumPy FFTs)
    param_h = _param(tmp_path, "host", order, dealias, fixed, paired)
    pos_h, vel_h = ic.generate(param_h, tables)
    _assert_ics_close(pos, vel, pos_h, vel_h)


def test_spectral_helpers_match_host():
    """fourier.gradient/hessian/sum_of_hessian/diff_of_hessian against
    ic.py's NumPy mirrors (the same float32 products)."""
    rng = np.random.default_rng(3)
    xk = (rng.standard_normal((16, 16, 9))
          + 1j * rng.standard_normal((16, 16, 9))).astype(np.complex64)
    t = torch.as_tensor(xk)
    np.testing.assert_allclose(fourier.gradient(t).numpy(), ic._gradient(xk),
                               rtol=1e-6, atol=0)
    for a in range(3):
        assert torch.equal(fourier.gradient_axis(t, a),
                           fourier.gradient(t)[..., a])
    for ij in ((0, 0), (0, 2), (1, 2)):
        np.testing.assert_allclose(fourier.hessian(t, ij).numpy(),
                                   ic._hessian(xk, ij), rtol=1e-6)
    for f, g in ((fourier.sum_of_hessian, ic._sum_of_hessian),
                 (fourier.diff_of_hessian, ic._diff_of_hessian)):
        np.testing.assert_allclose(f(t, (1, 1), (2, 2)).numpy(),
                                   g(xk, (1, 1), (2, 2)), rtol=1e-6)
    # Orszag 3/2 pad and trim: the host's zero-padding exactly
    np.testing.assert_array_equal(ic_device.pad_k(t).numpy(), ic.pad(xk))
    padded = ic.pad(xk)
    np.testing.assert_array_equal(
        ic_device.trim_k(torch.as_tensor(padded)).numpy(), ic.trim(padded))


@pytest.mark.parametrize("over,expect", [
    ({}, True),
    ({"initial_conditions": "3LPT"}, True),
    ({"ic_device": False}, False),
    ({"particle_engine": "scatter"}, False),
    ({"npart": 15 ** 3}, False),  # not a multiple of the column quantum
    ({"initial_conditions": 1}, False),  # a restart
    ({"initial_conditions": "snap.h5"}, False),
])
def test_supported_matches_jax(tmp_path, over, expect):
    param = dict(_param(tmp_path, "s", "2LPT", False), **over)
    assert ic_device.supported(param) is expect
    assert jic_device.supported(param) is expect


def test_run_takes_the_device_path(tmp_path, monkeypatch):
    """A pallas-engine LPT run builds its state on the device: no host
    ICs and no row-to-column step; with ``ic_device = False`` the host
    path runs instead."""
    def refuse(*a, **k):
        raise AssertionError("host IC path taken")

    param = _e2e_param(tmp_path, "dev", linear_newton_solver="fft",
                       z_out="[46]")
    with monkeypatch.context() as m:
        m.setattr(ic, "generate", refuse)
        m.setattr(tiled_pm, "to_columns_host", refuse)
        records = pysco_tpu_torch.run(param, device="cpu")
    assert records and ic_device.TIMES["generate_lpt"] > 0
    assert glob.glob(f"{param['base']}/output_00000/particles_*.h5")

    host = _e2e_param(tmp_path, "host", linear_newton_solver="fft",
                      z_out="[46]", ic_device=False)
    monkeypatch.setattr(main.ic_device, "generate_lpt", refuse)
    pysco_tpu_torch.run(host, device="cpu")
    # the two paths give the same final snapshot to float32 FFT roundoff
    from pysco_tpu_torch.utils import io as iostream

    a, b = (iostream.read_snapshot_particles_hdf5(glob.glob(
        f"{p['base']}/output_00001/particles_*.h5")[0]) for p in (param,
                                                               host))
    assert np.all(_wrap_dist(a[0], b[0]) < 2e-5)


def test_write_initial_snapshot_false(tmp_path):
    param = _param(tmp_path, "nosnap", "2LPT", False)
    param["write_initial_snapshot"] = False
    pos, _ = ic_device.generate_lpt(param, cosmo.generate(param), "cpu")
    assert pos.shape == (4, 32 ** 3)
    assert not glob.glob(f"{param['base']}/output_00000/particles_*")
