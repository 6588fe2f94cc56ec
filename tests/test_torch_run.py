"""The port's main path as a whole: ``pysco_tpu_torch.run`` on the CPU
(plain twins) against the golden P(k), against ``pysco_tpu.run`` on the
same configurations, and against the absolute physics oracles of
tests/test_physics_oracle.py."""

import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import pysco_tpu
import pysco_tpu_torch
from pysco_tpu_torch import ic
from pysco_tpu_torch.cosmo import generate, write_power_spectrum_table
from pysco_tpu_torch.ops import tiled_pm
from pysco_tpu_torch.utils import io as iostream
from pysco_tpu_torch.utils.config import extra_name
from pysco_tpu_torch.utils.units import PC_M, set_units

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "golden_pk_32.json")


def _pks(base):
    return {os.path.basename(f): np.loadtxt(f)
            for f in sorted(glob.glob(f"{base}/power/pk_*.dat"))}


def _compare(pks_a, pks_b, rtol, context):
    """tests/test_full_run_fidelity.py's rule: identical k bins, P(k)
    within rtol on bins with >= 8 modes."""
    assert pks_a and set(pks_a) == set(pks_b)
    for name in pks_a:
        a, b = pks_a[name], pks_b[name]
        np.testing.assert_allclose(a[:, 0], b[:, 0], rtol=1e-6)
        np.testing.assert_array_equal(a[:, 2], b[:, 2])
        sel = a[:, 2] >= 8
        rel = np.abs(a[sel, 1] - b[sel, 1]) / np.abs(b[sel, 1])
        assert rel.max() < rtol, (
            f"{context} {name}: max rel P(k) diff {rel.max():.2e} >= {rtol}")


def test_full_horizon_matches_golden(tmp_path):
    """The configuration of tests/test_full_run_fidelity.py (z = 49 -> 0,
    tiled engine, lazy re-binning) through the port."""
    pk_file = tmp_path / "pk.dat"
    write_power_spectrum_table(str(pk_file))
    base = tmp_path / "run"
    param = {
        "theory": "newton", "H0": 72, "Om_m": 0.25733, "T_cmb": 2.726,
        "N_eff": 3.044, "w0": -1.0, "wa": 0.0, "boxlen": 100,
        "ncoarse": 5, "npart": 16 ** 3, "z_start": 49, "seed": 42,
        "position_ICS": "center", "fixed_ICS": True, "paired_ICS": False,
        "dealiased_ICS": False, "power_spectrum_file": str(pk_file),
        "initial_conditions": "2LPT", "base": str(base),
        "output_snapshot_format": "HDF5", "z_out": "[5, 1, 0]",
        "save_power_spectrum": "z_out", "integrator": "leapfrog",
        "mass_scheme": "TSC", "n_reorder": 50, "Courant_factor": 1.0,
        "max_aexp_stepping": 10, "linear_newton_solver": "fft",
        "gradient_stencil_order": 5, "Npre": 2, "Npost": 1,
        "epsrel": 1e-2, "verbose": 0, "particle_engine": "pallas",
        "lazy_sort": True, "pm_precision_widened": "bf16x3",
    }
    records = pysco_tpu_torch.run(param, device="cpu")
    drifts = [r.drift for r in records]
    assert 0 in drifts[1:] and max(drifts) == 3  # re-sorts and stale steps
    assert all(r.overflow == 0 for r in records)
    with open(GOLDEN) as f:
        golden = {k: np.array(v) for k, v in json.load(f).items()}
    pks = _pks(base)
    assert len(pks) == 3
    # the JAX engines meet the golden file at 2.9e-6 (measured floor of
    # tests/test_full_run_fidelity.py); 1e-4 is that test's bound
    _compare(pks, golden, 1e-4, "torch port vs golden")


def _pk_table(path):
    """tests/test_e2e.py's synthetic linear P(k)."""
    k = np.logspace(-3, 2, 200)
    k0 = 0.02
    np.savetxt(path, np.c_[k, 2e4 * (k / k0) / (1 + (k / k0) ** 2) ** 2
                          * 1e2])
    return str(path)


def _e2e_param(tmp_path, tag, **kw):
    """tests/test_e2e.py's base configuration (16^3 particles on a 16^3
    grid) run to z = 44 (a sorted and a stale-bin step), exact-kernel
    precision mode."""
    param = {
        "theory": "newton", "parametrized_mu0": -0.1, "H0": 72,
        "Om_m": 0.25733, "T_cmb": 2.726, "N_eff": 3.044, "w0": -1.0,
        "wa": 0.0, "boxlen": 100, "ncoarse": 4, "npart": 16 ** 3,
        "z_start": 49, "seed": 42, "position_ICS": "center",
        "fixed_ICS": False, "paired_ICS": False, "dealiased_ICS": False,
        "power_spectrum_file": _pk_table(tmp_path / "pk.dat"),
        "initial_conditions": "2LPT", "base": str(tmp_path / tag),
        "output_snapshot_format": "HDF5", "z_out": "[44]",
        "save_power_spectrum": "z_out", "integrator": "leapfrog",
        "mass_scheme": "TSC", "n_reorder": 3, "Courant_factor": 1.0,
        "max_aexp_stepping": 10, "gradient_stencil_order": 5, "Npre": 2,
        "Npost": 1, "epsrel": 1e-2, "verbose": 0,
        "pm_precision_widened": "bf16x3",
    }
    param.update(kw)
    return param


@pytest.mark.parametrize("name,overrides", [
    ("newton_fft_cic", {"linear_newton_solver": "fft", "mass_scheme": "CIC",
                        "initial_conditions": "1LPT"}),
    ("newton_fft7pt", {"linear_newton_solver": "fft_7pt"}),
    ("newton_fullfft", {"linear_newton_solver": "full_fft",
                        "save_power_spectrum": "yes"}),
    ("newton_euler", {"integrator": "euler", "linear_newton_solver": "fft"}),
    ("parametrized", {"theory": "parametrized",
                      "linear_newton_solver": "fft"}),
    ("newton_multigrid_tsc_2lpt", {"linear_newton_solver": "multigrid"}),
    ("mond_multigrid", {"theory": "mond",
                        "linear_newton_solver": "multigrid"}),
    ("mond_fft7pt", {"theory": "mond", "linear_newton_solver": "fft_7pt"}),
    ("parametrized_multigrid_f", {"theory": "parametrized",
                                  "linear_newton_solver": "multigrid",
                                  "multigrid_cycle": "F"}),
])
def test_e2e_rows_match_jax(tmp_path, name, overrides):
    """The Newtonian, parametrized and QUMOND rows of tests/test_e2e.py
    through both packages (default tiled engine, lazy re-binning on), and
    one F-cycle multigrid row."""
    pj = _e2e_param(tmp_path, "jax", **overrides)
    pt = _e2e_param(tmp_path, "torch", **overrides)
    pysco_tpu.run(pj)
    pysco_tpu_torch.run(pt, device="cpu")
    # the two engines sum deposits and FFTs in other orders: float32
    # roundoff over a few steps, far under the golden bound
    _compare(_pks(pt["base"]), _pks(pj["base"]), 1e-4, name)
    snap_j = glob.glob(f"{pj['base']}/output_00001/particles_*.h5")
    snap_t = glob.glob(f"{pt['base']}/output_00001/particles_*.h5")
    assert len(snap_j) == len(snap_t) == 1
    attrs = iostream.read_hdf5_snapshot_attrs(snap_t[0])
    assert abs(float(attrs["aexp"]) - 1.0 / 45.0) < 1e-12
    assert int(attrs["nsteps"]) == int(
        iostream.read_hdf5_snapshot_attrs(snap_j[0])["nsteps"])


def test_restart_across_packages(tmp_path):
    """A snapshot written by the JAX package restarts the port, which
    then tracks its own uninterrupted run (scatter engine with no Morton
    reordering inside the horizon: the particle order is kept, so
    particles compare row by row). The reverse
    direction is tests/test_torch_host.py::test_snapshots_interchange."""
    pj = _e2e_param(tmp_path, "a", linear_newton_solver="fft",
                    particle_engine="scatter", n_reorder=1000)
    pysco_tpu.run(pj)
    pt = _e2e_param(tmp_path, "a", linear_newton_solver="fft",
                    particle_engine="scatter", initial_conditions=1,
                    z_out="[40]", n_reorder=1000)
    pysco_tpu_torch.run(pt, device="cpu")
    pt2 = _e2e_param(tmp_path, "b", linear_newton_solver="fft",
                     particle_engine="scatter", z_out="[44, 40]",
                     n_reorder=1000)
    pysco_tpu_torch.run(pt2, device="cpu")
    for i in (1, 2):
        a = glob.glob(f"{tmp_path}/a/output_0000{i}/particles_*.h5")
        b = glob.glob(f"{tmp_path}/b/output_0000{i}/particles_*.h5")
        pa, va = iostream.read_snapshot_particles_hdf5(a[0])
        pb, vb = iostream.read_snapshot_particles_hdf5(b[0])
        # JAX then the port, vs the port alone: float32 roundoff
        np.testing.assert_allclose(pa, pb, atol=1e-6)
        np.testing.assert_allclose(va, vb, atol=1e-5 * np.abs(vb).max())


def test_pk_written_after_overflow_check(tmp_path, monkeypatch):
    """A step that breaks the drift bound aborts before its P(k) is
    written (the JAX loop writes it first)."""
    param = _e2e_param(tmp_path, "ovf", linear_newton_solver="fft",
                       save_power_spectrum="yes", z_out="[30]")
    monkeypatch.setattr(tiled_pm, "drift_violations",
                        lambda *a, **k: torch.tensor(5))
    with pytest.raises(RuntimeError, match="5 particles lost"):
        pysco_tpu_torch.run(param, device="cpu")
    # step 0 (initial force) and step 1 (a sort) wrote P(k); step 2 ran
    # on stale bins, broke the (patched) bound and wrote nothing
    names = sorted(os.path.basename(f) for f in
                   glob.glob(f"{param['base']}/power/pk_*.dat"))
    assert names == [f"pk_newton_fft_ncoarse4_0000{i}.dat" for i in (0, 1)]


def test_run_requires_cuda_unless_told_otherwise(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pysco_tpu_torch.run(_e2e_param(tmp_path, "x"))


def test_cli_entry_point(tmp_path):
    ini = tmp_path / "param.ini"
    param = _e2e_param(tmp_path, "cli", linear_newton_solver="fft",
                       mass_scheme="CIC", z_out="[45]")
    ini.write_text("".join(f"{k} = {v}\n" for k, v in param.items()))
    r = subprocess.run(
        [sys.executable, "-m", "pysco_tpu_torch.main", "-c", str(ini),
         "--device", "cpu"],
        capture_output=True, text=True, timeout=300,
        cwd=os.path.dirname(HERE),
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert "Simulation run time" in r.stdout
    assert glob.glob(f"{param['base']}/output_00001/particles_*.h5")
    assert glob.glob(f"{param['base']}/power/pk_*.dat")


BOX_KEYS = {
    "theory": "newton", "H0": 72.0, "Om_m": 0.25733, "T_cmb": 2.726,
    "N_eff": 3.044, "w0": -1.0, "wa": 0.0,
    "position_ICS": "center", "fixed_ICS": False, "paired_ICS": False,
    "dealiased_ICS": False, "output_snapshot_format": "HDF5",
    "save_power_spectrum": "no", "integrator": "leapfrog",
    "mass_scheme": "TSC", "n_reorder": 10 ** 6, "Courant_factor": 1.0,
    "max_aexp_stepping": 10, "linear_newton_solver": "fft",
    "gradient_stencil_order": 5, "Npre": 2, "Npost": 1, "epsrel": 1e-2,
    "verbose": 0, "particle_engine": "scatter", "seed": 42,
}


def _periodic_diff(a, b):
    return (a - b + 0.5) % 1.0 - 0.5


def test_zeldovich_plane_wave(tmp_path):
    """tests/test_physics_oracle.py's Zel'dovich oracle through the port:
    a plane wave stays on its closed-form trajectory (scatter engine, so
    the particle order of the final snapshot is the initial one)."""
    n, z_start, z_end = 32, 49.0, 4.0
    base = str(tmp_path / "za")
    param = dict(BOX_KEYS, boxlen=100.0, ncoarse=5, npart=n ** 3,
                 z_start=z_start, z_out=f"[{z_end}]", base=base,
                 initial_conditions="1LPT", power_spectrum_file="unused")
    tables = generate(param)
    a_start, a_end = 1.0 / (1 + z_start), 1.0 / (1 + z_end)
    lna_s, lna_e = np.log(a_start), np.log(a_end)
    d1_0 = float(tables[3](0.0))
    d1_s = float(tables[3](lna_s)) / d1_0
    d1_e = float(tables[3](lna_e)) / d1_0
    p_amp = 1.5 / n / d1_e
    coords = np.arange(n, dtype=np.float64) / n + 0.5 / n
    psi = np.zeros((n, n, n, 3), dtype=np.float32)
    psi[..., 0] = (-p_amp * np.sin(2 * np.pi * coords))[:, None, None]

    param["aexp"] = a_start
    set_units(param)
    mpc_to_km = 1e3 * PC_M
    hz_s = float(tables[2](lna_s)) * param["unit_t"] / mpc_to_km
    pos, vel = ic.initialise_1LPT(psi, d1_s, float(tables[4](lna_s)) * hz_s,
                                  param)
    pos = ic._wrap_host(pos.reshape(n ** 3, 3))
    vel = vel.reshape(n ** 3, 3)
    param["extra"] = extra_name(param)
    attrs = dict(param, nsteps=0, i_snap=0, t=float(tables[1](lna_s)))
    iostream.write_snapshot_particles_hdf5(
        f"{base}/output_00000/particles_{param['extra']}.h5", pos, vel, attrs)

    pysco_tpu_torch.run(dict(param, initial_conditions=0), device="cpu")
    final = f"{base}/output_00001/particles_{param['extra']}.h5"
    pos_f, vel_f = iostream.read_snapshot_particles_hdf5(final)
    assert abs(float(iostream.read_hdf5_snapshot_attrs(final)["aexp"])
               - a_end) < 1e-12

    end = dict(param, aexp=a_end)
    set_units(end)
    hz_e = float(tables[2](lna_e)) * end["unit_t"] / mpc_to_km
    f1_e = float(tables[4](lna_e))
    pos_exact = ic._wrap_host((pos.astype(np.float64) + (d1_e - d1_s)
                               * (-psi.reshape(n ** 3, 3))).astype(np.float32))
    vel_exact = -(d1_e * f1_e * hz_e) * psi.reshape(n ** 3, 3)
    disp_amp = d1_e * p_amp
    pos_err = np.abs(_periodic_diff(pos_f.astype(np.float64),
                                    pos_exact.astype(np.float64))).max()
    vel_err = np.abs(vel_f - vel_exact).max()
    # the oracle test's bounds: 2% of the perturbation amplitude
    assert pos_err < 0.02 * disp_amp, pos_err / disp_amp
    assert vel_err < 0.02 * np.abs(vel_exact).max(), (
        vel_err / np.abs(vel_exact).max())


def test_linear_growth_pk(tmp_path):
    """tests/test_physics_oracle.py's D1^2 oracle through the port's main
    path (tiled engine, lazy re-binning): the step-0 P(k) is D1(a_start)^2
    times the input spectrum and grows by (D1(1)/D1(a_start))^2 by z = 0
    on linear scales."""
    pk_file = str(tmp_path / "pk.dat")
    write_power_spectrum_table(pk_file)
    base = str(tmp_path / "growth")
    param = dict(BOX_KEYS, boxlen=500.0, ncoarse=5, npart=32 ** 3,
                 z_start=49.0, z_out="[0]", base=base,
                 initial_conditions="2LPT", power_spectrum_file=pk_file,
                 fixed_ICS=True, save_power_spectrum="yes", n_reorder=50,
                 particle_engine="pallas")
    tables = generate(dict(param))
    pysco_tpu_torch.run(param, device="cpu")
    pk_files = sorted(glob.glob(f"{base}/power/pk_*.dat"))
    assert len(pk_files) >= 10
    k0, p0, n0 = np.loadtxt(pk_files[0]).T
    k1, p1, _ = np.loadtxt(pk_files[-1]).T
    np.testing.assert_allclose(k0, k1, rtol=1e-6)
    k_in, pk_in = np.loadtxt(pk_file).T
    d1_s = float(tables[3](np.log(1.0 / 50.0))) / float(tables[3](0.0))
    sel = (k0 < 0.055) & (n0 >= 12)
    assert sel.sum() >= 3
    # the oracle test's bounds (its measured method floor is ~2x under)
    ic_ratio = p0[sel] / (d1_s ** 2 * np.interp(k0[sel], k_in, pk_in))
    assert np.all(np.abs(ic_ratio - 1) < 0.06), ic_ratio
    growth = p1[sel] / p0[sel] * d1_s ** 2
    assert np.all(np.abs(growth[k0[sel] < 0.03] - 1) < 0.05), growth
    assert np.all(np.abs(growth - 1) < 0.12), growth
