"""The port's dense particle engine (pysco_tpu_torch/ops/dense_pm.py, the
``particle_engine = dense`` path) against the JAX package's
(pysco_tpu/ops/dense_pm.py), and through the port's force evaluation and
run loop.

The transfers are fed one sorted state on both sides (the port's stable
sort; JAX's ``lax.sort`` may order a plane's particles otherwise), so
they compare row by row. Tolerances: the deposit within 1e-5 of max |rho|
and the gather within 1e-5 of max |f| (float32 matrix products summed in
another order); plane starts and overflow counts exactly.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from pysco_tpu import solver as jsolver
from pysco_tpu.ops import dense_pm as jdense
import pysco_tpu_torch
from pysco_tpu_torch import solver
from pysco_tpu_torch.cosmo import write_power_spectrum_table
from pysco_tpu_torch.ops import dense_pm
from pysco_tpu_torch.utils.units import set_units

torch.set_num_threads(1)

SCHEMES = ("ngp", "cic", "tsc")
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "golden_pk_32.json")


def _rows(n, seed, clustered=False):
    rng = np.random.default_rng(seed)
    pos = rng.random((n, 3), dtype=np.float32)
    if clustered:
        # a quarter of the particles in a thin slab: planes at ~2x the mean
        pos[: n // 4, 0] = 0.25 + 0.2 * pos[: n // 4, 0]
    vel = rng.standard_normal((n, 3)).astype(np.float32)
    return pos, vel


def _sorted(pos, vel, m, scheme):
    ps, vs, starts = dense_pm.sort_by_plane(torch.as_tensor(pos), m, scheme,
                                            torch.as_tensor(vel))
    return ps, vs, starts


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("clustered", [False, True])
def test_deposit_matches_jax(scheme, clustered):
    m = 16
    pos, vel = _rows(4096, 0, clustered)
    ps, _, starts = _sorted(pos, vel, m, scheme)
    grid, overflow = dense_pm.deposit(ps, starts, m, scheme)
    jgrid, joverflow = jdense.deposit(jnp.asarray(ps.numpy()),
                                      jnp.asarray(starts.numpy()), m, scheme)
    jgrid = np.array(jgrid)
    assert grid.shape == (m, m, m) and grid.dtype == torch.float32
    np.testing.assert_allclose(grid.numpy(), jgrid, rtol=0,
                               atol=1e-5 * np.abs(jgrid).max())
    assert int(overflow) == int(joverflow) == 0
    assert float(grid.double().sum()) == pytest.approx(4096.0, rel=1e-6)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_deposit_in_pieces_matches_jax(scheme, monkeypatch):
    """The deposit's sum over a plane's rows cut into pieces (as at 128^3
    and above on the card; here by shrinking the piece) gives JAX's
    deposit and, within float32 rounding, the deposit in one piece."""
    m = 16
    pos, vel = _rows(4096, 8, clustered=True)
    ps, _, starts = _sorted(pos, vel, m, scheme)
    whole, _ = dense_pm.deposit(ps, starts, m, scheme)
    monkeypatch.setattr(dense_pm, "_PIECE_ROWS", 128)
    assert dense_pm._pieces(dense_pm._capacity(4096, m)) == 4
    grid, overflow = dense_pm.deposit(ps, starts, m, scheme)
    jgrid = np.array(jdense.deposit(jnp.asarray(ps.numpy()),
                                    jnp.asarray(starts.numpy()), m,
                                    scheme)[0])
    for ref in (jgrid, whole.numpy()):
        np.testing.assert_allclose(grid.numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(jgrid).max())
    assert int(overflow) == 0


@pytest.mark.parametrize("scheme", SCHEMES)
def test_gather_matches_jax(scheme):
    m = 16
    rng = np.random.default_rng(1)
    field = rng.standard_normal((m, m, m, 3)).astype(np.float32)
    pos, vel = _rows(2048, 2, clustered=True)
    ps, _, starts = _sorted(pos, vel, m, scheme)
    got = dense_pm.gather_vec(torch.as_tensor(field), ps, starts, scheme)
    want = np.array(jdense.gather_vec(jnp.asarray(field),
                                      jnp.asarray(ps.numpy()),
                                      jnp.asarray(starts.numpy()), scheme))
    assert got.shape == (2048, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(field).max())


def test_sort_by_plane_payload_and_starts():
    m = 8
    pos, vel = _rows(512, 3)
    for scheme in SCHEMES:
        ps, vs, starts = _sorted(pos, vel, m, scheme)
        jp, jv, jstarts = jdense.sort_by_plane(jnp.asarray(pos), m, scheme,
                                               jnp.asarray(vel))
        assert starts.dtype == torch.int32 and starts.shape == (m + 1,)
        np.testing.assert_array_equal(starts.numpy(), np.array(jstarts))
        # rows stay attached, and the sorted rows are a permutation
        lookup = {tuple(p): tuple(v) for p, v in zip(pos, vel)}
        for p, v in zip(ps.numpy(), vs.numpy()):
            assert lookup[tuple(p)] == tuple(v)
        # each plane's rows are the JAX plane's rows, as sets
        for i in range(m):
            a, b = ps.numpy()[starts[i]:starts[i + 1]], np.array(jp)[
                jstarts[i]:jstarts[i + 1]]
            np.testing.assert_array_equal(a[np.lexsort(a.T)],
                                          b[np.lexsort(b.T)])


def test_overflow_counted_exactly():
    """Every particle in plane 0: all but a capacity's worth overflow, in
    both packages, and they deposit nothing."""
    m, n = 16, 4096
    pos, vel = _rows(n, 5)
    pos[:, 0] = pos[:, 0] / m
    ps, _, starts = _sorted(pos, vel, m, "ngp")
    grid, overflow = dense_pm.deposit(ps, starts, m, "ngp")
    _, joverflow = jdense.deposit(jnp.asarray(ps.numpy()),
                                  jnp.asarray(starts.numpy()), m, "ngp")
    cap = dense_pm._capacity(n, m)
    assert cap == jdense._capacity(n, m) < n
    assert int(overflow) == int(joverflow) == n - cap
    assert float(grid.double().sum()) == pytest.approx(cap, rel=1e-6)
    acc = dense_pm.gather_vec(torch.ones((m, m, m, 3)), ps, starts, "ngp")
    assert torch.equal(acc[cap:], torch.zeros((n - cap, 3)))


@pytest.mark.parametrize("scheme", ["cic", "tsc"])
def test_repeat_and_matmul_precision_change_no_bit(scheme):
    """A second call gives the same bits, and so does one under another
    float32 matmul precision of the process, which the call leaves as it
    found it."""
    m = 16
    pos, vel = _rows(4096, 6, clustered=True)
    ps, _, starts = _sorted(pos, vel, m, scheme)
    field = torch.as_tensor(np.random.default_rng(7).standard_normal(
        (m, m, m, 3)).astype(np.float32))
    grid, _ = dense_pm.deposit(ps, starts, m, scheme)
    acc = dense_pm.gather_vec(field, ps, starts, scheme)
    assert torch.equal(dense_pm.deposit(ps, starts, m, scheme)[0], grid)
    assert torch.equal(dense_pm.gather_vec(field, ps, starts, scheme), acc)
    flags = (torch.backends.cuda.matmul, torch.backends.mkldnn.matmul)
    prev = [f.fp32_precision for f in flags]
    try:
        for setting in (("tf32", "bf16"), ("tf32", "tf32")):
            for f, v in zip(flags, setting):
                f.fp32_precision = v
            assert torch.equal(dense_pm.deposit(ps, starts, m, scheme)[0],
                               grid)
            assert torch.equal(dense_pm.gather_vec(field, ps, starts,
                                                   scheme), acc)
            assert tuple(f.fp32_precision for f in flags) == setting
        # torch's legacy flag too
        torch.backends.cuda.matmul.allow_tf32 = True
        dense_pm.deposit(ps, starts, m, scheme)
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        for f, v in zip(flags, prev):
            f.fp32_precision = v


def _param(**kw):
    p = {
        "theory": "newton", "ncoarse": 4, "npart": 16 ** 3,
        "mass_scheme": "tsc", "linear_newton_solver": "fft",
        "gradient_stencil_order": 5, "Npre": 2, "Npost": 1, "fR_n": 1,
        "mond_function": "simple", "mond_alpha": 1.0, "aexp": 0.1,
        "Om_m": 0.3, "Om_lambda": 0.7, "Om_r": 8e-5, "w0": -1.0,
        "wa": 0.0, "epsrel": 1e-2, "particle_engine": "dense",
        "H0": 72.0, "boxlen": 100.0,
    }
    p.update(kw)
    set_units(p)
    return p


@pytest.mark.parametrize("scheme,solver_name", [("tsc", "fft"),
                                                ("cic", "multigrid")])
def test_force_evaluation_matches_jax(scheme, solver_name):
    """One force evaluation through ``solver.pm`` with the dense engine
    against ``pysco_tpu.solver.pm``: the same particles and velocities,
    the accelerations within 1e-5 of the largest (2e-4 for multigrid,
    which stops on a tolerance, as tests/test_torch_parallel.py holds it),
    P(k) within 1e-5, no overflow."""
    param = _param(mass_scheme=scheme, linear_newton_solver=solver_name)
    rng = np.random.default_rng(8)
    pos = rng.random((16 ** 3, 3), dtype=np.float32)
    pos[:2048] = 0.3 + 0.3 * pos[:2048]
    vel = (0.3 * rng.standard_normal((16 ** 3, 3))).astype(np.float32)
    cfg_j = jsolver.config_from_param(param)
    phi0, u0 = jsolver.empty_fields(cfg_j)
    out_j = jsolver.pm(cfg_j, True, True, jnp.asarray(pos), jnp.asarray(vel),
                       phi0, u0, jsolver.compute_dynamics(param))
    cfg = solver.config_from_param(param)
    p, v, _, phi, u = solver.state_from_arrays(
        cfg, pos, vel, None, np.array(phi0), np.array(u0), "cpu")
    assert p.shape == (16 ** 3, 3)  # the dense engine keeps rows
    out = solver.pm(cfg, True, True, p, v, phi, u,
                    solver.compute_dynamics(param))
    assert int(out[6]) == int(out_j[6]) == 0

    def by_position(*arrays):
        order = np.lexsort(arrays[0].T[::-1])
        return tuple(a[order] for a in arrays)

    pj, vj, aj = by_position(*jsolver.particles_to_rows(
        cfg_j, out_j[0], out_j[1], out_j[2]))
    pt, vt, at = by_position(*solver.particles_to_rows(cfg, *out[:3]))
    np.testing.assert_array_equal(pt, pj)
    np.testing.assert_array_equal(vt, vj)
    tol = 2e-4 if solver_name == "multigrid" else 1e-5
    np.testing.assert_allclose(at, aj, rtol=0, atol=tol * np.abs(aj).max())
    for a, b in zip(out[5], out_j[5]):
        np.testing.assert_allclose(a.numpy(), np.array(b), rtol=1e-5)


def _golden_param(tmp_path, tag, **kw):
    """tests/test_full_run_fidelity.py's configuration (z = 49 -> 0)."""
    pk_file = tmp_path / "pk.dat"
    if not pk_file.exists():
        write_power_spectrum_table(str(pk_file))
    param = {
        "theory": "newton", "H0": 72, "Om_m": 0.25733, "T_cmb": 2.726,
        "N_eff": 3.044, "w0": -1.0, "wa": 0.0, "boxlen": 100,
        "ncoarse": 5, "npart": 16 ** 3, "z_start": 49, "seed": 42,
        "position_ICS": "center", "fixed_ICS": True, "paired_ICS": False,
        "dealiased_ICS": False, "power_spectrum_file": str(pk_file),
        "initial_conditions": "2LPT", "base": str(tmp_path / tag),
        "output_snapshot_format": "npz", "z_out": "[5, 1, 0]",
        "save_power_spectrum": "z_out", "integrator": "leapfrog",
        "mass_scheme": "TSC", "n_reorder": 50, "Courant_factor": 1.0,
        "max_aexp_stepping": 10, "linear_newton_solver": "fft",
        "gradient_stencil_order": 5, "Npre": 2, "Npost": 1,
        "epsrel": 1e-2, "verbose": 0, "particle_engine": "dense",
    }
    param.update(kw)
    return param


def test_full_horizon_matches_golden(tmp_path):
    """The golden configuration with the dense engine through ``run``:
    every step sorts (no lazy levels), no overflow, and P(k) within 1e-4
    of tests/golden_pk_32.json on the bins with at least 8 modes."""
    param = _golden_param(tmp_path, "run")
    records = pysco_tpu_torch.run(param, device="cpu")
    assert len(records) > 20
    assert all(r.drift == 0 and r.overflow == 0 for r in records)
    with open(GOLDEN) as f:
        golden = {k: np.array(v) for k, v in json.load(f).items()}
    power = tmp_path / "run" / "power"
    got = {p.name: np.loadtxt(p) for p in sorted(power.glob("pk_*.dat"))}
    assert sorted(got) == sorted(golden)
    for name, a in got.items():
        b = golden[name]
        np.testing.assert_allclose(a[:, 0], b[:, 0], rtol=1e-6)
        np.testing.assert_array_equal(a[:, 2], b[:, 2])
        sel = a[:, 2] >= 8
        rel = np.abs(a[sel, 1] - b[sel, 1]) / np.abs(b[sel, 1])
        assert rel.max() < 1e-4, f"{name}: {rel.max():.2e}"


def test_run_aborts_on_plane_capacity_overflow(tmp_path, monkeypatch):
    """A plane-capacity overflow aborts the run with the JAX package's
    message, before that step's P(k) is written."""
    monkeypatch.setattr(dense_pm, "_capacity", lambda npart, m: 8)
    param = _golden_param(tmp_path, "ovf", z_out="[40]")
    with pytest.raises(RuntimeError,
                       match="dense particle engine plane-capacity overflow"):
        pysco_tpu_torch.run(param, device="cpu")
    assert not list((tmp_path / "ovf" / "power").glob("pk_*.dat"))


def test_slab_mode_refuses_dense(tmp_path):
    param = _golden_param(tmp_path, "slab", parallel_mode="slab",
                          z_out="[40]")
    with pytest.raises(NotImplementedError, match="dense"):
        pysco_tpu_torch.run(param, device="cpu", devices=["cpu"] * 2)
