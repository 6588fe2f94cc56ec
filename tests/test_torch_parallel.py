"""The port's mesh collectives (pysco_tpu_torch/parallel/mesh.py), its
replicated mode (parallel/pm.py) and the two multi-device run loops of
``pysco_tpu_torch.run``, against NumPy, against the JAX package on 4 of its
8 virtual CPU devices (Pallas in interpret mode, as tests/test_parallel.py
and tests/test_slab.py run it) and against the port's single-device mode.

The port runs on the mesh ``[cpu] * D`` in this one process: nothing is
spawned and nothing can wait on a peer.
"""

import glob
import json
import logging
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pysco_tpu_torch
from pysco_tpu import solver as jsolver
from pysco_tpu.parallel import pm as jpm
from pysco_tpu_torch import integrate as tintegrate
from pysco_tpu_torch import solver as tsolver
from pysco_tpu_torch.cosmo import write_power_spectrum_table
from pysco_tpu_torch.ops import tiled_pm
from pysco_tpu_torch.parallel import mesh as pmesh
from pysco_tpu_torch.parallel import pm as par_pm
from pysco_tpu_torch.utils import io as iostream

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "golden_pk_32.json")


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def _cpu_mesh(d):
    return pmesh.make_mesh(devices=["cpu"] * d)


# ---------------------------------------------------------------------------
# The mesh and its collectives
# ---------------------------------------------------------------------------

def test_make_mesh():
    assert pmesh.make_mesh(device="cpu") == (torch.device("cpu"),)
    mesh = pmesh.make_mesh(devices=["cpu"] * 4)
    assert mesh == (torch.device("cpu"),) * 4  # repeats allowed
    assert len(pmesh.make_mesh(2, devices=["cpu"] * 4)) == 2
    with pytest.raises(ValueError, match="devices asked"):
        pmesh.make_mesh(8, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="empty"):
        pmesh.make_mesh(devices=[])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pmesh.make_mesh()
    with pytest.raises(ValueError, match="shards on a mesh"):
        pmesh.psum([torch.zeros(2)] * 3, mesh)


@pytest.mark.parametrize("d", [1, 2, 4])
def test_ppermute_and_all_to_all_match_numpy(d):
    rng = np.random.default_rng(d)
    xs = [rng.standard_normal((2 * d, 3, d)).astype(np.float32)
          for _ in range(d)]
    mesh = _cpu_mesh(d)
    ts = [_t(x) for x in xs]
    fwd = pmesh.ppermute_fwd(ts, mesh)
    bwd = pmesh.ppermute_bwd(ts, mesh)
    for r in range(d):
        np.testing.assert_array_equal(fwd[r].numpy(), xs[(r - 1) % d])
        np.testing.assert_array_equal(bwd[r].numpy(), xs[(r + 1) % d])
    # tiled all-to-all, both directions of the pencil transpose
    for split, concat in ((0, 2), (2, 0), (0, 1)):
        got = pmesh.all_to_all(ts, mesh, split, concat)
        for r in range(d):
            want = np.concatenate(
                [np.split(x, d, axis=split)[r] for x in xs], axis=concat)
            np.testing.assert_array_equal(got[r].numpy(), want)
    back = pmesh.all_to_all(pmesh.all_to_all(ts, mesh, 0, 2), mesh, 2, 0)
    for r in range(d):
        np.testing.assert_array_equal(back[r].numpy(), xs[r])
    if d > 1:
        with pytest.raises(ValueError, match="does not split"):
            pmesh.all_to_all([t[:1] for t in ts], mesh, 0, 1)


@pytest.mark.parametrize("d", [1, 2, 4])
def test_scatter_replicate_gather_match_numpy(d):
    rng = np.random.default_rng(20 + d)
    a = rng.standard_normal((4, 8 * d, 3)).astype(np.float32)
    mesh = _cpu_mesh(d)
    for axis in (1, 0):
        pieces = pmesh.scatter(_t(a), mesh, axis)
        assert len(pieces) == d
        for got, want in zip(pieces, np.split(a, d, axis=axis)):
            assert got.is_contiguous()
            np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            pmesh.gather(pieces, axis, "cpu").numpy(), a)
    copies = pmesh.replicate(_t(a), mesh)
    assert len(copies) == d and all(c is copies[0] for c in copies)
    np.testing.assert_array_equal(copies[-1].numpy(), a)
    if d > 1:
        with pytest.raises(ValueError, match="does not split"):
            pmesh.scatter(_t(a)[:, :d + 1], mesh, 1)


@pytest.mark.parametrize("d", [1, 2, 4])
def test_reductions_match_numpy_in_shard_order(d):
    """psum adds in the order 0, 1, ..., D-1: bitwise the sequential
    float32 sum, on any layout of the same D; pmax and pmean likewise."""
    rng = np.random.default_rng(10 + d)
    xs = [(rng.standard_normal((64, 64)) * 10.0 ** rng.integers(-3, 4))
          .astype(np.float32) for _ in range(d)]
    want = xs[0].copy()
    for x in xs[1:]:
        want = want + x
    for mesh in (_cpu_mesh(d), pmesh.make_mesh(d, devices=["cpu"] * 8)):
        got = pmesh.psum([_t(x) for x in xs], mesh)
        assert len(got) == d
        for g in got:
            np.testing.assert_array_equal(g.numpy(), want)
    if d > 2:  # another order gives other bits: the order is the contract
        other = xs[-1].copy()
        for x in xs[:-1]:
            other = other + x
        assert not np.array_equal(other, want)
    mx = pmesh.pmax([_t(x).max() for x in xs], _cpu_mesh(d))
    assert float(mx[0]) == max(float(x.max()) for x in xs)
    mean = pmesh.pmean([_t(x) for x in xs], _cpu_mesh(d))
    np.testing.assert_array_equal(mean[d - 1].numpy(),
                                  want / np.float32(d))


# ---------------------------------------------------------------------------
# The replicated step
# ---------------------------------------------------------------------------

_EXTRA = {"fR_logfR0": 5.0, "Om_lambda": 0.7, "Om_r": 0.0, "w0": -1.0,
          "wa": 0.0, "mond_g0": 1.2, "mond_scale_factor_exponent": 0.0}


def _param(theory, solver_name, engine, **kw):
    units = ({"unit_l": 3085.0, "unit_t": 1e10} if theory == "mond"
             else {"unit_l": 1.0, "unit_t": 1.0})
    param = {
        "theory": theory, "ncoarse": 4, "npart": 16 ** 3,
        "mass_scheme": "tsc", "linear_newton_solver": solver_name,
        "gradient_stencil_order": 5, "Npre": 2, "Npost": 1, "fR_n": 1,
        "mond_function": "simple", "mond_alpha": 1.0, "aexp": 0.2,
        "Om_m": 0.3, "epsrel": 1e-3, "particle_engine": engine,
        **_EXTRA, **units,
    }
    param.update(kw)
    return param


def _rows(seed):
    rng = np.random.default_rng(seed)
    pos = rng.random((16 ** 3, 3), dtype=np.float32)
    vel = (0.02 * rng.standard_normal((16 ** 3, 3))).astype(np.float32)
    return pos, vel


def _matched(got, want):
    """``got``'s rows in the order of ``want``'s, each particle paired with
    the nearest in the periodic box, one to one."""
    from scipy.spatial import cKDTree

    tree = cKDTree(np.mod(got[0].astype(np.float64), 1.0), boxsize=1.0)
    dist, idx = tree.query(np.mod(want[0].astype(np.float64), 1.0))
    assert len(np.unique(idx)) == len(idx) == len(got[0])
    return tuple(a[idx] for a in got), dist


def _assert_rows_close(got, want, what, tol):
    got, dist = _matched(got, want)
    assert dist.max() <= tol, f"{what}: positions {dist.max():.2e}"
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, rtol=0, atol=tol * np.abs(w).max(),
                                   err_msg=what)


def _real_rows(cfg, *arrays):
    """Sharded (or single) particle arrays of either package -> (n, 3)
    rows of the real particles (the tiled engine's sentinel columns sit at
    every shard's end)."""
    arrays = [np.asarray(a) for a in arrays]
    if arrays[0].ndim == 2 and arrays[0].shape[0] == 4:
        real = arrays[0][0] < tiled_pm.SENTINEL_MIN
        return tuple(a[:3, real].T for a in arrays)
    return tuple(arrays)


@pytest.mark.parametrize("theory,solver_name,engine,n_dev", [
    ("newton", "fft", "pallas", 4),
    ("newton", "fft", "scatter", 4),
    ("newton", "fft", "pallas", 2),
    ("newton", "multigrid", "pallas", 4),
    ("fr", "multigrid", "pallas", 4),
    ("mond", "multigrid", "scatter", 4),
    ("mond", "fft_7pt", "pallas", 1),
    ("newton", "fft", "dense", 2),
])
def test_replicated_step_matches_jax_and_single(theory, solver_name, engine,
                                                n_dev):
    """The first force evaluation (a zero-dt first-call step) and two
    steps in replicated mode against the JAX package's make_sharded_step on
    as many virtual devices, and against the port's own single-device step.
    The FFT rows are held to 1e-5. The multigrid solves stop on a
    tolerance (epsrel = 1e-3 of the truncation error), so roundoff in the
    summed grids moves their result by a fraction of it: the linear
    multigrid rows are held to 2e-4 (the bar of tests/test_parallel.py for
    the fields); the f(R) row to 2e-3, since its FAS solve may stop one
    cycle apart (measured 1.1e-3 of the largest acceleration between the
    port's replicated and single steps)."""
    param = _param(theory, solver_name, engine)
    pos, vel = _rows(7)
    dt = 5e-3
    tol = 1e-5
    if solver_name == "multigrid":
        tol = 2e-3 if theory == "fr" else 2e-4
    cfg = tsolver.config_from_param(param)
    dyn = tsolver.compute_dynamics(param)
    mesh = _cpu_mesh(n_dev)
    p0, v0 = (tiled_pm.to_columns_host(pos, vel, cfg.npart)
              if engine == "pallas" else (pos, vel))
    phi0, u0 = tsolver.empty_fields(cfg, "cpu")
    state = par_pm.shard_state(mesh, p0, v0, np.zeros_like(p0), phi0, u0)
    assert len(state[0]) == n_dev and state[3][0] is state[3][-1]
    out = par_pm.make_sharded_step(cfg, mesh, "leapfrog", first_call=True)(
        *state, dyn, 0.0)
    step = par_pm.make_sharded_step(cfg, mesh, "leapfrog")
    for _ in range(2):
        out = step(*out[:5], dyn, dt)
        assert int(out[6].overflow) == 0
    got = _real_rows(cfg, *(x.numpy() for x in par_pm.gather_state(*out[:3])))
    assert got[0].shape == (cfg.npart, 3)

    # the port's single-device step, the same schedule
    ref = tsolver.pm(cfg, True, False, _t(p0), _t(v0), phi0, u0, dyn)
    st = ref[:5]
    for _ in range(2):
        st = tintegrate.step_impl(cfg, "leapfrog", False, False, *st, dyn,
                                  dt)[:5]
    want = tsolver.particles_to_rows(cfg, st[0], st[1], st[2])
    _assert_rows_close(got, want, "port replicated vs port single", tol)
    torch.testing.assert_close(out[3][0], st[3], rtol=0,
                               atol=tol * float(st[3].abs().max()) + 1e-12)

    # the JAX package, replicated on n_dev virtual devices
    jcfg = jsolver.config_from_param(param)
    jdyn = jsolver.compute_dynamics(param)
    jmesh = jpm.make_mesh(n_dev)
    jphi, ju = jsolver.empty_fields(jcfg)
    jstate = jpm.shard_state(jmesh, jnp.asarray(p0), jnp.asarray(v0),
                             jnp.zeros_like(jnp.asarray(p0)), jphi, ju)
    jout = jpm.make_sharded_step(jcfg, jmesh, "leapfrog", first_call=True)(
        *jstate, jdyn, np.float32(0))
    jstep = jpm.make_sharded_step(jcfg, jmesh, "leapfrog")
    for _ in range(2):
        jout = jstep(*jout[:5], jdyn, np.float32(dt))
    jwant = _real_rows(jcfg, *jout[:3])
    _assert_rows_close(got, jwant, "port replicated vs JAX replicated", tol)
    assert float(out[6].max_abs_acc) == pytest.approx(
        float(jout[6].max_abs_acc), rel=10 * tol)
    if theory == "fr":  # the scalaron's mean, close to 1
        assert float(out[6].mean_additional) == pytest.approx(
            float(jout[6].mean_additional), rel=tol)


def test_replicated_step_euler_save_pk_and_checks():
    """The Euler integrator with a P(k): the replicated P(k) is the
    single-device one (the grids are summed in another order: 1e-5); a
    particle count that does not shard raises."""
    param = _param("newton", "fft", "pallas")
    pos, vel = _rows(8)
    cfg = tsolver.config_from_param(param)
    dyn = tsolver.compute_dynamics(param)
    mesh = _cpu_mesh(4)
    p0, v0 = tiled_pm.to_columns_host(pos, vel, cfg.npart)
    phi0, u0 = tsolver.empty_fields(cfg, "cpu")
    state = par_pm.shard_state(mesh, p0, v0, np.zeros_like(p0), phi0, u0)
    out = par_pm.make_sharded_step(cfg, mesh, "euler", save_pk=True)(
        *state, dyn, 5e-3)
    ref = tintegrate.step_impl(cfg, "euler", False, True, _t(p0), _t(v0),
                               torch.zeros(p0.shape), phi0, u0, dyn, 5e-3)
    for a, b in zip(out[5], ref[5]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=0)
    got = _real_rows(cfg, *(x.numpy() for x in par_pm.gather_state(*out[:3])))
    want = tsolver.particles_to_rows(cfg, ref[0], ref[1], ref[2])
    _assert_rows_close(got, want, "euler", 1e-5)
    with pytest.raises(ValueError, match="aligned shards"):
        par_pm.make_sharded_step(cfg, _cpu_mesh(16))
    scatter = tsolver.config_from_param(_param("newton", "fft", "scatter"))
    with pytest.raises(ValueError, match="split evenly"):
        par_pm.make_sharded_step(scatter, _cpu_mesh(3))
    with pytest.raises(NotImplementedError, match="integrator"):
        par_pm.make_sharded_step(cfg, mesh, "rk4")


# ---------------------------------------------------------------------------
# The run loops
# ---------------------------------------------------------------------------

@pytest.fixture
def run_log(monkeypatch, caplog):
    """The root logger's records of a run: ``run`` installs its own handler
    with ``basicConfig(force=True)``, which would drop the capture, so that
    call is held off."""
    monkeypatch.setattr(logging, "basicConfig", lambda **kw: None)
    caplog.set_level(logging.WARNING)
    return caplog


def _pk_table(path):
    write_power_spectrum_table(str(path))
    return str(path)


def _run_param(tmp_path, tag, **kw):
    param = {
        "theory": "newton", "H0": 72, "Om_m": 0.25733, "T_cmb": 2.726,
        "N_eff": 3.044, "w0": -1.0, "wa": 0.0, "boxlen": 100,
        "ncoarse": 5, "npart": 16 ** 3, "z_start": 49, "seed": 42,
        "position_ICS": "center", "fixed_ICS": False, "paired_ICS": False,
        "dealiased_ICS": False,
        "power_spectrum_file": _pk_table(tmp_path / "pk.dat"),
        "initial_conditions": "2LPT", "base": str(tmp_path / tag),
        "output_snapshot_format": "HDF5", "z_out": "[40]",
        "save_power_spectrum": "z_out", "integrator": "leapfrog",
        "mass_scheme": "TSC", "n_reorder": 50, "Courant_factor": 1.0,
        "max_aexp_stepping": 10, "linear_newton_solver": "fft",
        "gradient_stencil_order": 5, "Npre": 2, "Npost": 1,
        "epsrel": 1e-2, "verbose": 0, "parallel_mode": "slab",
    }
    param.update(kw)
    return param


def _pks(base):
    return {os.path.basename(f): np.loadtxt(f)
            for f in sorted(glob.glob(f"{base}/power/pk_*.dat"))}


def _last_snapshot(base):
    snap = sorted(glob.glob(f"{base}/output_*/particles_*.h5"))[-1]
    return (iostream.read_hdf5_snapshot_attrs(snap),
            *iostream.read_snapshot_particles_hdf5(snap))


@pytest.mark.parametrize("mode", ["slab", "replicated"])
def test_full_horizon_matches_golden(tmp_path, mode):
    """The configuration of tests/test_full_run_fidelity.py (z = 49 -> 0,
    tiled engine, lazy re-binning) through ``pysco_tpu_torch.run`` on four
    CPU shards: tests/golden_pk_32.json within 1e-4 on the bins with at
    least 8 modes, the JAX package's own bar."""
    param = _run_param(
        tmp_path, "run", fixed_ICS=True, z_out="[5, 1, 0]",
        output_snapshot_format="npz", particle_engine="pallas",
        lazy_sort=True, pm_precision_widened="bf16x3", parallel_mode=mode)
    recs = pysco_tpu_torch.run(param, device="cpu", devices=["cpu"] * 4)
    assert len(recs) > 20 and all(r.overflow == 0 for r in recs)
    if mode == "slab":
        drifts = [r.drift for r in recs]
        assert 0 in drifts[1:] and max(drifts) >= 1  # lazy and re-sorted
    else:
        assert not any(r.drift for r in recs)
    with open(GOLDEN) as f:
        golden = {k: np.array(v) for k, v in json.load(f).items()}
    got = _pks(param["base"])
    assert sorted(got) == sorted(golden)
    for name, a in got.items():
        b = golden[name]
        np.testing.assert_allclose(a[:, 0], b[:, 0], rtol=1e-6)
        np.testing.assert_array_equal(a[:, 2], b[:, 2])
        sel = a[:, 2] >= 8
        rel = np.abs(a[sel, 1] - b[sel, 1]) / np.abs(b[sel, 1])
        assert rel.max() < 1e-4, f"{mode} {name}: {rel.max():.2e}"


@pytest.mark.parametrize("mode,devices", [("slab", 1), ("slab", 2),
                                          ("replicated", 2)])
def test_run_modes_match_single(tmp_path, mode, devices):
    """A short run in each mode against the single mode: the same P(k)
    (1e-5) and the same particles (1e-5) at z = 40."""
    single = _run_param(tmp_path, "single", parallel_mode="single",
                        ic_device=False)
    pysco_tpu_torch.run(single, device="cpu")
    param = _run_param(tmp_path, mode, parallel_mode=mode)
    pysco_tpu_torch.run(param, device="cpu", devices=["cpu"] * devices)
    a, b = _pks(param["base"]), _pks(single["base"])
    assert a and sorted(a) == sorted(b)
    for name in a:
        np.testing.assert_array_equal(a[name][:, 2], b[name][:, 2])
        np.testing.assert_allclose(a[name][:, 1], b[name][:, 1], rtol=1e-5)
    _, pa, va = _last_snapshot(param["base"])
    _, pb, vb = _last_snapshot(single["base"])
    assert pa.shape == pb.shape == (16 ** 3, 3)
    _assert_rows_close((pa, va), (pb, vb), mode, 1e-5)


def test_run_slab_restart(tmp_path, run_log):
    """A slab run restarts from its own snapshot, and the restored
    ``parallel_mode`` is honoured when the restart's parameters leave it
    out; it then tracks the uninterrupted run."""
    whole = _run_param(tmp_path, "whole", z_out="[44, 42]",
                       save_power_spectrum="no")
    pysco_tpu_torch.run(whole, device="cpu", devices=["cpu"] * 4)
    first = _run_param(tmp_path, "parts", z_out="[44]",
                       save_power_spectrum="no")
    pysco_tpu_torch.run(first, device="cpu", devices=["cpu"] * 4)
    again = _run_param(tmp_path, "parts", z_out="[42]",
                       save_power_spectrum="no", initial_conditions=1,
                       verbose=1)
    del again["parallel_mode"]
    run_log.clear()
    pysco_tpu_torch.run(again, device="cpu", devices=["cpu"] * 4)
    assert "slab mode: 4 devices, 8 planes each" in run_log.text
    attrs, pa, va = _last_snapshot(first["base"])
    assert str(attrs["parallel_mode"]) == "slab"
    _, pb, vb = _last_snapshot(whole["base"])
    _assert_rows_close((pa, va), (pb, vb), "restart", 1e-5)


def test_run_slab_rebalance(tmp_path, run_log):
    """With a tiny headroom the run grows the shards' capacity (more slack,
    sentinel columns appended on each shard) before any particle is at
    risk, and the physics is untouched: the final snapshot is that of a
    run that never re-balances (tests/test_slab.py::test_run_slab_rebalance)."""
    def run(tag, headroom):
        param = _run_param(tmp_path, tag, z_out="[47]", verbose=1,
                           save_power_spectrum="no",
                           slab_rebalance_headroom=headroom)
        pysco_tpu_torch.run(param, device="cpu", devices=["cpu"] * 4)
        return _last_snapshot(param["base"])

    attrs_r, pos_r, vel_r = run("reb", 0.01)
    assert "re-balancing with slack 1.25 -> 1.88" in run_log.text
    # the grown slack goes into the snapshot: a restart inherits it
    assert float(attrs_r["slab_slack"]) > 1.25
    assert pos_r.shape == (16 ** 3, 3)
    _, pos_n, vel_n = run("plain", 1.0)
    _assert_rows_close((pos_r, vel_r), (pos_n, vel_n), "rebalance", 1e-6)


def test_run_slab_overflow_aborts_before_pk(tmp_path, monkeypatch):
    """A shard that overflows its capacity aborts the run (mass would be
    lost), before the step's P(k) is written; on_particle_overflow = warn
    carries on."""
    from pysco_tpu_torch.parallel import slab

    real_migrate = slab.migrate

    def lossy(*args, **kw):
        pos, vel, lost = real_migrate(*args, **kw)
        return pos, vel, [x + 3 for x in lost]

    param = _run_param(tmp_path, "ovf", save_power_spectrum="yes",
                       z_out="[46]")
    monkeypatch.setattr(slab, "migrate", lossy)
    with pytest.raises(RuntimeError, match="capacity overflow: 12 particles "
                                           "lost"):
        pysco_tpu_torch.run(param, device="cpu", devices=["cpu"] * 4)
    assert _pks(param["base"]) == {}
    warn = _run_param(tmp_path, "warn", save_power_spectrum="no",
                      z_out="[48]", on_particle_overflow="warn")
    recs = pysco_tpu_torch.run(warn, device="cpu", devices=["cpu"] * 4)
    assert recs and all(r.overflow == 12 for r in recs if r.drift == 0)


@pytest.mark.parametrize("overrides,match", [
    ({"particle_engine": "scatter"}, "runs only 'pallas'"),
    ({"integrator": "rk4"}, "integrator 'rk4'"),
    ({"theory": "fr", "fR_logfR0": 5, "fR_n": 3,
      "linear_newton_solver": "multigrid"}, "fR_n=3"),
    ({"theory": "mond", "mond_g0": 1.2, "mond_function": "simple",
      "mond_scale_factor_exponent": 0, "mond_alpha": 1,
      "linear_newton_solver": "fft"}, "requires multigrid or fft_7pt"),
    ({"parallel_mode": "pencil"}, "should be 'single', 'replicated' or"),
])
def test_run_slab_refuses(tmp_path, overrides, match):
    """Slab mode runs every theory and solver on the tiled engine; what it
    does not run (another engine, an unknown integrator, theory or mode)
    raises and names it, and nothing runs a single-device solve in its
    place or writes a P(k)."""
    param = _run_param(tmp_path, "no", **overrides)
    with pytest.raises(NotImplementedError, match=match):
        pysco_tpu_torch.run(param, device="cpu", devices=["cpu"] * 4)
    assert _pks(param["base"]) == {}


def test_run_replicated_scatter_engine(tmp_path):
    """The scatter engine in replicated mode (rows sharded, each shard's
    reordered among themselves) against the tiled engine in the same
    mode."""
    a = _run_param(tmp_path, "scatter", parallel_mode="replicated",
                   particle_engine="scatter", n_reorder=2)
    b = _run_param(tmp_path, "tiled", parallel_mode="replicated")
    for p in (a, b):
        pysco_tpu_torch.run(p, device="cpu", devices=["cpu"] * 4)
    pa, pb = _pks(a["base"]), _pks(b["base"])
    assert pa and sorted(pa) == sorted(pb)
    for name in pa:
        np.testing.assert_allclose(pa[name][:, 1], pb[name][:, 1], rtol=1e-4)

