"""The run extras of the port against the JAX package on the CPU:
``run_paired``, the verbose = 2 per-cycle residual log and component
breakdown, the ``profile_dir`` profiler hook, the profiling decorators,
and Morton reordering of the scatter engine every ``n_reorder`` steps."""

import glob
import logging
import os

import numpy as np
import pytest
import torch

import pysco_tpu
import pysco_tpu_torch
from pysco_tpu_torch import main as main_mod
from pysco_tpu_torch.cosmo import write_power_spectrum_table
from pysco_tpu_torch.models import multigrid
from pysco_tpu_torch.ops import stencil, tiled_pm
from pysco_tpu_torch.utils import profiling

torch.set_num_threads(1)


def _param(tmp_path, tag, **kw):
    """The configuration of tests/test_e2e.py::test_run_paired: 16^3
    particles on a 16^3 grid, 1LPT, FFT, z = 49 -> 44."""
    pk_file = tmp_path / "pk.dat"
    if not pk_file.exists():
        write_power_spectrum_table(str(pk_file))
    param = {
        "theory": "newton", "H0": 72, "Om_m": 0.25733, "T_cmb": 2.726,
        "N_eff": 3.044, "w0": -1.0, "wa": 0.0, "boxlen": 100,
        "ncoarse": 4, "npart": 16 ** 3, "z_start": 49, "seed": 7,
        "position_ICS": "center", "dealiased_ICS": False,
        "power_spectrum_file": str(pk_file),
        "initial_conditions": "1LPT", "base": str(tmp_path / tag),
        "output_snapshot_format": "HDF5", "z_out": "[44]",
        "save_power_spectrum": "z_out", "integrator": "leapfrog",
        "mass_scheme": "TSC", "n_reorder": 50, "Courant_factor": 1.0,
        "max_aexp_stepping": 10, "linear_newton_solver": "fft",
        "gradient_stencil_order": 5, "Npre": 2, "Npost": 1,
        "epsrel": 1e-2, "verbose": 0,
    }
    param.update(kw)
    return param


def _pks(base, sub="power"):
    return {os.path.basename(f): np.loadtxt(f)
            for f in sorted(glob.glob(f"{base}/{sub}/pk_*.dat"))}


def _max_rel(pks_a, pks_b):
    """tests/test_full_run_fidelity.py's rule: identical k bins and mode
    counts; the largest relative P(k) difference on bins with >= 8 modes
    (of the summed counts, for pair-averaged files)."""
    assert pks_a and set(pks_a) == set(pks_b)
    worst = 0.0
    for name, a in pks_a.items():
        b = pks_b[name]
        np.testing.assert_allclose(a[:, 0], b[:, 0], rtol=1e-6)
        np.testing.assert_array_equal(a[:, 2], b[:, 2])
        sel = a[:, 2] >= 8
        worst = max(worst, float((np.abs(a[sel, 1] - b[sel, 1])
                                  / np.abs(b[sel, 1])).max()))
    return worst


def test_run_paired_matches_jax(tmp_path):
    pj = _param(tmp_path, "jax")
    pt = _param(tmp_path, "torch")
    pysco_tpu.run_paired(pj)
    pysco_tpu_torch.run_paired(pt, device="cpu")
    avg_t, avg_j = _pks(pt["base"]), _pks(pj["base"])
    # the two packages sum deposits and FFTs in other orders: float32
    # roundoff over two steps (measured 1.1e-6; the golden run's agreement
    # is 1.4e-6), far under the bound of tests/test_full_run_fidelity.py
    assert _max_rel(avg_t, avg_j) < 1e-4
    pair_a = _pks(pt["base"], "pair_A/power")
    pair_b = _pks(pt["base"], "pair_B/power")
    assert set(avg_t) == set(pair_a) == set(pair_b)
    for name, m in avg_t.items():
        a, b = pair_a[name], pair_b[name]
        np.testing.assert_array_equal(m[:, 0], a[:, 0])
        np.testing.assert_allclose(m[:, 1], 0.5 * (a[:, 1] + b[:, 1]),
                                   rtol=1e-12)
        np.testing.assert_array_equal(m[:, 2], a[:, 2] + b[:, 2])
        assert not np.array_equal(a[:, 1], b[:, 1])  # two phases
        with open(f"{pt['base']}/power/{name}") as f, \
                open(f"{pj['base']}/power/{name}") as g:
            assert f.readline() == g.readline()  # the same header
    for tag in ("pair_A", "pair_B"):
        assert glob.glob(f"{pt['base']}/{tag}/output_00001/particles_*.h5")


def test_run_paired_requires_cuda_unless_told_otherwise(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pysco_tpu_torch.run_paired(_param(tmp_path, "x"))
    assert not os.path.exists(tmp_path / "x")


@pytest.fixture
def run_log(monkeypatch, caplog):
    """The root logger's records of a run: ``run`` installs its own
    handler with ``basicConfig(force=True)``, which would drop the
    capture, so that call is held off and the level kept at INFO. Both
    verbosities below then differ only in what ``run`` switches on."""
    monkeypatch.setattr(logging, "basicConfig", lambda **kw: None)
    monkeypatch.setattr(multigrid, "LOG_RESIDUALS", False)
    caplog.set_level(logging.INFO)
    return caplog


def _mg_param(tmp_path, tag, **kw):
    return _param(tmp_path, tag, linear_newton_solver="multigrid",
                  initial_conditions="2LPT", seed=42, **kw)


def test_verbose_two_logs_residuals_and_breakdown(tmp_path, run_log):
    multigrid.reset_stats()
    recs1 = pysco_tpu_torch.run(_mg_param(tmp_path, "v1", verbose=1),
                                device="cpu")
    stats1 = dict(multigrid.STATS)
    text = [r.getMessage() for r in run_log.records]
    assert not any(m.startswith("multigrid: cycle") for m in text)
    assert not any("component timings" in m for m in text)
    assert multigrid.LOG_RESIDUALS is False

    run_log.clear()
    multigrid.reset_stats()
    recs2 = pysco_tpu_torch.run(_mg_param(tmp_path, "v2", verbose=2),
                                device="cpu")
    text = [r.getMessage() for r in run_log.records]
    cycles = [m for m in text if m.startswith("multigrid: cycle")]
    # one line a cycle of the run's own solves; the breakdown's solves
    # neither log nor count
    assert len(cycles) == multigrid.STATS["cycles"] > 0
    assert dict(multigrid.STATS) == stats1
    assert cycles[0].startswith("multigrid: cycle 1 residual error ")
    assert "(tolerance " in cycles[0]
    lines = [m for m in text if "force-evaluation component timings" in m]
    assert len(lines) == 1
    for key in ("tile_sort_ms", "deposit_ms", "solve_plus_gradient_ms",
                "gather_ms"):
        assert f"'{key}': " in lines[0]
    assert [r.launches for r in recs2] == [r.launches for r in recs1]
    assert len(recs2) == len(recs1)
    # the hooks change no result
    np.testing.assert_array_equal(
        list(_pks(tmp_path / "v1").values())[0],
        list(_pks(tmp_path / "v2").values())[0])
    # a later run at a lower verbosity switches the residual lines off
    pysco_tpu_torch.run(_mg_param(tmp_path, "v0", verbose=0), device="cpu")
    assert multigrid.LOG_RESIDUALS is False


def test_residual_log_line_is_the_jax_text(run_log):
    """The line of ``pysco_tpu.models.multigrid._converge``: the cycle
    counted from 1, err and tol as %.3e."""
    multigrid.set_residual_logging(True)
    errs = iter([4.0, 1.0, 0.9])
    multigrid._converge(torch.zeros(()), None, lambda x, b: x,
                        lambda x, b: torch.tensor(next(errs)), 1e-3)
    got = [r.getMessage() for r in run_log.records]
    assert got == [
        "multigrid: cycle 1 residual error 4.000e+00 (tolerance 1.000e-03)",
        "multigrid: cycle 2 residual error 1.000e+00 (tolerance 1.000e-03)",
        "multigrid: cycle 3 residual error 9.000e-01 (tolerance 1.000e-03)",
    ]


def test_component_breakdown_leaves_counters(tmp_path):
    """The four keys, positive times, and the launch counts, multigrid
    statistics and residual-logging flag as they were found."""
    from pysco_tpu_torch import cosmo, solver
    from pysco_tpu_torch.utils.config import params_from_dict, with_defaults
    from pysco_tpu_torch.utils.units import set_units

    param = with_defaults(params_from_dict(_mg_param(tmp_path, "cb")))
    cosmo.generate(param)
    param["aexp"] = 1.0 / 50.0
    set_units(param)
    cfg = solver.config_from_param(param)
    dyn = solver.compute_dynamics(param)
    rng = np.random.default_rng(3)
    pos, vel = tiled_pm.to_columns_host(
        rng.random((16 ** 3, 3), dtype=np.float32),
        np.zeros((16 ** 3, 3), np.float32), cfg.npart)
    pos, vel = torch.as_tensor(pos), torch.as_tensor(vel)
    multigrid.STATS.update(solves=5, cycles=11)
    stencil.LAUNCHES["half_sweep"] = 7
    multigrid.set_residual_logging(True)
    try:
        before = (dict(multigrid.STATS), dict(stencil.LAUNCHES),
                  dict(tiled_pm.LAUNCHES))
        out = profiling.component_breakdown(cfg, pos, vel, dyn, iters=1)
        assert (dict(multigrid.STATS), dict(stencil.LAUNCHES),
                dict(tiled_pm.LAUNCHES)) == before
        assert multigrid.LOG_RESIDUALS is True
    finally:
        multigrid.set_residual_logging(False)
        multigrid.reset_stats()
        stencil.reset_launches()
    assert list(out) == ["tile_sort_ms", "deposit_ms",
                         "solve_plus_gradient_ms", "gather_ms"]
    assert all(v >= 0 and round(v, 1) == v for v in out.values())
    assert out["solve_plus_gradient_ms"] > 0


def test_breakdown_gate_and_memory_error(tmp_path, run_log, monkeypatch):
    """The breakdown runs on the tiled engine only; running out of device
    memory there is logged and the run goes on, any other error rises."""
    calls = []

    def boom(*a, **k):
        calls.append(1)
        raise torch.cuda.OutOfMemoryError("out of memory")

    monkeypatch.setattr(profiling, "component_breakdown", boom)
    pysco_tpu_torch.run(_param(tmp_path, "sc", verbose=2,
                               particle_engine="scatter"), device="cpu")
    assert not calls
    recs = pysco_tpu_torch.run(_param(tmp_path, "oom", verbose=2),
                               device="cpu")
    assert len(calls) == 1 and len(recs) == 2
    assert any("component timing breakdown skipped (OutOfMemoryError"
               in r.getMessage() for r in run_log.records)

    def bad(*a, **k):
        raise ValueError("not a memory error")

    monkeypatch.setattr(profiling, "component_breakdown", bad)
    with pytest.raises(ValueError, match="not a memory error"):
        pysco_tpu_torch.run(_param(tmp_path, "err", verbose=2), device="cpu")


def test_profile_dir_traces_step_two_only(tmp_path, monkeypatch):
    real = profiling.trace
    seen = []

    def counting(log_dir, device=None):
        seen.append(log_dir)
        return real(log_dir, device)

    monkeypatch.setattr(profiling, "trace", counting)
    out = tmp_path / "trace"
    recs = pysco_tpu_torch.run(
        _param(tmp_path, "prof", profile_dir=str(out), z_out="[35]"),
        device="cpu")
    assert len(recs) >= 3 and seen == [str(out)]  # step 2 of 3 or more
    files = os.listdir(out)
    assert files == ["pysco_tpu_torch_trace.json"]
    assert os.path.getsize(out / files[0]) > 1000
    with open(out / files[0]) as f:
        assert '"traceEvents"' in f.read(100000)
    # no profile_dir, no trace; a one-step run never reaches step 2
    pysco_tpu_torch.run(_param(tmp_path, "noprof", z_out="[35]"),
                        device="cpu")
    pysco_tpu_torch.run(_param(tmp_path, "one", profile_dir=str(out),
                               z_out="[48.5]"), device="cpu")
    assert len(seen) == 1


def test_time_me_and_profile_me(tmp_path, run_log, monkeypatch):
    monkeypatch.chdir(tmp_path)

    @profiling.time_me
    def add(a, b):
        return {"sum": (a + b, [a])}

    @profiling.profile_me
    def mul(a, b):
        return a * b

    x = torch.ones(3)
    assert torch.equal(add(x, x)["sum"][0], 2 * x)
    assert torch.equal(mul(x, 3.0), 3 * x)
    text = [r.getMessage() for r in run_log.records]
    assert any(m.startswith("add took ") and m.endswith(" s") for m in text)
    assert "Profiling: wrote mul.prof (inspect with snakeviz/pstats)" in text
    assert os.path.getsize(tmp_path / "mul.prof") > 0
    assert add.__name__ == "add" and mul.__name__ == "mul"


def test_scatter_run_with_reorder_matches_jax(tmp_path, run_log):
    """The scatter engine reordered by Morton key every 2 steps, through
    both packages: P(k) within 1e-4 on bins with >= 8 modes, the bar of
    tests/test_full_run_fidelity.py (``index_add_`` sums in memory order,
    so a reordered run is not bitwise the unreordered one)."""
    kw = dict(particle_engine="scatter", n_reorder=2, z_out="[40]",
              verbose=2)
    pj = _param(tmp_path, "jax", **kw)
    pt = _param(tmp_path, "torch", **kw)
    pysco_tpu.run(pj)
    recs = pysco_tpu_torch.run(pt, device="cpu")
    n_log = sum(r.getMessage() == "Reordering particles"
                for r in run_log.records if "pysco_tpu_torch" in r.pathname)
    assert n_log == len(recs) // 2 > 0
    # measured 5.5e-7
    assert _max_rel(_pks(pt["base"]), _pks(pj["base"])) < 1e-4
    # against the port's own run without reordering: the same physics
    plain = _param(tmp_path, "plain", **dict(kw, n_reorder=10 ** 6))
    pysco_tpu_torch.run(plain, device="cpu")
    assert _max_rel(_pks(pt["base"]), _pks(plain["base"])) < 1e-4
    # the tiled engine is never reordered
    run_log.clear()
    pysco_tpu_torch.run(_param(tmp_path, "tiled", n_reorder=1, verbose=2),
                        device="cpu")
    assert not any(r.getMessage() == "Reordering particles"
                   for r in run_log.records)
