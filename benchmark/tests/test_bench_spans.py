"""The per-layer readers of the program's own spans, counters and phases
(``benchmark/program_spans.py``), rehearsed on the CPU at 16^3: a traced
``fr512.lazy`` cell reports every one of them, and the spans add no
event to the profiler's list, so the device-trace readers read the same
with them as without."""

import contextlib

import numpy as np
import pytest

import cell
import devtrace

TINY = {"ncoarse": 4, "npart": 16 ** 3, "boxlen": 64.0}
SEED = 2 ** 31 + 4242
SPAN_SOURCES = ("program_span", "program_counter")
NEW = {"kdk_ms_per_step", "drift_check_ms_per_step", "tile_sort_ms_per_step",
       "deposit_ms_per_step", "field_solve_ms_per_step",
       "smoothing_ms_per_step", "gradient_ms_per_step", "gather_ms_per_step",
       "outside_step_ms_per_step", "host_syncs_per_step", "cosmo_s",
       "pk_bins_s"}


def test_traced_fr_cell_reports_every_span_metric():
    from pysco_tpu_torch.utils import profiling

    listed = {m["name"] for m in cell.metrics_of(cell.spec(), "fr512.lazy",
                                                 "per_layer")}
    assert NEW <= listed
    profiling.reset_spans()
    res = cell.run_cell("fr512.lazy", SEED, 1.0, True, "cpu",
                        overrides=TINY)
    assert res["correct"] is True
    for name in NEW:
        assert res["metrics"][name]["value"] is not None, name
    assert res["metrics"]["host_syncs_per_step"]["value"] > 0
    # the store holds the window's traced steps and nothing else
    steps = res["run"]["traced_steps"]
    roots = [r for r in profiling.span_records() if r["name"] == "step"]
    assert len(roots) == steps > 0
    totals = profiling.span_totals(last_steps=steps)
    assert res["metrics"]["deposit_ms_per_step"]["value"] == pytest.approx(
        totals["spans"]["pm.deposit"]["device_ms"] / steps)


def test_readers_give_nothing_without_spans():
    from types import SimpleNamespace

    from pysco_tpu_torch.utils import profiling

    profiling.reset_spans()
    ctx = SimpleNamespace(steps=4)
    for name in NEW - {"cosmo_s", "pk_bins_s"}:
        assert cell.metric_reader(name)(ctx) is None, name


def _fr_step():
    """A drift-1 lazy f(R) multigrid step at 16^3 from a fixed state."""
    import torch

    from pysco_tpu_torch import integrate, solver
    from pysco_tpu_torch.utils.units import set_units

    n = 16
    param = {"theory": "fr", "ncoarse": 4, "npart": n ** 3,
             "mass_scheme": "cic", "linear_newton_solver": "multigrid",
             "gradient_stencil_order": 5, "fR_n": 1, "fR_logfR0": 5.0,
             "aexp": 0.05, "Om_m": 0.3, "Om_lambda": 0.7, "Om_r": 8e-5,
             "w0": -1.0, "wa": 0.0, "epsrel": 1e-2, "H0": 72.0,
             "boxlen": 100.0}
    set_units(param)
    cfg = solver.config_from_param(param)
    dyn = solver.compute_dynamics(param)
    rng = np.random.default_rng(5)
    pos = rng.random((n ** 3, 3), dtype=np.float32)
    vel = (0.3 * rng.standard_normal((n ** 3, 3))).astype(np.float32)
    phi, u = solver.empty_fields(cfg, "cpu")
    p, v, ts, phi, u = solver.state_from_arrays(cfg, pos, vel, None,
                                                phi.numpy(), u.numpy(),
                                                "cpu")
    p, v, a, phi, u, _, _ = solver.pm(cfg, True, False, p, v, phi, u, dyn)
    state = integrate.step_lazy_impl(cfg, "leapfrog", 0, False, p, v, a,
                                     phi, u, ts, dyn, 1e-3)[:6]
    torch.set_num_threads(1)
    return lambda: integrate.step_lazy_impl(cfg, "leapfrog", 1, False,
                                            *state, dyn, 1e-3)


def _profiled(step):
    with devtrace.profiler(False) as prof:
        step()
    names = sorted(e.name() for e in prof.profiler.kineto_results.events())
    return devtrace.reduce(prof), names


def test_spans_add_no_profiler_event(monkeypatch):
    from pysco_tpu_torch.utils import profiling

    step = _fr_step()
    step()  # warm
    profiling.reset_spans()
    with_spans, names_with = _profiled(step)
    assert profiling.span_totals()["steps"] == 1
    profiling.reset_spans()
    for site in ("span", "step_span"):
        monkeypatch.setattr(profiling, site,
                            lambda *a, **k: contextlib.nullcontext())
    monkeypatch.setattr(profiling, "count", lambda *a, **k: None)
    alone, names_alone = _profiled(step)
    assert profiling.span_records() == []
    assert names_with == names_alone
    assert set(with_spans["kernels"]) == set(alone["kernels"])
    assert with_spans["busy_s"] == alone["busy_s"]
