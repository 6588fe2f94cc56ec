"""The f(R) n = 1 cell on the Newton roots (``fr1nroot512.lazy``): its
reference module ``reference/fr_n1.py`` (the cubic FAS run to its aim),
the cell rehearsed on the CPU at 16^3 through ``cell.run_cell``, and the
readers of the Newton-root span, the guard's counter and the sweep's
roofline: they read what the program records, and nothing where a program
without the span (the parent's) gives nothing."""

import importlib.util
import json
import math
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import cell
import check
import yardstick

TINY = {"ncoarse": 4, "npart": 16 ** 3, "boxlen": 64.0}
SEED = 2 ** 31 + 24024
CELL = "fr1nroot512.lazy"
CONFIG = "fr_n1_tsc_mg_nroot_512"
METRICS = ("newton_root_ms_per_step", "newton_root_guarded_per_step",
           "scalaron_sweep_roofline")


def _line(result):
    return json.loads(json.dumps(result))


def _config():
    return cell.load_json(cell.HERE / "configs" / f"{CONFIG}.json")


def _reference():
    spec = importlib.util.spec_from_file_location(
        "reference.fr_n1", cell.HERE / "reference" / "fr_n1.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _clustered(n, seed=5, sigma=1.5):
    """A lognormal density of mean 1 on n^3 cells, float64."""
    from reference import fas

    g = torch.Generator().manual_seed(seed)
    field = torch.randn((n, n, n), generator=g, dtype=torch.float64)
    for _ in range(2):
        field = 0.5 * field + fas._neighbours(field) / 12.0
    rho = torch.exp(sigma * field / field.std())
    return rho / rho.mean()


def test_reference_reaches_its_aim_where_fas_stagnates():
    """On a clustered 16^3 state at a = 1 ``fas.solve`` stops where a cycle
    gains less than a tenth, above its aim; ``fr_n1.solve`` goes on to
    the aim."""
    from reference import cosmology, fas
    from reference.precision import F64

    fr_n1 = _reference()
    param = dict(_config()["param"], ncoarse=4, npart=16 ** 3, boxlen=16.0)
    c = cosmology.fr_constants(cosmology.Cosmology(param), param, 1.0)
    b = c["f1"] * _clustered(16) + c["f2"]
    x0 = fas.first_guess(b, c["q"], F64)
    aim = 1e-3 * 0.01 * fas.truncation_error(x0, b, c["q"], F64)
    stopped = fas.solve(b, c["q"], None, 4, 2, 1, 0.01, F64)
    assert fas.residual(stopped, b, c["q"], F64) > aim
    stats = {}
    u = fr_n1.solve(b, c["q"], None, 4, 2, 1, 0.01, F64, stats)
    assert stats["aim"] == pytest.approx(aim)
    assert stats["residual"] <= aim < fas.residual(stopped, b, c["q"], F64)
    assert stats["cycles"] < fr_n1.MAX_CYCLES
    assert torch.isfinite(u).all() and (u > 0).all()


@pytest.mark.parametrize("change,match", [
    ({"theory": "newton"}, "multigrid"),
    ({"theory": "mond"}, "mond"),
    ({"fR_n": 2}, "n = 1"),
    ({"linear_newton_solver": "fft"}, "multigrid"),
    ({"linear_newton_solver": "fft_7pt"}, "fft_7pt"),
])
def test_reference_refuses_what_it_cannot_follow(change, match):
    fr_n1 = _reference()
    param = dict(_config()["param"], **change)
    with pytest.raises(NotImplementedError, match=match):
        fr_n1.Forces(param)


@pytest.mark.parametrize("scheme,p", [("NGP", 1), ("CIC", 2), ("TSC", 3)])
def test_reference_takes_every_mass_scheme(scheme, p):
    forces = _reference().Forces(dict(_config()["param"],
                                      mass_scheme=scheme))
    assert (forces.scheme, forces.p) == (scheme.lower(), p)


def test_configuration_loads_through_its_reference():
    conf = _config()
    assert conf["reference"] == "fr_n1"
    p = conf["param"]
    assert (p["theory"], p["fR_n"], p["mass_scheme"], p["fR_root_solver"],
            p["linear_newton_solver"]) == ("fr", 1, "TSC", "newton",
                                           "multigrid")
    ref = check.reference_for(CONFIG, conf, p, cell.HERE)
    assert ref.__name__ == "reference.fr_n1"
    # fr_n1_mg_cic_512's parameters but for the scheme and the roots
    base = cell.load_json(cell.HERE / "configs" / "fr_n1_mg_cic_512.json")
    assert {k: v for k, v in p.items() if base["param"].get(k) != v} == {
        "mass_scheme": "TSC", "fR_root_solver": "newton"}


def test_cell_is_the_configuration_it_names():
    bench = cell.spec()
    w = cell.find_workload(bench, CELL)
    assert (w["config"], w["traffic"], w["chips"]) == (CONFIG, "lazy", 1)
    per_layer = {m["name"] for m in cell.metrics_of(bench, CELL,
                                                    "per_layer")}
    assert per_layer == set(METRICS)


def test_fr1nroot_cell_on_cpu():
    """The program's Newton-root step against the reference, within the
    cell's limits."""
    res = _line(cell.run_cell(CELL, SEED, 1.0, False, "cpu",
                              overrides=TINY))
    assert res["correct"] is True
    assert res["attempted"] > 0 and res["failed"] == 0
    assert {"step_ms", "setup_s"} <= set(res["metrics"])
    for name, (value, limit) in res["checks"].items():
        assert value <= limit, name


def test_traced_cell_reports_the_newton_root_metrics():
    from pysco_tpu_torch.utils import profiling

    profiling.reset_spans()
    res = _line(cell.run_cell(CELL, SEED, 1.0, True, "cpu",
                              overrides=TINY))
    assert res["correct"] is True
    m = res["metrics"]
    assert set(METRICS) <= set(m)
    steps = res["run"]["traced_steps"]
    totals = profiling.span_totals(last_steps=steps)
    spans = totals["spans"]
    assert m["newton_root_ms_per_step"]["value"] == pytest.approx(
        spans["mg.newton_root"]["device_ms"] / steps)
    assert 0 < spans["mg.newton_root"]["device_ms"] <= spans["mg.smooth"][
        "device_ms"]
    assert m["newton_root_guarded_per_step"]["value"] == totals[
        "counters"].get("newton_root_guarded", 0) / steps
    roots = [r for r in profiling.span_records()
             if r["name"] == "mg.newton_root"]
    assert len(roots) >= spans["mg.newton_root"]["calls"]
    assert all(r["counters"]["newton_root_sweeps"] >= 2 for r in roots)
    assert 0 < m["scalaron_sweep_roofline"]["value"] < 100


def _ctx(**kw):
    base = dict(steps=4, npart=64 ** 3, n=64, kernels={}, launches={})
    base.update(kw)
    return SimpleNamespace(**base)


def test_readers_give_nothing_without_the_span():
    """An empty store, and a parent's traced step: an FAS smoothing that
    opens no ``mg.newton_root`` (the exact roots' span and counter
    only)."""
    from pysco_tpu_torch.utils import profiling

    profiling.reset_spans()
    for name in METRICS:
        assert cell.metric_reader(name)(_ctx()) is None, name
    x = torch.zeros(4)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            for _ in range(4):
                with profiling.step_span(x):
                    with profiling.span("mg.smooth", 0):
                        with profiling.span("mg.exact_root"):
                            profiling.count("exact_root_sweeps", 6)
        assert profiling.span_totals(last_steps=4)["steps"] == 4
        for name in METRICS:
            assert cell.metric_reader(name)(_ctx()) is None, name
    finally:
        profiling.reset_spans()


def test_readers_read_span_counter_and_levels():
    """Two levels a step: level 0 (64^3, no coefficient plane) with 6
    colour updates and level 1 (32^3, with the plane) with 4; the
    roofline is their bytes over 3.35 TB/s in the spans' device time."""
    from pysco_tpu_torch.utils import profiling

    profiling.reset_spans()
    x = torch.zeros(4)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            for _ in range(4):
                with profiling.step_span(x):
                    for level, sweeps in ((0, 6), (1, 4)):
                        with profiling.span("mg.smooth", level):
                            with profiling.span(
                                    "mg.newton_root", level,
                                    {"newton_root_sweeps": sweeps}):
                                profiling.count("newton_root_guarded", 3)
        t = profiling.span_totals(last_steps=4)
        ms = t["spans"]["mg.newton_root"]["device_ms"]
        assert cell.metric_reader("newton_root_ms_per_step")(
            _ctx()) == pytest.approx(ms / 4)
        assert cell.metric_reader("newton_root_guarded_per_step")(
            _ctx()) == 6
        moved = 4 * (6 * yardstick.scalaron_sweep_bytes(64, False)
                     + 4 * yardstick.scalaron_sweep_bytes(32, True))
        want = 100.0 * moved / yardstick.HBM_BYTES_PER_S / (ms / 1e3)
        assert cell.metric_reader("scalaron_sweep_roofline")(
            _ctx()) == pytest.approx(want)
        assert math.isfinite(want)
    finally:
        profiling.reset_spans()
