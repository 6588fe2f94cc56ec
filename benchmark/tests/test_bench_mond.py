"""The QUMOND TSC cell (``mondtsc512.lazy``) rehearsed on the CPU at 16^3
through ``cell.run_cell``, and the readers of its three spans and of the
source's roofline: they read what the program records, and nothing where
a program without the spans (the parent's) gives nothing."""

import importlib.util
import json
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import cell
import yardstick

TINY = {"ncoarse": 4, "npart": 16 ** 3, "boxlen": 64.0}
SEED = 2 ** 31 + 21021
CELL = "mondtsc512.lazy"
SPANS = {"mond_newton_ms_per_step": "mond.newton",
         "mond_source_ms_per_step": "mond.source",
         "mond_potential_ms_per_step": "mond.potential"}
METRICS = tuple(SPANS) + ("mond_source_roofline",)


def _line(result):
    return json.loads(json.dumps(result))


def test_mondtsc_cell_on_cpu():
    res = _line(cell.run_cell(CELL, SEED, 1.0, False, "cpu",
                              overrides=TINY))
    assert res["correct"] is True
    assert res["attempted"] > 0 and res["failed"] == 0
    assert {"step_ms", "setup_s"} <= set(res["metrics"])
    for name, (value, limit) in res["checks"].items():
        assert value <= limit, name


def test_cell_is_the_configuration_it_names():
    bench = cell.spec()
    w = cell.find_workload(bench, CELL)
    conf = cell.load_json(cell.HERE / "configs" / f"{w['config']}.json")
    p = conf["param"]
    assert (p["theory"], p["mond_function"], p["mond_g0"],
            p["mond_scale_factor_exponent"], p["mond_alpha"]) == (
        "mond", "simple", 1.2, 0.0, 1.0)
    assert (p["mass_scheme"], p["linear_newton_solver"],
            p["multigrid_cycle"], p["Npre"], p["Npost"], p["epsrel"]) == (
        "TSC", "multigrid", "V", 2, 1, 0.01)
    assert (p["ncoarse"], p["npart"], p["boxlen"]) == (9, 512 ** 3, 500.0)
    assert conf["reference"] == "mond"
    assert w["chips"] == 1 and w["traffic"] == "lazy"
    per_layer = {m["name"] for m in cell.metrics_of(bench, CELL,
                                                    "per_layer")}
    assert per_layer == set(METRICS)


def test_traced_cell_reports_the_mond_metrics():
    from pysco_tpu_torch.utils import profiling

    profiling.reset_spans()
    try:
        res = _line(cell.run_cell(CELL, SEED, 1.0, True, "cpu",
                                  overrides=TINY))
        assert res["correct"] is True
        m = res["metrics"]
        assert set(m) == set(METRICS)
        steps = res["run"]["traced_steps"]
        spans = profiling.span_totals(last_steps=steps)["spans"]
        for name, span in SPANS.items():
            assert m[name]["value"] == pytest.approx(
                spans[span]["device_ms"] / steps)
            assert spans[span]["calls"] == steps  # one a force evaluation
        # the three cover the field solve but its host bookkeeping
        parts = sum(m[name]["value"] for name in SPANS)
        assert parts <= spans["pm.solve"]["device_ms"] / steps
    finally:
        profiling.reset_spans()


def _ctx(**kw):
    base = dict(steps=4, npart=64 ** 3, n=64, kernels={})
    base.update(kw)
    return SimpleNamespace(**base)


def test_readers_give_nothing_without_the_spans():
    """An empty store, and a parent's traced step: a field solve with no
    QUMOND spans."""
    from pysco_tpu_torch.utils import profiling

    profiling.reset_spans()
    try:
        for name in METRICS:
            assert cell.metric_reader(name)(_ctx()) is None, name
        x = torch.zeros(4)
        with profile(activities=[ProfilerActivity.CPU]):
            for _ in range(4):
                with profiling.step_span(x):
                    with profiling.span("pm.solve"):
                        pass
        assert profiling.span_totals(last_steps=4)["steps"] == 4
        for name in METRICS:
            assert cell.metric_reader(name)(_ctx()) is None, name
    finally:
        profiling.reset_spans()


def test_readers_read_the_spans():
    from pysco_tpu_torch.utils import profiling

    profiling.reset_spans()
    x = torch.zeros(4)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            for _ in range(4):
                with profiling.step_span(x):
                    with profiling.span("pm.solve"):
                        for span in SPANS.values():
                            with profiling.span(span):
                                pass
        spans = profiling.span_totals(last_steps=4)["spans"]
        for name, span in SPANS.items():
            assert cell.metric_reader(name)(_ctx()) == pytest.approx(
                spans[span]["device_ms"] / 4), name
        src = spans["mond.source"]
        least = 4 * 2 * 4 * 64 ** 3 / yardstick.HBM_BYTES_PER_S
        assert cell.metric_reader("mond_source_roofline")(
            _ctx()) == pytest.approx(100 * least / (src["device_ms"] / 1e3))
    finally:
        profiling.reset_spans()


@pytest.mark.parametrize("n", [16, 512])
def test_source_roofline_bytes_are_8_n_cubed(n):
    """phi_N read once, the source written once, float32: 8 n^3 bytes a
    call, 0.3205 ms at 512^3 over 3.35 TB/s."""
    spec = importlib.util.spec_from_file_location(
        "bench_metric_mond_source_roofline",
        cell.HERE / "metrics" / "mond_source_roofline.py")
    metric = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(metric)
    assert metric.source_bytes(n) == 8 * n ** 3
    if n == 512:
        ms = metric.source_bytes(n) / yardstick.HBM_BYTES_PER_S * 1e3
        assert ms == pytest.approx(0.3205, abs=1e-4)
