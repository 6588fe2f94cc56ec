"""The f(R) n = 2 TSC cell (``fr2tsc512.lazy``) rehearsed on the CPU at
16^3 through ``cell.run_cell``, and the readers of the exact-root span and
counter and of the TSC rooflines: they read what the program records, and
nothing where a program without the span (the parent's) or a run without
the kernels gives nothing."""

import json
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import cell
import yardstick

TINY = {"ncoarse": 4, "npart": 16 ** 3, "boxlen": 64.0}
SEED = 2 ** 31 + 17017
CELL = "fr2tsc512.lazy"
EXACT = ("exact_root_ms_per_step", "exact_root_sweeps_per_step")
TSC = ("deposit_roofline.tsc", "gather_roofline.tsc")


def _line(result):
    return json.loads(json.dumps(result))


def test_fr2tsc_cell_on_cpu():
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
    assert (p["theory"], p["fR_n"], p["mass_scheme"],
            p["fR_root_solver"]) == ("fr", 2, "TSC", "exact")
    assert conf["reference"] == "fr_n2"
    assert w["chips"] == 1 and w["traffic"] == "lazy"
    per_layer = {m["name"] for m in cell.metrics_of(bench, CELL,
                                                    "per_layer")}
    assert per_layer == set(EXACT + TSC)


@pytest.mark.parametrize("workload", ["fr512.lazy", CELL])
def test_traced_cell_reports_the_exact_root_metrics(workload):
    from pysco_tpu_torch.utils import profiling

    profiling.reset_spans()
    res = _line(cell.run_cell(workload, SEED, 1.0, True, "cpu",
                              overrides=TINY))
    assert res["correct"] is True
    m = res["metrics"]
    steps = res["run"]["traced_steps"]
    totals = profiling.span_totals(last_steps=steps)
    spans = totals["spans"]
    assert m["exact_root_ms_per_step"]["value"] == pytest.approx(
        spans["mg.exact_root"]["device_ms"] / steps)
    # inside the smoothing; at least one sweep (2 colour updates) a call
    assert 0 < spans["mg.exact_root"]["device_ms"] <= spans["mg.smooth"][
        "device_ms"]
    sweeps = totals["counters"]["exact_root_sweeps"]
    assert m["exact_root_sweeps_per_step"]["value"] == sweeps / steps
    assert sweeps % 2 == 0 and sweeps >= 2 * spans["mg.exact_root"]["calls"]
    # no kernel of the card ran: the rooflines report nothing
    assert not set(TSC) & set(m)


def _ctx(**kw):
    base = dict(steps=4, npart=64 ** 3, n=64, kernels={},
                launches={"deposit": 10, "gather": 10})
    base.update(kw)
    return SimpleNamespace(**base)


def test_exact_root_readers_give_nothing_without_the_span():
    """An empty store, and a parent's traced step: an FAS smoothing with
    the n = 1 counter but no ``mg.exact_root``."""
    from pysco_tpu_torch.utils import profiling

    profiling.reset_spans()
    for name in EXACT:
        assert cell.metric_reader(name)(_ctx()) is None, name
    x = torch.zeros(4)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            for _ in range(4):
                with profiling.step_span(x):
                    with profiling.span("mg.smooth", 0):
                        profiling.count("exact_root_sweeps", 6)
        assert profiling.span_totals(last_steps=4)["steps"] == 4
        for name in EXACT:
            assert cell.metric_reader(name)(_ctx()) is None, name
    finally:
        profiling.reset_spans()


def test_exact_root_readers_read_span_and_counter():
    from pysco_tpu_torch.utils import profiling

    profiling.reset_spans()
    x = torch.zeros(4)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            for _ in range(4):
                with profiling.step_span(x):
                    with profiling.span("mg.smooth", 0):
                        with profiling.span("mg.exact_root"):
                            profiling.count("exact_root_sweeps", 6)
        t = profiling.span_totals(last_steps=4)
        ms = cell.metric_reader("exact_root_ms_per_step")(_ctx())
        assert ms == pytest.approx(t["spans"]["mg.exact_root"]["device_ms"]
                                   / 4)
        assert cell.metric_reader("exact_root_sweeps_per_step")(
            _ctx()) == 6
    finally:
        profiling.reset_spans()


def test_tsc_rooflines_are_the_cic_readers():
    """Same kernels, same bytes: the TSC names read what deposit_roofline
    and gather_roofline read, and nothing where no kernel ran."""
    dep = yardstick.deposit_bytes(64 ** 3, 64)
    gat = yardstick.gather_bytes(64 ** 3, 64)
    kernels = {
        "(anonymous namespace)::deposit_tiles(float const*)":
            (10 * dep / yardstick.HBM_BYTES_PER_S * 20, 40),
        "(anonymous namespace)::gather_march(float const*)":
            (10 * gat / yardstick.HBM_BYTES_PER_S * 2, 10)}
    ctx = _ctx(kernels=kernels)
    assert cell.metric_reader("deposit_roofline.tsc")(ctx) == pytest.approx(
        5.0)
    assert cell.metric_reader("gather_roofline.tsc")(ctx) == pytest.approx(
        50.0)
    for name in TSC:
        assert cell.metric_reader(name)(_ctx()) is None, name
