"""The program's spans and counters (``pysco_tpu_torch.utils.profiling``)
on the CPU at 16^3: recorded only under a profiler, the step's tree,
the host-fetch counter against the multigrid statistics, sessions, the
last-k totals, the set-up phases, and the span track of the
``profile_dir`` trace on the profiler's own clock."""

import json
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import pysco_tpu_torch
from pysco_tpu_torch import cosmo, integrate, solver
from pysco_tpu_torch.cosmo import write_power_spectrum_table
from pysco_tpu_torch.models import multigrid
from pysco_tpu_torch.ops import fourier, tiled_pm
from pysco_tpu_torch.utils import profiling
from pysco_tpu_torch.utils.units import set_units

torch.set_num_threads(1)

N = 16
DT = 1e-3  # far under a cell of drift: a drift-1 window holds every step


def _param(**kw):
    p = {
        "theory": "newton", "ncoarse": 4, "npart": N ** 3,
        "mass_scheme": "cic", "linear_newton_solver": "fft",
        "gradient_stencil_order": 5, "Npre": 2, "Npost": 1, "fR_n": 1,
        "fR_logfR0": 5.0, "aexp": 0.1, "Om_m": 0.3, "Om_lambda": 0.7,
        "Om_r": 8e-5, "w0": -1.0, "wa": 0.0, "epsrel": 1e-2, "H0": 72.0,
        "boxlen": 100.0,
    }
    p.update(kw)
    set_units(p)
    return p


def _start(param, seed=0):
    """(cfg, dyn, state): the state after a first force evaluation and a
    sorting lazy step, as (position, velocity, acceleration, potential,
    u, tstarts)."""
    cfg = solver.config_from_param(param)
    dyn = solver.compute_dynamics(param)
    rng = np.random.default_rng(seed)
    pos = rng.random((N ** 3, 3), dtype=np.float32)
    pos[: N ** 3 // 2] = 0.3 + 0.3 * pos[: N ** 3 // 2]
    vel = (0.3 * rng.standard_normal((N ** 3, 3))).astype(np.float32)
    phi, u = solver.empty_fields(cfg, "cpu")
    p, v, ts, phi, u = solver.state_from_arrays(cfg, pos, vel, None,
                                                phi.numpy(), u.numpy(),
                                                "cpu")
    p, v, a, phi, u, _, _ = solver.pm(cfg, True, False, p, v, phi, u, dyn)
    out = integrate.step_lazy_impl(cfg, "leapfrog", 0, False, p, v, a, phi,
                                   u, ts, dyn, DT)
    return cfg, dyn, out[:6]


def _step(cfg, dyn, state, kind, save_pk=False):
    """One step: ``eager`` (step_impl), ``lazy_sort`` (a lazy step that
    sorts) or ``lazy_window`` (a drift-1 window, no sort). Returns the
    new state and every output tensor."""
    p, v, a, phi, u, ts = state
    if kind == "eager":
        out = integrate.step_impl(cfg, "leapfrog", False, save_pk, p, v, a,
                                  phi, u, dyn, DT)
        new = out[:5] + (ts,)
    else:
        level = 1 if kind == "lazy_window" else 0
        out = integrate.step_lazy_impl(cfg, "leapfrog", level, save_pk, p,
                                       v, a, phi, u, ts, dyn, DT)
        new = out[:6]
    tensors = [t for t in out if isinstance(t, torch.Tensor)]
    for extra in out:
        if isinstance(extra, tuple):  # P(k) and the diagnostics
            tensors += [t for t in extra if isinstance(t, torch.Tensor)]
    return new, tensors


def _profiler():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture(autouse=True)
def _fresh_store():
    profiling.reset_spans()
    yield
    profiling.reset_spans()


def test_no_profiler_records_nothing():
    cfg, dyn, state = _start(_param())
    for kind in ("eager", "lazy_sort", "lazy_window"):
        state, _ = _step(cfg, dyn, state, kind)
    assert profiling.span_records() == []
    assert profiling.span_totals()["steps"] == 0
    # the off path hands every site one shared object and allocates none
    assert profiling.span("pm.deposit") is profiling.span("mg.smooth", 3)
    assert profiling.step_span(state[0]) is profiling.span("x")
    profiling.count("host_syncs")
    assert profiling.span_records() == []


STEP_CHILDREN = {
    "eager": ["step.kick_drift", "pm.sort", "pm.deposit", "pm.solve",
              "pm.gradient", "pm.gather", "step.close"],
    "lazy_sort": ["step.kick_drift", "pm.sort", "pm.deposit",
                  "pm.power_spectrum", "pm.solve", "pm.gradient",
                  "pm.gather", "step.close"],
    "lazy_window": ["step.kick_drift", "pm.drift_check", "pm.deposit",
                    "pm.solve", "pm.gradient", "pm.gather", "step.close"],
}


@pytest.mark.parametrize("kind", sorted(STEP_CHILDREN))
def test_profiled_step_records_its_tree_bitwise(kind):
    cfg, dyn, state = _start(_param())
    save_pk = kind == "lazy_sort"
    _, plain = _step(cfg, dyn, state, kind, save_pk)
    assert profiling.span_records() == []
    with _profiler():
        _, traced = _step(cfg, dyn, state, kind, save_pk)
    assert len(plain) == len(traced) >= 7
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)
    recs = profiling.span_records()
    root = recs[0]
    assert (root["name"], root["parent"], root["level"]) == ("step", None,
                                                             None)
    assert [r["name"] for r in recs if r["name"] == "step"] == ["step"]
    children = [r for r in recs if r["parent"] == root["index"]]
    assert [r["name"] for r in children] == STEP_CHILDREN[kind]
    assert len(recs) == 1 + len(children)
    assert all(r["step"] == root["step"] for r in recs)
    for r in children:  # nested in the step on the host clock
        assert root["t0_ns"] <= r["t0_ns"] <= r["t1_ns"] <= root["t1_ns"]
        assert r["device_ms"] == r["host_ms"]  # no card: host time
    assert root["counters"] == {}  # the Newton FFT step fetches nothing


def test_fr_multigrid_counts_a_host_sync_per_solve_and_cycle():
    param = _param(theory="fr", linear_newton_solver="multigrid", aexp=0.05)
    cfg, dyn, state = _start(param)
    multigrid.reset_stats()
    with _profiler():
        _step(cfg, dyn, state, "lazy_window")
    stats = dict(multigrid.STATS)
    assert stats["fas_solves"] == 1 and stats["solves"] == 2
    totals = profiling.span_totals()
    assert totals["counters"] == {
        "host_syncs": stats["solves"] + stats["cycles"]}
    spans = totals["spans"]
    assert spans["mg.residual"]["calls"] == stats["cycles"]
    # a V-cycle at 16^3: two smoothings on levels 0 and 1 (16^3, 8^3),
    # one on the coarsest (4^3), a restriction and a prolongation between
    assert spans["mg.smooth"]["calls"] == 5 * stats["cycles"]
    assert spans["mg.restrict"]["calls"] == 2 * stats["cycles"]
    assert spans["mg.prolong"]["calls"] == 2 * stats["cycles"]
    assert spans["mg.newton_root"]["calls"] == 5 * stats["fas_cycles"]
    recs = profiling.span_records()
    solve = [r for r in recs if r["name"] == "pm.solve"]
    assert len(solve) == 1
    by_index = {r["index"]: r for r in recs}
    for r in recs:
        if r["name"] == "mg.newton_root":  # inside its smoothing call
            parent = by_index[r["parent"]]
            assert parent["name"] == "mg.smooth"
            assert parent["level"] == r["level"]
        elif r["name"].startswith("mg."):
            assert r["parent"] == solve[0]["index"]
    levels = {r["level"] for r in recs if r["name"] == "mg.smooth"}
    assert levels == {0, 1, 2}
    # the solve's own time is what its multigrid spans leave
    s = spans["pm.solve"]
    mg_ms = sum(spans[k]["device_ms"] for k in spans
                if k.startswith("mg.") and k != "mg.newton_root")
    assert s["self_device_ms"] == pytest.approx(s["device_ms"] - mg_ms)


def test_sessions_split_the_gaps_between_steps():
    cfg, dyn, state = _start(_param())
    with _profiler():
        for _ in range(2):
            state, _ = _step(cfg, dyn, state, "lazy_window")
    state, _ = _step(cfg, dyn, state, "lazy_window")  # untraced
    with _profiler():
        for _ in range(3):
            state, _ = _step(cfg, dyn, state, "lazy_window")
    roots = [r for r in profiling.span_records() if r["name"] == "step"]
    assert [r["session"] for r in roots] == [1, 1, 2, 2, 2]
    assert [r["gap_ms"] is None for r in roots] == [True, False, True,
                                                    False, False]
    gaps = profiling.span_totals()["outside_step_ms"]
    assert len(gaps) == 3 and min(gaps) >= 0
    for prev, r in zip(roots, roots[1:]):
        if r["gap_ms"] is not None:
            assert r["gap_ms"] == (r["t0_ns"] - prev["t1_ns"]) / 1e6


def test_device_counters_join_the_step_that_counted_them():
    """A kernel's counter tensor (csrc/deposit.cu's chunks) is handed out
    only inside a profiled step, read once as that step's counters when it
    closes, and starts the next step from zero; off the profiler, and
    outside a step, the wrapper gets None and the kernel counts nothing."""
    names = tiled_pm.DEPOSIT_COUNTERS
    like = torch.zeros(1)
    assert profiling.device_counters(names, "cpu") is None
    with _profiler():
        assert profiling.device_counters(names, "cpu") is None  # no step
        for chunks in (5, 7):
            with profiling.step_span(like):
                counts = profiling.device_counters(names, "cpu")
                assert counts.tolist() == [0, 0]
                counts += torch.tensor([chunks, 1])  # what a launch adds
                assert profiling.device_counters(names, "cpu") is counts
                counts += torch.tensor([chunks, 0])
    roots = [r for r in profiling.span_records() if r["name"] == "step"]
    assert [r["counters"] for r in roots] == [
        {"deposit_chunks": 10, "deposit_chunks_unbalanced": 1},
        {"deposit_chunks": 14, "deposit_chunks_unbalanced": 1}]
    assert profiling.span_totals()["counters"] == {
        "deposit_chunks": 24, "deposit_chunks_unbalanced": 2}
    assert profiling.device_counters(names, "cpu") is None


def test_span_totals_takes_the_last_steps_only():
    param = _param(theory="fr", linear_newton_solver="multigrid", aexp=0.05)
    cfg, dyn, state = _start(param)
    with _profiler():
        state, _ = _step(cfg, dyn, state, "lazy_sort", save_pk=True)
        for _ in range(2):
            state, _ = _step(cfg, dyn, state, "lazy_window")
    everything = profiling.span_totals()
    last = profiling.span_totals(last_steps=2)
    assert everything["steps"] == 3 and last["steps"] == 2
    assert profiling.span_totals(last_steps=7)["steps"] == 3
    assert last["spans"]["step"]["calls"] == 2
    assert "pm.sort" in everything["spans"]
    assert "pm.sort" not in last["spans"]
    assert "pm.power_spectrum" not in last["spans"]
    assert last["spans"]["pm.drift_check"]["calls"] == 2
    roots = [r for r in profiling.span_records() if r["name"] == "step"]
    assert last["counters"]["host_syncs"] == sum(
        r["counters"]["host_syncs"] for r in roots[1:])
    assert len(last["outside_step_ms"]) == 1
    assert last["spans"]["step"]["device_ms"] == pytest.approx(
        sum(r["device_ms"] for r in roots[1:]))


def test_phases_time_the_tables_and_a_built_pk_table(tmp_path):
    param = {"theory": "newton", "H0": 72, "Om_m": 0.25733,
             "T_cmb": 2.726, "N_eff": 3.044, "w0": -1.0, "wa": 0.0,
             "base": str(tmp_path)}
    profiling.PHASES.pop("cosmo.generate", None)
    cosmo.generate(param)
    assert profiling.PHASES["cosmo.generate"] > 0
    n = 12
    fourier._PK_BINS.pop((n, "cpu", 0, None), None)
    profiling.PHASES.pop("pk_bins", None)
    grid = fourier.rfft3(torch.rand((n, n, n)))
    fourier.power_spectrum(grid, 2)
    assert profiling.PHASES["pk_bins"] > 0
    profiling.PHASES.pop("pk_bins")
    fourier.power_spectrum(grid, 2)  # the table is found, not built
    assert "pk_bins" not in profiling.PHASES


class _FakeEvent:
    """A CUDA event stand-in on the host clock: records, synchronises and
    measures as ``torch.cuda.Event`` does, and knows whether it is in
    use."""

    made = []

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.t = None
        _FakeEvent.made.append(self)

    def record(self):
        self.t = time.perf_counter_ns()

    def synchronize(self):
        assert self.t is not None

    def elapsed_time(self, end):
        return (end.t - self.t) / 1e6


class _OnCard:
    is_cuda = True


def test_card_events_give_gaps_and_return_to_the_pool(monkeypatch):
    """The CUDA event path, with host-clock events: device times and gaps
    from the events, and each event back in the pool once read, but the
    live session's last exit, which the next step's gap still needs."""
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    _FakeEvent.made = []
    like = _OnCard()

    def steps(k):
        for _ in range(k):
            with profiling.step_span(like):
                with profiling.span("pm.deposit"):
                    pass
                profiling.count("host_syncs", 2)

    with _profiler():
        steps(2)
        assert len(_FakeEvent.made) == 8
        recs = profiling.span_records()
        assert len(profiling._STORE.pool) == 7  # the last exit is held
        steps(1)  # takes events from the pool
        assert len(_FakeEvent.made) == 8
    roots = [r for r in profiling.span_records() if r["name"] == "step"]
    assert len(roots) == 3 and roots[0]["gap_ms"] is None
    assert all(r["gap_ms"] >= 0 for r in roots[1:])
    assert all(r["counters"] == {"host_syncs": 2} for r in roots)
    assert len(profiling._STORE.pool) == 7  # the session may go on
    steps(1)  # off: the session ends
    with _profiler():
        steps(1)  # a new session frees the last one's held exit
    assert len(profiling._STORE.pool) == 4
    profiling.span_records()
    assert len(profiling._STORE.pool) == 7
    assert recs[0]["device_ms"] >= recs[1]["device_ms"] >= 0


def test_profile_dir_trace_holds_the_span_track(tmp_path, monkeypatch):
    """``profile_dir``: the spans of step 2 on their own track, each
    ``pm.deposit`` around its deposit's operators on the trace's clock."""
    real = tiled_pm.deposit

    def marked(*args, **kwargs):
        with record_function("test.deposit"):
            return real(*args, **kwargs)

    monkeypatch.setattr(tiled_pm, "deposit", marked)
    pk_file = tmp_path / "pk.dat"
    write_power_spectrum_table(str(pk_file))
    out = tmp_path / "trace"
    param = {
        "theory": "newton", "H0": 72, "Om_m": 0.25733, "T_cmb": 2.726,
        "N_eff": 3.044, "w0": -1.0, "wa": 0.0, "boxlen": 100,
        "ncoarse": 4, "npart": 16 ** 3, "z_start": 49, "seed": 7,
        "position_ICS": "center", "dealiased_ICS": False,
        "power_spectrum_file": str(pk_file),
        "initial_conditions": "1LPT", "base": str(tmp_path / "run"),
        "output_snapshot_format": "npz", "z_out": "[35]",
        "save_power_spectrum": "no", "integrator": "leapfrog",
        "mass_scheme": "CIC", "n_reorder": 50, "Courant_factor": 1.0,
        "max_aexp_stepping": 10, "linear_newton_solver": "fft",
        "gradient_stencil_order": 5, "epsrel": 1e-2, "verbose": 0,
        "profile_dir": str(out),
    }
    pysco_tpu_torch.run(param, device="cpu")
    with open(out / "pysco_tpu_torch_trace.json") as f:
        events = json.load(f)["traceEvents"]
    track = [e["pid"] for e in events if e.get("ph") == "M"
             and e["name"] == "process_name"
             and e["args"]["name"] == profiling.SPAN_TRACK]
    assert len(track) == 1
    spans = [e for e in events if e.get("pid") == track[0]
             and e.get("ph") == "X"]
    assert [e["name"] for e in spans].count("step") == 1
    assert {"parent", "step", "device_ms"} <= set(spans[0]["args"])
    deposits = [e for e in spans if e["name"] == "pm.deposit"]
    marks = [e for e in events if e.get("name") == "test.deposit"]
    assert len(deposits) == len(marks) == 1
    span, mark = deposits[0], marks[0]
    assert span["ts"] <= mark["ts"]
    assert mark["ts"] + mark["dur"] <= span["ts"] + span["dur"]
    ops = [e for e in events if e.get("cat") == "cpu_op"
           and mark["ts"] <= e["ts"] <= mark["ts"] + mark["dur"]]
    assert ops
    for e in ops:
        assert span["ts"] <= e["ts"] <= e["ts"] + e["dur"] <= (
            span["ts"] + span["dur"])


@pytest.mark.parametrize("fR_n, roots", [(1, "exact"), (2, "exact"),
                                         (2, "newton")])
def test_exact_roots_open_a_span_in_each_smoothing(fR_n, roots,
                                                  monkeypatch):
    """With exact roots every FAS smoothing call opens one
    ``mg.exact_root`` inside its ``mg.smooth`` (the Poisson solve's
    none) and counts its 2 ``n_smoothing`` colour updates under
    ``exact_root_sweeps``; the Newton roots open and count none."""
    from pysco_tpu_torch.models import cubic, laplacian, quartic

    sweeps = []

    def tallied(x, b, q, n_smoothing, rhs, exact_root=False, *a, **kw):
        if exact_root:
            sweeps.append(n_smoothing)
        return laplacian.packed_scalaron_smoothing(
            x, b, q, n_smoothing, rhs, exact_root, *a, **kw)

    for mod in (cubic, quartic):
        monkeypatch.setattr(mod, "packed_scalaron_smoothing", tallied)
    param = _param(theory="fr", linear_newton_solver="multigrid", aexp=0.05,
                   fR_n=fR_n, fR_root_solver=roots)
    cfg, dyn, state = _start(param)
    multigrid.reset_stats()
    sweeps.clear()  # the profiled step's calls alone
    with _profiler():
        _step(cfg, dyn, state, "lazy_window")
    stats = dict(multigrid.STATS)
    totals = profiling.span_totals()
    calls = totals["spans"].get("mg.exact_root", {"calls": 0})["calls"]
    assert calls == (5 * stats["fas_cycles"] if roots == "exact" else 0)
    assert stats["fas_cycles"] > 0
    recs = profiling.span_records()
    smooth = {r["index"]: r for r in recs if r["name"] == "mg.smooth"}
    for r in recs:
        if r["name"] == "mg.exact_root":
            parent = smooth[r["parent"]]
            assert parent["t0_ns"] <= r["t0_ns"] <= r["t1_ns"] <= parent[
                "t1_ns"]
    assert len(sweeps) == calls
    if roots == "exact":
        assert totals["counters"]["exact_root_sweeps"] == 2 * sum(sweeps) > 0
    else:
        assert "exact_root_sweeps" not in totals["counters"]


@pytest.mark.parametrize("power", [2, 3])
@pytest.mark.parametrize("exact_root", [False, True])
def test_scalaron_smoothing_opens_its_root_span_with_level(power,
                                                           exact_root):
    """A scalaron smoothing call inside ``mg.smooth`` of level 2 opens its
    root's span (``mg.newton_root`` with the Newton roots, the default;
    ``mg.exact_root`` with the closed forms) with that level and its
    colour updates in its record (2 a sweep, under ``newton_root_sweeps``
    or ``exact_root_sweeps``); the step counts the exact roots' too.
    Untraced, nothing is recorded; on the CPU no kernel counts guarded
    cells."""
    from pysco_tpu_torch.models import cubic, quartic

    mod = cubic if power == 2 else quartic
    n = 8
    gen = torch.Generator().manual_seed(power)
    b = 0.1 * torch.randn((n, n, n), generator=gen)
    rhs = 1e-4 * torch.randn((n, n, n), generator=gen)
    x = mod.smoothing(mod.initialise_potential(b, -2000.0), b, -2000.0, 20,
                      rhs, exact_root=True)
    plain = mod.smoothing(x, b, -2000.0, 3, rhs, exact_root=exact_root)
    assert profiling.span_records() == []
    with _profiler():
        with profiling.step_span(x):
            with profiling.span("mg.smooth", 2):
                traced = mod.smoothing(x, b, -2000.0, 3, rhs,
                                       exact_root=exact_root)
    assert torch.equal(plain, traced)
    name, counter = (("mg.exact_root", "exact_root_sweeps") if exact_root
                     else ("mg.newton_root", "newton_root_sweeps"))
    recs = profiling.span_records()
    root = [r for r in recs if r["name"] == name]
    assert len(root) == 1
    assert root[0]["level"] == 2 and root[0]["counters"] == {counter: 6}
    step = recs[0]
    assert step["name"] == "step"
    assert step["counters"] == ({counter: 6} if exact_root else {})
