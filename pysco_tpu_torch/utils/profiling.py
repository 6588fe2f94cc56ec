"""Timing and profiling utilities (PyTorch port of
``pysco_tpu/utils/profiling.py``).

Work on a card is asynchronous, so a wall time only means something once
the device has finished: ``time_me`` and ``profile_me`` synchronise the
device of the tensors they are handed back, ``component_breakdown``
times each stage of a force evaluation alone with CUDA events, and
:func:`trace` writes a ``torch.profiler`` Chrome trace for kernel-level
analysis. On the CPU everything is synchronous and the host clock times
it.

Spans and counters: the step's layers open :func:`span` (the step itself
:func:`step_span`) and count host fetches with :func:`count`; a kernel
counts on the device into the tensor :func:`device_counters` hands its
wrapper, read once when the step closes. They record only while a
``torch.profiler`` profile is active (the benchmark's traced stretches,
the ``profile_dir`` step); otherwise each site costs one attribute read
and one branch. A span keeps its host enter and exit times on
``time.time_ns()``, the clock the profiler stamps its events with, and,
inside a step on a card, a pair of CUDA events on the current stream,
resolved when the spans are read (:func:`span_records`,
:func:`span_totals`). :func:`trace` adds them to its Chrome trace on a
track of their own. ``PHASES`` times set-up phases that run once a
process, always.
"""

from __future__ import annotations

import cProfile
import functools
import json
import logging
import os
from collections import defaultdict
from contextlib import contextmanager
from time import perf_counter, time_ns

import torch
from torch.autograd import profiler as _autograd_profiler

SPAN_TRACK = "pysco_tpu_torch spans"

# set-up phases that run once a process, outside any profiler: name to
# seconds of the last run, host clock
PHASES: dict = {}


def _tensors(result):
    if isinstance(result, torch.Tensor):
        yield result
    elif isinstance(result, dict):
        for v in result.values():
            yield from _tensors(v)
    elif isinstance(result, (tuple, list)):
        for v in result:
            yield from _tensors(v)


def _sync(result):
    """Wait for the card of any CUDA tensor in ``result`` (a tensor, or
    nested tuples, lists and dicts of them); nothing to do on the CPU."""
    for t in _tensors(result):
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
            break
    return result


def time_me(func):
    """Log wall time per call at INFO."""

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        t0 = perf_counter()
        result = _sync(func(*args, **kwargs))
        logging.info("%s took %.6f s", func.__name__, perf_counter() - t0)
        return result

    return wrapper


def profile_me(func):
    """Dump a cProfile of the call to ``<func>.prof``."""

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        profiler = cProfile.Profile()
        profiler.enable()
        result = _sync(func(*args, **kwargs))
        profiler.disable()
        fname = f"{func.__name__}.prof"
        profiler.dump_stats(fname)
        logging.warning("Profiling: wrote %s (inspect with snakeviz/pstats)",
                        fname)
        return result

    return wrapper


def _timeit(fn, args, iters: int, device: torch.device):
    """(ms per call, last output) of ``fn(*args)`` after a warm-up call:
    CUDA events on the current stream on a card, the host clock on the
    CPU. The previous output is freed before each call: at 512^3 a second
    live sorted state or force mesh is the margin the next stage needs."""
    out = fn(*args)
    _sync(out)
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    else:
        t0 = perf_counter()
    for _ in range(iters):
        del out
        out = fn(*args)
    if device.type == "cuda":
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / iters, out
    return (perf_counter() - t0) / iters * 1e3, out


def component_breakdown(cfg, position, velocity, dyn, iters: int = 3):
    """Per-component times (ms) of one force evaluation on the tiled
    engine: tile sort, deposit, field solve + gradient, gather, each stage
    run alone after a warm-up call. Used by the run loop at verbose=2.

    The kernel launch counts and the multigrid statistics are left as
    they were found (the run loop reports them per step), and its solves
    log no per-cycle residual lines.
    """
    from .. import solver as solver_mod
    from ..models import multigrid
    from ..ops import stencil, tiled_pm

    counters = (stencil.LAUNCHES, tiled_pm.LAUNCHES, multigrid.STATS)
    saved = [dict(c) for c in counters]
    log_residuals = multigrid.LOG_RESIDUALS
    multigrid.set_residual_logging(False)
    m = cfg.ncells_1d
    scheme = cfg.mass_scheme
    device = position.device
    try:
        t_sort, (pos_s, vel_s, starts) = _timeit(
            lambda p, v: tiled_pm.sort_particles(p, v, m, scheme),
            (position, velocity), iters, device)
        # the unsorted state is only needed by the sort stage
        del position, velocity, vel_s
        t_dep, dens = _timeit(
            lambda p, s: tiled_pm.deposit(p, s, m, scheme), (pos_s, starts),
            iters, device)

        def solve(d):
            potential, u = solver_mod.empty_fields(cfg, device)
            force, _, _, _ = solver_mod._solve_fields(
                cfg, True, False, solver_mod._normalise(cfg, d), potential,
                u, dyn, leading=True)
            return force

        t_solve, force = _timeit(solve, (dens,), iters, device)
        del dens
        t_gat, _ = _timeit(
            lambda f, p, s: tiled_pm.gather_vec_cl(f, p, s, scheme),
            (force, pos_s, starts), iters, device)
    finally:
        multigrid.set_residual_logging(log_residuals)
        for c, old in zip(counters, saved):
            c.update(old)
    return {
        "tile_sort_ms": round(t_sort, 1),
        "deposit_ms": round(t_dep, 1),
        "solve_plus_gradient_ms": round(t_solve, 1),
        "gather_ms": round(t_gat, 1),
    }


@contextmanager
def phase(name: str):
    """Time a set-up phase on the host clock into ``PHASES[name]``."""
    t0 = perf_counter()
    yield
    PHASES[name] = perf_counter() - t0


class _Null:
    """What a span site gets while no profiler is active."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _Span:
    """One span: its place in the tree, host times (ns since the epoch)
    and, inside a step on a card, its CUDA events until resolved."""

    __slots__ = ("store", "index", "name", "parent", "step", "level",
                 "session", "t0", "t1", "events", "device_ms", "gap_ms",
                 "counters", "prev", "has_next")

    def __init__(self, store, name, level):
        self.store = store
        self.name = name
        self.level = level
        self.parent = store.stack[-1].index if store.stack else None
        self.step = store.current.step if store.current is not None else None
        self.session = store.session
        self.t0 = self.t1 = self.device_ms = self.gap_ms = None
        self.events = self.counters = self.prev = None
        self.has_next = False
        if store.current is not None and store.cuda:
            self.events = (store.event(), store.event())
        self.index = len(store.records)
        store.records.append(self)

    def __enter__(self):
        self.store.stack.append(self)
        self.t0 = time_ns()
        if self.events is not None:
            self.events[0].record()
        return self

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[1].record()
        self.t1 = time_ns()
        store = self.store
        if store.stack and store.stack[-1] is self:
            store.stack.pop()
        if store.current is self:
            store.read_device_counters(self)
            store.current = None
        return False


class _Store:
    """The spans recorded in this process, in the order they opened.

    A session is a run of steps taken with the profiler on; a step taken
    with it off ends the session, so no gap between two steps is counted
    across an untraced stretch. A step's CUDA exit event serves the gap
    to the next step of its session too, and goes back to the pool only
    when that gap is read, or when no next step can come."""

    def __init__(self):
        self.records = []
        self.stack = []
        self.resolved = 0  # records[:resolved] hold their times
        self.current = None  # the open step span
        self.steps = 0  # step numbers handed out
        self.cuda = False  # the open step records CUDA events
        self.session = 0
        self.live = False  # the session still takes steps
        self.last_step = None  # the live session's latest step
        self.pool = []
        self.device = {}  # (names, device): the int64 counts of kernels

    def event(self):
        return (self.pool.pop() if self.pool
                else torch.cuda.Event(enable_timing=True))

    def open_step(self, cuda: bool) -> _Span:
        if not self.live:
            self.live = True
            self.session += 1
            last = self.last_step
            if last is not None and last.device_ms is not None:
                self._release_exit(last)  # else resolve() releases it
            self.last_step = None
        self.steps += 1
        self.cuda = cuda
        prev = self.last_step
        self.current = None
        span = _Span(self, "step", None)
        if cuda:
            span.events = (self.event(), self.event())
        span.step = self.steps
        span.counters = {}
        span.prev = prev
        if prev is not None:
            prev.has_next = True
        self.current = self.last_step = span
        return span

    def count(self, name: str, n: int) -> None:
        if self.current is not None:
            c = self.current.counters
            c[name] = c.get(name, 0) + n

    def device_counters(self, names: tuple, device: torch.device):
        if self.current is None:
            return None
        key = (names, device)
        if key not in self.device:
            self.device[key] = torch.zeros(len(names), dtype=torch.int64,
                                           device=device)
        return self.device[key]

    def read_device_counters(self, step) -> None:
        """Add what the kernels counted in ``step`` to its counters (one
        fetch a tensor, once the step's work is queued) and start the
        tensors again from zero."""
        for (names, _), counts in self.device.items():
            for name, n in zip(names, counts.tolist()):
                step.counters[name] = step.counters.get(name, 0) + n
            counts.zero_()

    def _release_exit(self, span) -> None:
        if span.events is not None:
            self.pool.append(span.events[1])
            span.events = None

    def resolve(self) -> list:
        """Times of every closed span from the first unresolved on (the
        open ones and those after them wait); waits for the card."""
        recs = self.records
        while self.resolved < len(recs) and recs[self.resolved].t1 is not None:
            s = recs[self.resolved]
            host_ms = (s.t1 - s.t0) / 1e6
            prev = s.prev
            if s.events is None:
                s.device_ms = host_ms
                if prev is not None:
                    s.gap_ms = (s.t0 - prev.t1) / 1e6
            else:
                ev0, ev1 = s.events
                ev1.synchronize()
                s.device_ms = ev0.elapsed_time(ev1)
                if prev is not None and prev.events is not None:
                    s.gap_ms = prev.events[1].elapsed_time(ev0)
                    self._release_exit(prev)
                self.pool.append(ev0)
                s.events = (None, ev1)
                if s.counters is None or not (
                        s.has_next or (self.live and s is self.last_step)):
                    self._release_exit(s)
            self.resolved += 1
        return recs[:self.resolved]


_STORE = _Store()


def span(name: str, level=None):
    """A span around a layer's work, ``with profiling.span(name):``;
    ``level`` is a multigrid level, kept as an attribute."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NULL
    return _Span(_STORE, name, level)


def step_span(like: torch.Tensor):
    """The root span of one step, numbered; its spans, counters and device
    (``like``'s: CUDA events on a card) are the step's."""
    if not _autograd_profiler._is_profiler_enabled:
        _STORE.live = False
        return _NULL
    return _STORE.open_step(like.is_cuda)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` of the open step."""
    if _autograd_profiler._is_profiler_enabled:
        _STORE.count(name, n)


def device_counters(names, device):
    """The int64 tensor, one entry per name of ``names``, on ``device``
    that a kernel adds its counts into in the open step; None (count
    nothing) while no profiler is active or no step is open. The step
    reads it once when it closes: the counts join its counters under
    ``names``, and the tensor starts again from zero."""
    if not _autograd_profiler._is_profiler_enabled:
        return None
    return _STORE.device_counters(tuple(names), torch.device(device))


def reset_spans() -> None:
    """Forget every span and counter."""
    _STORE.__init__()


def span_records() -> list:
    """The closed spans as dicts, in the order they opened: name, index,
    parent index (None at a root), step number (None outside a step),
    level, session, host enter and exit (``t0_ns``, ``t1_ns``, on
    ``time.time_ns()``), ``host_ms``, ``device_ms`` (the stream time from
    the span's first command to the end of its last; the host time off
    the card), and for a step its counters and ``gap_ms``, the stream
    time since the previous step of its session ended (None for the
    first)."""
    return [{"name": s.name, "index": s.index, "parent": s.parent,
             "step": s.step, "level": s.level, "session": s.session,
             "t0_ns": s.t0, "t1_ns": s.t1, "host_ms": (s.t1 - s.t0) / 1e6,
             "device_ms": s.device_ms, "gap_ms": s.gap_ms,
             "counters": dict(s.counters) if s.counters is not None
             else None}
            for s in _STORE.resolve()]


def span_totals(last_steps=None) -> dict:
    """Totals over the last ``last_steps`` step trees (all by default):
    ``steps`` (trees found), per span name ``calls``, ``host_ms``,
    ``device_ms`` and ``self_device_ms`` (less its child spans'), the
    summed ``counters``, and ``outside_step_ms``, the stream time between
    each pair of consecutive steps of one session."""
    recs = span_records()
    roots = [r for r in recs if r["name"] == "step" and r["parent"] is None]
    if last_steps is not None:
        roots = roots[len(roots) - min(int(last_steps), len(roots)):]
    steps = {r["step"] for r in roots}
    inside = [r for r in recs if r["step"] in steps]
    child_ms = defaultdict(float)
    for r in inside:
        if r["parent"] is not None:
            child_ms[r["parent"]] += r["device_ms"]
    spans = {}
    for r in inside:
        t = spans.setdefault(r["name"], {"calls": 0, "host_ms": 0.0,
                                         "device_ms": 0.0,
                                         "self_device_ms": 0.0})
        t["calls"] += 1
        t["host_ms"] += r["host_ms"]
        t["device_ms"] += r["device_ms"]
        t["self_device_ms"] += r["device_ms"] - child_ms[r["index"]]
    counters = defaultdict(int)
    for r in roots:
        for k, v in r["counters"].items():
            counters[k] += v
    gaps = [r["gap_ms"] for r in roots[1:] if r["gap_ms"] is not None]
    return {"steps": len(roots), "spans": spans, "counters": dict(counters),
            "outside_step_ms": gaps}


def _append_spans(path: str, records: list) -> None:
    """Add ``records`` to the Chrome trace at ``path`` as the
    ``SPAN_TRACK`` process, on the trace's own time base."""
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    base = int(doc.get("baseTimeNanoseconds", 0))
    pid = 1 + max((e["pid"] for e in events
                   if isinstance(e.get("pid"), int)), default=0)
    events.append({"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                   "args": {"name": SPAN_TRACK}})
    for r in records:
        args = {"index": r["index"], "parent": r["parent"],
                "step": r["step"], "device_ms": r["device_ms"]}
        if r["level"] is not None:
            args["level"] = r["level"]
        if r["counters"]:
            args.update(r["counters"])
        events.append({"ph": "X", "cat": "pysco_tpu_torch",
                       "name": r["name"], "pid": pid, "tid": 0,
                       "ts": (r["t0_ns"] - base) / 1e3,
                       "dur": (r["t1_ns"] - r["t0_ns"]) / 1e3,
                       "args": args})
    with open(path, "w") as f:
        json.dump(doc, f)


@contextmanager
def trace(log_dir, device=None):
    """Capture a ``torch.profiler`` trace around a code block: host
    activity, and the card's when ``device`` is one (by default, when
    torch sees one). One Chrome trace file is written into ``log_dir`` on
    exit (a 512^3 f(R) step holds tens of thousands of events), with the
    program's spans of the block on the ``SPAN_TRACK`` track, and its
    path logged."""
    from torch.profiler import ProfilerActivity, profile

    on_card = (torch.cuda.is_available() if device is None
               else torch.device(device).type == "cuda")
    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(str(log_dir), "pysco_tpu_torch_trace.json")
    prof = profile(activities=activities)
    first = len(_STORE.records)
    prof.__enter__()
    try:
        yield
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(path)
        _append_spans(path, [r for r in span_records()
                             if r["index"] >= first])
        logging.warning("torch.profiler trace written to %s", path)
