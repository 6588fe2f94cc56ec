"""Timing and profiling utilities (PyTorch port of
``pysco_tpu/utils/profiling.py``).

Work on a card is asynchronous, so a wall time only means something once
the device has finished: ``time_me`` and ``profile_me`` synchronise the
device of the tensors they are handed back, ``component_breakdown``
times each stage of a force evaluation alone with CUDA events, and
:func:`trace` writes a ``torch.profiler`` Chrome trace for kernel-level
analysis. On the CPU everything is synchronous and the host clock times
it.
"""

from __future__ import annotations

import cProfile
import functools
import logging
import os
from contextlib import contextmanager
from time import perf_counter

import torch


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
def trace(log_dir, device=None):
    """Capture a ``torch.profiler`` trace around a code block: host
    activity, and the card's when ``device`` is one (by default, when
    torch sees one). One Chrome trace file is written into ``log_dir`` on
    exit (a 512^3 f(R) step holds tens of thousands of events), and its
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
    prof.__enter__()
    try:
        yield
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(path)
        logging.warning("torch.profiler trace written to %s", path)
