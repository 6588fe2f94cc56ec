"""torch.profiler traces of the measured window, reduced to device time
by operation name, the union of device activity, and the longest device
idle gaps with the CUDA runtime call the host was in at each.

The window is traced in stretches: a few steps under the profiler, as
many without, in turn to its end, so that the trace samples every
redshift of the span while each stretch stays short: the profiler's own
callbacks slow the host, and a 512^3 Newton window traced whole for 45 s
ran 16% fewer steps (a 10 s trace, none). The untraced stretches' wall
time a step is reported beside the traced one. Only CUDA activity is recorded
(device operations and the host's CUDA runtime calls), and events are
read from the profiler's raw Kineto list, not its event tree, which half
a million launches take minutes to build."""

from __future__ import annotations

from collections import defaultdict
from time import perf_counter

import numpy as np

TRACED = 4  # steps a traced stretch
UNTRACED = 4  # steps an untraced stretch between two traced ones


def profiler(cuda: bool = True):
    """The window's profiler: CUDA activity on a card; host operators in a
    rehearsal on the CPU, which has no device activity to record."""
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CUDA if cuda
                               else ProfilerActivity.CPU])


def _union(starts: np.ndarray, ends: np.ndarray):
    """Length of the union of [start, end) intervals, and the gaps between
    its pieces as (start, end) arrays."""
    if not len(starts):
        return 0.0, np.empty(0), np.empty(0)
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], np.maximum.accumulate(ends[order])
    # a new piece starts where an interval begins after all before it ended
    new = np.empty(len(s), bool)
    new[0] = True
    new[1:] = s[1:] > e[:-1]
    piece_start = s[new]
    piece_end = np.append(e[np.flatnonzero(new)[1:] - 1], e[-1])
    busy = float(np.sum(piece_end - piece_start))
    return busy, piece_end[:-1], piece_start[1:]


def reduce(prof) -> dict:
    """Seconds and calls by device operation name, busy seconds (the union
    of every device operation), and the longest idle gaps, each with the
    host's CUDA call at its start."""
    from torch.autograd import DeviceType

    by_name = defaultdict(lambda: [0.0, 0])
    dev_s, dev_e, host_s, host_e, host_n = [], [], [], [], []
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns() * 1e-9
        t = s + e.duration_ns() * 1e-9
        if e.device_type() == DeviceType.CUDA:
            entry = by_name[e.name()]
            entry[0] += t - s
            entry[1] += 1
            dev_s.append(s)
            dev_e.append(t)
        else:
            host_s.append(s)
            host_e.append(t)
            host_n.append(e.name())
    busy, gap_s, gap_e = _union(np.array(dev_s), np.array(dev_e))
    hs, he = np.array(host_s), np.array(host_e)
    idle = []
    for i in np.argsort(gap_s - gap_e)[:10]:
        inside = np.flatnonzero((hs <= gap_s[i]) & (he > gap_s[i]))
        name = "host, outside CUDA calls"
        if len(inside):
            name = host_n[inside[np.argmin(he[inside] - hs[inside])]]
        idle.append([name, float(gap_e[i] - gap_s[i])])
    return {"kernels": by_name, "busy_s": busy, "idle_gaps": idle}


class Sampler:
    """Traced and untraced stretches of the window, in turn.

    ``before()`` and ``after()`` bracket each step of the window (a step
    ends in a device synchronise); ``counters()`` returns the program's
    launch counters, whose change over the traced stretches the roofline
    readers take as calls."""

    def __init__(self, cuda: bool, counters):
        self.cuda = cuda
        self.counters = counters
        self.kernels = defaultdict(lambda: [0.0, 0])
        self.launches = defaultdict(int)
        self.gaps = []
        self.busy_s = self.traced_s = self.plain_s = 0.0
        self.traced_steps = self.plain_steps = 0
        self.k = 0
        self.prof = None

    def warm(self) -> None:
        """Start and stop the profiler once, in set-up: its first start
        initialises the tracing library."""
        with profiler(self.cuda):
            pass

    def before(self) -> None:
        if self.k == 0:
            self.c0 = dict(self.counters())
            self.prof = profiler(self.cuda)
            self.prof.__enter__()
        if self.k in (0, TRACED):
            self.t0 = perf_counter()

    def after(self) -> None:
        self.k += 1
        if self.k == TRACED:
            self._end_traced(TRACED)
        elif self.k == TRACED + UNTRACED:
            self.plain_s += perf_counter() - self.t0
            self.plain_steps += UNTRACED
            self.k = 0

    def _end_traced(self, steps: int) -> None:
        self.traced_s += perf_counter() - self.t0
        self.traced_steps += steps
        self.prof.__exit__(None, None, None)
        for name, c in self.counters().items():
            self.launches[name] += c - self.c0.get(name, 0)
        r = reduce(self.prof)
        self.prof = None
        for name, (sec, calls) in r["kernels"].items():
            self.kernels[name][0] += sec
            self.kernels[name][1] += calls
        self.busy_s += r["busy_s"]
        self.gaps = sorted(self.gaps + r["idle_gaps"],
                           key=lambda g: -g[1])[:10]

    def close(self) -> dict:
        """End the last stretch and return what the readers take: device
        time by name, busy and traced seconds, traced steps, the untraced
        wall seconds a step, launches, and the breakdown."""
        if 0 < self.k < TRACED:
            self._end_traced(self.k)
        elif self.k > TRACED:
            self.plain_s += perf_counter() - self.t0
            self.plain_steps += self.k - TRACED
        top = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])[:10]
        return {
            "kernels": {k: tuple(v) for k, v in self.kernels.items()},
            "busy_s": self.busy_s, "traced_s": self.traced_s,
            "steps": self.traced_steps, "launches": dict(self.launches),
            "plain_step_s": (self.plain_s / self.plain_steps
                             if self.plain_steps else None),
            "breakdown": {"device_ops": [[k, v[0]] for k, v in top],
                          "idle_gaps": self.gaps},
        }


def kernel_time(kernels: dict, match) -> tuple:
    """(seconds, calls) of the device operations whose name ``match``
    accepts."""
    sec, calls = 0.0, 0
    for name, (s, c) in kernels.items():
        if match(name):
            sec += s
            calls += c
    return sec, calls
