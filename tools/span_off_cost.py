#!/usr/bin/env python3
"""The cost of a span site while no profiler runs, on the host's CPU.

    python3 tools/span_off_cost.py

Times, over a million calls each and best of five, a function whose
body sits in ``with profiling.span(...)`` (and one with a multigrid
level, the step root and a counter) against the same function without
the site, and prints one JSON line of nanoseconds a site. Multiplied by
the sites a step reaches (``tools/span_accounting.py`` counts them per
span name), it is the untraced run's cost of the spans.
"""

from __future__ import annotations

import json
import sys
import timeit
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from pysco_tpu_torch.utils import profiling  # noqa: E402

CALLS = 1_000_000


def body(x):
    return x


def plain(x):
    return body(x)


def span(x):
    with profiling.span("pm.deposit"):
        return body(x)


def span_level(x, level=3):
    with profiling.span("mg.smooth", level):
        return body(x)


def step_root(x):
    with profiling.step_span(x):
        return body(x)


def counted(x):
    profiling.count("host_syncs")
    return body(x)


def main() -> int:
    assert not torch.autograd.profiler._is_profiler_enabled
    x = torch.zeros(1)

    def ns(fn):
        best = min(timeit.repeat(lambda: fn(x), number=CALLS, repeat=5))
        return best / CALLS * 1e9

    base = ns(plain)
    out = {"plain_call_ns": base}
    for name, fn in (("span", span), ("span_level", span_level),
                     ("step_span", step_root), ("count", counted)):
        out[f"{name}_ns"] = ns(fn) - base
    out["python"] = sys.version.split()[0]
    out["torch"] = torch.__version__
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
