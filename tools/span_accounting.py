#!/usr/bin/env python3
"""One traced run of a benchmark cell, with the program's span accounting.

    python3 tools/span_accounting.py --workload fr512.lazy --seed 7 \\
        --seconds 45

Runs ``benchmark/run.py --trace 1`` in this process (its result line is
printed as usual), then prints one more JSON line with what the
program's spans (``pysco_tpu_torch.utils.profiling``) say of the traced
steps, each figure a traced step:

- per span name: calls, host ms, device ms and self device ms, and for
  the multigrid spans the same by level;
- ``accounting``: the ``step`` span's device ms plus the mean stream time
  between steps against the traced wall time, the share of the step's
  device time its child spans cover, and the step trees in the store
  (``step_trees``) against the traced steps;
- ``outside``: the device-trace readings the span readings must not fall
  under (the CUB sort kernels, ``deposit_tiles``, ``gather_march``);
- ``launches``: the program's kernel launches (``stencil.LAUNCHES``,
  ``tiled_pm.LAUNCHES``) a traced step, to hold against the counters;
- ``counters``: the program's counters a traced step, among them the
  deposit kernel's ``deposit_chunks`` (512-particle chunks summed) and
  ``deposit_chunks_unbalanced`` (those in which one thread's adds
  exceeded 4 times the chunk's mean a thread).

Needs a CUDA card, as the benchmark does.
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "benchmark"), str(ROOT)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=45.0)
    args = ap.parse_args(argv)

    import cell
    import devtrace
    import run
    from pysco_tpu_torch.utils import profiling

    reduced = {}
    close = devtrace.Sampler.close

    def keep(self):
        out = close(self)
        reduced.update(out)
        return out

    devtrace.Sampler.close = keep
    rc = run.main(["--workload", args.workload, "--seed", str(args.seed),
                   "--seconds", str(args.seconds), "--trace", "1"])
    if rc:
        return rc
    steps = reduced["steps"]
    totals = profiling.span_totals(last_steps=steps)
    recs = profiling.span_records()
    roots = sorted(r["step"] for r in recs if r["name"] == "step"
                   and r["parent"] is None)
    kept = set(roots[-steps:])
    by_level = defaultdict(lambda: [0, 0.0])
    for r in recs:
        if r["step"] in kept and r["level"] is not None:
            entry = by_level[f"{r['name']}@{r['level']}"]
            entry[0] += 1
            entry[1] += r["device_ms"]
    spans = {name: {k: v / steps for k, v in t.items()}
             for name, t in totals["spans"].items()}
    step = totals["spans"]["step"]
    gaps = totals["outside_step_ms"]
    outside_ms = sum(gaps) / len(gaps) if gaps else 0.0
    traced_ms = 1e3 * reduced["traced_s"] / steps
    ctx = SimpleNamespace(kernels=reduced["kernels"], steps=steps)
    kernel_ms = {
        "sort_ms_per_step": cell.metric_reader("sort_ms_per_step")(ctx),
        "deposit_tiles_ms_per_step": 1e3 * devtrace.kernel_time(
            reduced["kernels"], lambda k: "deposit_tiles" in k)[0] / steps,
        "gather_march_ms_per_step": 1e3 * devtrace.kernel_time(
            reduced["kernels"], lambda k: "gather_march" in k)[0] / steps,
    }
    print(json.dumps({
        "workload": args.workload, "seed": args.seed,
        "traced_steps": steps, "step_trees": len(roots),
        "spans": spans,
        "by_level": {k: [c / steps, ms / steps]
                     for k, (c, ms) in sorted(by_level.items())},
        "counters": {k: v / steps for k, v in totals["counters"].items()},
        "launches": {k: v / steps for k, v in reduced["launches"].items()},
        "accounting": {
            "step_device_ms": step["device_ms"] / steps,
            "outside_step_ms": outside_ms,
            "traced_step_ms": traced_ms,
            "step_plus_outside_over_traced": (
                (step["device_ms"] / steps + outside_ms) / traced_ms),
            "children_cover": 1.0 - step["self_device_ms"]
            / step["device_ms"],
        },
        "outside": kernel_ms,
        "phases": dict(profiling.PHASES),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
