#!/usr/bin/env python3
"""Readings that set the limits of a cell's compared numbers.

    python3 benchmark/control.py --workload fr512.lazy --seeds 1,2,3 \\
        --seconds 5 --out readings_fr512.lazy.json

Runs the cell once per seed in one process, each with a short window,
and reads every number twice: the program's against the float64
reference (the lower readings), and the control's, the reference itself
computed in bfloat16 in the program's place (the upper readings). Runs on
the card only; the benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", default="5",
                    help="window seconds, or a comma list taken in turn "
                         "(windows that close at other redshifts check "
                         "other outputs)")
    ap.add_argument("--control", type=int, choices=(0, 1), default=1)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch

    import cell

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    rows = []
    windows = [float(s) for s in args.seconds.split(",")]
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        r = cell.run_cell(args.workload, seed, windows[i % len(windows)],
                          False, "cuda", control=bool(args.control))
        row = {"seed": seed, "window_s": r["run"]["window_s"],
               "program": {k: v for k, (v, _) in
                                         r["checks"].items()},
               "control": r.get("control_numbers"),
               "correct": r["correct"], "seconds": time.perf_counter() - t0}
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"workload": args.workload, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
