#!/usr/bin/env python3
"""The benchmark of pysco_tpu_torch on one NVIDIA GPU.

    python3 benchmark/run.py --workload newton512.lazy --seed 7 \\
        --seconds 30 --trace 0

Runs one cell of ``BENCHMARK.json`` from the root of a checkout: set-up
(background tables, 2LPT initial conditions on the card from the seed,
the first force evaluation, a few warm-up steps), then the simulation
loop for ``--seconds``, started again from its saved state whenever it
reaches z = 0, then the check against the plain reference. The last line
of standard output is the result as one JSON object; the numbers the
check compared, each with its limit, are also the last lines of
standard error. ``--trace 1`` reports the per-layer metrics from a
torch.profiler trace of the window instead of the end-to-end ones.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _caches() -> None:
    """Kernel and extension caches at fixed paths inside the checkout."""
    cache = ROOT / ".bench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    sys.path[:0] = [str(HERE), str(ROOT)]
    import torch

    import cell

    workload = cell.find_workload(cell.spec(ROOT), args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(workload["chips"]):
        print(f"{workload['name']} needs {workload['chips']} CUDA devices, "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = cell.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), "cuda", T_START)
    for name, (value, limit) in result["checks"].items():
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
