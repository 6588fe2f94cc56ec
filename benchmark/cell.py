"""One run of one cell: set-up, the measured window, the check.

Everything that belongs to a configuration, a traffic mix, a metric or a
cell's limits is a file found by its name:

- ``configs/<config>.json``: the parameters as run (``param``) and,
  optionally, the name of its reference module (``reference``; see
  ``check.py``);
- ``traffic/<traffic>.json``: the loop's cadence and its warm-up;
- ``metrics/<metric>.py``: ``read(ctx)`` returns the metric or None;
- ``limits/<workload>.json``: the limit of each compared number.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "pysco_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def spec(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def find_workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def metric_reader(name: str, here: Path = HERE):
    path = here / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def metrics_of(bench: dict, workload: str, kind: str) -> list:
    """The cell's end-to-end (``kind = end_to_end``) or per-layer metrics:
    those that list it, and those that list no cells."""
    return [m for m in bench[kind]
            if workload in m.get("workloads", [workload])]


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def _param(config: dict, seed: int, base: str, overrides: dict,
           here: Path):
    from pysco_tpu_torch.utils.config import params_from_dict, with_defaults

    p = dict(config["param"])
    p.update(overrides)
    p.update(seed=int(seed), base=base, write_initial_snapshot=False,
             power_spectrum_file=str(here / "configs" / config["pk_file"]),
             verbose=0)
    return with_defaults(params_from_dict(p))


def _set_up(param, traffic: dict, seed: int, dev, base: str):
    """Background tables, 2LPT on the device, the first force evaluation
    and the warm-up; keeps the sampled particles the check compares.
    Returns (simulation, held, seconds of the ICs)."""
    import numpy as np
    import torch

    from pysco_tpu_torch import cosmo, ic_device, solver
    from pysco_tpu_torch.utils.units import set_units

    import check
    import loop

    tables = cosmo.generate(param)
    param["aexp"] = 1.0 / (1 + param["z_start"])
    set_units(param)
    param["nsteps"] = 0
    held = check.Held()
    position, velocity = ic_device.generate_lpt(param, tables, dev)
    ic_s = ic_device.TIMES["generate_lpt"]
    held.sites = check.sample_sites(seed, int(param["npart"]))
    sites = torch.as_tensor(held.sites, device=dev)
    held.ic_pos = position[:3, sites].clone()
    held.ic_vel = velocity[:3, sites].clone()
    param["t"] = float(tables[1](np.log(param["aexp"])))
    param["aexp_old"] = param["aexp"]
    held.step = {"aexp0": param["aexp"]}

    # the first force evaluation; the sample found again after its sort
    cfg = solver.config_from_param(param)
    sim = loop.Simulation(param, tables, cfg, bool(param["lazy_sort"]),
                          base)
    potential, u = solver.empty_fields(cfg, dev)
    state = solver.pm(cfg, True, False, position, velocity, potential, u,
                      solver.compute_dynamics(param))[:5]
    del position, velocity, potential, u
    cols, j = check.find_columns(state[0], held.ic_pos)
    held.pm0_sites = held.sites[j.cpu().numpy()]
    held.pm0_acc = state[2][:3, cols].clone()
    sim.start(*state)
    del state

    # every drift window level the cell uses, and one P(k)
    levels = traffic["warmup_levels"]
    for i, level in enumerate(levels):
        sim.step(force_level=level, force_pk=i == len(levels) - 1)
    if sim.finished:
        raise RuntimeError("the warm-up reached the last output")
    return sim, held, ic_s


def _window(sim, seconds: float, sampler) -> dict:
    """The measured window: the simulation, started again from its saved
    state whenever it reaches z = 0, until ``seconds`` have passed."""
    t0 = time.perf_counter()
    steps = spans = 0
    span_steps = None  # steps from the saved state to z = 0
    while True:
        if sampler is not None:
            sampler.before()
        sim.step()
        steps += 1
        if sim.finished:
            sim.restore()
            spans += 1
            span_steps = span_steps or steps
        if sampler is not None:
            sampler.after()
        if time.perf_counter() - t0 >= seconds:
            break
    return {"t0": t0, "steps": steps, "spans": spans,
            "span_steps": span_steps}


def _hold_checked_step(sim, held) -> None:
    """Run on to the first output after the window, keeping the state that
    the step which reaches it starts from, its output and its P(k)."""
    while True:
        if sim.finished:
            sim.restore()
        before = tuple(None if t is None else t.clone()
                       for t in sim.state())
        info = sim.step()
        if info["output"]:
            break
    sim.saved = None
    held.step_in = (before[0], before[1], before[2], before[4])
    held.step.update(dt=info["dt"], aexp=info["aexp"])
    held.step_out = (sim.position, sim.velocity, sim.acceleration)
    held.pk = info["pk"]
    sim.potential = sim.u = sim.tstarts = None


def _free(cuda: bool) -> None:
    import torch

    gc.collect()
    if cuda:
        torch.cuda.empty_cache()


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float | None = None,
             overrides: dict | None = None, control: bool = False,
             here: Path = HERE, bench: dict | None = None) -> dict:
    """One run; returns the result line's dict, the compared numbers and
    their limits last (with ``control``, the control's numbers beside)."""
    t_start = time.perf_counter() if t_start is None else t_start
    import torch

    from pysco_tpu_torch.models import multigrid
    from pysco_tpu_torch.ops import stencil, tiled_pm

    import check
    import devtrace

    bench = spec(here.parent) if bench is None else bench
    cell = find_workload(bench, workload)
    config = load_json(here / "configs" / f"{cell['config']}.json")
    traffic = load_json(here / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(here / "limits" / f"{workload}.json")
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    base = os.path.join(tempfile.gettempdir(), "pysco_bench", workload)
    os.makedirs(base, exist_ok=True)
    param = _param(config, seed, base,
                   {**traffic["param"], **(overrides or {})}, here)
    param["z_out"] = list(param["z_out"])
    ref = check.reference_for(cell["config"], config, param, here)

    sim, held, ic_s = _set_up(param, traffic, seed, dev, base)
    peak_setup = 0
    if cuda:
        torch.cuda.synchronize(dev)
        peak_setup = torch.cuda.max_memory_allocated(dev)
    saved_bytes = sim.save()
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    multigrid.reset_stats()
    tiled_pm.reset_launches()
    stencil.reset_launches()
    sampler = None
    if trace:
        sampler = devtrace.Sampler(
            cuda, lambda: {**tiled_pm.LAUNCHES, **stencil.LAUNCHES})
        sampler.warm()

    win = _window(sim, seconds, sampler)
    if cuda:
        torch.cuda.synchronize(dev)
    window_s = time.perf_counter() - win["t0"]
    setup_s = win["t0"] - t_start
    stats = dict(multigrid.STATS)
    launches = {**tiled_pm.LAUNCHES, **stencil.LAUNCHES}
    peak_bytes = program_peak = 0
    if cuda:
        peak_window = torch.cuda.max_memory_allocated(dev)
        peak_bytes = max(peak_setup, peak_window)
        program_peak = max(peak_setup, peak_window - saved_bytes)
    found = forbidden_modules()
    if found:
        raise SystemExit("modules that must not load: " + ", ".join(found))
    reduced = sampler.close() if trace else {}

    _hold_checked_step(sim, held)
    _free(cuda)
    numbers = check.reference_numbers(
        param, seed, held, dev, check.program_outputs(held), ref)
    correct, rows = check.judge(numbers, limits)

    ctx = SimpleNamespace(
        steps=win["steps"], spans=win["spans"], window_s=window_s,
        setup_s=setup_s, program_peak_bytes=program_peak, ic_s=ic_s,
        stats=stats, launches=launches, npart=int(param["npart"]),
        n=sim.cfg.ncells_1d)
    ctx.__dict__.update(reduced)
    kind = "per_layer" if trace else "end_to_end"
    values = {}
    for m in metrics_of(bench, workload, kind):
        v = metric_reader(m["name"], here)(ctx)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {
        "correct": correct, "attempted": win["steps"], "failed": 0,
        "metrics": values,
        "device": {
            "platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
            "count": 1, "memory_peak_bytes": int(peak_bytes)},
    }
    result["run"] = {"seed": seed, "steps": win["steps"],
                     "spans": win["spans"],
                     "steps_per_span": win["span_steps"],
                     "window_s": window_s, "ic_s": ic_s}
    if trace:
        result["device"]["busy_s"] = reduced["busy_s"]
        result["device"]["window_s"] = reduced["traced_s"]
        result["breakdown"] = reduced["breakdown"]
        result["run"].update(
            traced_steps=reduced["steps"],
            traced_step_s=reduced["traced_s"] / max(reduced["steps"], 1),
            plain_step_s=reduced["plain_step_s"])
    if control:
        result["control_numbers"] = check.reference_numbers(
            param, seed, held, dev,
            check.control_outputs(param, seed, held, dev, ref=ref), ref)
    # last: each compared number beside its limit
    result["checks"] = {k: [v, lim] for k, v, lim in rows}
    del held, sim
    _free(cuda)
    return result
