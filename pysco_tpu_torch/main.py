"""Run loop and CLI (PyTorch port of ``pysco_tpu/main.py``).

``run(param, device)`` computes the background tables on the host and
the initial conditions on the device (LPT on the tiled engine, unless
``ic_device`` is false) or on the host, then runs the adaptive
kick-drift-kick loop on the device, writing snapshots and power spectra
at each ``z_out``. The host picks dt from the previous step's max |acc|
and max |vel|, and the lazy re-binning level from the accumulated drift
bound. One loop (:func:`_loop`) serves every ``parallel_mode``; a stepper
holds the mode's state and steps: :class:`_SingleStepper` on one device,
``parallel/pm.ReplicatedStepper`` (particles sharded, grids replicated)
and ``parallel/slab.SlabStepper`` (both sharded in x-slabs) over a mesh.
"""

from __future__ import annotations

import ast
import contextlib
import glob
import logging
import os
from time import perf_counter
from typing import Dict, NamedTuple

import numpy as np
import torch

from . import cosmo, ic, ic_device
from . import integrate as integration
from . import solver as solver_mod
from .models import multigrid
from .ops import mesh as mesh_ops
from .ops import cuda_build, stencil, tiled_pm
from .parallel import ic_slab, slab
from .parallel import mesh as pmesh
from .parallel import pm as par_pm
from .utils import io as iostream
from .utils import profiling
from .utils.config import Params, extra_name, params_from_dict, with_defaults
from .utils.units import set_units


class StepRecord(NamedTuple):
    """What :func:`run` reports for one step of its loop."""

    nsteps: int
    drift: int  # lazy window level, 0 on a sorted step
    # host wall time of the step, device synchronised (step 2 with its
    # trace's start and export when profile_dir is set)
    seconds: float
    overflow: int  # particles outside their drift windows
    launches: dict  # tiled_pm.LAUNCHES and stencil.LAUNCHES after the step
    mean_additional: float  # mean of u after the step (the f(R) scalaron)


def _setup_logging(verbose: int) -> None:
    level = {0: logging.ERROR, 1: logging.WARNING, 2: logging.INFO}.get(verbose)
    if level is None:
        raise ValueError(f"verbose={verbose}, should be 0, 1 or 2")
    logging.basicConfig(level=level, format="%(message)s", force=True)


def _handle_overflow(param, overflow: int, what: str) -> None:
    """A nonzero count means particles left their widened windows and
    deposited (part of) their mass nowhere: the run no longer conserves
    mass. Abort, unless ``on_particle_overflow = warn``."""
    if not overflow:
        return
    msg = f"{what}: {overflow} particles lost this step"
    policy = str(param.get("on_particle_overflow", "raise")).casefold()
    if policy == "warn":
        logging.error("%s -- continuing (on_particle_overflow=warn); "
                      "results do not conserve mass", msg)
        return
    raise RuntimeError(
        msg + " -- aborting (mass is no longer conserved). Fixes: lower "
        "Courant_factor; or set on_particle_overflow=warn to continue "
        "anyway."
    )


def _advance_time(param, tables, aexp_out, t_out, max_abs_acc,
                  max_abs_vel) -> float:
    """Adaptive dt (3 criteria) clamped onto the next output time, then
    the aexp/units/potential_scaling bookkeeping. Sets
    param["write_snapshot"] and returns dt."""
    dt, dts = integration.compute_dt(param, tables, max_abs_acc,
                                     max_abs_vel)
    i_snap_idx = min(int(param["i_snap"]) - 1, len(t_out) - 1)
    t_snap_next = t_out[i_snap_idx]
    if param["t"] + dt > t_snap_next:
        dt = t_snap_next - param["t"]
        param["write_snapshot"] = True
    else:
        param["write_snapshot"] = False
    logging.info("dt conditions: acc=%s vel=%s aexp=%s", *dts)
    param["t"] = param["t"] + dt
    param["aexp_old"] = param["aexp"]
    if param["write_snapshot"]:
        param["aexp"] = float(aexp_out[i_snap_idx])
    else:
        param["aexp"] = float(np.exp(tables[0](param["t"])))
    set_units(param)
    d1_new = float(tables[3](np.log(param["aexp"])))
    d1_old = float(tables[3](np.log(param["aexp_old"]))) or 1.0
    param["potential_scaling"] = (
        param["aexp"] * d1_new / (param["aexp_old"] * d1_old)
    )
    return dt


def _drift_level(need: float, max_drift: int) -> int:
    """Smallest drift-window level (cells) that keeps a lazy step exact
    for an accumulated drift bound of ``need`` cells, or 0 (re-sort) if
    none <= max_drift does; 0.01 is the float-slack margin."""
    for level in range(1, max_drift + 1):
        if need <= level - 0.01:
            return level
    return 0


def _save_pk_mode(param) -> str:
    mode = str(param["save_power_spectrum"]).casefold()
    if mode not in ("no", "z_out", "yes"):
        raise NotImplementedError(
            f"save_power_spectrum={mode!r}, should be 'yes', 'z_out' or 'no'"
        )
    return mode


def _write_pk(pk, param) -> None:
    if pk is None:
        return
    k, Pk, Nmodes = (v.cpu().numpy() for v in pk)
    n = 2 ** int(param["ncoarse"])
    Pk = Pk * (param["boxlen"] / n ** 2) ** 3
    k = k * 2 * np.pi / param["boxlen"]
    iostream.write_power_spectrum_to_ascii_file(k, Pk, Nmodes, param)


def _resolve_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' but torch sees no CUDA device; pass "
            "device='cpu' to run on the plain PyTorch twins"
        )
    return device


def run(param, device="cuda", devices=None) -> list:
    """Run an N-body simulation from a parameter container (dict/Params)
    on ``device`` (``"cuda"`` by default; raises if CUDA is not
    available, and never falls back to the CPU on its own).

    ``parallel_mode = replicated`` and ``slab`` run on the mesh
    ``devices``: an ordered list of devices, one per shard, in which a
    device may appear more than once (``["cuda:0"] * 4`` runs four shards
    in turns on one card, ``["cpu"] * 4`` on the CPU); by default every
    visible card, or the CPU alone for ``device="cpu"``. ``single``
    ignores it.

    Returns one :class:`StepRecord` per step of the loop.

    Slab mode runs every theory and solver, and builds LPT initial
    conditions sharded on the mesh (``parallel/ic_slab.py``) whenever
    ``ic_slab.supported`` holds (else on the host, distributed by base
    plane), as ``pysco_tpu.run`` does. Single and replicated mode run all
    three particle engines (``pallas``, ``dense``, ``scatter``); slab mode
    runs ``pallas`` only, and refuses the others. The lazy re-binning is
    the tiled engine's; the dense engine sorts at every step and aborts on
    a plane-capacity overflow, as in ``pysco_tpu``.

    ``compile_cache`` is read for parity and changes nothing: the JAX
    package's persistent XLA cache has its counterpart in the kernel
    library built once under ``csrc/build`` (``ops/cuda_build.py``), its
    file name tagged by the sources' content, which every later process
    reuses.

    Differences from ``pysco_tpu.run``:
    - a step's overflow count (drift-bound violations, slab capacity,
      the dense engine's plane capacity) is checked *before* its power
      spectrum is written, the first force evaluation's too, so an aborted
      step leaves no P(k) file (the JAX loops write first);
    - slab mode's multigrid and FAS take a slab's first guess -h^2 b / 6
      (and the f(R) scalaron's) with h from the grid's size, where the JAX
      slab functions take the slab's height: the port's slab solves are the
      single-device ones (``parallel/slab_mg.py``).
    """
    device = _resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if isinstance(param, Dict) and not isinstance(param, Params):
        param = params_from_dict(param)
    param = with_defaults(param)
    verbose = int(param["verbose"])
    _setup_logging(verbose)
    # full timings at verbose = 2: per-cycle multigrid residual lines and
    # per-step wall-clock at INFO; an earlier run's setting does not stay
    multigrid.set_residual_logging(verbose >= 2)
    logging.info("compile_cache=%s: the kernel library under %s is built "
                 "once and reused (the key changes nothing else)",
                 param.get("compile_cache", "yes"), cuda_build.BUILD_DIR)
    param["write_snapshot"] = False
    param["extra"] = extra_name(param)

    z_out = param["z_out"]
    if isinstance(z_out, str):
        z_out = ast.literal_eval(z_out)
    z_out = list(z_out)

    os.makedirs(f"{param['base']}/power", exist_ok=True)
    for i in range(len(z_out) + 1):
        os.makedirs(f"{param['base']}/output_{i:05d}", exist_ok=True)

    logging.warning("----- Compute background cosmology -----")
    tables = cosmo.generate(param)
    param["aexp"] = 1.0 / (1 + param["z_start"])
    set_units(param)
    if "nsteps" not in param:
        param["nsteps"] = 0

    logging.warning("----- Initial conditions -----")
    parallel_mode = str(param.get("parallel_mode", "single")).casefold()
    device_ic = parallel_mode == "single" and ic_device.supported(param)
    mesh = slab_state = None
    if parallel_mode in ("slab", "replicated"):
        mesh = pmesh.make_mesh(devices=devices, device=device)
    slab_ic = parallel_mode == "slab" and ic_slab.supported(param, len(mesh))
    if device_ic:
        # the LPT algebra on the device (only the RNG draw on the host),
        # straight into the column state
        position, velocity = ic_device.generate_lpt(param, tables, device)
    elif slab_ic:
        # the LPT algebra sharded over the mesh: no device holds more than
        # its slab, and the particles start on the shard that owns them
        slab_state = ic_slab.generate_lpt_slab(param, tables, mesh)
        position = velocity = None
    else:
        # a restart restores parameters (parallel_mode among them) from
        # the snapshot, so the configuration is read only after this call
        position, velocity = ic.generate(param, tables)
    param["t"] = float(tables[1](np.log(param["aexp"])))
    param["aexp_old"] = param["aexp"]
    logging.warning("aexp=%s t=%s", param["aexp"], param["t"])

    parallel_mode = str(param.get("parallel_mode", "single")).casefold()
    cfg = solver_mod.config_from_param(param)
    integrator = str(param["integrator"]).casefold()
    pk_mode = _save_pk_mode(param)
    if parallel_mode in ("slab", "replicated") and mesh is None:
        mesh = pmesh.make_mesh(devices=devices, device=device)  # a restart
    if parallel_mode == "slab":
        stepper = slab.SlabStepper(param, cfg, integrator, mesh, position,
                                   velocity, slab_state)
    elif parallel_mode == "replicated":
        stepper = par_pm.ReplicatedStepper(param, cfg, integrator, mesh,
                                           position, velocity)
    elif parallel_mode == "single":
        if not device_ic:
            if cfg.particle_engine == "pallas":
                position, velocity = tiled_pm.to_columns_host(
                    position, velocity, cfg.npart)
            position = torch.as_tensor(np.asarray(position, np.float32)).to(
                device)
            velocity = torch.as_tensor(np.asarray(velocity, np.float32)).to(
                device)
        stepper = _SingleStepper(param, cfg, integrator, device, position,
                                 velocity, verbose)
    else:
        raise NotImplementedError(
            f"parallel_mode={parallel_mode!r}, should be 'single', "
            "'replicated' or 'slab'"
        )
    # the stepper holds the state from here on: the initial one goes
    del position, velocity, slab_state
    return _loop(param, tables, z_out, pk_mode, stepper)


class _SingleStepper:
    """The run loop's stepper on one device (:func:`_loop` says what a
    stepper gives): ``integrate.step_lazy_impl`` on the tiled engine with
    ``lazy_sort``, ``step_impl`` otherwise; the scatter engine's Morton
    reorder every ``n_reorder`` steps; the ``profile_dir`` trace of step 2;
    at verbose = 2, the component breakdown of the first force
    evaluation."""

    def __init__(self, param, cfg, integrator, device, position, velocity,
                 verbose):
        self.param, self.cfg, self.integrator = param, cfg, integrator
        self.device, self.verbose = device, verbose
        # CFL-bounded lazy re-binning is the tiled engine's; the dense
        # engine sorts at every step and the scatter engine never does
        self.lazy = bool(param.get("lazy_sort", True)) and (
            cfg.particle_engine == "pallas")
        self.max_drift = cfg.lazy_drift if self.lazy else 0
        # (position, velocity, acceleration, potential, u)
        self.state = [position, velocity, None,
                      *solver_mod.empty_fields(cfg, device)]
        self.tstarts = None

    def first(self, save_pk, dyn):
        cfg = self.cfg
        position, velocity, _, potential, u = self.state
        *self.state, pk, overflow = solver_mod.pm(
            cfg, True, save_pk, position, velocity, potential, u, dyn)
        position, velocity, acceleration, _, u = self.state
        if (self.verbose >= 2 and cfg.particle_engine == "pallas"
                and cfg.npart <= 256 ** 3):
            # one-time per-component breakdown of a force evaluation, each
            # stage timed alone. It holds a second sorted state and force
            # mesh, so it can exhaust the card's memory at the largest
            # sizes: skip it in that case.
            try:
                logging.info(
                    "force-evaluation component timings: %s",
                    profiling.component_breakdown(cfg, position, velocity,
                                                  dyn),
                )
            except torch.cuda.OutOfMemoryError as e:
                logging.warning(
                    "component timing breakdown skipped (%s: needs a state "
                    "clone; insufficient device memory at this size)",
                    type(e).__name__,
                )
        return pk, integration._diagnostics(acceleration, velocity, u,
                                            overflow)

    def step(self, save_pk, presorted, dyn, dt):
        # profile_dir: a device trace of one steady-state step (step 1
        # still pays one-time set-up, the first sort's geometry among it)
        profile_dir = self.param.get("profile_dir", "")
        tracing = bool(profile_dir) and self.param["nsteps"] == 2
        with (profiling.trace(str(profile_dir), self.device) if tracing
              else contextlib.nullcontext()):
            if self.lazy:
                *self.state, self.tstarts, pk, diag = (
                    integration.step_lazy_impl(
                        self.cfg, self.integrator, presorted, save_pk,
                        *self.state, self.tstarts, dyn, dt))
            else:
                *self.state, pk, diag = integration.step_impl(
                    self.cfg, self.integrator, False, save_pk, *self.state,
                    dyn, dt)
            if tracing and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)  # the step's end in it
        return pk, diag

    def after_step(self, nsteps, presorted):
        if (nsteps % int(self.param["n_reorder"]) == 0
                and self.cfg.particle_engine == "scatter"):
            # the tiled and dense engines re-sort at every force
            # evaluation already
            logging.info("Reordering particles")
            self.state[:3] = mesh_ops.reorder_particles(*self.state[:3])

    def rows(self):
        return solver_mod.particles_to_rows(self.cfg, *self.state[:2])

    def overflow_text(self, presorted):
        if self.lazy:
            return ("lazy re-binning drift-bound violation (particles outside "
                    "the widened windows)")
        return "dense particle engine plane-capacity overflow"


def _loop(param, tables, z_out, pk_mode, stepper) -> list:
    """The run loop of every mode: the first force evaluation, then
    adaptive steps up to the last ``z_out``, with P(k) and snapshots at
    the outputs. Returns one :class:`StepRecord` per step.

    ``stepper`` holds the state in its mode's layout and gives:
    - ``cfg``, the ``SolverConfig``;
    - ``max_drift``, the widest lazy re-binning window in cells (0: a sort
      at every step);
    - ``first(save_pk, dyn) -> (pk, diag)``, the first force evaluation;
    - ``step(save_pk, presorted, dyn, dt) -> (pk, diag)``, one step on a
      binning ``presorted`` cells stale (0: sort after the drift);
    - ``after_step(nsteps, presorted)``, what the mode does between steps;
    - ``rows() -> (position, velocity)``, the particles as NumPy rows;
    - ``overflow_text(presorted)``, what a nonzero ``diag.overflow`` means.

    A step's overflow aborts the run before its P(k) is written.
    """
    cfg = stepper.cfg
    logging.warning("----- Run N-body -----")
    dyn = solver_mod.compute_dynamics(param)
    save_pk = pk_mode == "yes"
    pk, diag = stepper.first(save_pk, dyn)
    _handle_overflow(param, int(diag.overflow), stepper.overflow_text(0))
    if save_pk:
        _write_pk(pk, param)
    aexp_out = np.sort(1.0 / (np.array(z_out, dtype=np.float64) + 1))
    t_out = np.array([float(tables[1](np.log(a))) for a in aexp_out])
    logging.info("aexp_out=%s", aexp_out)
    param["i_snap"] = int(param.get("i_snap", 0)) + 1  # the first output
    max_abs_acc = float(diag.max_abs_acc)
    max_abs_vel = float(diag.max_abs_vel)

    # CFL-bounded lazy re-binning: skip the sort while the accumulated
    # drift bound since the last sort fits a drift window
    cum_drift = np.inf  # no binning yet: the first loop step sorts
    records = []
    while param["aexp"] < aexp_out[-1]:
        param["nsteps"] = int(param["nsteps"]) + 1
        dt = _advance_time(param, tables, aexp_out, t_out,
                           max_abs_acc, max_abs_vel)
        dyn = solver_mod.compute_dynamics(param)
        save_pk = pk_mode == "yes" or (
            pk_mode == "z_out" and param["write_snapshot"]
        )
        t_step0 = perf_counter()
        step_bound = (
            max_abs_vel * dt + 0.5 * max_abs_acc * dt * dt
        ) * cfg.ncells_1d
        presorted = _drift_level(cum_drift + step_bound, stepper.max_drift)
        pk, diag = stepper.step(save_pk, presorted, dyn, dt)
        if presorted:
            cum_drift += step_bound
            logging.info("lazy re-binning: sort skipped "
                         "(drift bound %.3f cells, window %d)",
                         cum_drift, presorted)
        else:
            cum_drift = 0.0  # this step sorted after its drift
        # fetching the diagnostics synchronises the devices, so the step's
        # wall time is a true one
        max_abs_acc = float(diag.max_abs_acc)
        max_abs_vel = float(diag.max_abs_vel)
        overflow = int(diag.overflow)
        seconds = perf_counter() - t_step0
        mean_u = float(diag.mean_additional)
        logging.info("step wall time: %.1f ms", 1e3 * seconds)
        records.append(StepRecord(int(param["nsteps"]), presorted, seconds,
                                  overflow,
                                  {**tiled_pm.LAUNCHES, **stencil.LAUNCHES},
                                  mean_u))
        _handle_overflow(param, overflow, stepper.overflow_text(presorted))
        if save_pk:
            _write_pk(pk, param)
        if cfg.theory == "fr" and param["nsteps"] % 10 == 0:
            logging.info("mean(u_scalaron)=%s (should stay close to 1)",
                         mean_u)
        stepper.after_step(int(param["nsteps"]), presorted)
        if param["write_snapshot"]:
            iostream.write_snapshot_particles(*stepper.rows(), param)
            param["i_snap"] = int(param["i_snap"]) + 1
        logging.warning(
            "nsteps=%d aexp=%.6f z=%.4f",
            param["nsteps"], param["aexp"], 1.0 / param["aexp"] - 1,
        )
    return records


def run_paired(param, device="cuda") -> None:
    """Paired-and-fixed convenience runner (``pysco_tpu.run_paired``): run
    both phases of a fixed-amplitude pair (phase shift pi, Angulo &
    Pontzen 2016) on ``device`` into ``base/pair_A`` and ``base/pair_B``,
    and write each matching P(k) output phase-averaged into
    ``base/power``: the mean P(k), the summed mode counts. Raises without
    a card unless ``device="cpu"``, as :func:`run` does."""
    device = _resolve_device(device)
    if isinstance(param, Dict) and not isinstance(param, Params):
        param = params_from_dict(param)
    param = with_defaults(param)
    base = str(param["base"]).rstrip("/")
    for tag, paired in (("pair_A", False), ("pair_B", True)):
        sub = dict(param)
        sub["base"] = f"{base}/{tag}"
        sub["fixed_ICS"] = True
        sub["paired_ICS"] = paired
        run(sub, device=device)

    os.makedirs(f"{base}/power", exist_ok=True)
    for pk_a in sorted(glob.glob(f"{base}/pair_A/power/pk_*.dat")):
        pk_b = pk_a.replace("/pair_A/", "/pair_B/")
        if not os.path.exists(pk_b):
            continue
        a = np.loadtxt(pk_a)
        b = np.loadtxt(pk_b)
        avg = a.copy()
        avg[:, 1] = 0.5 * (a[:, 1] + b[:, 1])
        avg[:, 2] = a[:, 2] + b[:, 2]
        out = f"{base}/power/{os.path.basename(pk_a)}"
        header = "k [h/Mpc]  P(k) [Mpc/h]^3 (pair-averaged)  Nmodes (sum)"
        np.savetxt(out, avg, header=header)
        logging.warning("Write pair-averaged P(k) in %s", out)


def main() -> None:
    import argparse

    from .utils.config import read_param_file

    parser = argparse.ArgumentParser(
        description="pysco-tpu N-body runner, PyTorch/CUDA port")
    parser.add_argument("-c", "--config_file", required=True)
    parser.add_argument("--device", default="cuda",
                        help="torch device (default: cuda)")
    args = parser.parse_args()
    param = read_param_file(args.config_file)
    print(param)
    t_start = perf_counter()
    run(param, device=args.device)
    print(f"Simulation run time: {perf_counter() - t_start} seconds.")


if __name__ == "__main__":
    main()
