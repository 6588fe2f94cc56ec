"""Run loops and CLI (PyTorch port of ``pysco_tpu/main.py``).

``run(param, device)`` computes the background tables on the host and
the initial conditions on the device (LPT on the tiled engine, unless
``ic_device`` is false) or on the host, then runs the adaptive
kick-drift-kick loop on the device, writing snapshots and power spectra
at each ``z_out``. The
host picks dt from the previous step's max |acc| and max |vel|, and
the lazy re-binning level from the accumulated drift bound.
``parallel_mode = replicated`` and ``slab`` run the same loop over a mesh
of devices (``parallel/``): particles sharded and grids replicated, or
both sharded in x-slabs.
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
from .parallel import ic_slab
from .parallel import mesh as pmesh
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


def _output_times(param, tables, z_out):
    """The output scale factors and times, and the snapshot counter moved
    on to the first of them."""
    aexp_out = np.sort(1.0 / (np.array(z_out, dtype=np.float64) + 1))
    t_out = np.array([float(tables[1](np.log(a))) for a in aexp_out])
    logging.info("aexp_out=%s", aexp_out)
    param["i_snap"] = int(param.get("i_snap", 0)) + 1
    return aexp_out, t_out


def _finish_step(param, cfg, records, t_step0, presorted, diag,
                 what: str, save_pk: bool, pk) -> tuple:
    """The end of a step in every loop: fetch the diagnostics (which
    synchronises the devices, so the step's wall time is a true one), record
    the step, abort on an overflow, then write the P(k). Returns
    (max_abs_acc, max_abs_vel)."""
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
    _handle_overflow(param, overflow, what)
    if save_pk:
        _write_pk(pk, param)
    if cfg.theory == "fr" and param["nsteps"] % 10 == 0:
        logging.info("mean(u_scalaron)=%s (should stay close to 1)", mean_u)
    return max_abs_acc, max_abs_vel


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
    - a step's overflow count (drift-bound violations, slab capacity) is
      checked *before* its power spectrum is written, in all three loops,
      so an aborted step leaves no P(k) file (the JAX loops write first);
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
    if parallel_mode in ("slab", "replicated"):
        if mesh is None:  # a restart that restored the mode
            mesh = pmesh.make_mesh(devices=devices, device=device)
        if parallel_mode == "slab":
            return _run_slab(param, tables, cfg, integrator, pk_mode,
                             position, velocity, z_out, mesh, slab_state)
        return _run_replicated(param, tables, cfg, integrator, pk_mode,
                               position, velocity, z_out, mesh)
    if parallel_mode != "single":
        raise NotImplementedError(
            f"parallel_mode={parallel_mode!r}, should be 'single', "
            "'replicated' or 'slab'"
        )

    if not device_ic:
        if cfg.particle_engine == "pallas":
            position, velocity = tiled_pm.to_columns_host(
                position, velocity, cfg.npart)
        position = torch.as_tensor(np.asarray(position, np.float32)).to(
            device)
        velocity = torch.as_tensor(np.asarray(velocity, np.float32)).to(
            device)
    potential, u = solver_mod.empty_fields(cfg, device)

    logging.warning("----- Run N-body -----")
    dyn = solver_mod.compute_dynamics(param)
    save_pk_first = pk_mode == "yes"
    position, velocity, acceleration, potential, u, pk, _ = solver_mod.pm(
        cfg, True, save_pk_first, position, velocity, potential, u, dyn
    )
    if save_pk_first:
        _write_pk(pk, param)

    if (verbose >= 2 and cfg.particle_engine == "pallas"
            and cfg.npart <= 256 ** 3):
        # one-time per-component breakdown of a force evaluation, each
        # stage timed alone. It holds a second sorted state and force
        # mesh, so it can exhaust the card's memory at the largest sizes:
        # skip it in that case.
        try:
            logging.info(
                "force-evaluation component timings: %s",
                profiling.component_breakdown(cfg, position, velocity, dyn),
            )
        except torch.cuda.OutOfMemoryError as e:
            logging.warning(
                "component timing breakdown skipped (%s: needs a state "
                "clone; insufficient device memory at this size)",
                type(e).__name__,
            )

    aexp_out, t_out = _output_times(param, tables, z_out)

    max_abs_acc = float(torch.max(torch.abs(acceleration)))
    max_abs_vel = float(torch.max(torch.abs(velocity)))

    # CFL-bounded lazy re-binning (tiled engine): skip the sort while the
    # accumulated drift bound since the last sort fits a drift window
    lazy = bool(param.get("lazy_sort", True)) and (
        cfg.particle_engine == "pallas"
    )
    tstarts = None
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
        # profile_dir: a device trace of one steady-state step (step 1
        # still pays one-time set-up, the first sort's geometry among it)
        profile_dir = param.get("profile_dir", "")
        tracing = bool(profile_dir) and param["nsteps"] == 2
        t_step0 = perf_counter()
        with (profiling.trace(str(profile_dir), device) if tracing
              else contextlib.nullcontext()):
            presorted = 0
            if lazy:
                step_bound = (
                    max_abs_vel * dt + 0.5 * max_abs_acc * dt * dt
                ) * cfg.ncells_1d
                presorted = _drift_level(cum_drift + step_bound,
                                         cfg.lazy_drift)
                (position, velocity, acceleration, potential, u, tstarts, pk,
                 diag) = integration.step_lazy_impl(
                    cfg, integrator, presorted, save_pk, position, velocity,
                    acceleration, potential, u, tstarts, dyn, dt,
                )
                if presorted:
                    cum_drift += step_bound
                    logging.info("lazy re-binning: sort skipped "
                                 "(drift bound %.3f cells, window %d)",
                                 cum_drift, presorted)
                else:
                    cum_drift = 0.0  # this step sorted after its drift
            else:
                (position, velocity, acceleration, potential, u, pk,
                 diag) = integration.step_impl(
                    cfg, integrator, False, save_pk, position, velocity,
                    acceleration, potential, u, dyn, dt,
                )
            if tracing and device.type == "cuda":
                torch.cuda.synchronize(device)  # the step's end in the window
        max_abs_acc, max_abs_vel = _finish_step(
            param, cfg, records, t_step0, presorted, diag,
            "lazy re-binning drift-bound violation (particles outside the "
            "widened windows)" if lazy
            else "dense particle engine plane-capacity overflow", save_pk,
            pk)
        if (param["nsteps"] % int(param["n_reorder"]) == 0
                and cfg.particle_engine == "scatter"):
            # the tiled and dense engines re-sort at every force
            # evaluation already
            logging.info("Reordering particles")
            position, velocity, acceleration = mesh_ops.reorder_particles(
                position, velocity, acceleration)
        if param["write_snapshot"]:
            pos_np, vel_np = solver_mod.particles_to_rows(cfg, position,
                                                          velocity)
            iostream.write_snapshot_particles(pos_np, vel_np, param)
            param["i_snap"] = int(param["i_snap"]) + 1
        logging.warning(
            "nsteps=%d aexp=%.6f z=%.4f",
            param["nsteps"], param["aexp"], 1.0 / param["aexp"] - 1,
        )
    return records


def _run_replicated(param, tables, cfg, integrator, pk_mode, position,
                    velocity, z_out, mesh) -> list:
    """Replicated-grid run loop (``parallel/pm.py``): particles sharded
    over the mesh, field grids replicated, one sum of the deposited grids
    per force evaluation and everything else local. Every theory, solver
    and engine of the single mode; a sort at every step, and an abort on
    a dense-engine plane-capacity overflow."""
    from .parallel import pm as par_pm

    n_dev = len(mesh)
    logging.warning("replicated-grid mode: %d devices, %d particles each",
                    n_dev, cfg.npart // n_dev)
    par_pm.check_shardable(cfg, n_dev)
    if cfg.particle_engine == "pallas":
        position, velocity = tiled_pm.to_columns_host(position, velocity,
                                                      cfg.npart)
    position = np.asarray(position, np.float32)
    phi0, u0 = solver_mod.empty_fields(cfg, "cpu")
    pos_d, vel_d, acc_d, phi_d, u_d = par_pm.shard_state(
        mesh, position, np.asarray(velocity, np.float32),
        np.zeros_like(position), phi0, u0)

    logging.warning("----- Run N-body -----")
    dyn = solver_mod.compute_dynamics(param)
    save_pk_first = pk_mode == "yes"
    # first force evaluation: a zero-dt step is deposit -> sum -> solve ->
    # gather
    pos_d, vel_d, acc_d, phi_d, u_d, pk, diag = par_pm.make_sharded_step(
        cfg, mesh, integrator, first_call=True, save_pk=save_pk_first,
    )(pos_d, vel_d, acc_d, phi_d, u_d, dyn, 0.0)
    if save_pk_first:
        _write_pk(pk, param)
    steps = {flag: par_pm.make_sharded_step(cfg, mesh, integrator,
                                            save_pk=flag)
             for flag in (False, True)}

    aexp_out, t_out = _output_times(param, tables, z_out)
    max_abs_acc = float(diag.max_abs_acc)
    max_abs_vel = float(diag.max_abs_vel)
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
        pos_d, vel_d, acc_d, phi_d, u_d, pk, diag = steps[save_pk](
            pos_d, vel_d, acc_d, phi_d, u_d, dyn, dt)
        max_abs_acc, max_abs_vel = _finish_step(
            param, cfg, records, t_step0, 0, diag,
            "dense particle engine plane-capacity overflow", save_pk, pk)
        if (param["nsteps"] % int(param["n_reorder"]) == 0
                and cfg.particle_engine == "scatter"):
            logging.info("Reordering particles")
            for r in range(n_dev):  # each shard's rows, among themselves
                pos_d[r], vel_d[r], acc_d[r] = mesh_ops.reorder_particles(
                    pos_d[r], vel_d[r], acc_d[r])
        if param["write_snapshot"]:
            pos_np, vel_np = solver_mod.particles_to_rows(
                cfg, *par_pm.gather_state(pos_d, vel_d))
            iostream.write_snapshot_particles(pos_np, vel_np, param)
            param["i_snap"] = int(param["i_snap"]) + 1
        logging.warning(
            "nsteps=%d aexp=%.6f z=%.4f",
            param["nsteps"], param["aexp"], 1.0 / param["aexp"] - 1,
        )
    return records


def _run_slab(param, tables, cfg, integrator, pk_mode, position, velocity,
              z_out, mesh, state=None) -> list:
    """Slab-decomposed run loop (``parallel/slab.py``): grids and particles
    sharded in x over the mesh, every theory and solver, the tiled engine
    only. ``state`` is the sharded state of ``ic_slab.generate_lpt_slab``;
    without it the host-built particles are distributed by their base
    plane."""
    from .parallel import slab

    slab.check_supported(cfg)
    n_dev = len(mesh)
    logging.warning("slab mode: %d devices, %d planes each",
                    n_dev, cfg.ncells_1d // n_dev)
    slack = float(param.get("slab_slack", 1.25))
    if state is None:
        state = slab.distribute_particles(mesh, cfg, position, velocity,
                                          slack)
    del position, velocity
    pos_d, vel_d, acc_d, phi_d, u_d, ts_d = state
    del state
    step_fns = {}

    def step_fn(save_pk, first_call=False, presorted=0):
        key = (save_pk, first_call, presorted)
        if key not in step_fns:
            step_fns[key] = slab.make_slab_step(
                cfg, mesh, integrator, save_pk=save_pk,
                first_call=first_call, presorted=presorted)
        return step_fns[key]

    logging.warning("----- Run N-body -----")
    dyn = solver_mod.compute_dynamics(param)
    save_pk_first = pk_mode == "yes"
    # first force evaluation: a zero-dt step (a kick by acc = 0 and no
    # drift) is migrate -> sort -> deposit -> solve -> gather
    pos_d, vel_d, acc_d, phi_d, u_d, ts_d, pk, diag = step_fn(
        save_pk_first, first_call=True)(pos_d, vel_d, acc_d, phi_d, u_d,
                                        ts_d, dyn, 0.0)
    _handle_overflow(param, int(diag.overflow),
                     "slab particle capacity overflow")
    if save_pk_first:
        _write_pk(pk, param)

    # CFL-bounded lazy re-binning, the single-device loop's bound:
    # migration and the sort are skipped while the drift since the last
    # sort fits a window. A k-cell window needs slabs of at least
    # w - 1 + k planes.
    lazy = bool(param.get("lazy_sort", True))
    w = slab._WIDTH[cfg.mass_scheme]
    max_drift = min(int(cfg.lazy_drift),
                    max(cfg.ncells_1d // n_dev - (w - 1), 0))
    if max_drift < 1:
        lazy = False
    cum_drift = np.inf  # the first loop step sorts

    aexp_out, t_out = _output_times(param, tables, z_out)
    max_abs_acc = float(diag.max_abs_acc)
    max_abs_vel = float(diag.max_abs_vel)

    # Capacity re-balancing ahead of need: the slabs take on the density
    # contrast along x as structure forms. Rather than stepping until a
    # shard overflows (an abort), watch the fullest shard after every sorted
    # step and grow every shard's buffers before a particle is at risk;
    # growing appends sentinel columns on each device.
    headroom = float(param.get("slab_rebalance_headroom", 0.9))

    def rebalance_if_needed():
        nonlocal pos_d, vel_d, acc_d, slack
        if not 0.0 < headroom < 1.0:
            return  # disabled
        cap = pos_d[0].shape[1]
        max_count = max(int(t[-1]) for t in ts_d)
        occ = max_count / cap
        if occ <= headroom:
            return
        slack_new = slack * 1.5
        # capacities come in whole column quanta: grow until one more fits
        while slab.shard_capacity(cfg.npart, n_dev, slack_new) <= cap:
            slack_new *= 1.5
        logging.warning(
            "slab occupancy %.0f%% of capacity (max shard %d / %d): "
            "re-balancing with slack %.2f -> %.2f",
            100 * occ, max_count, cap, slack, slack_new,
        )
        slack = slack_new
        param["slab_slack"] = slack  # a restart inherits the grown capacity
        pos_d, vel_d, acc_d = slab.grow_capacity(
            slab.shard_capacity(cfg.npart, n_dev, slack), pos_d, vel_d,
            acc_d)

    rebalance_if_needed()
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
        presorted = (
            _drift_level(cum_drift + step_bound, max_drift) if lazy else 0
        )
        pos_d, vel_d, acc_d, phi_d, u_d, ts_d, pk, diag = step_fn(
            save_pk, presorted=presorted
        )(pos_d, vel_d, acc_d, phi_d, u_d, ts_d, dyn, dt)
        if presorted:
            cum_drift += step_bound
            logging.info("lazy re-binning: slab sort skipped "
                         "(drift bound %.3f cells, window %d)",
                         cum_drift, presorted)
        else:
            cum_drift = 0.0
        max_abs_acc, max_abs_vel = _finish_step(
            param, cfg, records, t_step0, presorted, diag,
            "slab lazy re-binning drift-bound violation" if presorted
            else "slab particle capacity overflow", save_pk, pk)
        if not presorted:
            # the shards' counts change by migration only: on sorted steps
            rebalance_if_needed()
        if param["write_snapshot"]:
            pos_np, vel_np = slab.gather_particles(pos_d, vel_d)
            iostream.write_snapshot_particles(pos_np, vel_np, param)
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
