"""Replicated-grid PM step: particles sharded over a mesh, fields
replicated (PyTorch port of ``pysco_tpu/parallel/pm.py``).

- the particles are sharded over the mesh (:mod:`.mesh`): the tiled
  engine's columns (4, N_up) by column blocks, the dense and scatter
  engines' rows (N, 3) by row blocks;
- every shard sorts and deposits its particles into a full grid of its own,
  and the grids are summed in shard order (one ``psum``);
- the field solve is the single-device one (``solver._solve_fields``), run
  on identical data on every device of the mesh, so every theory and solver
  of the single mode runs here; shards that share a device share its solve;
- the gather and the kicks and drift are local to the shard.

The particle work scales with the shards while the grid work is replicated:
the mode for a grid that fits every card and a run that the particles
dominate. ``parallel_mode = slab`` shards the grids too.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from .. import solver as solver_mod
from ..integrate import StepDiagnostics, kick_drift
from ..ops import dense_pm, tiled_pm
from ..ops import mesh as mesh_ops
from ..solver import DynScalars, SolverConfig
from . import mesh as pmesh
from .mesh import Mesh


def _sharded_pm(cfg: SolverConfig, mesh: Mesh, first_call: bool,
                save_pk: bool, position: list, velocity: list, potential: list,
                u: list, dyn: DynScalars):
    """Deposit each shard -> psum -> replicated solve -> local gather.
    Returns (position, velocity, acceleration, potential, u, pk, overflow)
    with pk and the summed dense-engine overflow on shard 0's device."""
    n = cfg.ncells_1d
    engine = cfg.particle_engine
    tiled = engine == "pallas"
    scheme = cfg.mass_scheme
    overflow = 0  # a fresh tile sort puts every particle in its window
    if engine == "scatter":
        grids = [mesh_ops.deposit(p, n, scheme) for p in position]
    else:
        if tiled:
            srt = [tiled_pm.sort_particles(p, v, n, scheme,
                                           mode=cfg.sort_mode)
                   for p, v in zip(position, velocity)]
        else:
            srt = [dense_pm.sort_by_plane(p, n, scheme, v)
                   for p, v in zip(position, velocity)]
        position = [s[0] for s in srt]
        velocity = [s[1] for s in srt]
        starts = [s[2] for s in srt]
        if tiled:
            grids = [tiled_pm.deposit(p, t, n, scheme)
                     for p, t in zip(position, starts)]
        else:
            dep = [dense_pm.deposit(p, t, n, scheme)
                   for p, t in zip(position, starts)]
            grids = [d[0] for d in dep]
            overflow = pmesh.psum([d[1] for d in dep], mesh)[0]
    density = pmesh.psum(grids, mesh)
    del grids
    # one solve per device of the mesh, on identical data; the shards of a
    # device share it
    solved = {}
    for r, dev in enumerate(mesh):
        if dev not in solved:
            solved[dev] = solver_mod._solve_fields(
                cfg, first_call, save_pk,
                solver_mod._normalise(cfg, density[r]), potential[r], u[r],
                dyn, leading=tiled)
    del density
    force = [solved[dev][0] for dev in mesh]
    potential = [solved[dev][1] for dev in mesh]
    u = [solved[dev][2] for dev in mesh]
    pk = solved[mesh[0]][3]
    if tiled:
        acc = [tiled_pm.gather_vec_cl(f, p, t, scheme)
               for f, p, t in zip(force, position, starts)]
    elif engine == "dense":
        acc = [dense_pm.gather_vec(f, p, t, scheme)
               for f, p, t in zip(force, position, starts)]
    else:
        acc = [mesh_ops.gather_vec(f, p, scheme)
               for f, p in zip(force, position)]
    return position, velocity, acc, potential, u, pk, overflow


def check_shardable(cfg: SolverConfig, n_dev: int) -> None:
    """The tiled engine's column state must split into Q-aligned shards,
    the row engines' (dense, scatter) rows evenly."""
    if cfg.particle_engine == "pallas":
        if tiled_pm.padded_cols(cfg.npart) % (n_dev * tiled_pm.Q):
            raise ValueError(
                f"npart={cfg.npart}: the column state must split into "
                f"Q={tiled_pm.Q}-aligned shards on {n_dev} devices; pick "
                "npart a multiple of Q * n_devices or use "
                "particle_engine='scatter' (or 'dense', the slower one "
                "on a GPU)"
            )
    elif cfg.npart % n_dev:
        raise ValueError(
            f"npart={cfg.npart} must split evenly over {n_dev} devices for "
            "parallel_mode='replicated' with a row-layout engine"
        )


def make_sharded_step(cfg: SolverConfig, mesh: Mesh,
                      integrator: str = "leapfrog", first_call: bool = False,
                      save_pk: bool = False):
    """Build the replicated-grid step: a plain function
    ``fn(pos, vel, acc, phi, u, dyn, dt) -> (pos, vel, acc, phi, u, pk,
    diag)`` over lists of per-shard tensors (``pk`` is None unless
    ``save_pk``; the diagnostics are tensors on shard 0's device)."""
    check_shardable(cfg, len(mesh))
    if integrator not in ("leapfrog", "euler"):
        raise NotImplementedError(
            f"integrator {integrator!r}, must be 'leapfrog' or 'euler'")

    def step(position, velocity, acceleration, potential, u, dyn, dt):
        moved = [kick_drift(integrator, p, v, a, dt)
                 for p, v, a in zip(position, velocity, acceleration)]
        position = [m[0] for m in moved]
        velocity = [m[1] for m in moved]
        last_kick = moved[0][2]
        (position, velocity, acceleration, potential, u, pk,
         overflow) = _sharded_pm(cfg, mesh, first_call, save_pk, position,
                                 velocity, potential, u, dyn)
        if last_kick:
            velocity = [v - a * last_kick
                        for v, a in zip(velocity, acceleration)]
        diag = StepDiagnostics(
            max_abs_acc=pmesh.pmax(
                [torch.max(torch.abs(a)) for a in acceleration], mesh)[0],
            max_abs_vel=pmesh.pmax(
                [torch.max(torch.abs(v)) for v in velocity], mesh)[0],
            mean_additional=pmesh.pmean(
                [torch.mean(x) for x in u], mesh)[0],
            overflow=overflow,
        )
        return position, velocity, acceleration, potential, u, pk, diag

    return step


class ReplicatedStepper:
    """The run loop's stepper for ``parallel_mode = replicated``
    (``main._loop`` says what a stepper gives): the state sharded over
    ``mesh`` by :func:`shard_state`, the steps of :func:`make_sharded_step`
    (a sort at every step; every theory, solver and engine of the single
    mode), and the scatter engine's Morton reorder of each shard's rows
    every ``n_reorder`` steps. ``position`` and ``velocity`` are the
    host-built rows."""

    max_drift = 0

    def __init__(self, param, cfg: SolverConfig, integrator: str,
                 mesh: Mesh, position, velocity):
        n_dev = len(mesh)
        logging.warning("replicated-grid mode: %d devices, %d particles each",
                        n_dev, cfg.npart // n_dev)
        check_shardable(cfg, n_dev)
        if cfg.particle_engine == "pallas":
            position, velocity = tiled_pm.to_columns_host(position, velocity,
                                                          cfg.npart)
        position = np.asarray(position, np.float32)
        phi0, u0 = solver_mod.empty_fields(cfg, "cpu")
        # (position, velocity, acceleration, potential, u), per shard
        self.state = shard_state(mesh, position,
                                 np.asarray(velocity, np.float32),
                                 np.zeros_like(position), phi0, u0)
        self.param, self.cfg, self.mesh = param, cfg, mesh
        self.integrator = integrator
        self.steps = None

    def first(self, save_pk: bool, dyn: DynScalars):
        # a zero-dt step is deposit -> sum -> solve -> gather
        *self.state, pk, diag = make_sharded_step(
            self.cfg, self.mesh, self.integrator, first_call=True,
            save_pk=save_pk)(*self.state, dyn, 0.0)
        self.steps = {flag: make_sharded_step(self.cfg, self.mesh,
                                              self.integrator, save_pk=flag)
                      for flag in (False, True)}
        return pk, diag

    def step(self, save_pk: bool, presorted: int, dyn: DynScalars, dt):
        *self.state, pk, diag = self.steps[save_pk](*self.state, dyn, dt)
        return pk, diag

    def after_step(self, nsteps: int, presorted: int) -> None:
        if (nsteps % int(self.param["n_reorder"]) == 0
                and self.cfg.particle_engine == "scatter"):
            logging.info("Reordering particles")
            pos, vel, acc = self.state[:3]
            # each shard's rows, among themselves
            for r in range(len(self.mesh)):
                pos[r], vel[r], acc[r] = mesh_ops.reorder_particles(
                    pos[r], vel[r], acc[r])

    def rows(self):
        return solver_mod.particles_to_rows(
            self.cfg, *gather_state(*self.state[:2]))

    def overflow_text(self, presorted: int) -> str:
        return "dense particle engine plane-capacity overflow"


def shard_state(mesh: Mesh, position, velocity, acceleration, potential, u):
    """Place a state (tensors or NumPy arrays) on the mesh: particles
    sharded -- columns (4, N_up) along the column axis, rows (N, 3) along
    the row axis -- and fields replicated, one copy per device."""
    def t(a):
        return torch.as_tensor(a).to(torch.float32)

    position, velocity, acceleration = t(position), t(velocity), t(
        acceleration)
    columnar = position.ndim == 2 and position.shape[0] == 4
    axis = 1 if columnar else 0
    return (pmesh.scatter(position, mesh, axis),
            pmesh.scatter(velocity, mesh, axis),
            pmesh.scatter(acceleration, mesh, axis),
            pmesh.replicate(t(potential), mesh),
            pmesh.replicate(t(u), mesh))


def gather_state(*arrays):
    """Per-shard particle lists -> one tensor each on shard 0's device
    (columns joined along the column axis, rows along the row axis)."""
    def columnar(xs):
        return xs[0].ndim == 2 and xs[0].shape[0] == 4

    return tuple(pmesh.gather(xs, 1 if columnar(xs) else 0) for xs in arrays)
