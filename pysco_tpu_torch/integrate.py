"""Time integration: leapfrog (KDK) and Euler steps (PyTorch port of
``pysco_tpu/integrate.py``).

One step = kick + drift + periodic wrap + PM force evaluation + kick, run
eagerly where the JAX package jit-compiles and donates the state. Every
update makes new tensors (nothing is updated in place), so a caller may
keep the state it passed in. The adaptive timestep is chosen on the host
from the previous step's max |acc| and max |vel| and the background
tables.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import solver as solver_mod
from .ops import mesh
from .solver import DynScalars, SolverConfig


class StepDiagnostics(NamedTuple):
    max_abs_acc: torch.Tensor
    max_abs_vel: torch.Tensor
    mean_additional: torch.Tensor  # mean of u (the f(R) scalaron)
    overflow: torch.Tensor | int


def _diagnostics(acc, vel, u, overflow) -> StepDiagnostics:
    return StepDiagnostics(torch.max(torch.abs(acc)),
                           torch.max(torch.abs(vel)), torch.mean(u),
                           overflow)


def _half_dt(dt) -> tuple[float, float]:
    """dt and dt/2 rounded to float32, as the JAX step computes them."""
    dt = np.float32(dt)
    return float(dt), float(np.float32(0.5) * dt)


def kick_drift(integrator: str, position, velocity, acceleration, dt):
    """The part of a step before its force evaluation: leapfrog's first
    half kick then the drift, or Euler's drift then its whole kick, and the
    periodic wrap. Returns (position, velocity, last_kick): leapfrog's
    closing half kick is ``velocity - acceleration * last_kick`` with the
    new acceleration; Euler has none (0.0)."""
    dt, half_dt = _half_dt(dt)
    if integrator == "leapfrog":
        velocity = velocity - acceleration * half_dt
        position = mesh.periodic_wrap(position + velocity * dt)
        return position, velocity, half_dt
    if integrator == "euler":
        position = mesh.periodic_wrap(position + velocity * dt)
        return position, velocity - acceleration * dt, 0.0
    raise NotImplementedError(
        f"integrator {integrator!r}, must be 'leapfrog' or 'euler'"
    )


def step_impl(cfg: SolverConfig, integrator: str, first_call: bool,
              save_pk: bool, position, velocity, acceleration, potential, u,
              dyn: DynScalars, dt):
    """One step with a fresh sort; returns (position, velocity,
    acceleration, potential, u, pk, diagnostics). ``first_call`` starts
    the multigrid solves from a Jacobi guess (the run loop passes False:
    its first force evaluation comes before the loop)."""
    position, velocity, last_kick = kick_drift(
        integrator, position, velocity, acceleration, dt)
    (position, velocity, acceleration, potential, u, pk,
     overflow) = solver_mod.pm(cfg, first_call, save_pk, position,
                               velocity, potential, u, dyn)
    if last_kick:
        velocity = velocity - acceleration * last_kick
    diag = _diagnostics(acceleration, velocity, u, overflow)
    return position, velocity, acceleration, potential, u, pk, diag


def step_lazy_impl(cfg: SolverConfig, integrator: str, presorted: int,
                   save_pk: bool, position, velocity, acceleration,
                   potential, u, tstarts, dyn: DynScalars, dt):
    """KDK/Euler step on the tiled engine with lazy re-binning
    (:func:`solver._pm_lazy_impl`): ``presorted = k >= 1`` skips the sort
    and uses k-cell drift-widened windows. Returns (position, velocity,
    acceleration, potential, u, tstarts, pk, diagnostics)."""
    position, velocity, last_kick = kick_drift(
        integrator, position, velocity, acceleration, dt)
    (position, velocity, tstarts, acceleration, potential, u, pk,
     overflow) = solver_mod._pm_lazy_impl(
        cfg, presorted, save_pk, position, velocity, tstarts, potential,
        u, dyn)
    if last_kick:
        velocity = velocity - acceleration * last_kick
    diag = _diagnostics(acceleration, velocity, u, overflow)
    return (position, velocity, acceleration, potential, u, tstarts, pk,
            diag)


def compute_dt(param, tables, max_abs_acc: float, max_abs_vel: float):
    """Host-side adaptive dt: min of the acceleration CFL, velocity CFL and
    maximum scale-factor-variation criteria."""
    dx = 0.5 ** int(param["ncoarse"])
    courant = float(param["Courant_factor"])
    dt1 = courant * np.sqrt(dx / max_abs_acc) if max_abs_acc > 0 else np.inf
    dt2 = courant * dx / max_abs_vel if max_abs_vel > 0 else np.inf
    aexp_factor = 1.0 + 0.01 * float(param["max_aexp_stepping"])
    aexp = float(param["aexp"])
    dt3 = float(
        tables[1](np.log(aexp_factor * aexp)) - tables[1](np.log(aexp))
    )
    return min(dt1, dt2, dt3), (dt1, dt2, dt3)
