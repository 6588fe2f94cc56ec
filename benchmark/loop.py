"""The single-device simulation loop, one step at a time.

A frozen copy of the body of ``pysco_tpu_torch.main.run``'s single-mode
loop, cut from its snapshot writes: dt from ``integrate.compute_dt``
clamped onto the next output time (``main._advance_time``), the lazy
re-binning level from the accumulated drift bound (``main._drift_level``),
the step (``integrate.step_lazy_impl``, or ``step_impl`` when the sort
runs every step), the abort on a drift-bound overflow
(``main._finish_step``) and the P(k) at each output, written as ASCII.
The benchmark drives it so that it can stop at the end of its window and
start the simulation again from a saved state.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from pysco_tpu_torch import integrate, solver
from pysco_tpu_torch.utils.units import set_units


def drift_level(need: float, max_drift: int) -> int:
    """Smallest window level that keeps a lazy step exact for ``need``
    cells of accumulated drift, 0 (re-sort) if none up to max_drift."""
    for level in range(1, max_drift + 1):
        if need <= level - 0.01:
            return level
    return 0


class Simulation:
    """The state of one simulation and the loop that advances it."""

    STATE = ("position", "velocity", "acceleration", "potential", "u",
             "tstarts")
    SCALARS = ("t", "aexp", "aexp_old", "nsteps", "i_snap",
               "potential_scaling", "write_snapshot", "unit_l", "unit_t",
               "unit_d", "mpart")

    def __init__(self, param, tables, cfg, lazy: bool, pk_dir: str):
        self.param = param
        self.tables = tables
        self.cfg = cfg
        self.lazy = lazy
        self.pk_dir = pk_dir
        z_out = sorted(param["z_out"], reverse=True)
        self.aexp_out = np.sort(1.0 / (np.array(z_out, np.float64) + 1))
        self.t_out = np.array([float(tables[1](np.log(a)))
                               for a in self.aexp_out])
        param["i_snap"] = 1
        self.position = self.velocity = self.acceleration = None
        self.potential = self.u = self.tstarts = None
        self.max_abs_acc = self.max_abs_vel = 0.0
        self.cum_drift = np.inf  # no binning yet: the first step sorts
        self.saved = None

    def start(self, position, velocity, acceleration, potential, u):
        """The state after the first force evaluation."""
        self.position, self.velocity = position, velocity
        self.acceleration, self.potential, self.u = acceleration, potential, u
        self.max_abs_acc = float(torch.max(torch.abs(acceleration)))
        self.max_abs_vel = float(torch.max(torch.abs(velocity)))

    @property
    def finished(self) -> bool:
        return self.param["aexp"] >= self.aexp_out[-1]

    def advance_time(self) -> float:
        """dt, clamped onto the next output time; moves aexp, the units and
        the potential's growth rescaling on."""
        param, tables = self.param, self.tables
        param["nsteps"] = int(param["nsteps"]) + 1
        dt, _ = integrate.compute_dt(param, tables, self.max_abs_acc,
                                     self.max_abs_vel)
        i_snap = min(int(param["i_snap"]) - 1, len(self.t_out) - 1)
        param["write_snapshot"] = param["t"] + dt > self.t_out[i_snap]
        if param["write_snapshot"]:
            dt = self.t_out[i_snap] - param["t"]
        param["t"] = param["t"] + dt
        param["aexp_old"] = param["aexp"]
        if param["write_snapshot"]:
            param["aexp"] = float(self.aexp_out[i_snap])
        else:
            param["aexp"] = float(np.exp(tables[0](param["t"])))
        set_units(param)
        d1_new = float(tables[3](np.log(param["aexp"])))
        d1_old = float(tables[3](np.log(param["aexp_old"]))) or 1.0
        param["potential_scaling"] = (param["aexp"] * d1_new
                                      / (param["aexp_old"] * d1_old))
        return dt

    def step(self, force_level=None, force_pk: bool = False) -> dict:
        """One step. ``force_level`` (set-up only) takes a wider drift
        window than the rule needs, or a sort; ``force_pk`` computes a
        P(k) on a step that has no output. Returns what the step did."""
        cfg, param = self.cfg, self.param
        dt = self.advance_time()
        dyn = solver.compute_dynamics(param)
        output = bool(param["write_snapshot"])
        save_pk = output or force_pk
        level = 0
        if self.lazy:
            step_bound = (self.max_abs_vel * dt
                          + 0.5 * self.max_abs_acc * dt * dt) * cfg.ncells_1d
            level = drift_level(self.cum_drift + step_bound, cfg.lazy_drift)
            if force_level is not None and level:
                level = force_level if force_level == 0 else max(
                    level, force_level)
            (self.position, self.velocity, self.acceleration, self.potential,
             self.u, self.tstarts, pk, diag) = integrate.step_lazy_impl(
                cfg, "leapfrog", level, save_pk, self.position,
                self.velocity, self.acceleration, self.potential, self.u,
                self.tstarts, dyn, dt)
            self.cum_drift = self.cum_drift + step_bound if level else 0.0
        else:
            (self.position, self.velocity, self.acceleration, self.potential,
             self.u, pk, diag) = integrate.step_impl(
                cfg, "leapfrog", False, save_pk, self.position,
                self.velocity, self.acceleration, self.potential, self.u,
                dyn, dt)
        self.max_abs_acc = float(diag.max_abs_acc)
        self.max_abs_vel = float(diag.max_abs_vel)
        overflow = int(diag.overflow)
        if not np.isfinite(self.max_abs_acc + self.max_abs_vel):
            raise RuntimeError(
                f"step {param['nsteps']}: the state is no longer finite "
                f"(max |acc| {self.max_abs_acc}, max |vel| "
                f"{self.max_abs_vel})")
        if overflow:
            raise RuntimeError(f"step {param['nsteps']}: {overflow} particles "
                               "left their drift windows (mass lost)")
        if output:
            self._write_pk(pk, int(param["i_snap"]))
            param["i_snap"] = int(param["i_snap"]) + 1
        return {"level": level, "output": output, "pk": pk, "dt": dt,
                "aexp": param["aexp"], "aexp_old": param["aexp_old"]}

    def _write_pk(self, pk, index: int) -> None:
        k, Pk, Nmodes = (v.cpu().numpy() for v in pk)
        n = self.cfg.ncells_1d
        box = float(self.param["boxlen"])
        np.savetxt(os.path.join(self.pk_dir, f"pk_{index:05d}.txt"),
                   np.c_[k * 2 * np.pi / box, Pk * (box / n ** 2) ** 3,
                         Nmodes],
                   header=f"aexp = {self.param['aexp']:.9f}\n"
                          "k [h/Mpc], P(k) [Mpc/h]^3, N_modes")

    def state(self) -> tuple:
        return tuple(getattr(self, k) for k in self.STATE)

    def save(self) -> int:
        """Keep a device copy of the state and the loop's scalars, to start
        again from; returns its bytes."""
        tensors = tuple(None if t is None else t.clone()
                        for t in self.state())
        scalars = {k: self.param[k] for k in self.SCALARS if k in self.param}
        self.saved = (tensors, scalars, self.max_abs_acc, self.max_abs_vel,
                      self.cum_drift)
        return sum(t.numel() * t.element_size() for t in tensors
                   if t is not None)

    def restore(self) -> None:
        """Start again from the saved state."""
        tensors, scalars, self.max_abs_acc, self.max_abs_vel, \
            self.cum_drift = self.saved
        for k in self.STATE:
            setattr(self, k, None)
        for k, t in zip(self.STATE, tensors):
            setattr(self, k, None if t is None else t.clone())
        self.param.update(scalars)
