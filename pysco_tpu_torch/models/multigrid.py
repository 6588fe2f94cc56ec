"""Geometric multigrid: linear V/F/W cycles and the Full Approximation
Scheme (PyTorch port of ``pysco_tpu/models/multigrid.py``).

The recursion over grid levels has depth ``ncoarse - 3`` (the coarsest
handled grid is 4^3). The outer "cycle until the residual norm drops
below the tolerance" loop, a ``lax.while_loop`` in the JAX package, is a
host loop here with one scalar fetch per cycle; the stop test is the
same, on float32 values: stop when err <= tol or the per-cycle
improvement ratio falls under 2 (2 err > prev), or after
:data:`MAX_CYCLES` cycles. On the card the residual norm is summed in a
fixed order, so the loop takes the same branch on every run.

FAS: tau-correction ``res_c = 4 * res_c + op(R(x), R(b))`` with the x4
residual normalisation of Laplacian-type operators; the operator sets are
the reformulated Laplacian and the f(R) scalaron's cubic (n = 1) and
quartic (n = 2) equations.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ..ops import mesh, stencil
from . import cubic as cubic_mod
from . import laplacian as lap
from . import quartic as quartic_mod

MAX_CYCLES = 30  # safety cap, as in the JAX package; the reference has none

# solves and cycles run by _converge since the last reset_stats(): all of
# them, and of those the FAS ones (the f(R) scalaron) on their own
STATS = {"solves": 0, "cycles": 0, "fas_solves": 0, "fas_cycles": 0}


# When True, _converge logs a "residual error vs tolerance" line per cycle
# at INFO (the JAX package's LOG_RESIDUALS; run() sets it at verbose >= 2).
# The loop holds both values on the host already, so the line costs no
# extra synchronisation.
LOG_RESIDUALS = False


def reset_stats() -> None:
    for k in STATS:
        STATS[k] = 0


def set_residual_logging(enabled: bool) -> None:
    """Toggle the per-cycle residual log line."""
    global LOG_RESIDUALS
    LOG_RESIDUALS = bool(enabled)


@dataclass(frozen=True)
class FASOps:
    """Theory-specific operator set used by FAS cycles.

    smoothing(x, b, n, rhs) -> x ; operator(x, b) -> array ;
    restrict_residual(x, b, rhs) -> coarse array ;
    residual_error(x, b) -> scalar ; truncation_error(x, b) -> scalar ;
    restrict_all(x, b, rhs) -> (restrict_residual(x, b, rhs), R(x), R(b)),
    one fine-lattice pass of the fused restriction kernel.
    """

    smoothing: Callable
    operator: Callable
    restrict_residual: Callable
    residual_error: Callable
    truncation_error: Callable
    restrict_all: Callable


def _restrict_all_fused(kind: str, x, b, rhs, q=None):
    """Shared restrict_all: (R(rhs - op), R(x), R(b)) in one pass of
    :func:`stencil.restrict3`; without ``rhs`` the residual is -op, so the
    restricted op flips sign."""
    res_c, x_c, b_c = stencil.restrict3(kind, x, b, rhs=rhs, q=q)
    if rhs is None:
        res_c = -res_c
    return res_c, x_c, b_c


def fas_ops_laplacian() -> FASOps:
    def smoothing(x, b, n, rhs=None):
        if rhs is None:
            return lap.smoothing(x, b, n)
        return lap.smoothing_with_rhs(x, b, n, rhs)

    def restrict_residual(x, b, rhs=None):
        if rhs is None:
            return mesh.minus_restriction(lap.operator_reformulated(x, b))
        return mesh.restriction(rhs - lap.operator_reformulated(x, b))

    return FASOps(
        smoothing=smoothing,
        operator=lap.operator_reformulated,
        restrict_residual=restrict_residual,
        residual_error=lap.residual_error_reformulated,
        truncation_error=lap.truncation_error_reformulated,
        restrict_all=lambda x, b, rhs=None: _restrict_all_fused(
            "reformulated", x, b, rhs),
    )


def _fas_ops_scalaron(kind: str, mod, q, exact_root: bool) -> FASOps:
    def smoothing(x, b, n, rhs=None):
        return mod.smoothing(x, b, q, n, rhs, exact_root=exact_root)

    def restrict_residual(x, b, rhs=None):
        if rhs is None:
            return mod.restrict_residual(x, b, q)
        return mod.restrict_residual_with_rhs(x, b, q, rhs)

    return FASOps(
        smoothing=smoothing,
        operator=lambda x, b: mod.operator(x, b, q),
        restrict_residual=restrict_residual,
        residual_error=lambda x, b: mod.residual_error(x, b, q),
        truncation_error=lambda x, b: mod.truncation_error(x, b, q),
        restrict_all=lambda x, b, rhs=None: _restrict_all_fused(
            kind, x, b, rhs, q=q),
    )


def fas_ops_cubic(q, exact_root: bool = False) -> FASOps:
    """The f(R) n = 1 scalaron equation u^3 + p u + q h^2 = 0."""
    return _fas_ops_scalaron("cubic", cubic_mod, q, exact_root)


def fas_ops_quartic(q, exact_root: bool = False) -> FASOps:
    """The f(R) n = 2 scalaron equation u^4 + p u + q h^2 = 0."""
    return _fas_ops_scalaron("quartic", quartic_mod, q, exact_root)


# ---------------------------------------------------------------------------
# Linear cycles
# ---------------------------------------------------------------------------

def _coarsest(level: int, ncoarse: int) -> bool:
    return level >= ncoarse - 3


def _coarse_correction(x, b, ncoarse, Npre, Npost, level, recurse):
    """Restrict the residual, solve the coarse problem (smoothing on the
    coarsest level, ``recurse`` above it) and add its prolongation."""
    res_c = lap.restrict_residual(x, b)
    x_c = lap.initialise_potential(res_c)
    if _coarsest(level, ncoarse):
        x_c = lap.smoothing(x_c, res_c, Npre)
    else:
        x_c = recurse(x_c, res_c, ncoarse, Npre, Npost, level + 1)
    return mesh.add_prolongation(x, x_c)


def V_cycle(x, b, ncoarse: int, Npre: int, Npost: int, level: int = 0):
    x = lap.smoothing(x, b, Npre)
    x = _coarse_correction(x, b, ncoarse, Npre, Npost, level, V_cycle)
    return lap.smoothing(x, b, Npost)


def F_cycle(x, b, ncoarse: int, Npre: int, Npost: int, level: int = 0):
    x = lap.smoothing(x, b, Npre)
    x = _coarse_correction(x, b, ncoarse, Npre, Npost, level, F_cycle)
    x = lap.smoothing(x, b, Npre)
    x = _coarse_correction(x, b, ncoarse, Npre, Npost, level, V_cycle)
    return lap.smoothing(x, b, Npost)


def W_cycle(x, b, ncoarse: int, Npre: int, Npost: int, level: int = 0):
    for last in (False, True):
        x = lap.smoothing(x, b, Npre)
        x = _coarse_correction(x, b, ncoarse, Npre, Npost, level, W_cycle)
        if last:
            x = lap.smoothing(x, b, Npost)
    return x


def _converge(x, b, cycle_fn, error_fn, tolerance, fas: bool = False):
    """Iterate ``cycle_fn`` until err <= tolerance or the improvement
    ratio falls under 2; one scalar fetch per cycle. ``fas`` counts the
    solve under STATS' FAS entries too."""
    tol = np.float32(float(tolerance))
    prev = np.float32(1e30)
    STATS["solves"] += 1
    STATS["fas_solves"] += int(fas)
    for it in range(1, MAX_CYCLES + 1):
        x = cycle_fn(x, b)
        STATS["cycles"] += 1
        STATS["fas_cycles"] += int(fas)
        err = np.float32(float(error_fn(x, b)))
        if LOG_RESIDUALS:
            logging.info("multigrid: cycle %d residual error %.3e "
                         "(tolerance %.3e)", it, err, tol)
        if err <= tol or err * np.float32(2) > prev:
            break
        prev = err
    return x


def linear(x, b, ncoarse: int, Npre: int, Npost: int, tolerance,
           cycle: str = "V"):
    """Linear multigrid solve of Laplacian(x) = b to the given tolerance
    (typically epsrel * truncation_error(x), computed by the caller)."""
    cyc = {"V": V_cycle, "F": F_cycle, "W": W_cycle}[cycle]
    return _converge(
        x, b, lambda x_, b_: cyc(x_, b_, ncoarse, Npre, Npost),
        lap.residual_error, tolerance,
    )


# ---------------------------------------------------------------------------
# FAS cycles
# ---------------------------------------------------------------------------

def _fas_correction(x, b, ops: FASOps, ncoarse, Npre, Npost, level, rhs,
                    recurse, b_c=None):
    """FAS coarse-grid correction: restrict, tau-correct, solve the coarse
    problem, add the prolongation of its change. ``b_c`` reuses the
    coarse source of an earlier leg (the F-cycle's second leg)."""
    res_c, x_c, b_c_new = ops.restrict_all(x, b, rhs)
    b_c = b_c_new if b_c is None else b_c
    res_c = 4.0 * res_c + ops.operator(x_c, b_c)
    if _coarsest(level, ncoarse):
        x_corr_c = ops.smoothing(x_c, b_c, Npre, res_c)
    else:
        x_corr_c = recurse(x_c, b_c, ops, ncoarse, Npre, Npost, level + 1,
                           res_c)
    return mesh.add_prolongation(x, x_corr_c - x_c), b_c


def V_cycle_FAS(x, b, ops: FASOps, ncoarse: int, Npre: int, Npost: int,
                level: int = 0, rhs: Optional[torch.Tensor] = None):
    x = ops.smoothing(x, b, Npre, rhs)
    x, _ = _fas_correction(x, b, ops, ncoarse, Npre, Npost, level, rhs,
                           V_cycle_FAS)
    return ops.smoothing(x, b, Npost, rhs)


def F_cycle_FAS(x, b, ops: FASOps, ncoarse: int, Npre: int, Npost: int,
                level: int = 0, rhs: Optional[torch.Tensor] = None):
    """FAS F-cycle: an F-recursion first leg, then a V-cycle second leg,
    Npre smoothing between legs."""
    x = ops.smoothing(x, b, Npre, rhs)
    x, b_c = _fas_correction(x, b, ops, ncoarse, Npre, Npost, level, rhs,
                             F_cycle_FAS)
    x = ops.smoothing(x, b, Npre, rhs)
    x, _ = _fas_correction(x, b, ops, ncoarse, Npre, Npost, level, rhs,
                           V_cycle_FAS, b_c)
    return ops.smoothing(x, b, Npost, rhs)


def W_cycle_FAS(x, b, ops: FASOps, ncoarse: int, Npre: int, Npost: int,
                level: int = 0, rhs: Optional[torch.Tensor] = None):
    for last in (False, True):
        x = ops.smoothing(x, b, Npre, rhs)
        x, _ = _fas_correction(x, b, ops, ncoarse, Npre, Npost, level, rhs,
                               W_cycle_FAS)
        if last:
            x = ops.smoothing(x, b, Npost, rhs)
    return x


def FAS(x, b, ops: FASOps, ncoarse: int, Npre: int, Npost: int, tolerance,
        cycle: str = "V"):
    """Full Approximation Scheme solve of ops.operator(x, b) = 0."""
    cyc = {"V": V_cycle_FAS, "F": F_cycle_FAS, "W": W_cycle_FAS}[cycle]
    return _converge(
        x, b, lambda x_, b_: cyc(x_, b_, ops, ncoarse, Npre, Npost),
        ops.residual_error, tolerance, fas=True,
    )
