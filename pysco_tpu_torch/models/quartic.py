"""f(R) n=2 scalaron operator: per-cell depressed quartic solves (PyTorch
port of ``pysco_tpu/models/quartic.py``).

For Hu-Sawicki n=2 the reduced scalaron obeys ``u^4 + p u + q = 0`` per
cell (Ruan et al. 2021). By default three float32 Newton steps from the
current grid value polish the root (the scalaron sweep kernel on the
card); ``exact_root`` takes the float64 resolvent-cubic closed form with
the reference's fallbacks to ``(-q)^(1/4)`` (one kernel a colour update on
the card; the closed form lives in ``ops/stencil.py``, beside it).

Conventions (h = 1/N):
- operator(x, b, q)[ijk] = x^4 + p x + q h^2,
  p = h^2 b - (1/6) sum_nb x_nb^3;
- the cell equation with FAS rhs is u^4 + p u + (q h^2 - rhs) = 0.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import stencil
from ..ops.stencil import _cbrt, _f64, solution_quartic_equation
from .laplacian import F_RELAX, _parity, packed_scalaron_smoothing

F32 = torch.float32
F64 = torch.float64


def initialise_potential(b: torch.Tensor, q) -> torch.Tensor:
    """First guess assuming u_nb = 0, guarded against the small-b
    cancellation in Q + d0/Q (near-empty cells): a non-finite or too small
    result falls back to the b = 0 root (-h^2 q)^(1/4)."""
    n = b.shape[-1]  # the grid's size: the z extent, an x-slab's too
    h2 = 1.0 / (n * n)
    d0 = 12.0 * h2 * float(q)
    p = h2 * b.to(F64)
    d1 = 27.0 * p * p
    Q = _cbrt(0.5 * (d1 + torch.sqrt(d1 * d1 - 4.0 * (d0 * d0 * d0))))
    # a tensor numerator: torch takes float / tensor as reciprocal times
    # float, two roundings where the JAX module has one division
    S = 0.5 * torch.sqrt(torch.abs(Q + _f64(d0, Q) / Q) / 3.0)
    S = torch.where(S > 0.0, S, 1.0)
    u = -S + 0.5 * torch.sqrt(torch.clamp(-4.0 * S * S + p / S, min=0.0))
    fallback = abs(h2 * float(q)) ** 0.25
    good = torch.isfinite(u) & (u > 0.25 * fallback)
    return torch.where(good, u, fallback).to(F32)


def operator(x: torch.Tensor, b: torch.Tensor, q) -> torch.Tensor:
    return stencil.residual_plain("quartic", x, b, q=q)


def residual_with_rhs(x: torch.Tensor, b: torch.Tensor, q,
                      rhs: torch.Tensor) -> torch.Tensor:
    return rhs - operator(x, b, q)


def residual_error(x: torch.Tensor, b: torch.Tensor, q) -> torch.Tensor:
    return torch.sqrt(stencil.residual_norm2("quartic", x, b, q=q))


def restrict_residual(x: torch.Tensor, b: torch.Tensor, q) -> torch.Tensor:
    return -stencil.restrict3("quartic", x, b, q=q, residual_only=True)[0]


def restrict_residual_with_rhs(x: torch.Tensor, b: torch.Tensor, q,
                               rhs: torch.Tensor) -> torch.Tensor:
    return stencil.restrict3("quartic", x, b, rhs=rhs, q=q,
                             residual_only=True)[0]


def truncation_error(x: torch.Tensor, b: torch.Tensor, q) -> torch.Tensor:
    """||4 R(op(x, b)) - op(R(x), R(b))||, as ``cubic.truncation_error``."""
    RLx, x_c, b_c = stencil.restrict3("quartic", x, b, q=q)
    return torch.sqrt(stencil.residual_norm2("quartic", x_c, b_c,
                                             rhs=4.0 * RLx, q=q))


def gauss_seidel(x: torch.Tensor, b: torch.Tensor, q, rhs=None,
                 f_relax: float = F_RELAX,
                 exact_root: bool = False) -> torch.Tensor:
    """One red-black sweep of the nonlinear quartic Gauss-Seidel on the
    full lattice (the oracle of the packed :func:`smoothing`)."""
    n = x.shape[0]
    h2 = 1.0 / (n * n)
    fr = float(np.float32(f_relax))
    parity = _parity(n, x.device)
    if exact_root:
        q_eff = h2 * float(q)
        q_eff = q_eff if rhs is None else q_eff - rhs.to(F64)
    else:
        c0_q = float(np.float32(h2) * np.float32(q))
        c0 = c0_q if rhs is None else c0_q - rhs
    for colour in (1, 0):  # red (odd parity) first
        S = stencil.neighbour_sum(x * x * x)
        p = float(np.float32(h2)) * b - stencil._INVSIX * S
        if exact_root:
            x_new = solution_quartic_equation(p, q_eff).to(F32)
        else:
            x_new = stencil.newton_root(x, p, c0, 3)
        x = torch.where(parity == colour, x + fr * (x_new - x), x)
    return x


def smoothing(x: torch.Tensor, b: torch.Tensor, q, n_smoothing: int,
              rhs=None, exact_root: bool = False) -> torch.Tensor:
    """n_smoothing red-black sweeps on packed half-lattices (see
    cubic.smoothing: cube-sum neighbours and the quartic root)."""
    return packed_scalaron_smoothing(x, b, q, n_smoothing, rhs, exact_root,
                                     n_power=3)
