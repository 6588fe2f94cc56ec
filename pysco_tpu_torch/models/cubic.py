"""f(R) n=1 scalaron operator: per-cell depressed cubic solves (PyTorch
port of ``pysco_tpu/models/cubic.py``).

The reduced scalaron u = sqrt(-f_R) obeys a nonlinear 7-point equation
whose Gauss-Seidel update needs the real root of ``u^3 + p u + q = 0`` per
cell (Bose et al. 2017). By default three float32 Newton steps from the
current grid value polish the root (the scalaron sweep kernel on the
card); ``exact_root`` takes the float64 closed form instead.

Conventions (h = 1/N):
- operator(x, b, q)[ijk] = x^3 + p x + q h^2,
  p = h^2 b - (1/6) sum_nb x_nb^2;
- the Gauss-Seidel cell equation with FAS rhs is x^3 + p x + (q h^2 -
  rhs) = 0, d1 = 27 (q h^2 - rhs) in the closed form.

On an exactly uniform density the solve stays on a nonphysical small root
(the zero-neighbour first guess is itself a near-root); any density
contrast breaks the degeneracy. The JAX module's docstring records why the
background-seeded guess was not adopted.

torch has no ``cbrt``: cube roots of negative float64 values are taken as
sign(v) |v|^(1/3) (:func:`_cbrt`). The closed form and its helpers live in
``ops/stencil.py``, beside the sweep kernel that computes it on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import stencil
# the closed-form root, under the JAX module's names
from ..ops.stencil import _cbrt, _f64, solution_cubic_equation  # noqa: F401
from .laplacian import F_RELAX, _parity, packed_scalaron_smoothing

F32 = torch.float32
F64 = torch.float64


def initialise_potential(b: torch.Tensor, q) -> torch.Tensor:
    """First guess assuming u_nb = 0: root of u^3 + h^2 b u + h^2 q = 0.

    Cardano with the cancellation-free sign choice: d1 = 27 h^2 q < 0, so
    d1 - sqrt(d1^2 - 4 d0^3) is the stable branch (near-empty cells would
    otherwise give C = 0 and an infinite guess)."""
    n = b.shape[-1]  # the grid's size: the z extent, an x-slab's too
    h2 = 1.0 / (n * n)
    d1 = 27.0 * h2 * float(q)
    d0 = -3.0 * h2 * b.to(F64)
    C = _cbrt(0.5 * (d1 - torch.sqrt(d1 * d1 - 4.0 * (d0 * d0 * d0))))
    u = -(1.0 / 3.0) * (C + d0 / C)
    # an invalid cell falls back to the b = 0 root
    fallback = _cbrt(_f64(-h2 * float(q), u))
    u = torch.where(torch.isfinite(u) & (u > 0), u, fallback)
    return u.to(F32)


def operator(x: torch.Tensor, b: torch.Tensor, q) -> torch.Tensor:
    return stencil.residual_plain("cubic", x, b, q=q)


def residual_with_rhs(x: torch.Tensor, b: torch.Tensor, q,
                      rhs: torch.Tensor) -> torch.Tensor:
    return rhs - operator(x, b, q)


def residual_error(x: torch.Tensor, b: torch.Tensor, q) -> torch.Tensor:
    return torch.sqrt(stencil.residual_norm2("cubic", x, b, q=q))


def restrict_residual(x: torch.Tensor, b: torch.Tensor, q) -> torch.Tensor:
    return -stencil.restrict3("cubic", x, b, q=q, residual_only=True)[0]


def restrict_residual_with_rhs(x: torch.Tensor, b: torch.Tensor, q,
                               rhs: torch.Tensor) -> torch.Tensor:
    return stencil.restrict3("cubic", x, b, rhs=rhs, q=q,
                             residual_only=True)[0]


def truncation_error(x: torch.Tensor, b: torch.Tensor, q) -> torch.Tensor:
    """FAS truncation error with the x4 coarse-grid factor,
    ||4 R(op(x, b)) - op(R(x), R(b))||: the cubic residual of (R(x), R(b))
    against the source 4 R(op)."""
    RLx, x_c, b_c = stencil.restrict3("cubic", x, b, q=q)
    return torch.sqrt(stencil.residual_norm2("cubic", x_c, b_c,
                                             rhs=4.0 * RLx, q=q))


def gauss_seidel(x: torch.Tensor, b: torch.Tensor, q, rhs=None,
                 f_relax: float = F_RELAX,
                 exact_root: bool = False) -> torch.Tensor:
    """One red-black sweep of the nonlinear cubic Gauss-Seidel on the full
    lattice: every cell's root is computed and half are kept per colour
    (the oracle of the packed :func:`smoothing`)."""
    n = x.shape[0]
    h2 = 1.0 / (n * n)
    fr = float(np.float32(f_relax))
    parity = _parity(n, x.device)
    if exact_root:
        d1_q = 27.0 * h2 * float(q)
        d1 = d1_q if rhs is None else d1_q - 27.0 * rhs.to(F64)
    else:
        c0_q = float(np.float32(h2) * np.float32(q))
        c0 = c0_q if rhs is None else c0_q - rhs
    for colour in (1, 0):  # red (odd parity) first
        S = stencil.neighbour_sum(x * x)
        p = float(np.float32(h2)) * b - stencil._INVSIX * S
        if exact_root:
            x_new = solution_cubic_equation(p, d1).to(F32)
        else:
            x_new = stencil.newton_root(x, p, c0, 2)
        x = torch.where(parity == colour, x + fr * (x_new - x), x)
    return x


def smoothing(x: torch.Tensor, b: torch.Tensor, q, n_smoothing: int,
              rhs=None, exact_root: bool = False) -> torch.Tensor:
    """n_smoothing red-black sweeps on packed half-lattices (one
    pack/unpack round trip; see laplacian.pack_rb)."""
    return packed_scalaron_smoothing(x, b, q, n_smoothing, rhs, exact_root,
                                     n_power=2)
