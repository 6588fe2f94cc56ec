"""Linear 7-point Laplacian operators and red-black Gauss-Seidel smoothing
(PyTorch port of ``pysco_tpu/models/laplacian.py``).

Grid units: the mesh spacing is h = 1/N, so the operator is
``(sum of 6 neighbours - 6x) * N^2``. The "reformulated" fixed-point form
``x + (h^2 b - sum_neighbours)/6`` is what FAS cycles operate on.

Red-black Gauss-Seidel (f_relax = 1.25) runs on packed half-lattices: the
two colours live in separate (n, n/2, n) grids, so each colour update
reads only the other colour. Cells with odd (i+j+k) are "red" and are
relaxed first. On the card each colour update is one launch of the
half-sweep kernel (the scalaron sweep kernel for the f(R) equations,
:func:`packed_scalaron_smoothing`); the residual norms and the
restrictions of the residual go through the residual-norm and
fused-restriction kernels (``ops/stencil.py``). The masked full-lattice
sweeps (:func:`gauss_seidel`, ``cubic.gauss_seidel``,
``quartic.gauss_seidel``) are the oracles of the packed form.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import stencil
# the stencil primitives, under the JAX module's names
from ..ops.stencil import (  # noqa: F401
    _INVSIX, _f32, _parity_ik, neighbour_sum, packed_neighbour_sum)
from ..utils import profiling

F_RELAX = 1.25  # Kravtsov et al. 1997


def operator(x: torch.Tensor) -> torch.Tensor:
    """7-point Laplacian: (sum_nb - 6 x) / h^2."""
    return stencil.residual_plain("laplacian", x)


def operator_reformulated(x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Fixed-point form: x + (h^2 b - sum_nb) / 6."""
    return stencil.residual_plain("reformulated", x, b)


def residual(x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """residual = b - Laplacian(x)."""
    return stencil.residual_plain("linear", x, b)


def residual_error(x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sqrt(sum((b - Lx)^2)), the linear multigrid convergence metric."""
    return torch.sqrt(stencil.residual_norm2("linear", x, b))


def residual_error_reformulated(x: torch.Tensor,
                                b: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(stencil.residual_norm2("reformulated", x, b))


def restrict_residual(x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Restriction of (b - Lx) to the coarse grid."""
    return stencil.restrict3("linear", x, b, residual_only=True)[0]


def truncation_error(x: torch.Tensor) -> torch.Tensor:
    """||restriction(L x) - L(restriction(x))||_2 (Numerical Recipes).

    R(Lx) - L(Rx) is the linear residual of Rx against the source R(Lx),
    so its norm is one more residual-norm pass on the coarse grid."""
    RLx, Rx = stencil.restrict3("laplacian", x)
    return torch.sqrt(stencil.residual_norm2("linear", Rx, RLx))


def truncation_error_reformulated(x: torch.Tensor,
                                  b: torch.Tensor) -> torch.Tensor:
    """FAS variant with the x4 coarse-grid correction:
    ||4 R(op(x, b)) - op(R(x), R(b))||_2, the reformulated residual of
    (R(x), R(b)) against the source 4 R(op)."""
    RLx, x_c, b_c = stencil.restrict3("reformulated", x, b)
    return torch.sqrt(stencil.residual_norm2("reformulated", x_c, b_c,
                                             rhs=4.0 * RLx))


def initialise_potential(b: torch.Tensor) -> torch.Tensor:
    """One Jacobi sweep from zero: u = -h^2 b / 6."""
    n = b.shape[-1]  # the grid's size: the z extent, an x-slab's too
    return _f32(-1.0 / (6.0 * n * n)) * b


def _parity(n: int, device) -> torch.Tensor:
    """(i+j+k) & 1 over the (n, n, n) lattice."""
    i = torch.arange(n, device=device)
    return (i[:, None, None] + i[None, :, None] + i[None, None, :]) & 1


# ---------------------------------------------------------------------------
# Packed red-black half-lattices
#
# Packed layout: s(i,k) = (i+k) & 1;
#   red[i, jp, k]   = x[i, 2*jp + 1 - s, k]   (odd total parity)
#   black[i, jp, k] = x[i, 2*jp + s, k]       (even total parity)
# ---------------------------------------------------------------------------

def pack_rb(x: torch.Tensor):
    """Split a (n, n, n) grid into (red, black) (n, n/2, n) half-lattices."""
    n = x.shape[0]
    x5 = x.reshape(n, n // 2, 2, n)
    s1 = _parity_ik(n, x.device)
    even, odd = x5[:, :, 0, :], x5[:, :, 1, :]
    return torch.where(s1, even, odd), torch.where(s1, odd, even)


def unpack_rb(red: torch.Tensor, black: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_rb`."""
    n = red.shape[0]
    s1 = _parity_ik(n, red.device)
    even = torch.where(s1, red, black)
    odd = torch.where(s1, black, red)
    return torch.stack((even, odd), dim=2).reshape(n, n, n)


def _smoothing_packed(x, b, n_smoothing: int, rhs=None,
                      f_relax: float = F_RELAX):
    """n_smoothing red-black sweeps with a single pack/unpack round trip;
    each colour update is :func:`stencil.half_sweep` (the CUDA kernel on
    the card)."""
    n = x.shape[1]
    red, black = pack_rb(x)
    h2b_r, h2b_b = pack_rb(_f32(1.0 / (n * n)) * b)
    rhs_r, rhs_b = pack_rb(rhs) if rhs is not None else (None, None)
    for _ in range(n_smoothing):
        red = stencil.half_sweep(black, red, h2b_r, True, f_relax, rhs_r)
        black = stencil.half_sweep(red, black, h2b_b, False, f_relax, rhs_b)
    return unpack_rb(red, black)


def packed_scalaron_smoothing(x, b, q, n_smoothing: int, rhs,
                              exact_root: bool,
                              n_power: int) -> torch.Tensor:
    """Packed red-black sweeps of the f(R) scalaron equation
    u^(n_power+1) + p u + q h^2 [- rhs] = 0, one pack/unpack round trip
    (``cubic.smoothing`` with n_power = 2, ``quartic.smoothing`` with 3).

    Each colour update reads only the opposite half-lattice's n_power-th
    power. With the Newton root it is :func:`stencil.scalaron_half_sweep`
    (the CUDA kernel on the card), c0 = h^2 q [- rhs] in float32. With
    ``exact_root`` it is one launch of a float64 closed-form kernel on the
    card: for n_power = 2 :func:`stencil.scalaron_exact_half_sweep` (the
    cubic), d1 = 27 h^2 q [- 27 rhs]; for n_power = 3
    :func:`stencil.scalaron_quartic_exact_half_sweep` (the quartic), c =
    h^2 q [- rhs]; both fold the rhs plane in themselves. The relaxation
    factor is :data:`F_RELAX`.

    Under a profiler a call opens its root's span around its colour
    updates (pack and unpack stay outside it): ``mg.exact_root`` or
    ``mg.newton_root``, with the multigrid level of the ``mg.smooth`` span
    it opens in (0 on the finest grid) and, in its record, its 2
    ``n_smoothing`` colour updates under ``exact_root_sweeps`` or
    ``newton_root_sweeps``. An exact-root call adds them to the step's
    counter ``exact_root_sweeps`` too. The Newton sweep's guard counts its
    cells into the device counter ``newton_root_guarded``
    (:func:`stencil.scalaron_half_sweep`)."""
    n = x.shape[1]
    h2 = 1.0 / (n * n)
    red, black = pack_rb(x)
    hb_r, hb_b = pack_rb(_f32(h2) * b)
    rhs_r, rhs_b = (None, None) if rhs is None else pack_rb(rhs)
    root_span, sweeps = (("mg.exact_root", "exact_root_sweeps") if exact_root
                         else ("mg.newton_root", "newton_root_sweeps"))
    if exact_root:
        # the colour updates, for a profiled step
        profiling.count(sweeps, 2 * n_smoothing)
        if n_power == 2:
            sweep = stencil.scalaron_exact_half_sweep
            coef = 27.0 * h2 * float(q)
        else:
            sweep = stencil.scalaron_quartic_exact_half_sweep
            coef = h2 * float(q)
        coef_r, coef_b = rhs_r, rhs_b  # the kernels fold rhs in

        def half(src, dst, hb, r, to_red):
            return sweep(src, dst, hb, coef, to_red, F_RELAX, r)
    else:
        c0_q = _f32(np.float32(h2) * np.float32(q))
        coef_r, coef_b = ((c0_q, c0_q) if rhs is None else
                          (c0_q - rhs_r, c0_q - rhs_b))

        def half(src, dst, hb, coef, to_red):
            return stencil.scalaron_half_sweep(src, dst, hb, coef, to_red,
                                               F_RELAX, n_power)

    with profiling.span(root_span, profiling.open_level(),
                        {sweeps: 2 * n_smoothing}):
        for _ in range(n_smoothing):
            red = half(black, red, hb_r, coef_r, True)
            black = half(red, black, hb_b, coef_b, False)
    return unpack_rb(red, black)


def _masked_sweep(x, b, rhs, f_relax: float):
    n = x.shape[0]
    h2b = _f32(1.0 / (n * n)) * b
    fr = _f32(f_relax)
    parity = _parity(n, x.device)
    for colour in (1, 0):  # red (odd parity) first
        tgt = (neighbour_sum(x) - h2b) * _INVSIX
        if rhs is not None:
            tgt = tgt + rhs
        x = torch.where(parity == colour, x + fr * (tgt - x), x)
    return x


def gauss_seidel(x: torch.Tensor, b: torch.Tensor,
                 f_relax: float = F_RELAX) -> torch.Tensor:
    """One red-black over-relaxed Gauss-Seidel sweep on the full lattice:
    every cell's stencil is computed and half are kept per colour (the
    oracle of the packed sweep)."""
    return _masked_sweep(x, b, None, f_relax)


def gauss_seidel_with_rhs(x: torch.Tensor, b: torch.Tensor,
                          rhs: torch.Tensor,
                          f_relax: float = F_RELAX) -> torch.Tensor:
    """Red-black sweep for the reformulated equation with FAS rhs:
    x = (sum_nb - h^2 b)/6 + rhs."""
    return _masked_sweep(x, b, rhs, f_relax)


def smoothing(x: torch.Tensor, b: torch.Tensor,
              n_smoothing: int) -> torch.Tensor:
    return _smoothing_packed(x, b, n_smoothing)


def smoothing_with_rhs(x: torch.Tensor, b: torch.Tensor, n_smoothing: int,
                       rhs: torch.Tensor) -> torch.Tensor:
    return _smoothing_packed(x, b, n_smoothing, rhs)
