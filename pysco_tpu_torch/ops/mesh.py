"""Mesh <-> particle operators and gradient stencils (PyTorch port of the
main-path part of ``pysco_tpu/ops/mesh.py``).

- ``deposit`` / ``gather`` / ``gather_vec``: NGP/CIC/TSC mass assignment
  and interpolation on ``(npart, 3)`` row particles by ``index_add`` and
  advanced indexing -- the ``particle_engine = scatter`` path. On the
  card ``index_add`` sums with atomics, so its order is not fixed.
- ``derivative``: 2/3/5/7-point gradient stencils by ``torch.roll``;
  ``derivative_fR`` adds the f(R) scalaron's fifth force.
- ``restriction`` / ``prolongation`` / ``add_prolongation``: the
  multigrid transfer operators; ``add_prolongation`` runs the CUDA kernel
  of ``ops/stencil.py`` on the card.
- ``periodic_wrap``: wrap into [0, 1) while keeping the tiled engine's
  sentinel columns (position >= 1.5).
- ``morton_keys`` / ``reorder_particles``: the scatter engine's
  ``n_reorder`` sort of (npart, 3) rows into Morton order.
"""

from __future__ import annotations

import numpy as np
import torch

from . import morton

F32 = torch.float32
I64 = torch.int64


# ---------------------------------------------------------------------------
# Particle <-> mesh
# ---------------------------------------------------------------------------

def _cells_and_offsets(position: torch.Tensor, ncells_1d: int):
    """Base cell index ``trunc(x*N)`` and offset ``x*N - 0.5 - i`` per axis."""
    xs = position * float(ncells_1d)
    ijk = torch.clamp(xs.to(I64), 0, ncells_1d - 1)
    d = xs - 0.5 - ijk.to(F32)
    return ijk, d


def _flat(i, j, k, n: int):
    return (i * n + j) * n + k


def _cic_axes(position: torch.Tensor, ncells_1d: int):
    ijk, d = _cells_and_offsets(position, ncells_1d)
    i2 = (ijk + torch.sign(d).to(I64)) % ncells_1d
    absd = torch.abs(d)
    return ijk, i2, 1.0 - absd, absd


def _tsc_axes(position: torch.Tensor, ncells_1d: int):
    ijk, d = _cells_and_offsets(position, ncells_1d)
    w0 = 0.75 - d * d
    wm = 0.5 * (0.5 - d) ** 2
    wp = 0.5 * (0.5 + d) ** 2
    cells = ((ijk - 1) % ncells_1d, ijk, (ijk + 1) % ncells_1d)
    return cells, (wm, w0, wp)


def _contribs(position: torch.Tensor, ncells_1d: int, scheme: str):
    """(flat cell index, weight) per support cell, in the JAX module's
    order (x slowest)."""
    scheme = scheme.casefold()
    n = ncells_1d
    if scheme == "ngp":
        ijk, _ = _cells_and_offsets(position, n)
        one = torch.ones(position.shape[0], dtype=F32, device=position.device)
        return [(_flat(ijk[:, 0], ijk[:, 1], ijk[:, 2], n), one)]
    if scheme == "cic":
        ijk, i2, w1, w2 = _cic_axes(position, n)
        cells, weights = (ijk, i2), (w1, w2)
        rng = range(2)
    elif scheme == "tsc":
        cells, weights = _tsc_axes(position, n)
        rng = range(3)
    else:
        raise NotImplementedError(
            f"mass scheme {scheme!r}, should be NGP, CIC or TSC"
        )
    out = []
    for ax in rng:
        for ay in rng:
            for az in rng:
                w = weights[ax][:, 0] * weights[ay][:, 1] * weights[az][:, 2]
                flat = _flat(cells[ax][:, 0], cells[ay][:, 1],
                             cells[az][:, 2], n)
                out.append((flat, w))
    return out


def deposit(position: torch.Tensor, ncells_1d: int,
            scheme: str) -> torch.Tensor:
    """Particle counts per cell of (npart, 3) positions."""
    n = ncells_1d
    grid = torch.zeros(n ** 3, dtype=F32, device=position.device)
    for flat, w in _contribs(position, n, scheme):
        grid.index_add_(0, flat, w)
    return grid.reshape(n, n, n)


def _gather_sum(grid_flat: torch.Tensor, contribs) -> torch.Tensor:
    out = None
    for flat, w in contribs:
        vals = grid_flat[flat]
        term = w[:, None] * vals if vals.ndim == 2 else w * vals
        out = term if out is None else out + term
    return out


def gather(grid: torch.Tensor, position: torch.Tensor,
           scheme: str) -> torch.Tensor:
    """Interpolate a scalar grid at (npart, 3) positions."""
    n = grid.shape[0]
    return _gather_sum(grid.reshape(-1), _contribs(position, n, scheme))


def gather_vec(grid: torch.Tensor, position: torch.Tensor,
               scheme: str) -> torch.Tensor:
    """Interpolate a vector grid (N, N, N, C) at positions -> (npart, C)."""
    n = grid.shape[0]
    flatg = grid.reshape(n ** 3, -1)
    return _gather_sum(flatg, _contribs(position, n, scheme))


# ---------------------------------------------------------------------------
# Gradient stencils
# ---------------------------------------------------------------------------

def stencil_diff(r, n: int, order: int) -> torch.Tensor:
    """The order's difference stencil along one axis of an n-cell grid;
    ``r(shift)`` is the field rolled by ``shift`` cells along that axis
    (``torch.roll``'s sign: r(-1)[i] is cell i + 1)."""
    if order == 2:
        return float(n) * (r(-1) - r(0))
    if order == 3:
        return float(np.float32(0.5 * n)) * (r(-1) - r(1))
    if order == 5:
        return float(np.float32(n / 12.0)) * (
            8.0 * (r(-1) - r(1)) + r(2) - r(-2)
        )
    if order == 7:
        return float(np.float32(n / 60.0)) * (
            45.0 * (r(-1) - r(1)) + 9.0 * (r(2) - r(-2)) - r(3) + r(-3)
        )
    raise NotImplementedError(
        f"gradient stencil order {order}, should be 2, 3, 5 or 7"
    )


def _axis_diff(a: torch.Tensor, axis: int, order: int) -> torch.Tensor:
    return stencil_diff(
        lambda shift: torch.roll(a, shift, dims=axis) if shift else a,
        a.shape[0], order)


def derivative(a: torch.Tensor, order: int,
               leading: bool = False) -> torch.Tensor:
    """Gradient of a scalar grid -> (N, N, N, 3), or (3, N, N, N) with
    ``leading=True`` (the layout the tiled gather reads)."""
    return torch.stack([_axis_diff(a, ax, order) for ax in range(3)],
                       dim=0 if leading else -1)


def derivative_fR(a: torch.Tensor, b: torch.Tensor, f, fR_n: int,
                  order: int, leading: bool = False) -> torch.Tensor:
    """f(R) force mesh: grad(a + f b^(fR_n+1)), f rounded to float32 (the
    stencil is linear, so this is grad(a) + f grad(b^(fR_n+1)))."""
    f = float(np.float32(f))
    if fR_n == 1:
        combined = a + f * b * b
    elif fR_n == 2:
        combined = a + f * b * b * b
    else:
        raise NotImplementedError(f"fR_n must be 1 or 2, got {fR_n}")
    return derivative(combined, order, leading)


# ---------------------------------------------------------------------------
# Multigrid transfer operators
# ---------------------------------------------------------------------------

def restriction(x: torch.Tensor) -> torch.Tensor:
    """Full-weighting restriction: the mean over 2x2x2 children, summed in
    pairs along z, then y, then x (the order of the fused restriction
    kernel and of the JAX kernel's pair-sum contractions). Each axis is
    halved on its own: an x-slab (P, M, M) gives (P/2, M/2, M/2)."""
    p, m, k = (s // 2 for s in x.shape)
    v = x.reshape(p, 2, m, 2, k, 2)
    z = v[..., 0] + v[..., 1]
    y = z[:, :, :, 0] + z[:, :, :, 1]
    return (y[:, 0] + y[:, 1]) * 0.125


def minus_restriction(x: torch.Tensor) -> torch.Tensor:
    return -restriction(x)


def _prolong_axis(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Double the size along ``axis`` with (3/4, 1/4) trilinear weights:
    fine 2r = 3/4 x[r] + 1/4 x[r-1], fine 2r+1 = 3/4 x[r] + 1/4 x[r+1]
    (periodic)."""
    c = 0.75 * x
    even = c + 0.25 * torch.roll(x, 1, axis)
    odd = c + 0.25 * torch.roll(x, -1, axis)
    return torch.stack((even, odd), dim=axis + 1).flatten(axis, axis + 1)


def prolongation(x: torch.Tensor) -> torch.Tensor:
    """Trilinear prolongation (27-point, weights 27/9/3/1 over 64), the
    axes in the order 0, 1, 2."""
    for axis in range(3):
        x = _prolong_axis(x, axis)
    return x


def add_prolongation(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y + prolongation(x): the CUDA kernel on the card, the plain form on
    the CPU (ops/stencil.py)."""
    from . import stencil

    return stencil.add_prolongation(y, x)


# ---------------------------------------------------------------------------
# Particle utilities
# ---------------------------------------------------------------------------

_WRAP_EPS = float(np.float32(-(0.5 ** 25) * (1.0 + 1e-6)))


def periodic_wrap(position: torch.Tensor) -> torch.Tensor:
    """Wrap positions into [0, 1), snapping float32-epsilon negatives to 0.

    Values >= 1.5 are kept: the tiled engine marks its padding columns
    with the sentinel position 2.0 (real positions never reach 1.5, as
    the CFL bound keeps a step's drift to a fraction of a cell).
    """
    x = position
    x = torch.where((x < 0) & (x > _WRAP_EPS), torch.zeros_like(x), x)
    x = torch.where(x < 0, x + 1.0, x)
    return torch.where((x >= 1) & (x < 1.5), x - 1.0, x)


def morton_keys(position: torch.Tensor) -> torch.Tensor:
    """Morton keys of (npart, 3) positions at 21 bits per axis, x the
    most significant (:func:`.morton.positions_to_keys`). The JAX package
    holds them in uint64; they have 63 bits, so int64 holds the same
    integers and sorts in the same order."""
    return morton.positions_to_keys(position)


def reorder_particles(position: torch.Tensor, *arrays):
    """Sort the particles by Morton key, for the locality of the scatter
    engine's deposit; ties keep their order (a stable sort, as
    ``jnp.argsort``). Returns (position, *arrays) in the new order."""
    order = torch.argsort(morton_keys(position), stable=True)
    return (position[order], *(a[order] for a in arrays))
