"""Slab-sharded geometric multigrid: linear V/F/W cycles and FAS over a mesh
(PyTorch port of ``pysco_tpu/parallel/slab_mg.py``).

The x-slab counterpart of ``models/multigrid.py``: the 7-point stencils and
the red-black sweeps exchange one-plane halos (:func:`.slab.exchange_halo_x`)
per colour half, restriction and prolongation act on each slab (x pairs
never straddle two slabs: a slab's height is a power of two), and once a
level's slab is too thin the coarse grid is gathered onto shard 0's device,
the remaining levels run there once through ``models/multigrid.py`` (the
stencil kernels on the card), and every shard takes its planes of the
result. The JAX package runs those levels on every shard, each computing the
same correction; one run gives the same bits.

Every function takes lists of per-shard tensors (shard r holds the global x
planes [r P, (r + 1) P)) and the mesh where the JAX function takes the
device count. The red/black parity is global, (i + r P + j + k) & 1, and the
neighbours are added in the order x-, x+, y-, y+, z-, z+, so a sweep updates
the cells of the single-device sweep in its order and the two agree to
float32 rounding; the packed x-neighbours sit at the same packed index only
because the parity is global. The slab levels are plain torch operations,
as the JAX module's are XLA operations: no stencil kernel has a slab form.

One deliberate difference: a coarse level's first guess -h^2 b / 6 takes h
from the grid's size (``laplacian.initialise_potential`` reads the z
extent), where the JAX module passes a slab to a function that reads its
first axis, the slab's height. Both converge; the port's iterates are the
single-device ones.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ..models import cubic as cubic_mod
from ..models import laplacian as lap
from ..models import multigrid as mg
from ..models import quartic as quartic_mod
from ..models.laplacian import F_RELAX
from ..ops import mesh as mesh_ops
from ..ops.stencil import _INVSIX, _f32, _power, newton_root
from . import mesh as pmesh
from .mesh import Mesh, shardwise
from .slab import exchange_halo_x

F32 = torch.float32
F64 = torch.float64

# gather-to-replicated threshold: levels whose whole grid is at most this
# size run through models/multigrid.py on shard 0's device
REPLICATE_BELOW = 32


def _psum_norm(rs: list, mesh: Mesh) -> torch.Tensor:
    """sqrt of the shard-order sum of every shard's sum of squares, on
    shard 0's device."""
    return torch.sqrt(pmesh.psum([torch.sum(r * r) for r in rs], mesh)[0])


def _global_parity(planes: int, m: int, mesh: Mesh) -> list:
    """(i_global + j + k) & 1 of every shard's (planes, m, m) slab."""
    out = []
    for r, dev in enumerate(mesh):
        ii = torch.arange(planes, device=dev) + r * planes
        jk = torch.arange(m, device=dev)
        out.append((ii[:, None, None] + jk[None, :, None]
                    + jk[None, None, :]) & 1)
    return out


def neighbour_sum_slab(xs: list, mesh: Mesh) -> list:
    """Sum of the 6 periodic neighbours, x through a 1-plane halo."""
    return shardwise(
        lambda x, ext: (ext[:-2] + ext[2:]
                        + torch.roll(x, 1, 1) + torch.roll(x, -1, 1)
                        + torch.roll(x, 1, 2) + torch.roll(x, -1, 2)),
        xs, exchange_halo_x(xs, 1, mesh))


def operator_slab(xs: list, mesh: Mesh) -> list:
    """7-point Laplacian on the slabs (``laplacian.operator``)."""
    m = xs[0].shape[1]
    return shardwise(lambda x, s: (s - 6.0 * x) * float(m * m), xs,
                     neighbour_sum_slab(xs, mesh))


def residual_error_slab(xs: list, bs: list, mesh: Mesh) -> torch.Tensor:
    """||b - L x||_2 over the whole grid."""
    return _psum_norm(shardwise(lambda b, lx: b - lx, bs,
                                operator_slab(xs, mesh)), mesh)


def restriction_slab(xs: list) -> list:
    """Full-weighting restriction; the x pairs are slab-local."""
    return [mesh_ops.restriction(x) for x in xs]


def prolongation_slab(xs: list, mesh: Mesh) -> list:
    """Trilinear prolongation; the doubling of x reads a 1-plane halo."""
    out = []
    for x, ext in zip(xs, exchange_halo_x(xs, 1, mesh)):
        c = 0.75 * x
        even = c + 0.25 * ext[:-2]
        odd = c + 0.25 * ext[2:]
        y = torch.stack((even, odd), dim=1).flatten(0, 1)
        for axis in (1, 2):
            y = mesh_ops._prolong_axis(y, axis)
        out.append(y)
    return out


def gauss_seidel_slab(xs: list, bs: list, mesh: Mesh,
                      f_relax: float = F_RELAX, rhs=None) -> list:
    """One masked red-black over-relaxed sweep with the global parity, one
    halo exchange a colour: the reference of :func:`smoothing_slab`, which
    agrees with it bit for bit. With ``rhs`` it smooths the reformulated
    FAS equation x = (sum_nb - h^2 b)/6 + rhs."""
    planes, m = xs[0].shape[0], xs[0].shape[1]
    h2b = [_f32(1.0 / (m * m)) * b for b in bs]
    fr = _f32(f_relax)
    parity = _global_parity(planes, m, mesh)
    rhs = rhs if rhs is not None else [None] * len(xs)
    for colour in (1, 0):  # red (odd parity) first
        tgts = shardwise(lambda s, h, r: (s - h) * _INVSIX if r is None
                         else (s - h) * _INVSIX + r,
                         neighbour_sum_slab(xs, mesh), h2b, rhs)
        xs = shardwise(lambda x, t, p: torch.where(
            p == colour, x + fr * (t - x), x), xs, tgts, parity)
    return xs


# ---------------------------------------------------------------------------
# Packed red-black half-lattices on the slabs: laplacian.pack_rb's layout
# with s(i, k) = (i_global + k) & 1, and the x-neighbours (at the same
# packed (jp, k) index of the opposite colour) from a 1-plane halo
# ---------------------------------------------------------------------------

def _parity_ik_slab(planes: int, m: int, plane0: int, device):
    """s(i, k) = (plane0 + i + k) & 1 as a bool (planes, 1, m) mask."""
    ii = torch.arange(planes, device=device) + plane0
    kk = torch.arange(m, device=device)
    return ((ii[:, None, None] + kk[None, None, :]) & 1) == 1


def _pack(x: torch.Tensor, plane0: int):
    planes, m = x.shape[0], x.shape[1]
    x5 = x.reshape(planes, m // 2, 2, m)
    s1 = _parity_ik_slab(planes, m, plane0, x.device)
    even, odd = x5[:, :, 0, :], x5[:, :, 1, :]
    return torch.where(s1, even, odd), torch.where(s1, odd, even)


def _unpack(red: torch.Tensor, black: torch.Tensor, plane0: int):
    planes, m = red.shape[0], red.shape[2]
    s1 = _parity_ik_slab(planes, m, plane0, red.device)
    even = torch.where(s1, red, black)
    odd = torch.where(s1, black, red)
    return torch.stack((even, odd), dim=2).reshape(planes, m, m)


def pack_rb_slab(xs: list):
    """Every (planes, m, m) slab as (red, black) (planes, m/2, m)
    half-lattices, red the odd global parity: two lists."""
    planes = xs[0].shape[0]
    halves = [_pack(x, r * planes) for r, x in enumerate(xs)]
    return [h[0] for h in halves], [h[1] for h in halves]


def unpack_rb_slab(reds: list, blacks: list) -> list:
    """Inverse of :func:`pack_rb_slab`."""
    planes = reds[0].shape[0]
    return [_unpack(red, black, r * planes)
            for r, (red, black) in enumerate(zip(reds, blacks))]


def packed_neighbour_sum_slab(srcs: list, to_red: bool, mesh: Mesh) -> list:
    """Sum of the 6 stencil neighbours of each ``to_red`` (else black) cell,
    read from the opposite-colour half-lattices ``srcs``
    (``stencil.packed_neighbour_sum`` with the x-rolls replaced by a
    1-plane halo)."""
    planes, m = srcs[0].shape[0], srcs[0].shape[2]
    out = []
    for r, (src, ext) in enumerate(zip(srcs, exchange_halo_x(srcs, 1,
                                                               mesh))):
        s1 = _parity_ik_slab(planes, m, r * planes, src.device)
        down = torch.roll(src, 1, 1)
        up = torch.roll(src, -1, 1)
        if to_red:
            ym, yp = torch.where(s1, down, src), torch.where(s1, src, up)
        else:
            ym, yp = torch.where(s1, src, down), torch.where(s1, up, src)
        out.append(ext[:-2] + ext[2:] + ym + yp
                   + torch.roll(src, 1, 2) + torch.roll(src, -1, 2))
    return out


def _sweeps(xs: list, n_smoothing: int, mesh: Mesh, update,
            power: int = 1) -> list:
    """The sweep loop of every slab smoother: ``n_smoothing`` red-black
    sweeps, one pack/unpack round trip. ``update(dst, nsum, to_red, r)``
    is shard r's colour update from the packed neighbour sum of the
    opposite colour's ``power``-th power; between the two colours of a
    sweep every shard's updated colour crosses its halo."""
    reds, blacks = pack_rb_slab(xs)
    for _ in range(n_smoothing):
        for to_red in (True, False):
            src, dst = (blacks, reds) if to_red else (reds, blacks)
            nsum = packed_neighbour_sum_slab(
                [_power(x, power) for x in src], to_red, mesh)
            new = [update(d, s, to_red, r)
                   for r, (d, s) in enumerate(zip(dst, nsum))]
            if to_red:
                reds = new
            else:
                blacks = new
    return unpack_rb_slab(reds, blacks)


def smoothing_slab(xs: list, bs: list, n_smoothing: int, mesh: Mesh,
                   rhs=None, f_relax: float = F_RELAX) -> list:
    """``n_smoothing`` packed red-black sweeps, bit for bit the same as
    looping :func:`gauss_seidel_slab`."""
    m = xs[0].shape[1]
    fr = _f32(f_relax)
    h2b = pack_rb_slab([_f32(1.0 / (m * m)) * b for b in bs])
    rhs_p = pack_rb_slab(rhs) if rhs is not None else None

    def update(dst, nsum, to_red, r):
        c = 0 if to_red else 1
        tgt = (nsum - h2b[c][r]) * _INVSIX
        if rhs_p is not None:
            tgt = tgt + rhs_p[c][r]
        return dst + fr * (tgt - dst)

    return _sweeps(xs, n_smoothing, mesh, update)


def _gather_full(xs: list, mesh: Mesh) -> torch.Tensor:
    """The whole grid on shard 0's device."""
    return pmesh.all_gather(xs, mesh, 0)[0]


def _local_slice(x_full: torch.Tensor, mesh: Mesh) -> list:
    """Every shard's planes of a whole grid."""
    return pmesh.scatter(x_full, mesh, 0)


def _thin(xs: list) -> bool:
    """Whether a level's slabs are too thin to stay sharded."""
    return xs[0].shape[0] < 4 or xs[0].shape[1] <= REPLICATE_BELOW


def truncation_error_slab(xs: list, mesh: Mesh) -> torch.Tensor:
    """||R(L x) - L(R x)||_2 over the whole grid."""
    t = shardwise(lambda a, b: a - b,
                  restriction_slab(operator_slab(xs, mesh)),
                  operator_slab(restriction_slab(xs), mesh))
    return _psum_norm(t, mesh)


# per-leg recursion kinds: V is one leg; F recurses F then V (with an Npre
# smoothing between the legs); W recurses W twice: the legs of
# models/multigrid.py's cycles
_LEGS = {"V": ("V",), "F": ("F", "V"), "W": ("W", "W")}


def cycle_slab(xs: list, bs: list, ncoarse: int, Npre: int, Npost: int,
               mesh: Mesh, level: int = 0, kind: str = "V") -> list:
    """Linear V/F/W cycle on the slabs; thin coarse levels continue through
    ``models/multigrid`` on shard 0's device."""
    mg_cycles = {"V": mg.V_cycle, "F": mg.F_cycle, "W": mg.W_cycle}
    for sub in _LEGS[kind]:
        xs = smoothing_slab(xs, bs, Npre, mesh)
        res_c = restriction_slab(shardwise(lambda b, lx: b - lx, bs,
                                           operator_slab(xs, mesh)))
        if mg._coarsest(level, ncoarse):
            x_c = smoothing_slab([lap.initialise_potential(r) for r in res_c],
                                 res_c, Npre, mesh)
        elif _thin(res_c):
            res_full = _gather_full(res_c, mesh)
            x_c = _local_slice(mg_cycles[sub](
                lap.initialise_potential(res_full), res_full, ncoarse, Npre,
                Npost, level + 1), mesh)
        else:
            x_c = cycle_slab([lap.initialise_potential(r) for r in res_c],
                             res_c, ncoarse, Npre, Npost, mesh, level + 1,
                             sub)
        xs = shardwise(lambda x, p: x + p, xs, prolongation_slab(x_c, mesh))
    return smoothing_slab(xs, bs, Npost, mesh)


def V_cycle_slab(xs: list, bs: list, ncoarse: int, Npre: int, Npost: int,
                 mesh: Mesh, level: int = 0) -> list:
    return cycle_slab(xs, bs, ncoarse, Npre, Npost, mesh, level, "V")


def linear_slab(xs: list, bs: list, ncoarse: int, Npre: int, Npost: int,
                tolerance, mesh: Mesh, cycle: str = "V") -> list:
    """Sharded ``multigrid.linear``: V/F/W cycles until the residual norm
    over the whole grid beats the tolerance or stops improving, through
    ``multigrid._converge`` (its stop rule, cap and statistics)."""
    return mg._converge(
        xs, bs,
        lambda x, b: cycle_slab(x, b, ncoarse, Npre, Npost, mesh, 0, cycle),
        lambda x, b: residual_error_slab(x, b, mesh), tolerance)


# ---------------------------------------------------------------------------
# FAS (nonlinear) slab cycles: the f(R) scalaron
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SlabFASOps:
    """Slab counterpart of ``models.multigrid.FASOps``, with the replicated
    ops of the gathered coarse levels. Every function takes and returns
    per-shard lists (the errors: a 0-dim tensor on shard 0's device)."""

    smoothing: Callable  # (x, b, n, rhs) -> x
    operator: Callable  # (x, b) -> op(x, b)
    gauss_seidel_masked: Callable  # (x, b, rhs) -> x; the reference sweep
    restrict_residual: Callable  # (x, b, rhs) -> R(rhs - op) or -R(op)
    residual_error: Callable  # (x, b) -> ||op||
    truncation_error: Callable  # (x, b) -> ||4 R(op(x, b)) - op(Rx, Rb)||
    replicated: mg.FASOps


def _neighbour_pow_sum_slab(xs: list, mesh: Mesh, power: int) -> list:
    return neighbour_sum_slab([_power(x, power) for x in xs], mesh)


def _fas_ops_scalaron_slab(q, mesh: Mesh, n_power: int,
                           exact_root: bool) -> SlabFASOps:
    """f(R) scalaron ops on the slabs: u^(n_power+1) + p u + q h^2 with
    p = h^2 b - (1/6) sum_nb u^n_power (the cubic for n_power = 2, the
    quartic for 3)."""
    mod = cubic_mod if n_power == 2 else quartic_mod
    exact_solve = (mod.solution_cubic_equation if n_power == 2
                   else mod.solution_quartic_equation)
    exact_scale = 27.0 if n_power == 2 else 1.0
    fr = _f32(F_RELAX)

    def p_terms(xs, bs):
        h2 = _f32(1.0 / xs[0].shape[1] ** 2)
        return shardwise(lambda b, s: h2 * b - _INVSIX * s, bs,
                         _neighbour_pow_sum_slab(xs, mesh, n_power))

    def operator(xs, bs):
        m = xs[0].shape[1]
        qh2 = _f32(np.float32(q) * np.float32(1.0 / (m * m)))

        def one(x, p):
            if n_power == 2:
                return x * x * x + p * x + qh2
            x2 = x * x
            return x2 * x2 + p * x + qh2

        return shardwise(one, xs, p_terms(xs, bs))

    def coefficients(m, rhs):
        """The cell equation's constant term per shard: c0 = h^2 q [- rhs]
        in float32 for the Newton root, exact_scale (h^2 q [- rhs]) in
        float64 for the closed form."""
        h2 = 1.0 / (m * m)
        if exact_root:
            base = exact_scale * h2 * float(q)
            return (lambda r: base if rhs is None
                    else base - exact_scale * rhs[r].to(F64))
        c0_q = _f32(np.float32(h2) * np.float32(q))
        return lambda r: c0_q if rhs is None else c0_q - rhs[r]

    def new_values(x, p, coef):
        if exact_root:
            return exact_solve(p, coef).to(F32)
        return newton_root(x, p, coef, n_power)

    def gauss_seidel(xs, bs, rhs=None):
        planes, m = xs[0].shape[0], xs[0].shape[1]
        parity = _global_parity(planes, m, mesh)
        coef = coefficients(m, rhs)
        for colour in (1, 0):  # red (odd parity) first
            ps = p_terms(xs, bs)
            xs = [torch.where(parity[r] == colour,
                              x + fr * (new_values(x, p, coef(r)) - x), x)
                  for r, (x, p) in enumerate(zip(xs, ps))]
        return xs

    def smoothing(xs, bs, n, rhs=None):
        """n packed red-black sweeps, bit for bit looping
        ``gauss_seidel``."""
        m = xs[0].shape[1]
        hb = pack_rb_slab([_f32(1.0 / (m * m)) * b for b in bs])
        if rhs is None:
            coef = coefficients(m, None)
            coefs = ([coef(r) for r in range(len(xs))],) * 2
        else:
            coefs = tuple([coefficients(m, half)(r) for r in range(len(xs))]
                          for half in pack_rb_slab(rhs))

        def update(dst, nsum, to_red, r):
            c = 0 if to_red else 1
            p = hb[c][r] - _INVSIX * nsum
            return dst + fr * (new_values(dst, p, coefs[c][r]) - dst)

        return _sweeps(xs, n, mesh, update, n_power)

    def restrict_residual(xs, bs, rhs=None):
        ops = operator(xs, bs)
        if rhs is None:
            return [-r for r in restriction_slab(ops)]
        return restriction_slab(shardwise(lambda h, o: h - o, rhs, ops))

    def residual_error(xs, bs):
        return _psum_norm(operator(xs, bs), mesh)

    def truncation_error(xs, bs):
        RLx = restriction_slab(operator(xs, bs))
        LRx = operator(restriction_slab(xs), restriction_slab(bs))
        return _psum_norm(shardwise(lambda a, b: 4.0 * a - b, RLx, LRx), mesh)

    replicated = (mg.fas_ops_cubic(q, exact_root) if n_power == 2
                  else mg.fas_ops_quartic(q, exact_root))
    return SlabFASOps(
        smoothing=smoothing, operator=operator,
        gauss_seidel_masked=gauss_seidel,
        restrict_residual=restrict_residual, residual_error=residual_error,
        truncation_error=truncation_error, replicated=replicated)


def fas_ops_cubic_slab(q, mesh: Mesh, exact_root: bool = False) -> SlabFASOps:
    return _fas_ops_scalaron_slab(q, mesh, 2, exact_root)


def fas_ops_quartic_slab(q, mesh: Mesh,
                         exact_root: bool = False) -> SlabFASOps:
    return _fas_ops_scalaron_slab(q, mesh, 3, exact_root)


def cycle_FAS_slab(xs: list, bs: list, ops: SlabFASOps, ncoarse: int,
                   Npre: int, Npost: int, mesh: Mesh, level: int = 0,
                   rhs: Optional[list] = None, kind: str = "V") -> list:
    """FAS V/F/W cycle on the slabs (the tau-correction res_c = 4 res_c +
    op(R x, R b)); thin coarse levels continue through
    ``models/multigrid`` on shard 0's device. The legs of
    :func:`cycle_slab`."""
    mg_cycles = {"V": mg.V_cycle_FAS, "F": mg.F_cycle_FAS,
                 "W": mg.W_cycle_FAS}
    for sub in _LEGS[kind]:
        xs = ops.smoothing(xs, bs, Npre, rhs)
        res_c = ops.restrict_residual(xs, bs, rhs)
        x_c = restriction_slab(xs)
        b_c = restriction_slab(bs)
        res_c = shardwise(lambda r, o: 4.0 * r + o, res_c,
                          ops.operator(x_c, b_c))
        if mg._coarsest(level, ncoarse):
            x_corr_c = ops.smoothing(x_c, b_c, Npre, res_c)
        elif _thin(x_c):
            x_corr_c = _local_slice(mg_cycles[sub](
                _gather_full(x_c, mesh), _gather_full(b_c, mesh),
                ops.replicated, ncoarse, Npre, Npost, level + 1,
                _gather_full(res_c, mesh)), mesh)
        else:
            x_corr_c = cycle_FAS_slab(x_c, b_c, ops, ncoarse, Npre, Npost,
                                      mesh, level + 1, res_c, sub)
        xs = shardwise(lambda x, p: x + p, xs, prolongation_slab(
            shardwise(lambda a, b: a - b, x_corr_c, x_c), mesh))
    return ops.smoothing(xs, bs, Npost, rhs)


def V_cycle_FAS_slab(xs: list, bs: list, ops: SlabFASOps, ncoarse: int,
                     Npre: int, Npost: int, mesh: Mesh, level: int = 0,
                     rhs: Optional[list] = None) -> list:
    return cycle_FAS_slab(xs, bs, ops, ncoarse, Npre, Npost, mesh, level,
                          rhs, "V")


def FAS_slab(xs: list, bs: list, ops: SlabFASOps, ncoarse: int, Npre: int,
             Npost: int, tolerance, mesh: Mesh, cycle: str = "V") -> list:
    """Sharded ``multigrid.FAS`` of ops.operator(x, b) = 0, through
    ``multigrid._converge``."""
    return mg._converge(
        xs, bs,
        lambda x, b: cycle_FAS_slab(x, b, ops, ncoarse, Npre, Npost, mesh,
                                    kind=cycle),
        ops.residual_error, tolerance, fas=True)
