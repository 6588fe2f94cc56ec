"""The f(R) Hu-Sawicki n = 1 scalaron equation, solved by Full
Approximation Scheme V-cycles (PySCo, Breton 2025, section 2.3).

On a grid of n cells a side (h = 1/n) the reduced scalaron u obeys, per
cell, u^3 + p u + q h^2 = rhs with p = h^2 b - (sum of the 6 neighbours'
u^2) / 6, b = f1 rho + f2 and rhs = 0 on the finest grid. A smoothing
sweep takes each colour of a red-black lattice in turn and moves every
cell of it towards the real root of its cubic (Cardano's formula,
over-relaxed by 1.25). The coarse grid problem of a V-cycle is the
full-weighting restriction of the grid's u and b, its right-hand side 4
R(rhs - op) + op(R u, R b), and the trilinear prolongation brings back
its change. The solve runs until the residual falls a thousand times
below the program's stopping point (epsrel times the truncation error
of the starting u) or stops falling by a tenth a cycle.
"""

from __future__ import annotations

import math

import torch

from .precision import Precision

RELAX = 1.25
MAX_CYCLES = 40


def _neighbours(x):
    return (torch.roll(x, 1, 0) + torch.roll(x, -1, 0) + torch.roll(x, 1, 1)
            + torch.roll(x, -1, 1) + torch.roll(x, 1, 2)
            + torch.roll(x, -1, 2))


def _parity(n, device):
    i = torch.arange(n, device=device)
    return (i[:, None, None] + i[None, :, None] + i[None, None, :]) % 2


def operator(x, b, q, prec: Precision):
    n = x.shape[0]
    h2 = 1.0 / (n * n)
    p = h2 * b - _neighbours(x * x) / 6.0
    return prec.q(x * x * x + p * x + q * h2)


def cubic_root(p, c):
    """The real root of u^3 + p u + c = 0 that PySCo takes: the single
    one where the discriminant is positive, else the trigonometric root at
    (theta + 2 pi)/3. Computed in float64."""
    p = p.double()
    d1 = 27.0 * c if torch.is_tensor(c) else torch.full_like(p, 27.0 * c)
    d1 = d1.double()
    d = d1 * d1 + 108.0 * p ** 3
    dd = d1 + torch.sqrt(torch.where(d > 0, d, 1.0))
    safe = torch.where(dd == 0, 1.0, dd)
    C = torch.sign(0.5 * safe) * torch.abs(0.5 * safe) ** (1.0 / 3.0)
    cbrt_d1 = torch.sign(d1) * torch.abs(d1) ** (1.0 / 3.0)
    pos = torch.where(dd == 0, -cbrt_d1 / 3.0, -(C - 3.0 * p / C) / 3.0)
    d0 = torch.where(d < 0, -3.0 * p, 1.0)
    theta = torch.arccos(torch.clamp(d1 / (2.0 * d0 ** 1.5), -1.0, 1.0))
    neg = -2.0 / 3.0 * torch.sqrt(d0) * torch.cos((theta + 2.0 * math.pi)
                                                  / 3.0)
    return torch.where(d > 0, pos, torch.where(d < 0, neg, -cbrt_d1 / 3.0))


def first_guess(b, q, prec: Precision):
    """The root with every neighbour at zero: u^3 + h^2 b u + h^2 q = 0,
    the positive branch (the b = 0 root where that has none)."""
    n = b.shape[0]
    h2 = 1.0 / (n * n)
    d1 = 27.0 * h2 * q
    d0 = -3.0 * h2 * b.double()
    C = 0.5 * (d1 - torch.sqrt(d1 * d1 - 4.0 * d0 ** 3))
    C = torch.sign(C) * torch.abs(C) ** (1.0 / 3.0)
    u = -(C + d0 / C) / 3.0
    v = -h2 * q
    fallback = math.copysign(abs(v) ** (1.0 / 3.0), v)
    u = torch.where(torch.isfinite(u) & (u > 0), u, fallback)
    return prec.q(u.to(prec.real))


def smooth(x, b, q, rhs, sweeps: int, prec: Precision):
    n = x.shape[0]
    h2 = 1.0 / (n * n)
    parity = _parity(n, x.device)
    c = q * h2 if rhs is None else q * h2 - rhs
    for _ in range(sweeps):
        for colour in (1, 0):
            p = h2 * b - _neighbours(x * x) / 6.0
            root = cubic_root(p, c).to(prec.real)
            x = prec.q(torch.where(parity == colour,
                                   x + RELAX * (root - x), x))
    return x


def restrict(x):
    n = x.shape[0] // 2
    return x.reshape(n, 2, n, 2, n, 2).mean(dim=(1, 3, 5))


def prolong(x):
    """Trilinear: fine 2r = 3/4 x[r] + 1/4 x[r-1], fine 2r+1 = 3/4 x[r] +
    1/4 x[r+1], along each axis in turn."""
    for ax in range(3):
        even = 0.75 * x + 0.25 * torch.roll(x, 1, ax)
        odd = 0.75 * x + 0.25 * torch.roll(x, -1, ax)
        x = torch.stack((even, odd), dim=ax + 1).flatten(ax, ax + 1)
    return x


def v_cycle(x, b, q, rhs, depth: int, npre: int, npost: int,
            prec: Precision):
    x = smooth(x, b, q, rhs, npre, prec)
    res = -operator(x, b, q, prec) if rhs is None else rhs - operator(
        x, b, q, prec)
    xc, bc = prec.q(restrict(x)), prec.q(restrict(b))
    rhs_c = prec.q(4.0 * restrict(res) + operator(xc, bc, q, prec))
    if depth <= 1:
        corr = smooth(xc, bc, q, rhs_c, npre, prec)
    else:
        corr = v_cycle(xc, bc, q, rhs_c, depth - 1, npre, npost, prec)
    x = prec.q(x + prolong(corr - xc))
    return smooth(x, b, q, rhs, npost, prec)


def residual(x, b, q, prec: Precision) -> float:
    return float(torch.linalg.vector_norm(operator(x, b, q, prec).double()))


def truncation_error(x, b, q, prec: Precision) -> float:
    xc, bc = restrict(x), restrict(b)
    t = 4.0 * restrict(operator(x, b, q, prec)) - operator(xc, bc, q, prec)
    return float(torch.linalg.vector_norm(t.double()))


def solve(b, q: float, x, ncoarse: int, npre: int, npost: int,
          epsrel: float, prec: Precision):
    """The scalaron from the first guess ``x`` (None: :func:`first_guess`)."""
    b = prec.t(b)
    x = first_guess(b, q, prec) if x is None else prec.t(x)
    tol = 1e-3 * epsrel * truncation_error(x, b, q, prec)
    prev = math.inf
    for _ in range(MAX_CYCLES):
        x = v_cycle(x, b, q, None, ncoarse - 2, npre, npost, prec)
        err = residual(x, b, q, prec)
        if err <= tol or err > 0.9 * prev:
            break
        prev = err
    return x
