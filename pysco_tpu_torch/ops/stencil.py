"""Multigrid stencil kernels: the red-black half-sweep (linear and f(R)
scalaron, the latter with a float32 Newton root or the float64 closed-form
cubic or quartic root), the residual norm, the fused restriction and the
prolongation (the PyTorch/CUDA counterpart of
``pysco_tpu/ops/pallas_stencil.py``; the closed-form sweeps have no Pallas
kernel: the JAX package takes those roots in plain jnp).

Each kernel is hand-written CUDA (``csrc/half_sweep.cu``,
``csrc/scalaron_sweep.cu``, ``csrc/residual.cu``,
``csrc/prolongation.cu``) with a plain PyTorch
twin beside it of the same signature (``*_plain``). A wrapper takes the
twin for a CPU tensor and launches the kernel for a CUDA tensor, at every
grid size (the multigrid levels go down to 4^3); there is no fallback
from one to the other. ``LAUNCHES`` counts kernel launches, those of
the QUMOND source kernel (``csrc/mond_source.cu``, wrapped by
``models/mond.rhs``; its C signature is registered here) among them.

The stencil primitives the twins are written in -- the full-lattice
``neighbour_sum`` and the packed red-black ``packed_neighbour_sum`` --
live here too; ``models/laplacian.py`` uses them under the JAX package's
names. Every expression keeps the JAX package's operand order and its
float32 constants (``np.float32(1/6)``, ``np.float32(1/(n*n))``).
"""

from __future__ import annotations

import ctypes
import math
from functools import lru_cache

import numpy as np
import torch

from ..utils import profiling
from .mesh import prolongation, restriction

F32 = torch.float32
F64 = torch.float64

# kernel launches by the CUDA wrappers (one per wrapper call); the CPU
# twins do not count
LAUNCHES = {"half_sweep": 0, "scalaron_half_sweep": 0, "newton_root": 0,
            "scalaron_exact_half_sweep": 0,
            "scalaron_quartic_exact_half_sweep": 0, "residual_norm2": 0,
            "restrict3": 0, "add_prolongation": 0, "mond_source": 0}

#: residual kind -> (kernel enum, neighbour power, needs b); the kinds of
#: pysco_tpu/ops/pallas_stencil.py _KINDS
_KINDS = {
    "linear": (0, 1, True),        # b - L(x)                (laplacian.residual)
    "laplacian": (1, 1, False),    # L(x)                    (truncation_error)
    "reformulated": (2, 1, True),  # x + (h^2 b - S)/6       (operator_reformulated)
    "cubic": (3, 2, True),         # x^3 + p x + q h^2       (f(R) n = 1)
    "quartic": (4, 3, True),       # x^4 + p x + q h^2       (f(R) n = 2)
}

_INVSIX = float(np.float32(1.0 / 6.0))
_NEWTON_EPS = float(np.float32(1e-12))
#: the Newton steps of the safe root, at most
SAFE_ROOT_STEPS = 64
#: the device counter of the Newton sweep: cells its guard took
NEWTON_COUNTERS = ("newton_root_guarded",)
_MAX_N = 1024  # the kernels index with 32-bit ints: n^3 < 2^31


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _f32(x) -> float:
    return float(np.float32(x))


def _h2(n: int) -> float:
    return _f32(1.0 / (n * n))


# ---------------------------------------------------------------------------
# Stencil primitives (pysco_tpu/models/laplacian.py)
# ---------------------------------------------------------------------------

def neighbour_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of the 6 periodic neighbours, in the order x-, x+, y-, y+, z-,
    z+."""
    return (torch.roll(x, 1, 0) + torch.roll(x, -1, 0)
            + torch.roll(x, 1, 1) + torch.roll(x, -1, 1)
            + torch.roll(x, 1, 2) + torch.roll(x, -1, 2))


def _parity_ik(n: int, device) -> torch.Tensor:
    """s(i,k) = (i+k) & 1 as a bool (n, 1, n) mask (True where s == 1)."""
    i = torch.arange(n, device=device)
    return (((i[:, None, None] + i[None, None, :]) & 1) == 1)


def packed_neighbour_sum(src: torch.Tensor, to_red: bool) -> torch.Tensor:
    """Sum of the 6 stencil neighbours of each ``to_red`` (else black) cell,
    read from the opposite-colour half-lattice ``src``: x and z neighbours
    at the same packed index, the two y neighbours ``src`` itself and one
    y-roll, which one is y- depending on s(i,k). Same order as
    :func:`neighbour_sum`."""
    s1 = _parity_ik(src.shape[0], src.device)
    down = torch.roll(src, 1, 1)
    up = torch.roll(src, -1, 1)
    if to_red:
        ym = torch.where(s1, down, src)
        yp = torch.where(s1, src, up)
    else:
        ym = torch.where(s1, src, down)
        yp = torch.where(s1, up, src)
    return (torch.roll(src, 1, 0) + torch.roll(src, -1, 0) + ym + yp
            + torch.roll(src, 1, 2) + torch.roll(src, -1, 2))


def _power(x: torch.Tensor, power: int) -> torch.Tensor:
    if power == 2:
        return x * x
    if power == 3:
        return x * x * x
    return x


def _cbrt(v: torch.Tensor) -> torch.Tensor:
    """Real cube root of a float64 tensor, negative values included (torch
    has no ``cbrt``)."""
    return torch.sign(v) * torch.abs(v) ** (1.0 / 3.0)


def _f64(v, like: torch.Tensor) -> torch.Tensor:
    """A float or tensor as float64 on ``like``'s device, broadcast to its
    shape."""
    return torch.as_tensor(v, dtype=F64, device=like.device).expand(
        like.shape)


def solution_cubic_equation(p: torch.Tensor, d1) -> torch.Tensor:
    """Real root of u^3 + p u + d1/27 = 0 (float64, branchless; the JAX
    package's ``cubic.solution_cubic_equation``)."""
    p = p.to(F64)
    d1 = _f64(d1, p)
    inv3 = 1.0 / 3.0
    d = d1 * d1 + 108.0 * (p * p * p)

    # d > 0: the single real root, by Cardano
    d_pos = torch.where(d > 0.0, d, 1.0)
    dd = d1 + torch.sqrt(d_pos)
    dd_safe = torch.where(dd == 0.0, 1.0, dd)
    C = _cbrt(0.5 * dd_safe)
    root_pos = torch.where(dd == 0.0, -inv3 * _cbrt(d1),
                           -inv3 * (C - 3.0 * p / C))

    # d < 0: three real roots, the trigonometric one at (theta + 2 pi)/3
    d0 = torch.where(d < 0.0, -3.0 * p, 1.0)
    dn = d1 / (2.0 * d0 ** 1.5)
    theta = torch.arccos(torch.clamp(dn, -1.0, 1.0))
    root_neg = -2.0 * inv3 * torch.sqrt(d0) * torch.cos(
        inv3 * (theta + 2.0 * math.pi))

    root_zero = -inv3 * _cbrt(d1)
    return torch.where(d > 0.0, root_pos,
                       torch.where(d < 0.0, root_neg, root_zero))


def solution_quartic_equation(p: torch.Tensor, q) -> torch.Tensor:
    """Real positive root of u^4 + p u + q = 0 (float64, branchless; the
    JAX package's ``quartic.solution_quartic_equation``)."""
    pp = p.to(F64)
    qq = _f64(q, pp)

    fallback = torch.abs(qq) ** 0.25  # (-q)^(1/4) for q < 0

    d0 = 12.0 * qq
    d1_safe = torch.where(pp == 0.0, 1.0, 27.0 * pp * pp)
    ratio = d0 / d1_safe
    sqrt_term = 1.0 - 4.0 * d0 * (ratio * ratio)
    sqrt_term_safe = torch.where(sqrt_term < 0.0, 0.0, sqrt_term)
    Q = _cbrt(0.5 * d1_safe * (1.0 + torch.sqrt(sqrt_term_safe)))
    Q_safe = torch.where(Q == 0.0, 1.0, Q)
    Q_d0oQ = Q_safe + d0 / Q_safe
    S = 0.5 * torch.sqrt(torch.where(Q_d0oQ > 0.0, Q_d0oQ, 1.0) / 3.0)
    S_safe = torch.where(S == 0.0, 1.0, S)
    disc_pos = -4.0 * S * S + pp / S_safe
    disc_neg = -4.0 * S * S - pp / S_safe
    root_p_pos = -S + 0.5 * torch.sqrt(torch.clamp(disc_pos, min=0.0))
    root_p_neg = S + 0.5 * torch.sqrt(torch.clamp(disc_neg, min=0.0))
    root = torch.where(pp > 0.0, root_p_pos, root_p_neg)
    root = torch.where(Q_d0oQ > 0.0, root, fallback)
    root = torch.where(sqrt_term < 0.0, fallback, root)
    return torch.where(pp == 0.0, fallback, root)


def residual_plain(kind: str, x, b=None, rhs=None, q=None) -> torch.Tensor:
    """The per-cell residual of ``kind`` (``pallas_stencil._residual_block``
    on the full lattice); with ``rhs`` it is rhs - op."""
    _, power, _ = _KINDS[kind]
    n = x.shape[0]
    S = neighbour_sum(_power(x, power))
    h2 = _h2(n)
    if kind == "linear":
        r = b - (S - 6.0 * x) * float(n * n)
    elif kind == "laplacian":
        r = (S - 6.0 * x) * float(n * n)
    elif kind == "reformulated":
        r = x + _INVSIX * (h2 * b - S)
    else:
        p = h2 * b - _INVSIX * S
        qh2 = _f32(np.float32(q) * np.float32(h2))
        if kind == "cubic":
            r = x * x * x + p * x + qh2
        else:
            x2 = x * x
            r = x2 * x2 + p * x + qh2
    return r if rhs is None else rhs - r


# ---------------------------------------------------------------------------
# Plain twins of the kernels
# ---------------------------------------------------------------------------

def half_sweep_plain(src, dst, h2b, to_red: bool, f_relax: float,
                     rhs=None) -> torch.Tensor:
    """Twin of :func:`half_sweep`."""
    tgt = (packed_neighbour_sum(src, to_red) - h2b) * _INVSIX
    if rhs is not None:
        tgt = tgt + rhs
    return dst + _f32(f_relax) * (tgt - dst)


def _bracket_top(p, c0, n_power: int) -> torch.Tensor:
    """An upper bound of every positive root of u^(n_power+1) + p u + c0 =
    0, in p's precision, from square roots alone (so the kernel computes
    the same bits): with A = max(-p, 0) and C = |c0| a positive root r has
    r^(n_power+1) <= A r + C, so r <= A^(1/2) + C^(1/3) for the cubic and
    r <= A^(1/3) + C^(1/4) for the quartic; a cube root is bounded by the
    square root above 1 and by the fourth root below."""
    a = torch.where(-p > 0.0, -p, 0.0)
    c = torch.abs(torch.as_tensor(c0, dtype=p.dtype, device=p.device))
    if n_power == 2:
        return torch.sqrt(a) + torch.where(c <= 1.0, torch.sqrt(torch.sqrt(c)),
                                           torch.sqrt(c))
    return (torch.where(a <= 1.0, torch.sqrt(torch.sqrt(a)), torch.sqrt(a))
            + torch.sqrt(torch.sqrt(c)))


def _newton_step(x, p, c0, n_power: int):
    """f / f' of u^(n_power+1) + p u + c0 at x, f' held at 1e-12 or above
    in magnitude; also f', unheld."""
    if n_power == 2:
        f = x * (x * x + p) + c0
        fp = 3.0 * x * x + p
    else:
        x2 = x * x
        f = x2 * x2 + p * x + c0
        fp = 4.0 * x2 * x + p
    return f / torch.where(torch.abs(fp) < _NEWTON_EPS, _NEWTON_EPS, fp), fp


def safe_root(p, c0, n_power: int) -> torch.Tensor:
    """The root a guarded cell takes, float32, from p and c0 (a float or a
    tensor of p's shape): Newton steps from :func:`_bracket_top`, which
    lies above every positive root, while a step lowers u (at most
    ``SAFE_ROOT_STEPS``). The polynomial is convex for u > 0, so the steps
    fall monotonically onto its largest positive root: for c0 < 0 the only
    one, and PySCo's. Where c0 >= 0 (a coarse FAS level's rhs above h^2
    q) and no positive root exists, they stop where u no longer falls."""
    c = c0 if isinstance(c0, torch.Tensor) else torch.as_tensor(
        float(c0), dtype=p.dtype, device=p.device).expand(p.shape)
    x = _bracket_top(p, c, n_power)
    live = torch.ones(p.shape, dtype=torch.bool, device=p.device)
    for _ in range(SAFE_ROOT_STEPS):
        new = x - _newton_step(x, p, c, n_power)[0]
        live = live & (new < x)
        if not bool(live.any()):
            break
        x = torch.where(live, new, x)
    return x


def newton_root_plain(x, p, c0, n_power: int, iters: int = 3):
    """Twin of :func:`newton_root`, and the root the sweep's twin takes:
    the root of u^(n_power+1) + p u + c0 = 0 by float32 Newton steps from
    the seed x (the JAX package's ``cubic._newton_root`` for n_power = 2,
    ``quartic._newton_root`` for 3, in their operand order), guarded. A
    cell whose steps leave the root's bracket [0, top], top = max(2 x,
    :func:`_bracket_top`), takes :func:`safe_root` instead: where the
    first step meets f' at or below 1e-12 (NaN included), or the first or
    the last iterate is negative, not finite or above top. Elsewhere the
    result is the steps' bit for bit. Returns (root, guarded), ``guarded``
    the cells that took the safe root (the kernels count them, and return
    the root alone). The guarded cells are gathered, a host read on a
    card, where the kernels run instead.

    For c0 < 0 the polynomial is negative at 0 and convex for u > 0, so a
    step from a seed above the positive root falls monotonically onto it,
    and one from below lands above it; the first step decides, and the
    last iterate is tested for the other cases (c0 >= 0 on the coarse
    levels of FAS, a seed <= 0). Deep screening (the root near 0, the seed
    left over from a larger u) gives seeds below the root with f' near 0
    or below: a step from there flies far above the root, where three
    steps cannot bring it back, or below 0, and the FAS V-cycle diverges
    from such cells. 2 x in the top lets a converging cell's first step
    overshoot the root as Newton does, where ``_bracket_top`` is tight (the
    quartic's at p >= 0)."""
    seed = first = x
    guarded = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    for k in range(iters):
        step, fp = _newton_step(x, p, c0, n_power)
        x = x - step
        if k == 0:
            guarded = ~(fp > _NEWTON_EPS)
            first = x
    if iters:
        top = _bracket_top(p, c0, n_power)
        top = torch.where(2.0 * seed > top, 2.0 * seed, top)
        guarded |= (~(torch.minimum(first, x) >= 0.0)
                    | (torch.maximum(first, x) > top))
    cells = guarded.nonzero(as_tuple=True)
    if cells[0].numel():
        c = (c0[cells] if isinstance(c0, torch.Tensor) and c0.dim()
             else float(c0))
        x = x.index_put(cells, safe_root(p[cells], c, n_power))
    return x, guarded


def scalaron_half_sweep_plain(src, dst, hb, coef, to_red: bool,
                              f_relax: float, n_power: int,
                              newton_iters: int = 3, counts=None):
    """Twin of :func:`scalaron_half_sweep`; adds the cells the guard took
    to ``counts[0]`` where given."""
    p = hb - _INVSIX * packed_neighbour_sum(_power(src, n_power), to_red)
    x, guarded = newton_root_plain(dst, p, coef, n_power, newton_iters)
    if counts is not None:
        counts[0] += guarded.sum()
    return dst + _f32(f_relax) * (x - dst)


def scalaron_exact_half_sweep_plain(src, dst, hb, d1_q: float,
                                    to_red: bool, f_relax: float,
                                    rhs=None) -> torch.Tensor:
    """Twin of :func:`scalaron_exact_half_sweep`."""
    coef = d1_q if rhs is None else d1_q - 27.0 * rhs.double()
    p = hb - _INVSIX * packed_neighbour_sum(_power(src, 2), to_red)
    x_new = solution_cubic_equation(p, coef).to(F32)
    return dst + _f32(f_relax) * (x_new - dst)


def scalaron_quartic_exact_half_sweep_plain(src, dst, hb, c_q: float,
                                            to_red: bool, f_relax: float,
                                            rhs=None) -> torch.Tensor:
    """Twin of :func:`scalaron_quartic_exact_half_sweep`."""
    coef = c_q if rhs is None else c_q - rhs.double()
    p = hb - _INVSIX * packed_neighbour_sum(_power(src, 3), to_red)
    x_new = solution_quartic_equation(p, coef).to(F32)
    return dst + _f32(f_relax) * (x_new - dst)


def residual_norm2_plain(kind: str, x, b=None, rhs=None,
                         q=None) -> torch.Tensor:
    """Twin of :func:`residual_norm2`."""
    r = residual_plain(kind, x, b, rhs, q)
    return torch.sum(r * r)


def restrict3_plain(kind: str, x, b=None, rhs=None, q=None,
                    residual_only: bool = False):
    """Twin of :func:`restrict3`."""
    out = (restriction(residual_plain(kind, x, b, rhs, q)),)
    if residual_only:
        return out
    out += (restriction(x),)
    if _KINDS[kind][2]:
        out += (restriction(b),)
    return out


def add_prolongation_plain(y, x_c) -> torch.Tensor:
    """Twin of :func:`add_prolongation`."""
    return y + prolongation(x_c)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _kernels():
    """The compiled kernel library with the stencil kernels' C signatures
    (built at first use from ``csrc/``)."""
    from . import cuda_build

    lib = cuda_build.load()
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.pysco_half_sweep.argtypes = [P, P, P, P, P, I, I, F, P]
    lib.pysco_scalaron_half_sweep.argtypes = [P, P, P, P, F, P, I, I, F, I,
                                              I, P, P]
    lib.pysco_newton_root.argtypes = [P, P, P, F, P, ctypes.c_longlong, I,
                                      I, P]
    lib.pysco_scalaron_exact_half_sweep.argtypes = [P, P, P, P,
                                                    ctypes.c_double, P, I,
                                                    I, F, P]
    lib.pysco_scalaron_quartic_exact_half_sweep.argtypes = [
        P, P, P, P, ctypes.c_double, P, I, I, F, P]
    lib.pysco_norm2_blocks.argtypes = [I]
    lib.pysco_residual_norm2.argtypes = [I, P, P, P, I, F, F, F, P, P, P]
    lib.pysco_norm2_variant_blocks.argtypes = [I, I]
    lib.pysco_residual_norm2_variant.argtypes = [I, I, I, P, P, P, I, F, F, F,
                                                 P, P, P]
    lib.pysco_restrict3.argtypes = [I, P, P, P, I, F, F, F, P, P, P, P]
    lib.pysco_add_prolongation.argtypes = [P, P, P, I, P]
    lib.pysco_mond_source.argtypes = [P, P, I, I, I, F, F, F, I,
                                      ctypes.c_double, P]
    for fn in (lib.pysco_half_sweep, lib.pysco_scalaron_half_sweep,
               lib.pysco_newton_root,
               lib.pysco_scalaron_exact_half_sweep,
               lib.pysco_scalaron_quartic_exact_half_sweep,
               lib.pysco_norm2_blocks,
               lib.pysco_residual_norm2, lib.pysco_norm2_variant_blocks,
               lib.pysco_residual_norm2_variant, lib.pysco_restrict3,
               lib.pysco_add_prolongation, lib.pysco_mond_source):
        fn.restype = I
    return lib


def _on_cuda(name: str, *tensors) -> bool:
    """False for CPU tensors (the twin runs), True for CUDA tensors (the
    kernel runs); raises for any other device or a mix."""
    devs = {t.device.type for t in tensors if t is not None}
    if devs == {"cpu"}:
        return False
    if devs == {"cuda"}:
        return True
    raise ValueError(f"{name}: no kernel for devices {sorted(devs)}")


def _check(name: str, t, shape) -> None:
    if t is None:
        return
    if t.dtype != F32 or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous CUDA float32 "
                         f"tensor, got {t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")


def _check_n(name: str, n: int) -> None:
    if n % 2 or not 2 <= n <= _MAX_N:
        raise ValueError(f"{name}: grid size {n} must be even and at most "
                         f"{_MAX_N}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _raise_on(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} kernel failed: CUDA error {err}")


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def half_sweep(src, dst, h2b, to_red: bool, f_relax: float, rhs=None):
    """One colour half of a packed red-black Gauss-Seidel sweep on
    (n, n/2, n) half-lattices: dst + f_relax ((sum_nb(src) - h2b)/6
    [+ rhs] - dst), the ``to_red`` colour (else black) updated from the
    other colour ``src``."""
    if not _on_cuda("half_sweep", src, dst, h2b, rhs):
        return half_sweep_plain(src, dst, h2b, to_red, f_relax, rhs)
    n = src.shape[0]
    _check_n("half_sweep", n)
    shape = (n, n // 2, n)
    for name, t in (("src", src), ("dst", dst), ("h2b", h2b), ("rhs", rhs)):
        _check(f"half_sweep {name}", t, shape)
    out = torch.empty_like(dst)
    err = _kernels().pysco_half_sweep(
        src.data_ptr(), dst.data_ptr(), h2b.data_ptr(), _ptr(rhs),
        out.data_ptr(), n, int(bool(to_red)), _f32(f_relax), _stream(out))
    _raise_on(err, "half_sweep")
    LAUNCHES["half_sweep"] += 1
    return out


def _check_sweep(name: str, n: int, **tensors) -> None:
    """The scalaron sweeps' operands: n a multiple of 4 (the kernels move
    float4s), each tensor (n, n/2, n) and 16-byte aligned."""
    _check_n(name, n)
    if n % 4:
        raise ValueError(f"{name}: grid size {n} must be a multiple of 4 "
                         "(the kernel moves float4s)")
    for tname, t in tensors.items():
        _check(f"{name} {tname}", t, (n, n // 2, n))
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name} {tname}: the kernel needs a 16-byte "
                             "aligned tensor")


def scalaron_half_sweep(src, dst, hb, coef, to_red: bool, f_relax: float,
                        n_power: int, newton_iters: int = 3):
    """One colour half of the packed nonlinear f(R) scalaron sweep on
    (n, n/2, n) half-lattices: p = hb - sum_nb(src^n_power)/6, then
    ``newton_iters`` Newton steps from dst on u^(n_power+1) + p u + c0 = 0
    and dst + f_relax (root - dst). ``coef`` is c0: a float (h^2 q) or an
    (n, n/2, n) plane (h^2 q - rhs)."""
    plane = isinstance(coef, torch.Tensor) and coef.dim() == 3
    if not _on_cuda("scalaron_half_sweep", src, dst, hb,
                    coef if plane else None):
        return scalaron_half_sweep_plain(src, dst, hb, coef, to_red, f_relax,
                                         n_power, newton_iters)
    if n_power not in (2, 3):
        raise ValueError(f"scalaron_half_sweep: n_power={n_power}, should "
                         "be 2 (f(R) n = 1) or 3 (n = 2)")
    n = src.shape[0]
    _check_sweep("scalaron_half_sweep", n, src=src, dst=dst, hb=hb,
                 coef=coef if plane else None)
    counts = profiling.device_counters(NEWTON_COUNTERS, dst.device)
    out = torch.empty_like(dst)
    err = _kernels().pysco_scalaron_half_sweep(
        src.data_ptr(), dst.data_ptr(), hb.data_ptr(),
        coef.data_ptr() if plane else None,
        0.0 if plane else _f32(float(coef)), out.data_ptr(), n,
        int(bool(to_red)), _f32(f_relax), int(n_power), int(newton_iters),
        _ptr(counts), _stream(out))
    _raise_on(err, "scalaron_half_sweep")
    LAUNCHES["scalaron_half_sweep"] += 1
    return out


def newton_root(x, p, c0, n_power: int, iters: int = 3) -> torch.Tensor:
    """The guarded root of u^(n_power+1) + p u + c0 = 0 a cell (the root
    the scalaron sweep takes, :func:`newton_root_plain`) from the seed x,
    for p and c0 formed elsewhere (the slab FAS, the masked Gauss-Seidel
    oracles): ``iters`` float32 Newton steps, or the safe root where they
    leave the root's bracket. ``c0`` is a float or a tensor of x's shape.
    One launch, whatever the cells."""
    plane = isinstance(c0, torch.Tensor) and c0.dim() > 0
    if not _on_cuda("newton_root", x, p, c0 if plane else None):
        return newton_root_plain(x, p, c0, n_power, iters)[0]
    if n_power not in (2, 3):
        raise ValueError(f"newton_root: n_power={n_power}, should be 2 "
                         "(f(R) n = 1) or 3 (n = 2)")
    x, p = x.contiguous(), p.contiguous()
    _check("newton_root x", x, x.shape)
    _check("newton_root p", p, x.shape)
    coef = c0.contiguous() if plane else None
    _check("newton_root c0", coef, x.shape)
    out = torch.empty_like(x)
    err = _kernels().pysco_newton_root(
        x.data_ptr(), p.data_ptr(), _ptr(coef),
        0.0 if plane else _f32(float(c0)), out.data_ptr(), x.numel(),
        int(n_power), int(iters), _stream(out))
    _raise_on(err, "newton_root")
    LAUNCHES["newton_root"] += 1
    return out


def scalaron_exact_half_sweep(src, dst, hb, d1_q: float, to_red: bool,
                              f_relax: float, rhs=None) -> torch.Tensor:
    """One colour half of the packed f(R) n = 1 scalaron sweep with the
    float64 closed-form root, on (n, n/2, n) half-lattices: p = hb -
    sum_nb(src^2)/6 in float32, the real root of u^3 + p u + d1/27 = 0
    (:func:`solution_cubic_equation`) with d1 = d1_q (27 h^2 q, a float)
    or d1_q - 27 rhs (``rhs`` an (n, n/2, n) float32 plane), cast to
    float32, and dst + f_relax (root - dst)."""
    if not _on_cuda("scalaron_exact_half_sweep", src, dst, hb, rhs):
        return scalaron_exact_half_sweep_plain(src, dst, hb, d1_q, to_red,
                                               f_relax, rhs)
    n = src.shape[0]
    _check_sweep("scalaron_exact_half_sweep", n, src=src, dst=dst, hb=hb,
                 rhs=rhs)
    out = torch.empty_like(dst)
    err = _kernels().pysco_scalaron_exact_half_sweep(
        src.data_ptr(), dst.data_ptr(), hb.data_ptr(), _ptr(rhs),
        float(d1_q), out.data_ptr(), n, int(bool(to_red)), _f32(f_relax),
        _stream(out))
    _raise_on(err, "scalaron_exact_half_sweep")
    LAUNCHES["scalaron_exact_half_sweep"] += 1
    return out


def scalaron_quartic_exact_half_sweep(src, dst, hb, c_q: float,
                                      to_red: bool, f_relax: float,
                                      rhs=None) -> torch.Tensor:
    """One colour half of the packed f(R) n = 2 scalaron sweep with the
    float64 closed-form root, on (n, n/2, n) half-lattices: p = hb -
    sum_nb(src^3)/6 in float32, the real root of u^4 + p u + c = 0
    (:func:`solution_quartic_equation`) with c = c_q (h^2 q, a float) or
    c_q - rhs (``rhs`` an (n, n/2, n) float32 plane), cast to float32, and
    dst + f_relax (root - dst)."""
    if not _on_cuda("scalaron_quartic_exact_half_sweep", src, dst, hb, rhs):
        return scalaron_quartic_exact_half_sweep_plain(src, dst, hb, c_q,
                                                       to_red, f_relax, rhs)
    n = src.shape[0]
    _check_sweep("scalaron_quartic_exact_half_sweep", n, src=src, dst=dst,
                 hb=hb, rhs=rhs)
    out = torch.empty_like(dst)
    err = _kernels().pysco_scalaron_quartic_exact_half_sweep(
        src.data_ptr(), dst.data_ptr(), hb.data_ptr(), _ptr(rhs),
        float(c_q), out.data_ptr(), n, int(bool(to_red)), _f32(f_relax),
        _stream(out))
    _raise_on(err, "scalaron_quartic_exact_half_sweep")
    LAUNCHES["scalaron_quartic_exact_half_sweep"] += 1
    return out


def _kind_args(kind: str, x, b, q):
    if kind not in _KINDS:
        raise ValueError(f"residual kind {kind!r}, should be one of "
                         f"{tuple(_KINDS)}")
    code, _, needs_b = _KINDS[kind]
    if needs_b and b is None:
        raise ValueError(f"residual kind {kind!r} needs b")
    if kind in ("cubic", "quartic") and q is None:
        raise ValueError(f"residual kind {kind!r} needs q")
    n = x.shape[0]
    _check_n(kind, n)
    for name, t in (("x", x), ("b", b if needs_b else None)):
        _check(f"{kind} {name}", t, (n, n, n))
    q = 0.0 if q is None else _f32(q)
    return code, needs_b, n, float(n * n), _h2(n), q


def residual_norm2(kind: str, x, b=None, rhs=None, q=None) -> torch.Tensor:
    """Sum of squares of the ``kind`` residual over the (n, n, n) lattice
    (rhs - op with ``rhs``), a 0-dim float32 tensor on x's device. On the
    card the kernel marches along x with float4 accesses when n is a
    multiple of 4, at least 32, and every array 16-byte aligned, and takes
    one thread a cell otherwise; either way the sum has one fixed order,
    set by n alone: two calls are bitwise equal."""
    if not _on_cuda("residual_norm2", x, b, rhs):
        return residual_norm2_plain(kind, x, b, rhs, q)
    code, needs_b, n, n2, h2, qf = _kind_args(kind, x, b, q)
    _check("residual_norm2 rhs", rhs, (n, n, n))
    lib = _kernels()
    partial = torch.empty(lib.pysco_norm2_blocks(n), dtype=torch.float64,
                          device=x.device)
    out = torch.empty((), dtype=F32, device=x.device)
    err = lib.pysco_residual_norm2(
        code, x.data_ptr(), _ptr(b if needs_b else None), _ptr(rhs), n, n2,
        h2, qf, partial.data_ptr(), out.data_ptr(), _stream(out))
    _raise_on(err, "residual_norm2")
    LAUNCHES["residual_norm2"] += 1
    return out


def restrict3(kind: str, x, b=None, rhs=None, q=None,
              residual_only: bool = False):
    """One pass over the fine (n, n, n) lattice: (R(r), R(x)[, R(b)]) with
    R the 2x2x2 mean and r the ``kind`` residual (rhs - op with ``rhs``);
    R(b) for the kinds that read b. ``residual_only`` returns (R(r),) and
    writes nothing else."""
    if not _on_cuda("restrict3", x, b, rhs):
        return restrict3_plain(kind, x, b, rhs, q, residual_only)
    code, needs_b, n, n2, h2, qf = _kind_args(kind, x, b, q)
    _check("restrict3 rhs", rhs, (n, n, n))
    m = n // 2
    n_out = 1 if residual_only else 2 + int(needs_b)
    outs = tuple(torch.empty((m, m, m), dtype=F32, device=x.device)
                 for _ in range(n_out))
    ptrs = [o.data_ptr() for o in outs] + [None] * (3 - n_out)
    err = _kernels().pysco_restrict3(
        code, x.data_ptr(), _ptr(b if needs_b else None), _ptr(rhs), n, n2,
        h2, qf, *ptrs, _stream(outs[0]))
    _raise_on(err, "restrict3")
    LAUNCHES["restrict3"] += 1
    return outs


def add_prolongation(y, x_c) -> torch.Tensor:
    """y + the trilinear prolongation of the coarse x_c, (n, n, n) +
    (n/2, n/2, n/2) -> (n, n, n). On the card the kernel marches along x
    with float4 accesses when n is a multiple of 4 and y is 16-byte
    aligned, and takes one fine cell a thread otherwise (n = 2, 6, 10,
    ... or a y that is an offset view); both are bitwise the twin."""
    if not _on_cuda("add_prolongation", y, x_c):
        return add_prolongation_plain(y, x_c)
    n = y.shape[0]
    _check_n("add_prolongation", n)
    _check("add_prolongation y", y, (n, n, n))
    _check("add_prolongation x_c", x_c, (n // 2,) * 3)
    out = torch.empty_like(y)
    err = _kernels().pysco_add_prolongation(
        y.data_ptr(), x_c.data_ptr(), out.data_ptr(), n, _stream(out))
    _raise_on(err, "add_prolongation")
    LAUNCHES["add_prolongation"] += 1
    return out
