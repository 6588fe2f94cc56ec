"""QUMOND source term (PyTorch port of ``pysco_tpu/models/mond.py``).

The quasi-linear MOND Poisson source is the divergence of
``nu(|grad phi_N|/g0) grad phi_N`` on face-centred points. Every B-face
quantity is the A-face quantity of the next cell, so each axis needs one
face-gradient field and one roll:

    out = sum_a (1/h) * [ roll(nu_A * gA_a, -1, a) - nu_A * gA_a ]

Interpolating-function families: simple / n / beta / gamma / delta. The
float32 constants are the JAX module's. On a face where the gradient is
exactly 0 the flux is its limit, 0, where the JAX module's is not a
number (nu(0) is infinite).

:func:`rhs` takes the plain PyTorch form, :func:`rhs_plain`, for a CPU
tensor and launches the hand-written kernel ``csrc/mond_source.cu`` (one
pass: phi read once, the source written once) for a CUDA tensor; there
is no fallback from one to the other. The kernel is bitwise the plain
form for the simple family; the others may differ by the ulps of
``powf``/``expf``/``rsqrtf`` against torch's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import stencil

F32 = np.float32


def _f32(x) -> float:
    """A host constant rounded to float32 (the JAX module's ``F32(...)``)."""
    return float(F32(x))


def nu_simple(y: torch.Tensor) -> torch.Tensor:
    return 0.5 + torch.sqrt(0.25 + 1.0 / y)


def nu_n(y: torch.Tensor, n: float) -> torch.Tensor:
    n = int(n)
    return (0.5 + torch.sqrt(0.25 + y ** (-n))) ** _f32(1.0 / n)


def nu_beta(y: torch.Tensor, beta: float) -> torch.Tensor:
    exp_minus_y = torch.exp(-y)
    one_minus = 1.0 - exp_minus_y
    positive = one_minus > 0
    extra = torch.where(
        positive, torch.where(positive, one_minus, 1.0) ** -0.5, 0.0)
    return _f32(beta) * exp_minus_y + extra


def nu_gamma(y: torch.Tensor, gamma: float) -> torch.Tensor:
    gamma = float(gamma)
    e = torch.exp(-(y ** _f32(0.5 * gamma)))
    return (1.0 - e) ** _f32(-1.0 / gamma) + _f32(1 - 1.0 / gamma) * e


def nu_delta(y: torch.Tensor, delta: float) -> torch.Tensor:
    delta = float(delta)
    return (1.0 - torch.exp(-(y ** _f32(0.5 * delta)))) ** _f32(-1.0 / delta)


_NU = {
    "simple": lambda y, alpha: nu_simple(y),
    "n": nu_n,
    "beta": nu_beta,
    "gamma": nu_gamma,
    "delta": nu_delta,
}


#: the families in the kernel's numbering (csrc/mond_source.cu Family)
_FAMILIES = ("simple", "n", "beta", "gamma", "delta")


def _family(mond_function: str) -> str:
    mond_function = mond_function.casefold()
    if mond_function not in _NU:
        raise NotImplementedError(
            f"mond_function {mond_function!r}, should be simple, n, beta, "
            "gamma or delta"
        )
    return mond_function


def _inv_g0(g0) -> float:
    return float(F32(1.0) / F32(g0))


def rhs(potential: torch.Tensor, g0, mond_function: str,
        alpha: float) -> torch.Tensor:
    """QUMOND right-hand side from the Newtonian potential; ``g0`` is the
    acceleration constant in box units, already scaled by aexp
    (``solver.compute_dynamics``). Periodic on each axis by its own
    length, 1/h from the last axis: the slab path passes (P + 4, m, m)
    extended slabs."""
    family = _family(mond_function)
    if not stencil._on_cuda("mond.rhs", potential,
                            g0 if isinstance(g0, torch.Tensor) else None):
        return rhs_plain(potential, g0, family, alpha)
    phi = potential
    stencil._check("mond.rhs", phi, phi.shape)
    if phi.dim() != 3 or min(phi.shape) < 3:
        raise ValueError("mond.rhs: expected a 3-D grid with every axis at "
                         f"least 3, got shape {tuple(phi.shape)}")
    nz, ny, nx = phi.shape
    out = torch.empty_like(phi)
    err = stencil._kernels().pysco_mond_source(
        phi.data_ptr(), out.data_ptr(), nz, ny, nx, _f32(nx),
        _f32(0.25 * nx), _inv_g0(float(g0)), _FAMILIES.index(family),
        float(alpha), stencil._stream(out))
    stencil._raise_on(err, "mond_source")
    stencil.LAUNCHES["mond_source"] += 1
    return out


def rhs_plain(potential: torch.Tensor, g0, mond_function: str,
              alpha: float) -> torch.Tensor:
    """The plain PyTorch form of :func:`rhs` (its CPU path, and the
    kernel's yardstick on the card)."""
    nu_fn = _NU[_family(mond_function)]
    phi = potential
    n = phi.shape[-1]
    invh = _f32(n)
    inv4h = _f32(0.25 * n)
    inv_g0 = _inv_g0(g0)

    # centred tangential differences, shared across axes
    D = [torch.roll(phi, -1, a) - torch.roll(phi, 1, a) for a in range(3)]
    out = torch.zeros_like(phi)
    for a in range(3):
        t1, t2 = [t for t in range(3) if t != a]
        # normal component at the A-face
        g_a = invh * (phi - torch.roll(phi, 1, a))
        g_t1 = inv4h * (D[t1] + torch.roll(D[t1], 1, a))
        g_t2 = inv4h * (D[t2] + torch.roll(D[t2], 1, a))
        norm = torch.sqrt(g_a * g_a + g_t1 * g_t1 + g_t2 * g_t2)
        # nu(0) is infinite; nu g -> 0 as |g| -> 0 (as sqrt(g0 |g|))
        flux = torch.where(norm > 0, nu_fn(norm * inv_g0, alpha) * g_a, 0.0)
        out = out + invh * (torch.roll(flux, -1, a) - flux)
    return out
