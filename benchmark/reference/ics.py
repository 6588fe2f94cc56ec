"""2LPT initial conditions from the seeded white-noise draw.

The draw is PySCo's stream (``initial_conditions.py``): NumPy's
``default_rng(seed)``, float32 uniforms for the amplitudes, then for the
phases, of the upper half of the Fourier cube (planes 0..n/2), then 7
corner amplitudes. The Hermitian half grid keeps PySCo's resolution of
the self-conjugate planes (i = 0 and i = n/2: of two writes to one cell,
the one at the larger flat index of the lower write wins). Everything
after the draw runs on ``device`` in the given precision.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .cosmology import Cosmology
from .precision import F64, Precision


def wavenumbers(n: int, device, dtype=torch.float64):
    """Integer wavenumbers of the (n, n, n/2+1) half grid, broadcastable."""
    k = ((torch.arange(n, device=device) + n // 2) % n - n // 2).to(dtype)
    kz = torch.arange(n // 2 + 1, device=device).to(dtype)
    return k[:, None, None], k[None, :, None], kz[None, None, :]


def _self_conjugate(plane: torch.Tensor) -> torch.Tensor:
    n = plane.shape[0]
    j = torch.arange(n, device=plane.device)
    jm = (-j) % n
    own = j[:, None] * n + j[None, :]
    mirror = jm[:, None] * n + jm[None, :]
    return torch.where(mirror >= own, torch.conj(plane[jm][:, jm]), plane)


def white_noise(seed: int, n: int, device, prec: Precision = F64):
    """The Rayleigh-amplitude Hermitian white noise on the half grid."""
    rng = np.random.default_rng(seed)
    m = n // 2
    shape = (m + 1, n, n)
    amp_u = torch.as_tensor(rng.random(shape, dtype=np.float32),
                            device=device).to(prec.real)
    phase_u = torch.as_tensor(rng.random(shape, dtype=np.float32),
                              device=device).to(prec.real)
    corners = rng.random(7, dtype=np.float32).astype(np.float64)
    amp = prec.q(torch.sqrt(-torch.log(1.0 - amp_u)))
    del amp_u
    phase = prec.q(2.0 * math.pi * phase_u)
    del phase_u
    U = prec.q(torch.complex(amp * torch.cos(phase), amp * torch.sin(phase)))
    del amp, phase
    jm = (-torch.arange(n, device=device)) % n
    km = (-torch.arange(m + 1, device=device)) % n
    planes = [_self_conjugate(U[0])[:, : m + 1]]
    planes += [U[i, :, : m + 1] for i in range(1, m)]
    planes.append(_self_conjugate(U[m])[:, : m + 1])
    planes += [torch.conj(U[n - i][jm][:, km]) for i in range(m + 1, n)]
    out = torch.stack(planes)
    del U, planes
    out[0, 0, 0] = 0
    cells = ((0, 0, m), (0, m, 0), (0, m, m), (m, 0, 0), (m, 0, m),
             (m, m, 0), (m, m, m))
    for c, idx in zip(corners, cells):
        out[idx] = math.sqrt(-math.log(1.0 - c))
    return prec.q(out)


def transfer(pk_file: str, boxlen: float, n: int, device,
             prec: Precision = F64) -> torch.Tensor:
    """sqrt(P(|k|) / L^3) n^3 on the half grid (|k| in cycles per box)."""
    k, pk = np.loadtxt(pk_file).T
    kx, ky, kz = wavenumbers(n, "cpu")
    kmag = torch.sqrt(kx * kx + ky * ky + kz * kz).numpy()
    amp = np.interp(kmag, k / (2 * math.pi / boxlen),
                    np.sqrt(pk / boxlen ** 3) * n ** 3)
    return prec.t(torch.as_tensor(amp, device=device))


def _inverse_laplacian(xk, prec):
    n = xk.shape[0]
    kx, ky, kz = wavenumbers(n, xk.device, prec.real)
    k2 = kx * kx + ky * ky + kz * kz
    k2[0, 0, 0] = 1.0
    out = prec.q(xk * (-0.25 / math.pi ** 2 / k2))
    out[0, 0, 0] = 0
    return out


def _irfft(xk, prec):
    n = xk.shape[0]
    return prec.q(torch.fft.irfftn(xk, s=(n, n, n)))


def _rfft(x, prec):
    return prec.q(torch.fft.rfftn(x))


def _hessian(phik, i, j, prec):
    ks = wavenumbers(phik.shape[0], phik.device, prec.real)
    return _irfft(prec.q(-4.0 * math.pi ** 2 * ks[i] * ks[j] * phik), prec)


def _displacement(phik, axis, prec):
    ks = wavenumbers(phik.shape[0], phik.device, prec.real)
    return _irfft(prec.q(2j * math.pi * ks[axis] * phik), prec).reshape(-1)


def second_order_source(phi1k, prec):
    """phi_xx (phi_yy + phi_zz) + phi_yy phi_zz - phi_xy^2 - phi_xz^2 -
    phi_yz^2 of the first-order potential."""
    h11 = _hessian(phi1k, 1, 1, prec)
    h22 = _hessian(phi1k, 2, 2, prec)
    rhs = prec.q(_hessian(phi1k, 0, 0, prec) * (h11 + h22) + h11 * h22)
    del h11, h22
    for i, j in ((0, 1), (0, 2), (1, 2)):
        h = _hessian(phi1k, i, j, prec)
        rhs = prec.q(rhs - h * h)
        del h
    return rhs


def lpt2(param, seed: int, device, prec: Precision = F64,
         cosmo: Cosmology | None = None):
    """2LPT particles of the lattice at z_start: positions wrapped into
    [0, 1) and velocities, each (3, n^3) in lattice order (x slowest).
    ``cosmo`` gives the growth (None: ``Cosmology(param)``)."""
    if (str(param["initial_conditions"]).casefold() != "2lpt"
            or bool(param["fixed_ICS"]) or bool(param["paired_ICS"])
            or bool(param["dealiased_ICS"])):
        raise NotImplementedError("the reference builds plain 2LPT only")
    n = round(int(param["npart"]) ** (1.0 / 3.0))
    a = 1.0 / (1.0 + float(param["z_start"]))
    d1, v1, d2, v2 = (cosmo or Cosmology(param)).lpt_coefficients(a)
    delta = white_noise(seed, n, device, prec)
    delta = prec.q(delta * transfer(param["power_spectrum_file"],
                                    float(param["boxlen"]), n, device, prec))
    phi1k = _inverse_laplacian(delta, prec)
    del delta
    offset = 0.5 / n if str(param["position_ICS"]).casefold() == "center" \
        else 0.0
    coords = prec.t(torch.arange(n, device=device) / n + offset)
    pos = torch.empty((3, n ** 3), dtype=prec.real, device=device)
    vel = torch.empty_like(pos)
    for ax in range(3):
        shape = [1, 1, 1]
        shape[ax] = n
        psi = _displacement(phi1k, ax, prec)
        lattice = coords.reshape(shape).expand(n, n, n).reshape(-1)
        pos[ax] = prec.q(lattice - d1 * psi)
        vel[ax] = prec.q(-v1 * psi)
        del psi
    phi2k = _inverse_laplacian(_rfft(second_order_source(phi1k, prec), prec),
                               prec)
    del phi1k
    for ax in range(3):
        psi = _displacement(phi2k, ax, prec)
        pos[ax] = prec.q(pos[ax] + d2 * psi)
        vel[ax] = prec.q(vel[ax] + v2 * psi)
        del psi
    return prec.q(torch.remainder(pos, 1.0)), vel
