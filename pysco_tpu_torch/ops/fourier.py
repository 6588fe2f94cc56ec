"""Spectral operators on rfft half grids (PyTorch port of
``pysco_tpu/ops/fourier.py``).

Every operator is an elementwise expression on the ``(N, N, N//2+1)``
complex64 half grid around ``torch.fft``; wavenumbers are integers
(cycles per box) and are built on the device of the grid they act on.
The arithmetic follows the JAX module term by term, in float32, so the
two agree to float32 roundoff (the FFT libraries differ: pocketfft on
the CPU, cuFFT on the card).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

F32 = torch.float32


def rfft3(x: torch.Tensor) -> torch.Tensor:
    """3D real-to-complex FFT, float32 -> complex64 half grid."""
    return torch.fft.rfftn(x.to(F32))


def irfft3(xk: torch.Tensor) -> torch.Tensor:
    """3D complex-to-real inverse FFT on an (N, N, N//2+1) half grid."""
    n = xk.shape[0]
    return torch.fft.irfftn(xk, s=(n, n, n)).to(F32)


def irfft3_vec(xk: torch.Tensor) -> torch.Tensor:
    """Inverse FFT of a vector field (N, N, N//2+1, 3) -> (N, N, N, 3)."""
    n = xk.shape[0]
    return torch.fft.irfftn(xk, s=(n, n, n), dim=(0, 1, 2)).to(F32)


def _wavenumbers(n: int, device):
    """Integer wavenumbers for an (n, n, n//2+1) half grid, broadcast-ready:
    kx, ky in [-n/2, n/2) and kz in [0, n/2]."""
    k_full = ((torch.arange(n, device=device) + n // 2) % n - n // 2).to(F32)
    kx = k_full[:, None, None]
    ky = k_full[None, :, None]
    kz = torch.arange(n // 2 + 1, device=device).to(F32)[None, None, :]
    return kx, ky, kz


def _k2(n: int, device) -> torch.Tensor:
    kx, ky, kz = _wavenumbers(n, device)
    return kx * kx + ky * ky + kz * kz


def _k2_safe(n: int, device) -> torch.Tensor:
    """|k|^2 with the DC entry set to 1 (the DC mode is zeroed after)."""
    k2 = _k2(n, device)
    k2[0, 0, 0] = 1.0
    return k2


def _sinc_weight(n: int, device, ks=None) -> torch.Tensor:
    """Product of per-axis sinc mass-assignment window functions (over the
    wavenumbers ``ks`` when given: a pencil's)."""
    h = 1.0 / n
    kx, ky, kz = ks if ks is not None else _wavenumbers(n, device)
    return torch.sinc(kx * h) * torch.sinc(ky * h) * torch.sinc(kz * h)


def _f32(x: float) -> float:
    """Round a host scalar to float32 (the JAX module's ``F32(...)``)."""
    return float(np.float32(x))


def _zero_dc(xk: torch.Tensor) -> torch.Tensor:
    xk[0, 0, 0] = 0
    return xk


def inverse_laplacian(xk: torch.Tensor) -> torch.Tensor:
    """Multiply by -1/(4 pi^2 k^2); DC mode zeroed."""
    k2 = _k2_safe(xk.shape[0], xk.device)
    return _zero_dc(xk * (_f32(-0.25 / math.pi ** 2) / k2))


def inverse_laplacian_compensated(xk: torch.Tensor, p: int) -> torch.Tensor:
    """Inverse Laplacian with Jing (2005) deconvolution of the MAS window."""
    n = xk.shape[0]
    k2 = _k2_safe(n, xk.device)
    w = _sinc_weight(n, xk.device)
    return _zero_dc(xk * (w ** (-2 * p) * _f32(-0.25 / math.pi ** 2) / k2))


def inverse_laplacian_7pt(xk: torch.Tensor) -> torch.Tensor:
    """Exact inverse of the discrete 7-point Laplacian in k-space."""
    n = xk.shape[0]
    pi_h = _f32(math.pi / n)
    h = _f32(1.0 / n)
    minus_h2_inv4 = _f32(-0.25 * h * h)
    kx, ky, kz = _wavenumbers(n, xk.device)
    f = (torch.sin(pi_h * kx) ** 2 + torch.sin(pi_h * ky) ** 2
         + torch.sin(pi_h * kz) ** 2)
    f[0, 0, 0] = 1.0
    return _zero_dc(xk * (minus_h2_inv4 / f))


_TWOPI_I = complex(0.0, float(np.float32(2 * math.pi)))
_FOURPI2 = _f32(4 * math.pi ** 2)


def gradient(xk: torch.Tensor) -> torch.Tensor:
    """Spectral gradient 2 pi i k_n x -> (N, N, N//2+1, 3)."""
    return torch.stack([gradient_axis(xk, a) for a in range(3)], dim=-1)


def gradient_axis(xk: torch.Tensor, axis: int) -> torch.Tensor:
    """One component of :func:`gradient` (the device ICs take one at a
    time, holding one complex grid where the stack holds three)."""
    ks = _wavenumbers(xk.shape[0], xk.device)
    return (_TWOPI_I * xk) * ks[axis]


def hessian(xk: torch.Tensor, ij) -> torch.Tensor:
    """Second-derivative kernel -4 pi^2 k_i k_j x."""
    ks = _wavenumbers(xk.shape[0], xk.device)
    return -ks[ij[0]] * ks[ij[1]] * _FOURPI2 * xk


def sum_of_hessian(xk: torch.Tensor, ij1, ij2) -> torch.Tensor:
    """-4 pi^2 (k_i k_j + k_l k_m) x."""
    ks = _wavenumbers(xk.shape[0], xk.device)
    return (-(ks[ij1[0]] * ks[ij1[1]] + ks[ij2[0]] * ks[ij2[1]]) * _FOURPI2
            * xk)


def diff_of_hessian(xk: torch.Tensor, ij1, ij2) -> torch.Tensor:
    """-4 pi^2 (k_i k_j - k_l k_m) x."""
    ks = _wavenumbers(xk.shape[0], xk.device)
    return (-(ks[ij1[0]] * ks[ij1[1]] - ks[ij2[0]] * ks[ij2[1]]) * _FOURPI2
            * xk)


def _gradient_inverse_laplacian_from_ratio(xk, ratio):
    kx, ky, kz = _wavenumbers(xk.shape[0], xk.device)
    tmp = -1j * (ratio * xk)
    out = torch.stack((tmp * kx, tmp * ky, tmp * kz), dim=-1)
    out[0, 0, 0, :] = 0
    return out


def gradient_inverse_laplacian(xk: torch.Tensor) -> torch.Tensor:
    """-i k_n / (2 pi k^2) x: spectral displacement/force kernel."""
    k2 = _k2_safe(xk.shape[0], xk.device)
    return _gradient_inverse_laplacian_from_ratio(
        xk, _f32(0.5 / math.pi) / k2
    )


def gradient_inverse_laplacian_compensated(xk: torch.Tensor,
                                           p: int) -> torch.Tensor:
    n = xk.shape[0]
    k2 = _k2_safe(n, xk.device)
    w = _sinc_weight(n, xk.device)
    return _gradient_inverse_laplacian_from_ratio(
        xk, w ** (-2 * p) * _f32(0.5 / math.pi) / k2
    )


class _PkBins(NamedTuple):
    """Fixed-order binning of an (n, n, n//2+1) half grid for
    :func:`power_spectrum`, bins 1 .. kmax-1 only.

    The modes of each bin, in flat-index order, are laid out in chunks of
    ``_PK_CHUNK`` slots, each bin starting on a chunk; ``slot_src`` gives
    each slot's flat index (the trailing index ``n_flat`` reads a zero).
    A chunk is summed in one row reduction, then each bin's chunks (padded
    to a common count with the extra zero chunk) in another: every bin
    has one summation order, on every device and run, and no float
    atomics are involved."""

    slot_src: torch.Tensor  # (n_chunks * _PK_CHUNK,) int64
    chunk_of_bin: torch.Tensor  # (n_bins, max_chunks) int64
    k: torch.Tensor  # mean |k| per bin, float32
    nmodes: torch.Tensor  # modes per bin, float32


_PK_CHUNK = 512
_PK_BINS: dict = {}


def _pk_bins(n: int, device, y0: int = 0, ny: int | None = None) -> _PkBins:
    """The binning of :func:`power_spectrum` for grid size n, made on the
    host once per (n, device); with ``y0`` and ``ny`` that of the pencil
    (n, ny, n//2+1) holding the y rows from ``y0`` on (the slab mode's
    layout; ``k`` is then the pencil's sum of |k| per bin, float64, and
    ``nmodes`` its own count, for the shards' sums to be added)."""
    pencil = ny is not None
    key = (n, str(device), y0, ny)
    if key in _PK_BINS:
        return _PK_BINS[key]
    kx, ky, kz = _wavenumbers(n, "cpu")
    if pencil:
        ky = ky[:, y0:y0 + ny]
    k_norm = torch.sqrt(kx * kx + ky * ky + kz * kz).reshape(-1).numpy()
    k_index = (k_norm + np.float32(0.5)).astype(np.int64)
    kmax = int(2 * (n // 2) / 3)
    modes = np.nonzero((k_index >= 1) & (k_index < kmax))[0]
    order = modes[np.argsort(k_index[modes], kind="stable")]
    counts = np.bincount(k_index[order] - 1, minlength=kmax - 1)
    chunks = -(-counts // _PK_CHUNK)  # ceil
    first_chunk = np.concatenate(([0], np.cumsum(chunks)[:-1]))
    n_chunks = int(chunks.sum())
    slot_src = np.full(n_chunks * _PK_CHUNK, k_norm.size, np.int64)
    bin_start = np.concatenate(([0], np.cumsum(counts)[:-1]))
    for c, s0, f0 in zip(counts, bin_start, first_chunk):
        slot_src[f0 * _PK_CHUNK: f0 * _PK_CHUNK + c] = order[s0: s0 + c]
    chunk_of_bin = np.full((kmax - 1, max(int(chunks.max()), 1)), n_chunks,
                           np.int64)
    for b, (c, f0) in enumerate(zip(chunks, first_chunk)):
        chunk_of_bin[b, :c] = np.arange(f0, f0 + c)
    bins = _PkBins(torch.as_tensor(slot_src), torch.as_tensor(chunk_of_bin),
                   None, torch.as_tensor(counts.astype(np.float32)))
    ksum = _binned_sum(torch.as_tensor(k_norm), bins)
    bins = bins._replace(
        k=ksum if pencil else (ksum / bins.nmodes.double()).to(F32))
    bins = _PkBins(*(t.to(device) for t in bins))
    _PK_BINS[key] = bins
    return bins


def _binned_sum(values: torch.Tensor, bins: _PkBins) -> torch.Tensor:
    """Float64 sum per bin of a flat float32 field, in the fixed order of
    ``bins``."""
    zero = values.new_zeros(1, dtype=torch.float64)
    ext = torch.cat((values.reshape(-1).to(torch.float64), zero))
    chunk_sums = ext[bins.slot_src].reshape(-1, _PK_CHUNK).sum(1)
    return torch.cat((chunk_sums, zero))[bins.chunk_of_bin].sum(1)


def power_spectrum(xk: torch.Tensor, p: int):
    """Binned power spectrum of an rfft half grid with sinc^-p compensation.

    Bins |delta(k)|^2 by round(|k|) up to the Orszag 2/3 Nyquist cutoff
    over the half grid (each mode counted once). Returns (k, Pk, Nmodes)
    in grid units; the caller applies the box normalisation. The sums run
    in one fixed order (:class:`_PkBins`), so the result is bitwise the
    same on every run, on the card too.
    """
    n = xk.shape[0]
    bins = _pk_bins(n, xk.device)
    amp = xk * _sinc_weight(n, xk.device) ** (-p) if p != 0 else xk
    delta2 = amp.real ** 2 + amp.imag ** 2
    pksum = _binned_sum(delta2, bins)
    return (bins.k.clone(), (pksum / bins.nmodes.double()).to(F32),
            bins.nmodes.clone())
