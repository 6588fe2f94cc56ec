"""On-device LPT initial conditions (PyTorch port of
``pysco_tpu/ic_device.py``).

The host keeps only the raw RNG draws, in the reference's stream order
(``ic.py`` white_noise_fourier[_fixed]: amplitudes, phases, then 7 corner
scalars). Everything downstream runs in torch on the device, in
complex64/float32 and in the JAX module's operand order: the Rayleigh map
and trigonometry, the Hermitian assembly of the rfft half grid, the
transfer multiply, the 1/2/3LPT sources (Hessian products, with the
rotational 3LPT terms), Orszag 3/2 dealiasing and the particle-lattice
initialisation. At 512^3 the host path is about 20 single-threaded
768^3 FFTs; on the card the same algebra takes seconds.

Particles come out in the tiled engine's (4, npart) column layout (no row
array, no sentinel tail: :func:`supported` requires a chunk-aligned
particle count). Between terms at most the source, three real grids and
the padded spectra are live.
"""

from __future__ import annotations

import logging
import math
from time import perf_counter

import numpy as np
import torch

from . import ic as ic_host
from .ops import fourier, mesh, tiled_pm
from .utils.units import PC_M

F32 = torch.float32
C64 = torch.complex64

# seconds of the last generate_lpt call, for the caller's report
TIMES = {"generate_lpt": None}


# ---------------------------------------------------------------------------
# Orszag 3/2 dealiasing (ic.py pad/trim)
# ---------------------------------------------------------------------------

def _copy_corners(out: torch.Tensor, x: torch.Tensor, m: int) -> None:
    out[:m, :m, :m] = x[:m, :m, :m]
    out[-m + 1:, :m, :m] = x[-m + 1:, :m, :m]
    out[:m, -m + 1:, :m] = x[:m, -m + 1:, :m]
    out[-m + 1:, -m + 1:, :m] = x[-m + 1:, -m + 1:, :m]


def pad_k(x: torch.Tensor) -> torch.Tensor:
    """Zero-pad an rfft half grid to 3N/2."""
    n = x.shape[0]
    ne = 3 * n // 2
    out = torch.zeros((ne, ne, ne // 2 + 1), dtype=x.dtype, device=x.device)
    _copy_corners(out, x, n // 2)
    return out


def trim_k(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pad_k`."""
    n = 2 * x.shape[0] // 3
    m = n // 2
    out = torch.zeros((n, n, m + 1), dtype=x.dtype, device=x.device)
    _copy_corners(out, x, m)
    return out


def _trim(rhs: torch.Tensor, rescale: float) -> torch.Tensor:
    """Orszag 3/2 trim back to N plus the 1.5^k volume rescale."""
    return fourier.irfft3(trim_k(fourier.rfft3(rhs))) * float(
        np.float32(rescale))


# ---------------------------------------------------------------------------
# White noise assembly
# ---------------------------------------------------------------------------

def _hermitian_self_plane(plane: torch.Tensor) -> torch.Tensor:
    """The i = 0 and i = middle planes: the reference's last-write-wins
    resolution of their overlapping upper and lower writes."""
    n = plane.shape[0]
    j = torch.arange(n, device=plane.device)
    jp = (-j) % n
    t_up = j[:, None] * n + j[None, :]
    t_low = jp[:, None] * n + jp[None, :]
    lower = torch.conj(plane[jp[:, None], jp[None, :]])
    return torch.where(t_low >= t_up, lower, plane)


def _assemble_half_grid(U: torch.Tensor) -> torch.Tensor:
    """rfft half grid (n, n, middle+1) from the upper-half draws
    U[(middle+1), n, n], with the reference's Hermitian symmetry."""
    middle = U.shape[0] - 1
    n = U.shape[1]
    jp = (-torch.arange(n, device=U.device)) % n
    kp_half = (-torch.arange(middle + 1, device=U.device)) % n
    self0 = _hermitian_self_plane(U[0])[:, : middle + 1]
    selfm = _hermitian_self_plane(U[middle])[:, : middle + 1]
    upper = U[1:middle, :, : middle + 1]
    # planes middle+1 .. n-1 hold conj(U[n-i]) reindexed
    lower = torch.conj(U[1:middle][:, jp][:, :, kp_half]).flip(0)
    return torch.cat([self0[None], upper, selfm[None], lower], dim=0)


def _k2_int_grid(n: int, device) -> torch.Tensor:
    """Integer |k|^2 on the rfft half grid (the index into the transfer
    table)."""
    half = n // 2
    ki = (torch.arange(n, device=device) + half) % n - half
    kz = torch.arange(half + 1, device=device)
    return ((ki * ki)[:, None, None] + (ki * ki)[None, :, None]
            + (kz * kz)[None, None, :])


def _corner_indices(middle: int):
    m = middle
    return ((0, 0, m), (0, m, 0), (0, m, m),
            (m, 0, 0), (m, 0, m), (m, m, 0), (m, m, m))


def _rayleigh(u: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(-torch.log(1.0 - u))


def _noise_to_density_k(amps, phases, corners, table) -> torch.Tensor:
    """Rayleigh white noise -> Hermitian half grid -> x transfer."""
    middle = amps.shape[0] - 1
    phase = float(np.float32(2 * np.pi)) * phases
    amplitude = _rayleigh(amps)
    U = torch.complex(amplitude * torch.cos(phase),
                      amplitude * torch.sin(phase))
    del phase, amplitude
    out = _assemble_half_grid(U)
    del U
    out[0, 0, 0] = 0
    cvals = _rayleigh(corners).to(C64)
    for i, idx in enumerate(_corner_indices(middle)):
        out[idx] = cvals[i]
    return out * table[_k2_int_grid(out.shape[0], out.device)]


def _noise_fixed_to_density_k(phases, shift: float, table) -> torch.Tensor:
    """Unit-amplitude ("fixed") variant, phase-shifted by pi when
    paired."""
    middle = phases.shape[0] - 1
    phase = float(np.float32(2 * np.pi)) * phases + shift
    U = torch.complex(torch.cos(phase), torch.sin(phase))
    del phase
    out = _assemble_half_grid(U)
    del U
    out[0, 0, 0] = 0
    for idx in _corner_indices(middle):
        out[idx] = 1.0
    return out * table[_k2_int_grid(out.shape[0], out.device)]


# ---------------------------------------------------------------------------
# LPT sources: one FFT per term, at most the source and three real grids
# live (the JAX module's sequence of small programs)
# ---------------------------------------------------------------------------

def _hess(src_k, ij):
    return fourier.irfft3(fourier.hessian(src_k, ij))


def _sum_hess(src_k, ij1, ij2):
    return fourier.irfft3(fourier.sum_of_hessian(src_k, ij1, ij2))


def _diff_hess(src_k, ij1, ij2):
    return fourier.irfft3(fourier.diff_of_hessian(src_k, ij1, ij2))


def _invlap_of_real(rhs):
    return fourier.inverse_laplacian(fourier.rfft3(rhs))


def compute_2ndorder_rhs(phi1_k, dealias: bool) -> torch.Tensor:
    p1 = pad_k(phi1_k) if dealias else phi1_k
    s = _sum_hess(p1, (1, 1), (2, 2))
    rhs = _hess(p1, (0, 0)) * s
    del s
    rhs = rhs + _hess(p1, (1, 1)) * _hess(p1, (2, 2))
    for ij in ((0, 1), (0, 2), (1, 2)):
        h = _hess(p1, ij)
        rhs = rhs - h * h
        del h
    del p1
    return _trim(rhs, 1.5 ** 3) if dealias else rhs


def compute_3a_rhs(phi1_k, dealias: bool) -> torch.Tensor:
    p1 = pad_k(phi1_k) if dealias else phi1_k
    rhs = _hess(p1, (0, 0)) * _hess(p1, (1, 1)) * _hess(p1, (2, 2))
    h01 = _hess(p1, (0, 1))
    h02 = _hess(p1, (0, 2))
    h12 = _hess(p1, (1, 2))
    rhs = rhs + 2.0 * h01 * h02 * h12
    rhs = rhs - h12 * h12 * _hess(p1, (0, 0))
    del h12
    rhs = rhs - h02 * h02 * _hess(p1, (1, 1))
    del h02
    rhs = rhs - h01 * h01 * _hess(p1, (2, 2))
    del h01, p1
    return _trim(rhs, 1.5 ** 6) if dealias else rhs


def compute_3b_rhs(phi1_k, phi2_k, dealias: bool) -> torch.Tensor:
    if dealias:
        p1, p2 = pad_k(phi1_k), pad_k(phi2_k)
    else:
        p1, p2 = phi1_k, phi2_k
    rhs = 0.5 * _hess(p1, (0, 0)) * _sum_hess(p2, (1, 1), (2, 2))
    rhs = rhs + 0.5 * _hess(p1, (1, 1)) * _sum_hess(p2, (0, 0), (2, 2))
    rhs = rhs + 0.5 * _hess(p1, (2, 2)) * _sum_hess(p2, (0, 0), (1, 1))
    for ij in ((0, 1), (0, 2), (1, 2)):
        rhs = rhs - _hess(p1, ij) * _hess(p2, ij)
    del p1, p2
    return _trim(rhs, 1.5 ** 3) if dealias else rhs


def compute_3c_rhs(phi1_k, phi2_k, dealias: bool,
                   component: int) -> torch.Tensor:
    """Rotational 3LPT source A_x/A_y/A_z (component 0/1/2)."""
    if dealias:
        p1, p2 = pad_k(phi1_k), pad_k(phi2_k)
    else:
        p1, p2 = phi1_k, phi2_k
    # (first Hessian pair, second pair, the pair of the third term, the
    # diff axes) per component
    ij_a, ij_b, ij_c, dd = {
        0: ((0, 2), (0, 1), (1, 2), ((1, 1), (2, 2))),
        1: ((0, 1), (1, 2), (0, 2), ((2, 2), (0, 0))),
        2: ((1, 2), (0, 2), (0, 1), ((0, 0), (1, 1))),
    }[component]
    rhs = _hess(p1, ij_a) * _hess(p2, ij_b)
    rhs = rhs - _hess(p2, ij_a) * _hess(p1, ij_b)
    rhs = rhs + _hess(p1, ij_c) * _diff_hess(p2, *dd)
    rhs = rhs - _hess(p2, ij_c) * _diff_hess(p1, *dd)
    del p1, p2
    return _trim(rhs, 1.5 ** 3) if dealias else rhs


# ---------------------------------------------------------------------------
# Particle lattice (ic.py initialise_1LPT / add_nLPT on the column state)
# ---------------------------------------------------------------------------

def _psi_axis(src_k, axis: int) -> torch.Tensor:
    """One displacement component irfft3(2 pi i k_axis src_k), flat."""
    return fourier.irfft3(fourier.gradient_axis(src_k, axis)).reshape(-1)


def _stage_1lpt(density_k, offset: float, dplus_1: float, fH_1: float):
    """phi1 and the 1LPT lattice: (4, n^3) column state, row 3 zero."""
    phi1_k = fourier.inverse_laplacian(density_k)
    n = phi1_k.shape[0]
    dev = phi1_k.device
    position = torch.zeros((4, n ** 3), dtype=F32, device=dev)
    velocity = torch.zeros((4, n ** 3), dtype=F32, device=dev)
    coords = torch.arange(n, dtype=F32, device=dev) * float(
        np.float32(1.0 / n)) + offset
    dfH = float(np.float32(dplus_1) * np.float32(fH_1))
    for a in range(3):
        psi = _psi_axis(phi1_k, a)
        shape = [1, 1, 1]
        shape[a] = n
        lattice = coords.reshape(shape).expand(n, n, n).reshape(-1)
        position[a] = lattice - dplus_1 * psi
        velocity[a] = -dfH * psi
        del psi, lattice
    return phi1_k, position, velocity


def _apply_nlpt(position, velocity, src_k, dplus_n: float, fH_n: float):
    dfH = float(np.float32(dplus_n) * np.float32(fH_n))
    for a in range(3):
        psi = _psi_axis(src_k, a)
        position[a] += dplus_n * psi
        velocity[a] += dfH * psi
        del psi


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------

def supported(param) -> bool:
    """Device ICs cover the LPT orders on the tiled engine with a
    chunk-aligned particle count (so the column state needs no sentinel
    tail), unless ``ic_device`` is false. Reads param, not a solver
    config: a restart rewrites param inside ic.generate."""
    ics = param["initial_conditions"]
    if isinstance(ics, (int, np.integer)) and not isinstance(ics, bool):
        return False
    engine = str(param.get("particle_engine", "pallas")).casefold()
    npart = int(param["npart"])
    return ("lpt" in str(ics).casefold() and engine == "pallas"
            and tiled_pm.padded_cols(npart) == npart
            and bool(param.get("ic_device", True)))


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def generate_lpt(param, tables, device="cuda"):
    """1/2/3LPT initial conditions on ``device``: (position, velocity) as
    (4, npart) float32 column tensors, positions wrapped into [0, 1). The
    output_00000 snapshot is written as by the host path unless
    ``write_initial_snapshot`` is false."""
    device = torch.device(device)
    t0 = perf_counter()
    order = str(param["initial_conditions"]).casefold()
    if order not in ("1lpt", "2lpt", "3lpt"):
        raise ValueError(
            f"initial_conditions={order}, should be 1LPT, 2LPT or 3LPT")
    a_start = 1.0 / (1 + param["z_start"])
    lna_start = np.log(a_start)
    logging.warning("z_start=%s (device IC path)", param["z_start"])
    Hz = tables[2](lna_start) * param["unit_t"] / (1e3 * PC_M)
    dealias = bool(param["dealiased_ICS"])

    ncells_1d = int(round(float(param["npart"]) ** (1.0 / 3.0)))
    middle = ncells_1d // 2
    seed = int(param["seed"])
    rng = (np.random.default_rng(seed) if seed >= 0
           else np.random.default_rng())
    table = torch.as_tensor(ic_host.transfer_table(param, ncells_1d),
                            device=device)
    shape = (middle + 1, ncells_1d, ncells_1d)

    def draw():
        return torch.as_tensor(rng.random(shape, dtype=np.float32),
                               device=device)

    if bool(param["fixed_ICS"]):
        phases = draw()
        logging.warning("Host RNG draw: %.1f s", perf_counter() - t0)
        shift = float(np.float32(np.pi)) if bool(param["paired_ICS"]) else 0.0
        density_k = _noise_fixed_to_density_k(phases, shift, table)
    else:
        amps = draw()
        phases = draw()
        corners = torch.as_tensor(rng.random(7, dtype=np.float32),
                                  device=device)
        logging.warning("Host RNG draw: %.1f s", perf_counter() - t0)
        density_k = _noise_to_density_k(amps, phases, corners, table)
        del amps
    del phases

    dplus_1_z0 = tables[3](0)
    dplus_1 = float(np.float32(tables[3](lna_start) / dplus_1_z0))
    fH_1 = float(np.float32(tables[4](lna_start) * Hz))
    offset = float(np.float32(
        0.5 / ncells_1d
        if str(param["position_ICS"]).casefold() == "center" else 0.0))
    phi1_k, position, velocity = _stage_1lpt(density_k, offset, dplus_1,
                                             fH_1)
    del density_k

    if order != "1lpt":
        logging.warning("Compute 2LPT contribution")
        phi2_k = _invlap_of_real(compute_2ndorder_rhs(phi1_k, dealias))
        _apply_nlpt(position, velocity, phi2_k,
                    float(np.float32(tables[5](lna_start) / dplus_1_z0 ** 2)),
                    float(np.float32(tables[6](lna_start) * Hz)))
        if order == "3lpt":
            def coeffs(i):
                return (-float(np.float32(tables[i](lna_start)
                                          / dplus_1_z0 ** 3)),
                        float(np.float32(tables[i + 1](lna_start) * Hz)))

            terms = (("a", 7), ("b", 9), ("cx", 11), ("cy", 11), ("cz", 11))
            for term, i in terms:
                logging.warning("Compute 3LPT %s contribution", term)
                if term == "a":
                    rhs = compute_3a_rhs(phi1_k, dealias)
                elif term == "b":
                    rhs = compute_3b_rhs(phi1_k, phi2_k, dealias)
                else:
                    rhs = compute_3c_rhs(phi1_k, phi2_k, dealias,
                                         "xyz".index(term[1]))
                src_k = _invlap_of_real(rhs)
                del rhs
                _apply_nlpt(position, velocity, src_k, *coeffs(i))
                del src_k
        del phi2_k
    del phi1_k

    position = mesh.periodic_wrap(position)
    _sync(position)
    TIMES["generate_lpt"] = perf_counter() - t0
    logging.warning("Device IC generation: %.1f s", TIMES["generate_lpt"])

    if bool(param.get("write_initial_snapshot", True)):
        from . import solver as solver_mod

        cfg = solver_mod.config_from_param(param)
        pos_np, vel_np = solver_mod.particles_to_rows(cfg, position,
                                                      velocity)
        ic_host.finalise_initial_conditions(pos_np, vel_np, param)
        logging.warning("Device IC + snapshot write: %.1f s",
                        perf_counter() - t0)
    return position, velocity
