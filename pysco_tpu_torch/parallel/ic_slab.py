"""Slab-sharded LPT initial conditions (PyTorch port of
``pysco_tpu/parallel/ic_slab.py``).

The ``parallel_mode = slab`` counterpart of :mod:`pysco_tpu_torch.ic_device`.
The host draws only the raw uniform variates, in the reference's stream
order, and uploads them already cut into y blocks, one per shard. Everything
downstream runs on the mesh through the pencil FFT of :mod:`.slab` (one
all-to-all a 3-D FFT): the Rayleigh map and the Hermitian assembly of the
rfft half grid, the transfer multiply, every inverse Laplacian, spectral
gradient and Hessian product of the 1/2/3LPT sources, Orszag 3/2 dealiasing
and the particle lattice. No shard ever holds more than 1/D of a grid (the
padded one when dealiasing) beyond the two Hermitian self-planes, and the
particles never leave the shard that owns their lattice planes.

The arithmetic is :mod:`.ic_device`'s, operation for operation, on the
pencil layout; where the JAX module builds jitted stages
(``_make_noise_to_density_k``, ``_make_stage_1lpt``, ``_make_rhs_k``,
``_make_apply_src``) this one has the plain functions
(:func:`_noise_to_density_k`, :func:`_stage_1lpt`, :func:`_rhs_k`,
:func:`_apply_src`). The Orszag pad and trim move modes between the shards'
y blocks, which the JAX module leaves to GSPMD; here they are written out as
block moves (``mesh.move_rows``).

The result is the per-shard state of :func:`.slab.distribute_particles`:
shard r holds the lattice planes of its slab, so the run loop's first
sorted step (migration, tile sort) takes over directly; a particle whose
displacement or mass-assignment base puts it on a neighbour's plane is
one slab from home, as ``migrate`` expects.
"""

from __future__ import annotations

import logging
from time import perf_counter

import numpy as np
import torch

from .. import ic as ic_host
from ..ic_device import _hermitian_self_plane
from ..ops import fourier, tiled_pm
from ..ops import mesh as mesh_ops
from ..utils.units import PC_M
from . import mesh as pmesh
from . import slab
from .mesh import Mesh, shardwise

F32 = torch.float32
C64 = torch.complex64

# seconds of the last generate_lpt_slab call, for the caller's report
TIMES = {"generate_lpt_slab": None}

# ---------------------------------------------------------------------------
# Spectral kernels on the pencil layout (fourier.py analogues)
# ---------------------------------------------------------------------------

def _hessian_slab(xks: list, ij, m: int) -> list:
    """-4 pi^2 k_i k_j x on the (M, M/D, M/2+1) pencils
    (``fourier.hessian``)."""
    return slab._per_pencil(
        lambda x, ks: -ks[ij[0]] * ks[ij[1]] * fourier._FOURPI2 * x, xks, m)


def _sum_of_hessian_slab(xks: list, ij1, ij2, m: int) -> list:
    return slab._per_pencil(
        lambda x, ks: (-(ks[ij1[0]] * ks[ij1[1]] + ks[ij2[0]] * ks[ij2[1]])
                       * fourier._FOURPI2 * x), xks, m)


def _diff_of_hessian_slab(xks: list, ij1, ij2, m: int) -> list:
    return slab._per_pencil(
        lambda x, ks: (-(ks[ij1[0]] * ks[ij1[1]] - ks[ij2[0]] * ks[ij2[1]])
                       * fourier._FOURPI2 * x), xks, m)


def _ihess(xks: list, ij, m: int, mesh: Mesh) -> list:
    return slab.irfft3_slab(_hessian_slab(xks, ij, m), mesh, m)


def _psi_components_slab(src_k: list, m: int, mesh: Mesh):
    """The spectral gradient as real x-slabs, one component at a time (a
    generator: one component's grids live at once)."""
    tmp = [fourier._TWOPI_I * x for x in src_k]
    for a in range(3):
        yield slab.irfft3_slab(slab._per_pencil(
            lambda x, ks, a=a: x * ks[a], tmp, m), mesh, m)


# ---------------------------------------------------------------------------
# Orszag 3/2 dealiasing on the y-sharded pencils (ic_device.pad_k / trim_k):
# x and z are local, so each shard places or cuts them itself; the y rows
# cross between shards by one block move
# ---------------------------------------------------------------------------

def _pad_pencil(xks: list, mesh: Mesh, m: int) -> list:
    """Zero-pad the sharded rfft pencils of an m-grid to 3m/2."""
    ne, m2 = 3 * m // 2, m // 2
    local = []
    for x in xks:
        out = torch.zeros((ne, x.shape[1], ne // 2 + 1), dtype=x.dtype,
                          device=x.device)
        out[:m2, :, :m2] = x[:m2, :, :m2]
        out[-m2 + 1:, :, :m2] = x[-m2 + 1:, :, :m2]
        local.append(out)
    return pmesh.move_rows(local, mesh, 1, ne // len(mesh),
                           [(0, 0, m2), (m - m2 + 1, ne - m2 + 1, m2 - 1)])


def _trim_pencil(xks: list, mesh: Mesh, me: int, rescale: float) -> list:
    """Inverse of :func:`_pad_pencil`, the real-space rescale folded in
    (it is linear, so it commutes with the trim)."""
    m = 2 * me // 3
    m2 = m // 2
    rows = pmesh.move_rows(xks, mesh, 1, m // len(mesh),
                           [(0, 0, m2), (me - m2 + 1, m - m2 + 1, m2 - 1)])
    out = []
    for y in rows:
        t = torch.zeros((m, y.shape[1], m2 + 1), dtype=y.dtype,
                        device=y.device)
        t[:m2, :, :m2] = y[:m2, :, :m2]
        t[-m2 + 1:, :, :m2] = y[-m2 + 1:, :, :m2]
        out.append(t * float(np.float32(rescale)))
    return out


# ---------------------------------------------------------------------------
# LPT sources (ic_device.compute_* on the pencil layout; when dealiasing,
# the caller passes the padded pencils and m = 3n/2)
# ---------------------------------------------------------------------------

def _rhs_2ndorder(p1: list, m: int, mesh: Mesh) -> list:
    rhs = shardwise(lambda h, s: h * s, _ihess(p1, (0, 0), m, mesh),
                    slab.irfft3_slab(_sum_of_hessian_slab(p1, (1, 1), (2, 2),
                                                          m), mesh, m))
    rhs = shardwise(lambda r, a, b: r + a * b, rhs,
                    _ihess(p1, (1, 1), m, mesh), _ihess(p1, (2, 2), m, mesh))
    for ij in ((0, 1), (0, 2), (1, 2)):
        rhs = shardwise(lambda r, h: r - h * h, rhs, _ihess(p1, ij, m, mesh))
    return rhs


def _rhs_3a(p1: list, m: int, mesh: Mesh) -> list:
    def ih(ij):
        return _ihess(p1, ij, m, mesh)

    rhs = shardwise(lambda a, b, c: a * b * c, ih((0, 0)), ih((1, 1)),
                    ih((2, 2)))
    h01, h02, h12 = ih((0, 1)), ih((0, 2)), ih((1, 2))
    rhs = shardwise(lambda r, a, b, c: r + 2.0 * a * b * c, rhs, h01, h02, h12)
    rhs = shardwise(lambda r, a, b: r - a * a * b, rhs, h12, ih((0, 0)))
    del h12
    rhs = shardwise(lambda r, a, b: r - a * a * b, rhs, h02, ih((1, 1)))
    del h02
    return shardwise(lambda r, a, b: r - a * a * b, rhs, h01, ih((2, 2)))


def _rhs_3b(p1: list, p2: list, m: int, mesh: Mesh) -> list:
    def sum_h(ij1, ij2):
        return slab.irfft3_slab(_sum_of_hessian_slab(p2, ij1, ij2, m), mesh,
                                m)

    rhs = None
    for ij, pair in (((0, 0), ((1, 1), (2, 2))), ((1, 1), ((0, 0), (2, 2))),
                     ((2, 2), ((0, 0), (1, 1)))):
        term = shardwise(lambda h, s: 0.5 * h * s, _ihess(p1, ij, m, mesh),
                         sum_h(*pair))
        rhs = term if rhs is None else shardwise(lambda r, t: r + t, rhs,
                                                 term)
    for ij in ((0, 1), (0, 2), (1, 2)):
        rhs = shardwise(lambda r, a, b: r - a * b, rhs,
                        _ihess(p1, ij, m, mesh), _ihess(p2, ij, m, mesh))
    return rhs


def _rhs_3c(p1: list, p2: list, m: int, mesh: Mesh, component: int) -> list:
    """Rotational 3LPT source A_x/A_y/A_z (component 0/1/2)."""
    # (first Hessian pair, second pair, the pair of the third term, the
    # diff axes) per component
    ij_a, ij_b, ij_c, dd = {
        0: ((0, 2), (0, 1), (1, 2), ((1, 1), (2, 2))),
        1: ((0, 1), (1, 2), (0, 2), ((2, 2), (0, 0))),
        2: ((1, 2), (0, 2), (0, 1), ((0, 0), (1, 1))),
    }[component]

    def diff(p):
        return slab.irfft3_slab(_diff_of_hessian_slab(p, *dd, m), mesh, m)

    rhs = shardwise(lambda a, b: a * b, _ihess(p1, ij_a, m, mesh),
                    _ihess(p2, ij_b, m, mesh))
    rhs = shardwise(lambda r, a, b: r - a * b, rhs,
                    _ihess(p2, ij_a, m, mesh), _ihess(p1, ij_b, m, mesh))
    rhs = shardwise(lambda r, a, b: r + a * b, rhs,
                    _ihess(p1, ij_c, m, mesh), diff(p2))
    return shardwise(lambda r, a, b: r - a * b, rhs,
                     _ihess(p2, ij_c, m, mesh), diff(p1))


# ---------------------------------------------------------------------------
# The stages
# ---------------------------------------------------------------------------

def _add_nlpt_cols(position: list, velocity: list, src_k: list, m: int,
                   mesh: Mesh, n_local: int, dplus_n: float,
                   fH_n: float) -> None:
    """psi = grad(src) added onto every shard's real columns, in place."""
    dfH = float(np.float32(dplus_n) * np.float32(fH_n))
    for a, psis in enumerate(_psi_components_slab(src_k, m, mesh)):
        for pos, vel, psi in zip(position, velocity, psis):
            pa = psi.reshape(-1)
            pos[a, :n_local] += dplus_n * pa
            vel[a, :n_local] += dfH * pa


def _flip_y(us: list, mesh: Mesh) -> list:
    """The global y flip (row j -> (-j) % n) of axis-1-sharded blocks: each
    shard reverses its rows, the shards swap in reverse order, and a
    one-row roll across the shard edges finishes it."""
    d = len(mesh)
    rev = pmesh.ppermute([u.flip(1) for u in us],
                         [(i, d - 1 - i) for i in range(d)], mesh)
    last = pmesh.ppermute_fwd([r[:, -1:] for r in rev], mesh)
    return [torch.cat((a, r[:, :-1]), dim=1) for a, r in zip(last, rev)]


def _noise_to_density_k(draw_a: list, draw_b: list, corners: torch.Tensor,
                        table: torch.Tensor, n: int, mesh: Mesh,
                        fixed: bool, shift: float = 0.0) -> list:
    """The raw uniform draws (y-sharded (n/2 + 1, n/D, n) blocks) as the
    Hermitian white noise times the transfer function on the
    (n, n/D, n/2 + 1) pencils (``ic_device._noise_to_density_k`` and its
    fixed-amplitude variant, phase-shifted by ``shift``). Only the lower
    planes' y flip and the two self-planes cross between shards."""
    d = len(mesh)
    c = n // d
    middle = n // 2
    if fixed:
        Us = []
        for a in draw_a:
            phase = fourier._f32(2 * np.pi) * a + shift
            Us.append(torch.complex(torch.cos(phase), torch.sin(phase)))
        cvals = torch.ones(7, dtype=C64)
    else:
        Us = []
        for a, b in zip(draw_a, draw_b):
            phase = fourier._f32(2 * np.pi) * b
            amplitude = torch.sqrt(-torch.log(1.0 - a))
            Us.append(torch.complex(amplitude * torch.cos(phase),
                                    amplitude * torch.sin(phase)))
        cvals = torch.sqrt(-torch.log(1.0 - corners)).to(C64)
    self_planes = [pmesh.all_gather([u[i] for u in Us], mesh, 0)
                   for i in (0, middle)]
    lower = _flip_y([u[1:middle] for u in Us], mesh)
    tables = pmesh.replicate(table, mesh)
    out = []
    for r, (u, low) in enumerate(zip(Us, lower)):
        dev = u.device
        s0, sm = (_hermitian_self_plane(p[r])[r * c:(r + 1) * c,
                                              : middle + 1]
                  for p in self_planes)
        kp_half = (-torch.arange(middle + 1, device=dev)) % n
        x = torch.cat((s0[None], u[1:middle, :, : middle + 1], sm[None],
                       torch.conj(low[:, :, kp_half]).flip(0)), dim=0)
        # the zero mode and the 7 corner draws (ic.py's corner fixes, in
        # their order), each on the shard that holds its row
        for i, (ix, iy, iz) in enumerate((
                (0, 0, 0), (0, 0, middle), (0, middle, 0),
                (0, middle, middle), (middle, 0, 0), (middle, 0, middle),
                (middle, middle, 0), (middle, middle, middle))):
            if iy // c == r:
                x[ix, iy % c, iz] = 0 if i == 0 else cvals[i - 1]
        # the transfer multiply: the integer |k|^2 of the local y block
        ki = (torch.arange(n, device=dev) + middle) % n - middle
        ky = (r * c + torch.arange(c, device=dev) + middle) % n - middle
        kz = torch.arange(middle + 1, device=dev)
        k2 = ((ki * ki)[:, None, None] + (ky * ky)[None, :, None]
              + (kz * kz)[None, None, :])
        out.append(x * tables[r][k2])
    return out


def _stage_1lpt(density_k: list, offset: float, dplus_1: float, fH_1: float,
                m: int, mesh: Mesh, cap: int):
    """density_k pencils -> (phi1_k pencils, every shard's lattice columns
    (4, cap): its planes of the lattice, sentinels after them)."""
    phi1_k = slab.inverse_laplacian_slab(density_k, m, 0)
    planes = m // len(mesh)
    n_local = planes * m * m
    h = float(np.float32(1.0 / m))
    dfH = float(np.float32(dplus_1) * np.float32(fH_1))
    position, velocity, coords = [], [], []
    for r, dev in enumerate(mesh):
        pos = torch.full((4, cap), tiled_pm.SENTINEL, dtype=F32, device=dev)
        pos[3] = 0.0
        position.append(pos)
        velocity.append(torch.zeros((4, cap), dtype=F32, device=dev))
        cx = (r * planes + torch.arange(planes, dtype=F32, device=dev)) * h
        cyz = torch.arange(m, dtype=F32, device=dev) * h + offset
        coords.append(((cx + offset).reshape(planes, 1, 1),
                       cyz.reshape(1, m, 1), cyz.reshape(1, 1, m)))
    for a, psis in enumerate(_psi_components_slab(phi1_k, m, mesh)):
        for pos, vel, psi, xyz in zip(position, velocity, psis, coords):
            pos[a, :n_local] = (xyz[a] - dplus_1 * psi).expand(
                planes, m, m).reshape(-1)
            vel[a, :n_local] = (-dfH * psi).reshape(-1)
    return phi1_k, position, velocity


def _rhs_k(term: str, p1: list, p2, m: int, mesh: Mesh) -> list:
    """An LPT source in k space at pencil size m (the padded size when
    dealiasing): the pencils in, rfft3_slab(real source) out."""
    if term == "2":
        rhs = _rhs_2ndorder(p1, m, mesh)
    elif term == "a":
        rhs = _rhs_3a(p1, m, mesh)
    elif term == "b":
        rhs = _rhs_3b(p1, p2, m, mesh)
    else:
        rhs = _rhs_3c(p1, p2, m, mesh, "xyz".index(term[1]))
    return slab.rfft3_slab(rhs, mesh)


def _apply_src(rhs_k: list, position: list, velocity: list, dplus_n: float,
               fH_n: float, m: int, mesh: Mesh) -> list:
    """src_k = invlap(rhs_k), psi = grad(src) added to the shards' columns
    (the tails of ic_device's 2LPT and 3LPT terms). Returns src_k."""
    src_k = slab.inverse_laplacian_slab(rhs_k, m, 0)
    _add_nlpt_cols(position, velocity, src_k, m, mesh,
                   (m // len(mesh)) * m * m, dplus_n, fH_n)
    return src_k


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------

def supported(param, n_dev: int) -> bool:
    """Slab device ICs cover the LPT orders, dealiased or not, on the tiled
    engine, unless ``ic_device`` is false, when the particle lattice splits
    evenly over the mesh: n_p a multiple of 2 D keeps the pencil layout
    valid at n_p and at the padded 3 n_p / 2."""
    ics = param["initial_conditions"]
    if isinstance(ics, (int, np.integer)) and not isinstance(ics, bool):
        return False
    if "lpt" not in str(ics).casefold():
        return False
    if not bool(param.get("ic_device", True)):
        return False
    if str(param.get("particle_engine", "pallas")).casefold() != "pallas":
        return False  # the slab step itself runs the tiled engine only
    n_p = round(float(param["npart"]) ** (1.0 / 3.0))
    return (
        n_p ** 3 == int(param["npart"])
        and n_p % (2 * n_dev) == 0
        and int(param["ncoarse"]) >= 1
        and 2 ** int(param["ncoarse"]) % n_dev == 0
    )


def _sync(mesh: Mesh) -> None:
    for dev in set(mesh):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def generate_lpt_slab(param, tables, mesh: Mesh):
    """Slab-sharded 1/2/3LPT: the per-shard state lists (position,
    velocity, acceleration, phi, u, tile starts) of
    :func:`.slab.distribute_particles`, without the particles ever being
    gathered (the output_00000 snapshot aside, written as by the host path
    unless ``write_initial_snapshot`` is false)."""
    from .. import solver as solver_mod

    t0 = perf_counter()
    n_dev = len(mesh)
    order = str(param["initial_conditions"]).casefold()
    if order not in ("1lpt", "2lpt", "3lpt"):
        raise ValueError(
            f"initial_conditions={order}, should be 1LPT, 2LPT or 3LPT")
    a_start = 1.0 / (1 + param["z_start"])
    lna_start = np.log(a_start)
    logging.warning("z_start=%s (slab device IC path, %d devices)",
                    param["z_start"], n_dev)
    Hz = tables[2](lna_start) * param["unit_t"] / (1e3 * PC_M)

    npart = int(param["npart"])
    n_p = round(npart ** (1.0 / 3.0))
    cap = slab.shard_capacity(npart, n_dev,
                              float(param.get("slab_slack", 1.25)))

    # the host draws the raw variates only, in ic.py's order, and uploads
    # each shard's y block of them
    middle = n_p // 2
    seed = int(param["seed"])
    rng = (np.random.default_rng(seed) if seed >= 0
           else np.random.default_rng())
    table = torch.as_tensor(ic_host.transfer_table(param, n_p))
    shape = (middle + 1, n_p, n_p)

    def draw():
        return pmesh.scatter(torch.as_tensor(rng.random(shape,
                                                        dtype=np.float32)),
                             mesh, 1)

    if bool(param["fixed_ICS"]):
        shift = float(np.float32(np.pi)) if bool(param["paired_ICS"]) else 0.0
        density_k = _noise_to_density_k(draw(), None, None, table, n_p, mesh,
                                        True, shift)
    else:
        amps, phases = draw(), draw()
        corners = torch.as_tensor(rng.random(7, dtype=np.float32))
        density_k = _noise_to_density_k(amps, phases, corners, table, n_p,
                                        mesh, False)
        del amps, phases
    logging.warning("Host RNG draw and upload: %.1f s", perf_counter() - t0)

    dplus_1_z0 = tables[3](0)
    dplus_1 = float(np.float32(tables[3](lna_start) / dplus_1_z0))
    fH_1 = float(np.float32(tables[4](lna_start) * Hz))
    offset = float(np.float32(
        0.5 / n_p if str(param["position_ICS"]).casefold() == "center"
        else 0.0))
    phi1_k, position, velocity = _stage_1lpt(density_k, offset, dplus_1, fH_1,
                                             n_p, mesh, cap)
    del density_k

    if order != "1lpt":
        dealias = bool(param["dealiased_ICS"])
        me = 3 * n_p // 2 if dealias else n_p

        def pad(xks):
            return _pad_pencil(xks, mesh, n_p) if dealias else xks

        def rhs_k(term, rescale, p1, p2=None):
            rk = _rhs_k(term, p1, p2, me, mesh)
            return _trim_pencil(rk, mesh, me, rescale) if dealias else rk

        def coeffs(i, power):
            return (float(np.float32(tables[i](lna_start)
                                     / dplus_1_z0 ** power)),
                    float(np.float32(tables[i + 1](lna_start) * Hz)))

        logging.warning("Compute 2LPT contribution (slab)")
        p1e = pad(phi1_k)
        phi2_k = _apply_src(rhs_k("2", 1.5 ** 3, p1e), position, velocity,
                            *coeffs(5, 2), n_p, mesh)
        if order == "3lpt":
            p2e = pad(phi2_k)
            for term, rescale, i in (("a", 1.5 ** 6, 7), ("b", 1.5 ** 3, 9),
                                     ("cx", 1.5 ** 3, 11),
                                     ("cy", 1.5 ** 3, 11),
                                     ("cz", 1.5 ** 3, 11)):
                logging.warning("Compute 3LPT %s contribution (slab)", term)
                dplus_n, fH_n = coeffs(i, 3)
                _apply_src(rhs_k(term, rescale, p1e, p2e), position,
                           velocity, -dplus_n, fH_n, n_p, mesh)
            del p2e
        del p1e, phi2_k
    del phi1_k

    position = [mesh_ops.periodic_wrap(p) for p in position]
    _sync(mesh)
    TIMES["generate_lpt_slab"] = perf_counter() - t0
    logging.warning("Slab device IC generation: %.1f s",
                    TIMES["generate_lpt_slab"])

    cfg = solver_mod.config_from_param(param)
    if bool(param.get("write_initial_snapshot", True)):
        ic_host.finalise_initial_conditions(
            *slab.gather_particles(position, velocity), param)
        logging.warning("Slab device IC + snapshot write: %.1f s",
                        perf_counter() - t0)

    # the rest of distribute_particles' state: zeros (the run loop's first
    # sorted step migrates the stragglers and builds the tile starts)
    m = cfg.ncells_1d
    planes = m // n_dev
    u_shape = ((planes, m, m) if cfg.theory in ("fr", "mond")
               else (1, 1, 1))
    nt_local = tiled_pm.n_tiles(m, None, planes) + 1
    return (position, velocity,
            [torch.zeros((4, cap), dtype=F32, device=dev) for dev in mesh],
            [torch.zeros((planes, m, m), dtype=F32, device=dev)
             for dev in mesh],
            [torch.zeros(u_shape, dtype=F32, device=dev) for dev in mesh],
            [torch.zeros(nt_local, dtype=torch.int32, device=dev)
             for dev in mesh])
