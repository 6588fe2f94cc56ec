"""Tile-binned particle-mesh transfer: deposit and gather on tile-sorted
column particles (the PyTorch/CUDA counterpart of
``pysco_tpu/ops/pallas_pm.py``, which it replaces).

Particle state is the JAX package's **column layout** ``(4, N_up)``:
x/y/z rows plus a zero spare row, ``N_up = round_up(npart, Q)``, tail
columns holding the sentinel position 2.0 and zero velocity. One stable
sort per force evaluation bins particles by tile -- one x-plane, an
8-row y-block and, from 512^3 up, a 128-cell z-block -- and
``tile_starts[t]:tile_starts[t+1]`` are tile t's columns. The geometry
(``YB``, the z-block rule, the 8-rounded y window) is the JAX package's,
so tile keys, ``tile_starts`` and the set of particles a window accepts
are the same in both packages.

``drift = k >= 1`` is the lazy re-binning mode: the sort is stale and
every window is widened by k cells on each side, so a particle that
moved less than k cells since the sort still lands exactly;
:func:`drift_violations` counts the ones that did not.

The two transfers are hand-written CUDA kernels (``csrc/deposit.cu``,
``csrc/gather.cu``), each with a plain PyTorch twin beside it
(:func:`deposit_plain`, :func:`gather_vec_cl_plain`) of the same
signature and masking. :func:`deposit` and :func:`gather_vec_cl` take the
twin for a CPU tensor and launch the kernel for a CUDA tensor; there is
no fallback from one to the other. ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from ..utils import profiling

F32 = torch.float32
I32 = torch.int32
I64 = torch.int64

YB = 8  # y-block rows per tile
Q = 512  # column padding quantum
SENTINEL = 2.0  # tail-column x position
SENTINEL_MIN = 1.5
_WIDTH = {"ngp": 1, "cic": 2, "tsc": 3}

# kernel launches by the CUDA wrappers (one per wrapper call), the slab call
# forms under their own names; the CPU twins do not count
LAUNCHES = {"deposit": 0, "gather": 0, "deposit_slab": 0, "gather_slab": 0}

# the JAX package's sort_mode values; one route here (sort_particles)
SORT_MODES = ("full", "nearly", "index", "nearly_index")

# dynamic shared memory a block may opt into on Hopper (H100/H200)
_SMEM_LIMIT = 232448
# csrc/deposit.cu: its threads a block, the particles staged per pass (2 a
# thread), and the bytes kept for its block sort and for its prefix sum
_DEPOSIT_THREADS = 256
_DEPOSIT_CHUNK = 512
_DEPOSIT_SORT_SCRATCH = 12288
_DEPOSIT_SCAN_SCRATCH = 64
# its program counters (read under a profiler only): the chunks summed,
# and those in which one thread's adds exceeded 4 times the mean a thread
DEPOSIT_COUNTERS = ("deposit_chunks", "deposit_chunks_unbalanced")
_GATHER_VEC = 4  # csrc/gather.cu: z cells of its 16-byte copies


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# Weights (pysco_tpu/ops/dense_pm.py:52-101)
# ---------------------------------------------------------------------------

def _base_axis(scheme: str, xs: torch.Tensor) -> torch.Tensor:
    """Base cell of the support window along one axis (xs = position*M):
    NGP/TSC anchor on the occupied cell (TSC one below), CIC on
    floor(xs - 1/2)."""
    if scheme == "cic":
        return torch.floor(xs - 0.5).to(I64)
    base = torch.floor(xs).to(I64)
    return base - 1 if scheme == "tsc" else base


def _axis_weights(scheme: str, xs: torch.Tensor, base: torch.Tensor):
    """Weights over the W support cells (offsets 0..W-1 from base)."""
    if scheme == "tsc":
        d = xs - 0.5 - (base + 1).to(F32)
        return 0.5 * (0.5 - d) ** 2, 0.75 - d * d, 0.5 * (0.5 + d) ** 2
    if scheme == "cic":
        frac = xs - 0.5 - base.to(F32)
        return 1.0 - frac, frac
    if scheme == "ngp":
        return (torch.ones_like(xs),)
    raise NotImplementedError(scheme)


# ---------------------------------------------------------------------------
# Geometry and column state
# ---------------------------------------------------------------------------

def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _zb_size(ncells_1d: int, zbs: int | None = None) -> int:
    """z-block size: ``zbs`` if given (tests force small blocks), else the
    JAX package's rule -- 128 from 512^3 up, the full z extent below."""
    if zbs is not None:
        zbs = min(int(zbs), ncells_1d)
        if zbs <= 0 or ncells_1d % zbs:
            raise ValueError(f"zbs={zbs} must divide ncells_1d={ncells_1d}")
        return zbs
    if ncells_1d >= 512 and ncells_1d % 128 == 0:
        return 128
    return ncells_1d


class Geometry(NamedTuple):
    w: int  # support width (NGP 1, CIC 2, TSC 3)
    wx: int  # window x extent, w + 2*drift
    wy_pad: int  # window y extent, YB + w - 1 + 2*drift rounded up to 8
    wz_pad: int  # window z extent of a z-blocked tile (JAX's 128-rounding)
    nby: int
    nbz: int
    zbs: int
    ntiles: int
    n_planes: int  # local x extent: the grid's on one device, a slab's else

    @property
    def wz(self) -> int:
        """z extent of a window: the full periodic z line when tiles span
        z (nbz == 1), else the z-blocked extent."""
        return self.wz_pad if self.nbz > 1 else self.zbs

    def padded_shape(self, m: int):
        """Shape of the grid the windows are added into, before the fold:
        index i holds grid index (i - drift) along y (and z when
        z-blocked) and plane (plane0 + i - drift) along x."""
        gz = m if self.nbz == 1 else m + self.wz_pad - self.zbs
        return (self.n_planes + self.wx - 1, m + self.wy_pad - YB, gz)

    @property
    def live_window(self):
        """(x, y, z) extent of the cells a tile's particles reach while
        each keeps its drift bound: w + 2 drift planes, YB + w - 1 + 2 drift
        rows, and the z line or zbs + w - 1 + 2 drift cells. The deposit
        kernel keeps these in shared memory; the rest of the padded window
        (the 8- and 128-rounding) only a particle past its bound reaches."""
        z = self.zbs if self.nbz == 1 else self.zbs + self.wx - 1
        return (self.wx, YB + self.wx - 1, z)


def _geometry(ncells_1d: int, scheme: str, drift: int = 0,
              zbs: int | None = None,
              n_planes: int | None = None) -> Geometry:
    """Tile and window geometry (``pallas_pm._geometry``). ``n_planes`` is
    the local x extent: the whole grid's on a single device (the default),
    the slab's height under sharding."""
    m = ncells_1d
    if m % YB:
        raise ValueError(f"ncells_1d={m} must be a multiple of {YB}")
    if n_planes is None:
        n_planes = m
    w = _WIDTH[scheme]
    zbs = _zb_size(m, zbs)
    nbz = m // zbs
    if nbz == 1:
        wz_pad = _round_up(m, 128)
    else:
        wz_pad = _round_up(zbs + w - 1 + 2 * drift, 128)
    return Geometry(
        w=w, wx=w + 2 * drift, wy_pad=_round_up(YB + w - 1 + 2 * drift, 8),
        wz_pad=wz_pad, nby=m // YB, nbz=nbz, zbs=zbs,
        ntiles=n_planes * (m // YB) * nbz, n_planes=n_planes,
    )


def n_tiles(ncells_1d: int, zbs: int | None = None,
            n_planes: int | None = None) -> int:
    """Tile count of a grid, or of a slab of ``n_planes`` x-planes
    (``tile_starts`` has n_tiles + 1 entries)."""
    zbs = _zb_size(ncells_1d, zbs)
    if n_planes is None:
        n_planes = ncells_1d
    return n_planes * (ncells_1d // YB) * (ncells_1d // zbs)


def padded_cols(npart: int) -> int:
    """Column count of the particle state arrays."""
    return _round_up(npart, Q)


def to_columns_host(position, velocity, npart: int):
    """(npart, 3) row particles -> (4, N_up) column state, in NumPy."""
    n_up = padded_cols(npart)
    pos = np.full((4, n_up), SENTINEL, np.float32)
    pos[:3, :npart] = np.asarray(position, np.float32).T
    pos[3] = 0.0
    vel = np.zeros((4, n_up), np.float32)
    vel[:3, :npart] = np.asarray(velocity, np.float32).T
    return pos, vel


def to_columns(position: torch.Tensor, velocity: torch.Tensor, npart: int):
    """(npart, 3) row particles -> (4, N_up) column state, on their device."""
    n_up = padded_cols(npart)
    dev = position.device
    pos = torch.full((4, n_up), SENTINEL, dtype=F32, device=dev)
    pos[:3, :npart] = position.to(F32).T
    pos[3] = 0.0
    vel = torch.zeros((4, n_up), dtype=F32, device=dev)
    vel[:3, :npart] = velocity.to(F32).T
    return pos, vel


# ---------------------------------------------------------------------------
# Tile sort
# ---------------------------------------------------------------------------

def tile_keys(position: torch.Tensor, ncells_1d: int, scheme: str,
              zbs: int | None = None, plane0: int = 0,
              n_planes: int | None = None) -> torch.Tensor:
    """(N_up,) int64 tile id per column; sentinel columns key past the
    last tile. Under slab sharding ``plane0`` and ``n_planes`` select the
    local x-plane range: the tile id is slab-local, and a particle whose
    base plane lies outside the slab keys past the end too, so a foreign
    particle is dropped by the sort, not misbinned."""
    m = ncells_1d
    scheme = scheme.casefold()
    g = _geometry(m, scheme, 0, zbs, n_planes)
    p_loc = _base_axis(scheme, position[0] * float(m)) % m - int(plane0)
    py = (_base_axis(scheme, position[1] * float(m)) % m) // YB
    key = p_loc * g.nby + py
    if g.nbz > 1:
        pz = (_base_axis(scheme, position[2] * float(m)) % m) // g.zbs
        key = key * g.nbz + pz
    bad = ((position[0] >= SENTINEL_MIN) | (p_loc < 0)
           | (p_loc >= g.n_planes))
    return torch.where(bad, torch.full_like(key, g.ntiles), key)


def sort_particles(position: torch.Tensor, velocity: torch.Tensor,
                   ncells_1d: int, scheme: str, zbs: int | None = None,
                   plane0: int = 0, n_planes: int | None = None,
                   mode: str = "full"):
    """Tile-sort the column state; returns (pos, vel, tile_starts).

    One stable sort of the tile key, then one permutation of each state
    array (row 3 stays zero). ``tile_starts`` (int32, ntiles + 1) is the
    same as the JAX package's; the order within a tile may differ, since
    ``lax.sort`` there is not stable. ``plane0`` and ``n_planes`` sort a
    slab's columns into its own tiles (:func:`tile_keys`): sentinels and
    foreign particles end up past ``tile_starts[-1]``.

    ``mode`` is the JAX package's ``sort_mode``; every one of the four
    takes the one stable sort and permutation here, so all four give
    bitwise the same result. Torch has no multi-operand sort, so JAX's
    ``full`` form is its ``index`` form, and the ``nearly`` forms' two
    rounds of block sorts lost to the one sort on the H100 (see
    ROADMAP.md, "Not ported"); an unknown mode is a ``ValueError``.
    """
    if mode not in SORT_MODES:
        raise ValueError(f"sort_mode={mode!r}, should be one of {SORT_MODES}")
    scheme = scheme.casefold()
    g = _geometry(ncells_1d, scheme, 0, zbs, n_planes)
    key = tile_keys(position, ncells_1d, scheme, zbs, plane0, n_planes)
    skey, order = torch.sort(key, stable=True)
    tiles = torch.arange(g.ntiles + 1, dtype=skey.dtype, device=skey.device)
    starts = torch.searchsorted(skey, tiles, side="left").to(I32)
    return (position.index_select(1, order),
            velocity.index_select(1, order), starts)


def _tile_of_columns(tile_starts: torch.Tensor, n_up: int) -> torch.Tensor:
    """Tile of every column (tile t owns [starts[t], starts[t+1]));
    columns past the last tile get ntiles."""
    cols = torch.arange(n_up, dtype=I32, device=tile_starts.device)
    return torch.searchsorted(tile_starts[1:].contiguous(), cols, right=True)


def _window_offset(base: torch.Tensor, origin, m: int, drift: int):
    """Drift-widened window offset of a base cell from its tile's first
    cell: the modular offset mapped to [-drift, m - drift), plus drift."""
    raw = (base - origin + 2 * m) % m
    return torch.where(raw >= m - drift, raw - m, raw) + drift


def drift_violations(position_sorted: torch.Tensor, tile_starts: torch.Tensor,
                     ncells_1d: int, scheme: str, drift: int,
                     zbs: int | None = None, plane0: int = 0,
                     n_planes: int | None = None) -> torch.Tensor:
    """Count particles outside their stale tile's widened window.

    A particle whose base moved past the window deposits (part of) its
    mass nowhere and gathers (part of) no force in the JAX kernels; the
    host-side CFL bound prevents it and this counter detects a broken
    bound. Same envelope as ``pallas_pm.drift_violations``: x offset in
    [-drift, drift], y offset within the 8-rounded window, z within the
    z-blocked window. On a slab the tile's plane is ``plane0`` plus its
    slab-local one.
    """
    m = ncells_1d
    scheme = scheme.casefold()
    g = _geometry(m, scheme, drift, zbs, n_planes)
    n_up = position_sorted.shape[1]
    tile = _tile_of_columns(tile_starts, n_up).to(I64)
    plane = tile // (g.nby * g.nbz) + int(plane0)
    yb = (tile // g.nbz) % g.nby
    bx = _base_axis(scheme, position_sorted[0] * float(m)) % m
    by = _base_axis(scheme, position_sorted[1] * float(m)) % m
    dx = (bx - plane + m + drift) % m
    dy = (by - yb * YB + m + drift) % m
    real = (position_sorted[0] < SENTINEL_MIN) & (tile < g.ntiles)
    bad = (dx > 2 * drift) | (dy > g.wy_pad - g.w)
    if g.nbz > 1:
        bz = _base_axis(scheme, position_sorted[2] * float(m)) % m
        dz = (bz - (tile % g.nbz) * g.zbs + m + drift) % m
        bad = bad | (dz > g.wz_pad - g.w)
    return torch.sum(real & bad)


# ---------------------------------------------------------------------------
# Deposit
# ---------------------------------------------------------------------------

def _fold_axis(arr: torch.Tensor, axis: int, m: int,
               lead: int = 0) -> torch.Tensor:
    """Fold pad cells periodically: index i of ``arr`` holds grid index
    (i - lead); the leading ``lead`` cells wrap onto the top, cells
    beyond lead + m wrap onto the bottom (``pallas_pm._fold_axis``)."""
    size = arr.shape[axis]
    head = arr.narrow(axis, lead, m).clone()
    if lead:
        head.narrow(axis, m - lead, lead).add_(arr.narrow(axis, 0, lead))
    off = lead + m
    while off < size:
        hi = min(off + m, size)
        head.narrow(axis, 0, hi - off).add_(arr.narrow(axis, off, hi - off))
        off = hi
    return head


def _padded_sums_plain(position_sorted, tile_starts, m: int, scheme: str,
                       drift: int, g: Geometry,
                       plane0: int = 0) -> torch.Tensor:
    """Twin of the deposit kernel before the fold: every particle's
    weights added into its tile's window cells of the padded grid, with
    the kernel's window masking, by ``index_add_``."""
    dev = position_sorted.device
    shape = g.padded_shape(m)
    gx, gy, gz = shape
    n_up = position_sorted.shape[1]
    tile = _tile_of_columns(tile_starts, n_up)
    real = (position_sorted[0] < SENTINEL_MIN) & (tile < g.ntiles)
    cols = torch.nonzero(real).squeeze(1)
    t = tile[cols].to(I64)
    plane = t // (g.nby * g.nbz)  # slab-local
    yb = (t // g.nbz) % g.nby
    zb = t % g.nbz
    xs = position_sorted[:3, cols] * float(m)
    bx, by, bz = (_base_axis(scheme, xs[i]) for i in range(3))
    wx = _axis_weights(scheme, xs[0], bx)
    wy = _axis_weights(scheme, xs[1], by)
    wz = _axis_weights(scheme, xs[2], bz)
    if drift:
        dx = _window_offset(bx, plane + int(plane0), m, drift)
        yl = _window_offset(by, yb * YB, m, drift)
    else:
        dx = torch.zeros_like(bx)  # fresh sort: the base plane is the tile's
        yl = by % m - yb * YB
    zw = bz % m
    if g.nbz > 1:
        zl = (_window_offset(zw, zb * g.zbs, m, drift) if drift
              else zw - zb * g.zbs)
    gp = torch.zeros(gx * gy * gz, dtype=F32, device=dev)
    for a in range(g.w):
        xa = dx + a
        ok_x = xa < g.wx
        for oy in range(g.w):
            ya = yl + oy
            ok_xy = ok_x & (ya >= 0) & (ya < g.wy_pad)
            wxy = wx[a] * wy[oy]
            for oz in range(g.w):
                if g.nbz == 1:
                    zg = (zw + oz) % m
                    ok = ok_xy
                else:
                    za = zl + oz
                    zg = zb * g.zbs + za
                    ok = ok_xy & (za >= 0) & (za < g.wz_pad)
                idx = ((plane + xa) * gy + yb * YB + ya) * gz + zg
                gp.index_add_(0, idx[ok], (wxy * wz[oz])[ok])
    return gp.reshape(shape)


@lru_cache(maxsize=None)
def _kernels():
    """The compiled kernel library with its C signatures (built at first
    use from ``csrc/``)."""
    from . import cuda_build

    lib = cuda_build.load()
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.pysco_deposit.argtypes = [P, L, P, P, I, I, I, I, I, I, I, I, I, P,
                                  P]
    lib.pysco_deposit.restype = I
    lib.pysco_deposit_smem.argtypes = [I, I, I, I, I, I, I]
    lib.pysco_deposit_smem.restype = L
    lib.pysco_gather.argtypes = [P, I, P, L, P, I, P, I, I, I, I, I, I, I, I,
                                 I, P]
    lib.pysco_gather.restype = I
    lib.pysco_gather_smem.argtypes = [I, I, I, I, I, I]
    lib.pysco_gather_smem.restype = L
    return lib


def _check_cuda(name: str, t: torch.Tensor, dtype, shape=None) -> None:
    if not t.is_cuda or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous CUDA {dtype} "
                         f"tensor, got {t.dtype} on {t.device}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {shape}, got "
                         f"{tuple(t.shape)}")


def _raise_on(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} kernel failed: CUDA error {err}")


def _deposit_bins(g: Geometry) -> int:
    """The deposit kernel's bins: a particle's base cell (zl, yl) in the
    live window, each from 1 - w (zl over the z line when it is the
    window), as far as a cell of the window reaches; key ``nbins`` holds
    the particles with no live cell."""
    wx, wy, wz = g.live_window
    nzb = wz if g.nbz == 1 else wz + g.w - 1
    return nzb * (wy + g.w - 1)


def _deposit_smem(g: Geometry) -> int:
    """Dynamic shared memory of a deposit block in bytes, as
    ``csrc/deposit.cu`` lays it out: the sort scratch, or after the sort
    the sorted particles, the counter's warp sums, the prefix sum's
    scratch, the visits before each thread's lines, the heavy columns, the
    bin starts and, in one place, the sorted keys or the threads' partial
    line sums; then the live window, and 3 w weights a staged particle."""
    wx, wy, wz = g.live_window
    threads = _DEPOSIT_THREADS
    head = (4 * _DEPOSIT_CHUNK + 4 * 2 * (threads // 32)
            + _DEPOSIT_SCAN_SCRATCH + _round_up(4 * (threads + 1), 16)
            + 2 * threads)
    starts = _round_up(2 * (_deposit_bins(g) + 1), 16)
    shared = max(4 * threads * wx, 2 * _DEPOSIT_CHUNK)
    scratch = _round_up(max(_DEPOSIT_SORT_SCRATCH, head + starts + shared), 16)
    return scratch + 4 * wx * wy * wz + 4 * _DEPOSIT_CHUNK * 3 * g.w


def _check_deposit_smem(g: Geometry, m: int, scheme: str, drift: int) -> None:
    """Raise before a launch the card would refuse. (A window that fits
    has fewer bins than the kernel's 16-bit keys hold.)"""
    smem = _deposit_smem(g)
    if smem > _SMEM_LIMIT:
        raise ValueError(
            f"deposit window of {smem} B exceeds the {_SMEM_LIMIT} B of "
            f"shared memory a block can use (m={m}, {scheme}, drift={drift})"
        )


def _padded_sums_cuda(position_sorted, tile_starts, m: int, scheme: str,
                      drift: int, g: Geometry, plane0: int = 0,
                      count: str = "deposit") -> torch.Tensor:
    """Launch the deposit kernel (csrc/deposit.cu) into a zeroed padded
    grid, counted under ``count``."""
    n_up = position_sorted.shape[1]
    _check_cuda("position_sorted", position_sorted, F32, (4, n_up))
    _check_cuda("tile_starts", tile_starts, I32, (g.ntiles + 1,))
    _check_deposit_smem(g, m, scheme, drift)
    gp = torch.zeros(g.padded_shape(m), dtype=F32,
                     device=position_sorted.device)
    counts = profiling.device_counters(DEPOSIT_COUNTERS, gp.device)
    with torch.cuda.device(gp.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernels().pysco_deposit(
            position_sorted.data_ptr(), n_up, tile_starts.data_ptr(),
            gp.data_ptr(), m, g.w, drift, g.wy_pad, g.wz, g.zbs, g.nbz,
            g.n_planes, int(plane0),
            None if counts is None else counts.data_ptr(), stream,
        )
    _raise_on(err, "deposit")
    LAUNCHES[count] += 1
    return gp


def _check_slab(m: int, g: Geometry, drift: int, plane0: int) -> None:
    """A slab lies inside the grid and is at least as tall as the
    drift-widened window reaches beyond a plane (``w - 1 + drift``), so a
    spill plane goes to a direct neighbour."""
    if not (0 <= plane0 and plane0 + g.n_planes <= m):
        raise ValueError(f"slab planes [{plane0}, {plane0 + g.n_planes}) "
                         f"lie outside the grid of {m}")
    if g.n_planes < g.w - 1 + drift:
        raise ValueError(f"a slab of {g.n_planes} planes is thinner than "
                         f"the window's reach w - 1 + drift = "
                         f"{g.w - 1 + drift}")


def _fold_yz(gp: torch.Tensor, m: int, drift: int,
             g: Geometry) -> torch.Tensor:
    """Fold the y pads and, when z-blocked, the z pads of the padded window
    sums (the JAX package's order: y, then z; x last, by the caller)."""
    gp = _fold_axis(gp, 1, m, lead=drift)
    if g.nbz > 1:
        gp = _fold_axis(gp, 2, m, lead=drift)
    return gp


def deposit_slab_plain(position_sorted: torch.Tensor,
                       tile_starts: torch.Tensor, ncells_1d: int, scheme: str,
                       drift: int = 0, zbs: int | None = None,
                       plane0: int = 0,
                       n_planes: int | None = None) -> torch.Tensor:
    """Plain PyTorch twin of :func:`deposit_slab` (any device)."""
    scheme = scheme.casefold()
    g = _geometry(ncells_1d, scheme, drift, zbs, n_planes)
    _check_slab(ncells_1d, g, drift, plane0)
    gp = _padded_sums_plain(position_sorted, tile_starts, ncells_1d, scheme,
                            drift, g, plane0)
    return _fold_yz(gp, ncells_1d, drift, g)


def _deposit_slab(count: str, position_sorted, tile_starts, ncells_1d: int,
                  scheme: str, drift: int, zbs, plane0: int, n_planes):
    """The slab deposit behind both public forms: the twin for CPU tensors,
    the kernel (counted under ``count``) for CUDA ones."""
    dev = position_sorted.device.type
    if dev == "cpu":
        return deposit_slab_plain(position_sorted, tile_starts, ncells_1d,
                                  scheme, drift, zbs, plane0, n_planes)
    if dev != "cuda":
        raise ValueError(f"deposit: no kernel for device {dev!r}")
    scheme = scheme.casefold()
    g = _geometry(ncells_1d, scheme, drift, zbs, n_planes)
    _check_slab(ncells_1d, g, drift, plane0)
    gp = _padded_sums_cuda(position_sorted, tile_starts, ncells_1d, scheme,
                           drift, g, plane0, count)
    return _fold_yz(gp, ncells_1d, drift, g)


def deposit_slab(position_sorted: torch.Tensor, tile_starts: torch.Tensor,
                 ncells_1d: int, scheme: str, drift: int = 0,
                 zbs: int | None = None, plane0: int = 0,
                 n_planes: int | None = None) -> torch.Tensor:
    """Deposit tile-sorted column particles onto the local x-slab of
    ``n_planes`` planes from global plane ``plane0`` on
    (``pallas_pm.deposit_slab``).

    Returns the y-folded, z-folded slab (n_planes + w - 1 + 2 drift, M, M)
    whose x index i holds grid plane (plane0 + i - drift): the leading
    ``drift`` planes spill onto the left neighbour and the trailing
    w - 1 + drift onto the right (``parallel/slab.add_spill``; the periodic
    wrap on a single device, which :func:`deposit` folds). ``tile_starts``
    holds the slab's own tiles (:func:`sort_particles` with the same
    ``plane0`` and ``n_planes``).
    """
    return _deposit_slab("deposit_slab", position_sorted, tile_starts,
                         ncells_1d, scheme, drift, zbs, plane0, n_planes)


def deposit_plain(position_sorted: torch.Tensor, tile_starts: torch.Tensor,
                  ncells_1d: int, scheme: str, drift: int = 0,
                  zbs: int | None = None) -> torch.Tensor:
    """Plain PyTorch twin of :func:`deposit` (any device)."""
    return _fold_axis(
        deposit_slab_plain(position_sorted, tile_starts, ncells_1d, scheme,
                           drift, zbs), 0, ncells_1d, lead=drift)


def deposit(position_sorted: torch.Tensor, tile_starts: torch.Tensor,
            ncells_1d: int, scheme: str, drift: int = 0,
            zbs: int | None = None) -> torch.Tensor:
    """Deposit tile-sorted column particles; returns the (M, M, M) counts
    grid: the slab form over the whole grid, its x spill folded
    periodically. ``drift`` widens the windows for lazy re-binning (stale
    sort); ``zbs`` overrides the z-block size (tests only)."""
    return _fold_axis(
        _deposit_slab("deposit", position_sorted, tile_starts, ncells_1d,
                      scheme, drift, zbs, 0, None), 0, ncells_1d, lead=drift)


# ---------------------------------------------------------------------------
# Gather
# ---------------------------------------------------------------------------

def _gather_plain(field_cl: torch.Tensor, position_sorted: torch.Tensor,
                  tile_starts: torch.Tensor, scheme: str,
                  x_cell) -> torch.Tensor:
    """The w^3-point sum in the kernel's order, by advanced indexing.
    ``x_cell(base_x, a)`` gives the field's x index of support cell a and
    whether the field holds it (None: always)."""
    w = _WIDTH[scheme]
    ncomp, m = field_cl.shape[0], field_cl.shape[-1]
    nx = field_cl.shape[1]
    n_up = position_sorted.shape[1]
    col = torch.arange(n_up, device=position_sorted.device)
    valid = ((col >= tile_starts[0]) & (col < tile_starts[-1])
             & (position_sorted[0] < SENTINEL_MIN))
    cols = torch.nonzero(valid).squeeze(1)
    xs = position_sorted[:3, cols] * float(m)
    base = [_base_axis(scheme, xs[i]) for i in range(3)]
    wts = [_axis_weights(scheme, xs[i], base[i]) for i in range(3)]
    flat = field_cl.reshape(ncomp, -1)
    acc = torch.zeros((ncomp, cols.shape[0]), dtype=F32,
                      device=field_cl.device)
    for a in range(w):
        ix, ok = x_cell(base[0], a)
        if ok is not None:
            ix = torch.clamp(ix, 0, nx - 1)
        for oy in range(w):
            iy = (base[1] + oy) % m
            wxy = wts[0][a] * wts[1][oy]
            for oz in range(w):
                iz = (base[2] + oz) % m
                vals = flat[:, (ix * m + iy) * m + iz]
                if ok is not None:
                    vals = torch.where(ok, vals, torch.zeros_like(vals))
                acc = acc + vals * (wxy * wts[2][oz])
    out = torch.zeros((4, n_up), dtype=F32, device=field_cl.device)
    out[:ncomp, cols] = acc
    return out


def gather_vec_cl_plain(field_cl: torch.Tensor, position_sorted: torch.Tensor,
                        tile_starts: torch.Tensor, scheme: str,
                        drift: int = 0) -> torch.Tensor:
    """Plain PyTorch twin of :func:`gather_vec_cl` (any device)."""
    del drift  # the full periodic field is read: no window to widen
    m = field_cl.shape[1]
    return _gather_plain(field_cl, position_sorted, tile_starts,
                         scheme.casefold(),
                         lambda bx, a: ((bx + a) % m, None))


def gather_vec_slab_plain(field_ext_cl: torch.Tensor,
                          position_sorted: torch.Tensor,
                          tile_starts: torch.Tensor, scheme: str,
                          drift: int = 0, plane0: int = 0) -> torch.Tensor:
    """Plain PyTorch twin of :func:`gather_vec_slab` (any device): support
    cell a of a particle reads extended plane
    ``offset(base_x, plane0) + drift + a`` (the offset mapped to
    [-drift, M - drift)), and counts 0 where the extended field ends."""
    m = field_ext_cl.shape[-1]
    nx = field_ext_cl.shape[1]

    def x_cell(bx, a):
        ix = _window_offset(bx % m, int(plane0), m, drift) + a
        return ix, ix < nx

    return _gather_plain(field_ext_cl, position_sorted, tile_starts,
                         scheme.casefold(), x_cell)


def _gather_smem(g: Geometry, ncomp: int) -> int:
    """Dynamic shared memory of a gather block in bytes, as
    ``csrc/gather.cu`` lays it out: the live window's x-planes, each
    ``ncomp`` components x its y rows x its z cells in whole 16-byte
    groups (the periodic z line with its first group repeated after its
    end; a z-blocked row with room for the 3 cells of the group before the
    window's first cell)."""
    wx, wy, wz = g.live_window
    if g.nbz == 1:
        wz += _GATHER_VEC
    else:
        wz = _round_up(wz + _GATHER_VEC - 1, _GATHER_VEC)
    return 4 * wx * ncomp * wy * wz


def _gather_stage(g: Geometry, ncomp: int, m: int, scheme: str,
                  drift: int) -> int:
    """Components a gather block stages a pass: all of them when their
    windows fit a block's shared memory, else one. Raises before a launch
    the card would refuse (one component beyond a block's shared
    memory)."""
    if _gather_smem(g, ncomp) <= _SMEM_LIMIT:
        return ncomp
    smem = _gather_smem(g, 1)
    if smem > _SMEM_LIMIT:
        raise ValueError(
            f"gather window of {smem} B exceeds the {_SMEM_LIMIT} B of "
            f"shared memory a block can use (m={m}, {scheme}, drift={drift})"
        )
    return 1


def _gather_cuda(field_cl, position_sorted, tile_starts, drift: int,
                 g: Geometry, ncs: int, plane0: int = 0,
                 slab: bool = False) -> torch.Tensor:
    """Launch the gather kernel (csrc/gather.cu), ``ncs`` (1 or all)
    components staged a pass, over the periodic field or (``slab``) the
    x-extended field of the slab that starts at global plane ``plane0``."""
    ncomp, m = field_cl.shape[0], field_cl.shape[-1]
    n_up = position_sorted.shape[1]
    out = torch.empty((4, n_up), dtype=F32, device=field_cl.device)
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernels().pysco_gather(
            field_cl.data_ptr(), ncomp, position_sorted.data_ptr(), n_up,
            tile_starts.data_ptr(), g.ntiles, out.data_ptr(), m, g.w, drift,
            g.zbs, g.nbz, ncs, g.n_planes, int(plane0), int(slab), stream,
        )
    _raise_on(err, "gather")
    return out


def _gather(name: str, field_cl, position_sorted, tile_starts, scheme: str,
            drift: int, g: Geometry, plane0: int, slab: bool, twin):
    """Checks and dispatch shared by the two gather forms: the twin for a
    CPU field, the kernel for a CUDA one."""
    ncomp, m = field_cl.shape[0], field_cl.shape[-1]
    if tuple(tile_starts.shape) != (g.ntiles + 1,):
        raise ValueError(f"tile_starts: expected shape {(g.ntiles + 1,)} "
                         f"for m={m}, zbs={g.zbs}, n_planes={g.n_planes}; "
                         f"got {tuple(tile_starts.shape)}")
    dev = field_cl.device.type
    if dev == "cpu":
        return twin()
    if dev != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev!r}")
    n_up = position_sorted.shape[1]
    if not 1 <= ncomp <= 4:
        raise ValueError(f"{name}: 1 to 4 components, got {ncomp}")
    nx = g.n_planes + g.wx - 1 if slab else m
    _check_cuda("field_cl", field_cl, F32, (ncomp, nx, m, m))
    _check_cuda("position_sorted", position_sorted, F32, (4, n_up))
    _check_cuda("tile_starts", tile_starts, I32, (g.ntiles + 1,))
    if field_cl.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel needs a 16-byte aligned field")
    ncs = _gather_stage(g, ncomp, m, scheme, drift)
    out = _gather_cuda(field_cl, position_sorted, tile_starts, drift, g, ncs,
                       plane0, slab)
    LAUNCHES["gather_slab" if slab else "gather"] += 1
    return out


def gather_vec_cl(field_cl: torch.Tensor, position_sorted: torch.Tensor,
                  tile_starts: torch.Tensor, scheme: str,
                  drift: int = 0, zbs: int | None = None) -> torch.Tensor:
    """Interpolate a component-leading field (C, M, M, M) at tile-sorted
    columns; returns (4, N_up) with rows C..3 and the columns outside
    every tile (the sentinel tail) zero. ``drift`` widens the windows the
    kernel stages for a stale sort (as :func:`deposit`'s); ``zbs``
    overrides the z-block size of the tiles (tests only), and
    ``tile_starts`` must hold one entry more than that geometry's tiles.

    The result is the twin's, which reads the whole periodic field: a
    particle past its drift window is still interpolated at its position.
    There the JAX kernel returns 0 (or a partial sum); a run aborts on such
    a step (:func:`drift_violations`). On the card the field must be
    16-byte aligned (the kernel copies it in 16-byte groups).
    """
    scheme = scheme.casefold()
    g = _geometry(field_cl.shape[1], scheme, drift, zbs)
    return _gather(
        "gather_vec_cl", field_cl, position_sorted, tile_starts, scheme,
        drift, g, 0, False,
        lambda: gather_vec_cl_plain(field_cl, position_sorted, tile_starts,
                                    scheme, drift))


def gather_vec_slab(field_ext_cl: torch.Tensor,
                    position_sorted: torch.Tensor, tile_starts: torch.Tensor,
                    scheme: str, drift: int = 0, zbs: int | None = None,
                    plane0: int = 0) -> torch.Tensor:
    """Interpolate a slab's x-extended field at its tile-sorted columns
    (``pallas_pm.gather_vec_slab``).

    ``field_ext_cl`` is component-leading, (C, n_planes + w - 1 + 2 drift,
    M, M), where the JAX function takes the components last: the slab's
    planes plus ``drift`` halo planes of the left neighbour and
    w - 1 + drift of the right, so extended index i holds grid plane
    plane0 + i - drift; y and z are the full periodic axes. Returns
    (4, N_up) with rows C..3 and the columns outside every tile zero.
    ``tile_starts`` holds the slab's own tiles.

    The result is the twin's: a support cell beyond the extended field (the
    particle broke its drift bound in x; :func:`drift_violations` counts it
    and the run aborts) counts 0, as in the JAX kernel; past its window in
    y or z a particle is still interpolated at its position. On the card
    the field must be 16-byte aligned.
    """
    scheme = scheme.casefold()
    m = field_ext_cl.shape[-1]
    n_planes = field_ext_cl.shape[1] - (_WIDTH[scheme] - 1 + 2 * drift)
    g = _geometry(m, scheme, drift, zbs, n_planes)
    _check_slab(m, g, drift, plane0)
    return _gather(
        "gather_vec_slab", field_ext_cl, position_sorted, tile_starts,
        scheme, drift, g, plane0, True,
        lambda: gather_vec_slab_plain(field_ext_cl, position_sorted,
                                      tile_starts, scheme, drift, plane0))
