"""Dense (scatter-free) particle-mesh transfer: the ``particle_engine =
dense`` engine (PyTorch port of ``pysco_tpu/ops/dense_pm.py``).

Particles are sorted by their base x-plane (:func:`sort_by_plane`, the
velocity riding along), and every plane's transfer is dense algebra over
banded one-hot weight matrices of a static capacity ``cap`` of rows:

    deposit:  rho[a, y, z] = sum_p Wx[p,a] Wy[p,y] Wz[p,z]
              == (Wx (x) Wy)^T @ Wz
    gather:   f[p] = sum_{a,y,z} Wx Wy Wz F[a,y,z]
              == rows of (Wx (x) Wy) @ F_window, then a z contraction

with Wx (cap, W) over the W support planes and Wy, Wz (cap, M). A plane's
particles are the rows ``plane_starts[i]:plane_starts[i] + cap`` of the
sorted state padded with ``cap`` sentinel rows (x = 2.0); rows of another
plane are masked out, and particles past the capacity are counted
(``overflow``), not transferred. The deposit's plane outputs land on
planes i..i+W-1 and are combined by rolls in one fixed order.

The contractions are ``torch.bmm`` in IEEE float32 (the JAX module's
``Precision.HIGHEST``): the float32 matmul precision of CUDA and oneDNN
is set to ``"ieee"`` for the call and restored after it, so a global TF32
(or, on the CPU, bf16) setting never reaches them. G planes go through one
``bmm`` (:func:`_group`), and the deposit cuts each plane's long sum
over its rows into pieces batched in the same ``bmm`` (:func:`_pieces`),
added by one sum after it: a plane's output is only W M x M, too few
tiles to fill the card over a K of ``cap``. Both counts come from the
shapes alone, so two calls on the same inputs give the same bits;
nothing is summed with atomics. The engine has no hand-written kernel:
the JAX module has no ``pallas_call`` either. Its FLOPs grow as M^5 --
it is there for parity with the JAX package, never a default.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch

from .tiled_pm import _WIDTH, _axis_weights, _base_axis

F32 = torch.float32
I32 = torch.int32
I64 = torch.int64

# bytes of one group's largest operand: the gather's (G, cap, M C) product
_GROUP_BYTES = 1 << 30
# least rows of a piece of the deposit's sum over a plane's particles
_PIECE_ROWS = 8192


def _capacity(npart: int, ncells_1d: int) -> int:
    """Static per-plane particle capacity: 2x the mean plane count plus
    slack, at most ``npart``, rounded up to 256 rows."""
    cap = int(2.0 * npart / ncells_1d) + 256
    cap = min(cap, npart)
    return ((cap + 255) // 256) * 256


def _group(m: int, row_bytes: int, cap: int) -> int:
    """Planes per ``bmm``: as many as keep one operand of ``cap`` rows of
    ``row_bytes`` each under ``_GROUP_BYTES``, cut to a divisor of m so
    that every ``bmm`` has the same shape."""
    g = max(1, min(_GROUP_BYTES // max(cap * row_bytes, 1), m))
    while m % g:
        g -= 1
    return g


def _pieces(cap: int) -> int:
    """Pieces the deposit's sum over a plane's ``cap`` rows is cut into:
    the largest power of two up to 256 (``cap`` is a multiple of 256)
    that leaves each piece ``_PIECE_ROWS`` rows or more."""
    s = 1
    while s < 256 and cap // (2 * s) >= _PIECE_ROWS:
        s *= 2
    return s


@contextmanager
def _ieee_fp32():
    """IEEE float32 matmuls for the block (CUDA's and oneDNN's), the
    caller's settings after it. The per-backend flags are set and restored
    as they are, so a TF32 or bf16 setting made by either of torch's two
    APIs comes back unchanged."""
    flags = (torch.backends.cuda.matmul, torch.backends.mkldnn.matmul)
    prev = [f.fp32_precision for f in flags]
    try:
        for f in flags:
            f.fp32_precision = "ieee"
        yield
    finally:
        for f, p in zip(flags, prev):
            f.fp32_precision = p


def sort_by_plane(position: torch.Tensor, ncells_1d: int, scheme: str,
                  *payload):
    """Sort (npart, 3) particles by base x-plane; returns (position,
    *payload, plane_starts), ``plane_starts`` int32 of length M + 1. One
    stable sort of the plane key, then one permutation of each array (the
    JAX module's multi-operand sort, whose order within a plane may
    differ)."""
    scheme = scheme.casefold()
    m = ncells_1d
    key = _base_axis(scheme, position[:, 0] * float(m)) % m
    skey, order = torch.sort(key, stable=True)
    planes = torch.arange(m + 1, dtype=skey.dtype, device=skey.device)
    starts = torch.searchsorted(skey, planes, side="left").to(I32)
    return (position.index_select(0, order),
            *(a.index_select(0, order) for a in payload), starts)


def _banded_onehot(base: torch.Tensor, weights, ncells_1d: int):
    """(..., cap, M) matrix with weights[o] at column (base + o) mod M."""
    lanes = torch.arange(ncells_1d, device=base.device)
    out = None
    for o, w in enumerate(weights):
        col = ((base + o) % ncells_1d).unsqueeze(-1)
        term = torch.where(lanes == col, w.unsqueeze(-1), 0.0)
        out = term if out is None else out + term
    return out


def _plane_weights(pos_pad: torch.Tensor, starts: torch.Tensor,
                   planes: torch.Tensor, cap: int, ncells_1d: int,
                   scheme: str):
    """Weights of the planes ``planes`` (G,): Wx (G, cap, W) masked by
    plane validity and the banded Wy, Wz (G, cap, M). A row is valid when
    its base plane is the plane, or the one periodic wrap (a CIC base of
    -1); the sentinel rows never are."""
    m = ncells_1d
    rows = starts[planes].to(I64).unsqueeze(1) + torch.arange(
        cap, device=pos_pad.device)
    xs = pos_pad[rows] * float(m)  # (G, cap, 3)
    bases = [_base_axis(scheme, xs[..., a]) for a in range(3)]
    p = planes.to(I64).unsqueeze(1)
    valid = (bases[0] == p) | (bases[0] == p - m)
    vmask = valid.to(F32)
    wx = torch.stack([w * vmask for w in
                      _axis_weights(scheme, xs[..., 0], bases[0])], dim=-1)
    wy = _banded_onehot(bases[1], _axis_weights(scheme, xs[..., 1],
                                                bases[1]), m)
    wz = _banded_onehot(bases[2], _axis_weights(scheme, xs[..., 2],
                                                bases[2]), m)
    return wx, wy, wz


def _padded(position_sorted: torch.Tensor, cap: int) -> torch.Tensor:
    """The sorted rows followed by ``cap`` sentinel rows (x = 2.0)."""
    pad = torch.full((cap, 3), 2.0, dtype=F32, device=position_sorted.device)
    return torch.cat([position_sorted, pad])


def deposit(position_sorted: torch.Tensor, plane_starts: torch.Tensor,
            ncells_1d: int, scheme: str):
    """Deposit plane-sorted particles; returns (counts grid (M, M, M),
    overflow): ``overflow`` is the number of particles past their plane's
    capacity (a 0-d int64 tensor; they deposit nothing)."""
    scheme = scheme.casefold()
    m = ncells_1d
    width = _WIDTH[scheme]
    npart = position_sorted.shape[0]
    cap = _capacity(npart, m)
    pos_pad = _padded(position_sorted, cap)
    dev = pos_pad.device
    g = _group(m, 4 * width * m, cap)
    s = _pieces(cap)
    planes = torch.empty((m, width * m, m), dtype=F32, device=dev)
    with _ieee_fp32():
        for i0 in range(0, m, g):
            idx = torch.arange(i0, i0 + g, device=dev)
            wx, wy, wz = _plane_weights(pos_pad, plane_starts, idx, cap, m,
                                        scheme)
            a = (wx.unsqueeze(-1) * wy.unsqueeze(-2)).reshape(
                g, cap, width * m)
            del wx, wy
            part = torch.bmm(
                a.view(g * s, cap // s, width * m).transpose(1, 2),
                wz.view(g * s, cap // s, m))
            planes[i0:i0 + g] = part.view(g, s, width * m, m).sum(dim=1)
    planes = planes.view(m, width, m, m)
    # planes[i, o] contributes to grid plane (i + o) mod M
    grid = planes[:, 0].clone()
    for o in range(1, width):
        grid += torch.roll(planes[:, o], o, dims=0)
    counts = (plane_starts[1:] - plane_starts[:-1]).to(I64)
    overflow = torch.sum(torch.clamp(counts - cap, min=0))
    return grid, overflow


def gather_vec(field: torch.Tensor, position_sorted: torch.Tensor,
               plane_starts: torch.Tensor, scheme: str) -> torch.Tensor:
    """Interpolate a vector field (M, M, M, C) at plane-sorted particles;
    returns (npart, C) in the sorted order. A particle past its plane's
    capacity gets 0."""
    scheme = scheme.casefold()
    m = field.shape[0]
    ncomp = field.shape[-1]
    width = _WIDTH[scheme]
    npart = position_sorted.shape[0]
    cap = _capacity(npart, m)
    pos_pad = _padded(position_sorted, cap)
    dev = pos_pad.device
    # x-plane halo: plane i's window is planes i..i+W-1, periodic
    f_ext = torch.cat([field, field[: width - 1]]) if width > 1 else field
    g = _group(m, 4 * m * ncomp, cap)
    vals = torch.empty((m, cap, ncomp), dtype=F32, device=dev)
    with _ieee_fp32():
        for i0 in range(0, m, g):
            idx = torch.arange(i0, i0 + g, device=dev)
            wx, wy, wz = _plane_weights(pos_pad, plane_starts, idx, cap, m,
                                        scheme)
            a = (wx.unsqueeze(-1) * wy.unsqueeze(-2)).reshape(
                g, cap, width * m)
            del wx, wy
            window = torch.stack([f_ext[i:i + width] for i in
                                  range(i0, i0 + g)]).reshape(
                g, width * m, m * ncomp)
            t = torch.bmm(a, window).view(g, cap, m, ncomp)
            del a, window
            vals[i0:i0 + g] = torch.sum(wz.unsqueeze(-1) * t, dim=2)
    # each particle's value is the row of its own plane, at offset
    # p - plane_starts[plane] (the JAX merge by plane validity)
    p = torch.arange(npart, dtype=I32, device=dev)
    plane = torch.searchsorted(plane_starts[1:].contiguous(), p, right=True)
    off = p - plane_starts[plane]
    out = vals[plane, off.clamp(max=cap - 1)]
    return torch.where((off < cap).unsqueeze(1), out, 0.0)
