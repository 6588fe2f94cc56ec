"""Device mesh and collectives of the multi-device run modes: what
``jax.sharding.Mesh`` and the ``lax`` collectives give ``pysco_tpu/parallel``.

The port is single-controller, as the JAX package is: one Python process
drives every device. A **mesh** is an ordered tuple of ``torch.device``s, one
per shard, **in which the same device may appear more than once** (the
counterpart of XLA's forced host device count): ``[cuda:0, cuda:1, ...]`` is
the production layout, where the shards' work overlaps because CUDA launches
are asynchronous; ``[cuda:0] * 4`` runs the whole sharded machinery on one
card, the shards taking turns; ``[cpu] * 4`` runs it in the tests. A sharded
array is a Python list with one tensor per shard, each on its shard's device,
and a collective is a plain function over such lists that moves every piece
to the device of the shard that receives it.

Every copy between devices that the package makes on its own goes through
this module -- the collectives, and :func:`scatter`, :func:`replicate` and
:func:`gather`, which place a state on the mesh and bring it back -- so
backing them with NCCL changes this file only.
Results that land on one device may share storage (a reduction's result is
copied once per device, not once per shard): a caller does not write into a
collective's result in place.

Reductions add in the fixed shard order 0, 1, ..., D-1, whatever the devices:
a rerun, and a run on another layout of the same D, give the same bits.
"""

from __future__ import annotations

from typing import Sequence

import torch

Mesh = tuple  # of torch.device, one per shard


def make_mesh(n_devices: int | None = None, devices=None,
              device="cuda") -> Mesh:
    """The mesh of a run: ``devices`` as given (anything ``torch.device``
    takes; repeats allowed), else every visible card, or the CPU alone when
    ``device`` is the CPU; cut to the first ``n_devices`` if given."""
    if devices is None:
        if torch.device(device).type == "cpu":
            devices = ["cpu"]
        else:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "make_mesh: torch sees no CUDA device; pass devices= "
                    "(or device='cpu') to build a CPU mesh")
            devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    mesh = tuple(torch.device(d) for d in devices)
    if n_devices:
        if n_devices > len(mesh):
            raise ValueError(f"make_mesh: {n_devices} devices asked, "
                             f"{len(mesh)} given")
        mesh = mesh[:n_devices]
    if not mesh:
        raise ValueError("make_mesh: an empty mesh")
    return mesh


def shardwise(fn, *lists) -> list:
    """``fn`` applied shard by shard to the sharded arrays ``lists``."""
    return [fn(*args) for args in zip(*lists)]


def _check(xs: Sequence[torch.Tensor], mesh: Mesh) -> None:
    if len(xs) != len(mesh):
        raise ValueError(f"{len(xs)} shards on a mesh of {len(mesh)}")


def ppermute_fwd(xs: Sequence[torch.Tensor], mesh: Mesh) -> list:
    """Shard i's tensor goes to shard (i + 1) % D: the result's entry r is
    what its left neighbour sent."""
    _check(xs, mesh)
    d = len(mesh)
    return [xs[(r - 1) % d].to(mesh[r]) for r in range(d)]


def ppermute_bwd(xs: Sequence[torch.Tensor], mesh: Mesh) -> list:
    """Shard i's tensor goes to shard (i - 1) % D: the result's entry r is
    what its right neighbour sent."""
    _check(xs, mesh)
    d = len(mesh)
    return [xs[(r + 1) % d].to(mesh[r]) for r in range(d)]


def ppermute(xs: Sequence[torch.Tensor], perm, mesh: Mesh) -> list:
    """``lax.ppermute``: for every pair (i, j) of ``perm``, shard i's tensor
    goes to shard j; a shard that no pair names receives zeros."""
    _check(xs, mesh)
    out = [torch.zeros_like(x, device=dev) for x, dev in zip(xs, mesh)]
    for src, dst in perm:
        out[dst] = xs[src].to(mesh[dst])
    return out


def all_gather(xs: Sequence[torch.Tensor], mesh: Mesh, axis: int) -> list:
    """Tiled ``lax.all_gather``: the shards' tensors joined in shard order
    along ``axis``, one copy per device of the mesh (shared by its
    shards)."""
    _check(xs, mesh)
    return replicate(gather(xs, axis, mesh[0]), mesh)


def move_rows(xs: Sequence[torch.Tensor], mesh: Mesh, axis: int,
              rows_out: int, moves) -> list:
    """A block move between two cuts of one axis over the mesh.

    Shard r of ``xs`` holds the global rows [r c, (r + 1) c) of ``axis``;
    shard r of the result holds the rows [r rows_out, (r + 1) rows_out) of
    a new global axis, zero except where ``moves`` fills it: each move
    (src, dst, count) copies the global input rows [src, src + count) to
    the global output rows [dst, dst + count). Every piece goes straight
    from the shard that holds it to the shard that receives it, so no
    shard ever holds more than its own cut."""
    _check(xs, mesh)
    c = xs[0].shape[axis]
    out = []
    for t, dev in enumerate(mesh):
        shape = list(xs[0].shape)
        shape[axis] = rows_out
        out.append(torch.zeros(shape, dtype=xs[0].dtype, device=dev))
    for src, dst, count in moves:
        for s, x in enumerate(xs):
            lo, hi = max(src, s * c), min(src + count, (s + 1) * c)
            if lo >= hi:
                continue
            for t in range(len(mesh)):
                # the output rows of shard t that this piece lands on
                d_lo = max(dst + lo - src, t * rows_out)
                d_hi = min(dst + hi - src, (t + 1) * rows_out)
                if d_lo >= d_hi:
                    continue
                piece = x.narrow(axis, d_lo - dst + src - s * c, d_hi - d_lo)
                out[t].narrow(axis, d_lo - t * rows_out,
                              d_hi - d_lo).copy_(piece)
    return out


def all_to_all(xs: Sequence[torch.Tensor], mesh: Mesh, split_axis: int,
               concat_axis: int) -> list:
    """Tiled all-to-all (``lax.all_to_all(..., tiled=True)``): every shard's
    tensor is cut into D equal pieces along ``split_axis``; shard r receives
    piece r of every shard and joins them, in shard order, along
    ``concat_axis``."""
    _check(xs, mesh)
    d = len(mesh)
    pieces = [torch.chunk(x, d, dim=split_axis) for x in xs]
    if any(len(p) != d for p in pieces):
        raise ValueError(f"all_to_all: axis {split_axis} does not split into "
                         f"{d} pieces")
    return [torch.cat([pieces[i][r].to(mesh[r]) for i in range(d)],
                      dim=concat_axis) for r in range(d)]


def replicate(total: torch.Tensor, mesh: Mesh) -> list:
    """One copy of ``total`` per device of the mesh, shared by its shards."""
    copies = {}
    for dev in mesh:
        if dev not in copies:
            copies[dev] = total.to(dev)
    return [copies[dev] for dev in mesh]


def scatter(a: torch.Tensor, mesh: Mesh, axis: int) -> list:
    """``a`` cut into D equal pieces along ``axis``, piece r on shard r's
    device."""
    d = len(mesh)
    if a.shape[axis] % d:
        raise ValueError(f"scatter: axis {axis} of {tuple(a.shape)} does not "
                         f"split over {d} shards")
    return [piece.to(dev).contiguous()
            for piece, dev in zip(torch.chunk(a, d, dim=axis), mesh)]


def gather(xs: Sequence[torch.Tensor], axis: int, device=None) -> torch.Tensor:
    """The shards' tensors joined in shard order along ``axis`` on
    ``device`` (default: shard 0's)."""
    device = xs[0].device if device is None else device
    return torch.cat([x.to(device) for x in xs], dim=axis)


def psum(xs: Sequence[torch.Tensor], mesh: Mesh) -> list:
    """Sum over the shards, added in shard order 0, 1, ..., D-1 on shard
    0's device, and handed to every shard."""
    _check(xs, mesh)
    total = xs[0]
    for x in xs[1:]:
        total = total + x.to(mesh[0])
    return replicate(total, mesh)


def pmax(xs: Sequence[torch.Tensor], mesh: Mesh) -> list:
    """Maximum over the shards, handed to every shard."""
    _check(xs, mesh)
    total = xs[0]
    for x in xs[1:]:
        total = torch.maximum(total, x.to(mesh[0]))
    return replicate(total, mesh)


def pmean(xs: Sequence[torch.Tensor], mesh: Mesh) -> list:
    """Mean over the shards (the shard-order sum over D)."""
    return [t / len(mesh) for t in psum(xs, mesh)]
