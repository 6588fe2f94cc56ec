"""Morton (Z-order) indexing: encode/decode and tesseral arithmetic
(PyTorch port of ``pysco_tpu/ops/morton.py``).

21 bits per axis interleaved into 63-bit keys (x << 2 | y << 1 | z at
every bit triple) by magic-number spreads, elementwise over particle
arrays. The keys are **int64**, where the JAX module's are uint64: 3 x 21
bits fit non-negative in an int64, and torch's uint64 lacks shifts and
masks on the CPU. The bit patterns are the same; a sum that would carry
out of bit 63 in uint64 wraps the same way in int64 (the increment adds a
positive unit to a negative value, the decrement subtracts one from a
non-negative value, so neither overflows). The scatter engine's
reordering (``mesh.morton_keys``) takes its keys from
:func:`positions_to_keys`.
"""

from __future__ import annotations

import torch

I64 = torch.int64
BITS = 21
_MASKS_SPREAD = (
    (32, 0x1F00000000FFFF),
    (16, 0x1F0000FF0000FF),
    (8, 0x100F00F00F00F00F),
    (4, 0x10C30C30C30C30C3),
    (2, 0x1249249249249249),
)

# per-axis dilated masks for tesseral arithmetic: key bits of axis a are
# at positions 3*i + (2 - a) given the (x<<2 | y<<1 | z) interleave
_X_MASK = 0x4924924924924924
_Y_MASK = 0x2492492492492492
_Z_MASK = 0x1249249249249249


def spread_bits(v: torch.Tensor) -> torch.Tensor:
    """Dilate the low 21 bits so they occupy every third bit."""
    x = v.to(I64) & 0x1FFFFF
    for shift, mask in _MASKS_SPREAD:
        x = (x | (x << shift)) & mask
    return x


def compact_bits(v: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`spread_bits`."""
    x = v.to(I64) & 0x1249249249249249
    x = (x ^ (x >> 2)) & 0x10C30C30C30C30C3
    x = (x ^ (x >> 4)) & 0x100F00F00F00F00F
    x = (x ^ (x >> 8)) & 0x1F0000FF0000FF
    x = (x ^ (x >> 16)) & 0x1F00000000FFFF
    x = (x ^ (x >> 32)) & 0x1FFFFF
    return x


def encode(i: torch.Tensor, j: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Interleave three 21-bit integer coordinates into a Morton key."""
    return (spread_bits(i) << 2) | (spread_bits(j) << 1) | spread_bits(k)


def decode(key: torch.Tensor):
    """Recover (i, j, k) from Morton keys (int64 each; the JAX module
    returns uint32)."""
    key = key.to(I64)
    return compact_bits(key >> 2), compact_bits(key >> 1), compact_bits(key)


def positions_to_keys(position: torch.Tensor) -> torch.Tensor:
    """Morton keys from (n, 3) positions in [0, 1) at 21 bits per axis."""
    scaled = torch.clamp(
        (position.to(torch.float32) * float(2 ** BITS)).to(I64),
        0, 2 ** BITS - 1)
    return encode(scaled[:, 0], scaled[:, 1], scaled[:, 2])


def keys_to_positions(keys: torch.Tensor) -> torch.Tensor:
    """Cell-centre positions from Morton keys (inverse of
    :func:`positions_to_keys` up to quantisation)."""
    inv = 0.5 ** BITS
    return torch.stack([(c.to(torch.float32) + 0.5) * inv
                        for c in decode(keys)], dim=1)


def _axis_add(key: torch.Tensor, delta_key: int, mask: int) -> torch.Tensor:
    """Tesseral add along one axis: add within the dilated axis bits."""
    key = key.to(I64)
    inv = ~mask  # every mask is below 2^63: ~mask is its int64 complement
    return ((key | inv) + (delta_key & mask)) & mask | (key & inv)


def _level_unit(axis: int, level: int) -> int:
    """Dilated '1' for the given axis at a coarse level (cells of size
    2^level quantisation units)."""
    return 1 << (3 * level + (2 - axis))


def increment(key: torch.Tensor, axis: int, level: int = 0) -> torch.Tensor:
    """Move to the +1 neighbour along an axis at the given level (periodic
    in 21 bits)."""
    mask = (_X_MASK, _Y_MASK, _Z_MASK)[axis]
    return _axis_add(key, _level_unit(axis, level), mask)


def decrement(key: torch.Tensor, axis: int, level: int = 0) -> torch.Tensor:
    """Move to the -1 neighbour along an axis at the given level."""
    mask = (_X_MASK, _Y_MASK, _Z_MASK)[axis]
    key = key.to(I64)
    inv = ~mask
    # subtract within dilated bits: (key & mask) - unit, borrow-safe
    return ((key & mask) - _level_unit(axis, level)) & mask | (key & inv)
