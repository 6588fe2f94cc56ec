"""The card's peaks and the bytes each hand-written kernel must move.

Peak: NVIDIA's H100 SXM data sheet, 3.35 TB/s of HBM3 (the card's power
limit is reported beside every run). A kernel's least time is its bytes
over that rate, counting each input byte read once and each output byte
written once; none of these kernels is bound by its float32 operations
at 67 TFLOP/s.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32 = 4


def deposit_bytes(npart: int, n: int) -> int:
    """csrc/deposit.cu, one call: the x, y, z rows of every particle in,
    the n^3 float32 density out."""
    return 3 * F32 * npart + F32 * n ** 3


def gather_bytes(npart: int, n: int) -> int:
    """csrc/gather.cu, one call: the three force components of the n^3
    grid and the particles' x, y, z in, three acceleration rows out."""
    return 3 * F32 * npart + 3 * F32 * n ** 3 + 3 * F32 * npart


def scalaron_sweep_bytes(n: int, plane_coef: bool = False) -> int:
    """csrc/scalaron_sweep.cu, one colour of one sweep on the packed
    (n, n/2, n) half-lattices: the other colour, this colour and h^2 b in
    (and the coefficient plane on the coarse levels of FAS), this colour
    out."""
    half = F32 * n ** 3 // 2
    return (5 if plane_coef else 4) * half


def roofline_pct(calls: int, bytes_per_call: int, seconds: float):
    """Share of the least time in the measured time, percent; None when
    the kernel did not run."""
    if not calls or seconds <= 0:
        return None
    return 100.0 * calls * bytes_per_call / HBM_BYTES_PER_S / seconds
