"""The arithmetic the reference runs in.

The reference computes in float64. Its control, the same code in the
nearest precision below the configuration's float32, keeps every array
in bfloat16: each step's result is rounded to bfloat16, the step itself
runs in float32 (torch's FFT has no bfloat16 form).
"""

from __future__ import annotations

import torch


class Precision:
    def __init__(self, name: str):
        if name not in ("float64", "bfloat16"):
            raise ValueError(f"precision {name!r}: float64 or bfloat16")
        self.name = name
        self.real = torch.float64 if name == "float64" else torch.float32
        self.complex = (torch.complex128 if name == "float64"
                        else torch.complex64)

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """Round an intermediate result to the storage precision."""
        if self.name == "float64":
            return x
        if x.is_complex():
            return torch.complex(x.real.to(torch.bfloat16).float(),
                                 x.imag.to(torch.bfloat16).float())
        if x.is_floating_point():
            return x.to(torch.bfloat16).float()
        return x

    def t(self, x: torch.Tensor) -> torch.Tensor:
        """A floating-point input in this precision."""
        return self.q(x.to(self.real))


F64 = Precision("float64")
BF16 = Precision("bfloat16")
