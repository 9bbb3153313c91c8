"""The reference's precisions: float64, and TF32 for the control.

TF32 keeps float32's exponent and 10 of its 23 mantissa bits; a tensor core
rounds each operand of a product to it and accumulates in float32.
:func:`tf32` rounds a tensor to it (to nearest, ties to even), so the
control computes with the operands a TF32 product would see.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch


def tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` as float32 rounded to TF32's 10 mantissa bits."""
    bits = t.to(torch.float32).contiguous().view(torch.int32)
    bits = (bits + (0x0FFF + ((bits >> 13) & 1))) & -0x2000
    return bits.view(torch.float32)


@dataclasses.dataclass(frozen=True)
class Precision:
    name: str
    dtype: torch.dtype
    # Applied to every operand of a product.
    rnd: Callable[[torch.Tensor], torch.Tensor]

    def cast(self, t: torch.Tensor) -> torch.Tensor:
        return self.rnd(t.to(self.dtype))


FLOAT64 = Precision("float64", torch.float64, lambda t: t)
TF32 = Precision("tf32", torch.float32, tf32)
