"""The direct solve's reference: a dense Cholesky factor of the operator.

The float64 reference factors the dense matrix the stencil gives and
solves with it. The control rounds the factor, the right-hand sides and the
intermediate to TF32 and solves in float32: a factor computed or kept in
TF32.
"""

from __future__ import annotations

import torch

from . import stencil
from .precision import Precision


class DenseCholesky:
    """The dense factor of the operator, made once and solved with many
    times."""

    def __init__(self, config: dict, device):
        a = stencil.dense(config, device)
        self.l = torch.linalg.cholesky(a)
        del a

    def solve(self, b: torch.Tensor, prec: Precision) -> torch.Tensor:
        """``A⁻¹ b`` for ``b`` (n, m), in ``prec``."""
        if prec.dtype == torch.float64:
            return torch.cholesky_solve(b.to(torch.float64), self.l)
        l = prec.cast(self.l)
        y = torch.linalg.solve_triangular(l, prec.cast(b), upper=False)
        x = torch.linalg.solve_triangular(l.mT, prec.cast(y), upper=True)
        return prec.rnd(x)
