"""Triangular solves (forward / backward substitution) on dense operands.

Counterpart of ``basic_sparse_matrix_tpu/models/triangular.py`` and of the
reference's ``forward_substitution`` / ``backward_substitution``: the
factor is densified and solved with ``torch.linalg.solve_triangular`` in
float32, all right-hand-side columns at once. The level-scheduled sparse
solve lives in ``sparse_triangular.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.csr import CSR
from ..ops.dense import Dense
from ..utils.errors import IncorrectDimensions, check


def solve_triangular_dense(l: torch.Tensor, b: torch.Tensor,
                           lower: bool) -> torch.Tensor:
    return torch.linalg.solve_triangular(l.float(), b.float(),
                                         upper=not lower)


def _as_array(b, device=None) -> torch.Tensor:
    """A right-hand side as a 2-D tensor on ``device`` (default: where it
    already is, or the CPU for host data); a vector becomes one column."""
    if isinstance(b, Dense):
        b = b.array
    if not isinstance(b, torch.Tensor):
        b = torch.as_tensor(np.asarray(b))
    if device is not None:
        b = b.to(device)
    return b[:, None] if b.ndim == 1 else b


def forward_substitution(l: CSR, b) -> torch.Tensor:
    """Solve ``L y = b`` (L lower-triangular); multi-RHS batched."""
    rhs = _as_array(b, l.device)
    check(rhs.shape[0] == l.rows, IncorrectDimensions,
          f"forward_substitution: {l.dims} vs rhs {tuple(rhs.shape)}")
    return solve_triangular_dense(l.todense(), rhs, True)


def backward_substitution(u: CSR, y) -> torch.Tensor:
    """Solve ``U x = y`` (U upper-triangular)."""
    rhs = _as_array(y, u.device)
    check(rhs.shape[0] == u.rows, IncorrectDimensions,
          f"backward_substitution: {u.dims} vs rhs {tuple(rhs.shape)}")
    return solve_triangular_dense(u.todense(), rhs, False)
