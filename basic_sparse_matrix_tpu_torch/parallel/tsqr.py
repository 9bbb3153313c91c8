"""Distributed TSQR (communication-avoiding tall-skinny QR).

Counterpart of ``basic_sparse_matrix_tpu/parallel/tsqr.py``: each rank
factors its row block (``torch.linalg.qr``), the ``(n, n)`` R factors ride
one untiled all-gather, every rank factors the stacked ``(num·n, n)``
matrix redundantly, and the local Q is corrected by the rank's ``(n, n)``
slice of that Q, in float32 with TF32 off. Communication: ``num · n²``
floats, independent of m.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..ops.csr import CSR
from ..utils.config import matmul_precision
from ..utils.errors import IncorrectDimensions, check
from .mesh import ROWS
from .sharded import held_rows


def tsqr_sharded(a, mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reduced QR of a tall ``(m, n)`` operand, rows split over ``"rows"``
    (padded with zero rows to a multiple of the axis). Returns (the held
    rows of Q, all ``m`` on a local mesh; R ``(n, n)``, replicated). ``a``
    may be a dense tensor or array, or a CSR (densified: Q is dense
    anyway)."""
    comm = mesh.axis(ROWS)
    arr = a.todense() if isinstance(a, CSR) else a
    arr = torch.as_tensor(arr, dtype=torch.float32, device=mesh.device)
    m, n = arr.shape
    num = comm.size
    check(m >= n * num, IncorrectDimensions,
          f"tsqr_sharded needs rows >= cols*devices, got {tuple(arr.shape)} "
          f"on {num} shards")
    arr = F.pad(arr, (0, 0, 0, (-m) % num))
    mps = arr.shape[0] // num
    with matmul_precision():
        qrs = [torch.linalg.qr(arr[s * mps: (s + 1) * mps])
               for s in comm.local]
        stacks = comm.all_gather([r for _, r in qrs], tiled=False)
        qs = []
        for s, (ql, _), rs in zip(comm.local, qrs, stacks):
            q2, r = torch.linalg.qr(rs.reshape(num * n, n))
            qs.append(ql @ q2[s * n: (s + 1) * n])
    return held_rows(qs, comm.local, mps, rows=m), r
