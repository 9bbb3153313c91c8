"""CSR transpose on the CSR's device — O(nnz log nnz).

Counterpart of ``basic_sparse_matrix_tpu/ops/transpose.py``: expand row ids,
stable-argsort by column id (stability keeps the row order within a column,
so the result is sorted CSC, i.e. the transposed CSR), and rebuild
``indptr`` with a bincount and a cumulative sum.
"""

from __future__ import annotations

import torch

from .csr import CSR


def transpose(a: CSR) -> CSR:
    rows = a.row_ids()
    perm = torch.argsort(a.indices, stable=True)
    counts = torch.bincount(a.indices.long(), minlength=a.cols)
    indptr = torch.zeros(a.cols + 1, dtype=torch.int32, device=a.device)
    indptr[1:] = torch.cumsum(counts, 0).to(torch.int32)
    return CSR(indptr=indptr, indices=rows[perm], values=a.values[perm],
               rows=a.cols, cols=a.rows)
