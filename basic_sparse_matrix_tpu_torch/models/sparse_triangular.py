"""Level-set-parallel sparse triangular solve, in a ragged layout.

Counterpart of ``basic_sparse_matrix_tpu/models/sparse_triangular.py``:
the same level sets (``runtime/symbolic.level_sets``: rows of one level
depend only on earlier levels) and the same arithmetic per row,
``x[i] = (b[i] - sum_j L[i, j] x[j]) / L[i, i]``.

The JAX package pads every level to the largest level's row count and
every row to the longest row (``(nlev, max_rows, max_deps)`` tables). That
product grows far faster than the factor: at n = 35,937 (the 33³
Laplacian under nested dissection) it is 3639 × 3398 × 4716 entries, some
233 GB for the forward solve alone. Here each level is stored ragged: its
rows, and the off-diagonal entries of those rows as flat ``(cols, vals)``
with each entry's row slot inside the level (``seg``). The solve runs on
the unknowns permuted into level order, so a level's rows are one
contiguous slice and a level is four operations: one gather, one
multiply, one ``index_add_`` into that slice, then the diagonal scale
(the solve is bound by the launches of these small operations). The
tables take O(nnz + n) bytes and are built with vectorised numpy.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.csr import CSR, to_tensor
from ..runtime import symbolic
from ..utils.errors import IncorrectDimensions, NonSquareMatrix, check


@dataclasses.dataclass(eq=False)
class TriangularSchedule:
    """Ragged solve schedule for one triangular CSR matrix.

    Level ``l`` solves rows ``rows[row_ptr[l]:row_ptr[l+1]]`` (ascending)
    with the off-diagonal entries ``cols/vals[ent_ptr[l]:ent_ptr[l+1]]``;
    ``cols`` are positions in level order (``rows[cols[e]]`` is the
    column), ``seg`` gives each entry's row slot inside its level and
    ``inv_diag`` each row's reciprocal diagonal (in level order)."""

    rows: torch.Tensor      # (n,) int64, rows in level order
    inv_diag: torch.Tensor  # (n,) float32
    cols: torch.Tensor      # (nnz_off,) int64, level-order positions
    vals: torch.Tensor      # (nnz_off,) float32
    seg: torch.Tensor       # (nnz_off,) int64
    row_ptr: Tuple[int, ...]
    ent_ptr: Tuple[int, ...]
    n: int
    lower: bool

    @property
    def n_levels(self) -> int:
        return len(self.row_ptr) - 1

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (
            self.rows, self.inv_diag, self.cols, self.vals, self.seg))


def _mirror(n: int, indptr, indices, values):
    """Upper-triangular CSR → the lower-triangular CSR of the same system on
    reversed indices (row i → n-1-i, col j → n-1-j)."""
    rows = np.repeat(np.arange(n), np.diff(indptr))
    m_rows, m_cols = n - 1 - rows, n - 1 - indices
    order = np.lexsort((m_cols, m_rows))
    m_rows, m_cols, m_vals = m_rows[order], m_cols[order], values[order]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr[1:], m_rows, 1)
    return np.cumsum(indptr), m_cols, m_vals


def build_schedule(l: CSR, *, lower: bool = True) -> TriangularSchedule:
    """Host analysis: level sets and the ragged per-level tables, placed on
    ``l``'s device."""
    check(l.rows == l.cols, NonSquareMatrix, "triangular solve needs square")
    n = l.rows
    indptr, indices, values = l.numpy()
    indices = indices.astype(np.int64)
    if not lower:
        indptr, indices, values = _mirror(n, indptr, indices, values)

    level, nlev = symbolic.level_sets(n, indptr, indices)
    erow = np.repeat(np.arange(n), np.diff(indptr))
    diag = indices == erow
    ndiag = np.bincount(erow[diag], minlength=n)
    dval = np.zeros(n, dtype=np.float64)
    dval[erow[diag]] = values[diag]
    bad = np.nonzero((ndiag != 1) | (dval == 0))[0]
    check(bad.size == 0, IncorrectDimensions,
          f"missing/zero diagonal at row {int(bad[0]) if bad.size else -1}")

    # Rows sorted by level, ascending within a level (the JAX package's
    # nonzero(level == lv) order).
    order = np.argsort(level, kind="stable")
    counts = np.bincount(level, minlength=nlev)
    row_ptr = np.concatenate([[0], np.cumsum(counts)])
    slot_of = np.empty(n, dtype=np.int64)
    slot_of[order] = np.arange(n)
    # Off-diagonal entries, grouped by level, in row-then-storage order.
    off = ~diag
    orow = erow[off]
    eorder = np.argsort(slot_of[orow], kind="stable")
    orow = orow[eorder]
    ecount = np.bincount(level[orow], minlength=nlev)
    ent_ptr = np.concatenate([[0], np.cumsum(ecount)])
    seg = slot_of[orow] - row_ptr[level[orow]]
    dev = l.device
    return TriangularSchedule(
        rows=to_tensor(order.astype(np.int64), dev),
        inv_diag=to_tensor((1.0 / dval[order]).astype(np.float32), dev),
        cols=to_tensor(slot_of[indices[off][eorder]], dev),
        vals=to_tensor(values[off][eorder].astype(np.float32), dev),
        seg=to_tensor(seg.astype(np.int64), dev),
        row_ptr=tuple(int(v) for v in row_ptr),
        ent_ptr=tuple(int(v) for v in ent_ptr),
        n=n,
        lower=lower,
    )


def _solve_scheduled(sched: TriangularSchedule,
                     b: torch.Tensor) -> torch.Tensor:
    # y holds the unknowns in level order: level l is y[r0:r1].
    y = b.to(torch.float32).index_select(0, sched.rows)
    shape = (-1,) + (1,) * (y.ndim - 1)
    vals = sched.vals.reshape(shape)
    inv_diag = sched.inv_diag.reshape(shape)
    for lv in range(sched.n_levels):
        r0, r1 = sched.row_ptr[lv], sched.row_ptr[lv + 1]
        e0, e1 = sched.ent_ptr[lv], sched.ent_ptr[lv + 1]
        level = y[r0:r1]
        if e1 > e0:
            prod = y.index_select(0, sched.cols[e0:e1]) * vals[e0:e1]
            level.index_add_(0, sched.seg[e0:e1], prod, alpha=-1)
        level.mul_(inv_diag[r0:r1])
    return torch.empty_like(y).index_copy_(0, sched.rows, y)


def solve_triangular_sparse(l: CSR, b,
                            sched: Optional[TriangularSchedule] = None,
                            *, lower: bool = True) -> torch.Tensor:
    """Sparse triangular solve ``L x = b`` by level scheduling. Pass a
    prebuilt ``sched`` to reuse the analysis across solves."""
    if sched is None:
        sched = build_schedule(l, lower=lower)
    if not isinstance(b, torch.Tensor):
        b = torch.as_tensor(np.asarray(b))
    b = b.to(sched.rows.device)
    check(b.shape[0] == sched.n, IncorrectDimensions,
          f"triangular solve: n={sched.n} vs b {tuple(b.shape)}")
    if not sched.lower:
        # Mirrored problem: reverse the rows of b and of the solution.
        return torch.flip(_solve_scheduled(sched, torch.flip(b, (0,))), (0,))
    return _solve_scheduled(sched, b)
