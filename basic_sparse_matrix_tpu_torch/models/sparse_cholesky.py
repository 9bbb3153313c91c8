"""Level-scheduled sparse Cholesky (symbolic + numeric split), the
scatter-list tier.

Counterpart of ``basic_sparse_matrix_tpu/models/sparse_cholesky.py``:

* **Symbolic phase** (host, ``runtime/symbolic``): the pattern of L, the
  fan-in level of every column, and every left-looking update
  ``L[i,j] -= L[i,k]·L[j,k]`` as an index triple ``(dst, src_a, src_b)``
  into L's CSC value array, grouped by the destination column's level.
* **Numeric phase** (the matrix's device): per level, one gather +
  multiply + ``index_add_`` for the updates, then the level's columns are
  finalised (square root of the diagonal, the column scaled by its
  reciprocal).

The JAX package pads the triples to (levels, max updates per level) and the
column tables to (levels, max columns, max column length); the second
product grows far faster than the factor (the same padding made the
triangular-solve schedule unusable at n = 35,937). Here every level is
stored ragged: flat triples with level offsets, the level's diagonal
positions, and its below-diagonal positions with each one's column slot.
The tables take O(triples + nnz_l) entries. The scratch slot past the end
of L's values stays, as does the guard ``where(diag > 0, 1/max(diag,
1e-30), 0)`` (a column whose pivot is not positive gets a NaN diagonal and
zeros below it).

Levels: a column's updates come only from columns k with L[j, k] ≠ 0, so
the level sets of L's own pattern (``symbolic.level_sets``, as the
triangular solves use) order the factorization correctly. For the full
factor they equal the elimination-tree levels the JAX package uses. For
the IC(0) pattern they are far fewer (the etree of the 33³ Laplacian in
natural order is a chain of 35,937 levels; the pattern has 97), and since
the updates into a column are applied in the same order either way, the
factor is the same.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..ops.csr import CSR, to_tensor
from ..runtime import symbolic
from ..utils.errors import NonSquareMatrix, check


@dataclasses.dataclass(eq=False)
class CholeskySchedule:
    """Ragged numeric-phase schedule, on the matrix's device.

    Level ``l`` applies the triples ``upd_*[upd_ptr[l]:upd_ptr[l+1]]``,
    then finalises the columns whose diagonals sit at
    ``col_diag[col_ptr[l]:col_ptr[l+1]]`` and whose below-diagonal entries
    sit at ``col_off[off_ptr[l]:off_ptr[l+1]]`` (``col_seg``: each entry's
    column slot inside its level). All positions index L's CSC value array
    (``l_col_ptr``/``l_row_idx``, host numpy, diagonal first per column).
    """

    a_src_pos: torch.Tensor   # (nnz_lower_A,) int64 into L values
    a_vals_idx: torch.Tensor  # (nnz_lower_A,) int64 into A.values
    upd_dst: torch.Tensor     # (triples,) int64
    upd_a: torch.Tensor       # (triples,) int64
    upd_b: torch.Tensor       # (triples,) int64
    col_diag: torch.Tensor    # (n,) int64, columns in level order
    col_off: torch.Tensor     # (nnz_l - n,) int64
    col_seg: torch.Tensor     # (nnz_l - n,) int64
    upd_ptr: Tuple[int, ...]
    col_ptr: Tuple[int, ...]
    off_ptr: Tuple[int, ...]
    nnz_l: int
    n: int
    l_col_ptr: np.ndarray
    l_row_idx: np.ndarray

    @property
    def n_levels(self) -> int:
        return len(self.col_ptr) - 1

    @property
    def n_triples(self) -> int:
        return int(self.upd_dst.shape[0])

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (
            self.a_src_pos, self.a_vals_idx, self.upd_dst, self.upd_a,
            self.upd_b, self.col_diag, self.col_off, self.col_seg))


def analyze(a: CSR, *, incomplete: bool = False) -> CholeskySchedule:
    """Symbolic phase. ``a`` must be square; only its lower triangle is read
    (symmetry assumed, like the reference).

    ``incomplete=True`` gives the IC(0) schedule: the factor's pattern is
    A's lower pattern plus the diagonal (no fill), and updates whose
    destination falls outside it are dropped."""
    check(a.rows == a.cols, NonSquareMatrix, f"cholesky needs square {a.dims}")
    n = a.rows
    indptr, indices, _ = a.numpy()
    rows = np.repeat(np.arange(n), np.diff(indptr))

    if incomplete:
        keep_low = indices <= rows
        pr = np.concatenate([rows[keep_low], np.arange(n)])
        pc = np.concatenate([indices[keep_low], np.arange(n)])
        pk = np.unique(pr * n + pc)
        l_rows_flat, l_indices = pk // n, pk % n
        l_indptr = np.zeros(n + 1, dtype=np.int64)
        np.add.at(l_indptr[1:], l_rows_flat, 1)
        l_indptr = np.cumsum(l_indptr)
    else:
        _, l_indptr, l_indices = symbolic.chol_symbolic_csr(a)

    level, nlev = symbolic.level_sets(n, l_indptr, l_indices)
    nlev = max(nlev, 1)

    # Row-wise L pattern → CSC (column-wise), diagonal first per column.
    l_rows = np.repeat(np.arange(n), np.diff(l_indptr))
    order = np.lexsort((l_rows, l_indices))
    csc_rows, csc_cols = l_rows[order], np.asarray(l_indices)[order]
    nnz_l = csc_rows.shape[0]
    col_ptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(col_ptr[1:], csc_cols, 1)
    col_ptr = np.cumsum(col_ptr)
    # (col, row) keys ascend with the value array, so searchsorted finds
    # any (row, col)'s position.
    csc_keys = csc_cols.astype(np.int64) * n + csc_rows

    keep = indices <= rows
    a_rows, a_cols = rows[keep], indices[keep]
    a_vals_idx = np.nonzero(keep)[0]
    a_src_pos = np.searchsorted(csc_keys, a_cols.astype(np.int64) * n
                                + a_rows)

    # Update triples, level-sorted; incomplete patterns drop out-of-pattern
    # destinations inside the generator.
    dst, ua, ub, _, counts, _ = symbolic.chol_update_triples(
        col_ptr, csc_rows, level, nlev)
    upd_ptr = np.concatenate([[0], np.cumsum(counts)])

    # Columns in level order (ascending inside a level), then each column's
    # below-diagonal positions with its slot inside the level.
    cols = np.argsort(level, kind="stable")
    ccount = np.bincount(level, minlength=nlev)
    cptr = np.concatenate([[0], np.cumsum(ccount)])
    slot = np.arange(n) - cptr[level[cols]]
    below = np.diff(col_ptr)[cols] - 1
    first = np.repeat(col_ptr[cols] + 1 - np.concatenate(
        [[0], np.cumsum(below)[:-1]]), below)
    col_off = first + np.arange(int(below.sum()))
    col_seg = np.repeat(slot, below)
    off_ptr = np.concatenate([[0], np.cumsum(
        np.bincount(level[cols], weights=below, minlength=nlev))])

    dev = a.device

    def up(x):
        return to_tensor(np.asarray(x, dtype=np.int64), dev)

    return CholeskySchedule(
        a_src_pos=up(a_src_pos), a_vals_idx=up(a_vals_idx),
        upd_dst=up(dst), upd_a=up(ua), upd_b=up(ub),
        col_diag=up(col_ptr[cols]), col_off=up(col_off), col_seg=up(col_seg),
        upd_ptr=tuple(int(v) for v in upd_ptr),
        col_ptr=tuple(int(v) for v in cptr),
        off_ptr=tuple(int(v) for v in off_ptr),
        nnz_l=int(nnz_l), n=n, l_col_ptr=col_ptr, l_row_idx=csc_rows)


def initial_lvals(sched: CholeskySchedule,
                  a_values: torch.Tensor) -> torch.Tensor:
    """A's lower triangle scattered into L's CSC value array, plus one
    trailing scratch slot, kept zero."""
    lvals = torch.zeros(sched.nnz_l + 1, dtype=torch.float32,
                        device=a_values.device)
    return lvals.index_add_(0, sched.a_src_pos,
                            a_values[sched.a_vals_idx].to(torch.float32))


def factor_levels(sched: CholeskySchedule, lvals: torch.Tensor, lo: int,
                  hi: int) -> torch.Tensor:
    """Apply levels ``lo`` .. ``hi - 1`` to ``lvals`` in place (a Python
    loop; ``runtime.checkpoint`` snapshots the values between calls)."""
    for lv in range(lo, hi):
        u0, u1 = sched.upd_ptr[lv], sched.upd_ptr[lv + 1]
        if u1 > u0:
            delta = lvals[sched.upd_a[u0:u1]] * lvals[sched.upd_b[u0:u1]]
            lvals.index_add_(0, sched.upd_dst[u0:u1], delta, alpha=-1)
        dpos = sched.col_diag[sched.col_ptr[lv]: sched.col_ptr[lv + 1]]
        diag = lvals[dpos].sqrt()
        inv = torch.where(diag > 0, 1.0 / diag.clamp_min(1e-30), 0.0)
        lvals[dpos] = diag
        o0, o1 = sched.off_ptr[lv], sched.off_ptr[lv + 1]
        if o1 > o0:
            opos = sched.col_off[o0:o1]
            lvals[opos] = lvals[opos] * inv[sched.col_seg[o0:o1]]
    lvals[-1] = 0.0
    return lvals


def factorize(sched: CholeskySchedule, a_values: torch.Tensor
              ) -> torch.Tensor:
    """Numeric phase on ``a_values``' device: L's CSC value array (length
    ``nnz_l``), a Python loop over the levels."""
    lvals = initial_lvals(sched, a_values)
    return factor_levels(sched, lvals, 0, sched.n_levels)[:-1]


def csc_to_csr_l(sched: CholeskySchedule, lvals) -> CSR:
    """Assemble the factor as a row-major CSR (host), on ``lvals``' device
    (the CPU for a numpy array)."""
    device = lvals.device if isinstance(lvals, torch.Tensor) else None
    if isinstance(lvals, torch.Tensor):
        lvals = lvals.detach().cpu().numpy()
    n = sched.n
    cols = np.repeat(np.arange(n), np.diff(sched.l_col_ptr))
    return CSR.from_coo_arrays((n, n), sched.l_row_idx, cols,
                               np.asarray(lvals), sum_duplicates=False,
                               drop_zeros=False, device=device)


def cholesky_sparse(a: CSR) -> CSR:
    """End-to-end sparse Cholesky: symbolic + numeric + assembly."""
    sched = analyze(a)
    return csc_to_csr_l(sched, factorize(sched, a.values))
