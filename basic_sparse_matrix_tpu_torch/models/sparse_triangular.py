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

Batched values (the counterpart of ``jax.vmap(_solve_scheduled)`` over
schedules stacked from ``Bt`` factors of one pattern): the schedule also
records where each scheduled value sits in ``l.values``, so
:func:`schedule_values` maps ``Bt`` value sets of ``l``'s pattern to the
schedule's (off-diagonal values, reciprocal diagonals) on the device, and
the solves take them beside ``b`` of shape (Bt, n[, k]): every level is the
same four operations for the whole batch. :func:`factor_pattern` and
:func:`csr_value_order` map a factorization's CSC value order to ``l``'s
CSR order, so factor → solve needs no host round trip per system.

On the card the level loop runs as one captured CUDA graph per (schedule,
operand shapes), replayed on every later solve (``runtime/graphs.py``: the
counterpart of the JAX package's ``jax.jit``); on the CPU it runs as it
is.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.csr import CSR, to_tensor
from ..runtime import graphs, profiling, symbolic
from ..utils.errors import IncorrectDimensions, NonSquareMatrix, check


@dataclasses.dataclass(eq=False)
class TriangularSchedule:
    """Ragged solve schedule for one triangular CSR matrix.

    Level ``l`` solves rows ``rows[row_ptr[l]:row_ptr[l+1]]`` (ascending)
    with the off-diagonal entries ``cols/vals[ent_ptr[l]:ent_ptr[l+1]]``;
    ``cols`` are positions in level order (``rows[cols[e]]`` is the
    column), ``seg`` gives each entry's row slot inside its level and
    ``inv_diag`` each row's reciprocal diagonal (in level order).
    ``val_pos`` and ``diag_pos`` are the positions in ``l.values`` (the
    matrix the schedule was built from, in its CSR order) of ``vals`` and
    of the diagonal behind ``inv_diag`` (:func:`schedule_values`)."""

    rows: torch.Tensor      # (n,) int64, rows in level order
    inv_diag: torch.Tensor  # (n,) float32
    cols: torch.Tensor      # (nnz_off,) int64, level-order positions
    vals: torch.Tensor      # (nnz_off,) float32
    seg: torch.Tensor       # (nnz_off,) int64
    val_pos: torch.Tensor   # (nnz_off,) int64 into l.values
    diag_pos: torch.Tensor  # (n,) int64 into l.values, level order
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
    reversed indices (row i → n-1-i, col j → n-1-j); also returns where
    each mirrored entry sits in the input's storage."""
    rows = np.repeat(np.arange(n), np.diff(indptr))
    m_rows, m_cols = n - 1 - rows, n - 1 - indices
    order = np.lexsort((m_cols, m_rows))
    m_rows, m_cols, m_vals = m_rows[order], m_cols[order], values[order]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr[1:], m_rows, 1)
    return np.cumsum(indptr), m_cols, m_vals, order


def build_schedule(l: CSR, *, lower: bool = True) -> TriangularSchedule:
    """Host analysis: level sets and the ragged per-level tables, placed on
    ``l``'s device."""
    check(l.rows == l.cols, NonSquareMatrix, "triangular solve needs square")
    n = l.rows
    indptr, indices, values = l.numpy()
    indices = indices.astype(np.int64)
    src = np.arange(values.shape[0], dtype=np.int64)   # l.values positions
    if not lower:
        indptr, indices, values, src = _mirror(n, indptr, indices, values)

    level, nlev = symbolic.level_sets(n, indptr, indices)
    erow = np.repeat(np.arange(n), np.diff(indptr))
    diag = indices == erow
    ndiag = np.bincount(erow[diag], minlength=n)
    dval = np.zeros(n, dtype=np.float64)
    dval[erow[diag]] = values[diag]
    dpos = np.zeros(n, dtype=np.int64)
    dpos[erow[diag]] = src[diag]
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
        val_pos=to_tensor(src[off][eorder], dev),
        diag_pos=to_tensor(dpos[order], dev),
        row_ptr=tuple(int(v) for v in row_ptr),
        ent_ptr=tuple(int(v) for v in ent_ptr),
        n=n,
        lower=lower,
    )


def schedule_values(sched: TriangularSchedule, l_values: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Map value sets of the scheduled matrix's pattern, ``l_values`` (nnz,)
    or (Bt, nnz) in ``l``'s CSR storage order, to the schedule's
    ``(vals (..., nnz_off), inv_diag (..., n))`` float32, on
    ``l_values``' device: the data fields of one ``TriangularSchedule`` per
    system in the JAX package. The reciprocal is taken in float64, as
    :func:`build_schedule` takes it. A zero diagonal gives an infinite
    reciprocal (the schedule checked only the values it was built from)."""
    vals = l_values[..., sched.val_pos.to(l_values.device)].to(torch.float32)
    diag = l_values[..., sched.diag_pos.to(l_values.device)]
    return vals, (1.0 / diag.to(torch.float64)).to(torch.float32)


def factor_pattern(sched) -> Tuple[np.ndarray, np.ndarray]:
    """(rows, cols) of each entry of a factorization's flat CSC value array:
    ``sched.l_pattern`` of a supernodal schedule, or the pattern behind a
    scatter-list schedule's ``l_col_ptr`` / ``l_row_idx``."""
    pattern = getattr(sched, "l_pattern", None)
    if pattern is not None:
        return pattern
    cols = np.repeat(np.arange(sched.n), np.diff(sched.l_col_ptr))
    return np.asarray(sched.l_row_idx), cols


def csr_value_order(rows, cols, l: CSR) -> torch.Tensor:
    """Host helper: for a value array whose entry ``e`` is ``(rows[e],
    cols[e])`` (a factorization's CSC order, :func:`factor_pattern`), the
    position of each stored entry of ``l`` in its CSR order, so that
    ``values[..., order]`` are ``l``'s values; on ``l``'s device. For
    ``l.transpose()`` pass ``(cols, rows)``. Raises if ``l`` stores an
    entry the pattern lacks."""
    n = max(l.rows, l.cols)
    keys = np.asarray(rows, dtype=np.int64) * n + np.asarray(cols)
    sort = np.argsort(keys, kind="stable")
    indptr, indices, _ = l.numpy()
    want = np.repeat(np.arange(l.rows, dtype=np.int64),
                     np.diff(indptr)) * n + indices
    at = np.searchsorted(keys[sort], want)
    check(bool(np.all(at < keys.size)) and bool(
        np.array_equal(keys[sort][np.minimum(at, keys.size - 1)], want)),
        IncorrectDimensions, "csr_value_order: l holds entries the pattern "
        "lacks")
    return to_tensor(sort[at].astype(np.int64), l.device)


def _solve_scheduled(sched: TriangularSchedule, b: torch.Tensor,
                     vals: Optional[torch.Tensor] = None,
                     inv_diag: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """The level loop on ``b`` (n[, k]) with the schedule's values, or on
    ``b`` (Bt, n[, k]) with batched ``vals`` (Bt, nnz_off) and ``inv_diag``
    (Bt, n) (:func:`schedule_values`): the same operations along the
    unknowns' axis ``d``."""
    d = 0 if vals is None else 1           # the unknowns' axis
    if vals is None:
        vals, inv_diag = sched.vals, sched.inv_diag
    # y holds the unknowns in level order: level l is y[r0:r1] on axis d.
    y = b.to(torch.float32).index_select(d, sched.rows)
    tail = (1,) * (y.ndim - d - 1)
    vals = vals.reshape(vals.shape + tail)
    inv_diag = inv_diag.reshape(inv_diag.shape + tail)
    for lv in range(sched.n_levels):
        r0, r1 = sched.row_ptr[lv], sched.row_ptr[lv + 1]
        e0, e1 = sched.ent_ptr[lv], sched.ent_ptr[lv + 1]
        level = y.narrow(d, r0, r1 - r0)
        if e1 > e0:
            prod = y.index_select(d, sched.cols[e0:e1]) \
                * vals.narrow(d, e0, e1 - e0)
            level.index_add_(d, sched.seg[e0:e1], prod, alpha=-1)
        level.mul_(inv_diag.narrow(d, r0, r1 - r0))
    return torch.empty_like(y).index_copy_(d, sched.rows, y)


def solve_triangular_sparse(l: CSR, b,
                            sched: Optional[TriangularSchedule] = None,
                            *, lower: bool = True,
                            values: Optional[Tuple[torch.Tensor,
                                                   torch.Tensor]] = None
                            ) -> torch.Tensor:
    """Sparse triangular solve ``L x = b`` by level scheduling. Pass a
    prebuilt ``sched`` to reuse the analysis across solves.

    ``values``, from :func:`schedule_values` on (Bt, nnz) value sets of
    ``l``'s pattern, solves ``Bt`` systems at once: ``b`` is then (Bt,
    n[, k]) and so is the result (``jax.vmap`` over stacked schedules in
    the JAX package). On the card the solve replays a captured graph
    (``runtime/graphs.py``); ``b`` and the batched values are copied into
    its static buffers, and the result is a fresh tensor. The recorder's
    span is ``bsm.trsv`` (``runtime/profiling.py``)."""
    with profiling.span("bsm.trsv"):
        if sched is None:
            sched = build_schedule(l, lower=lower)
        if not isinstance(b, torch.Tensor):
            b = torch.as_tensor(np.asarray(b))
        b = b.to(sched.rows.device)
        d = 0
        vals = inv_diag = None
        if values is not None:
            vals, inv_diag = values
            d = 1
            check(vals.ndim == 2
                  and inv_diag.shape == (vals.shape[0], sched.n)
                  and b.ndim >= 2 and b.shape[0] == vals.shape[0],
                  IncorrectDimensions,
                  f"batched triangular solve: values {tuple(vals.shape)}, "
                  f"{tuple(inv_diag.shape)} vs b {tuple(b.shape)}")
        check(b.shape[d] == sched.n, IncorrectDimensions,
              f"triangular solve: n={sched.n} vs b {tuple(b.shape)}")
        operands = (b,) if values is None else (b, vals, inv_diag)
        return graphs.run(sched, "solve", functools.partial(_solve, sched),
                          *operands)


def _solve(sched: TriangularSchedule, b: torch.Tensor,
           vals: Optional[torch.Tensor] = None,
           inv_diag: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The level loop in the schedule's orientation: the mirrored upper
    problem reverses the rows of ``b`` and of the solution."""
    if sched.lower:
        return _solve_scheduled(sched, b, vals, inv_diag)
    d = 0 if vals is None else 1
    return torch.flip(_solve_scheduled(sched, torch.flip(b, (d,)), vals,
                                       inv_diag), (d,))
