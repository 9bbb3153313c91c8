"""SpGEMM (sparse × sparse).

Counterpart of ``basic_sparse_matrix_tpu/ops/spgemm.py`` (reference
``mul_sparse``), with the same entry points and dispatch:

* :func:`spgemm_dense` — the dense product: SpMM of ``a`` against the
  densified right operand.
* :func:`spgemm` / ``mul_sparse`` — CSR result with exact zeros dropped.
  Masked-dense while the dense intermediates fit ``DENSE_OUTPUT_BUDGET``,
  else :func:`spgemm_planned`.
* :func:`spgemm_bounded` — sparse output at a caller-given capacity: every
  entry of A expanded against B's rows at B's longest row, duplicates merged
  by a sort. Returns the capacity-padded CSR.
* :func:`spgemm_planned` — host symbolic + device numeric: a vectorised
  Gustavson pass in numpy (:class:`_SpgemmPlan`) sizes the expansion by the
  matched row lengths, computes C's exact pattern and memoises the plan on
  the left operand per right operand; the numeric phase is a gather, a
  multiply and an ``index_add_`` by destination slot on the operands'
  device. An expansion over ``EXPANSION_BUDGET`` is planned and run in
  contiguous row chunks (:class:`_SpgemmChunkedPlan`).

The JAX package has five numeric formulations of the planned product (config
``spgemm_numeric``: ``planned``, ``chunked``, ``rowgather``, ``mergetree``,
``auto``); the last four rearrange the gathers so that XLA runs fewer of
them on its device. PyTorch gathers by index directly, so the port runs one
formulation (gather, multiply, ``index_add_``) for every value. The output
pattern (exact, cancellations kept as explicit zeros) is the same.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.config import matmul_precision
from ..utils.errors import IncorrectDimensions, check
from .csr import CSR, compute_dtype, to_tensor
from .elementwise import cached_plan, sum_sorted_runs
from .spmm import spmm, spmm_auto


def _same_device(a: CSR, b: CSR) -> None:
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")


def spgemm_dense(a: CSR, b: CSR) -> torch.Tensor:
    """Dense product of two sparse operands, on their device. Float32
    operands go through ``spmm_auto``'s ladder (at reference scale the
    dense rung, a float32 matmul with TF32 off); other dtypes through the
    gather/segment ``spmm``, which keeps them."""
    _same_device(a, b)
    dense_b = b.todense()
    if a.dtype == torch.float32 and dense_b.dtype == torch.float32:
        with matmul_precision():
            return spmm_auto(a, dense_b)
    return spmm(a, dense_b)


DENSE_OUTPUT_BUDGET = 1 << 30  # bytes the densified RHS/output may occupy
EXPANSION_BUDGET = 1 << 27     # entries the planned path may expand to


def spgemm(a: CSR, b: CSR) -> CSR:
    """Sparse × sparse → CSR — reference ``mul_sparse``, with the inner
    dimension checked.

    Dispatch: masked-dense while the dense intermediates fit the budget,
    else the planned Gustavson path (:func:`spgemm_planned`)."""
    check(a.cols == b.rows, IncorrectDimensions,
          f"mul_sparse: {a.dims} × {b.dims}")
    dense_bytes = 4 * max(b.rows * b.cols, a.rows * b.cols)
    if dense_bytes <= DENSE_OUTPUT_BUDGET:
        return CSR.from_dense(spgemm_dense(a, b), device=a.device)
    return spgemm_planned(a, b)


# Parity alias.
mul_sparse = spgemm


def spgemm_bounded(a: CSR, b: CSR, out_capacity: int) -> CSR:
    """Static-capacity sparse-output SpGEMM.

    Every stored entry ``A[i,k]`` contributes ``A[i,k] * B[k, :]`` to output
    row ``i``. The contributions are expanded entry by entry against B's
    rows at B's longest row, then duplicates are merged by a (row, col)
    sort. ``out_capacity`` bounds the expanded entry count: ``nnz(A) *
    max_row_nnz(B)`` always suffices. Returns the capacity-padded CSR (use
    ``.compacted()`` for exact storage)."""
    check(a.cols == b.rows, IncorrectDimensions,
          f"spgemm_bounded: {a.dims} × {b.dims}")
    _same_device(a, b)
    b_indptr = b.numpy()[0]
    max_b_row = int(np.max(np.diff(b_indptr))) if b.stored else 0
    expanded = a.stored * max_b_row
    check(out_capacity >= expanded, IncorrectDimensions,
          f"out_capacity {out_capacity} < worst case {expanded}")
    if max_b_row == 0 or a.stored == 0:
        return CSR.empty((a.rows, b.cols), dtype=a.dtype, device=a.device)
    rows, cols, vals = _expand(a, b, max_b_row)
    keys, order = torch.sort(rows * b.cols + cols, stable=True)
    vals = sum_sorted_runs(keys, vals[order])
    counts = torch.bincount(rows[order], minlength=a.rows)
    indptr = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    dtype = torch.result_type(a.values, b.values)
    return CSR(indptr=indptr.to(torch.int32),
               indices=cols[order].to(torch.int32), values=vals.to(dtype),
               rows=a.rows, cols=b.cols)


def _expand(a: CSR, b: CSR, max_b_row: int):
    # For each stored entry (i, k, v) of A, gather B's row k padded to
    # max_b_row. Invalid slots park at the entry's own row, col 0, value 0.
    cdt = compute_dtype(torch.result_type(a.values, b.values))
    k = a.indices.long()
    starts = b.indptr.long()[k]                              # (nnz_a,)
    lens = b.indptr.long()[k + 1] - starts
    offs = torch.arange(max_b_row, device=a.device)          # (L,)
    pos = (starts[:, None] + offs[None, :]).clamp(0, max(b.stored - 1, 0))
    valid = offs[None, :] < lens[:, None]
    out_rows = a.row_ids().long()[:, None].expand(pos.shape)
    out_cols = torch.where(valid, b.indices.long()[pos], 0)
    out_vals = a.values.to(cdt)[:, None] * b.values.to(cdt)[pos]
    out_vals = torch.where(valid, out_vals, torch.zeros_like(out_vals))
    return out_rows.reshape(-1), out_cols.reshape(-1), out_vals.reshape(-1)


class _ExpansionOverBudget(Exception):
    """Actual Gustavson expansion exceeds EXPANSION_BUDGET — the caller
    falls back to the row-chunked plan."""


class _SpgemmPlan:
    """Value-independent Gustavson plan for a fixed (pattern_a, pattern_b)
    pair: the exact output pattern of C = A·B plus flat (dst, src_a, src_b)
    contribution lists sized by the actual expansion (Σ over A's entries of
    the matched B row length), sorted by destination slot. Vectorised numpy
    on the host; the lists live on ``device``."""

    __slots__ = ("indptr", "indices", "dst", "src_a", "src_b", "nnz_c",
                 "rows", "cols", "expansion", "_host_indptr",
                 "_host_indices")

    def __init__(self, a: CSR, b: CSR):
        ia, xa, _ = a.numpy()
        ib, xb, _ = b.numpy()
        self._build(ia, xa, a.rows, ib, xb, b.cols, a.device,
                    budget=EXPANSION_BUDGET)

    def _build(self, ia, xa, a_rows, ib, xb, b_cols, device, budget=None):
        nnz_a = xa.shape[0]
        ra = np.repeat(np.arange(a_rows, dtype=np.int64), np.diff(ia))
        lens = np.diff(ib)[xa].astype(np.int64)   # matched B-row lengths
        total = int(lens.sum())
        if budget is not None and total > budget:
            raise _ExpansionOverBudget(total)
        offsets = np.zeros(nnz_a + 1, dtype=np.int64)
        np.cumsum(lens, out=offsets[1:])
        src_a = np.repeat(np.arange(nnz_a, dtype=np.int64), lens)
        within = np.arange(total, dtype=np.int64) - offsets[src_a]
        src_b = ib[xa[src_a]] + within
        key = ra[src_a] * b_cols + xb[src_b]
        # One stable sort gives the pattern (the distinct keys), every
        # contribution's destination slot, and the lists in destination
        # order.
        order = np.argsort(key, kind="stable")
        key = key[order]
        first = np.ones(total, dtype=bool)
        first[1:] = key[1:] != key[:-1]
        pattern = key[first]
        dst = np.cumsum(first) - 1
        nnz_c = pattern.shape[0]
        counts = np.bincount(pattern // b_cols, minlength=a_rows)
        indptr = np.concatenate([[0], np.cumsum(counts)])
        self._host_indptr = indptr.astype(np.int64)
        self._host_indices = (pattern % b_cols).astype(np.int32)
        self.indptr = to_tensor(indptr.astype(np.int32), device)
        self.indices = to_tensor(self._host_indices, device)
        self.dst = to_tensor(dst.astype(np.int32), device)
        self.src_a = to_tensor(src_a[order].astype(np.int32), device)
        self.src_b = to_tensor(src_b[order].astype(np.int32), device)
        self.nnz_c = nnz_c
        self.rows, self.cols = a_rows, b_cols
        self.expansion = total
        return self


def _plan_numeric(plan: _SpgemmPlan, vals_a: torch.Tensor,
                  vals_b: torch.Tensor) -> torch.Tensor:
    """One plan's numeric phase: gather, multiply, add by destination."""
    dtype = torch.result_type(vals_a, vals_b)
    cdt = compute_dtype(dtype)
    prod = vals_a.to(cdt).index_select(0, plan.src_a) \
        * vals_b.to(cdt).index_select(0, plan.src_b)
    out = torch.zeros(plan.nnz_c, dtype=cdt, device=vals_a.device)
    return out.index_add_(0, plan.dst, prod).to(dtype)


class _SpgemmChunkedPlan:
    """Row-chunked Gustavson plan: when the full expansion exceeds
    ``EXPANSION_BUDGET``, A's rows are cut into contiguous chunks whose
    expansion fits the budget, one :class:`_SpgemmPlan` per chunk, run one
    after another. Output rows are disjoint across chunks, so the pieces
    concatenate exactly. A single row whose own expansion exceeds the
    budget is a chunk by itself."""

    __slots__ = ("chunks", "indptr", "indices", "nnz_c", "rows", "cols",
                 "expansion")

    def __init__(self, a: CSR, b: CSR):
        ia, xa, _ = a.numpy()
        ib, xb, _ = b.numpy()
        ia = np.asarray(ia, dtype=np.int64)
        b_len = np.diff(np.asarray(ib, dtype=np.int64))
        # cumulative expansion at each A-entry boundary → per-row prefix
        ce = np.zeros(xa.shape[0] + 1, dtype=np.int64)
        np.cumsum(b_len[xa], out=ce[1:])
        row_pref = ce[ia]                       # (rows+1,)
        self.expansion = int(row_pref[-1])

        bounds = [0]
        r0 = 0
        while r0 < a.rows:
            r1 = int(np.searchsorted(row_pref,
                                     row_pref[r0] + EXPANSION_BUDGET,
                                     side="right")) - 1
            r1 = min(max(r1, r0 + 1), a.rows)
            bounds.append(r1)
            r0 = r1

        self.chunks = []
        indices_parts, indptr_parts = [], [np.zeros(1, dtype=np.int64)]
        nnz_off = 0
        for r0, r1 in zip(bounds[:-1], bounds[1:]):
            s, e = int(ia[r0]), int(ia[r1])
            p = _SpgemmPlan.__new__(_SpgemmPlan)
            p._build(ia[r0:r1 + 1] - ia[r0], xa[s:e], r1 - r0, ib, xb,
                     b.cols, a.device)
            self.chunks.append((s, e, p))
            indices_parts.append(p._host_indices)
            indptr_parts.append(p._host_indptr[1:] + nnz_off)
            nnz_off += p.nnz_c
        self.nnz_c = nnz_off
        self.indptr = to_tensor(
            np.concatenate(indptr_parts).astype(np.int32), a.device)
        self.indices = to_tensor(
            np.concatenate(indices_parts).astype(np.int32), a.device)
        self.rows, self.cols = a.rows, b.cols

    def numeric(self, vals_a, vals_b):
        parts = [_plan_numeric(p, vals_a[s:e], vals_b)
                 for s, e, p in self.chunks]
        return torch.cat(parts) if len(parts) > 1 else parts[0]


def _build_plan(a: CSR, b: CSR):
    try:
        return _SpgemmPlan(a, b)
    except _ExpansionOverBudget:
        return _SpgemmChunkedPlan(a, b)


def spgemm_planned(a: CSR, b: CSR) -> CSR:
    """True sparse-output SpGEMM: host symbolic plan (memoised per right
    operand, at most four) and one gather-multiply-add on the operands'
    device. Exact output pattern, so a skewed B (one dense row) costs its
    actual expansion, not ``nnz(A)·max_row(B)``."""
    check(a.cols == b.rows, IncorrectDimensions,
          f"spgemm_planned: {a.dims} × {b.dims}")
    _same_device(a, b)
    if a.stored == 0 or b.stored == 0:
        return CSR.empty((a.rows, b.cols), dtype=a.dtype, device=a.device)
    if a._spgemm_plans is None:
        a._spgemm_plans = []
    plan = cached_plan(a._spgemm_plans, b, lambda: _build_plan(a, b))
    if isinstance(plan, _SpgemmChunkedPlan):
        vals = plan.numeric(a.values, b.values)
    else:
        vals = _plan_numeric(plan, a.values, b.values)
    return CSR(indptr=plan.indptr, indices=plan.indices, values=vals,
               rows=plan.rows, cols=plan.cols)
