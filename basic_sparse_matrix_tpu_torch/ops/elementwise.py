"""Elementwise sparse algebra: add, sub, scalar multiply, reductions.

Counterpart of ``basic_sparse_matrix_tpu/ops/elementwise.py`` (reference
``add_sparse``/``sub_sparse``, ``mul_scalar``, ``sum_elements``,
``l2_norm``). ``add``/``sub`` keep the JAX package's three merges, all with
output capacity ``nnz_a + nnz_b`` (slots past the union hold explicit zeros;
``CSR.compacted()`` restores exact storage):

* *planned*: a host union plan (:class:`_MergePlan`, numpy) memoised on the
  left operand per right operand; the numeric phase is two gathers and one
  add on the operands' device. Taken whenever neither operand stores a
  coordinate twice.
* *key-space* and *sort* merges: the duplicate-safe fallbacks, taken when
  the plan refuses (:class:`_HasDuplicateCoords`, e.g. for the
  capacity-padded output of an earlier merge): scatter-add into a flat
  ``rows·cols`` accumulator while that fits ``KEYSPACE_BUDGET_BYTES``, else
  a stable sort of the concatenated entries and a segment sum.

The output pattern, its order and the explicit zeros kept are those of the
JAX package, entry for entry.

The JAX package has two numeric formulations of the planned merge (config
``merge_numeric``: ``"planned"``, and ``"chunked"``, which groups scalar
gathers into row gathers for XLA on its device). PyTorch gathers by index directly, so the
port runs one formulation, two gathers and an add, for either value.

Unsigned values above uint8 are summed in int64 and cast back, which wraps
modulo 2**bits as the JAX package's uint32 does.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from ..utils.errors import IncorrectDimensions, check
from .csr import CSR, compute_dtype, to_tensor


def _signed_values(a: CSR, b: CSR, b_sign: int):
    """Both value vectors in the dtype their sums are taken in, ``b``
    negated for a subtraction; and the dtype of the result."""
    dtype = torch.result_type(a.values, b.values)
    cdt = compute_dtype(dtype)
    vb = b.values.to(cdt)
    return a.values.to(cdt), (vb if b_sign > 0 else -vb), dtype


def _indptr_of(rows: torch.Tensor, n_rows: int) -> torch.Tensor:
    counts = torch.bincount(rows, minlength=n_rows)
    return torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)]).to(
        torch.int32)


def sum_sorted_runs(keys: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """For entries sorted by ``keys``: the first entry of each run of equal
    keys takes the run's sum, the later ones become explicit zeros."""
    first = torch.ones_like(keys, dtype=torch.bool)
    first[1:] = keys[1:] != keys[:-1]
    seg = torch.cumsum(first, 0) - 1
    summed = torch.zeros_like(vals).index_add_(0, seg, vals)
    return torch.where(first, summed[seg], torch.zeros_like(vals))


def _merge(a: CSR, b: CSR, b_sign: int) -> CSR:
    """Sort merge: concatenate, sort stably by (row, col), sum each run of
    one coordinate into its first entry."""
    n = a.stored + b.stored
    if n == 0:
        return CSR.empty(a.dims, dtype=a.dtype, device=a.device)
    va, vb, dtype = _signed_values(a, b, b_sign)
    rows = torch.cat([a.row_ids(), b.row_ids()]).long()
    cols = torch.cat([a.indices, b.indices]).long()
    keys, order = torch.sort(rows * a.cols + cols, stable=True)
    vals = sum_sorted_runs(keys, torch.cat([va, vb])[order])
    return CSR(indptr=_indptr_of(rows[order], a.rows),
               indices=cols[order].to(torch.int32), values=vals.to(dtype),
               rows=a.rows, cols=a.cols)


def _merge_keyspace(a: CSR, b: CSR, b_sign: int) -> CSR:
    """Key-space merge: scatter-add both operands into a flat ``rows·cols``
    accumulator, mark the union, and read the union's coordinates off the
    mask already sorted. Slots past the union's size are explicit zeros at
    (rows-1, cols-1)."""
    n = a.stored + b.stored
    ncell = a.rows * a.cols
    va, vb, dtype = _signed_values(a, b, b_sign)
    key_a = a.row_ids().long() * a.cols + a.indices.long()
    key_b = b.row_ids().long() * b.cols + b.indices.long()
    acc = torch.zeros(ncell, dtype=va.dtype, device=a.device)
    acc.index_add_(0, key_a, va)
    acc.index_add_(0, key_b, vb)
    mask = torch.zeros(ncell, dtype=torch.bool, device=a.device)
    mask[key_a] = True
    mask[key_b] = True
    union = torch.nonzero(mask).reshape(-1)
    keys = torch.full((n,), ncell - 1, dtype=torch.int64, device=a.device)
    keys[: union.shape[0]] = union
    vals = torch.zeros(n, dtype=va.dtype, device=a.device)
    vals[: union.shape[0]] = acc[union]
    rows = keys // a.cols
    return CSR(indptr=_indptr_of(rows, a.rows),
               indices=(keys % a.cols).to(torch.int32),
               values=vals.to(dtype), rows=a.rows, cols=a.cols)


class _HasDuplicateCoords(Exception):
    """Operand stores duplicate coordinates — planned merge inapplicable."""


def _has_repeats(keys: np.ndarray) -> bool:
    s = np.sort(keys)
    return bool((s[1:] == s[:-1]).any())


def sorted_unique(keys: np.ndarray) -> np.ndarray:
    """``np.unique(keys)`` by sort and compare (numpy's hash-based unique
    is slow on tens of millions of 64-bit keys)."""
    s = np.sort(keys)
    if s.size == 0:
        return s
    keep = np.ones(s.shape[0], dtype=bool)
    keep[1:] = s[1:] != s[:-1]
    return s[keep]


class _MergePlan:
    """Value-independent merge plan for a fixed (pattern_a, pattern_b) pair:
    the union coordinates (sorted, capacity ``nnz_a + nnz_b`` with trailing
    explicit-zero padding at (rows-1, cols-1)) plus per-slot inverse gather
    maps into each operand's value vector (sentinel: one past the end, a
    zero appended to the values). Built on the host in numpy, kept on the
    operands' device, memoised on the left operand and keyed by the right
    operand's identity."""

    __slots__ = ("indptr", "indices", "gather_a", "gather_b", "n")

    def __init__(self, a: CSR, b: CSR):
        n = a.stored + b.stored
        ia, xa, _ = a.numpy()
        ib, xb, _ = b.numpy()
        ra = np.repeat(np.arange(a.rows, dtype=np.int64), np.diff(ia))
        rb = np.repeat(np.arange(b.rows, dtype=np.int64), np.diff(ib))
        ka = ra * a.cols + xa
        kb = rb * b.cols + xb
        # An output slot can take at most one entry of each operand, so an
        # operand that stores a coordinate twice would lose values: refuse,
        # and let the dispatcher take a duplicate-safe merge.
        if _has_repeats(ka) or _has_repeats(kb):
            raise _HasDuplicateCoords()
        union = sorted_unique(np.concatenate([ka, kb]))
        m = union.shape[0]
        keys = np.full(n, (a.rows - 1) * a.cols + (a.cols - 1),
                       dtype=np.int64)
        keys[:m] = union
        counts = np.bincount(keys // a.cols, minlength=a.rows)
        indptr = np.concatenate([[0], np.cumsum(counts)])
        ga = np.full(n, a.stored, dtype=np.int64)
        ga[np.searchsorted(union, ka)] = np.arange(ka.shape[0])
        gb = np.full(n, b.stored, dtype=np.int64)
        gb[np.searchsorted(union, kb)] = np.arange(kb.shape[0])
        dev = a.device
        self.indptr = to_tensor(indptr.astype(np.int32), dev)
        self.indices = to_tensor((keys % a.cols).astype(np.int32), dev)
        self.gather_a = to_tensor(ga.astype(np.int32), dev)
        self.gather_b = to_tensor(gb.astype(np.int32), dev)
        self.n = n


def _merge_planned_vals(a: CSR, b: CSR, plan: _MergePlan,
                        b_sign: int) -> torch.Tensor:
    """The planned merge's numeric phase: two gathers and an add."""
    va, vb, dtype = _signed_values(a, b, b_sign)
    za = torch.cat([va, va.new_zeros(1)])
    zb = torch.cat([vb, vb.new_zeros(1)])
    return (za.index_select(0, plan.gather_a)
            + zb.index_select(0, plan.gather_b)).to(dtype)


def cached_plan(plans: list, b: CSR, build):
    """The plan memoised for right operand ``b`` in ``plans`` (a list of
    (weakref, plan) bounded to four), built with ``build()`` on a miss."""
    for ref, p in plans:
        if ref() is b:
            return p
    plan = build()
    plans.append((weakref.ref(b), plan))
    del plans[:-4]
    return plan


def _merge_planned(a: CSR, b: CSR, b_sign: int) -> CSR:
    if a._merge_plans is None:
        a._merge_plans = []
    plan = cached_plan(a._merge_plans, b, lambda: _MergePlan(a, b))
    return CSR(indptr=plan.indptr, indices=plan.indices,
               values=_merge_planned_vals(a, b, plan, b_sign),
               rows=a.rows, cols=a.cols)


# Flat accumulator budget for the key-space merge (rows·cols·itemsize·~2).
KEYSPACE_BUDGET_BYTES = 1 << 28


def _use_keyspace(a: CSR, b: CSR) -> bool:
    if a.stored + b.stored == 0:
        return False
    ncell = a.rows * a.cols
    return ncell < 2**31 and 8 * ncell <= KEYSPACE_BUDGET_BYTES


def _dispatch_merge(a: CSR, b: CSR, b_sign: int) -> CSR:
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    if a.stored + b.stored:
        # symbolic/numeric split: one host plan per pattern pair, then two
        # gathers and an add per call
        try:
            return _merge_planned(a, b, b_sign)
        except _HasDuplicateCoords:
            pass  # e.g. a previous merge's capacity-padded output
    if _use_keyspace(a, b):
        return _merge_keyspace(a, b, b_sign)
    return _merge(a, b, b_sign)


def add(a: CSR, b: CSR) -> CSR:
    """Sparse + sparse — reference ``add_sparse``, on the operands'
    device."""
    check(a.shape == b.shape, IncorrectDimensions,
          f"add_sparse dims {a.dims} vs {b.dims}")
    return _dispatch_merge(a, b, 1)


def sub(a: CSR, b: CSR) -> CSR:
    """Sparse − sparse — reference ``sub_sparse``."""
    check(a.shape == b.shape, IncorrectDimensions,
          f"sub_sparse dims {a.dims} vs {b.dims}")
    return _dispatch_merge(a, b, -1)


# Parity aliases.
add_sparse = add
sub_sparse = sub


def mul_scalar(a: CSR, s) -> CSR:
    """Scale all stored values — reference ``mul_scalar``. The scalar is
    cast to the matrix's dtype first, as in the JAX package."""
    cdt = compute_dtype(a.dtype)
    s = torch.as_tensor(s, device=a.device).to(a.dtype).to(cdt)
    return CSR(indptr=a.indptr, indices=a.indices,
               values=(a.values.to(cdt) * s).to(a.dtype),
               rows=a.rows, cols=a.cols)


def sum_elements(a: CSR) -> torch.Tensor:
    """Sum of stored values, in the matrix's dtype (a 0-d tensor on its
    device) — reference ``sum_elements``."""
    return a.values.to(compute_dtype(a.dtype)).sum().to(a.dtype)


def l2_norm(a: CSR) -> torch.Tensor:
    """Frobenius norm of stored values in float32 — reference
    ``l2_norm``."""
    return a.values.to(torch.float32).square().sum().sqrt()
