"""Symmetric permutations / reordering.

Counterpart of ``basic_sparse_matrix_tpu/ops/reorder.py``. The orderings
are host work (numpy + the native runtime) and return the JAX package's
permutations exactly; :func:`permute_symmetric` builds P·A·Pᵀ on the host
and places it on ``a``'s device, and :func:`apply_perm` permutes tensor
rows on their own device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..runtime import symbolic
from ..utils.errors import NonSquareMatrix, check
from .csr import CSR


def _sym_pattern(a: CSR):
    """Symmetrised adjacency (CSR indptr/indices) of A's pattern."""
    indptr, indices, _ = a.numpy()
    rows = np.repeat(np.arange(a.rows), np.diff(indptr))
    pr = np.concatenate([rows, indices])
    pc = np.concatenate([indices, rows])
    keys = np.unique(pr * a.rows + pc)
    sr, sc = keys // a.rows, keys % a.rows
    sp = np.zeros(a.rows + 1, dtype=np.int64)
    np.add.at(sp[1:], sr, 1)
    sp = np.cumsum(sp)
    return sp, sc


def rcm_permutation(a: CSR) -> np.ndarray:
    """RCM permutation from A's symmetrised pattern."""
    check(a.rows == a.cols, NonSquareMatrix, "rcm needs square")
    sp, sc = _sym_pattern(a)
    return symbolic.rcm_ordering(a.rows, sp, sc)


def nd_permutation(a: CSR, *, leaf: int = 64) -> np.ndarray:
    """Nested-dissection permutation (recursive BFS bisection, separators
    eliminated last)."""
    check(a.rows == a.cols, NonSquareMatrix, "nd needs square")
    sp, sc = _sym_pattern(a)
    return symbolic.nd_ordering(a.rows, sp, sc, leaf=leaf)


def chol_fill(a: CSR, perm: np.ndarray = None) -> int:
    """Predicted Cholesky factor nnz of A under ``perm`` (symbolic only)."""
    sp, sc = _sym_pattern(a)
    n = a.rows
    if perm is not None:
        inv = np.empty_like(perm)
        inv[perm] = np.arange(n)
        rows = np.repeat(inv, np.diff(sp))
        cols = inv[sc]
    else:
        rows = np.repeat(np.arange(n), np.diff(sp))
        cols = sc
    low = cols < rows
    lp = np.zeros(n + 1, dtype=np.int64)
    np.add.at(lp[1:], rows[low], 1)
    lp = np.cumsum(lp)
    order = np.argsort(rows[low] * n + cols[low], kind="stable")
    _, l_indptr, _ = symbolic.chol_symbolic(n, lp, cols[low][order])
    return int(l_indptr[-1])


# The JAX package's bias towards RCM (its measured device-time finding on
# the TPU, kept so that both packages choose the same ordering; unmeasured
# on the H100): ND is chosen only when its fill is under this fraction of
# RCM's.
ND_FILL_FACTOR = 0.45


def best_permutation(a: CSR):
    """Ordering auto-choice by predicted factor fill, as in the JAX package:
    ND wins when its fill is < ``ND_FILL_FACTOR``× RCM's, RCM wins ties and
    moderate gaps, natural order wins only if it beats both outright.
    Returns ``(perm, name)`` with ``(None, 'natural')`` for the given
    order. An ordering that fails is left out of the choice."""
    fills = {"natural": chol_fill(a)}
    perms = {}
    for name, fn in (("rcm", rcm_permutation), ("nd", nd_permutation)):
        try:
            perms[name] = fn(a)
        except RuntimeError:
            continue
        fills[name] = chol_fill(a, perms[name])
    if "nd" in fills and fills["nd"] < ND_FILL_FACTOR * fills.get(
            "rcm", fills["natural"]):
        winner = "nd"
    elif "rcm" in fills and fills["rcm"] <= fills["natural"]:
        winner = "rcm"
    else:
        winner = min(fills, key=fills.get)
    return perms.get(winner), winner


def permute_symmetric(a: CSR, perm: np.ndarray) -> CSR:
    """P·A·Pᵀ: row/col i of the result is row/col ``perm[i]`` of ``a``."""
    check(a.rows == a.cols, NonSquareMatrix, "permute_symmetric needs square")
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.shape[0])
    indptr, indices, values = a.numpy()
    rows = np.repeat(np.arange(a.rows), np.diff(indptr))
    return CSR.from_coo_arrays(
        a.dims, inv[rows], inv[indices], values,
        sum_duplicates=False, drop_zeros=False, device=a.device,
    )


def apply_perm(x: torch.Tensor, perm, inverse: bool = False) -> torch.Tensor:
    """Permute the rows of ``x`` into (or out of) permuted space, on
    ``x``'s device. ``perm`` is a numpy array (inverted on the host and
    uploaded at each call) or an int64 tensor (gathered with on ``x``'s
    device; a prepared solver keeps both directions as tensors and never
    inverts)."""
    if isinstance(perm, torch.Tensor):
        perm = perm.to(device=x.device, dtype=torch.int64)
        if inverse:
            perm = torch.empty_like(perm).scatter_(
                0, perm, torch.arange(perm.shape[0], device=perm.device))
        return x[perm]
    perm = np.asarray(perm)
    if inverse:
        inv = np.empty_like(perm)
        inv[perm] = np.arange(perm.shape[0])
        perm = inv
    return x[torch.as_tensor(perm, dtype=torch.int64, device=x.device)]


def bandwidth(a: CSR) -> int:
    """Maximum |row − col| over stored entries."""
    indptr, indices, _ = a.numpy()
    if a.stored == 0:
        return 0
    rows = np.repeat(np.arange(a.rows), np.diff(indptr))
    return int(np.abs(rows - indices).max())
