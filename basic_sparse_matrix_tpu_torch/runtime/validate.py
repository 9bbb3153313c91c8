"""Validation and failure-detection utilities.

Counterpart of ``basic_sparse_matrix_tpu/runtime/validate.py``:
construction-time structural validation of a CSR, finite-value checks for
numeric phases (a Cholesky of a matrix that is not SPD gives NaN, as in the
reference; :func:`check_spd_result` turns that into a typed error when
wanted), and :func:`checkified`, the guard around a long-running function.
All checks run on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.csr import CSR
from ..utils.errors import IncorrectDimensions, MatErr, check


class NumericalError(MatErr):
    """NaN/Inf detected where a finite result was required."""


def validate_csr(a: CSR, *, require_sorted: bool = True,
                 allow_duplicates: bool = True) -> None:
    """Structural invariants: indptr monotone with correct endpoints,
    indices in range, rows sorted (optionally strictly)."""
    indptr, indices, values = a.numpy()
    check(indptr.shape[0] == a.rows + 1, IncorrectDimensions,
          f"indptr length {indptr.shape[0]} != rows+1")
    check(int(indptr[0]) == 0 and int(indptr[-1]) == a.stored,
          IncorrectDimensions, "indptr endpoints invalid")
    check(bool((np.diff(indptr) >= 0).all()), IncorrectDimensions,
          "indptr not monotone")
    check(indices.shape[0] == values.shape[0] == a.stored,
          IncorrectDimensions, "indices/values length mismatch")
    if a.stored:
        check(bool((indices >= 0).all() and (indices < a.cols).all()),
              IncorrectDimensions, "column index out of range")
    if require_sorted and a.stored:
        rows = np.repeat(np.arange(a.rows), np.diff(indptr))
        keys = rows.astype(np.int64) * a.cols + indices
        diffs = np.diff(keys)
        ok = (diffs >= 0).all() if allow_duplicates else (diffs > 0).all()
        check(bool(ok), IncorrectDimensions, "entries not row-major sorted")


def _host(x) -> np.ndarray:
    if isinstance(x, CSR):
        x = x.values
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def check_finite(x, what: str = "result") -> None:
    """Raise :class:`NumericalError` if ``x`` (tensor, array or CSR)
    contains NaN/Inf."""
    arr = _host(x)
    if not np.isfinite(arr).all():
        bad = int((~np.isfinite(arr)).sum())
        raise NumericalError(f"{what} contains {bad} non-finite values")


def check_spd_result(l: CSR) -> CSR:
    """Validate a Cholesky factor: finite with positive diagonal."""
    check_finite(l, "cholesky factor")
    indptr, indices, values = l.numpy()
    rows = np.repeat(np.arange(l.rows), np.diff(indptr))
    diag = np.zeros(min(l.rows, l.cols), dtype=values.dtype)
    on = rows == indices
    np.add.at(diag, rows[on], values[on])
    if not (diag > 0).all():
        raise NumericalError(
            "cholesky factor has non-positive diagonal (input not SPD?)"
        )
    return l


class CheckResult:
    """What :func:`checkified` found: ``get()`` is the message or ``None``,
    ``throw()`` raises :class:`NumericalError` if there is one (the two
    calls of ``checkify``'s error object)."""

    def __init__(self, message=None):
        self.message = message

    def get(self):
        return self.message

    def throw(self) -> None:
        if self.message is not None:
            raise NumericalError(self.message)


def checkified(fn):
    """Wrap a function with NaN/Inf checks of its result; the wrapped
    function returns ``(err, out)`` with ``err`` a :class:`CheckResult`.

    The JAX package wraps ``jax.experimental.checkify`` here because a
    jitted program cannot raise; PyTorch runs eagerly, so every floating
    tensor, array or CSR of the result is checked on the host after the
    call, and ``err.throw()`` raises the same :class:`NumericalError` as
    :func:`check_finite`."""

    def leaves(out):
        if isinstance(out, (tuple, list)):
            for o in out:
                yield from leaves(o)
        elif isinstance(out, dict):
            for o in out.values():
                yield from leaves(o)
        elif isinstance(out, (CSR, torch.Tensor, np.ndarray)):
            yield out

    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        for leaf in leaves(out):
            arr = _host(leaf)
            if arr.dtype.kind in "fc" and not np.isfinite(arr).all():
                bad = int((~np.isfinite(arr)).sum())
                return CheckResult(
                    f"{getattr(fn, '__name__', 'result')} contains {bad} "
                    f"non-finite values"), out
        return CheckResult(), out

    return wrapped
