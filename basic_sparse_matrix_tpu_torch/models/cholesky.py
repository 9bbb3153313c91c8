"""Cholesky factorization.

Counterpart of ``basic_sparse_matrix_tpu/models/cholesky.py`` and of the
reference's ``cholesky_decomp`` (a scalar Cholesky–Banachiewicz loop whose
factor's sparsity is a storage property only).

* :func:`cholesky_dense` — the dense factor in float32, with the JAX
  package's semantics: the input is symmetrised first, and a matrix that is
  not positive definite gives NaN in its lower triangle (per batch member)
  instead of raising.
* :func:`cholesky` — CSR → CSR: densify, factor, re-sparsify on the host
  with exact zeros dropped.
* :func:`cholesky_auto` — the JAX package's ladder: dense, then banded,
  then supernodal, then the scatter-list factorization.

Like the reference, nothing checks positive-definiteness up front.
"""

from __future__ import annotations

import torch

from ..ops.csr import CSR
from ..utils.config import matmul_precision
from ..utils.errors import NonSquareMatrix, check


def cholesky_dense(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of a dense SPD matrix, or of each matrix of a
    batch (..., n, n), in float32. As ``jnp.linalg.cholesky``: the input is
    symmetrised, ``(a + aᵀ) / 2``, and a member that is not positive
    definite comes back NaN below and on its diagonal, zero above."""
    a = a.to(torch.float32)
    with matmul_precision():
        l, info = torch.linalg.cholesky_ex((a + a.mT) / 2)
    nan = torch.tril(torch.full(l.shape[-2:], float("nan"), dtype=l.dtype,
                                device=l.device))
    return torch.where((info != 0)[..., None, None], nan, l)


def cholesky(a: CSR) -> CSR:
    """CSR → CSR lower Cholesky factor — the reference ``cholesky_decomp``
    including its ``NonSquareMatrix`` error; on ``a``'s device."""
    check(a.rows == a.cols, NonSquareMatrix,
          f"cholesky requires square matrix, got {a.dims}")
    return CSR.from_dense(cholesky_dense(a.todense()), device=a.device)


# Parity alias matching the reference method name.
cholesky_decomp = cholesky


def cholesky_auto(a: CSR) -> CSR:
    """The dense path for small or dense-ish ``a``; for large sparse SPD
    matrices the banded block-tridiagonal scan when the given-order band is
    narrow (no reordering, as the reference factors in the given order),
    the supernodal panels when they amalgamate (average width >= 2), else
    the scatter-list factorization."""
    check(a.rows == a.cols, NonSquareMatrix,
          f"cholesky requires square matrix, got {a.dims}")
    from ..utils.config import get_config
    from . import banded as _bd
    from . import sparse_cholesky as _sc
    from . import supernodal as _sn

    cfg = get_config()
    if (a.rows <= cfg.dense_cholesky_max_n
            or a.get_density() > cfg.dense_cholesky_min_density):
        return cholesky(a)
    nb = _bd.banded_block_choice(a)
    if nb is not None:
        return _bd.assemble_factor_csr(_bd.factor_banded(a, nb))
    width, _ = _sn.supernode_stats(a, relax=cfg.supernodal_relax)
    if width >= 2.0:
        sched = _sn.analyze_supernodal(a, relax=cfg.supernodal_relax)
        # sched gives the (relaxed, expanded) pattern lvals aligns with
        return _sn.assemble_factor(
            a, _sn.factorize_supernodal(sched, a.values), sched)
    return _sc.cholesky_sparse(a)
