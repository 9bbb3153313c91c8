"""QR decomposition and QR-iteration eigenvalues.

Counterpart of ``basic_sparse_matrix_tpu/models/qr.py`` and of the
reference's ``qr_decomp`` (Householder deflation) and ``eigen_values``
(unshifted QR iteration for a caller-chosen number of steps, no
convergence test). The operand is densified and factored by
``torch.linalg.qr`` (one call); the eigenvalue iteration is a Python loop,
on the card one CUDA graph per operand shape, dtype and iteration count.
Householder sign conventions differ between libraries, so Q and R are
defined up to the signs of R's rows, as in the reference, whose own test
asserts only the residual. Every product runs under
:func:`matmul_precision` (TF32 off).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from ..ops.csr import CSR
from ..runtime import graphs
from ..utils.config import default_device, matmul_precision
from ..utils.errors import IncorrectDimensions, NonSquareMatrix, check


def _check_densify_budget(a: CSR, op: str) -> None:
    """These are dense-delegation ops; refuse inputs whose densified form
    exceeds ``dense_dispatch_max_bytes`` instead of running out of memory
    inside ``todense()``."""
    from ..utils.config import get_config

    limit = get_config().dense_dispatch_max_bytes
    check(4 * a.rows * a.cols <= limit, IncorrectDimensions,
          f"{op}: densified operand {a.dims} needs {4 * a.rows * a.cols} "
          f"bytes > dense_dispatch_max_bytes={limit}; this op has no sparse "
          f"path (raise BSM_DENSE_DISPATCH_MAX_BYTES to override, or for "
          f"symmetric eigenvalues use models.lanczos.eigen_values_lanczos)")


def qr_dense(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reduced Householder QR in float32."""
    return torch.linalg.qr(a.to(torch.float32), mode="reduced")


DEFAULT_TSQR_BLOCK = 1024


def tsqr_dense(a: torch.Tensor, block_rows: int = DEFAULT_TSQR_BLOCK
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tall-skinny QR (TSQR): a batched Householder QR over row blocks
    (padded to a power-of-two count), a log2-depth tree of stacked (2n, n)
    R factorizations, then the tree's Q factors multiplied back down.

    Requires ``m >= n``; returns reduced (Q (m, n), R (n, n)). R's rows
    carry QR's usual sign ambiguity."""
    m, n = a.shape
    a = a.to(torch.float32)
    br = max(block_rows, n)
    B = -(-m // br)
    Bp = 1 << max(B - 1, 0).bit_length()          # pad blocks to a pow2
    a = torch.nn.functional.pad(a, (0, 0, 0, Bp * br - m))
    q0, r = torch.linalg.qr(a.reshape(Bp, br, n))  # (B, br, n), (B, n, n)
    tree = []
    nb = Bp
    while nb > 1:
        q2, r = torch.linalg.qr(r.reshape(nb // 2, 2 * n, n))
        tree.append(q2)                            # (nb/2, 2n, n)
        nb //= 2
    R = r[0]
    acc = torch.eye(n, dtype=torch.float32, device=a.device)[None]
    with matmul_precision():
        for q2 in reversed(tree):
            acc = torch.matmul(q2, acc).reshape(-1, n, n)   # (2P, n, n)
        Q = torch.matmul(q0, acc).reshape(Bp * br, n)[:m]
    return Q, R


def _as_dense(a) -> torch.Tensor:
    if isinstance(a, CSR):
        return a.todense()
    if isinstance(a, torch.Tensor):
        return a
    return torch.as_tensor(np.asarray(a), device=default_device())


def tsqr(a, block_rows: int = DEFAULT_TSQR_BLOCK
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """TSQR of a tall operand (CSR or dense array) — see
    :func:`tsqr_dense`. Sparse operands densify (Q is inherently dense)."""
    arr = _as_dense(a)
    check(arr.shape[0] >= arr.shape[1], IncorrectDimensions,
          f"tsqr needs rows >= cols, got {tuple(arr.shape)}")
    return tsqr_dense(arr, block_rows)


# The JAX package's TSQR routing threshold (rows >= 4096 · cols), kept so
# that qr_decomp routes as the reference does; unmeasured on the H100.
TSQR_MIN_ASPECT = 4096


def qr_decomp(a: CSR) -> Tuple[CSR, CSR]:
    """QR of a CSR matrix — the reference ``qr_decomp``. Returns (Q, R) as
    CSR on ``a``'s device (re-sparsified on the host, exact zeros
    dropped). Operands with rows >= ``TSQR_MIN_ASPECT`` · cols go through
    :func:`tsqr_dense`, the rest through one Householder QR."""
    _check_densify_budget(a, "qr_decomp")
    dense = a.todense()
    if a.rows >= TSQR_MIN_ASPECT * a.cols:
        q, r = tsqr_dense(dense)
    else:
        q, r = qr_dense(dense)
    return (CSR.from_dense(q, device=a.device),
            CSR.from_dense(r, device=a.device))


class _Programs:
    """The owner of the QR iteration's graphs (one for the module)."""


_QR_ITERATION = _Programs()


def eigen_values_dense(a: torch.Tensor, iterations: int) -> torch.Tensor:
    """Unshifted QR iteration: ``A ← R Q`` repeated ``iterations`` times,
    then the diagonal — the reference ``eigen_values``. On the card the
    loop is one CUDA graph per operand shape, dtype and ``iterations``
    (``runtime/graphs.py``, keyed as ``jax.jit`` caches), captured on the
    second such call and replayed on every later one."""
    return graphs.run(_QR_ITERATION, ("qr_eig", iterations)
                      + graphs.host_state(),
                      functools.partial(_qr_iterate, iterations), a,
                      capture_on=2)


def _qr_iterate(iterations: int, a: torch.Tensor) -> torch.Tensor:
    working = a.to(torch.float32)
    with matmul_precision():
        for _ in range(iterations):
            q, r = torch.linalg.qr(working)
            working = torch.matmul(r, q)
    return torch.diagonal(working)


def eigen_values(a: CSR, iterations: int) -> torch.Tensor:
    check(a.rows == a.cols, NonSquareMatrix,
          f"eigen_values requires square matrix, got {a.dims}")
    _check_densify_budget(a, "eigen_values")
    return eigen_values_dense(a.todense(), iterations)


def eigen_values_sym_dense(a: torch.Tensor) -> torch.Tensor:
    """Symmetric fast path: ``eigvalsh`` instead of QR iteration, the exact
    spectrum in one call (ascending). The input is symmetrised first, as
    ``jnp.linalg.eigvalsh`` does."""
    a = a.to(torch.float32)
    return torch.linalg.eigvalsh((a + a.mT) / 2)


def eigen_values_sym(a: CSR) -> torch.Tensor:
    """Eigenvalues of a symmetric CSR matrix via ``eigvalsh`` (the converged
    answer the reference's unshifted QR iteration approaches)."""
    check(a.rows == a.cols, NonSquareMatrix,
          f"eigen_values_sym requires square matrix, got {a.dims}")
    _check_densify_budget(a, "eigen_values_sym")
    return eigen_values_sym_dense(a.todense())
