"""Banded (block-tridiagonal) SPD Cholesky factorization and solve.

Counterpart of ``basic_sparse_matrix_tpu/models/banded.py``, with the JAX
package's dispatch thresholds, so that the port's ``DirectSolver`` sees the
same tier choice as the reference.

After a banded ordering (RCM, or a matrix that is banded as given),
``a[i, j] == 0`` for ``|i - j| > bw``. Blocks of ``nb >= bw`` rows make A
block-tridiagonal (diagonal blocks ``D[i]``, subdiagonal blocks ``E[i]``
coupling block ``i+1`` to block ``i``), and Cholesky keeps the band:

    L_0 = chol(D_0)
    F_{i-1} = E_{i-1} · L_{i-1}^{-T}          (triangular solve)
    L_i = chol(D_i − F_{i-1} F_{i-1}ᵀ)

The JAX package runs the m block rows as one ``lax.scan``; here they are a
Python loop of the same (nb, nb) steps, every product under
:func:`matmul_precision` (TF32 off). Both triangular solves are
block-bidiagonal loops, on the card replayed as one CUDA graph per factor
and right-hand-side shape. The tail block is padded with an identity diagonal
so every step has the same shape; padded rows of the right-hand side are
zero and decouple.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..ops.csr import CSR, to_tensor
from ..ops.reorder import bandwidth
from ..runtime import graphs
from ..utils.config import matmul_precision
from ..utils.errors import IncorrectDimensions, NonSquareMatrix, check
from .cholesky import cholesky_dense


def block_size_for(bw: int, n: int | None = None) -> int:
    """Multiple-of-8 block size covering half-bandwidth ``bw``, floored so
    that a narrow band still takes at most ~128 block steps."""
    nb = max(8, -(-max(bw, 1) // 8) * 8)
    if n is not None:
        target = -(-n // 128)                # block size for ~128 scan steps
        target = -(-target // 8) * 8         # rounded up to the 8-alignment
        nb = max(nb, min(target, 128))
    return nb


def banded_block_choice(a: CSR) -> int | None:
    """The block size of the banded tier for ``a``, or ``None`` when the
    band is too wide, its storage too large, or the block rows too few."""
    from ..utils.config import get_config

    cfg = get_config()
    if cfg.banded_max_block <= 0:
        return None
    nb = block_size_for(bandwidth(a), a.rows)
    if nb > cfg.banded_max_block:
        return None
    if 8 * a.rows * nb > cfg.banded_max_bytes:  # 2 blocks/row · nb² · 4 B
        return None
    if a.rows < nb * cfg.banded_min_steps:
        return None
    return nb


@dataclasses.dataclass(eq=False)
class BandedFactor:
    """Block-bidiagonal Cholesky factor: ``L[i]`` (nb, nb) lower-triangular
    diagonal blocks, ``F[i]`` (nb, nb) subdiagonal blocks coupling block
    ``i+1`` to block ``i``. Trailing pad rows carry an identity diagonal."""

    L: torch.Tensor  # (m, nb, nb)
    F: torch.Tensor  # (m-1, nb, nb)
    n: int

    @property
    def nb(self) -> int:
        return int(self.L.shape[1])

    @property
    def m(self) -> int:
        return int(self.L.shape[0])


def band_blocks(a: CSR, nb: int):
    """Host: block-tridiagonal (D, E) numpy blocks of symmetric banded A.

    ``D[i]`` is the i-th (nb, nb) diagonal block (full symmetric), ``E[i]``
    the subdiagonal block coupling block i+1 to block i. Requires
    ``bandwidth(a) <= nb``; raises ``IncorrectDimensions`` otherwise."""
    check(a.rows == a.cols, NonSquareMatrix, "band_blocks needs square A")
    n = a.rows
    m = -(-n // nb)
    indptr, indices, values = a.numpy()
    rows = np.repeat(np.arange(n), np.diff(indptr))
    cols = indices
    bi, bj = rows // nb, cols // nb
    check(bool(np.all(np.abs(bi - bj) <= 1)), IncorrectDimensions,
          f"band_blocks: entries outside block-tridiagonal band (nb={nb})")
    D = np.zeros((m, nb, nb), dtype=np.float32)
    E = np.zeros((max(m - 1, 0), nb, nb), dtype=np.float32)
    diag = bi == bj
    D[bi[diag], rows[diag] % nb, cols[diag] % nb] = values[diag]
    sub = bi == bj + 1
    E[bj[sub], rows[sub] % nb, cols[sub] % nb] = values[sub]
    # pad tail rows with a decoupled identity so chol stays defined
    r = np.arange(n, m * nb)
    D[m - 1, r % nb, r % nb] = 1.0
    return D, E


def cholesky_banded_blocks(D: torch.Tensor, E: torch.Tensor):
    """Block-tridiagonal Cholesky: a loop over the m block rows (the JAX
    package's ``lax.scan``). Returns (L (m, nb, nb), F (m-1, nb, nb))."""
    with matmul_precision():
        ls = [cholesky_dense(D[0])]
        fs = []
        for d, e in zip(D[1:], E):
            # F = E · L_prevᵀ⁻¹: solve L_prev Yᵀ = Eᵀ, F = Y
            f = torch.linalg.solve_triangular(ls[-1], e.mT, upper=False).mT
            ls.append(cholesky_dense(d - f @ f.mT))
            fs.append(f)
    return torch.stack(ls), (torch.stack(fs) if fs else E[:0].clone())


def solve_banded_blocks(L: torch.Tensor, F: torch.Tensor,
                        b: torch.Tensor) -> torch.Tensor:
    """Solve ``(L Lᵀ) x = b`` with block-bidiagonal L; ``b`` is (m, nb, k)."""
    tri = torch.linalg.solve_triangular
    with matmul_precision():
        ys = [tri(L[0], b[0], upper=False)]
        for l, f, bi in zip(L[1:], F, b[1:]):
            ys.append(tri(l, bi - f @ ys[-1], upper=False))
        xs = [tri(L[-1].mT, ys[-1], upper=True)]
        for l, f, yi in zip(reversed(L[:-1]), reversed(F), reversed(ys[:-1])):
            xs.append(tri(l.mT, yi - f.mT @ xs[-1], upper=True))
    return torch.stack(xs[::-1])


def factor_banded(a: CSR, nb: int | None = None) -> BandedFactor:
    """Factor a symmetric banded SPD CSR into a :class:`BandedFactor` on
    ``a``'s device."""
    if nb is None:
        nb = block_size_for(bandwidth(a))
    D, E = band_blocks(a, nb)
    L, F = cholesky_banded_blocks(to_tensor(D, a.device),
                                  to_tensor(E, a.device))
    return BandedFactor(L=L, F=F, n=a.rows)


def _blocked_rhs(b, n: int, m: int, nb: int, device):
    """``b`` as float32 (m, nb, k) blocks on ``device`` (zero pad rows), and
    whether it was a vector."""
    if not isinstance(b, torch.Tensor):
        b = torch.as_tensor(np.asarray(b))
    b = b.to(device=device, dtype=torch.float32)
    squeeze = b.ndim == 1
    if squeeze:
        b = b[:, None]
    check(b.shape[0] == n, IncorrectDimensions,
          f"banded solve: A n={n} vs b {tuple(b.shape)}")
    b = torch.nn.functional.pad(b, (0, 0, 0, m * nb - n))
    return b.reshape(m, nb, b.shape[1]), squeeze


def solve_factored_banded(fac: BandedFactor, b) -> torch.Tensor:
    """Solve ``A x = b`` from a prepared :class:`BandedFactor`. On the card
    the two block scans replay one CUDA graph per factor and right-hand
    side shape, captured on the first call (``runtime/graphs.py``; the JAX
    package's jitted ``solve_banded_blocks``); the blocking of ``b`` runs
    outside it."""
    blocks, squeeze = _blocked_rhs(b, fac.n, fac.m, fac.nb, fac.L.device)
    x = graphs.run(fac, ("banded",) + graphs.host_state(),
                   functools.partial(solve_banded_blocks, fac.L, fac.F),
                   blocks)
    x = x.reshape(fac.m * fac.nb, -1)[: fac.n]
    return x[:, 0] if squeeze else x


def solve_banded(a: CSR, b, nb: int | None = None) -> torch.Tensor:
    """Factor + solve for symmetric banded SPD ``A`` (no reordering)."""
    return solve_factored_banded(factor_banded(a, nb), b)


def assemble_factor_csr(fac: BandedFactor) -> CSR:
    """Host: lay the block factor into a lower-triangular CSR on the
    factor's device (exact zeros dropped, as the dense path stores it)."""
    L = fac.L.cpu().numpy()
    F = fac.F.cpu().numpy()
    m, nb, n = fac.m, fac.nb, fac.n
    tr, tc = np.tril_indices(nb)
    fr, fc = np.unravel_index(np.arange(nb * nb), (nb, nb))
    base = np.arange(m)[:, None] * nb
    rows = np.concatenate([(base + tr).ravel(), (base[1:] + fr).ravel()])
    cols = np.concatenate([(base + tc).ravel(), (base[:-1] + fc).ravel()])
    vals = np.concatenate([L[:, tr, tc].ravel(), F.reshape(-1)])
    keep = (rows < n) & (cols < n)
    return CSR.from_coo_arrays((n, n), rows[keep], cols[keep], vals[keep],
                               sum_duplicates=False, drop_zeros=True,
                               device=fac.L.device)
