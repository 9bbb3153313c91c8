"""Block cyclic reduction (BCR) — an O(log m)-depth banded SPD solver.

Counterpart of ``basic_sparse_matrix_tpu/models/bcr.py``. The banded scan
(``models/banded.py``) takes m sequential block steps; cyclic reduction
eliminates every odd-indexed block of a level at once (one batched
Cholesky, batched triangular solves and batched products over m/2 blocks),
leaving a block-tridiagonal system of half the size: log2(m) batched
stages at about 4× the flops.

Level algebra (row i: ``E_{i-1} x_{i-1} + D_i x_i + E_iᵀ x_{i+1} = b_i``,
``E_i`` couples block i+1 to block i):

    x_o = D_o⁻¹ (b_o − E_{o−1} x_{o−1} − E_oᵀ x_{o+1})        (odd o)

substituted into the even rows gives the half-size system

    D'_k = D_{2k} − E_{2k−1} Wr_{k−1} − E_{2k}ᵀ Wl_k
    E'_k = −E_{2k+1} Wl_k
    b'_k = b_{2k} − E_{2k−1} z_{k−1} − E_{2k}ᵀ z_k

with ``Wl_k = D_{2k+1}⁻¹ E_{2k}``, ``Wr_k = D_{2k+1}⁻¹ E_{2k+1}ᵀ``,
``z_k = D_{2k+1}⁻¹ b_{2k+1}``. Everything independent of b (the factors of
the odd diagonal blocks, Wl, Wr and each level's coupling blocks) is the
factorization, computed once. The slicing (``E[0::2]``, ``E[1::2]``, the
zeroed last coupling, ``_shift_prev``) is the JAX package's; the level loop
is a Python loop over halving shapes, every product under
:func:`matmul_precision` (TF32 off).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from ..ops.csr import CSR, to_tensor
from ..runtime import graphs
from ..utils.config import matmul_precision
from .banded import _blocked_rhs, band_blocks, bandwidth, block_size_for
from .cholesky import cholesky_dense


def _mm(a, b):
    # callers hold matmul_precision()
    return torch.matmul(a, b)


def _chol_solve(l: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Batched SPD solve from batched Cholesky factors: (B,nb,nb)×(B,nb,k)."""
    y = torch.linalg.solve_triangular(l, rhs, upper=False)
    return torch.linalg.solve_triangular(l.mT, y, upper=True)


def _shift_prev(x):
    """x[k-1] with x[-1] = 0: prepend a zero block, drop the last."""
    return torch.cat([torch.zeros_like(x[:1]), x[:-1]], dim=0)


@dataclasses.dataclass(eq=False)
class BCRFactor:
    """Per-level b-independent elimination state (outermost level first).
    ``ls[p]``: Cholesky factors of the level-p odd diagonal blocks;
    ``wls[p]``/``wrs[p]``: substitution maps ``D⁻¹E_even`` / ``D⁻¹E_oddᵀ``;
    ``elefts[p]``/``erights[p]``: the level's coupling blocks (needed by
    the RHS reduction); ``l0``: the final single-block factor. ``n`` is the
    padded order (m_padded · nb), as in the JAX package."""

    ls: tuple
    wls: tuple
    wrs: tuple
    elefts: tuple
    erights: tuple
    l0: torch.Tensor
    n: int

    @property
    def nb(self) -> int:
        return int(self.l0.shape[0])

    @property
    def m_padded(self) -> int:
        return 2 * int(self.ls[0].shape[0]) if self.ls else 1


def _pad_pow2(D, E):
    """Pad D with identity blocks and E with zero couplings to the next
    power of two of block rows (E gets as many blocks as D)."""
    m, nb = int(D.shape[0]), int(D.shape[1])
    p = 1
    while p < m:
        p *= 2
    if p != m:
        eye = torch.eye(nb, dtype=D.dtype, device=D.device).expand(
            p - m, nb, nb)
        D = torch.cat([D, eye], dim=0)
    if int(E.shape[0]) != p:
        ez = torch.zeros((p - int(E.shape[0]), nb, nb), dtype=D.dtype,
                         device=D.device)
        E = torch.cat([E, ez], dim=0)
    return D, E


def factor_bcr(D: torch.Tensor, E: torch.Tensor) -> BCRFactor:
    """Eliminate odd blocks level by level, each level batched. ``D`` and
    ``E`` are already padded to a power of two of block rows
    (:func:`_pad_pow2`)."""
    m = int(D.shape[0])
    if m & (m - 1) or int(E.shape[0]) != m:
        raise ValueError(f"factor_bcr needs {m} = 2^j diagonal blocks and "
                         f"as many couplings, got {int(E.shape[0])}: pad "
                         f"with _pad_pow2")
    n = m * int(D.shape[1])
    ls, wls, wrs, elefts, erights = [], [], [], [], []
    with matmul_precision():
        while int(D.shape[0]) > 1:
            dodd = D[1::2]
            eleft = E[0::2]                    # E_{2k} (odd 2k+1 <- 2k)
            eright = E[1::2]                   # E_{2k+1} (2k+2 <- 2k+1)
            l = cholesky_dense(dodd)
            wl = _chol_solve(l, eleft)                        # D⁻¹ E_{2k}
            wr = _chol_solve(l, eright.mT)                    # D⁻¹ E_{2k+1}ᵀ
            ls.append(l), wls.append(wl), wrs.append(wr)
            elefts.append(eleft), erights.append(eright)
            D = (D[0::2] - _mm(_shift_prev(eright), _shift_prev(wr))
                 - _mm(eleft.mT, wl))
            E = -_mm(eright, wl)               # E'_k = -E_{2k+1} Wl_k
            E = torch.cat([E[:-1], torch.zeros_like(E[:1])], dim=0)
        l0 = cholesky_dense(D[0])
    return BCRFactor(ls=tuple(ls), wls=tuple(wls), wrs=tuple(wrs),
                     elefts=tuple(elefts), erights=tuple(erights), l0=l0,
                     n=n)


def solve_bcr(fac: BCRFactor, b: torch.Tensor) -> torch.Tensor:
    """Solve from a prepared factor; ``b`` is (m_padded, nb, k) blocks."""
    with matmul_precision():
        # forward: reduce the RHS level by level, keeping each level's z
        zs = []
        for l, eleft, eright in zip(fac.ls, fac.elefts, fac.erights):
            z = _chol_solve(l, b[1::2])
            zs.append(z)
            b = (b[0::2] - _mm(_shift_prev(eright), _shift_prev(z))
                 - _mm(eleft.mT, z))
        x = _chol_solve(fac.l0[None], b[0][None])          # (1, nb, k)
        # backward: interleave the recovered odd blocks at each level
        for wl, wr, z in zip(reversed(fac.wls), reversed(fac.wrs),
                             reversed(zs)):
            x_next = torch.cat([x[1:], torch.zeros_like(x[:1])], dim=0)
            x_odd = z - _mm(wl, x) - _mm(wr, x_next)
            x = torch.stack([x, x_odd], dim=1).reshape(
                2 * x.shape[0], *x.shape[1:])
    return x


def _tridiag_matvec(D: torch.Tensor, E: torch.Tensor,
                    x: torch.Tensor) -> torch.Tensor:
    """Block-tridiagonal A·x on (m, nb, k) blocks; E padded to length m with
    a zero last coupling."""
    with matmul_precision():
        t = _mm(E, x)                                # E_i x_i -> row i+1
        up = torch.cat([x[1:], torch.zeros_like(x[:1])], dim=0)
        return _mm(D, x) + _shift_prev(t) + _mm(E.mT, up)


def _solve_refined(fac: BCRFactor, D, E, blocks, steps: int = 1):
    """BCR solve plus ``steps`` residual-correction passes (one, as in the
    JAX package: the odd-even order costs a little float32 accuracy on
    ill-conditioned systems against the sequential scan)."""
    x = solve_bcr(fac, blocks)
    for _ in range(steps):
        r = blocks - _tridiag_matvec(D, E, x)
        x = x + solve_bcr(fac, r)
    return x


@dataclasses.dataclass(eq=False)
class BCRSolver:
    """Prepared BCR solver for one banded SPD matrix. Keeps the (padded)
    block operands for the refinement matvec."""

    fac: BCRFactor
    D: torch.Tensor
    E: torch.Tensor
    n: int
    nb: int

    def solve(self, b) -> torch.Tensor:
        """Solve ``A x = b``; ``b`` (n,) or (n, k). On the card the BCR
        solve and its refinement replay one CUDA graph per solver and
        right-hand-side shape, captured on the first call
        (``runtime/graphs.py``); the blocking and padding of ``b`` run
        outside it."""
        m = -(-self.n // self.nb)
        blocks, squeeze = _blocked_rhs(b, self.n, m, self.nb, self.D.device)
        mp = self.fac.m_padded
        if mp != m:
            blocks = torch.nn.functional.pad(blocks, (0, 0, 0, 0, 0, mp - m))
        x = graphs.run(self, ("bcr",) + graphs.host_state(),
                       functools.partial(_solve_refined, self.fac, self.D,
                                         self.E), blocks)
        x = x.reshape(mp * self.nb, -1)[: self.n]
        return x[:, 0] if squeeze else x


def bcr_from_blocks(D: torch.Tensor, E: torch.Tensor, n: int) -> BCRSolver:
    """Pad the (D, E) blocks of an order-``n`` matrix to a power of two of
    block rows, once, and factor them."""
    D, E = _pad_pow2(D, E)
    return BCRSolver(fac=factor_bcr(D, E), D=D, E=E, n=n,
                     nb=int(D.shape[1]))


def prepare_bcr(a: CSR, nb: int | None = None) -> BCRSolver:
    """Factor a symmetric banded SPD CSR for O(log m)-depth solves, on
    ``a``'s device."""
    if nb is None:
        nb = block_size_for(bandwidth(a), a.rows)
    D, E = band_blocks(a, nb)
    return bcr_from_blocks(to_tensor(D, a.device), to_tensor(E, a.device),
                           a.rows)
