"""Lanczos eigensolver for large sparse symmetric matrices.

Counterpart of ``basic_sparse_matrix_tpu/models/lanczos.py``: extremal
eigenvalues without densifying (the reference's ``eigen_values`` is a
dense QR iteration, ``models/qr.py``). The only touch of A is one SpMV per
step (the ELL gather + row reduce when the padding overhead permits, as in
PCG); the rest is (k, n) × (n,) products under :func:`matmul_precision`.

* k steps as a Python loop (the JAX package's ``lax.scan``); nothing is
  read back to the host inside the loop. On the card the k steps are one
  CUDA graph per set-up, k and start-vector shape, captured on the second
  call and replayed on every later one (``runtime/graphs.py``); the Ritz
  values' ``eigvalsh`` runs outside it (torch reads its status on the
  host).
* Full reorthogonalisation every step: classical Gram-Schmidt twice against
  the stored basis (CGS2). Rows of V beyond the current step are zero and
  project to zero.
* Breakdown (β <= 1e-7·max(|α|, 1): an invariant subspace was found): β is
  stored as 0, so T decouples, and the basis restarts from the same
  deterministic vector as the JAX package, ``sin((i + 1)·(1 + j))``,
  re-projected against the basis.
* The Ritz values are ``eigvalsh`` of the k×k tridiagonal T.

The start vector is drawn from a ``torch.Generator`` seeded with ``seed``
on ``a``'s device; the JAX package draws it from ``PRNGKey(seed)``, which
torch cannot reproduce, so the two packages agree on Ritz values given the
same ``v0`` (``_ritz_values``), not given the same seed.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch

from ..ops.csr import CSR
from ..ops.ell import ELL
from ..runtime import graphs
from ..utils.config import matmul_precision
from ..utils.errors import NonSquareMatrix, check


@dataclasses.dataclass(eq=False)
class LanczosSetup:
    """Keeps A, and an ELL view when the padding overhead permits so each
    step's SpMV is the gather + row reduce."""

    a: CSR
    ell: Optional[ELL] = None

    @staticmethod
    def build(a: CSR) -> "LanczosSetup":
        check(a.rows == a.cols, NonSquareMatrix,
              f"lanczos needs square matrix, got {a.dims}")
        from ..ops.ell import csr_to_ell, ell_overhead
        from ..utils.config import get_config

        ell = None
        if a.stored and ell_overhead(a) <= get_config().ell_max_overhead:
            ell = csr_to_ell(a)
        return LanczosSetup(a=a, ell=ell)


def _matvec(setup: LanczosSetup, x: torch.Tensor) -> torch.Tensor:
    if setup.ell is not None:
        from ..ops.ell import spmv_ell

        return spmv_ell(setup.ell, x)
    from ..ops.spmm import spmv

    return spmv(setup.a, x)


def _lanczos_scan(setup: LanczosSetup, v0: torch.Tensor, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """k Lanczos steps with full reorthogonalisation.

    Returns (alphas (k,), betas (k-1,), V (k, n)) with V the orthonormal
    Krylov basis. On the card the steps replay a graph owned by ``setup``
    from the second call with the same k and ``v0`` shape on."""
    return graphs.run(setup, ("lanczos", k) + graphs.host_state(),
                      functools.partial(_lanczos_steps, setup, k), v0,
                      capture_on=2)


def _lanczos_steps(setup: LanczosSetup, k: int, v0: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    n = v0.shape[0]
    v0 = v0.to(torch.float32)
    v0 = v0 / torch.linalg.norm(v0).clamp_min(1e-30)
    V = torch.zeros((k, n), dtype=torch.float32, device=v0.device)
    V[0] = v0
    ramp = torch.arange(n, dtype=torch.float32, device=v0.device) + 1.0
    alphas, betas = [], []

    def reproject(w):
        w = w - V.T @ (V @ w)
        return w - V.T @ (V @ w)

    with matmul_precision():
        for j in range(k):
            vj = V[j]
            w = _matvec(setup, vj)
            alpha = torch.dot(vj, w)
            w = reproject(w)
            beta = torch.linalg.norm(w)
            broke = beta <= 1e-7 * alpha.abs().clamp_min(1.0)
            fresh = reproject(torch.sin(ramp * (1.0 + j)))
            fresh = fresh / torch.linalg.norm(fresh).clamp_min(1e-30)
            v_next = torch.where(broke, fresh, w / beta.clamp_min(1e-30))
            alphas.append(alpha)
            betas.append(torch.where(broke, 0.0, beta))
            if j + 1 < k:
                V[j + 1] = v_next
    return torch.stack(alphas), torch.stack(betas)[:-1], V


def _ritz_values(setup: LanczosSetup, v0: torch.Tensor, k: int
                 ) -> torch.Tensor:
    alphas, betas, _ = _lanczos_scan(setup, v0, k)
    t = torch.diag(alphas)
    if k > 1:
        t = t + torch.diag(betas, 1) + torch.diag(betas, -1)
    return torch.linalg.eigvalsh(t)


def eigen_values_lanczos(a: CSR, k: int = 32, *,
                         setup: Optional[LanczosSetup] = None,
                         seed: int = 0) -> torch.Tensor:
    """k Ritz values (ascending) of symmetric ``a`` from a k-step fully
    reorthogonalised Lanczos run, on ``a``'s device. Extremal values
    converge first; at ``k == a.rows`` the full spectrum is exact up to
    float32 round-off. Pass a prebuilt ``setup`` to amortise the ELL
    conversion across calls."""
    if setup is None:
        setup = LanczosSetup.build(a)
    check(a.rows == a.cols, NonSquareMatrix,
          f"eigen_values_lanczos requires square matrix, got {a.dims}")
    k = int(min(k, a.rows))
    if k < 1:
        raise ValueError("eigen_values_lanczos: k must be >= 1")
    gen = torch.Generator(device=a.device).manual_seed(seed)
    v0 = torch.randn(a.rows, generator=gen, dtype=torch.float32,
                     device=a.device)
    return _ritz_values(setup, v0, k)


def extremal_eigen_values(a: CSR, k: int = 32, *,
                          setup: Optional[LanczosSetup] = None,
                          seed: int = 0) -> Tuple[float, float]:
    """(λ_min, λ_max) estimates — the first Ritz pair to converge."""
    ritz = eigen_values_lanczos(a, k, setup=setup, seed=seed)
    return float(ritz[0]), float(ritz[-1])


def condition_estimate(a: CSR, k: int = 32, *,
                       setup: Optional[LanczosSetup] = None,
                       seed: int = 0) -> float:
    """2-norm condition estimate λ_max/λ_min for SPD ``a``. Returns ``inf``
    when the smallest Ritz value is not resolved as positive (indefinite,
    or k too small)."""
    lo, hi = extremal_eigen_values(a, k, setup=setup, seed=seed)
    if lo <= 0.0:
        return float("inf")
    return hi / lo
