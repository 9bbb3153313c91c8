"""Chebyshev semi-iterative solver — the dot-product-free companion to CG.

Counterpart of ``basic_sparse_matrix_tpu/models/chebyshev.py``. Every
iteration is one SpMV plus axpys and no inner product; the price is the
spectral interval [λ_min, λ_max] up front, which comes from the port's
Lanczos (``models/lanczos.py``). With θ = (λ_max+λ_min)/2,
δ = (λ_max−λ_min)/2, σ₁ = θ/δ:

    ρ₀ = 1/σ₁,  d₀ = r₀/θ
    x ← x + d;  r ← r − A d
    ρ_k = 1/(2σ₁ − ρ_{k−1})
    d ← ρ_k ρ_{k−1} d + (2ρ_k/δ) r

The scalars are float32 tensors on the device, as in the JAX package; the
fixed iteration count is a Python loop that reads nothing back until the
final residual. On the card the whole loop is one captured CUDA graph,
replayed on every later solve with the same setup, iteration count and
shape (the JAX package's ``fori_loop`` under ``jax.jit``).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.csr import CSR
from ..runtime import graphs
from ..utils.errors import NonSquareMatrix, check
from .lanczos import LanczosSetup, _matvec, eigen_values_lanczos


def spectral_bounds(a: CSR, k: int = 32, *,
                    setup: Optional[LanczosSetup] = None,
                    seed: int = 0) -> Tuple[float, float]:
    """A safe [λ_min, λ_max] interval from k-step Lanczos. Ritz values lie
    inside the true extremes, so the interval is widened: λ_max by 1%,
    λ_min toward zero by 5%."""
    ritz = eigen_values_lanczos(a, k, setup=setup, seed=seed)
    lo, hi = float(ritz[0]), float(ritz[-1])
    if lo <= 0.0:
        raise ValueError(
            f"chebyshev needs SPD: smallest Ritz value {lo} <= 0")
    return 0.95 * lo, 1.01 * hi


def _cheby_loop(setup: LanczosSetup, b: torch.Tensor, lam_min: float,
                lam_max: float, iters: int):
    """``iters`` iterations; on the card one captured graph per (setup,
    iters, shape), the bounds in its static device scalars
    (``runtime/graphs.py``)."""
    f32 = dict(dtype=torch.float32, device=b.device)
    return graphs.run(setup, ("chebyshev", iters),
                      functools.partial(_cheby_iterate, setup, iters), b,
                      torch.tensor(lam_min, **f32),
                      torch.tensor(lam_max, **f32))


def _cheby_iterate(setup: LanczosSetup, iters: int, b: torch.Tensor,
                   lam_min: torch.Tensor, lam_max: torch.Tensor):
    theta = (lam_max + lam_min) / 2.0
    delta = ((lam_max - lam_min) / 2.0).clamp_min(1e-30)
    sigma1 = theta / delta

    x = torch.zeros_like(b)
    r = b
    d = r / theta
    rho = 1.0 / sigma1
    for _ in range(iters):
        x = x + d
        r = r - _matvec(setup, d)
        rho_new = 1.0 / (2.0 * sigma1 - rho)
        d = rho_new * rho * d + (2.0 * rho_new / delta) * r
        rho = rho_new
    bnorm = torch.linalg.norm(b).clamp_min(1e-30)
    return x, torch.linalg.norm(r) / bnorm


def chebyshev_solve(a: CSR, b, *, iters: int = 100,
                    bounds: Optional[Tuple[float, float]] = None,
                    lanczos_k: int = 32,
                    setup: Optional[LanczosSetup] = None
                    ) -> Tuple[torch.Tensor, float]:
    """Solve SPD ``A x = b`` by Chebyshev semi-iteration on ``a``'s device.
    Returns (x, final relative residual). ``bounds`` = (λ_min, λ_max); when
    omitted they are estimated by :func:`spectral_bounds` (one Lanczos run,
    amortised via ``setup`` across solves)."""
    check(a.rows == a.cols, NonSquareMatrix,
          f"chebyshev_solve needs square matrix, got {a.dims}")
    if setup is None:
        setup = LanczosSetup.build(a)
    if bounds is None:
        bounds = spectral_bounds(a, lanczos_k, setup=setup)
    if not isinstance(b, torch.Tensor):
        b = torch.as_tensor(np.asarray(b))
    b = b.to(device=a.device, dtype=torch.float32)
    x, res = _cheby_loop(setup, b, bounds[0], bounds[1], iters)
    return x, float(res)
