"""Preconditioned conjugate gradient with an IC(0) preconditioner.

Counterpart of ``basic_sparse_matrix_tpu/models/pcg.py``, built from the
port's own parts:

* SpMV: the ELL gather + row reduce when the padding overhead permits
  (``ell_max_overhead``), else the gather/segment sum (``ops/spmm.spmv``);
* preconditioner: the IC(0) factor from the scatter-list Cholesky
  (``models/sparse_cholesky.analyze(incomplete=True)``);
* its application: two level-scheduled triangular solves per iteration
  (``models/sparse_triangular``).

The JAX package's ``lax.while_loop`` is a Python loop here with the same
stopping rule (``‖r‖/‖b‖ > tol`` in float32 and ``it < max_iters``):
reading ‖r‖ synchronises the host with the device once per iteration.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.csr import CSR
from ..ops.ell import ELL
from ..utils.errors import NonSquareMatrix, check
from . import sparse_cholesky as sc
from .sparse_triangular import (
    TriangularSchedule,
    build_schedule,
    solve_triangular_sparse,
)


@dataclasses.dataclass(eq=False)
class PCGSetup:
    """Host-side preparation: IC(0) factor, both triangular schedules, and
    (when the padding overhead permits) an ELL view of A for the
    per-iteration matvec."""

    a: CSR
    fwd: TriangularSchedule
    bwd: TriangularSchedule
    ell: Optional[ELL] = None

    @staticmethod
    def build(a: CSR) -> "PCGSetup":
        check(a.rows == a.cols, NonSquareMatrix, f"pcg needs square {a.dims}")
        sched = sc.analyze(a, incomplete=True)
        return PCGSetup.from_factor(
            a, sc.csc_to_csr_l(sched, sc.factorize(sched, a.values)))

    @staticmethod
    def from_factor(a: CSR, l: CSR) -> "PCGSetup":
        """The set-up for ``a`` with the lower-triangular preconditioner
        factor ``l`` (``M = L Lᵀ``)."""
        from ..ops.ell import csr_to_ell, ell_overhead
        from ..utils.config import get_config

        ell = None
        if a.stored and ell_overhead(a) <= get_config().ell_max_overhead:
            ell = csr_to_ell(a)
        return PCGSetup(a=a, fwd=build_schedule(l, lower=True),
                        bwd=build_schedule(l.transpose(), lower=False),
                        ell=ell)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        if self.ell is not None:
            from ..ops.ell import spmv_ell

            return spmv_ell(self.ell, x)
        from ..ops.spmm import spmv

        return spmv(self.a, x)

    def apply_m_inv(self, r: torch.Tensor) -> torch.Tensor:
        """``(L Lᵀ)⁻¹ r``: the backward schedule is already mirrored inside
        ``solve_triangular_sparse``."""
        y = solve_triangular_sparse(None, r, self.fwd)
        return solve_triangular_sparse(None, y, self.bwd, lower=False)


def _pcg_loop(setup: PCGSetup, b: torch.Tensor, tol: float,
              max_iters: int):
    x = torch.zeros_like(b)
    r = b
    z = setup.apply_m_inv(r)
    p = z
    rz = torch.dot(r, z)
    bnorm = torch.linalg.norm(b).clamp_min(1e-30)
    it = 0
    # tol compares in float32, as the JAX package's jnp.float32(tol)
    while it < max_iters and bool(torch.linalg.norm(r) / bnorm > tol):
        ap = setup.matvec(p)
        alpha = rz / torch.dot(p, ap).clamp_min(1e-30)
        x = x + alpha * p
        r = r - alpha * ap
        z = setup.apply_m_inv(r)
        rz_new = torch.dot(r, z)
        beta = rz_new / rz.clamp_min(1e-30)
        p = z + beta * p
        rz = rz_new
        it += 1
    return x, it, torch.linalg.norm(r) / bnorm


def pcg_solve(a: CSR, b, *, tol: float = 1e-6, max_iters: int = 1000,
              setup: Optional[PCGSetup] = None
              ) -> Tuple[torch.Tensor, int, float]:
    """Solve ``A x = b`` (SPD, ``b`` a vector) by IC(0)-preconditioned CG
    on ``a``'s device. Returns (x, iterations, final relative residual).
    Pass a prebuilt ``setup`` to amortise the symbolic work across
    solves."""
    if setup is None:
        setup = PCGSetup.build(a)
    if not isinstance(b, torch.Tensor):
        b = torch.as_tensor(np.asarray(b))
    b = b.to(device=setup.a.device, dtype=torch.float32)
    x, it, res = _pcg_loop(setup, b, tol, max_iters)
    return x, it, float(res)
