"""Preconditioned conjugate gradient, with an IC(0) preconditioner by
default.

Counterpart of ``basic_sparse_matrix_tpu/models/pcg.py``, built from the
port's own parts:

* SpMV: the ELL gather + row reduce when the padding overhead permits
  (``ell_max_overhead``), else the gather/segment sum (``ops/spmm.spmv``);
* preconditioner: the IC(0) factor from the scatter-list Cholesky
  (``models/sparse_cholesky.analyze(incomplete=True)``);
* its application: two level-scheduled triangular solves per iteration
  (``models/sparse_triangular``).

The loop takes any set-up with :class:`PCGSetup`'s interface
(:class:`Preconditioned`: ``a``, ``matvec``, ``apply_m_inv``, ``timings``);
``models/multigrid.py``'s ``MultigridSetup`` (HPCG's V-cycle) is the other
one. The graphs are keyed on the set-up, so each has its own.

The JAX package's ``lax.while_loop`` keeps its stopping rule
(``‖r‖/‖b‖ > tol`` in float32 and ``it < max_iters``). On the CPU it is a
Python loop that reads ‖r‖ every iteration (:func:`_pcg_loop`). On the card
it runs in chunks of ``CHUNK`` iterations (or the set-up's own ``chunk``),
each a captured CUDA graph that evaluates the rule on the device and masks
the steps past the end; the host reads one flag per chunk
(:func:`_pcg_chunked`). Both take the same iterations to the same result.

The recorder (``runtime/profiling.py``) sees the start as the span
``bsm.pcg.start``, each chunk as ``bsm.pcg.chunk`` and each host read
(a chunk's flag, the iteration count, the residual; on the CPU each
iteration's test) as ``bsm.pcg.read`` and the counter ``pcg.host_reads``.
``PCGSetup.build``'s phases are the laps ``pcg.analyze``, ``pcg.numeric``,
``pcg.assemble``, ``pcg.schedules`` and ``pcg.ell``, in its ``timings``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Protocol, Tuple

import numpy as np
import torch

from ..ops.csr import CSR
from ..ops.ell import ELL
from ..runtime import graphs, profiling
from ..utils.errors import NonSquareMatrix, check
from . import sparse_cholesky as sc
from .sparse_triangular import (
    TriangularSchedule,
    build_schedule,
    solve_triangular_sparse,
)


class Preconditioned(Protocol):
    """What the loop takes of a set-up: the operator ``a`` (its device),
    ``matvec`` (A·x), ``apply_m_inv`` (M⁻¹·r, M symmetric positive
    definite) and the set-up laps ``timings``. A set-up must be hashable
    by identity: it owns the loop's graphs."""

    a: CSR
    timings: dict

    def matvec(self, x: torch.Tensor) -> torch.Tensor: ...

    def apply_m_inv(self, r: torch.Tensor) -> torch.Tensor: ...


def ell_view(a: CSR) -> Optional[ELL]:
    """``a``'s ELL layout where the padding overhead permits
    (``ell_max_overhead``), else None."""
    from ..ops.ell import csr_to_ell, ell_overhead
    from ..utils.config import get_config

    if a.stored and ell_overhead(a) <= get_config().ell_max_overhead:
        return csr_to_ell(a)
    return None


def spmv_with(a: CSR, ell: Optional[ELL], x: torch.Tensor) -> torch.Tensor:
    """``a·x`` through ``a``'s ELL view ``ell`` (:func:`ell_view`), or the
    gather/segment sum where it has none."""
    if ell is not None:
        from ..ops.ell import spmv_ell

        return spmv_ell(ell, x)
    from ..ops.spmm import spmv

    return spmv(a, x)


@dataclasses.dataclass(eq=False)
class PCGSetup:
    """Host-side preparation: IC(0) factor, both triangular schedules, and
    (when the padding overhead permits) an ELL view of A for the
    per-iteration matvec. ``timings`` holds the host-clock seconds of each
    set-up phase, each lap synchronised with the device: ``analyze``,
    ``numeric`` and ``assemble`` (the factor's CSR) from :meth:`build`,
    ``schedules`` (the two triangular-solve schedules) and ``ell``."""

    a: CSR
    fwd: TriangularSchedule
    bwd: TriangularSchedule
    ell: Optional[ELL] = None
    timings: dict = dataclasses.field(default_factory=dict)

    @staticmethod
    def build(a: CSR) -> "PCGSetup":
        check(a.rows == a.cols, NonSquareMatrix, f"pcg needs square {a.dims}")
        clock = profiling.Laps("pcg", a.device)
        sched = sc.analyze(a, incomplete=True)
        clock.lap("analyze")
        lvals = sc.factorize(sched, a.values)
        clock.lap("numeric")
        l = sc.csc_to_csr_l(sched, lvals)
        clock.lap("assemble")
        return PCGSetup._finish(a, l, clock)

    @staticmethod
    def from_factor(a: CSR, l: CSR) -> "PCGSetup":
        """The set-up for ``a`` with the lower-triangular preconditioner
        factor ``l`` (``M = L Lᵀ``)."""
        return PCGSetup._finish(a, l, profiling.Laps("pcg", a.device))

    @staticmethod
    def _finish(a: CSR, l: CSR, clock: profiling.Laps) -> "PCGSetup":
        fwd = build_schedule(l, lower=True)
        bwd = build_schedule(l.transpose(), lower=False)
        clock.lap("schedules")
        ell = ell_view(a)
        clock.lap("ell")
        return PCGSetup(a=a, fwd=fwd, bwd=bwd, ell=ell, timings=clock.out)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return spmv_with(self.a, self.ell, x)

    def apply_m_inv(self, r: torch.Tensor) -> torch.Tensor:
        """``(L Lᵀ)⁻¹ r``: the backward schedule is already mirrored inside
        ``solve_triangular_sparse``."""
        y = solve_triangular_sparse(None, r, self.fwd)
        return solve_triangular_sparse(None, y, self.bwd, lower=False)


def _pcg_start(setup: Preconditioned, b: torch.Tensor):
    """The loop's carry before the first iteration: (x, r, p, rz) and the
    clamped ‖b‖."""
    with profiling.span("bsm.pcg.start"):
        z = setup.apply_m_inv(b)
        return (torch.zeros_like(b), b, z, torch.dot(b, z),
                torch.linalg.norm(b).clamp_min(1e-30))


def _read(x: torch.Tensor, kind: type):
    """``kind(x)`` (``bool``, ``int`` or ``float``): a host read of a
    device value, which waits for the device."""
    profiling.count("pcg.host_reads")
    with profiling.span("bsm.pcg.read"):
        return kind(x)


def _pcg_step(setup: Preconditioned, x, r, p, rz):
    """One CG iteration: the new (x, r, p, rz)."""
    ap = setup.matvec(p)
    alpha = rz / torch.dot(p, ap).clamp_min(1e-30)
    x = x + alpha * p
    r = r - alpha * ap
    z = setup.apply_m_inv(r)
    rz_new = torch.dot(r, z)
    beta = rz_new / rz.clamp_min(1e-30)
    return x, r, z + beta * p, rz_new


def _pcg_loop(setup: Preconditioned, b: torch.Tensor, tol: float,
              max_iters: int):
    """The eager loop: the host reads ‖r‖ every iteration."""
    x, r, p, rz, bnorm = _pcg_start(setup, b)
    it = 0
    # tol compares in float32, as the JAX package's jnp.float32(tol)
    while it < max_iters and _read(torch.linalg.norm(r) / bnorm > tol,
                                   bool):
        x, r, p, rz = _pcg_step(setup, x, r, p, rz)
        it += 1
    return x, it, torch.linalg.norm(r) / bnorm


# Iterations in one captured chunk of the card's loop. On the 33³
# Laplacian (PERF.md) a chunk's copy-in and flag read cost too
# little to resolve, while each masked step past the end costs a whole
# iteration: 4 was the fastest of 4, 8 and 16.
CHUNK = 4


def _pcg_active(r, bnorm, it, tol, max_iters) -> torch.Tensor:
    """The while loop's condition on the device: ``it < max_iters`` and
    ‖r‖/‖b‖ > tol in float32 (``tol`` a float32 tensor)."""
    return (it < max_iters) & (torch.linalg.norm(r) / bnorm > tol)


def _pcg_chunk(setup: Preconditioned, steps: int, x, r, p, rz, it, bnorm,
               tol, max_iters):
    """``steps`` iterations of the while loop with its condition on the
    device: each computes the step and keeps it only where the condition
    holds, so a chunk that runs past the end repeats masked steps and
    changes nothing. Returns the carry, ``it``, and the condition for the
    next iteration."""
    for _ in range(steps):
        act = _pcg_active(r, bnorm, it, tol, max_iters)
        step = _pcg_step(setup, x, r, p, rz)
        x, r, p, rz = (torch.where(act, new, old)
                       for new, old in zip(step, (x, r, p, rz)))
        it = it + act.to(it.dtype)
    return x, r, p, rz, it, _pcg_active(r, bnorm, it, tol, max_iters)


def _pcg_chunked(setup: Preconditioned, b: torch.Tensor, tol: float,
                 max_iters: int):
    """The loop in chunks of ``CHUNK`` iterations, or the set-up's own
    ``chunk``, each one captured graph on the card (``runtime/graphs.py``;
    eager on the CPU); the host reads one flag per chunk. ``tol`` and
    ``max_iters`` are device scalars, so changing them replays the same
    graph. The iterations and the result are those of :func:`_pcg_loop`."""
    x, r, p, rz, bnorm = _pcg_start(setup, b)
    it = torch.zeros((), dtype=torch.int64, device=b.device)
    limits = (torch.tensor(tol, dtype=torch.float32, device=b.device),
              torch.tensor(max_iters, dtype=torch.int64, device=b.device))
    steps = getattr(setup, "chunk", CHUNK)
    chunk = functools.partial(_pcg_chunk, setup, steps)
    go = True
    while go:
        with profiling.span("bsm.pcg.chunk"):
            x, r, p, rz, it, act = graphs.run(setup, ("pcg", steps), chunk,
                                              x, r, p, rz, it, bnorm,
                                              *limits)
        go = _read(act, bool)
    return x, _read(it, int), torch.linalg.norm(r) / bnorm


def pcg_solve(a: CSR, b, *, tol: float = 1e-6, max_iters: int = 1000,
              setup: Optional[Preconditioned] = None
              ) -> Tuple[torch.Tensor, int, float]:
    """Solve ``A x = b`` (SPD, ``b`` a vector) by preconditioned CG on
    ``a``'s device. Returns (x, iterations, final relative residual).
    ``setup`` defaults to IC(0) (:meth:`PCGSetup.build`); pass a prebuilt
    one (IC(0), or a ``MultigridSetup``) to amortise the set-up across
    solves."""
    if setup is None:
        setup = PCGSetup.build(a)
    if not isinstance(b, torch.Tensor):
        b = torch.as_tensor(np.asarray(b))
    b = b.to(device=setup.a.device, dtype=torch.float32)
    loop = _pcg_chunked if b.is_cuda else _pcg_loop
    x, it, res = loop(setup, b, tol, max_iters)
    return x, it, _read(res, float)
