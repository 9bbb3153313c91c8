"""``SparseOperator.solve(b)``: the prepared direct solver (ordering,
factorization and triangular-solve schedules at set-up, replayed solves in
the window).

Inputs: a pool of ``pool`` right-hand sides of ``rhs`` columns made on the
device from the seed, one drawn in seeded order for each request. Set-up
holds the solver to the configuration's ``solver_kind``. Checked: every
solution of the window against a dense float64 Cholesky solve of the
stencil's matrix: ``solve_err`` = ‖x - x_ref‖∞ / ‖x_ref‖∞.
"""

from __future__ import annotations

import importlib

import torch

from portbench import spans
from portbench.entries.base import ORDER, Entry
from portbench.reference.direct import DenseCholesky


class Solve(Entry):
    checks = ("solve_err",)

    def __init__(self, ctx):
        # The package exports a function named solve; the module is this.
        _solve = importlib.import_module(
            "basic_sparse_matrix_tpu_torch.models.solve")

        super().__init__(ctx)
        self.build_operator()
        self.inputs()
        ctx.lap("inputs")
        made = []
        with spans.around(_solve, "prepare_direct", ctx.sync,
                          lambda s, solver: made.append(solver)):
            for _ in range(2):
                self.op.solve(self.b[0])
                ctx.sync()
        solver = made[-1]
        ctx.program.update({f"timings.{k}": v
                            for k, v in solver.timings.items()})
        want = ctx.config.get("solver_kind")
        if want and solver.kind != want:
            raise RuntimeError(f"the direct solver took the {solver.kind!r} "
                               f"tier; the configuration states {want!r}")
        self._dense = None

    def inputs(self) -> None:
        ctx = self.ctx
        pool, rhs = int(ctx.traffic["pool"]), int(ctx.traffic["rhs"])
        self.kept, self.b = {}, None
        shape = (pool, self.n) if rhs == 1 else (pool, self.n, rhs)
        self.b = torch.randn(shape, generator=ctx.gen, device=ctx.device,
                             dtype=torch.float32)
        self.order = ctx.rng.integers(0, pool, size=ORDER)

    def _rhs(self, i: int) -> torch.Tensor:
        return self.b[int(self.order[i % ORDER])]

    def send(self, i: int):
        return self.op.solve(self._rhs(i))

    def reference(self, ids, prec):
        if self._dense is None:
            self._dense = DenseCholesky(self.ctx.config, self.ctx.device)
        cols = [self._rhs(i).reshape(self.n, -1) for i in ids]
        if not cols:
            return {}
        x = self._dense.solve(torch.cat(cols, 1), prec)
        per = cols[0].shape[1]
        return {i: x[:, k * per: (k + 1) * per].reshape(self._rhs(i).shape)
                for k, i in enumerate(ids)}


ENTRY = Solve
