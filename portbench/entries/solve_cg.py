"""``SparseOperator.solve_cg(b, tol, max_iters)``: IC(0)-preconditioned CG
(the IC(0) factor and its schedules at set-up, chunked graph replays in the
window).

Inputs: a pool of ``pool`` exact solutions x* made on the device from the
seed and b = A·x* (the stencil in float64, rounded to float32), one drawn in
seeded order for each set. With ``tol`` 0 every set runs ``iters``
iterations, HPCG's fixed set. Checked: every set's iterate against the
reference's IC(0)-PCG iterate in float64, ``pcg_err`` = ‖x - x_ref‖∞ /
‖x_ref‖∞, and ``pcg_iters_off``, the sets that did not run ``iters``
iterations.
"""

from __future__ import annotations

import torch

from portbench import spans
from portbench.entries.base import ORDER, Entry
from portbench.reference import ic0_pcg, stencil
from portbench.reference.precision import FLOAT64


class SolveCG(Entry):
    checks = ("pcg_err", "pcg_iters_off")

    def __init__(self, ctx):
        from basic_sparse_matrix_tpu_torch.models import pcg as _pcg

        super().__init__(ctx)
        self.iters, self.tol = int(ctx.traffic["iters"]), \
            float(ctx.traffic["tol"])
        self.build_operator()
        self.inputs()
        ctx.lap("inputs")
        with spans.around(_pcg.PCGSetup, "build", ctx.sync,
                          lambda s, _: ctx.spans.__setitem__("pcg_build", s)):
            for _ in range(2):
                self.send(0)
                ctx.sync()

    def inputs(self) -> None:
        ctx, pool = self.ctx, int(self.ctx.traffic["pool"])
        self.kept, self.ran = {}, {}
        xs = torch.randn((self.n, pool), generator=ctx.gen, device=ctx.device,
                         dtype=torch.float32)
        self.b = stencil.apply(ctx.config, xs, FLOAT64).to(
            torch.float32).T.contiguous()
        self.order = ctx.rng.integers(0, pool, size=ORDER)

    def _rhs(self, i: int) -> int:
        return int(self.order[i % ORDER])

    def send(self, i: int):
        return self.op.solve_cg(self.b[self._rhs(i)], tol=self.tol,
                                max_iters=self.iters)

    def keep(self, i: int, out) -> None:
        self.kept[i] = out[0]
        self.ran[i] = out[1]

    def reference(self, ids, prec):
        used = sorted({self._rhs(i) for i in ids})
        if not used:
            return {}
        x = ic0_pcg.pcg(self.ctx.config, self.b[used].T, self.iters, prec)
        col = {j: k for k, j in enumerate(used)}
        return {i: x[:, col[self._rhs(i)]] for i in ids}

    def errors(self, control: bool = False):
        out = super().errors(control)
        out["pcg_iters_off"] = {
            i: 0.0 if control else float(self.ran[i] != self.iters)
            for i in self.kept}
        return out


ENTRY = SolveCG
