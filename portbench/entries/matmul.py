"""``SparseOperator.matmul(X)``: the SpMM entry, through ``mul_dense``'s
dispatch ladder to the rung it picks for the operator and the width.

Inputs: a pool of ``pool`` operands X of shape (n, ``width``) made on the
device from the seed, one drawn in seeded order for each request. Checked:
the products of ``check_requests`` requests drawn from the seed among the
first ``SAMPLE_FROM``, and the window's last, against the stencil applied in
float64: ``spmm_err`` = max|C - R| / max|R|.
"""

from __future__ import annotations

import torch

from portbench import costs
from portbench.entries.base import ORDER, Entry
from portbench.reference import stencil

SAMPLE_FROM = 32


class Matmul(Entry):
    checks = ("spmm_err",)

    def __init__(self, ctx):
        super().__init__(ctx)
        self.width = int(ctx.traffic["width"])
        _, indices, values = self.build_operator()
        ctx.cost = costs.spmm(self.n, indices, values, self.width)
        self.inputs()
        ctx.lap("inputs")
        for _ in range(2):
            self.op.matmul(self.x[0])
            ctx.sync()

    def inputs(self) -> None:
        ctx, pool = self.ctx, int(self.ctx.traffic["pool"])
        self.kept, self.last, self.x = {}, None, None
        self.x = torch.randn((pool, self.n, self.width), generator=ctx.gen,
                             device=ctx.device, dtype=torch.float32)
        self.order = ctx.rng.integers(0, pool, size=ORDER)
        self.sample = set(ctx.rng.choice(
            SAMPLE_FROM, size=int(ctx.traffic["check_requests"]),
            replace=False).tolist())

    def _operand(self, i: int) -> torch.Tensor:
        return self.x[int(self.order[i % ORDER])]

    def send(self, i: int):
        return self.op.matmul(self._operand(i))

    def keep(self, i: int, out) -> None:
        if i in self.sample:
            self.kept[i] = out
        self.last = (i, out)

    def close_window(self) -> None:
        if self.last is not None:
            self.kept[self.last[0]] = self.last[1]
            self.last = None

    def reference(self, ids, prec):
        return {i: stencil.apply(self.ctx.config, self._operand(i), prec)
                for i in ids}


ENTRY = Matmul
