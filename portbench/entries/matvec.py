"""``SparseOperator.matvec(x)``: GAP's PageRank product ``y = P·x`` on the
``kron`` graph (``portbench/kron.py``), through ``mul_vector`` (on the card
the dispatch ladder, as one column).

Inputs: a pool of ``pool`` PageRank iterates x of shape (n,), positive and
summing to 1, made on the device from the seed, one drawn in seeded order
for each request; the graph itself comes from the configuration's
``graph_seed``. Checked: the products of ``check_requests`` requests drawn
from the seed among the first ``SAMPLE_FROM``, and the window's last,
against the edge list's product in float64 (``reference/graph.py``), row by
row: ``spmv_err`` = max over the rows with entries of |y_i − r_i| ÷
Σ_j |P_ij·x_j|; an empty row that reads anything but exactly 0 makes it
infinite. (An ∞-norm over the whole vector would be the hubs' alone, and a
product in a lower precision would pass it.)
"""

from __future__ import annotations

import torch

from portbench import kron
from portbench.entries.base import ORDER, Entry
from portbench.entries.matmul import SAMPLE_FROM, Matmul
from portbench.reference import graph
from portbench.reference.precision import FLOAT64, TF32

# Scale of the graph when the entry runs on the CPU: the harness's own tests
# and rehearsals (``run.py`` refuses a run without a card) size every cell
# down, and the CPU generates no graph above ``kron.CPU_MAX_SCALE``.
CPU_SCALE = 10


class Matvec(Matmul):
    """:class:`Matmul`'s loop (the kept answers, the window's last) over
    ``matvec`` of a vector pool; the cost is counted from the row pointer
    (``kron.spmv_cost``)."""

    checks = ("spmv_err",)

    def __init__(self, ctx):
        Entry.__init__(self, ctx)
        indptr, _, _ = self.build_operator()
        ctx.cost = kron.spmv_cost(indptr)
        self.inputs()
        ctx.lap("inputs")
        for _ in range(2):
            self.send(0)
            ctx.sync()

    def build_operator(self):
        """The ``kron`` graph's ``P`` in the program through
        ``CSR.from_host`` (at ``CPU_SCALE`` at most on the CPU); the host
        triple is kept for the reference's edge list."""
        from basic_sparse_matrix_tpu_torch import CSR, SparseOperator

        config = self.ctx.config
        if self.ctx.device.type == "cpu":
            config = dict(config, scale=min(int(config["scale"]), CPU_SCALE))
        self.graph = kron.csr(config, self.ctx.device)
        self.ctx.lap("graph")
        indptr, indices, values = self.graph
        self.n = n = indptr.shape[0] - 1
        self.op = SparseOperator(CSR.from_host(
            indptr, indices, values, (n, n), device=self.ctx.device))
        self.ctx.lap("operator")
        return self.graph

    def inputs(self) -> None:
        ctx, pool = self.ctx, int(self.ctx.traffic["pool"])
        self.kept, self.last, self.x = {}, None, None
        u = torch.rand((pool, self.n), generator=ctx.gen, device=ctx.device,
                       dtype=torch.float64) + 0.5
        self.x = (u / u.sum(1, keepdim=True)).to(torch.float32)
        del u
        self.order = ctx.rng.integers(0, pool, size=ORDER)
        self.sample = set(ctx.rng.choice(
            SAMPLE_FROM, size=int(ctx.traffic["check_requests"]),
            replace=False).tolist())

    def _pick(self, i: int) -> int:
        return int(self.order[i % ORDER])

    def send(self, i: int):
        return self.op.matvec(self._operand(i))

    def reference(self, ids, prec):
        """Per pool entry the kept requests drew: its product in ``prec``
        (with ``FLOAT64`` also its row scale), as (pool index, y[, s])."""
        picks = sorted({self._pick(i) for i in ids})
        indptr, indices, _ = self.graph
        x = self.x[picks].T.contiguous()
        got = graph.apply(indptr, indices, x, prec, scale=prec is FLOAT64)
        return {"picks": picks, "y": got[0] if prec is FLOAT64 else got,
                "s": got[1] if prec is FLOAT64 else None}

    def errors(self, control: bool = False):
        ids = sorted(self.kept)
        ref = self.reference(ids, FLOAT64)
        col = {p: k for k, p in enumerate(ref["picks"])}
        ctl = self.reference(ids, TF32) if control else None
        out = {}
        for i in ids:
            k = col[self._pick(i)]
            ans = ctl["y"][:, k] if control else self.kept[i]
            out[i] = graph.row_error(ans, ref["y"][:, k], ref["s"][:, k])
        return {self.checks[0]: out}


ENTRY = Matvec
