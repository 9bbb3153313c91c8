"""``SparseOperator.solve_cg(b, tol, max_iters)`` after ``use_multigrid``:
CG preconditioned by HPCG's multigrid V-cycle (the hierarchy, its
triangular-solve schedules and ELL views at set-up; chunk graphs in the
window).

The hierarchy is the configuration's: its operator on ``mg_levels`` grids,
each the one before halved in every dimension (``hpcg.csr`` at each grid),
and HPCG's injection between them (``multigrid.injection_map``: coarse
point (i, j, k) is fine point (2i, 2j, 2k)), handed to the program. The
configuration must state what the program runs: HPCG's smoother, transfer,
coarse operators and one smoothing step before and after.

Inputs and the first two checks are ``solve_cg``'s: every set's iterate
against the reference's MG-PCG iterate in float64 (``pcg_err``) and the sets
that did not run ``iters`` iterations (``pcg_iters_off``). With
``tol`` 0 and 50 iterations PCG reaches float32's accuracy under almost any
preconditioner, so a third number holds the V-cycle itself: after the
window the program's own set-up is applied once to each distinct b of the
kept sets and compared with the reference's V-cycle, ``mg_err`` =
‖M⁻¹b − (M⁻¹b)_ref‖∞ / ‖(M⁻¹b)_ref‖∞.
"""

from __future__ import annotations

# First: a program without multigrid fails here, at the start of set-up.
from basic_sparse_matrix_tpu_torch.models import multigrid

import torch

from portbench import hpcg
from portbench.entries.base import Entry
from portbench.entries.solve_cg import SolveCG
from portbench.reference import ic0_pcg, mg_pcg
from portbench.reference.precision import FLOAT64, TF32

# What the configuration may state: HPCG's multigrid, what the program
# runs; the reference reads the same keys.
STATED = {"smoother": "symgs-natural", "transfer": "injection",
          "coarse": "regenerated 27-point", "pre_smoother_steps": 1,
          "post_smoother_steps": 1}


class SolveCGMG(SolveCG):
    checks = ("pcg_err", "pcg_iters_off", "mg_err")

    def __init__(self, ctx):
        from basic_sparse_matrix_tpu_torch import CSR

        Entry.__init__(self, ctx)
        config = ctx.config
        for key, want in STATED.items():
            if config.get(key) != want:
                raise ValueError(f"the configuration states {key} "
                                 f"{config.get(key)!r}; the program runs "
                                 f"{want!r}")
        self.iters, self.tol = int(ctx.traffic["iters"]), \
            float(ctx.traffic["tol"])
        self.build_operator()
        coarse, maps = [], []
        configs = mg_pcg.level_configs(config)
        for fine, c in zip(configs, configs[1:]):
            n = hpcg.rows(c)
            coarse.append(CSR.from_host(*hpcg.csr(c), (n, n),
                                        device=ctx.device))
            maps.append(multigrid.injection_map(hpcg.grid(fine), ctx.device))
        self.op.use_multigrid(coarse, maps)
        ctx.lap("multigrid")
        self.inputs()
        ctx.lap("inputs")
        self.mg_out = {}
        for _ in range(2):
            self.send(0)
            ctx.sync()

    def close_window(self) -> None:
        """Apply the program's set-up once to each distinct b of the kept
        sets, kept under the first request that drew it."""
        setup = self.op.pcg_setup
        first = {}
        for i in sorted(self.kept):
            first.setdefault(self._rhs(i), i)
        self.mg_out = {i: setup.apply_m_inv(self.b[j]).clone()
                       for j, i in first.items()}
        self.ctx.sync()

    def reference(self, ids, prec):
        used = sorted({self._rhs(i) for i in ids})
        if not used:
            return {}
        m = mg_pcg.GridMG(self.ctx.config, self.b.device, prec)
        x = ic0_pcg.pcg(self.ctx.config, self.b[used].T, self.iters, prec,
                        m=m)
        col = {j: k for k, j in enumerate(used)}
        return {i: x[:, col[self._rhs(i)]] for i in ids}

    def errors(self, control: bool = False):
        out = super().errors(control)
        ids = sorted(self.mg_out)
        if not ids:
            out["mg_err"] = {}
            return out
        b = self.b[[self._rhs(i) for i in ids]].T
        ref = mg_pcg.GridMG(self.ctx.config, b.device,
                            FLOAT64).apply_inverse(b)
        ans = mg_pcg.GridMG(self.ctx.config, b.device, TF32).apply_inverse(
            b) if control else torch.stack([self.mg_out[i] for i in ids], 1)
        out["mg_err"] = {i: self.error(ans[:, k], ref[:, k])
                         for k, i in enumerate(ids)}
        return out


ENTRY = SolveCGMG
