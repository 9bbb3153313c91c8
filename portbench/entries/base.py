"""What every entry does: set up the program and the seeded inputs, send
request i, keep the answers to be checked, and give the reference's answer
for them."""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from portbench import hpcg
from portbench.reference.precision import FLOAT64, TF32, Precision

# Length of the seeded sequence of pool indices; request i takes entry
# i mod ORDER.
ORDER = 1 << 16


@dataclasses.dataclass
class Context:
    config: dict
    traffic: dict
    seed: int
    device: torch.device
    spans: dict = dataclasses.field(default_factory=dict)
    program: dict = dataclasses.field(default_factory=dict)
    cost: Optional[dict] = None
    # Set-up laps on the host clock, seconds since the context was made.
    laps: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self._t0 = time.perf_counter()
        self.reseed(self.seed)

    def reseed(self, seed: int) -> None:
        """Draw the inputs from ``seed`` from here on."""
        self.seed = seed
        self.rng = np.random.default_rng(seed % (1 << 64))
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed % (1 << 63))

    def lap(self, name: str) -> None:
        self.sync()
        self.laps[name] = time.perf_counter() - self._t0

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


class Entry:
    """Subclasses build the program in ``__init__``, make the seeded inputs
    in :meth:`inputs` (which empties ``self.kept``, {request: answer}), and
    implement :meth:`send` and :meth:`reference`."""

    # Names of the numbers compared, each with its limit in limits/<cell>.
    checks: tuple = ()

    def __init__(self, ctx: Context):
        self.ctx = ctx
        self.kept: Dict[int, torch.Tensor] = {}

    def build_operator(self):
        """The configuration's operator in the program, through its cheapest
        public CSR constructor, wrapped in a ``SparseOperator``; returns the
        host CSR triple it was built from."""
        from basic_sparse_matrix_tpu_torch import CSR, SparseOperator

        indptr, indices, values = hpcg.csr(self.ctx.config)
        self.n = n = indptr.shape[0] - 1
        self.op = SparseOperator(CSR.from_host(
            indptr, indices, values, (n, n), device=self.ctx.device))
        self.ctx.lap("operator")
        return indptr, indices, values

    def inputs(self) -> None:
        """Make the inputs from the context's seed."""
        raise NotImplementedError

    def send(self, i: int):
        raise NotImplementedError

    def keep(self, i: int, out) -> None:
        self.kept[i] = out

    def close_window(self) -> None:
        """The window (and any traced slice) has ended: settle which
        answers are compared."""

    def release(self) -> None:
        """Drop the program's state before the reference runs."""
        self.op = None

    def reference(self, ids: Iterable[int],
                  prec: Precision) -> Dict[int, torch.Tensor]:
        raise NotImplementedError

    def error(self, answer: torch.Tensor, ref: torch.Tensor) -> float:
        """‖answer - ref‖∞ / ‖ref‖∞; a NaN reads as infinity."""
        d = (answer.to(torch.float64) - ref).abs().max()
        e = float(d / ref.abs().max())
        return e if np.isfinite(e) else float("inf")

    def errors(self, control: bool = False) -> Dict[str, Dict[int, float]]:
        """Each compared number per kept answer: the program's answers
        against the float64 reference, or with ``control`` the reference
        computed in TF32 against it."""
        ids = sorted(self.kept)
        ref = self.reference(ids, FLOAT64)
        ans = self.reference(ids, TF32) if control else self.kept
        return {self.checks[0]: {i: self.error(ans[i], ref[i]) for i in ids}}
