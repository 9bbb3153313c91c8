"""Shape vocabulary.

Reference counterpart: ``MatDim`` (the reference crate's ``src/util.rs:11-41``) and
the ``GetDims`` trait (util.rs:43-45). Here a matrix dimension is a frozen
dataclass interchangeable with a ``(rows, cols)`` tuple, the way the reference
lets ``(usize, usize)`` convert into ``MatDim``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple, Union

DimLike = Union["MatDim", Tuple[int, int]]


@dataclasses.dataclass(frozen=True)
class MatDim:
    rows: int
    cols: int

    @staticmethod
    def of(d: DimLike) -> "MatDim":
        if isinstance(d, MatDim):
            return d
        r, c = d
        return MatDim(int(r), int(c))

    def transpose(self) -> "MatDim":
        """Reference ``MatDim::transpose`` (util.rs:18-20)."""
        return MatDim(self.cols, self.rows)

    def as_tuple(self) -> Tuple[int, int]:
        return (self.rows, self.cols)

    @property
    def size(self) -> int:
        return self.rows * self.cols

    def __iter__(self):
        yield self.rows
        yield self.cols

    def __str__(self) -> str:  # util.rs:36-41
        return f"(rows: {self.rows}, cols: {self.cols})"
