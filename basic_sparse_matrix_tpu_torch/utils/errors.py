"""Error model of the PyTorch port (same names as the JAX package's).

The reference crate uses a ``Result<_, MatErr>`` enum with six variants
(the reference crate's ``src/util.rs:47-55``). In Python we map each variant to an
exception type rooted at :class:`MatErr` so callers can catch either the
specific condition or the whole family. Errors are raised eagerly at
construction / dispatch time on the host, before any kernel launches.
"""

from __future__ import annotations


class MatErr(Exception):
    """Base class for all matrix errors (reference ``MatErr``, util.rs:47)."""


class MatrixFinalised(MatErr):
    """Mutation attempted on a finalised matrix (util.rs:49)."""


class MatrixNotFinalised(MatErr):
    """Operation requires a finalised matrix (util.rs:50)."""


class NonSquareMatrix(MatErr):
    """Operation requires a square matrix (util.rs:51)."""


class IncorrectDimensions(MatErr):
    """Operand dimensions are incompatible (util.rs:52)."""


class PaddingSizeSmallerThanOriginal(MatErr):
    """Requested padded size is smaller than the matrix (util.rs:53)."""


class OutOfBounds(MatErr):
    """Index outside the matrix bounds (util.rs:54)."""


def check(cond: bool, err: type[MatErr], msg: str = "") -> None:
    """Raise ``err(msg)`` unless ``cond`` holds. Host-side only."""
    if not cond:
        raise err(msg)
