from .errors import (
    IncorrectDimensions,
    MatErr,
    MatrixFinalised,
    MatrixNotFinalised,
    NonSquareMatrix,
    OutOfBounds,
    PaddingSizeSmallerThanOriginal,
    check,
)
from .shapes import DimLike, MatDim

__all__ = [
    "MatDim",
    "DimLike",
    "MatErr",
    "MatrixFinalised",
    "MatrixNotFinalised",
    "NonSquareMatrix",
    "IncorrectDimensions",
    "PaddingSizeSmallerThanOriginal",
    "OutOfBounds",
    "check",
]
