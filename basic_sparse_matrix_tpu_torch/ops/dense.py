"""Dense matrix parity wrapper.

Counterpart of ``basic_sparse_matrix_tpu/ops/dense.py``. The reference's
``Dense<T>`` is column-major and its ``from_data`` takes a list of
*columns*; this wrapper keeps that construction convention while storing a
plain row-major ``(rows, cols)`` tensor on one device: host data goes to
``device`` (``None``: the configured default device, the card), a tensor
stays where it is unless ``device`` is given. ``DenseS`` (the reference's
const-generic twin) is an alias.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.config import default_device
from ..utils.errors import IncorrectDimensions, check
from ..utils.shapes import MatDim


def _as_tensor(data, device=None) -> torch.Tensor:
    if isinstance(data, torch.Tensor):
        return data if device is None else data.to(device)
    return torch.as_tensor(np.array(data), device=default_device(device))


class Dense:
    """Thin column-convention wrapper over a row-major tensor."""

    def __init__(self, array, device=None):
        self.array = _as_tensor(array, device)
        check(self.array.ndim == 2, IncorrectDimensions,
              f"Dense needs 2D data, got {tuple(self.array.shape)}")

    @staticmethod
    def new_default_with_dims(col_count: int, row_count: int,
                              dtype=torch.float32, device=None) -> "Dense":
        """Zero matrix. NOTE the reference argument order: (cols, rows)."""
        return Dense(torch.zeros((row_count, col_count), dtype=dtype,
                                 device=default_device(device)))

    @staticmethod
    def new_with_dims(val, col_count: int, row_count: int,
                      device=None) -> "Dense":
        """Constant fill, (cols, rows) argument order."""
        return Dense(_as_tensor(np.full((row_count, col_count), val),
                                device))

    @staticmethod
    def from_data(cols, device=None) -> "Dense":
        """Column-major construction: ``cols[i]`` is the i-th *column*."""
        return Dense(np.asarray(cols).T, device)

    @property
    def dims(self) -> MatDim:
        r, c = self.array.shape
        return MatDim(int(r), int(c))

    get_dims = dims.fget

    def get_col(self, col_index: int) -> torch.Tensor:
        return self.array[:, col_index]

    def set_col(self, col_index: int, values) -> "Dense":
        """Returns a new Dense with the column replaced (the original is
        left as it was)."""
        out = self.array.clone()
        out[:, col_index] = _as_tensor(values, out.device)
        return Dense(out)

    def __eq__(self, other) -> bool:
        if isinstance(other, Dense):
            other = other.array
        return bool(np.array_equal(self.array.cpu().numpy(),
                                   _as_tensor(other).cpu().numpy()))

    def allclose(self, other, rtol=1e-5, atol=1e-6) -> bool:
        if isinstance(other, Dense):
            other = other.array
        return bool(np.allclose(self.array.cpu().numpy(),
                                _as_tensor(other).cpu().numpy(),
                                rtol=rtol, atol=atol))

    def __repr__(self) -> str:
        return f"Dense({self.dims})\n{self.array.cpu().numpy()}"

    def __str__(self) -> str:
        return "\n".join(
            "|" + "".join(f"{v:>5}" for v in row) + "|"
            for row in self.array.cpu().numpy()
        )


DenseS = Dense
