"""The yardstick's peaks and the byte and operation counts of each roofline.

Counts are computed from the data alone, never from the kernel that runs,
so a later kernel in the same place is held to the same work: every input
read once, every output written once, as the data needs it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

# Published peaks by card (NVIDIA H100 SXM data sheet: dense rates, no
# sparsity, at the full 700 W power limit): HBM bytes/s and float32
# operations/s on the CUDA cores.
PEAKS = {
    "H100": {"hbm_bytes_per_s": 3.35e12, "fp32_flops_per_s": 67e12},
}


def peaks(kind: str) -> Optional[dict]:
    """The peaks of the card named ``kind`` (``torch.cuda.get_device_name``),
    or None for a card not in the table."""
    for key, value in PEAKS.items():
        if key in kind:
            return value
    return None


def spmm(rows: int, cols: np.ndarray, vals: np.ndarray, n_rhs: int,
         index_bytes: int = 4, value_bytes: int = 4) -> dict:
    """Operations and bytes of ``C = A·B`` for a (rows, K) sparse A with
    entries ``cols``/``vals`` in any layout (slots whose value is 0, such as
    padding, are not entries) and a B of ``n_rhs`` columns: A's values,
    column indices and row pointers once, each distinct column's row of B
    once, C once."""
    cols, vals = np.asarray(cols).ravel(), np.asarray(vals).ravel()
    live = cols[vals != 0]
    nnz = int(live.size)
    held = int(np.count_nonzero(np.bincount(live))) if nnz else 0
    nbytes = (nnz * (value_bytes + index_bytes) + (rows + 1) * index_bytes
              + held * n_rhs * value_bytes + rows * n_rhs * value_bytes)
    return {"flops": 2.0 * nnz * n_rhs, "bytes": float(nbytes)}


def bound_s(cost: dict, peak: dict) -> float:
    """The least seconds the card could take: the larger of bytes over peak
    bandwidth and operations over peak float32 rate."""
    return max(cost["bytes"] / peak["hbm_bytes_per_s"],
               cost["flops"] / peak["fp32_flops_per_s"])
