"""Level splits of the distributed direct solvers (``cholesky``,
``triangular``, ``supernodal``).

No counterpart in the JAX package, which pads every level's batch to a
multiple of the mesh size and reshapes it into one slice per device
(``parallel/cholesky.py::_split``). The port's schedules are ragged, so
each level is cut into contiguous ranges instead, one per rank, computed
once on the host per schedule; a rank may get an empty range (a level with
fewer items than ranks, as the last levels of any elimination tree are).
Items of one level are disjoint across ranks, so gathering the ranks'
results in rank order rebuilds the level's values exactly.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F


def split_levels(ptr: Sequence[int], num: int) -> np.ndarray:
    """(levels, num + 1) bounds: rank ``r`` takes items
    ``b[l, r]:b[l, r + 1]`` of level ``l`` (whose items are
    ``ptr[l]:ptr[l + 1]``); the ranges differ in length by at most one."""
    ptr = np.asarray(ptr, dtype=np.int64)
    count = np.diff(ptr)
    return ptr[:-1, None] + (count[:, None] * np.arange(num + 1)) // num


def range_starts(bounds: np.ndarray, total: int) -> np.ndarray:
    """For every item position ``0 .. total - 1``: the first position of
    the rank range that holds it."""
    return np.repeat(bounds[:, :-1].ravel(),
                     np.diff(bounds, axis=1).ravel())[:total]


def gather_ragged(comm, parts: Sequence[torch.Tensor],
                  counts: Sequence[int]) -> torch.Tensor:
    """The ranks' ``parts`` (rank ``r``'s has ``counts[r]`` rows along dim
    0; one part per rank this process runs) concatenated in rank order.
    Where this process runs every rank that is one concatenation; across
    processes each part is padded to the longest and gathered."""
    if len(comm.local) == comm.size:
        return comm.all_gather(parts)[0]
    (x,) = parts
    width = int(max(counts))
    pad = [0, 0] * (x.ndim - 1) + [0, width - x.shape[0]]
    stacked = comm.all_gather([F.pad(x, pad)], tiled=False)[0]
    return torch.cat([stacked[r, : int(c)] for r, c in enumerate(counts)])
