"""Device timing with CUDA events.

Counterpart of ``basic_sparse_matrix_tpu/runtime/timing.py``, whose
two-point, fetch-fenced loop works around a remote TPU transport. On a
local GPU, CUDA events time the device directly: warm up, then record an
event pair around each of ``iters`` launches, synchronise, and take the
median of the per-launch times.
"""

from __future__ import annotations

import statistics
from typing import Callable


def cuda_time_ms(fn: Callable[[], object], *, warmup: int = 3,
                 iters: int = 20) -> float:
    """Median per-launch device milliseconds of ``fn()`` on the current
    CUDA stream, after ``warmup`` untimed calls. Raises without a CUDA
    device."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("cuda_time_ms needs a CUDA device")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)
