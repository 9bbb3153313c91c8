"""Device timing with CUDA events.

Counterpart of ``basic_sparse_matrix_tpu/runtime/timing.py``, whose
two-point, fetch-fenced loop works around a remote TPU transport. On a
local GPU, CUDA events time the device directly: warm up, then record an
event pair around each of ``iters`` launches, synchronise, and take the
median of the per-launch times. :class:`CudaTimer` times one enclosed region
the same way (``runtime/profiling.py``'s ``timed`` uses it).
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


class CudaTimer:
    """Context manager: device milliseconds between entry and exit on the
    current CUDA stream of ``device``, by an event pair; ``ms`` is set on
    exit, which waits for the end event."""

    def __init__(self, device=None):
        self.device = device
        self.ms = 0.0

    def __enter__(self) -> "CudaTimer":
        import torch

        self._start = torch.cuda.Event(enable_timing=True)
        self._end = torch.cuda.Event(enable_timing=True)
        self._start.record(torch.cuda.current_stream(self.device))
        return self

    def __exit__(self, *exc) -> None:
        import torch

        self._end.record(torch.cuda.current_stream(self.device))
        self._end.synchronize()
        self.ms = self._start.elapsed_time(self._end)
