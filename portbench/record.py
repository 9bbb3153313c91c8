"""What one run leaves for the metric readers (``metrics/<name>.py``)."""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class Record:
    cell: str
    # torch.cuda.get_device_name, or "cpu".
    device_kind: str
    # Process start to the first timed request, host clock.
    setup_s: float
    # First request's send to the last one's synchronised result.
    window_s: float
    # Per request of the window: send to synchronised result, and send to
    # the entry's return (before the synchronise).
    latency_s: list
    host_s: list
    # Work of one request as the data needs it ({"flops", "bytes"}), or
    # None where the entry counts none.
    cost: Optional[dict]
    # Seconds of spans the benchmark took around calls into the program.
    spans: dict
    # Values the program reported (its own laps and choices).
    program: dict
    # The traced slice (trace.profile), or None.
    trace: Optional[dict]
