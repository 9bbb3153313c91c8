"""The traced slice: a few requests under ``torch.profiler``, reduced to what
the per-layer metrics and the ``breakdown`` read.

The slice runs after the measured window has closed, on the same program
state, so the window itself is never profiled. Its length (``window_s``)
runs from the first request's start to the last request's synchronised end
on the profiler's clock; ``busy_s`` is the union of device activity
(kernels, copies, fills) inside it. Each idle gap of the device is put
down to what the host was doing at its midpoint: the innermost host event
open then. The profiler drops device events now and then, so counts of
device operations are lower bounds.
"""

from __future__ import annotations

import collections
from typing import Callable

REQUEST = "portbench.request"
TOP = 10


def profile(request: Callable[[int], None], first: int, count: int,
            cuda: bool = True) -> dict:
    """Run ``request(first)`` ... ``request(first + count - 1)`` (each ends
    synchronised) under the profiler and reduce the trace. Without
    ``cuda`` only the host is traced, and the device reads idle."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as _profile, \
        record_function

    activities = [ProfilerActivity.CPU]
    if cuda:
        torch.cuda.synchronize()
        activities.append(ProfilerActivity.CUDA)
    with _profile(activities=activities) as prof:
        for i in range(first, first + count):
            with record_function(REQUEST):
                request(i)
    events = prof.events()
    spans = [(e.time_range.start, e.time_range.end) for e in events
             if e.device_type == DeviceType.CPU and e.name == REQUEST]
    w0, w1 = min(s for s, _ in spans), max(e for _, e in spans)
    # The device's copy of the request's own range is no operation.
    dev = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e in events if e.device_type == DeviceType.CUDA
                 and e.name != REQUEST
                 and not getattr(e, "is_user_annotation", False)
                 and e.time_range.end > w0 and e.time_range.start < w1)
    host = sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in events if e.device_type == DeviceType.CPU)
    return reduce(dev, host, w0, w1, count)


def reduce(dev, host, w0: float, w1: float, requests: int) -> dict:
    """Busy time, device operations, time by operation name and idle time
    by host activity from device intervals ``dev`` and host intervals
    ``host`` ((start, end, name), microseconds) inside [w0, w1]."""
    by_name = collections.Counter()
    busy, end = 0.0, w0
    gaps = []
    for s, e, name in dev:
        s, e = max(s, w0), min(e, w1)
        by_name[name] += (e - s) * 1e-6
        if s > end:
            gaps.append((end, s))
        if e > end:
            busy += e - max(s, end)
            end = e
    if w1 > end:
        gaps.append((end, w1))
    idle = collections.Counter()
    active, k = [], 0
    for g0, g1 in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = 0.5 * (g0 + g1)
        while k < len(host) and host[k][0] <= mid:
            active.append(host[k])
            k += 1
        active = [h for h in active if h[1] >= mid]
        label = max(active, key=lambda h: h[0])[2] if active else "host idle"
        idle[label] += (g1 - g0) * 1e-6
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": busy * 1e-6,
        "requests": requests,
        "device_ops": len(dev),
        "device_op_s": [[n, s] for n, s in by_name.most_common(TOP)],
        "idle_gaps": [[n, s] for n, s in idle.most_common(TOP)],
    }
