"""Readers that several per-layer metrics share; each metric's own file
under ``metrics/`` names the one it uses."""

from __future__ import annotations

from typing import Optional

from portbench.record import Record


def _traced(r: Record) -> Optional[dict]:
    """The traced slice where it saw the device work, else None."""
    t = r.trace
    return t if t and t["busy_s"] > 0 and t["requests"] > 0 else None


def idle_pct(r: Record) -> Optional[float]:
    """Share of the traced slice in which no operation ran on the device."""
    t = _traced(r)
    return None if t is None else 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def device_ops(r: Record) -> Optional[float]:
    """Device operations a request ran in the traced slice (a lower
    bound: the profiler drops events now and then)."""
    t = _traced(r)
    return None if t is None else t["device_ops"] / t["requests"]


def device_s(r: Record) -> Optional[float]:
    """Device busy seconds a request took in the traced slice: all device
    work between its send and its synchronised end."""
    t = _traced(r)
    return None if t is None else t["busy_s"] / t["requests"]
