"""Readers of a ratio of two of the program's counters (its recorder's
snapshot, :mod:`portbench.program`) over the traced slice."""

from __future__ import annotations

from typing import Optional

from portbench.program import snapshot


def ratio(num: str, den: str):
    """A reader: the counter ``num`` over the counter ``den``, or None where
    the program has no recorder or counted neither."""
    def read(_record) -> Optional[float]:
        snap = snapshot()
        if snap is None:
            return None
        a, b = snap.counters.get(num, 0), snap.counters.get(den, 0)
        return a / b if a and b else None
    return read
