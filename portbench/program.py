"""What the program records about itself, for the per-layer metrics whose
source is ``program_span``: the snapshot of its recorder
(``basic_sparse_matrix_tpu_torch/runtime/profiling.py``: spans, counters and
the table of set-up laps).

A ``--trace 1`` run has the profiler on only for the traced slice, so the
recorder's last session is that slice; counts a request divide by the
slice's request roots (``bsm.matmul``, ``bsm.solve``, ``bsm.solve_cg``).
The laps are the process's set-up. A program without the recorder, or a run
in which it recorded nothing a reader needs, gives None.
"""

from __future__ import annotations

import importlib
from typing import Optional

RECORDER = "basic_sparse_matrix_tpu_torch.runtime.profiling"


def snapshot():
    """The recorder's snapshot, or None where the program has none."""
    try:
        mod = importlib.import_module(RECORDER)
    except ImportError:
        return None
    snap = getattr(mod, "snapshot", None)
    return snap() if callable(snap) else None


def _positive(x) -> Optional[float]:
    return float(x) if x is not None and x > 0 else None


def _per_request(snap, total) -> Optional[float]:
    n = snap.requests()
    return _positive(total / n) if n and total else None


def self_ms(name: str):
    """A reader: self time of the span ``name`` a request, ms."""
    def read(_record) -> Optional[float]:
        snap = snapshot()
        if snap is None:
            return None
        row = snap.summary().get(name)
        return None if row is None else _per_request(snap,
                                                     row["self_s"] * 1e3)
    return read


def counter(name: str):
    """A reader: the counter ``name`` a request."""
    def read(_record) -> Optional[float]:
        snap = snapshot()
        return None if snap is None else _per_request(
            snap, snap.counters.get(name, 0))
    return read


def lap(name: str):
    """A reader: the set-up lap ``name`` (``<owner>.<phase>``), s."""
    def read(_record) -> Optional[float]:
        snap = snapshot()
        return None if snap is None else _positive(snap.laps.get(name))
    return read


def laps_of(owner: str):
    """A reader: the sum of the set-up laps ``<owner>.*`` present, s."""
    def read(_record) -> Optional[float]:
        snap = snapshot()
        if snap is None:
            return None
        return _positive(sum(v for k, v in snap.laps.items()
                             if k.startswith(owner + ".")))
    return read


def node_us(_record) -> Optional[float]:
    """Device time of the slice's graph replays (CUDA events around each
    ``replay()``) over the nodes they replayed, us a node."""
    snap = snapshot()
    if snap is None:
        return None
    nodes = snap.counters.get("graphs.nodes", 0)
    ms = sum(s.attrs.get("device_ms", 0.0) for s in snap.spans
             if s.name == "bsm.graphs.replay")
    return _positive(ms * 1e3 / nodes) if nodes else None
