"""Device time of one multigrid V-cycle, ms: the mean ``device_ms`` (the
program's CUDA event pair around a graph replay) of the replays under the
program's ``bsm.mg.apply`` span in the traced slice, the V-cycle each PCG
set starts with, replayed as a graph of its own. None where the program
recorded no such replay."""

from typing import Optional

from portbench.program import snapshot


def read(_record) -> Optional[float]:
    snap = snapshot()
    if snap is None:
        return None
    ms = [s.attrs["device_ms"] for s in snap.spans
          if s.name == "bsm.graphs.replay" and "device_ms" in s.attrs
          and s.parent is not None
          and snap.spans[s.parent].name == "bsm.mg.apply"]
    return sum(ms) / len(ms) if ms else None
