"""Spans the benchmark takes around calls into the program's layers."""

from __future__ import annotations

import contextlib
import inspect
import time
from typing import Callable


@contextlib.contextmanager
def around(owner, attr: str, sync: Callable[[], None],
           on_call: Callable[[float, object], None]):
    """Inside the block, each call of ``owner.attr`` ends with the device
    synchronised and calls ``on_call(seconds, result)``: the host clock from
    the call to that synchronise, and what the call returned. The attribute
    is restored on exit."""
    static = isinstance(inspect.getattr_static(owner, attr), staticmethod)
    orig = getattr(owner, attr)

    def wrapped(*args, **kwargs):
        t = time.perf_counter()
        res = orig(*args, **kwargs)
        sync()
        on_call(time.perf_counter() - t, res)
        return res

    setattr(owner, attr, staticmethod(wrapped) if static else wrapped)
    try:
        yield
    finally:
        setattr(owner, attr, staticmethod(orig) if static else orig)
