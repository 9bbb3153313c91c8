"""Profiling: the port's one recorder of spans, counters and set-up laps, and
roofline figures.

Counterpart of ``basic_sparse_matrix_tpu/runtime/profiling.py``: per-op
metrics (nnz/s, GFLOP/s, bytes moved), a roofline calculator against a
card's published peaks, and the program's own tracing.

**Spans and counters.** The program's layer boundaries open spans
(:func:`span`, every name ``bsm.``-prefixed) and add to counters
(:func:`count`). A span holds its name, its start and end
(``time.perf_counter_ns``), its parent span and its request: the outermost
span open when it started. Both are recorded only while a ``torch.profiler``
session is active or a :func:`recording` block is open. Otherwise a span
costs one check and returns a shared no-op context, and a counter one check.
Under the profiler each span is also a ``record_function`` range, so it sits
on the profiler's host timeline, the clock of its device events; inside a
:func:`recording` block alone it is not (``record_function`` costs
microseconds even with no profiler running).

A session's record starts empty. :func:`snapshot` returns the last
session's record until the next session begins. A profiler session is seen
to begin at the first span or counter while it is active, and to end at the
first call into the recorder (a snapshot included) after it.

**Set-up laps** (:class:`Laps`) are always taken: they happen once per
set-up. Each is written to its owner's ``timings`` dict and to a
process-wide table under ``<owner>.<phase>`` (the last value), and while
recording is on it is also a span ``bsm.<owner>.<phase>``.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import time
from typing import Dict, Iterator, Optional, Tuple

import torch
from torch.autograd.profiler import record_function

_profiler_enabled = torch._C._autograd._profiler_enabled


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """Peak numbers of one device, the roofline's denominators. The field
    names are the JAX package's: ``mxu_f32`` is the rate of a product that
    is accurate to float32, ``mxu_bf16`` the matrix units' bf16 rate;
    ``tf32`` (new here) the tensor cores' TF32 rate."""

    name: str
    hbm_bw: float       # bytes/s
    mxu_f32: float      # FLOP/s, float32
    mxu_bf16: float     # FLOP/s
    tf32: float = 0.0   # FLOP/s, 0 where the device has no such mode


# NVIDIA H100 SXM5 80 GB, from NVIDIA's H100 data sheet (dense rates, no
# sparsity, at the full 700 W power limit): HBM3 at 3.35 TB/s; 67 TFLOP/s
# float32 on the CUDA cores; 495 TFLOP/s TF32 and 989 TFLOP/s bf16 on the
# tensor cores.
H100 = ChipSpec(name="nvidia-h100-sxm", hbm_bw=3.35e12, mxu_f32=67e12,
                mxu_bf16=989e12, tf32=495e12)
# Placeholder figures for runs without a GPU (the tests): not a measurement
# of any host.
CPU = ChipSpec(name="cpu", hbm_bw=100e9, mxu_f32=1e12, mxu_bf16=2e12)


def detect_chip(device=None) -> ChipSpec:
    """The spec of ``device`` (default: the current CUDA device when there
    is one, else the CPU), read from ``torch.cuda.get_device_properties``.
    A card without an entry here raises: pass a :class:`ChipSpec` of its
    own to :meth:`OpMetrics.roofline_fraction` instead."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type != "cuda":
        return CPU
    name = torch.cuda.get_device_properties(device).name
    if "H100" in name:
        return H100
    raise ValueError(f"no peak numbers recorded for {name!r}; pass a "
                     f"ChipSpec")


@dataclasses.dataclass
class OpMetrics:
    op: str
    seconds: float
    flops: float = 0.0
    bytes_moved: float = 0.0
    nnz: int = 0

    @property
    def gflops_per_s(self) -> float:
        return self.flops / self.seconds / 1e9 if self.seconds else 0.0

    @property
    def nnz_per_s(self) -> float:
        return self.nnz / self.seconds if self.seconds else 0.0

    def roofline_fraction(self, chip: Optional[ChipSpec] = None) -> float:
        """Achieved fraction of the bound = t_bound / t_measured with
        t_bound = max(memory time, float32 compute time)."""
        chip = chip or detect_chip()
        t_mem = self.bytes_moved / chip.hbm_bw
        t_flop = self.flops / chip.mxu_f32
        t_bound = max(t_mem, t_flop)
        return t_bound / self.seconds if self.seconds else 0.0

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["gflops_per_s"] = self.gflops_per_s
        d["nnz_per_s"] = self.nnz_per_s
        d["roofline_fraction"] = self.roofline_fraction()
        return json.dumps(d)


# ---- the recorder -------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Span:
    """A recorded span. ``parent`` and ``request`` are indices into the
    snapshot's spans (``request`` is the span's own index at a root);
    ``end_ns`` is None while the span is still open."""

    name: str
    start_ns: int
    end_ns: Optional[int]
    parent: Optional[int]
    request: int
    attrs: dict

    @property
    def seconds(self) -> float:
        return 0.0 if self.end_ns is None else \
            (self.end_ns - self.start_ns) * 1e-9


@dataclasses.dataclass(frozen=True)
class Snapshot:
    """One session's spans (in the order they opened) and counters, and
    the process-wide table of set-up laps (seconds)."""

    spans: Tuple[Span, ...]
    counters: Dict[str, int]
    laps: Dict[str, float]

    def requests(self) -> int:
        """Request roots: spans with no parent."""
        return sum(1 for s in self.spans if s.parent is None)

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per span name over the closed spans: ``count``, ``total_s`` and
        ``self_s``, a span's duration less what its child spans cover."""
        children = collections.defaultdict(list)
        for s in self.spans:
            if s.parent is not None and s.end_ns is not None:
                children[s.parent].append((s.start_ns, s.end_ns))
        out: Dict[str, Dict[str, float]] = {}
        for i, s in enumerate(self.spans):
            if s.end_ns is None:
                continue
            covered, reach = 0, s.start_ns
            for c0, c1 in sorted(children[i]):
                c0, c1 = max(c0, reach), min(c1, s.end_ns)
                if c1 > c0:
                    covered += c1 - c0
                    reach = c1
            row = out.setdefault(s.name, {"count": 0, "total_s": 0.0,
                                          "self_s": 0.0})
            row["count"] += 1
            row["total_s"] += s.seconds
            row["self_s"] += (s.end_ns - s.start_ns - covered) * 1e-9
        return out


class _Record:
    """One session: the spans opened, the indices of those still open, and
    the counters."""

    def __init__(self):
        self.spans: list = []
        self.stack: list = []
        self.counters: collections.Counter = collections.Counter()

    def opened(self, span: "_Span") -> None:
        span.index = len(self.spans)
        span.parent = self.stack[-1] if self.stack else None
        span.request = self.stack[0] if self.stack else span.index
        self.spans.append(span)


class _Span:
    """An open or closed span of a record; the context manager
    :func:`span` returns while recording is on."""

    __slots__ = ("rec", "name", "attrs", "index", "parent", "request",
                 "start_ns", "end_ns", "_range", "_events")

    def __init__(self, rec: _Record, name: str, attrs: dict):
        self.rec, self.name, self.attrs = rec, name, attrs
        self.end_ns = self._range = self._events = None

    def __enter__(self) -> "_Span":
        self.rec.opened(self)
        self.rec.stack.append(self.index)
        if _profiler_enabled():
            self._range = record_function(self.name)
            self._range.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        stack = self.rec.stack
        if stack and stack[-1] == self.index:
            stack.pop()
        return False

    def device_start(self) -> None:
        """Record a timing event on the current CUDA stream; with
        :meth:`device_end` it gives the span's ``device_ms``, resolved at
        :func:`snapshot` (nothing waits for the device here)."""
        self._events = [torch.cuda.Event(enable_timing=True), None]
        self._events[0].record()

    def device_end(self) -> None:
        self._events[1] = torch.cuda.Event(enable_timing=True)
        self._events[1].record()

    def frozen(self) -> Span:
        if self._events is not None and self._events[1] is not None:
            start, end = self._events
            end.synchronize()
            self.attrs["device_ms"] = start.elapsed_time(end)
            self._events = None
        return Span(self.name, self.start_ns, self.end_ns, self.parent,
                    self.request, dict(self.attrs))


class _Recorder:
    def __init__(self):
        self.record = _Record()
        self.live = False     # ``record`` belongs to a session still open
        self.depth = 0        # open recording() blocks

    def active(self) -> Optional[_Record]:
        """The record to write to, or None while recording is off."""
        if self.depth:
            return self.record
        if _profiler_enabled():
            if not self.live:
                self.record, self.live = _Record(), True
            return self.record
        if self.live:
            self.live = False
        return None


_REC = _Recorder()
# name -> seconds, the last lap of each ``<owner>.<phase>``.
_LAPS: Dict[str, float] = {}


# The shared no-op span: ``with span(...) as s`` gives None.
_OFF = contextlib.nullcontext()


def span(name: str, **attrs):
    """A context manager that records the span ``name`` (with ``attrs``)
    while recording is on; off, a shared no-op whose ``as`` target is
    None."""
    rec = _REC.active()
    return _OFF if rec is None else _Span(rec, name, attrs)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while recording is on."""
    rec = _REC.active()
    if rec is not None:
        rec.counters[name] += n


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Record spans and counters inside the block, without the profiler.
    The outermost block starts an empty record, unless a profiler session
    is already being recorded, which it then continues."""
    rec = _REC
    if not rec.depth and not (rec.live and _profiler_enabled()):
        rec.record, rec.live = _Record(), True
    rec.depth += 1
    try:
        yield
    finally:
        rec.depth -= 1
        if not rec.depth:
            rec.live = bool(_profiler_enabled())


def snapshot() -> Snapshot:
    """The current or last session's spans and counters, and the laps
    table. Replay spans' device times are resolved here (waiting for their
    end events)."""
    rec = _REC.active() or _REC.record
    return Snapshot(spans=tuple(s.frozen() for s in rec.spans),
                    counters=dict(rec.counters), laps=dict(_LAPS))


class Laps:
    """Set-up laps of ``owner`` on the host clock, each ended by a
    synchronise of ``device`` (a CUDA device, and no synchronise while the
    current stream is capturing) so that a lap holds the device work it
    queued. :meth:`lap` writes the seconds since the last lap (or since the
    clock was made) to ``out[phase]``, the owner's ``timings``, and to the
    process-wide table under ``<owner>.<phase>``; while recording is on it
    is also a span ``bsm.<owner>.<phase>``."""

    def __init__(self, owner: str, device, out: Optional[dict] = None):
        self.owner, self.device = owner, torch.device(device)
        self.out = {} if out is None else out
        self.t0 = time.perf_counter_ns()

    def lap(self, phase: str) -> float:
        if (self.device.type == "cuda"
                and not torch.cuda.is_current_stream_capturing()):
            torch.cuda.synchronize(self.device)
        now = time.perf_counter_ns()
        seconds = (now - self.t0) * 1e-9
        self.out[phase] = seconds
        _LAPS[f"{self.owner}.{phase}"] = seconds
        rec = _REC.active()
        if rec is not None:
            s = _Span(rec, f"bsm.{self.owner}.{phase}", {})
            rec.opened(s)
            s.start_ns, s.end_ns = self.t0, now
        self.t0 = now
        return seconds


@contextlib.contextmanager
def timed(op: str, *, flops: float = 0.0, bytes_moved: float = 0.0,
          nnz: int = 0, device=None) -> Iterator[OpMetrics]:
    """Timer context that yields an :class:`OpMetrics` and sets its
    ``seconds`` on exit; while recording is on it is also a span
    ``bsm.<op>`` carrying the metrics' fields. On a CUDA ``device``
    (default: the current one when there is one) the time is the device's,
    between two CUDA events on the current stream
    (``runtime.timing.CudaTimer``; the exit waits for the work). On the
    CPU it is the host clock."""
    from .timing import CudaTimer

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    m = OpMetrics(op=op, seconds=0.0, flops=flops, bytes_moved=bytes_moved,
                  nnz=nnz)
    timer = CudaTimer(device) if device.type == "cuda" else None
    with span(f"bsm.{op}") as s:
        t0 = time.perf_counter()
        try:
            if timer is None:
                yield m
            else:
                with timer:
                    yield m
        finally:
            m.seconds = (time.perf_counter() - t0 if timer is None
                         else timer.ms / 1e3)
            if s is not None:
                s.attrs.update(dataclasses.asdict(m))


def spmm_cost(nnz: int, n_rhs: int, rows: int, cols: int,
              dtype_bytes: int = 4) -> Dict[str, float]:
    """Roofline cost model for gather-style SpMM: every stored entry reads
    one RHS row and the output is written once."""
    flops = 2.0 * nnz * n_rhs
    bytes_moved = (
        nnz * (dtype_bytes + 4)               # values + col indices
        + min(nnz, cols) * n_rhs * dtype_bytes  # RHS rows touched (≥ once)
        + rows * n_rhs * dtype_bytes          # output
    )
    return {"flops": flops, "bytes_moved": bytes_moved}
