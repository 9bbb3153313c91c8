"""Captured CUDA graphs: the port's counterpart of ``jax.jit`` for a loop
with static shapes.

The JAX package runs each numeric and serving loop as one compiled device
program. In the port the same loop is a sequence of small torch
operations, thousands of launches a call, and the host's launch rate
bounds it. :func:`run` captures such a loop into a ``torch.cuda.CUDAGraph``
per (owner, tag, operand shapes) and replays it on every later call, so
the host issues one graph launch per call. The loops and their owners:

* the level loop of a triangular solve (``models/sparse_triangular``),
  owner the ``TriangularSchedule``;
* IC(0)-PCG's chunk of iterations (``models/pcg``), owner the
  ``PCGSetup``;
* Chebyshev's iterations and Lanczos' steps (``models/chebyshev``,
  ``models/lanczos``), owner the ``LanczosSetup``;
* the supernodal numeric phase (``models/supernodal``), owner the
  ``SupernodalSchedule``; the scatter-list one (``models/sparse_cholesky``),
  owner the ``CholeskySchedule``;
* the banded scan solve and the BCR solve (``models/banded``,
  ``models/bcr``), owners the ``BandedFactor`` and the ``BCRSolver``;
* the QR eigen-iteration (``models/qr``), one owner for the module, keyed
  by the operand's shape and dtype as ``jax.jit`` caches;
* the distributed programs of ``parallel/`` (``jax.jit(jax.shard_map(...))``
  in the JAX package), through ``parallel/comm.py::compiled``, which adds
  the communicator's key to the tag: the sharded triangular solve (owner
  the ``TriangularSchedule``), the sharded scatter-list and supernodal
  numeric phases (the ``CholeskySchedule``, the ``SupernodalSchedule``),
  CG, PCG, Chebyshev and Lanczos (the ``ShardedCSR``) and the sharded BCR
  solve (one owner for the module). A ``TorchDistComm`` over NCCL keeps
  its graphs on a holder of its own per owner, so that they go with it; a
  gloo communicator runs the programs op by op.

Rules:

* Only CUDA operands are captured. On the CPU ``fn`` runs as it is and no
  graph is built or call counted.
* While the current stream is itself capturing (a triangular solve inside
  the PCG chunk), ``fn`` runs as it is, so that the outer graph records its
  operations: this is how graphs compose.
* ``capture_on``: the call of a key that captures. The calls before it run
  ``fn`` eagerly and only count (the count lives in the owner's entry, so
  it goes with the owner). The solves, PCG and Chebyshev capture on their
  first call (1); the numeric phases, Lanczos and the QR iteration on
  their second (2), so that a one-shot factorization or set-up pays no
  warm-up or capture.
* The capturing call runs ``fn`` once on a side stream (the warm-up
  ``torch.cuda.graph`` needs, which also builds anything made lazily) with
  synchronising operations made errors, captures it on static copies of
  the operands, and replays the graph. Later calls copy the operands into
  those static buffers and replay.
* Each result is a fresh tensor (a clone of the graph's static output), as
  a JAX result is a new array: the next replay does not overwrite it.
* A warm-up, capture or replay that fails raises; nothing runs the eager
  loop in a graph's place on the card. A host read in ``fn`` (``.item()``,
  ``bool``, ``.cpu()``, a data-dependent shape) fails in the warm-up,
  before the capture begins, so the process stays usable.
* A tag names every host-side value the recorded program depends on (an
  iteration count, a formulation; :func:`host_state` gives the matmul
  precision and the deterministic-algorithms flag): a graph replays the
  operations it recorded, so a changed setting must make a new key.

The cache is a ``WeakKeyDictionary`` keyed by the owner object (dataclasses
with ``eq=False``, so they hash by identity): a graph and its private
memory pool go with the owner, and checkpoints never see them.

``fn`` must not write to its operands, and must read device values only
through tensors (its operands or tensors the owner keeps): the graph
replays the operations it recorded, on the addresses it recorded.

While the recorder is on (``runtime/profiling.py``), :func:`run` counts
``graphs.eager`` (a counted eager call before the capture),
``graphs.captures``, ``graphs.evictions``, ``graphs.replays`` (the
capturing call replays too) and ``graphs.nodes`` (the replayed graph's
nodes, counted once at its capture and added at each replay), and records
the spans ``bsm.graphs.capture`` and ``bsm.graphs.replay``; the replay span
carries ``device_ms`` from a CUDA event pair around ``replay()``. Spans
inside a captured ``fn`` are recorded at its capture, never at a replay.
Counts made inside a captured ``fn`` (``trsv.launches``) are the graph's:
tallied at its capture (``profiling.tally``; the warm-up's are dropped)
and added at each replay, the capturing call's included, as the work the
replay does.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import weakref
from typing import Callable, Optional, Tuple

import torch

from . import profiling

# Graphs kept per owner; the least recently used goes first. Four covers a
# schedule's usual callers, which serve either one device or one mesh: 1
# and k right-hand sides, one batched shape and its batch of one; a
# numeric phase at one or two value shapes beside its sharded phase; a
# ShardedCSR's CG, PCG, Chebyshev and Lanczos at one iteration count each.
# A schedule that serves one device and a mesh at two shapes each is at
# the limit; a fifth key evicts the oldest, which then captures anew.
MAX_GRAPHS_PER_OWNER = 4


@dataclasses.dataclass(eq=False)
class _Graph:
    graph: "torch.cuda.CUDAGraph"
    inputs: Tuple[torch.Tensor, ...]    # static copies of the operands
    outputs: Tuple[torch.Tensor, ...]   # static results, in the graph's pool
    single: bool                        # fn returned one tensor
    nodes: Optional[int]                # the graph's nodes, None if unread
    counts: dict                        # counts fn made at the capture


@dataclasses.dataclass(eq=False)
class _Entry:
    graphs: collections.OrderedDict = dataclasses.field(
        default_factory=collections.OrderedDict)
    calls: dict = dataclasses.field(default_factory=dict)  # eager calls a key


_GRAPHS: "weakref.WeakKeyDictionary[object, _Entry]" = \
    weakref.WeakKeyDictionary()


def host_state() -> tuple:
    """The host settings a recorded numeric program depends on: the
    configured matmul precision (TF32 or not) and whether torch's
    deterministic algorithms are on (another ``index_add_`` kernel)."""
    from ..utils.config import get_config

    return (get_config().matmul_precision.lower(),
            torch.are_deterministic_algorithms_enabled())


def run(owner, tag, fn: Callable, *operands: torch.Tensor,
        capture_on: int = 1):
    """``fn(*operands)``; on CUDA operands through the graph cached for
    ``(owner, tag)`` and the operands' shapes, dtypes and device, captured
    on the ``capture_on``-th such call (the earlier ones run ``fn``
    eagerly). ``tag`` names what ``fn`` computes for this owner, with any
    static parameter (an iteration count)."""
    if not operands[0].is_cuda or torch.cuda.is_current_stream_capturing():
        return fn(*operands)
    key = (tag,) + tuple((tuple(x.shape), x.dtype, x.device)
                         for x in operands)
    owned = _GRAPHS.setdefault(owner, _Entry())
    graphs = owned.graphs
    entry = graphs.get(key)
    if entry is None and owned.calls.get(key, 0) + 1 < capture_on:
        owned.calls[key] = owned.calls.get(key, 0) + 1
        profiling.count("graphs.eager")
        return fn(*operands)
    with torch.cuda.device(operands[0].device):
        captured = entry is None
        if captured:
            with profiling.span("bsm.graphs.capture"):
                entry = _capture(fn, operands)
            profiling.count("graphs.captures")
            owned.calls.pop(key, None)
            graphs[key] = entry
            while len(graphs) > MAX_GRAPHS_PER_OWNER:
                graphs.popitem(last=False)
                profiling.count("graphs.evictions")
        else:
            graphs.move_to_end(key)
        with profiling.span("bsm.graphs.replay") as sp:
            if not captured:
                for static, x in zip(entry.inputs, operands):
                    static.copy_(x)
            profiling.count("graphs.replays")
            if entry.nodes is not None:
                profiling.count("graphs.nodes", entry.nodes)
            for name, n in entry.counts.items():
                profiling.count(name, n)
            if sp is not None:
                sp.device_start()
            entry.graph.replay()
            if sp is not None:
                sp.device_end()
            outs = tuple(o.clone() for o in entry.outputs)
    return outs[0] if entry.single else outs


# One warm-up stream per device, made once: cuBLAS and cuSOLVER keep a
# workspace per (handle, stream) for the life of the process, so a fresh
# stream per capture would leave one behind at every capture.
_WARM_UP_STREAMS: dict = {}


def _capture(fn: Callable, operands) -> _Graph:
    inputs = tuple(x.detach().clone(memory_format=torch.contiguous_format)
                   for x in operands)
    device = torch.cuda.current_device()
    side = _WARM_UP_STREAMS.get(device)
    if side is None:
        side = _WARM_UP_STREAMS[device] = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    # A host read inside a capture invalidates it, and the failed capture
    # leaves the allocator and the random generators in capture mode: the
    # warm-up raises on any synchronising operation instead.
    sync_mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.cuda.stream(side), profiling.tally():
            fn(*inputs)
    finally:
        torch.cuda.set_sync_debug_mode(sync_mode)
    torch.cuda.current_stream().wait_stream(side)
    try:
        graph, kept = torch.cuda.CUDAGraph(keep_graph=True), True
    except TypeError:   # a torch without keep_graph: the count is not read
        graph, kept = torch.cuda.CUDAGraph(), False
    with profiling.tally() as counts, torch.cuda.graph(graph):
        out = fn(*inputs)
    nodes = None
    if kept:
        nodes = _node_count(graph)
        graph.instantiate()
    single = isinstance(out, torch.Tensor)
    return _Graph(graph, inputs, (out,) if single else tuple(out), single,
                  nodes, dict(counts))


@functools.lru_cache(maxsize=None)
def _get_nodes():
    """``cudaGraphGetNodes`` of the CUDA runtime this process has loaded
    (torch's), else the driver's ``cuGraphGetNodes`` (the same graph
    handle); None without either. Both take (graph, NULL, &count)."""
    try:
        with open("/proc/self/maps") as f:
            found = sorted({line.split()[-1] for line in f
                            if "libcudart" in line})
    except OSError:
        found = []
    for path, name in [(p, "cudaGraphGetNodes") for p in found] \
            + [("libcuda.so.1", "cuGraphGetNodes")]:
        try:
            fn = getattr(ctypes.CDLL(path), name)
        except (OSError, AttributeError):
            continue
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.POINTER(ctypes.c_size_t)]
        fn.restype = ctypes.c_int
        return fn
    return None


def _node_count(graph) -> Optional[int]:
    """Nodes of a graph captured with ``keep_graph=True`` (read before it
    is instantiated), or None where the count cannot be read."""
    try:
        raw = graph.raw_cuda_graph()
    except (AttributeError, RuntimeError):
        return None
    fn = _get_nodes()
    n = ctypes.c_size_t(0)
    if fn is None or fn(ctypes.c_void_p(raw), None, ctypes.byref(n)) != 0:
        return None
    return int(n.value)


def count(owner) -> int:
    """Graphs cached for ``owner``."""
    owned = _GRAPHS.get(owner)
    return len(owned.graphs) if owned is not None else 0


def calls(owner) -> int:
    """Eager calls counted for ``owner`` towards a later capture."""
    owned = _GRAPHS.get(owner)
    return sum(owned.calls.values()) if owned is not None else 0


def owners() -> int:
    """Owners holding at least one graph."""
    return sum(1 for owned in list(_GRAPHS.values()) if owned.graphs)
