"""Captured CUDA graphs: the port's counterpart of ``jax.jit`` for a loop
with static shapes.

The JAX package runs each serving loop (the level loop of a triangular
solve, IC(0)-PCG's ``lax.while_loop``, Chebyshev's ``fori_loop``) as one
compiled device program. In the port the same loop is a sequence of small
torch operations, thousands of launches a call, and the host's launch
rate bounds it. :func:`run` captures such a loop once into a
``torch.cuda.CUDAGraph`` per (owner, tag, operand shapes) and replays it on
every later call, so the host issues one graph launch per call.

* Only CUDA operands are captured. On the CPU ``fn`` runs as it is and no
  graph is built.
* While the current stream is itself capturing (a triangular solve inside
  the PCG chunk), ``fn`` runs as it is, so that the outer graph records its
  operations: this is how graphs compose.
* The first call for a key runs ``fn`` once on a side stream (the warm-up
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

The cache is a ``WeakKeyDictionary`` keyed by the owner object (a
``TriangularSchedule``, ``PCGSetup`` or ``LanczosSetup``; dataclasses with
``eq=False``, so they hash by identity): a graph and its private memory
pool go with the owner, and checkpoints never see them.

``fn`` must not write to its operands, and must read device values only
through tensors (its operands or tensors the owner keeps): the graph
replays the operations it recorded, on the addresses it recorded.
"""

from __future__ import annotations

import collections
import dataclasses
import weakref
from typing import Callable, Tuple

import torch

# Graphs kept per owner; the least recently used goes first. Four covers a
# schedule's usual callers: 1 and k right-hand sides, one batched shape
# and its batch of one.
MAX_GRAPHS_PER_OWNER = 4


@dataclasses.dataclass(eq=False)
class _Graph:
    graph: "torch.cuda.CUDAGraph"
    inputs: Tuple[torch.Tensor, ...]    # static copies of the operands
    outputs: Tuple[torch.Tensor, ...]   # static results, in the graph's pool
    single: bool                        # fn returned one tensor


_GRAPHS: "weakref.WeakKeyDictionary[object, collections.OrderedDict]" = \
    weakref.WeakKeyDictionary()


def run(owner, tag, fn: Callable, *operands: torch.Tensor):
    """``fn(*operands)``; on CUDA operands through the graph cached for
    ``(owner, tag)`` and the operands' shapes, dtypes and device, captured
    on the first such call. ``tag`` names what ``fn`` computes for this
    owner, with any static parameter (an iteration count)."""
    if not operands[0].is_cuda or torch.cuda.is_current_stream_capturing():
        return fn(*operands)
    key = (tag,) + tuple((tuple(x.shape), x.dtype, x.device)
                         for x in operands)
    graphs = _GRAPHS.setdefault(owner, collections.OrderedDict())
    entry = graphs.get(key)
    with torch.cuda.device(operands[0].device):
        if entry is None:
            entry = _capture(fn, operands)
            graphs[key] = entry
            while len(graphs) > MAX_GRAPHS_PER_OWNER:
                graphs.popitem(last=False)
        else:
            graphs.move_to_end(key)
            for static, x in zip(entry.inputs, operands):
                static.copy_(x)
        entry.graph.replay()
        outs = tuple(o.clone() for o in entry.outputs)
    return outs[0] if entry.single else outs


def _capture(fn: Callable, operands) -> _Graph:
    inputs = tuple(x.detach().clone(memory_format=torch.contiguous_format)
                   for x in operands)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    # A host read inside a capture invalidates it, and the failed capture
    # leaves the allocator and the random generators in capture mode: the
    # warm-up raises on any synchronising operation instead.
    sync_mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.cuda.stream(side):
            fn(*inputs)
    finally:
        torch.cuda.set_sync_debug_mode(sync_mode)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(*inputs)
    single = isinstance(out, torch.Tensor)
    return _Graph(graph, inputs, (out,) if single else tuple(out), single)


def count(owner) -> int:
    """Graphs cached for ``owner``."""
    return len(_GRAPHS.get(owner, ()))


def owners() -> int:
    """Owners holding at least one graph."""
    return len(_GRAPHS)
