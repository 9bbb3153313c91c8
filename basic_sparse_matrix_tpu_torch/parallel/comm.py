"""Communicators: the collectives of one mesh axis, over the ranks this
process runs.

No counterpart in the JAX package, which writes each algorithm once as a
per-device body under ``jax.shard_map`` with XLA collectives in it
(``all_gather``, ``psum``, ``ppermute``). ``torch.distributed`` runs one
process per rank instead, and one process cannot simulate a mesh by
calling a per-rank function rank after rank: the first rank would block in
its first collective. So every algorithm of ``parallel/`` is written in
bulk-synchronous form: a process runs the members ``local`` of an axis,
each step maps over them, and each collective takes one tensor per local
member and returns one per local member.

Two communicators implement the same five methods:

* :class:`LocalComm` runs every member of the axis in this process (the
  logical shards of one device, or of the CPU). A gathered or reduced
  result is ONE tensor handed to every member, never a copy per member.
* :class:`TorchDistComm` runs one member per process over a
  ``torch.distributed`` process group (NCCL on the card, gloo on the CPU).

Member ``i`` of an axis of ``size`` members:

* ``all_gather(xs)``: the members' tensors concatenated along dim 0 in
  member order (JAX ``all_gather(x, axis, tiled=True)``); with
  ``tiled=False`` stacked on a new dim 0.
* ``all_reduce(xs)``: the sum over members, added in member order,
  ``((x_0 + x_1) + x_2) + ...`` (JAX ``psum``). Both communicators add in
  that order, so their results agree bit for bit; ``TorchDistComm`` gathers
  the summands and adds them locally rather than trusting the backend's
  reduction order (the operands are scalars and k-vectors).
* ``ring_shift(xs)``: member ``i`` receives member ``(i + 1) % size``'s
  tensor and sends its own to ``(i - 1) % size`` (JAX ``ppermute`` with
  ``perm = [(i, (i - 1) % size)]``). At size 1 it returns the input and
  posts nothing.
* ``shift(xs, offset)``: the non-cyclic shift. Member ``i`` receives member
  ``i - offset``'s tensor, or zeros where no such member exists (JAX
  ``ppermute`` with pairs ``(i, i + offset)``: the open edge is filled with
  zeros). At size 1 (``offset != 0``) it returns zeros and posts nothing.

Compiled programs. The JAX package runs each distributed loop as one
``jax.jit(jax.shard_map(...))`` program; the port records it as one CUDA
graph (``runtime/graphs.py``) through :func:`compiled`. A communicator
gives the graph three things:

* ``capturable``: whether its collectives can be recorded. ``LocalComm``'s
  are plain tensor operations; a ``TorchDistComm``'s only where its backend
  is NCCL (gloo's collectives copy through the host, which a capture
  refuses), decided from the backend up front. A communicator that is not
  capturable runs the program op by op.
* ``graph_key``: its part of the graph's tag, so that one owner's graphs on
  two meshes, and its sharded and single-device graphs, never share a key.
* ``graph_owner(owner)``: where the graphs are kept. ``LocalComm`` has no
  state and keeps them on ``owner`` (a schedule, a ``ShardedCSR``).
  A ``TorchDistComm``'s graphs hold NCCL kernels recorded on its process
  group, so it keeps them itself, one holder per owner: they go when
  either the communicator or the owner goes, and a call after the process
  group was destroyed raises instead of replaying.
"""

from __future__ import annotations

import weakref
from typing import List, Sequence

import torch


def _ordered_sum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


class LocalComm:
    """Every member of the axis in this process."""

    capturable = True

    def __init__(self, size: int):
        if size < 1:
            raise ValueError(f"a mesh axis needs at least 1 member, got "
                             f"{size}")
        self.size = int(size)
        self.local: List[int] = list(range(self.size))

    @property
    def graph_key(self) -> tuple:
        return ("local", self.size)

    def graph_owner(self, owner):
        return owner

    def all_gather(self, xs: Sequence[torch.Tensor], tiled: bool = True
                   ) -> List[torch.Tensor]:
        out = torch.cat(list(xs)) if tiled else torch.stack(list(xs))
        return [out] * self.size

    def all_reduce(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        return [_ordered_sum(xs)] * self.size

    def ring_shift(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        xs = list(xs)
        return xs[1:] + xs[:1]

    def shift(self, xs: Sequence[torch.Tensor], offset: int
              ) -> List[torch.Tensor]:
        xs = list(xs)
        return [xs[i - offset] if 0 <= i - offset < self.size
                else torch.zeros_like(xs[i]) for i in range(self.size)]


class TorchDistComm:
    """One member per process: this process is member ``index`` of the
    axis whose members are the global ranks ``ranks`` (in axis order),
    joined by ``group`` (``None``: the default group, when ``ranks`` is the
    whole world)."""

    def __init__(self, ranks: Sequence[int], index: int, group=None):
        import torch.distributed as dist

        self.ranks = [int(r) for r in ranks]
        self.size = len(self.ranks)
        self.index = int(index)
        self.group = group
        self.local: List[int] = [self.index]
        # the process group the collectives run on, held so that its
        # identity in graph_key is not reused while this communicator lives
        self._pg = dist.group.WORLD if group is None else group
        self.backend = str(dist.get_backend(self._pg))
        self._graph_owners = weakref.WeakKeyDictionary()

    @property
    def capturable(self) -> bool:
        """NCCL collectives can be recorded in a CUDA graph; gloo's cannot
        (they stage CUDA tensors through the host)."""
        return self.backend == "nccl"

    @property
    def graph_key(self) -> tuple:
        return ("dist", self.backend, tuple(self.ranks), self.index,
                id(self._pg))

    def graph_owner(self, owner):
        """The holder of the graphs this communicator records for
        ``owner``, kept here: a graph never outlives the communicator whose
        NCCL calls it holds."""
        import torch.distributed as dist

        if not (dist.is_initialized() and (self.group is not None
                                           or dist.group.WORLD is self._pg)):
            raise RuntimeError("TorchDistComm: its process group was "
                               "destroyed; make a new mesh")
        holder = self._graph_owners.get(owner)
        if holder is None:
            holder = self._graph_owners[owner] = _GraphHolder()
        return holder

    def _gather(self, x: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist

        out = torch.empty((self.size,) + tuple(x.shape), dtype=x.dtype,
                          device=x.device)
        gather = getattr(dist, "all_gather_single", None) \
            or dist.all_gather_into_tensor
        gather(out, x.contiguous().unsqueeze(0), group=self.group)
        return out

    def all_gather(self, xs: Sequence[torch.Tensor], tiled: bool = True
                   ) -> List[torch.Tensor]:
        (x,) = xs
        out = self._gather(x)
        return [out.reshape((-1,) + tuple(x.shape[1:])) if tiled else out]

    def all_reduce(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        (x,) = xs
        return [_ordered_sum(self._gather(x).unbind(0))]

    def ring_shift(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        (x,) = xs
        if self.size == 1:
            return [x]
        import torch.distributed as dist

        x = x.contiguous()
        buf = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x,
                          self.ranks[(self.index - 1) % self.size],
                          self.group),
               dist.P2POp(dist.irecv, buf,
                          self.ranks[(self.index + 1) % self.size],
                          self.group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return [buf]

    def shift(self, xs: Sequence[torch.Tensor], offset: int
              ) -> List[torch.Tensor]:
        (x,) = xs
        if offset == 0:
            return [x]
        import torch.distributed as dist

        x = x.contiguous()
        buf = torch.zeros_like(x)
        src, dst = self.index - offset, self.index + offset
        ops = []
        if 0 <= dst < self.size:
            ops.append(dist.P2POp(dist.isend, x, self.ranks[dst], self.group))
        if 0 <= src < self.size:
            ops.append(dist.P2POp(dist.irecv, buf, self.ranks[src],
                                  self.group))
        if ops:     # an edge rank posts one side; a lone rank posts none
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return [buf]


class _GraphHolder:
    """The graphs one ``TorchDistComm`` recorded for one owner."""


def compiled(comm, owner, tag: tuple, fn, *operands, capture_on: int = 1):
    """``fn(*operands)``, the per-process body of a distributed program, as
    one compiled program: on CUDA operands and a capturable ``comm`` the
    CUDA graph of ``runtime/graphs.py`` kept for ``owner`` under ``tag``
    and the communicator's key, captured on the ``capture_on``-th call
    (the JAX package's ``jax.jit(jax.shard_map(...))``); otherwise op by
    op. ``fn`` follows ``graphs.run``'s rules: it reads device values only
    through its operands and tensors the owner keeps, writes none of its
    operands and reads nothing back to the host."""
    if not comm.capturable:
        return fn(*operands)
    from ..runtime import graphs

    return graphs.run(comm.graph_owner(owner), tuple(tag) + comm.graph_key,
                      fn, *operands, capture_on=capture_on)
