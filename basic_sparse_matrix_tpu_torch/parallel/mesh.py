"""Device mesh of the port: axis names, shape, one communicator per axis
and the device this process's ranks compute on.

Counterpart of ``basic_sparse_matrix_tpu/parallel/mesh.py`` with the same
axis conventions: ``"rows"`` partitions matrix rows, ``"cols"`` partitions
dense RHS columns. Ranks are numbered row-major over the shape, as
``jax.sharding.Mesh`` lays devices out, so flat rank ``r · n_cols + c``
sits at ``(rows = r, cols = c)``.

A mesh runs on one of two communicators (``parallel/comm.py``):

* ``comm="local"``: :class:`~.comm.LocalComm`, every rank in this
  process; all ranks share one device (logical shards of one card, or the
  CPU).
* ``comm="dist"``: :class:`~.comm.TorchDistComm`, one rank per process of
  the initialised ``torch.distributed`` process group; the mesh's shape
  must hold the world. An axis that spans the whole world uses the default
  group; the axes of a 2-D mesh get one subgroup per line (every process
  creates every subgroup, in the same order, as ``new_group`` demands).

``comm=None`` picks ``"dist"`` when a process group is initialised and
``"local"`` otherwise.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..utils.config import default_device
from .comm import LocalComm, TorchDistComm

ROWS = "rows"
COLS = "cols"


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """``axis_names`` and ``sizes`` in mesh order, one communicator per
    axis (``axis(name)``) and ``device``, where this process's ranks keep
    their shards. ``shape[name]`` is an axis's size, as on a JAX mesh."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    comms: Dict[str, object]
    device: torch.device

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    def axis(self, name: str):
        """The communicator of axis ``name``: its ``local`` members are
        the positions along that axis that this process runs."""
        return self.comms[name]

    @property
    def holds_all(self) -> bool:
        """Whether this process runs every rank (a local mesh)."""
        return all(isinstance(c, LocalComm) for c in self.comms.values())


def _lines(sizes: Sequence[int], axis: int) -> List[List[int]]:
    """Flat ranks of every line along ``axis`` (row-major numbering), each
    in axis order, the lines in order of their other coordinates."""
    idx = torch.arange(math.prod(sizes)).reshape(tuple(sizes))
    moved = idx.movedim(axis, -1).reshape(-1, sizes[axis])
    return [row.tolist() for row in moved]


def _dist_comms(axis_names, sizes) -> Dict[str, TorchDistComm]:
    import torch.distributed as dist

    world, me = dist.get_world_size(), dist.get_rank()
    if math.prod(sizes) != world:
        raise ValueError(f"mesh shape {tuple(sizes)} does not hold the "
                         f"world of {world} processes")
    comms = {}
    for ax, name in enumerate(axis_names):
        for line in _lines(sizes, ax):
            group = None if len(line) == world else dist.new_group(line)
            if me in line:
                comms[name] = TorchDistComm(line, line.index(me), group)
    return comms


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axis_names: Sequence[str] = (ROWS, COLS),
              comm: Optional[str] = None, device=None) -> Mesh:
    """A mesh of ``shape`` on communicator ``comm`` ("local" or "dist";
    ``None`` as the module docstring says). With no ``shape``: a 1-D row
    mesh over the world of the process group, or over
    ``torch.cuda.device_count()`` logical ranks on a card (one on the
    CPU). ``device`` defaults to the configured default device (the card;
    :func:`~..utils.config.default_device` raises ``NoDefaultDevice``
    where there is none and the CPU was not asked for)."""
    import torch.distributed as dist

    if comm is None:
        comm = "dist" if dist.is_available() and dist.is_initialized() \
            else "local"
    if comm not in ("local", "dist"):
        raise ValueError(f"comm must be 'local' or 'dist', got {comm!r}")
    dev = default_device(device)
    if shape is None:
        if comm == "dist":
            n = dist.get_world_size()
        else:
            n = torch.cuda.device_count() if dev.type == "cuda" else 1
        shape, axis_names = (n,), tuple(axis_names)[:1]
    sizes = tuple(int(s) for s in shape)
    names = tuple(axis_names)[: len(sizes)]
    if len(names) != len(sizes):
        raise ValueError(f"mesh shape {sizes} needs {len(sizes)} axis "
                         f"names, got {tuple(axis_names)}")
    if comm == "dist":
        comms = _dist_comms(names, sizes)
    else:
        comms = {name: LocalComm(s) for name, s in zip(names, sizes)}
    return Mesh(axis_names=names, sizes=sizes, comms=comms, device=dev)


def row_mesh(num: Optional[int] = None, comm: Optional[str] = None,
             device=None) -> Mesh:
    """1-D mesh over ``num`` ranks (default: as :func:`make_mesh` with no
    shape), axis ``"rows"``."""
    if num is None:
        return make_mesh(None, (ROWS,), comm=comm, device=device)
    return make_mesh((int(num),), (ROWS,), comm=comm, device=device)
