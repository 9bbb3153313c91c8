"""Multi-host runtime: process bootstrap and per-process row blocks.

Counterpart of ``basic_sparse_matrix_tpu/parallel/multihost.py``, on
``torch.distributed`` instead of ``jax.distributed``:

* :func:`initialize` joins the process group (NCCL when the default device
  is the card, gloo on the CPU), once;
* :func:`global_row_mesh` is the ``"rows"`` mesh over the world;
* :func:`build_global_sharded_csr` has each process build only its own row
  block (``local_builder``), so no process ever holds the whole matrix: on
  a ``torch.distributed`` mesh the block IS the process's shard; on a local
  mesh (one process) it is split over the mesh's row ranks and placed with
  ``put_sharded``, as the JAX package does at process count 1.

A single process runs everything unchanged with a world of 1.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional

import numpy as np

from ..ops.csr import CSR, to_tensor
from ..utils.config import default_device
from .mesh import ROWS, Mesh, row_mesh
from .sharded import ShardedCSR, put_sharded, shard_csr

_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR")


def _world():
    """(this process's rank, the world size): (0, 1) without a group."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Join the process group: with ``coordinator_address`` (``host:port``
    or a URL) at ``tcp://`` there, with ``num_processes`` and
    ``process_id`` as world size and rank; with no arguments from the
    ``RANK``/``WORLD_SIZE``/``MASTER_ADDR`` environment (``env://``) where
    it is set, else nothing (a single process). A process whose group is
    up is left as it is: never initialised twice."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    if coordinator_address is None:
        if num_processes is None and process_id is None \
                and not all(k in os.environ for k in _ENV):
            return
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    kwargs = {}
    if num_processes is not None:
        kwargs["world_size"] = int(num_processes)
    if process_id is not None:
        kwargs["rank"] = int(process_id)
    backend = "nccl" if default_device().type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method, **kwargs)


def global_row_mesh() -> Mesh:
    """1-D ``"rows"`` mesh over the world (one rank per process), or over
    the logical ranks :func:`~.mesh.row_mesh` picks without a group."""
    return row_mesh()


@dataclasses.dataclass(frozen=True)
class RowBlockSpec:
    """Which global rows this process owns."""

    row_start: int
    row_end: int
    global_rows: int
    global_cols: int


def local_row_block(global_rows: int, global_cols: int,
                    process_id: Optional[int] = None,
                    process_count: Optional[int] = None) -> RowBlockSpec:
    """Contiguous equal row block of this process (``ceil(rows /
    processes)`` rows, the last block shorter)."""
    rank, world = _world()
    pid = rank if process_id is None else process_id
    pc = world if process_count is None else process_count
    per = -(-global_rows // pc)
    return RowBlockSpec(row_start=min(pid * per, global_rows),
                        row_end=min((pid + 1) * per, global_rows),
                        global_rows=global_rows, global_cols=global_cols)


def _padded(host, nnz_max: int):
    """Stacked shard arrays with the entry lists padded to ``nnz_max``
    (padding entries in each shard's last row, value 0, column 0)."""
    indptr, indices, values = host
    pad = nnz_max - indices.shape[1]
    if pad < 0:
        raise ValueError(f"nnz_max_per_device {nnz_max} below observed "
                         f"{indices.shape[1]}")
    if pad == 0:
        return host
    indptr = indptr.copy()
    indptr[:, -1] += pad
    return (indptr, np.pad(indices, ((0, 0), (0, pad))),
            np.pad(values, ((0, 0), (0, pad))))


def _own_shard(spec: RowBlockSpec, local: CSR, comm, device,
               nnz_max: Optional[int]) -> ShardedCSR:
    """This process's row block as shard ``comm.index`` of the world's
    equal-block partition, entry lists padded to ``nnz_max``."""
    rps = -(-spec.global_rows // comm.size)
    rows = spec.row_end - spec.row_start
    if spec.row_start != min(comm.index * rps, spec.global_rows) \
            or local.rows != rows or local.cols != spec.global_cols:
        raise ValueError(
            f"process {comm.index} of {comm.size} owns rows "
            f"[{comm.index * rps}, {(comm.index + 1) * rps}) of "
            f"{spec.global_rows}; got the block {spec} and a "
            f"{local.rows} × {local.cols} local CSR")
    if nnz_max is None:
        if comm.size > 1:
            raise ValueError(
                "build_global_sharded_csr on a world of more than one "
                "process needs nnz_max_per_device: every shard's entry "
                "list must have the same padded length, and no process "
                "sees the others' counts")
        nnz_max = max(local.stored, 1)
    indptr, indices, values = local.numpy()
    count = int(indptr[-1])
    ptr = np.full((1, rps + 1), count, dtype=np.int32)
    ptr[0, : rows + 1] = indptr
    ptr[0, rps] = max(count, 1)
    idx = np.zeros((1, max(count, 1)), dtype=np.int32)
    val = np.zeros((1, max(count, 1)), dtype=values.dtype)
    idx[0, :count], val[0, :count] = indices, values
    host = _padded((ptr, idx, val), nnz_max)
    return ShardedCSR(
        indptr=to_tensor(host[0], device), indices=to_tensor(host[1], device),
        values=to_tensor(host[2], device), rows=spec.global_rows,
        cols=spec.global_cols, rows_per_shard=rps, num_shards=comm.size,
        shards=(comm.index,), nnz=(count,), _host=host)


def build_global_sharded_csr(
    spec: RowBlockSpec,
    local_builder: Callable[[RowBlockSpec], CSR],
    mesh: Optional[Mesh] = None,
    nnz_max_per_device: Optional[int] = None,
) -> ShardedCSR:
    """A row-sharded CSR to which each process contributes only its own row
    block, built by ``local_builder(spec)`` as a ``(row_end - row_start,
    global_cols)`` CSR. Padded entry lists must have one length across the
    world, so ``nnz_max_per_device`` (a global agreement, e.g. a
    generator's analytic bound) is required where the world has more than
    one process; a single process may omit it."""
    mesh = mesh or global_row_mesh()
    local = local_builder(spec)
    comm = mesh.axis(ROWS)
    if len(comm.local) < comm.size:
        return _own_shard(spec, local, comm, mesh.device, nnz_max_per_device)
    sa = shard_csr(local, comm.size)
    if nnz_max_per_device is not None:
        sa = dataclasses.replace(sa, _host=_padded(sa._host,
                                                   nnz_max_per_device))
    return put_sharded(sa, mesh)


def weak_scaling_report(seconds: float, nnz_per_host: int,
                        baseline_seconds_1host: float) -> dict:
    """Weak-scaling efficiency record; hosts are the world's processes."""
    hosts = _world()[1]
    eff = baseline_seconds_1host / seconds if seconds else 0.0
    return {
        "hosts": hosts,
        "nnz_total": nnz_per_host * hosts,
        "seconds": seconds,
        "weak_scaling_efficiency": eff,
    }
