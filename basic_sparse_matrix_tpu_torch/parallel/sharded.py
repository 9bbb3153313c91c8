"""Row-partitioned CSR for a mesh.

Counterpart of ``basic_sparse_matrix_tpu/parallel/sharded.py``. A
:class:`ShardedCSR` splits rows into ``num_shards`` contiguous blocks of
equal (padded) size ``rows_per_shard`` and pads every shard's entry list to
the largest shard's, so the three arrays stack to ``(S, rps + 1)``,
``(S, nnz_max)``, ``(S, nnz_max)``. The trailing padded rows of a shard are
empty; its last local row absorbs the entry padding (value 0, column 0).
:func:`shard_csr` builds these arrays on the host exactly as the JAX
package does, entry for entry.

A process keeps only the shards of the ranks it runs: all of them on a
local mesh, its own on a ``torch.distributed`` one. ``shards`` names them,
in order, and the arrays' leading dim runs over them; ``nnz`` holds each
one's true entry count (the padded arrays lose it where a shard's rows are
all live: its last row pointer is then ``nnz_max``).

The products do not work on the padded arrays: :meth:`ShardedCSR.local`
gives each held shard as a port :class:`~..ops.csr.CSR` of shape
``(rps, cols)`` with the padding left out, built once from the host arrays
and kept, so the host plans of ``spmm_auto``'s rungs (ELL, stream plan,
BSR) are built once per shard and cached with it. A padding entry would
make the last row of a shard long, and a long row sends a shard off the
ELL and streaming rungs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops.csr import CSR, to_tensor
from .mesh import ROWS, Mesh


@dataclasses.dataclass(eq=False)
class ShardedCSR:
    """Stacked per-shard CSR arrays of the held ``shards`` (leading dim),
    with the whole matrix's ``rows``, ``cols``, ``rows_per_shard`` and
    ``num_shards``, and each held shard's true entry count ``nnz``.
    ``_host`` keeps the numpy arrays the tensors came from."""

    indptr: torch.Tensor    # (len(shards), rows_per_shard + 1) int32
    indices: torch.Tensor   # (len(shards), nnz_max) int32
    values: torch.Tensor    # (len(shards), nnz_max)
    rows: int
    cols: int
    rows_per_shard: int
    num_shards: int
    shards: Tuple[int, ...]
    nnz: Tuple[int, ...]
    _host: Tuple[np.ndarray, np.ndarray, np.ndarray] = dataclasses.field(
        repr=False, default=None)
    _local: Dict[int, CSR] = dataclasses.field(
        default_factory=dict, init=False, repr=False)
    _col_blocks: Dict[Tuple[int, int], CSR] = dataclasses.field(
        default_factory=dict, init=False, repr=False)

    @property
    def padded_rows(self) -> int:
        return self.num_shards * self.rows_per_shard

    @property
    def device(self) -> torch.device:
        return self.values.device

    def _host_shard(self, s: int):
        indptr, indices, values = self._host
        i = self.shards.index(s)
        nnz = self.nnz[i]
        return np.minimum(indptr[i], nnz), indices[i, :nnz], values[i, :nnz]

    def local(self, s: int) -> CSR:
        """Shard ``s`` as a ``(rows_per_shard, cols)`` CSR on the shards'
        device, without the entry padding; built once."""
        if s not in self._local:
            ptr, idx, val = self._host_shard(s)
            self._local[s] = CSR.from_host(
                ptr, idx, val, (self.rows_per_shard, self.cols),
                device=self.device)
        return self._local[s]

    def col_block(self, s: int, owner: int, kps: int) -> CSR:
        """The entries of shard ``s`` whose column lies in panel ``owner``
        (columns ``owner·kps .. (owner + 1)·kps``), with columns counted
        from the panel's start: a ``(rows_per_shard, kps)`` CSR, built once
        on the host (the ring's per-step operand)."""
        key = (s, owner)
        if key not in self._col_blocks:
            ptr, idx, val = self._host_shard(s)
            rows = np.repeat(np.arange(self.rows_per_shard), np.diff(ptr))
            keep = (idx >= owner * kps) & (idx < (owner + 1) * kps)
            counts = np.bincount(rows[keep], minlength=self.rows_per_shard)
            bptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
            self._col_blocks[key] = CSR.from_host(
                bptr, idx[keep] - owner * kps, val[keep],
                (self.rows_per_shard, kps), device=self.device)
        return self._col_blocks[key]


def shard_csr(a: CSR, num_shards: int) -> ShardedCSR:
    """Host-side row partition of ``a`` into ``num_shards`` equal blocks;
    every shard held, on the CPU (``put_sharded`` places them)."""
    indptr, indices, values = a.numpy()
    rps = -(-a.rows // num_shards)  # rows per shard (ceil)
    bounds = []
    for s in range(num_shards):
        r0 = min(s * rps, a.rows)
        r1 = min((s + 1) * rps, a.rows)
        bounds.append((r0, r1, int(indptr[r0]), int(indptr[r1])))
    nnz_max = max(max(hi - lo for _, _, lo, hi in bounds), 1)

    out_indptr = np.zeros((num_shards, rps + 1), dtype=np.int32)
    out_indices = np.zeros((num_shards, nnz_max), dtype=np.int32)
    out_values = np.zeros((num_shards, nnz_max), dtype=values.dtype)
    for s, (r0, r1, lo, hi) in enumerate(bounds):
        out_indptr[s, : r1 - r0 + 1] = indptr[r0: r1 + 1].astype(np.int64) \
            - lo
        out_indptr[s, r1 - r0:] = hi - lo  # trailing padded rows: empty
        out_indptr[s, rps] = nnz_max       # last row absorbs entry padding
        out_indices[s, : hi - lo] = indices[lo:hi]
        out_values[s, : hi - lo] = values[lo:hi]
    return ShardedCSR(
        indptr=to_tensor(out_indptr, "cpu"),
        indices=to_tensor(out_indices, "cpu"),
        values=to_tensor(out_values, "cpu"), rows=a.rows, cols=a.cols,
        rows_per_shard=rps, num_shards=num_shards,
        shards=tuple(range(num_shards)),
        nnz=tuple(hi - lo for _, _, lo, hi in bounds),
        _host=(out_indptr, out_indices, out_values))


def put_sharded(sa: ShardedCSR, mesh: Mesh) -> ShardedCSR:
    """Keep the shards of the ranks this process runs along ``"rows"``,
    on the mesh's device (shard ``s`` belongs to rank ``s`` of that
    axis)."""
    comm = mesh.axis(ROWS)
    if comm.size != sa.num_shards:
        raise ValueError(f"{sa.num_shards} shards on a mesh of {comm.size} "
                         f"row ranks")
    pick = [sa.shards.index(s) for s in comm.local]
    host = tuple(np.ascontiguousarray(x[pick]) for x in sa._host)
    return ShardedCSR(
        indptr=to_tensor(host[0], mesh.device),
        indices=to_tensor(host[1], mesh.device),
        values=to_tensor(host[2], mesh.device), rows=sa.rows, cols=sa.cols,
        rows_per_shard=sa.rows_per_shard, num_shards=sa.num_shards,
        shards=tuple(comm.local), nnz=tuple(sa.nnz[i] for i in pick),
        _host=host)


def held_rows(blocks: List[torch.Tensor], shards, block_rows: int,
              rows: Optional[int] = None) -> torch.Tensor:
    """The row blocks of the held ``shards`` (consecutive ranks), stacked
    in order: the rows of the global row-sharded array that this process
    holds; all of it on a local mesh. With ``rows``, the global rows at or
    past ``rows`` (the padding of the partition) are left out."""
    out = torch.cat(blocks) if len(blocks) > 1 else blocks[0]
    if rows is None:
        return out
    keep = min(max(rows - shards[0] * block_rows, 0), out.shape[0])
    return out[:keep]


def unshard_rows(y_padded: torch.Tensor, rows: int,
                 mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Trim the row padding of the equal-block partition. On a mesh whose
    process holds only its own row block, pass ``mesh``: the blocks are
    gathered along ``"rows"`` first."""
    if mesh is not None and not mesh.holds_all:
        (y_padded,) = mesh.axis(ROWS).all_gather([y_padded])
    return y_padded[:rows]
