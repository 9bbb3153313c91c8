"""Cell-binned streaming SpMM: host plan, plain version and the K2 CUDA kernel.

Counterpart of ``basic_sparse_matrix_tpu/ops/pallas/stream_kernel.py``. The
host plan (:func:`build_stream_plan`, memoised per matrix and tile) bins
the stored entries by (row tile, k tile) cell, pads every cell to the
largest cell's population (rounded up to 16) with ``(i=0, k=0, v=0)``
slots, and lays them out as ``(ncells, 1, cellmax)`` arrays — the same
arrays, for the same tiles, as the JAX package builds. :func:`spmm_stream`
computes ``C[rt*tile_m + i, :] += v * B[kt*tile_k + k, :]`` over all slots:

* on a CUDA tensor with the hand-written kernel ``csrc/spmm_stream.cu``
  (one thread block per row tile and column slice, output tile in shared
  memory), or it raises;
* on a CPU tensor with :func:`spmm_stream_reference`, the plain version.

The JAX package's three ``layout`` values are three TPU register layouts of
one function; here one kernel serves all three. The CUDA target's tiles are
its own: :func:`pick_tile_m` sizes the output tile for Hopper's shared
memory, and ``cuda_stream_tile_k`` (default: one k tile) bins by column.
``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ...utils.config import get_config
from ..csr import to_tensor

# Launches of the K2 CUDA kernel in this process (a plain counter that a
# caller may reset to 0).
LAUNCHES = 0

# The JAX package's default tiles; build_stream_plan keeps them as defaults
# so the plan arrays equal the JAX package's for the same arguments.
DEFAULT_TILE_M = 4096
DEFAULT_TILE_K = 2048

LAYOUTS = ("row", "vreg", "vregp")

# Shared memory one thread block's output tile may take. Under 48 KB no
# opt-in is needed, and up to seven such blocks fit one SM's 227 KB, which
# keeps enough warps resident to overlap the B-row gathers.
SMEM_TILE_BYTES = 48 * 1024
# Largest dynamic shared memory one thread block can have on Hopper.
SMEM_MAX_BYTES = 232448
# Threads of one thread block; each owns 4 adjacent columns (1 when the
# RHS width is no multiple of 4), so a block covers up to 512 columns.
THREADS = 128

# The plain version gathers (slots, n) products; it takes the cells in
# chunks whose gather stays under this many bytes.
REFERENCE_BUDGET_BYTES = 1 << 30


@dataclasses.dataclass(eq=False)
class StreamPlan:
    """Cell-binned entry layout for the streaming kernel."""

    ii: torch.Tensor   # (ncells, 1, cellmax) int32 — tile-local row index
    kk: torch.Tensor   # (ncells, 1, cellmax) int32 — tile-local col index
    vv: torch.Tensor   # (ncells, 1, cellmax) f32 — value (0 = padding)
    rows: int
    cols: int
    tile_m: int
    tile_k: int
    n_rt: int
    n_kt: int
    nnz: int

    @property
    def cellmax(self) -> int:
        return int(self.ii.shape[-1])

    @property
    def pad_factor(self) -> float:
        return self.ii.shape[0] * self.ii.shape[-1] / max(self.nnz, 1)

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.ii, self.kk, self.vv))


def make_stream_plan(ii: np.ndarray, kk: np.ndarray, vv: np.ndarray, *,
                     rows: int, cols: int, tile_m: int, tile_k: int,
                     nnz: int, device=None) -> StreamPlan:
    """A plan from host arrays, validated once here so that the kernel can
    index without bounds checks: shapes, ``0 <= i < tile_m``,
    ``0 <= k < tile_k``, and every slot's global row and column in range."""
    n_rt = max(-(-rows // tile_m), 1)
    n_kt = max(-(-cols // tile_k), 1)
    ii = np.asarray(ii, dtype=np.int32)
    kk = np.asarray(kk, dtype=np.int32)
    vv = np.asarray(vv, dtype=np.float32)
    if not (ii.ndim == 3 and ii.shape[:2] == (n_rt * n_kt, 1)
            and kk.shape == ii.shape and vv.shape == ii.shape
            and ii.shape[2] % 16 == 0):
        raise ValueError(f"stream plan arrays {ii.shape}/{kk.shape}/"
                         f"{vv.shape} do not fit {n_rt}x{n_kt} cells with "
                         f"cellmax a multiple of 16")
    if ii.size:
        # Largest global row of each row tile / column of each k tile.
        grow = np.arange(n_rt, dtype=np.int64) * tile_m \
            + ii.reshape(n_rt, -1).max(axis=1)
        gcol = np.arange(n_kt, dtype=np.int64) * tile_k \
            + kk.reshape(n_rt, n_kt, -1).max(axis=(0, 2))
        if not (ii.min() >= 0 and ii.max() < tile_m and kk.min() >= 0
                and kk.max() < tile_k and grow.max() < max(rows, 1)
                and gcol.max() < max(cols, 1)):
            raise ValueError("stream plan indices out of range")
    return StreamPlan(ii=to_tensor(ii, device), kk=to_tensor(kk, device),
                      vv=to_tensor(vv, device), rows=rows, cols=cols,
                      tile_m=tile_m, tile_k=tile_k, n_rt=n_rt, n_kt=n_kt,
                      nnz=nnz)


def build_stream_plan(rows_idx: np.ndarray, cols_idx: np.ndarray,
                      vals: np.ndarray, rows: int, cols: int,
                      tile_m: int = DEFAULT_TILE_M,
                      tile_k: int = DEFAULT_TILE_K,
                      device=None) -> StreamPlan:
    """Bin entries by (row tile, k tile) cell (host, O(nnz log nnz), once
    per matrix). Zero-valued entries are dropped (they include ELL padding
    slots)."""
    rows_idx = np.asarray(rows_idx).ravel()
    cols_idx = np.asarray(cols_idx).ravel()
    vals = np.asarray(vals).ravel()
    live = vals != 0
    rows_idx, cols_idx, vals = rows_idx[live], cols_idx[live], vals[live]
    nnz = vals.shape[0]
    n_rt = max(-(-rows // tile_m), 1)
    n_kt = max(-(-cols // tile_k), 1)
    cell = (rows_idx // tile_m).astype(np.int64) * n_kt \
        + cols_idx // tile_k
    order = np.argsort(cell, kind="stable")
    cell = cell[order]
    counts = np.bincount(cell, minlength=n_rt * n_kt)
    cellmax = max(int(counts.max()) if nnz else 0, 1)
    cellmax = -(-cellmax // 16) * 16
    ncells = n_rt * n_kt
    slot = np.arange(nnz) - np.concatenate(
        [[0], np.cumsum(counts)])[cell]
    ii = np.zeros((ncells, 1, cellmax), dtype=np.int32)
    kk = np.zeros((ncells, 1, cellmax), dtype=np.int32)
    vv = np.zeros((ncells, 1, cellmax), dtype=np.float32)
    ii[cell, 0, slot] = (rows_idx[order] % tile_m).astype(np.int32)
    kk[cell, 0, slot] = (cols_idx[order] % tile_k).astype(np.int32)
    vv[cell, 0, slot] = vals[order]
    return make_stream_plan(ii, kk, vv, rows=rows, cols=cols, tile_m=tile_m,
                            tile_k=tile_k, nnz=nnz, device=device)


def spmm_stream_reference(plan: StreamPlan, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K2: every slot's product ``v * B[k]`` added
    into row ``i`` with ``index_add_``, cells taken in chunks bounded by
    ``REFERENCE_BUDGET_BYTES`` of gathered rows."""
    n = int(b.shape[1])
    b = b.float()
    dev = b.device
    out = torch.zeros((plan.n_rt * plan.tile_m, n), dtype=torch.float32,
                      device=dev)
    ncells, cellmax = plan.n_rt * plan.n_kt, plan.cellmax
    chunk = max(1, REFERENCE_BUDGET_BYTES // max(cellmax * n * 4, 1))
    cells = torch.arange(ncells, device=dev)
    for c0 in range(0, ncells, chunk):
        c = cells[c0: c0 + chunk]
        rt, kt = c // plan.n_kt, c % plan.n_kt
        grow = rt[:, None] * plan.tile_m + plan.ii[c0: c0 + chunk, 0].long()
        gcol = kt[:, None] * plan.tile_k + plan.kk[c0: c0 + chunk, 0].long()
        prod = b.index_select(0, gcol.reshape(-1)) \
            * plan.vv[c0: c0 + chunk, 0].reshape(-1, 1)
        out.index_add_(0, grow.reshape(-1), prod)
    return out[: plan.rows]


def _slice_width(tile_m: int, n: int, vec: int) -> int:
    """Column slice of one thread block: ``n`` rounded up to whole warps,
    at most 128 threads' worth, halved until the output tile fits shared
    memory."""
    cw = min(THREADS * vec, -(-n // (32 * vec)) * 32 * vec)
    while tile_m * cw * 4 > SMEM_MAX_BYTES and cw > vec:
        cw //= 2
    if tile_m * cw * 4 > SMEM_MAX_BYTES:
        raise ValueError(f"tile_m={tile_m} is too tall for a Hopper thread "
                         f"block's shared memory")
    return cw


def spmm_stream(plan: StreamPlan, b: torch.Tensor,
                layout: str = "vreg") -> torch.Tensor:
    """SpMM against a pre-binned plan: the K2 CUDA kernel for a CUDA ``b``,
    the plain version for a CPU one. ``layout`` ("row", "vreg" or "vregp",
    the JAX package's TPU register layouts) selects nothing here: all three
    are the same function. Returns (rows, n) float32."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    if b.ndim != 2 or b.shape[0] != plan.cols:
        raise ValueError(f"RHS {tuple(b.shape)} does not fit a plan with "
                         f"{plan.cols} cols")
    if not b.is_cuda:
        return spmm_stream_reference(plan, b)
    global LAUNCHES
    from ...runtime import cuda_kernels

    for t in (plan.ii, plan.kk, plan.vv):
        if t.device != b.device:
            raise ValueError(f"plan on {t.device}, RHS on {b.device}")
        if not t.is_contiguous():
            raise ValueError("stream plan tensors must be contiguous")
    if b.dtype != torch.float32:
        raise TypeError(f"CUDA SpMM kernels take float32, got {b.dtype}")
    b = b.contiguous()
    n = int(b.shape[1])
    vec = 4 if n % 4 == 0 and b.data_ptr() % 16 == 0 else 1
    cw = _slice_width(plan.tile_m, n, vec)
    out = torch.empty((plan.rows, n), dtype=torch.float32, device=b.device)
    lib = cuda_kernels.load()
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream(b.device).cuda_stream
        status = lib.bsm_spmm_stream(
            plan.ii.data_ptr(), plan.kk.data_ptr(), plan.vv.data_ptr(),
            b.data_ptr(), out.data_ptr(), plan.n_rt, plan.n_kt,
            plan.cellmax, plan.tile_m, plan.tile_k, plan.rows, n, n, n, cw,
            vec, stream)
    LAUNCHES += 1
    cuda_kernels.check_launch(lib, status, "spmm_stream")
    return out


def pick_tile_m(rows: int, n_rhs: int) -> int:
    """Output-tile height for the CUDA kernel: the largest power of two
    whose ``tile_m x slice x 4 B`` tile fits ``SMEM_TILE_BYTES``, where the
    slice is the RHS width rounded up to 128 columns, at most 512. Capped
    at the matrix's own height (rounded up to a power of two)."""
    cw = min(THREADS * 4, -(-max(n_rhs, 1) // 128) * 128)
    tm = 1
    while 2 * tm * cw * 4 <= SMEM_TILE_BYTES:
        tm *= 2
    return min(tm, 1 << max(rows - 1, 0).bit_length())


def stream_plan_from_ell(ell, n_rhs: int = 512) -> Optional[StreamPlan]:
    """Build (and memoise on the ELL instance, per tile) the CUDA target's
    streaming plan from the host mirrors ``csr_to_ell`` keeps, never from a
    device copy. Tiles: config ``cuda_stream_tile_m`` (0: pick_tile_m) and
    ``cuda_stream_tile_k`` (0: one k tile over all columns). Returns
    ``None`` when no host mirror exists."""
    cfg = get_config()
    tile_m = cfg.cuda_stream_tile_m or pick_tile_m(ell.n_rows, n_rhs)
    tile_k = cfg.cuda_stream_tile_k or max(ell.n_cols, 1)
    plan = ell._stream_plans.get((tile_m, tile_k))
    if plan is None:
        cols, vals = ell._host_cols, ell._host_vals
        if cols is None or vals is None:
            return None
        rows = np.repeat(np.arange(ell.n_rows), cols.shape[1])
        plan = build_stream_plan(rows, cols.ravel(), vals.ravel(),
                                 ell.n_rows, ell.n_cols, tile_m=tile_m,
                                 tile_k=tile_k, device=ell.vals.device)
        ell._stream_plans[(tile_m, tile_k)] = plan
    return plan
