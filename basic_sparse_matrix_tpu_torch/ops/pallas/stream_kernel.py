"""Cell-binned streaming SpMM: host plan, plain version and the K2 CUDA kernel.

Counterpart of ``basic_sparse_matrix_tpu/ops/pallas/stream_kernel.py``. The
host plan (:func:`build_stream_plan`, memoised per matrix and tile) bins
the stored entries by (row tile, k tile) cell, pads every cell to the
largest cell's population (rounded up to 16) with ``(i=0, k=0, v=0)``
slots, and lays them out as ``(ncells, 1, cellmax)`` arrays — the same
arrays, for the same tiles, as the JAX package builds. :func:`spmm_stream`
computes ``C[rt*tile_m + i, :] += v * B[kt*tile_k + k, :]`` over all slots:

* on a CUDA tensor with one of the two hand-written kernels of
  ``csrc/spmm_stream.cu``, chosen by shape (:func:`pick_stream_kernel`), or
  it raises:

  - ``"tile"``: one thread block per row tile and column slice, output tile
    in shared memory, one whole row of B read per slot. Any plan.
  - ``"sliced"``: the columns of B cut into slices of ``w`` columns over
    all K rows, a persistent grid that sweeps every row for one slice
    before any block moves to the next, a few threads per row with the
    row's sum in registers (:func:`spmm_stream_sliced`). At ``w = 32`` a
    row's piece of B is one whole 128-byte L2 line: the slice (K x 128
    bytes) stays in L2 where it fits and streams at the HBM rate where it
    does not. Plans with one k tile whose cells keep their slots sorted by
    row, float32 ``B`` with ``N % 4 == 0``. One width only: narrower
    slices of a ``B`` repacked slice-major lose to the tile kernel on the
    H100, because a gather of 32-byte pieces from L2 is no faster than the
    tile kernel's 2 KB reads from HBM;

* on a CPU tensor with :func:`spmm_stream_reference`, the plain version of
  both kernels. :func:`spmm_stream_sliced_model` is a pure-torch model of
  the sliced kernel's arithmetic (slices, per-row sums) for the tests.

The JAX package's three ``layout`` values are three TPU register layouts of
one function; here they select nothing. The CUDA target's tiles are its
own: :func:`pick_tile_m` sizes the output tile for Hopper's shared memory,
and ``cuda_stream_tile_k`` (default: one k tile) bins by column.
``LAUNCHES`` counts :func:`spmm_stream`, :func:`spmm_stream_tile` and
:func:`spmm_stream_sliced` calls that launched a kernel,
``LAUNCHES_BY_KERNEL`` the same per kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ...runtime import profiling
from ...utils.config import get_config
from ..csr import to_tensor

# Launches of the K2 CUDA kernel in this process (a plain counter that a
# caller may reset to 0).
LAUNCHES = 0
LAUNCHES_BY_KERNEL = {"tile": 0, "sliced": 0}

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

# Columns of B in one slice of the sliced kernel: one whole 128-byte line a
# row, so B is read as it lies.
SLICE_WIDTH = 32
# A B (K x N x 4 bytes) up to this size is taken as L2-resident as it lies,
# and keeps the tile kernel. The H100's L2 is 50 MB; a gather of 32-byte
# pieces from all SMs reads a 16 MB array at 4.4 TB/s, a 32 MB one at 3.2
# and a 64 MB one at 1.7 TB/s (probes/stream_slice_probe.py), so what a
# gather can use of it ends between 32 and 64 MB.
L2_SLICE_BUDGET_BYTES = 32 << 20
# In the sliced kernel one thread group walks a row's slots one after
# another, 16 slices over (n = 512): about 1.9 us a slot of the longest row,
# whatever the size of the matrix, while what the kernel gains grows with
# the rows. So a plan keeps the tile kernel (which spreads every slot over
# the whole block, but walks the padding a long row brings) when its longest
# row has more than rows / LONG_ROW_ROWS slots. Measured on the H100 with one
# long row among rows of 32 entries, n = 512, tile / sliced ms
# (probes/stream_slice_probe.py --long-rows): 50k rows 256 slots 0.916 /
# 0.870, 512 slots 1.002 / 1.310; 200k rows 1024 slots 5.03 / 4.44, 2048
# slots 6.12 / 6.66; 1M rows 4096 slots 43.6 / 35.3. Under 50k rows the
# crossing is not measured.
LONG_ROW_ROWS = 192

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
    # Memo of cell_row_pointers(): (row_ptr or None, longest_row).
    _rows: Optional[Tuple[Optional[torch.Tensor], int]] = dataclasses.field(
        default=None, init=False, repr=False)

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


def cell_row_pointers(plan: StreamPlan
                      ) -> Tuple[Optional[torch.Tensor], int]:
    """Per-cell row pointers for the sliced kernel, derived once from
    ``plan.ii`` on the plan's device and memoised on the plan:
    ``row_ptr[c, i] .. row_ptr[c, i + 1]`` are the slots of cell ``c`` that
    hold tile-local row ``i`` ((ncells, tile_m + 1) int32), and the length of
    the longest row of any cell. Live slots are those with ``v != 0``
    (``build_stream_plan`` drops zeros; padding is ``v = 0``). The pointers
    exist only where every cell keeps its live slots first and sorted by row,
    as ``build_stream_plan``'s stable sort leaves them; otherwise
    ``(None, longest)``."""
    if plan._rows is None:
        ii, live = plan.ii[:, 0, :].long(), plan.vv[:, 0, :] != 0
        ncells = ii.shape[0]
        ordered = bool(((live[:, :-1] | ~live[:, 1:])
                        & ((ii[:, 1:] >= ii[:, :-1]) | ~live[:, 1:])).all())
        cell = torch.arange(ncells, device=ii.device)[:, None]
        counts = torch.bincount((cell * plan.tile_m + ii)[live],
                                minlength=ncells * plan.tile_m
                                ).view(ncells, plan.tile_m)
        longest = int(counts.max()) if counts.numel() else 0
        row_ptr = None
        if ordered:
            row_ptr = torch.zeros((ncells, plan.tile_m + 1),
                                  dtype=torch.int32, device=ii.device)
            row_ptr[:, 1:] = counts.cumsum(1)
        plan._rows = (row_ptr, longest)
    return plan._rows


def slice_width(k: int, n: int, n_kt: int) -> int:
    """Columns per slice the sliced kernel takes for a (k, n) right-hand
    side, or 0 where it does not apply: more than one k tile, ``n`` no
    multiple of 4, or a ``B`` that fits ``L2_SLICE_BUDGET_BYTES`` whole
    (the tile kernel's reads then hit L2 anyway). Where it applies the
    width is ``SLICE_WIDTH`` = 32, read as ``B`` lies: measured on the
    H100 at 32 entries a row and n = 512, sliced / tile ms at K = 200k
    (slice 25.6 MB, in L2) 2.46 / 4.45, at 400k 5.54 / 9.27, at 1M (slice
    128 MB, streamed) 21.4 / 23.7, and every narrower width slower than the
    tile kernel."""
    if n_kt != 1 or n % 4 != 0 or k * n * 4 <= L2_SLICE_BUDGET_BYTES:
        return 0
    return SLICE_WIDTH


def pick_stream_kernel(rows: int, k: int, n: int, n_kt: int,
                       longest_row: int) -> Tuple[str, int]:
    """The kernel :func:`spmm_stream` launches for a plan of ``rows`` rows
    with ``n_kt`` k tiles and a longest row of ``longest_row`` slots against
    a (k, n) right-hand side, by shape alone: ``("sliced", w)`` where
    :func:`slice_width` gives a width and no row has more than
    ``rows / LONG_ROW_ROWS`` slots, else ``("tile", 0)``."""
    w = slice_width(k, n, n_kt)
    if w and longest_row * LONG_ROW_ROWS <= rows:
        return "sliced", w
    return "tile", 0


def spmm_stream_sliced_model(plan: StreamPlan,
                             b: torch.Tensor) -> torch.Tensor:
    """Pure-torch model of the sliced kernel: cut ``b`` into slices of
    ``SLICE_WIDTH`` columns (the last one zero-padded), then for every slice
    sum each row's slots (``row_ptr`` gives them; padding is never visited)
    and write the row's outputs. Plans with one k tile whose cells are
    sorted by row. Returns (rows, n) float32."""
    row_ptr, _ = cell_row_pointers(plan)
    if row_ptr is None or plan.n_kt != 1:
        raise ValueError("the sliced kernel takes plans with one k tile "
                         "whose cells keep their slots sorted by row")
    k, n = (int(x) for x in b.shape)
    w = SLICE_WIDTH
    n_slices = -(-n // w)
    padded = torch.zeros((k, n_slices * w), dtype=torch.float32,
                         device=b.device)
    padded[:, :n] = b
    packed = padded.view(k, n_slices, w).permute(1, 0, 2)  # (slices, K, w)
    lens = torch.diff(row_ptr.long(), dim=1)               # (ncells, tile_m)
    first = row_ptr[:, :-1].long() + plan.cellmax * torch.arange(
        row_ptr.shape[0], device=row_ptr.device)[:, None]
    row_of = torch.repeat_interleave(
        torch.arange(lens.numel(), device=lens.device), lens.reshape(-1))
    # flat slot index of every live slot, row by row in slot order
    start = torch.cumsum(lens.reshape(-1), 0) - lens.reshape(-1)
    slot = first.reshape(-1)[row_of] + (
        torch.arange(row_of.numel(), device=lens.device) - start[row_of])
    # one k tile: row_of numbers (row tile, tile-local row) pairs, which are
    # the global rows
    kk = plan.kk.reshape(-1)[slot].long()
    vv = plan.vv.reshape(-1)[slot]
    out = torch.zeros((packed.shape[0], plan.n_rt * plan.tile_m, w),
                      dtype=torch.float32, device=b.device)
    for s in range(packed.shape[0]):
        out[s].index_add_(0, row_of, packed[s][kk] * vv[:, None])
    return out.permute(1, 0, 2).reshape(out.shape[1], -1)[: plan.rows, :n] \
        .contiguous()


def _tile_columns(tile_m: int, n: int, vec: int) -> int:
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


def _check_cuda_operands(plan: StreamPlan, b: torch.Tensor) -> None:
    for t in (plan.ii, plan.kk, plan.vv):
        if t.device != b.device:
            raise ValueError(f"plan on {t.device}, RHS on {b.device}")
        if not t.is_contiguous():
            raise ValueError("stream plan tensors must be contiguous")
    if b.dtype != torch.float32:
        raise TypeError(f"CUDA SpMM kernels take float32, got {b.dtype}")


def _count(kernel: str) -> None:
    global LAUNCHES
    LAUNCHES += 1
    LAUNCHES_BY_KERNEL[kernel] += 1


def spmm_stream_tile(plan: StreamPlan, b: torch.Tensor) -> torch.Tensor:
    """SpMM against ``plan`` by the tile kernel on a CUDA ``b`` (any plan,
    any width), whatever :func:`spmm_stream` would pick. Counts one
    launch."""
    from ...runtime import cuda_kernels

    if not b.is_cuda:
        raise ValueError("spmm_stream_tile launches a CUDA kernel; for a "
                         "CPU tensor use spmm_stream")
    _check_cuda_operands(plan, b)
    b = b.contiguous()
    n = int(b.shape[1])
    vec = 4 if n % 4 == 0 and b.data_ptr() % 16 == 0 else 1
    cw = _tile_columns(plan.tile_m, n, vec)
    out = torch.empty((plan.rows, n), dtype=torch.float32, device=b.device)
    lib = cuda_kernels.load()
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream(b.device).cuda_stream
        status = lib.bsm_spmm_stream(
            plan.ii.data_ptr(), plan.kk.data_ptr(), plan.vv.data_ptr(),
            b.data_ptr(), out.data_ptr(), plan.n_rt, plan.n_kt,
            plan.cellmax, plan.tile_m, plan.tile_k, plan.rows, n, n, n, cw,
            vec, stream)
    _count("tile")
    cuda_kernels.check_launch(lib, status, "spmm_stream (tile kernel)")
    return out


def spmm_stream_sliced(plan: StreamPlan, b: torch.Tensor) -> torch.Tensor:
    """SpMM against ``plan`` by the sliced kernel (slices of ``SLICE_WIDTH``
    columns, ``b`` read as it lies, C written row-major) on a CUDA float32
    ``b`` (K, N), ``N % 4 == 0``, whatever :func:`spmm_stream` would pick;
    raises where the kernel does not apply (more than one k tile, cells not
    sorted by row). Counts one launch."""
    from ...runtime import cuda_kernels

    if not b.is_cuda:
        raise ValueError("spmm_stream_sliced launches a CUDA kernel; for a "
                         "CPU tensor use spmm_stream")
    _check_cuda_operands(plan, b)
    k, n = (int(x) for x in b.shape)
    row_ptr, _ = cell_row_pointers(plan)
    if row_ptr is None or plan.n_kt != 1 or k != plan.cols or n % 4:
        raise ValueError(f"the sliced kernel takes a plan with one k tile "
                         f"whose cells are sorted by row and N % 4 == 0; got "
                         f"{plan.n_kt} k tiles, sorted {row_ptr is not None}, "
                         f"B {tuple(b.shape)}")
    b = b.contiguous()
    out = torch.empty((plan.rows, n), dtype=torch.float32, device=b.device)
    lib = cuda_kernels.load()
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream(b.device).cuda_stream
        status = lib.bsm_spmm_stream_sliced(
            row_ptr.data_ptr(), plan.kk.data_ptr(), plan.vv.data_ptr(),
            b.data_ptr(), out.data_ptr(), plan.rows, n, plan.tile_m,
            plan.cellmax, n, n, stream)
    _count("sliced")
    cuda_kernels.check_launch(lib, status, "spmm_stream (sliced kernel)")
    return out


def spmm_stream(plan: StreamPlan, b: torch.Tensor,
                layout: str = "vreg") -> torch.Tensor:
    """SpMM against a pre-binned plan: a K2 CUDA kernel for a CUDA ``b``,
    the plain version for a CPU one. Returns (rows, n) float32.

    Which kernel, by shape (:func:`pick_stream_kernel`): the sliced kernel
    where the plan has one k tile, ``B`` (K x N x 4 bytes) is larger than
    ``L2_SLICE_BUDGET_BYTES`` (1M x 512: 2 GB), ``N % 4 == 0``, the cells
    are sorted by row and no row has more than ``rows / LONG_ROW_ROWS``
    slots (1M rows: 5208),
    with slices of 32 columns read as ``B`` lies; the tile kernel
    everywhere else (a ``B`` that fits L2 whole, several k tiles, ragged
    widths, one very long row). A kernel that fails to build or launch
    raises; neither steps down to the other or to the plain version. The
    row pointers and the longest row are derived on the first call and kept
    on the plan. ``layout`` ("row",
    "vreg" or "vregp", the JAX package's TPU register layouts) selects
    nothing here: all three are the same function."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    if b.ndim != 2 or b.shape[0] != plan.cols:
        raise ValueError(f"RHS {tuple(b.shape)} does not fit a plan with "
                         f"{plan.cols} cols")
    if not b.is_cuda:
        return spmm_stream_reference(plan, b)
    _check_cuda_operands(plan, b)
    k, n = (int(x) for x in b.shape)
    # The row walk (one bincount over the plan) is spared where the shape
    # alone already decides for the tile kernel.
    row_ptr, longest = cell_row_pointers(plan) \
        if slice_width(k, n, plan.n_kt) else (None, 0)
    kernel, _ = pick_stream_kernel(plan.rows, k, n, plan.n_kt, longest)
    if kernel == "sliced" and row_ptr is not None:
        return spmm_stream_sliced(plan, b)
    return spmm_stream_tile(plan, b)


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
    ``None`` when no host mirror exists. A plan built is the set-up lap
    ``spmm.stream_plan``."""
    cfg = get_config()
    tile_m = cfg.cuda_stream_tile_m or pick_tile_m(ell.n_rows, n_rhs)
    tile_k = cfg.cuda_stream_tile_k or max(ell.n_cols, 1)
    plan = ell._stream_plans.get((tile_m, tile_k))
    if plan is None:
        cols, vals = ell._host_cols, ell._host_vals
        if cols is None or vals is None:
            return None
        clock = profiling.Laps("spmm", ell.vals.device)
        rows = np.repeat(np.arange(ell.n_rows), cols.shape[1])
        plan = build_stream_plan(rows, cols.ravel(), vals.ravel(),
                                 ell.n_rows, ell.n_cols, tile_m=tile_m,
                                 tile_k=tile_k, device=ell.vals.device)
        ell._stream_plans[(tile_m, tile_k)] = plan
        clock.lap("stream_plan")
    return plan
