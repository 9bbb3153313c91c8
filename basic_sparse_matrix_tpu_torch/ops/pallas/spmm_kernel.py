"""Block-sparse (BSR) SpMM: host layout, plain version and the K1 CUDA kernel.

Counterpart of ``basic_sparse_matrix_tpu/ops/pallas/spmm_kernel.py``. The
matrix is re-laid-out on the host into BSR: dense ``(bm, bk)`` blocks kept
only where nonzero, sorted by block row, with one zero block seeded at
column 0 of every block row (the same layout, block for block, as the JAX
package builds). Beside it the host keeps the LIVE blocks, those that
received an entry, per block row (``live_ptr``, ``live_idx``).
:func:`spmm_bsr` multiplies it by a dense RHS:

* on a CUDA tensor it launches the hand-written kernel
  ``csrc/spmm_bsr.cu`` (one thread block per output tile, walking the live
  blocks of its block row on the tensor cores), or raises;
* on a CPU tensor it runs :func:`spmm_bsr_reference`, the plain PyTorch
  version of the same function, over all blocks.

The kernel skips the seed-only blocks. For finite B that changes nothing
(they are zero blocks), but a NaN or Inf in rows of B that only a seed
block covers no longer reaches C: the kernel multiplies stored entries
only, as the reference crate does. The plain version keeps multiplying
every block, as the JAX kernel does.

Precision follows the JAX function: ``HIGHEST`` (the default) is float32
accuracy, on the card the 3×TF32 split; ``DEFAULT`` is one pass on operands
rounded to TF32, the counterpart of the TPU's single bf16 pass, exact where
the inputs fit TF32's 10 mantissa bits.

``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ...runtime import profiling
from ...utils.config import get_config, matmul_precision
from ..csr import CSR, canonical, to_tensor

# Launches of the K1 CUDA kernel in this process (a plain counter that a
# caller may reset to 0).
LAUNCHES = 0

# The two precisions of the JAX function (``jax.lax.Precision`` members
# are taken by name as well).
HIGHEST = "highest"
DEFAULT = "default"
_PASSES = {HIGHEST: 3, DEFAULT: 1}


def _precision(precision) -> str:
    """``HIGHEST`` or ``DEFAULT`` from None (``HIGHEST``), a string or an
    enum member with either name."""
    name = HIGHEST if precision is None else str(
        getattr(precision, "name", precision)).lower()
    if name not in _PASSES:
        raise ValueError(f"precision {precision!r}: the BSR kernel takes "
                         f"{HIGHEST!r} or {DEFAULT!r}")
    return name


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (10 mantissa bits), to nearest with
    ties away from zero, as ``cvt.rna.tf32.f32`` rounds; Inf and NaN pass
    through."""
    bits = x.contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isfinite(x), rounded, x)


def pick_tiles(rows: int, cols: int, nnz: int) -> Tuple[int, int]:
    """(bm, bk) from density, as in the JAX package (the dispatch and the
    layout must match it; unmeasured as tile choices on the H100)."""
    density = nnz / max(rows * cols, 1)
    if density >= 0.05:
        return 256, 512
    if density >= 0.005:
        return 64, 256
    return 8, 128


@dataclasses.dataclass(eq=False)
class BSR:
    """Flat block-sparse layout: ``blocks[t]`` is the dense (bm, bk) block
    at block coordinates ``(block_rows[t], block_cols[t])``, sorted by block
    row; ``brow_ptr[r]:brow_ptr[r+1]`` are block row r's blocks, and
    ``live_idx[live_ptr[r]:live_ptr[r+1]]`` those of them that hold an
    entry."""

    blocks: torch.Tensor      # (nblocks, bm, bk)
    block_rows: torch.Tensor  # (nblocks,) int32, sorted
    block_cols: torch.Tensor  # (nblocks,) int32
    brow_ptr: torch.Tensor    # (n_block_rows + 1,) int32
    live_ptr: torch.Tensor    # (n_block_rows + 1,) int32
    live_idx: torch.Tensor    # (n_live,) int32, increasing
    rows: int
    cols: int

    @property
    def n_live(self) -> int:
        return int(self.live_idx.shape[0])

    @property
    def bm(self) -> int:
        return int(self.blocks.shape[1])

    @property
    def bk(self) -> int:
        return int(self.blocks.shape[2])

    @property
    def nblocks(self) -> int:
        return int(self.blocks.shape[0])

    @property
    def n_block_rows(self) -> int:
        return -(-self.rows // self.bm)

    @property
    def padded_rows(self) -> int:
        return self.n_block_rows * self.bm

    @property
    def padded_cols(self) -> int:
        return -(-self.cols // self.bk) * self.bk


def make_bsr(blocks: np.ndarray, block_rows: np.ndarray,
             block_cols: np.ndarray, rows: int, cols: int,
             device=None, live_idx: Optional[np.ndarray] = None) -> BSR:
    """A BSR from host arrays, with its block-row pointers built here.
    ``live_idx`` lists the blocks that hold an entry (increasing); without
    it, the blocks with a nonzero element. Checks the invariants the kernel
    relies on."""
    blocks = canonical(blocks)
    block_rows = np.asarray(block_rows, dtype=np.int32)
    block_cols = np.asarray(block_cols, dtype=np.int32)
    if blocks.ndim != 3 or block_rows.shape != (blocks.shape[0],) \
            or block_cols.shape != block_rows.shape:
        raise ValueError("BSR arrays disagree in shape: blocks "
                         f"{blocks.shape}, block_rows {block_rows.shape}, "
                         f"block_cols {block_cols.shape}")
    bm, bk = int(blocks.shape[1]), int(blocks.shape[2])
    nrb, ncb = -(-rows // bm), -(-cols // bk)
    if block_rows.size and not (
            (np.diff(block_rows) >= 0).all() and block_rows[0] >= 0
            and block_rows[-1] < nrb and block_cols.min() >= 0
            and block_cols.max() < ncb):
        raise ValueError("BSR block coordinates unsorted or out of range")
    if live_idx is None:
        live_idx = np.flatnonzero(blocks.any(axis=(1, 2)))
    live_idx = np.asarray(live_idx, dtype=np.int32)
    if live_idx.ndim != 1 or (live_idx.size and not (
            (np.diff(live_idx) > 0).all() and live_idx[0] >= 0
            and live_idx[-1] < blocks.shape[0])):
        raise ValueError("live block list unsorted or out of range")

    def row_ptr(brows):
        ptr = np.zeros(nrb + 1, dtype=np.int32)
        np.cumsum(np.bincount(brows, minlength=nrb), out=ptr[1:])
        return ptr

    return BSR(blocks=to_tensor(blocks, device),
               block_rows=to_tensor(block_rows, device),
               block_cols=to_tensor(block_cols, device),
               brow_ptr=to_tensor(row_ptr(block_rows), device),
               live_ptr=to_tensor(row_ptr(block_rows[live_idx]), device),
               live_idx=to_tensor(live_idx, device), rows=rows, cols=cols)


def csr_to_bsr(a: CSR, bm: Optional[int] = None,
               bk: Optional[int] = None) -> BSR:
    """Host-side CSR → BSR conversion (numpy, O(nnz), once per matrix),
    uploaded to ``a``'s device."""
    indptr, indices, values = a.numpy()
    if bm is None or bk is None:
        bm, bk = pick_tiles(a.rows, a.cols, a.stored)
    rows = np.repeat(np.arange(a.rows), np.diff(indptr))
    brow = rows // bm
    bcol = indices // bk
    ncb = -(-a.cols // bk)
    nrb = -(-a.rows // bm)
    bkey = brow.astype(np.int64) * ncb + bcol
    # Every block row gets a zero block at column 0, as in the JAX package,
    # so the two layouts match block for block.
    bkey = np.concatenate([bkey, np.arange(nrb, dtype=np.int64) * ncb])
    uniq, inv = np.unique(bkey, return_inverse=True)
    inv = inv[: rows.shape[0]]
    blocks = np.zeros((uniq.shape[0], bm, bk), dtype=values.dtype)
    np.add.at(blocks, (inv, rows % bm, indices % bk), values)
    live_idx = np.flatnonzero(np.bincount(inv, minlength=uniq.shape[0]))
    return make_bsr(blocks, uniq // ncb, uniq % ncb, a.rows, a.cols,
                    device=a.device, live_idx=live_idx)


def spmm_bsr_reference(bsr: BSR, b: torch.Tensor,
                       precision=None) -> torch.Tensor:
    """Plain PyTorch version of K1: gather each block's B panel, batch
    multiply, and add the products into their block rows. Under
    ``DEFAULT`` both operands are rounded to TF32 first and multiplied in
    float32."""
    n = b.shape[1]
    bp = torch.zeros((bsr.padded_cols, n), dtype=torch.float32,
                     device=b.device)
    bp[: b.shape[0]] = b
    panels = bp.view(-1, bsr.bk, n).index_select(0, bsr.block_cols.long())
    blocks = bsr.blocks.float()
    if _precision(precision) == DEFAULT:
        blocks, panels = round_tf32(blocks), round_tf32(panels)
    with matmul_precision():  # float32 products without TF32
        prod = torch.bmm(blocks, panels)
    out = torch.zeros((bsr.n_block_rows, bsr.bm, n), dtype=torch.float32,
                      device=b.device)
    out.index_add_(0, bsr.block_rows.long(), prod)
    return out.view(-1, n)[: bsr.rows]


def spmm_bsr(bsr: BSR, b: torch.Tensor, bn: Optional[int] = None,
             precision=None) -> torch.Tensor:
    """``A @ b`` for a BSR ``A``: the K1 CUDA kernel for a CUDA ``b``, the
    plain version for a CPU one. Returns (rows, n) float32.

    The signature is the JAX function's. ``bn`` is accepted and ignored:
    the kernel's N tile is its own. ``precision`` is None or ``HIGHEST``
    (float32 accuracy; the 3×TF32 split on the card) or ``DEFAULT`` (one
    TF32 pass)."""
    mode = _precision(precision)
    if b.ndim != 2 or b.shape[0] != bsr.cols:
        raise ValueError(f"RHS {tuple(b.shape)} does not fit a BSR with "
                         f"{bsr.cols} cols")
    if not b.is_cuda:
        return spmm_bsr_reference(bsr, b, mode)
    global LAUNCHES
    from ...runtime import cuda_kernels

    for t in (bsr.blocks, bsr.live_ptr, bsr.live_idx, bsr.block_cols):
        if t.device != b.device:
            raise ValueError(f"BSR on {t.device}, RHS on {b.device}")
        if not t.is_contiguous():
            raise ValueError("BSR tensors must be contiguous")
    if b.dtype != torch.float32 or bsr.blocks.dtype != torch.float32:
        raise TypeError(f"CUDA SpMM kernels take float32, got "
                        f"{bsr.blocks.dtype} x {b.dtype}")
    b = b.contiguous()
    n = int(b.shape[1])
    out = torch.empty((bsr.rows, n), dtype=torch.float32, device=b.device)
    lib = cuda_kernels.load()
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream(b.device).cuda_stream
        status = lib.bsm_spmm_bsr(
            bsr.blocks.data_ptr(), bsr.live_ptr.data_ptr(),
            bsr.live_idx.data_ptr(), bsr.block_cols.data_ptr(),
            b.data_ptr(), out.data_ptr(), bsr.n_block_rows, bsr.rows,
            bsr.cols, n, bsr.bm, bsr.bk, n, n, _PASSES[mode], stream)
    LAUNCHES += 1
    cuda_kernels.check_launch(lib, status, "spmm_bsr")
    return out


def kernel_config(bm: int, precision=None) -> dict:
    """The launch configuration K1 takes for blocks of ``bm`` rows, read
    from the built kernel: threads, output tile, dynamic shared memory,
    registers, local (spill) bytes per thread and thread blocks per SM.
    Needs a CUDA device."""
    import ctypes

    from ...runtime import cuda_kernels

    lib = cuda_kernels.load()
    vals = (ctypes.c_int * 7)()
    status = lib.bsm_spmm_bsr_info(bm, _PASSES[_precision(precision)], vals)
    cuda_kernels.check_launch(lib, status, "spmm_bsr_info")
    return dict(zip(("threads", "tile_m", "tile_n", "smem_bytes",
                     "registers", "local_bytes", "blocks_per_sm"), vals))


def cached_bsr(a: CSR) -> BSR:
    """``a``'s BSR layout, converted once and memoised on ``a`` (the set-up
    lap ``spmm.bsr_convert``)."""
    if a._bsr_cache is None:
        clock = profiling.Laps("spmm", a.device)
        a._bsr_cache = csr_to_bsr(a)
        clock.lap("bsr_convert")
    return a._bsr_cache


def spmm_bsr_from_csr(a: CSR, b: torch.Tensor) -> torch.Tensor:
    """CSR entry point with memoised BSR conversion."""
    return spmm_bsr(cached_bsr(a), b)


def bsr_profitable(a: CSR, b: torch.Tensor, *, force: bool = False) -> bool:
    """Dispatch heuristic of the JAX package: BSR when the block fill
    reaches ``bsr_min_fill``, only for an RHS on a CUDA device (the JAX
    package's "real TPU backend" gate). ``force=True`` bypasses the device
    gate so the fill logic can be tested on the CPU. The fill test, run
    once per matrix, is the set-up lap ``spmm.bsr_fill``."""
    if not b.is_cuda and not force:
        return False
    n = int(b.shape[-1])
    if a.stored == 0 or n < 64:
        return False
    bsr = a._bsr_cache
    if bsr is not None:
        fill = a.stored / (bsr.nblocks * bsr.bm * bsr.bk)
    else:
        if a._bsr_fill is None:
            clock = profiling.Laps("spmm", a.device)
            bm, bk = pick_tiles(a.rows, a.cols, a.stored)
            indptr, indices, _ = a.numpy()
            rows = np.repeat(np.arange(a.rows), np.diff(indptr))
            bkey = np.sort((rows // bm).astype(np.int64)
                           * (-(-a.cols // bk)) + indices // bk)
            # Distinct blocks by sort: numpy 2.3's hash-based np.unique is
            # several times slower than a sort on tens of millions of keys.
            nblocks = 1 + int(np.count_nonzero(bkey[1:] != bkey[:-1]))
            a._bsr_fill = a.stored / (nblocks * bm * bk)
            clock.lap("bsr_fill")
        fill = a._bsr_fill
    return fill >= get_config().bsr_min_fill
