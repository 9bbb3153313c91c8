"""Split layout — the skewed-row SpMM / SpMV path on the card.

The port's own rung, with no counterpart in the JAX package: a matrix whose
ELL overhead exceeds ``ell_max_overhead`` (a power-law graph's hubs beside
rows of one or two entries) would pad every row to its longest one as an
ELL, so the JAX package's ladder sends it to the gather + ``index_add_``
rung. On a CUDA device in float32 the port cuts each row into **pieces** of
at most :data:`WIDTH` entries instead (empty rows get none) and runs the
pieces as an ELL on K8 (``csrc/ell_spmm.cu``, through ``ops/ell.py``): every
piece gives one partial sum. The partial sums of a row lie next to each
other, so the same cut is applied to them: K8 over pieces of pieces, until
every row has one, and a last pass of width 1 writes each row's sum to the
output in row order (an empty row reads a zero kept at the end of the sums).

Each pass is one K8 launch; the product allocates only its output and the
sums buffer (no nnz × N intermediate, no atomics). A row's sum is added in
a fixed order, a tree of at most ``WIDTH``-long runs, so a product is the
same bit for bit from run to run and its rounding grows with the log of
the row's length. A padding slot repeats its piece's last column with
value 0, so it reads nothing the piece does not read already.

:func:`build` makes the layout on the matrix's device from its device
arrays; :func:`cached_split` memoises it on the CSR (the set-up lap
``spmm.split_convert``). :func:`spmm_split` runs K8 where ``ops/ell.py``
would (float32 on a CUDA device) and the plain version of each pass
elsewhere, and counts ``split.entries``, ``split.slots`` (every slot the
product's passes read), ``split.pieces`` (the first pass's rows) and
``split.levels`` (the passes after the first) at every product.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch

from ..runtime import profiling
from . import ell as _e
from .csr import CSR, compute_dtype

# Entries a piece. On GAP's kron graph at scale 25 (1.05B entries) an SpMV
# took 20.66 / 20.55 / 20.51 ms at 8 / 16 / 32 (probes/split_probe.py;
# NVIDIA H100 80GB HBM3, 700 W): the gathers of x set the pace, not the
# slots. 16 holds 3 % more slots than 8 (1.32 against 1.28 an entry, all
# passes) in 6 passes against 8, and 18 % fewer than 32.
WIDTH = 16
# Pieces cut at once while the layout is built.
BUILD_CHUNK = 1 << 22


@dataclasses.dataclass(eq=False)
class Split:
    """``passes[0]`` cuts the matrix's rows (columns of the operand);
    ``passes[k]``, k ≥ 1, cuts the partial sums (columns of the sums
    buffer). Pass k writes rows ``offsets[k]`` on of the sums buffer, which
    has ``n_sums`` rows, the last one kept zero. ``out`` (rows × 1) reads
    each row's sum from the buffer."""

    passes: List[_e.ELL]
    offsets: List[int]
    out: _e.ELL
    n_sums: int
    entries: int

    @property
    def slots(self) -> int:
        return sum(p.n_rows * p.width for p in self.passes) + self.out.n_rows

    @property
    def pieces(self) -> int:
        return self.passes[0].n_rows


def _cut(start: torch.Tensor, length: torch.Tensor, width: int,
         dtype: torch.dtype, cols: torch.Tensor = None,
         vals: torch.Tensor = None) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """Cut runs ``[start_r, start_r + length_r)`` (each length ≥ 1) into
    pieces of at most ``width`` positions, in run order. Returns each run's
    piece count and the pieces' int32 columns and ``dtype`` values
    (``width`` a piece): ``cols``/``vals`` at the positions, or, where
    ``cols`` is None, the positions themselves with value 1; padding
    repeats the piece's last column with value 0."""
    count = (length + width - 1) // width
    total = int(count.sum())
    dev = start.device
    run = torch.repeat_interleave(
        torch.arange(count.numel(), device=dev), count, output_size=total)
    first = torch.cumsum(count, 0) - count
    p_start = start[run] + (torch.arange(total, device=dev)
                            - first[run]) * width
    p_end = torch.minimum(p_start + width, (start + length)[run])
    del run, first
    step = torch.arange(width, device=dev)
    out_cols = torch.empty((total, width), dtype=torch.int32, device=dev)
    out_vals = torch.empty((total, width), dtype=dtype, device=dev)
    for p0 in range(0, total, BUILD_CHUNK):
        s = p_start[p0: p0 + BUILD_CHUNK, None]
        e = p_end[p0: p0 + BUILD_CHUNK, None]
        pos = s + step
        live = pos < e
        pos = torch.minimum(pos, e - 1)
        if cols is None:
            out_cols[p0: p0 + BUILD_CHUNK] = pos
            out_vals[p0: p0 + BUILD_CHUNK] = live
        else:
            out_cols[p0: p0 + BUILD_CHUNK] = cols[pos]
            out_vals[p0: p0 + BUILD_CHUNK] = torch.where(
                live, vals[pos], torch.zeros((), dtype=dtype, device=dev))
    return count, out_cols, out_vals


def _align(k: int) -> int:
    """``k`` rounded up to a multiple of 4: each pass's first row of sums
    starts 16-byte aligned at any N (K8's 16-byte lanes)."""
    return (k + 3) & ~3


def build(a: CSR, width: int = WIDTH) -> Split:
    """``a``'s split layout at ``width`` entries a piece, built on ``a``'s
    device from its device arrays (module docstring)."""
    if width < 2:
        raise ValueError(f"split: width {width} < 2 would never join sums")
    dev = a.device
    indptr = a.indptr.long()
    length = indptr[1:] - indptr[:-1]
    rows = torch.nonzero(length).flatten()
    count, cols, vals = _cut(indptr[:-1][rows], length[rows], width,
                             a.dtype, a.indices, a.values)
    first = _e.ELL(cols=cols, vals=vals, n_cols=a.cols)
    _e.check_cols(first)
    passes, offsets = [first], [0]
    # the partial sums of each live row: [start, start + count)
    start = torch.cumsum(count, 0) - count
    top = _align(first.n_rows)
    while True:
        more = torch.nonzero(count > 1).flatten()
        if not more.numel():
            break
        sub, cols, vals = _cut(start[more], count[more], width, a.dtype)
        passes.append(_e.ELL(cols=cols, vals=vals, n_cols=0))
        offsets.append(top)
        start[more] = top + torch.cumsum(sub, 0) - sub
        count[more] = sub
        top = _align(top + cols.shape[0])
    n_sums = top + 1
    root = torch.full((a.rows,), n_sums - 1, dtype=torch.int32, device=dev)
    root[rows] = start.to(torch.int32)
    one = torch.zeros(a.rows, dtype=a.values.dtype, device=dev)
    one[rows] = 1
    out = _e.ELL(cols=root[:, None], vals=one[:, None], n_cols=n_sums,
                 _cols_ok=True)
    for p in passes[1:]:
        p.n_cols, p._cols_ok = n_sums, True
    return Split(passes=passes, offsets=offsets, out=out, n_sums=n_sums,
                 entries=a.stored)


def cached_split(a: CSR) -> Split:
    """``a``'s split layout, built once and memoised on ``a`` (the set-up
    lap ``spmm.split_convert``)."""
    if a._split_cache is None:
        clock = profiling.Laps("spmm", a.device)
        a._split_cache = build(a)
        clock.lap("split_convert")
    return a._split_cache


def spmm_split(split: Split, b: torch.Tensor) -> torch.Tensor:
    """``A·b`` for ``b`` of shape (K,) or (K, N) through ``split`` (module
    docstring); the result has ``b``'s dtype and shape (rows,) or (rows,
    N)."""
    cdt = compute_dtype(b.dtype)
    sums = torch.empty((split.n_sums, *b.shape[1:]), dtype=cdt,
                       device=b.device)
    sums[-1:].zero_()
    for k, (ell, off) in enumerate(zip(split.passes, split.offsets)):
        _e.spmm_ell(ell, b if k == 0 else sums,
                    out=sums[off: off + ell.n_rows])
    out = _e.spmm_ell(split.out, sums)
    profiling.count("split.entries", split.entries)
    profiling.count("split.slots", split.slots)
    profiling.count("split.pieces", split.pieces)
    profiling.count("split.levels", len(split.passes))
    return out.to(b.dtype)
