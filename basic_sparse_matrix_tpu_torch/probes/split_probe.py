"""Split-rung probe: what an SpMV ``y = A·x`` of a skewed float32 matrix
costs on the card through the split rung, by piece width, beside the
plain SpMV and a library call.

:func:`rows` takes the matrix as a ``CSR`` on the card and the operand;
the caller makes both (``chip_smoke.py`` phase 27 makes GAP's PageRank
operator on the ``kron`` graph, and gives the row error against its
float64 reference and the product's byte bound). One row a case: the split
rung (``ops/split.py``) at each width of ``widths`` (its set-up seconds,
passes, pieces, slots per entry, K8 time, two products bit for bit); the
counters of one ``SparseOperator.matvec`` on the main path (the split rung
at ``ops/split.py::WIDTH``); the plain ``spmv`` (gather + ``index_add_``,
the rung the ladder took before the split rung); ``torch.sparse.mm`` of a
``sparse_csr_tensor`` of ``A`` (the library yardstick, built untimed).
Times are the median of ``ITERS`` eager calls between CUDA events. Where
the caller gives ``error`` (an answer → a number) and ``bound_ms``, each
row carries ``row_err`` and ``bound_ms``.
"""

from __future__ import annotations

import json
import statistics
import time
from typing import Callable, Iterable, Optional

import torch

from ..models.operator import SparseOperator
from ..ops import split as ps
from ..ops.csr import CSR
from ..ops.spmm import spmv
from ..runtime import profiling

ITERS = 10


def eager_ms(fn) -> float:
    """Median device milliseconds of ``fn()`` between CUDA events, after
    one untimed call."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(ITERS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def rows(a: CSR, x: torch.Tensor, widths: Iterable[int],
         error: Optional[Callable[[torch.Tensor], float]] = None,
         bound_ms: Optional[float] = None) -> list:
    """The probe's rows (module docstring) for ``a`` (float32, on the
    card) times ``x`` (float32, (a.cols,)), each printed as one JSON line
    as it is made. Leaves ``a`` without its split layout."""
    extra = {} if bound_ms is None else {"bound_ms": bound_ms}
    out = []

    def emit(row: dict, y: torch.Tensor) -> None:
        if error is not None:
            row["row_err"] = error(y)
        out.append({**row, **extra})
        print(json.dumps(out[-1]), flush=True)

    for w in widths:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        split = ps.build(a, w)
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        y1 = ps.spmm_split(split, x)
        y2 = ps.spmm_split(split, x)
        emit({"case": f"split w{w}", "width": w, "setup_s": setup,
              "passes": len(split.passes) + 1, "pieces": split.pieces,
              "slots_per_entry": split.slots / split.entries,
              "layout_gb": sum(p.cols.numel() * 8
                               for p in split.passes) / 1e9,
              "kernel_ms": eager_ms(lambda: ps.spmm_split(split, x)),
              "bit_equal": bool(torch.equal(y1, y2))}, y1)
        del split, y1, y2
        torch.cuda.empty_cache()
    with profiling.recording():
        y = SparseOperator(a).matvec(x)
        torch.cuda.synchronize()
    emit({"case": "main path", "width": ps.WIDTH,
          "counters": profiling.snapshot().counters}, y)
    a._split_cache = None
    del y
    torch.cuda.empty_cache()
    emit({"case": "plain spmv",
          "kernel_ms": eager_ms(lambda: spmv(a, x))}, spmv(a, x))
    torch.cuda.empty_cache()
    t = torch.sparse_csr_tensor(a.indptr.long(), a.indices.long(), a.values,
                                (a.rows, a.cols))
    emit({"case": "torch.sparse.mm", "kernel_ms": eager_ms(
        lambda: torch.sparse.mm(t, x[:, None]))},
        torch.sparse.mm(t, x[:, None])[:, 0])
    return out
