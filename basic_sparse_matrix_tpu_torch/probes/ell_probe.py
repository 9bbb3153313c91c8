"""K8 probe: what the ELL product costs on the card at the benchmark's
shapes, beside its plain version, a library call and its bound.

K8 (``csrc/ell_spmm.cu``, through ``ops/ell.py``) multiplies an ELL layout
by a vector or a block of columns in one launch. :func:`hpcg_rows` times it
on HPCG's 27-point operator at 104³ (1,124,864 rows) where the benchmark's
cells run it: the SpMV of the whole operator (width 27, the IC(0) and
multigrid PCG's A·p), the SpMV of its strict lower triangle (width 13, a
SymGS product of the V-cycle) and the product with N = 32 columns (the
``spmm-n32`` cell); and at N = 256 (the ``spmm-n256`` cell's width, where
the dispatch sends the operator to K1) beside K1's time on the same
operand, as data for the dispatch's choice; the N = 32 row also counts
the K8 launches of one ``spmm_auto`` call there (the dispatch's main path,
``main_path_launches``). :func:`vcycle_launches` counts those of one
replayed V-cycle of HPCG's 4-level multigrid at 16³. Launches are the
recorder's ``ell.launches`` over a fresh recording. Each row holds K8's time, the
plain version's (``spmm_ell_plain`` / ``spmv_ell_plain``), the library
yardstick ``torch.sparse.mm`` of a ``sparse_csr_tensor`` of the operator
(built untimed; nothing in the port calls it), the bound and K8's largest
difference from the plain version relative to the largest output.

Times: K8 and the plain version are CUDA events around replays of a CUDA
graph holding ``REPEAT`` calls (median of ``ITERS`` replays, divided);
the library call and K1 by CUDA events around eager calls (median of
``ITERS``). The bound is the larger of bytes over 3.35 TB/s and float32
operations over 67 TFLOP/s (H100 SXM data sheet): the stored entries'
values and int32 columns, the row pointer, each distinct column's row of B
and C once, ``2·nnz·N`` operations (as the benchmark's ``spmm.roofline_pct``
counts them). ``--threads`` also times K8 at other block sizes
(``ell.THREADS``), the measurement behind the one it takes.

Usage (a machine with a CUDA GPU and nvcc; ≈ 30 s of host set-up):
    python -m basic_sparse_matrix_tpu_torch.probes.ell_probe [--threads]
Every line printed is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import statistics

import numpy as np
import torch

from ..ops import ell as pe
from ..runtime import profiling
from .trsv_probe import graph_ms, hpcg27

ITERS = 20
REPEAT = 10
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12
THREADS = (128, 256, 512, 1024)


def eager_ms(fn) -> float:
    """Median device milliseconds of ``fn()`` between CUDA events around
    each eager call, after one untimed call."""
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


def bound_ms(a, n: int) -> float:
    """The least ms for ``a`` (CSR) times N columns (module docstring)."""
    _, indices, _ = a.numpy()
    held = int(np.count_nonzero(np.bincount(indices, minlength=a.cols)))
    nbytes = 8 * a.stored + 4 * (a.rows + 1) + 4 * n * (held + a.rows)
    return max(nbytes / HBM_BYTES_PER_S,
               2.0 * a.stored * n / FP32_FLOPS_PER_S) * 1e3


def _row(case, a, ell, b, **extra) -> dict:
    if b.ndim == 1:
        k8, plain = pe.spmv_ell, pe.spmv_ell_plain
    else:
        k8, plain = pe.spmm_ell, pe.spmm_ell_plain
    got, want = k8(ell, b), plain(ell, b)
    err = float((got - want).abs().max() / want.abs().max())
    del got, want
    indptr, indices, values = a.numpy()
    lib = torch.sparse_csr_tensor(
        torch.as_tensor(indptr.astype(np.int64), device=b.device),
        torch.as_tensor(indices.astype(np.int64), device=b.device),
        torch.as_tensor(values, device=b.device), size=(a.rows, a.cols))
    rhs = b if b.ndim == 2 else b[:, None]
    n = int(rhs.shape[1])
    row = {"metric": "ell_kernel", "case": case, "rows": ell.n_rows,
           "width": ell.width, "n": n, "stored": a.stored,
           "kernel_ms": graph_ms(lambda: k8(ell, b), REPEAT),
           "plain_ms": graph_ms(lambda: plain(ell, b),
                                REPEAT if n == 1 else 1),
           "library_ms": eager_ms(lambda: torch.sparse.mm(lib, rhs)),
           "bound_ms": bound_ms(a, n), "max_abs_err_of_max": err, **extra}
    print(json.dumps(row), flush=True)
    return row


def threads_rows(case, ell, b) -> list:
    """K8's time at each block size of ``THREADS``."""
    fn = pe.spmv_ell if b.ndim == 1 else pe.spmm_ell
    keep, rows = pe.THREADS, []
    try:
        for t in THREADS:
            pe.THREADS = t
            rows.append({"metric": "ell_threads", "case": case,
                         "threads": t,
                         "kernel_ms": graph_ms(lambda: fn(ell, b), REPEAT)})
            print(json.dumps(rows[-1]), flush=True)
    finally:
        pe.THREADS = keep
    return rows


def hpcg_rows(device, threads: bool = False) -> list:
    """K8 at the benchmark's shapes (module docstring)."""
    from ..ops.pallas import spmm_kernel as k1

    from ..ops.spmm import spmm_auto

    a = hpcg27(104, device)
    lower = a.triangle(lower=True, strict=True)
    ell, ell_lower = pe.csr_to_ell(a), pe.csr_to_ell(lower)
    gen = torch.Generator(device=device).manual_seed(7)
    x = torch.randn(a.cols, generator=gen, device=device)
    b32 = torch.randn(a.cols, 32, generator=gen, device=device)
    with profiling.recording():
        spmm_auto(a, b32)    # the spmm-n32 cell's call: the ELL rung
    main_path = profiling.snapshot().counters.get("ell.launches", 0)
    cases = [("104³ SpMV (width 27)", a, ell, x),
             ("104³ strict lower triangle SpMV (width 13)", lower,
              ell_lower, x),
             ("104³ N = 32", a, ell, b32)]
    rows = [_row(*case) for case in cases[:2]]
    rows.append(_row(*cases[2], main_path_launches=main_path))
    if threads:
        for case, _, e, b in cases:
            threads_rows(case, e, b)
    del cases
    b256 = torch.randn(a.cols, 256, generator=gen, device=device)
    k1.cached_bsr(a)
    k1_ms = eager_ms(lambda: k1.spmm_bsr_from_csr(a, b256))
    rows.append(_row("104³ N = 256", a, ell, b256, k1_ms=k1_ms))
    return rows


def vcycle_launches(device, k: int = 16) -> int:
    """K8 launches of one replayed V-cycle of HPCG's 4-level multigrid
    (``models/multigrid.py``) on a k³ grid (the first call captures)."""
    from ..models.multigrid import MultigridSetup, injection_map

    dims = [k >> s for s in range(4)]
    setup = MultigridSetup.build(
        [hpcg27(d, device) for d in dims],
        [injection_map((d, d, d), device) for d in dims[:-1]])
    r = torch.randn(k ** 3, generator=torch.Generator(device=device)
                    .manual_seed(5), device=device)
    setup.apply_m_inv(r)
    with profiling.recording():
        setup.apply_m_inv(r)
    return profiling.snapshot().counters.get("ell.launches", 0)


def main(argv=None) -> None:
    from ..runtime import cuda_kernels

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--threads", action="store_true",
                   help="also time K8 at each block size of THREADS")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("the K8 probe needs a CUDA device")
    device = torch.device("cuda")
    cuda_kernels.load()
    print(json.dumps({"device": torch.cuda.get_device_name(device),
                      "threads": pe.THREADS}), flush=True)
    hpcg_rows(device, args.threads)


if __name__ == "__main__":
    main()
