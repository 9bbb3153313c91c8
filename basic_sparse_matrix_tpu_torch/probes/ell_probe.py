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
        [--choice]
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


CHOICE_WIDTHS = (64, 128, 256, 512)
# Device bytes a probed layout (blocks or plan) may take.
LAYOUT_BUDGET_BYTES = 6 << 30


def block_operand(device, seed: int = 11):
    """``chip_smoke.py``'s K1 operand: 32,768² with 1 % of its 64 × 256
    blocks dense and random-normal (655 blocks, ≈ 10.7M entries)."""
    from ..ops.csr import CSR

    n, bm, bk = 32768, 64, 256
    nrb, ncb = n // bm, n // bk
    rng = np.random.default_rng(seed)
    picked = np.sort(rng.choice(nrb * ncb, (nrb * ncb) // 100,
                                replace=False))
    br, bc = picked // ncb, picked % ncb
    per_brow = np.bincount(br, minlength=nrb)
    lens = np.repeat(per_brow * bk, bm)
    indptr = np.concatenate([[0], np.cumsum(lens)])
    starts = np.concatenate([[0], np.cumsum(per_brow)])
    cols = [np.concatenate([np.arange(c * bk, (c + 1) * bk)
                            for c in bc[starts[r]: starts[r + 1]]]
                           or [np.zeros(0, np.int64)])
            for r in range(nrb)]
    indices = np.concatenate([np.tile(c, bm) for c in cols])
    values = rng.standard_normal(indices.size, dtype=np.float32)
    return CSR.from_host(indptr, indices, values, (n, n), device=device)


def random_operand(device, rows: int, cols: int, per_row: int,
                   seed: int = 12):
    """``rows`` × ``cols`` with ``per_row`` uniformly random columns a row
    (sorted; a repeated column is a second entry, as the kernels sum it),
    random-normal values: ``chip_smoke.py``'s K2 operand at 1M² and 32."""
    from ..ops.csr import CSR

    rng = np.random.default_rng(seed)
    indices = np.sort(rng.integers(0, cols, (rows, per_row)), axis=1)
    indptr = np.arange(rows + 1, dtype=np.int64) * per_row
    values = rng.standard_normal(rows * per_row, dtype=np.float32)
    return CSR.from_host(indptr, indices.ravel(), values, (rows, cols),
                         device=device)


def corner(a, rows: int, cols: int):
    """The leading ``rows`` × ``cols`` block of ``a``, as a row shard or a
    ring step's column block of ``parallel/`` multiplies it."""
    from ..ops.csr import CSR

    indptr, indices, values = a.numpy()
    keep = indices[: indptr[rows]] < cols
    counts = np.add.reduceat(keep, indptr[:rows]) if rows else keep
    counts[np.diff(indptr[: rows + 1]) == 0] = 0
    ptr = np.concatenate([[0], np.cumsum(counts)])
    return CSR.from_host(ptr, indices[: indptr[rows]][keep],
                         values[: indptr[rows]][keep], (rows, cols),
                         device=a.device)


def _timed(fn):
    """``eager_ms(fn)``, or None where the card runs out of memory."""
    try:
        return eager_ms(fn)
    except torch.cuda.OutOfMemoryError:
        torch.cuda.empty_cache()
        return None


def choice_row(case, a, n: int, gen) -> dict:
    """K1, K2 and K8 on ``a`` at N = ``n`` beside the choice's model and
    pick (module docstring)."""
    from ..ops.pallas import spmm_kernel as k1
    from ..ops.pallas import stream_kernel as k2
    from ..ops.spmm import _card_kernel, card_costs, card_layout

    b = torch.randn(a.cols, n, generator=gen, device=gen.device)
    layout = card_layout(a, b)
    with profiling.recording():
        pick = _card_kernel(a, b)
    ell = pe.cached_ell(a)
    ref = pe.spmm_ell(ell, b)
    times, errs = {"k8": _timed(lambda: pe.spmm_ell(ell, b))}, {}
    blocks = layout["live"] * layout["bm"] * layout["bk"] * 4
    if blocks <= LAYOUT_BUDGET_BYTES or a._bsr_cache is not None:
        k1.cached_bsr(a)
        times["k1"] = _timed(lambda: k1.spmm_bsr_from_csr(a, b))
        errs["k1"] = float((k1.spmm_bsr_from_csr(a, b) - ref).abs().max()
                           / ref.abs().max())
    plan = k2.stream_plan_from_ell(ell, n)
    if plan is not None:
        times["k2"] = _timed(lambda: k2.spmm_stream(plan, b))
        errs["k2"] = float((k2.spmm_stream(plan, b) - ref).abs().max()
                           / ref.abs().max())
        _, longest = k2.cell_row_pointers(plan) \
            if k2.slice_width(a.cols, n, plan.n_kt) else (None, 0)
        layout["k2_kernel"] = k2.pick_stream_kernel(
            plan.rows, a.cols, n, plan.n_kt, longest)[0]
    measured = {k: v for k, v in times.items() if v is not None}
    row = {"metric": "spmm_choice", "case": case, **layout,
           "fill": a._bsr_fill, "ms": times,
           "model_ms": {k: v * 1e3 for k, v in
                        card_costs(layout).items()},
           "pick": pick, "fastest": min(measured, key=measured.get),
           "bound_ms": bound_ms(a, n), "max_rel_err_vs_k8": errs,
           "card_counters": profiling.snapshot().counters}
    print(json.dumps(row), flush=True)
    return row


def choice_rows(device) -> list:
    """The ``--choice`` rows (module docstring)."""
    gen = torch.Generator(device=device).manual_seed(23)
    smoke_k2 = lambda: random_operand(device, 1 << 20, 1 << 20, 32)
    test_k2 = lambda: random_operand(device, 131072, 131072, 40)
    operands = [
        ("104³ HPCG", lambda: hpcg27(104, device), CHOICE_WIDTHS),
        ("chip_smoke K1 operand (32,768², 64 × 256 blocks, 1 %)",
         lambda: block_operand(device), CHOICE_WIDTHS),
        ("chip_smoke K2 operand (1M², 32 random a row)", smoke_k2,
         CHOICE_WIDTHS),
        ("its row shard at 4 ranks (262,144 × 1M)",
         lambda: corner(smoke_k2(), 1 << 18, 1 << 20), (512,)),
        ("its ring block at 4 ranks (262,144²)",
         lambda: corner(smoke_k2(), 1 << 18, 1 << 18), (512,)),
        ("its 2-D ring block at 2 × 2 (524,288²)",
         lambda: corner(smoke_k2(), 1 << 19, 1 << 19), (256,)),
        ("card test operand (20,000², 16 a row)",
         lambda: random_operand(device, 20000, 20000, 16), (128,)),
        ("card test operand (131,072², 40 a row)", test_k2, (256,)),
        ("its row shard at 4 ranks (32,768 × 131,072)",
         lambda: corner(test_k2(), 32768, 131072), (256,)),
        ("its ring block at 4 ranks (32,768²)",
         lambda: corner(test_k2(), 32768, 32768), (256,)),
        ("its 2-D ring block at 2 × 2 (65,536²)",
         lambda: corner(test_k2(), 65536, 65536), (128,)),
    ]
    rows = []
    for case, make, widths in operands:
        a = make()
        for n in widths:
            rows.append(choice_row(case, a, n, gen))
        del a
        torch.cuda.empty_cache()
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
    p.add_argument("--choice", action="store_true",
                   help="time K1, K2 and K8 beside the card's choice")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("the K8 probe needs a CUDA device")
    device = torch.device("cuda")
    cuda_kernels.load()
    print(json.dumps({"device": torch.cuda.get_device_name(device),
                      "threads": pe.THREADS}), flush=True)
    if args.choice:
        choice_rows(device)
    else:
        hpcg_rows(device, args.threads)


if __name__ == "__main__":
    main()
