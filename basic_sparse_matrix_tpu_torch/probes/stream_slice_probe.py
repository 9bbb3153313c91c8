"""Streaming SpMM slice probe: the two K2 kernels side by side on the card,
the sliced kernel at every slice width, and the card's L2 gather rate.

The sliced kernel (``ops/pallas/stream_kernel.py::spmm_stream_sliced``)
keeps one slice of ``w`` columns of B in L2 at a time; which ``w`` that
should be depends on how much of the L2 a gather from all SMs can really
use, which only a run on the card can say. The probe builds a ``rows`` ×
``rows`` operand with ``per_row`` uniformly random columns a row and a
``lanes``-column right-hand side (the defaults are the streaming SpMM's main
shape: 1M × 1M, 32 a row, 512 columns; about 7 GiB of device memory and some
seconds of host work) and prints one JSON object a line:

* ``l2_gather``: GB/s of a gather of 32-byte pieces at hashed addresses
  from arrays of 16 MB, 32 MB, 64 MB and 1 GB (the last one is the HBM
  gather rate; the probe kernel is ``l2_gather_probe_kernel`` of
  ``csrc/spmm_stream.cu``);
* ``tile``: the tile kernel's time;
* ``pack``: the pack kernel alone, at each width below 32;
* ``sliced``: the sliced kernel at w = 4, 8, 16 and 32, with B packed (every
  time includes the pack), C written row-major in 32-byte pieces or
  slice-major and unpacked (the unpack included), and w = 32 unpacked. Each
  is held to the tile kernel's output (max abs error; the sums are taken in
  the same order, so 0.0 is expected) and run twice for bitwise equality;
* ``dispatch``: what :func:`spmm_stream` itself launches at this shape;
* ``long_row`` (``--long-rows 256,1024,4096``; off by default, each length
  builds a plan of its own on the host): both kernels (the sliced one at
  w = 32, B as it lies) on the same operand with one row, in the middle,
  given that many entries. In the sliced kernel one group of 8 threads
  walks a row's slots one after another, so a long row holds its block
  back; ``LONG_ROW_ROWS`` of the wrapper is set from these times.

Times are CUDA events around one call each, median, min and max of
``--iters``; the calls are milliseconds long, so the host does not pace
them.

Usage (a machine with a CUDA GPU and nvcc):
    python -m basic_sparse_matrix_tpu_torch.probes.stream_slice_probe
    python -m basic_sparse_matrix_tpu_torch.probes.stream_slice_probe \\
        --rows 200000 --per-row 32 --lanes 512 --iters 5
"""

from __future__ import annotations

import argparse
import json
import statistics

import numpy as np
import torch

from ..ops.pallas import stream_kernel as k2

GATHER_ARRAY_BYTES = (16 << 20, 32 << 20, 64 << 20, 1 << 30)
PIECE_BYTES = 32


def event_times_ms(fn, iters: int, warmup: int = 1) -> dict:
    """Median, min and max device milliseconds of ``fn()`` over ``iters``
    event pairs, after ``warmup`` untimed calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    ms = [s.elapsed_time(e) for s, e in pairs]
    return {"ms": statistics.median(ms), "min_ms": min(ms), "max_ms": max(ms)}


def l2_gather_gbps(array_bytes: int, device, iters: int = 2048,
                   blocks_per_sm: int = 8) -> float:
    """GB/s of 32-byte pieces gathered at hashed addresses from the first
    ``array_bytes`` of a device array, by pairs of threads from a grid that
    fills the card (median of 5 launches after one that warms the L2)."""
    from ..runtime import cuda_kernels

    lib = cuda_kernels.load()
    blocks = torch.cuda.get_device_properties(device).multi_processor_count \
        * blocks_per_sm
    src = torch.ones(array_bytes // 4, dtype=torch.float32, device=device)
    out = torch.empty(blocks * 256, dtype=torch.float32, device=device)

    def run():
        with torch.cuda.device(device):
            status = lib.bsm_l2_gather_probe(
                src.data_ptr(), out.data_ptr(), array_bytes // PIECE_BYTES,
                iters, blocks, torch.cuda.current_stream(device).cuda_stream)
        cuda_kernels.check_launch(lib, status, "l2_gather_probe")

    ms = event_times_ms(run, 5)["ms"]
    if float(out[0]) != 4.0 * iters:     # every load returned ones
        raise AssertionError("l2_gather_probe read something else than the "
                             "array")
    return blocks * 128 * iters * PIECE_BYTES / ms / 1e6


def make_operand(rows: int, per_row: int, lanes: int, device, seed: int = 1,
                 long_row: int = 0):
    """A seeded ``rows`` × ``rows`` plan with ``per_row`` random columns a
    row (the middle row ``long_row`` of them where that is larger) at the
    CUDA target's tiles (``pick_tile_m``, one k tile), and a normal
    (rows, lanes) right-hand side."""
    rng = np.random.default_rng(seed)
    counts = np.full(rows, per_row)
    counts[rows // 2] = max(per_row, long_row)
    entries = int(counts.sum())
    plan = k2.build_stream_plan(
        np.repeat(np.arange(rows), counts), rng.integers(0, rows, entries),
        rng.standard_normal(entries).astype(np.float32), rows, rows,
        tile_m=k2.pick_tile_m(rows, lanes), tile_k=rows, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return plan, torch.randn((rows, lanes), generator=gen, device=device)


def sweep(plan, b, iters: int = 5, widths=k2.SLICE_WIDTHS[::-1]) -> list:
    """The tile kernel, the pack kernel alone and the sliced kernel at every
    width and C layout on one operand; a list of report dicts. Raises if a
    sliced result differs from the tile kernel's by more than 1e-4 of
    max|ref| or from its own second run at all."""
    reports = []
    ref = k2.spmm_stream_tile(plan, b)
    scale = max(float(ref.abs().max()), 1.0)
    reports.append({"kernel": "tile", "tile_m": plan.tile_m,
                    **event_times_ms(lambda: k2.spmm_stream_tile(plan, b),
                                     iters)})
    slots = plan.ii.numel()
    for w in widths:
        modes = [(True, False), (True, True)] if w < 32 else \
            [(False, False), (True, False)]
        if w < 32:
            reports.append({"kernel": "pack", "w": w, **event_times_ms(
                lambda: k2.pack_slices_cuda(b, w), iters)})
        for pack, c_major in modes:
            def run():
                return k2.spmm_stream_sliced(plan, b, w, pack=pack,
                                             c_slice_major=c_major)
            out = run()
            err = float((out - ref).abs().max())
            same = bool(torch.equal(out, run()))
            if not (err <= 1e-4 * scale and same):
                raise AssertionError(f"sliced kernel, w {w}: max abs err "
                                     f"{err} vs the tile kernel, bitwise "
                                     f"repeatable {same}")
            del out
            n_slices = -(-b.shape[1] // w)
            reports.append({
                "kernel": "sliced", "w": w, "packed_b": pack,
                "c_slice_major": c_major,
                "slice_bytes": plan.cols * w * 4,
                "slot_reread_bytes": n_slices * slots * 8,
                "max_abs_err_vs_tile": err, "bitwise_repeatable": same,
                **event_times_ms(run, iters)})
    return reports


def long_row_report(rows: int, per_row: int, lanes: int, long_row: int,
                    device, iters: int = 5) -> dict:
    """Both kernels on an operand whose middle row has ``long_row`` entries;
    the sliced result is held to the tile kernel's."""
    plan, b = make_operand(rows, per_row, lanes, device, long_row=long_row)
    ref = k2.spmm_stream_tile(plan, b)
    err = float((k2.spmm_stream_sliced(plan, b, 32) - ref).abs().max())
    if not err <= 1e-4 * max(float(ref.abs().max()), 1.0):
        raise AssertionError(f"sliced kernel, a row of {long_row}: max abs "
                             f"err {err} vs the tile kernel")
    del ref
    tile = event_times_ms(lambda: k2.spmm_stream_tile(plan, b), iters)
    sliced = event_times_ms(lambda: k2.spmm_stream_sliced(plan, b, 32), iters)
    return {"longest_row": k2.cell_row_pointers(plan)[1],
            "cellmax": plan.cellmax, "pad_factor": plan.pad_factor,
            "max_abs_err_vs_tile": err,
            "tile": tile, "sliced_w32": sliced}


def sweep_and_dispatch(args, device, name: str) -> None:
    """The L2 gather rates, the width sweep and the dispatch at one shape."""
    for nbytes in GATHER_ARRAY_BYTES:
        print(json.dumps({"probe": "l2_gather", "array_bytes": nbytes,
                          "piece_bytes": PIECE_BYTES,
                          "gb_per_s": l2_gather_gbps(nbytes, device),
                          "device": name}), flush=True)
    plan, b = make_operand(args.rows, args.per_row, args.lanes, device)
    for rep in sweep(plan, b, args.iters):
        print(json.dumps({"probe": "stream_slice", "rows": args.rows,
                          "per_row": args.per_row, "lanes": args.lanes,
                          "entries": plan.nnz, "device": name, **rep}),
              flush=True)
    _, longest = k2.cell_row_pointers(plan)
    kernel, w = k2.pick_stream_kernel(plan.rows, plan.cols, args.lanes,
                                      plan.n_kt, longest)
    before = dict(k2.LAUNCHES_BY_KERNEL)
    times = event_times_ms(lambda: k2.spmm_stream(plan, b), args.iters)
    took = [k for k, v in k2.LAUNCHES_BY_KERNEL.items() if v > before[k]]
    print(json.dumps({"probe": "dispatch", "picked": kernel, "w": w,
                      "launched": took, "longest_row": longest,
                      "l2_slice_budget_bytes": k2.L2_SLICE_BUDGET_BYTES,
                      **times, "device": name}), flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--per-row", type=int, default=32)
    ap.add_argument("--lanes", type=int, default=512)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--long-rows", default="",
                    help="comma-separated lengths of one long row to time "
                         "both kernels on (default: none)")
    ap.add_argument("--no-sweep", action="store_true",
                    help="skip the L2 gather rates and the width sweep")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("stream_slice_probe: no CUDA device; the probe "
                         "times kernels on the card")
    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(device)
    if not args.no_sweep:
        sweep_and_dispatch(args, device, name)
    for long_row in (int(x) for x in args.long_rows.split(",") if x):
        print(json.dumps({"probe": "long_row", "rows": args.rows,
                          "per_row": args.per_row, "lanes": args.lanes,
                          "device": name,
                          **long_row_report(args.rows, args.per_row,
                                            args.lanes, long_row, device,
                                            args.iters)}),
              flush=True)


if __name__ == "__main__":
    main()
