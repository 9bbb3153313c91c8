"""Per-entry FMA probe: what one ``C[i, :] += v * B[k, :]`` costs on the
card when the output tile is addressed at random, beside the streaming
SpMM kernel's cost for the same entries.

Counterpart of ``benchmarks/entry_fma_probe.py``. K6
(``ops/pallas/entry_fma.py``) applies E entries ``(i, k, v)`` to a
(rows, lanes) float32 tile that stays in global memory (L2 at these
sizes), one atomic add per entry and four lanes. The streaming SpMM
K2 (``ops/pallas/stream_kernel.py``) computes the same function from the
same entries binned by row tile, with no atomics. The probe runs both on
the same entries in one process, checks each against a plain version, and
reports nanoseconds per entry for both; the verdict names the lower one.

Two times are taken per kernel, both with CUDA events. ``call_ms`` is an
event pair around one call made at the host's pace: at the default size
the device finishes before the host has queued the next call, so this is
the cost of the Python wrapper and the launch. ``kernel_ms`` is the same
pair while the stream is kept busy ahead of the host (a spin kernel is
queued first), so the events bracket device work only; the per-entry
figures divide this one.

Usage (a machine with a CUDA GPU and nvcc):
    python -m basic_sparse_matrix_tpu_torch.probes.entry_fma_probe
    python -m basic_sparse_matrix_tpu_torch.probes.entry_fma_probe \\
        --entries 8192 --rows 4096 --lanes 128
Correctness only, small shapes, any device (the CPU runs the plain
version against a float64 loop):
    python -m basic_sparse_matrix_tpu_torch.probes.entry_fma_probe --check

Every line printed is one JSON object. Without ``--lanes`` the timing runs
at the default width and at 512 lanes, then at the first width with every
entry sent to one row. Unless ``--stream-rows 0``, the last
line times the streaming kernel at a shape of its own in the same run
(``--stream-rows`` rows with 32 random columns each against a 512-column
right-hand side; the default, 1,000,000 rows, is the streaming SpMM's main
shape and takes about 5 GiB of device memory and some seconds of host work)
and says which per-entry time is lower, that one or K6's at 512 lanes.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..ops.pallas import entry_fma as k6
from ..ops.pallas import stream_kernel as k2

CHECK_SHAPE = (64, 32, 128)   # entries, rows, lanes of --check
MAX_ABS_ERR = 1e-4
DEFAULT_LANES = (128, 512)


def make_entries(entries: int, rows: int, lanes: int, seed: int = 0):
    """Seeded host inputs: ``ii``, ``kk`` uniform in [0, rows), ``vv`` and
    ``b`` (rows, lanes) standard normal."""
    rng = np.random.default_rng(seed)
    ii = rng.integers(0, rows, entries).astype(np.int32)
    kk = rng.integers(0, rows, entries).astype(np.int32)
    vv = rng.standard_normal(entries).astype(np.float32)
    b = rng.standard_normal((rows, lanes)).astype(np.float32)
    return ii, kk, vv, b


def oracle(ii, kk, vv, b, rows: int) -> np.ndarray:
    """The same sums in float64 on the host."""
    out = np.zeros((rows, b.shape[1]), dtype=np.float64)
    np.add.at(out, ii, vv[:, None].astype(np.float64) * b[kk])
    return out


def check(entries: int, rows: int, lanes: int, device) -> float:
    """Max abs error of ``entry_fma`` on ``device`` against the float64
    oracle; raises above ``MAX_ABS_ERR``."""
    ii, kk, vv, b = make_entries(entries, rows, lanes)
    out = k6.entry_fma(*(torch.as_tensor(x, device=device)
                         for x in (ii, kk, vv, b)), rows)
    err = float(np.abs(out.double().cpu().numpy()
                       - oracle(ii, kk, vv, b, rows)).max())
    if not err < MAX_ABS_ERR:
        raise AssertionError(f"entry_fma max abs err {err} >= "
                             f"{MAX_ABS_ERR}")
    return err


# Device cycles the spin kernel holds the stream while the host queues the
# timed launches behind it (tens of milliseconds at Hopper's clocks, far
# more than ``iters`` wrapper calls take to queue).
SPIN_CYCLES = 60_000_000


def device_time_ms(fn, iters: int) -> float:
    """Median device milliseconds of ``fn()`` with the launches queued
    behind a spin kernel, so no event pair waits for the host."""
    import statistics

    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    pairs = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def measure(entries: int, rows: int, lanes: int, device,
            iters: int = 50, hot_row=None) -> dict:
    """Time K6 and K2 on the same entries on the card (CUDA events, median
    of ``iters`` launches each, K6-K2-K2-K6, the better of each pair) and
    hold both against the plain version. ``hot_row`` sends every entry to
    that row. Needs a CUDA device."""
    from ..runtime.timing import cuda_time_ms

    ii_h, kk_h, vv_h, b_h = make_entries(entries, rows, lanes)
    if hot_row is not None:
        ii_h[:] = hot_row
    ii, kk, vv, b = (torch.as_tensor(x, device=device)
                     for x in (ii_h, kk_h, vv_h, b_h))
    plan = k2.build_stream_plan(ii_h, kk_h, vv_h, rows, rows,
                                tile_m=k2.pick_tile_m(rows, lanes),
                                tile_k=rows, device=device)
    ref = k6.entry_fma_reference(ii, kk, vv, b, rows)
    limit = MAX_ABS_ERR * max(float(ref.abs().max()), 1.0)
    out6 = k6.entry_fma(ii, kk, vv, b, rows)     # range-checked once here
    out2 = k2.spmm_stream(plan, b)
    torch.cuda.synchronize(device)
    err6 = float((out6 - ref).abs().max())
    err2 = float((out2 - ref).abs().max())
    if not (err6 < limit and err2 < limit):
        raise AssertionError(f"max abs err K6 {err6}, K2 {err2} vs the "
                             f"plain version, limit {limit}")

    def run6():
        return k6.entry_fma(ii, kk, vv, b, rows, check_range=False)

    def run2():
        return k2.spmm_stream(plan, b)

    call6 = cuda_time_ms(run6, warmup=3, iters=iters)
    call2 = cuda_time_ms(run2, warmup=3, iters=iters)
    t6a = device_time_ms(run6, iters)
    t2a = device_time_ms(run2, iters)
    t2b = device_time_ms(run2, iters)
    t6b = device_time_ms(run6, iters)
    ms6, ms2 = min(t6a, t6b), min(t2a, t2b)
    ns6, ns2 = ms6 * 1e6 / entries, ms2 * 1e6 / entries
    return {
        "metric": "entry_fma_ns", "value": ns6, "unit": "ns/entry",
        "kernel_ms": ms6, "call_ms": call6,
        "entries": entries, "rows": rows, "lanes": lanes,
        "hot_row": hot_row,
        "stream_kernel_ns": ns2, "stream_kernel_ms": ms2,
        "stream_call_ms": call2,
        "stream_tile_m": plan.tile_m, "stream_cellmax": plan.cellmax,
        "max_abs_err": err6, "stream_max_abs_err": err2,
        "verdict": ("entry_fma lower" if ns6 < ns2
                    else "stream kernel lower"),
        "device": torch.cuda.get_device_name(device),
    }


STREAM_PER_ROW = 32
STREAM_LANES = 512


def measure_stream_at_own_shape(rows: int, device, iters: int = 5) -> dict:
    """Time K2 on a ``rows`` × ``rows`` operand with ``STREAM_PER_ROW``
    uniformly random columns a row against a ``STREAM_LANES``-column
    right-hand side (CUDA events, median of ``iters``; the launches are
    milliseconds long, so the host does not pace them). The plan is built
    straight from the seeded coordinates."""
    from ..runtime.timing import cuda_time_ms

    rng = np.random.default_rng(1)
    entries = rows * STREAM_PER_ROW
    plan = k2.build_stream_plan(
        np.repeat(np.arange(rows), STREAM_PER_ROW),
        rng.integers(0, rows, entries),
        rng.standard_normal(entries).astype(np.float32), rows, rows,
        tile_m=k2.pick_tile_m(rows, STREAM_LANES), tile_k=rows,
        device=device)
    gen = torch.Generator(device=device).manual_seed(1)
    b = torch.randn((rows, STREAM_LANES), generator=gen, device=device)
    ms = cuda_time_ms(lambda: k2.spmm_stream(plan, b), warmup=1, iters=iters)
    return {"metric": "stream_kernel_ns_at_own_shape",
            "value": ms * 1e6 / plan.nnz, "unit": "ns/entry",
            "kernel_ms": ms, "entries": plan.nnz, "rows": rows,
            "lanes": STREAM_LANES, "stream_tile_m": plan.tile_m,
            "stream_cellmax": plan.cellmax}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--entries", type=int, default=8192)
    ap.add_argument("--rows", type=int, default=4096)
    ap.add_argument("--lanes", type=int, default=None,
                    help="tile width (default: 128, then 512)")
    ap.add_argument("--stream-rows", type=int, default=1_000_000,
                    help="rows of the streaming kernel's own shape "
                         "(0: skip that measurement)")
    ap.add_argument("--check", action="store_true",
                    help="correctness only (small shapes, any device)")
    args = ap.parse_args(argv)

    if args.check:
        device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
        e, r, l = CHECK_SHAPE
        print(json.dumps({"check_max_abs_err": check(e, r, l, device),
                          "entries": e, "device": device.type}))
        return
    if not torch.cuda.is_available():
        raise SystemExit("entry_fma_probe: no CUDA device; timing needs "
                         "the card (--check runs anywhere)")
    device = torch.device("cuda", 0)
    lanes = (args.lanes,) if args.lanes else DEFAULT_LANES
    err = check(args.entries, args.rows, lanes[0], device)
    print(json.dumps({"check_max_abs_err": err, "entries": args.entries}))
    reports = [measure(args.entries, args.rows, width, device)
               for width in lanes]
    reports.append(measure(args.entries, args.rows, lanes[0], device,
                           hot_row=args.rows // 2))
    for rep in reports:
        print(json.dumps(rep), flush=True)
    if args.stream_rows:
        own = measure_stream_at_own_shape(args.stream_rows, device)
        wide = next((r for r in reports if r["lanes"] == STREAM_LANES),
                    reports[0])
        own["entry_fma_ns"] = wide["value"]
        own["entry_fma_lanes"] = wide["lanes"]
        own["verdict"] = ("entry_fma lower" if wide["value"] < own["value"]
                          else "stream kernel lower")
        print(json.dumps(own), flush=True)


if __name__ == "__main__":
    main()
