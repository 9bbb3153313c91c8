"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

A run sets the program up for the cell's configuration and traffic mix
(``BENCHMARK.json``, and the files it names under ``portbench/``), warms
up every shape the mix uses (and, where the mix asks for ``warm_seconds``,
keeps sending its requests that long, as set-up), then sends requests in
a closed loop with one caller (each synchronised before the next is sent)
for ``--seconds``. With ``--trace 1`` a few more requests run under the
profiler after the window. Then the program's state is freed and the
answers kept from the window are compared with the plain reference. The last lines on standard error give
each compared number beside its limit; the last line on standard output is
the result, with the cell's end-to-end metrics (``--trace 0``) or its
per-layer metrics (``--trace 1``).

It fails, printing no result, without as many CUDA devices as the cell
asks for, without the program beside it, or where the process holds JAX or
the JAX package once the window has closed.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import sys
import time
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import manifest, stats  # noqa: E402

# Modules the process may not hold once the window has closed, by whole
# top-level name.
FOREIGN = ("jax", "jaxlib", "flax", "basic_sparse_matrix_tpu")
PROGRAM = "basic_sparse_matrix_tpu_torch"


def _started() -> float:
    """Seconds since this process started, from the kernel's record of its
    start (10 ms ticks); where that is missing, since this module loaded."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.clock_gettime(time.CLOCK_BOOTTIME) - start
    except (OSError, ValueError, IndexError, AttributeError):
        return time.perf_counter() - _LOADED


_LOADED = time.perf_counter()


def foreign_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FOREIGN))


@contextlib.contextmanager
def configured(config: dict):
    """The precision the configuration states (TF32 on or off in torch's
    float32 products) and its ``port_config`` settings of the program, for
    the block; the program's previous settings return after it."""
    import dataclasses

    import torch

    from basic_sparse_matrix_tpu_torch.utils import config as port_config

    torch.backends.cuda.matmul.allow_tf32 = bool(config["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(config["tf32"])
    prev = port_config.get_config()
    port_config.set_config(dataclasses.replace(
        prev, **config.get("port_config", {})))
    try:
        yield
    finally:
        port_config.set_config(prev)


def window(entry, ctx, seconds: float):
    """Requests 0, 1, ... in a closed loop, each synchronised before the
    next is sent, until ``seconds`` have passed at a result. Returns each
    request's latency (send to synchronised result) and host time (send to
    the entry's return), and the window's length (first send to last
    result)."""
    latency, host = [], []
    w0 = time.perf_counter()
    while True:
        t = time.perf_counter()
        out = entry.send(len(latency))
        th = time.perf_counter()
        ctx.sync()
        td = time.perf_counter()
        entry.keep(len(latency), out)
        latency.append(td - t)
        host.append(th - t)
        if td - w0 >= seconds:
            return latency, host, td - w0


def run_cell(bench: dict, cell: dict, seed: int, seconds: float,
             traced: bool, device, *, config: dict = None,
             traffic: dict = None, limits: dict = None,
             since_start=_started):
    """One run of ``cell``. Returns (result, lines for standard error).
    ``config``, ``traffic`` and ``limits`` replace the cell's files (the
    tests run at a small grid on the CPU this way)."""
    import torch

    from portbench import trace as _trace
    from portbench.entries.base import Context
    from portbench.record import Record

    config = config or manifest.data("configs", cell["config"])
    traffic = traffic or manifest.data("traffic", cell["traffic"])
    limits = limits or manifest.data("limits", cell["name"])
    device = torch.device(device)
    cuda = device.type == "cuda"
    with configured(config):
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        ctx = Context(config=config, traffic=traffic, seed=seed,
                      device=device)
        entry = manifest.module("entries", traffic["entry"]).ENTRY(ctx)
        warm = float(traffic.get("warm_seconds", 0))
        if warm:
            window(entry, ctx, warm)
            entry.kept.clear()
        ctx.lap("warm_up")
        gc.collect()
        setup_s = since_start()
        latency, host, window_s = window(entry, ctx, seconds)
        i = len(latency)
        traced_slice = None
        if traced:
            def request(k):
                res = entry.send(k)
                ctx.sync()
                entry.keep(k, res)

            count = int(traffic["trace_requests"])
            traced_slice = _trace.profile(request, i, count, cuda)
            i += count
        entry.close_window()
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        entry.release()
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        tc = time.perf_counter()
        errors = entry.errors()
        check_s = time.perf_counter() - tc

    checks, bad = {}, set()
    for name, per in errors.items():
        limit = float(limits[name])
        value = max(per.values()) if per else float("inf")
        checks[name] = {"value": value, "limit": limit}
        bad |= {k for k, e in per.items() if not e <= limit}
    correct = bool(entry.kept) and not bad and all(
        c["value"] <= c["limit"] for c in checks.values())

    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    rec = Record(cell=cell["name"], device_kind=kind, setup_s=setup_s,
                 window_s=window_s, latency_s=latency, host_s=host,
                 cost=ctx.cost, spans=ctx.spans, program=ctx.program,
                 trace=traced_slice)
    metrics = {}
    for m in manifest.metrics_of(bench, cell["name"], traced):
        value = manifest.module("metrics", m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind,
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": i, "failed": len(bad),
              "metrics": metrics, "device": dev}
    if traced_slice is not None:
        dev["busy_s"] = traced_slice["busy_s"]
        dev["window_s"] = traced_slice["window_s"]
        result["breakdown"] = {"device_ops": traced_slice["device_op_s"],
                               "idle_gaps": traced_slice["idle_gaps"]}
    result["checks"] = checks
    lines = [
        f"{cell['name']} seed {seed}: {len(latency)} requests in "
        f"{window_s!r} s; latency ms median "
        f"{stats.median(latency) * 1e3!r}, p90/p95/p99/max "
        + "/".join(f"{stats.percentile(latency, q) * 1e3:.3f}"
                   for q in (90, 95, 99, 100)) + "; set-up "
        f"{setup_s!r} s (laps {ctx.laps}); {len(entry.kept)} answers "
        f"compared in {check_s!r} s"]
    lines += [f"check {name} {c['value']!r} limit {c['limit']!r}"
              for name, c in checks.items()]
    return result, lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        bench = manifest.load()
        cell = manifest.cell(bench, args.workload)
    except (OSError, KeyError, ValueError) as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < int(cell["chips"]):
        print(f"portbench: {cell['name']} needs {cell['chips']} CUDA "
              f"device(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, {have} found", file=sys.stderr)
        return 3
    try:
        __import__(PROGRAM)
    except ImportError as e:
        print(f"portbench: the program {PROGRAM} cannot be imported: {e}",
              file=sys.stderr)
        return 4
    result, lines = run_cell(bench, cell, args.seed, args.seconds,
                             bool(args.trace), "cuda")
    found = foreign_modules()
    if found:
        print(f"portbench: the process holds {found}", file=sys.stderr)
        return 5
    sys.stderr.flush()
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
